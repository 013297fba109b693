"""repro_torch: the PyTorch/CUDA port of the logzip package ``repro``.

Layout mirrors ``repro`` module for module:
    repro_torch.core     -- the paper's batch codec (parse -> dedup ->
                            ISE structure -> encode -> pack, and decode),
                            streaming (LZJS) and multi-chunk (LZJM)
                            containers, and the compressed-domain query
                            engine
    repro_torch.kernels  -- hand-written CUDA kernels for the H100
                            (``csrc/``), their plain torch versions, and
                            the numpy in/out wrappers the pipeline calls
    repro_torch.data     -- the synthetic loghub-style corpora

The package imports torch and numpy, never jax and nothing of ``repro``.
Entry points run their kernels on ``LogzipConfig.device`` ("cuda" by
default, which raises where there is no card); ``device="cpu"`` runs the
kernels' plain torch versions.
"""

__version__ = "0.1.0"
