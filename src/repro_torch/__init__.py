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
    repro_torch.data     -- the synthetic loghub-style corpora and the
                            LM data pipeline over logzip shards
    repro_torch.ingest   -- the multi-tenant ingest daemon
    repro_torch.lifecycle -- archive compaction and retention
    repro_torch.models   -- the LM zoo, every family: ``Transformer``,
                            ``forward``, ``loss_fn``, KV-cache
                            ``prefill`` / ``decode_step``, weights
                            carried from ``repro``
    repro_torch.configs  -- the architecture configs
    repro_torch.optim    -- AdamW, clipping, the cosine schedule, int8
                            error-feedback gradient compression
    repro_torch.train    -- the train steps
    repro_torch.checkpoint -- atomic, async checkpoints in the
                            reference's format
    repro_torch.launch   -- the logzip CLI (``compress``) and the LM
                            serving and training launchers (``serve``,
                            ``train``)

The package imports torch and numpy, never jax and nothing of ``repro``.
Entry points run their kernels on ``LogzipConfig.device`` ("cuda" by
default, which raises where there is no card); ``device="cpu"`` runs the
kernels' plain torch versions.
"""

__version__ = "0.1.0"
