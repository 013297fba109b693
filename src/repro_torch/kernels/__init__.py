"""Hand-written CUDA kernels for the H100 (sources in ``repro_torch/csrc``).

- wildcard_match:      batched wildcard-template matching (ISE, frozen store)
- colcodec_transform:  typed integer column transforms (delta / zigzag / FoR)
- tokenize_hash:       byte tokenizer masks + two rolling-hash prefix scans
- simcount:            common-token counts φ of lines x templates
- match_extract:       fused lowest-id match + per-star parameter spans

Each module holds the kernel's wrapper, its plain torch version (run for
CPU tensors) and its launch count; ``ops`` holds the numpy in/out wrappers
the pipeline and the kernel benchmark call, and ``launch_counts``.
Nothing is built at import.
"""
