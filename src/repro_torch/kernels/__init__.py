"""Hand-written CUDA kernels for the H100 (sources in ``repro_torch/csrc``).

- wildcard_match_first: lowest-id wildcard-template match per line, one
                       first-hit launch per ``match_first`` (ISE, frozen store)
- wildcard_match:      the (N, K) wildcard-template match matrix
- colcodec_transform:  typed integer column transforms (delta / zigzag / FoR)
- tokenize_hash:       byte tokenizer masks + two rolling-hash prefix scans
- simcount:            common-token counts φ of lines x templates
- match_extract:       fused lowest-id match + per-star parameter spans
- distinct_counts:     weighted histogram of an inverse index (query scans)

Each module holds the kernel's wrapper, its plain torch version (run for
CPU tensors) and its launch count; ``ops`` holds the numpy in/out wrappers
the pipeline and the kernel benchmark call, and ``launch_counts``.
Nothing is built at import.
"""
