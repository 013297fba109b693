"""Hand-written CUDA kernels for the H100 (sources in ``repro_torch/csrc``).

- wildcard_match:      batched wildcard-template matching (ISE, frozen store)
- colcodec_transform:  typed integer column transforms (delta / zigzag / FoR)

Each module holds the kernel's wrapper, its plain torch version (run for
CPU tensors) and its launch count; ``ops`` holds the numpy in/out wrappers
the pipeline calls and ``launch_counts``. Nothing is built at import.
"""
