"""PyTorch and CUDA port of the openwhisk_tpu placement core.

The JAX package `openwhisk_tpu` is the reference; every module here mirrors
its counterpart's path and is held against it, bit for bit, by the
`tests/test_torch_*.py` suites. This package imports `torch` and never
`jax`, and nothing of `openwhisk_tpu`: what it needs from there is copied.

Entry points run on the CUDA card unless the caller passes
`device="cpu"`; the hand-written Hopper kernels live in `csrc/` and are
built with `nvcc` at first use (`ops/_build.py`).
"""
