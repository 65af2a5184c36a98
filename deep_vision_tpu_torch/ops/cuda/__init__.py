"""Hand-written CUDA kernels: one wrapper module each, built from
`deep_vision_tpu_torch/csrc/` at first use by build.py."""
