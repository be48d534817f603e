"""Hand-written Hopper kernels (``afford_motion_torch/csrc``): nvcc build,
ctypes binding, and one wrapper + plain PyTorch version per kernel."""
