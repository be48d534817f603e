"""Point ops, the point hierarchy and the CUDA kernel wrappers."""
