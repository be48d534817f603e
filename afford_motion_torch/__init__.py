"""PyTorch / CUDA port of afford_motion_tpu (JAX on TPU): same layout, same
numerics, hand-written Hopper kernels in ``csrc/``. Imports torch, never jax."""
