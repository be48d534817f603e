"""The benchmark of the PyTorch and CUDA package ``afford_motion_torch``
(``perfbench/run.py``)."""
