"""Data parallelism over processes, one per card, and host-to-device
pipelining (counterpart of ``afford_motion_tpu/parallel``); see
``mesh.py``."""
from .mesh import DataParallel, DevicePrefetcher, current, is_main, launched, session

__all__ = ["DataParallel", "DevicePrefetcher", "current", "is_main", "launched", "session"]
