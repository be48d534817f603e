"""Host-side datasets of the port (copies of the jax-free modules of
``afford_motion_tpu/data``): the HumanML3D family, the MotionX family with
its example and custom sets, and the packed store."""
from .base import (
    BaseDataset,
    contact_to_dist,
    create_dataset,
    extract_contact,
    gaussian_contact,
    pad_motion,
)
from .loader import DataLoader, collate_fn_general
from .transforms import make_default_transform

# Register dataset classes on import (reference imports trigger the same).
from . import humanml3d as _humanml3d  # noqa: F401
from . import motionx as _motionx  # noqa: F401

__all__ = [
    "BaseDataset",
    "create_dataset",
    "DataLoader",
    "collate_fn_general",
    "make_default_transform",
    "extract_contact",
    "gaussian_contact",
    "contact_to_dist",
    "pad_motion",
]
