"""Data-loader checks (counterpart of ``afford_motion_tpu/utils/debug.py``;
reference: utils/debug.py:13-80). The reference opens trimesh windows; here
a batch's statistics go to the log and its clouds to PLY files, to look at
offline. The loaders are the port's (``data/loader.py``), whose batches
hold tensors or arrays."""
from __future__ import annotations

import os

import numpy as np

from .io import get_logger
from .mesh import colormap_values, export_pointcloud_ply

logger = get_logger()


def debug_motionx_dataloader(dataloader, out_dir: str = "outputs/debug",
                             n_batches: int = 1) -> None:
    """Per batch: the motions' shape, mean, std and valid frames, the first
    texts, and the first two items' scene clouds as PLYs (reference:
    utils/debug.py:13-56)."""
    os.makedirs(out_dir, exist_ok=True)
    for bi, batch in enumerate(dataloader):
        if bi >= n_batches:
            break
        x = batch["x"]
        logger.info(
            f"batch {bi}: x {x.shape} mean={x.mean():.4f} std={x.std():.4f} "
            f"valid_frames={(~batch['x_mask']).sum(1) if 'x_mask' in batch else 'n/a'}"
        )
        if "c_pc_xyz" in batch:
            for i in range(min(2, len(x))):
                export_pointcloud_ply(os.path.join(out_dir, f"b{bi}_s{i}_scene.ply"),
                                      np.asarray(batch["c_pc_xyz"][i]))
        logger.info(f"texts: {batch.get('c_text', [])[:4]}")


def debug_contact_map_dataloader(dataloader, out_dir: str = "outputs/debug",
                                 n_batches: int = 1, joint: int = 0) -> None:
    """Per batch: the first two items' contact maps of ``joint`` as coloured
    clouds, and the maps' range (reference: utils/debug.py:58-80)."""
    os.makedirs(out_dir, exist_ok=True)
    for bi, batch in enumerate(dataloader):
        if bi >= n_batches:
            break
        x = np.asarray(batch["x"])
        xyz = np.asarray(batch["c_pc_xyz"])
        contact = dataloader.dataset.denormalize(x, clip=True)
        for i in range(min(2, len(x))):
            export_pointcloud_ply(os.path.join(out_dir, f"b{bi}_s{i}_contact_j{joint}.ply"),
                                  xyz[i], colormap_values(contact[i][:, joint]))
        logger.info(f"batch {bi}: contact range [{contact.min():.4f}, {contact.max():.4f}]")
