"""Contact-map training data from motion / scene pairs (counterpart of
``afford_motion_tpu/prepare/contact_data.py``; reference:
prepare/generate_contact_data.py:361-487).

Per pair: crop a ``region_size`` square jittered around the pelvis
trajectory, sample ``num_points`` scene points, recentre (the xy box's
middle, the 2 % height floor) and compute the per-joint distance map: for
each scene point, the distance to the nearest position of each of the 22
joints over the trajectory. Writes what the datasets read:
``motions/{i:05d}.npy``, ``contacts/{i:05d}.npz`` (``points``, ``mask``,
``dist``) and ``anno.csv``.

The distance map is the stage's work on the device, in the JAX package's
expanded form ``|t|^2 - 2 t.s + |s|^2`` (the cross term one batched matmul,
float32 with TF32 off), clamped at 0, the min over the frames, the square
root. Pairs go in chunks of 16, their trajectories padded to a multiple of
32 frames with the padding frames set to +inf before the min. The host's
randomness (the region's jitter, the point choice) is numpy's generator,
drawn in the JAX package's order, so every file but ``dist`` is the JAX
package's byte for byte. :func:`joint_distance_map_plain` is the exact
brute force in float64 that the device path is checked against.
"""
from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

JOINTS = 22
CHUNK = 16
FRAME_BUCKET = 32
# the float32 expanded form's error bound on a squared distance, in unit
# roundoffs (2^-24) of |t|^2 + |s|^2 for the pair's largest trajectory and
# scene norms: |t|^2 and |s|^2 round to 2u of themselves, 2 t.s to 3u of
# 2|t||s|, the two sums and the square root once each, and the min over
# the frames keeps the bound; 16 holds it with room (see dist_excess)
DIST_UNITS = 16

Device = Union[str, torch.device]


def joint_distance_map_plain(pose_seq, scene_xyz) -> torch.Tensor:
    """Exact brute force in float64 with direct differences: (L, J, 3)
    trajectory and (N, 3) scene (numpy or tensors, on any device) -> (N, J)
    float64 min distances."""
    p = torch.as_tensor(pose_seq).double()
    s = torch.as_tensor(scene_xyz, device=p.device).double()
    return torch.stack([((s[:, None, :] - p[None, :, j, :]) ** 2).sum(-1).amin(1).sqrt()
                        for j in range(p.shape[1])], dim=-1)


def dist_excess(dist: np.ndarray, exact, pose_seq: np.ndarray, scene_xyz: np.ndarray) -> float:
    """The largest |dist^2 - exact^2| of a float32 distance map against the
    float64 brute force, in units of its bound ``DIST_UNITS * 2^-24 *
    (max|t|^2 + max|s|^2)``: at most 1 for a map within tolerance. The bound
    is on squares because the expanded form cancels near zero distance, where
    the square root magnifies the cancellation."""
    exact = np.asarray(torch.as_tensor(exact).cpu(), np.float64)
    t2 = float((np.asarray(pose_seq, np.float64) ** 2).sum(-1).max())
    s2 = float((np.asarray(scene_xyz, np.float64) ** 2).sum(-1).max())
    bound = DIST_UNITS * 2.0 ** -24 * (t2 + s2)
    return float(np.abs(np.asarray(dist, np.float64) ** 2 - exact ** 2).max() / bound)


def _distance_map(traj: torch.Tensor, lens: torch.Tensor, scene: torch.Tensor) -> torch.Tensor:
    """(B, L, J, 3) trajectories of ``lens`` valid frames and (B, N, 3)
    scenes, float32 on one device -> (B, N, J) min distances. The (B, L, J, N)
    squared distances are the one large buffer: the matmul writes it and the
    rest runs in place."""
    B, L, J, _ = traj.shape
    N = scene.shape[1]
    t2 = (traj * traj).sum(-1)                                        # (B, L, J)
    s2 = (scene * scene).sum(-1)                                      # (B, N)
    d2 = torch.bmm(traj.reshape(B, L * J, 3), scene.transpose(1, 2)).view(B, L, J, N)
    d2.mul_(-2.0).add_(t2[..., None]).add_(s2[:, None, None, :]).clamp_min_(0.0)
    pad = torch.arange(L, device=traj.device)[None, :] >= lens[:, None]
    d2.masked_fill_(pad[:, :, None, None], float("inf"))
    return d2.amin(dim=1).sqrt_().transpose(1, 2).contiguous()


def joint_distance_map(pose_seq: np.ndarray, scene_xyz: np.ndarray,
                       device: Device = "cuda") -> np.ndarray:
    """(L, 22, 3) trajectory and (N, 3) scene -> (N, 22) float32 min
    distances, computed on ``device``; the same row as the pair's in
    :func:`joint_distance_map_batch`."""
    traj = torch.from_numpy(np.ascontiguousarray(pose_seq, np.float32))[None].to(device)
    scene = torch.from_numpy(np.ascontiguousarray(scene_xyz, np.float32))[None].to(device)
    lens = torch.tensor([traj.shape[1]], device=device)
    return _distance_map(traj, lens, scene)[0].cpu().numpy()


def joint_distance_map_batch(pose_seqs: Sequence[np.ndarray], scenes: np.ndarray,
                             device: Device = "cuda") -> np.ndarray:
    """``B`` trajectories (L_i, J, 3) of any lengths and (B, N, 3) scenes ->
    (B, N, J) float32 min distances in one device call: the trajectories
    padded to a multiple of 32 frames, the padding frames +inf before the
    min, so that each row equals its pair's :func:`joint_distance_map`."""
    B, J = len(pose_seqs), pose_seqs[0].shape[1]
    lmax = -(-max(p.shape[0] for p in pose_seqs) // FRAME_BUCKET) * FRAME_BUCKET
    traj = np.zeros((B, lmax, J, 3), dtype=np.float32)
    for i, p in enumerate(pose_seqs):
        traj[i, : p.shape[0]] = p
    lens = torch.tensor([p.shape[0] for p in pose_seqs], device=device)
    scene = torch.from_numpy(np.ascontiguousarray(scenes, np.float32)).to(device)
    return _distance_map(torch.from_numpy(traj).to(device), lens, scene).cpu().numpy()


def _flush_pending(pending: List[Tuple], save_dir: str, device: Device) -> None:
    """The distance maps of a chunk of staged pairs in one batched call,
    then each pair's files."""
    dists = joint_distance_map_batch([p[1] for p in pending],
                                     np.stack([p[2][:, 0:3] for p in pending]), device)
    for (i, pose_seq, points, indices), dist in zip(pending, dists):
        np.save(os.path.join(save_dir, "motions", f"{i:05d}.npy"), pose_seq)
        np.savez(os.path.join(save_dir, "contacts", f"{i:05d}.npz"),
                 points=points, mask=indices, dist=np.ascontiguousarray(dist))


def process(
    motions: Sequence[Tuple],
    scene_data: Dict[str, Dict],
    save_dir: str,
    num_points: int = 8192,
    region_size: float = 4.0,
    traj_pad_ratio: float = 0.5,
    rng: Optional[np.random.Generator] = None,
    chunk: int = CHUNK,
    device: Device = "cuda",
) -> None:
    """Motion / scene pairs -> the ``contact_motion`` tree under ``save_dir``.

    ``motions``: (pose_seq (L, >= 66), texts or None, (scene_id, scene_trans
    4x4), other_info dict) each; ``scene_data``: scene_id -> {'pcd': (N, 6)
    xyz and rgb}. ``chunk`` pairs share one device call and are written
    together."""
    rng = rng or np.random.default_rng()
    traj_pad = region_size * traj_pad_ratio
    os.makedirs(os.path.join(save_dir, "motions"), exist_ok=True)
    os.makedirs(os.path.join(save_dir, "contacts"), exist_ok=True)

    anno_rows: List[List[str]] = []
    pending: List[Tuple] = []
    for i, (pose_seq, texts, (scene_id, scene_trans), other_info) in enumerate(motions):
        pose_seq = pose_seq.copy().astype(np.float32)
        pelvis_seq = pose_seq[:, :3]
        pose_seq = pose_seq[:, : JOINTS * 3].reshape(-1, JOINTS, 3)
        utterances = "$$".join(texts) if texts else ""
        append_info = "".join(str(v) for v in (other_info or {}).values())

        assert scene_id is not None
        scene_trans = np.asarray(scene_trans, dtype=np.float32)[0:3, -1].copy()

        # the region window around the trajectory, jittered
        traj_max = pelvis_seq.max(axis=0)[0:2]
        traj_min = pelvis_seq.min(axis=0)[0:2]
        traj_size = traj_max - traj_min
        traj_size = traj_size + traj_pad * np.exp(-traj_size)
        pad = np.maximum((region_size - traj_size) / 2, [0, 0])
        center = (traj_max + traj_min) / 2
        sample_xy = rng.uniform(low=center - pad, high=center + pad)
        region_min = sample_xy - region_size / 2
        region_max = sample_xy + region_size / 2

        scene_pcd = scene_data[scene_id]["pcd"].copy()
        scene_pcd[:, 0:3] += scene_trans
        in_region = (
            (scene_pcd[:, 0] >= region_min[0]) & (scene_pcd[:, 0] <= region_max[0])
            & (scene_pcd[:, 1] >= region_min[1]) & (scene_pcd[:, 1] <= region_max[1])
        )
        indices = np.arange(len(scene_pcd))[in_region]
        assert len(indices) > 0, "No points in the region!"
        while len(indices) < num_points:
            indices = np.concatenate([indices, indices])
        indices = rng.choice(indices, num_points, replace=False)

        points = scene_data[scene_id]["pcd"].copy()
        points[:, 0:3] += scene_trans
        points = points[indices]

        # recentre: the xy box's middle, the 2 % height floor
        xyz = points[:, 0:3]
        xy_center = (xyz[:, 0:2].max(axis=0) + xyz[:, 0:2].min(axis=0)) * 0.5
        z_height = np.percentile(xyz[:, 2], 2)
        trans_vec = np.array([-xy_center[0], -xy_center[1], -z_height], dtype=np.float32)
        points[:, 0:3] += trans_vec
        pose_seq = pose_seq + trans_vec
        scene_trans = scene_trans + trans_vec

        pending.append((i, pose_seq, points, indices))
        anno_rows.append([
            scene_id,
            f"{scene_trans[0]:.8f}", f"{scene_trans[1]:.8f}", f"{scene_trans[2]:.8f}",
            utterances, append_info,
        ])
        if len(pending) >= chunk:
            _flush_pending(pending, save_dir, device)
            pending = []
    if pending:
        _flush_pending(pending, save_dir, device)

    with open(os.path.join(save_dir, "anno.csv"), "w", newline="") as fp:
        writer = csv.writer(fp)
        writer.writerow(["scene_id", "scene_trans_x", "scene_trans_y", "scene_trans_z",
                         "utterance", "others"])
        writer.writerows(anno_rows)
