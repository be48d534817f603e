"""Physics metrics: scene <-> body signed distance on the device
(counterpart of ``afford_motion_tpu/eval/physics.py``).

Per frame, every scene point finds its nearest body vertex; the sign comes
from that vertex's normal (positive = inside the body). Two routes find the
nearest vertex, under the JAX package's names: ``pallas`` is the fused 1-NN
kernel (``ops/cuda/sdf.py``: exact coordinate-difference distances), ``xla``
the matmul-form path ``|p|^2 - 2 p.v + |v|^2`` that materialises the (O, H)
matrix. Everything is float32; the matmul-form path needs TF32 off, which
the entry points see to. Vertex normals sum each vertex's face normals in
ascending face order through an incidence table (no atomics), so the
metrics are the same from run to run on the card and agree with the CPU's.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.cuda.sdf import nn1_cuda


def incidence_table(vert_of: np.ndarray, face_of: np.ndarray, n_verts: int,
                    n_faces: int) -> np.ndarray:
    """(vertex, face) incidence pairs -> (n_verts, max degree) int64 table of
    each vertex's faces in ascending order (a face listed once per corner
    that names the vertex), padded with ``n_faces``: the index of a zero row.
    The pairs may come in any order; the table does not depend on it."""
    order = np.lexsort((face_of, vert_of))
    vert_of, face_of = vert_of[order], face_of[order]
    degree = np.bincount(vert_of, minlength=n_verts)
    first = np.concatenate([[0], np.cumsum(degree)[:-1]])
    table = np.full((n_verts, max(1, int(degree.max(initial=0)))), n_faces, dtype=np.int64)
    table[vert_of, np.arange(len(vert_of)) - first[vert_of]] = face_of
    return table


def face_table(faces: torch.Tensor, n_verts: int) -> torch.Tensor:
    """The incidence table of ``faces`` (F, 3) over ``n_verts`` vertices, on
    the faces' device: build it once per mesh and pass it to the functions
    below (the evaluator does), which otherwise build it on every call."""
    f = faces.detach().cpu().numpy().astype(np.int64)
    corners = np.arange(f.size) // 3
    table = incidence_table(f.reshape(-1), corners, n_verts, len(f))
    return torch.from_numpy(table).to(faces.device)


def vertex_normals(verts: torch.Tensor, faces: torch.Tensor,
                   table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Area-weighted vertex normals, (..., H, 3) from faces (F, 3) int. Each
    vertex sums its face normals one face at a time in ascending face order
    (the columns of ``table``, :func:`face_table`), the same order on every
    device."""
    if table is None:
        table = face_table(faces, verts.shape[-2])
    faces = faces.long()
    fv = verts[..., faces, :]                                   # (..., F, 3, 3)
    e1 = fv[..., 1, :] - fv[..., 0, :]
    e2 = fv[..., 2, :] - fv[..., 0, :]
    e1 = e1 / (torch.linalg.norm(e1, dim=-1, keepdim=True) + 1e-12)
    e2 = e2 / (torch.linalg.norm(e2, dim=-1, keepdim=True) + 1e-12)
    fn = torch.linalg.cross(e1, e2, dim=-1)                     # (..., F, 3)
    fn = torch.cat([fn, torch.zeros_like(fn[..., :1, :])], dim=-2)   # row F: the padding
    vn = fn[..., table[:, 0], :]
    for j in range(1, table.shape[1]):
        vn = vn + fn[..., table[:, j], :]
    return vn / (torch.linalg.norm(vn, dim=-1, keepdim=True) + 1e-12)


def _signed(points, closest, normal, dist):
    to_surface = closest - points
    to_surface = to_surface / (torch.linalg.norm(to_surface, dim=-1, keepdim=True) + 1e-12)
    return torch.sign(torch.sum(to_surface * normal, dim=-1)) * dist


def signed_distance_to_body(points: torch.Tensor, verts: torch.Tensor, faces: torch.Tensor,
                            table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Signed distance of each scene point to the body surface, (O,), by the
    matmul-form path. Positive = inside the body (penetration), negative =
    outside: the vertex-normal sign convention."""
    vn = vertex_normals(verts, faces, table)                     # (H, 3)
    p2 = torch.sum(points * points, dim=-1, keepdim=True)
    v2 = torch.sum(verts * verts, dim=-1, keepdim=True).T
    d2 = torch.clamp_min(p2 - 2.0 * torch.matmul(points, verts.T) + v2, 0.0)   # (O, H)
    # the first index of the minimum, as jnp.argmin gives it
    m = d2.min(dim=-1, keepdim=True).values
    col = torch.arange(d2.shape[1], device=d2.device)
    idx = torch.where(d2 == m, col, d2.shape[1]).min(dim=-1).values
    return _signed(points, verts[idx], vn[idx], torch.sqrt(m[:, 0]))


def _resolve_kernel(kernel: str) -> str:
    """``auto`` -> the fused 1-NN kernel, which takes any shape; the
    matmul-form path is the reference route, taken only when ``xla`` is
    named. ``AM_SDF_KERNEL=xla|pallas`` is a debug override."""
    kernel = os.environ.get("AM_SDF_KERNEL", kernel)
    if kernel == "auto":
        kernel = "pallas"
    if kernel not in ("pallas", "xla"):
        raise ValueError(f"unknown sdf kernel {kernel!r} (auto, pallas or xla)")
    return kernel


def signed_distance_seq(
    points: torch.Tensor,       # (O, 3)
    verts_seq: torch.Tensor,    # (L, H, 3)
    faces: torch.Tensor,        # (F, 3)
    kernel: str = "auto",
    table: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(L, O) signed distances over a sequence. ``pallas`` fuses the per-frame
    1-NN in the kernel; ``xla`` is the matmul-form path, frame by frame."""
    kernel = _resolve_kernel(kernel)
    if kernel == "xla":
        return torch.stack([signed_distance_to_body(points, v, faces, table) for v in verts_seq])

    d2, idx = nn1_cuda(points.contiguous(), verts_seq.contiguous())       # (L, O)
    vn = vertex_normals(verts_seq, faces, table)                           # (L, H, 3)
    wide = idx.long()[..., None].expand(-1, -1, 3)
    closest = torch.gather(verts_seq, 1, wide)                             # (L, O, 3)
    return _signed(points[None], closest, torch.gather(vn, 1, wide),
                   torch.sqrt(torch.clamp_min(d2, 0.0)))


@torch.no_grad()
def physics_over_sequence(
    points: torch.Tensor,       # (O, 3) scene points
    verts_seq: torch.Tensor,    # (L, H, 3) body vertices per frame (padded)
    faces: torch.Tensor,        # (F, 3)
    contact_threshold: float = 0.05,
    kernel: str = "auto",
    table: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-frame (non_collision, contact) over a padded sequence, (L,) each;
    the caller averages over the valid frames."""
    sdf = signed_distance_seq(points, verts_seq, faces, kernel, table)     # (L, O)
    non_collision = torch.mean((sdf <= 0).to(torch.float32), dim=1)
    contact = (torch.sum((sdf > -contact_threshold).to(torch.int32), dim=1) > 0
               ).to(torch.float32)
    return non_collision, contact


@torch.no_grad()
def dist_to_obj(points: torch.Tensor, verts: torch.Tensor, faces: torch.Tensor,
                table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """min(max signed distance, 0) of object points to an anchor body frame."""
    sdf = signed_distance_to_body(points, verts, faces, table)
    return torch.clamp_max(sdf.max(), 0.0)


def compute_pairwise_distance(x: np.ndarray) -> float:
    """Average pairwise l2 distance across k samples, per frame: the APD
    diversity metric."""
    k, n, d = x.shape
    diff = x[:, None, :, :] - x[None, :, :, :]           # (k, k, n, d)
    dist = np.linalg.norm(diff, axis=-1)                 # (k, k, n)
    return float(dist.sum() / (k * (k - 1)) / n)
