"""SMPL-X body model (linear blend skinning) in PyTorch (counterpart of
``afford_motion_tpu/eval/smplx_lbs.py``).

A neutral SMPL-X layer driven by 69-d params: transl(3), orient(3,
axis-angle), body_pose(63 = 21 joints axis-angle); hands and face stay at
rest. Loads the official ``SMPLX_NEUTRAL.npz`` where it is on disk; a
synthetic model with the same structure, drawn from the same numpy stream as
the JAX package's, drives tests and shape-honest runs without the asset.

Everything is float32 and batched over frames with the batch dimension
written out; the products are plain ``torch.matmul`` / ``einsum`` calls, so
the caller keeps TF32 off (the entry points do). The forward is
differentiable: the refinement of ``joints_to_smplx`` takes its gradient
through :func:`smplx_joints`.
"""
from __future__ import annotations

import functools
import os
from dataclasses import dataclass, fields
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch

NUM_JOINTS = 55          # SMPL-X: pelvis + 21 body + jaw + 2 eyes + 30 hand
NUM_BODY_JOINTS = 21


@dataclass
class SMPLXModel:
    v_template: torch.Tensor    # (V, 3)
    shapedirs: torch.Tensor     # (V, 3, n_betas)
    posedirs: torch.Tensor      # ((J-1)*9, V*3)
    J_regressor: torch.Tensor   # (J, V)
    lbs_weights: torch.Tensor   # (V, J)
    parents: torch.Tensor       # (J,) int32, parents[0] == -1
    faces_arr: torch.Tensor     # (F, 3) int32

    @property
    def faces(self) -> np.ndarray:
        return self.faces_arr.cpu().numpy()

    @property
    def num_vertices(self) -> int:
        return self.v_template.shape[0]

    @functools.cached_property
    def parents_tuple(self) -> Tuple[int, ...]:
        """The parent table on the host (the chain's level plan reads it)."""
        return tuple(int(p) for p in self.parents.cpu().numpy())

    def to(self, device: Union[str, torch.device]) -> "SMPLXModel":
        return SMPLXModel(**{f.name: getattr(self, f.name).to(device) for f in fields(self)})

    @classmethod
    def from_numpy(cls, **arrays: np.ndarray) -> "SMPLXModel":
        """Arrays under this class's field names -> a model on the CPU; float
        fields as float32, ``parents`` and ``faces_arr`` as int32."""
        ints = ("parents", "faces_arr")
        return cls(**{
            f.name: torch.tensor(
                np.asarray(arrays[f.name], dtype=np.int32 if f.name in ints else np.float32))
            for f in fields(cls)})

    # ------------------------------------------------------------------ load
    @classmethod
    def load(cls, path: str) -> "SMPLXModel":
        """Load from the official SMPLX_NEUTRAL.npz (allow_pickle for the
        chumpy-free exports); keys: v_template, shapedirs, posedirs,
        J_regressor, weights, kintree_table, f."""
        data = np.load(path, allow_pickle=True)
        parents = np.asarray(data["kintree_table"])[0].astype(np.int64)
        parents[0] = -1
        posedirs = np.asarray(data["posedirs"], dtype=np.float32)  # (V, 3, (J-1)*9)
        posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T      # ((J-1)*9, V*3)
        return cls.from_numpy(
            v_template=data["v_template"],
            shapedirs=np.asarray(data["shapedirs"], dtype=np.float32)[..., :10],
            posedirs=posedirs,
            J_regressor=data["J_regressor"],
            lbs_weights=data["weights"],
            parents=parents,
            faces_arr=np.asarray(data["f"], dtype=np.int64),
        )

    @classmethod
    def load_default(cls) -> "SMPLXModel":
        if os.environ.get("SMPLX_USE_SYNTHETIC"):
            # runs without the real body model on disk;
            # SMPLX_SYNTHETIC_VERTS/FACES pick the mesh resolution (10475 /
            # 20908 is the official one, so every LBS and SDF shape is real)
            nv = int(os.environ.get("SMPLX_SYNTHETIC_VERTS", "128"))
            nf = os.environ.get("SMPLX_SYNTHETIC_FACES", "")
            return cls.synthetic(num_verts=nv, num_faces=int(nf) if nf else None)
        for cand in (
            os.environ.get("SMPLX_MODEL_PATH", ""),
            "./data/smplx/SMPLX_NEUTRAL.npz",
            "./data/body_models/smplx/SMPLX_NEUTRAL.npz",
        ):
            if cand and Path(cand).exists():
                return cls.load(cand)
        raise FileNotFoundError(
            "SMPL-X body model not found (set SMPLX_MODEL_PATH or place "
            "SMPLX_NEUTRAL.npz under ./data/smplx/)"
        )

    @classmethod
    def synthetic(cls, num_verts: int = 128, seed: int = 0,
                  num_faces: Optional[int] = None) -> "SMPLXModel":
        """Random model with the real kinematic structure. At
        ``num_verts=10475, num_faces=20908`` (the official SMPL-X mesh
        resolution) every product and scatter of the LBS and SDF paths has
        its real dimensions; only the values are random. The draws follow
        the JAX package's ``synthetic`` one for one, so a seed gives the
        same model in both packages."""
        rng = np.random.default_rng(seed)
        # SMPL-X parent table (first 22 joints are the body; the rest hang
        # off wrists/neck)
        parents = np.array(
            [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
             15, 15, 15,
             20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,
             21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53],
            dtype=np.int64,
        )
        J = len(parents)
        v_template = rng.normal(size=(num_verts, 3)).astype(np.float32) * 0.3
        # J_regressor: soft assignment so regressed joints are plausible
        reg = np.abs(rng.normal(size=(J, num_verts)).astype(np.float32))
        reg = reg / reg.sum(axis=1, keepdims=True)
        w = np.abs(rng.normal(size=(num_verts, J)).astype(np.float32))
        w = w / w.sum(axis=1, keepdims=True)
        n_faces = num_faces if num_faces is not None else max(num_verts, 4)
        faces = rng.integers(0, num_verts, size=(n_faces, 3)).astype(np.int64)
        return cls.from_numpy(
            v_template=v_template,
            shapedirs=rng.normal(size=(num_verts, 3, 10)).astype(np.float32) * 0.01,
            posedirs=rng.normal(size=((J - 1) * 9, num_verts * 3)).astype(np.float32) * 0.001,
            J_regressor=reg,
            lbs_weights=w,
            parents=parents,
            faces_arr=faces,
        )


def rodrigues(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3), in the closed
    form ``R = cos(a) I + sin(a) K + (1 - cos(a)) n n^T`` built elementwise."""
    angle = torch.linalg.norm(axis_angle, dim=-1, keepdim=True)
    axis = axis_angle / torch.clamp_min(angle, 1e-8)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    a = angle[..., 0]
    s, c = torch.sin(a), torch.cos(a)
    C = 1.0 - c
    R = torch.stack([
        c + C * x * x,     -s * z + C * x * y, s * y + C * x * z,
        s * z + C * x * y, c + C * y * y,      -s * x + C * y * z,
        -s * y + C * x * z, s * x + C * y * z, c + C * z * z,
    ], dim=-1)
    return R.reshape(axis_angle.shape[:-1] + (3, 3))


def _matmul44(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched 4x4 product in multiply-and-sum form (the JAX package's
    summation order, exact float32)."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(dim=-2)


@functools.lru_cache(maxsize=8)
def _tree_levels(parents: tuple) -> tuple:
    """Joints grouped by kinematic-tree depth: ((idx, parent_idx), ...) for
    depths 1..max. The chain composes level by level (depth ~11 for
    SMPL-X) instead of joint by joint (54 sequential 4x4 products)."""
    parents_np = np.asarray(parents)
    depth = np.zeros(len(parents_np), np.int64)
    for j in range(1, len(parents_np)):
        depth[j] = depth[parents_np[j]] + 1
    levels = []
    for d in range(1, int(depth.max()) + 1):
        idx = np.where(depth == d)[0]
        levels.append((idx, parents_np[idx]))
    return tuple(levels)


def _rigid_transform(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., J, 3, 3), (..., J, 3) -> (..., J, 4, 4) homogeneous."""
    top = torch.cat([R, t[..., None]], dim=-1)                      # (..., J, 3, 4)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    bottom = bottom.expand(*R.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def chain_transforms(R: torch.Tensor, rel: torch.Tensor, parents: Tuple[int, ...]
                     ) -> torch.Tensor:
    """Per-joint local rigid transforms -> global transforms along the
    kinematic tree. R (..., J, 3, 3), rel (..., J, 3) -> (..., J, 4, 4).
    Level-batched: every joint at tree depth d composes with its (already
    final) parent in one batched 4x4 product. Joints are read by indexing,
    whose gradient on a CUDA device is summed in a fixed order (a parent may
    have several children at one depth); ``index_select``'s is summed with
    float atomics, and the fit's result would vary from run to run."""
    T_local = _rigid_transform(R, rel)
    A = T_local
    dim = T_local.ndim - 3
    lead = (slice(None),) * dim
    for idx, par in _tree_levels(tuple(parents)):
        idx_t = torch.as_tensor(idx, device=R.device)
        par_t = torch.as_tensor(par, device=R.device)
        new = _matmul44(A[lead + (par_t,)], T_local[lead + (idx_t,)])
        A = A.index_copy(dim, idx_t, new)   # out of place: autograd-safe
    return A


def _full_pose_rotations(orient: torch.Tensor, body_pose: torch.Tensor, J: int) -> torch.Tensor:
    """(B, 3), (B, 63) -> (B, J, 3, 3): the 22 driven joints, the rest at
    rest (the identity)."""
    B = orient.shape[0]
    rest = torch.zeros((B, J - 1 - NUM_BODY_JOINTS, 3), dtype=orient.dtype, device=orient.device)
    full_pose = torch.cat([orient[:, None, :], body_pose.reshape(B, NUM_BODY_JOINTS, 3), rest],
                          dim=1)
    return rodrigues(full_pose)


def _relative_joints(joints0: torch.Tensor, parents: Tuple[int, ...]) -> torch.Tensor:
    """Rest joints (..., J, 3) -> offsets from each joint's parent (the root
    keeps its position)."""
    par = torch.as_tensor(parents[1:], device=joints0.device)
    return torch.cat([joints0[..., :1, :],
                      joints0[..., 1:, :] - joints0.index_select(-2, par)], dim=-2)


def smplx_forward(
    model: SMPLXModel,
    transl: torch.Tensor,      # (B, 3)
    orient: torch.Tensor,      # (B, 3) axis-angle
    body_pose: torch.Tensor,   # (B, 63) axis-angle for joints 1..21
    betas: Optional[torch.Tensor] = None,  # (B, n_betas)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (vertices (B, V, 3), joints (B, J, 3))."""
    B = transl.shape[0]
    J = model.parents.shape[0]
    parents = model.parents_tuple
    if betas is None:
        betas = torch.zeros((B, model.shapedirs.shape[-1]), dtype=transl.dtype,
                            device=transl.device)
    v_shaped = model.v_template + torch.einsum("vdk,bk->bvd", model.shapedirs, betas)
    joints0 = torch.matmul(model.J_regressor, v_shaped)               # (B, J, 3)

    R = _full_pose_rotations(orient, body_pose, J)                    # (B, J, 3, 3)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    pose_feature = (R[:, 1:] - eye).reshape(B, -1)                    # (B, (J-1)*9)
    v_posed = v_shaped + torch.matmul(pose_feature, model.posedirs).reshape(B, -1, 3)

    A = chain_transforms(R, _relative_joints(joints0, parents), parents)   # (B, J, 4, 4)
    posed_joints = A[:, :, :3, 3]

    # remove the rest-pose joint locations from the skinning transforms
    correction = (A[:, :, :3, :3] * joints0[:, :, None, :]).sum(dim=-1)     # (B, J, 3)
    A_skin = torch.cat([A[:, :, :3, :3], (A[:, :, :3, 3] - correction)[..., None]], dim=-1)
    # only the top three rows of the blend are read
    T = torch.einsum("vj,bjac->bvac", model.lbs_weights, A_skin)      # (B, V, 3, 4)
    verts = (T[..., :3] * v_posed[:, :, None, :]).sum(dim=-1) + T[..., 3]
    return verts + transl[:, None, :], posed_joints + transl[:, None, :]


def smplx_joints(
    model: SMPLXModel,
    transl: torch.Tensor,      # (B, 3)
    orient: torch.Tensor,      # (B, 3) axis-angle
    body_pose: torch.Tensor,   # (B, 63)
    betas: Optional[torch.Tensor] = None,  # (B, n_betas)
) -> torch.Tensor:
    """Joints-only forward (B, J, 3): what ``smplx_forward(...)[1]`` gives,
    without the pose blendshapes and the vertex skinning, which the joints do
    not depend on. With ``betas=None`` the rest-pose joints are a constant of
    the model, regressed once instead of per frame. This is the hot path of
    the Adam refinement, which optimises a joints-only error."""
    J = model.parents.shape[0]
    parents = model.parents_tuple
    if betas is None:
        joints0 = torch.matmul(model.J_regressor, model.v_template)   # (J, 3)
        rel = _relative_joints(joints0, parents).expand(transl.shape[0], -1, -1)
    else:
        v_shaped = model.v_template + torch.einsum("vdk,bk->bvd", model.shapedirs, betas)
        rel = _relative_joints(torch.matmul(model.J_regressor, v_shaped), parents)
    R = _full_pose_rotations(orient, body_pose, J)
    A = chain_transforms(R, rel, parents)
    return A[:, :, :3, 3] + transl[:, None, :]


def params_to_verts_joints(model: SMPLXModel, params: torch.Tensor):
    """69-d param rows -> (verts, joints[:, :22])."""
    transl, orient, body_pose = params[:, :3], params[:, 3:6], params[:, 6:69]
    verts, joints = smplx_forward(model, transl, orient, body_pose)
    return verts, joints[:, :22, :]


def params_to_joints(model: SMPLXModel, params: torch.Tensor) -> torch.Tensor:
    """69-d param rows -> joints (B, 22, 3) via the joints-only forward."""
    transl, orient, body_pose = params[:, :3], params[:, 3:6], params[:, 6:69]
    return smplx_joints(model, transl, orient, body_pose)[:, :22, :]
