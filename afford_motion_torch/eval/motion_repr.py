"""HumanML3D motion representation utilities (counterpart of
``afford_motion_tpu/eval/motion_repr.py``)
(reference: utils/visualize.py:443-505 and the duplicate in
visualize_h3d.py:68-104): quaternion ops + recovery of global joint
positions from the 263-d rotation-invariant coordinates. Pure numpy (these
run host-side in visualizers/evaluators)."""
from __future__ import annotations

import numpy as np


def qinv(q: np.ndarray) -> np.ndarray:
    """Quaternion conjugate, (..., 4) wxyz."""
    out = q.copy()
    out[..., 1:] = -out[..., 1:]
    return out


def qrot(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    assert q.shape[-1] == 4 and v.shape[-1] == 3
    qvec = q[..., 1:]
    uv = np.cross(qvec, v)
    uuv = np.cross(qvec, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def recover_root_rot_pos(data: np.ndarray):
    """Integrate root rotation velocity + planar velocity into a global
    root quaternion + position (reference: visualize.py:470-489)."""
    rot_vel = data[..., 0]
    r_rot_ang = np.zeros_like(rot_vel)
    r_rot_ang[..., 1:] = rot_vel[..., :-1]
    r_rot_ang = np.cumsum(r_rot_ang, axis=-1)

    r_rot_quat = np.zeros(data.shape[:-1] + (4,), dtype=data.dtype)
    r_rot_quat[..., 0] = np.cos(r_rot_ang)
    r_rot_quat[..., 2] = np.sin(r_rot_ang)

    r_pos = np.zeros(data.shape[:-1] + (3,), dtype=data.dtype)
    r_pos[..., 1:, [0, 2]] = data[..., :-1, 1:3]
    r_pos = qrot(qinv(r_rot_quat), r_pos)
    r_pos = np.cumsum(r_pos, axis=-2)
    r_pos[..., 1] = data[..., 3]
    return r_rot_quat, r_pos


def recover_from_ric(data: np.ndarray, joints_num: int = 22) -> np.ndarray:
    """263-d HumanML3D vectors (..., L, D) -> joint positions
    (..., L, joints_num, 3) (reference: visualize.py:491-505)."""
    r_rot_quat, r_pos = recover_root_rot_pos(data)
    positions = data[..., 4: (joints_num - 1) * 3 + 4]
    positions = positions.reshape(positions.shape[:-1] + (-1, 3))

    q = np.broadcast_to(
        qinv(r_rot_quat)[..., None, :], positions.shape[:-1] + (4,)
    )
    positions = qrot(q, positions)
    positions = positions.copy()
    positions[..., 0] += r_pos[..., 0:1]
    positions[..., 2] += r_pos[..., 2:3]
    return np.concatenate([r_pos[..., None, :], positions], axis=-2)
