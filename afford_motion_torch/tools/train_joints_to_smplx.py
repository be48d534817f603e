"""Train the joints -> SMPL-X parameter regressor that the scene protocol's
fit reads (counterpart of the root ``tools/train_joints_to_smplx.py``).

Data: the SMPL-X parameter pickles of ``prepare process``
(``{set}/motions/*.pkl``, each ``(pose_seq (L, >= 69), betas)``); sequences
of 24..196 frames are kept, and their 22-joint inputs are made from
``pose_seq[:, :69]`` by the port's LBS (``eval/smplx_lbs.py``, the body at
its rest shape, as the root tool does), so joints and parameters agree with
the body model the fit uses. A step: the regressor in train mode (dropout
0.1, masks from an explicit generator) on a padded batch, the masked
parameter MSE plus ``--joint_loss_weight`` times the masked joint MSE
through the frozen LBS (its joints; the vertices, which the loss does not
read, are not computed), and Adam with optax's defaults (b1 0.9, b2 0.999,
eps 1e-8 outside the square root, bias-corrected moments). Batches are
drawn as the root tool draws them, ``np.random.default_rng(0).integers``.
The weights go to ``--out`` as the JAX package's flat-key ``.npz``, which
both packages' ``JointsToSMPLXFitter`` load.

    python -m afford_motion_torch.tools.train_joints_to_smplx --data_dir ./data \\
        --sets HUMANISE PROX --steps 60000 \\
        --out ./utils/joints_to_smplx/regressor.npz [--device cpu]

It runs on ``cuda:0`` unless ``--device`` names another device, and raises
without a card otherwise. The body model is ``SMPLXModel.load_default()``
(``SMPLX_MODEL_PATH``, or ``SMPLX_USE_SYNTHETIC=1``).
"""
from __future__ import annotations

import argparse
import glob
import os
import pickle
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..eval.joints_to_smplx import PARAM_DIM, JointsToSMPLXRegressor, save_regressor_npz
from ..eval.smplx_lbs import SMPLXModel, params_to_joints
from ..models.layers import set_dropout_generator
from ..utils.device import resolve_device
from ..utils.io import get_logger

logger = get_logger()
JOINT_DIM = 66


def build_pairs(data_dir: str, sets: Sequence[str], model: SMPLXModel, max_len: int = 196,
                min_len: int = 24, max_files: Optional[int] = None
                ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(joints (L, 66), params (L, 69)) float32 for every pickle of
    ``{set}/motions`` in sorted order (the first ``max_files`` a set) whose
    length lies in [min_len, max_len]; the joints from the LBS on the
    model's device."""
    dev = model.v_template.device
    pairs = []
    for s in sets:
        files = sorted(glob.glob(os.path.join(data_dir, s, "motions", "*.pkl")))
        if max_files:
            files = files[:max_files]
        for f in files:
            with open(f, "rb") as fp:
                pose_seq, _betas = pickle.load(fp)
            if not (min_len <= len(pose_seq) <= max_len):
                continue
            params = np.asarray(pose_seq[:, :PARAM_DIM], dtype=np.float32)
            with torch.no_grad():
                joints = params_to_joints(model, torch.from_numpy(params).to(dev))
            pairs.append((joints.cpu().numpy().reshape(len(params), JOINT_DIM), params))
    return pairs


def pad_batch(pairs, idxs, max_len: int = 196):
    """The pairs ``idxs`` padded to ``max_len`` frames: (joints, params,
    mask), mask True on padded frames."""
    B = len(idxs)
    joints = np.zeros((B, max_len, JOINT_DIM), dtype=np.float32)
    params = np.zeros((B, max_len, PARAM_DIM), dtype=np.float32)
    mask = np.ones((B, max_len), dtype=bool)
    for b, i in enumerate(idxs):
        j, p = pairs[i]
        L = len(j)
        joints[b, :L], params[b, :L], mask[b, :L] = j, p, False
    return joints, params, mask


class RegressorTrainer:
    """The regressor, the frozen body model and Adam's moments: one
    :meth:`step` a batch. The regressor must be in the mode the caller
    wants (train for dropout)."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, regressor: JointsToSMPLXRegressor, body: SMPLXModel, lr: float = 1e-4,
                 joint_loss_weight: float = 1.0):
        self.regressor, self.body = regressor, body
        self.lr, self.joint_loss_weight = lr, joint_loss_weight
        self.params = [p for p in regressor.parameters()]
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def losses(self, joints: torch.Tensor, gt_params: torch.Tensor, mask: torch.Tensor):
        """(loss, params MSE, joints MSE) of the batch, masked frames left
        out of both means."""
        pred = self.regressor(joints, mask)
        valid = (~mask).to(torch.float32)[..., None]
        n = torch.sum(valid)
        p_loss = torch.sum(((pred - gt_params) ** 2) * valid) / torch.clamp_min(n * PARAM_DIM, 1.0)
        B, L, _ = pred.shape
        j = params_to_joints(self.body, pred.reshape(B * L, PARAM_DIM)).reshape(B, L, JOINT_DIM)
        j_loss = torch.sum(((j - joints) ** 2) * valid) / torch.clamp_min(n * JOINT_DIM, 1.0)
        return p_loss + self.joint_loss_weight * j_loss, p_loss, j_loss

    def step(self, joints: torch.Tensor, gt_params: torch.Tensor, mask: torch.Tensor):
        """One Adam step on the batch; returns the losses before it."""
        with torch.enable_grad():
            loss, p_loss, j_loss = self.losses(joints, gt_params, mask)
            grads = torch.autograd.grad(loss, self.params)
        self.count += 1
        c1, c2 = 1.0 - self.B1 ** self.count, 1.0 - self.B2 ** self.count
        with torch.no_grad():
            for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
                mu.mul_(self.B1).add_(g, alpha=1.0 - self.B1)
                nu.mul_(self.B2).add_(g * g, alpha=1.0 - self.B2)
                p.sub_(self.lr * ((mu / c1) / (torch.sqrt(nu / c2) + self.EPS)))
        return loss.detach(), p_loss.detach(), j_loss.detach()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data_dir", default="./data")
    ap.add_argument("--sets", nargs="+", default=["HUMANISE", "PROX"])
    ap.add_argument("--steps", type=int, default=60000)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--joint_loss_weight", type=float, default=1.0)
    ap.add_argument("--out", default="./utils/joints_to_smplx/regressor.npz")
    ap.add_argument("--max_files", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="the device to train on (default cuda:0; cpu runs on the CPU)")
    args = ap.parse_args(argv)

    dev = resolve_device({}, args.device)
    body = SMPLXModel.load_default().to(dev)
    pairs = build_pairs(args.data_dir, args.sets, body, max_files=args.max_files)
    if not pairs:
        raise FileNotFoundError(f"no training sequences of 24..196 frames under "
                                f"{args.data_dir}/{{{','.join(args.sets)}}}/motions")
    logger.info(f"{len(pairs)} sequences")

    torch.manual_seed(0)
    reg = JointsToSMPLXRegressor().to(dev).train()
    set_dropout_generator(reg, torch.Generator(device=dev).manual_seed(1))
    trainer = RegressorTrainer(reg, body, args.lr, args.joint_loss_weight)
    rng = np.random.default_rng(0)
    logged = []
    t0 = time.perf_counter()
    for it in range(args.steps):
        idxs = rng.integers(0, len(pairs), size=args.batch_size)
        joints, gt_params, mask = (torch.from_numpy(a).to(dev)
                                   for a in pad_batch(pairs, idxs))
        loss, pl, jl = trainer.step(joints, gt_params, mask)
        if it % 200 == 0 or it == args.steps - 1:
            logged.append({"step": it, "loss": float(loss), "params": float(pl),
                           "joints": float(jl)})
            logger.info(f"step {it}: loss={logged[-1]['loss']:.5f} "
                        f"params={logged[-1]['params']:.5f} joints={logged[-1]['joints']:.5f}")
    seconds = time.perf_counter() - t0   # the last step's losses were read: synchronized
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    save_regressor_npz(args.out, reg)
    logger.info(f"saved regressor to {args.out}")
    return {"out": args.out, "pairs": len(pairs), "logged": logged,
            "s_per_step": seconds / max(args.steps, 1)}


if __name__ == "__main__":
    main()
