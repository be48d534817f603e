"""The first steps of a training run, plainly: the batches of
``data``, the hierarchy of ``geometry``, the models of ``models``, the
Gaussian diffusion's masked MSE on x0 and AdamW, each step's timesteps,
noise and dropout masks drawn from one generator seeded by (run seed,
step) in the program's order (timesteps, noise, then the masks in the
forward's order). ``readings`` gives what ``harness/compare.py`` compares:
each step's loss, each leaf's norm of the first gradient and of the
parameters' change over the steps."""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from perfbench.harness.compare import leaf_parts

from . import data, geometry, models
from .lowp import fp8_mm


def cosine_schedule(steps: int) -> Dict[str, np.ndarray]:
    """sqrt(alpha_bar) and sqrt(1 - alpha_bar) of the cosine schedule,
    computed in float64, kept in float32."""
    def alpha_bar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    i = np.arange(steps, dtype=np.float64)
    betas = np.minimum(1.0 - np.vectorize(alpha_bar)((i + 1) / steps)
                       / np.vectorize(alpha_bar)(i / steps), 0.999)
    ac = np.cumprod(1.0 - betas)
    return {"a": np.sqrt(ac).astype(np.float32), "s": np.sqrt(1.0 - ac).astype(np.float32)}


class AdamW:
    """Adam with decoupled weight decay, betas (0.9, 0.999), epsilon 1e-8:
    p <- p (1 - lr wd) - lr m_hat / (sqrt(v_hat) + eps)."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0):
        self.params, self.lr, self.wd, self.t = params, lr, weight_decay, 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        b1, b2 = 0.9, 0.999
        for p, m, v in zip(self.params, self.m, self.v):
            m.mul_(b1).add_(p.grad, alpha=1 - b1)
            v.mul_(b2).addcmul_(p.grad, p.grad, value=1 - b2)
            p.mul_(1 - self.lr * self.wd)
            denom = (v / (1 - b2 ** self.t)).sqrt() + 1e-8
            p.sub_(self.lr * (m / (1 - b1 ** self.t)) / denom)


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's norm, a packed in-projection's by its three projections."""
    return {n: float(torch.linalg.vector_norm(t)) for name, v in tensors.items()
            for n, t in leaf_parts(name, v)}


def step_seed(base: int, step: int) -> int:
    return (int(base) * 2654435761 + int(step)) & 0xFFFFFFFF


def _mm(lowp: bool):
    return fp8_mm if lowp else torch.matmul


def _stage2_batch(cfg, params, draws, rows, dev, w0):
    ds = cfg["task"]["dataset"]
    joints = [int(j) for j in cfg["model"]["contact_model"]["contact_joints"]]
    sigma2 = torch.tensor(float(ds["sigma"]) ** 2, dtype=torch.float32, device=dev)
    x, x_mask = data.motion_batch(params, draws, rows, int(ds["max_horizon"]), dev)
    xyz32, contact = data.sorted_clouds(params, draws["item"][rows], joints, dev)
    d16 = contact.half().float()
    c = torch.exp(-0.5 * (d16 * d16) / sigma2).half().float()
    xyz16 = xyz32.half().float()
    levels = geometry.hierarchy(xyz16, geometry.fps_wire(xyz32), w0)
    cond = {"levels": levels, "c_pc_contact": c, "x_mask": x_mask,
            "text_emb": data.text_batch(params, draws["caption"][rows], dev)}
    for key in ("c_text_erase", "c_pc_erase"):
        cond[key] = torch.tensor(draws[key][rows], device=dev)[:, None]
    return x, cond


def _stage1_batch(cfg, params, draws, rows, dev, stats):
    ds = cfg["task"]["dataset"]
    joints = [int(j) for j in ds["data_repr_joints"]]
    sigma2 = torch.tensor(float(ds["sigma"]) ** 2, dtype=torch.float32, device=dev)
    xyz, d = data.sorted_clouds(params, draws["item"][rows], joints, dev)
    c = torch.exp(-0.5 * (d * d) / sigma2)
    mean, std = (torch.as_tensor(v, device=dev) for v in stats)
    x = (c - mean) / std
    cond = {"c_pc_xyz": xyz.half().float(),
            "text_emb": data.text_batch(params, draws["caption"][rows], dev)}
    return x, cond


def readings(cfg: Dict[str, Any], params: Dict, weights: Dict[str, torch.Tensor], seed: int,
             n_steps: int, G: int, dev, lowp: bool = False,
             rows_used: Optional[int] = None, cache=None) -> Dict[str, Any]:
    """The reference's first ``n_steps`` steps from ``weights`` (float32,
    by the program's names) on the run of ``seed`` with megabatches of
    ``G`` steps. ``lowp``: the control, every matrix product in float8.
    ``rows_used``: a planted fault for the control test, the loss's mean
    over that many rows of each batch. ``cache``: a folder for the
    reference's own derived files."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m, ds, tr = cfg["model"], cfg["task"]["dataset"], cfg["task"]["train"]
    name = str(m["name"])
    B = int(tr["batch_size"])
    if name == "CMDM":
        motion_dim = int(m["input_feats"])
        model = models.CMDM(m, motion_dim, len(m["contact_model"]["contact_joints"]))
        flags = []
        probs = ds.get("transform_cfg", {})
        for t in ds["train_transforms"]:
            if t == "RandomEraseLang":
                flags.append(("c_text_erase", float(probs["random_mask_prob"])))
            elif t == "RandomEraseContact":
                flags.append(("c_pc_erase", float(probs["random_mask_prob_pc"])))
            elif t != "NumpyToTensor":
                raise NotImplementedError(f"transform {t}")
        p_drop = float(m["dropout"])
    elif name == "CDM":
        model = models.CDM(m, int(m["input_feats"]))
        joints = [int(j) for j in ds["data_repr_joints"]]
        stats = data.contact_stats(params, joints, float(ds["sigma"]), cache)
        p_drop = 0.0
    else:
        raise NotImplementedError(name)
    model = model.to(dev)
    names = dict(model.named_parameters())
    if set(names) != set(weights):
        raise KeyError(f"the reference's leaves differ from the weights': "
                       f"{sorted(set(names) ^ set(weights))[:8]}")
    with torch.no_grad():
        for n, p in names.items():
            p.copy_(weights[n].to(dev))
    start = {n: p.detach().clone() for n, p in names.items()}
    opt = AdamW(list(names.values()), float(tr["lr"]), float(tr.get("weight_decay", 0.0)))
    sched = cosine_schedule(int(cfg["diffusion"]["steps"]))
    sa = torch.from_numpy(sched["a"]).to(dev)
    so = torch.from_numpy(sched["s"]).to(dev)
    w0 = int(m.get("banded_window", 0) or 0)
    order, positions = data.item_order(params, seed, int(ds.get("min_horizon", 0) or 0))
    out: Dict[str, Any] = {"loss": []}
    draws = None
    for step in range(n_steps):
        gi, g = divmod(step, G)
        if g == 0 or draws is None:
            ids = data.megabatch_ids(len(order), G, B, gi, seed)
            draws = (data.draw_motion_batch(params, order, positions, ids, gi, seed, flags)
                     if name == "CMDM" else
                     data.draw_contact_batch(params, order, positions, ids, gi, seed))
        rows = slice(g * B, (g + 1) * B)
        if name == "CMDM":
            x, cond = _stage2_batch(cfg, params, draws, rows, dev, w0)
        else:
            x, cond = _stage1_batch(cfg, params, draws, rows, dev, stats)
        gen = torch.Generator(device=dev).manual_seed(step_seed(seed, step))
        t = torch.randint(0, sa.shape[0], (B,), generator=gen, device=dev)
        noise = torch.randn(tuple(x.shape), generator=gen, device=dev, dtype=torch.float32)
        shape = (B,) + (1,) * (x.ndim - 1)
        x_t = sa[t].reshape(shape) * x + so[t].reshape(shape) * noise
        ctx = models.Ctx(gen, p_drop, _mm(lowp))
        pred = model(ctx, x_t, t, cond)
        valid = (~cond["x_mask"]).float()[..., None] if "x_mask" in cond else torch.ones_like(
            x[..., :1])
        mse = ((x - pred) ** 2 * valid).reshape(B, -1).sum(1) / (
            valid.reshape(B, -1).sum(1) * x.shape[-1])
        if rows_used is not None:
            mse = mse[:rows_used]
        loss = mse.mean()
        for p in names.values():
            p.grad = None
        loss.backward()
        if step == 0:
            out["grad"] = _norms({n: p.grad for n, p in names.items()})
        opt.step()
        out["loss"].append(float(loss.detach()))
    out["change"] = _norms({n: p.detach() - start[n] for n, p in names.items()})
    return out
