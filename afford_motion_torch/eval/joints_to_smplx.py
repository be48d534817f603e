"""Joints -> SMPL-X parameter projection + refinement (counterpart of
``afford_motion_tpu/eval/joints_to_smplx.py``).

A 2-layer transformer regressor maps 22x3 joint sequences to 69-d SMPL-X
parameters; an Adam refinement then minimises the masked joint MSE, plus an
acceleration-smoothness term over the last 40% of the steps, for a whole
padded batch at once. The regressor keeps the reference checkpoint's
parameter names (``utils/joints_to_smplx/060.pt`` loads with
``strict=True``); natively trained weights come as an ``.npz`` in the JAX
package's flat-key layout and cross through ``utils/convert.py``. The body
model is the LBS of ``smplx_lbs.py``.

In a data-parallel run (``parallel.current()``) :meth:`JointsToSMPLXFitter.fit`
splits the rows over the ranks (the JAX package's fit shards them over the
mesh): each rank regresses and refines its share, both loss denominators
count the valid frames of the whole batch, all-reduced once before the Adam
steps, so that each row's gradient is the one-process fit's, and the results
are gathered.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from ..models.layers import Linear, PositionalEncoding, TransformerEncoder
from ..parallel.mesh import current
from ..utils.convert import regressor_state_dict_from_jax
from ..utils.device import resolve_device
from .smplx_lbs import SMPLXModel, params_to_joints, params_to_verts_joints

NJOINTS = 22
PARAM_DIM = 3 + NJOINTS * 3  # 69


class JointsToSMPLXRegressor(nn.Module):
    """(B, L, 66) joints, (B, L) pad mask -> (B, L, 69) params, float32."""

    def __init__(self, latent_dim: int = 256, num_heads: int = 4, ff_size: int = 512,
                 num_layers: int = 2, dropout: float = 0.1):
        super().__init__()
        self.input_layer = nn.Sequential(
            Linear(NJOINTS * 3, latent_dim // 2), nn.ReLU(),
            Linear(latent_dim // 2, latent_dim), nn.ReLU(),
        )
        self.positional_encoder = PositionalEncoding(latent_dim, max_len=1000, dropout=dropout)
        self.TransEncoder = TransformerEncoder(num_layers, latent_dim, num_heads, ff_size,
                                               dropout=dropout, activation="relu")
        self.output_layer = Linear(latent_dim, PARAM_DIM)

    def forward(self, x: torch.Tensor, x_mask=None) -> torch.Tensor:
        h = self.positional_encoder(self.input_layer(x))
        return self.output_layer(self.TransEncoder(h, x_mask))


def load_regressor_npz(path: str) -> Dict:
    """The JAX package's flat npz ('/'-joined flax keys) -> the nested tree."""
    flat = np.load(path)
    tree: Dict = {}
    for name in flat.files:
        node = tree
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = flat[name]
    return tree


def load_regressor_weights(regressor: JointsToSMPLXRegressor, path: str) -> None:
    """``.npz``: flax params crossed through the name table; anything else: a
    torch state_dict in the reference layout. Every parameter of the
    regressor must be in the file; entries the regressor does not have (a
    stored positional table) are passed over, as the JAX package's converter
    passes over them."""
    if path.endswith(".npz"):
        sd = regressor_state_dict_from_jax(
            {"params": load_regressor_npz(path)}, num_layers=len(regressor.TransEncoder.layers))
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    own = regressor.state_dict().keys()
    missing = sorted(k for k in own if k not in sd)
    if missing:
        raise KeyError(f"{path}: regressor weights lack {missing}")
    regressor.load_state_dict({k: sd[k] for k in own}, strict=True)


def make_refine_fn(model: SMPLXModel, lr: float, steps: int) -> Callable:
    """Adam refinement of 69-d params against target joints: joints MSE, plus
    a 0.1x acceleration penalty from step ``int(0.6 * steps)`` on. Masked
    frames contribute nothing. Adam is written out with optax's defaults
    (b1 0.9, b2 0.999, eps 1e-8 outside the root, bias-corrected moments), so
    a step reads as the JAX package's does."""
    smooth_start = int(0.6 * steps)
    b1, b2, eps = 0.9, 0.999, 1e-8

    def acc_valid_of(valid):
        return valid[:, 2:] * valid[:, 1:-1] * valid[:, :-2]

    def loss_fn(params, joints, valid, use_smooth: bool, denominators):
        B, L, _ = params.shape
        j = params_to_joints(model, params.reshape(B * L, PARAM_DIM)).reshape(B, L, NJOINTS * 3)
        # masked mean over (valid frames, joints, 3)
        loss = torch.sum(((j - joints) ** 2) * valid) / denominators[0]
        if use_smooth:
            vel = params[:, 1:] - params[:, :-1]
            acc = vel[:, 1:] - vel[:, :-1]
            sl = torch.sum((acc ** 2) * acc_valid_of(valid)) / denominators[1]
            loss = loss + 0.1 * sl
        return loss

    def refine(init_params: torch.Tensor, joints: torch.Tensor, x_mask: torch.Tensor,
               dp=None):
        """init_params (B, L, 69), joints (B, L, 66), x_mask (B, L) True = pad.
        ``dp``: these are one rank's rows of a data-parallel fit, whose
        denominators are summed over the ranks."""
        valid = (~x_mask).to(torch.float32)[..., None]
        counts = torch.stack([torch.sum(valid), torch.sum(acc_valid_of(valid))])
        if dp is not None:
            counts = dp.all_reduce(counts)
        denominators = (torch.clamp_min(counts[0] * (NJOINTS * 3), 1.0),
                        torch.clamp_min(counts[1] * PARAM_DIM, 1.0))
        params = init_params.detach().clone()
        if params.shape[0] == 0:
            return params
        mu, nu = torch.zeros_like(params), torch.zeros_like(params)
        for i in range(steps):
            p = params.requires_grad_(True)
            with torch.enable_grad():
                g, = torch.autograd.grad(
                    loss_fn(p, joints, valid, i >= smooth_start, denominators), p)
            with torch.no_grad():
                mu = b1 * mu + (1.0 - b1) * g
                nu = b2 * nu + (1.0 - b2) * (g * g)
                mu_hat = mu / (1.0 - b1 ** (i + 1))
                nu_hat = nu / (1.0 - b2 ** (i + 1))
                params = p.detach() - lr * (mu_hat / (torch.sqrt(nu_hat) + eps))
        return params

    return refine


class JointsToSMPLXFitter:
    """Facade used by ``Text2MotionInSceneEvaluator``. Raises
    ``FileNotFoundError`` at construction when the regressor weights or the
    SMPL-X model are missing. Runs on the card unless ``device`` names
    another, and raises without one."""

    def __init__(self, weights_path: str, opt_rate: float = 0.02, opt_steps: int = 200,
                 device: Optional[Union[str, torch.device]] = None):
        if not weights_path or not Path(weights_path).exists():
            raise FileNotFoundError(f"JointsToSMPLX weights not found: {weights_path}")
        self.device = resolve_device({}, device)
        self.body_model = SMPLXModel.load_default().to(self.device)
        self.regressor = JointsToSMPLXRegressor()
        load_regressor_weights(self.regressor, weights_path)
        self.regressor.to(self.device).eval()
        self.opt_rate = opt_rate
        self.opt_steps = opt_steps
        self._refine = make_refine_fn(self.body_model, opt_rate, opt_steps)

    @property
    def faces(self) -> np.ndarray:
        return self.body_model.faces

    def fit(self, joints: np.ndarray, x_mask: np.ndarray) -> np.ndarray:
        """(B, L, 66) + (B, L) -> refined params (B, L, 69); in a
        data-parallel run each rank fits its share of the rows (every rank
        calls with the same batch) and every rank returns all of them."""
        dp = current()
        dp = dp if dp is not None and dp.world > 1 else None
        rows = dp.chunk(len(joints)) if dp is not None else slice(0, len(joints))
        joints_t = torch.as_tensor(np.asarray(joints, dtype=np.float32)[rows],
                                   device=self.device)
        mask_t = torch.as_tensor(np.asarray(x_mask, dtype=bool)[rows], device=self.device)
        if joints_t.shape[0] == 0:
            pred = joints_t.new_zeros(joints_t.shape[:2] + (PARAM_DIM,))
        else:
            with torch.no_grad():
                pred = self.regressor(joints_t, mask_t)
        out = self._refine(pred, joints_t, mask_t, dp).cpu().numpy()
        if dp is None:
            return out
        return np.concatenate(dp.gather_objects(out), axis=0)

    def vertices(self, params: np.ndarray) -> np.ndarray:
        """Fitted params (L, 69) -> body vertices (L, V, 3) (one sequence per
        call keeps the skinning transforms small; fitting is the batched
        part)."""
        return self.vertices_device(params).cpu().numpy()

    @torch.no_grad()
    def vertices_device(self, params: np.ndarray) -> torch.Tensor:
        """:meth:`vertices` with the (L, V, 3) stack left on the device, for
        consumers that feed it straight into the physics there."""
        p = torch.as_tensor(np.asarray(params, dtype=np.float32), device=self.device)
        return params_to_verts_joints(self.body_model, p)[0]
