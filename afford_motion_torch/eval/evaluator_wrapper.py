"""The frozen text-motion-match evaluator (counterpart of
``afford_motion_tpu/eval/evaluator_wrapper.py``; reference:
utils/eval/evaluator_wrapper.py:177-287).

Wraps the T2M encoders with the reference's co-embedding protocol:
length-sorted batches, movement encoding at ``unit_length = 4``, text
encoding over padded token sequences. Two configurations:
- 'ours': dim_pose=66 (the in-repo retrained evaluator for pos-repr sets)
- 'mdm' : dim_pose=263, motion input strips the last 4 channels (the
  original T2M/MDM evaluator convention)

The length order ``np.argsort(m_lens)[::-1]`` is computed on the host, as in
the JAX wrapper, so tied lengths come out in its order. Inputs may be numpy
arrays or tensors already on the evaluator's device.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from ..utils.convert import t2m_state_dicts_from_jax
from ..utils.device import resolve_device
from .t2m_models import build_t2m_modules, load_t2m_checkpoint
from .word_vectorizer import POS_enumerator

OURS_OPT = {
    "dim_word": 300,
    "max_motion_length": 196,
    "dim_pos_ohot": len(POS_enumerator),
    "dim_motion_hidden": 1024,
    "max_text_len": 20,
    "dim_text_hidden": 512,
    "dim_coemb_hidden": 512,
    "dim_pose": 66,
    "dim_movement_enc_hidden": 512,
    "dim_movement_latent": 512,
    "unit_length": 4,
    "strip_last4": False,
}

MDM_OPT = dict(OURS_OPT, dim_pose=263, strip_last4=True)


def _rows(x, device: torch.device, order: Optional[np.ndarray] = None) -> torch.Tensor:
    """``x`` (numpy or a tensor) as f32 on ``device``, its rows in ``order``
    (gathered on the device when ``x`` is already there)."""
    if isinstance(x, torch.Tensor):
        t = x.to(device=device, dtype=torch.float32)
        return t if order is None else t[torch.as_tensor(order, device=device)]
    a = np.asarray(x)
    a = a if order is None else a[order]
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32).to(device)


class EvaluatorWrapper:
    """(reference: evaluator_wrapper.py:220-287). ``params``: numpy
    parameter dicts in the checkpoint's names (e.g. ``synthetic_t2m_params``,
    or the JAX package's), used in place of the file at ``ckpt_path``.
    ``device``: the card unless the caller names another (it raises
    without one)."""

    def __init__(self, ckpt_path: str, variant: str = "ours",
                 params: Optional[Dict[str, Dict[str, np.ndarray]]] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.opt = dict(OURS_OPT if variant == "ours" else MDM_OPT)
        self.device = resolve_device({}, device)
        if params is None:
            params = load_t2m_checkpoint(ckpt_path)
        modules = build_t2m_modules(t2m_state_dicts_from_jax(params))
        for m in modules.values():
            m.to(self.device)
            m.requires_grad_(False)
        self.movement_encoder = modules["movement_encoder"]
        self.text_encoder = modules["text_encoder"]
        self.motion_encoder = modules["motion_encoder"]

    @torch.no_grad()
    def _motion_embedding(self, motions: torch.Tensor, m_lens: np.ndarray) -> torch.Tensor:
        if self.opt["strip_last4"]:
            motions = motions[..., :-4]
        movements = self.movement_encoder(motions)
        return self.motion_encoder(movements, m_lens // self.opt["unit_length"])

    def _out(self, t: torch.Tensor, order: Optional[np.ndarray], device_out: bool):
        t = t if order is None else t[torch.as_tensor(order, device=t.device)]
        return t if device_out else t.cpu().numpy()

    @torch.no_grad()
    def get_co_embeddings(self, word_embs, pos_ohot, cap_lens, motions, m_lens,
                          unsort: bool = False, device_out: bool = False):
        """(text, motion) co-embeddings. By default both follow the
        length-descending order of ``m_lens``, as in the reference
        (evaluator_wrapper.py:254-273); ``unsort=True`` returns both in the
        input order (the values are per item: only the row order changes).
        ``device_out=True`` returns tensors on the device, without the copy
        to the host."""
        m_arr = np.asarray(m_lens)
        align_idx = np.argsort(m_arr)[::-1].copy()
        motion_emb = self._motion_embedding(_rows(motions, self.device, align_idx),
                                            m_arr[align_idx])
        text_emb = self.text_encoder(_rows(word_embs, self.device),
                                     _rows(pos_ohot, self.device), np.asarray(cap_lens))
        if unsort:
            return (self._out(text_emb, None, device_out),
                    self._out(motion_emb, np.argsort(align_idx), device_out))
        return (self._out(text_emb, align_idx, device_out),
                self._out(motion_emb, None, device_out))

    @torch.no_grad()
    def get_motion_embeddings(self, motions, m_lens, unsort: bool = False,
                              device_out: bool = False):
        m_arr = np.asarray(m_lens)
        align_idx = np.argsort(m_arr)[::-1].copy()
        emb = self._motion_embedding(_rows(motions, self.device, align_idx), m_arr[align_idx])
        return self._out(emb, np.argsort(align_idx) if unsort else None, device_out)
