"""The frozen T2M text/motion matching encoders (counterpart of
``afford_motion_tpu/eval/t2m_models.py``; reference: utils/eval/modules.py —
MovementConvEncoder:79-98, TextEncoderBiGRUCo:311-350,
MotionEncoderBiGRUCo:353-386).

``nn.Module``s whose parameter names are those of the checkpoint
``finest.tar``, so a real checkpoint loads with ``strict=True``. The
bidirectional GRUs run over ``pack_padded_sequence``: the forward state at
``len - 1`` and the backward pass reversed within the valid length, as the
JAX package's masked scan. A row of length 0 (a motion under ``unit_length``
frames) cannot be packed; the masked scan leaves its state at the learned
initial ``hidden``, and so does :func:`bigru_last` here.

No port kernel lies on this path: the JAX package computes these layers with
XLA, and here cuDNN's convolutions and GRUs run them. Both are true-f32
surfaces: turn TF32 off for cuBLAS and cuDNN
(``torch.backends.cuda.matmul.allow_tf32``, ``torch.backends.cudnn.allow_tf32``)
before calling them on the card.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn
from torch.nn.utils.rnn import pack_padded_sequence

NETS = ("movement_encoder", "text_encoder", "motion_encoder")


def bigru_last(gru: nn.GRU, x: torch.Tensor, lengths: np.ndarray,
               hidden: torch.Tensor) -> torch.Tensor:
    """The final states [forward, backward] of a one-layer bidirectional GRU
    over ``x`` (B, L, H) with host ``lengths`` (B,); rows of length 0 keep
    ``hidden`` (2, 1, H)."""
    lengths = np.asarray(lengths, dtype=np.int64)
    out = hidden[:, 0, :].reshape(1, -1).expand(x.shape[0], -1)
    live = np.flatnonzero(lengths > 0)
    if live.size == 0:
        return out.contiguous()
    rows = x if live.size == x.shape[0] else x[torch.as_tensor(live, device=x.device)]
    packed = pack_padded_sequence(rows, torch.as_tensor(lengths[live]), batch_first=True,
                                  enforce_sorted=False)
    h0 = hidden.expand(-1, live.size, -1).contiguous()
    _, last = gru(packed, h0)
    last = torch.cat([last[0], last[1]], dim=-1)
    if live.size == x.shape[0]:
        return last
    out = out.clone()
    out[torch.as_tensor(live, device=x.device)] = last
    return out


class MovementConvEncoder(nn.Module):
    """(B, L, D) -> (B, L / 4, latent); the dropouts are identity at eval."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int):
        super().__init__()
        self.main = nn.Sequential(
            nn.Conv1d(input_size, hidden_size, 4, 2, 1), nn.Dropout(0.2), nn.LeakyReLU(0.2),
            nn.Conv1d(hidden_size, output_size, 4, 2, 1), nn.Dropout(0.2), nn.LeakyReLU(0.2),
        )
        self.out_net = nn.Linear(output_size, output_size)

    def forward(self, motions: torch.Tensor) -> torch.Tensor:
        return self.out_net(self.main(motions.permute(0, 2, 1)).permute(0, 2, 1))


def _head(hidden: int, output: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(hidden * 2, hidden), nn.LayerNorm(hidden),
                         nn.LeakyReLU(0.2), nn.Linear(hidden, output))


class TextEncoderBiGRUCo(nn.Module):
    """(B, T, 300) words + (B, T, 15) POS one-hots + lengths -> (B, coemb)."""

    def __init__(self, word_size: int, pos_size: int, hidden_size: int, output_size: int):
        super().__init__()
        self.pos_emb = nn.Linear(pos_size, word_size)
        self.input_emb = nn.Linear(word_size, hidden_size)
        self.gru = nn.GRU(hidden_size, hidden_size, batch_first=True, bidirectional=True)
        self.output_net = _head(hidden_size, output_size)
        self.hidden = nn.Parameter(torch.zeros(2, 1, hidden_size))

    def forward(self, word_embs: torch.Tensor, pos_ohot: torch.Tensor,
                cap_lens: np.ndarray) -> torch.Tensor:
        h = self.input_emb(word_embs + self.pos_emb(pos_ohot))
        return self.output_net(bigru_last(self.gru, h, cap_lens, self.hidden))


class MotionEncoderBiGRUCo(nn.Module):
    """(B, L', latent) movements + lengths in movement steps -> (B, coemb)."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int):
        super().__init__()
        self.input_emb = nn.Linear(input_size, hidden_size)
        self.gru = nn.GRU(hidden_size, hidden_size, batch_first=True, bidirectional=True)
        self.output_net = _head(hidden_size, output_size)
        self.hidden = nn.Parameter(torch.zeros(2, 1, hidden_size))

    def forward(self, movements: torch.Tensor, m_lens: np.ndarray) -> torch.Tensor:
        h = self.input_emb(movements)
        return self.output_net(bigru_last(self.gru, h, m_lens, self.hidden))


def build_t2m_modules(state_dicts: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, nn.Module]:
    """The three encoders, sized from the shapes of their state dicts and
    loaded from them with ``strict=True``, in eval mode on the CPU."""
    mv, tx, mo = (state_dicts[n] for n in NETS)
    modules = {
        "movement_encoder": MovementConvEncoder(
            mv["main.0.weight"].shape[1], mv["main.0.weight"].shape[0],
            mv["main.3.weight"].shape[0]),
        "text_encoder": TextEncoderBiGRUCo(
            tx["pos_emb.weight"].shape[0], tx["pos_emb.weight"].shape[1],
            tx["input_emb.weight"].shape[0], tx["output_net.3.weight"].shape[0]),
        "motion_encoder": MotionEncoderBiGRUCo(
            mo["input_emb.weight"].shape[1], mo["input_emb.weight"].shape[0],
            mo["output_net.3.weight"].shape[0]),
    }
    for name, module in modules.items():
        module.load_state_dict(state_dicts[name], strict=True)
        module.eval()
    return modules


def synthetic_t2m_params(dim_pose: int = 263, strip_last4: bool = True,
                         seed: int = 0) -> Dict[str, Dict[str, np.ndarray]]:
    """Random numpy parameter dicts with the real checkpoint's names and
    sizes (movement 512, text BiGRU 512, motion BiGRU 1024, co-embedding 512,
    300-d words, 15 POS classes), the same draws as the JAX package's
    function of this name: shape-true runs without the checkpoint."""
    from .word_vectorizer import POS_enumerator

    rng = np.random.default_rng(seed)

    def W(*s):
        return (rng.normal(size=s) * 0.02).astype(np.float32)

    d_in = dim_pose - 4 if strip_last4 else dim_pose
    hid_mov, lat_mov = 512, 512
    movement = {
        "main.0.weight": W(hid_mov, d_in, 4), "main.0.bias": W(hid_mov),
        "main.3.weight": W(lat_mov, hid_mov, 4), "main.3.bias": W(lat_mov),
        "out_net.weight": W(lat_mov, lat_mov), "out_net.bias": W(lat_mov),
    }

    def bigru(prefix_in: int, hid: int):
        p = {}
        for sfx in ("", "_reverse"):
            p[f"gru.weight_ih_l0{sfx}"] = W(3 * hid, prefix_in)
            p[f"gru.weight_hh_l0{sfx}"] = W(3 * hid, hid)
            p[f"gru.bias_ih_l0{sfx}"] = W(3 * hid)
            p[f"gru.bias_hh_l0{sfx}"] = W(3 * hid)
        p["hidden"] = W(2, 1, hid)
        return p

    dim_word, dim_pos = 300, len(POS_enumerator)
    hid_txt, hid_mot, coemb = 512, 1024, 512
    text = {
        "pos_emb.weight": W(dim_word, dim_pos), "pos_emb.bias": W(dim_word),
        "input_emb.weight": W(hid_txt, dim_word), "input_emb.bias": W(hid_txt),
        **bigru(hid_txt, hid_txt),
        "output_net.0.weight": W(hid_txt, 2 * hid_txt), "output_net.0.bias": W(hid_txt),
        "output_net.1.weight": W(hid_txt), "output_net.1.bias": W(hid_txt),
        "output_net.3.weight": W(coemb, hid_txt), "output_net.3.bias": W(coemb),
    }
    motion = {
        "input_emb.weight": W(hid_mot, lat_mov), "input_emb.bias": W(hid_mot),
        **bigru(hid_mot, hid_mot),
        "output_net.0.weight": W(hid_mot, 2 * hid_mot), "output_net.0.bias": W(hid_mot),
        "output_net.1.weight": W(hid_mot), "output_net.1.bias": W(hid_mot),
        "output_net.3.weight": W(coemb, hid_mot), "output_net.3.bias": W(coemb),
    }
    return {"movement_encoder": movement, "text_encoder": text, "motion_encoder": motion}


def load_t2m_checkpoint(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Read ``finest.tar`` and return numpy parameter dicts keyed
    'movement_encoder' / 'text_encoder' / 'motion_encoder'
    (reference: evaluator_wrapper.py:211-216)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return {net: {k: v.detach().numpy().astype(np.float32) for k, v in ckpt[net].items()}
            for net in NETS}
