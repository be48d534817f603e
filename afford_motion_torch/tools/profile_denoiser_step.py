"""Where one DDIM denoiser step's time goes on the card, with and without the
fused attention:

    python -m afford_motion_torch.tools.profile_denoiser_step [out_dir]
        [--arch trans_enc | trans_dec | cdm_MLP | cdm_PointTransV2]

Builds the scene slice's denoiser, the CMDM ``trans_enc`` at full width
(latent 512, 5 layers of 8 heads, planes 32/64/128/256, bf16) on 66-d joint
motions, from a seeded init, the DDIM-50 respacing of the 500-step diffusion
and one random batch of 32 (8192-point clouds with contact maps, text
features, 40..196-frame motion masks), and encodes the conditions once. With
``--arch trans_dec`` the denoiser is instead ``trans_dec`` as
``scripts/t2m_contact_motion/train_ddp.sh`` builds it with
``model.arch=trans_dec`` (the same widths, 5 self-attention stages and 4
decoder layers whose cross-attention reads the U-Net's 128, 512, 2048 and
8192 points) on 263-d motions, with the DDIM-50 respacing of 1000 steps.
With ``--arch cdm_MLP`` (``cdm_PointTransV2``) it is stage 1's CDM with its
frozen scene model as ``task=contact_gen model=cdm`` builds it (the shipped
MLP backbone, or V2), on 32 coloured clouds' 6-channel contact maps, with the
DDIM-50 respacing of its 500 steps (a step costs what a CDM-500 chain's
does). The once-a-chain work (hierarchies and ``encode_conditions``) is
timed apart to a synchronize. Then, alternating ``AM_FLASH_ATTN=1`` and ``0`` three times each, it times
one DDIM-50 loop by the host clock to a device synchronize (ms per step), and
traces one more loop each way with ``torch.profiler``: device kernel time and
launches per step, the attention's share, the device's idle share, 1 -
device ms / host ms per step of the untraced loops, and the device time by
kernel class. Prints the card's name and power limit first; writes the table
to ``out_dir`` (default ``build/profile``) as ``profile_denoiser_step.txt``
(``profile_denoiser_step_trans_dec.txt``).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..diffusion import create_gaussian_diffusion
from ..models.cmdm import CMDM
from ..models.conditioning import add_hierarchies, encode_conditions
from ..utils.config import DictConfig
from .profile_train_step import _by_class

B, N, L = 32, 8192, 196
STEPS = 50
# motion width and diffusion steps of each arch's configuration
ARCHS = {"trans_enc": (66, 500), "trans_dec": (263, 1000), "cdm_MLP": (6, 500),
         "cdm_PointTransV2": (6, 500)}


def _loop_ms(loop) -> float:
    """Host ms per denoiser step of one loop, to a device synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / STEPS


def main(out_dir: str = "build/profile", arch: str = "trans_enc") -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_denoiser_step runs only on a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.manual_seed(2023)
    D, steps = ARCHS[arch]
    diffusion = create_gaussian_diffusion(
        DictConfig({"steps": steps, "timestep_respacing": f"ddim{STEPS}"}), dev)
    rng = np.random.default_rng(2023)
    if arch.startswith("cdm_"):
        from ..models.base import create_model
        from ..utils.config import load_config

        cfg = load_config(str(Path(__file__).resolve().parents[2] / "configs"),
                          ["task=contact_gen", "model=cdm", "diffusion.steps=500",
                           f"model.arch={arch[4:]}"])
        cfg.model.input_feats = D
        model = create_model(cfg.model, dev)
        cond = {"c_pc_xyz": torch.from_numpy(rng.normal(size=(B, N, 3)).astype(np.float16)),
                "c_pc_feat": torch.from_numpy(rng.uniform(size=(B, N, 3)).astype(np.float32)),
                "text_emb": torch.from_numpy(rng.normal(size=(B, 1, 512)).astype(np.float32))}
        shape = (B, N, D)
    else:
        model = CMDM(motion_dim=D, dtype=torch.bfloat16, arch=arch).to(dev).eval()
        x_mask = np.arange(L)[None, :] >= rng.integers(40, L + 1, size=(B, 1))
        cond = {
            "c_pc_xyz": torch.from_numpy(rng.normal(size=(B, N, 3)).astype(np.float16)),
            "c_pc_contact": torch.from_numpy(rng.uniform(size=(B, N, 6)).astype(np.float16)),
            "text_emb": torch.from_numpy(rng.normal(size=(B, 1, 512)).astype(np.float32)),
            "x_mask": torch.from_numpy(x_mask),
        }
        shape = (B, L, D)
    cond = {k: v.to(dev) for k, v in cond.items()}
    noise = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
    saved = os.environ.get("AM_FLASH_ATTN")
    with torch.no_grad():
        prepare = []
        for _ in range(4):   # the first warms up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cond_h = add_hierarchies(model, cond)
            enc = encode_conditions(model, cond_h)
            torch.cuda.synchronize()
            prepare.append(1e3 * (time.perf_counter() - t0))

        def loop():
            return diffusion.ddim_sample_loop(lambda x, t: model.denoise(x, t, cond_h, enc),
                                              shape, noise=noise, clip_denoised=False)

        try:
            host = {"1": [], "0": []}
            for flash in ("1", "0") * 4:   # the first pair warms up
                os.environ["AM_FLASH_ATTN"] = flash
                host[flash].append(_loop_ms(loop))
            host = {flash: v[1:] for flash, v in host.items()}
            what = {"trans_enc": "the scene slice's CMDM", "trans_dec": "the CMDM trans_dec"}.get(
                arch, f"the CDM {arch[4:]} with its scene model")
            lines = [f"once a chain (hierarchies and encode_conditions), ms to a synchronize: "
                     f"{', '.join(f'{x:.3f}' for x in prepare[1:])}",
                     f"DDIM-50 denoiser step of {what}, batch 32, bf16; host ms per step to a "
                     "synchronize, three alternating loops each way after a warm-up pair:"]
            for flash, v in host.items():
                lines.append(f"  AM_FLASH_ATTN={flash}: {', '.join(f'{x:.3f}' for x in v)} "
                             f"(median {np.median(v):.3f})")
            for flash in ("1", "0"):
                os.environ["AM_FLASH_ATTN"] = flash
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    traced = _loop_ms(loop)
                events = [e for e in prof.key_averages()
                          if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
                device = sum(e.self_device_time_total for e in events) / 1e3 / STEPS
                count = sum(e.count for e in events) / STEPS
                attn = sum(e.self_device_time_total for e in events
                           if "attention" in e.key or "softmax" in e.key.lower()) / 1e3 / STEPS
                idle = 1.0 - device / float(np.median(host[flash]))
                lines.append(
                    f"traced step, AM_FLASH_ATTN={flash}: {device:.3f} ms of device kernels in "
                    f"{count:.0f} launches (attention and softmax kernels {attn:.3f} ms); "
                    f"{traced:.3f} ms a step on the host's clock with the profiler on; device "
                    f"idle share {idle:.3f} of the untraced median step")
                for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
                    lines.append(f"  {e.self_device_time_total / 1e3 / STEPS:8.4f} ms  "
                                 f"{e.count / STEPS:5.1f}x  {e.key[:100]}")
                lines.append(f"  by kernel class, a step (AM_FLASH_ATTN={flash}):")
                lines += ["  " + line for line in _by_class(
                    [(e.self_device_time_total / 1e3 / STEPS, round(e.count / STEPS), e.key)
                     for e in events])]
        finally:
            if saved is None:
                os.environ.pop("AM_FLASH_ATTN", None)
            else:
                os.environ["AM_FLASH_ATTN"] = saved
    text = "\n".join(lines)
    print(text, flush=True)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    name = "profile_denoiser_step" + ("" if arch == "trans_enc" else f"_{arch}")
    (out / f"{name}.txt").write_text(text + "\n")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir", nargs="?", default="build/profile")
    ap.add_argument("--arch", default="trans_enc", choices=tuple(ARCHS))
    args = ap.parse_args()
    main(args.out_dir, args.arch)
