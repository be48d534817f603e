"""Where one DDIM denoiser step's time goes on the card, with and without the
fused attention:

    python -m afford_motion_torch.tools.profile_denoiser_step [out_dir]

Builds the scene slice's denoiser, the CMDM ``trans_enc`` at full width
(latent 512, 5 layers of 8 heads, planes 32/64/128/256, bf16) on 66-d joint
motions, from a seeded init, the DDIM-50 respacing of the 500-step diffusion
and one random batch of 32 (8192-point clouds with contact maps, text
features, 40..196-frame motion masks), and encodes the conditions once. Then,
alternating ``AM_FLASH_ATTN=1`` and ``0`` three times each, it times one
DDIM-50 loop by the host clock to a device synchronize (ms per step), and
traces one more loop each way with ``torch.profiler``: device kernel time and
launches per step, the attention's share, and the device's idle share, 1 -
device ms / host ms per step of the untraced loops. Prints the card's name
and power limit first; writes the table to ``out_dir`` (default
``build/profile``) as ``profile_denoiser_step.txt``.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..diffusion import create_gaussian_diffusion
from ..models.cmdm import CMDM
from ..models.conditioning import add_hierarchies, encode_conditions
from ..utils.config import DictConfig

B, N, L, D = 32, 8192, 196, 66
STEPS = 50


def _loop_ms(loop) -> float:
    """Host ms per denoiser step of one loop, to a device synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / STEPS


def main(out_dir: str = "build/profile") -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_denoiser_step runs only on a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.manual_seed(2023)
    model = CMDM(motion_dim=D, dtype=torch.bfloat16).to(dev).eval()
    diffusion = create_gaussian_diffusion(
        DictConfig({"steps": 500, "timestep_respacing": f"ddim{STEPS}"}), dev)
    rng = np.random.default_rng(2023)
    x_mask = np.arange(L)[None, :] >= rng.integers(40, L + 1, size=(B, 1))
    cond = {
        "c_pc_xyz": torch.from_numpy(rng.normal(size=(B, N, 3)).astype(np.float16)).to(dev),
        "c_pc_contact": torch.from_numpy(rng.uniform(size=(B, N, 6)).astype(np.float16)).to(dev),
        "text_emb": torch.from_numpy(rng.normal(size=(B, 1, 512)).astype(np.float32)).to(dev),
        "x_mask": torch.from_numpy(x_mask).to(dev),
    }
    noise = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32)).to(dev)
    saved = os.environ.get("AM_FLASH_ATTN")
    with torch.no_grad():
        cond_h = add_hierarchies(model, cond)
        enc = encode_conditions(model, cond_h)

        def loop():
            return diffusion.ddim_sample_loop(lambda x, t: model.denoise(x, t, cond_h, enc),
                                              (B, L, D), noise=noise, clip_denoised=False)

        try:
            host = {"1": [], "0": []}
            for flash in ("1", "0") * 4:   # the first pair warms up
                os.environ["AM_FLASH_ATTN"] = flash
                host[flash].append(_loop_ms(loop))
            host = {flash: v[1:] for flash, v in host.items()}
            lines = ["DDIM-50 denoiser step of the scene slice's CMDM, batch 32, bf16; host ms "
                     "per step to a synchronize, three alternating loops each way after a warm-up "
                     "pair:"]
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
        finally:
            if saved is None:
                os.environ.pop("AM_FLASH_ATTN", None)
            else:
                os.environ["AM_FLASH_ATTN"] = saved
    text = "\n".join(lines)
    print(text, flush=True)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "profile_denoiser_step.txt").write_text(text + "\n")


if __name__ == "__main__":
    main(*sys.argv[1:2])
