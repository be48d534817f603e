"""Smoke run of the PyTorch / CUDA port (``afford_motion_torch``) on one
NVIDIA GPU (written for an H100):

    python3 chip_smoke.py

Phases; any failure exits non-zero, and nothing falls back to the CPU:

1. card: ``nvidia-smi`` name and power limit;
2. build: nvcc builds the kernels of ``afford_motion_torch/csrc`` into
   ``build/kernels``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the sampling path gives it (batch 32, 8192-point contact
   clouds) and on a near-tie cloud, plus a few shapes off that path. FPS
   picks, kNN idx and dist and the gathered rows (f32 and bf16) must be
   bit-equal. Times by CUDA events;
4. reference: a small float32 chain (full-width CMDM, 1024 points, 10 DDIM
   steps) on the card, through the kernels, against the same chain on the
   CPU through the plain versions;
5. slice: ``afford_motion_torch.test`` (the port's test entry) with the
   flagship CMDM ``trans_enc`` at full width from a seeded random init, in
   the config's bf16, on one batch of 32 HumanML3D-shaped items (8192-point
   clouds, 196x263 motions), once with DDIM-50 and once with DDPM-1000. x0
   must be finite with shape (32, 196, 263), and every kernel must have been
   launched by the run.

The line before the last is a JSON object with each kernel's launches in
the slice runs, its largest difference from the plain version, and its time
and the plain version's summed over the sampling path's shapes. The last
line is ``{"ok": true, "device": {...}}``. Everything written at run time
goes under ``build/`` in the checkout.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
SEED = 2023
B, N_POINTS, L, D = 32, 8192, 196, 263
REPLACES = {
    "fps": ("afford_motion_torch/csrc/fps.cu", "afford_motion_tpu/ops/pallas/fps.py:124"),
    "knn": ("afford_motion_torch/csrc/knn.cu", "afford_motion_tpu/ops/pallas/knn.py:101"),
    "gather": ("afford_motion_torch/csrc/gather.cu", "afford_motion_tpu/ops/pallas/gather.py:95"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean ms per call by CUDA events, after one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bits(t: torch.Tensor) -> torch.Tensor:
    """Raw bit pattern, for bit-equality of float tensors."""
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)


class KernelReport:
    def __init__(self):
        self.err = {k: 0.0 for k in REPLACES}
        self.ms = {k: 0.0 for k in REPLACES}
        self.plain_ms = {k: 0.0 for k in REPLACES}

    def check(self, name: str, label: str, got, want) -> None:
        for g, w in zip(got, want):
            if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(bits(g), bits(w)):
                diff = (g.double() - w.double()).abs().max().item() if g.shape == w.shape else -1
                raise AssertionError(f"{name} {label}: kernel differs from plain (max {diff})")
            self.err[name] = max(self.err[name], (g.double() - w.double()).abs().max().item())

    def timed(self, name, label, kernel, plain, reps, path_shape=True):
        k_ms, p_ms = time_ms(kernel, reps), time_ms(plain, max(1, reps // 3))
        if path_shape:
            self.ms[name] += k_ms
            self.plain_ms[name] += p_ms
        log(f"  {name} {label}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")


def phase_kernels(dev: torch.device) -> KernelReport:
    from afford_motion_torch.ops.cuda.fps import fps_cuda, fps_plain
    from afford_motion_torch.ops.cuda.gather import gather_rows, gather_rows_plain
    from afford_motion_torch.ops.cuda.knn import knn_cuda, knn_plain

    rep = KernelReport()
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    clouds = {
        "random": torch.from_numpy(rng.normal(size=(B, N_POINTS, 3)).astype(np.float32)).to(dev),
        # 16^3 grid for 8192 points: duplicates and exactly tied distances
        "near-tie": torch.from_numpy(
            (rng.integers(0, 16, size=(B, N_POINTS, 3)) * 0.125).astype(np.float32)).to(dev),
    }
    for kind, cloud in clouds.items():
        path = kind == "random"
        levels = [cloud]
        for n_out in (2048, 512, 128):
            parent = levels[-1]
            label = f"{kind} ({B},{parent.shape[1]},3)->{n_out}"
            got = fps_cuda(parent, n_out)
            rep.check("fps", label, [got], [fps_plain(parent, n_out)])
            rep.timed("fps", label, lambda p=parent, m=n_out: fps_cuda(p, m),
                      lambda p=parent, m=n_out: fps_plain(p, m), 5, path)
            levels.append(torch.gather(parent, 1, got.long()[..., None].expand(-1, -1, 3)))
        # the packed-kNN calls of one SceneMap hierarchy (the 128x128 level
        # is below the kernel's range and takes the exact path)
        knn_idx = {}
        for qi, si, k in ((0, 0, 8), (1, 0, 16), (1, 1, 16), (2, 1, 16), (2, 2, 16), (3, 2, 16)):
            q, s = levels[qi], levels[si]
            label = f"{kind} q{tuple(q.shape)} s{tuple(s.shape)} k={k}"
            got = knn_cuda(q, s, k)
            rep.check("knn", label, got, knn_plain(q, s, k))
            rep.timed("knn", label, lambda q=q, s=s, k=k: knn_cuda(q, s, k),
                      lambda q=q, s=s, k=k: knn_plain(q, s, k), 5, path)
            knn_idx[(qi, si)] = got[0]
        # the row gathers of the SceneMap encoder: per level, the
        # TransitionDown group (3 + C_in channels) and the block's packed
        # xyz|k|v (3 + 2C), for planes 32/64/128/256
        gathers = [((0, 0), 67), ((1, 0), 35), ((1, 1), 131), ((2, 1), 67),
                   ((2, 2), 259), ((3, 2), 131), ((3, 3), 515)]
        for (qi, si), c in gathers:
            idx = knn_idx.get((qi, si))
            if idx is None:  # 128-point level: any in-range neighbours will do
                idx = torch.randint(0, 128, (B, 128, 16), device=dev, dtype=torch.int32,
                                    generator=gen)
            n_src = levels[si].shape[1]
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn(B, n_src, c, device=dev, generator=gen).to(dtype)
                label = f"{kind} x({B},{n_src},{c}) idx{tuple(idx.shape)} {str(dtype)[6:]}"
                rep.check("gather", label, [gather_rows(x, idx)], [gather_rows_plain(x, idx)])
                rep.timed("gather", label, lambda x=x, i=idx: gather_rows(x, i),
                          lambda x=x, i=idx: gather_rows_plain(x, i), 10,
                          path and dtype == torch.bfloat16)
    # off the sampling path, checked but not timed: the kNN's other
    # register-array sizes (k=3 is the 3-NN up-interpolation), an FPS cloud
    # that does not fill its block, a one-channel gather
    cloud = clouds["random"]
    for k in (3, 32, 64):
        q, s = cloud[:, :512].contiguous(), cloud[:, :2048].contiguous()
        rep.check("knn", f"off-path k={k}", knn_cuda(q, s, k), knn_plain(q, s, k))
    odd = cloud[:, :1000].contiguous()
    rep.check("fps", "off-path (32,1000,3)->250", [fps_cuda(odd, 250)], [fps_plain(odd, 250)])
    idx = torch.randint(0, 1000, (B, 300, 5), device=dev, dtype=torch.int32, generator=gen)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(B, 1000, 1, device=dev, generator=gen).to(dtype)
        rep.check("gather", "off-path C=1", [gather_rows(x, idx)], [gather_rows_plain(x, idx)])
    log("  off-path checks: kNN k=3/32/64, FPS N=1000, gather C=1 bit-equal")
    return rep


def phase_reference(dev: torch.device) -> float:
    """Full-width float32 CMDM, small cloud: card (kernels) vs CPU (plain)."""
    from afford_motion_torch.diffusion import create_gaussian_diffusion
    from afford_motion_torch.models.cmdm import CMDM
    from afford_motion_torch.train.sampling import make_sample_fn
    from afford_motion_tpu.utils.config import DictConfig

    torch.manual_seed(SEED)
    cpu_model = CMDM(motion_dim=D).eval()
    gpu_model = CMDM(motion_dim=D).to(dev).eval()
    gpu_model.load_state_dict(cpu_model.state_dict(), strict=True)
    rng = np.random.default_rng(SEED + 1)
    n, lb = 1024, 2
    x_mask = np.zeros((lb, L), dtype=bool)
    x_mask[1, 120:] = True
    cond = {
        "c_pc_xyz": rng.normal(size=(lb, n, 3)).astype(np.float32),
        "c_pc_contact": rng.uniform(size=(lb, n, 6)).astype(np.float32),
        "text_emb": rng.normal(size=(lb, 1, 512)).astype(np.float32),
        "x_mask": x_mask,
    }
    noise = rng.standard_normal((lb, L, D)).astype(np.float32)
    out = []
    for model, device in ((cpu_model, torch.device("cpu")), (gpu_model, dev)):
        diffusion = create_gaussian_diffusion(
            DictConfig({"steps": 1000, "timestep_respacing": "ddim10"}), device)
        fn = make_sample_fn(model, diffusion, sampler="ddim")
        c = {k: torch.from_numpy(v).to(device) for k, v in cond.items()}
        out.append(fn((lb, L, D), c, noise=torch.from_numpy(noise).to(device)).cpu())
    err = (out[0] - out[1]).abs().max().item()
    log(f"reference: DDIM-10 x0 (2,{L},{D}) f32, card vs CPU max abs diff {err:.3e}")
    if not (torch.isfinite(out[1]).all() and err <= 1e-3):
        raise AssertionError(f"card chain disagrees with the CPU chain: {err}")
    return err


def make_tree() -> dict:
    """Synthetic HumanML3D tree (8192-point clouds, motions of 40..196
    frames) whose test split holds 32 items, plus the stage-1 handoff
    ``H3D/pred_contact/{id}-0.npy`` each test item reads, from the seed."""
    from afford_motion_tpu.data.synthetic import make_synthetic_h3d

    shutil.rmtree(WORK, ignore_errors=True)
    data, contacts, exp = WORK / "data", WORK / "contacts", WORK / "exp"
    make_synthetic_h3d(str(data), n_items=4 * B, num_points=N_POINTS, horizon_range=(40, 197))
    pred = contacts / "H3D" / "pred_contact"
    pred.mkdir(parents=True)
    rng = np.random.default_rng(SEED)
    for name in (data / "H3D" / "test.txt").read_text().split():
        dist = np.abs(rng.normal(size=(1, N_POINTS, 6))).astype(np.float32)
        np.save(pred / f"{name}-0.npy", dist)
    return {"data": data, "contacts": contacts, "exp": exp}


def phase_slice(dev: torch.device, counters: dict) -> dict:
    from afford_motion_torch import test as entry
    from afford_motion_torch.models.base import create_model
    from afford_motion_torch.train.checkpoint import save_ckpt
    from afford_motion_tpu.utils.config import load_config
    from afford_motion_tpu.utils.misc import compute_repr_dimension

    tree = make_tree()
    base = [
        "task=text_to_motion_contact_motion_gen", "model=cmdm", "model.arch=trans_enc",
        "model.data_repr=h3d", "model.text_model.max_length=20", "diffusion.steps=1000",
        f"task.dataset.data_dir={tree['data']}", f"task.test.contact_folder={tree['contacts']}",
        f"exp_dir={tree['exp']}", f"task.test.batch_size={B}", "task.evaluator.eval_nbatch=1",
        f"seed={SEED}", f"text_encoder.table_path={WORK / 'no_table'}",
        f"text_encoder.weights_dir={WORK / 'no_weights'}",
    ]
    cfg = load_config(str(ROOT / "configs"), base)
    cfg.model.input_feats = compute_repr_dimension(cfg.model.data_repr)
    torch.manual_seed(SEED)
    save_ckpt(create_model(cfg.model, dev), str(tree["exp"] / "ckpt"), 0)

    launches = {k: 0 for k in counters}
    runs = {"ddim50": ["diffusion.timestep_respacing=ddim50", "task.test.sampler=ddim"],
            "ddpm1000": ["task.test.sampler=ddpm"]}
    for name, extra in runs.items():
        for fn in counters.values():
            fn.launches = 0
        out = Path(entry.main(base + extra))
        counts = {k: fn.launches for k, fn in counters.items()}
        z = np.load(out / "samples.npz")
        timing = json.loads((out / "timing.json").read_text())
        x0 = z["sample"]
        log(f"slice {name}: x0 {x0.shape} finite={bool(np.isfinite(x0).all())} "
            f"launches {counts}")
        if x0.shape != (B, L, D) or not np.isfinite(x0).all():
            raise AssertionError(f"{name}: bad x0 {x0.shape}")
        if min(counts.values()) <= 0:
            raise AssertionError(f"{name}: a kernel of the path was never launched: {counts}")
        chain = timing["chains"][0]
        log(f"slice {name}: chain {chain['chain_s']:.3f} s (hierarchy + contact encoding "
            f"{chain['prepare_s']:.3f} s, {chain['steps']} denoiser steps "
            f"{chain['loop_s']:.3f} s = {1e3 * chain['loop_s'] / chain['steps']:.3f} ms/step), "
            f"peak memory {timing.get('peak_memory_bytes', float('nan')) / 2**30:.2f} GiB")
        for k in launches:
            launches[k] += counts[k]
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    from afford_motion_torch.ops.cuda import build
    from afford_motion_torch.ops.cuda.fps import fps_cuda
    from afford_motion_torch.ops.cuda.gather import gather_rows
    from afford_motion_torch.ops.cuda.knn import knn_cuda

    os.chdir(ROOT)  # the entry reads ./configs, as the root test.py does
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    log(card)
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    t0 = time.monotonic()
    lib_path = build.build()
    build.library()
    log(f"build: {lib_path.name} in {time.monotonic() - t0:.1f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "Function properties" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    rep = phase_kernels(dev)
    phase_reference(dev)
    counters = {"fps": fps_cuda, "knn": knn_cuda, "gather": gather_rows}
    launches = phase_slice(dev, counters)

    kernels = [{
        "name": name, "route": "cuda", "source": REPLACES[name][0],
        "replaces": REPLACES[name][1], "launches": launches[name],
        "max_abs_err": rep.err[name], "ms": rep.ms[name], "plain_ms": rep.plain_ms[name],
    } for name in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
