"""Where one full-width train step's time goes on the card:

    python -m afford_motion_torch.tools.profile_train_step [out_dir]
        [--banded | --store | --flash] [--dtype bfloat16 | float32] [--stage1]
        [--arch trans_enc | trans_dec] [--scene MLP | Perceiver | PointTrans | PointTransV2]

Builds the flagship CMDM ``trans_enc`` (latent 512, 5 layers, planes
32/64/128/256, bf16) from a seeded init and one random batch of 32 items
(8192-point clouds, 196x263 motions) on the card, runs a few warm-up steps,
then (1) times the parts of a step by a host clock to a device synchronize
(hierarchy, forward with loss, backward, optimizer) over a few steps and
(2) traces one step with ``torch.profiler`` and prints the device time by
kernel. Prints the card's name and power limit first; writes the table to
``out_dir`` (default ``build/profile``). No dataset is read: this measures the
device's step, not the host's loading. With ``--banded`` it profiles the
banded step instead, as the loop runs it on a curve-sorted packed store: the
clouds are Hilbert-sorted, the batch carries each item's cached ascending
``fps_idx`` (so no FPS runs in the step) and the model has ``use_banded`` on;
the table goes to ``profile_train_step_banded.txt``. With ``--store`` it
profiles the step as the loop runs it on the device store
(``train/device_store.py``): the same sorted clouds, motions of 40..196
frames and contacts held in a store on the card, the whole hierarchy cached
at upload, and each step assembling its batch on the card from an index
batch of random items and crops; the parts are the assembly, the hierarchy
from the cache, forward with loss, backward and the optimizer, and the table
goes to ``profile_train_step_store.txt``. With ``--flash`` the model
has dropout 0 and every step is taken twice, with ``AM_FLASH_ATTN=1`` (the
fused attention's kernels, forward and backward) and ``0`` (the einsum
route), in turns; besides the whole and the traced steps it times one
layer's attention, forward and backward, at the step's shape each way with
``chip_smoke.time_ms``, and sums the fused kernels' device time in the
traced step; the table goes to ``profile_train_step_flash.txt``. ``--dtype
float32`` builds the model in float32 (the config's reference-parity dtype)
instead of the train config's bf16; with ``--flash`` that routes every layer
through the f32 forward and backward kernels, and the table goes to
``profile_train_step_flash_float32.txt``.

``--arch trans_dec`` builds the CMDM ``trans_dec`` of the same widths
instead (``model.arch=trans_dec``: the SceneMap U-Net, 5 self-attention
stages and 4 decoder layers whose cross-attention reads its 128, 512, 2048
and 8192 points), whose hierarchy, built in the step or cached in the
store, carries the 3-NN up-interpolation; with every option above, and ``_trans_dec`` at the end of each table's name. With
``--flash`` its attention alone is timed at each of its shapes: the
self-attention (198 tokens) and each cross-attention.

With ``--stage1`` the model is stage 1's instead, the CDM-Perceiver as
``scripts/t2m_contact/train_ddp.sh`` builds it (bf16, dropout 0.1, no scene
model), on a batch of 64 contact maps (8192 points, 6 channels) with their
f16 clouds and caption embeddings; with ``--store`` also, each step
assembling that batch on the card from a stage-1 store of 64 scenes (f32
distances, the sigma kernel and the normalization on the card). The tables
go to ``profile_train_step_stage1.txt`` and
``profile_train_step_stage1_store.txt``. ``--stage1 --scene ARCH`` profiles
instead the CDM of that backbone with its frozen scene model, as
``task=contact_gen model=cdm`` builds it (``MLP`` is the shipped default),
on 64 coloured clouds; the hierarchies are built in the step, and the table
goes to ``profile_train_step_stage1_scene_<ARCH>.txt``; with ``--store`` also,
each step assembling that batch from the HUMANISE tree's ``motionx_contact``
store of 64 Hilbert-sorted scenes (colours, the fps wire of each hierarchy
the model reads, the rest cached at upload through the banded kNN), table
``profile_train_step_stage1_scene_<ARCH>_store.txt``. Every table ends with the traced
step's device time by kernel class (GEMMs, elementwise, reductions, norms,
softmax, the optimizer, copies, the port's kernels).
"""
from __future__ import annotations

import argparse
import re
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..diffusion import create_gaussian_diffusion
from ..models.cmdm import CMDM
from ..models.conditioning import add_hierarchies
from ..models.layers import set_dropout_generator
from ..train.loop import make_train_step
from ..train.state import TrainState, annealed_lr
from ..utils.config import DictConfig

B, N, L, D = 32, 8192, 196, 263


def _sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def _banded_batch(rng, dev):
    """Hilbert-sorted clouds (f16 on the wire) and their cached FPS indices,
    as the packed store with the fps geometry wire delivers them (the step's
    hierarchy, and the store's cache, follow the model's
    ``needs_up_interpolation``)."""
    from ..models.pointtransformer import SCENEMAP_NSAMPLES, SCENEMAP_STRIDES
    from ..ops.curves import curve_order
    from ..ops.hierarchy import build_point_hierarchy

    pts = rng.normal(size=(B, N, 3)).astype(np.float32)
    pts = np.stack([p[curve_order(p, "hilbert")] for p in pts])
    with torch.no_grad():
        levels = build_point_hierarchy(torch.from_numpy(pts).to(dev), SCENEMAP_STRIDES,
                                       SCENEMAP_NSAMPLES, with_up=False, sort_fps=True)
    cond = {f"geo_sm{li}_fps_idx": lvl.fps_idx.to(torch.int16)
            for li, lvl in enumerate(levels) if lvl.fps_idx is not None}
    cond["c_pc_xyz"] = torch.from_numpy(pts.astype(np.float16)).to(dev)
    return cond


def _store_batch(rng, dev, model):
    """A device store of B items on the card, as the loop builds it from a
    prepared tree (sorted clouds with their cached FPS indices, f16 motions
    of 40..196 frames, f16 distances), its hierarchy cached at upload, and
    one index batch of random items and crops: (assemble, index batch)."""
    from ..train.device_store import DeviceStore, make_assemble_fn

    wire = _banded_batch(rng, dev)
    wire["xyz16"] = wire.pop("c_pc_xyz")
    lengths = rng.integers(40, L + 1, size=B).astype(np.int32)
    motion16 = rng.normal(size=(B, L, D)).astype(np.float16)
    motion16[np.arange(L)[None, :] >= lengths[:, None]] = 0
    arrays = {"motion16": motion16, "length": lengths,
              "scene_row": np.arange(B, dtype=np.int32),
              "dist16": rng.uniform(0, 2, size=(B, N, 6)).astype(np.float16),
              **{k: v.cpu().numpy() for k, v in wire.items()}}
    meta = {"kind": "h3d", "n_items": B, "max_horizon": L, "unit_length": 4, "sigma": 0.5,
            "use_raw_dist": False, "motion_dim": D, "mix": False, "flag_chain": []}
    store = DeviceStore(arrays, meta)
    if not store.add_geometry_cache(model, dev):
        raise RuntimeError("the store's geometry cache was not built")
    assemble = make_assemble_fn(store, dev)
    crop_len = (lengths // 4) * 4
    batch = {"item_row": rng.permutation(B).astype(np.int32),
             "text_emb": rng.normal(size=(B, 1, 512)).astype(np.float16)}
    batch["crop_len"] = crop_len[batch["item_row"]]
    batch["crop_start"] = rng.integers(0, lengths[batch["item_row"]] - batch["crop_len"] + 1
                                       ).astype(np.int32)
    return assemble, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _stage1(rng, dev, store: bool, scene: str | None = None):
    """The published CDM-Perceiver (or, with ``scene``, the CDM of that
    backbone with its scene model) on the card and one stage-1 batch of
    ``B_STAGE1`` items: (model, x, cond, assemble); with ``store`` x is None
    and cond the index batch of a stage-1 store of ``B_STAGE1`` scenes. A
    scene model's store is the HUMANISE tree's ``motionx_contact`` store, as
    ``prepare sort|geometry|pack`` leaves it: Hilbert-sorted clouds with
    their f16 colours and the fps wire of each hierarchy the model reads,
    the rest of each hierarchy cached at upload through the banded kNN."""
    from ..models.base import create_model
    from ..train.device_store import DeviceStore, make_assemble_fn
    from ..utils.config import load_config
    from .kernel_ab import _smoke

    smoke = _smoke()
    args = (["task=contact_gen", "model=cdm", "diffusion.steps=500", f"model.arch={scene}"]
            if scene else ["task=text_to_motion_contact_gen", *smoke.STAGE1_MODEL])
    cfg = load_config(str(smoke.ROOT / "configs"), args)
    cfg.model.input_feats = 6
    model = create_model(cfg.model, dev)
    nb = smoke.B_STAGE1
    text = rng.normal(size=(nb, 1, 512)).astype(np.float16)
    xyz = rng.normal(size=(nb, N, 3)).astype(np.float16)
    if not store:
        cond = {"c_pc_xyz": torch.from_numpy(xyz).to(dev),
                "text_emb": torch.from_numpy(text).to(dev)}
        if scene:
            cond["c_pc_feat"] = torch.from_numpy(
                rng.uniform(size=(nb, N, 3)).astype(np.float32)).to(dev)
        x = torch.from_numpy(rng.normal(size=(nb, N, 6)).astype(np.float32)).to(dev)
        return model, x, cond, None
    arrays = {"scene_row": np.arange(nb, dtype=np.int32), "xyz16": xyz,
              "dist32": rng.uniform(0, 2, size=(nb, N, 6)).astype(np.float32)}
    meta = {"kind": "h3d_contact", "n_items": nb, "sigma": 0.8, "use_raw_dist": False,
            "mean": np.full((1, 6), 0.3, np.float32), "std": np.full((1, 6), 0.2, np.float32)}
    if scene:
        arrays.update(_scene_wire(model, xyz, dev))
        arrays["rgb16"] = rng.uniform(-1, 1, size=(nb, N, 3)).astype(np.float16)
        meta.update(kind="motionx_contact", rotate=False, use_color=True,
                    item_store_row=np.arange(nb, dtype=np.int32))
    device_store = DeviceStore(arrays, meta)
    if scene:
        model.use_banded = True
        if not device_store.add_geometry_cache(model, dev):
            raise RuntimeError("the store's geometry cache was not built")
    assemble = make_assemble_fn(device_store, dev)
    batch = {"item_row": rng.permutation(nb).astype(np.int32), "text_emb": text}
    return model, None, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}, assemble


def _scene_wire(model, xyz: np.ndarray, dev) -> dict:
    """Hilbert-sorts the clouds ``xyz`` (f16, in place) and returns the fps
    wire of every hierarchy ``model`` reads, as ``prepare geometry --kind
    seg`` (the scene model's) and ``--kind sm`` (PointTrans's) write it."""
    from ..models.conditioning import hierarchy_specs
    from ..ops.curves import curve_order
    from ..ops.hierarchy import build_point_hierarchy

    pts = xyz.astype(np.float32)
    pts = np.stack([p[curve_order(p, "hilbert")] for p in pts])
    xyz[...] = pts.astype(np.float16)
    wire = {}
    for _, prefix, strides, nsamples, _ in hierarchy_specs(model):
        with torch.no_grad():
            levels = build_point_hierarchy(torch.from_numpy(pts).to(dev), strides, nsamples,
                                           with_up=False, sort_fps=True)
        wire.update({f"{prefix}{li}_fps_idx": lvl.fps_idx.to(torch.int16).cpu().numpy()
                     for li, lvl in enumerate(levels) if lvl.fps_idx is not None})
    return wire


# the port's kernels (csrc/*.cu), by name
PORT_KERNELS = re.compile(
    r"(?<![a-z0-9_])(attention_bf16|attention_bwd_bf16|attention_bwd_f32|attention_f32|count|fps|"
    r"fps_streamed|gather_banded|gather_rows|knn_banded|knn_merge|knn_scan|lists|nn1_scan|"
    r"nn1_sort|order|place|scan|sums)_kernel(?![a-z0-9_])")
# the other kernel classes of a traced step, by a word of the kernel's name;
# the first class that matches takes it
KERNEL_CLASSES = (
    ("GEMMs", ("gemm", "cutlass", "xmma", "nvjet", "sm90_", "sm80_", "cublas")),
    ("softmax", ("softmax",)),
    ("norms", ("layer_norm", "batch_norm", "welford")),
    ("optimizer", ("adam", "multi_tensor")),
    ("reductions", ("reduce",)),
    ("copies and casts", ("copy", "cat", "index", "gather", "scatter", "fill")),
    ("elementwise", ("elementwise",)),
)


def _by_class(rows) -> list:
    """Lines of the traced step's device ms and launches by kernel class."""
    sums: dict = {}
    for ms, n, key in rows:
        low = key.lower()
        name = "the port's kernels" if PORT_KERNELS.search(low) else next(
            (c for c, words in KERNEL_CLASSES if any(w in low for w in words)), "other")
        t, c = sums.get(name, (0.0, 0))
        sums[name] = (t + ms, c + n)
    return [f"  {name}: {t:.3f} ms in {c} launches"
            for name, (t, c) in sorted(sums.items(), key=lambda kv: -kv[1][0])]


def _attention_shapes(model) -> list:
    """(label, query tokens, keys, calls a step) of the model's attention:
    ``trans_enc`` one self-attention shape (1 + 1 + 128 + 196 tokens) in
    every layer; ``trans_dec`` the self-attention of 1 + 1 + 196 tokens in
    every encoder and decoder layer and one cross-attention a decoder layer,
    against the U-Net's 128, 512, 2048 and 8192 points."""
    if model.arch == "trans_enc":
        seq = 2 + 128 + L
        return [("self", seq, seq, len(model.self_attn_layer.layers))]
    seq = 2 + L
    n_self = sum(len(s.layers) for s in model.self_attn_layers) + len(model.cross_attn_layers)
    return [("self", seq, seq, n_self)] + [(f"cross to {N // 4 ** (3 - i)} points", seq,
                                            N // 4 ** (3 - i), 1)
                                           for i in range(len(model.cross_attn_layers))]


def _attention_alone(smoke, model, x_mask, dev) -> list:
    """One call of each of the model's attention shapes (batch 32, 8 heads,
    the motions' padding masked; a cross-attention's memory unmasked) in the
    model's type, forward and backward, fused and einsum, on q, k and v as
    the layers give them (views of one packed projection: a self-attention's
    (B, L, 3D) qkv, a cross-attention's q and (B, Lk, 2D) kv), by
    ``chip_smoke.time_ms``: lines of the table. The fused route is the
    layers' whole: the kernels and, with a mask, the all-masked items'
    repair (``uniform_where_all_masked`` and its gradient)."""
    from ..models import layers
    from ..ops.cuda.attention import attention_q_kv_cuda, attention_qkv_cuda

    mha = (model.self_attn_layer.layers[0] if model.arch == "trans_enc"
           else model.self_attn_layers[0].layers[0]).self_attn
    heads, width = mha.num_heads, mha.d_model
    gen = torch.Generator(device=dev).manual_seed(7)
    dtype = model.dtype
    lines = [f"one attention call ({B} items, {heads}x{width // heads}) {str(dtype)[6:]}, ms "
             f"per call (chip_smoke.time_ms: median of {smoke.TIME_BLOCKS} blocks of 20 calls):"]
    total = {"fused": 0.0, "einsum": 0.0}
    for label, lq, lk, calls in _attention_shapes(model):
        def randn(*shape):
            return torch.randn(*shape, device=dev, generator=gen).to(dtype).requires_grad_(True)

        do = torch.randn(B, lq, width, device=dev, generator=gen).to(dtype)
        pad = None
        if lq == lk:
            pad = torch.cat([torch.zeros((B, lk - L), dtype=torch.bool, device=dev), x_mask],
                            dim=1)
            leaves = (randn(B, lq, 3 * width),)
            fused = lambda: attention_qkv_cuda(leaves[0], heads, pad)  # noqa: E731
            parts = lambda: leaves[0].chunk(3, dim=-1)  # noqa: E731
        else:
            leaves = (randn(B, lq, width), randn(B, lk, 2 * width))
            fused = lambda: attention_q_kv_cuda(*leaves, heads, pad)  # noqa: E731
            parts = lambda: (leaves[0], *leaves[1].chunk(2, dim=-1))  # noqa: E731
        routes = {"fused": fused,
                  "einsum": lambda: layers._attention(*parts(), heads, pad, mha.dropout)}
        for name, fwd in routes.items():
            with torch.no_grad():
                f_ms = smoke.time_ms(fwd, 20)[0]
            out = fwd()
            b_ms = smoke.time_ms(
                lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), 20)[0]
            total[name] += calls * (f_ms + b_ms)
            lines.append(f"  {label} ({lq} x {lk}) {name}: forward {f_ms:.4f}, backward "
                         f"{b_ms:.4f}, both {f_ms + b_ms:.4f}; x {calls} a step: "
                         f"{calls * (f_ms + b_ms):.4f}")
            del out
    lines.append(f"  a step's attention, forward and backward: fused {total['fused']:.4f}, "
                 f"einsum {total['einsum']:.4f}")
    return lines


def _traced(step, state, x, cond, seed: int):
    """One traced step: (wall ms, device ms, launches, [(ms, count, name)]).
    Ranges the profiler marks as user annotations (the optimizer's step) are
    left out: their device time is that of the kernels inside them."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, traced_ms = _sync_time(lambda: step(state, x, cond, seed=seed))
    events = [e for e in prof.key_averages() if e.device_time_total > 0
              and not getattr(e, "is_user_annotation", False)]
    cuda = [e for e in events if "cuda" in str(e.device_type).lower()]
    events = cuda or events
    total = sum(e.self_device_time_total for e in events) / 1e3
    count = sum(e.count for e in events)
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in events),
                  key=lambda r: -r[0])
    return traced_ms, total, count, rows


def main(out_dir: str = "build/profile", banded: bool = False, flash: bool = False,
         dtype: str = "bfloat16", store: bool = False, stage1: bool = False,
         arch: str = "trans_enc", scene: str | None = None) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_train_step runs only on a CUDA device")
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.manual_seed(2023)
    rng = np.random.default_rng(2023)
    assemble = None
    if stage1:
        model, x, cond, assemble = _stage1(rng, dev, store, scene)
        diffusion = create_gaussian_diffusion(DictConfig({"steps": 500}), dev)
    else:
        model = CMDM(motion_dim=D, dtype=getattr(torch, dtype), arch=arch,
                     dropout=0.0 if flash else 0.1).to(dev)
        diffusion = create_gaussian_diffusion(DictConfig({"steps": 1000}), dev)
        if store:
            model.use_banded = True
            assemble, cond = _store_batch(rng, dev, model)
            x = None
        else:
            x_mask = np.arange(L)[None, :] >= rng.integers(40, L + 1, size=(B, 1))
            if banded:
                model.use_banded = True
                cond = _banded_batch(rng, dev)
            else:
                cond = {"c_pc_xyz": torch.from_numpy(
                    rng.normal(size=(B, N, 3)).astype(np.float16)).to(dev)}
            cond.update({
                "c_pc_contact": torch.from_numpy(
                    rng.uniform(size=(B, N, 6)).astype(np.float16)).to(dev),
                "text_emb": torch.from_numpy(
                    rng.normal(size=(B, 1, 512)).astype(np.float32)).to(dev),
                "x_mask": torch.from_numpy(x_mask).to(dev),
            })
            x = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32)).to(dev)
    state = TrainState.create(model, lr=1e-4)
    nb = len(cond["item_row"]) if x is None else x.shape[0]
    step = make_train_step(model, diffusion, assemble=assemble)
    suffix = "" if stage1 or arch == "trans_enc" else f"_{arch}"
    if flash:
        text = "\n".join([f"CMDM {arch}, model in {dtype}"]
                         + _flash_table(model, step, state, x, cond, diffusion, dev))
        print(text, flush=True)
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        name = "profile_train_step_flash" + ("_float32" if dtype == "float32" else "") + suffix
        (out / f"{name}.txt").write_text(text + "\n")
        return
    torch.cuda.reset_peak_memory_stats(dev)
    for i in range(3):
        step(state, x, cond, seed=i)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30

    # (1) the parts of a step, each to a synchronize
    parts = {"assemble": [], "hierarchy": [], "forward+loss": [], "backward": [],
             "optimizer": []}
    if assemble is None:
        del parts["assemble"]
    for i in range(5):
        model.train()
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        set_dropout_generator(model, gen)
        t = torch.randint(0, diffusion.num_timesteps, (nb,), generator=gen, device=dev)
        x_i, cond_i = x, cond
        if assemble is not None:
            (x_i, cond_i), ms = _sync_time(lambda: assemble(cond))
            parts["assemble"].append(ms)
            x_i = x_i.float()
        cond_h, ms = _sync_time(lambda: add_hierarchies(model, cond_i))
        parts["hierarchy"].append(ms)
        loss, ms = _sync_time(lambda: diffusion.training_losses(
            lambda x_t, ts: model(x_t, ts, cond_h), x_i, t, generator=gen,
            x_mask=cond_h.get("x_mask"))["loss"].mean())
        parts["forward+loss"].append(ms)
        state.optimizer.zero_grad(set_to_none=True)
        _, ms = _sync_time(loss.backward)
        parts["backward"].append(ms)
        for group in state.optimizer.param_groups:
            group["lr"] = annealed_lr(state.lr, state.step, state.lr_anneal_steps)
        _, ms = _sync_time(state.optimizer.step)
        parts["optimizer"].append(ms)
    route = "store" if store else "banded" if banded else "non-banded"
    if stage1:
        route = "stage-1 " + (f"scene {scene} " if scene else "") + ("store" if store else "")
        route = route.rstrip()
    if not stage1:
        route = f"{arch} {route}"
    lines = [f"{route} step, batch {nb}, peak memory of the first three {peak:.2f} GiB; parts "
             f"of one step, ms to a synchronize (5 steps: min / mean / max):"]
    for name, v in parts.items():
        lines.append(f"  {name}: {min(v):.3f} / {np.mean(v):.3f} / {max(v):.3f}")
    whole = [_sync_time(lambda i=i: step(state, x, cond, seed=200 + i))[1] for i in range(5)]
    lines.append(f"  whole step: {min(whole):.3f} / {np.mean(whole):.3f} / {max(whole):.3f}")

    # (2) one traced step
    traced_ms, total, count, rows = _traced(step, state, x, cond, 300)
    lines.append(f"traced step: {traced_ms:.3f} ms wall with the profiler on, "
                 f"{total:.3f} ms of device kernels in {count} launches")
    for ms, n, key in rows[:30]:
        lines.append(f"  {ms:9.3f} ms  {n:5d}x  {key[:110]}")
    lines.append("traced step by kernel class:")
    lines += _by_class(rows)
    text = "\n".join(lines)
    print(text, flush=True)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    name = {"store": "_store", "banded": "_banded", "non-banded": "", "stage-1": "_stage1",
            "stage-1 store": "_stage1_store",
            f"stage-1 scene {scene}": f"_stage1_scene_{scene}",
            f"stage-1 scene {scene} store": f"_stage1_scene_{scene}_store"}[
        route.removeprefix(f"{arch} ")]
    (out / f"profile_train_step{name}{suffix}.txt").write_text(text + "\n")


def _flash_table(model, step, state, x, cond, diffusion, dev) -> list:
    """The --flash table: whole steps and traced steps with AM_FLASH_ATTN=1
    and 0 in turns, and one layer's attention alone each way."""
    from .kernel_ab import _smoke

    smoke = _smoke()
    for i in range(3):
        for value in ("1", "0"):
            with smoke.flash_switch(value):
                step(state, x, cond, seed=i)
    whole = {"1": [], "0": []}
    for i in range(4):
        for value in ("1", "0") if i % 2 == 0 else ("0", "1"):
            with smoke.flash_switch(value):
                whole[value].append(_sync_time(lambda: step(state, x, cond, seed=200 + i))[1])
    lines = ["dropout 0; whole step, ms to a synchronize (4 steps each way, in turns: "
             "min / mean / max):"]
    for value, v in whole.items():
        lines.append(f"  AM_FLASH_ATTN={value}: {min(v):.3f} / {np.mean(v):.3f} / {max(v):.3f}")
    for value in ("1", "0", "1", "0"):
        with smoke.flash_switch(value):
            traced_ms, total, count, rows = _traced(step, state, x, cond, 300)
        fused = [(ms, n, key) for ms, n, key in rows if "attention" in key and "_kernel" in key]
        lines.append(f"traced step, AM_FLASH_ATTN={value}: {traced_ms:.3f} ms wall with the "
                     f"profiler on, {total:.3f} ms of device kernels in {count} launches; the "
                     f"fused attention's kernels {sum(r[0] for r in fused):.3f} ms")
        for ms, n, key in fused:
            lines.append(f"  {ms:9.3f} ms  {n:5d}x  {key[:110]}")
    for ms, n, key in rows[:12]:   # the einsum route's largest kernels
        lines.append(f"  einsum route: {ms:9.3f} ms  {n:5d}x  {key[:100]}")
    return lines + _attention_alone(smoke, model, cond["x_mask"], dev)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir", nargs="?", default="build/profile")
    ap.add_argument("--banded", action="store_true")
    ap.add_argument("--store", action="store_true")
    ap.add_argument("--flash", action="store_true")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--stage1", action="store_true")
    ap.add_argument("--arch", default="trans_enc", choices=("trans_enc", "trans_dec"))
    ap.add_argument("--scene", default=None,
                    choices=("MLP", "Perceiver", "PointTrans", "PointTransV2"))
    args = ap.parse_args()
    main(args.out_dir, banded=args.banded, flash=args.flash, dtype=args.dtype, store=args.store,
         stage1=args.stage1, arch=args.arch, scene=args.scene)
