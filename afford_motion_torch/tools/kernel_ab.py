"""A/B times of one hand-written kernel at the shapes of one pass of the
training and sampling paths (batch 32, 8192-point clouds), for one or more
checkouts of the repo in turn, on one card:

    python afford_motion_torch/tools/kernel_ab.py --kernel KERNEL \
        [--sweep] [--out DIR] ROOT [ROOT ...]

KERNEL is one of knn, gather, banded_knn, banded_gather, scatter,
banded_scatter, attention_f32, attention_bwd (``--dtype bfloat16`` or
``float32``), nn1, scene.

Each ROOT is the root of a checkout (``.`` for this one; an older commit
unpacked with ``git archive`` into ``build/``); each is measured in its own
process, which imports ``afford_motion_torch`` from that root and builds its
kernels there, so list them in turns (old, new, new, old) to compare two
versions on one card. The shapes (``KNN_CALLS``, ``GATHER_CALLS``), the
timer (``time_ms``: the median, least and largest of 5 blocks of
back-to-back calls by CUDA events) and the bit comparison are those of this
checkout's ``chip_smoke.py``, whatever the root. Per shape: the result held
bit-equal to the plain version (the attention: within ``TOLERANCE`` or
``TOLERANCE_BWD`` of it), then the kernel's ms per call. The scatter-adds
(the row gather's #4 and the banded gather's #7) run at the gathers' shapes
in bf16, the path's type, whose rows make the pass's sum, and in f32 beside
them; each also gives the profiler's device time per kernel of one bf16
call, and #4 the largest and mean in-degree of each shape. The attention's
shapes are the regressor's f32 forward (16, 196, 4x64) and the train path's
backward (32, 326, 8x64) in bf16 or f32, with the padded frames masked, each
beside ``scaled_dot_product_attention`` (its forward, or its whole
backward). The 1-NN runs one 196-frame sequence against 8192 scene points
on ``chip_smoke.nn1_cloud``'s clouds a and b, with the share of pairs it
evaluates. ``scene`` runs the root's own ``chip_smoke.phase_scene_slice``
once (the scene-protocol test path at full width: two DDPM-500 chains of
32 with the fused attention, the SMPL-X fit, LBS, SDF physics with the
1-NN, APD, with the root's launch checks) and gives the evaluator's times
in seconds from its ``timing.json``.
The row gather (#3) runs at the gathers' shapes in bf16 and f32, each
beside ``torch.gather``; the banded kNN (#5) at the kNN's shapes on a sorted
pyramid, with the queue merges a warp took. ``--sweep`` also times, for the
roots whose wrappers expose them, every launch configuration of the kernel
(kNN: threads a block, parts of the cloud; row gather: chunks a lane at a
time, wide loads, span; banded kNN: queries a block and parts of the
window; banded gather: blocks a tile, window staged or not; the f32
attention: queries a block; the backward and the 1-NN have one; the scatters' sums:
channel passes, channels a lane and the register budget). Prints the card's name and power limit
first; writes everything to ``DIR/kernel_ab.txt`` (default ``build/profile``).
"""
from __future__ import annotations

import argparse
import importlib.util
import itertools
import json
import subprocess
import sys
from pathlib import Path


def _smoke():
    """This checkout's ``chip_smoke.py`` as a module (by its path: a root's
    own copy may differ)."""
    path = Path(__file__).resolve().parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _equal(smoke, got, want, what):
    for x, y in zip(got, want):
        if x.dtype != y.dtype or x.shape != y.shape or not smoke.torch.equal(
                smoke.bits(x), smoke.bits(y)):
            raise AssertionError(f"{what}: kernel differs from plain")


def _checked_time(smoke, fn, want, reps):
    """A configuration of the sweep: its time if it equals plain, else why not."""
    try:
        _equal(smoke, fn(), want, "sweep")
    except (AssertionError, RuntimeError, ValueError) as e:
        return [f"FAILED: {e}"]
    return smoke.time_ms(fn, reps)


def _pyramid(cloud, sort_fps):
    """The 8192-point cloud and its FPS levels of 2048, 512, 128 points (the
    FPS indices ascending on a banded pyramid): (levels, FPS indices)."""
    import torch

    from afford_motion_torch.ops.cuda.fps import fps_cuda

    levels, fps = [torch.from_numpy(cloud).to("cuda:0")], [None]
    for n_out in (2048, 512, 128):
        idx = fps_cuda(levels[-1], n_out)
        if sort_fps:
            idx = torch.sort(idx, dim=-1).values
        fps.append(idx)
        levels.append(torch.gather(levels[-1], 1, idx.long()[..., None].expand(-1, -1, 3)))
    return levels, fps


def _knn(smoke, rng, sweep):
    """The packed kNN of one SceneMap hierarchy on an FPS pyramid (a sweep's
    rows time the kernel alone, the curve order made once)."""
    from afford_motion_torch.ops.cuda import knn

    b = smoke.B
    levels, _ = _pyramid(rng.normal(size=(b, smoke.N_POINTS, 3)).astype("float32"), False)
    rows = {}
    for qi, si, k in smoke.KNN_CALLS:
        q, s = levels[qi], levels[si]
        m, n = q.shape[1], s.shape[1]
        want = knn.knn_plain(q, s, k)
        _equal(smoke, knn.knn_cuda(q, s, k), want, f"knn {m}/{n}")
        rows[f"knn q{m} s{n} k{k}"] = smoke.time_ms(lambda: knn.knn_cuda(q, s, k), 5)
        if sweep and hasattr(knn, "launch_config"):
            order = knn.curve_order(q, s)
            rows[f"  curve order q{m} s{n}"] = smoke.time_ms(lambda: knn.curve_order(q, s), 5)
            for threads, split in itertools.product((128, 256, 512, 1024), (1, 2, 4, 8)):
                if n % (split * knn.CHUNK) != 0 or threads > 2 * m:
                    continue
                cfg = (threads, split)
                rows[f"  sweep knn q{m} s{n} k{k} {cfg}"] = _checked_time(
                    smoke, lambda: knn.launch(q, s, k, *cfg, order=order), want, 5)
            rows[f"  policy knn q{m} s{n} k{k}"] = list(knn.launch_config(b, m, n, k))
    return rows


def _plain_indices(smoke, rng):
    """The packed kNN's indices of one SceneMap hierarchy on an FPS pyramid,
    as ``chip_smoke.py``'s kernel phase makes them (level 3's 128 points
    below the kernel's range: random in-range neighbours): (levels, {(query
    level, support level): idx})."""
    import torch

    from afford_motion_torch.ops.cuda import knn

    b, dev = smoke.B, torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
    levels, _ = _pyramid(rng.normal(size=(b, smoke.N_POINTS, 3)).astype("float32"), False)
    idx = {(qi, si): knn.knn_cuda(levels[qi], levels[si], k)[0] for qi, si, k in smoke.KNN_CALLS}
    idx[(3, 3)] = torch.randint(0, 128, (b, 128, 16), device=dev, dtype=torch.int32,
                                generator=gen)
    return levels, idx


def _banded_indices(smoke, rng):
    """The banded kNN's indices of one banded SceneMap hierarchy on a sorted
    pyramid, with their starts (static on self levels, adaptive across):
    (levels, {(query level, support level): idx}, {...: starts})."""
    import numpy as np
    import torch

    from afford_motion_torch.ops.cuda import banded
    from afford_motion_torch.ops.curves import curve_order
    from afford_motion_torch.ops.pointops import knn as knn_exact

    b, w0, dev = smoke.B, 128, torch.device("cuda:0")
    cloud = rng.normal(size=(b, smoke.N_POINTS, 3)).astype(np.float32)
    levels, fps = _pyramid(np.stack([c[curve_order(c, "morton")] for c in cloud]), True)
    knn_idx, starts = {}, {}
    for qi, si, k in smoke.KNN_CALLS:
        q, sup = levels[qi], levels[si]
        m, n = q.shape[1], sup.shape[1]
        st = (banded._starts_tensor(m, n, w0, dev) if qi == si
              else banded.adaptive_down_starts(fps[qi], n, w0))
        knn_idx[(qi, si)], starts[(qi, si)] = banded.knn_banded(q, sup, k, st, w0)[0], st
    knn_idx[(3, 3)] = knn_exact(levels[3], levels[3], 16)[0].contiguous()
    starts[(3, 3)] = banded._starts_tensor(128, 128, w0, dev)
    return levels, knn_idx, starts


def _banded_gather(smoke, rng, sweep):
    """The banded gathers of one banded SceneMap encoder on a sorted pyramid,
    bf16."""
    import torch

    from afford_motion_torch.ops.cuda import banded, build

    b, w0, dev = smoke.B, 128, torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
    levels, knn_idx, starts = _banded_indices(smoke, rng)
    rows = {}
    for (qi, si), c in smoke.GATHER_CALLS:
        idx, st = knn_idx[(qi, si)], starts[(qi, si)]
        n, (m, k) = levels[si].shape[1], idx.shape[1:]
        size = banded._window(m, n, w0)
        x = torch.randn(b, n, c, device=dev, generator=gen).to(torch.bfloat16)
        want = [banded.gather_banded_plain(x, idx, st, size)]
        _equal(smoke, [banded.gather_banded(x, idx, st, w0)], want, f"gather {m}/{n}x{c}")
        rows[f"banded_gather m{m} n{n} c{c} k{k} S{size}"] = smoke.time_ms(
            lambda: banded.gather_banded(x, idx, st, w0), 10)
        if sweep and hasattr(banded, "gather_config"):
            stride = 0 if st.ndim == 1 else st.shape[1]
            for staged in (True, False):
                if staged and size * c * 2 + banded.TQ * k * 4 > build.SMEM_BYTES:
                    continue
                for parts in (1, 2, 4, 8, 16):
                    cfg = (parts, staged)
                    rows[f"  sweep banded_gather m{m} c{c} {cfg}"] = _checked_time(
                        smoke, lambda: [banded.launch_gather(x, idx, st, stride, size, *cfg)],
                        want, 10)
            rows[f"  policy banded_gather m{m} c{c}"] = list(
                banded.gather_config(b, m, c, k, size, 2))
    return rows


def _gather(smoke, rng, sweep):
    """The row gathers (#3) of one SceneMap encoder on an FPS pyramid, bf16
    (the path) and f32 beside it, each beside ``torch.gather``."""
    import torch

    from afford_motion_torch.ops.cuda import gather

    b, dev = smoke.B, torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 4)
    levels, idx = _plain_indices(smoke, rng)
    rows = {}
    for (qi, si), c in smoke.GATHER_CALLS:
        ii = idx[(qi, si)]
        n, (m, k) = levels[si].shape[1], ii.shape[1:]
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(b, n, c, device=dev, generator=gen).to(dtype)
            want = [gather.gather_rows_plain(x, ii)]
            call = lambda x=x: [gather.gather_rows(x, ii)]   # noqa: E731
            _equal(smoke, call(), want, f"gather {m}/{n}x{c} {dtype}")
            tag = "gather" if dtype == torch.bfloat16 else "  f32 gather"
            rows[f"{tag} m{m} n{n} c{c} k{k}"] = smoke.time_ms(call, 10)
            wide = ii.long().reshape(b, m * k, 1).expand(-1, -1, c)
            rows[f"  torch.gather {str(dtype)[6:]} m{m} n{n} c{c} k{k}"] = smoke.time_ms(
                lambda x=x, w=wide: torch.gather(x, 1, w), 10)
            if sweep and hasattr(gather, "gather_config"):
                for cfg in gather.GATHER_CONFIGS:
                    label = f"  sweep {tag.strip()} m{m} c{c} (mode, wide, span) {cfg}"
                    rows[label] = _checked_time(
                        smoke, lambda cfg=cfg, x=x: [gather.launch_gather(x, ii, *cfg)], want, 10)
                rows[f"  policy {tag.strip()} m{m} c{c}"] = list(
                    gather.gather_config(ii.numel(), c, x.element_size()))
    return rows


def _banded_knn(smoke, rng, sweep):
    """The banded kNN (#5) of one banded SceneMap hierarchy on a sorted
    pyramid (static starts on self levels, adaptive across); per shape the
    queue merges a warp took (the selection's share of the work)."""
    import numpy as np
    import torch

    from afford_motion_torch.ops.cuda import banded
    from afford_motion_torch.ops.curves import curve_order

    b, w0, dev = smoke.B, 128, torch.device("cuda:0")
    cloud = rng.normal(size=(b, smoke.N_POINTS, 3)).astype(np.float32)
    levels, fps = _pyramid(np.stack([c[curve_order(c, "morton")] for c in cloud]), True)
    rows = {}
    for qi, si, k in smoke.KNN_CALLS:
        q, sup = levels[qi], levels[si]
        m, n = q.shape[1], sup.shape[1]
        st = (banded._starts_tensor(m, n, w0, dev) if qi == si
              else banded.adaptive_down_starts(fps[qi], n, w0))
        size = banded._window(m, n, w0)
        want = banded.knn_banded_plain(q, sup, k, st, size)
        call = lambda q=q, sup=sup, k=k, st=st: banded.knn_banded(q, sup, k, st, w0)  # noqa: E731
        _equal(smoke, call(), want, f"banded_knn {m}/{n} k{k}")
        rows[f"banded_knn q{m} s{n} k{k} S{size}"] = smoke.time_ms(call, 5)
        if not hasattr(banded, "knn_config"):
            continue
        stride = 0 if st.ndim == 1 else st.shape[1]
        policy = banded.knn_config(b, m, size, k)
        flushes = torch.zeros(1, dtype=torch.int64, device=dev)
        _equal(smoke, banded.launch_knn(q, sup, k, st, stride, size, *policy, flushes=flushes),
               want, "banded_knn with the flush counter")
        warps = b * m // 32 * policy[1]
        rows[f"  flushes banded_knn q{m} s{n}"] = [
            f"{int(flushes.item()) / warps:.2f} a warp over {size // policy[1]} rows, "
            f"policy {policy}"]
        if sweep:
            for cfg in banded.knn_configs(size, k):
                rows[f"  sweep banded_knn q{m} s{n} k{k} (queries, groups) {cfg}"] = _checked_time(
                    smoke, lambda cfg=cfg, q=q, sup=sup, k=k, st=st: banded.launch_knn(
                        q, sup, k, st, stride, size, *cfg), want, 5)
            rows[f"  policy banded_knn q{m} s{n}"] = list(policy)
    return rows


def _device_split(fn, reps=10) -> str:
    """The device time of each kernel (and memset) one call of ``fn``
    launches, by the profiler: 'name ms, ...'."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if e.device_type.name == "CUDA" and e.self_device_time_total > 0:
            name = re.search(r"(\w*kernel\w*|[Mm]emset)", e.key)
            name = name.group(1) if name else e.key[:40]
            split[name] = split.get(name, 0.0) + e.self_device_time_total / 1e3 / reps
    return ", ".join(f"{k} {v:.4f}" for k, v in split.items()) or "no device time seen"


def _scatter(smoke, rng, sweep):
    """The scatter-adds (#4) of one SceneMap encoder's backward on an FPS
    pyramid, bf16 (the path) and f32 beside it; per shape the largest and
    the mean in-degree, and the profiler's split of one call by kernel."""
    import torch

    from afford_motion_torch.ops.cuda import gather

    b, dev = smoke.B, torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 1)
    levels, idx = _plain_indices(smoke, rng)
    rows = {}
    for (qi, si), c in smoke.GATHER_CALLS:
        ii = idx[(qi, si)]
        n, (m, k) = levels[si].shape[1], ii.shape[1:]
        deg = torch.stack([torch.bincount(ii[i].reshape(-1).long(), minlength=n)
                           for i in range(b)])
        rows[f"  in-degree m{m} n{n} k{k}"] = [f"max {int(deg.max())}, "
                                               f"mean {float(deg.float().mean()):.2f}"]
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.randn(b, m, k, c, device=dev, generator=gen).to(dtype)
            want = [gather.scatter_add_rows_plain(g, ii, n)]
            call = lambda g=g: [gather.scatter_add_rows(g, ii, n)]   # noqa: E731
            _equal(smoke, call(), want, f"scatter {m}/{n}x{c} {dtype}")
            tag = "scatter" if dtype == torch.bfloat16 else "  f32 scatter"
            rows[f"{tag} m{m} n{n} c{c} k{k}"] = smoke.time_ms(call, 10)
            if dtype == torch.bfloat16:
                rows[f"  split scatter m{m} c{c}"] = [_device_split(call)]
            if sweep and dtype == torch.bfloat16 and hasattr(gather, "scatter_config"):
                policy = gather.scatter_config(c)
                configs = {smoke.scatter_passes(c, f, w, o) for f in (1, 2) for w in (2, 3, 4)
                           for o in (0, 1)}
                for cfg in sorted(configs | {policy}):
                    rows[f"  sweep {tag.strip()} m{m} c{c} (passes, wide, budget) {cfg}"] = (
                        _checked_time(smoke, lambda cfg=cfg, g=g: [
                            gather.launch_scatter(g, ii, n, *cfg)], want, 10))
                rows[f"  policy scatter m{m} c{c}"] = list(policy)
    return rows


def _banded_scatter(smoke, rng, sweep):
    """The banded scatter-adds (#7) of one banded SceneMap encoder's
    backward on a sorted pyramid, bf16 (the path) and f32 beside it."""
    import torch

    from afford_motion_torch.ops.cuda import banded

    b, w0, dev = smoke.B, 128, torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 2)
    levels, knn_idx, starts = _banded_indices(smoke, rng)
    rows = {}
    for (qi, si), c in smoke.GATHER_CALLS:
        idx, st = knn_idx[(qi, si)], starts[(qi, si)]
        n, (m, k) = levels[si].shape[1], idx.shape[1:]
        size = banded._window(m, n, w0)
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.randn(b, m, k, c, device=dev, generator=gen).to(dtype)
            want = [banded.scatter_banded_plain(g, idx, st, n, size)]
            call = lambda g=g: [banded.scatter_banded(g, idx, st, n, size)]   # noqa: E731
            _equal(smoke, call(), want, f"banded_scatter {m}/{n}x{c} {dtype}")
            tag = "banded_scatter" if dtype == torch.bfloat16 else "  f32 banded_scatter"
            rows[f"{tag} m{m} n{n} c{c} k{k} S{size}"] = smoke.time_ms(call, 10)
            if dtype == torch.bfloat16:
                rows[f"  split banded_scatter m{m} c{c}"] = [_device_split(call)]
            if sweep and dtype == torch.bfloat16 and hasattr(banded, "scatter_config"):
                stride = 0 if st.ndim == 1 else st.shape[1]
                policy = banded.scatter_config(c, banded=True)
                configs = {smoke.scatter_passes(c, f, w, o) for f in (1, 2) for w in (2, 3, 4)
                           for o in (0, 1)}
                for cfg in sorted(configs | {policy}):
                    rows[f"  sweep {tag.strip()} m{m} c{c} (passes, wide, budget) {cfg}"] = (
                        _checked_time(smoke, lambda cfg=cfg, g=g: [
                            banded.launch_scatter(g, idx, st, stride, n, size, *cfg)], want, 10))
                rows[f"  policy banded_scatter m{m} c{c}"] = list(policy)
    return rows


def _masked_qkv(smoke, rng, b, seq, heads, dtype, n=3):
    """``n`` (b, seq, heads*64) tensors on the card and the key padding mask
    of motions of 40..196 frames at the end of ``seq`` tokens, as
    ``chip_smoke.py`` makes them."""
    import torch

    dev = torch.device("cuda:0")
    x = [torch.from_numpy(rng.normal(size=(b, seq, heads * 64)).astype("float32")).to(dev)
         .to(dtype) for _ in range(n)]
    lengths = rng.integers(40, smoke.L + 1, size=b)
    pad = torch.from_numpy(smoke.np.arange(smoke.L)[None, :] >= lengths[:, None])
    pad = torch.cat([torch.zeros((b, seq - smoke.L), dtype=torch.bool), pad], dim=1).to(dev)
    return x, pad


def _within(got, want, atol, rtol, what):
    """Every entry within ``atol + rtol |want|``, as chip_smoke.py checks."""
    if not bool(((got.double() - want.double()).abs()
                 <= atol + rtol * want.double().abs()).all()):
        raise AssertionError(f"{what}: kernel differs from plain")


def _checked(fn, check, smoke, reps):
    """A configuration of the sweep: its time if its result passes ``check``,
    else why not."""
    try:
        check(fn())
    except (AssertionError, RuntimeError, ValueError) as e:
        return [f"FAILED: {e}"]
    return smoke.time_ms(fn, reps)


def _attention_f32(smoke, rng, sweep):
    """The regressor's f32 attention forward (chip_smoke.py's FIT_BATCH
    sequences of L frames, 4 heads of 64)."""
    import torch
    import torch.nn.functional as F

    from afford_motion_torch.ops.cuda import attention as attn

    b, heads = smoke.FIT_BATCH, 4
    (q, k, v), pad = _masked_qkv(smoke, rng, b, smoke.L, heads, torch.float32)
    atol = attn.TOLERANCE[torch.float32][0] * float(v.abs().max())
    want = attn.attention_plain(q, k, v, heads, pad)

    def check(got):
        _within(got, want, atol, 0.0, "attention_f32")

    rows = {}
    fwd = lambda: attn.attention_forward_cuda(q, k, v, heads, pad)[0]   # noqa: E731
    label = f"attention_f32 ({b},{smoke.L},{heads}x64)"
    rows[label] = _checked(fwd, check, smoke, 10)

    def heads_first(x):
        return x.reshape(b, -1, heads, 64).transpose(1, 2)

    rows[f"  scaled_dot_product_attention ({b},{smoke.L},{heads}x64)"] = smoke.time_ms(
        lambda: F.scaled_dot_product_attention(heads_first(q), heads_first(k), heads_first(v),
                                               attn_mask=~pad[:, None, None, :]), 10)
    if sweep and hasattr(attn, "F32_ROWS"):
        for n in attn.F32_ROWS:
            rows[f"  sweep attention_f32 queries a block {n}"] = _checked(
                lambda n=n: attn.attention_forward_cuda(q, k, v, heads, pad, config=n)[0],
                check, smoke, 10)
    return rows


def _attention_bwd(smoke, rng, sweep, dtype="bfloat16"):
    """The train path's attention backward (batch B, 326 tokens, 8 heads of
    64, the CMDM's masks) in ``dtype``, all three gradients, beside the
    whole backward of ``scaled_dot_product_attention``; in float32 also at
    the regressor's shape (16, 196, 4x64). It has one launch configuration
    in each type, so ``sweep`` adds nothing."""
    import torch
    import torch.nn.functional as F

    from afford_motion_torch.ops.cuda import attention as attn

    dt = getattr(torch, dtype)
    b, seq, heads = smoke.B, 1 + 1 + 128 + smoke.L, 8
    (q, k, v, do), pad = _masked_qkv(smoke, rng, b, seq, heads, dt, 4)
    o, lse = attn.attention_forward_cuda(q, k, v, heads, pad, stats=True)
    want = attn.attention_backward_plain(q, k, v, o, do, lse, heads, pad)
    atol, rtol = attn.TOLERANCE_BWD[dt]

    def check(got):
        if attn.backward_excess(got, want, rtol) > atol:
            raise AssertionError("attention_bwd: kernel differs from plain")
        again = attn.attention_backward_cuda(q, k, v, o, do, lse, heads, pad)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError("attention_bwd: two calls differ")

    rows = {}
    label = f"attention_bwd ({b},{seq},{heads}x64) {dtype}"
    rows[label] = _checked(lambda: attn.attention_backward_cuda(q, k, v, o, do, lse, heads, pad),
                           check, smoke, 10)
    qh, kh, vh = (x.reshape(b, seq, heads, 64).transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=~pad[:, None, None, :])
    doh = do.reshape(b, seq, heads, 64).transpose(1, 2)
    rows[f"  gradient of scaled_dot_product_attention ({b},{seq},{heads}x64) {dtype}"] = \
        smoke.time_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True), 10)
    if dt == torch.float32:   # the regressor's shape, masked
        rb, rheads = smoke.FIT_BATCH, 4
        (rq, rk, rv, rdo), rpad = _masked_qkv(smoke, rng, rb, smoke.L, rheads, dt, 4)
        ro, rlse = attn.attention_forward_cuda(rq, rk, rv, rheads, rpad, stats=True)
        rwant = attn.attention_backward_plain(rq, rk, rv, ro, rdo, rlse, rheads, rpad)

        def rcheck(got):
            if attn.backward_excess(got, rwant, rtol) > atol:
                raise AssertionError("attention_bwd regressor: kernel differs from plain")

        rows[f"  attention_bwd regressor ({rb},{smoke.L},{rheads}x64) {dtype}"] = _checked(
            lambda: attn.attention_backward_cuda(rq, rk, rv, ro, rdo, rlse, rheads, rpad), rcheck,
            smoke, 10)
    return rows


def _nn1(smoke, rng, sweep):
    """The 1-NN (#8) of one 196-frame sequence against the 8192 scene
    points, on ``chip_smoke.nn1_cloud``'s clouds a (points N(0, 2^2),
    vertices N(0, 1)) and b (a body in a room), bit-equal to its plain
    version, with the share of the pairs it evaluates where the root's
    wrapper counts them. It has one launch configuration, so ``sweep`` adds
    nothing."""
    import torch

    from afford_motion_torch.ops.cuda import sdf

    dev = torch.device("cuda:0")
    rows = {}
    for kind in ("a", "b"):
        points, verts = (torch.from_numpy(x).to(dev) for x in smoke.nn1_cloud(kind, rng))
        want = sdf.nn1_plain(points, verts)
        label = f"nn1 {kind} ({points.shape[0]}, {verts.shape[0]}x{verts.shape[1]})"
        rows[label] = _checked_time(smoke, lambda: sdf.nn1_cuda(points, verts), want, 5)
        if hasattr(sdf, "nn1_launch"):
            visits = torch.zeros(1, dtype=torch.int64, device=dev)
            sdf.nn1_launch(points, verts, visits)
            pairs = points.shape[0] * verts.shape[0] * verts.shape[1]
            rows[f"  pairs evaluated {kind}, share"] = [f"{float(visits[0]) / pairs:.5f}"]
        del points, verts, want
    return rows


# the kernels the scene slice launches; the others' counts must stay 0
SCENE_COUNTED = {"fps": ("fps", "fps_cuda"), "knn": ("knn", "knn_cuda"),
                 "gather": ("gather", "gather_rows"), "nn1": ("sdf", "nn1_cuda"),
                 "attention": ("attention", "attention_cuda")}


def _scene(smoke, rng, sweep, root):
    """The scene slice of ``root``'s own ``chip_smoke.py`` (its entries and
    launch checks are the root's), from a fresh work tree; returns its
    evaluator's ``fit_s``, ``physics_s``, ``apd_s`` and ``evaluator_s``
    (one run each, in seconds). ``rng`` and ``sweep`` are not used: the
    slice makes its data from its own seed and has no configurations."""
    import importlib
    import os
    import shutil
    import types

    import torch

    spec = importlib.util.spec_from_file_location("root_chip_smoke", Path(root) / "chip_smoke.py")
    own = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(own)
    os.chdir(root)   # the entries read ./configs
    shutil.rmtree(own.WORK, ignore_errors=True)   # a fresh tree, as chip_smoke.py starts with
    counters = {}
    for name in own.PLAIN_STEP:
        module, fn = SCENE_COUNTED.get(name, (None, None))
        counters[name] = (getattr(importlib.import_module(f"afford_motion_torch.ops.cuda.{module}"),
                                  fn) if module else types.SimpleNamespace(launches=0))
    out, log = [], own.log
    own.log = lambda msg: (out.append(msg), log(msg))[1]
    own.phase_scene_slice(torch.device("cuda:0"), counters)
    words = next(m for m in out if m.startswith("scene slice: fit_s")).split()
    return {f"{k} (scene slice, s)": [float(words[words.index(k) + 1])] * 3
            for k in ("fit_s", "physics_s", "apd_s", "evaluator_s")}


KERNELS = {"knn": _knn, "gather": _gather, "banded_knn": _banded_knn,
           "banded_gather": _banded_gather, "scatter": _scatter,
           "banded_scatter": _banded_scatter, "attention_f32": _attention_f32,
           "attention_bwd": _attention_bwd, "nn1": _nn1, "scene": _scene}


def worker(root: str, kernel: str, sweep: bool, dtype: str = "bfloat16") -> dict:
    """Measure ``kernel`` of the checkout at ``root`` (``dtype``: the
    attention backward's type); returns {row label: [median, lo, hi]}."""
    smoke = _smoke()
    root = str(Path(root).resolve())
    sys.path.insert(0, root)
    from afford_motion_torch.ops.cuda import build

    assert Path(build.__file__).resolve().is_relative_to(Path(root).resolve())
    build.library()
    extra = {"attention_bwd": {"dtype": dtype}, "scene": {"root": root}}.get(kernel, {})
    return KERNELS[kernel](smoke, smoke.np.random.default_rng(smoke.SEED), sweep, **extra)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--kernel", required=True, choices=sorted(KERNELS))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"),
                    help="the attention backward's type")
    ap.add_argument("--out", default="build/profile")
    ap.add_argument("--sass", default="", help="write the SASS of the kernels whose mangled "
                    "name holds this text, from the first root's library, to DIR")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.roots[0], args.kernel, args.sweep, args.dtype)))
        return 0
    if args.sass:
        _write_sass(args.roots[0], args.sass, Path(args.out))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    clocks = [_clocks()]
    runs, code, failure = [], 0, ""
    for root in args.roots:
        proc = subprocess.run([sys.executable, __file__, "--worker", "--kernel", args.kernel,
                               "--dtype", args.dtype, root] + ["--sweep"] * args.sweep,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            code = proc.returncode
            failure = f"{root} failed:\n{proc.stdout[-4000:]}{proc.stderr[-8000:]}"
            break
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    clocks.append(_clocks())
    text = "\n".join([card, "clocks before and after: " + " | ".join(clocks)]
                     + _table(args.roots, runs, args.kernel) + ([failure] if failure else []))
    print(text)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "kernel_ab.txt").write_text(text + "\n")
    return code


def _clocks() -> str:
    """The card's SM clock, its largest, temperature and power draw now."""
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,temperature.gpu,"
                           "power.draw", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def _write_sass(root: str, pattern: str, out: Path) -> None:
    """``cuobjdump -sass`` of the kernels of ``root``'s built library whose
    name holds ``pattern``, each to ``out/sass_<name>.txt`` with a count of
    its instructions by opcode at the top."""
    import os
    import re
    import shutil

    sys.path.insert(0, root)
    from afford_motion_torch.ops.cuda import build

    lib = build.build()
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out.mkdir(parents=True, exist_ok=True)
    for block in sass.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        if pattern not in name:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", block)
        counts = {}
        for op in ops:
            counts[op.split(".")[0]] = counts.get(op.split(".")[0], 0) + 1
        head = f"{name}: {len(ops)} instructions; " + ", ".join(
            f"{op} {n}" for op, n in sorted(counts.items(), key=lambda kv: -kv[1]))
        (out / f"sass_{name[:120]}.txt").write_text(head + "\n" + block)
        print(head)


def _table(roots, runs, kernel) -> list:
    """One line a shape or configuration, one cell a run, then the kernel's
    sum over the shapes of a pass."""
    lines = [f"run {i}: {root}" for i, root in enumerate(roots[:len(runs)])]
    for label in dict.fromkeys(label for run in runs for label in run):
        cells = []
        for run in runs:
            v = run.get(label)
            cells.append("-" if v is None else (f"{v[0]:.4f} ({v[1]:.4f}-{v[2]:.4f})"
                                                if isinstance(v[0], float) else str(v)))
        lines.append(f"{label}: " + " | ".join(cells))
    if not any(label.startswith(kernel + " ") for run in runs for label in run):
        return lines
    sums = [sum(v[0] for label, v in run.items()
                if label.startswith(kernel + " ") and isinstance(v[0], float)) for run in runs]
    lines.append(f"{kernel} a pass (sum of medians): " + " | ".join(f"{s:.4f}" for s in sums))
    return lines


if __name__ == "__main__":
    sys.exit(main())
