"""Emulations of the order in which the two scatter-add kernels sum, held bit
for bit to their plain versions and to the JAX package's Pallas backward.

The kernels (``csrc/scatter.cu`` #4, ``csrc/banded_scatter.cu`` #7, both
built on ``csrc/ordered_scatter.cuh``) run only on the card;
``chip_smoke.py`` holds them to their plain versions there. Here their
design is written out in numpy, step for step where a step decides the
order of a sum:

- (1)-(3) the kept positions (all of them for #4; for #7 those whose index
  lies in their tile's window) grouped by their destination's range of 128
  rows: per-chunk counts, a scan, range-major, and a placement by warps over
  contiguous parts of each chunk, 32 positions a step;
- (4) per range, the same again by destination: per-warp counts, a scan,
  a stable placement (the rank a ``__match_any_sync`` gives), one list a
  destination;
- (5) each destination's list summed in order from zero; for #7 a tile
  partial folded into the total when the tile changes.

Every add is a float32 add of numpy arrays, so an emulation computes the
kernel's bits. Planted faults (two tiles folded out of order, a position
dropped, a partial not reset at a tile change, an unstable grouping, the
adds of a few rows in the order their loads might arrive) must break
the equality with the plain version.

The bars against the JAX side are those of ``tests/test_torch_gather_vjp.py``
(#4: bit for bit) and ``tests/test_torch_banded.py`` (#7: its fold is a
one-hot product, which fixes no order of its own, so bit for bit on
gradients of the 2^-6 grid, where every partial sum is exact, and within
4 * 2^-23 * sum |g| per entry on normal draws).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afford_motion_tpu.ops.pallas import banded as jb
from afford_motion_tpu.ops.pallas.gather import gather_rows as jax_gather_rows
from afford_motion_torch.ops.cuda import banded as tb
from afford_motion_torch.ops.cuda.gather import (
    scatter_add_rows,
    scatter_add_rows_plain,
    scatter_config,
)

TQ = tb.TQ
WARPS = 8        # warps a block of the grouping and listing kernels
CHUNK = 1024     # positions a block of the grouping kernels
RANGE = 128      # destinations a range


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(view), b.view(view))


def _to(out32: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """The kernels' one rounding at the end (bfloat16: to nearest even)."""
    return torch.from_numpy(out32).to(dtype)


def _sum_list(rows, positions, tp, tiles, fault=None):
    """row_walk.cuh ``sum_list``: one destination's rows in list order, from
    zero; with ``tiles`` a partial a tile, folded into the total in order."""
    zero = np.zeros(rows.shape[1], np.float32)
    total, part, tile_end = zero, zero, 0
    if fault == "arrival order":   # adds in the order loads of 4 might arrive
        positions = [p for i in range(0, len(positions), 4) for p in positions[i:i + 4][::-1]]
    for p in positions:
        if tiles and p >= tile_end:
            total = total + part
            if fault != "no reset":
                part = zero
            tile_end = (p // tp + 1) * tp
        part = part + rows[p]
    return total + part if tiles else part


def _stable_by_key(items, keys, nkeys, offsets, fault=None):
    """place_stable over warps on contiguous parts of ``items``: each warp's
    items counted by key, offsets per (warp, key) from ``offsets`` (the
    keys' starts), then placed 32 a step, the rank within a step that of a
    ``__match_any_sync`` -> {slot: item}."""
    L = len(items)
    parts = [(L * w // WARPS, L * (w + 1) // WARPS) for w in range(WARPS)]
    cnt = np.zeros((WARPS, nkeys), np.int64)
    for w, (lo, hi) in enumerate(parts):
        np.add.at(cnt[w], keys[lo:hi], 1)
    offs = offsets[None, :] + np.cumsum(cnt, axis=0) - cnt
    out = {}
    for w, (lo, hi) in enumerate(parts):
        for i0 in range(lo, hi, 32):
            rank = {}
            for i in range(i0, min(i0 + 32, hi)):
                k = int(keys[i])
                out[int(offs[w, k] + rank.get(k, 0))] = items[i]
                rank[k] = rank.get(k, 0) + 1
            for k, r in rank.items():
                offs[w, k] += r
    if fault == "unstable":     # a range's positions out of order
        slots = sorted(out)
        out = dict(zip(slots, [out[s] for s in slots][::-1]))
    return out


def _emulate(rows_all, flat, kept, n, tp, tiles, fault=None):
    """ordered_scatter.cuh for one cloud: rows (P, C) float32, indices (P,),
    the kept mask (P,) -> (n, C) float32."""
    P = len(flat)
    ranges, chunks = -(-n // RANGE), -(-P // CHUNK)
    # (1) counts[range, chunk]; (2) their scan, range-major
    counts = np.zeros((ranges, chunks), np.int64)
    for c0 in range(0, P, CHUNK):
        sel = kept[c0:c0 + CHUNK]
        np.add.at(counts[:, c0 // CHUNK], flat[c0:c0 + CHUNK][sel] // RANGE, 1)
    start = (np.cumsum(counts.reshape(-1)) - counts.reshape(-1)).reshape(counts.shape)
    # (3) each chunk's kept positions into their range's part
    grouped = np.zeros(int(counts.sum()), np.int64)
    for c0 in range(0, P, CHUNK):
        pos = np.arange(c0, min(c0 + CHUNK, P))[kept[c0:c0 + CHUNK]]
        # a warp's part of the chunk: contiguous positions, kept or not
        ln = min(CHUNK, P - c0)
        for w in range(WARPS):
            part = pos[(pos >= c0 + ln * w // WARPS) & (pos < c0 + ln * (w + 1) // WARPS)]
            for q in part:
                r = flat[q] // RANGE
                grouped[start[r, c0 // CHUNK]] = q
                start[r, c0 // CHUNK] += 1
    bounds = np.concatenate([np.cumsum(counts.sum(1)) - counts.sum(1), [len(grouped)]])
    out = np.zeros((n, rows_all.shape[1]), np.float32)
    for r in range(ranges):
        # (4) the range's part into one list a destination
        part = list(grouped[bounds[r]:bounds[r + 1]])
        dests = np.array([flat[q] - r * RANGE for q in part], np.int64)
        per_dest = np.bincount(dests, minlength=RANGE) if len(part) else np.zeros(RANGE, int)
        firsts = np.cumsum(per_dest) - per_dest
        placed = _stable_by_key(part, dests, RANGE, firsts, fault)
        lists = [placed[s] for s in range(len(part))]
        if fault == "drop" and lists:
            lists = lists[:-1]
        # (5) each destination's sum
        for d in range(min(RANGE, n - r * RANGE)):
            out[r * RANGE + d] = _sum_list(rows_all, lists[firsts[d]:firsts[d] + per_dest[d]],
                                           tp, tiles, fault)
    return out


def emulate_banded(g, idx, starts, n, s, *, fault=None):
    """csrc/banded_scatter.cu, step for step: (B, M, K, C) g, (B, M, K) idx,
    (G,) | (B, G) starts -> (B, n, C) in g's type."""
    B, M, K, C = g.shape
    G, tp = M // TQ, TQ * K
    rows_all = g.reshape(B, M * K, C).float().numpy()
    flat = idx.reshape(B, M * K).numpy().astype(np.int64)
    st = np.broadcast_to(np.atleast_2d(starts.numpy()), (B, G)).astype(np.int64)
    out = np.zeros((B, n, C), np.float32)
    for b in range(B):
        tile = np.arange(M * K) // tp
        rel = flat[b] - st[b, tile]
        kept = (rel >= 0) & (rel < s)
        if fault == "tile order":   # the tiles' positions taken last tile first
            order = np.argsort(-tile, kind="stable")
            rows = rows_all[b][order]
            out[b] = _emulate(rows, flat[b][order], kept[order], n, tp, True)
            continue
        out[b] = _emulate(rows_all[b], flat[b], kept, n, tp, True, fault)
    return _to(out, g.dtype)


def emulate_plain(g, idx, n, *, fault=None):
    """csrc/scatter.cu, step for step: (B, M, K, C) g, (B, M, K) idx ->
    (B, n, C) in g's type."""
    B, M, K, C = g.shape
    rows_all = g.reshape(B, M * K, C).float().numpy()
    flat = idx.reshape(B, M * K).numpy().astype(np.int64)
    out = np.stack([_emulate(rows_all[b], flat[b], np.ones(M * K, bool), n, 1, False, fault)
                    for b in range(B)])
    return _to(out, g.dtype)


# ------------------------------------------------------------------ cases
def _draw(shape, kind, rng):
    if kind == "grid":   # integers x 2^-6: every partial sum exact in any order
        return (rng.integers(-8, 9, size=shape) / 64.0).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


def _banded_case(case, seed=5):
    """(n, idx (B, M, K) int32, starts tensor, s, C) for B = 2, M = 512,
    n = 1024 (S = 512, four tiles); indices drawn inside their tile's
    window unless the case says otherwise."""
    rng = np.random.default_rng(seed)
    B, M, K, n = 2, 512, 8, 1024
    G = M // TQ
    s = tb.window_starts(M, n, tb.window_width(n))[1]
    C = {"c1": 1, "c67": 67}.get(case, 7)
    if case in ("rank2", "non-monotone", "hub"):
        st = rng.integers(0, (n - s) // 128 + 1, size=(B, G)) * 128
        if case == "non-monotone":
            st[:, :] = np.array([512, 0, 384, 128])[None, :G]
        if case == "hub":
            st[:, :3] = 0    # three tiles share the window [0, 512)
    else:
        st = np.asarray(tb.window_starts(M, n, tb.window_width(n))[0])[None, :].repeat(B, 0)
    rel = rng.integers(0, s, size=(B, M, K))
    idx = np.repeat(st, TQ, axis=1)[:, :, None] + rel
    if case == "outside":
        move = rng.random(idx.shape) < 0.1
        idx = np.where(move, rng.integers(0, n, size=idx.shape), idx)
    if case == "hub":
        # destination 400 hit by 160 positions of each of tiles 0, 1 and 2
        for t in range(3):
            rows = t * TQ + rng.choice(TQ, size=80, replace=False)
            idx[:, rows, :2] = 400
    if case == "untouched":
        idx = st[:, :1, None] * 0 + rng.integers(0, 100, size=(B, M, K))   # rows >= 100 untouched
        st = np.zeros_like(st)
    starts = torch.from_numpy(st[0] if case in ("window", "outside", "c1", "c67") else st)
    return n, torch.from_numpy(idx.astype(np.int32)), starts.to(torch.int32).contiguous(), s, C


BANDED_CASES = ["window", "outside", "rank2", "non-monotone", "hub", "untouched", "c1", "c67"]
FAULTS = {"tile order": "two tiles folded out of order", "drop": "one position dropped",
          "no reset": "a partial not reset at a tile change"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BANDED_CASES)
def test_banded_emulation_is_plain_bit_for_bit(case, dtype):
    n, idx, starts, s, C = _banded_case(case)
    g = torch.from_numpy(_draw(tuple(idx.shape) + (C,), "normal", np.random.default_rng(1)))
    g = g.to(dtype)
    want = tb.scatter_banded_plain(g, idx, starts, n, s)
    got = emulate_banded(g, idx, starts, n, s)
    assert _same_bits(got, want)
    if case == "untouched":
        assert not got[:, 100:].any()


@pytest.mark.parametrize("draw", ["grid-float32", "grid-bfloat16", "normal-float32"])
@pytest.mark.parametrize("case", ["outside", "rank2", "non-monotone", "hub"])
def test_banded_emulation_matches_pallas_vjp(case, draw, monkeypatch):
    monkeypatch.delenv("AM_BANDED_DEBUG", raising=False)
    n, idx, starts, s, C = _banded_case(case)
    kind, dtype = draw.split("-")
    g = _draw(tuple(idx.shape) + (C,), kind, np.random.default_rng(2))
    jg = jnp.asarray(g).astype(getattr(jnp, dtype))
    x0 = jnp.zeros((idx.shape[0], n, C), jg.dtype)
    jst = jnp.asarray(starts.numpy())
    want = np.asarray(jax.vjp(lambda xx: jb.gather_banded(xx, jnp.asarray(idx.numpy()), jst),
                              x0)[1](jg)[0].astype(jnp.float32), np.float64)
    got = emulate_banded(torch.from_numpy(g).to(getattr(torch, dtype)), idx, starts, n, s)
    got = got.double().numpy()
    if kind == "grid":
        np.testing.assert_array_equal(got, want)
    else:
        B, M, K = idx.shape
        st = np.broadcast_to(np.atleast_2d(starts.numpy()), (B, M // TQ))
        mag = np.zeros((B, n, C))
        for b in range(B):
            rel = idx[b].numpy() - np.repeat(st[b], TQ)[:, None]
            keep = (rel >= 0) & (rel < s)
            np.add.at(mag[b], idx[b].numpy()[keep], np.abs(g[b][keep].astype(np.float64)))
        assert (np.abs(got - want) <= 4 * 2.0 ** -23 * mag + 1e-30).all()


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_banded_emulation_faults_break_it(fault):
    """A hub destination fed by three tiles and no exact sums: each planted
    fault changes some bits."""
    n, idx, starts, s, C = _banded_case("hub")
    g = torch.from_numpy(_draw(tuple(idx.shape) + (C,), "normal", np.random.default_rng(3)))
    want = tb.scatter_banded_plain(g, idx, starts, n, s)
    assert _same_bits(emulate_banded(g, idx, starts, n, s), want)
    assert not _same_bits(emulate_banded(g, idx, starts, n, s, fault=fault), want), FAULTS[fault]


PLAIN_CASES = [  # (B, N, C, M, K, index range)
    pytest.param(2, 64, 35, 32, 8, 64, id="k8-c35"),
    pytest.param(2, 96, 67, 24, 16, 96, id="k16-c67"),
    pytest.param(3, 40, 1, 40, 3, 40, id="k3-c1"),
    pytest.param(1, 50, 7, 128, 16, 7, id="hub"),
    pytest.param(2, 64, 35, 16, 8, 20, id="untouched-rows"),
]


def _plain_inputs(B, N, C, M, K, hi, kind="normal", seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, hi, size=(B, M, K)).astype(np.int32)
    return _draw((B, M, K, C), kind, rng), idx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, N, C, M, K, hi", PLAIN_CASES)
def test_plain_emulation_is_plain_and_pallas_bit_for_bit(B, N, C, M, K, hi, dtype):
    g, idx = _plain_inputs(B, N, C, M, K, hi)
    tg, tidx = torch.from_numpy(g).to(dtype), torch.from_numpy(idx)
    want = scatter_add_rows_plain(tg, tidx, N)
    got = emulate_plain(tg, tidx, N)
    assert _same_bits(got, want)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    x0 = jnp.zeros((B, N, C), jdtype)
    jvjp = jax.vjp(lambda v: jax_gather_rows(v, jnp.asarray(idx)), x0)[1]
    jwant = np.asarray(jvjp(jnp.asarray(g).astype(jdtype))[0].astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy().view(np.int32), jwant.view(np.int32))
    if hi < N:
        assert not got[:, hi:].any()


@pytest.mark.parametrize("fault", ["unstable", "drop", "arrival order"])
def test_plain_emulation_faults_break_it(fault):
    g, idx = _plain_inputs(1, 50, 7, 128, 16, 7, seed=4)
    tg, tidx = torch.from_numpy(g), torch.from_numpy(idx)
    want = scatter_add_rows_plain(tg, tidx, 50)
    assert _same_bits(emulate_plain(tg, tidx, 50), want)
    assert not _same_bits(emulate_plain(tg, tidx, 50, fault=fault), want)


# the row gathers of one SceneMap encoder at batch 32: (m, n, c, k)
SCENEMAP_CALLS = [(8192, 8192, 67, 8), (2048, 8192, 35, 16), (2048, 2048, 131, 16),
                  (512, 2048, 67, 16), (512, 512, 259, 16), (128, 512, 131, 16),
                  (128, 128, 515, 16)]


def test_launch_configs_at_the_scenemap_shapes():
    """The sums take a row's channels in passes of equal width, at most 128
    (C = 131: two of 66), four channels a lane and the compiler's registers
    for the row gather's scatter; passes of at most 96, each lane taking the
    fewest channels a pass needs, and the 32-register budget for the banded
    one (the sweep's choices on an H100)."""
    for m, n, c, k in SCENEMAP_CALLS:
        passes, wide, budget = scatter_config(c)
        assert passes == -(-c // 128) and -(-c // passes) <= 32 * wide and (wide, budget) == (4, 0)
        passes, wide, budget = tb.scatter_config(c, banded=True)
        width = -(-c // passes)
        assert passes == -(-c // 96) and 32 * (wide - 1) < width <= 32 * wide and budget == 1
    assert scatter_config(131) == (2, 4, 0) and scatter_config(35) == (1, 4, 0)
    assert tb.scatter_config(515, banded=True) == (6, 3, 1)
    assert tb.scatter_config(35, banded=True) == (1, 2, 1)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    n, idx, starts, s, C = _banded_case("rank2")
    g = torch.randn(tuple(idx.shape) + (C,))
    before = tb.scatter_banded.launches
    assert torch.equal(tb.scatter_banded(g, idx, starts, n, s),
                       tb.scatter_banded_plain(g, idx, starts, n, s))
    assert tb.scatter_banded.launches == before
    before = scatter_add_rows.launches
    assert torch.equal(scatter_add_rows(g, idx, n), scatter_add_rows_plain(g, idx, n))
    assert scatter_add_rows.launches == before
