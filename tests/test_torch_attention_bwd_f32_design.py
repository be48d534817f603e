"""A model of the f32 attention backward's tiling and summation order
(``csrc/attention.cu``, ``bwd_f32_dkv`` and ``bwd_f32_dq``), held to
``attention_backward_plain`` within ``TOLERANCE_BWD[float32]`` and to the
JAX library's Pallas backward (interpret mode, through the JAX package's
own ``_flash_attention``, as ``tests/test_torch_attention_bwd.py`` runs it).

The kernels run only on the card; ``chip_smoke.py`` holds them to the plain
version there. Here their order is written out in numpy, every product an
``fmaf`` (emulated through float64: the exact product, then one rounding
to float32 of the sum):

- di of a query row: 4 threads of 16 dimensions each, each summing its
  entries in order of d, then (s0 + s1) + (s2 + s3);
- S and dP of a (query, key) pair: one chain over d in order; P = exp2(s
  (scale log2 e) - lse log2 e) on attended keys, else 0; dS = ((dP - di) P)
  scale, each step rounded, computed once per (query tile, key tile);
- dV and dK of a key: one chain over the queries in order (the query tiles
  in order, each tile's rows in order), whatever the tile's size;
- dQ of a query: one chain over the keys in order, key tiles of 64 with no
  attended key left out, up to the last attended key (rounded up to 4).

So every gradient element has one writer and a fixed order: the result
does not depend on the order in which the blocks run, and two calls give
the same bits. Planted faults (di left
out, a key tile's dQ part dropped, masked keys attended) must break the
tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from afford_motion_tpu.models import layers as jlayers
from afford_motion_torch.ops.cuda import attention as tattn

F32, F64 = np.float32, np.float64
KEY_TILE = 64
QUERY_TILE = 32
LOG2E = F32(1.4426950408889634)


def _fma(a, b, c):
    return (a.astype(F64) * b + c).astype(F32)


def model_backward(q, k, v, o, do, lse, heads, pad, order=None, fault=None):
    """The kernels' dq, dk, dv (float32 numpy, (B, L, heads * hd)) from
    float32 numpy inputs; ``pad`` (B, Lk) bool or None. ``order``: a
    permutation of the (item, head) pairs, the order the blocks run in;
    ``fault``: "no di", "dq tile dropped" (the first key tile's dQ part),
    "no mask"."""
    b, lq, d = q.shape
    lk = k.shape[1]
    hd = d // heads
    scale = F32(hd ** -0.5)
    scale2 = scale * LOG2E

    def split(x):
        return x.reshape(b, -1, heads, hd).transpose(0, 2, 1, 3)

    qh, kh, vh, oh, gh = (split(x) for x in (q, k, v, o, do))
    keep = np.ones((b, lk), bool) if pad is None or fault == "no mask" else ~pad
    dq, dk, dv = np.zeros_like(qh), np.zeros_like(kh), np.zeros_like(vh)
    pairs = [(i, h) for i in range(b) for h in range(heads)]
    for i, h in (pairs if order is None else [pairs[n] for n in order]):
        Q, K, V, O, G = qh[i, h], kh[i, h], vh[i, h], oh[i, h], gh[i, h]
        # di: 4 partial chains of 16 dimensions (zero past hd), then pairs
        part = np.zeros((4, lq), F32)
        for c in range(4):
            for e in range(16):
                dd = 16 * c + e
                if dd < hd:
                    part[c] = _fma(O[:, dd], G[:, dd], part[c])
        di = (part[0] + part[1]) + (part[2] + part[3])
        if fault == "no di":
            di = np.zeros_like(di)
        s, dp = np.zeros((lq, lk), F32), np.zeros((lq, lk), F32)
        for dd in range(hd):
            s = _fma(Q[:, dd, None], K[None, :, dd], s)
            dp = _fma(G[:, dd, None], V[None, :, dd], dp)
        lse2 = lse[i, h] * LOG2E
        p = np.where(keep[i][None, :], np.exp2(s * scale2 - lse2[:, None]), F32(0)).astype(F32)
        ds = ((dp - di[:, None]) * p) * scale
        tiles = [(t, min(t + KEY_TILE, lk)) for t in range(0, lk, KEY_TILE)]
        attended = [bool(keep[i, a:z].any()) for a, z in tiles]
        # dK / dV: a block a key tile, over the query tiles in order
        for (a, z), live in zip(tiles, attended):
            if not live:
                continue
            for t0 in range(0, lq, QUERY_TILE):
                for r in range(t0, min(t0 + QUERY_TILE, lq)):
                    dv[i, h, a:z] = _fma(p[r, a:z, None], G[r][None, :], dv[i, h, a:z])
                    dk[i, h, a:z] = _fma(ds[r, a:z, None], Q[r][None, :], dk[i, h, a:z])
        # dQ: a block a query tile, over the attended key tiles in order
        end = int(np.nonzero(keep[i])[0].max()) + 1 if keep[i].any() else 0
        for n, ((a, z), live) in enumerate(zip(tiles, attended)):
            if not live or a >= end or (fault == "dq tile dropped" and n == 0):
                continue
            for j in range(a, min(z, a + ((end - a + 3) & ~3))):
                dq[i, h] = _fma(ds[:, j, None], K[j][None, :], dq[i, h])

    def back(x):
        return x.transpose(0, 2, 1, 3).reshape(b, -1, d)

    return back(dq), back(dk), back(dv)


def _case(name, seed=17):
    """The train step's attention cut to one item and 2 heads (326 tokens:
    time, text, 128 contact, 196 motion frames whose padding is masked), and
    off the path at head dimensions 8, 40 and 64 with 70 queries and 150 or
    133 keys: one item with every key, one with a masked tile of 64 keys
    between attended ones, one with a single attended key."""
    rng = np.random.default_rng(seed)
    if name.startswith("train"):
        b, lq, lk, heads, hd = 1, 326, 326, 2, 64
        frames = np.arange(196)[None, :] >= np.array([[150]])
        pad = np.concatenate([np.zeros((b, lk - 196), bool), frames], 1)
        if name.endswith("no mask"):
            pad = None
    else:
        hd = int(name[3:])
        b, lq, lk, heads = 3, 70, 133 if hd == 64 else 150, 2
        pad = np.arange(lk)[None, :] >= np.array([[lk], [lk - 50], [1]])
        pad[:2, 64:128] = True
    q, do = (rng.normal(size=(b, lq, heads * hd)).astype(F32) for _ in range(2))
    k, v = (rng.normal(size=(b, lk, heads * hd)).astype(F32) for _ in range(2))
    return q, k, v, do, heads, pad


def _plain(q, k, v, do, heads, pad):
    """The forward's o and lse and the plain backward, in torch on the CPU."""
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tpad = None if pad is None else torch.from_numpy(pad)
    o = tattn.attention_plain(tq, tk, tv, heads, tpad)
    lse = tattn.attention_lse_plain(tq, tk, heads, tpad)
    want = tattn.attention_backward_plain(tq, tk, tv, o, tdo, lse, heads, tpad)
    return o.numpy(), lse.numpy(), want


def _need(got, want):
    atol, rtol = tattn.TOLERANCE_BWD[torch.float32]
    return tattn.backward_excess([torch.from_numpy(g) for g in got], want, rtol) / atol


CASES = ["train", "train no mask", "hd=8", "hd=40", "hd=64"]


@pytest.mark.parametrize("case", CASES)
def test_model_within_tolerance_of_plain(case):
    q, k, v, do, heads, pad = _case(case)
    o, lse, want = _plain(q, k, v, do, heads, pad)
    got = model_backward(q, k, v, o, do, lse, heads, pad)
    assert _need(got, want) <= 0.5, _need(got, want)
    if pad is not None:
        assert not any(np.abs(g[pad]).any() for g in got[1:])   # masked keys: zero rows


@pytest.mark.parametrize("case", ["hd=40", "hd=64"])
def test_model_matches_the_jax_library_backward(case):
    """The library's Pallas forward and backward (interpret mode) through the
    JAX package's ``_flash_attention``, at 1e-5 of each gradient's largest
    entry, as tests/test_torch_attention_bwd.py holds the plain version."""
    import jax

    q, k, v, do, heads, pad = _case(case, seed=23)
    o, lse, _ = _plain(q, k, v, do, heads, pad)
    got = model_backward(q, k, v, o, do, lse, heads, pad)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a, b, c: jlayers._flash_attention(a, b, c, heads,
                                                                  jnp.asarray(pad)), jq, jk, jv)
        want = [np.asarray(x) for x in vjp(jdo)]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        excess = np.abs(g.astype(F64) - w) - 1e-5 * np.abs(w).max()
        assert (excess <= 0).all(), f"{name}: {excess.max():.3e} beyond 1e-5 of the largest entry"


def test_same_bits_in_any_block_order():
    """Every element's sum has a fixed order: the blocks' order leaves the
    bits alone, and so do two calls."""
    q, k, v, do, heads, pad = _case("hd=40")
    o, lse, _ = _plain(q, k, v, do, heads, pad)
    first = model_backward(q, k, v, o, do, lse, heads, pad)
    runs = [model_backward(q, k, v, o, do, lse, heads, pad),
            model_backward(q, k, v, o, do, lse, heads, pad,
                           order=np.random.default_rng(3).permutation(3 * heads))]
    for run in runs:
        for g, w in zip(run, first):
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))


@pytest.mark.parametrize("fault,case", [("no di", "hd=64"), ("dq tile dropped", "hd=40"),
                                        ("no mask", "hd=8"), ("no di", "train")])
def test_a_planted_fault_breaks_the_tolerance(fault, case):
    q, k, v, do, heads, pad = _case(case)
    o, lse, want = _plain(q, k, v, do, heads, pad)
    assert _need(model_backward(q, k, v, o, do, lse, heads, pad, fault=fault), want) > 4
