"""Parity of the PyTorch port's banded (windowed) neighbourhood ops
(``afford_motion_torch.ops.cuda.banded``: the window policy and the plain
versions of its three CUDA kernels) with ``afford_motion_tpu.ops.pallas.
banded`` on the CPU, where the Pallas kernels run in interpret mode as the
JAX package's own tests run them.

- Window policy: equal integers over a grid of shapes, with and without the
  AM_BANDED_* overrides; adaptive starts equal on density-skewed clouds.
- kNN: idx bit-equal and dist equal on curve-sorted clouds of the 2^-8 grid,
  where every step of d^2 is exact (XLA:CPU contracts the interpret-mode
  kernel's sums into FMAs, see tests/test_torch_ops.py); a numpy oracle of
  the definition covers a generic cloud.
- Gather: bit-equal in f32 and bf16, out-of-window rows zero on both sides.
- Scatter (the gather's VJP): the order of the JAX side's sums is XLA's, so
  bit-equality is asked on gradients from a coarse grid (integers x 2^-6,
  every partial sum exact in any order), and on normal draws
  |got - want| <= 4 * 2^-23 * sum|g| per output entry (both sides are float32
  sums of the same terms in different orders; each is within (n-1) * 2^-24 *
  sum|g| of the true sum). A float64 oracle of the definition holds both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afford_motion_tpu.ops.pallas import banded as jb
from afford_motion_torch.ops.cuda import banded as tb
from afford_motion_torch.ops.cuda.gather import scatter_add_rows_plain
from afford_motion_torch.ops.curves import curve_order

TQ = 128


def _sorted_cloud(kind, b, n, seed, curve="hilbert"):
    rng = np.random.default_rng(seed)
    if kind == "dyadic":
        pts = (rng.integers(-512, 512, size=(b, n, 3)) / 256.0).astype(np.float32)
    elif kind == "skewed":
        # a dense cluster and a sparse halo: FPS positions are far from
        # uniform along the curve, the case adaptive starts exist for
        dense = rng.normal(size=(b, n - n // 5, 3)) * 0.2
        sparse = rng.normal(size=(b, n // 5, 3)) * 4.0 + 2.0
        pts = np.concatenate([dense, sparse], axis=1)
        pts = (np.round(pts * 256.0) / 256.0).astype(np.float32)
    else:
        pts = rng.normal(size=(b, n, 3)).astype(np.float32)
    return np.stack([p[curve_order(p, curve)] for p in pts])


def _fps_sorted(p, m):
    """Greedy FPS (start 0) then ascending sort: the hierarchy's rule."""
    idx = np.zeros(m, dtype=np.int32)
    d = np.full(len(p), np.inf, dtype=np.float32)
    last = 0
    for i in range(1, m):
        d = np.minimum(d, ((p - p[last]) ** 2).sum(1))
        last = idx[i] = int(np.argmax(d))
    return np.sort(idx)


# ------------------------------------------------------------ window policy
GRID = [(m, n, w0) for (m, n) in ((8192, 8192), (2048, 8192), (2048, 2048), (512, 2048),
                                  (512, 512), (128, 512), (128, 128), (8192, 2048),
                                  (2048, 512), (1024, 4096), (256, 1024), (384, 1536),
                                  (128, 256), (640, 640))
        for w0 in (0, 128, 256, 300, 512)]


@pytest.mark.parametrize("env", [{}, {"AM_BANDED_WINDOW": "512"}, {"AM_BANDED_WINDOW": "256",
                                                                   "AM_BANDED_ADAPTIVE": "0"},
                                 {"AM_BANDED_ADAPTIVE": "1"}],
                         ids=["no-env", "window-512", "window-256+static", "adaptive-on"])
def test_window_policy_matches_jax(monkeypatch, env):
    for name in ("AM_BANDED_WINDOW", "AM_BANDED_ADAPTIVE"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert tb.TQ == jb.TQ == TQ
    for cfg in (None, True, False):
        assert tb.resolve_adaptive(cfg) == jb.resolve_adaptive(cfg)
    for m, n, w0 in GRID:
        assert tb.resolve_window(w0) == jb.resolve_window(w0)
        assert tb.window_width(n, w0) == jb.window_width(n, w0)
        w = tb.window_width(n, w0)
        got, want = tb.window_starts(m, n, w), jb.window_starts(m, n, w)
        assert got == want and all(isinstance(v, int) for v in got[0]), (m, n, w0)
        np.testing.assert_array_equal(tb._starts_tensor(m, n, w0, "cpu").numpy(),
                                      np.asarray(jb._starts_array(1, m, n, w0)))
        for k in (3, 8, 16, 63, 64):
            assert tb.knn_supports(m, n, k) == jb.knn_supports(m, n, k)
            for c, itemsize in ((35, 2), (515, 4), (4096, 4)):
                assert (tb.gather_supports(m, n, c, k, itemsize, w0)
                        == jb.gather_supports(m, n, c, k, itemsize, w0)), (m, n, c, k, w0)


def test_window_policy_at_the_scenemap_shapes(monkeypatch):
    """The window sizes the full-width path runs with (``banded_window:
    128``), and which of its calls the predicates route where."""
    monkeypatch.delenv("AM_BANDED_WINDOW", raising=False)
    sizes = {(m, n): tb.window_starts(m, n, tb.window_width(n, 128))[1]
             for m, n in ((8192, 8192), (2048, 8192), (2048, 2048), (512, 2048), (512, 512),
                          (128, 512), (128, 128))}
    assert sizes == {(8192, 8192): 384, (2048, 8192): 768, (2048, 2048): 384, (512, 2048): 768,
                     (512, 512): 384, (128, 512): 512, (128, 128): 128}
    assert not tb.knn_supports(128, 128, 16) and tb.gather_supports(128, 128, 515, 16, 2, 128)
    assert not tb.gather_supports(8192, 8192, 900, 8, 4, 128)  # the kept 12 MiB term


@pytest.mark.parametrize("w0", [0, 256])
def test_adaptive_starts_match_jax(w0):
    pts = _sorted_cloud("skewed", 2, 2048, 3)
    fps = np.stack([_fps_sorted(p, 512) for p in pts])
    for dtype in (np.int32, np.int16):
        got = tb.adaptive_down_starts(torch.from_numpy(fps.astype(dtype)), 2048, w0)
        want = np.asarray(jb.adaptive_down_starts(jnp.asarray(fps.astype(dtype)), 2048, w0))
        assert got.dtype == torch.int32 and got.shape == (2, 4)
        np.testing.assert_array_equal(got.numpy(), want)
        got = tb.adaptive_up_starts(torch.from_numpy(fps.astype(dtype)), 2048, w0)
        want = np.asarray(jb.adaptive_up_starts(jnp.asarray(fps.astype(dtype)), 2048, w0))
        assert got.dtype == torch.int32 and got.shape == (2, 16)
        np.testing.assert_array_equal(got.numpy(), want)
    # the skew shows: the adaptive starts differ from the proportional ones
    static = tb._starts_tensor(512, 2048, w0, "cpu")
    assert (tb.adaptive_down_starts(torch.from_numpy(fps), 2048, w0) != static).any()


# ---------------------------------------------------------------------- kNN
def _knn_oracle(q, s, k, starts, size):
    """numpy statement of the banded kernel's definition, every step rounded:
    the key's low bits are the window-local column."""
    B, M, _ = q.shape
    st = np.broadcast_to(np.atleast_2d(starts), (B, M // TQ))
    idx = np.zeros((B, M, k), np.int32)
    dist = np.zeros((B, M, k), np.float32)
    for b in range(B):
        for t in range(M // TQ):
            win = s[b, st[b, t]:st[b, t] + size]
            qq = q[b, t * TQ:(t + 1) * TQ]
            d = np.zeros((TQ, size), np.float32)
            for c in range(3):
                diff = qq[:, None, c] - win[None, :, c]
                d = diff * diff if c == 0 else d + diff * diff
            keys = (d.view(np.int32) & ~tb.IDX_MASK) | np.arange(size, dtype=np.int32)
            keys = np.sort(keys, axis=-1)[:, :k]
            idx[b, t * TQ:(t + 1) * TQ] = (keys & tb.IDX_MASK) + st[b, t]
            dq = (keys & ~tb.IDX_MASK).view(np.float32)
            dist[b, t * TQ:(t + 1) * TQ] = np.sqrt(dq.astype(np.float64)).astype(np.float32)
    return idx, dist


@pytest.mark.parametrize("case", ["self-static", "down-static", "down-adaptive", "up-adaptive",
                                  "full-window"])
def test_knn_banded_plain_matches_pallas(case, monkeypatch):
    monkeypatch.delenv("AM_BANDED_WINDOW", raising=False)
    pts = _sorted_cloud("skewed" if "adaptive" in case else "dyadic", 2, 2048, 5)
    fps = np.stack([_fps_sorted(p, 512) for p in pts])
    coarse = np.stack([p[f] for p, f in zip(pts, fps)])
    starts = None
    if case == "self-static":
        q, s, k = pts, pts, 8
    elif case == "full-window":
        q, s, k = coarse[:, :128], coarse, 16
    elif case.startswith("down"):
        q, s, k = coarse, pts, 16
        if case == "down-adaptive":
            starts = tb.adaptive_down_starts(torch.from_numpy(fps), 2048)
    else:
        q, s, k = pts, coarse, 3
        starts = tb.adaptive_up_starts(torch.from_numpy(fps), 2048)
    M, N = q.shape[1], s.shape[1]
    size = tb.window_starts(M, N, tb.window_width(N))[1]
    assert (size == N) == (case == "full-window")
    got_idx, got_dist = tb.knn_banded(torch.from_numpy(q), torch.from_numpy(s), k, starts)
    want_idx, want_dist = jb.knn_banded(jnp.asarray(q), jnp.asarray(s), k,
                                        None if starts is None else jnp.asarray(starts.numpy()))
    assert got_idx.dtype == torch.int32 and got_dist.dtype == torch.float32
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_dist.numpy(), np.asarray(want_dist))
    st = tb._starts_tensor(M, N, 0, "cpu") if starts is None else starts
    o_idx, o_dist = _knn_oracle(q, s, k, st.numpy(), size)
    np.testing.assert_array_equal(got_idx.numpy(), o_idx)
    np.testing.assert_array_equal(got_dist.numpy(), o_dist)
    # every index lies in its tile's window, and the chunked plain version
    # does not depend on its chunking
    rel = got_idx.long() - tb._per_row_starts(st, 2)[:, :, None]
    assert bool(((rel >= 0) & (rel < size)).all())
    again = tb.knn_banded_plain(torch.from_numpy(q), torch.from_numpy(s), k, st, size,
                                tiles_per_chunk=3)
    assert torch.equal(again[0], got_idx) and torch.equal(again[1], got_dist)


def test_knn_banded_plain_matches_oracle_on_a_generic_cloud():
    pts = _sorted_cloud("normal", 2, 1024, 9, curve="morton")
    starts = tb._starts_tensor(1024, 1024, 0, "cpu")
    size = tb.window_starts(1024, 1024, tb.window_width(1024))[1]
    got_idx, got_dist = tb.knn_banded(torch.from_numpy(pts), torch.from_numpy(pts), 8)
    o_idx, o_dist = _knn_oracle(pts, pts, 8, starts.numpy(), size)
    np.testing.assert_array_equal(got_idx.numpy(), o_idx)
    np.testing.assert_array_equal(got_dist.numpy(), o_dist)
    # windowed, hence not the full packed kNN everywhere
    assert size < 1024


def test_knn_banded_refuses_what_it_does_not_take():
    q = torch.zeros(1, 128, 3)
    with pytest.raises(ValueError, match="unsupported shape"):
        tb.knn_banded(q, q, 16)            # n < 256
    s = torch.zeros(1, 512, 3)
    with pytest.raises(ValueError, match="starts must be"):
        tb.knn_banded(q, s, 16, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="float32"):
        tb.knn_banded(q.double(), s.double(), 16)


# ----------------------------------------------------------- gather/scatter
def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a.view(np.int32)


def _torch_bits(t):
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32).numpy()


def _gather_case(case, seed=11):
    """x-less setup: (N, idx, starts or None, size). 'window': indices from
    the banded kNN; 'outside': a tenth of them moved anywhere in the cloud;
    'adaptive': rank-2 starts; 'full': S == N and arbitrary indices."""
    rng = np.random.default_rng(seed)
    if case == "full":
        N, M, K = 256, 128, 4
        idx = rng.integers(0, N, size=(2, M, K)).astype(np.int32)
        starts = None
    else:
        N, M, K = 2048, 512, 16
        pts = _sorted_cloud("skewed", 2, N, seed)
        fps = np.stack([_fps_sorted(p, M) for p in pts])
        coarse = np.stack([p[f] for p, f in zip(pts, fps)])
        starts = tb.adaptive_down_starts(torch.from_numpy(fps), N) if case == "adaptive" else None
        idx = tb.knn_banded(torch.from_numpy(coarse), torch.from_numpy(pts), K, starts)[0].numpy()
        if case == "outside":
            move = rng.random(idx.shape) < 0.1
            idx = np.where(move, rng.integers(0, N, size=idx.shape), idx).astype(np.int32)
    size = tb.window_starts(M, N, tb.window_width(N))[1]
    return N, idx, starts, size


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["window", "outside", "adaptive", "full"])
def test_gather_banded_forward_bit_equal(case, dtype, monkeypatch):
    monkeypatch.delenv("AM_BANDED_DEBUG", raising=False)
    N, idx, starts, size = _gather_case(case)
    x = np.random.default_rng(1).normal(size=(2, N, 12)).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    got = tb.gather_banded(tx, torch.from_numpy(idx), starts)
    want = jb.gather_banded(jx, jnp.asarray(idx),
                            None if starts is None else jnp.asarray(starts.numpy()))
    assert got.dtype == tx.dtype and got.shape == (2,) + idx.shape[1:] + (12,)
    np.testing.assert_array_equal(_torch_bits(got), _bits(want))
    st = tb._starts_tensor(idx.shape[1], N, 0, "cpu") if starts is None else starts
    rel = torch.from_numpy(idx).long() - tb._per_row_starts(st, 2)[:, :, None]
    inside = ((rel >= 0) & (rel < size)).numpy()
    assert inside.all() == (case != "outside")
    # inside the window the plain take, outside zero rows
    take = tx[torch.arange(2)[:, None, None], torch.from_numpy(idx).long()]
    assert torch.equal(got[torch.from_numpy(inside)], take[torch.from_numpy(inside)])
    assert not got[torch.from_numpy(~inside)].any()


def _scatter_oracle(g, idx, starts, n, size):
    """float64 statement of the definition; also the sum of magnitudes."""
    B, M, K, C = g.shape
    st = np.broadcast_to(np.atleast_2d(starts), (B, M // TQ))
    out = np.zeros((B, n, C), np.float64)
    mag = np.zeros((B, n, C), np.float64)
    for b in range(B):
        rel = idx[b] - np.repeat(st[b], TQ)[:, None]
        keep = (rel >= 0) & (rel < size)
        np.add.at(out[b], idx[b][keep], g[b][keep].astype(np.float64))
        np.add.at(mag[b], idx[b][keep], np.abs(g[b][keep].astype(np.float64)))
    return out, mag


@pytest.mark.parametrize("draw", ["grid-float32", "grid-bfloat16", "normal-float32"])
@pytest.mark.parametrize("case", ["window", "outside", "adaptive", "full"])
def test_scatter_banded_matches_pallas_vjp(case, draw, monkeypatch):
    monkeypatch.delenv("AM_BANDED_DEBUG", raising=False)
    N, idx, starts, size = _gather_case(case)
    kind, dtype = draw.split("-")
    rng = np.random.default_rng(2)
    shape = (2,) + idx.shape[1:] + (7,)
    g = (rng.integers(-8, 9, size=shape) / 64.0 if kind == "grid"
         else rng.normal(size=shape)).astype(np.float32)
    tg = torch.from_numpy(g).to(getattr(torch, dtype))
    jg = jnp.asarray(g).astype(getattr(jnp, dtype))
    jstarts = None if starts is None else jnp.asarray(starts.numpy())
    x0 = jnp.zeros((2, N, 7), jg.dtype)
    want = jax.vjp(lambda xx: jb.gather_banded(xx, jnp.asarray(idx), jstarts), x0)[1](jg)[0]
    st = tb._starts_tensor(idx.shape[1], N, 0, "cpu") if starts is None else starts
    got = tb.scatter_banded(tg, torch.from_numpy(idx), st, N, size)
    assert got.dtype == tg.dtype and got.shape == (2, N, 7)
    oracle, mag = _scatter_oracle(g, idx, st.numpy(), N, size)
    if kind == "grid":
        np.testing.assert_array_equal(_torch_bits(got), _bits(want))
        np.testing.assert_array_equal(got.double().numpy(), oracle)
    else:
        tol = 4 * 2.0 ** -23 * mag + 1e-30
        assert (np.abs(got.double().numpy() - np.asarray(want, np.float64)) <= tol).all()
        assert (np.abs(got.double().numpy() - oracle) <= tol).all()
    if case == "outside":
        # contributions were dropped: the flat scatter of the same table differs
        flat = scatter_add_rows_plain(tg, torch.from_numpy(idx), N)
        assert not torch.equal(flat, got)


def test_scatter_banded_order_is_per_tile_then_over_tiles():
    """One destination fed from two tiles with values whose float32 sum
    depends on the association: (a + b) + (c + d), not ((a + b) + c) + d."""
    M, K, N = 256, 1, 256
    idx = torch.zeros((1, M, K), dtype=torch.int32)
    idx[0, :, 0] = torch.arange(M) % 250 + 3
    idx[0, [0, 1, 128, 129], 0] = 7
    g = torch.zeros((1, M, K, 1))
    a, b, c, d = 1.0, 2.0 ** -24, 2.0 ** -24, 2.0 ** -24
    g[0, 0, 0, 0], g[0, 1, 0, 0], g[0, 128, 0, 0], g[0, 129, 0, 0] = a, b, c, d
    starts = torch.zeros(2, dtype=torch.int32)
    got = tb.scatter_banded(g, idx, starts, N, 256)[0, 7, 0].item()
    f = np.float32
    two_level = f(f(a) + f(b)) + f(f(c) + f(d))
    flat = f(f(f(f(a) + f(b)) + f(c)) + f(d))
    assert two_level != flat and got == two_level
    assert scatter_add_rows_plain(g, idx, N)[0, 7, 0].item() == flat


def test_gather_banded_gradcheck_float64():
    N, idx, starts, _ = _gather_case("outside", seed=4)
    x = torch.randn(2, N, 3, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda xx: tb.gather_banded(xx, torch.from_numpy(idx[:, :128]).contiguous(), None),
        (x,), nondet_tol=0.0, fast_mode=True)
    N, idx, starts, _ = _gather_case("adaptive", seed=4)
    assert torch.autograd.gradcheck(
        lambda xx: tb.gather_banded(xx, torch.from_numpy(idx), starts), (x,), fast_mode=True)


def test_gather_banded_backward_is_the_banded_scatter():
    N, idx, starts, size = _gather_case("adaptive")
    x = torch.randn(2, N, 5, requires_grad=True)
    out = tb.gather_banded(x, torch.from_numpy(idx), starts)
    g = torch.randn_like(out)
    out.backward(g)
    assert torch.equal(x.grad, tb.scatter_banded_plain(g, torch.from_numpy(idx), starts, N, size))


def test_debug_containment_check_raises(monkeypatch):
    N, idx, starts, _ = _gather_case("window")
    x = torch.randn(2, N, 4)
    monkeypatch.setenv("AM_BANDED_DEBUG", "1")
    tb.gather_banded(x, torch.from_numpy(idx))  # in-window: fine
    bad = idx.copy()
    bad[0, 0, 0] = N - 1  # row block 0's window cannot reach the last row
    with pytest.raises(AssertionError, match="outside its curve window"):
        tb.gather_banded(x, torch.from_numpy(bad))
    with pytest.raises(AssertionError):
        jb.gather_banded(jnp.asarray(x.numpy()), jnp.asarray(bad))
    monkeypatch.delenv("AM_BANDED_DEBUG")
    assert not tb.gather_banded(x, torch.from_numpy(bad))[0, 0, 0].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gather_config_at_the_scenemap_shapes(dtype):
    """The gather kernel's launch at the seven banded gathers of one SceneMap
    encoder (batch 32): a split of the 128-row tile into 1 to 16 blocks of at
    least 8 rows, the split that gives a block an SM, and the window staged
    in shared memory exactly when it fits beside the block's indices (f32
    at the 259- and 515-channel levels does not)."""
    from afford_motion_torch.ops.cuda import build

    size = torch.tensor([], dtype=dtype).element_size()
    shapes = [(8192, 8192, 67, 8), (2048, 8192, 35, 16), (2048, 2048, 131, 16),
              (512, 2048, 67, 16), (512, 512, 259, 16), (128, 512, 131, 16), (128, 128, 515, 16)]
    for m, n, c, k in shapes:
        s = tb._window(m, n, 128)
        parts, staged = tb.gather_config(32, m, c, k, s, size)
        assert parts in (1, 2, 4, 8, 16) and 128 // parts >= 8
        assert 32 * (m // tb.TQ) * parts >= build.SMS or parts == 16
        assert parts == 1 or 32 * (m // tb.TQ) * parts // 2 < build.SMS
        assert staged == (s * c * size + tb.TQ * k * 4 <= build.SMEM_BYTES)
    if dtype == torch.float32:
        assert not tb.gather_config(32, 512, 259, 16, 384, 4)[1]
        assert not tb.gather_config(32, 128, 515, 16, 128, 4)[1]
