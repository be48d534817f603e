"""A numpy model of the banded kNN kernel's selection (``csrc/banded_knn.cu``),
held exactly (idx and dist) to ``knn_banded_plain`` and, through it, to the
JAX package's Pallas ``knn_banded`` in interpret mode (the harness of
``tests/test_torch_banded.py``).

The kernel runs only on the card; ``chip_smoke.py`` holds it to its plain
version there. Here its design is written out step by step:

- the window of S rows is cut into ``groups`` parts, part p the 4-row
  groups p, p + groups, ...; a warp (32 consecutive queries) finds where
  its queries lie in the window (every lane the nearest of the rows
  32 i + 16, the warp their mean) and walks its part's groups outward from
  there, alternately above and below;
- a query compares each row's d on its bits against its threshold
  (bits(d) <= kth | 0x1FFF, the kth key's quantized distance and every
  column); a candidate's key (quantized d | window-local column) goes to the
  query's queue; when some lane of the warp (32 consecutive queries) holds
  ``KNN_CAP`` entries, the warp's queues are merged into the sorted KMAX-slot
  lists (the first KMAX - k held by INT_MIN) and the thresholds fall;
- the parts' lists are merged.

Every step of d is a float32 numpy operation, which rounds as the kernel's
``__fsub_rn`` / ``__fmul_rn`` / ``__fadd_rn`` do. Planted faults (the absolute
row in the key instead of the window-local column, a part's list dropped in
the merge, a filter on ``<`` of the quantized distance where ``<=`` is
needed) must break the equality. The clouds lie on the 2^-3 grid with
duplicate points: every d is exact, so the Pallas kernel's sums (which
XLA:CPU may contract into FMAs) agree, and many keys tie on their quantized
distance, so the column decides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afford_motion_tpu.ops.pallas import banded as jb
from afford_motion_torch.ops.cuda import banded as tb

TQ = tb.TQ
MASK = tb.IDX_MASK
I32_MAX, I32_MIN = np.int32(2 ** 31 - 1), np.int32(-2 ** 31)


def _kmax(k):
    return 8 if k <= 8 else 16 if k <= 16 else 32 if k <= 32 else 64


def _merge(lists, k):
    """The k smallest keys of sorted lists (the kernel's merge, a head of
    each list at a time: the smallest of the union, the keys being unique)."""
    return np.sort(np.concatenate(lists, axis=-1), axis=-1)[..., :k]


def _d_bits(q, p):
    """bits of d = ((qx-px)^2 + (qy-py)^2) + (qz-pz)^2, every step float32."""
    diff = q - p
    sq = diff * diff
    return ((sq[..., 0] + sq[..., 1]) + sq[..., 2]).view(np.int32)


def warp_centers(q, win, s):
    """Where each warp's 32 queries lie in the window: every lane the first
    nearest of the rows 32 i + 16, the warp the mean of those rows (rounded
    down). q (B, G, W, 32, 3), win (B, G, S, 3) -> (B, G, W)."""
    rows = np.arange(16, s, 32)
    bits = _d_bits(q[..., None, :], win[:, :, None, None, rows, :])   # (B, G, W, 32, R)
    return rows[np.argmin(bits, axis=-1)].sum(-1) // 32


def walk_rows(s, parts, p, center):
    """The first window row of each 4-row group part ``p`` of ``parts``
    visits, step by step, from ``center`` (an array of window rows, one a
    warp): the part's groups p, p + parts, ..., outward from the one nearest
    the centre, alternately above and below -> (steps, *center.shape)."""
    n4 = s // (4 * parts)
    hi = np.minimum(n4 - 1, np.maximum(0, center // 4 - p + parts // 2) // parts)
    lo = hi - 1
    out = []
    for t in range(n4):
        up = (hi < n4) & ((lo < 0) | (t % 2 == 0))
        out.append(4 * (p + parts * np.where(up, hi, lo)))
        hi, lo = hi + up, lo - ~up
    return np.stack(out)


def test_walks_cover_the_window_once():
    """Whatever the centre, the parts' walks visit every window row once,
    and a walk starts within a part's stride of its centre."""
    for s in (128, 384, 512, 768):
        for parts in (1, 2, 8, 16):
            if s % (4 * parts):
                continue
            center = np.arange(0, s, 7)
            walks = np.stack([walk_rows(s, parts, p, center) for p in range(parts)])
            rows = (walks[..., None] + np.arange(4)).transpose(2, 0, 1, 3).reshape(len(center), -1)
            assert (np.sort(rows, axis=1) == np.arange(s)).all()
            assert (np.abs(walks[:, 0] - center) <= 4 * parts + 4).all()


def test_walk_closed_form_matches_the_walk():
    """The kernel's ``PartWalk::at`` (a step's group index in closed form,
    branch-free) gives the walk above, step by step."""
    for n4 in (1, 2, 3, 6, 12, 24, 48, 96):
        for parts in (1, 2, 4, 8, 16):
            s = 4 * n4 * parts
            for p in range(parts):
                center = np.arange(0, s, 5)
                mid = np.minimum(n4 - 1, np.maximum(0, center // 4 - p + parts // 2) // parts)
                m = np.minimum(mid, n4 - mid)
                above = n4 - mid > mid
                steps = []
                for t in range(n4):
                    both = mid - (t + 1) // 2 if t % 2 else mid + t // 2
                    one = np.where(above, mid + t - m, mid - 1 - t + m)
                    steps.append(4 * (p + parts * np.where(t < 2 * m, both, one)))
                np.testing.assert_array_equal(np.stack(steps), walk_rows(s, parts, p, center))


def knn_banded_model(query, support, k, starts, s, queries, groups, fault=None):
    """The kernel's idx (B, M, k) and dist for ``starts`` (G,) or (B, G).
    A warp holds 32 consecutive queries, a thread one; the warp flushes the
    lists when some lane has a full queue. ``queries`` (a block's share of a
    tile) changes where a warp runs, not what it computes. Nor does the
    warp's vote on 4 groups of 4 rows at once: it skips rows only where no
    query has a candidate, and the rows after it go one by one as here."""
    b_, m, _ = query.shape
    g = m // TQ
    st = np.broadcast_to(np.asarray(starts).reshape(-1, g), (b_, g)).astype(np.int64)
    kmax, parts = _kmax(k), groups
    win = support[np.arange(b_)[:, None, None], st[:, :, None] + np.arange(s)]   # (B, G, S, 3)
    q = query.reshape(b_, g, TQ // 32, 32, 3)                                 # warp, lane
    center = warp_centers(q, win, s)                                          # (B, G, W)
    bi, gi = np.meshgrid(np.arange(b_), np.arange(g), indexing="ij")
    part_lists = []
    for p in range(parts):
        best = np.full(q.shape[:-1] + (kmax,), I32_MAX, np.int32)
        best[..., :kmax - k] = I32_MIN
        lim = np.full(best.shape[:-1], I32_MAX, np.int32)
        queue = np.full(best.shape[:-1] + (tb.KNN_CAP,), I32_MAX, np.int32)
        count = np.zeros(best.shape[:-1], np.int64)

        def flush(lists):
            merged = np.sort(np.concatenate([best, queue], axis=-1), axis=-1)[..., :kmax]
            best[lists] = merged[lists]
            queue[lists] = I32_MAX
            count[lists] = 0
            lim[lists] = best[lists][..., -1] | MASK

        for r0 in walk_rows(s, parts, p, center):                             # (B, G, W)
            for u in range(4):
                col = r0 + u
                rowpts = win[bi[..., None], gi[..., None], col]                # (B, G, W, 3)
                bits = _d_bits(q, rowpts[:, :, :, None, :])                    # (B, G, W, 32)
                if fault == "filter on <":
                    hit = bits < (best[..., -1] & ~MASK)
                else:
                    hit = bits <= lim
                low = (st[:, :, None] + col) & MASK if fault == "absolute row" else col
                key = (bits & ~MASK) | low[..., None]
                at = np.nonzero(hit)
                queue[at + (count[at],)] = key[at]
                count[at] += 1
                full = (count == tb.KNN_CAP).any(axis=3, keepdims=True)        # a lane of the warp
                if full.any():
                    flush(np.broadcast_to(full, count.shape))
        flush(np.ones(count.shape, bool))
        part_lists.append(best[..., kmax - k:].reshape(b_, g, TQ, k))
    if fault == "a part dropped":
        part_lists = part_lists[1:]
    keys = _merge(part_lists, k).reshape(b_, m, k)
    idx = ((keys & MASK) + np.repeat(st, TQ, axis=1)[:, :, None]).astype(np.int32)
    dist = np.sqrt((keys & ~MASK).view(np.float32).astype(np.float64)).astype(np.float32)
    return idx, dist


def _near_tie_cloud(b, n, seed):
    """A curve-sorted cloud on the 2^-3 grid with duplicate points."""
    from afford_motion_torch.ops.curves import curve_order

    rng = np.random.default_rng(seed)
    pts = (rng.integers(0, 12, size=(b, (n + 1) // 2, 3)) * 0.125).astype(np.float32)
    pts = np.concatenate([pts, pts], axis=1)[:, :n]   # every point twice
    pts = np.stack([p[rng.permutation(n)] for p in pts])
    return np.stack([p[curve_order(p, "morton")] for p in pts])


def _starts(kind, b, m, n, s, seed):
    """Rank-1 proportional starts, or rank-2 starts drawn per cloud and tile
    (multiples of 128 in [0, n - s], not monotone)."""
    if kind == "rank-1":
        return tb._starts_tensor(m, n, 128, "cpu")
    rng = np.random.default_rng(seed)
    st = rng.integers(0, (n - s) // 128 + 1, size=(b, m // TQ)) * 128
    return torch.from_numpy(st.astype(np.int32))


# (M, N, k): the windows of every KNN_CALLS shape (S = 384, 768, 512), k 8, 16
# and 63
SHAPES = [(512, 512, 8), (512, 2048, 16), (128, 512, 16), (256, 512, 63)]


@pytest.mark.parametrize("rank", ["rank-1", "rank-2"])
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_knn_banded_model_matches_plain_and_pallas(m, n, k, rank, monkeypatch):
    monkeypatch.delenv("AM_BANDED_WINDOW", raising=False)
    b = 2
    s = tb._window(m, n, 128)
    assert s in (384, 512, 768)
    support = _near_tie_cloud(b, n, seed=n + k)
    query = support[:, :: n // m] if m < n else support
    query = np.ascontiguousarray(query)
    st = _starts(rank, b, m, n, s, seed=m + k)
    want_idx, want_dist = tb.knn_banded_plain(torch.from_numpy(query), torch.from_numpy(support),
                                              k, st, s)
    pallas = jb.knn_banded(jnp.asarray(query), jnp.asarray(support), k,
                           None if rank == "rank-1" else jnp.asarray(st.numpy()))
    np.testing.assert_array_equal(want_idx.numpy(), np.asarray(pallas[0]))
    np.testing.assert_array_equal(want_dist.numpy(), np.asarray(pallas[1]))
    # every number of parts the kernel takes here (the queries a block
    # change no step of the model)
    configs = tb.knn_configs(s, k)
    assert tb.knn_config(32, m, s, k) in configs
    for groups in sorted({cfg[1] for cfg in configs}):
        idx, dist = knn_banded_model(query, support, k, st.numpy(), s, TQ, groups)
        np.testing.assert_array_equal(idx, want_idx.numpy(), err_msg=f"groups {groups}")
        np.testing.assert_array_equal(dist, want_dist.numpy(), err_msg=f"groups {groups}")


@pytest.mark.parametrize("fault,config", [("absolute row", (32, 4)), ("a part dropped", (128, 2)),
                                          ("a part dropped", (32, 8)), ("filter on <", (128, 1))])
def test_knn_banded_model_faults_break_it(fault, config):
    """Each planted fault breaks the equality (the filter's on a part that
    spans the window, where ties on the quantized distance meet the lists
    most often)."""
    b, m, n, k = 2, 512, 512, 16
    s = tb._window(m, n, 128)
    support = _near_tie_cloud(b, n, seed=4)
    st = _starts("rank-2", b, m, n, s, seed=5)
    want = tb.knn_banded_plain(torch.from_numpy(support), torch.from_numpy(support), k, st, s)
    got = knn_banded_model(support, support, k, st.numpy(), s, *config)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    bad = knn_banded_model(support, support, k, st.numpy(), s, *config, fault=fault)
    assert not np.array_equal(bad[0], want[0].numpy()), fault


@pytest.mark.parametrize("m,n,k", [(8192, 8192, 8), (2048, 8192, 16), (2048, 2048, 16),
                                   (512, 2048, 16), (512, 512, 16), (128, 512, 16),
                                   (512, 2048, 63), (256, 512, 3)])
def test_knn_banded_config_is_one_the_kernel_takes(m, n, k):
    """The wrapper's configuration at the path's shapes and off them: parts
    of a multiple of 4 rows, at most 1024 threads a block (512 for k > 16),
    a block's shared memory within the card's 227 KB."""
    s = tb._window(m, n, 128)
    assert tb.knn_config(32, m, s, k) in tb.knn_configs(s, k)


def test_knn_banded_configs_at_the_scenemap_shapes():
    """The configurations ``tools/kernel_ab.py --sweep`` chose at the path's
    shapes (``chip_smoke.KNN_CALLS`` at batch 32)."""
    got = {(m, n): tb.knn_config(32, m, tb._window(m, n, 128), k)
           for m, n, k in ((8192, 8192, 8), (2048, 8192, 16), (2048, 2048, 16),
                           (512, 2048, 16), (512, 512, 16), (128, 512, 16))}
    assert got == {(8192, 8192): (128, 1), (2048, 8192): (128, 1), (2048, 2048): (128, 1),
                   (512, 2048): (64, 4), (512, 512): (64, 4), (128, 512): (32, 8)}
