"""A numpy model of the packed kNN kernel's selection (``csrc/knn.cu``) held
against the port's plain version (``knn_plain``), on the CPU.

The kernel visits fewer than all M x N pairs and selects lazily, and the
model runs its steps in its order: each cloud's queries and support points
sorted by cell of a 16^3 grid over the support's bounding box, the cells
numbered along a Morton curve (float32 as the kernel computes them; within
a cell by index, or shuffled, as the kernel's atomics may leave them); a
warp of 32
consecutive queries visits the support's chunks of 32 outward from the
chunk where its lane 16's cell falls, two a step, and skips a chunk when, in every
lane, the box's lower bound on d (d's formula on the gaps, rounded the same
way) is above the lane's threshold; in a chunk, a pair whose d bits are at
most the k-th key with its 13 index bits set goes to its query's queue, and
when some lane of the warp has a full queue (``kCap`` entries) every lane
merges its queue into its sorted k-list (a min/max chain over KMAX slots,
the first KMAX - k held by INT_MIN) and lowers its threshold. Calls split
in parts merge the parts' k-lists afterwards. The model must give exactly
what ``knn_plain`` gives (itself held to the JAX package's ``knn_pallas`` in
``test_torch_ops.py``): on near-tie clouds on a 2^-4 grid (d exact, many
equal distances, boxes of zero width), on a support given from the farthest
point to the nearest, on duplicated points, at k 8, 16 and 64, split and
not, and at sizes that no block, part or tile of the TPU kernel divides.
Tolerance: none, the keys are integers.
"""
import numpy as np
import pytest
import torch

from afford_motion_torch.ops.cuda import knn as tknn

INT_MIN, INT_MAX = int(np.iinfo(np.int32).min), int(np.iinfo(np.int32).max)
CAP = 8           # csrc/knn.cu kCap
KMAX = (8, 16, 32, 64)


def _insert(best, key):
    """The kernel's sorted insert on (..., KMAX) lists, one key a list."""
    for j in range(best.shape[-1] - 1, 0, -1):
        best[..., j] = np.minimum(best[..., j], np.maximum(best[..., j - 1], key))
    best[..., 0] = np.minimum(best[..., 0], key)


def _new_lists(shape, kmax, k):
    best = np.full(shape + (kmax,), INT_MAX, np.int64)
    best[..., :kmax - k] = INT_MIN
    return best


def _spread3(v):
    v = v & 0xF
    v = (v | (v << 4)) & 0x0C3
    return (v | (v << 2)) & 0x249


def cells(points, lo, hi):
    """The kernel's cells: 16 an axis over [lo, hi], float32, numbered along
    a Morton curve."""
    span = np.where(hi > lo, hi - lo, np.float32(1))
    scale = np.where(hi > lo, np.float32(16) / span, np.float32(0)).astype(np.float32)
    cell = np.clip((points - lo) * scale, 0, 15).astype(np.int64)
    return _spread3(cell[:, 0]) | (_spread3(cell[:, 1]) << 1) | (_spread3(cell[:, 2]) << 2)


def _cell_order(codes, rng):
    """Indices sorted by cell; within a cell in the order ``rng`` gives (the
    kernel's counting sort places a cell's points in whatever order its
    atomics take), or by index without one."""
    tie = np.arange(len(codes)) if rng is None else rng.permutation(len(codes))
    return np.lexsort((tie, codes))


def _sq_sum(dx, dy, dz):
    return (dx * dx + dy * dy) + dz * dz


def box_bound(box_lo, box_hi, q):
    """The kernel's lower bound on d, as int32 bits, for queries ``q`` (..., 3)
    and boxes (..., 3) that broadcast against them: d's formula on the gaps
    between the query and the box, rounded as d is."""
    gap = np.maximum(np.maximum(box_lo - q, q - box_hi), np.float32(0))
    return _sq_sum(gap[..., 0], gap[..., 1], gap[..., 2]).view(np.int32)


def knn_select_model(query, support, k, threads, split, rng=None):
    """(M, 3), (N, 3) f32 -> the k smallest packed keys a query, ascending,
    (M, k) int64, by the kernel's steps; ``rng`` shuffles the order within
    each cell."""
    m, n = len(query), len(support)
    kmax = next(v for v in KMAX if v >= k)
    lo, hi = support.min(0), support.max(0)
    scodes, qcodes = cells(support, lo, hi), cells(query, lo, hi)
    sorder, qorder = _cell_order(scodes, rng), _cell_order(qcodes, rng)
    scodes, qcodes, ssorted = scodes[sorder], qcodes[qorder], support[sorder]
    part_len = n // split
    assert n % split == 0 and part_len % tknn.CHUNK == 0
    blocks = -(-m // threads)
    pos = np.arange(blocks * threads).reshape(blocks, threads // 32, 32)   # ordered positions
    q = query[qorder[np.minimum(pos, m - 1)]]                               # (block, warp, lane, 3)
    probe = qcodes[np.minimum(pos[..., 0] + 16, m - 1)]                     # (block, warp)
    parts = []
    for p in range(split):
        base, chunks = p * part_len, part_len // tknn.CHUNK
        pts, orig = ssorted[base:base + part_len], sorder[base:base + part_len]
        box_lo = pts.reshape(chunks, tknn.CHUNK, 3).min(1)
        box_hi = pts.reshape(chunks, tknn.CHUNK, 3).max(1)
        start = np.minimum(np.searchsorted(scodes[base:base + part_len], probe) // tknn.CHUNK,
                           chunks - 1)
        best = _new_lists(q.shape[:3], kmax, k)
        lim = np.full(q.shape[:3], INT_MAX, np.int64)
        queue = np.zeros(q.shape[:3] + (CAP,), np.int64)
        count = np.zeros(q.shape[:3], np.int64)

        def flush(warps):
            for i in range(CAP):
                _insert(best, np.where((i < count) & warps[..., None], queue[..., i], INT_MAX))
            count[warps] = 0
            lim[...] = best[..., -1] | tknn.IDX_MASK

        def bound(c):
            c = np.clip(c, 0, chunks - 1)
            return box_bound(box_lo[c][:, :, None], box_hi[c][:, :, None], q)

        def scan(c, visit):
            for j in range(tknn.CHUNK):
                pt = pts[c * tknn.CHUNK + j][:, :, None]                      # (block, warp, 1, 3)
                d = _sq_sum(*(q[..., a] - pt[..., a] for a in range(3)))
                bits = d.view(np.int32).astype(np.int64)
                hit = (bits <= lim) & visit[..., None]
                at = np.nonzero(hit)
                queue[at + (count[at],)] = (bits[at] & ~tknn.IDX_MASK) | orig[
                    (c * tknn.CHUNK + j)[at[:2]]]
                count[at] += 1
                full = (count == CAP).any(axis=2) & hit.any(axis=2)
                if full.any():
                    flush(full)

        # two chunks a step, outward: start + off, then start - 1 - off
        for off in range(chunks):
            sides = [start + off, start - 1 - off]
            bounds = [bound(c) for c in sides]
            for c, b in zip(sides, bounds):
                visit = (c >= 0) & (c < chunks) & (b <= lim).any(axis=2)
                if visit.any():
                    scan(np.clip(c, 0, chunks - 1), visit)
        flush(np.ones(q.shape[:2], bool))
        parts.append(best[..., kmax - k:])
    if split == 1:
        keys = parts[0]
    else:   # the merge kernel: every part's k keys into a fresh list, in order
        best = _new_lists(q.shape[:3], kmax, k)
        for part in parts:
            for j in range(k):
                _insert(best, part[..., j])
        keys = best[..., kmax - k:]
    flat, rows = pos.reshape(-1), keys.reshape(-1, k)
    out = np.zeros((m, k), np.int64)
    out[qorder[flat[flat < m]]] = rows[flat < m]
    return out


def _plain_keys(query, support, k):
    idx, dist = tknn.knn_plain(torch.from_numpy(query[None]), torch.from_numpy(support[None]), k)
    return idx[0].numpy(), dist[0].numpy()


def _key_dist(keys):
    """The kernel's dist of a key: sqrt of the key with its index bits cleared."""
    dq = (keys & ~tknn.IDX_MASK).astype(np.int32).view(np.float32)
    return np.sqrt(np.maximum(dq, 0).astype(np.float64)).astype(np.float32)


def _cloud(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "near-tie":      # 16^3 values 2^-4 apart: d exact, duplicates, equal distances
        return (rng.integers(0, 16, size=(n, 3)) * 2.0 ** -4).astype(np.float32)
    if kind == "dyadic":
        return (rng.integers(-512, 512, size=(n, 3)) / 256.0).astype(np.float32)
    if kind == "duplicates":    # every point four times
        base = (rng.integers(-512, 512, size=(-(-n // 4), 3)) / 256.0).astype(np.float32)
        return np.repeat(base, 4, axis=0)[:n]
    raise ValueError(kind)


@pytest.mark.parametrize("kind,m,n,k,threads,split", [
    ("near-tie", 256, 1024, 8, 64, 1),
    ("near-tie", 200, 1056, 16, 96, 3),       # m, n off every block, part and 128-row tile
    ("dyadic", 300, 800, 16, 64, 5),
    ("dyadic", 128, 1024, 64, 64, 2),
    ("duplicates", 160, 512, 16, 96, 1),
    ("duplicates", 96, 544, 8, 32, 17),
])
def test_knn_selection_model_matches_plain(kind, m, n, k, threads, split):
    support = _cloud(kind, n, 40 + n)
    query = _cloud(kind, m, 41 + m)
    idx, dist = _plain_keys(query, support, k)
    for rng in (None, np.random.default_rng(m)):   # any order within a cell
        keys = knn_select_model(query, support, k, threads, split, rng)
        np.testing.assert_array_equal(keys & tknn.IDX_MASK, idx)
        np.testing.assert_array_equal(_key_dist(keys), dist)


@pytest.mark.parametrize("k", [8, 16, 64])
def test_knn_selection_model_on_a_cloud_given_far_to_near(k):
    """Support points in descending distance from the queries' centre, on
    shells (many equal distances): the queries' thresholds fall only once
    the near shells are reached, wherever the scan starts."""
    rng = np.random.default_rng(7)
    query = (rng.integers(-8, 8, size=(128, 3)) / 256.0).astype(np.float32)
    support = (rng.integers(-512, 512, size=(768, 3)) / 256.0).astype(np.float32)
    support = support[np.argsort(-(support.astype(np.float64) ** 2).sum(1), kind="stable")]
    keys = knn_select_model(query, support, k, 64, 1)
    idx, _ = _plain_keys(query, support, k)
    np.testing.assert_array_equal(keys & tknn.IDX_MASK, idx)


def test_knn_box_bound_is_below_every_point_of_the_box():
    """The skip is exact and no looser than it must be: for random boxes and
    queries at three scales, the bound is at most the rounded d of every
    point in the box, compared as the kernel compares, on the bits; where the
    box's corner nearest the query is one of its points, the bound is that
    point's d, bit for bit."""
    rng = np.random.default_rng(9)
    for scale in (1.0, 1e-3, 1e3):
        pts = (rng.normal(size=(400, 32, 3)) * scale).astype(np.float32)
        q = (rng.normal(size=(400, 1, 3)) * scale * 2).astype(np.float32)
        lo, hi = pts.min(1, keepdims=True), pts.max(1, keepdims=True)
        bound = box_bound(lo, hi, q)
        d = _sq_sum(*(q[..., a] - pts[..., a] for a in range(3))).view(np.int32)
        assert (bound <= d.min(axis=1, keepdims=True)).all()
        pts[:, 0] = lo[:, 0]                     # the box's lower corner is a point
        below = (lo - np.abs(q) - np.float32(scale)).astype(np.float32)   # below it on every axis
        corner = _sq_sum(*(below[..., a] - pts[:, :1, a] for a in range(3))).view(np.int32)
        np.testing.assert_array_equal(box_bound(lo, pts.max(1, keepdims=True), below), corner)


@pytest.mark.parametrize("b,m,n,k", [(32, 8192, 8192, 8), (32, 2048, 8192, 16),
                                     (32, 2048, 2048, 16), (32, 512, 2048, 16),
                                     (32, 512, 512, 16), (32, 128, 512, 16), (32, 512, 2048, 64),
                                     (1, 256, 256, 3)])
def test_knn_launch_config_is_one_the_kernel_takes(b, m, n, k):
    """The wrapper's configurations at the path's shapes and off them: what
    ``amt_knn_packed`` accepts (a multiple of 32 threads up to 1024, 512 for
    k > 16, parts of a multiple of 32 points), a block's shared memory within the card's 227
    KB, and the model's result at that configuration on a smaller cloud
    equal to plain."""
    threads, split = tknn.launch_config(b, m, n, k)
    assert threads % 32 == 0 and 32 <= threads <= (1024 if k <= 16 else 512)
    part_len = n // split
    assert n % split == 0 and part_len % tknn.CHUNK == 0
    assert part_len * 16 + 32 * (part_len // tknn.CHUNK) + 4 * CAP * threads <= 232448
    if m * n <= 2048 * 2048:
        query, support = _cloud("dyadic", m, 5), _cloud("dyadic", n, 6)
        keys = knn_select_model(query, support, k, threads, split)
        np.testing.assert_array_equal(keys & tknn.IDX_MASK, _plain_keys(query, support, k)[0])
