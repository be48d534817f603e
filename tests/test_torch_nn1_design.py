"""A model of the exact 1-NN kernel's order (``csrc/nn1.cu``), held bit for
bit to ``nn1_plain`` and to the JAX package's Pallas ``nn1_pallas``
(interpret mode on the CPU, as ``tests/test_torch_sdf.py`` runs it).

The kernel runs only on the card; ``chip_smoke.py`` holds it to its plain
version there. Here its design is written out in numpy, step for step:

- every frame's vertices, and the scene points once, are sorted by cell of
  a 16^3 grid over their own bounding box, the cells numbered along a
  Morton curve (the order within a cell is whatever the kernel's atomics
  give: the model takes any);
- the sorted vertices are cut into groups of 32 with a box each, and boxes
  of 8 groups; a warp is 32 consecutive sorted points;
- a warp first visits the group whose box is nearest its lane 16's point,
  then walks the boxes of 8 groups outward from the one holding it, each
  group in order, and skips a box when, for every lane, its bound (d2's
  formula on the gaps, every step rounded) is strictly above the lane's
  best;
- in a visited group a lane takes a vertex when d < best, or d == best and
  its index is smaller than the best's.

Distances in float32, each step rounded, as in ``nn1_plain``. The JAX side
is compared on clouds on a 2^-8 grid, where its interpret-mode sums (which
XLA:CPU contracts into FMAs) are exact. Planted faults must break the
equality on the faces cloud of ``chip_smoke.nn1_faces_cloud`` (every
group's vertices on its box, ties across mirror images, coordinates whose
squares round): a box skipped where its bound equals the best (``>=``), a
strict ``<`` update without the index tie-break, and a bound formed with
FMAs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from afford_motion_tpu.ops.pallas import sdf as jsdf
from afford_motion_torch.ops.cuda import sdf as tsdf

CELLS, GROUP, SUPER, THREADS, PART_CAP = 16, 32, 8, 1024, 12288
F32 = np.float32
BIG = np.iinfo(np.int32).max


def _spread3(v):
    v = v & 0xF
    v = (v | (v << 4)) & 0x0C3
    return (v | (v << 2)) & 0x249


def cell_order(p, rng=None):
    """Positions of ``p`` (n, 3) f32 sorted by Morton cell of its own
    bounding box; ``rng`` shuffles the order within each cell."""
    lo, hi = p.min(0), p.max(0)
    scale = np.where(hi > lo, F32(CELLS) / np.where(hi > lo, hi - lo, F32(1)), F32(0))
    c = np.minimum(np.maximum((p - lo) * scale, F32(0)), F32(CELLS - 1)).astype(np.int64)
    code = _spread3(c[:, 0]) | (_spread3(c[:, 1]) << 1) | (_spread3(c[:, 2]) << 2)
    tie = np.zeros(len(p)) if rng is None else rng.permutation(len(p))
    return np.lexsort((tie, code))


def _fma(a, b, c):
    """float32 fma(a, b, c): the exact product, one rounding (through float64)."""
    return (a.astype(np.float64) * b + c).astype(F32)


def box_bound(lo, hi, q, fault=None):
    """The lower bound of d2 over the box (lo, hi) (.., 3) for queries q
    (.., 3), in d2's own rounding; ``fault="fma"`` forms it with FMAs."""
    g = np.maximum(np.maximum(lo - q, q - hi), F32(0))
    if fault == "fma":
        return _fma(g[..., 2], g[..., 2], _fma(g[..., 0], g[..., 0], g[..., 1] * g[..., 1]))
    return (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]) + g[..., 2] * g[..., 2]


def dist2(q, v):
    """(32, 3) queries x (n, 3) vertices -> (32, n) d2, every step rounded."""
    d = q[:, None, :] - v[None, :, :]
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def _scan(q, gv, gi, best, besti, fault):
    """One visited group (vertices gv, original indices gi) for a warp."""
    d = dist2(q, gv)
    for t in range(len(gi)):
        take = d[:, t] < best
        if fault != "strict":
            take |= (d[:, t] == best) & (gi[t] < besti)
        best, besti = np.where(take, d[:, t], best), np.where(take, gi[t], besti)
    return best, besti


def nn1_model(points, verts_seq, fault=None, rng=None):
    """The kernel's d2 (L, O) f32 and idx (L, O) int32, and the share of
    vertex-query pairs it evaluates. ``fault``: "ge" skips a box whose bound
    equals the best, "strict" takes only d < best, "fma" forms the bounds
    with FMAs; ``rng`` shuffles the order within each cell."""
    o = len(points)
    L, H, _ = verts_seq.shape
    porder = cell_order(points, rng)
    d2 = np.zeros((L, o), F32)
    idx = np.zeros((L, o), np.int32)
    seen = 0

    def needs(lo, hi, q, best):
        b = box_bound(lo, hi, q, fault)
        return bool((b < best).any() if fault == "ge" else (b <= best).any())

    for f in range(L):
        vorder = cell_order(verts_seq[f], rng)
        vs, vi = verts_seq[f][vorder], vorder.astype(np.int64)
        for w0 in range(0, o, 32):
            pos = np.minimum(np.arange(w0, w0 + 32), o - 1)
            live = np.arange(w0, w0 + 32) < o
            q = points[porder[pos]]
            best, besti = np.full(32, np.inf, F32), np.full(32, BIG, np.int64)
            for base in range(0, H, PART_CAP):
                pv, pi = vs[base:base + PART_CAP], vi[base:base + PART_CAP]
                gs = [(g, min(g + GROUP, len(pv))) for g in range(0, len(pv), GROUP)]
                glo = np.stack([pv[a:b].min(0) for a, b in gs])
                ghi = np.stack([pv[a:b].max(0) for a, b in gs])
                supers = [(s, min(s + SUPER, len(gs))) for s in range(0, len(gs), SUPER)]
                slo = np.stack([glo[a:b].min(0) for a, b in supers])
                shi = np.stack([ghi[a:b].max(0) for a, b in supers])
                start = int(np.argmin(box_bound(glo, ghi, q[16][None], fault)))

                def visit(g, best, besti):
                    a, b = gs[g]
                    return (*_scan(q, pv[a:b], pi[a:b], best, besti, fault), b - a)

                if needs(glo[start], ghi[start], q, best):
                    best, besti, n = visit(start, best, besti)
                    seen += n * live.sum()
                first = start // SUPER
                for off in range(max(len(supers) - first, first + 1)):
                    for side in (0, 1):
                        s = first - off if side else first + off
                        if (side and off == 0) or s < 0 or s >= len(supers):
                            continue
                        if not needs(slo[s], shi[s], q, best):
                            continue
                        for g in range(*supers[s]):
                            if g == start or not needs(glo[g], ghi[g], q, best):
                                continue
                            best, besti, n = visit(g, best, besti)
                            seen += n * live.sum()
            d2[f, porder[pos[live]]] = best[live]
            idx[f, porder[pos[live]]] = besti[live]
    return d2, idx, seen / (L * o * H)


def _plain(points, verts):
    d2, idx = tsdf.nn1_plain(torch.from_numpy(points), torch.from_numpy(verts))
    return d2.numpy(), idx.numpy()


def _assert_equal(got, want, what):
    np.testing.assert_array_equal(got[1], want[1], err_msg=f"{what}: idx")
    np.testing.assert_array_equal(got[0].view(np.int32), want[0].view(np.int32),
                                  err_msg=f"{what}: d2 bits")


def _grid_cloud(seed, o, l, h, step=2.0 ** -8):
    """A grid of ``step`` in [-2, 2): exact distances, duplicates and ties."""
    rng = np.random.default_rng(seed)
    n = int(2 / step)
    return ((rng.integers(-n, n, size=(o, 3)) * step).astype(F32),
            (rng.integers(-n, n, size=(l, h, 3)) * step).astype(F32))


def _faces(seed, cubes=40, frames=2, o=1024):
    return chip_smoke.nn1_faces_cloud(np.random.default_rng(seed), cubes, frames, o)


@pytest.mark.parametrize("o,l,h,step", [(1024, 2, 1300, 2.0 ** -8), (384, 2, 77, 2.0 ** -8),
                                        (128, 1, 4099, 2.0 ** -8), (512, 2, 700, 0.25),
                                        (256, 3, 331, 0.25)])
def test_model_matches_plain_and_pallas_on_the_grid(o, l, h, step):
    """Bit-equal to nn1_plain and to the Pallas kernel (interpret mode),
    with a duplicate of a vertex in another group planted; the coarse grid
    gives many exact ties."""
    points, verts = _grid_cloud(o + h, o, l, h, step)
    verts[0, h - 1] = verts[0, 0]
    got = nn1_model(points, verts)
    want = _plain(points, verts)
    _assert_equal(got, want, "plain")
    jd2, jidx = jsdf.nn1_pallas(jnp.asarray(points), jnp.asarray(verts))
    _assert_equal(got, (np.asarray(jd2), np.asarray(jidx)), "pallas")
    if step == 0.25:
        d = dist2(points, verts[0])
        assert ((d == d.min(1, keepdims=True)).sum(1) > 1).mean() > 0.25  # ties exercised


@pytest.mark.parametrize("kind", ["a", "b"])
def test_model_matches_plain_on_the_timing_clouds(kind):
    """chip_smoke.py's timing clouds, cut to 1024 points, 2 frames and 2000
    vertices; the body in a room visits a small share of the pairs."""
    points, verts = chip_smoke.nn1_cloud(kind, np.random.default_rng(5), 1024, 2, 2000)
    got = nn1_model(points, verts)
    _assert_equal(got, _plain(points, verts), kind)
    assert got[2] < (0.5 if kind == "a" else 0.2), got[2]


def test_model_splits_vertices_into_parts():
    """More vertices than a block holds (12288) go in two parts, the best
    carried from one to the next."""
    points, verts = chip_smoke.nn1_cloud("b", np.random.default_rng(6), 256, 1, 13000)
    _assert_equal(nn1_model(points, verts), _plain(points, verts), "two parts")


@pytest.mark.parametrize("seed", [0, 1])
def test_model_on_the_faces_cloud_in_any_order_within_cells(seed):
    """Every group's vertices on its box's faces, exact ties across mirror
    images: bit-equal to plain whatever the order within the cells."""
    points, verts = _faces(seed)
    want = _plain(points, verts)
    _assert_equal(nn1_model(points, verts), want, "faces")
    _assert_equal(nn1_model(points, verts, rng=np.random.default_rng(seed)), want,
                  "faces, shuffled within cells")


@pytest.mark.parametrize("fault", ["ge", "strict", "fma"])
def test_a_planted_fault_breaks_the_equality(fault):
    points, verts = _faces(3, cubes=60, o=2048)
    want = _plain(points, verts)
    got = nn1_model(points, verts, fault=fault)
    assert not np.array_equal(got[1], want[1]), fault


def test_faces_cloud_groups_are_its_boxes():
    """In the faces cloud every cell of the sort holds 32 vertices, so each
    group is one box, and every vertex lies on its group's box."""
    _, verts = _faces(4)
    for v in verts:
        vs = v[cell_order(v)]
        for g in range(0, len(vs), GROUP):
            box = vs[g:g + GROUP]
            lo, hi = box.min(0), box.max(0)
            assert ((box == lo) | (box == hi)).any(1).all()
            assert (hi - lo).max() < 0.5
