"""Parity of the PyTorch port's point hierarchy
(``afford_motion_torch.ops.hierarchy``) with the JAX package's, at B=2,
N=1024, SceneMap strides (1, 4, 4, 4) and k (8, 16, 16, 16), with the 3-NN
up-interpolation on.

Index fields must be bit-equal; up_weight agrees to 5e-5 (abs), except at
parent points that are themselves coarse points (see ``_assert_same``).
(a) both sides on the exact kNN; (b) the JAX side routed through its Pallas
FPS and packed kNN in interpret mode, the port on its default route (the
plain versions of its kernels), on a cloud of the 2^-8 grid where every
step of d^2 is exact (see tests/test_torch_ops.py for why).
(c) banded hierarchies at N=2048 on curve-sorted clouds of that grid, the JAX
side with ``banded.available`` patched to true (its kernels then run in
interpret mode): levels 2048/512/128/32 take the windowed kNN (S < N), the
full-window kNN (128 over 512), and both fallbacks (n < 256, and m not a
multiple of 128), which run the exact kNN on both sides. Every index field,
``down_starts``/``up_starts`` and the ascending ``fps_idx`` must be bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afford_motion_tpu.ops import hierarchy as jh
from afford_motion_tpu.ops.pallas import banded as jbanded
from afford_motion_tpu.ops.pallas import knn as jknn
from afford_motion_tpu.ops.pallas.fps import fps_pallas
from afford_motion_torch.ops import hierarchy as th
from afford_motion_torch.ops.curves import curve_order
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

STRIDES, NSAMPLES = (1, 4, 4, 4), (8, 16, 16, 16)
INDEX_FIELDS = ("knn_idx", "fps_idx", "down_knn_idx", "up_idx")


def _cloud(kind):
    rng = np.random.default_rng(21)
    if kind == "dyadic":
        return (rng.integers(-512, 512, size=(2, 1024, 3)) / 256.0).astype(np.float32)
    return rng.normal(size=(2, 1024, 3)).astype(np.float32)


def _assert_same(jax_levels, torch_levels):
    assert len(jax_levels) == len(torch_levels)
    for li, (a, b) in enumerate(zip(jax_levels, torch_levels)):
        for field in INDEX_FIELDS:
            want, got = getattr(a, field), getattr(b, field)
            assert (want is None) == (got is None), (li, field)
            if got is not None:
                assert got.dtype == torch.int32, (li, field)
                np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"{li} {field}")
        np.testing.assert_array_equal(b.xyz.numpy(), np.asarray(a.xyz))
        assert (a.banded, a.window) == (b.banded, b.window), li
        for field in ("down_starts", "up_starts"):
            want, got = getattr(a, field), getattr(b, field)
            assert (want is None) == (got is None), (li, field)
            if got is not None:
                assert got.dtype == torch.int32, (li, field)
                np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"{li} {field}")
        if b.up_weight is not None:
            wa, wb = np.asarray(a.up_weight), b.up_weight.numpy()
            # a parent point that is itself a coarse point: the expanded-form
            # d^2 leaves a rounding residual that 1/(sqrt(d^2) + 1e-8)
            # amplifies; both sides still give that point > 0.99 of the weight
            self_match = np.maximum(wa[..., 0], wb[..., 0]) > 0.99
            assert (np.minimum(wa[..., 0], wb[..., 0])[self_match] > 0.99).all()
            np.testing.assert_allclose(wb[~self_match], wa[~self_match], rtol=0, atol=5e-5)


def test_hierarchy_exact_matches_jax():
    xyz = _cloud("random")
    want = jh.build_point_hierarchy(jnp.asarray(xyz), STRIDES, NSAMPLES, knn_method="exact")
    got = th.build_point_hierarchy(torch.from_numpy(xyz), STRIDES, NSAMPLES, knn_method="exact")
    _assert_same(want, got)


def test_hierarchy_from_fps_matches_jax():
    """FPS indices from a cache, kNN recomputed; level 2's knn_idx cached."""
    xyz = _cloud("random")
    full = jh.build_point_hierarchy(jnp.asarray(xyz), STRIDES, NSAMPLES, knn_method="exact")
    arrays = {f"geo{li}_fps_idx": lvl.fps_idx for li, lvl in enumerate(full) if li}
    arrays["geo2_knn_idx"] = full[2].knn_idx
    want = jh.build_point_hierarchy_from_fps(jnp.asarray(xyz), arrays, STRIDES, NSAMPLES,
                                             knn_method="exact")
    got = th.build_point_hierarchy_from_fps(
        torch.from_numpy(xyz), {k: torch.tensor(np.asarray(v)) for k, v in arrays.items()},
        STRIDES, NSAMPLES, knn_method="exact")
    _assert_same(want, got)


def test_geometry_from_arrays_matches_jax():
    xyz = _cloud("random")
    full = jh.build_point_hierarchy(jnp.asarray(xyz), STRIDES, NSAMPLES, knn_method="exact")
    arrays = jh.geometry_to_arrays(full)
    want = jh.geometry_from_arrays(arrays, jnp.asarray(xyz), len(STRIDES))
    got = th.geometry_from_arrays({k: torch.tensor(np.asarray(v)) for k, v in arrays.items()},
                                  torch.from_numpy(xyz), len(STRIDES))
    _assert_same(want, got)


@pytest.fixture
def jax_on_pallas(monkeypatch):
    """Route the JAX hierarchy through fps_pallas / knn_pallas (interpret
    mode on the CPU), as it runs on the TPU; the jit caches are cleared on
    both sides of the patch."""
    real_knn = jh.batched_knn

    def knn_via_pallas(query, support, k, method=None):
        if method != "exact" and jknn.supports(query.shape[1], support.shape[1], k):
            return jknn.knn_pallas(query, support, k)
        return real_knn(query, support, k, method)

    jax.clear_caches()
    monkeypatch.setattr(jh, "batched_knn", knn_via_pallas)
    monkeypatch.setattr(jh, "batched_fps", fps_pallas)
    yield
    monkeypatch.undo()
    jax.clear_caches()


def test_hierarchy_pallas_route_matches_jax(jax_on_pallas):
    xyz = _cloud("dyadic")
    want = jh.build_point_hierarchy(jnp.asarray(xyz), STRIDES, NSAMPLES)
    got = th.build_point_hierarchy(torch.from_numpy(xyz), STRIDES, NSAMPLES)
    _assert_same(want, got)
    # the packed kNN really ran and differs from exact top-k somewhere
    exact = jh.build_point_hierarchy(jnp.asarray(xyz), STRIDES, NSAMPLES, knn_method="exact")
    assert any((np.asarray(a.knn_idx) != b.knn_idx.numpy()).any() for a, b in zip(exact, got))


# ------------------------------------------------------------ (c) banded
@pytest.fixture
def jax_banded(monkeypatch):
    """``banded.available()`` true on the CPU, as the JAX package's own tests
    force it; the jit caches are cleared on both sides of the patch."""
    jax.clear_caches()
    monkeypatch.setattr(jbanded, "available", lambda: True)
    for name in ("AM_BANDED_WINDOW", "AM_BANDED_ADAPTIVE"):
        monkeypatch.delenv(name, raising=False)
    yield
    monkeypatch.undo()
    jax.clear_caches()


def _sorted_cloud():
    rng = np.random.default_rng(31)
    pts = (rng.integers(-512, 512, size=(2, 2048, 3)) / 256.0).astype(np.float32)
    pts[1, :1500] *= 0.25  # a dense part: the adaptive starts leave the proportional ones
    return np.stack([p[curve_order(p, "hilbert")] for p in pts])


def _tensors(arrays):
    return {k: torch.tensor(np.asarray(v)) for k, v in arrays.items()}


@pytest.mark.parametrize("adaptive, window", [(None, 0), (False, 0), (None, 256)],
                         ids=["adaptive", "static", "window-256"])
def test_banded_hierarchy_matches_jax(jax_banded, adaptive, window):
    xyz = _sorted_cloud()
    kw = dict(banded=True, knn_method="exact", window=window, adaptive=adaptive)
    want = jh.build_point_hierarchy(jnp.asarray(xyz), STRIDES, NSAMPLES, **kw)
    got = th.build_point_hierarchy(torch.from_numpy(xyz), STRIDES, NSAMPLES, **kw)
    _assert_same(want, got)
    assert all(lvl.banded and lvl.window == window for lvl in got)
    for lvl in got[1:]:
        assert bool((lvl.fps_idx[:, 1:] > lvl.fps_idx[:, :-1]).all())
    # the routes: windowed with adaptive starts, full window, fallbacks
    assert (got[1].down_starts is not None) == (adaptive is None)
    assert (got[1].up_starts is not None) == (adaptive is None)
    assert (got[2].down_starts is not None) == (adaptive is None) and got[2].up_starts is None
    assert got[3].down_starts is None and got[3].up_starts is None
    # the windowed kNN really ran and differs from the exact one somewhere
    exact = th.build_point_hierarchy(torch.from_numpy(xyz), STRIDES, NSAMPLES, sort_fps=True,
                                     knn_method="exact")
    assert (exact[0].knn_idx != got[0].knn_idx).any()
    for a, b in zip(exact, got):
        assert torch.equal(a.fps_idx, b.fps_idx) if a.fps_idx is not None else b.fps_idx is None


def test_banded_hierarchy_from_fps_matches_jax(jax_banded):
    """The fps wire: int16 FPS indices from the cache, every kNN field
    rebuilt banded; level 2's knn_idx cached."""
    xyz = _sorted_cloud()
    full = jh.build_point_hierarchy(jnp.asarray(xyz), STRIDES, NSAMPLES, banded=True,
                                    knn_method="exact")
    arrays = {f"geo{li}_fps_idx": np.asarray(lvl.fps_idx).astype(np.int16)
              for li, lvl in enumerate(full) if li}
    arrays["geo2_knn_idx"] = np.asarray(full[2].knn_idx)
    kw = dict(banded=True, knn_method="exact", with_up=False)
    want = jh.build_point_hierarchy_from_fps(
        jnp.asarray(xyz), {k: jnp.asarray(v) for k, v in arrays.items()}, STRIDES, NSAMPLES, **kw)
    got = th.build_point_hierarchy_from_fps(torch.from_numpy(xyz), _tensors(arrays), STRIDES,
                                            NSAMPLES, **kw)
    _assert_same(want, got)
    assert got[1].down_starts is not None and got[1].up_starts is None
    # the rebuild reproduces the hierarchy the indices came from
    for a, b in zip(full, got):
        np.testing.assert_array_equal(b.knn_idx.numpy(), np.asarray(a.knn_idx))


def test_banded_geometry_from_arrays_matches_jax(jax_banded):
    xyz = _sorted_cloud()
    full = jh.build_point_hierarchy(jnp.asarray(xyz), STRIDES, NSAMPLES, banded=True,
                                    knn_method="exact")
    arrays = jh.geometry_to_arrays(full)
    for kw in (dict(banded=True), dict(banded=True, adaptive=False), dict()):
        want = jh.geometry_from_arrays(arrays, jnp.asarray(xyz), len(STRIDES), **kw)
        got = th.geometry_from_arrays(_tensors(arrays), torch.from_numpy(xyz), len(STRIDES), **kw)
        _assert_same(want, got)
    assert got[1].down_starts is None
    got = th.geometry_from_arrays(_tensors(arrays), torch.from_numpy(xyz), len(STRIDES),
                                  banded=True)
    for a, b in zip(full, got):  # the starts re-attached are the ones it was built with
        for field in ("down_starts", "up_starts"):
            assert (getattr(a, field) is None) == (getattr(b, field) is None)
            if getattr(b, field) is not None:
                np.testing.assert_array_equal(getattr(b, field).numpy(),
                                              np.asarray(getattr(a, field)))
    flat = th.geometry_to_arrays(got)
    assert sorted(flat) == sorted(arrays)
    for k, v in flat.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(arrays[k]), err_msg=k)


def test_sort_fps_without_banded_matches_jax():
    """The geometry cache's rule: ascending ``fps_idx`` on the full kNN."""
    xyz = _cloud("random")
    want = jh.build_point_hierarchy(jnp.asarray(xyz), STRIDES, NSAMPLES, sort_fps=True,
                                    knn_method="exact")
    got = th.build_point_hierarchy(torch.from_numpy(xyz), STRIDES, NSAMPLES, sort_fps=True,
                                   knn_method="exact")
    _assert_same(want, got)
    greedy = th.build_point_hierarchy(torch.from_numpy(xyz), STRIDES, NSAMPLES,
                                      knn_method="exact")
    assert not got[0].banded and got[1].down_starts is None
    assert torch.equal(got[1].fps_idx, torch.sort(greedy[1].fps_idx, dim=-1).values)
    assert not torch.equal(got[1].fps_idx, greedy[1].fps_idx)
