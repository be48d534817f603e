"""Parity of the PyTorch port's point ops and the plain versions of its CUDA
kernels (``afford_motion_torch.ops``) with the JAX package on the CPU.

The JAX Pallas kernels run in interpret mode, as the JAX package's own CPU
tests run them. Inputs are made from a seed with numpy. FPS picks, the
packed kNN's idx and dist, and gathered rows must be bit-equal. The exact
kNN's indices must be equal and its distances agree to 1e-5 (abs): both
sides use the expanded form |q|^2 - 2 q.s + |s|^2, whose matmul may round
differently.

The packed kNN's d^2 is ((dx*dx + dy*dy) + dz*dz) with every step rounded,
as the kernel is written. XLA:CPU contracts the interpret-mode kernel's
sums into FMAs, which moves about one quantized key in 2000 on a generic
float cloud. So the comparison with ``knn_pallas`` uses clouds on a 2^-8
grid, where every step of d^2 is exact and FMA cannot matter, and a numpy
oracle of the kernel's definition (no contraction) covers generic clouds.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afford_motion_tpu.ops import pointops as jpo
from afford_motion_tpu.ops.pallas import knn as jknn
from afford_motion_tpu.ops.pallas.fps import fps_pallas
from afford_motion_tpu.ops.pallas.gather import gather_rows as jax_gather_rows
from afford_motion_torch.ops import pointops as tpo
from afford_motion_torch.ops.cuda import fps as tfps
from afford_motion_torch.ops.cuda import knn as tknn
from afford_motion_torch.ops.cuda.fps import fps_cuda, fps_plain
from afford_motion_torch.ops.cuda.gather import gather_rows, gather_rows_plain


def _cloud(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "tie":
        # coarse grid: duplicate points and exactly equal distances
        return (rng.integers(0, 6, size=shape) * 0.25).astype(np.float32)
    if kind == "dyadic":
        # 2^-8 grid in [-2, 2): d^2 < 48 in multiples of 2^-16, exact in f32
        return (rng.integers(-512, 512, size=shape) / 256.0).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


def _packed_knn_oracle(q, s, k):
    """numpy statement of the TPU kernel's definition, every step rounded."""
    d = np.zeros(q.shape[:2] + (s.shape[1],), dtype=np.float32)
    for c in range(3):
        t = q[:, :, None, c] - s[:, None, :, c]
        d = t * t if c == 0 else d + t * t
    keys = (d.view(np.int32) & ~tknn.IDX_MASK) | np.arange(s.shape[1], dtype=np.int32)
    keys = np.sort(keys, axis=-1)[..., :k]
    dq = (keys & ~tknn.IDX_MASK).view(np.float32)
    return keys & tknn.IDX_MASK, np.sqrt(dq.astype(np.float64)).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "tie"])
def test_fps_plain_matches_pallas_and_xla(kind):
    pts = _cloud(kind, (2, 1024, 3), 0)
    got = fps_plain(torch.from_numpy(pts), 256).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(fps_pallas(jnp.asarray(pts), 256)))
    np.testing.assert_array_equal(got, np.asarray(jpo._batched_fps_xla(jnp.asarray(pts), 256)))


@pytest.mark.parametrize("kind,n,m", [("dyadic", 512, 128), ("tie", 256, 64), ("random", 384, 96)])
def test_fps_plain_at_one_cloud_matches_single_row_kernel(kind, n, m):
    """``_fps_kernel`` (one cloud in the (3, N) layout; no caller in the JAX
    package) computes what the batched kernel computes for B = 1: its
    counterpart is the port's FPS given one cloud. The kernel runs in a
    ``pallas_call`` of this test's own, in interpret mode."""
    import functools

    from jax.experimental import pallas as pl

    from afford_motion_tpu.ops.pallas.fps import _fps_kernel

    pts = _cloud(kind, (1, n, 3), 14)
    want = pl.pallas_call(functools.partial(_fps_kernel, m),
                          out_shape=jax.ShapeDtypeStruct((1, m), jnp.int32),
                          interpret=True)(jnp.asarray(pts[0].T))
    got = fps_plain(torch.from_numpy(pts), m)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(fps_pallas(jnp.asarray(pts), m)))
    np.testing.assert_array_equal(fps_cuda(torch.from_numpy(pts), m).numpy(), got.numpy())


def _two_stage_max(hi, lo, axis):
    """The largest (hi, lo) pair along ``axis`` as two unsigned maxima: the
    largest high word, then the largest low word of the entries holding it."""
    top = hi.max(axis=axis, keepdims=True)
    return np.squeeze(top, axis), np.where(hi == top, lo, np.uint32(0)).max(axis=axis)


def _fps_packed_key_model(cloud, m):
    """numpy statement of ``csrc/fps.cu`` on one (N, 3) cloud, ``threads`` a
    block and ``cluster`` blocks a cloud: slot j of thread t in block r holds
    point j * threads * cluster + r * threads + t; each thread keeps the first
    largest field value of its slots; (value, index) becomes the key
    (value bits << 32) | (0xFFFFFFFF - index), 0 for a thread with no point;
    a warp takes the largest high word, then the largest low word among the
    lanes that hold it (two ``redux.sync``), and the partials of all warps of
    the cluster are reduced the same way. Both instances (register-resident
    up to ``RESIDENT_POINTS``, streamed above) use these slots."""
    threads, cluster = tfps.THREADS, tfps.CLUSTER
    n = len(cloud)
    span = threads * cluster
    idx = (np.arange(-(-max(n, tfps.RESIDENT_POINTS) // span))[:, None, None] * span
           + np.arange(cluster)[None, :, None] * threads
           + np.arange(threads)[None, None, :])                       # (slots, blocks, threads)
    valid = idx < n
    p = np.where(valid[..., None], cloud[np.minimum(idx, n - 1)], np.float32(0))
    md = np.where(valid, np.float32(np.inf), np.float32(-1))
    out = np.zeros(m, dtype=np.int32)
    for step in range(1, m):
        dx, dy, dz = (p[..., c] - cloud[out[step - 1], c] for c in range(3))
        with np.errstate(over="ignore"):
            md = np.minimum(md, (dx * dx + dy * dy) + dz * dz)
        best_j = md.argmax(axis=0)[None]                                # first maximal slot
        best = np.take_along_axis(md, best_j, 0)[0]
        real = best >= 0
        hi = np.where(real, best.view(np.uint32), np.uint32(0))
        lo = np.where(real, np.uint32(0xFFFFFFFF)
                      - np.take_along_axis(idx, best_j, 0)[0].astype(np.uint32), np.uint32(0))
        largest = ((hi.astype(np.uint64) << np.uint64(32)) | lo).max()
        hi, lo = _two_stage_max(hi.reshape(cluster, threads // 32, 32),
                                lo.reshape(cluster, threads // 32, 32), 2)
        hi, lo = _two_stage_max(hi.reshape(-1), lo.reshape(-1), 0)
        assert int(hi) << 32 | int(lo) == int(largest)
        out[step] = np.uint32(0xFFFFFFFF) - lo
    return out


def _fps_key_cloud(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "near-tie":
        # 2^-3 grid: duplicate points and exactly tied field values
        return (rng.integers(0, 8, size=(2, 1024, 3)) * 0.125).astype(np.float32)
    if kind == "inf":
        # some points ~1e20 away: their distances overflow, so the field holds
        # +inf for many points at once, tied
        pts = (rng.integers(0, 8, size=(2, 1024, 3)) * 0.125).astype(np.float32)
        far = rng.random(size=(2, 1024)) < 0.05
        pts[far] = rng.choice([-1e20, 1e20, 3e19], size=(int(far.sum()), 3)).astype(np.float32)
        return pts
    n = int(kind.split("=")[1])   # one cloud whose size leaves padding slots
    return (rng.integers(-512, 512, size=(1, n, 3)) / 256.0).astype(np.float32)


@pytest.mark.parametrize("kind,m", [("near-tie", 200), ("inf", 200), ("N=1000", 250),
                                    ("N=8191", 96)])
def test_fps_packed_key_order_matches_first_index_rule(kind, m):
    """The kernel's packed-key argmax picks what ``fps_plain``'s first-index
    rule and the TPU kernel pick."""
    pts = _fps_key_cloud(kind, 15)
    want = fps_plain(torch.from_numpy(pts), m).numpy()
    np.testing.assert_array_equal(want, np.asarray(fps_pallas(jnp.asarray(pts), m)))
    if kind == "inf":   # after the first pick, the far points' field is +inf
        delta = pts[0] - pts[0, 0]
        with np.errstate(over="ignore"):
            d = (delta[:, 0] * delta[:, 0] + delta[:, 1] * delta[:, 1]) + delta[:, 2] * delta[:, 2]
        assert np.isinf(d).sum() > 1
    for b in range(len(pts)):
        np.testing.assert_array_equal(_fps_packed_key_model(pts[b], m), want[b])



@pytest.mark.parametrize("kind", ["random", "near-tie"])
def test_fps_beyond_the_resident_cloud(kind):
    """Past 8192 points ``fps_cuda`` has no cap: on the CPU it takes
    ``fps_plain``, and the key-order model of the streamed instance's slots
    (10 a thread at N = 10,000) picks what ``fps_plain`` picks."""
    rng = np.random.default_rng(16)
    n = 10_000
    assert n > tfps.RESIDENT_POINTS
    if kind == "near-tie":
        pts = (rng.integers(0, 8, size=(1, n, 3)) * 0.125).astype(np.float32)
    else:
        pts = rng.normal(size=(1, n, 3)).astype(np.float32)
    before = fps_cuda.launches
    got = fps_cuda(torch.from_numpy(pts), 48).numpy()
    assert fps_cuda.launches == before
    np.testing.assert_array_equal(got, fps_plain(torch.from_numpy(pts), 48).numpy())
    np.testing.assert_array_equal(_fps_packed_key_model(pts[0], 48), got[0])


def test_fps_cuda_wrapper_routes_cpu_to_plain():
    pts = torch.from_numpy(_cloud("random", (2, 512, 3), 1))
    before = fps_cuda.launches
    np.testing.assert_array_equal(fps_cuda(pts, 128).numpy(), fps_plain(pts, 128).numpy())
    np.testing.assert_array_equal(tpo.farthest_point_sampling(pts[1], 128).numpy(),
                                  fps_plain(pts, 128)[1].numpy())
    assert fps_cuda.launches == before
    with pytest.raises(ValueError):
        fps_cuda(pts.double(), 128)


@pytest.mark.parametrize("kind,m,n,k", [
    ("dyadic", 128, 256, 8),
    ("dyadic", 256, 512, 16),
    ("dyadic", 128, 1024, 16),
    ("tie", 256, 512, 16),
])
def test_knn_plain_matches_pallas_packed(kind, m, n, k):
    """The packed-quantized order of knn_pallas, not exact top-k."""
    s = _cloud(kind, (2, n, 3), 2)
    q = s[:, :m].copy() if kind == "tie" else _cloud(kind, (2, m, 3), 3)
    want_i, want_d = jknn.knn_pallas(jnp.asarray(q), jnp.asarray(s), k)
    got_i, got_d = tknn.knn_plain(torch.from_numpy(q), torch.from_numpy(s), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_d.numpy().view(np.int32),
                                  np.asarray(want_d).view(np.int32))
    exact_i, _ = jpo.knn(jnp.asarray(q[0]), jnp.asarray(s[0]), k, method="exact")
    if kind == "dyadic":  # the quantization is visible: not exact top-k
        assert (got_i.numpy()[0] != np.asarray(exact_i)).any()


@pytest.mark.parametrize("m,n,k", [(128, 256, 8), (256, 2048, 16)])
def test_knn_plain_matches_packed_oracle(m, n, k):
    q, s = _cloud("random", (2, m, 3), 12), _cloud("random", (2, n, 3), 13)
    want_i, want_d = _packed_knn_oracle(q, s, k)
    got_i, got_d = tknn.knn_plain(torch.from_numpy(q), torch.from_numpy(s), k)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_d.numpy().view(np.int32), want_d.view(np.int32))


def test_knn_plain_chunking_is_invisible():
    q, s = _cloud("random", (2, 384, 3), 4), _cloud("random", (2, 512, 3), 5)
    a = tknn.knn_plain(torch.from_numpy(q), torch.from_numpy(s), 8, chunk=128)
    b = tknn.knn_plain(torch.from_numpy(q), torch.from_numpy(s), 8, chunk=384)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


@pytest.mark.parametrize("m,n,k", [(128, 256, 8), (384, 8192, 64), (100, 512, 8),
                                   (128, 200, 8), (128, 256, 256), (128, 8320, 8)])
def test_knn_supports_matches_jax(m, n, k):
    assert tknn.supports(m, n, k) == jknn.supports(m, n, k)


@pytest.mark.parametrize("m,n,k,chunk", [(64, 200, 8, 2048), (96, 300, 16, 32),
                                         (20, 5, 8, 2048), (16, 16, 16, 8)])
def test_exact_knn_matches_jax(m, n, k, chunk):
    """Generic clouds, including the k > n clamp (index 0, dist sqrt(1e10))."""
    q, s = _cloud("random", (2, m, 3), 6), _cloud("random", (2, n, 3), 7)
    want_i, want_d = jax.vmap(
        lambda a, b: jpo.knn(a, b, k, chunk=chunk, method="exact"))(jnp.asarray(q), jnp.asarray(s))
    got_i, got_d = tpo.knn(torch.from_numpy(q), torch.from_numpy(s), k, chunk=chunk)
    assert got_i.dtype == torch.int32 and tuple(got_i.shape) == (2, m, k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=0, atol=1e-5)


def test_batched_knn_routing():
    """Supported shapes take the packed kNN unless method='exact'."""
    q, s = _cloud("random", (2, 128, 3), 8), _cloud("random", (2, 256, 3), 9)
    qt, st = torch.from_numpy(q), torch.from_numpy(s)
    packed = tknn.knn_plain(qt, st, 8)
    exact = tpo.knn(qt, st, 8)
    for x, y in zip(tpo.batched_knn(qt, st, 8), packed):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    for x, y in zip(tpo.batched_knn(qt, st, 8, "exact"), exact):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    # 128 support points are below the packed kernel's range
    small = tpo.batched_knn(qt, st[:, :128], 16)
    np.testing.assert_array_equal(small[0].numpy(), tpo.knn(qt, st[:, :128], 16)[0].numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_plain_matches_gather_rows(dtype):
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 300, 67)).astype(np.float32)
    idx = rng.integers(0, 300, size=(2, 128, 16)).astype(np.int32)
    xj = jnp.asarray(x).astype(dtype)
    want = np.asarray(jax_gather_rows(xj, jnp.asarray(idx)).astype(jnp.float32))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    before = gather_rows.launches
    got = gather_rows(xt, torch.from_numpy(idx))
    assert got.dtype == xt.dtype and gather_rows.launches == before
    np.testing.assert_array_equal(got.float().numpy().view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(got.numpy() if dtype == "float32" else got.float().numpy(),
                                  gather_rows_plain(xt, torch.from_numpy(idx)).float().numpy())


def test_interpolation_weights_match_jax():
    d = np.abs(_cloud("random", (2, 64, 3), 11))
    np.testing.assert_allclose(tpo.interpolation_weights(torch.from_numpy(d)).numpy(),
                               np.asarray(jpo.interpolation_weights(jnp.asarray(d))),
                               rtol=1e-6, atol=1e-7)


def test_port_imports_without_jax():
    """Every port module and ``chip_smoke`` import, and a tiny CPU chain and
    the LBS and physics of the evaluator run, with no module of jax or of
    the JAX package loaded."""
    code = (
        "import sys, pkgutil, importlib, torch\n"
        "import afford_motion_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'afford_motion_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "for name in ('ops.cuda.banded', 'ops.curves', 'ops.morton', 'data.packed', 'prepare',\n"
        "             'ops.cuda.sdf', 'ops.cuda.attention', 'data.motionx', 'eval.smplx_lbs',\n"
        "             'eval.joints_to_smplx', 'eval.physics', 'eval.evaluate', 'native',\n"
        "             'train.device_store', 'parallel.mesh'):\n"
        "    assert 'afford_motion_torch.' + name in sys.modules, name\n"
        "from afford_motion_torch.models.cmdm import CMDM\n"
        "from afford_motion_torch.diffusion import create_gaussian_diffusion\n"
        "from afford_motion_torch.train.sampling import make_sample_fn\n"
        "from afford_motion_torch.utils.config import DictConfig\n"
        "torch.manual_seed(0)\n"
        "m = CMDM(motion_dim=12, latent_dim=32, time_emb_dim=32, text_feat_dim=16,\n"
        "         planes=(8, 16, 32, 64), num_layers=(1,), num_heads=4,\n"
        "         dim_feedforward=64).eval()\n"
        "d = create_gaussian_diffusion(DictConfig({'steps': 4}))\n"
        "cond = {'c_pc_xyz': torch.randn(1, 512, 3), 'c_pc_contact': torch.rand(1, 512, 6),\n"
        "        'text_emb': torch.randn(1, 1, 16), 'x_mask': torch.zeros(1, 10, dtype=torch.bool)}\n"
        "x0 = make_sample_fn(m, d, sampler='ddim')((1, 10, 12), cond)\n"
        "assert x0.shape == (1, 10, 12) and bool(torch.isfinite(x0).all())\n"
        "from afford_motion_torch.eval.physics import physics_over_sequence\n"
        "from afford_motion_torch.eval.smplx_lbs import SMPLXModel, params_to_verts_joints\n"
        "body = SMPLXModel.synthetic(num_verts=32)\n"
        "verts, _ = params_to_verts_joints(body, torch.randn(3, 69) * 0.3)\n"
        "nc, ct = physics_over_sequence(torch.randn(128, 3), verts, body.faces_arr)\n"
        "assert nc.shape == (3,) and bool(torch.isfinite(nc).all())\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('afford_motion_tpu', 'jax', 'jaxlib', 'flax', 'optax', 'orbax'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr[-3000:]
