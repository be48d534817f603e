"""Parity of the port's fused 1-NN (plain version) and SDF physics
(``afford_motion_torch.ops.cuda.sdf``, ``afford_motion_torch.eval.physics``)
with the JAX package on the CPU.

``nn1_pallas`` runs in interpret mode, as the JAX package's own CPU tests
run it. Inputs are made from a seed with numpy. The kernel's d2 is
((dx*dx + dy*dy) + dz*dz) with every step rounded; XLA:CPU may contract the
interpret-mode kernel's sums into FMAs, so the bit-for-bit comparison with
``nn1_pallas`` (idx equal, d2 bit-equal) uses clouds on a 2^-8 grid, where
every step is exact, and a numpy oracle of the definition (no contraction)
covers generic clouds, ties, a vertex count off every chunk and the carry
across query chunks.

Tolerances of the physics functions (float32, sums in other orders): signed
distances 1e-5 abs on all but the entries whose sign dot product is at
rounding level (at most 0.2% of the entries may differ), vertex normals 1e-5,
per-frame metrics 2/O (two points changing side), ``dist_to_obj`` 1e-5.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afford_motion_tpu.eval import physics as jphys
from afford_motion_tpu.ops.pallas import sdf as jsdf
from afford_motion_torch.eval import physics as tphys
from afford_motion_torch.ops.cuda import sdf as tsdf


def _cloud(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "tie":
        # coarse grid: duplicate vertices and exactly equal distances
        return (rng.integers(0, 5, size=shape) * 0.25).astype(np.float32)
    if kind == "dyadic":
        # 2^-8 grid in [-2, 2): d2 < 48 in multiples of 2^-16, exact in f32
        return (rng.integers(-512, 512, size=shape) / 256.0).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


def _nn1_oracle(points, verts_seq):
    """numpy statement of the kernel's definition, every step rounded."""
    d = np.zeros((verts_seq.shape[0], points.shape[0], verts_seq.shape[1]), dtype=np.float32)
    for c in range(3):
        t = points[None, :, None, c] - verts_seq[:, None, :, c]
        d = t * t if c == 0 else d + t * t
    return d.min(axis=-1), d.argmin(axis=-1).astype(np.int32)   # numpy: first index of the min


def _scene(seed, o, l, h):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(o, 3)).astype(np.float32),
            rng.normal(size=(l, h, 3)).astype(np.float32),
            rng.integers(0, h, size=(2 * h, 3)).astype(np.int32))


@pytest.mark.parametrize("kind,o,l,h", [
    ("dyadic", 256, 3, 331),    # H off the TPU kernel's 128-wide chunks: its sentinel padding
    ("dyadic", 128, 2, 1024),
    ("tie", 256, 2, 300),       # duplicates and exact ties: the first index wins
])
def test_nn1_plain_matches_pallas(kind, o, l, h):
    pts, vs = _cloud(kind, (o, 3), 0), _cloud(kind, (l, h, 3), 1)
    want_d2, want_idx = jsdf.nn1_pallas(jnp.asarray(pts), jnp.asarray(vs))
    got_d2, got_idx = tsdf.nn1_plain(torch.from_numpy(pts), torch.from_numpy(vs))
    assert got_idx.dtype == torch.int32 and got_d2.dtype == torch.float32
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_d2.numpy().view(np.int32),
                                  np.asarray(want_d2).view(np.int32))


def test_nn1_plain_matches_pallas_multi_chunk(monkeypatch):
    """The TPU kernel's carry across support chunks, with an exact duplicate
    in a later chunk: the earlier chunk's index stays."""
    monkeypatch.setattr(jsdf, "_VMEM_BUDGET", 128 * 128 * 12 + 128 * 16)
    assert jsdf._chunking(300)[0] >= 2
    pts, vs = _cloud("dyadic", (128, 3), 2), _cloud("dyadic", (2, 300, 3), 3)
    vs[0, 250] = vs[0, 10]
    want_d2, want_idx = jsdf.nn1_pallas.__wrapped__(jnp.asarray(pts), jnp.asarray(vs))
    got_d2, got_idx = tsdf.nn1_plain(torch.from_numpy(pts), torch.from_numpy(vs))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_d2.numpy().view(np.int32),
                                  np.asarray(want_d2).view(np.int32))


@pytest.mark.parametrize("kind,o,l,h,chunk", [
    ("random", 256, 3, 331, 2048),
    ("random", 300, 2, 517, 128),   # queries off the tile, carried across query chunks
    ("tie", 128, 2, 130, 50),
])
def test_nn1_plain_matches_oracle(kind, o, l, h, chunk):
    pts, vs = _cloud(kind, (o, 3), 4), _cloud(kind, (l, h, 3), 5)
    if kind == "tie":
        vs[0, 97] = vs[0, 40]
    want_d2, want_idx = _nn1_oracle(pts, vs)
    got_d2, got_idx = tsdf.nn1_plain(torch.from_numpy(pts), torch.from_numpy(vs), chunk=chunk)
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    np.testing.assert_array_equal(got_d2.numpy().view(np.int32), want_d2.view(np.int32))


def test_nn1_tie_break_first_index():
    pts = torch.zeros((128, 3))
    v = np.ones((1, 130, 3), dtype=np.float32)
    v[0, 40] = 0.25
    v[0, 97] = 0.25
    _, idx = tsdf.nn1_plain(pts, torch.from_numpy(v))
    assert int(idx[0, 0]) == 40


def test_nn1_cuda_wrapper_routes_cpu_to_plain():
    pts, vs = _cloud("random", (128, 3), 6), _cloud("random", (2, 200, 3), 7)
    before = tsdf.nn1_cuda.launches
    got = tsdf.nn1_cuda(torch.from_numpy(pts), torch.from_numpy(vs))
    want = tsdf.nn1_plain(torch.from_numpy(pts), torch.from_numpy(vs))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert tsdf.nn1_cuda.launches == before
    with pytest.raises(ValueError):
        tsdf.nn1_cuda(torch.from_numpy(pts).double(), torch.from_numpy(vs))
    with pytest.raises(ValueError):
        tsdf.nn1_cuda(torch.from_numpy(pts), torch.from_numpy(vs[0]))


@pytest.mark.parametrize("o,h", [(256, 300), (250, 300), (127, 1), (1, 77)])
def test_auto_takes_the_fused_route_at_any_shape(o, h):
    """The TPU kernel's ``supports`` wants queries that tile by 128; the
    port's kernel masks its ragged tiles, so ``auto`` never leaves it."""
    pts, vs, faces = _scene(14, o, 2, h)
    args = (torch.from_numpy(pts), torch.from_numpy(vs), torch.from_numpy(faces))
    before = tsdf.nn1_cuda.launches
    got = tphys.signed_distance_seq(*args, kernel="auto")
    want = tphys.signed_distance_seq(*args, kernel="pallas")
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert tsdf.nn1_cuda.launches == before   # CPU tensors: the plain version
    if h >= 300:
        # where the JAX package's ``auto`` leaves its kernel (250 queries) the
        # two packages still agree, to the tolerance of the two distance forms
        _assert_sdf_close(got.numpy(), np.asarray(jphys.signed_distance_seq(
            jnp.asarray(pts), jnp.asarray(vs), jnp.asarray(faces), kernel="xla")))


def test_vertex_normals_match_jax():
    _, vs, faces = _scene(8, 64, 3, 200)
    want = np.asarray(jphys.vertex_normals(jnp.asarray(vs[0]), jnp.asarray(faces)))
    got = tphys.vertex_normals(torch.from_numpy(vs[0]), torch.from_numpy(faces))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    batched = tphys.vertex_normals(torch.from_numpy(vs), torch.from_numpy(faces))
    np.testing.assert_array_equal(batched[0].numpy(), got.numpy())



def _index_add_normals(verts, faces):
    """The summation the port used before its incidence table: ``index_add_``
    of the face normals, one corner column at a time."""
    faces = faces.long()
    fv = verts[..., faces, :]
    e1 = fv[..., 1, :] - fv[..., 0, :]
    e2 = fv[..., 2, :] - fv[..., 0, :]
    e1 = e1 / (torch.linalg.norm(e1, dim=-1, keepdim=True) + 1e-12)
    e2 = e2 / (torch.linalg.norm(e2, dim=-1, keepdim=True) + 1e-12)
    fn = torch.linalg.cross(e1, e2, dim=-1)
    vn = torch.zeros_like(verts)
    for k in range(3):
        vn.index_add_(-2, faces[:, k], fn)
    return vn / (torch.linalg.norm(vn, dim=-1, keepdim=True) + 1e-12)


def test_vertex_normals_fixed_order():
    """The incidence-table sum agrees with the ``index_add_`` one to 1e-6,
    is bit-identical from call to call, and its table does not depend on the
    order in which the incidence pairs come (faces with a repeated corner
    and vertices in no face included)."""
    _, vs, faces = _scene(21, 16, 3, 400)
    faces[:5, 1] = faces[:5, 0]          # degenerate faces: a vertex named twice
    faces[faces == 7] = 8                # vertex 7 in no face: a zero normal
    v, f = torch.from_numpy(vs), torch.from_numpy(faces)
    got = tphys.vertex_normals(v, f)
    np.testing.assert_allclose(got.numpy(), _index_add_normals(v, f).numpy(), rtol=0, atol=1e-6)
    assert torch.equal(got, tphys.vertex_normals(v, f))
    assert torch.equal(got, tphys.vertex_normals(v, f, tphys.face_table(f, 400)))
    assert not got[:, 7].any()
    vert_of = faces.reshape(-1).astype(np.int64)
    face_of = np.arange(vert_of.size) // 3
    table = tphys.incidence_table(vert_of, face_of, 400, len(faces))
    perm = np.random.default_rng(3).permutation(vert_of.size)
    np.testing.assert_array_equal(
        tphys.incidence_table(vert_of[perm], face_of[perm], 400, len(faces)), table)
    assert (np.diff(table, axis=1) >= 0).all()
    assert table[7].tolist() == [len(faces)] * table.shape[1]
    assert "index_add" not in inspect.getsource(tphys.vertex_normals)


def _assert_sdf_close(got, want):
    far = np.abs(got - want) > 1e-5
    assert far.mean() <= 2e-3, f"{far.mean():.4f} of the signed distances differ"
    # what differs is the sign, not the distance
    np.testing.assert_allclose(np.abs(got), np.abs(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kernel", ["pallas", "xla"])
def test_signed_distance_seq_matches_jax(kernel):
    pts, vs, faces = _scene(9, 256, 4, 300)
    want = np.asarray(jphys.signed_distance_seq(jnp.asarray(pts), jnp.asarray(vs),
                                                jnp.asarray(faces), kernel=kernel))
    got = tphys.signed_distance_seq(torch.from_numpy(pts), torch.from_numpy(vs),
                                    torch.from_numpy(faces), kernel=kernel).numpy()
    assert got.shape == (4, 256)
    _assert_sdf_close(got, want)


@pytest.mark.parametrize("kernel", ["pallas", "xla", "auto"])
def test_physics_over_sequence_matches_jax(kernel):
    pts, vs, faces = _scene(10, 256, 4, 300)
    # bring the body near the points so both metrics move
    vs = vs * 0.3
    want = jphys.physics_over_sequence(jnp.asarray(pts), jnp.asarray(vs), jnp.asarray(faces),
                                       kernel="pallas" if kernel == "auto" else kernel)
    got = tphys.physics_over_sequence(torch.from_numpy(pts), torch.from_numpy(vs),
                                      torch.from_numpy(faces), kernel=kernel)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=2 / 256)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert 0.0 < float(got[0].mean()) < 1.0


def test_sdf_kernel_routing(monkeypatch):
    """``auto`` takes the fused 1-NN, ``xla`` is taken only by name, the env
    override wins over the argument, and an unknown name is refused."""
    assert tphys._resolve_kernel("auto") == "pallas"
    assert tphys._resolve_kernel("xla") == "xla"
    pts, vs, faces = _scene(11, 128, 2, 200)
    args = (torch.from_numpy(pts), torch.from_numpy(vs), torch.from_numpy(faces))
    monkeypatch.setenv("AM_SDF_KERNEL", "xla")
    a = tphys.physics_over_sequence(*args, kernel="pallas")
    monkeypatch.delenv("AM_SDF_KERNEL")
    b = tphys.physics_over_sequence(*args, kernel="xla")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    with pytest.raises(ValueError):
        tphys.physics_over_sequence(*args, kernel="mosaic")


def test_dist_to_obj_and_apd_match_jax():
    pts, vs, faces = _scene(12, 128, 1, 200)
    for scale in (1.0, 3.0):   # 3.0: every point outside, so the minimum with 0 matters
        want = float(jphys.dist_to_obj(jnp.asarray(pts * scale), jnp.asarray(vs[0]),
                                       jnp.asarray(faces)))
        got = float(tphys.dist_to_obj(torch.from_numpy(pts * scale), torch.from_numpy(vs[0]),
                                      torch.from_numpy(faces)))
        assert abs(got - want) <= 1e-5 and got <= 0.0
    x = np.random.default_rng(13).normal(size=(3, 10, 66)).astype(np.float32)
    assert tphys.compute_pairwise_distance(x) == jphys.compute_pairwise_distance(x)
