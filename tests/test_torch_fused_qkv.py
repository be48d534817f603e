"""``model.fused_qkv`` in the port against the JAX package's ``fused_qkv=True``,
at a small width on the CPU (2 layers a stack, latent 64, 4 heads).

- The name table (``utils/convert.py cmdm_entries(..., fused_qkv=True)``):
  the flax tree of the fused model (a self-attention's ``in_proj`` one packed
  ``Dense_0`` and ``Dense_1`` out; a kv-shared cross-attention's q
  ``Dense_0``, packed kv ``Dense_1`` and ``Dense_2`` out) against the JAX
  package's ``convert_cmdm_checkpoint(..., fused_qkv=True)`` and
  ``export_cmdm_checkpoint``, bit for bit, both ways.
- The forward of ``trans_enc`` and ``trans_dec`` (whose attention always
  computes its projections fused) against JAX's CMDM built with the flag,
  at ``tests/test_torch_cmdm.py``'s tolerances (float32 1e-4, bfloat16
  5e-2).
- One ``trans_enc`` train step (loss, gradients, the parameters after AdamW)
  through ``tests/test_torch_train.py``'s ``_compare_train_steps``.
- The packed entries of the fused attention (``attention_qkv_cuda``,
  ``attention_q_kv_cuda``) on the CPU, where they take the plain versions:
  the same o and gradients as ``attention_cuda`` on copies followed by
  ``uniform_where_all_masked`` through autograd, bit for bit, one packed
  gradient tensor, and no split, slice or concatenation in the autograd
  graph between the attention and its inputs.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afford_motion_tpu.models.cmdm import CMDM as JaxCMDM
from afford_motion_tpu.ops.hierarchy import build_point_hierarchy, geometry_to_arrays
from afford_motion_tpu.utils.torch_convert import convert_cmdm_checkpoint, export_cmdm_checkpoint
from afford_motion_torch.models import layers
from afford_motion_torch.models.cmdm import CMDM
from afford_motion_torch.ops.cuda import attention as tattn
from afford_motion_torch.ops.hierarchy import geometry_from_arrays
from afford_motion_torch.utils.convert import (
    cmdm_jax_tree_from_state_dict,
    cmdm_state_dict_from_jax,
)
from test_torch_cmdm import _perturb_bn
from test_torch_train import ARCH as TRAIN_ARCH
from test_torch_train import LAYERS as TRAIN_LAYERS
from test_torch_train import BLOCKS as TRAIN_BLOCKS
from test_torch_train import _compare_train_steps
from test_torch_train import setup as train_setup  # noqa: F401  (a fixture)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, N, L, D, TEXT = 2, 1024, 24, 263, 64
PLANES, BLOCKS = (16, 32, 64, 128), (2, 2, 2, 2)
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
LAYERS = {"trans_enc": (1, 1), "trans_dec": (1, 1)}


def _arch(arch):
    return dict(motion_dim=D, latent_dim=64, time_emb_dim=64, text_feat_dim=TEXT,
                contact_dim=6, planes=PLANES, blocks=BLOCKS, num_layers=LAYERS[arch],
                num_heads=4, dim_feedforward=128, arch=arch)


def _names(arch, fused=True):
    return dict(num_layers=LAYERS[arch], blocks=BLOCKS, arch=arch, fused_qkv=fused)


def _flat(tree, leaf=np.asarray):
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module", params=["trans_enc", "trans_dec"])
def model_setup(request):
    """One architecture: the port's seeded init (BatchNorm values perturbed)
    as a state_dict and as the fused flax tree, a cloud's hierarchy on both
    sides and a batch."""
    arch = request.param
    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    tree = cmdm_jax_tree_from_state_dict(CMDM(**_arch(arch)).state_dict(), **_names(arch))
    variables = {"params": _perturb_bn(tree["params"], rng, "params"),
                 "batch_stats": _perturb_bn(tree["batch_stats"], rng, "stats")}
    xyz = rng.normal(size=(B, N, 3)).astype(np.float32)
    levels = build_point_hierarchy(jnp.asarray(xyz), (1, 4, 4, 4), (8, 16, 16, 16),
                                   with_up=arch == "trans_dec", knn_method="exact")
    x_mask = np.zeros((B, L), dtype=bool)
    x_mask[1, 15:] = True
    cond = {"levels_sm": levels,
            "c_pc_contact": jnp.asarray(rng.uniform(size=(B, N, 6)).astype(np.float32)),
            "text_emb": jnp.asarray(rng.normal(size=(B, 1, TEXT)).astype(np.float32)),
            "x_mask": jnp.asarray(x_mask),
            "c_pc_mask": jnp.asarray(np.array([[False], [True]]))}
    geo = {k: torch.tensor(np.asarray(v))
           for k, v in geometry_to_arrays(levels, prefix="geo_sm").items()}
    t_cond = {k: torch.tensor(np.asarray(v)) for k, v in cond.items() if k != "levels_sm"}
    t_cond["levels_sm"] = geometry_from_arrays(geo, torch.from_numpy(xyz), 4, prefix="geo_sm")
    return dict(arch=arch, variables=variables, cond=cond, t_cond=t_cond,
                sd=cmdm_state_dict_from_jax(variables, **_names(arch)),
                x=rng.normal(size=(B, L, D)).astype(np.float32),
                t=np.array([10, 700], dtype=np.int32), x_mask=x_mask)


def test_name_table_matches_the_jax_converters(model_setup):
    """The table's fused tree is ``convert_cmdm_checkpoint(fused_qkv=True)``
    of the same state_dict, leaf for leaf and bit for bit, and its state_dict
    is ``export_cmdm_checkpoint(fused_qkv=True)`` of that tree; both agree
    with the shapes of JAX's own init of the fused model, and the state_dict
    is the unfused model's key for key."""
    arch, sd = model_setup["arch"], model_setup["sd"]
    names = {k: v for k, v in _names(arch).items() if k != "blocks"}
    converted = convert_cmdm_checkpoint({k: v.numpy() for k, v in sd.items()}, **names)
    mine = cmdm_jax_tree_from_state_dict(sd, **_names(arch))
    a, b = _flat(converted), _flat(mine)
    assert sorted(a) == sorted(b)
    assert all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)
    exported = export_cmdm_checkpoint(mine, **names)
    assert sorted(exported) == sorted(sd)
    assert all(np.array_equal(np.asarray(exported[k]), sd[k].numpy()) for k in sd)
    back = cmdm_state_dict_from_jax(converted, **_names(arch))
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    shapes = jax.eval_shape(JaxCMDM(**_arch(arch), fused_qkv=True).init, jax.random.PRNGKey(0),
                            jnp.asarray(model_setup["x"]), jnp.asarray(model_setup["t"]),
                            model_setup["cond"])
    assert _flat(dict(shapes), lambda v: v.shape) == {k: v.shape for k, v in b.items()}
    # fused: a self-attention's packed Dense_0 is in_proj whole (transposed)
    mha = "self_attn_layer/TransformerEncoderLayer_0" if arch == "trans_enc" else \
        "self_attn_layers_0/TransformerEncoderLayer_0"
    key = mha.replace("/TransformerEncoderLayer_", ".layers.").replace("self_attn_layers_0",
                                                                     "self_attn_layers.0")
    assert np.array_equal(b[f"params/{mha}/TorchMultiHeadAttention_0/Dense_0/kernel"],
                          sd[f"{key}.self_attn.in_proj_weight"].numpy().T)
    assert set(CMDM(**_arch(arch)).state_dict()) == set(sd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(model_setup, dtype):
    """encode_contact + denoise, JAX's with the flag and the port's (item 1's
    memory masked by ``c_pc_mask``), on valid frames."""
    arch, s = model_setup["arch"], model_setup
    jm = JaxCMDM(**_arch(arch), dtype=jnp.dtype(dtype), fused_qkv=True)
    enc = jax.jit(partial(jm.apply, method=JaxCMDM.encode_contact))(s["variables"], s["cond"])
    want = jax.jit(partial(jm.apply, method=JaxCMDM.denoise))(
        s["variables"], jnp.asarray(s["x"]), jnp.asarray(s["t"]), s["cond"], enc)
    tm = CMDM(**_arch(arch), dtype=getattr(torch, dtype))
    tm.load_state_dict(s["sd"], strict=True)
    with torch.no_grad():
        tm.eval()
        got = tm(torch.from_numpy(s["x"]), torch.from_numpy(s["t"]), s["t_cond"])
    valid = ~s["x_mask"]
    tol = TOL[dtype]
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], rtol=tol, atol=tol)


def test_train_step_matches_jax(train_setup):
    """Three AdamW steps of the port's ``trans_enc`` (dropout 0) against JAX's
    fused model on ``tests/test_torch_train.py``'s batch, weights and draws,
    held as that file holds the unfused step."""
    names = dict(num_layers=TRAIN_LAYERS, blocks=TRAIN_BLOCKS)
    sd = cmdm_state_dict_from_jax(train_setup["variables"], **names)
    variables = cmdm_jax_tree_from_state_dict(sd, **names, fused_qkv=True)
    tm = CMDM(**TRAIN_ARCH, dropout=0.0)
    tm.load_state_dict(sd, strict=True)
    _compare_train_steps(train_setup, variables, train_setup["jcond"], train_setup["tcond"],
                         train_setup["x"], tm, 0.0, 0,
                         jm=JaxCMDM(**TRAIN_ARCH, dropout=0.0, fused_qkv=True),
                         to_tree=lambda t: cmdm_jax_tree_from_state_dict(t, **names,
                                                                         fused_qkv=True))


COPIES = ("Split", "Cat", "Chunk", "Slice", "Select", "Index", "Copy", "Clone")


def _graph(t, *inputs):
    """The names of the nodes of ``t``'s autograd graph that lie on a path
    from ``t`` to one of ``inputs`` (leaves): the nodes an input's gradient
    passes through."""
    targets = {x.grad_fn if x.grad_fn is not None else None for x in inputs}
    leaves = {id(x) for x in inputs}
    on_path = {}

    def reaches(fn):
        if fn is None:
            return False
        if fn not in on_path:
            on_path[fn] = False
            hit = getattr(fn, "variable", None) is not None and id(fn.variable) in leaves
            for nxt, _ in fn.next_functions:
                hit = reaches(nxt) or hit
            on_path[fn] = hit or fn in targets
        return on_path[fn]

    reaches(t.grad_fn)
    return {type(fn).__name__ for fn, hit in on_path.items() if hit}


def _copies(names):
    return [n for n in names if any(c in n for c in COPIES)]


@pytest.mark.parametrize("case", ["self", "cross"])
def test_packed_entries_match_the_unfused_call(case):
    """On CPU tensors the packed entries take the plain versions on the
    views: o and every gradient bit-equal to ``attention_cuda`` on contiguous
    copies followed by ``uniform_where_all_masked`` through autograd (an item
    with every key masked, one with a masked stretch), one gradient of the
    packed input's shape, and no split, slice or concatenation in the graph:
    the Function's backward hands the packed input its gradient directly,
    the all-masked item's share of it included."""
    rng = np.random.default_rng(3)
    b, lq, width, heads = 3, 20, 32, 4
    lk = lq if case == "self" else 37
    pad = torch.from_numpy(np.arange(lk)[None, :] >= np.array([[lk], [lk - 5], [0]]))
    pad[0, 4:9] = True
    do = torch.from_numpy(rng.normal(size=(b, lq, width)).astype(np.float32))
    if case == "self":
        x = torch.from_numpy(rng.normal(size=(b, lq, 3 * width)).astype(np.float32))
        x.requires_grad_(True)
        o = tattn.attention_qkv_cuda(x, heads, pad)
        parts = [t.detach().clone().requires_grad_(True) for t in x.chunk(3, dim=-1)]
        packed_grads = (x,)
    else:
        q = torch.from_numpy(rng.normal(size=(b, lq, width)).astype(np.float32))
        kv = torch.from_numpy(rng.normal(size=(b, lk, 2 * width)).astype(np.float32))
        q.requires_grad_(True)
        kv.requires_grad_(True)
        o = tattn.attention_q_kv_cuda(q, kv, heads, pad)
        parts = [t.detach().clone().requires_grad_(True) for t in (q, *kv.chunk(2, dim=-1))]
        packed_grads = (q, kv)
    names = _graph(o, *packed_grads)
    assert "PackedFlashAttentionBackward" in names
    assert not _copies(names), names
    want = tattn.uniform_where_all_masked(tattn.attention_cuda(*parts, heads, pad), parts[2], pad)
    assert torch.equal(o, want)
    o.backward(do)
    want.backward(do)
    got = list(packed_grads[0].grad.chunk(3, dim=-1)) if case == "self" else [
        packed_grads[0].grad, *packed_grads[1].grad.chunk(2, dim=-1)]
    assert all(t.grad.shape == t.shape for t in packed_grads)
    for g, p in zip(got, parts):
        assert torch.equal(g, p.grad)
    # masked keys get no gradient; the all-masked item's v gets its rows'
    # share at every key, and its q and k none
    assert not bool(got[1][:2][pad[:2]].any() or got[2][:2][pad[:2]].any())
    assert bool(got[2][2].all()) and not bool(got[0][2].any() or got[1][2].any())


@pytest.mark.parametrize("case", ["self", "cross"])
def test_fused_layer_route_has_no_split(case, monkeypatch):
    """The module's kernel route (``_flash_enabled`` patched on, CPU tensors
    through the plain versions) of a self-attention and of a cross-attention
    whose key is its value: the same output and input and parameter
    gradients as its einsum route, the all-masked item's uniform rows
    included, and no split, slice or concatenation in the graph between the
    attention and the layer's input (q, k and v are read as views of the
    packed projections)."""
    rng = np.random.default_rng(4)
    b, lq, width, heads = 3, 12, 32, 4
    lk = lq if case == "self" else 17
    pad = torch.zeros((b, lk), dtype=torch.bool)
    pad[1] = True
    pad[2, 5:] = True
    torch.manual_seed(1)
    mha = layers.TorchMultiHeadAttention(width, heads)
    x = torch.from_numpy(rng.normal(size=(b, lq, width)).astype(np.float32))
    mem = torch.from_numpy(rng.normal(size=(b, lk, width)).astype(np.float32))
    outs, grads = [], []
    for flash in (True, False):
        monkeypatch.setattr(layers, "_flash_enabled", lambda t, flash=flash: flash)
        mha.zero_grad(set_to_none=True)
        xi, mi = x.clone().requires_grad_(True), mem.clone().requires_grad_(True)
        o = mha(xi, xi, xi, pad) if case == "self" else mha(xi, mi, mi, pad)
        if flash:
            names = _graph(o, xi) if case == "self" else _graph(o, xi, mi)
            assert "PackedFlashAttentionBackward" in names
            assert not _copies(names), names
        o.sum().backward()
        outs.append(o.detach())
        grads.append((xi.grad, None if case == "self" else mi.grad,
                      mha.in_proj_weight.grad.clone()))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=1e-6)
    for g, w in zip(grads[0], grads[1]):
        if w is not None:
            torch.testing.assert_close(g, w, rtol=0, atol=1e-5)
