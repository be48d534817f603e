"""Parity of the port's differentiable fused attention (``FlashAttention`` in
``afford_motion_torch.ops.cuda.attention``, its plain forward and backward,
and its routing in ``afford_motion_torch.models.layers``) with the JAX
package's flash path on the CPU.

The JAX side runs the library's real Pallas forward and backward kernels
(``flash_attention`` and its ``custom_vjp``: ``_flash_attention_bwd_dkv``,
``_flash_attention_bwd_dq``) in TPU interpret mode, through the package's own
``_flash_attention`` wrapper; ``mha_reference_no_custom_vjp`` at ``highest``
precision is a second reference. Inputs come from a seed with numpy.
Tolerances, each an atol as a share of the tensor's largest entry (plus,
for bf16, ``2^-7 |reference|``, one bf16 ulp): float32 1e-5 (float32 sums in
other orders; the library normalises by 1/l where the port subtracts the
log-sum-exp; the readings are 2^-20.4 at most against either reference);
bfloat16 2^-6 (each side rounds its own output, P and dS to bf16, so a
weight or a dS entry that rounds the other way moves a gradient entry by
its ulp times the other operand; the readings are 2^-8.2 at most).

The CUDA kernels' order (tiles of 64 (bf16) or 32 (f32) rows summed in order,
P from the log-sum-exp in base 2 for bf16; the f32 kernel's own order is
modelled step for step in ``tests/test_torch_attention_bwd_f32_design.py``)
is emulated here in torch and held to half of ``TOLERANCE_BWD``, the figure ``chip_smoke.py`` holds the
kernels to on the card; the same emulation with a fault planted (a key tile
skipped, di left out, the mask missing in the backward, a key tile's dq part
left out of the ordered dq sum or added twice) must need more than 4 times
it. P left unrounded before dV stays inside any elementwise limit; the share
of dv entries that differ from the plain version's tells it apart
(``DV_DIFFER_SHARE``).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from afford_motion_tpu.models import layers as jlayers
from afford_motion_torch.models import layers as tlayers
from afford_motion_torch.ops.cuda import attention as tattn

BF16_ULP = 2.0 ** -7


def _inputs(seed, b, lq, lk, heads, hd, masked):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, lq, heads * hd)).astype(np.float32)
    k, v = (rng.normal(size=(b, lk, heads * hd)).astype(np.float32) for _ in range(2))
    do = rng.normal(size=(b, lq, heads * hd)).astype(np.float32)
    pad = np.zeros((b, lk), dtype=bool)
    if masked:
        pad[0, lk * 5 // 7:] = True   # torch convention: True = leave this key out
        pad[1, lk - 3:] = True
    return q, k, v, do, pad


def _assert_close(got, want, share, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    limit = share * np.abs(want).max() + rtol * np.abs(want)
    excess = np.abs(got - want) - limit
    assert (excess <= 0).all(), f"{what}: {excess.max():.3e} beyond the limit"


def _jax_flash_vjp(q, k, v, do, heads, pad, dtype):
    """The JAX package's flash path, forward and VJP, the library's Pallas
    kernels run in TPU interpret mode."""
    jq, jk, jv, jdo = (jnp.asarray(x).astype(dtype) for x in (q, k, v, do))
    with pltpu.force_tpu_interpret_mode():
        o, vjp = jax.vjp(lambda a, b, c: jlayers._flash_attention(a, b, c, heads,
                                                                  jnp.asarray(pad)), jq, jk, jv)
        grads = vjp(jdo)
    return [np.asarray(x.astype(jnp.float32)) for x in (o, *grads)]


def _jax_reference_vjp(q, k, v, do, heads, pad):
    """``mha_reference_no_custom_vjp`` (plain jnp, differentiated by JAX) at
    ``highest`` precision, float32, on the unpadded heads-first layout."""
    from jax.experimental.pallas.ops.tpu import flash_attention as fa

    b, lq, d = q.shape
    hd = d // heads

    def f(a, bb, c):
        def split(x):
            return x.reshape(b, -1, heads, hd).transpose(0, 2, 1, 3)

        seg = fa.SegmentIds(q=jnp.zeros((b, lq), jnp.int32), kv=jnp.asarray(pad, jnp.int32))
        out = fa.mha_reference_no_custom_vjp(split(a), split(bb), split(c), segment_ids=seg,
                                             sm_scale=hd ** -0.5)
        return out.transpose(0, 2, 1, 3).reshape(b, lq, d)

    with jax.default_matmul_precision("highest"):
        o, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
        grads = vjp(jnp.asarray(do))
    return [np.asarray(x) for x in (o, *grads)]


def _port_vjp(q, k, v, do, heads, pad, dtype):
    tq, tk, tv = (torch.from_numpy(x).to(dtype).requires_grad_(True) for x in (q, k, v))
    o = tattn.attention_cuda(tq, tk, tv, heads, torch.from_numpy(pad))
    assert o.grad_fn is not None and o.dtype == dtype
    grads = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do).to(dtype))
    return [x.detach().float().numpy() for x in (o, *grads)]


@pytest.mark.parametrize("dtype,masked,length,hd", [
    ("float32", True, 70, 8),
    ("float32", False, 130, 40),
    ("float32", True, 130, 64),
    ("bfloat16", True, 70, 64),
    ("bfloat16", False, 70, 40),
    ("bfloat16", True, 130, 8),
    ("bfloat16", False, 130, 64),
])
def test_flash_attention_matches_jax_pallas_vjp(dtype, masked, length, hd):
    """FlashAttention's plain forward and backward against the library's
    Pallas forward and backward kernels (interpret mode)."""
    heads = 2
    q, k, v, do, pad = _inputs(11, 2, length, length, heads, hd, masked)
    want = _jax_flash_vjp(q, k, v, do, heads, pad, getattr(jnp, dtype))
    got = _port_vjp(q, k, v, do, heads, pad, getattr(torch, dtype))
    f32 = dtype == "float32"
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        share = 1e-5 if f32 else 2.0 ** -6
        _assert_close(g, w, share, 0.0 if f32 else BF16_ULP, f"{dtype} {name}")
    if masked:   # masked keys get exactly zero gradients
        for g in got[2:]:
            assert not np.abs(g[pad]).any()
    if f32:
        ref = _jax_reference_vjp(q, k, v, do, heads, pad)
        for name, g, w in zip(("o", "dq", "dk", "dv"), got, ref):
            _assert_close(g, w, 1e-5, 0.0, f"reference {name}")


def test_flash_attention_needs_no_stats_without_grad():
    """The forward keeps nothing, and gives no graph, unless a gradient is
    asked for; the statistics are the log-sum-exp, +inf for a row with no
    attended key."""
    q, k, v, _, pad = _inputs(12, 2, 20, 20, 2, 8, True)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tpad = torch.from_numpy(pad)
    assert tattn.attention_cuda(tq, tk, tv, 2, tpad).grad_fn is None
    with torch.no_grad():
        assert tattn.attention_cuda(tq.requires_grad_(True), tk, tv, 2, tpad).grad_fn is None
    o, lse = tattn.attention_forward_cuda(tq, tk, tv, 2, tpad, stats=True)
    assert lse.shape == (2, 2, 20) and lse.dtype == torch.float32
    logits = torch.einsum("bqhc,bkhc->bhqk", tq.reshape(2, 20, 2, 8), tk.reshape(2, 20, 2, 8))
    logits = (logits * 8 ** -0.5).masked_fill(tpad[:, None, None, :], -math.inf)
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1), rtol=0, atol=1e-6)
    none = torch.ones_like(tpad)
    _, lse = tattn.attention_forward_cuda(tq, tk, tv, 2, none, stats=True)
    assert bool((lse == math.inf).all())
    grads = tattn.attention_backward_plain(tq, tk, tv, torch.zeros_like(tq), tq, lse, 2, none)
    assert all(not bool(g.any()) for g in grads)


def test_attention_backward_wrapper_routes_cpu_to_plain():
    q, k, v, do, pad = (torch.from_numpy(x) for x in _inputs(13, 2, 20, 24, 4, 8, True))
    o, lse = tattn.attention_forward_cuda(q, k, v, 4, pad, stats=True)
    before = tattn.attention_backward_cuda.launches
    got = tattn.attention_backward_cuda(q, k, v, o, do, lse, 4, pad)
    want = tattn.attention_backward_plain(q, k, v, o, do, lse, 4, pad)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tattn.attention_backward_cuda.launches == before
    good = dict(q=q, k=k, v=v, o=o, do=do, lse=lse, num_heads=4, pad_mask=pad)
    for bad in (dict(o=o.double()), dict(do=do[:, :10]), dict(lse=lse[:, :2]),
                dict(lse=lse.double()), dict(pad_mask=pad[:, :5])):
        with pytest.raises(ValueError):
            tattn.attention_backward_cuda(**{**good, **bad})


# ------------------------------------------------ the kernels' order, emulated
LOG2E = torch.tensor(math.log2(math.e), dtype=torch.float32)
LN2 = torch.tensor(math.log(2.0), dtype=torch.float32)


def _heads(x, heads):
    b, n, d = x.shape
    return x.float().reshape(b, n, heads, d // heads).transpose(1, 2)


def _kernel_lse(q, k, heads, pad):
    """The bf16 forward kernel's statistics: base-2 maximum and sum,
    (m + log2 l) ln 2, +inf for a row with no attended key."""
    scale_log2 = torch.tensor((q.shape[-1] // heads) ** -0.5, dtype=torch.float32) * LOG2E
    s = torch.matmul(_heads(q, heads), _heads(k, heads).transpose(-1, -2)) * scale_log2
    if pad is not None:
        s = s.masked_fill(pad[:, None, None, :], -math.inf)
    m = s.amax(-1, keepdim=True)
    l = torch.exp2(s - torch.where(m == -math.inf, 0.0, m)).sum(-1)
    return torch.where(l > 0, (m[..., 0] + torch.log2(l)) * LN2, math.inf)


def _kernel_backward(q, k, v, o, do, lse, heads, pad, fault=None):
    """csrc/attention.cu's backward order in torch: di over the rounded o
    (bf16: computed in the dK/dV kernel's walk from its staged o and dO
    tiles; f32: by the di pass); dK/dV walks the query tiles of each key tile
    in order; dQ sums each key tile's part, dS K with dS rounded to the type
    (bf16: the dS^T tiles dK/dV wrote), over the key tiles in order into
    f32; tiles with no attended key skipped; each tile's products summed in
    f32, operands rounded to the type where the kernel rounds them; bf16
    takes P as exp2 of base-2 logits less lse log2(e). ``fault`` plants a
    kernel's fault: "skip tile" leaves out the first key tile, "no di" takes
    di as 0, "no mask" attends masked keys in the backward, "P unrounded"
    feeds dV the float32 P, "dq tile dropped" leaves the first key tile's
    part out of dq, "dq tile twice" adds it twice."""
    b, lq, d = q.shape
    lk = k.shape[1]
    hd = d // heads
    dt = q.dtype
    bf = dt == torch.bfloat16
    tile = 64 if bf else 32
    scale = torch.tensor(hd ** -0.5, dtype=torch.float32)

    def rnd(x):
        return x.to(dt).float()

    def probs(s, rows):
        return torch.exp2(s * (scale * LOG2E) - rows * LOG2E) if bf else torch.exp(s * scale - rows)

    qh, kh, vh, oh, doh = (_heads(x, heads) for x in (q, k, v, o, do))
    di = (oh * doh).sum(-1, keepdim=True)
    if fault == "no di":
        di = torch.zeros_like(di)
    keep = torch.ones(b, lk, dtype=torch.bool) if pad is None or fault == "no mask" else ~pad
    tiles = [(k0, min(k0 + tile, lk)) for k0 in range(0, lk, tile)]
    if fault == "skip tile":
        tiles = tiles[1:]
    dq, dk, dv = torch.zeros(b, heads, lq, hd), torch.zeros(b, heads, lk, hd), torch.zeros(
        b, heads, lk, hd)
    for k0, k1 in tiles:
        if not bool(keep[:, k0:k1].any()):
            continue
        kt, vt, kk = kh[:, :, k0:k1], vh[:, :, k0:k1], keep[:, None, k0:k1, None]
        for i0 in range(0, lq, tile):
            i1 = min(i0 + tile, lq)
            qt, dot = qh[:, :, i0:i1], doh[:, :, i0:i1]
            pt = torch.where(kk, probs(torch.matmul(kt, qt.transpose(-1, -2)),
                                       lse[:, :, None, i0:i1]), 0.0)
            dv[:, :, k0:k1] += torch.matmul(pt if fault == "P unrounded" else rnd(pt), dot)
            dst = (torch.matmul(vt, dot.transpose(-1, -2)) - di[:, :, None, i0:i1, 0]) * pt * scale
            dk[:, :, k0:k1] += torch.matmul(rnd(dst), qt)
        p = torch.where(keep[:, None, None, k0:k1],
                        probs(torch.matmul(qh, kt.transpose(-1, -2)), lse[..., None]), 0.0)
        ds = (torch.matmul(doh, vt.transpose(-1, -2)) - di) * p * scale
        part = torch.matmul(rnd(ds), kt)
        first = k0 == tiles[0][0]
        if not (fault == "dq tile dropped" and first):
            dq += part
        if fault == "dq tile twice" and first:
            dq += part

    def back(x, n):
        return x.transpose(1, 2).reshape(b, n, d).to(dt)

    return back(dq, lq), back(dk, lk), back(dv, lk)


def _case(name, dtype):
    """The denoiser's attention (B 2 here, 326 tokens: time, text, 128
    contact, 196 motion frames whose padding is masked; 8 heads of 64), and
    off the path at head dimensions 8, 40 and 64 with 150 keys (133 at 64):
    one item with every key, one with a masked tile of 64 keys between
    attended ones, one with a single attended key."""
    rng = np.random.default_rng(17)
    if name.startswith("denoiser"):
        b, n, heads, hd = 2, 326, 8, 64
        frames = np.arange(196)[None, :] >= np.array([[60], [170]])
        pad = torch.from_numpy(np.concatenate([np.zeros((b, n - 196), bool), frames], 1))
        if name.endswith("no mask"):
            pad = None
    else:
        hd = int(name[3:])
        b, n, heads = 3, 133 if hd == 64 else 150, 2
        pad = torch.from_numpy(np.arange(n)[None, :] >= np.array([[n], [n - 50], [1]]))
        pad[:2, 64:128] = True
    q, k, v, do = (torch.from_numpy(rng.normal(size=(b, n, heads * hd)).astype(np.float32))
                   .to(dtype) for _ in range(4))
    o = tattn.attention_plain(q, k, v, heads, pad)
    return q, k, v, o, do, heads, pad


CASES = ["denoiser", "denoiser no mask", "hd=8", "hd=40", "hd=64"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", CASES)
def test_kernel_order_within_half_tolerance(case, dtype):
    q, k, v, o, do, heads, pad = _case(case, dtype)
    lse = tattn.attention_lse_plain(q, k, heads, pad)
    want = tattn.attention_backward_plain(q, k, v, o, do, lse, heads, pad)
    kernel_lse = _kernel_lse(q, k, heads, pad) if dtype == torch.bfloat16 else lse
    got = _kernel_backward(q, k, v, o, do, kernel_lse, heads, pad)
    atol, rtol = tattn.TOLERANCE_BWD[dtype]
    assert tattn.backward_excess(got, want, rtol) <= atol / 2
    if dtype == torch.bfloat16:
        assert float((got[2] != want[2]).float().mean()) <= tattn.DV_DIFFER_SHARE / 2
    if pad is not None:
        assert all(not bool(g[pad].any()) for g in got[1:])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("fault,case", [
    ("skip tile", "denoiser"), ("skip tile", "hd=40"),
    ("no di", "denoiser"), ("no di", "denoiser no mask"),
    ("no mask", "denoiser"), ("no mask", "hd=8"),
    ("dq tile dropped", "denoiser"), ("dq tile twice", "hd=40"),
])
def test_kernel_order_with_a_fault_breaks_tolerance(fault, case, dtype):
    q, k, v, o, do, heads, pad = _case(case, dtype)
    lse = tattn.attention_lse_plain(q, k, heads, pad)
    want = tattn.attention_backward_plain(q, k, v, o, do, lse, heads, pad)
    got = _kernel_backward(q, k, v, o, do, lse, heads, pad, fault=fault)
    atol, rtol = tattn.TOLERANCE_BWD[dtype]
    assert tattn.backward_excess(got, want, rtol) > 4 * atol


@pytest.mark.parametrize("case", ["denoiser", "hd=8", "hd=64"])
def test_unrounded_p_passes_elementwise_but_not_the_dv_share(case):
    """No elementwise limit tells a kernel that leaves P unrounded before dV
    from one that rounds it: the rounding moves dv by less than its own
    final rounding. The share of dv entries that differ from the plain
    version's does, by more than 4 times ``DV_DIFFER_SHARE``."""
    q, k, v, o, do, heads, pad = _case(case, torch.bfloat16)
    lse = tattn.attention_lse_plain(q, k, heads, pad)
    want = tattn.attention_backward_plain(q, k, v, o, do, lse, heads, pad)
    got = _kernel_backward(q, k, v, o, do, _kernel_lse(q, k, heads, pad), heads, pad,
                           fault="P unrounded")
    atol, rtol = tattn.TOLERANCE_BWD[torch.bfloat16]
    assert tattn.backward_excess(got, want, rtol) <= atol
    assert float((got[2] != want[2]).float().mean()) > 4 * tattn.DV_DIFFER_SHARE


# --------------------------------------------------------- through the layers
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mha_train_mode_flash_gradients_match_einsum(dtype, monkeypatch):
    """TorchMultiHeadAttention in train mode with dropout 0 takes the fused
    route, which now carries gradients: in_proj_weight.grad is non-zero and
    within 1e-5 (f32) or 2^-5 (bf16, where the routes round in other places)
    of the einsum route's, relative to its largest entry."""
    x, _, _, g, pad = (torch.from_numpy(a) for a in _inputs(14, 2, 40, 40, 4, 16, True))
    torch.manual_seed(0)
    mha = tlayers.TorchMultiHeadAttention(64, 4, dtype=dtype, dropout=0.0).train()
    grads = []
    for fused in (True, False):
        monkeypatch.setattr(tlayers, "_flash_enabled", lambda t, fused=fused: fused)
        mha.zero_grad(set_to_none=True)
        out = mha(x, x, x, pad)
        assert (out.grad_fn is not None)
        out.float().backward(g)
        grads.append({n: p.grad.clone() for n, p in mha.named_parameters()})
    for name in ("in_proj_weight", "in_proj_bias", "out_proj.weight"):
        fused, plain = grads[0][name], grads[1][name]
        scale = float(plain.abs().max())
        assert scale > 0 and float(fused.abs().max()) > 0.5 * scale, name
        limit = (1e-5 if dtype == torch.float32 else 2.0 ** -5) * scale
        assert float((fused - plain).abs().max()) <= limit, name


def test_cmdm_train_step_with_flash_matches_jax(monkeypatch):
    """One whole train step (and two more) of the small CMDM of
    ``tests/test_torch_train.py`` (2 layers, latent 64, 4 heads of 16,
    dropout 0, batch 4, its batch and weights) with the fused attention
    forced on both sides: the JAX package's step through the library's
    Pallas forward and backward in interpret mode, the port's through
    FlashAttention. Loss, gradients and updated parameters within that
    file's tolerances (its ``_compare_train_steps``)."""
    import test_torch_train as ttt
    from afford_motion_tpu.models.cmdm import CMDM as JaxCMDM
    from afford_motion_tpu.ops.hierarchy import build_point_hierarchy, geometry_to_arrays

    # test_torch_train.py's ``setup`` fixture, built here once more
    rng = np.random.default_rng(3)
    xyz = rng.normal(size=(ttt.B, ttt.N, 3)).astype(np.float32)
    levels = build_point_hierarchy(jnp.asarray(xyz), (1, 4, 4, 4), (8, 16, 16, 16),
                                   with_up=False, knn_method="exact")
    x_mask = np.zeros((ttt.B, ttt.L), dtype=bool)
    x_mask[1, 15:] = True
    x_mask[3, 20:] = True
    arrays = {
        "c_pc_xyz": xyz,
        "c_pc_contact": rng.uniform(size=(ttt.B, ttt.N, 6)).astype(np.float32),
        "text_emb": rng.normal(size=(ttt.B, 1, ttt.TEXT)).astype(np.float32),
        "c_pc_erase": np.array([[0.0], [1.0], [0.0], [0.0]], dtype=np.float32),
        "x_mask": x_mask,
    }
    geo = {k: np.asarray(v) for k, v in geometry_to_arrays(levels, prefix="geo_sm").items()}
    jcond = {k: jnp.asarray(v) for k, v in arrays.items()}
    jcond["levels_sm"] = levels
    tcond = {k: torch.tensor(v) for k, v in {**arrays, **geo}.items()}
    x = rng.normal(size=(ttt.B, ttt.L, ttt.D)).astype(np.float32)
    jm = JaxCMDM(**ttt.ARCH, dropout=0.0)
    init = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.zeros((ttt.B,), jnp.int32), jcond)
    variables = jax.device_get({"params": init["params"], "batch_stats": init["batch_stats"]})
    ts = [np.array([10, 700, 0, 999]), np.array([5, 250, 640, 31]), np.array([900, 1, 77, 420])]
    noises = [rng.standard_normal((ttt.B, ttt.L, ttt.D)).astype(np.float32) for _ in ts]
    setup = dict(jm=jm, ts=ts, noises=noises)

    calls, traced = [], []
    real, real_jax = tattn.FlashAttention.apply, jlayers._flash_attention

    def counting(*args):
        calls.append(args[5])
        return real(*args)

    def tracing(*args):
        traced.append(1)
        return real_jax(*args)

    monkeypatch.setattr(jlayers, "_flash_attention", tracing)
    monkeypatch.setattr(jlayers, "_flash_enabled", lambda: True)
    monkeypatch.setattr(tlayers, "_flash_enabled", lambda t: True)
    monkeypatch.setattr(tattn.FlashAttention, "apply", counting)
    with pltpu.force_tpu_interpret_mode():
        ttt._compare_train_steps(setup, variables, jcond, tcond, x, ttt._torch_model(variables),
                                 0.0, 0)
    # every layer of every step took the fused route, with a gradient; the
    # JAX step's trace went through the library kernel at both layers
    assert calls == [True] * (2 * 3) and len(traced) >= 2


@pytest.mark.parametrize("override,p", [("model.dropout=0", 0.0), (None, 0.1)])
def test_config_dropout_reaches_every_dropout(override, p):
    """``model.dropout`` of the flagship train config reaches every Dropout
    of the CMDM (the positional encoding's, and per layer the attention
    weights', the FFN activation's and both residual branches', the last
    three one module): with 0, the JAX gate ``not train or dropout == 0``
    routes training to the fused attention."""
    from afford_motion_torch.models.cmdm import build_cmdm
    from afford_motion_torch.utils.config import load_config

    argv = ["task=text_to_motion_contact_motion_gen", "model=cmdm", "model.arch=trans_enc",
            "model.input_feats=263"]   # the entry sets it from the data representation
    cfg = load_config("configs", argv + ([override] if override else []))
    model = build_cmdm(cfg.model)
    drops = [m for m in model.modules() if isinstance(m, tlayers.Dropout)]
    assert len(drops) == 2 * sum(cfg.model.num_layers) + 1
    assert all(d.p == p for d in drops)
    assert model.positional_encoder.dropout.p == p
    for layer in model.self_attn_layer.layers:
        assert layer.self_attn.dropout.p == p and layer.dropout.p == p
