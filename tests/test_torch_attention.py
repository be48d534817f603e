"""Parity of the port's inference attention (the plain version of
``afford_motion_torch.ops.cuda.attention`` and its routing in
``afford_motion_torch.models.layers``) with the JAX package's on the CPU.

Inputs come from a seed with numpy; rows are compared where a query has at
least one valid key (a fully masked row has no defined result on either
side). Tolerances: against the JAX einsum path ``_attention`` in float32,
1e-5 abs (float32 sums in other orders, values O(1)); in bfloat16 (both
round the softmax weights to bf16 before they weight v) one bf16 ulp of the
result, but for the rare weight whose float32 value lies on a bf16 rounding
boundary, where XLA's exp and torch's differ in the last bit; against
``_flash_attention`` with the library kernel replaced by its own reference
``mha_reference``, that substitution's 5e-2, as the JAX package's own test of
the wiring uses. The CUDA kernel's bf16 order (64-key tiles, online softmax,
weights rounded to bf16 against the running maximum) is emulated here in
torch and held to ``TOLERANCE``, the figure ``chip_smoke.py`` holds the
kernel to on the card, with a margin of 2; the same emulation with a fault
planted (an attended key left out, the last tile skipped) must break it. So
is the f32 instance's order (32-key tiles, an online softmax in base e), to
half of ``TOLERANCE[float32]``, with the last tile skipped breaking it. The
kernels address q, k and v by a row pitch each (views of one packed
projection, ``model.fused_qkv``): the bf16 emulation on rows read from a
packed buffer by that rule gives the contiguous bits, and a pitch left out
breaks the tolerance.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afford_motion_tpu.models import layers as jlayers
from afford_motion_torch.models import layers as tlayers
from afford_motion_torch.ops.cuda import attention as tattn


def _qkv(seed, b, lq, lk, d, masked=True):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, n, d)).astype(np.float32) for n in (lq, lk, lk))
    pad = np.zeros((b, lk), dtype=bool)
    if masked:
        pad[0, lk * 5 // 7:] = True   # torch convention: True = leave this key out
        pad[1, lk - 3:] = True
    return q, k, v, pad


@pytest.mark.parametrize("lq,lk,d,heads,masked", [
    (70, 70, 32, 4, True),
    (70, 70, 32, 4, False),
    (33, 50, 64, 8, True),     # cross attention: other key length, head dim 8
    (196, 196, 128, 2, True),  # head dim 64
])
def test_attention_plain_matches_jax_einsum(lq, lk, d, heads, masked):
    q, k, v, pad = _qkv(0, 2, lq, lk, d, masked)
    jpad = jnp.asarray(pad) if masked else None
    tpad = torch.from_numpy(pad) if masked else None
    want = np.asarray(jlayers._attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
                                         jpad, lambda x: x))
    got = tattn.attention_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                heads, tpad)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, lq, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # the port's own default path is the same function
    default = tlayers._attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 heads, tpad, lambda x: x)
    np.testing.assert_allclose(got.numpy(), default.numpy(), rtol=0, atol=1e-5)


def test_attention_plain_bf16_matches_jax_einsum():
    q, k, v, pad = _qkv(1, 2, 70, 70, 64)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jlayers._attention(jq, jk, jv, 4, jnp.asarray(pad), lambda x: x)
                      .astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = tattn.attention_plain(tq, tk, tv, 4, torch.from_numpy(pad))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0 ** -7 * np.abs(want).max())


def _bf16_ulp(x):
    """One bf16 ulp of |x| (2^(e - 7) for 2^e <= |x| < 2^(e + 1))."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


@pytest.mark.parametrize("b,lq,lk,heads,hd,masked", [
    (2, 70, 70, 2, 64, True),
    (2, 70, 70, 2, 64, False),
    (2, 33, 50, 8, 64, True),
    (2, 326, 326, 8, 64, True),    # the denoiser's width and length
    (2, 70, 70, 4, 16, True),
])
def test_attention_plain_bf16_within_an_ulp_of_jax_einsum(b, lq, lk, heads, hd, masked):
    q, k, v, pad = _qkv(6, b, lq, lk, heads * hd, masked)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jlayers._attention(jq, jk, jv, heads, jnp.asarray(pad), lambda x: x)
                      .astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = tattn.attention_plain(tq, tk, tv, heads, torch.from_numpy(pad)).float().numpy()
    diff = np.abs(got - want)
    ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert (diff > ulp).mean() <= 1e-3
    # a weight that rounds the other way moves the result by at most its own
    # bf16 ulp (2^-8 of it, which is at most 1) times |v|
    assert (diff <= ulp + 2.0 ** -8 * np.abs(v).max()).all()


def _tiled_bf16_attention(q, k, v, num_heads, pad_mask, tile=64, fault=None):
    """The order of csrc/attention.cu's bf16 instance in torch: logits in
    float32 pre-scaled by log2(e), tiles of 64 keys, a tile with no attended
    key skipped, online softmax in base 2 against the running maximum, the
    unnormalised weights rounded to bf16 before they weight v, the sums of
    the unrounded weights in float32, one division and one rounding.
    ``fault`` plants a kernel's fault: "first key" or "last key" leaves out
    each item's first or last attended key, "last tile" skips the last tile."""
    B, Lq, D = q.shape
    Lk = k.shape[1]
    hd = D // num_heads
    qh, kh, vh = (x.float().reshape(B, -1, num_heads, hd).transpose(1, 2) for x in (q, k, v))
    scale = torch.tensor(hd ** -0.5, dtype=torch.float32) * torch.tensor(math.log2(math.e),
                                                                        dtype=torch.float32)
    keep = torch.ones(B, Lk, dtype=torch.bool) if pad_mask is None else ~pad_mask
    if fault in ("first key", "last key"):
        order = keep.int() if fault == "first key" else keep.int().flip(1)
        at = order.argmax(1) if fault == "first key" else Lk - 1 - order.argmax(1)
        keep[torch.arange(B), at] = False
    m = torch.full((B, num_heads, Lq, 1), -math.inf)
    l = torch.zeros(B, num_heads, Lq, 1)
    acc = torch.zeros(B, num_heads, Lq, hd)
    bases = list(range(0, Lk, tile))
    for base in bases[:-1] if fault == "last tile" else bases:
        kt = keep[:, None, None, base:base + tile]
        if not bool(kt.any()):
            continue
        s = torch.matmul(qh, kh[:, :, base:base + tile].transpose(-1, -2)) * scale
        s = s.masked_fill(~kt, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_use = torch.where(m_new == -math.inf, 0.0, m_new)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(s - m_use)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.bfloat16().float(), vh[:, :, base:base + tile])
        m = m_new
    o = torch.where(l > 0, acc / l, torch.zeros(()))
    return o.transpose(1, 2).reshape(B, Lq, D).to(q.dtype)


def _denoiser_qkv(seed, masked):
    """The denoiser's attention: 8 heads of 64, 326 tokens (time, text, 128
    contact, 196 motion frames whose padding is masked)."""
    rng = np.random.default_rng(seed)
    b, seq, heads, hd = 2, 326, 8, 64
    q, k, v = (torch.from_numpy(rng.normal(size=(b, seq, heads * hd)).astype(np.float32))
               .bfloat16() for _ in range(3))
    pad = None
    if masked:
        frames = np.arange(196)[None, :] >= np.array([[60], [170]])
        pad = torch.from_numpy(np.concatenate([np.zeros((b, seq - 196), bool), frames], 1))
    return q, k, v, heads, pad


def _off_path_qkv(seed, hd):
    """chip_smoke.py's off-path shape: 70 queries, 150 keys, 2 heads; one item
    with every key, one with a masked tile between attended keys, one with a
    single attended key."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(3, 70, 2 * hd)).astype(np.float32)).bfloat16()
    k, v = (torch.from_numpy(rng.normal(size=(3, 150, 2 * hd)).astype(np.float32)).bfloat16()
            for _ in range(2))
    pad = torch.from_numpy(np.arange(150)[None, :] >= np.array([[150], [100], [1]]))
    pad[:2, 64:128] = True
    return q, k, v, 2, pad


def _excess(got, want, v):
    """Largest difference beyond the bf16 tolerance's rtol term, as a share
    of max |v|: the atol the pair needs."""
    _, rtol = tattn.TOLERANCE[torch.bfloat16]
    d = (got.float() - want.float()).abs() - rtol * want.float().abs()
    return float(d.max() / v.float().abs().max())


@pytest.mark.parametrize("case", ["denoiser masked", "denoiser", "hd=8", "hd=40", "hd=64"])
def test_tiled_bf16_order_within_tolerance_of_plain(case):
    q, k, v, heads, pad = (_off_path_qkv(7, int(case[3:])) if case.startswith("hd=")
                           else _denoiser_qkv(7, case.endswith("masked")))
    want = tattn.attention_plain(q, k, v, heads, pad)
    got = _tiled_bf16_attention(q, k, v, heads, pad)
    atol, _ = tattn.TOLERANCE[torch.bfloat16]
    assert _excess(got, want, v) <= atol / 2
    assert bool((got != want).any())   # the orders do differ


@pytest.mark.parametrize("fault,masked", [("first key", True), ("first key", False),
                                          ("last key", True), ("last key", False),
                                          ("last tile", False)])
def test_tiled_bf16_with_a_fault_breaks_tolerance(fault, masked):
    """The tolerance catches a kernel that leaves out one attended key or the
    last tile (326 = 5 x 64 + 6 keys), with a margin of 4."""
    q, k, v, heads, pad = _denoiser_qkv(7, masked)
    want = tattn.attention_plain(q, k, v, heads, pad)
    got = _tiled_bf16_attention(q, k, v, heads, pad, fault=fault)
    atol, _ = tattn.TOLERANCE[torch.bfloat16]
    assert _excess(got, want, v) > 4 * atol


def _rows_at(flat, b, length, pitch, offset, width):
    """The (b, length, width) tensor whose row r of item i the kernels read at
    ``flat[offset + (i length + r) pitch + c]`` (``Pitch`` in
    csrc/attention.cu)."""
    i = torch.arange(b)[:, None, None]
    r = torch.arange(length)[None, :, None]
    c = torch.arange(width)[None, None, :]
    return flat[offset + (i * length + r) * pitch + c]


def _packed_qkv_rows(q, k, v, fault=None):
    """q, k, v stored side by side in one packed (B, L, 3D) buffer and read
    back by the address rule at pitch 3D; ``fault`` "read pitch" reads k and
    v at the contiguous pitch D, as a kernel that ignores the pitch would."""
    b, length, d = q.shape
    flat = torch.cat([q, k, v], dim=-1).reshape(-1)
    return [_rows_at(flat, b, length, d if fault and n else 3 * d, n * d, d) for n in range(3)]


def test_tiled_bf16_on_packed_rows_gives_the_contiguous_bits():
    """The bf16 order on q, k, v read from one packed projection by the row
    pitch: the rows are the views' (bit for bit), so the result is the
    contiguous one's, within half of ``TOLERANCE`` of the plain version."""
    q, k, v, heads, pad = _denoiser_qkv(7, True)
    rows = _packed_qkv_rows(q, k, v)
    assert all(torch.equal(a, b) for a, b in zip(rows, (q, k, v)))
    got = _tiled_bf16_attention(*rows, heads, pad)
    assert torch.equal(got, _tiled_bf16_attention(q, k, v, heads, pad))
    want = tattn.attention_plain(*torch.cat([q, k, v], -1).chunk(3, dim=-1), heads, pad)
    atol, _ = tattn.TOLERANCE[torch.bfloat16]
    assert _excess(got, want, v) <= atol / 2


def test_tiled_bf16_with_the_pitch_left_out_breaks_tolerance():
    """k and v read at the contiguous pitch instead of the packed one break
    the tolerance by more than 4 times."""
    q, k, v, heads, pad = _denoiser_qkv(7, True)
    got = _tiled_bf16_attention(*_packed_qkv_rows(q, k, v, fault="read pitch"), heads, pad)
    want = tattn.attention_plain(q, k, v, heads, pad)
    atol, _ = tattn.TOLERANCE[torch.bfloat16]
    assert _excess(got, want, v) > 4 * atol


def _tiled_f32_attention(q, k, v, num_heads, pad_mask, tile=32, fault=None):
    """The order of csrc/attention.cu's f32 instance in torch: tiles of 32
    keys, a tile with no attended key skipped (and none past the last
    attended key), logits scaled after the dot product, an online softmax in
    base e against the running maximum (the sums and O rescaled once a tile),
    P V summed over the tile's keys, one division at the end. ``fault``:
    "last tile" skips the last tile of keys."""
    B, Lq, D = q.shape
    Lk = k.shape[1]
    hd = D // num_heads
    qh, kh, vh = (x.reshape(B, -1, num_heads, hd).transpose(1, 2) for x in (q, k, v))
    keep = torch.ones(B, Lk, dtype=torch.bool) if pad_mask is None else ~pad_mask
    m = torch.full((B, num_heads, Lq, 1), -math.inf)
    l = torch.zeros(B, num_heads, Lq, 1)
    acc = torch.zeros(B, num_heads, Lq, hd)
    bases = list(range(0, Lk, tile))
    for base in bases[:-1] if fault == "last tile" else bases:
        kt = keep[:, None, None, base:base + tile]
        if not bool(kt.any()):
            continue
        s = torch.matmul(qh, kh[:, :, base:base + tile].transpose(-1, -2)) * hd ** -0.5
        s = s.masked_fill(~kt, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_use = torch.where(m_new == -math.inf, 0.0, m_new)
        alpha = torch.exp(m - m_use)
        p = torch.exp(s - m_use)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, vh[:, :, base:base + tile])
        m = m_new
    o = torch.where(l > 0, acc / l, torch.zeros(()))
    return o.transpose(1, 2).reshape(B, Lq, D)


def _regressor_qkv(seed):
    """The regressor's attention: 4 heads of 64 over 196 frames, the padded
    frames masked (batch 2 here; 16 on the path)."""
    rng = np.random.default_rng(seed)
    b, seq, heads, hd = 2, 196, 4, 64
    q, k, v = (torch.from_numpy(rng.normal(size=(b, seq, heads * hd)).astype(np.float32))
               for _ in range(3))
    pad = torch.from_numpy(np.arange(seq)[None, :] >= np.array([[seq], [70]]))
    return q, k, v, heads, pad


def _f32_case(case):
    if case == "regressor":
        return _regressor_qkv(8)
    q, k, v, heads, pad = _off_path_qkv(8, int(case[3:]))
    return q.float(), k.float(), v.float(), heads, pad


def _f32_excess(got, want, v):
    """Largest difference as a share of max |v|: the atol the pair needs
    (float32's rtol is 0)."""
    return float((got - want).abs().max() / v.abs().max())


@pytest.mark.parametrize("case", ["regressor", "hd=8", "hd=40", "hd=64"])
def test_tiled_f32_order_within_half_tolerance_of_plain(case):
    """The f32 kernel's order, emulated, meets half of ``TOLERANCE[float32]``
    at the regressor's shape and at chip_smoke.py's off-path shapes (70
    queries, 150 keys, a masked 64-key stretch, one item with one key)."""
    q, k, v, heads, pad = _f32_case(case)
    want = tattn.attention_plain(q, k, v, heads, pad)
    got = _tiled_f32_attention(q, k, v, heads, pad)
    atol, _ = tattn.TOLERANCE[torch.float32]
    assert _f32_excess(got, want, v) <= atol / 2
    assert bool((got != want).any())   # the orders do differ


@pytest.mark.parametrize("case", ["regressor", "hd=64"])
def test_tiled_f32_with_the_last_tile_skipped_breaks_tolerance(case):
    """The f32 tolerance catches a kernel that skips the last tile of keys
    (196 = 6 x 32 + 4 keys at the regressor's shape), by more than 4 times."""
    q, k, v, heads, pad = _f32_case(case)
    want = tattn.attention_plain(q, k, v, heads, pad)
    got = _tiled_f32_attention(q, k, v, heads, pad, fault="last tile")
    atol, _ = tattn.TOLERANCE[torch.float32]
    assert _f32_excess(got, want, v) > 4 * atol


def _reference_kernel(q, k, v, ab=None, segment_ids=None, *, sm_scale=1.0, **kw):
    from jax.experimental.pallas.ops.tpu import flash_attention as fa

    return fa.mha_reference(q, k, v, ab, segment_ids, sm_scale=sm_scale)


@pytest.mark.parametrize("masked", [True, False])
def test_attention_plain_matches_jax_flash_wiring(masked, monkeypatch):
    from jax.experimental.pallas.ops.tpu import flash_attention as fa

    monkeypatch.setattr(fa, "flash_attention", _reference_kernel)
    q, k, v, pad = _qkv(2, 2, 70, 70, 32, masked)
    want = np.asarray(jlayers._flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 4,
                                               jnp.asarray(pad) if masked else None))
    got = tattn.attention_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 4,
                                torch.from_numpy(pad) if masked else None)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-2, atol=5e-2)


def test_attention_cuda_wrapper_routes_cpu_to_plain():
    q, k, v, pad = (torch.from_numpy(x) for x in _qkv(3, 2, 20, 24, 32))
    before = tattn.attention_cuda.launches
    got = tattn.attention_cuda(q, k, v, 4, pad)
    assert torch.equal(got, tattn.attention_plain(q, k, v, 4, pad))
    assert tattn.attention_cuda.launches == before
    for bad in (dict(q=q.double()), dict(pad_mask=pad.float()), dict(num_heads=5),
                dict(k=k[:, :5]), dict(pad_mask=pad[:, :5])):
        with pytest.raises(ValueError):
            tattn.attention_cuda(**{**dict(q=q, k=k, v=v, num_heads=4, pad_mask=pad), **bad})
    wide = torch.zeros(1, 4, 256)   # head dimension 128: above the kernel's one instance
    with pytest.raises(ValueError, match="at most 64"):
        tattn.attention_cuda(wide, wide, wide, 2)
    odd = torch.zeros(1, 4, 24, dtype=torch.bfloat16)  # head dimension 12: the CPU takes it
    assert tattn.attention_cuda(odd, odd, odd, 2).shape == odd.shape


def test_flash_gate_conditions(monkeypatch):
    """The fused path is taken under the JAX package's gate and no other: the
    switch, no active dropout on the weights, a head dimension that is a
    multiple of 8. The switch itself is the variable AND a CUDA tensor."""
    calls = []
    real = tattn.attention_qkv_cuda

    def counting(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(tlayers, "attention_qkv_cuda", counting)
    x, _, _, pad = (torch.from_numpy(a) for a in _qkv(4, 2, 12, 12, 32))
    torch.manual_seed(0)
    mha = tlayers.TorchMultiHeadAttention(32, 4, dropout=0.1).eval()
    want = mha(x, x, x, pad)

    # the variable alone does nothing for CPU tensors
    monkeypatch.setenv("AM_FLASH_ATTN", "1")
    assert not tlayers._flash_enabled(x)
    assert torch.equal(mha(x, x, x, pad), want) and not calls
    monkeypatch.delenv("AM_FLASH_ATTN")
    assert not tlayers._flash_enabled(x)

    monkeypatch.setattr(tlayers, "_flash_enabled", lambda t: True)
    got = mha(x, x, x, pad)                      # eval mode: dropout inactive
    assert len(calls) == 1
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=0, atol=1e-5)

    mha.train()                                  # dropout 0.1 active: the default path
    tlayers.set_dropout_generator(mha, torch.Generator().manual_seed(0))
    mha(x, x, x, pad)
    assert len(calls) == 1
    mha0 = tlayers.TorchMultiHeadAttention(32, 4, dropout=0.0).train()
    mha0(x, x, x, pad)                           # train mode with dropout 0: fused
    assert len(calls) == 2
    odd = tlayers.TorchMultiHeadAttention(24, 2).eval()   # head dim 12
    narrow = x[..., :24]
    odd(narrow, narrow, narrow, pad)
    assert len(calls) == 2



@pytest.mark.parametrize("hd,fused", [(64, True), (128, False)])
def test_flash_gate_routes_wide_heads_to_einsum(hd, fused, monkeypatch):
    """With the switch on, a head dimension above the kernel's 64 takes the
    einsum path before any launch (the kernel would refuse it); 64 takes the
    kernel's route."""
    calls = []

    def recording(qkv, num_heads, pad_mask=None):
        calls.append(qkv.shape[-1] // 3 // num_heads)
        return tattn.attention_plain(*qkv.chunk(3, dim=-1), num_heads, pad_mask)

    monkeypatch.setattr(tlayers, "attention_qkv_cuda", recording)
    monkeypatch.setenv("AM_FLASH_ATTN", "1")
    # CPU tensors: the switch stands in for the variable on a card
    monkeypatch.setattr(tlayers, "_flash_enabled", lambda t: True)
    x, _, _, pad = (torch.from_numpy(a) for a in _qkv(5, 2, 12, 12, 2 * hd))
    torch.manual_seed(0)
    mha = tlayers.TorchMultiHeadAttention(2 * hd, 2).eval()
    got = mha(x, x, x, pad)
    assert calls == ([hd] if fused else [])
    monkeypatch.setattr(tlayers, "_flash_enabled", lambda t: False)
    want = mha(x, x, x, pad)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=0, atol=1e-5)


def test_encoder_layer_relu_matches_jax():
    """The regressor's encoder layer: ReLU in place of the CMDM's GELU."""
    from flax import linen as nn

    from afford_motion_torch.utils.convert import _encoder_layer, _state_dict_from_jax

    x, _, _, pad = _qkv(5, 2, 10, 10, 32)
    jl = jlayers.TransformerEncoderLayer(32, 4, 64, 0.1, nn.relu)
    variables = jax.device_get(jl.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x),
                                       jnp.asarray(pad), train=False))
    tl = tlayers.TransformerEncoderLayer(32, 4, 64, dropout=0.1, activation="relu").eval()
    sd = _state_dict_from_jax(variables, _encoder_layer("l", ()))
    tl.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    want = np.asarray(jl.apply(variables, jnp.asarray(x), jnp.asarray(pad), train=False))
    with torch.no_grad():
        got = tl(torch.from_numpy(x), torch.from_numpy(pad)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    gelu = tlayers.TransformerEncoderLayer(32, 4, 64).eval()
    gelu.load_state_dict(tl.state_dict())
    with torch.no_grad():
        assert not np.allclose(gelu(torch.from_numpy(x), torch.from_numpy(pad)).numpy(), got,
                               atol=1e-3)
    with pytest.raises(ValueError):
        tlayers.TransformerEncoderLayer(32, 4, 64, activation="swish")
