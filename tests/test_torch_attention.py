"""Parity of the port's inference attention (the plain version of
``afford_motion_torch.ops.cuda.attention`` and its routing in
``afford_motion_torch.models.layers``) with the JAX package's on the CPU.

Inputs come from a seed with numpy; rows are compared where a query has at
least one valid key (a fully masked row has no defined result on either
side). Tolerances: against the JAX einsum path ``_attention`` in float32,
1e-5 abs (float32 sums in other orders, values O(1)); in bfloat16 one bf16
ulp of the largest value (the einsum path rounds its weights to bf16, the
fused path keeps float32 accumulators and rounds once); against
``_flash_attention`` with the library kernel replaced by its own reference
``mha_reference``, that substitution's 5e-2, as the JAX package's own test of
the wiring uses.
"""
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


def test_flash_gate_conditions(monkeypatch):
    """The fused path is taken under the JAX package's gate and no other: the
    switch, no active dropout on the weights, a head dimension that is a
    multiple of 8. The switch itself is the variable AND a CUDA tensor."""
    calls = []
    real = tattn.attention_cuda

    def counting(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(tlayers, "attention_cuda", counting)
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
    odd(x[..., :24], x[..., :24], x[..., :24], pad)
    assert len(calls) == 2


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
