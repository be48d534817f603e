"""The backward of the port's ``gather_rows`` (the ordered scatter-add, plain
version, CPU) against the JAX package's Pallas scatter kernel.

The JAX side calls ``afford_motion_tpu.ops.pallas.gather.gather_rows``
directly, which runs ``_scatter_kernel`` in interpret mode off the TPU (the
JAX model's own ``bgather`` takes ``jnp.take`` on the CPU and would not reach
the kernel). Both sides add a destination row's contributions in ascending
flat position ``m * K + k``, from zero, in float32, and an add has one
correctly rounded result, so float32 gradients must be bit-equal, and
bfloat16 gradients bit-equal after the one final cast. A float64 numpy
oracle (``np.add.at``) bounds the rounding (1e-5 relative to each case's
largest sum) and ``torch.autograd.gradcheck`` holds the Function to finite
differences in float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afford_motion_tpu.ops.pallas.gather import gather_rows as jax_gather_rows
from afford_motion_torch.ops.cuda.gather import (
    gather_rows,
    scatter_add_rows,
    scatter_add_rows_plain,
)

CASES = [  # (B, N, C, M, K, index range)
    pytest.param(2, 64, 35, 32, 8, 64, id="k8-c35"),
    pytest.param(2, 96, 67, 24, 16, 96, id="k16-c67"),
    pytest.param(3, 40, 1, 40, 3, 40, id="k3-c1"),
    pytest.param(1, 50, 67, 128, 16, 7, id="heavy-repeats"),
    pytest.param(2, 64, 35, 16, 8, 20, id="untouched-rows"),
]


def _inputs(B, N, C, M, K, hi, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    idx = rng.integers(0, hi, size=(B, M, K)).astype(np.int32)
    g = rng.normal(size=(B, M, K, C)).astype(np.float32)
    return x, idx, g


def _jax_vjp(x, idx, g, dtype):
    xj = jnp.asarray(x).astype(dtype)
    _, vjp = jax.vjp(lambda v: jax_gather_rows(v, jnp.asarray(idx)), xj)
    (dx,) = vjp(jnp.asarray(g).astype(dtype))
    assert dx.dtype == xj.dtype
    return np.asarray(dx.astype(jnp.float32))


def _torch_vjp(x, idx, g, dtype):
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    before = scatter_add_rows.launches
    out = gather_rows(xt, torch.from_numpy(idx))
    out.backward(torch.from_numpy(g).to(dtype))
    assert xt.grad.dtype == dtype and scatter_add_rows.launches == before  # CPU: plain
    return xt.grad.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B, N, C, M, K, hi", CASES)
def test_vjp_bit_equal_to_pallas_scatter(B, N, C, M, K, hi, dtype):
    x, idx, g = _inputs(B, N, C, M, K, hi)
    want = _jax_vjp(x, idx, g, dtype)
    got = _torch_vjp(x, idx, g, getattr(torch, dtype))
    assert got.shape == (B, N, C)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if hi < N:  # destinations nobody points at stay exactly zero
        assert not got[:, hi:].any() and not want[:, hi:].any()


@pytest.mark.parametrize("B, N, C, M, K, hi", CASES)
def test_plain_scatter_against_float64_oracle(B, N, C, M, K, hi):
    _, idx, g = _inputs(B, N, C, M, K, hi, seed=1)
    want = np.zeros((B, N, C), dtype=np.float64)
    for b in range(B):
        np.add.at(want[b], idx[b].reshape(-1), g[b].reshape(-1, C).astype(np.float64))
    got = scatter_add_rows_plain(torch.from_numpy(g), torch.from_numpy(idx), N).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    # the same sums again: the plain version is deterministic
    again = scatter_add_rows_plain(torch.from_numpy(g), torch.from_numpy(idx), N).numpy()
    np.testing.assert_array_equal(got.view(np.int32), again.view(np.int32))


def test_plain_scatter_sums_in_ascending_position():
    """1e8 + 1 - 1e8 depends on the order in float32: ascending positions
    give (1e8 + 1) - 1e8 = 0, any other order gives 1."""
    g = torch.tensor([1e8, 1.0, -1e8], dtype=torch.float32).reshape(1, 3, 1, 1)
    idx = torch.zeros((1, 3, 1), dtype=torch.int32)
    assert scatter_add_rows_plain(g, idx, 2).reshape(-1).tolist() == [0.0, 0.0]
    g2 = torch.tensor([1e8, -1e8, 1.0], dtype=torch.float32).reshape(1, 3, 1, 1)
    assert scatter_add_rows_plain(g2, idx, 2).reshape(-1).tolist() == [1.0, 0.0]


def test_gradcheck_float64():
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(size=(2, 9, 3)), dtype=torch.float64, requires_grad=True)
    idx = torch.tensor(rng.integers(0, 7, size=(2, 5, 4)), dtype=torch.int32)
    assert torch.autograd.gradcheck(lambda v: gather_rows(v, idx), (x,))


def test_wrappers_raise_on_bad_arguments():
    g = torch.zeros((2, 4, 3, 5))
    with pytest.raises(ValueError, match="does not match"):
        scatter_add_rows(g, torch.zeros((2, 4, 2), dtype=torch.int32), 6)
    with pytest.raises(ValueError, match="bad shapes"):
        scatter_add_rows(g[0], torch.zeros((2, 4, 3), dtype=torch.int32), 6)
    with pytest.raises(ValueError, match="bad shapes"):
        gather_rows(torch.zeros((2, 6)), torch.zeros((2, 4, 3), dtype=torch.int32))
