"""An emulation of the row gather kernel's addressing (``csrc/gather.cu``),
held bit for bit to ``gather_rows_plain`` and to the JAX package's Pallas
``gather_rows`` (interpret mode on the CPU, as ``tests/test_torch_ops.py``
runs it).

The kernel runs only on the card; ``chip_smoke.py`` holds it to its plain
version there. Here its design is written out in numpy, word for word:

- the output, (B * M * K) rows of C words, is cut into spans of ``span``
  rows; a span's rows get their source offsets ((b * N + idx) * C, b the
  row's cloud, so a span may cross clouds);
- the words before the span's first 16-byte boundary (an output at an
  offset) and after its last (a ragged end) are copied one a lane;
- the 16-byte chunks between are assembled word by word, stepping to the
  next row's offset when a row ends, or (``wide``), where a chunk lies
  inside one source row, read from the one or two aligned 16-byte words
  that hold it, shifted into place.

The source is read as one flat array, so an ``x`` at an offset is a flat
buffer with words in front. Planted faults (a chunk that does not step to
the next row, a span whose start is counted in rows rather than words, the
ragged end left out) must break the equality.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afford_motion_tpu.ops.pallas.gather import gather_rows as jax_gather_rows
from afford_motion_torch.ops.cuda import gather as tg

FILL = {2: 0xA5A5, 4: 0xA5A5A5A5}   # what an output word holds before it is written


def _unaligned_16(xflat, word, elem_bytes):
    """The 16 bytes from word ``word`` of ``xflat`` (whose word 0 is 16-byte
    aligned), as the kernel's load_unaligned reads them: the one or two
    aligned 16-byte words that hold them, 5 32-bit words from the first that
    holds one of them, a 16-bit funnel shift where they are not 4-byte
    aligned."""
    raw = xflat.view(np.uint8)
    a = word * elem_bytes
    q, o = a & ~15, a & 15
    block = raw[q:q + (32 if o else 16)]
    w = np.zeros(8, np.uint32)
    w[:len(block) // 4] = block.view(np.uint32)
    win = w[(o >> 2):(o >> 2) + 5].astype(np.uint64)
    win = np.concatenate([win, np.zeros(5 - len(win), np.uint64)])
    if o & 2:
        out = ((win[:4] >> 16) | (win[1:] << 16)) & 0xFFFFFFFF
    else:
        out = win[:4]
    return out.astype(np.uint32).view(xflat.dtype)


def gather_model(xflat, x_at, idx, n, c, elem_bytes, wide, span, out_at=0, fault=None):
    """The kernel's copy of ``x`` (words ``xflat[x_at:]``, (B, N, C), word 0
    of ``xflat`` 16-byte aligned) by ``idx`` (B, M, K) into a flat output
    whose first word lies ``out_at`` bytes past a 16-byte boundary: returns
    the output words. How many chunks a lane loads before it stores (the
    mode) does not change which word goes where."""
    b_, m, k = idx.shape
    vec = 16 // elem_bytes
    rows_per_batch, rows = m * k, b_ * m * k
    flat_idx = idx.reshape(-1).astype(np.int64)
    # room for the second aligned 16-byte word past the last one that holds x
    xflat = np.concatenate([xflat, np.zeros(2 * vec, xflat.dtype)])
    out = np.full(rows * c, FILL[elem_bytes], dtype=xflat.dtype)
    for s in range(-(-rows // span)):
        row0 = s * span
        nrows = min(span, rows - row0)
        r = np.arange(row0, row0 + nrows)
        off = x_at + ((r // rows_per_batch) * n + flat_idx[r]) * c
        elems = nrows * c
        first = row0 * c if fault != "span start in rows" else row0
        addr = out_at + first * elem_bytes
        head = min(elems, ((16 - addr % 16) % 16) // elem_bytes)
        chunks = (elems - head) // vec
        e = np.arange(head)
        out[first + e] = xflat[off[e // c] + e % c]
        if fault != "no ragged end":
            e = np.arange(head + chunks * vec, elems)
            out[first + e] = xflat[off[e // c] + e % c]
        # a lane's chunk: inside one row and wide, the aligned words; else
        # the words of rows row, row + 1, ... in turn
        for ci in range(chunks):
            e = head + ci * vec
            row, ch = e // c, e % c
            if wide and ch + vec <= c:
                words = _unaligned_16(xflat, off[row] + ch, elem_bytes)
            else:
                words = np.empty(vec, dtype=xflat.dtype)
                for j in range(vec):
                    words[j] = xflat[off[row] + ch]
                    if j + 1 < vec:
                        ch += 1
                        if ch == c:
                            ch = 0
                            row += fault != "no row step"
            out[first + e:first + e + vec] = words
    return out


def _case(c, b, n, m, k, seed, repeated=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, c)).astype(np.float32)
    idx = rng.integers(0, n, size=(b, m, k)).astype(np.int32)
    if repeated:   # every query's neighbours a few rows, many times over
        idx = rng.integers(0, 3, size=(b, m, k)).astype(np.int32) * (n // 3)
    return x, idx


def _words(x, dtype):
    t = torch.from_numpy(x).to(dtype)
    return t, t.view(torch.int16 if dtype == torch.bfloat16 else torch.int32).numpy()


# (C, B, N, M, K): the SceneMap's channel counts; rows a cloud (M * K) off every
# span, so spans cross clouds; totals of words off 16 bytes in bf16
CASES = [(1, 2, 50, 7, 5), (35, 2, 300, 5, 7), (67, 2, 300, 9, 16), (515, 2, 40, 3, 16),
         (8, 3, 64, 5, 3), (33, 2, 70, 11, 3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c,b,n,m,k", CASES)
def test_gather_model_matches_plain_and_pallas(c, b, n, m, k, dtype):
    x, idx = _case(c, b, n, m, k, seed=c + m)
    xt, words = _words(x, dtype)
    want = tg.gather_rows_plain(xt, torch.from_numpy(idx))
    want_words = want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32).numpy()
    jx = jnp.asarray(x).astype(jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    pallas = np.asarray(jax_gather_rows(jx, jnp.asarray(idx)).astype(jnp.float32))
    np.testing.assert_array_equal(want.float().numpy().view(np.int32), pallas.view(np.int32))
    size = xt.element_size()
    for wide, span in sorted({cfg[1:] for cfg in tg.GATHER_CONFIGS}):
        for out_at, x_at in ((0, 0), (size, 3), (16 - size, 1)):
            xflat = np.concatenate([np.zeros(x_at, words.dtype), words.reshape(-1)])
            got = gather_model(xflat, x_at, idx, n, c, size, wide, span, out_at)
            np.testing.assert_array_equal(got, want_words.reshape(-1),
                                          err_msg=f"wide {wide} span {span} out_at {out_at}")


def test_gather_cases_end_ragged_and_cross_clouds():
    """The cases hold totals that are not a multiple of 16 bytes in both
    types, and clouds whose rows are not a multiple of any span."""
    for size in (2, 4):
        assert any(b * m * k * c * size % 16 for c, b, n, m, k in CASES)
    assert all((m * k) % 32 for c, b, n, m, k in CASES)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gather_model_on_repeated_indices(dtype):
    x, idx = _case(35, 2, 90, 13, 16, seed=3, repeated=True)
    xt, words = _words(x, dtype)
    want = tg.gather_rows_plain(xt, torch.from_numpy(idx))
    want_words = want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32).numpy()
    for wide, span in sorted({cfg[1:] for cfg in tg.GATHER_CONFIGS}):
        got = gather_model(words.reshape(-1), 0, idx, 90, 35, xt.element_size(), wide, span)
        np.testing.assert_array_equal(got, want_words.reshape(-1))


@pytest.mark.parametrize("fault", ["no row step", "span start in rows", "no ragged end"])
@pytest.mark.parametrize("wide", [0, 1])
def test_gather_model_faults_break_it(fault, wide):
    x, idx = _case(35, 2, 300, 5, 7, seed=5)
    xt, words = _words(x, torch.bfloat16)
    want = tg.gather_rows_plain(xt, torch.from_numpy(idx)).view(torch.int16).numpy().reshape(-1)
    got = gather_model(words.reshape(-1), 0, idx, 300, 35, 2, wide, 32)
    np.testing.assert_array_equal(got, want)
    bad = gather_model(words.reshape(-1), 0, idx, 300, 35, 2, wide, 32, fault=fault)
    assert not np.array_equal(bad, want), fault


@pytest.mark.parametrize("rows", [32 * 8192 * 8, 32 * 128 * 16, 300])
@pytest.mark.parametrize("c,itemsize", [(c, s) for c in (67, 35, 131, 259, 515, 1)
                                        for s in (2, 4)])
def test_gather_config_is_one_the_kernel_takes(rows, c, itemsize):
    """The wrapper's configuration at the SceneMap's channel counts and at
    C = 1: one of ``GATHER_CONFIGS``, whose spans are multiples of 8 rows
    (a span's byte start keeps the output's 16-byte alignment) of at most
    128 (the warp's slice of offsets)."""
    mode, wide, span = tg.gather_config(rows, c, itemsize)
    assert (mode, wide, span) in tg.GATHER_CONFIGS
    assert span % 8 == 0 and span <= 128 and span * c < 2 ** 31


def test_gather_configs_at_the_scenemap_shapes():
    """The configurations ``tools/kernel_ab.py --sweep`` chose at the path's
    shapes (``chip_smoke.GATHER_CALLS`` at batch 32: bf16, the path's type,
    and f32)."""
    calls = {(0, 0): (8192, 8, 67), (1, 0): (2048, 16, 35), (1, 1): (2048, 16, 131),
             (2, 1): (512, 16, 67), (2, 2): (512, 16, 259), (3, 2): (128, 16, 131),
             (3, 3): (128, 16, 515)}
    got = {(call, s): tg.gather_config(32 * m * k, c, s)
           for call, (m, k, c) in calls.items() for s in (2, 4)}
    narrow, wide = (2, 0, 64), (0, 1, 16)
    assert got == {
        ((0, 0), 2): narrow, ((1, 0), 2): narrow, ((1, 1), 2): narrow, ((2, 1), 2): narrow,
        ((2, 2), 2): wide, ((3, 2), 2): wide, ((3, 3), 2): wide,
        ((0, 0), 4): (1, 0, 16), ((1, 0), 4): (1, 0, 16), ((1, 1), 4): (1, 0, 16),
        ((2, 1), 4): (1, 0, 16), ((2, 2), 4): (2, 1, 16), ((3, 2), 4): (1, 0, 16),
        ((3, 3), 4): (2, 1, 16)}
