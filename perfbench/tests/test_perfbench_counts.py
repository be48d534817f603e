"""The yardstick's arithmetic against hand-worked numbers at small shapes:
the model FLOPs of a step, the kernels' bytes and operations, the bound,
and the leaves the numbers that decide ``correct`` compare."""
import json
import types

import pytest
import torch

from perfbench.harness import compare, core, peaks

from .conftest import ROOT

BENCH = ROOT / "perfbench"


def test_cmdm_flops_by_hand():
    flops = core.load_module(BENCH / "flops" / "cmdm_enc_h3d.train_loop.py")
    s = {"batch": 2, "points": 512, "horizon": 4, "motion_dim": 3, "contact_dim": 1,
         "latent_dim": 8, "dim_feedforward": 16, "num_layers": 1, "num_heads": 2,
         "time_emb_dim": 8, "text_dim": 4, "text_tokens": 1, "groups": 8, "tokens": 14,
         "planes": [8, 16], "blocks": [2, 1], "strides": [1, 4], "nsamples": [2, 4]}
    # transformer: 14 tokens x (2*8*(4*8 + 2*16)) + 14 * 4 * 14 * 8
    layers = 14 * 1024 + 14 * 4 * 14 * 8
    # adapters: text 2*4*8, motion in/out 2*3*8*4 each, contact 2*16*8*8, time 2*2*8*8
    adapters = 64 + 192 + 2048 + 192 + 256
    # level 0: 512 points, 4 -> 8 channels; one block (c 8, k 2, mid 1)
    block0 = 5 * 2 * 512 * 64 + 512 * 2 * (18 + 48) + 512 * 2 * (16 + 2) + 2 * 512 * 2 * 8
    # level 1: 128 points, k 4, (3 + 8) -> 16; no block
    down1 = 2 * 128 * 4 * 11 * 16
    encoder = 2 * 512 * 4 * 8 + block0 + down1
    assert flops.flops_per_step({"shapes": s}, {}) == 3 * 2 * (layers + adapters + encoder)


def test_perceiver_flops_by_hand():
    flops = core.load_module(BENCH / "flops" / "cdm_perceiver_h3d.train_loop.py")
    s = {"batch": 1, "points": 10, "contact_dim": 1, "q_channels": 4, "kv_channels": 2,
         "decoder_q_channels": 2, "time_emb_dim": 2, "text_dim": 3, "widening": 1,
         "self_layers": 1}
    embed = 2 * 2 * 2 * 2 + 2 * 10 * 4 * 2 + 2 * 3 * 4 + 2 * 2 * 4
    enc_cross = 2 * 2 * 16 + 2 * 2 * 10 * 2 * 4 + 2 * 2 * 2 * 10 * 4 + 2 * 2 * 16 + 2 * 2 * 2 * 16
    enc_self = 2 * 2 * 4 * 16 + 2 * 2 * 2 * 2 * 4 + 2 * 2 * 2 * 16
    dec = (2 * 10 * 2 * 2 + 2 * 10 * 4 + 2 * 2 * 2 * 4 * 2 + 2 * 2 * 10 * 2 * 2 + 2 * 10 * 4
           + 2 * 10 * 2 * 4 + 2 * 10 * 2 * 1)
    assert flops.flops_per_step({"shapes": s}, {}) == 3 * (embed + enc_cross + enc_self + dec)


def test_the_configurations_step_flops():
    """The cells' own shapes: 0.865 TFLOP a flagship sample-step at batch 32
    scales with the batch."""
    for name, per_sample in (("cmdm_enc_h3d", 0.865039417344e12 / 32),
                             ("cdm_perceiver_h3d", 1.880733253632e12 / 64)):
        cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
        flops = core.load_module(BENCH / "flops" / f"{name}.train_loop.py")
        assert flops.flops_per_step(cfg, {}) == pytest.approx(
            per_sample * cfg["shapes"]["batch"], rel=1e-12)


def test_banded_kernel_counts_by_hand():
    gather = core.load_module(BENCH / "roofline" / "banded_gather.py")
    scatter = core.load_module(BENCH / "roofline" / "banded_scatter.py")
    x = torch.zeros((2, 256, 4), dtype=torch.bfloat16)
    idx = torch.zeros((2, 128, 8), dtype=torch.int32)
    starts = torch.zeros((2, 1), dtype=torch.int32)
    # x read, idx read, out written, starts read
    assert gather.counts((x, idx, starts, 1, 384, 1, True), {}) == (
        2 * (256 * 4 * 2 + 128 * 8 * 4 + 128 * 8 * 4 * 2) + 2 * 4, 0.0, "bfloat16")
    g = torch.zeros((2, 128, 8, 4), dtype=torch.bfloat16)
    assert scatter.counts((g, idx, starts, 1, 256, 384, 1, 1, 0), {}) == (
        2 * (128 * 8 * 4 * 2 + 128 * 8 * 4 + 256 * 4 * 2) + 2 * 4, 2.0 * 128 * 8 * 4, "float32")
    for spec in (gather, scatter):
        module = __import__(spec.MODULE, fromlist=[spec.FUNCTION])
        assert isinstance(getattr(module, spec.FUNCTION), types.FunctionType)


def test_bound_takes_the_larger_side():
    assert peaks.bound_s(3.35e12, 0.0, peaks.F32_FLOP_PER_S) == pytest.approx(1.0)
    assert peaks.bound_s(0.0, 989e12, peaks.BF16_FLOP_PER_S) == pytest.approx(1.0)
    assert peaks.bound_s(3.35e9, 67e12, peaks.F32_FLOP_PER_S) == pytest.approx(1.0)


def test_leaves_of_the_comparison_by_hand():
    w = torch.arange(12.0).reshape(6, 2)
    parts = dict(compare.leaf_parts("attn.in_proj_weight", w))
    assert list(parts) == ["attn.in_proj_weight.q", "attn.in_proj_weight.k",
                           "attn.in_proj_weight.v"]
    assert torch.equal(parts["attn.in_proj_weight.k"], w[2:4])
    assert [n for n, _ in compare.leaf_parts("attn.out_proj.weight", w)] == [
        "attn.out_proj.weight"]
    # the key's bias is nought to rounding in the reference: out of the change
    ref = {"loss": [1.0], "grad": {"a": 1.0, "b": 2.0, "b.k": 1e-9, "c": 4.0},
           "change": {"a": 1.0, "b": 1.0, "b.k": 0.1, "c": 1.0}}
    prog = {"loss": [1.01], "grad": {"a": 1.1, "b": 2.0, "b.k": 0.5, "c": 4.0},
            "change": {"a": 1.0, "b": 1.2, "b.k": 1.0, "c": 1.0}}
    n = compare.numbers(prog, ref, {"ac": ["a", "c"]})
    assert n["loss_gap"] == pytest.approx(0.01)
    # grad medians 1.5 (all leaves): a 0.1 / 1.5, b.k 0.5 / 1.5
    assert n["grad_gap"] == pytest.approx(0.5 / 1.5)
    assert n["grad_gap.ac"] == pytest.approx(0.1 / 1.5)
    assert n["grad_gap_median"] == pytest.approx(0.05 / 1.5)
    assert n["change_gap"] == pytest.approx(0.2)
