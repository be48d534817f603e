"""The plain reference against the port on the CPU at a small width: with
the program in float32 the first steps agree to rounding; its frozen plain
pieces agree with the program's own plain versions."""
import numpy as np
import pytest
import torch

from perfbench.harness import corpus
from perfbench.reference import geometry

from .conftest import run_cell

PARAMS = {"seed": 2023, "items": 4, "points": 2048, "motion_dim": 263, "frames": [40, 196],
          "captions": 3, "room_size": 6.0}


@pytest.mark.parametrize("cell", ["cmdm_enc_h3d.train_store", "cdm_perceiver_h3d.train_store"])
def test_reference_follows_the_program_in_float32(cell, small, capsys):
    rc, result, err = run_cell(cell, small("float32"), capsys)
    assert rc == 0, err[-3000:]
    assert result["correct"]
    for name, c in result["checks"].items():
        assert c["value"] <= 1e-4, (name, c)


def test_curve_order_and_fps_and_knn_match_the_program():
    from afford_motion_torch.ops.cuda import banded
    from afford_motion_torch.ops.cuda.fps import fps_plain
    from afford_motion_torch.ops.curves import curve_order
    from afford_motion_torch.ops.hierarchy import (build_point_hierarchy,
                                                   build_point_hierarchy_from_fps)

    pts = np.stack([corpus.make_item(PARAMS, i)["points"][:, :3] for i in range(3)])
    order = geometry.hilbert_order(torch.from_numpy(pts)).numpy()
    for i in range(3):
        assert (order[i] == curve_order(pts[i], "hilbert")).all()
    xyz = torch.from_numpy(np.take_along_axis(pts, order[..., None], axis=1))
    assert torch.equal(geometry.fps(xyz, 512), fps_plain(xyz, 512))
    wire = geometry.fps_wire(xyz)
    levels = geometry.hierarchy(xyz.half().float(), wire, 128)
    # the program's wire (prepare geometry) and its cache's hierarchy (the store's upload)
    ref = build_point_hierarchy(xyz, (1, 4, 4, 4), (8, 16, 16, 16), with_up=False, sort_fps=True)
    arrays = {f"geo_sm{li}_fps_idx": lvl.fps_idx for li, lvl in enumerate(ref) if li in wire}
    prog = build_point_hierarchy_from_fps(xyz.half().float(), arrays, (1, 4, 4, 4),
                                          (8, 16, 16, 16), prefix="geo_sm", with_up=False,
                                          banded=True, window=128, adaptive=True)
    for li, (lvl, r, p) in enumerate(zip(levels, ref, prog)):
        if li in wire:
            assert torch.equal(wire[li], r.fps_idx)
            assert torch.equal(lvl["down"], p.down_knn_idx)
        assert torch.equal(lvl["xyz"], p.xyz) and torch.equal(lvl["knn"], p.knn_idx)
    assert banded.knn_supports(2048, 2048, 8)
