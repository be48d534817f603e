"""Offline MDM-protocol HumanML3D evaluation of the port (counterpart of the
root ``h3d_eval/eval_h3d_offline.py``; reference:
h3d_eval/eval_h3d_offline.py:22-79).

Scores the ``humanml/*.pkl`` files of a stage-2 HumanML3D test with the
"mdm" T2M evaluator (263-d vectors, the last 4 channels stripped). Protocol
constants are the reference's: pools of 32 for R-precision, modes
debug/wo_mm/mm_short with 1,000 generated samples, diversity over 300 pairs,
MultiModality over 100 prompts and 10 pairs.

Usage (on the card unless ``--device cpu``):
    python -m afford_motion_torch.h3d_eval.eval_h3d_offline \\
        --results_dir outputs/<exp>/eval/test-<ts>/humanml \\
        --eval_mode wo_mm --data_dir ./data --eval_meta_dir ./data/eval \\
        --ckpt ./data/eval/t2m_evaluator/finest.tar

Writes ``eval_humanml_{mode}.json`` (the JAX entry's keys and layout) and
``eval_humanml_{mode}_timing.json`` (seconds per stage, each to a device
synchronize; the pools' bytes on the device; peak device memory) into the
results directory.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from collections import OrderedDict
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..eval.eval_humanml import (
    DeviceResidentPool,
    _batches,
    evaluate_diversity,
    evaluate_fid,
    evaluate_matching_score,
    evaluate_multimodality_metric,
)
from ..eval.evaluator_wrapper import EvaluatorWrapper
from ..eval.word_vectorizer import create_word_vectorizer
from ..utils.device import resolve_device
from ..utils.io import get_logger
from .eval_h3d_dataset_offline import H3DEvalDataset, H3DGTEvalDataset, MMH3DEvalDataset

logger = get_logger()

EVAL_MODES = {
    # reference: eval_h3d_offline.py:37-62
    "debug": dict(num_samples_limit=1000, run_mm=False, mm_num_samples=0,
                  mm_num_times=0, diversity_times=300, replication_times=1),
    "wo_mm": dict(num_samples_limit=1000, run_mm=False, mm_num_samples=0,
                  mm_num_times=0, diversity_times=300, replication_times=1),
    "mm_short": dict(num_samples_limit=1000, run_mm=True, mm_num_samples=100,
                     mm_num_times=10, diversity_times=300, replication_times=1),
}


def run_evaluation(results_dir: str, *, data_dir: str = "./data",
                   eval_meta_dir: str = "./data/eval",
                   ckpt: str = "./data/eval/t2m_evaluator/finest.tar",
                   eval_mode: str = "wo_mm", batch_size: int = 32,
                   mm_results_dir: Optional[str] = None, seed: int = 0,
                   device: Optional[Union[str, torch.device]] = None,
                   timing: Optional[Dict] = None):
    """The protocol's metrics, ``{metric: {"ground truth"|"vald": [value per
    replication]}}``. ``device``: the card unless the caller names another.
    ``timing``, if given, receives the seconds of each stage (summed over
    replications), the pools' bytes on the device and the device's peak
    memory. Diversity and MultiModality draw from
    ``np.random.RandomState(seed)``."""
    dev = resolve_device({}, device)
    timing = {} if timing is None else timing
    t_stage = time.monotonic()

    def mark(stage):
        nonlocal t_stage
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.monotonic()
        timing[stage] = timing.get(stage, 0.0) + now - t_stage
        logger.info(f"[timing] {stage}: {now - t_stage:.2f}s")
        t_stage = now

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    mode = EVAL_MODES[eval_mode]
    wrapper = EvaluatorWrapper(ckpt, variant="mdm", device=dev)
    w_vectorizer = create_word_vectorizer(os.path.join(eval_meta_dir, "glove"))
    ms = np.load(os.path.join(eval_meta_dir, "meta", "t2m_mean_std.npz"))
    mean, std = ms["mean"], ms["std"]
    mark("evaluator_s")

    rng = np.random.RandomState(seed)
    all_metrics = OrderedDict(
        (k, OrderedDict()) for k in
        ("Matching Score", "R_precision", "FID", "Diversity", "MultiModality")
    )
    for rep in range(mode["replication_times"]):
        gt = H3DGTEvalDataset(data_dir, mean, std, w_vectorizer)
        gen = H3DEvalDataset(results_dir, mean, std, w_vectorizer, mode["num_samples_limit"])
        mark("datasets_s")
        pools = OrderedDict()
        pools["ground truth"] = DeviceResidentPool(_batches(gt, batch_size), dev)
        pools["vald"] = DeviceResidentPool(_batches(gen, batch_size), dev)
        timing["pool_bytes"] = sum(p.nbytes for p in pools.values())
        mark("pool_upload_s")

        match, rprec, acts = evaluate_matching_score(wrapper, pools)
        mark("matching_s")
        fid = evaluate_fid(acts["ground truth"], acts)
        mark("fid_s")
        div = evaluate_diversity(acts, mode["diversity_times"], rng)
        mark("diversity_s")
        mm = 0.0
        if mode["run_mm"]:
            mm_ds = MMH3DEvalDataset(mm_results_dir or results_dir, w_vectorizer,
                                     mode["mm_num_samples"])
            mm = evaluate_multimodality_metric(
                wrapper, [mm_ds[i] for i in range(len(mm_ds))], mode["mm_num_times"], rng)
            mark("multimodality_s")

        for store, values in (
            (all_metrics["Matching Score"], match),
            (all_metrics["R_precision"], rprec),
            (all_metrics["FID"], fid),
            (all_metrics["Diversity"], div),
        ):
            for k, v in values.items():
                store.setdefault(k, []).append(v)
        all_metrics["MultiModality"].setdefault("vald", []).append(mm)
        logger.info(f"replication {rep}: FID={fid}")
    if dev.type == "cuda":
        timing["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    return all_metrics


def _clean(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, list):
        return [_clean(x) for x in v]
    if isinstance(v, dict):
        return {k: _clean(x) for k, x in v.items()}
    return v


def main(argv=None) -> str:
    """The command line; returns the path of the metrics file."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--results_dir", required=True)
    parser.add_argument("--mm_results_dir", default=None)
    parser.add_argument("--eval_mode", default="wo_mm", choices=list(EVAL_MODES))
    parser.add_argument("--data_dir", default="./data")
    parser.add_argument("--eval_meta_dir", default="./data/eval")
    parser.add_argument("--ckpt", default="./data/eval/t2m_evaluator/finest.tar")
    parser.add_argument("--batch_size", type=int, default=32,
                        help="must stay 32 for the R-precision pools")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card, cuda:0; cpu to run on the CPU)")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the Diversity and MultiModality draws")
    args = parser.parse_args(argv)

    # the evaluator's convolutions and GRUs are true-f32 surfaces
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timing: Dict = {}
    metrics = run_evaluation(
        args.results_dir, data_dir=args.data_dir, eval_meta_dir=args.eval_meta_dir,
        ckpt=args.ckpt, eval_mode=args.eval_mode, batch_size=args.batch_size,
        mm_results_dir=args.mm_results_dir, seed=args.seed, device=args.device, timing=timing,
    )
    out = os.path.join(args.results_dir, f"eval_humanml_{args.eval_mode}.json")
    with open(out, "w") as f:
        json.dump(_clean(metrics), f, indent=2)
    with open(os.path.join(args.results_dir, f"eval_humanml_{args.eval_mode}_timing.json"),
              "w") as f:
        json.dump(timing, f, indent=1)
    logger.info(f"wrote {out}")
    for metric, d in metrics.items():
        for model, vals in d.items():
            mean = np.mean(np.asarray(vals, dtype=object).tolist(), axis=0)
            logger.info(f"{metric} [{model}]: mean={mean}")
    return out


if __name__ == "__main__":
    main()
