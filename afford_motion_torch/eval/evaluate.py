"""Evaluators (counterpart of ``afford_motion_tpu/eval/evaluate.py``).

Same registry names, ``sample_list`` / ``k_samples_list`` contract and
on-disk outputs as the JAX package:
- ``ContactHumanML3DEvaluator`` writes the stage-1 handoff
  ``H3D/pred_contact/{id}-{caption}.npy``;
- ``ContactEvaluator`` computes ``dist_to_target@{thresholds}`` and its three
  averages on the HUMANISE target-object masks and writes
  ``{set}/pred_contact/{i:05d}.npy``;
- ``Text2MotionInSceneHumanML3DEvaluator`` pickles motions for the offline
  MDM-protocol HumanML3D evaluation (``humanml/{id}-{caption}.pkl``);
- ``Text2MotionInSceneEvaluator`` computes APD and the SDF physics metrics
  (``non_collision``, ``contact``, ``dist``) through a batched SMPL-X fit
  and LBS on the evaluator's device, and saves per-sequence results
  (``joints/{i:05d}.pkl``). The SMPL-X projection needs the fitting
  weights and the body model on disk; joints are saved either way. With
  ``Rprecison`` or ``fid`` in ``eval_metrics`` it also computes the
  in-process HumanML3D metrics (``H3D+{metric}_{model}``) through the 'ours'
  T2M evaluator (``eval/eval_humanml.py``), skipped with a warning when its
  checkpoint or eval meta is not on disk.

A handoff file holds distances, ``(1, N, C)`` for a sample and ``(k, N, C)``
for k samples, which the stage-2 datasets read.
"""
from __future__ import annotations

import json
import os
import pickle
import time
from collections import defaultdict
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..data.base import contact_to_dist
from ..utils.device import resolve_device
from ..utils.io import get_logger
from ..utils.registry import EVALUATOR
from .physics import compute_pairwise_distance, dist_to_obj, face_table, physics_over_sequence

logger = get_logger()


class Eval:
    """Base evaluator. ``device``: where an evaluator that computes on
    tensors runs them; the card unless the caller names another (it raises
    without one)."""

    def __init__(self, cfg: Any, *args, device: Optional[Union[str, torch.device]] = None,
                 **kwargs):
        ecfg = cfg.evaluator
        self.cfg = ecfg
        self.device = resolve_device({}, device)
        self.k_samples = int(ecfg.get("k_samples", 0))
        self.num_k_samples = int(ecfg.get("num_k_samples", 0))
        self.eval_nbatch = int(ecfg.get("eval_nbatch", 1))
        self.eval_metrics = list(ecfg.get("eval_metrics", []))
        self.save_results = bool(ecfg.get("save_results", True))
        self.metrics: Dict[str, Any] = defaultdict(list)
        # seconds per stage of the last evaluate(), each to a device synchronize
        self.timing: Dict[str, float] = {}

    def evaluate(self, sample_list, k_samples_list, save_dir, dataloader, **kwargs):
        pass

    def assist(self, sample_list, k_samples_list, dataloader) -> None:
        """What a rank other than 0 of a data-parallel test runs while rank 0
        runs :meth:`evaluate`: its share of the collective steps, on the same
        samples. Writes nothing."""

    def report(self, save_dir: str) -> None:
        """metrics.txt + metrics.json, byte for byte the JAX package's."""
        path = os.path.join(save_dir, "metrics.txt")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            for m in self.metrics:
                if m.startswith("_"):
                    continue
                v = self.metrics[m]
                if isinstance(v, list) and v and isinstance(v[0], (int, float, np.floating)):
                    f.write(f"{m}: {np.mean(v):.6f}\n")
                else:
                    f.write(f"{m}: {v}\n")
        with open(path.replace(".txt", ".json"), "w") as f:
            json.dump({k: _jsonable(v) for k, v in self.metrics.items()}, f)

    def _timed(self, name: str, fn, *args):
        """Run ``fn`` and book its seconds, device work included."""
        t0 = time.monotonic()
        out = fn(*args)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timing[name] = time.monotonic() - t0
        return out


def _jsonable(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, list):
        return [_jsonable(x) for x in v]
    return v


def _pred_dist(contact: np.ndarray, dataset) -> np.ndarray:
    """A sampled (normalized) contact map -> distances: denormalized and
    clipped, then through the inverse sigma kernel unless the dataset's
    target is the raw distance."""
    contact = dataset.denormalize(contact, clip=True)
    if getattr(dataset, "use_raw_dist", False):
        return contact.copy()
    return contact_to_dist(contact, dataset.sigma)


@EVALUATOR.register()
class ContactHumanML3DEvaluator(Eval):
    """Save stage-1 H3D contacts for the stage-2 dataset."""

    def evaluate(self, sample_list, k_samples_list, save_dir, dataloader, **kwargs):
        if not self.save_results:
            return
        out = os.path.join(save_dir, "H3D", "pred_contact")
        os.makedirs(out, exist_ok=True)
        for sample in sample_list:
            dist = _pred_dist(sample["sample"], dataloader.dataset)
            name, cap = sample["info_index"], sample["info_caption_index"]
            np.save(os.path.join(out, f"{name}-{cap}.npy"), dist[None, ...])
        for ks in k_samples_list:
            dist = _pred_dist(ks["k_samples"], dataloader.dataset)
            name, cap = ks["info_index"], ks["info_caption_index"]
            np.save(os.path.join(out, f"{name}-{cap}.npy"), dist)


@EVALUATOR.register()
class ContactEvaluator(Eval):
    """Stage-1 metrics on the target-object masks (``info_obj_mask``, the
    HUMANISE items'): per sample, whether its nearest predicted distance on
    the object is below each threshold, the mean distance over the object's
    points, that of the first (pelvis) channel and that of each point's
    nearest channel. Then the stage-1 -> stage-2 handoff files."""

    def __init__(self, cfg: Any, *args, **kwargs):
        super().__init__(cfg, *args, **kwargs)
        self.dist_to_target_thresholds = list(
            cfg.evaluator.get("dist_to_target_thresholds", [0.1, 0.3, 0.5]))

    def evaluate(self, sample_list, k_samples_list, save_dir, dataloader, **kwargs):
        for sample in sample_list:
            dist = _pred_dist(sample["sample"], dataloader.dataset)
            if "dist_to_target" in self.eval_metrics and sample.get("info_obj_mask") is not None:
                obj_dist = dist[np.asarray(sample["info_obj_mask"], dtype=bool), :]
                if obj_dist.size == 0:
                    continue
                d = obj_dist.min()
                for thr in self.dist_to_target_thresholds:
                    self.metrics[f"dist_to_target_{thr}"].append(float(d < thr))
                self.metrics["dist_to_target_average"].append(float(obj_dist.mean()))
                self.metrics["dist_to_target_pelvis_average"].append(float(obj_dist[:, 0].mean()))
                self.metrics["dist_to_target_min_average"].append(float(obj_dist.min(-1).mean()))

        if self.save_results:
            for sample in sample_list:
                dist = _pred_dist(sample["sample"], dataloader.dataset)
                out = os.path.join(save_dir, str(sample["info_set"]), "pred_contact")
                os.makedirs(out, exist_ok=True)
                np.save(os.path.join(out, f"{sample['info_index']:05d}.npy"), dist[None, ...])
            for ks in k_samples_list:
                dist = _pred_dist(ks["k_samples"], dataloader.dataset)
                out = os.path.join(save_dir, str(ks["info_set"]), "pred_contact")
                os.makedirs(out, exist_ok=True)
                np.save(os.path.join(out, f"{ks['info_index']:05d}.npy"), dist)


@EVALUATOR.register()
class Text2MotionInSceneHumanML3DEvaluator(Eval):
    """Pickle generated motions for the offline MDM-protocol evaluation."""

    def __init__(self, cfg: Any, *args, **kwargs):
        super().__init__(cfg, *args, **kwargs)
        self.njoints = int(cfg.evaluator.get("njoints", 22))

    def evaluate(self, sample_list, k_samples_list, save_dir, dataloader, **kwargs):
        if not self.save_results:
            return
        out = os.path.join(save_dir, "humanml")
        os.makedirs(out, exist_ok=True)
        for sample in sample_list:
            # MDM's protocol re-normalizes with the T2M eval mean/std, so the
            # DEnormalized motion is saved
            motion = dataloader.dataset.denormalize(sample["sample"])
            length = int((~sample["x_mask"]).sum())
            name, cap = sample["info_index"], sample["info_caption_index"]
            with open(os.path.join(out, f"{name}-{cap}.pkl"), "wb") as fp:
                pickle.dump({
                    "name": name, "text": sample["c_text"],
                    "tokens": sample["info_tokens"],
                    "motion": motion, "m_len": length,
                }, fp)
        for ks in k_samples_list:
            # the MM protocol consumes the raw (normalized) samples
            length = int((~ks["x_mask"]).sum())
            name, cap = ks["info_index"], ks["info_caption_index"]
            with open(os.path.join(out, f"{name}-{cap}.pkl"), "wb") as fp:
                pickle.dump({
                    "name": name, "text": ks["c_text"], "tokens": ks["info_tokens"],
                    "motion": ks["k_samples"], "m_len": length,
                }, fp)


@EVALUATOR.register()
class Text2MotionInSceneEvaluator(Eval):
    """Stage-2 physics and diversity metrics.

    Physics needs the predicted joints projected to SMPL-X meshes. When the
    fitting weights (``cfg.evaluator.joints_to_smplx_model_weights``) or the
    SMPL-X body model are not on disk, the physics metrics are skipped with
    a warning and the joints are saved raw; any other failure of the fitter
    is raised."""

    def __init__(self, cfg: Any, *args, **kwargs):
        super().__init__(cfg, *args, **kwargs)
        self.njoints = int(cfg.evaluator.get("njoints", 22))
        self.opt_rate = float(cfg.evaluator.get("opt_rate", 0.02))
        self.opt_steps = int(cfg.evaluator.get("opt_steps", 200))
        # batched-fit chunk: the Adam refinement runs once over (fit_batch, L)
        # padded batches for the whole sample list
        self.fit_batch = int(cfg.evaluator.get("fit_batch", 16))
        self._fitter = None
        self._fit_cache: Optional[np.ndarray] = None
        weights = str(cfg.evaluator.get("joints_to_smplx_model_weights", ""))
        try:
            from .joints_to_smplx import JointsToSMPLXFitter

            self._fitter = JointsToSMPLXFitter(
                weights, opt_rate=self.opt_rate, opt_steps=self.opt_steps, device=self.device)
        except FileNotFoundError as e:  # missing weights or body model
            logger.warning(f"SMPL-X fitting unavailable ({e}); physics metrics skipped")

    def _fit_all(self, sample_list, dataloader) -> np.ndarray:
        """One batched SMPL-X fit for the whole sample list: (n, L, 69). All
        samples share the padded horizon L, so chunks of ``fit_batch``
        sequences refine together."""
        joints = np.stack(
            [dataloader.dataset.denormalize(s["sample"]) for s in sample_list])
        masks = np.stack([np.asarray(s["x_mask"]) for s in sample_list])
        out = []
        for a in range(0, len(sample_list), self.fit_batch):
            out.append(self._fitter.fit(
                joints[a: a + self.fit_batch], masks[a: a + self.fit_batch]))
        return np.concatenate(out, axis=0)

    def _fits(self, sample_list) -> bool:
        """Whether :meth:`evaluate` fits SMPL-X to ``sample_list``: the same
        answer on every rank, whose fit is one sharded call."""
        wants_physics = any(
            m in self.eval_metrics for m in ("dist", "non_collision", "contact"))
        return self._fitter is not None and bool(sample_list) and (
            wants_physics or self.save_results)

    def assist(self, sample_list, k_samples_list, dataloader) -> None:
        """The sharded SMPL-X fit, beside rank 0's :meth:`evaluate`."""
        if self._fits(sample_list):
            self._fit_all(sample_list, dataloader)

    def evaluate(self, sample_list, k_samples_list, save_dir, dataloader, **kwargs):
        self.timing = {}
        for item in sample_list:
            self.metrics["_name"].append(f"{item['info_set']} - {item['info_index']}")
            self.metrics["_length"].append(f"{int((~item['x_mask']).sum())}")

        wants_physics = any(
            m in self.eval_metrics for m in ("dist", "non_collision", "contact"))
        if self._fits(sample_list):
            self._fit_cache = self._timed("fit_s", self._fit_all, sample_list, dataloader)

        if wants_physics and self._fitter is not None:
            self._timed("physics_s", self.eval_physics, sample_list, dataloader)
        elif wants_physics:
            logger.warning("physics metrics requested but SMPL-X fitter unavailable")

        if "apd" in self.eval_metrics and len(k_samples_list) > 0:
            self._timed("apd_s", self.eval_apd, k_samples_list, dataloader)

        if "Rprecison" in self.eval_metrics or "fid" in self.eval_metrics:
            self._timed("humanml_s", self.eval_humanml, sample_list, k_samples_list, dataloader)

        if self.save_results:
            out = os.path.join(save_dir, "joints")
            os.makedirs(out, exist_ok=True)
            for i, sample in enumerate(sample_list):
                joints = dataloader.dataset.denormalize(sample["sample"])
                payload = {
                    "joints": joints[~sample["x_mask"]],
                    "text": sample["c_text"],
                    "set": sample["info_set"],
                    "index": sample["info_index"],
                    "scene_trans": sample["info_scene_trans"],
                    "scene_mesh": sample["info_scene_mesh"],
                }
                if self._fit_cache is not None:
                    payload["params"] = self._fit_cache[i]
                with open(os.path.join(out, f"{sample['info_index']:05d}.pkl"), "wb") as f:
                    pickle.dump(payload, f)
        self._fit_cache = None

    def eval_physics(self, sample_list, dataloader):
        """Per sequence: LBS vertices from the batched fit, the signed
        distances of the scene points over the padded horizon, and the
        distance of the target object to an anchor frame. Everything stays
        on the device and is enqueued without a synchronize; only the
        per-frame values come to the host, in a second pass. The work in
        flight needs no bound of its own: the launch queue blocks the host
        when it is full, and a sequence's buffers return to the allocator in
        stream order."""
        dev = self.device
        faces = torch.as_tensor(np.asarray(self._fitter.faces), device=dev)
        table = face_table(faces, self._fitter.body_model.num_vertices)
        kernel = str(self.cfg.get("sdf_kernel", "auto"))
        wants_frames = "non_collision" in self.eval_metrics or "contact" in self.eval_metrics
        deferred = []
        for i, sample in enumerate(sample_list):
            valid = ~np.asarray(sample["x_mask"])
            # one sequence per LBS call bounds the (L, V, 3, 4) skinning blend
            verts = self._fitter.vertices_device(self._fit_cache[i])      # (L, V, 3)
            xyz_np = np.asarray(sample["c_pc_xyz"], dtype=np.float32)

            ncs = cts = d = None
            if wants_frames:
                ncs, cts = physics_over_sequence(torch.as_tensor(xyz_np, device=dev), verts,
                                                 faces, kernel=kernel, table=table)
            if "dist" in self.eval_metrics and sample.get("info_obj_mask") is not None:
                obj = xyz_np[np.asarray(sample["info_obj_mask"], dtype=bool)]
                if obj.shape[0] > 0:
                    # last VALID frame (the padded stack's -1 is a pad frame)
                    anchor = 0 if str(sample["c_text"]).startswith("stand up") \
                        else int(valid.sum()) - 1
                    d = dist_to_obj(torch.as_tensor(obj, device=dev), verts[anchor], faces,
                                    table)
            deferred.append((valid, ncs, cts, d))

        for valid, ncs, cts, d in deferred:
            if ncs is not None:
                self.metrics["non_collision"].append(float(ncs.cpu().numpy()[valid].mean()))
                self.metrics["contact"].append(float(cts.cpu().numpy()[valid].mean()))
            if d is not None:
                self.metrics["dist"].append(float(d))

    def eval_humanml(self, sample_list, k_samples_list, dataloader):
        """The in-process HumanML3D metrics (reference: evaluate.py:388-407),
        paths from ``cfg.evaluator.{eval_meta_dir, t2m_ckpt_path}``, pools of
        ``eval_batch_size``; Diversity and MultiModality draw from
        ``np.random.RandomState(0)``. A missing asset skips them with a
        warning."""
        from .eval_humanml import eval_humanml

        kwargs = {"device": self.device}
        if "eval_meta_dir" in self.cfg:
            kwargs["eval_meta_dir"] = str(self.cfg.eval_meta_dir)
        if "t2m_ckpt_path" in self.cfg:
            kwargs["ckpt_path"] = str(self.cfg.t2m_ckpt_path)
        if "eval_batch_size" in self.cfg:
            kwargs["batch_size"] = int(self.cfg.eval_batch_size)
        try:
            all_metrics = eval_humanml(sample_list, k_samples_list, dataloader, **kwargs)
        except FileNotFoundError as e:
            logger.warning(f"HumanML metrics skipped (missing asset: {e})")
            return
        for metric_name, metric_dict in all_metrics.items():
            for model_name, values in metric_dict.items():
                mean = np.mean(values, axis=0)
                if isinstance(mean, np.ndarray):
                    mean = mean.tolist()
                elif isinstance(mean, (np.floating, np.integer)):
                    mean = float(mean)
                self.metrics["H3D+" + metric_name + "_" + model_name] = mean

    def eval_apd(self, k_samples_list, dataloader):
        for ks in k_samples_list:
            x_mask = ks["x_mask"]
            pose_seq = ks["k_samples"][:, ~x_mask, :]
            pose_seq = dataloader.dataset.denormalize(pose_seq)
            pose_seq = pose_seq[:, :, : self.njoints * 3]
            self.metrics["apd"].append(compute_pairwise_distance(pose_seq))


def create_evaluator(cfg: Any, *args, **kwargs):
    """The evaluator named by ``cfg.evaluator.name``."""
    return EVALUATOR.get(str(cfg.evaluator.name))(cfg, *args, **kwargs)
