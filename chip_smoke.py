"""Smoke run of the PyTorch / CUDA port (``afford_motion_torch``) on one
NVIDIA GPU (written for an H100):

    python3 chip_smoke.py

Phases; any failure exits non-zero, and nothing falls back to the CPU:

1. card: ``nvidia-smi`` name and power limit;
2. build: nvcc builds the kernels of ``afford_motion_torch/csrc`` into
   ``build/kernels``; the registers, spills and shared memory of every
   kernel from the build log, and the count of tensor-core instructions
   (HMMA / HGMMA) in the SASS (``cuobjdump``) of the bf16 attention's
   forward and of its backward kernel;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the sampling and training paths give it (batch 32, 8192-point
   contact clouds) and on a near-tie cloud, plus a few shapes off those
   paths (the kNN also at other block sizes and splits of the cloud, k up to
   64; the banded gather with its other instance and splits). FPS picks,
   kNN idx and dist, the gathered rows and the scatter-added rows (f32 and
   bf16) must be bit-equal, the scatter also from one launch to the next.
   The banded kernels (windowed kNN, gather and scatter-add) likewise, on
   curve-sorted clouds with the static rank-1 starts and the adaptive rank-2
   starts of real sorted FPS indices, and with some indices put outside
   their window (zero rows, dropped contributions). Both scatters also at
   every launch configuration of their sums (``SCATTER_CONFIGS``), the
   banded one on non-monotone starts, a 192-position hub, 6144 positions on
   one destination and C = 1, the plain one with C = 1 and every position
   on one destination; the largest in-degree of each shape is logged. The
   row gather also in every launch configuration (``GATHER_CONFIGS``) at
   every shape, at C = 1, with a total that is not a multiple of 16 bytes
   and with an ``x`` one word past an aligned address, with a log line per
   shape of its time over ``torch.gather``'s; the banded kNN also in every
   launch configuration (``banded.knn_configs``) at every shape, at k = 63
   and on rank-2 starts drawn per cloud and tile (not monotone). Times by
   CUDA events, the median of 5 blocks of back-to-back calls (least and
   largest printed), each block queued behind
   a device-side sleep so the card, not the host's launch rate, sets it;
   beside the plain version and, where one PyTorch call computes the same
   function (``torch.gather``, ``index_add_``), beside that call (for the
   kNN, beside ``torch.cdist`` + ``torch.topk``, a yardstick that is not the
   same function: exact distances, not packed keys); the bound is the least
   time the card could take, from the bytes moved and the operations done at
   these shapes, at the card's peak rate for the inputs' type (bf16: the
   tensor cores'). The kNN skips pairs that cannot enter the k smallest, and
   the skip is exact, so no count of pairs bounds every exact algorithm: its
   bound is its bytes alone, and a device counter gives the share of pairs
   it visits, beside the time of a dense scan's and of those pairs'
   operations.
   FPS also at B = 1 (the single-cloud TPU kernel's case), at N = 1000
   and 8191, with its time per pick, and past 8192 points (its streamed
   instance) at N = 16384 and 10000 on random and near-tie clouds. The fused 1-NN
   (``nn1``) at the scene protocol's shape (8192 scene points, 10475 body
   vertices, 196 frames) on two clouds (:func:`nn1_cloud`: a, points N(0, 2^2)
   and vertices N(0, 1); b, a body in a room), on a cloud with duplicated and
   near-tie vertices, at a vertex count that no group divides, and on a
   cloud whose every group lies on its box's faces (:func:`nn1_faces_cloud`):
   idx and d2 bit-equal to its plain version;
   a and b timed beside ``torch.cdist`` + ``argmin`` with the share of pairs
   the kernel evaluates (a device counter); a sets the kernels line's row
   (the yardstick of the kernel's first port), b is logged. The fused
   attention at the denoiser's shape (batch 32, 8 heads of 64, 326 tokens,
   bf16, padded keys masked) and the regressor's (batch 16, 4 heads of 64,
   196 frames, f32), masked and not, and off the path at head dimensions 8,
   40 and 64 with a masked tile of 64 keys: within the kernel's stated
   tolerance of its plain version (``TOLERANCE`` in ops/cuda/attention.py:
   1e-5 of the largest ``|v|`` for f32; 2^-9 of it plus one bf16 ulp of the
   result for bf16, with the largest share of it any bf16 check needed);
   timed beside ``F.scaled_dot_product_attention``, with the kernels that
   call launched. The attention's backward (bf16 and f32: one kernel each for
   dq, dk and dv) against ``attention_backward_plain``
   on the kernel forward's o and row statistics, to ``TOLERANCE_BWD`` (and for bf16
   at most ``DV_DIFFER_SHARE`` of dv's entries differing at all): at the
   train path's shape (batch 32, 326 tokens, 8 heads of 64, the CMDM's
   masks) in bf16 and f32, at the regressor's f32 shape, and off the path at
   head dimensions 8, 40 and 64 with odd lengths, a masked tile of 64 keys
   and an item with no attended key; two calls bit-identical; the forward's
   o bit-identical with and without the statistics, which must match
   ``attention_lse_plain`` (LSE_LIMIT); and at 1100 keys (18 key tiles);
   every f32 launch configuration bit-identical to the default.
   The whole backward timed at the train shape beside the gradient of
   ``scaled_dot_product_attention`` with the same mask with respect to the
   same inputs, and split by kernel by the profiler's device time where the
   profiler sees it (logged only);
4. autograd: ``gather_rows(x, idx).backward(g)`` and ``gather_banded(x,
   idx, starts).backward(g)`` through the kernels on the card equal the
   CPU's plain path bit for bit in float32;
5. reference: a small float32 chain (full-width CMDM, 1024 points, 10 DDIM
   steps) and two float32 train steps on the card, through the kernels,
   against the same on the CPU through the plain versions; then two banded
   train steps on a curve-sorted cloud likewise; then the evaluator's
   ``physics_over_sequence`` and a short SMPL-X fit (10 refine steps) on the
   card against the CPU's plain path, float32; then one train step's
   gradients of the flagship CMDM at full width (dropout 0, 4 items,
   1024-point clouds) through the fused attention against the einsum route,
   in bf16 and float32: every layer's ``in_proj_weight.grad`` non-zero and
   within FLASH_GRAD_LIMIT, the forward and backward launched once a layer;
6. train: ``afford_motion_torch.train`` (the port's train entry) with the
   flagship CMDM ``trans_enc`` at full width from the seeded init, in the
   config's bf16, batch 32, 8192-point clouds, 196x263 motions, on the
   synthetic HumanML3D tree: 8 steps with a checkpoint every 4, then 4 more
   steps resumed from ``model000004.pt``, whose weights must equal the
   straight run's within RESUME_LIMIT. Every loss must be finite, FPS, kNN
   and gather launched, and the scatter launched 7 times per step. Then
   ``flash train``: the same with ``model.dropout=0`` and
   ``AM_FLASH_ATTN=1``, where each step also launches the fused attention's
   forward and backward once per layer (5 each), 8 steps and 4 resumed; and
   ``flash f32 train``: the same with ``model.dtype=float32`` (the config's
   reference-parity dtype), through the f32 forward and the f32 backward
   once per layer (5 each);
7. slice: ``afford_motion_torch.test`` (the port's test entry) from the
   checkpoint the train phase wrote, on one batch of 32 test items, once
   with DDIM-50 and once with DDPM-1000. x0 must be finite with shape
   (32, 196, 263), and FPS, kNN and gather must have been launched;
8. banded train: a second tree, a copy of the first taken through
   ``afford_motion_torch.prepare`` ``sort``, ``geometry`` and ``pack``; the
   train entry with the same arguments as in 6 (nothing names bandedness or
   the store: the loop must switch the banded kernels on and build the
   device store, the flagship configuration's default, and say both in its
   log), 8 steps and 4 resumed as in 6. The store's upload caches every
   scene's hierarchy through the banded kNN, 6 launches a chunk of 64
   scenes, counted apart from the steps (``STORE_UPLOAD``); per step the
   banded gather must be launched 7 times and the banded scatter 7, and no
   kNN, FPS, row gather or its scatter (``STORE_STEP``). The store's bytes,
   its upload and cache time, s/step and the peak memory are logged. Then
   ``banded host train``: the same with ``task.train.device_store=off``,
   the host route's producer thread on the packed tree, where every step
   launches the banded kNN 6 times (``BANDED_STEP``). Then ``store
   megabatch``: one megabatch of 128 items assembled on the card from the
   store equals the host wire of the same items with the same draws, bit
   for bit in ``x``, ``x_mask``, ``c_pc_xyz``, the flags and the fps wire,
   the cached hierarchy equals the one the step rebuilds from that wire
   through the kernels, and ``c_pc_contact`` is within one f16 ulp (an f32
   ``exp`` rounded to f16 on each side: the card's and numpy's may differ
   in the last f32 bit);
9. banded slice: one DDIM-50 chain through the test entry from that
   checkpoint with ``model.use_banded=true`` on the sorted tree, once from
   the cached FPS indices (no FPS launch) and once with the geometry cache
   off (FPS and sort in the chain);
10. stage 1: the CDM-Perceiver as every published
   ``scripts/*_contact/train_ddp.sh`` runs it (no scene model, 500 diffusion
   steps, a 512-wide encoder of 8 heads and 2 latent layers, a 256-wide
   decoder, bf16 with float32 LayerNorms and head, dropout 0.1), through the
   train entry with ``scripts/t2m_contact/train_ddp.sh``'s overrides (batch
   64, sigma 0.8): 8 steps and 4 resumed, bit-exact, on the plain tree (the
   host stream) and on the sorted, packed tree (the stage-1 device store,
   its staging line logged); s/step, peak memory, and every port kernel's
   launches 0 (the CDM builds no hierarchy and its attention is the einsum
   route). Then the t2m chain: ``scripts/t2m_contact/test.sh`` (CDM-500, B
   items) from that checkpoint writes ``H3D/pred_contact`` (finite distances
   of shape (1, 8192, 6)), and a DDIM-50 chain of the CMDM reads them
   through ``task.test.contact_folder``; its ``c_pc_contact`` for every item
   it reads equals the sigma kernel of the file;
11. scene slice: the scene-protocol test path at full width. A synthetic
   HUMANISE tree (8192-point scenes, 66-d joint motions of 40..196 frames, 36
   test items), checkpoints of a seeded CDM-Perceiver and of the seeded CMDM
   ``trans_enc`` (``data_repr=pos``, bf16), a seeded joints-to-SMPL-X
   regressor file and a synthetic SMPL-X of the official mesh size (10475
   vertices, 20908 faces). First the ts2m chain's stage 1:
   ``scripts/ts2m_contact/test.sh`` (CDM-500, ``ContactEvaluator``, two maps
   for each of B items) writes ``HUMANISE/pred_contact`` and finite
   ``dist_to_target_*`` metrics, and the scene protocol reads those files;
   then ``afford_motion_torch.test task=contact_motion_gen model=cmdm
   diffusion.steps=500`` with ``AM_FLASH_ATTN=1``: one batch of 32, two
   DDPM-500 chains (``k_samples=2``), the batched fit (200 refine steps, 16
   sequences a batch), LBS, SDF physics and APD. Samples must be finite with
   shape (32, 196, 66), ``metrics.txt`` hold the four metrics, the pickles
   carry 69-d params, ``nn1`` be launched once per sequence and the attention
   once per layer of every denoiser step and of every regressor call; a
   second evaluator over the same samples must write a byte-identical
   ``metrics.json``. Three
   alternating pairs of DDIM-50 chains with and without ``AM_FLASH_ATTN``
   give the denoiser step's time each way. Then the scene slice's evaluator
   once more over the same samples with ``Rprecison`` and ``fid`` added: the
   in-process HumanML3D metrics through a seeded full-width "ours" T2M
   evaluator (66-d) against a synthetic ``HumanML3D/contact_motion`` set of
   64 items beside the scene tree, pools of 32; the ``H3D+`` metrics finite,
   ``humanml_s`` logged, no port kernel launched in them;
12. the HumanML3D metric stack (``eval/t2m_models.py``,
   ``evaluator_wrapper.py``, ``eval_humanml.py``, ``h3d_eval/``), none of
   whose work is a port kernel (every count 0 in each of these phases):
   the full-width "mdm" (263-d, the last 4 channels stripped) and "ours"
   evaluators from seeded checkpoints (``make_synthetic_t2m_ckpt``) on 256
   seeded rows (motions of 40..196 frames and four
   under 4, captions of 5..22 tokens) on the card against the CPU, f32:
   the co-embeddings within T2M_LIMIT of the largest entry, and a run with
   TF32 on for cuBLAS and cuDNN outside it; the t2m chain's 32 stage-2
   ``humanml/*.pkl`` scored by the offline entry
   (``afford_motion_torch.h3d_eval.eval_h3d_offline``, ``wo_mm``) against
   the tree's test split, the metrics finite and R-precision in [0, 1]; the
   protocol at HumanML3D's scale: 4,384 test motions of 40..196 frames, a
   GloVe triple and the eval meta, 1,000 generated motions and 100 k-sample
   files of (30, 196, 263) written by
   ``Text2MotionInSceneHumanML3DEvaluator.evaluate``; ``wo_mm`` twice (the
   metrics files byte-identical) and ``mm_short`` once, each stage's
   seconds, the pools' bytes on the card and the peak memory logged;
13. CMDM ``trans_dec`` (``model.arch=trans_dec``, the flagship's widths:
   the SceneMap U-Net with its 3-NN up-interpolation, 5 self-attention
   stages and 4 decoder layers whose cross-attention reads the U-Net's 128,
   512, 2048 and 8192 points; 13 attention calls a denoiser step). Its
   kernels at the shapes it adds (:func:`phase_kernels_trans_dec`, run with
   the kernel phases): the up kNN at k = 3 (#2 on the FPS pyramid of a
   random and a near-tie cloud, #5 with the adaptive up starts on the
   sorted one; level 3's 512 x 128 takes the exact path), the up-gathers
   and their scatters (#3/#4, #6/#7), bit-equal to their plain versions;
   the fused attention as cross-attention (198 queries against each scale,
   bf16 and f32, an item with every key masked and one with a masked
   stretch) within ``TOLERANCE`` / ``TOLERANCE_BWD``, and the all-masked
   item through the module's fused route equal to the einsum route's
   uniform rows, forward and v's gradient; each timed beside its bound and
   SDPA. With the reference phases, one f32 denoiser step at full width
   (2 items, 8192 points, one item's memories masked) on the card, on both
   attention routes, against the CPU within ``DEC_STEP_LIMIT``. Then 8 + 4
   train steps on the plain tree (``DEC_PLAIN_STEP``: 8 kNN, 14 gathers and
   14 scatters a step), bit-exact resume; the chains from that checkpoint
   through the test entry, DDIM-50 on the einsum route and with
   ``AM_FLASH_ATTN=1``, DDPM-1000 fused, x0 finite of shape (32, 196, 263),
   their seconds, ms a step and peak memory; 8 + 4 flash steps
   (``model.dropout=0``, ``AM_FLASH_ATTN=1``: the cross-attention's backward
   every step, ``DEC_FLASH_STEP``); and 8 + 4 steps through the device store
   of the sorted tree (``DEC_STORE_STEP``; its upload caches the up arrays
   too, 8 banded kNN a chunk of 64 scenes).
14. the CDM with its frozen scene model, the shipped stage-1 default
   (``task=contact_gen model=cdm``: the MLP backbone and the 5-level
   ``PointTransformerSeg`` in float32, 32-d point features, bf16, 500 steps;
   the pretrained file is not in the checkout, so its seeded init, with the
   entry's warning). Its kernels at the shapes it adds
   (:func:`phase_kernels_cdm_scene`, with the kernel phases): FPS down to 32
   points and the scene hierarchy's kNN at batch 64, bit-equal; the float32
   gather of its level 0 (64 x 8192 x 8 x 67) and the bf16 scatter of
   PointTrans's (131 channels), bit-equal, beside ``torch.gather`` and
   ``index_add_``, and PointTrans's banded kNN, gather and scatter of level
   0 on a sorted cloud at batch 64; V2's bottleneck attention (32 x 128 tokens, 8 heads of 64)
   within ``TOLERANCE``, beside SDPA. With the reference phases, one float32
   CDM-V2 forward with the scene model at a small width on 2 x 8192 points,
   card vs CPU: the hierarchies bit-equal, the features and the output
   within ``CDM_SCENE_LIMIT``. Then on a synthetic HUMANISE tree (8192-point
   scenes with colours) through the entries: 8 + 4 steps of the MLP at
   batch 64 (``SCENE_PASS`` a step: the hierarchy and the scene model, no
   backward through it), 4 + 2 each of the Perceiver, PointTrans and
   PointTransV2 with the scene model (``PT_SCENE_STEP``), every run's scene
   model bit-equal to the seeded init after training; 4 + 2 steps of
   PointTrans without it through the stage-1 store of the sorted H3D tree
   (the banded route and the upload's geometry cache); the MLP's CDM-500
   test (two chains of 32, ``pred_contact`` files and ``dist_to_target_*``
   as in the ts2m phase) and V2's DDIM-50 test with ``AM_FLASH_ATTN=1`` (the
   bottleneck attention fused, once a step). Every run's launches are
   checked exactly.
15. the MotionX training route and ``sample.py`` (:func:`phase_motionx`, after
   the stage-1 phases): a synthetic HUMANISE tree (96 scenes of 8192
   coloured points, 66-d joint motions of 40..196 frames, a ``pred_contact``
   file for every other item) taken through ``afford_motion_torch.prepare
   sort|geometry|pack --dataset HUMANISE`` on the card (the ``target_mask``
   sidecars checked to follow their sorted rows; 3 FPS and 8 kNN a chunk of
   B in the geometry stage); ``scripts/ts2m_contact_motion/train_ddp.sh``
   (the CMDM ``trans_enc`` at full width, 500 steps, batch 32, the rotation
   chain, mix 0.5) 4 + 2 steps through the ``motionx`` store (the banded
   route: ``STORE_STEP`` a step, the upload's banded kNN), one assembled
   batch on the card against the same batch assembled on the CPU (``x_mask``
   and the fps wire equal; ``x``, ``c_pc_xyz``, ``c_pc_contact`` within one
   f16 ulp plus ``MX_ROT_UNITS`` f32 unit roundoffs of the rotation's scale,
   :func:`rotation_excess`), 4 + 2 steps on the packed host route
   (``BANDED_STEP``), 4 + 2 steps of ``scripts/ts2m_contact/train_ddp.sh``
   through the ``motionx_contact`` store; each store's kind asserted; then
   ``python -m afford_motion_torch.sample``'s two stages from those
   checkpoints at batch 8, DDPM-500: one ``contact.npy`` of (8192, 9) finite
   f32 a case from stage 1 (no port kernel), one frame PLY a frame of each
   case from stage 2 (one encoding: ``PLAIN_STEP``), each chain's seconds.
16. the raw-data chain (:func:`phase_raw_chain`): a synthetic raw HUMANISE
   release (``data/synthetic.py``: 8 ScanNet-layout scenes of 150,000
   points with segments and objects, 96 aligned motions of 40..196 frames;
   SMPL-X at 10,475 vertices) through ``python -m
   afford_motion_torch.prepare`` ``process``, ``smplx_to_vec``,
   ``process_scene``, ``contact_data`` (8192 points, a 4 m region),
   ``split`` and ``target_mask`` on the card, each stage also on the CPU on
   a copy of the tree: the joints within RAW_JOINT_ATOL + RAW_JOINT_RTOL
   |x| of the CPU's (whose copy then takes the card's), every file but
   ``dist`` byte-equal, ``dist`` of both within its bound of the float64
   brute force on the card (``contact_data.dist_excess``) and a pair alone
   bit-equal to its batch row; ``contact_data``'s pairs a second and peak
   memory, ``smplx_to_vec``'s sequences a second, the whole chain's
   seconds; then ``sort`` (the target masks follow the rows), ``geometry``
   (3 FPS and 8 kNN a chunk of B) and ``pack``, and 4 + 2 steps of
   ``ts2m_contact_motion`` through the ``motionx`` store (``STORE_STEP``);
   one PROX sequence of 120 frames through ``process --dataset PROX`` (the
   pelvis on the card) against the CPU's; the root ``visualize.py``'s
   counterpart through the LBS on the card (40 frames, the vertices against
   the CPU's) and ``visualize_h3d``'s on a 263-d result;
17. ``model.norm=layer`` (:func:`phase_norm_layer`): two float32 train
   steps on the card through the kernels against the same steps on the CPU,
   of the flagship CMDM ``trans_enc`` and of a ``PointTrans`` CDM with its
   scene model, both built from the config at the published widths on 2 x
   8192 points: the losses within 1e-3, the weights within 2 steps x 2 lr
   and all but 2% within 2e-6 in each part of the model; the launches
   exactly two steps' of FPS, kNN, the row gather and its scatter.

The line before the last is a JSON object with, for each kernel, its
launches over the driven paths (every train run and chain above), its
largest difference from the plain version, and its time, the plain
version's, the bound and the library call's (and the kNN's yardstick's,
under ``yardstick_ms``), each summed over the shapes of one pass of its path (one hierarchy and encoder forward; for the scatter
one backward) of ``trans_enc``; ``trans_dec``'s shapes are timed and
logged apart. The last line is ``{"ok": true, "device": {...}}``.
Everything written at run time goes under ``build/`` in the checkout.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
SEED = 2023
B, N_POINTS, L, D = 32, 8192, 196, 263
REPLACES = {
    "fps": ("afford_motion_torch/csrc/fps.cu", "afford_motion_tpu/ops/pallas/fps.py:124"),
    "knn": ("afford_motion_torch/csrc/knn.cu", "afford_motion_tpu/ops/pallas/knn.py:101"),
    "gather": ("afford_motion_torch/csrc/gather.cu", "afford_motion_tpu/ops/pallas/gather.py:95"),
    "scatter": ("afford_motion_torch/csrc/scatter.cu",
                "afford_motion_tpu/ops/pallas/gather.py:112"),
    "banded_knn": ("afford_motion_torch/csrc/banded_knn.cu",
                   "afford_motion_tpu/ops/pallas/banded.py:234"),
    "banded_gather": ("afford_motion_torch/csrc/banded_gather.cu",
                      "afford_motion_tpu/ops/pallas/banded.py:312"),
    "banded_scatter": ("afford_motion_torch/csrc/banded_scatter.cu",
                       "afford_motion_tpu/ops/pallas/banded.py:340"),
    "nn1": ("afford_motion_torch/csrc/nn1.cu", "afford_motion_tpu/ops/pallas/sdf.py:128"),
    "attention": ("afford_motion_torch/csrc/attention.cu",
                  "afford_motion_tpu/models/layers.py:122"),
    # the library's backward kernels the JAX package's flash path reaches
    # through its custom_vjp (afford_motion_tpu/models/layers.py:122)
    "attention_bwd_dkv": ("afford_motion_torch/csrc/attention.cu",
                          "jax/experimental/pallas/ops/tpu/flash_attention.py:1121"),
    "attention_bwd_dq": ("afford_motion_torch/csrc/attention.cu",
                         "jax/experimental/pallas/ops/tpu/flash_attention.py:1456"),
    # the f32 instance of both (dK/dV and dQ in one launch)
    "attention_bwd_f32": ("afford_motion_torch/csrc/attention.cu",
                          "jax/experimental/pallas/ops/tpu/flash_attention.py:1121"),
}
# what the kernels line's numbers mean where a row's differ from the others'
_WHOLE = ("both backward rows read one kernel, which computes dq, dk and dv: launches are "
          "calls of attention_backward_cuda, each launching it once; ms, bound_ms, plain_ms and "
          "library_ms (the whole backward of scaled_dot_product_attention) are the whole "
          "backward's, the same in both rows, not to be added")
NOTES = {"attention_bwd_dkv": _WHOLE, "attention_bwd_dq": _WHOLE,
         "attention_bwd_f32": "the float32 backward, one launch for dq, dk and dv: the two "
                              "library kernels at flash_attention.py:1121 (dK/dV) and :1456 (dQ); "
                              "the bf16 rows count bf16 calls only"}
# the packed-kNN calls of one SceneMap hierarchy, (query level, support
# level, k), level 0 the 8192-point cloud and each next one its FPS to
# 2048, 512, 128 (the 128x128 level is below the kernel's range and takes
# the exact path); the row gathers of its encoder, ((query level, support
# level), channels): per level the TransitionDown group (3 + C_in) and the
# block's packed xyz|k|v (3 + 2C), for planes 32/64/128/256
KNN_CALLS = ((0, 0, 8), (1, 0, 16), (1, 1, 16), (2, 1, 16), (2, 2, 16), (3, 2, 16))
GATHER_CALLS = (((0, 0), 67), ((1, 0), 35), ((1, 1), 131), ((2, 1), 67), ((2, 2), 259),
                ((3, 2), 131), ((3, 3), 515))
# launches per train step (one hierarchy, encoder forward and backward) and
# per chain (no backward) on each route; level 3's 128-point self kNN is
# below both kNN kernels' range and takes the exact path
PLAIN_STEP = {"fps": 3, "knn": 6, "gather": 7, "scatter": 7,
              "banded_knn": 0, "banded_gather": 0, "banded_scatter": 0,
              "nn1": 0, "attention": 0, "attention_bwd_dkv": 0, "attention_bwd_dq": 0,
              "attention_bwd_f32": 0}
BANDED_STEP = dict(PLAIN_STEP, fps=0, knn=0, gather=0, scatter=0, banded_knn=6, banded_gather=7,
                   banded_scatter=7)
# the device store's route on the sorted tree: the hierarchy comes from the
# cache, so a step launches no kNN; the upload caches it through the banded
# kNN, one hierarchy (6 launches) a chunk of STORE_CHUNK scenes
STORE_STEP = dict(BANDED_STEP, banded_knn=0)
STORE_CHUNK = 64


def store_upload(n_scenes: int, knn: int = BANDED_STEP["banded_knn"]) -> dict:
    """The launches of the store's geometry cache for ``n_scenes`` scenes,
    ``knn`` banded kNN launches a hierarchy."""
    return dict({k: 0 for k in PLAIN_STEP}, banded_knn=knn * -(-n_scenes // STORE_CHUNK))


# CMDM trans_dec (model.arch=trans_dec): the SceneMap U-Net over the same
# hierarchy, plus its 3-NN up-interpolation. UP_CALLS: (fine level, coarse
# level, channels of the coarse features gathered), one a decoder stage; the
# up kNN queries the fine level's points against the coarse level's with
# k = 3, and level 3's 512 x 128 is below both kNN kernels' range (128 < 256
# support points) and takes the exact path, as level 3's own neighbours do;
# its up-gather still takes the kernels. A pass adds 2 kNN launches, 3
# up-gathers and the 4 decoder blocks' gathers (the encoder blocks' shapes),
# each with its scatter backward; the denoiser runs 5 self-attention stages
# and 4 decoder layers, each a self- and a cross-attention: 13 attention
# calls a denoiser step.
UP_CALLS = ((0, 1, 32), (1, 2, 64), (2, 3, 128))
DEC_ARCH = ("model.arch=trans_dec",)
DEC_ATTENTION = 5 + 2 * 4
DEC_PLAIN_STEP = dict(PLAIN_STEP, knn=PLAIN_STEP["knn"] + 2, gather=14, scatter=14)
DEC_BANDED_KNN = BANDED_STEP["banded_knn"] + 2
DEC_STORE_STEP = dict(STORE_STEP, banded_gather=14, banded_scatter=14)
DEC_FLASH_STEP = dict(DEC_PLAIN_STEP, attention=DEC_ATTENTION,
                      attention_bwd_dkv=DEC_ATTENTION, attention_bwd_dq=DEC_ATTENTION)
# the cross-attention's key counts, coarsest first, and its query tokens
# (time, pooled text, 196 frames)
DEC_MEMORY = (128, 512, 2048, 8192)
DEC_QUERIES = 2 + L


# the CDM with its frozen scene model (task=contact_gen model=cdm, the
# shipped default; scripts/ts2m_contact/train_ddp.sh without its
# use_scene_model=False). A pass builds the scene model's 5-level hierarchy
# (4 FPS, 8192 -> 2048 -> 512 -> 128 -> 32; 8 kNN: the self kNN of the levels
# of 8192, 2048 and 512 points, the down kNN of 2048, 512 and 128 points and
# the up kNN of 8192 x 2048 and 2048 x 512; below 256 support points the
# exact path) and runs the scene model once, forward only and in float32:
# 26 row gathers (17 in the encoder of blocks 2/3/4/6/3, 5 decoder blocks
# and 4 up-gathers) and no scatter. The PointTrans backbones add the SceneMap
# hierarchy with its up kNN (3 FPS, 8 kNN) and their U-Net's 14 gathers a
# pass, 14 scatters backward; V2's bottleneck self-attention is one
# attention call a denoiser step (128 tokens, 8 heads of 64), fused under
# AM_FLASH_ATTN=1 in chains (its dropout 0.1 keeps training on the einsum
# route). Without the scene model, through the stage-1 store of the sorted
# tree, PointTrans runs trans_dec's store route: DEC_STORE_STEP, and the
# upload DEC_BANDED_KNN banded kNN a chunk.
SCENE_PASS = dict(PLAIN_STEP, fps=4, knn=8, gather=26, scatter=0)
PT_SCENE_STEP = dict(SCENE_PASS, fps=4 + 3, knn=8 + 8, gather=26 + 14, scatter=14)
# V2's bottleneck attention (B chains of N_POINTS / 64 tokens) and the scene
# model's shapes the kernel phases add
V2_TOKENS, V2_WIDTH, V2_HEADS = N_POINTS // 64, 512, 8
SCENE_GATHER_C = 3 + 2 * 32


# launch configurations of the two scatter kernels' sums checked against
# their plain versions beside the wrappers' own: (a factor on the fewest
# channel passes, channels a lane, registers budgeted), every instance of
# csrc/ordered_scatter.cuh's sums_kernel
SCATTER_CONFIGS = ((1, 1, 1), (1, 2, 0), (1, 3, 1), (1, 4, 0), (2, 4, 1), (3, 2, 0), (1, 1, 0),
                   (1, 2, 1), (1, 3, 0), (1, 4, 1))


def scatter_passes(c: int, factor: int, wide: int, budget: int) -> tuple:
    """(passes, wide, budget): ``factor`` times the fewest channel passes of
    at most 32 * wide channels, at most c."""
    return min(c, factor * -(-c // (32 * wide))), wide, budget


# the scene protocol: SMPL-X's mesh, the denoiser's and the regressor's layers,
# the evaluator's fit batch
N_VERTS, N_FACES, D_POS = 10475, 20908, 66
CMDM_LAYERS, REGRESSOR_LAYERS, FIT_BATCH = 5, 2, 16
# a train step with dropout 0 and AM_FLASH_ATTN=1: the plain route, plus the
# fused attention's forward and backward once per denoiser layer
FLASH_STEP = dict(PLAIN_STEP, attention=CMDM_LAYERS, attention_bwd_dkv=CMDM_LAYERS,
                  attention_bwd_dq=CMDM_LAYERS)
# the same in float32 (model.dtype=float32): the f32 forward and the f32
# backward (dK/dV and dQ in one launch) once per denoiser layer
FLASH_F32_STEP = dict(PLAIN_STEP, attention=CMDM_LAYERS, attention_bwd_f32=CMDM_LAYERS)
# stage 1, the CDM-Perceiver of every published scripts/*_contact/train_ddp.sh
# (no scene model, 500 diffusion steps): its train batch (its chains run at
# B); it builds no point hierarchy and its attention is the einsum route, so
# it launches none of the port's kernels
B_STAGE1 = 64
STAGE1_MODEL = ["model=cdm", "model.arch=Perceiver", "model.scene_model.use_scene_model=False",
                "diffusion.steps=500"]
STAGE1_STEP = {k: 0 for k in PLAIN_STEP}
# published peaks of one H100 SXM: device memory, float32 outside the tensor
# cores, bf16 products with float32 sums on the tensor cores (dense). A bound
# takes the rate the card has for the inputs' type, whatever the kernel uses.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
# largest difference allowed between the resumed run's weights and the
# straight run's: every kernel of the step is deterministic, so 0 is expected
RESUME_LIMIT = 1e-6
# the forward's row statistics against attention_lse_plain: a share of
# max(1, the largest |lse|)
LSE_LIMIT = 2.0 ** -13
# one step's gradients through the fused attention against the einsum
# route's, |fused - einsum| / |einsum| in the L2 norm, per layer's
# in_proj_weight and over every parameter: set from readings on an H100
# (2.2e-3 to 2.5e-3 in bf16, where the routes round in other places;
# 1.5e-7 to 1.7e-7 in float32), about six times above them
FLASH_GRAD_LIMIT = {torch.bfloat16: 2.0 ** -6, torch.float32: 1e-6}
# assumed least time of one pick (a field update and an argmax across the
# block or cluster, with one barrier, at ~1.7 GHz): FPS picks are sequential,
# so picks x this is its latency floor, not bytes or operations
FPS_PICK_FLOOR_US = 0.25


def nn1_cloud(kind: str, rng, n_points: int | None = None, frames: int | None = None,
              n_verts: int | None = None):
    """The 1-NN's timing clouds, float32 numpy: (points (O, 3), vertices
    (frames, H, 3)). "a": points N(0, 2^2), vertices N(0, 1) in every frame.
    "b", a body in a room: points uniform in a 6 x 6 x 3 m room; each frame
    one blob of vertices N(0, 0.3^2) in random index order (as the synthetic
    SMPL-X template has it), moved along a path through the room, with 1 cm
    of motion of its own a frame. Sizes default to the protocol's."""
    n_points, frames, n_verts = n_points or N_POINTS, frames or L, n_verts or N_VERTS
    if kind == "a":
        points = rng.normal(size=(n_points, 3)) * 2
        return points.astype(np.float32), rng.normal(size=(frames, n_verts, 3)).astype(np.float32)
    points = rng.uniform(size=(n_points, 3)) * np.array([6.0, 6.0, 3.0])
    body = rng.normal(size=(n_verts, 3)) * 0.3
    t = np.linspace(0.0, 1.0, frames)[:, None]
    path = np.concatenate([0.8 + 4.4 * t, 0.8 + 4.4 * t * t, np.full_like(t, 0.9)], axis=1)
    verts = body[None] + path[:, None, :] + rng.normal(size=(frames, n_verts, 3)) * 0.01
    return points.astype(np.float32), verts.astype(np.float32)


def nn1_faces_cloud(rng, cubes: int, frames: int, n_points: int):
    """A cloud whose every group of the 1-NN kernel lies on the faces of its
    box: in each frame ``cubes`` cells of a 16^3 grid over [0, 16]^3 (x below
    8) hold a box of 32 vertices (its 8 corners and 24 points on its faces),
    each mirrored to x' = 16 - x, and two cells hold 32 copies of a corner
    of [0, 16]^3, so that the kernel's cells are these and each holds one
    group. Coordinates lie on a 2^-20 grid: differences are exact, their
    squares are rounded, and a query on the plane x = 8 (half of them; the
    others anywhere) is exactly as far from a vertex as from its mirror
    image. Vertex indices in random order. Returns float32 (points (O, 3),
    vertices (frames, 64 cubes + 64, 3))."""
    step = 2.0 ** -20
    free = [(x, y, z) for x in range(8) for y in range(16) for z in range(16)
            if (x, y, z) not in ((0, 0, 0), (0, 15, 15))]
    corners = np.array([[i >> 2 & 1, i >> 1 & 1, i & 1] for i in range(8)], dtype=np.float64)
    out = []
    for _ in range(frames):
        chosen = rng.choice(len(free), size=cubes, replace=False)
        boxes = []
        for c in chosen:
            lo = np.array(free[c], np.float64) + 0.25 + rng.integers(0, 2 ** 16, 3) * step
            hi = lo + 0.25 + rng.integers(0, 2 ** 16, 3) * step
            face = rng.integers(0, 3, size=24)
            pts = lo + rng.integers(0, np.round((hi - lo) / step).astype(np.int64) + 1,
                                    size=(24, 3)) * step
            pts[np.arange(24), face] = np.where(rng.integers(0, 2, size=24) == 1, hi[face],
                                                lo[face])
            box = np.concatenate([lo + corners * (hi - lo), pts])
            boxes += [box, np.concatenate([16.0 - box[:, :1], box[:, 1:]], axis=1)]
        boxes += [np.zeros((32, 3)), np.full((32, 3), 16.0)]
        verts = np.concatenate(boxes)
        out.append(verts[rng.permutation(len(verts))])
    points = rng.integers(0, 16 * 2 ** 20, size=(n_points, 3)) * step
    points[: n_points // 2, 0] = 8.0
    return points.astype(np.float32), np.stack(out).astype(np.float32)


def log(msg: str) -> None:
    print(msg, flush=True)


# blocks of back-to-back calls a kernel's (and a library call's) time is the
# median of; the plain versions, timed for the record only, take fewer
TIME_BLOCKS, PLAIN_BLOCKS = 5, 3
# cycles of torch.cuda._sleep a second: above any H100 clock, so a sleep
# lasts at least as long as asked
SLEEP_CYCLES_PER_S = 2.0e9


def time_ms(fn, reps: int, blocks: int = TIME_BLOCKS):
    """ms per call by CUDA events: the median, least and largest over
    ``blocks`` blocks of ``reps`` back-to-back calls, after a warm-up block.
    Each block is queued behind a device-side sleep longer than the host
    takes to queue it, so the calls run back to back on the card and a
    short kernel is not timed at the host's launch rate (a function that
    waits for the device inside still is)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    queue_s = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    per_call = []
    for _ in range(blocks):
        torch.cuda._sleep(min(int(SLEEP_CYCLES_PER_S * (2 * queue_s + 1e-4)), 10 ** 8))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return float(np.median(per_call)), min(per_call), max(per_call)


def bits(t: torch.Tensor) -> torch.Tensor:
    """Raw bit pattern, for bit-equality of float tensors."""
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)


def bound_ms(bytes_ms: float, ops_ms: float):
    """Least time for the work, from the ms its bytes and its operations
    need at the card's peaks: (ms, which limit sets it)."""
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


class KernelReport:
    def __init__(self):
        self.err = {k: 0.0 for k in REPLACES}
        self.ms = {k: 0.0 for k in REPLACES}
        self.plain_ms = {k: 0.0 for k in REPLACES}
        self.library_ms = {k: None for k in REPLACES}
        # a call that computes a related function (the kNN's cdist + topk)
        self.yardstick_ms = {k: None for k in REPLACES}
        # ms at the card's peaks for the path shapes' bytes and operations
        self.bytes_ms = {k: 0.0 for k in REPLACES}
        self.ops_ms = {k: 0.0 for k in REPLACES}
        # the largest atol (a share of max |v|) any bf16 attention check needed
        self.attention_bf16_atol = 0.0
        # the same for the backward (a share of each gradient's max |plain|)
        self.attention_bwd_need = {"bf16": 0.0, "f32": 0.0}

    def check(self, name: str, label: str, got, want) -> None:
        for g, w in zip(got, want):
            if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(bits(g), bits(w)):
                diff = (g.double() - w.double()).abs().max().item() if g.shape == w.shape else -1
                raise AssertionError(f"{name} {label}: kernel differs from plain (max {diff})")
            self.err[name] = max(self.err[name], (g.double() - w.double()).abs().max().item())

    def check_close(self, name: str, label: str, got, want, atol: float, rtol: float) -> None:
        """For a kernel whose sums run in another order than its plain
        version's: every entry within ``atol + rtol * |plain|``."""
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name} {label}: {got.shape} {got.dtype} from the kernel")
        diff = (got.double() - want.double()).abs()
        if not bool((diff <= atol + rtol * want.double().abs()).all()) or not bool(
                torch.isfinite(got).all()):
            raise AssertionError(f"{name} {label}: kernel differs from plain (max "
                                 f"{diff.max().item():.3e}, limit {atol:.3e} + {rtol:.3e} |plain|)")
        self.err[name] = max(self.err[name], diff.max().item())

    def timed(self, name, label, kernel, plain, reps, path_shape=True, *, nbytes, flops,
              library=None, peak=F32_FLOP_PER_S, yardstick=None):
        """Time one shape. ``nbytes``: every input read once and every output
        written once; ``flops``: the arithmetic the function needs; ``peak``:
        the card's rate for operations on inputs of this type; ``yardstick``:
        a call that computes a related function, timed one call a block.
        Returns the kernel's, the plain version's and the library call's
        median ms."""
        (k_ms, k_lo, k_hi), (p_ms, _, _) = time_ms(kernel, reps), time_ms(
            plain, max(1, reps // 3), PLAIN_BLOCKS)
        l_ms, line = None, ""
        for what, fn, calls, into in (("library", library, reps, self.library_ms),
                                      ("yardstick", yardstick, 1, self.yardstick_ms)):
            if fn is None:
                continue
            t = time_ms(fn, calls)
            if what == "library":
                l_ms = t[0]
            if path_shape:
                into[name] = (into[name] or 0.0) + t[0]
            line += f", {what} {t[0]:.4f} ms ({t[1]:.4f}-{t[2]:.4f})"
        self.record(name, label, k_ms, f"median of {TIME_BLOCKS} blocks; {k_lo:.4f}-{k_hi:.4f}",
                    p_ms, path_shape, nbytes=nbytes, flops=flops, peak=peak, line=line)
        return k_ms, p_ms, l_ms

    def record(self, name, label, k_ms, how, p_ms, path_shape=True, *, nbytes, flops,
               peak=F32_FLOP_PER_S, line=""):
        """Enter one shape's kernel and plain ms (``how``: how the kernel's
        was measured) beside its bound, as :meth:`timed` describes."""
        bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / peak
        b_ms, by = bound_ms(bytes_ms, ops_ms)
        if path_shape:
            self.ms[name] += k_ms
            self.plain_ms[name] += p_ms
            self.bytes_ms[name] += bytes_ms
            self.ops_ms[name] += ops_ms
        log(f"  {name} {label}: kernel {k_ms:.4f} ms ({how}), plain {p_ms:.4f} ms{line}, "
            f"bound {b_ms:.4f} ms ({by})")


def kernel_usage(ptxas_log: str) -> dict:
    """Registers, spills and shared memory of each kernel, from the build
    log's ``-Xptxas -v`` lines: {kernel<template arguments>: line}."""
    import re

    usage, name, spill = {}, None, ""
    for line in ptxas_log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:   # _Z[N]: length-prefixed names (namespace, kernel), then I..E
            rest, parts = re.sub(r"^_ZN?", "", entry.group(1)), []
            while (m := re.match(r"(\d+)", rest)):
                n = int(m.group(1))
                parts.append(rest[m.end():m.end() + n])
                rest = rest[m.end() + n:]
            args = re.match(r"I((?:L[ib]\d+E|[a-z])+)E", rest)
            types = {"t": "u16", "j": "u32", "f": "f32", "i": "i32"}
            name = (parts[-1] if parts else entry.group(1)) + (
                "<" + ",".join(v or types.get(t, t) for v, t in
                               re.findall(r"L[ib](\d+)E|([a-z])", args.group(1))) + ">"
                if args else "")
            spill = ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and name is not None:
            usage[name] = line.split(":", 1)[1].strip() + "; " + spill
            name = None
    return usage


def tensor_core_ops(lib_path: Path) -> str:
    """How many HMMA / HGMMA instructions ``cuobjdump -sass`` finds in each
    bf16 attention kernel of the built library (the forward and the
    backward), or why it was not checked."""
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(cuobjdump):
        return "not checked (no cuobjdump)"
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            current = next((k for k in ("attention_bf16", "attention_bwd_bf16") if k in name),
                           None)
            if current is not None:
                counts.setdefault(current, {})
        elif current is not None:
            for op in ("HGMMA", "HMMA"):
                if f" {op}." in line:
                    counts[current][op] = counts[current].get(op, 0) + 1
                    break
    if len(counts) != 2 or not all(counts.values()):
        raise AssertionError(f"a bf16 attention kernel's SASS holds no tensor-core instruction: "
                             f"{counts}")
    return "; ".join(f"{k}: " + ", ".join(f"{n} {op}" for op, n in c.items())
                     for k, c in counts.items())


def knn_ops_ms(pairs: int) -> str:
    """The time of a kNN's arithmetic on ``pairs`` query-support pairs (3
    differences, 3 products, 2 sums and the compare against the k-th key):
    at the card's f32 peak, which counts an FMA as two operations, and at
    the no-FMA floor of one FP32 instruction an operation (half that
    rate), which the kernel's rounding contract imposes."""
    t = 1e3 * 9.0 * pairs / F32_FLOP_PER_S
    return f"{t:.4f} ms (no-FMA floor {2 * t:.4f} ms)"


def cdist_topk(q: torch.Tensor, s: torch.Tensor, k: int):
    """A yardstick for the packed kNN, not the same function: exact
    difference-form distances (``torch.cdist`` without the matrix-product
    expansion) and their k smallest, in query chunks that keep the distance
    matrix under 1 GB."""
    b, m, _ = q.shape
    chunk = max(1, min(m, (1 << 30) // (b * s.shape[1] * 4)))
    return [torch.topk(torch.cdist(q[:, lo:lo + chunk], s,
                                   compute_mode="donot_use_mm_for_euclid_dist"),
                       k, dim=-1, largest=False) for lo in range(0, m, chunk)]


def phase_kernels(dev: torch.device) -> KernelReport:
    from afford_motion_torch.ops.cuda import fps as fps_mod
    from afford_motion_torch.ops.cuda import gather as gather_mod
    from afford_motion_torch.ops.cuda.fps import fps_cuda, fps_plain
    from afford_motion_torch.ops.cuda.gather import (
        gather_rows,
        gather_rows_plain,
        scatter_add_rows,
        scatter_add_rows_plain,
    )
    from afford_motion_torch.ops.cuda import knn as knn_mod
    from afford_motion_torch.ops.cuda.knn import knn_cuda, knn_plain

    rep = KernelReport()
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    clouds = {
        "random": torch.from_numpy(rng.normal(size=(B, N_POINTS, 3)).astype(np.float32)).to(dev),
        # 16^3 grid for 8192 points: duplicates and exactly tied distances
        "near-tie": torch.from_numpy(
            (rng.integers(0, 16, size=(B, N_POINTS, 3)) * 0.125).astype(np.float32)).to(dev),
    }
    for kind, cloud in clouds.items():
        path = kind == "random"
        levels = [cloud]
        for n_out in (2048, 512, 128):
            parent = levels[-1]
            label = f"{kind} ({B},{parent.shape[1]},3)->{n_out}"
            got = fps_cuda(parent, n_out)
            rep.check("fps", label, [got], [fps_plain(parent, n_out)])
            # per pick and point: 3 differences, 3 products, 2 sums, a min
            # and a compare. The picks are sequential, so the real floor is
            # n_out dependent block-wide argmax steps, far above this bound
            n_in = parent.shape[1]
            rep.timed("fps", label, lambda p=parent, m=n_out: fps_cuda(p, m),
                      lambda p=parent, m=n_out: fps_plain(p, m), 5, path,
                      nbytes=B * (n_in * 12 + n_out * 4), flops=10.0 * B * n_out * n_in)
            levels.append(torch.gather(parent, 1, got.long()[..., None].expand(-1, -1, 3)))
        knn_idx, pairs, visited = {}, 0, 0
        for qi, si, k in KNN_CALLS:
            q, s = levels[qi], levels[si]
            label = f"{kind} q{tuple(q.shape)} s{tuple(s.shape)} k={k}"
            got = knn_cuda(q, s, k)
            rep.check("knn", label, got, knn_plain(q, s, k))
            # bound: the bytes alone (the skip of pairs is exact, so no count
            # of pairs bounds every exact algorithm)
            m, n = q.shape[1], s.shape[1]
            rep.timed("knn", label, lambda q=q, s=s, k=k: knn_cuda(q, s, k),
                      lambda q=q, s=s, k=k: knn_plain(q, s, k), 5, path,
                      nbytes=B * ((m + n) * 12 + m * k * 8), flops=0.0,
                      yardstick=lambda q=q, s=s, k=k: cdist_topk(q, s, k))
            # the pairs this kernel visits: chunks of 32 points scanned by
            # warps of 32 queries (a second launch, with the counter on)
            visits = torch.zeros(1, dtype=torch.int64, device=dev)
            rep.check("knn", label + " with the visit counter",
                      knn_mod.launch(q, s, k, *knn_mod.launch_config(B, m, n, k), visits=visits),
                      got)
            seen = int(visits.item()) * knn_mod.CHUNK * 32
            log(f"    visits {seen / (B * m * n):.4f} of the {B * m * n} pairs; at 9 operations a "
                f"pair {knn_ops_ms(B * m * n)} for a dense scan, {knn_ops_ms(seen)} for these")
            pairs, visited = pairs + B * m * n, visited + seen
            knn_idx[(qi, si)] = got[0]
        log(f"  knn a pass ({kind}): visits {visited / pairs:.4f} of the pairs; "
            f"{knn_ops_ms(pairs)} for a dense scan, {knn_ops_ms(visited)} for the pairs visited")
        for (qi, si), c in GATHER_CALLS:
            idx = knn_idx.get((qi, si))
            if idx is None:  # 128-point level: any in-range neighbours will do
                idx = torch.randint(0, 128, (B, 128, 16), device=dev, dtype=torch.int32,
                                    generator=gen)
            n_src = levels[si].shape[1]
            degree = torch.stack([torch.bincount(i.reshape(-1).long(), minlength=n_src)
                                  for i in idx])
            log(f"  {kind} scatter in-degree ({B},{n_src}) <- idx{tuple(idx.shape)}: largest "
                f"{int(degree.max())}, mean {float(degree.float().mean()):.2f}")
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn(B, n_src, c, device=dev, generator=gen).to(dtype)
                label = f"{kind} x({B},{n_src},{c}) idx{tuple(idx.shape)} {str(dtype)[6:]}"
                on_path = path and dtype == torch.bfloat16
                m, k = idx.shape[1:]
                size = x.element_size()
                want = gather_rows_plain(x, idx)
                rep.check("gather", label, [gather_rows(x, idx)], [want])
                check_gather_configs(rep, label, x, idx, want)
                del want
                wide = idx.long().reshape(B, m * k, 1).expand(-1, -1, c)
                k_ms, _, l_ms = rep.timed(
                    "gather", label, lambda x=x, i=idx: gather_rows(x, i),
                    lambda x=x, i=idx: gather_rows_plain(x, i), 10, on_path,
                    nbytes=B * (n_src * c * size + m * k * 4 + m * k * c * size), flops=0.0,
                    library=lambda x=x, w=wide: torch.gather(x, 1, w))
                log(f"    gather {label}: kernel / torch.gather {k_ms / l_ms:.3f}")
                del wide
                # the backward of this gather: g has the gathered rows' shape
                g = torch.randn(B, m, k, c, device=dev, generator=gen).to(dtype)
                got = scatter_add_rows(g, idx, n_src)
                want = scatter_add_rows_plain(g, idx, n_src)
                rep.check("scatter", label, [got], [want])
                rep.check("scatter", label + " again", [scatter_add_rows(g, idx, n_src)], [got])
                # every launch configuration of the reduce
                for config in SCATTER_CONFIGS:
                    cfg = scatter_passes(c, *config)
                    rep.check("scatter", f"{label} (passes, wide, budget) {cfg}",
                              [gather_mod.launch_scatter(g, idx, n_src, *cfg)], [want])
                del want
                flat = (idx.long() + n_src * torch.arange(B, device=dev)[:, None, None]).reshape(-1)

                def index_add(g=g, flat=flat, n_src=n_src, c=c):
                    out = torch.zeros((B * n_src, c), dtype=g.dtype, device=g.device)
                    return out.index_add_(0, flat, g.reshape(-1, c))

                rep.timed("scatter", label, lambda g=g, i=idx, n=n_src: scatter_add_rows(g, i, n),
                          lambda g=g, i=idx, n=n_src: scatter_add_rows_plain(g, i, n), 10, on_path,
                          nbytes=B * (m * k * c * size + m * k * 4 + n_src * c * size),
                          flops=1.0 * B * m * k * c, library=index_add)
                del g, got, flat
    picks = 2048 + 512 + 128
    log(f"  fps: {picks} dependent picks per hierarchy: latency floor {picks * FPS_PICK_FLOOR_US / 1e3:.3f} "
        f"ms at an assumed {FPS_PICK_FLOOR_US} us per pick; measured "
        f"{1e3 * rep.ms['fps'] / picks:.3f} us per pick ({fps_mod.THREADS} threads x "
        f"{fps_mod.CLUSTER} blocks a cloud)")
    # off the sampling path, checked but not timed: the kNN's other
    # register-array sizes (k=3 is the 3-NN up-interpolation), an FPS cloud
    # that does not fill its block, a one-channel gather
    cloud = clouds["random"]
    for k in (3, 32, 64):
        q, s = cloud[:, :512].contiguous(), cloud[:, :2048].contiguous()
        rep.check("knn", f"off-path k={k}", knn_cuda(q, s, k), knn_plain(q, s, k))
    # other block sizes and splits of the cloud than the wrapper picks at
    # these shapes (threads a block, parts of the cloud)
    q, s = clouds["near-tie"][:, :512].contiguous(), clouds["near-tie"][:, :2048].contiguous()
    for k, config in ((8, (1024, 1)), (16, (128, 16)), (8, (96, 4)), (32, (512, 2)),
                      (64, (256, 2))):
        rep.check("knn", f"off-path near-tie k={k} config {config}",
                  knn_mod.launch(q, s, k, *config), knn_plain(q, s, k))
    for n in (1000, 8191):   # clouds that leave padding slots
        odd = cloud[:, :n].contiguous()
        rep.check("fps", f"off-path (32,{n},3)->{n // 4}", [fps_cuda(odd, n // 4)],
                  [fps_plain(odd, n // 4)])
    # the streamed instance, past 8192 points: a power of two and a ragged
    # size, random and near-tie (16^3 grid) clouds
    for n in (16384, 10000):
        for kind, big in (("random", rng.normal(size=(4, n, 3))),
                          ("near-tie", rng.integers(0, 16, size=(4, n, 3)) * 0.125)):
            big = torch.from_numpy(big.astype(np.float32)).to(dev)
            label = f"streamed {kind} (4,{n},3)->{n // 8}"
            rep.check("fps", label, [fps_cuda(big, n // 8)], [fps_plain(big, n // 8)])
            if kind == "random" and n == 16384:
                rep.timed("fps", label, lambda big=big, n=n: fps_cuda(big, n // 8),
                          lambda big=big, n=n: fps_plain(big, n // 8), 3, False,
                          nbytes=4 * (n * 12 + n // 8 * 4), flops=10.0 * 4 * n // 8 * n)
    # one cloud: what the TPU package's single-row FPS kernel computes
    for kind, c in clouds.items():
        one = c[:1].contiguous()
        label = f"{kind} (1,{N_POINTS},3)->2048"
        rep.check("fps", label, [fps_cuda(one, 2048)], [fps_plain(one, 2048)])
        if kind == "random":
            rep.timed("fps", label, lambda: fps_cuda(one, 2048), lambda: fps_plain(one, 2048), 5,
                      False, nbytes=N_POINTS * 12 + 2048 * 4, flops=10.0 * 2048 * N_POINTS)
    idx = torch.randint(0, 1000, (B, 300, 5), device=dev, dtype=torch.int32, generator=gen)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(B, 1000, 1, device=dev, generator=gen).to(dtype)
        want = gather_rows_plain(x, idx)
        rep.check("gather", "off-path C=1", [gather_rows(x, idx)], [want])
        check_gather_configs(rep, "off-path C=1", x, idx, want)
        # a total that is not a multiple of 16 bytes, and an x one word past
        # an aligned address (a view at an offset)
        ragged = torch.randint(0, 1000, (3, 299, 5), device=dev, dtype=torch.int32,
                               generator=gen)
        x = torch.randn(3, 1000, 35, device=dev, generator=gen).to(dtype)
        if (ragged.numel() * 35 * x.element_size()) % 16 == 0:
            raise AssertionError("the ragged gather case ends on a 16-byte boundary")
        want = gather_rows_plain(x, ragged)
        rep.check("gather", "off-path ragged end", [gather_rows(x, ragged)], [want])
        check_gather_configs(rep, "off-path ragged end", x, ragged, want)
        flat = torch.randn(B * 1000 * 35 + 1, device=dev, generator=gen).to(dtype)
        x = flat[1:].view(B, 1000, 35)
        if x.data_ptr() % 16 == 0 or not x.is_contiguous():
            raise AssertionError("the offset view lies on a 16-byte boundary")
        want = gather_rows_plain(x, idx)
        rep.check("gather", "off-path x at an offset", [gather_rows(x, idx)], [want])
        check_gather_configs(rep, "off-path x at an offset", x, idx, want)
        g = torch.randn(B, 300, 5, 1, device=dev, generator=gen).to(dtype)
        rep.check("scatter", "off-path C=1", [scatter_add_rows(g, idx, 1000)],
                  [scatter_add_rows_plain(g, idx, 1000)])
        # every position on one destination: a list as long as the table
        one = torch.full((2, 1500, 3), 5, device=dev, dtype=torch.int32)
        g = torch.randn(2, 1500, 3, 131, device=dev, generator=gen).to(dtype)
        rep.check("scatter", "off-path one destination", [scatter_add_rows(g, one, 9)],
                  [scatter_add_rows_plain(g, one, 9)])
    log("  off-path checks: kNN k=3/32/64, FPS N=1000/8191, B=1 and N=10000/16384 (streamed), "
        "gather and scatter C=1, the gather with a ragged end and an x at an offset in every "
        "launch configuration, scatter onto one destination bit-equal")
    return rep


def check_gather_configs(rep: KernelReport, label: str, x, idx, want) -> None:
    """The row gather in every launch configuration the wrapper might pick
    (``gather.GATHER_CONFIGS``: chunks a lane at a time, wide loads, span),
    bit-equal to the plain version."""
    from afford_motion_torch.ops.cuda import gather as gather_mod

    for cfg in gather_mod.GATHER_CONFIGS:
        rep.check("gather", f"{label} (mode, wide, span) {cfg}",
                  [gather_mod.launch_gather(x, idx, *cfg)], [want])


def phase_kernels_banded(dev: torch.device, rep: KernelReport) -> None:
    """The three banded kernels against their plain versions at the shapes
    of one banded SceneMap hierarchy, encoder forward and backward."""
    from afford_motion_torch.ops.cuda import banded, build
    from afford_motion_torch.ops.cuda.fps import fps_cuda
    from afford_motion_torch.ops.curves import curve_order
    from afford_motion_torch.ops.pointops import knn as knn_exact

    rng = np.random.default_rng(SEED + 3)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    clouds = {
        "sorted": rng.normal(size=(B, N_POINTS, 3)).astype(np.float32),
        # 16^3 grid for 8192 points: duplicates and exactly tied distances
        "near-tie": (rng.integers(0, 16, size=(B, N_POINTS, 3)) * 0.125).astype(np.float32),
    }
    w0 = 128  # configs/model/cmdm.yaml banded_window
    for kind, cloud in clouds.items():
        path = kind == "sorted"
        curve = "morton" if path else "hilbert"
        cloud = np.stack([c[curve_order(c, curve)] for c in cloud])
        levels, fps = [torch.from_numpy(cloud).to(dev)], [None]
        for n_out in (2048, 512, 128):
            # the hierarchy's rule on a banded level: ascending FPS indices
            idx = torch.sort(fps_cuda(levels[-1], n_out), dim=-1).values
            fps.append(idx)
            levels.append(torch.gather(levels[-1], 1, idx.long()[..., None].expand(-1, -1, 3)))
        starts, knn_idx = {}, {}
        for qi, si, k in KNN_CALLS:
            q, sup = levels[qi], levels[si]
            m, n = q.shape[1], sup.shape[1]
            size = banded.window_starts(m, n, banded.window_width(n, w0))[1]
            # self levels: static rank-1 starts; cross levels: adaptive rank-2
            # starts of the real sorted FPS indices
            st = (banded._starts_tensor(m, n, w0, dev) if qi == si
                  else banded.adaptive_down_starts(fps[qi], n, w0))
            starts[(qi, si)] = st
            label = (f"{kind} q{tuple(q.shape)} s{tuple(sup.shape)} k={k} S={size} "
                     f"starts{tuple(st.shape)}")
            got = banded.knn_banded(q, sup, k, st, w0)
            check_banded_knn(rep, label, q, sup, k, st, size, got)
            knn_idx[(qi, si)] = got[0]
            if path:
                # per query and window row: 3 differences, 3 products, 2 sums
                # and the compare against the k-th key
                rep.timed("banded_knn", label,
                          lambda q=q, sup=sup, k=k, st=st: banded.knn_banded(q, sup, k, st, w0),
                          lambda q=q, sup=sup, k=k, st=st, size=size:
                          banded.knn_banded_plain(q, sup, k, st, size), 5,
                          nbytes=B * ((m + n) * 12 + m * k * 8) + st.numel() * 4,
                          flops=9.0 * B * m * size)
        # the other rank of starts on each kind of call; k = 63, the largest
        # the kernel takes; rank-2 starts drawn per cloud and tile, not
        # monotone; each in every launch configuration
        q, sup = levels[1], levels[0]
        st = banded._starts_tensor(2048, N_POINTS, w0, dev)
        check_banded_knn(rep, f"{kind} down, static starts", q, sup, 16, st, 768,
                         banded.knn_banded(q, sup, 16, st, w0))
        st = banded._starts_tensor(2048, 2048, w0, dev).expand(B, -1).contiguous()
        check_banded_knn(rep, f"{kind} self, rank-2 starts", q, q, 16, st, 384,
                         banded.knn_banded(q, q, 16, st, w0))
        for (qi, si), st in ((1, 0), starts[(1, 0)]), ((1, 1), starts[(1, 1)]):
            q, sup = levels[qi], levels[si]
            size = banded._window(q.shape[1], sup.shape[1], w0)
            check_banded_knn(rep, f"{kind} q{tuple(q.shape)} s{tuple(sup.shape)} k=63", q, sup,
                             63, st, size, banded.knn_banded(q, sup, 63, st, w0))
        for qi, si, k in ((0, 0, 8), (1, 0, 16), (3, 2, 16)):
            q, sup = levels[qi], levels[si]
            m, n = q.shape[1], sup.shape[1]
            size = banded._window(m, n, w0)
            st = (torch.randint(0, (n - size) // 128 + 1, (B, m // banded.TQ), device=dev,
                                generator=gen) * 128).to(torch.int32)
            if m // banded.TQ > 1 and bool((st[:, 1:] >= st[:, :-1]).all()):
                raise AssertionError("the random starts came out monotone")
            check_banded_knn(rep, f"{kind} q{tuple(q.shape)} s{tuple(sup.shape)} k={k} "
                             "non-monotone starts", q, sup, k, st, size,
                             banded.knn_banded(q, sup, k, st, w0))
        # level 3's own neighbours come from the exact kNN (128 < 256); its
        # gather still takes the banded route with the full window S = 128
        knn_idx[(3, 3)] = knn_exact(levels[3], levels[3], 16)[0].contiguous()
        starts[(3, 3)] = banded._starts_tensor(128, 128, w0, dev)
        for (qi, si), c in GATHER_CALLS:
            idx, st = knn_idx[(qi, si)], starts[(qi, si)]
            n_src = levels[si].shape[1]
            m, k = idx.shape[1:]
            size = banded.window_starts(m, n_src, banded.window_width(n_src, w0))[1]
            if not banded.gather_supports(m, n_src, c, k, 4, w0):
                raise AssertionError(f"banded gather would not take m={m} n={n_src} c={c}")
            inside = (idx.long() - banded._per_row_starts(st, B)[:, :, None])
            inside = (inside >= 0) & (inside < size)
            if not bool(inside.all()):
                raise AssertionError(f"{kind} {(qi, si)}: a kNN index lies outside its window")
            # some indices moved anywhere in the cloud: outside the window they
            # give zero rows and their contributions are dropped
            moved = torch.where(torch.rand(idx.shape, device=dev, generator=gen) < 0.1,
                                torch.randint(0, n_src, idx.shape, device=dev, dtype=torch.int32,
                                              generator=gen), idx)
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn(B, n_src, c, device=dev, generator=gen).to(dtype)
                g = torch.randn(B, m, k, c, device=dev, generator=gen).to(dtype)
                label = (f"{kind} x({B},{n_src},{c}) idx{tuple(idx.shape)} S={size} "
                         f"starts{tuple(st.shape)} {str(dtype)[6:]}")
                stride = 0 if st.ndim == 1 else st.shape[1]
                for what, ii in (("", idx), (" out-of-window", moved)):
                    rep.check("banded_gather", label + what, [banded.gather_banded(x, ii, st, w0)],
                              [banded.gather_banded_plain(x, ii, st, size)])
                    got = banded.scatter_banded(g, ii, st, n_src, size)
                    want = banded.scatter_banded_plain(g, ii, st, n_src, size)
                    rep.check("banded_scatter", label + what, [got], [want])
                    rep.check("banded_scatter", label + what + " again",
                              [banded.scatter_banded(g, ii, st, n_src, size)], [got])
                    for config in SCATTER_CONFIGS:
                        cfg = scatter_passes(c, *config)
                        rep.check("banded_scatter", f"{label}{what} (passes, wide, budget) {cfg}",
                                  [banded.launch_scatter(g, ii, st, stride, n_src, size, *cfg)],
                                  [want])
                    del want
                if size < n_src and bool(torch.equal(
                        banded.gather_banded(x, moved, st, w0), banded.gather_banded(x, idx, st, w0))):
                    raise AssertionError(f"{label}: no moved index left its window")
                # the instance and split the wrapper did not pick at this shape
                _, staged = banded.gather_config(B, m, c, k, size, x.element_size())
                window = size * c * x.element_size() + banded.TQ * k * 4
                for parts, other in ((1, not staged), (16, not staged), (2, staged)):
                    if other and window > build.SMEM_BYTES:
                        continue
                    rep.check("banded_gather",
                              f"{label} out-of-window parts={parts} staged={other}",
                              [banded.launch_gather(x, moved, st, stride, size, parts, other)],
                              [banded.gather_banded_plain(x, moved, st, size)])
                if not path:
                    continue
                on_path = dtype == torch.bfloat16
                esize = x.element_size()
                wide = idx.long().reshape(B, m * k, 1).expand(-1, -1, c)
                mask = inside.reshape(B, m * k, 1).to(dtype)
                rep.timed("banded_gather", label,
                          lambda x=x, i=idx, st=st: banded.gather_banded(x, i, st, w0),
                          lambda x=x, i=idx, st=st, size=size:
                          banded.gather_banded_plain(x, i, st, size), 10, on_path,
                          nbytes=B * (n_src * c * esize + m * k * 4 + m * k * c * esize)
                          + st.numel() * 4, flops=0.0,
                          library=lambda x=x, w=wide, mask=mask: torch.gather(x, 1, w) * mask)
                flat = (idx.long() + n_src * torch.arange(B, device=dev)[:, None, None]).reshape(-1)

                def index_add(g=g, flat=flat, n_src=n_src, c=c):
                    out = torch.zeros((B * n_src, c), dtype=g.dtype, device=g.device)
                    return out.index_add_(0, flat, g.reshape(-1, c))

                rep.timed("banded_scatter", label,
                          lambda g=g, i=idx, st=st, n=n_src, size=size:
                          banded.scatter_banded(g, i, st, n, size),
                          lambda g=g, i=idx, st=st, n=n_src, size=size:
                          banded.scatter_banded_plain(g, i, st, n, size), 10, on_path,
                          nbytes=B * (m * k * c * esize + m * k * 4 + n_src * c * esize)
                          + st.numel() * 4, flops=1.0 * B * m * k * c, library=index_add)
                del wide, mask, flat
            del moved
    check_banded_scatter_cases(dev, rep, gen)
    log("  banded: kNN, gather and scatter bit-equal to their plain versions on the sorted and "
        "the near-tie cloud, with rank-1 and rank-2 starts and with out-of-window indices; the "
        "kNN also at k=63 and on non-monotone starts, in every launch configuration")


def check_banded_knn(rep: KernelReport, label: str, q, sup, k: int, st, size: int, got) -> None:
    """The banded kNN's result ``got`` (from the wrapper) and the kernel in
    every launch configuration it takes at this window and k
    (``banded.knn_configs``: queries a block and parts of the window), idx
    and dist bit-equal to the plain version."""
    from afford_motion_torch.ops.cuda import banded

    want = banded.knn_banded_plain(q, sup, k, st, size)
    rep.check("banded_knn", label, got, want)
    stride = 0 if st.ndim == 1 else st.shape[1]
    for cfg in banded.knn_configs(size, k):
        rep.check("banded_knn", f"{label} (queries, groups) {cfg}",
                  banded.launch_knn(q, sup, k, st, stride, size, *cfg), want)


def check_banded_scatter_cases(dev: torch.device, rep: KernelReport, gen) -> None:
    """The banded scatter off the kNN's indices, at the path's (1, 0) and
    (0, 0) shapes: non-monotone rank-2 starts; a hub destination that 192
    positions of three tiles hit; one destination that 6144 positions hit,
    and a range whose 6144 positions go to two destinations; one channel.
    A tenth of the indices anywhere in the cloud (out of their windows).
    Each bit-equal to the plain version in bf16 and f32, and again."""
    from afford_motion_torch.ops.cuda import banded

    def check(label, idx, st, n, c):
        m, k = idx.shape[1:]
        size = banded._window(m, n, 128)
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.randn(B, m, k, c, device=dev, generator=gen).to(dtype)
            got = banded.scatter_banded(g, idx, st, n, size)
            rep.check("banded_scatter", f"{label} {str(dtype)[6:]}", [got],
                      [banded.scatter_banded_plain(g, idx, st, n, size)])
            rep.check("banded_scatter", f"{label} {str(dtype)[6:]} again",
                      [banded.scatter_banded(g, idx, st, n, size)], [got])

    def inside(st, m, k, size):
        """Indices drawn inside each tile's window, and a tenth anywhere."""
        rel = torch.randint(0, size, (B, m, k), device=dev, generator=gen)
        idx = banded._per_row_starts(st, B)[:, :, None] + rel
        moved = torch.rand(idx.shape, device=dev, generator=gen) < 0.1
        anywhere = torch.randint(0, N_POINTS, idx.shape, device=dev, generator=gen)
        return torch.where(moved, anywhere, idx).to(torch.int32).contiguous()

    m, k = 2048, 16                         # (1, 0): 16 tiles, S = 768
    size = banded._window(m, N_POINTS, 128)
    tiles = m // banded.TQ
    st = torch.randint(0, (N_POINTS - size) // 128 + 1, (B, tiles), device=dev,
                       generator=gen) * 128
    st = st.to(torch.int32).contiguous()    # random per tile: not monotone
    if bool((st[:, 1:] >= st[:, :-1]).all()):
        raise AssertionError("the random starts came out monotone")
    check("non-monotone starts (1,0) C=35", inside(st, m, k, size), st, N_POINTS, 35)
    check("non-monotone starts (1,0) C=1", inside(st, m, k, size), st, N_POINTS, 1)
    # three tiles whose windows hold destination 5000: 64 positions each hit it
    st = st.clone()
    st[:, 2:5] = 4608
    idx = inside(st, m, k, size).clone()
    for t in range(2, 5):
        idx[:, t * banded.TQ:t * banded.TQ + 64, 0] = 5000
    check("hub of 192 positions over 3 tiles (1,0) C=35", idx, st, N_POINTS, 35)
    # all 6144 positions of those tiles on it
    idx[:, 2 * banded.TQ:5 * banded.TQ, :] = 5000
    check("one destination over 6144 positions (1,0) C=35", idx, st, N_POINTS, 35)
    # the same positions spread over two destinations of one range
    idx[:, 2 * banded.TQ:5 * banded.TQ, 8:] = 5001
    check("a range of 6144 positions on two destinations (1,0) C=35", idx, st, N_POINTS, 35)
    m, k = N_POINTS, 8                      # (0, 0): 64 tiles, S = 384, static starts
    st = banded._starts_tensor(m, N_POINTS, 128, dev)
    check("static starts (0,0) C=1", inside(st, m, k, banded._window(m, N_POINTS, 128)), st,
          N_POINTS, 1)
    log("  banded scatter: non-monotone starts, a hub of 192 positions, 6144 positions on one "
        "and on two destinations, C=1 bit-equal")


def phase_kernels_scene(dev: torch.device, rep: KernelReport) -> None:
    """The scene slice's two kernels against their plain versions: the fused
    1-NN at the protocol's shape on the clouds of :func:`nn1_cloud` (timed,
    with the share of pairs it evaluates; cloud a sets the kernels line's
    row, as it has since the kernel's first port, and cloud b, a body in a
    room, is logged beside it) and of :func:`nn1_faces_cloud`, the fused
    attention at the
    denoiser's and the regressor's."""
    import torch.nn.functional as F

    from afford_motion_torch.ops.cuda.attention import TOLERANCE, attention_cuda, attention_plain
    from afford_motion_torch.ops.cuda.sdf import nn1_cuda, nn1_launch, nn1_plain

    rng = np.random.default_rng(SEED + 4)
    for kind in ("a", "b"):
        points, verts = (torch.from_numpy(x).to(dev) for x in nn1_cloud(kind, rng))
        label = f"cloud {kind} points({N_POINTS},3) verts({L},{N_VERTS},3)"
        want = nn1_plain(points, verts)
        rep.check("nn1", label, nn1_cuda(points, verts), want)

        def cdist_argmin(points=points, verts=verts):
            out = []
            for v in verts:
                d = torch.cdist(points, v)
                out.append((d.min(dim=1).values, d.argmin(dim=1)))
            return out

        # the skip of pairs is exact, so the bound is the bytes: points,
        # vertices, d2 and idx
        rep.timed("nn1", label, lambda: nn1_cuda(points, verts), lambda: nn1_plain(points, verts),
                  3, kind == "a", nbytes=(N_POINTS + L * N_VERTS) * 12 + L * N_POINTS * 8,
                  flops=0.0, library=cdist_argmin)
        visits = torch.zeros(1, dtype=torch.int64, device=dev)
        nn1_launch(points, verts, visits)
        share = float(visits[0]) / (N_POINTS * L * N_VERTS)
        # per evaluated pair: 3 differences, 3 products, 2 sums, without FMA
        floor = 2e3 * 8.0 * float(visits[0]) / F32_FLOP_PER_S
        dense = 2e3 * 8.0 * N_POINTS * L * N_VERTS / F32_FLOP_PER_S
        log(f"  nn1 {label}: evaluates {share:.5f} of the point-vertex pairs; their no-FMA "
            f"floor {floor:.4f} ms, a dense scan's {dense:.4f} ms")
        del points, verts, want
    # duplicated and near-tie vertices on a 16^3 grid, queries on the same
    # grid; and a vertex count that no group of 32 divides, with queries off
    # the kernel's block of 1024
    grid_v = torch.from_numpy(
        (rng.integers(0, 16, size=(4, N_VERTS, 3)) * 0.125).astype(np.float32)).to(dev)
    grid_p = torch.from_numpy(
        (rng.integers(0, 16, size=(N_POINTS, 3)) * 0.125).astype(np.float32)).to(dev)
    grid_v[0, 9000] = grid_v[0, 17]   # an exact duplicate in a later tile
    got = nn1_cuda(grid_p, grid_v)
    rep.check("nn1", "near-tie grid", got, nn1_plain(grid_p, grid_v))
    if float((got[0] == 0).float().mean()) < 0.5:
        raise AssertionError("nn1 near-tie grid: too few exact hits for a tie test")
    points, verts = (torch.from_numpy(x).to(dev) for x in nn1_cloud("a", rng, 1000, 3, 4099))
    rep.check("nn1", "odd (1000 points, 4099 vertices)", nn1_cuda(points, verts),
              nn1_plain(points, verts))
    # every group's vertices on its box's faces, exact ties across mirror
    # images, coordinates whose squares round
    points, verts = (torch.from_numpy(x).to(dev) for x in nn1_faces_cloud(rng, 160, 4, N_POINTS))
    rep.check("nn1", "faces", nn1_cuda(points, verts), nn1_plain(points, verts))
    log("  nn1: idx and d2 bit-equal to the plain version at the protocol shape on clouds a "
        "and b, on the near-tie grid, at the odd sizes and on the faces cloud")
    del verts, grid_v

    # the denoiser's attention (time + text + 128 contact + 196 motion tokens,
    # the motions' padded frames masked) and the regressor's
    shapes = {"denoiser": (B, 1 + 1 + 128 + L, 8, torch.bfloat16, CMDM_LAYERS),
              "regressor": (FIT_BATCH, L, 4, torch.float32, REGRESSOR_LAYERS)}
    for what, (b, seq, heads, dtype, _) in shapes.items():
        hd = 64
        q, k, v = (torch.from_numpy(rng.normal(size=(b, seq, heads * hd)).astype(np.float32))
                   .to(dev).to(dtype) for _ in range(3))
        lengths = rng.integers(40, L + 1, size=b)
        pad = torch.from_numpy(np.arange(L)[None, :] >= lengths[:, None])
        pad = torch.cat([torch.zeros((b, seq - L), dtype=torch.bool), pad], dim=1).to(dev)
        label = f"{what} ({b},{seq},{heads}x{hd}) {str(dtype)[6:]}"
        check_attention(rep, label, q, k, v, heads, pad)
        check_attention(rep, label + " no mask", q, k, v, heads, None)

        def heads_first(x, b=b, heads=heads, hd=hd):
            return x.reshape(b, -1, heads, hd).transpose(1, 2)

        keep = ~pad[:, None, None, :]
        size = q.element_size()
        valid = float((~pad).sum())
        # each valid query-key pair of a head: hd products and sums for the
        # logit, hd for the weighted sum, at the card's rate for the type
        k_ms, _, l_ms = rep.timed(
            "attention", label, lambda: attention_cuda(q, k, v, heads, pad),
            lambda: attention_plain(q, k, v, heads, pad), 10,
            nbytes=4 * b * seq * heads * hd * size + b * seq, flops=4.0 * heads * hd * seq * valid,
            peak=BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S,
            library=lambda: F.scaled_dot_product_attention(
                heads_first(q), heads_first(k), heads_first(v), attn_mask=keep))
        log(f"  attention {what}: kernel / scaled_dot_product_attention = {k_ms / l_ms:.3f}; "
            f"the library call's kernels: {sdpa_kernels(heads_first(q), heads_first(k), heads_first(v), keep)}")
    # off the path, checked but not timed: head dimensions below the kernel's
    # 64, a key length other than the queries', a batch item with one attended
    # key, and a whole tile of 64 keys masked between attended ones
    for hd, dtype in ((8, torch.float32), (8, torch.bfloat16), (40, torch.bfloat16),
                      (64, torch.float32), (64, torch.bfloat16)):
        q = torch.from_numpy(rng.normal(size=(3, 70, 2 * hd)).astype(np.float32)).to(dev).to(dtype)
        k, v = (torch.from_numpy(rng.normal(size=(3, 150, 2 * hd)).astype(np.float32)).to(dev)
                .to(dtype) for _ in range(2))
        pad = torch.from_numpy(np.arange(150)[None, :] >= np.array([[150], [100], [1]])).to(dev)
        pad[:2, 64:128] = True
        check_attention(rep, f"off-path hd={hd} {str(dtype)[6:]}", q, k, v, 2, pad)
    atol = {str(t)[6:]: a for t, (a, _) in TOLERANCE.items()}
    log(f"  attention: within {atol} of the largest |v| (+ one bf16 ulp of the result for "
        "bf16) of the plain version at the denoiser's and the regressor's shapes, masked and "
        "not, and at head dimensions 8, 40 and 64 with 150 keys for 70 queries, one "
        "attended key, and a masked tile; the bf16 checks needed at most "
        f"2^{np.log2(rep.attention_bf16_atol):.2f} of the largest |v| beyond the ulp term")


def sdpa_kernels(q, k, v, keep) -> str:
    """The CUDA kernels one ``scaled_dot_product_attention`` call launches
    (which of its backends it took), from a profile of one call."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages() if e.device_type.name == "CUDA"})
    return "; ".join(n[:80] for n in names) or "none seen by the profiler"


def device_ms(fn, reps: int, names) -> dict | None:
    """ms per call of each kernel ``fn`` launches whose symbol holds one of
    ``names``, from the profiler's device time over ``reps`` calls after a
    warm-up call: {name: ms}. For kernels launched by one call, which CUDA
    events cannot time apart. None where the profiler saw no device time for
    one of them: it does not see the card on every machine, so a split taken
    here is a log line and never a check."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms = {n: 0.0 for n in names}
    for e in prof.key_averages():
        for n in names:
            if e.device_type.name == "CUDA" and n in e.key:
                ms[n] += e.self_device_time_total / 1e3 / reps
    return ms if all(ms.values()) else None


def check_attention(rep: KernelReport, label: str, q, k, v, heads: int, pad) -> None:
    """The fused attention against its plain version, to the kernel's stated
    tolerance for the inputs' type (``TOLERANCE`` in ops/cuda/attention.py)."""
    from afford_motion_torch.ops.cuda.attention import TOLERANCE, attention_cuda, attention_plain

    atol, rtol = TOLERANCE[q.dtype]
    got, want = attention_cuda(q, k, v, heads, pad), attention_plain(q, k, v, heads, pad)
    v_max = float(v.float().abs().max())
    rep.check_close("attention", label, got, want, atol * v_max, rtol)
    if q.dtype == torch.bfloat16:
        excess = (got.float() - want.float()).abs() - rtol * want.float().abs()
        rep.attention_bf16_atol = max(rep.attention_bf16_atol, float(excess.max()) / v_max)


def check_attention_bwd(rep: KernelReport, label: str, q, k, v, do, heads: int, pad):
    """The backward kernels against ``attention_backward_plain`` on the
    kernel forward's o and row statistics (the forward's o bit-identical with
    and without them, the statistics within LSE_LIMIT of the plain ones), to
    ``TOLERANCE_BWD`` and for bf16 at most ``DV_DIFFER_SHARE`` of dv's
    entries differing; two calls bit-identical; masked keys without a
    gradient. Returns the forward's (o, lse)."""
    from afford_motion_torch.ops.cuda import attention as attn

    o0, _ = attn.attention_forward_cuda(q, k, v, heads, pad)
    o, lse = attn.attention_forward_cuda(q, k, v, heads, pad, stats=True)
    if not torch.equal(bits(o), bits(o0)):
        raise AssertionError(f"attention {label}: o differs with the statistics written")
    want_lse = attn.attention_lse_plain(q, k, heads, pad)
    inf = torch.isinf(want_lse)
    lse_err = float((lse - want_lse)[~inf].abs().max()) if bool((~inf).any()) else 0.0
    if not (torch.equal(torch.isinf(lse), inf) and bool((lse[inf] > 0).all())
            and lse_err <= LSE_LIMIT * max(1.0, float(want_lse[~inf].abs().max()))):
        raise AssertionError(f"attention {label}: statistics differ from the plain ones "
                             f"(max {lse_err:.3e})")
    got = attn.attention_backward_cuda(q, k, v, o, do, lse, heads, pad)
    again = attn.attention_backward_cuda(q, k, v, o, do, lse, heads, pad)
    if not all(torch.equal(bits(a), bits(b)) for a, b in zip(got, again)):
        raise AssertionError(f"attention backward {label}: two calls differ")
    want = attn.attention_backward_plain(q, k, v, o, do, lse, heads, pad)
    atol, rtol = attn.TOLERANCE_BWD[q.dtype]
    need = attn.backward_excess(got, want, rtol)
    differ = float((got[2] != want[2]).float().mean())
    log(f"  attention backward {label}: needs {need:.3e} of the largest gradient entry "
        f"beyond the rtol term (limit {atol:.3e}); {differ:.4f} of dv's entries differ; "
        f"lse max diff {lse_err:.3e}")
    if need > atol or (q.dtype == torch.bfloat16 and differ > attn.DV_DIFFER_SHARE):
        raise AssertionError(f"attention backward {label}: kernel differs from plain")
    if pad is not None and any(bool(g[pad].any()) for g in got[1:]):
        raise AssertionError(f"attention backward {label}: a masked key has a gradient")
    key = "bf16" if q.dtype == torch.bfloat16 else "f32"
    rep.attention_bwd_need[key] = max(rep.attention_bwd_need[key], need)
    if key == "bf16":
        rows = (("attention_bwd_dq", (got[0], want[0])),
                ("attention_bwd_dkv", (torch.cat(got[1:]), torch.cat(want[1:]))))
    else:
        rows = (("attention_bwd_f32", (torch.cat([g.reshape(-1) for g in got]),
                                       torch.cat([w.reshape(-1) for w in want]))),)
    for name, (g, w) in rows:
        rep.err[name] = max(rep.err[name], (g.double() - w.double()).abs().max().item())
    return o, lse


def phase_kernels_attention_bwd(dev: torch.device, rep: KernelReport) -> None:
    """The fused attention's backward kernels (bf16 and f32: one kernel each
    for dq, dk and dv) against ``attention_backward_plain`` on the same
    inputs (the kernel forward's o and statistics), to ``TOLERANCE_BWD``,
    and for bf16 at most ``DV_DIFFER_SHARE`` of dv's entries differing at
    all; two calls bit-identical; the forward's o bit-identical with and
    without the statistics, which must match ``attention_lse_plain``. At the
    train path's shape (batch 32, 326 tokens, 8 heads of 64, the CMDM's
    masks) in both instances, at the regressor's f32 shape, and off the path
    at head dimensions 8, 40 and 64 with odd lengths, a masked tile of 64
    keys and an item with no attended key, and at 1100 keys. Timed at the
    train shape: the whole backward against the gradient of
    ``scaled_dot_product_attention`` with the same mask and beside its bound,
    and by the profiler's device time where it sees the kernel
    (:func:`device_ms`, logged)."""
    import torch.nn.functional as F

    from afford_motion_torch.ops.cuda import attention as attn

    rng = np.random.default_rng(SEED + 6)

    def tensors(b, lq, lk, heads, hd, dtype):
        return [torch.from_numpy(rng.normal(size=(b, n, heads * hd)).astype(np.float32)).to(dev)
                .to(dtype) for n in (lq, lk, lk, lq)]

    # the train path's attention (time + text + 128 contact + 196 motion
    # tokens, the motions' padded frames masked) in both instances, and the
    # regressor's shape in f32
    shapes = {"train": (B, 1 + 1 + 128 + L, 8), "regressor": (FIT_BATCH, L, 4)}
    for what, (b, seq, heads) in shapes.items():
        hd = 64
        lengths = rng.integers(40, L + 1, size=b)
        pad = torch.from_numpy(np.arange(L)[None, :] >= lengths[:, None])
        pad = torch.cat([torch.zeros((b, seq - L), dtype=torch.bool), pad], dim=1).to(dev)
        for dtype in ((torch.bfloat16, torch.float32) if what == "train" else (torch.float32,)):
            q, k, v, do = tensors(b, seq, seq, heads, hd, dtype)
            label = f"{what} ({b},{seq},{heads}x{hd}) {str(dtype)[6:]}"
            o, lse = check_attention_bwd(rep, label, q, k, v, do, heads, pad)
            if what != "train":   # off every train path: the whole backward, logged
                whole = time_ms(lambda: attn.attention_backward_cuda(q, k, v, o, do, lse, heads,
                                                                     pad), 10)
                log(f"  attention backward {label}, whole: kernels {whole[0]:.4f} ms "
                    f"({whole[1]:.4f}-{whole[2]:.4f})")
                continue
            # timed: the whole backward by CUDA events, and by the
            # profiler's device time over the same calls where it sees the
            # kernel. Each instance is one kernel for dq, dk and dv: bf16's
            # time stands in both bf16 rows, f32's in its own
            bf16 = dtype == torch.bfloat16
            size = q.element_size()
            tokens = b * seq * heads * hd   # entries of one (B, L, D) tensor
            pairs = float(seq * (~pad).sum()) * heads   # attended query-key pairs
            product = 2.0 * hd * pairs                  # one of the five products
            peak = BF16_FLOP_PER_S if bf16 else F32_FLOP_PER_S
            stats = b * heads * seq * 4
            qh, kh, vh = (x.reshape(b, seq, heads, hd).transpose(1, 2).detach()
                          .requires_grad_(True) for x in (q, k, v))
            doh = do.reshape(b, seq, heads, hd).transpose(1, 2)
            out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=~pad[:, None, None, :])

            def backward():
                return attn.attention_backward_cuda(q, k, v, o, do, lse, heads, pad)

            whole = time_ms(backward, 10)
            split = device_ms(backward, 10, ("attention_bwd_bf16",) if bf16 else (
                "attention_bwd_f32",))
            plain = time_ms(lambda: attn.attention_backward_plain(q, k, v, o, do, lse, heads,
                                                                  pad), 3, PLAIN_BLOCKS)
            lib = time_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True),
                          10)
            # the whole: q, k, v, o, dO, lse read, dq, dk, dv written. The
            # plain version and the library call compute the three gradients
            # at once
            how = f"the whole backward, median of {TIME_BLOCKS} blocks"
            names = ("attention_bwd_dkv", "attention_bwd_dq") if bf16 else ("attention_bwd_f32",)
            for name in names:
                rep.record(name, label, whole[0], how, plain[0], nbytes=8 * tokens * size + stats,
                           flops=5 * product, peak=peak,
                           line=f", the whole backward's library call {lib[0]:.4f} ms")
                rep.library_ms[name] = lib[0]
            b_ms, by = bound_ms(1e3 * (8 * tokens * size + stats) / HBM_BYTES_PER_S,
                                1e3 * 5 * product / peak)
            log(f"  attention backward {label}, whole: kernels {whole[0]:.4f} ms ({whole[1]:.4f}-"
                f"{whole[2]:.4f}; by the profiler "
                + (", ".join(f"{n[10:]} {t:.4f}" for n, t in split.items()) if split
                   else "not measured: it saw no device time") + "), the "
                f"gradient of scaled_dot_product_attention {lib[0]:.4f} ms ({lib[1]:.4f}-"
                f"{lib[2]:.4f}), kernels / library {whole[0] / lib[0]:.3f}, bound {b_ms:.4f} ms "
                f"({by}: 5 products of {product / 1e9:.3f} GFLOP, "
                f"{(8 * tokens * size + stats) / 1e6:.1f} MB)")
            del out, qh, kh, vh, doh
    # off the path, checked but not timed: head dimensions below 64, odd
    # lengths (other key lengths than query lengths), a masked tile of 64 keys
    # between attended ones, an item with one attended key and one with none
    for hd, dtype in ((8, torch.float32), (8, torch.bfloat16), (40, torch.bfloat16),
                      (40, torch.float32), (64, torch.float32), (64, torch.bfloat16)):
        for lq, lk in ((70, 150), (133, 133)):
            q, k, v, do = tensors(4, lq, lk, 2, hd, dtype)
            pad = torch.from_numpy(np.arange(lk)[None, :] >= np.array([[lk], [lk - 3], [1], [0]]))
            pad[:2, 64:128] = True
            check_attention_bwd(rep, f"off-path hd={hd} Lq={lq} Lk={lk} {str(dtype)[6:]}", q,
                                k, v, do, 2, pad.to(dev))
    # 1100 keys (18 key tiles), a masked stretch across tiles
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = tensors(3, 100, 1100, 2, 64, dtype)
        pad = torch.from_numpy(np.arange(1100)[None, :] >= np.array([[1100], [1000], [300]]))
        pad[:2, 448:640] = True
        check_attention_bwd(rep, f"off-path hd=64 Lq=100 Lk=1100 {str(dtype)[6:]}", q, k, v, do,
                            2, pad.to(dev))
    log(f"  attention backward: within TOLERANCE_BWD of the plain version at every shape, "
        f"two calls bit-identical; the largest share needed: bf16 "
        f"2^{np.log2(max(rep.attention_bwd_need['bf16'], 1e-30)):.2f}, f32 "
        f"2^{np.log2(max(rep.attention_bwd_need['f32'], 1e-30)):.2f}")


def phase_kernels_trans_dec(dev: torch.device, rep: KernelReport) -> None:
    """The kernels at the shapes CMDM ``trans_dec`` adds (timed, logged, and
    kept out of the kernels line's pass sums, which stay ``trans_enc``'s):
    the up kNN at k = 3 (#2 on the FPS pyramid of a random and a near-tie
    cloud, #5 on the sorted pyramid with the adaptive up starts), bit-equal
    to their plain versions; the up-gathers and their scatters (#3/#4, and
    #6/#7 with the up starts) bit-equal; the fused attention forward and
    backward as cross-attention, 198 queries against 128, 512, 2048 and
    8192 keys, bf16 and f32, with an item whose keys are all masked and one
    with its last 40% masked, within ``TOLERANCE`` / ``TOLERANCE_BWD``; and the
    all-masked item through the module's fused route
    (``layers._uniform_where_all_masked``) against the einsum route,
    forward and the gradient of v."""
    import torch.nn.functional as F

    from afford_motion_torch.models import layers
    from afford_motion_torch.ops.cuda import attention as attn
    from afford_motion_torch.ops.cuda import banded
    from afford_motion_torch.ops.cuda import knn as knn_mod
    from afford_motion_torch.ops.cuda.fps import fps_cuda
    from afford_motion_torch.ops.cuda.gather import (
        gather_rows, gather_rows_plain, scatter_add_rows, scatter_add_rows_plain)
    from afford_motion_torch.ops.cuda.knn import knn_cuda, knn_plain
    from afford_motion_torch.ops.curves import curve_order
    from afford_motion_torch.ops.pointops import knn as knn_exact

    rng = np.random.default_rng(SEED + 11)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    w0 = 128
    clouds = {
        "random": rng.normal(size=(B, N_POINTS, 3)).astype(np.float32),
        "near-tie": (rng.integers(0, 16, size=(B, N_POINTS, 3)) * 0.125).astype(np.float32),
    }
    for kind, cloud in clouds.items():
        for route in ("plain", "banded"):
            if route == "banded":
                cloud = np.stack([c[curve_order(c, "hilbert")] for c in cloud])
            levels, fps = [torch.from_numpy(cloud).to(dev)], [None]
            for n_out in (2048, 512, 128):
                idx = fps_cuda(levels[-1], n_out)
                if route == "banded":
                    idx = torch.sort(idx, dim=-1).values
                fps.append(idx)
                levels.append(torch.gather(levels[-1], 1, idx.long()[..., None].expand(-1, -1, 3)))
            timed = kind == "random"
            for fine, coarse, c in UP_CALLS:
                q, sup = levels[fine], levels[coarse]
                m, n = q.shape[1], sup.shape[1]
                label = f"{kind} up q{tuple(q.shape)} s{tuple(sup.shape)} k=3"
                st, size = None, n
                if route == "plain":
                    if knn_mod.supports(m, n, 3):
                        got = knn_cuda(q, sup, 3)
                        rep.check("knn", label, got, knn_plain(q, sup, 3))
                        if timed:
                            rep.timed("knn", label, lambda q=q, s=sup: knn_cuda(q, s, 3),
                                      lambda q=q, s=sup: knn_plain(q, s, 3), 5, False,
                                      nbytes=B * ((m + n) * 12 + m * 3 * 8), flops=0.0)
                        idx = got[0]
                    else:   # the exact path, as in the hierarchy
                        idx = knn_exact(q, sup, 3)[0].contiguous()
                        log(f"  {label}: below the kNN kernel's range, the exact path")
                else:
                    size = banded._window(m, n, w0)
                    if banded.knn_supports(m, n, 3):
                        st = banded.adaptive_up_starts(fps[coarse], m, w0)
                        got = banded.knn_banded(q, sup, 3, st, w0)
                        check_banded_knn(rep, f"{label} up starts{tuple(st.shape)} S={size}", q,
                                         sup, 3, st, size, got)
                        if timed:
                            rep.timed("banded_knn", f"{label} S={size}",
                                      lambda q=q, s=sup, st=st: banded.knn_banded(q, s, 3, st, w0),
                                      lambda q=q, s=sup, st=st, size=size:
                                      banded.knn_banded_plain(q, s, 3, st, size), 5, False,
                                      nbytes=B * ((m + n) * 12 + m * 3 * 8) + st.numel() * 4,
                                      flops=9.0 * B * m * size)
                        idx = got[0]
                    else:
                        st = banded._starts_tensor(m, n, w0, dev)
                        idx = knn_exact(q, sup, 3)[0].contiguous()
                        log(f"  {label}: below the banded kNN's range, the exact path; the "
                            f"gather's window S={size} covers the {n} points")
                    if not banded.gather_supports(m, n, c, 3, 2, w0):
                        raise AssertionError(f"{label}: the banded gather would not take C={c}")
                # the up-gather of the coarse level's features and its scatter
                for dtype in (torch.bfloat16, torch.float32):
                    x = torch.randn(B, n, c, device=dev, generator=gen).to(dtype)
                    g = torch.randn(B, m, 3, c, device=dev, generator=gen).to(dtype)
                    glabel = f"{kind} up x({B},{n},{c}) idx{tuple(idx.shape)} {str(dtype)[6:]}"
                    size_b = x.element_size()
                    nbytes = B * (n * c * size_b + m * 3 * 4 + m * 3 * c * size_b)
                    wide = idx.long().reshape(B, m * 3, 1).expand(-1, -1, c)
                    flat = (idx.long() + n * torch.arange(B, device=dev)[:, None, None]).reshape(-1)

                    def index_add(g=g, flat=flat, n=n, c=c):
                        out = torch.zeros((B * n, c), dtype=g.dtype, device=g.device)
                        return out.index_add_(0, flat, g.reshape(-1, c))

                    if route == "plain":
                        rep.check("gather", glabel, [gather_rows(x, idx)],
                                  [gather_rows_plain(x, idx)])
                        rep.check("scatter", glabel, [scatter_add_rows(g, idx, n)],
                                  [scatter_add_rows_plain(g, idx, n)])
                        if timed and dtype == torch.bfloat16:
                            rep.timed("gather", glabel, lambda x=x, i=idx: gather_rows(x, i),
                                      lambda x=x, i=idx: gather_rows_plain(x, i), 10, False,
                                      nbytes=nbytes, flops=0.0,
                                      library=lambda x=x, w=wide: torch.gather(x, 1, w))
                            rep.timed("scatter", glabel,
                                      lambda g=g, i=idx, n=n: scatter_add_rows(g, i, n),
                                      lambda g=g, i=idx, n=n: scatter_add_rows_plain(g, i, n), 10,
                                      False, nbytes=nbytes, flops=1.0 * B * m * 3 * c,
                                      library=index_add)
                        continue
                    glabel += f" S={size} starts{tuple(st.shape)}"
                    rep.check("banded_gather", glabel, [banded.gather_banded(x, idx, st, w0)],
                              [banded.gather_banded_plain(x, idx, st, size)])
                    rep.check("banded_scatter", glabel, [banded.scatter_banded(g, idx, st, n, size)],
                              [banded.scatter_banded_plain(g, idx, st, n, size)])
                    if timed and dtype == torch.bfloat16:
                        rep.timed("banded_gather", glabel,
                                  lambda x=x, i=idx, st=st: banded.gather_banded(x, i, st, w0),
                                  lambda x=x, i=idx, st=st, size=size:
                                  banded.gather_banded_plain(x, i, st, size), 10, False,
                                  nbytes=nbytes + st.numel() * 4, flops=0.0,
                                  library=lambda x=x, w=wide: torch.gather(x, 1, w))
                        rep.timed("banded_scatter", glabel,
                                  lambda g=g, i=idx, st=st, n=n, size=size:
                                  banded.scatter_banded(g, i, st, n, size),
                                  lambda g=g, i=idx, st=st, n=n, size=size:
                                  banded.scatter_banded_plain(g, i, st, n, size), 10, False,
                                  nbytes=nbytes + st.numel() * 4, flops=1.0 * B * m * 3 * c,
                                  library=index_add)
                    del wide, flat
    log("  trans_dec: the up kNN at k=3 (#2 and #5 with the up starts), the up-gathers and "
        "their scatters (#3/#4, #6/#7) bit-equal to their plain versions on the random and "
        "the near-tie cloud")

    # the cross-attention: 198 queries (time, text, 196 frames) against each
    # U-Net scale; item 1's keys all masked (c_pc_mask), item 0's last 40%
    heads, width = 8, 512
    hd = width // heads
    identity = layers.Dropout(0.0)
    for lk in DEC_MEMORY:
        pad = torch.zeros((B, lk), dtype=torch.bool)
        pad[0, int(0.6 * lk):] = True
        pad[1] = True
        pad = pad.to(dev)
        keep = ~pad[:, None, None, :]
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn(B, DEC_QUERIES, width, device=dev, generator=gen).to(dtype)
            k, v = (torch.randn(B, lk, width, device=dev, generator=gen).to(dtype)
                    for _ in range(2))
            do = torch.randn(B, DEC_QUERIES, width, device=dev, generator=gen).to(dtype)
            label = f"cross ({B},{DEC_QUERIES}x{lk},{heads}x{hd}) {str(dtype)[6:]}"
            check_attention(rep, label, q, k, v, heads, pad)
            o, lse = check_attention_bwd(rep, label, q, k, v, do, heads, pad)
            # the module's fused route on the all-masked item against the
            # einsum route: the mean of v, and v's share of the gradient
            atol, rtol = attn.TOLERANCE[dtype]
            v_max = float(v.float().abs().max())
            leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            fused = layers._uniform_where_all_masked(
                attn.attention_cuda(*leaves, heads, pad), leaves[2], pad)
            fused.backward(do)
            e_leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            einsum = layers._attention(*e_leaves, heads, pad, identity)
            einsum.backward(do)
            diff = (fused[1].float() - einsum[1].float()).abs()
            dv_diff = (leaves[2].grad[1].float() - e_leaves[2].grad[1].float()).abs()
            dv_max = float(e_leaves[2].grad[1].float().abs().max())
            log(f"  attention {label}, all-masked item through the fused route: rows "
                f"{diff.max().item():.3e} from the einsum route's (limit {atol:.1e} max|v| + "
                f"{rtol:.1e} |einsum|), dv {dv_diff.max().item():.3e} of max {dv_max:.3e}; "
                f"dq, dk of the item zero: "
                f"{not bool(leaves[0].grad[1].any() or leaves[1].grad[1].any())}")
            if not (bool((diff <= atol * v_max + rtol * einsum[1].float().abs()).all())
                    and bool((dv_diff <= atol * dv_max
                              + rtol * e_leaves[2].grad[1].float().abs()).all())
                    and not bool(leaves[0].grad[1].any() or leaves[1].grad[1].any())):
                raise AssertionError(f"attention {label}: the fused route's all-masked item "
                                     "differs from the einsum route's")
            del leaves, e_leaves, fused, einsum
            # timed: the forward against SDPA with the same mask, and the
            # whole backward against SDPA's gradient; the bound counts the
            # attended pairs
            bf16 = dtype == torch.bfloat16
            peak = BF16_FLOP_PER_S if bf16 else F32_FLOP_PER_S
            size = q.element_size()
            pairs = float(DEC_QUERIES * (~pad).sum()) * heads
            io = (2 * q.numel() + 2 * k.numel()) * size
            qh = q.reshape(B, DEC_QUERIES, heads, hd).transpose(1, 2)
            kh, vh = (t.reshape(B, lk, heads, hd).transpose(1, 2) for t in (k, v))
            rep.timed("attention", label, lambda: attn.attention_cuda(q, k, v, heads, pad),
                      lambda: attn.attention_plain(q, k, v, heads, pad), 10, False,
                      nbytes=io + pad.numel(), flops=4.0 * hd * pairs, peak=peak,
                      library=lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=keep))
            stats = B * heads * DEC_QUERIES * 4
            nbytes = (4 * q.numel() + 4 * k.numel()) * size + stats
            qg, kg, vg = (t.detach().requires_grad_(True) for t in (qh, kh, vh))
            out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=keep)
            doh = do.reshape(B, DEC_QUERIES, heads, hd).transpose(1, 2)
            whole = time_ms(lambda: attn.attention_backward_cuda(q, k, v, o, do, lse, heads, pad),
                            10)
            plain = time_ms(lambda: attn.attention_backward_plain(q, k, v, o, do, lse, heads,
                                                                  pad), 2, PLAIN_BLOCKS)
            lib = time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), doh, retain_graph=True),
                          10)
            rep.record("attention_bwd_dkv" if bf16 else "attention_bwd_f32", label, whole[0],
                       f"the whole backward, median of {TIME_BLOCKS} blocks; {whole[1]:.4f}-"
                       f"{whole[2]:.4f}", plain[0], False, nbytes=nbytes, flops=5.0 * 2 * hd * pairs,
                       peak=peak, line=f", SDPA's whole backward {lib[0]:.4f} ms")
            del out, qg, kg, vg, o, lse
        del pad, keep
    log(f"  trans_dec cross-attention: within TOLERANCE and TOLERANCE_BWD at every Lk, the "
        f"all-masked item as on the einsum route; largest shares needed so far: forward bf16 "
        f"2^{np.log2(max(rep.attention_bf16_atol, 1e-30)):.2f}, backward bf16 "
        f"2^{np.log2(max(rep.attention_bwd_need['bf16'], 1e-30)):.2f}, f32 "
        f"2^{np.log2(max(rep.attention_bwd_need['f32'], 1e-30)):.2f}")


def phase_kernels_cdm_scene(dev: torch.device, rep: KernelReport) -> None:
    """The kernels at the shapes the CDM's scene model and its PointTrans
    backbones add (timed, logged, kept out of the kernels line's pass sums):
    the scene model's hierarchy at the train batch B_STAGE1 (FPS down to 32
    points, every kNN the kernel takes, each bit-equal to its plain
    version; FPS 512 -> 128 and 128 -> 32 and the k = 8 self kNN over 8192
    points timed), its float32 row gather at level 0 (B_STAGE1 x 8192 x 8 x
    67: xyz and the 32-wide k and v) bit-equal and timed beside
    ``torch.gather``, the bf16 scatter of PointTrans's level-0 block at that
    batch (3 + 2 x 64 channels) bit-equal and timed beside ``index_add_``;
    the same block on the stage-1 store's banded route (a sorted cloud: the
    banded self kNN, gather and scatter, each checked and timed); and V2's
    bottleneck attention (B chains x 128 tokens, 8 heads of 64,
    bf16, no mask) within ``TOLERANCE`` of its plain version, timed beside
    SDPA."""
    import torch.nn.functional as F

    from afford_motion_torch.models.pointtransformer import SEG_NSAMPLES, SEG_STRIDES
    from afford_motion_torch.ops.cuda import attention as attn
    from afford_motion_torch.ops.cuda import banded
    from afford_motion_torch.ops.cuda import knn as knn_mod
    from afford_motion_torch.ops.cuda.fps import fps_cuda, fps_plain
    from afford_motion_torch.ops.cuda.gather import (
        gather_rows, gather_rows_plain, scatter_add_rows, scatter_add_rows_plain)
    from afford_motion_torch.ops.cuda.knn import knn_cuda, knn_plain
    from afford_motion_torch.ops.curves import curve_order

    rng = np.random.default_rng(SEED + 13)
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    nb = B_STAGE1
    levels = [torch.from_numpy(rng.normal(size=(nb, N_POINTS, 3)).astype(np.float32)).to(dev)]
    for stride in SEG_STRIDES[1:]:
        parent = levels[-1]
        n_in, n_out = parent.shape[1], parent.shape[1] // stride
        label = f"scene ({nb},{n_in},3)->{n_out}"
        got = fps_cuda(parent, n_out)
        rep.check("fps", label, [got], [fps_plain(parent, n_out)])
        if n_out <= 128:
            rep.timed("fps", label, lambda p=parent, m=n_out: fps_cuda(p, m),
                      lambda p=parent, m=n_out: fps_plain(p, m), 5, False,
                      nbytes=nb * (n_in * 12 + n_out * 4), flops=10.0 * nb * n_out * n_in)
        levels.append(torch.gather(parent, 1, got.long()[..., None].expand(-1, -1, 3)))
    calls = [(li, li, SEG_NSAMPLES[li]) for li in range(5)]
    calls += [(li, li - 1, SEG_NSAMPLES[li]) for li in range(1, 5)]
    calls += [(li - 1, li, 3) for li in range(1, 5)]
    knn0 = None
    for qi, si, k in calls:
        q, sup = levels[qi], levels[si]
        m, n = q.shape[1], sup.shape[1]
        label = f"scene q{tuple(q.shape)} s{tuple(sup.shape)} k={k}"
        if not knn_mod.supports(m, n, k):
            log(f"  knn {label}: below the kernel's range, the exact path")
            continue
        got = knn_cuda(q, sup, k)
        rep.check("knn", label, got, knn_plain(q, sup, k))
        if (qi, si) == (0, 0):
            knn0 = got[0]
            rep.timed("knn", label, lambda q=q, s=sup, k=k: knn_cuda(q, s, k),
                      lambda q=q, s=sup, k=k: knn_plain(q, s, k), 5, False,
                      nbytes=nb * ((m + n) * 12 + m * k * 8), flops=0.0)
    del levels
    # the scene model's level-0 block gathers xyz, k and v (3 + 2 x 32
    # channels, float32) through the k = 8 neighbours
    c = SCENE_GATHER_C
    x = torch.randn(nb, N_POINTS, c, device=dev, generator=gen)
    label = f"scene x({nb},{N_POINTS},{c}) idx{tuple(knn0.shape)} float32"
    rep.check("gather", label, [gather_rows(x, knn0)], [gather_rows_plain(x, knn0)])
    wide = knn0.long().reshape(nb, -1, 1).expand(-1, -1, c)
    rows = knn0.shape[1] * knn0.shape[2]
    k_ms, _, l_ms = rep.timed(
        "gather", label, lambda: gather_rows(x, knn0), lambda: gather_rows_plain(x, knn0), 10,
        False, nbytes=nb * (N_POINTS * c * 4 + rows * 4 + rows * c * 4), flops=0.0,
        library=lambda: torch.gather(x, 1, wide))
    log(f"    gather {label}: kernel / torch.gather {k_ms / l_ms:.3f}")
    del x, wide
    # PointTrans's level-0 block at the train batch: 3 + 2 x 64 bf16 channels
    c = 3 + 2 * 64
    g = torch.randn(nb, N_POINTS, knn0.shape[2], c, device=dev, generator=gen).to(torch.bfloat16)
    label = f"PointTrans g{tuple(g.shape)} -> ({nb},{N_POINTS},{c}) bfloat16"
    got = scatter_add_rows(g, knn0, N_POINTS)
    rep.check("scatter", label, [got], [scatter_add_rows_plain(g, knn0, N_POINTS)])
    rep.check("scatter", label + " again", [scatter_add_rows(g, knn0, N_POINTS)], [got])
    flat = (knn0.long() + N_POINTS * torch.arange(nb, device=dev)[:, None, None]).reshape(-1)

    def index_add():   # reads this scope's g and flat when it is called
        out = torch.zeros((nb * N_POINTS, c), dtype=g.dtype, device=dev)
        return out.index_add_(0, flat, g.reshape(-1, c))

    rep.timed("scatter", label, lambda: scatter_add_rows(g, knn0, N_POINTS),
              lambda: scatter_add_rows_plain(g, knn0, N_POINTS), 10, False,
              nbytes=nb * (rows * c * 2 + rows * 4 + N_POINTS * c * 2), flops=1.0 * nb * rows * c,
              library=index_add)
    del g, got, flat, knn0
    # PointTrans through the stage-1 store: level 0 of a sorted cloud at the
    # train batch, its banded self kNN (k = 8, static starts) and the banded
    # gather and scatter of its block (131 bf16 channels)
    w0 = 128
    cloud = rng.normal(size=(nb, N_POINTS, 3)).astype(np.float32)
    xyz = torch.from_numpy(np.stack([p[curve_order(p, "hilbert")] for p in cloud])).to(dev)
    st = banded._starts_tensor(N_POINTS, N_POINTS, w0, dev)
    size = banded._window(N_POINTS, N_POINTS, w0)
    label = f"PointTrans store ({nb},{N_POINTS},3) k=8 S={size} starts{tuple(st.shape)}"
    got = banded.knn_banded(xyz, xyz, 8, st, w0)
    check_banded_knn(rep, label, xyz, xyz, 8, st, size, got)
    rep.timed("banded_knn", label, lambda: banded.knn_banded(xyz, xyz, 8, st, w0),
              lambda: banded.knn_banded_plain(xyz, xyz, 8, st, size), 5, False,
              nbytes=nb * (2 * N_POINTS * 12 + N_POINTS * 8 * 8) + st.numel() * 4,
              flops=9.0 * nb * N_POINTS * size)
    idx = got[0]
    x = torch.randn(nb, N_POINTS, c, device=dev, generator=gen).to(torch.bfloat16)
    g = torch.randn(nb, N_POINTS, 8, c, device=dev, generator=gen).to(torch.bfloat16)
    label = f"PointTrans store x({nb},{N_POINTS},{c}) idx{tuple(idx.shape)} bfloat16 S={size}"
    rep.check("banded_gather", label, [banded.gather_banded(x, idx, st, w0)],
              [banded.gather_banded_plain(x, idx, st, size)])
    rep.check("banded_scatter", label, [banded.scatter_banded(g, idx, st, N_POINTS, size)],
              [banded.scatter_banded_plain(g, idx, st, N_POINTS, size)])
    nbytes = nb * (N_POINTS * c * 2 + rows * 4 + rows * c * 2) + st.numel() * 4
    wide = idx.long().reshape(nb, -1, 1).expand(-1, -1, c)
    flat = (idx.long() + N_POINTS * torch.arange(nb, device=dev)[:, None, None]).reshape(-1)
    rep.timed("banded_gather", label, lambda: banded.gather_banded(x, idx, st, w0),
              lambda: banded.gather_banded_plain(x, idx, st, size), 10, False, nbytes=nbytes,
              flops=0.0, library=lambda: torch.gather(x, 1, wide))
    rep.timed("banded_scatter", label, lambda: banded.scatter_banded(g, idx, st, N_POINTS, size),
              lambda: banded.scatter_banded_plain(g, idx, st, N_POINTS, size), 10, False,
              nbytes=nbytes, flops=1.0 * nb * rows * c, library=index_add)
    del x, g, wide, flat, idx, got
    # V2's bottleneck self-attention in a chain of B
    hd = V2_WIDTH // V2_HEADS
    q, k, v = (torch.randn(B, V2_TOKENS, V2_WIDTH, device=dev, generator=gen).to(torch.bfloat16)
               for _ in range(3))
    label = f"V2 bottleneck ({B},{V2_TOKENS}x{V2_TOKENS},{V2_HEADS}x{hd}) bfloat16"
    check_attention(rep, label, q, k, v, V2_HEADS, None)
    qh, kh, vh = (t.reshape(B, V2_TOKENS, V2_HEADS, hd).transpose(1, 2) for t in (q, k, v))
    pairs = float(B * V2_HEADS * V2_TOKENS * V2_TOKENS)
    rep.timed("attention", label, lambda: attn.attention_cuda(q, k, v, V2_HEADS, None),
              lambda: attn.attention_plain(q, k, v, V2_HEADS, None), 10, False,
              nbytes=4 * q.numel() * 2, flops=4.0 * hd * pairs, peak=BF16_FLOP_PER_S,
              library=lambda: F.scaled_dot_product_attention(qh, kh, vh))
    log("  CDM scene: FPS to 32 points and the scene hierarchy's kNN at batch "
        f"{nb}, the float32 gather and the bf16 scatter of level 0 bit-equal to their plain "
        "versions; V2's bottleneck attention within TOLERANCE")


def phase_flash_grads(dev: torch.device, counters: dict) -> None:
    """One train step's gradients through the fused attention against the
    einsum route: the flagship CMDM at full width (dropout 0, from one seeded
    init) on one batch (4 items, 1024-point clouds, padded motions), the
    same t and noise, once with AM_FLASH_ATTN=1 and once with 0, in bf16 (the
    train config's) and in float32. Every layer's in_proj_weight.grad must be
    non-zero on the fused route and within FLASH_GRAD_LIMIT (relative, in
    the L2 norm) of the einsum route's; the fused route must launch the
    forward and the backward once per layer."""
    from afford_motion_torch.diffusion import create_gaussian_diffusion
    from afford_motion_torch.models.cmdm import CMDM
    from afford_motion_torch.models.conditioning import add_hierarchies
    from afford_motion_torch.utils.config import DictConfig

    rng = np.random.default_rng(SEED + 7)
    n, lb = 1024, 4
    x_mask = np.arange(L)[None, :] >= np.array([[L], [150], [90], [40]])
    cond = {
        "c_pc_xyz": torch.from_numpy(rng.normal(size=(lb, n, 3)).astype(np.float32)).to(dev),
        "c_pc_contact": torch.from_numpy(rng.uniform(size=(lb, n, 6)).astype(np.float32)).to(dev),
        "text_emb": torch.from_numpy(rng.normal(size=(lb, 1, 512)).astype(np.float32)).to(dev),
        "x_mask": torch.from_numpy(x_mask).to(dev),
    }
    x = torch.from_numpy(rng.normal(size=(lb, L, D)).astype(np.float32)).to(dev)
    t = torch.from_numpy(rng.integers(0, 1000, size=lb)).to(dev)
    noise = torch.from_numpy(rng.standard_normal((lb, L, D)).astype(np.float32)).to(dev)
    diffusion = create_gaussian_diffusion(DictConfig({"steps": 1000}), dev)
    for dtype in (torch.bfloat16, torch.float32):
        torch.manual_seed(SEED)
        model = CMDM(motion_dim=D, dtype=dtype, dropout=0.0).to(dev)
        initial = {k: v.clone() for k, v in model.state_dict().items()}
        runs = {}
        for flash in ("1", "0"):
            with flash_switch(flash):
                model.load_state_dict(initial, strict=True)
                model.train()
                model.zero_grad(set_to_none=True)
                reset(counters)
                cond_h = add_hierarchies(model, cond)
                loss = diffusion.training_losses(lambda x_t, ts: model(x_t, ts, cond_h), x, t,
                                                 x_mask=cond_h["x_mask"], noise=noise)["loss"]
                loss.mean().backward()
                torch.cuda.synchronize()
                rows = ("attention", "attention_bwd_dkv", "attention_bwd_dq", "attention_bwd_f32")
                counts = {k: counters[k].launches for k in rows}
                step = FLASH_STEP if dtype == torch.bfloat16 else FLASH_F32_STEP
                want = {k: step[k] * (flash == "1") for k in rows}
                if counts != want:
                    raise AssertionError(f"flash grads AM_FLASH_ATTN={flash}: launches {counts}, "
                                         f"expected {want}")
                runs[flash] = (float(loss.mean().detach()), [
                    layer.self_attn.in_proj_weight.grad.clone()
                    for layer in model.self_attn_layer.layers], torch.cat(
                        [p.grad.reshape(-1) for p in model.parameters() if p.grad is not None]))
        (loss_f, fused, all_f), (loss_e, einsum, all_e) = runs["1"], runs["0"]
        rel = [float((f - e).norm() / e.norm()) for f, e in zip(fused, einsum)]
        whole = float((all_f - all_e).norm() / all_e.norm())
        limit = FLASH_GRAD_LIMIT[dtype]
        log(f"flash grads {str(dtype)[6:]}: loss {loss_f:.6f} fused, {loss_e:.6f} einsum; "
            f"in_proj_weight.grad per layer, |fused - einsum| / |einsum|: "
            f"{', '.join(f'{r:.3e}' for r in rel)} (limit {limit:.0e}); norms "
            f"{', '.join(f'{float(f.norm()):.3e}' for f in fused)}; every gradient: "
            f"{whole:.3e}")
        if not (all(float(f.norm()) > 0 for f in fused) and max(rel) <= limit
                and whole <= limit):
            raise AssertionError(f"flash grads {dtype}: the fused route's gradients differ "
                                 f"from the einsum route's")
        del model


def phase_autograd(dev: torch.device) -> None:
    """backward through the kernels on the card == the CPU's plain path."""
    from afford_motion_torch.ops.cuda.gather import gather_rows

    rng = np.random.default_rng(SEED + 2)
    x = rng.normal(size=(4, 2048, 67)).astype(np.float32)
    idx = rng.integers(0, 2048, size=(4, 512, 16)).astype(np.int32)
    g = rng.normal(size=(4, 512, 16, 67)).astype(np.float32)
    grads = []
    for device in (torch.device("cpu"), dev):
        xt = torch.from_numpy(x).to(device).requires_grad_(True)
        out = gather_rows(xt, torch.from_numpy(idx).to(device))
        out.backward(torch.from_numpy(g).to(device))
        grads.append((out.detach().cpu(), xt.grad.cpu()))
    for a, b, what in zip(grads[0], grads[1], ("forward", "backward")):
        if not torch.equal(bits(a), bits(b)):
            raise AssertionError(f"autograd {what}: card differs from the CPU's plain path")
    log("autograd: gather_rows forward and backward on the card bit-equal to the CPU's plain path")

    from afford_motion_torch.ops.cuda import banded

    # indices near the diagonal, so most lie in their tile's window of 768
    # rows and some do not; per-cloud starts
    centre = (np.arange(512) * 4)[None, :, None]
    idx = np.clip(centre + rng.integers(-500, 500, size=(4, 512, 16)), 0, 2047).astype(np.int32)
    starts = np.sort(rng.integers(0, 11, size=(4, 4)) * 128, axis=1).astype(np.int32)
    grads = []
    for device in (torch.device("cpu"), dev):
        xt = torch.from_numpy(x).to(device).requires_grad_(True)
        out = banded.gather_banded(xt, torch.from_numpy(idx).to(device),
                                   torch.from_numpy(starts).to(device), 128)
        out.backward(torch.from_numpy(g).to(device))
        grads.append((out.detach().cpu(), xt.grad.cpu()))
    zero_rows = float((grads[0][0] == 0).all(dim=-1).float().mean())
    if not 0.0 < zero_rows < 0.9:
        raise AssertionError(f"autograd: {zero_rows:.2f} of the banded rows are out of window")
    for a, b, what in zip(grads[0], grads[1], ("forward", "backward")):
        if not torch.equal(bits(a), bits(b)):
            raise AssertionError(f"autograd banded {what}: card differs from the CPU's plain path")
    log(f"autograd: gather_banded forward and backward on the card bit-equal to the CPU's plain "
        f"path ({100 * zero_rows:.1f}% of the rows out of window)")


def phase_reference(dev: torch.device) -> float:
    """Full-width float32 CMDM, small cloud: card (kernels) vs CPU (plain)."""
    from afford_motion_torch.diffusion import create_gaussian_diffusion
    from afford_motion_torch.models.cmdm import CMDM
    from afford_motion_torch.train.sampling import make_sample_fn
    from afford_motion_torch.train.loop import make_train_step
    from afford_motion_torch.train.state import TrainState
    from afford_motion_torch.utils.config import DictConfig

    torch.manual_seed(SEED)
    cpu_model = CMDM(motion_dim=D).eval()
    gpu_model = CMDM(motion_dim=D).to(dev).eval()
    gpu_model.load_state_dict(cpu_model.state_dict(), strict=True)
    rng = np.random.default_rng(SEED + 1)
    n, lb = 1024, 2
    x_mask = np.zeros((lb, L), dtype=bool)
    x_mask[1, 120:] = True
    cond = {
        "c_pc_xyz": rng.normal(size=(lb, n, 3)).astype(np.float32),
        "c_pc_contact": rng.uniform(size=(lb, n, 6)).astype(np.float32),
        "text_emb": rng.normal(size=(lb, 1, 512)).astype(np.float32),
        "x_mask": x_mask,
    }
    noise = rng.standard_normal((lb, L, D)).astype(np.float32)
    out = []
    for model, device in ((cpu_model, torch.device("cpu")), (gpu_model, dev)):
        diffusion = create_gaussian_diffusion(
            DictConfig({"steps": 1000, "timestep_respacing": "ddim10"}), device)
        fn = make_sample_fn(model, diffusion, sampler="ddim")
        c = {k: torch.from_numpy(v).to(device) for k, v in cond.items()}
        out.append(fn((lb, L, D), c, noise=torch.from_numpy(noise).to(device)).cpu())
    err = (out[0] - out[1]).abs().max().item()
    log(f"reference: DDIM-10 x0 (2,{L},{D}) f32, card vs CPU max abs diff {err:.3e}")
    if not (torch.isfinite(out[1]).all() and err <= 1e-3):
        raise AssertionError(f"card chain disagrees with the CPU chain: {err}")

    # two float32 train steps (dropout 0) from the same weights, batch, t and
    # noise. Limits: each loss within 1e-3 (rel). Adam moves an entry by at
    # most lr a step whatever its gradient's size, and by +-lr with a sign
    # that is rounding noise where the true gradient is 0 (biases in front of
    # a train-mode BatchNorm or a softmax), so the weights are held to
    # 2 steps x 2 lr at most, and to 2e-6 for all but 2% of the entries.
    # Once on the plain route, once banded on a curve-sorted cloud (FPS, sort
    # and the windowed kNN in the step), each from the initial weights.
    from afford_motion_torch.ops.curves import curve_order

    lr = 1e-4
    x = rng.standard_normal((lb, L, D)).astype(np.float32)
    ts = rng.integers(0, 1000, size=(2, lb))
    noises = rng.standard_normal((2, lb, L, D)).astype(np.float32)
    initial = {k: v.clone() for k, v in cpu_model.state_dict().items()}
    sorted_cond = dict(cond, c_pc_xyz=np.stack(
        [c[curve_order(c, "hilbert")] for c in cond["c_pc_xyz"]]))
    for route, step_cond in (("plain", cond), ("banded", sorted_cond)):
        losses, weights = [], []
        for model, device in ((cpu_model, torch.device("cpu")), (gpu_model, dev)):
            model.load_state_dict(initial, strict=True)
            model.use_banded = route == "banded"
            diffusion = create_gaussian_diffusion(DictConfig({"steps": 1000}), device)
            state = TrainState.create(model, lr=lr)
            step = make_train_step(model, diffusion)
            c = {k: torch.from_numpy(v).to(device) for k, v in step_cond.items()}
            losses.append([float(step(state, torch.from_numpy(x).to(device), c, seed=i,
                                      t=torch.from_numpy(ts[i]).to(device),
                                      noise=torch.from_numpy(noises[i]).to(device))["loss"])
                           for i in range(2)])
            weights.append(torch.cat([p.detach().cpu().reshape(-1) for p in model.parameters()]))
            model.eval()
            model.use_banded = False
        diff = (weights[0] - weights[1]).abs()
        far = float((diff > 2e-6).float().mean())
        log(f"reference: 2 f32 {route} train steps, card vs CPU: losses {losses[1]} vs {losses[0]}, "
            f"weights max abs diff {diff.max().item():.3e}, {100 * far:.3f}% of entries beyond 2e-6")
        rel = max(abs(a - b) / abs(a) for a, b in zip(losses[0], losses[1]))
        if not (np.isfinite(losses[1]).all() and rel <= 1e-3 and diff.max().item() <= 4.004 * lr
                and far <= 0.02):
            raise AssertionError(f"card {route} train steps disagree with the CPU's")
    return err


# one float32 trans_dec denoiser step, card against CPU: the largest
# difference as a share of the largest |output|; set before the first
# reading at ten times the f32 attention kernel's own tolerance (1e-5 of
# max |v|), which the fused route adds to the einsum route's sums in another
# order
DEC_STEP_LIMIT = 1e-4


def phase_reference_trans_dec(dev: torch.device) -> None:
    """One full-width float32 CMDM ``trans_dec`` denoiser step, the U-Net's
    encoding and ``denoise``, on the card and on the CPU on the same inputs:
    2 items of 8192 points, item 1's memories all masked (``c_pc_mask``),
    padded frames. The hierarchy is built on the card through the kernels
    (3 FPS, 8 kNN) and handed to the CPU as arrays. The card runs the step
    on the einsum route and on the fused one (``AM_FLASH_ATTN=1``: 13 f32
    forward launches), each within DEC_STEP_LIMIT of the CPU's."""
    from afford_motion_torch.models.cmdm import CMDM
    from afford_motion_torch.models.conditioning import add_hierarchies
    from afford_motion_torch.ops.cuda.attention import attention_cuda
    from afford_motion_torch.ops.hierarchy import geometry_to_arrays

    torch.manual_seed(SEED)
    cpu_model = CMDM(motion_dim=D, arch="trans_dec").eval()
    gpu_model = CMDM(motion_dim=D, arch="trans_dec").to(dev).eval()
    gpu_model.load_state_dict(cpu_model.state_dict(), strict=True)
    rng = np.random.default_rng(SEED + 12)
    lb = 2
    x_mask = np.zeros((lb, L), dtype=bool)
    x_mask[0, 150:] = True
    cond = {
        "c_pc_xyz": rng.normal(size=(lb, N_POINTS, 3)).astype(np.float32),
        "c_pc_contact": rng.uniform(size=(lb, N_POINTS, 6)).astype(np.float32),
        "text_emb": rng.normal(size=(lb, 1, 512)).astype(np.float32),
        "x_mask": x_mask, "c_pc_mask": np.array([[False], [True]]),
    }
    x = torch.from_numpy(rng.standard_normal((lb, L, D)).astype(np.float32))
    t = torch.tensor([3, 871])
    with torch.no_grad():
        t0 = time.monotonic()
        gcond = add_hierarchies(gpu_model, {k: torch.from_numpy(v).to(dev)
                                            for k, v in cond.items()})
        arrays = {k: v.cpu() for k, v in geometry_to_arrays(gcond["levels_sm"],
                                                            prefix="geo_sm").items()}
        ccond = add_hierarchies(cpu_model, {**{k: torch.from_numpy(v) for k, v in cond.items()},
                                            **arrays})
        want = cpu_model.denoise(x, t, ccond, cpu_model.encode_contact(ccond))
        cpu_s = time.monotonic() - t0
        scale = float(want.abs().max())
        for flash in ("0", "1"):
            with flash_switch(flash):
                before = attention_cuda.launches
                got = gpu_model.denoise(x.to(dev), t.to(dev), gcond,
                                        gpu_model.encode_contact(gcond)).cpu()
                calls = attention_cuda.launches - before
            err = float((got - want).abs().max()) / scale
            route = "fused" if flash == "1" else "einsum"
            log(f"reference trans_dec: one f32 denoiser step ({lb},{L},{D}), {N_POINTS} points, "
                f"card {route} route vs CPU: {err:.3e} of the largest |output| {scale:.3f} "
                f"(limit {DEC_STEP_LIMIT:.0e}); {calls} fused attention launches; the CPU's "
                f"step with the card's hierarchy {cpu_s:.1f} s")
            if not (bool(torch.isfinite(got).all()) and err <= DEC_STEP_LIMIT
                    and calls == DEC_ATTENTION * (flash == "1")):
                raise AssertionError(f"trans_dec denoiser step on the card ({route}) disagrees "
                                     "with the CPU's")
    del cpu_model, gpu_model


# the card's float32 CDM forward with its scene model against the CPU's, as
# a share of the CPU output's largest entry
CDM_SCENE_LIMIT = 1e-4


def phase_reference_cdm_scene(dev: torch.device) -> None:
    """One float32 forward of a CDM with its scene model and the V2 backbone
    at a small width (scene planes 32/32/64/64/128, blocks 1/2/1/1/1;
    PointTrans planes 32/64/64/128, blocks 1/2/1/1), 2 x 8192 points: the
    hierarchies (``add_hierarchies``: FPS and kNN on the card through the
    kernels) bit-equal to the CPU's plain versions, the scene features and
    the denoiser's output within CDM_SCENE_LIMIT of the CPU's."""
    from afford_motion_torch.models.cdm import CDM
    from afford_motion_torch.models.conditioning import add_hierarchies

    torch.manual_seed(SEED + 17)
    model = CDM(6, 128, 512, 32, True, arch="PointTransV2",
                arch_cfg={"blocks": (1, 2, 1, 1), "planes": (32, 64, 64, 128)},
                scene_planes=(32, 32, 64, 64, 128), scene_blocks=(1, 2, 1, 1, 1)).eval()
    rng = np.random.default_rng(SEED + 17)
    nb = 2
    cond = {"c_pc_xyz": rng.normal(size=(nb, N_POINTS, 3)).astype(np.float32),
            "c_pc_feat": rng.uniform(size=(nb, N_POINTS, 3)).astype(np.float32),
            "text_emb": rng.normal(size=(nb, 1, 512)).astype(np.float32)}
    x = rng.normal(size=(nb, N_POINTS, 6)).astype(np.float32)
    t = np.array([3, 450])
    outs = []
    for device in (torch.device("cpu"), dev):
        model.to(device)
        c = add_hierarchies(model, {k: torch.from_numpy(v).to(device) for k, v in cond.items()})
        with torch.no_grad():
            feat = model.encode_scene(c)
            out = model.denoise(torch.from_numpy(x).to(device), torch.from_numpy(t).to(device),
                                c, feat)
        outs.append((c, feat.cpu(), out.cpu()))
    for key in ("levels_seg", "levels_pt"):
        for li, (a, b) in enumerate(zip(outs[0][0][key], outs[1][0][key])):
            for f in ("knn_idx", "fps_idx", "down_knn_idx", "up_idx"):
                fa, fb = getattr(a, f), getattr(b, f)
                if (fa is None) != (fb is None) or (fa is not None and not torch.equal(
                        fa, fb.cpu())):
                    raise AssertionError(f"reference CDM: {key}[{li}].{f} differs card vs CPU")
    errs = []
    for i, what in ((1, "scene features"), (2, "denoiser output")):
        a, b = outs[0][i], outs[1][i]
        errs.append((b - a).abs().max().item() / a.abs().max().item())
        if not (torch.isfinite(b).all() and errs[-1] <= CDM_SCENE_LIMIT):
            raise AssertionError(f"reference CDM: {what} card vs CPU {errs[-1]:.3e} of the "
                                 f"largest entry (limit {CDM_SCENE_LIMIT:.0e})")
    log(f"reference: CDM-V2 with its scene model, f32, 2 x {N_POINTS} points: hierarchies "
        f"bit-equal card vs CPU; scene features {errs[0]:.3e} and output {errs[1]:.3e} of the "
        f"largest entry from the CPU's (limit {CDM_SCENE_LIMIT:.0e})")


def phase_reference_scene(dev: torch.device) -> None:
    """The evaluator's physics and a short SMPL-X fit, float32: the card
    (through the kernels) against the CPU (through the plain versions).
    Limits: per-frame non_collision within 2 points of the cloud (a sign dot
    product at rounding level may fall either way) and contact equal; fitted
    params within 1e-4 on all but 1% of the entries and within 2 lr a step
    everywhere (Adam moves an entry by lr whatever its gradient's size, with a
    sign that is noise where the gradient is)."""
    from afford_motion_torch.eval.joints_to_smplx import JointsToSMPLXRegressor, make_refine_fn
    from afford_motion_torch.eval.physics import physics_over_sequence
    from afford_motion_torch.eval.smplx_lbs import SMPLXModel, params_to_verts_joints

    rng = np.random.default_rng(SEED + 5)
    cpu = torch.device("cpu")
    body = SMPLXModel.synthetic(num_verts=2000, num_faces=4000)
    n_pts, frames, lr, steps = 1024, 24, 0.02, 10
    params = (rng.normal(size=(frames, 69)) * 0.3).astype(np.float32)
    points = (rng.normal(size=(n_pts, 3)) * 0.4).astype(np.float32)
    out = []
    for device in (cpu, dev):
        model = body.to(device)
        verts, _ = params_to_verts_joints(model, torch.from_numpy(params).to(device))
        nc, ct = physics_over_sequence(torch.from_numpy(points).to(device), verts,
                                       model.faces_arr, kernel="pallas")
        out.append((verts.cpu(), nc.cpu(), ct.cpu()))
    verts_err = (out[0][0] - out[1][0]).abs().max().item()
    nc_err = (out[0][1] - out[1][1]).abs().max().item()
    log(f"reference: LBS ({frames},2000,3) card vs CPU max abs diff {verts_err:.3e}; "
        f"physics_over_sequence non_collision max diff {nc_err:.3e} (mean "
        f"{out[1][1].mean().item():.4f}), contact equal={torch.equal(out[0][2], out[1][2])}")
    if not (verts_err <= 1e-5 and nc_err <= 2.0 / n_pts + 1e-7
            and torch.equal(out[0][2], out[1][2])):
        raise AssertionError("card physics disagrees with the CPU's")

    torch.manual_seed(SEED)
    regressor = JointsToSMPLXRegressor().eval()
    joints = (rng.normal(size=(2, 32, 66)) * 0.5).astype(np.float32)
    x_mask = np.zeros((2, 32), dtype=bool)
    x_mask[1, 20:] = True
    fitted = []
    for device in (cpu, dev):
        reg = JointsToSMPLXRegressor().to(device).eval()
        reg.load_state_dict(regressor.state_dict())
        j, m = torch.from_numpy(joints).to(device), torch.from_numpy(x_mask).to(device)
        with torch.no_grad():
            pred = reg(j, m)
        fitted.append((pred.cpu(), make_refine_fn(body.to(device), lr, steps)(pred, j, m).cpu()))
    pred_err = (fitted[0][0] - fitted[1][0])[~torch.from_numpy(x_mask)].abs().max().item()
    diff = (fitted[0][1] - fitted[1][1]).abs()
    far = float((diff > 1e-4).float().mean())
    log(f"reference: regressor card vs CPU max abs diff {pred_err:.3e}; {steps} refine steps: "
        f"max abs diff {diff.max().item():.3e}, {100 * far:.3f}% of entries beyond 1e-4")
    if not (pred_err <= 1e-4 and diff.max().item() <= 2 * lr * steps and far <= 0.01
            and bool(torch.isfinite(fitted[1][1]).all())):
        raise AssertionError("card fit disagrees with the CPU's")


def make_tree() -> dict:
    """Synthetic HumanML3D tree (8192-point clouds, motions of 40..196
    frames) whose train split holds 144 items (one megabatch of four steps is
    128) and whose test split 48, plus the stage-1 handoff
    ``H3D/pred_contact/{id}-0.npy`` each test item reads, from the seed."""
    from afford_motion_torch.data.synthetic import make_synthetic_h3d

    shutil.rmtree(WORK, ignore_errors=True)
    data, contacts, exp = WORK / "data", WORK / "contacts", WORK / "exp"
    make_synthetic_h3d(str(data), n_items=6 * B, num_points=N_POINTS, horizon_range=(40, 197))
    pred = contacts / "H3D" / "pred_contact"
    pred.mkdir(parents=True)
    rng = np.random.default_rng(SEED)
    for name in (data / "H3D" / "test.txt").read_text().split():
        dist = np.abs(rng.normal(size=(1, N_POINTS, 6))).astype(np.float32)
        np.save(pred / f"{name}-0.npy", dist)
    return {"data": data, "contacts": contacts, "exp": exp}


def make_banded_tree(tree: dict) -> dict:
    """A second tree beside the plain one: a copy of it taken through the
    port's ``prepare`` stages ``sort`` (Hilbert order), ``geometry`` (on the
    card, through the kernels) and ``pack``. The test items keep their names,
    so the plain tree's stage-1 handoff serves both."""
    from afford_motion_torch import prepare

    data = WORK / "data_banded"
    shutil.copytree(tree["data"], data)
    for stage in ("sort", "geometry", "pack"):
        t0 = time.monotonic()
        prepare.main([stage, "--dataset", "H3D", "--out_dir", str(data), "--batch_size", str(B)])
        log(f"prepare {stage}: {time.monotonic() - t0:.1f} s")
    meta = json.loads((data / "H3D" / "packed" / "meta.json").read_text())
    if not (meta["morton"] and meta["curve"] == "hilbert"
            and "geo_sm1_fps_idx" in meta["fields"] and len(meta["bases"]) == 6 * B):
        raise AssertionError(f"the packed store is not sorted, cached and whole: "
                             f"{ {k: v for k, v in meta.items() if k != 'bases'} }")
    return dict(tree, data=data, exp=WORK / "exp_banded")


def common_args() -> list:
    """What every entry run here shares: no embedding table and no
    text-encoder weights (the port's hash embeddings, from the caption), and
    the jsonl board."""
    return [f"text_encoder.table_path={WORK / 'no_table'}",
            f"text_encoder.weights_dir={WORK / 'no_weights'}", "platform=jsonl"]


def base_args(tree: dict) -> list:
    """The flagship configuration of ``scripts/t2m_contact_motion/train_ddp.sh``
    on the synthetic tree; both entries read it."""
    return [
        "task=text_to_motion_contact_motion_gen", "model=cmdm", "model.arch=trans_enc",
        "model.data_repr=h3d", "model.text_model.max_length=20", "diffusion.steps=1000",
        "task.dataset.sigma=0.8", f"task.dataset.data_dir={tree['data']}",
        f"task.test.contact_folder={tree['contacts']}", f"exp_dir={tree['exp']}",
        f"task.test.batch_size={B}", "task.evaluator.eval_nbatch=1", f"seed={SEED}",
        *common_args(),
    ]


def stage1_args(tree: dict, exp: Path) -> list:
    """``scripts/t2m_contact/train_ddp.sh`` on the synthetic HumanML3D tree
    (batch 64, sigma 0.8, captions of at most 20 tokens)."""
    return ["task=text_to_motion_contact_gen", *STAGE1_MODEL, "task.dataset.sigma=0.8",
            f"task.train.batch_size={B_STAGE1}", "model.text_model.max_length=20",
            f"task.dataset.data_dir={tree['data']}", f"exp_dir={exp}", f"seed={SEED}",
            *common_args()]


@contextlib.contextmanager
def environ(env: dict):
    """The variables of ``env`` set inside the block, restored after."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def flash_switch(value: str):
    """``AM_FLASH_ATTN`` set to ``value`` inside the block, restored after."""
    return environ({"AM_FLASH_ATTN": value})


def reset(counters: dict) -> None:
    for fn in counters.values():
        fn.launches = 0


def check_launches(name: str, counts: dict, per_pass: dict, passes: int, backward: bool) -> None:
    """The launches of one driven path must be exactly ``passes`` times the
    route's count per pass (the scatters only where there is a backward)."""
    want = {k: v * passes * (backward or "scatter" not in k) for k, v in per_pass.items()}
    if counts != want:
        raise AssertionError(f"{name}: launches {counts}, expected {want}")


@contextlib.contextmanager
def count_uploads(counters: dict, seen: list):
    """Inside the block, each ``DeviceStore.add_geometry_cache`` call appends
    the launches it made to ``seen``: the store's upload, apart from the
    steps."""
    from afford_motion_torch.train.device_store import DeviceStore

    real = DeviceStore.add_geometry_cache

    def counted(self, *args, **kwargs):
        before = {k: fn.launches for k, fn in counters.items()}
        out = real(self, *args, **kwargs)
        seen.append({k: fn.launches - before[k] for k, fn in counters.items()})
        return out

    DeviceStore.add_geometry_cache = counted
    try:
        yield
    finally:
        DeviceStore.add_geometry_cache = real


def phase_train(tree: dict, counters: dict, per_step: dict, extra: tuple = (),
                tag: str = "", args: list | None = None, store: bool | None = None,
                upload_knn: int = BANDED_STEP["banded_knn"], steps: int = 8,
                geometry_cache: bool | None = None) -> dict:
    """``steps`` (8) full-width steps through the train entry (the config's
    bf16 unless ``extra`` sets model.dtype), then the second half again
    resumed from the midpoint; returns the launches of both runs. ``per_step``: the launches one step must make on
    this tree's route (``STORE_STEP``: the device store, whose upload must
    launch ``store_upload`` of the tree's scenes); ``extra``: arguments
    beyond the flagship's. ``args``: another model's configuration instead
    of the flagship CMDM's (stage 1's, ``stage1_args``), and ``store``
    whether its route is the device store, whose upload caches the hierarchy
    (``geometry_cache``, default: for a CMDM) with ``upload_knn`` banded kNN
    a chunk, or launches nothing. Nothing in the arguments
    names the banded route or the store: the loop picks them from the
    tree."""
    from afford_motion_torch import train as entry

    cmdm = args is None
    geometry_cache = cmdm if geometry_cache is None else geometry_cache
    half = steps // 2
    store = per_step is STORE_STEP if store is None else store
    banded = store or per_step is BANDED_STEP
    if cmdm:
        args = base_args(tree) + [
            f"task.train.batch_size={B}",
            "task.dataset.train_transforms=['RandomEraseLang','RandomEraseContact',"
            "'NumpyToTensor']"]
    train_args = args + list(extra) + [
        f"task.train.save_every_step={half}", "task.train.log_every_step=1",
        f"task.train.max_steps={steps}"]
    launches = {k: 0 for k in counters}
    runs = {"train": (train_args, steps),
            "resumed": ([a for a in train_args if not a.startswith("exp_dir=")] + [
                f"exp_dir={tree['exp']}_resumed",
                f"task.train.resume_ckpt={tree['exp'] / 'ckpt' / f'model{half:06d}.pt'}"],
                steps - half)}
    for name, (args, n) in runs.items():
        name = tag + name
        reset(counters)
        uploads: list = []
        t0 = time.monotonic()
        with count_uploads(counters, uploads):
            summary = entry.main(args)
        wall = time.monotonic() - t0
        counts = {k: fn.launches for k, fn in counters.items()}
        logged = summary["logged"]
        losses = [e["loss"] for e in logged]
        log(f"{name}: steps {[e['step'] for e in logged]} losses {[round(v, 4) for v in losses]} "
            f"launches {counts}")
        if len(logged) != n or summary["step"] != steps or not np.isfinite(losses).all():
            raise AssertionError(f"{name}: expected {n} finite losses up to step {steps}")
        exp_dir = Path(summary["last_ckpt"]).parents[1]
        run_log = (exp_dir / "log" / "runtime.log").read_text()
        switched = "banded windowed-neighborhood kernels enabled" in run_log
        if switched != banded:
            raise AssertionError(f"{name}: the loop's log says banded={switched}")
        said = ("device store: staging" in run_log,
                "device store: caching hierarchy geometry" in run_log, "store" in summary)
        if said != (store, store and geometry_cache, store):
            raise AssertionError(f"{name}: the loop's device store (staged, geometry cached, "
                                 f"uploaded) = {said}, expected {store}")
        if store:
            packed = tree.get("packed", tree["data"] / "H3D" / "packed")
            n_scenes = len(json.loads((packed / "meta.json").read_text())["bases"])
            want = (store_upload(n_scenes, upload_knn) if geometry_cache
                    else {k: 0 for k in PLAIN_STEP})
            if uploads != [want]:
                raise AssertionError(f"{name}: upload launches {uploads}, expected [{want}]")
            counts = {k: v - uploads[0][k] for k, v in counts.items()}
            st = summary["store"]
            staged = next(line for line in run_log.splitlines() if "device store: staging" in line)
            log(f"{name}: {staged.split(' | ')[-1]}")
            log(f"{name}: device store {st['bytes'] / 1e6:.1f} MB for {n_scenes} scenes, "
                f"geometry cache and upload {st['seconds']:.3f} s, upload launches {uploads[0]}")
        elif uploads:
            raise AssertionError(f"{name}: a geometry cache was built off the store route")
        check_launches(name, counts, per_step, n, backward=True)
        last = f"model{steps:06d}.pt"
        if not summary["last_ckpt"].endswith(last) or not os.path.exists(summary["last_ckpt"]):
            raise AssertionError(f"{name}: {last} was not written")
        rest = [e["seconds"] / e["steps"] for e in logged[1:]]
        log(f"{name}: first step {logged[0]['seconds']:.3f} s (one-off set-up of the process "
            f"and the libraries included), then {np.mean(rest):.4f} s/step "
            f"(min {min(rest):.4f}, max {max(rest):.4f}; the host's data work runs on the "
            f"producer thread beside the steps), "
            f"peak memory {summary.get('peak_memory_bytes', float('nan')) / 2**30:.2f} GiB, "
            f"entry {wall:.1f} s")
        for k in launches:
            launches[k] += counts[k] + (uploads[0][k] if uploads else 0)
    straight = torch.load(tree["exp"] / "ckpt" / f"model{steps:06d}.pt", weights_only=True)
    resumed = torch.load(Path(f"{tree['exp']}_resumed") / "ckpt" / f"model{steps:06d}.pt",
                         weights_only=True)
    diff = max((straight[k].double() - resumed[k].double()).abs().max().item() for k in straight)
    log(f"{tag}resumed: largest difference from the straight run's weights and buffers at step "
        f"{steps}: {diff:.3e} (limit {RESUME_LIMIT:.0e})")
    if not diff <= RESUME_LIMIT:
        raise AssertionError(f"the {tag}resumed run differs from the straight one by {diff}")
    return launches


def phase_store_megabatch(tree: dict, dev: torch.device) -> None:
    """One megabatch (4 B items) assembled on the card from the device store
    of the sorted tree against the host wire of the same items with the same
    draws (the packed dataset's items under the global streams seeded as the
    store's generators): ``x``, ``x_mask``, ``c_pc_xyz``, the flags and the
    fps wire bit for bit, ``c_pc_contact`` within one f16 ulp, and the cached
    hierarchy equal to the one the step rebuilds from the host wire on the
    card."""
    import random

    from afford_motion_torch.data import create_dataset
    from afford_motion_torch.data.loader import collate_fn_general
    from afford_motion_torch.models.cmdm import CMDM
    from afford_motion_torch.models.conditioning import (
        add_hierarchies, cond_to_device, host_prepare_cond)
    from afford_motion_torch.train.device_store import DeviceStore, make_assemble_fn
    from afford_motion_torch.utils.config import load_config

    cfg = load_config("configs", base_args(tree) + [
        "task.dataset.train_transforms=['RandomEraseLang','RandomEraseContact','NumpyToTensor']"])
    random.seed(SEED)
    np.random.seed(SEED)
    ds = create_dataset(cfg.task.dataset, "train")
    store = DeviceStore.try_build(ds)
    if store is None:
        raise AssertionError("store megabatch: the device store refused the sorted tree")
    model = CMDM(motion_dim=D, latent_dim=32, time_emb_dim=32, planes=(8, 16, 32, 64),
                 num_layers=(1,), num_heads=4, dim_feedforward=32, use_banded=True).to(dev)
    t0 = time.monotonic()
    if not store.add_geometry_cache(model, dev):
        raise AssertionError("store megabatch: no geometry cache")
    assemble = make_assemble_fn(store, dev)
    log(f"store megabatch: {store.nbytes() / 1e6:.1f} MB on the card, cache and upload "
        f"{time.monotonic() - t0:.3f} s")

    class Text:  # captions are not compared: zero embeddings on both sides
        per_token = False

        def encode(self, texts):
            return np.zeros((len(texts), 16), np.float32)

    ids, seed = list(range(4 * B)), SEED + 5
    meta = store.draw_batch(ds, ids, random.Random(seed), np.random.RandomState(seed + 1))
    meta["text_emb"] = Text().encode(meta.pop("c_text"))[:, None, :].astype(np.float16)
    x, cond = assemble({k: torch.from_numpy(v).to(dev) for k, v in meta.items()})
    random.seed(seed)
    np.random.seed(seed + 1)
    hx, hcond = host_prepare_cond(collate_fn_general([ds[i] for i in ids]), Text())
    host = cond_to_device(hcond, dev)
    for k in ("x_mask", "c_pc_xyz", "c_text_erase", "c_pc_erase", *(
            k for k in hcond if k.endswith("_fps_idx"))):
        if not torch.equal(cond[k].cpu(), host[k].to(cond[k].dtype).cpu()):
            raise AssertionError(f"store megabatch: {k} differs from the host wire")
    if x.dtype != torch.float16 or not torch.equal(bits(x).cpu(), bits(torch.from_numpy(hx))):
        raise AssertionError("store megabatch: x differs from the host wire")
    got = cond["c_pc_contact"].cpu().numpy().astype(np.float32)
    want = host["c_pc_contact"].cpu().numpy().astype(np.float32)
    ulp = np.maximum(np.spacing(np.maximum(np.abs(got), np.abs(want)).astype(np.float16)
                                ).astype(np.float32), 2.0 ** -24)
    ulps = float((np.abs(got - want) / ulp).max())
    n_diff = int((got != want).sum())
    log(f"store megabatch: x, x_mask, c_pc_xyz, flags and fps wire bit-equal to the host wire; "
        f"c_pc_contact {n_diff} of {got.size} entries differ, at most {ulps:.1f} f16 ulp")
    if ulps > 1.0:
        raise AssertionError(f"store megabatch: c_pc_contact differs by {ulps} f16 ulp")
    cached = add_hierarchies(model, cond)["levels_sm"]
    rebuilt = add_hierarchies(model, host)["levels_sm"]
    for li, (a, b) in enumerate(zip(cached, rebuilt)):
        for f in ("xyz", "knn_idx", "fps_idx", "down_knn_idx", "down_starts"):
            u, v = getattr(a, f), getattr(b, f)
            if (u is None) != (v is None) or (u is not None and not torch.equal(u, v)):
                raise AssertionError(f"store megabatch: level {li} {f}: the cache differs from "
                                     "the in-step rebuild")
        if not (a.banded and b.banded):
            raise AssertionError(f"store megabatch: level {li} is not marked banded")
    log(f"store megabatch: the cached hierarchy of {len(ids)} items equals the in-step rebuild "
        f"({len(cached)} levels)")


def phase_slice(tree: dict, counters: dict, runs: dict) -> dict:
    """Sampling chains through the test entry, from the checkpoint the train
    phase wrote under the tree's ``exp`` (the natsort-latest,
    ``model000008.pt``). ``runs``: name -> (extra arguments, the launches one
    chain must make)."""
    from afford_motion_torch import test as entry

    base = base_args(tree)
    launches = {k: 0 for k in counters}
    for name, (extra, per_chain) in runs.items():
        reset(counters)
        out = Path(entry.main(base + extra))
        counts = {k: fn.launches for k, fn in counters.items()}
        z = np.load(out / "samples.npz")
        timing = json.loads((out / "timing.json").read_text())
        x0 = z["sample"]
        log(f"slice {name}: x0 {x0.shape} finite={bool(np.isfinite(x0).all())} "
            f"launches {counts}")
        if x0.shape != (B, L, D) or not np.isfinite(x0).all():
            raise AssertionError(f"{name}: bad x0 {x0.shape}")
        check_launches(f"slice {name}", counts, per_chain, 1, backward=False)
        chain = timing["chains"][0]
        log(f"slice {name}: chain {chain['chain_s']:.3f} s (hierarchy + contact encoding "
            f"{chain['prepare_s']:.3f} s, {chain['steps']} denoiser steps "
            f"{chain['loop_s']:.3f} s = {1e3 * chain['loop_s'] / chain['steps']:.3f} ms/step), "
            f"peak memory {timing.get('peak_memory_bytes', float('nan')) / 2**30:.2f} GiB")
        for k in launches:
            launches[k] += counts[k]
    return launches


def phase_t2m_chain(tree: dict, counters: dict, s1_exp: Path) -> dict:
    """Text -> contact -> motion through files. Stage 1:
    ``scripts/t2m_contact/test.sh`` (CDM-500, the config's sigma 0.5, the
    model overrides its checkpoint was trained with) from the stage-1 train
    phase's checkpoint, one batch of B, writes ``H3D/pred_contact``. Stage 2:
    a DDIM-50 chain of the CMDM from the plain train phase's checkpoint, with
    ``task.test.contact_folder`` at stage 1's directory, reads them: its
    dataset's ``c_pc_contact`` for every item the chain reads is the sigma
    kernel of stage 1's file. Returns the launches of both tests and stage
    2's test directory, whose ``humanml/*.pkl`` the HumanML3D protocol
    scores."""
    from afford_motion_torch import test as entry
    from afford_motion_torch.data import create_dataset, gaussian_contact
    from afford_motion_torch.utils.config import load_config

    launches = {k: 0 for k in counters}
    s1 = ["task=text_to_motion_contact_gen", *STAGE1_MODEL, "model.text_model.max_length=20",
          f"task.dataset.data_dir={tree['data']}", f"exp_dir={s1_exp}",
          f"task.test.batch_size={B}", "task.evaluator.eval_nbatch=1", f"seed={SEED}",
          *common_args()]
    reset(counters)
    t0 = time.monotonic()
    out1 = Path(entry.main(s1))
    wall = time.monotonic() - t0
    counts = {k: fn.launches for k, fn in counters.items()}
    check_launches("t2m stage 1", counts, STAGE1_STEP, 1, backward=False)
    timing = json.loads((out1 / "timing.json").read_text())
    chain = timing["chains"][0]
    files = {f.name: np.load(f) for f in (out1 / "H3D" / "pred_contact").glob("*.npy")}
    bad = [n for n, d in files.items() if d.shape != (1, N_POINTS, 6) or d.dtype != np.float32
           or not (np.isfinite(d).all() and (d >= 0).all())]
    log(f"t2m stage 1: CDM-500 chain of {B} {chain['chain_s']:.3f} s "
        f"({1e3 * chain['loop_s'] / chain['steps']:.3f} ms/step), entry {wall:.1f} s, peak "
        f"memory {timing.get('peak_memory_bytes', float('nan')) / 2**30:.2f} GiB; "
        f"{len(files)} pred_contact files, launches {counts}")
    if len(files) != B or bad:
        raise AssertionError(f"t2m stage 1: {len(files)} files, bad: {bad[:4]}")

    s2 = [a for a in base_args(tree) if not a.startswith("task.test.contact_folder=")] + [
        f"task.test.contact_folder={out1}", "diffusion.timestep_respacing=ddim50",
        "task.test.sampler=ddim"]
    cfg = load_config("configs", s2)
    sigma = float(cfg.task.dataset.sigma)
    ds = create_dataset(cfg.task.dataset, "test", contact_folder=str(out1))
    for i in range(B):   # the items the chain reads: the split's first B, in its order
        item = ds[i]
        name = f"{item['info_index']}-{item['info_caption_index']}.npy"
        want = gaussian_contact(files[name], sigma).astype(np.float32)
        if not np.array_equal(item["c_pc_contact"], want):
            raise AssertionError(f"t2m stage 2: c_pc_contact of {name} is not the sigma "
                                 "kernel of stage 1's file")
    log(f"t2m stage 2: c_pc_contact of all {B} items it reads equals exp(-d^2 / 2 "
        f"{sigma}^2) of stage 1's files")
    reset(counters)
    out2 = Path(entry.main(s2))
    counts2 = {k: fn.launches for k, fn in counters.items()}
    check_launches("t2m stage 2", counts2, PLAIN_STEP, 1, backward=False)
    z = np.load(out2 / "samples.npz")
    read = {f"{n}-0.npy" for n in z["info_index"]}
    if z["sample"].shape != (B, L, D) or not np.isfinite(z["sample"]).all() or not read <= set(
            files):
        raise AssertionError(f"t2m stage 2: x0 {z['sample'].shape}, or items without a file")
    c2 = json.loads((out2 / "timing.json").read_text())["chains"][0]
    log(f"t2m stage 2: DDIM-50 chain {c2['chain_s']:.3f} s "
        f"({1e3 * c2['loop_s'] / c2['steps']:.3f} ms/step) on stage 1's contacts, x0 "
        f"{z['sample'].shape} finite, launches {counts2}")
    for k in launches:
        launches[k] += counts[k] + counts2[k]
    return launches, out2


def make_scene_tree(dev: torch.device) -> dict:
    """What the scene slice reads, all from the seed: a synthetic HUMANISE
    tree (8192-point scenes, joint motions of 40..196 frames, 36 test items),
    a checkpoint of the full-width CDM-Perceiver (stage 1) and one of the
    full-width CMDM ``trans_enc`` for 66-d joint positions, and a
    joints-to-SMPL-X regressor file in the reference's torch layout."""
    from afford_motion_torch.data.synthetic import make_synthetic_motionx_set
    from afford_motion_torch.eval.joints_to_smplx import JointsToSMPLXRegressor
    from afford_motion_torch.models.base import create_model
    from afford_motion_torch.train.checkpoint import save_ckpt
    from afford_motion_torch.utils.config import load_config

    data, exp = WORK / "scene_data", WORK / "scene_exp"
    make_synthetic_motionx_set(str(data), "HUMANISE", n_items=40, num_points=N_POINTS,
                               horizon_range=(40, L + 1), seed=SEED, test_items=36)
    tree = {"data": data, "exp": exp, "cdm_exp": WORK / "scene_cdm_exp",
            "regressor": WORK / "regressor.pt"}
    cfg = load_config("configs", ts2m_args(tree))
    cfg.model.input_feats = 6
    torch.manual_seed(SEED + 1)
    save_ckpt(create_model(cfg.model, dev), str(tree["cdm_exp"] / "ckpt"), 0)
    cfg = load_config("configs", scene_args(dict(tree, contacts=WORK)))
    cfg.model.input_feats = D_POS
    torch.manual_seed(SEED)
    save_ckpt(create_model(cfg.model, dev), str(exp / "ckpt"), 0)
    torch.save(JointsToSMPLXRegressor().state_dict(), tree["regressor"])
    return tree


def ts2m_args(tree: dict) -> list:
    """``scripts/ts2m_contact/test.sh`` (CDM-500, ``ContactEvaluator``, the
    config's sigma 0.5) with the model overrides of its train script, on the
    synthetic HUMANISE tree: one batch of B, 2 contact maps each."""
    return ["task=contact_gen", *STAGE1_MODEL, "task.dataset.sets=[HUMANISE]",
            f"task.dataset.data_dir={tree['data']}", f"exp_dir={tree['cdm_exp']}",
            f"task.test.batch_size={B}", "task.evaluator.eval_nbatch=1",
            "task.evaluator.k_samples=2", f"task.evaluator.num_k_samples={B}", f"seed={SEED}",
            *common_args()]


def phase_ts2m_contact(tree: dict, counters: dict, args: list | None = None,
                       per_chain: dict = STAGE1_STEP, tag: str = "ts2m stage 1"):
    """Stage 1 of the scene protocol: the CDM-500 test (``args``, default
    :func:`ts2m_args`) writes ``HUMANISE/pred_contact/{i:05d}.npy``, two
    contact maps of distances for each of B test items, and
    ``dist_to_target_*``: the three threshold rates in [0, 1], the three
    average distances finite and at most the largest distance a contact map
    can encode, sqrt(-2 sigma^2 ln 1e-20). Each of its chains must launch
    ``per_chain``. Returns the directory that holds the files and the
    launches."""
    from afford_motion_torch import test as entry
    from afford_motion_torch.utils.config import load_config

    args = ts2m_args(tree) if args is None else args
    reset(counters)
    t0 = time.monotonic()
    out = Path(entry.main(args))
    wall = time.monotonic() - t0
    counts = {k: fn.launches for k, fn in counters.items()}
    timing = json.loads((out / "timing.json").read_text())
    check_launches(tag, counts, per_chain, len(timing["chains"]), backward=False)
    files = sorted((out / "HUMANISE" / "pred_contact").glob("*.npy"))
    maps = [np.load(f) for f in files]
    if len(files) != B or not all(m.shape == (2, N_POINTS, 6) and np.isfinite(m).all()
                                  and (m >= 0).all() for m in maps):
        raise AssertionError(f"{tag}: {len(files)} pred_contact files, or a bad one")
    metrics = {k: float(v) for k, v in (line.split(": ") for line in
                                        (out / "metrics.txt").read_text().splitlines())}
    sigma = float(load_config("configs", args).task.dataset.sigma)
    d_max = float(np.sqrt(-2.0 * sigma ** 2 * np.log(1e-20)))
    rates = [f"dist_to_target_{t}" for t in (0.1, 0.3, 0.5)]
    means = [f"dist_to_target_{k}average" for k in ("", "pelvis_", "min_")]
    if sorted(metrics) != sorted(rates + means) or not (
            all(0.0 <= metrics[k] <= 1.0 for k in rates)
            and all(0.0 <= metrics[k] <= d_max for k in means)):
        raise AssertionError(f"{tag}: metrics.txt holds {metrics}")
    for c in timing["chains"]:
        log(f"{tag}: chain of {B} {c['chain_s']:.3f} s (prepare {c['prepare_s']:.3f} s, "
            f"{1e3 * c['loop_s'] / c['steps']:.3f} ms/step over {c['steps']} steps)")
    log(f"{tag}: entry {wall:.1f} s, evaluator {timing['evaluator_s']:.3f} s, peak "
        f"memory {timing.get('peak_memory_bytes', float('nan')) / 2**30:.2f} GiB; {len(files)} "
        f"pred_contact files of 2 maps; {metrics}; launches {counts}")
    return out, counts


def make_cdm_tree() -> dict:
    """A synthetic HUMANISE tree for the CDM with its scene model: 8192-point
    scenes with colours, B_STAGE1 + B items (the train phase ``all`` reads
    them all, one batch of B_STAGE1 a step), the last B the test split."""
    from afford_motion_torch.data.synthetic import make_synthetic_motionx_set

    data = WORK / "cdm_data"
    make_synthetic_motionx_set(str(data), "HUMANISE", n_items=B_STAGE1 + B, num_points=N_POINTS,
                               horizon_range=(40, L + 1), seed=SEED + 3, test_items=B)
    return {"data": data}


def cdm_args(tree: dict, exp: Path, arch: str | None = None, test: bool = False) -> list:
    """``scripts/ts2m_contact/train_ddp.sh`` without its
    ``model.scene_model.use_scene_model=False``: the shipped CDM (``arch``
    MLP, the frozen PointTransformerSeg, 32-d point features, bf16, 500
    steps) at batch B_STAGE1 on the synthetic HUMANISE tree, or another
    ``arch``; with ``test``, ``scripts/ts2m_contact/test.sh``'s run of it,
    one batch of B, two contact maps each."""
    run = ([f"task.test.batch_size={B}", "task.evaluator.eval_nbatch=1",
            "task.evaluator.k_samples=2", f"task.evaluator.num_k_samples={B}"] if test
           else [f"task.train.batch_size={B_STAGE1}"])
    return ["task=contact_gen", "model=cdm", "diffusion.steps=500", "task.dataset.sets=[HUMANISE]",
            *([f"model.arch={arch}"] if arch else []), *run,
            f"task.dataset.data_dir={tree['data']}", f"exp_dir={exp}", f"seed={SEED}",
            *common_args()]


def check_scene_frozen(tag: str, args: list, exp: Path, steps: int) -> None:
    """The straight and the resumed run's last checkpoints hold the frozen
    scene model's weights and BatchNorm statistics bit for bit as the seeded
    init made them (the pretrained file is not in the checkout: the train
    entry warns and keeps the init)."""
    from afford_motion_torch.models.base import create_model
    from afford_motion_torch.utils.config import load_config
    from afford_motion_torch.utils.misc import compute_repr_dimension

    cfg = load_config("configs", args)
    cfg.model.input_feats = compute_repr_dimension(cfg.model.data_repr)
    torch.manual_seed(int(cfg.seed))
    init = {k: v for k, v in create_model(cfg.model, torch.device("cpu")).state_dict().items()
            if k.startswith("scene_model.")}
    for run in (exp, Path(f"{exp}_resumed")):
        sd = torch.load(run / "ckpt" / f"model{steps:06d}.pt", weights_only=True)
        changed = [k for k, v in init.items() if not torch.equal(sd[k].cpu(), v)]
        if not init or changed:
            raise AssertionError(f"{tag}: the frozen scene model changed in training: "
                                 f"{changed[:4]} of {len(init)} tensors")
        if "pretrained scene weights not found" not in (run / "log" / "runtime.log").read_text():
            raise AssertionError(f"{tag}: the train entry did not say the scene model keeps "
                                 "its init")
    log(f"{tag}: the scene model's {len(init)} tensors (weights and BatchNorm statistics) after "
        f"{steps} steps, straight and resumed, bit-equal to the seeded init")


def phase_cdm_scene(counters: dict, banded_tree: dict) -> list:
    """The CDM with its frozen scene model, the shipped stage-1 default,
    through the entries on a synthetic HUMANISE tree: 8 + 4 steps of the
    MLP at batch B_STAGE1 (``SCENE_PASS`` a step), 4 + 2 of the Perceiver and
    of the PointTrans and PointTransV2 backbones (``PT_SCENE_STEP``), each
    with the scene model unchanged; 4 + 2 of PointTrans without it through
    the stage-1 store of the sorted HumanML3D tree (the banded kernels and
    the upload's geometry cache: ``DEC_STORE_STEP``, ``DEC_BANDED_KNN`` a
    chunk); then the MLP's CDM-500 test (two chains of B through
    ``pred_contact`` files and ``dist_to_target_*``) and V2's DDIM-50 test
    with ``AM_FLASH_ATTN=1`` (the bottleneck attention fused, once a step).
    Returns the launches of every run."""
    tree = make_cdm_tree()
    runs = []
    exps = {}
    for arch, per_step, steps in (("MLP", SCENE_PASS, 8), ("Perceiver", SCENE_PASS, 4),
                                  ("PointTrans", PT_SCENE_STEP, 4),
                                  ("PointTransV2", PT_SCENE_STEP, 4)):
        t = dict(tree, exp=WORK / f"exp_cdm_{arch}")
        args = cdm_args(t, t["exp"], None if arch == "MLP" else arch)
        tag = f"cdm {arch} + scene "
        runs.append(phase_train(t, counters, per_step, tag=tag, args=args, store=False,
                                steps=steps))
        check_scene_frozen(tag.strip(), args, t["exp"], steps)
        exps[arch] = t["exp"]
    st = dict(banded_tree, exp=WORK / "exp_cdm_pt_store")
    runs.append(phase_train(st, counters, DEC_STORE_STEP, ("model.arch=PointTrans",),
                            tag="cdm PointTrans store ", args=stage1_args(st, st["exp"]),
                            store=True, upload_knn=DEC_BANDED_KNN, steps=4,
                            geometry_cache=True))
    _, counts = phase_ts2m_contact(tree, counters, cdm_args(tree, exps["MLP"], test=True),
                                   SCENE_PASS, tag="cdm MLP + scene CDM-500")
    runs.append(counts)
    ddim = ["diffusion.timestep_respacing=ddim50", "task.test.sampler=ddim"]
    with flash_switch("1"):
        _, counts = phase_ts2m_contact(
            tree, counters, cdm_args(tree, exps["PointTransV2"], "PointTransV2", test=True) + ddim,
            dict(PT_SCENE_STEP, gather=26 + 14 * 50, scatter=0, attention=50),
            tag="cdm PointTransV2 + scene DDIM-50 fused")
    runs.append(counts)
    return runs


# the MotionX training route (scripts/ts2m_contact_motion/train_ddp.sh and
# its stage 1, scripts/ts2m_contact/train_ddp.sh) on a prepared HUMANISE
# tree, and the two-stage demo chain of sample.py: MX_ITEMS scenes, every
# other one with a stage-1 pred_contact file for the training mix; the demo's
# prompt files hold MX_SAMPLE lines, one batch of task.sample.batch_size
MX_ITEMS, MX_SAMPLE, MX_STEPS = 96, 8, 4
MX_FRAMES = (40, 60, 80, 100, 120, 140, 160, 196)


@contextlib.contextmanager
def record_store_kinds(kinds: list):
    """Inside the block, each ``DeviceStore.try_build`` call appends the kind
    of the store it built (None where it built none) to ``kinds``."""
    from afford_motion_torch.train.device_store import DeviceStore

    raw = DeviceStore.__dict__["try_build"]
    real = DeviceStore.try_build

    def recorded(dataset):
        store = real(dataset)
        kinds.append(None if store is None else store.meta["kind"])
        return store

    DeviceStore.try_build = staticmethod(recorded)
    try:
        yield
    finally:
        DeviceStore.try_build = raw


def make_motionx_tree(counters: dict) -> tuple:
    """A synthetic HUMANISE tree (MX_ITEMS scenes of N_POINTS points, 66-d
    joint motions of 40..196 frames, ``pred_contact`` files for every other
    item) taken through ``afford_motion_torch.prepare sort|geometry|pack
    --dataset HUMANISE`` on the card: the store sorted, cached and whole, the
    ``target_mask`` sidecars in their clouds' new row order, one hierarchy's
    FPS and kNN launches (with the up kNN) a chunk of B scenes in the
    geometry stage. Returns the tree and the launches."""
    from afford_motion_torch import prepare
    from afford_motion_torch.data.synthetic import make_synthetic_motionx_set

    data = WORK / "mx_data"
    make_synthetic_motionx_set(str(data), "HUMANISE", n_items=MX_ITEMS, num_points=N_POINTS,
                               horizon_range=(40, L + 1), seed=SEED + 7, test_items=MX_SAMPLE)
    base = data / "HUMANISE" / "contact_motion"
    pred = data / "HUMANISE" / "pred_contact"
    pred.mkdir()
    rng = np.random.default_rng(SEED + 7)
    for i in range(0, MX_ITEMS, 2):
        np.save(pred / f"{i:05d}.npy", np.abs(rng.normal(size=(1, N_POINTS, 6))).astype(np.float32))
    before = {i: (np.load(base / "contacts" / f"{i:05d}.npz")["points"][:, :3],
                  np.load(base / "target_mask" / f"{i:05d}.npy")) for i in (0, MX_ITEMS - 1)}
    launches = {k: 0 for k in counters}
    for stage in ("sort", "geometry", "pack"):
        reset(counters)
        t0 = time.monotonic()
        prepare.main([stage, "--dataset", "HUMANISE", "--out_dir", str(data),
                      "--batch_size", str(B)])
        counts = {k: fn.launches for k, fn in counters.items()}
        log(f"motionx prepare {stage}: {time.monotonic() - t0:.1f} s, launches {counts}")
        # the geometry stage builds one hierarchy with its up kNN (3 FPS, 8
        # kNN) a chunk of B scenes; the others are numpy
        chunks = -(-MX_ITEMS // B) if stage == "geometry" else 0
        check_launches(f"motionx prepare {stage}", counts,
                       dict(STAGE1_STEP, fps=3, knn=DEC_PLAIN_STEP["knn"]), chunks,
                       backward=False)
        for k in launches:
            launches[k] += counts[k]
    check_sorted_sidecar(base, before, "motionx prepare")
    meta = json.loads((base / "packed" / "meta.json").read_text())
    if not (meta["morton"] and meta["curve"] == "hilbert" and len(meta["bases"]) == MX_ITEMS
            and {"motion32", "motion_len", "rgb16", "geo_sm1_fps_idx"} <= set(meta["fields"])):
        raise AssertionError(f"motionx prepare: the packed store is not sorted, cached and "
                             f"whole: { {k: v for k, v in meta.items() if k != 'bases'} }")
    log(f"motionx prepare: {MX_ITEMS} scenes sorted with their target_mask sidecars, cached, "
        f"packed ({sorted(meta['fields'])})")
    return {"data": data, "packed": base / "packed"}, launches


def mx_args(tree: dict, exp: Path) -> list:
    """``scripts/ts2m_contact_motion/train_ddp.sh`` on the synthetic HUMANISE
    tree: the CMDM ``trans_enc`` at full width, 500 diffusion steps, batch
    B, the config's rotation chain and mix ratio 0.5."""
    return ["task=contact_motion_gen", "model=cmdm", "model.arch=trans_enc",
            "diffusion.steps=500", "task.dataset.sets=[HUMANISE]", f"task.train.batch_size={B}",
            f"task.dataset.data_dir={tree['data']}", f"exp_dir={exp}", f"seed={SEED}",
            *common_args()]


def mx_stage1_args(tree: dict, exp: Path) -> list:
    """``scripts/ts2m_contact/train_ddp.sh``: the CDM-Perceiver at batch
    B_STAGE1 on the synthetic HUMANISE tree."""
    return ["task=contact_gen", *STAGE1_MODEL, "task.dataset.sets=[HUMANISE]",
            f"task.train.batch_size={B_STAGE1}", f"task.dataset.data_dir={tree['data']}",
            f"exp_dir={exp}", f"seed={SEED}", *common_args()]


def phase_motionx(dev: torch.device, counters: dict) -> list:
    """The MotionX training route and the sample chain. Prepare the tree
    (:func:`make_motionx_tree`); MX_STEPS steps and half of them resumed of
    ``ts2m_contact_motion`` through the ``motionx`` store (the banded route,
    ``STORE_STEP`` a step, the upload's banded kNN ``store_upload``); one
    assembled batch on the card against the CPU's
    (:func:`phase_motionx_batch`); the same run with
    ``task.train.device_store=off`` (the host route of the packed tree,
    ``BANDED_STEP``); stage 1 through the ``motionx_contact`` store
    (``STAGE1_STEP``); then ``sample.py``'s two stages
    (:func:`phase_sample`). Returns the launches of every run."""
    tree, prep = make_motionx_tree(counters)
    runs = [prep]
    s2 = dict(tree, exp=WORK / "exp_mx_store")
    s1 = dict(tree, exp=WORK / "exp_mx_stage1")
    for tag, t, args, per_step, store, kind in (
            ("motionx store ", s2, mx_args(s2, s2["exp"]), STORE_STEP, True, "motionx"),
            ("motionx host ", dict(tree, exp=WORK / "exp_mx_host"),
             mx_args(tree, WORK / "exp_mx_host") + ["task.train.device_store=off"],
             BANDED_STEP, False, None),
            ("motionx stage-1 store ", s1, mx_stage1_args(s1, s1["exp"]), STAGE1_STEP, True,
             "motionx_contact")):
        kinds: list = []
        with record_store_kinds(kinds):
            runs.append(phase_train(t, counters, per_step, tag=tag, args=args, store=store,
                                    steps=MX_STEPS, geometry_cache=per_step is STORE_STEP))
        want = [kind] * 2 if store else []
        if kinds != want:
            raise AssertionError(f"{tag}: stores built {kinds}, expected {want}")
        if tag == "motionx store ":
            phase_motionx_batch(tree, dev)
    runs.append(phase_sample(tree, counters, s1["exp"], s2["exp"]))
    log(f"motionx launches: {[{k: v for k, v in r.items() if v} for r in runs]}")
    return runs


# the card's rotation against the CPU's: CUDA's cosf / sinf are within 2 ulps
# of the true value, the CPU's within 1, and the rotation's products and sum,
# the normalization's subtraction and division each round once on each side:
# within MX_ROT_UNITS f32 unit roundoffs (2^-24) of (r + |mean|) / std, r the
# point's or joint's distance from the z axis (mean 0 and std 1 for the
# cloud), before the rounding to f16, which adds one f16 ulp of the value
MX_ROT_UNITS = 16


def rotation_excess(a: np.ndarray, b: np.ndarray, scale: np.ndarray) -> float:
    """The largest |a - b| of two f16 results of a rotation, in units of what
    MX_ROT_UNITS allows at ``scale``: at most 1 passes."""
    a, b = a.astype(np.float32), b.astype(np.float32)
    ulp = np.maximum(np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float16)
                                ).astype(np.float32), 2.0 ** -24)
    return float((np.abs(a - b) / (ulp + MX_ROT_UNITS * 2.0 ** -24 * scale)).max())


def rotation_scales(store, rows: np.ndarray) -> dict:
    """(r + |mean|) / std of ``x`` and r of ``c_pc_xyz`` for the store rows
    ``rows``, r from the unrotated rows (the padding frames' 0)."""
    H = store.meta["max_horizon"]
    raw = store.arrays["motion32"][rows][:, :H]
    raw = np.pad(raw, ((0, 0), (0, H - raw.shape[1]), (0, 0)))
    r_joint = np.repeat(np.hypot(raw[..., 0::3], raw[..., 1::3]), 3, axis=-1)
    xyz = store.arrays["xyz16"][rows].astype(np.float32)
    return {"x": (r_joint + np.abs(store.meta["mean"])) / store.meta["std"],
            "c_pc_xyz": np.repeat(np.hypot(xyz[..., :1], xyz[..., 1:2]), 3, axis=-1),
            "c_pc_contact": np.zeros(xyz.shape[:-1] + (store.arrays["dist16"].shape[-1],))}


def phase_motionx_batch(tree: dict, dev: torch.device) -> None:
    """One batch of B items assembled on the card from the ``motionx`` store
    (rotation, normalization, the mix override) against the same index
    batch assembled on the CPU: ``x_mask`` and the fps wire equal, ``x``,
    ``c_pc_xyz`` and ``c_pc_contact`` within one f16 ulp plus what
    MX_ROT_UNITS allows the rotation (:func:`rotation_excess`)."""
    import random

    from afford_motion_torch.data import create_dataset
    from afford_motion_torch.train.device_store import DeviceStore, make_assemble_fn
    from afford_motion_torch.utils.config import load_config

    cfg = load_config("configs", mx_args(tree, WORK / "exp_mx_batch"))
    random.seed(SEED)
    np.random.seed(SEED)
    ds = create_dataset(cfg.task.dataset, cfg.task.train.phase)
    store = DeviceStore.try_build(ds)
    if store is None or store.meta["kind"] != "motionx" or not store.meta["rotate"]:
        raise AssertionError("motionx batch: no rotating motionx store")
    seed = SEED + 9
    meta = store.draw_batch(ds, list(range(B)), random.Random(seed),
                            np.random.RandomState(seed + 1))
    meta.pop("c_text")
    meta["text_emb"] = np.zeros((B, 1, 16), np.float16)
    if not meta["mix_mask"].any():
        raise AssertionError("motionx batch: no item took its pred_contact file")
    out = []
    for where in (dev, torch.device("cpu")):
        st = DeviceStore(dict(store.arrays), dict(store.meta))
        x, cond = make_assemble_fn(st, where)({k: torch.from_numpy(v).to(where)
                                               for k, v in meta.items()})
        out.append({"x": x.cpu(), **{k: v.cpu() for k, v in cond.items()}})
    card, cpu = out
    scales = rotation_scales(store, meta["item_row"])
    for k in cpu:
        if k in scales:
            a, b = card[k].numpy(), cpu[k].numpy()
            excess = rotation_excess(a, b, scales[k])
            d = np.abs(a.astype(np.float32) - b.astype(np.float32))
            ulp = np.spacing(np.maximum(np.abs(a), np.abs(b))).astype(np.float32)
            log(f"motionx batch: {k} {tuple(a.shape)} card vs CPU: {int((a != b).sum())} of "
                f"{a.size} entries differ, at most {float((d / ulp).max()):.1f} f16 ulp, "
                f"{excess:.3f} of the allowance (1 f16 ulp + {MX_ROT_UNITS} x 2^-24 x scale)")
            if card[k].dtype != torch.float16 or excess > 1.0:
                raise AssertionError(f"motionx batch: {k} differs by {excess} of the allowance")
        elif not torch.equal(card[k], cpu[k]):
            raise AssertionError(f"motionx batch: {k} differs between the card and the CPU")


def phase_sample(tree: dict, counters: dict, s1_exp: Path, s2_exp: Path) -> dict:
    """``python -m afford_motion_torch.sample``'s two-stage demo chain from
    the MotionX phase's checkpoints, DDPM-500, one batch of MX_SAMPLE cases:
    stage 1 (``ContactMapExampleDataset``, the CDM-Perceiver) writes one
    ``contact.npy`` of (N_POINTS, 3 + 6) finite f32 a case; stage 2
    (``ContactMotionExampleDataset`` through ``task.sample.contact_folder``,
    the CMDM) one skeleton PLY a frame of each case. Stage 1 launches none of
    the kernels; stage 2's chain one encoding (``PLAIN_STEP``: the example
    clouds carry no cached geometry). Returns the launches of both."""
    from afford_motion_torch import sample as entry

    ex = WORK / "mx_examples"
    ex.mkdir(exist_ok=True)
    idx = range(MX_ITEMS - MX_SAMPLE, MX_ITEMS)
    texts = [f"walk to the object {i}" for i in idx]
    (ex / "contact.txt").write_text("".join(f"{t}#HUMANISE#{i}\n" for t, i in zip(texts, idx)))
    (ex / "motion.txt").write_text("".join(
        f"{t}#HUMANISE#{i}#{n}\n" for t, i, n in zip(texts, idx, MX_FRAMES)))
    launches = {k: 0 for k in counters}
    stage1 = mx_stage1_args(tree, s1_exp) + [f"task.sample.data_path={ex / 'contact.txt'}",
                                             f"task.sample.batch_size={MX_SAMPLE}"]
    stage2 = mx_args(tree, s2_exp) + [f"task.sample.data_path={ex / 'motion.txt'}",
                                      f"task.sample.batch_size={MX_SAMPLE}"]
    out1 = None
    for name, args, per_chain in (("stage 1", stage1, STAGE1_STEP),
                                  ("stage 2", stage2, PLAIN_STEP)):
        if out1 is not None:
            args = args + [f"task.sample.contact_folder={out1}"]
        reset(counters)
        t0 = time.monotonic()
        out = Path(entry.main(args))
        wall = time.monotonic() - t0
        counts = {k: fn.launches for k, fn in counters.items()}
        check_launches(f"sample {name}", counts, per_chain, 1, backward=False)
        cases = sorted(p.name for p in out.iterdir() if p.is_dir())
        if cases != [f"{i:03d}-{t}" for i, t in enumerate(texts)]:
            raise AssertionError(f"sample {name}: cases {cases}")
        if out1 is None:
            for case in cases:
                c = np.load(out / case / "contact.npy")
                if c.shape != (N_POINTS, 3 + 6) or c.dtype != np.float32 \
                        or not np.isfinite(c).all():
                    raise AssertionError(f"sample stage 1: {case}/contact.npy is "
                                         f"{c.dtype} {c.shape}")
            out1 = out
            detail = f"{len(cases)} contact.npy of ({N_POINTS}, 9) f32, finite"
        else:
            frames = [len(list((out / case).glob("frame_*.ply"))) for case in cases]
            if frames != list(MX_FRAMES):
                raise AssertionError(f"sample stage 2: frames {frames}, expected {MX_FRAMES}")
            detail = f"frame PLYs per case {frames}"
        timing = json.loads((out / "timing.json").read_text())
        chain = timing["chains"][0]
        log(f"sample {name}: DDPM-500 chain of {MX_SAMPLE} "
            f"{chain['prepare_s'] + chain['loop_s']:.3f} s (prepare {chain['prepare_s']:.3f} s, "
            f"{1e3 * chain['loop_s'] / chain['steps']:.3f} ms a step), visualizer "
            f"{timing['visualize_s'][0]:.3f} s, entry {wall:.1f} s; {detail}; launches {counts}")
        for k in launches:
            launches[k] += counts[k]
    return launches


# the raw-data preparation chain (afford_motion_torch.prepare process ..
# target_mask, then sort|geometry|pack) on a synthetic raw HUMANISE release:
# RAW_SCENES ScanNet-layout scenes of RAW_SCENE_POINTS points with their
# segments and objects, MX_ITEMS motions of 40..196 frames, the SMPL-X body
# model at the official mesh size; contact_data samples N_POINTS points in a
# 4 m region. One PROX sequence of RAW_PROX_FRAMES frames goes through
# PROXExtractor. The card's joints (smplx_to_vec, PROX's pelvis, the
# visualizer's LBS vertices) are held to the CPU's float32 LBS within
# RAW_JOINT_ATOL + RAW_JOINT_RTOL * |x|, the tests' tolerance against JAX
RAW_SCENES, RAW_SCENE_POINTS, RAW_PROX_FRAMES = 8, 150_000, 120
RAW_JOINT_ATOL = RAW_JOINT_RTOL = 1e-5
RAW_VIS_FRAMES = 40


def tree_files(root: Path) -> dict:
    """Every file under ``root``: its path relative to it -> its bytes."""
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def joints_excess(card: np.ndarray, cpu: np.ndarray) -> float:
    """The largest |card - cpu| in units of RAW_JOINT_ATOL + RAW_JOINT_RTOL *
    |cpu|: at most 1 within tolerance."""
    return float((np.abs(card - cpu) / (RAW_JOINT_ATOL + RAW_JOINT_RTOL * np.abs(cpu))).max())


def check_sorted_sidecar(base: Path, before: dict, what: str) -> None:
    """Each item of ``before`` (its points and target mask before ``sort``):
    the sorted contacts hold a permutation of its rows, not the identity,
    and its ``target_mask`` sidecar follows the same permutation."""
    for i, (xyz, mask) in before.items():
        now = np.load(base / "contacts" / f"{i:05d}.npz")["points"][:, :3]
        row = {p.tobytes(): r for r, p in enumerate(xyz)}
        order = np.array([row[p.tobytes()] for p in now])
        if (order == np.arange(len(xyz))).all() or not np.array_equal(
                np.load(base / "target_mask" / f"{i:05d}.npy"), mask[order]):
            raise AssertionError(f"{what}: item {i}'s target_mask does not follow its sorted "
                                 "rows")


def prepare_stages(counters: dict, stages, data: Path, args: list, tag: str,
                   per_chunk: dict | None = None, total: dict | None = None) -> dict:
    """Each of ``stages`` through ``python -m afford_motion_torch.prepare``
    with ``args``; its seconds and launches logged, the launches added to
    ``total``. Only ``geometry`` may launch a kernel: one hierarchy with its
    up kNN (``per_chunk``) a chunk of B scenes. Returns the seconds of each
    stage."""
    from afford_motion_torch import prepare

    seconds = {}
    for stage in stages:
        reset(counters)
        t0 = time.monotonic()
        prepare.main([stage, "--out_dir", str(data), *args])
        seconds[stage] = time.monotonic() - t0
        counts = {k: fn.launches for k, fn in counters.items()}
        log(f"{tag} {stage}: {seconds[stage]:.2f} s, launches {counts}")
        if stage == "geometry":
            check_launches(f"{tag} geometry", counts, per_chunk, -(-MX_ITEMS // B),
                           backward=False)
        elif any(counts.values()):
            raise AssertionError(f"{tag} {stage}: launched {counts}")
        for k in total or {}:
            total[k] += counts[k]
    return seconds


def check_contact_data(card: Path, cpu: Path, dev: torch.device) -> None:
    """``contact_motion/`` of the card's run against the CPU's on the same
    ``motions_pos``: every file but ``dist`` byte-equal (``motions/``,
    ``anno.csv``, the contacts' ``points`` and ``mask``); each pair's
    ``dist`` of both within its bound of the float64 brute force on the card
    (``contact_data.dist_excess`` at most 1); the first pair's row of its
    batch bit-equal to the pair computed alone on the card."""
    from afford_motion_torch.prepare import contact_data as cd

    a, b = card / "HUMANISE" / "contact_motion", cpu / "HUMANISE" / "contact_motion"
    if tree_files(a / "motions") != tree_files(b / "motions"):
        raise AssertionError("raw chain contact_data: motions/ differs card vs CPU")
    if (a / "anno.csv").read_bytes() != (b / "anno.csv").read_bytes():
        raise AssertionError("raw chain contact_data: anno.csv differs card vs CPU")
    worst = {"card": 0.0, "cpu": 0.0}
    t_exact = 0.0
    for i in range(MX_ITEMS):
        za, zb = (np.load(d / "contacts" / f"{i:05d}.npz") for d in (a, b))
        for key in ("points", "mask"):
            if not np.array_equal(za[key], zb[key]) or za[key].dtype != zb[key].dtype:
                raise AssertionError(f"raw chain contact_data: item {i}'s {key} differs")
        pose = np.load(a / "motions" / f"{i:05d}.npy")
        xyz = za["points"][:, :3]
        t0 = time.monotonic()
        exact = cd.joint_distance_map_plain(torch.from_numpy(pose).to(dev),
                                            torch.from_numpy(xyz).to(dev)).cpu()
        t_exact += time.monotonic() - t0
        for side, z in (("card", za), ("cpu", zb)):
            if z["dist"].shape != (N_POINTS, 22) or z["dist"].dtype != np.float32:
                raise AssertionError(f"raw chain contact_data: item {i}'s dist is "
                                     f"{z['dist'].dtype} {z['dist'].shape}")
            worst[side] = max(worst[side], cd.dist_excess(z["dist"], exact, pose, xyz))
        if i == 0:
            alone = cd.joint_distance_map(pose, xyz, dev)
            if not np.array_equal(alone, za["dist"]):
                raise AssertionError("raw chain contact_data: item 0 alone differs from its "
                                     "batch row on the card")
    log(f"raw chain contact_data: card vs CPU files equal but dist; dist against the float64 "
        f"brute force on the card ({t_exact:.2f} s for {MX_ITEMS} pairs): largest "
        f"|d^2 - exact^2| {worst['card']:.3f} (card) and {worst['cpu']:.3f} (CPU) of the bound "
        f"{cd.DIST_UNITS} u (|t|^2 + |s|^2); pair 0 alone bit-equal to its batch row")
    if not max(worst.values()) <= 1.0:
        raise AssertionError(f"raw chain contact_data: dist beyond its bound {worst}")


def phase_raw_chain(dev: torch.device, counters: dict) -> list:
    """The raw-data chain at full width on the card, each card stage also run
    on the CPU on a copy of the same tree: ``process`` (HUMANISE), then
    ``smplx_to_vec`` (the joints against the CPU's; the CPU's copy then takes
    the card's joints), ``process_scene``, ``contact_data`` (its pairs a
    second and peak memory; :func:`check_contact_data`), ``split`` and
    ``target_mask``, every non-``dist`` file byte-equal to the CPU's; then
    ``sort`` (the target masks follow the rows), ``geometry`` (3 FPS and 8
    kNN a chunk of B) and ``pack``, and MX_STEPS + MX_STEPS / 2 steps of
    ``ts2m_contact_motion`` through the ``motionx`` store. One PROX sequence
    through ``process --dataset PROX`` (the pelvis on the card) against the
    CPU's; ``visualize`` through the LBS on the card against the CPU and
    ``visualize_h3d`` on a 263-d result. Returns the launches of the
    geometry stage and of the training."""
    from afford_motion_torch import visualize, visualize_h3d
    from afford_motion_torch.data.synthetic import (
        make_synthetic_raw_humanise,
        make_synthetic_raw_prox,
    )

    work = WORK / "raw_chain"
    raw, prox_raw, data, cpu = work / "raw", work / "prox_raw", work / "data", work / "data_cpu"
    env = {"SMPLX_USE_SYNTHETIC": "1", "SMPLX_SYNTHETIC_VERTS": str(N_VERTS),
           "SMPLX_SYNTHETIC_FACES": str(N_FACES)}
    with environ(env):
        t0 = time.monotonic()
        scenes = make_synthetic_raw_humanise(str(raw), str(data), n_scenes=RAW_SCENES,
                                             scene_points=RAW_SCENE_POINTS, n_motions=MX_ITEMS,
                                             horizon_range=(40, L + 1), seed=SEED + 18)
        make_synthetic_raw_prox(str(prox_raw), str(data), n_frames=(RAW_PROX_FRAMES,),
                                scene_points=RAW_SCENE_POINTS // 3, seed=SEED + 18)
        log(f"raw chain: synthetic raw release ({RAW_SCENES} scenes {scenes[0]}..{scenes[-1]} of "
            f"{RAW_SCENE_POINTS} points, {MX_ITEMS} motions, one PROX sequence of "
            f"{RAW_PROX_FRAMES} frames) in {time.monotonic() - t0:.1f} s")
        args = ["--dataset", "HUMANISE", "--data_dir", str(raw), "--num_points", str(N_POINTS),
                "--region_size", "4.0", "--batch_size", str(B)]
        cpu_args = args + ["--device", "cpu"]
        seconds = prepare_stages(counters, ("process",), data, args, "raw chain")
        shutil.copytree(data, cpu)
        seconds.update(prepare_stages(counters, ("smplx_to_vec",), data, args, "raw chain"))
        prepare_stages(counters, ("smplx_to_vec",), cpu, cpu_args, "raw chain CPU")
        pos = sorted((data / "HUMANISE" / "motions_pos").glob("*.npy"))
        excess = max(joints_excess(np.load(p), np.load(cpu / "HUMANISE" / "motions_pos" / p.name))
                     for p in pos)
        log(f"raw chain smplx_to_vec: {len(pos) / seconds['smplx_to_vec']:.1f} sequences a second "
            f"on the card ({N_VERTS}-vertex SMPL-X); joints card vs CPU {excess:.3f} of "
            f"{RAW_JOINT_ATOL:.0e} + {RAW_JOINT_RTOL:.0e} |x|")
        if len(pos) != MX_ITEMS or not excess <= 1.0:
            raise AssertionError(f"raw chain smplx_to_vec: {len(pos)} sequences, joints card vs "
                                 f"CPU {excess:.3f} of their tolerance")
        shutil.rmtree(cpu / "HUMANISE" / "motions_pos")
        shutil.copytree(data / "HUMANISE" / "motions_pos", cpu / "HUMANISE" / "motions_pos")
        seconds.update(prepare_stages(counters, ("process_scene",), data, args, "raw chain"))
        torch.cuda.reset_peak_memory_stats(dev)
        seconds.update(prepare_stages(counters, ("contact_data",), data, args, "raw chain"))
        peak = torch.cuda.max_memory_allocated(dev)
        seconds.update(prepare_stages(counters, ("split", "target_mask"), data, args, "raw chain"))
        t0 = time.monotonic()
        prepare_stages(counters, ("process_scene", "contact_data", "split", "target_mask"), cpu,
                       cpu_args, "raw chain CPU")
        log(f"raw chain contact_data: {MX_ITEMS / seconds['contact_data']:.1f} pairs a second on "
            f"the card ({N_POINTS} points, chunks of 16, frames padded to 32), peak memory "
            f"{peak / 2**30:.2f} GiB; the CPU's four stages {time.monotonic() - t0:.1f} s")
        check_contact_data(data, cpu, dev)
        for sub in ("HUMANISE/points", "HUMANISE/contact_motion/target_mask"):
            if tree_files(data / sub) != tree_files(cpu / sub) or not tree_files(data / sub):
                raise AssertionError(f"raw chain: {sub} differs card vs CPU")
        for name in ("train.txt", "test.txt", "all.txt"):
            if (data / "HUMANISE" / name).read_bytes() != (cpu / "HUMANISE" / name).read_bytes():
                raise AssertionError(f"raw chain split: {name} differs card vs CPU")
        base = data / "HUMANISE" / "contact_motion"
        before = {i: (np.load(base / "contacts" / f"{i:05d}.npz")["points"][:, :3],
                      np.load(base / "target_mask" / f"{i:05d}.npy")) for i in (0, MX_ITEMS - 1)}
        prep = {k: 0 for k in counters}
        seconds.update(prepare_stages(counters, ("sort", "geometry", "pack"), data, args,
                                      "raw chain", dict(STAGE1_STEP, fps=3,
                                                        knn=DEC_PLAIN_STEP["knn"]), prep))
        check_sorted_sidecar(base, before, "raw chain sort")
        meta = json.loads((base / "packed" / "meta.json").read_text())
        if not (meta["morton"] and len(meta["bases"]) == MX_ITEMS
                and "geo_sm1_fps_idx" in meta["fields"]):
            raise AssertionError("raw chain pack: the store is not sorted, cached and whole")
        log(f"raw chain: raw release -> packed store in {sum(seconds.values()):.1f} s on the "
            f"card ({', '.join(f'{k} {v:.1f}' for k, v in seconds.items())})")
        tree = {"data": data, "packed": base / "packed", "exp": work / "exp_store"}
        kinds: list = []
        with record_store_kinds(kinds):
            train = phase_train(tree, counters, STORE_STEP, tag="raw chain motionx store ",
                                args=mx_args(tree, tree["exp"]), store=True, steps=MX_STEPS,
                                geometry_cache=True)
        if kinds != ["motionx"] * 2:
            raise AssertionError(f"raw chain train: stores built {kinds}")
        phase_raw_prox(data, cpu, prox_raw, counters)
        phase_raw_visualize(work, dev, visualize, visualize_h3d)
    return [prep, train]


def phase_raw_prox(data: Path, cpu: Path, prox_raw: Path, counters: dict) -> None:
    """``process --dataset PROX`` of one sequence on the card and on the CPU:
    ``normalize_to_center.json`` byte-equal, the pickle's orients, body
    poses, hands and betas equal and its translations (from the pelvis of
    the LBS) within the joints' tolerance."""
    import pickle

    args = ["--dataset", "PROX", "--data_dir", str(prox_raw)]
    t = prepare_stages(counters, ("process",), data, args, "raw chain PROX")["process"]
    prepare_stages(counters, ("process",), cpu, args + ["--device", "cpu"], "raw chain PROX CPU")
    a, b = data / "PROX", cpu / "PROX"
    if (a / "normalize_to_center.json").read_bytes() != (b / "normalize_to_center.json"
                                                        ).read_bytes():
        raise AssertionError("raw chain PROX: normalize_to_center.json differs card vs CPU")
    names = sorted(p.name for p in (a / "motions").glob("*.pkl"))
    for name in names:
        with open(a / "motions" / name, "rb") as f:
            pa, ba = pickle.load(f)
        with open(b / "motions" / name, "rb") as f:
            pb, bb = pickle.load(f)
        excess = joints_excess(pa[:, :3], pb[:, :3])
        if not (pa.shape == (RAW_PROX_FRAMES, 159) and np.array_equal(pa[:, 3:], pb[:, 3:])
                and np.array_equal(ba, bb) and excess <= 1.0):
            raise AssertionError(f"raw chain PROX: {name} differs card vs CPU ({excess:.3f} of "
                                 "the joints' tolerance in the translations)")
    log(f"raw chain PROX: {names} ({RAW_PROX_FRAMES} frames) in {t:.2f} s on the card, the "
        f"translations card vs CPU {excess:.3f} of the joints' tolerance, the rest equal")


def phase_raw_visualize(work: Path, dev: torch.device, visualize, visualize_h3d) -> None:
    """``visualize`` on a result pickle of RAW_VIS_FRAMES frames without
    ``--render_joint``: one SMPL-X mesh a frame through the LBS on the card,
    the vertices against the CPU run's within the joints' tolerance;
    ``visualize_h3d`` on a 263-d result: one skeleton frame a frame."""
    import pickle

    from afford_motion_torch.utils.mesh import load_mesh_ply

    rng = np.random.default_rng(SEED + 19)
    res = work / "results"
    res.mkdir()
    with open(res / "00000.pkl", "wb") as f:
        pickle.dump({"joints": rng.normal(size=(RAW_VIS_FRAMES, 66)).astype(np.float32),
                     "params": rng.normal(scale=0.3, size=(RAW_VIS_FRAMES, 69)).astype(
                         np.float32)}, f)
    t0 = time.monotonic()
    visualize.main(["--file", str(res / "00000.pkl"), "--out_dir", str(work / "vis_card")])
    wall = time.monotonic() - t0
    visualize.main(["--file", str(res / "00000.pkl"), "--out_dir", str(work / "vis_cpu"),
                    "--device", "cpu"])
    frames = sorted((work / "vis_card" / "00000").glob("frame_*.ply"))
    excess = max(joints_excess(load_mesh_ply(str(p)).vertices,
                               load_mesh_ply(str(work / "vis_cpu" / "00000" / p.name)).vertices)
                 for p in frames)
    if len(frames) != RAW_VIS_FRAMES or not excess <= 1.0:
        raise AssertionError(f"raw chain visualize: {len(frames)} frames, vertices card vs CPU "
                             f"{excess:.3f} of the joints' tolerance")
    with open(res / "h3d.pkl", "wb") as f:
        pickle.dump({"motion": rng.normal(scale=0.2, size=(L, D)).astype(np.float32),
                     "m_len": 120, "text": "a person walks"}, f)
    visualize_h3d.main(["--file", str(res / "h3d.pkl"), "--out_dir", str(work / "vis_h3d")])
    h3d = len(list((work / "vis_h3d" / "h3d").glob("frame_*.ply")))
    if h3d != 120:
        raise AssertionError(f"raw chain visualize_h3d: {h3d} frames")
    log(f"raw chain visualize: {RAW_VIS_FRAMES} SMPL-X frames ({N_VERTS} vertices) in {wall:.1f} "
        f"s, vertices card vs CPU {excess:.3f} of the joints' tolerance; visualize_h3d 120 frames")


def phase_norm_layer(dev: torch.device, counters: dict) -> list:
    """``model.norm=layer``: two float32 train steps (dropout 0) of each model,
    built from the config (``build_cmdm``/``build_cdm`` of ``load_config``
    with ``model.norm=layer``), on the card through the kernels against the
    same steps on the CPU through the plain versions, from the same weights,
    batch, t and noise: the flagship CMDM ``trans_enc`` and a ``PointTrans``
    CDM with its scene model, both at the published widths on 2 x 8192
    points. The second loss follows the first update, so it reads the card's
    backward. Limits as in the reference phase: each loss within 1e-3 (rel),
    every weight within 2 steps x 2 lr, and all but 2% within 2e-6 in each
    of the model's parts (the point encoder's weights apart from the
    denoiser's); the card's launches exactly two steps' (``PLAIN_STEP``,
    ``PT_SCENE_STEP``). Returns the launches."""
    from afford_motion_torch.diffusion import create_gaussian_diffusion
    from afford_motion_torch.models.cdm import build_cdm
    from afford_motion_torch.models.cmdm import build_cmdm
    from afford_motion_torch.models.layers import LayerNorm
    from afford_motion_torch.train.loop import make_train_step
    from afford_motion_torch.train.state import TrainState
    from afford_motion_torch.utils.config import DictConfig, load_config

    rng = np.random.default_rng(SEED + 20)
    lr, lb, n, runs = 1e-4, 2, N_POINTS, []
    layer = ["model.norm=layer", "model.dtype=float32"]
    x_mask = np.zeros((lb, L), dtype=bool)
    x_mask[1, 120:] = True
    cmdm_cfg = load_config("configs", ["task=contact_motion_gen", "model=cmdm",
                                       "model.arch=trans_enc", f"model.input_feats={D}",
                                       "model.dropout=0.0", *layer]).model
    cdm_cfg = load_config("configs", ["task=contact_gen", "model=cdm", "model.arch=PointTrans",
                                      "model.input_feats=6", *layer]).model
    cases = [
        ("CMDM trans_enc", lambda: build_cmdm(cmdm_cfg), PLAIN_STEP, {
            "c_pc_xyz": rng.normal(size=(lb, n, 3)).astype(np.float32),
            "c_pc_contact": rng.uniform(size=(lb, n, 6)).astype(np.float32),
            "text_emb": rng.normal(size=(lb, 1, 512)).astype(np.float32), "x_mask": x_mask},
         rng.standard_normal((lb, L, D)).astype(np.float32)),
        ("CDM PointTrans + scene", lambda: build_cdm(cdm_cfg), PT_SCENE_STEP, {
            "c_pc_xyz": rng.normal(size=(lb, n, 3)).astype(np.float32),
            "c_pc_feat": rng.uniform(size=(lb, n, 3)).astype(np.float32),
            "text_emb": rng.normal(size=(lb, 1, 512)).astype(np.float32)},
         rng.normal(size=(lb, n, 6)).astype(np.float32))]
    for name, build, per_step, cond, x in cases:
        torch.manual_seed(SEED + 20)
        cpu_model = build()
        norms = sum(isinstance(m, LayerNorm) for m in cpu_model.modules())
        initial = {k: v.clone() for k, v in cpu_model.state_dict().items()}
        ts = rng.integers(0, 1000, size=(2, lb))
        noises = rng.standard_normal((2, *x.shape)).astype(np.float32)
        losses, weights = [], []
        for device in (torch.device("cpu"), dev):
            model = build().to(device)
            model.load_state_dict(initial, strict=True)
            diffusion = create_gaussian_diffusion(DictConfig({"steps": 1000}), device)
            state = TrainState.create(model, lr=lr)
            step = make_train_step(model, diffusion)
            c = {k: torch.from_numpy(v).to(device) for k, v in cond.items()}
            reset(counters)
            losses.append([float(step(state, torch.from_numpy(x).to(device), c, seed=i,
                                      t=torch.from_numpy(ts[i]).to(device),
                                      noise=torch.from_numpy(noises[i]).to(device))["loss"])
                           for i in range(2)])
            weights.append({part: torch.cat([p.detach().cpu().reshape(-1)
                                             for p in child.parameters()])
                            for part, child in model.named_children()
                            if any(True for _ in child.parameters())})
        launches = {k: fn.launches for k, fn in counters.items()}
        diffs = {part: (weights[0][part] - weights[1][part]).abs() for part in weights[0]}
        worst = max(d.max().item() for d in diffs.values())
        far = {part: float((d > 2e-6).float().mean()) for part, d in diffs.items()}
        rel = max(abs(a - b) / abs(a) for a, b in zip(losses[0], losses[1]))
        log(f"norm=layer: two f32 train steps of the {name} ({norms} float32 LayerNorms in the "
            f"point backbones and transformers), card vs CPU: losses {losses[1]} vs "
            f"{losses[0]}, weights max abs diff {worst:.3e}, share beyond 2e-6 by part "
            f"{ {part: f'{100 * v:.3f}%' for part, v in far.items()} }; card launches {launches}")
        if not (np.isfinite(losses[1]).all() and rel <= 1e-3 and worst <= 4.004 * lr
                and max(far.values()) <= 0.02):
            raise AssertionError(f"norm=layer: the {name}'s train steps on the card disagree "
                                 "with the CPU's")
        check_launches(f"norm=layer {name}", launches, per_step, 2, backward=True)
        runs.append(launches)
    return runs


def scene_args(tree: dict) -> list:
    """``scripts/ts2m_contact_motion/test.sh`` on the synthetic HUMANISE tree:
    one batch of 32, both of its contact maps sampled."""
    return [
        "task=contact_motion_gen", "model=cmdm", "diffusion.steps=500",
        "task.dataset.sets=[HUMANISE]", f"task.dataset.data_dir={tree['data']}",
        f"task.test.contact_folder={tree['contacts']}", f"exp_dir={tree['exp']}",
        f"task.test.batch_size={B}", "task.evaluator.eval_nbatch=1",
        "task.evaluator.k_samples=2", f"task.evaluator.num_k_samples={B}",
        "task.evaluator.opt_steps=200", f"task.evaluator.fit_batch={FIT_BATCH}",
        f"task.evaluator.joints_to_smplx_model_weights={tree['regressor']}", f"seed={SEED}",
        *common_args(),
    ]


def check_scene_outputs(out: Path) -> None:
    """What the scene-protocol run wrote: finite samples of the expected
    shape, the four metrics finite and in range, physics run for every
    sequence (so the fitter was built), pickles with 69-d params."""
    import pickle

    z = np.load(out / "samples.npz")
    if z["sample"].shape != (B, L, D_POS) or z["k_samples"].shape != (B, 2, L, D_POS) \
            or not (np.isfinite(z["sample"]).all() and np.isfinite(z["k_samples"]).all()):
        raise AssertionError(f"scene slice: bad samples {z['sample'].shape}")
    metrics = dict(line.split(": ") for line in
                   (out / "metrics.txt").read_text().splitlines())
    per_case = json.loads((out / "metrics.json").read_text())
    log(f"scene slice: samples {z['sample'].shape} finite, metrics {metrics}")
    if list(metrics) != ["non_collision", "contact", "dist", "apd"] or not all(
            np.isfinite(float(v)) for v in metrics.values()):
        raise AssertionError(f"scene slice: metrics.txt holds {metrics}")
    if not (0.0 <= float(metrics["non_collision"]) <= 1.0
            and 0.0 <= float(metrics["contact"]) <= 1.0 and float(metrics["dist"]) <= 0.0
            and float(metrics["apd"]) > 0.0):
        raise AssertionError(f"scene slice: a metric is out of range: {metrics}")
    # the fitter was built and physics ran for every sequence
    if [len(per_case[k]) for k in ("non_collision", "contact", "apd")] != [B, B, B] \
            or not 0 < len(per_case["dist"]) <= B:
        raise AssertionError("scene slice: physics did not run for every sequence")
    files = sorted((out / "joints").glob("*.pkl"))
    payloads = [pickle.loads(f.read_bytes()) for f in files]
    if len(files) != B or not all(
            p["params"].shape == (L, 69) and np.isfinite(p["params"]).all()
            and p["joints"].shape[1] == D_POS for p in payloads):
        raise AssertionError("scene slice: joints/*.pkl lack finite 69-d params")


def capture_evaluator(create, seen: dict):
    """``create_evaluator`` that also records its arguments and what its
    evaluator's ``evaluate`` was given (the samples and the dataloader), so
    a second evaluator can be run over the same samples."""
    def creating(*args, **kwargs):
        evaluator = create(*args, **kwargs)
        evaluate = evaluator.evaluate
        seen.update(args=args, kwargs=kwargs)

        def recording(sample_list, k_samples_list, save_dir, dataloader, **kw):
            seen.update(samples=(sample_list, k_samples_list), dataloader=dataloader)
            return evaluate(sample_list, k_samples_list, save_dir, dataloader, **kw)

        evaluator.evaluate = recording
        return evaluator
    return creating


def phase_scene_slice(dev: torch.device, counters: dict, assets: dict | None = None) -> dict:
    """The scene-protocol test path through the test entry, with the fused
    attention on; then one DDIM-50 chain each way for the denoiser step's
    time with and without it. With ``assets`` (:func:`make_eval_assets`),
    also the in-process HumanML3D metrics over the same samples
    (:func:`phase_scene_humanml`). Returns the launches of the protocol
    run."""
    from afford_motion_torch import test as entry
    from afford_motion_torch.eval import create_evaluator

    env = {"AM_FLASH_ATTN": "1", "SMPLX_USE_SYNTHETIC": "1",
           "SMPLX_SYNTHETIC_VERTS": str(N_VERTS), "SMPLX_SYNTHETIC_FACES": str(N_FACES)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        t0 = time.monotonic()
        tree = make_scene_tree(dev)
        if assets is not None:
            from afford_motion_torch.data.synthetic import make_synthetic_h3d_contact_motion

            make_synthetic_h3d_contact_motion(str(tree["data"]), n_items=T2M_GT, seed=SEED)
        log(f"scene slice: tree, checkpoints and regressor in {time.monotonic() - t0:.1f} s")
        # the ts2m chain: stage 2 reads the contact maps stage 1 writes
        tree["contacts"], _ = phase_ts2m_contact(tree, counters)
        base = scene_args(tree)
        seen = {}
        entry.create_evaluator = capture_evaluator(create_evaluator, seen)
        try:
            reset(counters)
            out = Path(entry.main(base))
            launches = {k: fn.launches for k, fn in counters.items()}
        finally:
            entry.create_evaluator = create_evaluator
        timing = json.loads((out / "timing.json").read_text())
        chains = timing["chains"]
        # two chains of one hierarchy each; the attention once per layer of
        # each of the 500 denoiser steps of both chains and of the regressor's
        # call on each fit batch; the 1-NN once per evaluated sequence
        want = {k: 2 * v * ("scatter" not in k) for k, v in PLAIN_STEP.items()}
        want["nn1"] = B
        want["attention"] = (CMDM_LAYERS * 500 * len(chains)
                             + REGRESSOR_LAYERS * -(-B // FIT_BATCH))
        log(f"scene slice: launches {launches}")
        if len(chains) != 2 or launches != want:
            raise AssertionError(f"scene slice: {len(chains)} chains, launches {launches}, "
                                 f"expected {want}")
        check_scene_outputs(out)
        written = {f.stem for f in (tree["contacts"] / "HUMANISE" / "pred_contact").glob("*.npy")}
        if not {f"{int(i):05d}" for i in np.load(out / "samples.npz")["info_index"]} <= written:
            raise AssertionError("scene slice: an item without stage 1's contact file")
        # a second evaluator over the same samples: metrics.json byte for byte
        again = out / "evaluated_again"
        again.mkdir()
        t0 = time.monotonic()
        second = create_evaluator(*seen["args"], **seen["kwargs"])
        second.evaluate(*seen["samples"], str(again), seen["dataloader"])
        second.report(str(again))
        same = (again / "metrics.json").read_bytes() == (out / "metrics.json").read_bytes()
        log(f"scene slice: a second evaluator run over the same samples "
            f"({time.monotonic() - t0:.1f} s): metrics.json byte-identical={same}")
        if not same:
            raise AssertionError("scene slice: two evaluator runs over the same samples wrote "
                                 "different metrics.json")
        if assets is not None:
            phase_scene_humanml(seen, out, counters, assets)
        ev = timing["evaluator"]
        for c in chains:
            log(f"scene slice: DDPM-500 chain {c['chain_s']:.3f} s (hierarchy + contact encoding "
                f"{c['prepare_s']:.3f} s, {1e3 * c['loop_s'] / c['steps']:.3f} ms/step)")
        log(f"scene slice: fit_s {ev['fit_s']:.3f} physics_s {ev['physics_s']:.3f} "
            f"apd_s {ev['apd_s']:.3f} evaluator_s {timing['evaluator_s']:.3f} = "
            f"{B / timing['evaluator_s']:.3f} sequences/s; dataset {timing['dataset_load_s']:.2f} "
            f"s, peak memory {timing.get('peak_memory_bytes', float('nan')) / 2**30:.2f} GiB")

        # the denoiser step with and without the fused attention: a DDIM-50
        # chain each way, no evaluator work
        ddim = base + ["diffusion.timestep_respacing=ddim50", "task.test.sampler=ddim",
                       "task.evaluator.k_samples=0", "task.evaluator.eval_metrics=[]",
                       "task.evaluator.save_results=false"]
        steps_ms = {"1": [], "0": []}
        for flash in ("1", "0") * 3:
            os.environ["AM_FLASH_ATTN"] = flash
            reset(counters)
            t = json.loads((Path(entry.main(ddim)) / "timing.json").read_text())["chains"][0]
            counts = {k: fn.launches for k, fn in counters.items()}
            want = {k: v * ("scatter" not in k) for k, v in PLAIN_STEP.items()}
            want["attention"] = CMDM_LAYERS * 50 * (flash == "1")
            if counts != want:
                raise AssertionError(f"DDIM-50 AM_FLASH_ATTN={flash}: launches {counts}, "
                                     f"expected {want}")
            log(f"scene slice: DDIM-50 with AM_FLASH_ATTN={flash}: "
                f"{1e3 * t['loop_s'] / t['steps']:.3f} ms per denoiser step "
                f"(chain {t['chain_s']:.3f} s)")
            steps_ms[flash].append(1e3 * t["loop_s"] / t["steps"])
        pairs = [a - b for a, b in zip(steps_ms["0"], steps_ms["1"])]
        log(f"scene slice: DDIM-50 denoiser step, {len(pairs)} alternating pairs: fused "
            f"attention {np.median(steps_ms['1']):.3f} ms (median; {min(steps_ms['1']):.3f}-"
            f"{max(steps_ms['1']):.3f}) against {np.median(steps_ms['0']):.3f} "
            f"({min(steps_ms['0']):.3f}-{max(steps_ms['0']):.3f}); without minus with, pair by "
            f"pair: {', '.join(f'{d:.3f}' for d in pairs)} ms")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return launches


# the HumanML3D metric stack (eval/t2m_models.py, evaluator_wrapper.py,
# eval_humanml.py, h3d_eval/): HumanML3D's test split (bench.py
# BENCH_EVAL_GT_POOL), the MDM protocol's 1,000 generated samples and 100
# prompts of 30 draws (MDM's repeats a prompt) for MultiModality; the rows of
# the evaluator's card-vs-CPU check; the in-process ground truth's items
H3D_TEST, H3D_GEN, MM_PROMPTS, MM_K = 4384, 1000, 100, 30
T2M_ROWS, T2M_GT = 256, 64
# the card's co-embeddings against the CPU's, both f32, the largest
# difference as a share of the largest |entry|: set between the card's
# reading (1.2e-6 "ours", 1.3e-6 "mdm") and that of a run with TF32 on for
# cuBLAS and cuDNN (6.5e-4, 6.0e-4), which must break it (an H100 at 700 W)
T2M_LIMIT = 1e-4


def make_eval_assets() -> dict:
    """What the HumanML3D metrics read, from the seed, in the real formats:
    the eval meta (``meta/{mean_std,t2m_mean_std}.npz``, ``meta/test.txt``
    of the in-process ground truth's ids) with a GloVe triple, and seeded
    full-width T2M evaluator checkpoints, "mdm" (263-d, the last 4 channels
    stripped) and "ours" (66-d)."""
    from afford_motion_torch.data.synthetic import make_synthetic_eval_meta, \
        make_synthetic_t2m_ckpt

    root = WORK / "eval"
    make_synthetic_eval_meta(str(root), test_ids=range(T2M_GT), seed=SEED)
    assets = {"meta": root, "mdm": root / "mdm_finest.tar", "ours": root / "ours_finest.tar"}
    make_synthetic_t2m_ckpt(str(assets["mdm"]), seed=SEED)
    make_synthetic_t2m_ckpt(str(assets["ours"]), dim_pose=D_POS, strip=False, seed=SEED + 1)
    return assets


def check_no_launches(name: str, counters: dict) -> None:
    """The HumanML3D phases run no port kernel: the evaluator is XLA's work
    in the JAX package, cuDNN's and cuBLAS's here."""
    counts = {k: fn.launches for k, fn in counters.items()}
    log(f"{name}: launches {counts}")
    if any(counts.values()):
        raise AssertionError(f"{name}: port kernels launched: {counts}")


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 for cuBLAS and cuDNN set to ``on`` inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def phase_t2m_evaluator(dev: torch.device, counters: dict, assets: dict) -> None:
    """Both full-width evaluators on T2M_ROWS seeded rows (motions of 40..196
    frames and a few under 4, captions of 5..22 tokens) on the card against
    the same modules on the CPU, f32: the largest difference of the
    co-embeddings within T2M_LIMIT of the largest entry; then again with
    TF32 planted, which must break it. No port kernel is launched."""
    from afford_motion_torch.eval.evaluator_wrapper import EvaluatorWrapper

    rng = np.random.default_rng(SEED)
    m_lens = rng.integers(40, L + 1, size=T2M_ROWS)
    m_lens[:4] = (3, 1, 2, 3)
    cap = rng.integers(5, 23, size=T2M_ROWS)
    words = rng.standard_normal((T2M_ROWS, 22, 300), dtype=np.float32)
    pos = np.eye(15, dtype=np.float32)[rng.integers(0, 15, size=(T2M_ROWS, 22))]
    reset(counters)
    for variant, dim in (("mdm", D), ("ours", D_POS)):
        motions = rng.standard_normal((T2M_ROWS, L, dim), dtype=np.float32)
        args = (words, pos, cap, motions, m_lens)
        t0 = time.monotonic()
        card = EvaluatorWrapper(str(assets[variant]), variant, device=dev)
        load_s = time.monotonic() - t0
        cpu = EvaluatorWrapper(str(assets[variant]), variant, device="cpu")
        want = np.concatenate(cpu.get_co_embeddings(*args), axis=1)
        scale = float(np.abs(want).max())
        got = np.concatenate(card.get_co_embeddings(*args), axis=1)
        err = float(np.abs(got - want).max()) / scale
        with tf32(True):
            planted = float(np.abs(np.concatenate(card.get_co_embeddings(*args), axis=1)
                                   - want).max()) / scale
        on_card = [torch.as_tensor(a, device=dev) for a in (words, pos, motions)]
        ms = time_ms(lambda: card.get_co_embeddings(on_card[0], on_card[1], cap, on_card[2],
                                                    m_lens, device_out=True), reps=3)
        log(f"t2m evaluator {variant}: {T2M_ROWS} rows of ({L}, {dim}), co-embeddings "
            f"{want.shape}, card vs CPU {err:.3e} of the largest |entry| {scale:.4f} (limit "
            f"{T2M_LIMIT:.0e}); TF32 planted {planted:.3e}; finite={bool(np.isfinite(got).all())}"
            f"; one call of {T2M_ROWS} rows {ms[0]:.3f} ms ({ms[1]:.3f}-{ms[2]:.3f}) by CUDA "
            f"events, checkpoint load and upload {load_s:.2f} s")
        if not (np.isfinite(got).all() and err <= T2M_LIMIT < planted):
            raise AssertionError(f"t2m evaluator {variant}: card vs CPU {err:.3e}, TF32 planted "
                                 f"{planted:.3e}, limit {T2M_LIMIT:.0e}")
    check_no_launches("t2m evaluator", counters)


def run_offline(results: Path, data: Path, assets: dict, mode: str, tag: str,
                extra: tuple = ()) -> tuple:
    """``afford_motion_torch.h3d_eval.eval_h3d_offline`` on the card, as a
    user calls it; returns (metrics file, its bytes, the stage seconds)."""
    from afford_motion_torch.h3d_eval import eval_h3d_offline

    t0 = time.monotonic()
    out = Path(eval_h3d_offline.main([
        "--results_dir", str(results), "--data_dir", str(data),
        "--eval_meta_dir", str(assets["meta"]), "--ckpt", str(assets["mdm"]),
        "--eval_mode", mode, *extra]))
    wall = time.monotonic() - t0
    raw = out.read_bytes()
    metrics = json.loads(raw)
    timing = json.loads(out.with_name(out.stem + "_timing.json").read_text())
    values = [np.asarray(v, dtype=np.float64) for d in metrics.values() for v in d.values()]
    rp = np.asarray(metrics["R_precision"]["vald"][0])
    stages = " ".join(f"{k} {v:.3f}" for k, v in timing.items() if k.endswith("_s"))
    log(f"{tag}: {mode} in {wall:.2f} s ({stages}); pools on the card "
        f"{timing['pool_bytes'] / 1e6:.1f} MB, peak memory "
        f"{timing.get('peak_memory_bytes', float('nan')) / 2**30:.2f} GiB; "
        + "; ".join(f"{m} {metrics[m]}" for m in metrics))
    if list(metrics) != ["Matching Score", "R_precision", "FID", "Diversity", "MultiModality"] \
            or not all(np.isfinite(v).all() for v in values) \
            or not (rp.shape == (3,) and (rp >= 0).all() and (rp <= 1).all()):
        raise AssertionError(f"{tag}: {mode} metrics {metrics}")
    return out, raw, timing


def phase_t2m_scored(tree: dict, t2m_out: Path, counters: dict, assets: dict) -> None:
    """The t2m chain's stage-2 files scored by the offline protocol
    (``wo_mm``) against ``make_tree()``'s test split."""
    files = sorted((t2m_out / "humanml").glob("*.pkl"))
    if len(files) != B:
        raise AssertionError(f"t2m scored: {len(files)} humanml files, expected {B}")
    reset(counters)
    run_offline(t2m_out / "humanml", tree["data"], assets, "wo_mm", f"t2m scored ({B} files)")
    check_no_launches("t2m scored", counters)


def write_protocol_samples(out: Path, rng) -> None:
    """H3D_GEN generated motions and MM_PROMPTS groups of MM_K draws, written
    by ``Text2MotionInSceneHumanML3DEvaluator.evaluate`` into
    ``out/{gen,mm}/humanml``: seeded (196, 263) motions of 40..196 frames,
    captions of 5..22 tokens."""
    from afford_motion_torch.data.synthetic import synthetic_caption
    from afford_motion_torch.eval import create_evaluator
    from afford_motion_torch.utils.config import DictConfig

    class Dataset:
        def denormalize(self, x):
            return x

    class Loader:
        dataset = Dataset()

    def case(i: int) -> dict:
        text, tokens = synthetic_caption(rng, int(rng.integers(5, 23)))
        return {"x_mask": np.arange(L) >= int(rng.integers(40, L + 1)), "c_text": text,
                "info_tokens": tokens, "info_index": f"{i:06d}", "info_caption_index": 0}

    ev = create_evaluator(DictConfig({"evaluator": {
        "name": "Text2MotionInSceneHumanML3DEvaluator", "save_results": True}}), device="cpu")
    ev.evaluate([{"sample": rng.standard_normal((L, D), dtype=np.float32), **case(i)}
                 for i in range(H3D_GEN)], [], str(out / "gen"), Loader())
    ev.evaluate([], [{"k_samples": rng.standard_normal((MM_K, L, D), dtype=np.float32),
                      **case(H3D_GEN + i)} for i in range(MM_PROMPTS)], str(out / "mm"), Loader())


def phase_protocol(counters: dict, assets: dict) -> None:
    """The offline protocol at HumanML3D's scale: H3D_TEST test motions of
    40..196 frames (texts and split, no contact files), H3D_GEN generated
    samples, MM_PROMPTS k-sample files of (MM_K, 196, 263); ``wo_mm`` twice
    (the metrics file byte-identical) and ``mm_short`` once through the
    entry on the card. No port kernel is launched."""
    from afford_motion_torch.data.synthetic import make_synthetic_h3d_protocol

    t0 = time.monotonic()
    root = WORK / "protocol"
    make_synthetic_h3d_protocol(str(root / "data"), n_train=0, n_test=H3D_TEST,
                                horizon_range=(40, L + 1), seed=SEED, contacts=False)
    tree_s = time.monotonic() - t0
    write_protocol_samples(root, np.random.default_rng(SEED))
    log(f"protocol: {H3D_TEST} test motions written in {tree_s:.1f} s, {H3D_GEN} generated and "
        f"{MM_PROMPTS} k-sample files of ({MM_K}, {L}, {D}) by the evaluator in "
        f"{time.monotonic() - t0 - tree_s:.1f} s")
    gen = root / "gen" / "humanml"
    reset(counters)
    _, first, _ = run_offline(gen, root / "data", assets, "wo_mm", "protocol run 1")
    _, second, _ = run_offline(gen, root / "data", assets, "wo_mm", "protocol run 2")
    log(f"protocol: the two wo_mm metrics files byte-identical={first == second}")
    if first != second:
        raise AssertionError("protocol: two wo_mm runs wrote different metrics")
    _, raw, _ = run_offline(gen, root / "data", assets, "mm_short", "protocol",
                            ("--mm_results_dir", str(root / "mm" / "humanml")))
    if not json.loads(raw)["MultiModality"]["vald"][0] > 0:
        raise AssertionError("protocol: mm_short gave no MultiModality")
    check_no_launches("protocol", counters)


def phase_scene_humanml(seen: dict, out: Path, counters: dict, assets: dict) -> None:
    """The scene slice's evaluator once more over the same samples, with
    ``Rprecison`` and ``fid`` added to its metrics: the "ours" evaluator
    against the synthetic ``HumanML3D/contact_motion`` set beside the scene
    tree, pools of 32. The H3D+ metrics must be finite; their part of the
    run launches no port kernel."""
    from afford_motion_torch.eval import create_evaluator
    from afford_motion_torch.utils.config import DictConfig

    cfg = seen["args"][0].to_dict()
    cfg["evaluator"].update(
        eval_metrics=list(cfg["evaluator"]["eval_metrics"]) + ["Rprecison", "fid"],
        eval_meta_dir=str(assets["meta"]), t2m_ckpt_path=str(assets["ours"]), eval_batch_size=B)
    ev = create_evaluator(DictConfig(cfg), *seen["args"][1:], **seen["kwargs"])
    inner, h3d = ev.eval_humanml, {}

    def counted(*args, **kwargs):
        reset(counters)
        inner(*args, **kwargs)
        h3d.update({k: fn.launches for k, fn in counters.items()})

    ev.eval_humanml = counted
    again = out / "evaluated_h3d"
    again.mkdir()
    t0 = time.monotonic()
    ev.evaluate(*seen["samples"], str(again), seen["dataloader"])
    ev.report(str(again))
    metrics = json.loads((again / "metrics.json").read_text())
    keys = ("H3D+Matching Score_vald", "H3D+R_precision_vald", "H3D+FID_vald")
    log(f"scene humanml: evaluator with Rprecison and fid in {time.monotonic() - t0:.1f} s, "
        f"humanml_s {ev.timing['humanml_s']:.3f}; "
        + "; ".join(f"{k} {metrics.get(k)}" for k in sorted(metrics) if k.startswith("H3D+"))
        + f"; launches in eval_humanml {h3d}")
    if not all(k in metrics and np.isfinite(np.asarray(metrics[k], dtype=np.float64)).all()
               for k in keys) or any(h3d.values()):
        raise AssertionError(f"scene humanml: metrics {metrics}, launches {h3d}")


def launch_counters() -> dict:
    """Each kernels-line row's wrapper, whose ``launches`` it reads. One
    wrapper call launches one backward kernel for dq, dk and dv: the bf16
    instance's count stands in both bf16 rows, the f32 instance's in its
    own."""
    from afford_motion_torch.ops.cuda import banded
    from afford_motion_torch.ops.cuda.attention import attention_cuda, backward_bf16, backward_f32
    from afford_motion_torch.ops.cuda.fps import fps_cuda
    from afford_motion_torch.ops.cuda.gather import gather_rows, scatter_add_rows
    from afford_motion_torch.ops.cuda.knn import knn_cuda
    from afford_motion_torch.ops.cuda.sdf import nn1_cuda

    return {"fps": fps_cuda, "knn": knn_cuda, "gather": gather_rows,
            "scatter": scatter_add_rows, "banded_knn": banded.knn_banded,
            "banded_gather": banded.gather_banded, "banded_scatter": banded.scatter_banded,
            "nn1": nn1_cuda, "attention": attention_cuda,
            "attention_bwd_dkv": backward_bf16, "attention_bwd_dq": backward_bf16,
            "attention_bwd_f32": backward_f32}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    from afford_motion_torch.ops.cuda import build

    os.chdir(ROOT)  # the entries read ./configs, as the root train.py and test.py do
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    log(card)
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    t0 = time.monotonic()
    lib_path = build.build()
    build.library()
    log(f"build: {lib_path.name} in {time.monotonic() - t0:.1f} s")
    for name, usage in kernel_usage(lib_path.with_suffix(".log").read_text()).items():
        log(f"  ptxas: {name}: {usage}")
    log(f"  SASS of the bf16 attention kernels: {tensor_core_ops(lib_path)}")

    rep = phase_kernels(dev)
    phase_kernels_banded(dev, rep)
    phase_kernels_scene(dev, rep)
    phase_kernels_attention_bwd(dev, rep)
    phase_kernels_trans_dec(dev, rep)
    phase_kernels_cdm_scene(dev, rep)
    phase_autograd(dev)
    phase_reference(dev)
    phase_reference_scene(dev)
    phase_reference_trans_dec(dev)
    phase_reference_cdm_scene(dev)
    counters = launch_counters()
    phase_flash_grads(dev, counters)
    tree = make_tree()
    assets = make_eval_assets()
    phase_t2m_evaluator(dev, counters, assets)
    ddim = ["diffusion.timestep_respacing=ddim50", "task.test.sampler=ddim"]
    phases = [
        phase_train(tree, counters, PLAIN_STEP),
        phase_slice(tree, counters, {"ddim50": (ddim, PLAIN_STEP),
                                     "ddpm1000": (["task.test.sampler=ddpm"], PLAIN_STEP)}),
    ]
    # training through the fused attention: dropout 0 and the switch on
    # route every layer's attention, forward and backward, to the kernels;
    # in float32 (the reference-parity dtype of configs/model/cmdm.yaml)
    # through the f32 forward and backward
    with flash_switch("1"):
        phases.append(phase_train(dict(tree, exp=WORK / "exp_flash"), counters, FLASH_STEP,
                                  ("model.dropout=0",), tag="flash "))
        phases.append(phase_train(dict(tree, exp=WORK / "exp_flash_f32"), counters,
                                  FLASH_F32_STEP, ("model.dropout=0", "model.dtype=float32"),
                                  tag="flash f32 "))
    # CMDM trans_dec: 8 + 4 steps on the plain tree, its chains from that
    # checkpoint (DDIM-50 on both attention routes, DDPM-1000 on the fused
    # one), and 8 + 4 steps through the fused attention (dropout 0)
    dec_tree = dict(tree, exp=WORK / "exp_dec")
    phases.append(phase_train(dec_tree, counters, DEC_PLAIN_STEP, DEC_ARCH, tag="trans_dec "))
    phases.append(phase_slice(dec_tree, counters, {
        "trans_dec ddim50": ([*DEC_ARCH, *ddim], DEC_PLAIN_STEP)}))
    with flash_switch("1"):
        phases.append(phase_slice(dec_tree, counters, {
            "trans_dec ddim50 fused": ([*DEC_ARCH, *ddim],
                                       dict(DEC_PLAIN_STEP, attention=50 * DEC_ATTENTION)),
            "trans_dec ddpm1000 fused": ([*DEC_ARCH, "task.test.sampler=ddpm"],
                                         dict(DEC_PLAIN_STEP, attention=1000 * DEC_ATTENTION))}))
        phases.append(phase_train(dict(tree, exp=WORK / "exp_dec_flash"), counters,
                                  DEC_FLASH_STEP, (*DEC_ARCH, "model.dropout=0"),
                                  tag="trans_dec flash "))
    banded_tree = make_banded_tree(tree)
    phases += [
        # the flagship configuration's default on a prepared tree: the store
        phase_train(banded_tree, counters, STORE_STEP, tag="banded store "),
        phase_train(dict(banded_tree, exp=WORK / "exp_banded_host"), counters, BANDED_STEP,
                    ("task.train.device_store=off",), tag="banded host "),
    ]
    phase_store_megabatch(banded_tree, dev)
    # trans_dec through the device store: the upload caches the up kNN too
    phases.append(phase_train(dict(banded_tree, exp=WORK / "exp_dec_store"), counters,
                              DEC_STORE_STEP, DEC_ARCH, tag="trans_dec store ", store=True,
                              upload_knn=DEC_BANDED_KNN))
    # stage 1, the CDM-Perceiver as published: 8 + 4 steps on each data
    # route (the plain tree through the host stream, the prepared tree
    # through the stage-1 store), none of the port's kernels launched; then
    # the text -> contact -> motion chain through pred_contact files
    s1_tree = dict(tree, exp=WORK / "exp_stage1")
    s1_banded = dict(banded_tree, exp=WORK / "exp_stage1_store")
    phases += [
        phase_train(s1_tree, counters, STAGE1_STEP, tag="stage-1 ",
                    args=stage1_args(s1_tree, s1_tree["exp"]), store=False),
        phase_train(s1_banded, counters, STAGE1_STEP, tag="stage-1 store ",
                    args=stage1_args(s1_banded, s1_banded["exp"]), store=True),
    ]
    # the MotionX route: prepare a HUMANISE tree, train stage 2 and stage 1
    # through their stores (and stage 2 on the host route), then sample.py
    phases += phase_motionx(dev, counters)
    # the raw-data chain from a raw HUMANISE release to training steps, and
    # the point backbones' norm=layer
    phases += phase_raw_chain(dev, counters)
    phases += phase_norm_layer(dev, counters)
    # the CDM with its frozen scene model and the point-transformer backbones
    phases += phase_cdm_scene(counters, banded_tree)
    t2m_launches, t2m_out = phase_t2m_chain(tree, counters, s1_tree["exp"])
    phases.append(t2m_launches)
    phase_t2m_scored(tree, t2m_out, counters, assets)
    phases += [
        # the cached FPS indices serve the chain; with the cache off the chain
        # runs FPS and the sort itself
        phase_slice(banded_tree, counters, {
            "banded ddim50": (ddim + ["model.use_banded=true"], BANDED_STEP),
            "banded ddim50, no geometry cache": (
                ddim + ["model.use_banded=true", "task.dataset.use_geometry_cache=false"],
                dict(BANDED_STEP, fps=3))}),
        phase_scene_slice(dev, counters, assets),
    ]
    phase_protocol(counters, assets)
    launches = {k: sum(phase[k] for phase in phases) for k in counters}

    kernels = []
    for name in REPLACES:
        b_ms, by = bound_ms(rep.bytes_ms[name], rep.ops_ms[name])
        kernels.append({
            "name": name, "route": "cuda", "source": REPLACES[name][0],
            "replaces": REPLACES[name][1], "launches": launches[name],
            "max_abs_err": rep.err[name], "ms": rep.ms[name], "plain_ms": rep.plain_ms[name],
            "bound_ms": b_ms, "bound_by": by, "library_ms": rep.library_ms[name],
            "yardstick_ms": rep.yardstick_ms[name], "note": NOTES.get(name),
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
