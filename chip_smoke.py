#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``shapy_tpu_torch``) on one NVIDIA
GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1):

1. Prints the card's name and power limit, and builds the thirteen
   hand-written CUDA sources from ``shapy_tpu_torch/csrc/``, one nvcc
   process each, all started together: K1 measure (reference and exact
   slice modes, forward and backward, and K1-AoS's ``measure_points``
   and ``measure_points_backward``), K2 ingest, K3 skinning forward and
   backward, K3-chain forward and backward, K4 train-mode BatchNorm
   forward and backward, K5-conv (the backbone's convolutions with their
   epilogue) with K5-dgrad and K5-wgrad (their data and weight
   gradients), K5-fuse (HRNet's multi-resolution fusion) and its
   backward, K10 (the ResNet's 7x7 stem, in ``conv.cu``) and K11 (its
   max pool, forward and backward), K6 mesh-mesh
   intersection, K7 repulsion forward and backward, K8a P2P point error,
   K8b aligned point error, K9 nearest-neighbour distances; prints each
   kernel's registers and stack (the wgmma kernels' and K4's backward
   kernels' each, with the wgmma kernels' dynamic shared memory).
2. Holds each kernel against its plain PyTorch version on the card at the
   main paths' shapes (batch 32, SMPL-X 10475 vertices / 20908 faces,
   K=256 hull directions, 480x360 uint8 images -> 256x256 crops, a
   P2P regressor of 20000 points x 3 vertices, alignments over 10475
   vertices; K2 bit-equal for uint8 and f32 images and f32 and bf16
   crops on the served requests at batch 32 and 128 and on extreme
   affines (magnification 4, a 90 degree rotation, a crop wholly outside:
   tiles in both regimes of ``ingest_plan``), its bound from the source
   pixels that the corners read; K3 skinning's forward at batch 32 and 48
   and its backward at 48, each also bit-equal across two calls, for a
   body alone and to its order replay; K3-chain forward and backward at
   batch 32 and 48 on the flagship's tree (55 joints in 6 levels), the
   published SMPL-X tree (11 levels) and a 64-joint path, against the
   plain version in f64 and f32 and bit-equal to its replays, across two
   calls and for a body alone; for training batch 48:
   K4 on the stem's first BN and a stage-4 BN in bf16 and
   f32, its backward also forced into each of its two regimes (one
   cluster launch; partials, finalize and dx); K1's forward (a
   thread-block cluster per body and plane, sized by ``measure_plan``)
   on the subsets and all faces at batch 32 and K1's and K1-exact's on
   all faces at batch 48 and 1, the hits and codes it saves equal to the
   plain slice's in face order and two calls bit-equal
   (``check_saved_hits``); K1's backward and
   K1-exact forward and backward on all faces at
   batch 48 and batch 1; the backwards first against autograd through
   the plain versions in f64; K6, K7 and K9 at phase 9's shapes: K6 on a
   full-width body pair and the four pairs with 256 slots and on the
   plane route (phase 9's quads, 1024 slots), and on planted cases (more
   hits than slots, hit lists forced to overflow into the index-order
   sweep, a target repeated, degenerate triangles), ids equal and
   barycentrics bit-equal to the plain version and to its replay
   (``mesh_mesh_intersection_replay``), two calls bit-equal, its Morton
   order and overflow count the replay's, the culled tests a query as
   the kernel's counting build counts them (equal to the replay's) and
   the prologue's share of the time; K7 on the four pairs' contacts, value
   rel 1e-5 and gradient within 1e-4 of the largest of autograd in f64,
   two calls bit-equal, one device kernel a forward and two a backward,
   all ``repulsion.cu``'s (checked trace), the loss bit-equal to
   ``repulsion_forward_replay`` and the gradient to
   ``repulsion_backward_replay``, the per-pair penalties and live bytes
   the plain version's, on those inputs and planted cases (a face in 48
   entries, batch 1, C = 300, padded rows, C = 0, a pair on a cone's
   axis whose plain gradient is NaN, ``penalize_outside=False``);
   K9 both ways between two bodies' vertices and between clouds with
   duplicate and equidistant points planted, through ``nn_dists_both``
   and ``_nn_dists``, bit-equal to the plain version, its neighbours the
   replay's, and its floor in issue slots computed and printed beside
   its bound) and times both with CUDA
   events (K6's plain version over 2 calls: it takes ~0.5 s), K4 beside
   ``F.batch_norm(training=True)`` and K9 beside ``torch.cdist`` + ``min``
   (two calls a direction); computes each kernel's bound (bytes or FLOPs
   of this run's inputs at 3.35 TB/s / 67 TFLOP/s). K1-AoS at the
   scorer's shapes (SMPL-X triangles of batch 32, all faces, both slice
   modes) against the plain AoS version: circumferences 1e-5 m, mass and
   height rel 1e-5, masks equal, points bit-equal (reference) or within
   1e-6 m (exact), height points exact, values bit-equal to K1 from the
   vertices, the backward as K1's; ``measure_points`` on the forward's
   saves bit-equal to ``measure_points_replay``, to the parent kernel's
   fill-and-scatter layout and to a second call, one device kernel a
   call, timed alone (its own bound: the points and masks written once)
   beside the walk (K1 alone on the triangles).
   ``measure_points_backward`` in both modes against autograd through
   the plain AoS slice in f64 at the forward's plane heights, within
   1e-5 of the largest gradient; on the saves, the gradient and the plane
   heights' cotangent bit-equal to ``measure_points_backward_replay`` and
   to a second call, at most two device kernels a call (its exact-mode
   bound counts only the cotangent's sectors under the hits). Both again
   at an odd F, at F % 8 = 6, at batch 1, with a body that no plane cuts
   and with the waist left out (a plane that walks no faces).
   K5-conv at all 33 conv shapes of the W48 forward, with the served
   weights and each shape's epilogue: batch 32 in bf16 within one bf16
   step of the plain value at each rounding of the epilogue plus the
   worst-case gap of two f32 sums in other orders, against the plain
   version and against the plain epilogue on the exact (f64) sum (the
   differing elements counted), batch 2 in f32 within 1e-5 of the
   largest |y|; each shape timed beside cuDNN's ``F.conv2d`` (its
   library time) and its bound (FLOPs at 989 TFLOP/s bf16, bytes at
   3.35 TB/s), with its plan (the wgmma kernel's N tile, K step, box, K
   partitions and tiles, or the stem's kernel); a profiled served
   forward runs one ``conv_bf16_kernel`` (the stem's), 330
   ``conv_wgmma_kernel`` and a reduce per K-partitioned conv, and no
   cuDNN kernel. K5-fuse bit-equal at every target of a stage-4 module
   (bf16 batch 32, f32 batch 2), timed. The whole bf16 backbone at batch
   32, the K5 route against the plain route (cuDNN + eager ops): both
   times, the features' cosine (>= 0.999) and relative L2 (<= 0.05).
   K5-dgrad and K5-wgrad at all 33 conv shapes with one train step's
   recorded inputs, weights and cotangents (batch 48, bf16; dgrad at the
   32 shapes whose input needs a gradient): within one bf16 step plus 2 K
   2^-24 sum|terms| of the plain versions (cuDNN's gradients), two calls
   bit-equal, and at batch 2 in f32 within 1e-5 of the largest |value|
   (dbias 1e-5 sum|dy|), and K5-wgrad in f32 at batch 48 against the
   exact sum (half an f32 step + 2 sqrt(K) 2^-24 sum|terms|; its order
   gap to the plain f32 sum printed); each shape timed beside cuDNN's
   ``aten.convolution_backward`` and its bound; the step's 330 data and
   331 weight gradients replayed each through the kernel, the plain
   version and cuDNN, and its 331 forward convs through K5-conv and
   cuDNN. K4's backward at the step's 326 recorded BNs: each within its
   limits of the plain version and two calls bit-equal, replayed through
   K4, the plain version and ``F.batch_norm``'s autograd backward (the
   entry's times). Every replay is timed as device time (the durations
   of its kernels in a ``torch.profiler`` trace), its CUDA-event window
   printed beside: a replay of hundreds of calls outruns CUDA's launch
   queue, and the window then times the host. K5-fuse's backward
   at the step's 26
   targets: within one bf16 step (f32 bit-equal), each shift-0 gradient
   equal to dx, replayed and timed beside its bound's bytes. The
   whole backbone's train-mode forward and backward at batch 48, the K5
   route against the plain route: in f32 (TF32 off) per module group a
   gradient cosine >= 0.999 and relative L2 <= 0.05; in bf16 both times,
   and each route against the f32 one (K5's relative L2 within 1.05x the
   plain route's: either bf16 gradient is mostly amplified rounding noise
   with these random weights).
3. Serves the flagship (HRNet-W48 at full width, 3-stage head with MLP
   (1024, 1024), SMPL-X, measurements; bf16 backbone) through
   ``apply_from_full_images``: one warm-up, then 3 requests of batch 32.
   Weights are random from a seed. Checks that every output is finite,
   that betas vary per image inside the candidate-face bound, that K1,
   K2 and K3 were launched by this run, and that every backbone forward
   made exactly 331 K5-conv and 26 K5-fuse launches.
4. Cross-device parity: the same weights at batch 2 with an f32 backbone
   and TF32 off, the CPU port (plain versions) against the CUDA port
   (kernels): outputs, and the evaluator's metrics on them; then one train
   step (dropout 0) with the height, chest, waist and hips losses at
   weight 1.0 (GT measurements from K1 on the GT bodies): losses, each
   module's gradient norm and cosine, the head's gradients elementwise,
   and the updated parameters; the CUDA step runs the f32 K5 kernels
   (331 K5-conv, 330 K5-dgrad, 331 K5-wgrad, 26 + 26 K5-fuse launches).
5. Evaluates the flagship of phase 3 at batch 32: 3 batches of synthetic
   ground truth (shaped and posed SMPL-X bodies from seeded betas and
   poses, GT measurements from K1 on all faces, genders and BMI buckets,
   a P2P regressor of 20000 barycentric points, a (14, V) J14 regressor)
   through ``eval.loop.make_eval_fn`` -> ``Evaluator.run`` with the
   reference's alignment sets. Checks finite metrics and group means,
   that K1, K2, K3, K8a and K8b were each launched by this run, and that
   each batch's metrics equal those of the kernels' plain versions on
   the card, and 331 K5-conv and 26 K5-fuse launches per forward; prints
   images/s of forward + metrics.
6. Scores a synthetic HBW submission of 64 fitted bodies against their GT
   with ``cli.evaluate_hbw.evaluate_submission`` (K8b V2V, K8a P2P,
   K1-AoS on all faces of both meshes' triangles); checks the launches,
   finite errors and the plain versions' numbers (``measure_points`` once
   a batch for the fits and once for the GT: 4); differentiates the
   fitted bodies' circumferences and slice points in their vertices (one
   ``measure_points_backward`` launch per batch). Then runs the scorer's
   ``main`` on a release tree written to a temporary directory (the GT as
   HBW npy files, a faces npz, synthetic SMPL-X and SMPL release files at
   the real counts): the ``--faces-path`` route (SMPL-X, anchors from the
   repository's YAMLs) and the model-folder route (SMPL fits on the SMPL
   model's faces); each run's printed lines must equal those formatted
   from the plain versions' numbers on the card.
7. Trains the flagship at full width (bf16 backbone, dropout 0.5, the
   losses and the Adam optimizer of ``configs/train_shapy.yaml`` that need
   no files) with ``Trainer.fit``: 2 warm-up steps, then 10 steps on one
   fixed synthetic batch of 48. Checks finite losses and a last total
   below the first, that every BN running stat moved and ``param_mean``
   did not, that K1, K3 and K3-chain (forward and backward) and K4
   (forward and backward) were launched by these 10 steps, and that each
   step made exactly 331 K5-conv, 330 K5-dgrad, 331 K5-wgrad, 26 K5-fuse
   and 26 K5-fuse backward launches; one more step with ``F.conv2d`` made
   to raise, under ``torch.profiler``, shows no convolution operator
   (forward or ``aten.convolution_backward``) in training; prints
   steps/s, images/s and the peak device memory beside the card.
8. Fits shape to measurements with ``fit_betas_to_measurements`` on the
   full-width SMPL-X, in both slice modes: batch 1 from zero betas and
   batch 32 from seeded betas (0.5 sigma), 200 Adam steps at lr 0.05 (the
   example's) and a shape prior of 1e-5
   toward the height, chest, waist and hips of a seeded betas vector.
   Checks every fit within 1 cm of its targets, that K1 (or K1-exact)
   forward and backward launched once per step, and the first 20 steps
   against the same fit through the plain versions on the card; prints
   steps/s. Then runs ``cli.virtual_measurements.main(..., render=False)``
   over 8 seeded betas files and checks its lines against the plain
   version's measurements.
9. Contact and distance at full width on four body pairs (A: seeded
   betas and pose; B: other betas, A's pose, shifted a few cm): K6 with
   A's triangles as queries against B's (256 slots; at least 1000
   collisions per pair; pair 0 equal to phase 2's plain run; each kept
   endpoint, rebuilt from its barycentrics, on both triangles' planes
   within 1e-5 m, except in target triangles under the JAX package's
   barycentric clamp, which are held to the target's plane), K6 with
   the chest, waist and hips quads at K1's plane heights as queries
   (1024 slots; the faces found equal the exact slice's crossed faces),
   K7 on the contacts as (receiver, intruder) pairs (positive, finite,
   value and gradient against the plain versions; prints the pairs that
   are not live, which the backward skipped), and ``point_fscore``
   at 5, 10 and 20 mm between the bodies' vertices and between their
   P2P-20k clouds (distances within 1e-5 m of the plain version's, and
   scores equal wherever no point's two distances fall on either side of
   the threshold). Checks that K6, K7 forward and backward and K9 were
   launched by this phase, K9 once an F-score (both directions), and
   prints their counts and K6's overflowed queries.
10. Kill and resume on the card: 4 ``Trainer.fit`` steps of batch 48
   against 2 steps, a checkpoint in a temporary directory, a new
   ``Trainer`` that resumes from it and 2 more steps: parameters, BN
   running stats, ``param_mean``, Adam's moments and the step bit-equal.
11. The ResNet family (``build_flagship(backbone="resnet50")``, then
   ``"resnet18"``; every BN folded in eval): K5-conv at each conv shape
   of ResNet-50 and ResNet-18 that HRNet-W48 lacks (15 and 6, the 1x1
   stride-2 downsamples among them) and K10 (the 7x7 stem, through the
   same per-shape check: bf16 within K5's limit, f32 1e-5, timed beside
   cuDNN with bias) on a served forward's weights at batch 32; the served
   forward profiled (one ``stem7_kernel`` for K10, 52
   ``conv_wgmma_kernel`` + reduces, one K11 ``max_pool_forward_kernel``,
   no cuDNN convolution or ATen pooling kernel) and against the plain
   route (cosine >= 0.999, relative L2 <= 0.05); ResNet-50 served at
   batch 32 and 128 (exactly 52 K5-conv, 1 K10, 1 K11 launch a forward;
   images/s, and a request's device busy time and idle share from
   ``device_time``) and evaluated at batch 32 (metrics equal to the
   plain versions'); K11 against its plain versions (forward bit-equal in
   bf16 and f32 on the served stem output; backward on a train step's
   recorded cotangent at batch 48, f32 bit-equal, bf16 within one bf16
   step; windows planted all-zero and tied); a train step's K5-dgrad,
   K5-wgrad and K10 weight gradient at each new shape, as phase 2's
   (K10's against the exact sum, K5-wgrad's limit), and K4's forward and
   backward at each of its 53 / 20 BNs in the regime its plan picks, with
   phase 2's limits; then ``Trainer.fit``
   at batch 48, 1 warm-up and 4 timed steps, for ResNet-50 and ResNet-18:
   52 / 19 K5-conv, K5-dgrad and K5-wgrad launches a step, one K10
   forward and weight gradient, one K11 forward and backward, 53 / 20
   K4 forwards and backwards, a falling loss, no library convolution or
   pooling operator, steps/s and peak memory.
12. The evaluation CLI end to end: ``cli.evaluate.main`` with
   ``configs/shapy_eval_shape.yaml`` (read by the port's config loader;
   the data folder, batch 32, the reference's v2v_t alignments and a P2P
   regressor pickle of 20000 points given as dot-list overrides) on a
   synthetic HBW tree written to a temporary directory (8 subjects x 8
   480x360 PPM images, OpenPose JSONs, ``genders.yaml``, GT OBJ meshes of
   seeded betas at 10475 vertices). The regressor is the flagship's
   (``build_body_head`` on ``flagship.build_flagship_body``'s body in
   place of the demo builder's, then phase 3's ``spread_init_``; bf16
   backbone, BN folded), the registry's HBW dataset gets its measurement
   module, so the GT measurements run K1-AoS once. The CLI runs twice,
   cold (GT measurements computed and cached) and warm (a copy of the
   same regressor, GT from the cache). Checks rc 0, finite printed
   metrics, the same lines from both runs, the launches of each run (per
   batch 331 K5-conv, 26 K5-fuse and one K1, K2, K3, K3-chain, K8a and
   K8b; in the cold run K1 and K1-AoS's points once more for the GT;
   nothing else), and both runs' predictions bit-equal to the same padded
   batches through ``apply_from_full_images``; K2 on a padded batch of
   four sizes (odd widths among them) bit-equal to each image alone;
   prints the metrics, the images/s of the warm run's batches after the
   first on the host clock beside phase 5's, the host's share of their
   wall (1 - the device busy time of a batch's forward and metrics, from
   ``device_time``, times the batches, over their wall), and each run's
   batches one by one (the first waits for its whole decode).

13. Training through the CLI: ``cli.train.main`` with
   ``configs/train_shapy.yaml`` (read by the port's config loader; the
   synthetic archives' folders and names given as dot-list overrides) at
   its full width: HRNet-W48 in bf16, batch 48 (24 pose + 24 shape),
   256^2 crops, dropout 0.5, its augmentations (flip, scale, rotation
   and channel noise) on uint8 full images that K2 crops on the card with
   the drawn noise factors. The data: synthetic archives written to a
   temporary directory by the port's generator (``data/synthetic.py``, the
   rasterizer's native route) on phase 7's body at 320x320: two pose
   archives, one shape archive and a val archive with vertices; the
   regressor is ``build_body_head`` on that body, weights from its seed.
   Three runs: (1) 8 steps with ``use_adv_training`` (LSGAN) and
   ``eval_steps`` 4; (2) 4 steps, then a fresh ``main`` that resumes from
   the checkpoint and takes 4 more, whose checkpoint must equal run 1's
   bit for bit (every parameter, BN stat, Adam moment, schedule and the
   discriminator's weights, ``u`` buffers and moments), its resumed leg
   under a ``torch.profiler`` trace of the host's operators; (3) 8 steps
   with ``losses.discriminator.type: wgan-gp`` and no checkpoint, under a
   trace of the device's kernels. ``F.conv2d`` and ``F.max_pool2d`` raise
   throughout, and the resumed leg's trace may show no convolution
   operator. Checks rc 0, finite losses and eval rows, and a
   train step's launches (the eval hook's counted apart): one K2 with the
   noise factor and none without, and phase 7's K5, K4, K3 and K3-chain
   counts; K2 with the factor bit-equal to its plain version on a recorded
   train batch and on phase 2's extreme affines, and without it on the
   same batch (the plain version without factors is the parent's, so the
   kernel's served path did not move). Prints steps/s on the host clock
   (the median span from one step's start to the next, the spans with an
   eval call or a checkpoint write left out), the device's busy share of
   run 3's traced fit and the peak memory, and times K2's noise variant at
   batch 48.
14. The demo CLI end to end: ``cli.demo.main`` with
   ``configs/shapy_demo.yaml`` (HRNet-W48 at 256^2 crops, 3 stages, bf16
   backbone with BN folded) over a synthetic OpenPose folder (8 480x360
   PPM images with OpenPose JSONs, as phase 12's). The demo's own builder
   runs, on the flagship's synthetic SMPL-X (10475 vertices:
   ``SHAPY_TPU_SYNTHETIC_BODY=1`` with ``exact_counts``; its measurements
   without candidate subsets, as the JAX demo's, so K1 walks all faces),
   its weights through ``pretrained``: a reference-layout checkpoint
   (``{'model': state_dict}``: ``backbone.*`` with
   ``num_batches_tracked``, ``regressor.module.*``,
   ``regressor.mean_param``, body constants under ``model.*``) of that
   builder's regressor with seeded weights, imported by
   ``io.model_import.load_reference_model_checkpoint`` into a regressor of
   other weights. ``main`` runs at batch 4 and at 1 with ``save_vis``,
   ``save_params`` and ``save_mesh`` on, and once more at batch 4 under a
   trace of the host's operators; ``F.conv2d`` and ``F.max_pool2d`` raise
   throughout. Checks rc 0 and every file the JAX demo names (``{img}.npz``,
   ``{img}.ply``, ``{img}_hd_imgs.png``, ``{img}_hd_stage_02_overlay.png``
   (RGBA) and ``_cat.png``), each run's launches (per batch 331 K5-conv, 26
   K5-fuse and one K1, K2, K3 and K3-chain, nothing else), no convolution
   or pooling operator in the trace, each forward bit-equal to the seeded
   regressor loaded directly on the same padded images, every kernel of
   the forward against its plain version at batch 4 and at 1 on the
   inputs the forward gave it (K5-conv's plans follow the batch; K2 and
   K5-fuse bit-equal, each K5-conv call within phase 2's limit, the
   backbone against the plain route as phase 2's, K3-chain and K3 1e-5,
   K1 as phase 2's), the npz vertices and measurements equal to the
   forward's, and batch 1
   against batch 4 (features cosine >= 0.999 and rel L2 <= 0.05, the limit
   between two bf16 backbones whose sums round otherwise; vertices within
   1 cm). Then ``Evaluator.run`` on phase 5's batches with a recording
   writer and ``render_summaries`` on: the image grids (mesh overlays, GT
   meshes, estimated keypoints) and every mean as a scalar arrive, the BMI
   histogram route is printed, and the launches are phase 5's with one
   more K2 (the summary's crops in f32). Then
   ``cli.virtual_measurements.main`` with ``render=False`` (its caption
   needs ``cv2``, which a card's machine may lack) on the demo's npz files:
   its printed values within half a printed unit + 1e-4 of the npz's
   measurements. Prints which of matplotlib, tensorboard and cv2 are
   installed, the demo's images/s at batch 4 and 1 on the host clock and
   the host seconds a batch spent writing and rendering.
15. The attribute models and their plugins. ``cli.fit_regression.main``
   with ``--train`` and then without on the synthetic database, for
   ``configs/s2a.yaml`` (B2A) and ``configs/a2s_variations/02b_ahw2s.yaml``
   (A2B, whw2s and BodyTalk), both genders: every printed number finite,
   the four polynomials written as reference Lightning checkpoints, the
   card's predictions within 1e-5 (relative to the largest) of a CPU
   copy's. ``cli.attributes_demo.main``: S2A on a folder of betas npz
   files with a genders YAML (the printed ratings those of the module),
   A2S on a ratings database written as a plain pickle with rendering
   (the printed betas within 1e-5 of the module's, a 512x512 PNG a
   model). ``A2B.fit_nn`` (an MLP from the ratings alone, 00_a2s) on the flagship's
   SMPL-X with v2v and the four measurement losses, 50 steps at batch 256:
   one K1 forward and one K1 backward a step and nothing else, two K1
   forwards in its validation, the loss falling, and K1's forward and
   backward at the first step's 512 bodies within phase 2's limits of
   their plain versions. The evaluation CLI on phase 12's HBW tree and
   regressor without plugins, with B2A and A2B (``--exp-opts`` with the
   four checkpoints) and without again: the printed metrics bit-equal,
   the plugin run's launches the warm run's, its ``attributes``,
   ``betas_ref`` and ``v_shaped_ref`` present and the first two within
   1e-5 of CPU copies of the plugins on the same betas and K1 height and
   mass. ``cli.train.main`` with ``use_b2a`` on phase 13's pose archives
   and a synthetic model-agency archive (the config's shape stream, with
   attribute ratings), 4 steps: an ``attributes`` loss finite and not
   zero, the B2A weights bit-unchanged, every kernel's launches a step
   phase 13's.

The line before the last is a JSON object with one entry per kernel
function (forward and backward separately); ``launches`` counts the
training phase for the kernels it runs (K5 among them), the batch-32 fit
of phase 8 for K1's backward and K1-exact, phase 9 for K6, K7 and K9,
the scorer (phase 6) for K1-AoS's points and their backward, ResNet-50's
training (phase 11) for K10 and K11, and the evaluation phase for the
others, and phase 13's run 1 for K2's noise variant; ``launches_cli``
counts phase 12's cold run, ``launches_train_cli`` phase 13's run 1 (its
train steps, the eval hook's launches left out), ``launches_demo`` phase
14's run at batch 4, ``launches_attributes`` all of phase 15's runs. K5-conv's and K5-fuse's times are a served forward's at batch 32,
the backward kernels' and K4's backward's a train step's at batch 48;
K10's and K11's forwards at the served batch 32, their backwards at 48.
The last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without
the repository beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

B = 32
IMAGE_H, IMAGE_W = 360, 480
CROP = 256
SEED = 0
BETA_BOUND = 8.0  # candidate_faces' bound: the subsets are exact inside it
EVAL_BATCHES = 3
P2P_POINTS = 20000
SUBMISSION = 64
TRAIN_B = 48  # train_shapy.yaml's batch
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
MEASURED = ("height", "chest", "waist", "hips")
PLANE_NAMES = ("chest", "waist", "hips")
# Phase 8: the example's steps and learning rate; the shape prior of the
# JAX package's convergence check (the example's 1e-3 holds the fit ~1.3
# cm off its targets).
FIT_STEPS, FIT_LR, FIT_PRIOR = 200, 0.05, 1e-5
FIT_B = 32
FIT_TOL = 0.01  # m
FIT_PARITY_STEPS = 20
VM_FILES = 8
# Phase 9: body pairs A (seeded betas of 2 sigma and a pose of 0.2 rad per
# axis) and B (other betas, A's pose, shifted a few cm); these seeds give
# ~1200-1300 crossing triangle pairs each at full width.
CONTACT_SEEDS = (5, 6, 7, 8)
CONTACT_BETAS, CONTACT_POSE = 2.0, 0.2
CONTACT_SHIFT = (0.01, 0.005, 0.03)  # m
CONTACT_M = 256  # the reference's max_collisions
PLANE_M = 1024  # slots per plane triangle: no truncation
MIN_COLLISIONS = 1000
FSCORE_THRESH = (0.005, 0.01, 0.02)  # m
NN_TOL = 1e-5  # m: K9 vs plain, neighbours that tie within f32 rounding
# K5-wgrad in bf16 at batch 48: the share of dw's elements that may round
# otherwise than the exact sum. f32 sums in another order move only the
# sums near a rounding midpoint (at most 5.5% of a shape's elements on an
# H100); a lost row partition moves 91-100% of them (PERF.md).
WGRAD_MAX_DIFFERING = 0.25
# The bf16 train-mode backbone: how far below the plain route's cosine with
# the f32 gradient the K5 route's may fall in a module group. On an H100
# the two, both with K4's BN, differ by at most 0.005 per group, routes
# with cuDNN's BN by up to 0.034 (PERF.md); a noise gradient falls ~0.75
# at the head convs.
BF16_COSINE_MARGIN = 0.02
# The H100 SXM's published peaks (at its 700 W limit): HBM bytes/s and
# f32 FLOP/s outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
PEAK_BF16_FLOP_S = 989e12  # dense, tensor cores
# Kernel vs plain version on the card: per-sample mean errors in m (sums
# in another order), measurement errors exact (the same outputs).
METRIC_TOL = 1e-5
# Phase 12, the evaluation CLI: a synthetic HBW tree of 8 subjects x 8
# images (480x360 PPM), evaluated at batch 32 (two batches).
CLI_SUBJECTS, CLI_IMAGES, CLI_B = 8, 8, 32


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def ptxas_report(log: str, marker: str) -> list:
    """``nvcc -Xptxas -v``'s registers, stack and spills of each entry
    function whose name holds ``marker``, as "name: line | line"."""
    entries, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif "Function properties for" in ln:
            name = ln.split("for ")[-1].strip()
        elif name and marker in name and (
                "registers" in ln or "stack frame" in ln):
            entries.setdefault(name, []).append(
                ln.split("ptxas info    :")[-1].strip())
    try:  # readable template arguments where binutils is installed
        names = subprocess.run(["c++filt"], input="\n".join(entries),
                               capture_output=True, text=True,
                               check=True).stdout.split("\n")
    except (OSError, subprocess.CalledProcessError):
        names = list(entries)
    return [f"{shown}: {' | '.join(lines)}"
            for shown, lines in zip(names, entries.values())]


def wgmma_smem() -> str:
    """conv.cu's own account (``conv2d_wgmma_smem``) of the dynamic shared
    memory of K5-conv's and K5-dgrad's wgmma kernels by (N tile, K step)
    and K5-wgrad's by N tile, with the blocks an SM holds, for the
    backbone's shapes (K5-conv at batch 32 and 48). Fails where a plan
    (``_wgmma_pair``, by which K5-conv and K5-dgrad size their K
    partitions) disagrees with the kernel on the blocks an SM holds."""
    import ctypes

    from shapy_tpu_torch.models.backbones.layers import (
        CONV_KERNEL,
        _conv_plan,
        _dgrad_plan,
        _wgmma_n,
        _wgmma_pair,
    )

    smem = CONV_KERNEL.build().conv2d_wgmma_smem  # not a launch
    smem.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    out = (ctypes.c_int * 2)()
    conv, dgrad, wgrad = set(), set(), set()
    for cin, cout, k, stride, side in BACKBONE_SHAPES:
        if cin % 8 == 0:
            for n in (B, TRAIN_B):
                plan = _conv_plan(n, side, side, cin, cout, k, stride)
                conv.add((plan.bn, plan.bk))
            plan = _dgrad_plan(TRAIN_B, side, side, cin, cout, k, stride)
            dgrad.add((plan.bn, plan.bk))
            wgrad.add(_wgmma_n(cout))
    parts = []
    for kind, code, keys in (("K5-conv (N, K step)", 2, sorted(conv)),
                             ("K5-dgrad (N, K step)", 1, sorted(dgrad)),
                             ("K5-wgrad N", 0, sorted(wgrad))):
        shown = []
        for key in keys:
            bn, bk = key if isinstance(key, tuple) else (key, 0)
            smem(code, bn, bk, ctypes.addressof(out))
            if bk:
                check(out[1] == 1 + _wgmma_pair(bn, bk, code == 2),
                      f"{kind} {key}: {out[1]} blocks an SM in conv.cu, "
                      "not as the plan has it")
            shown.append(f"{key}: {out[0]} B x{out[1]}")
        parts.append(f"{kind}: " + ", ".join(shown))
    return "; ".join(parts)


def conv_plan_text(n: int, cin: int, cout: int, k: int, stride: int,
                   side: int) -> tuple:
    """K5-conv's plan for one shape as (dict, text): the wgmma kernel's N
    tile, K step, pixel box, K partitions and tiles (its grid is the
    smaller of the tiles and the blocks the card holds), or the stem's
    mma.sync kernel."""
    from shapy_tpu_torch.models.backbones.layers import (
        _conv_plan,
        _wgmma_pair,
    )

    if cin % 8:
        if k == 7:
            return {"kernel": "stem7_kernel"}, "K10's stem7_kernel"
        return {"kernel": "conv_bf16_kernel"}, "stem mma.sync kernel"
    plan = _conv_plan(n, side, side, cin, cout, k, stride)
    out = (side + 2 * (k // 2) - k) // stride + 1
    bni, bh, bw = plan.box
    tiles = (-(-n // bni) * -(-out // bh) * -(-out // bw)
             * -(-cout // plan.bn) * plan.parts)
    slots = 132 * (1 + _wgmma_pair(plan.bn, plan.bk, True))
    row = {"kernel": "conv_wgmma_kernel", "bn": plan.bn, "bk": plan.bk,
           "box": list(plan.box), "parts": plan.parts, "tiles": tiles,
           "grid_on_132_sms": min(tiles, slots)}
    return row, (f"wgmma N {plan.bn}, K step {plan.bk}, box {plan.box}, "
                 f"{plan.parts} K partition(s), {tiles} tiles, grid "
                 f"{min(tiles, slots)}")


def time_ms(fn, iters: int = 20, warmup: int = 3, windows: int = 3
            ) -> float:
    """Mean device time per call from CUDA events around ``iters`` calls,
    the least of ``windows`` such windows.

    The calls are queued behind a spin kernel that outlasts their host-side
    launching, so the events time the device work back to back and not the
    host's launch rate (a kernel of tens of microseconds launches slower
    than it runs). A host pause longer than the spin's margin leaves a gap
    in a window; the least window is the one without."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0  # bounds one call's launch time
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(windows):
        torch.cuda._sleep(int(2e9 * 1.5 * iters * host_s))  # <= 2 GHz
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


_PAD_NAMES = set()


def _device_trace(fn, passes: int, first: bool = True):
    """(ms, kernels by name, ms by name) of the CUDA kernels and copies
    that ``passes`` calls of ``fn`` run, from one ``torch.profiler``
    trace: the time at least one of them runs (the union of their spans: a
    kernel launched as a programmatic dependent, as K4's split forward
    launches its second and third passes, starts before the one it waits
    for ends), their count by name and their summed spans by name; None
    where the trace lost its marker.
    The trace starts and ends with 8 short spin kernels, left out of both:
    a trace can miss its first or last few events. A trace has also been
    seen to miss the first kernels of the first call in it, every time in
    one process, so something runs first and is left out too: one call
    of ``fn`` (with ``first``, for an ``fn`` that may run once more), else
    (for a train step, which must not step twice) 64 short spin kernels
    and a 50 ms pause of the host. The counted calls are those after a
    long spin kernel, the marker, launched once that lead has finished."""
    import torch

    def pad():
        for _ in range(8):
            torch.cuda._sleep(1000)

    if not _PAD_NAMES:  # the spin kernel's name, as the profiler gives it
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            pad()
            pad()
            torch.cuda.synchronize()
        _PAD_NAMES.update(e.key for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA)
        check(bool(_PAD_NAMES), "a trace of spin kernels held no kernel")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        pad()
        if first:
            fn()
        else:
            for _ in range(8):
                pad()
        torch.cuda.synchronize()
        if not first:
            time.sleep(0.05)
        torch.cuda._sleep(100_000)  # the marker: ~50 us, a pad ~0.5 us
        for _ in range(passes):
            fn()
        pad()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    marks = [e for e in events if e.name in _PAD_NAMES
             and e.time_range.end - e.time_range.start > 10.0]  # us
    if len(marks) != 1:
        return None
    after = marks[0].time_range.end
    events = [e for e in events if e.name not in _PAD_NAMES
              and e.time_range.start >= after]
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in events):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    spans = collections.Counter()
    for e in events:
        spans[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    return busy / 1e3, collections.Counter(e.name for e in events), spans


def device_time(fn, passes: int = 3, tries: int = 5,
                split: bool = False) -> tuple:
    """(ms, kernels) of one call of ``fn`` on the device: the time the
    CUDA kernels (and copies) it runs take on the device
    (:func:`_device_trace`), from a ``torch.profiler`` trace of ``passes``
    calls after a warm-up call, and how many it runs; with ``split`` also
    each kernel name's ms a call.
    Unlike :func:`time_ms`'s window it leaves out the host: a replay of
    hundreds of small calls queues more launches than CUDA's launch queue
    holds, and the window times the Python wrappers.

    A trace can drop events, so each is checked against a second trace of
    one call: the ``passes`` calls must hold each kernel name ``passes``
    times as often, and one call must run at least ``fn.calls`` kernels
    (:func:`replay` sets it: each call launches one or more). A pair that
    disagrees is printed and taken again after a second's pause (the
    tracer's lapses come in bursts: a run once lost every event of two
    pairs in a row), at most ``tries`` times; then the check fails."""
    import torch

    fn()
    torch.cuda.synchronize()
    least = getattr(fn, "calls", 1)
    seen = []
    for _ in range(tries):
        traces = _device_trace(fn, 1), _device_trace(fn, passes)
        if None in traces:
            seen.append((None, None))
            print("device trace lost its marker: taken again", flush=True)
            time.sleep(1.0)
            continue
        (_, one, _), (total, many, spans) = traces
        n = sum(one.values())
        want = collections.Counter({k: v * passes for k, v in one.items()})
        if n >= least and many == want:
            if split:
                return total / passes, n, {k: v / passes
                                           for k, v in spans.items()}
            return total / passes, n
        seen.append((n, sum(many.values())))
        print(f"device trace pair disagrees (one call {n} kernels, at "
              f"least {least}; {passes} calls {seen[-1][1]}): "
              f"{dict((many - want) + (want - many))}", flush=True)
        time.sleep(1.0)
    check(False, f"device traces dropped kernels {tries} times: (one call, "
                 f"{passes} calls) held {seen}, at least {least} a call")


def device_ms(fn, passes: int = 3) -> float:
    """The device time of one call of ``fn`` (:func:`device_time`)."""
    return device_time(fn, passes)[0]


def max_err(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


def bound(nbytes: float, flops: float,
          peak_flop_s: float = PEAK_F32_FLOP_S) -> tuple:
    """(least ms, "bytes" or "operations") for the work on one H100, its
    operations at ``peak_flop_s`` (f32 outside the tensor cores unless
    given)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak_flop_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    return max_err(got, want) / max(float(want.float().abs().max()), 1e-30)


def record_kernel(results, name, err, fn, plain_fn, nbytes, flops,
                  library_fn=None, plain_iters=20):
    """Times the kernel, its plain version (``plain_iters`` calls: fewer
    for plain versions that take seconds) and the library call, and
    computes the bound."""
    ms = time_ms(fn)
    plain_ms = time_ms(plain_fn, plain_iters, min(3, plain_iters - 1))
    library_ms = None if library_fn is None else time_ms(library_fn)
    bound_ms, bound_by = bound(nbytes, flops)
    results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library_ms}
    lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
    print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib}, bound "
          f"{bound_ms:.4f} ms ({bound_by}; {nbytes / 1e6:.2f} MB, "
          f"{flops / 1e6:.1f} MFLOP), kernel at {bound_ms / ms:.1%} of its "
          "bound")
    return results[name]


def kernels():
    """(name, CudaKernel, exported function, source, replaced TPU-side
    function) of every kernel of the paths; forward and backward are
    separate entries."""
    from shapy_tpu_torch.core.kinematics import CHAIN_KERNEL
    from shapy_tpu_torch.data.crop import INGEST_KERNEL
    from shapy_tpu_torch.eval.metrics import (
        ALIGN_KERNEL,
        NN_KERNEL,
        REGRESS_KERNEL,
    )
    from shapy_tpu_torch.measure.measurements import MEASURE_KERNEL
    from shapy_tpu_torch.models.backbones.hrnet import FUSE_KERNEL
    from shapy_tpu_torch.models.backbones.layers import (
        BN_KERNEL,
        CONV_KERNEL,
        POOL_KERNEL,
    )
    from shapy_tpu_torch.models.body.lbs import SKIN_KERNEL
    from shapy_tpu_torch.ops.repulsion import REPULSION_KERNEL
    from shapy_tpu_torch.ops.tri_tri import TRI_KERNEL

    csrc = "shapy_tpu_torch/csrc/"
    return [
        ("K1_measure", MEASURE_KERNEL, "measure_forward", csrc + "measure.cu",
         "shapy_tpu/ops/plane_slice.py:74"),
        ("K1_measure_backward", MEASURE_KERNEL, "measure_backward",
         csrc + "measure.cu", "shapy_tpu/measure/measurements.py:313"),
        ("K1exact_measure", MEASURE_KERNEL, "measure_exact_forward",
         csrc + "measure.cu", "shapy_tpu/ops/plane_slice.py:242"),
        ("K1exact_measure_backward", MEASURE_KERNEL, "measure_exact_backward",
         csrc + "measure.cu", "shapy_tpu/ops/plane_slice.py:242"),
        ("K1aos_points", MEASURE_KERNEL, "measure_points",
         csrc + "measure.cu", "shapy_tpu/ops/plane_slice.py:28"),
        ("K1aos_points_backward", MEASURE_KERNEL, "measure_points_backward",
         csrc + "measure.cu", "shapy_tpu/ops/plane_slice.py:28"),
        ("K2_ingest", INGEST_KERNEL, "ingest_forward", csrc + "ingest.cu",
         "shapy_tpu/data/crop.py:96"),
        ("K2_noise", INGEST_KERNEL, "ingest_noise_forward",
         csrc + "ingest.cu", "shapy_tpu/data/crop.py:96"),
        ("K3_skinning", SKIN_KERNEL, "skin_forward", csrc + "skinning.cu",
         "shapy_tpu/models/body/lbs.py:97"),
        ("K3_skinning_backward", SKIN_KERNEL, "skin_backward",
         csrc + "skinning.cu", "shapy_tpu/models/body/lbs.py:97"),
        ("K3chain_forward", CHAIN_KERNEL, "chain_forward",
         csrc + "kinematic_chain.cu", "shapy_tpu/core/kinematics.py:54"),
        ("K3chain_backward", CHAIN_KERNEL, "chain_backward",
         csrc + "kinematic_chain.cu", "shapy_tpu/core/kinematics.py:54"),
        ("K4_bn_forward", BN_KERNEL, "bn_forward", csrc + "batch_norm.cu",
         "shapy_tpu/models/backbones/layers.py:174"),
        ("K4_bn_backward", BN_KERNEL, "bn_backward", csrc + "batch_norm.cu",
         "shapy_tpu/models/backbones/layers.py:198"),
        ("K5_conv", CONV_KERNEL, "conv2d_act_forward", csrc + "conv.cu",
         "shapy_tpu/models/backbones/layers.py:91"),
        ("K5_fuse", FUSE_KERNEL, "hr_fuse_forward", csrc + "hr_fuse.cu",
         "shapy_tpu/models/backbones/hrnet.py:141"),
        ("K5_dgrad", CONV_KERNEL, "conv2d_dgrad", csrc + "conv.cu",
         "shapy_tpu/models/backbones/layers.py:91"),
        ("K5_wgrad", CONV_KERNEL, "conv2d_wgrad", csrc + "conv.cu",
         "shapy_tpu/models/backbones/layers.py:91"),
        ("K5_fuse_backward", FUSE_KERNEL, "hr_fuse_backward",
         csrc + "hr_fuse.cu", "shapy_tpu/models/backbones/hrnet.py:141"),
        ("K10_stem", CONV_KERNEL, "conv2d_stem_forward", csrc + "conv.cu",
         "shapy_tpu/models/backbones/resnet.py:54"),
        ("K10_stem_wgrad", CONV_KERNEL, "conv2d_stem_wgrad",
         csrc + "conv.cu", "shapy_tpu/models/backbones/resnet.py:54"),
        ("K11_max_pool", POOL_KERNEL, "max_pool_forward",
         csrc + "max_pool.cu", "shapy_tpu/models/backbones/resnet.py:57"),
        ("K11_max_pool_backward", POOL_KERNEL, "max_pool_backward",
         csrc + "max_pool.cu", "shapy_tpu/models/backbones/resnet.py:57"),
        ("K8a_point_regress", REGRESS_KERNEL, "point_regress_forward",
         csrc + "point_regress.cu", "shapy_tpu/eval/metrics.py:228"),
        ("K8b_align_error", ALIGN_KERNEL, "align_error_forward",
         csrc + "align_error.cu", "shapy_tpu/eval/metrics.py:123"),
        ("K6_tri_tri", TRI_KERNEL, "tri_tri_forward", csrc + "tri_tri.cu",
         "shapy_tpu/ops/tri_tri.py:144"),
        ("K7_repulsion", REPULSION_KERNEL, "repulsion_forward",
         csrc + "repulsion.cu", "shapy_tpu/ops/repulsion.py:103"),
        ("K7_repulsion_backward", REPULSION_KERNEL, "repulsion_backward",
         csrc + "repulsion.cu", "shapy_tpu/ops/repulsion.py:103"),
        ("K9_nn_dists", NN_KERNEL, "nn_dists_forward", csrc + "nn_dists.cu",
         "shapy_tpu/eval/metrics.py:36"),
    ]


# The kernels each path runs.
SERVE_KERNELS = ("K1_measure", "K2_ingest", "K3_skinning", "K3chain_forward",
                 "K5_conv", "K5_fuse")
# Launches per backbone forward: every conv of HRNet-W48 once, every
# fusion target once.
K5_PER_FORWARD = {"K5_conv": 331, "K5_fuse": 26}
# Launches per train step: the forward's, the data gradient of every conv
# but the stem's first (the images take none), every conv's weight
# gradient, every fusion target's backward.
K5_PER_TRAIN_STEP = dict(K5_PER_FORWARD, K5_dgrad=330, K5_wgrad=331,
                         K5_fuse_backward=26)
K5_SHAPES = 33
# BN layers of the backbone: a train step's K4 forward and backward calls.
K4_PER_TRAIN_STEP = 326
# The backbone's conv shapes (Cin, Cout, k, stride, input side) at a 256^2
# crop: the 33 of a train step.
BACKBONE_SHAPES = (
    (3, 64, 3, 2, 256), (64, 64, 3, 2, 128), (64, 256, 1, 1, 64),
    (64, 64, 1, 1, 64), (64, 64, 3, 1, 64), (256, 64, 1, 1, 64),
    (256, 48, 3, 1, 64), (256, 96, 3, 2, 64), (48, 48, 3, 1, 64),
    (96, 96, 3, 1, 32), (96, 48, 1, 1, 32), (48, 96, 3, 2, 64),
    (96, 192, 3, 2, 32), (192, 192, 3, 1, 16), (192, 48, 1, 1, 16),
    (192, 96, 1, 1, 16), (48, 48, 3, 2, 64), (48, 192, 3, 2, 32),
    (192, 384, 3, 2, 16), (384, 384, 3, 1, 8), (384, 48, 1, 1, 8),
    (384, 96, 1, 1, 8), (384, 192, 1, 1, 8), (48, 48, 3, 2, 32),
    (48, 384, 3, 2, 16), (96, 96, 3, 2, 32), (96, 384, 3, 2, 16),
    (1536, 2048, 1, 1, 8), (1536, 512, 1, 1, 8), (512, 512, 3, 1, 8),
    (512, 2048, 1, 1, 8), (2048, 2048, 1, 1, 8), (2048, 512, 1, 1, 8),
)
EVAL_KERNELS = SERVE_KERNELS + ("K8a_point_regress", "K8b_align_error")
# The backbones' kernels, whose launches a forward or a train step fixes.
BACKBONE_KERNELS = (*K5_PER_TRAIN_STEP, "K10_stem", "K10_stem_wgrad",
                    "K11_max_pool", "K11_max_pool_backward")
# Phase 11, the ResNet family: ResNet-50 served at batch 32 and 128 and
# evaluated at 32, ResNet-50 and ResNet-18 trained at batch 48. Per
# forward: a K5-conv launch per conv but the 7x7 stem (52 / 19), K10 for
# the stem, K11 for the max pool; a train step adds K5-dgrad and K5-wgrad
# at those convs, K10's weight gradient and K11's backward once, and K4
# at every BN (53 / 20).
RESNET_CONVS = {50: 52, 18: 19}
RESNET_SERVE_B = (32, 128)
RESNET_TRAIN_WARMUP, RESNET_TRAIN_STEPS = 1, 4
RESNET_KERNELS = ("K10_stem", "K10_stem_wgrad", "K11_max_pool",
                  "K11_max_pool_backward")
RESNET_SERVE_KERNELS = tuple(k for k in SERVE_KERNELS if k != "K5_fuse") + (
    "K10_stem", "K11_max_pool")
RESNET_EVAL_KERNELS = RESNET_SERVE_KERNELS + ("K8a_point_regress",
                                              "K8b_align_error")

# Phase 12's launches: per eval batch the served forward's and the
# metrics' (K8a for p2p_t, K8b for the v2v_t group), and once for the
# dataset K1 and K1-AoS's points on the GT triangles.
CLI_PER_BATCH = dict(K5_PER_FORWARD, K1_measure=1, K2_ingest=1,
                     K3_skinning=1, K3chain_forward=1, K8a_point_regress=1,
                     K8b_align_error=1)
CLI_PER_DATASET = {"K1_measure": 1, "K1aos_points": 1}
SCORE_KERNELS = ("K1_measure", "K1aos_points", "K8a_point_regress",
                 "K8b_align_error")
# The metrics' launches a batch, evaluated or scored: K8a once, K8b once
# (an eval batch's nine point errors in one group).
K8_PER_BATCH = {"K8a_point_regress": 1, "K8b_align_error": 1}
TRAIN_KERNELS = ("K1_measure", "K3_skinning", "K3_skinning_backward",
                 "K3chain_forward", "K3chain_backward", "K4_bn_forward",
                 "K4_bn_backward", *K5_PER_TRAIN_STEP)
FIT_KERNELS = {"reference": ("K1_measure", "K1_measure_backward"),
               "exact": ("K1exact_measure", "K1exact_measure_backward")}
CONTACT_KERNELS = ("K6_tri_tri", "K7_repulsion", "K7_repulsion_backward",
                   "K9_nn_dists")
RESNET_TRAIN_KERNELS = tuple(k for k in TRAIN_KERNELS
                             if "fuse" not in k) + RESNET_KERNELS
# Device functions a train step must run: K4's forward in both regimes;
# a ResNet's also K10's forward and weight gradient and K11's backward,
# each on its own kernel, and not on the general stem kernels (forward,
# scalar weight gradient) that K10's replaced.
TRAIN_DEVICE_KERNELS = ("fwd_cluster_kernel", "fwd_partial_kernel",
                        "fwd_normalize_kernel")
RESNET_DEVICE_KERNELS = (TRAIN_DEVICE_KERNELS + (
    "stem7_kernel", "stem7_wgrad_kernel", "max_pool_backward_kernel"),
    ("wgrad_bf16_scalar_kernel", "conv_bf16_kernel"))


def sources():
    """Each CudaKernel once (one nvcc per source)."""
    unique = {}
    for _, kernel, _, _, _ in kernels():
        unique.setdefault(kernel.source, kernel)
    return list(unique.values())


def reset_launches() -> None:
    for kernel in sources():
        kernel.reset_counts()


def read_launches() -> dict:
    return {name: kernel.counts[fn] for name, kernel, fn, _, _ in kernels()}


def check_kernels(regressor, requests, eval_data, dev):
    """Each kernel against its plain version at the main paths' shapes.
    Returns {name: dict(max_abs_err, ms, plain_ms, bound_ms, bound_by,
    library_ms)}."""
    import torch

    from shapy_tpu_torch.measure.measurements import (
        PLANES,
        _soa,
        measure_plain,
    )
    from shapy_tpu_torch.ops.plane_slice import plane_slice_reference_soa

    results = {}
    gen = torch.Generator().manual_seed(SEED + 1)
    model = regressor.model
    meas = regressor.body_measurements

    # K1: bodies with ||beta|| <= 6, on the candidate subsets (the main
    # path) and on all faces.
    betas = torch.randn((B, model.num_betas), generator=gen) * 1.5
    betas = betas * torch.clamp(6.0 / betas.norm(dim=1, keepdim=True), max=1)
    v_shaped = model.forward_shape(betas.to(dev))["v_shaped"].contiguous()
    subsets = [getattr(meas, f"subset_{n}") for n in PLANES]
    k1_err, heights = check_k1_forward(meas, v_shaped)
    # The work these bodies need on the subsets: the signed volume of all
    # F faces (17 FLOP each), ~150 FLOP of ray and edge tests per candidate
    # face, and 5 FLOP per (slice point, antipodal direction pair) for the
    # hull's projections and max / min (the points counted from the data).
    tx, ty, tz = _soa(v_shaped, meas.faces)
    points = 0
    for p, ids in enumerate(subsets):
        ids = ids.long()
        _, _, mask = plane_slice_reference_soa(
            ty[..., ids], tx[..., ids], tz[..., ids], heights[:, p],
            face_ids=ids)
        points += int(mask.sum())
    F = meas.faces.shape[0]
    n_cand = sum(int(ids.shape[0]) for ids in subsets)
    k1 = (v_shaped, meas.faces, subsets, meas.anchors)
    record_kernel(results, "K1_measure", k1_err,
           lambda: meas.measure(v_shaped),
           lambda: measure_plain(*k1, meas.num_hull_directions, meas.density),
           v_shaped.numel() * 4 + F * 12 + n_cand * 4 + B * 8 * 4,
           B * F * 17 + B * n_cand * 150
           + points * (meas.num_hull_directions // 2) * 5)

    results.update(check_k8a(eval_data, gen, dev))
    results.update(check_k8b(model, eval_data, gen, dev))
    return results


def k2_extreme_affines(H: int, W: int, S: int) -> np.ndarray:
    """Crop->image affines (f32) at K2's extremes: a magnification of 4
    (a 1024-pixel box onto S; its tiles inside the image overflow the
    staging budget and read their corners from the image), a 90 degree
    rotation, and a crop wholly outside the image (every corner reads 0)."""
    from shapy_tpu_torch.data.crop import crop_to_image_affine

    return np.stack([
        crop_to_image_affine((W / 2, H / 2), 4 * S / 200, (S, S)),
        crop_to_image_affine((W / 2, H / 2), min(H, W) / 200, (S, S),
                             rot_deg=90.0),
        crop_to_image_affine((-3 * W, 2 * H), 1.0, (S, S), rot_deg=10.0),
    ]).astype(np.float32)


def k2_read_pixels(images, affines) -> int:
    """The source pixels that K2's bilinear corners read inside the images
    for these affines, each counted once: what the kernel must load."""
    import torch

    B, H, W, _ = images.shape
    g = torch.arange(CROP, dtype=torch.float32, device=images.device)
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    A = affines[:, :, :, None, None]
    x0 = torch.floor(A[:, 0, 0] * gx + A[:, 0, 1] * gy + A[:, 0, 2])
    y0 = torch.floor(A[:, 1, 0] * gx + A[:, 1, 1] * gy + A[:, 1, 2])
    read = torch.zeros(B * H * W, dtype=torch.bool, device=images.device)
    base = torch.arange(B, device=images.device)[:, None, None] * (H * W)
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        cx, cy = x0 + dx, y0 + dy
        inside = (cx >= 0) & (cx <= W - 1) & (cy >= 0) & (cy <= H - 1)
        read[(base + cy.clamp(0, H - 1).long() * W
              + cx.clamp(0, W - 1).long())[inside]] = True
    return int(read.sum())


def check_k2(requests, dev) -> dict:
    """Phase 2, K2 bit-equal to ``crop_normalize_plain`` (max error 0:
    the same f32 operations in the same order, no FMA contraction) for
    uint8 and f32 images and f32 and bf16 crops, on the served requests at
    batch 32 and 128 (every uint8 tile staged, ``ingest_plan``) and on
    ``k2_extreme_affines`` (tiles in both regimes). Times the served call
    (uint8 -> bf16) at 32, the entry, and 128 (``cases``); the bound
    counts the source pixels that the run's corners read inside the
    images (``k2_read_pixels``, 3 bytes each), the affines and the bf16
    output, and the whole images' bytes are printed beside it."""
    import torch

    from shapy_tpu_torch.data.crop import (
        INGEST_KERNEL,
        crop_normalize,
        crop_normalize_plain,
        ingest_plan,
    )
    from shapy_tpu_torch.flagship import synthetic_requests

    big = tuple(torch.from_numpy(a).to(dev) for a in synthetic_requests(
        4 * B, IMAGE_H, IMAGE_W, CROP, SEED + 9))
    extreme = torch.from_numpy(k2_extreme_affines(IMAGE_H, IMAGE_W,
                                                  CROP)).to(dev)
    cases = {f"batch{B}": requests, f"batch{4 * B}": big,
             "extreme": (big[0][:extreme.shape[0]], extreme)}
    for name, (images, affines) in cases.items():
        for x in (images, images.to(torch.float32) * (1.0 / 255.0)):
            staged = ingest_plan(affines, IMAGE_H, IMAGE_W, CROP, x.dtype,
                                 x.data_ptr())["staged"]
            n_staged, tiles = int(staged.sum()), staged.numel()
            for out_dtype in (torch.float32, torch.bfloat16):
                before = INGEST_KERNEL.launches
                got = crop_normalize(x, affines, CROP, out_dtype=out_dtype)
                want = crop_normalize_plain(x, affines, CROP,
                                            out_dtype=out_dtype)
                torch.cuda.synchronize()
                check(INGEST_KERNEL.launches == before + 1,
                      f"K2 {name}: not one launch")
                check(torch.equal(got, want), f"K2 {name} {x.dtype} -> "
                      f"{out_dtype}: max error {max_err(got, want)}")
            print(f"K2 ingest {name} ({x.dtype} in): f32 and bf16 out "
                  f"bit-equal to the plain version; {n_staged} of {tiles} "
                  f"tiles staged, {tiles - n_staged} read the image")
            if name == "extreme":
                check(0 < n_staged < tiles, f"K2 extremes: {n_staged} of "
                      f"{tiles} tiles staged, not both regimes")
            elif x.dtype == torch.uint8:
                check(n_staged == tiles, f"K2 {name}: {n_staged} of "
                      f"{tiles} served tiles staged")

    entries = {}
    for name in (f"batch{B}", f"batch{4 * B}"):
        images, affines = cases[name]
        Bk = images.shape[0]
        pixels = k2_read_pixels(images, affines)
        out_bytes = Bk * CROP * CROP * 3 * 2
        print(f"K2 {name}: the corners read {pixels} source pixels "
              f"({pixels * 3 / 1e6:.2f} MB) of {images.numel() / 1e6:.2f} "
              f"MB of images; whole-image bound "
              f"{(images.numel() + out_bytes) / PEAK_BYTES_S * 1e3:.4f} ms")
        # Per output pixel: the affine map (8 FLOP) and, per channel, the
        # bilinear blend (11) and the normalisation (2).
        entries[name] = record_kernel(
            {}, "K2_ingest", 0.0,
            lambda: crop_normalize(images, affines, CROP,
                                   out_dtype=torch.bfloat16),
            lambda: crop_normalize_plain(images, affines, CROP,
                                         out_dtype=torch.bfloat16),
            pixels * 3 + affines.numel() * 4 + out_bytes,
            Bk * CROP * CROP * (8 + 3 * 13))
        entries[name]["source_pixels_read"] = pixels
    return {"K2_ingest": dict(entries[f"batch{B}"], cases={
        f"batch{4 * B}": entries[f"batch{4 * B}"]})}


# The published SMPL-X tree (kintree order: pelvis; hips, spine1; knees,
# spine2; ankles, spine3; feet, neck, collars; head, shoulders; elbows;
# wrists; jaw and eyes; five fingers of three joints under each wrist):
# 55 joints in 11 levels, where the synthetic tree has 6.
SMPLX_PARENTS = (
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
    15, 15, 15, 20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,
    21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53)
PATH64_PARENTS = (-1,) + tuple(range(63))


def check_k3chain(model, dev) -> dict:
    """Phase 2, K3-chain at the served batch (32) and a train step's (48)
    on three trees: the flagship's (synthetic SMPL-X, 55 joints in 6
    levels), the published SMPL-X tree (``SMPLX_PARENTS``, 55 in 11) and
    a 64-joint path (64 levels); rest joints from the flagship's seeded
    bodies (the path: 64 seeded points of ~0.3 m), rotations of 0.3 rad a
    joint, cotangents N(0, 1). The forward and the backward within 1e-5 of
    autograd through the plain version in f64 and in f32 (3x4 products over
    up to 11 levels in f32; on the path 1e-5 of the largest value: its
    gradients reach ~75, and the plain version in f32 is itself 2.3e-5
    from f64 there), each bit-equal to its replay
    (``chain_forward_replay``, ``chain_backward_replay``), across two calls
    and for a body alone (the first, middle and last) as in its batch; one
    launch each. Returns the forward's entry (the flagship's tree at 48;
    at 32 and on the SMPL-X tree under ``cases``) and the backward's."""
    import torch

    from shapy_tpu_torch.core.kinematics import (
        CHAIN_KERNEL,
        batch_rigid_transform,
        batch_rigid_transform_plain,
        chain_backward_replay,
        chain_forward_replay,
    )
    from shapy_tpu_torch.core.rotations import aa_to_rotmat

    gen = torch.Generator().manual_seed(SEED + 11)
    trees = {"flagship": tuple(int(p) for p in model.parents),
             "smplx": SMPLX_PARENTS, "path64": PATH64_PARENTS}
    fwd, bwd = {}, {}
    for tree, parents in trees.items():
        J = len(parents)
        for Bk in (B, TRAIN_B):
            if J == model.num_joints:
                betas = torch.randn((Bk, model.num_betas), generator=gen) * 1.5
                joints = torch.matmul(model.J_regressor, model.forward_shape(
                    betas.to(dev))["v_shaped"]).contiguous()
            else:
                joints = (torch.randn((Bk, J, 3), generator=gen) * 0.3).to(dev)
            rot = aa_to_rotmat((torch.randn((Bk, J, 3), generator=gen) * 0.3)
                               .to(dev)).contiguous()
            cts = [torch.randn(s, generator=gen).to(dev) for s in
                   ((Bk, J, 3), (Bk, J, 4, 4), (Bk, J, 4, 4))]

            def graph(fn, dtype, sl=slice(None)):
                r = rot[sl].to(dtype, copy=True).requires_grad_()
                j = joints[sl].to(dtype, copy=True).requires_grad_()
                return fn(r, j), (r, j)

            kern = lambda r, j: batch_rigid_transform(  # noqa: E731
                r, j, parents)
            plain = lambda r, j: batch_rigid_transform_plain(  # noqa: E731
                r, j, parents)
            before = dict(CHAIN_KERNEL.counts)
            outs, ins = graph(kern, torch.float32)
            got = torch.autograd.grad(outs, ins, cts, retain_graph=True)
            check(CHAIN_KERNEL.counts == {k: v + 1 for k, v in
                                          before.items()},
                  f"K3-chain {tree} {Bk}: not one launch each")
            fwd_err = bwd_err = 0.0
            for dtype in (torch.float64, torch.float32):
                p_outs, p_ins = graph(plain, dtype)
                want = torch.autograd.grad(p_outs, p_ins,
                                           [c.to(dtype) for c in cts])
                scale = [max(1.0, float(w.abs().max()))
                         if tree == "path64" else 1.0 for w in want]
                fwd_err = max(fwd_err, *(max_err(a, b) for a, b in
                                         zip(outs, p_outs)))
                bwd_err = max(bwd_err, *(max_err(a, b) / k for a, b, k in
                                         zip(got, want, scale)))
            replayed = (all(torch.equal(a, b) for a, b in zip(
                outs, chain_forward_replay(rot, joints, parents)))
                and all(torch.equal(a, b) for a, b in zip(
                    got, chain_backward_replay(rot, joints, parents, *cts))))
            o2, i2 = graph(kern, torch.float32)
            again = torch.autograd.grad(o2, i2, cts)
            same = all(torch.equal(a, b) for a, b in
                       zip(outs + got, o2 + again))
            single = True
            for i in sorted({0, Bk // 2, Bk - 1}):
                sl = slice(i, i + 1)
                o1, i1 = graph(kern, torch.float32, sl)
                g1 = torch.autograd.grad(o1, i1, [c[sl] for c in cts])
                single &= all(torch.equal(a[0], b[i]) for a, b in
                              zip(o1 + g1, outs + got))
            torch.cuda.synchronize()
            print(f"K3-chain ({tree}, {J} joints, batch {Bk}): forward err "
                  f"{fwd_err:.3e}, backward err vs plain autograd f64/f32 "
                  f"{bwd_err:.3e}{' of the largest' if tree == 'path64' else ''}"
                  f" (tol 1e-5); bit-equal to the replays: {replayed}, "
                  f"across two calls: {same}, for a body alone: {single}")
            check(fwd_err <= 1e-5 and bwd_err <= 1e-5,
                  f"K3-chain {tree} {Bk} vs plain: {fwd_err}, {bwd_err}")
            check(replayed and same and single,
                  f"K3-chain {tree} {Bk}: replays, two calls, a body alone "
                  f"bit-equal: {replayed}, {same}, {single}")
            if tree == "path64" or (tree == "smplx" and Bk == B):
                continue
            n_in, n_out = Bk * J * 12, Bk * J * 35
            key = f"{tree}_batch{Bk}"
            fwd[key] = record_kernel(
                {}, "K3chain_forward", fwd_err,
                lambda: batch_rigid_transform(rot, joints, parents),
                lambda: batch_rigid_transform_plain(rot, joints, parents),
                (n_in + n_out) * 4, Bk * J * (60 + 15))
            if Bk == TRAIN_B:
                p_outs, p_ins = graph(plain, torch.float32)
                bwd[key] = record_kernel(
                    {}, "K3chain_backward", bwd_err,
                    lambda: torch.autograd.grad(outs, ins, cts,
                                                retain_graph=True),
                    lambda: torch.autograd.grad(p_outs, p_ins, cts,
                                                retain_graph=True),
                    (n_in + Bk * J * 16 + n_out + n_in) * 4, Bk * J * 160)
    main_key = f"flagship_batch{TRAIN_B}"
    return {"K3chain_forward": dict(fwd.pop(main_key), cases=fwd),
            "K3chain_backward": dict(bwd.pop(main_key), cases=bwd)}


def check_k3(model, dev) -> dict:
    """Phase 2, K3 at the main paths' shapes: the forward at batch 32 (a
    served or evaluated batch) and 48 (a train step's), the backward at
    48, on bodies of the flagship's SMPL-X posed by 0.3 rad a joint.
    Tolerances: the forward atol 1e-5 m (sums of 55 weighted transforms in
    another order than the plain version's matmul); the gradients 1e-5 of
    the largest against autograd through the plain version in f64 and f32
    (sums over 10475 vertices in f32). Each also bit-equal across two
    calls, for a body alone (the first, middle and last) as in its row of
    the batch, and to its order replay (``skin_forward_replay``,
    ``skin_backward_replay``). Returns the forward's entry (batch 48 under
    ``cases``) and the backward's."""
    import torch

    from shapy_tpu_torch.core.kinematics import batch_rigid_transform
    from shapy_tpu_torch.core.rotations import aa_to_rotmat
    from shapy_tpu_torch.models.body.lbs import (
        skin,
        skin_backward_replay,
        skin_forward_replay,
        skin_plain,
    )

    gen = torch.Generator().manual_seed(SEED + 3)
    W = model.lbs_weights
    V, J = W.shape

    def posed(Bk):
        betas = (torch.randn((Bk, model.num_betas), generator=gen) * 1.5)
        v_shaped = model.forward_shape(betas.to(dev))["v_shaped"]
        joints = torch.matmul(model.J_regressor, v_shaped)
        aa = torch.randn((Bk, J, 3), generator=gen) * 0.3
        _, rel, _ = batch_rigid_transform(aa_to_rotmat(aa.to(dev)), joints,
                                          model.parents, model.levels)
        v_posed = v_shaped + 0.01 * torch.randn(v_shaped.shape,
                                                generator=gen).to(dev)
        return rel.contiguous(), v_posed.contiguous()

    def alone(Bk):
        return sorted({0, Bk // 2, Bk - 1})

    forward = {}
    for Bk in (B, TRAIN_B):
        rel, vp = posed(Bk)
        got = skin(W, rel, vp)
        err = max_err(got, skin_plain(W, rel, vp))
        same = torch.equal(got, skin(W, rel, vp))
        single = all(torch.equal(skin(W, rel[i:i + 1], vp[i:i + 1])[0],
                                 got[i]) for i in alone(Bk))
        replayed = torch.equal(got, skin_forward_replay(W, rel, vp))
        torch.cuda.synchronize()
        print(f"K3 skinning (batch {Bk}): err {err:.3e} m (tol 1e-5); two "
              f"calls bit-equal: {same}; bodies {alone(Bk)} alone bit-equal: "
              f"{single}; bit-equal to its replay: {replayed}")
        check(err <= 1e-5, f"K3 err {err} at batch {Bk}")
        check(same and single and replayed,
              f"K3 forward at batch {Bk}: two calls, a body alone and the "
              f"replay bit-equal: {same}, {single}, {replayed}")
        # Per vertex: 12 multiply-adds per joint, then the 3x4 transform.
        forward[Bk] = record_kernel(
            {}, "K3_skinning", err, lambda: skin(W, rel, vp),
            lambda: skin_plain(W, rel, vp),
            (V * J + rel.numel() + 2 * vp.numel()) * 4,
            Bk * V * (24 * J + 18))

    rel, v_posed = posed(TRAIN_B)
    dv = torch.randn(v_posed.shape, generator=gen).to(dev)

    def skin_graph(fn, dtype, sl=slice(None)):
        a = rel[sl].to(dtype, copy=True).requires_grad_()
        b = v_posed[sl].to(dtype, copy=True).requires_grad_()
        return fn(W.to(dtype), a, b), (a, b)

    out, s_ins = skin_graph(skin, torch.float32)
    got = torch.autograd.grad(out, s_ins, dv, retain_graph=True)
    err = 0.0
    for dtype in (torch.float64, torch.float32):
        want = torch.autograd.grad(*skin_graph(skin_plain, dtype),
                                   dv.to(dtype))
        err = max(err, *(max_err(a, b) / max(1.0, float(b.abs().max()))
                         for a, b in zip(got, want)))
    again = torch.autograd.grad(*skin_graph(skin, torch.float32), dv)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    single = True
    for i in alone(TRAIN_B):
        one = torch.autograd.grad(
            *skin_graph(skin, torch.float32, slice(i, i + 1)), dv[i:i + 1])
        single &= all(torch.equal(a[0], b[i]) for a, b in zip(one, got))
    replay = skin_backward_replay(W, rel, v_posed, dv)
    replayed = all(torch.equal(a, b) for a, b in zip(got, replay))
    print(f"K3 skinning backward (batch {TRAIN_B}): err vs plain autograd "
          f"f64/f32 {err:.3e} of the largest gradient (tol 1e-5); two calls "
          f"bit-equal: {same}; bodies {alone(TRAIN_B)} alone bit-equal: "
          f"{single}; bit-equal to its replay: {replayed}")
    check(err <= 1e-5, f"K3 backward vs plain: {err}")
    check(same and single and replayed,
          f"K3 backward: two calls, a body alone and the replay bit-equal: "
          f"{same}, {single}, {replayed}")
    p_out, p_ins = skin_graph(skin_plain, torch.float32)
    results = {"K3_skinning": dict(forward[B],
                                   cases={f"batch{TRAIN_B}": forward[TRAIN_B]})}
    # Per vertex: the transform again (24 J), d v_posed (15), the outer
    # product (12) and 24 FLOP per joint into d A.
    record_kernel(results, "K3_skinning_backward", err,
                  lambda: torch.autograd.grad(out, s_ins, dv,
                                              retain_graph=True),
                  lambda: torch.autograd.grad(p_out, p_ins, dv,
                                              retain_graph=True),
                  (V * J + 2 * rel.numel() + 3 * v_posed.numel()) * 4,
                  TRAIN_B * V * (48 * J + 27))
    return results


def check_k8a(eval_data, gen, dev) -> dict:
    """K8a, the P2P-20k error of predicted-like against GT v_shaped, in its
    three cases: the evaluator's (one regressor for both meshes), a
    separate target regressor, no alignment; each through the regressor's
    call (its sorted rows, the main path). Tolerance atol 1e-5 m: the
    translation's means summed in another order (f64 in the kernel). One
    launch a call, the same bits twice, the totals bit-equal to their
    replay in the kernel's order."""
    import torch

    from shapy_tpu_torch.eval import metrics

    reg = eval_data["p2p"]
    gt_v = eval_data["batches"][0]["gt_v_shaped"]
    pred_v = (gt_v + 0.01 * torch.randn(gt_v.shape, generator=gen).to(dev)
              + 0.02).contiguous()
    P, K = reg.indices.shape
    rng = np.random.default_rng(SEED + 7)
    faces = np.asarray(reg.indices.cpu())  # rows of three vertices
    target = metrics.SparsePointRegressor(
        faces[rng.permutation(P)], rng.dirichlet(np.ones(K), size=P),
        device=dev)
    no_align = copy.copy(reg)
    no_align.align = False
    kernel = metrics.REGRESS_KERNEL
    err = 0.0
    for case, r, tr in (("same", reg, None), ("target", reg, target),
                        ("no-align", no_align, None)):
        before = kernel.counts["point_regress_forward"]
        got = r(pred_v, gt_v, tr)
        check(kernel.counts["point_regress_forward"] == before + 1,
              f"K8a ({case}) took more than one launch")
        e = max_err(got, r.plain(pred_v, gt_v, tr))
        check(e <= 1e-5, f"K8a ({case}) err {e}")
        check(torch.equal(got, r(pred_v, gt_v, tr)),
              f"K8a ({case}): two calls differ")
        rows = r.kernel_rows(tr)
        _, sums = metrics._point_regress_cuda(pred_v, gt_v, *rows[:4],
                                              r.align, rows[4])
        want = (metrics.regress_sums_replay(pred_v, gt_v, *rows[:4])
                if r.align else torch.zeros_like(sums))
        check(torch.equal(sums, want),
              f"K8a ({case}): the translation's sums are not the kernel "
              f"order's (max diff {float((sums - want).abs().max()):.3e})")
        print(f"K8a point regress ({case}): err {e:.3e} m (tol 1e-5), one "
              "launch, bit-equal twice, sums as their replay")
        err = max(err, e)
    plan = metrics.regress_plan(P, B)
    print(f"K8a plan: {plan.cluster} CTAs a body of {plan.span} points")
    # Per (body, point): two K-term regressions (6K FLOP each), the
    # translation and the distance (~15 FLOP); bytes: both meshes, the
    # rows and their order read once, the errors written once.
    return {"K8a_point_regress": record_kernel(
        {}, "K8a_point_regress", err, lambda: reg(pred_v, gt_v),
        lambda: reg.plain(pred_v, gt_v),
        (pred_v.numel() + gt_v.numel()) * 4 + P * K * 8 + P * 4 + B * P * 4,
        B * P * (12 * K + 15))}


# Per-point FLOP of K8b: the means (6) if any alignment needs them, the
# moments (var1 6, var2 6, K 18), and each alignment's error.
K8B_FLOP = {"none": 8, "root": 11, "translation": 11, "scale": 17,
            "procrustes": 32}


def k8b_group(model, eval_data, gen, dev) -> list:
    """The evaluator's K8b group of one batch (B = 32), GT from the first
    eval batch: v2v_t (v_shaped: scale, translation), v2v (posed:
    procrustes, scale, translation), mpjpe (the 55 joints: root,
    procrustes), mpjpe14 (root on the hips, procrustes); each estimate a
    rotated, scaled, shifted and perturbed copy of its GT."""
    import torch

    batch = eval_data["batches"][0]
    gt_p, gt_s = batch["gt_vertices"], batch["gt_v_shaped"]
    j14 = torch.as_tensor(np.asarray(eval_data["j14"]), device=dev)
    R = torch.linalg.qr(torch.randn((B, 3, 3), generator=gen))[0]
    R = (R * torch.linalg.det(R).sign()[:, None, None]).to(dev)

    def similar(x):
        noise = 0.005 * torch.randn(x.shape, generator=gen).to(dev)
        return (1.1 * torch.einsum("bij,bpj->bpi", R, x) + noise
                + torch.tensor([0.1, -0.3, 2.0], device=dev)).contiguous()

    joints = torch.matmul(model.J_regressor, gt_p).contiguous()
    joints14 = torch.einsum("jv,bvn->bjn", j14, gt_p).contiguous()
    return [(similar(gt_s), gt_s, ("scale", "translation"), None),
            (similar(gt_p), gt_p, ("procrustes", "scale", "translation"),
             None),
            (similar(joints), joints, ("root", "procrustes"), (0,)),
            (similar(joints14), joints14, ("root", "procrustes"), (2, 3))]


def check_k8b(model, eval_data, gen, dev) -> dict:
    """K8b at the eval batch's nine calls in one launch, against the plain
    version in f64 (atol 1e-5 m: the kernel forms the aligned points in
    f32) and in f32 (atol 1e-5 m; 3e-5 m for procrustes, whose f32 SVD
    gives a rotation good to ~3e-6 at points ~4 m from the centroid);
    bit-equal run to run and to each pair as a group of one, the totals
    bit-equal to their replay in the kernel's order; and procrustes over
    an exact similarity (error ~0)."""
    import torch

    from shapy_tpu_torch.eval import metrics

    group = k8b_group(model, eval_data, gen, dev)
    kernel = metrics.ALIGN_KERNEL
    before = kernel.counts["align_error_forward"]
    got = metrics.aligned_point_errors(group)
    check(kernel.counts["align_error_forward"] == before + 1,
          "K8b: the group took more than one launch")
    again = metrics.aligned_point_errors(group)
    err = 0.0
    for (est, gt, names, root), out, out2 in zip(group, got, again):
        root = tuple(root or (0,))
        alone, sums = metrics._aligned_point_errors_cuda(
            [(est, gt, names, root)])
        want = metrics.aligned_sums_replay(est, gt, names, root)
        check(torch.equal(sums[0], want),
              f"K8b (P {est.shape[1]}): the sums are not the kernel "
              f"order's (max diff {float((sums[0] - want).abs().max()):.3e})")
        for name in names:
            e64 = max_err(out[name], metrics.aligned_point_error_plain(
                est.double(), gt.double(), name, root))
            e32 = max_err(out[name], metrics.aligned_point_error_plain(
                est, gt, name, root))
            tol = 3e-5 if name == "procrustes" else 1e-5
            print(f"K8b {name} (P {est.shape[1]}): err {e64:.3e} m vs f64 "
                  f"(tol 1e-5), {e32:.3e} vs f32 (tol {tol:g})")
            check(e64 <= 1e-5 and e32 <= tol,
                  f"K8b {name} (P {est.shape[1]}) err {e64} / {e32}")
            check(torch.equal(out[name], out2[name])
                  and torch.equal(out[name], alone[0][name]),
                  f"K8b {name} (P {est.shape[1]}): bits differ between "
                  "two calls or from a group of one")
            err = max(err, e64)
    gt_p = group[1][1]
    R = torch.linalg.qr(torch.randn((B, 3, 3), generator=gen))[0]
    R = (R * torch.linalg.det(R).sign()[:, None, None]).to(dev)
    moved = (1.1 * torch.einsum("bij,bpj->bpi", R, gt_p)
             + torch.tensor([0.1, -0.3, 2.0], device=dev)).contiguous()
    exact = float(metrics.aligned_point_error(moved, gt_p,
                                              "procrustes").max())
    print(f"K8b procrustes of an exact similarity: max err {exact:.3e} m "
          "(tol 1e-5)")
    check(exact <= 1e-5, f"K8b similarity not recovered: {exact}")
    plans = sorted({(est.shape[1], metrics.align_plan(est.shape[1], B))
                    for est, *_ in group})
    print(f"K8b plans (P, CTAs a body, points a CTA): {plans}")
    nbytes = sum((est.numel() + gt.numel()) * 4
                 + est.shape[0] * est.shape[1] * 4 * len(names)
                 for est, gt, names, _ in group)
    flops = sum(est.shape[0] * est.shape[1] * (
        6 * bool(set(names) & {"translation", "scale", "procrustes"})
        + 6 * bool(set(names) & {"scale", "procrustes"})
        + 6 * ("scale" in names) + 18 * ("procrustes" in names)
        + sum(K8B_FLOP[n] for n in names)) for est, gt, names, _ in group)
    return {"K8b_align_error": record_kernel(
        {}, "K8b_align_error", err,
        lambda: metrics.aligned_point_errors(group),
        lambda: metrics.aligned_point_errors(group, plain=True),
        nbytes, flops)}


def check_k1_forward(meas, v_shaped) -> tuple:
    """Phase 2, K1's forward (``meas``, reference mode) on the bodies
    ``v_shaped`` on the candidate subsets (the served path) and on all
    faces, against its plain version: mass / height rel 1e-5 (f32 sums in
    another order), circumferences atol 1e-5 m (identical hit tests
    without FMA; centroid and hull sums in another order), plane heights
    1e-6; the saved hits as the plain slice's (:func:`check_saved_hits`).
    Returns (the largest error, the plain plane heights on the
    subsets)."""
    import torch

    from shapy_tpu_torch.measure.measurements import PLANES, measure_plain

    subsets = [getattr(meas, f"subset_{n}") for n in PLANES]
    k1_err = 0.0
    for plane_faces in (subsets, None):
        got, got_h = meas.measure(v_shaped, plane_faces is not None)
        want, want_h = measure_plain(v_shaped, meas.faces, plane_faces,
                                     meas.anchors, meas.num_hull_directions,
                                     meas.density)
        torch.cuda.synchronize()
        rel = ((got[:, :2] - want[:, :2]).abs() / want[:, :2].abs()).max()
        circ = max_err(got[:, 2:], want[:, 2:])
        walk = "subsets" if plane_faces else "all faces"
        print(f"K1 measure ({walk}, batch {v_shaped.shape[0]}): mass/height "
              f"rel err {float(rel):.3e} (tol 1e-5), circumference err "
              f"{circ:.3e} m (tol 1e-5); " + check_saved_hits(
                  meas, v_shaped, plane_faces, plane_faces is not None,
                  f"K1 measure ({walk})"))
        check(float(rel) <= 1e-5, f"K1 mass/height rel err {float(rel)}")
        check(circ <= 1e-5, f"K1 circumference err {circ} m")
        check(max_err(got_h, want_h) <= 1e-6, "K1 plane heights")
        check(bool((got[:, 2:] > 0.5).all()), "K1 empty slices")
        k1_err = max(k1_err, max_err(got, want))
        if plane_faces is subsets:
            heights = want_h
    return k1_err, heights


def check_k5_launches(launches: dict, forwards: int, what: str,
                      per_forward: dict = K5_PER_FORWARD) -> None:
    """Exactly ``per_forward`` backbone launches per forward (HRNet-W48:
    331 K5-conv and 26 K5-fuse): every conv, fusion target and pool of the
    eval backbone ran its kernel; no backward kernel ran, and no kernel of
    another backbone."""
    for name in BACKBONE_KERNELS:
        per = per_forward.get(name, 0)
        check(launches[name] == per * forwards,
              f"{what}: {launches[name]} {name} launches for {forwards} "
              f"forwards, expected {per} each")


def serve(regressor, requests, per_forward: dict = K5_PER_FORWARD,
          path_kernels=SERVE_KERNELS, what: str = "serve"):
    """The main path: warm-up, then 3 requests of the requests' batch,
    ``per_forward`` backbone launches a request. Returns the launch counts
    of this run and images/s."""
    import torch

    images, affines = requests
    n = images.shape[0]
    with torch.inference_mode():
        regressor.apply_from_full_images(images, affines, CROP)
        torch.cuda.synchronize()
        reset_launches()
        start = time.perf_counter()
        outs = [regressor.apply_from_full_images(images, affines, CROP)
                for _ in range(3)]
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        launches = read_launches()

    for out in outs:
        last = out["stage_02"]
        tensors = [out["features"], out["proj_joints"], last["vertices"],
                   last["joints"], last["v_shaped"], last["betas"],
                   *out["measurements"].values()]
        check(all(bool(torch.isfinite(t).all()) for t in tensors),
              "non-finite output")
        check(last["vertices"].shape == (n, regressor.model.num_verts, 3),
              "vertices shape")
    betas = outs[-1]["stage_02"]["betas"]
    beta_norm = float(betas.norm(dim=1).max())
    spread = float(betas.std(dim=0).max())
    check(beta_norm < BETA_BOUND, f"||beta|| {beta_norm} outside the bound")
    check(spread > 1e-3, "betas do not vary per image")
    for name in path_kernels:
        check(launches[name] > 0, f"{name} was not launched by {what}")
    check_k5_launches(launches, 3, what, per_forward)
    rate = 3 * n / elapsed
    meas = {k: [round(float(v.min()), 4), round(float(v.max()), 4)]
            for k, v in outs[-1]["measurements"].items()}
    print(f"{what}: 3 requests of {n} in {elapsed * 1e3:.1f} ms = "
          f"{rate:.1f} images/s; max ||beta|| {beta_norm:.3f}, "
          f"betas std over batch up to {spread:.4f}; launches {launches}")
    print(f"measurements (min, max): {json.dumps(meas)}")
    return launches, rate


def parity(base, requests, eval_data, dev):
    """CPU port (plain versions) vs CUDA port (kernels), f32, no TF32: the
    outputs, and the evaluator's metrics on them against the first two
    GT bodies of the first eval batch."""
    import torch

    from shapy_tpu_torch.eval.evaluator import build_evaluator
    from shapy_tpu_torch.flagship import REFERENCE_EVAL_CFG

    gt = eval_data["batches"][0]
    targets = {"gt_v_shaped": gt["gt_v_shaped"][:2],
               "gt_vertices": gt["gt_vertices"][:2],
               "gt_joints3d": gt["joints3d"][:2],
               "gt_joints14": gt["joints14"][:2],
               "joints14_valid": gt["joints14_valid"][:2],
               **{k: gt[f"{k}_gt"][:2] for k in
                  ("height", "chest", "waist", "hips", "mass")}}
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        images, affines = (t[:2] for t in requests)
        outs, metrics = [], []
        for device in ("cpu", dev):
            reg = copy.deepcopy(base).to(device).prepare_for_eval_()
            evaluator = build_evaluator(
                REFERENCE_EVAL_CFG, device=device,
                point_regressor=eval_data["p2p"],
                j14_regressor=eval_data["j14"])
            with torch.inference_mode():
                out = reg.apply_from_full_images(images.to(device),
                                                 affines.to(device), CROP)
                m = evaluator.compute_batch_metrics(
                    out, {k: v.to(device) for k, v in targets.items()})
            metrics.append({k: v.cpu() for k, v in m.items()})
            last = out["stage_02"]
            outs.append({"betas": last["betas"].cpu(),
                         "vertices": last["vertices"].cpu(),
                         **{k: v.cpu() for k, v in
                            out["measurements"].items()}})
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    cpu, gpu = outs
    # Tolerances: ~100 f32 conv layers in another order on each side
    # drift the features by ~1e-5 relative.
    scale = float(cpu["betas"].norm(dim=1).max())
    errs = {"betas": max_err(cpu["betas"], gpu["betas"]) / scale,
            "vertices": max_err(cpu["vertices"], gpu["vertices"])}
    for k in ("mass", "height", "chest", "waist", "hips"):
        errs[k] = float(((cpu[k] - gpu[k]).abs() / cpu[k].abs()).max())
    tols = {"betas": 1e-3, "vertices": 1e-4, "mass": 1e-4, "height": 1e-4,
            "chest": 1e-4, "waist": 1e-4, "hips": 1e-4}
    print("cross-device parity (betas rel to max ||beta||, vertices m, "
          "measurements rel): " + ", ".join(
              f"{k} {errs[k]:.3e} (tol {tols[k]:g})" for k in errs))
    for k, e in errs.items():
        check(e <= tols[k], f"cross-device parity {k}: {e} > {tols[k]}")
    # Metrics: the vertices' 1e-4 m tolerance bounds the point errors'
    # difference; the measurements' rel 1e-4 bounds their errors' (1e-2
    # kg on ~100 kg).
    mcpu, mgpu = metrics
    check(set(mcpu) == set(mgpu) and len(mcpu) == 15, "metric keys")
    worst = {}
    for k in mcpu:
        tol = 1e-2 if k == "mass_error" else 1e-4
        both_nan = torch.isnan(mcpu[k]) & torch.isnan(mgpu[k])
        e = float(torch.where(both_nan, 0.0, (mcpu[k] - mgpu[k]).abs())
                  .max())
        worst[k] = e
        check(e <= tol, f"cross-device metric {k}: {e} > {tol}")
    check(bool(torch.isnan(mgpu["mpjpe14_root"]).any()),
          "the invalid mpjpe14 sample is not NaN")
    print("cross-device metrics (max |cpu - cuda|; m, mass kg): "
          + ", ".join(f"{k} {e:.2e}" for k, e in sorted(worst.items())))


def evaluate(regressor, eval_data, serve_rate,
             per_forward: dict = K5_PER_FORWARD,
             path_kernels=EVAL_KERNELS, what: str = "evaluate"):
    """Phase 5: the flagship through make_eval_fn -> Evaluator.run, with
    ``per_forward`` backbone launches a batch."""
    import torch

    from shapy_tpu_torch.eval.loop import make_eval_fn
    from shapy_tpu_torch.flagship import REFERENCE_EVAL_CFG

    eval_fn = make_eval_fn(regressor, {"hbw_synthetic": eval_data["batches"]},
                           REFERENCE_EVAL_CFG,
                           point_regressor=eval_data["p2p"],
                           j14_regressor=eval_data["j14"])
    eval_fn()  # warm-up
    torch.cuda.synchronize()
    seen = []
    reset_launches()
    start = time.perf_counter()
    results = eval_fn(on_batch=lambda *a: seen.append(a))["hbw_synthetic"]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launches = read_launches()

    for name in path_kernels:
        check(launches[name] > 0, f"{name} was not launched by {what}")
    for name, per in K8_PER_BATCH.items():
        check(launches[name] == per * EVAL_BATCHES,
              f"{what}: {launches[name]} {name} launches for "
              f"{EVAL_BATCHES} batches, expected {per} each")
    check_k5_launches(launches, EVAL_BATCHES, what, per_forward)
    metric_names = [k for k in results if "/" not in k]
    check(len(metric_names) == 15, f"metrics {sorted(metric_names)}")
    check(all(math.isfinite(v) for v in results.values()),
          "non-finite accumulated metric")
    for name in metric_names:
        check(any(k.startswith(name + "/") for k in results),
              f"no group means for {name}")
    # The kernels' metrics against the plain versions' on the card.
    evaluator = eval_fn.evaluator
    worst = 0.0
    for outputs, targets, metrics in seen:
        plain = evaluator.compute_batch_metrics(outputs, targets, plain=True)
        check(set(plain) == set(metrics), "metric keys differ from plain")
        for k, v in metrics.items():
            both_nan = torch.isnan(v) & torch.isnan(plain[k])
            check(bool((torch.isnan(v) == torch.isnan(plain[k])).all()),
                  f"{k}: NaN pattern differs from plain")
            e = float(torch.where(both_nan, 0.0, (v - plain[k]).abs()).max())
            tol = 0.0 if k.endswith("_error") else METRIC_TOL
            check(e <= tol, f"{k}: kernel vs plain {e} > {tol}")
            worst = max(worst, e)
    rate = EVAL_BATCHES * B / elapsed
    show = {k: round(v, 5) for k, v in results.items() if "/" not in k}
    print(f"{what}: {EVAL_BATCHES} batches of {B} in "
          f"{elapsed * 1e3:.1f} ms = {rate:.1f} images/s forward + metrics "
          f"(serve only: {serve_rate:.1f} images/s); launches {launches}; "
          f"kernel vs plain metrics max err {worst:.2e} (tol {METRIC_TOL})")
    print(f"eval means: {json.dumps(show)}")
    print(f"eval group means: {sum('/' in k for k in results)}")
    return launches, rate


def score_lines(results) -> str:
    """The offline scorer's printed lines for ``results``, in its
    format."""
    lines = []
    if "v2v_t" in results:
        lines.append(f"V2V Error: {results['v2v_t'] * 1000:.0f} mm")
    if "p2p_t" in results:
        lines.append(f"P2P-20k Error: {results['p2p_t'] * 1000:.0f} mm")
    for k in ("chest", "waist", "hips", "height"):
        if f"{k}_error" in results:
            lines.append(f"{k} Error: {results[f'{k}_error'] * 1000:.0f} mm")
    if "mass_error" in results:
        lines.append(f"mass Error: {results['mass_error']:.0f} kg")
    return "".join(line + "\n" for line in lines)


def plain_errors(fit_t, gt_t, meas_gt, meas_fit, gt_faces, fit_faces,
                 smplx, reg=None) -> dict:
    """The scorer's mean errors through the plain versions on the card,
    all bodies at once."""
    import torch

    from shapy_tpu_torch.eval.metrics import (
        aligned_point_error_plain,
        point_regress_error_plain,
    )

    out = {}
    with torch.inference_mode():
        if smplx:
            out["v2v_t"] = float(aligned_point_error_plain(
                fit_t, gt_t, "translation").mean())
        if reg is not None:
            out["p2p_t"] = float(point_regress_error_plain(
                fit_t, gt_t, reg.indices, reg.weights, reg.indices,
                reg.weights).mean())
        m_gt = meas_gt.forward_plain(gt_t[:, gt_faces])["measurements"]
        m_fit = meas_fit.forward_plain(fit_t[:, fit_faces])["measurements"]
        for k in ("mass",) + MEASURED:
            out[f"{k}_error"] = float((m_gt[k]["tensor"]
                                       - m_fit[k]["tensor"]).abs().mean())
    return out


def points_gradient(meas, fits, dev) -> dict:
    """Phase 6, the slice points' gradient: the scorer's triangle surface
    (``BodyMeasurements.forward`` on ``v[:, faces]`` of the fitted bodies,
    batch 32) differentiated in the vertices through a loss on the
    circumferences and on the chest, waist and hips slice points (the sum
    of their squared coordinates, masked slots included). Checks one
    ``measure_points_backward`` launch per batch and
    a finite, non-zero gradient. Returns its launches."""
    import torch

    faces = meas.faces.long()
    reset_launches()
    batches = 0
    for start in range(0, len(fits), B):
        v = torch.from_numpy(np.ascontiguousarray(
            fits[start:start + B], np.float32)).to(dev).requires_grad_()
        m = meas(v[:, faces])["measurements"]
        loss = sum(m[k]["tensor"].sum() + m[k]["points"].square().sum()
                   for k in PLANE_NAMES)
        grad = torch.autograd.grad(loss, v)[0]
        check(bool(torch.isfinite(grad).all()) and float(grad.abs().max())
              > 0, "slice points' gradient")
        batches += 1
    launches = read_launches()
    check(launches["K1aos_points_backward"] == batches,
          f"{launches['K1aos_points_backward']} points backward launches for "
          f"{batches} batches")
    print(f"score, the slice points' gradient: {batches} batches of {B}; "
          f"launches {launches['K1aos_points_backward']} "
          "measure_points_backward")
    return {"K1aos_points_backward": launches["K1aos_points_backward"]}


def score(regressor, eval_data, dev):
    """Phase 6: the offline HBW scorer on a synthetic submission, through
    ``evaluate_submission``, then ``main`` on the faces-file route (SMPL-X)
    and the model-folder route (SMPL fits) of a release tree written
    here."""
    import contextlib
    import io
    import tempfile

    import torch

    from shapy_tpu_torch.cli.evaluate_hbw import evaluate_submission
    from shapy_tpu_torch.cli.evaluate_hbw import main as score_main
    from shapy_tpu_torch.measure.measurements import BodyMeasurements
    from shapy_tpu_torch.models.body.assets import make_synthetic_model_data

    rng = np.random.default_rng(SEED + 6)
    model, meas, reg = (regressor.model, regressor.body_measurements,
                        eval_data["p2p"])
    betas = rng.normal(size=(SUBMISSION, model.num_betas)) * 1.5
    betas *= np.minimum(1.0, 6.0 / np.linalg.norm(betas, axis=1,
                                                  keepdims=True))
    fit_betas = betas + rng.normal(size=betas.shape) * 0.1
    with torch.inference_mode():
        gt, fits = (model.forward_shape(torch.tensor(
            b, dtype=torch.float32, device=dev))["v_shaped"].cpu().numpy()
            for b in (betas, fit_betas))
    fits = fits + rng.normal(size=fits.shape).astype(np.float32) * 0.002
    labels = [f"test/{i:03d}_synthetic/img.jpg" for i in range(SUBMISSION)]
    lookup = dict(zip(labels, gt))

    reset_launches()
    results = evaluate_submission(labels, fits, lookup.__getitem__,
                                  "smplx", reg, reg, meas, meas,
                                  batch_size=B, device=dev)
    launches = score_launches = read_launches()
    for name in SCORE_KERNELS:
        check(launches[name] > 0, f"{name} was not launched by the scorer")
    batches = -(-SUBMISSION // B)
    # K1-AoS's points: a batch's fits and its GT, each once
    check(launches["K1aos_points"] == 2 * batches,
          f"the scorer: {launches['K1aos_points']} measure_points launches "
          f"for {batches} batches of fits and GT, expected {2 * batches}")
    for name, per in K8_PER_BATCH.items():
        check(launches[name] == per * batches,
              f"the scorer: {launches[name]} {name} launches for {batches} "
              f"batches, expected {per} each")
    score_launches.update(points_gradient(meas, fits, dev))
    check(all(math.isfinite(v) for v in results.values()) and
          len(results) == 7, f"scorer results {results}")
    fit_t = torch.from_numpy(np.ascontiguousarray(fits, np.float32)).to(dev)
    gt_t = torch.from_numpy(gt).to(dev)
    faces = meas.faces.long()
    plain = plain_errors(fit_t, gt_t, meas, meas, faces, faces, True, reg)
    # Tolerances: means of per-body errors summed in another order;
    # lengths 1e-5 m, mass 1e-3 kg (rel 1e-5 of ~100 kg).
    for k, v in plain.items():
        tol = 1e-3 if k == "mass_error" else 1e-5
        check(abs(results[k] - v) <= tol,
              f"scorer {k}: {results[k]} vs plain {v}")
    print(f"score: {SUBMISSION} bodies; V2V {results['v2v_t'] * 1e3:.2f} mm, "
          f"P2P-20k {results['p2p_t'] * 1e3:.2f} mm, "
          + ", ".join(f"{k} {results[k + '_error'] * 1e3:.2f} mm"
                      for k in ("chest", "waist", "hips", "height"))
          + f", mass {results['mass_error']:.3f} kg; launches {launches}; "
          f"max |kernel - plain| "
          f"{max(abs(results[k] - v) for k, v in plain.items()):.2e}")

    # The release routes: the GT as HBW npy files, a faces npz, and
    # synthetic SMPL-X and SMPL release files at the real counts (f32).
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        for i, v in enumerate(gt):
            path = root / "hbw" / "smplx" / "test" / f"{i:03d}.npy"
            path.parent.mkdir(parents=True, exist_ok=True)
            np.save(path, v)
        folder = root / "hbw" / "body_models"
        folder.mkdir()
        smpl_faces = None
        for model_type, subdiv, name in (("smplx", 5, "SMPLX"),
                                         ("smpl", 4, "SMPL")):
            data = make_synthetic_model_data(model_type, subdivisions=subdiv,
                                             exact_counts=True, seed=SEED,
                                             num_shape_dirs=20)
            np.savez(folder / f"{name}_NEUTRAL.npz", **{
                k: a.astype(np.float32) if a.dtype.kind == "f" else a
                for k, a in data.items()})
            if model_type == "smplx":
                np.savez(root / "faces.npz", faces=data["f"])
                xfaces = data["f"]
            else:
                smpl_faces = data["f"]
                smpl_fits = (data["v_template"][None] + np.einsum(
                    "bl,vkl->bvk", fit_betas[:, :10],
                    data["shapedirs"][:, :, :10])).astype(np.float32)
        routes = (
            ("faces file, smplx", "smplx", fits,
             {"faces_path": str(root / "faces.npz")}),
            ("model folder, smpl", "smpl", smpl_fits, {}),
        )
        for what, model_type, sub_v, kw in routes:
            sub = root / f"sub_{model_type}.npz"
            np.savez(sub, image_name=np.asarray(labels), v_shaped=sub_v)
            reset_launches()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = score_main(str(sub), str(root / "hbw"), model_type,
                                device=str(dev), **kw)
            launches = read_launches()
            check(rc == 0, f"scorer main ({what}) returned {rc}")
            for name in ("K1_measure", "K1aos_points") + (
                    ("K8b_align_error",) if model_type == "smplx" else ()):
                check(launches[name] > 0,
                      f"{name} was not launched by main ({what})")
            meas_gt = BodyMeasurements(None, xfaces).to(dev)
            fit_faces = xfaces if model_type == "smplx" else smpl_faces
            meas_fit = (meas_gt if model_type == "smplx" else
                        BodyMeasurements(None, fit_faces,
                                         model_type=model_type).to(dev))
            plain = plain_errors(
                torch.from_numpy(sub_v).to(dev), gt_t, meas_gt, meas_fit,
                torch.from_numpy(xfaces).to(dev),
                torch.from_numpy(fit_faces).to(dev), model_type == "smplx")
            want = score_lines(plain)
            got = buf.getvalue()
            used = {n: launches[n] for n in SCORE_KERNELS}
            print(f"score main ({what}): {got.strip().replace(chr(10), '; ')}"
                  f"; launches {used}")
            check(got == want, f"main ({what}) printed {got!r}, the plain "
                  f"versions give {want!r}")
    return score_launches


def check_train_kernels(model, dev):
    """Phase 2, the training path's K4 at its shapes (batch 48): forward
    and backward on the stem's first BN (64 x 128 x 128) and on a stage-4
    branch-3 BN (384 x 8 x 8), in bf16 and f32, also in each of its two
    regimes. The backward is first held against autograd through the
    plain version in f64, then timed against the plain version's
    backward."""
    import torch
    import torch.nn.functional as F

    from shapy_tpu_torch.models.backbones.layers import (
        _bn_backward_cuda,
        _bn_forward_cuda,
        _bn_plan,
        _bn_plan_regime,
        batch_norm_train,
        batch_norm_train_backward_plain,
        batch_norm_train_plain,
    )

    results = {}
    gen = torch.Generator().manual_seed(SEED + 7)
    Bt = TRAIN_B

    # K4: tolerances rel 1e-4 in f32 (sums in another order), one bf16
    # step (2^-7 of the largest value) in bf16; parameter gradients rel
    # 1e-4 (f32 sums) in both.
    cases = {"K4_bn_forward": [], "K4_bn_backward": []}
    for layer, shape in (("stem bn1", (Bt, 64, 128, 128)),
                         ("stage4 branch3", (Bt, 384, 8, 8))):
        for dtype in (torch.bfloat16, torch.float32):
            C = shape[1]
            x = (torch.randn(shape, generator=gen) * 2 + 0.3).to(dev, dtype)
            x = x.contiguous(memory_format=torch.channels_last)
            dy = torch.randn(shape, generator=gen).to(dev, dtype).contiguous(
                memory_format=torch.channels_last)
            g = (torch.rand(C, generator=gen) + 0.5).to(dev)
            b = torch.randn(C, generator=gen).to(dev)
            rm, rv = torch.zeros(C, device=dev), torch.ones(C, device=dev)
            y_p, mean_p, var_p = batch_norm_train_plain(x, g, b)
            inv_p = torch.rsqrt(var_p + 1e-5)
            name = f"K4 {layer} {str(dtype)[6:]} {tuple(shape)}"
            n, es, R = x.numel(), x.element_size(), x.numel() // C
            # The forward in each regime (the plan picks one by shape: one
            # cluster launch, or partials + finalize + y), first: y, mean
            # and inv each against its limit, before the backward uses them.
            fwd_regimes = {}
            want_f = (y_p, mean_p, inv_p)
            for fused in (True, False):
                plan = _bn_plan_regime(R, C, fused)
                args = (x, g, b, rm.clone(), rv.clone(), 1e-5, 0.1, plan)
                got = _bn_forward_cuda(*args)
                again = _bn_forward_cuda(x, g, b, rm.clone(), rv.clone(),
                                         1e-5, 0.1, plan)
                limits = _k4_forward_limits(got, want_f)
                over = max(limits.values())
                equal = all(torch.equal(u, w) for u, w in zip(got, again))
                regime = "cluster" if fused else "split"
                check(over <= 1.0 and equal,
                      f"{name} {regime} forward at {over:.3f} of its "
                      f"limit (" + ", ".join(
                          f"{k} {v:.3f}" for k, v in limits.items())
                      + f"), two calls equal {equal}")
                fwd_regimes[regime] = {
                    "ms": time_ms(lambda: _bn_forward_cuda(*args)),
                    "over_limit": over, "tiles": plan.tiles,
                    "planned": plan.fused == _bn_plan(R, C, True).fused}
            print(f"{name} forward per regime (planned: "
                  f"{'cluster' if _bn_plan(R, C, True).fused else 'split'}"
                  "): " + ", ".join(
                f"{k} {v['ms']:.4f} ms ({v['tiles']} tiles, "
                f"{v['over_limit']:.3f} of the limit)"
                for k, v in fwd_regimes.items()))
            xs, gs, bs = (t.clone().requires_grad_() for t in (x, g, b))
            y = batch_norm_train(xs, gs, bs, rm, rv)
            dx, dg, db = torch.autograd.grad(y, (xs, gs, bs), dy,
                                             retain_graph=True)
            dx_p, dg_p, db_p = batch_norm_train_backward_plain(
                dy, x, g, mean_p, inv_p)
            tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
            errs = {"y": rel_err(y, y_p), "dx": rel_err(dx, dx_p),
                    "dgamma": rel_err(dg, dg_p), "dbeta": rel_err(db, db_p)}
            tols = {"y": tol, "dx": tol, "dgamma": 1e-4, "dbeta": 1e-4}
            print(f"{name}: rel err " + ", ".join(
                f"{k} {v:.3e} (tol {tols[k]:.1e})" for k, v in errs.items()))
            for k, v in errs.items():
                check(v <= tols[k], f"{name} {k} rel err {v}")
            again = torch.autograd.grad(
                batch_norm_train(xs, gs, bs), (xs, gs, bs), dy)
            check(all(torch.equal(u, w) for u, w in
                      zip((dx, dg, db), again)), f"{name} not deterministic")
            xl, gl, bl = (t.clone().requires_grad_() for t in (x, g, b))
            y_l = F.batch_norm(xl, rm.clone(), rv.clone(), gl, bl, True,
                               0.1, 1e-5)
            common = {"layer": layer, "dtype": str(dtype)[6:],
                      "shape": list(shape)}
            fwd = record_kernel(
                {}, f"K4_bn_forward ({layer}, {common['dtype']})",
                max_err(y, y_p),
                lambda: batch_norm_train(x, g, b, rm, rv),
                lambda: batch_norm_train_plain(x, g, b),
                2 * n * es + 8 * C * 4, 7 * n,
                lambda: F.batch_norm(x, rm, rv, g, b, True, 0.1, 1e-5))
            bwd = record_kernel(
                {}, f"K4_bn_backward ({layer}, {common['dtype']})",
                max(max_err(dx, dx_p), max_err(dg, dg_p), max_err(db, db_p)),
                lambda: torch.autograd.grad(y, (xs, gs, bs), dy,
                                            retain_graph=True),
                lambda: batch_norm_train_backward_plain(dy, x, g, mean_p,
                                                        inv_p),
                3 * n * es + 6 * C * 4, 10 * n,
                lambda: torch.autograd.grad(y_l, (xl, gl, bl), dy,
                                            retain_graph=True))
            # The backward in each regime, as the forward: one cluster
            # launch, or partials + finalize + dx.
            want = (dx_p, dg_p, db_p)
            regimes = {}
            for fused in (True, False):
                plan = _bn_plan_regime(R, C, fused)
                got = _bn_backward_cuda(dy, x, g, mean_p, inv_p, plan)
                again = _bn_backward_cuda(dy, x, g, mean_p, inv_p, plan)
                over = max(_k4_limits(got, want).values())
                equal = all(torch.equal(u, w) for u, w in zip(got, again))
                regime = "cluster" if fused else "split"
                check(over <= 1.0 and equal,
                      f"{name} {regime} backward at {over:.3f} of its "
                      f"limit, two calls equal {equal}")
                regimes[regime] = {
                    "ms": time_ms(lambda: _bn_backward_cuda(
                        dy, x, g, mean_p, inv_p, plan)),
                    "over_limit": over, "tiles": plan.tiles,
                    "planned": plan.fused == _bn_plan(R, C).fused}
            print(f"{name} backward per regime (planned: "
                  f"{'cluster' if _bn_plan(R, C).fused else 'split'}): "
                  + ", ".join(f"{k} {v['ms']:.4f} ms ({v['tiles']} tiles, "
                              f"{v['over_limit']:.3f} of the limit)"
                              for k, v in regimes.items()))
            cases["K4_bn_forward"].append({**common, **fwd,
                                           "rel_err": errs["y"],
                                           "regimes": fwd_regimes})
            cases["K4_bn_backward"].append({**common, **bwd,
                                            "rel_err": max(errs["dx"],
                                                           errs["dgamma"],
                                                           errs["dbeta"]),
                                            "regimes": regimes})
    # The kernels line's numbers: the main path's dtype (bf16) on the
    # largest layer (the stem); every case beside them.
    for name, rows in cases.items():
        results[name] = dict(rows[0], cases=rows)
    return results


def check_saved_hits(meas, v, plane_faces, use_subsets: bool,
                     what: str) -> str:
    """K1's forward (``meas.measure``) on bodies ``v``: the hits and codes
    it saves for the backward, against those the plain slice's masks give
    at the kernel's plane heights (``saved_hits_plain``: points bit-equal,
    in face order; in reference mode the codes' candidate bits are the
    kernel's alone), and a second call's bit-equal. Returns the cluster
    plan and the hits checked, as text."""
    import torch

    from shapy_tpu_torch.measure.measurements import (
        measure_plan,
        saved_hits_plain,
    )

    x = v.clone().requires_grad_()
    vals, heights = meas.measure(x, use_subsets)
    _, hits, codes, stats, _ = vals.grad_fn.saved_tensors
    again = meas.measure(v.clone().requires_grad_(), use_subsets)[0]
    _, hits2, codes2, stats2, _ = again.grad_fn.saved_tensors
    ref = saved_hits_plain(v, meas.faces, plane_faces, heights.detach(),
                           meas.slice_mode)
    keep = ~7 if meas.slice_mode == "reference" else -1
    total = 0
    for b in range(v.shape[0]):
        for p in range(3):
            pts, cds = ref[b][p]
            n = int(stats[b, p, 0])
            check(n == cds.shape[0] and torch.equal(hits[b, p, :n], pts)
                  and torch.equal(codes[b, p, :n] & keep, cds),
                  f"{what}: body {b} plane {p}: the saved hits are not the "
                  "plain slice's in face order")
            check(torch.equal(hits[b, p, :n], hits2[b, p, :n])
                  and torch.equal(codes[b, p, :n], codes2[b, p, :n]),
                  f"{what}: two calls saved other hits")
            total += n
    # stats: per plane the hit count and centroid, the volume sum
    check(torch.equal(vals, again)
          and torch.equal(stats[:, :3, :3], stats2[:, :3, :3])
          and torch.equal(stats[:, 3, 0], stats2[:, 3, 0]),
          f"{what}: two calls differ")
    F = meas.faces.shape[0]
    counts = meas.subset_counts if use_subsets else (F, F, F)
    plan = measure_plan(counts, F, v.shape[0])
    return (f"cluster of {plan.cluster} CTAs, spans {plan.spans} / mass "
            f"{plan.mass_span}; {total} saved hits equal the plain slice's "
            "in face order, two calls bit-equal")


def slice_points(meas, v, slice_mode) -> int:
    """The hits of the three planes over all faces of bodies ``v``, from
    the plain slice on the card (the data-dependent part of K1's work)."""
    import torch

    from shapy_tpu_torch.measure.measurements import PLANES, _soa
    from shapy_tpu_torch.ops.plane_slice import (
        plane_slice_reference_soa,
        plane_slice_soa,
    )

    tx, ty, tz = _soa(v, meas.faces)
    points = 0
    with torch.no_grad():
        for name in PLANES:
            a = getattr(meas.anchors, name)
            h = (ty[:, :, a.face_idx] * torch.tensor(
                a.bary, device=v.device)).sum(-1)
            if slice_mode == "reference":
                _, _, m = plane_slice_reference_soa(ty, tx, tz, h)
            else:
                _, _, m = plane_slice_soa(ty, tx, tz, h)
            points += int(m.sum())
    return points


def check_measure_kernels(model, anchors, dev):
    """Phase 2, the fit's and the train step's measurement kernels on all
    faces, at the train batch (48) and the fit's batches 32 and 1:
    K1-exact's forward against its plain version (mass / height rel 1e-5,
    circumferences 1e-5 m, as K1), and K1's and K1-exact's backwards, for
    a seeded cotangent on all eight outputs and for one on the
    circumferences alone (the mass gradient would otherwise set the
    scale). Then (``check_measure_backward_routes``) two bodies of which
    one has no hit on any plane, the hits past the backward's records, and
    the kernel's bits against its replay.

    The hull's max and min are not differentiable where two hits' support
    values tie, and at batch 48 some directions have two distinct hits
    whose projections differ by less than the rounding of the centroid's
    sum: a plain version that sums the centroid in another order sends
    such a direction's gradient to the other hit. So the backward is held
    (1) against autograd through the plain version in f32 given the
    kernel's own centroids (``saved_centroids``), on every vertex, within
    1e-4 of the largest gradient (in exact mode y - h cancels near the
    plane and the two sides order that formula's terms differently:
    3.2e-5 measured on the CPU), and (2) against autograd through the
    plain version in f64 with its own centroids, on at least 99.8% of the
    vertices within 1e-4 (the rest are vertices of hits at such ties, or
    at hit tests that f64 decides the other way). Two calls give the same
    bits. Times each beside the plain version (the backward's in f64)."""
    import torch

    from shapy_tpu_torch.measure.measurements import (
        BodyMeasurements,
        measure_plain,
        saved_centroids,
    )

    gen = torch.Generator().manual_seed(SEED + 10)
    K = 256
    cases = {"K1_measure": [], "K1_measure_backward": [],
             "K1exact_measure": [], "K1exact_measure_backward": []}
    for batch in (TRAIN_B, FIT_B, 1):
        betas = torch.randn((batch, model.num_betas), generator=gen) * 1.5
        v = model.forward_shape(betas.to(dev))["v_shaped"].detach()
        v = v.contiguous()
        g_all = (torch.randn((batch, 5), generator=gen).to(dev),
                 torch.randn((batch, 3), generator=gen).to(dev))
        g_circ = (g_all[0] * torch.tensor([0.0, 0.0, 1.0, 1.0, 1.0],
                                          device=dev),
                  torch.zeros_like(g_all[1]))
        for mode in ("reference", "exact"):
            meas = BodyMeasurements(anchors, model.faces, K,
                                    slice_mode=mode).to(dev)

            def plain(t, centroids=None, meas=meas, mode=mode):
                return measure_plain(t, meas.faces, None, meas.anchors, K,
                                     meas.density, mode, centroids)

            x = v.clone().requires_grad_()
            outs = meas.measure(x, use_face_subsets=False)
            cents = saved_centroids(outs[0]).detach()
            want, _ = plain(v)
            torch.cuda.synchronize()
            fwd_rel = float(((outs[0][:, :2].detach() - want[:, :2]).abs()
                             / want[:, :2].abs()).max())
            fwd_circ = max_err(outs[0][:, 2:], want[:, 2:])
            err32, err64, share = {}, {}, {}
            grads = []
            for which, (gv, gh) in (("all", g_all), ("circ", g_circ)):
                got = torch.autograd.grad(outs, x, (gv, gh),
                                          retain_graph=True)[0]
                grads.append(got)
                xp = v.clone().requires_grad_()
                w32 = torch.autograd.grad(plain(xp, cents), xp, (gv, gh))[0]
                err32[which] = max_err(got, w32) / float(w32.abs().max())
                xp = v.double().requires_grad_()
                w64 = torch.autograd.grad(plain(xp), xp,
                                          (gv.double(), gh.double()))[0]
                per_v = ((got.double() - w64).abs().amax(-1)
                         / float(w64.abs().max()))
                err64[which] = float(per_v.max())
                share[which] = float((per_v <= 1e-4).double().mean())
            x2 = v.clone().requires_grad_()
            again = torch.autograd.grad(meas.measure(x2, False), x2, g_all)[0]
            same = torch.equal(grads[0], again)
            name = "K1" if mode == "reference" else "K1-exact"
            print(f"{name} all faces, batch {batch}: forward mass/height rel "
                  f"err {fwd_rel:.3e} (tol 1e-5), circumference err "
                  f"{fwd_circ:.3e} m (tol 1e-5); backward (all outputs / "
                  f"circumferences), of the largest gradient: vs plain f32 "
                  f"with the kernel's centroids {err32['all']:.3e} / "
                  f"{err32['circ']:.3e} (tol 1e-4); vs plain f64 max "
                  f"{err64['all']:.3e} / {err64['circ']:.3e}, vertices "
                  f"within 1e-4 {share['all']:.5f} / {share['circ']:.5f} "
                  f"(tol 0.998); two runs bit-equal: {same}")
            check(fwd_rel <= 1e-5 and fwd_circ <= 1e-5, f"{name} forward")
            check(max(err32.values()) <= 1e-4,
                  f"{name} backward vs plain f32: {err32}")
            check(min(share.values()) >= 0.998,
                  f"{name} backward vs plain f64: {share}")
            check(same, f"{name} backward is not deterministic")
            check(bool((want[:, 2:] > 0.5).all()), f"{name} empty slices")
            print(f"{name} all faces, batch {batch}: " + check_saved_hits(
                meas, v, None, False, f"{name} forward"))

            points = slice_points(meas, v, mode)
            F, n_v = meas.faces.shape[0], v.numel()
            x64 = v.double().requires_grad_()
            p64 = plain(x64)
            g64 = tuple(g.double() for g in g_all)
            bwd = record_kernel(
                {}, f"{name} backward (batch {batch})", max(err32.values()),
                lambda: torch.autograd.grad(outs, x, g_all,
                                            retain_graph=True),
                lambda: torch.autograd.grad(p64, x64, g64,
                                            retain_graph=True),
                # vertices in, gradient out, faces, the saved hits (point
                # and code); the mass term's three cross products per
                # face, the hull's share per (hit, direction pair) and
                # each hit's chain
                2 * n_v * 4 + F * 12 + points * 12 + batch * 8 * 4,
                batch * F * 36 + points * ((K // 2) * 8 + 150))
            row = {"batch": batch, **bwd, "rel_err_f32": err32,
                   "rel_err_f64_max": err64, "share_within_1e-4_f64": share}
            # the forward on all faces (the fit's and training's)
            fwd = record_kernel(
                {}, f"{name} forward (all faces, batch {batch})",
                max_err(outs[0], want),
                lambda: meas.measure(v, False), lambda: plain(v),
                # the signed volume of every face (17 FLOP), the crossing
                # tests per (face, plane) (reference: ~150 FLOP for the
                # ordered hit tests; exact: ~12), 8 per slice point and 5
                # per (point, direction pair) for the hull
                n_v * 4 + F * 12 + batch * 8 * 4,
                batch * F * (17 + 3 * (150 if mode == "reference" else 12))
                + points * (8 + (K // 2) * 5))
            key = "K1" if mode == "reference" else "K1exact"
            cases[f"{key}_measure_backward"].append(row)
            cases[f"{key}_measure"].append({"batch": batch, "faces": "all",
                                            **fwd})
            del p64, x64
    check_measure_backward_routes(model, anchors, dev)
    # The kernels line's numbers: the train batch; batches 32 and 1 beside
    # them. K1's forward keeps phase 2's subsets row; these are its cases.
    k1_cases = cases.pop("K1_measure")
    out = {name: dict(rows[0], cases=rows) for name, rows in cases.items()}
    out["K1_measure_cases"] = k1_cases
    return out


def check_measure_backward_routes(model, anchors, dev) -> None:
    """K1's and K1-exact's backward on all faces where a plain comparison
    is blind:

    * two bodies, the second flattened to the height of its first vertex,
      so that none of its planes has a hit in either slice mode (no face
      crosses a plane, no quad edge meets a face): its circumferences are
      0 and, for a cotangent on the circumferences alone, its gradient is
      0; the first's within 1e-4 of the largest gradient of the plain
      version in f32 given the kernel's centroids;
    * the hits past the records (``measure_backward_plan``'s ``records``
      cut to 16 a row, so that the vertices pass takes nearly every hit
      again from the saved hits): the same bits as the records' route, at
      batch 1 and 48;
    * ``measure_backward_replay``: the kernel's operations in its order, in
      PyTorch on the card, bit-equal to the kernel at batch 1, 32 and 48
      for the seeded cotangent on all eight outputs;
    * the backward of saves whose chest centroid is moved 1 m along x, off
      the hits, so that the clamp max(h, 0) holds on about half the
      direction pairs and the centroid's share of the point cotangents is
      large (for the hits' own centroid it is 0 but for rounding: the
      perimeter does not move when every point does): bit-equal to the
      replay and within 1e-4 of the largest gradient of the plain version
      in f32 given the same centroids, at batch 1 and 32."""
    import torch

    from shapy_tpu_torch.measure import measurements as mm

    gen = torch.Generator().manual_seed(SEED + 12)
    K = 256
    for mode in ("reference", "exact"):
        meas = mm.BodyMeasurements(anchors, model.faces, K,
                                   slice_mode=mode).to(dev)
        name = "K1" if mode == "reference" else "K1-exact"
        betas = torch.randn((2, model.num_betas), generator=gen) * 1.5
        v = model.forward_shape(betas.to(dev))["v_shaped"].detach().clone()
        v[1, :, 1] = v[1, 0, 1]
        g = (torch.randn((2, 5), generator=gen).to(dev)
             * torch.tensor([0.0, 0.0, 1.0, 1.0, 1.0], device=dev),
             torch.zeros((2, 3), device=dev))
        x = v.clone().requires_grad_()
        outs = meas.measure(x, use_face_subsets=False)
        cents = mm.saved_centroids(outs[0]).detach()
        got = torch.autograd.grad(outs, x, g)[0]
        xp = v.clone().requires_grad_()
        want = torch.autograd.grad(mm.measure_plain(
            xp, meas.faces, None, meas.anchors, K, meas.density, mode,
            cents), xp, g)[0]
        err = max_err(got, want) / float(want.abs().max())
        empty = float(outs[0][1, 2:].abs().max())
        stray = float(got[1].abs().max())
        print(f"{name} backward, a body with no hit on any plane: its "
              f"circumferences {empty}, its gradient's largest {stray} (both "
              f"0); the other body vs plain f32 {err:.3e} (tol 1e-4)")
        check(empty == 0.0 and stray == 0.0 and err <= 1e-4,
              f"{name} backward with a plane of fewer than 2 hits: "
              f"circumferences {empty}, gradient {stray}, err {err}")

        for batch in (1, FIT_B, TRAIN_B):
            betas = torch.randn((batch, model.num_betas), generator=gen) * 1.5
            v = model.forward_shape(betas.to(dev))["v_shaped"].detach()
            v = v.contiguous()
            g = (torch.randn((batch, 5), generator=gen).to(dev),
                 torch.randn((batch, 3), generator=gen).to(dev))
            x = v.clone().requires_grad_()
            outs = meas.measure(x, use_face_subsets=False)
            got = torch.autograd.grad(outs, x, g, retain_graph=True)[0]
            replay = mm.measure_backward_replay(
                meas, x, outs[0].grad_fn.saved_tensors[1:], g, False)
            same = torch.equal(got, replay)
            differ = int((got != replay).any(-1).sum())
            line = (f"{name} backward, batch {batch}: bit-equal to its "
                    f"replay: {same} ({differ} vertices differ)")
            check(same, f"{name} backward at batch {batch} is not its "
                        f"replay's bits: {differ} vertices differ")
            if batch != FIT_B:
                records = mm._K1B_RECORDS
                mm._K1B_RECORDS = 16
                try:
                    past = torch.autograd.grad(outs, x, g)[0]
                finally:
                    mm._K1B_RECORDS = records
                check(torch.equal(got, past),
                      f"{name} backward at batch {batch}: the hits past "
                      "the records give other bits")
                line += "; hits past 16 records a row: the same bits"
            print(line)

        for batch in (1, FIT_B):  # the chest centroid off the hits
            betas = torch.randn((batch, model.num_betas), generator=gen) * 1.5
            v = model.forward_shape(betas.to(dev))["v_shaped"].detach()
            v = v.contiguous()
            g = (torch.randn((batch, 5), generator=gen).to(dev),
                 torch.randn((batch, 3), generator=gen).to(dev))
            x = v.clone().requires_grad_()
            outs = meas.measure(x, use_face_subsets=False)
            hits, codes, stats, plane_h = outs[0].grad_fn.saved_tensors[1:]
            moved = stats.clone()
            moved[:, 0, 1] += 1.0
            saved = (hits, codes, moved, plane_h)
            got = mm.measure_backward(meas, meas._vertex_walk(False), v,
                                      saved, *g)
            replay = mm.measure_backward_replay(meas, v, saved, g, False)
            differ = int((got != replay).any(-1).sum())
            xp = v.clone().requires_grad_()
            want = torch.autograd.grad(mm.measure_plain(
                xp, meas.faces, None, meas.anchors, K, meas.density, mode,
                moved[:, :3, 1:3]), xp, g)[0]
            err = max_err(got, want) / float(want.abs().max())
            print(f"{name} backward, batch {batch}, the chest centroid 1 m "
                  f"off the hits: bit-equal to its replay: {differ == 0} "
                  f"({differ} vertices differ); vs plain f32 {err:.3e} (tol "
                  "1e-4)")
            check(differ == 0 and err <= 1e-4,
                  f"{name} backward with a centroid off the hits: {differ} "
                  f"vertices differ from the replay, err {err}")

def check_aos_kernel(model, anchors, dev):
    """Phase 2, K1-AoS at the scorer's shapes: full-width SMPL-X
    triangles ``v[:, faces]`` of batch 32, all faces, both slice modes,
    against the plain AoS version (``forward_plain``) on the card:
    circumferences within 1e-5 m, mass and height rel 1e-5, masks equal,
    points bit-equal in reference mode and within 1e-6 m in exact mode
    (y recomputed from the crossed edge), height points exact; the values
    bit-equal to K1 from the vertices on all faces (the same faces in the
    same order); the backward within 1e-4 of the largest gradient of
    autograd through K1's plain version on the triangles in f32 given the
    kernel's centroids, and in f64 per mesh vertex (the triangles'
    gradients summed) on at least 99.8% of the vertices, as K1's check.
    ``measure_points`` on the forward's saves as
    :func:`check_points_kernel`, then timed alone beside the plain AoS
    slices (its bound: the points and masks written once, the hits read
    once); the walk (K1 alone on the triangles) and the whole forward
    timed too. Then ``measure_points_backward``
    (:func:`check_points_backward`) and the small cases
    (:func:`check_points_cases`)."""
    import torch

    from shapy_tpu_torch.measure.measurements import (
        BodyMeasurements,
        _MeasureKernel,
        measure_plain,
        measure_points,
        saved_centroids,
    )
    from shapy_tpu_torch.ops.plane_slice import (
        plane_slice_reference,
        plane_slice_triangles,
    )

    gen = torch.Generator().manual_seed(SEED + 12)
    K = 256
    betas = torch.randn((B, model.num_betas), generator=gen) * 1.5
    v = model.forward_shape(betas.to(dev))["v_shaped"].detach().contiguous()
    faces = model.faces_tensor.long()
    tri = v[:, faces].contiguous()
    F = faces.shape[0]
    keys = ("mass", "height", "chest", "waist", "hips")
    g_vals = torch.randn((B, 5), generator=gen).to(dev)
    rows, back_rows = [], []
    for mode in ("reference", "exact"):
        meas = BodyMeasurements(anchors, model.faces, K,
                                slice_mode=mode).to(dev)
        x = tri.clone().requires_grad_()
        got = meas(x)["measurements"]
        saved = saved_measure_tensors(got["mass"]["tensor"])
        with torch.no_grad():
            want = meas.forward_plain(tri)["measurements"]
            soa = meas.forward_from_vertices(v, use_face_subsets=False)[
                "measurements"]
        torch.cuda.synchronize()
        rel = max(rel_err(got[k]["tensor"], want[k]["tensor"])
                  for k in ("mass", "height"))
        circ = max(max_err(got[k]["tensor"], want[k]["tensor"])
                   for k in PLANE_NAMES)
        masks = all(torch.equal(got[k]["valid_points"],
                                want[k]["valid_points"])
                    for k in PLANE_NAMES)
        pts = max(max_err(got[k]["points"], want[k]["points"])
                  for k in PLANE_NAMES)
        pts_equal = all(torch.equal(got[k]["points"], want[k]["points"])
                        for k in PLANE_NAMES)
        heads = torch.equal(got["height"]["points"], want["height"]["points"])
        same_k1 = all(torch.equal(got[k]["tensor"], soa[k]["tensor"])
                      for k in keys)
        hits = sum(int(got[k]["valid_points"].sum()) for k in PLANE_NAMES)
        cents = saved_centroids(got["mass"]["tensor"]._base).detach()
        grad = torch.autograd.grad(sum(
            (g_vals[:, i] * got[k]["tensor"]).sum()
            for i, k in enumerate(keys)), x)[0]

        def identity_plain(t, centroids=None):
            return measure_plain(t.reshape(B, 3 * F, 3), torch.arange(
                3 * F, device=dev).view(F, 3), None, meas.anchors, K,
                meas.density, mode, centroids)[0]

        xp = tri.clone().requires_grad_()
        w32 = torch.autograd.grad((identity_plain(xp, cents)
                                   * g_vals).sum(), xp)[0]
        err32 = max_err(grad, w32) / float(w32.abs().max())
        xp = tri.double().requires_grad_()
        w64 = torch.autograd.grad((identity_plain(xp)
                                   * g_vals.double()).sum(), xp)[0]

        def per_vertex(g):
            out = torch.zeros((B, v.shape[1], 3), dtype=torch.float64,
                              device=dev)
            return out.index_add_(1, faces.reshape(-1),
                                  g.double().reshape(B, 3 * F, 3))

        gv, wv = per_vertex(grad), per_vertex(w64)
        share = float(((gv - wv).abs().amax(-1) / float(wv.abs().max())
                       <= 1e-4).double().mean())
        name = "K1-AoS" if mode == "reference" else "K1-AoS exact"
        print(f"{name} batch {B}, all {F} faces: mass/height rel err "
              f"{rel:.3e} (tol 1e-5), circumference err {circ:.3e} m "
              f"(tol 1e-5), masks equal {masks}, points err {pts:.3e} m "
              f"(bit-equal {pts_equal}; tol: reference bit-equal, exact "
              f"1e-6), height points equal {heads}, {hits} slice points, "
              f"values bit-equal to K1 from the vertices {same_k1}; "
              f"backward of the largest gradient: vs plain f32 with the "
              f"kernel's centroids {err32:.3e} (tol 1e-4), vs plain f64 "
              f"vertices within 1e-4 {share:.5f} (tol 0.998)")
        check(rel <= 1e-5 and circ <= 1e-5, f"{name} values")
        check(masks and heads, f"{name} masks / height points")
        check(pts_equal if mode == "reference" else pts <= 1e-6,
              f"{name} points err {pts}")
        check(same_k1, f"{name} values differ from K1 on the same faces")
        check(err32 <= 1e-4, f"{name} backward vs plain f32: {err32}")
        check(share >= 0.998, f"{name} backward vs plain f64: {share}")
        check(all(float(got[k]["tensor"].detach().min()) > 0.5
                  for k in PLANE_NAMES), f"{name} empty slices")

        walk = meas._triangle_walk(F, tri.device,
                                   tuple(meas.anchors.ordered()), (F,) * 3)
        k1_ms = time_ms(lambda: _MeasureKernel.apply(
            tri.view(B, 3 * F, 3), meas, walk, False))
        forward_ms = time_ms(lambda: meas(tri))
        # The walk's bound: the triangles read once; K1's operations on all
        # faces (the signed volume, the crossing tests per (face, plane),
        # 8 per slice point and 5 per (point, direction pair) for the hull).
        walk_bound, walk_by = bound(
            tri.numel() * 4, B * F * (17 + 3 * (150 if mode == "reference"
                                                else 12))
            + hits * (8 + (K // 2) * 5))
        check_points_kernel(saved, mode, got, PLANE_NAMES,
                            f"{name} points (batch {B})")
        # Bytes: the points and masks written once, each hit's point and
        # code read once and, in exact mode, its crossed edge's two y;
        # operations: ~8 per exact-mode hit for its y.
        exact = mode == "exact"
        mask_bytes = B * 3 * (F if exact else 2 * F)
        plane_h = saved[4]
        fn = plane_slice_triangles if exact else plane_slice_reference
        row = record_kernel(
            {}, f"{name} points (batch {B}, all faces)", pts,
            lambda: measure_points(saved, mode),
            lambda: [fn(tri, plane_h[:, p]) for p in range(3)],
            B * 3 * 6 * F * 4 + mask_bytes + hits * (12 + (8 if exact
                                                         else 0)),
            hits * 8 if exact else 0, plain_iters=5)
        device_ms, kernels_a_call = device_time(
            lambda: measure_points(saved, mode))
        check(kernels_a_call == 1,
              f"{name} points: {kernels_a_call} device kernels a call")
        row = dict(row, mode=mode, batch=B, device_ms=device_ms,
                   device_kernels=kernels_a_call, walk_ms=k1_ms,
                   walk_bound_ms=walk_bound, walk_bound_by=walk_by,
                   forward_ms=forward_ms, slice_points=hits,
                   rel_err_mass_height=rel, backward_rel_err_f32=err32,
                   backward_share_f64=share)
        print(f"{name}: the walk (K1 alone on the triangles) {k1_ms:.4f} ms "
              f"(bound {walk_bound:.4f}, {walk_by}), the whole forward "
              f"{forward_ms:.4f} ms; measure_points {row['ms']:.4f} ms in a "
              f"window, {device_ms:.4f} ms of device time, "
              f"{kernels_a_call} device kernel a call")
        rows.append(row)
        del x, got, want, w64, xp
        back_rows.append(check_points_backward(meas, tri, mode, gen))
    for mode in ("reference", "exact"):
        check_points_cases(model, anchors, mode, gen, dev)
    return {"K1aos_points": dict(rows[0], cases=rows),
            "K1aos_points_backward": dict(back_rows[0], cases=back_rows)}


def saved_measure_tensors(value):
    """What K1-AoS's forward saved for its backward (vertices, hits,
    codes, stats, plane heights), from one of its output values."""
    return value._base.grad_fn.saved_tensors


def points_fill_scatter(saved, slice_mode: str):
    """The slice points as the parent's ``measure_points`` laid them out,
    whole rows at once and independent of any tile: every slot filled
    ((0, h, 0) in reference mode, 0 in exact mode), then each saved hit
    scattered to its slot by its code (exact mode: y recomputed from its
    crossed edge, ``measurements._crossed_y``). Returns (points (B, 3,
    6F), masks)."""
    import torch

    from shapy_tpu_torch.measure.measurements import _crossed_y

    verts, hits, codes, stats, plane_h = saved[:5]
    B, F = verts.shape[0], verts.shape[1] // 3
    exact = slice_mode == "exact"
    pts = torch.zeros((B, 3, 2 * F, 3), device=verts.device)
    if not exact:
        pts[..., 1] = plane_h[..., None]
    valid = torch.zeros((B, 3, F if exact else 2 * F), dtype=torch.bool,
                        device=verts.device)
    counts = stats[:, :3, 0].long().tolist()
    for b in range(B):
        for p in range(3):
            k = counts[b][p]
            code, hit = codes[b, p, :k].long(), hits[b, p, :k]
            pos, detail = code >> 4, code & 15
            if exact:
                y = _crossed_y(verts[b].expand(k, -1, -1), pos, detail,
                               plane_h[b, p].expand(k))
                pts[b, p, 2 * pos + (detail >> 2)] = torch.stack(
                    [hit[:, 0], y, hit[:, 1]], -1)
                valid[b, p, pos] = True
            else:
                slot = (detail >> 3) * F + pos
                pts[b, p, slot, 0] = hit[:, 0]
                pts[b, p, slot, 2] = hit[:, 1]
                valid[b, p, slot] = True
    return pts.reshape(B, 3, 6 * F), valid


def check_points_kernel(saved, mode, got, planes, what: str) -> None:
    """``measure_points`` on a K1-AoS forward's saves: bit-equal, in every
    row (unwalked ones too), to ``measure_points_replay`` (tile by tile),
    to :func:`points_fill_scatter` (the parent kernel's layout, whole
    rows) and to a second call; the forward's outputs its rows for
    ``planes``; one device kernel a call."""
    import torch

    from shapy_tpu_torch.measure.measurements import (
        measure_points,
        measure_points_replay,
    )

    points, valid = measure_points(saved, mode)
    again = measure_points(saved, mode)
    replay = measure_points_replay(saved, mode)
    scatter = points_fill_scatter(saved, mode)
    same = {"replay": replay, "fill and scatter": scatter, "again": again}
    for k, (p2, v2) in same.items():
        check(torch.equal(points, p2) and torch.equal(valid, v2),
              f"{what}: measure_points differs from {k}")
    for p, k in enumerate(planes):
        check(torch.equal(points[:, p].reshape(got[k]["points"].shape),
                          got[k]["points"]) and torch.equal(
                              valid[:, p], got[k]["valid_points"]),
              f"{what}: the forward's {k} points")
    _, kernels_a_call = device_time(lambda: measure_points(saved, mode), 1)
    check(kernels_a_call == 1,
          f"{what}: measure_points ran {kernels_a_call} device kernels")
    print(f"{what}: measure_points bit-equal to its replay, to the fill and "
          f"scatter and to a second call; {kernels_a_call} device kernel")


def check_points_backward_kernel(saved, mode, counts, gen, what: str):
    """``measure_points_backward`` on a K1-AoS forward's saves with a
    seeded cotangent: the triangles' gradient and the plane heights'
    cotangent bit-equal to ``measure_points_backward_replay`` (the
    gradient's per-face arithmetic is the parent kernel's, ``g_h`` in the
    new fixed order) and to a second call's; nothing through a plane
    that walks no faces; at most two device kernels a call. Returns the
    cotangent, the gradient and ``g_h``."""
    import torch

    from shapy_tpu_torch.measure.measurements import (
        measure_points_backward,
        measure_points_backward_replay,
    )

    verts = saved[0]
    B, F = verts.shape[0], verts.shape[1] // 3
    g_points = torch.randn((B, 3, 6 * F), generator=gen).to(verts.device)
    grad, g_h = measure_points_backward(saved, g_points, counts, mode)
    r_grad, r_h = measure_points_backward_replay(saved, g_points, counts,
                                                 mode)
    a_grad, a_h = measure_points_backward(saved, g_points, counts, mode)
    check(torch.equal(grad, r_grad), f"{what}: the gradient differs from "
          "measure_points_backward_replay")
    check(torch.equal(g_h, r_h), f"{what}: g_h differs from "
          "measure_points_backward_replay")
    check(torch.equal(grad, a_grad) and torch.equal(g_h, a_h),
          f"{what}: two calls differ")
    for p, n in enumerate(counts):
        check(n or not bool(g_h[:, p].any()),
              f"{what}: g_h through unwalked plane {p}")
    _, kernels_a_call = device_time(
        lambda: measure_points_backward(saved, g_points, counts, mode), 1)
    check(kernels_a_call <= 2, f"{what}: measure_points_backward ran "
          f"{kernels_a_call} device kernels")
    print(f"{what}: measure_points_backward bit-equal to its replay (the "
          f"gradient and g_h) and to a second call; {kernels_a_call} device "
          "kernels")
    return g_points, grad, g_h


def points_plain_f64(meas, tri, plane_heights: dict) -> dict:
    """The slice points of ``tri`` through the plain AoS slice in f64,
    differentiable, at the given (f32) plane heights: each height's value
    is pinned, its gradient flows to the anchor triangle in f64. The
    points are a function of the plane height that the forward computed
    once in f32; near-horizontal crossed edges make their gradient
    ill-conditioned in it (a height one f32 rounding away can move the
    gradient by more than the check's 1e-5), so the reference takes the
    forward's heights, as K1's backward is held against the plain version
    given the kernel's centroids. Returns {plane: (points, mask)} for the
    planes of ``plane_heights``."""
    from shapy_tpu_torch.core.geometry import face_barycentric_point
    from shapy_tpu_torch.ops.plane_slice import (
        plane_slice_reference,
        plane_slice_triangles,
    )

    out = {}
    for k, height in plane_heights.items():
        anchor = getattr(meas.anchors, k)
        h = face_barycentric_point(tri, anchor.face_idx, anchor.bary)[..., 1]
        h = h + (height.to(h.dtype) - h).detach()
        fn = (plane_slice_reference if meas.slice_mode == "reference"
              else plane_slice_triangles)
        out[k] = fn(tri, h)
    return out


def points_grad_vs_f64(meas, tri, got, planes, gen) -> tuple:
    """The gradient in ``tri`` of a seeded weighted sum of the slice
    points of ``planes`` (masked slots included) through the forward
    ``got`` (K1-AoS, its backward ``measure_points_backward``) against
    autograd through the plain AoS slice in f64 at the forward's plane
    heights (:func:`points_plain_f64`): (masks equal to the f64 plain
    version's, error over the largest gradient, the weights)."""
    import torch

    x = got[planes[0]]["points"]
    w = {k: torch.randn(got[k]["points"].shape, generator=gen).to(x.device)
         for k in planes}
    grad = torch.autograd.grad(sum((w[k] * got[k]["points"]).sum()
                                   for k in planes), tri)[0]
    x64 = tri.detach().double().requires_grad_()
    want = points_plain_f64(meas, x64, {
        k: got[k]["plane_height"].detach() for k in planes})
    masks = all(torch.equal(got[k]["valid_points"], want[k][1])
                for k in planes)
    want_g = torch.autograd.grad(sum((w[k].double() * want[k][0]).sum()
                                     for k in planes), x64)[0]
    return masks, max_err(grad, want_g) / float(want_g.abs().max()), w


def check_points_backward(meas, tri, mode, gen):
    """Phase 2, ``measure_points_backward`` at the scorer's shapes: the
    gradient of a weighted sum of the slice points (masked slots
    included) in the triangles, against autograd through the plain AoS
    slice in f64 at the forward's plane heights (its masks must equal the
    kernel's: the same hits), within 1e-5 of the largest gradient; on the
    forward's saves :func:`check_points_backward_kernel`. Times the kernel
    alone, and the plain version's backward in f32. The bound: in
    reference mode the triangles and the whole points' cotangent read
    (every slot's y is the plane height), the gradient written; in exact
    mode only the cotangent's 32-byte sectors that the hit slots touch
    (an unhit slot is the constant 0)."""
    import torch

    from shapy_tpu_torch.measure.measurements import measure_points_backward

    Bt, F = tri.shape[:2]
    x = tri.clone().requires_grad_()
    got = meas(x)["measurements"]
    saved = saved_measure_tensors(got["mass"]["tensor"])
    masks, err, w = points_grad_vs_f64(meas, x, got, PLANE_NAMES, gen)
    name = "K1-AoS points backward" + (" exact" if mode == "exact" else "")
    print(f"{name} batch {Bt}, all {F} faces: masks equal to plain f64 "
          f"{masks}; of the largest gradient vs plain f64 {err:.3e} "
          "(tol 1e-5)")
    check(masks, f"{name}: the f64 plain version's hits differ")
    check(err <= 1e-5, f"{name} vs plain f64: {err}")
    g_points, _, _ = check_points_backward_kernel(
        saved, mode, (F,) * 3, gen, f"{name} (batch {Bt})")

    xp = tri.clone().requires_grad_()
    plain = meas.forward_plain(xp)["measurements"]
    plain_loss = sum((w[k] * plain[k]["points"]).sum() for k in PLANE_NAMES)
    hits = sum(int(got[k]["valid_points"].sum()) for k in PLANE_NAMES)
    if mode == "exact":
        valid = torch.stack([got[k]["valid_points"] for k in PLANE_NAMES], 1)
        b, p, f = valid.nonzero(as_tuple=True)
        start = ((b * 3 + p) * 6 * F + 6 * f) * 4  # slots 2f, 2f + 1
        g_bytes = 32 * torch.cat([start // 32, (start + 23) // 32]
                                 ).unique().numel()
    else:
        g_bytes = g_points.numel() * 4
    # Bytes: the triangles read once, the gradient written once, g_h, and
    # the cotangent's bytes above; operations: ~100 per hit for its VJP.
    row = record_kernel(
        {}, f"{name} (batch {Bt}, all faces)", err,
        lambda: measure_points_backward(saved, g_points, (F,) * 3, mode),
        lambda: torch.autograd.grad(plain_loss, xp, retain_graph=True),
        g_bytes + 2 * tri.numel() * 4 + Bt * 3 * 4, hits * 100,
        plain_iters=5)
    device_ms, kernels_a_call = device_time(
        lambda: measure_points_backward(saved, g_points, (F,) * 3, mode))
    print(f"{name}: {device_ms:.4f} ms of device time, {kernels_a_call} "
          f"device kernels a call, cotangent bytes read {g_bytes / 1e6:.2f} "
          "MB")
    return dict(row, mode=mode, batch=Bt, masks_equal=masks,
                device_ms=device_ms, device_kernels=kernels_a_call,
                cotangent_bytes=g_bytes)


# K1-AoS's points at the shapes where a row does not start on 16 bytes,
# at batch 1, with a row of no hit and with a plane that walks no faces:
# (name, batch, faces kept, forward keywords). 20907 faces: odd (points
# rows of odd index start 8 bytes off); 20906: F % 8 = 6 (the reference
# masks' rows start off 16 bytes); "no hit": the second body flattened
# onto one height, so that no plane cuts it.
POINTS_CASES = (("odd F", 3, 20907, {}), ("F % 8 = 6", 2, 20906, {}),
                ("batch 1", 1, None, {}), ("no hit", 3, None, {}),
                ("unwalked waist", 2, None, {"compute_waist": False}))


def check_points_cases(model, anchors, mode, gen, dev) -> None:
    """Phase 2, K1-AoS's points and their backward in ``POINTS_CASES`` on
    the flagship's SMPL-X: masks equal to the plain AoS version's, points
    bit-equal to it (reference mode) or within 1e-6 m (exact mode); the
    kernels on the saves as :func:`check_points_kernel` and
    :func:`check_points_backward_kernel`; the gradient through the
    forward within 1e-5 of the largest of the f64 plain version's."""
    import torch

    from shapy_tpu_torch.measure.measurements import BodyMeasurements

    meas = BodyMeasurements(anchors, model.faces, 256,
                            slice_mode=mode).to(dev)
    faces = model.faces_tensor.long()
    for what, batch, keep, kwargs in POINTS_CASES:
        betas = torch.randn((batch, model.num_betas), generator=gen) * 1.5
        v = model.forward_shape(betas.to(dev))["v_shaped"].detach().clone()
        if what == "no hit":
            v[1, :, 1] = v[1, 0, 1]
        tri = v[:, faces][:, :keep].contiguous()
        F = tri.shape[1]
        x = tri.clone().requires_grad_()
        got = meas(x, **kwargs)["measurements"]
        with torch.no_grad():
            want = meas.forward_plain(tri, **kwargs)["measurements"]
        planes = [k for k in PLANE_NAMES if k in got]
        name = f"K1-AoS points {mode}, {what} (batch {batch}, {F} faces)"
        masks = all(torch.equal(got[k]["valid_points"],
                                want[k]["valid_points"]) for k in planes)
        err = max(max_err(got[k]["points"], want[k]["points"])
                  for k in planes)
        empty = [bool(got[k]["valid_points"][b].any())
                 for k in planes for b in range(batch)].count(False)
        check(masks and (err == 0 if mode == "reference" else err <= 1e-6),
              f"{name}: masks equal {masks}, points err {err}")
        check(empty == (3 if what == "no hit" else 0),
              f"{name}: {empty} rows without a hit")
        saved = saved_measure_tensors(got["mass"]["tensor"])
        check_points_kernel(saved, mode, got, planes, name)
        counts = tuple(F if p < len(planes) else 0 for p in range(3))
        check_points_backward_kernel(saved, mode, counts, gen, name)
        f64_masks, f64_err, _ = points_grad_vs_f64(meas, x, got, planes, gen)
        check(f64_masks and f64_err <= 1e-5,
              f"{name}: backward vs plain f64 {f64_err}")
        print(f"{name}: masks equal, points err {err:.3e}, {empty} rows "
              f"without a hit; backward vs plain f64 {f64_err:.3e} of the "
              "largest (tol 1e-5)")


def served_input(requests):
    """The backbone's input of the served request: the bf16 crops of
    ``requests``, channels_last NCHW."""
    import torch

    from shapy_tpu_torch.data.crop import crop_normalize

    images, affines = requests
    crops = crop_normalize(images, affines, CROP, out_dtype=torch.bfloat16)
    return crops.permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def backbone_calls(backbone, requests):
    """Every ``conv2d_act`` and every ``hr_fuse`` call of one eval forward
    of ``backbone`` on the served crops at batch 32, in order, with its
    arguments (kept alive, to replay them): (convs, fuses), each conv
    ``(x, weight, bias, residual, relu, stride)``, each fuse ``(x,
    terms)``."""
    import torch

    from shapy_tpu_torch.models.backbones import hrnet, layers

    convs, fuses = [], []
    conv_fn, fuse_fn = layers.conv2d_act, hrnet.hr_fuse

    def conv(x, weight, bias=None, residual=None, relu=False, stride=1):
        convs.append((x, weight, bias, residual, relu, stride))
        return conv_fn(x, weight, bias, residual, relu, stride)

    def fuse(x, terms):
        fuses.append((x, list(terms)))
        return fuse_fn(x, terms)

    layers.conv2d_act, hrnet.hr_fuse = conv, fuse
    try:
        with torch.inference_mode():
            backbone(served_input(requests))
    finally:
        layers.conv2d_act, hrnet.hr_fuse = conv_fn, fuse_fn
    return convs, fuses


def replay(fn, calls):
    """A function that makes every call of ``calls`` through ``fn``, in
    order (outputs dropped), for :func:`time_ms` or :func:`device_time` to
    time; its ``calls`` is their number."""
    def run():
        for args in calls:
            fn(*args)
    run.calls = len(calls)
    return run


def check_conv_kernels(convs, expect=(K5_PER_FORWARD["K5_conv"], K5_SHAPES),
                       skip=(), replays: bool = True):
    """Phase 2, K5-conv at every one of the backbone's 33 conv shapes, with
    the served weights (bf16, BN folded) and the epilogue the forward first
    uses at that shape, at batch 32 in bf16. Against the plain version
    (cuDNN without bias, then eager adds and ReLU) and against the plain
    epilogue on the exact conv sum (f64, rounded once to bf16): within
    ``conv2d_act_bf16_tolerance`` (one bf16 step of the plain value at each
    rounding of the epilogue, plus the worst-case gap of two f32 sums of
    the same products in other orders); the elements that differ from the
    plain version, and the steps of each side from the exact sum, are
    counted and printed. Then at batch 2 in f32 (TF32 off) within 1e-5 of
    the largest |y|. Each shape's kernel, plain version and cuDNN's
    ``F.conv2d`` with bias are timed under ``cases``, beside the shape's
    bound (FLOPs at 989 TFLOP/s bf16, bytes of x, weight, bias, residual
    and y at 3.35 TB/s).

    The entry's times are one forward's: ``convs``, the 331 recorded calls
    of a served forward at batch 32 (:func:`backbone_calls`), each with
    its own input, weight and epilogue, replayed through the kernel, the
    plain version and ``F.conv2d(x, w, bias)`` (the library call: cuDNN,
    without the residual and ReLU), as device time (:func:`device_ms`;
    the CUDA-event window, which also times the host's launches, is
    printed beside); the bound is the larger of those calls' summed bytes
    and summed FLOPs over the peak rates.

    Phase 11 runs the same per-shape checks on a ResNet's forward
    (``expect``: its convs and shapes), at the shapes not in ``skip``,
    the 7x7 stem's through K10, without the replays, and returns the
    cases by shape."""
    import torch
    import torch.nn.functional as F

    from shapy_tpu_torch.models.backbones.layers import (
        _conv_plan,
        conv2d_act,
        conv2d_act_bf16_tolerance,
        conv2d_act_plain,
    )

    check(len(convs) == expect[0], f"{len(convs)} convs per forward")
    shapes = {}
    for x, w, b, r, relu, stride in convs:
        key = (x.shape[1], w.shape[0], w.shape[-1], stride, x.shape[2])
        shapes.setdefault(key, {"weight": w, "bias": b, "relu": relu,
                                "residual": r is not None, "count": 0})
        shapes[key]["count"] += 1
    check(len(shapes) == expect[1], f"{len(shapes)} conv shapes")
    shapes = {k: v for k, v in shapes.items() if k not in skip}
    dev = convs[0][0].device
    gen = torch.Generator().manual_seed(SEED + 14)
    cl = torch.channels_last
    cases, failed = [], []
    worst, worst_f32, total_diff, total_elems = 0.0, 0.0, 0, 0
    for (cin, cout, k, stride, size), c in shapes.items():
        out = (size + 2 * (k // 2) - k) // stride + 1
        x = torch.randn((B, cin, size, size), generator=gen)
        x = (x if cin == 3 else x.abs()).to(dev, torch.bfloat16).contiguous(
            memory_format=cl)
        w, b, relu = c["weight"], c["bias"], c["relu"]
        r = (torch.randn((B, cout, out, out), generator=gen).to(
            dev, torch.bfloat16).contiguous(memory_format=cl)
            if c["residual"] else None)
        got = conv2d_act(x, w, b, r, relu, stride)
        want = conv2d_act_plain(x, w, b, r, relu, stride)
        saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            terms = F.conv2d(x.abs().float(), w.abs().float(), None, stride,
                             k // 2)
            exact_sum = F.conv2d(x.double(), w.double(), None, stride,
                                 k // 2)
            # f32 at batch 2: the f32 sums in another order
            args32 = (x[:2].float(), w.float(),
                      None if b is None else b.float(),
                      None if r is None else r[:2].float(), relu, stride)
            got32 = conv2d_act(*args32)
            want32 = conv2d_act_plain(*args32)
        finally:
            torch.backends.cudnn.allow_tf32 = saved
        exact = exact_sum.to(torch.bfloat16)
        if b is not None:
            exact = exact + b[:, None, None]
        if r is not None:
            exact = exact + r
        if relu:
            exact = torch.relu(exact)
        tol = conv2d_act_bf16_tolerance(exact_sum.float(), b, r, terms,
                                        cin, k)
        steps = float(((got.float() - want.float()).abs() / tol).max())
        steps_exact = float(((got.float() - exact.float()).abs() / tol)
                            .max())
        plain_exact = float(((want.float() - exact.float()).abs() / tol)
                            .max())
        n_diff = int((got != want).sum())
        n_diff_exact = int((got != exact).sum())
        n_plain_exact = int((want != exact).sum())
        rel32 = max_err(got32, want32) / max(
            float(want32.abs().max()), 1e-30)
        torch.cuda.synchronize()
        check(got.is_contiguous(memory_format=cl), "K5-conv layout")
        name = f"{cin}->{cout} k{k} s{stride} {size}^2"
        if steps > 1.0 or steps_exact > 1.0 or rel32 > 1e-5:
            failed.append(name)
        worst, worst_f32 = max(worst, max_err(got, want)), max(worst_f32,
                                                              rel32)
        total_diff += n_diff
        total_elems += got.numel()

        ms = time_ms(lambda: conv2d_act(x, w, b, r, relu, stride))
        plain_ms = time_ms(lambda: conv2d_act_plain(x, w, b, r, relu, stride))
        library_ms = time_ms(lambda: F.conv2d(x, w, b, stride, k // 2))
        flops = 2.0 * got.numel() * cin * k * k
        nbytes = 2.0 * (x.numel() + w.numel() + got.numel() * (
            2 if r is not None else 1) + (0 if b is None else b.numel()))
        ops_ms = flops / PEAK_BF16_FLOP_S * 1e3
        bytes_ms = nbytes / PEAK_BYTES_S * 1e3
        plan, plan_text = conv_plan_text(B, cin, cout, k, stride, size)
        case = {"cin": cin, "cout": cout, "k": k, "stride": stride,
                "size": size, "convs_per_forward": c["count"], "plan": plan,
                "max_abs_err": max_err(got, want),
                "bias": b is not None, "residual": r is not None,
                "relu": relu, "ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms,
                "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "ops_ms": ops_ms, "bytes_ms": bytes_ms,
                "tol_vs_plain": steps, "tol_vs_exact": steps_exact,
                "plain_tol_vs_exact": plain_exact, "differing": n_diff,
                "differing_from_exact": n_diff_exact,
                "plain_differing_from_exact": n_plain_exact,
                "elements": got.numel(), "f32_rel_err": rel32}
        cases.append(case)
        print(f"K5-conv {name} (x{c['count']}; bias {b is not None}, "
              f"residual {r is not None}, relu {relu}): bf16 differs from "
              f"plain in {n_diff} of {got.numel()} elements, at most "
              f"{steps:.3f} of the tolerance (limit 1); from the exact sum's "
              f"epilogue kernel {n_diff_exact} at {steps_exact:.3f}, plain "
              f"{n_plain_exact} at {plain_exact:.3f}; f32 rel {rel32:.2e} "
              f"(tol 1e-5); kernel {ms:.4f} ms, plain {plain_ms:.4f}, cuDNN "
              f"{library_ms:.4f}, bound {max(ops_ms, bytes_ms):.4f} "
              f"({case['bound_by']}), kernel at "
              f"{max(ops_ms, bytes_ms) / ms:.1%} of its bound; plan: "
              f"{plan_text}")
        del terms, exact_sum, exact
    check(not failed, f"K5-conv outside its tolerance at {failed}")
    if not replays:
        return {"max_abs_err": worst, "f32_max_rel_err": worst_f32,
                "cases": cases}

    def library(x, w, b, r, relu, stride):
        return F.conv2d(x, w, b, stride, w.shape[-1] // 2)

    with torch.inference_mode():
        window = {"kernel": time_ms(replay(conv2d_act, convs)),
                  "plain": time_ms(replay(conv2d_act_plain, convs)),
                  "library": time_ms(replay(library, convs))}
        ms, on_card = device_time(replay(conv2d_act, convs))
        plain_ms = device_ms(replay(conv2d_act_plain, convs))
        library_ms = device_ms(replay(library, convs))
    flops = nbytes = 0.0
    for x, w, b, r, relu, stride in convs:
        k = w.shape[-1]
        side = (x.shape[2] + 2 * (k // 2) - k) // stride + 1
        y = x.shape[0] * w.shape[0] * side * side
        flops += 2.0 * y * x.shape[1] * k * k
        nbytes += x.element_size() * (x.numel() + w.numel() + y * (
            2 if r is not None else 1) + (0 if b is None else b.numel()))
    ops_ms = flops / PEAK_BF16_FLOP_S * 1e3
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    # a kernel a conv and a reduce for each conv with K partitions
    want = len(convs) + sum(
        _conv_plan(x.shape[0], x.shape[2], x.shape[3], x.shape[1],
                   w.shape[0], w.shape[-1], stride).parts > 1
        for x, w, *_, stride in convs if x.shape[1] % 8 == 0)
    check(on_card == want, f"the K5-conv replay ran {on_card} device "
                           f"kernels, its plans {want}")
    print(f"K5-conv, one served forward's {len(convs)} convs at batch {B} "
          f"replayed ({on_card} device kernels), device time: kernel "
          f"{ms:.3f} ms, plain "
          f"{plain_ms:.3f}, cuDNN (conv + bias) {library_ms:.3f}, bound "
          f"{bound_ms:.3f} ms ({flops / 1e12:.3f} TFLOP, "
          f"{nbytes / 1e9:.3f} GB; by "
          f"{'operations' if ops_ms >= bytes_ms else 'bytes'}), kernel at "
          f"{bound_ms / ms:.1%} of its bound; in one CUDA-event window, "
          f"host launches included: kernel {window['kernel']:.3f}, plain "
          f"{window['plain']:.3f}, cuDNN {window['library']:.3f}; per-shape "
          f"checks: {total_diff} of {total_elems} bf16 elements differ "
          "from plain")
    return {"K5_conv": {
        "max_abs_err": worst, "f32_max_rel_err": worst_f32,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "window_ms": window, "bound_ms": bound_ms, "device_kernels": on_card,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_call": "F.conv2d(x, w, bias) (cuDNN), bf16 channels_last",
        "timed_as": f"one served forward's {len(convs)} convs at batch {B}, "
                    "each with its own input, weight and epilogue, replayed; "
                    "the device time of its kernels (torch.profiler)",
        "cases": cases}}


def check_conv_routes(backbone, requests, convs, pools: int = 0):
    """Phase 2, the served forward's device kernels (``torch.profiler``,
    one bf16 backbone forward at batch 32): exactly one
    stem kernel (the Cin = 3 conv: HRNet's 3x3 K5-conv's
    ``conv_bf16_kernel``, a ResNet's 7x7 K10's ``stem7_kernel``), a
    ``conv_wgmma_kernel`` for each
    of the other convs (330 for HRNet-W48) and a ``conv_reduce_kernel``
    for each conv whose plan has K partitions (from ``convs``, the
    recorded calls), ``pools`` K11 ``max_pool_forward_kernel`` (a ResNet's
    one), and no cuDNN convolution or ATen pooling kernel."""
    import torch

    x = served_input(requests)
    parted = 0
    for x_, w, *_rest in convs:
        if x_.shape[1] % 8 == 0:
            stride = _rest[-1]
            plan, _ = conv_plan_text(x_.shape[0], x_.shape[1], w.shape[0],
                                     w.shape[-1], stride, x_.shape[2])
            parted += plan["parts"] > 1
    stem7 = int(convs[0][1].shape[-1] == 7)  # K10's kernel, else K5's
    want = {"conv_bf16_kernel": 1 - stem7, "stem7_kernel": stem7,
            "conv_wgmma_kernel": len(convs) - 1,
            "conv_reduce_kernel": parted, "max_pool_forward_kernel": pools}
    # A trace can miss its first few events: :func:`_device_trace` pads it
    # with spin kernels, and a trace that still misses some is taken again
    # (at most three times).
    with torch.inference_mode():
        backbone(x)
        torch.cuda.synchronize()
        for _ in range(3):
            counts = (_device_trace(lambda: backbone(x), 1)
                      or (0.0, collections.Counter()))[1]

            def named(part):
                return sum(n for k, n in counts.items() if part in k)

            got = {k: named(k) for k in want}
            if got == want:
                break
            print(f"served forward's trace held {got}, expected {want}: "
                  "taken again", flush=True)
    library = sorted(k for k in counts if any(
        s in k.lower() for s in ("cudnn", "xmma", "implicit", "convolve",
                                 "fprop", "winograd")) or (
        "pool" in k.lower() and "max_pool_forward_kernel" not in k))
    print(f"served forward's device kernels (profiled, batch {B}): {got}; "
          f"expected {want}; cuDNN convolution or ATen pooling kernels "
          f"{library}")
    check(got == want, f"the served forward's conv kernels {got}")
    check(not library, f"library convolution or pooling kernels ran: "
                       f"{library}")
    return dict(got, library_kernels=library)


def check_train_forward_replay(convs):
    """Phase 2, a train step's 331 forward convs at batch 48 (the inputs,
    weights and strides recorded by :func:`train_step_calls`; no
    epilogue: in training the BN follows), replayed through K5-conv and
    through ``F.conv2d`` (cuDNN), as device time (and in one CUDA-event
    window), beside their summed bound."""
    import torch
    import torch.nn.functional as F

    from shapy_tpu_torch.models.backbones.layers import conv2d_act

    calls = [(x, w, s) for _dy, x, w, s, _nx, _b in convs]
    check(len(calls) == K5_PER_TRAIN_STEP["K5_conv"],
          f"{len(calls)} train forward convs")
    with torch.inference_mode():
        for x, w, s in calls[:: max(1, len(calls) // 8)]:
            got = conv2d_act(x, w, None, None, False, s)
            check(bool(torch.isfinite(got).all()), "train forward finite")
        kernel = replay(lambda x, w, s: conv2d_act(x, w, None, None, False,
                                                   s), calls)
        library = replay(lambda x, w, s: F.conv2d(x, w, None, s,
                                                  w.shape[-1] // 2), calls)
        ms, library_ms = device_ms(kernel), device_ms(library)
        window = {"kernel": time_ms(kernel, iters=5, warmup=1),
                  "library": time_ms(library, iters=5, warmup=1)}
    flops = nbytes = 0.0
    for x, w, s in calls:
        k = w.shape[-1]
        side = (x.shape[2] + 2 * (k // 2) - k) // s + 1
        y = x.shape[0] * w.shape[0] * side * side
        flops += 2.0 * y * x.shape[1] * k * k
        nbytes += x.element_size() * (x.numel() + w.numel() + y)
    bound_ms, bound_by = bound(nbytes, flops, PEAK_BF16_FLOP_S)
    print(f"K5-conv, a train step's {len(calls)} forward convs at batch "
          f"{TRAIN_B} replayed, device time: kernel {ms:.3f} ms, cuDNN "
          f"{library_ms:.3f} (kernel / cuDNN {ms / library_ms:.3f}), bound "
          f"{bound_ms:.3f} ({bound_by}; {flops / 1e12:.3f} TFLOP, "
          f"{nbytes / 1e9:.3f} GB); one CUDA-event window: kernel "
          f"{window['kernel']:.3f}, cuDNN {window['library']:.3f}; "
          f"{gpu_line()}")
    return {"ms": ms, "library_ms": library_ms, "window_ms": window,
            "bound_ms": bound_ms,
            "bound_by": bound_by, "convs": len(calls), "batch": TRAIN_B}


def check_fuse_kernel(regressor, fuses):
    """Phase 2, K5-fuse: bit-equal to ``hr_fuse_plain`` at each of
    ``fuses``, the 26 recorded calls of a served forward at batch 32
    (:func:`backbone_calls`), and at every target of the first stage-4
    module (its real widths and resolutions: 48..384 channels, 64^2..8^2)
    at batch 32 in bf16 and batch 2 in f32, the terms made by K5-conv from
    random branch outputs; each stage-4 target timed under ``cases``. The
    entry's times are the 26 calls replayed through the kernel and the
    plain version, as device time; the bound is their bytes (x, the terms
    and y once each) at 3.35 TB/s."""
    import torch

    from shapy_tpu_torch.models.backbones.hrnet import (
        _branch_channels,
        hr_fuse,
        hr_fuse_plain,
    )
    from shapy_tpu_torch.models.backbones.layers import conv_act

    check(len(fuses) == K5_PER_FORWARD["K5_fuse"],
          f"{len(fuses)} fusion targets per forward")
    with torch.inference_mode():
        for n, (x, terms) in enumerate(fuses):
            check(torch.equal(hr_fuse(x, terms), hr_fuse_plain(x, terms)),
                  f"K5-fuse: the forward's fusion {n} differs")
        # the forward's times: the stage-4 loop below times its targets
        fwd = {"ms": device_ms(replay(hr_fuse, fuses)),
               "plain_ms": device_ms(replay(hr_fuse_plain, fuses)),
               "window_ms": time_ms(replay(hr_fuse, fuses))}
    nbytes = sum(x.element_size() * (2 * x.numel() + sum(
        t.numel() for t, _ in terms)) for x, terms in fuses)
    fwd["bound_ms"] = nbytes / PEAK_BYTES_S * 1e3
    print(f"K5-fuse, one served forward's {len(fuses)} fusion targets at "
          f"batch {B}: bit-equal to plain at each; replayed, device time: "
          f"kernel {fwd['ms']:.4f} ms, plain {fwd['plain_ms']:.4f}, bound "
          f"{fwd['bound_ms']:.4f} (bytes {nbytes / 1e6:.2f} MB), kernel at "
          f"{fwd['bound_ms'] / fwd['ms']:.1%} of its bound")

    module = regressor.backbone.stage4[0]
    dev = fuses[0][0].device
    gen = torch.Generator().manual_seed(SEED + 15)
    chans = _branch_channels("stage4")
    n = len(chans)
    cases = []
    for dtype, batch in ((torch.bfloat16, B), (torch.float32, 2)):
        mod = module if dtype == torch.bfloat16 else copy.deepcopy(
            module).float()
        xs = [torch.randn((batch, c, (CROP // 4) >> i, (CROP // 4) >> i),
                          generator=gen).abs().to(dev, dtype).contiguous(
            memory_format=torch.channels_last) for i, c in enumerate(chans)]
        with torch.inference_mode():
            for i in range(n):
                row = mod.fuse_layers[i]
                terms = [(conv_act(row[j][0], row[j][1], xs[j]), j - i)
                         if j > i else (row[j](xs[j]), 0)
                         for j in list(range(i + 1, n)) + list(range(i))]
                got = hr_fuse(xs[i], terms)
                want = hr_fuse_plain(xs[i], terms)
                torch.cuda.synchronize()
                equal = torch.equal(got, want)
                check(equal, f"K5-fuse target {i} ({dtype}) differs")
                if dtype != torch.bfloat16:
                    continue
                ms = time_ms(lambda: hr_fuse(xs[i], terms))
                plain_ms = time_ms(lambda: hr_fuse_plain(xs[i], terms))
                nbytes = 2.0 * (2 * xs[i].numel()
                                + sum(t.numel() for t, _ in terms))
                bound_ms = nbytes / PEAK_BYTES_S * 1e3
                cases.append({"target": i, "shape": list(xs[i].shape),
                              "terms": len(terms), "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "bit_equal": equal})
                print(f"K5-fuse stage-4 target {i} {list(xs[i].shape)}, "
                      f"{len(terms)} terms: bit-equal {equal}; kernel "
                      f"{ms:.4f} ms, plain {plain_ms:.4f}, bound "
                      f"{bound_ms:.4f} (bytes {nbytes / 1e6:.2f} MB), kernel "
                      f"at {bound_ms / ms:.1%} of its bound")
    print("K5-fuse f32 (batch 2): bit-equal at every target")
    return {"K5_fuse": {
        "max_abs_err": 0.0, **fwd, "bound_by": "bytes", "library_ms": None,
        "timed_as": f"one served forward's {len(fuses)} fusion targets at "
                    f"batch {B}, replayed; the device time of its kernels",
        "cases": cases}}


def check_backbone_routes(regressor, requests):
    """Phase 2, the whole bf16 backbone at batch 32 on the served crops:
    the K5 route (331 K5-conv and 26 K5-fuse launches) against the plain
    route (the plain versions on the card: cuDNN convs, eager adds,
    nearest upsamples), both timed. Limits on the features: cosine >=
    0.999 and relative L2 <= 0.05: each side rounds to bf16 after every
    op, and 331 convs summed in another order flip single bits that
    accumulate."""
    import torch

    from shapy_tpu_torch.models.backbones import hrnet, layers

    x = served_input(requests)
    backbone = regressor.backbone
    saved = (layers._conv2d_act_cuda, hrnet._hr_fuse_cuda,
             layers._max_pool2d_cuda)

    def run():
        feats = backbone(x)
        return feats["avg_pooling"] if isinstance(feats, dict) else feats

    with torch.inference_mode():
        k5 = run().float()
        k5_ms = time_ms(run, iters=10)
        layers._conv2d_act_cuda = layers.conv2d_act_plain
        hrnet._hr_fuse_cuda = hrnet.hr_fuse_plain
        layers._max_pool2d_cuda = layers.max_pool2d_plain
        try:
            plain = run().float()
            plain_ms = time_ms(run, iters=10)
        finally:
            (layers._conv2d_act_cuda, hrnet._hr_fuse_cuda,
             layers._max_pool2d_cuda) = saved
    cos = float(torch.nn.functional.cosine_similarity(
        k5.flatten(), plain.flatten(), dim=0))
    rel = float((k5 - plain).norm() / plain.norm())
    print(f"backbone bf16 batch {B}: K5 route {k5_ms:.3f} ms, plain route "
          f"(cuDNN + eager) {plain_ms:.3f} ms; features cosine {cos:.6f} "
          f"(tol >= 0.999), relative L2 {rel:.3e} (tol 0.05)")
    check(bool(torch.isfinite(k5).all()), "non-finite K5 features")
    check(cos >= 0.999 and rel <= 0.05, "K5 backbone vs plain route")
    return {"k5_ms": k5_ms, "plain_ms": plain_ms, "cosine": cos,
            "relative_l2": rel}


def _train_regressor(base, dev):
    """A copy of ``base`` on ``dev`` in train mode with a bf16 backbone,
    as phase 7 trains it."""
    import torch

    return copy.deepcopy(base).to(dev).prepare_for_train_(torch.bfloat16)


def train_step_calls(base, dev, expect=(K5_PER_TRAIN_STEP["K5_wgrad"],
                                         K5_PER_TRAIN_STEP["K5_dgrad"],
                                         K5_PER_TRAIN_STEP["K5_fuse_backward"],
                                         K4_PER_TRAIN_STEP, 0)):
    """Every conv, fusion target, BN and max pool of one train step of the
    flagship (or of ``base``, a ResNet regressor) at batch 48 (bf16
    backbone, dropout 0.5, the losses of phase 7), with the cotangent its
    backward received (made channels_last, as the wrappers make it):
    (convs, fuses, bns, pools), each conv ``(dy, x, weight, stride, needs
    dx, has a bias)`` in backward order, each fuse ``(dy, y, shifts)``,
    each BN ``(dy, x, gamma, mean, inv)`` (K4's backward's arguments),
    each pool ``(dy, x)``; ``expect`` their counts (conv backwards, those
    that need dx, fuses, BNs, pools). The step runs the kernels; the
    recorded tensors stay alive for the replays."""
    import torch

    from shapy_tpu_torch.flagship import (
        FLAGSHIP_OPTIM_CFG,
        FLAGSHIP_TRAIN_LOSS_CFG,
        synthetic_train_batches,
    )
    from shapy_tpu_torch.models.backbones import hrnet, layers
    from shapy_tpu_torch.train.losses import RegressorLosses
    from shapy_tpu_torch.train.step import init_train_state, make_train_step

    reg = _train_regressor(base, dev)
    batch = dict(synthetic_train_batches(reg, 1, TRAIN_B, CROP, SEED + 9)[0])
    images = batch.pop("images")
    step = make_train_step(reg, RegressorLosses(FLAGSHIP_TRAIN_LOSS_CFG),
                           init_train_state(reg, FLAGSHIP_OPTIM_CFG))
    convs, fuses, bns, pools = [], [], [], []
    conv_bwd, fuse_bwd = (layers._conv2d_backward_cuda,
                          hrnet._hr_fuse_backward_cuda)
    bn_bwd = layers._bn_backward_cuda
    pool_bwd = layers._max_pool2d_backward_cuda

    def conv(dy, x, weight, y, stride, need_x, need_w, need_b, need_r):
        dy = layers._aligned_cl(dy)
        convs.append((dy, x.detach(), weight.detach(), stride, need_x,
                      need_b))
        return conv_bwd(dy, x, weight, y, stride, need_x, need_w, need_b,
                        need_r)

    def fuse(dy, y, shifts):
        dy = dy.contiguous(memory_format=torch.channels_last)
        fuses.append((dy, y.detach(), shifts))
        return fuse_bwd(dy, y, shifts)

    def bn(dy, x, gamma, mean, inv, plan):
        bns.append((dy, x.detach(), gamma.detach(), mean, inv))
        return bn_bwd(dy, x, gamma, mean, inv, plan)

    def pool(dy, x):
        pools.append((layers._aligned_cl(dy.to(x.dtype)), x.detach()))
        return pool_bwd(dy, x)

    layers._conv2d_backward_cuda, hrnet._hr_fuse_backward_cuda = conv, fuse
    layers._bn_backward_cuda, layers._max_pool2d_backward_cuda = bn, pool
    try:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        step.backward(step.forward(images, batch, gen))
    finally:
        layers._conv2d_backward_cuda, hrnet._hr_fuse_backward_cuda = (
            conv_bwd, fuse_bwd)
        layers._bn_backward_cuda = bn_bwd
        layers._max_pool2d_backward_cuda = pool_bwd
    torch.cuda.synchronize()
    got = (len(convs), sum(c[4] for c in convs), len(fuses), len(bns),
           len(pools))
    check(got == tuple(expect), f"a train step's (conv backwards, of them "
          f"with dx, fusion backwards, BN backwards, pool backwards) {got}, "
          f"expected {tuple(expect)}")
    return convs, fuses, bns, pools


def _conv_library(dy, x, w, stride, mask):
    """cuDNN's conv backward for the same output mask (dx, dw, dbias)."""
    import torch

    k = w.shape[-1]
    return torch.ops.aten.convolution_backward(
        dy, x, w, [w.shape[0]] if mask[2] else None, [stride] * 2,
        [k // 2] * 2, [1, 1], False, [0, 0], 1, list(mask))


def _bwd_steps(got, want, s, terms, k: int) -> float:
    """The largest |got - want| of a bf16 backward kernel against its
    plain version in units of its per-element limit: one bf16 step at the
    larger magnitude of the f32 sum ``s`` and the two rounded values (two
    roundings that straddle a power of two differ by up to a step of the
    upper binade) plus 2 k 2^-24 sum|terms| (two f32 sums of the k same
    products in other orders)."""
    import torch

    from shapy_tpu_torch.models.backbones.layers import (
        conv2d_act_bf16_tolerance,
    )

    got, want = got.float(), want.float()
    mag = torch.maximum(s.abs(), torch.maximum(got.abs(), want.abs()))
    tol = conv2d_act_bf16_tolerance(mag, None, None, terms, k, 1)
    return float(((got - want).abs() / tol).max())


def _exact_steps(got, exact, terms, k: int) -> tuple:
    """A bf16 K5-wgrad result against the exact (f64) sum: (the largest
    |got - exact| in units of :func:`conv2d_wgrad_bf16_tolerance`, the
    share of elements that round otherwise than the exact sum)."""
    from shapy_tpu_torch.models.backbones.layers import (
        conv2d_wgrad_bf16_tolerance,
    )

    tol = conv2d_wgrad_bf16_tolerance(got, terms, k).double()
    steps = float(((got.double() - exact).abs() / tol).max())
    return steps, float((got != exact.to(got.dtype)).double().mean())


def check_conv_backward_kernels(convs, expect_shapes: int = K5_SHAPES,
                                skip=(), replays: bool = True):
    """Phase 2, K5-dgrad and K5-wgrad at each of the backbone's 33 conv
    shapes, with one train step's recorded inputs, weights and cotangents
    at batch 48 in bf16 (``convs``, :func:`train_step_calls`; K5-dgrad at
    the 32 shapes whose input needs a gradient): against the plain
    versions (cuDNN's data and weight gradients, the bias's f32 sum),
    within one bf16 step (at the larger of the f32 no-TF32 sum and the
    two values: :func:`_bwd_steps`) plus 2 K 2^-24 sum|terms|
    (K = k^2 Cout for dx, N Ho Wo for dw and dbias: two f32 sums of the
    same products in other orders). That limit grows with K, and at the
    weight gradients' K (12,288 to 786,432 rows) it would pass a zeroed
    dw, so dw and dbias are also held against the exact (f64) sum: half a
    bf16 step plus 2 sqrt(K) 2^-24 sum|terms| per element
    (:func:`conv2d_wgrad_bf16_tolerance`), and at most
    ``WGRAD_MAX_DIFFERING`` of the elements may round otherwise than the
    exact sum (an error that moves every sum, such as a lost row
    partition, changes the rounding of most of them). Two calls
    bit-equal; then at batch 2
    in f32 (phase 4's shapes, TF32 off): dx and dw within 1e-5 of the
    largest |value|, dbias within 1e-5 sum|dy|. Each shape's kernel,
    plain version and cuDNN (``aten.convolution_backward`` with the same
    output mask) timed under ``cases`` beside its bound (FLOPs at 989
    TFLOP/s, bytes of the inputs and outputs at 3.35 TB/s).

    The entries' times are one train step's: the 330 data gradients, then
    the 331 weight gradients, replayed through the kernel, the plain
    version and cuDNN, as device time (the CUDA-event windows, host
    launches included, printed beside).

    Phase 11 runs the same per-shape checks on a ResNet's train step
    (``expect_shapes`` its shapes), at the shapes not in ``skip``, the 7x7
    stem's weight gradient through K10, without the replays, and returns
    the cases."""
    import torch

    from shapy_tpu_torch.models.backbones.layers import (
        _conv2d_dgrad_cuda,
        _conv2d_wgrad_cuda,
        conv2d_input_plain,
        conv2d_weight_plain,
        conv2d_wgrad_f32_tolerance,
    )

    shapes = {}
    for args in convs:
        dy, x, w, stride, need_x, bias = args
        key = (x.shape[1], w.shape[0], w.shape[-1], stride, x.shape[2])
        shapes.setdefault(key, {"args": args, "count": 0})["count"] += 1
    check(len(shapes) == expect_shapes, f"{len(shapes)} conv shapes")
    shapes = {k: v for k, v in shapes.items() if k not in skip}
    cases, failed = [], []
    worst = {"K5_dgrad": 0.0, "K5_wgrad": 0.0}
    worst32 = {"K5_dgrad": 0.0, "K5_wgrad": 0.0}
    worst48 = {"exact": 0.0, "gap": 0.0}
    saved = torch.backends.cudnn.allow_tf32
    for (cin, cout, k, stride, size), c in shapes.items():
        dy, x, w, _, need_x, bias = c["args"]
        rows = dy.shape[0] * dy.shape[2] * dy.shape[3]
        name = f"{cin}->{cout} k{k} s{stride} {size}^2"
        torch.backends.cudnn.allow_tf32 = False
        try:
            dw, db, _ = _conv2d_wgrad_cuda(x, dy, None, w.shape, stride, bias)
            dw2, db2, _ = _conv2d_wgrad_cuda(x, dy, None, w.shape, stride,
                                             bias)
            pw, pb = conv2d_weight_plain(x, w.shape, dy, stride, bias)
            sw, sb = conv2d_weight_plain(x.float(), w.shape, dy.float(),
                                         stride, bias)
            ew, eb = conv2d_weight_plain(x.double(), w.shape, dy.double(),
                                         stride, bias)
            tw, tb = conv2d_weight_plain(x.abs().float(), w.shape,
                                         dy.abs().float(), stride, bias)
            # f32 at batch 48, on the same (bf16-valued) inputs: ew and
            # eb are its exact sums too.
            dw48, db48, _ = _conv2d_wgrad_cuda(x.float(), dy.float(), None,
                                               w.shape, stride, bias)
            args32 = (x[:2].float(), dy[:2].float())
            dw32, db32, _ = _conv2d_wgrad_cuda(*args32, None, w.shape, stride,
                                               bias)
            pw32, pb32 = conv2d_weight_plain(args32[0], w.shape, args32[1],
                                             stride, bias)
            sum_dy32 = args32[1].abs().sum(dim=(0, 2, 3))
            if need_x:
                dx = _conv2d_dgrad_cuda(dy, w, x.shape, stride)
                dx2 = _conv2d_dgrad_cuda(dy, w, x.shape, stride)
                px = conv2d_input_plain(x.shape, w, dy, stride)
                sx = conv2d_input_plain(x.shape, w.float(), dy.float(),
                                        stride)
                tx = conv2d_input_plain(x.shape, w.abs().float(),
                                        dy.abs().float(), stride)
                dx32 = _conv2d_dgrad_cuda(args32[1], w.float(),
                                          args32[0].shape, stride)
                px32 = conv2d_input_plain(args32[0].shape, w.float(),
                                          args32[1], stride)
        finally:
            torch.backends.cudnn.allow_tf32 = saved
        torch.cuda.synchronize()
        equal = torch.equal(dw, dw2) and (db is None or torch.equal(db, db2))
        steps_w = _bwd_steps(dw, pw, sw, tw, rows)
        steps_b = 0.0 if db is None else _bwd_steps(db, pb, sb, tb, rows)
        exact_w, share_w = _exact_steps(dw, ew, tw, rows)
        exact_b, share_b = ((0.0, 0.0) if db is None
                            else _exact_steps(db, eb, tb, rows))
        rel_w32 = rel_err(dw32, pw32)
        # The f32 K5-wgrad at batch 48 against the exact sum, per element
        # (conv2d_wgrad_f32_tolerance), and its order gap to the plain f32
        # sum (cuDNN without TF32).
        tol48 = conv2d_wgrad_f32_tolerance(dw48, tw, rows)
        exact48 = float(((dw48.double() - ew).abs() / tol48).max())
        if db48 is not None:
            tolb = conv2d_wgrad_f32_tolerance(db48, tb, rows)
            exact48 = max(exact48, float(((db48.double() - eb).abs()
                                          / tolb).max()))
        gap48 = rel_err(dw48, sw)
        worst48["exact"] = max(worst48["exact"], exact48)
        worst48["gap"] = max(worst48["gap"], gap48)
        b32 = 0.0 if db32 is None else float(
            ((db32 - pb32).abs() / sum_dy32).max())
        worst["K5_wgrad"] = max(worst["K5_wgrad"], max_err(dw, pw))
        worst32["K5_wgrad"] = max(worst32["K5_wgrad"], rel_w32)
        case = {"cin": cin, "cout": cout, "k": k, "stride": stride,
                "size": size, "convs_per_step": c["count"], "bias": bias,
                "wgrad_tol_vs_plain": steps_w, "dbias_tol_vs_plain": steps_b,
                "wgrad_tol_vs_exact": exact_w, "dbias_tol_vs_exact": exact_b,
                "wgrad_share_rounded_otherwise": share_w,
                "dbias_share_rounded_otherwise": share_b,
                "wgrad_f32_rel_err": rel_w32, "dbias_f32_err_over_sum_dy": b32,
                "wgrad_f32_b48_tol_vs_exact": exact48,
                "wgrad_f32_b48_rel_vs_plain": gap48,
                "wgrad_differing": int((dw != pw).sum()),
                "wgrad_elements": dw.numel(),
                "wgrad_max_abs_err": max_err(dw, pw)}
        bad = (max(steps_w, steps_b, exact_w, exact_b, exact48) > 1.0
               or max(share_w, share_b) > WGRAD_MAX_DIFFERING
               or rel_w32 > 1e-5 or b32 > 1e-5)
        flops = 2.0 * rows * cout * cin * k * k
        mask_w = (False, True, bool(bias))
        case["wgrad_ms"] = time_ms(lambda: _conv2d_wgrad_cuda(
            x, dy, None, w.shape, stride, bias))
        case["wgrad_plain_ms"] = time_ms(lambda: conv2d_weight_plain(
            x, w.shape, dy, stride, bias))
        case["wgrad_library_ms"] = time_ms(lambda: _conv_library(
            dy, x, w, stride, mask_w))
        case["wgrad_bound_ms"], case["wgrad_bound_by"] = bound(
            2.0 * (x.numel() + dy.numel() + w.numel()), flops,
            PEAK_BF16_FLOP_S)
        line = (f"K5-wgrad {name} (x{c['count']}, bias {bias}): bf16 at "
                f"{steps_w:.3f} of the tolerance (dbias {steps_b:.3f}), "
                f"{case['wgrad_differing']} of {dw.numel()} differ; against "
                f"the exact sum at {exact_w:.3f} of its limit (dbias "
                f"{exact_b:.3f}), {share_w:.2%} rounded otherwise (dbias "
                f"{share_b:.2%}; limit {WGRAD_MAX_DIFFERING:.0%}); two "
                f"calls equal {equal}; f32 rel {rel_w32:.2e}, dbias "
                f"{b32:.2e} of sum|dy|; f32 at batch {TRAIN_B} against "
                f"the exact sum at {exact48:.3f} of its limit, "
                f"{gap48:.2e} of the largest |dw| from the plain f32 sum; "
                f"kernel {case['wgrad_ms']:.4f} ms, "
                f"plain {case['wgrad_plain_ms']:.4f}, cuDNN "
                f"{case['wgrad_library_ms']:.4f} (kernel / cuDNN "
                f"{case['wgrad_ms'] / case['wgrad_library_ms']:.2f}), bound "
                f"{case['wgrad_bound_ms']:.4f} ({case['wgrad_bound_by']})")
        if need_x:
            steps_x = _bwd_steps(dx, px, sx, tx, cout * k * k)
            rel_x32 = rel_err(dx32, px32)
            equal = equal and torch.equal(dx, dx2)
            worst["K5_dgrad"] = max(worst["K5_dgrad"], max_err(dx, px))
            worst32["K5_dgrad"] = max(worst32["K5_dgrad"], rel_x32)
            bad = bad or steps_x > 1.0 or rel_x32 > 1e-5
            case.update({"dgrad_tol_vs_plain": steps_x,
                         "dgrad_f32_rel_err": rel_x32,
                         "dgrad_differing": int((dx != px).sum()),
                         "dgrad_elements": dx.numel()})
            mask_x = (True, False, False)
            case["dgrad_ms"] = time_ms(lambda: _conv2d_dgrad_cuda(
                dy, w, x.shape, stride))
            case["dgrad_plain_ms"] = time_ms(lambda: conv2d_input_plain(
                x.shape, w, dy, stride))
            case["dgrad_library_ms"] = time_ms(lambda: _conv_library(
                dy, x, w, stride, mask_x))
            case["dgrad_bound_ms"], case["dgrad_bound_by"] = bound(
                2.0 * (x.numel() + dy.numel() + w.numel()), flops,
                PEAK_BF16_FLOP_S)
            line += (f"; K5-dgrad at {steps_x:.3f} of the tolerance, "
                     f"{case['dgrad_differing']} of {dx.numel()} differ; f32 "
                     f"rel {rel_x32:.2e}; kernel {case['dgrad_ms']:.4f} ms, "
                     f"plain {case['dgrad_plain_ms']:.4f}, cuDNN "
                     f"{case['dgrad_library_ms']:.4f} (kernel / cuDNN "
                     f"{case['dgrad_ms'] / case['dgrad_library_ms']:.2f}), "
                     "bound "
                     f"{case['dgrad_bound_ms']:.4f} ({case['dgrad_bound_by']})")
        case["bit_equal_calls"] = equal
        print(line)
        if bad or not equal:
            failed.append(name)
        cases.append(case)
    check(not failed, f"K5 conv backward outside its tolerance at {failed}")
    print(f"K5-wgrad f32 at batch {TRAIN_B}: against the exact sum at most "
          f"{worst48['exact']:.3f} of its limit (half an f32 step + 2 "
          f"sqrt(K) 2^-24 sum|terms|); from the plain f32 sum at most "
          f"{worst48['gap']:.2e} of the largest |dw| (the batch-2 check "
          "holds 1e-5)")
    if not replays:
        return {"max_abs_err": worst, "f32_max_rel_err": worst32,
                "f32_batch48": worst48, "cases": cases}

    dgrads = [(dy, x, w, stride) for dy, x, w, stride, need_x, _ in convs
              if need_x]
    wgrads = [(dy, x, w, stride, bias) for dy, x, w, stride, _, bias in convs]
    out = {}
    for name, calls, kernel, plain, library in (
            ("K5_dgrad", dgrads,
             lambda dy, x, w, s: _conv2d_dgrad_cuda(dy, w, x.shape, s),
             lambda dy, x, w, s: conv2d_input_plain(x.shape, w, dy, s),
             lambda dy, x, w, s: _conv_library(dy, x, w, s,
                                               (True, False, False))),
            ("K5_wgrad", wgrads,
             lambda dy, x, w, s, b: _conv2d_wgrad_cuda(x, dy, None, w.shape,
                                                       s, b),
             lambda dy, x, w, s, b: conv2d_weight_plain(x, w.shape, dy, s, b),
             lambda dy, x, w, s, b: _conv_library(dy, x, w, s,
                                                  (False, True, b)))):
        window = {"kernel": time_ms(replay(kernel, calls), iters=5,
                                    warmup=1),
                  "library": time_ms(replay(library, calls), iters=5,
                                     warmup=1)}
        # the device kernels of the step's calls: a main pass each, and
        # K5-dgrad's K-partition reduces (no weight copy)
        ms, on_card = device_time(replay(kernel, calls))
        plain_ms = device_ms(replay(plain, calls), passes=1)
        library_ms = device_ms(replay(library, calls))
        if name == "K5_dgrad":
            check(on_card <= 2 * len(calls),
                  f"K5-dgrad ran {on_card} device kernels a train step")
        flops = nbytes = 0.0
        for dy, x, w, *_ in calls:
            k = w.shape[-1]
            flops += 2.0 * dy.numel() * x.shape[1] * k * k
            nbytes += 2.0 * (x.numel() + dy.numel() + w.numel())
        bound_ms, bound_by = bound(nbytes, flops, PEAK_BF16_FLOP_S)
        print(f"{name}, one train step's {len(calls)} convs at batch "
              f"{TRAIN_B} ({on_card} device kernels) replayed, device time: "
              f"kernel {ms:.3f} ms (one CUDA-event window: "
              f"{window['kernel']:.3f}; cuDNN {window['library']:.3f}), plain "
              f"{plain_ms:.3f}, cuDNN {library_ms:.3f} (kernel / cuDNN "
              f"{ms / library_ms:.3f}), bound {bound_ms:.3f} "
              f"ms ({flops / 1e12:.3f} TFLOP, {nbytes / 1e9:.3f} GB; by "
              f"{bound_by}), kernel at {bound_ms / ms:.1%} of its bound; "
              f"{gpu_line()}")
        out[name] = {
            "max_abs_err": worst[name], "f32_max_rel_err": worst32[name],
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "over_library": ms / library_ms, "device_kernels": on_card,
            "window_ms": window,
            "bound_ms": bound_ms, "bound_by": bound_by,
            **({"f32_batch48": worst48} if name == "K5_wgrad" else {}),
            "library_call": "torch.ops.aten.convolution_backward (cuDNN), "
                            "bf16 channels_last, the same output mask",
            "timed_as": f"one train step's {len(calls)} conv backwards at "
                        f"batch {TRAIN_B}, each with its own input, weight "
                        "and cotangent, replayed; the device time of its "
                        "kernels (torch.profiler)",
            "cases": cases}
    return out


def check_fuse_backward_kernel(fuses):
    """Phase 2, K5-fuse's backward at one train step's 26 recorded
    targets at batch 48 (``fuses``, :func:`train_step_calls`): dx and each
    term's gradient within one bf16 step of ``hr_fuse_backward_plain``
    (the differing elements counted), bit-equal in f32 (batch 2), each
    shift-0 gradient equal to dx, and two calls bit-equal; the 26 calls
    replayed through the kernel and the plain version, as device time;
    the bound is their bytes (dy and y read, dx and every term's
    gradient, the shift-0 copies of dx included, written once each) at
    3.35 TB/s."""
    import torch

    from shapy_tpu_torch.models.backbones.hrnet import (
        _hr_fuse_backward_cuda,
        hr_fuse_backward_plain,
    )
    from shapy_tpu_torch.models.backbones.layers import bf16_step

    worst, differing, elements = 0.0, 0, 0
    for n, (dy, y, shifts) in enumerate(fuses):
        got = _hr_fuse_backward_cuda(dy, y, shifts)
        again = _hr_fuse_backward_cuda(dy, y, shifts)
        want = hr_fuse_backward_plain(dy, y, shifts)
        got32 = _hr_fuse_backward_cuda(dy[:2].float(), y[:2].float(), shifts)
        want32 = hr_fuse_backward_plain(dy[:2].float(), y[:2].float(), shifts)
        for g, s in zip(got[1], shifts):
            check(s != 0 or torch.equal(g, got[0]),
                  f"K5-fuse backward {n}: a shift-0 gradient is not dx")
        for a, b, w, a32, w32 in zip([got[0], *got[1]], [again[0], *again[1]],
                                     [want[0], *want[1]],
                                     [got32[0], *got32[1]],
                                     [want32[0], *want32[1]]):
            check(torch.equal(a, b), f"K5-fuse backward {n}: two calls differ")
            check(torch.equal(a32, w32), f"K5-fuse backward {n}: f32 differs")
            check(bool(((a.float() - w.float()).abs()
                        <= bf16_step(w.float().abs())).all()),
                  f"K5-fuse backward {n}: beyond one bf16 step")
            worst = max(worst, max_err(a, w))
            differing += int((a != w).sum())
            elements += a.numel()
    nbytes = sum(y.element_size() * (3 * y.numel() + sum(
        y.numel() >> (2 * s) for s in shifts)) for _, y, shifts in fuses)
    ms = device_ms(replay(_hr_fuse_backward_cuda, fuses))
    plain_ms = device_ms(replay(hr_fuse_backward_plain, fuses), passes=1)
    bound_ms = nbytes / PEAK_BYTES_S * 1e3
    print(f"K5-fuse backward, one train step's {len(fuses)} targets at batch "
          f"{TRAIN_B}: {differing} of {elements} bf16 elements differ from "
          f"plain (max {worst:.3e}, within one bf16 step), f32 bit-equal, two "
          f"calls bit-equal; replayed, device time: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f}, bound {bound_ms:.4f} (bytes "
          f"{nbytes / 1e6:.2f} MB), kernel at {bound_ms / ms:.1%} of its "
          "bound")
    return {"K5_fuse_backward": {
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
        "differing": differing, "elements": elements,
        "timed_as": f"one train step's {len(fuses)} fusion backwards at "
                    f"batch {TRAIN_B}, replayed; the device time of its "
                    "kernels"}}


def _k4_limits(got, want) -> dict:
    """K4's backward ``(dx, dgamma, dbeta)`` against its plain version: dx
    rel 1e-4 in f32 (sums in another order), one bf16 step (2^-7 of the
    largest |dx|) in bf16; dgamma and dbeta rel 1e-4 (f32 sums). Returns
    each error over its limit."""
    import torch

    tol = 1e-4 if want[0].dtype == torch.float32 else 2.0 ** -7
    return {"dx": rel_err(got[0], want[0]) / tol,
            "dgamma": rel_err(got[1], want[1]) / 1e-4,
            "dbeta": rel_err(got[2], want[2]) / 1e-4}


def _bn_calls_checked(what: str, bns, regimes: dict, worst: float,
                      err: float) -> dict:
    """The summary of K4's ``what`` (forward or backward) checked call by
    call at a train step's recorded BNs, without the replays' timings:
    the calls and distinct shapes of each regime, the worst error over its
    limit."""
    by_regime = {k: {"calls": len(v), "shapes": len({tuple(c[0].shape)
                                                      for c in v})}
                 for k, v in regimes.items()}
    shapes = len({tuple(b[1].shape) for b in bns})
    print(f"K4 {what}, a train step's {len(bns)} BNs ({shapes} shapes) at "
          f"batch {TRAIN_B} in bf16, each in its planned regime against the "
          f"plain version: within {worst:.3f} of its limit, two calls "
          f"bit-equal; per regime {by_regime}")
    return {"calls": len(bns), "shapes": shapes, "regimes": by_regime,
            "worst_over_limit": worst, "max_abs_err": err}


def check_bn_backward_replay(bns, expect: int = K4_PER_TRAIN_STEP,
                             replays: bool = True):
    """Phase 2, K4's backward over one train step's 326 recorded calls at
    batch 48 in bf16 (``bns``, :func:`train_step_calls`; ``expect`` their
    number): each call in the regime its plan picks against
    ``batch_norm_train_backward_plain`` (dx within one bf16 step of the
    largest |dx|, dgamma and dbeta rel 1e-4) and two calls bit-equal;
    with ``replays`` (phase 11 checks a ResNet step's calls without them)
    the 326 calls replayed through K4, its plain version, and
    ``F.batch_norm(training=True)``'s autograd backward (the library call,
    on graphs built once from the same inputs). The
    bound sums the calls' bytes (dy and x read, dx written, the per-channel
    vectors) at 3.35 TB/s. The times are device time (:func:`device_ms`):
    the replay's ~700 launches outrun CUDA's launch queue, and its window
    (printed beside) times the host. Per regime: the calls and their
    device time."""
    import torch
    import torch.nn.functional as F

    from shapy_tpu_torch.models.backbones import layers

    check(len(bns) == expect, f"{len(bns)} BN backwards, expected {expect}")
    worst, err = 0.0, 0.0
    calls, regimes = [], {}
    for dy, x, g, mean, inv in bns:
        plan = layers._bn_plan(x.shape[0] * x.shape[2] * x.shape[3],
                               x.shape[1])
        calls.append((dy, x, g, mean, inv, plan))
        got = layers._bn_backward_cuda(*calls[-1])
        again = layers._bn_backward_cuda(*calls[-1])
        want = layers.batch_norm_train_backward_plain(dy.to(x.dtype), x, g,
                                                      mean, inv)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K4 backward {tuple(x.shape)}: two calls differ")
        limits = _k4_limits(got, want)
        worst = max(worst, *limits.values())
        err = max(err, *(max_err(a, b) for a, b in zip(got, want)))
        regimes.setdefault("cluster" if plan.fused else "split",
                           []).append(calls[-1])
    check(worst <= 1.0, f"K4 backward replay at {worst:.3f} of its limit")
    if not replays:
        return _bn_calls_checked("backward", bns, regimes, worst, err)
    kernel = replay(layers._bn_backward_cuda, calls)
    plain = replay(
        lambda dy, x, g, m, i: layers.batch_norm_train_backward_plain(
            dy.to(x.dtype), x, g, m, i), bns)
    graphs = []
    for dy, x, g, _m, _i in bns:
        xl, gl = x.detach().requires_grad_(), g.detach().requires_grad_()
        bl = torch.zeros_like(gl).requires_grad_()
        yl = F.batch_norm(xl, None, None, gl, bl, True, 0.1, layers.BN_EPS)
        graphs.append((yl, (xl, gl, bl), dy.to(x.dtype)))

    library = replay(lambda yl, ins, dy: torch.autograd.grad(
        yl, ins, dy, retain_graph=True), graphs)
    ms, on_card = device_time(kernel)
    plain_ms = device_ms(plain, passes=1)
    library_ms = device_ms(library)
    window_ms = {"kernel": time_ms(kernel, iters=5, warmup=1),
                 "library": time_ms(library, iters=5, warmup=1)}
    by_regime = {k: {"calls": len(v), "ms": device_ms(replay(
        layers._bn_backward_cuda, v))} for k, v in regimes.items()}
    nbytes = sum(3.0 * x.numel() * x.element_size() + 6.0 * x.shape[1] * 4
                 for _dy, x, *_ in bns)
    bound_ms = nbytes / PEAK_BYTES_S * 1e3
    del graphs
    print(f"K4 backward, one train step's {len(bns)} BN backwards at batch "
          f"{TRAIN_B} (bf16; {on_card} device kernels), device time of a "
          f"replay: kernel {ms:.3f} ms, plain {plain_ms:.3f}, "
          f"F.batch_norm's backward {library_ms:.3f} (kernel / library "
          f"{ms / library_ms:.3f}); one CUDA-event window, host launches "
          f"included: kernel {window_ms['kernel']:.3f}, library "
          f"{window_ms['library']:.3f}; bound {bound_ms:.3f} ms (bytes; "
          f"{nbytes / 1e9:.3f} GB), kernel at {bound_ms / ms:.1%} of its "
          f"bound; per regime {by_regime}; each call within {worst:.3f} of "
          f"its limit, two calls bit-equal; {gpu_line()}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "device_kernels": on_card,
            "window_ms": window_ms, "regimes": by_regime,
            "worst_over_limit": worst,
            "library_call": "torch.autograd.grad of F.batch_norm("
                            "training=True), bf16 channels_last",
            "timed_as": f"one train step's {len(bns)} BN backwards at batch "
                        f"{TRAIN_B}, each with its own input and cotangent, "
                        "replayed; the device time of its kernels "
                        "(torch.profiler)"}


def _k4_forward_limits(got, want) -> dict:
    """K4's forward ``(y, mean, inv)`` against its plain version: y rel
    1e-4 in f32 (sums in another order), one bf16 step (2^-7 of the
    largest |y|) in bf16; mean and inv rel 1e-4 (f32 sums). Returns each
    error over its limit."""
    import torch

    tol = 1e-4 if want[0].dtype == torch.float32 else 2.0 ** -7
    return {"y": rel_err(got[0], want[0]) / tol,
            "mean": rel_err(got[1], want[1]) / 1e-4,
            "inv": rel_err(got[2], want[2]) / 1e-4}


def check_bn_forward_replay(bns, expect: int = K4_PER_TRAIN_STEP,
                            replays: bool = True):
    """Phase 2, K4's forward over one train step's 326 recorded BNs at
    batch 48 in bf16 (the inputs x and gamma of ``bns``,
    :func:`train_step_calls`, ``expect`` their number; beta and the
    running stats from the seed): each call in the regime its plan picks
    against ``batch_norm_train_plain`` (y within one bf16 step of the
    largest |y|; mean, inv and the running stats' EMA rel 1e-4) and two
    calls bit-equal; with ``replays`` (phase 11 checks a ResNet step's BNs
    without them) the 326 calls replayed through K4, its plain version
    and ``F.batch_norm(training=True)`` (the library call, with the same
    running stats). The bound sums the calls' bytes (x read once, y
    written once, the per-channel vectors) at 3.35 TB/s. The times are
    device time (:func:`device_ms`), as the backward's replay; per
    regime, the calls and their device time."""
    import torch
    import torch.nn.functional as F

    from shapy_tpu_torch.models.backbones import layers

    check(len(bns) == expect, f"{len(bns)} BN forwards, expected {expect}")
    gen = torch.Generator().manual_seed(SEED + 12)
    worst, err = 0.0, 0.0
    calls, plain_calls, library_calls, regimes = [], [], [], {}
    for _dy, x, g, _m, _i in bns:
        C = x.shape[1]
        R = x.numel() // C
        beta = (torch.randn(C, generator=gen) * 0.1).to(x.device)
        rm = torch.randn(C, generator=gen).to(x.device)
        rv = (torch.rand(C, generator=gen) + 0.5).to(x.device)
        plan = layers._bn_plan(R, C, True)
        args = (x, g, beta, rm.clone(), rv.clone(), layers.BN_EPS,
                layers.BN_MOMENTUM, plan)
        calls.append(args)
        got = layers._bn_forward_cuda(*args)
        stats = (args[3].clone(), args[4].clone())
        again = layers._bn_forward_cuda(x, g, beta, rm.clone(), rv.clone(),
                                        layers.BN_EPS, layers.BN_MOMENTUM,
                                        plan)
        y_p, mean_p, var_p = layers.batch_norm_train_plain(x, g, beta)
        want = (y_p, mean_p, torch.rsqrt(var_p + layers.BN_EPS))
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K4 forward {tuple(x.shape)}: two calls differ")
        limits = _k4_forward_limits(got, want)
        m = layers.BN_MOMENTUM
        ema = ((1 - m) * rm + m * mean_p,
               (1 - m) * rv + m * var_p * (R / (R - 1)))
        limits.update({"running_mean": rel_err(stats[0], ema[0]) / 1e-4,
                       "running_var": rel_err(stats[1], ema[1]) / 1e-4})
        worst = max(worst, *limits.values())
        err = max(err, *(max_err(a, b) for a, b in zip(got, want)))
        regimes.setdefault("cluster" if plan.fused else "split",
                           []).append(args)
        plain_calls.append((x, g, beta))
        library_calls.append((x, rm.clone(), rv.clone(), g, beta))
    check(worst <= 1.0, f"K4 forward replay at {worst:.3f} of its limit")
    if not replays:
        return _bn_calls_checked("forward", bns, regimes, worst, err)
    kernel = replay(layers._bn_forward_cuda, calls)
    plain = replay(layers.batch_norm_train_plain, plain_calls)
    library = replay(lambda x, rm, rv, g, b: F.batch_norm(
        x, rm, rv, g, b, True, layers.BN_MOMENTUM, layers.BN_EPS),
        library_calls)
    ms, on_card = device_time(kernel)
    plain_ms = device_ms(plain, passes=1)
    library_ms = device_ms(library)
    window_ms = {"kernel": time_ms(kernel, iters=5, warmup=1),
                 "library": time_ms(library, iters=5, warmup=1)}
    by_regime = {}
    for k, v in regimes.items():
        r_ms, r_kernels = device_time(replay(layers._bn_forward_cuda, v))
        by_regime[k] = {"calls": len(v), "ms": r_ms,
                        "device_kernels": r_kernels}
    nbytes = sum(2.0 * x.numel() * x.element_size() + 8.0 * x.shape[1] * 4
                 for x, *_ in plain_calls)
    bound_ms = nbytes / PEAK_BYTES_S * 1e3
    check(on_card < 3 * len(bns), f"K4's forward ran {on_card} device "
          f"kernels for {len(bns)} BNs")
    print(f"K4 forward, one train step's {len(bns)} BNs at batch {TRAIN_B} "
          f"(bf16; {on_card} device kernels), device time of a replay: "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f}, F.batch_norm "
          f"{library_ms:.3f} (kernel / library {ms / library_ms:.3f}); one "
          f"CUDA-event window, host launches included: kernel "
          f"{window_ms['kernel']:.3f}, library {window_ms['library']:.3f}; "
          f"bound {bound_ms:.3f} ms (bytes; {nbytes / 1e9:.3f} GB), kernel "
          f"at {bound_ms / ms:.1%} of its bound; per regime {by_regime}; "
          f"each call within {worst:.3f} of its limit, two calls "
          f"bit-equal; {gpu_line()}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "device_kernels": on_card,
            "window_ms": window_ms, "regimes": by_regime,
            "worst_over_limit": worst,
            "library_call": "F.batch_norm(training=True) with running "
                            "stats, bf16 channels_last",
            "timed_as": f"one train step's {len(bns)} BN forwards at batch "
                        f"{TRAIN_B}, each with its own input, replayed; the "
                        "device time of its kernels (torch.profiler)"}


def _backbone_group(name: str) -> str:
    head = name.split(".")[0]
    return "stem" if head in ("conv1", "bn1", "conv2", "bn2") else head


def _group_gradients(a: dict, b: dict) -> dict:
    """Per module group (stem, layer1, transitions, stages, subsample
    chains, head convs): the cosine of the gradients ``a`` and ``b`` and
    their L2 distance relative to ``b``'s norm."""
    sums = {}  # per group: |a|^2, |b|^2, |a - b|^2, a . b
    for k, ga in a.items():
        gb = b[k]
        acc = sums.setdefault(_backbone_group(k), [0.0] * 4)
        for i, v in enumerate((ga * ga, gb * gb, (ga - gb) ** 2, ga * gb)):
            acc[i] += float(v.sum())
    return {name: {"cosine": ab / (aa * bb) ** 0.5,
                   "relative_l2": (dd / bb) ** 0.5}
            for name, (aa, bb, dd, ab) in sums.items()}


def check_backbone_train_routes(base, dev):
    """Phase 2, the whole backbone in train mode at batch 48 (f32 master
    weights, BN unfolded): a forward and backward of a fixed random
    projection of its features through the K5 route (K5-conv, K5-dgrad,
    K5-wgrad, K5-fuse and its backward) and through the plain route (the
    plain versions on the card: cuDNN convs and their gradients, eager
    adds, nearest upsamples and box sums).

    In f32 (TF32 off) the two routes' gradients are held per module group
    to a cosine >= 0.999 and a relative L2 <= 0.05. In bf16 both routes
    are timed, and each is held against the f32 plain route: in each
    group the K5 route's cosine with it may fall at most
    ``BF16_COSINE_MARGIN`` below the plain route's, and its relative L2
    distance may exceed the plain route's by at most 5%. A bf16 limit
    between the two bf16 routes themselves cannot hold: with these random
    weights the bf16 gradient of either route is mostly rounding noise
    amplified through ~100 train-mode BN backwards, so two bf16 routes
    that sum in other orders disagree as much as each does with f32. A
    third bf16 route, the plain one with ``F.batch_norm`` (cuDNN) in
    place of K4, is the witness that this is no fault of K4, which the
    first two share: its cosines with f32 are as low (PERF.md). The
    cosine floor fails a gradient that is noise: the head groups' cosine
    with f32 is ~0.75 on every route, a random one's ~0."""
    import torch
    import torch.nn.functional as F

    from shapy_tpu_torch.models.backbones import hrnet, layers

    def cudnn_bn(x, gamma, beta, running_mean, running_var, eps, momentum):
        return F.batch_norm(x, running_mean, running_var, gamma, beta, True,
                            momentum, eps)

    gen = torch.Generator().manual_seed(SEED + 16)
    x32 = torch.randn((TRAIN_B, 3, CROP, CROP), generator=gen)
    g = torch.randn((TRAIN_B, 2048), generator=gen).to(dev)
    plain = {(layers, "_conv2d_act_cuda"): layers.conv2d_act_plain,
             (layers, "_conv2d_backward_cuda"): layers.conv2d_backward_plain,
             (hrnet, "_hr_fuse_cuda"): hrnet.hr_fuse_plain,
             (hrnet, "_hr_fuse_backward_cuda"): hrnet.hr_fuse_backward_plain}
    f32, bf16 = torch.float32, torch.bfloat16
    routes = {"f32 K5": (f32, {}), "f32 plain": (f32, plain),
              "bf16 K5": (bf16, {}), "bf16 plain": (bf16, plain),
              "bf16 plain, F.batch_norm": (
                  bf16, {**plain, (layers, "batch_norm_train"): cudnn_bn})}
    tf32 = torch.backends.cudnn.allow_tf32
    runs, times, peaks = {}, {}, {}
    for name, (dtype, patch) in routes.items():
        x = x32.to(dev, dtype).contiguous(memory_format=torch.channels_last)
        net = copy.deepcopy(base.backbone).to(dev).train().to(
            memory_format=torch.channels_last)

        def run():
            net.zero_grad(set_to_none=True)
            feat = net(x)
            (feat.float() * g).sum().backward()
            return feat.detach()

        saved = {key: getattr(*key) for key in patch}
        for (mod, attr), fn in patch.items():
            setattr(mod, attr, fn)
        torch.backends.cudnn.allow_tf32 = False
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            feat = run().double()
            peaks[name] = (torch.cuda.max_memory_allocated()
                           - resident) / 2 ** 30
            grads = {k: p.grad.double() for k, p in net.named_parameters()}
            if name in ("bf16 K5", "bf16 plain"):
                times[name] = time_ms(run, iters=5, warmup=1)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
            for (mod, attr), fn in saved.items():
                setattr(mod, attr, fn)
        check(all(bool(torch.isfinite(t).all()) for t in grads.values()),
              f"non-finite gradients ({name})")
        runs[name] = (feat, grads)
        del net
    ref = runs["f32 plain"][1]
    f32_groups = _group_gradients(runs["f32 K5"][1], ref)
    to_f32 = {name: _group_gradients(runs[name][1], ref)
              for name in ("bf16 K5", "bf16 plain",
                           "bf16 plain, F.batch_norm")}
    k5, pl = to_f32["bf16 K5"], to_f32["bf16 plain"]
    bf16_groups = _group_gradients(runs["bf16 K5"][1],
                                   runs["bf16 plain"][1])
    cos = min(m["cosine"] for m in f32_groups.values())
    rel = max(m["relative_l2"] for m in f32_groups.values())
    ratio = max(k5[n]["relative_l2"] / pl[n]["relative_l2"] for n in k5)
    drop = max(pl[n]["cosine"] - k5[n]["cosine"] for n in k5)

    def fcos(a, b):
        return float(torch.nn.functional.cosine_similarity(
            runs[a][0].flatten(), runs[b][0].flatten(), dim=0))

    def fmt(groups):
        return ", ".join(f"{k} {v['cosine']:.5f}/{v['relative_l2']:.3e}"
                         for k, v in groups.items())

    against = "; ".join(
        f"{name}: features cosine {fcos(name, 'f32 plain'):.6f}, "
        f"{fmt(groups)}" for name, groups in to_f32.items())
    print(f"backbone train step batch {TRAIN_B} (forward + backward), bf16: "
          f"K5 route {times['bf16 K5']:.3f} ms, plain route (cuDNN + eager) "
          f"{times['bf16 plain']:.3f} ms. f32 (no TF32), K5 against plain: "
          f"features cosine {fcos('f32 K5', 'f32 plain'):.6f}, gradients of "
          f"{len(f32_groups)} module groups cosine >= {cos:.6f} (tol "
          f"0.999), relative L2 <= {rel:.3e} (tol 0.05): {fmt(f32_groups)}. "
          f"Against the f32 plain route (cosine/relative L2), {against}. "
          f"K5's cosine at most {drop:.5f} below the plain route's (tol "
          f"{BF16_COSINE_MARGIN}), its relative L2 at most {ratio:.4f} of "
          f"the plain route's (tol 1.05). bf16 K5 against bf16 plain: "
          f"features cosine {fcos('bf16 K5', 'bf16 plain'):.6f}, "
          f"{fmt(bf16_groups)}. Peak memory above the resident weights: "
          + ", ".join(f"{k} {v:.3f} GiB" for k, v in peaks.items()))
    check(cos >= 0.999 and rel <= 0.05, "K5 f32 train backbone vs plain")
    check(drop <= BF16_COSINE_MARGIN and ratio <= 1.05,
          "K5 bf16 train gradients farther from f32 than the plain route's")
    return {"k5_ms": times["bf16 K5"], "plain_ms": times["bf16 plain"],
            "peak_gib": peaks, "f32_min_cosine": cos,
            "f32_max_relative_l2": rel, "bf16_cosine_drop": drop,
            "bf16_relative_l2_to_f32_ratio": ratio, "f32": f32_groups,
            "bf16_vs_f32": to_f32, "bf16_k5_vs_bf16_plain": bf16_groups}


def _train_step_once(reg, batch, device, loss_cfg):
    """One train step of ``reg`` on ``device``: (losses, gradients,
    parameters before and after), on the CPU."""
    from shapy_tpu_torch.flagship import FLAGSHIP_OPTIM_CFG
    from shapy_tpu_torch.train.losses import RegressorLosses
    from shapy_tpu_torch.train.step import init_train_state, make_train_step

    step = make_train_step(reg, RegressorLosses(loss_cfg),
                           init_train_state(reg, FLAGSHIP_OPTIM_CFG))
    b = {k: v.to(device) for k, v in batch.items()}
    images = b.pop("images")
    before = {k: p.detach().cpu() for k, p in reg.named_parameters()}
    loss = step.forward(images, b)
    step.backward(loss)
    grads = {k: p.grad.detach().cpu() for k, p in reg.named_parameters()}
    step.update()
    return ({k: float(v.detach()) for k, v in loss.items()}, grads, before,
            {k: p.detach().cpu() for k, p in reg.named_parameters()})


def _module(name: str) -> str:
    parts = name.split(".")
    if parts[0] != "backbone":
        return parts[0]
    if parts[1] in ("conv1", "bn1", "conv2", "bn2"):
        return "backbone.stem"
    return ".".join(parts[:2])


def train_parity(base, dev):
    """Phase 4, training: one train step of the same weights at batch 2,
    f32, TF32 off, dropout 0, with the height, chest, waist and hips losses
    at weight 1.0 against GT measurements from K1 on the GT bodies, on the
    CPU port (plain versions) and the CUDA port (kernels, K1's backward
    among them): the losses, the gradient of each module (norm and
    cosine), the head's gradients elementwise, and the updated
    parameters."""
    import torch

    from shapy_tpu_torch.flagship import (
        FLAGSHIP_OPTIM_CFG,
        FLAGSHIP_TRAIN_LOSS_CFG,
        synthetic_train_batches,
    )
    from shapy_tpu_torch.measure.measurements import MEASURE_KERNEL

    loss_cfg = {"body": dict(FLAGSHIP_TRAIN_LOSS_CFG["body"],
                             **{k: {"weight": 1.0} for k in MEASURED})}
    reg = copy.deepcopy(base).to(dev)
    gt_betas = synthetic_train_batches(reg, 1, 2, CROP, SEED + 8)[0][
        "gt_betas"]
    with torch.no_grad():
        gt = reg.body_measurements.forward_from_vertices(
            reg.model.forward_shape(gt_betas)["v_shaped"],
            use_face_subsets=False)["measurements"]
    gt = {k: gt[k]["tensor"].cpu() for k in MEASURED}
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        runs = []
        for device in ("cpu", dev):
            reg = copy.deepcopy(base).to(device)
            reg.head.dropout = 0.0
            reg.prepare_for_train_(torch.float32)
            batch = synthetic_train_batches(reg, 1, 2, CROP, SEED + 8)[0]
            batch.update({k: v.to(device) for k, v in gt.items()})
            before = MEASURE_KERNEL.counts["measure_backward"]
            k5_before = read_launches()
            runs.append(_train_step_once(reg, batch, device, loss_cfg))
            bwd_launches = MEASURE_KERNEL.counts["measure_backward"] - before
            k5 = {n: read_launches()[n] - k5_before[n]
                  for n in K5_PER_TRAIN_STEP}
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    (loss_c, grad_c, old, new_c), (loss_g, grad_g, _, new_g) = runs
    check(all(k in loss_g for k in MEASURED), "no measurement losses")
    check(bwd_launches == 1, f"K1's backward launched {bwd_launches} times "
          "by the CUDA train step")
    check(k5 == K5_PER_TRAIN_STEP, f"the f32 CUDA train step's K5 launches "
          f"{k5}, expected {K5_PER_TRAIN_STEP}")
    loss_rel = max(abs(loss_g[k] - v) / abs(v) for k, v in loss_c.items())
    sums = {}
    for k, gc in grad_c.items():
        gc, gg = gc.double(), grad_g[k].double()
        acc = sums.setdefault(_module(k), [0.0, 0.0, 0.0])
        acc[0] += float((gc * gc).sum())
        acc[1] += float((gg * gg).sum())
        acc[2] += float((gc * gg).sum())
    norm_rel = max(abs(b ** 0.5 - a ** 0.5) / a ** 0.5
                   for a, b, _ in sums.values())
    cos = min(c / (a * b) ** 0.5 for a, b, c in sums.values())
    # the head's gradients carry those of the body model's kernels (K3,
    # K3-chain, through the betas and poses it predicts): elementwise,
    # relative to each tensor's largest
    head_err = max(float((grad_g[k] - gc).abs().max() / gc.abs().max())
                   for k, gc in grad_c.items() if k.startswith("head."))
    # Adam's first update is lr x sign(g + wd p): elements whose decayed
    # gradient has the same sign on both sides (and is above 1e-6) must
    # agree to 1e-5; any element to 2 lr.
    flipped = total = 0
    same_err = all_err = 0.0
    wd = FLAGSHIP_OPTIM_CFG["weight_decay"]
    for k, gc in grad_c.items():
        decay = 0.0 if "bias" in k else wd * old[k]  # no decay on biases
        tc, tg = gc + decay, grad_g[k] + decay
        same = (torch.sign(tc) == torch.sign(tg)) & (tc.abs() > 1e-6) & (
            tg.abs() > 1e-6)
        d = (new_c[k] - new_g[k]).abs()
        if same.any():
            same_err = max(same_err, float(d[same].max()))
        all_err = max(all_err, float(d.max()))
        flipped += int(((torch.sign(tc) != torch.sign(tg)) & (
            tc.abs() > 1e-6) & (tg.abs() > 1e-6)).sum())
        total += d.numel()
    print(f"cross-device train step (batch 2, f32, no TF32, measurement "
          f"losses at 1.0): loss "
          f"{loss_c['total']:.6f} vs {loss_g['total']:.6f} ("
          + ", ".join(f"{k} {loss_g[k]:.5f}" for k in MEASURED)
          + f"), terms rel err "
          f"{loss_rel:.3e} (tol 1e-4); gradients of {len(sums)} modules: "
          f"norm rel err <= {norm_rel:.3e} (tol 2e-2), cosine >= {cos:.6f} "
          f"(tol 0.998); head gradients err <= {head_err:.3e} of each "
          f"tensor's largest (tol 2e-3); updated params err "
          f"{same_err:.3e} (tol 1e-5) where the decayed gradients agree in "
          f"sign, {all_err:.3e} on all (tol "
          f"2 lr = 2e-4); signs turned over on {flipped} of {total} "
          "(tol 5%)")
    check(loss_rel <= 1e-4, f"cross-device train loss {loss_rel}")
    check(norm_rel <= 2e-2 and cos >= 0.998,
          f"cross-device gradients: norm {norm_rel}, cosine {cos}")
    check(head_err <= 2e-3, f"cross-device head gradients {head_err}")
    check(same_err <= 1e-5, f"cross-device updated params {same_err}")
    check(all_err <= 2e-4 + 1e-6, f"cross-device updated params {all_err}")
    check(flipped < 0.05 * total, f"gradient signs turned over on "
          f"{flipped / total}")


def _no_cudnn_step(trainer, batch,
                   nodes=("_Conv2dActBackward", "_HrFuseBackward")) -> None:
    """One more step of ``trainer`` with ``F.conv2d`` and ``F.max_pool2d``
    made to raise and the host's operators recorded by ``torch.profiler``
    (the autograd engine's backward threads included): no convolution or
    pooling operator, forward or backward, may appear; the hand-written
    kernels' autograd Functions' backwards (``nodes``) must."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def refuse(*args, **kwargs):
        raise RuntimeError("F.conv2d reached in training")

    F = torch.nn.functional
    conv2d, max_pool2d = F.conv2d, F.max_pool2d
    F.conv2d = F.max_pool2d = refuse
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            trainer.fit({"train": batch}, 1, seed=SEED)
            torch.cuda.synchronize()
    finally:
        F.conv2d, F.max_pool2d = conv2d, max_pool2d
    names = {e.name for e in prof.events()}
    convs = sorted(n for n in names if "convolution" in n or "cudnn" in n
                   or n == "aten::conv2d" or "pool" in n)
    k5 = sorted(n for n in names if any(f in n for f in nodes))
    print(f"train step under the profiler: {len(names)} operator names, "
          f"convolution and pooling operators {convs}, backward nodes of "
          f"the hand-written kernels {k5}")
    check(not convs, f"training reached library convolutions or pooling: "
                     f"{convs}")
    check(all(any(f in n for n in k5) for f in nodes),
          "the profile holds no backward of the hand-written kernels: the "
          "guard would not see a convolution backward either")


def _step_device_kernels(trainer, batch, present, absent,
                         tries: int = 3) -> None:
    """One more step of ``trainer`` under a CUDA trace (no call run first:
    :func:`_device_trace`'s lead and marker): each name in ``present``
    must be part of a kernel's name, none in ``absent`` (a trace can drop
    events: taken again, a step each, at most ``tries`` times, until every
    ``present`` name shows)."""
    names, missing = collections.Counter(), list(present)
    for _ in range(tries):
        traced = _device_trace(
            lambda: trainer.fit({"train": batch}, 1, seed=SEED), 1,
            first=False)
        if traced is None:
            print("device trace lost its marker: taken again", flush=True)
            continue
        names = traced[1]
        missing = [p for p in present if not any(p in k for k in names)]
        if not missing:
            break
    found = sorted(k for k in names if any(a in k for a in absent))
    print(f"a train step's device kernels: {sum(names.values())} launches "
          f"of {len(names)} kernels; {list(present)} among them, missing "
          f"{missing}; of {list(absent)}: {found}")
    check(not missing and not found,
          f"a train step's kernels: missing {missing}, found {found}")


def train(base, dev, per_step: dict = K5_PER_TRAIN_STEP,
          steps: tuple = (TRAIN_WARMUP, TRAIN_STEPS),
          path_kernels=TRAIN_KERNELS,
          nodes=("_Conv2dActBackward", "_HrFuseBackward"),
          what: str = "train", device_kernels=(TRAIN_DEVICE_KERNELS, ())):
    """Phase 7: ``Trainer.fit`` on the flagship at full width, batch 48,
    bf16 backbone, dropout 0.5: 2 warm-up steps, then 10 steps on one
    fixed synthetic batch, then one step under the cuDNN guard
    (:func:`_no_cudnn_step`) and one under a CUDA trace, which must run
    the device functions named in ``device_kernels[0]`` and none of
    ``device_kernels[1]`` (:func:`_step_device_kernels`). Returns the
    launches of the 10 steps and {steps/s, images/s, peak memory}. Phase
    11 trains the ResNets the same way (``steps``: warm-up and timed
    steps; ``per_step`` the backbone's launches a step)."""
    import torch

    from shapy_tpu_torch.flagship import (
        FLAGSHIP_OPTIM_CFG,
        FLAGSHIP_TRAIN_LOSS_CFG,
        synthetic_train_batches,
    )
    from shapy_tpu_torch.train.losses import RegressorLosses
    from shapy_tpu_torch.train.trainer import Trainer

    reg = _train_regressor(base, dev)
    batch = synthetic_train_batches(reg, 1, TRAIN_B, CROP, SEED + 9)
    warmup, timed = steps
    trainer = Trainer(reg, RegressorLosses(FLAGSHIP_TRAIN_LOSS_CFG),
                      FLAGSHIP_OPTIM_CFG, summary_steps=warmup + timed,
                      device=dev)
    trainer.fit({"train": batch}, warmup, seed=SEED)
    mean0 = reg.param_mean.clone()
    stats0 = {k: v.clone() for k, v in reg.named_buffers()
              if "running_" in k}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # What is allocated before the timed steps, by this phase and by the
    # script's earlier phases: the peak less this is the steps' own.
    held = torch.cuda.memory_allocated()
    totals = []
    reset_launches()
    start = time.perf_counter()
    last = trainer.fit({"train": batch}, timed, seed=SEED,
                       on_step=lambda s, m: totals.append(m["total"]))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()

    totals = [float(t) for t in totals]
    check(len(totals) == timed and all(map(math.isfinite, totals)),
          f"{what} losses {totals}")
    check(all(math.isfinite(v) for v in last.values()), f"losses {last}")
    check(totals[-1] < totals[0], f"the loss did not fall: {totals}")
    moved = sum(not torch.equal(v, stats0[k]) for k, v in
                reg.named_buffers() if "running_" in k)
    check(moved == len(stats0), f"{len(stats0) - moved} BN running stats "
          "did not move")
    check(torch.equal(reg.param_mean, mean0), "param_mean moved")
    for name in path_kernels:
        check(launches[name] > 0, f"{name} was not launched by {what}")
    for name in BACKBONE_KERNELS:
        per = per_step.get(name, 0)
        check(launches[name] == per * timed,
              f"{name}: {launches[name]} launches in {timed} {what} "
              f"steps, expected {per} a step")
    _no_cudnn_step(trainer, batch, nodes)
    _step_device_kernels(trainer, batch, *device_kernels)
    rates = {"steps_per_s": timed / elapsed,
             "images_per_s": timed * TRAIN_B / elapsed,
             "peak_memory_gib": peak / 2 ** 30,
             "held_before_gib": held / 2 ** 30}
    print(f"{what}: {timed} steps of batch {TRAIN_B} in "
          f"{elapsed * 1e3:.1f} ms = {rates['steps_per_s']:.3f} steps/s = "
          f"{rates['images_per_s']:.1f} images/s; peak memory "
          f"{peak / 2 ** 30:.3f} GiB, of which {held / 2 ** 30:.3f} GiB "
          f"held before the steps; total loss {totals[0]:.4f} -> "
          f"{totals[-1]:.4f}; last losses {json.dumps(last)}; {moved} BN "
          f"running stats moved, param_mean fixed; launches {launches}; "
          f"{gpu_line()}")
    return launches, rates


def train_resume(base, dev) -> None:
    """Phase 10: kill and resume on the card. 4 steps of one Trainer
    against 2 steps of another that checkpoints into a temporary
    directory, then a third Trainer on a fresh copy of the weights that
    resumes from it and takes 2 more steps, over two distinct batches of
    48 (the resumed stream starts at the global step), dropout 0.5: every
    parameter, BN running stat, ``param_mean``, Adam moment and the step
    count bit-equal."""
    import tempfile

    import torch

    from shapy_tpu_torch.flagship import (
        FLAGSHIP_OPTIM_CFG,
        FLAGSHIP_TRAIN_LOSS_CFG,
        synthetic_train_batches,
    )
    from shapy_tpu_torch.io.checkpoint import Checkpointer
    from shapy_tpu_torch.train.losses import RegressorLosses
    from shapy_tpu_torch.train.trainer import Trainer

    def trainer(folder=None):
        return Trainer(_train_regressor(base, dev),
                       RegressorLosses(FLAGSHIP_TRAIN_LOSS_CFG),
                       FLAGSHIP_OPTIM_CFG, checkpoint_steps=2,
                       checkpointer=None if folder is None else
                       Checkpointer(folder), device=dev)

    def state(t):
        opt = t.state.optimizer.state_dict()["state"]
        return ({k: v.clone() for k, v in t.regressor.state_dict().items()},
                {(i, k): v.clone() for i, st in opt.items()
                 for k, v in st.items()})

    whole = trainer()
    loaders = {"train": synthetic_train_batches(whole.regressor, 2, TRAIN_B,
                                                CROP, SEED + 10)}
    whole.fit(loaders, 4, seed=SEED)
    want = state(whole)
    del whole
    with tempfile.TemporaryDirectory() as folder:
        trainer(folder).fit(loaders, 2, seed=SEED)
        t0 = time.perf_counter()
        resumed = trainer(folder)
        resumed.resume()
        resume_s = time.perf_counter() - t0
        check(resumed.state.step == 2, f"resumed at {resumed.state.step}")
        resumed.fit(loaders, 2, seed=SEED)
    got = state(resumed)
    check(resumed.state.step == 4, "resumed run's step count")
    differ = [k for part in (0, 1) for k in want[part]
              if not torch.equal(want[part][k], got[part][k])]
    print(f"resume: 4 steps of batch {TRAIN_B} against 2 + checkpoint + "
          f"resume ({resume_s:.2f} s) + 2: {len(want[0])} module tensors and "
          f"{len(want[1])} optimizer tensors compared, {len(differ)} differ "
          f"{differ[:5]}")
    check(not differ, f"kill and resume differs from 4 steps: {differ[:5]}")


def resnet_base(depth: int):
    """The flagship on ResNet-``depth`` (``build_flagship(backbone=
    "resnet<depth>")``) on the CPU, its weights spread from the seed as
    phase 3's HRNet-W48's."""
    from shapy_tpu_torch.flagship import build_flagship, spread_init_

    base = build_flagship(subdivisions=5, exact_counts=True, device="cpu",
                          seed=SEED, backbone=f"resnet{depth}")
    return spread_init_(base, seed=SEED, beta_scale=0.25)


def request_device(regressor, requests, rate: float) -> dict:
    """One served request's host-clock ms (from ``rate``, images/s), its
    device busy ms (:func:`device_time`), kernels and the idle share 1 -
    busy / wall."""
    import torch

    images, affines = requests
    wall_ms = images.shape[0] / rate * 1e3
    with torch.inference_mode():
        busy, kernels = device_time(
            lambda: regressor.apply_from_full_images(images, affines, CROP))
    return {"batch": images.shape[0], "images_per_s": rate,
            "request_ms": wall_ms, "device_busy_ms": busy,
            "device_kernels": kernels,
            "idle_share": max(0.0, 1.0 - busy / wall_ms)}


def _pool_planted(x):
    """x with planted windows: an all-zero block (whole windows of zeros)
    and a tie across the overlap of two windows, in every channel."""
    x = x.clone()
    x[0, :, :8, :8] = 0
    x[1, :, 4, 3:8] = 1.5
    x[1, :, 3:6, 5] = 1.5
    return x


def _pool_small_cases(dev):
    """(dy, x) of K11's backward at odd and tiny sides and narrow rows:
    small integers after a ReLU (most windows tie), a corner all zero;
    8-channel bf16 and 4-channel f32 rows among them."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 33)
    cases = []
    for n, c, h, w, dt in ((2, 64, 33, 17, torch.bfloat16),
                           (2, 64, 33, 17, torch.float32),
                           (3, 8, 21, 19, torch.bfloat16),
                           (3, 4, 19, 21, torch.float32),
                           (1, 8, 1, 1, torch.bfloat16),
                           (2, 8, 2, 3, torch.bfloat16)):
        x = torch.randint(-2, 3, (n, c, h, w), generator=gen).float()
        x = x.clamp_min(0)
        x[0, :, :6, :6] = 0.0
        dy = torch.randn((n, c, (h - 1) // 2 + 1, (w - 1) // 2 + 1),
                         generator=gen)
        cl = torch.channels_last
        cases.append((dy.to(dev, dt).contiguous(memory_format=cl),
                      x.to(dev, dt).contiguous(memory_format=cl)))
    return cases


def check_pool_kernels(x_served, pools):
    """Phase 11, K11 against its plain versions on the card. The forward
    at the served ResNet-50's stem output (batch 32, bf16, 64 x 128^2,
    windows planted by :func:`_pool_planted`): bit-equal in bf16 and in
    f32 (the same maxima); timed beside ``F.max_pool2d``. The backward at
    a train step's recorded ``(dy, x)`` at batch 48 (``pools``), planted
    the same way, and at odd and tiny sides with 8- and 4-channel rows
    (:func:`_pool_small_cases`): bit-equal in bf16 and in f32 (the same
    first maxima, the same f32 sums in the same order, rounded once), two
    calls bit-equal, one launch a call; timed beside ATen's
    ``max_pool2d_with_indices_backward`` (the library backward, given the
    forward's indices). Bounds: the bytes read and written once at 3.35
    TB/s."""
    import torch
    import torch.nn.functional as F

    from shapy_tpu_torch.models.backbones.layers import (
        POOL_KERNEL,
        _max_pool2d_backward_cuda,
        _max_pool2d_cuda,
        max_pool2d_backward_plain,
        max_pool2d_plain,
        max_pool_backward_plan,
    )

    out = {}
    x = _pool_planted(x_served)
    y = _max_pool2d_cuda(x)
    y32 = _max_pool2d_cuda(x.float())
    want = max_pool2d_plain(x)
    torch.cuda.synchronize()
    equal = torch.equal(y, want) and torch.equal(y32, want.float())
    print(f"K11 forward at {tuple(x.shape)} bf16: bit-equal to the plain "
          f"version {torch.equal(y, want)}, f32 {torch.equal(y32, y.float())}")
    check(equal, "K11 forward differs from its plain version")
    out["K11_max_pool"] = record_kernel(
        out, "K11_max_pool", max_err(y, want), lambda: _max_pool2d_cuda(x),
        lambda: max_pool2d_plain(x), 2.0 * (x.numel() + y.numel()), 0.0,
        lambda: F.max_pool2d(x, 3, 2, 1))
    out["K11_max_pool"].update(
        library_call="F.max_pool2d(x, 3, 2, 1), bf16 channels_last",
        timed_as=f"the served ResNet-50's stem output, batch {B}",
        f32_bit_equal=equal)

    dy, xb = pools[0]
    xb = _pool_planted(xb)
    failed = []
    cases = [(dy, xb), (dy.float(), xb.float())] + _pool_small_cases(
        dy.device)
    for g, xc in cases:
        n0 = POOL_KERNEL.counts["max_pool_backward"]
        dx = _max_pool2d_backward_cuda(g, xc)
        dx2 = _max_pool2d_backward_cuda(g, xc)
        launches = POOL_KERNEL.counts["max_pool_backward"] - n0
        pdx = max_pool2d_backward_plain(g, xc)
        torch.cuda.synchronize()
        differ = int((dx != pdx).sum())
        n, c, h, w = xc.shape
        plan = max_pool_backward_plan(n, h, w, c, xc.element_size())
        tiles = (-(-((h - 1) // 2 + 1) // plan.th)
                 * -(-((w - 1) // 2 + 1) // plan.tw) * (c // plan.cs))
        name = f"{tuple(xc.shape)} {str(xc.dtype)[6:]}"
        print(f"K11 backward at {name}: {differ} of {dx.numel()} elements "
              f"differ from the plain version, two calls equal "
              f"{torch.equal(dx, dx2)}, {launches} launches for 2 calls; "
              f"tiles {plan.th} x {plan.tw} windows x {plan.cs} channels, "
              f"{tiles} an image")
        if differ or not torch.equal(dx, dx2) or launches != 2:
            failed.append(name)
    check(not failed, f"K11 backward differs from its plain version at "
                      f"{failed}")
    dx = _max_pool2d_backward_cuda(dy, xb)
    pdx = max_pool2d_backward_plain(dy, xb)
    _, idx = F.max_pool2d(xb, 3, 2, 1, return_indices=True)
    out["K11_max_pool_backward"] = record_kernel(
        out, "K11_max_pool_backward", max_err(dx, pdx),
        lambda: _max_pool2d_backward_cuda(dy, xb),
        lambda: max_pool2d_backward_plain(dy, xb),
        2.0 * (dy.numel() + 2 * xb.numel()), 0.0,
        lambda: torch.ops.aten.max_pool2d_with_indices_backward(
            dy, xb, [3, 3], [2, 2], [1, 1], [1, 1], False, idx))
    out["K11_max_pool_backward"].update(
        library_call="aten.max_pool2d_with_indices_backward (F.max_pool2d's "
                     "backward, given the forward's indices), bf16",
        timed_as=f"a ResNet-50 train step's pool cotangent, batch {TRAIN_B}",
        kernel="max_pool_backward_kernel (one launch, no scratch)",
        bit_equal_cases=len(cases))
    return out


def check_stem_kernel(stem, stem_train):
    """Phase 11, K10's forward (``stem7_kernel``) beyond the per-shape
    check: the served ResNet-50's stem (``stem``: its recorded call at
    batch 32, the folded BN's bias and the ReLU), the same weights on
    random crops at batch 128, and a train step's bare stem at batch 48
    (``stem_train``: its recorded input and weight), each within K5's bf16
    limit of the plain version (``conv2d_act_bf16_tolerance``, TF32 off
    for the f32 sums), two calls bit-equal and the first and the last
    image alone bit-equal to themselves in the batch; at the odd sides 61
    and 301 (rows of 6 W bytes not a multiple of 16: the direct regime)
    within the same limit. Each is timed beside ``F.conv2d`` with bias
    (cuDNN) and its bound (x read and y written once at 3.35 TB/s; 2 x 147
    FLOP an output at 989 TFLOP/s). Returns the cases."""
    import torch
    import torch.nn.functional as F

    from shapy_tpu_torch.models.backbones.layers import (
        conv2d_act,
        conv2d_act_bf16_tolerance,
        conv2d_act_plain,
        stem_plan,
    )

    gen = torch.Generator().manual_seed(SEED + 17)
    cl = torch.channels_last
    x32, w, b = stem[0], stem[1], stem[2]
    dev = x32.device
    x128 = torch.randn((128, *x32.shape[1:]), generator=gen).to(
        dev, torch.bfloat16).contiguous(memory_format=cl)
    xt, wt = stem_train
    odd = [torch.randn((3, 3, side, side), generator=gen).to(
        dev, torch.bfloat16).contiguous(memory_format=cl)
        for side in (61, 301)]
    runs = [("served b32", x32, w, b, True), ("served b128", x128, w, b, True),
            (f"train b{xt.shape[0]} bare", xt, wt, None, False),
            ("odd 61 bare", odd[0], w, None, False),
            ("odd 301 bias-relu", odd[1], w, b, True)]
    cases, failed = [], []
    for name, x, wc, bc, relu in runs:
        got = conv2d_act(x, wc, bc, None, relu, 2)
        again = conv2d_act(x, wc, bc, None, relu, 2)
        alone = [conv2d_act(x[i:i + 1].contiguous(memory_format=cl), wc, bc,
                            None, relu, 2) for i in (0, x.shape[0] - 1)]
        want = conv2d_act_plain(x, wc, bc, None, relu, 2)
        saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            c = F.conv2d(x.float(), wc.float(), None, 2, 3)
            terms = F.conv2d(x.abs().float(), wc.abs().float(), None, 2, 3)
        finally:
            torch.backends.cudnn.allow_tf32 = saved
        tol = conv2d_act_bf16_tolerance(c, bc, None, terms, 3, 7)
        steps = float(((got.float() - want.float()).abs() / tol).max())
        twice = torch.equal(got, again)
        single = (torch.equal(alone[0], got[:1])
                  and torch.equal(alone[1], got[-1:]))
        torch.cuda.synchronize()
        plan = stem_plan(x.shape[0], *x.shape[2:], wc.shape[0], 2, x.dtype)
        bytes_ms = 2.0 * (x.numel() + got.numel()) / PEAK_BYTES_S * 1e3
        ops_ms = 2.0 * got.numel() * 147 / PEAK_BF16_FLOP_S * 1e3
        case = {"name": name, "shape": list(x.shape), "relu": relu,
                "bias": bc is not None, "staged": plan.staged,
                "max_abs_err": max_err(got, want), "tol_vs_plain": steps,
                "bit_equal_twice": twice, "image_alone_bit_equal": single,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        if not name.startswith("odd"):
            case["ms"] = time_ms(lambda: conv2d_act(x, wc, bc, None, relu, 2))
            case["library_ms"] = time_ms(lambda: F.conv2d(
                x, wc, b, 2, 3))
        print(f"K10 forward {name} {tuple(x.shape)}: {case['max_abs_err']} "
              f"from the plain version, {steps:.3f} of the limit; twice "
              f"bit-equal {twice}, an image alone {single}; "
              f"{'staged (TMA)' if plan.staged else 'direct'}, at most "
              f"{plan.grid} blocks; "
              + (f"kernel {case['ms']:.4f} ms, cuDNN {case['library_ms']:.4f}"
                 f", bound {case['bound_ms']:.4f}" if "ms" in case else ""))
        if not steps <= 1.0 or not twice or not single:  # NaN fails too
            failed.append(name)
        cases.append(case)
    check(not failed, f"K10 forward outside its limits at {failed}")
    return cases


def _stem_entries(fwd_cases, bwd_cases) -> dict:
    """K10's entries from the per-shape cases of its 7x7 shape: the
    forward's at the served batch (:func:`check_conv_kernels`), the weight
    gradient's at a train step's (:func:`check_conv_backward_kernels`)."""
    f = next(c for c in fwd_cases if c["k"] == 7)
    w = next(c for c in bwd_cases if c["k"] == 7)
    return {
        "K10_stem": {
            "max_abs_err": f["max_abs_err"], "ms": f["ms"],
            "plain_ms": f["plain_ms"], "library_ms": f["library_ms"],
            "bound_ms": f["bound_ms"], "bound_by": f["bound_by"],
            "f32_max_rel_err": f["f32_rel_err"],
            "library_call": "F.conv2d(x, w, bias, 2, 3) (cuDNN), bf16 "
                            "channels_last",
            "timed_as": f"the served ResNet-50's stem at batch {B}, bias "
                        "and ReLU of the folded BN",
            "cases": [f]},
        "K10_stem_wgrad": {
            "max_abs_err": w["wgrad_max_abs_err"], "ms": w["wgrad_ms"],
            "plain_ms": w["wgrad_plain_ms"],
            "library_ms": w["wgrad_library_ms"],
            "bound_ms": w["wgrad_bound_ms"], "bound_by": w["wgrad_bound_by"],
            "f32_max_rel_err": w["wgrad_f32_rel_err"],
            "library_call": "torch.ops.aten.convolution_backward (cuDNN), "
                            "the weight gradient alone, bf16",
            "timed_as": f"a ResNet-50 train step's stem at batch {TRAIN_B}",
            "kernel": "stem7_wgrad_kernel (runs of 128 output pixels), "
                      "then wgrad_reduce_kernel",
            "cases": [w]},
    }


def resnet(dev, eval_data):
    """Phase 11, the ResNet family on the card: ResNet-50 served at batch
    32 and 128 (exactly 52 K5-conv, one K10 and one K11 launch a forward;
    request time, device busy time and idle share), its served forward
    profiled (no cuDNN convolution or ATen pooling kernel), its bf16
    backbone against the plain route, evaluated at batch 32; K5-conv at
    every conv shape of ResNet-50 and ResNet-18 that HRNet-W48 lacks, K10
    and K11 against their plain versions; then ResNet-50 and ResNet-18
    trained at batch 48 (1 warm-up and 4 timed steps on one batch: the
    launches of every backbone kernel a step, K4 at every BN, no library
    convolution or pooling operator, steps/s and peak memory), with
    K5-dgrad, K5-wgrad and K10's weight gradient at each new shape of a
    recorded train step, and K4's forward and backward at each of its BNs
    against their plain versions. Returns (K10 and K11 entries, ResNet-50's
    training launches, serving and evaluation launches, a summary)."""
    import torch

    from shapy_tpu_torch.flagship import synthetic_requests
    from shapy_tpu_torch.models.backbones import layers

    summary, checked = {}, {}
    seen_fwd = {s for s in BACKBONE_SHAPES}
    seen_bwd = set(seen_fwd)
    serve_launches = eval_launches = train_launches = None
    for depth in (50, 18):
        n = RESNET_CONVS[depth]
        base = resnet_base(depth)
        reg = copy.deepcopy(base).to(dev).prepare_for_eval_(torch.bfloat16)
        check(not any(isinstance(m, layers.BatchNorm2d)
                      for m in reg.modules()), "a BN left unfolded")
        what = f"ResNet-{depth}"
        per_forward = {"K5_conv": n, "K10_stem": 1, "K11_max_pool": 1}
        requests = {}
        for b in RESNET_SERVE_B if depth == 50 else (B,):
            images, affines = synthetic_requests(b, IMAGE_H, IMAGE_W, CROP,
                                                 SEED)
            requests[b] = (torch.from_numpy(images).to(dev),
                           torch.from_numpy(affines).to(dev))
        convs, _ = backbone_calls(reg.backbone, requests[B])
        shapes = {(x.shape[1], w.shape[0], w.shape[-1], s, x.shape[2])
                  for x, w, _b, _r, _relu, s in convs}
        fwd = check_conv_kernels(convs, (n + 1, len(shapes)), seen_fwd,
                                 replays=False)
        seen_fwd |= shapes
        if depth == 50:
            with torch.inference_mode():  # the stem's output, K11's input
                x_pool = layers.conv2d_act(*convs[0])
            stem = convs[0]
            summary["resnet50_routes"] = check_conv_routes(
                reg.backbone, requests[B], convs, pools=1)
            summary["resnet50_backbone"] = check_backbone_routes(
                reg, requests[B])
            for b, req in requests.items():
                launches, rate = serve(reg, req, per_forward,
                                       RESNET_SERVE_KERNELS, f"{what} serve")
                summary[f"resnet50_serve_b{b}"] = request_device(reg, req,
                                                                 rate)
                print(f"{what} request at batch {b}: "
                      f"{json.dumps(summary[f'resnet50_serve_b{b}'])}; "
                      f"{gpu_line()}")
                if b == B:
                    serve_launches = launches
            served = summary[f"resnet50_serve_b{B}"]["images_per_s"]
            eval_launches, rate = evaluate(
                reg, eval_data, served, per_forward, RESNET_EVAL_KERNELS,
                f"{what} evaluate")
            summary["resnet50_eval_b32_images_per_s"] = rate
        del convs, reg
        per_step = dict(per_forward, K5_dgrad=n, K5_wgrad=n,
                        K10_stem_wgrad=1, K11_max_pool_backward=1)
        bconvs, _, bns, pools = train_step_calls(
            base, dev, (n + 1, n, 0, n + 1, 1))
        bwd = check_conv_backward_kernels(bconvs, len(shapes), seen_bwd,
                                          replays=False)
        seen_bwd |= shapes
        if depth == 50:
            checked.update(_stem_entries(fwd["cases"], bwd["cases"]))
            with torch.inference_mode():
                checked["K10_stem"]["stem_cases"] = check_stem_kernel(
                    stem, next((c[1], c[2]) for c in bconvs
                               if c[2].shape[-1] == 7))
            checked.update(check_pool_kernels(x_pool, pools))
            del x_pool, stem
        summary[f"resnet{depth}_new_shapes"] = {
            "forward": len(fwd["cases"]), "backward": len(bwd["cases"])}
        # K4 at each of the step's BNs, in the regime its plan picks (the
        # forward's cluster takes the 16^2 and 8^2 layers at any width).
        summary[f"resnet{depth}_bn"] = {
            "forward": check_bn_forward_replay(bns, n + 1, replays=False),
            "backward": check_bn_backward_replay(bns, n + 1, replays=False)}
        del bconvs, bns, pools
        launches, rates = train(
            base, dev, per_step, (RESNET_TRAIN_WARMUP, RESNET_TRAIN_STEPS),
            RESNET_TRAIN_KERNELS, ("_Conv2dActBackward", "_MaxPool2d"),
            f"{what} train", RESNET_DEVICE_KERNELS)
        for name in ("K4_bn_forward", "K4_bn_backward"):
            check(launches[name] == (n + 1) * RESNET_TRAIN_STEPS,
                  f"{what}: {launches[name]} {name} launches, expected "
                  f"{n + 1} a step")
        summary[f"resnet{depth}_train"] = rates
        if depth == 50:
            train_launches = launches
        del base
        torch.cuda.empty_cache()
    return checked, train_launches, serve_launches, eval_launches, summary


class PlainMeasurements:
    """``forward_from_vertices`` through the plain version, given the
    kernel's centroids of the same bodies (see ``check_measure_kernels``):
    phase 8's reference fit."""

    def __init__(self, meas):
        self.meas = meas

    def forward_from_vertices(self, vertices, use_face_subsets=True):
        from shapy_tpu_torch.measure.measurements import (
            PLANES,
            measure_plain,
            saved_centroids,
        )

        import torch

        m = self.meas
        with torch.enable_grad():  # the centroids are saved for a backward
            probe = vertices.detach().clone().requires_grad_()
            cents = saved_centroids(m.measure(probe, False)[0]).detach()
        vals, heights = measure_plain(vertices, m.faces, None, m.anchors,
                                      m.num_hull_directions, m.density,
                                      m.slice_mode, cents)
        out = {"mass": {"tensor": vals[:, 0]},
               "height": {"tensor": vals[:, 1]}}
        for p, name in enumerate(PLANES):
            out[name] = {"tensor": vals[:, 2 + p],
                         "plane_height": heights[:, p]}
        return {"measurements": out}


def fit(model, anchors, dev):
    """Phase 8: ``fit_betas_to_measurements`` on the full-width SMPL-X in
    both slice modes (batch 1 from zero betas, batch 32 from seeded betas
    of 0.5 sigma), then the virtual-measurements CLI. Returns the launches
    of each mode's batch-32 fit."""
    import torch

    from shapy_tpu_torch.measure.fit_measurements import (
        fit_betas_to_measurements,
    )
    from shapy_tpu_torch.measure.measurements import BodyMeasurements

    rng = np.random.default_rng(SEED + 11)
    target_betas = torch.tensor(rng.normal(size=(1, model.num_betas)),
                                dtype=torch.float32, device=dev)
    init32 = torch.tensor(rng.normal(size=(FIT_B, model.num_betas)) * 0.5,
                          dtype=torch.float32)
    kwargs = dict(num_steps=FIT_STEPS, learning_rate=FIT_LR,
                  shape_prior_weight=FIT_PRIOR)
    launches = {}
    for mode in ("reference", "exact"):
        meas = BodyMeasurements(anchors, model.faces, 256,
                                slice_mode=mode).to(dev)
        with torch.no_grad():
            m = meas.forward_from_vertices(
                model.forward_shape(target_betas)["v_shaped"],
                use_face_subsets=False)["measurements"]
        targets = {k: float(m[k]["tensor"][0]) for k in MEASURED}
        fwd, bwd = FIT_KERNELS[mode]
        for batch, init in ((1, None), (FIT_B, init32)):
            fit_fn = lambda: fit_betas_to_measurements(  # noqa: E731
                model, meas, targets, init_betas=init, batch_size=batch,
                **kwargs)
            fit_fn()  # warm-up
            torch.cuda.synchronize()
            reset_launches()
            start = time.perf_counter()
            result = fit_fn()
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - start
            counts = read_launches()
            errs = {k: float((result["measurements"][k] - t).abs().max())
                    for k, t in targets.items()}
            losses = result["losses"]
            check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
                  f"fit losses {losses[0]} -> {losses[-1]}")
            check(max(errs.values()) <= FIT_TOL,
                  f"{mode} fit of batch {batch} off its targets: {errs}")
            check(counts[fwd] == FIT_STEPS + 1 and counts[bwd] == FIT_STEPS,
                  f"{mode} fit launched {counts[fwd]} forwards and "
                  f"{counts[bwd]} backwards in {FIT_STEPS} steps")
            others = {k: n for k, n in counts.items()
                      if n and k not in (fwd, bwd)}
            if batch == FIT_B:
                launches.update({fwd: counts[fwd], bwd: counts[bwd]})
            # The first steps against the same fit through the plain
            # versions on the card (given the kernel's centroids): losses
            # rel 1e-4, betas 2e-4 (f32 gradients that agree to ~1e-5 of
            # their largest, through 20 Adam steps of ~lr each, which
            # magnify the difference where a component is near 0:
            # 6.1e-5 measured at batch 32).
            short = dict(kwargs, num_steps=FIT_PARITY_STEPS)
            a = fit_betas_to_measurements(model, meas, targets,
                                          init_betas=init,
                                          batch_size=batch, **short)
            b = fit_betas_to_measurements(model, PlainMeasurements(meas),
                                          targets, init_betas=init,
                                          batch_size=batch, **short)
            loss_rel = float(np.max(np.abs(a["losses"] - b["losses"])
                                    / np.abs(b["losses"])))
            beta_err = max_err(a["betas"], b["betas"])
            check(loss_rel <= 1e-4 and beta_err <= 2e-4,
                  f"{mode} fit vs plain: losses {loss_rel}, betas "
                  f"{beta_err}")
            print(f"fit ({mode}, batch {batch}): {FIT_STEPS} steps in "
                  f"{elapsed * 1e3:.1f} ms = {FIT_STEPS / elapsed:.1f} "
                  f"steps/s; loss {losses[0]:.6f} -> {losses[-1]:.3e}; max "
                  f"|fitted - target| " + ", ".join(
                      f"{k} {e * 1e3:.3f} mm" for k, e in errs.items())
                  + f" (tol {FIT_TOL * 1e3:.0f} mm); launches {fwd} "
                  f"{counts[fwd]}, {bwd} {counts[bwd]}, others {others}; "
                  f"first {FIT_PARITY_STEPS} steps vs plain: losses rel "
                  f"{loss_rel:.2e} (tol 1e-4), betas {beta_err:.2e} (tol "
                  "2e-4)")
    virtual_measurements(dev)
    return launches


def virtual_measurements(dev):
    """``cli.virtual_measurements.main(..., render=False)`` over seeded
    betas files on the synthetic SMPL-X (subdivisions 5): its lines
    against the plain version's measurements of the same bodies."""
    import contextlib
    import io
    import os
    import tempfile

    import torch

    from shapy_tpu_torch.cli import virtual_measurements as vm_cli
    from shapy_tpu_torch.measure.measurements import (
        MeasurementAnchors,
        measure_plain,
    )
    from shapy_tpu_torch.models.body.assets import make_synthetic_model_data
    from shapy_tpu_torch.models.body.model import SMPLX

    rng = np.random.default_rng(SEED + 12)
    betas = rng.normal(size=(VM_FILES, 10)).astype(np.float32)
    saved = {k: os.environ.get(k) for k in ("SHAPY_TPU_SYNTHETIC_BODY",
                                             "SHAPY_TPU_TEST_SUBDIV")}
    os.environ.update(SHAPY_TPU_SYNTHETIC_BODY="1", SHAPY_TPU_TEST_SUBDIV="5")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for i, b in enumerate(betas):
                np.savez(os.path.join(tmp, f"body_{i:02d}.npz"), betas=b)
            buf = io.StringIO()
            reset_launches()
            with contextlib.redirect_stdout(buf):
                rc = vm_cli.main(tmp, os.path.join(tmp, "out"),
                                 render=False, device=str(dev))
            launches = read_launches()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    lines = [ln for ln in buf.getvalue().splitlines()
             if "Virtual measurements" in ln]
    check(rc == 0 and len(lines) == VM_FILES, f"virtual measurements: {rc}, "
          f"{len(lines)} lines")
    check(launches["K1_measure"] == VM_FILES, "the CLI's K1 launches")
    model = SMPLX(make_synthetic_model_data("smplx", subdivisions=5)).to(dev)
    anchors = MeasurementAnchors.synthetic(model.faces,
                                           model.v_template.cpu().numpy())
    with torch.no_grad():
        v = model.forward_shape(torch.from_numpy(betas).to(dev))["v_shaped"]
        vals, _ = measure_plain(v, model.faces_tensor, None, anchors)
    # The same line, or (where a value sits on a rounding edge) numbers
    # one printed unit apart.
    for line, row in zip(lines, vals.cpu().numpy()):
        want = "    Virtual measurements: " + "".join(
            f"    {k}: {x:.2f} {'kg' if k == 'mass' else 'm'}"
            for k, x in zip(("mass", "height", "chest", "waist", "hips"),
                            row))
        got_t, want_t = line.split(), want.split()
        close = len(got_t) == len(want_t) and all(
            a == b or (a.replace(".", "").isdigit()
                       and abs(float(a) - float(b)) <= 0.0100001)
            for a, b in zip(got_t, want_t))
        check(close, f"CLI line {line!r} vs plain {want!r}")
    print(f"virtual measurements CLI: {VM_FILES} files, lines equal to the "
          f"plain version's; first: {lines[0].strip()}")

def contact_bodies(model, dev) -> dict:
    """Phase 9's body pairs at full width, one per seed of CONTACT_SEEDS:
    vertices ``va``, ``vb`` (4, V, 3) and triangles ``a``, ``b`` (4, F, 3,
    3); A has seeded betas and pose, B other betas, A's pose and a shift
    of CONTACT_SHIFT, so that the surfaces cross (no vertex is shared)."""
    import torch

    va, vb = [], []
    for seed in CONTACT_SEEDS:
        rng = np.random.default_rng(seed)
        pose = rng.normal(size=(1, model.NUM_BODY_JOINTS, 3)) * CONTACT_POSE
        betas = [rng.normal(size=(1, model.num_betas)) * CONTACT_BETAS
                 for _ in range(2)]
        with torch.no_grad():
            for out, b in zip((va, vb), betas):
                out.append(model(
                    betas=torch.tensor(b, dtype=torch.float32, device=dev),
                    body_pose=torch.tensor(pose, dtype=torch.float32,
                                           device=dev))["vertices"])
    va = torch.cat(va)
    vb = torch.cat(vb) + torch.tensor(CONTACT_SHIFT, device=dev)
    faces = model.faces_tensor.long()
    return {"va": va.contiguous(), "vb": vb.contiguous(),
            "a": va[:, faces].contiguous(), "b": vb[:, faces].contiguous()}


def contact_pairs(faces, M: int, F: int):
    """K6's hits (B, Q * M) as repulsion pairs (B, C, 2) int32, -1-padded:
    receiver = the target (B's) face + F, intruder = the query (A's) face,
    in slot order; C is the largest count."""
    import torch

    rows = []
    for row in faces:
        slots = torch.nonzero(row >= 0)[:, 0]
        rows.append(torch.stack([row[slots].long() + F, slots // M], dim=-1))
    C = max(len(r) for r in rows)
    pairs = torch.full((len(rows), C, 2), -1, dtype=torch.int32,
                       device=faces.device)
    for k, r in enumerate(rows):
        pairs[k, :len(r)] = r.to(torch.int32)
    return pairs


def box_pairs(a, b, chunk: int = 1024) -> int:
    """The (query, target) pairs of triangles a, b (F, 3, 3) whose boxes
    overlap: the pairs K6 runs its full test on."""
    qmin, qmax, tmin, tmax = a.amin(1), a.amax(1), b.amin(1), b.amax(1)
    n = 0
    for s in range(0, len(a), chunk):
        n += int(((tmin[None] <= qmax[s:s + chunk, None])
                  & (tmax[None] >= qmin[s:s + chunk, None])).all(-1).sum())
    return n


def plane_quads(meas, va):
    """Phase 9's plane route: the chest, waist and hips quads (+-1 m, two
    triangles each) at K1's plane heights of the bodies va (B, V, 3), as
    queries (B, 6, 3, 3), and the heights (B, 3)."""
    import torch

    from shapy_tpu_torch.measure.measurements import PLANES

    with torch.no_grad():
        _, heights = meas.measure(va, use_face_subsets=False)  # (B, 3)
    quads = []
    for h in heights.reshape(-1).tolist():
        quads += [[[-1.0, h, -1.0], [1.0, h, -1.0], [1.0, h, 1.0]],
                  [[-1.0, h, -1.0], [1.0, h, 1.0], [-1.0, h, 1.0]]]
    quads = torch.tensor(quads, device=va.device)
    return quads.reshape(len(va), 2 * len(PLANES), 3, 3), heights


def k6_case(name, q, t, M, plan=None, check_order=False):
    """K6 on (q, t, M) under ``plan`` against its plain version and its
    replay: ids equal, barycentrics bit-equal, two calls bit-equal, the
    overflow counter the replay's count, a third call through the
    kernel's counting build (the same outputs) whose counts of the tests
    its walk made equal the replay's totals (and with ``check_order`` the
    kernel's Morton order the replay's). Returns the replay's info, with
    ``tested`` and ``overflowed_count``: the kernel's counts of that
    call."""
    import torch

    from shapy_tpu_torch.ops import tri_tri

    tested = torch.zeros(4, dtype=torch.int64, device=q.device)
    with torch.no_grad():
        tri_tri.reset_overflowed()
        faces, bcs, order = tri_tri._mesh_mesh_intersection_cuda(q, t, M,
                                                                 plan)
        again = tri_tri._mesh_mesh_intersection_cuda(q, t, M, plan)
        over = tri_tri.overflowed_queries()
        counted = tri_tri._mesh_mesh_intersection_cuda(q, t, M, plan, tested)
        want_f, want_b = tri_tri.mesh_mesh_intersection_plain(
            q, t, M, query_chunk=256)
        rep_f, rep_b, info = tri_tri.mesh_mesh_intersection_replay(
            q, t, M, plan, query_chunk=256)
    same = (torch.equal(faces, want_f) and torch.equal(bcs, want_b)
            and torch.equal(rep_f, want_f) and torch.equal(rep_b, want_b))
    twice = all(torch.equal(x, y[0]) and torch.equal(bcs, y[1])
                for x, y in ((faces, again), (faces, counted)))
    ordered = not check_order or torch.equal(order.long(), info["order"])
    n_over = int(info["overflowed"].sum())
    want_tests = [q.shape[0] * q.shape[1] * info["superclusters_tested"],
                  *(int(info[k].sum()) for k in (
                      "clusters_tested", "faces_tested", "box_passed"))]
    info["tested"] = tested.tolist()
    info["overflowed_count"] = over // 2
    print(f"K6 {name}: {int((faces >= 0).sum())} hits, ids equal to the "
          f"plain version's and barycentrics bit-equal: {same}, three calls "
          f"(the third counting) bit-equal: {twice}, order equal to the "
          f"replay's: {ordered}, overflowed queries {over // 2} a call "
          f"(replay {n_over}), most hits a query {int(info['hits'].max())}; "
          f"tests counted by the kernel (superclusters, clusters, faces, "
          f"Moller) {info['tested']}, the replay's {want_tests}")
    check(same and twice and ordered and over == 2 * n_over
          and info["tested"] == want_tests, f"K6 {name} vs plain and replay")
    return info


def k7_nan_equal(a, b) -> bool:
    """a and b equal, NaN where the other holds NaN."""
    import torch

    return a.shape == b.shape and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def k7_fan(dev, receivers: int = 48):
    """K7's planted long list: one intruder triangle (1 cm, in the xy
    plane) and ``receivers`` triangles 1-10 cm below it facing it (2-3 cm
    circumradius, seeded turns, tilts and offsets of a few mm), paired
    (receiver k, intruder 0): the intruder's face holds ``receivers``
    entries of different values, past any register list."""
    import torch

    rng = np.random.default_rng(SEED + 22)
    ang = np.asarray([0.0, 2.0944, 4.1888])
    tris = [0.0058 * np.stack([np.cos(ang), np.sin(ang), 0 * ang], -1)]
    for _ in range(receivers):
        t = rng.uniform(0, 2 * np.pi)
        r = rng.uniform(0.02, 0.03)
        v = r * np.stack([np.cos(ang + t), np.sin(ang + t), 0 * ang], -1)
        tilt = rng.normal(size=3) * 0.05
        v[:, 2] += v[:, :2] @ tilt[:2]
        tris.append(v + [*rng.normal(size=2) * 0.003,
                         -rng.uniform(0.01, 0.1)])
    tris = torch.tensor(np.stack(tris)[None], dtype=torch.float32,
                        device=dev)
    pairs = torch.tensor([[[k, 0] for k in range(1, receivers + 1)]],
                         dtype=torch.int32, device=dev)
    return tris, pairs


def k7_on_axis(dev):
    """K7's planted on-axis pair (``tests/test_torch_repulsion_plan.py``'s
    ``on_axis_pair``): its value is exactly 0, an intruder vertex lies
    exactly on the receiver's cone axis 1 m in front (intensity 0), and the
    plain version's gradient is NaN there."""
    import torch

    a = 2.0 ** -6
    tris = torch.zeros(1, 4, 3, 3)
    tris[0, 0] = torch.tensor([[0, 0, 0], [a, 0, 0], [0, a, 0]])
    tris[0, 1] = torch.tensor([[a / 2, a / 2, 1.0], [a / 2, a / 2 + 0.01, 1.0],
                               [a / 2, a / 2, 1.01]])
    tris[0, 2:] = tris[0, :2] + 0.3
    return (tris.to(dev),
            torch.tensor([[[0, 1], [2, 3]]], dtype=torch.int32, device=dev))


def k7_case(name, tris, pairs, cot, **kw) -> dict:
    """K7 on (tris, pairs) with cotangent cot through its entry points on
    the card (``_repulsion_forward_cuda``, ``_repulsion_backward_cuda``),
    each called twice: the loss and its f64 total bit-equal to
    ``repulsion_forward_replay`` of the kernel's per-pair penalties, those
    bit-equal to the plain version's on the card and the live bytes equal
    to its live mask; the gradient bit-equal (NaN where NaN) to
    ``repulsion_backward_replay`` of the kernel's entries; two calls
    bit-equal; against autograd through the plain version in f64 the
    loss within rel 1e-5 and the gradient within 1e-4 of its largest
    finite entry, NaN wherever f64 gives NaN (the kernel's dual sqrt at 0
    makes every tangent of that pair NaN, so it may give NaN at more
    entries of such a pair's faces)."""
    import torch

    from shapy_tpu_torch.ops import repulsion as rep

    sigma = kw.get("sigma", 0.5)
    po = kw.get("penalize_outside", True)
    lmax = kw.get("linear_max", 1000.0)
    consts = rep._constants(sigma, po, lmax)
    F = tris.shape[1]
    loss, live, total, pen = rep._repulsion_forward_cuda(tris, pairs, consts,
                                                         per_pair=True)
    again = rep._repulsion_forward_cuda(tris, pairs, consts)
    grad, entries = rep._repulsion_backward_cuda(tris, pairs, cot, live,
                                                 consts)
    grad2, _ = rep._repulsion_backward_cuda(tris, pairs, cot, live, consts)
    with torch.no_grad():
        pen_plain, live_plain = rep.repulsion_pairs_plain(tris, pairs, sigma,
                                                          po, lmax)
        rep_loss, rep_total = rep.repulsion_forward_replay(pen)
        rep_grad = rep.repulsion_backward_replay(entries, pairs, F, live, cot)
    x64 = tris.double().requires_grad_()
    loss64 = rep.repulsion_loss_plain(x64, pairs, sigma, po, lmax)
    want64, = torch.autograd.grad((loss64 * cot.double()).sum(), x64,
                                  allow_unused=True)
    want64 = torch.zeros_like(x64) if want64 is None else want64
    loss64 = loss64.detach()
    finite = torch.isfinite(want64) & torch.isfinite(grad)
    scale = float(want64[finite].abs().max()) if bool(finite.any()) else 0.0
    diff = (grad.double() - want64)[finite].abs()
    grad_err = (float(diff.max()) if diff.numel() else 0.0) / max(scale,
                                                                   1e-300)
    val_err = float(((loss.double() - loss64).abs()
                     / loss64.abs().clamp(min=1e-300)).max()
                    ) if loss.numel() else 0.0
    nan_kept = bool((torch.isnan(grad) | ~torch.isnan(want64)).all())
    valid = int(torch.all(pairs >= 0, dim=-1).sum())
    row = {
        "case": name, "bodies": tris.shape[0], "C": pairs.shape[1], "F": F,
        "pairs": valid, "live": int(live.sum()),
        "skipped": valid - int(live.sum()),
        "loss_rel_err": val_err, "grad_err": grad_err,
        "grad_nan": int(torch.isnan(grad).sum()),
        "plain_nan": int(torch.isnan(want64).sum()),
        "replays": bool(torch.equal(loss, rep_loss)
                        and torch.equal(total, rep_total)
                        and k7_nan_equal(grad, rep_grad)),
        "per_pair_plain": bool(torch.equal(pen, pen_plain)
                               and torch.equal(live.bool(), live_plain)),
        "twice": bool(torch.equal(loss, again[0])
                      and torch.equal(live, again[1])
                      and torch.equal(total, again[2])
                      and k7_nan_equal(grad, grad2))}
    print(f"K7 {name}: {row}")
    check(row["replays"], f"K7 {name}: loss, total or gradient vs replays")
    check(row["per_pair_plain"],
          f"K7 {name}: per-pair penalties or live bytes vs plain")
    check(row["twice"], f"K7 {name}: two calls differ")
    check(val_err <= 1e-5 and grad_err <= 1e-4 and nan_kept,
          f"K7 {name} vs plain f64: loss {val_err}, gradient {grad_err}, "
          f"NaN kept {nan_kept}")
    row["loss"], row["grad"], row["live_mask"] = loss, grad, live
    return row


def check_k7(tris, pairs, dev) -> dict:
    """Phase 2's K7 on phase 9's contacts (the four pairs' triangles side
    by side, the reference's defaults) and its planted cases. Through
    ``repulsion_loss`` and autograd, as phase 9 calls it: the value
    within rel 1e-5 of the plain version (the pairs summed in another
    order), the gradient within 1e-4 of the largest of autograd in f64,
    two runs bit-equal, one device kernel a forward and at most four a
    backward, all of them ``repulsion.cu``'s (no library sort, no
    memset), from a checked trace; then ``k7_case`` on the same inputs
    and on planted ones: a face in 48 entries, batch 1 (bit-equal to body
    0 of the batch), C = 300 (not a multiple of the 256-pair tile), a row
    of only padded pairs beside half-padded ones (face 0 made a copy of a
    live pair's intruder, so that a padded id read as 0 would add), C =
    0, the on-axis pair, and ``penalize_outside=False``."""
    import torch

    from shapy_tpu_torch.ops.repulsion import (
        REPULSION_KERNEL,
        repulsion_loss,
        repulsion_loss_plain,
    )

    results = {}
    Bc = tris.shape[0]
    n_pairs = int((pairs[..., 0] >= 0).sum())
    cot = torch.linspace(1.0, -0.5, Bc, device=dev)
    x = tris.clone().requires_grad_()
    loss = repulsion_loss(x, pairs)
    got, = torch.autograd.grad(loss, x, cot, retain_graph=True)
    want = repulsion_loss_plain(tris, pairs)
    val_err = float(((loss.detach() - want).abs() / want.abs()).max())
    x64 = tris.double().requires_grad_()
    loss64 = repulsion_loss_plain(x64, pairs)
    want64, = torch.autograd.grad(loss64, x64, cot.double(),
                                  retain_graph=True)
    grad_err = float((got.double() - want64).abs().max()
                     / want64.abs().max())
    x2 = tris.clone().requires_grad_()
    again, = torch.autograd.grad(repulsion_loss(x2, pairs), x2, cot)
    same = torch.equal(got, again)
    print(f"K7 repulsion ({n_pairs} pairs over {Bc} bodies, C = "
          f"{pairs.shape[1]}): loss "
          f"{[round(float(v), 6) for v in loss.detach()]}, "
          f"rel err {val_err:.3e} (tol 1e-5); gradient err vs plain "
          f"autograd f64 {grad_err:.3e} of the largest (tol 1e-4); two runs "
          f"bit-equal: {same}")
    check(bool((loss > 0).all() and torch.isfinite(loss).all()), "K7 loss")
    check(val_err <= 1e-5 and grad_err <= 1e-4 and same, "K7 vs plain")

    # the device kernels of a call, from a checked trace: all of them
    # repulsion.cu's
    own = REPULSION_KERNEL.device_functions()
    calls = {"forward": lambda: repulsion_loss(tris, pairs),
             "backward": lambda: torch.autograd.grad(loss, x, cot,
                                                     retain_graph=True)}
    device = {}
    for what, fn in calls.items():
        ms, n, spans = device_time(fn, split=True)
        foreign = [k for k in spans if not any(f"::{f}(" in k or
                                               k.startswith(f"{f}(")
                                               for f in own)]
        device[what] = (ms, n)
        names = {(re.search(r"(\w+)\(", k) or [k[:40]])[0].rstrip("("):
                 round(v, 5) for k, v in spans.items()}
        print(f"K7 {what}: {n} device kernel(s) a call, {ms:.4f} ms of "
              f"device time: {names}")
        check(not foreign, f"K7 {what} runs kernels not its own: {foreign}")
        check(n <= (1 if what == "forward" else 4),
              f"K7 {what}: {n} device kernels a call")

    # the kernels' own entry points against the replays, on these inputs
    # and planted ones
    main = k7_case("phase 9's contacts", tris, pairs, cot)
    check(torch.equal(main["loss"], loss.detach())
          and torch.equal(main["grad"], got),
          "K7 entry points vs repulsion_loss")
    cases = [main]
    one = k7_case("batch 1", tris[:1], pairs[:1], cot[:1])
    check(torch.equal(one["loss"], main["loss"][:1])
          and torch.equal(one["grad"], main["grad"][:1]),
          "K7 batch 1 vs body 0 of the batch")
    cases.append(one)
    cases.append(k7_case("C = 300", tris, pairs[:, :300].contiguous(), cot))
    fan_t, fan_p = k7_fan(dev)
    fan = k7_case("a face in 48 entries", fan_t, fan_p, cot[:1])
    check(fan["live"] >= 40, f"K7 planted face: {fan['live']} live entries")
    cases.append(fan)
    # a row of only padded pairs; beside it half-padded pairs, and face 0
    # made a copy of a live pair's intruder (a padded id read as 0 would
    # add that pair again)
    r0, i0 = (int(v) for v in pairs[0, main["live_mask"][0].argmax()])
    padded_t = tris[:2].clone()
    padded_t[0, 0] = padded_t[0, i0]
    padded_p = torch.full((2, 54, 2), -1, dtype=torch.int32, device=dev)
    padded_p[0, :50] = pairs[0, :50]
    padded_p[0, 50:54] = torch.tensor([[r0, -1], [-1, i0], [-1, -1],
                                       [r0, i0]], device=dev)
    cases.append(k7_case("padded rows", padded_t, padded_p, cot[:2]))
    empty = k7_case("C = 0", tris, pairs[:, :0].contiguous(), cot)
    check(bool((empty["loss"] == 0).all() and (empty["grad"] == 0).all()),
          "K7 C = 0: nonzero loss or gradient")
    cases.append(empty)
    axis_t, axis_p = k7_on_axis(dev)
    on_axis = k7_case("on-axis pair", axis_t, axis_p, cot[:1])
    check(on_axis["live"] == 2 and on_axis["plain_nan"] > 0
          and float(on_axis["loss"][0]) == 0.0,
          "K7 on-axis pair: not live, or no NaN in the plain gradient")
    cases.append(on_axis)
    cases.append(k7_case("penalize_outside=False", tris, pairs, cot,
                         penalize_outside=False))
    for c in cases:
        del c["loss"], c["grad"], c["live_mask"]

    # per pair ~400 FLOPs (two cones, six cone fields), the gradient ~3x
    # for each live pair; bytes: the pairs and their two gathered
    # triangles, the losses, the gradient of all faces written once
    row = record_kernel(results, "K7_repulsion", max_err(loss, want),
                        lambda: repulsion_loss(tris, pairs),
                        lambda: repulsion_loss_plain(tris, pairs),
                        n_pairs * (8 + 72) + Bc * 4, n_pairs * 400)
    row["device_ms"], row["device_kernels"] = device["forward"]
    row = record_kernel(results, "K7_repulsion_backward", grad_err,
                        lambda: torch.autograd.grad(loss, x, cot,
                                                    retain_graph=True),
                        lambda: torch.autograd.grad(loss64, x64, cot.double(),
                                                    retain_graph=True),
                        n_pairs * (8 + 72) + Bc * 4 + tris.numel() * 4,
                        main["live"] * 1200)
    row["device_ms"], row["device_kernels"] = device["backward"]
    row["live_pairs"], row["skipped_pairs"] = main["live"], main["skipped"]
    row["cases"] = cases
    return results


def check_contact_kernels(bodies, meas, dev):
    """Phase 2, the contact path's kernels at phase 9's shapes: K6 (a body
    pair and the four pairs, 20908 x 20908 faces, 256 slots; the plane
    route, phase 9's chest / waist / hips quads as queries, 1024 slots;
    and planted cases: more hits than slots, lists forced to overflow,
    coincident boxes and degenerate triangles) against its plain version
    on the card and its replay (ids equal, barycentrics bit-equal: the
    same decisions, no FMA on either side; the kernel's Morton order the
    replay's), with the culling counts and the prologue's share of the
    time; K7's forward and backward on the four pairs' contacts against
    the plain version (value rel 1e-5: pairs summed in another order;
    gradient within 1e-4 of the largest of autograd in f64); K9 both ways
    between two bodies' vertices (10475 x 10475) through ``_nn_dists``
    and ``nn_dists_both``, bit-equal to the plain version, its neighbours
    the replay's, also with duplicate and equidistant points planted in
    b. Returns the entries and the plain K6 output of pair 0, which phase
    9 holds its run against."""
    import torch

    from shapy_tpu_torch.eval.metrics import (
        _nn_dists,
        _nn_search_cuda,
        nn_dists_both,
        nn_dists_plain,
        nn_plan,
        nn_search_replay,
    )
    from shapy_tpu_torch.ops import tri_tri
    from shapy_tpu_torch.ops.repulsion import (
        repulsion_loss,
        repulsion_loss_plain,
    )
    from shapy_tpu_torch.ops.tri_tri import (
        mesh_mesh_intersection,
        mesh_mesh_intersection_plain,
    )

    results = {}
    a, b = bodies["a"], bodies["b"]
    Bc, F = a.shape[:2]
    M = CONTACT_M
    a1, b1 = a[:1].contiguous(), b[:1].contiguous()
    quads, _ = plane_quads(meas, bodies["va"])

    # K6 at batch 1 (the plain version goes through 82 query chunks in a
    # Python loop, ~0.5 s: timed over 2 calls), at the main path's batch
    # of 4 pairs and on the plane route
    info = k6_case("pair 0", a1, b1, M, check_order=True)
    with torch.no_grad():
        plain = mesh_mesh_intersection_plain(a1, b1, M, query_chunk=256)
    hits = int((plain[0] >= 0).sum())
    info4 = k6_case(f"{Bc} pairs", a, b, M, check_order=True)
    info_p = k6_case("plane route", quads, a, PLANE_M, check_order=True)
    # planted: more hits than slots; lists too short for the hits (a block
    # a query on the plane route, a warp a query on pair 0); a target
    # repeated (coincident boxes); degenerate triangles (a vertex
    # repeated, in a query and in a target)
    nc = -(-F // 32)
    over = k6_case("plane route, 8 slots", quads, a, 8)
    check(int(over["hits"].max()) > 8, "K6 planted: no query has more "
          "hits than 8 slots")
    for name, q, t, m, plan in (
            ("plane route, lists of 32", quads, a, PLANE_M,
             tri_tri.TriTriPlan(nc, 32, 8)),
            ("pair 0, lists of 1", a1, b1, 4, tri_tri.TriTriPlan(nc, 1, 1))):
        got = k6_case(name, q, t, m, plan)
        check(bool(got["overflowed"].any()), f"K6 {name}: no overflow")
    planted_t, planted_q = b1.clone(), a1.clone()
    planted_t[:, 5] = planted_t[:, 100]
    planted_t[:, 7, 2] = planted_t[:, 7, 0]
    planted_q[:, 9, 1] = planted_q[:, 9, 0]
    k6_case("coincident boxes and degenerate triangles", planted_q,
            planted_t, M)

    n_box = box_pairs(a1[0], b1[0])
    # bytes: queries and targets read once, ids and barycentrics written;
    # operations: this data's culled tests as the kernel counted them (6 a
    # box test: every supercluster box, the cluster boxes of those that
    # overlap, the face boxes of the clusters that overlap), ~150 for the
    # full test on the faces whose boxes overlap, ~60 per kept hit
    def k6_work(inf, B, Q, m):
        n_s, n_c, n_f, n_b = inf["tested"]
        return (B * (Q + F) * 36 + B * Q * m * (4 + 24),
                6 * (n_s + n_c + n_f) + 150 * n_b
                + 60 * int(inf["hits"].sum()))

    k6_bytes, k6_ops = k6_work(info, 1, F, M)
    with torch.no_grad():
        bcs_err = max_err(mesh_mesh_intersection(a1, b1, M)[1], plain[1])
    row = record_kernel(
        results, "K6_tri_tri", bcs_err,
        lambda: mesh_mesh_intersection(a1, b1, M),
        lambda: mesh_mesh_intersection_plain(a1, b1, M, query_chunk=256),
        k6_bytes, k6_ops, plain_iters=2)
    row["box_pairs"] = n_box
    row["hits"] = hits

    # the tests a query, from the kernel's counting build (k6_case holds
    # them to the replay's), and the queries the kernel counted overflowed
    def culling(inf):
        n = inf["hits"].numel()
        return {**{k: round(v / n, 2) for k, v in zip(
                    ("superclusters_tested", "clusters_tested",
                     "faces_tested", "box_passed"), inf["tested"])},
                "overflowed": inf["overflowed_count"]}

    def prologue_share(fn):
        ms, _, spans = device_time(fn, split=True)
        query = sum(v for k, v in spans.items() if "tri_tri_kernel" in k)
        return ms, round(1.0 - query / sum(spans.values()), 4)

    row["culling"] = culling(info)
    row["device_ms"], row["prologue_share"] = prologue_share(
        lambda: mesh_mesh_intersection(a1, b1, M))
    with torch.no_grad():
        faces4 = mesh_mesh_intersection(a, b, M)[0]
        n_box4 = n_box + sum(box_pairs(a[k], b[k]) for k in range(1, Bc))
    row["cases"] = []
    for name, (q, t, m, inf) in {
            f"batch {Bc}": (a, b, M, info4),
            "plane route": (quads, a, PLANE_M, info_p)}.items():
        nbytes, ops = k6_work(inf, len(q), q.shape[1], m)
        ms = time_ms(lambda: mesh_mesh_intersection(q, t, m))
        lim = bound(nbytes, ops)
        dev_ms, share = prologue_share(
            lambda: mesh_mesh_intersection(q, t, m))
        row["cases"].append({
            "case": name, "ms": ms, "device_ms": dev_ms,
            "prologue_share": share, "bound_ms": lim[0], "bound_by": lim[1],
            "hits": int(inf["hits"].sum()), "culling": culling(inf)})
        print(f"K6 {name}: kernel {ms:.4f} ms (device {dev_ms:.4f}, the "
              f"prologue {share:.1%}), bound {lim[0]:.4f} ms ({lim[1]}); "
              f"culling a query {row['cases'][-1]['culling']}")
    row["cases"][0]["box_pairs"] = n_box4
    print(f"K6 pair 0: device {row['device_ms']:.4f} ms, the prologue "
          f"{row['prologue_share']:.1%}; culling a query {row['culling']}")

    # K7 on the contacts of all four pairs, both directions of the pairs'
    # cones, the reference's defaults, and its planted cases
    results.update(check_k7(torch.cat([a, b], dim=1).contiguous(),
                            contact_pairs(faces4, M, F), dev))

    # K9 both ways between two bodies' vertices, as point_fscore runs it
    # (nn_dists_both), and each way alone (_nn_dists); then clouds with
    # duplicates and points equidistant from a query planted in b
    pa, pb = bodies["va"][0].contiguous(), bodies["vb"][0].contiguous()
    gen = torch.Generator().manual_seed(SEED + 3)
    x = (torch.randn(3000, 3, generator=gen) * 0.3).to(dev)
    y = (torch.randn(5000, 3, generator=gen) * 0.3).to(dev)
    y[100:200] = y[0:100]
    y[4999] = y[5]
    x[:50] = 0.0
    y[300], y[301] = (torch.tensor([1e-3, 0, 0]),
                      torch.tensor([-1e-3, 0, 0]))
    N, Mb = len(pa), len(pb)
    err, same = 0.0, True
    with torch.no_grad():
        for p, q in ((pa, pb), (x, y)):
            want = nn_dists_plain(p, q), nn_dists_plain(q, p)
            got = nn_dists_both(p, q)
            single = _nn_dists(p, q), _nn_dists(q, p)
            out, idx = _nn_search_cuda(p, q, True)
            plans = nn_plan(len(p), len(q), True)
            replay = [nn_search_replay(u, v, plan)[1] for (u, v), plan in
                      zip(((p, q), (q, p)), plans)]
            err = max(err, *(max_err(g, w) for g, w in
                             zip(got + single, want + want)))
            same &= all(torch.equal(i.long(), r) for i, r in
                        zip(idx.split([len(p), len(q)]), replay))
    first = int(idx[0])
    print(f"K9 nn dists ({N} x {Mb} and 3000 x 5000 with planted ties, "
          f"both ways, through nn_dists_both and _nn_dists): err "
          f"{err:.3e} m (exact), neighbours the replay's: {same}, a "
          f"planted tie's neighbour {first} (the first, 300)")
    check(err == 0.0 and same and first == 300, "K9 vs plain and replay")
    row = record_kernel(
        results, "K9_nn_dists", err,
        lambda: nn_dists_both(pa, pb),
        lambda: (nn_dists_plain(pa, pb), nn_dists_plain(pb, pa)),
        (N + Mb) * (12 + 4), 2 * 8 * N * Mb,
        lambda: (torch.cdist(pa, pb).min(dim=1),
                 torch.cdist(pb, pa).min(dim=1)))
    row["library_call"] = ("torch.cdist(a, b).min(dim=1), both ways: two "
                           "calls a direction")
    row["timed_as"] = "nn_dists_both(a, b): one launch, both ways"
    row["device_ms"] = device_ms(lambda: nn_dists_both(pa, pb))
    # A second bound beside bound_ms, computed, not measured (so kept out
    # of the kernels line): K9's floor in issue slots. --fmad=false leaves
    # 8 instructions a pair (3 multiplies, 4 adds, a minimum), at one a
    # cycle on each of the card's schedulers (4 an SM) at its top SM clock.
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    floor = 2 * N * Mb * 8 / (sms * 4 * 32 * clock * 1e6) * 1e3
    print(f"K9: device {row['device_ms']:.4f} ms; issue floor under "
          f"--fmad=false (computed from the shapes and the top SM clock, "
          f"not measured) {floor:.4f} ms ({sms} SMs at {clock:.0f} MHz)")
    return results, plain


def contact(bodies, eval_data, meas, k6_plain, dev):
    """Phase 9: the contact and distance path at full width on the four
    body pairs. K6 body against body (256 slots; pair 0 against the plain
    version of phase 2, each kept endpoint on both triangles' planes), K6
    plane against body (the chest, waist and hips quads at K1's plane
    heights, 1024 slots, against the exact slice's crossed faces), K7 on
    the contacts (value and gradient), and ``point_fscore`` at 5, 10 and
    20 mm between the bodies' vertices and their P2P-20k clouds, against
    the plain versions. Returns the launches of the phase's run."""
    import torch

    from shapy_tpu_torch.eval.metrics import (
        _nn_dists,
        fscore_from_dists,
        nn_dists_plain,
        point_fscore,
    )
    from shapy_tpu_torch.measure.measurements import PLANES, _soa
    from shapy_tpu_torch.ops import MeshMeshIntersection, repulsion_loss
    from shapy_tpu_torch.ops import tri_tri
    from shapy_tpu_torch.ops.plane_slice import plane_slice_soa
    from shapy_tpu_torch.ops.repulsion import repulsion_loss_plain

    a, b, va, vb = (bodies[k] for k in ("a", "b", "va", "vb"))
    Bc, F = a.shape[:2]
    quads, heights = plane_quads(meas, va)
    p2p = eval_data["p2p"]
    clouds = {"vertices": (va, vb), "p2p": (p2p.regress(va).contiguous(),
                                            p2p.regress(vb).contiguous())}
    torch.cuda.synchronize()

    reset_launches()
    tri_tri.reset_overflowed()
    start = time.perf_counter()
    with torch.no_grad():
        faces, bcs = MeshMeshIntersection(CONTACT_M)(a, b)
        plane_faces, _ = MeshMeshIntersection(PLANE_M)(quads, a)
    pairs = contact_pairs(faces, CONTACT_M, F)
    tris = torch.cat([a, b], dim=1).contiguous().requires_grad_()
    loss = repulsion_loss(tris, pairs)
    live = loss.grad_fn.saved_tensors[2]  # K7's live bytes, for the count
    grad, = torch.autograd.grad(loss.sum(), tris)
    scores = {}
    with torch.no_grad():
        for name, (p, q) in clouds.items():
            for k in range(Bc):
                for thresh in FSCORE_THRESH:
                    scores[name, k, thresh] = point_fscore(p[k], q[k],
                                                           thresh)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launches = read_launches()

    for name in CONTACT_KERNELS:
        check(launches[name] > 0, f"{name} was not launched by phase 9")
    # one K9 launch an F-score (both directions), none other
    check(launches["K9_nn_dists"] == len(scores),
          f"K9 launches {launches['K9_nn_dists']} for {len(scores)} F-scores")
    overflowed = tri_tri.overflowed_queries()
    # K6 body against body
    counts = (faces >= 0).sum(dim=1).tolist()
    check(min(counts) >= MIN_COLLISIONS, f"collisions per pair {counts}")
    check(torch.equal(faces[:1], k6_plain[0]), "K6 pair 0 vs plain faces")
    bcs_err = max_err(bcs[:1], k6_plain[1])
    check(bcs_err <= 1e-5, f"K6 pair 0 vs plain barycentrics {bcs_err}")
    # Every kept endpoint, rebuilt from its barycentrics, lies on the
    # target's plane. It lies on the query's plane too, except in target
    # triangles under the JAX package's clamp of d00 d11 - d01^2 = (2
    # area)^2 at 1e-9 m^4 (tri_tri.py:84, ROADMAP F6: areas below ~1.6e-5
    # m^2), where the barycentrics follow that clamp as the plain
    # version's do; those are counted and held to the target's plane only.
    worst, clamped = 0.0, 0
    for k in range(Bc):
        slots = torch.nonzero(faces[k] >= 0)[:, 0]
        tri_t = b[k, faces[k, slots].long()].double()
        tri_q = a[k, slots // CONTACT_M].double()
        pts = torch.einsum("sek,skd->sed", bcs[k, slots].double(), tri_t)
        for tri in (tri_t, tri_q):
            n = torch.linalg.cross(tri[:, 1] - tri[:, 0],
                                   tri[:, 2] - tri[:, 0])
            if tri is tri_t:
                clear = (n * n).sum(-1) > 2e-9
                clamped += int((~clear).sum())
            n = n / n.norm(dim=-1, keepdim=True)
            dist = torch.einsum("sed,sd->se", pts - tri[:, None, 0], n)
            dist = dist if tri is tri_t else dist[clear]
            worst = max(worst, float(dist.abs().max()))
    check(worst <= 1e-5, f"K6 endpoints off the planes by {worst} m")
    # K6 plane against body vs the exact slice
    tx, ty, tz = _soa(va, meas.faces)
    sizes = []
    for p in range(len(PLANES)):
        _, _, mask = plane_slice_soa(ty, tx, tz, heights[:, p])
        slots = plane_faces[:, 2 * p * PLANE_M:(2 * p + 2) * PLANE_M]
        for k in range(Bc):
            found = set(slots[k][slots[k] >= 0].tolist())
            want = set(torch.nonzero(mask[k, :F])[:, 0].tolist())
            check(found == want, f"K6 plane {PLANES[p]} of body {k}: "
                  f"{len(found ^ want)} faces differ from the exact slice")
            sizes.append(len(found))
    check(int((plane_faces >= 0).reshape(Bc, -1, PLANE_M).sum(-1).max())
          < PLANE_M, "K6 plane query truncated")
    # K7 value and gradient against the plain version
    want = repulsion_loss_plain(tris.detach(), pairs)
    val_err = float(((loss.detach() - want).abs() / want.abs()).max())
    x64 = tris.detach().double().requires_grad_()
    want64, = torch.autograd.grad(repulsion_loss_plain(x64, pairs).sum(),
                                  x64)
    grad_err = float((grad.double() - want64).abs().max()
                     / want64.abs().max())
    check(bool((loss > 0).all() and torch.isfinite(loss).all()),
          f"K7 loss {loss}")
    check(val_err <= 1e-5 and grad_err <= 1e-4,
          f"K7 vs plain: value {val_err}, gradient {grad_err}")
    n_pairs = int((pairs[..., 0] >= 0).sum())
    skipped = n_pairs - int(live.sum())
    # K9: distances and scores against the plain version. The scores must
    # be equal unless a point's two distances (kernel, plain) fall on
    # either side of the threshold, which they can only within NN_TOL.
    nn_err, straddled, fs = 0.0, 0, {}
    with torch.no_grad():
        for name, (p, q) in clouds.items():
            for k in range(Bc):
                want_d = (nn_dists_plain(p[k], q[k]),
                          nn_dists_plain(q[k], p[k]))
                got_d = (_nn_dists(p[k], q[k]), _nn_dists(q[k], p[k]))
                nn_err = max(nn_err, *(max_err(g, w) for g, w in
                                       zip(got_d, want_d)))
                for thresh in FSCORE_THRESH:
                    if any(bool(((g < thresh) != (w < thresh)).any())
                           for g, w in zip(got_d, want_d)):
                        straddled += 1
                        continue
                    got = scores[name, k, thresh]
                    want = fscore_from_dists(*want_d, thresh)
                    for key in got:
                        check(float(got[key]) == float(want[key]),
                              f"F-score {name} {k} {thresh} {key}: "
                              f"{float(got[key])} vs {float(want[key])}")
                    fs.setdefault((name, thresh), []).append(
                        round(float(got["fscore"]), 4))
    check(nn_err <= NN_TOL, f"K9 distances vs plain {nn_err}")
    fs_text = json.dumps({f"{n}@{t * 1e3:g}mm": v for (n, t), v in fs.items()})
    print(f"contact: {Bc} body pairs in {elapsed * 1e3:.1f} ms; collisions "
          f"per pair {counts} (>= {MIN_COLLISIONS}); pair 0 equal to the "
          f"plain version (barycentrics {bcs_err:.2e}); endpoints within "
          f"{worst:.2e} m of both planes ({clamped} hits in target "
          f"triangles under the 1e-9 clamp: their target's plane only); "
          f"plane quads cross {min(sizes)}-"
          f"{max(sizes)} faces, the exact slice's; repulsion over "
          f"{n_pairs} pairs ({skipped} not live: the backward skipped "
          f"them): loss "
          f"{[round(float(v), 5) for v in loss.detach()]}, rel err "
          f"{val_err:.2e}, "
          f"gradient {grad_err:.2e} of the largest; F-scores {fs_text}"
          f" ({straddled} of {len(scores)} skipped: a point's distances on "
          f"either side of the threshold), distances within {nn_err:.2e} "
          f"m; K6 queries that overflowed their lists: {overflowed}; "
          f"launches { {k: launches[k] for k in CONTACT_KERNELS} }")
    return launches


def write_ppm(path: Path, image: np.ndarray) -> None:
    """(H, W, 3) uint8 RGB as a binary PPM (P6, maxval 255), its folder
    made."""
    from shapy_tpu_torch.data.synthetic import write_ppm as write

    path.parent.mkdir(parents=True, exist_ok=True)
    write(str(path), image)


def write_hbw_tree(root: Path, model, p2p_path: Path) -> None:
    """A synthetic HBW-val tree in ``configs/shapy_eval_shape.yaml``'s
    layout: ``CLI_SUBJECTS`` subjects of ``CLI_IMAGES`` 480x360 PPM images
    each (smooth random content) with OpenPose JSONs (one person inside
    the image), ``genders.yaml`` and GT meshes of ``model`` (OBJ) from
    seeded betas; and a P2P regressor pickle of ``P2P_POINTS`` barycentric
    points."""
    import pickle

    import scipy.sparse
    import torch

    from shapy_tpu_torch.flagship import synthetic_requests

    rng = np.random.default_rng(SEED + 12)
    images, _ = synthetic_requests(CLI_SUBJECTS * CLI_IMAGES, IMAGE_H,
                                   IMAGE_W, CROP, SEED + 12)
    betas = rng.normal(size=(CLI_SUBJECTS, model.num_betas)) * 1.5
    betas *= np.minimum(1.0, 6.0 / np.linalg.norm(betas, axis=1,
                                                  keepdims=True))
    with torch.no_grad():
        gt = model.forward_shape(torch.tensor(
            betas, dtype=torch.float32))["v_shaped"].numpy()
    faces = "".join(f"f {a} {b} {c}\n" for a, b, c in model.faces + 1)
    genders = []
    for si in range(CLI_SUBJECTS):
        sid = f"s{si:03d}"
        genders.append(f"{sid}: {('female', 'male')[si % 2]}\n")
        mesh = root / "smplx" / "val" / f"{sid}.obj"
        mesh.parent.mkdir(parents=True, exist_ok=True)
        mesh.write_text("".join(f"v {x:.9g} {y:.9g} {z:.9g}\n"
                                for x, y, z in gt[si]) + faces)
        for ii in range(CLI_IMAGES):
            rel = Path("val") / f"{sid}_synthetic" / "studio"
            write_ppm(root / "images" / rel / f"img{ii}.ppm",
                      images[si * CLI_IMAGES + ii])
            body = np.stack([rng.uniform(0.3, 0.7, 25) * IMAGE_W,
                             rng.uniform(0.15, 0.85, 25) * IMAGE_H,
                             np.full(25, 0.9)], -1)
            kp = root / "keypoints" / rel / f"img{ii}.json"
            kp.parent.mkdir(parents=True, exist_ok=True)
            kp.write_text(json.dumps({"people": [
                {"pose_keypoints_2d": body.reshape(-1).tolist()}]}))
    (root / "genders.yaml").write_text("".join(genders))
    V = model.num_verts
    tri = model.faces[rng.integers(0, len(model.faces), size=P2P_POINTS)]
    w = rng.dirichlet(np.ones(3), size=P2P_POINTS)
    matrix = scipy.sparse.csr_matrix(
        (w.reshape(-1), (np.repeat(np.arange(P2P_POINTS), 3),
                         tri.reshape(-1))), shape=(P2P_POINTS, V))
    with open(p2p_path, "wb") as f:
        pickle.dump(matrix, f, protocol=2)


def check_padding(dev) -> None:
    """K2 on a padded batch of mixed sizes (the CLI's collate,
    ``data.build.pad_images``) bit-equal to K2 on each image alone and to
    the plain version: the zero fill of a smaller image's padding is the
    zero K2 reads outside an image. Odd widths put the lone images in
    K2's direct regime, the padded batch in its staged one."""
    import torch

    from shapy_tpu_torch.data.build import pad_images
    from shapy_tpu_torch.data.crop import crop_normalize, crop_normalize_plain
    from shapy_tpu_torch.flagship import synthetic_requests

    sizes = ((IMAGE_H, IMAGE_W), (300, 401), (IMAGE_H - 1, IMAGE_W - 1),
             (201, 333))
    images, affines = [], []
    for i, (H, W) in enumerate(sizes):
        img, aff = synthetic_requests(1, H, W, CROP, SEED + 120 + i)
        images.append(img[0])
        affines.append(aff[0])
    full = torch.from_numpy(pad_images(images)).to(dev)
    aff = torch.from_numpy(np.stack(affines)).to(dev)
    with torch.inference_mode():
        batch = crop_normalize(full, aff, CROP)
        check(torch.equal(batch, crop_normalize_plain(full, aff, CROP)),
              "padding: K2 on the padded batch differs from plain")
        for i, img in enumerate(images):
            alone = crop_normalize(torch.from_numpy(img[None]).to(dev),
                                   aff[i:i + 1], CROP)
            check(torch.equal(batch[i:i + 1], alone),
                  f"padding: image {i} ({sizes[i]}) crops otherwise alone")
    print(f"cli: K2 on a padded batch of sizes {sizes} bit-equal to each "
          "image alone and to the plain version")


def evaluate_cli(dev, eval_rate: float):
    """Phase 12: ``cli.evaluate.main`` on a synthetic HBW tree, its config
    ``configs/shapy_eval_shape.yaml`` read by the port's loader, the
    flagship's regressor (``build_body_head`` on the flagship's body,
    ``flagship.build_flagship_body``, in place of the demo builder's
    synthetic body; its weights as phase 3's base: seeded, then
    ``spread_init_``) and the registry's HBW dataset given the regressor's
    measurement module. The CLI runs twice: a cold run, which computes and
    caches the GT measurements, and a warm one on a copy of the same
    regressor, which reads them from the cache. Checks rc 0, finite
    printed metrics, the launches (``CLI_PER_BATCH`` a batch,
    ``CLI_PER_DATASET`` once in the cold run, nothing else), the same
    printed lines from both runs and each run's per-image predictions
    bit-equal to the same padded batches through
    ``apply_from_full_images``; prints the images/s of the warm run's
    batches after the first (the first waits for its whole decode) and
    the host's share of their wall beside phase 5's evaluated images/s,
    and each run's batches one by one."""
    import contextlib
    import io
    import tempfile

    import torch

    from shapy_tpu_torch.cli import demo as demo_mod
    from shapy_tpu_torch.cli import evaluate as cli
    from shapy_tpu_torch.data import build as build_mod
    from shapy_tpu_torch.data.datasets.hbw import HBWDataset
    from shapy_tpu_torch.eval import evaluator as evaluator_mod
    from shapy_tpu_torch.flagship import build_flagship_body, spread_init_
    from shapy_tpu_torch.models.body.assets import make_synthetic_model_data
    from shapy_tpu_torch.models.body.model import SMPLX
    from shapy_tpu_torch.models.heads.regressor import build_body_head
    from shapy_tpu_torch.utils.config import load_config

    repo = Path(__file__).resolve().parent
    base, built, evaluators, seen, spans = [], [], [], [], []
    real_evaluator = evaluator_mod.build_evaluator

    def builder(exp_cfg, checkpoint_path="", device="cuda"):
        if not base:
            body, meas = build_flagship_body(subdivisions=5,
                                             exact_counts=True)
            base.append(spread_init_(
                build_body_head(exp_cfg, body_model=body, measurements=meas),
                seed=SEED, beta_scale=0.25))
        built.append(copy.deepcopy(base[0]).to(device))
        return built[-1]

    def evaluator(*args, **kwargs):
        ev = real_evaluator(*args, **kwargs)
        run = ev.run

        def timed_run(*a, **k):
            t = time.perf_counter()
            out = run(*a, on_batch=lambda *b: seen[-1].append(
                (*b, time.perf_counter())), **k)
            torch.cuda.synchronize()
            spans.append((t, time.perf_counter()))
            return out
        ev.run = timed_run
        evaluators.append(ev)
        return ev

    class HBWWithMeasurements(HBWDataset):
        def __init__(self, **kwargs):
            reg = built[-1]
            super().__init__(measurements_module=reg.body_measurements,
                             body_model_faces=reg.model.faces, **kwargs)

    def run_cli(cfg, out_dir):
        """One ``cli.evaluate.main``: rc, printed lines, wall, launches."""
        seen.append([])
        out = io.StringIO()
        torch.cuda.synchronize()
        reset_launches()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(cfg, output_folder=out_dir, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        return rc, out.getvalue().splitlines(), wall, read_launches()

    images = CLI_SUBJECTS * CLI_IMAGES
    batches = -(-images // CLI_B)
    with tempfile.TemporaryDirectory() as tmp:
        root, p2p = Path(tmp) / "HBW", Path(tmp) / "p2p.pkl"
        t = time.perf_counter()
        write_hbw_tree(root, SMPLX(make_synthetic_model_data(
            "smplx", subdivisions=5, exact_counts=True)), p2p)
        print(f"cli: wrote {images} images in "
              f"{time.perf_counter() - t:.1f} s")
        cfg = load_config({}, [str(repo / "configs" /
                                   "shapy_eval_shape.yaml")], [
            f"datasets.shape.hbw.data_folder={root}",
            f"datasets.batch_size={CLI_B}", "datasets.pose_shape_ratio=0.0",
            f"datasets.shape.transforms.crop_size={CROP}",
            "evaluation.body.v2v_t=['scale','translation']",
            f"evaluation.body.p2p_t.input_point_regressor_path={p2p}"])
        build_mod._populate_registry()
        saved = (demo_mod.build_demo_regressor,
                 evaluator_mod.build_evaluator,
                 build_mod.DATASET_REGISTRY["hbw"])
        demo_mod.build_demo_regressor = builder
        evaluator_mod.build_evaluator = evaluator
        build_mod.DATASET_REGISTRY["hbw"] = HBWWithMeasurements
        try:
            runs = [run_cli(cfg, str(Path(tmp) / f"out{i}"))
                    for i in range(2)]
        finally:
            (demo_mod.build_demo_regressor, evaluator_mod.build_evaluator,
             build_mod.DATASET_REGISTRY["hbw"]) = saved
        (rc, lines, wall, launches), (rc_w, lines_w, wall_w, launches_w) = runs
        print("\n".join(f"cli | {line}" for line in lines))
        check(rc == 0 and rc_w == 0, f"cli: rc {rc}, warm rc {rc_w}")
        check(lines_w == lines, "cli: the warm run printed other lines")
        check(lines[:1] == ["=== shape ==="], f"cli: printed {lines[:2]}")
        values = {line.split(": ")[0]: float(line.split(": ")[1].split()[0])
                  for line in lines[1:]}
        check(all(math.isfinite(v) for v in values.values()),
              "cli: a printed metric is not finite")
        for name in ("v2v_t", "v2v_t_scale", "p2p_t", "height_error",
                     "chest_error", "waist_error", "hips_error",
                     "mass_error"):
            check(name in values, f"cli: no {name} printed")
        for i, run_seen in enumerate(seen):
            check(len(run_seen) == batches,
                  f"cli run {i}: {len(run_seen)} batches")
        for name, *_ in kernels():
            want = CLI_PER_BATCH.get(name, 0) * batches
            check(launches[name] == want + CLI_PER_DATASET.get(name, 0),
                  f"cli: {launches[name]} {name} launches, expected "
                  f"{want + CLI_PER_DATASET.get(name, 0)}")
            check(launches_w[name] == want,
                  f"cli warm run (GT measurements from the cache): "
                  f"{launches_w[name]} {name} launches, expected {want}")

        # The same padded batches through apply_from_full_images directly.
        reg = built[0]
        loaders = build_mod.build_all_data_loaders(
            cfg, "val", target_keypoint_names=reg.model.keypoint_names,
            return_full_imgs=True, enable_augment=False)
        t = time.perf_counter()
        host_batches = list(loaders["shape"])  # decode, transforms, collate
        load_s = time.perf_counter() - t
        direct = []
        with torch.inference_mode():
            for batch in host_batches:
                full = torch.from_numpy(batch["full_images"]).to(dev)
                aff = torch.from_numpy(batch["crop_to_image_affines"]).to(dev)
                direct.append((full, aff, reg.apply_from_full_images(
                    full, aff, CROP)))
        check(len(direct) == batches, "cli: direct batches")
        for run_seen in seen:
            for (outputs, *_), (_, _, want) in zip(run_seen, direct):
                got, exp = outputs["stage_02"], want["stage_02"]
                for key in ("betas", "vertices", "joints", "v_shaped"):
                    check(torch.equal(got[key], exp[key]),
                          f"cli: {key} differs from the direct route")
                check(torch.equal(outputs["proj_joints"],
                                  want["proj_joints"]),
                      "cli: proj_joints differ from the direct route")
                for k, v in want["measurements"].items():
                    check(torch.equal(outputs["measurements"][k], v),
                          f"cli: {k} differs from the direct route")

        check_padding(dev)

        # Device busy time of one batch's forward + metrics.
        full, aff, _ = direct[0]
        targets = seen[0][0][1]

        def step():
            evaluators[-1].compute_batch_metrics(
                reg.apply_from_full_images(full, aff, CROP), targets)
        with torch.inference_mode():
            busy, kernels_a_batch = device_time(step)

    def batch_ms(i):
        """Run ``i``'s host time of each batch, the first from the start
        of ``Evaluator.run``."""
        stamps = [spans[i][0]] + [a[-1] for a in seen[i]]
        return [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]

    # The loader decodes a batch's images on its threads while the main
    # thread runs the batch before; nothing overlaps the first batch's
    # decode, so the batches after it give the loop's steady rate.
    loop_s = [end - start for start, end in spans]
    later_ms = sum(batch_ms(1)[1:])
    rate = CLI_B * (batches - 1) / (later_ms / 1e3)
    host_share = 1.0 - busy * (batches - 1) / later_ms
    print(f"cli: cold run rc 0 in {wall:.1f} s (model build, dataset and "
          f"GT measurements included), its evaluation loop {images} images "
          f"in {loop_s[0] * 1e3:.1f} ms = {images / loop_s[0]:.1f} "
          f"images/s, host time a batch {batch_ms(0)} ms; warm run (a copy "
          f"of the same regressor, GT measurements from the cache) rc 0 in "
          f"{wall_w:.1f} s, its loop {loop_s[1] * 1e3:.1f} ms = "
          f"{images / loop_s[1]:.1f} images/s, host time a batch "
          f"{batch_ms(1)} ms (the first waits for its whole decode); the "
          f"warm run's batches after the first {rate:.1f} images/s, the "
          f"host {host_share:.3f} of their wall (phase 5, the same forward "
          f"+ metrics on batches already on the card: {eval_rate:.1f} "
          f"images/s); the loader alone (decode, transforms, padding "
          f"collate) {load_s * 1e3:.1f} ms for {batches} batches; device "
          f"busy {busy:.3f} ms a batch ({kernels_a_batch} kernels); "
          f"launches {launches}")
    return launches, {"images_s": rate, "host_share": host_share,
                      "batch_ms": batch_ms(1), "loop_ms": loop_s[1] * 1e3,
                      "wall_s": wall_w, "cold_batch_ms": batch_ms(0),
                      "cold_loop_ms": loop_s[0] * 1e3, "cold_wall_s": wall,
                      "busy_ms_a_batch": busy, "loader_ms": load_s * 1e3,
                      "eval_images_s": eval_rate}


# Phase 13: training through the CLI on synthetic archives.
TRAIN_CLI_IMAGE = 320
# (name, samples, seed): two pose archives (the equal sampler), a shape
# archive and a val archive with GT vertices.
TRAIN_CLI_ARCHIVES = (("pose_a", 48, 1), ("pose_b", 48, 2),
                      ("shape_a", 48, 3), ("val", 24, 9))
TRAIN_CLI_STEPS, TRAIN_CLI_EVAL_STEPS = 8, 4
# A train step's kernels whose launches phase 7 fixes.
TRAIN_CLI_KERNELS = ("K3_skinning", "K3_skinning_backward",
                     "K3chain_forward", "K3chain_backward", "K4_bn_forward",
                     "K4_bn_backward", *K5_PER_TRAIN_STEP)


def train_cli_config(root: Path, steps_eval: int, extra=()) -> dict:
    """``configs/train_shapy.yaml`` with dot-list overrides: the synthetic
    archives under ``root`` as its pose, shape and val datasets (SMPL-X
    keypoints, the val archive's vertices), no shape val, the adversarial
    step, a checkpoint every 4 steps and the eval hook every
    ``steps_eval``."""
    from shapy_tpu_torch.utils.config import load_config

    repo = Path(__file__).resolve().parent
    opts = ["datasets.pose.splits.train=['pose_a','pose_b']",
            "datasets.pose.splits.val=['val']",
            "datasets.shape.splits.train=['shape_a']",
            "datasets.shape.splits.val=[]",
            "use_adv_training=True", "checkpoint_steps=4",
            "summary_steps=4", f"eval_steps={steps_eval}"]
    for name, _, _ in TRAIN_CLI_ARCHIVES:
        part = "shape" if name.startswith("shape") else "pose"
        key = f"datasets.{part}.{name}"
        opts += [f"{key}.data_folder={root / name}",
                 f"{key}.npz_files=['fits.npz']",
                 f"{key}.keypoint_format=smplx",
                 f"{key}.body_dset_factor=1.0",
                 f"{key}.return_vertices={name == 'val'}"]
    return load_config({}, [str(repo / "configs" / "train_shapy.yaml")],
                       opts + list(extra))


def _equal_trees(a, b, path: str = "") -> list:
    """The paths at which two checkpoint trees differ (tensors bit for
    bit)."""
    import torch

    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            return [path]
        return [d for k in a for d in _equal_trees(a[k], b[k],
                                                   f"{path}.{k}")]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [path]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _equal_trees(x, y, f"{path}[{i}]")]
    if isinstance(a, torch.Tensor):
        return [] if isinstance(b, torch.Tensor) and torch.equal(a, b) \
            else [path]
    return [] if a == b else [path]


def train_cli(dev, train_launches: dict):
    """Phase 13: ``cli.train.main`` on ``configs/train_shapy.yaml`` at
    full width over synthetic archives (see the module docstring). Returns
    the launches of run 1's train steps, a summary, and K2's noise
    variant's entry for the kernels line."""
    import contextlib
    import io
    import tempfile

    import torch

    from shapy_tpu_torch.cli import demo as demo_mod
    from shapy_tpu_torch.cli import train as cli
    from shapy_tpu_torch.data.crop import crop_normalize, crop_normalize_plain
    from shapy_tpu_torch.data.synthetic import (
        generate_parametric_fits,
        register_synthetic_datasets,
    )
    from shapy_tpu_torch.eval import loop as loop_mod
    from shapy_tpu_torch.flagship import (
        build_flagship_body,
        synthetic_requests,
    )
    from shapy_tpu_torch.io.checkpoint import Checkpointer
    from shapy_tpu_torch.models.heads.regressor import build_body_head
    from shapy_tpu_torch.train.trainer import Trainer

    model, meas = build_flagship_body(subdivisions=5, exact_counts=True)

    def builder(exp_cfg, checkpoint_path="", device="cuda"):
        return build_body_head(exp_cfg, body_model=copy.deepcopy(model),
                               measurements=copy.deepcopy(meas)).to(device)

    # The eval hook's launches are counted apart: each call's are taken
    # back out of the counters.
    eval_launches = collections.Counter()
    make_eval_fn = loop_mod.make_eval_fn

    def counted_make_eval_fn(*args, **kwargs):
        fn = make_eval_fn(*args, **kwargs)

        def eval_fn(step=0, **kw):
            before = {k.source: dict(k.counts) for k in sources()}
            out = fn(step, **kw)
            torch.cuda.synchronize()
            for k in sources():
                for f, n in k.counts.items():
                    eval_launches[f] += n - before[k.source][f]
                k.counts = dict(before[k.source])
            return out

        return eval_fn

    # The first step's crop inputs, for the K2 checks; the host clock at
    # each step's start (its batch on the card); the spans of the eval
    # hook's calls and of the checkpoints' writes, which the rates leave
    # out; a trace of the fit where ``traced`` names the profiler's
    # activities.
    recorded, stamps, pauses, traced, traces = [], [], [], [], []
    images_fn, fit_fn, save_fn = Trainer._images, Trainer.fit, \
        Checkpointer.save

    def recording_images(self, merged):
        stamps.append(time.perf_counter())
        if not recorded and "full_images" in merged:
            recorded.append(tuple(merged[k].clone() for k in (
                "full_images", "crop_to_image_affines", "channel_noise")))
        return images_fn(self, merged)

    def paused(fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            pauses.append((t, time.perf_counter()))
            return out

        return call

    def traced_fit(self, *args, **kwargs):
        from torch.profiler import profile

        torch.cuda.synchronize()
        with (profile(activities=traced.pop()) if traced
              else contextlib.nullcontext()) as prof:
            t = time.perf_counter()
            out = fit_fn(self, *args, **kwargs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        if prof is not None:
            traces.append((prof, wall))
        return out

    def counted_paused_make_eval_fn(*args, **kwargs):
        return paused(counted_make_eval_fn(*args, **kwargs))

    def step_rate(first: int) -> tuple:
        """Steps/s from the median span between consecutive steps' starts
        since stamp ``first``, the spans that hold an eval or a
        checkpoint left out; and those spans in ms."""
        spans = [(a, b) for a, b in zip(stamps[first:], stamps[first + 1:])
                 if not any(a < p0 < b for p0, _ in pauses)]
        ms = [round((b - a) * 1e3, 1) for a, b in spans]
        return 1e3 / sorted(ms)[len(ms) // 2], ms

    def refuse(*args, **kwargs):
        raise RuntimeError("a library convolution or pool was reached")

    def run(cfg, out_dir, steps):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(cfg, output_folder=str(out_dir), num_steps=steps,
                          device=dev)
        lines = out.getvalue().splitlines()
        check(rc == 0, f"train cli: rc {rc}")
        return lines

    def rows(lines):
        import ast

        losses = ast.literal_eval(lines[0])
        evals = [ast.literal_eval(x) for x in lines[1:]
                 if x.startswith("{'eval'")]
        check(all(math.isfinite(v) for v in losses.values()),
              f"train cli: losses {losses}")
        check(all(math.isfinite(v) for r in evals for k, v in r.items()
                  if k not in ("eval", "step")), f"train cli: evals {evals}")
        return losses, evals

    F = torch.nn.functional
    saved = (demo_mod.build_demo_regressor, loop_mod.make_eval_fn,
             Trainer._images, Trainer.fit, Checkpointer.save, F.conv2d,
             F.max_pool2d)
    summary = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "synth"
        t = time.perf_counter()
        body = copy.deepcopy(model).to(dev)
        for name, n, seed in TRAIN_CLI_ARCHIVES:
            generate_parametric_fits(
                str(root / name), n, model=body, seed=seed, device=dev,
                image_size=TRAIN_CLI_IMAGE, betas_std=1.0, pose_std=0.25)
        register_synthetic_datasets([a[0] for a in TRAIN_CLI_ARCHIVES])
        del body
        summary["archives_s"] = time.perf_counter() - t
        print(f"train cli: wrote {sum(a[1] for a in TRAIN_CLI_ARCHIVES)} "
              f"samples at {TRAIN_CLI_IMAGE}^2 in "
              f"{summary['archives_s']:.1f} s")
        demo_mod.build_demo_regressor = builder
        loop_mod.make_eval_fn = counted_paused_make_eval_fn
        Trainer._images, Trainer.fit = recording_images, traced_fit
        Checkpointer.save = paused(save_fn)
        F.conv2d = F.max_pool2d = refuse
        try:
            # Run 1: 8 steps, LSGAN, the eval hook every 4.
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            lines = run(train_cli_config(root, TRAIN_CLI_EVAL_STEPS),
                        Path(tmp) / "run1", TRAIN_CLI_STEPS)
            launches = read_launches()
            peak = torch.cuda.max_memory_allocated()
            losses, evals = rows(lines)
            print("\n".join(f"train cli | {x}" for x in lines))
            check({r["step"] for r in evals} == {0, 4, 8},
                  f"train cli: eval rows at {[r['step'] for r in evals]}")
            check({"adv_gen", "adv_disc"} <= set(losses),
                  f"train cli: losses {sorted(losses)}")
            rate1, spans1 = step_rate(0)
            # Run 2: 4 steps, then a fresh main that resumes and takes 4,
            # its steps under a trace of the host's operators.
            from torch.profiler import ProfilerActivity

            cfg = train_cli_config(root, 0)
            run(cfg, Path(tmp) / "run2", 4)
            traced.append([ProfilerActivity.CPU])
            run(cfg, Path(tmp) / "run2", 4)
            ckpt = "checkpoints/ckpt_00000008"
            a = torch.load(Path(tmp) / "run1" / ckpt, map_location="cpu",
                           weights_only=False)
            b = torch.load(Path(tmp) / "run2" / ckpt, map_location="cpu",
                           weights_only=False)
            differ = _equal_trees(a, b)
            n_model = len(a["model"]) + len(a["disc"]["model"])
            print(f"train cli: 8 steps against 4 + kill + resume + 4: "
                  f"{n_model} module tensors, the optimizers' moments and "
                  f"the schedules compared; {len(differ)} differ "
                  f"{differ[:5]}")
            check(not differ and a["step"] == 8 and a["disc"]["step"] == 8,
                  f"train cli: the resumed run differs: {differ[:5]}")
            # Run 3: 8 WGAN-GP steps, no checkpoint, under a trace of the
            # device's kernels.
            traced.append([ProfilerActivity.CUDA])
            first3 = len(stamps)
            lines3 = run(train_cli_config(root, 0, [
                "losses.discriminator.type=wgan-gp",
                "checkpoint_steps=100"]), Path(tmp) / "run3",
                TRAIN_CLI_STEPS)
            rate3, spans3 = step_rate(first3)
            losses3, _ = rows(lines3)
            print(f"train cli | wgan-gp | {lines3[0]}")
            check("adv_gp" in losses3, f"train cli: wgan-gp losses "
                                       f"{sorted(losses3)}")
        finally:
            (demo_mod.build_demo_regressor, loop_mod.make_eval_fn,
             Trainer._images, Trainer.fit, Checkpointer.save, F.conv2d,
             F.max_pool2d) = saved

    # The resumed leg's operators: no convolution or pooling; run 3's
    # device busy share of its fit (its first step's warm-up included).
    (leg, _), (wgan, wgan_wall) = traces
    names = {e.name for e in leg.events()}
    convs = sorted(n for n in names if "convolution" in n or "cudnn" in n
                   or n == "aten::conv2d" or "pool" in n)
    check(not convs, f"train cli: library convolutions {convs}")
    check(any("_Conv2dActBackward" in n for n in names),
          "train cli: the trace holds no K5 backward node")
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in wgan.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    check(len(spans) > TRAIN_CLI_STEPS * 1000, f"train cli: the trace of "
          f"{TRAIN_CLI_STEPS} steps holds {len(spans)} device events")
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    busy_ms = busy / 1e3

    # A train step's launches (run 1, the eval hook's taken out).
    per_step = {k: v / TRAIN_CLI_STEPS for k, v in launches.items()}
    check(launches["K2_noise"] == TRAIN_CLI_STEPS
          and launches["K2_ingest"] == 0,
          f"train cli: K2 {launches['K2_noise']} with noise, "
          f"{launches['K2_ingest']} without, in {TRAIN_CLI_STEPS} steps")
    for name in TRAIN_CLI_KERNELS:
        want = train_launches[name] / TRAIN_STEPS
        check(per_step[name] == want, f"train cli: {name} {per_step[name]} "
                                      f"a step, phase 7 {want}")
    check(eval_launches["ingest_forward"] > 0
          and eval_launches["ingest_noise_forward"] == 0,
          f"train cli: the eval hook's K2 launches {dict(eval_launches)}")

    # K2's noise variant: the recorded train batch and phase 2's extremes.
    full, aff, noise = recorded[0]
    check(full.dtype == torch.uint8 and full.shape[0] == TRAIN_B,
          f"train cli: recorded {full.dtype} {tuple(full.shape)}")
    big, _ = synthetic_requests(4, IMAGE_H, IMAGE_W, CROP, SEED + 13)
    big = torch.from_numpy(big).to(dev)
    extreme = torch.from_numpy(k2_extreme_affines(IMAGE_H, IMAGE_W,
                                                  CROP)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    ext_noise = torch.rand((3, 3), generator=gen, device=dev) * 0.8 + 0.6
    with torch.inference_mode():
        for what, (x, A, f) in {
                "train batch": (full, aff, noise),
                "extreme": (big[:3], extreme, ext_noise)}.items():
            for x_in in (x, x.to(torch.float32) * (1.0 / 255.0)):
                for out_dtype in (torch.float32, torch.bfloat16):
                    got = crop_normalize(x_in, A, CROP, out_dtype=out_dtype,
                                         factors=f)
                    want = crop_normalize_plain(x_in, A, CROP,
                                                out_dtype=out_dtype,
                                                factors=f)
                    check(torch.equal(got, want),
                          f"K2 noise {what} {x_in.dtype} -> {out_dtype}: "
                          f"max error {max_err(got, want)}")
            got = crop_normalize(x, A, CROP, out_dtype=torch.bfloat16)
            check(torch.equal(got, crop_normalize_plain(
                x, A, CROP, out_dtype=torch.bfloat16)),
                f"K2 without noise on the {what}: differs from plain")
            check(not torch.equal(got, crop_normalize(
                x, A, CROP, out_dtype=torch.bfloat16, factors=f)),
                f"K2 noise on the {what}: the factors changed nothing")
    print("K2 noise: bit-equal to the plain version on the recorded train "
          "batch and phase 2's extreme affines (uint8 and f32 in, f32 and "
          "bf16 out); without factors bit-equal to the plain version")
    pixels = k2_read_pixels(full, aff)
    out_bytes = TRAIN_B * CROP * CROP * 3 * 2
    # Per output pixel: the affine map (8 FLOP) and, per channel, the
    # blend (11), the noise and its clip (3) and the normalisation (2).
    entry = record_kernel(
        {}, "K2_noise", 0.0,
        lambda: crop_normalize(full, aff, CROP, out_dtype=torch.bfloat16,
                               factors=noise),
        lambda: crop_normalize_plain(full, aff, CROP,
                                     out_dtype=torch.bfloat16,
                                     factors=noise),
        pixels * 3 + aff.numel() * 4 + noise.numel() * 4 + out_bytes,
        TRAIN_B * CROP * CROP * (8 + 3 * 16))
    entry["source_pixels_read"] = pixels

    pause_ms = [round((b - a) * 1e3, 1) for a, b in pauses]
    summary.update({
        "steps": TRAIN_CLI_STEPS, "batch": TRAIN_B,
        "steps_per_s": rate1, "images_per_s": rate1 * TRAIN_B,
        "step_spans_ms": spans1, "wgan_steps_per_s": rate3,
        "wgan_step_spans_ms": spans3, "wgan_fit_ms": wgan_wall * 1e3,
        "wgan_busy_ms": busy_ms,
        "wgan_busy_share": busy_ms / 1e3 / wgan_wall,
        "eval_and_checkpoint_ms": pause_ms,
        "peak_memory_gib": peak / 2 ** 30,
        "eval_rows": len(evals), "losses": losses,
        "wgan_gp_losses": losses3, "card": gpu_line()})
    print(f"train cli: run 1 (LSGAN, batch {TRAIN_B}): a step's span "
          f"(one start to the next, on the host clock) {spans1} ms, median "
          f"{1e3 / rate1:.1f} ms = {rate1:.3f} steps/s = "
          f"{rate1 * TRAIN_B:.1f} images/s; eval calls and checkpoint "
          f"writes (left out) {pause_ms} ms; peak memory "
          f"{summary['peak_memory_gib']:.3f} GiB; run 3 (WGAN-GP, traced): "
          f"spans {spans3} ms ({rate3:.3f} steps/s), its fit "
          f"{wgan_wall * 1e3:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({summary['wgan_busy_share']:.3f}); launches a step {dict((k, v) for k, v in per_step.items() if v)}"
          f"; eval hook launches {dict(eval_launches)}; {gpu_line()}")
    return launches, summary, entry


# Phase 14: the demo CLI end to end.
DEMO_IMAGES = 8
DEMO_B = 4
# The demo's launches a batch: the served forward's (K2's crop, the
# backbone, the body model and the measurements; the demo's builder makes
# them without candidate subsets, as the JAX demo's, so K1 walks all
# faces).
DEMO_PER_BATCH = dict(K5_PER_FORWARD, K1_measure=1, K2_ingest=1,
                      K3_skinning=1, K3chain_forward=1)
# Batch 1 against batch 4: only the backbone's bf16 rounding can differ
# (K5-conv's K partitions follow the batch's pixel count, so its f32 sums
# run in other orders), so the features are held to the limit between
# two bf16 backbones whose sums round otherwise (phase 2's route check:
# cosine >= 0.999, rel L2 <= 0.05) and the meshes to the fit's 1 cm.
DEMO_FEATURE_COS, DEMO_FEATURE_REL = 0.999, 0.05
DEMO_VERTEX_TOL = 0.01  # m
# The virtual-measurements CLI prints 2 decimals: half a printed unit,
# plus 1e-4 for its own shape forward and K1 on one body against the
# demo's on a batch of 4 (f32 sums in other orders).
DEMO_VM_TOL = 0.005 + 1e-4


def write_demo_folder(root: Path) -> None:
    """A synthetic OpenPose demo folder: ``DEMO_IMAGES`` 480x360 PPM images
    under ``images/`` (smooth random content, as phase 12's) and their
    OpenPose JSONs (one person inside the image) under ``openpose/``."""
    from shapy_tpu_torch.flagship import synthetic_requests

    rng = np.random.default_rng(SEED + 14)
    images, _ = synthetic_requests(DEMO_IMAGES, IMAGE_H, IMAGE_W, CROP,
                                   SEED + 14)
    for i, image in enumerate(images):
        write_ppm(root / "images" / f"img{i}.ppm", image)
        body = np.stack([rng.uniform(0.3, 0.7, 25) * IMAGE_W,
                         rng.uniform(0.15, 0.85, 25) * IMAGE_H,
                         np.full(25, 0.9)], -1)
        kp = root / "openpose" / f"img{i}_keypoints.json"
        kp.parent.mkdir(parents=True, exist_ok=True)
        kp.write_text(json.dumps({"people": [
            {"pose_keypoints_2d": body.reshape(-1).tolist()}]}))


def write_reference_checkpoint(path: Path, regressor) -> None:
    """``regressor``'s weights in the reference's ``Checkpointer`` layout,
    ``{'model': state_dict}``: ``backbone.*`` with a
    ``num_batches_tracked`` beside each BN, ``regressor.module.*`` (the
    head), ``regressor.mean_param`` flat, and body-model constants under
    ``model.*`` (which the import skips)."""
    import torch

    sd = {}
    for k, v in regressor.state_dict().items():
        if k.startswith("backbone."):
            sd[k] = v.clone()
            if k.endswith("running_var"):
                sd[k[:-len("running_var")] + "num_batches_tracked"] = (
                    torch.tensor(1000, dtype=torch.long))
        elif k.startswith("head."):
            sd["regressor.module." + k[len("head."):]] = v.clone()
        elif k == "param_mean":
            sd["regressor.mean_param"] = v.reshape(-1).clone()
        elif k.startswith("model."):
            sd[k] = v.clone()
    torch.save({"model": sd, "iteration": 0}, path)


def png_size(path: Path) -> tuple:
    """(width, height, channels) from a PNG's IHDR."""
    data = path.read_bytes()[:26]
    check(data[:8] == b"\x89PNG\r\n\x1a\n" and data[12:16] == b"IHDR",
          f"demo: {path.name} is not a PNG")
    w, h = int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24],
                                                              "big")
    return w, h, {2: 3, 6: 4}[data[25]]


class RecordingWriter:
    """A duck-typed summary writer that keeps what it is given (no
    ``add_figure``: the BMI bars arrive as raw bucket scalars)."""

    def __init__(self):
        self.images, self.scalars, self.flushed = {}, {}, 0

    def add_image(self, tag, image, step):
        self.images[tag] = (np.asarray(image), step)

    def add_scalar(self, tag, value, step):
        self.scalars[tag] = (float(value), step)

    def flush(self):
        self.flushed += 1


def demo_summaries(regressor, eval_data, eval_launches) -> dict:
    """Phase 14's evaluator leg: ``Evaluator.run`` on phase 5's batches
    with a :class:`RecordingWriter` and ``render_summaries`` on. The image
    grids and the scalars must arrive, and the launches must be phase 5's
    with one more K2 (the summary's crops in f32)."""
    import torch

    from shapy_tpu_torch.eval.loop import make_eval_fn
    from shapy_tpu_torch.flagship import REFERENCE_EVAL_CFG

    writer = RecordingWriter()
    eval_fn = make_eval_fn(regressor, {"hbw_synthetic": eval_data["batches"]},
                           REFERENCE_EVAL_CFG,
                           keypoint_names=regressor.model.keypoint_names,
                           point_regressor=eval_data["p2p"],
                           j14_regressor=eval_data["j14"],
                           crop_size=CROP, summary_writer=writer)
    torch.cuda.synchronize()
    reset_launches()
    t = time.perf_counter()
    with eval_fn.evaluator:
        results = eval_fn(step=7)["hbw_synthetic"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_launches()
    for name, *_ in kernels():
        want = eval_launches[name] + (name == "K2_ingest")
        check(launches[name] == want, f"demo summaries: {launches[name]} "
              f"{name} launches, phase 5's {eval_launches[name]} + "
              f"{int(name == 'K2_ingest')}")
    tags = sorted(writer.images)
    want_tags = ["hbw_synthetic/Images", "hbw_synthetic/Images/est_keypoints",
                 "hbw_synthetic/Images/gt_mesh"]
    check(tags == want_tags, f"demo summaries: image tags {tags}")
    grid, step = writer.images["hbw_synthetic/Images"]
    check(grid.shape == (3, CROP, 4 * CROP) and grid.dtype == np.uint8
          and step == 7 and grid.std() > 0,
          f"demo summaries: grid {grid.shape} {grid.dtype} step {step}")
    for name, value in results.items():
        got = writer.scalars.get(f"hbw_synthetic/{name}")
        check(got is not None and (got[0] == value or (
            math.isnan(value) and math.isnan(got[0]))),
              f"demo summaries: scalar {name} {got} vs {value}")
    buckets = [t for t in writer.scalars if "/bmi_histogram/" in t]
    try:  # the evaluator draws the bars with it, as the JAX package does
        import matplotlib  # noqa: F401
        has_mpl = True
    except Exception:
        has_mpl = False
    route = ("raw bucket scalars (the writer has no add_figure)" if has_mpl
             else "none (matplotlib is not installed)")
    check(bool(buckets) == has_mpl, f"demo summaries: {len(buckets)} "
          f"bucket scalars with matplotlib {has_mpl}")
    check(writer.flushed == 1, "demo summaries: the writer was not flushed")
    print(f"demo summaries: Evaluator.run on phase 5's {EVAL_BATCHES} "
          f"batches with a recording writer in {wall * 1e3:.1f} ms: images "
          f"{tags} (grid {grid.shape}), {len(writer.scalars)} scalars; BMI "
          f"histogram route: {route} ({len(buckets)} bucket scalars); "
          f"launches phase 5's + one K2")
    return {"summary_ms": wall * 1e3, "bmi_route": route,
            "image_tags": tags, "scalars": len(writer.scalars)}


def demo_kernel_calls(direct, full, aff) -> dict:
    """Every kernel wrapper's call in one demo forward of ``direct`` on the
    padded full images ``full`` and their affines, with its arguments
    (kept alive, to replay them): {"K2": [(args, kwargs)], "conv": [(x,
    weight, bias, residual, relu, stride)], "fuse": [(x, terms)], "chain":
    [(args, kwargs)], "skin": [args], "measure": [(vertices,
    use_face_subsets)]}."""
    import torch

    from shapy_tpu_torch.models.backbones import hrnet, layers
    from shapy_tpu_torch.models.body import lbs
    from shapy_tpu_torch.models.heads import regressor as head_mod

    calls = {k: [] for k in ("K2", "conv", "fuse", "chain", "skin",
                             "measure")}
    saved = (head_mod.crop_normalize, layers.conv2d_act, hrnet.hr_fuse,
             lbs.batch_rigid_transform, lbs.skin)
    crop_fn, conv_fn, fuse_fn, chain_fn, skin_fn = saved
    meas = direct.body_measurements
    measure_fn = meas.measure

    def crop(*args, **kwargs):
        calls["K2"].append((args, kwargs))
        return crop_fn(*args, **kwargs)

    def conv(x, weight, bias=None, residual=None, relu=False, stride=1):
        calls["conv"].append((x, weight, bias, residual, relu, stride))
        return conv_fn(x, weight, bias, residual, relu, stride)

    def fuse(x, terms):
        calls["fuse"].append((x, list(terms)))
        return fuse_fn(x, terms)

    def chain(*args, **kwargs):
        calls["chain"].append((args, kwargs))
        return chain_fn(*args, **kwargs)

    def skin(*args):
        calls["skin"].append(args)
        return skin_fn(*args)

    def measure(vertices, use_face_subsets=True):
        calls["measure"].append((vertices, use_face_subsets))
        return measure_fn(vertices, use_face_subsets)

    (head_mod.crop_normalize, layers.conv2d_act, hrnet.hr_fuse,
     lbs.batch_rigid_transform, lbs.skin) = crop, conv, fuse, chain, skin
    meas.measure = measure
    try:
        with torch.inference_mode():
            direct.apply_from_full_images(full, aff, CROP)
    finally:
        (head_mod.crop_normalize, layers.conv2d_act, hrnet.hr_fuse,
         lbs.batch_rigid_transform, lbs.skin) = saved
        del meas.measure
    return calls


def check_demo_kernels(direct, full, aff) -> dict:
    """Phase 14, every kernel of the demo's forward against its plain
    version on the card, at the demo's own batch (4 or 1), on the inputs
    that batch's forward gives it (:func:`demo_kernel_calls`). K5-conv's
    plan follows the batch (its tiles and K partitions, so the split-K
    reduction too), so phase 2's checks at batch 32 and 2 do not cover
    these plans. Limits as phase 2's: K2 bit-equal; each of the 331
    K5-conv calls within ``conv2d_act_bf16_tolerance`` of the plain
    version and of the plain epilogue on the exact sum (f64); each of the
    26 K5-fuse calls bit-equal; the whole backbone against the plain route
    (features cosine >= 0.999, rel L2 <= 0.05, as
    :func:`check_backbone_routes`); K3-chain's three outputs and K3's
    vertices within 1e-5 of the plain versions in f32 and f64; K1 (the
    demo's walk: all faces, as its builder makes no candidate subsets)
    mass / height rel 1e-5, circumferences 1e-5 m, plane heights 1e-6."""
    import torch
    import torch.nn.functional as F

    from shapy_tpu_torch.core.kinematics import (
        batch_rigid_transform,
        batch_rigid_transform_plain,
    )
    from shapy_tpu_torch.data.crop import crop_normalize, crop_normalize_plain
    from shapy_tpu_torch.measure.measurements import PLANES, measure_plain
    from shapy_tpu_torch.models.backbones import hrnet, layers
    from shapy_tpu_torch.models.body.lbs import skin, skin_plain

    n = len(full)
    calls = demo_kernel_calls(direct, full, aff)
    check(len(calls["K2"]) == 1 and len(calls["chain"]) == 1
          and len(calls["skin"]) == 1 and len(calls["measure"]) == 1,
          f"demo kernels at batch {n}: "
          f"{ {k: len(v) for k, v in calls.items()} } calls")
    with torch.inference_mode():
        args, kwargs = calls["K2"][0]
        check(torch.equal(crop_normalize(*args, **kwargs),
                          crop_normalize_plain(*args, **kwargs)),
              f"demo kernels at batch {n}: K2 differs from its plain version")

        check(len(calls["conv"]) == K5_PER_FORWARD["K5_conv"],
              f"demo kernels at batch {n}: {len(calls['conv'])} convs")
        steps = steps_exact = 0.0
        plans = set()
        saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            for x, w, b, r, relu, stride in calls["conv"]:
                k, cin = w.shape[-1], x.shape[1]
                plans.add(conv_plan_text(n, cin, w.shape[0], k, stride,
                                         x.shape[2])[1])
                got = layers.conv2d_act(x, w, b, r, relu, stride)
                want = layers.conv2d_act_plain(x, w, b, r, relu, stride)
                exact_sum = F.conv2d(x.double(), w.double(), None, stride,
                                     k // 2)
                terms = F.conv2d(x.abs().float(), w.abs().float(), None,
                                 stride, k // 2)
                exact = exact_sum.to(torch.bfloat16)
                if b is not None:
                    exact = exact + b[:, None, None]
                if r is not None:
                    exact = exact + r
                if relu:
                    exact = torch.relu(exact)
                tol = layers.conv2d_act_bf16_tolerance(exact_sum.float(), b,
                                                       r, terms, cin, k)
                steps = max(steps, float(
                    ((got.float() - want.float()).abs() / tol).max()))
                steps_exact = max(steps_exact, float(
                    ((got.float() - exact.float()).abs() / tol).max()))
        finally:
            torch.backends.cudnn.allow_tf32 = saved
        check(steps <= 1.0 and steps_exact <= 1.0,
              f"demo kernels at batch {n}: K5-conv at {steps:.3f} of the "
              f"tolerance from plain, {steps_exact:.3f} from the exact sum")

        check(len(calls["fuse"]) == K5_PER_FORWARD["K5_fuse"],
              f"demo kernels at batch {n}: {len(calls['fuse'])} fusions")
        for i, (x, terms) in enumerate(calls["fuse"]):
            check(torch.equal(hrnet.hr_fuse(x, terms),
                              hrnet.hr_fuse_plain(x, terms)),
                  f"demo kernels at batch {n}: fusion {i} differs")

        args, kwargs = calls["K2"][0]
        crops = crop_normalize(*args, **kwargs)
        k5 = direct.compute_features(crops)
        routes = (layers._conv2d_act_cuda, hrnet._hr_fuse_cuda,
                  layers._max_pool2d_cuda)
        layers._conv2d_act_cuda = layers.conv2d_act_plain
        hrnet._hr_fuse_cuda = hrnet.hr_fuse_plain
        layers._max_pool2d_cuda = layers.max_pool2d_plain
        try:
            plain = direct.compute_features(crops)
        finally:
            (layers._conv2d_act_cuda, hrnet._hr_fuse_cuda,
             layers._max_pool2d_cuda) = routes
        cos = float(F.cosine_similarity(k5.flatten().double(),
                                        plain.flatten().double(), dim=0))
        rel = float((k5 - plain).norm() / plain.norm())
        check(bool(torch.isfinite(k5).all()) and cos >= 0.999
              and rel <= 0.05, f"demo kernels at batch {n}: backbone "
              f"against the plain route: cosine {cos}, rel L2 {rel}")

        args, kwargs = calls["chain"][0]
        got = batch_rigid_transform(*args, **kwargs)
        chain_err = 0.0
        for dtype in (torch.float32, torch.float64):
            cast = [a.to(dtype) if torch.is_tensor(a) and a.is_floating_point()
                    else a for a in args]
            want = batch_rigid_transform_plain(*cast, **kwargs)
            chain_err = max(chain_err, *(max_err(g, w)
                                         for g, w in zip(got, want)))
        check(chain_err <= 1e-5,
              f"demo kernels at batch {n}: K3-chain err {chain_err}")

        args = calls["skin"][0]
        got = skin(*args)
        skin_err = max(max_err(got, skin_plain(*[a.to(dtype) for a in args]))
                       for dtype in (torch.float32, torch.float64))
        check(skin_err <= 1e-5, f"demo kernels at batch {n}: K3 err "
                                f"{skin_err} m")

        meas = direct.body_measurements
        v, use_subsets = calls["measure"][0]
        got, got_h = meas.measure(v, use_subsets)
        plane_faces = ([getattr(meas, f"subset_{p}") for p in PLANES]
                       if use_subsets and meas.has_subsets else None)
        want, want_h = measure_plain(v, meas.faces, plane_faces, meas.anchors,
                                     meas.num_hull_directions, meas.density,
                                     meas.slice_mode)
        k1_rel = float(((got[:, :2] - want[:, :2]).abs()
                        / want[:, :2].abs()).max())
        k1_circ = max_err(got[:, 2:], want[:, 2:])
        k1_h = max_err(got_h, want_h)
        check(k1_rel <= 1e-5 and k1_circ <= 1e-5 and k1_h <= 1e-6,
              f"demo kernels at batch {n}: K1 mass/height rel {k1_rel}, "
              f"circumferences {k1_circ} m, plane heights {k1_h}")
    walk = "subsets" if plane_faces else "all faces"
    print(f"demo kernels at batch {n} against their plain versions: K2 "
          f"bit-equal; K5-conv's 331 calls ({len(plans)} plans) at most "
          f"{steps:.3f} of the tolerance from plain and {steps_exact:.3f} "
          f"from the exact sum (limit 1); K5-fuse's 26 bit-equal; backbone "
          f"against the plain route cosine {cos:.6f} (>= 0.999), rel L2 "
          f"{rel:.3e} (<= 0.05); K3-chain {chain_err:.3e}, K3 {skin_err:.3e} "
          f"m (tol 1e-5); K1 ({walk}) mass/height rel {k1_rel:.3e}, "
          f"circumferences {k1_circ:.3e} m (tol 1e-5), plane heights "
          f"{k1_h:.3e} (tol 1e-6)")
    return {"conv_steps": steps, "conv_steps_exact": steps_exact,
            "conv_plans": len(plans), "backbone_cosine": cos,
            "backbone_rel_l2": rel, "k3chain_err": chain_err,
            "k3_err": skin_err, "k1_rel": k1_rel, "k1_circ": k1_circ,
            "k1_walk": walk}


@contextlib.contextmanager
def demo_body():
    """The demo builder's synthetic body at the flagship's counts:
    ``SHAPY_TPU_SYNTHETIC_BODY=1``, ``SHAPY_TPU_TEST_SUBDIV=5`` and
    ``make_synthetic_model_data(exact_counts=True)`` (10475 vertices,
    20908 faces), so that the CLIs' own builders run at full width."""
    import functools

    from shapy_tpu_torch.cli import demo as demo_mod
    from shapy_tpu_torch.models.body import assets

    saved_env = {k: os.environ.get(k) for k in (
        "SHAPY_TPU_SYNTHETIC_BODY", "SHAPY_TPU_TEST_SUBDIV")}
    os.environ.update(SHAPY_TPU_SYNTHETIC_BODY="1", SHAPY_TPU_TEST_SUBDIV="5")
    make = assets.make_synthetic_model_data
    exact = functools.partial(make, exact_counts=True)
    assets.make_synthetic_model_data = exact
    demo_mod.make_synthetic_model_data = exact
    try:
        yield
    finally:
        assets.make_synthetic_model_data = make
        demo_mod.make_synthetic_model_data = make
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def demo_cli(dev, regressor, eval_data, eval_launches):
    """Phase 14: ``cli.demo.main`` on ``configs/shapy_demo.yaml`` at full
    width (HRNet-W48, 256^2 crops, 3 stages, bf16 backbone, BN folded)
    over a synthetic OpenPose folder. The demo's own builder runs on the
    flagship's synthetic SMPL-X (:func:`demo_body`), its weights through
    ``pretrained``: a reference-layout checkpoint of that builder's
    regressor with seeded weights (``spread_init_``), which the builder
    imports into a regressor of its own (the JAX init's) weights. Runs at
    batch 4 and at 1 with every output on, then once more at batch 4 under
    a trace of the host's operators; ``F.conv2d`` and ``F.max_pool2d``
    raise throughout. Each batch's forward must be bit-equal to the seeded
    regressor's, and at both batches every kernel of the forward is held
    to its plain version (:func:`check_demo_kernels`). Then the
    evaluator's summaries (:func:`demo_summaries`) and the
    virtual-measurements CLI on the demo's npz files. Returns the batch-4
    run's launches and a summary."""
    import importlib
    import io
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from shapy_tpu_torch.cli import demo as demo_mod
    from shapy_tpu_torch.cli import virtual_measurements as vm_cli
    from shapy_tpu_torch.flagship import spread_init_
    from shapy_tpu_torch.models.heads.regressor import BodyRegressor
    from shapy_tpu_torch.utils.config import load_config

    modules = {}
    for name in ("matplotlib", "tensorboard", "cv2"):
        try:
            modules[name] = getattr(importlib.import_module(name),
                                    "__version__", "imported")
        except Exception as exc:  # absent, or present and broken
            modules[name] = f"not importable ({type(exc).__name__})"
    print(f"demo: importable here {modules}")
    repo = Path(__file__).resolve().parent
    summary = {"modules": modules}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t = time.perf_counter()
        write_demo_folder(tmp / "samples")
        ckpt = tmp / "shapy_reference.ckpt"
        cfg = load_config({}, [str(repo / "configs" / "shapy_demo.yaml")], [
            f"datasets.pose.openpose.data_folder={tmp / 'samples'}",
            f"datasets.crop_size={CROP}", f"pretrained={ckpt}"])
        with demo_body():
            base = spread_init_(demo_mod.build_demo_regressor(
                cfg, "", device="cpu"), seed=SEED, beta_scale=0.25)
        check(base.model.v_template.shape[0] == 10475,
              f"demo: the builder's body has "
              f"{base.model.v_template.shape[0]} vertices")
        write_reference_checkpoint(ckpt, base)
        direct = base.to(dev).prepare_for_eval_(
            torch.bfloat16 if dev.type == "cuda" else torch.float32)
        del base
        summary["setup_s"] = time.perf_counter() - t
        calls = []
        forward = BodyRegressor.apply_from_full_images

        def recorded(self, full, aff, crop_size=256, **norm):
            out = forward(self, full, aff, crop_size, **norm)
            calls[-1].append((full, aff, out))
            return out

        renders = []
        save = demo_mod._save_sample_outputs

        def timed_save(*args, **kwargs):
            t = time.perf_counter()
            save(*args, **kwargs)
            renders[-1].append(time.perf_counter() - t)

        def refuse(*args, **kwargs):
            raise RuntimeError("F.conv2d reached in the demo")

        def run(out_dir, batch, trace=False, outputs=True):
            calls.append([])
            renders.append([])
            buf = io.StringIO()
            torch.cuda.synchronize()
            reset_launches()
            t = time.perf_counter()
            ctx = (profile(activities=[ProfilerActivity.CPU]) if trace
                   else contextlib.nullcontext())
            with ctx as prof, contextlib.redirect_stdout(buf):
                rc = demo_mod.main(cfg, demo_output_folder=str(out_dir),
                                   save_vis=outputs, save_params=outputs,
                                   save_mesh=outputs, batch_size=batch,
                                   device=dev)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t
            lines = buf.getvalue().splitlines()
            check(rc == 0, f"demo at batch {batch}: rc {rc}")
            return lines, wall, read_launches(), prof

        F = torch.nn.functional
        conv2d, max_pool2d = F.conv2d, F.max_pool2d
        BodyRegressor.apply_from_full_images = recorded
        demo_mod._save_sample_outputs = timed_save
        F.conv2d = F.max_pool2d = refuse
        try:
            with demo_body():
                runs = {b: run(tmp / f"out{b}", b) for b in (DEMO_B, 1)}
                _, _, traced_launches, prof = run(tmp / "traced", DEMO_B,
                                                  trace=True, outputs=False)
        finally:
            F.conv2d, F.max_pool2d = conv2d, max_pool2d
            demo_mod._save_sample_outputs = save
            BodyRegressor.apply_from_full_images = forward
        names = {e.name for e in prof.events()}
        convs = sorted(n for n in names if "convolution" in n or "cudnn" in n
                       or n == "aten::conv2d" or "pool" in n)
        check(not convs, f"demo: library convolution or pooling operators "
                         f"{convs}")

        stems = [f"img{i}" for i in range(DEMO_IMAGES)]
        want_files = sorted(
            f"{s}{suffix}" for s in stems
            for suffix in (".npz", ".ply", "_hd_imgs.png",
                           "_hd_stage_02_overlay.png",
                           "_hd_stage_02_cat.png"))
        recorded = {}
        for batch, (lines, wall, launches, _) in runs.items():
            out_dir = tmp / f"out{batch}"
            check(sorted(os.listdir(out_dir)) == want_files,
                  f"demo at batch {batch}: files "
                  f"{sorted(os.listdir(out_dir))}")
            batches = -(-DEMO_IMAGES // batch)
            for name, *_ in kernels():
                want = DEMO_PER_BATCH.get(name, 0) * batches
                check(launches[name] == want,
                      f"demo at batch {batch}: {launches[name]} {name} "
                      f"launches, expected {want}")
            # The forward of each batch against the directly loaded
            # regressor on the same padded images: bit-equal.
            check(len(calls[0 if batch == DEMO_B else 1]) == batches,
                  f"demo at batch {batch}: forwards")
            per_image = {}
            for full, aff, out in calls[0 if batch == DEMO_B else 1]:
                with torch.inference_mode():
                    want = direct.apply_from_full_images(full, aff, CROP)
                for key in ("betas", "vertices", "joints", "v_shaped",
                            "global_rot", "body_pose"):
                    check(torch.equal(out["stage_02"][key],
                                      want["stage_02"][key]),
                          f"demo at batch {batch}: {key} differs from the "
                          "regressor loaded directly")
                check(torch.equal(out["features"], want["features"]),
                      f"demo at batch {batch}: features differ")
                for k, v in want["measurements"].items():
                    check(torch.equal(out["measurements"][k], v),
                          f"demo at batch {batch}: {k} differs")
                for i in range(len(full)):
                    per_image[len(per_image)] = {
                        "features": out["features"][i].float().cpu(),
                        "vertices": out["stage_02"]["vertices"][i].cpu(),
                        "measurements": {k: float(v[i]) for k, v in
                                         out["measurements"].items()}}
            recorded[batch] = per_image
            full, aff, _ = calls[0 if batch == DEMO_B else 1][0]
            summary[f"kernels_b{batch}"] = check_demo_kernels(direct, full,
                                                              aff)
            # The npz files hold the forward's vertices and measurements.
            for i, stem in enumerate(stems):
                with np.load(out_dir / f"{stem}.npz",
                             allow_pickle=True) as d:
                    check(np.array_equal(d["vertices"],
                                         per_image[i]["vertices"].numpy()),
                          f"demo at batch {batch}: {stem}.npz vertices "
                          "differ from the forward's")
                    m = d["measurements"].item()
                    check(all(float(m[k]) == v for k, v in
                              per_image[i]["measurements"].items()),
                          f"demo at batch {batch}: {stem}.npz measurements")
                w, h, c = png_size(out_dir / f"{stem}_hd_stage_02_overlay.png")
                check((w, h, c) == (IMAGE_W, IMAGE_H, 4),
                      f"demo: overlay {w}x{h}x{c}")
                w, h, c = png_size(out_dir / f"{stem}_hd_stage_02_cat.png")
                check((w, h, c) == (2 * IMAGE_W, IMAGE_H, 3),
                      f"demo: side by side {w}x{h}x{c}")
        for name, *_ in kernels():
            want = DEMO_PER_BATCH.get(name, 0) * (-(-DEMO_IMAGES // DEMO_B))
            check(traced_launches[name] == want,
                  f"demo traced: {traced_launches[name]} {name} launches")

        # Batch 1 against batch 4.
        worst = {"cos": 1.0, "rel": 0.0, "vertices": 0.0, "meas": 0.0}
        for i in range(DEMO_IMAGES):
            a, b = recorded[DEMO_B][i], recorded[1][i]
            fa, fb = a["features"].double(), b["features"].double()
            cos = float(fa @ fb / (fa.norm() * fb.norm()))
            rel = float((fa - fb).norm() / fb.norm())
            dv = float((a["vertices"] - b["vertices"]).abs().max())
            dm = max(abs(a["measurements"][k] - b["measurements"][k])
                     for k in a["measurements"])
            worst = {"cos": min(worst["cos"], cos),
                     "rel": max(worst["rel"], rel),
                     "vertices": max(worst["vertices"], dv),
                     "meas": max(worst["meas"], dm)}
        check(worst["cos"] >= DEMO_FEATURE_COS
              and worst["rel"] <= DEMO_FEATURE_REL,
              f"demo: batch 1 vs {DEMO_B} features {worst}")
        check(worst["vertices"] <= DEMO_VERTEX_TOL,
              f"demo: batch 1 vs {DEMO_B} vertices {worst}")
        print(f"demo: batch 1 against batch {DEMO_B}: features cosine >= "
              f"{worst['cos']:.6f}, rel L2 <= {worst['rel']:.3e}; vertices "
              f"within {worst['vertices']:.3e} m, measurements within "
              f"{worst['meas']:.3e} (limits {DEMO_FEATURE_COS}, "
              f"{DEMO_FEATURE_REL}, {DEMO_VERTEX_TOL} m)")

        # The virtual-measurements CLI on the demo's npz files, on the
        # same synthetic body.
        buf = io.StringIO()
        with demo_body(), contextlib.redirect_stdout(buf):
            rc = vm_cli.main(str(tmp / f"out{DEMO_B}"), str(tmp / "vm"),
                             render=False, device=str(dev))
        lines = [ln for ln in buf.getvalue().splitlines()
                 if "Virtual measurements" in ln]
        check(rc == 0 and len(lines) == DEMO_IMAGES,
              f"demo: virtual measurements rc {rc}, {len(lines)} lines")
        worst_vm = 0.0
        for i, line in enumerate(lines):
            parts = line.split()
            got = {parts[j].rstrip(":"): float(parts[j + 1])
                   for j in range(2, len(parts), 3)}
            want = recorded[DEMO_B][i]["measurements"]
            for k, v in got.items():
                worst_vm = max(worst_vm, abs(v - want[k]))
        check(worst_vm <= DEMO_VM_TOL,
              f"demo: virtual measurements {worst_vm} from the npz's")
        print(f"demo: virtual-measurements CLI on the {DEMO_IMAGES} npz "
              f"files: printed values within {worst_vm:.4f} of the npz "
              f"measurements (limit {DEMO_VM_TOL})")

    del direct
    summary.update(demo_summaries(regressor, eval_data, eval_launches))
    rates, render_s = {}, {}
    for i, (batch, (lines, wall, _, _)) in enumerate(runs.items()):
        thr = [ln for ln in lines if ln.startswith("Throughput:")]
        check(len(thr) == 1, f"demo at batch {batch}: printed {lines}")
        rates[batch] = float(thr[0].split()[1])
        per_batch = [sum(renders[i][j:j + batch])
                     for j in range(0, DEMO_IMAGES, batch)]
        render_s[batch] = per_batch
        summary[f"wall_s_b{batch}"] = wall
    summary.update({"images_s": rates, "render_s_a_batch": render_s,
                    "batch1_vs_4": worst, "vm_max_err": worst_vm,
                    "card": gpu_line()})
    print(f"demo: images/s on the host clock (the demo's own Throughput "
          f"line: forward and copy to the host) {rates}; host seconds a "
          f"batch spent writing and rendering {render_s}; main's wall "
          f"{ {b: round(r[1], 2) for b, r in runs.items()} } s; "
          f"{gpu_line()}")
    return runs[DEMO_B][2], summary



# Phase 15: the attribute models, their CLIs and the regressor's plugins.
ATTR_CONFIGS = {"b2a": "configs/s2a.yaml",
                "a2b": "configs/a2s_variations/02b_ahw2s.yaml"}
ATTR_GENDERS = ("female", "male")
# fit_nn: A2S from the attributes alone (00_a2s's features) into an MLP
# (256, 256) on the synthetic database (400 training rows), the default
# batch (256), v2v and the four measurement losses.
ATTR_FIT_STEPS = 50
ATTR_FIT_CONFIG = "configs/a2s_variations/00_a2s.yaml"
ATTR_FIT_OPTS = ("network.type=mlp", "network.mlp.layers=[256,256]")
ATTR_DEMO_FILES, ATTR_DEMO_MODELS = 6, 4
ATTR_TRAIN_STEPS = 4
ATTR_AGENCY_MODELS, ATTR_AGENCY_IMAGES = 24, 2
ATTR_TOL = 1e-5
ATTR_CHECK_CHUNK = 64  # bodies a plain K1 check takes at once (phase 2: 48)
NUMBER_RE = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?|nan|inf")


def attr_config(kind: str, gender: str, *opts, path: str = "") -> dict:
    """``ATTR_CONFIGS[kind]`` (or ``path``) for ``gender``, with ``opts``."""
    from shapy_tpu_torch.utils.config import load_config

    repo = Path(__file__).resolve().parent
    return load_config({}, [str(repo / (path or ATTR_CONFIGS[kind]))], [
        f"ds_gender={gender}", f"model_gender={gender}", *opts])


def run_quietly(fn, *args, **kwargs) -> tuple:
    """``fn``'s return value, its printed lines and the launches it made
    (the counts set to 0 just before it)."""
    import contextlib
    import io

    import torch

    buf = io.StringIO()
    torch.cuda.synchronize()
    reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return rc, buf.getvalue().splitlines(), read_launches()


def attr_fit_regression(root: Path, dev, launches) -> dict:
    """``cli.fit_regression.main`` with ``--train`` and then without, on
    the synthetic database, for S2A (``configs/s2a.yaml``) and A2S (02b:
    whw2s and BodyTalk) and both genders: every printed number finite; the
    saved polynomials written as reference Lightning checkpoints
    (``{'state_dict': {'b2a.linear.weight': ...}, 'hyper_parameters':
    {'cfg': ...}}``); the card's predictions on the val split against a
    CPU copy's (largest difference over the largest value, tol 1e-5).
    Returns the checkpoints' paths by (kind, gender)."""
    import torch

    from shapy_tpu_torch.cli import fit_regression as cli
    from shapy_tpu_torch.models.attributes.build import MODEL_DICT
    from shapy_tpu_torch.models.attributes.polynomial import Polynomial
    from shapy_tpu_torch.models.attributes.regression_data import (
        RegressionDataset,
    )

    checkpoints = {}
    for kind in ATTR_CONFIGS:
        for gender in ATTR_GENDERS:
            out = root / f"{kind}_{gender}"
            cfg = attr_config(kind, gender, f"output_dir={out}",
                              "use_synthetic_db=True")
            printed = []
            for train in (True, False):
                rc, lines, counts = run_quietly(cli.main, cfg, train,
                                                device=dev)
                launches.update(counts)
                check(rc == 0, f"fit_regression {kind} {gender}: rc {rc}")
                printed += [ln for ln in lines if "checkpoint" not in ln]
            values = [float(v) for ln in printed
                      for v in NUMBER_RE.findall(ln.split(":", 1)[-1])]
            check(len(values) >= 3 and all(map(math.isfinite, values)),
                  f"fit_regression {kind} {gender}: {printed}")
            model = MODEL_DICT[kind](cfg)
            net = getattr(model, kind)
            net.load_state_dict(Polynomial.load_checkpoint(
                str(out / "last.ckpt.npz")).state_dict())
            path = root / f"{kind}_{gender}.ckpt"
            torch.save({"state_dict": model.state_dict(),
                        "hyper_parameters": {"cfg": cfg}}, path)
            checkpoints[kind, gender] = path
            val = RegressionDataset.synthetic(
                ds_gender=gender, model_gender=gender).db["val"]
            x = (val[f"betas_smplx_{gender}"] if kind == "b2a" else
                 model.preprocess(model.create_input_feature_vec(val)))
            want = net.predict(x)
            got = copy.deepcopy(net).to(dev).predict(x)
            rel = float(np.abs(got - want).max() / np.abs(want).max())
            check(rel <= ATTR_TOL, f"fit_regression {kind} {gender}: the "
                  f"card's predictions off the CPU's by {rel}")
            print(f"attributes: fit_regression {kind} {gender}: "
                  f"{printed[1].strip()}, {printed[-1].strip()}; the card "
                  f"vs a CPU copy {rel:.2e} (tol {ATTR_TOL})")
    return checkpoints


def attr_demo(root: Path, checkpoints: dict, dev, launches) -> None:
    """``cli.attributes_demo.main``: S2A on a folder of betas npz files
    with a genders YAML, A2S on a ratings database written as a plain
    pickle, with rendering; the printed ratings (to two decimals) equal
    to the S2A module's, the printed betas within 1e-5 of the A2S
    module's, one 512x512 PNG a model."""
    import pickle

    from shapy_tpu_torch.cli import attributes_demo as cli
    from shapy_tpu_torch.models.attributes.a2b import A2B
    from shapy_tpu_torch.models.attributes.b2a import B2A
    from shapy_tpu_torch.models.attributes.demo_data import DemoA2SData

    rng = np.random.default_rng(SEED + 15)
    betas = rng.normal(size=(ATTR_DEMO_FILES, 10)).astype(np.float32)
    folder = root / "demo_betas"
    folder.mkdir()
    genders = [("female", "male")[i % 2] for i in range(ATTR_DEMO_FILES)]
    for i, b in enumerate(betas):
        np.savez(folder / f"img{i:02d}.npz", betas=b)
    (root / "genders.yaml").write_text("".join(
        f"img{i:02d}: {g}\n" for i, g in enumerate(genders)))
    n = ATTR_DEMO_MODELS
    (root / "ratings").mkdir()
    with open(root / "ratings" / "modeldata_for_a2s_female.pt", "wb") as f:
        pickle.dump({"ids": [f"model_{i}" for i in range(n)],
                     "ratings": np.clip(rng.normal(3, 1, (n, 15)), 1, 5),
                     "heights": rng.uniform(1.5, 1.9, n),
                     "weight_gt": rng.uniform(50, 90, n),
                     "bust": rng.uniform(80, 100, n),
                     "waist": rng.uniform(60, 80, n),
                     "hips": rng.uniform(85, 105, n)}, f)

    ckpt = checkpoints["b2a", "female"]
    cfg = attr_config("b2a", "female", f"checkpoint_path={ckpt}",
                      f"betas_folder={folder}",
                      f"ds_genders_path={root / 'genders.yaml'}")
    rc, lines, counts = run_quietly(cli.main, cfg, str(root / "s2a"),
                                    device=dev)
    launches.update(counts)
    model = B2A.load_from_checkpoint(str(ckpt)).to(dev)
    female = [i for i, g in enumerate(genders) if g == "female"]
    pred = model.predict(betas[female])
    want = []
    for i, row in zip(female, pred):
        want += ["", f" Results for image img{i:02d}"] + [
            f"{name:20s}: {float(v):.2f}"
            for name, v in zip(model.output_names, row)]
    check(rc == 0 and lines == want, f"attributes demo S2A: rc {rc}, "
          f"{len(lines)} lines, {len(want)} expected")

    ckpt = checkpoints["a2b", "female"]
    cfg = attr_config("a2b", "female", f"checkpoint_path={ckpt}",
                      f"rating_folder={root / 'ratings'}")
    t = time.perf_counter()
    rc, lines, counts = run_quietly(
        cli.main, cfg, str(root / "a2s"),
        smpl_model_path=str(root / "no_body_models"), device=dev)
    render_s = time.perf_counter() - t
    launches.update(counts)
    model = A2B.load_from_checkpoint(str(ckpt)).to(dev)
    db = DemoA2SData(rating_folder=str(root / "ratings")).db
    pred = model.predict(model.create_input_feature_vec(db))
    text = " ".join(lines)
    heads = [f"Predicted betas for model_{i}" for i in range(n)]
    got = [np.array([float(v) for v in NUMBER_RE.findall(chunk)])
           for chunk in re.split("|".join(heads), text)[1:]]
    err = max(float(np.abs(g - w).max()) for g, w in zip(got, pred))
    check(rc == 0 and all(h in text for h in heads) and len(got) == n
          and err <= ATTR_TOL, f"attributes demo A2S: rc {rc}, betas off "
          f"by {err}")
    for i in range(n):
        png = root / "a2s" / f"model_{i}.png"
        check(png.exists() and png_size(png)[:2] == (512, 512),
              f"attributes demo A2S: {png}")
    print(f"attributes: demo S2A {len(female)} images, lines equal to the "
          f"module's; A2S {n} models, betas within {err:.2e} (tol "
          f"{ATTR_TOL}) of the module's, {n} PNGs, {render_s:.1f} s with "
          "rendering")


def attr_fit_nn(model, dev, launches) -> None:
    """``A2B.fit_nn`` (an MLP on 00_a2s's features) on the flagship's SMPL-X
    with v2v and the four measurement losses, ``ATTR_FIT_STEPS`` steps at
    the default batch: one K1 forward and one K1 backward a step (the
    prediction and the target measured in one call), nothing else; two
    K1 forwards in the validation; the loss falls. Then K1's forward and
    backward at the first step's vertices against their plain versions
    (phase 2's limits: mass / height rel 1e-5, circumferences 1e-5 m,
    plane heights 1e-6; the backward of a seeded cotangent within 1e-4 of
    the largest gradient of autograd through the plain version given the
    kernel's centroids)."""
    import torch

    from shapy_tpu_torch.measure.measurements import (
        BodyMeasurements,
        MeasurementAnchors,
        measure_plain,
        saved_centroids,
    )
    from shapy_tpu_torch.models.attributes.a2b import A2B
    from shapy_tpu_torch.models.attributes.regression_data import (
        RegressionDataset,
    )

    anchors = MeasurementAnchors.synthetic(model.faces,
                                           model.v_template.cpu().numpy())
    meas = BodyMeasurements(anchors, model.faces, 256).to(dev)
    cfg = attr_config("a2b", "female", *ATTR_FIT_OPTS, path=ATTR_FIT_CONFIG)
    a2b = A2B(cfg, body_model=model, meas_module=meas,
              generator=torch.Generator().manual_seed(SEED)).to(dev)
    db = RegressionDataset.synthetic(ds_gender="female",
                                     model_gender="female").db
    first, losses, counts = [], [], []
    measure = meas.forward_from_vertices

    def recording(vertices, use_face_subsets=True):
        if not first:
            first.append(vertices.detach().clone())
        return measure(vertices, use_face_subsets)

    meas.forward_from_vertices = recording

    def on_step(step, loss):
        losses.append(float(loss))
        counts.append(read_launches())

    torch.cuda.synchronize()
    reset_launches()
    t = time.perf_counter()
    report = a2b.fit_nn(db, meas_weights={k: 1.0 for k in MEASURED},
                        num_steps=ATTR_FIT_STEPS, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    total = read_launches()
    launches.update(total)
    del meas.forward_from_vertices
    prev = {k: 0 for k in total}
    for step, c in enumerate(counts):
        delta = {k: c[k] - prev[k] for k in c if c[k] != prev[k]}
        check(delta == {"K1_measure": 1, "K1_measure_backward": 1},
              f"fit_nn step {step} launched {delta}")
        prev = c
    val = {k: total[k] - prev[k] for k in total if total[k] != prev[k]}
    check(val == {"K1_measure": 2}, f"fit_nn validation launched {val}")
    head, tail = np.mean(losses[:5]), np.mean(losses[-5:])
    check(all(map(math.isfinite, losses)) and tail < head,
          f"fit_nn loss {head} -> {tail}")
    check(all(math.isfinite(v) for v in report["val"].values()),
          f"fit_nn report {report}")

    # The plain versions a chunk of bodies at a time (all 512 at once
    # take more than the card's 80 GB); each body's values and gradient
    # depend on its own vertices only.
    v = first[0]
    bodies = v.shape[0]
    x = v.clone().requires_grad_()
    outs = meas.measure(x, use_face_subsets=False)
    cents = saved_centroids(outs[0]).detach()
    gen = torch.Generator().manual_seed(SEED + 16)
    g = (torch.randn((bodies, 5), generator=gen).to(dev),
         torch.randn((bodies, 3), generator=gen).to(dev))
    got = torch.autograd.grad(outs, x, g)[0]
    fwd_rel = fwd_circ = fwd_h = bwd_diff = bwd_scale = 0.0
    for start in range(0, bodies, ATTR_CHECK_CHUNK):
        rows = slice(start, start + ATTR_CHECK_CHUNK)
        with torch.no_grad():
            want, want_h = measure_plain(v[rows], meas.faces, None,
                                         meas.anchors, 256, meas.density)
        val = outs[0][rows].detach()
        fwd_rel = max(fwd_rel, float(((val[:, :2] - want[:, :2]).abs()
                                      / want[:, :2].abs()).max()))
        fwd_circ = max(fwd_circ, max_err(val[:, 2:], want[:, 2:]))
        fwd_h = max(fwd_h, max_err(outs[1][rows], want_h))
        xp = v[rows].clone().requires_grad_()
        w32 = torch.autograd.grad(measure_plain(
            xp, meas.faces, None, meas.anchors, 256, meas.density,
            "reference", cents[rows]), xp, (g[0][rows], g[1][rows]))[0]
        bwd_diff = max(bwd_diff, max_err(got[rows], w32))
        bwd_scale = max(bwd_scale, float(w32.abs().max()))
    bwd = bwd_diff / bwd_scale
    check(fwd_rel <= 1e-5 and fwd_circ <= 1e-5 and fwd_h <= 1e-6,
          f"fit_nn K1 forward: {fwd_rel}, {fwd_circ}, {fwd_h}")
    check(bwd <= 1e-4, f"fit_nn K1 backward: {bwd}")
    print(f"attributes: A2B.fit_nn {ATTR_FIT_STEPS} steps (batch "
          f"{bodies // 2}, {bodies} bodies measured a step) in "
          f"{wall * 1e3:.1f} ms = {ATTR_FIT_STEPS / wall:.1f} steps/s, loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}; a step K1 1 forward 1 "
          f"backward, validation 2 forwards; val "
          + ", ".join(f"{k} {x:.3f}" for k, x in report["val"].items())
          + f"; K1 at the first step's {bodies} bodies: forward mass/height "
          f"rel {fwd_rel:.2e}, circumferences {fwd_circ:.2e} m, plane "
          f"heights {fwd_h:.2e}; backward {bwd:.2e} of the largest "
          f"(tol 1e-4); {gpu_line()}")


def _snapshot(modules) -> list:
    return [{k: t.detach().clone() for k, t in m.state_dict().items()}
            for m in modules]


def attr_evaluate_cli(root: Path, checkpoints: dict, dev, launches) -> None:
    """``cli.evaluate.main`` on phase 12's synthetic HBW tree and
    regressor, three runs: without plugins (the cold run, which caches the
    GT measurements), with the B2A and A2B plugins (``use_b2a`` /
    ``use_a2b`` and the four checkpoints in ``--exp-opts``), and without
    again. The plugin run's outputs hold ``attributes``, ``betas_ref``
    and ``v_shaped_ref``; its launches are the warm run's without
    plugins; its printed metrics bit-equal to both other runs'; its
    ``attributes`` and ``betas_ref`` against CPU copies of the plugins on
    the same betas and K1 height and mass (largest difference over the
    largest value, tol 1e-5)."""
    import torch

    from shapy_tpu_torch.cli import demo as demo_mod
    from shapy_tpu_torch.cli import evaluate as cli
    from shapy_tpu_torch.cli.demo import load_attribute_plugins
    from shapy_tpu_torch.data import build as build_mod
    from shapy_tpu_torch.data.datasets.hbw import HBWDataset
    from shapy_tpu_torch.flagship import build_flagship_body, spread_init_
    from shapy_tpu_torch.models.body.assets import make_synthetic_model_data
    from shapy_tpu_torch.models.body.model import SMPLX
    from shapy_tpu_torch.models.heads.regressor import build_body_head
    from shapy_tpu_torch.utils.config import load_config
    from shapy_tpu_torch.utils.device import full_f32_matmul

    repo = Path(__file__).resolve().parent
    hbw, p2p = root / "HBW", root / "p2p.pkl"
    write_hbw_tree(hbw, SMPLX(make_synthetic_model_data(
        "smplx", subdivisions=5, exact_counts=True)), p2p)
    opts = [f"datasets.shape.hbw.data_folder={hbw}",
            f"datasets.batch_size={CLI_B}", "datasets.pose_shape_ratio=0.0",
            f"datasets.shape.transforms.crop_size={CROP}",
            "evaluation.body.v2v_t=['scale','translation']",
            f"evaluation.body.p2p_t.input_point_regressor_path={p2p}"]
    plugins = [f"network.smplx.use_{k}=True" for k in ATTR_CONFIGS] + [
        f"network.smplx.{k}_{g}s_checkpoint={checkpoints[k, g]}"
        for k in ATTR_CONFIGS for g in ATTR_GENDERS]
    base, built, seen = [], [], []

    def builder(exp_cfg, checkpoint_path="", device="cuda"):
        if not base:
            body, meas = build_flagship_body(subdivisions=5,
                                             exact_counts=True)
            base.append(spread_init_(
                build_body_head(exp_cfg, body_model=body, measurements=meas),
                seed=SEED, beta_scale=0.25))
        reg = copy.deepcopy(base[0]).to(device).attach_plugins_(
            *load_attribute_plugins(exp_cfg["network"]["smplx"]))
        apply = reg.apply

        def recorded(images, batch=None, **kw):
            out = apply(images, batch=batch, **kw)
            last = out["stage_02"]
            seen[-1].append({
                "gender": batch["gender"].clone(),
                "betas": last["betas"].detach().clone(),
                "height": out["measurements"]["height"].clone(),
                "mass": out["measurements"]["mass"].clone(),
                "attributes": out.get("attributes"),
                "betas_ref": last.get("betas_ref"),
                "v_shaped_ref": "v_shaped_ref" in last})
            return out

        reg.apply = recorded
        built.append(reg)
        return reg

    class HBWWithMeasurements(HBWDataset):
        def __init__(self, **kwargs):
            reg = built[-1]
            super().__init__(measurements_module=reg.body_measurements,
                             body_model_faces=reg.model.faces, **kwargs)

    build_mod._populate_registry()
    saved = (demo_mod.build_demo_regressor, build_mod.DATASET_REGISTRY["hbw"])
    demo_mod.build_demo_regressor = builder
    build_mod.DATASET_REGISTRY["hbw"] = HBWWithMeasurements
    runs = []
    try:
        for i, extra in enumerate(([], plugins, [])):
            cfg = load_config({}, [str(repo / "configs" /
                                       "shapy_eval_shape.yaml")],
                              opts + extra)
            seen.append([])
            rc, lines, counts = run_quietly(
                cli.main, cfg, output_folder=str(root / f"eval{i}"),
                device=dev)
            launches.update(counts)
            check(rc == 0, f"evaluate with plugins: run {i} rc {rc}")
            runs.append((lines, counts))
    finally:
        demo_mod.build_demo_regressor, build_mod.DATASET_REGISTRY["hbw"] = \
            saved
    (cold, _), (lines, counts), (warm, warm_counts) = runs
    check(lines == cold == warm and len(lines) > 5,
          "evaluate with plugins: the printed metrics differ")
    check(counts == warm_counts, f"evaluate with plugins: launches {counts}"
          f" against {warm_counts} without")
    reg = built[1]
    cpu = {k: {g: copy.deepcopy(m).cpu() for g, m in models.items()}
           for k, models in (("b2a", reg.b2a_models),
                             ("a2b", reg.a2b_models))}
    errs = {"attributes": 0.0, "betas_ref": 0.0}
    for rec in seen[1]:
        check(rec["attributes"] is not None and rec["betas_ref"] is not None
              and rec["v_shaped_ref"], "evaluate with plugins: outputs")
        gender = rec["gender"].cpu()
        check(set(gender.tolist()) <= {1, 2}, f"genders {gender.tolist()}")
        with torch.no_grad(), full_f32_matmul():
            betas = rec["betas"].cpu()
            want = {"attributes": reg._by_gender(
                gender, *(cpu["b2a"][g](betas) for g in ("male", "female")))}
            refs = []
            for g, height, weight in (("male", 1.71, 71.0),
                                      ("female", 1.59, 62.0)):
                m = cpu["a2b"][g]
                B = len(gender)
                refs.append(m.a2b(m.create_input_feature_vec_tensor({
                    "rating": torch.zeros(B, 15),
                    "height_gt": torch.full((B,), height),
                    "weight_gt": torch.full((B,), weight),
                    "height_bg": rec["height"].cpu(),
                    "weight_bg": rec["mass"].cpu()})))
            want["betas_ref"] = reg._by_gender(gender, *refs)
        for k, w in want.items():
            errs[k] = max(errs[k], float((rec[k].cpu() - w).abs().max()
                                         / max(1.0, float(w.abs().max()))))
    check(max(errs.values()) <= ATTR_TOL, f"evaluate with plugins: the "
          f"plugins' outputs off their CPU copies: {errs}")
    print(f"attributes: evaluate CLI with B2A and A2B, {len(seen[1])} "
          f"batches: printed metrics bit-equal to the runs without "
          f"plugins, launches the same ({ {k: n for k, n in counts.items() if n} }); "
          f"attributes / betas_ref against CPU copies "
          f"{errs['attributes']:.2e} / {errs['betas_ref']:.2e} (tol "
          f"{ATTR_TOL})")


def write_agencies(root: Path, rng) -> None:
    """A synthetic model-agency archive (the shape stream of
    ``configs/train_shapy.yaml``): ``ATTR_AGENCY_MODELS`` models of
    alternating gender with height, chest, waist, hips and 15 attribute
    ratings, ``ATTR_AGENCY_IMAGES`` 320x320 PPM images each with 25 body
    keypoints inside the image, all in the train split."""
    import json

    annotations = {}
    for i in range(ATTR_AGENCY_MODELS):
        key = f"model_{i:03d}"
        images = {}
        for j in range(ATTR_AGENCY_IMAGES):
            fname = f"img{j}.ppm"
            write_ppm(root / "agency" / "images" / key / fname,
                      rng.integers(0, 256, (TRAIN_CLI_IMAGE, TRAIN_CLI_IMAGE,
                                            3), dtype=np.uint8))
            kp = np.stack([rng.uniform(0.3, 0.7, 25) * TRAIN_CLI_IMAGE,
                           rng.uniform(0.15, 0.85, 25) * TRAIN_CLI_IMAGE,
                           np.full(25, 0.9)], -1)
            images[fname] = kp.tolist()
        annotations[key] = {
            "agency": "agency", "gender": ("female", "male")[i % 2],
            "height": float(rng.uniform(1.55, 1.9)),
            "chest": float(rng.uniform(0.8, 1.0)),
            "waist": float(rng.uniform(0.6, 0.8)),
            "hips": float(rng.uniform(0.85, 1.05)),
            "attributes": rng.uniform(1, 5, 15).round(2).tolist(),
            "images": images}
    (root / "annotations.json").write_text(json.dumps(annotations))
    (root / "splits.json").write_text(json.dumps(
        {"train": sorted(annotations)}))


def attr_train_cli(root: Path, checkpoints: dict, train_cli_launches: dict,
                   dev, launches) -> None:
    """``cli.train.main`` with ``use_b2a`` and the B2A checkpoints, on phase
    13's pose archives and a synthetic model-agency archive (the config's
    own shape stream, which carries attribute ratings),
    ``ATTR_TRAIN_STEPS`` steps: an ``attributes`` loss finite and not
    zero, the B2A weights bit-unchanged, and every kernel's launches a
    step those of phase 13's steps."""
    import ast

    from shapy_tpu_torch.cli import demo as demo_mod
    from shapy_tpu_torch.cli import train as cli
    from shapy_tpu_torch.cli.demo import load_attribute_plugins
    from shapy_tpu_torch.data.synthetic import (
        generate_parametric_fits,
        register_synthetic_datasets,
    )
    from shapy_tpu_torch.flagship import build_flagship_body
    from shapy_tpu_torch.models.heads.regressor import build_body_head

    model, meas = build_flagship_body(subdivisions=5, exact_counts=True)
    body = copy.deepcopy(model).to(dev)
    pose = [a for a in TRAIN_CLI_ARCHIVES if a[0].startswith("pose")]
    for name, n, seed in pose:
        generate_parametric_fits(
            str(root / name), n, model=body, seed=seed, device=dev,
            image_size=TRAIN_CLI_IMAGE, betas_std=1.0, pose_std=0.25)
    register_synthetic_datasets([a[0] for a in pose])
    del body
    write_agencies(root / "agencies", np.random.default_rng(SEED + 17))
    built, before = [], []

    def builder(exp_cfg, checkpoint_path="", device="cuda"):
        b2a, a2b = load_attribute_plugins(exp_cfg["network"]["smplx"])
        reg = build_body_head(exp_cfg, body_model=copy.deepcopy(model),
                              measurements=copy.deepcopy(meas),
                              b2a_models=b2a, a2b_models=a2b).to(device)
        built.append(reg)
        before.append(_snapshot(reg._plugins()))
        return reg

    cfg = train_cli_config(root, 0, [
        "datasets.shape.splits.train=['model_agencies']",
        f"datasets.shape.model_agencies.data_folder={root / 'agencies'}",
        "network.smplx.use_b2a=True", "checkpoint_steps=100",
        *(f"network.smplx.b2a_{g}s_checkpoint={checkpoints['b2a', g]}"
          for g in ATTR_GENDERS)])
    saved = demo_mod.build_demo_regressor
    demo_mod.build_demo_regressor = builder
    try:
        rc, lines, counts = run_quietly(
            cli.main, cfg, output_folder=str(root / "train"),
            num_steps=ATTR_TRAIN_STEPS, device=dev)
    finally:
        demo_mod.build_demo_regressor = saved
    launches.update(counts)
    check(rc == 0 and len(built) == 1, f"train with B2A: rc {rc}")
    reg = built[0]
    check(set(reg.b2a_models) == set(ATTR_GENDERS),
          f"train with B2A: plugins {sorted(reg.b2a_models)}")
    losses = ast.literal_eval(lines[0])
    check(math.isfinite(losses.get("attributes", math.nan))
          and losses["attributes"] != 0, f"train with B2A: losses {losses}")
    differ = _equal_trees(before[0], _snapshot(reg._plugins()))
    check(not differ, f"train with B2A: the B2A weights changed: {differ}")
    per_step = {k: n / ATTR_TRAIN_STEPS for k, n in counts.items()}
    want = {k: n / TRAIN_CLI_STEPS for k, n in train_cli_launches.items()}
    check(per_step == want, f"train with B2A: launches a step {per_step}, "
          f"phase 13 {want}")
    print(f"attributes: train CLI with B2A, {ATTR_TRAIN_STEPS} steps: "
          f"losses {losses}; B2A weights bit-unchanged; launches a step "
          f"those of phase 13")


def attributes(dev, train_cli_launches: dict):
    """Phase 15: the attribute models, their two CLIs and the regressor's
    plugins on the card (see the module docstring). Returns the launches
    of the whole phase."""
    import tempfile

    import torch

    from shapy_tpu_torch.flagship import build_flagship_body

    launches = collections.Counter()
    spans = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        spans[name] = round(time.perf_counter() - t, 2)
        return out

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        checkpoints = timed("fit_regression", attr_fit_regression, root, dev,
                            launches)
        timed("demo", attr_demo, root, checkpoints, dev, launches)
        body = build_flagship_body(subdivisions=5, exact_counts=True)[0]
        timed("fit_nn", attr_fit_nn, body.to(dev), dev, launches)
        timed("evaluate", attr_evaluate_cli, root, checkpoints, dev,
              launches)
        timed("train", attr_train_cli, root, checkpoints, train_cli_launches,
              dev, launches)
    print(f"attributes: phase 15 seconds {spans}, launches "
          f"{ {k: n for k, n in launches.items() if n} }; {gpu_line()}")
    return {name: launches[name] for name, *_ in kernels()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from shapy_tpu_torch.flagship import (
        build_flagship,
        spread_init_,
        synthetic_eval_data,
        synthetic_requests,
    )

    print(gpu_line())
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()

    def stamp(what: str) -> None:
        print(f"[{time.perf_counter() - t0:.1f} s] {what}", flush=True)

    def build(kernel):
        t = time.perf_counter()
        kernel.build()
        return kernel.source, time.perf_counter() - t, kernel.build_log

    with ThreadPoolExecutor(len(sources())) as pool:
        for name, secs, log in pool.map(build, sources()):
            usage = [ln.split("ptxas info    :")[-1].strip()
                     for ln in log.splitlines()
                     if "registers" in ln or "stack frame" in ln]
            print(f"built {name} in {secs:.1f} s; "
                  f"{' | '.join(usage) or 'cached build'}")
            if name == "conv.cu":  # K5-conv's, K5-dgrad's, K5-wgrad's
                for line in ptxas_report(log, "wgmma"):
                    print(f"  {line}")
                for line in ptxas_report(log, "conv_reduce"):
                    print(f"  {line}")
                for line in ptxas_report(log, "stem7"):  # K10's
                    print(f"  {line}")
                print(f"  dynamic shared memory a block, blocks an SM: "
                      f"{wgmma_smem()}")
            if name == "batch_norm.cu":  # K4's kernels
                for marker in ("fwd_", "bwd_"):
                    for line in ptxas_report(log, marker):
                        print(f"  {line}")

    base = build_flagship(subdivisions=5, exact_counts=True, device="cpu",
                          seed=SEED)
    spread_init_(base, seed=SEED, beta_scale=0.25)
    regressor = copy.deepcopy(base).to(dev).prepare_for_eval_(torch.bfloat16)
    images, affines = synthetic_requests(B, IMAGE_H, IMAGE_W, CROP, SEED)
    requests = (torch.from_numpy(images).to(dev),
                torch.from_numpy(affines).to(dev))
    eval_data = synthetic_eval_data(regressor, EVAL_BATCHES, B, IMAGE_H,
                                    IMAGE_W, CROP, SEED + 5, P2P_POINTS)

    stamp("phase 2")
    checked = check_kernels(regressor, requests, eval_data, dev)
    checked.update(check_k2(requests, dev))
    checked.update(check_k3(regressor.model, dev))
    checked.update(check_k3chain(regressor.model, dev))
    checked.update(check_train_kernels(regressor.model, dev))
    anchors = regressor.body_measurements.anchors
    checked.update(check_measure_kernels(regressor.model, anchors, dev))
    checked["K1_measure"]["cases"] = checked.pop("K1_measure_cases")
    checked.update(check_aos_kernel(regressor.model, anchors, dev))
    convs, fuses = backbone_calls(regressor.backbone, requests)
    checked.update(check_conv_kernels(convs))
    checked["K5_conv"]["routes"] = check_conv_routes(regressor.backbone,
                                                     requests, convs)
    checked.update(check_fuse_kernel(regressor, fuses))
    del convs, fuses
    checked["K5_conv"]["backbone"] = check_backbone_routes(regressor,
                                                           requests)
    stamp("phase 2: K5 backward, K4 replay")
    convs, fuses, bns, _ = train_step_calls(base, dev)
    checked["K5_conv"]["train_forward"] = check_train_forward_replay(convs)
    checked.update(check_conv_backward_kernels(convs))
    checked.update(check_fuse_backward_kernel(fuses))
    # K4: the step's replays are the entries' times, the stem and stage-4
    # cases beside them.
    checked["K4_bn_forward"] = dict(
        check_bn_forward_replay(bns),
        cases=checked["K4_bn_forward"]["cases"])
    checked["K4_bn_backward"] = dict(
        check_bn_backward_replay(bns),
        cases=checked["K4_bn_backward"]["cases"])
    del convs, fuses, bns
    checked["K5_wgrad"]["backbone"] = check_backbone_train_routes(base, dev)
    stamp("phase 2: contact")
    bodies = contact_bodies(regressor.model, dev)
    contact_checked, k6_plain = check_contact_kernels(
        bodies, regressor.body_measurements, dev)
    checked.update(contact_checked)
    stamp("phase 3")
    serve_launches, serve_rate = serve(regressor, requests)
    stamp("phase 4")
    parity(base, tuple(t.cpu() for t in requests), eval_data, dev)
    train_parity(base, dev)
    stamp("phase 5")
    eval_launches, eval_rate = evaluate(regressor, eval_data, serve_rate)
    stamp("phase 6")
    score_launches = score(regressor, eval_data, dev)
    stamp("phase 7")
    train_launches, _ = train(base, dev)
    stamp("phase 8")
    fit_launches = fit(regressor.model, anchors, dev)
    stamp("phase 9")
    contact_launches = contact(bodies, eval_data,
                               regressor.body_measurements, k6_plain, dev)
    stamp("phase 10")
    train_resume(base, dev)
    stamp("phase 11")
    (resnet_checked, resnet_train, resnet_serve, resnet_eval,
     resnet_summary) = resnet(dev, eval_data)
    checked.update(resnet_checked)
    stamp("phase 12")
    cli_launches, cli_summary = evaluate_cli(dev, eval_rate)
    stamp("phase 13")
    train_cli_launches, train_cli_summary, k2_noise = train_cli(
        dev, train_launches)
    checked["K2_noise"] = k2_noise
    stamp("phase 14")
    demo_launches, demo_summary = demo_cli(dev, regressor, eval_data,
                                           eval_launches)
    stamp("phase 15")
    attr_launches = attributes(dev, train_cli_launches)
    stamp("done")

    entries = []
    for name, _, _, source, replaces in kernels():
        c = checked[name]
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            # training (phase 7) for its kernels (all five K5 among
            # them), the batch-32 fit of phase 8 for K1's backward and
            # K1-exact, the contact phase (9) for its kernels, the scorer
            # (phase 6) for K1-AoS's points and their backward,
            # evaluation (phase 5) for the others (K2, K8a, K8b)
            "launches": (resnet_train[name] if name in RESNET_KERNELS
                         else train_cli_launches[name]
                         if name == "K2_noise"
                         else train_launches[name] if name in TRAIN_KERNELS
                         else contact_launches[name]
                         if name in CONTACT_KERNELS
                         else score_launches[name] if name.startswith(
                             "K1aos_points")
                         else fit_launches.get(name, eval_launches[name])),
            "launches_score": score_launches[name],
            "launches_contact": contact_launches[name],
            "launches_train": (train_cli_launches[name]
                               if name == "K2_noise"
                               else train_launches[name]),
            "launches_train_cli": train_cli_launches[name],
            "launches_fit": fit_launches.get(name, 0),
            "launches_eval": eval_launches[name],
            "launches_serve": serve_launches[name],
            "launches_resnet50_train": resnet_train[name],
            "launches_resnet50_serve": resnet_serve[name],
            "launches_resnet50_eval": resnet_eval[name],
            "launches_cli": cli_launches[name],
            "launches_demo": demo_launches[name],
            "launches_attributes": attr_launches[name],
            **{k: c[k] for k in ("max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by")},
            # K4: F.batch_norm(training=True); K5-conv: F.conv2d (cuDNN);
            # K9: torch.cdist + min; no single PyTorch call computes any
            # of the others
            "library_ms": c.get("library_ms")}
        for key in ("library_call", "box_pairs", "hits", "timed_as",
                    "source_pixels_read",
                    "f32_max_rel_err", "backbone", "cases", "culling",
                    "device_ms", "prologue_share", "device_kernels",
                    "live_pairs", "skipped_pairs"):
            if key in c:
                entry[key] = c[key]
        entries.append(entry)
        check(all(math.isfinite(c[k]) for k in ("ms", "plain_ms",
                                                "bound_ms")), "timing")
    print(f"ResNet: {json.dumps(resnet_summary)}")
    print(f"evaluate CLI: {json.dumps(cli_summary)}")
    print(f"train CLI: {json.dumps(train_cli_summary)}")
    print(f"demo CLI: {json.dumps(demo_summary)}")
    print(gpu_line())
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
