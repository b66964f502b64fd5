"""End-to-end checks of the PyTorch port on one CUDA card:
``python3 chip_smoke.py``.

Drives ``deepviewagg_tpu_torch`` end to end on the card and fails (non-zero
exit) on any fault.  It checks; it does not time: the port's speed is
measured by ``benchmark/`` (``python3 -m benchmark.run``) in the cells of
``BENCHMARK.json``.  The hand-written kernels' own checks on the card are
pytest tests with the marker ``card`` (``CARD_TESTS``), which phase 2 runs
and which also run alone (``pytest --noconftest -m card <files>``).  Phases:

  0. card     name and power limit; TF32 off for matmuls and convolutions
  1. build    compile every hand-written kernel (one nvcc per source, in
              parallel) from the checkout's ``csrc/``, and the native host
              builders (``native/*.cpp``, g++) beside them
  2. kernels  the ``card`` tests of ``CARD_TESTS``, by pytest in this
              process: each hand-written kernel against its plain version
              (the segment kernels on the flagship's 6 + 5 calls, empty,
              masked and all-masked segments, forced ties and the tile
              edges; the Lovasz scan's weights bit for bit and its
              products within 1e-6 at the PTv3 cell's [13, 1,228,800],
              the loss's gradient against the row-major formula; the kNN
              kernel's tables equal to the brute force's, ties included);
              every selected test passes and none skips
  3. serving  the flagship model (Res16UNet34 + ResNet18-PPM branch, random
              weights from a seed) answers three requests of the benchmark's
              shape (4 samples, density 260, 12 images of 256 x 128), each
              preprocessed on the card: logits finite, 6 forward launches of
              the segment kernel each and no backward launch
  4. card vs CPU  one smaller request through the same weights on the card
              and on the CPU (plain versions): logits within 3e-2 relative,
              argmax agreement >= 99%
  4c. cameras card vs CPU  the four camera models (the 2048 x 1024
              panorama, the ScanNet 640 x 480 pinhole, KITTI-360's 1408 x
              376 perspective and 1400 x 1400 MEI fisheye) over one
              synthetic room of about 10^6 points: pixel coordinates within
              1e-2 px, the validity masks and each model's ``splat_zbuffer``
              winner map agreeing on >= 99.9% of the points / seen pixels;
              one Biasutti mask (the panorama, X-wrapped, every 50th point)
              and one depth-map mask (the pinhole against the card's
              z-buffer depths) to the same share
  6. training the flagship model in training mode takes ten optimizer steps
              (SGD + momentum 0.9, LR 0.1, weight decay 1e-4, clip 10) on
              the benchmark request, each through 6 + 5 launches; loss and
              gradient norm stay finite, the loss falls, every parameter and
              every running mean moves; then the trained model serves one
              request in eval mode, and a model with ``remat_tower=False``
              takes six steps from the same weights (the same first loss
              within 2e-3)
  7. card vs CPU, one train step  from identical weights on the smaller
              request: loss within 1e-2 relative, gradient norm within 3e-2;
              then the same check on the step's other paths: 7a head
              dropout 0.5 (one dropout generator on both), 7b Adam, 7c
              AdamW (each one update and the step after it), 7d a frozen
              tower (its parameters do not move), 7e gradient accumulation
              over 2 (nothing moves until the second mini-step), 7f float32
              tower activations, 7g float32 everywhere (every convolution's
              operands too); every loss within 1e-2, the gradient norm within 3e-2
              at the start weights and 1e-1 after an update; 7e and 7f
              compare both devices' max routing (ties, near ties, pairs
              routed apart) and run the CPU once more with the card's
              routing imposed (gaps logged), and split the update's
              card-vs-CPU difference by parameter (as phase 7 and 8e do);
              7g (float32 everywhere) holds the loss within 1e-4, the
              gradient norm within 2e-3 and the whole update within 5e-2,
              and runs the CPU once more on half its threads (the same
              step's spread on one device); 7h logs the tower alone, card
              against CPU, by layout and remat mode
  8. recipe request  the crop-ladder batch at the S3DIS recipe's 2D size
              (``recipe_batch()``: 2 samples, 4 panoramas of 1024 x 512 in
              the ladder's largest bucket, about 934k pixel rows; three
              smaller buckets with one zero image and 256 masked rows each),
              through the same flagship weights, nothing cut:
              8a  every sorted-segment forward and backward call of one
                  recipe forward / train step (one atomic pool per bucket,
                  three of them with every row masked and every segment
                  empty, then the view pool's) held against its plain
                  version (max exact, sum within 1e-5, backward bit-equal)
              8b  the largest bucket's shape takes the pixel gather's
                  upsample route
              8c  serving: four forwards in eval mode, the launch counts
                  zeroed before and read after
              8d  training: eight optimizer steps with ``remat_tower='convs'``,
                  the loss must fall and every parameter and running mean
                  move; then five steps each with ``False`` and ``True``
                  from the same weights: the first two losses equal across
                  the three modes within 2e-3
              8e  card vs CPU on the check request as a ladder batch (ladder
                  (64, 32), (128, 64)): logits and one train step to the
                  bounds of phases 4 and 7
  9. loop     the experiment loop, through ``deepviewagg_tpu_torch.cli.
              train.main`` in this process (data and run dirs under a
              temporary directory, deleted afterwards); every train step
              checked (finite loss, 6 + 5 segment launches):
              9a  ``conf/synthetic.yaml`` (the Quick start: Res16UNet14-L1
                  group-4 branch, 128 x 64 images, batch 2) for two epochs
                  with an eval each: ``metrics.jsonl`` holds two records
                  with ``val_miou``, ``latest`` and ``best_val_miou`` exist,
                  every parameter is on the card and moved, both kernels
                  launched; then ``training.resume=true`` for one epoch:
                  the restored model and optimizer equal the saved ones bit
                  for bit before the first resumed step, and the step count
                  continues from the saved one
              9b  ``conf/s3dis_benchmark.yaml`` with ``data.dataset=
                  synthetic`` (``RECIPE_LOOP``): the recipe's model at its
                  published widths (deep-stem 512-d L4 tower, group-4 pool,
                  concat before the stem, trained from scratch), batch 4,
                  4 image slots of 1024 x 512, 2 m spheres at 5 cm, one
                  epoch of 48 spheres with an eval, with the recipe's
                  augmentations (centre roll, flip 0.5, mapping jitter 0.02,
                  colour jitter (0.6, 0.6, 0.7): each must be called, on
                  raw cached images) and the raw clouds kept in the cache;
                  then every sorted-segment forward and backward call of the
                  first train batch (the atomic pool and the view pool at
                  512 channels) held against its plain version
              9c  ``cli.eval.main`` on 9b's run (``--weight best_val_miou
                  --voting_runs 2 --full_res``): 6 forward and no backward
                  launches per eval batch; finite votes; test, vote and
                  full-resolution mIoU; one prediction per raw point; the
                  model has no dropout, so the second voting run's logits
                  equal the first's bit for bit and the votes double; then
                  every sorted-segment call of one forward of the first eval
                  batch (eval buckets, images by coverage, centre roll) held
                  against its plain version
              9c' MC dropout at the library level: 9a's run, its model
                  built from ``dataclasses.replace(spec, head_dropout=0.5)``
                  (the zoo drops that override, as the JAX package's does)
                  with the run's weights, three voting runs of
                  ``cli.eval.vote`` on one room: 6 + 0 launches a batch, the
                  runs differ, are finite, and the same seed repeats them
                  bit for bit
              9c'' 9a's run evaluated on the card and on the CPU, one room:
                  argmax agreement >= 99%, metrics within 1e-2 (fractions)
              9d  ``cli.predict.main`` with a 3D-only Res16UNet34 trained by
                  ``cli.train`` on 9b's rooms at 5 cm (one epoch of 8
                  spheres), on one of those rooms' raw cloud (about 66k
                  points) as ``.npz`` and as ``.ply``: equal labels, one per
                  voxel
              9e  the S3DIS loader from a 2D-3D-S raw layout written here
                  (Area_1 with two rooms, Area_5 with one, three panoramas
                  of 2048 x 1024 a room): ``cli.train`` with
                  ``conf/s3dis_benchmark.yaml`` for one epoch and an eval
                  (exact mappings, no pixel on the static band; the four
                  augmentations called; the first train batch's segment
                  calls held against their plain versions), one exact
                  z-buffer card vs CPU (>= 99.9% of the seen pixels), then
                  ``cli.eval --voting_runs 2 --full_res``: 6 + 0 launches a
                  batch, votes doubled, one prediction per raw point of
                  Area_5, and the first eval batch's segment calls held
                  against their plain versions
              9f  the ScanNet loader from a ScanNet v2 layout written here
                  (``SCANNET_SCANS``: three train scans and one val scan,
                  rooms of 5 x 4 x 2.6 m with about 10^5 vertices and NYU40
                  labels, 240 poses and 12 JPEG frames of 640 x 480 a scan,
                  written by the port's ``write_jpeg``): ``cli.train`` with
                  ``conf/scannet_benchmark.yaml`` (the recipe's model at its
                  published widths, batch 4, 6 slots of 320 x 240) for one
                  epoch of 24 spheres, 6 + 5 launches a step, the first
                  train batch's segment calls held against their plain
                  versions; then ``cli.eval --voting_runs 2 --submission``:
                  6 + 0 launches a batch, votes doubled, one ``<scan>.txt``
                  for the val scan with one benchmark NYU40 id per cached
                  voxel, and the first eval batch's segment calls held
              9g  the KITTI-360 loader (``loop_kitti360``, see
                  ``KITTI360_LOOP``)
              9h  the paper's other model families on 9e's layout
                  (``FAMILY_LOOP``, ``FAMILY_MODELS``): ``cli.train`` and
                  ``cli.eval --voting_runs 2`` of the light no3d model
                  (``Res16UNet21-15_light`` with the view-level loss: the
                  view loss in every step's loss, unseen points out of it,
                  3 + 2 launches a step; the eval's propagation onto the
                  first batch's unseen points held against a brute-force
                  1-NN on the CPU) and of ``Res16UNet34-LateFeatureFusion``
                  (6 + 5); then, on the light run's first batch, a forward
                  and two train steps of the late logit, two no3d, qkv,
                  heuristic, mean and min-max-diff models with their launch
                  counts asserted; every segment call of each model's first
                  forward and backward held against its plain version
              9i  pretrained BatchNorm towers and the bottleneck / SE nets
                  on 9e's layout (``loop_pretrained``, ``PRETRAINED_LOOP``,
                  ``SE_MODELS``): (a) ``cli.train`` of the S3DIS recipe with
                  ``model.tower_weights`` a random-weight MIT-semseg
                  deep-stem checkpoint written here (its loaded parameters
                  positive, 6 + 5 launches a step), the checkpoint's tower
                  card vs CPU on the first batch's images (float32 within
                  1e-4, bf16 within 3e-2), every segment call of the first
                  train batch against plain, the running statistics after
                  one step equal across the three remat modes, ``cli.eval
                  --voting_runs 2`` (6 + 0 a batch, votes doubled, the first
                  eval batch's calls against plain), then the run with
                  ``model.tower_frozen=true`` (6 + 4 a step, the tower
                  bit-equal to the checkpoint after it); (b) the Cityscapes
                  PointPyramid with a Cityscapes-layout checkpoint: five
                  truncations loaded, a forward and a step on (a)'s first
                  batch (30 + 25); (c) ``cli.train`` of ``SERes16UNet34``
                  (46 + 23 a step: 2 + 1 per squeeze-excitation block) and
                  ``cli.predict`` on Area_5's room (one label per voxel),
                  then a forward and two steps of ``Res16UNet50``,
                  ``Res16UNet101``, ``SERes16UNet50`` and
                  ``Res16UNet50-L4-early`` at the presets' widths, every
                  segment call of each first forward and backward against
                  plain
              9j  the reference-config path on 9e's layout
                  (``loop_reference``, ``REF_ENTRIES``): ``cli.preprocess``
                  in two shards, each cache byte-equal (else array-equal) to
                  9e's in-line one; a conf tree in the upstream's YAML DSL
                  written here, the flagship entry equal to its zoo spec but
                  ``drop_hard``; ``cli.train`` (4 steps, an eval) and
                  ``cli.eval --voting_runs 2`` through
                  ``model.name=ref:sparseconv3d/<entry>`` and
                  ``data.ref=s3disfused-sparse`` of (a) a shared trunk (15 +
                  10 launches a step), (b) tower reuse (18 + 15) and (c) the
                  raw-RGB branch on the ingested crop ladder (one atomic pool
                  per bucket + 2, no backward), every segment call of each
                  first forward and backward against plain; (a) card vs CPU
                  at phases 4 / 7's bounds and in float32 at 7g's; then
                  ``cli.scale_rehearsal`` at its defaults (one grid kNN)
  10. parallel  data and view parallelism (``deepviewagg_tpu_torch/
              parallel/``), the flagship at full width:
              10a NCCL in this process at world 1 (``torch.cuda.
                  device_count()`` is 1 on a one-card machine, and NCCL
                  refuses two ranks on one card): ``data_parallel_step``
                  on the bench request against the plain step from the
                  same weights (the loss equal, the update within the
                  plain step's own run-to-run gap), 6 + 5 launches, every
                  segment call of that step held against its plain version;
                  the collectives' NCCL paths; then ``cli.train`` with
                  ``training.data_parallel=true`` on 9e's layout (4 steps
                  and an eval), resumed for one step, the restore bit-equal
              10b two gloo ranks in spawned processes, the model on the
                  card, float32 everywhere at 7g's bounds: data parallel on
                  the bench request and a variant of it (the same voxels,
                  other labels, colours and images) against one process on
                  their union, both ranks bit-equal; the batches swapped
                  (the loss within 1e-6); view parallel 1 x 2 against one
                  process on the bench request; which collectives gloo runs
                  on CUDA tensors
  11. tasks   the non-segmentation tasks through ``deepviewagg_tpu_torch.
              cli.train_task.main`` at ``scripts/train_task.py``'s settings
              (procedural data, ``TASK_BATCHES`` batches of one epoch):
              11a classification (``SparseConv3dCls``, Res16UNet14, 1024
                  points a shape, batch 2), detection (``VoteNetDet``, 4096
                  points), panoptic (``PanopticSeg``, Res16UNet14, voxel
                  0.15, batch 2) and registration (``RegistrationNet``,
                  ``Res16UNetTest``): every step finite and through its
                  launches (classification 3 + 2: the global mean pool's
                  sum and count and the max pool forward, the sum and the
                  max backward; the others none)
              11b every segment call of one classification step held
                  against its plain version
              11c the first step of each task on the card and on the CPU
                  from the same weights and batch: with bf16 conv operands
                  the loss within 1e-2 and the gradient norm within 3e-2
                  (phase 7's bounds), with float32 everywhere within 7g's
                  1e-4 and 2e-3; registration's gradient norm is logged,
                  not held (``TASK_GRAD_NORM_HELD``)
  12. backbones  the point backbones (``nn/pointnet.py``, ``pvcnn.py``,
              ``kpconv.py``, ``rsconv.py``, ``pointcnn.py``, ``ppnet.py``,
              ``randlanet.py``) at their default widths, random weights from
              a seed (see BACKBONE_*):
              12a each model (PointNet segmentation and classification and
                  PVCNN on 8 collated samples of 4096 points, the others on
                  one-sample graphs of 16,384 points) takes one eval-mode
                  forward and six Adam steps; losses finite, the segment
                  launches of the forward and of every step asserted
                  (PointNet 3 + 3 a step, PVCNN 6 + 2, the others none)
              12b every segment call of one train step of PointNet (both
                  heads) and PVCNN held against its plain version
              12c the first step of each model on the card and on the CPU
                  from the same weights and batch: models with bf16
                  operands (KPConv, PointCNN, PVCNN) within phase 7's
                  bounds, the float32 ones within 7g's
  13. native  the native host builders, the viewer's demo and the kNN
              transforms:
              13a the UNet graph of 9b's first train batch (every level and
                  kernel map) by the native builders and by their numpy
                  versions, byte-equal; the same for ``unique_coords`` /
                  ``query_coords`` on 9e's Area_1 raw cloud
              13b the scale rehearsal's cloud: the host's grid kNN against
                  the card's brute force at the JAX package's bounds, then
                  ``pca_features`` through the host path (one grid kNN)
              13c ``cli.demo_synthetic`` on the card: the PLY and the HTML,
                  the viewer's data and panels, 6 + 5 launches a step and 6
                  an eval forward, every segment call of its first batch
                  against plain
              13d ``RandomWalkDropout`` then ``DensityFilter`` on a sphere of
                  9e's voxels, card against CPU: equal clouds

The last line of standard output is ``{"ok": true, "device": {...}}``.
Needs a CUDA card, ``nvcc``, ``g++`` and the repository checkout.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
sys.path[:0] = [str(REPO), str(REPO / "tests")]

from deepviewagg_tpu_torch.data.collate import batch_to_torch  # noqa: E402
from deepviewagg_tpu_torch.data.toy import (  # noqa: E402
    flagship_spec, recipe_batch, toy_batch)
from deepviewagg_tpu_torch.models.losses import segmentation_loss  # noqa: E402
from deepviewagg_tpu_torch.models.segmentation import MultimodalSeg  # noqa: E402
from deepviewagg_tpu_torch.modules import gather as pixel_gather  # noqa: E402
from deepviewagg_tpu_torch.modules.image_encoders import (  # noqa: E402
    f32_convs, run_tower)
from deepviewagg_tpu_torch.nn.norm import MaskedBatchNorm  # noqa: E402
from deepviewagg_tpu_torch.ops import segment as seg  # noqa: E402
from deepviewagg_tpu_torch.train.optimizers import (  # noqa: E402
    make_optimizer, make_schedule)
from deepviewagg_tpu_torch.train.step import (  # noqa: E402
    TrainState, make_train_step)
from deepviewagg_tpu_torch.utils import cuda_build  # noqa: E402
from torch_port_util import (  # noqa: E402
    BACKWARD_LAUNCHES, FORWARD_LAUNCHES, SERVE_REQUEST, check_bwd_call,
    check_call, record_backward_calls, record_segment_calls, rel_err)

# the hand-written kernels' card tests (phase 2)
CARD_TESTS = ("tests/test_torch_port_segment_card.py",
              "tests/test_torch_port_lovasz.py",
              "tests/test_torch_port_knn_card.py")
# the graft-entry request (the benchmark one is SERVE_REQUEST)
CHECK_REQUEST = dict(n_samples=2, density=120.0, image_size=(128, 64),
                     n_cameras=2)
LOGITS_RTOL = 3e-2                 # card vs CPU: bf16 tower convs differ
ARGMAX_AGREE = 0.99
TRAIN_STEPS = 10
NO_REMAT_STEPS = 6                 # steps with remat_tower=False
# card vs CPU train step: bf16 tower convs and the order of the pixel
# gather's scatter-add differ
TRAIN_LOSS_RTOL = 1e-2
TRAIN_GRAD_NORM_RTOL = 3e-2
# after an update the two devices' weights differ as well: the gradient
# norm's gap read 4.9e-3 and 5.8e-3 after an Adam / AdamW update and 7.3e-2
# after an accumulated SGD one (7e) on an H100
TRAIN_GRAD_NORM_AFTER_RTOL = 1e-1
UPDATE_GAP_TOP = 5                 # parameters named by ``log_update_gap``
# 7g, float32 everywhere: no bf16 rounding to amplify, so card and CPU must
# agree closely in the whole update, not only in its norm (an H100 read a
# loss gap of 0, 2.2e-4 in the gradient norm and 7.1e-3 in the update; with
# bf16 operands the update differs by 0.59)
ALL_F32_LOSS_RTOL = 1e-4
ALL_F32_GRAD_NORM_RTOL = 2e-3
ALL_F32_UPDATE_RTOL = 5e-2
# phase 7's variants: Adam and AdamW at a learning rate where one step
# moves the loss without leaving the basin (the second call's loss is
# compared too)
VARIANT_ADAM_LR = 1e-3
# the accumulated step at a tenth of phase 7's LR: at 0.1 one update takes
# the check request's loss from 1.77 to 0.64, and the loss after it
# differed between an H100 and the CPU by 8.7e-3, most of the 1e-2 bound
ACCUMULATE_LR = 1e-2
MOVED_SHARE = 0.99
# the recipe request: recipe_batch()'s defaults; the card vs CPU check takes
# the flat check's request as a ladder batch (ladder (64, 32), (128, 64)),
# so that the same bounds apply: at 64 x 32 images the tower's maps are 8 x 4
# cells and the bf16 gradient norm alone differs by 4.9e-2 between card and
# CPU (loss 7.5e-4, logits 2.3e-3)
RECIPE_IMAGE_SIZE = (1024, 512)
LADDER_CHECK_REQUEST = dict(min_size=32, **CHECK_REQUEST)
RECIPE_FORWARDS = 4
RECIPE_STEPS = 8
RECIPE_SHORT_STEPS = 5             # remat False and True
# per ladder batch: one atomic pool per bucket that holds an image, then the
# view pool's five reductions (four of them differentiated)
VIEW_POOL_FORWARD, VIEW_POOL_BACKWARD = 5, 4
REMAT_LOSS_RTOL = 2e-3             # second step's loss, across remat modes
# phase 9: the experiment loop through ``deepviewagg_tpu_torch.cli.train``;
# the S3DIS recipe (conf/s3dis_benchmark.yaml) on synthetic rooms, cut to
# one epoch of 48 spheres (12 batches) with an eval (the recipe: 200 x 2000,
# eval every 5; two epochs before 9e came, which needs their time); rooms
# of 6 x 4 x 2.6 m at 600 points
# per m^2, six 1024 x 512 panoramas each, so that a 2 m sphere at 5 cm holds
# about as many voxels as the cache's 6 cm grid gives
CONF = REPO / "conf"
QUICK_EPOCHS = 2
# 9b takes the recipe's published augmentations (s3dis.py:272-275: centre
# roll at train and eval, flip, mapping jitter, colour jitter at train) and
# keeps the raw clouds for 9c's full-resolution remap
RECIPE_LOOP = ("data.dataset=synthetic", "data.samples_per_epoch=48",
               "training.epochs=1", "training.eval_frequency=1",
               "data.kwargs={n_areas: 2, density: 600.0, n_cameras: 6, "
               "keep_raw: true, aug_params: {center_roll: true, flip_p: 0.5, "
               "jitter_mapping: 0.02, color_jitter: [0.6, 0.6, 0.7]}}")
# (the colour jitter's seams are its draw and its application: the dataset
# applies the draws in the native pass or in the numpy chain, and
# ``JITTER_APPLIED`` counts both)
AUGMENTS = ("center_roll", "random_horizontal_flip", "jitter_mapping_features",
            "draw_color_jitter")
JITTER_APPLIED = "color_jitter_applied"
# phase 9c-9d: eval with two voting runs and the full-resolution remap on
# 9b's run; MC dropout with three voting runs on 9a's, one room of it; the
# card vs CPU eval on 9a's run, one room; predict with a 3D-only
# Res16UNet34 trained on 9b's rooms (5 cm) for one epoch of 8 spheres
EVAL_VOTING_RUNS, MC_VOTING_RUNS = 2, 3
ONE_ROOM = "data.kwargs.n_areas=1"
EVAL_METRIC_ATOL = 1e-2            # card vs CPU, metrics as fractions
VOTE_RTOL = 1e-6                   # two sums of the same logits, reordered
PREDICT_SPHERES = 8
# phase 9e: the S3DIS loader end to end, from a synthetic 2D-3D-S raw layout
# written here (the card's machine has neither PIL nor the release):
# Area_1 with two rooms, Area_5 (the eval fold) with one, each room made by
# data/synthetic.py as in 9b (6 x 4 x 2.6 m at 600 points per m^2, the
# second room of an area 8 m along x), split by label into S3DIS class
# names, with three panoramas at the release's 2048 x 1024 (the preprocess
# resizes them to its 1024 x 512) whose rows cycle through the five PNG
# filter types and whose bottom 64 rows are one static band (a capture rig,
# for the non-static mask); cli.train with conf/s3dis_benchmark.yaml for
# one epoch of 24 spheres and an eval, then cli.eval with two voting runs
# and the full-resolution remap
S3DIS_AREAS = {1: 2, 5: 1}             # area -> rooms
S3DIS_PANORAMAS = 3                    # per room
S3DIS_PANORAMA = (2048, 1024)
S3DIS_DENSITY = 600.0                  # points per m^2
S3DIS_RIG_ROWS = 64
S3DIS_CLASS_NAMES = ("floor", "ceiling", "wall", "table")  # synthetic labels
S3DIS_LOOP = ("data.samples_per_epoch=24", "training.epochs=1",
              "training.eval_frequency=1",
              "data.kwargs={fold: 5, keep_raw: true}")
ZBUFFER_AGREE = 0.999                  # card vs CPU, of the seen pixels
# phase 4c: the four camera models over one synthetic room of about 10^6
# points (9,000 points per m^2); pixel coordinates card vs CPU within 1e-2
# px (float32 trigonometry, the cuSOLVER vs LAPACK inverse of the ScanNet
# pose and reordered sums move a coordinate by ulps of a value of up to
# 2048); the Biasutti kNN on every 50th point (about 20k; brute force), its
# X-wrap margin 20 px
CAMERA_DENSITY = 9000.0
CAMERA_PIX_ATOL = 1e-2
CAMERA_FISHEYE = np.array([2.2, 0.02, -0.01, 1320.0, 1320.0, 700.0, 700.0],
                          np.float32)
BIASUTTI_STRIDE, BIASUTTI_MARGIN = 50, 20.0
SCANNET_NATIVE = (640, 480)            # .sens colour frames
# phase 9f: the ScanNet loader end to end, from a ScanNet v2 layout written
# here with the port's write_jpeg and write_ply (the card's machine has
# neither PIL nor the release): four scans, three listed in
# scannetv2_train.txt and one in scannetv2_val.txt, each a synthetic room of
# 5 x 4 x 2.6 m at 1,000 points per m^2 (about 10^5 vertices, a
# _vh_clean_2.ply's order) with NYU40 labels, a pose file for each of 240
# frames and a 640 x 480 colour frame (smooth shading, the points' colours)
# at each multiple of frame_step = 20: 12 kept frames a scan, of which the
# coverage selection keeps max_images = 8; cli.train with
# conf/scannet_benchmark.yaml for one epoch of 24 spheres, then cli.eval
# with two voting runs and --submission
SCANNET_SCANS = {"scene0000_00": "train", "scene0001_00": "train",
                 "scene0002_00": "train", "scene0003_00": "val"}
SCANNET_ROOM = (5.0, 4.0, 2.6)
SCANNET_DENSITY = 1000.0
SCANNET_FRAMES, SCANNET_FRAME_STEP = 12, 20
SCANNET_NYU40 = (2, 22, 1, 5)          # synthetic labels -> NYU40 ids
SCANNET_LOOP = ("training.epochs=1",
                "data.kwargs={samples_per_epoch: 24, max_images: 8}")
SCANNET_IMAGE_SIZE = (320, 240)        # the preprocess's default
# phase 9g: the KITTI-360 loader end to end, from a release layout written
# here with the port's write_ply and write_png (the card's machine has
# neither PIL, PyYAML nor the release): one sequence, a straight street
# (road, sidewalks, facades, parked cars, trees, poles; KITTI-360 ids) of
# which three overlapping windows are cut, two listed in
# data_3d_semantics/train/2013_05_28_drive_train.txt and one in
# ..._val.txt; the vehicle drives along it at 0.2 m a frame; the release's
# calibration files (image_02.yaml / image_03.yaml with the %YAML:1.0
# directive, the document start and exponent floats); a cam0 PNG of 1408 x
# 376 and cam2 / cam3 PNGs of 1400 x 1400 (the vehicle's body a static band
# at the bottom) at each multiple of frame_step = 10: 11 frame times a
# window, 33 candidate images, of which the coverage selection keeps
# max_images = 30; the rows of every PNG mostly Up-filtered, with one row
# in 50 each of None, Sub, Avg and Paeth (all five filters, a Python
# unfilter for 2% of the rows); cli.train with conf/kitti360_benchmark.yaml
# as written but for data.root, one epoch of 24 cylinders (6 steps), then
# cli.eval with two voting runs and --submission
KITTI360_SEQ = "2013_05_28_drive_0000_sync"
KITTI360_WINDOWS = {"0000000000_0000000100": "train",
                    "0000000080_0000000180": "train",
                    "0000000160_0000000260": "val"}
KITTI360_FRAMES = range(0, 261, 10)
KITTI360_SPEED = 0.2                   # m a frame
KITTI360_DENSITY = 160.0               # points per m^2 of surface
# a window's cloud: the street from 8 m behind its first frame to 25 m
# ahead of its last (the LiDAR accumulates ahead of the drive; only the
# forward pinhole sees that far ahead)
KITTI360_BEHIND, KITTI360_AHEAD = 8.0, 25.0
KITTI360_PINHOLE, KITTI360_FISHEYE = (1408, 376), (1400, 1400)
KITTI360_FAMILIES = ((704, 188), (350, 350))    # the recipe's buckets
KITTI360_BODY_ROWS = 120               # the fisheyes' static band
KITTI360_IDS = {"road": 7, "sidewalk": 8, "building": 11, "pole": 17,
                "vegetation": 21, "car": 26, "unlabelled": 0}
KITTI360_LOOP = ("training.epochs=1", "data.samples_per_epoch=24")
# five branches (the PointPyramid's towers), each with one atomic pool per
# camera-family bucket and the view pool's reductions
KITTI360_BRANCHES, KITTI360_BUCKETS = 5, 2
KITTI360_FORWARD = KITTI360_BRANCHES * (KITTI360_BUCKETS + VIEW_POOL_FORWARD)
KITTI360_BACKWARD = KITTI360_BRANCHES * (KITTI360_BUCKETS
                                         + VIEW_POOL_BACKWARD)
# phase 9h: the paper's other model families on 9e's S3DIS layout (written
# anew when 9h runs alone), conf/s3dis_benchmark.yaml as written but for
# data.root, the model and one epoch of FAMILY_SPHERES spheres: (a) the light
# no3d model with the view-level loss, (b) the late feature-fusion model,
# each through cli.train and cli.eval --voting_runs 2; (c) at the library
# level, on (a)'s first collated batch, a forward and two train steps of
# each FAMILY_MODELS entry.  Sorted-segment launches per forward and per
# train step, from the code: one atomic pool and the view count, then the
# pool's own reductions (group: set-encoder max, compatibility max, softmax
# sum, weighted sum; qkv: the same with its key encoder; min-max-diff: its
# min and max of the map features, which take no gradient; mean: one sum;
# max and heuristic: one max)
FAMILY_SPHERES = 16
FAMILY_LOOP = ("training.epochs=1", f"data.samples_per_epoch={FAMILY_SPHERES}",
               "data.kwargs={fold: 5, keep_raw: true}")
FAMILY_LIGHT = ("Res16UNet21-15_light", 3, 2)
FAMILY_LATE = ("Res16UNet34-LateFeatureFusion", 6, 5)
FAMILY_MODELS = (  # (label, zoo name, set encoder, forward, backward)
    ("late_logit", "Res16UNet34-LateLogitFusion", None, 6, 5),
    ("no3d_ade20k_group8", "No3D-ADE20K-group8", None, 6, 5),
    ("no3d_l4_max", "No3D-L4-max", None, 3, 2),
    ("qkv", "Res16UNet34-L4-early-qkv-interpolate", None, 6, 5),
    ("heuristic", "Res16UNet34-L4-early-heuristic-interpolate", None, 3, 1),
    ("mean", "Res16UNet34-L4-early-mean-interpolate", None, 3, 2),
    ("group4_minmaxdiff", "Res16UNet34-L4-early-group4-interpolate",
     "minmaxdiff", 7, 4),
)
# phase 9i: pretrained BatchNorm towers and the bottleneck / SE Res16UNets on
# 9e's S3DIS layout (written anew when 9i runs alone): (a) the recipe
# (conf/s3dis_benchmark.yaml: the deep-stem 512-d L4 tower) with
# model.tower_weights = a random-weight MIT-semseg checkpoint written here,
# one epoch of PRETRAINED_SPHERES spheres and cli.eval --voting_runs 2, then
# again with model.tower_frozen=true (its atomic pool then takes no
# gradient: the view pool's 4 backward launches only); (b) the KITTI-360
# recipe's five deep-stem truncations with a Cityscapes-layout checkpoint,
# a forward and one step on (a)'s first batch (each branch its atomic pool
# and view pool: 5 x (6 + 5) launches); (c) cli.train of SERes16UNet34 for
# one epoch of SE_SPHERES spheres and cli.predict on Area_5's room, then a
# forward and two steps of each SE_MODELS entry on (a)'s first batch.  A
# squeeze-excitation block launches a segment sum and a segment count
# forward and the sum's backward (33 segments: the samples and padding)
PRETRAINED_SPHERES = 16
PRETRAINED_LOOP = ("training.epochs=1",
                   f"data.samples_per_epoch={PRETRAINED_SPHERES}",
                   "data.kwargs={fold: 5, keep_raw: true}")
PRETRAINED_FROZEN_BACKWARD = VIEW_POOL_BACKWARD
PRETRAINED_CHECK_IMAGES = 2            # tower card vs CPU, eval mode
TOWER_F32_RTOL = 1e-4                  # float32 operands: 7g's loss bound
REMAT_STATS_RTOL = 1e-6                # running statistics, remat modes
PYRAMID_MODEL = "Res16UNet34-PointPyramid-early-cityscapes-interpolate"
PYRAMID_LOADED = [9, 24, 39, 54, 69]   # parameters of each truncation
PYRAMID_FORWARD = KITTI360_BRANCHES * FORWARD_LAUNCHES
PYRAMID_BACKWARD = KITTI360_BRANCHES * BACKWARD_LAUNCHES
SE_SPHERES = 8
SE_CLI = ("SERes16UNet34", 46, 23)     # (zoo name, forward, backward)
SE_MODELS = (  # (label, zoo name, forward, backward), at 13 classes
    ("res16unet50", "Res16UNet50", 0, 0),
    ("res16unet101", "Res16UNet101", 0, 0),
    ("seres16unet50", "SERes16UNet50", 46, 23),
    ("res16unet50_l4_early", "Res16UNet50-L4-early", 6, 5),
)


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def norm_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """``|a - b| / |b|`` in the 2-norm."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def valid_voxels(batch) -> int:
    return int(np.asarray(batch["graph"]["levels"][0]["valid"]).sum())


def make_request(seed: int, device: str, **shape):
    """A collated numpy request, preprocessed on ``device``."""
    batch, _, _ = toy_batch(seed=seed, device=device, **shape)
    return batch


def phase_card() -> dict:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("0 card", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, allow_tf32_matmul=False,
        allow_tf32_cudnn=False)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    cuda_build.build()
    for name in (*cuda_build.KERNELS, *cuda_build.HOST):
        cuda_build.load(name)
    log("1 build", kernels=",".join(cuda_build.KERNELS),
        host=",".join(cuda_build.HOST))


class _Outcomes:
    """A pytest plugin that counts the tests' outcomes."""

    def __init__(self):
        self.passed, self.skipped, self.failed = [], [], []

    def pytest_runtest_logreport(self, report):
        if report.outcome != "passed":
            getattr(self, report.outcome).append(report.nodeid)
        elif report.when == "call":
            self.passed.append(report.nodeid)


def phase_kernels() -> None:
    """The ``card`` tests of ``CARD_TESTS`` in this process: pytest's exit
    code 0, at least one test run, none skipped."""
    import pytest

    outcomes = _Outcomes()
    rc = pytest.main(["-q", "--noconftest", "-p", "no:cacheprovider",
                      "-c", str(REPO / "pytest.ini"), "--rootdir", str(REPO),
                      "-m", "card", *(str(REPO / f) for f in CARD_TESTS)],
                     plugins=[outcomes])
    if rc != 0 or outcomes.failed or outcomes.skipped or not outcomes.passed:
        raise AssertionError(f"card tests: exit code {rc}, failed "
                             f"{outcomes.failed}, skipped {outcomes.skipped}")
    log("2 kernels", files=",".join(CARD_TESTS), passed=len(outcomes.passed))


def check_forward_calls(calls, phase: str, count_key: str) -> None:
    """Hold every recorded forward call against its plain version (max
    exact, sum within ``SUM_RTOL``, the same bits on two runs)."""
    for i, (x, ptr, valid, reduce) in enumerate(calls):
        err = check_call(x, ptr, valid, reduce)
        log(phase, call=i, reduce=reduce, rows=x.shape[0],
            channels=x.shape[1], segments=ptr.numel() - 1,
            masked=valid is not None, max_abs_err=err)
    log(phase, kernel="segment_csr", checked=True, **{count_key: len(calls)})


def zero_launches() -> None:
    for name in seg.LAUNCHES:
        seg.LAUNCHES[name] = 0


def image_shapes(np_batch) -> tuple:
    """The shape of a batch's image tensor, or of each of its ladder
    buckets' (a crop-ladder or camera-family batch); none for a 3D-only
    model's batch."""
    if "images" in np_batch:
        return tuple(np.asarray(np_batch["images"]).shape)
    return tuple(tuple(im.shape) for im in np_batch.get("bucket_images", ()))


def bucket_pixels(np_batch) -> tuple:
    """Valid pixel rows per ladder bucket at level 0 (empty for a flat
    batch or a 3D-only model's)."""
    mm = np_batch.get("mappings", {}).get(0, {})
    return tuple(int(np.asarray(b["pix_valid"]).sum())
                 for b in mm.get("buckets", ()))


def image_count(np_batch) -> int:
    """Images a request carries (a ladder batch: over its buckets, padding
    images included)."""
    if "images" in np_batch:
        return int(np.asarray(np_batch["images"]).shape[0])
    return sum(int(im.shape[0]) for im in np_batch["bucket_images"])


def serve_one(model, np_batch, phase: str, expect: int = FORWARD_LAUNCHES,
              batch=None, **fields) -> None:
    """One eval forward of a request on the card, checked: logits of the
    expected shape, finite on the valid voxels, through ``expect`` launches
    of the forward kernel."""
    if batch is None:
        batch = batch_to_torch(np_batch, device="cuda")
    before = seg.LAUNCHES["segment_csr"]
    with torch.no_grad():
        out = model(batch)
    n = valid_voxels(np_batch)
    logits = out["logits"][:n]
    if logits.shape != (n, model.spec.num_classes):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite logits on valid voxels")
    launched = seg.LAUNCHES["segment_csr"] - before
    if launched != expect:
        raise AssertionError(f"{launched} forward launches, expected "
                             f"{expect}")
    log(phase, **fields, voxels=n, images=image_count(np_batch),
        launches={"segment_csr": launched})


def phase_serving(model, requests) -> None:
    zero_launches()
    for i, np_batch in enumerate(requests):
        serve_one(model, np_batch, "3 serving", request=i)
    if seg.LAUNCHES["segment_csr_bwd"] != 0:
        raise AssertionError("serving launched the backward kernel")


def check_backward_calls(calls, phase: str) -> None:
    """Hold every recorded backward call against its plain version
    (bit-equal)."""
    for i, (g, x, out, ptr, valid, reduce, num_rows) in enumerate(calls):
        err = check_bwd_call(g, x, out, ptr, valid, reduce, num_rows)
        log(phase, call=i, reduce=reduce,
            rows=x.shape[0] if x is not None else num_rows,
            channels=g.shape[1], segments=g.shape[0],
            masked=valid is not None, max_abs_err=err)
    log(phase, kernel="segment_csr_bwd", checked=True, bit_equal=True,
        calls_per_step=len(calls))


def run_steps(model, batch, steps: int, phase: str, expect: dict,
              **fields) -> list:
    """``steps`` optimizer steps (SGD + momentum 0.9, LR 0.1, weight decay
    1e-4, clip 10) of ``model`` on one batch on the card, each checked
    (finite loss and gradient norm, ``expect`` launches); returns the
    losses."""
    model.train()
    state = TrainState.create(model, make_optimizer(
        make_schedule("constant", 0.1), grad_clip=10.0))
    step = make_train_step(model)
    losses = []
    for i in range(steps):
        before = dict(seg.LAUNCHES)
        state, metrics = step(state, batch, None)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise AssertionError(f"step {i}: loss {loss}, grad_norm {gnorm}")
        per_step = {k: seg.LAUNCHES[k] - before[k] for k in seg.LAUNCHES}
        if per_step != expect:
            raise AssertionError(f"launches per step: {per_step}, expected "
                                 f"{expect}")
        losses.append(loss)
        log(phase, **fields, step=i, loss=f"{loss:.6f}",
            grad_norm=f"{gnorm:.4f}", launches=per_step)
    if state.step != steps:
        raise AssertionError(f"step counter {state.step}")
    return losses


def check_trained(model, start, means, losses) -> None:
    """Every parameter has a gradient and moved, every running mean moved,
    the loss fell."""
    no_grad = [k for k, p in model.named_parameters() if p.grad is None]
    still = [k for k, p in model.named_parameters()
             if torch.equal(p.detach(), start[k])]
    if no_grad or still:
        raise AssertionError(f"parameters without gradient {no_grad[:5]} or "
                             f"unmoved {still[:5]}")
    stuck = [k for k, m in model.named_modules()
             if isinstance(m, MaskedBatchNorm)
             and torch.equal(m.running_mean, means[k])]
    if stuck:
        raise AssertionError(f"running means did not move: {stuck[:5]}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")


def snapshot(model) -> tuple:
    return ({k: p.detach().clone() for k, p in model.named_parameters()},
            {k: m.running_mean.clone() for k, m in model.named_modules()
             if isinstance(m, MaskedBatchNorm)})


def phase_training(model, np_batch, check_batch) -> None:
    """Ten optimizer steps on one request, then one without tower remat."""
    batch = batch_to_torch(np_batch, device="cuda")
    start, means = snapshot(model)
    zero_launches()
    expect = {"segment_csr": FORWARD_LAUNCHES,
              "segment_csr_bwd": BACKWARD_LAUNCHES}
    losses = run_steps(model, batch, TRAIN_STEPS, "6 training", expect)
    check_trained(model, start, means, losses)
    log("6 training", steps=TRAIN_STEPS,
        params=sum(p.numel() for p in model.parameters()),
        voxels=valid_voxels(np_batch), first_loss=f"{losses[0]:.4f}",
        last_loss=f"{losses[-1]:.4f}", launches=dict(seg.LAUNCHES))
    model.eval()
    serve_one(model, check_batch, "6 training", after="training, eval mode")
    # the same step without tower remat (``flagship_spec`` asks for
    # 'convs'): the same first loss
    plain = MultimodalSeg(with_remat(model.spec, False), device="cuda",
                          seed=0)
    short = run_steps(plain, batch, NO_REMAT_STEPS, "6 training", expect,
                      remat=False)
    err = abs(short[0] - losses[0]) / abs(losses[0])
    log("6 training", remat=False, steps=NO_REMAT_STEPS,
        first_loss=f"{short[0]:.6f}", first_loss_rel_err=f"{err:.3e}")
    if err > REMAT_LOSS_RTOL:
        raise AssertionError(f"remat changed the first loss: {err}")


def phase_train_card_vs_cpu(model, np_batch, phase="7 train card vs cpu"
                            ) -> dict:
    """One train step from identical weights on the card and on the CPU
    (``variant_steps`` with phase 7's optimizer); returns the loss and the
    relative errors of the loss and of the gradient norm."""
    got = variant_steps(model, np_batch, 1)
    (loss,), (ref_loss,) = got["cuda"]["losses"], got["cpu"]["losses"]
    (gnorm,), (ref_gnorm,) = got["cuda"]["norms"], got["cpu"]["norms"]
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    gnorm_err = abs(gnorm - ref_gnorm) / abs(ref_gnorm)
    log(phase, voxels=valid_voxels(np_batch),
        loss=f"{loss:.6f}", cpu_loss=f"{ref_loss:.6f}",
        loss_rel_err=f"{loss_err:.3e}", grad_norm=f"{gnorm:.5f}",
        cpu_grad_norm=f"{ref_gnorm:.5f}", grad_norm_rel_err=f"{gnorm_err:.3e}")
    log_update_gap(phase, got["cuda"]["params"], got["cpu"]["params"], 0)
    if not (loss_err <= TRAIN_LOSS_RTOL and gnorm_err <= TRAIN_GRAD_NORM_RTOL):
        raise AssertionError(
            f"card and CPU train steps disagree: {loss_err}, {gnorm_err}")
    return {"loss": loss, "loss_rel_err": loss_err,
            "grad_norm_rel_err": gnorm_err}


@contextlib.contextmanager
def f32_everywhere():
    """Float32 operands in every convolution: the towers'
    (``f32_convs``) and the sparse UNet's, which round them to bf16
    otherwise."""
    from deepviewagg_tpu_torch.nn import sparse_blocks as blocks

    saved = plain, subm, pair = (blocks.sparse_conv,
                                 blocks.sparse_conv_submanifold,
                                 blocks.sparse_conv_pair)
    blocks.sparse_conv = lambda f, w, n, bias=None, compute_dtype=None: \
        plain(f, w, n, bias, torch.float32)
    blocks.sparse_conv_submanifold = lambda f, w, n, cd=None: subm(
        f, w, n, torch.float32)
    blocks.sparse_conv_pair = lambda f, w, n, nt, cd=None: pair(
        f, w, n, nt, torch.float32)
    try:
        with f32_convs():
            yield
    finally:
        (blocks.sparse_conv, blocks.sparse_conv_submanifold,
         blocks.sparse_conv_pair) = saved


class MaxRouting:
    """A seam on ``seg.segment_csr_bwd`` for one run.  Every 'max' call
    records which elements attain their segment's max, i.e. where its
    cotangent goes (``segment_csr_bwd_plain`` of a cotangent of ones), and,
    over the (segment, channel) pairs that hold a valid row, how many
    attaining rows each has (``counts``: two or more is a tie, each of whose
    rows gets the whole cotangent) and how many have a runner-up exactly one
    ulp below the max (``near``).  With ``impose`` (the ``masks`` of another
    run, in call order) the i-th 'max' call routes its cotangent by
    ``impose[i]`` instead, in plain torch; 'sum' calls pass through."""

    def __init__(self, impose=None):
        self.impose = impose
        self.masks, self.ids, self.counts, self.near = [], [], [], []

    def __enter__(self):
        self.inner = inner = seg.segment_csr_bwd

        def route(g, x, out, ptr, valid, reduce, num_rows=None):
            if reduce != "max":
                return inner(g, x, out, ptr, valid, reduce, num_rows)
            mask = seg.segment_csr_bwd_plain(torch.ones_like(g), x, out, ptr,
                                             valid, "max") != 0
            ids, keep = seg._row_segments(ptr, x.shape[0])
            if valid is not None:
                keep = keep & valid
            below = torch.nextafter(out, torch.full_like(out, -np.inf))
            near = keep[:, None] & ~mask & (x == below[ids]) \
                & (x > seg._NEG / 2)

            def per_pair(m):
                return torch.zeros_like(g).index_add_(0, ids, m.float())

            self.counts.append(per_pair(mask).cpu())
            self.near.append(int((per_pair(near) > 0).sum()))
            self.masks.append(mask.cpu())
            self.ids.append(ids.cpu())
            if self.impose is None:
                return inner(g, x, out, ptr, valid, reduce, num_rows)
            imposed = self.impose[len(self.masks) - 1].to(g.device)
            if imposed.shape != mask.shape:
                raise AssertionError(f"imposed routing {imposed.shape} for "
                                     f"{mask.shape}")
            return torch.where(imposed, g[ids], 0.0)

        seg.segment_csr_bwd = route
        return self

    def __exit__(self, *exc):
        seg.segment_csr_bwd = self.inner


def routing_differences(card: MaxRouting, cpu: MaxRouting) -> list:
    """Per 'max' call of two runs of the same step: the pairs that hold a
    row, the tied and near-tied pairs on each, and the pairs whose attaining
    rows differ between them (``differ``), ``differ_tied`` of them tied on
    one side or both."""
    out = []
    for i, (a, b) in enumerate(zip(card.masks, cpu.masks)):
        n_a, n_b = card.counts[i], cpu.counts[i]
        differ = torch.zeros_like(n_a).index_add_(
            0, card.ids[i], (a ^ b).float()) > 0
        tied = (n_a > 1) | (n_b > 1)
        out.append({"rows": a.shape[0], "channels": a.shape[1],
                    "pairs": int((n_a > 0).sum()),
                    "tied": f"{int((n_a > 1).sum())}/{int((n_b > 1).sum())}",
                    "near": f"{card.near[i]}/{cpu.near[i]}",
                    "differ": int(differ.sum()),
                    "differ_tied": int((differ & tied).sum())})
    return out


def variant_steps(model, np_batch, calls: int, spec_changes=None,
                  branch_changes=None, dropout_seed=None, lr: float = 0.1,
                  routing: bool = False, all_f32: bool = False,
                  **opt) -> dict:
    """``calls`` train steps of a variant of ``model`` (its spec changed,
    its weights as they are) from identical weights on the card and on the
    CPU.  ``dropout_seed``: one CPU generator of that seed on each device,
    so that both draw the same dropout masks (``_uniform`` moves the draws
    to the card).  Returns per device the losses, the gradient norms and
    the parameters before and after every call (on the host).  With
    ``routing``, both runs record their max routing (``MaxRouting``) and
    the CPU runs once more with the card's routing imposed on every call
    (``got["cpu_card_routing"]``; the recorders under ``"routing"``); each
    of the three runs also keeps its tower's outputs and the cotangents that
    reached them (``TowerSeam``, under ``"tower"``).
    ``all_f32``: every convolution takes float32 operands on both devices
    (``f32_everywhere``), and the CPU runs once more on half its threads
    (``got["cpu_threads"]``, recorded as the routing runs are): the same
    step in another summation order on the same device."""
    spec = model.spec
    if branch_changes:
        spec = dataclasses.replace(spec, branches=tuple(
            (level, dataclasses.replace(b, **branch_changes))
            for level, b in spec.branches))
    if spec_changes:
        spec = dataclasses.replace(spec, **spec_changes)

    def run_on(device, router):
        m = MultimodalSeg(spec, device=device, seed=0)
        m.load_state_dict(model.state_dict())
        state = TrainState.create(m, make_optimizer(
            make_schedule("constant", lr), grad_clip=10.0, **opt))
        step = make_train_step(m)
        batch = batch_to_torch(np_batch, device)
        gen = None if dropout_seed is None else \
            torch.Generator().manual_seed(dropout_seed)

        def params():
            return {k: p.detach().cpu().clone()
                    for k, p in m.named_parameters()}

        run = {"losses": [], "norms": [], "params": [params()]}
        seam = TowerSeam() if router else contextlib.nullcontext()
        with router or contextlib.nullcontext(), seam, \
                f32_everywhere() if all_f32 else contextlib.nullcontext():
            for _ in range(calls):
                _, metrics = step(state, batch, gen)
                run["losses"].append(float(metrics["loss"]))
                run["norms"].append(float(metrics["grad_norm"]))
                run["params"].append(params())
        if router:
            run["tower"] = (seam.outputs, seam.cotangents)
        return run

    routers = {d: MaxRouting() for d in ("cuda", "cpu")} if routing else {}
    got = {d: run_on(d, routers.get(d)) for d in ("cuda", "cpu")}
    if routing:
        imposed = MaxRouting(impose=routers["cuda"].masks)
        got["cpu_card_routing"] = run_on("cpu", imposed)
        got["routing"] = routers
    if all_f32:
        threads = torch.get_num_threads()
        torch.set_num_threads(max(1, threads // 2))
        try:
            router = MaxRouting()
            got["cpu_threads"] = run_on("cpu", router)
            got["cpu_threads"]["router"] = router
        finally:
            torch.set_num_threads(threads)
    return got


def moved(before: dict, after: dict) -> set:
    return {k for k in before if not torch.equal(before[k], after[k])}


def log_update_gap(phase: str, card: list, cpu: list, call: int,
                   against: str = "cpu") -> float:
    """Where two runs' updates at ``call`` differ (parameters before and
    after each call, as ``variant_steps`` keeps them; the same weights
    before it).  SGD's first update is linear in the gradient and the weight
    decay term is equal on both, so this splits the gradients' difference:
    its norm relative to the CPU's update, the tower's share of its square,
    and the ``UPDATE_GAP_TOP`` parameters with the largest shares, each with
    its own relative difference; returns the first of these."""
    diff, base = {}, {}
    for k in card[call]:
        a = (card[call + 1][k] - card[call][k]).double()
        b = (cpu[call + 1][k] - cpu[call][k]).double()
        diff[k], base[k] = float((a - b).square().sum()), float(
            b.square().sum())
    total = sum(diff.values())
    tower = sum(v for k, v in diff.items() if k.startswith("branch_l0.tower."))
    rel = (total / sum(base.values())) ** 0.5
    log(phase, against=against, update_rel_diff=f"{rel:.3e}",
        tower_share=f"{tower / total:.3f}" if total else "none")
    for k in sorted(diff, key=diff.get, reverse=True)[:UPDATE_GAP_TOP]:
        if diff[k]:
            log(phase, against=against, param=k,
                share=f"{diff[k] / total:.3f}",
                rel_diff=f"{(diff[k] / base[k]) ** 0.5:.3e}" if base[k]
                else "inf")
    return rel


def rel_errs(a: list, b: list) -> list:
    return [abs(x - y) / abs(y) for x, y in zip(a, b)]


def log_routing(phase: str, got: dict, calls: int, moves: list) -> float:
    """The routing split of a ``variant_steps(..., routing=True)`` run:
    per 'max' call of each step, the pairs the two devices route apart
    (``routing_differences``); per step, the tower's output and the
    cotangent reaching it, card against the CPU and against the CPU with
    the card's routing imposed; at the first update, where it differs by
    parameter against either (``log_update_gap``); with ``"cpu_threads"``,
    the same for the CPU against itself on half its threads.  Returns
    the card's update difference from the CPU's."""
    routers = got["routing"]
    per_call = len(routers["cuda"].masks) // calls
    for i, diff in enumerate(routing_differences(routers["cuda"],
                                                 routers["cpu"])):
        log(phase, routing="card/cpu", call=i // per_call,
            max_call=i % per_call, **diff)
    (out, cot), (cpu_out, cpu_cot), (_, imposed_cot) = (
        got[k]["tower"] for k in ("cuda", "cpu", "cpu_card_routing"))
    for i in range(calls):
        log(phase, call=i, tower_output_rel_diff=(
            f"{norm_rel(out[i], cpu_out[i]):.3e}"),
            cotangent_rel_diff=f"{norm_rel(cot[i], cpu_cot[i]):.3e}",
            routed_cotangent_rel_diff=(
                f"{norm_rel(cot[i], imposed_cot[i]):.3e}"))
    first = next(i for i, m in enumerate(moves) if m)
    rel = log_update_gap(phase, got["cuda"]["params"], got["cpu"]["params"],
                         first)
    log_update_gap(phase, got["cuda"]["params"],
                   got["cpu_card_routing"]["params"], first,
                   "cpu_card_routing")
    if "cpu_threads" in got:
        other = got["cpu_threads"]
        for i, diff in enumerate(routing_differences(routers["cpu"],
                                                     other["router"])):
            log(phase, routing="cpu/cpu_half_threads", call=i // per_call,
                max_call=i % per_call, **diff)
        (t_out, t_cot) = other["tower"]
        for i in range(calls):
            log(phase, call=i, against="cpu_half_threads",
                tower_output_rel_diff=f"{norm_rel(t_out[i], cpu_out[i]):.3e}",
                cotangent_rel_diff=f"{norm_rel(t_cot[i], cpu_cot[i]):.3e}")
        log_update_gap(phase + " cpu", other["params"], got["cpu"]["params"],
                       first, "cpu_half_threads")
    return rel


def phase_train_variants(model, np_batch, plain: dict) -> None:
    """Phase 7's card vs CPU check on the paths of the train step that the
    flagship step leaves out (ROADMAP C): dropout, Adam, AdamW, a frozen
    tower, gradient accumulation, and the flat step with float32 towers
    (7f: float32 activations, the convolutions' operands still bf16) and
    with float32 everywhere (7g: the towers' and the sparse UNet's
    convolution operands too).
    Every call's loss to phase 7's bound, the gradient norm to phase 7's
    bound at the start weights and to ``TRAIN_GRAD_NORM_AFTER_RTOL`` after
    an update, and the parameters that must (not) move.  7e-7g also split
    the gap by cause (``log_routing``): both devices' max routing (ties,
    near ties, pairs routed apart), the CPU again with the card's routing
    imposed (loss and gradient norm gaps as ``routed_*``), the cotangent
    reaching the tower, the update by parameter.  7g, with no bf16 rounding
    to amplify, holds loss, gradient norm and the whole update to the
    ``ALL_F32_*`` bounds, beside the CPU against itself on half its
    threads."""
    names = [k for k, _ in model.named_parameters()]
    tower = {k for k in names if k.startswith("branch_l0.tower.")}
    variants = [
        ("7a dropout", dict(spec_changes={"head_dropout": 0.5},
                            dropout_seed=0), 1),
        ("7b adam", dict(optimizer="adam", lr=VARIANT_ADAM_LR), 2),
        ("7c adamw", dict(optimizer="adamw", lr=VARIANT_ADAM_LR), 2),
        ("7d frozen tower", dict(branch_changes={"frozen": True},
                                 freeze_paths=(("branch_l0", "tower"),)), 1),
        ("7e accumulate 2", dict(grad_accumulate=2, lr=ACCUMULATE_LR,
                                 routing=True), 3),
        ("7f tower f32", dict(branch_changes={"tower_bf16": False},
                              routing=True), 1),
        ("7g all f32", dict(branch_changes={"tower_bf16": False},
                            all_f32=True, routing=True), 1),
    ]
    for phase, kw, calls in variants:
        got = variant_steps(model, np_batch, calls, **kw)
        card, cpu = got["cuda"], got["cpu"]
        loss_err = rel_errs(card["losses"], cpu["losses"])
        norm_err = rel_errs(card["norms"], cpu["norms"])
        moves = {d: [moved(got[d]["params"][i], got[d]["params"][i + 1])
                     for i in range(calls)] for d in ("cuda", "cpu")}
        fields = {}
        # per call: the parameters that must not move, and the least share
        # of the others that must (a parameter whose gradient is exactly
        # zero may stay, as under Adam)
        rules = [(set(), MOVED_SHARE)] * calls
        if phase == "7a dropout":
            # the masks acted: not the loss of phase 7's plain step
            fields["plain_loss"] = f"{plain['loss']:.6f}"
            if abs(card["losses"][0] - plain["loss"]) <= 1e-6 * abs(
                    plain["loss"]):
                raise AssertionError(f"{phase}: dropout changed no loss")
        elif phase == "7d frozen tower":
            rules = [(tower, MOVED_SHARE)]
            fields["frozen_params"] = len(tower)
        elif phase == "7e accumulate 2":
            # the first mini-step moves nothing, the second the rest; the
            # third (the loss after the update) starts a new accumulation
            rules = [(set(names), 0.0), (set(), MOVED_SHARE),
                     (set(names), 0.0)]
        elif phase.startswith("7f") or phase.startswith("7g"):
            fields.update(bf16_loss_rel_err=f"{plain['loss_rel_err']:.3e}",
                          bf16_grad_norm_rel_err=(
                              f"{plain['grad_norm_rel_err']:.3e}"))
        for device, runs in moves.items():
            for i, (run, (still, share)) in enumerate(zip(runs, rules)):
                free = set(names) - still
                if run & still or len(run) < share * len(free):
                    raise AssertionError(
                        f"{phase} on {device}, call {i}: {len(run)} of "
                        f"{len(names)} parameters moved, "
                        f"{len(run & still)} of them must not")
        routed = None
        if "cpu_card_routing" in got:
            imposed = got["cpu_card_routing"]
            routed = (rel_errs(card["losses"], imposed["losses"]),
                      rel_errs(card["norms"], imposed["norms"]))
            fields.update(
                routed_loss_rel_err="/".join(f"{x:.3e}" for x in routed[0]),
                routed_grad_norm_rel_err="/".join(
                    f"{x:.3e}" for x in routed[1]))
        log(phase, calls=calls,
            loss="/".join(f"{x:.6f}" for x in card["losses"]),
            cpu_loss="/".join(f"{x:.6f}" for x in cpu["losses"]),
            loss_rel_err="/".join(f"{x:.3e}" for x in loss_err),
            grad_norm_rel_err="/".join(f"{x:.3e}" for x in norm_err),
            moved="/".join(str(len(r)) for r in moves["cuda"]), **fields)
        if routed is not None:
            update_rel = log_routing(phase, got, calls, moves["cuda"])
        # phase 7's gradient-norm bound holds at the start weights; after an
        # update the two devices' weights differ too
        at_start = [not any(moves["cuda"][:i]) for i in range(calls)]
        norm_bad = [e > (TRAIN_GRAD_NORM_RTOL if start
                         else TRAIN_GRAD_NORM_AFTER_RTOL)
                    for e, start in zip(norm_err, at_start)]
        if max(loss_err) > TRAIN_LOSS_RTOL or any(norm_bad):
            raise AssertionError(f"{phase}: card and CPU disagree: "
                                 f"{loss_err}, {norm_err}")
        if kw.get("all_f32") and not (
                loss_err[0] <= ALL_F32_LOSS_RTOL
                and norm_err[0] <= ALL_F32_GRAD_NORM_RTOL
                and update_rel <= ALL_F32_UPDATE_RTOL):
            raise AssertionError(f"{phase}: card and CPU disagree in float32: "
                                 f"{loss_err}, {norm_err}, {update_rel}")
        del got


class TowerSeam:
    """A seam on the branch's ``run_tower`` for one run: every call's output
    and the cotangent that reaches it (on the host), in call order."""

    def __enter__(self):
        from deepviewagg_tpu_torch.modules import branch

        self.outputs, self.cotangents = [], []
        self.owner, self.inner = branch, branch.run_tower

        def run(*args, **kwargs):
            y = self.inner(*args, **kwargs)
            self.outputs.append(y.detach().cpu())
            if y.requires_grad:
                y.register_hook(lambda g: self.cotangents.append(g.cpu()))
            return y

        branch.run_tower = run
        return self

    def __exit__(self, *exc):
        self.owner.run_tower = self.inner


def phase_tower_card_vs_cpu(model, np_batch) -> None:
    """7h: the tower alone on each device from the same images and the
    same seeded cotangent on its output, float32 operands and activations
    (``f32_convs``), train mode, with its input as the branch hands it (an
    NHWC tensor permuted to NCHW: channels-last strides) or contiguous, and
    with remat off or the branch's: each parameter gradient against the
    CPU's contiguous, remat-off one (all of them as one vector, and the
    worst parameter)."""
    phase = "7h tower alone card vs cpu"
    images = {d: batch_to_torch(np_batch, d)["images"] for d in ("cpu", "cuda")}
    with torch.no_grad():
        shape = run_tower(copy.deepcopy(model.branch_l0.tower).cpu(),
                          images["cpu"], bf16=False).shape
    cotangent = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    remat = model.branch_l0.remat_tower
    grads, names = {}, [k for k, _ in model.branch_l0.tower.named_parameters()]
    for device in ("cpu", "cuda"):
        nchw = images[device].permute(0, 3, 1, 2)
        for layout in ("contiguous", "channels_last"):
            # run_tower permutes NHWC to NCHW: hand it the NHWC view of the
            # layout wanted
            x = nchw.contiguous() if layout == "contiguous" else \
                nchw.contiguous(memory_format=torch.channels_last)
            for mode in (False, remat):
                tower = copy.deepcopy(model.branch_l0.tower).to(device)
                with f32_convs():
                    y = run_tower(tower, x.permute(0, 2, 3, 1), True,
                                  remat=mode, bf16=False)
                    y.backward(cotangent.to(device))
                grads[device, layout, mode] = (
                    y.detach().cpu(),
                    [p.grad.detach().cpu() for p in tower.parameters()])
                del tower, y
    ref_y, ref = grads["cpu", "contiguous", False]
    ref_flat = torch.cat([g.reshape(-1) for g in ref])
    for (device, layout, mode), (y, g) in grads.items():
        flat = torch.cat([t.reshape(-1) for t in g])
        per = [norm_rel(a, b) for a, b in zip(g, ref)]
        worst = int(np.argmax(per))
        log(phase, tower_alone=device, layout=layout, remat=mode,
            output_rel_diff=f"{norm_rel(y, ref_y):.3e}",
            grad_rel_diff=f"{norm_rel(flat, ref_flat):.3e}",
            worst_param=names[worst], worst_rel_diff=f"{per[worst]:.3e}")


def phase_card_vs_cpu(model, np_batch, phase="4 card vs cpu") -> None:
    n = valid_voxels(np_batch)
    with torch.no_grad():
        card = model(batch_to_torch(np_batch, "cuda"))["logits"][:n].cpu()
        cpu_model = copy.deepcopy(model).to("cpu")
        cpu = cpu_model(batch_to_torch(np_batch, "cpu"))["logits"][:n]
    err = rel_err(card, cpu)
    agree = float((card.argmax(1) == cpu.argmax(1)).double().mean())
    log(phase, voxels=n, rel_err=f"{err:.3e}",
        argmax_agree=f"{agree:.5f}")
    if not (err <= LOGITS_RTOL and agree >= ARGMAX_AGREE):
        raise AssertionError(f"card and CPU disagree: {err}, {agree}")


# --- the camera models, card vs CPU -------------------------------------------

def four_cameras(scene_pano, scene_pinhole) -> list:
    """One camera of each model over the same room: the synthetic scene's
    panorama (2048 x 1024) and ScanNet pinhole (640 x 480, cam->world
    pose), and on that pose KITTI-360's perspective camera (1408 x 376, its
    ``P_rect_00``) and MEI fisheye (1400 x 1400, the ``image_02``
    parameters ``tests/test_kitti360_fisheye.py`` writes)."""
    from deepviewagg_tpu_torch.core.cameras import Camera

    pano, pin = scene_pano.cameras[0], scene_pinhole.cameras[0]
    k = np.eye(4, dtype=np.float32)
    k[0, 0] = k[1, 1] = 552.55
    k[0, 2], k[1, 2] = 682.05, 238.77
    return [
        pano,
        pin,
        Camera(model="kitti360_perspective", size=(1408, 376),
               extrinsic=pin.extrinsic, intrinsic=k, r_min=pin.r_min,
               r_max=pin.r_max),
        Camera(model="kitti360_fisheye", size=(1400, 1400),
               extrinsic=pin.extrinsic, fisheye=CAMERA_FISHEYE,
               r_min=pin.r_min, r_max=pin.r_max),
    ]


def on_both(fn) -> dict:
    """``{device: fn(device)}`` on the card and on the CPU."""
    return {device: fn(device) for device in ("cuda", "cpu")}


def phase_cameras_card_vs_cpu() -> None:
    """4c: the four camera models over about 10^6 points of a synthetic
    room, card vs CPU (plain torch both): pixel coordinates within
    ``CAMERA_PIX_ATOL`` where valid, validity and each model's
    ``splat_zbuffer`` winner map agreeing on >= 99.9% of the points / seen
    pixels (9e's rule: float ``dist`` ties and pixel edges may break
    apart); then one Biasutti mask (the panorama, X-wrapped, on a subsample:
    its kNN is brute force) and one depth-map mask (the ScanNet pinhole
    against the card's z-buffer depths), to the same share."""
    from deepviewagg_tpu_torch.core import cameras, visibility
    from deepviewagg_tpu_torch.data import synthetic

    pano = synthetic.make_scene(seed=0, density=CAMERA_DENSITY, n_cameras=1,
                                image_size=S3DIS_PANORAMA)
    pin = synthetic.make_scene(seed=0, density=CAMERA_DENSITY, n_cameras=1,
                               camera_model="scannet",
                               image_size=SCANNET_NATIVE)
    pos = torch.from_numpy(pano.pos.astype(np.float32))
    log("4c cameras card vs cpu", points=len(pos))
    depth_maps = {}
    cams = four_cameras(pano, pin)
    for cam in cams:
        proj = on_both(lambda d: [
            t.cpu() for t in cameras.project(pos.to(d), cam)])
        (xa, ya, da, va), (xb, yb, db, vb) = proj["cuda"], proj["cpu"]
        both = va & vb
        pix_err = float(torch.maximum((xa - xb).abs(), (ya - yb).abs())
                        [both].max())
        valid_agree = float((va == vb).double().mean())
        maps = on_both(lambda d: [
            t.cpu() for t in visibility.splat_zbuffer(
                cam, pos.to(d), voxel=0.05)[:2]])
        a, b = maps["cuda"][0], maps["cpu"][0]
        seen = (a >= 0) | (b >= 0)
        agree = float((a == b)[seen].double().mean())
        depth_maps[cam.model] = maps["cuda"][1]
        log("4c cameras card vs cpu", model=cam.model,
            image=f"{cam.size[0]}x{cam.size[1]}", valid=int(vb.sum()),
            pix_max_abs_err=f"{pix_err:.3e}",
            dist_max_abs_err=f"{float((da - db).abs().max()):.3e}",
            valid_agree=f"{valid_agree:.6f}", seen_pixels=int(seen.sum()),
            zbuffer_agree=f"{agree:.6f}")
        if not (pix_err <= CAMERA_PIX_ATOL and valid_agree >= ZBUFFER_AGREE
                and agree >= ZBUFFER_AGREE and seen.sum() > 1000):
            raise AssertionError(f"4c {cam.model}: pixels {pix_err}, valid "
                                 f"{valid_agree}, z-buffer {agree}")

    pano_cam, pin_cam = cams[:2]
    sub = pos[::BIASUTTI_STRIDE]

    def biasutti(d):
        x, y, dist, valid = cameras.project(sub.to(d), pano_cam)
        return visibility.biasutti_visibility(
            x, y, dist, valid, k=75, x_margin=BIASUTTI_MARGIN,
            x_width=pano_cam.size[0]).cpu()

    def depth(d):
        x, y, dist, valid = cameras.project(pos.to(d), pin_cam)
        return (valid & visibility.depth_map_visibility(
            x, y, dist, depth_maps["scannet"].to(d))).cpu()

    for name, fn, n in (("biasutti", biasutti, len(sub)),
                        ("depth_map", depth, len(pos))):
        masks = on_both(fn)
        agree = float((masks["cuda"] == masks["cpu"]).double().mean())
        log("4c cameras card vs cpu", method=name, points=n,
            seen=int(masks["cpu"].sum()), agree=f"{agree:.6f}")
        if agree < ZBUFFER_AGREE or not masks["cpu"].any():
            raise AssertionError(f"4c {name}: card and CPU agree on {agree}")


# --- the recipe request (crop ladder) ----------------------------------------

def ladder_launches(np_batch) -> dict:
    """Kernel launches of one train step on a ladder batch with one branch:
    an atomic pool per bucket that holds an image, then the view pool's."""
    buckets = sum(int(im.shape[0]) > 0 for im in np_batch["bucket_images"])
    return {"segment_csr": buckets + VIEW_POOL_FORWARD,
            "segment_csr_bwd": buckets + VIEW_POOL_BACKWARD}


def with_remat(spec, remat):
    return dataclasses.replace(spec, branches=tuple(
        (lvl, dataclasses.replace(b, remat_tower=remat))
        for lvl, b in spec.branches))


def check_recipe_request(np_batch) -> dict:
    """The request is the recipe's: every image in the largest bucket at
    full size, the smaller buckets one zero image and masked rows only."""
    images = np_batch["bucket_images"]
    buckets = np_batch["mappings"][0]["buckets"]
    rows = [int(b["pix_valid"].shape[0]) for b in buckets]
    live = [int(b["pix_valid"].sum()) for b in buckets]
    if tuple(images[-1].shape[1:3]) != RECIPE_IMAGE_SIZE or len(images) != 4:
        raise AssertionError(f"ladder {[tuple(i.shape) for i in images]}")
    if images[-1].shape[0] != 4 or any(live[:-1]) or live[-1] < 500_000:
        raise AssertionError(f"images {[i.shape[0] for i in images]}, live "
                             f"pixel rows {live}")
    if any(np.abs(im).max() != 0 for im in images[:-1]):
        raise AssertionError("a padding image is not zero")
    view = np_batch["mappings"][0]["view"]
    return dict(voxels=valid_voxels(np_batch),
                voxel_cap=int(np_batch["feats"].shape[0]),
                view_rows=int(view["view_valid"].shape[0]),
                valid_views=int(view["view_valid"].sum()),
                ladder="+".join(f"{i.shape[0]}x{i.shape[1]}x{i.shape[2]}"
                                for i in images),
                pixel_rows=rows, live_pixel_rows=live)


def phase_recipe_gather(batch) -> None:
    """8b: the pixel gather of the largest bucket at the tower's 128
    channels takes the upsample route (the upsampled maps, then one
    ``index_select`` of the rows)."""
    bucket = batch["mappings"][0]["buckets"][-1]
    images = batch["bucket_images"][-1]
    i_cap, (w, h) = images.shape[0], images.shape[1:3]
    rows = bucket["pix_x"].shape[0]
    used = pixel_gather._use_upsample(i_cap, w, h, 128, rows, 4)
    log("8b recipe gather", rows=rows, channels=128,
        maps=f"{i_cap}x{w // 8}x{h // 8}", upsampled=f"{i_cap}x{w}x{h}",
        use_upsample=used)
    if not used:
        raise AssertionError("the recipe shape did not take the upsample path")


def phase_recipe(model) -> None:
    """Phases 8, 8a-8e: the crop-ladder path at the recipe's size."""
    np_batch, _, _ = recipe_batch(device="cuda")
    shape = check_recipe_request(np_batch)
    log("8 recipe request", **shape)
    expect = ladder_launches(np_batch)
    batch = batch_to_torch(np_batch, device="cuda")

    # 8a: every kernel call of the path against its plain version
    calls = record_segment_calls(model, batch)
    if len(calls) != expect["segment_csr"]:
        raise AssertionError(f"{len(calls)} segment calls in one recipe "
                             f"forward, expected {expect['segment_csr']}")
    masked_out = [c for c in calls if c[2] is not None and not c[2].any()]
    if len(masked_out) != 3:
        raise AssertionError(f"{len(masked_out)} all-masked calls")
    check_forward_calls(calls, "8a recipe kernels",
                          "calls_per_recipe_forward")
    del calls, masked_out
    train_model = copy.deepcopy(model).train()
    bwd_calls = record_backward_calls(train_model, batch)
    if len(bwd_calls) != expect["segment_csr_bwd"]:
        raise AssertionError(f"{len(bwd_calls)} segment backwards in one "
                             f"recipe step, expected "
                             f"{expect['segment_csr_bwd']}")
    check_backward_calls(bwd_calls, "8a recipe kernels")
    del bwd_calls, train_model
    torch.cuda.empty_cache()

    # 8b: the pixel gather's route
    phase_recipe_gather(batch)

    # 8c: serving
    zero_launches()
    for i in range(RECIPE_FORWARDS):
        serve_one(model, np_batch, "8c recipe serving",
                  expect=expect["segment_csr"], batch=batch, forward=i)
    if seg.LAUNCHES["segment_csr_bwd"] != 0:
        raise AssertionError("serving launched the backward kernel")
    log("8c recipe serving", forwards=RECIPE_FORWARDS,
        launches=dict(seg.LAUNCHES))

    # 8d: training under the three remat modes, from the same weights
    runs = {}
    for remat, steps in (("convs", RECIPE_STEPS), (False, RECIPE_SHORT_STEPS),
                         (True, RECIPE_SHORT_STEPS)):
        m = MultimodalSeg(with_remat(model.spec, remat), device="cuda",
                          seed=0)
        start, means = snapshot(m)
        if not all(torch.equal(p, dict(model.named_parameters())[k])
                   for k, p in start.items()):
            raise AssertionError("the seeded weights differ from the serving "
                                 "model's")
        zero_launches()
        runs[remat] = run_steps(m, batch, steps, "8d recipe training",
                                expect, remat=remat)
        if remat == "convs":
            check_trained(m, start, means, runs[remat])
        del m, start, means
        torch.cuda.empty_cache()
    ref = runs[False]
    for remat in ("convs", True):
        errs = [abs(a - b) / abs(b) for a, b in zip(runs[remat][:2], ref[:2])]
        log("8d recipe training", remat=remat, against=False,
            first_loss_rel_err=f"{errs[0]:.3e}",
            second_loss_rel_err=f"{errs[1]:.3e}")
        if max(errs) > REMAT_LOSS_RTOL:
            raise AssertionError(f"remat {remat!r} changed the loss: {errs}")

    # 8e: card vs CPU on a small ladder batch, logits and one train step
    small, _, _ = recipe_batch(device="cuda", **LADDER_CHECK_REQUEST)
    ladder = [tuple(im.shape[1:3]) for im in small["bucket_images"]]
    if ladder != [(64, 32), (128, 64)]:
        raise AssertionError(f"small ladder {ladder}")
    phase_card_vs_cpu(model, small, "8e ladder card vs cpu")
    phase_train_card_vs_cpu(model, small, "8e ladder train card vs cpu")


class Seams:
    """Attributes of the package replaced for one run (``with``), put
    back on exit."""

    def __init__(self):
        self._undo = []

    def _patch(self, owner, name, make):
        original = getattr(owner, name)
        self._undo.append((owner, name, original))
        setattr(owner, name, make(original))

    def __exit__(self, *exc):
        for owner, name, original in reversed(self._undo):
            setattr(owner, name, original)
        return False


class LoopProbe(Seams):
    """The seams of one ``cli.train.main`` run, patched for that run only:
    every train step (loss, launches of each kernel), each train batch's
    image shapes, valid voxels and pixel rows, the number of eval batches,
    the bucket, the calls of each of the recipe's 2D augmentations, the
    ``Trainer`` (its model's parameters as built) and the first train
    step's batch on the card (``batch``).  ``on_fit(trainer)`` runs just
    before ``Trainer.fit``."""

    def __init__(self, on_fit=None):
        super().__init__()
        self.on_fit = on_fit
        self.losses, self.step_launches = [], []
        self.train_images, self.eval_batches = [], 0
        self.train_voxels, self.bucket_pixels = [], []
        self.augments = dict.fromkeys((*AUGMENTS, JITTER_APPLIED), 0)
        self.bucket = self.trainer = self.start = self.batch = None

    def __enter__(self):
        from deepviewagg_tpu_torch.cli import train as cli
        from deepviewagg_tpu_torch.data import transforms2d
        from deepviewagg_tpu_torch.data.datasets import base
        from deepviewagg_tpu_torch.native import images as native_images
        from deepviewagg_tpu_torch.train import trainer

        probe = self

        def make_train_step(original):
            def build(*args, **kwargs):
                step = original(*args, **kwargs)

                def run(state, batch, generator):
                    if probe.batch is None:
                        probe.batch = batch
                    before = dict(seg.LAUNCHES)
                    state, metrics = step(state, batch, generator)
                    loss = float(metrics["loss"])
                    if not np.isfinite(loss):
                        raise AssertionError(
                            f"step {len(probe.losses)}: loss {loss}")
                    probe.losses.append(loss)
                    probe.step_launches.append(
                        {k: seg.LAUNCHES[k] - before[k] for k in before})
                    return state, metrics
                return run
            return build

        def init(original):
            def run(trainer_self, *args, **kwargs):
                original(trainer_self, *args, **kwargs)
                probe.trainer = trainer_self
                probe.start = {k: p.detach().clone() for k, p in
                               trainer_self.model.named_parameters()}
            return run

        def fit(original):
            def run(trainer_self, *args, **kwargs):
                if probe.on_fit is not None:
                    probe.on_fit(trainer_self)
                return original(trainer_self, *args, **kwargs)
            return run

        def loader_iter(original):
            def run(loader):
                it = original(loader)
                try:
                    while True:
                        try:
                            batch = next(it)
                        except StopIteration:
                            return
                        if loader.dataset.train:
                            probe.train_images.append(image_shapes(batch))
                            probe.train_voxels.append(valid_voxels(batch))
                            probe.bucket_pixels.append(
                                bucket_pixels(batch))
                        else:
                            probe.eval_batches += 1
                        yield batch
                finally:
                    it.close()
            return run

        def auto_bucket(original):
            def run(*args, **kwargs):
                probe.bucket = original(*args, **kwargs)
                return probe.bucket
            return run

        self._patch(trainer, "make_train_step", make_train_step)
        self._patch(trainer.Trainer, "__init__", init)
        self._patch(trainer.Trainer, "fit", fit)
        self._patch(base.BatchLoader, "__iter__", loader_iter)

        def counted(name):
            def make(fn):
                def run(*args, **kwargs):
                    probe.augments[name] += 1
                    return fn(*args, **kwargs)
                return run
            return make

        def applied(fn):
            # the native pass with draws, or the numpy chain's application
            def run(images, draws=None, *args, **kwargs):
                if draws is not None:
                    probe.augments[JITTER_APPLIED] += 1
                return fn(images, draws, *args, **kwargs)
            return run

        self._patch(cli, "auto_bucket", auto_bucket)
        for name in AUGMENTS:
            self._patch(transforms2d, name, counted(name))
        self._patch(native_images, "jitter_normalize", applied)
        self._patch(transforms2d, "apply_color_jitter", applied)
        return self

    def check_steps(self, phase: str, forward: int = FORWARD_LAUNCHES,
                    backward: int = BACKWARD_LAUNCHES) -> None:
        """Every step finite (checked as it ran) and through ``forward`` +
        ``backward`` kernel launches (the flagship's by default); every
        parameter on the card."""
        expect = {"segment_csr": forward, "segment_csr_bwd": backward}
        bad = [d for d in self.step_launches if d != expect]
        if not self.losses or bad:
            raise AssertionError(f"{phase}: {len(self.losses)} steps, "
                                 f"launches {bad[:2]} (expected {expect})")
        off = [k for k, p in self.trainer.model.named_parameters()
               if p.device.type != "cuda"]
        if off:
            raise AssertionError(f"{phase}: parameters off the card {off[:5]}")

    def summary(self) -> dict:
        return {
            "steps": len(self.losses),
            "voxels_per_batch": f"{min(self.train_voxels)}-"
                                f"{max(self.train_voxels)} (mean "
                                f"{np.mean(self.train_voxels):.0f})",
            "eval_batches": self.eval_batches,
            "first_loss": f"{self.losses[0]:.6f}",
            "last_loss": f"{self.losses[-1]:.6f}",
        }


def read_records(run_dir: Path) -> list:
    return [json.loads(line) for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()]


def state_matches(trainer, saved: dict) -> list:
    """Names of the model and optimizer tensors of ``trainer`` that differ
    from a saved checkpoint payload, bit for bit."""
    bad = [k for k, v in trainer.model.state_dict().items()
           if not torch.equal(v.cpu(), saved["model"][k])]
    tx = trainer.state.tx.state_dict()
    for i, (group, want) in enumerate(zip(tx["groups"],
                                          saved["optimizer"]["groups"])):
        for key in set(group) | set(want):
            if len(group.get(key, [])) != len(want.get(key, [])) or not all(
                    torch.equal(a.cpu(), b) for a, b in zip(group[key],
                                                            want[key])):
                bad.append(f"optimizer/{i}/{key}")
    for key in ("count", "mini_step"):
        if tx[key] != saved["optimizer"][key]:
            bad.append(f"optimizer/{key}")
    if trainer.state.step != saved["step"]:
        bad.append("step")
    return bad


def loop_quick(cli, tmp: Path) -> None:
    """9a: ``conf/synthetic.yaml`` (the Quick start) for two epochs with an
    eval each, then one resumed epoch."""
    run_dir = tmp / "quick_run"
    args = ["--config", str(CONF / "synthetic.yaml"),
            f"data.root={tmp / 'quick_data'}", f"training.run_dir={run_dir}",
            "training.eval_frequency=1", "training.tensorboard=false"]
    zero_launches()
    with LoopProbe() as probe:
        cli.main(args + [f"training.epochs={QUICK_EPOCHS}"])
    launches = dict(seg.LAUNCHES)
    probe.check_steps("9a quick start")
    records = read_records(run_dir)
    if len(records) != QUICK_EPOCHS or not all("val_miou" in r
                                                for r in records):
        raise AssertionError(f"metrics.jsonl: {records}")
    for name in ("latest.pt", "best_val_miou.pt", "run.json", "best.json"):
        if not (run_dir / name).exists():
            raise AssertionError(f"{name} missing from the run dir")
    still = [k for k, p in probe.trainer.model.named_parameters()
             if torch.equal(p.detach(), probe.start[k])]
    if still:
        raise AssertionError(f"parameters that did not move: {still[:5]}")
    if not (launches["segment_csr"] > 0 and launches["segment_csr_bwd"] > 0):
        raise AssertionError(f"kernel launches did not rise: {launches}")
    log("9a quick start", model=probe.trainer.model.spec.backbone,
        params=sum(p.numel() for p in probe.trainer.model.parameters()),
        images=probe.train_images[0], **probe.summary(),
        val_miou="/".join(f"{r['val_miou']:.2f}" for r in records),
        launches=launches)

    saved = torch.load(run_dir / "latest.pt", map_location="cpu",
                       weights_only=True)
    restored = []

    def check_restored(trainer):
        restored.append(state_matches(trainer, saved))

    zero_launches()
    with LoopProbe(on_fit=check_restored) as resumed:
        cli.main(args + ["training.epochs=1", "training.resume=true"])
    resumed.check_steps("9a resume")
    if restored != [[]]:
        raise AssertionError(f"restored state differs from the saved one: "
                             f"{restored}")
    after = torch.load(run_dir / "latest.pt", map_location="cpu",
                       weights_only=True)["step"]
    if after != saved["step"] + len(resumed.losses):
        raise AssertionError(f"step {after} after resuming at "
                             f"{saved['step']} for {len(resumed.losses)} "
                             "steps")
    log("9a resume", restored_bit_equal=True, saved_step=saved["step"],
        steps=len(resumed.losses), step_after=after,
        launches=dict(seg.LAUNCHES))


def loop_recipe(cli, tmp: Path) -> tuple:
    """9b: ``conf/s3dis_benchmark.yaml`` on synthetic rooms: the recipe's
    model at its published widths, its batch, image slots and 2D size; then
    every sorted-segment call of the first train step's batch (forward in
    eval mode, backward in training mode, through the trained model) held
    against its plain version.  Returns the arguments of the run's first
    UNet graph build (for 13a)."""
    run_dir = tmp / "recipe_run"
    args = ["--config", str(CONF / "s3dis_benchmark.yaml"), *RECIPE_LOOP,
            f"data.root={tmp / 'recipe_data'}", f"training.run_dir={run_dir}",
            "training.tensorboard=false"]
    zero_launches()
    with LoopProbe() as probe, FirstGraph() as first_graph:
        cli.main(args)
    launches = dict(seg.LAUNCHES)
    probe.check_steps("9b recipe loop")
    spec = probe.trainer.model.spec
    (_, branch), = spec.branches
    if not (spec.backbone == "Res16UNet34" and branch.tower == "resnet18_l4"
            and branch.tower_deep_stem and branch.out_channels == 512
            and branch.num_groups == 4 and branch.fusion_mode == "concat"):
        raise AssertionError(f"not the recipe's model: {spec}")
    if any(shape[1:3] != RECIPE_IMAGE_SIZE for shape in probe.train_images):
        raise AssertionError(f"image batches {probe.train_images}")
    records = read_records(run_dir)
    if len(records) != 1 or "val_miou" not in records[0]:
        raise AssertionError(f"metrics.jsonl: {records}")
    # colour jitter runs on raw (uint8 or non-negative float) caches only
    from deepviewagg_tpu_torch.data.datasets.base import load_area

    area = load_area(str(tmp / "recipe_data" / "area_0.npz"))
    images = np.asarray(area["images"][:1])
    if not (images.dtype == np.uint8 or images.min() >= -0.01) \
            or "raw_pos" not in area:
        raise AssertionError(f"cache: images {images.dtype} min "
                             f"{images.min()}, keys {sorted(area)}")
    if not all(probe.augments.values()):
        raise AssertionError(f"augmentations not called: {probe.augments}")
    b = probe.bucket
    log("9b recipe loop", model=probe.trainer.run_config["model"]["name"],
        augments=probe.augments, cached_images=f"{images.dtype} "
        f"min={images.min():.3f} max={images.max():.3f}",
        raw_points=len(area["raw_pos"]), voxels=len(area["pos"]),
        params=sum(p.numel() for p in probe.trainer.model.parameters()),
        images=probe.train_images[0],
        bucket=f"levels={list(b.level_caps)} views={b.view_cap} "
               f"pix={b.pix_cap} imgs={b.image_cap}",
        **probe.summary(),
        launches_per_step=probe.step_launches[0], launches=launches,
        val_miou="/".join(f"{r['val_miou']:.2f}" for r in records))

    model, batch = probe.trainer.model, probe.batch
    del probe
    calls = record_segment_calls(model.eval(), batch)
    if len(calls) != FORWARD_LAUNCHES:
        raise AssertionError(f"{len(calls)} segment calls in one forward")
    check_forward_calls(calls, "9b recipe loop kernels",
                          "calls_per_forward")
    del calls
    bwd_calls = record_backward_calls(model.train(), batch)
    if len(bwd_calls) != BACKWARD_LAUNCHES:
        raise AssertionError(f"{len(bwd_calls)} segment backwards in one "
                             "step")
    check_backward_calls(bwd_calls, "9b recipe loop kernels")
    del bwd_calls, model, batch
    return first_graph.args


class EvalProbe(Seams):
    """The seams of one ``cli.eval.main`` run, patched for that run only:
    every eval step (launches of each kernel), the model and the first eval
    batch as the step got them (``model``, ``batch``), the eval bucket
    (``bucket``), every vote added (cloud, size, ids and logits, copied),
    the vote accumulator and every full-resolution remap (raw and voted
    points; one prediction per raw point is checked)."""

    def __init__(self):
        super().__init__()
        self.step_launches, self.adds, self.remaps = [], [], []
        self.votes = self.model = self.batch = self.bucket = None

    def __enter__(self):
        from deepviewagg_tpu_torch.cli import eval as cli_eval
        from deepviewagg_tpu_torch.data.datasets import base

        probe = self

        def make_eval_step(original):
            def build(model, *args, **kwargs):
                step = original(model, *args, **kwargs)

                def run(state, batch, generator=None):
                    if probe.batch is None:
                        probe.model, probe.batch = model, batch
                    before = dict(seg.LAUNCHES)
                    out = step(state, batch, generator)
                    probe.step_launches.append(
                        {k: seg.LAUNCHES[k] - before[k] for k in before})
                    return out
                return run
            return build

        def votes(cls):
            class Recorded(cls):
                def __init__(self, *args, **kwargs):
                    super().__init__(*args, **kwargs)
                    probe.votes = self

                def add(self, cloud, size, ids, logits):
                    probe.adds.append((cloud, size, np.array(ids),
                                       np.array(logits, np.float32)))
                    super().add(cloud, size, ids, logits)

                def full_res_preds(self, cloud, vote_pos, raw_pos, **kwargs):
                    out = super().full_res_preds(cloud, vote_pos, raw_pos,
                                                 **kwargs)
                    if out.shape != (len(raw_pos),):
                        raise AssertionError(f"full_res_preds {out.shape} "
                                             f"for {len(raw_pos)} raw points")
                    probe.remaps.append(dict(
                        raw=len(raw_pos),
                        voted=int(self.preds(cloud)[1].sum())))
                    return out
            return Recorded

        def auto_bucket(original):
            def run(*args, **kwargs):
                probe.bucket = original(*args, **kwargs)
                return probe.bucket
            return run

        self._patch(cli_eval, "make_eval_step", make_eval_step)
        self._patch(cli_eval, "auto_bucket", auto_bucket)
        self._patch(cli_eval, "VoteAccumulator", votes)
        return self

    def run_logits(self, runs: int) -> list:
        """The logits of each voting run, concatenated in add order."""
        n = len(self.adds) // runs
        if not n or n * runs != len(self.adds):
            raise AssertionError(f"{len(self.adds)} adds over {runs} runs")
        return [np.concatenate([a[3] for a in self.adds[r * n:(r + 1) * n]])
                for r in range(runs)]

    def summary(self) -> dict:
        return {
            "batches": len(self.step_launches),
            "remaps": "/".join(f"{r['raw']}->{r['voted']}"
                               for r in self.remaps),
        }


def run_eval(cli_eval, args, device="cuda", forward=FORWARD_LAUNCHES):
    """``cli.eval.main(args)`` on ``device`` under an ``EvalProbe``, launch
    counts zeroed just before and read just after; every eval step checked
    for ``forward`` (6 by default) forward and no backward launches on the
    card.  Returns ``(metrics, probe, launches)``."""
    zero_launches()
    with EvalProbe() as probe:
        metrics = cli_eval.main([*args, "--device", device])
    launches = dict(seg.LAUNCHES)
    expect = ({"segment_csr": forward, "segment_csr_bwd": 0}
              if device == "cuda" else dict.fromkeys(seg.LAUNCHES, 0))
    bad = [d for d in probe.step_launches if d != expect]
    if not probe.step_launches or bad:
        raise AssertionError(f"eval: {len(probe.step_launches)} batches, "
                             f"launches {bad[:2]} (expected {expect})")
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"eval metrics {metrics}")
    return metrics, probe, launches


def check_doubled(probe, num_classes: int) -> float:
    """Two voting runs without dropout: the second run's logits are the
    first's bit for bit, so every count doubles and every vote doubles,
    exactly where one sphere holds the point and to float32 rounding of the
    reordered sums elsewhere; returns the largest such rounding."""
    from deepviewagg_tpu_torch.metrics.tracker import VoteAccumulator

    first, second = probe.run_logits(EVAL_VOTING_RUNS)
    if not np.array_equal(first, second):
        raise AssertionError("the second voting run's logits differ: "
                             f"{np.abs(first - second).max()}")
    single = VoteAccumulator(num_classes)
    for add in probe.adds[:len(probe.adds) // 2]:
        single.add(*add)
    worst = 0.0
    for cloud in single.clouds():
        v1, n1 = single.votes(cloud)
        v2, n2 = probe.votes.votes(cloud)
        once = n1 == 1
        if not (np.array_equal(n2, 2 * n1) and once.any()
                and np.array_equal(v2[once], 2 * v1[once])):
            raise AssertionError(f"{cloud}: votes of two runs are not twice "
                                 "one run's")
        err = float(np.abs(v2 - 2 * v1).max() / np.abs(v1).max())
        if err > VOTE_RTOL:
            raise AssertionError(f"{cloud}: votes off twice by {err}")
        worst = max(worst, err)
    return worst


def loop_eval(cli_eval, tmp: Path) -> None:
    """9c: ``cli.eval`` on 9b's run (the recipe's model at full width), its
    best-val-mIoU checkpoint, two voting runs and the full-resolution
    remap; then every sorted-segment call of one forward of the first eval
    batch (eval buckets sized from the eval data, images by coverage,
    ``center_roll``) held against its plain version."""
    metrics, probe, launches = run_eval(cli_eval, [
        "--run_dir", str(tmp / "recipe_run"), "--weight", "best_val_miou",
        "--voting_runs", str(EVAL_VOTING_RUNS), "--full_res"])
    for key in ("test_miou", "vote_miou", "full_res_miou"):
        if key not in metrics:
            raise AssertionError(f"{key} missing from {sorted(metrics)}")
    clouds = probe.votes.clouds()
    if not all(np.isfinite(probe.votes.votes(c)[0]).all() for c in clouds):
        raise AssertionError("non-finite votes")
    if len(probe.remaps) != len(clouds):
        raise AssertionError(f"{len(probe.remaps)} remaps, {len(clouds)} "
                             "clouds")
    worst = check_doubled(probe, probe.votes.num_classes)
    b = probe.bucket
    log("9c eval", voting_runs=EVAL_VOTING_RUNS, **probe.summary(),
        bucket=f"levels={list(b.level_caps)} views={b.view_cap} "
               f"pix={b.pix_cap} imgs={b.image_cap}",
        launches_per_batch=probe.step_launches[0],
        launches=launches, second_run_bit_equal=True,
        votes_twice_rel_err=f"{worst:.2e}",
        **{k: f"{v:.3f}" for k, v in metrics.items()})

    model, batch = probe.model, probe.batch
    del probe
    calls = record_segment_calls(model.eval(), batch)
    if len(calls) != FORWARD_LAUNCHES:
        raise AssertionError(f"{len(calls)} segment calls in one eval "
                             "forward")
    check_forward_calls(calls, "9c eval kernels", "calls_per_forward")
    del calls, model, batch


def loop_mc_dropout(cli_eval, tmp: Path) -> None:
    """9c': MC dropout on the card at the library level: 9a's run, its
    model built from ``dataclasses.replace(spec, head_dropout=0.5)`` with
    the run's weights (the zoo drops a ``head_dropout`` override, as the
    JAX package's does), three voting runs of ``cli.eval.vote`` (the CLI's
    voting loop) on one room, twice with the same seed."""
    from deepviewagg_tpu_torch.cli import train as cli_train
    from deepviewagg_tpu_torch.config.run import load_run_config
    from deepviewagg_tpu_torch.config.zoo import resolve_spec_from_cfg
    from deepviewagg_tpu_torch.data.datasets.base import (BatchLoader,
                                                          load_area)
    from deepviewagg_tpu_torch.metrics.tracker import SegmentationTracker
    from deepviewagg_tpu_torch.models.segmentation import build_model
    from deepviewagg_tpu_torch.train.checkpoint import CheckpointManager

    run_dir = tmp / "quick_run"
    cfg = load_run_config(None, [ONE_ROOM], base=json.loads(
        (run_dir / "run.json").read_text()))
    device = torch.device("cuda")
    ds = cli_train.build_dataset(cfg, train=False, device=device)
    spec = dataclasses.replace(
        resolve_spec_from_cfg(cfg.model, ds.num_classes), head_dropout=0.5)
    levels = sorted(dict(spec.branches))
    bucket = cli_train.auto_bucket(cfg, ds, levels)
    runs = []
    for _ in range(2):
        model = CheckpointManager(str(run_dir)).restore_variables(
            "latest", build_model(spec, device=device, seed=None))
        loader = BatchLoader(ds, bucket, cfg.data.batch_size, levels,
                             shuffle=False, conv0_kernel=spec.stem_kernel)
        zero_launches()
        with EvalProbe() as probe:
            votes = cli_eval.VoteAccumulator(ds.num_classes)
            cli_eval.vote(model, loader, MC_VOTING_RUNS, device,
                          SegmentationTracker(ds.num_classes, "test"), votes,
                          lambda cloud: len(load_area(cloud)["pos"]))
        expect = {"segment_csr": FORWARD_LAUNCHES, "segment_csr_bwd": 0}
        if any(d != expect for d in probe.step_launches):
            raise AssertionError(f"9c': launches {probe.step_launches[:2]}")
        runs.append(probe.run_logits(MC_VOTING_RUNS))
    first, again = runs
    if not all(np.isfinite(x).all() for x in first):
        raise AssertionError("non-finite MC-dropout logits")
    if not all(np.array_equal(a, b) for a, b in zip(first, again)):
        raise AssertionError("one seed did not repeat the MC-dropout runs")
    for i in range(MC_VOTING_RUNS):
        for j in range(i):
            if np.array_equal(first[i], first[j]):
                raise AssertionError(f"voting runs {j} and {i} are equal")
    log("9c' mc dropout", head_dropout=spec.head_dropout,
        voting_runs=MC_VOTING_RUNS, **probe.summary(),
        repeat_bit_equal=True, runs_differ=True,
        run_diff_max="/".join(f"{np.abs(first[i] - first[0]).max():.3f}"
                              for i in range(1, MC_VOTING_RUNS)))


def loop_eval_card_vs_cpu(cli_eval, tmp: Path) -> None:
    """9c'': 9a's run evaluated on the card and on the CPU (plain versions),
    one room, with the remap: argmax of the logits and the metrics to the
    bounds of phase 4."""
    args = ["--run_dir", str(tmp / "quick_run"), "--full_res", ONE_ROOM]
    card, card_probe, _ = run_eval(cli_eval, args, "cuda")
    cpu, cpu_probe, _ = run_eval(cli_eval, args, "cpu")
    a, b = card_probe.run_logits(1)[0], cpu_probe.run_logits(1)[0]
    agree = float((a.argmax(1) == b.argmax(1)).mean())
    worst = max(abs(card[k] - cpu[k]) / 100 for k in cpu)
    if sorted(card) != sorted(cpu) or agree < ARGMAX_AGREE \
            or worst > EVAL_METRIC_ATOL:
        raise AssertionError(f"eval card vs cpu: argmax {agree}, metrics "
                             f"{card} vs {cpu}")
    log("9c'' eval card vs cpu", voxels=len(a), argmax_agree=f"{agree:.5f}",
        logits_rel_err=f"{rel_err(torch.from_numpy(a), torch.from_numpy(b)):.3e}",
        metric_max_abs_diff=f"{worst:.5f}")


def loop_predict(tmp: Path) -> None:
    """9d: ``cli.predict`` with a 3D-only Res16UNet34 (full width) trained by
    ``cli.train`` on 9b's rooms at the recipe's 5 cm for one epoch of 8
    spheres, on one room's raw cloud written as ``.npz`` and as ``.ply``:
    equal labels, one per voxel."""
    from deepviewagg_tpu_torch.cli import predict as cli_predict
    from deepviewagg_tpu_torch.cli import train as cli_train
    from deepviewagg_tpu_torch.data import synthetic
    from deepviewagg_tpu_torch.data.transforms3d import quantize_cloud
    from deepviewagg_tpu_torch.utils.ply import read_ply, write_ply

    run_dir = tmp / "predict_run"
    cli_train.main(["--config", str(CONF / "s3dis_benchmark.yaml"),
                    *RECIPE_LOOP, f"data.root={tmp / 'recipe_data'}",
                    f"training.run_dir={run_dir}", "model.name=Res16UNet34",
                    f"data.samples_per_epoch={PREDICT_SPHERES}",
                    "training.epochs=1", "training.eval_frequency=2",
                    "training.tensorboard=false"])
    stored = json.loads((run_dir / "run.json").read_text())
    kw = stored["data"]["kwargs"]
    scene = synthetic.make_scene(seed=0, density=kw["density"],
                                 n_cameras=kw["n_cameras"],
                                 image_size=tuple(stored["data"]["image_size"]))
    rgb = np.round(scene.rgb * 255).astype(np.uint8)
    npz, ply = tmp / "room.npz", tmp / "room.ply"
    np.savez(npz, pos=scene.pos, rgb=rgb)
    write_ply(str(ply), {"x": scene.pos[:, 0], "y": scene.pos[:, 1],
                         "z": scene.pos[:, 2], "red": rgb[:, 0],
                         "green": rgb[:, 1], "blue": rgb[:, 2]})
    voxels = len(quantize_cloud({"pos": scene.pos},
                                stored["data"]["voxel_size"])["coords"])
    zero_launches()
    outs = [cli_predict.main(["--run_dir", str(run_dir), "--input", str(src),
                              "--output",
                              str(tmp / f"pred_{src.suffix[1:]}.ply")])
            for src in (npz, ply)]
    launches = dict(seg.LAUNCHES)
    labels = [read_ply(out)["label"] for out in outs]
    if not (np.array_equal(*labels) and len(labels[0]) == voxels):
        raise AssertionError(f"predict: {[len(x) for x in labels]} labels, "
                             f"{voxels} voxels, equal "
                             f"{np.array_equal(*labels)}")
    log("9d predict", model="Res16UNet34", raw_points=len(scene.pos),
        voxels=voxels, labels_equal=True,
        classes=len(np.unique(labels[0])), launches=launches)


def s3dis_panorama(pos, rgb, camera, rig, seed: int) -> np.ndarray:
    """``uint8 [H, W, 3]``: a smooth background with noise, each point's
    colour at its projected pixel (the nearest point wins), the static rig
    band at the bottom."""
    from deepviewagg_tpu_torch.core.cameras import project

    w, h = camera.size
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = (np.sin(x / (40.0 + seed))[..., None] * 50
           + np.cos(y / 23.0)[..., None] * 40 + 110
           + rng.normal(0, 6, (h, w, 3)).astype(np.float32))
    img = np.clip(img, 0, 255).astype(np.uint8)
    px, py, dist, valid = (t.numpy() for t in project(
        torch.from_numpy(pos), camera))
    order = np.argsort(-dist[valid], kind="stable")  # the nearest last
    xi = px[valid].astype(np.int64)[order]
    yi = py[valid].astype(np.int64)[order]
    img[yi, xi] = np.round(rgb[valid][order] * 255).astype(np.uint8)
    img[h - len(rig):] = rig
    return img


def write_s3dis_layout(root: Path) -> dict:
    """The 9e layout (see ``S3DIS_AREAS``); returns the raw points per area
    (``raw``)."""
    from deepviewagg_tpu_torch.data import synthetic
    from deepviewagg_tpu_torch.utils.image_io import write_png

    w, h = S3DIS_PANORAMA
    filters = [r % 5 for r in range(h)]
    rig = np.random.default_rng(0).integers(0, 256, (S3DIS_RIG_ROWS, w, 3),
                                            dtype=np.uint8)
    raw = {}
    for area, rooms in S3DIS_AREAS.items():
        area_dir = root / f"Area_{area}"
        pose_dir, rgb_dir = area_dir / "data" / "pose", area_dir / "data" / "rgb"
        pose_dir.mkdir(parents=True)
        rgb_dir.mkdir(parents=True)
        raw[area] = 0
        for r in range(rooms):
            scene = synthetic.make_scene(seed=10 * area + r,
                                         density=S3DIS_DENSITY,
                                         n_cameras=S3DIS_PANORAMAS,
                                         image_size=S3DIS_PANORAMA)
            shift = np.array([8.0 * r, 0.0, 0.0], np.float32)
            pos = (scene.pos + shift).astype(np.float32)
            room = f"office_{r + 1}"
            ann = area_dir / room / "Annotations"
            ann.mkdir(parents=True)
            rgb255 = np.round(scene.rgb * 255).astype(np.float32)
            for label, name in enumerate(S3DIS_CLASS_NAMES):
                sel = scene.labels == label
                np.savetxt(ann / f"{name}_1.txt",
                           np.concatenate([pos[sel], rgb255[sel]], axis=1),
                           fmt="%.4f")
            raw[area] += len(pos)
            for i, cam in enumerate(scene.cameras):
                cam = dataclasses.replace(cam, pos=cam.pos + shift)
                stem = f"camera_{i}_{room}"
                (pose_dir / f"{stem}_pose.json").write_text(json.dumps({
                    "camera_location": [float(v) for v in cam.pos],
                    "final_camera_rotation": [float(v) for v in cam.opk]}))
                img = s3dis_panorama(pos, scene.rgb, cam, rig, seed=i)
                write_png(str(rgb_dir / f"{stem}_rgb.png"), img,
                          filters=filters, level=1)
    return {"raw": raw}


def check_s3dis_caches(root: Path, layout: dict) -> dict:
    """Each area's cache: exact mappings (at most one pixel per view), no
    mapped pixel on the static band, the raw cloud kept, uint8 panoramas at
    1024 x 512; returns the caches' sizes."""
    from deepviewagg_tpu_torch.data.datasets.base import load_area

    sizes = {}
    for area, rooms in S3DIS_AREAS.items():
        cache = load_area(str(root / "processed_dva" / f"area_{area}.npz"))
        m, images = cache["mapping"], cache["images"]
        per_view = np.bincount(m.pix_view[m.pix_valid])
        # the band after the 2x resize, but its first row: that one's
        # filter still reads a row above the band
        band = RECIPE_IMAGE_SIZE[1] - S3DIS_RIG_ROWS // 2 + 1
        n_img = rooms * S3DIS_PANORAMAS
        if per_view.max() != 1:
            raise AssertionError(f"area {area}: {per_view.max()} pixels in "
                                 "one exact view")
        if m.pix_y[m.pix_valid].max() >= band:
            raise AssertionError(f"area {area}: a pixel on the static band")
        if images.shape != (n_img, *RECIPE_IMAGE_SIZE, 3) \
                or images.dtype != np.uint8:
            raise AssertionError(f"area {area}: images {images.shape} "
                                 f"{images.dtype}")
        if len(cache["raw_pos"]) != layout["raw"][area]:
            raise AssertionError(f"area {area}: {len(cache['raw_pos'])} raw "
                                 f"points, {layout['raw'][area]} written")
        log("9e s3dis preprocess", area=area, rooms=rooms, panoramas=n_img,
            raw_points=len(cache["raw_pos"]), voxels=len(cache["pos"]),
            views=int(m.view_valid.sum()),
            mapped_pixels=int(m.pix_valid.sum()))
        sizes[area] = len(cache["raw_pos"])
    return sizes


def s3dis_zbuffer_card_vs_cpu(root: Path) -> None:
    """One camera's exact z-buffer over the eval area's voxels on the card
    and on the CPU (plain torch both): the same winner on >= 99.9% of the
    pixels either one sees (ties of float ``dist`` may break apart)."""
    from deepviewagg_tpu_torch.core.visibility import splat_zbuffer_batch
    from deepviewagg_tpu_torch.data.datasets import s3dis
    from deepviewagg_tpu_torch.data.datasets.base import load_area

    pos = load_area(str(root / "processed_dva" / "area_5.npz"))["pos"]
    cam = s3dis.area_cameras(str(root / "Area_5"),
                             RECIPE_IMAGE_SIZE)[0]["camera"]
    a, b = (splat_zbuffer_batch([cam], torch.as_tensor(pos, device=d),
                                voxel=0.05, exact=True)[0][0].cpu().numpy()
            for d in ("cuda", "cpu"))
    seen = (a >= 0) | (b >= 0)
    agree = float((a == b)[seen].mean())
    log("9e s3dis zbuffer card vs cpu", voxels=len(pos),
        image=f"{RECIPE_IMAGE_SIZE[0]}x{RECIPE_IMAGE_SIZE[1]}",
        seen_pixels=int(seen.sum()), agree=f"{agree:.5f}")
    if agree < ZBUFFER_AGREE:
        raise AssertionError(f"exact z-buffer card vs cpu: {agree}")


def loop_s3dis(cli, cli_eval, tmp: Path) -> None:
    """9e: ``cli.train`` with ``conf/s3dis_benchmark.yaml`` on the S3DIS
    raw layout (the recipe's model at its published widths; the areas
    preprocessed with exact splatting and the non-static mask), the first
    train batch's segment calls held against their plain versions, one
    exact z-buffer card vs CPU, then ``cli.eval --voting_runs 2
    --full_res``."""
    root = tmp / "s3dis_raw"
    layout = write_s3dis_layout(root)
    log("9e s3dis layout", areas=dict(S3DIS_AREAS),
        panoramas=f"{S3DIS_PANORAMAS} a room, {S3DIS_PANORAMA[0]}x"
                  f"{S3DIS_PANORAMA[1]}, rows cycling filters 0-4",
        raw_points=layout["raw"])
    run_dir = tmp / "s3dis_run"
    args = ["--config", str(CONF / "s3dis_benchmark.yaml"),
            f"data.root={root}", f"training.run_dir={run_dir}",
            "training.tensorboard=false", *S3DIS_LOOP]
    zero_launches()
    with LoopProbe() as probe:
        cli.main(args)
    launches = dict(seg.LAUNCHES)
    probe.check_steps("9e s3dis loop")
    spec = probe.trainer.model.spec
    (_, branch), = spec.branches
    if not (spec.backbone == "Res16UNet34" and branch.tower == "resnet18_l4"
            and branch.tower_deep_stem and branch.out_channels == 512
            and spec.num_classes == 13):
        raise AssertionError(f"not the recipe's model: {spec}")
    if any(shape[1:3] != RECIPE_IMAGE_SIZE for shape in probe.train_images):
        raise AssertionError(f"image batches {probe.train_images}")
    if not all(probe.augments.values()):
        raise AssertionError(f"augmentations not called: {probe.augments}")
    records = read_records(run_dir)
    if len(records) != 1 or "val_miou" not in records[0]:
        raise AssertionError(f"metrics.jsonl: {records}")
    raw = check_s3dis_caches(root, layout)
    b = probe.bucket
    log("9e s3dis loop", params=sum(
        p.numel() for p in probe.trainer.model.parameters()),
        augments=probe.augments, images=probe.train_images[0],
        bucket=f"levels={list(b.level_caps)} views={b.view_cap} "
               f"pix={b.pix_cap} imgs={b.image_cap}",
        **probe.summary(),
        launches_per_step=probe.step_launches[0], launches=launches,
        val_miou=f"{records[0]['val_miou']:.2f}")

    model, batch = probe.trainer.model, probe.batch
    del probe
    calls = record_segment_calls(model.eval(), batch)
    if len(calls) != FORWARD_LAUNCHES:
        raise AssertionError(f"{len(calls)} segment calls in one forward")
    check_forward_calls(calls, "9e s3dis loop kernels",
                          "calls_per_forward")
    del calls
    bwd_calls = record_backward_calls(model.train(), batch)
    if len(bwd_calls) != BACKWARD_LAUNCHES:
        raise AssertionError(f"{len(bwd_calls)} segment backwards in one "
                             "step")
    check_backward_calls(bwd_calls, "9e s3dis loop kernels")
    del bwd_calls, model, batch
    torch.cuda.empty_cache()
    s3dis_zbuffer_card_vs_cpu(root)

    metrics, probe, eval_launches = run_eval(cli_eval, [
        "--run_dir", str(run_dir), "--voting_runs", str(EVAL_VOTING_RUNS),
        "--full_res"])
    for key in ("test_miou", "vote_miou", "full_res_miou"):
        if key not in metrics:
            raise AssertionError(f"{key} missing from {sorted(metrics)}")
    if [r["raw"] for r in probe.remaps] != [raw[5]]:
        raise AssertionError(f"remaps {probe.remaps}: Area_5 holds {raw[5]} "
                             "raw points")
    worst = check_doubled(probe, probe.votes.num_classes)
    b = probe.bucket
    log("9e s3dis eval", voting_runs=EVAL_VOTING_RUNS, **probe.summary(),
        bucket=f"levels={list(b.level_caps)} views={b.view_cap} "
               f"pix={b.pix_cap} imgs={b.image_cap}",
        launches_per_batch=probe.step_launches[0], launches=eval_launches,
        votes_twice_rel_err=f"{worst:.2e}",
        **{k: f"{v:.3f}" for k, v in metrics.items()})

    # the eval bucket is sized from Area_5, not from the train bucket
    model, batch = probe.model, probe.batch
    del probe
    calls = record_segment_calls(model.eval(), batch)
    if len(calls) != FORWARD_LAUNCHES:
        raise AssertionError(f"{len(calls)} segment calls in one eval "
                             "forward")
    check_forward_calls(calls, "9e s3dis eval kernels",
                          "calls_per_forward")
    del calls, model, batch


def scannet_frame(pos, rgb, camera, seed: int) -> np.ndarray:
    """``uint8 [H, W, 3]``: smooth shading, each point's colour on the 2 x 2
    pixels at its projection (the nearest point wins)."""
    from deepviewagg_tpu_torch.core.cameras import project

    w, h = camera.size
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([np.sin(x / (45.0 + seed)) * 40 + 120,
                    np.cos(y / 37.0) * 35 + 110,
                    (x + y) * (60.0 / (w + h)) + 90], axis=-1)
    px, py, dist, valid = (t.numpy() for t in project(
        torch.from_numpy(pos), camera))
    order = np.argsort(-dist[valid], kind="stable")  # the nearest last
    xi = px[valid].astype(np.int64)[order]
    yi = py[valid].astype(np.int64)[order]
    col = rgb[valid][order] * 255
    for dy in (0, 1):
        for dx in (0, 1):
            img[np.minimum(yi + dy, h - 1), np.minimum(xi + dx, w - 1)] = col
    return np.clip(img, 0, 255).astype(np.uint8)


def write_scannet_layout(root: Path) -> dict:
    """The 9f layout (see ``SCANNET_SCANS``); returns the vertices per scan
    (``vertices``)."""
    from deepviewagg_tpu_torch.data import synthetic
    from deepviewagg_tpu_torch.utils.image_io import write_jpeg
    from deepviewagg_tpu_torch.utils.ply import write_ply

    vertices = {}
    for s, scan in enumerate(SCANNET_SCANS):
        d = root / "scans" / scan
        for sub in ("pose", "color", "intrinsic"):
            (d / sub).mkdir(parents=True)
        scene = synthetic.make_scene(
            seed=30 + s, room=SCANNET_ROOM, density=SCANNET_DENSITY,
            n_cameras=SCANNET_FRAMES, camera_model="scannet",
            image_size=SCANNET_NATIVE)
        pos = scene.pos.astype(np.float32)
        rgb = np.round(scene.rgb * 255).astype(np.uint8)
        write_ply(str(d / f"{scan}_vh_clean_2.ply"), {
            "x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2],
            "red": rgb[:, 0], "green": rgb[:, 1], "blue": rgb[:, 2]})
        write_ply(str(d / f"{scan}_vh_clean_2.labels.ply"), {
            "x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2],
            "label": np.asarray(SCANNET_NYU40, np.uint16)[scene.labels]})
        vertices[scan] = len(pos)
        for i, cam in enumerate(scene.cameras):
            for j in range(SCANNET_FRAME_STEP):
                # every exported frame has a pose; colour only at the kept
                np.savetxt(d / "pose" / f"{i * SCANNET_FRAME_STEP + j}.txt",
                           cam.extrinsic)
            img = scannet_frame(pos, scene.rgb, cam, seed=i)
            write_jpeg(str(d / "color" / f"{i * SCANNET_FRAME_STEP}.jpg"),
                       img)
        np.savetxt(d / "intrinsic" / "intrinsic_color.txt",
                   np.asarray(scene.cameras[0].intrinsic, np.float32))
    for split in ("train", "val"):
        (root / f"scannetv2_{split}.txt").write_text("".join(
            f"{scan}\n" for scan, sp in SCANNET_SCANS.items() if sp == split))
    return {"vertices": vertices}


def check_scannet_caches(root: Path, layout: dict) -> dict:
    """Each scan's cache: 8 uint8 frames of 320 x 240 (the coverage
    selection ran), a mapping with views and pixels; returns the caches'
    voxel counts."""
    from deepviewagg_tpu_torch.data.datasets.base import load_area

    sizes = {}
    for scan in SCANNET_SCANS:
        cache = load_area(str(root / "processed_dva" / f"{scan}.npz"))
        m, images = cache["mapping"], cache["images"]
        m.check()
        if images.shape != (8, *SCANNET_IMAGE_SIZE, 3) \
                or images.dtype != np.uint8 or m.num_images != 8:
            raise AssertionError(f"{scan}: images {images.shape} "
                                 f"{images.dtype}, {m.num_images} in the "
                                 "mapping")
        if not (m.view_valid.sum() > 0 and m.pix_valid.sum() > 0):
            raise AssertionError(f"{scan}: an empty mapping")
        log("9f scannet preprocess", scan=scan,
            vertices=layout["vertices"][scan], voxels=len(cache["pos"]),
            frames=f"{SCANNET_FRAMES} kept of "
                   f"{SCANNET_FRAMES * SCANNET_FRAME_STEP} poses, 8 after "
                   "coverage",
            views=int(m.view_valid.sum()),
            mapped_pixels=int(m.pix_valid.sum()))
        sizes[scan] = len(cache["pos"])
    return sizes


def check_submission(sub: Path, sizes: dict) -> dict:
    """One ``<scan>.txt`` per val scan, one benchmark NYU40 id per line, as
    many lines as the scan's voted (voxel) cloud."""
    from deepviewagg_tpu_torch.data.datasets.scannet import VALID_CLASS_IDS

    val = [s for s, sp in SCANNET_SCANS.items() if sp == "val"]
    files = sorted(p.name for p in sub.iterdir())
    if files != [f"{s}.txt" for s in val]:
        raise AssertionError(f"submission files {files}, val scans {val}")
    lines = {}
    for scan in val:
        ids = np.loadtxt(sub / f"{scan}.txt", dtype=np.int64, ndmin=1)
        if len(ids) != sizes[scan] or not set(ids.tolist()) <= set(
                VALID_CLASS_IDS):
            raise AssertionError(f"{scan}.txt: {len(ids)} lines for "
                                 f"{sizes[scan]} voxels, ids "
                                 f"{sorted(set(ids.tolist()))[:8]}")
        lines[scan] = len(ids)
    return lines


def loop_scannet(cli, cli_eval, tmp: Path) -> None:
    """9f: ``cli.train`` with ``conf/scannet_benchmark.yaml`` on the ScanNet
    layout (the recipe's model at its published widths: Res16UNet34, the
    512-d ``resnet18_l4`` tower, group-4 pool, concat early fusion; batch
    4, 6 image slots of 320 x 240), the first train batch's segment calls
    held against their plain versions, then ``cli.eval --voting_runs 2
    --submission`` and its first batch's calls."""
    root = tmp / "scannet_raw"
    layout = write_scannet_layout(root)
    log("9f scannet layout", scans=dict(SCANNET_SCANS),
        vertices=layout["vertices"],
        frames=f"{SCANNET_FRAMES} a scan of {SCANNET_NATIVE[0]}x"
               f"{SCANNET_NATIVE[1]}, poses {SCANNET_FRAMES * SCANNET_FRAME_STEP}")
    run_dir = tmp / "scannet_run"
    args = ["--config", str(CONF / "scannet_benchmark.yaml"),
            f"data.root={root}", f"training.run_dir={run_dir}",
            "training.tensorboard=false", *SCANNET_LOOP]
    log("9f scannet cuts", scans="4 (ScanNet v2: 1,513)",
        vertices="~1e5 a scan (a _vh_clean_2.ply's order)",
        frames="12 kept a scan, max_images 8 (recipe 40)",
        epochs="1 of 24 spheres (recipe 200 of 2000), no eval in training "
               "(eval_frequency 5 as written)",
        run_dir="temporary", tensorboard="off",
        widths="none cut", batch="4 as written", frames_size="320x240")
    zero_launches()
    with LoopProbe() as probe:
        cli.main(args)
    launches = dict(seg.LAUNCHES)
    probe.check_steps("9f scannet loop")
    spec = probe.trainer.model.spec
    (_, branch), = spec.branches
    if not (spec.backbone == "Res16UNet34" and branch.tower == "resnet18_l4"
            and branch.out_channels == 512 and branch.num_groups == 4
            and branch.fusion_mode == "concat" and spec.num_classes == 20):
        raise AssertionError(f"not the recipe's model: {spec}")
    if any(shape[:3] != (24, *SCANNET_IMAGE_SIZE)
           for shape in probe.train_images):
        raise AssertionError(f"image batches {probe.train_images}")
    if not (probe.augments["draw_color_jitter"]
            and probe.augments[JITTER_APPLIED]):
        raise AssertionError(f"colour jitter not drawn and applied: "
                             f"{probe.augments}")
    sizes = check_scannet_caches(root, layout)
    b = probe.bucket
    log("9f scannet loop", params=sum(
        p.numel() for p in probe.trainer.model.parameters()),
        augments=probe.augments, images=probe.train_images[0],
        bucket=f"levels={list(b.level_caps)} views={b.view_cap} "
               f"pix={b.pix_cap} imgs={b.image_cap}",
        **probe.summary(),
        launches_per_step=probe.step_launches[0], launches=launches)

    model, batch = probe.trainer.model, probe.batch
    del probe
    calls = record_segment_calls(model.eval(), batch)
    if len(calls) != FORWARD_LAUNCHES:
        raise AssertionError(f"{len(calls)} segment calls in one forward")
    check_forward_calls(calls, "9f scannet loop kernels",
                          "calls_per_forward")
    del calls
    bwd_calls = record_backward_calls(model.train(), batch)
    if len(bwd_calls) != BACKWARD_LAUNCHES:
        raise AssertionError(f"{len(bwd_calls)} segment backwards in one "
                             "step")
    check_backward_calls(bwd_calls, "9f scannet loop kernels")
    del bwd_calls, model, batch
    torch.cuda.empty_cache()

    sub = tmp / "scannet_submission"
    metrics, probe, eval_launches = run_eval(cli_eval, [
        "--run_dir", str(run_dir), "--voting_runs", str(EVAL_VOTING_RUNS),
        "--submission", str(sub)])
    lines = check_submission(sub, sizes)
    worst = check_doubled(probe, probe.votes.num_classes)
    b = probe.bucket
    log("9f scannet eval", voting_runs=EVAL_VOTING_RUNS, **probe.summary(),
        bucket=f"levels={list(b.level_caps)} views={b.view_cap} "
               f"pix={b.pix_cap} imgs={b.image_cap}",
        launches_per_batch=probe.step_launches[0], launches=eval_launches,
        votes_twice_rel_err=f"{worst:.2e}", submission_lines=lines,
        **{k: f"{v:.3f}" for k, v in metrics.items()})

    model, batch = probe.model, probe.batch
    del probe
    calls = record_segment_calls(model.eval(), batch)
    if len(calls) != FORWARD_LAUNCHES:
        raise AssertionError(f"{len(calls)} segment calls in one eval "
                             "forward")
    check_forward_calls(calls, "9f scannet eval kernels",
                          "calls_per_forward")
    del calls, model, batch


# --- 9g: KITTI-360 ----------------------------------------------------------

# the release's calibration files (perspective.txt's calib_time line and the
# fisheyes' YAML form included); camera axes in the vehicle frame: cam0
# looks along +x, cam2 (left fisheye) along +y, cam3 (right) along -y;
# image y is down
KITTI360_PERSPECTIVE = (
    "calib_time: 09-Jan-2012 14:00:15\n"
    "S_rect_00: 1.408000e+03 3.760000e+02\n"
    "R_rect_00: 9.999974e-01 -7.253732e-04 -2.195405e-03 7.102433e-04 "
    "9.999894e-01 -4.462649e-03 2.198609e-03 4.461186e-03 9.999876e-01\n"
    "P_rect_00: 5.525500e+02 0.000000e+00 6.820500e+02 0.000000e+00 "
    "0.000000e+00 5.525500e+02 2.387700e+02 0.000000e+00 0.000000e+00 "
    "0.000000e+00 1.000000e+00 0.000000e+00\n")
KITTI360_FISHEYE_YAML = (
    "%YAML:1.0\n---\nmodel_type: MEI\ncamera_name: image_0{cam}\n"
    "image_width: 1400\nimage_height: 1400\nmirror_parameters:\n"
    "   xi: 2.2134047507854890e+00\ndistortion_parameters:\n"
    "   k1: 1.6798235660113681e-02\n   k2: 1.6548773243373522e+00\n"
    "   p1: 4.2223943394772046e-04\n   p2: 4.2462134260997584e-04\n"
    "projection_parameters:\n   gamma1: 1.3363220825849971e+03\n"
    "   gamma2: 1.3357883350012958e+03\n   u0: 7.1694323510126321e+02\n"
    "   v0: 7.0576498308221585e+02\n")
KITTI360_AXES = {
    0: ((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0)),
    2: ((1.0, 0.0, 0.0), (0.0, 0.0, 1.0), (0.0, -1.0, 0.0)),
    3: ((-1.0, 0.0, 0.0), (0.0, 0.0, -1.0), (0.0, -1.0, 0.0)),
}
KITTI360_CAM_OFFSET = {0: (1.5, 0.0, 0.0), 2: (0.8, 0.5, 0.1),
                       3: (0.8, -0.5, 0.1)}


def kitti360_street(x0: float, x1: float, seed: int = 0):
    """The sequence's street along x over ``[x0, x1]`` at
    ``KITTI360_DENSITY`` points per m^2 of surface, 2 cm of noise: road
    (|y| < 3.5 m) and sidewalks to the facades at |y| = 7 m (8 m high), a
    parked car every 12 m on either side, a tree crown and a pole every
    15 m, low unlabelled clutter.  Returns ``(pos float32 [N, 3], rgb uint8
    [N, 3], KITTI-360 ids int32 [N])``."""
    rng = np.random.default_rng(seed)
    length, parts = x1 - x0, []

    def add(p, name, colour):
        parts.append((p, KITTI360_IDS[name], colour))

    n = int(KITTI360_DENSITY * length * 14.0)
    g = rng.uniform((x0, -7.0, 0.0), (x1, 7.0, 0.0), (n, 3))
    road = np.abs(g[:, 1]) < 3.5
    add(g[road], "road", (80, 80, 85))
    add(g[~road], "sidewalk", (150, 140, 130))
    n = int(KITTI360_DENSITY * length * 8.0)
    for side, colour in ((-1.0, (200, 190, 160)), (1.0, (170, 120, 90))):
        f = rng.uniform((x0, 7.0 * side, 0.0), (x1, 7.0 * side, 8.0), (n, 3))
        add(f, "building", colour)
    for k, cx in enumerate(np.arange(x0 + 2.0, x1 - 4.0, 12.0)):
        side = 1.0 if k % 2 else -1.0
        n = int(KITTI360_DENSITY * 20.0)
        c = rng.uniform((cx, 1.8, 0.0), (cx + 4.2, 3.4, 1.5), (n, 3))
        face = rng.integers(0, 4, n)          # snap to a face of the box
        c[face == 0, 1] = 1.8
        c[face == 1, 2] = 1.5
        c[face == 2, 0] = cx
        c[face == 3, 0] = cx + 4.2
        c[:, 1] *= side
        add(c, "car", (30, 60, 160) if k % 3 else (160, 30, 30))
    for cx in np.arange(x0 + 6.0, x1, 15.0):
        n = int(KITTI360_DENSITY * 12.0)
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        add(d * 1.2 + (cx, 5.0, 4.0), "vegetation", (40, 140, 50))
        n = int(KITTI360_DENSITY * 3.0)
        a = rng.uniform(0, 2 * np.pi, n)
        pole = np.stack([cx + 3.0 + 0.1 * np.cos(a), -5.0 + 0.1 * np.sin(a),
                         rng.uniform(0, 6.0, n)], 1)
        add(pole, "pole", (110, 110, 110))
    n = int(KITTI360_DENSITY * length * 0.3)
    add(rng.uniform((x0, -7.0, 0.0), (x1, 7.0, 0.6), (n, 3)), "unlabelled",
        (120, 120, 120))
    pos = np.concatenate([p for p, _, _ in parts])
    pos = (pos + rng.normal(0.0, 0.02, pos.shape)).astype(np.float32)
    sem = np.concatenate([np.full(len(p), i, np.int32) for p, i, _ in parts])
    rgb = np.concatenate([
        np.clip(np.asarray(c, np.float64) + rng.normal(0, 12, (len(p), 3)),
                0, 255) for p, _, c in parts]).astype(np.uint8)
    return pos, rgb, sem


def kitti360_frame(pos_dev, rgb_dev, camera, body=None) -> np.ndarray:
    """``uint8 [H, W, 3]``: smooth shading, each point's colour on the 2 x 2
    pixels at its projection through ``camera`` (the nearest point wins),
    computed on the points' device; ``body`` rows at the bottom (the
    fisheyes' static band)."""
    from deepviewagg_tpu_torch.core.cameras import project

    w, h = camera.size
    dev = pos_dev.device
    y, x = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                          torch.arange(w, device=dev, dtype=torch.float32),
                          indexing="ij")
    img = torch.stack([torch.sin(x / 53.0) * 40 + 120,
                       torch.cos(y / 41.0) * 35 + 110,
                       (x + y) * (60.0 / (w + h)) + 90], dim=-1)
    px, py, dist, valid = project(pos_dev, camera)
    order = torch.argsort(-dist[valid], stable=True)    # the nearest last
    xi = px[valid].long()[order]
    yi = py[valid].long()[order]
    col = rgb_dev[valid][order]
    for dy in (0, 1):
        for dx in (0, 1):
            img[torch.clamp(yi + dy, max=h - 1),
                torch.clamp(xi + dx, max=w - 1)] = col
    out = img.clamp(0, 255).to(torch.uint8).cpu().numpy()
    if body is not None:
        out[h - len(body):] = body
    return out


def kitti360_filters(h: int) -> np.ndarray:
    """The PNG row filters of 9g: Up, but for one row in 50 each of None,
    Sub, Avg and Paeth."""
    r = np.arange(h) % 50
    return np.select([r == 0, r == 1, r == 2, r == 3], [0, 1, 3, 4], 2)


def write_kitti360_layout(root: Path, device="cuda") -> dict:
    """The 9g layout (see ``KITTI360_WINDOWS``), its frames rendered on
    ``device``; returns the points per window (``points``) and the number
    of frames (``frames``)."""
    from deepviewagg_tpu_torch.core.cameras import Camera
    from deepviewagg_tpu_torch.utils.image_io import write_png
    from deepviewagg_tpu_torch.utils.ply import write_ply

    x_end = KITTI360_FRAMES[-1] * KITTI360_SPEED + KITTI360_AHEAD
    pos, rgb, sem = kitti360_street(-KITTI360_BEHIND, x_end + 10.0)
    rng = np.random.default_rng(1)
    static = root / "data_3d_semantics" / KITTI360_SEQ / "static"
    static.mkdir(parents=True)
    points = {}
    for name in KITTI360_WINDOWS:
        start, end = (int(v) * KITTI360_SPEED for v in name.split("_"))
        sel = ((pos[:, 0] >= start - KITTI360_BEHIND)
               & (pos[:, 0] <= end + KITTI360_AHEAD))
        n = int(sel.sum())
        write_ply(str(static / f"{name}.ply"), {
            "x": pos[sel, 0], "y": pos[sel, 1], "z": pos[sel, 2],
            "red": rgb[sel, 0], "green": rgb[sel, 1], "blue": rgb[sel, 2],
            "semantic": sem[sel],
            "instanceId": (sem[sel] * 1000 + rng.integers(0, 9, n)).astype(
                np.int32),
            "isVisible": np.ones(n, np.uint8),
            "confidence": rng.uniform(0.5, 1.0, n).astype(np.float32)})
        points[name] = n
    lists = root / "data_3d_semantics" / "train"
    lists.mkdir()
    for split in ("train", "val"):
        (lists / f"2013_05_28_drive_{split}.txt").write_text("".join(
            f"data_3d_semantics/{KITTI360_SEQ}/static/{name}.ply\n"
            for name, sp in KITTI360_WINDOWS.items() if sp == split))
    calib = root / "calibration"
    calib.mkdir()
    (calib / "perspective.txt").write_text(KITTI360_PERSPECTIVE)
    lines = []
    for cam in (0, 1, 2, 3):
        m = np.zeros((3, 4))
        m[:, :3] = np.array(KITTI360_AXES.get(cam, KITTI360_AXES[0])).T
        m[:, 3] = KITTI360_CAM_OFFSET.get(cam, (1.5, -0.6, 0.0))
        lines.append(f"image_0{cam}: " + " ".join(f"{v:.9f}" for v in m.flat))
        if cam in (2, 3):
            (calib / f"image_0{cam}.yaml").write_text(
                KITTI360_FISHEYE_YAML.format(cam=cam))
    (calib / "calib_cam_to_pose.txt").write_text("\n".join(lines) + "\n")
    poses = root / "data_poses" / KITTI360_SEQ
    poses.mkdir(parents=True)
    cam_rows, imu_rows, vehicles = [], [], {}
    for frame in KITTI360_FRAMES:
        vehicle = np.eye(4)
        vehicle[:3, 3] = (frame * KITTI360_SPEED, 0.0, 1.7)
        vehicles[frame] = vehicle
        cam0 = vehicle.copy()
        cam0[:3, :3] = np.array(KITTI360_AXES[0]).T
        cam0[:3, 3] += KITTI360_CAM_OFFSET[0]
        cam_rows.append([frame] + list(cam0.flatten()))
        imu_rows.append([frame] + list(vehicle[:3].flatten()))
    np.savetxt(poses / "cam0_to_world.txt", np.array(cam_rows))
    np.savetxt(poses / "poses.txt", np.array(imu_rows))

    # the frames, rendered through the loader's own cameras at native size
    from deepviewagg_tpu_torch.data.datasets import kitti360

    pos_dev = torch.from_numpy(pos).to(device)
    rgb_dev = torch.from_numpy(rgb.astype(np.float32)).to(device)
    body = np.random.default_rng(2).integers(
        0, 256, (KITTI360_BODY_ROWS, KITTI360_FISHEYE[0], 3), dtype=np.uint8)
    k = np.eye(4, dtype=np.float32)
    k[:3, :3] = kitti360.read_perspective_calib(str(
        calib / "perspective.txt"))["P_rect_00"].reshape(3, 4)[:, :3]
    cam0_to_world = kitti360.read_cam0_to_world(str(poses
                                                    / "cam0_to_world.txt"))
    frames = [(0, frame, Camera(
        model="kitti360_perspective", size=KITTI360_PINHOLE,
        extrinsic=cam0_to_world[frame], intrinsic=k, r_min=kitti360.R_MIN,
        r_max=kitti360.R_MAX)) for frame in KITTI360_FRAMES]
    for cam in (0, 2, 3):
        sub = "data_rect" if cam == 0 else "data_rgb"
        (root / "data_2d_raw" / KITTI360_SEQ / f"image_0{cam}" / sub).mkdir(
            parents=True)
    for cam in (2, 3):
        fe = kitti360.read_fisheye_calib(str(calib / f"image_0{cam}.yaml"))
        c2p = kitti360.read_cam_to_pose(
            str(calib / "calib_cam_to_pose.txt"))[f"image_0{cam}"]
        for frame in KITTI360_FRAMES:
            frames.append((cam, frame, Camera(
                model="kitti360_fisheye", size=KITTI360_FISHEYE,
                extrinsic=vehicles[frame].astype(np.float32) @ c2p,
                fisheye=fe, r_min=kitti360.R_MIN, r_max=kitti360.R_MAX)))
    for cam, frame, camera in frames:
        img = kitti360_frame(pos_dev, rgb_dev, camera,
                             body=None if cam == 0 else body)
        sub = "data_rect" if cam == 0 else "data_rgb"
        write_png(str(root / "data_2d_raw" / KITTI360_SEQ / f"image_0{cam}"
                      / sub / f"{frame:010d}.png"), img,
                  filters=kitti360_filters(img.shape[0]), level=1)
    return {"points": points, "frames": len(frames)}


def check_kitti360_caches(root: Path, layout: dict) -> dict:
    """Each window's cache: 30 uint8 frames kept of 33 candidates on one
    canvas of 704 x 350, both camera families, fisheye pixels inside 350 x
    350 and none on the vehicle's body; returns the caches' voxel counts by
    cache name."""
    from deepviewagg_tpu_torch.data.datasets.base import load_area

    sizes = {}
    canvas = (max(w for w, _ in KITTI360_FAMILIES),
              max(h for _, h in KITTI360_FAMILIES))
    for name in KITTI360_WINDOWS:
        start, end = (int(v) for v in name.split("_"))
        cache_name = f"{KITTI360_SEQ}_{start:010d}_{end:010d}"
        cache = load_area(str(root / "processed_dva" / f"{cache_name}.npz"))
        m, images, fam = cache["mapping"], cache["images"], cache[
            "image_family"]
        m.check()
        if (images.shape != (30, *canvas, 3) or images.dtype != np.uint8
                or m.num_images != 30 or set(fam.tolist()) != {0, 1}
                or cache["family_sizes"].tolist() != [
                    list(s) for s in KITTI360_FAMILIES]):
            raise AssertionError(f"{name}: images {images.shape} "
                                 f"{images.dtype}, families {fam.tolist()}")
        pv = np.minimum(m.pix_view, m.view_capacity - 1)
        pf = fam[m.image_id[pv]]
        fe = m.pix_valid & (pf == 1)
        fw, fh = KITTI360_FAMILIES[1]
        body = fh - KITTI360_BODY_ROWS * fh // KITTI360_FISHEYE[1]
        if not (fe.any() and m.pix_x[fe].max() < fw
                and m.pix_y[fe].max() < fh):
            raise AssertionError(f"{name}: fisheye pixels outside {fw}x{fh}")
        if (fe & (m.pix_y >= body + 1)).any():
            raise AssertionError(f"{name}: mapped pixels on the static body")
        log("9g kitti360 preprocess", window=name,
            points=layout["points"][name], voxels=len(cache["pos"]),
            images="30 kept of 33 (11 frame times x cam0, cam2, cam3)",
            kept_per_family=np.bincount(fam, minlength=2).tolist(),
            views=int(m.view_valid.sum()),
            mapped_pixels=int(m.pix_valid.sum()),
            fisheye_pixels=int(fe.sum()))
        sizes[cache_name] = len(cache["pos"])
    return sizes


def check_kitti360_submission(sub: Path, sizes: dict) -> dict:
    """``submission.zip`` holds one ``.npy`` of original KITTI-360 ids per
    val window, as many as the window's voted (voxel) cloud."""
    import io
    import zipfile

    from deepviewagg_tpu_torch.data.datasets.kitti360 import TRAINID2ID

    val = [f"{KITTI360_SEQ}_{int(s):010d}_{int(e):010d}" for s, e in (
        name.split("_") for name, sp in KITTI360_WINDOWS.items()
        if sp == "val")]
    lines = {}
    with zipfile.ZipFile(sub / "submission.zip") as z:
        members = z.namelist()
        if members != [f"{v}.npy" for v in val]:
            raise AssertionError(f"submission members {members}, val {val}")
        for v in val:
            ids = np.load(io.BytesIO(z.read(f"{v}.npy")))
            if (ids.dtype != np.uint8 or ids.shape != (sizes[v],)
                    or not set(ids.tolist()) <= set(TRAINID2ID.tolist())):
                raise AssertionError(f"{v}.npy: {ids.dtype} {ids.shape} for "
                                     f"{sizes[v]} voxels")
            lines[v] = len(ids)
    return lines


def loop_kitti360(cli, cli_eval, tmp: Path) -> None:
    """9g: ``cli.train`` with ``conf/kitti360_benchmark.yaml`` on the
    KITTI-360 layout (the recipe's model at its published widths: five
    deep-stem ResNet18 truncations pooled to 32 / 32 / 64 / 128 / 256 with
    group-4 attention, concatenated before the stem of a Res16UNet34, 19
    classes; batch 4, 4 image slots, 6 m cylinders at 5 cm, pinhole frames
    of 704 x 188 and fisheyes of 350 x 350 in two camera-family buckets),
    the first train batch's segment calls held against their plain
    versions, then ``cli.eval --voting_runs 2 --submission`` and its first
    batch's calls."""
    root = tmp / "kitti360_raw"
    layout = write_kitti360_layout(root)
    log("9g kitti360 layout", windows=dict(KITTI360_WINDOWS),
        points=layout["points"], frames=layout["frames"],
        sizes=f"cam0 {KITTI360_PINHOLE[0]}x{KITTI360_PINHOLE[1]}, cam2/cam3 "
              f"{KITTI360_FISHEYE[0]}x{KITTI360_FISHEYE[1]}",
        filters="Up, 1 row in 50 each None/Sub/Avg/Paeth")
    run_dir = tmp / "kitti360_run"
    args = ["--config", str(CONF / "kitti360_benchmark.yaml"),
            f"data.root={root}", f"training.run_dir={run_dir}",
            "training.tensorboard=false", *KITTI360_LOOP]
    log("9g kitti360 cuts", windows="3 (the release: about 300)",
        frames="11 frame times a window at frame_step 10, 33 candidates, "
               "max_images 30 as written",
        points=f"{KITTI360_DENSITY:.0f} a m^2 of surface (a release window "
               "holds millions of points)",
        epochs="1 of 24 cylinders (recipe 60 of 2000), no eval in training "
               "(eval_frequency 5 as written)",
        run_dir="temporary", tensorboard="off", widths="none cut",
        batch="4 as written", sizes="704x188 and 350x350 as written")
    zero_launches()
    with LoopProbe() as probe:
        cli.main(args)
    launches = dict(seg.LAUNCHES)
    probe.check_steps("9g kitti360 loop", KITTI360_FORWARD, KITTI360_BACKWARD)
    spec = probe.trainer.model.spec
    towers = [(b.tower, b.out_channels, b.tower_deep_stem, b.num_groups,
               b.fusion_mode) for _, b in spec.branches]
    if not (spec.backbone == "Res16UNet34" and spec.num_classes == 19
            and [lvl for lvl, _ in spec.branches] == [0] * 5
            and towers == [(f"resnet18_l{i}", c, True, 4, "concat")
                           for i, c in enumerate((32, 32, 64, 128, 256))]):
        raise AssertionError(f"not the recipe's model: {spec}")
    want = tuple((16, *s, 3) for s in KITTI360_FAMILIES)
    if any(len(shapes) != 2 or shapes[0][1:] != want[0][1:]
           or shapes[1][1:] != want[1][1:] for shapes in probe.train_images):
        raise AssertionError(f"image buckets {probe.train_images}")
    if not any(all(n > 0 for n in px) for px in probe.bucket_pixels):
        raise AssertionError("no batch holds both camera families: "
                             f"{probe.bucket_pixels}")
    if not (probe.augments["draw_color_jitter"]
            and probe.augments[JITTER_APPLIED]):
        raise AssertionError(f"colour jitter not drawn and applied: "
                             f"{probe.augments}")
    sizes = check_kitti360_caches(root, layout)
    b = probe.bucket
    fe_bucket = probe.batch["mappings"][0]["buckets"][1]
    fv = fe_bucket["pix_valid"]
    if not (bool((fe_bucket["pix_x"][fv] < KITTI360_FAMILIES[1][0]).all())
            and bool((fe_bucket["pix_y"][fv] < KITTI360_FAMILIES[1][1]).all())):
        raise AssertionError("fisheye bucket pixels outside 350x350")
    log("9g kitti360 loop", params=sum(
        p.numel() for p in probe.trainer.model.parameters()),
        augments=probe.augments, images=probe.train_images[0],
        bucket_pixels=probe.bucket_pixels,
        bucket=f"levels={list(b.level_caps)} views={b.view_cap} "
               f"pix={b.pix_cap} imgs={b.image_cap}",
        ladder=list(b.image_ladder), ladder_image_caps=b.ladder_image_caps,
        ladder_pix_caps=b.ladder_pix_caps, **probe.summary(),
        launches_per_step=probe.step_launches[0], launches=launches)

    model, batch = probe.trainer.model, probe.batch
    del probe
    calls = record_segment_calls(model.eval(), batch)
    if len(calls) != KITTI360_FORWARD:
        raise AssertionError(f"{len(calls)} segment calls in one forward")
    check_forward_calls(calls, "9g kitti360 loop kernels",
                          "calls_per_forward")
    del calls
    bwd_calls = record_backward_calls(model.train(), batch)
    if len(bwd_calls) != KITTI360_BACKWARD:
        raise AssertionError(f"{len(bwd_calls)} segment backwards in one "
                             "step")
    check_backward_calls(bwd_calls, "9g kitti360 loop kernels")
    del bwd_calls, model, batch
    torch.cuda.empty_cache()

    sub = tmp / "kitti360_submission"
    metrics, probe, eval_launches = run_eval(cli_eval, [
        "--run_dir", str(run_dir), "--voting_runs", str(EVAL_VOTING_RUNS),
        "--submission", str(sub)], forward=KITTI360_FORWARD)
    lines = check_kitti360_submission(sub, sizes)
    worst = check_doubled(probe, probe.votes.num_classes)
    b = probe.bucket
    log("9g kitti360 eval", voting_runs=EVAL_VOTING_RUNS, **probe.summary(),
        bucket=f"levels={list(b.level_caps)} views={b.view_cap} "
               f"pix={b.pix_cap} imgs={b.image_cap}",
        ladder_image_caps=b.ladder_image_caps,
        ladder_pix_caps=b.ladder_pix_caps,
        launches_per_batch=probe.step_launches[0], launches=eval_launches,
        votes_twice_rel_err=f"{worst:.2e}",
        submission=sorted(p.name for p in sub.iterdir()),
        submission_ids=lines,
        **{k: f"{v:.3f}" for k, v in metrics.items()})

    model, batch = probe.model, probe.batch
    del probe
    calls = record_segment_calls(model.eval(), batch)
    if len(calls) != KITTI360_FORWARD:
        raise AssertionError(f"{len(calls)} segment calls in one eval "
                             "forward")
    check_forward_calls(calls, "9g kitti360 eval kernels",
                          "calls_per_forward")
    del calls, model, batch


class FamilyProbe(Seams):
    """The seams of 9h's no3d train run: every value of the view-level loss
    and every mask the step's segmentation loss got, with the model's
    ``x_seen`` and the batch's valid mask of the same step."""

    def __init__(self):
        super().__init__()
        self.view_losses, self.masks = [], []

    def __enter__(self):
        from deepviewagg_tpu_torch.train import step

        probe = self

        def view_loss(original):
            def run(*args, **kwargs):
                out = original(*args, **kwargs)
                probe.view_losses.append(float(out.detach()))
                return out
            return run

        def seg_loss(original):
            def run(logits, labels, valid=None, *args, **kwargs):
                probe.masks.append(valid)
                return original(logits, labels, valid, *args, **kwargs)
            return run

        self._patch(step, "view_level_loss", view_loss)
        self._patch(step, "segmentation_loss", seg_loss)
        return self


class PropagateProbe(Seams):
    """The seam of one ``cli.eval.main`` run at ``propagate_unseen``: the
    first call's inputs and output, and the number of calls."""

    def __init__(self):
        super().__init__()
        self.first, self.calls = None, 0

    def __enter__(self):
        from deepviewagg_tpu_torch.cli import eval as cli_eval

        probe = self

        def propagate(original):
            def run(logits, pos, seen, *args, **kwargs):
                out = original(logits, pos, seen, *args, **kwargs)
                if probe.first is None:
                    probe.first = tuple(t.detach().cpu() for t in
                                        (logits, pos, seen, out))
                probe.calls += 1
                return out
            return run

        self._patch(cli_eval, "propagate_unseen", propagate)
        return self


def check_propagated(first) -> dict:
    """The first eval batch's propagation against a brute-force 1-NN on the
    CPU: seen points keep their logits; every unseen real point (padding
    sits 1e6 m away) takes the logits of a seen point at the least distance
    (within 1e-4 m^2: voxel grids hold equidistant neighbours)."""
    logits, pos, seen, out = first
    if not torch.equal(out[seen], logits[seen]):
        raise AssertionError("propagation moved a seen point's logits")
    real = pos.abs().max(1).values < 1e5
    q = ((~seen) & real).nonzero()[:, 0]
    worst = 0.0
    for chunk in q.split(256):
        d = ((pos[chunk, None, :].double() - pos[None, seen, :].double())
             ** 2).sum(-1)
        nearest = d <= d.min(1, keepdim=True).values + 1e-4
        same = (out[chunk][:, None, :] == logits[seen][None]).all(-1)
        if not bool((same & nearest).any(1).all()):
            raise AssertionError("an unseen point did not take its nearest "
                                 "seen point's logits")
        worst = max(worst, float(d.min(1).values.max()))
    return {"unseen_real_points": int(len(q)), "seen_points": int(seen.sum()),
            "real_points": int(real.sum()),
            "farthest_copy_m": f"{np.sqrt(worst):.3f}"}


def family_kernels(model, batch, phase: str, forward: int,
                   backward: int) -> None:
    """Every segment call of one forward (eval mode) and of one train-mode
    forward and backward of ``model`` on ``batch``, held against the plain
    versions; ``forward`` / ``backward`` calls expected."""
    calls = record_segment_calls(model.eval(), batch)
    if len(calls) != forward:
        raise AssertionError(f"{phase}: {len(calls)} segment calls in one "
                             f"forward, expected {forward}")
    check_forward_calls(calls, phase, "calls_per_forward")
    del calls
    bwd_calls = record_backward_calls(model.train(), batch)
    if len(bwd_calls) != backward:
        raise AssertionError(f"{phase}: {len(bwd_calls)} segment backwards "
                             f"in one step, expected {backward}")
    if backward:
        check_backward_calls(bwd_calls, phase)


def family_model(name: str, set_encoder, num_classes: int):
    from deepviewagg_tpu_torch.config.zoo import get_model_spec
    from deepviewagg_tpu_torch.models.segmentation import build_model

    spec = get_model_spec(name, num_classes, 4)
    if set_encoder:
        spec = dataclasses.replace(spec, branches=tuple(
            (lvl, dataclasses.replace(b, set_encoder=set_encoder))
            for lvl, b in spec.branches))
    return build_model(spec, device="cuda", seed=0)


def loop_families(cli, cli_eval, tmp: Path) -> None:
    """9h: the paper's other model families on the S3DIS layout of 9e (the
    recipe's flat batches: 4 spheres of 2 m at 5 cm, 16 panoramas of 1024 x
    512): (a) ``cli.train`` of the light no3d model with the view-level
    loss, then ``cli.eval --voting_runs 2`` with the unseen points'
    propagation checked on the first batch; (b) the same for the late
    feature-fusion model; (c) on (a)'s first batch, a forward and two train
    steps of each ``FAMILY_MODELS`` entry.  Every segment call of each
    model's first forward and backward is held against its plain
    version."""
    root = tmp / "s3dis_raw"
    if not (root / "Area_5").exists():
        write_s3dis_layout(root)
    log("9h families cuts", spheres=f"{FAMILY_SPHERES} a model, 1 epoch "
        "(recipe 200 x 2000)", steps_library="2 (one warm-up)",
        widths="none cut", batch="4 spheres x 4 image slots of 1024x512 "
        "as written", towers="as published")
    trained = {}
    for label, (name, fwd_n, bwd_n) in (("light", FAMILY_LIGHT),
                                        ("late_feature", FAMILY_LATE)):
        run_dir = tmp / f"family_{label}_run"
        args = ["--config", str(CONF / "s3dis_benchmark.yaml"),
                f"data.root={root}", f"model.name={name}",
                f"training.run_dir={run_dir}", "training.tensorboard=false",
                *FAMILY_LOOP]
        if label == "light":
            args.append("training.view_loss_weight=1.0")
        seen = []

        def on_fit(trainer):
            trainer.model.register_forward_hook(
                lambda m, a, o: seen.append((o["x_seen"].detach(),
                                             a[0]["graph"]["levels"][0]
                                             ["valid"])))

        zero_launches()
        with LoopProbe(on_fit) as probe, FamilyProbe() as fam:
            cli.main(args)
        launches = dict(seg.LAUNCHES)
        probe.check_steps(f"9h {label} loop", fwd_n, bwd_n)
        model, batch = probe.trainer.model, probe.batch
        spec = model.spec
        x_seen, valid = seen[0]
        unseen_share = 1.0 - float((x_seen & valid).sum()) / float(valid.sum())
        fields = {}
        if label == "light":
            (_, b), = spec.branches
            if not (spec.family == "no3d" and not spec.no3d_head
                    and b.tower == "scratch_unet" and b.view_pool == "mean"
                    and spec.num_classes == 13):
                raise AssertionError(f"not the light no3d model: {spec}")
            steps = len(probe.losses)
            if len(fam.view_losses) != steps or not all(
                    np.isfinite(v) and v > 0 for v in fam.view_losses):
                raise AssertionError(f"view losses {fam.view_losses} over "
                                     f"{steps} steps")
            for mask, (xs, v) in zip(fam.masks, seen):
                if not torch.equal(mask, xs & v):
                    raise AssertionError("the no3d loss took unseen points")
            fields = {"view_loss_first": f"{fam.view_losses[0]:.4f}",
                      "loss_mask": "valid & x_seen on every step"}
        elif spec.family != "late_feature":
            raise AssertionError(f"not the late feature model: {spec}")
        log(f"9h {label} loop", model=name, params=sum(
            p.numel() for p in model.parameters()), **probe.summary(),
            launches_per_step=probe.step_launches[0], launches=launches,
            unseen_share_first_batch=f"{unseen_share:.4f}", **fields)
        family_kernels(model, batch, f"9h {label} kernels", fwd_n, bwd_n)
        if label == "light":
            trained["batch"] = batch
        del model, probe
        torch.cuda.empty_cache()

        with PropagateProbe() as prop:
            metrics, eprobe, eval_launches = run_eval(cli_eval, [
                "--run_dir", str(run_dir), "--voting_runs",
                str(EVAL_VOTING_RUNS)], forward=fwd_n)
        checked = {}
        if label == "light":
            if prop.calls != len(eprobe.step_launches):
                raise AssertionError(f"{prop.calls} propagations for "
                                     f"{len(eprobe.step_launches)} eval "
                                     "batches")
            checked = check_propagated(prop.first)
        elif prop.calls:
            raise AssertionError("a late model's eval propagated")
        log(f"9h {label} eval", voting_runs=EVAL_VOTING_RUNS,
            **eprobe.summary(), launches_per_batch=eprobe.step_launches[0],
            launches=eval_launches, **checked,
            **{k: f"{v:.3f}" for k, v in metrics.items()})
        del eprobe
        torch.cuda.empty_cache()

    batch = trained["batch"]
    valid = batch["graph"]["levels"][0]["valid"]
    n = int(valid.sum())
    for label, name, set_encoder, fwd_n, bwd_n in FAMILY_MODELS:
        phase = f"9h {label}"
        model = family_model(name, set_encoder, 13)
        zero_launches()
        with torch.no_grad():
            first = model.eval()(batch)
        fwd_launches = dict(seg.LAUNCHES)
        if fwd_launches != {"segment_csr": fwd_n, "segment_csr_bwd": 0}:
            raise AssertionError(f"{phase}: forward launches {fwd_launches}")
        logits = first["logits"][valid]
        if logits.shape != (n, 13) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{phase}: logits {tuple(logits.shape)}")
        unseen = 1.0 - float((first["x_seen"] & valid).sum()) / n
        losses = run_steps(model, batch, 2, phase,
                           {"segment_csr": fwd_n, "segment_csr_bwd": bwd_n})
        family_kernels(model, batch, f"{phase} kernels", fwd_n, bwd_n)
        log(phase, model=name, set_encoder=set_encoder or "default",
            params=sum(p.numel() for p in model.parameters()),
            launches_per_forward=fwd_n, launches_per_step=(fwd_n, bwd_n),
            unseen_share_first_batch=f"{unseen:.4f}",
            losses="/".join(f"{x:.4f}" for x in losses))
        del model, first
        torch.cuda.empty_cache()


# --- phase 9i: pretrained BatchNorm towers, the bottleneck and SE nets -------

def resnet18_checkpoint(path: Path, seed: int, layout: str) -> str:
    """A random-weight MIT-semseg ResNet-18 encoder checkpoint (the deep
    stem: ``conv1..3`` / ``bn1..3`` of 64, 64 and 128 channels, then
    ``layer{i}.{j}.conv{k}`` / ``bn{k}`` and ``downsample.0/1``) with
    non-trivial BatchNorm scales, biases and running statistics, written
    with ``torch.save``.  ``layout``: ``'ade20k'`` (MIT's merged save:
    ``encoder.`` keys, and the PPM decoder's ``decoder.ppm.{i}.1/2`` and
    ``decoder.conv_last.0/1/4`` at 512 channels, which no truncated tower
    takes) or ``'cityscapes'`` (a ``{"state_dict": ...}`` of ``module.``
    keys, a DataParallel save)."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(key, cout, cin, k):
        sd[f"{key}.weight"] = torch.randn(cout, cin, k, k, generator=gen) * \
            float(np.sqrt(2.0 / (cin * k * k)))

    def bn(key, c):
        sd[f"{key}.weight"] = torch.rand(c, generator=gen) + 0.5
        sd[f"{key}.bias"] = torch.randn(c, generator=gen) * 0.2
        sd[f"{key}.running_mean"] = torch.randn(c, generator=gen) * 0.3
        sd[f"{key}.running_var"] = torch.rand(c, generator=gen) * 1.5 + 0.5
        sd[f"{key}.num_batches_tracked"] = torch.tensor(1000)

    for i, (cout, cin) in enumerate(((64, 3), (64, 64), (128, 64))):
        conv(f"conv{i + 1}", cout, cin, 3)
        bn(f"bn{i + 1}", cout)
    cin = 128
    for layer, planes in enumerate((64, 128, 256, 512), 1):
        for j in range(2):
            p, ci = f"layer{layer}.{j}", cin if j == 0 else planes
            conv(f"{p}.conv1", planes, ci, 3)
            bn(f"{p}.bn1", planes)
            conv(f"{p}.conv2", planes, planes, 3)
            bn(f"{p}.bn2", planes)
            if ci != planes:
                conv(f"{p}.downsample.0", planes, ci, 1)
                bn(f"{p}.downsample.1", planes)
        cin = planes
    if layout == "ade20k":
        sd = {f"encoder.{k}": v for k, v in sd.items()}
        for i in range(4):
            conv(f"decoder.ppm.{i}.1", 512, 512, 1)
            bn(f"decoder.ppm.{i}.2", 512)
        conv("decoder.conv_last.0", 512, 512 + 4 * 512, 3)
        bn("decoder.conv_last.1", 512)
        conv("decoder.conv_last.4", 150, 512, 1)
        torch.save(sd, str(path))
    else:
        torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
                   str(path))
    return str(path)


class TowerWeightsProbe(Seams):
    """The seam of ``apply_tower_weights`` for one ``cli.train`` run: what
    each call returned (the parameters loaded per tower path)."""

    def __init__(self):
        super().__init__()
        self.loaded = []

    def __enter__(self):
        from deepviewagg_tpu_torch.utils import pretrained

        probe = self

        def apply(original):
            def run(*args, **kwargs):
                out = original(*args, **kwargs)
                probe.loaded.append(dict(out))
                return out
            return run

        self._patch(pretrained, "apply_tower_weights", apply)
        return self


def converted_tower(pth: str, out_level: int = 4) -> dict:
    """The tower state a checkpoint converts to (on the host)."""
    from deepviewagg_tpu_torch.utils.torch_convert import (
        convert_resnet18, load_torch_state_dict, strip_prefix)

    sd = load_torch_state_dict(pth)
    for prefix in ("module.", "encoder.", "backbone."):
        sd = strip_prefix(sd, prefix)
    return convert_resnet18(sd, out_level=out_level)


def loaded_model(spec, pth: str, device: str, seed=None):
    from deepviewagg_tpu_torch.models.segmentation import build_model
    from deepviewagg_tpu_torch.utils.pretrained import apply_tower_weights

    model = build_model(spec, device=device, seed=seed)
    return model, apply_tower_weights(model, spec, pth)


def pretrained_tower_card_vs_cpu(spec, pth: str, batch) -> dict:
    """The checkpoint loaded into the recipe's tower on the card and on the
    CPU, in eval mode (its running statistics), on the first
    ``PRETRAINED_CHECK_IMAGES`` images of the first train batch (in eval
    mode each image's output is its own): float32 operands and activations
    within ``TOWER_F32_RTOL``, the production bf16 ones within
    ``LOGITS_RTOL``."""
    images = batch["images"][:PRETRAINED_CHECK_IMAGES]
    towers = {d: loaded_model(spec, pth, d)[0].branch_l0.tower.eval()
              for d in ("cuda", "cpu")}
    out = {}
    for label, bf16 in (("f32", False), ("bf16", True)):
        ys = {}
        for d, tower in towers.items():
            ctx = contextlib.nullcontext() if bf16 else f32_convs()
            with torch.no_grad(), ctx:
                ys[d] = run_tower(tower, images.to(d), False,
                                  bf16=bf16).cpu()
        out[label] = rel_err(ys["cuda"], ys["cpu"])
    log("9i pretrained tower card vs cpu", images=tuple(images.shape),
        f32_rel_err=f"{out['f32']:.3e}", bf16_rel_err=f"{out['bf16']:.3e}")
    if not (out["f32"] <= TOWER_F32_RTOL and out["bf16"] <= LOGITS_RTOL):
        raise AssertionError(f"pretrained tower card vs CPU: {out}")
    return out


def tower_stats(tower) -> dict:
    return {k: v.detach().clone() for k, v in tower.named_buffers()}


def pretrained_remat_stats(spec, pth: str, batch) -> None:
    """One train step of the recipe's model with the checkpoint loaded under
    ``remat_tower`` False, True and ``'convs'`` from the same weights: the
    tower's running statistics after the step equal within 1e-6 (each moved
    once)."""
    from deepviewagg_tpu_torch.models.segmentation import build_model

    base, _ = loaded_model(spec, pth, "cuda", seed=0)
    start = tower_stats(base.branch_l0.tower)
    weights = base.state_dict()
    del base
    stats = {}
    for remat in (False, True, "convs"):
        s = dataclasses.replace(spec, branches=tuple(
            (lvl, dataclasses.replace(b, remat_tower=remat))
            for lvl, b in spec.branches))
        model = build_model(s, device="cuda", seed=None)
        model.load_state_dict(weights)
        run_steps(model, batch, 1, "9i pretrained remat",
                  {"segment_csr": FORWARD_LAUNCHES,
                   "segment_csr_bwd": BACKWARD_LAUNCHES}, remat=remat)
        stats[remat] = tower_stats(model.branch_l0.tower)
        del model
        torch.cuda.empty_cache()
    worst = max(rel_err(stats[m][k], stats[False][k])
                for m in (True, "convs") for k in start)
    moved_all = all(not torch.equal(stats[False][k], start[k])
                    for k in start)
    log("9i pretrained remat", running_stats=len(start),
        max_rel_diff_across_modes=f"{worst:.3e}", all_moved=moved_all)
    if worst > REMAT_STATS_RTOL or not moved_all:
        raise AssertionError(f"running statistics across remat modes: "
                             f"{worst}, all moved {moved_all}")


def pretrained_run(cli, root: Path, run_dir: Path, pth: str, frozen: bool,
                   phase: str):
    """``cli.train`` of the S3DIS recipe on 9e's layout with the checkpoint
    as ``model.tower_weights`` (``PRETRAINED_LOOP``); returns the probe."""
    args = ["--config", str(CONF / "s3dis_benchmark.yaml"),
            f"data.root={root}", f"training.run_dir={run_dir}",
            "training.tensorboard=false", f"model.tower_weights={pth}",
            *PRETRAINED_LOOP] + (["model.tower_frozen=true"] if frozen
                                 else [])
    zero_launches()
    with LoopProbe() as probe, TowerWeightsProbe() as weights:
        cli.main(args)
    launches = dict(seg.LAUNCHES)
    probe.check_steps(phase, FORWARD_LAUNCHES,
                      PRETRAINED_FROZEN_BACKWARD if frozen
                      else BACKWARD_LAUNCHES)
    (loaded,) = weights.loaded
    if not (loaded and all(v > 0 for v in loaded.values())):
        raise AssertionError(f"{phase}: tower weights loaded {loaded}")
    spec = probe.trainer.model.spec
    (_, b), = spec.branches
    if not (b.tower == "resnet18_l4" and b.tower_norm == "batch"
            and b.tower_deep_stem and b.frozen == frozen
            and spec.num_classes == 13):
        raise AssertionError(f"{phase}: not the pretrained recipe: {spec}")
    stored = json.loads((run_dir / "run.json").read_text())["model"]
    if stored["overrides"].get("tower_deep_stem") is not True:
        raise AssertionError(f"{phase}: run.json model {stored}")
    log(phase, model=spec.backbone, tower=b.tower, frozen=frozen,
        loaded=loaded, params=sum(
            p.numel() for p in probe.trainer.model.parameters()),
        **probe.summary(), launches_per_step=probe.step_launches[0],
        launches=launches)
    return probe


def se_blocks(model) -> int:
    from deepviewagg_tpu_torch.nn.sparse_blocks import SqueezeExcite

    return sum(isinstance(m, SqueezeExcite) for m in model.modules())


def loop_pretrained(cli, cli_eval, tmp: Path) -> None:
    """9i: (a) the S3DIS recipe with a pretrained (random-weight) MIT
    deep-stem checkpoint through ``cli.train`` and ``cli.eval --voting_runs
    2``, the tower card vs CPU, the first train and eval batches' segment
    calls against plain, the running statistics across remat modes, then
    the same run with ``model.tower_frozen=true``; (b) the KITTI-360
    recipe's five-tower model with a Cityscapes-layout checkpoint at library
    level; (c) ``cli.train`` + ``cli.predict`` of ``SERes16UNet34``, then a
    forward and two steps of each ``SE_MODELS`` entry on (a)'s first
    batch."""
    from deepviewagg_tpu_torch.config.run import ModelCfg
    from deepviewagg_tpu_torch.config.zoo import (get_model_spec,
                                                  resolve_spec_from_cfg)
    from deepviewagg_tpu_torch.models.segmentation import build_model

    root = tmp / "s3dis_raw"
    if not (root / "Area_5").exists():
        write_s3dis_layout(root)
    log("9i pretrained cuts", spheres=f"{PRETRAINED_SPHERES} (recipe 200 x "
        f"2000; SE run {SE_SPHERES})", epochs=1,
        steps_library="2 (one warm-up)", widths="none cut",
        batch="4 spheres x 4 image slots of 1024x512 as written",
        weights="random, from a seed, in the published key layouts")
    ade = resnet18_checkpoint(tmp / "ade20k_resnet18.pth", 0, "ade20k")
    city = resnet18_checkpoint(tmp / "cityscapes_resnet18.pth", 1,
                               "cityscapes")

    # (a) the pretrained recipe, trained, evaluated, then frozen
    run_dir = tmp / "pretrained_run"
    probe = pretrained_run(cli, root, run_dir, ade, False,
                           "9i pretrained loop")
    model, batch = probe.trainer.model, probe.batch
    spec = model.spec
    del probe
    pretrained_tower_card_vs_cpu(spec, ade, batch)
    family_kernels(model, batch, "9i pretrained kernels", FORWARD_LAUNCHES,
                   BACKWARD_LAUNCHES)
    del model
    torch.cuda.empty_cache()
    pretrained_remat_stats(spec, ade, batch)
    first = batch
    metrics, eprobe, eval_launches = run_eval(cli_eval, [
        "--run_dir", str(run_dir), "--voting_runs", str(EVAL_VOTING_RUNS)])
    worst = check_doubled(eprobe, eprobe.votes.num_classes)
    log("9i pretrained eval", voting_runs=EVAL_VOTING_RUNS,
        **eprobe.summary(), launches_per_batch=eprobe.step_launches[0],
        launches=eval_launches, votes_twice_rel_err=f"{worst:.2e}",
        **{k: f"{v:.3f}" for k, v in metrics.items()})
    calls = record_segment_calls(eprobe.model.eval(), eprobe.batch)
    if len(calls) != FORWARD_LAUNCHES:
        raise AssertionError(f"{len(calls)} segment calls in one eval "
                             "forward")
    check_forward_calls(calls, "9i pretrained eval kernels",
                          "calls_per_forward")
    del calls, eprobe
    torch.cuda.empty_cache()

    probe = pretrained_run(cli, root, tmp / "pretrained_frozen_run", ade,
                           True, "9i pretrained frozen loop")
    want = converted_tower(ade)
    tower = probe.trainer.model.branch_l0.tower.state_dict()
    changed = [k for k, v in want.items()
               if not torch.equal(tower[k].cpu(), v)]
    moved_3d = sum(not torch.equal(p.detach(), probe.start[k])
                   for k, p in probe.trainer.model.named_parameters()
                   if not k.startswith("branch_l0.tower."))
    log("9i pretrained frozen loop", tower_entries=len(want),
        tower_changed=len(changed), other_params_moved=moved_3d)
    if changed or set(want) != set(tower) or not moved_3d:
        raise AssertionError(f"frozen tower changed: {changed[:5]}")
    del probe, tower
    torch.cuda.empty_cache()

    # (b) the KITTI-360 recipe's five towers at library level
    pspec = resolve_spec_from_cfg(ModelCfg(name=PYRAMID_MODEL,
                                           tower_weights=city), 13)
    model, loaded = loaded_model(pspec, city, "cuda", seed=0)
    counts = list(loaded.values())
    if counts != PYRAMID_LOADED:
        raise AssertionError(f"pyramid loaded {loaded}")
    zero_launches()
    with torch.no_grad():
        logits = model.eval()(first)["logits"][first["graph"]["levels"][0][
            "valid"]]
    fwd_launches = dict(seg.LAUNCHES)
    if fwd_launches != {"segment_csr": PYRAMID_FORWARD,
                        "segment_csr_bwd": 0} or not bool(
                            torch.isfinite(logits).all()):
        raise AssertionError(f"pyramid forward launches {fwd_launches}")
    losses = run_steps(model, first, 1, "9i pyramid",
                       {"segment_csr": PYRAMID_FORWARD,
                        "segment_csr_bwd": PYRAMID_BACKWARD})
    log("9i pyramid", model=PYRAMID_MODEL, loaded=loaded, params=sum(
        p.numel() for p in model.parameters()),
        launches_per_step=(PYRAMID_FORWARD, PYRAMID_BACKWARD),
        loss=f"{losses[0]:.4f}")
    del model
    torch.cuda.empty_cache()

    # (c) the squeeze-excitation Res16UNet34 through the CLIs, then the
    # bottleneck and SE nets at library level
    loop_se(cli, root, tmp)
    for label, name, fwd_n, bwd_n in SE_MODELS:
        phase = f"9i {label}"
        model = build_model(get_model_spec(name, 13, 4), device="cuda",
                            seed=0)
        if (2 * se_blocks(model), se_blocks(model)) != (
                fwd_n - (FORWARD_LAUNCHES if "-L4-" in name else 0),
                bwd_n - (BACKWARD_LAUNCHES if "-L4-" in name else 0)):
            raise AssertionError(f"{phase}: {se_blocks(model)} SE blocks")
        zero_launches()
        with torch.no_grad():
            logits = model.eval()(first)["logits"][first["graph"]["levels"][
                0]["valid"]]
        launches = dict(seg.LAUNCHES)
        if launches != {"segment_csr": fwd_n, "segment_csr_bwd": 0} or not \
                bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{phase}: forward launches {launches}")
        losses = run_steps(model, first, 2, phase,
                           {"segment_csr": fwd_n, "segment_csr_bwd": bwd_n})
        if fwd_n:
            family_kernels(model, first, f"{phase} kernels", fwd_n, bwd_n)
        log(phase, model=name, params=sum(p.numel()
                                          for p in model.parameters()),
            se_blocks=se_blocks(model), launches_per_forward=fwd_n,
            launches_per_step=(fwd_n, bwd_n),
            losses="/".join(f"{x:.4f}" for x in losses))
        del model
        torch.cuda.empty_cache()


def loop_se(cli, root: Path, tmp: Path) -> None:
    """9i (c): ``cli.train`` of ``SERes16UNet34`` (3D only: every launch is
    a squeeze-excitation pool) on 9e's layout for one epoch of
    ``SE_SPHERES`` spheres, its first batch's segment calls against plain,
    then ``cli.predict`` on Area_5's room: one label per voxel.
    ``cli.predict`` sizes the head from the stored ``data.num_classes``, as
    the JAX package's ``predict.py`` does, so the run pins the dataset's
    13."""
    from deepviewagg_tpu_torch.cli import predict as cli_predict
    from deepviewagg_tpu_torch.data.transforms3d import quantize_cloud
    from deepviewagg_tpu_torch.models import segmentation
    from deepviewagg_tpu_torch.utils.ply import read_ply

    name, fwd_n, bwd_n = SE_CLI
    run_dir = tmp / "se_run"
    args = ["--config", str(CONF / "s3dis_benchmark.yaml"),
            f"data.root={root}", f"training.run_dir={run_dir}",
            "training.tensorboard=false", f"model.name={name}",
            "training.epochs=1", f"data.samples_per_epoch={SE_SPHERES}",
            "training.eval_frequency=2", "data.num_classes=13",
            "data.kwargs={fold: 5, keep_raw: true}"]
    zero_launches()
    with LoopProbe() as probe:
        cli.main(args)
    launches = dict(seg.LAUNCHES)
    probe.check_steps("9i se loop", fwd_n, bwd_n)
    model, batch = probe.trainer.model, probe.batch
    if se_blocks(model) * 2 != fwd_n or model.spec.branches:
        raise AssertionError(f"not {name}: {model.spec}")
    log("9i se loop", model=name, params=sum(
        p.numel() for p in model.parameters()), **probe.summary(),
        launches_per_step=probe.step_launches[0], launches=launches)
    del probe
    family_kernels(model, batch, "9i se loop kernels", fwd_n, bwd_n)
    del model, batch
    torch.cuda.empty_cache()

    ann = sorted((root / "Area_5").glob("*/Annotations/*.txt"))
    pts = np.concatenate([np.loadtxt(p, dtype=np.float32, ndmin=2)
                          for p in ann])
    src = tmp / "se_room.npz"
    np.savez(src, pos=pts[:, :3], rgb=pts[:, 3:6].astype(np.uint8))
    stored = json.loads((run_dir / "run.json").read_text())
    voxels = len(quantize_cloud({"pos": pts[:, :3]},
                                stored["data"]["voxel_size"])["coords"])
    forwards = []

    class Counted(Seams):
        def __enter__(self):
            def make(fn):
                def run(*args, **kwargs):
                    forwards.append(1)
                    return fn(*args, **kwargs)
                return run
            self._patch(segmentation.SparseConv3dSeg, "forward", make)
            return self

    zero_launches()
    with Counted():
        dst = cli_predict.main(["--run_dir", str(run_dir), "--input",
                                str(src), "--output",
                                str(tmp / "se_room_pred.ply")])
    predict_launches = dict(seg.LAUNCHES)
    labels = read_ply(dst)["label"]
    expect = {"segment_csr": fwd_n * len(forwards), "segment_csr_bwd": 0}
    if len(labels) != voxels or predict_launches != expect:
        raise AssertionError(f"se predict: {len(labels)} labels for {voxels} "
                             f"voxels, launches {predict_launches}")
    log("9i se predict", model=name, raw_points=len(pts), voxels=voxels,
        forwards=len(forwards), launches=predict_launches)



# --- phase 9j: reference-YAML ingest, the ingest-only branches, preprocess --

# phase 9j: on 9e's S3DIS layout (written anew, with its in-line caches, when
# 9j runs alone): cli.preprocess --dataset s3dis in two shards against 9e's
# in-line caches; a conf tree in the upstream's YAML DSL written here
# (REF_MODELS, REF_DATA_BASE, REF_DATA) under DVA_REFERENCE_CONF /
# DVA_REFERENCE_DATA_CONF; the flagship entry against its zoo name; then
# cli.train (REF_SPHERES spheres: 4 steps of batch 4, an eval) and cli.eval
# --voting_runs 2 with model.name=ref:sparseconv3d/<entry> and
# data.ref=s3disfused-sparse for (a) the shared trunk, (b) tower reuse and
# (c) the tower-less raw-RGB branch, at the recipe's width (16 panoramas of
# 1024 x 512 a batch, 5 cm, 2 m spheres); (a) card vs CPU; the scale
# rehearsal at its defaults.  Segment launches, from the code: a max-pooled
# branch launches its atomic max, the view count and the view max forward,
# and the two maxima's backwards (its taps take gradient); a group-pooled
# one the flagship's 6 + 5; the raw-RGB branch one atomic max per ladder
# bucket, the view count and the view max, and no backward (nothing before
# its max pools takes a gradient)
REF_SPHERES = 16
REF_LOOP = ("training.epochs=1", f"data.samples_per_epoch={REF_SPHERES}",
            "data.kwargs.keep_raw=true")
REF_FLAT = ("data.crop_ladder_min=0",)     # (a) and (b) take flat batches
REF_ENTRIES = (  # (label, entry, forward, backward; None: per ladder bucket)
    ("shared", "Res16UNet34-Res16Image-max", 5 * 3, 5 * 2),
    ("reuse", "Res16UNet34-L4-all", 3 * FORWARD_LAUNCHES,
     3 * BACKWARD_LAUNCHES),
    ("raw", "Res16UNet34-RGB-identity-early", None, 0),
)
REF_FLAGSHIP = "Res16UNet34-L4-early-ade20k-interpolate"
REF_REHEARSAL = ()                          # the rehearsal's defaults

_REF_BACKBONE = """\
        define_constants:
            in_feat: 32
            block: ResBlock
            mod: {mod}
        down_conv:
            module_name: ResNetDown
            block: block
            conv3d_after_fusion: False
            N: [0, 2, 3, 4, 6]
            down_conv_nn:
                [
                    [FEAT + mod, in_feat],
                    [in_feat, in_feat],
                    [in_feat, 2*in_feat],
                    [2*in_feat, 4*in_feat],
                    [4*in_feat, 8*in_feat],
                ]
            kernel_size: [3, 2, 2, 2, 2]
            stride: [1, 2, 2, 2, 2]
"""
_REF_UP = """\
        up_conv:
            module_name: ResNetUp
            block: block
            N: [1, 1, 1, 1, 1]
            up_conv_nn:
                [
                    [8*in_feat, 4*in_feat, 8*in_feat],
                    [8*in_feat, 2*in_feat, 4*in_feat],
                    [4*in_feat, in_feat, 3*in_feat],
                    [3*in_feat, in_feat, 3*in_feat],
                    [3*in_feat, 0, 3*in_feat],
                ]
            stride: [2, 2, 2, 2, 1]
"""
_REF_HEAD = """\
{name}:
    class: sparseconv3d.APIModel
    conv_type: "SPARSE"
    backend: "minkowski"
    backbone:
"""
REF_MODELS = (
    "# multimodal entries in the upstream's DSL, at the recipe's widths\n"
    + _REF_HEAD.format(name=REF_FLAGSHIP)
    + _REF_BACKBONE.format(mod=512) + """\
            image:
                down_conv:
                    module_name: ADE20KResNet18TruncatedLayer4
                    frozen: False
                atomic_pooling:
                    module_name: BimodalCSRPool
                    mode: max
                view_pooling:
                    module_name: GroupBimodalCSRPool
                    in_map: 8
                    in_mod: mod
                    num_groups: 4
                    use_mod: False
                    gating: True
                    group_scaling: True
                    map_encoder: DeepSetFeat
                    use_num: True
                fusion:
                    module_name: BimodalFusion
                    mode: concatenation
                branching_index: 0
                interpolate: True
""" + _REF_UP + "\n"
    # (a) the Res16Image shared trunk at ConvDown2D's published defaults,
    # its five taps at levels 0-4
    + _REF_HEAD.format(name=REF_ENTRIES[0][1])
    + _REF_BACKBONE.format(mod=32) + """\
            image:
                down_conv:
                    module_name: ResNetDown
                    block: ResBlock
                    N: [0, 2, 2, 2, 2]
                    down_conv_nn:
                        [
                            [3, 32],
                            [32, 32],
                            [32, 64],
                            [64, 128],
                            [128, 256],
                        ]
                    kernel_size: [3, 3, 3, 3, 3]
                    stride: [1, 2, 2, 2, 2]
                    normalization: GroupNorm
                    weight_standardization: True
                atomic_pooling:
                    module_name: BimodalCSRPool
                    mode: max
                view_pooling:
                    module_name: BimodalCSRPool
                    mode: max
                fusion:
                    module_name: BimodalFusion
                    mode: concatenation
                branching_index: [0, 2, 3, 4, 5]
                interpolate: True
""" + _REF_UP + "\n"
    # (b) XYZ-RGB-L4-all: one deep-stem L4 tower at level 0, its maps
    # gathered again at levels 1 and 3
    + _REF_HEAD.format(name=REF_ENTRIES[1][1])
    + _REF_BACKBONE.format(mod=512) + """\
            image:
                down_conv:
                    module_name:
                        - ADE20KResNet18TruncatedLayer4
                        - ModalityIdentity
                        - ModalityIdentity
                atomic_pooling:
                    module_name: BimodalCSRPool
                    mode: max
                view_pooling:
                    module_name: GroupBimodalCSRPool
                    in_mod: [512, 512, 512]
                    out_mod: [mod, in_feat, 4*in_feat]
                    num_groups: 4
                    gating: True
                    group_scaling: True
                    map_encoder: DeepSetFeat
                    use_num: True
                fusion:
                    module_name: BimodalFusion
                    mode: [concatenation, residual, residual]
                branching_index: [0, 2, 4]
                interpolate: True
""" + _REF_UP + "\n"
    # (c) ModalityIdentity only: the raw RGB gathered and pooled
    + _REF_HEAD.format(name=REF_ENTRIES[2][1])
    + _REF_BACKBONE.format(mod=3) + """\
            image:
                down_conv:
                    module_name: ModalityIdentity
                atomic_pooling:
                    module_name: BimodalCSRPool
                    mode: max
                view_pooling:
                    module_name: BimodalCSRPool
                    mode: max
                fusion:
                    module_name: BimodalFusion
                    mode: concatenation
                branching_index: 0
                interpolate: True
""" + _REF_UP)
REF_DATA_BASE = """\
# @package data
task: segmentation
class: s3dis.S3DISFusedDataset
dataroot: data
fold: 5
first_subsampling: 0.04
sample_per_epoch: 3000
"""
REF_DATA = """\
# @package data
defaults:
    - /data/segmentation/s3disfused

class: s3dis.S3DISFusedDataset
first_subsampling: 0.05
resolution_2d: [1024, 512]
exact_splatting_2d: True
min_size_2d: 64

multimodal:
    modality: image
    settings:
        mapping_key: mapping_index
        proj_upscale: 2
        r_max: 8
        r_min: 0.05
        train_pixel_credit: 4
        test_pixel_credit: 4
        k_coverage: 2
        use_bbox: True
    pre_transform:
        - transform: LoadImages
          params:
              ref_size: ${data.resolution_2d}
        - transform: NonStaticMask
          params:
              ref_size: ${data.resolution_2d}
              proj_upscale: ${data.multimodal.settings.proj_upscale}
              n_sample: 5
        - transform: MapImages
          params:
              method: SplattingVisibility
              ref_size: ${data.resolution_2d}
              proj_upscale: ${data.multimodal.settings.proj_upscale}
              voxel: ${data.first_subsampling}
              r_max: ${data.multimodal.settings.r_max}
              r_min: ${data.multimodal.settings.r_min}
              exact: ${data.exact_splatting_2d}
              camera: s3dis_equirectangular
        - transform: NeighborhoodBasedMappingFeatures
          params:
              k: 50
              voxel: ${data.first_subsampling}
              density: True
              occlusion: True
    train_transforms:
        - transform: SelectMappingFromPointId
        - transform: PickImagesFromMappingArea
          params:
              use_bbox: ${data.multimodal.settings.use_bbox}
        - transform: PickImagesFromMemoryCredit
          params:
              img_size: ${data.resolution_2d}
              k_coverage: ${data.multimodal.settings.k_coverage}
              n_img: ${data.multimodal.settings.train_pixel_credit}
        - transform: CenterRoll
          params:
              angular_res: 16
        - transform: CropImageGroups
          params:
              padding: 8
              min_size: ${data.min_size_2d}
        - transform: JitterMappingFeatures
          params:
              sigma: 0.02
              clip: 0.03
        - transform: ColorJitter
          params:
              brightness: 0.6
              contrast: 0.6
              saturation: 0.7
        - transform: RandomHorizontalFlip
        - transform: ToFloatImage

train_transforms:
    - transform: RandomNoise
      params:
          sigma: 0.001
    - transform: RandomRotate
      params:
          degrees: 180
          axis: 2
    - transform: RandomScaleAnisotropic
      params:
          scales: [0.8, 1.2]
    - transform: RandomSymmetry
      params:
          axis: [True, False, False]
    - transform: RandomSphere
      params:
          radius: 2.0
          strategy: RANDOM
"""


def write_reference_conf(root: Path) -> Path:
    """The 9j conf tree under ``<root>/conf`` (the ancestor named ``conf``
    anchors the data file's ``defaults:``); returns it."""
    conf = root / "conf"
    for rel, text in (
            ("models/segmentation/multimodal/sparseconv3d.yaml", REF_MODELS),
            ("data/segmentation/s3disfused.yaml", REF_DATA_BASE),
            ("data/segmentation/multimodal/s3disfused-sparse.yaml",
             REF_DATA)):
        (conf / rel).parent.mkdir(parents=True, exist_ok=True)
        (conf / rel).write_text(text)
    return conf


def s3dis_inline_caches(root: Path) -> None:
    """9e's in-line caches (``cli.train``'s S3DIS loader with
    ``conf/s3dis_benchmark.yaml``'s options), built when 9j runs alone."""
    from deepviewagg_tpu_torch.data.datasets.s3dis import make_s3dis_dataset

    for train in (True, False):
        make_s3dis_dataset(str(root), train=train, fold=5, voxel_size=0.05,
                           keep_raw=True)


def preprocess_shards(root: Path, out: Path) -> None:
    """``cli.preprocess --dataset s3dis`` in two shards into ``out``; each
    cache held against 9e's in-line one: byte-equal, else equal array by
    array (the zip container of ``np.savez_compressed`` carries a time)."""
    import filecmp

    from deepviewagg_tpu_torch.cli import preprocess as cli_pre

    for shard in (0, 1):
        cli_pre.main(["--dataset", "s3dis", "--root", str(root), "--out",
                      str(out), "--voxel-size", "0.05", "--keep-raw",
                      "--shard", str(shard), "--num-shards", "2"])
    inline = root / "processed_dva"
    names = sorted(p.name for p in out.iterdir())
    if names != sorted(p.name for p in inline.iterdir()):
        raise AssertionError(f"cli.preprocess wrote {names}")
    equal = {}
    for name in names:
        a, b = out / name, inline / name
        if filecmp.cmp(a, b, shallow=False):
            equal[name] = "bytes"
            continue
        za, zb = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
        if sorted(za.files) != sorted(zb.files) or not all(
                np.array_equal(za[k], zb[k]) for k in za.files):
            raise AssertionError(f"{name}: cli.preprocess differs from the "
                                 "in-line cache")
        equal[name] = "arrays"
    log("9j preprocess", shards=2, equal=equal)


def check_flagship_ingest(path: str) -> None:
    """The flagship entry ingests to the zoo's spec of its name, but for
    ``drop_hard`` (the upstream builder never threads it), which does
    nothing at the entry's zero dropouts."""
    from deepviewagg_tpu_torch.config.reference_ingest import load_model_spec
    from deepviewagg_tpu_torch.config.zoo import get_model_spec

    got = load_model_spec(path, REF_FLAGSHIP, 13, 4)
    zoo = get_model_spec(REF_FLAGSHIP, 13, 4)
    (lvl, b), = got.branches
    same = dataclasses.replace(got, branches=((lvl, dataclasses.replace(
        b, drop_hard=zoo.branches[0][1].drop_hard)),))
    if same != zoo or b.drop_modality or b.drop_3d:
        raise AssertionError(f"flagship ingest {got} != zoo {zoo}")
    log("9j flagship ingest", entry=REF_FLAGSHIP, equal_to_zoo=True,
        but="drop_hard False (inert at drop 0)")


def ref_kinds(spec, label: str) -> None:
    """The ingested spec is the branch kind 9j means to run."""
    towers = [b.tower for _, b in spec.branches]
    ok = {"shared": spec.shared_tower is not None
          and towers == [f"shared:{i}" for i in range(5)],
          "reuse": towers == ["resnet18_l4", "reuse", "reuse"],
          "raw": towers == [None]}[label]
    if not ok or spec.num_classes != 13 or spec.backbone != "Res16UNet34":
        raise AssertionError(f"9j {label}: not the entry's spec: {spec}")


def loop_reference(cli, cli_eval, tmp: Path) -> None:
    """9j: reference-YAML ingest end to end (see ``REF_ENTRIES``):
    preprocess shards, the flagship ingest, then for each of (a) the shared
    trunk, (b) tower reuse and (c) the raw-RGB branch ``cli.train`` (4
    steps and an eval) and ``cli.eval --voting_runs 2`` through ``ref:``
    and ``data.ref``, every segment call of the first forward and backward
    held against plain; (a) card vs CPU; the scale rehearsal."""
    from deepviewagg_tpu_torch.cli import scale_rehearsal
    from deepviewagg_tpu_torch.config.zoo import get_model_spec

    root = tmp / "s3dis_raw"
    if not (root / "Area_5").exists():
        write_s3dis_layout(root)
    if not (root / "processed_dva" / "area_5.npz").exists():
        s3dis_inline_caches(root)
    log("9j reference cuts", spheres=f"{REF_SPHERES} a model (4 steps), 1 "
        "epoch (recipe 200 x 2000)", widths="none cut",
        batch="4 spheres x 4 image slots of 1024x512 as ingested",
        rehearsal=" ".join(REF_REHEARSAL) or "defaults")
    preprocess_shards(root, tmp / "ref_caches")
    conf = write_reference_conf(tmp / "ref")
    env = {"DVA_REFERENCE_CONF": str(conf / "models/segmentation"),
           "DVA_REFERENCE_DATA_CONF": str(conf / "data/segmentation/"
                                                 "multimodal")}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        check_flagship_ingest(str(conf / "models/segmentation/multimodal/"
                                         "sparseconv3d.yaml"))
        for label, entry, fwd_n, bwd_n in REF_ENTRIES:
            ref_run(cli, cli_eval, root, tmp, label, entry, fwd_n, bwd_n)
        shared = get_model_spec(f"ref:sparseconv3d/{REF_ENTRIES[0][1]}", 4,
                                4)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    ref_card_vs_cpu(shared)
    with KnnGridCalls() as grid:
        rehearsal = scale_rehearsal.main(list(REF_REHEARSAL))
    if grid.calls != 1:
        raise AssertionError(f"9j rehearsal: {grid.calls} grid kNN calls")
    log("9j scale rehearsal", knn_grid_calls=grid.calls,
        **{k: rehearsal[k] for k in ("raw_points", "voxels",
                                     "full_res_points",
                                     "vote_spilled_clouds")})


def ref_run(cli, cli_eval, root: Path, tmp: Path, label: str, entry: str,
            fwd_n, bwd_n) -> None:
    """One 9j model through ``cli.train`` and ``cli.eval``."""
    flat = () if label == "raw" else REF_FLAT
    run_dir = tmp / f"ref_{label}_run"
    args = [f"data.root={root}", "data.ref=s3disfused-sparse",
            f"model.name=ref:sparseconv3d/{entry}",
            f"training.run_dir={run_dir}", "training.tensorboard=false",
            *REF_LOOP, *flat]
    zero_launches()
    with LoopProbe() as probe:
        cli.main(args)
    launches = dict(seg.LAUNCHES)
    model, batch = probe.trainer.model, probe.batch
    ref_kinds(model.spec, label)
    ladder = "buckets" in batch["mappings"][0]
    if ladder != (label == "raw"):
        raise AssertionError(f"9j {label}: ladder batch {ladder}")
    if fwd_n is None:
        # one atomic pool per ladder bucket, the view count and the max
        fwd_n = len(probe.train_images[0]) + 2
    probe.check_steps(f"9j {label} loop", fwd_n, bwd_n)
    records = read_records(run_dir)
    if len(records) != 1 or "val_miou" not in records[0]:
        raise AssertionError(f"9j {label} metrics.jsonl: {records}")
    log(f"9j {label} loop", model=f"ref:sparseconv3d/{entry}",
        data_ref="s3disfused-sparse", flat=" ".join(flat) or "ladder",
        params=sum(p.numel() for p in model.parameters()),
        images=probe.train_images[0], **probe.summary(),
        launches_per_step=probe.step_launches[0], launches=launches,
        val_miou=f"{records[0]['val_miou']:.2f}")
    del probe
    family_kernels(model, batch, f"9j {label} kernels", fwd_n, bwd_n)
    del model, batch
    torch.cuda.empty_cache()

    metrics, eprobe, eval_launches = run_eval(cli_eval, [
        "--run_dir", str(run_dir), "--voting_runs", str(EVAL_VOTING_RUNS),
        *flat], forward=fwd_n)
    worst = check_doubled(eprobe, eprobe.votes.num_classes)
    log(f"9j {label} eval", voting_runs=EVAL_VOTING_RUNS, **eprobe.summary(),
        launches_per_batch=eprobe.step_launches[0], launches=eval_launches,
        votes_twice_rel_err=f"{worst:.2e}",
        **{k: f"{v:.3f}" for k, v in metrics.items()})
    del eprobe
    torch.cuda.empty_cache()


def ref_card_vs_cpu(spec) -> None:
    """(a) at full width on a small flat request with mappings at every
    level, card vs CPU: the bounds of phases 4 and 7; then, as 7g, one step
    in float32 everywhere, held to the ``ALL_F32_*`` bounds, its update
    against the CPU's with the card's max routing imposed (the trunk's five
    atomic maxima behind bilinear taps route near ties apart), beside the
    CPU against itself on half its threads."""
    phase = "9j shared f32 card vs cpu"
    np_batch = make_request(0, "cuda", branch_levels=(0, 1, 2, 3, 4),
                            **CHECK_REQUEST)
    model = MultimodalSeg(spec, device="cuda", seed=0).eval()
    phase_card_vs_cpu(model, np_batch, phase="9j shared card vs cpu")
    phase_train_card_vs_cpu(model, np_batch,
                            phase="9j shared train card vs cpu")
    got = variant_steps(model, np_batch, 1, all_f32=True, routing=True,
                        branch_changes={"tower_bf16": False})
    (loss_err,), (norm_err,) = (
        rel_errs(got["cuda"][k], got["cpu"][k]) for k in ("losses", "norms"))
    log(phase, loss_rel_err=f"{loss_err:.3e}",
        grad_norm_rel_err=f"{norm_err:.3e}")
    for i, diff in enumerate(routing_differences(got["routing"]["cuda"],
                                                 got["routing"]["cpu"])):
        log(phase, routing="card/cpu", max_call=i, **diff)
    card = got["cuda"]["params"]
    log_update_gap(phase, card, got["cpu"]["params"], 0)
    routed = log_update_gap(phase, card, got["cpu_card_routing"]["params"], 0,
                            "cpu_card_routing")
    log_update_gap(phase + " cpu", got["cpu_threads"]["params"],
                   got["cpu"]["params"], 0, "cpu_half_threads")
    if not (loss_err <= ALL_F32_LOSS_RTOL
            and norm_err <= ALL_F32_GRAD_NORM_RTOL
            and routed <= ALL_F32_UPDATE_RTOL):
        raise AssertionError(f"{phase}: {loss_err}, {norm_err}, {routed}")
    del model, got
    torch.cuda.empty_cache()


def phase_loop(tmp: Path) -> tuple:
    """Phase 9: the experiment loop on the card, through the entry point a
    user calls (``cli.train.main``), in this process; data and run dirs
    under ``tmp``.  Returns 9b's first UNet graph build (for 13a)."""
    from deepviewagg_tpu_torch.cli import eval as cli_eval
    from deepviewagg_tpu_torch.cli import train as cli

    def part(fn, *args):
        out = fn(*args)
        torch.cuda.empty_cache()
        return out

    part(loop_quick, cli, tmp)
    graph = part(loop_recipe, cli, tmp)
    part(loop_eval, cli_eval, tmp)
    part(loop_mc_dropout, cli_eval, tmp)
    part(loop_eval_card_vs_cpu, cli_eval, tmp)
    part(loop_predict, tmp)
    part(loop_s3dis, cli, cli_eval, tmp)
    part(loop_scannet, cli, cli_eval, tmp)
    part(loop_kitti360, cli, cli_eval, tmp)
    part(loop_families, cli, cli_eval, tmp)
    part(loop_pretrained, cli, cli_eval, tmp)
    part(loop_reference, cli, cli_eval, tmp)
    return graph


# phase 10: data and view parallelism (deepviewagg_tpu_torch/parallel/).
# 10a runs NCCL in this process at world 1 (the script needs one card, and
# NCCL refuses two ranks on one card): the flagship's
# data-parallel step on the bench request against the plain step from the
# same weights (the loss equal, the update within the plain step's own
# run-to-run gap on the card), the collectives' NCCL paths, then
# cli.train with training.data_parallel=true on 9e's layout
# (PARALLEL_LOOP: 4 steps of the S3DIS recipe and an eval), resumed for one
# step (PARALLEL_RESUME) with the restore checked bit for bit.  10b holds
# the two-rank arithmetic in GLOO_WORLD spawned gloo ranks with the model on
# the one card, float32 everywhere at 7g's bounds: data parallel on the bench
# request and a variant of it (the same voxels and mapping, so the same
# valid counts, with other labels, colours and images) against one process
# on their union; the batches swapped; view parallel (1 x 2) against one
# process on the bench request.
PARALLEL_SPHERES = 16                  # 4 steps of batch 4
PARALLEL_LOOP = ("training.epochs=1",
                 f"data.samples_per_epoch={PARALLEL_SPHERES}",
                 "training.eval_frequency=1",
                 "data.kwargs={fold: 5, keep_raw: true}",
                 "training.data_parallel=true")
PARALLEL_RESUME = ("data.samples_per_epoch=4", "training.eval_frequency=2",
                   "training.resume=true")
GLOO_WORLD = 2
GLOO_TIMEOUT_S = 300
SWAP_RTOL = 1e-6                       # two ranks' sums, in either order
# 10a: the card's updates are not bit-reproducible (the atomic index_add_
# backward of the pixel gather): two plain steps' updates differed by
# 1.8e-3 to 3.3e-3 relative on an H100, and a pair of runs can also be
# bit-equal, so the DP step's update is held to three times the plain
# pair's gap, at least DP_UPDATE_FLOOR (three times the larger gap)
DP_UPDATE_FLOOR = 1e-2


def sgd_state(model):
    """Phase 6's optimizer (SGD + momentum 0.9, LR 0.1, weight decay 1e-4,
    clip 10) bound to ``model``."""
    return TrainState.create(model, make_optimizer(
        make_schedule("constant", 0.1), grad_clip=10.0))


def update_of(model, start: dict) -> torch.Tensor:
    """The parameters' update since ``start``, flat, float64."""
    return torch.cat([(p.detach() - start[k]).double().flatten()
                      for k, p in model.named_parameters()])


def record_step_calls(step, state, batch) -> tuple:
    """``step(state, batch, None)`` with every ``segment_csr`` call (inputs
    cloned) and every ``segment_csr_bwd`` call recorded."""
    fwd, bwd = [], []
    inner_f, inner_b = seg.segment_csr, seg.segment_csr_bwd

    def rf(x, ptr, valid, reduce):
        fwd.append((x.detach().clone(), ptr.clone(),
                    None if valid is None else valid.clone(), reduce))
        return inner_f(x, ptr, valid, reduce)

    def rb(g, x, out, ptr, valid, reduce, num_rows=None):
        bwd.append((g.clone(), x, out, ptr, valid, reduce, num_rows))
        return inner_b(g, x, out, ptr, valid, reduce, num_rows)

    seg.segment_csr, seg.segment_csr_bwd = rf, rb
    try:
        state, metrics = step(state, batch, None)
    finally:
        seg.segment_csr, seg.segment_csr_bwd = inner_f, inner_b
    torch.cuda.synchronize()
    return state, metrics, fwd, bwd


def nccl_collectives(col) -> None:
    """The collectives' NCCL paths at world 1 (all_gather_into_tensor,
    reduce_scatter_tensor, all_reduce), forward and gradient."""
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(3, 5, device="cuda", generator=g, requires_grad=True)
    w = torch.randn(3, 5, device="cuda", generator=g)
    y = col.all_gather_blocks(x)
    z = col.all_reduce_sum(x)
    ((y + z) * w).sum().backward()
    if not (torch.equal(y, x) and torch.equal(z, x)
            and torch.equal(x.grad, 2 * w)):
        raise AssertionError("10a: NCCL collectives at world 1 are not the "
                             "identity")


def parallel_step_check(model, np_batch) -> None:
    """10a at the library level (see PARALLEL_*)."""
    import torch.distributed as dist

    from deepviewagg_tpu_torch.parallel import collectives as col
    from deepviewagg_tpu_torch.parallel import mesh as pmesh

    batch = batch_to_torch(np_batch, "cuda")
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    mesh = pmesh.make_mesh()
    plain = []
    for _ in range(2):
        m = copy.deepcopy(model).train()
        state = sgd_state(m)
        step = make_train_step(m)
        state, metrics = step(state, batch, None)
        torch.cuda.synchronize()
        plain.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                      update_of(m, start)))
        del m, state, step
    m = copy.deepcopy(model).train()
    pmesh.replicate(m, mesh)
    state = sgd_state(m)
    step = pmesh.data_parallel_step(
        make_train_step(m, group=mesh.data_group), mesh)
    zero_launches()
    state, metrics, fwd_calls, bwd_calls = record_step_calls(step, state,
                                                             batch)
    launches = dict(seg.LAUNCHES)
    if launches != {"segment_csr": FORWARD_LAUNCHES,
                    "segment_csr_bwd": BACKWARD_LAUNCHES}:
        raise AssertionError(f"10a dp step launches {launches}")
    loss, gnorm, upd = (float(metrics["loss"]), float(metrics["grad_norm"]),
                        update_of(m, start))
    gap = norm_rel(plain[1][2], plain[0][2])
    dp_gap = norm_rel(upd, plain[0][2])
    loss_gap = abs(plain[1][0] - plain[0][0])
    if abs(loss - plain[0][0]) > loss_gap + 1e-6 * abs(plain[0][0]) \
            or dp_gap > max(3 * gap, DP_UPDATE_FLOOR):
        raise AssertionError(f"10a dp vs plain: loss {loss} vs {plain[0][0]}"
                             f" (plain gap {loss_gap}), update {dp_gap} vs "
                             f"the plain steps' own gap {gap}")
    nccl_collectives(col)
    log("10a dp step", backend=dist.get_backend(),
        world=dist.get_world_size(), devices=torch.cuda.device_count(),
        params=sum(p.numel() for p in m.parameters()),
        loss_dp=f"{loss:.7f}", loss_plain=f"{plain[0][0]:.7f}/"
        f"{plain[1][0]:.7f}", loss_bit_equal=loss == plain[0][0],
        grad_norm_dp=f"{gnorm:.6f}", grad_norm_plain=f"{plain[0][1]:.6f}",
        update_rel_gap_dp=f"{dp_gap:.3e}",
        update_rel_gap_plain_runs=f"{gap:.3e}", launches=launches,
        nccl_identity=True)
    del state, step
    check_forward_calls(fwd_calls, "10a dp kernels", "calls_per_forward")
    check_backward_calls(bwd_calls, "10a dp kernels")
    del m, fwd_calls, bwd_calls
    torch.cuda.empty_cache()


def loop_parallel(cli, tmp: Path) -> None:
    """10a through the entry point: ``cli.train`` with
    ``training.data_parallel=true`` on 9e's layout in this process's
    process group, then resumed."""
    root = tmp / "s3dis_raw"
    if not (root / "Area_5").exists():
        write_s3dis_layout(root)
    run_dir = tmp / "parallel_run"
    args = ["--config", str(CONF / "s3dis_benchmark.yaml"),
            f"data.root={root}", f"training.run_dir={run_dir}",
            "training.tensorboard=false", *PARALLEL_LOOP]
    zero_launches()
    with LoopProbe() as probe:
        cli.main(args)
    launches = dict(seg.LAUNCHES)
    probe.check_steps("10a parallel loop")
    mesh = probe.trainer.mesh
    records = read_records(run_dir)
    if (mesh is None or len(probe.losses) != PARALLEL_SPHERES // 4
            or len(records) != 1 or "val_miou" not in records[0]
            or not (run_dir / "latest.pt").exists()):
        raise AssertionError(f"10a parallel loop: mesh {mesh}, "
                             f"{len(probe.losses)} steps, {records}")
    log("10a parallel loop", world=mesh.n_data,
        **probe.summary(), launches=launches,
        val_miou=f"{records[0]['val_miou']:.2f}")
    saved = torch.load(run_dir / "latest.pt", map_location="cpu",
                       weights_only=True)
    restored = []
    with LoopProbe(on_fit=lambda tr: restored.append(
            state_matches(tr, saved))) as resumed:
        cli.main(args + list(PARALLEL_RESUME))
    resumed.check_steps("10a parallel resume")
    if restored != [[]]:
        raise AssertionError(f"10a resume: restored state differs {restored}")
    log("10a parallel resume", restored_bit_equal=True,
        saved_step=saved["step"], steps=len(resumed.losses))


def variant_samples(samples, num_classes: int) -> list:
    """The same voxels and mapping (so the same valid counts) with other
    labels, colours and images."""
    out = []
    for s in samples:
        lab = s.labels
        out.append(dataclasses.replace(
            s, labels=np.where(lab >= 0, (lab + 1) % num_classes, lab),
            feats=np.concatenate([np.roll(s.feats[:, :3], 1, axis=1),
                                  s.feats[:, 3:]], axis=1),
            images=np.roll(s.images, 1, axis=-1)))
    return out


def state_digest(model) -> str:
    import hashlib

    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def gloo_collectives() -> dict:
    """Which collectives gloo runs on CUDA tensors (True) or refuses (the
    error's type)."""
    import torch.distributed as dist

    x = torch.ones(4, device="cuda")
    ops = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(GLOO_WORLD)], x),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(4 * GLOO_WORLD, device="cuda"), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4 // GLOO_WORLD, device="cuda"), x),
    }
    out = {}
    for name, op in ops.items():
        try:
            op()
            torch.cuda.synchronize()
            out[name] = True
        except (RuntimeError, ValueError, NotImplementedError) as e:
            out[name] = type(e).__name__
    return out


def gloo_rank(rank: int, port: int, out_dir: str) -> None:
    """One of 10b's gloo ranks, a spawned process with the model on the
    card: data parallel on the two batches, then swapped, then view
    parallel on the first; writes ``rank<r>.pt``."""
    import datetime
    import pickle

    import torch.distributed as dist

    from deepviewagg_tpu_torch.parallel import mesh as pmesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=GLOO_WORLD,
        rank=rank, timeout=datetime.timedelta(seconds=GLOO_TIMEOUT_S))
    try:
        with open(Path(out_dir) / "batches.pkl", "rb") as f:
            batches = [batch_to_torch(b, "cuda") for b in pickle.load(f)]
        res = {"gloo_cuda": gloo_collectives()}
        model = MultimodalSeg(flagship_spec(), device="cuda", seed=0)
        res["start_digest"] = state_digest(model)
        start_sd = copy.deepcopy(model.state_dict())
        start = {k: p.detach().clone() for k, p in model.named_parameters()}
        with f32_everywhere():
            for name, order, n_model in (("dp", (0, 1), 1),
                                         ("swapped", (1, 0), 1),
                                         ("hybrid", (0, 0), 2)):
                model.load_state_dict(start_sd)
                mesh = (pmesh.make_hybrid_mesh(n_model) if n_model > 1
                        else pmesh.make_mesh())
                state = sgd_state(model.train())
                if n_model > 1:
                    step = pmesh.hybrid_parallel_step(
                        make_train_step(model, group=mesh.world), mesh)
                else:
                    step = pmesh.data_parallel_step(
                        make_train_step(model, group=mesh.data_group), mesh)
                state, m = step(state, batches[order[mesh.data_rank]], None)
                res[name] = {"loss": float(m["loss"]),
                             "grad_norm": float(m["grad_norm"]),
                             "digest": state_digest(model)}
                if rank == 0 and name != "swapped":
                    res[name]["update"] = update_of(model, start).float().cpu()
        torch.save(res, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def one_process_step(model, np_batch) -> dict:
    """One float32-everywhere SGD step of a copy of ``model`` on the card."""
    m = copy.deepcopy(model).train()
    start = {k: p.detach().clone() for k, p in m.named_parameters()}
    with f32_everywhere():
        _, metrics = make_train_step(m)(sgd_state(m),
                                        batch_to_torch(np_batch, "cuda"), None)
    torch.cuda.synchronize()
    out = {"loss": float(metrics["loss"]),
           "grad_norm": float(metrics["grad_norm"]),
           "update": update_of(m, start).float().cpu()}
    del m
    torch.cuda.empty_cache()
    return out


def phase_gloo(model, tmp: Path) -> None:
    """10b: GLOO_WORLD spawned gloo ranks on the one card against one
    process (this one) on the union batch and on the first batch."""
    import multiprocessing
    import pickle

    from deepviewagg_tpu_torch.data.collate import collate
    from deepviewagg_tpu_torch.data.toy import toy_batch

    batch_a, bucket, samples = toy_batch(seed=0, device="cuda",
                                         **SERVE_REQUEST)
    other = variant_samples(samples, model.spec.num_classes)
    batch_b = collate(other, bucket, branch_levels=(0,))
    union_bucket = dataclasses.replace(
        bucket, level_caps=[c * 2 for c in bucket.level_caps],
        num_batches=bucket.num_batches * 2, view_cap=bucket.view_cap * 2,
        pix_cap=bucket.pix_cap * 2, image_cap=bucket.image_cap * 2)
    union = collate(samples + other, union_bucket, branch_levels=(0,))
    if valid_voxels(batch_a) != valid_voxels(batch_b) or \
            valid_voxels(union) != 2 * valid_voxels(batch_a):
        raise AssertionError("10b: the batches' valid counts differ")
    out_dir = tmp / "gloo"
    out_dir.mkdir()
    with open(out_dir / "batches.pkl", "wb") as f:
        pickle.dump([{k: v for k, v in b.items() if k != "meta"}
                     for b in (batch_a, batch_b)], f)
    port = free_port()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=gloo_rank, args=(r, port, str(out_dir)))
             for r in range(GLOO_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        ref_union = one_process_step(model, union)
        ref_a = one_process_step(model, batch_a)
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs) or \
                    time.perf_counter() - t0 > GLOO_TIMEOUT_S:
                raise AssertionError(
                    f"10b gloo ranks: exit codes "
                    f"{[p.exitcode for p in procs]}")
            time.sleep(0.1)
        if any(p.exitcode != 0 for p in procs):
            raise AssertionError(f"10b gloo ranks: exit codes "
                                 f"{[p.exitcode for p in procs]}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    got = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
           for r in range(GLOO_WORLD)]
    if {g["start_digest"] for g in got} != {state_digest(model)}:
        raise AssertionError("10b: the ranks' seeded weights differ from "
                             "this process's")
    for name in ("dp", "swapped", "hybrid"):
        if len({g[name]["digest"] for g in got}) != 1 or \
                len({g[name]["loss"] for g in got}) != 1:
            raise AssertionError(f"10b {name}: the ranks differ after the "
                                 "step")
    checks = {}
    for name, ref in (("dp", ref_union), ("hybrid", ref_a)):
        mine = got[0][name]
        checks[name] = dict(
            loss=abs(mine["loss"] - ref["loss"]) / abs(ref["loss"]),
            grad_norm=abs(mine["grad_norm"] - ref["grad_norm"])
            / ref["grad_norm"],
            update=norm_rel(mine["update"], ref["update"]))
        c = checks[name]
        if not (c["loss"] <= ALL_F32_LOSS_RTOL
                and c["grad_norm"] <= ALL_F32_GRAD_NORM_RTOL
                and c["update"] <= ALL_F32_UPDATE_RTOL):
            raise AssertionError(f"10b {name} vs one process: {c}")
    swap = abs(got[0]["swapped"]["loss"] - got[0]["dp"]["loss"]) \
        / abs(got[0]["dp"]["loss"])
    if swap > SWAP_RTOL:
        raise AssertionError(f"10b: swapping the batches moved the loss by "
                             f"{swap}")
    log("10b gloo", world=GLOO_WORLD,
        gloo_cuda_collectives=got[0]["gloo_cuda"],
        valid_voxels_each=valid_voxels(batch_a))
    for name, c in checks.items():
        log(f"10b {name}",
            vs="union (one process)" if name == "dp" else "one process",
            loss=f"{got[0][name]['loss']:.7f}",
            loss_rel=f"{c['loss']:.2e}", grad_norm_rel=f"{c['grad_norm']:.2e}",
            update_rel=f"{c['update']:.2e}", ranks_bit_equal=True)
    log("10b swapped", loss_rel_to_dp=f"{swap:.2e}", ranks_bit_equal=True)


def free_port() -> int:
    """A free TCP port on localhost."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_parallel(model, np_batch, cli, tmp: Path) -> None:
    """Phase 10: data and view parallelism (see PARALLEL_*, GLOO_*)."""
    import torch.distributed as dist

    from deepviewagg_tpu_torch.parallel import multihost

    multihost.initialize(device="cuda")
    try:
        parallel_step_check(model, np_batch)
        loop_parallel(cli, tmp)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    phase_gloo(model, tmp)


# phase 11: the non-segmentation tasks through their entry point,
# ``deepviewagg_tpu_torch.cli.train_task.main`` (the port of
# scripts/train_task.py), each at that script's own settings: classification
# (SparseConv3dCls, Res16UNet14, 1024 points a shape, batch 2, caps 2048 ..
# 256), detection (VoteNetDet, SA channels (16, 32), (32, 64), 4096
# points), panoptic (PanopticSeg, Res16UNet14, voxel 0.15, caps 12288 ..
# 512, batch 2), registration (RegistrationNet, Res16UNetTest, descriptor
# 16, caps 4096 .. 256), procedural data, TASK_BATCHES batches of one epoch,
# 11a: the run; every step checked (finite loss, TASK_LAUNCHES).  11b: every
# segment_csr forward and backward call of one classification step (the
# global mean and max pools of the coarsest level's batch_idx into
# num_batches + 1 segments) held against the plain versions.  11c: the first
# step of each task on the card and on the CPU from the same weights and
# batch (no dropout), twice: with the production bf16 conv operands, the
# loss within phase 7's TRAIN_LOSS_RTOL and the gradient norm within its
# TRAIN_GRAD_NORM_RTOL (bf16 operands whose rounding flips after the card's
# and the CPU's GEMMs sum in another order; the atomic index_add_ behind
# index_select's backward), then with float32 everywhere at 7g's ALL_F32_*
# bounds; registration's gradient norm is logged, not held (see
# TASK_GRAD_NORM_HELD).
TASKS = ("classification", "detection", "panoptic", "registration")
# scripts/train_task.py's default --batches (4), but registration's: the
# third synthetic pair holds 1044 voxels at level 2, over the script's cap
# of 1024, in both packages (ROADMAP C), so it takes the two pairs before it
TASK_BATCHES = {"classification": 4, "detection": 4, "panoptic": 4,
                "registration": 2}
TASK_LAUNCHES = {"classification": (3, 2), "detection": (0, 0),
                 "panoptic": (0, 0), "registration": (0, 0)}
# registration's first gradient is dominated by rows whose raw descriptor
# is 0 (every backbone channel cut by its ReLU, the head's bias 0): the L2
# normalisation's rsqrt(|d|^2 + 1e-12) multiplies their cotangent by 1e6,
# and which channels pass it back depends on ReLU gates at pre-activations
# of rounding size, which any change of summation order flips.  Its norm
# is discontinuous in the rounding: card vs CPU 4.6e-2 apart with bf16
# operands and 0.22 with float32 ones in phase 11's second H100 run, the
# loss 1.5e-4 and 1e-7.  So it is logged with the count of such rows, and
# only the loss is held.
TASK_GRAD_NORM_HELD = ("classification", "detection", "panoptic")
ZERO_DESCRIPTOR = 1e-6                  # raw descriptor norm of such a row


class TaskProbe(Seams):
    """The seams of one ``cli.train_task.main`` run: every train step
    (loss, launches of each kernel), the task's step builder with its
    arguments, the model's parameters and running statistics as
    ``TaskTrainer.init`` left them, and the first host batch."""

    def __init__(self):
        super().__init__()
        self.losses, self.launches = [], []
        self.make = self.trainer = self.start = self.host_batch = None

    def __enter__(self):
        from deepviewagg_tpu_torch.train import task_steps

        probe = self

        def make_step(original):
            def build(model, *args, **kwargs):
                probe.make = lambda m: original(m, *args, **kwargs)
                step = original(model, *args, **kwargs)

                def run(state, batch, generator):
                    before = dict(seg.LAUNCHES)
                    state, metrics = step(state, batch, generator)
                    loss = float(metrics["loss"])
                    if not np.isfinite(loss):
                        raise AssertionError(
                            f"step {len(probe.losses)}: loss {loss}")
                    probe.losses.append(loss)
                    probe.launches.append(
                        {k: seg.LAUNCHES[k] - before[k] for k in before})
                    return state, metrics
                return run
            return build

        def init(original):
            def run(trainer_self, *args, **kwargs):
                state = original(trainer_self, *args, **kwargs)
                probe.trainer = trainer_self
                probe.start = {k: v.detach().clone() for k, v in
                               trainer_self.model.state_dict().items()}
                return state
            return run

        def to_device(original):
            def run(batch, device="cuda"):
                if probe.host_batch is None:
                    probe.host_batch = batch
                return original(batch, device)
            return run

        for task in TASKS:
            self._patch(task_steps, f"make_{task}_step", make_step)
        self._patch(task_steps.TaskTrainer, "init", init)
        self._patch(task_steps, "batch_to_torch", to_device)
        return self


def task_adam(model):
    """``TaskTrainer``'s optimizer (Adam, constant LR 3e-3, clip 10, no
    weight decay) bound to ``model``."""
    return TrainState.create(model, make_optimizer(
        make_schedule("constant", 3e-3), optimizer="adam", weight_decay=0.0,
        grad_clip=10.0))


def task_first_step(probe, device: str) -> dict:
    """The run's first step again on ``device``: a copy of the model with the
    parameters and running statistics ``init`` gave it, the first batch, no
    dropout generator."""
    model = copy.deepcopy(probe.trainer.model).to(device)
    model.load_state_dict(probe.start)
    step = probe.make(model)
    _, metrics = step(task_adam(model), batch_to_torch(probe.host_batch,
                                                       device), None)
    return {k: float(v) for k, v in metrics.items() if v.ndim == 0}


def zero_descriptor_rows(probe) -> dict:
    """Valid rows of each registration fragment whose raw descriptor (before
    the L2 normalisation) has a norm under ``ZERO_DESCRIPTOR``, on the card
    at the start weights, in training mode as the step sees them."""
    model = copy.deepcopy(probe.trainer.model)
    model.load_state_dict(probe.start)
    batch = batch_to_torch(probe.host_batch, "cuda")
    out = {}
    with torch.no_grad():
        for side in ("a", "b"):
            frag = batch[side]
            raw = model.desc(model.backbone(frag["feats"], frag["graph"]))
            valid = frag["graph"]["levels"][0]["valid"]
            out[f"zero_descriptors_{side}"] = (
                f"{int((raw.norm(dim=1)[valid] < ZERO_DESCRIPTOR).sum())}/"
                f"{int(valid.sum())}")
    return out


def task_card_vs_cpu(task: str, probe) -> None:
    """11c: the first step on the card and on the CPU, same weights and
    batch, with bf16 conv operands and with float32 everywhere."""
    extra = zero_descriptor_rows(probe) if task == "registration" else {}
    for mode, ctx, bounds in (
            ("bf16", contextlib.nullcontext,
             (TRAIN_LOSS_RTOL, TRAIN_GRAD_NORM_RTOL)),
            ("f32", f32_everywhere,
             (ALL_F32_LOSS_RTOL, ALL_F32_GRAD_NORM_RTOL))):
        with ctx():
            card = task_first_step(probe, "cuda")
            cpu = task_first_step(probe, "cpu")
        gaps = {k: abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-12)
                for k in cpu}
        log("11c task card vs cpu", task=task, operands=mode,
            loss_card=f"{card['loss']:.6f}", loss_cpu=f"{cpu['loss']:.6f}",
            grad_norm_card=f"{card['grad_norm']:.4f}",
            grad_norm_cpu=f"{cpu['grad_norm']:.4f}", **extra,
            **{f"{k}_rel_gap": f"{v:.2e}" for k, v in gaps.items()})
        if gaps["loss"] > bounds[0] or (task in TASK_GRAD_NORM_HELD
                                        and gaps["grad_norm"] > bounds[1]):
            raise AssertionError(f"11c {task} {mode}: loss gap "
                                 f"{gaps['loss']}, grad_norm gap "
                                 f"{gaps['grad_norm']} (bounds {bounds})")


def task_kernels(probe) -> None:
    """11b: every segment call of one classification step (a copy of the
    trained model, the first batch) against the plain versions."""
    model = copy.deepcopy(probe.trainer.model)
    _, _, fwd, bwd = record_step_calls(
        probe.make(model), task_adam(model),
        batch_to_torch(probe.host_batch, "cuda"))
    expect = TASK_LAUNCHES["classification"]
    if (len(fwd), len(bwd)) != expect:
        raise AssertionError(f"11b: {len(fwd)} + {len(bwd)} segment calls "
                             f"in one classification step, expected "
                             f"{expect}")
    x, ptr, _, _ = fwd[0]
    log("11b task kernels", rows=x.shape[0], channels=x.shape[1],
        segments=ptr.numel() - 1, ptr=ptr.tolist())
    check_forward_calls(fwd, "11b task kernels", "calls_per_step")
    check_backward_calls(bwd, "11b task kernels")


def phase_tasks() -> None:
    """Phase 11 (see TASK_*)."""
    from deepviewagg_tpu_torch.cli import train_task as cli_task

    launches = {}
    for task in TASKS:
        zero_launches()
        torch.cuda.empty_cache()
        with TaskProbe() as probe:
            metrics = cli_task.main(["--task", task, "--batches",
                                     str(TASK_BATCHES[task])])
        launches[task] = dict(seg.LAUNCHES)
        fwd, bwd = TASK_LAUNCHES[task]
        want = {"segment_csr": fwd, "segment_csr_bwd": bwd}
        if len(probe.losses) != TASK_BATCHES[task] or any(
                d != want for d in probe.launches):
            raise AssertionError(f"11a {task}: {len(probe.losses)} steps, "
                                 f"launches {probe.launches}")
        if launches[task] != {k: v * TASK_BATCHES[task]
                              for k, v in want.items()}:
            raise AssertionError(f"11a {task}: launches {launches[task]}")
        off = [k for k, p in probe.trainer.model.named_parameters()
               if p.device.type != "cuda"]
        if off or not np.isfinite(metrics["loss"]):
            raise AssertionError(f"11a {task}: off the card {off[:3]}, "
                                 f"loss {metrics['loss']}")
        log("11a tasks", task=task, model=type(probe.trainer.model).__name__,
            params=sum(p.numel() for p in probe.trainer.model.parameters()),
            steps=len(probe.losses),
            losses="/".join(f"{v:.4f}" for v in probe.losses),
            launches=launches[task],
            **{k: f"{v:.4f}" for k, v in metrics.items()
               if k not in ("batches", "loss", "time_s")})
        if task == "classification":
            task_kernels(probe)
        task_card_vs_cpu(task, probe)


# --- phase 12: the point backbones ---------------------------------------------

# Each model at its JAX class's default widths, random weights from a seed.
# PointNet (segmentation and classification) and PVCNN take 8 samples of 4096
# points, the PointNet paper's S3DIS block size: synthetic rooms
# (data/synthetic.py) voxelized at 5 cm, 4096 voxels drawn from each, collated
# as the JAX package's tests collate a PointNet batch (32,768 rows, every one
# valid: the padding segment is empty).  The graph backbones take one-sample
# graphs of 16,384 points of another room, with as many levels as the model
# has widths (a multi-sample graph collapses under ``_separated``'s float32
# shift in both packages, ROADMAP C): build_pointnet_graph at n_points (4096,
# 1024, 256), radii (0.15, 0.3, 0.6) (KPConv's and PPNet's defaults; RSConv
# and PointCNN have none of their own), k 32, self_k 16 for PPNet's
# bottlenecks (one graph serves the four); build_randla_graph at decimation 4,
# k 16.  PVCNN's grids at its default resolutions.
BACKBONE_SAMPLES, BACKBONE_BLOCK = 8, 4096
BACKBONE_VOXEL = 0.05
BACKBONE_GRAPH_POINTS = 16384
BACKBONE_LEVELS = (4096, 1024, 256)
BACKBONE_RADII = (0.15, 0.3, 0.6)
BACKBONE_K, PPNET_SELF_K = 32, 16
RANDLA_DECIMATION, RANDLA_K = 4, 16
PVCNN_RESOLUTIONS = (24, 16, 12)
SEG_CLASSES, CLS_CLASSES = 13, 40
BACKBONE_STEPS = 6                           # train steps (Adam, task_adam)
# name: ((forward, backward) sorted-segment launches per train step, bf16
# operands).  PointNet: three masked maxima over batch_idx (T-Net 3, T-Net
# 64, the global descriptor), each differentiated; PVCNN: the voxel mean's
# sum and count per block, of which the sums of blocks 2 and 3 (whose input
# takes a gradient) run backward; the others launch none
BACKBONES = {
    "pointnet_seg": ((3, 3), False), "pointnet_cls": ((3, 3), False),
    "pvcnn": ((6, 2), True), "kpconv": ((0, 0), True),
    "rsconv": ((0, 0), False), "pointcnn": ((0, 0), True),
    "ppnet": ((0, 0), False), "randlanet": ((0, 0), False),
}


def backbone_blocks() -> dict:
    """12's PointNet / PVCNN batch (see BACKBONE_*), as numpy: the collated
    rows, ``valid`` and PVCNN's ``pv_*`` grid tables, ``cls_label`` one
    class per sample."""
    from deepviewagg_tpu_torch.data.collate import (Bucket, Sample, collate,
                                                    device_view)
    from deepviewagg_tpu_torch.data.synthetic import make_scene
    from deepviewagg_tpu_torch.nn.pvcnn import normalize_to_grid
    from deepviewagg_tpu_torch.ops.voxel import grid_sample

    rng = np.random.default_rng(0)
    samples = []
    for s in range(BACKBONE_SAMPLES):
        scene = make_scene(seed=s, n_cameras=1, image_size=(32, 16))
        g = grid_sample(scene.pos, BACKBONE_VOXEL, feats=scene.rgb,
                        labels=scene.labels)
        take = np.sort(rng.choice(len(g["pos"]), BACKBONE_BLOCK,
                                  replace=False))
        samples.append(Sample(
            coords=g["coords"][take, 1:], labels=g["labels"][take],
            pos=g["pos"][take], feats=np.concatenate(
                [g["feats"][take], np.ones((BACKBONE_BLOCK, 1), np.float32)],
                1)))
    rows = BACKBONE_SAMPLES * BACKBONE_BLOCK
    batch = device_view(collate(samples, Bucket(
        level_caps=[rows] * 5, num_batches=BACKBONE_SAMPLES), conv0_kernel=3))
    lvl = batch["graph"]["levels"][0]
    batch["valid"] = lvl["valid"]
    batch["cls_label"] = (np.arange(BACKBONE_SAMPLES) % CLS_CLASSES).astype(
        np.int32)
    batch["pv_batch_idx"] = lvl["batch_idx"]
    batch["pv_resolution"] = PVCNN_RESOLUTIONS[0]
    batch["pv_grid_coords"] = normalize_to_grid(
        batch["pos"], lvl["batch_idx"], lvl["valid"], PVCNN_RESOLUTIONS[0],
        BACKBONE_SAMPLES)[0]
    for r in PVCNN_RESOLUTIONS:
        batch[f"pv_key_r{r}"] = normalize_to_grid(
            batch["pos"], lvl["batch_idx"], lvl["valid"], r,
            BACKBONE_SAMPLES)[1]
    return batch


def backbone_graphs() -> tuple:
    """12's one-sample graph batches (see BACKBONE_*), as numpy: the
    pointnet graph (with PPNet's same-level tables) and the RandLA one."""
    from deepviewagg_tpu_torch.data.synthetic import make_scene
    from deepviewagg_tpu_torch.nn.pointnet2 import build_pointnet_graph
    from deepviewagg_tpu_torch.nn.randlanet import build_randla_graph

    scene = make_scene(seed=100, n_cameras=1, image_size=(32, 16))
    rng = np.random.default_rng(1)
    take = np.sort(rng.choice(len(scene.pos), BACKBONE_GRAPH_POINTS,
                              replace=False))
    pos = scene.pos[take].astype(np.float32)
    n = len(pos)
    zeros, valid = np.zeros(n, np.int32), np.ones(n, bool)
    points = {"feats": np.concatenate([scene.rgb[take].astype(np.float32),
                                       np.ones((n, 1), np.float32)], 1),
              "valid": valid, "labels": scene.labels[take].astype(np.int32)}
    pn = build_pointnet_graph(pos, zeros, valid, n_points=BACKBONE_LEVELS,
                              radii=BACKBONE_RADII, k=BACKBONE_K,
                              self_k=PPNET_SELF_K)
    rl = build_randla_graph(pos, zeros, valid, decimation=RANDLA_DECIMATION,
                            num_levels=len(BACKBONE_LEVELS), k=RANDLA_K)
    log("12 backbones", part="graphs", points=n,
        group_count_mean="/".join(f"{lvl['group_count'].mean():.1f}"
                                  for lvl in pn["levels"]))
    return dict(points, pn_graph=pn), dict(points, rl_graph=rl)


def build_backbone(name: str, device: str, seed=0):
    """Model ``name`` of BACKBONES at its JAX class's default widths."""
    from deepviewagg_tpu_torch.nn import (kpconv, pointcnn, pointnet, ppnet,
                                          pvcnn, randlanet, rsconv)

    kw = dict(device=device, seed=seed)
    return {
        "pointnet_seg": lambda: pointnet.PointNetSeg(
            SEG_CLASSES, 4, BACKBONE_SAMPLES, **kw),
        "pointnet_cls": lambda: pointnet.PointNetCls(
            CLS_CLASSES, 4, BACKBONE_SAMPLES, **kw),
        "pvcnn": lambda: pvcnn.PVCNNSeg(SEG_CLASSES, 4,
                                        resolutions=PVCNN_RESOLUTIONS,
                                        num_batches=BACKBONE_SAMPLES, **kw),
        "kpconv": lambda: kpconv.KPConvSeg(SEG_CLASSES, 4,
                                           radii=BACKBONE_RADII, **kw),
        "rsconv": lambda: rsconv.RSConvSeg(SEG_CLASSES, 4, **kw),
        "pointcnn": lambda: pointcnn.PointCNNSeg(SEG_CLASSES, 4, BACKBONE_K,
                                                 **kw),
        "ppnet": lambda: ppnet.PPNetSeg(SEG_CLASSES, 4, radii=BACKBONE_RADII,
                                        bottlenecks=True, **kw),
        "randlanet": lambda: randlanet.RandLANetSeg(SEG_CLASSES, 4, **kw),
    }[name]()


def backbone_step(model, name: str):
    """One Adam step of ``model``: CE over the samples for the classifier
    (``make_classification_step``), the masked per-point CE for the
    segmentation nets; metrics ``loss`` and ``grad_norm`` (before
    clipping)."""
    from deepviewagg_tpu_torch.train import task_steps

    if name == "pointnet_cls":
        return task_steps.make_classification_step(model)

    def step(state, batch, generator=None):
        model.train()
        logits = model(batch)["logits"]
        loss = segmentation_loss(logits, batch["labels"], batch["valid"])
        # the task steps' backward, gradient norm and update
        return task_steps._update(state, model, loss, {})

    return step


def backbone_run(name: str, host_batch: dict) -> tuple:
    """12a: one eval-mode forward and BACKBONE_STEPS train steps of
    ``name`` on the card, every step's segment launches asserted; returns
    the model's start state (parameters and running statistics), the
    trained model, its optimizer state and the batch on the card."""
    (fwd, bwd), _ = BACKBONES[name]
    zero_launches()
    torch.cuda.empty_cache()
    model = build_backbone(name, "cuda")
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    batch = batch_to_torch(host_batch, "cuda")
    rows = (BACKBONE_SAMPLES if name == "pointnet_cls"
            else host_batch["feats"].shape[0])
    with torch.no_grad():
        logits = model.eval()(batch)["logits"]
    want_classes = CLS_CLASSES if name == "pointnet_cls" else SEG_CLASSES
    if logits.shape != (rows, want_classes) or not torch.isfinite(
            logits).all():
        raise AssertionError(f"12a {name}: eval logits {tuple(logits.shape)}"
                             f", finite {bool(torch.isfinite(logits).all())}")
    if seg.LAUNCHES != {"segment_csr": fwd, "segment_csr_bwd": 0}:
        raise AssertionError(f"12a {name}: eval forward launched "
                             f"{seg.LAUNCHES}, expected {fwd} + 0")
    step, state = backbone_step(model, name), task_adam(model)
    losses = []
    for i in range(BACKBONE_STEPS):
        before = dict(seg.LAUNCHES)
        state, metrics = step(state, batch, None)
        losses.append(float(metrics["loss"]))
        got = {k: seg.LAUNCHES[k] - before[k] for k in before}
        if got != {"segment_csr": fwd, "segment_csr_bwd": bwd}:
            raise AssertionError(f"12a {name} step {i}: launches {got}, "
                                 f"expected {fwd} + {bwd}")
        if not (np.isfinite(losses[-1])
                and np.isfinite(float(metrics["grad_norm"]))):
            raise AssertionError(f"12a {name} step {i}: loss {losses[-1]}, "
                                 f"grad_norm {float(metrics['grad_norm'])}")
    off = [k for k, p in model.named_parameters() if p.device.type != "cuda"]
    if off:
        raise AssertionError(f"12a {name}: parameters off the card {off[:3]}")
    log("12a backbones", model=name, cls=type(model).__name__,
        params=sum(p.numel() for p in model.parameters()), rows=rows,
        steps=len(losses), losses="/".join(f"{v:.4f}" for v in losses),
        launches_per_step=f"{fwd}+{bwd}", launches=dict(seg.LAUNCHES))
    return start, model, state, batch


def backbone_kernels(name: str, model, state, batch) -> None:
    """12b: every segment call of one train step of ``name`` (the trained
    model) held against the plain versions."""
    (fwd_n, bwd_n), _ = BACKBONES[name]
    _, _, fwd, bwd = record_step_calls(backbone_step(model, name), state,
                                       batch)
    if (len(fwd), len(bwd)) != (fwd_n, bwd_n):
        raise AssertionError(f"12b {name}: {len(fwd)} + {len(bwd)} segment "
                             f"calls in one step, expected {fwd_n} + "
                             f"{bwd_n}")
    x, ptr, _, _ = max(fwd, key=lambda c: c[0].numel())
    log("12b backbone kernels", model=name, widest_rows=x.shape[0],
        channels=x.shape[1], segments=ptr.numel() - 1)
    phase = f"12b {name} kernels"
    check_forward_calls(fwd, phase, "calls_per_step")
    check_backward_calls(bwd, phase)


def backbone_card_vs_cpu(name: str, start: dict, host_batch: dict) -> None:
    """12c: the first step of ``name`` on the card and on the CPU, from the
    same weights and batch: bf16 operands within phase 7's bounds (loss
    1e-2, gradient norm 3e-2), float32 models within 7g's (1e-4, 2e-3)."""
    _, bf16 = BACKBONES[name]
    got = {}
    for device in ("cuda", "cpu"):
        model = build_backbone(name, device, seed=None)
        model.load_state_dict(start)
        _, metrics = backbone_step(model, name)(
            task_adam(model), batch_to_torch(host_batch, device), None)
        got[device] = {k: float(metrics[k]) for k in ("loss", "grad_norm")}
        del model
    bounds = ((TRAIN_LOSS_RTOL, TRAIN_GRAD_NORM_RTOL) if bf16
              else (ALL_F32_LOSS_RTOL, ALL_F32_GRAD_NORM_RTOL))
    gaps = {k: abs(got["cuda"][k] - got["cpu"][k])
            / max(abs(got["cpu"][k]), 1e-12) for k in ("loss", "grad_norm")}
    log("12c backbone card vs cpu", model=name,
        operands="bf16" if bf16 else "f32",
        loss_card=f"{got['cuda']['loss']:.6f}",
        loss_cpu=f"{got['cpu']['loss']:.6f}",
        grad_norm_card=f"{got['cuda']['grad_norm']:.5f}",
        grad_norm_cpu=f"{got['cpu']['grad_norm']:.5f}",
        loss_rel_gap=f"{gaps['loss']:.2e}",
        grad_norm_rel_gap=f"{gaps['grad_norm']:.2e}", bounds=bounds)
    if gaps["loss"] > bounds[0] or gaps["grad_norm"] > bounds[1]:
        raise AssertionError(f"12c {name}: loss gap {gaps['loss']}, "
                             f"grad_norm gap {gaps['grad_norm']} (bounds "
                             f"{bounds})")


def phase_backbones() -> None:
    """Phase 12 (see BACKBONE_*)."""
    blocks = backbone_blocks()
    graph, randla = backbone_graphs()
    lvl = blocks["graph"]["levels"][0]
    log("12 backbones", part="batches", rows=blocks["feats"].shape[0],
        valid=int(lvl["valid"].sum()), samples=BACKBONE_SAMPLES,
        graph_points=graph["feats"].shape[0])
    for name in BACKBONES:
        host = (blocks if name.startswith("pointnet") or name == "pvcnn"
                else randla if name == "randlanet" else graph)
        start, model, state, batch = backbone_run(name, host)
        if BACKBONES[name][0] != (0, 0):
            backbone_kernels(name, model, state, batch)
        del model, state, batch
        torch.cuda.empty_cache()
        backbone_card_vs_cpu(name, start, host)

# phase 13: the native host builders (deepviewagg_tpu_torch/native:
# kernelmap.cpp built by g++ in phase 1), the HTML viewer with its demo and
# the kNN transforms.  13a: the UNet graph of 9b's first train batch (every
# level's coordinates, maps and parents) built by the native builders and by
# the numpy versions (``*_plain``), byte-equal; unique_coords /
# query_coords on 9e's Area_1 raw cloud at the recipe's 5 cm, the same.  13b: the scale rehearsal's cloud (scene
# seed 0 at its defaults, voxelized at 4 cm, centred: the brute force's
# expanded form loses ~1e-4 at 24 m from the origin): the host's grid kNN at
# the rehearsal's k against the card's brute force, at the JAX package's
# own bounds (distances rtol 1e-3 / atol 2e-4 row by row; ids >= 99.9%
# equal, or else every differing id a tie with the k-th distance within
# that bound: the voxel means of planes hold many), then pca_features on
# the card through the host path (one grid kNN call).  13c:
# ``cli.demo_synthetic`` on the card at its defaults (4 epochs of 8 steps):
# the files, the viewer's data, each panel decoded to its image's bytes,
# FORWARD_LAUNCHES + BACKWARD_LAUNCHES a step (the flagship's pools) and
# FORWARD_LAUNCHES an eval forward, every segment call of its first batch's
# forward and backward against plain.  13d: RandomWalkDropout then
# DensityFilter on a sphere of 9e's Area_1 voxels, on the card and on the
# CPU from one seed: equal clouds.  The sphere is centred and rounded to
# multiples of TIES_LATTICE (within 1 m every product and sum of the kNN's
# expanded squared distances is then exact in float32 on both devices), and
# thinned until no point's TIES_K + 1 nearest hold equal distances.
GRID_K = 30                       # the rehearsal's pca_features k
GRID_RTOL, GRID_ATOL, GRID_IDS = 1e-3, 2e-4, 0.999
REHEARSAL_ROOM, REHEARSAL_POINTS, REHEARSAL_VOXEL = (24.0, 18.0, 3.0), 1e6, 0.04
TIES_LATTICE, TIES_K, SPHERE_RADIUS = 2.0 ** -10, 9, 1.0
DEMO_EPOCHS, DEMO_STEPS = 4, 8    # cli.demo_synthetic's defaults


class FirstGraph(Seams):
    """The arguments of the run's first ``build_unet_graph`` call (the
    collate of its first train batch)."""

    def __init__(self):
        super().__init__()
        self.args = None

    def __enter__(self):
        from deepviewagg_tpu_torch.ops import sparse_graph

        def make(original):
            def run(coords, *args, **kwargs):
                if self.args is None:
                    self.args = (np.array(coords, copy=True), args,
                                 dict(kwargs))
                return original(coords, *args, **kwargs)
            return run

        self._patch(sparse_graph, "build_unet_graph", make)
        return self


class PlainBuilders(Seams):
    """The numpy versions of the host builders in place of the native
    ones, for one block."""

    def __enter__(self):
        from deepviewagg_tpu_torch.ops import kernel_map, sparse_graph, voxel

        for owner, name in ((voxel, "unique_coords"), (voxel, "query_coords"),
                            (kernel_map, "build_kernel_map"),
                            (sparse_graph, "_build_padded_map")):
            plain = getattr(owner, name + "_plain")
            self._patch(owner, name, lambda original, plain=plain: plain)
        return self


class KnnGridCalls(Seams):
    """The number of ``ops.knn.knn_grid`` calls (``pca_features`` past
    HOST_KNN_POINTS points)."""

    def __init__(self):
        super().__init__()
        self.calls = 0

    def __enter__(self):
        from deepviewagg_tpu_torch.ops import knn

        def grid(original):
            def run(*args, **kwargs):
                self.calls += 1
                return original(*args, **kwargs)
            return run

        self._patch(knn, "knn_grid", grid)
        return self


def same_bytes(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


def native_graph(first) -> None:
    """13a: the graph of 9b's first batch, native against plain."""
    from deepviewagg_tpu_torch.ops import sparse_graph as sg

    coords, args, kwargs = first

    def build():
        return sg.build_unet_graph(coords, *args, **kwargs)

    native = build()
    with PlainBuilders():
        plain = build()
    a, b = sg.graph_to_device(native), sg.graph_to_device(plain)
    maps = 0
    for lvl, (x, y) in enumerate(zip(a["levels"], b["levels"])):
        for key in x:
            if sorted(x) != sorted(y) or not same_bytes(x[key], y[key]):
                raise AssertionError(f"13a level {lvl} {key}: native and "
                                     "plain differ")
            maps += key.endswith("_nbr")
    if not same_bytes(a["conv0_nbr"], b["conv0_nbr"]):
        raise AssertionError("13a conv0_nbr: native and plain differ")
    log("13a native graph", voxels=len(coords),
        levels="/".join(str(lvl.num_valid) for lvl in native.levels),
        caps="/".join(str(len(lvl.valid)) for lvl in native.levels),
        maps=maps + 1, equal="bytes")


def native_grid(root: Path) -> None:
    """13a: unique_coords / query_coords on 9e's Area_1 raw cloud."""
    from deepviewagg_tpu_torch.data.datasets.base import load_area
    from deepviewagg_tpu_torch.ops import voxel

    raw = load_area(str(root / "processed_dva" / "area_1.npz"))["raw_pos"]
    coords = np.concatenate([np.zeros((len(raw), 1), np.int32), np.round(
        raw / 0.05).astype(np.int32)], 1)
    uniq, inverse = voxel.unique_coords(coords)
    uniq_p, inverse_p = voxel.unique_coords_plain(coords)
    hit = voxel.query_coords(uniq, coords)
    hit_p = voxel.query_coords_plain(uniq, coords)
    if not (same_bytes(uniq, uniq_p) and same_bytes(inverse, inverse_p)
            and same_bytes(hit, hit_p)):
        raise AssertionError("13a Area_1 grid: native and plain differ")
    if not np.array_equal(hit, inverse):
        raise AssertionError("13a Area_1 grid: a row does not find its voxel")
    log("13a native grid", raw_points=len(raw), voxels=len(uniq),
        equal="bytes")


def boundary_ties(pos, idg, sg, sb) -> float:
    """Over the rows whose two neighbour sets differ: how far each differing
    id's exact (float64) distance lies outside the GRID_* bound around the
    row's k-th distance (<= 0: every difference is a tie at the boundary,
    which either kNN may break its own way)."""
    p = pos.astype(np.float64)
    worst = -np.inf
    for r in np.nonzero((sg != sb).any(1))[0]:
        diff = np.setxor1d(sg[r], sb[r])
        d = ((p[diff] - p[r]) ** 2).sum(1)
        kth = ((p[idg[r, -1]] - p[r]) ** 2).sum()
        worst = max(worst, float((np.abs(d - kth)
                                  - (GRID_ATOL + GRID_RTOL * kth)).max()))
    return worst


def native_knn() -> None:
    """13b: the host's grid kNN against the card's brute force on the
    rehearsal's cloud, then pca_features through the host path."""
    from deepviewagg_tpu_torch.data import synthetic
    from deepviewagg_tpu_torch.data.geometric import pca_features
    from deepviewagg_tpu_torch.ops import knn
    from deepviewagg_tpu_torch.ops.voxel import grid_sample

    room = REHEARSAL_ROOM
    area = 2 * (room[0] * room[1] + room[0] * room[2] + room[1] * room[2])
    scene = synthetic.make_scene(seed=0, room=room,
                                 density=REHEARSAL_POINTS / area, n_boxes=10,
                                 n_cameras=24, image_size=(512, 256),
                                 r_max=16.0)
    pos = grid_sample(scene.pos, REHEARSAL_VOXEL)["pos"]
    pos = pos - pos.mean(0)
    d2g, idg = knn.knn_grid(pos, pos, GRID_K)
    pos_t = torch.as_tensor(pos, device="cuda")
    d2b, idb = (t.cpu().numpy() for t in knn.knn(pos_t, pos_t, GRID_K))
    bs = np.sort(d2b, 1)
    excess = float((np.abs(np.sort(d2g, 1) - bs)
                    - (GRID_ATOL + GRID_RTOL * np.abs(bs))).max())
    sg, sb = np.sort(idg, 1), np.sort(idb, 1)
    ids = float((sg == sb).mean())
    tie = boundary_ties(pos, idg, sg, sb)
    if excess > 0 or (ids < GRID_IDS and tie > 0):
        raise AssertionError(f"13b grid vs brute: distances over the bound "
                             f"by {excess:.3e}, ids {ids:.5f}, a differing "
                             f"id {tie:.3e} off the k-th distance's bound")
    if not np.array_equal(idg[:, 0], np.arange(len(pos))):
        raise AssertionError("13b grid kNN: a point is not its own first")
    del d2b, idb, bs, sg, sb
    with KnnGridCalls() as grid:
        geo = pca_features(pos, k=GRID_K, device="cuda")
    if grid.calls != 1 or not np.array_equal(
            geo["nn_idx"].cpu().numpy(), idg):
        raise AssertionError(f"13b pca_features: {grid.calls} grid kNN "
                             "calls, or other neighbours")
    if not all(bool(torch.isfinite(v).all()) for v in geo.values()
               if v.dtype.is_floating_point):
        raise AssertionError("13b pca_features: non-finite features")
    log("13b native knn", raw_points=len(scene.pos), voxels=len(pos),
        k=GRID_K, ids_equal=f"{ids:.6f}",
        differing_ids_off_kth_tie=f"{tie:.3e}", distance_excess=f"{excess:.3e}",
        pca_grid_calls=grid.calls, rtol=GRID_RTOL, atol=GRID_ATOL)
    del geo
    torch.cuda.empty_cache()


def panel_pixels(b64: str, tmp: Path) -> np.ndarray:
    import base64

    from deepviewagg_tpu_torch.utils.image_io import read_png

    path = tmp / "panel.png"
    path.write_bytes(base64.b64decode(b64))
    return read_png(str(path))


def native_demo(tmp: Path) -> None:
    """13c: ``cli.demo_synthetic`` on the card at its defaults."""
    from deepviewagg_tpu_torch.cli import demo_synthetic

    out_dir = tmp / "demo"
    zero_launches()
    with LoopProbe() as probe:
        out = demo_synthetic.main(["--out", str(out_dir)])
    launches = dict(seg.LAUNCHES)
    probe.check_steps("13c demo")
    steps, forwards = DEMO_EPOCHS * DEMO_STEPS, DEMO_EPOCHS + 1
    want = {"segment_csr": (steps + forwards) * FORWARD_LAUNCHES,
            "segment_csr_bwd": steps * BACKWARD_LAUNCHES}
    if len(probe.losses) != steps or launches != want:
        raise AssertionError(f"13c demo: {len(probe.losses)} steps, "
                             f"launches {launches}, expected {want}")
    html = Path(out["html"]).read_text()
    start = html.index("const D = ") + len("const D = ")
    data = json.loads(html[start:html.index(
        ";\ndocument.getElementById('title')", start)])
    sample = out["sample"]
    if sorted(data) != ["modes", "panels", "pos", "title"] \
            or len(data["pos"]) != len(sample.pos) \
            or sorted(data["modes"]) != ["labels", "preds", "rgb"] \
            or len(data["panels"]) != len(sample.images):
        raise AssertionError(f"13c viewer data: {sorted(data)}")
    for panel, img in zip(data["panels"], sample.images):
        want_px = (np.clip(img, 0, 1) * 255).astype(np.uint8).transpose(
            1, 0, 2)
        if not np.array_equal(panel_pixels(panel["png"], tmp), want_px):
            raise AssertionError("13c viewer: a panel is not its image")
    log("13c demo", steps=len(probe.losses),
        losses=f"{probe.losses[0]:.4f}/{probe.losses[-1]:.4f}",
        val_miou=f"{out['metrics']['val_miou']:.2f}",
        launches=launches, ply_bytes=Path(out["ply"]).stat().st_size,
        html_bytes=len(html), panels=len(data["panels"]),
        points=len(data["pos"]))
    model, batch = probe.trainer.model, probe.batch
    del probe
    calls = record_segment_calls(model.eval(), batch)
    if len(calls) != FORWARD_LAUNCHES:
        raise AssertionError(f"13c: {len(calls)} segment calls a forward")
    check_forward_calls(calls, "13c demo kernels", "calls_per_forward")
    del calls
    bwd_calls = record_backward_calls(model.train(), batch)
    if len(bwd_calls) != BACKWARD_LAUNCHES:
        raise AssertionError(f"13c: {len(bwd_calls)} segment backwards")
    check_backward_calls(bwd_calls, "13c demo kernels")
    del bwd_calls, model, batch
    torch.cuda.empty_cache()


def ties_free(pos: np.ndarray) -> np.ndarray:
    """Rows of ``pos`` (multiples of TIES_LATTICE) kept so that no point's
    TIES_K + 1 nearest hold two equal distances (exact integers)."""
    keep = np.arange(len(pos))
    while True:
        p = np.round(pos[keep] / TIES_LATTICE).astype(np.int64)
        d = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
        near = np.sort(d, axis=1)[:, :TIES_K + 2]
        tied = (np.diff(near, axis=1) == 0).any(axis=1)
        if not tied.any():
            return keep
        keep = keep[~tied]


def native_transforms(root: Path) -> None:
    """13d: the kNN transforms on the card and on the CPU."""
    from deepviewagg_tpu_torch.data import transforms3d as t3
    from deepviewagg_tpu_torch.data.datasets.base import load_area

    cache = load_area(str(root / "processed_dva" / "area_1.npz"))
    pos = cache["pos"]
    centre = pos[np.argmin(np.linalg.norm(pos - np.median(pos, 0), axis=1))]
    near = np.nonzero(np.linalg.norm(pos - centre, axis=1)
                      < SPHERE_RADIUS)[0]
    q = (np.round((pos[near] - centre) / TIES_LATTICE) * TIES_LATTICE).astype(
        np.float32)
    _, first = np.unique(q, axis=0, return_index=True)
    rows = np.sort(first)
    rows = rows[ties_free(q[rows])]
    cloud = {"pos": q[rows], "rgb": cache["rgb"][near][rows],
             "labels": cache["labels"][near][rows]}
    out = on_both(lambda device: t3.Compose([
        t3.RandomWalkDropout(device=device),
        t3.DensityFilter(radius_nn=0.1, min_num=4, device=device)])(
            dict(cloud), np.random.default_rng(0)))
    for key in cloud:
        if not same_bytes(out["cuda"][key], out["cpu"][key]):
            raise AssertionError(f"13d transforms: {key} differs card vs CPU")
    kept = len(out["cuda"]["pos"])
    if not 16 <= kept < len(cloud["pos"]):
        raise AssertionError(f"13d transforms kept {kept} of "
                             f"{len(cloud['pos'])}")
    log("13d transforms", sphere_voxels=len(near), ties_free=len(rows),
        kept=kept, equal="bytes")


def phase_native(graph: tuple, tmp: Path) -> None:
    """Phase 13; 9b's first graph build in ``graph``, 9e's layout under
    ``tmp``."""
    root = tmp / "s3dis_raw"
    native_graph(graph)
    native_grid(root)
    native_knn()
    native_demo(tmp)
    native_transforms(root)


def main() -> None:
    device = phase_card()
    phase_build()
    phase_kernels()
    model = MultimodalSeg(flagship_spec(), device="cuda", seed=0).eval()
    log("3 serving", model="flagship", params=sum(
        p.numel() for p in model.parameters()))
    requests = [make_request(seed, "cuda", **SERVE_REQUEST)
                for seed in range(3)]
    phase_serving(model, requests)
    check_request = make_request(0, "cuda", **CHECK_REQUEST)
    phase_card_vs_cpu(model, check_request)
    phase_cameras_card_vs_cpu()
    # training runs on a copy, so the serving model keeps its weights
    phase_training(copy.deepcopy(model).train(), requests[0], requests[1])
    torch.cuda.empty_cache()
    plain_step = phase_train_card_vs_cpu(model, check_request)
    phase_train_variants(model, check_request, plain_step)
    phase_tower_card_vs_cpu(model, check_request)
    phase_recipe(model)
    torch.cuda.empty_cache()
    # phases 9, 10 and 13 share one temporary directory (10a trains on 9e's
    # layout), deleted afterwards
    from deepviewagg_tpu_torch.cli import train as cli

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_loop_"))
    try:
        graph = phase_loop(tmp)
        phase_parallel(model, requests[0], cli, tmp)
        phase_native(graph, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    phase_tasks()
    phase_backbones()
    log("done")
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
