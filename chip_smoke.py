"""Smoke run of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Phases (each prints its lines; any failure raises and exits non-zero):

1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build the kernels (``nextou_tpu_torch/csrc/*.cu``), one nvcc per source
   and all started together, for sm_90a;
3. K1 (inference forward) against its plain PyTorch version at every kNN
   shape of one flagship forward on the serving path (2 tiles x 2 mirror
   variants = batch 4), in bf16 and in f32. Tolerance: at most 0.1% of
   output rows may differ, and every row that differs must be a near tie of
   the plain version (its k-th and (k+1)-th distances within 1e-4: f32
   accumulation-order noise over C <= 324 terms; bf16 products are exact in
   f32, and f32 coordinates go through the 3xTF32 split). The share is taken
   over at least 10,000 rows per shape: a small shape is drawn again with
   fresh seeded inputs until it has that many. Per shape the time beside the
   first design's (``FIRST_DESIGN_MS``), the plain version's, the bound and
   the CTAs the kernel launches;
4. K2 (indices), K3 (training forward: max and indices) and K4 (backward)
   at every kNN shape of one flagship train step at batch 2, f32
   coordinates with bf16 and with f32 values. K2's indices equal to K3's
   everywhere, and held against the plain version's row by row: a row may
   differ as a set only on a near tie of phase 3, and in its order alone only
   where two of its k nearest are within 1e-4; at most 0.1% of the rows
   differ as sets and 1% in their order alone. K3's max bit-equal to the plain version's wherever the set
   is. K4 against its plain version on K3's own indices, within rtol 1e-5
   and atol 1e-6 + 2e-6 x the sum of the absolute contributions to that
   entry (a pooled candidate receives hundreds of f32 contributions, which
   the plain version's ``index_add_`` adds in another order), bit-exact
   where every candidate receives one contribution, within the tolerance on
   a hot candidate (every one of 10,752 rows names candidate 0, at s3
   pool's M, C and k, in bf16 and f32), the same bits on a second launch in
   both, and non-zero for bf16 queries with f32 candidates; K4's time per
   shape beside its first design's, split by kernel (the scatter, the sum of
   the chunks' partials) under ``torch.profiler``, with its plan. Every time beside its bound: the larger of
   the bytes moved at 3.35 TB/s and the operations at the card's peak for
   their type; for the selection on f32 coordinates (K1's f32
   instantiation, K2, K3, T1) the rate of an f32-accurate tensor-core
   product, three TF32 products per term at 495 TFLOP/s (2 B N M C / 165e12
   s), not the f32 FMA peak, which a tensor-core kernel would read under.
   Times beside the first design's too. No flagship graph is dilated, so K2 never runs at these
   shapes: its record comes from the shapes of the small dilated network of
   phase 8 (``k * dilation`` neighbours), held against the plain version
   there in the same way;
5. the serving slice: a ``3d_fullres_nextou`` plans folder, two seeded
   1x64x280x240 cases and a seeded flagship checkpoint go through
   ``nextou_tpu_torch.predict.main`` with 8-way mirror TTA, tile batch 2, in
   bf16; K1's launch count must be 14 per forward; then seconds per volume,
   peak device memory, and the probabilities of one case;
6. a small network predicted on the card in f32 against the CPU;
7. the training slice: the flagship with deep supervision, batch 2, bf16
   compute and f32 parameters, takes 3 optimizer steps with Dice + CE and 2
   with the BTI Synapse loss, then one eval step. Losses and gradient norms
   finite, every parameter moved (but the biases under a normalization and
   the zero-weight head's) and the BatchNorm statistics too, K3 and K4 launched 14
   times per step, the eval statistics consistent; seconds per step, patches
   per second, peak device memory; then two steps with every stage
   recomputed in the backward pass (K3 launched 28 times per step, K4 14);
8. a small network trained for 2 steps on the card (K3, K4, and K2 through
   one dilated stage) against the same 2 steps on the CPU (plain versions),
   each step from the same state;
9. the conv kernel K5 against its plain version at the five flagship convs
   that ``conv_kernel="1"`` hands to it (the list is derived from the spec
   and must be e1a, e1b, e2a, d1a, d1b), in bf16 at batch 4 and in f32 at
   batch 1. Tolerance: f32 within 1e-4 (the order of an f32 sum of up to
   3,564 products); bf16 within one rounding of the output, 2^-7 of the
   value + 1e-3. Per shape its time beside ``F.conv3d``'s (cuDNN), the plain
   version's and its bound (bytes at 3.35 TB/s or 2 B S_out 27 C Co
   operations at the tensor cores' bf16 peak, for f32 the f32 peak); for
   bf16 also the previous design's time (``MMA_SYNC_DESIGN_MS``) and the
   wgmma kernel's plan (block, N tiles, chunks, stages, staging route),
   asserted equal to its Python mirror ``kernels.conv.conv_sm90_plan``;
10. serving with the kernel on: one flagship volume through
    ``predict.main --conv-kernel 1`` (K5 launched exactly 40 times, K1 112),
    seconds, peak device memory, labels in range; then a narrow network of
    the flagship's geometry (so that the same five convs reach K5), kernels
    halved as in phase 6, mode ``"1"`` against ``"0"`` on the card, in f32
    (K5's FMA kernel) and in bf16 (its tensor-core kernel): at most 0.1% of
    the logits outside atol 2e-3 / rtol 1e-3 in f32 (a kNN near tie may
    flip under the conv's reordered sum) and outside 5e-3 / 5e-3 in bf16
    (one rounding step of a conv output), argmax agreement 99.9%;
11. training with the kernel on: the flagship of phase 7 from the same seed
    takes 2 Dice + CE steps with ``conv_kernel="1"`` (K5 launched exactly 5
    times per step, its backward being the library conv's), the first loss
    within rtol 1e-2 of phase 7's first loss (bf16 compute: the conv's
    rounding differs, and kNN near ties with it), then one step with every
    stage recomputed (10 launches);
12. the tools: T4's ``check`` (K5 against the plain and the library conv at
    small cases), T2's row-patch probe in both output orders against its
    numpy oracle (max error under 1e-4), each order's time beside
    ``F.conv1d``'s and an empty kernel's launch, T1's dissection of K1 at its two
    shapes (mode ``full`` against the plain version, at most 0.1% of rows
    off; the five modes' times printed beside the first design's);
13. T3, the channels-last conv, through its tool: ``check`` and ``check3``
    (both entry points, ``pallas_conv`` and ``csub_conv``, in f32 and bf16,
    against the plain version and ``F.conv3d``; f32 within 1e-4 x max(1,
    |y|), bf16 within one rounding of the output, 2^-7 of the value +
    1e-3), then every case of the JAX tool's ``CASES`` in bf16 at full size
    beside ``F.conv3d`` on ``channels_last_3d`` tensors (TF32 off), the
    plain version, the bound, the previous design's time and the plan (as
    in phase 9);
14. the trainer: five labelled 1x64x280x240 cases with all 14 labels go
    through ``nextou_tpu_torch.run_training.main`` (``nnUNetTrainer_NexToU``,
    fold 0, 2 epochs of 4 iterations, 50 eval steps per epoch, then the
    final validation), and ``predict.main`` serves its
    ``checkpoint_final.pth``. K3 and K4 launched exactly 14 times per train
    step, K1 14 times per eval and per validation forward, K5 never; the
    remat choice logged with its estimate; losses finite; checkpoints,
    ``training_log.txt`` and ``validation/summary.json`` written; seconds
    per epoch and per iteration, the share of the train loop spent waiting
    in ``next(train_it)``, the host's cores and loader threads, peak device
    memory. ``--device-da`` is left at ``auto``, so the loader draws plans
    and the train step augments on the card: the DA path and the loader
    wait are printed beside the host-DA figures; then the loader alone,
    seconds per batch (sampling and plans);
15. raw serving (after phase 10, on its checkpoint): a synthetic abdominal
    CT, int16 HU, (x, y, z) 512x512x148 at (0.68, 0.68, 3.0) mm, zero outside
    a field-of-view cylinder of radius 230, written as ``ct_000_0000.nii.gz``
    by the port's ``data/io.py``, goes through ``predict.main --raw`` with
    a model folder whose ``plans.json`` builds the flagship at spacing [3.0,
    0.76, 0.76] with ``transpose_forward`` [2, 1, 0] and CT normalization
    (8-way TTA, tile batch 2). The grid (148x412x412, 48 tiles, 96
    forwards) is reckoned and asserted; K1 exactly 14 launches per forward,
    device accumulation, the NIfTI written at the input's shape and spacing,
    int16, labels in [0, 14), background outside the field of view. Seconds
    by stage, timed around ``infer/raw.py``'s own functions inside that run
    (read, crop + normalize, resample to spacing, sliding window on the card
    to a synchronize, resample back, argmax + revert, write), the total and
    the peak device and host memory;
16. host accumulation: (a) phase 5's first case through
    ``sliding_window_predict`` (host accumulators) and the device predictor,
    8-way TTA: at most 0.1% of the probabilities outside atol 2e-3 / rtol
    1e-3 (phase 6's rule), argmax agreement 99.9%; (b) a preprocessed
    1x272x512x512 case, whose accumulators (4.56 GB) exceed the 4 GiB
    budget, through ``predict.main --disable_tta``: the host path printed,
    K1 exactly 14 launches per forward (160 tiles, 80 forwards), labels in
    range; seconds, the share of them outside the forwards, peak device and
    host memory;
17. fold ensembles: two seed-distinct flagship checkpoints under
    ``fold_0/`` and ``fold_1/`` serve phase 5's first case through
    ``predict.main -f 0 1 --save-probabilities``, once per fold, and with
    ``-f 0 -pp postprocessing.json`` (largest component kept for every
    label): the ensemble's probabilities the folds' mean within float16
    rounding (atol 1e-3); ``ensemble.main`` over the single folds the same
    seg but where the two best probabilities lie within 1e-3; ``-pp`` equal
    bit for bit to ``postprocess apply`` on fold 0's seg; K1 exactly 14
    launches per forward;
18. the networks the plans can name, at the planner's widths for a
    BTCV-sized fingerprint (``PLAN_BASE`` and below): (a) the 3d_lowres
    PlainConvUNet (96x160x160, 32 ... 320, 14 classes, seed-0 weights)
    serves two seeded 1x112x192x192 volumes through ``predict.main -tr
    nnUNetTrainer`` (8-way TTA) with ``--conv-kernel`` 0 and 1: K5 exactly 5
    launches per forward with 1 (e0a on the one input channel, e0b, e1a,
    d0a, d0b) and none with 0, labels in range, seconds per volume both
    ways; K5 held against its plain version at those five shapes (phase
    9's rule); (b) the 3d_fullres ResidualEncoderUNet (56x192x160, blocks
    1/3/4/6/6/6, one conv per decoder stage) through ``nnUNetTrainer`` with
    ``conv_kernel="1"``: a batch-2 forward and 3 train steps in bf16, losses
    finite, every parameter moved (phase 7's rule), K5 once per forward
    (its stage-1 conv1, also held against its plain version), seconds and
    peak device memory; (c) the plain Grapher over the flagship's
    bottleneck map (2 x 4x7x6 x 324, k 32, the position bias), f32, card
    against CPU: at most 0.1% of values outside atol 2e-3 / rtol 1e-3, K1
    launched once;
19. the cascade: three seeded labelled 1x96x320x288 cases on the cascade
    stage's grid and their 3d_lowres copies (resampled by the plans'
    spacings with the port's resampler); ``run_training -tr nnUNetTrainer
    3d_lowres`` (1 epoch of 4 iterations), ``predict_next_stage`` onto the
    cascade stage's grid, ``run_training -tr nnUNetTrainer_NexToU
    3d_cascade_fullres_nextou`` (the flagship on 1 + 13 input channels, the
    one-hot noise; K3 and K4 exactly 14 launches per step, K1 14 per eval
    and validation forward, no recomputation), then ``predict.main -prev``
    on a preprocessed case (the trainer's validation label on 99% of
    voxels) and ``--raw`` on a NIfTI copy of its central 96x224x192 crop
    (CT HU, with its previous-stage seg cropped alike): K1 exactly 14
    launches per forward, labels in range, the NIfTI at the input's shape;
20. on-device augmentation (right after phase 14, on its cases): the
    flagship's final patch 64x224x192 at batch 2, one channel, from the
    initial patch (92, 324, 398) (rotation +-30 degrees) and (64, 320, 320)
    (dummy 2D), each with the default probabilities and with every p = 1
    (its plans' seed the first to fire every transform somewhere):
    ``device_augment_batch`` on the card against the host path
    (``augment_batch``) from the same seed, data within atol 1e-4 / rtol
    1e-5, seg equal on 99.99% of voxels (exactly where no rotation or
    scaling fired); its CUDA-event time per batch, each transform's alone,
    the upload (pinned, as the train step makes it, and from pageable
    memory), the plans and the host path's seconds; then the trainer
    loop (``tools/exp_trainer_loop.run``: 1 epoch of 8 iterations, 2
    validation iterations) with ``device_da`` off and on: seconds per
    iteration, loader-wait share and the loader alone per batch;
21. data parallel on one card (NCCL refuses two ranks on one device): (a)
    after phase 20, ``python -m torch.distributed.run
    --standalone --nproc_per_node 1 -m nextou_tpu_torch.run_training`` on
    phase 14's cases, 1 epoch x 4 iterations, over NCCL: the log names world
    size 1, nccl and local batch 2, the first step's loss bit-equal to phase
    14's (the same seed without the launcher), no all-reduce in the train
    steps, rank 0's checkpoints and validation written, seconds per
    iteration beside phase 14's; (b) two ranks spawned on card 0 over gloo,
    the flagship at a global batch of 2 (one sample per rank), 3 Dice + CE
    steps, against one process at batch 2 from the same weights and
    batches: the first loss within rtol 1e-2, the first gradient norm within
    2e-2, every parameter and buffer bit-equal across the ranks after the
    steps (SHA-256 digests broadcast from each rank), K3 and K4 14 launches
    per step per rank; each rank's seconds per step and its all-reduces per
    step with their milliseconds (gloo takes CUDA tensors through host
    memory: a record, not a target); (c) after phase 5, ``predict.main
    --all-devices`` on its first case, its seg bit-equal to the same call's
    without the flag (one card);
22. from a raw dataset to a served model with the port alone (after phase
    19, in a folder of its own): (a) five seeded labelled CT cases and one
    test case, int16 HU (background -1000, so cropping keeps the whole
    volume), (96, 320, 288) at (0.6, 0.297, 0.297) mm, every one of the 14
    labels present, written as ``.nii.gz`` in nnU-Net's raw layout by
    ``data/io.py``; (b) ``plan_and_preprocess.main`` with
    ``--verify_dataset_integrity -c 3d_fullres``: "dataset integrity OK",
    3d_fullres 64x192x160 at batch 2, 3d_fullres_nextou 64x224x192 with
    33/324, the trainer's spec of it equal to ``flagship_3d_spec()`` field
    for field, five preprocessed cases; (c) ``run_training.main`` of the
    planned 3d_fullres_nextou (1 epoch x 4 iterations, 50 eval steps, the
    validation): K3 and K4 exactly 14 launches per step, K1 14 per eval
    step and validation forward, losses finite, ``checkpoint_final.pth`` and
    ``validation/summary.json`` written, seconds per iteration beside phase
    14's; (d) ``find_best_configuration.main`` names the run with its
    ``summary.json``'s foreground mean Dice; (e) ``predict.main --raw`` of
    the test case from the run: the NIfTI at the input's shape, labels in
    range, K1 14 launches per forward; (f) the run's weights rewritten in
    upstream's layout (``module._orig_mod.`` prefixes, ``current_epoch``),
    ``import_torch_checkpoint.main`` on the card, and ``predict.main --raw``
    from the folder it writes: the seg bit-equal to (e)'s. Every stage's
    seconds.
23. the port's training over a run (after phase 22): (a)
    the small dilated network of phase 8 in f32, 20 steps on the card (K2,
    K3, K4; K5 at every (3, 3, 3) conv with ``conv_kernel="1"``, its region
    widened to them) against the CPU, the card set to the CPU's state after
    each step, on the port trainer's host-DA batches of a synthetic 3D
    dataset, steps 0-9 with Dice + CE and 10-19 with the RAVIR BTI loss, once
    with ``conv_kernel`` "0" and once "1": per step the loss within rtol 1e-4,
    the gradient norm 2e-2, the update 10% in L2, the TI term alone 1e-3 (or,
    on a step at a near tie of a kNN selection or a max, within 1.5 x the
    CPU's own floor under a one-ulp change of its parameters, printed), the
    worst of each, launches exact; (b) the flagship at full width through
    ``run_training.main -tr nnUNetTrainer_NexToU_BTI_Synapse`` on phase 14's
    cases, 3 epochs x 50 iterations, device DA, 10 eval steps per
    epoch, the validation: every loss and BTI term finite, epoch 2's mean
    train loss below epoch 0's, K3 and K4 14 launches per step, K1 14 per
    eval step and validation forward; seconds per iteration, the loader's
    share, peak device memory, the phase's seconds.

The last line is ``{"ok": true, "device": {...}}``; the line before it holds
the kernels' JSON record, each entry with the path its numbers were taken
on. An index kernel's ``max_abs_err`` is the largest difference between the
distances of its neighbours and the plain version's. Without a CUDA card the script fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import sys
import tempfile
import time

import numpy as np
import torch

from nextou_tpu_torch.tools.exp_trainer_loop import LOADER_BATCHES, loader_seconds_per_batch
from nextou_tpu_torch.tools.synthetic import labelled_case, write_dataset
from nextou_tpu_torch.tools.timing import card, cuda_ms

# the near-tie bound of phases 3 and 4, the row share allowed to differ (in
# its set of neighbours; in their order alone), and the fewest rows that
# share is taken over
TIE_GAP, MAX_ROWS_OFF, MAX_ROWS_REORDERED, MIN_ROWS = 1e-4, 1e-3, 1e-2, 10_000
TILE_BATCH, MIRRORS_PER_FORWARD = 2, 2
TRAIN_BATCH = 2
# the card's published peaks (H100 SXM): device memory, bf16 tensor cores,
# f32 outside the tensor cores; and the rate of an f32-accurate product on
# the tensor cores, three TF32 products per term at 495 TFLOP/s (the kNN
# kernels' 3xTF32 selection on f32 coordinates)
PEAK_BYTES_S, PEAK_BF16_FLOPS, PEAK_F32_FLOPS = 3.35e12, 989e12, 67e12
PEAK_SPLIT_FLOPS = 495e12 / 3

# The kNN kernels' milliseconds per call in their first design (f32 FMAs
# from shared memory, 32 query rows per CTA), by chip_smoke.py of git commit
# 179b1e6 on one NVIDIA H100 80GB HBM3 at a 700.00 W power limit: printed
# beside this run's, shape by shape. (kernel, dtype, (B, N, M, C, k)) -> ms;
# the dtype is K1's coordinates', K3's values'. T1's by mode, at the pool
# shape only: its Swin windows were drawn apart from their queries then.
FIRST_DESIGN_MS = {
    ('K1', 'bfloat16', (4, 10752, 168, 132, 14)): 0.587,
    ('K1', 'float32', (4, 10752, 168, 132, 14)): 0.574,
    ('K1', 'bfloat16', (2048, 168, 168, 132, 7)): 3.794,
    ('K1', 'float32', (2048, 168, 168, 132, 7)): 3.246,
    ('K1', 'bfloat16', (4, 10752, 1344, 264, 28)): 4.52,
    ('K1', 'float32', (4, 10752, 1344, 264, 28)): 3.644,
    ('K1', 'bfloat16', (256, 168, 168, 264, 14)): 1.016,
    ('K1', 'float32', (256, 168, 168, 264, 14)): 0.885,
    ('K1', 'bfloat16', (4, 1344, 1344, 324, 32)): 1.151,
    ('K1', 'float32', (4, 1344, 1344, 324, 32)): 0.97,
    ('K1', 'bfloat16', (32, 168, 168, 324, 14)): 0.291,
    ('K1', 'float32', (32, 168, 168, 324, 14)): 0.245,
    ('K1', 'bfloat16', (4, 168, 168, 324, 32)): 0.276,
    ('K1', 'float32', (4, 168, 168, 324, 32)): 0.277,
    ('K1', 'bfloat16', (4, 168, 168, 324, 28)): 0.257,
    ('K1', 'float32', (4, 168, 168, 324, 28)): 0.242,
    ('K3', 'bfloat16', (2, 10752, 168, 132, 14)): 0.241,
    ('K2', 'float32', (2, 10752, 168, 132, 14)): 0.176,
    ('K3', 'float32', (2, 10752, 168, 132, 14)): 0.238,
    ('K3', 'bfloat16', (1024, 168, 168, 132, 7)): 1.488,
    ('K2', 'float32', (1024, 168, 168, 132, 7)): 1.089,
    ('K3', 'float32', (1024, 168, 168, 132, 7)): 1.472,
    ('K3', 'bfloat16', (2, 10752, 1344, 264, 28)): 1.917,
    ('K2', 'float32', (2, 10752, 1344, 264, 28)): 1.642,
    ('K3', 'float32', (2, 10752, 1344, 264, 28)): 1.928,
    ('K3', 'bfloat16', (128, 168, 168, 264, 14)): 0.412,
    ('K2', 'float32', (128, 168, 168, 264, 14)): 0.275,
    ('K3', 'float32', (128, 168, 168, 264, 14)): 0.406,
    ('K3', 'bfloat16', (2, 1344, 1344, 324, 32)): 0.784,
    ('K2', 'float32', (2, 1344, 1344, 324, 32)): 0.62,
    ('K3', 'float32', (2, 1344, 1344, 324, 32)): 0.794,
    ('K3', 'bfloat16', (16, 168, 168, 324, 14)): 0.166,
    ('K2', 'float32', (16, 168, 168, 324, 14)): 0.104,
    ('K3', 'float32', (16, 168, 168, 324, 14)): 0.178,
    ('K3', 'bfloat16', (2, 168, 168, 324, 32)): 0.212,
    ('K2', 'float32', (2, 168, 168, 324, 32)): 0.12,
    ('K3', 'float32', (2, 168, 168, 324, 32)): 0.218,
    ('K3', 'bfloat16', (2, 168, 168, 324, 28)): 0.207,
    ('K2', 'float32', (2, 168, 168, 324, 28)): 0.118,
    ('K3', 'float32', (2, 168, 168, 324, 28)): 0.217,
    ('K2', 'float32', (2, 32, 32, 12, 16)): 0.0441,
    ('K2', 'float32', (2, 32, 32, 12, 8)): 0.0441,
    # K4's first design (a bitmap of rows per candidate, then a walk per
    # candidate), by tools.exp_knn_bwd of git commit d5dbfda on the same card
    ('K4', 'bfloat16', (2, 10752, 168, 132, 14)): 0.4672,
    ('K4', 'float32', (2, 10752, 168, 132, 14)): 0.4545,
    ('K4', 'bfloat16', (1024, 168, 168, 132, 7)): 0.7979,
    ('K4', 'float32', (1024, 168, 168, 132, 7)): 0.7701,
    ('K4', 'bfloat16', (2, 10752, 1344, 264, 28)): 0.5874,
    ('K4', 'float32', (2, 10752, 1344, 264, 28)): 0.5741,
    ('K4', 'bfloat16', (128, 168, 168, 264, 14)): 0.2948,
    ('K4', 'float32', (128, 168, 168, 264, 14)): 0.2875,
    ('K4', 'bfloat16', (2, 1344, 1344, 324, 32)): 0.1291,
    ('K4', 'float32', (2, 1344, 1344, 324, 32)): 0.1226,
    ('K4', 'bfloat16', (16, 168, 168, 324, 14)): 0.0628,
    ('K4', 'float32', (16, 168, 168, 324, 14)): 0.0658,
    ('K4', 'bfloat16', (2, 168, 168, 324, 32)): 0.0749,
    ('K4', 'float32', (2, 168, 168, 324, 32)): 0.0793,
    ('K4', 'bfloat16', (2, 168, 168, 324, 28)): 0.0679,
    ('K4', 'float32', (2, 168, 168, 324, 28)): 0.0879,
}
FIRST_DESIGN_T1_MS = {
    's3 pool': {'full': 1.963, 'half_k': 1.819, 'nosel': 1.606, 'nominext': 1.676,
                'distonly': 1.6},
}


def first_design(kernel, dtype, shape) -> str:
    ms = FIRST_DESIGN_MS.get((kernel, str(dtype)[6:], tuple(shape)))
    return "first design not measured" if ms is None else f"first design {ms:.3f} ms"


def bwd_plan_str(B, N, M, C, k, bf16) -> str:
    """The CTAs K4 launches at this shape, and how they sit."""
    from nextou_tpu_torch.kernels.knn import knn_max_bwd_plan

    p = knn_max_bwd_plan(B, N, M, C, k, bf16=bf16)
    ctas = B * p["slices"] * p["ranges"] * p["chunks"]
    return (f"{ctas} CTAs of {p['warps']} warps ({'walk' if p['walk'] else 'scatter'}: "
            f"{p['slices']} slices x {p['chunks']} chunks of {p['chunk_rows']} rows, "
            f"{p['per_sm']}/SM, {p['smem'] / 1024:.1f} KB)")


def plan_str(B, N, M, C, k, **kw) -> str:
    """The CTAs a kNN kernel launches at this shape, and how they sit."""
    from nextou_tpu_torch.kernels.knn import kernel_plan

    p = kernel_plan(B, N, M, C, k, **kw)
    mode = "one per window" if p["window"] else f"{p['rows']} rows each"
    return f"{p['ctas']} CTAs ({mode}, {p['per_sm']}/SM, {p['smem'] / 1024:.1f} KB)"

# the BTCV/Synapse 13-organ binary interaction tree of upstream's
# nnUNetTrainer_NexToU_BTI_Synapse (exclusion pairs of label sets)
BTI_SYNAPSE_EXCLUSION = [
    [[1, 3, 5, 7, 8, 11, 13], [2, 4, 6, 9, 10, 12]],
    [[1, 3, 11, 13], [5, 7, 8]],
    [[1, 3], [11, 13]],
    [1, 3],
    [11, 13],
    [[5, 8], [7]],
    [5, 8],
    [[4, 6, 10], [2, 9, 12]],
    [[4, 6], [10]],
    [4, 6],
    [[9, 12], [2]],
    [9, 12],
]


def nbytes(*tensors) -> int:
    """Bytes of the given tensors, each storage once (a self-graph passes one
    tensor as queries and candidates); ``None`` entries skipped."""
    seen = {t.data_ptr(): t.numel() * t.element_size() for t in tensors if t is not None}
    return sum(seen.values())


def bound_ms(moved: int, flops: float, peak_flops: float = PEAK_F32_FLOPS):
    """The least time the card could take: ``moved`` bytes (every input read
    once, every output written once) at the card's memory rate, or ``flops``
    at ``peak_flops``, whichever is larger. Returns (ms, 'bytes' | 'operations')."""
    by_bytes, by_ops = moved / PEAK_BYTES_S * 1e3, flops / peak_flops * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


class Totals:
    """Per-kernel sums over the shapes of one pass of the main path."""

    def __init__(self):
        self.ms = self.plain_ms = self.bound_ms = self.max_abs_err = 0.0
        self.by = {"bytes": 0.0, "operations": 0.0}
        # stays None where no single PyTorch call computes the function (kNN
        # + gather + max, its indices, its backward)
        self.library_ms = None

    def add(self, count, ms, plain_ms, bound, by, err, library_ms=None):
        self.ms += count * ms
        self.plain_ms += count * plain_ms
        self.bound_ms += count * bound
        self.by[by] += count * bound
        self.max_abs_err = max(self.max_abs_err, err)
        if library_ms is not None:
            self.library_ms = (self.library_ms or 0.0) + count * library_ms

    def merge(self, other: "Totals") -> None:
        """Add the sums of another path's shapes."""
        for key in ("ms", "plain_ms", "bound_ms"):
            setattr(self, key, getattr(self, key) + getattr(other, key))
        for key in self.by:
            self.by[key] += other.by[key]
        self.max_abs_err = max(self.max_abs_err, other.max_abs_err)
        if other.library_ms is not None:
            self.library_ms = (self.library_ms or 0.0) + other.library_ms

    def record(self) -> dict:
        return {"max_abs_err": self.max_abs_err, "ms": self.ms, "plain_ms": self.plain_ms,
                "bound_ms": self.bound_ms, "bound_by": max(self.by, key=self.by.get),
                "library_ms": self.library_ms}


def knn_calls(spec, batch: int, dilated: bool = False) -> dict:
    """(B, N, M, C, k, self_graph) -> calls per forward, from the spec the
    way the model builds its graphers: the fused graphs (dilation 1: K1, or
    K3 and K4), or with ``dilated`` the others (K2), whose ``k`` is the
    ``k * dilation`` neighbours that the kernel selects."""
    calls: dict = {}
    for st in (*spec.encoder, *spec.decoder):
        for b in st.gnn:
            if (b.dilation > 1) != dilated:
                continue
            C = st.features
            if b.kind == "pool":
                pooled = [s // p for s, p in zip(st.img_shape, b.pool_size)]
                n = math.prod(pooled)
                m = math.prod(s // b.reduce_ratio for s in pooled)
                key = (batch, n, m, C, b.k * b.dilation, b.reduce_ratio == 1)
            else:
                windows = math.prod(s // w for s, w in zip(st.img_shape, b.window_size))
                n = math.prod(b.window_size)
                key = (batch * windows, n, n, C, b.k * b.dilation, True)
            calls[key] = calls.get(key, 0) + 1
    return calls


def near_tie_gaps(xn, yn, rel, k, rows):
    """The gap between the k-th and the (k+1)-th distance of the plain
    version, at the rows of the boolean mask ``rows``."""
    from nextou_tpu_torch.core.graph import knn_sq_dist

    near = torch.topk(knn_sq_dist(xn, yn, rel), k + 1, dim=-1, largest=False).values
    return (near[..., k] - near[..., k - 1])[rows]


class Selection:
    """A kernel's ``(B, N, k)`` indices held against the plain version's,
    summed over the draws of one shape. A row may differ only where the plain
    version's own distances nearly tie: as a set where the k-th and the
    (k+1)-th are within ``TIE_GAP`` (at most ``MAX_ROWS_OFF`` of the rows),
    in its order alone where two neighbouring ones of the k nearest are (at
    most ``MAX_ROWS_REORDERED``: a row has k - 1 such pairs, and the order
    inside the set reaches no max). ``dist_err`` is the largest difference,
    position by position, between the distances of the kernel's neighbours
    and of the plain version's."""

    def __init__(self):
        self.rows = self.rows_off = self.rows_reordered = 0
        self.worst_gap = self.dist_err = 0.0

    def add(self, xn, yn, rel, k, idx, want_idx):
        from nextou_tpu_torch.core.graph import knn_sq_dist

        dist = knn_sq_dist(xn, yn, rel)
        near = torch.topk(dist, min(k + 1, dist.shape[-1]), dim=-1, largest=False).values
        step = torch.nn.functional.pad(near[..., 1:] - near[..., :-1], (0, 2), value=math.inf)
        other_set = (idx.sort(-1).values != want_idx.sort(-1).values).any(-1)
        other_order = (idx != want_idx).any(-1) & ~other_set
        gaps = torch.cat([step[..., k - 1][other_set],
                          step[..., :k - 1].amin(-1)[other_order]]) if k > 1 else step[..., 0][other_set]
        self.rows += other_set.numel()
        self.rows_off += int(other_set.sum())
        self.rows_reordered += int(other_order.sum())
        self.worst_gap = max(self.worst_gap, gaps.max().item() if gaps.numel() else 0.0)
        got = dist.gather(2, idx.long())
        self.dist_err = max(self.dist_err, (got - near[..., :k]).abs().max().item())
        return other_set

    @property
    def share(self) -> float:
        return self.rows_off / self.rows

    def check(self, name, shape):
        if (self.share > MAX_ROWS_OFF or self.rows_reordered > MAX_ROWS_REORDERED * self.rows
                or self.worst_gap > TIE_GAP):
            raise AssertionError(f"{name} selects other neighbours than the plain version at {shape}")

    def __str__(self):
        return (f"rows off {self.rows_off}/{self.rows} = {self.share:.2e}, "
                f"{self.rows_reordered} more in their order alone "
                f"(worst gap {self.worst_gap:.2e}, max|distance err| {self.dist_err:.3g})")


def kernel_phase(spec, dev) -> Totals:
    from nextou_tpu_torch.core.pos_embed import relative_pos_bias
    from nextou_tpu_torch.kernels.knn import (
        _normalized, knn_max_neighbors, knn_max_neighbors_reference,
    )

    calls = knn_calls(spec, TILE_BATCH * MIRRORS_PER_FORWARD)
    assert sum(calls.values()) == 14, calls
    gen = torch.Generator(device=dev).manual_seed(0)
    totals = {torch.bfloat16: Totals(), torch.float32: Totals()}
    for (B, N, M, C, k, self_graph), count in calls.items():
        rel = torch.tensor(relative_pos_bias(C, N, M, 3), device=dev)
        # the row share is a rate: small shapes draw fresh inputs until
        # MIN_ROWS rows are compared (one near tie in 672 rows is 0.15%)
        draws = math.ceil(MIN_ROWS / (B * N))
        for dtype in (torch.bfloat16, torch.float32):
            rows_off = worst_gap = err = 0
            for _ in range(draws):
                x = torch.randn(B, N, C, generator=gen, device=dev).to(dtype)
                y = None if self_graph else torch.randn(
                    B, M, C, generator=gen, device=dev).to(dtype)
                got = knn_max_neighbors(x, k, y, rel)
                want = knn_max_neighbors_reference(x, k, y, rel).to(dtype)
                assert got.shape == want.shape == (B, N, C) and got.dtype == dtype
                assert torch.isfinite(got.float()).all()
                off = (got != want).any(-1)
                rows_off += int(off.sum())
                xn, yn = _normalized(x, y)
                gaps = near_tie_gaps(xn, None if y is None else yn, rel, k, off)
                worst_gap = max(worst_gap, gaps.max().item() if gaps.numel() else 0.0)
                err = max(err, (got.float() - want.float()).abs().max().item())
                del got, want
            share = rows_off / (draws * B * N)
            t_k1 = cuda_ms(lambda: knn_max_neighbors(x, k, y, rel))
            t_plain = cuda_ms(lambda: knn_max_neighbors_reference(x, k, y, rel))
            peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_SPLIT_FLOPS
            # K1 reads the coordinates, the values (the raw features in the
            # coordinates' dtype: a tensor of its own) and the bias, and
            # writes the f32 max
            vals = x if y is None else y
            moved = nbytes(xn, yn, rel) + vals.numel() * xn.element_size() + B * N * C * 4
            bound, by = bound_ms(moved, 2.0 * B * N * M * C, peak)
            totals[dtype].add(count, t_k1, t_plain, bound, by, err)
            print(
                f"K1 B={B} N={N} M={M} C={C} k={k} {str(dtype)[6:]} x{count}: "
                f"rows off {rows_off}/{draws * B * N} = {share:.2e} "
                f"(worst k/k+1 gap {worst_gap:.2e}) max|err| {err:.3g}  "
                f"K1 {t_k1:.3f} ms ({first_design('K1', dtype, (B, N, M, C, k))})  "
                f"plain {t_plain:.3f} ms  bound {bound:.4f} ms ({by}); "
                + plan_str(B, N, M, C, k, bf16=dtype == torch.bfloat16, self_graph=self_graph)
            )
            if share > MAX_ROWS_OFF or worst_gap > TIE_GAP:
                raise AssertionError(f"K1 disagrees with the plain version at {B, N, M, C, k}")
        torch.cuda.empty_cache()
    for dtype, t in totals.items():
        print(f"K1 per flagship forward ({str(dtype)[6:]}): {t.ms:.3f} ms, "
              f"plain {t.plain_ms:.3f} ms, bound {t.bound_ms:.3f} ms")
    return totals[torch.bfloat16]


def order_unambiguous_case(dev, seed=7, n=16, k=3, c=8):
    """N queries, each with k nearest candidates of its own, disjoint from
    every other query's (M = N * k clusters): each candidate receives exactly
    one contribution, so no add order can change the gradient."""
    rng = np.random.default_rng(seed)
    qs = rng.standard_normal((1, n, c)).astype(np.float32) * 10
    cands = np.repeat(qs[0], k, axis=0) + 0.01 * rng.standard_normal((n * k, c)).astype(np.float32)
    g = rng.standard_normal((1, n, c)).astype(np.float32)
    return (torch.from_numpy(a).to(dev) for a in (qs, cands[None], g)), k


def hot_candidate_case(dev, b, n, m, c, k, seed=3):
    """K4's inputs without a selection: every row names candidate 0 (at a
    random place among its k) and k - 1 other distinct candidates. Values
    are halves (exact in bf16), candidate 0 at 1.5 in every channel, so it
    holds or shares the max of most rows. Returns f32 ``yv (b, m, c)``,
    ``idx (b, n, k)`` int32 and ``g (b, n, c)`` on ``dev``."""
    rng = np.random.default_rng(seed)
    yv = (np.round(rng.standard_normal((b, m, c)) * 2) / 2).astype(np.float32)
    yv[:, 0] = 1.5
    start = rng.integers(0, m - 1, (b, n, 1))
    cols = np.concatenate(
        [np.zeros((b, n, 1), np.int64), 1 + (start + np.arange(k - 1)) % (m - 1)], axis=2)
    order = np.argsort(rng.random((b, n, k)), axis=2)
    idx = np.take_along_axis(cols, order, axis=2).astype(np.int32)
    g = rng.standard_normal((b, n, c)).astype(np.float32)
    return (torch.from_numpy(a).to(dev) for a in (yv, idx, g))


def k4_error(gy, yv, idx, maxv, g, k) -> tuple[float, float]:
    """K4's largest difference from its plain version, and the largest
    share of the tolerance it takes: rtol 1e-5 and atol 1e-6 + 2e-6 x the
    sum of the absolute contributions to that entry (f32 sums in another
    order than ``index_add_``'s)."""
    from nextou_tpu_torch.kernels.knn import knn_max_bwd_reference

    want = knn_max_bwd_reference(yv, idx, maxv, g, k)
    scale = knn_max_bwd_reference(yv, idx, maxv, g.abs(), k)
    diff = (gy - want).abs()
    tol = 1e-6 + 1e-5 * want.abs() + 2e-6 * scale
    return diff.max().item(), (diff / tol).max().item()


def train_kernel_phase(spec, dev) -> dict[str, Totals]:
    from nextou_tpu_torch.core.graph import l2_normalize
    from nextou_tpu_torch.core.pos_embed import relative_pos_bias
    from nextou_tpu_torch.kernels.knn import (
        knn_indices_cuda, knn_indices_reference, knn_max_bwd_cuda, knn_max_bwd_reference,
        knn_max_idx_cuda, knn_max_idx_reference, knn_max_neighbors,
    )
    from nextou_tpu_torch.tools.exp_knn_bwd import device_ms_by_kernel

    calls = knn_calls(spec, TRAIN_BATCH)
    assert sum(calls.values()) == 14, calls
    gen = torch.Generator(device=dev).manual_seed(10)
    totals = {
        name: {torch.bfloat16: Totals(), torch.float32: Totals()}
        for name in ("knn_max_idx", "knn_max_bwd")
    }
    for (B, N, M, C, k, self_graph), count in calls.items():
        rel = torch.tensor(relative_pos_bias(C, N, M, 3), device=dev).contiguous()
        draws = math.ceil(MIN_ROWS / (B * N))
        for dtype in (torch.bfloat16, torch.float32):
            err3 = err4 = worst4 = 0.0
            sel = Selection()
            for _ in range(draws):
                x = torch.randn(B, N, C, generator=gen, device=dev).to(dtype)
                y = x if self_graph else torch.randn(
                    B, M, C, generator=gen, device=dev).to(dtype)
                # a train step selects on f32 coordinates whatever the model's dtype
                xn = l2_normalize(x.float()).contiguous()
                yn = xn if self_graph else l2_normalize(y.float()).contiguous()
                yv = y.contiguous()
                g = torch.randn(B, N, C, generator=gen, device=dev)
                maxv, idx3 = knn_max_idx_cuda(xn, yn, yv, rel, k)
                idx2 = knn_indices_cuda(xn, yn, rel, k)
                gy = knn_max_bwd_cuda(yv, idx3, maxv, g, k)
                torch.cuda.synchronize()
                assert maxv.shape == (B, N, C) and maxv.dtype == torch.float32
                assert idx3.shape == idx2.shape == (B, N, k) and idx3.dtype == idx2.dtype == torch.int32
                assert gy.shape == (B, M, C) and gy.dtype == torch.float32
                assert torch.isfinite(maxv).all() and torch.isfinite(gy).all()
                if not torch.equal(idx2, idx3):
                    raise AssertionError(f"K2 and K3 select differently at {B, N, M, C, k}")
                # K2's indices (and so K3's) against the plain version's
                other_set = sel.add(xn, yn, rel, k, idx2, knn_indices_reference(xn, yn, rel, k))
                want_max, _ = knn_max_idx_reference(xn, yn, yv, rel, k)
                # the same neighbours give the same max, bit for bit
                if ((maxv != want_max).any(-1) & ~other_set).any():
                    raise AssertionError(f"K3's max differs on an equal selection at {B, N, M, C, k}")
                err3 = max(err3, (maxv - want_max).abs().max().item())
                # K4 on K3's own indices: selection noise does not enter
                err, worst = k4_error(gy, yv, idx3, maxv, g, k)
                err4, worst4 = max(err4, err), max(worst4, worst)
                del want_max
            t_k3 = cuda_ms(lambda: knn_max_idx_cuda(xn, yn, yv, rel, k))
            t_k2 = cuda_ms(lambda: knn_indices_cuda(xn, yn, rel, k))
            t_k4 = cuda_ms(lambda: knn_max_bwd_cuda(yv, idx3, maxv, g, k))
            passes = device_ms_by_kernel(lambda: knn_max_bwd_cuda(yv, idx3, maxv, g, k), 5)
            p_k3 = cuda_ms(lambda: knn_max_idx_reference(xn, yn, yv, rel, k))
            p_k2 = cuda_ms(lambda: knn_indices_reference(xn, yn, rel, k))
            p_k4 = cuda_ms(lambda: knn_max_bwd_reference(yv, idx3, maxv, g, k))
            flops = 2.0 * B * N * M * C
            b_k3, by3 = bound_ms(nbytes(xn, yn, yv, rel, maxv, idx3), flops, PEAK_SPLIT_FLOPS)
            b_k2, by2 = bound_ms(nbytes(xn, yn, rel, idx2), flops, PEAK_SPLIT_FLOPS)
            b_k4, by4 = bound_ms(nbytes(yv, idx3, maxv, g, gy), 2.0 * B * N * k * C)
            totals["knn_max_idx"][dtype].add(count, t_k3, p_k3, b_k3, by3, err3)
            totals["knn_max_bwd"][dtype].add(count, t_k4, p_k4, b_k4, by4, err4)
            print(
                f"train B={B} N={N} M={M} C={C} k={k} values {str(dtype)[6:]} x{count}: {sel}; "
                f"K3 {t_k3:.3f} ms ({first_design('K3', dtype, (B, N, M, C, k))}) "
                f"plain {p_k3:.3f} bound {b_k3:.4f} ({by3}), "
                + plan_str(B, N, M, C, k, self_graph=self_graph) + "; "
                f"K2 {t_k2:.3f} ms ({first_design('K2', torch.float32, (B, N, M, C, k))}) "
                f"plain {p_k2:.3f} bound {b_k2:.4f} ({by2}); "
                f"K4 {t_k4:.4f} ms ({first_design('K4', dtype, (B, N, M, C, k))}; device "
                + ", ".join(f"{n} {t:.4f}" for n, t in passes.items())
                + f") plain {p_k4:.3f} bound {b_k4:.4f} ({by4}) "
                f"max|err| {err4:.3g} = {worst4:.3f} of tolerance, "
                + bwd_plan_str(B, N, M, C, k, dtype == torch.bfloat16)
            )
            sel.check("K2/K3", (B, N, M, C, k))
            if worst4 > 1.0:
                raise AssertionError(f"K4 disagrees with the plain version at {B, N, M, C, k}")
        torch.cuda.empty_cache()

    # K4 where every candidate receives one contribution: bit-exact, and the
    # same bits on a second launch
    (x, y, g), k = order_unambiguous_case(dev)
    xn, yn = l2_normalize(x).contiguous(), l2_normalize(y).contiguous()
    maxv, idx = knn_max_idx_cuda(xn, yn, y, None, k)
    assert idx.unique().numel() == idx.numel()
    gy = knn_max_bwd_cuda(y, idx, maxv, g, k)
    if not torch.equal(gy, knn_max_bwd_reference(y, idx, maxv, g, k)):
        raise AssertionError("K4 is not bit-exact where the add order cannot matter")
    if not torch.equal(gy, knn_max_bwd_cuda(y, idx, maxv, g, k)):
        raise AssertionError("K4 gave other bits on a second launch")
    # one candidate in every row of 10,752 (s3 pool's M, C and k): its rows in
    # chunks whose partials are summed in chunk order; ties among them
    for dtype in (torch.bfloat16, torch.float32):
        yv, idx, g = hot_candidate_case(dev, 2, 10752, 1344, 264, 28)
        yv = yv.to(dtype)
        maxv = torch.stack([yv[b].float()[idx[b].long()].amax(1) for b in range(2)])
        gy = knn_max_bwd_cuda(yv, idx, maxv, g, 28)
        err, worst = k4_error(gy, yv, idx, maxv, g, 28)
        if worst > 1.0:
            raise AssertionError(f"K4 disagrees with the plain version on the hot candidate ({dtype})")
        if not torch.equal(gy, knn_max_bwd_cuda(yv, idx, maxv, g, 28)):
            raise AssertionError(f"K4 gave other bits on a second launch, hot candidate ({dtype})")
        print(f"K4 hot candidate (2, 10752, 1344, 264, 28) values {str(dtype)[6:]}: "
              f"max|err| {err:.3g} = {worst:.3f} of tolerance, the same bits twice; "
              + bwd_plan_str(2, 10752, 1344, 264, 28, dtype == torch.bfloat16))
        del yv, idx, g, maxv, gy
    # bf16 queries with f32 candidates: the f32 max is saved, so the
    # candidates' gradient is not lost
    yt = torch.randn(2, 150, 12, generator=gen, device=dev).requires_grad_()
    xt = torch.randn(2, 70, 12, generator=gen, device=dev).bfloat16()
    out = knn_max_neighbors(xt, 9, yt, None, train=True)
    out.float().sum().backward()
    assert out.dtype == torch.bfloat16 and yt.grad.dtype == torch.float32
    if not yt.grad.abs().sum() > 0:
        raise AssertionError("mixed bf16/f32: the candidates' gradient is zero")
    print("K4 bit-exact on the order-unambiguous case, the same bits twice; "
          "mixed bf16/f32 gradient non-zero")
    for name, by_dtype in totals.items():
        for dtype, t in by_dtype.items():
            print(f"{name} per flagship train step (values {str(dtype)[6:]}): {t.ms:.3f} ms, "
                  f"plain {t.plain_ms:.3f} ms, bound {t.bound_ms:.3f} ms")
    return {name: by_dtype[torch.bfloat16] for name, by_dtype in totals.items()}


def dilated_kernel_phase(spec, dev) -> Totals:
    """K2 at the shapes of the path that runs it: the dilated graphs of
    ``spec`` in a train step at batch 2, where it selects ``k * dilation``
    neighbours on f32 coordinates. Indices against the plain version's under
    the near-tie rule of :class:`Selection`; ``max_abs_err`` is the largest
    difference between the distances of K2's neighbours and the plain
    version's."""
    from nextou_tpu_torch.core.graph import l2_normalize
    from nextou_tpu_torch.core.pos_embed import relative_pos_bias
    from nextou_tpu_torch.kernels.knn import knn_indices_cuda, knn_indices_reference

    calls = knn_calls(spec, TRAIN_BATCH, dilated=True)
    assert calls, "the spec has no dilated graph"
    gen = torch.Generator(device=dev).manual_seed(11)
    total = Totals()
    for (B, N, M, C, k, self_graph), count in calls.items():
        rel = torch.tensor(relative_pos_bias(C, N, M, 3), device=dev).contiguous()
        sel = Selection()
        for _ in range(math.ceil(MIN_ROWS / (B * N))):
            xn = l2_normalize(torch.randn(B, N, C, generator=gen, device=dev)).contiguous()
            yn = xn if self_graph else l2_normalize(
                torch.randn(B, M, C, generator=gen, device=dev)).contiguous()
            idx = knn_indices_cuda(xn, yn, rel, k)
            assert idx.shape == (B, N, k) and idx.dtype == torch.int32
            sel.add(xn, yn, rel, k, idx, knn_indices_reference(xn, yn, rel, k))
        t_k2 = cuda_ms(lambda: knn_indices_cuda(xn, yn, rel, k))
        p_k2 = cuda_ms(lambda: knn_indices_reference(xn, yn, rel, k))
        bound, by = bound_ms(nbytes(xn, yn, rel, idx), 2.0 * B * N * M * C, PEAK_SPLIT_FLOPS)
        total.add(count, t_k2, p_k2, bound, by, sel.dist_err)
        print(f"K2 B={B} N={N} M={M} C={C} k={k} x{count}: {sel}; "
              f"K2 {t_k2:.4f} ms ({first_design('K2', torch.float32, (B, N, M, C, k))}) "
              f"plain {p_k2:.4f} bound {bound:.6f} ({by}); "
              + plan_str(B, N, M, C, k, self_graph=self_graph))
        sel.check("K2", (B, N, M, C, k))
    print(f"knn_indices per train step of the small dilated network: {total.ms:.4f} ms, "
          f"plain {total.plain_ms:.4f} ms, bound {total.bound_ms:.6f} ms")
    return total


def slice_phase(dev, tmp: str, spec, shape) -> dict:
    from nextou_tpu_torch import predict
    from nextou_tpu_torch.infer.sliding_window import compute_sliding_window_steps
    from nextou_tpu_torch.kernels.conv import conv3d_cuda
    from nextou_tpu_torch.kernels.knn import knn_max_cuda
    from nextou_tpu_torch.models import NexToU
    from nextou_tpu_torch.utils import init_weights

    n_cases, config = 2, "3d_fullres_nextou"
    data_dir, model_dir, out_dir = (os.path.join(tmp, d) for d in ("data", "model", "out"))
    os.makedirs(model_dir)
    write_dataset(data_dir, spec, config, n_cases, shape, seed=1)
    t0 = time.time()
    model = init_weights(NexToU(spec, device=dev), seed=0)
    torch.save({"network_weights": model.state_dict()},
               os.path.join(model_dir, "checkpoint_final.pth"))
    del model
    print(f"flagship checkpoint (seed 0) built and saved in {time.time() - t0:.1f} s")

    tiles = math.prod(len(s) for s in compute_sliding_window_steps(shape, spec.patch_size))
    forwards = n_cases * math.ceil(tiles / TILE_BATCH) * (8 // MIRRORS_PER_FORWARD)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    knn_max_cuda.launches = conv3d_cuda.launches = 0
    t0 = time.time()
    predict.main([model_dir, data_dir, config, "-tr", "nnUNetTrainer_NexToU",
                  "-o", out_dir, "--tile-batch", str(TILE_BATCH), "--device", str(dev)])
    torch.cuda.synchronize()
    main_s = time.time() - t0
    launches = knn_max_cuda.launches
    if conv3d_cuda.launches:
        raise AssertionError("the default configuration launched the conv kernel")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"predict.main: {n_cases} volumes {shape}, {tiles} tiles each, "
          f"{forwards} forwards, {main_s:.2f} s incl. model build and load; "
          f"K1 launches {launches}; peak device memory {peak / 2**30:.2f} GiB")
    if launches != 14 * forwards:
        raise AssertionError(f"K1 launched {launches} times for {forwards} forwards")
    segs = []
    for i in range(n_cases):
        with np.load(os.path.join(out_dir, f"case_{i:03d}.npz")) as z:
            seg = z["seg"]
        assert seg.shape == shape and seg.dtype == np.uint8, (seg.shape, seg.dtype)
        assert seg.max() < spec.num_classes
        segs.append(seg)
        print(f"case_{i:03d}: seg {seg.shape} labels {np.unique(seg).tolist()}")

    # steady-state seconds per volume, and the probabilities of one case
    plans, _, infer_spec = predict.load_dataset(data_dir, config)
    model = predict.load_model(infer_spec, os.path.join(model_dir, "checkpoint_final.pth"), dev)
    cases = [data for _, data in predict.iter_cases(data_dir, plans, config)]
    seg_pred = predict.build_predictor(model, (0, 1, 2), tile_batch=TILE_BATCH, output="seg")
    times = []
    for data in cases:
        torch.cuda.synchronize()
        t0 = time.time()
        seg_pred(data)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    print(f"seconds per volume (8-way TTA, tile batch {TILE_BATCH}, bf16): "
          f"{', '.join(f'{t:.3f}' for t in times)}")
    probs = predict.build_predictor(model, (0, 1, 2), tile_batch=TILE_BATCH)(cases[0])
    assert probs.shape == (*shape, spec.num_classes) and np.isfinite(probs).all()
    sums = probs.sum(-1)
    agree = float(np.mean(np.argmax(probs, -1) == segs[0]))
    print(f"probabilities: sum in [{sums.min():.6f}, {sums.max():.6f}], "
          f"argmax agrees with main's seg on {agree:.6f} of voxels")
    assert np.abs(sums - 1).max() <= 1e-3
    assert agree >= 0.99
    return {"launches": launches, "s_per_volume": min(times), "peak_bytes": peak}


def small_reference_phase(dev):
    """A small network (seeded) predicted on the card in f32 with K1 against
    the same network on the CPU with the plain kNN.

    The He-normal kernels are halved, as in the CPU tests: with identity
    running statistics, full-scale kernels grow the logits to ~1e5, and then
    f32 rounding alone (f32 against f64 on one CPU) moves the softmax and
    flips kNN near ties, so no tolerance would separate a fault from noise.
    """
    from nextou_tpu_torch.infer import make_device_sliding_predictor
    from nextou_tpu_torch.models import NexToU
    from nextou_tpu_torch.models.presets import small_3d_spec
    from nextou_tpu_torch.utils import init_weights

    spec = small_3d_spec(num_classes=3, deep_supervision=False)
    data = np.random.default_rng(2).standard_normal((16, 120, 100, 1)).astype(np.float32)
    out = {}
    for d in (dev, torch.device("cpu")):
        model = init_weights(NexToU(spec, device=d), seed=3).eval()
        with torch.no_grad():
            for p in model.parameters():
                if p.dim() >= 2:
                    p.mul_(0.5)
        out[d.type] = make_device_sliding_predictor(
            model, (0, 1, 2), spec.patch_size, spec.num_classes, device=d,
            tile_batch=TILE_BATCH, transfer_dtype=torch.float32,
        )(data).cpu().numpy()
    got, want = out["cuda"], out["cpu"]
    off = np.abs(got - want) > 2e-3 + 1e-3 * np.abs(want)
    agree = float(np.mean(np.argmax(got, -1) == np.argmax(want, -1)))
    print(f"small network f32, card vs CPU: max|diff| {np.abs(got - want).max():.3g}, "
          f"{off.mean():.2e} of values outside atol 2e-3/rtol 1e-3, seg agreement {agree:.6f}")
    if off.mean() > 1e-3 or agree < 0.999:
        raise AssertionError("the port on the card disagrees with the CPU reference")


def train_phase(dev, spec) -> dict:
    """The training slice at full width and depth: 3 steps with Dice + CE, 2
    with the BTI Synapse term, one eval step."""
    from nextou_tpu_torch.kernels.conv import conv3d_cuda
    from nextou_tpu_torch.kernels.knn import knn_max_bwd_cuda, knn_max_cuda, knn_max_idx_cuda
    from nextou_tpu_torch.losses import CompoundLossSpec, TILossSpec, deep_supervision_weights
    from nextou_tpu_torch.models import NexToU
    from nextou_tpu_torch.models.nextou import remat_flags
    from nextou_tpu_torch.train import (
        create_train_state, make_eval_step, make_optimizer, make_train_step, poly_lr, pseudo_dice,
    )

    rng = np.random.default_rng(20)
    batch = {
        "data": rng.standard_normal((TRAIN_BATCH, *spec.patch_size, 1), dtype=np.float32),
        "seg": rng.integers(0, spec.num_classes, (TRAIN_BATCH, *spec.patch_size)),
    }
    model = NexToU(spec, dtype=torch.bfloat16, device=dev)
    opt = make_optimizer(poly_lr(1e-2, 1000, 0.9, steps_per_epoch=250))
    state = create_train_state(model, opt, seed=0)
    weights = deep_supervision_weights(len(spec.decoder))
    base = CompoundLossSpec()
    bti = CompoundLossSpec(weight_ti=1e-6, ti=TILossSpec.create(
        dim=3, connectivity=26, exclusion=BTI_SYNAPSE_EXCLUSION))
    graphers = [len(st.gnn) for st in (*spec.encoder, *spec.decoder)]
    recomputed = sum(n for n, again in zip(graphers, (*model.remat[0], *model.remat[1])) if again)
    assert sum(graphers) == 14

    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats = {n: b.clone() for n, b in model.named_buffers() if "running_" in n}
    for counter in (knn_max_idx_cuda, knn_max_bwd_cuda, knn_max_cuda, conv3d_cuda):
        counter.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    seconds, losses, plan = [], [], [("Dice+CE", base)] * 3 + [("Dice+CE+BTI", bti)] * 2
    steps = {name: make_train_step(model, opt, ls, weights) for name, ls in dict(plan).items()}
    for i, (name, _) in enumerate(plan):
        t0 = time.time()
        state, metrics = steps[name](state, batch)
        torch.cuda.synchronize()
        seconds.append(time.time() - t0)
        loss, norm = metrics["loss"].item(), metrics["grad_norm"].item()
        losses.append(loss)
        print(f"train step {i} ({name}): loss {loss:.4f} grad_norm {norm:.4f} "
              f"{seconds[-1]:.3f} s")
        if not (math.isfinite(loss) and math.isfinite(norm)):
            raise AssertionError(f"train step {i}: loss {loss}, grad_norm {norm}")
    peak = torch.cuda.max_memory_allocated(dev)
    k3, k4 = knn_max_idx_cuda.launches, knn_max_bwd_cuda.launches
    n_steps = len(plan)
    print(f"K3 launches {k3}, K4 launches {k4} in {n_steps} steps "
          f"({recomputed} of 14 graphers recomputed); K1 launches {knn_max_cuda.launches}; "
          f"peak device memory {peak / 2**30:.2f} GiB")
    if k3 != (14 + recomputed) * n_steps or k4 != 14 * n_steps or knn_max_cuda.launches:
        raise AssertionError(f"K3 launched {k3} times and K4 {k4} times in {n_steps} steps")
    assert state.step == n_steps

    # every parameter finite, and every one moved, but for the biases that
    # cannot: a conv or 1x1 bias directly under a normalization (its gradient
    # is zero up to rounding, and it starts at 0), and the bias of the
    # lowest-resolution head, whose loss weight is 0 (its kernel moves by the
    # weight decay alone). Norm scales and shifts, the transposed convs and
    # the other heads must all move.
    may_stay = re.compile(r"\.(conv|fc[12]\.0|nn\.0)\.bias$|^decoder\.seg_layers\.0\.bias$")
    unmoved = []
    for n, p in model.named_parameters():
        if not torch.isfinite(p).all():
            raise AssertionError(f"parameter {n} is not finite")
        if torch.equal(p, before[n]):
            unmoved.append(n)
    print(f"parameters: {len(before)} tensors finite, {len(unmoved)} unmoved: {unmoved[:5]}")
    if any(not may_stay.search(n) for n in unmoved):
        raise AssertionError(f"parameters that did not move: {unmoved[:5]}")
    still = [n for n, b in model.named_buffers() if n in stats and torch.equal(b, stats[n])]
    if still:
        raise AssertionError(f"BatchNorm statistics that did not move: {still[:5]}")
    del before, stats

    steady = seconds[1:3]
    print(f"seconds per step, batch {TRAIN_BATCH}, bf16: first {seconds[0]:.3f}; Dice+CE "
          f"{', '.join(f'{s:.3f}' for s in steady)} ({TRAIN_BATCH / min(steady):.3f} patches/s); "
          f"first with BTI {seconds[3]:.3f}, then {seconds[4]:.3f} "
          f"({TRAIN_BATCH / seconds[4]:.3f} patches/s)")

    knn_max_cuda.launches = 0
    out = make_eval_step(model, bti, weights)(state, batch)
    torch.cuda.synchronize()
    tp, fp, fn = (out[key].cpu() for key in ("tp", "fp", "fn"))
    seg = torch.from_numpy(batch["seg"])
    truth = torch.stack([(seg == c).sum() for c in range(1, spec.num_classes)])
    dice = pseudo_dice(tp, fp, fn)
    print(f"eval step: loss {out['loss'].item():.4f}, K1 launches {knn_max_cuda.launches}, "
          f"pseudo dice {[round(d, 4) for d in dice.tolist()]}")
    ok = (
        math.isfinite(out["loss"].item()) and knn_max_cuda.launches == 14
        and k3 == knn_max_idx_cuda.launches
        and all(t.dtype == torch.int64 and (t >= 0).all() for t in (tp, fp, fn))
        and torch.equal(tp + fn, truth) and (tp + fp).sum() <= seg.numel()
    )
    if not ok:
        raise AssertionError(f"eval step: tp {tp.tolist()} fp {fp.tolist()} fn {fn.tolist()}")

    # two more steps with every stage recomputed in the backward pass: K3
    # runs twice per grapher, K4 once
    model.remat = remat_flags(spec, True)
    for counter in (knn_max_idx_cuda, knn_max_bwd_cuda):
        counter.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    again_s = []
    for _ in range(2):
        t0 = time.time()
        state, metrics = steps["Dice+CE"](state, batch)
        torch.cuda.synchronize()
        again_s.append(time.time() - t0)
    loss, norm = metrics["loss"].item(), metrics["grad_norm"].item()
    print(f"train steps with every stage recomputed (Dice+CE): {again_s[0]:.3f} s, then "
          f"{again_s[1]:.3f} s; loss {loss:.4f} grad_norm {norm:.4f}; K3 launches "
          f"{knn_max_idx_cuda.launches}, K4 launches {knn_max_bwd_cuda.launches}; peak device "
          f"memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    if not (math.isfinite(loss) and math.isfinite(norm)
            and (knn_max_idx_cuda.launches, knn_max_bwd_cuda.launches) == (2 * 28, 2 * 14)):
        raise AssertionError("the recomputed train steps failed their checks")
    if conv3d_cuda.launches:
        raise AssertionError("the default configuration launched the conv kernel")
    return {"k3": k3, "k4": k4, "s_per_step": min(steady), "s_per_step_bti": seconds[4],
            "peak_bytes": peak, "first_loss": losses[0]}


def small_train_spec():
    """A five-stage network of about 2,000 kNN rows per forward whose
    bottleneck stage is dilated and stochastic: the one path that runs K2."""
    from nextou_tpu_torch.models.spec import build_model_spec

    spec = build_model_spec(
        in_channels=1, patch_size=(8, 16, 16), n_stages=5,
        features_per_stage=[6, 12, 12, 12, 12], kernel_sizes=[(3, 3, 3)] * 5,
        strides=[(1, 1, 1), (2, 2, 2), (2, 2, 2), (1, 1, 1), (1, 1, 1)],
        n_conv_per_stage=[2] * 5, n_conv_per_stage_decoder=[2] * 4,
        num_classes=3, deep_supervision=True,
    )
    enc = list(spec.encoder)
    enc[4] = dataclasses.replace(
        enc[4], gnn=tuple(dataclasses.replace(b, dilation=2) for b in enc[4].gnn))
    return dataclasses.replace(spec, encoder=tuple(enc), epsilon=0.5)


def small_train_phase(dev) -> int:
    """Two train steps of a small network in f32 on the card (K3 and K4, and
    K2 through one dilated, stochastic stage) against the same two steps on
    the CPU (plain versions, autograd's own backward).

    The network is small enough (about 2,000 kNN rows per forward) that a
    near tie is rare: a flipped row under batch statistics moves every
    gradient. Its gradient is sharp all the same (a norm above 100, and a
    relative 1e-6 in the parameters moves it by 1e-3), so two f32 runs part
    by percents in their second step: the card's state is set to the CPU's
    after each step, and every step starts from the same point on both.
    Tolerances per step: the loss within rtol 1e-4, the gradient norm within
    rtol 2e-2 and the update (parameters after minus before) within 10% of
    the CPU's in the L2 norm, each about six times what an H100 showed
    (3.2e-3 and 1.7e-2 in the first step, 5.5e-4 and 3.1e-3 in the second).
    A fault is far outside: halving the gradient that the neighbour max
    hands to the candidates moves this update by 119% of its norm, losing
    it by 141% (tried on the CPU with the plain version altered).
    Returns K2's launches on the card.
    """
    from nextou_tpu_torch.kernels.knn import knn_indices_cuda, knn_max_bwd_cuda, knn_max_idx_cuda
    from nextou_tpu_torch.losses import CompoundLossSpec, TILossSpec, deep_supervision_weights
    from nextou_tpu_torch.models import NexToU
    from nextou_tpu_torch.train import create_train_state, make_optimizer, make_train_step

    spec = small_train_spec()
    rng = np.random.default_rng(30)
    batches = [
        {"data": rng.standard_normal((2, *spec.patch_size, 1), dtype=np.float32),
         "seg": rng.integers(0, 3, (2, *spec.patch_size))}
        for _ in range(2)
    ]
    loss_spec = CompoundLossSpec(weight_ti=1e-4, ti=TILossSpec.create(3, 26, [], [[1, 2]]))
    weights = deep_supervision_weights(len(spec.decoder))
    opt = make_optimizer(1e-2)

    def flat(model):
        return torch.cat([p.detach().cpu().flatten() for p in model.parameters()])

    states, steps = {}, {}
    for kind, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        model = NexToU(spec, device=d)
        states[kind] = create_train_state(model, opt, seed=4)
        steps[kind] = make_train_step(model, opt, loss_spec, weights)
    for counter in (knn_indices_cuda, knn_max_idx_cuda, knn_max_bwd_cuda):
        counter.launches = 0
    for i, batch in enumerate(batches):
        start = flat(states["cpu"].model)
        assert torch.equal(start, flat(states["cuda"].model))
        metrics = {}
        for kind in ("cuda", "cpu"):
            states[kind], m = steps[kind](states[kind], batch)
            metrics[kind] = m["loss"].item(), m["grad_norm"].item()
        (gl, gn), (wl, wn) = metrics["cuda"], metrics["cpu"]
        want = flat(states["cpu"].model) - start
        got = flat(states["cuda"].model) - start
        update_off = ((got - want).norm() / want.norm()).item()
        print(f"small network f32, train step {i}, card vs CPU: loss {gl:.6f} vs {wl:.6f}, "
              f"grad_norm {gn:.4f} vs {wn:.4f}, update off by {update_off:.2e} of its norm")
        if abs(gl - wl) > 1e-4 * abs(wl) or abs(gn - wn) > 2e-2 * abs(wn) or update_off > 0.1:
            raise AssertionError("the train step on the card disagrees with the CPU")
        states["cuda"].load_state_dict(states["cpu"].state_dict())
    k2, k3, k4 = (c.launches for c in (knn_indices_cuda, knn_max_idx_cuda, knn_max_bwd_cuda))
    print(f"small network launches in 2 steps: K2 {k2} K3 {k3} K4 {k4}")
    # 14 graphers, 2 of them dilated (K2 + plain gather and max), 12 fused
    if (k2, k3, k4) != (2 * 2, 12 * 2, 12 * 2):
        raise AssertionError(f"small train launches: K2 {k2} K3 {k3} K4 {k4}")
    return k2


def conv_calls(spec, mode: str = "1") -> list:
    """(name, C, Co, stride, input spatial) of the convs that ``conv_kernel``
    = ``mode`` hands to K5 in one forward, from the spec the way the model
    builds its stages: encoder stage ``s`` is ``e{s}``, the decoder stage at
    its resolution ``d{s}``, the convs of a stage ``a``, ``b``."""
    from nextou_tpu_torch.kernels.conv import conv_kernel_wins

    stages, shape, cin = [], tuple(spec.patch_size), spec.in_channels
    for i, st in enumerate(spec.encoder):
        stages.append((f"e{i}", st.n_conv, cin, st.features, st.kernel_size, st.stride, shape))
        shape = tuple(a // b for a, b in zip(shape, st.stride))
        cin = st.features
    ones = (1,) * spec.spatial_dims
    for i, st in enumerate(spec.decoder):
        s = len(spec.encoder) - 2 - i
        stages.append((f"d{s}", st.n_conv, 2 * st.features, st.features, st.kernel_size, ones,
                       tuple(spec.encoder[s].img_shape)))
    calls = []
    for name, n_conv, cin, cout, kernel, stride, shape in stages:
        for j in range(n_conv):
            strided = any(v > 1 for v in stride)
            named = mode == "1" or (mode == "s1" and not strided) or (mode == "s2" and strided)
            if named and len(kernel) == 3 and conv_kernel_wins(shape, cin, cout, kernel, stride):
                calls.append((name + "ab"[j], cin, cout, tuple(stride), shape))
            shape = tuple(a // b for a, b in zip(shape, stride))
            cin, stride = cout, ones
    return calls


# the narrow network with the conv kernel on against off, per compute dtype:
# atol, rtol, the share of logits allowed outside them, the least argmax
# agreement. f32: the order of an f32 sum, and the kNN near ties it flips
# (phase 6's rule; an H100 showed no difference at all: cuDNN's f32 conv adds
# in K5's order). bf16: a conv output that lands on the other side of a
# rounding step moves by 2^-8 of its value, and what follows moves with it:
# five times what an H100 showed (9.8e-4 at logits up to 0.28).
NARROW_TOLERANCES = {
    torch.float32: (2e-3, 1e-3, 1e-3, 0.999),
    torch.bfloat16: (5e-3, 5e-3, 1e-3, 0.999),
}

FLAGSHIP_CONVS = [
    ("e1a", 33, 66, (1, 2, 2), (64, 224, 192)), ("e1b", 66, 66, (1, 1, 1), (64, 112, 96)),
    ("e2a", 66, 132, (2, 2, 2), (64, 112, 96)), ("d1a", 132, 66, (1, 1, 1), (64, 112, 96)),
    ("d1b", 66, 66, (1, 1, 1), (64, 112, 96)),
]


# K5's and T3's milliseconds in their previous design (mma.sync, 8 x 32
# output positions x 72 output channels per CTA, K padded to 16 channels, one
# staging buffer), bf16, on one NVIDIA H100 80GB HBM3 at a 700.00 W power
# limit: K5 at batch 4 by tools.exp_conv_v2 bench (git commit 6b4ab89), T3 at
# the JAX tool's CASES by tools.exp_conv_kernel (git commit 179b1e6).
MMA_SYNC_DESIGN_MS = {
    "K5": {"e1a": 6.496, "e1b": 3.988, "e2a": 3.878, "d1a": 7.331, "d1b": 3.960},
    "T3": {"e0b": 2.170, "e1a": 5.018, "e1b": 1.927, "e2a": 1.525, "e2b": 1.044, "d4": 0.634,
           "d0": 2.729},
}


def sm90_plan_str(layout: str, lib_name: str, args: tuple, py_args: tuple) -> str:
    """The bf16 conv kernel's plan for one shape, as the library computes it,
    after asserting that the Python mirror agrees."""
    from nextou_tpu_torch.kernels.conv import (PLAN_KEYS, conv_sm90_plan, describe_plan,
                                               library_plan)

    got = library_plan(lib_name, args)
    want = conv_sm90_plan(layout, *py_args)
    if any(got[k] != want[k] for k in PLAN_KEYS):
        raise AssertionError(f"{lib_name} plan {got} differs from the Python mirror's {want}")
    return describe_plan(got)


def hold_k5(name, C, Co, stride, spatial, dtype, B, gen, dev, totals: Totals, count: int = 1,
            previous_ms: float | None = None):
    """K5 at one conv shape against its plain version (phase 9's rule: f32
    within 1e-4, bf16 within one rounding of the output, 2^-7 of the value
    + 1e-3); its time beside ``F.conv3d``'s, the plain version's, the bound
    and (bf16) the previous design's where it was measured, added ``count``
    times to ``totals``."""
    import torch.nn.functional as F

    from nextou_tpu_torch.kernels.conv import conv3d, conv3d_reference

    x = torch.randn(B, C, *spatial, generator=gen, device=dev).to(dtype)
    w = (torch.randn(Co, C, 3, 3, 3, generator=gen, device=dev) * 0.05).to(dtype)
    got = conv3d(x, w, stride)
    torch.cuda.synchronize()
    want = conv3d_reference(x, w, stride)
    out_spatial = tuple(n // s for n, s in zip(spatial, stride))
    assert got.shape == want.shape == (B, Co, *out_spatial) and got.dtype == dtype
    assert torch.isfinite(got.float()).all()
    diff = (got.float() - want.float()).abs()
    err, differ = diff.max().item(), (diff > 0).float().mean().item()
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7 * want.float().abs() + 1e-3
    ok = bool((diff <= tol).all())
    del diff, want, tol
    t_k5 = cuda_ms(lambda: conv3d(x, w, stride), iters=3, warmup=1)
    t_lib = cuda_ms(lambda: F.conv3d(x, w, None, stride, 1))
    t_plain = cuda_ms(lambda: conv3d_reference(x, w, stride), iters=2, warmup=1)
    flops = 2.0 * B * math.prod(out_spatial) * 27 * C * Co
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    bound, by = bound_ms(nbytes(x, w, got), flops, peak)
    totals.add(count, t_k5, t_plain, bound, by, err, t_lib)
    extra = "f32 FMA kernel (unchanged)"
    if dtype == torch.bfloat16:
        extra = ((f"previous design {previous_ms:.3f} ms; " if previous_ms is not None else "")
                 + sm90_plan_str("ncdhw", "conv3d", (B, C, *spatial, Co, 3, 3, 3, *stride),
                                 (B, C, spatial, Co, (3, 3, 3), stride)))
    print(f"K5 {name} B={B} {C}->{Co} stride {stride} in {spatial} {str(dtype)[6:]}: "
          f"max|err| {err:.3g} ({differ:.2e} of values differ)  K5 {t_k5:.3f} ms "
          f"({flops / t_k5 / 1e9:.1f} TFLOP/s)  cudnn {t_lib:.3f} ms  plain {t_plain:.3f} ms  "
          f"bound {bound:.4f} ms ({by}); {extra}")
    if not ok:
        raise AssertionError(f"K5 disagrees with the plain version at {name} {dtype}")
    del x, w, got
    torch.cuda.empty_cache()


def conv_kernel_phase(spec, dev) -> Totals:
    """K5 at the five flagship convs of its region: bf16 at the serving
    batch and f32 at batch 1 against the plain version; times by CUDA events
    beside ``F.conv3d``'s. Returns the bf16 sums: one serving forward's."""
    calls = conv_calls(spec)
    if calls != FLAGSHIP_CONVS:
        raise AssertionError(f"conv_kernel='1' routes {calls}")
    assert [c[0] for c in conv_calls(spec, "s1")] == ["e1b", "d1a", "d1b"]
    assert [c[0] for c in conv_calls(spec, "s2")] == ["e1a", "e2a"]
    gen = torch.Generator(device=dev).manual_seed(40)
    totals = {torch.bfloat16: Totals(), torch.float32: Totals()}
    for name, C, Co, stride, spatial in calls:
        for dtype, B in ((torch.bfloat16, TILE_BATCH * MIRRORS_PER_FORWARD), (torch.float32, 1)):
            hold_k5(name, C, Co, stride, spatial, dtype, B, gen, dev, totals[dtype],
                    previous_ms=MMA_SYNC_DESIGN_MS["K5"][name])
    for dtype, t in totals.items():
        prev = (f", previous design {sum(MMA_SYNC_DESIGN_MS['K5'].values()):.3f} ms"
                if dtype == torch.bfloat16 else "")
        print(f"K5 over the five convs ({str(dtype)[6:]}): {t.ms:.3f} ms, cudnn {t.library_ms:.3f} "
              f"ms, plain {t.plain_ms:.3f} ms, bound {t.bound_ms:.3f} ms{prev}")
    return totals[torch.bfloat16]


def narrow_flagship_spec():
    """The flagship's patch, kernels and strides at widths 6/12: its five
    convs of K5's region are in this network's too."""
    from nextou_tpu_torch.models.presets import flagship_3d_spec
    from nextou_tpu_torch.models.spec import build_model_spec

    flagship = flagship_3d_spec()
    return build_model_spec(
        in_channels=1, patch_size=flagship.patch_size, n_stages=6,
        features_per_stage=[6, 12, 12, 12, 12, 12],
        kernel_sizes=[st.kernel_size for st in flagship.encoder],
        strides=[st.stride for st in flagship.encoder],
        n_conv_per_stage=[2] * 6, n_conv_per_stage_decoder=[2] * 5,
        num_classes=3, deep_supervision=False,
    )


def conv_serving_phase(dev, tmp: str, spec, shape) -> dict:
    """One flagship volume through ``predict.main --conv-kernel 1``, on the
    dataset and checkpoint that :func:`slice_phase` left in ``tmp``; then a
    narrow network of the flagship's geometry with the kernel on against
    off, on the card in f32."""
    from nextou_tpu_torch import predict
    from nextou_tpu_torch.kernels.conv import conv3d_cuda
    from nextou_tpu_torch.kernels.knn import knn_max_cuda
    from nextou_tpu_torch.models import NexToU
    from nextou_tpu_torch.utils import init_weights

    config = "3d_fullres_nextou"
    data_dir, model_dir, out_dir = (os.path.join(tmp, d) for d in ("data", "model", "out_k5"))
    forwards = 2 * (8 // MIRRORS_PER_FORWARD)  # 4 tiles at tile batch 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    conv3d_cuda.launches = knn_max_cuda.launches = 0
    t0 = time.time()
    predict.main([model_dir, data_dir, config, "-tr", "nnUNetTrainer_NexToU", "-o", out_dir,
                  "--cases", "case_000", "--tile-batch", str(TILE_BATCH), "--device", str(dev),
                  "--conv-kernel", "1"])
    torch.cuda.synchronize()
    main_s = time.time() - t0
    launches, k1 = conv3d_cuda.launches, knn_max_cuda.launches
    peak = torch.cuda.max_memory_allocated(dev)
    with np.load(os.path.join(out_dir, "case_000.npz")) as z:
        seg = z["seg"]
    with np.load(os.path.join(tmp, "out", "case_000.npz")) as z:
        agree = float(np.mean(seg == z["seg"]))
    print(f"predict.main --conv-kernel 1: 1 volume {shape}, {forwards} forwards, {main_s:.2f} s "
          f"incl. model build and load; K5 launches {launches}, K1 launches {k1}; peak device "
          f"memory {peak / 2**30:.2f} GiB; labels {np.unique(seg).tolist()}; the same label as "
          f"without the kernel on {agree:.4f} of voxels")
    if (launches, k1) != (5 * forwards, 14 * forwards):
        raise AssertionError(f"K5 launched {launches} times, K1 {k1}, in {forwards} forwards")
    assert seg.shape == shape and seg.dtype == np.uint8 and seg.max() < spec.num_classes

    plans, _, infer_spec = predict.load_dataset(data_dir, config)
    checkpoint = os.path.join(model_dir, "checkpoint_final.pth")
    data = next(d for _, d in predict.iter_cases(data_dir, plans, config, ["case_000"]))
    times = {}
    for mode in ("1", "0"):
        model = predict.load_model(infer_spec, checkpoint, dev, conv_kernel=mode)
        seg_pred = predict.build_predictor(model, (0, 1, 2), tile_batch=TILE_BATCH, output="seg")
        torch.cuda.synchronize()
        t0 = time.time()
        seg_pred(data)
        torch.cuda.synchronize()
        times[mode] = time.time() - t0
        del model, seg_pred
    print(f"seconds per volume (8-way TTA, tile batch {TILE_BATCH}, bf16): {times['1']:.3f} with "
          f"conv_kernel='1', {times['0']:.3f} with '0' in the same run")

    # the f32 kernel, then the bf16 one, each in a network against the library conv
    narrow = narrow_flagship_spec()
    x = torch.from_numpy(np.random.default_rng(41).standard_normal(
        (2, *narrow.patch_size, 1)).astype(np.float32)).to(dev)
    for dtype, (atol, rtol, max_off, min_same) in NARROW_TOLERANCES.items():
        out = {}
        for mode in ("1", "0"):
            model = init_weights(
                NexToU(narrow, dtype=dtype, conv_kernel=mode, device=dev), seed=3).eval()
            conv3d_cuda.launches = 0
            with torch.no_grad():
                for p in model.parameters():
                    if p.dim() >= 2:
                        p.mul_(0.5)
                out[mode] = model(x).float().cpu().numpy()
            if conv3d_cuda.launches != (5 if mode == "1" else 0):
                raise AssertionError(
                    f"narrow network, mode {mode}: K5 launched {conv3d_cuda.launches} times")
        got, want = out["1"], out["0"]
        off = np.abs(got - want) > atol + rtol * np.abs(want)
        same = float(np.mean(np.argmax(got, -1) == np.argmax(want, -1)))
        print(f"narrow flagship-geometry network {str(dtype)[6:]}, conv_kernel '1' vs '0' on the "
              f"card: max|diff| {np.abs(got - want).max():.3g} (max|logit| {np.abs(want).max():.3g}), "
              f"{off.mean():.2e} of values outside atol {atol:g}/rtol {rtol:g}, argmax agreement "
              f"{same:.6f}")
        if off.mean() > max_off or same < min_same:
            raise AssertionError(f"the {dtype} network with the conv kernel on disagrees with it off")
    return {"launches": launches, "s_per_volume": times["1"], "s_per_volume_off": times["0"],
            "peak_bytes": peak}


def conv_train_phase(dev, spec, first_loss_off: float) -> dict:
    """The training slice with the conv kernel on: the flagship of
    :func:`train_phase` (the same seed and batch) with ``conv_kernel="1"``."""
    from nextou_tpu_torch.kernels.conv import conv3d_cuda
    from nextou_tpu_torch.losses import CompoundLossSpec, deep_supervision_weights
    from nextou_tpu_torch.models import NexToU
    from nextou_tpu_torch.models.nextou import remat_flags
    from nextou_tpu_torch.train import create_train_state, make_optimizer, make_train_step, poly_lr

    rng = np.random.default_rng(20)
    batch = {
        "data": rng.standard_normal((TRAIN_BATCH, *spec.patch_size, 1), dtype=np.float32),
        "seg": rng.integers(0, spec.num_classes, (TRAIN_BATCH, *spec.patch_size)),
    }
    model = NexToU(spec, dtype=torch.bfloat16, conv_kernel="1", device=dev)
    opt = make_optimizer(poly_lr(1e-2, 1000, 0.9, steps_per_epoch=250))
    state = create_train_state(model, opt, seed=0)
    step = make_train_step(model, opt, CompoundLossSpec(), deep_supervision_weights(len(spec.decoder)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    seconds, losses, launches = [], [], []
    for i in range(3):
        if i == 2:  # every stage recomputed: each routed conv launches twice
            model.remat = remat_flags(spec, True)
        conv3d_cuda.launches = 0
        t0 = time.time()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        seconds.append(time.time() - t0)
        loss, norm = metrics["loss"].item(), metrics["grad_norm"].item()
        losses.append(loss)
        launches.append(conv3d_cuda.launches)
        print(f"train step {i} with conv_kernel='1'{' (every stage recomputed)' if i == 2 else ''}: "
              f"loss {loss:.4f} grad_norm {norm:.4f} {seconds[-1]:.3f} s, K5 launches {launches[-1]}")
        if not (math.isfinite(loss) and math.isfinite(norm)):
            raise AssertionError(f"train step {i} with the conv kernel: loss {loss}, grad_norm {norm}")
    peak = torch.cuda.max_memory_allocated(dev)
    off = abs(losses[0] - first_loss_off) / abs(first_loss_off)
    print(f"first loss {losses[0]:.6f} against {first_loss_off:.6f} with conv_kernel='0' from the "
          f"same state: off by {off:.2e}; peak device memory {peak / 2**30:.2f} GiB")
    if launches != [5, 5, 10] or off > 1e-2:
        raise AssertionError(f"train steps with the conv kernel: launches {launches}, loss off {off}")
    return {"launches": sum(launches[:2]), "s_per_step": seconds[1], "peak_bytes": peak}


def tools_phase(dev) -> dict:
    """T4's check, T2's probe and T1's dissection through the tools' own
    functions; returns the probes' records and launch counts."""
    import torch.nn.functional as F

    from nextou_tpu_torch.tools import exp_conv_probe, exp_conv_v2, exp_knn_dissect

    exp_conv_v2.check(dev)

    probe = Totals()
    exp_conv_probe.conv_probe_cuda.launches = 0
    TH, C, W, CO = (getattr(exp_conv_probe, n) for n in ("TH", "C", "W", "CO"))
    x, w = (torch.from_numpy(a).to(dev) for a in exp_conv_probe.probe_inputs())
    # the same function as one library call: a conv along the rows, k = 3
    x3, w3 = x.reshape(TH + 2, C, W).permute(2, 1, 0), w.reshape(3, C, CO).permute(2, 1, 0)
    want = exp_conv_probe.conv_probe_reference(x, w, True)
    assert (F.conv1d(x3, w3).permute(2, 1, 0) - want).abs().max() < exp_conv_probe.TOLERANCE
    t_lib = cuda_ms(lambda: F.conv1d(x3, w3), iters=20)
    moved = (x.numel() + w.numel() + TH * W * CO) * 4
    bound, by = bound_ms(moved, 2.0 * TH * W * 3 * C * CO)
    times = {}
    for transpose_out in (False, True):
        r = exp_conv_probe.run(dev, transpose_out)
        probe.add(1, r["ms"], r["plain_ms"], bound, by, r["err"], t_lib)
        times["(TH, Co, W)" if transpose_out else "(TH, W, Co)"] = r["ms"]
    floor = exp_conv_probe.launch_floor_ms(dev)
    print("conv_probe per output order: " + ", ".join(f"{o} {t:.4f} ms" for o, t in times.items())
          + f"; library conv1d {t_lib:.4f} ms; empty kernel {floor:.4f} ms; "
          f"bound {bound:.6f} ms ({by})")

    dissect = Totals()
    exp_knn_dissect.knn_dissect_cuda.launches = 0
    for tag, B, N, M, C, k, self_graph in exp_knn_dissect.SHAPES:
        r = exp_knn_dissect.bench_shape(tag, B, N, M, C, k, self_graph, dev)
        # f32 coordinates (once for a self-graph), bf16 values and the f32
        # bias in, the f32 max out
        moved = (B * N * C + (0 if self_graph else B * M * C)) * 4 + B * M * C * 2 + N * M * 4
        moved += B * N * C * 4
        bound, by = bound_ms(moved, 2.0 * B * N * M * C, PEAK_SPLIT_FLOPS)
        dissect.add(1, r["full"], r["plain_ms"], bound, by, r["max_abs_err"])
        old = FIRST_DESIGN_T1_MS.get(tag, {})
        print(f"knn_dissect {tag}: bound {bound:.4f} ms ({by}); first design: "
              + (", ".join(f"{mode} {ms:.3f} ms" for mode, ms in old.items()) or "not measured")
              + "; " + plan_str(B, N, M, C, k, self_graph=self_graph))
        torch.cuda.empty_cache()
    return {"conv_probe": probe, "knn_dissect": dissect,
            "probe_launches": exp_conv_probe.conv_probe_cuda.launches,
            "dissect_launches": exp_knn_dissect.knn_dissect_cuda.launches}


def conv_cl_phase(dev) -> tuple[Totals, int]:
    """T3 through the tool's own functions: ``check`` and ``check3`` (both
    entry points, f32 and bf16, against the plain version and the library
    conv), then every case of the JAX tool's ``CASES`` in bf16 at full size,
    timed beside ``F.conv3d`` on ``channels_last_3d`` tensors, the plain
    version and the bound (2 N S_out taps C Co operations at the bf16 tensor
    cores' peak, or the bytes). Returns the sums and the kernel's launches in
    the tool's run."""
    from nextou_tpu_torch.tools import exp_conv_kernel as t3

    t3.conv_cl_cuda.launches = 0
    t3.check(dev)
    t3.check3(dev)
    totals = Totals()
    for name, shape, co, kernel, stride in t3.CASES:
        r = t3.time_case(t3.pallas_conv, shape, co, kernel, stride, dev)
        bound, by = bound_ms(r["bytes"], r["flops"], PEAK_BF16_FLOPS)
        totals.add(1, r["ms"], r["plain_ms"], bound, by, r["max_abs_err"], r["library_ms"])
        plan = sm90_plan_str("ndhwc", "conv_cl", (shape[0], *shape[1:4], shape[4], co, *kernel,
                                                   *stride),
                             (shape[0], shape[4], shape[1:4], co, kernel, stride))
        print(f"conv_cl {name} {shape}->{co} k{kernel} s{stride} bf16: {r['ms']:.3f} ms "
              f"({r['flops'] / r['ms'] / 1e9:.1f} TFLOP/s)  F.conv3d channels_last "
              f"{r['library_ms']:.3f} ms  plain {r['plain_ms']:.3f} ms  bound {bound:.4f} ms ({by})  "
              f"max|err| {r['max_abs_err']:.3g}; previous design "
              f"{MMA_SYNC_DESIGN_MS['T3'][name]:.3f} ms; {plan}")
    launches = t3.conv_cl_cuda.launches
    print(f"conv_cl over the {len(t3.CASES)} cases: {totals.ms:.3f} ms, F.conv3d "
          f"{totals.library_ms:.3f} ms, plain {totals.plain_ms:.3f} ms, bound "
          f"{totals.bound_ms:.3f} ms, previous design {sum(MMA_SYNC_DESIGN_MS['T3'].values()):.3f} "
          f"ms; {launches} launches in the tool's run")
    return totals, launches


# the trainer phase: 5 cases of 1x64x280x240, fold 0 (4 training cases, 1
# validation case), 2 epochs of 4 iterations at the reference's 50
# validation iterations per epoch
TRAIN_CASES, TRAIN_SHAPE, EPOCHS, ITERS = 5, (64, 280, 240), 2, 4
# the host-DA path's figures of this phase on one NVIDIA H100 80GB HBM3 at
# 700.00 W, by chip_smoke.py of git commits 6fffebe and 22db5b0, printed
# beside this run's device-DA figures
HOST_DA_WAIT = "0.545 in epoch 0 at 22db5b0, 0.339 at 6fffebe"
HOST_DA_LOADER = "0.322 s per batch at 22db5b0, 0.276 at 6fffebe"


def trainer_phase(dev, tmp: str) -> dict:
    """The trainer at the flagship's full width through
    ``nextou_tpu_torch.run_training.main``, then ``predict.main`` on its
    ``checkpoint_final.pth``."""
    from nextou_tpu_torch import predict, run_training
    from nextou_tpu_torch.infer.sliding_window import compute_sliding_window_steps
    from nextou_tpu_torch.kernels.conv import conv3d_cuda
    from nextou_tpu_torch.kernels.knn import knn_max_bwd_cuda, knn_max_cuda, knn_max_idx_cuda
    from nextou_tpu_torch.models.presets import flagship_3d_spec

    config, spec = "3d_fullres_nextou", flagship_3d_spec(num_classes=14)
    data_dir = os.path.join(tmp, "train_data")
    t0 = time.time()
    write_dataset(data_dir, spec, config, TRAIN_CASES, TRAIN_SHAPE, seed=50, labelled=True)
    print(f"{TRAIN_CASES} labelled cases {TRAIN_SHAPE} written in {time.time() - t0:.1f} s")
    counters = (knn_max_cuda, knn_max_idx_cuda, knn_max_bwd_cuda, conv3d_cuda)
    for counter in counters:
        counter.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    trainer = run_training.main([data_dir, config, "0", "-tr", "nnUNetTrainer_NexToU",
                                 "--epochs", str(EPOCHS), "--iters", str(ITERS),
                                 "--device", str(dev)])
    torch.cuda.synchronize()
    main_s = time.time() - t0
    k1, k3, k4, k5 = (c.launches for c in counters)
    peak = torch.cuda.max_memory_allocated(dev)
    out = trainer.output_folder

    _, val = trainer.get_split()
    tiles = math.prod(len(s) for s in compute_sliding_window_steps(TRAIN_SHAPE, spec.patch_size))
    val_forwards = len(val.case_ids) * math.ceil(tiles / TILE_BATCH) * (8 // MIRRORS_PER_FORWARD)
    steps, evals = EPOCHS * ITERS, EPOCHS * trainer.num_val_iterations_per_epoch
    print(f"run_training.main: {EPOCHS} epochs x {ITERS} iterations, {evals} eval steps, "
          f"validation of {len(val.case_ids)} case(s) ({val_forwards} forwards): {main_s:.2f} s "
          f"incl. model build; remat {trainer.remat!r}; K3 {k3}, K4 {k4}, K1 {k1}, K5 {k5} "
          f"launches; peak device memory {peak / 2**30:.2f} GiB")
    if trainer.remat is not False:
        raise AssertionError(f"auto remat chose {trainer.remat!r} for the flagship at batch 2")
    if (k3, k4, k1, k5) != (14 * steps, 14 * steps, 14 * (evals + val_forwards), 0):
        raise AssertionError(f"trainer launches: K3 {k3} K4 {k4} K1 {k1} K5 {k5}")
    with open(os.path.join(out, "training_log.txt")) as f:
        log = f.read()
    remat_line = next((line for line in log.splitlines() if "auto remat:" in line), None)
    if remat_line is None or "activation estimate" not in remat_line:
        raise AssertionError("the trainer did not log its remat choice with its estimate")
    print(f"  {remat_line.split(' ', 2)[2]}")
    for e in trainer.log_history:
        per_iter = e["train_time_s"] / ITERS
        print(f"epoch {e['epoch']}: train_loss {e['train_loss']:.4f} val_loss {e['val_loss']:.4f} "
              f"ema {e['ema_pseudo_dice']:.4f}; {e['epoch_time_s']:.2f} s per epoch, train "
              f"{e['train_time_s']:.2f} s = {per_iter:.3f} s per iteration, waiting in "
              f"next(train_it) {e['loader_wait_s']:.2f} s = "
              f"{e['loader_wait_s'] / e['train_time_s']:.3f} of the train loop")
        if not (math.isfinite(e["train_loss"]) and math.isfinite(e["val_loss"])):
            raise AssertionError(f"epoch {e['epoch']}: a loss is not finite")
    print(f"host: os.cpu_count() {os.cpu_count()}, loader threads {trainer.loader_threads}")
    # device_da="auto" on the card: the loader draws plans, the step augments
    da_line = next((line for line in log.splitlines() if " DA: initial patch size" in line), "")
    print(f"DA path: device_da={trainer.device_da!r} ({da_line.split(' ', 2)[-1]}); loader wait "
          f"in epoch 0 {trainer.log_history[0]['loader_wait_s'] / trainer.log_history[0]['train_time_s']:.3f} "
          f"of the train loop (host DA: {HOST_DA_WAIT})")
    if trainer.device_da is not True or "device DA" not in da_line:
        raise AssertionError(f"device_da='auto' took the {trainer.device_da!r} path on the card")
    for name in ("checkpoint_final.pth", "checkpoint_best.pth", "training_log.txt",
                 "validation/summary.json"):
        if not os.path.exists(os.path.join(out, name)):
            raise AssertionError(f"the trainer wrote no {name}")
    with open(os.path.join(out, "validation", "summary.json")) as f:
        summary = json.load(f)
    print(f"validation/summary.json: foreground mean Dice {summary['foreground_mean']['Dice']:.4f}")

    # predict.main serves the trainer's checkpoint_final.pth
    pred_dir = os.path.join(tmp, "train_pred")
    knn_max_cuda.launches = 0
    predict.main([out, data_dir, config, "-tr", "nnUNetTrainer_NexToU", "-o", pred_dir,
                  "--cases", *val.case_ids, "--tile-batch", str(TILE_BATCH), "--device", str(dev)])
    torch.cuda.synchronize()
    if knn_max_cuda.launches != 14 * val_forwards:
        raise AssertionError(f"predict.main launched K1 {knn_max_cuda.launches} times")
    for cid in val.case_ids:
        with np.load(os.path.join(pred_dir, f"{cid}.npz")) as z:
            seg = z["seg"]
        with np.load(os.path.join(out, "validation", f"{cid}.npz")) as z:
            agree = float(np.mean(seg == z["seg"]))
        print(f"predict.main on checkpoint_final.pth, {cid}: labels {np.unique(seg).tolist()}, "
              f"the trainer's validation label on {agree:.6f} of voxels")
        if seg.shape != TRAIN_SHAPE or seg.max() >= spec.num_classes or agree < 0.99:
            raise AssertionError(f"predict.main on the trained checkpoint: {cid}")

    # the loader alone (sampling and the plans): seconds per batch once its
    # queue has drained, beside the seconds per train step
    loader, _ = trainer.get_dataloaders()
    per_batch = loader_seconds_per_batch(loader)
    print(f"loader alone, device DA ({trainer.loader_threads} threads, {os.cpu_count()} cores): "
          f"{per_batch:.3f} s per batch of {trainer.batch_size} over {LOADER_BATCHES} batches "
          f"(host DA: {HOST_DA_LOADER})")
    last = trainer.log_history[-1]
    return {"k1": k1, "k3": k3, "k4": k4, "s_per_iter": last["train_time_s"] / ITERS,
            "wait_share": last["loader_wait_s"] / last["train_time_s"], "peak_bytes": peak,
            "loader_s_per_batch": per_batch, "log": trainer.log_history}


# --- on-device augmentation (phase 20) -------------------------------------------------

# the flagship's final patch at batch 2, one channel; rotation +-30 degrees per
# axis gives the initial patch (92, 324, 398), dummy 2D (+-180 degrees in
# plane) gives (64, 320, 320); the trainer loop on phase 14's cases
DA_BATCH, DA_ITERS = 2, 8
DA_ALL = dict.fromkeys(("p_rotation", "p_scaling", "p_noise", "p_blur", "p_brightness",
                        "p_contrast", "p_lowres", "p_gamma_invert", "p_gamma"), 1.0)
# each transform's fields of the plan, timed alone on the crop
DA_TRANSFORMS = {"rotation+scaling": ("mat", "offset"), "noise": ("noise",), "blur": ("blur",),
                 "brightness": ("brightness",), "contrast": ("contrast",),
                 "lowres": ("lowres",), "gamma": ("gamma",), "mirror": ("mirror",)}


def fired_everywhere(plans) -> bool:
    """Every transform fired in some sample, the per-channel coins too."""
    def fired(plan, field):
        value = getattr(plan, field)
        if field in ("blur", "lowres"):  # a coin per channel
            return value is not None and any(v is not None for v in value)
        return value is not None and (not isinstance(value, (list, tuple)) or len(value) > 0)

    return all(any(fired(p, fields[0]) for p in plans) for fields in DA_TRANSFORMS.values())


def device_augment_phase(dev, tmp: str) -> dict:
    """Phase 20: the card's device DA against the host path at the
    flagship's full patch, each transform's time, then the trainer loop
    with ``device_da`` off and on on phase 14's cases."""
    from nextou_tpu_torch.data.augment import AugmentConfig, augment_batch, initial_patch_size
    from nextou_tpu_torch.data.device_augment import (
        AugmentPlan, device_augment_batch, draw_augment_plan,
    )
    from nextou_tpu_torch.models.presets import flagship_3d_spec
    from nextou_tpu_torch.tools.exp_trainer_loop import run

    t_phase = time.time()
    final = tuple(flagship_3d_spec().patch_size)
    out = {}
    for name, probs, dummy in (("default", {}, False), ("default, dummy 2D", {}, True),
                               ("every p = 1", DA_ALL, False),
                               ("every p = 1, dummy 2D", DA_ALL, True)):
        rot = (math.pi,) * 3 if dummy else (math.pi / 6,) * 3
        cfg = AugmentConfig(**probs, rotation_rad=rot, dummy_2d=dummy, mirror_axes=(0, 1, 2),
                            final_patch_size=final)
        initial = initial_patch_size(final, rot, dummy)
        rng = np.random.default_rng(60)
        cases = [labelled_case(rng, initial, 14) for _ in range(DA_BATCH)]
        data = np.stack([d[None] for d, _ in cases])
        seg = np.stack([s for _, s in cases])
        # the plans' seed: the first from 0 whose plans fire every transform
        # somewhere where every p is 1 (blur and lowres toss a coin per channel)
        seed = 0
        while probs and not fired_everywhere(
                [draw_augment_plan(cfg, d.shape, np.random.default_rng(seed)) for d in data]):
            seed += 1
        t0 = time.perf_counter()
        plan_rng = np.random.default_rng(seed)
        plans = [draw_augment_plan(cfg, d.shape, plan_rng) for d in data]
        plan_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want_d, want_s, _ = augment_batch(data.copy(), seg.copy(), cfg, np.random.default_rng(seed))
        host_s = time.perf_counter() - t0
        # the upload as the train step makes it (the loader pins the batch),
        # and from pageable memory
        pinned = [torch.from_numpy(a).pin_memory() for a in (data, seg)]
        upload_ms = cuda_ms(lambda: [a.to(dev, non_blocking=True) for a in pinned], iters=3,
                            warmup=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data_dev, seg_dev = torch.from_numpy(data).to(dev), torch.from_numpy(seg).to(dev)
        torch.cuda.synchronize()
        pageable_ms = (time.perf_counter() - t0) * 1e3
        got_d, got_s, _ = device_augment_batch(data_dev, seg_dev, plans, cfg)
        batch_ms = cuda_ms(lambda: device_augment_batch(data_dev, seg_dev, plans, cfg), iters=3,
                           warmup=1)
        got_d, got_s = got_d.cpu().numpy(), got_s.cpu().numpy()
        err = np.abs(got_d - want_d)
        outside = int((err > 1e-4 + 1e-5 * np.abs(want_d)).sum())
        agree = float((got_s == want_s).mean())
        spatial = any(p.mat is not None for p in plans)
        print(f"device DA, {name}: {initial} -> {final}, batch {DA_BATCH}, plans of seed {seed} "
              f"(spatial {[p.mat is not None for p in plans]}); data max |card - host| "
              f"{err.max():.3g}, {outside} values outside atol 1e-4 / rtol 1e-5; seg equal on "
              f"{agree:.6f} of voxels; device_augment_batch {batch_ms:.2f} ms per batch "
              f"(CUDA events), upload {upload_ms:.2f} ms pinned ({pageable_ms:.2f} ms from pageable "
              f"memory), plans {plan_s * 1e3:.2f} ms, host "
              f"augment_batch {host_s:.3f} s")
        if got_d.shape != want_d.shape or outside or agree < 0.9999 or (
                not spatial and agree != 1.0):
            raise AssertionError(f"device DA ({name}) differs from the host path")
        out[name] = {"batch_ms": batch_ms, "upload_ms": upload_ms, "pageable_ms": pageable_ms,
                     "host_s": host_s,
                     "max_abs_err": float(err.max()), "seg_agree": agree}
        if not probs:
            continue
        times = {"crop": cuda_ms(lambda: device_augment_batch(
            data_dev, seg_dev, [AugmentPlan(p.in_shape, p.out_shape) for p in plans], cfg),
            iters=3, warmup=1)}
        for transform, fields in DA_TRANSFORMS.items():
            alone = [AugmentPlan(p.in_shape, p.out_shape, **{f: getattr(p, f) for f in fields})
                     for p in plans]
            times[transform] = cuda_ms(lambda a=alone: device_augment_batch(
                data_dev, seg_dev, a, cfg), iters=3, warmup=1)
        print(f"  each transform alone on the batch (CUDA events, ms; the crop included): "
              + ", ".join(f"{k} {v:.2f}" for k, v in times.items()))
        out[name]["transform_ms"] = times
        del data_dev, seg_dev
        torch.cuda.empty_cache()

    data_dir = os.path.join(tmp, "train_data")  # phase 14's cases
    for device_da in (False, True):
        row = run(data_dir, os.path.join(tmp, f"da_loop_{device_da}"), 2, device_da, DA_ITERS,
                  device=str(dev))
        print(f"trainer loop, device_da {'on' if device_da else 'off'}: 1 epoch x {DA_ITERS} "
              f"iterations, {row['s_per_iter']:.3f} s per iteration, waiting in next(train_it) "
              f"{row['wait_share']:.3f} of the loop; the loader alone "
              f"{row['loader_s_per_batch']:.3f} s per batch (2 threads); train loss "
              f"{row['train_loss']:.4f}")
        if not math.isfinite(row["train_loss"]):
            raise AssertionError(f"device_da={device_da}: the train loss is not finite")
        out[f"loop_{device_da}"] = row
    print(f"phase 20: {time.time() - t_phase:.1f} s")
    return out


# --- data parallel (phase 21) ----------------------------------------------------------

# (b): the flagship at a global batch of 2 on two ranks of one sample, Dice + CE
DP_STEPS, DP_WORLD = 3, 2


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _dp_batches(spec) -> list:
    rng = np.random.default_rng(21)
    return [{"data": rng.standard_normal((TRAIN_BATCH, *spec.patch_size, 1), dtype=np.float32),
             "seg": rng.integers(0, spec.num_classes, (TRAIN_BATCH, *spec.patch_size))}
            for _ in range(DP_STEPS)]


def _dp_state(dev, spec):
    from nextou_tpu_torch.losses import CompoundLossSpec, deep_supervision_weights
    from nextou_tpu_torch.models import NexToU
    from nextou_tpu_torch.parallel import broadcast_module
    from nextou_tpu_torch.train import create_train_state, make_optimizer, make_train_step, poly_lr

    model = NexToU(spec, dtype=torch.bfloat16, device=dev)
    opt = make_optimizer(poly_lr(1e-2, 1000, 0.9, steps_per_epoch=250))
    state = create_train_state(model, opt, seed=0)
    broadcast_module(model)
    step = make_train_step(model, opt, CompoundLossSpec(),
                           deep_supervision_weights(len(spec.decoder)))
    return state, step


def _dp_rank(r: int, port: int, tmp: str) -> None:
    """Phase 21 (b), one rank: two ranks share card 0 over gloo, each with
    one sample of every batch; its losses, gradient norms, seconds, kernel
    launches and all-reduces per step, and a digest of its parameters and
    buffers after the steps, compared with the other rank's over a
    broadcast. Written to ``tmp/dp_rank{r}.pt``."""
    import hashlib

    import torch.distributed as dist

    from nextou_tpu_torch import parallel
    from nextou_tpu_torch.kernels.knn import knn_max_bwd_cuda, knn_max_cuda, knn_max_idx_cuda
    from nextou_tpu_torch.models.presets import flagship_3d_spec

    os.environ.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(DP_WORLD),
                      LOCAL_WORLD_SIZE=str(DP_WORLD), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    dev = parallel.initialize_distributed("cuda")
    try:
        spec = flagship_3d_spec(num_classes=14, deep_supervision=True)
        state, step = _dp_state(dev, spec)
        # every all-reduce timed to a synchronize on both sides (gloo copies
        # CUDA tensors through host memory and waits for them anyway)
        reduce_ms, all_reduce = [], dist.all_reduce

        def timed_all_reduce(t, *args, **kw):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = all_reduce(t, *args, **kw)
            torch.cuda.synchronize(dev)
            reduce_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        dist.all_reduce = timed_all_reduce
        rows = []
        for batch in _dp_batches(spec):
            batch = {k: v[r:r + 1] for k, v in batch.items()}
            before = (knn_max_idx_cuda.launches, knn_max_bwd_cuda.launches, knn_max_cuda.launches,
                      parallel.all_reduce.calls, len(reduce_ms))
            torch.cuda.synchronize(dev)
            t0 = time.time()
            state, metrics = step(state, batch)
            torch.cuda.synchronize(dev)
            rows.append({
                "s": time.time() - t0, "loss": metrics["loss"].item(),
                "grad_norm": metrics["grad_norm"].item(),
                "k3": knn_max_idx_cuda.launches - before[0],
                "k4": knn_max_bwd_cuda.launches - before[1],
                "k1": knn_max_cuda.launches - before[2],
                "all_reduces": parallel.all_reduce.calls - before[3],
                "all_reduce_ms": sum(reduce_ms[before[4]:]),
            })
        dist.all_reduce = all_reduce
        sha = hashlib.sha256()
        for t in (*state.model.parameters(), *state.model.buffers()):
            sha.update(t.detach().contiguous().cpu().numpy().tobytes())
        mine = torch.tensor(list(sha.digest()), dtype=torch.uint8, device=dev)
        digests = []
        for src in range(DP_WORLD):
            d = mine.clone()
            dist.broadcast(d, src)
            digests.append(d.cpu().tolist())
        torch.save({"rows": rows, "digests": digests, "backend": str(dist.get_backend()),
                    "device": str(dev), "peak_bytes": torch.cuda.max_memory_allocated(dev)},
                   os.path.join(tmp, f"dp_rank{r}.pt"))
    finally:
        dist.destroy_process_group()


def one_rank_phase(tmp: str, trained: dict) -> None:
    """Phase 21 (a): the trainer under ``torch.distributed.run`` on one NCCL
    rank on phase 14's cases, against phase 14's run."""
    import subprocess

    data_dir, out = os.path.join(tmp, "train_data"), os.path.join(tmp, "dp_one_rank")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
           "-m", "nextou_tpu_torch.run_training", data_dir, "3d_fullres_nextou", "0",
           "-tr", "nnUNetTrainer_NexToU", "--epochs", "1", "--iters", str(ITERS), "-o", out]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    run_s = time.time() - t0
    if proc.returncode != 0:
        raise AssertionError(f"torch.distributed.run exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    with open(os.path.join(out, "training_log.txt")) as f:
        log = f.read()
    line = next((x for x in log.splitlines() if "data parallel: world size" in x), "")
    ckpt = torch.load(os.path.join(out, "checkpoint_final.pth"), map_location="cpu",
                      weights_only=True)
    (epoch,) = ckpt["logging"]
    ref = trained["log"][0]
    per_iter = epoch["train_time_s"] / ITERS
    print(f"phase 21 (a): torch.distributed.run --nproc_per_node 1 -m "
          f"nextou_tpu_torch.run_training, 1 epoch x {ITERS}: {run_s:.1f} s of command time; "
          f"log: '{line.split(' ', 2)[-1]}'; first step's loss {epoch['first_step_loss']!r} "
          f"(phase 14, no launcher: {ref['first_step_loss']!r}); all-reduces in the train "
          f"steps {epoch['train_all_reduces']}; {per_iter:.3f} s per iteration in epoch 0 "
          f"(phase 14: {ref['train_time_s'] / ITERS:.3f} in epoch 0, "
          f"{trained['s_per_iter']:.3f} in epoch 1)")
    if "world size 1, backend nccl, local batch 2" not in line:
        raise AssertionError(f"the one-rank run logged '{line}'")
    if epoch["first_step_loss"] != ref["first_step_loss"] or epoch["train_all_reduces"]:
        raise AssertionError("one NCCL rank is not the one-process step")
    for name in ("checkpoint_final.pth", "checkpoint_best.pth", "validation/summary.json"):
        if not os.path.exists(os.path.join(out, name)):
            raise AssertionError(f"rank 0 wrote no {name}")


def two_ranks_phase(dev, tmp: str) -> dict:
    """Phase 21 (b): two gloo ranks sharing the card, one flagship sample
    each, against one process at the same global batch. Returns the K3 and
    K4 launches of the ranks and of the one process."""
    import torch.multiprocessing as mp

    from nextou_tpu_torch.kernels.knn import knn_max_bwd_cuda, knn_max_idx_cuda
    from nextou_tpu_torch.models.presets import flagship_3d_spec

    t0 = time.time()
    ctx = mp.start_processes(_dp_rank, args=(_free_port(), tmp), nprocs=DP_WORLD, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + 600
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError("the two ranks did not finish in 600 s")
    ranks = [torch.load(os.path.join(tmp, f"dp_rank{r}.pt"), weights_only=False)
             for r in range(DP_WORLD)]
    ranks_s = time.time() - t0
    spec = flagship_3d_spec(num_classes=14, deep_supervision=True)
    state, step = _dp_state(dev, spec)
    for counter in (knn_max_idx_cuda, knn_max_bwd_cuda):
        counter.launches = 0
    one = []
    for batch in _dp_batches(spec):
        torch.cuda.synchronize()
        t1 = time.time()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        one.append({"s": time.time() - t1, "loss": metrics["loss"].item(),
                    "grad_norm": metrics["grad_norm"].item()})
    one_k3, one_k4 = knn_max_idx_cuda.launches, knn_max_bwd_cuda.launches
    del state, step
    for r, run in enumerate(ranks):
        for i, row in enumerate(run["rows"]):
            print(f"phase 21 (b) rank {r} ({run['backend']}, {run['device']}), step {i}: loss "
                  f"{row['loss']:.6f} grad_norm {row['grad_norm']:.4f}, {row['s']:.3f} s; "
                  f"{row['all_reduces']} all-reduces, {row['all_reduce_ms']:.1f} ms in them; "
                  f"K3 {row['k3']} K4 {row['k4']} K1 {row['k1']}")
        print(f"  rank {r}: peak device memory {run['peak_bytes'] / 2**30:.2f} GiB")
    for i, row in enumerate(one):
        print(f"phase 21 (b) one process, batch {TRAIN_BATCH}, step {i}: loss {row['loss']:.6f} "
              f"grad_norm {row['grad_norm']:.4f}, {row['s']:.3f} s")
    first, want = ranks[0]["rows"][0], one[0]
    loss_off = abs(first["loss"] - want["loss"]) / abs(want["loss"])
    norm_off = abs(first["grad_norm"] - want["grad_norm"]) / abs(want["grad_norm"])
    same = all(run["digests"][0] == run["digests"][1] for run in ranks)
    print(f"phase 21 (b): first loss off by {loss_off:.2e}, gradient norm by {norm_off:.2e} "
          f"(relative); parameters and buffers bit-equal across the ranks after {DP_STEPS} "
          f"steps: {same}; {ranks_s:.1f} s for the two ranks incl. start")
    if loss_off > 1e-2 or norm_off > 2e-2 or not same:
        raise AssertionError("two ranks of one sample are not one process of two")
    for run in ranks:
        if any((row["k3"], row["k4"], row["k1"]) != (14, 14, 0) for row in run["rows"]):
            raise AssertionError(f"per-step launches on a rank: {run['rows']}")
    if (one_k3, one_k4) != (14 * DP_STEPS, 14 * DP_STEPS):
        raise AssertionError(f"one process: K3 {one_k3} K4 {one_k4}")
    print(f"phase 21 (b): {time.time() - t0:.1f} s")
    return {"k3": 14 * DP_STEPS * (DP_WORLD + 1), "k4": 14 * DP_STEPS * (DP_WORLD + 1)}


def all_devices_phase(dev, tmp: str, spec, shape) -> int:
    """Phase 21 (c): ``predict.main --all-devices`` on phase 5's first case
    against the same call without it (one card: the seg bit for bit).
    Returns K1's launches."""
    from nextou_tpu_torch import predict
    from nextou_tpu_torch.infer.sliding_window import compute_sliding_window_steps
    from nextou_tpu_torch.kernels.knn import knn_max_cuda

    config = "3d_fullres_nextou"
    data_dir, model_dir = os.path.join(tmp, "data"), os.path.join(tmp, "model")
    tiles = math.prod(len(s) for s in compute_sliding_window_steps(shape, spec.patch_size))
    forwards = math.ceil(tiles / TILE_BATCH) * (8 // MIRRORS_PER_FORWARD)
    outs, launches = {}, 0
    for flag in ([], ["--all-devices"]):
        out = os.path.join(tmp, f"all_devices_{bool(flag)}")
        knn_max_cuda.launches = 0
        t0 = time.time()
        predict.main([model_dir, data_dir, config, "-tr", "nnUNetTrainer_NexToU", "-o", out,
                      "--cases", "case_000", "--tile-batch", str(TILE_BATCH),
                      "--device", str(dev), *flag])
        torch.cuda.synchronize()
        seconds = time.time() - t0
        if knn_max_cuda.launches != 14 * forwards:
            raise AssertionError(f"predict.main {flag}: K1 launched {knn_max_cuda.launches} times")
        launches += knn_max_cuda.launches
        with np.load(os.path.join(out, "case_000.npz")) as z:
            outs[bool(flag)] = z["seg"]
        print(f"phase 21 (c): predict.main {' '.join(flag) or '(no flag)'} on "
              f"{torch.cuda.device_count()} card(s): {seconds:.2f} s, K1 {14 * forwards}")
    same = outs[False].dtype == outs[True].dtype and np.array_equal(outs[False], outs[True])
    print(f"phase 21 (c): --all-devices seg bit-equal to the plain call's: {same}")
    if not same:
        raise AssertionError("--all-devices on one card differs from the plain call")
    return launches


# --- raw serving, host accumulation, fold ensembles (phases 15-17) ---------------------

# the raw CT of phase 15, as stored: (x, y, z) voxels and mm, int16 HU; zero
# outside a field-of-view cylinder
RAW_SHAPE, RAW_SPACING, FOV_RADIUS = (512, 512, 148), (0.68, 0.68, 3.0), 230
RAW_TARGET_SPACING = [3.0, 0.76, 0.76]
CT_PROPERTIES = {"mean": 80.0, "std": 160.0, "median": 60.0, "min": -1000.0, "max": 1500.0,
                 "percentile_00_5": -150.0, "percentile_99_5": 1000.0}
# phase 16 (b): one preprocessed case whose accumulators exceed the budget
HOST_SHAPE = (272, 512, 512)


def synthetic_ct(seed: int) -> np.ndarray:
    """An abdominal CT-like volume (x, y, z) int16: air, a body ellipse of
    soft tissue, seeded organ-like ellipsoids and a bone column, with noise;
    zero outside the field-of-view cylinder (radius ``FOV_RADIUS``)."""
    rng = np.random.default_rng(seed)
    x, y, z = RAW_SHAPE
    xx = np.arange(x, dtype=np.float32)[:, None] - (x - 1) / 2
    yy = np.arange(y, dtype=np.float32)[None, :] - (y - 1) / 2
    body = (xx / 215) ** 2 + (yy / 165) ** 2 <= 1
    vol = np.where(body, np.float32(40), np.float32(-1000))[..., None] + rng.normal(
        0, 20, RAW_SHAPE).astype(np.float32)
    zz = np.arange(z, dtype=np.float32)
    blobs = [(rng.uniform(-110, 110), rng.uniform(-80, 80), rng.uniform(30, z - 30),
              rng.uniform(30, 70), rng.uniform(25, 55), rng.uniform(10, 35),
              rng.uniform(60, 220)) for _ in range(6)]
    blobs.append((0.0, 110.0, z / 2, 22.0, 22.0, 4 * z, 700.0))  # the spine
    for cx, cy, cz, rx, ry, rz, hu in blobs:
        inside = (((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2)[..., None] + (
            ((zz - cz) / rz) ** 2)[None, None] <= 1
        inside &= body[..., None]
        vol[inside] = hu + rng.normal(0, 15, int(inside.sum())).astype(np.float32)
    vol[~(xx ** 2 + yy ** 2 <= FOV_RADIUS ** 2)] = 0
    return vol.astype(np.int16)


class HostPeak:
    """Peak resident memory of this process while the ``with`` block runs: a
    thread samples ``/proc/self/statm`` every 10 ms. Where that file is
    missing, the peak is ``ru_maxrss``, the process's own since it began,
    and ``words`` says so."""

    def __init__(self):
        import threading

        self.bytes, self._stop = 0, threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self.words = "peak host memory"

    @staticmethod
    def _rss() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def _sample(self):
        while not self._stop.wait(0.01):
            self.bytes = max(self.bytes, self._rss())

    def __enter__(self):
        try:
            self.bytes = self._rss()
            self._thread.start()
        except OSError:
            self._thread = None
        return self

    def __exit__(self, *exc):
        if self._thread is not None:
            self._stop.set()
            self._thread.join()
            self.bytes = max(self.bytes, self._rss())
        else:
            import resource

            self.bytes = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
            self.words = "peak host memory (the process's, since it began)"


def run_main(fn, argv) -> str:
    """``fn(argv)`` with its standard output captured, echoed and returned."""
    import io as _io

    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    out = buf.getvalue()
    sys.stdout.write("".join(f"  | {line}\n" for line in out.splitlines()))
    return out


def raw_serving_phase(dev, tmp: str, spec) -> dict:
    """Phase 15: one synthetic 512x512x148 CT through ``predict.main --raw``
    with the flagship (seed-0 weights of phase 5), stage by stage."""
    import shutil

    from nextou_tpu_torch import predict
    from nextou_tpu_torch.data import io as nio
    from nextou_tpu_torch.data.preprocessing import crop_to_nonzero, shape_for_spacing
    from nextou_tpu_torch.infer import raw as raw_mod
    from nextou_tpu_torch.infer.sliding_window import compute_sliding_window_steps
    from nextou_tpu_torch.kernels.conv import conv3d_cuda
    from nextou_tpu_torch.kernels.knn import knn_max_cuda

    config = "3d_fullres_nextou"
    raw_dir, model_dir, out_dir = (os.path.join(tmp, d) for d in ("raw", "raw_model", "raw_out"))
    os.makedirs(raw_dir)
    write_dataset(model_dir, spec, config, 0, None, seed=0)
    with open(os.path.join(model_dir, "nnUNetPlans.json")) as f:
        plans = json.load(f)
    plans["configurations"][config]["spacing"] = RAW_TARGET_SPACING
    plans["transpose_forward"] = plans["transpose_backward"] = [2, 1, 0]
    plans["foreground_intensity_properties_per_channel"] = {"0": CT_PROPERTIES}
    with open(os.path.join(model_dir, "plans.json"), "w") as f:
        json.dump(plans, f)
    shutil.copy(os.path.join(tmp, "model", "checkpoint_final.pth"), model_dir)
    t0 = time.time()
    ct = synthetic_ct(seed=8)
    nio.write_nifti(os.path.join(raw_dir, "ct_000_0000.nii.gz"), ct, spacing=RAW_SPACING)
    print(f"synthetic CT {RAW_SHAPE} int16, spacing {RAW_SPACING} mm, HU in [{ct.min()}, "
          f"{ct.max()}], written as NIfTI (gzip) in {time.time() - t0:.1f} s")

    # the grid the plans ask for, and the tiles and forwards it takes
    cropped = crop_to_nonzero(np.transpose(ct, (2, 1, 0))[None])[0].shape[1:]
    grid = shape_for_spacing(cropped, RAW_SPACING[::-1], RAW_TARGET_SPACING)
    tiles = math.prod(len(s) for s in compute_sliding_window_steps(grid, spec.patch_size))
    forwards = math.ceil(tiles / TILE_BATCH) * (8 // MIRRORS_PER_FORWARD)
    print(f"cropped to {cropped}, resampled to {grid}: {tiles} tiles, {forwards} forwards of "
          f"batch {TILE_BATCH * MIRRORS_PER_FORWARD}")
    assert abs(grid[0] - 148) <= 1 and all(abs(g - 412) <= 3 for g in grid[1:]), grid
    assert (tiles, forwards) == (48, 96), (tiles, forwards)
    del ct

    # each stage timed around raw.py's own functions, inside predict.main
    stages = dict.fromkeys(("read", "crop + normalize", "resample to spacing",
                            "sliding window (card)", "resample back", "argmax + revert",
                            "write"), 0.0)
    saved = {name: getattr(raw_mod, name) for name in (
        "read_image", "crop_to_nonzero", "normalize", "resample_data_or_seg_to_shape",
        "write_nifti", "predict_raw_case")}
    resamples = []

    def timed(stage, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            stages[stage() if callable(stage) else stage] += time.perf_counter() - t
            return out
        return run

    def resample_stage():  # predict_raw_case resamples to the spacing, then back
        resamples.append(None)
        return "resample to spacing" if len(resamples) % 2 else "resample back"

    def case(predictor, *args, **kwargs):
        def card_predictor(x):
            out = predictor(x)
            torch.cuda.synchronize()
            return out

        before = dict(stages)
        t = time.perf_counter()
        out = saved["predict_raw_case"](timed("sliding window (card)", card_predictor),
                                        *args, **kwargs)
        inner = sum(stages[s] - before[s] for s in stages if s not in ("read", "write"))
        stages["argmax + revert"] += time.perf_counter() - t - inner
        return out

    raw_mod.read_image = timed("read", saved["read_image"])
    raw_mod.crop_to_nonzero = timed("crop + normalize", saved["crop_to_nonzero"])
    raw_mod.normalize = timed("crop + normalize", saved["normalize"])
    raw_mod.resample_data_or_seg_to_shape = timed(resample_stage,
                                                  saved["resample_data_or_seg_to_shape"])
    raw_mod.write_nifti = timed("write", saved["write_nifti"])
    raw_mod.predict_raw_case = case
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    knn_max_cuda.launches = conv3d_cuda.launches = 0
    t0 = time.time()
    try:
        with HostPeak() as host_peak:
            log = run_main(predict.main, [model_dir, raw_dir, config, "--raw", "-o", out_dir,
                                          "--tile-batch", str(TILE_BATCH), "--device", str(dev)])
    finally:
        for name, fn in saved.items():
            setattr(raw_mod, name, fn)
    torch.cuda.synchronize()
    total = time.time() - t0
    launches, peak = knn_max_cuda.launches, torch.cuda.max_memory_allocated(dev)
    seg, seg_spacing = nio.read_nifti(os.path.join(out_dir, "ct_000.nii.gz"))
    labels = np.unique(seg)
    print(f"predict.main --raw: 1 CT {RAW_SHAPE}, {total:.2f} s incl. model build and load; "
          f"K1 launches {launches}; peak device memory {peak / 2**30:.2f} GiB, {host_peak.words} "
          f"{host_peak.bytes / 2**30:.2f} GiB; seg {seg.shape} {seg.dtype}, spacing "
          f"{seg_spacing}, labels {labels.tolist()}")
    print("seconds by stage: " + ", ".join(f"{s} {t:.3f}" for s, t in stages.items())
          + f"; sum {sum(stages.values()):.3f}")
    if launches != 14 * forwards or conv3d_cuda.launches:
        raise AssertionError(f"K1 launched {launches} times for {forwards} forwards, "
                             f"K5 {conv3d_cuda.launches}")
    if "(device accumulation)" not in log:
        raise AssertionError("the raw CT did not take the device-accumulation path")
    assert seg.shape == RAW_SHAPE and seg.dtype == np.int16, (seg.shape, seg.dtype)
    assert seg_spacing == tuple(float(np.float32(s)) for s in RAW_SPACING), seg_spacing
    assert labels.min() >= 0 and labels.max() < spec.num_classes
    assert (seg[0] == 0).all() and (seg[:, 0] == 0).all()  # outside the field of view
    return {"launches": launches, "s": total, "stages": stages, "peak_bytes": peak,
            "host_peak_bytes": host_peak.bytes}


def host_accumulation_phase(dev, tmp: str, spec) -> dict:
    """Phase 16: (a) host against device accumulation on phase 5's case;
    (b) a preprocessed 1x272x512x512 case over the budget through
    ``predict.main``."""
    from nextou_tpu_torch import predict
    from nextou_tpu_torch.infer.sliding_window import (
        compute_sliding_window_steps,
        make_tile_predictor,
        sliding_window_predict,
    )
    from nextou_tpu_torch.kernels.knn import knn_max_cuda

    config = "3d_fullres_nextou"
    data_dir, model_dir = os.path.join(tmp, "data"), os.path.join(tmp, "model")
    checkpoint = os.path.join(model_dir, "checkpoint_final.pth")
    plans, _, infer_spec = predict.load_dataset(data_dir, config)
    model = predict.load_model(infer_spec, checkpoint, dev)
    data = next(d for _, d in predict.iter_cases(data_dir, plans, config, ["case_000"]))
    seconds = {}
    torch.cuda.synchronize()
    t0 = time.time()
    want = predict.build_predictor(model, (0, 1, 2), tile_batch=TILE_BATCH)(data)
    seconds["device"] = time.time() - t0
    t0 = time.time()
    got = sliding_window_predict(make_tile_predictor(model, (0, 1, 2)), data, spec.patch_size,
                                 spec.num_classes, device=dev, tile_batch=TILE_BATCH)
    seconds["host"] = time.time() - t0
    off = np.abs(got - want) > 2e-3 + 1e-3 * np.abs(want)
    agree = float(np.mean(np.argmax(got, -1) == np.argmax(want, -1)))
    print(f"host against device accumulation, 1 volume {data.shape[:-1]}, 8-way TTA: max|diff| "
          f"{np.abs(got - want).max():.3g}, {off.mean():.2e} of values outside atol 2e-3/rtol "
          f"1e-3, argmax agreement {agree:.6f}; {seconds['host']:.3f} s on the host path, "
          f"{seconds['device']:.3f} s on the device path")
    if off.mean() > 1e-3 or agree < 0.999:
        raise AssertionError("host accumulation disagrees with device accumulation")
    del model, got, want

    big_dir, out_dir = os.path.join(tmp, "big"), os.path.join(tmp, "big_out")
    write_dataset(big_dir, spec, config, 1, HOST_SHAPE, seed=9)
    vox = math.prod(HOST_SHAPE)
    acc_bytes = vox * (spec.num_classes + 2) * 4
    tiles = math.prod(len(s) for s in compute_sliding_window_steps(HOST_SHAPE, spec.patch_size))
    forwards = math.ceil(tiles / TILE_BATCH)
    print(f"1 case {HOST_SHAPE}: {vox / 1e6:.1f} M voxels, accumulators {acc_bytes / 1e9:.2f} GB "
          f"against a budget of {predict.ACC_BUDGET_BYTES / 1e9:.2f} GB; {tiles} tiles, "
          f"{forwards} forwards of batch {TILE_BATCH} without TTA")
    assert acc_bytes > predict.ACC_BUDGET_BYTES and (tiles, forwards) == (160, 80)

    # the card's share: each tile batch's forwards, timed to a synchronize
    card_s = [0.0]
    make = predict.make_tile_predictor

    def timed_tile_predictor(*args, **kwargs):
        tile_pred = make(*args, **kwargs)

        def run(tiles):
            t = time.perf_counter()
            out = tile_pred(tiles)
            torch.cuda.synchronize()
            card_s[0] += time.perf_counter() - t
            return out
        return run

    predict.make_tile_predictor = timed_tile_predictor
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    knn_max_cuda.launches = 0
    t0 = time.time()
    try:
        with HostPeak() as host_peak:
            log = run_main(predict.main, [model_dir, big_dir, config, "-o", out_dir,
                                          "--disable_tta", "--tile-batch", str(TILE_BATCH),
                                          "--device", str(dev)])
    finally:
        predict.make_tile_predictor = make
    total = time.time() - t0
    launches, peak = knn_max_cuda.launches, torch.cuda.max_memory_allocated(dev)
    with np.load(os.path.join(out_dir, "case_000.npz")) as z:
        seg = z["seg"]
    print(f"predict.main over the budget: {total:.2f} s incl. model build and load and the "
          f"case's load, {card_s[0]:.2f} s of it in the forwards (host share "
          f"{1 - card_s[0] / total:.3f}); K1 launches {launches}; peak device memory "
          f"{peak / 2**30:.2f} GiB, {host_peak.words} {host_peak.bytes / 2**30:.2f} GiB; seg "
          f"{seg.shape} {seg.dtype}, labels {np.unique(seg).tolist()}")
    if "(host accumulation)" not in log:
        raise AssertionError("the case over the budget did not take the host path")
    if launches != 14 * forwards:
        raise AssertionError(f"K1 launched {launches} times for {forwards} forwards")
    assert seg.shape == HOST_SHAPE and seg.max() < spec.num_classes
    return {"launches": launches, "s": total, "card_s": card_s[0], "peak_bytes": peak,
            "host_peak_bytes": host_peak.bytes, "s_device_path": seconds["device"],
            "s_host_path": seconds["host"]}


def fold_ensemble_phase(dev, tmp: str, spec) -> dict:
    """Phase 17: two folds' checkpoints, their ensemble with saved
    probabilities, the ensemble CLI and postprocessing, on phase 5's first
    case (one case keeps the script inside half its time limit)."""
    from nextou_tpu_torch import ensemble, postprocess, predict
    from nextou_tpu_torch.kernels.knn import knn_max_cuda
    from nextou_tpu_torch.models import NexToU
    from nextou_tpu_torch.utils import init_weights

    config = "3d_fullres_nextou"
    data_dir, folds = os.path.join(tmp, "data"), os.path.join(tmp, "folds")
    for fold in (0, 1):
        os.makedirs(os.path.join(folds, f"fold_{fold}"))
        model = init_weights(NexToU(spec, device=dev), seed=fold)
        torch.save({"network_weights": model.state_dict()},
                   os.path.join(folds, f"fold_{fold}", "checkpoint_final.pth"))
    del model
    pp_file = os.path.join(tmp, "postprocessing.json")
    with open(pp_file, "w") as f:
        json.dump({"remove_all_but_largest_component": {
            str(label): True for label in range(1, spec.num_classes)}}, f)
    out = {name: os.path.join(tmp, f"ens_{name}") for name in (
        "f01", "f0", "f1", "pp", "cli", "applied")}
    base = [folds, data_dir, config, "--save-probabilities", "--tile-batch", str(TILE_BATCH),
            "--cases", "case_000", "--device", str(dev)]
    knn_max_cuda.launches = 0
    t0 = time.time()
    seconds = {}
    for name, extra in (("f01", ["-f", "0", "1"]), ("f0", ["-f", "0"]), ("f1", ["-f", "1"]),
                        ("pp", ["-f", "0", "-pp", pp_file])):
        t = time.time()
        log = run_main(predict.main, base + extra + ["-o", out[name]])
        seconds[name] = time.time() - t
        assert log.count("(device accumulation)") == 1, log
    launches = knn_max_cuda.launches
    forwards = 2 * (8 // MIRRORS_PER_FORWARD) * 5  # 2 tile batches, 5 folds' runs
    t = time.time()
    run_main(ensemble.main, [out["f0"], out["f1"], "-o", out["cli"]])
    run_main(postprocess.main, ["apply", out["f0"], "-o", out["applied"], "-pp", pp_file])
    seconds["ensemble + apply"] = time.time() - t
    print(f"fold ensemble, saved probabilities, ensemble and postprocessing CLIs: "
          f"{time.time() - t0:.2f} s (" + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())
          + f"); K1 launches {launches}")
    if launches != 14 * forwards:
        raise AssertionError(f"K1 launched {launches} times for {forwards} forwards")

    def load(name, cid, key="seg"):
        with np.load(os.path.join(out[name], f"{cid}.npz")) as z:
            return z[key]

    for cid in ("case_000",):
        p0, p1, p01 = (load(n, cid, "probabilities").astype(np.float32) for n in ("f0", "f1", "f01"))
        err = float(np.abs(p01 - (p0 + p1) / 2).max())
        seg, cli = load("f01", cid), load("cli", cid)
        top2 = np.sort(p01, -1)[..., -2:]
        off = seg != cli
        gap = float((top2[off, 1] - top2[off, 0]).max()) if off.any() else 0.0
        applied, pp = load("applied", cid), load("pp", cid)
        moved = float(np.mean(applied != load("f0", cid)))
        print(f"{cid}: ensemble probabilities against the mean of the folds' max|diff| {err:.2e}; "
              f"ensemble CLI seg against predict's {off.mean():.2e} of voxels off, their top-2 "
              f"gap at most {gap:.2e}; -pp against postprocess apply equal "
              f"{np.array_equal(pp, applied)} (dtypes {pp.dtype}, {applied.dtype}), "
              f"{moved:.4f} of voxels changed by the postprocessing")
        if err > 1e-3:
            raise AssertionError(f"{cid}: the fold ensemble is not the folds' mean")
        if gap > 1e-3:
            raise AssertionError(f"{cid}: the ensemble CLI differs beyond a float16 near tie")
        if not (np.array_equal(pp, applied) and pp.dtype == applied.dtype):
            raise AssertionError(f"{cid}: predict -pp differs from postprocess apply")
    return {"launches": launches, "s": time.time() - t0}


# --- the networks the plans can name, and the cascade (phases 18-19) -------------------

# The planner's geometry for a BTCV-sized fingerprint (30 CT cases, 512 x 512 in
# plane at 0.59-0.98 mm, 85-198 slices at 2.5-5 mm), from
# nextou_tpu/plans/planner.py::plan_experiment: its 3d_lowres and 3d_fullres
# PlainConvUNets (32 ... 320 features) and the cascade it plans (:408-462); the
# flagship's NexToU overlay (33 ... 324) on 3d_fullres and its cascade stage.
PLAN_BASE = {"batch_size": 2, "normalization_schemes": ["CTNormalization"],
             "use_mask_for_norm": [False], "UNet_class_name": "PlainConvUNet",
             "UNet_base_num_features": 32, "unet_max_num_features": 320,
             "n_conv_per_stage_encoder": [2] * 6, "n_conv_per_stage_decoder": [2] * 5,
             "batch_dice": False}
LOWRES_CFG = {**PLAN_BASE, "patch_size": [96, 160, 160], "spacing": [3.25, 1.62, 1.62],
              "pool_op_kernel_sizes": [[1, 1, 1]] + [[2, 2, 2]] * 4 + [[1, 2, 2]],
              "conv_kernel_sizes": [[3, 3, 3]] * 6, "data_identifier": "nnUNetPlans_3d_lowres",
              "next_stage": "3d_cascade_fullres_nextou"}
FULLRES_CFG = {**PLAN_BASE, "patch_size": [56, 192, 160], "spacing": [2.5, 0.79, 0.79],
               "pool_op_kernel_sizes": [[1, 1, 1], [1, 2, 2], [2, 2, 2], [2, 2, 2], [2, 2, 2],
                                        [1, 2, 2]],
               "conv_kernel_sizes": [[1, 3, 3]] + [[3, 3, 3]] * 5,
               "data_identifier": "nnUNetPlans_3d_fullres"}
# nnU-Net v2's residual-encoder layout on 3d_fullres (residual_encoder_unet_planners.py):
# blocks per encoder stage, one conv per decoder stage
RESENC_CFG = {**FULLRES_CFG, "UNet_class_name": "ResidualEncoderUNet",
              "n_conv_per_stage_encoder": [1, 3, 4, 6, 6, 6], "n_conv_per_stage_decoder": [1] * 5}
NEXTOU_CFG = {"inherits_from": "3d_fullres", "UNet_class_name": "NexToU",
              "patch_size": [64, 224, 192], "UNet_base_num_features": 33,
              "unet_max_num_features": 324,
              "pool_op_kernel_sizes": [[1, 1, 1], [1, 2, 2]] + [[2, 2, 2]] * 4}
CASCADE_CFG = {"inherits_from": "3d_fullres_nextou", "previous_stage": "3d_lowres"}
# the convs K5 takes in the 3d_lowres network (e0a on the one input channel),
# and in the residual encoder: its stage-1 conv1 (name, C, Co, stride, input)
LOWRES_CONVS = [
    ("e0a", 1, 32, (1, 1, 1), (96, 160, 160)), ("e0b", 32, 32, (1, 1, 1), (96, 160, 160)),
    ("e1a", 32, 64, (2, 2, 2), (96, 160, 160)), ("d0a", 64, 32, (1, 1, 1), (96, 160, 160)),
    ("d0b", 32, 32, (1, 1, 1), (96, 160, 160)),
]
RESENC_CONV = ("r1", 32, 64, (1, 2, 2), (56, 192, 160))
# phase 18 (a): two volumes on the lowres grid of a mid-sized BTCV case (2 x 2 x 2
# tiles); phase 19: three cases on the cascade stage's grid (~ 1 x 96 x 320 x 288)
LOWRES_VOLUME, CASCADE_CASES, CASCADE_SHAPE = (112, 192, 192), 3, (96, 320, 288)
CASCADE_EPOCHS, CASCADE_ITERS = 1, 4


def write_plans(folder: str, configurations: dict, cases: int, transpose=None):
    """``nnUNetPlans.json`` with ``configurations``, CT intensity properties
    and (where given) a transpose, and a 14-label ``dataset.json``."""
    os.makedirs(folder, exist_ok=True)
    plans = {"dataset_name": "Dataset999_Smoke", "plans_name": "nnUNetPlans",
             "configurations": configurations,
             "foreground_intensity_properties_per_channel": {"0": CT_PROPERTIES}}
    if transpose is not None:
        plans["transpose_forward"] = plans["transpose_backward"] = list(transpose)
    with open(os.path.join(folder, "nnUNetPlans.json"), "w") as f:
        json.dump(plans, f)
    labels = {"background": 0, **{f"organ{i}": i for i in range(1, 14)}}
    with open(os.path.join(folder, "dataset.json"), "w") as f:
        json.dump({"labels": labels, "numTraining": cases, "channel_names": {"0": "CT"},
                   "file_ending": ".nii.gz"}, f)


def moved_parameters(model, before: dict) -> list:
    """The parameters equal to ``before``; raises on a non-finite one or on
    one that should have moved (phase 7's rule: only a bias under a norm,
    and the zero-weight head's bias, may stay)."""
    may_stay = re.compile(r"\.(conv|fc[12]\.0|nn\.0)\.bias$|^decoder\.seg_layers\.0\.bias$")
    unmoved = []
    for n, p in model.named_parameters():
        if not torch.isfinite(p).all():
            raise AssertionError(f"parameter {n} is not finite")
        if torch.equal(p, before[n]):
            unmoved.append(n)
    if any(not may_stay.search(n) for n in unmoved):
        raise AssertionError(f"parameters that did not move: {unmoved[:5]}")
    return unmoved


def plans_networks_phase(dev, tmp: str) -> dict:
    """Phase 18: (a) the 3d_lowres PlainConvUNet served through
    ``predict.main -tr nnUNetTrainer`` with the conv kernel off and on, and
    K5 at its five convs; (b) the 3d_fullres ResidualEncoderUNet's forward
    and train steps through ``nnUNetTrainer``; (c) the plain Grapher at the
    flagship's bottleneck, card against CPU."""
    from nextou_tpu_torch import predict
    from nextou_tpu_torch.core.pos_embed import relative_pos_bias
    from nextou_tpu_torch.infer.sliding_window import compute_sliding_window_steps
    from nextou_tpu_torch.kernels.conv import conv3d_cuda
    from nextou_tpu_torch.kernels.knn import knn_max_cuda
    from nextou_tpu_torch.models import PlainConvUNet
    from nextou_tpu_torch.models.presets import flagship_3d_spec
    from nextou_tpu_torch.nn.graphers import Grapher
    from nextou_tpu_torch.plans import PlansManager
    from nextou_tpu_torch.train import get_trainer_class
    from nextou_tpu_torch.utils import init_weights

    # (a) the lowres plain U-Net, served
    t_phase = time.time()
    data_dir, model_dir = os.path.join(tmp, "lowres_data"), os.path.join(tmp, "lowres_model")
    write_plans(data_dir, {"3d_lowres": LOWRES_CFG}, 2)
    rng = np.random.default_rng(18)
    for i in range(2):
        np.savez(os.path.join(data_dir, f"case_{i:03d}.npz"),
                 data=rng.standard_normal((1, *LOWRES_VOLUME), dtype=np.float32),
                 seg=np.zeros(LOWRES_VOLUME, np.int16))
    plans, dataset_json, spec = predict.load_dataset(data_dir, "3d_lowres", "nnUNetTrainer")
    if conv_calls(spec) != LOWRES_CONVS or spec.stem_features is not None or any(
            st.gnn for st in spec.encoder):
        raise AssertionError(f"the lowres PlainConvUNet routes {conv_calls(spec)} to K5")
    os.makedirs(model_dir)
    model = init_weights(PlainConvUNet(spec, device=dev), seed=0)
    torch.save({"network_weights": model.state_dict()},
               os.path.join(model_dir, "checkpoint_final.pth"))
    del model
    tiles = math.prod(len(s) for s in compute_sliding_window_steps(LOWRES_VOLUME, spec.patch_size))
    forwards = 2 * math.ceil(tiles / TILE_BATCH) * (8 // MIRRORS_PER_FORWARD)
    k5, segs = 0, {}
    for mode in ("0", "1"):
        out_dir = os.path.join(tmp, f"lowres_out_{mode}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        conv3d_cuda.launches = 0
        t0 = time.time()
        predict.main([model_dir, data_dir, "3d_lowres", "-tr", "nnUNetTrainer", "-o", out_dir,
                      "--tile-batch", str(TILE_BATCH), "--device", str(dev),
                      "--conv-kernel", mode])
        torch.cuda.synchronize()
        main_s, launches = time.time() - t0, conv3d_cuda.launches
        print(f"predict.main -tr nnUNetTrainer 3d_lowres --conv-kernel {mode}: 2 volumes "
              f"{LOWRES_VOLUME}, {tiles} tiles each, {forwards} forwards, {main_s:.2f} s incl. "
              f"model build and load; K5 launches {launches} ({launches / forwards:g} per "
              f"forward); peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        if launches != (len(LOWRES_CONVS) * forwards if mode == "1" else 0):
            raise AssertionError(f"K5 launched {launches} times in {forwards} forwards")
        k5 += launches
        for i in range(2):
            with np.load(os.path.join(out_dir, f"case_{i:03d}.npz")) as z:
                seg = z["seg"]
            if seg.shape != LOWRES_VOLUME or seg.dtype != np.uint8 or seg.max() >= 14:
                raise AssertionError(f"lowres seg {seg.shape} {seg.dtype} max {seg.max()}")
            segs.setdefault(i, []).append(seg)
    same = float(np.mean([np.mean(a == b) for a, b in segs.values()]))
    print(f"the same label with the conv kernel on as off on {same:.4f} of voxels; labels "
          f"{np.unique(segs[0][1]).tolist()}")
    checkpoint = os.path.join(model_dir, "checkpoint_final.pth")
    data = next(d for _, d in predict.iter_cases(data_dir, plans, "3d_lowres", ["case_000"]))
    times = {}
    for mode in ("1", "0"):
        model = predict.load_model(spec, checkpoint, dev, conv_kernel=mode)
        seg_pred = predict.build_predictor(model, (0, 1, 2), tile_batch=TILE_BATCH, output="seg")
        seg_pred(data)  # the library's and the kernel's first calls
        torch.cuda.synchronize()
        t0 = time.time()
        seg_pred(data)
        torch.cuda.synchronize()
        times[mode] = time.time() - t0
        del model, seg_pred
    print(f"3d_lowres seconds per volume (8-way TTA, tile batch {TILE_BATCH}, bf16): "
          f"{times['1']:.3f} with conv_kernel='1', {times['0']:.3f} with '0'")
    gen = torch.Generator(device=dev).manual_seed(41)
    totals = {torch.bfloat16: Totals(), torch.float32: Totals()}
    for name, C, Co, stride, spatial in LOWRES_CONVS:
        for dtype, B in ((torch.bfloat16, TILE_BATCH * MIRRORS_PER_FORWARD), (torch.float32, 1)):
            hold_k5(name, C, Co, stride, spatial, dtype, B, gen, dev, totals[dtype])

    # (b) the residual encoder U-Net through nnUNetTrainer, K5 on
    config = "3d_fullres_resenc"
    res_dir = os.path.join(tmp, "resenc")
    write_plans(res_dir, {config: RESENC_CFG}, 1)
    plans_path = os.path.join(res_dir, "nnUNetPlans.json")
    trainer = get_trainer_class("nnUNetTrainer")(
        plans_path, config, 0, load_json(os.path.join(res_dir, "dataset.json")),
        preprocessed_folder=res_dir, output_folder=os.path.join(res_dir, "out"), device=dev,
        remat=False, conv_kernel="1", device_da=False).initialize()  # steps on a made batch
    rs = trainer.model_spec
    assert PlansManager(plans_path).get_configuration(config).UNet_class_name == \
        "ResidualEncoderUNet"
    if rs.stem_features != RESENC_CFG["UNet_base_num_features"] or not all(
            st.residual for st in rs.encoder) or [
            st.n_conv for st in rs.encoder] != [1, 3, 4, 6, 6, 6]:
        raise AssertionError(f"nnUNetTrainer built {rs}")
    n_params = sum(p.numel() for p in trainer.network.parameters())
    rng = np.random.default_rng(19)
    batch = {"data": rng.standard_normal((TRAIN_BATCH, *rs.patch_size, 1), dtype=np.float32),
             "seg": rng.integers(0, 14, (TRAIN_BATCH, *rs.patch_size))}
    conv3d_cuda.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    trainer.network.eval()
    with torch.no_grad():
        x = torch.from_numpy(batch["data"]).to(dev)
        outs = trainer.network(x)
        torch.cuda.synchronize()
        t0 = time.time()
        outs = trainer.network(x)
        torch.cuda.synchronize()
        fwd_s = time.time() - t0
    if not (len(outs) == 5 and outs[0].shape == (TRAIN_BATCH, *rs.patch_size, 14)
            and all(torch.isfinite(o.float()).all() for o in outs)):
        raise AssertionError("the residual encoder U-Net's forward")
    fwd_k5 = conv3d_cuda.launches
    del outs, x
    before = {n: p.detach().clone() for n, p in trainer.network.named_parameters()}
    conv3d_cuda.launches = 0
    step_s = []
    for i in range(3):
        t0 = time.time()
        trainer.state, metrics = trainer.train_step(trainer.state, batch)
        torch.cuda.synchronize()
        step_s.append(time.time() - t0)
        loss, norm = metrics["loss"].item(), metrics["grad_norm"].item()
        print(f"ResidualEncoderUNet train step {i}: loss {loss:.4f} grad_norm {norm:.4f} "
              f"{step_s[-1]:.3f} s")
        if not (math.isfinite(loss) and math.isfinite(norm)):
            raise AssertionError(f"ResidualEncoderUNet train step {i}: loss {loss}")
    res_k5 = conv3d_cuda.launches
    res_peak = torch.cuda.max_memory_allocated(dev)
    unmoved = moved_parameters(trainer.network, before)
    print(f"ResidualEncoderUNet (3d_fullres {rs.patch_size}, blocks "
          f"{[st.n_conv for st in rs.encoder]}, {n_params / 1e6:.2f} M parameters), batch "
          f"{TRAIN_BATCH}, bf16: forward {fwd_s:.3f} s (K5 {fwd_k5 // 2} launch per forward); "
          f"train steps {', '.join(f'{t:.3f}' for t in step_s)} s (K5 {res_k5} launches); "
          f"{len(unmoved)} of {len(before)} parameter tensors unmoved (biases under a norm); "
          f"peak device memory {res_peak / 2**30:.2f} GiB")
    if fwd_k5 != 2 or res_k5 != 3:
        raise AssertionError(f"K5 launched {fwd_k5} times in 2 forwards, {res_k5} in 3 steps")
    del trainer, before
    torch.cuda.empty_cache()
    for dtype, B in ((torch.bfloat16, TRAIN_BATCH), (torch.float32, 1)):
        hold_k5(*RESENC_CONV[:5], dtype, B, gen, dev, totals[dtype])

    # (c) the plain Grapher over the flagship's bottleneck map, f32, card vs CPU
    bottleneck = flagship_3d_spec().encoder[-1]
    C, sp, k = bottleneck.features, bottleneck.img_shape, bottleneck.gnn[0].k
    n = math.prod(sp)
    out = []
    x = np.random.default_rng(20).standard_normal((TRAIN_BATCH, *sp, C)).astype(np.float32)
    for d in (torch.device("cpu"), dev):
        table = torch.tensor(relative_pos_bias(C, n, n, 3), device=d)[None]
        g = Grapher(C, table, dims=3, k=k, groups=6, norm="instance", device=d)
        init_weights(g, seed=5)
        with torch.no_grad():
            for p in g.parameters():
                if p.dim() >= 2:
                    p.mul_(0.5)
            knn_max_cuda.launches = 0
            out.append(g.eval()(torch.from_numpy(x).to(d)).cpu().numpy())
    grapher_k1 = knn_max_cuda.launches
    want, got = out
    off = np.abs(got - want) > 2e-3 + 1e-3 * np.abs(want)
    print(f"Grapher over the flagship bottleneck ({TRAIN_BATCH} x {sp} x {C}, k {k}, N {n}), "
          f"f32, card vs CPU: max|diff| {np.abs(got - want).max():.3g}, {off.mean():.2e} of "
          f"values outside atol 2e-3/rtol 1e-3; K1 launches {grapher_k1}")
    if grapher_k1 != 1 or off.mean() > 1e-3:
        raise AssertionError("the Grapher on the card disagrees with the CPU or missed K1")
    print(f"phase 18: {time.time() - t_phase:.1f} s")
    return {"k5": k5 + fwd_k5 + res_k5, "k1": grapher_k1, "conv3d": totals[torch.bfloat16],
            "lowres_s_per_volume": times, "resenc_s_per_step": min(step_s[1:]),
            "resenc_peak_bytes": res_peak}


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def cascade_phase(dev, tmp: str) -> dict:
    """Phase 19: the 3d_lowres -> 3d_cascade_fullres_nextou cascade: train the
    lowres stage, predict_next_stage, train the NexToU cascade stage on the
    one-hot channels, and serve it with -prev, preprocessed and raw."""
    from nextou_tpu_torch import predict, predict_next_stage, run_training
    from nextou_tpu_torch.data.dataset import save_case
    from nextou_tpu_torch.data.io import read_image, write_nifti
    from nextou_tpu_torch.data.resampling import resample_data_or_seg_to_shape
    from nextou_tpu_torch.infer.sliding_window import compute_sliding_window_steps
    from nextou_tpu_torch.kernels.conv import conv3d_cuda
    from nextou_tpu_torch.kernels.knn import knn_max_bwd_cuda, knn_max_cuda, knn_max_idx_cuda
    from nextou_tpu_torch.plans import PlansManager

    t_phase = time.time()
    folder = os.path.join(tmp, "cascade")
    config = "3d_cascade_fullres_nextou"
    write_plans(folder, {"3d_lowres": LOWRES_CFG, "3d_fullres": FULLRES_CFG,
                         "3d_fullres_nextou": NEXTOU_CFG, config: CASCADE_CFG},
                CASCADE_CASES, transpose=(2, 1, 0))
    plans = PlansManager(os.path.join(folder, "nnUNetPlans.json"))
    low, full = plans.get_configuration("3d_lowres"), plans.get_configuration(config)
    low_shape = tuple(round(n * a / b) for n, a, b in zip(CASCADE_SHAPE, full.spacing,
                                                          low.spacing))
    rng = np.random.default_rng(19)
    cases = []
    for i in range(CASCADE_CASES):
        cid = f"case_{i:03d}"
        data, seg = labelled_case(rng, CASCADE_SHAPE, 14)
        save_case(os.path.join(folder, full.data_identifier), cid, data[None], seg)
        data_low = resample_data_or_seg_to_shape(data[None], low_shape, full.spacing, low.spacing,
                                                 is_seg=False, **low.resampling_fn_data_kwargs)
        seg_low = resample_data_or_seg_to_shape(seg, low_shape, full.spacing, low.spacing,
                                                is_seg=True, **low.resampling_fn_seg_kwargs)
        save_case(os.path.join(folder, low.data_identifier), cid, data_low, seg_low)
        cases.append((cid, data))
    print(f"{CASCADE_CASES} labelled cases {CASCADE_SHAPE} and their lowres copies {low_shape} "
          f"(resampled from {full.spacing} to {low.spacing} mm) written in "
          f"{time.time() - t_phase:.1f} s")

    counters = (knn_max_cuda, knn_max_idx_cuda, knn_max_bwd_cuda, conv3d_cuda)
    for counter in counters:
        counter.launches = 0
    t0 = time.time()
    lowres = run_training.main([folder, "3d_lowres", "0", "-tr", "nnUNetTrainer", "--epochs",
                                str(CASCADE_EPOCHS), "--iters", str(CASCADE_ITERS),
                                "--device", str(dev)])
    torch.cuda.synchronize()
    low_s = time.time() - t0
    if any(c.launches for c in counters) or not math.isfinite(lowres.log_history[0]["train_loss"]):
        raise AssertionError("the lowres stage launched a kNN or conv kernel, or its loss")
    e = lowres.log_history[0]
    print(f"run_training -tr nnUNetTrainer 3d_lowres: {low_s:.2f} s incl. model build and the "
          f"final validation; train {e['train_time_s'] / CASCADE_ITERS:.3f} s per iteration, "
          f"loss {e['train_loss']:.4f}, waiting for the loader {e['loader_wait_s']:.2f} s")

    t0 = time.time()
    prev_dir = predict_next_stage.main([folder, lowres.output_folder, "-c", "3d_lowres",
                                        "--next", config, "-tr", "nnUNetTrainer",
                                        "--device", str(dev)])
    torch.cuda.synchronize()
    for cid, _ in cases:
        with np.load(os.path.join(prev_dir, f"{cid}.npz")) as z:
            seg = z["seg"]
        if seg.shape != CASCADE_SHAPE or seg.dtype != np.int16 or seg.max() >= 14:
            raise AssertionError(f"predict_next_stage {cid}: {seg.shape} {seg.dtype}")
    print(f"predict_next_stage: {CASCADE_CASES} cases in {time.time() - t0:.2f} s, segs on the "
          f"cascade stage's grid {CASCADE_SHAPE}")

    for counter in counters:
        counter.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    trainer = run_training.main([folder, config, "0", "-tr", "nnUNetTrainer_NexToU",
                                 "--epochs", str(CASCADE_EPOCHS), "--iters", str(CASCADE_ITERS),
                                 "--device", str(dev)])
    torch.cuda.synchronize()
    main_s = time.time() - t0
    k1, k3, k4, k5 = (c.launches for c in counters)
    peak = torch.cuda.max_memory_allocated(dev)
    _, val = trainer.get_split()
    tiles = math.prod(len(s) for s in compute_sliding_window_steps(CASCADE_SHAPE,
                                                                   trainer.model_spec.patch_size))
    fwd_case = math.ceil(tiles / TILE_BATCH) * (8 // MIRRORS_PER_FORWARD)
    steps = CASCADE_EPOCHS * CASCADE_ITERS
    evals = CASCADE_EPOCHS * trainer.num_val_iterations_per_epoch
    e = trainer.log_history[-1]
    print(f"run_training -tr nnUNetTrainer_NexToU {config}: in-channels "
          f"{trainer.model_spec.in_channels}, remat {trainer.remat!r}, {main_s:.2f} s incl. model "
          f"build, {evals} eval steps and the validation of {len(val.case_ids)} case(s); train "
          f"{e['train_time_s'] / CASCADE_ITERS:.3f} s per iteration, loss {e['train_loss']:.4f}, "
          f"waiting for the loader {e['loader_wait_s']:.2f} s; K3 {k3}, K4 {k4}, K1 {k1}, K5 {k5} "
          f"launches; peak device memory {peak / 2**30:.2f} GiB")
    if trainer.model_spec.in_channels != 14 or trainer.remat is not False:
        raise AssertionError("the cascade stage's network or remat choice")
    if (k3, k4, k1, k5) != (14 * steps, 14 * steps,
                            14 * (evals + len(val.case_ids) * fwd_case), 0):
        raise AssertionError(f"cascade trainer launches: K3 {k3} K4 {k4} K1 {k1} K5 {k5}")
    if not (math.isfinite(e["train_loss"]) and math.isfinite(e["val_loss"])):
        raise AssertionError("the cascade stage's losses")
    out = trainer.output_folder

    # serve the cascade stage with -prev: a preprocessed case, then a raw NIfTI one
    cid = val.case_ids[0]
    knn_max_cuda.launches = 0
    t0 = time.time()
    predict.main([out, folder, config, "-tr", "nnUNetTrainer_NexToU", "-prev", prev_dir,
                  "-o", os.path.join(tmp, "cascade_pred"), "--cases", cid,
                  "--tile-batch", str(TILE_BATCH), "--device", str(dev)])
    torch.cuda.synchronize()
    pre_s, pre_k1 = time.time() - t0, knn_max_cuda.launches
    with np.load(os.path.join(tmp, "cascade_pred", f"{cid}.npz")) as z:
        seg = z["seg"]
    with np.load(os.path.join(out, "validation", f"{cid}.npz")) as z:
        agree = float(np.mean(seg == z["seg"]))
    print(f"predict.main -prev {cid}: {pre_s:.2f} s incl. model build, K1 {pre_k1} launches "
          f"({fwd_case} forwards), labels {np.unique(seg).tolist()}, the trainer's validation "
          f"label on {agree:.6f} of voxels")
    if pre_k1 != 14 * fwd_case or seg.shape != CASCADE_SHAPE or seg.max() >= 14 or agree < 0.99:
        raise AssertionError(f"predict -prev {cid}")

    # the raw case: the same case's central patch-wide crop as CT HU, (x, y, z),
    # and its previous-stage seg cropped alike
    raw_dir, raw_prev = os.path.join(tmp, "cascade_raw"), os.path.join(tmp, "cascade_raw_prev")
    os.makedirs(raw_dir)
    os.makedirs(raw_prev)
    crop = (slice(None), *(slice((n - p) // 2, (n - p) // 2 + p) for n, p in
                           zip(CASCADE_SHAPE[1:], trainer.model_spec.patch_size[1:])))
    hu = np.transpose(np.round(dict(cases)[cid][crop] * 300 + 60), (2, 1, 0)).astype(np.int16)
    write_nifti(os.path.join(raw_dir, f"{cid}_0000.nii.gz"), hu,
                spacing=tuple(full.spacing[::-1]))
    with np.load(os.path.join(prev_dir, f"{cid}.npz")) as z:
        np.savez(os.path.join(raw_prev, f"{cid}.npz"), seg=z["seg"][crop])
    raw_tiles = math.prod(len(s) for s in compute_sliding_window_steps(
        hu.shape[::-1], trainer.model_spec.patch_size))
    raw_fwd = math.ceil(raw_tiles / TILE_BATCH) * (8 // MIRRORS_PER_FORWARD)
    knn_max_cuda.launches = 0
    t0 = time.time()
    predict.main([out, raw_dir, config, "--raw", "-tr", "nnUNetTrainer_NexToU", "-prev",
                  raw_prev, "-o", os.path.join(tmp, "cascade_raw_out"),
                  "--tile-batch", str(TILE_BATCH), "--device", str(dev)])
    torch.cuda.synchronize()
    raw_s, raw_k1 = time.time() - t0, knn_max_cuda.launches
    seg, spacing = read_image(os.path.join(tmp, "cascade_raw_out", f"{cid}.nii.gz"))
    print(f"predict.main --raw -prev {cid} (cropped to {hu.shape[::-1]}): {raw_s:.2f} s, K1 "
          f"{raw_k1} launches ({raw_fwd} forwards), NIfTI {seg.shape} {seg.dtype} at "
          f"{tuple(round(s, 3) for s in spacing)} mm, labels {np.unique(seg).tolist()}")
    if raw_k1 != 14 * raw_fwd or seg.shape != hu.shape or seg.max() >= 14 or seg.min() < 0:
        raise AssertionError(f"predict --raw -prev {cid}")
    print(f"phase 19: {time.time() - t_phase:.1f} s")
    return {"k1": k1 + pre_k1 + raw_k1, "k3": k3, "k4": k4,
            "s_per_iter": e["train_time_s"] / CASCADE_ITERS, "peak_bytes": peak}


# --- from a raw dataset to a served model (phase 22) -----------------------------------

# five labelled CT cases and one test case, stored as (96, 320, 288) at (0.6, 0.297,
# 0.297) mm: the planner's flagship geometry (upstream's BTCV plan) from a fingerprint
# small enough for this script
DS_CASES, DS_SHAPE, DS_SPACING, DS_ITERS = 5, (96, 320, 288), (0.6, 0.297, 0.297), 4
DS_CONFIG = "3d_fullres_nextou"


def write_raw_ct(folder: str, seed: int) -> list:
    """nnU-Net's raw layout: ``imagesTr``/``labelsTr`` of ``DS_CASES`` cases
    and one case in ``imagesTs``, int16 HU with background -1000 (so cropping
    keeps the whole volume), every label present, written in parallel by
    the port's ``write_nifti`` (gzip level 9, as the reference's)."""
    from concurrent.futures import ThreadPoolExecutor

    from nextou_tpu_torch.data.io import write_nifti

    rng = np.random.default_rng(seed)
    jobs = []
    for i in range(DS_CASES + 1):
        _, seg = labelled_case(rng, DS_SHAPE, 14)
        hu = np.where(seg == 0, -1000, seg.astype(np.int32) * 40 + 20)
        hu = np.round(hu + rng.normal(0, 20, DS_SHAPE)).astype(np.int16)
        cid = f"case_{i:03d}"
        images = "imagesTr" if i < DS_CASES else "imagesTs"
        jobs.append((os.path.join(folder, images, f"{cid}_0000.nii.gz"), hu))
        if i < DS_CASES:
            jobs.append((os.path.join(folder, "labelsTr", f"{cid}.nii.gz"), seg))
    for sub in ("imagesTr", "labelsTr", "imagesTs"):
        os.makedirs(os.path.join(folder, sub), exist_ok=True)
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        for f in [ex.submit(write_nifti, path, arr, spacing=DS_SPACING) for path, arr in jobs]:
            f.result()
    with open(os.path.join(folder, "dataset.json"), "w") as f:
        json.dump({"name": "Dataset022_RawCT", "channel_names": {"0": "CT"},
                   "labels": {"background": 0, **{f"organ{i}": i for i in range(1, 14)}},
                   "numTraining": DS_CASES, "file_ending": ".nii.gz"}, f)
    return jobs


def check_flagship_plan(plans: dict, spec) -> None:
    """The planned 3d_fullres and its NexToU overlay are the BTCV plan's, and
    the trainer's network spec of the overlay is the flagship's."""
    from nextou_tpu_torch.models.presets import flagship_3d_spec

    cfgs = plans["configurations"]
    fr, ov = cfgs["3d_fullres"], cfgs[DS_CONFIG]
    print(f"plans: 3d_fullres patch {fr['patch_size']} batch {fr['batch_size']}, "
          f"{DS_CONFIG} patch {ov.get('patch_size')} features "
          f"{ov.get('UNet_base_num_features')}/{ov.get('unet_max_num_features')}; "
          f"configurations {list(cfgs)}")
    if (fr["patch_size"], fr["batch_size"]) != ([64, 192, 160], 2) or (
            ov.get("patch_size"), ov.get("UNet_base_num_features"),
            ov.get("unet_max_num_features")) != ([64, 224, 192], 33, 324):
        raise AssertionError("the planner did not plan the flagship")
    got, want = dataclasses.asdict(spec), dataclasses.asdict(flagship_3d_spec())
    differ = sorted(k for k in want if got.get(k) != want[k])
    print(f"the trainer's spec of the planned {DS_CONFIG} against "
          f"presets.flagship_3d_spec(): {'equal' if not differ else 'fields ' + str(differ)}")
    if differ:
        raise AssertionError(f"planned spec differs from the flagship in {differ}")


@contextlib.contextmanager
def timing(module, names, seconds: dict, prefix: str = ""):
    """While the block runs, each of ``module``'s functions ``names`` adds its
    seconds to ``seconds[prefix + name]``; the originals come back after."""
    originals = {name: getattr(module, name) for name in names}

    def timed(key, fn):
        def run(*args, **kwargs):
            t = time.time()
            try:
                return fn(*args, **kwargs)
            finally:
                seconds[key] = seconds.get(key, 0.0) + time.time() - t
        return run

    for name, fn in originals.items():
        setattr(module, name, timed(prefix + name, fn))
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(module, name, fn)


def expect_launches(what: str, got: tuple, want: tuple) -> None:
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def pipeline_phase(dev, tmp: str, trained: dict) -> dict:
    """Phase 22: a raw NIfTI dataset to a served model with the port alone:
    integrity, fingerprint, plans and preprocessing, training the planned
    flagship, find_best_configuration, raw serving, and an upstream-layout
    checkpoint imported and served bit-equal."""
    from nextou_tpu_torch import (
        find_best_configuration,
        import_torch_checkpoint,
        plan_and_preprocess,
        predict,
        run_training,
    )
    from nextou_tpu_torch.data.io import read_image
    from nextou_tpu_torch.infer import raw as raw_mod
    from nextou_tpu_torch.infer.sliding_window import compute_sliding_window_steps
    from nextou_tpu_torch.kernels.conv import conv3d_cuda
    from nextou_tpu_torch.kernels.knn import knn_max_bwd_cuda, knn_max_cuda, knn_max_idx_cuda
    from nextou_tpu_torch.plans import load_dataset_json
    from nextou_tpu_torch.train import get_trainer_class

    t_phase = time.time()
    seconds = {}
    raw, pre = os.path.join(tmp, "Dataset022_RawCT"), os.path.join(tmp, "preprocessed")
    t0 = time.time()
    write_raw_ct(raw, seed=22)
    seconds["write raw"] = time.time() - t0
    print(f"(a) {DS_CASES} labelled CT cases and 1 test case {DS_SHAPE} at {DS_SPACING} mm, "
          f"14 labels, written as .nii.gz in {seconds['write raw']:.2f} s")

    # (b) the CLI, its stages timed around the module's own functions
    with timing(plan_and_preprocess, ("verify_dataset_integrity", "extract_fingerprint",
                                      "plan_experiment", "preprocess_dataset"), seconds):
        t0 = time.time()
        out = run_main(plan_and_preprocess.main, [raw, "-o", pre, "--verify_dataset_integrity",
                                                  "-c", "3d_fullres"])
        seconds["plan_and_preprocess"] = time.time() - t0
    if "dataset integrity OK" not in out:
        raise AssertionError("the integrity check did not pass")
    plans = load_json(os.path.join(pre, "nnUNetPlans.json"))
    dataset_json = load_dataset_json(pre)
    spec = get_trainer_class("nnUNetTrainer_NexToU")(
        plans, DS_CONFIG, 0, dataset_json, device=dev).build_network_spec()
    check_flagship_plan(plans, spec)
    ident = plans["configurations"]["3d_fullres"]["data_identifier"]
    cases = sorted(f for f in os.listdir(os.path.join(pre, ident)) if f.endswith(".npz"))
    if len(cases) != DS_CASES:
        raise AssertionError(f"{len(cases)} preprocessed cases in {ident}")
    print(f"(b) plan_and_preprocess.main: {seconds['plan_and_preprocess']:.2f} s: integrity "
          f"{seconds['verify_dataset_integrity']:.2f}, fingerprint "
          f"{seconds['extract_fingerprint']:.2f}, planning {seconds['plan_experiment']:.3f}, "
          f"preprocessing {seconds['preprocess_dataset']:.2f} s ({len(cases)} cases in {ident}/)")

    # (c) the planned flagship on the card
    counters = (knn_max_cuda, knn_max_idx_cuda, knn_max_bwd_cuda, conv3d_cuda)
    for counter in counters:
        counter.launches = 0
    t0 = time.time()
    trainer = run_training.main([pre, DS_CONFIG, "0", "-tr", "nnUNetTrainer_NexToU",
                                 "--epochs", "1", "--iters", str(DS_ITERS),
                                 "--device", str(dev)])
    torch.cuda.synchronize()
    seconds["run_training"] = time.time() - t0
    k1, k3, k4, k5 = (c.launches for c in counters)
    _, val = trainer.get_split()
    tiles = math.prod(len(s) for s in compute_sliding_window_steps(DS_SHAPE, spec.patch_size))
    fwd_case = math.ceil(tiles / TILE_BATCH) * (8 // MIRRORS_PER_FORWARD)
    evals = trainer.num_val_iterations_per_epoch
    e = trainer.log_history[-1]
    per_iter = e["train_time_s"] / DS_ITERS
    ref = trained["log"]
    print(f"(c) run_training.main {DS_CONFIG}, 1 epoch x {DS_ITERS}, {evals} eval steps, "
          f"validation of {len(val.case_ids)} case(s) ({len(val.case_ids) * fwd_case} forwards): "
          f"{seconds['run_training']:.2f} s incl. model build; loss {e['train_loss']:.4f} val "
          f"{e['val_loss']:.4f}; {per_iter:.3f} s per iteration (phase 14: "
          f"{ref[0]['train_time_s'] / ITERS:.3f} in epoch 0, {trained['s_per_iter']:.3f} in "
          f"epoch 1); K3 {k3}, K4 {k4}, K1 {k1}, K5 {k5} launches")
    expect_launches("the trainer (K3, K4, K1, K5)", (k3, k4, k1, k5),
                    (14 * DS_ITERS, 14 * DS_ITERS,
                     14 * (evals + len(val.case_ids) * fwd_case), 0))
    if not (math.isfinite(e["train_loss"]) and math.isfinite(e["val_loss"])):
        raise AssertionError("phase 22's losses")
    run = trainer.output_folder
    for name in ("checkpoint_final.pth", "validation/summary.json"):
        if not os.path.exists(os.path.join(run, name)):
            raise AssertionError(f"the trainer wrote no {name}")
    dice = load_json(os.path.join(run, "validation", "summary.json"))["foreground_mean"]["Dice"]

    # (d) find_best_configuration names the run
    t0 = time.time()
    info_path = os.path.join(tmp, "inference_information.json")
    run_main(find_best_configuration.main, [run, "-o", info_path])
    seconds["find_best_configuration"] = time.time() - t0
    info = load_json(info_path)
    print(f"(d) find_best_configuration.main: best {info['best_configuration']!r}, fg mean Dice "
          f"{info['best_fg_mean_dice']!r} (summary.json: {dice!r}); "
          f"{seconds['find_best_configuration']:.2f} s")
    if info["best_configuration"] != os.path.basename(run) or info["best_fg_mean_dice"] != dice:
        raise AssertionError("find_best_configuration did not name the run")

    # (e) the test case through predict --raw, and (f) the same from an imported
    # upstream-layout checkpoint
    test_dir = os.path.join(raw, "imagesTs")
    ckpt = torch.load(os.path.join(run, "checkpoint_final.pth"), map_location="cpu",
                      weights_only=True)
    upstream = os.path.join(tmp, "upstream_checkpoint_final.pth")
    torch.save({"network_weights": {f"module._orig_mod.{k}": v
                                    for k, v in ckpt["network_weights"].items()},
                "current_epoch": 1}, upstream)
    t0 = time.time()
    imported = os.path.join(tmp, "imported")
    import_torch_checkpoint.main([upstream, pre, DS_CONFIG, "-o", imported,
                                  "--device", str(dev)])
    seconds["import_torch_checkpoint"] = time.time() - t0
    segs, k1_serve = {}, 0
    for step, model in (("e", run), ("f", imported)):
        knn_max_cuda.launches = 0
        out_dir = os.path.join(tmp, f"served_{step}")
        t0 = time.time()
        with timing(raw_mod, ("read_image", "resample_data_or_seg_to_shape", "write_nifti"),
                    seconds, prefix=f"{step} "):
            predict.main([model, test_dir, DS_CONFIG, "--raw", "-o", out_dir,
                          "--tile-batch", str(TILE_BATCH), "--device", str(dev)])
        torch.cuda.synchronize()
        seconds[f"predict {step}"] = time.time() - t0
        k1_serve += knn_max_cuda.launches
        seg, sp = read_image(os.path.join(out_dir, f"case_{DS_CASES:03d}.nii.gz"))
        segs[step] = seg
        print(f"({step}) predict.main --raw from {os.path.basename(model)}: "
              f"{seconds[f'predict {step}']:.2f} s per volume incl. model build (reading "
              f"{seconds[f'{step} read_image']:.2f}, resampling "
              f"{seconds[f'{step} resample_data_or_seg_to_shape']:.2f}, writing the NIfTI "
              f"{seconds[f'{step} write_nifti']:.2f} s), K1 "
              f"{knn_max_cuda.launches} launches ({fwd_case} forwards), NIfTI {seg.shape} "
              f"{seg.dtype} at {tuple(round(s, 3) for s in sp)} mm, labels "
              f"{np.unique(seg).tolist()}")
        expect_launches(f"predict ({step}), K1", (knn_max_cuda.launches,), (14 * fwd_case,))
        if seg.shape != DS_SHAPE or seg.min() < 0 or seg.max() >= 14:
            raise AssertionError(f"the served seg ({step})")
    same = bool(np.array_equal(segs["e"], segs["f"]))
    print(f"(f) import_torch_checkpoint.main {seconds['import_torch_checkpoint']:.2f} s; the "
          f"imported folder's seg bit-equal to the run's: {same}")
    if not same:
        raise AssertionError("the imported checkpoint serves another seg")
    print(f"phase 22: {time.time() - t_phase:.1f} s")
    return {"k1": k1 + k1_serve, "k3": k3, "k4": k4, "s_per_iter": per_iter,
            "seconds": seconds}


# --- training over a run (phase 23) ----------------------------------------------------

# (a) the small dilated network's run: a synthetic 3D dataset whose plans give
# small_train_spec's (8, 16, 16) patch, the trainer's host-DA batches, 10 steps
# with Dice + CE and 10 with the RAVIR BTI loss (exclusion [[1, 2]])
RUN_PLANS = {
    "dataset_name": "Dataset023_Run", "plans_name": "nnUNetPlans",
    "configurations": {"3d_tiny": {
        "batch_size": 2, "patch_size": [8, 16, 16], "spacing": [1.0, 1.0, 1.0],
        "normalization_schemes": ["ZScoreNormalization"], "use_mask_for_norm": [False],
        "UNet_class_name": "PlainConvUNet", "UNet_base_num_features": 4,
        "unet_max_num_features": 6, "n_conv_per_stage_encoder": [2] * 5,
        "n_conv_per_stage_decoder": [2] * 4,
        "pool_op_kernel_sizes": [[1, 1, 1], [2, 2, 2], [2, 2, 2], [1, 1, 1], [1, 1, 1]],
        "conv_kernel_sizes": [[3, 3, 3]] * 5, "batch_dice": True,
    }},
}
RUN_DATASET_JSON = {"labels": {"background": 0, "a": 1, "b": 2}, "numTraining": 6,
                    "channel_names": {"0": "img"}}
RUN_STEPS, RUN_BTI_FROM = 20, 10
# per step, card against CPU: loss, gradient norm (relative), update (L2
# share of the CPU's), TI term (relative); small_train_phase's and the TI term's
RUN_WIDTHS = {"loss": 1e-4, "grad_norm": 2e-2, "update": 0.1, "ti": 1e-3}
# a step beyond a width passes only where the card's result lies within the
# widths of the CPU's step from the same state with the parameters scaled by
# one of these (a near tie that a one-ulp change flips the card's way), at no
# more than RUN_WITNESS_STEPS of the 40 steps (predicted: 0-4)
RUN_WITNESS_EPS = (1e-7, -1e-7, 1e-6, -1e-6)
RUN_WITNESS_STEPS = 4
# (3, 3, 3) convs of small_train_spec: 11 per step routed to K5 with
# conv_kernel="1" and the region widened to each of them
RUN_K5_PER_STEP = 11
# (b) the flagship through run_training.main with the BTI Synapse trainer on
# phase 14's cases (a validation case of 64 x 280 x 240: its HD95 costs half of
# a 96 x 320 x 288 case's)
RUN_TRAINER = "nnUNetTrainer_NexToU_BTI_Synapse"
RUN_EPOCHS, RUN_ITERS, RUN_EVAL_STEPS = 3, 50, 10


def run_batches(tmp: str):
    """The port trainer's host-DA batches (one loader thread) of a synthetic
    3D dataset, and the loss specs of the plain and the RAVIR BTI trainer."""
    from nextou_tpu_torch.data import make_synthetic_dataset
    from nextou_tpu_torch.train import get_trainer_class

    folder = os.path.join(tmp, "run_data")
    make_synthetic_dataset(folder, n_cases=6, shape=(16, 32, 32), num_classes=3)
    trainers = [get_trainer_class(name)(
        RUN_PLANS, "3d_tiny", 0, RUN_DATASET_JSON, preprocessed_folder=folder,
        output_folder=os.path.join(tmp, "run_out"), device="cpu", device_da=False,
        loader_threads=1) for name in ("nnUNetTrainer_NexToU", "nnUNetTrainer_NexToU_BTI_RAVIR")]
    loader, _ = trainers[0].get_dataloaders()
    with loader:
        it = iter(loader)
        batches = [next(it) for _ in range(RUN_STEPS)]
    return batches, [t._loss_spec() for t in trainers]


def run_small_phase(dev, tmp: str) -> dict:
    """Phase 23 (a): 20 train steps of the small dilated network in f32 on the
    card (K2, K3, K4; and K5 at every (3, 3, 3) conv with conv_kernel="1")
    against the same steps on the CPU (plain versions), on the trainer's
    host-DA batches, 10 with Dice + CE and 10 with the BTI loss, once per
    conv_kernel. The card is set to the CPU's state after each step
    (small_train_phase's protocol). Per step: the loss, the gradient norm,
    the update and, in the BTI steps, the TI term alone (each model's logits
    through the deep-supervised TI loss, without its lambda of 1e-6) within
    ``RUN_WIDTHS`` of the CPU's. Where a step lands on a near tie (a kNN
    selection, or a max whose gradient is discontinuous there), the CPU
    runs it again from its state with the parameters scaled by each of
    ``RUN_WITNESS_EPS``: the card's result must then lie within the same
    widths of one of those, at no more than ``RUN_WITNESS_STEPS`` of the 40
    steps. Launches exact: K2 2, K3 and K4 12 per step, K5
    ``RUN_K5_PER_STEP`` with "1" and none with "0"."""
    from unittest import mock

    from nextou_tpu_torch.kernels.conv import conv3d_cuda, every_333_conv
    from nextou_tpu_torch.kernels.knn import knn_indices_cuda, knn_max_bwd_cuda, knn_max_idx_cuda
    from nextou_tpu_torch.losses import deep_supervised_loss, deep_supervision_weights, ti_loss
    from nextou_tpu_torch.models import NexToU
    from nextou_tpu_torch.nn import conv_blocks
    from nextou_tpu_torch.train import create_train_state, make_optimizer, make_train_step, poly_lr

    t_phase = time.time()
    spec = small_train_spec()
    batches, (dc_ce, bti) = run_batches(tmp)
    weights = deep_supervision_weights(len(spec.decoder))
    # the poly rate per "epoch" of 10 steps over two epochs: 1e-2, then 5.4e-3
    opt = make_optimizer(poly_lr(1e-2, 2, 0.9, steps_per_epoch=RUN_BTI_FROM))
    cpu = torch.device("cpu")
    counters = (knn_indices_cuda, knn_max_idx_cuda, knn_max_bwd_cuda, conv3d_cuda)

    def flat(model):
        return torch.cat([p.detach().cpu().flatten() for p in model.parameters()])

    def distances(a, b):
        return {"loss": abs(a[0] - b[0]) / abs(b[0]),
                "grad_norm": abs(a[1] - b[1]) / abs(b[1]),
                "update": ((a[2] - b[2]).norm() / b[2].norm()).item(),
                "ti": 0.0 if b[3] is None else abs(a[3] - b[3]) / abs(b[3])}

    out = {"k2": 0, "k3": 0, "k4": 0, "k5": 0, "worst": {}}
    witnessed = 0
    for mode in ("0", "1"):
        region = (mock.patch.object(conv_blocks, "conv_kernel_wins", every_333_conv)
                  if mode == "1" else contextlib.nullcontext())
        with region:
            states, steps, logits = {}, {}, {}
            for kind, d in (("cuda", dev), ("cpu", cpu), ("witness", cpu)):
                model = NexToU(spec, conv_kernel=mode, device=d)
                states[kind] = create_train_state(model, opt, seed=23)
                model.register_forward_hook(
                    lambda m, a, o, kind=kind: logits.__setitem__(kind, [t.detach() for t in o]))
                steps[kind] = [make_train_step(model, opt, s, weights) for s in (dc_ce, bti)]
            for counter in counters:
                counter.launches = 0
            worst = dict.fromkeys(RUN_WIDTHS, 0.0)

            def run_step(kind, leg, batch, start):
                states[kind], m = steps[kind][leg](states[kind], batch)
                ti = None
                if leg:
                    seg = torch.as_tensor(batch["seg"]).long().to(logits[kind][0].device)
                    ti = deep_supervised_loss(
                        logits[kind], seg, lambda o, t: ti_loss(o, t, bti.ti), weights).item()
                return m["loss"].item(), m["grad_norm"].item(), flat(states[kind].model) - start, ti

            for i, batch in enumerate(batches):
                leg = int(i >= RUN_BTI_FROM)
                before = {k: {n: t.clone() for n, t in v.items()} if isinstance(v, dict)
                          else v.clone() if torch.is_tensor(v) else v
                          for k, v in states["cpu"].state_dict().items()}
                start = flat(states["cpu"].model)
                assert torch.equal(start, flat(states["cuda"].model))
                got = {kind: run_step(kind, leg, batch, start) for kind in ("cuda", "cpu")}
                off = distances(got["cuda"], got["cpu"])
                note = ""
                if any(off[k] > w for k, w in RUN_WIDTHS.items()):
                    witnessed += 1
                    seen = []
                    for eps in RUN_WITNESS_EPS:
                        states["witness"].load_state_dict(before)
                        with torch.no_grad():
                            for p in states["witness"].model.parameters():
                                p.mul_(1 + eps)
                        result = run_step("witness", leg, batch, start * (1 + eps))
                        seen.append((eps, distances(got["cuda"], result),
                                     distances(result, got["cpu"])))
                    eps, match, moved = min(seen, key=lambda e: max(
                        e[1][k] / w for k, w in RUN_WIDTHS.items()))
                    note = (f" (beyond a width: the CPU at 1 {eps:+.0e} moves by " + ", ".join(
                        f"{k} {moved[k]:.2e}" for k in RUN_WIDTHS) + "; the card from it "
                        + ", ".join(f"{k} {match[k]:.2e}" for k in RUN_WIDTHS) + ")")
                    if any(match[k] > w for k, w in RUN_WIDTHS.items()):
                        raise AssertionError(
                            f"phase 23 (a) conv_kernel={mode!r} step {i}: off by {off}, and "
                            f"beyond the widths of each one-ulp CPU step: {seen}")
                    if witnessed > RUN_WITNESS_STEPS:
                        raise AssertionError(
                            f"phase 23 (a): {witnessed} steps beyond a width (at most "
                            f"{RUN_WITNESS_STEPS} of {2 * RUN_STEPS})")
                (gl, gn, _, gt), (wl, wn, _, wt) = got["cuda"], got["cpu"]
                print(f"(a) conv_kernel={mode!r} step {i} ({'BTI' if leg else 'Dice + CE'}): loss "
                      f"{gl:.6f} vs {wl:.6f}, grad_norm {gn:.4f} vs {wn:.4f}, update off "
                      f"{off['update']:.2e}" + (f", TI term {gt:.4f} vs {wt:.4f}" if leg else "")
                      + note)
                worst = {k: max(worst[k], off[k]) for k in worst}
                states["cuda"].load_state_dict(states["cpu"].state_dict())
            k2, k3, k4, k5 = (c.launches for c in counters)
            print(f"(a) conv_kernel={mode!r}: worst over {RUN_STEPS} steps, card vs CPU: "
                  + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
                  + f"; launches K2 {k2} K3 {k3} K4 {k4} K5 {k5}")
            # 14 graphers, the 2 of the dilated stage through K2, the other 12 K3 + K4
            expect_launches(f"phase 23 (a) conv_kernel={mode!r} (K2, K3, K4, K5)", (k2, k3, k4, k5),
                            (2 * RUN_STEPS, 12 * RUN_STEPS, 12 * RUN_STEPS,
                             RUN_K5_PER_STEP * RUN_STEPS * (mode == "1")))
            out["worst"][mode] = worst
            for key, n in zip(("k2", "k3", "k4", "k5"), (k2, k3, k4, k5)):
                out[key] += n
    out["witnessed"] = witnessed
    print(f"(a) {witnessed} of {2 * RUN_STEPS} steps beyond a width, each within the widths of a "
          f"one-ulp CPU step (at most {RUN_WITNESS_STEPS})")
    print(f"phase 23 (a): {time.time() - t_phase:.1f} s")
    return out


def run_flagship_phase(dev, data_dir: str) -> dict:
    """Phase 23 (b): the flagship at full width, free running, through
    ``run_training.main`` with the BTI Synapse trainer (14 classes, the
    13-organ tree) on phase 14's cases: 3 epochs x 50 iterations,
    device DA (auto), 10 eval steps per epoch, then the final validation.
    Every BTI term of the run finite (each call of the compound loss's TI
    term recorded), every epoch's losses finite, the epoch-mean train loss
    of epoch 2 below epoch 0's, K3 and K4 exactly 14 launches per step, K1
    14 per eval step and validation forward."""
    from unittest import mock

    from nextou_tpu_torch import run_training
    from nextou_tpu_torch.infer.sliding_window import compute_sliding_window_steps
    from nextou_tpu_torch.kernels.conv import conv3d_cuda
    from nextou_tpu_torch.kernels.knn import knn_max_bwd_cuda, knn_max_cuda, knn_max_idx_cuda
    from nextou_tpu_torch.losses import compound
    from nextou_tpu_torch.train import get_trainer_class
    from nextou_tpu_torch.train.trainer import NexToUTrainer

    t_phase = time.time()
    config, seconds = "3d_fullres_nextou", {}  # phase 14's configuration
    terms, ti = [], compound.ti_loss

    def recorded_ti(*args, **kwargs):
        term = ti(*args, **kwargs)
        terms.append(term.detach())
        return term

    counters = (knn_max_cuda, knn_max_idx_cuda, knn_max_bwd_cuda, conv3d_cuda)
    for counter in counters:
        counter.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    compound.ti_loss = recorded_ti
    try:
        with mock.patch.object(get_trainer_class(RUN_TRAINER), "num_val_iterations_per_epoch",
                               RUN_EVAL_STEPS), timing(NexToUTrainer, (
                "initialize", "run_training", "save_checkpoint", "perform_actual_validation"),
                seconds):
            trainer = run_training.main([data_dir, config, "0", "-tr", RUN_TRAINER,
                                         "--epochs", str(RUN_EPOCHS), "--iters", str(RUN_ITERS),
                                         "--device", str(dev)])
    finally:
        compound.ti_loss = ti
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    k1, k3, k4, k5 = (c.launches for c in counters)
    terms = torch.stack(terms).cpu()
    log = trainer.log_history
    for e in log:
        print(f"(b) epoch {e['epoch']}: train_loss {e['train_loss']:.4f} (first step "
              f"{e['first_step_loss']:.4f}) val_loss {e['val_loss']:.4f} ema "
              f"{e['ema_pseudo_dice']:.4f}; {e['train_time_s'] / RUN_ITERS:.3f} s per iteration, "
              f"waiting for the loader {e['loader_wait_s'] / e['train_time_s']:.3f} of it")
    _, val = trainer.get_split()
    tiles = math.prod(len(s) for s in compute_sliding_window_steps(
        TRAIN_SHAPE, trainer.configuration_manager.patch_size))
    fwd_case = math.ceil(tiles / TILE_BATCH) * (8 // MIRRORS_PER_FORWARD)
    steps = RUN_EPOCHS * RUN_ITERS
    print(f"(b) run_training.main -tr {RUN_TRAINER} {config}, {RUN_EPOCHS} x {RUN_ITERS}, "
          f"device DA {trainer.device_da}, {RUN_EVAL_STEPS} eval steps per epoch, validation of "
          f"{len(val.case_ids)} case(s): {time.time() - t_phase:.1f} s incl. model build; BTI "
          f"term over {len(terms)} calls {terms.min().item():.4f} .. {terms.max().item():.4f} "
          f"(all finite: {bool(torch.isfinite(terms).all())}); peak device memory "
          f"{peak / 2**30:.2f} GiB; K3 {k3}, K4 {k4}, K1 {k1}, K5 {k5} launches; seconds in "
          f"the trainer's run_training {seconds['run_training']:.2f} (initialize "
          f"{seconds['initialize']:.2f}, epochs {sum(e['epoch_time_s'] for e in log):.2f}, "
          f"checkpoints {seconds['save_checkpoint']:.2f}), the final validation "
          f"{seconds['perform_actual_validation']:.2f}")
    expect_launches("phase 23 (b) (K3, K4, K1, K5)", (k3, k4, k1, k5),
                    (14 * steps, 14 * steps,
                     14 * (RUN_EPOCHS * RUN_EVAL_STEPS + len(val.case_ids) * fwd_case), 0))
    losses = [v for e in log for v in (e["train_loss"], e["val_loss"], e["first_step_loss"])]
    if len(log) != RUN_EPOCHS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"phase 23 (b): losses {losses}")
    if not (len(terms) and torch.isfinite(terms).all()):
        raise AssertionError("phase 23 (b): a BTI term is not finite")
    if not log[-1]["train_loss"] < log[0]["train_loss"]:
        raise AssertionError(f"phase 23 (b): epoch {RUN_EPOCHS - 1}'s train loss "
                             f"{log[-1]['train_loss']} not below epoch 0's {log[0]['train_loss']}")
    print(f"phase 23 (b): {time.time() - t_phase:.1f} s")
    return {"k1": k1, "k3": k3, "k4": k4, "peak_bytes": peak,
            "s_per_iter": [e["train_time_s"] / RUN_ITERS for e in log]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 1
    from nextou_tpu_torch.kernels.build import build_kernels
    from nextou_tpu_torch.models.presets import flagship_3d_spec

    # f32 comparisons are full f32: no TF32 in matmuls or cuDNN convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = card()
    print(f"card: {smi} | torch.cuda: {name} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    t0 = time.time()
    logs = build_kernels()
    print(f"kernels built in {time.time() - t0:.1f} s from nextou_tpu_torch/csrc/ "
          f"(one nvcc -gencode arch=compute_90a,code=sm_90a per source, in parallel)")
    for lib, log in logs.items():
        used = [line for line in log.splitlines() if "Used" in line or "cached" in line]
        print(f"  {lib}: " + "; ".join(line.split("Used", 1)[-1].strip() for line in used))

    records = {"knn_max": kernel_phase(flagship_3d_spec(), dev)}
    records.update(train_kernel_phase(flagship_3d_spec(), dev))
    records["knn_indices"] = dilated_kernel_phase(small_train_spec(), dev)
    records["conv3d"] = conv_kernel_phase(flagship_3d_spec(), dev)
    with tempfile.TemporaryDirectory() as tmp:
        # two cases of 64x280x240: 2 x 2 tiles of the 64x224x192 patch each
        sl = slice_phase(dev, tmp, flagship_3d_spec(num_classes=14), (64, 280, 240))
        torch.cuda.empty_cache()
        all_devices_k1 = all_devices_phase(dev, tmp, flagship_3d_spec(num_classes=14),
                                           (64, 280, 240))
        torch.cuda.empty_cache()
        sl5 = conv_serving_phase(dev, tmp, flagship_3d_spec(num_classes=14), (64, 280, 240))
        torch.cuda.empty_cache()
        raw = raw_serving_phase(dev, tmp, flagship_3d_spec(num_classes=14))
        torch.cuda.empty_cache()
        host = host_accumulation_phase(dev, tmp, flagship_3d_spec(num_classes=14))
        torch.cuda.empty_cache()
        ens = fold_ensemble_phase(dev, tmp, flagship_3d_spec(num_classes=14))
    small_reference_phase(dev)
    torch.cuda.empty_cache()
    tr = train_phase(dev, flagship_3d_spec(num_classes=14, deep_supervision=True))
    torch.cuda.empty_cache()
    tr5 = conv_train_phase(dev, flagship_3d_spec(num_classes=14, deep_supervision=True),
                           tr["first_loss"])
    torch.cuda.empty_cache()
    k2_launches = small_train_phase(dev)
    torch.cuda.empty_cache()
    # phase 14's cases stay on disk until phase 23 (b) has trained on them
    trainer_tmp = tempfile.TemporaryDirectory()
    tmp = trainer_tmp.name
    trained = trainer_phase(dev, tmp)
    torch.cuda.empty_cache()
    device_augment_phase(dev, tmp)
    torch.cuda.empty_cache()
    t_phase = time.time()
    one_rank_phase(tmp, trained)
    torch.cuda.empty_cache()
    dp = two_ranks_phase(dev, tmp)
    print(f"phase 21 (a, b): {time.time() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    tools = tools_phase(dev)
    records["conv_probe"], records["knn_dissect"] = tools["conv_probe"], tools["knn_dissect"]
    records["conv_cl"], conv_cl_launches = conv_cl_phase(dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        nets = plans_networks_phase(dev, tmp)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        cascade = cascade_phase(dev, tmp)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        pipeline = pipeline_phase(dev, tmp, trained)
        torch.cuda.empty_cache()
        t_phase = time.time()
        run_small = run_small_phase(dev, tmp)
        torch.cuda.empty_cache()
        run_flagship = run_flagship_phase(dev, os.path.join(trainer_tmp.name, "train_data"))
        print(f"phase 23: {time.time() - t_phase:.1f} s")
    trainer_tmp.cleanup()
    records["conv3d"].merge(nets["conv3d"])

    # each kernel's numbers belong to the path that runs it ("path"): K1 to
    # predict.main on the flagship (phases 5, 15, 16 b, 17, 22) and on the cascade
    # stage (19), K3 and K4 to the flagship's train steps, the cascade stage's
    # and the planned flagship's (22), K2 to the small dilated network's (no flagship graph is
    # dilated), K5 to the networks with conv_kernel="1" (the flagship's served
    # volume and train steps; the 3d_lowres network's volumes and the residual
    # encoder's forwards and steps, phase 18: its times sum one forward of
    # each), the probes' kernels to their tools
    sources = {
        "knn_max": ("knn_max.cu", "nextou_tpu/kernels/knn.py:40",
                    sl["launches"] + raw["launches"] + host["launches"] + ens["launches"]
                    + trained["k1"] + nets["k1"] + cascade["k1"] + all_devices_k1
                    + pipeline["k1"] + run_flagship["k1"],
                    "flagship predict: preprocessed, raw, over the budget, fold ensembles, "
                    "--all-devices and without; the trainer's eval steps and validation; the "
                    "plain Grapher; the cascade stage's eval steps, validation and predict -prev "
                    "(preprocessed, raw); the planned flagship's eval steps and validation, "
                    "predict --raw from its run and from the imported checkpoint; the "
                    "flagship BTI run's eval steps and validation"),
        "knn_indices": ("knn_max_idx.cu", "nextou_tpu/kernels/knn.py:184",
                        k2_launches + run_small["k2"],
                        "small dilated network, train steps; its 40 steps of a run (Dice + CE "
                        "and BTI, conv_kernel '0' and '1') against the CPU"),
        "knn_max_idx": ("knn_max_idx.cu", "nextou_tpu/kernels/knn.py:278",
                        tr["k3"] + trained["k3"] + cascade["k3"] + dp["k3"] + pipeline["k3"]
                        + run_small["k3"] + run_flagship["k3"],
                        "flagship train steps; the trainer's; the cascade stage's; two gloo "
                        "ranks' and their one process's; the planned flagship's; the small "
                        "network's run against the CPU; the flagship BTI run's 150 steps"),
        "knn_max_bwd": ("knn_max_bwd.cu", "nextou_tpu/kernels/knn.py:384",
                        tr["k4"] + trained["k4"] + cascade["k4"] + dp["k4"] + pipeline["k4"]
                        + run_small["k4"] + run_flagship["k4"],
                        "flagship train steps; the trainer's; the cascade stage's; two gloo "
                        "ranks' and their one process's; the planned flagship's; the small "
                        "network's run against the CPU; the flagship BTI run's 150 steps"),
        "conv3d": ("conv3d.cu", "nextou_tpu/kernels/conv.py:90",
                   sl5["launches"] + tr5["launches"] + nets["k5"] + run_small["k5"],
                   "flagship predict and train steps with conv_kernel='1'; the 3d_lowres "
                   "PlainConvUNet's predict and the ResidualEncoderUNet's forwards and steps; "
                   "the small network's run with every (3, 3, 3) conv routed"),
        "conv_probe": ("conv_probe.cu", "tools/exp_mosaic_probe.py:24", tools["probe_launches"],
                       "tools.exp_conv_probe, both output orders"),
        "knn_dissect": ("knn_dissect.cu", "tools/exp_knn_dissect.py:27", tools["dissect_launches"],
                        "tools.exp_knn_dissect, mode full at its two shapes"),
        "conv_cl": ("conv_cl.cu", "tools/exp_conv_kernel.py:37", conv_cl_launches,
                    "tools.exp_conv_kernel: check, check3 (csub_conv, kernel :359) and CASES"),
    }
    records = {kernel: totals.record() for kernel, totals in records.items()}
    records["conv3d"]["cudnn_ms"] = records["conv3d"]["library_ms"]
    print(smi)
    print(json.dumps({"kernels": [
        {"name": kernel, "route": "cuda", "source": f"nextou_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": launches, **records[kernel], "path": path}
        for kernel, (src, replaces, launches, path) in sources.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
