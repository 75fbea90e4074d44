#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sgcdet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device   — refuse to run without a CUDA card; print nvidia-smi's name and
              power limit.
2. build    — compile the kernels of sgcdet_tpu_torch/csrc with nvcc
              (sm_90a) from this checkout, print the build seconds.
3. kernels  — every kernel against its plain PyTorch version on the card, at
              the shapes of the ScanNet 40-view eval path: bf16 value with
              f32 depth, and f32; out-of-image, behind-camera and NaN
              coordinates; a valid_counts case whose counted-out rows must be
              exactly zero.  Then the DFA3D template in the combination of
              every other TPU DFA3D kernel: bf16 value with bf16 depth at the
              2D lifting path's shapes (uniform 2-bin depth at d = 0.5,
              uncounted, all three levels), counted bf16/bf16 stage 1 and
              uncounted bf16/bf16 multi-head with a 12-bin depth (packed
              quads), uncounted f32/f32 and bf16/f32 stage 1 and multi-head
              (v1, v3); and F.grid_sample, the library call that computes the
              2D stage 1, against the kernel at f32.  The instances at the
              ScanNet200-L widths, K2 at c = 128 and K3 at 16 a head, at its
              level-2 shape (80 x 80 x 32 grid, top-k 51,200, exact auto
              budget), bf16/f32 and f32/f32, counted.  At a small size: a
              sweep whose 7 x 9 map and 5 planes fill no tile or plane group
              of K1 (with NaN / inf coordinates), and DFA3D stage 2 with 1,
              2 and 6 heads x 4 points and 8 heads x 3 points (head groups
              that fill part of a warp), every type pair, counted and
              uncounted.  Prints each max abs error with its worst ratio to
              the per-element tolerance, and the warm time of kernel, plain
              version and library call, with the earlier times of K1, K2,
              K3, K2' and K3', and K3's at 16 a head with one query a warp
              (PERF.md), beside this run's, and K2's of its parent design
              (a warp a query) at c = 256 and 128.  Stage 1 at c = 32
              (built, though no config reaches it) at every type pair, and
              a multi-head call with one point, which K3 runs and counts,
              each against its plain version.  ptxas's registers and spill
              bytes of every K2 and gather-epilogue instance.
3b. backward — every backward kernel against its plain version (the VJP of
              the plain forward) on the card, at the train path's shapes:
              bf16 and f32 value with f32 depth; out-of-image, behind-camera,
              NaN and image-edge coordinates; counted cases whose counted-out
              rows must get exactly zero location and attention gradients;
              then the same combinations as phase 3 (bf16/bf16 at the 2D
              path's shapes and with a 12-bin depth, uncounted f32), and
              aten's grid_sampler_2d_backward, the library call that
              computes the 2D stage 1's d_value, against the kernel at f32.
              The contention cases of the scatter-bound kernels K4 and K5:
              sweeps whose 8 x 16 reference tiles each sample one src point,
              a 13 x 21 sweep with integer and edge coordinates and a plane
              behind the source camera, a DFA3D stage 2 at level 2 whose
              heads and points all sample one pixel centre per query with a
              view counted to 0, and operands that are views breaking
              16-byte alignment; a DFA3D stage 1 at level 2 whose counted
              queries of each view all sample one pixel centre (lists of
              4608 entries, K6's long pass) with view 0 counted to 0.  K6 at
              c = 128 and K5 at 16 a head at the ScanNet200-L level-2 shape,
              bf16/f32 and f32/f32, with its long lists at c = 128.
              aten's grid_sampler_2d_backward, the library call that
              computes K4's d_src, against K4 at f32.  The partial head
              groups of phase 3 through K5.  Prints each gradient's max abs
              error, its worst ratio to the per-element tolerance, the warm
              time of kernel, plain version and library call (with the
              earlier times of K6, K6' and the f32 stage 1, and K5's at 16
              a head with one query a warp, beside this run's), the global
              atomic operations of K4 and K5 (vector and scalar, counted
              from the design) with their rate, and for K6
              and K6' the lists the call builds (entries, pixels, the
              longest list, the lists of more than 32 entries).
3c. frozen bn — ResNet-50's frozen BN epilogue (ops/frozen_bn.py): the
              forward and backward kernels against their plain versions at
              the main path's serving shapes (100 x 256 x 60 x 80 with the
              identity, 100 x 2048 x 8 x 10, the stem's 100 x 64 x 120 x
              160, a downsample without ReLU) and a 24-channel width whose
              rows fill no block, bf16 and f32: y within one ulp of the
              larger of |bn(x)|, |identity| and |y|, dx within one ulp,
              d_identity equal to g', d_weight and d_bias within 1e-5 of
              their terms' summed magnitudes; each kernel launched once a
              call and bit-identical over two calls; the share of ReLU
              decisions that differ from the plain version's.  Warm times
              of kernel, plain version (the same ops on the channels-last
              tensors) and library chain (the ops on NCHW tensors, as the
              model ran before), their bound, and ptxas's registers of
              every instance; refusals of NCHW operands, float16, mixed
              types and widths with no block.
4. slice    — the ScanNet forward at compute_dtype=float32 with TF32 off, on
              the indoor 40-view scene, once through the kernels and once
              through the plain versions: identical `valid`, matching
              depth distributions and head outputs.
5. serving  — the default bf16 ScanNet config with the exact auto visibility
              budget: infer.detect on 3 scenes (the first warms up); finite
              (M, 6) detections, seconds per scene split into the forward
              with the copy to the host, the host decode and the NMS, peak
              memory, and the launch counts of the run (2 sweep, 3 stage-1,
              3 stage-2 per scene).
6. train f32 — one train step (train.make_train_step) at compute_dtype=
              float32, TF32 off, ffn_dropout 0, depth loss on, on the indoor
              40-view train scene, through the plain versions and through
              the kernels from the same seeded weights, the kernel step on
              the plain step's side of 0 of every ReLU input (its own
              inputs held to the plain step's): matching loss terms and
              matching gradients of every parameter, each within 2e-3 of
              its scale plus 4x how far a 1e-7 nudge of the images moves it
              through the plain versions (a third step, on the same signs).
7. train    — the train setting of bench.py (default bf16 config, exact auto
              budget, depth loss on, dropout 0.1): 4 steps, the first a
              warm-up; finite losses and gradient norms, every trainable
              parameter moved and every frozen one did not, seconds per step,
              peak memory, and the launch counts of each step (sweep fwd/bwd
              2/2, stage-1 fwd/bwd 3/3, stage-2 fwd/bwd 3/3).
8. 2D lifting — ViewTransformer(use_depth=False) at the ScanNet width (embed
              256, 8 heads x 4 points, FFN 512), one per level, on seeded
              features at the three lifting shapes and the indoor scene's
              voxels (400 at level 0, seeded subsets of 800 and 6400 above):
              f32 with TF32 off through the kernels and the plain versions
              (output and the gradients of a seeded sum(out * g) for the
              features and every parameter); bf16 in train mode, forward and
              backward, finite, with the launches of the bf16-depth kernels
              (1 stage-1 and 1 stage-2, forward and backward, per level),
              warm milliseconds and peak memory per level.
9. windowed — the windowed kernels of the sort_queries path (multi-head
              forward and backward) at the three lifting shapes on the
              indoor scene's sorted projections with the model's initial
              sampling offsets, at every type pair, against their plain
              versions and against the template kernels on the same input,
              and the sorted stage 1, which goes to K2, against its plain
              version; a random-location case at level 2 for the
              global-memory branch.  Prints per level the share of chunks
              and of samples served from a window and the windowed and
              template kernels' warm times (with the earlier windowed
              times of PERF.md beside them, K2's beside the earlier
              windowed stage 1's); the windows' spans
              (p50 / p90 / max, per head and the union of a chunk's heads
              that a block stages) and the share of unions small enough to
              hold a chunk's d_value in shared memory; each windowed
              kernel's registers, spill bytes, shared memory a block and
              blocks an SM (CUDA runtime), and the registers and spills of
              K3, K5 and the windowed kernels from ptxas; at level 2 also
              the windows' cost as torch ops, and the template kernels on
              the same queries in sorted and in index order.  Then the
              instances at c = 16 (the sorted -L stage 2, two queries a
              warp) on ScanNet200-L's sorted level-2 queries (K' = 36,608,
              8 heads x 4 points, 12 bins) at every type pair, forward and
              backward with and without the sample gradients, against
              their plain versions and K3 / K5 at c = 16; the bf16/f32 ones
              timed beside K3 and K5 on the same input (their ratio) and
              their bound, with their resources.  Fails unless some case ran
              each branch.
10. sorted  — the ScanNet config with sort_queries=True and the exact auto
              budget: the f32 scene (TF32 off) through the kernels and the
              plain versions (as phase 4) and against phase 4's unsorted
              scene (identical `valid`, head outputs within 1e-4 of their
              scale); 3 bf16 scenes through infer.detect (launches per
              scene: 2 sweep, 3 K2, 3 windowed multi-head, no K3) and 4
              bf16 train steps (per step also 2 sweep bwd, 3 K6 and 3
              windowed backward, no K5).
11. probes  — the row gather/scatter probe kernels, each mode against its
              plain version at the TPU probes' shapes (gathers exact; a
              windowed scatter of a permutation bit-exact), then the probes'
              own run (sgcdet_tpu_torch.experiments.probes.run_probes):
              rows/s, GB/s, plain and bound ms beside torch.index_select and
              index_add_, with PERF.md rows 24 and 29 set beside their library
              call, and row 28 (the gather with the DFA3D corner epilogue)
              beside its parent design's time (PERF.md); the epilogue on
              jittered rows whose chunks fit a window, direct and windowed,
              each against its plain version and timed, and on random rows
              beside the same call with every index in 8 rows (its L2
              gathers removed); for the windowed
              gathers, the direct bf16 gather and the
              windowed scatters, where a call's device time goes (whole call,
              kernel alone, the wrapper's torch ops alone: probes.
              attribute_probes) and the device work of one call by
              torch.profiler, which must be the probe's own kernels only: one
              for a gather, at most three for a scatter-add.
12. large   — the ScanNet200-L config (scannet200_large: embed 128, so K2
              and K6 at c = 128 and K3 and K5 at 16 a head; 80 x 80 x 32
              grid, top-k 6400 / 51,200; 189 classes) with its exact auto
              budget at 40 views: the f32 scene through the kernels and the
              plain versions (as phase 4), one f32 train step through both
              (as phase 6, at its bounds), 3 bf16 scenes through infer.detect (launches per
              scene: 2 sweep, 3 K2 and 3 K3 at the -L widths) and 4 bf16 train
              steps (per step also 2 sweep bwd, 3 K6 and 3 K5 at the -L
              widths), with seconds per scene and step and peak memory.
              Then the same config with sort_queries: the f32 scene through
              kernels and plain versions and against the unsorted one
              (identical `valid`, heads within 1e-4 of scale), 3 bf16
              scenes (2 sweep, 3 K2 at c = 128, 3 windowed forwards at c =
              16 a scene) and 4 bf16 train steps (also 2 sweep bwd, 3 K6
              and 3 windowed backwards at c = 16 a step).
13. arkit   — the ARKit head (head_type "sunrgbd": yawed boxes, the rotated
              3D IoU loss, rotated BEV NMS), for arkit and for arkit_large
              (its -L widths), each with its exact auto budget at 40 views of
              the indoor scene at ARKit's 240 x 320 frames (60 x 80 value
              maps at level 2): K2, K3, K6 and K5 of the config's widths
              against their plain versions at its level-2 shape (bf16/f32 and
              f32/f32, counted; the bf16/f32 ones timed beside their bounds),
              and for arkit K1 and K4 on ARKit's rig; the f32 scene through
              kernels and plain versions (as phase 4); one f32 train step
              through both on the yawed synthetic ground truth (as phase 6,
              at its bounds), which must have FCOS positives and a nonzero
              loss_bbox.  In these f32 runs the second run takes the first
              run's occupancy top-k picks, its scores held to 1e-6 of their
              largest and at most 4 voxels swapped across a level's cut
              (PICK_SCORE_TOL, PICK_SWAPS_MAX).  bf16 serving, a warm-up
              forward and then ARKIT_SERVE_SCENES timed infer.detect calls,
              each split as in phase 5 (here the rotated BEV NMS), 1 to
              nms_pre (M, 7) boxes, launches per scene 2 sweep, 3 K2 and 3 K3
              at the config's widths; 4 bf16 train steps (per step also 2
              sweep bwd, 3 K6 and 3 K5), with seconds per step and peak
              memory (arkit_large's beside ScanNet200-L's of phase 12).
              For arkit_large also the windowed kernels at c = 16 on its
              sorted level-2 queries against their plain versions.
14. eval    — the port's indoor_eval (mAP) on the scenes phases 5 and 13
              served (ScanNet's aligned boxes, ARKit's yawed ones) against
              synthetic GT (the boxes of scene.example_train_scene):
              mAP@0.25 and @0.5 finite; then the GT given back as
              detections of score 1: AP 1.0 for every class present.
15. cli     — the CLI (sgcdet_tpu_torch.cli.run) on the ScanNet config at
              full width, bf16, --visibility_budget auto, data.repeat_times=1,
              model.ffn_dropout=0.0, over in-memory datasets (no dataset is
              stored on the card's host): 2 train scenes at 40 views with the yawless
              ground truth of scene.example_train_scene and 2 val scenes at
              the config's 100 views, behind the CLI's SceneLoader, log
              folders under build/cli_smoke/.  Train 3 steps (an epoch is 2:
              saves and 100-view evals at steps 2 and 3, a final save):
              metrics.jsonl has train/ and val/ lines, config.json, step_2,
              step_3 and last -> step_3, the launches of phase 7 per step and
              of phase 5 per eval scene; a fresh model and optimizer restored
              from step 3 bit-equal to the trained ones; --resume to step 4
              runs one step; --mode eval of step 2 gives the in-training
              eval's mAP dict; --mode show (score_thr 0, nms_pre 50: the
              seeded model scores no box above 0.01) writes the .npy dumps
              and a render per view (.png.npy without cv2) with infer.detect's
              detections;
              one data-parallel step at world size 1 on NCCL (FileStore, in
              this process) against the single-device step from the same
              weights and scene (f32, TF32 off): loss terms within 1e-4, n_pos
              equal, every trainable parameter moved and no frozen one, the
              same launches, and one all-reduce each way per synced BN plus
              one each for n_pos, the gradients, the metrics and the BN
              statistics.  Then phase 4 at 100 views (f32 through kernels and
              plain versions) and phase 5 at 100 views (a warm-up forward and
              3 timed bf16 infer.detect calls: seconds per scene split into
              forward + copy, decode and NMS, peak memory, K' per level,
              launches per scene).  Also an eval of step 2 with
              --sweep_band auto: the band is the largest
              visibility.required_sweep_band of the val rigs if at most 20
              rows (else None), and a kept band launches no K1.
16. remat   — depth_remat on scannet200_large: the f32 train step with and
              without it through the kernels (TF32 off, cuDNN
              deterministic; a second step without it measures the
              kernels' run-to-run rounding): loss terms and BN running
              statistics within 1e-6 of scale, every gradient within 2e-3
              of its scale plus 4x its run-to-run move, the depth net's BN
              statistics moved once, K1 launched twice more (the
              recomputation); then the bf16 step with and without it at
              40 and 100 views: seconds a step and peak memory (a step
              that does not fit the card is reported as such; the remat
              step must fit).
17. sweep band — the banded-Gram sweep on the indoor 40-view rig:
              required_sweep_band, 0 violations at it, the depth net's
              dpt_dist through the banded path against K1's (f32 within
              1e-4; bf16 no further from the f32 K1 one than 2x K1's own
              bf16 distance plus 1e-4), one neighbour's correlation timed
              beside K1.
18. gt depth — use_gt_dpt (ScanNet, bf16, downsample_factor 4, synthetic GT
              depth at the padded image's size): a forward whose dpt_dist
              is the GT one-hot and one train step whose depth head has
              zero gradients, neither launching a sweep kernel.
19. view    — view sharding (train.make_view_sharded_train_step /
              make_view_sharded_eval_step) on the ScanNet config: the f32
              train step at 40 views (TF32 off, cuDNN deterministic,
              ffn_dropout 0, exact auto budget, depth loss on) in one
              process, again on images nudged by 1e-7, view-sharded at
              world size 1 on NCCL (a FileStore) and over 2 ranks (two gloo
              processes on cuda:0, `chip_smoke.py --view-rank`, 20 views
              each), every one on the first's ReLU signs (a rank its views'
              rows) and occupancy picks and held to it at phase 6's bounds;
              the ranks' metrics and parameters bit-identical, each rank's
              launches those of one process, its collectives counted by
              kind.  bf16 evals at 40 and 100 views: one process, the same
              on images nudged by 2^-9, NCCL at world size 1 (bit-equal to
              one process) and the 2 ranks on one process's occupancy picks
              (scores and swaps within 4x the nudge's), ``valid`` identical,
              each head output and the decoded detections within 4x the
              nudge's move, the ranks' outputs bit-identical.  Timed bf16
              steps and scenes (two processes sharing one card, one
              process, NCCL at world size 1) and peak memory a rank.

Each phase prints its seconds.  The last three lines are the kernel report
(one JSON object; ``launches`` are the train run's for the kernels of the
DFA3D and serving paths, the bf16 2D lifting run's for the bf16-depth
instances, the sorted train run's for the windowed kernels (the sorted
ScanNet200-L train run's for their c = 16 instances), the probes'
run's for the probe kernels and the ScanNet200-L train run's for the
instances at its widths; ``serving_launches`` the matching serving run's;
``arkit_launches`` and ``arkit_serving_launches`` the ARKit train and
serving runs' of phase 13, arkit's for ScanNet's widths and
arkit_large's for the -L ones, 0 for the kernels they do not run), the
card's name and power limit, and the device record (one JSON object).
The script imports torch and sgcdet_tpu_torch only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

N_VIEWS = 40
SERVE_SCENES = 3

# TPU kernels each Hopper kernel of the paths replaces, and its source in
# this repo (built DFA3D instances that no path runs, such as K3 at c = 128,
# have launch counters but no entry)
_OPS = "sgcdet_tpu/ops/"
_EXP = "experiments/"
KERNEL_INFO = {
    "sweep_fwd": ("sgcdet_tpu_torch/csrc/sweep_fwd.cu",
                  f"{_OPS}sweep_pallas.py:233; {_OPS}sweep_pallas.py:225"),
    "dfa3d_fwd_s1_c256": ("sgcdet_tpu_torch/csrc/dfa3d_fwd.cu",
                          f"{_OPS}dfa3d_pallas.py:303; {_OPS}dfa3d_pallas3.py:179; "
                          f"{_EXP}dfa3d_pallas4.py:174"),
    "dfa3d_fwd_mh_c32": ("sgcdet_tpu_torch/csrc/dfa3d_fwd.cu",
                         f"{_OPS}dfa3d_pallas2.py:267; {_OPS}dfa3d_pallas.py:262; "
                         f"{_OPS}dfa3d_pallas3.py:154"),
    "sweep_bwd": ("sgcdet_tpu_torch/csrc/sweep_bwd.cu",
                  f"{_OPS}sweep_pallas.py:243"),
    "dfa3d_bwd_s1_c256": ("sgcdet_tpu_torch/csrc/dfa3d_bwd.cu",
                          f"{_OPS}dfa3d_pallas.py:439; {_OPS}dfa3d_pallas3.py:257"),
    "dfa3d_bwd_mh_c32": ("sgcdet_tpu_torch/csrc/dfa3d_bwd.cu",
                         f"{_OPS}dfa3d_pallas2.py:318; {_OPS}dfa3d_pallas.py:394; "
                         f"{_OPS}dfa3d_pallas3.py:227"),
    "dfa3d_fwd_s1_c256_bd": ("sgcdet_tpu_torch/csrc/dfa3d_fwd.cu",
                             f"{_OPS}dfa3d_pallas3.py:699"),
    "dfa3d_fwd_mh_c32_bd": ("sgcdet_tpu_torch/csrc/dfa3d_fwd.cu",
                            f"{_OPS}dfa3d_pallas3.py:665"),
    "dfa3d_bwd_s1_c256_bd": ("sgcdet_tpu_torch/csrc/dfa3d_bwd.cu",
                             f"{_OPS}dfa3d_pallas.py:439 at bf16 depth (the backward "
                             "of pq_s1 / pq_s1c)"),
    "dfa3d_bwd_mh_c32_bd": ("sgcdet_tpu_torch/csrc/dfa3d_bwd.cu",
                            f"{_OPS}dfa3d_pallas2.py:318 at bf16 depth (the 2D "
                            "path's stage 2)"),
    # the instances at the -L configs' widths (phase 12's path)
    "dfa3d_fwd_s1_c128": ("sgcdet_tpu_torch/csrc/dfa3d_fwd.cu", f"{_OPS}dfa3d_pallas.py:303"),
    "dfa3d_fwd_mh_c16": ("sgcdet_tpu_torch/csrc/dfa3d_fwd.cu", f"{_OPS}dfa3d_pallas2.py:267"),
    "dfa3d_bwd_s1_c128": ("sgcdet_tpu_torch/csrc/dfa3d_bwd.cu", f"{_OPS}dfa3d_pallas.py:439"),
    "dfa3d_bwd_mh_c16": ("sgcdet_tpu_torch/csrc/dfa3d_bwd.cu", f"{_OPS}dfa3d_pallas2.py:318"),
    "dfa3d_win_fwd_mh": ("sgcdet_tpu_torch/csrc/dfa3d_win_fwd.cu",
                         f"{_EXP}dfa3d_pallas4.py:130; {_EXP}dfa3d_pallas4.py:418; "
                         f"{_EXP}dfa3d_pallas5.py:185"),
    "dfa3d_win_bwd_mh": ("sgcdet_tpu_torch/csrc/dfa3d_win_bwd.cu",
                         f"{_EXP}dfa3d_pallas4.py:432; {_EXP}dfa3d_pallas5.py:284"),
    # the windowed instances at the -L stage 2's c = 16 (the sorted -L path)
    "dfa3d_win_fwd_mh_c16": ("sgcdet_tpu_torch/csrc/dfa3d_win_fwd.cu",
                             f"{_EXP}dfa3d_pallas4.py:130; {_EXP}dfa3d_pallas4.py:418; "
                             f"{_EXP}dfa3d_pallas5.py:185"),
    "dfa3d_win_bwd_mh_c16": ("sgcdet_tpu_torch/csrc/dfa3d_win_bwd.cu",
                             f"{_EXP}dfa3d_pallas4.py:432; {_EXP}dfa3d_pallas5.py:284"),
    # no TPU kernel: XLA fuses the frozen BN, the residual add and the ReLU
    # into the convolution there
    "frozen_bn_fwd": ("sgcdet_tpu_torch/csrc/frozen_bn.cu",
                      "none (ResNet-50's frozen BN + add + ReLU, sgcdet_tpu/models/"
                      "layers.py:229-232, fused by XLA)"),
    "frozen_bn_bwd": ("sgcdet_tpu_torch/csrc/frozen_bn.cu",
                      "none (the backward of frozen_bn_fwd, by autograd through XLA)"),
    "row_gather": ("sgcdet_tpu_torch/csrc/rows.cu",
                   f"{_EXP}probe_window_lowering.py:27; {_EXP}probe_window_matmul.py:27; "
                   f"{_EXP}probe_gather_batch.py:31; {_EXP}probe_gather_batch.py:47; "
                   f"{_EXP}probe_gather_batch.py:64; {_EXP}probe_gather_batch.py:85"),
    "row_scatter_add": ("sgcdet_tpu_torch/csrc/rows.cu",
                        f"{_EXP}probe_window_lowering.py:63; {_EXP}probe_f32_onehot.py:20"),
}
# the bf16-depth instances, launched by the 2D lifting path
KERNELS_2D = ("dfa3d_fwd_s1_c256_bd", "dfa3d_fwd_mh_c32_bd", "dfa3d_bwd_s1_c256_bd",
              "dfa3d_bwd_mh_c32_bd")
# the windowed kernels, launched by the sorted path
KERNELS_SORTED = ("dfa3d_win_fwd_mh", "dfa3d_win_bwd_mh")
# ... and at c = 16, by the sorted ScanNet200-L path
KERNELS_SORTED_LARGE = ("dfa3d_win_fwd_mh_c16", "dfa3d_win_bwd_mh_c16")
# the instances at the -L configs' widths, launched by the ScanNet200-L path
KERNELS_LARGE = ("dfa3d_fwd_s1_c128", "dfa3d_fwd_mh_c16", "dfa3d_bwd_s1_c128",
                 "dfa3d_bwd_mh_c16")
LARGE = "scannet200_large"
# the ARKit head's configs (phase 13), and the configs at the -L widths
ARKIT_CONFIGS = ("arkit", "arkit_large")
LARGE_CONFIGS = (LARGE, "arkit_large")
# timed detect calls a config of phase 13 serves (its host decode runs the
# rotated BEV NMS over every candidate of every class: score_thr 0)
ARKIT_SERVE_SCENES = 2
# phase 13's f32 runs take the reference run's occupancy top-k picks
# (_occupancy_picks_of): their scores held to this share of the largest (the
# kernels' f32 score error read at most 1.788e-7 at scales of 0.56-0.77), and
# at most this many voxels swapped across a level's cut
PICK_SCORE_TOL = 1e-6
PICK_SWAPS_MAX = 4
# each train phase's peak memory, by log tag (phase 13 prints ScanNet200-L's
# beside arkit_large's)
_TRAIN_PEAKS = {}
# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, and f32 flop/s outside
# the tensor cores, where every kernel here computes
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# ResNet-50's frozen BN epilogues, one launch each a forward (the stem, 3 a
# bottleneck, 4 downsamples) and a backward, in every config
RESNET_BN = {"frozen_bn_fwd": 53}
RESNET_BN_STEP = {"frozen_bn_fwd": 53, "frozen_bn_bwd": 53}
# launches of each kernel per scene on the serving path
LAUNCHES_PER_SCENE = {"sweep_fwd": 2, "dfa3d_fwd_s1_c256": 3, "dfa3d_fwd_mh_c32": 3,
                      **RESNET_BN}
# ... and per step on the train path
LAUNCHES_PER_STEP = {"sweep_fwd": 2, "sweep_bwd": 2, "dfa3d_fwd_s1_c256": 3,
                     "dfa3d_bwd_s1_c256": 3, "dfa3d_fwd_mh_c32": 3, "dfa3d_bwd_mh_c32": 3,
                     **RESNET_BN_STEP}
# ... and on the sorted path (sort_queries): K2 and K6 for stage 1, the
# windowed multi-head forward and backward
LAUNCHES_PER_SCENE_SORTED = {"sweep_fwd": 2, "dfa3d_fwd_s1_c256": 3,
                             "dfa3d_win_fwd_mh": 3, **RESNET_BN}
LAUNCHES_PER_STEP_SORTED = {"sweep_fwd": 2, "sweep_bwd": 2, "dfa3d_fwd_s1_c256": 3,
                            "dfa3d_bwd_s1_c256": 3, "dfa3d_win_fwd_mh": 3,
                            "dfa3d_win_bwd_mh": 3, **RESNET_BN_STEP}
# ... and on the ScanNet200-L path: the DFA3D instances at c = 128 (stage 1)
# and 16 a head (stage 2)
LAUNCHES_PER_SCENE_LARGE = {"sweep_fwd": 2, "dfa3d_fwd_s1_c128": 3, "dfa3d_fwd_mh_c16": 3,
                            **RESNET_BN}
LAUNCHES_PER_STEP_LARGE = {"sweep_fwd": 2, "sweep_bwd": 2, "dfa3d_fwd_s1_c128": 3,
                           "dfa3d_bwd_s1_c128": 3, "dfa3d_fwd_mh_c16": 3,
                           "dfa3d_bwd_mh_c16": 3, **RESNET_BN_STEP}
# ... and on the sorted -L path: K2 and K6 at c = 128, the windowed kernels
# at c = 16
LAUNCHES_PER_SCENE_SORTED_LARGE = {"sweep_fwd": 2, "dfa3d_fwd_s1_c128": 3,
                                   "dfa3d_win_fwd_mh_c16": 3, **RESNET_BN}
LAUNCHES_PER_STEP_SORTED_LARGE = {"sweep_fwd": 2, "sweep_bwd": 2, "dfa3d_fwd_s1_c128": 3,
                                  "dfa3d_bwd_s1_c128": 3, "dfa3d_win_fwd_mh_c16": 3,
                                  "dfa3d_win_bwd_mh_c16": 3, **RESNET_BN_STEP}
TRAIN_STEPS = 4
# the forward kernels' earlier times (PERF.md section 6, rows 1, 2, 4, 5,
# 8-10, 12, 13: this script on an H100 80GB HBM3 at 700 W), printed beside
# this run's: K1 and K3 before their 16-byte-lane layouts, K2 before the
# one-point case had a kernel of its own
EARLIER_MS = {"K1 bf16": 0.3748, "K1 f32": 0.3599, "K3": 0.4746,
              "K2' 2D": 0.1157, "K3' 2D": 1.2694, "K3 f32/f32 uncounted": 0.9651,
              "K2 f32/f32 uncounted": 0.1146,
              # K6 (rows 7 and 15) and K6' before the stage-1 backward summed
              # where the output lives (the multi-head template, zero-filled f32
              # gradients cast afterwards)
              "K6": 0.2372, "K6 f32/f32 uncounted": 0.2452, "K6' 2D": 0.2970,
              # the windowed kernels at level 2 before their redesign (PERF.md
              # section 6, rows 16-21, as this script measured them; stage 1
              # before the sorted path sent it to K2)
              "win s1 sorted": 0.2314, "win mh sorted": 0.3878,
              "win mh random": 0.4341, "win bwd sorted": 1.2569,
              "win bwd random": 1.2202,
              # K3 and K5 at c = 16 a head with one query a warp (lanes 16-31
              # idle at 8 heads), before two queries shared a warp (PERF.md
              # section 6, the -L rows)
              "K3 c16 one query a warp": 0.6100, "K5 c16 one query a warp": 1.8714,
              # K2 at stage 1 with a warp a query (PERF.md section 6, rows 4
              # and 4L), before a warp took four rounds of queries
              "K2 c256 a warp a query": 0.0579, "K2 c128 a warp a query": 0.2790,
              # row 28, the gather with the DFA3D corner epilogue, with a
              # warp an output row and a lane a channel (PERF.md section 6),
              # before a row's lanes took its channels and summed its corner
              # rows
              "p4+epi a lane a channel": 0.2016}
# small DFA3D stage-2 shapes whose head groups fill only part of a warp of
# eight 4-lane heads at c = 32: (heads, points)
PARTIAL_HEADS = ((1, 4), (2, 4), (6, 4), (8, 3))


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def cuda_ms(torch, fn, iters=10):
    """Warm mean milliseconds of fn() on the card (``ops._cuda.cuda_ms``:
    CUDA events, the stream held by a spin kernel while the host
    enqueues)."""
    from sgcdet_tpu_torch.ops._cuda import cuda_ms as device_ms

    return device_ms(fn, iters)


def tolerance(torch, ref, f32_rel=1e-4):
    """Per-element limit of |kernel - plain| and its description.

    Kernel and plain version both sum in f32, in different orders (the
    backward kernels' atomics in an order that changes from run to run), and
    round once to the output type.  bf16: one bf16 ulp of the element (at
    most 2^-7 of it) plus f32 summation noise, 1e-5 of the largest
    magnitude; f32: ``f32_rel`` of the largest magnitude (1e-4 for the
    forward outputs, 1e-5 for the gradients)."""
    r = ref.float().abs()
    peak = float(r.max())
    if ref.dtype == torch.bfloat16:
        noise = 1e-5 * peak
        return 2.0 ** -7 * r + noise, f"2^-7 |ref| + {noise:.2e}"
    return torch.full_like(r, f32_rel * peak), f"{f32_rel * peak:.3e}"


def compare_tensors(torch, name, got, want, f32_rel=1e-4):
    """Check one kernel output against its plain version; returns the max
    abs error."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: kernel {tuple(got.shape)} {got.dtype} vs plain "
          f"{tuple(want.shape)} {want.dtype}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
    diff = (got.float() - want.float()).abs()
    tol, tol_desc = tolerance(torch, want, f32_rel)
    err = float(diff.max())
    worst = float((diff / tol.clamp_min(1e-30)).max())
    ok = bool((diff <= tol).all())
    log(f"[kernels] {name}: max_abs_err {err:.3e}, worst err/tol {worst:.3f} "
        f"(tol {tol_desc}) {'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: kernel disagrees with plain version")
    return err


def _launched(launches):
    """The counters of ``launches`` that are not 0 (the logs' view)."""
    return {name: n for name, n in launches.items() if n}


def nbytes(t, frac=1.0):
    return t.numel() * t.element_size() * frac


def bound(byte_count, flops):
    """The least time the card could take (ms) and what sets it: the bytes
    each input is read once and each output written once over the HBM rate,
    or the operations over the f32 rate."""
    t_bytes = byte_count / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def touched_rows(locs, counts, h, w, dsize):
    """Distinct (view, pixel, head) value rows and distinct (view, pixel,
    bin) depth elements that the in-image corners of this run's samples
    read: per corner the two bins of the depth lerp that lie in range (the
    rows past each view's count read nothing; NaN lands off the image and
    off the depth range, as in the kernels)."""
    import torch

    n, k, heads = locs.shape[:3]
    dev = locs.device

    def cell(coord, size):
        return (coord * size - 0.5).nan_to_num(nan=-4.0).clamp(-4, size + 4).floor().long()

    x, y, d = cell(locs[..., 0], w), cell(locs[..., 1], h), cell(locs[..., 2], dsize)
    live = torch.ones(locs.shape[:4], dtype=torch.bool, device=dev)
    if counts is not None:
        q = torch.arange(k, device=dev)
        live = live & (q[None, :, None, None] < counts[:, None, None, None])
    cam = torch.arange(n, device=dev).view(n, 1, 1, 1)
    head = torch.arange(heads, device=dev).view(1, 1, heads, 1).expand_as(live)
    rows, bins = [], []
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x + dx, y + dy
            ok = live & (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            pix = (cam * h + yi) * w + xi
            rows.append(pix[ok] * heads + head[ok])
            for di in (d, d + 1):
                ok_d = ok & (di >= 0) & (di < dsize)
                bins.append(pix[ok_d] * dsize + di[ok_d])
    return torch.cat(rows).unique().numel(), torch.cat(bins).unique().numel()


def dfa3d_work(args, outs, counts, backward, dot=True):
    """Bytes and flops of one DFA3D call on ``args`` = (value, depth, locs,
    attn[, g]) with outputs ``outs``: the value rows and depth bins the
    run's samples touch, the per-query operands and the FMAs (2 flops) of
    the rows its counts let through, every output.  Per (query, head,
    point, corner, channel) the forward does one FMA, the backward a
    d_value update and, where it needs the dot product <g, value row> for
    the sample or depth gradients (``dot``), one FMA of it; a backward
    without ``dot`` reads no value row."""
    value, depth, locs = args[:3]
    n, h, w, cfull = value.shape
    k, heads, p = locs.shape[1:4]
    c = cfull // heads
    frac = 1.0 if counts is None else float(counts.clamp(max=k).sum()) / (n * k)
    value_rows, depth_elems = touched_rows(locs, counts, h, w, depth.shape[-1])
    reads_value = dot or not backward
    byte_count = ((value_rows * c * value.element_size() if reads_value else 0)
                  + depth_elems * depth.element_size())
    byte_count += sum(nbytes(t, frac) for t in args[2:])  # locs, attn, g
    byte_count += sum(nbytes(t) for t in outs if t is not None)
    fmas = 1 + (backward and dot)
    flops = n * k * frac * heads * p * 4 * c * 2 * fmas
    return byte_count, flops


def sweep_work(args, outs, backward):
    """Bytes and flops of one sweep call on (src, ref, x, y[, g]): per
    (view, plane, pixel) four C-channel corner FMAs and a C-channel dot
    product (10 C flops); the backward recomputes the sample, scatters four
    corner updates and sums the reference gradient (18 C flops)."""
    c = args[0].shape[-1]
    samples = args[2].numel()
    byte_count = sum(nbytes(t) for t in args) + sum(nbytes(t) for t in outs)
    return byte_count, samples * c * (18 if backward else 10)


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain at main-path shapes
# ---------------------------------------------------------------------------


def _scene_and_cfg(config="scannet", n_views=None):
    from sgcdet_tpu_torch import configs
    from sgcdet_tpu_torch.scene import example_scene

    cfg = getattr(configs, config)()
    scene = example_scene(cfg.data.img_shape, cfg.data.pad_size, n_views or N_VIEWS,
                          trajectory="indoor")
    return cfg, scene


def _auto_budget(cfg, scene):
    from sgcdet_tpu_torch.visibility import derive_visibility_budgets

    return derive_visibility_budgets([(scene["origin"], scene["proj_img"])],
                                     cfg.data.img_shape, cfg.model)


def _kept_queries(torch, mcfg):
    """K' per level: the queries a camera keeps under ``mcfg``'s budget
    (``compact_queries``' rounding; K where nothing is compacted)."""
    from sgcdet_tpu_torch.models.view_transformer import compact_queries

    ks = [math.prod(mcfg.n_voxels_list[0])] + list(mcfg.topk_list)
    kept = []
    for k, frac in zip(ks, mcfg.visibility_budget):
        compact = compact_queries(torch.ones((1, k), dtype=torch.bool), frac)
        kept.append(k if compact is None else compact[0].shape[1])
    return kept


def _sweep_cases(torch, dev, cfg, scene, gen):
    """Sweep inputs at the depth net's shapes: (40, 60, 80, 128) features,
    12 planes, sample coordinates of the indoor rig's first neighbour (with
    behind-camera planes), plus injected NaN / inf / far-off coordinates and
    samples on the image's edge rows and columns."""
    import numpy as np

    from sgcdet_tpu_torch.models.depth_net import _warp_grid, get_closest_frame_ids

    h, w, c = cfg.data.pad_size[0] // 4, cfg.data.pad_size[1] // 4, 128
    d0, d1, step = cfg.model.dbound
    depth_values = torch.from_numpy(
        np.arange(d0, d1, step, dtype=np.float32) + step / 2).to(dev)
    proj4 = torch.from_numpy(scene["proj_feat4"]).to(dev)
    nei = torch.from_numpy(get_closest_frame_ids(N_VIEWS, 2)[:, 0]).to(dev)
    xe, ye = _warp_grid(proj4[nei], proj4, depth_values, h, w)
    flat_x, flat_y = xe.view(-1), ye.view(-1)
    idx = torch.randint(0, flat_x.numel(), (128,), device=dev, generator=gen)
    flat_x[idx[:16]] = float("nan")
    flat_y[idx[16:32]] = float("inf")
    flat_x[idx[32:48]] = -float("inf")
    flat_x[idx[48:64]] = 1e9
    flat_x[idx[64:80]] = float(w - 1)  # last column: the x1 corners fall off
    flat_y[idx[80:96]] = float(h - 1)
    flat_x[idx[96:112]] = -0.5  # half a pixel left of the first column
    flat_y[idx[112:]] = -0.5
    n_out = int(((xe < -1) | (xe > w) | (ye < -1) | (ye > h) | ~torch.isfinite(xe)
                 | ~torch.isfinite(ye)).sum())
    log(f"[kernels] sweep coords: {n_out} of {xe.numel()} samples off-image, "
        f"behind-camera or non-finite")
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        src = torch.randn((N_VIEWS, h, w, c), device=dev, generator=gen).to(dt)
        ref = torch.randn((N_VIEWS, h, w, c), device=dev, generator=gen).to(dt)
        name = f"sweep {str(dt)[6:]} ({N_VIEWS},{h},{w},{c}) D={xe.shape[1]}"
        cases.append((name, src, ref, xe, ye))
    return cases


def _sweep_edge_cases(torch, dev, gen, n=2, h=7, w=9, d=5):
    """Sweeps whose H * W = 63 fills no tile of K1's reference pixels and
    whose D = 5 planes no group of planes it loads together, bf16 and f32:
    coordinates from 2 pixels outside the map to 1 past it, with NaN, inf
    and far-off ones injected.  Yields (name, (src, ref, x, y))."""
    x = torch.rand((n, d, h * w), device=dev, generator=gen) * (w + 3) - 2
    y = torch.rand((n, d, h * w), device=dev, generator=gen) * (h + 3) - 2
    x.view(-1)[::11] = float("nan")
    y.view(-1)[5::13] = float("inf")
    x.view(-1)[7::17] = -float("inf")
    y.view(-1)[3::19] = 1e30
    for dt in (torch.bfloat16, torch.float32):
        src = torch.randn((n, h, w, 128), device=dev, generator=gen).to(dt)
        ref = torch.randn((n, h, w, 128), device=dev, generator=gen).to(dt)
        yield f"sweep {str(dt)[6:]} ({n},{h},{w},128) D={d}, ragged tile", (src, ref, x, y)


def _partial_head_cases(torch, dev, gen, n=4, h=14, w=20, k=300, dsize=12):
    """DFA3D stage-2 operands at a small size whose head groups fill only
    part of a warp of eight 4-lane heads at c = 32 (PARTIAL_HEADS), with
    locations spilling off every side: every type pair, counted (views of
    count 0, 100, 299 and all 300 queries) and uncounted.  Yields (name,
    (value, depth, locs, attn, heads, counts))."""
    counted = torch.tensor([0, 100, 299, 300], dtype=torch.int32, device=dev)
    for heads, p in PARTIAL_HEADS:
        value = torch.randn((n, h, w, heads * 32), device=dev, generator=gen)
        depth = torch.softmax(torch.randn((n, h, w, dsize), device=dev, generator=gen), -1)
        locs = torch.rand((n, k, heads, p, 3), device=dev, generator=gen) * 1.4 - 0.2
        attn = torch.rand((n, k, heads, p), device=dev, generator=gen)
        for vdt, ddt in ((torch.bfloat16, torch.float32), (torch.float32, torch.float32),
                         (torch.bfloat16, torch.bfloat16)):
            tag = f"{str(vdt)[6:]}/{str(ddt)[6:]}"
            for counts in (counted, None):
                yield (f"{tag} ({n},{h},{w}) K={k}, {heads} heads x {p} points, "
                       + ("counted" if counts is not None else "uncounted"),
                       (value.to(vdt), depth.to(ddt), locs, attn, heads, counts))


def _level_voxels(torch, dev, cfg, level):
    """The voxel centres one lifting level takes: all of them at level 0, a
    seeded sorted subset of top-k size above (the occupancy top-k's count
    and scan order)."""
    from sgcdet_tpu_torch.voxel_grid import voxel_centers_zero_origin

    m = cfg.model
    nvox = m.n_voxels_list[level]
    ref_all = torch.from_numpy(voxel_centers_zero_origin(nvox, m.voxel_size_list[level]))
    k = ref_all.shape[0] if level == 0 else m.topk_list[level - 1]
    keep = torch.sort(torch.randperm(ref_all.shape[0], generator=torch.Generator()
                                     .manual_seed(level))[:k])[0]
    return ref_all[keep].to(dev)


def _level_hw(cfg, level):
    ds = 2 ** (2 - level) * 4
    return cfg.data.img_shape[0] // ds, cfg.data.img_shape[1] // ds


def _project(torch, dev, cfg, scene, level):
    from sgcdet_tpu_torch.models.view_transformer import point_sampling

    return point_sampling(
        _level_voxels(torch, dev, cfg, level), torch.from_numpy(scene["origin"]).to(dev),
        torch.from_numpy(scene["proj_img"]).to(dev), cfg.data.img_shape,
        cfg.model.dbound)


def _lifting_inputs(torch, dev, cfg, scene, level, budget, gen):
    """Stage-1 and stage-2 inputs of one pyramid level, compacted by the
    main path's own rule (visible queries first, counts = visible per
    camera)."""
    from sgcdet_tpu_torch.models.view_transformer import compact_queries

    m = cfg.model
    ref_cam, mask = _project(torch, dev, cfg, scene, level)
    compact = compact_queries(mask, budget)
    check(compact is not None, f"level {level}: the budget keeps every query")
    sel, counts = compact
    kb = sel.shape[1]
    ref_s = torch.gather(ref_cam, 1, sel[..., None].expand(-1, -1, 3))
    h, w = _level_hw(cfg, level)
    heads, pts, dsize = m.num_heads, m.num_points, m.depth_channels
    locs2 = ref_s[:, :, None, None, :] + torch.randn(
        (N_VIEWS, kb, heads, pts, 3), device=dev, generator=gen) * torch.tensor(
        [2.0 / w, 2.0 / h, 1.0 / dsize], device=dev)
    attn2 = torch.softmax(torch.randn((N_VIEWS, kb, heads, pts), device=dev,
                                      generator=gen), -1)
    depth = torch.softmax(torch.randn((N_VIEWS, h, w, dsize), device=dev,
                                      generator=gen), -1)
    value = torch.randn((N_VIEWS, h, w, m.embed_dims), device=dev, generator=gen)
    return dict(h=h, w=w, kb=kb, counts=counts, value=value, depth=depth,
                locs1=ref_s[:, :, None, None, :].contiguous(),
                attn1=torch.ones((N_VIEWS, kb, 1, 1), device=dev),
                locs2=locs2, attn2=attn2, heads=heads)


def _lifting_2d_inputs(torch, dev, cfg, scene, level, gen):
    """Stage-1 and stage-2 operands of the 2D lifting path at one level, as
    msda_2d_attend builds them: every query (the 2D path does not compact),
    bf16 values, a uniform 2-bin depth of bf16 ones sampled at d = 0.5."""
    m = cfg.model
    ref_cam, _ = _project(torch, dev, cfg, scene, level)
    k = ref_cam.shape[1]
    h, w = _level_hw(cfg, level)
    heads, pts = m.num_heads, m.num_points
    uv = ref_cam[..., :2]
    uv2 = uv[:, :, None, None, :] + torch.randn(
        (N_VIEWS, k, heads, pts, 2), device=dev, generator=gen) * torch.tensor(
        [2.0 / w, 2.0 / h], device=dev)

    def with_d(xy):
        return torch.cat([xy, torch.full_like(xy[..., :1], 0.5)], -1).contiguous()

    bf16 = torch.bfloat16
    return dict(
        h=h, w=w, k=k, heads=heads,
        value=torch.randn((N_VIEWS, h, w, m.embed_dims), device=dev, generator=gen).to(bf16),
        vp=torch.randn((N_VIEWS, h, w, m.embed_dims), device=dev, generator=gen).to(bf16),
        ones=torch.ones((N_VIEWS, h, w, 2), device=dev, dtype=bf16),
        locs1=with_d(uv[:, :, None, None, :]),
        attn1=torch.ones((N_VIEWS, k, 1, 1), device=dev),
        locs2=with_d(uv2),
        attn2=torch.softmax(torch.randn((N_VIEWS, k, heads, pts), device=dev,
                                        generator=gen), -1))


def stage1_grid(locs1, dtype):
    """The 2D stage 1's locations as a grid_sample grid: 2 loc - 1,
    (N, K, 1, 2), in ``dtype`` (grid_sample takes its grid in the value's
    dtype)."""
    return (2 * locs1[:, :, 0, 0, :2] - 1)[:, :, None, :].to(dtype).contiguous()


def grid_sample_stage1(torch, value, grid):
    """The library call that computes the 2D stage 1: F.grid_sample of the
    (N, C, H, W) view of the NHWC value on ``stage1_grid`` (align_corners=
    False: pixel = loc * size - 0.5, zero padding per corner).  Returns
    (N, C, K, 1)."""
    import torch.nn.functional as F

    return F.grid_sample(value.permute(0, 3, 1, 2), grid, mode="bilinear",
                         padding_mode="zeros", align_corners=False)


def grid_sample_stage1_bwd(torch, g, value, grid):
    """The library call that computes the 2D stage 1's backward as the
    module runs it (d_value only): aten's grid_sampler_2d_backward for the
    call of ``grid_sample_stage1``, with g (N, K, C).  Returns (d_value as
    (N, C, H, W), the grid gradient or None where the call skipped it)."""
    return torch.ops.aten.grid_sampler_2d_backward(
        g.transpose(1, 2)[..., None], value.permute(0, 3, 1, 2), grid, 0, 0,
        False, [True, False])


def _timing(torch, report, name, kernel_name, run_kernel, run_plain, work,
            run_library=None, main=False, earlier=None):
    """Warm times of kernel, plain version and library call, and the bound
    from ``work(kernel outputs) -> (bytes, flops)``; the report keeps the
    case at the shapes of the kernel's main path (``main``).  ``earlier``:
    a key of EARLIER_MS, printed beside the time.  Returns the kernel's
    time."""
    ms_k = cuda_ms(torch, run_kernel)
    ms_p = cuda_ms(torch, run_plain, iters=2)
    ms_l = None if run_library is None else cuda_ms(torch, run_library)
    outs = run_kernel()
    outs = outs if isinstance(outs, tuple) else (outs,)
    bound_ms, bound_by = bound(*work(outs))
    log(f"[kernels] {name}: kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms, "
        + (f"library {ms_l:.4f} ms, " if ms_l is not None else "")
        + f"bound {bound_ms:.4f} ms ({bound_by})"
        + ("" if earlier is None else
           f", earlier {EARLIER_MS[earlier]:.4f} ms ({earlier}, PERF.md)"))
    if main:
        report[kernel_name].update(ms=ms_k, plain_ms=ms_p, bound_ms=bound_ms,
                                   bound_by=bound_by, library_ms=ms_l)
    return ms_k


def _zeros_past_count(torch, counts, rows=0):
    """A check that the rows of ``outs[rows]`` past each camera's count
    (and, for a backward, of ``outs[3]`` too) are exactly zero."""
    def check_rows(outs):
        outs = outs if isinstance(outs, tuple) else (outs,)
        q = torch.arange(outs[rows].shape[1], device=counts.device)
        past = q[None, :] >= counts[:, None]
        tensors = (outs[rows],) if rows == 0 else (outs[2], outs[3])
        check(all(bool((t[past] == 0).all()) for t in tensors),
              "rows past valid_counts are not exactly zero")
        log(f"[kernels]   {int(past.sum())} counted-out rows exactly zero")
    return check_rows


def phase_kernels(torch, dev, report):
    from sgcdet_tpu_torch.ops import KERNELS
    from sgcdet_tpu_torch.ops.dfa3d import counter_name, dfa3d_attention_plain, dfa3d_fwd_cuda
    from sgcdet_tpu_torch.ops.sweep import sweep_fwd_cuda, sweep_fwd_plain

    log_ptxas_instances()
    cfg, scene = _scene_and_cfg()
    budget = _auto_budget(cfg, scene)
    log(f"[kernels] auto visibility budget per level: {[round(b, 4) for b in budget]}")
    gen = torch.Generator(device=dev).manual_seed(0)

    def compare(name, kernel_name, run_kernel, run_plain, extra=None):
        before = KERNELS[kernel_name].launches if kernel_name in KERNELS else None
        out_k = run_kernel()
        check(before is None or KERNELS[kernel_name].launches == before + 1,
              f"{name}: {kernel_name} did not launch once")
        out_p = run_plain()
        torch.cuda.synchronize()
        err = compare_tensors(torch, name, out_k, out_p)
        if extra is not None:
            extra(out_k)
        rec = report.setdefault(kernel_name, {})
        rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err)

    def dfa3d(name, kernel_name, args, extra=None, time=None, run_library=None,
              earlier=None):
        """time: None, "log" (print the times) or "main" (and report them)."""
        compare(name, kernel_name, lambda: dfa3d_fwd_cuda(*args),
                lambda: dfa3d_attention_plain(*args), extra)
        if time:
            _timing(torch, report, name, kernel_name, lambda: dfa3d_fwd_cuda(*args),
                    lambda: dfa3d_attention_plain(*args),
                    lambda outs: dfa3d_work(args[:4], outs, args[5], False),
                    run_library, main=time == "main", earlier=earlier)

    for name, src, ref, xe, ye in _sweep_cases(torch, dev, cfg, scene, gen):
        args = (src, ref, xe, ye)
        compare(name, "sweep_fwd", lambda: sweep_fwd_cuda(*args),
                lambda: sweep_fwd_plain(*args))
        bf16 = src.dtype == torch.bfloat16
        _timing(torch, report, name, "sweep_fwd", lambda: sweep_fwd_cuda(*args),
                lambda: sweep_fwd_plain(*args),
                lambda outs: sweep_work(args, outs, False), main=bf16,
                earlier="K1 bf16" if bf16 else "K1 f32")
    for name, args in _sweep_edge_cases(torch, dev, gen):
        compare(name, "sweep_fwd", lambda: sweep_fwd_cuda(*args),
                lambda: sweep_fwd_plain(*args))

    for level in range(3):
        x = _lifting_inputs(torch, dev, cfg, scene, level, budget[level], gen)
        shape = f"({N_VIEWS},{x['h']},{x['w']}) K'={x['kb']}"
        for vdt in (torch.bfloat16, torch.float32):
            value = x["value"].to(vdt)
            tag = "bf16/f32" if vdt == torch.bfloat16 else "f32/f32"
            counts = x["counts"]
            s1 = (value, x["depth"], x["locs1"], x["attn1"], 1, counts)
            bf16 = vdt == torch.bfloat16
            timed = level == 2 and ("main" if bf16 else "log")
            dfa3d(f"stage1 {tag} {shape} counted", "dfa3d_fwd_s1_c256", s1,
                  _zeros_past_count(torch, counts), time=timed,
                  earlier="K2 c256 a warp a query" if bf16 else None)
            vp = torch.randn((N_VIEWS, x["h"], x["w"], value.shape[-1]),
                             device=dev, generator=gen).to(vdt)
            s2 = (vp, x["depth"], x["locs2"], x["attn2"], x["heads"], counts)
            dfa3d(f"stage2 {tag} {shape} counted", "dfa3d_fwd_mh_c32", s2,
                  _zeros_past_count(torch, counts), time=timed,
                  earlier="K3" if bf16 else None)
            if level == 2 and vdt == torch.bfloat16:
                locs_nan = x["locs2"].clone()
                locs_nan.view(-1)[::997] = float("nan")
                dfa3d(f"stage2 {tag} {shape} uncounted, NaN locs", "dfa3d_fwd_mh_c32",
                      (vp, x["depth"], locs_nan, x["attn2"], x["heads"], None))
            if level == 2:
                # the v1 (_fwd_kernel) and v3 (_fwd_kernel_q / _q_s1) rows:
                # uncounted, f32 and bf16 value with f32 depth
                dfa3d(f"stage1 {tag} {shape} uncounted (v3 q_s1)", "dfa3d_fwd_s1_c256",
                      s1[:5] + (None,), time="log",
                      earlier=None if bf16 else "K2 f32/f32 uncounted")
                dfa3d(f"stage2 {tag} {shape} uncounted (v1, v3 q)", "dfa3d_fwd_mh_c32",
                      s2[:5] + (None,), time="log",
                      earlier=None if bf16 else "K3 f32/f32 uncounted")
        # the packed-quad rows with a real 12-bin depth in bf16: counted
        # stage 1 (pq_s1c) and uncounted multi-head (pq)
        if level == 2:
            bf = torch.bfloat16
            dpt_bf = x["depth"].to(bf)
            dfa3d(f"stage1 bf16/bf16 {shape} counted, 12-bin depth (pq_s1c)",
                  "dfa3d_fwd_s1_c256_bd",
                  (x["value"].to(bf), dpt_bf, x["locs1"], x["attn1"], 1, x["counts"]),
                  _zeros_past_count(torch, x["counts"]), time="log")
            dfa3d(f"stage2 bf16/bf16 {shape} uncounted, 12-bin depth (pq)",
                  "dfa3d_fwd_mh_c32_bd", (vp.to(bf), dpt_bf, x["locs2"], x["attn2"],
                                      x["heads"], None), time="log")
            # stage 1 at c = 32, which K2 is built for at every type pair
            # though no config reaches it
            for vdt, ddt in ((bf, torch.float32), (torch.float32, torch.float32), (bf, bf)):
                tag = f"{str(vdt)[6:]}/{str(ddt)[6:]}".replace("bfloat16", "bf16").replace(
                    "float32", "f32")
                dfa3d(f"stage1 c=32 {tag} {shape} counted", counter_name(False, True, 32, ddt),
                      (x["value"][..., :32].contiguous().to(vdt), x["depth"].to(ddt),
                       x["locs1"], x["attn1"], 1, x["counts"]),
                      _zeros_past_count(torch, x["counts"]), time="log")
            # a multi-head call with one point: K3's, and counted as K3's
            dfa3d(f"stage2 bf16/f32 {shape} counted, one point", "dfa3d_fwd_mh_c32",
                  (vp.to(bf), x["depth"], x["locs2"][:, :, :, :1].contiguous(),
                   x["attn2"][..., :1].contiguous(), x["heads"], x["counts"]),
                  _zeros_past_count(torch, x["counts"]))

    # the -L configs' instances, K2 at c = 128 and K3 at 16 a head, at the
    # ScanNet200-L level-2 shape (80 x 80 x 32 grid, top-k 51,200, its exact
    # auto budget); K3 beside its time with one query a warp
    lcfg, lscene = _scene_and_cfg(LARGE)
    lbudget = _auto_budget(lcfg, lscene)
    log(f"[kernels] {LARGE} auto visibility budget per level: "
        f"{[round(b, 4) for b in lbudget]}")
    x = _lifting_inputs(torch, dev, lcfg, lscene, 2, lbudget[2], gen)
    shape = f"({N_VIEWS},{x['h']},{x['w']}) K'={x['kb']}"
    for vdt in (torch.bfloat16, torch.float32):
        bf16 = vdt == torch.bfloat16
        tag = "bf16/f32" if bf16 else "f32/f32"
        counts = x["counts"]
        s1 = (x["value"].to(vdt), x["depth"], x["locs1"], x["attn1"], 1, counts)
        dfa3d(f"-L stage1 c=128 {tag} {shape} counted", "dfa3d_fwd_s1_c128", s1,
              _zeros_past_count(torch, counts), time="main" if bf16 else "log",
              earlier="K2 c128 a warp a query" if bf16 else None)
        vp = torch.randn((N_VIEWS, x["h"], x["w"], lcfg.model.embed_dims), device=dev,
                         generator=gen).to(vdt)
        s2 = (vp, x["depth"], x["locs2"], x["attn2"], x["heads"], counts)
        dfa3d(f"-L stage2 c=16 {tag} {shape} counted", "dfa3d_fwd_mh_c16", s2,
              _zeros_past_count(torch, counts), time="main" if bf16 else "log",
              earlier="K3 c16 one query a warp" if bf16 else None)
    del x, s1, s2, vp

    # stage 2 with head groups that fill only part of a warp, every type
    # pair, counted and uncounted
    for name, args in _partial_head_cases(torch, dev, gen):
        counts = args[-1]
        dfa3d(f"stage2 {name}", "dfa3d_fwd_mh_c32_bd" if args[1].dtype == torch.bfloat16
              else "dfa3d_fwd_mh_c32", args,
              None if counts is None else _zeros_past_count(torch, counts))

    # the 2D lifting path: bf16 value with bf16 (uniform) depth, uncounted
    for level in range(3):
        y = _lifting_2d_inputs(torch, dev, cfg, scene, level, gen)
        shape = f"({N_VIEWS},{y['h']},{y['w']}) K={y['k']}"
        s1 = (y["value"], y["ones"], y["locs1"], y["attn1"], 1, None)
        s2 = (y["vp"], y["ones"], y["locs2"], y["attn2"], y["heads"], None)
        last = level == 2
        grid = stage1_grid(y["locs1"], torch.bfloat16)
        library = (lambda: grid_sample_stage1(torch, s1[0], grid)) if last else None
        dfa3d(f"2D stage1 bf16/bf16 {shape}", "dfa3d_fwd_s1_c256_bd", s1,
              time=last and "main", run_library=library, earlier="K2' 2D")
        dfa3d(f"2D stage2 bf16/bf16 {shape}", "dfa3d_fwd_mh_c32_bd", s2,
              time=last and "main", earlier="K3' 2D")
        if last:
            locs_nan = y["locs2"].clone()
            locs_nan.view(-1)[::997] = float("nan")
            dfa3d(f"2D stage2 bf16/bf16 {shape}, NaN locs", "dfa3d_fwd_mh_c32_bd",
                  s2[:2] + (locs_nan,) + s2[3:])
            # F.grid_sample computes the same function as the 2D stage 1
            # (checked at f32: in bf16 it takes its grid in bf16 too, so its
            # bf16 time is for bf16 coordinates; both times are printed)
            v32, grid32 = y["value"].float(), stage1_grid(y["locs1"], torch.float32)
            s1_32 = (v32, y["ones"].float(), y["locs1"], y["attn1"], 1)
            lib = grid_sample_stage1(torch, v32, grid32)[..., 0].transpose(1, 2)
            ker = dfa3d_fwd_cuda(*s1_32)
            torch.cuda.synchronize()
            compare_tensors(torch, f"F.grid_sample vs 2D stage1 f32/f32 {shape}",
                            lib.contiguous(), ker)
            log(f"[kernels] 2D stage1 f32/f32 {shape}: kernel "
                f"{cuda_ms(torch, lambda: dfa3d_fwd_cuda(*s1_32)):.4f} ms, "
                f"F.grid_sample f32 "
                f"{cuda_ms(torch, lambda: grid_sample_stage1(torch, v32, grid32)):.4f} ms")


# ---------------------------------------------------------------------------
# phases 4 and 5: the whole slice
# ---------------------------------------------------------------------------


def _tag(config):
    """A phase's log tag suffix for ``config``: none for ScanNet's."""
    return "" if config == "scannet" else f" {config}"


def _compare_heads(torch, tag, got, want, rel):
    """Identical ``valid`` and every head output within ``rel`` of its
    scale."""
    check(torch.equal(got["valid"], want["valid"]), f"{tag}: valid differs")
    log(f"[{tag}] valid identical ({int(got['valid'].sum())} voxels selected)")
    for lvl, (a, b) in enumerate(zip(got["head_outs"], want["head_outs"])):
        for name, x, y in zip(("centerness", "bbox", "cls"), a, b):
            check(bool(torch.isfinite(x).all()), f"{tag}: non-finite {name} level {lvl}")
            scale = max(1e-3, float(y.abs().max()))
            err = float((x - y).abs().max())
            tol = rel * scale
            log(f"[{tag}] {name} level {lvl}: max_abs_err {err:.3e} (tol {tol:.3e})")
            check(err <= tol, f"{tag}: {name} level {lvl} differs")


@contextlib.contextmanager
def _occupancy_picks_of(torch, tag, ref, limits=None, errs=None):
    """Give a forward the occupancy top-k picks of a reference forward
    (``models/sparse_head.py::top_k_indices``, each level's selection of
    the voxels to lift), for phase 13's f32 runs.  With ``ref`` empty,
    record each call's scores and picks into it; else hold each call's
    scores to the reference's (PICK_SCORE_TOL of their largest), let at
    most PICK_SWAPS_MAX voxels swap sides of the cut, log them, and take
    the reference's picks.  Scores within ``err`` of the reference's can
    only swap voxels whose reference scores lie within 2 ``err`` of its
    k-th; the log gives how far the swapped ones lie and how many lie that
    close.  Kernels and plain versions sum in other orders, so a score
    within rounding of the k-th lands on either side of the cut, and a
    swapped voxel then holds a lifted feature in one run and an upsampled
    one in the other.  ``limits``: per call (the scores' bound, absolute;
    the swaps' bound) in place of these (phase 19's bf16 runs); ``errs``
    collects each call's (scores' error, swaps)."""
    from sgcdet_tpu_torch.models import sparse_head

    top_k = sparse_head.top_k_indices
    recording = not ref
    calls = iter(enumerate(list(ref)))

    def pinned(scores, k):
        own = top_k(scores, k)
        if recording:
            ref.append((scores.detach().clone(), own))
            return own
        i, (want_scores, want) = next(calls)
        tol, max_swaps = (PICK_SCORE_TOL * float(want_scores.abs().max()), PICK_SWAPS_MAX)
        if limits is not None:
            tol, max_swaps = limits[i]
        err = float((scores.detach() - want_scores).abs().max())
        kth = want_scores[want].min()
        near = int(((want_scores - kth).abs() <= 2 * err).sum())
        swapped = torch.cat([own[~torch.isin(own, want)], want[~torch.isin(want, own)]])
        margin = float((want_scores[swapped] - kth).abs().max()) if swapped.numel() else 0.0
        n_swapped = swapped.numel() // 2
        log(f"[{tag}] occupancy top-{k} of {scores.numel()}: scores max_abs_err "
            f"{err:.3e} (tol {tol:.3e}); {n_swapped} picks swapped (at most "
            f"{max_swaps}), at most {margin:.3e} from the reference's k-th score; "
            f"{near} reference scores lie within {2 * err:.3e} of it")
        if errs is not None:
            errs.append((err, n_swapped))
        check(err <= tol, f"{tag}: occupancy scores differ beyond rounding")
        check(n_swapped <= max_swaps, f"{tag}: {n_swapped} occupancy picks swapped")
        return want

    sparse_head.top_k_indices = pinned
    try:
        yield
    finally:
        sparse_head.top_k_indices = top_k


def _per_call_launches(sort_queries, config, train):
    """The launches of each kernel a scene (a step where ``train``) on
    ``config``'s path, sorted or not."""
    large = config in LARGE_CONFIGS
    if train:
        return ((LAUNCHES_PER_STEP_SORTED_LARGE if large else LAUNCHES_PER_STEP_SORTED)
                if sort_queries else LAUNCHES_PER_STEP_LARGE if large else LAUNCHES_PER_STEP)
    return ((LAUNCHES_PER_SCENE_SORTED_LARGE if large else LAUNCHES_PER_SCENE_SORTED)
            if sort_queries else LAUNCHES_PER_SCENE_LARGE if large else LAUNCHES_PER_SCENE)


def phase_slice_f32(torch, dev, sort_queries=False, config="scannet", pin_picks=False,
                    n_views=N_VIEWS):
    """The f32 scene of ``config`` at ``n_views`` through kernels and plain
    versions (with ``pin_picks``, the plain run on the kernel run's
    occupancy picks, ``_occupancy_picks_of``); returns the kernels'
    outputs."""
    from sgcdet_tpu_torch.infer import forward_scene
    from sgcdet_tpu_torch.models import SGCDet
    from sgcdet_tpu_torch.ops import plain_ops

    tag = ("sorted slice f32" if sort_queries else "slice f32") + _tag(config)
    if n_views != N_VIEWS:
        tag += f" {n_views} views"
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, scene = _scene_and_cfg(config, n_views)
    mcfg = dataclasses.replace(cfg.model, compute_dtype="float32",
                               visibility_budget=_auto_budget(cfg, scene),
                               sort_queries=sort_queries)
    model = SGCDet(mcfg, cfg.data.img_shape, device=dev,
                   generator=torch.Generator().manual_seed(0))
    picks = []
    pinned = (lambda name: _occupancy_picks_of(torch, f"{tag}, {name}", picks)
              if pin_picks else contextlib.nullcontext())
    t0 = time.perf_counter()
    with pinned("kernels"):
        out_k = forward_scene(model, scene)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with plain_ops(), pinned("plain"):
        out_p = forward_scene(model, scene)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"[{tag}] forward through kernels {t1 - t0:.3f} s (cold), "
        f"through plain versions {t2 - t1:.3f} s")
    err = float((out_k["dpt_dist"] - out_p["dpt_dist"]).abs().max())
    tol = 1e-4
    log(f"[{tag}] dpt_dist max_abs_err {err:.3e} (tol {tol:.0e})")
    check(err <= tol, f"{tag}: dpt_dist differs")
    _compare_heads(torch, tag, out_k, out_p, 1e-3)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return out_k


def phase_serving(torch, dev, kernels, sort_queries=False, config="scannet",
                  detections=None, n_scenes=SERVE_SCENES, warm_up="detect",
                  n_views=N_VIEWS):
    """``infer.detect`` on ``n_scenes`` scenes after a warm-up: the first
    of them (``warm_up="detect"``) or a forward of the first (``"forward"``,
    every call timed).  Each call's time is split into the forward with the
    copy of its head outputs to the host, the host decode and the NMS
    (``decode_bboxes`` and the NMS it calls, timed inside ``detect``).
    Returns the launches and appends each scene's detections to
    ``detections``."""
    import numpy as np

    from sgcdet_tpu_torch import infer
    from sgcdet_tpu_torch.models import SGCDet, det_head
    from sgcdet_tpu_torch.scene import example_scene

    tag = ("sorted serving" if sort_queries else "serving") + _tag(config)
    if n_views != N_VIEWS:
        tag += f" {n_views} views"
    per_scene = _per_call_launches(sort_queries, config, train=False)
    cfg, _ = _scene_and_cfg(config)
    scenes = [example_scene(cfg.data.img_shape, cfg.data.pad_size, n_views,
                            rng=np.random.RandomState(i), trajectory="indoor")
              for i in range(n_scenes)]
    mcfg = dataclasses.replace(cfg.model, visibility_budget=_auto_budget(cfg, scenes[0]),
                               sort_queries=sort_queries)
    yawed = mcfg.head_type == "sunrgbd"
    log(f"[{tag}] config {config}, compute {mcfg.compute_dtype}, head {mcfg.head_type}, "
        f"{mcfg.n_classes} classes, {mcfg.test_cfg}, budget "
        f"{[round(b, 4) for b in mcfg.visibility_budget]} (K' per level "
        f"{_kept_queries(torch, mcfg)}), sort_queries {sort_queries}, {n_views} views")
    model = SGCDet(mcfg, cfg.data.img_shape, device=dev,
                   generator=torch.Generator().manual_seed(0))
    log(f"[{tag}] parameters: {sum(p.numel() for p in model.parameters())}")
    if warm_up == "forward":
        t0 = time.perf_counter()
        infer.forward_scene(model, scenes[0])
        torch.cuda.synchronize()
        log(f"[{tag}] warm-up forward {time.perf_counter() - t0:.4f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels.values():
        k.launches = 0

    def timed(fn, secs):
        def call(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            secs.append(time.perf_counter() - t)
            return out
        return call

    originals = (infer.decode_bboxes, det_head.box3d_multiclass_nms, det_head.aligned_3d_nms)
    decode_s, nms_s, totals = [], [], []
    infer.decode_bboxes = timed(originals[0], decode_s)
    det_head.box3d_multiclass_nms = timed(originals[1], nms_s)
    det_head.aligned_3d_nms = timed(originals[2], nms_s)
    try:
        for i, scene in enumerate(scenes):
            t0 = time.perf_counter()
            boxes, scores, labels = infer.detect(model, scene)
            totals.append(time.perf_counter() - t0)
            width = 7 if yawed else 6
            check(boxes.ndim == 2 and boxes.shape[1] == width,
                  f"{tag} scene {i}: boxes of shape {boxes.shape}, expected (M, {width})")
            check(np.isfinite(boxes).all() and np.isfinite(scores).all(),
                  f"{tag} scene {i}: non-finite detections")
            if yawed:  # score_thr 0: every class keeps its best candidate
                check(0 < len(boxes) <= mcfg.test_cfg.nms_pre,
                      f"{tag} scene {i}: {len(boxes)} boxes, expected 1 to nms_pre")
            if detections is not None:
                detections.append((boxes, scores, labels))
            log(f"[{tag}] scene {i}{' (warm-up)' if i == 0 and warm_up == 'detect' else ''}: "
                f"{len(boxes)} boxes of width {boxes.shape[1]}, "
                f"{len(set(labels.tolist()))} classes; {totals[-1]:.4f} s: forward + copy "
                f"{totals[-1] - decode_s[-1]:.4f} s, host decode "
                f"{decode_s[-1] - nms_s[-1]:.4f} s, NMS {nms_s[-1]:.4f} s")
    finally:
        infer.decode_bboxes, det_head.box3d_multiclass_nms, det_head.aligned_3d_nms = originals
    launches = {name: k.launches for name, k in kernels.items()}
    warm = slice(1 if warm_up == "detect" else 0, None)
    n = len(totals[warm])
    log(f"[{tag}] warm seconds per scene: {sum(totals[warm]) / n:.4f} (forward + copy "
        f"{sum(t - d for t, d in zip(totals[warm], decode_s[warm])) / n:.4f}, host decode "
        f"{sum(d - m for d, m in zip(decode_s[warm], nms_s[warm])) / n:.4f}, NMS "
        f"{sum(nms_s[warm]) / n:.4f})")
    log(f"[{tag}] peak memory allocated: "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    log(f"[{tag}] kernel launches over {n_scenes} scenes: {_launched(launches)}")
    for name in kernels:
        want = per_scene.get(name, 0) * n_scenes
        check(launches[name] == want,
              f"{name}: {launches[name]} launches, expected {want}")
    return launches


# ---------------------------------------------------------------------------
# phase 3b: backward kernels vs plain at train-path shapes
# ---------------------------------------------------------------------------


def _edge_locs(locs, w, h):
    """A copy of normalized locations with some samples moved onto the
    image's first/last columns and rows and the depth range's ends."""
    locs = locs.clone()
    locs[:, 0::7, ..., 0] = 0.5 / w  # pixel x = 0: only the x1 corners
    locs[:, 1::7, ..., 0] = (w - 0.5) / w  # pixel x = w - 1
    locs[:, 2::7, ..., 1] = 0.0  # pixel y = -0.5: half the corners fall off
    locs[:, 3::7, ..., 1] = 1.0  # pixel y = h - 0.5
    locs[:, 4::7, ..., 2] = 0.0  # depth bin -0.5: lerp against an invalid bin
    locs[:, 5::7, ..., 2] = 1.0
    return locs


def sweep_library_bwd(torch, src, ref, x_eff, y_eff, g):
    """The library call that computes K4's d_src (not d_ref), its operands
    built here, outside the call: aten's grid_sampler_2d_backward of
    F.grid_sample on the (N, C, H, W) src (in f32: the values of a bf16 src
    are exact there) at the grid (N, D*H, W, 2), normalised for
    align_corners=False from the sample coordinates clipped as the kernels
    clip them, for the incoming gradient g * ref / sqrt(C) as (N, C, D*H,
    W); output_mask (True, False), since the sweep has no coordinate
    gradient.  Returns a function of no arguments giving d_src as (N, C, H,
    W)."""
    n, h, w, c = src.shape
    d = x_eff.shape[1]
    src_nchw = src.float().permute(0, 3, 1, 2).contiguous()
    grad = g.view(n, d, h, w, 1) * ref.float().view(n, 1, h, w, c) / math.sqrt(c)
    grad = grad.permute(0, 4, 1, 2, 3).reshape(n, c, d * h, w).contiguous()

    def norm(coord, size):  # pixel = ((norm + 1) * size - 1) / 2
        return (2 * coord.nan_to_num(nan=-4.0).clamp(-4, size + 4) + 1) / size - 1

    grid = torch.stack([norm(x_eff, w), norm(y_eff, h)], -1).view(n, d * h, w, 2)
    return lambda: torch.ops.aten.grid_sampler_2d_backward(
        grad, src_nchw, grid, 0, 0, False, [True, False])[0]


def in_image_corners(x, y, h, w, live=None):
    """The in-image bilinear corners of samples at pixel coordinates x, y,
    clipped and floored as the kernels do, over the samples ``live`` lets
    through (None: all)."""
    x0 = x.nan_to_num(nan=-4.0).clamp(-4, w + 4).floor()
    y0 = y.nan_to_num(nan=-4.0).clamp(-4, h + 4).floor()
    total = 0
    for dy in (0, 1):
        for dx in (0, 1):
            ok = (x0 + dx >= 0) & (x0 + dx <= w - 1) & (y0 + dy >= 0) & (y0 + dy <= h - 1)
            total += int((ok if live is None else ok & live).sum())
    return total


def log_atomics(name, ms, vector, scalar, earlier_scalar):
    """The global atomic operations of one call, counted from the design:
    16-byte vector reductions and scalar f32 atomics apart, their rate at
    the kernel's time, and the scalar count of the design before vector
    reductions (one atomicAdd per channel)."""
    log(f"[kernels] {name}: global atomics {vector:.4e} vector (16 B) + "
        f"{scalar:.4e} scalar, {(vector + scalar) / (ms * 1e-3):.4e} operations/s; "
        f"scalar-only design {earlier_scalar:.4e}")


def dfa3d_atomics(locs, counts, h, w, dsize, c, depth_grad=True):
    """(vector, scalar, earlier scalar) global atomics of one DFA3D backward
    call: per in-image corner of a counted sample c / 4 vector d_value
    reductions (c scalar ones before), and one scalar d_dpt atomic per
    depth bin of the lerp that lies in range with a nonzero weight."""
    import torch

    live = None
    if counts is not None:
        q = torch.arange(locs.shape[1], device=locs.device)
        live = (q[None, :, None, None] < counts[:, None, None, None]).expand(locs.shape[:4])
    x, y = locs[..., 0] * w - 0.5, locs[..., 1] * h - 0.5
    corners = in_image_corners(x, y, h, w, live)
    depth = 0
    if depth_grad:  # a bin in range with a nonzero lerp weight
        dd = (locs[..., 2] * dsize - 0.5).nan_to_num(nan=-4.0).clamp(-4, dsize + 4)
        d0 = dd.floor()
        for bin_, weighted in ((d0, True), (d0 + 1, dd != d0)):
            ok = (bin_ >= 0) & (bin_ <= dsize - 1) & weighted
            depth += in_image_corners(x, y, h, w, ok if live is None else ok & live)
    return corners * c // 4, depth, corners * c + depth


def _exact_centres(size):
    """Pixels p whose centre location (p + 0.5) / size is exact in f32, so
    that loc * size - 0.5 is p under any rounding (fused or not)."""
    import numpy as np

    return [p for p in range(size)
            if float(np.float32((p + 0.5) / size)) * size == p + 0.5]


def _misaligned(torch, t):
    """A contiguous copy of ``t`` starting one element past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    check(view.data_ptr() % 16 != 0, "the misaligned view is aligned")
    return view


def _sweep_contention_cases(torch, dev, gen, n, h, w, d):
    """Sweep inputs that pile samples onto few src rows: at the depth net's
    shape, every 8 x 16 tile of reference pixels samples one fractional src
    point per plane; on a 13 x 21 map, integer coordinates from -1 to the
    size (first and last row and column included) on all planes but the
    first, which lies behind the source camera (z < 0 at every pixel)."""
    c = 128
    ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                            indexing="ij")
    tile = ((ys // 8) * -(-w // 16) + xs // 16).reshape(-1)
    ntiles = int(tile.max()) + 1
    px = torch.rand((n, d, ntiles), device=dev, generator=gen) * w - 0.5
    py = torch.rand((n, d, ntiles), device=dev, generator=gen) * h - 0.5
    cases = [("tile collapse", (n, h, w), px[..., tile].contiguous(),
              py[..., tile].contiguous())]
    h2, w2 = 13, 21
    x = torch.randint(-1, w2 + 1, (n, d, h2 * w2), device=dev, generator=gen).float()
    y = torch.randint(-1, h2 + 1, (n, d, h2 * w2), device=dev, generator=gen).float()
    x[..., ::5], y[..., 1::5], x[..., 2::7], y[..., 3::7] = w2 - 1, h2 - 1, 0, 0
    # plane 0 at depth 0.5 behind a source camera 1.0 ahead: z = -0.5
    yy, xx = torch.meshgrid(torch.arange(h2, device=dev), torch.arange(w2, device=dev),
                            indexing="ij")
    z = -0.5
    x[:, 0] = (xx.reshape(-1) * 0.5 + 0.3) / z * (w2 / (w2 - 1)) - 0.5
    y[:, 0] = (yy.reshape(-1) * 0.5 - 0.2) / z * (h2 / (h2 - 1)) - 0.5
    cases.append(("integer grid, plane 0 behind the camera", (n, h2, w2), x, y))
    out = []
    for name, (nn, hh, ww), xe, ye in cases:
        g = torch.randn(xe.shape, device=dev, generator=gen)
        for dt in (torch.bfloat16, torch.float32):
            src = torch.randn((nn, hh, ww, c), device=dev, generator=gen).to(dt)
            ref = torch.randn((nn, hh, ww, c), device=dev, generator=gen).to(dt)
            out.append((f"sweep bwd {str(dt)[6:]} ({nn},{hh},{ww},{c}) D={d} {name}",
                        (src, ref, xe, ye, g)))
    return out


def s1_lists(locs, counts, h, w):
    """What the stage-1 backward's lists hold for one call: its entries
    (the in-image corners of the counted samples, each on one pixel), the
    pixels they fall on, the longest list and the lists longer than the
    pixel pass takes (32 entries: the long pass's)."""
    import torch

    n, k = locs.shape[:2]
    x = (locs[..., 0] * w - 0.5).nan_to_num(nan=-4.0).clamp(-4, w + 4).floor().long()
    y = (locs[..., 1] * h - 0.5).nan_to_num(nan=-4.0).clamp(-4, h + 4).floor().long()
    live = torch.ones(x.shape, dtype=torch.bool, device=locs.device)
    if counts is not None:
        q = torch.arange(k, device=locs.device)
        live = (q[None, :] < counts[:, None]).view(n, k, 1, 1).expand(x.shape)
    cam = torch.arange(n, device=locs.device).view(n, 1, 1, 1).expand(x.shape)
    pix = []
    for dy in (0, 1):
        for dx in (0, 1):
            ok = live & (x + dx >= 0) & (x + dx < w) & (y + dy >= 0) & (y + dy < h)
            pix.append(((cam * h + y + dy) * w + x + dx)[ok])
    per_pixel = torch.cat(pix).unique(return_counts=True)[1]
    return (f"{int(per_pixel.sum())} entries on {per_pixel.numel()} pixels, longest "
            f"list {int(per_pixel.max()) if per_pixel.numel() else 0}, "
            f"{int((per_pixel > 32).sum())} lists longer than 32")


def phase_backward(torch, dev, report):
    from sgcdet_tpu_torch.ops.dfa3d import dfa3d_bwd_cuda, dfa3d_bwd_plain
    from sgcdet_tpu_torch.ops.sweep import sweep_bwd_cuda, sweep_bwd_plain

    cfg, scene = _scene_and_cfg()
    budget = _auto_budget(cfg, scene)
    gen = torch.Generator(device=dev).manual_seed(1)
    names = ("d_value", "d_dpt", "d_locs", "d_attn")

    def compare(name, kernel_name, run_kernel, run_plain, labels, extra=None):
        outs_k = run_kernel()
        outs_p = run_plain()
        torch.cuda.synchronize()
        err = 0.0
        for label, got, want in zip(labels, outs_k, outs_p):
            if want is None:
                check(got is None, f"{name} {label}: kernel returned a gradient "
                                   "the plain version did not")
                continue
            err = max(err, compare_tensors(torch, f"{name} {label}", got, want,
                                           f32_rel=1e-5))
        if extra is not None:
            extra(outs_k)
        rec = report[kernel_name]
        rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err)

    def dfa3d(name, kernel_name, args, sample_grads=True, extra=None, time=None,
              depth_grad=True, run_library=None, earlier=None):
        """args: (value, depth, locs, attn, g, heads, counts); time: None,
        "log" or "main", as in phase 3."""
        kw = dict(sample_grads=sample_grads, depth_grad=depth_grad)

        def run_k():
            return dfa3d_bwd_cuda(*args, **kw)

        def run_p():
            return dfa3d_bwd_plain(*args, **kw)

        name = (f"{name}, sample grads {sample_grads}"
                + ("" if depth_grad else ", no depth grad"))
        compare(name, kernel_name, run_k, run_p, names, extra)
        if time:
            ms = _timing(torch, report, name, kernel_name, run_k, run_p,
                         lambda outs: dfa3d_work(args[:5], outs, args[6], True,
                                                 dot=sample_grads or depth_grad),
                         run_library, main=time == "main", earlier=earlier)
            value, depth, locs = args[:3]
            h, w = value.shape[1:3]
            if locs.shape[2] == locs.shape[3] == 1:  # K6, K6': lists, no atomics
                log(f"[kernels] {name}: {s1_lists(locs, args[6], h, w)}")
            else:
                log_atomics(name, ms, *dfa3d_atomics(
                    locs, args[6], h, w, depth.shape[-1], value.shape[-1] // args[5],
                    depth_grad))

    for name, src, ref, xe, ye in _sweep_cases(torch, dev, cfg, scene, gen):
        g = torch.randn(xe.shape, device=dev, generator=gen)
        args = (src, ref, xe, ye, g)
        name = name.replace("sweep", "sweep bwd")
        compare(name, "sweep_bwd", lambda: sweep_bwd_cuda(*args),
                lambda: sweep_bwd_plain(*args), ("d_src", "d_ref"))
        # aten's grid_sampler_2d_backward computes d_src (checked at f32)
        library = sweep_library_bwd(torch, *args)
        if src.dtype == torch.float32:
            compare_tensors(torch, f"grid_sampler_2d_backward vs {name} d_src",
                            library().permute(0, 2, 3, 1).contiguous(),
                            sweep_bwd_cuda(*args)[0], f32_rel=1e-5)
        ms = _timing(torch, report, name, "sweep_bwd", lambda: sweep_bwd_cuda(*args),
                     lambda: sweep_bwd_plain(*args),
                     lambda outs: sweep_work(args, outs, True), library,
                     main=src.dtype == torch.bfloat16)
        del library
        h, w, c = src.shape[1:]
        corners = in_image_corners(xe, ye, h, w)
        log_atomics(name, ms, corners * c // 4, 0, corners * c)
        if src.dtype == torch.bfloat16:
            mis = (_misaligned(torch, src), _misaligned(torch, ref)) + args[2:]
            compare(f"{name}, src and ref misaligned views", "sweep_bwd",
                    lambda: sweep_bwd_cuda(*mis), lambda: sweep_bwd_plain(*mis),
                    ("d_src", "d_ref"))
    for name, args in _sweep_contention_cases(torch, dev, gen, N_VIEWS, 60, 80, 12):
        compare(name, "sweep_bwd", lambda: sweep_bwd_cuda(*args),
                lambda: sweep_bwd_plain(*args), ("d_src", "d_ref"))

    for level in range(3):
        x = _lifting_inputs(torch, dev, cfg, scene, level, budget[level], gen)
        shape = f"({N_VIEWS},{x['h']},{x['w']}) K'={x['kb']}"
        counts = x["counts"]
        past_zero = _zeros_past_count(torch, counts, rows=2)
        for vdt in (torch.bfloat16, torch.float32):
            tag = "bf16/f32" if vdt == torch.bfloat16 else "f32/f32"
            value = x["value"].to(vdt)
            g1 = torch.randn((N_VIEWS, x["kb"], value.shape[-1]), device=dev,
                             generator=gen).to(vdt)
            locs1 = _edge_locs(x["locs1"], x["w"], x["h"])
            s1 = (value, x["depth"], locs1, x["attn1"], g1, 1, counts)
            dfa3d(f"stage1 bwd {tag} {shape} counted", "dfa3d_bwd_s1_c256", s1, True,
                  past_zero)
            # stage 1 as the model runs it: no location/attention grads
            timed = level == 2 and ("main" if vdt == torch.bfloat16 else "log")
            dfa3d(f"stage1 bwd {tag} {shape} counted", "dfa3d_bwd_s1_c256", s1, False,
                  time=timed, earlier="K6" if timed == "main" else None)
            vp = torch.randn((N_VIEWS, x["h"], x["w"], value.shape[-1]),
                             device=dev, generator=gen).to(vdt)
            locs2 = _edge_locs(x["locs2"], x["w"], x["h"])
            s2 = (vp, x["depth"], locs2, x["attn2"], g1, x["heads"], counts)
            dfa3d(f"stage2 bwd {tag} {shape} counted", "dfa3d_bwd_mh_c32", s2,
                  extra=past_zero, time=timed)
            if level == 2 and vdt == torch.bfloat16:
                locs_nan = locs2.clone()
                locs_nan.view(-1)[::997] = float("nan")
                dfa3d(f"stage2 bwd {tag} {shape} uncounted, NaN locs", "dfa3d_bwd_mh_c32",
                      (vp, x["depth"], locs_nan, x["attn2"], g1, x["heads"], None))
                dfa3d(f"stage2 bwd {tag} {shape} counted, value and g misaligned views",
                      "dfa3d_bwd_mh_c32", (_misaligned(torch, vp), x["depth"], locs2,
                                       x["attn2"], _misaligned(torch, g1)) + s2[5:],
                      extra=past_zero)
            if level == 2:
                # contention: all heads and points of a query on one pixel
                # centre (an exact one, so every rounding floors it alike),
                # a few centres per view; view 0 counted to 0
                cx = torch.tensor(_exact_centres(x["w"]), device=dev)
                cy = torch.tensor(_exact_centres(x["h"]), device=dev)
                pick = torch.randint(0, cx.numel() * cy.numel(), (N_VIEWS, x["kb"]),
                                     device=dev, generator=gen)
                one = locs2.clone()
                one[..., 0] = ((cx[pick % cx.numel()] + 0.5) / x["w"])[:, :, None, None]
                one[..., 1] = ((cy[pick // cx.numel()] + 0.5) / x["h"])[:, :, None, None]
                c0 = counts.clone()
                c0[0] = 0
                ddt = [x["depth"]] + ([x["depth"].to(vdt)] if vdt == torch.bfloat16 else [])
                for dpt in ddt:
                    dtag = tag if dpt.dtype == torch.float32 else "bf16/bf16"
                    dfa3d(f"stage2 bwd {dtag} {shape} one pixel centre per query "
                          f"({cx.numel() * cy.numel()} centres), view 0 counted to 0",
                          "dfa3d_bwd_mh_c32" if dpt.dtype == torch.float32 else "dfa3d_bwd_mh_c32_bd",
                          (vp, dpt, one, x["attn2"], g1, x["heads"], c0),
                          extra=_zeros_past_count(torch, c0, rows=2))
                # stage 1's long lists: every query of a view on one pixel
                # centre (each view its own), all of them counted but in
                # view 0, which is counted to 0: four lists of K' entries
                # a view
                pv = torch.arange(N_VIEWS, device=dev)
                one1 = locs1.clone()
                one1[..., 0] = ((cx[pv % cx.numel()] + 0.5) / x["w"])[:, None, None, None]
                one1[..., 1] = ((cy[pv % cy.numel()] + 0.5) / x["h"])[:, None, None, None]
                call = torch.full_like(counts, x["kb"])
                call[0] = 0
                for dpt in ddt:
                    dtag = tag if dpt.dtype == torch.float32 else "bf16/bf16"
                    s1_long = (value, dpt, one1, x["attn1"], g1, 1, call)
                    k6 = "dfa3d_bwd_s1_c256" if dpt.dtype == torch.float32 else "dfa3d_bwd_s1_c256_bd"
                    name1 = (f"stage1 bwd {dtag} {shape} every query of a view on one "
                             f"pixel centre, view 0 counted to 0")
                    dfa3d(name1, k6, s1_long, True, _zeros_past_count(torch, call, rows=2))
                    dfa3d(name1, k6, s1_long, False, time="log")
            if level == 2 and vdt == torch.float32:
                # the v1 (_bwd_kernel) and v3 (_bwd_kernel_q / _q_s1) rows:
                # uncounted f32
                dfa3d(f"stage1 bwd {tag} {shape} uncounted (v3 q_s1)", "dfa3d_bwd_s1_c256",
                      s1[:6] + (None,), time="log", earlier="K6 f32/f32 uncounted")
                dfa3d(f"stage2 bwd {tag} {shape} uncounted (v1, v3 q)",
                      "dfa3d_bwd_mh_c32", s2[:6] + (None,), time="log")
            if level == 2 and vdt == torch.bfloat16:
                # the backward of pq_s1c and of the bf16 multi-head with a
                # real 12-bin depth in bf16
                dpt_bf = x["depth"].to(torch.bfloat16)
                dfa3d(f"stage1 bwd bf16/bf16 {shape} counted, 12-bin depth",
                      "dfa3d_bwd_s1_c256_bd", (value, dpt_bf) + s1[2:], True, past_zero,
                      time="log")
                dfa3d(f"stage2 bwd bf16/bf16 {shape} uncounted, 12-bin depth",
                      "dfa3d_bwd_mh_c32_bd", (vp, dpt_bf) + s2[2:6] + (None,),
                      time="log")

    # the -L configs' instances, K6 at c = 128 and K5 at 16 a head (two
    # queries a warp), at the ScanNet200-L level-2 shape, with the model's
    # gradients and all of them; K6's long lists: every query of a view on
    # one pixel centre, view 0 counted to 0 (lists of K' entries)
    lcfg, lscene = _scene_and_cfg(LARGE)
    x = _lifting_inputs(torch, dev, lcfg, lscene, 2, _auto_budget(lcfg, lscene)[2], gen)
    shape = f"({N_VIEWS},{x['h']},{x['w']}) K'={x['kb']}"
    counts = x["counts"]
    past_zero = _zeros_past_count(torch, counts, rows=2)
    for vdt in (torch.bfloat16, torch.float32):
        bf16 = vdt == torch.bfloat16
        tag = "bf16/f32" if bf16 else "f32/f32"
        timed = "main" if bf16 else "log"
        value = x["value"].to(vdt)
        g1 = torch.randn((N_VIEWS, x["kb"], value.shape[-1]), device=dev,
                         generator=gen).to(vdt)
        locs1 = _edge_locs(x["locs1"], x["w"], x["h"])
        s1 = (value, x["depth"], locs1, x["attn1"], g1, 1, counts)
        dfa3d(f"-L stage1 bwd c=128 {tag} {shape} counted", "dfa3d_bwd_s1_c128", s1, True,
              past_zero)
        dfa3d(f"-L stage1 bwd c=128 {tag} {shape} counted", "dfa3d_bwd_s1_c128", s1, False,
              time=timed)
        vp = torch.randn((N_VIEWS, x["h"], x["w"], value.shape[-1]), device=dev,
                         generator=gen).to(vdt)
        s2 = (vp, x["depth"], _edge_locs(x["locs2"], x["w"], x["h"]), x["attn2"], g1,
              x["heads"], counts)
        dfa3d(f"-L stage2 bwd c=16 {tag} {shape} counted", "dfa3d_bwd_mh_c16", s2,
              extra=past_zero, time=timed,
              earlier="K5 c16 one query a warp" if bf16 else None)
        if bf16:
            cx = torch.tensor(_exact_centres(x["w"]), device=dev)
            cy = torch.tensor(_exact_centres(x["h"]), device=dev)
            pv = torch.arange(N_VIEWS, device=dev)
            one1 = locs1.clone()
            one1[..., 0] = ((cx[pv % cx.numel()] + 0.5) / x["w"])[:, None, None, None]
            one1[..., 1] = ((cy[pv % cy.numel()] + 0.5) / x["h"])[:, None, None, None]
            call = torch.full_like(counts, x["kb"])
            call[0] = 0
            s1_long = (value, x["depth"], one1, x["attn1"], g1, 1, call)
            name1 = (f"-L stage1 bwd c=128 {tag} {shape} every query of a view on one "
                     f"pixel centre, view 0 counted to 0")
            dfa3d(name1, "dfa3d_bwd_s1_c128", s1_long, True,
                  _zeros_past_count(torch, call, rows=2))
            dfa3d(name1, "dfa3d_bwd_s1_c128", s1_long, False, time="log")
    del x, s1, s2, vp, g1, value

    # stage 2 with head groups that fill only part of a warp (the lanes K5
    # masks past the last head), every type pair, counted and uncounted
    for name, (value, dpt, locs, attn, heads, counts) in _partial_head_cases(
            torch, dev, gen):
        g = torch.randn(locs.shape[:2] + value.shape[-1:], device=dev,
                        generator=gen).to(value.dtype)
        dfa3d(f"stage2 bwd {name}", "dfa3d_bwd_mh_c32_bd" if dpt.dtype == torch.bfloat16
              else "dfa3d_bwd_mh_c32", (value, dpt, locs, attn, g, heads, counts),
              extra=None if counts is None else _zeros_past_count(torch, counts, rows=2))

    # the 2D lifting path: bf16 value with bf16 (uniform) depth, uncounted;
    # as the module runs it: no depth gradient (the uniform depth is a
    # constant), and at stage 1 no location/attention gradients either
    for level in range(3):
        y = _lifting_2d_inputs(torch, dev, cfg, scene, level, gen)
        shape = f"({N_VIEWS},{y['h']},{y['w']}) K={y['k']}"
        g = torch.randn((N_VIEWS, y["k"], y["value"].shape[-1]), device=dev,
                        generator=gen).to(torch.bfloat16)
        locs1 = _edge_locs(y["locs1"], y["w"], y["h"])
        locs1[..., 2] = 0.5
        s1 = (y["value"], y["ones"], locs1, y["attn1"], g, 1, None)
        s2 = (y["vp"], y["ones"], y["locs2"], y["attn2"], g, y["heads"], None)
        last = level == 2
        grid = stage1_grid(locs1, torch.bfloat16)
        library = (lambda: grid_sample_stage1_bwd(torch, g, s1[0], grid)) if last else None
        dfa3d(f"2D stage1 bwd bf16/bf16 {shape}", "dfa3d_bwd_s1_c256_bd", s1, False,
              time=last and "main", depth_grad=False, run_library=library,
              earlier="K6' 2D" if last else None)
        dfa3d(f"2D stage2 bwd bf16/bf16 {shape}", "dfa3d_bwd_mh_c32_bd", s2,
              time=last and "main", depth_grad=False)
        if last:
            # ... with the depth gradient (the value gather, the dot products
            # and the depth atomics on top of the scatter), and every gradient
            dfa3d(f"2D stage1 bwd bf16/bf16 {shape}", "dfa3d_bwd_s1_c256_bd", s1, False,
                  time="log")
            dfa3d(f"2D stage1 bwd bf16/bf16 {shape}", "dfa3d_bwd_s1_c256_bd", s1, True,
                  time="log")
            dfa3d(f"2D stage2 bwd bf16/bf16 {shape}", "dfa3d_bwd_mh_c32_bd", s2,
                  time="log")
            locs_nan = y["locs2"].clone()
            locs_nan.view(-1)[::997] = float("nan")
            dfa3d(f"2D stage2 bwd bf16/bf16 {shape}, NaN locs", "dfa3d_bwd_mh_c32_bd",
                  s2[:2] + (locs_nan,) + s2[3:])
            # aten's grid_sampler_2d_backward computes the 2D stage 1's
            # d_value (checked at f32, as the forward's yardstick)
            v32, g32 = y["value"].float(), g.float()
            grid32 = stage1_grid(locs1, torch.float32)
            s1_32 = (v32, y["ones"].float(), locs1, y["attn1"], g32, 1, None)
            kw = dict(sample_grads=False, depth_grad=False)
            lib, lib_grid = grid_sample_stage1_bwd(torch, g32, v32, grid32)
            ker = dfa3d_bwd_cuda(*s1_32, **kw)[0]
            torch.cuda.synchronize()
            compare_tensors(torch, f"grid_sampler_2d_backward vs 2D stage1 bwd "
                            f"f32/f32 {shape} d_value",
                            lib.permute(0, 2, 3, 1).contiguous(), ker, f32_rel=1e-5)
            log(f"[kernels] 2D stage1 bwd f32/f32 {shape}: kernel "
                f"{cuda_ms(torch, lambda: dfa3d_bwd_cuda(*s1_32, **kw)):.4f} ms, "
                f"grid_sampler_2d_backward f32 "
                f"{cuda_ms(torch, lambda: grid_sample_stage1_bwd(torch, g32, v32, grid32)):.4f}"
                f" ms (grid gradient {'computed' if lib_grid is not None else 'skipped'})")


# ---------------------------------------------------------------------------
# phases 6 and 7: the train step
# ---------------------------------------------------------------------------


# the frozen BN epilogue's cases (phase 3c): label, (N, C, H, W), with the
# identity, with the ReLU.  The first two are the main path's serving
# shapes (stage 1's last bn3 and stage 4's at 100 views), then the stem's
# and a downsample's, and a width whose rows fill no block (24 channels: 3
# lanes a row, 85 rows a block of 255 threads) on a ragged row count
FROZEN_BN_CASES = (("stage 1 bn3", (100, 256, 60, 80), True, True),
                   ("stage 4 bn3", (100, 2048, 8, 10), True, True),
                   ("stem bn1", (100, 64, 120, 160), False, True),
                   ("stage 1 downsample", (100, 256, 60, 80), False, False),
                   ("ragged", (3, 24, 5, 7), True, True))


def frozen_bn_inputs(torch, dev, shape, identity, dtype, gen):
    """Seeded channels-last x (a conv output with an offset), identity and
    incoming gradient g, and f32 BN parameters (weight, bias, running mean,
    running variance) of ``shape``'s channels."""
    n, c, h, w = shape

    def normal(*size, scale=1.0, offset=0.0):
        return torch.randn(*size, generator=gen, device=dev) * scale + offset

    def act(scale=1.0, offset=0.0):
        return normal(n, c, h, w, scale=scale, offset=offset).to(dtype).contiguous(
            memory_format=torch.channels_last)

    x = act(2.0, 0.3)
    ident = act() if identity else None
    g = act()
    params = (torch.rand(c, generator=gen, device=dev) + 0.5, normal(c, scale=0.2),
              normal(c, scale=0.5), torch.rand(c, generator=gen, device=dev) * 2 + 0.25)
    return x, ident, params, g


def phase_frozen_bn(torch, dev, report):
    """ResNet-50's frozen BN epilogue (``ops/frozen_bn.py``) on the card:
    forward and backward kernels against their plain versions, twice
    bit-identical, timed beside the plain version and the chain the model
    ran before (NCHW ``F.batch_norm`` + casts + add + ReLU), and refusing
    what they do not take."""
    import torch.nn.functional as F

    from sgcdet_tpu_torch.ops import KERNELS, LIBRARY
    from sgcdet_tpu_torch.ops.frozen_bn import (frozen_bn_bwd_cuda, frozen_bn_bwd_plain,
                                                frozen_bn_fwd_cuda, frozen_bn_plain)

    eps = 1e-5
    gen = torch.Generator(device=dev).manual_seed(3)

    def within(name, got, want, tol, kernel_name):
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        worst = float((diff / tol.clamp_min(1e-30)).max())
        ok = bool(torch.isfinite(got).all()) and bool((diff <= tol).all())
        log(f"[frozen bn] {name}: max_abs_err {err:.3e}, worst err/tol {worst:.3f} "
            f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{name}: kernel disagrees with plain version")
        rec = report[kernel_name]
        rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err)

    def launched_once(kernel_name, fn):
        before = KERNELS[kernel_name].launches
        out = fn()
        check(KERNELS[kernel_name].launches == before + 1, f"{kernel_name} did not launch once")
        return out

    for (label, shape, identity, relu), dtype in (
            [(case, torch.bfloat16) for case in FROZEN_BN_CASES]
            + [(FROZEN_BN_CASES[0], torch.float32), (FROZEN_BN_CASES[4], torch.float32)]):
        name = f"{label} {tuple(shape)} {str(dtype)[6:]}"
        x, ident, params, g = frozen_bn_inputs(torch, dev, shape, identity, dtype, gen)
        w, b, mean, var = params
        args = (x, ident, w, b, mean, var, eps, relu)
        y = launched_once("frozen_bn_fwd", lambda: frozen_bn_fwd_cuda(*args))
        check(y.is_contiguous(memory_format=torch.channels_last), f"{name}: y not channels-last")
        y_plain = frozen_bn_plain(*args)
        bn = F.batch_norm(x.float(), mean, var, w, b, False, 0.0, eps)
        mag = torch.maximum(bn.abs(), y_plain.float().abs())
        if identity:
            mag = torch.maximum(mag, ident.float().abs())
        # bf16: one ulp of the larger of |bn(x)|, |identity| and |y| (the
        # plain version rounds bn(x) and the sum, the kernel their sum
        # once); f32: the two affine forms' rounding
        unit = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -21
        within(f"{name} y", y, y_plain, unit * mag + 1e-6 * float(mag.max()), "frozen_bn_fwd")
        check(torch.equal(frozen_bn_fwd_cuda(*args), y), f"{name}: forward not bit-identical")

        bwd_args = (g, x, y, w, mean, var, eps, relu, identity)
        outs = launched_once("frozen_bn_bwd", lambda: frozen_bn_bwd_cuda(*bwd_args))
        want = frozen_bn_bwd_plain(*bwd_args)
        again = frozen_bn_bwd_cuda(*bwd_args)
        check(all(a is b_ or torch.equal(a, b_) for a, b_ in zip(outs, again)),
              f"{name}: backward not bit-identical")
        dx, d_id, d_w, d_b = outs
        check(dx.is_contiguous(memory_format=torch.channels_last), f"{name}: dx not channels-last")
        within(f"{name} dx", dx, want[0], unit * want[0].float().abs()
               + 1e-6 * float(want[0].float().abs().max()), "frozen_bn_bwd")
        check(d_id is None if not identity else torch.equal(d_id, want[1]),
              f"{name}: d_identity is not g'")
        # the sums: f32 summation error, 1e-5 of the sum of the terms' magnitudes
        gp = torch.where(y <= 0, 0.0, g.float()) if relu else g.float()
        inv = torch.rsqrt(var + eps)
        within(f"{name} d_bias", d_b, want[3], 1e-5 * gp.abs().sum((0, 2, 3)) + 1e-30,
               "frozen_bn_bwd")
        within(f"{name} d_weight", d_w, want[2],
               1e-5 * (gp * (x.float() - mean[:, None, None])).abs().sum((0, 2, 3)) * inv
               + 1e-30, "frozen_bn_bwd")
        if relu:  # where the kernel's y and the plain version's take other sides of 0
            flips = int(((y > 0) != (y_plain > 0)).sum())
            log(f"[frozen bn] {name}: {flips} of {y.numel()} outputs ({flips / y.numel():.2e}) "
                "on the other side of 0 than the plain version's")
            check(flips <= 1e-2 * y.numel(), f"{name}: {flips} ReLU decisions differ")

        if dtype != torch.bfloat16 or label == "ragged":
            continue
        # timing: kernel, plain version on the same channels-last tensors, and
        # the chain as the model ran it before (NCHW tensors, cuDNN's BN)
        xn, idn, gn = (None if t is None else t.contiguous() for t in (x, ident, g))

        def chain(xx, ii):
            return frozen_bn_plain(xx, ii, w, b, mean, var, eps, relu)

        # the bound: x, identity, y once (forward); g, x, y, dx, d_identity
        # once (backward), where the case has them
        elems = x.numel() * x.element_size()
        fwd_bytes = elems * (2 + identity)
        bwd_bytes = elems * (3 + relu + (relu and identity))
        main = label == FROZEN_BN_CASES[0][0]
        _timing(torch, report, f"frozen bn fwd {name}", "frozen_bn_fwd",
                lambda: frozen_bn_fwd_cuda(*args), lambda: chain(x, ident),
                lambda outs: (fwd_bytes, 0), run_library=lambda: chain(xn, idn), main=main)
        wl, bl = w.detach().requires_grad_(), b.detach().requires_grad_()
        graphs = []
        for xx, ii, gg in ((x, ident, g), (xn, idn, gn)):
            ins = [t.detach().requires_grad_() for t in (xx, ii) if t is not None]
            out = frozen_bn_plain(ins[0], ins[1] if identity else None, wl, bl, mean, var,
                                  eps, relu)
            graphs.append((out, ins + [wl, bl], gg))

        def autograd_bwd(out, ins, gg):
            return lambda: torch.autograd.grad(out, ins, gg, retain_graph=True)

        _timing(torch, report, f"frozen bn bwd {name}", "frozen_bn_bwd",
                lambda: frozen_bn_bwd_cuda(*bwd_args), autograd_bwd(*graphs[0]),
                lambda outs: (bwd_bytes, 0), run_library=autograd_bwd(*graphs[1]), main=main)
        del graphs

    # refusals: NCHW memory, a type without a kernel, widths without a block
    x, ident, params, g = frozen_bn_inputs(torch, dev, (2, 64, 6, 10), True, torch.bfloat16, gen)
    for what, args, error in (
            ("NCHW x", (x.contiguous(), None), ValueError),
            ("NCHW identity", (x, ident.contiguous()), ValueError),
            ("float16", (x.half(), None), TypeError),
            ("identity of another dtype", (x, ident.float()), TypeError)):
        try:
            frozen_bn_fwd_cuda(*args, *params, eps, True)
        except error:
            log(f"[frozen bn] refuses {what}")
        else:
            raise SmokeFailure(f"frozen_bn_fwd_cuda took {what}")
    for c in (12, 2056):
        x, _, params, _ = frozen_bn_inputs(torch, dev, (1, c, 2, 2), False, torch.bfloat16, gen)
        try:
            frozen_bn_fwd_cuda(x, None, *params, eps, True)
        except ValueError:
            log(f"[frozen bn] refuses {c} channels")
        else:
            raise SmokeFailure(f"frozen_bn_fwd_cuda took {c} channels")
    found = ptxas_resources(LIBRARY.log)
    parts = [f"{name} {regs} registers, {spill} B spill stores"
             for name, (regs, spill) in sorted(found.items()) if "frozen_bn" in name]
    log("[frozen bn] ptxas: " + ("; ".join(parts) if parts else "not built by this process"))
    torch.cuda.synchronize()


def _train_parts(torch, dev, config="scannet", n_views=None, **model_kw):
    """bench.py's train setting (exact auto budget, depth loss on) of
    ``config`` on the indoor train scene of ``n_views`` views (N_VIEWS by
    default; its yawed ground truth for the ARKit head), with ``model_kw``
    overrides: (config, scene, model from a seeded init, optimizer)."""
    from sgcdet_tpu_torch.scene import example_train_scene
    from sgcdet_tpu_torch.train import init_train_state

    n_views = n_views or N_VIEWS
    cfg, scene = _scene_and_cfg(config, n_views)
    mcfg = dataclasses.replace(cfg.model, visibility_budget=_auto_budget(cfg, scene),
                               depth_loss=True, **model_kw)
    cfg = dataclasses.replace(cfg, model=mcfg)
    scene = example_train_scene(cfg.data.img_shape, cfg.data.pad_size, n_views,
                                mcfg.n_classes, mcfg.downsample_factor,
                                yawed=mcfg.head_type == "sunrgbd")
    model, optimizer = init_train_state(cfg, torch.Generator().manual_seed(0), dev)
    return cfg, scene, model, optimizer


def _train_setup(torch, dev, config="scannet", n_views=None, **model_kw):
    """``_train_parts`` with the single-device step in place of the
    optimizer."""
    from sgcdet_tpu_torch.train import make_train_step

    cfg, scene, model, optimizer = _train_parts(torch, dev, config, n_views, **model_kw)
    return cfg, scene, model, make_train_step(model, cfg, optimizer)


@contextlib.contextmanager
def _relu_signs_of(torch, tag, ref, views=None):
    """Give a train step the side of 0 of every ReLU input of a reference
    step (``F.relu``, which ``nn.ReLU`` calls too).  With ``ref`` empty,
    record the signs into it; else hold each input whose sign differs to
    1e-4 of its call's largest magnitude (the forward kernels' f32 bound),
    log how many differ, and take the reference's.  Kernels and plain
    versions sum in other orders, so an input within rounding of 0 lands
    on either side: the forward moves by that rounding only, but the
    backward passes or stops a whole gradient element there.  Where the
    loss's gradient sits on a few voxels (the FCOS positives of the -L
    step), one such ReLU in the 3D neck moves a weight gradient by percents
    of its scale.  ``views`` (rank, world): the step is a view-sharded
    rank's, whose per-view inputs take their views' rows of the
    reference's signs; a reference entry may be packed (``_pack_bits``).
    A frozen BN's ReLU (ResNet-50's, inside ``ops.frozen_bn``'s kernel)
    runs as the op without it and the pinned ReLU."""
    from torch.nn import functional as F

    from sgcdet_tpu_torch.models import layers
    from sgcdet_tpu_torch.models.layers import is_channels_last

    relu = F.relu
    recording = not ref
    signs = iter(list(ref))
    flips = []  # per call: inputs whose sign differs, their largest |x| / scale

    def pinned(x, inplace=False):
        if recording:
            ref.append(x.detach() > 0)
            return relu(x, inplace=inplace)
        want = next(signs)
        if isinstance(want, tuple):
            want = _unpack_bits(torch, *want, x.device)
        if views is not None and want.shape != x.shape:
            rank, world = views
            n = x.shape[0]
            check(want.shape == (world * n,) + x.shape[1:],
                  f"{tag}: ReLU input {tuple(x.shape)} is no rank's slice of {tuple(want.shape)}")
            want = want[rank * n:(rank + 1) * n]
        mag = x.detach().abs()
        differ = (x.detach() > 0) != want
        n = int(differ.sum())
        flips.append((n, float(mag[differ].max()) / max(float(mag.max()), 1e-30) if n else 0.0))
        # in x's layout: an unpacked reference is NCHW, a backbone input channels-last
        return torch.where(want, x, 0.0).contiguous(
            memory_format=torch.channels_last if is_channels_last(x) else torch.contiguous_format)

    def fused_pinned(x, identity, weight, bias, mean, var, eps, relu_after):
        # a frozen BN's ReLU is inside its kernel: the kernel without it,
        # then the pinned ReLU (the plain version calls F.relu there)
        y = fused(x, identity, weight, bias, mean, var, eps, False)
        return pinned(y) if relu_after else y

    fused = layers.frozen_bn
    F.relu, layers.frozen_bn = pinned, fused_pinned
    try:
        yield
    finally:
        F.relu, layers.frozen_bn = relu, fused
    if not recording:
        worst = max(r for _, r in flips)
        log(f"[{tag}] ReLU inputs on the other side of 0 than the reference's: "
            f"{sum(n for n, _ in flips)} in {sum(n > 0 for n, _ in flips)} of "
            f"{len(flips)} calls, at most {worst:.3e} of their call's largest (tol 1e-4)")
        check(worst <= 1e-4, f"{tag}: a ReLU input differs from the reference's")


def phase_train_f32(torch, dev, config="scannet", pin_picks=False):
    """One f32 train step through the kernels against the plain versions,
    both on the plain step's ReLU signs (``_relu_signs_of``) and, with
    ``pin_picks``, occupancy picks (``_occupancy_picks_of``)."""
    import numpy as np

    from sgcdet_tpu_torch.ops import plain_ops

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuDNN's own f32 backward sums in a varying order; pin it, so the steps
    # differ only where the kernels sum in another order than the plain
    # versions
    torch.backends.cudnn.deterministic = True
    tag = "train f32" + _tag(config)
    kw = dict(compute_dtype="float32", ffn_dropout=0.0)
    # three steps from the same seeded weights: through the plain versions
    # on the scene (the reference, whose ReLU signs all three take),
    # through the kernels, and through the plain versions on the scene's
    # images moved by 1e-7 relative noise (the size of the kernels' own
    # rounding differences), which measures how far rounding alone moves
    # each gradient in this state
    signs, picks, runs, scene = [], [], {}, None
    for name, route in (("plain", plain_ops), ("kernels", contextlib.nullcontext),
                        ("nudged plain", plain_ops)):
        cfg, made, model, step = _train_setup(torch, dev, config, **kw)
        scene = made if scene is None else scene
        sc = scene
        if name == "nudged plain":
            imgs = scene["imgs"]
            noise = 1e-7 * np.random.RandomState(2).randn(*imgs.shape)
            sc = dict(scene, imgs=(imgs * (1 + noise)).astype(imgs.dtype))
        gen = torch.Generator(device=dev).manual_seed(1)
        t0 = time.perf_counter()
        with (route(), _relu_signs_of(torch, f"{tag}, {name}", signs),
              _occupancy_picks_of(torch, f"{tag}, {name}", picks)
              if pin_picks else contextlib.nullcontext()):
            metrics = step(sc, gen)
        torch.cuda.synchronize()
        log(f"[{tag}] step through {name} {time.perf_counter() - t0:.3f} s")
        runs[name] = metrics, {n: p.grad for n, p in model.named_parameters()}
        del model, step
    (m_p, grads_p), (m_k, grads_k), (m_n, grads_n) = runs.values()
    log(f"[{tag}] n_pos {float(m_p['n_pos']):.0f} (kernels {float(m_k['n_pos']):.0f}), "
        f"loss_bbox {float(m_p['loss_bbox']):.6f} (kernels {float(m_k['loss_bbox']):.6f})")
    if cfg.model.head_type == "sunrgbd":  # the step must train the rotated IoU loss
        check(all(float(m["n_pos"]) > 0 and float(m["loss_bbox"]) != 0 for m in (m_p, m_k)),
              f"{tag}: no FCOS positive or a zero loss_bbox")
    _compare_steps(torch, tag, runs["plain"], runs["nudged plain"], runs["kernels"],
                   ("kernels", "plain", "nudged plain"))
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = flags


def _compare_steps(torch, tag, ref, nudged, got, names=("got", "reference", "nudged")):
    """Phase 6's bounds between two f32 train steps from the same weights on
    the same ReLU signs: each (metrics, {name: gradient}).  Loss terms
    within 1e-4 of their magnitude; every gradient within 2e-3 of its
    tensor's largest reference gradient (floored at 1e-5 of the largest
    anywhere in the model) plus 4x how far the reference's moves in
    ``nudged``, the reference step on images moved by 1e-7 relative noise
    (the size of the kernels' own rounding differences).  The second term
    covers the train-mode BatchNorm nets (depth U-Nets, 3D neck), whose
    gradients in this state are determined by rounding to about 1e-2
    only."""
    from sgcdet_tpu_torch.train import param_label

    (m_p, grads_p), (m_n, grads_n), (m_k, grads_k) = ref, nudged, got
    # loss terms: checked after the gradients are logged
    differ = []
    for name in m_p:
        a, b = float(m_k[name]), float(m_p[name])
        tol = 1e-4 * max(abs(b), 1e-3)
        log(f"[{tag}] {name}: {names[0]} {a:.6f}, {names[1]} {b:.6f} (tol {tol:.1e}; "
            f"the {names[2]} step {float(m_n[name]):.6f})")
        if abs(a - b) > tol:
            differ.append(name)
    floor = 1e-5 * max(float(g.abs().max()) for g in grads_p.values())
    rows = []
    for name, want in grads_p.items():
        got = grads_k[name]
        check(got is not None and bool(torch.isfinite(got).all()),
              f"{tag}: gradient of {name} missing or non-finite")
        scale = max(float(want.abs().max()), floor)
        spread = float((grads_n[name] - want).abs().max())
        tol = 2e-3 * scale + 4 * spread
        err = float((got - want).abs().max())
        rows.append((err / tol, name, err, scale, spread, param_label(name)))
    rows.sort(reverse=True)
    log(f"[{tag}] gradient scale floor {floor:.3e}; worst err/tol: "
        + "; ".join(f"{n} ({lbl}) {r:.3f}: err {e:.2e}, scale {m:.2e}, nudge {s:.2e}"
                    for r, n, e, m, s, lbl in rows[:5]))
    log(f"[{tag}] {sum(e > 2e-3 * m for _, _, e, m, _, _ in rows)} of {len(rows)} "
        f"tensors differ by more than 2e-3 of their scale; the largest nudge move is "
        f"{max(s / m for _, _, _, m, s, _ in rows):.3e} of its tensor's scale")
    check(not differ, f"{tag}: {differ} differ")
    bad = [n for r, n, *_ in rows if r > 1.0]
    check(not bad, f"{tag}: gradients differ: {bad}")
    log(f"[{tag}] all {len(rows)} parameter gradients match")


def phase_train(torch, dev, kernels, sort_queries=False, config="scannet"):
    from sgcdet_tpu_torch.train import param_label

    tag = ("sorted train" if sort_queries else "train") + _tag(config)
    per_step = _per_call_launches(sort_queries, config, train=True)
    cfg, scene, model, step = _train_setup(torch, dev, config, sort_queries=sort_queries)
    log(f"[{tag}] config {config}, compute {cfg.model.compute_dtype}, ffn_dropout "
        f"{cfg.model.ffn_dropout}, depth loss on, budget "
        f"{[round(b, 4) for b in cfg.model.visibility_budget]}, sort_queries "
        f"{sort_queries}, {N_VIEWS} views")
    before = {n: t.detach().clone() for n, t in model.state_dict().items()}
    gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels.values():
        k.launches = 0
    times = []
    has_grad = dict.fromkeys(before, False)
    for i in range(TRAIN_STEPS):
        counts0 = {name: k.launches for name, k in kernels.items()}
        t0 = time.perf_counter()
        metrics = step(scene, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        for n, p in model.named_parameters():
            has_grad[n] = has_grad[n] or bool(p.grad.any())
        step_launches = {name: k.launches - counts0[name] for name, k in kernels.items()}
        vals = {k: float(v) for k, v in metrics.items()}
        check(all(map(math.isfinite, vals.values())), f"{tag} step {i}: non-finite {vals}")
        log(f"[{tag}] step {i}{' (warm-up)' if i == 0 else ''}: {times[-1]:.4f} s, "
            + ", ".join(f"{k} {v:.5f}" for k, v in vals.items()))
        expected = {name: per_step.get(name, 0) for name in kernels}
        check(step_launches == expected,
              f"{tag} step {i}: launches {_launched(step_launches)}, expected "
              f"{_launched(expected)}")
    launches = {name: k.launches for name, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    after = model.state_dict()
    moved = {n: not torch.equal(before[n], after[n]) for n, _ in model.named_parameters()}
    frozen = [n for n in moved if param_label(n) == "frozen"]
    trainable = [n for n in moved if param_label(n) != "frozen"]
    # a tensor whose gradient stayed zero (FPN level 3, which nothing reads)
    # does not move in the JAX package either: weight decay alone is below
    # f32 rounding at these learning rates
    stuck = [n for n in trainable if has_grad[n] and not moved[n]]
    check(not stuck, f"trainable parameters with gradients that did not move: {stuck[:5]}")
    check(not any(moved[n] for n in frozen), "a frozen parameter moved")
    backbone_stats = [n for n in after if n.startswith("backbone.")
                      and n.endswith(("running_mean", "running_var"))]
    check(all(torch.equal(before[n], after[n]) for n in backbone_stats),
          "a frozen backbone BN's running statistics moved")
    log(f"[{tag}] {sum(moved[n] for n in trainable)} of {len(trainable)} trainable "
        f"parameter tensors moved (every one with a nonzero gradient; zero "
        f"gradient: {[n for n in trainable if not has_grad[n]]}); "
        f"{len(frozen)} frozen ones and {len(backbone_stats)} frozen BN "
        f"statistics did not")
    log(f"[{tag}] warm seconds per step: {sum(times[1:]) / len(times[1:]):.4f}")
    _TRAIN_PEAKS[tag] = peak
    large = _TRAIN_PEAKS.get(f"train{_tag(LARGE)}")
    log(f"[{tag}] peak memory allocated: {peak / 2**30:.3f} GiB"
        + (f" ({LARGE}'s step in this run: {large / 2**30:.3f} GiB)"
           if config == "arkit_large" and large else ""))
    log(f"[{tag}] kernel launches over {TRAIN_STEPS} steps: {_launched(launches)}")
    return launches


# ---------------------------------------------------------------------------
# phase 8: the 2D lifting path
# ---------------------------------------------------------------------------


def _lifting_2d_models(torch, dev, cfg):
    """One ViewTransformer(use_depth=False) per level at the ScanNet width,
    seeded weights, f32 on the card."""
    from sgcdet_tpu_torch.models.layers import init_weights
    from sgcdet_tpu_torch.models.view_transformer import ViewTransformer

    m = cfg.model
    models = []
    for level in range(3):
        vt = ViewTransformer(m.embed_dims, m.num_heads, m.num_points,
                             ffn_dropout=m.ffn_dropout, use_depth=False)
        init_weights(vt, torch.Generator().manual_seed(10 + level))
        models.append(vt.to(dev))
    return models


def phase_lifting_2d(torch, dev, kernels):
    import copy

    from sgcdet_tpu_torch.models.layers import set_compute_dtype
    from sgcdet_tpu_torch.ops import plain_ops

    cfg, scene = _scene_and_cfg()
    m = cfg.model
    origin = torch.from_numpy(scene["origin"]).to(dev)
    proj = torch.from_numpy(scene["proj_img"]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    levels = []
    for level in range(3):
        h, w = _level_hw(cfg, level)
        ref = _level_voxels(torch, dev, cfg, level)
        feat = torch.randn((N_VIEWS, m.embed_dims, h, w), device=dev, generator=gen)
        dpt = torch.zeros((N_VIEWS, m.depth_channels, h, w), device=dev)  # unused
        g = torch.randn((ref.shape[0], m.embed_dims), device=dev, generator=gen)
        levels.append((ref, feat, dpt, g))
        log(f"[2D lifting] level {level}: features ({N_VIEWS},{m.embed_dims},{h},{w}), "
            f"{ref.shape[0]} voxels")
    models = _lifting_2d_models(torch, dev, cfg)

    def run(model, level, feat, train_gen=None):
        ref, _, dpt, g = levels[level]
        out = model(ref, origin, proj, feat, dpt, cfg.data.img_shape, m.dbound,
                    train_gen)
        return out, (out.float() * g).sum()

    # (i) f32, TF32 off: kernels vs plain versions, output and gradients
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for level, model in enumerate(models):
        model.eval()
        params = list(model.named_parameters())
        results = []
        for plain in (False, True):
            feat = levels[level][1].clone().requires_grad_()
            if plain:
                with plain_ops():
                    out, loss = run(model, level, feat)
                    grads = torch.autograd.grad(loss, [feat] + [p for _, p in params])
            else:
                out, loss = run(model, level, feat)
                grads = torch.autograd.grad(loss, [feat] + [p for _, p in params])
            results.append((out.detach(), grads))
        torch.cuda.synchronize()
        (out_k, grads_k), (out_p, grads_p) = results
        check(bool(torch.isfinite(out_k).all()), f"level {level}: non-finite output")
        # the kernels sum in another order than the plain versions (the
        # backward's atomics in a varying one): 1e-4 of the output's scale,
        # 1e-3 of each gradient's after softmax, MHA and LayerNorm
        err = float((out_k - out_p).abs().max())
        tol = 1e-4 * max(float(out_p.abs().max()), 1e-3)
        log(f"[2D lifting] f32 level {level} output: max_abs_err {err:.3e} (tol {tol:.3e})")
        check(err <= tol, f"2D lifting level {level}: output differs")
        worst = []
        for name, a, b in zip(["features"] + [n for n, _ in params], grads_k, grads_p):
            check(bool(torch.isfinite(a).all()), f"level {level}: non-finite grad {name}")
            e = float((a - b).abs().max())
            t = 1e-3 * max(float(b.abs().max()), 1e-8)
            worst.append((e / t, name, e))
        worst.sort(reverse=True)
        log(f"[2D lifting] f32 level {level}: {len(worst)} gradients, worst err/tol "
            + "; ".join(f"{n} {r:.3f} (err {e:.2e})" for r, n, e in worst[:3]))
        check(worst[0][0] <= 1.0, f"2D lifting level {level}: gradient {worst[0][1]} differs")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    # (ii) bf16, train mode (FFN dropout 0.1): forward + backward through the
    # bf16-depth kernels, one level after another
    bf16_models = []
    for model in models:
        mb = copy.deepcopy(model)
        set_compute_dtype(mb, torch.bfloat16)
        bf16_models.append(mb.train())
    for k in kernels.values():
        k.launches = 0
    peaks = []
    for level, model in enumerate(bf16_models):
        feat = levels[level][1].to(torch.bfloat16).requires_grad_()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        out, loss = run(model, level, feat, gen)
        grads = torch.autograd.grad(loss, [feat] + list(model.parameters()))
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated(dev))
        check(bool(torch.isfinite(out.float()).all()) and all(
            bool(torch.isfinite(x.float()).all()) for x in grads),
            f"2D lifting bf16 level {level}: non-finite output or gradient")
    launches = {name: k.launches for name, k in kernels.items()}
    log(f"[2D lifting] bf16 kernel launches over 3 levels (forward + backward): "
        f"{_launched(launches)}")
    expected = {name: (3 if name in KERNELS_2D else 0) for name in kernels}
    check(launches == expected, f"2D lifting launches {_launched(launches)}, expected "
          f"{_launched(expected)}")

    for level, model in enumerate(bf16_models):
        feat = levels[level][1].to(torch.bfloat16)

        def fwd(model=model, level=level, feat=feat):
            model.eval()
            with torch.no_grad():
                run(model, level, feat)

        def fwd_bwd(model=model, level=level, feat=feat):
            model.train()
            f = feat.clone().requires_grad_()
            _, loss = run(model, level, f, gen)
            torch.autograd.grad(loss, [f] + list(model.parameters()))

        ms_f = cuda_ms(torch, fwd, iters=3)
        ms_fb = cuda_ms(torch, fwd_bwd, iters=3)
        log(f"[2D lifting] bf16 level {level}: forward {ms_f:.4f} ms, forward + "
            f"backward {ms_fb:.4f} ms, peak memory {peaks[level] / 2**30:.3f} GiB")
    return {name: launches[name] for name in KERNELS_2D}


# ---------------------------------------------------------------------------
# phase 9: the windowed kernels of the sorted path
# ---------------------------------------------------------------------------


def _sorted_inputs(torch, dev, cfg, scene, level, budget, gen):
    """Stage-1 and stage-2 operands of one level on the sorted path: the
    queries compacted and ordered by the model's own rule (compact_queries
    with sort_queries), stage-2 locations at a freshly built model's
    sampling offsets (each head 1-4 pixels out along its own direction and
    1-4 depth bins along (cos + sin) / 2), seeded softmax attention,
    features and depth."""
    from sgcdet_tpu_torch.models.view_transformer import (
        MSDeformableAttention3D,
        compact_queries,
    )

    m = cfg.model
    h, w = _level_hw(cfg, level)
    ref_cam, mask = _project(torch, dev, cfg, scene, level)
    compact = compact_queries(mask, budget, True, ref_cam, ((h, w),))
    check(compact is not None, f"level {level}: the sorted path compacts every level")
    sel, counts = compact
    kb = sel.shape[1]
    ref_s = torch.gather(ref_cam, 1, sel[..., None].expand(-1, -1, 3))
    # the same level compacted in index order, as without sort_queries
    sel_i = compact_queries(mask, budget)[0]
    ref_i = torch.gather(ref_cam, 1, sel_i[..., None].expand(-1, -1, 3))
    heads, pts, dsize = m.num_heads, m.num_points, m.depth_channels
    attention = MSDeformableAttention3D(m.embed_dims, heads, pts)
    with torch.no_grad():
        attention.reset_special_parameters(torch.Generator().manual_seed(0))
    offsets = torch.cat([attention.sampling_offsets.bias.view(heads, pts, 2)
                         / torch.tensor([w, h]),
                         attention.sampling_offsets_depth.bias.view(heads, pts, 1) / dsize],
                        -1).detach().to(dev)
    return dict(
        h=h, w=w, kb=kb, counts=counts, heads=heads,
        locs1_index=ref_i[:, :, None, None, :].contiguous(),
        locs2_index=(ref_i[:, :, None, None, :] + offsets).contiguous(),
        value=torch.randn((N_VIEWS, h, w, m.embed_dims), device=dev, generator=gen),
        vp=torch.randn((N_VIEWS, h, w, m.embed_dims), device=dev, generator=gen),
        depth=torch.softmax(torch.randn((N_VIEWS, h, w, dsize), device=dev,
                                        generator=gen), -1),
        locs1=ref_s[:, :, None, None, :].contiguous(),
        attn1=torch.ones((N_VIEWS, kb, 1, 1), device=dev),
        locs2=(ref_s[:, :, None, None, :] + offsets).contiguous(),
        attn2=torch.softmax(torch.randn((N_VIEWS, kb, heads, pts), device=dev,
                                        generator=gen), -1),
        g=torch.randn((N_VIEWS, kb, m.embed_dims), device=dev, generator=gen))


def window_shares(torch, plan, locs, counts, h, w):
    """(chunks served from their window, chunks that fall back to global
    memory, share of the live samples served from a window).  A chunk is
    live when a counted query of it has an in-image corner; a sample is
    live when it has one itself."""
    live_chunk = plan.span > 0
    n_ok = int((plan.ok & live_chunk).sum())
    n_fallback = int((~plan.ok & live_chunk).sum())

    def cell(coord, size):
        return (coord * size - 0.5).nan_to_num(nan=-4.0).clamp(-4, size + 4).floor()

    x, y = cell(locs[..., 0], w), cell(locs[..., 1], h)
    live = (x >= -1) & (x <= w - 1) & (y >= -1) & (y <= h - 1)  # (N, K, heads, P)
    k = locs.shape[1]
    q = torch.arange(k, device=locs.device)
    if counts is not None:
        live = live & (q[None, :] < counts[:, None])[..., None, None]
    served = live & plan.ok[:, q // plan.qc, None, None]
    return n_ok, n_fallback, float(served.sum()) / max(1, int(live.sum()))


def window_spans(torch, locs, counts, h, w, qc):
    """p50 / p90 / max of the live windows' spans in pixels at chunks of qc
    queries: each head's own window (``plan_windows`` over that head) and
    the union of a chunk's heads (the window a multi-head block stages),
    and the union spans themselves."""
    from sgcdet_tpu_torch.ops.dfa3d_windowed import plan_windows

    def stats(span):
        span = span[span > 0].float()
        q = torch.quantile(span, torch.tensor([0.5, 0.9], device=span.device))
        return f"{q[0]:.0f} / {q[1]:.0f} / {span.max():.0f}"

    heads = locs.shape[2]
    per_head = torch.cat([plan_windows(locs[:, :, i:i + 1], counts, h, w, 1, qc).span
                          .flatten() for i in range(heads)])
    union = plan_windows(locs, counts, h, w, 1, qc).span
    return (f"per head {stats(per_head)}" if heads > 1 else "") + \
        f"{', ' if heads > 1 else ''}union {stats(union)}", union


# the most pixels whose d_value a block could sum in its 227 KB of shared
# memory: 8 heads x 32 channels in f32 take 1 KB a pixel
DVALUE_WINDOW_PIXELS = 227


def ptxas_resources(log):
    """{mangled kernel name: (registers, spill store bytes)} from the
    ``-Xptxas -v`` lines of the build log."""
    found, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            found[name] = [0, 0]
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            found[name][1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            found[name][0] = int(m.group(1))
    return found


def _template_args(mangled, kernel):
    """The template arguments of one instance of ``kernel`` from its
    mangled name: types as bf16 / f32 / int32 / int64, integers as they
    are (``bf16/f32/256``)."""
    rest, args = mangled.split(kernel + "I", 1)[1], []
    while rest and rest[0] != "E":
        m = re.match(r"13__nv_bfloat16|S\d*_|[fix]|Li(\d+)E", rest)
        if m is None:
            break
        tok = m.group(0)
        args.append(m.group(1) if m.group(1) else
                    {"f": "f32", "i": "int32", "x": "int64"}.get(tok, "bf16"))
        rest = rest[m.end():]
    return "/".join(args)


# the kernels whose every instance's ptxas resources phase 3 prints
PTXAS_INSTANCES = ("dfa3d_fwd_s1_kernel", "gather_epilogue_kernel")


def log_ptxas_instances():
    """ptxas's registers and spill bytes of every instance of the kernels
    of PTXAS_INSTANCES, where this process built the library."""
    from sgcdet_tpu_torch.ops import LIBRARY

    found = ptxas_resources(LIBRARY.log)
    for kernel in PTXAS_INSTANCES:
        parts = [f"{_template_args(name, kernel)} {regs} registers, {spill} B spill stores"
                 for name, (regs, spill) in sorted(found.items()) if kernel + "I" in name]
        log(f"[kernels] ptxas {kernel}: " + ("; ".join(parts) if parts else
                                             "not built by this process"))


# ptxas names of the bf16/f32 instances of K2, K3, K5 (every gradient), K6's
# pixel pass (as the model runs it) and the windowed kernels
PTXAS_KERNELS = {"K2": "dfa3d_fwd_s1_kernelI13__nv_bfloat16fLi256EE",
                 "K3": "dfa3d_fwd_kernelI13__nv_bfloat16fLi32ELi2E",
                 "K5": "dfa3d_bwd_kernelI13__nv_bfloat16fLi32ELb1ELb1E",
                 "K5' bf16/bf16": "dfa3d_bwd_kernelI13__nv_bfloat16S1_Li32ELb1ELb1E",
                 "K6 pixel pass": "s1_pixels_kernelI13__nv_bfloat16fLi256ELb0ELb1EE",
                 "K6 long pass": "s1_long_kernelI13__nv_bfloat16fLi256ELb0ELb1EE",
                 "dfa3d_win_fwd_mh": "dfa3d_win_fwd_mh_kernelI13__nv_bfloat16fLi32E",
                 "dfa3d_win_bwd_mh": "dfa3d_win_bwd_kernelI13__nv_bfloat16fLi32ELb1ELb1E",
                 # the -L stage 2's instances at c = 16
                 "K3 c16": "dfa3d_fwd_kernelI13__nv_bfloat16fLi16ELi2E",
                 "K5 c16": "dfa3d_bwd_kernelI13__nv_bfloat16fLi16ELb1ELb1E",
                 "dfa3d_win_fwd_mh_c16": "dfa3d_win_fwd_mh_kernelI13__nv_bfloat16fLi16E",
                 "dfa3d_win_bwd_mh_c16": "dfa3d_win_bwd_kernelI13__nv_bfloat16fLi16ELb1ELb1E"}


def log_resources(torch, x, c=32):
    """Each windowed kernel's resources at level 2 at c a head (CUDA
    runtime), and ptxas's registers and spills of its bf16/f32 instances
    beside K2's, K3's, K5's, K5′'s at bf16 depth and K6's (and at c = 16
    K3's and K5's)."""
    from sgcdet_tpu_torch.ops import LIBRARY
    from sgcdet_tpu_torch.ops.dfa3d_windowed import (
        kernel_resources,
        win_counter,
        window_length,
    )

    dsize = x["depth"].shape[-1]
    for vdt, ddt in ((torch.bfloat16, torch.float32), (torch.float32, torch.float32),
                     (torch.bfloat16, torch.bfloat16)):
        value, depth = x["value"].to(vdt), x["depth"].to(ddt)
        parts = []
        for backward in (False, True):
            name = win_counter(backward, c)
            wwin = window_length(value, depth, backward)
            r = kernel_resources(backward, vdt, ddt, dsize, wwin, c)
            parts.append(f"{name} {r['registers']} registers, {r['spill_bytes']} B "
                         f"local, {r['smem_bytes']} B shared a block ({wwin} pixels), "
                         f"{r['blocks_per_sm']} blocks of {r['threads']} an SM")
        log(f"[windowed] resources {str(vdt)[6:]}/{str(ddt)[6:]} c={c}: " + "; ".join(parts))
    found = ptxas_resources(LIBRARY.log)
    if found and c == 32:  # once, every instance of PTXAS_KERNELS
        parts = []
        for label, key in PTXAS_KERNELS.items():
            hits = [v for k, v in found.items() if key in k]
            if hits:
                parts.append(f"{label} {hits[0][0]} registers, {hits[0][1]} B spill stores")
        log("[windowed] ptxas, bf16/f32 unless named: " + "; ".join(parts))


def phase_windowed(torch, dev, report):
    from sgcdet_tpu_torch.ops.dfa3d import (
        dfa3d_attention_plain,
        dfa3d_bwd_cuda,
        dfa3d_fwd_cuda,
    )
    from sgcdet_tpu_torch.ops.dfa3d_windowed import (
        QC_BWD,
        QC_FWD,
        dfa3d_attention_windowed,
        dfa3d_win_bwd_cuda,
        dfa3d_win_fwd_cuda,
        dfa3d_windowed_bwd_plain,
        dfa3d_windowed_plain,
        kernel_plan,
    )

    cfg, scene = _scene_and_cfg()
    budget = _auto_budget(cfg, scene)
    gen = torch.Generator(device=dev).manual_seed(9)
    branches = {"window": 0, "fallback": 0}
    grads = ("d_value", "d_dpt", "d_locs", "d_attn")

    def shares(args, backward):
        plan = kernel_plan(*args[:3], args[-1], backward)
        n_ok, n_fb, samples = window_shares(torch, plan, args[2], args[-1],
                                            args[0].shape[1], args[0].shape[2])
        branches["window"] += n_ok
        branches["fallback"] += n_fb
        return (f"{n_ok}/{n_ok + n_fb} chunks (window {plan.wwin} pixels), "
                f"{samples:.4f} of samples in a window")

    def spans(name, args, qcs):
        """The windows' spans of a case at each chunk size."""
        locs, counts = args[2], args[-1]
        h, w = args[0].shape[1:3]
        parts = []
        for qc in qcs:
            text, union = window_spans(torch, locs, counts, h, w, qc)
            live = union[union > 0]
            small = float((live <= DVALUE_WINDOW_PIXELS).float().mean())
            parts.append(f"{qc} queries: {text}; {small:.3f} of unions within "
                         f"{DVALUE_WINDOW_PIXELS} pixels")
        log(f"[windowed] {name} spans (p50 / p90 / max pixels), chunks of "
            + "; ".join(parts))

    def plan_time(name, args, backward):
        """The time of a main case's windows as torch ops on the card
        (``kernel_plan``: the plain version's)."""
        ms = cuda_ms(torch, lambda: kernel_plan(*args[:3], args[-1], backward))
        log(f"[windowed] {name}: the windows as torch ops {ms:.4f} ms")

    def fwd(name, kernel_name, args, timed=False, main=False, earlier=None):
        """Windowed forward vs its plain version and the template kernel."""
        got = dfa3d_win_fwd_cuda(*args)
        want = dfa3d_windowed_plain(*args)
        template = dfa3d_fwd_cuda(*args)
        torch.cuda.synchronize()
        err = compare_tensors(torch, f"{name} vs plain", got, want)
        compare_tensors(torch, f"{name} vs template", got, template)
        if args[-1] is not None:
            _zeros_past_count(torch, args[-1])(got)
        rec = report[kernel_name]
        rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err)
        line = f"[windowed] {name}: {shares(args, False)}"
        if timed:
            ms_t = cuda_ms(torch, lambda: dfa3d_fwd_cuda(*args))
            ms_w = _timing(torch, report, name, kernel_name,
                           lambda: dfa3d_win_fwd_cuda(*args),
                           lambda: dfa3d_windowed_plain(*args),
                           lambda outs: dfa3d_work(args[:4], outs, args[5], False),
                           main=main, earlier=earlier)
            line += (f"; windowed {ms_w:.4f} ms, template {ms_t:.4f} ms "
                     f"({ms_w / ms_t:.3f}x)")
        log(line)
        if main:
            plan_time(name, args, False)

    def stage1(name, args, timed=False, earlier=None):
        """The sorted path's stage 1, which the windowed op sends to K2 (K2'
        at bf16 depth), vs the plain version on sorted queries; timed, K2
        beside the windowed stage 1's earlier time."""
        kernel_name = "dfa3d_fwd_s1_c256_bd" if args[1].dtype == torch.bfloat16 else "dfa3d_fwd_s1_c256"
        got = dfa3d_attention_windowed(*args[:5], valid_counts=args[5])
        want = dfa3d_attention_plain(*args)
        torch.cuda.synchronize()
        err = compare_tensors(torch, f"{name} vs plain", got, want)
        _zeros_past_count(torch, args[-1])(got)
        rec = report[kernel_name]
        rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err)
        if timed:
            _timing(torch, report, name, kernel_name, lambda: dfa3d_fwd_cuda(*args),
                    lambda: dfa3d_attention_plain(*args),
                    lambda outs: dfa3d_work(args[:4], outs, args[5], False),
                    earlier=earlier)

    def bwd(name, args, timed=False, main=False, earlier=None,
            kernel_name="dfa3d_win_bwd_mh", sample_grads=True):
        """Windowed multi-head backward, every gradient (the train path's
        stage 2; without ``sample_grads`` d_value and d_depth only), vs its
        plain version and the template kernel K5."""
        kw = dict(sample_grads=sample_grads, depth_grad=True)
        got = dfa3d_win_bwd_cuda(*args, **kw)
        want = dfa3d_windowed_bwd_plain(*args, **kw)
        template = dfa3d_bwd_cuda(*args, **kw)
        torch.cuda.synchronize()
        err = 0.0
        for label, a, b, t in zip(grads, got, want, template):
            if b is None:
                check(a is None and t is None, f"{name} {label}: a gradient not asked for")
                continue
            err = max(err, compare_tensors(torch, f"{name} {label} vs plain", a, b, 1e-5))
            compare_tensors(torch, f"{name} {label} vs template", a, t, 1e-5)
        if args[-1] is not None and sample_grads:
            _zeros_past_count(torch, args[-1], rows=2)(got)
        rec = report[kernel_name]
        rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err)
        fargs = args[:4] + args[5:]
        line = f"[windowed] {name}: {shares(fargs, True)}"
        if timed:
            ms_t = cuda_ms(torch, lambda: dfa3d_bwd_cuda(*args, **kw))
            ms_w = _timing(torch, report, name, kernel_name,
                           lambda: dfa3d_win_bwd_cuda(*args, **kw),
                           lambda: dfa3d_windowed_bwd_plain(*args, **kw),
                           lambda outs: dfa3d_work(args[:5], outs, args[6], True),
                           main=main, earlier=earlier)
            line += (f"; windowed {ms_w:.4f} ms, template {ms_t:.4f} ms "
                     f"({ms_w / ms_t:.3f}x)")
        log(line)
        if main:
            plan_time(name, fargs, True)

    def query_order(x, s1, s2, shape):
        """The template kernels on this level's queries in sorted and in
        index order: what the order alone does to K2, K3, K6 and K5."""
        g = x["g"].to(s1[0].dtype)
        for order, l1, l2 in (("sorted", x["locs1"], x["locs2"]),
                              ("index-order", x["locs1_index"], x["locs2_index"])):
            a1, a2 = s1[:2] + (l1,) + s1[3:], s2[:2] + (l2,) + s2[3:]
            times = [cuda_ms(torch, lambda: dfa3d_fwd_cuda(*a1)),
                     cuda_ms(torch, lambda: dfa3d_fwd_cuda(*a2)),
                     cuda_ms(torch, lambda: dfa3d_bwd_cuda(*a1[:4], g, *a1[4:],
                                                           sample_grads=False)),
                     cuda_ms(torch, lambda: dfa3d_bwd_cuda(*a2[:4], g, *a2[4:]))]
            log(f"[windowed] templates on {order} queries {shape}: " + ", ".join(
                f"{k} {t:.4f} ms" for k, t in zip(("K2", "K3", "K6", "K5"), times)))

    bf16, f32 = torch.bfloat16, torch.float32
    for level in range(3):
        x = _sorted_inputs(torch, dev, cfg, scene, level, budget[level], gen)
        shape = f"({N_VIEWS},{x['h']},{x['w']}) K'={x['kb']}"
        counts = x["counts"]
        for vdt, ddt in ((bf16, f32), (f32, f32), (bf16, bf16)):
            tag = f"{str(vdt)[6:]}/{str(ddt)[6:]}"
            value, vp, depth = x["value"].to(vdt), x["vp"].to(vdt), x["depth"].to(ddt)
            s1 = (value, depth, x["locs1"], x["attn1"], 1, counts)
            s2 = (vp, depth, x["locs2"], x["attn2"], x["heads"], counts)
            model_pair = (vdt, ddt) == (bf16, f32)
            main = model_pair and level == 2
            if model_pair:
                spans(f"stage1 {shape}", s1, (QC_FWD[32],))
                spans(f"stage2 {shape}", s2, (QC_BWD[32], QC_FWD[32]))
            stage1(f"stage1 {tag} {shape} sorted, K2", s1, model_pair,
                   "win s1 sorted" if main else None)
            fwd(f"stage2 {tag} {shape} sorted", "dfa3d_win_fwd_mh", s2, model_pair, main,
                "win mh sorted" if main else None)
            bwd(f"stage2 bwd {tag} {shape} sorted", s2[:4] + (x["g"].to(vdt),) + s2[4:],
                model_pair, main, "win bwd sorted" if main else None)
            if main:
                query_order(x, s1, s2, shape)
                log_resources(torch, x)
    # random locations (and some NaN) at level 2: chunks too wide for a
    # window, the global-memory branch
    x = _sorted_inputs(torch, dev, cfg, scene, 2, budget[2], gen)
    shape = f"({N_VIEWS},{x['h']},{x['w']}) K'={x['kb']}"
    locs = torch.rand(x["locs2"].shape, device=dev, generator=gen) * 1.3 - 0.15
    locs.view(-1)[::997] = float("nan")
    vp = x["vp"].to(bf16)
    s2 = (vp, x["depth"], locs, x["attn2"], x["heads"], x["counts"])
    fwd(f"stage2 bf16/f32 {shape} random locs", "dfa3d_win_fwd_mh", s2, timed=True,
        earlier="win mh random")
    b2 = s2[:4] + (x["g"].to(bf16),) + s2[4:]
    bwd(f"stage2 bwd bf16/f32 {shape} random locs", b2, timed=True, earlier="win bwd random")
    del x, s2, b2
    # the sorted -L path's stage 2: the instances at c = 16 a head (two
    # queries a warp) on ScanNet200-L's sorted level-2 queries, every type
    # pair, the backward with and without the sample gradients; the
    # bf16/f32 ones timed beside K3 and K5 at c = 16 on the same input
    cfg_l, scene_l = _scene_and_cfg(LARGE)
    x = _sorted_inputs(torch, dev, cfg_l, scene_l, 2, _auto_budget(cfg_l, scene_l)[2], gen)
    shape = f"({N_VIEWS},{x['h']},{x['w']}) K'={x['kb']} c=16"
    check(x["vp"].shape[-1] // x["heads"] == 16, f"-L stage 2 at {shape}")
    for vdt, ddt in ((bf16, f32), (f32, f32), (bf16, bf16)):
        tag = f"{str(vdt)[6:]}/{str(ddt)[6:]}"
        s2 = (x["vp"].to(vdt), x["depth"].to(ddt), x["locs2"], x["attn2"], x["heads"],
              x["counts"])
        b2 = s2[:4] + (x["g"].to(vdt),) + s2[4:]
        main = (vdt, ddt) == (bf16, f32)
        if main:
            spans(f"-L stage2 {shape}", s2, (QC_BWD[16], QC_FWD[16]))
        fwd(f"-L stage2 {tag} {shape} sorted", "dfa3d_win_fwd_mh_c16", s2, main, main)
        bwd(f"-L stage2 bwd {tag} {shape} sorted", b2, main, main,
            kernel_name="dfa3d_win_bwd_mh_c16")
        bwd(f"-L stage2 bwd {tag} {shape} sorted, no sample gradients", b2,
            kernel_name="dfa3d_win_bwd_mh_c16", sample_grads=False)
        if main:
            log_resources(torch, x, c=16)
    del x, s2, b2
    log(f"[windowed] chunks run from a window: {branches['window']}, from global "
        f"memory: {branches['fallback']}")
    check(branches["window"] > 0, "no windowed case ran a chunk from its window")
    check(branches["fallback"] > 0, "no windowed case ran the global-memory branch")


# the chunk lengths chunk_sweep tries at c = 16: forward, backward
SWEEP_CHUNKS = {"fwd": (8, 16, 32, 64, 128), "bwd": (8, 16, 32, 64)}


def chunk_sweep():
    """The windowed kernels' chunk length at c = 16 a head, run by hand on
    a card (not a phase of ``main``):

        python3 -c "import chip_smoke as cs; cs.chunk_sweep()"

    On phase 9's sorted ScanNet200-L level-2 inputs (bf16 value, f32
    depth), for each length of ``SWEEP_CHUNKS`` the windowed forward and
    backward (every gradient) with chunks of that many queries
    (``win_fwd_launch`` / ``win_bwd_launch``), each first held against its
    plain version on the same chunks (``plan_windows``), then timed beside
    K3 and K5 at c = 16, twice over in turns; also the windows' spans."""
    import torch

    from sgcdet_tpu_torch.ops.dfa3d import dfa3d_bwd_cuda, dfa3d_fwd_cuda
    from sgcdet_tpu_torch.ops.dfa3d_windowed import (
        dfa3d_windowed_bwd_plain,
        dfa3d_windowed_plain,
        plan_windows,
        win_bwd_launch,
        win_fwd_launch,
        window_length,
    )

    check(torch.cuda.is_available(), "chunk_sweep needs a CUDA card")
    dev = torch.device("cuda", 0)
    cfg, scene = _scene_and_cfg(LARGE)
    gen = torch.Generator(device=dev).manual_seed(9)
    x = _sorted_inputs(torch, dev, cfg, scene, 2, _auto_budget(cfg, scene)[2], gen)
    args = (x["vp"].to(torch.bfloat16), x["depth"], x["locs2"], x["attn2"], x["heads"],
            x["counts"])
    bargs = args[:4] + (x["g"].to(torch.bfloat16),) + args[4:]
    h, w = x["h"], x["w"]
    log(f"[chunks] {torch.cuda.get_device_name(0)}; sorted {LARGE} level 2: "
        f"{tuple(args[0].shape)}, K'={x['kb']}, c=16")
    runs = {"fwd": (lambda qc: win_fwd_launch(*args, qc=qc), lambda: dfa3d_fwd_cuda(*args)),
            "bwd": (lambda qc: win_bwd_launch(*bargs, qc=qc), lambda: dfa3d_bwd_cuda(*bargs))}
    for direction, sizes in SWEEP_CHUNKS.items():
        backward = direction == "bwd"
        for qc in sizes:
            plan = plan_windows(args[2], args[5], h, w,
                                window_length(args[0], args[1], backward), qc)
            got = runs[direction][0](qc)
            want = (dfa3d_windowed_bwd_plain(*bargs, plan=plan) if backward
                    else dfa3d_windowed_plain(*args, plan=plan))
            for a, b in zip(got, want) if backward else ((got, want),):
                compare_tensors(torch, f"{direction} chunks of {qc}", a, b, 1e-5)
            text, _ = window_spans(torch, args[2], args[5], h, w, qc)
            log(f"[chunks] {direction} chunks of {qc}: spans (p50 / p90 / max) {text}")
    for turn in range(2):
        for direction, sizes in SWEEP_CHUNKS.items():
            run, template = runs[direction]
            ms_t = cuda_ms(torch, template)
            parts = []
            for qc in sizes:
                ms = cuda_ms(torch, lambda: run(qc))
                parts.append(f"{qc}: {ms:.4f} ms ({ms / ms_t:.3f}x)")
            log(f"[chunks] turn {turn} {direction}: template {ms_t:.4f} ms; chunks of "
                + ", ".join(parts))


# ---------------------------------------------------------------------------
# phase 10: the sorted path (sort_queries=True)
# ---------------------------------------------------------------------------


def phase_sorted(torch, dev, kernels, unsorted_f32, serving, train):
    """The sorted f32 scene against its plain run and the unsorted scene,
    then the bf16 serving and train loops with their launch counts."""
    out = phase_slice_f32(torch, dev, sort_queries=True)
    # an exact permutation: only summation order and the coordinate
    # arithmetic's rounding differ from the unsorted scene
    _compare_heads(torch, "sorted vs unsorted f32", out, unsorted_f32, 1e-4)
    del out
    serving.update(phase_serving(torch, dev, kernels, sort_queries=True))
    train.update(phase_train(torch, dev, kernels, sort_queries=True))


# ---------------------------------------------------------------------------
# phase 11: the row gather / scatter probes
# ---------------------------------------------------------------------------

# the probe kernels, and the case of each that the kernel line reports
PROBE_MAIN = {"row_gather": "lowering bf16 row copies (4944, 1072), direct",
              "row_scatter_add": "lowering scatter-add u (2^20, 1072) -> 4944 rows, "
                                 "windowed 256"}
# the probe cases printed beside an earlier design's time (EARLIER_MS)
PROBE_EARLIER = {"gather_batch p4+epi f32 w=176": "p4+epi a lane a channel"}
# PERF.md rows 24 and 29, the probe cases that lost to their library call
PROBE_ROWS = {"24 w128": "window_matmul bf16 (4944, 1072), w128 cm128",
              "24 w256": "window_matmul bf16 (4944, 1072), w256 cm256",
              "24 w512": "window_matmul bf16 (4944, 1072), w512 cm512",
              "29": "f32_onehot scatter-add (2048, 1072) -> 256 rows, windowed 256"}


def phase_probes(torch, dev, report):
    from sgcdet_tpu_torch.experiments import probes

    cases = probes.probe_cases(dev)
    plain_ms = {}
    for case in cases:
        got, want = case.run(), case.run_plain()
        torch.cuda.synchronize()
        if case.kernel == "row_gather" and case.flops == 0:
            check(torch.equal(got, want), f"probe {case.name}: gather is not exact")
            err = 0.0
            log(f"[probes] {case.name}: exact")
        else:  # f32 sums in another order (atomics, the epilogue's FMAs)
            err = compare_tensors(torch, f"probe {case.name}", got, want, f32_rel=1e-5)
        del got, want
        rec = report[case.kernel]
        if "f32_onehot" not in case.name:  # its rows' scales reach 2^40
            rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err)
        plain_ms[case.name] = cuda_ms(torch, case.run_plain, iters=2)
    # probe_f32_onehot.py's point: a window row hit once is moved bit for bit
    gen = torch.Generator(device=dev).manual_seed(3)
    scale = torch.exp2(torch.randint(-40, 40, (256, 1), device=dev, generator=gen).float())
    u = torch.randn((256, 1072), device=dev, generator=gen) * scale
    perm = torch.randperm(256, device=dev, generator=gen)
    got = probes.row_scatter_add(u, perm, 256, window=256)
    want = torch.zeros_like(u).index_copy_(0, perm, u)
    check(torch.equal(got, want), "windowed scatter of a permutation is not bit-exact")
    log("[probes] windowed scatter-add of a permutation (adversarial f32 scales): "
        "bit-exact")
    del cases
    # the probes' entry point, counted: every probe kernel must launch
    for k in probes.KERNELS.values():
        k.launches = 0
    records = probes.run_probes(dev)
    launches = {name: k.launches for name, k in probes.KERNELS.items()}
    for r in records:
        bound_ms, bound_by = bound(r["bytes"], r["flops"])
        lib = ("" if r["library_ms"] is None else
               f"; library {r['library_ms']:.4f} ms "
               f"({r['bytes'] / r['library_ms'] / 1e6:.1f} GB/s)")
        earlier = PROBE_EARLIER.get(r["name"])
        log(f"[probes] {r['name']}: {r['ms']:.4f} ms, {r['rows_per_s'] / 1e6:.1f} M "
            f"rows/s, {r['gb_per_s']:.1f} GB/s; plain {plain_ms[r['name']]:.4f} ms; "
            f"bound {bound_ms:.4f} ms ({bound_by}){lib}"
            + ("" if earlier is None else
               f"; earlier {EARLIER_MS[earlier]:.4f} ms ({earlier}, PERF.md)"))
        if PROBE_MAIN[r["kernel"]] == r["name"]:
            report[r["kernel"]].update(ms=r["ms"], plain_ms=plain_ms[r["name"]],
                                       bound_ms=bound_ms, bound_by=bound_by,
                                       library_ms=r["library_ms"])
    log(f"[probes] kernel launches of the probes' run: {launches}")
    check(all(n > 0 for n in launches.values()), f"a probe kernel did not launch: {launches}")
    # the rows of PERF.md's table that lost to their library call before
    by_name = {r["name"]: r for r in records}
    for row, name in PROBE_ROWS.items():
        r = by_name[name]
        bound_ms, _ = bound(r["bytes"], r["flops"])
        log(f"[probes] row {row} ({name}): {r['ms']:.4f} ms, bound {bound_ms:.4f} ms, "
            f"library {r['library_ms']:.4f} ms: "
            f"{'no slower than' if r['ms'] <= r['library_ms'] else 'SLOWER than'} the library")
    # the epilogue's window: four points' jittered monotone rows
    # (probe_window_matmul.py's regime), whose chunks fit a window of 256
    gen = torch.Generator(device=dev).manual_seed(4)
    m = probes.STEPS * probes.QB
    img = torch.randn((probes.RQ, 176), device=dev, generator=gen)
    t = torch.arange(m, device=dev) * (probes.RQ - 1) // (m - 1)
    rows = torch.stack([(t + torch.randint(-40, 40, (m,), device=dev, generator=gen))
                        .clamp(0, probes.RQ - 1) for _ in range(4)])
    winfo = torch.rand((4, m, 8), device=dev, generator=gen)
    winfo[..., 6:8] = torch.floor(winfo[..., 6:8] * 12)
    share = float(probes.plan_rows(rows, probes.CM, 256)[2].float().mean())
    for window in (None, 256):
        tag = f"p4+epi f32 w=176, jittered rows, {'windowed 256' if window else 'direct'}"
        got = probes.gather_epilogue(img, rows, winfo, window)
        want = probes.gather_epilogue_plain(img, rows, winfo, window)
        torch.cuda.synchronize()
        compare_tensors(torch, f"probe {tag}", got, want, f32_rel=1e-5)
        ms = cuda_ms(torch, lambda: probes.gather_epilogue(img, rows, winfo, window))
        log(f"[probes] {tag}: {ms:.4f} ms ({share:.3f} of chunks fit the window)")
    # what the gathered corner rows cost: row 28's call beside the same call
    # with every index in 8 rows, which stay in L1
    rows = torch.randint(0, probes.RQ, (4, m), device=dev, generator=gen)
    ms = cuda_ms(torch, lambda: probes.gather_epilogue(img, rows, winfo))
    ms8 = cuda_ms(torch, lambda: probes.gather_epilogue(img, rows % 8, winfo))
    gathered = m * 16 * (128 + 2 * 32)  # 16 value pieces, 32 depth sectors a row
    log(f"[probes] p4+epi f32 w=176, random rows: {ms:.4f} ms, every index in 8 rows "
        f"{ms8:.4f} ms; the random rows' {gathered / 1e6:.0f} MB of corner pieces and "
        f"depth sectors at {gathered / ms / 1e6:.0f} GB/s from L2")
    del img, rows, winfo, got, want
    # where the device time of a call goes, and the device work of one call
    attributed = [c for c in probes.probe_cases(dev) if c.prepare is not None]
    for r in probes.attribute_probes(dev, attributed):
        log(f"[probes] attribution {r['name']}: whole call {r['whole_ms']:.4f} ms, kernel "
            f"alone {r['kernel_ms']:.4f} ms, torch ops {r['torch_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms")
    for case in attributed:
        work = probes.device_work(case.run)
        most = 1 if case.kernel == "row_gather" else 3
        log(f"[probes] device work of one call, {case.name}: {work}")
        check(1 <= len(work) <= most and all(probes.KERNEL_SYMBOLS[case.kernel] in w
                                                 for w in work),
              f"probe {case.name}: one call ran {work}, not 1-{most} kernels of its own")
    return launches


# ---------------------------------------------------------------------------
# phase 12: the ScanNet200-L config
# ---------------------------------------------------------------------------


def phase_large(torch, dev, kernels, serving, train, sorted_serving, sorted_train):
    """``scannet200_large`` (embed 128: K2 / K6 at c = 128, K3 / K5 at 16 a
    head) at 40 views: the f32 scene and one f32 train step through the
    kernels against the plain versions, then the bf16 serving and train
    loops with their launch counts, seconds and peak memory.  Then the same
    config with ``sort_queries`` (the windowed kernels at c = 16 in place of
    K3 and K5): its f32 scene through kernels and plain versions and
    against the unsorted one (as phase 10), bf16 serving and training."""
    unsorted_f32 = phase_slice_f32(torch, dev, config=LARGE)
    torch.cuda.empty_cache()
    phase_train_f32(torch, dev, config=LARGE)
    torch.cuda.empty_cache()
    serving.update(phase_serving(torch, dev, kernels, config=LARGE))
    torch.cuda.empty_cache()
    train.update(phase_train(torch, dev, kernels, config=LARGE))
    torch.cuda.empty_cache()
    out = phase_slice_f32(torch, dev, sort_queries=True, config=LARGE)
    _compare_heads(torch, f"sorted vs unsorted f32{_tag(LARGE)}", out, unsorted_f32, 1e-4)
    del out, unsorted_f32
    torch.cuda.empty_cache()
    sorted_serving.update(phase_serving(torch, dev, kernels, sort_queries=True, config=LARGE))
    torch.cuda.empty_cache()
    sorted_train.update(phase_train(torch, dev, kernels, sort_queries=True, config=LARGE))
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 13: the ARKit head (arkit, arkit_large)
# ---------------------------------------------------------------------------


def _arkit_kernels(torch, dev, report, config):
    """The DFA3D kernels of ``config``'s widths against their plain versions
    at its level-2 shape (ARKit's 240-row frames: 60 x 80 value maps; the
    exact auto budget's K'), bf16/f32 and f32/f32, counted: K2 and K3
    forward, K6 (as the model runs it, no sample gradients) and K5
    backward on phase 3b's edge locations, each bf16/f32 one timed beside
    its bound; for ``arkit`` also
    the sweep forward and backward (K1, K4) on ARKit's rig.  Errors join
    the kernel report's max_abs_err."""
    from sgcdet_tpu_torch.ops import KERNELS
    from sgcdet_tpu_torch.ops.dfa3d import (
        counter_name,
        dfa3d_attention_plain,
        dfa3d_bwd_cuda,
        dfa3d_bwd_plain,
        dfa3d_fwd_cuda,
    )
    from sgcdet_tpu_torch.ops.sweep import (
        sweep_bwd_cuda,
        sweep_bwd_plain,
        sweep_fwd_cuda,
        sweep_fwd_plain,
    )

    tag = f"kernels {config}"
    cfg, scene = _scene_and_cfg(config)
    gen = torch.Generator(device=dev).manual_seed(13)

    def compare(name, kernel_name, run_kernel, run_plain, labels, work):
        before = KERNELS[kernel_name].launches
        outs_k = run_kernel()
        check(KERNELS[kernel_name].launches == before + 1,
              f"{tag} {name}: {kernel_name} did not launch once")
        outs_p = run_plain()
        torch.cuda.synchronize()
        outs_k = outs_k if isinstance(outs_k, tuple) else (outs_k,)
        outs_p = outs_p if isinstance(outs_p, tuple) else (outs_p,)
        err = 0.0
        for label, got, want in zip(labels, outs_k, outs_p):
            if want is None:
                check(got is None, f"{tag} {name} {label}: kernel returned a gradient "
                                   "the plain version did not")
                continue
            err = max(err, compare_tensors(torch, f"{config} {name} {label}", got, want,
                                           f32_rel=1e-5 if len(labels) > 1 else 1e-4))
        rec = report.setdefault(kernel_name, {})
        rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err)
        if work is not None:
            _timing(torch, report, f"{config} {name}", kernel_name, run_kernel, run_plain,
                    work)

    if config == "arkit":
        for name, src, ref, xe, ye in _sweep_cases(torch, dev, cfg, scene, gen):
            bf16 = src.dtype == torch.bfloat16
            f_args = (src, ref, xe, ye)
            compare(name, "sweep_fwd", lambda: sweep_fwd_cuda(*f_args),
                    lambda: sweep_fwd_plain(*f_args), ("out",),
                    (lambda outs: sweep_work(f_args, outs, False)) if bf16 else None)
            b_args = f_args + (torch.randn(xe.shape, device=dev, generator=gen),)
            compare(name.replace("sweep", "sweep bwd"), "sweep_bwd",
                    lambda: sweep_bwd_cuda(*b_args), lambda: sweep_bwd_plain(*b_args),
                    ("d_src", "d_ref"),
                    (lambda outs: sweep_work(b_args, outs, True)) if bf16 else None)

    budget = _auto_budget(cfg, scene)
    x = _lifting_inputs(torch, dev, cfg, scene, 2, budget[2], gen)
    shape = f"({N_VIEWS},{x['h']},{x['w']}) K'={x['kb']}"
    log(f"[{tag}] auto visibility budget per level {[round(b, 4) for b in budget]}; "
        f"level 2: {shape}")
    c1, heads = cfg.model.embed_dims, x["heads"]
    counts = x["counts"]
    grads = ("d_value", "d_dpt", "d_locs", "d_attn")
    for vdt in (torch.bfloat16, torch.float32):
        bf16 = vdt == torch.bfloat16
        dtag = "bf16/f32" if bf16 else "f32/f32"
        value = x["value"].to(vdt)
        vp = torch.randn((N_VIEWS, x["h"], x["w"], c1), device=dev, generator=gen).to(vdt)
        g = torch.randn((N_VIEWS, x["kb"], c1), device=dev, generator=gen).to(vdt)
        s1 = (value, x["depth"], x["locs1"], x["attn1"], 1, counts)
        s2 = (vp, x["depth"], x["locs2"], x["attn2"], heads, counts)
        for stage, args, c in (("stage1", s1, c1), ("stage2", s2, c1 // heads)):
            stage1 = stage == "stage1"
            compare(f"{stage} c={c} {dtag} {shape} counted", counter_name(False, stage1, c,
                                                                          torch.float32),
                    lambda: dfa3d_fwd_cuda(*args), lambda: dfa3d_attention_plain(*args),
                    ("out",),
                    (lambda outs: dfa3d_work(args[:4], outs, counts, False)) if bf16 else None)
            # the backward on phase 3b's locations (samples on the edges)
            b_args = (args[:2] + (_edge_locs(args[2], x["w"], x["h"]), args[3], g)
                      + args[4:])
            kw = dict(sample_grads=not stage1)
            compare(f"{stage} bwd c={c} {dtag} {shape} counted",
                    counter_name(True, stage1, c, torch.float32),
                    lambda: dfa3d_bwd_cuda(*b_args, **kw),
                    lambda: dfa3d_bwd_plain(*b_args, **kw), grads,
                    (lambda outs: dfa3d_work(b_args[:5], outs, counts, True))
                    if bf16 else None)
    del x, value, vp, g
    if config == "arkit_large":
        # the sorted path's stage 2 at c = 16 on this config's sorted level-2
        # queries: the windowed instances, bf16/f32, forward and backward
        from sgcdet_tpu_torch.ops.dfa3d_windowed import (
            dfa3d_win_bwd_cuda,
            dfa3d_win_fwd_cuda,
            dfa3d_windowed_bwd_plain,
            dfa3d_windowed_plain,
        )

        x = _sorted_inputs(torch, dev, cfg, scene, 2, budget[2], gen)
        shape = f"({N_VIEWS},{x['h']},{x['w']}) K'={x['kb']}"
        s2 = (x["vp"].to(torch.bfloat16), x["depth"], x["locs2"], x["attn2"], x["heads"],
              x["counts"])
        b2 = s2[:4] + (x["g"].to(torch.bfloat16),) + s2[4:]
        compare(f"sorted stage2 c=16 bf16/f32 {shape}", "dfa3d_win_fwd_mh_c16",
                lambda: dfa3d_win_fwd_cuda(*s2), lambda: dfa3d_windowed_plain(*s2),
                ("out",), None)
        compare(f"sorted stage2 bwd c=16 bf16/f32 {shape}", "dfa3d_win_bwd_mh_c16",
                lambda: dfa3d_win_bwd_cuda(*b2), lambda: dfa3d_windowed_bwd_plain(*b2),
                grads, None)
        del x, s2, b2


def phase_arkit(torch, dev, kernels, report, runs, detections):
    """The ARKit head's configs at 40 views with their exact auto budgets:
    the kernels at each config's level-2 shape, the f32 scene and one f32
    train step through kernels and plain versions, then bf16 serving and 4
    bf16 train steps with their launches, seconds and peak memory."""
    for config in ARKIT_CONFIGS:
        t0 = time.perf_counter()
        _arkit_kernels(torch, dev, report, config)
        torch.cuda.empty_cache()
        phase_slice_f32(torch, dev, config=config, pin_picks=True)
        torch.cuda.empty_cache()
        phase_train_f32(torch, dev, config=config, pin_picks=True)
        torch.cuda.empty_cache()
        served = phase_serving(torch, dev, kernels, config=config,
                               detections=detections.setdefault(config, []),
                               n_scenes=ARKIT_SERVE_SCENES, warm_up="forward")
        torch.cuda.empty_cache()
        runs[config] = dict(serving=served, train=phase_train(torch, dev, kernels,
                                                              config=config))
        torch.cuda.empty_cache()
        log(f"[arkit] {config}: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 14: the indoor mAP eval of the served scenes
# ---------------------------------------------------------------------------


class _EvalLog:
    """indoor_eval's logger: keeps the per-class table, logs its last row."""

    def info(self, report):
        log(f"[eval]   {report.strip().splitlines()[-1]}")


def phase_eval(torch, detections):
    """``eval.indoor_eval`` of the port on the scenes phases 5 and 13 served
    (ScanNet's aligned boxes, ARKit's yawed ones) against synthetic GT: the
    yawed or aligned boxes of ``scene.example_train_scene`` for every
    scene; mAP@0.25 and @0.5 finite.  Then the GT given back as detections
    of score 1: AP 1.0 for every class present."""
    import numpy as np

    from sgcdet_tpu_torch import configs
    from sgcdet_tpu_torch.eval import indoor_eval
    from sgcdet_tpu_torch.geometry import DepthBoxes3D
    from sgcdet_tpu_torch.scene import example_train_scene

    for config, dets in detections.items():
        cfg = configs.get_config(config)
        yawed = cfg.model.head_type == "sunrgbd"
        width = 7 if yawed else 6
        truth = example_train_scene(cfg.data.img_shape, cfg.data.pad_size, 2,
                                    cfg.model.n_classes, 1, yawed=yawed)
        mask = truth["gt_mask"]
        gt = dict(gt_num=int(mask.sum()),
                  gt_boxes_upright_depth=truth["gt_boxes"][mask][:, :width],
                  **{"class": truth["gt_labels"][mask].astype(np.int64)})
        label2cat = dict(enumerate(cfg.data.classes))

        def annos(scene_dets):
            return [dict(boxes_3d=DepthBoxes3D(b, box_dim=width, with_yaw=yawed,
                                               origin=(0.5, 0.5, 0.5)),
                         scores_3d=s, labels_3d=l) for b, s, l in scene_dets]

        t0 = time.perf_counter()
        res = indoor_eval([gt] * len(dets), annos(dets), [0.25, 0.5], label2cat,
                          logger=_EvalLog())
        maps = (res["mAP_0.25"], res["mAP_0.50"])
        log(f"[eval] {config}: {len(dets)} served scenes, "
            f"{sum(len(d[0]) for d in dets)} detections ({width} wide), {gt['gt_num']} GT "
            f"boxes a scene: mAP@0.25 {maps[0]:.6f}, mAP@0.5 {maps[1]:.6f}, mAR@0.25 "
            f"{res['mAR_0.25']:.6f} ({time.perf_counter() - t0:.3f} s)")
        check(all(math.isfinite(m) for m in maps), f"eval {config}: mAP not finite")
        perfect = [(gt["gt_boxes_upright_depth"], np.ones(gt["gt_num"], np.float32),
                    gt["class"])] * len(dets)
        res = indoor_eval([gt] * len(dets), annos(perfect), [0.25, 0.5], label2cat,
                          logger=_EvalLog())
        present = sorted({label2cat[int(c)] for c in gt["class"]})
        aps = [res[f"{c}_AP_{t}"] for c in present for t in ("0.25", "0.50")]
        log(f"[eval] {config}: GT as detections of score 1: AP over {len(present)} classes "
            f"present min {min(aps):.6f}, mAP@0.25 {res['mAP_0.25']:.6f}, "
            f"@0.5 {res['mAP_0.50']:.6f}")
        check(all(ap >= 1.0 - 1e-6 for ap in aps), f"eval {config}: GT as detections, AP < 1")


# ---------------------------------------------------------------------------
# phase 15: the CLI (train, eval, show), checkpoints, resume, data parallel
# at world size 1, and 100-view serving
# ---------------------------------------------------------------------------

CLI_TRAIN_SCENES = 2
CLI_VAL_SCENES = 2
CLI_STEPS = 3
# the loss terms of the DP step at world size 1 against the single-device
# step from the same weights, f32 with TF32 off: relative tolerance
DP_LOSS_RTOL = 1e-4


class _MemoryScenes:
    """``MultiViewDataset``'s interface (``__len__``, ``__getitem__``,
    ``gt_anno``, ``scene_poses``) over synthetic indoor scenes of
    ``scene.py``: the images of ``RandomState(seed + i)``, the yawless
    ground truth of ``example_train_scene`` (its 8 real boxes).  The card's
    host holds no dataset, so the CLI reads these from memory instead of an
    on-disk set."""

    def __init__(self, cfg, n_scenes, n_views, train, seed):
        import numpy as np

        from sgcdet_tpu_torch.scene import example_scene, example_train_scene

        truth = example_train_scene(cfg.data.img_shape, cfg.data.pad_size, 2,
                                    cfg.model.n_classes, 1)
        mask = truth["gt_mask"]
        self.boxes, self.labels = truth["gt_boxes"][mask], truth["gt_labels"][mask]
        self.train = train
        self.scenes = [example_scene(cfg.data.img_shape, cfg.data.pad_size, n_views,
                                     rng=np.random.RandomState(seed + i), trajectory="indoor")
                       for i in range(n_scenes)]

    def __len__(self):
        return len(self.scenes)

    def __getitem__(self, i):
        scene = dict(self.scenes[i], index=i)
        if self.train:
            scene.update(gt_boxes=self.boxes, gt_labels=self.labels)
        return scene

    def gt_anno(self, i):
        import numpy as np

        return dict(gt_num=len(self.boxes), gt_boxes_upright_depth=self.boxes[:, :6],
                    **{"class": self.labels.astype(np.int64)})

    def scene_poses(self, i):
        s = self.scenes[i]
        return s["origin"], s["proj_img"], s["proj_feat4"]


def _cli_run(torch, kernels, flags, datasets, built):
    """``cli.run`` of ``flags`` on the in-memory datasets; records each
    model the run builds (with its optimizer and config) in ``built`` and
    the launches of each train step and each eval forward.  Returns (the
    run's result, step launches, eval launches)."""
    from sgcdet_tpu_torch import cli, infer
    from sgcdet_tpu_torch import train as port_train

    steps, evals = [], []

    def counted(fn, into):
        def call(*args, **kw):
            before = {name: k.launches for name, k in kernels.items()}
            out = fn(*args, **kw)
            into.append({name: k.launches - before[name] for name, k in kernels.items()})
            return out
        return call

    def init(config, *args, **kw):
        model, optimizer = originals[0](config, *args, **kw)
        built.append((model, optimizer, config))
        return model, optimizer

    def make_step(*args, **kw):
        return counted(originals[1](*args, **kw), steps)

    originals = (port_train.init_train_state, port_train.make_train_step,
                 infer.forward_scene)
    port_train.init_train_state, port_train.make_train_step = init, make_step
    infer.forward_scene = counted(originals[2], evals)
    try:
        ret = cli.run(cli.parse_args(flags), *datasets)
    finally:
        (port_train.init_train_state, port_train.make_train_step,
         infer.forward_scene) = originals
    torch.cuda.synchronize()
    return ret, steps, evals


def _check_launches(tag, runs, per_call, what):
    for i, got in enumerate(runs):
        want = {name: per_call.get(name, 0) for name in got}
        check(got == want, f"{tag} {what} {i}: launches {_launched(got)}, expected "
              f"{_launched(want)}")
    log(f"[{tag}] {len(runs)} {what}s, each {_launched(runs[0]) if runs else {}}")


def _state_equal(torch, a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def phase_cli(torch, dev, kernels, root):
    """The CLI on the ScanNet config at full width (bf16, ``--visibility_budget
    auto``, ``data.repeat_times=1``, ``model.ffn_dropout=0.0``) over in-memory
    datasets in ``root``: train, restore, resume, eval, show; one
    data-parallel step at world size 1 on NCCL against a single-device step;
    the 100-view f32 scene through kernels and plain versions and 100-view
    bf16 serving."""
    cwd = os.getcwd()
    os.chdir(root)  # the CLI writes logs/<folder> where it runs
    try:
        _phase_cli(torch, dev, kernels, root)
    finally:
        os.chdir(cwd)


def _phase_cli(torch, dev, kernels, root):
    import numpy as np

    from sgcdet_tpu_torch import configs
    from sgcdet_tpu_torch.train import checkpoint, init_train_state

    tag = "cli"
    cfg = configs.scannet()
    train_ds = _MemoryScenes(cfg, CLI_TRAIN_SCENES, cfg.data.n_images_train, True, 0)
    val_ds = _MemoryScenes(cfg, CLI_VAL_SCENES, cfg.data.n_images_test, False, 10)
    try:
        import cv2
        decoder = f"cv2 {cv2.__version__}"
    except Exception:
        decoder = "no cv2"
    log(f"[{tag}] datasets in memory (this host holds no dataset; its image "
        f"decoder: {decoder}): {len(train_ds)} train scenes at {cfg.data.n_images_train} views "
        f"and {len(val_ds)} val scenes at {cfg.data.n_images_test} views of the indoor "
        f"trajectory, behind the CLI's SceneLoader; log folders in {root}")
    common = ["--config", "scannet", "--device", str(dev), "--num_workers", "2",
              "--override", "data.repeat_times=1", "--override", "model.ffn_dropout=0.0"]
    datasets = (train_ds, val_ds)
    ckpt_dir = root / "logs/run/ckpt"

    # 1. train 3 steps: an epoch is 2 steps, so a save and a 100-view eval
    # at step 2, and (the JAX package's loop counts the cut epoch as one) a
    # save and an eval at step 3, then the final save
    built = []
    t0 = time.perf_counter()
    _, steps, evals = _cli_run(torch, kernels, common + [
        "--mode", "train", "--log_folder", "run", "--visibility_budget", "auto",
        "--max_steps", str(CLI_STEPS), "--eval_every_epochs", "1"], datasets, built)
    model, optimizer, run_cfg = built[-1]
    budget = run_cfg.model.visibility_budget
    log(f"[{tag}] train: {CLI_STEPS} steps with the evals at steps 2 and 3 in "
        f"{time.perf_counter() - t0:.1f} s; budget {[round(b, 4) for b in budget]}")
    lines = [json.loads(x) for x in (root / "logs/run/metrics.jsonl").read_text().splitlines()]
    train_lines = [x for x in lines if "train/loss" in x]
    val_lines = [x for x in lines if "val/mAP_0.25" in x]
    log(f"[{tag}] metrics.jsonl: {train_lines[-1] if train_lines else None}; "
        f"{val_lines[-1] if val_lines else None}")
    check((root / "logs/run/config.json").is_file(), f"{tag}: no config.json")
    check(len(train_lines) == 2 and all(math.isfinite(x["train/loss"]) for x in train_lines),
          f"{tag}: train/ lines {train_lines}")
    check([x["step"] for x in val_lines] == [2, 3], f"{tag}: val/ lines {val_lines}")
    check((ckpt_dir / "step_2").is_file() and (ckpt_dir / "step_3").is_file()
          and (ckpt_dir / "last").read_text() == "step_3",
          f"{tag}: checkpoints {sorted(p.name for p in ckpt_dir.iterdir())}")
    check(len(steps) == CLI_STEPS and len(evals) == 2 * CLI_VAL_SCENES,
          f"{tag}: {len(steps)} steps and {len(evals)} eval forwards")
    _check_launches(tag, steps, LAUNCHES_PER_STEP, "train step")
    _check_launches(tag, evals, LAUNCHES_PER_SCENE, "100-view eval scene")

    # 2. a fresh model and optimizer restored from step 3 hold the trained
    # ones' bits
    fresh, fresh_opt = init_train_state(run_cfg, torch.Generator().manual_seed(1), dev)
    check(not _state_equal(torch, fresh.state_dict(), model.state_dict()),
          f"{tag}: the fresh model already equals the trained one")
    step = checkpoint.restore_checkpoint(str(ckpt_dir / "step_3"), fresh, fresh_opt)
    check(step == CLI_STEPS, f"{tag}: restored step {step}")
    check(_state_equal(torch, fresh.state_dict(), model.state_dict()),
          f"{tag}: the restored state_dict differs from the trained one")
    moments = [(optimizer.adamw.state[pa], fresh_opt.adamw.state[pb])
               for ga, gb in zip(optimizer.adamw.param_groups, fresh_opt.adamw.param_groups)
               for pa, pb in zip(ga["params"], gb["params"])]
    check(fresh_opt.count == optimizer.count == CLI_STEPS
          and all(_state_equal(torch, a, b) for a, b in moments),
          f"{tag}: the restored optimizer state differs")
    log(f"[{tag}] restore: {len(model.state_dict())} tensors and {len(moments)} "
        f"parameters' AdamW moments bit-equal at step {step}")
    del fresh, fresh_opt, built[:]
    torch.cuda.empty_cache()

    # 3. resume to step 4: one step, last -> step_4
    _, steps, _ = _cli_run(torch, kernels, common + [
        "--mode", "train", "--log_folder", "run", "--visibility_budget", "auto",
        "--max_steps", "4", "--resume", "--eval_every_epochs", "0"], datasets, built)
    check(len(steps) == 1 and (ckpt_dir / "last").read_text() == "step_4",
          f"{tag}: resume ran {len(steps)} steps, last {(ckpt_dir / 'last').read_text()}")
    _check_launches(tag, steps, LAUNCHES_PER_STEP, "resumed step")
    del built[:]

    # 4. eval of step 2 at 100 views, with the budget the training derived
    # (an override: the in-training eval ran with it)
    pinned = ["--override", f"model.visibility_budget={tuple(budget)}"]
    t0 = time.perf_counter()
    ret, _, evals = _cli_run(torch, kernels, common + pinned + [
        "--mode", "eval", "--log_folder", "eval", "--ckpt_path",
        str(ckpt_dir / "step_2")], datasets, built)
    maps = {k: v for k, v in ret.items() if k.startswith("mA")}
    trained = {k[4:]: v for k, v in val_lines[0].items() if k.startswith("val/")}
    diff = max(abs(maps[k] - trained[k]) for k in trained)
    log(f"[{tag}] eval of step 2: {maps} ({time.perf_counter() - t0:.1f} s); the "
        f"in-training eval at step 2: {trained}; largest difference {diff:.3e}")
    check(maps == trained, f"{tag}: the eval's mAP differs from the in-training eval's")
    _check_launches(tag, evals, LAUNCHES_PER_SCENE, "100-view eval scene")
    del built[:]

    # 5. show: the .npy dumps and the per-view renders; its detections are
    # infer.detect's on the same scenes.  The seeded model scores no box
    # above score_thr 0.01: the show keeps every candidate (score_thr 0),
    # 50 a scale before the NMS, so that it has boxes to dump and draw
    t0 = time.perf_counter()
    _, _, evals = _cli_run(torch, kernels, common + pinned + [
        "--override", "model.test_cfg.score_thr=0.0", "--override",
        "model.test_cfg.nms_pre=50", "--mode", "show", "--log_folder", "show",
        "--ckpt_path", str(ckpt_dir / "step_2")], datasets, built)
    show_s = time.perf_counter() - t0
    show = root / "logs/show/show"
    try:
        import cv2  # noqa: F401
        suffix = ".png"
    except Exception:
        suffix = ".png.npy"
    from sgcdet_tpu_torch import infer

    shown = built[-1][0]
    for i in range(CLI_VAL_SCENES):
        for kind in ("pred_corners", "gt_corners", "scores", "labels"):
            check((show / f"{i:05d}_{kind}.npy").is_file(), f"{tag}: no {i:05d}_{kind}.npy")
        renders = list((show / f"{i:05d}").glob(f"view_*{suffix}"))
        check(len(renders) == cfg.data.n_images_test,
              f"{tag}: {len(renders)} renders of scene {i}")
        boxes, scores, labels = infer.detect(shown, val_ds[i])
        dumped = np.load(show / f"{i:05d}_scores.npy")
        same = dumped.shape == scores.shape and np.array_equal(
            np.load(show / f"{i:05d}_labels.npy"), labels)
        err = float(np.abs(dumped - scores).max()) if same and len(scores) else 0.0
        log(f"[{tag}] show scene {i}: {len(dumped)} detections, infer.detect's "
            f"{len(scores)} (scores max_abs_err {err:.3e}), {len(renders)} renders "
            f"({suffix})")
        check(same and err <= 1e-5 and len(dumped) > 0,
              f"{tag}: the show dumps differ from infer.detect's, or are empty")
    log(f"[{tag}] show: {show_s:.1f} s")
    del built[:], shown
    torch.cuda.empty_cache()

    # 5b. eval of step 2 with --sweep_band auto: the band the CLI derives
    # from the val rigs is visibility.required_sweep_band's largest, kept
    # up to 20 rows (cli.AUTO_BAND_MAX); a kept band runs the banded sweep
    # in place of K1
    from sgcdet_tpu_torch.cli import AUTO_BAND_MAX
    from sgcdet_tpu_torch.visibility import required_sweep_band

    h4, w4 = cfg.data.img_shape[0] // 4, cfg.data.img_shape[1] // 4
    need = max(required_sweep_band(val_ds.scene_poses(i)[2], cfg.data.n_images_test,
                                   cfg.model, (h4, w4)) for i in range(len(val_ds)))
    t0 = time.perf_counter()
    ret, _, evals = _cli_run(torch, kernels, common + pinned + [
        "--mode", "eval", "--log_folder", "eval_band", "--sweep_band", "auto",
        "--ckpt_path", str(ckpt_dir / "step_2")], datasets, built)
    band = built[-1][2].model.sweep_band
    maps = {k: v for k, v in ret.items() if k.startswith("mA")}
    log(f"[{tag}] eval of step 2 with --sweep_band auto: band {band} (the rigs need "
        f"{need} of {h4} rows; kept up to {AUTO_BAND_MAX}); {maps} "
        f"({time.perf_counter() - t0:.1f} s)")
    check(band == (need if need <= AUTO_BAND_MAX else None),
          f"{tag}: --sweep_band auto gave {band}, the rigs need {need}")
    check(all(math.isfinite(v) for v in maps.values()), f"{tag}: mAP {maps}")
    per_scene = dict(LAUNCHES_PER_SCENE, sweep_fwd=0) if band is not None else LAUNCHES_PER_SCENE
    _check_launches(tag, evals, per_scene, "100-view --sweep_band eval scene")
    del built[:]
    torch.cuda.empty_cache()

    # 6. one data-parallel step at world size 1 on NCCL against the
    # single-device step: same weights and scene, f32 with TF32 off
    phase_dp(torch, dev, kernels, root, train_ds)

    # 7. 100-view serving
    torch.cuda.empty_cache()
    phase_slice_f32(torch, dev, n_views=cfg.data.n_images_test)
    torch.cuda.empty_cache()
    phase_serving(torch, dev, kernels, n_views=cfg.data.n_images_test, warm_up="forward")
    torch.cuda.empty_cache()


def phase_dp(torch, dev, kernels, root, train_ds):
    """One data-parallel train step at world size 1 (NCCL through a
    FileStore in ``root``) and the single-device step from the same weights
    on ``train_ds[0]``, f32 with TF32 off: loss terms, n_pos, launches, the
    all-reduces by kind, every trainable parameter moved."""
    import torch.distributed as dist

    from sgcdet_tpu_torch import configs, parallel
    from sgcdet_tpu_torch.data import pad_gt
    from sgcdet_tpu_torch.models import layers
    from sgcdet_tpu_torch.train import init_train_state, make_train_step, param_label

    tag = "dp"
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    base = configs.scannet()
    scene = train_ds[0]  # padded as the CLI's loader pads it
    scene["gt_boxes"], scene["gt_labels"], scene["gt_mask"] = pad_gt(
        scene["gt_boxes"], scene["gt_labels"], base.data.max_boxes)
    mcfg = dataclasses.replace(base.model, compute_dtype="float32", ffn_dropout=0.0,
                               visibility_budget=_auto_budget(base, scene))
    cfg = dataclasses.replace(base, model=mcfg)
    store = root / "dp_store"
    if dev.type == "cuda":
        dist.init_process_group("nccl", store=dist.FileStore(str(store), 1), rank=0,
                                world_size=1, device_id=dev)
    else:  # a rehearsal on the CPU
        dist.init_process_group("gloo", store=dist.FileStore(str(store), 1), rank=0,
                                world_size=1)
    try:
        runs = {}
        for name, group in (("single", None), ("dp", dist.group.WORLD)):
            model, optimizer = init_train_state(cfg, torch.Generator().manual_seed(0), dev)
            before = {n: p.detach().clone() for n, p in model.named_parameters()}
            step = make_train_step(model, cfg, optimizer, group=group)
            counts = dict(parallel.COUNTS)
            for k in kernels.values():
                k.launches = 0
            t0 = time.perf_counter()
            metrics = step(scene, torch.Generator(device=dev).manual_seed(1))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = {n: k.launches for n, k in kernels.items()}
            reduces = {k: v - counts[k] for k, v in parallel.COUNTS.items()}
            moved = {n: not torch.equal(before[n], p.detach())
                     for n, p in model.named_parameters()}
            has_grad = {n: bool(p.grad.any()) for n, p in model.named_parameters()}
            n_bn = sum(1 for m in model.modules()
                       if isinstance(m, layers._F32BatchNorm) and not m.frozen)
            runs[name] = ({k: float(v) for k, v in metrics.items()}, launches, reduces)
            log(f"[{tag}] {name} step (f32, TF32 off): {secs:.3f} s; launches "
                f"{_launched(launches)}; all-reduces {reduces}")
            expected = {n: LAUNCHES_PER_STEP.get(n, 0) for n in kernels}
            check(launches == expected, f"{tag} {name}: launches {_launched(launches)}")
            frozen = [n for n in moved if param_label(n) == "frozen"]
            stuck = [n for n in moved if param_label(n) != "frozen" and has_grad[n]
                     and not moved[n]]
            check(not stuck and not any(moved[n] for n in frozen),
                  f"{tag} {name}: stuck {stuck[:3]}, frozen moved "
                  f"{[n for n in frozen if moved[n]][:3]}")
            del model, optimizer, step
            torch.cuda.empty_cache()
        (m_s, _, r_s), (m_d, _, r_d) = runs["single"], runs["dp"]
        check(not any(r_s.values()), f"{tag}: the single-device step all-reduced {r_s}")
        want = dict(dict.fromkeys(parallel.COUNTS, 0), bn_sync=n_bn, bn_sync_backward=n_bn,
                    n_pos=1, gradients=1, metrics=1, bn_stats=1)
        check(r_d == want, f"{tag}: all-reduces {r_d}, expected {want}")
        for k in m_s:
            log(f"[{tag}] {k}: dp {m_d[k]:.6f}, single {m_s[k]:.6f}")
        losses = [k for k in m_s if k.startswith("loss")]
        bad = [k for k in losses
               if abs(m_d[k] - m_s[k]) > DP_LOSS_RTOL * max(abs(m_s[k]), 1e-3)]
        check(not bad and m_d["n_pos"] == m_s["n_pos"],
              f"{tag}: loss terms {bad} or n_pos differ from the single-device step")
        log(f"[{tag}] loss terms within {DP_LOSS_RTOL:.0e} and n_pos equal; every "
            f"trainable parameter with a gradient moved and no frozen one; {n_bn} "
            f"synced BNs, one all-reduce each way")
    finally:
        dist.destroy_process_group()
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = flags


# ---------------------------------------------------------------------------
# phase 16: depth_remat
# ---------------------------------------------------------------------------

# timed bf16 steps of each depth_remat setting (after one warm-up step), at
# N_VIEWS and at the released eval's view count
REMAT_STEPS = 3
REMAT_VIEWS = 100


def phase_remat(torch, dev, kernels):
    """``depth_remat`` on ScanNet200-L: the f32 train step with and without
    the remat through the kernels (TF32 off, cuDNN deterministic), and the
    step without it a second time, whose move from the first is the
    kernels' run-to-run rounding.  The forwards of all three are the same
    computation (the forward kernels sum in a fixed order), so the remat
    step takes the plain step's ReLU signs as it is; its loss terms and BN
    running statistics equal the step's without the remat within 1e-6 of
    scale, every gradient within phase 12's bound (2e-3 of its scale plus
    4x its run-to-run move), and the depth net's BN statistics moved once:
    as the step without the remat moves them.  The remat step launches K1
    twice more (the recomputed sweeps).  Then the bf16 step with and
    without the remat at 40 and 100 views: seconds a step and peak
    memory."""
    import numpy as np

    tag = "remat"
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    runs = {}
    for name, remat in (("no remat", False), ("remat", True), ("no remat again", False)):
        cfg, scene, model, step = _train_setup(torch, dev, LARGE, compute_dtype="float32",
                                               ffn_dropout=0.0, depth_remat=remat)
        stats = lambda: {n: b.detach().clone() for n, b in model.state_dict().items()  # noqa: E731
                         if n.endswith(("running_mean", "running_var"))}
        before = stats()
        for k in kernels.values():
            k.launches = 0
        gen = torch.Generator(device=dev).manual_seed(1)
        t0 = time.perf_counter()
        metrics = step(scene, gen)
        torch.cuda.synchronize()
        launches = {n: k.launches for n, k in kernels.items()}
        log(f"[{tag}] f32 step, {name}: {time.perf_counter() - t0:.3f} s, launches "
            f"{_launched(launches)}")
        want = dict(LAUNCHES_PER_STEP_LARGE)
        if remat:
            want["sweep_fwd"] += 2  # the backward recomputes the depth net's sweeps
        check(_launched(launches) == want, f"{tag} {name}: launches {_launched(launches)}, "
              f"expected {want}")
        runs[name] = dict(metrics=metrics, before=before, after=stats(),
                          grads={n: p.grad for n, p in model.named_parameters()})
        del model, step
        torch.cuda.empty_cache()
    ref, got, again = runs["no remat"], runs["remat"], runs["no remat again"]
    for name in ref["metrics"]:
        a, b = float(got["metrics"][name]), float(ref["metrics"][name])
        log(f"[{tag}] {name}: remat {a:.7f}, without {b:.7f}")
        check(abs(a - b) <= 1e-6 * max(abs(b), 1e-3), f"{tag}: {name} differs")
    worst = []
    for name, want in ref["grads"].items():
        have = got["grads"][name]
        check(have is not None and bool(torch.isfinite(have).all()),
              f"{tag}: gradient of {name} missing or non-finite")
        scale = max(float(want.abs().max()), 1e-12)
        spread = float((again["grads"][name] - want).abs().max())
        err = float((have - want).abs().max())
        worst.append((err / (2e-3 * scale + 4 * spread), name, err, scale, spread))
    worst.sort(reverse=True)
    log(f"[{tag}] gradients, worst err/tol: " + "; ".join(
        f"{n} {r:.3f}: err {e:.2e}, scale {m:.2e}, run-to-run {s:.2e}"
        for r, n, e, m, s in worst[:4]))
    check(worst[0][0] <= 1.0, f"{tag}: gradients differ: {[w[1] for w in worst if w[0] > 1]}")
    depth_stats = [n for n in ref["after"] if n.startswith("depth_head.")]
    moved = [n for n in depth_stats if not torch.equal(ref["after"][n], ref["before"][n])]
    for n in ref["after"]:
        scale = max(float(ref["after"][n].abs().max()), 1e-3)
        err = float((got["after"][n] - ref["after"][n]).abs().max())
        check(err <= 1e-6 * scale, f"{tag}: running statistic {n} differs by {err:.3e}")
    log(f"[{tag}] BN running statistics equal to the step's without the remat; "
        f"{len(moved)} of the depth net's {len(depth_stats)} moved, once")
    check(len(moved) > len(depth_stats) // 2, f"{tag}: the depth net's BN statistics "
          "did not move")
    del runs, ref, got, again
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, \
        torch.backends.cudnn.deterministic = flags
    torch.cuda.empty_cache()

    # bf16 seconds a step and peak memory, with and without the remat
    for n_views in (N_VIEWS, REMAT_VIEWS):
        for remat in (True, False):
            label = f"{n_views} views, {'remat' if remat else 'no remat'}"
            try:
                cfg, scene, model, step = _train_setup(torch, dev, LARGE, n_views=n_views,
                                                       depth_remat=remat)
                gen = torch.Generator(device=dev).manual_seed(1)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                times = []
                for _ in range(REMAT_STEPS + 1):
                    t0 = time.perf_counter()
                    metrics = step(scene, gen)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
            except torch.cuda.OutOfMemoryError as e:
                check(not remat, f"{tag} {label}: out of memory ({e})")
                log(f"[{tag}] bf16 step {LARGE}, {label}: did not fit in device memory "
                    f"({str(e).splitlines()[0]}); not measured")
                model = step = None
                torch.cuda.empty_cache()
                continue
            vals = {k: float(v) for k, v in metrics.items()}
            check(all(map(math.isfinite, vals.values())), f"{tag} {label}: {vals}")
            log(f"[{tag}] bf16 step {LARGE}, {label}: warm seconds per step "
                f"{np.mean(times[1:]):.4f} (steps {', '.join(f'{t:.4f}' for t in times)}), "
                f"peak memory allocated {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} "
                f"GiB, loss {vals['loss']:.5f}")
            del model, step
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 17: the banded-Gram plane sweep (sweep_band)
# ---------------------------------------------------------------------------


def phase_sweep_band(torch, dev):
    """The banded sweep on the ScanNet config's indoor 40-view scene: the
    band ``visibility.required_sweep_band`` gives for the sweep's feature
    map, its violation count (0), the depth net's ``dpt_dist`` through the
    banded path against K1's (f32, TF32 off: within phase 4's 1e-4; bf16:
    no further from the f32 K1 distribution than 2x K1's own bf16 distance
    plus 1e-4), and one neighbour's correlation timed, banded beside K1."""
    from sgcdet_tpu_torch.infer import forward_scene
    from sgcdet_tpu_torch.models import SGCDet
    from sgcdet_tpu_torch.models.depth_net import get_closest_frame_ids
    from sgcdet_tpu_torch.ops.sweep import plane_sweep_correlation
    from sgcdet_tpu_torch.ops.sweep_band import (
        plane_sweep_band_violations,
        plane_sweep_correlation_banded,
    )
    from sgcdet_tpu_torch.visibility import required_sweep_band

    tag = "sweep band"
    cfg, scene = _scene_and_cfg()
    m = cfg.model
    h4, w4 = cfg.data.pad_size[0] // 4, cfg.data.pad_size[1] // 4
    band = required_sweep_band(scene["proj_feat4"], N_VIEWS, m, (h4, w4))
    db = m.dbound
    dv = torch.arange(db[0], db[1], db[2], dtype=torch.float32, device=dev)[:m.depth_channels]
    dv = dv + db[2] / 2
    proj = torch.as_tensor(scene["proj_feat4"], dtype=torch.float32, device=dev)
    nei = torch.as_tensor(get_closest_frame_ids(N_VIEWS, m.neighbor_img_num), device=dev)
    viol = [plane_sweep_band_violations(proj[nei[:, j]], proj, dv, h4, w4, band)
            for j in range(nei.shape[1])]
    log(f"[{tag}] required_sweep_band on the indoor rig: {band} of {h4} rows; "
        f"violations at that band per neighbour {viol}, one row narrower "
        f"{[plane_sweep_band_violations(proj[nei[:, j]], proj, dv, h4, w4, band - 1) for j in range(nei.shape[1])] if band > 1 else 'n/a'}")
    check(sum(viol) == 0, f"{tag}: {sum(viol)} samples outside the band")
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    dpt = {}
    for dtype in ("float32", "bfloat16"):
        mcfg = dataclasses.replace(m, compute_dtype=dtype,
                                   visibility_budget=_auto_budget(cfg, scene))
        model = SGCDet(mcfg, cfg.data.img_shape, device=dev,
                       generator=torch.Generator().manual_seed(0))
        for route, b in (("K1", None), ("banded", band)):
            model.depth_head.sweep_band = b
            dpt[dtype, route] = forward_scene(model, scene)["dpt_dist"]
        del model
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    ref = dpt["float32", "K1"]
    err_f32 = float((dpt["float32", "banded"] - ref).abs().max())
    err_k1 = float((dpt["bfloat16", "K1"] - ref).abs().max())
    err_b = float((dpt["bfloat16", "banded"] - ref).abs().max())
    err_bk = float((dpt["bfloat16", "banded"] - dpt["bfloat16", "K1"]).abs().max())
    log(f"[{tag}] dpt_dist banded vs K1: f32 max_abs_err {err_f32:.3e} (tol 1e-4); bf16 "
        f"banded {err_b:.3e} and K1 {err_k1:.3e} from the f32 K1 (tol {2 * err_k1 + 1e-4:.3e}), "
        f"banded vs K1 at bf16 {err_bk:.3e}")
    check(err_f32 <= 1e-4, f"{tag}: f32 dpt_dist differs")
    check(err_b <= 2 * err_k1 + 1e-4, f"{tag}: bf16 banded dpt_dist differs")
    del dpt
    gen = torch.Generator(device=dev).manual_seed(17)
    fea = torch.randn((N_VIEWS, 128, h4, w4), device=dev, generator=gen).to(torch.bfloat16)
    args = (fea[nei[:, 0]], fea, proj[nei[:, 0]], proj, dv)
    ms_k1 = cuda_ms(torch, lambda: plane_sweep_correlation(*args))
    ms_band = cuda_ms(torch, lambda: plane_sweep_correlation_banded(*args, band))
    err = float((plane_sweep_correlation_banded(*args, band).float()
                 - plane_sweep_correlation(*args).float()).abs().max())
    log(f"[{tag}] one neighbour's correlation, bf16 {tuple(fea.shape)}, {len(dv)} planes: "
        f"K1 {ms_k1:.4f} ms, banded (band {band}) {ms_band:.4f} ms; max_abs_diff {err:.3e}")
    # the bands --sweep_band auto keeps (at most cli.AUTO_BAND_MAX rows),
    # forced on the same inputs: the banded path's cost at those bands
    # (this rig's samples leave them, so only the time is read)
    from sgcdet_tpu_torch.cli import AUTO_BAND_MAX

    parts = []
    for b in (4, 8, 12, 16, AUTO_BAND_MAX):
        ms_b = cuda_ms(torch, lambda: plane_sweep_correlation_banded(*args, b))
        viol_b = plane_sweep_band_violations(proj[nei[:, 0]], proj, dv, h4, w4, b)
        parts.append(f"band {b}: {ms_b:.4f} ms ({ms_b / ms_k1:.2f}x K1, {viol_b} "
                     f"samples outside)")
    log(f"[{tag}] forced narrow bands, K1 {ms_k1:.4f} ms: " + "; ".join(parts))


# ---------------------------------------------------------------------------
# phase 18: use_gt_dpt
# ---------------------------------------------------------------------------


def phase_gt_dpt(torch, dev, kernels):
    """``use_gt_dpt`` on the ScanNet config (bf16, exact auto budget, depth
    loss on, downsample_factor 4) with the synthetic GT depth of
    ``scene.example_train_scene`` at the padded image's size: one forward
    (``dpt_dist`` is the one-hot of ``downsample_gt_depth``; finite heads; no
    sweep launch, the DFA3D kernels as phase 5) and one train step (finite
    metrics, the depth head's gradients zero, no sweep launch)."""
    from sgcdet_tpu_torch.models.depth_net import downsample_gt_depth

    tag = "gt depth"
    cfg, scene, model, step = _train_setup(torch, dev, use_gt_dpt=True, downsample_factor=4)
    m = cfg.model
    x = {k: torch.as_tensor(v).to(dev) for k, v in scene.items()}
    for k in kernels.values():
        k.launches = 0
    model.eval()
    with torch.no_grad():
        out = model(*(x[k] for k in ("imgs", "proj_img", "proj_feat4", "origin")),
                    gt_depth=x["gt_depth"])
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in kernels.items()}
    n, h4, w4 = x["imgs"].shape[0], cfg.data.pad_size[0] // 4, cfg.data.pad_size[1] // 4
    want = downsample_gt_depth(x["gt_depth"], 4, m.dbound, m.depth_channels,
                               m.depth_max_tol).reshape(n, h4, w4, -1).permute(0, 3, 1, 2)
    check(torch.equal(out["dpt_dist"], want.float()), f"{tag}: dpt_dist is not the GT one-hot")
    check(all(bool(torch.isfinite(t).all()) for scale in out["head_outs"] for t in scale),
          f"{tag}: non-finite head outputs")
    want_launches = {k: v for k, v in LAUNCHES_PER_SCENE.items() if k != "sweep_fwd"}
    check(_launched(launches) == want_launches,
          f"{tag}: forward launches {_launched(launches)}, expected {want_launches}")
    log(f"[{tag}] forward: dpt_dist the one-hot of the GT depth ({int(want.sum())} of "
        f"{n * h4 * w4} pixels with a bin), launches {_launched(launches)}")
    for k in kernels.values():
        k.launches = 0
    gen = torch.Generator(device=dev).manual_seed(1)
    t0 = time.perf_counter()
    metrics = step(scene, gen)
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in kernels.items()}
    vals = {k: float(v) for k, v in metrics.items()}
    check(all(map(math.isfinite, vals.values())), f"{tag}: train step {vals}")
    head = [p.grad for n, p in model.named_parameters() if n.startswith("depth_head.")]
    check(all(g is not None and not bool(g.any()) for g in head),
          f"{tag}: a depth head parameter has a nonzero gradient")
    want = {k: v for k, v in LAUNCHES_PER_STEP.items() if not k.startswith("sweep")}
    check(_launched(launches) == want, f"{tag}: train launches {_launched(launches)}, "
          f"expected {want}")
    log(f"[{tag}] bf16 train step {time.perf_counter() - t0:.3f} s (cold): "
        + ", ".join(f"{k} {v:.5f}" for k, v in vals.items())
        + f"; {len(head)} depth head tensors with zero gradients; launches {_launched(launches)}")
    del model, step
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 19: view sharding
# ---------------------------------------------------------------------------

# the ranks of the view-sharded runs on the one card (gloo, each its own
# process on cuda:0), the eval's view counts, the timed bf16 steps and
# scenes after a warm-up, and each rank process's time limit (seconds)
VIEW_RANKS = 2
VIEW_EVAL_VIEWS = (N_VIEWS, 100)
VIEW_TIMED = 3
VIEW_RANK_TIMEOUT = 600


def _pack_bits(torch, mask):
    """A bool tensor as (its bits packed 8 to a byte on the host, shape)."""
    flat = mask.reshape(-1)
    flat = torch.cat([flat, flat.new_zeros((-flat.numel()) % 8)]).view(-1, 8)
    weights = 2 ** torch.arange(8, device=flat.device, dtype=torch.uint8)
    return (flat.to(torch.uint8) * weights).sum(1, dtype=torch.uint8).cpu(), tuple(mask.shape)


def _unpack_bits(torch, packed, shape, dev):
    weights = 2 ** torch.arange(8, device=dev, dtype=torch.uint8)
    bits = packed.to(dev)[:, None].bitwise_and(weights) > 0
    return bits.reshape(-1)[:math.prod(shape)].reshape(shape)


def _digest(torch, tensors):
    """sha1 of the bytes of a list of tensors (the ranks' replicated state
    and outputs are compared by it)."""
    import hashlib

    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _view_eval_setup(torch, dev, n_views):
    """The bf16 ScanNet model with the exact auto budget of the indoor scene
    of ``n_views`` (phase 5's, seeded) and that scene."""
    from sgcdet_tpu_torch.models import SGCDet

    cfg, scene = _scene_and_cfg("scannet", n_views)
    mcfg = dataclasses.replace(cfg.model, visibility_budget=_auto_budget(cfg, scene))
    model = SGCDet(mcfg, cfg.data.img_shape, device=dev,
                   generator=torch.Generator().manual_seed(0))
    return model, scene


@contextlib.contextmanager
def _f32_flags(torch):
    """Phase 6's setting: TF32 off, cuDNN deterministic."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = flags


def _view_f32_step(torch, dev, tag, signs, picks, group=None, views=None, scene_fn=None):
    """One f32 train step (ffn_dropout 0) of ``_train_parts`` from the seeded
    weights, on the ReLU signs ``signs`` and the occupancy picks ``picks``
    (recorded into them when empty): single-process without ``group``,
    else view-sharded over it.  Returns (metrics as floats, {name:
    gradient on the host}, the model's state digest, the collectives by
    kind, the launches, seconds)."""
    from sgcdet_tpu_torch import parallel
    from sgcdet_tpu_torch.models import layers
    from sgcdet_tpu_torch.ops import KERNELS
    from sgcdet_tpu_torch.train import make_train_step, make_view_sharded_train_step

    with _f32_flags(torch):
        cfg, scene, model, optimizer = _train_parts(torch, dev, compute_dtype="float32",
                                                    ffn_dropout=0.0)
        if scene_fn is not None:
            scene = scene_fn(scene)
        step = (make_train_step(model, cfg, optimizer) if group is None else
                make_view_sharded_train_step(model, cfg, optimizer, group))
        counts = dict(parallel.COUNTS)
        for k in KERNELS.values():
            k.launches = 0
        t0 = time.perf_counter()
        with (_relu_signs_of(torch, tag, signs, views),
              _occupancy_picks_of(torch, tag, picks)):
            metrics = step(scene, torch.Generator(device=dev).manual_seed(1))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = {n: k.launches for n, k in KERNELS.items()}
    reduces = {k: v - counts[k] for k, v in parallel.COUNTS.items() if v != counts[k]}
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    digest = _digest(torch, list(model.state_dict().values()))
    n_bn = sum(1 for m in model.depth_head.modules()
               if isinstance(m, layers._F32BatchNorm) and not m.frozen)
    return ({k: float(v) for k, v in metrics.items()}, grads, digest, reduces, launches,
            secs, n_bn)


def _view_step_counts(n_bn):
    """The collectives of a rank's view-sharded train step: the depth net's
    two gathers, two a level for the fusion, the reduce-scatters of the
    features and the three levels' queries, each depth-net BN's statistics
    once each way, the depth loss once each way, the gradients once."""
    return dict(view_gather=2, view_fusion=6, view_scatter=4, view_bn=n_bn,
                view_bn_backward=n_bn, view_depth_loss=1, view_depth_loss_backward=1,
                view_gradients=1)


def _view_evals(torch, dev, evaluate, n_views, first=None, scene_fn=None, timed=VIEW_TIMED):
    """``evaluate(model, scene)`` on the bf16 eval setup of ``n_views``: a
    first call inside the context ``first`` (occupancy picks recorded or
    pinned), then ``timed`` calls.  Returns (the first call's outputs with
    the launches it made, warm seconds a scene, peak memory, the model,
    the scene)."""
    from sgcdet_tpu_torch.ops import KERNELS

    model, scene = _view_eval_setup(torch, dev, n_views)
    if scene_fn is not None:
        scene = scene_fn(scene)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in KERNELS.values():
        k.launches = 0
    with first or contextlib.nullcontext():
        out = evaluate(model, scene)
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in KERNELS.items()}
    secs = []
    for _ in range(timed):
        t0 = time.perf_counter()
        evaluate(model, scene)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    out = dict(out, launches=launches)
    return (out, sum(secs) / len(secs) if secs else None,
            torch.cuda.max_memory_allocated(dev), model, scene)


def _nudged(scene, rel, seed=2):
    """``scene`` with its images moved by ``rel`` relative noise."""
    import numpy as np

    imgs = scene["imgs"]
    noise = rel * np.random.RandomState(seed).randn(*imgs.shape)
    return dict(scene, imgs=(imgs * (1 + noise)).astype(imgs.dtype))


def _timed_bf16_steps(torch, dev, group=None):
    """A warm-up and VIEW_TIMED timed bf16 train steps (phase 7's setting)
    at N_VIEWS, single-process or view-sharded over ``group``: (warm
    seconds a step, peak memory, each step's launches, the last metrics,
    the state's digest)."""
    from sgcdet_tpu_torch.ops import KERNELS
    from sgcdet_tpu_torch.train import make_train_step, make_view_sharded_train_step

    cfg, scene, model, optimizer = _train_parts(torch, dev)
    step = (make_train_step(model, cfg, optimizer) if group is None else
            make_view_sharded_train_step(model, cfg, optimizer, group))
    gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times, per_step = [], []
    for i in range(VIEW_TIMED + 1):
        for k in KERNELS.values():
            k.launches = 0
        t0 = time.perf_counter()
        metrics = step(scene, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_step.append({n: k.launches for n, k in KERNELS.items()})
        check(all(math.isfinite(float(v)) for v in metrics.values()),
              f"bf16 step {i}: non-finite metrics")
    return (sum(times[1:]) / VIEW_TIMED, torch.cuda.max_memory_allocated(dev), per_step,
            {k: float(v) for k, v in metrics.items()},
            _digest(torch, list(model.state_dict().values())))


def view_rank_main(root: Path) -> int:
    """One rank of phase 19 (``python3 chip_smoke.py --view-rank <dir>``,
    started by ``phase_view`` with RANK, WORLD_SIZE, MASTER_ADDR and
    MASTER_PORT): gloo with CUDA tensors on cuda:0.  The f32 view-sharded
    step on the single-process step's ReLU signs (this rank's views' rows)
    and occupancy picks, the bf16 evals at VIEW_EVAL_VIEWS views and timed
    bf16 steps; writes ``rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    from sgcdet_tpu_torch import infer, parallel
    from sgcdet_tpu_torch.ops import LIBRARY
    from sgcdet_tpu_torch.train import make_view_sharded_eval_step

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=VIEW_RANK_TIMEOUT))
    group = dist.group.WORLD
    LIBRARY.get()
    tag = f"view rank {rank}"
    ref = torch.load(root / "view_ref.pt", weights_only=False)
    picks = [(sc.to(dev), pk.to(dev)) for sc, pk in ref["picks"]]
    out = {}
    metrics, grads, digest, reduces, launches, secs, n_bn = _view_f32_step(
        torch, dev, f"{tag} f32", ref["signs"], picks, group, (rank, world))
    out["f32"] = dict(metrics=metrics, digest=digest, counts=reduces, launches=launches,
                      secs=secs, n_bn=n_bn, grads=grads if rank == 0 else None)
    log(f"[{tag}] f32 step {secs:.3f} s on {dist.get_backend(group)} with CUDA tensors; "
        f"collectives {reduces}")
    del grads
    torch.cuda.empty_cache()

    evals = {}
    for n_views in VIEW_EVAL_VIEWS:
        counts = dict(parallel.COUNTS)
        want = [(sc.to(dev), pk.to(dev)) for sc, pk in ref["eval_picks"][n_views]]
        errs = []
        res, secs, peak, model, scene = _view_evals(
            torch, dev, lambda m, sc: make_view_sharded_eval_step(m, None, group)(sc),
            n_views, _occupancy_picks_of(torch, f"{tag} eval {n_views}", want,
                                         ref["eval_limits"][n_views], errs))
        head = [t for scale in res["head_outs"] for t in scale]
        rec = dict(secs=secs, peak=peak, launches=res["launches"], pick_errs=errs,
                   counts={k: (v - counts[k]) // (VIEW_TIMED + 1)
                           for k, v in parallel.COUNTS.items() if v != counts[k]},
                   digest=_digest(torch, head + [res["valid"], res["dpt_dist"]]))
        if rank == 0:  # the host decode of the gathered outputs
            rec["outputs"] = dict(head_outs=[tuple(t.cpu() for t in sc) for sc in res["head_outs"]],
                                  valid=res["valid"].cpu())
            rec["detections"] = infer.decode(model, res, scene["origin"])
        rec["unpinned_valid"] = make_view_sharded_eval_step(model, None, group)(scene)["valid"].cpu()
        evals[n_views] = rec
        log(f"[{tag}] bf16 eval {n_views} views: {secs:.4f} s a scene, peak "
            f"{peak / 2**30:.3f} GiB, launches {_launched(res['launches'])}")
        del model, res
        torch.cuda.empty_cache()
    out["evals"] = evals

    secs, peak, per_step, metrics, digest = _timed_bf16_steps(torch, dev, group)
    out["train"] = dict(secs=secs, peak=peak, launches=per_step, metrics=metrics,
                        digest=digest)
    log(f"[{tag}] bf16 steps: {out['train']['secs']:.4f} s a step, peak "
        f"{out['train']['peak'] / 2**30:.3f} GiB")
    torch.save(out, root / f"rank{rank}.pt")
    dist.barrier(group)
    dist.destroy_process_group()
    return 0


def _start_view_ranks(root):
    """The VIEW_RANKS processes of ``view_rank_main``; each logs to
    ``rank<r>.log`` in ``root``."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = []
    for rank in range(VIEW_RANKS):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(VIEW_RANKS),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        with open(root / f"rank{rank}.log", "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--view-rank", str(root)],
                env=env, stdout=f, stderr=subprocess.STDOUT))
    return procs


def _wait_view_ranks(procs, root):
    """Wait for every rank (VIEW_RANK_TIMEOUT in all), echo their logs; a
    rank that fails ends the others at once (they would wait in a
    collective) and fails the phase."""
    deadline = time.monotonic() + VIEW_RANK_TIMEOUT
    try:
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, p in enumerate(procs):
        text = (root / f"rank{rank}.log").read_text()
        lines = [ln for ln in text.splitlines() if ln.startswith("[") or "Error" in ln
                 or "FAILED" in ln]
        for ln in lines[-40:]:
            log(f"    {ln}")
        check(p.returncode == 0,
              f"view rank {rank} exited with {p.returncode}: {text[-2000:]}")


def phase_view(torch, dev, kernels, root):
    """Phase 19: the ScanNet config's views split over ranks
    (``train.make_view_sharded_train_step`` / ``make_view_sharded_eval_step``)
    against the single-process step and eval on the card."""
    import numpy as np
    import torch.distributed as dist

    from sgcdet_tpu_torch import infer
    from sgcdet_tpu_torch.train import make_view_sharded_eval_step

    tag = "view"
    card = card_line()

    def say(msg):  # a measured line, beside the card it was measured on
        log(f"{msg} ({card})")

    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    # the single-process f32 step, whose ReLU signs and occupancy picks every
    # other f32 step here takes, and the same on images nudged by 1e-7 (the
    # bound's rounding term)
    signs, picks = [], []
    single = _view_f32_step(torch, dev, f"{tag} f32 single", signs, picks)
    say(f"[{tag}] single-process f32 step {single[5]:.3f} s")
    nudged = _view_f32_step(torch, dev, f"{tag} f32 nudged", signs, picks,
                            scene_fn=lambda sc: _nudged(sc, 1e-7))
    torch.cuda.empty_cache()
    n_bn = single[6]
    step_counts = _view_step_counts(n_bn)
    expected_step = {n: LAUNCHES_PER_STEP.get(n, 0) for n in kernels}
    expected_scene = {n: LAUNCHES_PER_SCENE.get(n, 0) for n in kernels}

    # world size 1 on NCCL (a FileStore): the product route
    store = root / "nccl_store"
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1), rank=0,
                            world_size=1, device_id=dev)
    try:
        nccl = _view_f32_step(torch, dev, f"{tag} f32 nccl", signs, picks,
                              dist.group.WORLD, (0, 1))
        say(f"[{tag}] NCCL world size 1 f32 step {nccl[5]:.3f} s; collectives {nccl[3]}")
        _compare_steps(torch, f"{tag} nccl", single[:2], nudged[:2], nccl[:2],
                       ("view nccl", "single", "nudged single"))
        check(nccl[3] == step_counts, f"{tag} nccl: collectives {nccl[3]}, expected {step_counts}")
        check(nccl[4] == expected_step, f"{tag} nccl: launches {_launched(nccl[4])}")
        nccl_eval, nccl_secs, _, model, scene = _view_evals(
            torch, dev, lambda m, sc: make_view_sharded_eval_step(m, None, dist.group.WORLD)(sc),
            N_VIEWS)
        say(f"[{tag}] NCCL world size 1 bf16 eval {N_VIEWS} views: {nccl_secs:.4f} s a scene")
        del model
        nccl_train = _timed_bf16_steps(torch, dev, dist.group.WORLD)
    finally:
        dist.destroy_process_group()

    single_train = _timed_bf16_steps(torch, dev)
    for name, rec in (("single process", single_train), ("NCCL world size 1", nccl_train)):
        check(all(step == expected_step for step in rec[2]),
              f"{tag} bf16 steps, {name}: launches {rec[2]}")
    say(f"[{tag}] bf16 train step at {N_VIEWS} views: single process {single_train[0]:.4f} s "
        f"a step, peak {single_train[1] / 2**30:.3f} GiB; view-sharded at NCCL world size 1 "
        f"{nccl_train[0]:.4f} s, peak {nccl_train[1] / 2**30:.3f} GiB")
    torch.cuda.empty_cache()

    # the single-process bf16 evals, the ranks' references: the first call's
    # occupancy picks, which the ranks take, and the same call on images
    # nudged by 2^-9 relative noise on those picks, whose move measures how
    # far bf16 rounding alone moves the outputs (phase 6's nudge at bf16)
    evals = {}
    for n_views in VIEW_EVAL_VIEWS:
        picks_n, errs = [], []
        res, secs, peak, model, scene = _view_evals(
            torch, dev, infer.forward_scene, n_views,
            _occupancy_picks_of(torch, f"{tag} eval {n_views} single", picks_n))
        dets = infer.decode(model, res, scene["origin"])
        del model
        moved, _, _, model, scene = _view_evals(
            torch, dev, infer.forward_scene, n_views,
            _occupancy_picks_of(torch, f"{tag} eval {n_views} nudged", picks_n,
                                [(math.inf, math.inf)] * len(picks_n), errs),
            scene_fn=lambda sc: _nudged(sc, 2.0 ** -9), timed=0)
        evals[n_views] = dict(out=res, secs=secs, peak=peak, detections=dets, picks=picks_n,
                              nudged=moved, nudged_detections=infer.decode(
                                  model, moved, scene["origin"]),
                              limits=[(max(PICK_SCORE_TOL * float(sc.abs().max()), 4 * err),
                                       max(PICK_SWAPS_MAX, 4 * swaps))
                                      for (sc, _), (err, swaps) in zip(picks_n, errs)])
        say(f"[{tag}] single-process bf16 eval {n_views} views: {secs:.4f} s a scene, "
            f"peak {peak / 2**30:.3f} GiB")
        del model
    torch.cuda.empty_cache()
    # world size 1 runs the single process's batch: bit-equal outputs
    check(all(torch.equal(x, y) for a, b in zip(nccl_eval["head_outs"],
                                                 evals[N_VIEWS]["out"]["head_outs"])
              for x, y in zip(a, b))
          and torch.equal(nccl_eval["valid"], evals[N_VIEWS]["out"]["valid"]),
          f"{tag}: the NCCL world-size-1 eval differs from the single process's")
    log(f"[{tag}] NCCL world size 1 bf16 eval: outputs bit-equal to the single process's")
    problems = []  # the bf16 comparisons, all logged before the phase fails

    def compare_eval(what, got, want, nudged):
        """``valid`` identical; each head output within 4x its move under the
        nudge (at least one bf16 unit, 2^-8 of its scale)."""
        if not torch.equal(got["valid"].to(want["valid"].device), want["valid"]):
            problems.append(f"{what}: valid differs")
        rows = []
        for lvl, (a, b, c) in enumerate(zip(got["head_outs"], want["head_outs"],
                                            nudged["head_outs"])):
            for name, x, y, z in zip(("centerness", "bbox", "cls"), a, b, c):
                x, y, z = x.to(y.device).float(), y.float(), z.float()
                scale = max(float(y.abs().max()), 1e-3)
                err = float((x - y).abs().max())
                tol = 4 * max(float((z - y).abs().max()), 2.0 ** -8 * scale)
                rows.append((err / tol, f"{name} {lvl}", err, tol, scale))
        rows.sort(reverse=True)
        log(f"[{what}] head outputs (err / tol / scale): "
            + "; ".join(f"{n} {e:.3e} / {t:.3e} / {sc:.3e}" for _, n, e, t, sc in rows))
        if rows[0][0] > 1.0:
            problems.append(f"{what}: head output {rows[0][1]} differs")

    def compare_detections(what, got, want, nudged):
        """The same boxes and labels, each coordinate and score within 4x
        its move under the nudge (at least a bf16 unit of its scale)."""
        (bg, sg, lg), (bw, sw, lw), (bn, sn, ln) = got, want, nudged

        def tol(moved, ref):
            if not len(ref):
                return 0.0
            return 4 * max(float(np.abs(moved - ref).max()) if len(moved) == len(ref) else 0.0,
                           2.0 ** -8 * float(np.abs(ref).max()))

        same = len(bg) == len(bw) and np.array_equal(lg, lw)
        err_b = float(np.abs(bg - bw).max()) if same and len(bw) else 0.0
        err_s = float(np.abs(sg - sw).max()) if same and len(bw) else 0.0
        tol_b, tol_s = tol(bn, bw), tol(sn, sw)
        log(f"[{what}] detections: {len(bg)} boxes against {len(bw)} (the nudged run "
            f"{len(bn)}), labels {'equal' if same else 'differ'}; boxes' largest difference "
            f"{err_b:.3e} (tol {tol_b:.3e}), scores' {err_s:.3e} (tol {tol_s:.3e}); "
            f"bit-equal {same and np.array_equal(bg, bw) and np.array_equal(sg, sw)}")
        if not same or err_b > tol_b or err_s > tol_s:
            problems.append(f"{what}: detections differ")

    # the ranks: the signs go packed (their views' rows are taken there)
    torch.save(dict(signs=[_pack_bits(torch, sg) for sg in signs],
                    picks=[(sc.cpu(), pk.cpu()) for sc, pk in picks],
                    eval_picks={n: [(sc.cpu(), pk.cpu()) for sc, pk in ev["picks"]]
                                for n, ev in evals.items()},
                    eval_limits={n: ev["limits"] for n, ev in evals.items()}),
               root / "view_ref.pt")
    del signs, picks
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _wait_view_ranks(_start_view_ranks(root), root)
    log(f"[{tag}] {VIEW_RANKS} rank processes took {time.perf_counter() - t0:.1f} s")
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(VIEW_RANKS)]
    f32 = [r["f32"] for r in ranks]
    _compare_steps(torch, f"{tag} {VIEW_RANKS} ranks",
                   single[:2], nudged[:2], (f32[0]["metrics"], f32[0]["grads"]),
                   (f"view {VIEW_RANKS} ranks", "single", "nudged single"))
    for r, rec in enumerate(f32):
        check(rec["metrics"] == f32[0]["metrics"], f"{tag}: rank {r}'s metrics differ")
        check(rec["digest"] == f32[0]["digest"], f"{tag}: rank {r}'s state differs")
        check(rec["counts"] == step_counts,
              f"{tag} rank {r}: collectives {rec['counts']}, expected {step_counts}")
        check(rec["launches"] == expected_step,
              f"{tag} rank {r}: launches {_launched(rec['launches'])}")
        say(f"[{tag}] rank {r} f32 step: launches {_launched(rec['launches'])}; collectives "
            f"{rec['counts']}")
    log(f"[{tag}] f32 step: the ranks' metrics and parameters bit-identical")
    for n_views in VIEW_EVAL_VIEWS:
        recs = [r["evals"][n_views] for r in ranks]
        ref = evals[n_views]
        unpinned = int((recs[0]["unpinned_valid"] != ref["out"]["valid"].cpu()).sum())
        log(f"[{tag} eval {n_views} views] on its own occupancy picks, {unpinned} voxels of "
            f"{ref['out']['valid'].numel()} of valid differ from the single process's")
        compare_eval(f"{tag} eval {n_views} views", recs[0]["outputs"], ref["out"],
                     ref["nudged"])
        compare_detections(f"{tag} eval {n_views} views", recs[0]["detections"],
                           ref["detections"], ref["nudged_detections"])
        for r, rec in enumerate(recs):
            check(rec["digest"] == recs[0]["digest"],
                  f"{tag} eval {n_views} views: rank {r}'s outputs differ")
            check(rec["launches"] == expected_scene,
                  f"{tag} eval rank {r}: launches {_launched(rec['launches'])}")
            check(rec["counts"] == dict(view_gather=3, view_fusion=6),
                  f"{tag} eval rank {r}: collectives {rec['counts']}")
        say(f"[{tag}] bf16 eval {n_views} views: ranks' outputs bit-identical; launches a "
            f"scene a rank {_launched(recs[0]['launches'])}; collectives a scene "
            f"{recs[0]['counts']}")
        say(f"[{tag}] bf16 eval {n_views} views, two processes sharing one card: "
            + ", ".join(f"rank {r} {rec['secs']:.4f} s a scene, peak "
                        f"{rec['peak'] / 2**30:.3f} GiB" for r, rec in enumerate(recs))
            + f"; one process alone {ref['secs']:.4f} s a scene, peak "
              f"{ref['peak'] / 2**30:.3f} GiB")
    trains = [r["train"] for r in ranks]
    for r, rec in enumerate(trains):
        check(all(step == expected_step for step in rec["launches"]),
              f"{tag} bf16 steps rank {r}: launches {rec['launches']}")
        check(rec["digest"] == trains[0]["digest"] and rec["metrics"] == trains[0]["metrics"],
              f"{tag} bf16 steps: rank {r}'s state or metrics differ")
    check(not problems, f"{tag}: {problems}")
    say(f"[{tag}] bf16 train step at {N_VIEWS} views, two processes sharing one card: "
        + ", ".join(f"rank {r} {rec['secs']:.4f} s a step, peak {rec['peak'] / 2**30:.3f} GiB"
                    for r, rec in enumerate(trains))
        + f"; launches a step a rank {_launched(trains[0]['launches'][-1])}; the ranks' "
          f"state bit-identical after {VIEW_TIMED + 1} steps")
    shutil.rmtree(root, ignore_errors=True)


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def main() -> int:
    repo = Path(__file__).resolve().parent
    if not (repo / "sgcdet_tpu_torch").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(sgcdet_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    import torch

    if sys.argv[1:2] == ["--view-rank"]:  # a rank process of phase 19
        return view_rank_main(Path(sys.argv[2]))

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
              "False); this smoke run needs the GPU and never falls back to "
              "the CPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = card_line()
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {smi}")

    from sgcdet_tpu_torch.ops import KERNELS, LIBRARY

    t0 = time.perf_counter()
    LIBRARY.get()
    build_s = time.perf_counter() - t0
    log(f"[build] kernels ready in {build_s:.2f} s (nvcc "
        f"{'not run: reused ' if LIBRARY.build_seconds is None else ''}"
        f"{'' if LIBRARY.build_seconds is None else f'{LIBRARY.build_seconds:.2f} s'})")
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", LIBRARY.log)]
    spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill", LIBRARY.log))
    if regs:
        log(f"[build] ptxas: {len(regs)} kernel instances, at most {max(regs)} "
            f"registers per thread, {spills} bytes of spills")

    from sgcdet_tpu_torch.experiments import probes

    check(set(KERNEL_INFO) <= set(KERNELS) | set(probes.KERNELS),
          "KERNEL_INFO names a kernel that has no launch counter")
    report = {name: {} for name in KERNEL_INFO}
    serving, train, lifting_2d, f32_scene = {}, {}, {}, {}
    sorted_serving, sorted_train, probe_runs = {}, {}, {}
    large_serving, large_train = {}, {}
    large_sorted_serving, large_sorted_train = {}, {}
    arkit_runs, detections = {}, {}
    cli_root = repo / "build" / "cli_smoke"
    shutil.rmtree(cli_root, ignore_errors=True)
    cli_root.mkdir(parents=True)
    for name, fn in (
            ("kernels", lambda: phase_kernels(torch, dev, report)),
            ("backward", lambda: phase_backward(torch, dev, report)),
            ("frozen bn", lambda: phase_frozen_bn(torch, dev, report)),
            ("slice f32", lambda: f32_scene.update(phase_slice_f32(torch, dev))),
            ("serving", lambda: serving.update(phase_serving(
                torch, dev, KERNELS, detections=detections.setdefault("scannet", [])))),
            ("train f32", lambda: phase_train_f32(torch, dev)),
            ("train", lambda: train.update(phase_train(torch, dev, KERNELS))),
            ("2D lifting", lambda: lifting_2d.update(phase_lifting_2d(torch, dev, KERNELS))),
            ("windowed", lambda: phase_windowed(torch, dev, report)),
            ("sorted", lambda: phase_sorted(torch, dev, KERNELS, f32_scene,
                                            sorted_serving, sorted_train)),
            ("probes", lambda: probe_runs.update(phase_probes(torch, dev, report))),
            ("large", lambda: phase_large(torch, dev, KERNELS, large_serving, large_train,
                                          large_sorted_serving, large_sorted_train)),
            ("arkit", lambda: phase_arkit(torch, dev, KERNELS, report, arkit_runs,
                                          detections)),
            ("eval", lambda: phase_eval(torch, detections)),
            ("cli", lambda: phase_cli(torch, dev, KERNELS, cli_root)),
            ("remat", lambda: phase_remat(torch, dev, KERNELS)),
            ("sweep band", lambda: phase_sweep_band(torch, dev)),
            ("gt depth", lambda: phase_gt_dpt(torch, dev, KERNELS)),
            ("view", lambda: phase_view(torch, dev, KERNELS, repo / "build" / "view_smoke"))):
        t0 = time.perf_counter()
        fn()
        log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        rec = report[name]
        # launches: the main path of each kernel (the train step; the bf16
        # 2D lifting run for the bf16-depth instances; the sorted train
        # step for the windowed kernels; the probes' run for theirs; the
        # ScanNet200-L train step for the -L instances)
        if name in KERNELS_2D:
            launches, served = lifting_2d[name], 0
        elif name in KERNELS_SORTED:
            launches, served = sorted_train[name], sorted_serving[name]
        elif name in PROBE_MAIN:
            launches, served = probe_runs[name], 0
        elif name in KERNELS_LARGE:
            launches, served = large_train[name], large_serving[name]
        elif name in KERNELS_SORTED_LARGE:
            launches, served = large_sorted_train[name], large_sorted_serving[name]
        else:
            launches, served = train[name], serving[name]
        # the ARKit runs' launches of the kernels they share: the arkit
        # config's of ScanNet's widths, arkit_large's of the -L ones
        arkit = arkit_runs["arkit_large" if name in KERNELS_LARGE else "arkit"]
        missing = [key for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms") if key not in rec]
        check(not missing, f"{name}: no {missing} measured")
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=launches,
                            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
                            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
                            bound_by=rec["bound_by"], library_ms=rec["library_ms"],
                            serving_launches=served,
                            arkit_launches=arkit["train"].get(name, 0),
                            arkit_serving_launches=arkit["serving"].get(name, 0)))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
