"""Smoke test of the PyTorch/CUDA port (tpu_mot_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing lines tagged with its name (any failure raises:
nonzero exit, no "ok" line):
  device     a CUDA card, its name and power limit (nvidia-smi);
  build      nvcc builds tpu_mot_torch/csrc, one process per source;
  roi        K1 (ROI kernel) against its plain version on a 1080p u8 bench
             frame: the fixture's 128 first-frame boxes at S = 64, 48 and
             32 (the template sizes of bench_template_size), the edge
             cases, 37 seeded boxes (a ragged T) at S = 64, 48 and 30, and
             the
             single-object bank's 3-scale call (the 128 boxes x 3 per-track
             scales, 384 rows), u8 and f32 pyramids: max |diff| 1e-5 and
             bit-equal to the kernel's torch mirror (four_tap_mirror); the
             code path of each case is printed and asserted;
  roi3       K3 (3-scale ROI kernel) against its plain version: the 128
             bench boxes at scales 1/1.05, 1, 1.05, plus the edge cases
             and a box straddling a level boundary, and 37 seeded boxes
             (a ragged T), u8 and f32 pyramids (max |diff| 1e-5);
  auction    K2 against its plain version: benefit matrices of the bench
             run's first frames, random n in {8, 40, 160}, all-infeasible,
             dead rows, a capped solve, odd n (7, 33, 159: padded rows,
             scalar staging; 159 needs over 50 rounds), n = 237 (the
             largest matrix staged into shared memory), the hard fixture's
             first three [256, 256] matrices and random n in {238, 240,
             256, 257, 512, 1024} (rows read from global memory, float4 or
             scalar loads), contested matrices (a price war) at 256 and
             512, a capped solve at 256, a batch [8, 256, 256] (each
             problem also alone), tie-heavy matrices quantised to a grid of
             0.25 at 40, 159, 160, 256, 257 (col_of and iters exactly
             equal), and n = 1025 refused;
  kcf        K4 (fused detect) and K5 (fused train + blend) against their
             plain versions, relative to each tensor's largest magnitude
             (1e-4 response and xf, 1e-3 alphaf): inputs captured from the
             first frames of an HF run ([384, 31, 16, 16] features, a
             [128, ...] bank; the FFT kernels) and at the gray shape (S=64,
             C=1, T=128; the direct kernels); K4 and K5 alone at C=3, S=12
             (direct kernels) and twice on the HF inputs (bit-equal); the
             code path of each case is printed and asserted; K6 (detect-site
             train + blend from the spectrum) at the serve cell's 32,768
             rows of gray S = 64 against its plain version (K6_TOL), twice
             (bit-equal), on 4 of its rows alone (equal to the same rows of
             the batch), one launch a call by its counter; K8 (stage 2's
             gray search) on the gray bank at the serve cell's 32,768 rows
             (frame 1's windows tiled) and at K = 3 (the windows at the
             3-scale search's scales, 3 x 128 items on 128 rows) against
             its plain version (K8_TOL), twice (bit-equal), on 4 rows alone
             and on each scale's items alone (equal to the batch's);
  epilogue   K7 (the ConvBlock epilogue: BatchNorm, leaky ReLU or Mish
             and the shortcut add in place) bit-equal to the chain it
             replaces (float32 words, NaN too; random values with +-0,
             infinities, values near float32's largest) at every BatchNorm
             block's output shape of YOLOv3-608, yolov3-tiny-416 and
             YOLOv4-608 at batch 2, with the skip where YOLOv3 and YOLOv4
             have one and Mish where YOLOv4 has it, and at 182 x 32 x 608 x
             608 with a skip (past 2^31 elements); then detect_batch on 720p
             u8 frames at the benchmark cells' batches (YOLOv3-608 x 128,
             yolov3-tiny-416 x 256, YOLOv4-608 x 128): launches counted from
             0 (72 / 11 / 107 K7, 72 of YOLOv4's with Mish, and no other
             kernel, no chain block), every K7 call held word for word
             against the plain version on the path's own inputs, and the
             detections bit-equal to the chain's; device ms of K7 and the
             chain, and the byte bound, at YOLOv3-608's and YOLOv4-608's
             layer 0 at batch 128, at their first residual block's shape
             with the skip, and at YOLOv4's largest leaky block;
  e2e        the default configuration on bench.py's fixture (seed 0, 128
             objects, 64 frames, 1080p u8) through tracker.scan.run_sequence
             on cuda:0: MOTA >= the JAX reference's MOTA - 0.01, exactly 64
             launches of K1, K2, K6 and K8 and none of K3-K5; then
             MultiTracker.init + 4 updates must give run_sequence's
             confirmed ids and boxes;
  e2e-heavy  the heavy configuration, fHOG-31 + 3-scale, in modes H (K3,
             K2 64 launches each, the FFT chain) and HF (K1-K5 64 each) on
             the same fixture: the MOTA gate, the exact launch counts, and
             ids, valid and boxes per frame against a dump of the JAX run
             (tests/golden/bench_heavy_jax_v1.npz);
  e2e-assoc  the association branches on a class fixture (three detector
             classes, 6-column detections) in modes A (class-aware, so
             assoc_box "best", with the appearance blend) and AW (A with the
             warm-started auction): the MOTA gate against the JAX run's MOTA,
             exact launches (A: K1 and K2 64 each; AW: K1 64, K2 none: the
             warm auction is plain torch), every valid track's class equal
             to its matched detection's, ids and valid per frame equal to a
             dump of the JAX run (tests/golden/bench_assoc_jax_v1.npz) with
             boxes within 0.05 px, and AW's auction rounds and host-side
             loop checks per frame;
  e2e-detect the detector path of bench_e2e.py (yolov3-tiny, 80 classes at
             416, seeded weights, on 32 u8 frames of 720p; 128 tracks, 64
             detections): the candidates before NMS of frames 0-1 against
             the JAX dump (tests/golden/detect_e2e_jax_v1.npz), NMS on the
             card equal index for index to NMS on the CPU fed the card's
             candidates, the detections against the dump's as sets (a
             floor of matches a frame), run_sequence fed the dump's
             detections against the dump's tracks (ids and valid equal,
             every box within 0.05 px: a free run on frames 0-27, then
             frames 28-31 from JAX's bank after frame 27, which the dump
             keeps, with K8's plain version and with K8, whose slots that
             follow another auction choice than the plain version's are
             excused where that choice is a tie on a float64 search's
             costs, E2E_TIE_EPS), exact K1, K2, K6, K8 and K7 launches of the fused
             detect -> track run (K7: 11, one forward) and the same run with
             every K1, K2, K6 and K8 call held against its plain version (K1
             1e-5 and bit-equal to the 4-tap mirror, K2 col_of and iters
             exactly, K6 K6_TOL, K8 K8_TOL), the detector call again with
             each of its 11 K7 calls held word for word against its plain
             version (the detections
             the counted run's), the strided
             scans (stride 3,
             N = 32 and 30) and the batched form (equal to run_sequence
             fed its detections; its forward's detections within 2e-3 of
             the B = 1 forwards'; to the scanned form step by step from the
             same bank, but for slot-frames that the two steps match to
             other detections), bf16 + fast NMS and int8 against float32
             (int8: one quantised layer bit-equal on the card and the CPU,
             scores moved by more than float32 noise; the stages' times
             are the bench phase's bench_e2e twin's);
  kcf-bank   the single-object flow: KCFTracker (T = 1) on a 480 x 640 clip
             of 100 frames (centre error under 2 px, exactly 1 + 2 x 99 K1
             launches), then a bank of the bench fixture's 128 first-frame
             boxes through run_otb_sequence over the 64 frames, gray with
             refined- and detect-site training and fHOG-31 + 3-scale
             refined: exact K1 launches, mean IoU with the ground truth at
             least the JAX CPU run's less 0.02, and each frame's boxes
             within 0.05 px of a step from the same bank with K1's plain
             version in K1's place (a free run with the plain version is
             printed beside it: lost slots drift apart by pixels);
  serve      multi-stream serving, BASELINE.json configs[4] on one card:
             8 streams of the bench generator (stream s at seed s, 32
             frames of 1080p u8, 128 tracks) through parallel/serve.py, one
             set of launches a multi-stream frame (K1, K2, K6 and K8 once
             a frame for all streams; HF K1-K5): exact launch counts; ids,
             valid and
             boxes (0.05 px) and each stream's MOTA against the JAX run's
             dump (tests/golden/serve_jax_v1.npz), stream 0 against the
             default cell; multi_stream_step against 8 single steps from
             the same banks on every frame (default 32, HF 8 frames: ids,
             valid, state, matches and rounds equal, boxes 1e-4; the
             default bit-equal in every field); every K1-K6 and K8 call
             of a serving run against its plain version (K1, K3 1.8e-7
             and bit-equal to the 4-tap mirror; K2's batch equal to the
             plain version and to a launch per problem; K4, K5, K8 as in
             kcf), K2 batches of odd n (5, 161); the shared yolov3-tiny
             (tools/bench_configs4.py's: 80 classes at 416, 64 detections):
             the fused shared step's exact launches (K1, K2, K6, K8 once,
             K7 11 times) with every call held against its plain version
             (K7 word for word), its shared and data-parallel forms equal, the
             strided serving (stride 4) equal to the stream sequence fed
             each head frame's detections, class-blind and class-aware, the
             batched forward within 2e-3 of B = 1 forwards; the
             StreamSupervisor (0 failures on a clean stream, 1 after a
             poisoned bank); aggregate stream-frames/s at S = 1, 2, 4, 8
             against 8 run_sequence calls and of the fused detect -> track
             step (f32 greedy, bf16 + fast NMS, strided-4), interleaved
             samples with their spread; peak device memory; later, in the
             times and profile phases, each kernel at its serving shape and
             the launches and busy share of a multi-stream frame;
  dist       the multi-device contract (parallel/mesh.py) at the serve
             phase's size: the 8 streams sharded over ranks of one process
             each (mesh.spawn), world min(cards, 4) over NCCL and worlds 2
             and 4 over gloo on cuda:0, each rank rendering its own
             streams: the tracker cell (multi_stream_sequence, every rank's
             K1 and K2 counted and each call held to its plain version),
             the shared detector batch (all-gather of the 8 frames, one
             forward on every rank: bit-equal to the one-process forward;
             the per-shard forwards matched to it as sets), the fused
             shared-detector step and strided-4 serving over the mesh
             (every rank's launches counted, K7 11 a forward over 9
             forwards; K1, K2, K7 and K8 calls held to their plain
             versions, K7 word for word, K8 to K8_TOL or, over its
             response's limit, to K8_F64_RATIO of its plain version's error
             against float64; K6's printed), gathered in rank order
             against the serve phase's one-process
             runs (bit for bit at world 1; ids and valid equal, boxes 1e-4
             px at worlds 2 and 4) and the tracker cell against the JAX
             dump; aggregate stream-frames/s of the sharded tracker and of
             the fused step per world; the data-parallel train step
             (yolov3-tiny at 416, SGD, a global batch of 32 distinct
             scenes) at worlds 1 and 2 against the one-process step: step
             0's loss (1e-5 relative), the running statistics (1e-5) and
             parameters (5e-2 of the update) after it, step 1's loss (1e-3
             relative), every rank bit-identical after 3 steps, images/s;
             at world 2 the same step with per-rank statistics, with no
             gradient sum and with averaged gradients must fail them;
  train      detector training at full width (see TRAIN_DUMP): yolov3-tiny,
             80 classes at 416, float32, seeded weights, Adam 1e-3 on a batch
             of 4 bench-generator scenes, on cuda:0: the port's resize of the
             scenes against the dump's images, step 0's loss, every gradient
             leaf's norm, the heads' full gradients and the running
             statistics after it, then 3 steps' losses and the running
             statistics after them, against the JAX dump; int8 refused; the
             toy convergence of tests/test_train.py:122 (mAP@0.5 through
             detect_batch and detection_map past the gate); the train state
             saved after step 2 and loaded into a fresh state (steps 3-4
             bit-equal, deterministic cuDNN); save_pipeline of the default
             bank after frame 31 and a yolov3-tiny state dict (frames 32-63
             bit-equal to the uninterrupted run); images/s and ms a step at
             batches 16 and 32, float32 and bfloat16 (interleaved samples,
             median and spread), peak device memory of a step; at the
             end of the run (after the profile phase, since the profiler
             loses records after long sessions) the launches and busy
             share of profiled steps at batch 32;
  cli        the application layer: `python -m tpu_mot_torch mot --synthetic
             --objects 128 --frames 64 --max-dets 160 --score` as a
             subprocess on the default device (exit 0, MOTA at least the JAX
             CLI's less 0.01, tests/golden/cli_jax_v1.json); the same run in
             process with exactly one K1 and one K2 launch a frame, and with
             the HF flags on 32 frames K1-K5 once a frame each; the native
             runtime (the g++ build, assign equal to scipy_assign on the
             bench run's first 3 cost matrices, the StreamScheduler's 8 x
             1080p u8 batches bit-equal to what was pushed and fed to
             multi_stream_step equal to the serve phase's run); where OpenCV
             imports, mot --seq and eval --root over a MOT16 directory of the
             bench fixture (the MOTA gate), otb with --gt and video with
             --det-stride 3 on a 720p mp4; without it one line says what did
             not run;
  bench      the twins of the repo's measuring scripts, each through its
             main at full size with 3 samples, printing its JSON lines
             (tpu_mot_torch/tools/): bench (MOTA at the gate, value > 0,
             device the card's nvidia-smi line), bench_variants (the
             default row and fhog31 + 3-scale at the MOTA gate, every other
             row at least 0.5, bench.py's rule), bench_e2e (its detector
             stage's detections on frame 0 equal to e2e-detect's, the same
             seeded weights) and bench_latency (46 timed update calls);
  tools      the twins of the JAX package's last five measuring tools,
             each through its main at full size with 3 samples, printing
             its JSON lines, the launch counts read around each:
             bench_otb (K1 only; every row within OTB's 20 px and its
             largest centre error within OTB_CPU_BOUND_PX of the same row
             run on the CPU), bench_configs4 (dp and shared bit-equal,
             every row a rate, K1 and K2 exactly once a multi-stream
             frame), bench_ingest (the native scheduler, live tracks on
             every stream, its counters balanced: fresh + repeated = steps,
             pushed = fresh + dropped + left in the ring; K1 and K2 once a
             step),
             bench_hard_fixture (K2 at n = 256 on every frame, its rows
             from global memory; K1 on the KCF tiers; each tracker tier's
             ids and valid equal to tests/golden/hard_fixture_jax_v1.npz
             on every frame, boxes within 0.05 px, HOTA and MOTA within
             0.005) and train_e2e_mota (the loss halves; mAP@50 at least
             0.75 of the JAX tool's CPU run; K1 and K2 once a tracked
             frame); then K2 on a hard-fixture
             matrix against its plain version, timed (the kernels line's
             auction_solve_global row);
  sweeps     the twins of the JAX package's last four measuring tools on
             bench.py's fixture, each through its main at full size with 3
             samples, printing its JSON lines, the launch counts read
             around each row, and in each row the calls SWEEP_CHECK_AT of
             every kernel at every input shape it runs at (K1 at 128 rows
             of S = 64, 48, 32 and at S x 128 rows, K3, K2 [S, 160, 160])
             held against its plain version on the path's own inputs
             (K1/K3 1e-5 and bit-equal to the mirror, K2 exact):
             bench_multistream (S = 1, 2, 4, 8 copies of the first 32
             frames: every stream bit-equal to stream 0 of S = 1, which
             equals run_sequence; K1 and K2 once a multi-stream frame, K2
             [S, 160, 160]), bench_class_cost (the class-blind and
             class-aware rows against tests/golden/sweeps_jax_v1.npz: ids
             and valid every frame, boxes 0.05 px, the auction's rounds
             every frame, the last bank's alphaf of SWEEP_BANK_SLOTS slots
             1e-3 of the largest magnitude), bench_train_site (the refined
             rows against the dump so, and MOTA within 0.005; the detect
             rows at the MOTA gate; K1, K3 and K2 launches a frame exactly
             TRAIN_SITE_LAUNCHES) and bench_template_size (48 and 32
             against the dump so, MOTA and HOTA within 0.005; 64 at the
             MOTA gate); every line names the card and has a rate above 0;
  times      run_sequence frames/s (default and H: the bench phase's
             twins; HF, A, AW: median of 3); each kernel against its plain
             version: the median ms per call from a CUDA event pair around
             each call (plain/kernel/kernel/plain; it includes the
             wrapper's host time, which bounds a short kernel) and the
             device ms per call from the profiler; the least time the card
             could take (bound);
             K2 also on the init frame's matrix and capped at 0 rounds
             (launch and staging alone); K1 also at one track (one CTA) and
             at 384 rows; build_pyramid at 1080p, float32 and u8; for every
             kernel the code path, registers, shared memory and CTAs per SM;
  profile    where device time goes over 16 frames, default, HF and AW, and
             how often the host reads a device scalar (AW: the warm
             auction's loop checks); then the fused detect -> track run of
             e2e-detect (launches a frame, the device's busy share) and
             one detect_batch call alone, greedy and fast NMS.
The line before the last is {"kernels": [...]}: per kernel its launches
in the path that runs it (K1, K2: default; K3-K5: HF), K2's global-memory
path ("auction_solve_global": its launches in the tools phase's hard
fixture run, n = 256), K7's ("epilogue": its launches counted in the
epilogue phase's detect_batch of YOLOv3-608 at 128 frames, its times at
layer 0 of YOLOv3-608 at batch 128, "plain" the chain), then each kernel's
serving row ("<name>_serve": its launches in the serving run, its shape),
then K1's and K2's rows at a rank's shapes of the sharded serving run
("<name>_dist": a rank's launches in the tracker cell of world 4),
"max_abs_err" the
largest difference from the plain version (K2: in col_of and iters; K4,
K5: relative to the largest magnitude, see "err_kind"), "ms"/"plain_ms"
the event times, "device_ms"/"plain_device_ms" the profiler's, "bound_ms"
and "bound_by" from this run's shapes and data at 3.35 TB/s and 67 TFLOP/s
float32, and "library_ms" null (no single PyTorch call computes any of
them).  The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import hashlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

from tpu_mot_torch import cli, interop, native
from tpu_mot_torch.config import KCFConfig, TrackerConfig
from tpu_mot_torch.data import synthetic
from tpu_mot_torch.kernels import _build
from tpu_mot_torch.kernels import auction as auction_k
from tpu_mot_torch.kernels import kcf as kcf_k
from tpu_mot_torch.kernels import roi as roi_k
from tpu_mot_torch.models import detector
from tpu_mot_torch.models import epilogue as epi_k
from tpu_mot_torch.models import yolo as yolo_mod
from tpu_mot_torch.models.yolo import YoloSpec
from tpu_mot_torch.ops import assignment
from tpu_mot_torch.ops import features as feat_ops
from tpu_mot_torch.ops import kcf as kcf_ops
from tpu_mot_torch.ops import nms as nms_ops
from tpu_mot_torch.ops import patch as patch_ops
from tpu_mot_torch.parallel import mesh as mesh_mod
from tpu_mot_torch.parallel import serve, train
from tpu_mot_torch.tools import bench as bench_tool
from tpu_mot_torch.tools import (bench_class_cost, bench_configs4,
                                 bench_e2e, bench_hard_fixture, bench_ingest,
                                 bench_latency, bench_multistream, bench_otb,
                                 bench_template_size, bench_train_site,
                                 bench_variants, train_e2e_mota)
from tpu_mot_torch.tracker import api
from tpu_mot_torch.tracker import bank as bank_mod
from tpu_mot_torch.tracker import kcf_bank
from tpu_mot_torch.tracker import scan
from tpu_mot_torch.tracker import step as step_mod
from tpu_mot_torch.utils import checkpoint, metrics, viz
from tpu_mot_torch.utils.supervisor import StreamSupervisor

# MOTA / HOTA of the JAX reference (tpu_mot, jax 0.9.0 on the CPU,
# JAX_PLATFORMS=cpu) on this fixture, from bench.py's correctness block
# (bench.py:76-124) run unchanged.  The heavy modes score the same on the
# JAX reference (tpu_mot on the CPU, roi_impl="pallas").
M_REF = 0.984375
HOTA_REF = 0.937445222418187

HEIGHT, WIDTH, N_OBJ, N_FRAMES = 1080, 1920, 128, 64
ROI_TOL = 1e-5
EPS = assignment.DEFAULT_EPS
SCALES = (1.0 / 1.05, 1.0, 1.05)
KCF_TOL = {"response": 1e-4, "xf": 1e-4, "alphaf": 1e-3}
# K6 against its plain version, relative to each tensor's largest magnitude.
# xf 1e-6: the phase shift and blend repeat the chain's roundings one by one,
# so only sincosf against separate sin and cos could part them (bit-equal at
# 32,768 rows on the H100).  alphaf 1e-3, K5's limit for the same reason:
# K6's FFTs round otherwise than cuFFT's, and the exp of a near-zero energy
# difference and the divide by k^ + lambda amplify that where k^ is small
# (2.8e-4 at 32,768 rows of the bench fixture's gray windows, where K5's
# direct kernel reads 2.6e-4; the float32 chain on the CPU is 5e-5 from
# float64 on such windows).
K6_TOL = {"xf": 1e-6, "alphaf": 1e-3}
# K8 against its plain version (`search_errors`).  z^ and the response
# relative to each tensor's largest magnitude, 1e-4: KCF_TOL's xf and
# response, since K8's FFTs round otherwise than cuFFT's as K4's and K6's do
# (2.7e-6 seen at 32,768 rows).  The first maximum's index exactly, on rows
# whose two largest values in the plain version part by more than "tie" =
# 1e-5 of the larger: closer values are a tie that float32 rounding breaks
# either way.  The peak, its index, dy and dx exactly what
# ops/kcf.peak_displacement gives on K8's own response, and the PSR within
# "own" = 1e-5 of psr's there, relative to its largest: the same rules on
# the same values, the sidelobe sums in another order.  dy, dx and the PSR
# are not held to the plain version's: a flat peak's parabola divides by a
# near-zero curvature, which amplifies the response's rounding (2.9e-4 px
# seen on random windows).
K8_TOL = {"zf": 1e-4, "response": 1e-4, "tie": 1e-5, "own": 1e-5}
# Where the bank's alphaf is ill-conditioned (K6's on the random detector's
# birth windows, see K6 in the dist phase), a response is a sum of terms
# far larger than itself, and any float32 inverse FFT rounds by the terms'
# size: K8 and its plain version may then part by more than K8_TOL's
# response.  Such a call (every other measure within K8_TOL) is held
# instead against the plain version run in float64: K8's response error
# there at most K8_F64_RATIO times the float32 plain version's.  Two
# float32 FFTs of the same sums err by like amounts in random directions;
# a fault (a lost term, a wrong twiddle) lands orders of magnitude above.
K8_F64_RATIO = 2.0

# The heavy configuration (tools/bench_variants.py "fhog31 + 3-scale"; the
# heavy golden's KCFConfig) and its two modes: H (defaults otherwise) and
# HF (the fused KCF kernels with refined-site training).
HEAVY_KCF = bench_variants.HEAVY_KCF
HEAVY = {"H": {}, "HF": dict(kcf_impl="pallas", train_site="refined")}
# ids, valid and boxes of the JAX reference (tpu_mot on the CPU,
# roi_impl="pallas") tracking the bench fixture in H and HF; regenerate
# with `python tests/test_torch_heavy.py regen-bench-dump`.
HEAVY_DUMP = (Path(__file__).resolve().parent / "tests" / "golden"
              / "bench_heavy_jax_v1.npz")

# The association configurations on a class fixture (three detector
# classes, 6-column detections): A = class-aware matching (so assoc_box
# resolves to "best") with the appearance blend, AW = A with the warm-started
# auction.  ASSOC_M_REF is the JAX reference's MOTA (tpu_mot on the CPU,
# roi_impl="pallas") and ASSOC_DUMP its ids, valid, boxes and cls; both come
# from `python tests/test_torch_assoc.py regen-bench-dump`.
ASSOC_BASE = dict(class_aware=True, appearance_weight=0.3)
ASSOC = {"A": {}, "AW": dict(auction_warm_start=True)}
ASSOC_M_REF = {"A": 0.984375, "AW": 0.984375}
ASSOC_DUMP = HEAVY_DUMP.with_name("bench_assoc_jax_v1.npz")

# The single-object flow as a bank of the bench fixture's 128 first-frame
# boxes, tracked by correlation alone: KCFConfig arguments and train site.
# KCF_BANK_IOU_REF is the mean IoU with the ground truth of the JAX
# reference (tpu_mot on the CPU, where it samples full resolution), from
# `python tests/test_torch_kcf_bank.py bench-ref`.
KCF_BANK = {"gray refined": ({}, "refined"), "gray detect": ({}, "detect"),
            "heavy refined": (HEAVY_KCF, "refined")}
KCF_BANK_IOU_REF = {"gray refined": 0.76836115, "gray detect": 0.78892004,
                    "heavy refined": 0.64376354}
# px, one bank step with K1 against one with K1's plain version, and the
# share of slot-frames that may exceed it by a tied peak
BANK_TOL = 0.05
BANK_TIES = 1e-3

# The detector path, bench_e2e.py:58-86 (BASELINE.json configs[3]): 32 u8
# frames of 720p with 128 objects, yolov3-tiny (80 classes, 416 input,
# float32, weights from interop.numpy_yolo_params at seed 0), greedy NMS at
# IoU 0.45 and score 0.3 into 64 slots, 128 track slots.  E2E_DUMP is the
# JAX reference on it (tpu_mot on the CPU; the tracker with
# roi_impl="pallas"): per frame dets, valid, classes; pre-NMS boxes, scores
# and classes of the first E2E_PRE frames; the tracker's ids, valid, boxes.
# Regenerate with `python tests/test_torch_detector.py regen-e2e-dump`.
E2E_H, E2E_W, E2E_FRAMES, E2E_DETS, E2E_PRE = 720, 1280, 32, 64, 2
E2E_SEED, E2E_IOU, E2E_SCORE, E2E_STRIDE = 0, 0.45, 0.3, 3
E2E_DUMP = HEAVY_DUMP.with_name("detect_e2e_jax_v1.npz")
# The dump also holds JAX's bank after frame E2E_BANK_FRAME - 1: a free
# run of the tracker is held to the dump on the frames before it, and the
# frames from it on are stepped from JAX's bank.  (Past it a slot that has
# lost its object turns a last-bit difference into pixels; see PERF.md §6.)
E2E_BANK_FRAME = 28
# From JAX's bank K8's run is held to the dump but for the slots that follow
# an auction choice other than its plain version's (which the dump's is)
# where that choice is a tie.  `step_ties` steps K8's bank on and, from each
# frame's bank, the plain version and a witness, the FFT chain in float64:
# where the plain version's matching differs from K8's, both are scored on
# the witness's cost matrix and tie when they hold as many pairs and their
# total costs part by at most E2E_TIE_EPS for each slot they match
# otherwise.  The auction is eps-optimal (ops/assignment.DEFAULT_EPS): under
# eps-complementary slackness its answer may trail the best matching by eps
# on each row where the two differ, and its tie-break jitter adds under a
# quarter eps a pair, so within that bound either matching is its answer.
E2E_TIE_EPS = 1.25 * assignment.DEFAULT_EPS
# Bounds of the card against the dump and of int8 against float32 (see
# PERF.md §6).  int8's scores before NMS must differ from float32's by
# more than float32's own noise (E2E_INT8_SCORE_MIN; the card against the
# JAX dump: 2.7e-7) and less than E2E_INT8_SCORE_TOL.
E2E_PRE_SCORE_TOL, E2E_PRE_BOX_TOL = 1e-5, 2e-3
E2E_MATCH_FLOOR = 60
E2E_INT8_SCORE_MIN, E2E_INT8_SCORE_TOL = 1e-4, 0.02

# Multi-stream serving, BASELINE.json configs[4] ("8 concurrent 1080p
# streams ..., shared detector batch") on one card: stream s is the bench
# generator (bench.py:76-104) at seed s, SERVE_FRAMES frames each (stream 0
# is the first SERVE_FRAMES frames of the bench fixture); tracker cells with
# ground-truth detections padded to 160, detector cells with
# tools/bench_configs4.py's yolov3-tiny (80 classes at 416, 64 detections,
# IoU 0.45, score 0.3).  SERVE_DUMP is the JAX reference on it
# (tpu_mot.parallel.serve.multi_stream_sequence on the CPU,
# roi_impl="pallas"): ids, valid and boxes [S, N, T(, 4)] and each stream's
# MOTA and HOTA; regenerate with `python tests/test_torch_serve.py
# regen-serve-dump`.
SERVE_STREAMS, SERVE_FRAMES, SERVE_DETS, SERVE_STRIDE = 8, 32, 64, 4
SERVE_DUMP = HEAVY_DUMP.with_name("serve_jax_v1.npz")

# Detector training at full width: yolov3-tiny (80 classes, 416 input,
# float32, weights interop.numpy_yolo_params at seed 0), Adam at 1e-3, on
# a batch of TRAIN_BATCH scenes of the bench generator (scene s: seed s, one
# 1080p frame, 128 objects of 80 classes; gray repeated to 3 channels,
# antialiased bilinear resize to 416, build_targets on the boxes scaled to
# the input).  TRAIN_DUMP is the JAX reference on it (tpu_mot.parallel.train
# on the CPU, optax.adam(1e-3)): step 0's loss, every gradient leaf's L2
# norm, the two heads' full gradients and the BatchNorm running statistics
# after it, the losses of TRAIN_STEPS steps and every BatchNorm running mean
# and variance after them, and step 0 on the first 2 scenes alone (and the
# images, so that both packages train on the same input; and the float64
# gradient norms of the port's net in float64); regenerate with `python
# tests/test_torch_train.py regen-train-dump`.
TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 4, 3, 1e-3
TRAIN_DUMP = Path(__file__).resolve().parent / "tests" / "golden" / \
    "train_jax_v1.npz"
TRAIN_SPEC = dict(name="yolov3-tiny", num_classes=80, input_size=416)

# The hard fixture (tools/bench_hard_fixture.py: 128 objects at 1080p over
# 64 frames, a quarter of the detections dropped, 4 false positives a
# frame, 2 px jitter; 256 track slots, so K2 solves [256, 256] from global
# memory).  HARD_DUMP is the JAX reference on it (tpu_mot on the CPU,
# roi_impl="pallas") in the three tracker tiers t0-t2 of
# tools.bench_hard_fixture.TIERS: ids, valid and boxes, HOTA and MOTA;
# regenerate with `python tests/test_torch_tools.py regen-hard-dump`.
HARD_DUMP = TRAIN_DUMP.with_name("hard_fixture_jax_v1.npz")

# The sweeps phase (the twins of tools/bench_{multistream,class_cost,
# train_site,template_size}.py) on bench.py's fixture.  SWEEPS_DUMP is the
# JAX reference on it (tpu_mot on the CPU, roi_impl="pallas") in every
# configuration of those twins that no other dump holds, and in the default
# one (the class-blind side of bench_class_cost): ids, valid and boxes, the
# auction's rounds a frame, the last bank's alphaf (where the template size,
# the features and the train site show on this fixture, which drops no
# detection and so moves no decision), MOTA and HOTA per row; regenerate
# with `python tests/test_torch_sweeps.py regen-sweeps-dump`.  SWEEP_ROWS: TrackerConfig arguments of each row
# ("kcf" a dict of KCFConfig arguments).
SWEEPS_DUMP = TRAIN_DUMP.with_name("sweeps_jax_v1.npz")
SWEEP_ROWS = {"default": {},
              "gray_refined": dict(train_site="refined"),
              "fhog_refined": dict(train_site="refined", kcf=HEAVY_KCF),
              "t48": dict(kcf=dict(template_size=48)),
              "t32": dict(kcf=dict(template_size=32)),
              "class_aware": dict(class_aware=True)}
# Launches a frame of each bench_train_site row, counted on the CPU through
# the kernels' wrappers (tests/test_torch_sweeps.py): refined-site training
# extracts a second time at the corrected boxes (K1), the 3-scale search
# is K3.
TRAIN_SITE_LAUNCHES = {
    ("default-gray", "refined"): dict(roi_extract=2, auction_solve=1,
                                      kcf_search=1),
    ("default-gray", "detect"): dict(roi_extract=1, auction_solve=1,
                                     kcf_train_shift=1, kcf_search=1),
    ("fhog-3scale", "refined"): dict(roi_extract=1, roi_extract_scales=1,
                                     auction_solve=1),
    ("fhog-3scale", "detect"): dict(roi_extract_scales=1, auction_solve=1)}
SWEEP_BOX_TOL, SWEEP_SCORE_TOL = 0.05, 0.005
# Track slots of each row's last bank whose KCF dual coefficients (alphaf)
# the dump holds.
SWEEP_BANK_SLOTS = 16
# In every sweeps row, the calls of each kernel at each input shape whose
# index is here are held against the plain version on the path's own
# inputs; all fall in the row's warm-up run (at least 32 calls a shape).
SWEEP_CHECK_AT = frozenset((0, 1, 2, 3, 20, 21, 22, 23))


# K7 (the ConvBlock epilogue).  The nets whose every BatchNorm block's
# output shape it is checked at (batch 2, with the block's activation), with
# their BatchNorm blocks (K7 launches a forward on the card) and the frames
# a detect_batch call takes in their benchmark cell; YOLOv4's Mish blocks
# (K7's Mish launches a forward); the timed (shape, skip, activation) cases
# (YOLOv3-608's layer 0 at the benchmark's 128 frames, the second block of
# its first residual unit with the skip, the same two of YOLOv4-608 with
# Mish, and YOLOv4's largest leaky block, a 3x3 conv of 256 at stride 8);
# the shape past 2^31 elements (182 frames of layer 0, 8.6 GB).
EPILOGUE_NETS = ((YoloSpec("yolov3", input_size=608), 72, 128),
                 (YoloSpec("yolov3-tiny", input_size=416), 11, 256),
                 (YoloSpec("yolov4", input_size=608), 107, 128))
EPILOGUE_MISH = {"yolov4": 72}
EPILOGUE_TIMED = (((128, 32, 608, 608), False, "leaky"),
                  ((128, 64, 304, 304), True, "leaky"),
                  ((128, 32, 608, 608), False, "mish"),
                  ((128, 64, 304, 304), True, "mish"),
                  ((128, 256, 76, 76), False, "leaky"))
EPILOGUE_BIG = (182, 32, 608, 608)

# Published H100 SXM peaks (the least-time bound of each kernel).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

KERNELS = ("roi_extract", "roi_extract_scales", "auction_solve",
           "kcf_detect", "kcf_train", "kcf_train_shift", "kcf_search",
           "epilogue")


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def reset_counts() -> None:
    set_counts(dict.fromkeys(KERNELS, 0))


def set_counts(counts: dict) -> None:
    (roi_k.launches, roi_k.launches_scales, auction_k.launches,
     kcf_k.launches_detect, kcf_k.launches_train,
     kcf_k.launches_train_shift, kcf_k.launches_search,
     epi_k.launches) = (counts[k] for k in KERNELS)


def read_counts() -> dict:
    return dict(zip(KERNELS, (roi_k.launches, roi_k.launches_scales,
                              auction_k.launches, kcf_k.launches_detect,
                              kcf_k.launches_train,
                              kcf_k.launches_train_shift,
                              kcf_k.launches_search, epi_k.launches)))


def bn_blocks(spec: YoloSpec) -> int:
    """The net's BatchNorm blocks: K7's launches a forward on the card."""
    with torch.device("meta"):
        model = yolo_mod.build_model(spec)
    return sum(isinstance(b, yolo_mod.ConvBlock) and b.bn is not None
               for b in model.modules())


def bench_fixture():
    """bench.py:76-104 (the bench twin's fixture): the same objects,
    frames, detections and config."""
    fx = bench_tool.fixture()
    return (fx.frames, fx.dets, fx.valid, fx.gt_boxes, fx.visible,
            fx.dets_list, fx.config())


def train_scenes(n: int = TRAIN_BATCH, input_size: int = 416,
                 first: int = 0):
    """The training batch's scenes: per scene s in [first, first + n) the
    first frame of the bench generator at seed s with 80 object classes.
    Returns (frames [n, 1080, 1920] float32 in [0, 1], boxes [n, 128, 4]
    cxcywh scaled to the input_size x input_size input, classes [n, 128],
    visible [n, 128]); one thread a scene, as serve_fixture."""
    def scene(seed):
        rng = np.random.default_rng(seed)
        objs = synthetic.make_objects(N_OBJ, HEIGHT, WIDTH, rng, min_size=24,
                                      max_size=64, max_speed=3.0,
                                      n_classes=80)
        f, b, v = synthetic.render_sequence(objs, 1, HEIGHT, WIDTH,
                                            seed=seed, noise=0.01)
        return (f[0], b[0] * np.float32([input_size / WIDTH,
                                         input_size / HEIGHT] * 2),
                [o.cls for o in objs], v[0])

    with concurrent.futures.ThreadPoolExecutor(
            min(n, os.cpu_count() or 1)) as pool:
        frames, boxes, classes, vis = zip(*pool.map(
            scene, range(first, first + n)))
    return (np.stack(frames), np.stack(boxes).astype(np.float32),
            np.asarray(classes, np.int64), np.stack(vis))


def train_images(frames, input_size: int = 416, device=None) -> torch.Tensor:
    """Gray frames [n, H, W] float -> the net's input [n, s, s, 3] NHWC
    float32: antialiased bilinear resize (jax.image.resize "bilinear" in
    the JAX package), the channel repeated."""
    x = torch.as_tensor(frames, device=device)[:, None]
    x = torch.nn.functional.interpolate(
        x, size=(input_size, input_size), mode="bilinear",
        align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1).repeat(1, 1, 1, 3).contiguous()


def serve_fixture(n_streams: int = SERVE_STREAMS,
                  n_frames: int = SERVE_FRAMES, first: int = 0):
    """S streams of the bench generator, stream s at seed s (streams first
    to first + S - 1): frames u8 [S, N, 1080, 1920], detections from the
    ground truth [S, N, 160, 5] and valid, ground-truth boxes [S, N, K, 4]
    and visibility [S, N, K], and the tracker config."""
    cfg = TrackerConfig(max_tracks=128, max_detections=160,
                        frame_height=HEIGHT, frame_width=WIDTH)

    def stream(s):
        objs = synthetic.make_objects(N_OBJ, HEIGHT, WIDTH,
                                      np.random.default_rng(s), min_size=24,
                                      max_size=64, max_speed=3.0)
        fr, boxes, vi = synthetic.render_sequence(
            objs, n_frames, HEIGHT, WIDTH, seed=s, noise=0.01)
        dets_list = synthetic.detections_from_gt(boxes, vi, seed=s,
                                                 frame_hw=(HEIGHT, WIDTH))
        dd = np.zeros((n_frames, cfg.max_detections, 5), np.float32)
        vv = np.zeros((n_frames, cfg.max_detections), bool)
        for f in range(n_frames):
            dd[f], vv[f] = api.pad_detections(dets_list[f],
                                              cfg.max_detections)
        return (fr * 255).astype(np.uint8), dd, vv, boxes, vi

    # one thread a stream (numpy releases the GIL in the renderer's array
    # work); every stream draws from its own seeds
    with concurrent.futures.ThreadPoolExecutor(
            min(n_streams, os.cpu_count() or 1)) as pool:
        parts = list(pool.map(stream, range(first, first + n_streams)))
    return (*(np.stack(x) for x in zip(*parts)), cfg)


def e2e_fixture():
    """bench_e2e.py:58-86 (the bench_e2e twin's fixture): (frames u8 [32,
    720, 1280], detections from the ground truth [32, 64, 5] and valid (the
    tracker-only stage's input), the tracker config, the detector spec)."""
    fx = bench_e2e.fixture()
    return (fx.frames, fx.dets, fx.valid, fx.config(),
            YoloSpec("yolov3-tiny", num_classes=80))


def assoc_fixture():
    """The bench frame size and capacities with three object classes:
    (frames u8, dets [N, D, 6], valid, gt boxes, visibility, classes [K],
    the base config of A and AW)."""
    objs = synthetic.make_objects(N_OBJ, HEIGHT, WIDTH,
                                  np.random.default_rng(0), n_classes=3)
    frames, boxes, vis = synthetic.render_sequence(
        objs, N_FRAMES, HEIGHT, WIDTH, seed=0, noise=0.01)
    classes = np.array([o.cls for o in objs])
    dets_list = synthetic.detections_from_gt(
        boxes, vis, seed=0, frame_hw=(HEIGHT, WIDTH), classes=classes)
    cfg = TrackerConfig(max_tracks=128, max_detections=160,
                        frame_height=HEIGHT, frame_width=WIDTH, **ASSOC_BASE)
    d = np.zeros((N_FRAMES, cfg.max_detections, 6), np.float32)
    v = np.zeros((N_FRAMES, cfg.max_detections), bool)
    for f in range(N_FRAMES):
        d[f], v[f] = api.pad_detections(dets_list[f], cfg.max_detections,
                                        width=6)
    return (frames * 255).astype(np.uint8), d, v, boxes, vis, classes, cfg


def heavy_config(cfg: TrackerConfig, name: str) -> TrackerConfig:
    """The bench config in heavy mode `name` ("H" or "HF")."""
    return cfg.replace(kcf=KCFConfig(**HEAVY_KCF), **HEAVY[name])


def edge_boxes() -> np.ndarray:
    """Corners, degenerate sizes, off-frame, level boundaries (128 px
    window = level 0/1 edge) and windows over 1024 px (block truncation)."""
    return np.array([
        [0.0, 0.0, 20.0, 20.0], [WIDTH - 1.0, HEIGHT - 1.0, 30.0, 18.0],
        [0.0, HEIGHT - 1.0, 40.0, 40.0], [WIDTH - 1.0, 0.0, 25.0, 33.0],
        [500.0, 400.0, 0.0, 0.0], [700.0, 300.0, -4.0, 12.0],
        [5000.0, -300.0, 20.0, 20.0], [300.0, 200.0, 51.2, 10.0],
        [310.0, 210.0, 51.21, 10.0], [900.0, 500.0, 102.4, 60.0],
        [950.0, 550.0, 102.5, 60.0], [1200.0, 700.0, 30.0, 204.8],
        [1000.0, 580.0, 600.0, 600.0], [1050.0, 540.0, 1000.0, 100.0],
        [960.0, 540.0, 900.0, 500.0], [1500.0, 900.0, 420.0, 300.0],
    ], np.float32)


# A window of 2.5 x 50 = 125 px at unit scale and 131 px at 1.05: its
# scales straddle the level 0/1 boundary (K3 samples level 1 for all).
STRADDLE = np.array([[300.0, 240.0, 50.0, 50.0]], np.float32)


def event_ms(fn, reps: int) -> list[float]:
    """ms of each of `reps` calls of fn, from a CUDA event pair around each
    call.  The stream idles while the host runs the wrapper's Python, so a
    call shorter than its launch overhead reads as host-bound time."""
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    fn()
    torch.cuda.synchronize()
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in pairs]


def in_turns(plain, kernel, reps: int) -> tuple[float, float]:
    """plain, kernel, kernel, plain; the median per-call ms of each."""
    p = event_ms(plain, reps)
    k = event_ms(kernel, reps)
    k += event_ms(kernel, reps)
    p += event_ms(plain, reps)
    return statistics.median(k), statistics.median(p)


def device_kernels(prof) -> list[tuple[str, float, int]]:
    """(name, self device us, count) of each CUDA kernel a profile saw,
    busiest first."""
    from torch.autograd import DeviceType

    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])


def device_ms(fn, reps: int) -> float:
    """Device ms per call of fn: the kernel time of `reps` calls under the
    profiler, summed over every kernel fn launches, divided by reps."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # The profiler loses device records, for passes on end (seen on the
    # H100: 50 calls, 49 or 48 records pass after pass, once 17 then 4;
    # a warm-up step under a profiler schedule made it worse: a stray
    # record a pass, 30-300x times).  A pass counts whole when every kernel
    # kind was recorded a whole number of times per call.  Else, after
    # DEVICE_MS_PASSES passes, a kind's time per call is its mean time over
    # every record of every pass times its launches per call (the most
    # records one pass kept, over reps, rounded up); with no device record
    # at all, CUDA event pairs give the time, and the log says which.
    seen: dict[str, list] = {}      # kind: [us, records, most in a pass]
    for attempt in range(DEVICE_MS_PASSES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = device_kernels(prof)
        if rows and all(count % reps == 0 for _, _, count in rows):
            return sum(us for _, us, _ in rows) / 1e3 / reps
        for name, us, count in rows:
            kind = seen.setdefault(name, [0.0, 0, 0])
            kind[0] += us
            kind[1] += count
            kind[2] = max(kind[2], count)
        log("times", f"profiler pass {attempt + 1} kept "
                     f"{sum(count for _, _, count in rows)} device records "
                     f"of {reps} calls, not a whole number a call")
    if not seen:
        ms = statistics.median(event_ms(fn, reps))
        log("times", f"the profiler kept no device record in "
                     f"{DEVICE_MS_PASSES} passes; CUDA event pairs give "
                     f"{ms:.4f} ms a call (host launch time included)")
        return ms
    log("times", f"mean kernel times over {DEVICE_MS_PASSES} partial "
                 f"passes are used ({len(seen)} kernel kinds)")
    return sum(us / count * math.ceil(most / reps)
               for us, count, most in seen.values()) / 1e3


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least ms the card could take: the larger of the bytes over the
    memory rate and the operations over the float32 rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOP_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def touched_pixels(lvl: torch.Tensor, ys: torch.Tensor,
                   xs: torch.Tensor, frame: torch.Tensor | None = None
                   ) -> int:
    """Distinct pyramid pixels that windows with level lvl [N] and level
    coordinates ys, xs [N, S] read with a nonzero bilinear weight (of frame
    `frame` [N] of a stacked pyramid)."""
    def taps(c):
        f = torch.floor(c)
        a = f.long()
        return torch.cat([a, torch.where(c > f, a + 1, a)], dim=1)

    plane = lvl.long() if frame is None else frame.long() * 4 + lvl.long()
    code = ((plane[:, None, None] * 4096 + taps(ys)[:, :, None]) * 4096
            + taps(xs)[:, None, :])
    return int(torch.unique(code).numel())


def fft_flops(s: int) -> float:
    """Operations of one real 2-D FFT of s x s points (2.5 N log2 N)."""
    n = s * s
    return 2.5 * n * math.log2(n)


def ragged_boxes(dev) -> torch.Tensor:
    """A T that no tile or warp size divides (37): boxes of 8-400 px
    anywhere on the frame (every level), the straddling box last."""
    rng = np.random.default_rng(3)
    return torch.as_tensor(np.concatenate([np.stack(
        [rng.uniform(0, WIDTH, 36), rng.uniform(0, HEIGHT, 36),
         rng.uniform(8, 400, 36), rng.uniform(8, 400, 36)],
        axis=1).astype(np.float32), STRADDLE]), device=dev)


def phase_roi(dev, frame_u8, boxes0):
    levels_u8 = roi_k.build_pyramid(frame_u8)
    gray = frame_u8.to(torch.float32) / 255.0
    levels_f32 = roi_k.build_pyramid(gray)
    hw = (HEIGHT, WIDTH)
    ragged = ragged_boxes(dev)
    # The single-object bank's 3-scale call: the boxes three times,
    # scale-major, with a per-track scale.
    scales3 = torch.tensor(SCALES, dtype=torch.float32,
                           device=dev).repeat_interleave(boxes0.shape[0])
    cases = (("bench", boxes0, 64, None),
             ("edges", torch.as_tensor(edge_boxes(), device=dev), 64, None),
             ("ragged", ragged, 64, None), ("ragged", ragged, 48, None),
             ("ragged", ragged, 30, None), ("bench", boxes0, 48, None),
             ("bench", boxes0, 32, None),
             ("bench x 3 scales", boxes0.repeat(3, 1), 64, scales3))
    max_err = 0.0
    for pyr_name, levels in (("u8", levels_u8), ("f32", levels_f32)):
        for box_name, b, s, scales in cases:
            info = roi_k.launch_info(pyr_name == "u8", s)
            got = roi_k.extract_patches(None, b, 2.5, s, levels=levels,
                                        frame_hw=hw, scales=scales)
            want = roi_k.extract_patches_ref(None, b, 2.5, s, levels=levels,
                                             frame_hw=hw, scales=scales)
            lvl, r0, c0, ys, xs = roi_k.sample_coords(b, 2.5, s, hw, scales)
            mirror = roi_k.four_tap_mirror(levels, hw, lvl, r0, c0, ys[None],
                                           xs[None])[0]
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            same = torch.equal(got, mirror)
            lv = sorted(set(lvl.tolist()))
            log("roi", f"{pyr_name} pyramid, {box_name} boxes "
                       f"T={b.shape[0]} S={s} levels {lv} by "
                       f"{info['path']}: max |kernel - plain| {err:.3g}; "
                       f"bit-equal to the 4-tap mirror: {same}")
            if not (err <= ROI_TOL and same
                    and got.shape == (b.shape[0], s, s)
                    and torch.isfinite(got).all().item()
                    and info["path"] == roi_k.SCALES_PATHS[s == 64]
                    and info["threads"] == 256):
                raise AssertionError(
                    f"ROI kernel {pyr_name}/{box_name} S={s}: max |kernel - "
                    f"plain| {err} (limit {ROI_TOL}), equal to the mirror "
                    f"{same}, launch {info}")
            max_err = max(max_err, err)
    return levels_u8, levels_f32, max_err


def phase_roi3(dev, levels_u8, levels_f32, boxes0):
    hw = (HEIGHT, WIDTH)
    extra = torch.as_tensor(np.concatenate([edge_boxes(), STRADDLE]),
                            device=dev)
    ragged = ragged_boxes(dev)
    max_err = 0.0
    for pyr_name, levels in (("u8", levels_u8), ("f32", levels_f32)):
        for box_name, b in (("bench", boxes0), ("edges+straddle", extra),
                            ("ragged", ragged)):
            got = roi_k.extract_patches_scales(None, b, 2.5, 64, SCALES,
                                               levels=levels, frame_hw=hw)
            want = roi_k.extract_patches_scales_ref(
                None, b, 2.5, 64, SCALES, levels=levels, frame_hw=hw)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            lv = sorted(set(roi_k.sample_coords_scales(
                b, 2.5, 64, SCALES, hw)[0].tolist()))
            if not (got.shape == (3, b.shape[0], 64, 64) and err <= ROI_TOL
                    and torch.isfinite(got).all().item()):
                raise AssertionError(
                    f"3-scale ROI kernel {pyr_name}/{box_name}: shape "
                    f"{tuple(got.shape)}, max |kernel - plain| {err}")
            max_err = max(max_err, err)
            log("roi3", f"{pyr_name} pyramid, {box_name} boxes "
                        f"T={b.shape[0]} x 3 scales, levels {lv}: max "
                        f"|kernel - plain| {err:.3g}")
    return max_err


def phase_auction(dev, bench_benefits, hard_benefits):
    """K2 against its plain version on every case; returns the largest
    difference of the cases that stage the matrix into shared memory and
    of those that read it from global memory (n > shared_max_n())."""
    rng = np.random.default_rng(1)
    cases = [(f"bench frame {i} n={b.shape[0]}", b, 2000)
             for i, b in enumerate(bench_benefits)]
    for n in (8, 40, 160):
        cost = torch.as_tensor(rng.uniform(0, 1, (n, n)).astype(np.float32),
                               device=dev)
        feas = torch.as_tensor(rng.random((n, n)) < 0.8, device=dev)
        cases.append((f"random n={n}", assignment.build_benefits(
            cost, feas, EPS), 2000))
    ones = torch.ones((160, 128), device=dev)
    cases.append(("all infeasible 160x128", assignment.build_benefits(
        ones, torch.zeros_like(ones, dtype=torch.bool), EPS), 2000))
    feas = torch.as_tensor(rng.random((128, 160)) < 0.1, device=dev)
    feas[::3] = False
    cases.append(("dead rows 128x160", assignment.build_benefits(
        torch.as_tensor(rng.uniform(0, 1, (128, 160)).astype(np.float32),
                        device=dev), feas, EPS), 2000))
    cases.append(("capped max_iters=3, random n=160",
                  cases[len(bench_benefits) + 2][1], 3))
    cases += [(f"hard fixture frame {i} n={b.shape[0]}", b, 2000)
              for i, b in enumerate(hard_benefits)]

    def random_b(n, grid=None):
        cost = rng.uniform(0, 1, (n, n))
        if grid:    # costs and benefits on a grid: many equal bids
            cost = np.round(cost * grid) / grid
        b = assignment.build_benefits(
            torch.as_tensor(cost.astype(np.float32), device=dev),
            torch.as_tensor(rng.random((n, n)) < 0.8, device=dev), EPS)
        return torch.round(b * grid) / grid if grid else b

    def contested_b(n):
        """every row prefers the same columns: a price war"""
        cost = (rng.uniform(0, 1, n)[None, :]
                + 0.05 * rng.uniform(0, 1, (n, n)))
        return assignment.build_benefits(
            torch.as_tensor(cost.astype(np.float32), device=dev),
            torch.as_tensor(rng.random((n, n)) < 0.9, device=dev), EPS)

    n_shared = auction_k.shared_max_n()
    for n in (7, 33, 159, n_shared) + AUCTION_GLOBAL_N:
        cases.append((f"random n={n}", random_b(n), 2000))
    for n in (40, 159, 160, 256, 257):
        cases.append((f"ties (grid 0.25) n={n}", random_b(n, 4), 2000))
    for n in (256, 512):
        cases.append((f"contested n={n}", contested_b(n), 2000))
    cases.append(("capped max_iters=3, random n=256", random_b(256), 3))
    batch = torch.stack([random_b(256) for _ in range(8)])
    max_err = {"shared": 0, "global": 0}
    most_rounds = 0
    for name, b, max_iters in cases + [("batch [8, 256, 256]", batch,
                                        2000)]:
        n = b.shape[-1]
        col, it = auction_k.auction_solve(b, EPS, max_iters)
        want_col, want_it = auction_k.auction_solve_ref(b, EPS, max_iters)
        torch.cuda.synchronize()
        err = max(int((col - want_col).abs().max()),
                  int((it - want_it).abs().max()))
        if not (torch.equal(col, want_col) and torch.equal(it, want_it)):
            raise AssertionError(f"auction kernel {name}: col_of/iters differ "
                                 f"from the plain version ({it.tolist()} vs "
                                 f"{want_it.tolist()} rounds)")
        if b.ndim == 3:       # each problem of the batch as a single solve
            for p in range(b.shape[0]):
                c1, i1 = auction_k.auction_solve(b[p].contiguous(), EPS,
                                                 max_iters)
                if not (torch.equal(c1, col[p]) and int(i1) == int(it[p])):
                    raise AssertionError(f"auction kernel {name}: problem "
                                         f"{p} differs from its single solve")
        path = "global" if n > n_shared else "shared"
        max_err[path] = max(max_err[path], err)
        most_rounds = max(most_rounds, int(it.max()))
        log("auction", f"{name} ({auction_k.launch_info(n)['path']}): "
                       f"col_of and iters ({it.tolist()}) exactly equal, "
                       f"{int((col < 0).sum())} unassigned rows")
    if most_rounds < 50:
        raise AssertionError("auction: no case needed 50 rounds (most: "
                             f"{most_rounds})")
    n_max = auction_k.max_n()
    try:
        auction_k.auction_solve(torch.zeros((n_max + 1, n_max + 1),
                                            device=dev), EPS, 10)
    except ValueError as e:
        log("auction", f"n={n_max + 1} refused: {e}")
    else:
        raise AssertionError(f"auction: n={n_max + 1} was not refused")
    log("auction", f"shared memory up to n={n_shared}, global memory "
                   f"{n_shared + 1}..{n_max}; largest difference {max_err}")
    return max_err


# n of K2 cases that read the matrix from global memory (n > 237)
AUCTION_GLOBAL_N = (238, 240, 256, 257, 512, 1024)
# calls a K2 time is taken over: the profiler can drop ~2 device records
# of a pass for passes on end (10 calls, 8 kept, 30 passes in a row on the
# H100), and device_ms then takes mean times over partial passes
K2_REPS = 50
# profiler passes device_ms takes before it settles for partial ones
DEVICE_MS_PASSES = 3


def record_benefits(frames, d, v, cfg, n_frames: int):
    """Benefit matrices the bench run hands the auction on its first
    frames (captured by wrapping the solve; not a counted run)."""
    seen = []
    solve = auction_k.auction_solve

    def capture(b, eps, max_iters):
        # the single-stream step hands the kernel a batch of one problem
        seen.append(b.reshape(b.shape[-2:]).clone())
        return solve(b, eps, max_iters)

    auction_k.auction_solve = capture
    try:
        scan.run_sequence(bank_mod.empty_bank(cfg, device=frames.device),
                          frames[:n_frames], d[:n_frames], v[:n_frames], cfg)
    finally:
        auction_k.auction_solve = solve
    return seen


def record_kcf_inputs(frames, d, v, cfg, n_frames: int):
    """The inputs an HF run hands the fused detect and train on its first
    frames (captured by wrapping the wrappers; not a counted run): the last
    frame's (model, feat) for detect and (model, feat, yf, lr) for train."""
    seen = {}
    detect, train = kcf_k.detect_fused, kcf_k.train_fused

    def cap_detect(model, feat, sigma):
        seen["detect"] = (kcf_ops.KCFModel(*[x.clone() for x in model]),
                          feat.clone())
        return detect(model, feat, sigma)

    def cap_train(model, feat, yf, sigma, lambda_, lr):
        seen["train"] = (kcf_ops.KCFModel(*[x.clone() for x in model]),
                         feat.clone(), yf.clone(), lr.clone())
        return train(model, feat, yf, sigma, lambda_, lr)

    kcf_k.detect_fused, kcf_k.train_fused = cap_detect, cap_train
    try:
        scan.run_sequence(bank_mod.empty_bank(cfg, device=frames.device),
                          frames[:n_frames], d[:n_frames], v[:n_frames], cfg)
    finally:
        kcf_k.detect_fused, kcf_k.train_fused = detect, train
    return seen


def rel_err(got, want) -> float:
    """Largest |got - want| relative to the largest |want| (0 where both
    are all zero: a bank's first frame has no model yet)."""
    return ((got - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def gray_kcf_inputs(frames, boxes0, cfg):
    """Gray-shape (S=64, C=1, T=128) inputs: a bank trained on frame 0's
    bench windows, features of frame 1 at the same boxes."""
    dev = frames.device
    s = cfg.kcf.feature_size
    yf = kcf_ops.make_yf(s, cfg.kcf.padding, cfg.kcf.output_sigma_factor,
                         device=dev)
    feats = [feat_ops.extract_features(roi_k.extract_patches_ref(
        frames[f], boxes0, cfg.kcf.padding, cfg.kcf.template_size),
        cfg.kcf).contiguous() for f in (0, 1)]
    model = kcf_ops.KCFModel(*[x.contiguous() for x in kcf_ops.train(
        feats[0], yf, cfg.kcf.kernel_sigma, cfg.kcf.lambda_)])
    lr = torch.tensor([1.0, 0.075, 0.0, 0.5], device=dev).repeat(
        boxes0.shape[0] // 4)
    return model, feats[1], yf, lr


# K6's rows in the kcf and times phases: the serve cell's 256 streams x 128
# slots.
SHIFT_ROWS = 256 * 128


def shift_inputs(gray_inputs, rows: int = SHIFT_ROWS):
    """K6's arguments at `rows` rows of gray S = 64: the gray bank and
    frame-1 spectra tiled, shifts from a seeded generator up to just inside
    +-S/4 (every 7th row 0), the gray inputs' rates repeated."""
    model, feat, yf, lr = gray_inputs
    reps = rows // feat.shape[0]
    dev = feat.device
    tiled = kcf_ops.KCFModel(*[x.repeat((reps,) + (1,) * (x.ndim - 1))
                               for x in model])
    zf = torch.fft.rfft2(feat.repeat(reps, 1, 1, 1)).contiguous()
    rng = np.random.default_rng(6)
    shifts = rng.uniform(-15.999, 15.999, (2, rows)).astype(np.float32)
    shifts[:, ::7] = 0.0
    dy, dx = (torch.as_tensor(x, device=dev) for x in shifts)
    return (tiled, zf, dy, dx, yf, 0.2, 1e-4, lr.repeat(reps), 64)


def search_inputs(frames, boxes0, cfg, rows: int = SHIFT_ROWS) -> dict:
    """K8's cases: the gray bank (trained on frame 0's windows) searched on
    frame 1's windows at the same boxes, both tiled to `rows` rows ("K=1");
    the same after K6's plain version trained the tiled bank on shifted
    spectra as stage 8 does ("K=1, K6's bank": its x^ is not Hermitian in
    the DC and Nyquist columns); and on frame 1's windows at the boxes
    scaled by the 3-scale search's scales ("K=3": 3 x T items,
    scale-major, against the T-row bank)."""
    gray = gray_kcf_inputs(frames, boxes0, cfg)
    model, feat = gray[:2]
    reps = rows // feat.shape[0]
    tiled = kcf_ops.KCFModel(*[x.repeat((reps,) + (1,) * (x.ndim - 1))
                               for x in model])
    trained = kcf_ops.KCFModel(*[x.contiguous() for x in
                                 kcf_k.train_shift_fused_ref(
                                     *shift_inputs(gray, rows))])
    scaled = [feat_ops.extract_features(roi_k.extract_patches_ref(
        frames[1], boxes0 * torch.tensor([1.0, 1.0, sc, sc],
                                         device=boxes0.device),
        cfg.kcf.padding, cfg.kcf.template_size), cfg.kcf) for sc in SCALES]
    tiled_feat = feat.repeat(reps, 1, 1, 1).contiguous()
    return {"K=1": (tiled, tiled_feat),
            "K=1, K6's bank": (trained, tiled_feat),
            "K=3": (model, torch.cat(scaled).contiguous())}


def search_errors(got, want) -> dict:
    """K8's result against its plain version's (kernels/kcf.SearchRows), by
    K8_TOL's measures: "zf" and "response" relative to the largest
    magnitude; "tie_flips" the rows whose first maximum differs where the
    plain version's two largest values part by more than K8_TOL["tie"];
    "own" the PSR's error relative to its largest against ops/kcf.psr on
    K8's own response, inf unless K8's peak, index, dy and dx equal
    peak_displacement's there bit for bit."""
    e = {"zf": rel_err(got.zf, want.zf),
         "response": rel_err(got.response, want.response)}
    top = want.response.reshape(want.response.shape[0], -1).topk(
        2, dim=1).values
    apart = (top[:, 0] - top[:, 1]) > K8_TOL["tie"] * top[:, 0].abs()
    e["tie_flips"] = int(((got.idx != want.idx) & apart).sum())
    dy, dx, peak, idx = kcf_ops.peak_displacement(got.response)
    exact = all(torch.equal(a, b) for a, b in (
        (got.dy, dy), (got.dx, dx), (got.peak, peak), (got.idx, idx)))
    e["own"] = (rel_err(got.psr, kcf_ops.psr(got.response, peak, idx))
                if exact else math.inf)
    return e


def search_ok(e: dict) -> bool:
    return (e["zf"] <= K8_TOL["zf"] and e["response"] <= K8_TOL["response"]
            and e["tie_flips"] == 0 and e["own"] <= K8_TOL["own"])


def search_float64_errors(model, feat, sigma, got, want) -> tuple:
    """(K8's, its plain version's) response error against the plain version
    run in float64 on the same inputs, each relative to the float64
    response's largest magnitude."""
    exact = kcf_k.search_fused_ref(
        kcf_ops.KCFModel(*[x.to(torch.complex128) for x in model]),
        feat.double(), sigma).response
    return (rel_err(got.response.double(), exact),
            rel_err(want.response.double(), exact))


def phase_kcf(hf_inputs, gray_inputs, search_cases, cfg_hf, cfg):
    errs = {"response": 0.0, "xf": 0.0, "alphaf": 0.0}
    model, feat = hf_inputs["detect"]
    cases = [("HF", cfg_hf, model, feat, *hf_inputs["train"]),
             ("gray", cfg, gray_inputs[0], gray_inputs[1], gray_inputs[0],
              gray_inputs[1], *gray_inputs[2:])]
    for name, c, d_model, d_feat, t_model, t_feat, yf, lr in cases:
        sigma, lam = c.kcf.kernel_sigma, c.kcf.lambda_
        paths = (kcf_k.detect_launch_info(*d_feat.shape[1:3])["path"],
                 kcf_k.train_launch_info(*t_feat.shape[1:3])["path"])
        if paths != (kcf_k.PATHS[name == "HF"],) * 2:
            raise AssertionError(f"fused KCF {name}: code paths {paths}")
        got = kcf_k.detect_fused(d_model, d_feat, sigma)
        want = kcf_k.detect_fused_ref(d_model, d_feat, sigma)
        new = kcf_k.train_fused(t_model, t_feat, yf, sigma, lam, lr)
        new_ref = kcf_k.train_fused_ref(t_model, t_feat, yf, sigma, lam, lr)
        torch.cuda.synchronize()
        e = {"response": rel_err(got, want), "xf": rel_err(new.xf,
                                                           new_ref.xf),
             "alphaf": rel_err(new.alphaf, new_ref.alphaf)}
        ok = all(torch.isfinite(x).all().item()
                 for x in (got, new.xf, new.alphaf))
        log("kcf", f"{name}: detect feat {tuple(d_feat.shape)} vs model "
                   f"{tuple(d_model.xf.shape)} by {paths[0]}, train feat "
                   f"{tuple(t_feat.shape)} by {paths[1]}; largest error "
                   "relative to the "
                   f"largest magnitude: response {e['response']:.3g}, xf "
                   f"{e['xf']:.3g}, alphaf {e['alphaf']:.3g}")
        for k, tol in KCF_TOL.items():
            if not (ok and e[k] <= tol):
                raise AssertionError(f"fused KCF {name}: {k} relative error "
                                     f"{e[k]} > {tol} (finite: {ok})")
            errs[k] = max(errs[k], e[k])

    # K4 and K5 alone: a shape with no specialised path, and run-to-run
    # equality.
    dev = feat.device
    rng = np.random.default_rng(2)
    c, s, t = 3, 12, 128
    feats = [torch.as_tensor(
        rng.standard_normal((n, c, s, s)).astype(np.float32) * 0.3,
        device=dev) for n in (t, 2 * t)]
    yf = kcf_ops.make_yf(s, cfg.kcf.padding, cfg.kcf.output_sigma_factor,
                         device=dev)
    small = kcf_ops.KCFModel(*[x.contiguous() for x in kcf_ops.train(
        feats[0], yf, cfg.kcf.kernel_sigma, cfg.kcf.lambda_)])
    for name, m, f in (("generic", small, feats[1]), ("HF", model, feat)):
        path = kcf_k.detect_launch_info(f.shape[1], f.shape[2])["path"]
        got = kcf_k.detect_fused(m, f, cfg.kcf.kernel_sigma)
        again = kcf_k.detect_fused(m, f, cfg.kcf.kernel_sigma)
        want = kcf_k.detect_fused_ref(m, f, cfg.kcf.kernel_sigma)
        torch.cuda.synchronize()
        e = rel_err(got, want)
        same = torch.equal(got, again)
        log("kcf", f"{name}: detect feat {tuple(f.shape)} by {path}: "
                   f"response error {e:.3g}; two runs bit-equal: {same}")
        if not (e <= KCF_TOL["response"] and same
                and torch.isfinite(got).all().item()):
            raise AssertionError(f"fused KCF detect {name}: error {e}, "
                                 f"bit-equal {same}")
        errs["response"] = max(errs["response"], e)
    t_model, t_feat, t_yf, t_lr = hf_inputs["train"]
    lr = torch.tensor([1.0, 0.075, 0.0, 0.5], device=dev).repeat(t // 4)
    for name, m, f, y, rate, fast in (
            ("generic", small, feats[1][:t], yf, lr, False),
            ("HF", t_model, t_feat, t_yf, t_lr, True)):
        path = kcf_k.train_launch_info(f.shape[1], f.shape[2])["path"]
        args = (m, f, y, cfg.kcf.kernel_sigma, cfg.kcf.lambda_, rate)
        got = kcf_k.train_fused(*args)
        again = kcf_k.train_fused(*args)
        want = kcf_k.train_fused_ref(*args)
        torch.cuda.synchronize()
        e = {k: rel_err(getattr(got, k), getattr(want, k))
             for k in ("xf", "alphaf")}
        same = (torch.equal(got.xf, again.xf)
                and torch.equal(got.alphaf, again.alphaf))
        log("kcf", f"{name}: train feat {tuple(f.shape)} by {path}: xf error "
                   f"{e['xf']:.3g}, alphaf error {e['alphaf']:.3g}; two runs "
                   f"bit-equal: {same}")
        if not (path == kcf_k.PATHS[fast] and same
                and all(e[k] <= KCF_TOL[k] for k in e)
                and torch.isfinite(got.xf).all().item()
                and torch.isfinite(got.alphaf).all().item()):
            raise AssertionError(f"fused KCF train {name}: path {path}, "
                                 f"errors {e}, bit-equal {same}")
        for k in e:
            errs[k] = max(errs[k], e[k])

    # K6 at the serve cell's rows: against the plain version, twice, and
    # four rows alone against the same rows of the batch.
    args = shift_inputs(gray_inputs)
    model, zf, dy, dx, yf, sigma, lam, lr, width = args
    before = kcf_k.launches_train_shift
    got = kcf_k.train_shift_fused(*args)
    again = kcf_k.train_shift_fused(*args)
    calls = kcf_k.launches_train_shift - before
    want = kcf_k.train_shift_fused_ref(*args)
    part = slice(5, 9)
    alone = kcf_k.train_shift_fused(
        kcf_ops.KCFModel(*[x[part].contiguous() for x in model]),
        zf[part].contiguous(), dy[part].contiguous(), dx[part].contiguous(),
        yf, sigma, lam, lr[part].contiguous(), width)
    torch.cuda.synchronize()
    e = {k: rel_err(getattr(got, k), getattr(want, k))
         for k in ("xf", "alphaf")}
    same = (torch.equal(got.xf, again.xf)
            and torch.equal(got.alphaf, again.alphaf))
    by_row = (torch.equal(alone.xf, got.xf[part])
              and torch.equal(alone.alphaf, got.alphaf[part]))
    kept = (torch.equal(got.xf[lr == 0], model.xf[lr == 0])
            and torch.equal(got.alphaf[lr == 0], model.alphaf[lr == 0]))
    finite = all(torch.isfinite(x).all().item() for x in got)
    log("kcf", f"K6 train_shift zf {tuple(zf.shape)}, shifts up to "
               f"{float(torch.maximum(dy.abs(), dx.abs()).max()):.3f} px: "
               f"xf error {e['xf']:.3g}, alphaf error {e['alphaf']:.3g} "
               f"(limits {K6_TOL}); xf bit-equal to the plain version: "
               f"{torch.equal(got.xf, want.xf)}; two runs bit-equal: {same}; "
               f"rows 5-8 alone equal to the batch's: {by_row}; lr = 0 rows "
               f"kept: {kept}; {calls} launches for 2 calls; "
               f"{kernel_line('K6', kcf_k.train_shift_launch_info())}")
    if not (all(e[k] <= K6_TOL[k] for k in e) and same and by_row and kept
            and finite and calls == 2):
        raise AssertionError(f"K6: errors {e}, bit-equal {same}, by row "
                             f"{by_row}, lr = 0 kept {kept}, finite "
                             f"{finite}, launches {calls}")
    errs["shift_xf"], errs["shift_alphaf"] = e["xf"], e["alphaf"]

    # K8 at the serve cell's rows and at K = 3: against the plain version,
    # twice, and rows alone (K = 1: 4 rows with their bank rows; K = 3: each
    # scale's items against the whole bank) against the same rows of the
    # batch.
    errs["search_zf"] = errs["search_response"] = 0.0
    sigma = cfg.kcf.kernel_sigma
    for name, (m, f) in search_cases.items():
        before = kcf_k.launches_search
        got = kcf_k.search_fused(m, f, sigma)
        again = kcf_k.search_fused(m, f, sigma)
        calls = kcf_k.launches_search - before
        want = kcf_k.search_fused_ref(m, f, sigma)
        r = m.xf.shape[0]
        if r == f.shape[0]:
            part = slice(5, 9)
            alone = [(kcf_k.search_fused(
                kcf_ops.KCFModel(*[x[part].contiguous() for x in m]),
                f[part].contiguous(), sigma), part)]
        else:
            alone = [(kcf_k.search_fused(m, f[k * r:(k + 1) * r].contiguous(),
                                         sigma), slice(k * r, (k + 1) * r))
                     for k in range(f.shape[0] // r)]
        torch.cuda.synchronize()
        e = search_errors(got, want)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        by_row = all(torch.equal(a, b[part]) for rows, part in alone
                     for a, b in zip(rows, got))
        finite = all(torch.isfinite(x).all().item() for x in got)
        log("kcf", f"K8 search {name}: feat {tuple(f.shape)} on "
                   f"{r} bank rows: zf error {e['zf']:.3g}, response error "
                   f"{e['response']:.3g}, first maxima off the plain "
                   f"version's on rows apart by more than a tie: "
                   f"{e['tie_flips']} (on ties: "
                   f"{int((got.idx != want.idx).sum())}); peak, index, dy, "
                   f"dx as peak_displacement on its response: "
                   f"{e['own'] < math.inf}, PSR error there {e['own']:.3g} "
                   f"(limits {K8_TOL}); two runs bit-equal: {same}; rows "
                   f"alone equal to the batch's: {by_row}; {calls} launches "
                   f"for 2 calls; "
                   f"{kernel_line('K8', kcf_k.search_launch_info())}")
        if not (search_ok(e) and same and by_row and finite and calls == 2):
            raise AssertionError(f"K8 {name}: errors {e}, bit-equal {same}, "
                                 f"by row {by_row}, finite {finite}, "
                                 f"launches {calls}")
        errs["search_zf"] = max(errs["search_zf"], e["zf"])
        errs["search_response"] = max(errs["search_response"],
                                      e["response"])
    return errs


def block_shapes(spec: YoloSpec, batch: int) -> list[tuple[tuple, bool,
                                                         str]]:
    """(output shape, whether it takes a skip, activation) of every
    BatchNorm ConvBlock of a forward of `spec` at `batch` gray frames, in
    order (a forward on the meta device: nothing is allocated)."""
    with torch.device("meta"):
        model = yolo_mod.build_model(spec)
    seen = []

    def hook(block, args, kwargs, out):
        if block.bn is not None:
            seen.append((tuple(out.shape), kwargs.get("skip") is not None,
                         block.act))

    for block in model.modules():
        if isinstance(block, yolo_mod.ConvBlock):
            block.register_forward_hook(hook, with_kwargs=True)
    size = spec.input_size
    with torch.no_grad():
        model(torch.empty((batch, 1, size, size), device="meta"))
    return seen


def epilogue_inputs(dev, shape, skip: bool, seed: int = 0):
    """K7's arguments at `shape` on the card: y ~ 3 N(0, 1) with +-0,
    values near float32's largest, infinities and NaN at a few places;
    mean, mul = rsqrt(var + 1e-5) * weight and bias per channel; skip ~
    2 N(0, 1) or None."""
    g = torch.Generator(device=dev).manual_seed(seed)
    y = torch.randn(shape, device=dev, generator=g).mul_(3.0)
    flat = y.view(-1)
    at = torch.randint(0, flat.numel(), (10,), device=dev, generator=g)
    flat[at] = torch.tensor([0.0, -0.0, 3e38, -3e38, float("nan"), 1e-40,
                             -1e-40, float("inf"), -float("inf"),
                             float("nan")], device=dev)[:at.numel()]
    c = shape[1]
    mean, weight, bias = (torch.randn(c, device=dev, generator=g)
                          for _ in range(3))
    var = torch.rand(c, device=dev, generator=g)
    mul = torch.rsqrt(var + 1e-5) * weight
    s = (torch.randn(shape, device=dev, generator=g).mul_(2.0) if skip
         else None)
    return y, mean, mul, bias, s


def words_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, NaN too."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def detections_equal(a, b) -> bool:
    """Two detect_batch results (dets, valid, classes) bit for bit."""
    return (words_equal(a[0], b[0]) and torch.equal(a[1], b[1])
            and torch.equal(a[2], b[2]))


@contextlib.contextmanager
def epilogue_chain():
    """Every ConvBlock runs the chain inside the block (K7 declines)."""
    takes = epi_k.takes
    epi_k.takes = lambda *args: False
    try:
        yield
    finally:
        epi_k.takes = takes


def phase_epilogue(dev) -> dict:
    """K7 against the chain it replaces: bit-equal at every BatchNorm
    block's output shape of YOLOv3-608, yolov3-tiny-416 and YOLOv4-608
    (batch 2; the skip where YOLOv3 and YOLOv4 have one, Mish where YOLOv4
    has it) and past 2^31 elements; detect_batch at the benchmark cells'
    batches with its launches counted (72 / 11 / 107 K7, 72 of them Mish in
    YOLOv4, no chain block), every K7 call held to the plain version and
    the detections equal to the chain's; kernel, bound and chain times.
    Returns its row of the kernels line."""
    t_phase = time.perf_counter()
    batch = 2
    for spec, n_bn, _ in EPILOGUE_NETS:
        blocks = block_shapes(spec, batch)
        assert len(blocks) == bn_blocks(spec) == n_bn, spec.name
        shapes = list(dict.fromkeys(blocks))
        for i, (shape, skip, act) in enumerate(shapes):
            y, mean, mul, bias, s = epilogue_inputs(dev, shape, skip, i)
            want = epi_k.epilogue_ref(y, mean, mul, bias, s, act)
            vector = epi_k.vector_path(y, s)
            got = epi_k.fused(y, mean, mul, bias, s, act)
            torch.cuda.synchronize()
            assert got.data_ptr() == y.data_ptr(), shape
            assert words_equal(got, want), (spec.name, shape, skip, act,
                                            vector)
        log("epilogue", f"{spec.name} {spec.input_size} batch {batch}: K7 "
                        f"bit-equal to the chain at all {len(shapes)} "
                        f"(shape, skip, activation) cases of its BatchNorm "
                        f"blocks: "
                        f"{shapes}")
        del y, s, want, got
    torch.cuda.empty_cache()

    y, mean, mul, bias, s = epilogue_inputs(dev, EPILOGUE_BIG, True, 99)
    want = epi_k.epilogue_ref(y, mean, mul, bias, s)
    got = epi_k.fused(y, mean, mul, bias, s)
    torch.cuda.synchronize()
    assert y.numel() > 2**31 and words_equal(got, want)
    log("epilogue", f"{EPILOGUE_BIG} with a skip ({y.numel()} elements, "
                    f"{y.numel() * 4 / 1e9:.2f} GB): bit-equal to the chain")
    del y, s, want, got
    torch.cuda.empty_cache()

    # the main path at the benchmark cells' batches: detect_batch on 720p
    # u8 frames, counted from 0; again with every K7 call held word for word
    # against the plain version on the path's own inputs; again on the chain
    main_launches = []
    for spec, n_bn, frames_n in EPILOGUE_NETS:
        model = detector.YoloDetector.random_init(spec, seed=0,
                                                  device=dev).model
        frames = torch.randint(0, 256, (frames_n, E2E_H, E2E_W),
                               dtype=torch.uint8, device=dev,
                               generator=torch.Generator(
                                   device=dev).manual_seed(1))

        def detect():
            out = detector.detect_batch(model, frames, (E2E_H, E2E_W),
                                        E2E_DETS, E2E_IOU, E2E_SCORE)
            torch.cuda.synchronize()
            return out

        reset_counts()
        epi_k.chain_blocks = epi_k.mish_launches = 0
        got = detect()
        counts, chain = read_counts(), epi_k.chain_blocks
        mish = epi_k.mish_launches
        with kernels_checked() as st:
            checked = detect()
        errs = st.by_kernel()
        with epilogue_chain():
            want = detect()
        same = [detections_equal(got, x) for x in (checked, want)]
        log("epilogue", f"{spec.name} {spec.input_size}: detect_batch of "
                        f"{frames_n} u8 frames {E2E_H}x{E2E_W}: launches "
                        f"{counts} ({mish} with Mish), chain blocks {chain}; "
                        f"the K7 calls held "
                        f"to the plain version word for word: "
                        f"{len(errs.get('epilogue', []))}, equal "
                        f"{errs.get('epilogue', []).count(0)}; detections "
                        f"equal to the unchecked run's {same[0]} and to the "
                        f"chain's {same[1]}")
        if not (counts == dict(dict.fromkeys(KERNELS, 0), epilogue=n_bn)
                and mish == EPILOGUE_MISH.get(spec.name, 0)
                and chain == 0 and errs == {"epilogue": [0] * n_bn}
                and all(same)):
            raise AssertionError(f"epilogue: {spec.name} detect_batch: "
                                 f"launches {counts}, Mish {mish}, chain "
                                 f"blocks {chain}, K7 errors {errs}, equal "
                                 f"{same}")
        main_launches.append(counts["epilogue"])
        del model, frames, got, checked, want
        torch.cuda.empty_cache()

    row = {}
    for shape, skip, act in EPILOGUE_TIMED:
        y, mean, mul, bias, s = epilogue_inputs(dev, shape, skip)
        reps = 10
        kernel_ms = device_ms(
            lambda: epi_k.fused(y, mean, mul, bias, s, act), reps)
        chain_ms = device_ms(
            lambda: epi_k.epilogue_ref(y, mean, mul, bias, s, act), reps)
        b_ms, b_by = bound(y.numel() * 4 * (3 if skip else 2),
                           y.numel() * (6 if skip else 5))
        log("epilogue", f"{shape} {act} {'with' if skip else 'without'} "
                        f"skip (vector path {epi_k.vector_path(y, s)}): "
                        f"device "
                        f"ms per call (profiler) K7 {kernel_ms:.4f}, bound "
                        f"{b_ms:.4f} ({b_by}; {100 * b_ms / kernel_ms:.1f}% "
                        f"of it), chain {chain_ms:.4f}")
        if not row:
            row = {"shape": list(shape), "device_ms": kernel_ms,
                   "plain_device_ms": chain_ms, "bound_ms": b_ms,
                   "bound_by": b_by, "library_ms": None}
        del y, s
        torch.cuda.empty_cache()
    log("epilogue", f"phase took {time.perf_counter() - t_phase:.1f} s")
    return {"name": "epilogue", "route": "cuda",
            "source": "tpu_mot_torch/csrc/epilogue.cu",
            "replaces": "none (ConvBlock's BatchNorm, leaky ReLU and "
                        "shortcut add, left to XLA by the JAX package)",
            "launches": main_launches[0], "max_abs_err": 0.0,
            "err_kind": "bit-equal to the chain", **row}


def tracks_of(out, n_frames):
    ids = out.ids.cpu().numpy()
    boxes = out.boxes.cpu().numpy()
    valid = out.valid.cpu().numpy()
    return [(ids[f, valid[f]], boxes[f, valid[f]]) for f in range(n_frames)]


def score(out, gt_boxes, vis):
    hyp = tracks_of(out, N_FRAMES)
    gt = [(np.where(vis[f])[0], gt_boxes[f, np.where(vis[f])[0]])
          for f in range(N_FRAMES)]
    return hyp, metrics.clear_mot(gt, hyp)["mota"], metrics.hota(gt, hyp)


def class_mismatches(out, d) -> int:
    """Valid tracks with a match whose class is not their matched
    detection's, over a stacked StepOutput and its detections [N, D, 6]."""
    matched = out.valid & (out.matched_det >= 0)
    det_cls = torch.round(d[..., 5]).to(torch.int32)
    at = det_cls.gather(1, out.matched_det.long().clamp_min(0))
    return int((matched & (out.cls != at)).sum())


def counted_run(frames, d, v, cfg):
    """run_sequence with every launch count set to 0 just before it and
    read just after."""
    reset_counts()
    t0 = time.perf_counter()
    _, out = scan.run_sequence(bank_mod.empty_bank(cfg, device=frames.device),
                               frames, d, v, cfg)
    torch.cuda.synchronize()
    return out, read_counts(), time.perf_counter() - t0


def check_output(out, cfg, what):
    boxes_np = out.boxes.cpu().numpy()
    if boxes_np.shape != (N_FRAMES, cfg.max_tracks, 4) or not np.isfinite(
            boxes_np).all():
        raise AssertionError(f"{what}: bad output boxes {boxes_np.shape}")


def phase_e2e(frames, d, v, cfg, gt_boxes, vis, dets_list, frames_np):
    out, launches, wall = counted_run(frames, d, v, cfg)
    log("e2e", f"run_sequence {N_FRAMES} frames in {wall:.3f} s (first run); "
               f"kernel launches {launches}")
    want = {k: 0 for k in KERNELS}
    want.update(roi_extract=N_FRAMES, auction_solve=N_FRAMES,
                kcf_train_shift=N_FRAMES, kcf_search=N_FRAMES)
    if launches != want:
        raise AssertionError(f"expected launches {want}, got {launches}")
    check_output(out, cfg, "e2e")
    iters = out.assign_iters.cpu().numpy().astype(int).tolist()
    log("e2e", f"auction rounds per frame over {N_FRAMES} frames: min "
               f"{min(iters)}, median {statistics.median(iters)}, max "
               f"{max(iters)} (frame 0: {iters[0]})")
    hyp, mota, h_all = score(out, gt_boxes, vis)
    log("e2e", f"MOTA {mota} (JAX reference {M_REF}), HOTA "
               f"{h_all['hota']} (JAX reference {HOTA_REF}), DetA "
               f"{h_all['deta']}, AssA {h_all['assa']}, LocA {h_all['loca']}")
    if not mota >= M_REF - 0.01:
        raise AssertionError(f"MOTA {mota} < {M_REF} - 0.01")

    # The public API on the same fixture: init + 4 updates.
    mt = api.MultiTracker(cfg, device=frames.device)
    got = [mt.init(frames_np[0], dets_list[0])]
    got += [mt.update(frames_np[f], dets_list[f]) for f in range(1, 5)]
    for f, tracks in enumerate(got):
        ids, boxes = hyp[f]
        t_ids = [t[0] for t in tracks]
        t_boxes = np.array([t[1] for t in tracks], np.float32).reshape(-1, 4)
        if t_ids != ids.tolist() or not np.allclose(t_boxes, boxes, rtol=0,
                                                    atol=1e-4):
            raise AssertionError(f"MultiTracker frame {f} differs from "
                                 "run_sequence")
    log("e2e", f"MultiTracker init + 4 updates: confirmed ids and boxes equal"
               f" run_sequence's on frames 0-4 ({len(got[-1])} tracks)")
    return launches, float(mota), h_all, out


def phase_e2e_heavy(frames, d, v, cfg, gt_boxes, vis):
    dump = np.load(HEAVY_DUMP)
    launches = {}
    for name in HEAVY:
        hcfg = heavy_config(cfg, name)
        out, counts, wall = counted_run(frames, d, v, hcfg)
        want = {k: 0 for k in KERNELS}
        want.update(roi_extract_scales=N_FRAMES, auction_solve=N_FRAMES)
        if name == "HF":
            want.update(roi_extract=N_FRAMES, kcf_detect=N_FRAMES,
                        kcf_train=N_FRAMES)
        log("e2e-heavy", f"{name}: run_sequence {N_FRAMES} frames in "
                         f"{wall:.3f} s (first run); kernel launches "
                         f"{counts}")
        if counts != want:
            raise AssertionError(f"{name}: expected launches {want}, got "
                                 f"{counts}")
        check_output(out, hcfg, f"e2e-heavy {name}")
        _, mota, h_all = score(out, gt_boxes, vis)
        log("e2e-heavy", f"{name}: MOTA {mota} (JAX reference {M_REF}), "
                         f"HOTA {h_all['hota']}, DetA {h_all['deta']}, AssA "
                         f"{h_all['assa']}, LocA {h_all['loca']}")
        if not mota >= M_REF - 0.01:
            raise AssertionError(f"{name}: MOTA {mota} < {M_REF} - 0.01")
        key = name.lower()
        ids = out.ids.cpu().numpy()
        valid = out.valid.cpu().numpy()
        boxes = out.boxes.cpu().numpy()
        same = [bool(np.array_equal(ids[f], dump[f"{key}_ids"][f])
                     and np.array_equal(valid[f], dump[f"{key}_valid"][f]))
                for f in range(N_FRAMES)]
        both = valid & dump[f"{key}_valid"]
        box_diff = float(np.abs(boxes - dump[f"{key}_boxes"])[both].max())
        first = same.index(False) if not all(same) else None
        log("e2e-heavy", f"{name}: against the JAX run's dump, ids and valid "
                         f"equal on {sum(same)}/{N_FRAMES} frames (first "
                         f"differing frame: {first}); largest box "
                         f"difference on slots valid in both {box_diff:.3g}")
        if first is not None:
            slots = np.where((ids[first] != dump[f"{key}_ids"][first])
                             | (valid[first]
                                != dump[f"{key}_valid"][first]))[0]
            log("e2e-heavy", f"{name}: frame {first} differs at slots "
                             f"{slots.tolist()}")
        launches[name] = counts
    return launches


def phase_e2e_assoc(frames, d, v, cfg, gt_boxes, vis):
    """A and AW on the class fixture: the MOTA gate, exact launches, every
    valid track's class, and the JAX run's dump."""
    dump = np.load(ASSOC_DUMP)
    for name, extra in ASSOC.items():
        acfg = cfg.replace(**extra)
        assignment.warm_checks = 0
        out, counts, wall = counted_run(frames, d, v, acfg)
        checks = assignment.warm_checks
        want = {k: 0 for k in KERNELS}
        want.update(roi_extract=N_FRAMES, kcf_train_shift=N_FRAMES,
                    kcf_search=N_FRAMES,
                    auction_solve=0 if acfg.auction_warm_start else N_FRAMES)
        log("e2e-assoc", f"{name}: run_sequence {N_FRAMES} frames in "
                         f"{wall:.3f} s (first run); kernel launches "
                         f"{counts}; assoc_box {acfg.assoc_box_resolved}")
        if counts != want:
            raise AssertionError(f"{name}: expected launches {want}, got "
                                 f"{counts}")
        check_output(out, acfg, f"e2e-assoc {name}")
        _, mota, h_all = score(out, gt_boxes, vis)
        log("e2e-assoc", f"{name}: MOTA {mota} (JAX reference "
                         f"{ASSOC_M_REF[name]}), HOTA {h_all['hota']}, DetA "
                         f"{h_all['deta']}, AssA {h_all['assa']}, LocA "
                         f"{h_all['loca']}")
        if not mota >= ASSOC_M_REF[name] - 0.01:
            raise AssertionError(f"{name}: MOTA {mota} < "
                                 f"{ASSOC_M_REF[name]} - 0.01")
        wrong = class_mismatches(out, d)
        matched = int((out.valid & (out.matched_det >= 0)).sum())
        classes = sorted(set(out.cls[out.valid].tolist()))
        log("e2e-assoc", f"{name}: {matched} valid matched slot-frames, "
                         f"{wrong} with a class other than their "
                         f"detection's; classes tracked {classes}")
        if wrong or classes != [0, 1, 2]:
            raise AssertionError(f"{name}: {wrong} class mismatches, classes "
                                 f"{classes}")
        iters = out.assign_iters.cpu().numpy().astype(int)
        log("e2e-assoc", f"{name}: auction rounds per frame: median "
                         f"{statistics.median(iters.tolist())}, max "
                         f"{iters.max()} (frame 0: {iters[0]}); loop checks "
                         f"on the host (one sync each): {checks} in "
                         f"{N_FRAMES} frames")
        if bool(checks) != acfg.auction_warm_start:
            raise AssertionError(f"{name}: {checks} warm-auction checks")
        key = name.lower()
        ids = out.ids.cpu().numpy()
        valid = out.valid.cpu().numpy()
        boxes = out.boxes.cpu().numpy()
        same = [bool(np.array_equal(ids[f], dump[f"{key}_ids"][f])
                     and np.array_equal(valid[f], dump[f"{key}_valid"][f]))
                for f in range(N_FRAMES)]
        both = valid & dump[f"{key}_valid"]
        box_diff = float(np.abs(boxes - dump[f"{key}_boxes"])[both].max())
        cls_same = bool(np.array_equal(out.cls.cpu().numpy()[both],
                                       dump[f"{key}_cls"][both]))
        iters_same = int((iters == dump[f"{key}_iters"]).sum())
        log("e2e-assoc", f"{name}: against the JAX run's dump, ids and valid "
                         f"equal on {sum(same)}/{N_FRAMES} frames; largest "
                         f"box difference on slots valid in both "
                         f"{box_diff:.3g} px; classes equal: {cls_same}; "
                         f"auction rounds equal on {iters_same}/{N_FRAMES} "
                         "frames")
        if not all(same):
            first = same.index(False)
            slots = np.where((ids[first] != dump[f"{key}_ids"][first])
                             | (valid[first]
                                != dump[f"{key}_valid"][first]))[0]
            raise AssertionError(f"{name}: frame {first} differs from the "
                                 f"JAX run at slots {slots.tolist()}")
        if not (box_diff <= 0.05 and cls_same):
            raise AssertionError(f"{name}: boxes differ from the JAX run by "
                                 f"{box_diff} px (limit 0.05), classes equal "
                                 f"{cls_same}")


def set_matches(dets, valid, classes, ref_dets, ref_valid, ref_classes,
                tol: float = 0.05) -> list[int]:
    """Per frame, how many of the reference's valid detections have a valid
    detection of the same class whose centre is within tol px (NumPy
    [N, D, 5], [N, D], [N, D])."""
    out = []
    for f in range(ref_valid.shape[0]):
        got_c = classes[f][valid[f]]
        got_xy = dets[f][valid[f], :2]
        n = 0
        for i in np.where(ref_valid[f])[0]:
            near = np.abs(got_xy - ref_dets[f, i, :2]).max(axis=1) <= tol
            n += bool((near & (got_c == ref_classes[f, i])).any())
        out.append(n)
    return out


def triple(out) -> tuple:
    """(ids, valid, boxes) of a stacked StepOutput, as NumPy."""
    return tuple(x.cpu().numpy() for x in (out.ids, out.valid, out.boxes))


def compare_tracks(got, ref, tol: float = 0.05, start: int = 0,
                   excused=None) -> tuple[bool, str]:
    """Two runs' (ids, valid, boxes) [N, T(, 4)]: whether ids and valid are
    equal on every frame and the boxes of every slot-frame valid in both
    within tol px, and a summary (frames numbered from start).  Slot-frames
    in excused ([N, T] bool) are counted apart and not held to tol."""
    ids, valid, boxes = got
    r_ids, r_valid, r_boxes = ref
    same = [bool(np.array_equal(ids[f], r_ids[f])
                 and np.array_equal(valid[f], r_valid[f]))
            for f in range(ids.shape[0])]
    both = valid & r_valid
    diff = np.abs(boxes - r_boxes).max(axis=-1)
    over = (diff > tol) & both
    n_excused = 0
    if excused is not None:
        n_excused = int((over & excused).sum())
        over &= ~excused
    far = np.where(over)[0]
    diff = diff[both]
    first = same.index(False) if not all(same) else None
    txt = (f"ids and valid equal on {sum(same)}/{len(same)} frames (first "
           f"other: {None if first is None else start + first}); boxes "
           f"within {tol} px on {int((diff <= tol).sum())} of {diff.size} "
           f"valid slot-frames (largest difference "
           f"{float(diff.max()) if diff.size else 0.0:.3g} px; first frame "
           f"over {tol} px: {start + int(far[0]) if far.size else None}")
    if excused is not None:
        txt += f"; {n_excused} excused over {tol} px"
    return bool(all(same) and diff.size and not far.size), txt + ")"


def same_tracks(got, ref, what: str, tol: float = 0.05, start: int = 0,
                excused=None) -> str:
    """compare_tracks's summary; raises unless the runs are equal."""
    ok, txt = compare_tracks(got, ref, tol, start, excused)
    if not ok:
        raise AssertionError(f"{what}: {txt}")
    return txt


def dump_bank(dump, device) -> bank_mod.TrackBank:
    """JAX's tracker bank kept in the e2e dump (its "bank_" keys)."""
    fields = {}
    for name in bank_mod.TrackBank._fields:
        if name == "kcf":
            fields[name] = kcf_ops.KCFModel(**{
                p: interop.cf_to_complex(dump[f"bank_{p}_re"],
                                         dump[f"bank_{p}_im"], device)
                for p in ("xf", "alphaf")})
        else:
            fields[name] = torch.as_tensor(dump[f"bank_{name}"],
                                           device=device)
    return bank_mod.TrackBank(**fields)


def lockstep(bank, frames, dets, valid, other_dets, other_valid, cfg):
    """Step the tracker frame by frame with two sets of detections from the
    same bank, the first set's bank going on: both stacked StepOutputs, so
    a difference is one step's, not a drift."""
    outs, others = [], []
    for i in range(frames.shape[0]):
        others.append(step_mod.step(bank, frames[i], other_dets[i],
                                    other_valid[i], cfg)[1])
        bank, out = step_mod.step(bank, frames[i], dets[i], valid[i], cfg)
        outs.append(out)
    return tuple(step_mod.StepOutput(*[torch.stack(x) for x in zip(*o)])
                 for o in (outs, others))


@contextlib.contextmanager
def uncounted():
    """Launches made inside the block (a kernel held against its plain
    version) leave the launch counts as they were."""
    saved = read_counts()
    try:
        yield
    finally:
        set_counts(saved)


class KernelChecks:
    """What `kernels_checked` saw.  calls[(kernel, shape)]: the path's
    calls of each kernel at each input shape; errs[(kernel, shape)]: the
    errors of the calls held against the plain version there (K1 and K3
    |kernel - plain|, inf where not bit-equal to the 4-tap mirror; K2 0
    where col_of and iters equal the plain version's and a launch per
    problem's, else inf; K4 the response's and K5 the larger of xf's and
    alphaf's error relative to the largest magnitude, inf over KCF_TOL; K6
    as K5, inf over K6_TOL; K8 the larger of zf's and the response's,
    inf where `search_ok` fails; K7 0 where its output equals the plain
    version's word for word, else inf);
    rounds: K2's per problem of the checked calls; seen: each kernel's last
    checked inputs (K7 none); k8_f64: for each K8 call that fails
    `search_ok` by its response alone, the response's error against a
    float64 search of the same inputs, K8's and its plain version's
    (`search_float64_errors`).  A shape is (rows, S, "u8" or "f32") for K1,
    (scales, rows, S, ...) for K3, the benefit matrix's for K2, the
    features' for K4, K5 and K8, the spectrum's for K6, (N, C, H, W,
    whether a
    skip is added) for K7."""

    def __init__(self):
        self.calls = collections.Counter()
        self.errs, self.rounds, self.seen = {}, [], {}
        self.k8_f64 = []

    def by_kernel(self) -> dict:
        """{kernel: the errors of its checked calls, at every shape}."""
        out = {}
        for (k, _), e in self.errs.items():
            out.setdefault(k, []).extend(e)
        return out


@contextlib.contextmanager
def kernels_checked(at=None):
    """Within the block, the kernels' calls are held against their plain
    versions on the inputs the path gives them: every call, or with `at`
    the calls whose index among the calls of their kernel at their input
    shape is in `at`.  The launches made to compare are not counted.
    Yields a KernelChecks."""
    st = KernelChecks()
    k1, k3 = roi_k._resample_cuda, roi_k._resample_scales_cuda
    k2 = auction_k.auction_solve
    k4, k5 = kcf_k.detect_fused, kcf_k.train_fused
    k6 = kcf_k.train_shift_fused
    k8 = kcf_k.search_fused
    k7 = epi_k.fused

    def checking(kernel, shape) -> tuple | None:
        """The key to file the call's error under, or None: not checked."""
        key = (kernel, shape)
        st.calls[key] += 1
        return key if at is None or st.calls[key] - 1 in at else None

    def roi_shape(levels, ys) -> tuple:
        return (*ys.shape, "u8" if levels[0].dtype == torch.uint8 else "f32")

    def roi(levels, frame_hw, lvl, r0, c0, ys, xs):
        got = k1(levels, frame_hw, lvl, r0, c0, ys, xs)
        key = checking("roi_extract", roi_shape(levels, ys))
        if key is None:
            return got
        want = roi_k._resample_ref(levels, frame_hw, lvl, r0, c0, ys, xs)
        mirror = roi_k.four_tap_mirror(levels, frame_hw, lvl, r0, c0,
                                       ys[None], xs[None])[0]
        err = float((got - want).abs().max())
        st.errs.setdefault(key, []).append(
            err if torch.equal(got, mirror) else math.inf)
        st.seen["roi_extract"] = (levels, frame_hw, lvl, r0, c0, ys, xs)
        return got

    def roi3(levels, frame_hw, lvl, r0, c0, ys, xs):
        got = k3(levels, frame_hw, lvl, r0, c0, ys, xs)
        key = checking("roi_extract_scales", roi_shape(levels, ys))
        if key is None:
            return got
        want = roi_k._resample_scales_ref(levels, frame_hw, lvl, r0, c0, ys,
                                          xs)
        mirror = roi_k.four_tap_mirror(levels, frame_hw, lvl, r0, c0, ys, xs)
        err = float((got - want).abs().max())
        st.errs.setdefault(key, []).append(
            err if torch.equal(got, mirror) else math.inf)
        st.seen["roi_extract_scales"] = (levels, frame_hw, lvl, r0, c0, ys,
                                         xs)
        return got

    def auction(b, eps, max_iters):
        col, it = k2(b, eps, max_iters)
        key = checking("auction_solve", tuple(b.shape))
        if key is None:
            return col, it
        want_col, want_it = auction_k.auction_solve_ref(b, eps, max_iters)
        with uncounted():
            one = [k2(b[p].contiguous(), eps, max_iters)
                   for p in range(b.shape[0])]
        same = (torch.equal(col, want_col) and torch.equal(it, want_it)
                and all(torch.equal(col[p], c) and torch.equal(it[p], i)
                        for p, (c, i) in enumerate(one)))
        st.errs.setdefault(key, []).append(0 if same else math.inf)
        st.rounds.extend(it.tolist())
        st.seen["auction_solve"] = b.clone()
        return col, it

    def detect(model, feat, sigma):
        got = k4(model, feat, sigma)
        key = checking("kcf_detect", tuple(feat.shape))
        if key is None:
            return got
        e = rel_err(got, kcf_k.detect_fused_ref(model, feat, sigma))
        st.errs.setdefault(key, []).append(
            e if e <= KCF_TOL["response"] else math.inf)
        st.seen["kcf_detect"] = (
            kcf_ops.KCFModel(*[x.clone() for x in model]), feat.clone(),
            sigma)
        return got

    def train(model, feat, yf, sigma, lambda_, lr):
        got = k5(model, feat, yf, sigma, lambda_, lr)
        key = checking("kcf_train", tuple(feat.shape))
        if key is None:
            return got
        want = kcf_k.train_fused_ref(model, feat, yf, sigma, lambda_, lr)
        e_x, e_a = rel_err(got.xf, want.xf), rel_err(got.alphaf, want.alphaf)
        st.errs.setdefault(key, []).append(
            max(e_x, e_a) if e_x <= KCF_TOL["xf"]
            and e_a <= KCF_TOL["alphaf"] else math.inf)
        st.seen["kcf_train"] = (
            kcf_ops.KCFModel(*[x.clone() for x in model]), feat.clone(), yf,
            sigma, lambda_, lr.clone())
        return got

    def train_shift(model, zf, dy, dx, yf, sigma, lambda_, lr, width):
        got = k6(model, zf, dy, dx, yf, sigma, lambda_, lr, width)
        key = checking("kcf_train_shift", tuple(zf.shape))
        if key is None:
            return got
        want = kcf_k.train_shift_fused_ref(model, zf, dy, dx, yf, sigma,
                                           lambda_, lr, width)
        e_x, e_a = rel_err(got.xf, want.xf), rel_err(got.alphaf, want.alphaf)
        st.errs.setdefault(key, []).append(
            max(e_x, e_a) if e_x <= K6_TOL["xf"]
            and e_a <= K6_TOL["alphaf"] else math.inf)
        st.seen["kcf_train_shift"] = (
            kcf_ops.KCFModel(*[x.clone() for x in model]), zf.clone(),
            dy.clone(), dx.clone(), yf, sigma, lambda_, lr.clone(), width)
        return got

    def search(model, feat, sigma):
        got = k8(model, feat, sigma)
        key = checking("kcf_search", tuple(feat.shape))
        if key is None:
            return got
        want = kcf_k.search_fused_ref(model, feat, sigma)
        e = search_errors(got, want)
        st.errs.setdefault(key, []).append(
            max(e["zf"], e["response"]) if search_ok(e) else math.inf)
        if not search_ok(e) and search_ok(dict(e, response=0.0)):
            st.k8_f64.append(search_float64_errors(model, feat, sigma, got,
                                                   want))
        st.seen["kcf_search"] = (
            kcf_ops.KCFModel(*[x.clone() for x in model]), feat.clone(),
            sigma)
        return got

    def epilogue(y, mean, mul, bias, skip=None, act="leaky"):
        key = checking("epilogue", (*y.shape, skip is not None)
                       + ((act,) if act != "leaky" else ()))
        if key is None:
            return k7(y, mean, mul, bias, skip, act)
        # K7 is in place
        want = epi_k.epilogue_ref(y, mean, mul, bias, skip, act)
        got = k7(y, mean, mul, bias, skip, act)
        st.errs.setdefault(key, []).append(
            0 if words_equal(got, want) else math.inf)
        return got

    roi_k._resample_cuda, roi_k._resample_scales_cuda = roi, roi3
    auction_k.auction_solve = auction
    kcf_k.detect_fused, kcf_k.train_fused = detect, train
    kcf_k.train_shift_fused = train_shift
    kcf_k.search_fused = search
    epi_k.fused = epilogue
    try:
        yield st
    finally:
        roi_k._resample_cuda, roi_k._resample_scales_cuda = k1, k3
        auction_k.auction_solve = k2
        kcf_k.detect_fused, kcf_k.train_fused = k4, k5
        kcf_k.train_shift_fused = k6
        kcf_k.search_fused = k8
        epi_k.fused = k7


def checked_run(run, *args):
    """run(*args) with every kernel call held against its plain version on
    the inputs the path gives it (`kernels_checked`).  Returns the outputs;
    per kernel that ran, its calls' errors; K2's rounds per problem; each
    kernel's last inputs."""
    with kernels_checked() as st:
        _, out = run(*args)
    return out, st.by_kernel(), st.rounds, st.seen


def phase_e2e_detect(dev, card: str):
    """The detector path of bench_e2e.py on the card: yolov3-tiny on 32 u8
    frames of 720p, then the tracker at 128 slots (see E2E_DUMP)."""
    t_phase = time.perf_counter()
    frames_np, d_np, v_np, cfg, spec = e2e_fixture()
    frames = torch.as_tensor(frames_np, device=dev)
    d = torch.as_tensor(d_np, device=dev)
    v = torch.as_tensor(v_np, device=dev)
    dump = np.load(E2E_DUMP)
    hw = (E2E_H, E2E_W)
    det = detector.YoloDetector.random_init(
        spec, seed=E2E_SEED, device=dev, max_out=E2E_DETS, iou_thr=E2E_IOU,
        score_thr=E2E_SCORE)
    model = det.model
    n_params = sum(p.numel() for p in model.parameters()) + sum(
        b.numel() for n, b in model.named_buffers()
        if not n.endswith("num_batches_tracked"))
    log("e2e-detect", f"{spec.name}, {spec.num_classes} classes at "
                      f"{spec.input_size}, {spec.dtype}, {n_params} "
                      f"parameters and BatchNorm statistics; {E2E_FRAMES} frames {E2E_H}x{E2E_W} u8, "
                      f"{cfg.max_tracks} tracks, {E2E_DETS} detections")

    def detect(m, fr, impl="greedy"):
        return detector.detect_batch(m, fr, hw, E2E_DETS, E2E_IOU,
                                     E2E_SCORE, nms_impl=impl)

    # 1. every candidate before NMS against the JAX dump
    boxes, scores, classes = detector.decode_frames(model, frames, hw)
    pre = slice(0, E2E_PRE)
    s_diff = float(np.abs(scores[pre].cpu().numpy()
                          - dump["pre_scores"]).max())
    b_diff = float(np.abs(boxes[pre].cpu().numpy()
                          - dump["pre_boxes"]).max())
    c_same = float((classes[pre].cpu().numpy()
                    == dump["pre_classes"]).mean())
    log("e2e-detect", f"before NMS, frames 0-{E2E_PRE - 1} "
                      f"({scores.shape[1]} candidates each) against the JAX "
                      f"dump: max |score diff| {s_diff:.3g} (limit "
                      f"{E2E_PRE_SCORE_TOL:g}), max box diff {b_diff:.3g} "
                      f"frame px (limit {E2E_PRE_BOX_TOL:g}; boxes up to "
                      f"{np.abs(dump['pre_boxes']).max():.1f} px), classes "
                      f"equal on {100 * c_same:.3f}%")
    if not (s_diff <= E2E_PRE_SCORE_TOL and b_diff <= E2E_PRE_BOX_TOL
            and c_same == 1.0):
        raise AssertionError(f"e2e-detect: pre-NMS score {s_diff}, box "
                             f"{b_diff}, classes equal {c_same}")

    # 2. NMS on the card against NMS on the CPU fed the card's candidates,
    # and the detections against the dump's as sets
    idx, val = nms_ops.nms_classwise(boxes, scores, classes, E2E_DETS,
                                     E2E_IOU, E2E_SCORE)
    idx_c, val_c = nms_ops.nms_classwise(boxes.cpu(), scores.cpu(),
                                         classes.cpu(), E2E_DETS, E2E_IOU,
                                         E2E_SCORE)
    nms_same = (torch.equal(idx.cpu(), idx_c)
                and torch.equal(val.cpu(), val_c))
    dets, valid, cls = detect(model, frames)
    first = tuple(x[0].cpu() for x in (dets, valid, cls))  # the bench phase's
    safe = idx.long().clamp_min(0)
    gathered = torch.equal(dets[..., :4], boxes.gather(
        1, safe[..., None].expand(-1, -1, 4))) and torch.equal(valid, val)
    matches = set_matches(dets.cpu().numpy(), valid.cpu().numpy(),
                          cls.cpu().numpy(), dump["dets"], dump["valid"],
                          dump["classes"])
    log("e2e-detect", f"NMS on the card equals NMS on the CPU fed the card's "
                      f"candidates, index for index on {E2E_FRAMES} frames: "
                      f"{nms_same}; detect_batch gives those detections: "
                      f"{gathered}; valid per frame "
                      f"{valid.sum(1).tolist()}")
    log("e2e-detect", f"detections matching the JAX dump's (same class, "
                      f"centre within 0.05 px), of 64 per frame: min "
                      f"{min(matches)}, median {statistics.median(matches)},"
                      f" per frame {matches} (floor {E2E_MATCH_FLOOR})")
    if not (nms_same and gathered and min(matches) >= E2E_MATCH_FLOOR):
        raise AssertionError(f"e2e-detect: NMS card == CPU {nms_same}, "
                             f"detect_batch consistent {gathered}, matches "
                             f"{matches}")

    # 3. the tracker fed the dump's detections against the dump's tracks:
    # a free run on the frames before E2E_BANK_FRAME, then the frames from
    # it on stepped from JAX's bank, with K8's plain version beside K8 there
    # (see E2E_TIE_EPS)
    k = E2E_BANK_FRAME
    bank0 = bank_mod.empty_bank(cfg, device=dev)
    dump_d = torch.as_tensor(dump["dets"], device=dev)
    dump_v = torch.as_tensor(dump["valid"], device=dev)
    ref = (dump["ids"], dump["track_valid"], dump["boxes"])
    ref_tail = [x[k:] for x in ref]
    _, free = scan.run_sequence(bank0, frames, dump_d, dump_v, cfg)
    free = triple(free)
    log("e2e-detect", f"run_sequence fed the dump's detections, frames 0-"
                      f"{k - 1} against the dump's tracks: " + same_tracks(
                          [x[:k] for x in free], [x[:k] for x in ref],
                          "tracker vs JAX dump"))
    _, tail_plain = with_plain_search(lambda: scan.run_sequence(
        dump_bank(dump, dev), frames[k:], dump_d[k:], dump_v[k:], cfg))
    log("e2e-detect", f"run_sequence from JAX's bank after frame {k - 1} "
                      f"with K8's plain version, frames {k}-{E2E_FRAMES - 1}"
                      " against the dump's tracks: " + same_tracks(
                          triple(tail_plain), ref_tail,
                          "plain version from JAX's bank vs JAX dump",
                          start=k))
    _, tail = scan.run_sequence(dump_bank(dump, dev), frames[k:],
                                dump_d[k:], dump_v[k:], cfg)
    steps, ties = step_ties(dump_bank(dump, dev), frames[k:], dump_d[k:],
                            dump_v[k:], cfg)
    again = all(torch.equal(getattr(steps, f), getattr(tail, f))
                for f in ("ids", "valid", "boxes", "matched_det"))
    # a slot follows another choice from the first frame its match differs
    # from the plain version's run on
    follows = np.logical_or.accumulate(
        (tail.matched_det != tail_plain.matched_det).cpu().numpy(), axis=0)
    log("e2e-detect", f"the same with K8, excused the {int(follows.sum())} "
                      "slot-frames that follow another auction choice than "
                      "the plain version's: " + same_tracks(
                          triple(tail), ref_tail,
                          "K8 from JAX's bank vs JAX dump", start=k,
                          excused=follows)
                      + f"; stepped from K8's bank, K8 and its plain version"
                      f" match slots otherwise on frames "
                      f"{[k + t['frame'] for t in ties]}, each a tie within "
                      f"{E2E_TIE_EPS:g} a slot on the float64 search's cost"
                      f" (pairs, total cost): "
                      f"{[dict(t, frame=k + t['frame']) for t in ties]}; "
                      "the steps equal the "
                      f"run: {again}")
    # every divergence starts at or after a witnessed tie
    diverge = int(follows.any(axis=1).argmax()) if follows.any() else None
    if not (again and all(is_tie(t) for t in ties)
            and (diverge is None or (ties and ties[0]["frame"] <= diverge))):
        raise AssertionError(f"e2e-detect: K8 from JAX's bank: choices "
                             f"other than the plain version's {ties}, steps "
                             f"equal the run {again}, first slot-frame "
                             f"following another choice on frame "
                             f"{diverge}")
    log("e2e-detect", "the free run over every frame against the dump "
                      "(printed, not held): " + compare_tracks(free, ref)[1])

    # 4. launches of the fused detect -> track run
    reset_counts()
    dets, valid, det_cls = detect(model, frames)
    _, fused = scan.run_sequence(bank0, frames, dets, valid, cfg)
    torch.cuda.synchronize()
    counts = read_counts()
    want = {k: 0 for k in KERNELS}
    n_bn = bn_blocks(spec)
    want.update(roi_extract=E2E_FRAMES, auction_solve=E2E_FRAMES,
                kcf_train_shift=E2E_FRAMES, kcf_search=E2E_FRAMES,
                epilogue=n_bn)
    log("e2e-detect", f"fused detect_batch + run_sequence, {E2E_FRAMES} "
                      f"frames on {frames.device}: kernel launches {counts}; "
                      f"{int(fused.valid.sum())} valid slot-frames")
    if counts != want:
        raise AssertionError(f"e2e-detect: launches {counts}, expected {want}")
    check_tracks = fused.boxes.cpu().numpy()
    if not np.isfinite(check_tracks).all() or not fused.valid.any():
        raise AssertionError("e2e-detect: fused run's tracks not finite")
    # the detector call again with each K7 call held word for word against
    # its plain version on the path's own conv outputs
    with kernels_checked() as st:
        checked_det = detect(model, frames)
    k7_err = st.by_kernel()
    same_det = detections_equal(checked_det, (dets, valid, det_cls))
    log("e2e-detect", f"the detector call checked call by call: K7 "
                      f"{len(k7_err.get('epilogue', []))} calls, equal to "
                      f"the plain version word for word on "
                      f"{k7_err.get('epilogue', []).count(0)}; detections "
                      f"equal the counted run's: {same_det}")
    if not (k7_err == {"epilogue": [0] * n_bn} and same_det):
        raise AssertionError(f"e2e-detect: K7 errors {k7_err}, detections "
                             f"equal {same_det}")
    # the same run again with K1, K2, K6 and K8 held against their plain
    # versions on every call: the path's own pyramids, boxes, benefit
    # matrices, spectra and windows
    checked, errs, rounds, _ = checked_run(scan.run_sequence, bank0, frames,
                                           dets, valid, cfg)
    k1_err, k2_err = errs["roi_extract"], errs["auction_solve"]
    k6_err = errs.get("kcf_train_shift", [])
    k8_err = errs.get("kcf_search", [])
    same_run = all(torch.equal(getattr(checked, f), getattr(fused, f))
                   for f in ("ids", "valid", "boxes", "assign_iters"))
    log("e2e-detect", f"fused run checked call by call: K1 on the {E2E_H}p "
                      f"u8 pyramid, {len(k1_err)} calls, max |kernel - plain|"
                      f" {max(k1_err):.3g} (limit {ROI_TOL:g}; inf: not "
                      f"bit-equal to the 4-tap mirror); K2 on the "
                      f"[{cfg.max_tracks}, {cfg.max_tracks}] benefits, "
                      f"{len(k2_err)} calls, col_of and iters exactly equal "
                      f"on {k2_err.count(0)} (rounds median "
                      f"{statistics.median(rounds)}, max {max(rounds)}); "
                      f"K6 {len(k6_err)} calls, largest error "
                      f"{max(k6_err, default=math.inf):.3g} (limit "
                      f"{K6_TOL['alphaf']:g}); K8 {len(k8_err)} calls, "
                      f"largest error {max(k8_err, default=math.inf):.3g} "
                      f"(limits {K8_TOL}); outputs equal the counted "
                      f"run's: {same_run}")
    if not (len(k1_err) == len(k2_err) == len(k6_err) == len(k8_err)
            == E2E_FRAMES
            and same_run and max(k1_err) <= ROI_TOL and max(k2_err) == 0
            and max(k6_err) <= K6_TOL["alphaf"]
            and max(k8_err) <= K8_TOL["response"]
            and set(errs) == {"roi_extract", "auction_solve",
                              "kcf_train_shift", "kcf_search"}):
        raise AssertionError(f"e2e-detect: K1 errors {k1_err}; K2 {k2_err}; "
                             f"K6 {k6_err}; K8 {k8_err}; "
                             f"same run {same_run}")

    # 5. variants: the strided scans, bf16 + fast NMS, int8
    for n in (E2E_FRAMES, E2E_FRAMES - E2E_FRAMES % E2E_STRIDE):
        fr = frames[:n]
        ref_d = torch.zeros((n, E2E_DETS, 5), device=dev)
        ref_v = torch.zeros((n, E2E_DETS), dtype=torch.bool, device=dev)
        for i in range(0, n, E2E_STRIDE):
            dd, vv, _ = detect(model, fr[i:i + 1])
            ref_d[i], ref_v[i] = dd[0], vv[0]
        _, ref = scan.run_sequence(bank0, fr, ref_d, ref_v, cfg)
        _, st = scan.run_sequence_strided_detector(
            bank0, fr, model, cfg, E2E_STRIDE, E2E_IOU, E2E_SCORE)
        lowering = "grouped" if n % E2E_STRIDE == 0 else "per-frame branch"
        log("e2e-detect", f"run_sequence_strided_detector stride "
                          f"{E2E_STRIDE}, N={n} ({lowering} in JAX) against "
                          "run_sequence fed the same detections: "
                          + same_tracks(triple(st), triple(ref),
                                        f"strided N={n}"))
        if n == E2E_FRAMES:
            scanned, scanned_d, scanned_v = st, ref_d, ref_v
    # the batched form: one forward over the stride frames, then
    # run_sequence; its detections against the B=1 forwards' above
    d_b, v_b, c_b = detect(model, frames[::E2E_STRIDE])
    ref_d = torch.zeros_like(scanned_d)
    ref_v = torch.zeros_like(scanned_v)
    ref_d[::E2E_STRIDE], ref_v[::E2E_STRIDE] = d_b, v_b
    _, ref = scan.run_sequence(bank0, frames, ref_d, ref_v, cfg)
    _, batched = scan.run_sequence_strided_batched(
        bank0, frames, model, cfg, E2E_STRIDE, E2E_IOU, E2E_SCORE)
    n_det = d_b.shape[0]
    log("e2e-detect", f"run_sequence_strided_batched (one forward over "
                      f"{n_det} frames) against run_sequence fed that "
                      "forward's detections: "
                      + same_tracks(triple(batched), triple(ref), "batched"))
    one_d = scanned_d[::E2E_STRIDE]
    both_v = v_b & scanned_v[::E2E_STRIDE]
    det_diff = float((d_b - one_d).abs()[both_v].max())
    same_v = torch.equal(v_b, scanned_v[::E2E_STRIDE])
    log("e2e-detect", f"the batched forward's detections against the {n_det}"
                      f" B=1 forwards': bit-equal {torch.equal(d_b, one_d)}, "
                      f"valid equal {same_v}, largest difference "
                      f"{det_diff:.3g} (px or score; limit "
                      f"{E2E_PRE_BOX_TOL:g}) over slots valid in both")
    if not (same_v and det_diff <= E2E_PRE_BOX_TOL):
        raise AssertionError(f"e2e-detect: batched forward's detections "
                             f"{det_diff} from the B=1 forwards', valid "
                             f"equal {same_v}")
    # batched against scanned: the two forwards' detections differ in the
    # last bits (cuDNN picks its algorithm by batch size), so both are
    # stepped from the scanned form's bank on every frame (a free run
    # carries a last-bit difference into pixels on a slot that has lost its
    # object).  A step may still match a track to another of two near-tied
    # detections (the auction is eps-optimal, eps 0.02): such slot-frames
    # are excused, every other box is held to 0.05 px.
    step_scanned, step_batched = lockstep(bank0, frames, scanned_d,
                                          scanned_v, ref_d, ref_v, cfg)
    again = all(torch.equal(getattr(step_scanned, f), getattr(scanned, f))
                for f in ("ids", "valid", "boxes"))
    flips = (step_batched.matched_det != step_scanned.matched_det)
    log("e2e-detect", "the batched form against the scanned form, both "
                      "stepped from the scanned form's bank on every frame "
                      "(excused: slot-frames matched to another detection, "
                      f"{int(flips.sum())} on frames "
                      f"{sorted(set(flips.nonzero()[:, 0].tolist()))}): "
                      + same_tracks(triple(step_batched),
                                    triple(step_scanned),
                                    "batched vs scanned, step by step",
                                    excused=flips.cpu().numpy())
                      + f"; the scanned steps equal the scanned run: {again}")
    log("e2e-detect", "the batched form against the scanned form, free runs "
                      "(printed, not held): " + compare_tracks(
                          triple(batched), triple(scanned))[1])
    if not again:
        raise AssertionError("e2e-detect: stepping the scanned form's "
                             "detections differs from the scanned run")

    state = model.state_dict()
    m16 = detector.YoloDetector(dataclasses.replace(spec, dtype="bfloat16"),
                                state, device=dev).model
    m8 = detector.YoloDetector(dataclasses.replace(spec, dtype="int8"),
                               state, device=dev).model
    d32, v32, _ = (x.cpu().numpy() for x in detect(model, frames))
    d16, v16, _ = (x.cpu().numpy() for x in detect(m16, frames, "fast"))
    top = float(np.abs(d16[:, 0, 4] - d32[:, 0, 4]).max())
    log("e2e-detect", f"bf16 + fast NMS against float32 + greedy: largest "
                      f"top-score difference {top:.3g} (limit 0.05, "
                      f"tests/test_detector.py:305); valid per frame "
                      f"{sorted(set(v16.sum(1).tolist()))}")
    # one quantised layer, ConvBlock_1 on its input in the int8 net: its
    # integer sums are exact in float64, so the card equals the CPU bit for
    # bit
    seen = []
    hook = m8.ConvBlock_1.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0][:2]))
    _, s8, _ = detector.decode_frames(m8, frames, hw)
    hook.remove()
    conv1 = m8.ConvBlock_1.conv
    q_card, q_cpu = (yolo_mod._quant_conv(
        x, w, conv1.stride[0], conv1.padding[0], False)
        for x, w in ((seen[0], conv1.weight),
                     (seen[0].cpu(), conv1.weight.cpu())))
    q_same = torch.equal(q_card.cpu(), q_cpu)
    q_vs_f32 = rel_err(q_card, torch.nn.functional.conv2d(
        seen[0], conv1.weight, None, conv1.stride, conv1.padding))
    log("e2e-detect", f"int8 ConvBlock_1 on {tuple(seen[0].shape)}: the "
                      f"quantised conv on the card bit-equal to the CPU's: "
                      f"{q_same}; its largest difference from the float32 "
                      f"conv, relative to the largest |output|: "
                      f"{q_vs_f32:.3g}")
    s8_diff = float((s8 - scores).abs().max())
    d8, v8, _ = (x.cpu().numpy() for x in detect(m8, frames))
    twins = []
    for b in range(E2E_FRAMES):
        for i in np.where(v32[b])[0]:
            dist = np.linalg.norm(d8[b, v8[b], :2] - d32[b, i, :2], axis=1)
            twins.append(bool(dist.size and dist.min() < 4.0))
    n_diff = int(np.abs(v8.sum(1) - v32.sum(1)).max())
    log("e2e-detect", f"int8 against float32, both greedy: valid count "
                      f"difference per frame at most {n_diff} (limit 1, "
                      f"tests/test_detector.py:475; every frame fills its "
                      f"{E2E_DETS} slots, so it cannot fail here); max "
                      f"|score diff| before NMS {s8_diff:.3g} (over "
                      f"{E2E_INT8_SCORE_MIN:g}: quantised; at most "
                      f"{E2E_INT8_SCORE_TOL:g}); float32 detections with an "
                      f"int8 twin within 4 px: {sum(twins)} of {len(twins)} "
                      "(printed, not held: near-tied candidates, see "
                      "PERF.md)")
    if not (np.isfinite(d16).all() and top <= 0.05 and np.isfinite(d8).all()
            and n_diff <= 1 and q_same
            and E2E_INT8_SCORE_MIN < s8_diff <= E2E_INT8_SCORE_TOL):
        raise AssertionError(f"e2e-detect: bf16 top {top}, int8 count "
                             f"{n_diff}, int8 scores {s8_diff}, int8 layer "
                             f"card == CPU {q_same}")

    # the stages' times are the bench_e2e twin's (the bench phase)
    log("e2e-detect", f"phase took {time.perf_counter() - t_phase:.1f} s")
    return (model, frames, cfg), first


def phase_profile_detect(model, frames, cfg, n_frames: int = 16):
    """The fused detect -> track run of e2e-detect over n_frames under the
    profiler, then one detect_batch call on the whole batch with each NMS
    (launches, device time)."""
    hw = (E2E_H, E2E_W)

    def fused():
        d, v, _ = detector.detect_batch(model, frames[:n_frames], hw,
                                        E2E_DETS, E2E_IOU, E2E_SCORE)
        scan.run_sequence(bank_mod.empty_bank(cfg, device=frames.device),
                          frames[:n_frames], d, v, cfg)

    phase_profile("E2E-720 fused detect -> track", fused, n_frames)
    for impl in ("greedy", "fast"):
        kernels, _, _ = profiled(lambda: detector.detect_batch(
            model, frames, hw, E2E_DETS, E2E_IOU, E2E_SCORE, nms_impl=impl))
        log("profile", f"E2E-720 detect_batch alone, {frames.shape[0]} "
                       f"frames, {impl} NMS: {sum(r[2] for r in kernels)} "
                       f"kernel launches, device "
                       f"{sum(r[1] for r in kernels) / 1e3:.3f} ms a call")


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of paired (cx, cy, w, h) boxes [..., 4]."""
    lo = np.maximum(a[..., :2] - a[..., 2:] / 2, b[..., :2] - b[..., 2:] / 2)
    hi = np.minimum(a[..., :2] + a[..., 2:] / 2, b[..., :2] + b[..., 2:] / 2)
    inter = np.prod(np.clip(hi - lo, 0.0, None), axis=-1)
    union = np.prod(a[..., 2:], axis=-1) + np.prod(b[..., 2:], axis=-1) - inter
    return inter / union


def single_object_clip(n_frames: int = 100, height: int = 480,
                       width: int = 640):
    """One textured object moving at (2, 1.2) px a frame."""
    objs = [synthetic.SyntheticObject(cx=160, cy=120, w=28, h=24, vx=2.0,
                                      vy=1.2)]
    frames, boxes, _ = synthetic.render_sequence(objs, n_frames, height,
                                                 width, seed=3, noise=0.0)
    return frames, boxes[:, 0]


def bank_run(frames, boxes0, kcfg, train_site):
    """init_bank on frame 0, then run_otb_sequence over the whole clip,
    with the launch counts set to 0 just before and read just after."""
    reset_counts()
    t0 = time.perf_counter()
    bank = kcf_bank.init_bank(
        patch_ops.to_gray(frames[0]), boxes0,
        torch.ones((boxes0.shape[0],), dtype=torch.bool,
                   device=boxes0.device), kcfg)
    _, boxes, peaks = kcf_bank.run_otb_sequence(bank, frames, kcfg,
                                                train_site)
    torch.cuda.synchronize()
    return boxes, peaks, read_counts(), time.perf_counter() - t0


def phase_kcf_tracker():
    """The single-object flow through the per-frame wrapper, T = 1."""
    clip, gt = single_object_clip()
    reset_counts()
    tracker = kcf_bank.KCFTracker(KCFConfig())
    if tracker.device.type != "cuda":
        raise AssertionError(f"KCFTracker() runs on {tracker.device}")
    tracker.init(clip[0], gt[0])
    errs, peaks = [], []
    for f in range(1, len(clip)):
        box, peak = tracker.update(clip[f])
        errs.append(float(np.hypot(box[0] - gt[f, 0], box[1] - gt[f, 1])))
        peaks.append(peak)
    counts = read_counts()
    log("kcf-bank", f"KCFTracker on a {clip.shape[1]}x{clip.shape[2]} clip "
                    f"of {len(clip)} frames: centre error max "
                    f"{max(errs):.3f} px, mean {statistics.mean(errs):.3f} "
                    f"px; peak min {min(peaks):.3f}; kernel launches "
                    f"{counts}")
    want = {k: 0 for k in KERNELS}
    want["roi_extract"] = 1 + 2 * (len(clip) - 1)
    want["kcf_search"] = len(clip) - 1
    if counts != want or not max(errs) < 2.0:
        raise AssertionError(f"KCFTracker: launches {counts} (expected "
                             f"{want}), centre error {max(errs)} px")


def with_plain_k1(fn):
    """Run fn() with K1's plain version in K1's place."""
    kernel = roi_k._resample_cuda
    roi_k._resample_cuda = roi_k._resample_ref
    try:
        return fn()
    finally:
        roi_k._resample_cuda = kernel


def with_plain_search(fn):
    """Run fn() with K8's plain version in K8's place."""
    kernel = kcf_k.search_fused
    kcf_k.search_fused = kcf_k.search_fused_ref
    try:
        return fn()
    finally:
        kcf_k.search_fused = kernel


def step_cost(bank, frame, dets, valid, cfg, float64=False):
    """step_mod.step, and the cost matrix [T, D] (float64 NumPy) and
    feasibility its auction was given; float64: ops/kcf.search run as the
    FFT chain in float64 (its results rounded to float32 for the step)."""
    search, solve, seen = kcf_ops.search, assignment.auction_assign_stats, {}

    def search_f64(model, feats, sigma, wts, impl):
        found = search(kcf_ops.KCFModel(*[x.to(torch.complex128)
                                          for x in model]),
                       feats.double(), sigma, wts.double(), "xla")
        return found._replace(zf=found.zf.to(torch.complex64), **{
            f: getattr(found, f).float()
            for f in ("dy", "dx", "peak", "response", "peaks")})

    def recorded(cost, feasible, *args, **kw):
        seen["cost"] = cost[0].double().cpu().numpy()
        seen["feasible"] = feasible[0].cpu().numpy()
        return solve(cost, feasible, *args, **kw)

    assignment.auction_assign_stats = recorded
    if float64:
        kcf_ops.search = search_f64
    try:
        bank, out = step_mod.step(bank, frame, dets, valid, cfg)
    finally:
        kcf_ops.search, assignment.auction_assign_stats = search, solve
    return bank, out, seen["cost"], seen["feasible"]


def step_ties(bank, frames, dets, valid, cfg):
    """Step frame by frame with K8, its bank going on, and from each frame's
    bank also with K8's plain version: K8's stacked StepOutput, and for
    each frame where the two match slots otherwise the witness (see
    E2E_TIE_EPS): frame index, slots matched otherwise, pairs and total
    cost on the float64 search's cost matrix of K8's matching, the plain
    version's, the float64 step's own and the best (scipy), and slots where
    the float64 step's matching differs from K8's and from the plain
    version's."""
    outs, ties = [], []
    for i in range(frames.shape[0]):
        args = (frames[i], dets[i], valid[i], cfg)
        _, plain, _, _ = with_plain_search(lambda: step_cost(bank, *args))
        _, f64, cost, feasible = step_cost(bank, *args, float64=True)
        bank, out, _, _ = step_cost(bank, *args)
        outs.append(out)
        m_k8, m_plain, m_f64 = (x.matched_det.cpu().numpy()
                                for x in (out, plain, f64))
        if not np.array_equal(m_k8, m_plain):
            best = assignment.scipy_assign(cost, feasible)
            score = {name: (int((m >= 0).sum()),
                            assignment.assignment_cost(cost, m))
                     for name, m in (("K8", m_k8), ("plain", m_plain),
                                     ("float64", m_f64), ("best", best))}
            ties.append(dict(frame=i, slots=int((m_k8 != m_plain).sum()),
                             **score,
                             f64_vs_k8=int((m_f64 != m_k8).sum()),
                             f64_vs_plain=int((m_f64 != m_plain).sum())))
    return step_mod.StepOutput(*[torch.stack(x) for x in zip(*outs)]), ties


def is_tie(t: dict) -> bool:
    """Whether a `step_ties` witness shows a tie (E2E_TIE_EPS)."""
    return (t["K8"][0] == t["plain"][0]
            and abs(t["K8"][1] - t["plain"][1]) <= E2E_TIE_EPS * t["slots"])


def bank_lockstep(frames, boxes0, kcfg, train_site):
    """Step the bank frame by frame with K1 and, from the same state, with
    K1's plain version: each frame's boxes [N, T, 4] both ways.  The state
    that goes on is K1's, so a difference is one frame's, not a drift."""
    bank = kcf_bank.init_bank(
        patch_ops.to_gray(frames[0]), boxes0,
        torch.ones((boxes0.shape[0],), dtype=torch.bool,
                   device=boxes0.device), kcfg)
    kernel_boxes, plain_boxes = [], []
    for f in range(frames.shape[0]):
        gray = patch_ops.to_gray(frames[f])
        plain_bank, _ = with_plain_k1(
            lambda: kcf_bank.step(bank, gray, kcfg, train_site))
        bank, _ = kcf_bank.step(bank, gray, kcfg, train_site)
        kernel_boxes.append(bank.boxes)
        plain_boxes.append(plain_bank.boxes)
    return torch.stack(kernel_boxes), torch.stack(plain_boxes)


def phase_kcf_bank(dev, frames, gt_boxes):
    """A bank of the bench fixture's first-frame boxes tracked by
    correlation alone, with K1 and with its plain version in its place.

    Held to BANK_TOL is the lockstep run: both versions step from the same
    bank on every frame.  A slot-frame may exceed it where two neighbouring
    pixels of the response (or two scales) tie within the patches' last
    bit and the peak falls on the other one: such a step differs by less
    than one response pixel of that slot's window, and at most
    BANK_TIES of the slot-frames may do so (at full size one in 8192 did,
    in two of the three configurations).  Two free runs are printed and
    not held to it: a correlation tracker feeds its box back into its next
    window, and on a slot that has lost its object a last-bit difference
    in a patch grows several-fold a frame (on the CPU, plain version
    against `four_tap_mirror`, 1e-3 px at frame 8 became 1.4 px at frame
    13)."""
    boxes0 = torch.as_tensor(gt_boxes[0], device=dev)
    n = frames.shape[0]
    for name, (kw, site) in KCF_BANK.items():
        kcfg = KCFConfig(**kw)
        boxes, peaks, counts, wall = bank_run(frames, boxes0, kcfg, site)
        free_boxes, _, plain_counts, _ = with_plain_k1(
            lambda: bank_run(frames, boxes0, kcfg, site))
        step_boxes, step_plain = bank_lockstep(frames, boxes0, kcfg, site)
        want = {k: 0 for k in KERNELS}
        want["roi_extract"] = 1 + n * (2 if site == "refined" else 1)
        want["kcf_search"] = n if kcfg.feature_type == "gray" else 0
        again = torch.equal(step_boxes, boxes)
        step_diff = (step_boxes - step_plain).abs().amax(dim=-1)  # [N, T]
        ties = step_diff > BANK_TOL
        n_ties = int(ties.sum().item())
        diff = step_diff[~ties].max().item()
        # one response pixel of each slot's search window, in frame pixels
        cell = (torch.maximum(step_boxes[..., 2:], step_plain[..., 2:])
                .amax(dim=-1) * kcfg.padding / kcfg.feature_size)
        tie_txt = "; ".join(
            f"frame {f} slot {t}: {step_diff[f, t].item():.3g} px of a "
            f"response pixel of {cell[f, t].item():.3g} px"
            for f, t in ties.nonzero().tolist()[:4]) or "none"
        free = (boxes - free_boxes).abs().amax(dim=-1)          # [N, T]
        iou = box_iou(boxes.cpu().numpy(), gt_boxes[:n])
        on = torch.as_tensor(iou >= 0.5, device=dev)
        ref = KCF_BANK_IOU_REF[name]
        ok = (tuple(boxes.shape) == (n, N_OBJ, 4)
              and torch.isfinite(boxes).all().item()
              and torch.isfinite(peaks).all().item())
        log("kcf-bank", f"{name}: {N_OBJ} boxes over {n} frames in "
                        f"{wall:.3f} s ({1000 * wall / n:.2f} ms a frame, "
                        f"first run); kernel launches {counts}; mean IoU "
                        f"with the ground truth {iou.mean():.4f} (JAX "
                        f"reference {ref}), last frame "
                        f"{iou[-1].mean():.4f}; largest box difference from "
                        f"K1's plain version stepping from the same bank "
                        f"{diff:.3g} px, but for {n_ties} of {ties.numel()} "
                        f"slot-frames where the peak fell on a tied "
                        f"neighbour ({tie_txt}); second run with K1 "
                        f"bit-equal: {again}; free-running, "
                        f"{free.max().item():.3g} px "
                        f"({free[on].max().item():.3g} px on the "
                        f"{100 * on.float().mean().item():.1f}% of "
                        "slot-frames with IoU >= 0.5)")
        if counts != want or plain_counts != dict(want, roi_extract=0):
            raise AssertionError(f"kcf-bank {name}: launches {counts} "
                                 f"(expected {want}); with the plain version "
                                 f"{plain_counts}")
        ties_ok = (n_ties <= BANK_TIES * ties.numel()
                   and (step_diff[ties] < cell[ties]).all().item())
        if not (ok and again and ties_ok and iou.mean() >= ref - 0.02):
            raise AssertionError(
                f"kcf-bank {name}: finite {ok}, second run bit-equal "
                f"{again}, {n_ties} slot-frames over {BANK_TOL} px ({tie_txt}"
                f"; at most {BANK_TIES:g} of {ties.numel()}, each under its "
                f"response pixel), mean IoU {iou.mean()} (JAX reference "
                f"{ref} - 0.02)")


# ---- multi-stream serving (BASELINE.json configs[4] on one card) ---------

# K1 and K3 against their plain versions in the serving runs: the 4-tap sum
# against the hat matmuls, three float32 roundings apart at most (PR 6's
# detector run: 1.79e-7).
SERVE_ROI_TOL = 1.8e-7
SERVE_REPS = 7          # interleaved samples of each serving time
SERVE_WINDOW = 8        # frames a timed sample tracks


def stream_bank(banks, s: int) -> bank_mod.TrackBank:
    """Stream s's bank of a stacked bank."""
    return bank_mod.map_bank(lambda x: x[s], banks)


def serve_lockstep(banks, frames, d, v, cfg, n_frames: int):
    """Gate 1: on every frame, multi_stream_step from the stacked banks
    against the S single-stream steps from the same per-stream banks (the
    stacked banks go on).  Returns the largest box difference, whether every
    field was bit-equal, and the number of slot-frames compared."""
    n_str = frames.shape[0]
    worst, bit_equal, bad = 0.0, True, []
    for f in range(n_frames):
        singles = [stream_bank(banks, s) for s in range(n_str)]
        banks, out = serve.multi_stream_step(banks, frames[:, f], d[:, f],
                                             v[:, f], cfg)
        for s in range(n_str):
            one_bank, one = step_mod.step(singles[s], frames[s, f], d[s, f],
                                          v[s, f], cfg)
            same = all(torch.equal(getattr(out, k)[s], getattr(one, k))
                       for k in ("ids", "valid", "matched_det",
                                 "assign_iters")) and torch.equal(
                banks.state[s], one_bank.state)
            diff = float((out.boxes[s] - one.boxes).abs().max())
            worst = max(worst, diff)
            bit_equal &= same and torch.equal(out.boxes[s], one.boxes)
            if not same or diff > 1e-4:
                bad.append((f, s, same, diff))
    if bad:
        raise AssertionError(f"serve: stream step against single steps: "
                             f"(frame, stream, fields equal, box diff) "
                             f"{bad[:8]}")
    return worst, bit_equal, n_frames * n_str * cfg.max_tracks


def serve_dump_check(out, dump, gt, vis):
    """Gate 2: the free run against JAX's dump: ids and valid on every
    frame, boxes within 0.05 px, each stream's MOTA equal to the dump's."""
    n_str, n = out.ids.shape[:2]
    ids, valid, boxes = triple(out)
    lines, motas = [], []
    for s in range(n_str):
        ok, txt = compare_tracks((ids[s], valid[s], boxes[s]),
                                 (dump["ids"][s], dump["valid"][s],
                                  dump["boxes"][s]))
        hyp = [(ids[s, f][valid[s, f]], boxes[s, f][valid[s, f]])
               for f in range(n)]
        g = [(np.where(vis[s, f])[0], gt[s, f][np.where(vis[s, f])[0]])
             for f in range(n)]
        mota = metrics.clear_mot(g, hyp)["mota"]
        motas.append(mota)
        if not (ok and mota == dump["mota"][s]):
            raise AssertionError(f"serve: stream {s} against the JAX dump: "
                                 f"{txt}; MOTA {mota} (dump "
                                 f"{dump['mota'][s]})")
        lines.append(txt)
    both = valid & dump["valid"]
    return (float(np.abs(boxes - dump["boxes"]).max(axis=-1)[both].max()),
            bool(np.array_equal(boxes[both], dump["boxes"][both])), motas)


def serve_detect(model, frames, impl: str = "greedy"):
    """configs[4]'s detector call (tools/bench_configs4.py): NMS (greedy or
    fast) into SERVE_DETS slots."""
    return detector.detect_batch(model, frames, (HEIGHT, WIDTH), SERVE_DETS,
                                 E2E_IOU, E2E_SCORE, nms_impl=impl)


def serve_detector(dev, frames_tm, card):
    """Gate 4 and the fused detect -> track times: tools/bench_configs4.py's
    detector over the S streams' frames (time-major [N, S, H, W])."""
    n, n_str = frames_tm.shape[:2]
    spec = YoloSpec("yolov3-tiny", num_classes=80)
    det = detector.YoloDetector.random_init(spec, seed=0, device=dev,
                                            max_out=SERVE_DETS,
                                            iou_thr=E2E_IOU,
                                            score_thr=E2E_SCORE)
    model = det.model
    m16 = detector.YoloDetector(dataclasses.replace(spec, dtype="bfloat16"),
                                model.state_dict(), device=dev).model
    cfg = TrackerConfig(max_tracks=128, max_detections=SERVE_DETS,
                        frame_height=HEIGHT, frame_width=WIDTH)

    detect_fn = serve_detect

    def fast_fn(m, fr):
        return serve_detect(m, fr, "fast")

    banks0 = serve.make_stream_banks(n_str, cfg, device=dev)
    # the fused step: the shared and data-parallel forms are one forward;
    # the shared form counted, with every kernel call held against its plain
    # version (K7 word for word)
    dp = serve.detect_then_track_step(model, banks0, frames_tm[0], cfg,
                                      detect_fn)
    torch.cuda.synchronize()
    reset_counts()
    with kernels_checked() as st:
        shared = serve.detect_then_track_step_shared(
            model, banks0, frames_tm[0], cfg, detect_fn)
    torch.cuda.synchronize()
    counts, errs = read_counts(), st.by_kernel()
    want = dict(dict.fromkeys(KERNELS, 0), roi_extract=1, auction_solve=1,
                kcf_train_shift=1, kcf_search=1, epilogue=bn_blocks(spec))
    limits = {"roi_extract": SERVE_ROI_TOL, "auction_solve": 0,
              "kcf_train_shift": K6_TOL["alphaf"],
              "kcf_search": K8_TOL["response"], "epilogue": 0}
    log("serve", f"detector cell: the fused shared step over {n_str} "
                 f"streams' frames: launches {counts}; every call against "
                 f"its plain version (kernel: calls, largest error) "
                 f"{ {k: (len(e), max(e)) for k, e in errs.items()} }")
    if not (counts == want and set(errs) == set(limits)
            and len(errs["epilogue"]) == want["epilogue"]
            and all(max(e) <= limits[k] for k, e in errs.items())):
        raise AssertionError(f"serve: fused shared step launches {counts} "
                             f"(expected {want}), errors {errs}")
    same_fused = all(torch.equal(x, y) for x, y in zip(
        [*dp[1], *bank_leaves(dp[0])], [*shared[1], *bank_leaves(shared[0])]))
    # strided-4 against multi_stream_sequence fed each head frame's
    # detections, class-blind and class-aware; K2's batches captured
    solve, seen_b = auction_k.auction_solve, []

    def capture(b, eps, max_iters):
        seen_b.append(b.clone())
        return solve(b, eps, max_iters)

    heads = {}
    for i in range(0, n, SERVE_STRIDE):
        heads[i] = detect_fn(model, frames_tm[i])
    strided = {}
    for class_aware in (False, True):
        c = cfg.replace(class_aware=class_aware)
        width = 6 if class_aware else 5
        dd = torch.zeros((n_str, n, SERVE_DETS, width), device=dev)
        vv = torch.zeros((n_str, n, SERVE_DETS), dtype=torch.bool,
                         device=dev)
        for i, (hd, hv, hc) in heads.items():
            dd[:, i] = (detector.dets_with_classes(hd, hc) if class_aware
                        else hd)
            vv[:, i] = hv
        auction_k.auction_solve = capture
        try:
            _, ref = serve.multi_stream_sequence(
                serve.make_stream_banks(n_str, c, device=dev),
                frames_tm.transpose(0, 1), dd, vv, c)
        finally:
            auction_k.auction_solve = solve
        _, st = serve.multi_stream_sequence_strided(
            model, serve.make_stream_banks(n_str, c, device=dev), frames_tm,
            c, detect_fn, SERVE_STRIDE)
        strided[class_aware] = triple(st)
        equal = all(torch.equal(getattr(st, k), getattr(ref, k))
                    for k in ("ids", "valid", "boxes", "cls"))
        alive = st.ids >= 0
        log("serve", f"detector cell, class_aware={class_aware}: "
                     f"multi_stream_sequence_strided (stride {SERVE_STRIDE},"
                     f" N={n}, one forward over {n_str} frames a head) equal "
                     "to multi_stream_sequence fed those detections (ids, "
                     f"valid, boxes, classes): {equal}; "
                     f"{int(alive.sum())} live and {int(st.valid.sum())} "
                     f"confirmed slot-frames (a tentative track dies "
                     f"unmatched for over {c.max_age_tentative} frames, "
                     f"before the next head frame), classes tracked "
                     f"{sorted(set(st.cls[alive].tolist()))}")
        if not (equal and alive.any()):
            raise AssertionError(f"serve: strided serving (class_aware="
                                 f"{class_aware}) differs from the "
                                 "explicit detections, or tracks nothing")
    # the batched forward against B = 1 forwards of each stream
    hd, hv, _ = heads[0]
    log("serve", f"detector cell: valid detections per stream on frame 0 "
                 f"{hv.sum(1).tolist()} (of {SERVE_DETS})")
    one = [detect_fn(model, frames_tm[0, s:s + 1]) for s in range(n_str)]
    od = torch.cat([o[0] for o in one])
    ov = torch.cat([o[1] for o in one])
    both = hv & ov
    diff = float((hd - od).abs()[both].max())
    n_diff = int(((hd - od).abs().amax(dim=-1) > 0)[both].sum())
    log("serve", f"detector cell: the forward over {n_str} streams' frames "
                 f"against {n_str} B = 1 forwards: valid equal "
                 f"{torch.equal(hv, ov)}, detections differing "
                 f"{n_diff} of {int(both.sum())}, largest difference "
                 f"{diff:.3g} (px or score; limit {E2E_PRE_BOX_TOL:g}); "
                 f"the fused step's shared and data-parallel forms equal: "
                 f"{same_fused}")
    if not (torch.equal(hv, ov) and diff <= E2E_PRE_BOX_TOL and same_fused):
        raise AssertionError(f"serve: batched forward {diff} from B = 1, "
                             f"shared == DP {same_fused}")

    # times: f32 greedy, bf16 + fast NMS, strided-4 (bf16 + fast NMS), in
    # turns over SERVE_WINDOW frames
    w = SERVE_WINDOW

    def fused(m, fn):
        def run():
            b = serve.make_stream_banks(n_str, cfg, device=dev)
            for i in range(w):
                b, _ = serve.detect_then_track_step_shared(
                    m, b, frames_tm[i], cfg, fn)
        return run

    runs = {"fused f32 greedy": fused(model, detect_fn),
            "fused bf16 + fast NMS": fused(m16, fast_fn),
            f"strided-{SERVE_STRIDE} bf16 + fast NMS":
                lambda: serve.multi_stream_sequence_strided(
                    m16, serve.make_stream_banks(n_str, cfg, device=dev),
                    frames_tm[:w], cfg, fast_fn, SERVE_STRIDE)}
    times = interleaved(runs, SERVE_REPS)
    for name, secs in times.items():
        log("serve", f"times {name}, S={n_str}: " + rate_line(
            secs, w, n_str) + f" ({card})")
    return seen_b[-1], dict(detect=tuple(x.cpu() for x in heads[0]),
                            fused=triple(shared[1]), strided=strided[False])


def bank_leaves(bank) -> list:
    return [x for v in bank for x in (v if isinstance(v, kcf_ops.KCFModel)
                                      else (v,))]


def interleaved(runs: dict, reps: int) -> dict:
    """Seconds of each run over `reps` rounds, the runs in turns within a
    round (one warm call each first)."""
    for fn in runs.values():
        fn()
    torch.cuda.synchronize()
    out = {k: [] for k in runs}
    for _ in range(reps):
        for k, fn in runs.items():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out[k].append(time.perf_counter() - t0)
    return out


def rate_line(secs: list, n_frames: int, n_str: int) -> str:
    med = statistics.median(secs)
    return (f"{n_str * n_frames / med:.1f} stream-frames/s aggregate, "
            f"{1000 * med / n_frames:.3f} ms a multi-stream frame (median of "
            f"{len(secs)}; samples {min(secs):.4f}-{max(secs):.4f} s per "
            f"{n_frames} frames, spread {max(secs) / min(secs):.2f}x)")


def phase_serve(dev, card, default_out):
    """configs[4] on one card: 8 streams x 1080p through the stream step
    (see SERVE_DUMP); gates 1-5 and the serving rates.  Returns what
    serve_kernel_times and serve_profile take."""
    t_phase = time.perf_counter()
    frames_np, d_np, v_np, gt, vis, cfg = serve_fixture()
    frames = torch.as_tensor(frames_np, device=dev)
    del frames_np
    d = torch.as_tensor(d_np, device=dev)
    v = torch.as_tensor(v_np, device=dev)
    n_str, n = frames.shape[:2]
    dump = np.load(SERVE_DUMP)
    log("serve", f"fixture: {n_str} streams x {n} frames of {HEIGHT}x{WIDTH}"
                 f" u8 ({frames.numel() / 1e6:.0f} MB on the card), "
                 f"{cfg.max_tracks} tracks and {cfg.max_detections} "
                 "detections a stream; rendered and uploaded in "
                 f"{time.perf_counter() - t_phase:.1f} s")
    banks0 = serve.make_stream_banks(n_str, cfg, device=dev)
    hf = heavy_config(cfg, "HF")

    # the main paths: default over 8 x 32, HF over 8 x 8, counted
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    launches = {}
    for name, c, nf in (("default", cfg, n), ("HF", hf, SERVE_WINDOW)):
        reset_counts()
        t0 = time.perf_counter()
        _, o = serve.multi_stream_sequence(
            serve.make_stream_banks(n_str, c, device=dev), frames[:, :nf],
            d[:, :nf], v[:, :nf], c)
        torch.cuda.synchronize()
        launches[name] = read_counts()
        want = {k: 0 for k in KERNELS}
        want.update(roi_extract=nf, auction_solve=nf)
        if name == "HF":
            want.update(roi_extract_scales=nf, kcf_detect=nf, kcf_train=nf)
        else:
            want.update(kcf_train_shift=nf, kcf_search=nf)
        log("serve", f"{name}: multi_stream_sequence {n_str} streams x {nf} "
                     f"frames in {time.perf_counter() - t0:.3f} s (first "
                     f"run); kernel launches {launches[name]} (one set a "
                     "multi-stream frame)")
        if launches[name] != want:
            raise AssertionError(f"serve {name}: launches {launches[name]}, "
                                 f"expected {want}")
        if name == "default":
            out = o
            peak = torch.cuda.max_memory_allocated()
    check = out.boxes.cpu().numpy()
    if check.shape != (n_str, n, cfg.max_tracks, 4) or not np.isfinite(
            check).all():
        raise AssertionError(f"serve: bad output boxes {check.shape}")
    log("serve", f"peak device memory of the default run "
                 f"{peak / 2**20:.1f} MiB ({(peak - mem0) / 2**20:.1f} MiB "
                 f"over the {mem0 / 2**20:.1f} MiB held before it: the "
                 "frames, the earlier phases' tensors)")

    # gate 2: the JAX dump, and stream 0 against the default cell
    box_diff, box_equal, motas = serve_dump_check(out, dump, gt, vis)
    log("serve", f"against the JAX run's dump ({SERVE_DUMP.name}): ids and "
                 f"valid equal on {n_str} x {n} frames, largest box "
                 f"difference {box_diff:.3g} px (bit-equal: {box_equal}); "
                 f"MOTA per stream {motas} equal to the dump's")
    stream0 = tuple(x[0] for x in triple(out))
    txt = same_tracks(stream0, tuple(x[:n] for x in triple(default_out)),
                      "serve stream 0 vs the default cell")
    log("serve", f"stream 0 against the default cell's first {n} frames: "
                 f"{txt}; bit-equal: "
                 f"{torch.equal(out.boxes[0], default_out.boxes[:n])}")

    # gate 1: the stream step against single steps, in lockstep
    for name, c, nf in (("default", cfg, n), ("HF", hf, SERVE_WINDOW)):
        worst, bit, count = serve_lockstep(
            serve.make_stream_banks(n_str, c, device=dev), frames, d, v, c,
            nf)
        log("serve", f"{name}: multi_stream_step against {n_str} single "
                     f"steps from the same banks on {nf} frames: ids, valid, "
                     f"state, matched_det, assign_iters equal; largest box "
                     f"difference {worst:.3g} px over {count} slot-frames "
                     f"(limit 1e-4); bit-equal: {bit}")
        # Every kernel of the default step computes a row from that row
        # alone, K6 included: the stream step is the single steps, bit for
        # bit.
        if name == "default" and not bit:
            raise AssertionError("serve: the default stream step is not "
                                 "bit-equal to the single steps")

    # gate 3: every kernel call of the serving runs against its plain
    # version; K2 on odd n
    limits = {"roi_extract": SERVE_ROI_TOL,
              "roi_extract_scales": SERVE_ROI_TOL, "auction_solve": 0,
              "kcf_detect": KCF_TOL["response"],
              "kcf_train": KCF_TOL["alphaf"],
              "kcf_train_shift": K6_TOL["alphaf"],
              "kcf_search": K8_TOL["response"]}
    _, errs, _, seen = checked_run(serve.multi_stream_sequence, banks0,
                                   frames, d, v, cfg)
    _, errs_hf, _, seen_hf = checked_run(
        serve.multi_stream_sequence,
        serve.make_stream_banks(n_str, hf, device=dev),
        frames[:, :SERVE_WINDOW], d[:, :SERVE_WINDOW], v[:, :SERVE_WINDOW],
        hf)
    for k, e in {**errs, **{"HF " + k: x for k, x in
                             errs_hf.items()}}.items():
        limit = limits[k.split()[-1]]
        log("serve", f"checked serving run, {k}: {len(e)} calls, largest "
                     f"error {max(e):.3g} (limit {limit:g}; K1/K3: "
                     "|kernel - plain|, inf where not bit-equal to "
                     "the 4-tap mirror; K2: 0 = col_of and iters equal to "
                     "the plain version and to a launch per problem; "
                     "K4-K6: relative to the largest magnitude)")
        if not max(e) <= limit:
            raise AssertionError(f"serve: {k} against its plain version on "
                                 f"the serving run: errors {e}")
    errs = {k: max(e) for k, e in errs.items()}
    errs_hf = {k: max(e) for k, e in errs_hf.items()}
    rng = np.random.default_rng(5)
    for nn in (5, 161):
        cost = torch.as_tensor(rng.uniform(0, 1, (n_str, nn, nn)).astype(
            np.float32), device=dev)
        feas = torch.as_tensor(rng.random((n_str, nn, nn)) < 0.8,
                               device=dev)
        b = assignment.build_benefits(cost, feas, EPS)
        col, it = auction_k.auction_solve(b, EPS, 2000)
        want_col, want_it = auction_k.auction_solve_ref(b, EPS, 2000)
        one = [auction_k.auction_solve(b[p].contiguous(), EPS, 2000)
               for p in range(n_str)]
        same = (torch.equal(col, want_col) and torch.equal(it, want_it)
                and all(torch.equal(col[p], c) and torch.equal(it[p], i)
                        for p, (c, i) in enumerate(one)))
        log("serve", f"K2 batch [{n_str}, {nn}, {nn}] (odd n: every problem "
                     f"staged by scalar loads): col_of and iters equal to the"
                     f" plain version and to {n_str} single launches: {same};"
                     f" rounds {it.tolist()}")
        if not same:
            raise AssertionError(f"serve: K2 batch n={nn} differs")

    # gate 4: detector serving
    frames_tm = frames.transpose(0, 1)
    det_b, det_refs = serve_detector(dev, frames_tm, card)

    # gate 5: the supervisor on stream 0
    sup = StreamSupervisor(cfg)
    for f in range(n):
        sup.step(frames[0, f], d[0, f], v[0, f])
    clean = sup.failures
    kf = sup.bank.kf_mean.clone()
    kf[:, 0] = float("nan")
    sup.bank = sup.bank._replace(kf_mean=kf)
    rec = sup.step(frames[0, n - 1], d[0, n - 1], v[0, n - 1])
    log("serve", f"StreamSupervisor on stream 0 ({sup.device}): failures "
                 f"{clean} over {n} frames; after the bank was poisoned with "
                 f"NaN: failures {sup.failures}, boxes finite "
                 f"{bool(torch.isfinite(rec.boxes).all())}")
    if not (clean == 0 and sup.failures == 1
            and torch.isfinite(rec.boxes).all()):
        raise AssertionError(f"serve: supervisor failures {clean} then "
                             f"{sup.failures}")

    # numbers: aggregate stream-frames/s at S = 1, 2, 4, 8 against eight
    # run_sequence calls, from the banks after frame 16 over frames 16-23
    w = SERVE_WINDOW
    banks16, _ = serve.multi_stream_sequence(banks0, frames[:, :16],
                                             d[:, :16], v[:, :16], cfg)
    win = slice(16, 16 + w)

    def streams(k):
        b = bank_mod.map_bank(lambda x: x[:k].contiguous(), banks16)
        return lambda: serve.multi_stream_sequence(
            b, frames[:k, win], d[:k, win], v[:k, win], cfg)

    singles = [stream_bank(banks16, s) for s in range(n_str)]
    runs = {f"S={k}": streams(k)
            for k in [k for k in (1, 2, 4) if k < n_str] + [n_str]}
    runs[f"{n_str} x run_sequence"] = lambda: [scan.run_sequence(
        singles[s], frames[s, win], d[s, win], v[s, win], cfg)
        for s in range(n_str)]
    times = interleaved(runs, SERVE_REPS)
    for name, secs in times.items():
        k = n_str if name.endswith("run_sequence") else int(name[2:])
        log("serve", f"times default {name}: " + rate_line(secs, w, k)
            + f" ({card})")
    log("serve", f"phase took {time.perf_counter() - t_phase:.1f} s")
    # the kernels' serving times and the profile come later in the script:
    # after a long profiler session the profiler loses device records
    w = slice(0, SERVE_WINDOW)
    return dict(sched_check=(frames[:, w], d[:, w], v[:, w], cfg,
                             out.ids[:, w], out.valid[:, w], out.boxes[:, w]),
                dist_refs=dict(tracker=triple(out), gt=gt, vis=vis,
                               dump=dump, **det_refs),
                seen=seen, seen_hf=seen_hf, det_b=det_b, errs=errs,
                errs_hf=errs_hf, launches=launches,
                windows={k: streams(k) for k in (1, n_str)})


def serve_profile(windows: dict) -> None:
    """Launches a multi-stream frame and the device's busy share, default,
    at S = 1 and S = 8 over SERVE_WINDOW frames."""
    w = SERVE_WINDOW
    for k, run in windows.items():
        kernels, wall_us, _ = profiled(run)
        busy = sum(r[1] for r in kernels)
        log("serve", f"profile default S={k}, {w} frames: "
                     f"{sum(r[2] for r in kernels) / w:.1f} kernel launches "
                     f"a multi-stream frame; device {busy / 1e3:.3f} ms of "
                     f"{wall_us / 1e3:.3f} ms wall under the profiler "
                     f"({100 * busy / wall_us:.1f}% busy)")
        for key, us, count in kernels[:6]:
            log("serve", f"  {us / 1e3:9.3f} ms  x{count:<6d} {key[:90]}")


def serve_kernel_times(seen, seen_hf, det_b, errs, errs_hf, launches):
    """Each kernel at its serving shape against its plain version (event
    times in turns, profiler device times) and its bound; the rows of the
    kernels line."""
    levels, hw, *c1 = seen["roi_extract"]
    lv3, hw3, *c3 = seen_hf["roi_extract_scales"]
    b = seen["auction_solve"]
    d_model, d_feat, sigma = seen_hf["kcf_detect"]
    t_model, t_feat, yf, t_sigma, lam, lr = seen_hf["kcf_train"]
    rows1 = c1[3].shape[0]
    k3, rows3, s3 = c3[3].shape
    frame3 = roi_k._row_frames(lv3, rows3, c3[3].device)
    rounds = auction_k.auction_solve(b, EPS, 2000)[1]
    ni, c, s, _ = d_feat.shape
    sf = s // 2 + 1
    nt = t_model.xf.shape[0]
    bounds = {
        "roi_extract": roi_bound(levels, c1),
        "roi_extract_scales": bound(
            k3 * rows3 * s3 * s3 * 4 + rows3 * 3 * 4 + k3 * rows3 * 2 * s3 * 4
            + touched_pixels(c3[0].repeat(k3), c3[3].reshape(-1, s3),
                             c3[4].reshape(-1, s3), frame3.repeat(k3)),
            10 * k3 * rows3 * s3 * s3),
        "auction_solve": auction_bound(b, rounds),
        "kcf_detect": bound(
            ni * c * s * s * 4 + nt * (c + 1) * s * sf * 8 + ni * s * s * 4,
            ni * (c * fft_flops(s) + 8 * c * s * sf + 3 * fft_flops(s)
                  + 10 * s * s + 6 * s * sf)),
        "kcf_train": bound(
            nt * c * s * s * 4 + 2 * nt * (c + 1) * s * sf * 8
            + s * sf * 8 + nt * 4,
            nt * (c * fft_flops(s) + 8 * c * s * sf + 2 * fft_flops(s)
                  + 10 * s * s + 16 * s * sf)),
    }
    pairs = {
        "roi_extract": (f"K1 {rows1} rows of {roi_k.n_frames(levels)} u8 "
                        "1080p frames",
                        lambda: roi_k._resample_ref(levels, hw, *c1),
                        lambda: roi_k._resample_cuda(levels, hw, *c1), 50),
        "roi_extract_scales": (
            f"K3 {rows3} rows x {k3} scales of {roi_k.n_frames(lv3)} frames",
            lambda: roi_k._resample_scales_ref(lv3, hw3, *c3),
            lambda: roi_k._resample_scales_cuda(lv3, hw3, *c3), 50),
        "auction_solve": (
            f"K2 batch {list(b.shape)} (rounds {rounds.tolist()})",
            lambda: auction_k.auction_solve_ref(b, EPS, 2000),
            lambda: auction_k.auction_solve(b, EPS, 2000), K2_REPS),
        "kcf_detect": (
            f"K4 feat {tuple(d_feat.shape)} on {nt} model rows",
            lambda: kcf_k.detect_fused_ref(d_model, d_feat, sigma),
            lambda: kcf_k.detect_fused(d_model, d_feat, sigma), 50),
        "kcf_train": (
            f"K5 feat {tuple(t_feat.shape)}",
            lambda: kcf_k.train_fused_ref(t_model, t_feat, yf, t_sigma, lam,
                                          lr),
            lambda: kcf_k.train_fused(t_model, t_feat, yf, t_sigma, lam, lr),
            50),
    }
    src = {"roi_extract": ("roi.cu", "roi.py:465"),
           "roi_extract_scales": ("roi.cu", "roi.py:346"),
           "auction_solve": ("auction.cu", "auction.py:107"),
           "kcf_detect": ("kcf.cu", "kcf.py:260"),
           "kcf_train": ("kcf.cu", "kcf.py:295")}
    err_of = {**errs_hf, **errs}
    rows = []
    for key, (what, plain, kernel, reps) in pairs.items():
        ms, plain_ms = in_turns(plain, kernel, reps)
        dev_ms, plain_dev_ms = device_ms(kernel, reps), device_ms(plain, reps)
        b_ms, b_by = bounds[key]
        log("times", f"serving {what}: per call (CUDA event pairs) kernel "
                     f"{ms:.4f} ms, plain {plain_ms:.4f} ms; device time per "
                     f"call (profiler) kernel {dev_ms:.4f} ms, plain "
                     f"{plain_dev_ms:.4f} ms; bound {b_ms:.5f} ms ({b_by})")
        path = "default" if key in ("roi_extract", "auction_solve") else "HF"
        rows.append({
            "name": f"{key}_serve", "route": "cuda",
            "source": f"tpu_mot_torch/csrc/{src[key][0]}",
            "replaces": f"tpu_mot/kernels/{src[key][1]}",
            "launches": launches[path][key], "max_abs_err": err_of[key],
            "ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms,
            "plain_device_ms": plain_dev_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "shape": what, "launches_of": f"serve {path}"})
    nb, nn = det_b.shape[:2]
    det_rounds = auction_k.auction_solve(det_b, EPS, 2000)[1]
    det_ms = device_ms(lambda: auction_k.auction_solve(det_b, EPS, 2000),
                       K2_REPS)
    log("times", f"serving K2 batch [{nb}, {nn}, {nn}] of the detector cell "
                 f"(rounds {det_rounds.tolist()}): device time per call "
                 f"(profiler) {det_ms:.4f} ms")
    return rows


# The multi-device contract (parallel/mesh.py) at configs[4]'s size: the 8
# serving streams sharded over ranks, one process each, in the NCCL world
# (one rank a card: min(cards, 4)) and in DIST_GLOO_WORLDS gloo ranks that
# share cuda:0.  Each rank renders its own streams (stream s at seed s);
# the gathered outputs must equal the serve phase's one-process outputs:
# bit for bit at world 1, ids and valid equal and boxes within
# DIST_BOX_TOL px at more ranks.  The data-parallel train step (yolov3-tiny
# at 416 from TRAIN_SPEC's seed-0 weights; a global batch of
# DIST_TRAIN_BATCH distinct bench scenes, scene s at seed s, each rank
# rendering its block; plain SGD at DIST_LR, so that a step's update is the
# summed gradient itself) runs at DIST_TRAIN_WORLDS against the
# one-process step on the whole batch, within DIST_LIMITS (dp_errors):
# step 0's and step 1's losses (relative), the running statistics after
# step 0 (absolute), the parameters after step 0 (each tensor's distance to
# the one-process parameters over the one-process update, the worst
# tensor); and every rank bit-identical after TRAIN_STEPS steps.  At world
# 2 the step runs again with each fault of DIST_FAULTS put in for the run,
# and each must fail those checks.  The parameter and step-1 limits leave
# room for float32: flax's variance E[y^2] - E[y]^2 over a different
# summation order moves the first blocks' updates by ~1e-3 of themselves,
# and one step carries that into step 1's loss; the faults move the
# updates by 0.5 and more and step 1's loss by percents.
DIST_GLOO_WORLDS = (2, 4)
DIST_TRAIN_WORLDS = (1, 2)
DIST_TRAIN_BATCH = 32
DIST_REPS = 5
DIST_LR = 1e-3
DIST_BOX_TOL = 1e-4
DIST_LIMITS = dict(loss0=1e-5, stats=1e-5, params=5e-2, loss1=1e-3)


def state_digest(model) -> str:
    """SHA-256 of the state dict's bytes: equal digests, bit-equal states."""
    h = hashlib.sha256()
    for v in model.state_dict().values():
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def dist_batch(dev, spec, first: int = 0, n: int = DIST_TRAIN_BATCH):
    """Bench scenes first..first + n - 1 (train_scenes) as the net's input
    on dev, and their targets: the data-parallel step's global batch, or
    with first and n a rank's block of it."""
    frames, boxes, classes, vis = train_scenes(n, spec.input_size, first)
    return (train_images(frames, spec.input_size, dev),
            [torch.as_tensor(t, device=dev)
             for t in train.build_targets(spec, boxes, classes, vis)])


# the library's gradient sum, kept while a fault stands in for it
SUM_GRADIENTS = train._sum_gradients


def averaged_gradients(model, mesh) -> None:
    """DDP's average in place of the sum."""
    SUM_GRADIENTS(model, mesh)
    for p in model.parameters():
        p.grad.div_(mesh.size())


# Faults the data-parallel checks must catch: the train module's function
# that each replaces for a run, and the stand-in.
DIST_FAULTS = {
    "per-rank statistics": ("batch_stats_over",
                            lambda model, mesh, n: contextlib.nullcontext()),
    "no gradient sum": ("_sum_gradients", lambda model, mesh: None),
    "averaged gradients": ("_sum_gradients", averaged_gradients),
}


@contextlib.contextmanager
def dp_fault(name: str):
    """The fault `name` of DIST_FAULTS put into the train module for the
    block."""
    attr, fake = DIST_FAULTS[name]
    real = getattr(train, attr)
    setattr(train, attr, fake)
    try:
        yield
    finally:
        setattr(train, attr, real)


def dp_run(spec, dev, x, t, mesh=None) -> tuple[dict, object, object]:
    """TRAIN_STEPS steps of SGD(DIST_LR) from the seed-0 weights on the
    batch (x, t), over a "batch" mesh a rank's block of it: the losses, the
    state dict after step 0 and the digest after the last step; with the
    state and the step."""
    state = train_state(spec, dev, mesh=mesh,
                        make_optimizer=lambda p: torch.optim.SGD(p, DIST_LR))
    step = train.make_train_step(spec, mesh)
    losses = []
    for i in range(TRAIN_STEPS):
        state, loss = step(state, x, t)
        losses.append(float(loss))
        if i == 0:
            after0 = {k: v.to("cpu", copy=True)
                      for k, v in state.model.state_dict().items()
                      if "num_batches" not in k}
    return (dict(losses=losses, after0=after0,
                 digest=state_digest(state.model)), state, step)


def dp_errors(run: dict, ref: dict, p0: dict) -> dict:
    """A data-parallel run's distances to the one-process run `ref` (the
    keys of DIST_LIMITS); p0 the weights both started from."""
    def rel(a, b):
        return abs(a - b) / abs(b)

    a, b = run["after0"], ref["after0"]
    return dict(
        loss0=rel(run["losses"][0], ref["losses"][0]),
        stats=max(float((a[k] - b[k]).abs().max()) for k in b
                  if "running" in k),
        params=max(float((a[k] - b[k]).norm() / (b[k] - p0[k]).norm())
                   for k in p0 if "running" not in k
                   and "num_batches" not in k),
        loss1=rel(run["losses"][1], ref["losses"][1]))


def dp_failures(errs: dict) -> list[str]:
    """The DIST_LIMITS that errs exceeds."""
    return [k for k, lim in DIST_LIMITS.items() if not errs[k] <= lim]


def to_device(x, dev):
    """Tensors in x (a tensor, or a tuple or list of them and other values)
    on dev."""
    if torch.is_tensor(x):
        return x.to(dev)
    if isinstance(x, (tuple, list)):
        return type(x)(to_device(y, dev) for y in x)
    return x


def synced_samples(runs: dict, mesh) -> dict:
    """Seconds of each run on every rank at once: a barrier, the run, a
    synchronise, a barrier; DIST_REPS rounds of the runs in turns after
    one warm call each."""
    group = mesh.get_group()

    def once(fn):
        torch.distributed.barrier(group=group)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        torch.distributed.barrier(group=group)
        return time.perf_counter() - t0

    for fn in runs.values():
        once(fn)
    out = {k: [] for k in runs}
    for _ in range(DIST_REPS):
        for k, fn in runs.items():
            out[k].append(once(fn))
    return out


def dist_rank(rank: int, world: int, backend: str, with_train: bool) -> dict:
    """One rank of the dist phase, on the card spawn set: its block of the
    serving streams through the sharded tracker (counted; every K1/K2 call
    against its plain version), the shared detector, the fused step and
    strided-4 serving, the serving rates, and with_train the
    data-parallel train step."""
    dev = torch.device("cuda", torch.cuda.current_device())
    m = mesh_mod.stream_mesh(world, device=dev, backend=backend)
    k = SERVE_STREAMS // world
    t0 = time.perf_counter()
    frames_np, d_np, v_np, _, _, cfg = serve_fixture(k, first=rank * k)
    frames = torch.as_tensor(frames_np, device=dev)
    del frames_np
    d = torch.as_tensor(d_np, device=dev)
    v = torch.as_tensor(v_np, device=dev)
    res = dict(rank=rank, device=str(dev), render_s=time.perf_counter() - t0)

    def banks(c):
        return serve.make_stream_banks(SERVE_STREAMS, c, m, device=dev)

    # the tracker cell, counted; then every K1/K2 call against its plain
    # version
    torch.cuda.synchronize()
    reset_counts()
    _, out = serve.multi_stream_sequence(banks(cfg), frames, d, v, cfg)
    torch.cuda.synchronize()
    res["tracker_launches"] = read_counts()
    res["tracker"] = triple(out)
    _, errs, _, seen = checked_run(serve.multi_stream_sequence, banks(cfg),
                                   frames, d, v, cfg)
    res["errs"] = {key: (len(e), max(e)) for key, e in errs.items()}
    if rank == 0:
        res["seen"] = {key: to_device(seen[key], "cpu")
                       for key in ("roi_extract", "auction_solve")}

    # the detector cells: the shared batch and the per-shard forward of
    # frame 0, then the fused step and strided-4 serving, counted
    spec = YoloSpec("yolov3-tiny", num_classes=80)
    model = detector.YoloDetector.random_init(
        spec, seed=0, device=dev, max_out=SERVE_DETS, iou_thr=E2E_IOU,
        score_thr=E2E_SCORE).model
    dcfg = TrackerConfig(max_tracks=128, max_detections=SERVE_DETS,
                         frame_height=HEIGHT, frame_width=WIDTH)
    frames_tm = frames.transpose(0, 1)
    res["detect"] = to_device(serve.shared_detector_detect(
        model, frames_tm[0], serve_detect, m, with_classes=True), "cpu")
    res["detect_dp"] = to_device(serve_detect(model, frames_tm[0]), "cpu")
    torch.cuda.synchronize()
    reset_counts()
    with kernels_checked() as checks:
        _, fused = serve.detect_then_track_step_shared(
            model, banks(dcfg), frames_tm[0], dcfg, serve_detect, m)
        _, st = serve.multi_stream_sequence_strided(
            model, banks(dcfg), frames_tm, dcfg, serve_detect, SERVE_STRIDE,
            mesh=m)
    torch.cuda.synchronize()
    res["detector_launches"] = read_counts()
    res["detector_errs"] = {key: (len(e), max(e))
                            for key, e in checks.by_kernel().items()}
    res["detector_k8"] = (sum(math.isinf(x) for x in checks.by_kernel().get(
        "kcf_search", [])), checks.k8_f64)
    res["fused"], res["strided"] = triple(fused), triple(st)

    # aggregate rates over SERVE_WINDOW frames: the tracker from the banks
    # after frame 16, the fused shared-detector step from fresh banks
    w = SERVE_WINDOW
    b16, _ = serve.multi_stream_sequence(banks(cfg), frames[:, :16],
                                         d[:, :16], v[:, :16], cfg)
    win = slice(16, 16 + w)

    def fused_run():
        b = banks(dcfg)
        for i in range(w):
            b, _ = serve.detect_then_track_step_shared(
                model, b, frames_tm[i], dcfg, serve_detect, m)

    res["serve_s"] = synced_samples({
        "tracker": lambda: serve.multi_stream_sequence(
            b16, frames[:, win], d[:, win], v[:, win], cfg),
        "fused": fused_run}, m)
    del frames, frames_tm, b16

    if with_train:
        bm = mesh_mod.batch_mesh(world, device=dev, backend=backend)
        tspec = YoloSpec(**TRAIN_SPEC)
        k = DIST_TRAIN_BATCH // world
        x, t = dist_batch(dev, tspec, first=rank * k, n=k)
        res["train"], state, step = dp_run(tspec, dev, x, t, bm)
        res["train_s"] = synced_samples(
            {"train": lambda: [step(state, x, t) for _ in range(2)]},
            bm)["train"]
        del state
        if world == 2:
            res["faults"] = {}
            for name in DIST_FAULTS:
                with dp_fault(name):
                    res["faults"][name] = dp_run(tspec, dev, x, t, bm)[0]
    return res


def dist_equal(got, ref, world: int, what: str) -> str:
    """Gathered (ids, valid, boxes) against the one-process run: bit-equal
    at world 1, else ids and valid equal and every slot's box within
    DIST_BOX_TOL."""
    same = all(np.array_equal(a, b) for a, b in zip(got[:2], ref[:2]))
    diff = float(np.abs(got[2] - ref[2]).max(initial=0.0))
    bit = bool(np.array_equal(got[2], ref[2]))
    if not (same and (bit if world == 1 else diff <= DIST_BOX_TOL)):
        raise AssertionError(f"dist world {world}: {what} against the "
                             f"one-process run: ids and valid equal {same}, "
                             f"boxes {diff:.3g} px (bit-equal {bit})")
    return (f"ids and valid equal, boxes bit-equal {bit} (largest "
            f"difference {diff:.3g} px)")


def phase_dist(dev, card, refs) -> dict:
    """The sharded serving and training paths at worlds 1 (NCCL), 2 and 4
    (gloo on cuda:0) against the one-process runs (see DIST_GLOO_WORLDS);
    returns what dist_kernel_times takes."""
    t_phase = time.perf_counter()
    tspec = YoloSpec(**TRAIN_SPEC)
    x, t = dist_batch(dev, tspec)
    ref_train = dp_run(tspec, dev, x, t)[0]
    p0 = seed_params(tspec)
    del x, t
    ref_d, ref_v, ref_c = refs["detect"]
    ref_d6 = detector.dets_with_classes(ref_d, ref_c)
    worlds = ([(min(torch.cuda.device_count(), 4), "nccl", "cuda")]
              + [(n, "gloo", "cuda:0") for n in DIST_GLOO_WORLDS])
    want_t = {k: 0 for k in KERNELS}
    want_t.update(roi_extract=SERVE_FRAMES, auction_solve=SERVE_FRAMES,
                  kcf_train_shift=SERVE_FRAMES, kcf_search=SERVE_FRAMES)
    # the detector cells: the fused step's forward and strided-4's 8, each
    # a yolov3-tiny forward
    want_d = dict(want_t, roi_extract=SERVE_FRAMES + 1,
                  auction_solve=SERVE_FRAMES + 1,
                  kcf_train_shift=SERVE_FRAMES + 1,
                  kcf_search=SERVE_FRAMES + 1,
                  epilogue=(1 + SERVE_FRAMES // SERVE_STRIDE) * bn_blocks(
                      YoloSpec("yolov3-tiny", num_classes=80)))
    limits = {"roi_extract": SERVE_ROI_TOL, "auction_solve": 0,
              "kcf_train_shift": K6_TOL["alphaf"],
              "kcf_search": K8_TOL["response"]}
    kept = dict(errs={k: 0.0 for k in limits})
    for world, backend, where in worlds:
        t0 = time.perf_counter()
        ranks = mesh_mod.spawn(dist_rank, world, backend,
                               world in DIST_TRAIN_WORLDS, device=where,
                               backend=backend)
        tag = f"world {world}, {backend}"
        log("dist", f"{tag}: {world} rank(s) on "
                    f"{[r['device'] for r in ranks]} in "
                    f"{time.perf_counter() - t0:.1f} s (each rendered its "
                    f"{SERVE_STREAMS // world} streams x {SERVE_FRAMES} "
                    f"frames of {HEIGHT}x{WIDTH} in <= "
                    f"{max(r['render_s'] for r in ranks):.1f} s)")
        for r in ranks:
            if (r["tracker_launches"] != want_t
                    or r["detector_launches"] != want_d):
                raise AssertionError(
                    f"dist {tag}, rank {r['rank']}: launches "
                    f"{r['tracker_launches']} (tracker), "
                    f"{r['detector_launches']} (detector); expected "
                    f"{want_t}, {want_d}")
            for key, (n, e) in r["errs"].items():
                if not e <= limits[key]:
                    raise AssertionError(f"dist {tag}, rank {r['rank']}: "
                                         f"{key} against its plain version "
                                         f"{e}")
                kept["errs"][key] = max(kept["errs"][key], e)
            # K6 is printed there, not held: on the random detector's
            # birth windows alphaf is ill-conditioned, and its float32 plain
            # version is itself up to 4e-3 of the largest |alphaf| from a
            # float64 run, over K6_TOL (PERF.md section 7).  K8, which
            # searches with that alphaf, is held: each call within K8_TOL,
            # or over it by the response alone and then within
            # K8_F64_RATIO of its plain version's error against float64
            det_errs = r["detector_errs"]
            n_wide, k8_f64 = r["detector_k8"]
            k8_ok = (det_errs.get("kcf_search", (0, 0))[0]
                     == want_d["kcf_search"] and n_wide == len(k8_f64)
                     and all(k8 <= K8_F64_RATIO * plain
                             for k8, plain in k8_f64))
            if not (set(det_errs) == {*limits, "epilogue"}
                    and det_errs["epilogue"] == (want_d["epilogue"], 0)
                    and all(det_errs[key][1] <= limits[key]
                            for key in ("roi_extract", "auction_solve"))
                    and k8_ok):
                raise AssertionError(f"dist {tag}, rank {r['rank']}: the "
                                     f"detector cells' calls against their "
                                     f"plain versions {det_errs}; K8 calls "
                                     f"over K8_TOL {n_wide}, their response "
                                     f"errors against float64 (K8, plain) "
                                     f"{k8_f64}")
        log("dist", f"{tag}: every rank launched K1, K2, K6 and K8 "
                    f"{SERVE_FRAMES} times in the tracker cell and "
                    f"{SERVE_FRAMES + 1} in the detector cells (fused step "
                    f"+ strided-4), K7 {want_d['epilogue']} times there, "
                    "K3-K5 never; every call of both cells against its "
                    "plain version, per rank (calls, largest error): "
                    f"tracker {[r['errs'] for r in ranks]}, detector "
                    f"{[r['detector_errs'] for r in ranks]} (K1 limit "
                    f"{SERVE_ROI_TOL:g} and bit-equal to the 4-tap mirror, "
                    "K2 exact, K7 word for word; K6 and K8 held to "
                    "K6_TOL and K8_TOL in the tracker cell; in the detector "
                    "cells K6 printed, K8 held, a call over K8_TOL's "
                    "response to within "
                    f"{K8_F64_RATIO:g} times its plain version's error "
                    "against float64: (K8, plain) "
                    f"{[r['detector_k8'][1] for r in ranks]})")

        def cat(key):
            return tuple(np.concatenate([r[key][i] for r in ranks])
                         for i in range(3))

        got = cat("tracker")
        log("dist", f"{tag}: tracker cell gathered over the ranks against "
                    "the one-process run: "
                    + dist_equal(got, refs["tracker"], world, "tracker"))
        box_diff, _, motas = serve_dump_check(
            types.SimpleNamespace(**{k: torch.as_tensor(x) for k, x in zip(
                ("ids", "valid", "boxes"), got)}),
            refs["dump"], refs["gt"], refs["vis"])
        log("dist", f"{tag}: against the JAX dump ({SERVE_DUMP.name}): ids "
                    f"and valid equal, boxes within {box_diff:.3g} px, "
                    f"MOTA per stream {motas}")
        sd = torch.cat([r["detect"][0] for r in ranks])
        sv = torch.cat([r["detect"][1] for r in ranks])
        shared_bit = torch.equal(sd, ref_d6) and torch.equal(sv, ref_v)
        dd, dv, dc = (torch.cat([r["detect_dp"][i] for r in ranks]).numpy()
                      for i in range(3))
        matches = set_matches(dd, dv, dc, sd[..., :5].numpy(), sv.numpy(),
                              sd[..., 5].numpy().astype(np.int64))
        log("dist", f"{tag}: the shared detector batch (all-gather of "
                    f"{SERVE_STREAMS} frames, one forward on every rank) "
                    "bit-equal to the one-process forward: "
                    f"{shared_bit}; the per-shard forwards "
                    f"({SERVE_STREAMS // world} frames a rank) against it, "
                    "detections "
                    f"matching per stream {matches} of {SERVE_DETS} (floor "
                    f"{E2E_MATCH_FLOOR})")
        if not (shared_bit and min(matches) >= E2E_MATCH_FLOOR):
            raise AssertionError(f"dist {tag}: shared detector bit-equal "
                                 f"{shared_bit}, per-shard matches "
                                 f"{matches}")
        for key, what in (("fused", "the fused shared-detector step"),
                          ("strided", f"strided-{SERVE_STRIDE} serving")):
            log("dist", f"{tag}: {what} gathered against the one-process "
                        "run: " + dist_equal(cat(key), refs[key], world,
                                             what))
        w = SERVE_WINDOW
        for key in ("tracker", "fused"):
            log("dist", f"{tag}: times {key} (sharded), S={SERVE_STREAMS} "
                        f"over {world} rank(s): " + rate_line(
                            ranks[0]["serve_s"][key], w, SERVE_STREAMS)
                        + f" ({card})")
        if world in DIST_TRAIN_WORLDS:
            def judged(runs):
                errs = dp_errors(runs[0], ref_train, p0)
                same = (len({x["digest"] for x in runs}) == 1
                        and all(x["losses"] == runs[0]["losses"]
                                for x in runs))
                return errs, dp_failures(errs) + ([] if same else
                                                  ["ranks bit-identical"])

            errs, failed = judged([r["train"] for r in ranks])
            ms = [1000 * s / 2 for s in ranks[0]["train_s"]]
            med = statistics.median(ms)
            log("dist", f"{tag}: data-parallel train step, yolov3-tiny at "
                        f"416, SGD {DIST_LR:g}, global batch "
                        f"{DIST_TRAIN_BATCH} distinct scenes "
                        f"({DIST_TRAIN_BATCH // world} a rank): losses "
                        f"{ranks[0]['train']['losses']} (one process "
                        f"{ref_train['losses']}); against the one-process "
                        f"step {errs} (limits {DIST_LIMITS}); every rank's "
                        f"state bit-identical after {TRAIN_STEPS} steps: "
                        f"{'ranks bit-identical' not in failed}; "
                        f"{DIST_TRAIN_BATCH * 1000 / med:.1f} images/s, "
                        f"{med:.2f} ms a step (median of {len(ms)} samples "
                        f"of 2 steps; {min(ms):.2f}-{max(ms):.2f} ms) "
                        f"({card})")
            if failed:
                raise AssertionError(f"dist {tag}: the data-parallel step "
                                     f"fails {failed}: {errs}")
            for name in ranks[0].get("faults", ()):
                errs, failed = judged([r["faults"][name] for r in ranks])
                log("dist", f"{tag}: the same step with the fault "
                            f"'{name}' put in: {errs}; fails {failed}")
                if not failed:
                    raise AssertionError(f"dist {tag}: the fault '{name}' "
                                         "passes the data-parallel checks")
        if world == max(DIST_GLOO_WORLDS):
            kept.update(seen=ranks[0]["seen"],
                        launches=ranks[0]["tracker_launches"],
                        world=world)
    log("dist", f"phase took {time.perf_counter() - t_phase:.1f} s")
    return kept


def roi_bound(levels, c1) -> tuple[float, str]:
    """K1's least time on its inputs (levels, lvl, r0, c0, ys, xs)."""
    rows, s = c1[3].shape
    frame = roi_k._row_frames(levels, rows, c1[3].device)
    return bound(rows * s * s * 4 + rows * (3 + 2 * s) * 4
                 + touched_pixels(c1[0], c1[3], c1[4], frame),
                 10 * rows * s * s)


def auction_bound(b, rounds) -> tuple[float, str]:
    """K2's least time on a batch of benefit matrices b [P, n, n] solved in
    `rounds` rounds each."""
    n_prob, n = b.shape[:2]
    return bound(b.numel() * 4 + n_prob * (n + 1) * 4,
                 int(rounds.sum()) * 4 * n * n)


def dist_kernel_times(seen, errs, launches, world) -> list:
    """K1 and K2 at a rank's shapes of the sharded serving run (rank 0 of
    the largest gloo world), timed here on cuda:0 against their plain
    versions; the rows of the kernels line."""
    dev = torch.device("cuda", 0)
    levels, hw, *c1 = to_device(seen["roi_extract"], dev)
    b = seen["auction_solve"].to(dev)
    rounds = auction_k.auction_solve(b, EPS, 2000)[1]
    rows = []
    for key, what, plain, kernel, reps, (b_ms, b_by), src in (
            ("roi_extract",
             f"K1 {c1[3].shape[0]} rows of {roi_k.n_frames(levels)} u8 "
             "1080p frames",
             lambda: roi_k._resample_ref(levels, hw, *c1),
             lambda: roi_k._resample_cuda(levels, hw, *c1), 50,
             roi_bound(levels, c1), ("roi.cu", "roi.py:465")),
            ("auction_solve",
             f"K2 batch {list(b.shape)} (rounds {rounds.tolist()})",
             lambda: auction_k.auction_solve_ref(b, EPS, 2000),
             lambda: auction_k.auction_solve(b, EPS, 2000), K2_REPS,
             auction_bound(b, rounds), ("auction.cu", "auction.py:107"))):
        ms, plain_ms = in_turns(plain, kernel, reps)
        dev_ms, plain_dev_ms = device_ms(kernel, reps), device_ms(plain, reps)
        log("times", f"sharded serving (a rank of world {world}) {what}: per "
                     f"call (CUDA event pairs) kernel {ms:.4f} ms, plain "
                     f"{plain_ms:.4f} ms; device time per call (profiler) "
                     f"kernel {dev_ms:.4f} ms, plain {plain_dev_ms:.4f} ms; "
                     f"bound {b_ms:.5f} ms ({b_by})")
        rows.append({
            "name": f"{key}_dist", "route": "cuda",
            "source": f"tpu_mot_torch/csrc/{src[0]}",
            "replaces": f"tpu_mot/kernels/{src[1]}",
            "launches": launches[key], "max_abs_err": errs[key],
            "ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms,
            "plain_device_ms": plain_dev_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "shape": what,
            "launches_of": f"dist world {world}, tracker cell, each rank"})
    return rows


def kernel_line(name: str, info: dict) -> str:
    return (f"{name} launches: path {info['path']}; {info['threads']} "
            f"threads per CTA, {info['registers']} registers per thread, "
            f"{info['smem_bytes']} bytes of shared memory per CTA, "
            f"{info['ctas_per_sm']} CTAs fit on an SM")


BENCH_SAMPLES = 3
BENCH_LATENCY_CALLS = 46
BENCH_FLOOR = 0.5       # bench.py:163-164: a MOTA under it reports 0
BENCH_GATED = ("default (gray, psr@5, appearance off)", "fhog31 + 3-scale")


def phase_bench(card: str, e2e_first) -> dict:
    """The port's twins of the repo's measuring scripts, each through its
    main at full size on the card (tpu_mot_torch/tools/): bench (the MOTA
    gate, value > 0), bench_variants (default and H at the MOTA gate, every
    row over bench.py's 0.5), bench_e2e (its detector stage's detections
    on frame 0 equal to e2e-detect's on the same weights) and bench_latency
    (46 timed calls).  Each prints its JSON line; returns {"bench": its
    line, "H": the "fhog31 + 3-scale" row, "e2e": bench_e2e's line}."""
    t_phase = time.perf_counter()
    samples = ["--samples", str(BENCH_SAMPLES)]
    failures = []

    line, _ = bench_tool.main(samples)
    mota = line["extra"]["mota_sanity"]
    log("bench", f"tools.bench: {line['value']} frames/s, MOTA {mota} "
                 f"(gate {M_REF - 0.01}), device {line['extra']['device']}")
    if not (mota >= M_REF - 0.01 and line["value"] > 0
            and line["extra"]["device"] == card):
        failures.append(f"bench: value {line['value']}, MOTA {mota}, "
                        f"device {line['extra']['device']!r}")

    rows, _ = bench_variants.main(samples)
    for row in rows:
        floor = M_REF - 0.01 if row["variant"] in BENCH_GATED else BENCH_FLOOR
        log("bench", f"tools.bench_variants {row['variant']!r}: "
                     f"{row['fps']} frames/s, MOTA {row['mota_sanity']} "
                     f"(floor {floor})")
        if not row["mota_sanity"] >= floor:
            failures.append(f"bench_variants {row['variant']!r}: MOTA "
                            f"{row['mota_sanity']} under {floor}")
    if [r["variant"] for r in rows] != list(bench_variants.VARIANTS):
        failures.append("bench_variants: rows missing")

    e2e, outs = bench_e2e.main(samples)
    same = [torch.equal(x[0].cpu(), y)
            for x, y in zip(outs["detector"], e2e_first)]
    diff = float((outs["detector"][0][0].cpu() - e2e_first[0]).abs().max())
    log("bench", f"tools.bench_e2e: fused {e2e['value']} frames/s; its "
                 f"detector stage's frame 0 equals e2e-detect's (dets, "
                 f"valid, classes): {same}, max |dets diff| {diff:.3g}")
    if not all(same):
        failures.append(f"bench_e2e: frame 0's detections {same}")

    lat, _ = bench_latency.main([])
    log("bench", f"tools.bench_latency: p50 {lat['value']} ms, p90 "
                 f"{lat['extra']['p90_ms']} ms, {lat['extra']['n_calls']} "
                 f"calls")
    if lat["extra"]["n_calls"] != BENCH_LATENCY_CALLS:
        failures.append(f"bench_latency: {lat['extra']['n_calls']} calls")

    log("bench", f"phase took {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError("bench: " + "; ".join(failures))
    return {"bench": line, "e2e": e2e,
            "H": rows[list(bench_variants.VARIANTS).index(BENCH_GATED[1])]}


# The tools phase (the last five twins, full size): the OTB rows' largest
# centre error on the card may differ from the same row run on the CPU (the
# port's gather path) by OTB_CPU_BOUND_PX: gray rows sit 3e-5 px from JAX
# on the CPU; a free fHOG-31 run drifts by pixels on its 4-px cells (the
# port's CPU run and JAX's differ by up to 2.3 px in it, PERF.md §6).
OTB_CPU_BOUND_PX = {"gray": 0.5, "fhog": 5.0, "fhog-3scale": 5.0}
# the hard fixture's tiers against HARD_DUMP: boxes (px), HOTA and MOTA
HARD_BOX_TOL, HARD_SCORE_TOL = 0.05, 0.005
# tools/train_e2e_mota.py on the CPU (jax 0.9.0, 600 steps): its mAP@50
# (loss 19.3013 -> 0.5445); the card's twin must reach TRAIN_E2E_MAP_SHARE
# of it and halve its loss.  Its weights are torch's draw of flax's
# initialisation, not the JAX run's, and the fine-tune is chaotic, so the
# gate is a floor, not equality.
TRAIN_E2E_MAP_JAX, TRAIN_E2E_MAP_SHARE = 0.3946, 0.75


def phase_tools(card: str, hard_b) -> dict:
    """The port's twins of the JAX package's last five measuring tools, each
    through its main at full size on the card (tpu_mot_torch/tools/), with
    the gates of each; returns the kernels line's row of K2's global-memory
    path (the hard fixture's [256, 256] matrices)."""
    t_phase = time.perf_counter()
    samples = ["--samples", str(BENCH_SAMPLES)]
    failures = []

    # otb: every row tracks; the centre error near the CPU twin's; K1
    # alone (T = 1 has no assignment)
    reset_counts()
    rows, _ = bench_otb.main(samples)
    counts = read_counts()
    log("tools", f"bench_otb: launches {counts}")
    if not (counts["roi_extract"] > 0 and counts["auction_solve"] == 0):
        failures.append(f"bench_otb: launches {counts}")
    clip = bench_otb.fixture()
    cpu_frames = torch.as_tensor(clip.frames)
    for row in rows:
        boxes, _ = bench_otb.run_row(
            cpu_frames, clip, KCFConfig(**bench_otb.VARIANTS[row["config"]]),
            row["train_site"], 0)
        cpu_err = float(bench_otb.center_err(boxes, clip).max())
        bound_px = OTB_CPU_BOUND_PX[row["config"]]
        log("tools", f"bench_otb {row['config']} {row['train_site']}: "
                     f"{row['fps']} frames/s, max centre error "
                     f"{row['max_center_err_px']} px (the CPU: "
                     f"{cpu_err:.3f}, bound {bound_px}), tracking_ok "
                     f"{row['tracking_ok']}")
        if not (row["tracking_ok"] and row["device"] == card
                and abs(row["max_center_err_px"] - cpu_err) <= bound_px):
            failures.append(f"bench_otb {row['config']} "
                            f"{row['train_site']}: {row}")

    # configs4: dp and shared bit-equal, every row a rate, K1 and K2 once a
    # multi-stream frame
    reset_counts()
    rows, outs = bench_configs4.main(samples)
    counts = read_counts()
    # the five rows that track (dp, shared, bf16 + fast NMS, strided-4, the
    # tracker stage) launch K1 and K2 once a multi-stream frame, in the
    # warm-up and every sample
    want_n = 5 * (1 + BENCH_SAMPLES) * bench_configs4.FULL["n_frames"]
    for row in rows[:-1]:
        log("tools", f"bench_configs4 {row['mode']}: "
                     f"{row['ms_per_multistream_step']} ms a multi-stream "
                     f"step, {row['aggregate_fps_per_chip']} stream-frames/s")
    log("tools", f"bench_configs4 stages: {rows[-1]}; dp and shared equal: "
                 f"{rows[1]['equal_to_dp']}; launches {counts} (K1, K2 "
                 f"{want_n} each expected)")
    if not (rows[1]["equal_to_dp"]
            and all(r["aggregate_fps_per_chip"] > 0 for r in rows[:-1])
            and counts["roi_extract"] == counts["auction_solve"] == want_n
            and bool(outs["dp"].valid.any())):
        failures.append(f"bench_configs4: {rows}, launches {counts}")

    # ingest: the native scheduler, live tracks, consistent counters; K1 and
    # K2 once a step (and the warm-up step)
    reset_counts()
    line, res = bench_ingest.main([])
    counts = read_counts()
    ex = line["extra"]
    st = ex["sched_stats"]
    books = all(st["fresh"][s] + st["repeated"][s] == ex["steps"]
                and ex["pushed"][s] == (st["fresh"][s] + st["dropped"][s]
                                        + ex["left_in_ring"][s])
                for s in range(ex["streams"]))
    log("tools", f"bench_ingest: {line['value']} steps/s, "
                 f"{ex['aggregate_tracked_fps']} stream-frames/s, scheduler "
                 f"{ex['scheduler']}, counters {st}, pushed {ex['pushed']}, "
                 f"left {ex['left_in_ring']}, alive "
                 f"{ex['alive_per_stream_at_end']}, batch copy p50 "
                 f"{ex['h2d_batch_ms_p50']} ms; books balance: {books}; "
                 f"launches {counts}")
    if not (ex["scheduler"] == "native" and books and ex["steps"] > 0
            and counts["roi_extract"] == counts["auction_solve"]
            == ex["steps"] + 1
            and all(a > 0 for a in ex["alive_per_stream_at_end"])
            and ex["device"] == card):
        failures.append(f"bench_ingest: {line}")

    # hard fixture: K2 at n = 256 on every frame; the dump's tracks
    solve, sizes = auction_k.auction_solve, []

    def sized(b, eps, max_iters):
        sizes.append(b.shape[-1])
        return solve(b, eps, max_iters)

    reset_counts()
    auction_k.auction_solve = sized
    try:
        rows, outs = bench_hard_fixture.main(samples)
    finally:
        auction_k.auction_solve = solve
    counts = read_counts()
    n_frames = bench_hard_fixture.FULL["n_frames"]
    runs = len(bench_hard_fixture.TIERS) * (1 + BENCH_SAMPLES)
    kcf_runs = (len(bench_hard_fixture.TIERS) - 1) * (1 + BENCH_SAMPLES)
    log("tools", f"bench_hard_fixture: launches {counts}; K2 sizes "
                 f"{sorted(set(sizes))} over {len(sizes)} calls "
                 f"({runs * n_frames} expected, path "
                 f"{auction_k.launch_info(256)['path']})")
    if not (counts["auction_solve"] == len(sizes) == runs * n_frames
            and set(sizes) == {256}
            and counts["roi_extract"] == kcf_runs * n_frames):
        failures.append(f"bench_hard_fixture: launches {counts}, K2 sizes "
                        f"{sorted(set(sizes))}")
    dump = np.load(HARD_DUMP)
    log("tools", f"bench_hard_fixture {rows[0]['tier']}: {rows[0]}")
    for i, row in enumerate(rows[1:]):
        ok, txt = compare_tracks(
            triple(outs[row["tier"]]),
            (dump[f"t{i}_ids"], dump[f"t{i}_valid"], dump[f"t{i}_boxes"]),
            HARD_BOX_TOL)
        ref = {k: float(dump[f"t{i}_{k}"]) for k in ("hota", "mota")}
        close = all(abs(row[k] - ref[k]) <= HARD_SCORE_TOL for k in ref)
        log("tools", f"bench_hard_fixture {row['tier']}: HOTA "
                     f"{row['hota']}, MOTA {row['mota']} (JAX {ref}), IDF1 "
                     f"{row['idf1']}, {row['fps']} frames/s; against the "
                     f"dump: {txt}")
        if not (ok and close and row["device"] == card):
            failures.append(f"bench_hard_fixture {row['tier']}: {txt}, "
                            f"{row}")
    hard_launches = counts["auction_solve"]

    # train-e2e: it learns, and reaches a share of the JAX run's mAP; its
    # tracking scene launches K1 and K2 once a frame
    reset_counts()
    lines, _ = train_e2e_mota.main([])
    counts = read_counts()
    track_frames = train_e2e_mota.FULL["track"]
    by = {x["phase"]: x for x in lines}
    tr = by["train"]
    floor = TRAIN_E2E_MAP_SHARE * TRAIN_E2E_MAP_JAX
    log("tools", f"train_e2e_mota: loss {tr['loss_first']} -> "
                 f"{tr['loss_final']} in {tr['seconds']} s; {by['map']}; "
                 f"{by['quant_map']}; {by['SUMMARY']}; launches {counts}")
    if not (tr["loss_final"] < 0.5 * tr["loss_first"]
            and counts["roi_extract"] == counts["auction_solve"]
            == track_frames
            and by["map"]["map@50"] >= floor
            and by["SUMMARY"]["device"] == card):
        failures.append(f"train_e2e_mota: loss {tr}, mAP "
                        f"{by['map']['map@50']} (floor {floor:.4f})")

    log("tools", f"phase took {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError("tools: " + "; ".join(failures))
    return global_k2_row(hard_b, hard_launches)


def rows_counted(fn, at=None):
    """fn() with `tools.bench.warm_and_sample` (one call a row of the twins
    that run bench.py's protocol) wrapped to read each call's launch
    counts, hold its kernel calls against their plain versions
    (`kernels_checked(at)`) and keep the bank its warm-up run left: (fn's
    result, [(each row's counts, its warm-up bank, its KernelChecks)])."""
    warm_and_sample, seen = bench_tool.warm_and_sample, []

    def counted(*args, **kw):
        reset_counts()
        with kernels_checked(at) as st:
            result = warm_and_sample(*args, **kw)
        seen.append((read_counts(), result[0], st))
        return result

    bench_tool.warm_and_sample = counted
    try:
        return fn(), seen
    finally:
        bench_tool.warm_and_sample = warm_and_sample


def per_frame(counts: dict, n_frames: int) -> dict:
    """Launches a frame of every kernel from a run's counts: the counts
    over n_frames, or the counts themselves where they do not divide."""
    return {k: c // n_frames if c % n_frames == 0 else c
            for k, c in counts.items()}


def phase_sweeps(card: str, frames, d, v, cfg) -> None:
    """The port's twins of the JAX package's last four measuring tools, each
    through its main at full size on the card, with the gates of each:
    bench_multistream (every stream of every S bit-equal to stream 0 of
    S = 1, which equals run_sequence on the same frames; K1 and K2 once a
    multi-stream frame, K6 and K8 too, K2 [S, 160, 160]),
    bench_class_cost (each row
    against SWEEPS_DUMP), bench_train_site (the refined rows against
    SWEEPS_DUMP, the detect rows at the MOTA gate, TRAIN_SITE_LAUNCHES
    exactly) and bench_template_size (48 and 32 against SWEEPS_DUMP, 64 at
    the MOTA gate); in every row the calls SWEEP_CHECK_AT of each kernel at
    each shape it runs at held against its plain version; every line names
    the card and has a rate above 0.  frames, d, v, cfg: the bench fixture
    on the card."""
    t_phase = time.perf_counter()
    samples = ["--samples", str(BENCH_SAMPLES)]
    runs = 1 + BENCH_SAMPLES            # the warm-up and the samples
    n = N_FRAMES
    dump = np.load(SWEEPS_DUMP)
    failures = []
    # K1, K2 and (gray S = 64: detect-site training, the search) K6 and K8
    # once a frame
    once = dict(roi_extract=1, auction_solve=1, kcf_train_shift=1,
                kcf_search=1)
    limits = {"roi_extract": ROI_TOL, "roi_extract_scales": ROI_TOL,
              "auction_solve": 0, "kcf_detect": KCF_TOL["response"],
              "kcf_train": KCF_TOL["alphaf"],
              "kcf_train_shift": K6_TOL["alphaf"],
              "kcf_search": K8_TOL["response"]}

    def against_dump(what, out, row, scores=None, bank=None):
        """ids and valid exact, boxes within SWEEP_BOX_TOL, the auction's
        rounds exact on every frame, the warm-up bank's alphaf of the first
        SWEEP_BANK_SLOTS slots within KCF_TOL (relative to the largest
        magnitude) and the scores within SWEEP_SCORE_TOL."""
        ok, txt = compare_tracks(
            triple(out), tuple(dump[f"{row}_{k}"]
                               for k in ("ids", "valid", "boxes")),
            SWEEP_BOX_TOL)
        iters = out.assign_iters.cpu().numpy()
        same_iters = int((iters == dump[f"{row}_iters"]).sum())
        ok &= same_iters == n
        txt += f"; auction rounds equal on {same_iters}/{n} frames"
        a = bank.kcf.alphaf[:SWEEP_BANK_SLOTS]
        want = torch.as_tensor(dump[f"{row}_alphaf"], device=a.device)
        e = (rel_err(a, want) if a.shape == want.shape else math.inf)
        ok &= e <= KCF_TOL["alphaf"]
        txt += (f"; the last bank's alphaf {tuple(a.shape)} (JAX "
                f"{tuple(want.shape)}) off by {e:.3g} of the largest "
                f"magnitude (limit {KCF_TOL['alphaf']:g})")
        for key, got in (scores or {}).items():
            ref = float(dump[f"{row}_{key}"])
            ok &= abs(got - ref) <= SWEEP_SCORE_TOL
            txt += f"; {key} {got} (JAX {ref})"
        log("sweeps", f"{what} against the JAX dump's {row!r}: {txt}")
        if not ok:
            failures.append(f"{what}: {txt}")

    def line_ok(what, line, rate):
        if not (line["device"] == card and line[rate] > 0):
            failures.append(f"{what}: {line}")

    def launches_ok(what, got, want):
        want = {k: want.get(k, 0) for k in KERNELS}
        log("sweeps", f"{what}: launches {got} (expected {want})")
        if got != want:
            failures.append(f"{what}: launches {got}, expected {want}")

    def checks_ok(what, st):
        """Every shape a kernel ran at has checked calls, each within its
        kernel's limit."""
        for key, calls in sorted(st.calls.items(), key=str):
            e = st.errs.get(key, [])
            worst = max(e, default=math.inf)
            log("sweeps", f"{what}: {key[0]} at {key[1]}: {calls} calls, "
                          f"{len(e)} held against the plain version, "
                          f"largest error {worst:.3g} (limit "
                          f"{limits[key[0]]:g})")
            if not worst <= limits[key[0]]:
                failures.append(f"{what}: {key[0]} at {key[1]} against its "
                                f"plain version: errors {e}")

    # multistream: S copies of one clip, each stream equal to S = 1's
    reset_counts()
    with kernels_checked(SWEEP_CHECK_AT) as st:
        lines, outs = bench_multistream.main(samples)
    counts = read_counts()
    m = bench_multistream.N_FRAMES
    streams = bench_multistream.STREAMS
    for line in lines:
        log("sweeps", f"bench_multistream S={line['streams']}: "
                      f"{line['ms_per_step']} ms a multi-stream step, "
                      f"{line['aggregate_fps_per_chip']} stream-frames/s "
                      f"(spread {line['spread_fps']}), scaling_vs_1 "
                      f"{line['scaling_vs_1']}")
        line_ok(f"bench_multistream S={line['streams']}", line,
                "aggregate_fps_per_chip")
    launches_ok("bench_multistream (a multi-stream frame)",
                per_frame(counts, len(streams) * runs * m), once)
    checks_ok("bench_multistream", st)
    k2_n = max(cfg.max_tracks, cfg.max_detections)     # K2 pads to square
    shapes = {key[1]: c for key, c in st.calls.items()
              if key[0] == "auction_solve"}
    if shapes != {(s, k2_n, k2_n): runs * m for s in streams}:
        failures.append(f"bench_multistream: K2 calls a shape {shapes}, "
                        f"expected [S, {k2_n}, {k2_n}] for S in {streams}, "
                        f"{runs * m} calls each")
    _, one = scan.run_sequence(bank_mod.empty_bank(cfg, device=frames.device),
                               frames[:m], d[:m], v[:m], cfg)
    first = type(one)(*[x[0] for x in outs[1]])
    unequal = [(s, k) for s in streams for k in ("ids", "valid", "boxes")
               for i in range(s)
               if not torch.equal(getattr(outs[s], k)[i], getattr(first, k))]
    unequal += [(0, k) for k in ("ids", "valid", "boxes")
                if not torch.equal(getattr(first, k), getattr(one, k))]
    log("sweeps", f"bench_multistream: every stream of S = "
                  f"{list(streams)} bit-equal to stream 0 of S = 1, which "
                  f"equals run_sequence on frames 0-{m - 1}: "
                  f"{not unequal} (K2 calls a shape {shapes})")
    if unequal:
        failures.append(f"bench_multistream: (S, field) unequal {unequal}")

    # class cost: each row against the dump
    (lines, outs), seen = rows_counted(
        lambda: bench_class_cost.main(samples), SWEEP_CHECK_AT)
    for line, (counts, bank, st) in zip(lines, seen):
        c = line["class_aware"]
        what = f"bench_class_cost class_aware={c}"
        log("sweeps", f"{what}: {line['fps']} frames/s, "
                      f"{line['ms_per_frame']} ms a frame, assoc_box "
                      f"{line['assoc_box_resolved']}")
        line_ok(what, line, "fps")
        launches_ok(f"{what} (a frame)", per_frame(counts, runs * n), once)
        checks_ok(what, st)
        against_dump(what, outs[c], "class_aware" if c else "default",
                     bank=bank)

    # train site: refined rows against the dump, detect rows at the gate
    (lines, outs), seen = rows_counted(
        lambda: bench_train_site.main(samples), SWEEP_CHECK_AT)
    for line, (counts, bank, st) in zip(lines, seen):
        row = (line["config"], line["train_site"])
        what = f"bench_train_site {row[0]} {row[1]}"
        log("sweeps", f"{what}: {line['fps']} frames/s, MOTA "
                      f"{line['mota_sanity']}, IDF1 {line['idf1']}, IDSW "
                      f"{line['idsw']}")
        line_ok(what, line, "fps")
        launches_ok(f"{what} (a frame)", per_frame(counts, runs * n),
                    TRAIN_SITE_LAUNCHES[row])
        checks_ok(what, st)
        if row[1] == "refined":
            against_dump(what, outs[row], {"default-gray": "gray_refined",
                                           "fhog-3scale": "fhog_refined"}[
                row[0]], {"mota": line["mota_sanity"]}, bank)
        elif not line["mota_sanity"] >= M_REF - 0.01:
            failures.append(f"{what}: MOTA {line['mota_sanity']} under "
                            f"{M_REF - 0.01}")

    # template size: 48 and 32 against the dump, 64 at the gate
    (lines, outs), seen = rows_counted(
        lambda: bench_template_size.main(samples), SWEEP_CHECK_AT)
    for line, (counts, bank, st) in zip(lines, seen):
        s = line["template_size"]
        what = f"bench_template_size {s}"
        log("sweeps", f"{what}: {line['fps']} frames/s, "
                      f"{line['ms_per_frame']} ms a frame, MOTA "
                      f"{line['mota']}, HOTA {line['hota']}")
        line_ok(what, line, "fps")
        launches_ok(f"{what} (a frame)", per_frame(counts, runs * n),
                    once if s == 64 else dict(once, kcf_train_shift=0,
                                              kcf_search=0))
        checks_ok(what, st)
        if s == 64:
            if not line["mota"] >= M_REF - 0.01:
                failures.append(f"{what}: MOTA {line['mota']} under "
                                f"{M_REF - 0.01}")
        else:
            against_dump(what, outs[s], f"t{s}",
                         {"mota": line["mota"], "hota": line["hota"]}, bank)

    log("sweeps", f"phase took {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError("sweeps: " + "; ".join(failures))


def global_k2_row(b, launches: int) -> dict:
    """K2 on one of the hard fixture's [256, 256] matrices (the rows read
    from global memory) against its plain version: the kernels line's row
    of that path, with its rounds and the device time at 0 rounds."""
    rounds = auction_k.auction_solve(b, EPS, 2000)[1]
    n = b.shape[-1]
    ms, plain_ms = in_turns(lambda: auction_k.auction_solve_ref(b, EPS, 2000),
                            lambda: auction_k.auction_solve(b, EPS, 2000),
                            K2_REPS)
    dev_ms = device_ms(lambda: auction_k.auction_solve(b, EPS, 2000), K2_REPS)
    plain_dev_ms = device_ms(
        lambda: auction_k.auction_solve_ref(b, EPS, 2000), K2_REPS)
    no_rounds = device_ms(lambda: auction_k.auction_solve(b, EPS, 0), K2_REPS)
    b_ms, b_by = auction_bound(b[None], rounds[None])
    info = auction_k.launch_info(n)
    per_round_us = 1000 * (dev_ms - no_rounds) / max(int(rounds), 1)
    log("times", f"K2 auction n={n} (hard fixture frame 2, "
                 f"{int(rounds)} rounds, {info['path']}): per call (CUDA "
                 f"event pairs) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
                 f"device time per call (profiler) kernel {dev_ms:.4f} ms, "
                 f"plain {plain_dev_ms:.4f} ms, at 0 rounds {no_rounds:.4f} "
                 f"ms ({per_round_us:.2f} us a round); bound {b_ms:.5f} ms "
                 f"({b_by})")
    log("times", kernel_line(f"K2 auction n={n}", info))
    return {"ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms,
            "plain_device_ms": plain_dev_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "launches": launches,
            "rounds": int(rounds), "no_rounds_device_ms": no_rounds,
            "per_round_us": per_round_us, "launch": info,
            "shape": f"[{n}, {n}]",
            "launches_of": "tools phase, bench_hard_fixture's three tiers"}


def phase_times(frames, d, v, cfg, levels_u8, boxes0, bench_bs, hf_inputs,
                assoc, twins):
    bench_b = bench_bs[-1]          # steady state; bench_bs[0]: init frame
    a_frames, a_d, a_v, a_cfg = assoc
    # Every run_sequence rate comes from the bench twins' protocol (a
    # warm-up run, then dependent runs that carry the bank, each closed by
    # one fetch): default and H are the twins' own runs (the bench phase),
    # HF, A and AW are timed here through bench_tool.run_tensors.
    rates = [("default", twins["bench"]["value"],
              twins["bench"]["extra"]["spread_fps"], "tools.bench"),
             ("H", twins["H"]["fps"], twins["H"]["spread_fps"],
              "tools.bench_variants 'fhog31 + 3-scale'")]
    for name, c, (fr, dd, vv) in (
            ("HF", heavy_config(cfg, "HF"), (frames, d, v)),
            ("A", a_cfg, (a_frames, a_d, a_v)),
            ("AW", a_cfg.replace(**ASSOC["AW"]), (a_frames, a_d, a_v))):
        _, secs = bench_tool.run_tensors(fr, dd, vv, c, BENCH_SAMPLES)
        n = fr.shape[0]
        rates.append((name, round(n / statistics.median(secs), 1),
                      bench_tool.spread(n, secs), "bench.run_tensors"))
    for name, fps, lo_hi, by in rates:
        log("times", f"run_sequence {name}: {fps} frames/s, "
                     f"{1000 / fps:.3f} ms/frame (median of {BENCH_SAMPLES} "
                     f"dependent runs of {N_FRAMES} frames, {lo_hi[0]}-"
                     f"{lo_hi[1]} frames/s; {by})")
    hw = (HEIGHT, WIDTH)
    t = boxes0.shape[0]
    s1 = cfg.kcf.template_size
    coords = roi_k.sample_coords(boxes0, 2.5, s1, hw)
    coords3 = roi_k.sample_coords_scales(boxes0, 2.5, s1, SCALES, hw)
    rounds = int(auction_k.auction_solve(bench_b, EPS, 2000)[1])
    n = bench_b.shape[0]
    d_model, d_feat = hf_inputs["detect"]
    t_model, t_feat, yf, lr = hf_inputs["train"]
    hcfg = heavy_config(cfg, "HF")
    sigma, lam = hcfg.kcf.kernel_sigma, hcfg.kcf.lambda_
    ni, c, s, _ = d_feat.shape
    sf = s // 2 + 1
    nt = t_model.xf.shape[0]
    lvl3 = coords3[0].repeat(3)
    bounds = {
        # outputs + coordinates + the pixels read with nonzero weight
        "roi_extract": bound(
            t * s1 * s1 * 4 + t * (3 + 2 * s1) * 4
            + touched_pixels(*coords[0:1], *coords[3:5]), 10 * t * s1 * s1),
        "roi_extract_scales": bound(
            3 * t * s1 * s1 * 4 + t * 3 * 4 + 3 * t * 2 * s1 * 4
            + touched_pixels(lvl3, coords3[3].reshape(3 * t, s1),
                             coords3[4].reshape(3 * t, s1)),
            30 * t * s1 * s1),
        # the benefit matrix in, col_of and iters out; ~4 n^2 per round
        "auction_solve": bound(n * n * 4 + n * 4 + 4, rounds * 4 * n * n),
        # features, the model rows, the response; FFT-based operations
        "kcf_detect": bound(
            ni * c * s * s * 4 + nt * (c + 1) * s * sf * 8 + ni * s * s * 4,
            ni * (c * fft_flops(s) + 8 * c * s * sf + 3 * fft_flops(s)
                  + 10 * s * s + 6 * s * sf)),
        "kcf_train": bound(
            nt * c * s * s * 4 + 2 * nt * (c + 1) * s * sf * 8
            + s * sf * 8 + nt * 4,
            nt * (c * fft_flops(s) + 8 * c * s * sf + 2 * fft_flops(s)
                  + 10 * s * s + 16 * s * sf)),
    }
    pairs = {
        "roi_extract": (f"K1 ROI resample T={t} u8 1080p",
                        lambda: roi_k._resample_ref(levels_u8, hw, *coords),
                        lambda: roi_k._resample_cuda(levels_u8, hw, *coords),
                        50),
        "roi_extract_scales": (
            f"K3 3-scale ROI resample T={t} x 3 u8 1080p",
            lambda: roi_k._resample_scales_ref(levels_u8, hw, *coords3),
            lambda: roi_k._resample_scales_cuda(levels_u8, hw, *coords3),
            50),
        "auction_solve": (
            f"K2 auction n={n} (bench frame 2, {rounds} rounds)",
            lambda: auction_k.auction_solve_ref(bench_b, EPS, 2000),
            lambda: auction_k.auction_solve(bench_b, EPS, 2000), K2_REPS),
        "kcf_detect": (
            f"K4 fused detect feat {tuple(d_feat.shape)} (HF frame 2)",
            lambda: kcf_k.detect_fused_ref(d_model, d_feat, sigma),
            lambda: kcf_k.detect_fused(d_model, d_feat, sigma), 50),
        "kcf_train": (
            f"K5 fused train feat {tuple(t_feat.shape)} (HF frame 2)",
            lambda: kcf_k.train_fused_ref(t_model, t_feat, yf, sigma, lam,
                                          lr),
            lambda: kcf_k.train_fused(t_model, t_feat, yf, sigma, lam, lr),
            50),
    }
    # K6 at the serve cell's rows: five [rows, 64, 33] spectra cross the
    # bus (z^, x^ and alpha^ in, x^ and alpha^ out); two real 2-D FFTs, the
    # phase ramp and the Gaussian kernel's exp in operations.
    sh = shift_inputs(gray_kcf_inputs(frames, boxes0, cfg))
    rows = sh[1].shape[0]
    bounds["kcf_train_shift"] = bound(
        rows * (5 * 64 * 33 * 8 + 3 * 4) + 64 * 33 * 8,
        rows * (2 * fft_flops(64) + 20 * 64 * 33 + 20 * 64 * 64))
    pairs["kcf_train_shift"] = (
        f"K6 train_shift zf {tuple(sh[1].shape)}",
        lambda: kcf_k.train_shift_fused_ref(*sh),
        lambda: kcf_k.train_shift_fused(*sh), 20)
    # K8 at the serve cell's rows: a row reads its windowed features and its
    # bank row's x^ and alpha^ and writes z^, the response and five scalars;
    # four real 2-D FFTs, the products, the exp and the peak's passes in
    # operations.
    s_model, s_feat = search_inputs(frames, boxes0, cfg)["K=1"]
    rows = s_feat.shape[0]
    bounds["kcf_search"] = bound(
        rows * (2 * 64 * 64 * 4 + 3 * 64 * 33 * 8 + 4 * 4 + 8) + 64 * 8,
        rows * (4 * fft_flops(64) + 16 * 64 * 33 + 30 * 64 * 64))
    pairs["kcf_search"] = (
        f"K8 search feat {tuple(s_feat.shape)}",
        lambda: kcf_k.search_fused_ref(s_model, s_feat, cfg.kcf.kernel_sigma),
        lambda: kcf_k.search_fused(s_model, s_feat, cfg.kcf.kernel_sigma), 20)
    times = {}
    for key, (what, plain, kernel, reps) in pairs.items():
        ms, plain_ms = in_turns(plain, kernel, reps)
        dev_ms, plain_dev_ms = device_ms(kernel, reps), device_ms(plain, reps)
        b_ms, b_by = bounds[key]
        times[key] = {"ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms,
                      "plain_device_ms": plain_dev_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": None}
        log("times", f"{what}: per call (median of CUDA event pairs, host "
                     f"launch time included) kernel {ms:.4f} ms, plain "
                     f"{plain_ms:.4f} ms; device time per call (profiler) "
                     f"kernel {dev_ms:.4f} ms, plain {plain_dev_ms:.4f} ms; "
                     f"bound {b_ms:.5f} ms ({b_by})")

    # K2 by rounds: the init frame's matrix, and solves capped at 0 rounds
    # (launch and staging alone) and at half the rounds.
    init_b = bench_bs[0]
    init_rounds = int(auction_k.auction_solve(init_b, EPS, 2000)[1])
    extra = {"rounds": rounds, "init_frame_rounds": init_rounds}
    for key, what, b, cap in (
            ("init_frame_device_ms",
             f"init frame's matrix, {init_rounds} rounds", init_b, 2000),
            ("half_rounds_device_ms",
             f"bench frame 2 capped at {rounds // 2} rounds", bench_b,
             rounds // 2),
            ("no_rounds_device_ms",
             "capped at 0 rounds: launch and staging", bench_b, 0)):
        extra[key] = device_ms(
            lambda: auction_k.auction_solve(b, EPS, cap), K2_REPS)
        log("times", f"K2 auction n={b.shape[0]}, {what}: device time per "
                     f"call (profiler) {extra[key]:.4f} ms")
    # K1 by rows: one track is one CTA (launch and one CTA's chain alone);
    # 3T rows is the single-object bank's 3-scale call.
    scales3 = torch.tensor(SCALES, dtype=torch.float32,
                           device=boxes0.device).repeat_interleave(t)
    for key, what, coords_n in (
            ("one_cta_device_ms", "T=1 (one CTA: launch and its chain)",
             roi_k.sample_coords(boxes0[:1], 2.5, s1, hw)),
            ("three_scales_device_ms", f"T={3 * t} (boxes x 3 scales)",
             roi_k.sample_coords(boxes0.repeat(3, 1), 2.5, s1, hw,
                                 scales3))):
        times["roi_extract"][key] = device_ms(
            lambda: roi_k._resample_cuda(levels_u8, hw, *coords_n), 50)
        log("times", f"K1 ROI resample {what} u8 1080p: device time per "
                     f"call (profiler) {times['roi_extract'][key]:.4f} ms")
    # The pyramid that every extraction of the single-object bank builds
    # (float32, from the gray frame; twice a frame at the refined site),
    # beside the u8 one that the tracker step builds once a frame.
    gray_f32 = patch_ops.to_gray(frames[0])
    for what, img in (("float32 (a KCF-bank extraction)", gray_f32),
                      ("u8 (a tracker step)", frames[0])):
        dev_ms = device_ms(lambda: roi_k.build_pyramid(img), 20)
        call_ms = statistics.median(
            event_ms(lambda: roi_k.build_pyramid(img), 20))
        log("times", f"build_pyramid {HEIGHT}x{WIDTH} {what}: device time "
                     f"per call (profiler) {dev_ms:.4f} ms, per call with "
                     f"host time (CUDA event pairs) {call_ms:.4f} ms")
    per_round = ((times["auction_solve"]["device_ms"]
                  - extra["no_rounds_device_ms"]) / rounds)
    log("times", f"K2 per round at n={n}: {1000 * per_round:.2f} us "
                 f"((device time at {rounds} rounds - at 0 rounds) / "
                 f"{rounds})")
    times["auction_solve"].update(extra)
    for key, what, info in (
            ("roi_extract", f"K1 ROI u8 S={s1}",
             roi_k.launch_info(True, s1)),
            ("auction_solve", f"K2 auction n={n}", auction_k.launch_info(n)),
            ("roi_extract_scales", f"K3 3-scale ROI u8 S={s1}",
             roi_k.scales_launch_info(True, s1)),
            ("kcf_detect", f"K4 fused detect C={c} S={s}",
             kcf_k.detect_launch_info(c, s)),
            ("kcf_train", f"K5 fused train C={c} S={s}",
             kcf_k.train_launch_info(c, s)),
            ("kcf_train_shift", "K6 train_shift C=1 S=64",
             kcf_k.train_shift_launch_info()),
            ("kcf_search", "K8 search C=1 S=64",
             kcf_k.search_launch_info())):
        log("times", kernel_line(what, info))
        times[key]["launch"] = info
    return times


# --- detector training (train) and the application layer (cli) -----------

# Tolerances of the train phase against TRAIN_DUMP (PERF.md §6): the
# loss of step 0 1e-4 relative; every gradient leaf's L2 norm 1e-2 relative
# to JAX's and to the exact (float64) norm: a float32 gradient norm of
# yolov3-tiny's first blocks at 416 is only known to ~1e-3 on the CPU (JAX
# 2.0e-3, the port 6.9e-4 from float64 on this batch) and to a few 1e-3
# with cuDNN's algorithms; the two heads' full gradients 1e-4 of their largest
# magnitude; the running statistics after step 0 1e-4 absolute.  After
# TRAIN_STEPS Adam steps: the losses of steps 1-2 and each running-
# statistics vector (L2) 1e-2 relative: Adam moves an element by ~lr
# whatever its gradient's size, so gradients of undetermined sign leave
# parameters apart by up to 2 lr, and the batch statistics and losses of
# later steps with them (the CPU run: 1.2e-4 and 3.6e-3).
TRAIN_LOSS_TOL, TRAIN_NORM_TOL, TRAIN_HEAD_TOL = 1e-4, 1e-2, 1e-4
TRAIN_STATS0_TOL, TRAIN_STEP_TOL, TRAIN_STATS_TOL = 1e-4, 1e-2, 1e-2
TRAIN_SPEED = ((16, "float32"), (32, "float32"), (16, "bfloat16"),
               (32, "bfloat16"))
TRAIN_SPEED_REPS, TRAIN_SPEED_STEPS = 5, 3
# tests/test_train.py:122's toy run: 300 Adam steps at 2e-3 of yolov2-tiny
# at 64 (1 class, BatchNorm momentum 0.9) on 8 images of one rectangle.
TOY_STEPS = 300
# The CLI's synthetic run and the JAX CLI's metrics on it
# (`python tests/test_torch_cli.py regen-cli-golden`).
CLI_GOLDEN = TRAIN_DUMP.with_name("cli_jax_v1.json")
CLI_HF = ["--feature", "hog", "--cell-size", "4", "--scale-step", "1.05",
          "--kcf-impl", "pallas", "--train-site", "refined"]


def adam_at(lr: float):
    return lambda params: torch.optim.Adam(params, lr=lr)


def seed_params(spec, seed: int = 0) -> dict:
    """interop.numpy_yolo_params(spec, seed) as the net's state dict."""
    return interop.yolo_params_from_jax(interop.numpy_yolo_params(spec, seed))


def train_state(spec, dev, seed: int = 0, mesh=None, make_optimizer=None):
    """A train state from seed_params(spec, seed) with make_optimizer
    (default Adam(TRAIN_LR)) on dev (replicated over a "batch" mesh)."""
    return train.train_state_from_params(
        spec, make_optimizer or adam_at(TRAIN_LR), seed_params(spec, seed),
        device=dev, mesh=mesh)


def train_batch(dev, spec, dump):
    """The dump's images (NHWC) and build_targets on the card; holds the
    port's own resize of the scenes to the dump's images (1e-4)."""
    frames, boxes, classes, vis = train_scenes()
    gray = torch.as_tensor(dump["images"], device=dev)
    resize_err = float((train_images(frames, device=dev)[..., 0]
                        - gray).abs().max())
    if resize_err > 1e-4:
        raise AssertionError(f"train: the port's resize is {resize_err:.3g} "
                             "from the dump's images (limit 1e-4)")
    tgt = [torch.as_tensor(t, device=dev)
           for t in train.build_targets(spec, boxes, classes, vis)]
    return gray[..., None].repeat(1, 1, 1, 3).contiguous(), tgt, resize_err


def toy_batch(rng, b: int = 8, s: int = 64):
    """tests/test_train.py's toy task: one bright rectangle an image."""
    images = rng.random((b, s, s, 3)).astype(np.float32) * 0.2
    gt_boxes = np.zeros((b, 1, 4), np.float32)
    for i in range(b):
        cx, cy = rng.uniform(16, 48, 2)
        w, h = rng.uniform(12, 20, 2)
        x0, x1 = int(cx - w / 2), int(cx + w / 2)
        y0, y1 = int(cy - h / 2), int(cy + h / 2)
        images[i, y0:y1, x0:x1] = 0.9
        gt_boxes[i, 0] = (cx, cy, w, h)
    return images, gt_boxes, np.zeros((b, 1), int), np.ones((b, 1), bool)


def toy_map(model, images, gb, gc, gv) -> float:
    dets, valid, classes = detector.detect_batch(model, images, (64, 64), 8,
                                                 0.45, 0.1)
    dets, valid, classes = (x.cpu().numpy() for x in (dets, valid, classes))
    preds = [(dets[i][valid[i], :4], dets[i][valid[i], 4],
              classes[i][valid[i]]) for i in range(len(images))]
    gts = [(gb[i][gv[i]], gc[i][gv[i]]) for i in range(len(images))]
    return metrics.detection_map(preds, gts, num_classes=1)["map"]


def train_speed(dev, card, images, tgt):
    """images/s and ms a step at TRAIN_SPEED's batches and dtypes (the
    dump's scenes tiled), interleaved samples of TRAIN_SPEED_STEPS steps;
    peak device memory of a step.  Returns the runs of the largest batch,
    for train_profile."""
    runs, peaks = {}, {}
    for b, dt in TRAIN_SPEED:
        spec = YoloSpec(**TRAIN_SPEC, dtype=dt)
        state, step = train_state(spec, dev), train.make_train_step(spec)
        reps = b // len(images)
        x = images.repeat(reps, 1, 1, 1)
        t = [y.repeat(reps, 1, 1, 1, 1) for y in tgt]
        step(state, x, t)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step(state, x, t)
        torch.cuda.synchronize()
        peaks[(b, dt)] = (torch.cuda.max_memory_allocated(), base)

        def run(state=state, step=step, x=x, t=t):
            for _ in range(TRAIN_SPEED_STEPS):
                step(state, x, t)
        runs[(b, dt)] = run
    secs = interleaved(runs, TRAIN_SPEED_REPS)
    for (b, dt), s in secs.items():
        ms = [1000 * v / TRAIN_SPEED_STEPS for v in s]
        med = statistics.median(ms)
        peak, base = peaks[(b, dt)]
        log("train", f"speed {dt} batch {b}: {b * 1000 / med:.1f} images/s, "
                     f"{med:.2f} ms a step (median of {len(ms)} samples of "
                     f"{TRAIN_SPEED_STEPS} steps; {min(ms):.2f}-"
                     f"{max(ms):.2f} ms, spread {max(ms) / min(ms):.2f}x); "
                     f"peak device memory of a step {peak / 2**20:.0f} MiB "
                     f"({(peak - base) / 2**20:.0f} MiB over the "
                     f"{base / 2**20:.0f} MiB held before it); {card}")
    top = max(b for b, _ in runs)
    return {k: fn for k, fn in runs.items() if k[0] == top}


def train_profile(runs: dict) -> None:
    """Launches and busy share of TRAIN_SPEED_STEPS profiled steps (after
    the times and profile phases: the profiler loses device records after
    long sessions)."""
    for key in runs:
        kernels, wall_us, _ = profiled(runs[key])
        busy = sum(r[1] for r in kernels)
        launches = sum(r[2] for r in kernels) / TRAIN_SPEED_STEPS
        log("train", f"profile {key[1]} batch {key[0]}, {TRAIN_SPEED_STEPS} "
                     f"steps: {launches:.0f} kernel launches a step; device "
                     "kernels "
                     f"{busy / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms wall "
                     f"under the profiler ({100 * busy / wall_us:.1f}% busy)")
        for name, us, count in kernels[:6]:
            log("train", f"  {us / 1e3:9.3f} ms  x{count:<5d} {name[:90]}")


def phase_train(dev, card):
    """Detector training at full width (see TRAIN_DUMP): parity with the
    JAX dump, int8 refused, the toy convergence, checkpoint/resume of the
    train state, and the training speed.  Returns train_speed's runs."""
    t_phase = time.perf_counter()
    spec = YoloSpec(**TRAIN_SPEC)
    with np.load(TRAIN_DUMP) as z:
        dump = {k: z[k] for k in z.files}
    images, tgt, resize_err = train_batch(dev, spec, dump)
    state, step = train_state(spec, dev), train.make_train_step(spec)
    losses = []
    for i in range(TRAIN_STEPS):
        state, loss = step(state, images, tgt)
        losses.append(float(loss))
        if i == 0:          # the step's gradients stay in .grad until the next
            grads = {n: p.grad.detach().clone()
                     for n, p in state.model.named_parameters()}
            sd = state.model.state_dict()
            stats0_err = max(float(np.abs(sd[k[7:]].cpu().numpy() - v).max())
                             for k, v in dump.items()
                             if k.startswith("stats0/"))
    loss_err = abs(losses[0] - float(dump["loss0"])) / float(dump["loss0"])
    norm_err = {n: abs(float(g.norm()) - float(dump[f"grad_norm/{n}"]))
                / float(dump[f"grad_norm/{n}"]) for n, g in grads.items()}
    exact_err = {n: abs(float(g.norm()) - float(dump[f"grad_norm64/{n}"]))
                 / float(dump[f"grad_norm64/{n}"]) for n, g in grads.items()}
    jax_exact = max(abs(float(dump[f"grad_norm/{n}"])
                        - float(dump[f"grad_norm64/{n}"]))
                    / float(dump[f"grad_norm64/{n}"]) for n in grads)
    det_flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        det_state = train_state(spec, dev)
        train.yolo_loss(det_state.model, images, tgt, spec,
                        train=True).backward()
        det_err = max(abs(float(p.grad.norm())
                          - float(dump[f"grad_norm64/{n}"]))
                      / float(dump[f"grad_norm64/{n}"])
                      for n, p in det_state.model.named_parameters())
    finally:
        torch.backends.cudnn.deterministic = det_flag
    del det_state
    head_err = max(float((grads[k[5:]].cpu() - torch.as_tensor(dump[k])
                          ).abs().max() / np.abs(dump[k]).max())
                   for k in dump if k.startswith("grad/"))
    step_err = max(abs(a - b) / abs(b)
                   for a, b in zip(losses[1:], dump["losses"][1:]))
    sd = state.model.state_dict()
    stats_err = max(float(np.linalg.norm(sd[k[6:]].cpu().numpy() - v)
                          / np.linalg.norm(v))
                    for k, v in dump.items() if k.startswith("stats/"))
    stats_abs = max(float(np.abs(sd[k[6:]].cpu().numpy() - v).max())
                    for k, v in dump.items() if k.startswith("stats/"))
    worst = max(norm_err, key=norm_err.get)
    worst64 = max(exact_err, key=exact_err.get)
    log("train", f"yolov3-tiny 80 classes at 416, batch {len(images)}, Adam "
                 f"{TRAIN_LR}, against the JAX dump ({TRAIN_DUMP.name}): "
                 f"resize {resize_err:.3g}; step 0 loss {losses[0]:.6f} "
                 f"(JAX {float(dump['loss0']):.6f}, rel {loss_err:.3g}); "
                 f"gradient norms of {len(norm_err)} leaves rel <= "
                 f"{norm_err[worst]:.3g} ({worst}), from the float64 norms "
                 f"<= {exact_err[worst64]:.3g} ({worst64}; JAX's "
                 f"{jax_exact:.3g}; with cudnn.deterministic "
                 f"{det_err:.3g}); heads' gradients "
                 f"{head_err:.3g} of their largest; running statistics after "
                 f"step 0 max |diff| {stats0_err:.3g}; losses {losses} vs "
                 f"{dump['losses'].tolist()} (steps 1-2 rel {step_err:.3g}); "
                 f"running statistics after {TRAIN_STEPS} steps rel (L2) "
                 f"{stats_err:.3g}, max |diff| {stats_abs:.3g}")
    for what, err, lim in (("loss", loss_err, TRAIN_LOSS_TOL),
                           ("gradient norm", norm_err[worst],
                            TRAIN_NORM_TOL),
                           ("gradient norm against float64",
                            exact_err[worst64], TRAIN_NORM_TOL),
                           ("head gradient", head_err, TRAIN_HEAD_TOL),
                           ("step-0 statistics", stats0_err,
                            TRAIN_STATS0_TOL),
                           ("later loss", step_err, TRAIN_STEP_TOL),
                           ("running statistics", stats_err,
                            TRAIN_STATS_TOL)):
        if not err <= lim:
            raise AssertionError(f"train: {what} {err:.3g} > {lim}")

    try:
        train.init_train_state(YoloSpec(**TRAIN_SPEC, dtype="int8"),
                               adam_at(TRAIN_LR), device=dev)
        raise AssertionError("train: int8 was not refused")
    except ValueError as exc:
        log("train", f"int8 refused: {str(exc)[:60]}...")

    # the toy convergence of tests/test_train.py:122
    toy = YoloSpec("yolov2-tiny", num_classes=1, input_size=64,
                   bn_momentum=0.9)
    t0 = time.perf_counter()
    tstate = train.init_train_state(toy, adam_at(2e-3), seed=0, device=dev)
    tstep = train.make_train_step(toy)
    ti, gb, gc, gv = toy_batch(np.random.default_rng(0))
    timg = torch.as_tensor(ti, device=dev)
    ttgt = [torch.as_tensor(t, device=dev)
            for t in train.build_targets(toy, gb, gc, gv)]
    map0 = toy_map(tstate.model, timg, gb, gc, gv)
    for _ in range(TOY_STEPS):
        tstep(tstate, timg, ttgt)
    map1 = toy_map(tstate.model, timg, gb, gc, gv)
    log("train", f"toy run (yolov2-tiny at 64, {TOY_STEPS} steps in "
                 f"{time.perf_counter() - t0:.1f} s): mAP@0.5 {map0:.4f} -> "
                 f"{map1:.4f} (gate > {max(map0 + 0.2, 0.3):.4f})")
    if not map1 > max(map0 + 0.2, 0.3):
        raise AssertionError(f"train: toy mAP {map0} -> {map1}")

    # checkpoint: the train state after step 2, deterministic cuDNN
    det_flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            a = train_state(spec, dev)
            for _ in range(2):
                step(a, images, tgt)
            train.save_train_state(f"{tmp}/train", a)
            b = train.load_train_state(f"{tmp}/train",
                                       train_state(spec, dev, seed=1))
            for _ in range(2):
                la, lb = float(step(a, images, tgt)[1]), float(
                    step(b, images, tgt)[1])
                if la != lb:
                    raise AssertionError(f"train: resumed loss {lb} != {la}")
            sa, sb = a.model.state_dict(), b.model.state_dict()
            if not all(torch.equal(sa[k], sb[k]) for k in sa):
                raise AssertionError("train: resumed state differs")
    finally:
        torch.backends.cudnn.deterministic = det_flag
    log("train", "checkpoint: saved after step 2, loaded into a fresh "
                 "state, steps 3-4 bit-equal to the uninterrupted run "
                 "(cudnn.deterministic)")
    del a, b, state
    runs = train_speed(dev, card, images, tgt)
    log("train", f"phase {time.perf_counter() - t_phase:.1f} s")
    return runs


def phase_pipeline_resume(dev, frames, d, v, cfg, default_out):
    """save_pipeline of the default bank after frame 31 plus a yolov3-tiny
    state dict; resuming gives frames 32-63 bit-equal to the uninterrupted
    run (default_out, phase e2e's run_sequence)."""
    bank, _ = scan.run_sequence(bank_mod.empty_bank(cfg, device=dev),
                                frames[:32], d[:32], v[:32], cfg)
    det_sd = detector.YoloDetector.random_init(
        YoloSpec(**TRAIN_SPEC), device=dev).model.state_dict()
    with tempfile.TemporaryDirectory() as tmp:
        checkpoint.save_pipeline(f"{tmp}/pipe", bank, det_sd, cfg)
        bank2, det2, cfg2 = checkpoint.load_pipeline(
            f"{tmp}/pipe", bank_mod.empty_bank(cfg, device=dev))
    if cfg2 != cfg or not all(torch.equal(det2[k], det_sd[k])
                              for k in det_sd):
        raise AssertionError("pipeline: config or detector state differs")
    _, out = scan.run_sequence(bank2, frames[32:], d[32:], v[32:], cfg)
    same = all(torch.equal(getattr(out, f), getattr(default_out, f)[32:])
               for f in ("ids", "valid", "boxes"))
    log("train", f"pipeline checkpoint: bank after frame 31 + yolov3-tiny "
                 f"state saved and loaded, frames 32-63 bit-equal to the "
                 f"uninterrupted run: {same}")
    if not same:
        raise AssertionError("pipeline: resumed frames differ")


def cli_lines(argv) -> list[str]:
    """cli.main(argv) in this process -> its output lines; raises on a
    nonzero exit."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"cli {argv}: exit {rc}")
    return buf.getvalue().splitlines()


def cli_run(argv) -> tuple[dict, dict, float]:
    """cli.main(argv) in this process, every launch count set to 0 just
    before it: (its metrics line, the launches, seconds)."""
    reset_counts()
    t0 = time.perf_counter()
    lines = cli_lines(argv)
    torch.cuda.synchronize()
    return json.loads(lines[-1]), read_counts(), time.perf_counter() - t0


def native_checks(dev, frames, d, v, cfg, sched_check):
    """The native runtime on this machine: the g++ build, assign against
    scipy_assign on the bench run's first 3 cost matrices, and the stream
    scheduler feeding the serving step."""
    lib, secs = native.build()
    if not native.ensure_built():
        raise AssertionError("native: the library did not load")
    log("cli", f"native: {lib.name} built by g++ in {secs:.2f} s")
    seen, solve = [], assignment.auction_assign_stats

    def capture(cost, feasible, *a, **kw):
        seen.append((cost.cpu().numpy().astype(np.float64),
                     feasible.cpu().numpy()))
        return solve(cost, feasible, *a, **kw)

    assignment.auction_assign_stats = capture
    try:
        scan.run_sequence(bank_mod.empty_bank(cfg, device=dev), frames[:3],
                          d[:3], v[:3], cfg)
    finally:
        assignment.auction_assign_stats = solve
    matches = 0
    for cost, feas in seen:
        got = native.assign(cost[0], feas[0])
        if not np.array_equal(got, assignment.scipy_assign(cost[0],
                                                           feas[0])):
            raise AssertionError("native: assign differs from scipy_assign")
        matches += int((got >= 0).sum())
    log("cli", f"native: assign equals scipy_assign on the bench run's "
               f"first {len(seen)} cost matrices ({seen[0][0].shape[1:]}, "
               f"{matches} matches)")
    s_frames, s_d, s_v, s_cfg, s_ids, s_valid, s_boxes = sched_check
    n_str, n = s_frames.shape[:2]
    host = s_frames.cpu().numpy()
    sched = native.StreamScheduler(n_str, host.shape[2:], capacity=n)
    if not sched._native:
        raise AssertionError("native: the scheduler took its fallback")
    for f in range(n):
        for s in range(n_str):
            sched.push(s, host[s, f])
    banks = serve.make_stream_banks(n_str, s_cfg, device=dev)
    gather_ms, same = [], True
    for f in range(n):
        t0 = time.perf_counter()
        batch, fresh = sched.gather()
        gather_ms.append(1000 * (time.perf_counter() - t0))
        if not fresh.all() or not np.array_equal(batch, host[:, f]):
            raise AssertionError(f"native: gathered batch {f} differs")
        banks, out = serve.multi_stream_step(
            banks, torch.as_tensor(batch, device=dev), s_d[:, f], s_v[:, f],
            s_cfg)
        if not (torch.equal(out.ids, s_ids[:, f])
                and torch.equal(out.valid, s_valid[:, f])):
            raise AssertionError(f"native: scheduled frame {f} differs")
        same &= torch.equal(out.boxes, s_boxes[:, f])
    log("cli", f"native: StreamScheduler gathered {n} batches of {n_str} x "
               f"{host.shape[2]}x{host.shape[3]} u8 bit-equal to what was "
               f"pushed, {statistics.median(gather_ms):.2f} ms a batch "
               f"(median; {min(gather_ms):.2f}-{max(gather_ms):.2f}); "
               "multi_stream_step on them: ids and valid equal to the serve "
               f"phase's run, boxes bit-equal: {same}")
    if not same:
        raise AssertionError("native: scheduled boxes differ")


def phase_cli(dev, frames, d, v, cfg, sched_check, frames_np, dets_list,
              gt_boxes, vis):
    """The application layer on the card: `python -m tpu_mot_torch mot
    --synthetic` as a subprocess against the JAX CLI's MOTA, the same run
    and the HF flags in process with the launch counts, the native
    runtime, and (with OpenCV) --seq, eval, otb and video."""
    t_phase = time.perf_counter()
    golden = json.loads(CLI_GOLDEN.read_text())
    args = golden["args"]
    repo = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(repo))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "tpu_mot_torch", *args],
                          cwd=repo, env=env, capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"cli: exit {proc.returncode}: {proc.stderr}")
    lines = proc.stdout.splitlines()
    m = json.loads(lines[-1])
    want = golden["metrics"]["mota"]
    log("cli", f"python -m tpu_mot_torch {' '.join(args)}: exit 0 in "
               f"{time.perf_counter() - t0:.1f} s; {lines[0]}; MOTA "
               f"{m['mota']} HOTA {m['hota']} (JAX CLI {want} / "
               f"{golden['metrics']['hota']}, gate >= {want - 0.01:.4f})")
    if not m["mota"] >= want - 0.01:
        raise AssertionError(f"cli: MOTA {m['mota']} < {want} - 0.01")
    n = args[args.index("--frames") + 1]
    for name, argv, n_frames, kernels in (
            ("default", args, int(n),
             ("roi_extract", "auction_solve", "kcf_train_shift",
              "kcf_search")),
            ("HF", [*args[:args.index("--frames")], "--frames", "32",
                    *args[args.index("--frames") + 2:], *CLI_HF], 32,
             KERNELS[:5])):
        m, counts, secs = cli_run(argv)
        want_counts = {k: (n_frames if k in kernels else 0) for k in KERNELS}
        log("cli", f"in process, {name} flags, {n_frames} frames in "
                   f"{secs:.1f} s: MOTA {m['mota']}; launches {counts}")
        if counts != want_counts:
            raise AssertionError(f"cli {name}: launches {counts}, expected "
                                 f"{want_counts}")
        if name == "default" and not m["mota"] >= want - 0.01:
            raise AssertionError(f"cli {name}: MOTA {m['mota']}")
    native_checks(dev, frames, d, v, cfg, sched_check)
    try:
        import cv2  # noqa: F401
    except ImportError:
        log("cli", "cli: no cv2 on this machine: --seq, eval, otb, video "
                   "not run")
    else:
        cli_with_cv2(frames_np, dets_list, gt_boxes, vis)
    log("cli", f"phase {time.perf_counter() - t_phase:.1f} s")


def write_mot_dir(root: Path, frames_u8, dets_list, gt_boxes, vis) -> None:
    """A MOT16-format sequence directory: img1/ PNGs (lossless, so the
    frames are the fixture's), det/det.txt, gt/gt.txt."""
    import cv2
    for sub in ("img1", "det", "gt"):
        (root / sub).mkdir(parents=True)
    for i, fr in enumerate(frames_u8, start=1):
        cv2.imwrite(str(root / "img1" / f"{i:06d}.png"), fr)
    with open(root / "det" / "det.txt", "w") as f:
        for fi, dd in enumerate(dets_list, start=1):
            for cx, cy, w, h, s in dd:
                f.write(f"{fi},-1,{cx - w / 2:.2f},{cy - h / 2:.2f},"
                        f"{w:.2f},{h:.2f},{s:.3f},-1,-1,-1\n")
    with open(root / "gt" / "gt.txt", "w") as f:
        for fi in range(1, len(frames_u8) + 1):
            for k in np.where(vis[fi - 1])[0]:
                cx, cy, w, h = gt_boxes[fi - 1, k]
                f.write(f"{fi},{k + 1},{cx - w / 2:.2f},{cy - h / 2:.2f},"
                        f"{w:.2f},{h:.2f},1,1,1.0\n")


def cli_with_cv2(frames_u8, dets_list, gt_boxes, vis, dev_args=()):
    """mot --seq and eval --root over a MOT16-format directory of the bench
    fixture (the MOTA gate), otb on a 480 x 640 clip with --gt, video on a
    32-frame 720p mp4 with --det-stride 3."""
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "train"
        write_mot_dir(root / "BENCH-01", frames_u8, dets_list, gt_boxes, vis)
        common = ["--max-dets", "160", *dev_args]
        m = json.loads(cli_lines(["mot", "--seq", str(root / "BENCH-01"),
                                  "--score", *common])[-1])
        over = json.loads(cli_lines(["eval", "--root", str(root),
                                     *common])[-1])
        log("cli", f"mot --seq (MOT16 directory of the bench fixture): MOTA "
                   f"{m['mota']} HOTA {m['hota']}; eval --root: OVERALL MOTA "
                   f"{over['mota']} over {over['frames']} frames (gate >= "
                   f"{M_REF - 0.01:.4f})")
        if not min(m["mota"], over["mota"]) >= M_REF - 0.01:
            raise AssertionError(f"cli --seq/eval: MOTA {m['mota']}, "
                                 f"{over['mota']}")
        clip, boxes = single_object_clip()
        import cv2
        (Path(tmp) / "otb").mkdir()
        for i, fr in enumerate(clip, start=1):
            cv2.imwrite(str(Path(tmp) / "otb" / f"{i:04d}.png"),
                        (fr * 255).astype(np.uint8))
        tl = boxes.copy()
        tl[:, :2] -= tl[:, 2:] / 2
        np.savetxt(Path(tmp) / "gt.txt", tl, delimiter=",", fmt="%.2f")
        x, y, w, h = tl[0]
        p = json.loads(cli_lines(["otb", "--seq", str(Path(tmp) / "otb"),
                                  "--box", f"{x},{y},{w},{h}", "--gt",
                                  str(Path(tmp) / "gt.txt"),
                                  *dev_args])[-1])
        log("cli", f"otb on a {clip.shape[1]}x{clip.shape[2]} clip of "
                   f"{len(clip)} frames: precision@20 "
                   f"{p['precision@20px']}, mean IoU {p['mean_iou']:.4f}")
        if p["precision@20px"] < 0.99:
            raise AssertionError(f"cli otb: {p}")
        e_frames = e2e_fixture()[0]
        mp4 = str(Path(tmp) / "clip.mp4")
        viz.write_video(mp4, [(f, []) for f in e_frames], fps=30)
        lines = cli_lines(["video", "--input", mp4, "--det-stride", "3",
                           "--max-dets", "64", *dev_args])
        log("cli", f"video ({len(e_frames)} frames of 720p mp4, "
                   f"--det-stride 3, yolov3-tiny seeded): {lines[-1]}")


OUR_KERNELS = ("roi_kernel", "roi_scales_kernel", "auction_kernel",
               "kcf_detect_kernel", "kcf_detect_fft16_kernel",
               "kcf_train_kernel", "kcf_train_fft16_kernel",
               "kcf_train_shift_kernel", "kcf_search_kernel")


def profiled(fn) -> tuple[list, float, object]:
    """fn() once under the profiler: its device kernels (device_kernels),
    the call's wall time in us, and the profile."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return device_kernels(prof), wall_us, prof


def phase_profile(name, run, n_frames: int = 16):
    """Device time by kernel while run() tracks a window of n_frames."""
    checks = assignment.warm_checks
    kernels, wall_us, prof = profiled(run)
    # Reads of a device scalar on the host: each one waits for the stream.
    reads = sum(e.count for e in prof.key_averages()
                if e.key == "aten::_local_scalar_dense")
    log("profile", f"{name}, {n_frames} frames: {reads} reads of a device "
                   "scalar on the host (aten::_local_scalar_dense), "
                   f"{assignment.warm_checks - checks} of them loop checks "
                   "of the warm auction")
    busy = sum(r[1] for r in kernels)
    ours = {k: sum(us for key, us, _ in kernels if k in key)
            for k in OUR_KERNELS}
    ours_txt = ", ".join(f"{k} {us / 1e3:.3f} ms" for k, us in ours.items()
                         if us > 0)
    log("profile", f"{name}, {n_frames} frames: "
                   f"{sum(r[2] for r in kernels) / n_frames:.1f} kernel "
                   f"launches a frame; device kernels {busy / 1e3:.3f} ms of "
                   f"{wall_us / 1e3:.3f} ms wall under the profiler "
                   f"({100 * busy / wall_us:.1f}% busy), {len(kernels)} "
                   f"kernel kinds; {ours_txt}")
    for key, us, count in kernels[:12]:
        log("profile", f"  {us / 1e3:9.3f} ms  x{count:<6d} {key[:90]}")


def main() -> int:
    # device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this smoke test runs only on the card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    card = bench_tool.card_line()
    log("device", f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
                  f"torch {torch.__version__} CUDA {torch.version.cuda}")

    # build
    path, secs, out = _build.build()
    _build.load()
    ptxas = [ln.strip() for ln in out.splitlines()
             if "registers" in ln or "Compiling entry" in ln
             or "bytes smem" in ln or "spill" in ln]
    log("build", f"{path.name}: nvcc {secs:.1f} s; ptxas: "
                 f"{' | '.join(ptxas) or 'reused build'}")

    t0 = time.perf_counter()
    frames_np, d_np, v_np, gt_boxes, vis, dets_list, cfg = bench_fixture()
    frames = torch.as_tensor(frames_np, device=dev)
    d = torch.as_tensor(d_np, device=dev)
    v = torch.as_tensor(v_np, device=dev)
    log("data", f"bench fixture {frames_np.shape} u8 rendered and uploaded in "
                f"{time.perf_counter() - t0:.1f} s")

    # kernels against their plain versions
    boxes0 = torch.as_tensor(gt_boxes[0], device=dev)
    levels_u8, levels_f32, roi_err = phase_roi(dev, frames[0], boxes0)
    roi3_err = phase_roi3(dev, levels_u8, levels_f32, boxes0)
    bench_b = record_benefits(frames, d, v, cfg, 3)
    t0 = time.perf_counter()
    hard = bench_hard_fixture.fixture()
    hard_b = record_benefits(*(torch.as_tensor(x, device=dev)
                               for x in (hard.frames, hard.dets,
                                         hard.valid)), hard.config(), 3)
    del hard
    log("data", f"hard fixture rendered, its first 3 frames' benefit "
                f"matrices {tuple(hard_b[0].shape)} captured in "
                f"{time.perf_counter() - t0:.1f} s")
    auction_err = phase_auction(dev, bench_b, hard_b)
    cfg_hf = heavy_config(cfg, "HF")
    hf_inputs = record_kcf_inputs(frames, d, v, cfg_hf, 3)
    kcf_err = phase_kcf(hf_inputs, gray_kcf_inputs(frames, boxes0, cfg),
                        search_inputs(frames, boxes0, cfg), cfg_hf, cfg)
    epilogue_row = phase_epilogue(dev)

    # end to end: default, then the heavy modes
    launches, mota, h_all, default_out = phase_e2e(
        frames, d, v, cfg, gt_boxes, vis, dets_list, frames_np)
    heavy_launches = phase_e2e_heavy(frames, d, v, cfg, gt_boxes, vis)

    # the association configurations on the class fixture
    t0 = time.perf_counter()
    a_np, a_d_np, a_v_np, a_gt, a_vis, _, a_cfg = assoc_fixture()
    a_frames = torch.as_tensor(a_np, device=dev)
    a_d = torch.as_tensor(a_d_np, device=dev)
    a_v = torch.as_tensor(a_v_np, device=dev)
    del a_np
    log("data", f"class fixture {tuple(a_frames.shape)} u8 rendered and "
                f"uploaded in {time.perf_counter() - t0:.1f} s")
    phase_e2e_assoc(a_frames, a_d, a_v, a_cfg, a_gt, a_vis)

    # the detector path: bench_e2e.py's fixture, detect -> track
    detect_run, e2e_first = phase_e2e_detect(dev, card)

    # the single-object flow
    phase_kcf_tracker()
    phase_kcf_bank(dev, frames, gt_boxes)

    # multi-stream serving: configs[4] on one card
    served = phase_serve(dev, card, default_out)

    # the multi-device contract: sharded serving and DP training
    dist = phase_dist(dev, card, served.pop("dist_refs"))

    # detector training at full width, checkpoints, the application layer
    sched_check = served.pop("sched_check")
    train_runs = phase_train(dev, card)
    phase_pipeline_resume(dev, frames, d, v, cfg, default_out)
    phase_cli(dev, frames, d, v, cfg, sched_check, frames_np, dets_list,
              gt_boxes, vis)
    del sched_check

    # the measuring entry points' twins, then times
    twins = phase_bench(card, e2e_first)
    global_row = phase_tools(card, hard_b[-1])
    phase_sweeps(card, frames, d, v, cfg)
    times = phase_times(frames, d, v, cfg, levels_u8, boxes0, bench_b,
                        hf_inputs, (a_frames, a_d, a_v, a_cfg), twins)
    windows = served.pop("windows")
    serve_rows = serve_kernel_times(**served)
    serve_rows += dist_kernel_times(**dist)
    for name, (fr, dd, vv, c) in (
            ("default", (frames, d, v, cfg)),
            ("HF", (frames, d, v, cfg_hf)),
            ("AW", (a_frames, a_d, a_v, a_cfg.replace(**ASSOC["AW"])))):
        phase_profile(name, lambda: scan.run_sequence(
            bank_mod.empty_bank(c, device=dev), fr[:16], dd[:16], vv[:16],
            c))
    phase_profile_detect(*detect_run)
    serve_profile(windows)
    train_profile(train_runs)


    hf = heavy_launches["HF"]
    rows = [
        ("roi_extract", "tpu_mot_torch/csrc/roi.cu",
         "tpu_mot/kernels/roi.py:465", launches["roi_extract"], roi_err, {}),
        ("roi_extract_scales", "tpu_mot_torch/csrc/roi.cu",
         "tpu_mot/kernels/roi.py:346", hf["roi_extract_scales"], roi3_err,
         {}),
        ("auction_solve", "tpu_mot_torch/csrc/auction.cu",
         "tpu_mot/kernels/auction.py:107", launches["auction_solve"],
         auction_err["shared"], {"err_kind": "col_of and iters"}),
        ("kcf_detect", "tpu_mot_torch/csrc/kcf.cu",
         "tpu_mot/kernels/kcf.py:260", hf["kcf_detect"],
         kcf_err["response"],
         {"err_kind": "relative to the largest |response|"}),
        ("kcf_train", "tpu_mot_torch/csrc/kcf.cu",
         "tpu_mot/kernels/kcf.py:295", hf["kcf_train"],
         max(kcf_err["xf"], kcf_err["alphaf"]),
         {"err_kind": "relative to the largest |xf| and |alphaf|",
          "rel_err_xf": kcf_err["xf"], "rel_err_alphaf": kcf_err["alphaf"]}),
        ("kcf_train_shift", "tpu_mot_torch/csrc/kcf.cu",
         "none (stage 8's detect-site chain, left to XLA by the JAX package)",
         launches["kcf_train_shift"],
         max(kcf_err["shift_xf"], kcf_err["shift_alphaf"]),
         {"err_kind": "relative to the largest |xf| and |alphaf|",
          "rel_err_xf": kcf_err["shift_xf"],
          "rel_err_alphaf": kcf_err["shift_alphaf"]}),
        ("kcf_search", "tpu_mot_torch/csrc/kcf.cu",
         "none (stage 2's gray search, left to XLA by the JAX package)",
         launches["kcf_search"],
         max(kcf_err["search_zf"], kcf_err["search_response"]),
         {"err_kind": "relative to the largest |zf| and |response|",
          "rel_err_zf": kcf_err["search_zf"],
          "rel_err_response": kcf_err["search_response"]}),
    ]
    print(card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": n, "max_abs_err": err, **times[name], **extra}
        for name, src, rep, n, err, extra in rows] + [
        {"name": "auction_solve_global", "route": "cuda",
         "source": "tpu_mot_torch/csrc/auction.cu",
         "replaces": "tpu_mot/kernels/auction.py:107",
         "max_abs_err": auction_err["global"],
         "err_kind": "col_of and iters", **global_row}, epilogue_row]
        + serve_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
