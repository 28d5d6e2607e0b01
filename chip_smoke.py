#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``aicamera_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--kernels-only] [--only PHASE,...]

Needs one CUDA GPU, the CUDA toolkit (``nvcc``) and the repository around
this file; exits non-zero otherwise. In order it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every kernel of the main path from ``aicamera_tpu_torch/csrc``;
3. holds each kernel, called through the public wrapper the pipeline calls,
   against its plain PyTorch version on the card, bitwise, at the main
   path's geometries at K 1, 2, 4 and 8 frames a launch (the training
   steps' counts among them) and more (misaligned and ragged shapes, both
   kernel variants, the facades' K=1 frame and 2x2 tiles of a 960x540
   frame, the multi-stream dispatch's 32 frames of 720p), and times it
   three ways at seven shapes (``finetune_on_clip``'s K=4 among them)
   (``device_ms``: a CUDA-graph replay over buffers larger than the L2;
   ``ms``: per call through the wrapper; ``host_ms``: the host's share of a
   call), next to the earlier design (``earlier_ms``, the scalar variant's
   ``device_ms``), the plain version, the nearest single PyTorch call, and
   the byte/operation bound;
   ``[assignment]``: the assignment kernel (``csrc/assignment.cu``), its
   default design called through the public ``min_cost_matching`` and
   ``matching_cascade`` on card tensors and its first design
   (``variant="v1"``) through the wrapper, both bitwise against the plain
   versions on the same tensors on 78 problems (``assignment_cases``:
   DeepSORT loads at 128 and 32 track slots, ties with -0.0, nothing
   feasible, one row, R < C, R > C, n = 256 staged and in device memory,
   cascades over 1, 2, 5 and 70 levels, the OC-SORT and ByteTrack costs,
   no eligible row, one row on each of 70 levels, rows that end on clamp
   columns, and 16 of the problems the main path solves, recorded by
   ``scripts/record_assignment_problems.py``), and on every timed problem
   below (the 8 seeded sets of each kind and all 128 recorded ones, the
   probe's outputs too); then the phase probe (a
   second build with ``-DAICAM_ASG_PROBE``: thread 0's cycles by phase,
   solves, rows augmented and augmenting steps a launch) of both designs
   on 8 seeded problems, the 128 recorded ones and a 70-level cascade; both
   designs timed in turns (v1, default, default, v1; graph replays, with
   their spread) on the seeded and the recorded problems; then the default
   design's device ms a solve (graph replay) at the main path's 128x64,
   per call, the plain version's,
   ``scipy.optimize.linear_sum_assignment``'s on the host with the copy,
   and its bound: the larger of the bytes it must move (the R x C cost and
   the masks read once, the outputs written once) and an empty kernel's
   replay; then the batched launch (B = 8 problems, a block each, as the
   8 streams of ``[streams]`` give it: ``assignment_batches``, the recorded
   problems 8 at a time, seeded loads at 128x64 and 32x64, mixed batches
   with no eligible row and every row eligible) bitwise against the plain
   version, the probe's sums per problem on batches, and one batched launch
   timed against the same 8 problems launched one by one, in turns, at
   128x64 and 32x64, with its per-call, plain and scipy times and bound;
   ``[oru]``: OC-SORT's ORU replay kernel (``csrc/oru.cu``), both designs:
   the default (``rows``) through the public ``core.ocsort.oru_replay`` and
   ``v1`` through the wrapper, on card tensors, bitwise equal to each other
   on every lane (NaN where NaN) and each within 1e-5 of each slot's scale
   of ``oru_replay_plain`` on the same tensors (the lanes bitwise the plain
   version counted), on seeded stacks of B = 1 and 8 streams of 128 slots
   with every gap from 0 to 31 on mixed masks, no replay, every slot at gap
   8 and at 31, a ragged stack, degenerate boxes and gaps (s = 0, r = 0,
   NaN in z2, gaps 0 and past ``max_gap``), and every timed set; the phase
   probe of both (a second build with ``-DAICAM_ORU_PROBE``: a slot's load,
   store and replay cycles, cycles a virtual step, a block's cycles); both
   designs timed in turns (v1, rows, rows, v1) by graph replay at B = 1
   and 8 with no replay, gap 8 and gap 31, with the default's per-call ms,
   the plain version's, and the bound (the larger of the launch data's
   bytes and operations and an empty kernel's replay; no single PyTorch
   call computes it); ``[streams]`` adds both designs on the OC-SORT
   stack's own inputs (a spy on ``oru_replay`` over an eager rerun of its
   dispatches: frames that replay, the gap histogram, the two held and
   timed in turns);
   ``[nms]``: the NMS kernel (``csrc/nms.cu``): the one-launch tail
   (class shift, greedy keep, emit) through its wrapper on card tensors,
   its five outputs (num, boxes, scores, labels, kept) bitwise against the
   plain tail's eager and fixed-K forms on the same tensors and against
   the CPU's, and its kept set against the first design's (``keep_v1``),
   on the main path's own candidates (one chunk of the pipeline with the
   kernel's arguments recorded: B = 8, K = 300) and ``nms_tail_cases``:
   the ``[streams]`` dispatch's B = 32, the facade's B = 1, the tiled
   merge at K = 500 by IoU and by IoS with its frame-scaled class offset,
   seeded crowded scenes, the suppression chain of length K, K = 1, 33
   and 1100, none and all valid, NaN, infinite and degenerate boxes,
   overlaps exactly at the threshold, max_det below the kept count and
   past K, K = 4096 and 16384; ``_suppress_and_emit`` on the card against
   the CPU; one call under CUDA's sync debug mode "error"; then, at the
   detect paths' six shapes, three designs timed in turns by graph replay
   (the first design's tail: shift, v1 keep and emit as eager launches;
   the v1 keep alone; the one launch) against the bound (the larger of
   the bytes and the operations the call's data needs and an empty
   kernel's replay), with the time per call, the plain eager tail's (a
   read an iteration) and the plain fixed-K tail's (graph replay); no
   single PyTorch call computes it;
4. drives the main path at full width: ``TrackingPipeline(device="cuda")``
   with YOLOv8n at 640x640, T=128 track slots, N=64 detection slots, a
   100-feature gallery of 512-d features and 32 ReID crops, on seeded
   960x540 frames of moving rectangles, ``chunk_size=8``,
   ``synthetic_load=24``; checks the kernel launch counts, confirmed tracks
   and finite outputs, no tracker read (the DeepSORT step reads nothing
   back); prints FPS, per-stage times (CUDA events), the tracker's ms a
   chunk with its scans replayed from CUDA-graph captures and run frame
   by frame with the host's branches (identical tracks), and the GPU busy share of one more chunk under
   ``torch.profiler``;
5. ``[bucket]``: the main path with ``scan_bucket=32`` (the default), then
   with ``scan_bucket=0``, at the main path's load and at a light load where
   the small pass runs: identical track tuples, FPS and tracker ms of both,
   and the chunks that took the small pass, the skip and the rerun;
6. ``[trackers]``: ByteTrack, BoT-SORT, OC-SORT, Deep OC-SORT and the
   StrongSORT preset (its default ``gmc="affine"``) at full width, 16
   frames each with the cores' thresholds lowered to 0.4 so that the
   synthetic grid (conf 0.5) starts tracks: FPS, tracker ms and host syncs
   per frame, tracks emitted, the kernel once per chunk; no tracker read
   for any core, each chunk one replay of its captured scan, the ORU kernel
   once a frame of OC-SORT and Deep OC-SORT; then the same 16 frames on the
   card in f32 (TF32 off) against the plain CPU path;
7. ``[gmc]``: a seeded panning scene (``scenes.panning_rectangles``, 32
   frames at 960x540): ``estimate_chunk`` on the card with CUDA's sync debug
   mode set to "error" (no read back), against the CPU (A within 1e-4, t
   within 1e-2 px) and against the true camera shift (within 0.5 px), its
   time per chunk; then the pipeline with ``gmc="affine"`` and without for
   DeepSORT, ByteTrack and OC-SORT: FPS, the ``gmc`` stage ms, distinct ids
   per object;
8. ``[facades]``: the reference loop ``YOLODetector.detect`` ->
   ``<facade>.update`` for DeepSORT, StrongSORT, ByteTrack, BoT-SORT,
   OC-SORT and Deep OC-SORT, 32 frames each at full width: FPS, syncs per
   frame (no tracker read for any of the six), the kernel once per frame
   (each ``detect`` a replay of its captured engine, counted per replay),
   the ORU kernel once an OC-SORT update; one ``detect_tiled`` frame (two
   launches); then 8 frames through every facade on the card in f32 against
   the CPU (identical tuples);
   ``[engine]``: ``runtime.engine`` on the facades' frames: the detect
   (K=1) and tiled engines replayed against their eager steps (f32 with
   TF32 off: identical outputs; bf16: identical counts and labels), the
   captured letterbox bitwise against its plain version, ``.cudae`` round
   trips in a temporary directory (detect and ReID, bitwise), the ReID
   engine at batches 1, 5 and 32, a capture that reads the GPU (it must
   raise: the detect step followed by the plain keep's early-exit form;
   the eager detect step itself now captures); times of the eager step and
   the replay, the output copies, the capture, ``device_cost`` beside the
   replay, and the graph nodes; the detect replay in turns against the same
   step captured with the plain fixed-K tail where the kernel runs (its
   replay ms and graph nodes beside the kernel's);
9. ``[cli]``: writes the 64 frames to a ``.npy`` in a temporary directory
   and runs ``aicamera_tpu_torch.cli.main`` on it on the card with
   ``--no_save --profile --checkpoint``, then a ``--resume`` run of 16
   frames, then ``--tracker strongsort`` (its default ``--gmc affine``) for
   16 frames; then writes the frames as an MJPEG ``.avi`` with the port's
   ``VideoWriter`` and runs the default saved run on it with
   ``--draw_detections --profile`` (its draw calls recorded), the same with
   ``--no_save``, and ``--no_save --native_io``: frame counts, tracks, the
   checkpoint file, no presentation error, the kernel once per chunk;
   ``[present]``: the saved video read back with ``VideoReader``: as many
   frames as were processed, each bitwise the port's drawing of that
   frame's recorded calls, JPEG-encoded (it launches nothing; the saving
   run's launches are ``[cli]``'s); decode, encode and draw ms a
   frame at 960x540 and 1920x1080 (q95 4:2:0), the CLI's FPS with saving
   against ``--no_save``, ``NativeVideoReader`` frames/s at 1 and 4
   threads;
10. ``[compare]``: runs the first chunks through the card in f32 (TF32 off)
    and through the plain CPU path, and at chunk 4 against chunk 8 on the
    card, and compares detections and track tuples;
11. ``[streams]``: ``MultiStreamPipeline(device="cuda")`` at BASELINE.json
    config 4's width, 8 streams of 720x1280 (each a seed of
    ``scenes.moving_rectangles``), chunk 4, the main path's model widths and
    DeepSORT defaults: stream-frames per second and ms per dispatch over 4
    dispatches after a warm-up, per-stage ms, tracker ms and syncs per
    stream-frame, the kernel once per dispatch (K=32); the streams as one
    stack: one scan replay a dispatch (two when a bucketed pass reruns),
    2 K assignment launches a replay (a batch of all streams' problems
    each), at most 2 bucket reads and no tracker read a dispatch; the
    stack against the streams stepped one by one through the same stage on
    the same detections, in turns (tracker ms, replays, launches and bucket
    reads a dispatch, identical tracks); the same for a ByteTrack and an
    OC-SORT stack (thresholds 0.4; 3 K or 2 K assignment launches and K ORU
    launches a replay; the stack's tracks and those of the streams one by
    one bitwise equal); a dispatch with two
    streams masked leaves their states bitwise; in f32 (TF32 off) each
    stream equals a ``TrackingPipeline`` on that stream alone; 2 streams x
    1 chunk card f32 against the CPU for DeepSORT, ByteTrack, OC-SORT and
    the StrongSORT preset (GMC); StrongSORT's batched GMC ms per dispatch;
12. ``[serving]``: ``TrackingService`` over the main scene against
    ``process_frames``; ``MultiTenantTrackingService`` at its defaults (4
    slots, 720x1280, chunk 4, 30 ms SLA; f32) with four tenant threads (one
    burst, three paced at 30, 15 and 8 frames/s for 2 s): every tenant
    against a ``TrackingPipeline`` over its frames, a re-leased slot from id
    1, the stats and the queue-wait and cycle percentiles;
13. ``[server]``: ``TrackingHTTPServer`` on 127.0.0.1: health names the
    GPU, 16 raw-frame POSTs against the service itself after a reset,
    stats; 8 JPEG bodies (the port's encoder) and 8 PNG bodies give the
    tracks of their decoded frames POSTed raw, the kernel once a request
    over those 32; a progressive JPEG, a garbage body, a JPEG whose frame
    header claims 65535x65535 and a PNG with a corrupt zlib stream are
    answered 400;
14. ``[quality]``: BASELINE config 9's world (``synthetic.TemporalWorld``,
    10 objects, seed 4, speed 3, 960x540), 96 frames rendered on the card
    and held against the CPU rendering (bitwise expected; at most 1 level
    on 0.01% of the pixels) and against the JAX golden's frame digests
    (``tests/data/quality_golden.json``, from
    ``scripts/make_quality_golden.py``); then ``TrackingPipeline`` at full
    width with the trained weights and no synthetic boxes, in bf16 and in
    f32 (TF32 off): FPS, stage ms, syncs and live tracks a frame, MOTA,
    MOTP, ID switches, FP, FN, HOTA, DetA, AssA, IDF1 (scored from frame 5)
    and AP50 and mAP@[.5:.95] over the detections; gates: f32 within 0.005
    of the golden's MOTA, HOTA and IDF1 and within 1 of its ID switches,
    bf16 MOTA at least the golden's minus 0.05 and ID switches at most its
    plus 4;
    ``[int8]``: W8A8 on the card: the int32 accumulators of every
    distinct conv of ``QuantReIDNet`` (8 crops) and ``QuantYOLOv8`` (one
    640x640 frame) bitwise against the CPU, the nets' outputs against the
    CPU (ReID features within 1e-5; at most 1e-3 of the YOLOv8 int8
    activations a level off), the calibration frames bitwise the CPU's;
    bf16 against int8 replay times for the embed at 32 crops and YOLOv8n
    at K=8; then the quality world with ``yolo_quant`` and ``reid_quant``
    "int8", scored like the bf16 run; gates: AP50 at least bf16's minus
    0.01, MOTA at least the golden's minus 0.05, ID switches at most its
    plus 4;
15. ``[mot]``: a MOTChallenge layout of 48 PNG frames (a second seed of the
    world) with its ``gt.txt``, then ``aicamera_tpu_torch.mot.main(--run
    --gsi)`` on the card: its report equals an in-process scoring of the
    result file, the result and GSI files exist; the same with the frames
    as JPEGs (the port's encoder, q95);
16. ``[train]``: one dispatch of ``train.make_train_step`` at full width
    (YOLOv8n 640x640, the 540x960 world, batch 2, scan 3, warm-up 1, so
    that steps 2 and 3 take full updates) in f32 with TF32 off on the card
    and on the CPU from the committed weights: losses within rtol 1e-4,
    parameters within rtol 5e-3 and atol 1e-5, which the starting
    parameters must fail (the largest difference printed); then two
    dispatches in bf16 of ``TrainConfig()`` (batch 8, scan 25, its 200-step
    warm-up) from the seeded init: ms a step, images/s, CUDA-event ms of
    render, letterbox, forward, backward and optimizer, peak memory, and
    the share of the bf16 peak (3x the forward's ``device_cost`` FLOPs over
    the step), one letterbox launch a step, one read a dispatch and no sync
    flagged by CUDA's sync debug mode in the second, its mean loss below
    the first's; ``train_detector`` warm-started from the committed
    detector (25 steps, a 5-step warm-up to lr 5e-4, then the cosine
    decay) with ``train_synthetic.evaluate`` on 48 scenes before and after
    (precision and recall at least 0.85, the script's save gate);
    ``train_reid`` from the committed embedder (25 steps) with
    ``evaluate_reid`` (intra_p95 at most 0.15, inter_p5 at least 0.25);
    ``finetune_on_clip`` on 16 frames of config 9's world labelled with
    its ground truth (the same 25 steps; two letterbox launches a step);
    ``.onnx`` files written from the committed checkpoints in a temporary
    directory, loaded by ``YOLODetector`` and ``ReIDModel``: outputs
    bitwise the msgpack-loaded ones on 4 frames;
17. ``[parallel]``: ``aicamera_tpu_torch.parallel`` over
    ``torch.distributed`` on the one card. ``PipelineParallelDetector(
    devices=[cuda:0])`` bitwise ``YOLOv8`` (640x640, K=8, f32); world A,
    one NCCL rank: ``MultiStreamPipeline(mesh=make_stream_mesh(1))`` at
    config 4 in f32 (TF32 off), tracks identical to the single-device f32
    run, one gather and one letterbox launch a dispatch; world B, two
    gloo ranks sharing cuda:0 (NCCL refuses two ranks of a communicator
    on one GPU): ``make_stream_mesh(2)`` (each rank 4 streams: one K=16
    launch and one gather a dispatch, tracks identical), ``make_mesh(1,
    2)`` with the detector channel-parallel (config 4: tracks identical,
    half the weight bytes a rank; YOLOv8m from its seeded init on 1080p
    frames at K=4 against the replicated forward), the DP trainer over
    ('batch', 2) at ``TrainConfig``'s widths (one f32 dispatch of scan 2
    at warm-up 1 against ``make_train_step`` in one process: losses within
    1e-6 relative, parameters within rtol 5e-3 and atol 1e-5, the start
    outside it, bitwise equal across ranks; one all-reduce a step) and the
    composed ``meshes=`` stage-split detector; ms a dispatch and a step
    per rank (two ranks sharing one card: no scaling figure);
18. ``[examples]``: the twelve scripts of ``examples_torch/``, each one's
    ``main(argv)`` in this process with no ``--device`` (the card), at the
    sizes ``tests/test_torch_examples.py`` runs them on the CPU (the video
    scripts on an MJPEG ``.avi`` of the synthetic world's frames, written
    by the port's ``VideoWriter``), and ``multistream.py --ranks 1`` (one
    NCCL rank) and ``--ranks 2`` (two gloo ranks sharing the card): a line
    a run with its exit status, wall seconds, every hand kernel's launches
    (the ranks report their own) and the memory still allocated after it;
    it fails where a
    script raises or exits non-zero, or leaves unlaunched a kernel it runs
    (letterbox and NMS in every script that detects, assignment in every
    one that tracks, ORU in ``ocsort_video.py``, the branch kernel in every
    ``TrackingPipeline`` and stream stack); ``serialized_engines.py``
    asserts its engine bitwise the weight path.

Every path that detects launches the NMS kernel once a chunk, dispatch,
request or ``detect`` replay (twice a ``detect_tiled`` replay) and reads
nothing in its NMS: no read of the plain keep's eager form on the card
outside ``[nms]``'s and ``[engine]``'s yardsticks, checked after every
path and at the end.
The last two lines of output are the kernels' JSON record (letterbox,
assignment, oru and nms, each with its launches by path: the letterbox's,
the assignment's and the NMS kernel's on the main path, the ORU kernel's on
``[trackers]``' OC-SORT run) and the device JSON record.
``--kernels-only`` stops after step 3, as do ``--only assignment``,
``--only oru`` and ``--only nms``;
``--only`` runs the kernel phases and the named phases (``int8`` brings
``quality`` along, ``present`` brings ``cli``; ``--only parallel`` runs
step 17 alone, ``--only examples`` step 18).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
import io
import json
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent

N_CHUNKS = 8          # main-path chunks (the first two are also compared)
CHUNK = 8
FRAME_HW = (540, 960)
COMPARE_CHUNKS = 2
TRACKER_CHUNKS = 2    # frames of each tracker in the [trackers] phase / CHUNK
GMC_CHUNKS = 4        # frames of the panning scene in the [gmc] phase / CHUNK
FACADE_FRAMES = 32    # frames of each facade in the [facades] phase
FACADE_COMPARE = 8    # of them, compared card f32 against the CPU
WARM_UP_ITERS = 2     # chunk steps of TrackingPipeline.warm_up
CAPTURE_PASSES = 1    # eager passes of a step before its capture
SEED = 0
STREAMS = 8           # [streams]: BASELINE.json config 4, 8 streams of 720p
STREAM_HW = (720, 1280)
STREAM_CHUNK = 4
STREAM_DISPATCHES = 4  # timed dispatches of [streams], after the warm-up
TENANT_SECONDS = 2.0   # [serving]: how long the paced tenants submit
TENANT_PACES = (None, 30.0, 15.0, 8.0)  # frames/s; None: one burst
SERVER_FRAMES = 16     # [server]: raw-frame POSTs
SERVER_CHUNK = 4
SERVER_IMAGES = 8      # [server]: JPEG bodies, then PNG bodies
QUALITY_GOLDEN = ROOT / "tests" / "data" / "quality_golden.json"
MOT_FRAMES = 48        # [mot]: PNG frames of a second seed of the world
MOT_SEED = 7
TRAIN_F32_BATCH = 2    # [train]: the card-vs-CPU dispatch at full width,
TRAIN_F32_SCAN = 3     # its warm-up 1: step 1 at lr 0, steps 2-3 at lr 2e-3
TRAIN_BF16_DISPATCHES = 2  # [train]: bf16 dispatches of TrainConfig()
TRAIN_TUNE_STEPS = 25  # [train]: warm-start and clip fine-tunes, one dispatch
TRAIN_TUNE_WARMUP = 5  # of them, at lr 5e-4 from step 5 on
TRAIN_EVAL_SCENES = 48  # train_synthetic.evaluate's default
TRAIN_CLIP_FRAMES = 16  # [train]: frames of config 9's world for the clip
TRAIN_ONNX_FRAMES = 4
PARALLEL_RANKS = 2     # [parallel]: world B, two gloo ranks on cuda:0
PARALLEL_DISPATCHES = 2  # config 4 dispatches a mesh run makes (f32)
PARALLEL_M_HW = (1080, 1920)  # config 5's frames for YOLOv8m, K=4
PARALLEL_M_K = 4
PARALLEL_PP_K = 8      # the stage-split detector's batch, 640x640
TP_TOL = 1e-4          # [parallel]: |TP - replicated| <= TP_TOL * max|ref|
PP_TOL = 1e-4          # [parallel]: the composed pipeline, likewise
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12       # H100 SXM, f32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12     # H100 SXM, dense bf16 tensor cores
PEAK_INT8_OPS = 1979e12      # H100 SXM, dense int8 tensor cores

# frames a launch: one (the facades), two (the f32 training dispatch of
# [train]), four (each of the clip step's two launches), eight (a chunk, a
# detector training step)
KERNEL_K = (1, 2, 4, 8)
KERNEL_GEOMETRIES = [  # (src_hw, dst_hw, auto)
    ((540, 960), (640, 640), False),
    ((720, 1280), (640, 640), False),
    ((1080, 1920), (640, 640), False),
    ((640, 640), (640, 640), False),
    ((240, 320), (640, 640), False),
    ((540, 960), (640, 640), True),
]


def bench_shapes():
    """(src_hw, out dtype) of the timed letterbox calls, K=8 each."""
    import torch
    return [((540, 960), torch.bfloat16), ((1080, 1920), torch.bfloat16),
            ((540, 960), torch.float32)]


def facade_shapes():
    """(path, src_hw, K) of the facades' letterbox launches on a 960x540
    frame: ``detect`` at K=1, ``detect_tiled``'s 2x2 tiles (its full frame
    is the K=1 launch)."""
    from aicamera_tpu_torch.ops.tiling import tile_layout
    origins, tile_hw = tile_layout(FRAME_HW, (2, 2), 0.2)
    return [("detect", FRAME_HW, 1), ("detect_tiled", tile_hw, len(origins))]


def stream_shape():
    """(path, src_hw, K) of the multi-stream dispatch's letterbox launch:
    all S*K frames of a dispatch in one launch."""
    return ("streams", STREAM_HW, STREAMS * STREAM_CHUNK)


def parallel_shape():
    """(path, src_hw, K) of a rank's letterbox launch on a 2-rank stream
    mesh: its 4 streams x 4 frames of 720p."""
    return ("parallel_streams", STREAM_HW,
            STREAMS * STREAM_CHUNK // PARALLEL_RANKS)


def clip_shape():
    """(path, src_hw, K) of ``finetune_on_clip``'s two launches a step:
    four 960x540 frames each."""
    return ("finetune_on_clip", FRAME_HW, 4)


def library_call(spec, frames):
    """The single PyTorch call nearest to the letterbox of ``frames``: the
    bilinear resize (``F.interpolate``) where the geometry resizes, else
    the constant-114 padding (``F.pad``), on NCHW f32 frames."""
    import torch.nn.functional as F
    nchw = frames.permute(0, 3, 1, 2).float().contiguous()
    if tuple(spec.unpad_hw) != tuple(spec.src_hw):
        return "F.interpolate", lambda: F.interpolate(
            nchw, size=spec.unpad_hw, mode="bilinear", align_corners=False)
    pad = (spec.left, spec.right, spec.top, spec.bottom)
    return "F.pad", lambda: F.pad(nchw, pad, value=114.0)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=50, warmup=5):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_host_ms(fn, bursts=20, burst=16, warmup=10):
    """Host time of one call: bursts of back-to-back calls with the clock
    stopped before the device is waited for, and a sync between bursts, so
    that the launch queue is never full and no call waits for the device."""
    import torch
    for _ in range(warmup):
        fn()
    host = 0.0
    for _ in range(bursts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(burst):
            fn()
        host += time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / (bursts * burst) * 1e3


def time_device_ms(launch, n_sets, rounds=8, replays=5):
    """:func:`time_device_stats`' median."""
    return time_device_stats(launch, n_sets, rounds, replays)[0]


def time_device_stats(launch, n_sets, rounds=8, replays=5):
    """A kernel's time on the device without its host side: ``rounds *
    n_sets`` launches captured into one CUDA graph, CUDA events around a
    replay, the median of ``replays`` replays over the launch count. It
    holds the gap between two kernel nodes of a graph (about a microsecond),
    so it bounds the kernel's own duration from above. ``launch(i)`` runs on
    buffer set ``i``. Where a kernel's reads from device memory are what is
    timed, the caller sizes the sets so that together they exceed the L2
    cache, so every launch finds its inputs in device memory; a
    latency-bound kernel whose inputs its path leaves in the L2 (the
    assignment solves) is timed over a few L2-resident sets. Returns the
    median, the least and the most of the replays, in ms a launch."""
    import torch

    for i in range(n_sets):
        launch(i)  # builds and caches whatever the first call sets up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(rounds):
            for i in range(n_sets):
                launch(i)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times = sorted(t / (rounds * n_sets) for t in times)
    return times[replays // 2], times[0], times[-1]


L2_BYTES = 50e6  # H100: 50 MB


def measure_letterbox(call, src_hw, dt, device, gen, k=CHUNK):
    """Three times of one letterbox call at one shape, and its bound.

    ``device_ms``: the kernel without the wrapper's host time (a graph
    replay), rotating over buffer sets larger than the L2 together (a
    device-memory reading, what the byte bound is held against). ``ms``:
    per call through ``call`` back to back on one buffer (what the pipeline
    pays per chunk once the queue runs). ``host_ms``: the host's share of
    one call.

    The bound's bytes are ``ops.letterbox.traffic``'s (the count that
    ``runtime.profiler.device_cost`` reads too): the source rows that some
    output row taps with a weight above 0, whole, and the output."""
    import torch
    from aicamera_tpu_torch.ops.letterbox import traffic
    from aicamera_tpu_torch.ops.preprocess import letterbox_spec

    spec = letterbox_spec(src_hw, (640, 640))
    in_bytes, out_bytes, rows_read = traffic(spec, k, dt)
    n_out = k * 3 * spec.out_hw[0] * spec.out_hw[1]
    n_sets = max(4, int(2.5 * L2_BYTES / (in_bytes + out_bytes)) + 1)
    inputs = [torch.randint(0, 256, (k, *src_hw, 3), dtype=torch.uint8,
                            device=device, generator=gen)
              for _ in range(n_sets)]
    outs = [None] * n_sets  # held, so the allocator rotates the outputs too

    def launch(i):
        outs[i] = call(inputs[i], spec, dt)

    device_ms = time_device_ms(launch, n_sets)
    del outs
    # the host's first thousand calls of a process run slower: median of 3
    ms = sorted(time_ms(lambda: call(inputs[0], spec, dt))
                for _ in range(3))[1]
    host_ms = sorted(time_host_ms(lambda: call(inputs[0], spec, dt))
                     for _ in range(3))[1]
    content = k * 3 * spec.unpad_hw[0] * spec.unpad_hw[1]
    ops = content * 11 + (n_out - content)  # 6 mul + 3 add + round/clip/div
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return {"shape": f"{src_hw[1]}x{src_hw[0]}->{spec.out_hw[1]}x"
                     f"{spec.out_hw[0]} K={k} "
                     f"{'bf16' if dt == torch.bfloat16 else 'f32'}",
            "device_ms": device_ms, "ms": ms, "host_ms": host_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": in_bytes + out_bytes, "source_rows_read": rows_read,
            "ops": ops, "n_sets": n_sets}


def build_kernels(kernels):
    """Build every kernel's source with nvcc and load it; the host C++
    (``native/*.cpp``: JPEG, MJPEG, lapjv) builds with ``c++`` beside it."""
    from concurrent.futures import ThreadPoolExecutor
    from aicamera_tpu_torch.ops import cuda_build, host_build
    t0 = time.perf_counter()
    host = sorted(host_build.NATIVE_DIR.glob("*.cpp"))
    with ThreadPoolExecutor(len(kernels) + len(host)) as pool:
        cuda = [pool.submit(cuda_build.build, k.source,
                            getattr(k, "defines", ()), getattr(k, "flags", ()))
                for k in kernels]
        cxx = [pool.submit(host_build.build, src) for src in host]
        for k, fut in zip(kernels, cuda):
            lib, log = fut.result()
            probe = " (probe)" if getattr(k, "probe", False) else ""
            print(f"[build] {k.name}{probe}: {lib.name}")
            for ln in log.splitlines():
                if "ptxas" in ln:
                    print(f"[build]   {ln.strip()}")
        for src, fut in zip(host, cxx):
            print(f"[build] host {src.name}: {fut.result()[0].name}")
    for k in kernels:
        k.load()  # finds the library just built
    return time.perf_counter() - t0


# Shapes the vector variant does not take (a source row that is not a
# multiple of 16 bytes), K=3: (src_hw, dst_hw).
MISALIGNED_GEOMETRIES = [((37, 1999), (128, 96)), ((101, 333), (640, 640)),
                         ((360, 636), (640, 640))]
# Aligned shapes off the usual, K=3: a left pad that splits 8-pixel groups,
# in blocks of two rows of threads; an odd output height; an integer ratio
# (one staged source row per output row); a band beyond the 48 KB of shared
# memory a block gets without asking.
RAGGED_GEOMETRIES = [((100, 48), (128, 120)), ((37, 64), (31, 40)),
                     ((108, 192), (64, 64)), ((16, 8208), (64, 640))]


def kernel_phase(device):
    """Letterbox kernel vs its plain version on the card, bitwise, then its
    times."""
    import torch
    import torch.nn.functional as F
    from aicamera_tpu_torch.ops import letterbox as lb
    from aicamera_tpu_torch.ops.preprocess import letterbox_spec

    gen = torch.Generator(device=device).manual_seed(SEED)
    max_err = 0.0
    n_checked = {"vector": 0, "scalar": 0}

    def hold(frames, spec, dt, want, variant=None):
        """One launch against the plain version; ``want``: the variant the
        plan must have picked; ``variant``: force that one."""
        nonlocal max_err
        before = lb.KERNEL.launches
        if variant:
            out = lb.KERNEL(frames, spec, dt, variant=variant)
        else:
            out = lb.letterbox(frames, spec, dt)  # the pipeline's call
        check(lb.KERNEL.launches == before + 1,
              "letterbox() on a CUDA tensor did not launch the kernel")
        plan = lb.KERNEL.last_plan
        what = (f"{tuple(frames.shape)}->{spec.out_hw} {dt} {plan.variant} "
                f"rows={plan.rows}")
        check(want == plan.variant, f"{what}: expected the {want} variant "
              f"({plan.reason})")
        ref = lb.letterbox_plain(frames, spec, dt)
        torch.cuda.synchronize()
        check(out.shape == ref.shape == (frames.shape[0], 3, *spec.out_hw)
              and out.dtype == dt, f"letterbox shape {tuple(out.shape)}")
        err = (out.float() - ref.float()).abs().max().item()
        max_err = max(max_err, err)
        check(torch.equal(out, ref),
              f"letterbox kernel != plain version: {what}: max |err| {err}")
        n_checked[plan.variant] += 1

    def random_frames(k, src):
        return torch.randint(0, 256, (k, *src, 3), dtype=torch.uint8,
                             device=device, generator=gen)

    dtypes = (torch.float32, torch.bfloat16)
    for src, dst, auto in KERNEL_GEOMETRIES:
        spec = letterbox_spec(src, dst, auto=auto)
        for k in KERNEL_K:
            frames = random_frames(k, src)
            for dt in dtypes:
                hold(frames, spec, dt, want="vector")
        for dt in dtypes:  # the same shapes through the scalar variant
            hold(frames, spec, dt, want="scalar", variant="scalar")
    for src, dst in MISALIGNED_GEOMETRIES:
        spec = letterbox_spec(src, dst)
        frames = random_frames(3, src)
        for dt in dtypes:
            hold(frames, spec, dt, want="scalar")
    for src, dst in RAGGED_GEOMETRIES:
        spec = letterbox_spec(src, dst)
        frames = random_frames(3, src)
        for dt in dtypes:
            hold(frames, spec, dt, want="vector")
    # the facades' launches, the tiles cut from a frame as detect_tiled does
    from aicamera_tpu_torch.ops.tiling import extract_tiles, tile_layout
    origins, tile_hw = tile_layout(FRAME_HW, (2, 2), 0.2)
    for path, src, k in facade_shapes():
        spec = letterbox_spec(src, (640, 640))
        frames = random_frames(k, src) if path == "detect" else extract_tiles(
            random_frames(1, FRAME_HW)[0], origins, tile_hw)
        for dt in dtypes:
            want = lb.launch_plan(spec, k, dt,
                                  frames.data_ptr() % 16 == 0).variant
            hold(frames, spec, dt, want=want)
    # the multi-stream dispatch: 8 streams x 4 frames of 720p in one
    # launch; a rank's half of it on a 2-rank stream mesh
    for _, src, k in (stream_shape(), parallel_shape()):
        spec = letterbox_spec(src, (640, 640))
        frames = random_frames(k, src)
        for dt in dtypes:
            hold(frames, spec, dt, want="vector")
        del frames
    k = stream_shape()[2]
    # the public single-frame preprocess is the kernel on a CUDA tensor
    from aicamera_tpu_torch.ops.preprocess import preprocess_yolo
    spec = letterbox_spec(FRAME_HW, (640, 640))
    frame = random_frames(1, FRAME_HW)[0]
    before = lb.KERNEL.launches
    out = preprocess_yolo(frame, spec)
    check(lb.KERNEL.launches == before + 1,
          "preprocess_yolo on a CUDA tensor did not launch the kernel")
    check(torch.equal(out, lb.letterbox_plain(frame[None], spec).permute(
        0, 2, 3, 1)), "preprocess_yolo != the plain version")
    # an aligned shape at a pointer off the 16-byte grid
    spec = letterbox_spec(FRAME_HW, (640, 640))
    n = 2 * FRAME_HW[0] * FRAME_HW[1] * 3
    shifted = torch.randint(0, 256, (n + 1,), dtype=torch.uint8,
                            device=device, generator=gen)[1:]
    shifted = shifted.view(2, *FRAME_HW, 3)
    check(shifted.data_ptr() % 16 != 0, "the shifted view is aligned")
    for dt in dtypes:
        hold(shifted, spec, dt, want="scalar")
    print(f"[kernel] letterbox: bitwise equal to the plain version on "
          f"{n_checked['vector']} vector and {n_checked['scalar']} scalar "
          f"launches ({len(KERNEL_GEOMETRIES)} geometries x K in "
          f"{KERNEL_K} x f32/bf16 as the pipeline calls it, the same "
          f"forced to the scalar variant, "
          f"{len(MISALIGNED_GEOMETRIES)} misaligned and "
          f"{len(RAGGED_GEOMETRIES)} ragged shapes, the facades' K=1 frame "
          f"and 2x2 tiles, the multi-stream dispatch's K={k} 720p batch and "
          f"a stream rank's K={parallel_shape()[2]}, one "
          f"unaligned pointer); preprocess_yolo on a CUDA frame launched it "
          f"once")

    # timing: the main path's shape first (960x540 -> 640x640, K=8, bf16)
    def scalar_call(frames, spec, dt):
        return lb.KERNEL.launch(frames, spec, dt, variant="scalar")

    def report(tag, r):
        print(f"[kernel] letterbox {r['shape']} {tag}: device "
              f"{r['device_ms']:.4f} ms (cold L2, {r['n_sets']} buffer "
              f"sets), per call {r['ms']:.4f} ms, host {r['host_ms']:.4f} "
              f"ms, bound {r['bound_ms']:.4f} ms ({r['bytes']} bytes with "
              f"{r['source_rows_read']} source rows a frame, {r['ops']} "
              f"ops): "
              f"{100 * r['bound_ms'] / r['device_ms']:.1f}% of the bound")

    rows = []
    for src, dt in bench_shapes():
        r = measure_letterbox(lb.letterbox, src, dt, device, gen)
        r["plan"] = repr(lb.KERNEL.last_plan)
        check(lb.KERNEL.last_plan.variant == "vector", r["plan"])
        report(f"rows={lb.KERNEL.last_plan.rows}x"
               f"{lb.KERNEL.last_plan.block[1]}", r)
        # the earlier design (one thread per pixel), now the scalar variant
        e = measure_letterbox(scalar_call, src, dt, device, gen)
        report("scalar variant", e)
        r["earlier_ms"] = e["device_ms"]
        rows.append(r)
    for path, src, k in [*facade_shapes(), stream_shape(), parallel_shape(),
                         clip_shape()]:
        r = measure_letterbox(lb.letterbox, src, torch.bfloat16, device, gen,
                              k=k)
        r["plan"] = repr(lb.KERNEL.last_plan)
        r["path"] = path
        report(f"{path}, {lb.KERNEL.last_plan.variant} variant", r)
        spec = letterbox_spec(src, (640, 640))
        frames = torch.randint(0, 256, (k, *src, 3), dtype=torch.uint8,
                               device=device, generator=gen)
        r["plain_ms"] = time_ms(lambda: lb.letterbox_plain(
            frames, spec, torch.bfloat16), iters=10)
        r["library"], call = library_call(spec, frames)
        r["library_ms"] = time_ms(call)
        del frames
        print(f"[kernel] letterbox {r['shape']} ({path}): plain "
              f"{r['plain_ms']:.4f} ms, {r['library']} {r['library_ms']:.4f} "
              f"ms")
        rows.append(r)
    main = rows[0]
    spec = letterbox_spec(FRAME_HW, (640, 640))
    frames = torch.randint(0, 256, (CHUNK, *FRAME_HW, 3), dtype=torch.uint8,
                           device=device, generator=gen)
    plain_ms = time_ms(lambda: lb.letterbox_plain(frames, spec,
                                                  torch.bfloat16), iters=10)
    nchw = frames.permute(0, 3, 1, 2).float().contiguous()
    library_ms = time_ms(lambda: F.interpolate(
        nchw, size=spec.unpad_hw, mode="bilinear", align_corners=False))
    lb.KERNEL.launches = 0  # comparison and timing launches do not count
    print(f"[kernel] letterbox {main['shape']}: plain {plain_ms:.4f} ms, "
          f"F.interpolate {library_ms:.4f} ms (the resize only)")
    return {"name": "letterbox", "route": "cuda",
            "source": "aicamera_tpu_torch/csrc/letterbox.cu",
            "replaces": lb.KERNEL.replaces, "launches": None,
            "max_abs_err": max_err, "ms": main["ms"],
            "device_ms": main["device_ms"], "host_ms": main["host_ms"],
            "earlier_ms": main["earlier_ms"],
            "plain_ms": plain_ms, "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": library_ms,
            "shapes": rows}


# [assignment]: the DeepSORT thresholds (appearance, IoU), the cascade depth
# (max_age), INFTY_COST, and the main path's widths
ASG_MAX_COS, ASG_MAX_IOU, ASG_DEPTH, ASG_INFTY = 0.2, 0.7, 70, 1e5
ASG_T, ASG_N = 128, 64
ASG_TIMED_SETS = 8     # distinct problems the timed launches rotate over
# (L2-resident, 32 KB a problem: on the main path the solve reads a cost
# that the kernel before it has just written)
# the problems the main path solves, recorded over its 64 frames by
# scripts/record_assignment_problems.py
ASG_RECORDED = ROOT / "tests" / "data" / "assignment_main_path.npz"
ASG_RECORDED_CASES = 16  # of them, in assignment_cases(): 8 frames' worth


def main_path_problems(limit=None):
    """The recorded main-path problems, ``[(family, kind, args)]`` as in
    :func:`assignment_cases`, in the order the tracker solved them."""
    import numpy as np
    with np.load(ASG_RECORDED) as z:
        kinds = [str(k) for k in z["kind"]]
        out = []
        for q, kind in enumerate(kinds[:limit]):
            cost, rows, cols = (z[f"p{q:03d}_{f}"]
                                for f in ("cost", "rows", "cols"))
            max_d = float(z["max_d"][q])
            args = ((cost, z[f"p{q:03d}_level"], rows, cols, max_d,
                     int(z["depth"][q])) if kind == "cascade"
                    else (cost, rows, cols, max_d))
            out.append(("main path", kind, args))
    return out


def assignment_cases():
    """Seeded problems for the assignment kernel, ``[(family, kind, args)]``
    with numpy args: kind ``"match"`` takes ``(cost, row_mask, col_mask,
    max_d)``, ``"cascade"`` ``(cost, level, eligible, det_valid, max_d,
    depth)``. Ineligible rows hold NaN now and then, as the tracker's unused
    slots do."""
    import numpy as np
    rng = np.random.RandomState(SEED)

    def rows_of(t, live):
        m = np.zeros(t, bool)
        m[rng.choice(t, live, replace=False)] = True
        return m

    def cols_of(nd, ndet):
        m = np.zeros(nd, bool)
        m[:ndet] = True   # the pipeline compacts detections to the front
        return m

    def appearance(t, nd, rows):
        """Cosine distances, Mahalanobis-gated to INFTY."""
        c = rng.uniform(0, 0.5, (t, nd)).astype(np.float32)
        c[rng.rand(t, nd) < 0.6] = ASG_INFTY
        c[~rows & (rng.rand(t) < 0.3)] = np.nan
        return c

    def iou_cost(t, nd, rows):
        """1 - IoU: 1.0 where boxes do not overlap, 0.0 for a perfect one."""
        c = np.ones((t, nd), np.float32)
        near = rng.rand(t, nd) < 0.08
        c[near] = rng.uniform(0, 1, near.sum())
        c[rng.rand(t, nd) < 0.01] = 0.0
        c[~rows & (rng.rand(t) < 0.3)] = np.nan
        return c

    def levels_of(t, rows, spread):
        lv = np.where(rng.rand(t) < 0.8, 1, rng.randint(1, spread + 1, t))
        lv[~rows] = rng.randint(0, 200, (~rows).sum())  # stale tsu
        return lv.astype(np.int32)

    cases = []
    # realistic DeepSORT loads at the full capacity and the bucketed one
    for t in (ASG_T, 32):
        for _ in range(6):
            live = rng.randint(8, min(60, t - 4) + 1)
            ndet = rng.randint(5, 61)
            rows, cols = rows_of(t, live), cols_of(ASG_N, ndet)
            fam = f"{t}x{ASG_N} load"
            cases.append((fam, "cascade", (
                appearance(t, ASG_N, rows), levels_of(t, rows, 4), rows,
                cols, ASG_MAX_COS, ASG_DEPTH)))
            cases.append((fam, "match", (iou_cost(t, ASG_N, rows), rows,
                                         cols, ASG_MAX_IOU)))
    # costs on a few levels: ties everywhere, -0.0 beside +0.0
    for _ in range(4):
        rows, cols = rows_of(ASG_T, 40), cols_of(ASG_N, 40)
        c = (rng.randint(0, 4, (ASG_T, ASG_N)) * 0.05).astype(np.float32)
        c[(c == 0) & (rng.rand(ASG_T, ASG_N) < 0.5)] = -0.0
        cases.append(("ties", "match", (c, rows, cols, ASG_MAX_COS)))
        cases.append(("ties", "cascade", (c, levels_of(ASG_T, rows, 3), rows,
                                          cols, ASG_MAX_COS, ASG_DEPTH)))
    rows, cols = rows_of(ASG_T, 30), cols_of(ASG_N, 30)
    cases.append(("all infeasible", "match", (rng.uniform(
        0.3, 1, (ASG_T, ASG_N)).astype(np.float32), rows, cols,
        ASG_MAX_COS)))
    one = rows_of(ASG_T, 1)
    cases.append(("one row", "match", (iou_cost(ASG_T, ASG_N, one), one,
                                       cols_of(ASG_N, 40), ASG_MAX_IOU)))
    for r, c in ((20, 50), (100, 30), (256, ASG_N), (ASG_N, 256),
                 (256, 256)):
        rows, cols = rows_of(r, min(r, 60)), cols_of(c, min(c, 60))
        fam = f"{r}x{c}"
        cases.append((fam, "match", (iou_cost(r, c, rows), rows, cols,
                                     ASG_MAX_IOU)))
        cases.append((fam, "cascade", (appearance(r, c, rows),
                                       levels_of(r, rows, 3), rows, cols,
                                       ASG_MAX_COS, ASG_DEPTH)))
    # a cascade spread over 1, 2, 5 and 70 levels, ungated: long searches
    for spread in (1, 2, 5, 70):
        rows, cols = rows_of(ASG_T, max(40, spread + 20)), cols_of(ASG_N, 60)
        idx = np.nonzero(rows)[0]
        lv = np.zeros(ASG_T, np.int32)
        lv[idx] = np.concatenate([np.arange(1, spread + 1), rng.randint(
            1, spread + 1, len(idx) - spread)])
        cost = rng.uniform(0, 0.3, (ASG_T, ASG_N)).astype(np.float32)
        cases.append((f"{spread} levels", "cascade", (
            cost, lv, rows, cols, ASG_MAX_COS, ASG_DEPTH)))
    # OC-SORT: shift - (IoU + bonus), nothing clamped; 1 - IoU up to 1.0
    for _ in range(2):
        rows, cols = rows_of(ASG_T, 30), cols_of(ASG_N, 30)
        objective = rng.uniform(-0.5, 2.0, (ASG_T, ASG_N)).astype(np.float32)
        cases.append(("OC-SORT", "match", (np.float32(3.0) - objective, rows,
                                           cols, 4.0)))
        cases.append(("OC-SORT", "match", (iou_cost(ASG_T, ASG_N, rows), rows,
                                           cols, 1.0)))
    # ByteTrack: fused IoU/score costs in [0, 1] at its three thresholds
    for thresh in (0.8, 0.5, 0.7):
        rows, cols = rows_of(ASG_T, 30), cols_of(ASG_N, 25)
        cases.append(("ByteTrack", "match", (iou_cost(ASG_T, ASG_N, rows),
                                             rows, cols, thresh)))
    # no eligible row: the IoU solve at a steady load, and a cascade
    none, cols = np.zeros(ASG_T, bool), cols_of(ASG_N, 24)
    cases.append(("no eligible row", "match", (iou_cost(
        ASG_T, ASG_N, none), none, cols, ASG_MAX_IOU)))
    cases.append(("no eligible row", "cascade", (appearance(
        ASG_T, ASG_N, none), levels_of(ASG_T, none, 3), none, cols,
        ASG_MAX_COS, ASG_DEPTH)))
    # a cascade with one row on each of 70 levels
    rows = rows_of(ASG_T, ASG_DEPTH)
    lv = np.zeros(ASG_T, np.int32)
    lv[rows] = rng.permutation(ASG_DEPTH) + 1
    cases.append(("70 levels, one row each", "cascade", (
        rng.uniform(0, 0.3, (ASG_T, ASG_N)).astype(np.float32), lv, rows,
        cols_of(ASG_N, 60), ASG_MAX_COS, ASG_DEPTH)))
    # rows that end on clamp columns: 24 live rows feasible on 3 columns
    # (21 end on infeasible columns below C), and 60 rows against 12
    # detections (48 end on padding columns beyond C)
    for live, ndet, feas in ((24, ASG_N, 3), (60, 12, 12)):
        rows = rows_of(ASG_T, live)
        c = np.full((ASG_T, ASG_N), 1.0, np.float32)
        on = rng.choice(ndet, feas, replace=False)
        c[np.ix_(rows, on)] = rng.uniform(0, 0.5, (live, feas))
        cases.append(("rows on clamp columns", "match", (
            c, rows, cols_of(ASG_N, ndet), ASG_MAX_IOU)))
        cases.append(("rows on clamp columns", "cascade", (
            c, levels_of(ASG_T, rows, 2), rows, cols_of(ASG_N, ndet),
            ASG_MAX_IOU, ASG_DEPTH)))
    return cases + main_path_problems(ASG_RECORDED_CASES)


def scipy_solve(cost, rows, cols, max_d):
    """The reference's ``min_cost_matching`` on the host: the clamped
    eligible sub-matrix through ``scipy.optimize.linear_sum_assignment``;
    returns the accepted (rows, columns)."""
    import numpy as np
    from scipy.optimize import linear_sum_assignment
    ri, ci = np.nonzero(rows)[0], np.nonzero(cols)[0]
    sub = cost[np.ix_(ri, ci)]
    sub = np.where(sub <= max_d, sub, np.float32(max_d + 1e-5))
    r, c = linear_sum_assignment(sub)
    ok = cost[ri[r], ci[c]] <= max_d
    return ri[r][ok], ci[c][ok]


def scipy_cascade(cost, level, elig, valid, max_d, depth):
    """The reference's matching cascade on the host, one scipy solve a
    level present; returns the detections left unmatched."""
    unmatched = valid.copy()
    for lvl in range(1, depth + 1):
        if not unmatched.any():
            break
        rows = elig & (level == lvl)
        if rows.any():
            unmatched[scipy_solve(cost, rows, unmatched, max_d)[1]] = False
    return unmatched


def sm_clock_mhz():
    """The card's SM clock and its maximum, in MHz (``nvidia-smi``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    cur, top = out.stdout.strip().splitlines()[0].split(",")
    return float(cur), float(top)


def seeded_timed_problems(on_card, t=ASG_T):
    """The timed problems, ``{"cascade": [args], "match": [args]}`` through
    ``on_card``: a DeepSORT frame's cascade and IoU solve at a load of 24
    tracks and 24 detections over ``t`` track slots, ``ASG_TIMED_SETS`` of
    each, seeded."""
    import numpy as np
    rng = np.random.RandomState(SEED + 1 if t == ASG_T else SEED + t)
    card = {"cascade": [], "match": []}
    for _ in range(ASG_TIMED_SETS):
        rows = np.zeros(t, bool)
        rows[rng.choice(t, 24, replace=False)] = True
        cols = np.zeros(ASG_N, bool)
        cols[:24] = True
        app = rng.uniform(0, 0.5, (t, ASG_N)).astype(np.float32)
        app[rng.rand(t, ASG_N) < 0.6] = ASG_INFTY
        lv = np.where(rng.rand(t) < 0.8, 1, 2).astype(np.int32)
        iou = np.ones((t, ASG_N), np.float32)
        near = rng.rand(t, ASG_N) < 0.08
        iou[near] = rng.uniform(0, 1, near.sum())
        card["cascade"].append(on_card((app, lv, rows, cols, ASG_MAX_COS,
                                        ASG_DEPTH)))
        card["match"].append(on_card((iou, rows, cols, ASG_MAX_IOU)))
    return card


ASG_BATCH = 8  # problems a batched launch: [streams]' 8 streams a frame


def stack_problems(problems):
    """Problems of one kind, shape, threshold and depth as one batch: each
    array argument stacked on a leading axis."""
    import numpy as np
    return tuple(np.stack(x) if isinstance(x[0], np.ndarray) else x[0]
                 for x in zip(*problems))


def assignment_batches():
    """Batches of ``ASG_BATCH`` problems for the batched launch, ``[(family,
    kind, args)]`` with numpy args stacked on a leading axis: the recorded
    main-path problems grouped 8 at a time by kind and shape (7 batches at
    128x64 and 1 at 32x64 a kind), the seeded timed sets at 128x64 and at
    the bucketed 32x64 (1 batch each a kind), and a mixed batch a kind: no
    eligible row, every row eligible (long searches), six recorded
    ones."""
    import numpy as np
    out = []
    groups = {}
    for _, kind, args in main_path_problems():
        groups.setdefault((kind, args[0].shape), []).append(args)
    for (kind, shape), probs in sorted(groups.items()):
        for i in range(0, len(probs) - ASG_BATCH + 1, ASG_BATCH):
            out.append((f"recorded {shape[0]}x{shape[1]}", kind,
                        stack_problems(probs[i:i + ASG_BATCH])))
    for t in (ASG_T, 32):
        for kind, probs in seeded_timed_problems(lambda a: a, t).items():
            out.append((f"seeded {t}x{ASG_N}", kind, stack_problems(probs)))
    rng = np.random.RandomState(SEED + 2)
    none, every = np.zeros(ASG_T, bool), np.ones(ASG_T, bool)
    cols = np.arange(ASG_N) < 40
    for kind, max_d in (("cascade", ASG_MAX_COS), ("match", ASG_MAX_IOU)):
        recorded = groups[kind, (ASG_T, ASG_N)][:ASG_BATCH - 2]
        cost = rng.uniform(0, 0.3, (2, ASG_T, ASG_N)).astype(np.float32)
        lv = rng.randint(1, 4, (2, ASG_T)).astype(np.int32)
        extra = [(cost[0], lv[0], none, cols, max_d, ASG_DEPTH),
                 (cost[1], lv[1], every, cols, max_d, ASG_DEPTH)]
        if kind == "match":
            extra = [(c, r, k, m) for c, _, r, k, m, _ in extra]
        out.append(("mixed", kind, stack_problems(extra + recorded)))
    return out


# the probe's phases, as csrc/assignment.cu's ProbeSlot orders them
ASG_PHASES = ("load", "stage", "feasibility", "levels", "init", "argmin",
              "augment", "accept", "output")


def assignment_phase(device):
    """Both designs of the assignment kernel against the plain version on
    the card, bitwise, on :func:`assignment_cases` and on every timed
    problem (the seeded sets and all the recorded main-path ones); the phase
    probe of both on the seeded, the recorded main-path and a 70-level
    problem, its outputs held the same way; both timed in turns; then the
    default design's times at the main path's shapes."""
    import numpy as np
    import torch
    from aicamera_tpu_torch.core import assignment as asg
    from aicamera_tpu_torch.ops.assignment import (KERNEL, VARIANTS,
                                                   AssignmentKernel)

    def on_card(args):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                if isinstance(a, np.ndarray) else a for a in args]

    public = {"match": asg.min_cost_matching,
              "cascade": asg.matching_cascade}
    plain = {"match": asg.min_cost_matching_plain,
             "cascade": asg.matching_cascade_plain}

    def run(kind, a, variant, kernel=KERNEL):
        """The default design through the public function; another design,
        or the probe's build, through the kernel's wrapper."""
        if variant == VARIANTS[0] and kernel is KERNEL:
            return public[kind](*a)
        fn = (kernel.matching_cascade if kind == "cascade"
              else kernel.min_cost_matching)
        return fn(*a, variant=variant)

    max_err = 0.0

    def launch(fam, kind, a, variant, kernel=KERNEL):
        before = kernel.launches
        got = run(kind, a, variant, kernel)
        check(kernel.launches == before + 1,
              f"[assignment] {fam} {kind} {variant}: the kernel did not "
              f"launch once")
        return got if kind == "cascade" else (got,)

    def same(fam, kind, a, variant, got, want):
        """``got`` bitwise ``want`` (after a synchronize)."""
        nonlocal max_err
        for g, w in zip(got, want):
            check(g.dtype == w.dtype and torch.equal(g, w),
                  f"[assignment] {variant} {fam} {kind} "
                  f"{tuple(a[0].shape)}: kernel {g.tolist()} != "
                  f"plain {w.tolist()}")
            max_err = max(max_err, float(torch.max(torch.abs(
                g.double() - w.double()))))

    def hold(fam, kind, a, variant, want):
        got = launch(fam, kind, a, variant)
        torch.cuda.synchronize()
        same(fam, kind, a, variant, got, want)

    def plain_of(kind, a):
        want = plain[kind](*a)
        return want if kind == "cascade" else (want,)

    by_family = {}
    cases = assignment_cases()
    for fam, kind, args in cases:
        a = on_card(args)
        want = plain_of(kind, a)
        for variant in VARIANTS:
            hold(fam, kind, a, variant, want)
        by_family[fam] = by_family.get(fam, 0) + 1

    # the timed problems: seeded, and the main path's own (all of them:
    # assignment_cases() holds the first ASG_RECORDED_CASES)
    card = seeded_timed_problems(on_card)
    recorded = {"cascade": [], "match": []}
    for _, kind, args in main_path_problems():
        recorded[kind].append(on_card(args))
    levels70 = {"cascade": [on_card(next(
        args for fam, _, args in cases if fam == "70 levels"))]}
    sets = (("seeded", card), ("main path", recorded),
            ("70 levels", levels70))
    wants = {}   # (set, kind, i) -> the plain version's outputs
    for set_name, problems in sets:
        for kind, probs in problems.items():
            for i, a in enumerate(probs):
                wants[set_name, kind, i] = want = plain_of(kind, a)
                if set_name == "70 levels":
                    continue   # one of the cases above
                for variant in VARIANTS:
                    hold(set_name, kind, a, variant, want)
            if set_name != "70 levels":
                fam = f"timed {set_name} {kind}"
                by_family[fam] = len(probs)
    print(f"[assignment] both designs ({', '.join(VARIANTS)}) bitwise equal "
          f"to the plain version on {sum(by_family.values())} problems (max "
          f"|diff| {max_err}): "
          + ", ".join(f"{f} {n}" for f, n in by_family.items()))

    # the phase probe: thread 0's cycles by phase, a launch on average
    probe = AssignmentKernel(probe=True)
    sm_mhz = sm_clock_mhz()
    probes = []
    for set_name, problems in sets:
        for kind, probs in problems.items():
            for variant in VARIANTS:
                probe.read_probe(reset=True)
                outs = [launch("probe", kind, a, variant, probe)
                        for a in probs]   # back to back, as timed
                torch.cuda.synchronize()
                got = probe.read_probe(reset=True)
                for i, (a, out) in enumerate(zip(probs, outs)):
                    same(f"probe {set_name}", kind, a, variant, out,
                         wants[set_name, kind, i])
                n = got["problems"]
                check(n == len(probs), f"[assignment] probe counted {n} "
                      f"problems of {len(probs)}")
                row = {"set": set_name, "kind": kind, "variant": variant,
                       "problems": n,
                       **{k: got[k] / n for k in ("total", *ASG_PHASES,
                                                   "solves",
                                                   "rows_augmented",
                                                   "steps")}}
                row["augment_cycles_a_step"] = (
                    got["augment"] / got["steps"] if got["steps"] else None)
                row["ns_a_step_at_max_clock"] = (
                    row["augment_cycles_a_step"] / sm_mhz[1] * 1e3
                    if got["steps"] else None)
                probes.append(row)
                step = ("" if not got["steps"] else
                        f"; augment {row['augment_cycles_a_step']:.1f} "
                        f"cycles a step ({row['ns_a_step_at_max_clock']:.1f}"
                        f" ns at {sm_mhz[1]:.0f} MHz)")
                print(f"[assignment] probe {variant} {set_name} {kind}: {n} "
                      f"launches; thread 0's cycles a problem "
                      f"{row['total']:.0f}"
                      f" (" + ", ".join(f"{k} {row[k]:.0f}"
                                        for k in ASG_PHASES)
                      + f"); a launch {row['solves']:.2f} solves, "
                        f"{row['rows_augmented']:.2f} rows augmented, "
                        f"{row['steps']:.2f} steps" + step)
    print(f"[assignment] probe: SM clock {sm_mhz[0]:.0f} MHz after the "
          f"probe, {sm_mhz[1]:.0f} MHz at most")

    # both designs in turns (v1, lanes, lanes, v1), graph replays
    turns = []
    for set_name, problems in sets[:2]:
        for kind, probs in problems.items():
            got = {}
            for variant in (VARIANTS[1], VARIANTS[0], VARIANTS[0],
                            VARIANTS[1]):
                got.setdefault(variant, []).append(time_device_stats(
                    lambda i: run(kind, probs[i], variant), len(probs)))
            row = {"set": set_name, "kind": kind, "problems": len(probs),
                   **{f"{v}_ms": [t[0] for t in got[v]] for v in VARIANTS},
                   **{f"{v}_spread_ms": [min(t[1] for t in got[v]),
                                         max(t[2] for t in got[v])]
                      for v in VARIANTS}}
            turns.append(row)
            print(f"[assignment] in turns, {set_name} {kind} "
                  f"({len(probs)} problems, graph replay): " + "; ".join(
                      f"{v} {' '.join(f'{t:.5f}' for t in row[v + '_ms'])} "
                      f"ms a launch (replays {row[v + '_spread_ms'][0]:.5f}-"
                      f"{row[v + '_spread_ms'][1]:.5f})" for v in VARIANTS))

    # the launch floor: an empty kernel (PyTorch's spin kernel for 0
    # cycles) replayed from a graph
    launch_floor = time_device_ms(lambda i: torch.cuda._sleep(0), 1,
                                  rounds=64)
    rows_out = []
    for kind in ("cascade", "match"):
        fn = public[kind]
        device_ms = time_device_ms(lambda i: fn(*card[kind][i]),
                                   ASG_TIMED_SETS)
        earlier_ms = time_device_ms(
            lambda i: run(kind, card[kind][i], VARIANTS[1]), ASG_TIMED_SETS)
        ms = sorted(time_ms(lambda: fn(*card[kind][0]))
                    for _ in range(3))[1]
        plain_ms = time_ms(lambda: plain[kind](*card[kind][0]), iters=5,
                           warmup=1)

        def library():
            host = [a.cpu().numpy() if torch.is_tensor(a) else a
                    for a in card[kind][0]]  # the copy a host solver needs
            return (scipy_cascade(*host) if kind == "cascade"
                    else scipy_solve(*host))

        library_ms = sorted(time_host_ms(library, bursts=5, burst=4)
                            for _ in range(3))[1]
        # the least work: each input read once (the R x C cost and the
        # masks), each output written once, one comparison a cost entry;
        # and no launch takes less than an empty kernel's replay
        args = card[kind][0]
        out = fn(*args)
        out = out if kind == "cascade" else (out,)
        n_bytes = sum(t.numel() * t.element_size()
                      for t in (*args, *out) if torch.is_tensor(t))
        t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
        t_ops = args[0].numel() / PEAK_F32_FLOPS * 1e3
        bound = max(t_bytes, t_ops, launch_floor)
        r = {"shape": f"{ASG_T}x{ASG_N} f32 {kind}, 24 tracks x 24 "
                      f"detections", "device_ms": device_ms,
             "earlier_ms": earlier_ms, "ms": ms,
             "plain_ms": plain_ms, "library_ms": library_ms,
             "bound_ms": bound,
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "bound_term": ("launch floor" if bound == launch_floor
                            else "work"),
             "bytes": n_bytes, "bytes_ms": t_bytes,
             "launch_floor_ms": launch_floor}
        rows_out.append(r)
        print(f"[assignment] {r['shape']}: device {device_ms:.4f} ms a solve "
              f"(graph replay, L2-resident; v1 {earlier_ms:.4f}), per call "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, scipy "
              f"{library_ms:.4f} ms (host, with the copy), bound "
              f"{bound:.6f} ms (the larger of {n_bytes} bytes once, "
              f"{t_bytes:.6f} ms, and an empty kernel's replay, "
              f"{launch_floor:.6f} ms: {r['bound_term']}); "
              f"{100 * bound / device_ms:.1f}% of the bound")
    batched, batch_probes = assignment_batch_phase(
        on_card, public, plain, plain_of, launch, same, probe,
        launch_floor)
    by_family["batched"] = sum(r["problems_checked"] for r in batched)
    probes += batch_probes
    KERNEL.launches = 0  # comparison and timing launches do not count
    main = rows_out[0]
    return {"name": KERNEL.name, "route": "cuda",
            "source": "aicamera_tpu_torch/csrc/assignment.cu",
            "replaces": KERNEL.replaces, "launches": None,
            "max_abs_err": max_err, "ms": main["ms"],
            "device_ms": main["device_ms"],
            "earlier_ms": main["earlier_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "bound_term": main["bound_term"],
            "library_ms": main["library_ms"],
            "launch_floor_ms": launch_floor,
            "problems_checked": sum(by_family.values()), "shapes": rows_out,
            "batched": batched, "turns": turns, "probe": probes}


def assignment_batch_phase(on_card, public, plain, plain_of, launch, same,
                           probe, launch_floor):
    """The batched launch (B = ``ASG_BATCH`` problems, a block each):
    bitwise against the plain version on every batch of
    :func:`assignment_batches`; the probe's sums per problem on the seeded
    and recorded batches; then, at 128x64 and at the bucketed 32x64, one
    batched launch against the same 8 problems launched one by one, in
    turns (singles, batch, batch, singles; graph replays), per call through
    the public function, the plain version (its loop over the 8), scipy on
    the host for the 8 with the copy, and the bound: the larger of the
    bytes of the 8 problems and an empty kernel's replay."""
    import numpy as np
    import torch
    from aicamera_tpu_torch.ops.assignment import VARIANTS

    batches = [(fam, kind, on_card(args))
               for fam, kind, args in assignment_batches()]
    for fam, kind, a in batches:
        got = launch(f"batch {fam}", kind, a, VARIANTS[0])
        torch.cuda.synchronize()
        same(f"batch {fam}", kind, a, VARIANTS[0], got, plain_of(kind, a))
    n_checked = sum(a[0].shape[0] for _, _, a in batches)
    print(f"[assignment] batched launch (B={ASG_BATCH}, a block a problem): "
          f"bitwise equal to the plain version on {len(batches)} batches, "
          f"{n_checked} problems (" + ", ".join(sorted({
              f for f, _, _ in batches})) + ")")

    # the probe, per problem: a batch's blocks add up as singles would
    probes = []
    for fam in ("seeded 128x64", "recorded 128x64"):
        for kind in ("cascade", "match"):
            group = [a for f, k, a in batches if f == fam and k == kind]
            probe.read_probe(reset=True)
            outs = [launch(f"probe batch {fam}", kind, a, VARIANTS[0],
                           probe) for a in group]
            torch.cuda.synchronize()
            got = probe.read_probe(reset=True)
            for a, out in zip(group, outs):
                same(f"probe batch {fam}", kind, a, VARIANTS[0], out,
                     plain_of(kind, a))
            n = got["problems"]
            check(n == ASG_BATCH * len(group), f"[assignment] probe counted "
                  f"{n} problems in {len(group)} batches")
            row = {"set": f"{fam} B={ASG_BATCH}", "kind": kind,
                   "variant": VARIANTS[0], "problems": n,
                   "launches": len(group),
                   **{k: got[k] / n for k in ("total", *ASG_PHASES,
                                               "solves", "rows_augmented",
                                               "steps")}}
            probes.append(row)
            print(f"[assignment] probe batched {fam} {kind}: {len(group)} "
                  f"launches of {ASG_BATCH}; thread 0's cycles a problem "
                  f"{row['total']:.0f} (" + ", ".join(
                      f"{k} {row[k]:.0f}" for k in ASG_PHASES)
                  + f"); a problem {row['solves']:.2f} solves, "
                    f"{row['rows_augmented']:.2f} rows augmented")

    rows = []
    for fam in ("seeded 128x64", "seeded 32x64", "recorded 128x64",
                "recorded 32x64"):
        for kind in ("cascade", "match"):
            group = [a for f, k, a in batches if f == fam and k == kind]
            fn = public[kind]
            singles = [[tuple(x[b] if torch.is_tensor(x) else x for x in a)
                        for b in range(a[0].shape[0])] for a in group]
            got = {}
            for way in ("singles", "batch", "batch", "singles"):
                one = ((lambda i: [fn(*q) for q in singles[i]])
                       if way == "singles" else (lambda i: fn(*group[i])))
                got.setdefault(way, []).append(
                    time_device_stats(one, len(group)))
            ms = sorted(time_ms(lambda: fn(*group[0])) for _ in range(3))[1]
            plain_ms = time_ms(lambda: plain[kind](*group[0]), iters=3,
                               warmup=1)

            def library():
                host = [a.cpu().numpy() if torch.is_tensor(a) else a
                        for a in group[0]]  # the copy a host solver needs
                for b in range(host[0].shape[0]):
                    q = [x[b] if isinstance(x, np.ndarray) else x
                         for x in host]
                    scipy_cascade(*q) if kind == "cascade" \
                        else scipy_solve(*q)

            library_ms = sorted(time_host_ms(library, bursts=3, burst=2)
                                for _ in range(3))[1]
            out = fn(*group[0])
            out = out if kind == "cascade" else (out,)
            n_bytes = sum(t.numel() * t.element_size()
                          for t in (*group[0], *out) if torch.is_tensor(t))
            t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
            t_ops = group[0][0].numel() / PEAK_F32_FLOPS * 1e3
            bound = max(t_bytes, t_ops, launch_floor)
            r = {"shape": f"B={ASG_BATCH} x {fam} f32 {kind}",
                 "batches": len(group),
                 "device_ms": [t[0] for t in got["batch"]],
                 "singles_device_ms": [t[0] for t in got["singles"]],
                 "spread_ms": [min(t[1] for v in got.values() for t in v),
                               max(t[2] for v in got.values() for t in v)],
                 "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                 "bound_ms": bound,
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "bound_term": ("launch floor" if bound == launch_floor
                                else "work"), "bytes": n_bytes,
                 "problems_checked": ASG_BATCH * len(group)}
            rows.append(r)
            dev = float(np.median(r["device_ms"]))
            print(f"[assignment] {r['shape']} ({len(group)} batches, graph "
                  f"replay): one launch "
                  + " ".join(f"{t:.5f}" for t in r["device_ms"])
                  + " ms against 8 single launches "
                  + " ".join(f"{t:.5f}" for t in r["singles_device_ms"])
                  + f" ms (in turns; replays {r['spread_ms'][0]:.5f}-"
                    f"{r['spread_ms'][1]:.5f} ms a set); per call "
                    f"{ms:.4f} ms, plain {plain_ms:.4f} ms, scipy "
                    f"{library_ms:.4f} ms (host, the 8 with the copy), "
                    f"bound {bound:.6f} ms ({n_bytes} bytes; "
                    f"{r['bound_term']}): {100 * bound / dev:.1f}% of it")
    return rows, probes


ORU_T = 128          # [oru]: track slots a stream, the main path's
ORU_MAX_AGE = 30     # OCSortParams().max_age: a live track's gap <= 31
ORU_TOL = 1e-5       # [oru]: relative to each slot's largest entry
ORU_TIMED_SETS = 4   # distinct input sets the timed launches rotate over
# operations of one slot, counted from csrc/oru.cu's arithmetic: the step
# sizes once a replay, then a virtual step (the interpolated box and the
# Joseph-form update: S, the Cholesky, 7 solves, K (z - x), (I - KH) P
# (I - KH)^T + K R K^T) each step, the bare predict between two
ORU_SETUP_OPS, ORU_UPDATE_OPS, ORU_PREDICT_OPS = 20, 2252, 94
# the probe's phases of a virtual step (csrc/oru.cu's ProbeSlot)
ORU_STEP_PHASES = ("gain", "joseph", "predict")


def oru_inputs(b, gap=None, replay_share=0.6, seed=0, t=ORU_T):
    """One ORU launch's inputs on the CPU: ``b`` streams of ``t`` slots, each
    slot's Kalman state and frozen state made by the plain SORT filter from
    a seeded track (initiate, 3 predict+update steps; the frozen state 2
    predicts on), the last observation near the state and the new one
    further along. ``gap``: every slot replays that many steps; ``None``:
    slot i replays ``i % (ORU_MAX_AGE + 2)`` steps (0 to 31), ``replay_share``
    of the slots chosen by the seed; ``gap=0``: no slot replays."""
    import numpy as np
    import torch
    from aicamera_tpu_torch.core import ocsort as oc
    rng = np.random.RandomState(seed)
    n = (b, t)
    z0 = np.stack([rng.uniform(0, 1280, n), rng.uniform(0, 720, n),
                   rng.uniform(400, 40000, n), rng.uniform(0.3, 3, n)], -1)
    vel = rng.normal(0, 3, n + (4,)) * np.array([1, 1, 50, 0.001])
    z0 = torch.from_numpy(z0.astype(np.float32))
    vel = torch.from_numpy(vel.astype(np.float32))
    x, p = oc.kf_initiate(z0)
    p = p.clone()
    for k in range(1, 4):
        x, p = oc.kf_predict(x, p)
        x, p = oc.kf_update(x, p, z0 + k * vel)
    fx, fp = x, p
    for _ in range(2):
        fx, fp = oc.kf_predict(fx, fp)
    if gap is None:
        g = np.broadcast_to(np.arange(t) % (ORU_MAX_AGE + 2), n)
        replay = rng.rand(*n) < replay_share
    else:
        g = np.full(n, gap)
        replay = np.full(n, gap > 0)
    g = torch.from_numpy(np.ascontiguousarray(g).astype(np.int32))
    z1 = z0 + 3 * vel
    z2 = z1 + (g[..., None] + 1).float() * vel
    return (x.contiguous(), p.contiguous(), fx.contiguous(), fp.contiguous(),
            torch.from_numpy(replay), g, z1.contiguous(), z2.contiguous())


def oru_degenerate(seed=7):
    """``B = 2`` streams of 16 slots with degenerate boxes and gaps: in z1
    and z2 an area s of 0, an aspect r of 0, both; a NaN in z2's centre and
    in its area; gaps 1, ``max_gap`` and beyond it (32, 40, 1000: the
    replay stops at ``max_gap``); a warp of 4 slots (12-15) whose replaying
    slots all roll back with gap 0 (no step) beside one that does not
    replay though its gap is set."""
    x, p, fx, fp, replay, gap, z1, z2 = oru_inputs(2, seed=seed, t=16)
    nan = float("nan")
    # (gap, z1 column and value, z2 column and value) by slot
    edits = [(1, None, None), (2, (2, 0.0), None), (5, None, (2, 0.0)),
             (ORU_MAX_AGE + 1, (3, 0.0), None), (32, None, (3, 0.0)),
             (40, (2, 0.0), (2, 0.0)), (1000, None, None),
             (3, None, (0, nan)), (8, None, (2, nan)),
             (8, (3, 0.0), (3, 0.0)), (31, (2, 0.0), (3, 0.0)),
             (6, (2, 0.0), (2, nan)), (0, None, None), (0, (2, 0.0), None),
             (12, None, None), (0, None, None)]
    for t, (g, a, b) in enumerate(edits):
        gap[:, t] = g
        if a is not None:
            z1[:, t, a[0]] = a[1]
        if b is not None:
            z2[:, t, b[0]] = b[1]
    replay[:] = True
    replay[:, 14] = False
    return x, p, fx, fp, replay, gap, z1, z2


def oru_cases():
    """``[(name, inputs)]`` the card checks the kernel on: B = 1 and 8
    streams with every gap from 0 to ``ORU_MAX_AGE + 1`` on mixed masks, no
    replay, every slot at gap 8 and at 31, a small ragged stack (111 slots:
    a last block of 7) and the degenerate boxes and gaps."""
    return [("B=8 mixed gaps 0-31", oru_inputs(8, seed=1)),
            ("B=1 mixed gaps 0-31", oru_inputs(1, seed=2)),
            ("B=8 no replay", oru_inputs(8, gap=0, seed=3)),
            ("B=8 gap 8", oru_inputs(8, gap=8, seed=4)),
            ("B=8 gap 31", oru_inputs(8, gap=31, seed=5)),
            ("B=3 T=37 mixed", oru_inputs(3, seed=6, t=37)),
            ("B=2 T=16 degenerate", oru_degenerate())]


def same_bits(a, b):
    """Elementwise: the same bits, or NaN in both."""
    import torch
    return ((a.view(torch.int32) == b.view(torch.int32))
            | (torch.isnan(a) & torch.isnan(b)))


def oru_compare(got, want):
    """Kernel ``got`` against plain ``want`` (each ``(x, p)``): the largest
    error of a slot's finite x and p entries over that slot's largest
    finite entry (at least 1), infinite where a NaN or an infinity of one
    is not the other's; the lanes bitwise equal (NaN where NaN), and the
    lanes."""
    import torch
    rel = 0.0
    for g, w, dims in ((got[0], want[0], (-1,)), (got[1], want[1], (-2, -1))):
        odd = ~(torch.isfinite(g) & torch.isfinite(w))
        if bool((odd & ~same_bits(g, w)).any()):
            return float("inf"), *oru_lanes_same(got, want)
        err = torch.where(odd, 0.0, g - w).abs().amax(dims)
        scale = torch.where(odd, 0.0, w).abs().amax(dims).clamp(min=1.0)
        rel = max(rel, float((err / scale).max()))
    return (rel, *oru_lanes_same(got, want))


def oru_lanes_same(got, want):
    """``(lanes bitwise equal, lanes)`` of two ``(x, p)``: a lane is a
    slot's x and p, NaN where NaN."""
    same = (same_bits(got[0], want[0]).all(-1)
            & same_bits(got[1], want[1]).all(-1).all(-1))
    return int(same.sum()), same.numel()


def oru_finite_err(got, want):
    """The largest absolute difference of the finite entries."""
    import torch
    return max(float(torch.where(torch.isfinite(g) & torch.isfinite(w),
                                 g - w, 0.0).abs().max())
               for g, w in zip(got, want))


def oru_work(args, max_gap=ORU_MAX_AGE + 1):
    """``(bytes, operations)`` this launch's data needs: every slot reads its
    state (the frozen one where it replays), its mask and gap, a replaying
    slot its two observations, and writes its state; the operations of the
    steps each slot replays."""
    x, _, _, _, replay, gap = args[:6]
    lanes = replay.numel()
    n_rep = int(replay.sum())
    steps = gap.clamp(max=max_gap)[replay].long().clamp(min=0)
    n_bytes = lanes * (56 * 4 * 2 + 1 + 4) + n_rep * 8 * 4
    ops = (n_rep * ORU_SETUP_OPS + int(steps.sum()) * ORU_UPDATE_OPS
           + int((steps - 1).clamp(min=0).sum()) * ORU_PREDICT_OPS)
    return n_bytes, ops


class OruChecks:
    """Both designs of the ORU kernel on one set of card inputs: the
    default design through the public ``oru_replay``, ``v1`` through the
    wrapper, one launch each; the two bitwise equal on every lane (NaN
    where NaN), each within ``ORU_TOL`` of ``oru_replay_plain`` on the same
    tensors, slots without a replay unchanged. Counts the lanes."""

    def __init__(self):
        self.lanes = self.designs_bitwise = self.plain_bitwise = 0
        self.rel = self.abs = 0.0

    def hold(self, tag, card, max_gap):
        import torch
        from aicamera_tpu_torch.core import ocsort as oc
        from aicamera_tpu_torch.ops.oru import KERNEL, VARIANTS
        before = KERNEL.launches
        got = oc.oru_replay(*card, max_gap)
        check(KERNEL.launches == before + 1, f"[oru] {tag}: the default "
              f"design did not launch once")
        old = KERNEL(*card, max_gap, variant=VARIANTS[1])
        check(KERNEL.launches == before + 2, f"[oru] {tag}: v1 did not "
              f"launch once")
        torch.cuda.synchronize()
        want = oc.oru_replay_plain(*card, max_gap)
        same, n = oru_lanes_same(got, old)
        check(same == n, f"[oru] {tag}: {n - same} of {n} lanes of the "
              f"{VARIANTS[0]} design differ from v1's")
        for design, out in ((VARIANTS[0], got), (VARIANTS[1], old)):
            rel, _, _ = oru_compare(out, want)
            check(rel <= ORU_TOL, f"[oru] {tag}: {design} vs plain {rel:.3g}"
                  f" of a slot's scale (tolerance {ORU_TOL})")
            self.rel = max(self.rel, rel)
            self.abs = max(self.abs, oru_finite_err(out, want))
        idle = ~card[4]
        check(torch.equal(got[0][idle], card[0][idle])
              and torch.equal(got[1][idle], card[1][idle]),
              f"[oru] {tag}: a slot without a replay changed")
        exact, _ = oru_lanes_same(got, want)
        self.lanes += n
        self.designs_bitwise += same
        self.plain_bitwise += exact
        return got, exact, n

    def line(self):
        from aicamera_tpu_torch.ops.oru import VARIANTS
        return (f"{VARIANTS[0]} bitwise v1 on {self.designs_bitwise} of "
                f"{self.lanes} lanes; both within {self.rel:.3g} of a slot's "
                f"scale of the plain version (tolerance {ORU_TOL}, max "
                f"|diff| {self.abs:.3g}), bitwise on {self.plain_bitwise}")


def design_turns(launch_of, n_sets, designs, rounds=8):
    """Designs timed in turns, each in order and then back in the reverse
    order (ORU: v1, rows, rows, v1): graph replays of
    ``launch_of(design)(i)`` over ``n_sets`` sets, ``rounds`` times each;
    per design the two medians and the replays' least and most, ms a
    launch."""
    got = {}
    for design in tuple(designs) + tuple(designs)[::-1]:
        got.setdefault(design, []).append(
            time_device_stats(launch_of(design), n_sets, rounds=rounds))
    return {d: {"ms": [t[0] for t in ts],
                "spread_ms": [min(t[1] for t in ts), max(t[2] for t in ts)]}
            for d, ts in got.items()}


def turns_line(turns):
    return "; ".join(
        f"{v} {' '.join(f'{t:.5f}' for t in r['ms'])} ms (replays "
        f"{r['spread_ms'][0]:.5f}-{r['spread_ms'][1]:.5f})"
        for v, r in turns.items())


def oru_probe(device, max_gap, sm_mhz):
    """The phase probe of both designs (a second build with
    ``-DAICAM_ORU_PROBE``) on the timed shapes' first input set and the
    mixed stack: per slot its load and store cycles, a virtual step's
    cycles by phase (gain, Joseph product, predict), a block's cycles from
    entry to exit; the probe build's outputs bitwise v1's."""
    import torch
    from aicamera_tpu_torch.ops.oru import KERNEL, VARIANTS, OruKernel
    probe = OruKernel(probe=True)
    rows = []
    shapes = [(f"B={b} T={ORU_T} " + (f"gap {g}" if g else "no replay"),
               oru_inputs(b, gap=g, seed=0)) for b in (1, 8)
              for g in (0, 8, 31)]
    shapes.append(("B=8 mixed gaps 0-31", oru_inputs(8, seed=1)))
    for name, args in shapes:
        card = [a.to(device) for a in args]
        want = KERNEL(*card, max_gap, variant=VARIANTS[1])
        for variant in VARIANTS:
            probe.read_probe(reset=True)
            out = probe(*card, max_gap, variant=variant)
            torch.cuda.synchronize()
            got = probe.read_probe(reset=True)
            same, n = oru_lanes_same(out, want)
            check(same == n, f"[oru] probe {variant} {name}: {n - same} "
                  f"lanes differ from v1")
            slots = got["slots"]
            check(slots == n, f"[oru] probe counted {slots} slots of {n}")
            steps = got["steps"]
            row = {"shape": name, "variant": variant, "slots": slots,
                   "replaying": got["replaying"], "steps": steps,
                   "blocks": got["blocks"],
                   "load_cycles_a_slot": got["load"] / slots,
                   "store_cycles_a_slot": got["store"] / slots,
                   **{f"{k}_cycles_a_step": got[k] / steps if steps else None
                      for k in ORU_STEP_PHASES},
                   "block_cycles": got["total"] / got["blocks"]}
            row["step_cycles"] = (sum(got[k] for k in ORU_STEP_PHASES)
                                  / steps if steps else None)
            row["us_a_step_at_max_clock"] = (
                row["step_cycles"] / sm_mhz[1] if steps else None)
            rows.append(row)
            step = ("" if not steps else
                    f", a virtual step {row['step_cycles']:.0f} cycles ("
                    + ", ".join(f"{k} {row[k + '_cycles_a_step']:.0f}"
                                for k in ORU_STEP_PHASES)
                    + f"; {row['us_a_step_at_max_clock']:.3f} us at "
                      f"{sm_mhz[1]:.0f} MHz)")
            print(f"[oru] probe {variant} {name}: {slots} slots, "
                  f"{got['replaying']} replaying, {got['steps']} steps, "
                  f"{got['blocks']} blocks; a slot's leading thread: load "
                  f"{row['load_cycles_a_slot']:.0f} cycles, store "
                  f"{row['store_cycles_a_slot']:.0f}{step}; a block "
                  f"{row['block_cycles']:.0f} cycles entry to exit")
    return rows


def oru_phase(device):
    """Both designs of the ORU kernel (``csrc/oru.cu``): the default through
    the public ``oru_replay`` and ``v1`` through the wrapper, on card
    tensors, against each other bitwise and against ``oru_replay_plain`` on
    the same tensors within ``ORU_TOL`` of each slot's scale, on
    :func:`oru_cases` and every timed set; the phase probe of both; both
    timed in turns by graph replay at B = 1 and 8, T = 128, with no replay,
    every slot at gap 8 and at 31, with the default design's time per call,
    the plain version's, and the bound: the larger of the bytes and
    operations of the launch's data and an empty kernel's replay."""
    import numpy as np
    import torch
    from aicamera_tpu_torch.core import ocsort as oc
    from aicamera_tpu_torch.ops.oru import KERNEL, VARIANTS

    max_gap = ORU_MAX_AGE + 1
    checks = OruChecks()
    for name, args in oru_cases():
        _, exact, n = checks.hold(name, [a.to(device) for a in args],
                                  max_gap)
        print(f"[oru] {name}: {VARIANTS[0]} bitwise v1 on all {n} lanes, "
              f"{exact} bitwise the plain version")
    try:
        KERNEL(*oru_cases()[0][1], max_gap)
        check(False, "[oru] the kernel took CPU tensors")
    except ValueError:
        pass
    sm_mhz = sm_clock_mhz()
    probes = oru_probe(device, max_gap, sm_mhz)

    launch_floor = time_device_ms(lambda i: torch.cuda._sleep(0), 1,
                                  rounds=64)
    rows = []
    for b in (1, 8):
        for gap in (0, 8, 31):
            shape = f"B={b} T={ORU_T} " + (f"gap {gap}" if gap
                                           else "no replay")
            sets = [[a.to(device) for a in oru_inputs(b, gap=gap, seed=s)]
                    for s in range(ORU_TIMED_SETS)]
            for i, card in enumerate(sets):
                checks.hold(f"{shape} set {i}", card, max_gap)
            outs = [None] * len(sets)

            def launch_of(variant):
                def launch(i):
                    outs[i] = KERNEL(*sets[i], max_gap, variant=variant)
                return launch

            turns = design_turns(launch_of, len(sets),
                                 (VARIANTS[1], VARIANTS[0]))
            ms = sorted(time_ms(lambda: oc.oru_replay(*sets[0], max_gap))
                        for _ in range(3))[1]
            plain_ms = time_ms(lambda: oc.oru_replay_plain(*sets[0],
                                                           max_gap),
                               iters=3, warmup=1)
            n_bytes, ops = oru_work(sets[0], max_gap)
            t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_F32_FLOPS * 1e3
            bound = max(t_bytes, t_ops, launch_floor)
            device_ms = float(np.median(turns[VARIANTS[0]]["ms"]))
            earlier_ms = float(np.median(turns[VARIANTS[1]]["ms"]))
            r = {"shape": shape, "device_ms": device_ms,
                 "earlier_ms": earlier_ms, "turns": turns, "ms": ms,
                 "plain_ms": plain_ms, "library_ms": None,
                 "bound_ms": bound,
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "bound_term": ("launch floor" if bound == launch_floor
                                else "work"),
                 "bytes": n_bytes, "ops": ops}
            rows.append(r)
            print(f"[oru] {shape} in turns (graph replay, L2-resident, ms a "
                  f"launch): {turns_line(turns)}; {VARIANTS[0]} "
                  f"{100 * bound / device_ms:.1f}% of the bound, v1 "
                  f"{100 * bound / earlier_ms:.1f}%; per call {ms:.4f} ms, "
                  f"plain {plain_ms:.3f} ms, bound {bound:.6f} ms (the "
                  f"larger of {n_bytes} bytes, {t_bytes:.6f} ms, {ops} "
                  f"operations, {t_ops:.6f} ms, and an empty kernel's "
                  f"replay, {launch_floor:.6f} ms: {r['bound_term']}); "
                  f"library: no single PyTorch call")
    print(f"[oru] checked: {checks.line()}")
    KERNEL.launches = 0  # comparison and timing launches do not count
    main = rows[3]   # B=8 with no replay: the [streams] stack's usual frame
    return {"name": KERNEL.name, "route": "cuda",
            "source": "aicamera_tpu_torch/csrc/oru.cu",
            "replaces": KERNEL.replaces, "launches": None,
            "max_abs_err": checks.abs, "max_rel_err": checks.rel,
            "ms": main["ms"], "device_ms": main["device_ms"],
            "earlier_ms": main["earlier_ms"],
            "device_ms_by_design": {VARIANTS[0]: main["device_ms"],
                                    VARIANTS[1]: main["earlier_ms"]},
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "bound_term": main["bound_term"],
            "library_ms": None, "launch_floor_ms": launch_floor,
            "lanes_checked": checks.lanes,
            "lanes_bitwise_designs": checks.designs_bitwise,
            "lanes_bitwise_plain": checks.plain_bitwise,
            "shapes": rows, "probe": probes}


def oru_main_path(pipe, chunks, device, record=None):
    """The ORU kernel on the ``[streams]`` OC-SORT stack's own inputs: the
    stack rerun over the same chunks from fresh states with its scans eager
    (a captured scan calls the step only while it captures), a spy on
    ``core.ocsort.oru_replay`` cloning every frame's arguments; then how
    many frames replay and the gap histogram, both designs held on every
    frame's inputs as in ``[oru]``, and both timed in turns over the
    frames. The row goes into ``record`` (the kernel's JSON record)."""
    import collections
    import numpy as np
    import torch
    from aicamera_tpu_torch.core import ocsort as oc
    from aicamera_tpu_torch.ops.oru import KERNEL, VARIANTS

    frames = []
    real = oc.oru_replay

    def spy(*args, **kw):
        frames.append([a.clone() for a in args[:8]] + [args[8]])
        return real(*args, **kw)

    for i in range(pipe.n_streams):
        pipe.reset_stream(i)
    oc.oru_replay = spy
    try:
        with eager_scans(pipe), torch.no_grad():
            for c in chunks:
                pipe.step_chunk(c)
        torch.cuda.synchronize()
    finally:
        oc.oru_replay = real
    check(len(frames) == len(chunks) * chunks[0].shape[1], f"[oru] "
          f"{len(frames)} ORU calls in {len(chunks)} chunks")
    max_gap = frames[0][8]
    checks = OruChecks()
    hist = collections.Counter()
    replaying = 0
    for i, f in enumerate(frames):
        checks.hold(f"main path frame {i}", f[:8], max_gap)
        g = f[5][f[4]].tolist()
        replaying += bool(g)
        hist.update(g)
    outs = [None] * len(frames)

    def launch_of(variant):
        def launch(i):
            outs[i] = KERNEL(*frames[i][:8], max_gap, variant=variant)
        return launch

    turns = design_turns(launch_of, len(frames), (VARIANTS[1], VARIANTS[0]))
    work = [oru_work(f[:8], max_gap) for f in frames]
    launch_floor = time_device_ms(lambda i: torch.cuda._sleep(0), 1,
                                  rounds=64)
    bound = max(launch_floor, max(b for b, _ in work) / PEAK_BYTES_PER_S
                * 1e3, max(o for _, o in work) / PEAK_F32_FLOPS * 1e3)
    KERNEL.launches = 0
    row = {"frames": len(frames), "shape": tuple(frames[0][0].shape),
           "frames_replaying": replaying,
           "gap_histogram": dict(sorted(hist.items())), "turns": turns,
           "device_ms": float(np.median(turns[VARIANTS[0]]["ms"])),
           "earlier_ms": float(np.median(turns[VARIANTS[1]]["ms"])),
           "bound_ms": bound, "lanes_checked": checks.lanes,
           "lanes_bitwise_designs": checks.designs_bitwise,
           "lanes_bitwise_plain": checks.plain_bitwise}
    print(f"[oru] the [streams] OC-SORT stack's own inputs: {len(frames)} "
          f"frames of {tuple(frames[0][0].shape)[:-1]} slots, "
          f"{replaying} with a replay, gaps {row['gap_histogram']}; "
          f"{checks.line()}")
    print(f"[oru] those frames in turns (graph replay, ms a launch): "
          f"{turns_line(turns)}; bound {bound:.6f} ms: {VARIANTS[0]} "
          f"{100 * bound / row['device_ms']:.1f}% of it, v1 "
          f"{100 * bound / row['earlier_ms']:.1f}%")
    if record is not None:
        record["main_path"] = row
    return row


NMS_THR = 0.5        # config.YOLO_NMS_THRESHOLD, the detect paths' default
NMS_TOPK = 300       # config.YOLO_NMS_TOPK: candidates a frame, detect paths
NMS_TILED_K = 500    # the 2x2 tiled merge with the full frame: 5 x 100
NMS_TIMED_SETS = 8   # distinct input sets the timed launches rotate over


def nms_scene(b, k, seed=0, classes=4, frame_hw=(640, 640),
              valid="prefix"):
    """A seeded crowded scene of ``b`` frames of ``k`` candidates on the
    CPU, unshifted: ``(boxes (b, k, 4) f32, cls (b, k) int32, valid (b, k)
    bool)``. Each frame has ``k // 6`` objects, each candidate a jittered
    copy of one object's box (a detector's duplicates: IoUs from 0 to 1),
    mostly of its object's class. ``valid``: ``"prefix"`` (score-ordered
    candidates above the floor: a seeded prefix of each frame), ``"all"``
    or ``"none"``."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    h, w = frame_hw
    n_obj = max(1, k // 6)
    ctr = rng.uniform(0, 1, (b, n_obj, 2)) * np.array([w, h])
    size = rng.uniform(8, 0.25 * min(h, w), (b, n_obj, 2))
    obj_cls = rng.randint(0, classes, (b, n_obj))
    pick = rng.randint(0, n_obj, (b, k))
    c = np.take_along_axis(ctr, pick[..., None], 1)
    s = np.take_along_axis(size, pick[..., None], 1)
    boxes = np.concatenate([c - s / 2, c + s / 2], -1)
    boxes += rng.normal(0, 0.12, (b, k, 4)) * np.concatenate([s, s], -1)
    cls = np.take_along_axis(obj_cls, pick, 1)
    stray = rng.rand(b, k) < 0.1
    cls = np.where(stray, rng.randint(0, classes, (b, k)), cls)
    if valid == "prefix":
        n = rng.randint(k // 2, k + 1, b)
        mask = np.arange(k)[None] < n[:, None]
    else:
        mask = np.full((b, k), valid == "all")
    return (torch.from_numpy(np.ascontiguousarray(boxes, np.float32)),
            torch.from_numpy(cls.astype(np.int32)), torch.from_numpy(mask))


def nms_inputs(b, k, seed=0, classes=4, frame_hw=(640, 640),
               offset=8192.0, valid="prefix"):
    """One keep's inputs on the CPU, as the first design took them: the
    scene of :func:`nms_scene` shifted by ``class * offset``, ``(shifted
    (b, k, 4) f32, valid (b, k) bool)``."""
    import numpy as np
    import torch
    boxes, cls, mask = nms_scene(b, k, seed, classes, frame_hw, valid)
    shifted = (boxes.numpy()
               + (cls.numpy().astype(np.float32)
                  * np.float32(offset))[..., None])
    return torch.from_numpy(np.ascontiguousarray(shifted, np.float32)), mask


def nms_scores(b, k, seed=0):
    """Seeded ``(b, k)`` f32 scores that do not increase along K, as the
    tail's callers sort them: ties among them (two decimals) and a tail at
    or below 0 (a candidate there is not emitted even where kept)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(1000 + seed)
    s = np.round(rng.uniform(-0.1, 1.0, (b, k)), 2)
    return torch.from_numpy(-np.sort(-s, axis=1).astype(np.float32))


def nms_tail_case(name, shifted, valid, thr, criterion, max_det=100,
                  seed=0):
    """A keep case as a case of the tail: the boxes as given with every
    class 0 (a shift of 0: the same kept set) and :func:`nms_scores`.
    ``(name, boxes, score, cls, valid, thr, criterion, max_det,
    class_offset)``."""
    import torch
    b, k = valid.shape
    return (name, shifted, nms_scores(b, k, seed),
            torch.zeros((b, k), dtype=torch.int32), valid, thr, criterion,
            max_det, 8192.0)


def nms_tail_cases(card_only=False):
    """The tail's cases (``(name, boxes, score, cls, valid, thr, criterion,
    max_det, class_offset)`` on the CPU): every case of :func:`nms_cases`
    at max_det 100 (K = 1 and 33 below it), and the emit's own: max_det
    below the kept count, max_det past K, classes shifted by the main
    path's offset (8192) and by the tiled merge's frame-scaled one (2 x
    960 at 540x960), by IoU and by IoS."""
    cases = [nms_tail_case(*c, seed=i)
             for i, c in enumerate(nms_cases(card_only))]
    tiled = dict(frame_hw=(540, 960))
    for name, (b, k, seed, kw), thr, crit, max_det, offset in (
            ("B=8 K=300 classes, max_det 5", (8, NMS_TOPK, 21, {}),
             NMS_THR, "iou", 5, 8192.0),
            ("B=8 K=300 classes, max_det 100", (8, NMS_TOPK, 22, {}),
             NMS_THR, "iou", 100, 8192.0),
            ("B=2 K=40 classes, max_det 64 > K", (2, 40, 23, {}), NMS_THR,
             "iou", 64, 8192.0),
            ("B=1 K=500 tiled merge iou, offset 1920",
             (1, NMS_TILED_K, 24, tiled), NMS_THR, "iou", 100, 1920.0),
            ("B=1 K=500 tiled merge ios, offset 1920",
             (1, NMS_TILED_K, 24, tiled), NMS_THR, "ios", 100, 1920.0),
            ("B=4 K=500 classes ios, max_det 7", (4, NMS_TILED_K, 25, {}),
             0.6, "ios", 7, 8192.0)):
        boxes, cls, valid = nms_scene(b, k, seed, **kw)
        cases.append((name, boxes, nms_scores(b, k, seed), cls, valid, thr,
                      crit, max_det, offset))
    return cases


def nms_chain(b, k):
    """The worst case of the fixpoint: box i overlaps only boxes i - 1 and
    i + 1 (IoU 0.6), so each kept box frees the next but one, and the JAX
    loop and the plain eager form take K steps."""
    import numpy as np
    import torch
    x = np.arange(k, dtype=np.float32) * 2.5
    one = np.stack([x, np.zeros(k), x + 10.0, np.full(k, 10.0)], -1)
    shifted = np.broadcast_to(one.astype(np.float32), (b, k, 4)).copy()
    return torch.from_numpy(shifted), torch.ones((b, k), dtype=torch.bool)


def nms_odd_boxes(b=8, k=300, seed=11):
    """A crowded scene with NaN, infinite, zero-area and inverted boxes
    among the candidates, and pairs whose overlap is exactly 0.3 (IoU
    3/10 and IoS 3/10, where the f32 threshold 0.3 rounds up and a
    comparison in double would differ)."""
    import torch
    shifted, valid = nms_inputs(b, k, seed=seed)
    nan, inf = float("nan"), float("inf")
    odd = [(nan, 0.0, 10.0, 10.0), (0.0, nan, 10.0, 10.0),
           (0.0, 0.0, nan, nan), (-inf, 0.0, inf, 10.0),
           (0.0, 0.0, inf, inf), (5.0, 5.0, 5.0, 5.0), (9.0, 9.0, 1.0, 1.0),
           (0.0, 0.0, 10.0, 1.0), (0.0, 0.0, 3.0, 1.0),
           (7.0, 0.0, 17.0, 1.0), (inf, inf, inf, inf),
           (-inf, -inf, -inf, -inf), (nan, nan, nan, nan)]
    for f in range(b):
        for n, box in enumerate(odd):
            i = (7 * n + 3 * f) % k
            shifted[f, i] = torch.tensor(box)
        valid[f, :40] = True
    return shifted, valid


def nms_cases(card_only=False):
    """``[(name, shifted, valid, threshold, criterion)]`` on the CPU: the
    shapes of every detect path (the main path's chunk B = 8 and the
    facade B = 1 at K = 300; the tiled
    merge at K = 500 in frame space, by IoU and by IoS), seeded crowded
    scenes, the suppression chain of length K, K not a multiple of 32, no
    candidate valid and every one valid, NaN, infinite and degenerate
    boxes, overlaps exactly at the threshold, and K past 32 words (1100).
    ``card_only`` adds what the CPU tests leave to the card: the
    ``[streams]`` dispatch's B = 32, B = 2 at K = 4096 and B = 1 at
    ``ops.nms.MAX_K``."""
    from aicamera_tpu_torch.ops.nms import MAX_K
    tiled = dict(frame_hw=(540, 960))
    cases = [("B=8 K=300 crowded", *nms_inputs(8, NMS_TOPK, seed=1),
              NMS_THR, "iou"),
             ("B=8 K=300 crowded seed 2", *nms_inputs(8, NMS_TOPK, seed=2),
              0.45, "iou"),
             ("B=1 K=300 crowded", *nms_inputs(1, NMS_TOPK, seed=4),
              NMS_THR, "iou"),
             ("B=1 K=500 tiled iou", *nms_inputs(1, NMS_TILED_K, seed=5,
                                                 **tiled), NMS_THR, "iou"),
             ("B=1 K=500 tiled ios", *nms_inputs(1, NMS_TILED_K, seed=5,
                                                 **tiled), NMS_THR, "ios"),
             ("B=8 K=500 crowded ios", *nms_inputs(8, NMS_TILED_K, seed=6),
              0.7, "ios"),
             ("B=1 K=300 chain", *nms_chain(1, NMS_TOPK), NMS_THR, "iou"),
             ("B=1 K=500 chain ios", *nms_chain(1, NMS_TILED_K), NMS_THR,
              "ios"),
             ("B=8 K=33", *nms_inputs(8, 33, seed=7), NMS_THR, "iou"),
             ("B=1 K=1", *nms_inputs(1, 1, seed=8), NMS_THR, "iou"),
             ("B=8 K=300 none valid", *nms_inputs(8, NMS_TOPK, seed=9,
                                                  valid="none"),
              NMS_THR, "iou"),
             ("B=8 K=300 all valid", *nms_inputs(8, NMS_TOPK, seed=10,
                                                 valid="all"),
              NMS_THR, "iou"),
             ("B=8 K=300 odd boxes iou", *nms_odd_boxes(), 0.3, "iou"),
             ("B=8 K=300 odd boxes ios", *nms_odd_boxes(), 0.3, "ios"),
             ("B=1 K=1100 crowded", *nms_inputs(1, 1100, seed=12),
              NMS_THR, "iou")]
    if card_only:
        cases += [("B=32 K=300 crowded", *nms_inputs(32, NMS_TOPK, seed=3),
                   NMS_THR, "iou"),
                  ("B=2 K=4096 crowded", *nms_inputs(2, 4096, seed=13),
                   NMS_THR, "iou"),
                  (f"B=1 K={MAX_K} crowded", *nms_inputs(1, MAX_K, seed=14),
                   NMS_THR, "iou")]
    return cases


NMS_PAIR_OPS = 14    # a pair's overlap in csrc/nms.cu: 4 max/min, 2 sub,
#                      2 clamps, mul, add, sub (or min), clamp, div, compare
NMS_BOX_OPS = 5      # a box's area: 2 sub, 2 clamps, mul
NMS_SHIFT_OPS = 6    # a box's class shift: int to float, mul, 4 adds
NMS_SLOT_BYTES = 24  # an output slot: box 16, score 4, label 4
TAIL_PARTS = ("num", "boxes", "scores", "labels", "kept")


class KernelStandIn:
    """Stands for ``ops.nms.KERNEL`` inside ``with`` (``_suppress_and_emit``
    looks it up at each call); ``self.kernel`` is the kernel."""

    def __enter__(self):
        from aicamera_tpu_torch.ops import nms
        self.kernel = nms.KERNEL
        nms.KERNEL = self
        return self

    def __exit__(self, *exc):
        from aicamera_tpu_torch.ops import nms
        nms.KERNEL = self.kernel


class SpyKernel(KernelStandIn):
    """Records a clone of every call's arguments, then calls the kernel."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(tuple(a.clone() if hasattr(a, "clone") else a
                                for a in args))
        return self.kernel(*args)


class PlainTail(KernelStandIn):
    """A yardstick: the plain tail in its fixed-K form, which reads nothing
    and captures, where the kernel would run."""

    def __call__(self, k_boxes, k_score, k_cls, k_valid, threshold, max_det,
                 class_offset, criterion="iou"):
        from aicamera_tpu_torch.ops.nms import suppress_and_emit_plain
        return suppress_and_emit_plain(k_boxes, k_score, k_cls, k_valid,
                                       threshold, k_valid.shape[-1], max_det,
                                       class_offset, criterion, True)


def v1_tail(k_boxes, k_score, k_cls, k_valid, threshold, max_det,
            class_offset, criterion="iou"):
    """The tail as the first design ran it: the class shift and the emit as
    eager PyTorch launches around the v1 keep's two."""
    from aicamera_tpu_torch.ops.nms import KERNEL, emit_plain
    shifted = k_boxes + (k_cls.float() * class_offset)[..., None]
    kept = KERNEL.keep_v1(shifted, k_valid, threshold, criterion)
    k = k_valid.shape[-1]
    return (*emit_plain(kept, k_boxes, k_score, k_cls, k, max_det), kept)


CARD_NMS_READS = [0]  # reads of CUDA tensors by ops.nms.NMS_SYNCS


def watch_nms_reads():
    """Counts, in ``CARD_NMS_READS``, every read ``ops.nms.NMS_SYNCS`` takes
    of a CUDA tensor: the plain keep's eager form on the card, which no path
    runs. Only the yardsticks of ``[nms]`` and ``[engine]`` run it, and they
    set the count back (:func:`yardstick_reads`)."""
    from aicamera_tpu_torch.ops.nms import NMS_SYNCS
    flag = NMS_SYNCS.flag

    def counted(t):
        CARD_NMS_READS[0] += bool(t.is_cuda)
        return flag(t)

    NMS_SYNCS.flag = counted


@contextlib.contextmanager
def yardstick_reads():
    """Inside, reads of the plain keep on the card do not count as a path's
    (``CARD_NMS_READS`` is set back on exit)."""
    before = CARD_NMS_READS[0]
    try:
        yield
    finally:
        CARD_NMS_READS[0] = before


def nms_work(valid, max_det):
    """``(bytes, operations)`` one call of the tail must do for ``valid (B,
    K)``, counted from this data: the greedy keep needs only the valid
    candidates, so a frame with n valid reads n boxes, scores and classes
    (24 bytes each) and its K valid bytes, writes its K kept bytes, its
    ``max_det`` output slots and its count, and computes n shifts and
    areas and the n (n - 1) / 2 overlaps among them."""
    b, k = valid.shape[0], valid.shape[-1]
    n = [int(x) for x in valid.reshape(b, k).sum(-1).tolist()]
    n_bytes = sum(24 * m + 2 * k + NMS_SLOT_BYTES * max_det + 4 for m in n)
    ops = sum(m * (NMS_SHIFT_OPS + NMS_BOX_OPS)
              + m * (m - 1) // 2 * NMS_PAIR_OPS for m in n)
    return n_bytes, ops


def nms_main_path_inputs(device):
    """The main path's own candidates: one chunk of ``TrackingPipeline``
    (the main path's settings, its first 8 seeded frames) with the kernel's
    arguments recorded (``SpyKernel``): B = 8, K = 300, ``(k_boxes,
    k_score, k_cls, k_valid, threshold, max_det, class_offset,
    criterion)``."""
    from aicamera_tpu_torch.scenes import moving_rectangles
    frames = moving_rectangles(N_CHUNKS * CHUNK, FRAME_HW, n_objects=6,
                               seed=SEED)[:CHUNK]
    pipe = make_pipeline(device)
    # the eager step: the captured one calls the kernel's wrapper only in
    # its pass before the capture and in the capture
    with eager_step(pipe), SpyKernel() as spy:
        list(pipe.process_frames(iter(frames)))
    check(len(spy.calls) == 1, f"[nms] {len(spy.calls)} NMS calls in one "
          f"main-path chunk")
    return spy.calls[0]


def bit_diffs(a, b):
    """Elements of ``a`` whose bits differ from ``b``'s (all of them where
    the shapes or types differ): NaN equals NaN of the same bits."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return max(a.numel(), 1)
    if a.dtype == torch.float32:
        a, b = a.contiguous().view(torch.int32), b.contiguous().view(
            torch.int32)
    return int((a != b).sum())


def nms_hold(tag, args, fixed=True, cpu=True):
    """The one-launch kernel through its wrapper against the plain tail on
    the same card tensors, eager and (``fixed``) fixed-K, and (``cpu``) the
    plain tail on the CPU, all five outputs; its kept set against the first
    design's (``keep_v1`` of the plain shift); bitwise. ``args``: the
    kernel's ``(k_boxes, k_score, k_cls, k_valid, threshold, max_det,
    class_offset, criterion)``. Returns the outputs, the forms held and the
    most elements that differed from one of them."""
    import torch
    from aicamera_tpu_torch.ops.nms import KERNEL, suppress_and_emit_plain
    boxes, score, cls, valid, thr, max_det, offset, crit = args
    k = valid.shape[-1]
    before = KERNEL.launches
    got = KERNEL(*args)
    check(KERNEL.launches == before + 1, f"[nms] {tag}: not one launch")
    torch.cuda.synchronize()
    with yardstick_reads():
        wants = {"eager": suppress_and_emit_plain(
            boxes, score, cls, valid, thr, k, max_det, offset, crit)}
    if fixed:
        wants["fixed-K"] = suppress_and_emit_plain(
            boxes, score, cls, valid, thr, k, max_det, offset, crit, True)
    if cpu:
        wants["CPU"] = [t.to(boxes.device) for t in suppress_and_emit_plain(
            boxes.cpu(), score.cpu(), cls.cpu(), valid.cpu(), thr, k,
            max_det, offset, crit)]
    diffs = []
    for form, want in wants.items():
        for part, a, w in zip(TAIL_PARTS, got, want):
            diffs.append(bit_diffs(a, w))
            check(diffs[-1] == 0, f"[nms] {tag}: {diffs[-1]} of {a.numel()} "
                  f"{part} differ from the plain tail's {form} form")
    shifted = boxes + (cls.float() * offset)[..., None]
    diffs.append(bit_diffs(got[4], KERNEL.keep_v1(shifted, valid, thr,
                                                  crit)))
    check(diffs[-1] == 0, f"[nms] {tag}: {diffs[-1]} kept bits differ from "
          f"the first design's")
    check(not bool((got[4] & ~valid).any()), f"[nms] {tag}: kept an invalid "
          f"candidate")
    return got, tuple(wants) + ("v1 keep",), max(diffs)


NMS_PHASES = ("count", "stage", "shift", "diag", "resolve", "items", "wait",
              "emit", "stream", "tail")


def nms_probe(shape_sets):
    """The one-launch design's phase probe (a second build with
    ``-DAICAM_NMS_PROBE``) on each timed shape's first set, after a
    warm-up call: a block's cycles by phase on thread 0's clock (n while
    the staging copy is in flight, the rest of the copy's wait, the shift,
    the diagonal words; in the scan its resolves, its items and its waits
    at the step's barrier; the emit, later tiles, the tail), its
    cycles from entry to exit, and scan steps, diagonal and OR items a
    block; the probe build's outputs bitwise the default's."""
    import torch
    from aicamera_tpu_torch.ops.nms import KERNEL, NmsKernel
    probe = NmsKernel(probe=True)
    mhz = sm_clock_mhz()
    rows = []
    for shape, args in shape_sets:
        want = KERNEL(*args)
        probe(*args)
        torch.cuda.synchronize()
        probe.read_probe(reset=True)
        got = probe(*args)
        torch.cuda.synchronize()
        sums = probe.read_probe(reset=True)
        check(all(bit_diffs(a, w) == 0 for a, w in zip(got, want)),
              f"[nms] probe {shape}: the probe build's outputs differ")
        blocks = max(sums["blocks"], 1)
        row = {"shape": shape, "blocks": sums["blocks"],
               "total_cycles": sums["total"] / blocks,
               "steps": sums["steps"] / blocks,
               "diag_items": sums["diag_items"] / blocks,
               "or_items": sums["or_items"] / blocks,
               "sm_mhz": mhz[0]}
        row.update({f"{ph}_cycles": sums[ph] / blocks for ph in NMS_PHASES})
        rows.append(row)
        print(f"[nms] probe {shape}: a block {row['total_cycles']:.0f} "
              f"cycles entry to exit ({row['total_cycles'] / mhz[0]:.3f} us "
              f"at {mhz[0]:.0f} MHz, max {mhz[1]:.0f}); by phase "
              + ", ".join(f"{ph} {row[ph + '_cycles']:.0f}"
                          for ph in NMS_PHASES)
              + f"; {row['steps']:.1f} scan steps, {row['diag_items']:.1f} "
              f"diagonal and {row['or_items']:.1f} OR items a block")
    return rows


def nms_phase(device):
    """The NMS kernel (``csrc/nms.cu``): the one-launch tail through its
    wrapper on card tensors, all five outputs bitwise against the plain
    tail's eager and fixed-K forms on the same tensors (and the CPU's) and
    its kept set against the first design's (``keep_v1``), on the main
    path's own candidates and :func:`nms_tail_cases` (``card_only``); one
    call under CUDA's sync debug mode "error"; then, at the detect paths'
    six shapes, three designs timed in turns by graph replay: the tail as
    the first design's path ran it (:func:`v1_tail`), the v1 keep alone
    and the one-launch tail; against the bound (the larger of
    :func:`nms_work`'s bytes and operations, the work bound, and an empty
    kernel's replay), with the time per call, the plain eager tail's (it
    reads once an iteration) and the plain fixed-K tail's (graph replay).
    No single PyTorch call computes a greedy NMS."""
    import numpy as np
    import torch
    from aicamera_tpu_torch import config
    from aicamera_tpu_torch.ops.nms import (KERNEL, MAX_K, _suppress_and_emit,
                                            suppress_and_emit_plain)

    main = nms_main_path_inputs(device)
    cases = [("main path chunk B=8 K=300", *main)]
    for name, boxes, score, cls, valid, thr, crit, max_det, offset in \
            nms_tail_cases(card_only=True):
        cases.append((name, boxes.to(device), score.to(device),
                      cls.to(device), valid.to(device), thr, max_det,
                      offset, crit))
    frames = candidates = kept_total = max_diff = 0
    for name, *args in cases:
        k = args[3].shape[-1]
        got, forms, diff = nms_hold(name, args, fixed=k <= 4096,
                                    cpu=k <= 4096)
        max_diff = max(max_diff, diff)
        frames += args[3].shape[0]
        candidates += args[3].numel()
        kept_total += int(got[4].sum())
        print(f"[nms] {name} ({args[7]}, threshold {args[4]}, max_det "
              f"{args[5]}, offset {args[6]}): {int(args[3].sum())} valid, "
              f"{int(got[4].sum())} kept, {int(got[0].sum())} emitted; "
              f"bitwise the plain tail's {', '.join(forms)} forms")
    # the public tail on the main path's candidates, card vs CPU
    boxes, score, cls, valid, thr, max_det, offset, crit = main
    k = valid.shape[-1]
    on_card = _suppress_and_emit(boxes, score, cls, valid, thr, k, max_det,
                                 offset, crit)
    on_cpu = _suppress_and_emit(boxes.cpu(), score.cpu(), cls.cpu(),
                                valid.cpu(), thr, k, max_det, offset, crit)
    check(all(bit_diffs(a.cpu(), c) == 0 for a, c in zip(on_card, on_cpu)),
          "[nms] _suppress_and_emit on the card != on the CPU")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        KERNEL(*main)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    try:
        KERNEL(*(t.cpu() if hasattr(t, "cpu") else t for t in main))
        check(False, "[nms] the kernel took CPU tensors")
    except ValueError:
        pass
    print(f"[nms] checked {len(cases)} cases, {frames} frames, {candidates} "
          f"candidates ({kept_total} kept): all five outputs bitwise the "
          f"plain tail, kept sets bitwise the first design's; K up to "
          f"{MAX_K}; no read under sync debug mode \"error\"; "
          f"_suppress_and_emit on the main path's candidates card == CPU")

    launch_floor = time_device_ms(lambda i: torch.cuda._sleep(0), 1,
                                  rounds=64)
    shapes = [("B=8 K=300 (the main path's own chunk)", 8, NMS_TOPK, "iou"),
              ("B=8 K=300 (seeded crowded chunks)", 8, NMS_TOPK, "iou"),
              ("B=32 K=300 ([streams] dispatch)", 32, NMS_TOPK, "iou"),
              ("B=1 K=300 (facade detect)", 1, NMS_TOPK, "iou"),
              ("B=1 K=500 (tiled merge, iou)", 1, NMS_TILED_K, "iou"),
              ("B=1 K=500 (tiled merge, ios)", 1, NMS_TILED_K, "ios")]
    rows, first_sets = [], []
    for shape, b, k, crit in shapes:
        if "own" in shape:
            sets = [main]   # as the path leaves them: in the L2
        else:
            tiled = k == NMS_TILED_K
            sets = []
            for i in range(NMS_TIMED_SETS):
                boxes, cls, valid = nms_scene(
                    b, k, seed=100 + i,
                    frame_hw=(540, 960) if tiled else (640, 640))
                sets.append((boxes.to(device),
                             nms_scores(b, k, 100 + i).to(device),
                             cls.to(device), valid.to(device), NMS_THR,
                             config.YOLO_MAX_DETECTIONS,
                             1920.0 if tiled else 8192.0,
                             crit))
        for i, args in enumerate(sets):
            max_diff = max(max_diff, nms_hold(f"{shape} set {i}", args,
                                              cpu=False)[2])
        first_sets.append((shape, sets[0]))
        shifted = [a[0] + (a[2].float() * a[6])[..., None] for a in sets]
        outs = [None] * len(sets)

        def launch_of(design):
            def launch(i):
                a = sets[i]
                if design == "emit":
                    outs[i] = KERNEL(*a)
                elif design == "v1":
                    outs[i] = KERNEL.keep_v1(shifted[i], a[3], a[4], a[7])
                else:
                    outs[i] = v1_tail(*a)
            return launch

        turns = design_turns(launch_of, len(sets), ("v1 tail", "v1", "emit"),
                             rounds=64 // len(sets))
        a0 = sets[0]
        ms = sorted(time_ms(lambda: KERNEL(*a0)) for _ in range(3))[1]
        plain = (a0[0], a0[1], a0[2], a0[3], a0[4], a0[3].shape[-1], a0[5],
                 a0[6], a0[7])
        with yardstick_reads():
            plain_ms = time_ms(lambda: suppress_and_emit_plain(*plain),
                               iters=5, warmup=1)
            fixed_ms = time_device_ms(
                lambda i: suppress_and_emit_plain(*plain, True), 1,
                rounds=1, replays=3)
        n_bytes, ops = nms_work(a0[3], a0[5])
        t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_F32_FLOPS * 1e3
        work = max(t_bytes, t_ops)
        bound = max(work, launch_floor)
        dev_ms = float(np.median(turns["emit"]["ms"]))
        v1_ms = float(np.median(turns["v1"]["ms"]))
        v1_tail_ms = float(np.median(turns["v1 tail"]["ms"]))
        r = {"shape": shape, "device_ms": dev_ms, "earlier_ms": v1_ms,
             "v1_tail_ms": v1_tail_ms, "turns": turns, "ms": ms,
             "plain_ms": plain_ms, "plain_fixed_ms": fixed_ms,
             "library_ms": None, "bound_ms": bound, "work_bound_ms": work,
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "bound_term": "launch floor" if bound == launch_floor
             else "work", "bytes": n_bytes, "ops": ops,
             "launch_floor_ms": launch_floor}
        rows.append(r)
        print(f"[nms] {shape} in turns (graph replay, L2-resident, ms a "
              f"call; v1 tail: shift, v1 keep, emit as eager launches; v1: "
              f"the keep alone, two launches; emit: the one launch): "
              f"{turns_line(turns)}; the one launch "
              f"{100 * bound / dev_ms:.1f}% of the bound, "
              f"{dev_ms / launch_floor:.2f}x an empty kernel's replay "
              f"({launch_floor:.6f} ms), v1 keep "
              f"{100 * bound / v1_ms:.1f}%, v1 tail "
              f"{100 * bound / v1_tail_ms:.1f}%; per call {ms:.4f} ms; "
              f"plain eager {plain_ms:.4f} ms (reads), plain fixed-K "
              f"{fixed_ms:.4f} ms (graph replay); bound {bound:.6f} ms (the "
              f"larger of the work bound {work:.7f} ms: {n_bytes} bytes, "
              f"{t_bytes:.7f} ms, {ops} operations, {t_ops:.7f} ms; and an "
              f"empty kernel's replay: {r['bound_term']}); library: no "
              f"single PyTorch call")
    probes = nms_probe(first_sets)
    KERNEL.launches = 0  # comparison and timing launches do not count
    top = rows[0]
    return {"name": KERNEL.name, "route": "cuda",
            "source": "aicamera_tpu_torch/csrc/nms.cu",
            "replaces": KERNEL.replaces, "launches": None,
            "max_abs_err": float(max_diff), "ms": top["ms"],
            "device_ms": top["device_ms"], "earlier_ms": top["earlier_ms"],
            "v1_tail_ms": top["v1_tail_ms"], "plain_ms": top["plain_ms"],
            "plain_fixed_ms": top["plain_fixed_ms"],
            "bound_ms": top["bound_ms"], "work_bound_ms": top["work_bound_ms"],
            "bound_by": top["bound_by"], "bound_term": top["bound_term"],
            "library_ms": None, "library": "no single PyTorch call",
            "launch_floor_ms": launch_floor, "cases_checked": len(cases),
            "frames_checked": frames, "candidates_checked": candidates,
            "shapes": rows, "probe": probes}


BRANCH_SITES = 16     # [branch]: sites a timed graph holds, one after another


def branch_phase(device):
    """The branch kernel (``csrc/branches.cu``): a branch site of a captured
    step, its set kernel ahead of its SWITCH node, at the main path's two kinds
    of site, a 7-way switch (the ReID bucket) and a 2-way cond (each of the
    scan's two), each captured by ``CUDAGraphEngine`` with bodies that
    write their index: at every index and one either side the body taken
    against the plain version (``branches.branch_plain``: the host reads the
    index). Then device ms a site by graph replay (``BRANCH_SITES`` sites in
    one graph, one body taken each, and none taken), per call with the
    engine's host side, the plain read's ms, and the bound: the larger of
    the work (4 bytes read, a comparison a body) and an empty kernel's
    replay."""
    import torch
    from aicamera_tpu_torch.runtime import branches
    from aicamera_tpu_torch.runtime.engine import CUDAGraphEngine
    from aicamera_tpu_torch.syncs import SyncCounter

    kernel = branches.KERNEL
    counter = SyncCounter()
    max_err = cases = 0

    def make(n, sites=1):
        idx = torch.zeros((), dtype=torch.int32, device=device)

        def fn(index):
            out = torch.full((sites,), -1, dtype=torch.int32, device=device)
            for s in range(sites):
                branches.switch(index, [
                    (lambda j=j, s=s: out[s].fill_(j)) for j in range(n)],
                    counter=counter, site=f"{n}-way {s}")
            return out
        return CUDAGraphEngine(fn, [idx], name=f"{n}-way x{sites}",
                               warmup_iters=1, device=device), idx

    for n in (7, 2):
        eng, idx = make(n)
        for j in range(-1, n + 1):
            idx.fill_(j)
            got = int(eng(idx)[0])
            want = branches.branch_plain(idx, n)
            max_err = max(max_err, abs(got - want))
            cases += 1
    check(max_err == 0 and counter.count == 0, f"[branch] the taken bodies "
          f"differ from the plain decisions ({max_err}) or the card was read "
          f"({counter.count})")

    def replay_ms(graph, reps=50):
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    launch_floor = time_device_ms(lambda i: torch.cuda._sleep(0), 1,
                                  rounds=64)
    rows = []
    for n in (7, 2):
        eng, idx = make(n, BRANCH_SITES)
        graph = next(iter(eng._graphs.values())).graph
        idx.fill_(n - 1)
        taken = sorted(replay_ms(graph) for _ in range(3))[1] / BRANCH_SITES
        idx.fill_(n)
        skipped = sorted(replay_ms(graph) for _ in range(3))[1] \
            / BRANCH_SITES
        one, idx1 = make(n)
        idx1.fill_(n - 1)
        ms = sorted(time_ms(lambda: one(idx1)) for _ in range(3))[1]
        plain_ms = time_ms(lambda: branches.branch_plain(idx1, n))
        t_bytes = 4 / PEAK_BYTES_PER_S * 1e3
        t_ops = n / PEAK_F32_FLOPS * 1e3
        bound = max(t_bytes, t_ops, launch_floor)
        rows.append({"shape": f"{n}-way site", "device_ms": taken,
                     "skipped_ms": skipped, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound,
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations",
                     "graph_nodes": eng.graph_nodes()})
        print(f"[branch] {n}-way site: device {taken:.5f} ms a site (graph "
              f"replay of {BRANCH_SITES} sites, the last body taken; none "
              f"taken {skipped:.5f}), per call {ms:.4f} ms (one site through "
              f"the engine), plain (the host's read) {plain_ms:.4f} ms, "
              f"bound {bound:.6f} ms (an empty kernel's replay), "
              f"{eng.graph_nodes()} graph nodes for {BRANCH_SITES} sites")
    print(f"[branch] the body taken equals the plain decision at {cases} "
          f"indices (7-way and 2-way, one out of range either side), no "
          f"read")
    kernel.launches = 0  # comparison and timing launches do not count
    main = rows[0]
    return {"name": kernel.name, "route": "cuda",
            "source": "aicamera_tpu_torch/csrc/branches.cu",
            "replaces": kernel.replaces, "launches": None,
            "max_abs_err": max_err, "ms": main["ms"],
            "device_ms": main["device_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "launch_floor_ms": launch_floor,
            "cases_checked": cases, "shapes": rows}


def make_pipeline(device, synthetic_load=24, **kw):
    from aicamera_tpu_torch import config
    from aicamera_tpu_torch.runtime.pipeline import TrackingPipeline
    return TrackingPipeline(
        yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
        reid_weights=str(config.REID_SYNTHETIC_PATH),
        chunk_size=CHUNK, synthetic_load=synthetic_load, device=device, **kw)


def sync_counters():
    """The counters of the reads that data-dependent branches take."""
    from aicamera_tpu_torch.core.assignment import TRACKER_SYNCS
    from aicamera_tpu_torch.ops.nms import NMS_SYNCS
    from aicamera_tpu_torch.runtime.pipeline import BUCKET_SYNCS, EMBED_SYNCS
    return {"NMS": NMS_SYNCS, "ReID bucket": EMBED_SYNCS,
            "tracker": TRACKER_SYNCS, "scan bucket": BUCKET_SYNCS}


def counted_run(pipe, frames, kernels, timed=False):
    """One run of a path with every launch and sync count set to 0 just
    before and read just after. Returns ``(results, wall seconds, launches by
    kernel, syncs by counter, ms per chunk by stage or None)``; ``timed``
    attaches a ``CudaStageTimer`` and warms the pipeline up with it first
    (the captured step's stamped capture, outside the counts; the eager
    step's CUDA events)."""
    import torch
    from aicamera_tpu_torch.runtime.pipeline import CudaStageTimer
    counters = sync_counters()
    pipe.stage_timer = CudaStageTimer() if timed else None
    if timed:
        pipe.warm_up(frames[0].shape[:2])
    for k in kernels:
        k.launches = 0
    for c in counters.values():
        c.count = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = list(pipe.process_frames(iter(frames)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pipe.settle()   # the launches of the branch bodies the chunks took
    launches = {k.name: k.launches for k in kernels}
    syncs = {name: c.count for name, c in counters.items()}
    stage_ms = None
    if timed:
        stage_ms = {s: v / pipe.stage_timer.chunks
                    for s, v in pipe.stage_timer.totals.items()}
        pipe.stage_timer = None
        drop_stamped(pipe)
    check(len(results) == len(frames),
          f"{len(results)} results for {len(frames)} frames")
    check(syncs["NMS"] == 0, f"{syncs['NMS']} NMS reads in a run on the card")
    return results, wall, launches, syncs, stage_ms


def check_launches(launches, n_chunks, what, solves=True, oru=0,
                   branches=None):
    """The letterbox and the NMS kernel once per chunk (dispatch, call;
    ``detect_tiled`` twice); the assignment kernel
    at least once where the path must solve (``solves``: a tracker core;
    detection alone solves nothing): its count follows the frames and the
    cores, and is printed; the ORU kernel ``oru`` times (one a frame an
    OC-SORT core steps, none on the other paths); the branch kernel
    ``branches`` times where given (a site a chunk each: the ReID bucket,
    the scan's two conds). No path reads the card in its NMS
    (``CARD_NMS_READS``)."""
    check(CARD_NMS_READS[0] == 0, f"{what}: {CARD_NMS_READS[0]} NMS reads "
          f"on the card")
    for name, n in launches.items():
        if name in ("letterbox", "nms"):
            check(n == n_chunks, f"{what}: {name} launched {n} times over "
                  f"{n_chunks} chunks")
        elif name == "oru":
            check(n == oru, f"{what}: {name} launched {n} times, {oru} "
                  f"expected")
        elif name == "branch":
            check(branches is None or n == branches, f"{what}: {name} "
                  f"launched {n} times, {branches} expected")
        elif solves:
            check(n >= 1, f"{what}: {name} never launched")


def summarize(results):
    """(track outputs, distinct ids) of a run; fails on a non-finite value."""
    import numpy as np
    for r in results:
        check(np.isfinite(r.det_boxes).all() and np.isfinite(
            r.det_scores).all(), f"non-finite detections at {r.frame_index}")
        check(all(np.isfinite(t[:4]).all() and np.isfinite(t[6])
                  for t in r.tracks),
              f"non-finite track at {r.frame_index}")
    return (sum(len(r.tracks) for r in results),
            len({t[4] for r in results for t in r.tracks}))


def syncs_line(syncs, n):
    return ", ".join(f"{name} {v / n:.3f}" for name, v in syncs.items())


def drop_stamped(pipe):
    """Free a pipeline's stamped captures once its timed run is read: each
    is a graph of its own beside the untimed one, and the phases that keep
    several pipelines of 8 streams at 720p alive would run the card out of
    memory holding both."""
    import torch
    steps = getattr(pipe, "_engine", pipe)._steps
    for key in [k for k in steps if k[-1] == "stamped"]:
        del steps[key]
    gc.collect()
    torch.cuda.empty_cache()


def step_ms(stage_ms) -> float:
    """A chunk's whole step from its stages' ms (the captured step's: its
    entry stamp to its ``tracker`` stamp)."""
    return sum(stage_ms.values())


def stages_line(stage_ms) -> str:
    return ", ".join(f"{s} {v:.3f}" for s, v in stage_ms.items() if v)


def main_path_phase(device, frames, kernels):
    """The full-width main path on the card, with launch counts."""
    from aicamera_tpu_torch.runtime.pipeline import CudaStageTimer

    pipe = make_pipeline(device)
    warm_s = pipe.warm_up(FRAME_HW)
    print(f"[main] warm-up {warm_s:.2f} s")
    results, wall, launches, syncs, _ = counted_run(pipe, frames, kernels)
    n = len(frames)
    check([r.frame_index for r in results] == list(range(n)),
          "results out of order")
    check_launches(launches, N_CHUNKS, "main path",
                   branches=N_CHUNKS * len(step_sites(pipe)))
    n_tracks, n_ids = summarize(results)
    n_init = pipe.tracker_params.n_init
    for r in results[n_init - 1:]:
        check(len(r.tracks) > 0, f"no confirmed track at frame "
              f"{r.frame_index} (n_init={n_init})")
    n_dets = sum(len(r.det_boxes) for r in results)
    print(f"[main] {n} frames in {wall:.3f} s: {n / wall:.2f} FPS "
          f"(chunk {CHUNK}, {N_CHUNKS} chunks, after warm-up, scan_bucket "
          f"{pipe.scan_bucket}: chunks {pipe.scan_stats})")
    print(f"[main] detections {n_dets}, track outputs {n_tracks}, distinct "
          f"confirmed ids {n_ids}; launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items())
          + " (the letterbox one per chunk)")
    print(f"[main] host syncs per frame: {syncs_line(syncs, n)} (plus one "
          f"packed result read per chunk); tracker reads a frame "
          f"{syncs['tracker'] / n:.3f}; assignment launches a frame "
          f"{launches['assignment'] / n:.3f} (a cascade and an IoU solve)")
    check(sum(syncs.values()) == 0, f"main path: the captured step read the "
          f"GPU: {syncs}")
    print(f"[main] reads a frame in all: {sum(syncs.values()) / n:.3f}; "
          f"step replays {pipe.step_replays()} (one a chunk, the warm-up's "
          f"among them); ReID buckets {pipe.reid_buckets}; "
          + step_line(pipe))
    # a cascade and an IoU solve a frame, a pass of a chunk's frames each
    # chunk and each rerun of a bucketed one (counted from the decisions)
    want = 2 * CHUNK * passes(pipe, N_CHUNKS)
    check(launches["assignment"] == want, f"main path: "
          f"{launches['assignment']} assignment launches, {want} expected")
    print("[main] sample tracks, last frame: "
          + repr(results[-1].tracks[:4]))

    # the same frames again with CUDA events: the captured step whole, the
    # eager step (the host reading its branches) at every stage boundary,
    # its scans replayed from their captures, then frame by frame
    def timed_run():
        pipe.reset()
        timer = CudaStageTimer()
        pipe.stage_timer = timer
        out = list(pipe.process_frames(iter(frames)))
        pipe.stage_timer = None
        return out, {s: v / timer.chunks for s, v in timer.totals.items()}

    again, captured_ms = timed_run()
    drop_stamped(pipe)
    with eager_step(pipe):
        timed_run()
        eager, stage_ms = timed_run()
    with eager_scans(pipe):
        pipe.warm_up(FRAME_HW)
        eager_frames, eager_ms = timed_run()
    print("[main] per-chunk stage ms of the eager step (CUDA events, "
          "includes the host launch gaps): " + stages_line(stage_ms)
          + f"; tracker per frame {stage_ms['tracker'] / CHUNK:.3f} ms")
    print(f"[main] per-chunk stage ms of the captured step (its stamps): "
          f"{stages_line(captured_ms)}; entry to tracker "
          f"{step_ms(captured_ms):.3f} ms; the eager step's stages sum to "
          f"{step_ms(stage_ms):.3f} ms; tracker ms a chunk: "
          f"captured step {captured_ms['tracker']:.3f}, eager step's "
          f"captured scan {stage_ms['tracker']:.3f}, eager scan "
          f"{eager_ms['tracker']:.3f}")
    same = sum(a.tracks == b.tracks for a, b in zip(results, again))
    print(f"[main] timed rerun: {same}/{n} frames with identical tracks")
    check([r.tracks for r in eager] == [r.tracks for r in again],
          "[main] the captured step's tracks differ from the eager step's")
    check([r.tracks for r in eager_frames] == [r.tracks for r in again],
          "[main] the captured step's tracks differ from the eager scan's")
    print(f"[main] eager step and eager scan: track tuples identical to the "
          f"captured step's on {n} frames")
    eager_turns("main", pipe, frames, kernels)
    pipe.warm_up(FRAME_HW)
    profile_chunk(pipe, frames[-CHUNK:])
    return launches


@contextlib.contextmanager
def eager_step(pipe, scans=True):
    """Inside, ``pipe`` (a ``TrackingPipeline`` or a
    ``MultiStreamPipeline``) runs the eager chunk step, the host reading its
    branches, not the captured one (to hold and time the two against each
    other in one call); ``scans=False``: its tracker scans frame by frame
    too, not from their captures."""
    eng = getattr(pipe, "_engine", pipe)
    eng._capture_step = False
    if eng is not pipe:
        pipe._captured = False
    if not scans:
        eng._capture_scans = False
        eng._stages.clear()  # the stages hold their engines
    try:
        yield
    finally:
        del eng._capture_step
        if eng is not pipe:
            pipe._captured = True
        if not scans:
            del eng._capture_scans
            eng._stages.clear()


def eager_scans(pipe):
    """:func:`eager_step` with the scans frame by frame."""
    return eager_step(pipe, scans=False)


def step_line(pipe):
    """The captured chunk steps of a pipeline: name, graph nodes (the
    branch bodies' included), capture and warm-up seconds, and the nodes of
    each branch body."""
    eng = getattr(pipe, "_engine", pipe)
    return "; ".join(
        f"{st.engine.name}: {st.engine.graph_nodes()} graph nodes, capture "
        f"{st.engine.compile_seconds:.3f} s (warm-up "
        f"{st.engine.warmup_seconds:.3f} s), bodies' nodes "
        f"{st.engine.branch_sites()}" for st in eng._steps.values())


def step_sites(pipe):
    """The branch sites of a pipeline's captured step (one set kernel a
    site a replay)."""
    eng = getattr(pipe, "_engine", pipe)
    return next(iter(eng._steps.values())).engine.branch_sites()


def passes(pipe, chunks):
    """Tracker passes the captured steps ran: one a chunk, two where the
    small pass reran (from the chunks' own decisions)."""
    return chunks + pipe.scan_stats["rerun"]


def eager_turns(tag, pipe, frames, kernels, run=None, label=""):
    """The captured step and the eager step on the same frames, in turns
    (eager, captured, captured, eager), each from a fresh state: track
    tuples and detections bitwise equal, the same ways and ReID buckets
    chunk for chunk; FPS of each turn. ``run(pipe)`` -> ``(outputs,
    seconds, ways, buckets)``, default a ``process_frames`` pass (then
    ``frames`` the frames; else the frames a run makes). ``label``: what
    the line is about, after the phase's ``tag``."""
    import numpy as np
    import torch

    def default(p):
        p.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = list(p.process_frames(iter(frames)))
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, dict(p.scan_stats), \
            dict(p.reid_buckets)

    run = run or default
    with eager_step(pipe):
        run(pipe)   # the eager step's own stages and scans, warmed
    got, order = {}, []
    for way in ("eager", "captured", "captured", "eager"):
        with eager_step(pipe) if way == "eager" else contextlib.nullcontext():
            order.append((way, run(pipe)))
        got.setdefault(way, []).append(order[-1][1])
    (cap, _, ways, buckets), (eag, _, e_ways, e_buckets) = \
        got["captured"][0], got["eager"][0]
    check((ways, buckets) == (e_ways, e_buckets), f"{tag}: captured step "
          f"ways {ways} buckets {buckets}, eager {e_ways} {e_buckets}")
    n = 0
    for a, b in zip(cap, eag, strict=True):
        if hasattr(a, "tracks"):
            check(a.tracks == b.tracks, f"{tag}: frame {a.frame_index}: "
                  f"captured {a.tracks} vs eager {b.tracks}")
            check(np.array_equal(a.det_boxes, b.det_boxes)
                  and np.array_equal(a.det_scores, b.det_scores),
                  f"{tag}: frame {a.frame_index}: detections differ")
            n += len(a.tracks)
        else:
            check(all(torch.equal(x, y) for x, y in zip(a, b)),
                  f"{tag}: captured and eager outputs differ")
            n += int(a[-1].sum())
    n_frames = len(frames) if run is default else frames
    print(f"[{tag}] {label}in turns: " + ", ".join(
        f"{way} {n_frames / r[1]:.2f}" for way, r in order)
        + f" frames/s; captured = eager bitwise ({n} track outputs, "
          f"detections), ways {ways}, ReID buckets {buckets}")
    return got


def bucket_phase(device, frames, kernels):
    """``scan_bucket=32`` against ``scan_bucket=0`` in one call, one run
    each, at the main path's load (24 synthetic boxes a frame, more live
    tracks than the small pass admits), at a light load (8, where the
    small pass runs every chunk) and at a load that forces the rerun (40:
    the first chunk overflows the small table): identical track tuples,
    no read on any counter, the FPS and the captured step's ms of both;
    then the bucketed run against the eager step, in turns."""
    launches = {}
    for load in (24, 8, 40):
        pipes = {b: make_pipeline(device, synthetic_load=load, scan_bucket=b)
                 for b in (32, 0)}
        for p in pipes.values():
            p.warm_up(FRAME_HW)
        runs = {32: [], 0: []}
        for b in (32, 0):
            pipes[b].reset()
            res, wall, launches, syncs, stage_ms = counted_run(
                pipes[b], frames, kernels, timed=True)
            check_launches(launches, N_CHUNKS, f"bucket phase ({b})")
            check(sum(syncs.values()) == 0, f"bucket phase ({b}, load "
                  f"{load}): reads {syncs}")
            check(launches["assignment"]
                  == 2 * CHUNK * passes(pipes[b], N_CHUNKS),
                  f"bucket phase ({b}, load {load}): "
                  f"{launches['assignment']} assignment launches")
            runs[b].append((res, len(frames) / wall, step_ms(stage_ms), syncs,
                            dict(pipes[b].scan_stats)))
        ref = runs[0][0][0]
        for b in (32, 0):
            for res, *_ in runs[b]:
                check([r.tracks for r in res] == [r.tracks for r in ref],
                      f"scan_bucket={b} at load {load}: track tuples differ "
                      f"from the unbucketed run")
        check(summarize(ref)[0] > 0, f"no track at load {load}")
        stats = runs[32][0][4]
        check(sum(stats.values()) == N_CHUNKS, f"scan counts {stats}")
        check(not any(runs[0][0][4].values()), "scan_bucket=0 counted a pass")
        if load == 8:
            check(stats["small"] == N_CHUNKS,
                  f"light load: the small pass did not run every chunk: "
                  f"{stats}")
        if load == 40:
            check(stats["rerun"] >= 1, f"load 40: no rerun: {stats}")
        for b in (32, 0):
            print(f"[bucket] load {load}, scan_bucket {b}: FPS "
                  + " / ".join(f"{r[1]:.2f}" for r in runs[b])
                  + ", captured step ms a chunk "
                  + " / ".join(f"{r[2]:.3f}" for r in runs[b])
                  + f", syncs per frame: "
                  f"{syncs_line(runs[b][0][3], len(frames))}")
        print(f"[bucket] load {load}: chunks by way {stats}; ReID buckets "
              f"{pipes[32].reid_buckets}; track tuples identical over "
              f"{len(frames)} frames in both runs ({summarize(ref)[0]} track "
              f"outputs); {step_line(pipes[32])}")
        eager_turns("bucket", pipes[32], frames, kernels,
                    label=f"load {load}, scan_bucket 32: ")
    return launches


def tracker_configs():
    """The new tracker paths: ``{name: pipeline keywords}``. The cores'
    thresholds are lowered to 0.4: the synthetic grid's boxes carry conf 0.5,
    which is in neither of ByteTrack's score splits at its default 0.5 and
    below OC-SORT's default ``det_thresh`` of 0.6."""
    from aicamera_tpu_torch.core.bytetrack import ByteTrackParams
    from aicamera_tpu_torch.core.ocsort import OCSortParams
    return {
        "bytetrack": dict(bytetrack_params=ByteTrackParams(track_thresh=0.4)),
        "botsort": dict(bytetrack_params=ByteTrackParams(
            track_thresh=0.4, with_appearance=True)),
        "ocsort": dict(ocsort_params=OCSortParams(det_thresh=0.4)),
        "deepocsort": dict(ocsort_params=OCSortParams(
            det_thresh=0.4, with_appearance=True)),
        "strongsort": dict(),   # the preset's default gmc="affine"
    }


def trackers_phase(device, frames, kernels):
    """Each new tracker at full width on the card, then against the CPU:
    no read on any counter for any core, each chunk one replay of its
    captured step (a tracker pass a chunk, two where a bucketed pass
    reruns), OC-SORT's ORU kernel once a frame a pass; the captured step
    against the eager one, in turns."""
    import torch
    check(not torch.backends.cuda.matmul.allow_tf32,
          "f32 matmuls run in TF32: the cores' cosine products need f32")
    sub = frames[:TRACKER_CHUNKS * CHUNK]
    by_tracker = {}
    for name, kw in tracker_configs().items():
        pipe = make_pipeline(device, tracker=name, **kw)
        pipe.warm_up(FRAME_HW)
        replays = pipe.step_replays()
        res, wall, launches, syncs, _ = counted_run(pipe, sub, kernels)
        replays = pipe.step_replays() - replays
        stats = dict(pipe.scan_stats)
        check(sum(syncs.values()) == 0, f"tracker {name}: the step read the "
              f"GPU: {syncs}")
        check(replays == TRACKER_CHUNKS, f"tracker {name}: {replays} step "
              f"replays in {TRACKER_CHUNKS} chunks")
        n_pass = passes(pipe, TRACKER_CHUNKS)
        check_launches(launches, TRACKER_CHUNKS, f"tracker {name}",
                       oru=CHUNK * n_pass if "ocsort" in name else 0,
                       branches=TRACKER_CHUNKS * len(step_sites(pipe)))
        by_tracker[name] = launches
        n_tracks, n_ids = summarize(res)
        check(n_tracks > 0, f"tracker {name} emitted no track")
        pipe.reset()
        captured_ms = counted_run(pipe, sub, kernels, timed=True)[4]
        with eager_step(pipe):
            pipe.reset()
            counted_run(pipe, sub, kernels, timed=True)
            pipe.reset()
            stage_ms = counted_run(pipe, sub, kernels, timed=True)[4]
        gmc = (f", gmc {pipe.gmc_method} {stage_ms['gmc']:.3f} ms per chunk"
               if pipe.gmc_method else "")
        print(f"[trackers] {name}: {len(sub)} frames, {len(sub) / wall:.2f} "
              f"FPS, the captured step {step_ms(captured_ms):.3f} ms a "
              f"chunk ({stages_line(captured_ms)}); "
              f"the eager step's tracker {stage_ms['tracker'] / CHUNK:.3f} "
              f"ms per frame (captured scan){gmc}; syncs per "
              f"frame: {syncs_line(syncs, len(sub))}; {replays} step "
              f"replays and {n_pass} tracker passes in {TRACKER_CHUNKS} "
              f"chunks; track outputs {n_tracks}, distinct ids {n_ids}, "
              f"chunks {stats}, launches {launches} (the letterbox one per "
              f"chunk); {step_line(pipe)}")
        eager_turns("trackers", pipe, sub, kernels, label=f"{name}: ")
        compare_runs(
            f"trackers] {name}",
            list(make_pipeline("cuda", tracker=name, detect_dtype="f32",
                               reid_dtype="f32", **kw).process_frames(
                iter(sub[:COMPARE_CHUNKS * CHUNK]))),
            list(make_pipeline("cpu", tracker=name, **kw).process_frames(
                iter(sub[:COMPARE_CHUNKS * CHUNK]))), "CPU")
    return by_tracker


def gmc_phase(device, kernels):
    """Camera-motion compensation on a panning scene: the estimate on the
    card against the CPU and the true shift, with no read back; then the
    pipeline with and without it for the three cores."""
    import numpy as np
    import torch
    from aicamera_tpu_torch.ops import gmc
    from aicamera_tpu_torch.scenes import panning_rectangles

    n_obj = 6
    frames, shifts = panning_rectangles(GMC_CHUNKS * CHUNK, FRAME_HW,
                                        n_objects=n_obj, seed=SEED)
    spec = gmc.gmc_spec(FRAME_HW)
    centre = torch.tensor([FRAME_HW[1] / 2.0, FRAME_HW[0] / 2.0])
    f_gpu = torch.from_numpy(frames).to(device)
    gmc.estimate_chunk(f_gpu[0], f_gpu[:CHUNK], spec)  # FFT plans
    torch.cuda.synchronize()
    err_a = err_t = err_true = err_centre = 0.0
    for c in range(GMC_CHUNKS):
        lo = c * CHUNK
        prev = lo - 1 if c else 0
        torch.cuda.set_sync_debug_mode("error")  # a read back raises
        try:
            a, t = gmc.estimate_chunk(f_gpu[prev], f_gpu[lo:lo + CHUNK],
                                      spec)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        a_cpu, t_cpu = gmc.estimate_chunk(
            torch.from_numpy(frames[prev]),
            torch.from_numpy(frames[lo:lo + CHUNK]), spec)
        a, t = a.cpu(), t.cpu()
        err_a = max(err_a, float((a - a_cpu).abs().max()))
        err_t = max(err_t, float((t - t_cpu).abs().max()))
        true = torch.from_numpy(shifts[lo:lo + CHUNK])
        err_true = max(err_true, float((t - true).abs().max()))
        err_centre = max(err_centre, float(
            (a @ centre + t - centre - true).abs().max()))
    check(err_a <= 1e-4 and err_t <= 1e-2, f"gmc on the card vs the CPU: "
          f"A {err_a}, t {err_t} px")
    check(err_true <= 0.5 and err_centre <= 0.5,
          f"gmc vs the true shift: t {err_true} px, centre {err_centre} px")
    est_ms = time_ms(lambda: gmc.estimate_chunk(f_gpu[0], f_gpu[:CHUNK],
                                                spec), iters=20)
    print(f"[gmc] estimate_chunk on {GMC_CHUNKS} chunks of {CHUNK} panning "
          f"{FRAME_HW[1]}x{FRAME_HW[0]} frames (pool {spec.pool}, "
          f"{spec.n_blocks} blocks of {spec.block} px): card vs CPU max "
          f"|dA| {err_a:.3g} (tolerance 1e-4), |dt| {err_t:.3g} px "
          f"(1e-2); vs the true shift max |dt| {err_true:.3f} px, frame "
          f"centre {err_centre:.3f} px (0.5); reads back 0 per chunk (sync "
          f"debug mode 'error'); {est_ms:.3f} ms per chunk")

    launches = {}
    for name in ("deepsort", "bytetrack", "ocsort"):
        line = []
        for mode in ("affine", "off"):
            pipe = make_pipeline(device, synthetic_load=0, tracker=name,
                                 gmc=mode)
            pipe.warm_up(FRAME_HW)
            res, wall, counts, syncs, captured_ms = counted_run(
                pipe, frames, kernels, timed=True)
            check(sum(syncs.values()) == 0, f"gmc {name} {mode}: reads "
                  f"{syncs}")
            check_launches(counts, GMC_CHUNKS, f"gmc {name} {mode}",
                           oru=CHUNK * passes(pipe, GMC_CHUNKS)
                           if name == "ocsort" else 0)
            n_tracks, n_ids = summarize(res)
            check(n_tracks > 0, f"gmc {name} {mode}: no track")
            with eager_step(pipe):
                pipe.warm_up(FRAME_HW)
                stage_ms = counted_run(pipe, frames, kernels, timed=True)[4]
            line.append(f"{mode}: {len(frames) / wall:.2f} FPS, the "
                        f"captured step {step_ms(captured_ms):.3f} ms a "
                        f"chunk (gmc {captured_ms['gmc']:.3f} ms) "
                        f"(the eager step's gmc stage "
                        f"{stage_ms['gmc']:.3f} ms), "
                        f"{n_ids / n_obj:.2f} ids per object, {n_tracks} "
                        f"track outputs, reads 0")
            if mode == "affine":
                launches[name] = counts
                eager_turns("gmc", pipe, frames, kernels,
                            label=f"{name} affine: ")
        print(f"[gmc] {name} on the panning scene ({len(frames)} frames, "
              f"{n_obj} objects, real detections only): " + "; ".join(line))
    return launches


def quiet(make):
    """``make()`` with its constructor prints swallowed."""
    with contextlib.redirect_stdout(io.StringIO()):
        return make()


def facade_configs():
    """``{name: (facade class, keywords)}``: the six tracker facades at
    their defaults with the committed ReID weights."""
    import aicamera_tpu_torch as port
    from aicamera_tpu_torch import config
    reid = dict(reid_model_path=str(config.REID_SYNTHETIC_PATH))
    return {"DeepSORT": (port.DeepSORT, reid),
            "StrongSORT": (port.StrongSORT, reid),
            "ByteTrack": (port.ByteTrack, {}),
            "BoTSORT": (port.BoTSORT, reid),
            "OCSort": (port.OCSort, {}),
            "DeepOCSort": (port.DeepOCSort, reid)}


def facades_phase(device, frames, kernels):
    """The reference API's per-frame loop, ``YOLODetector.detect`` ->
    ``<facade>.update``, for the six tracker facades at full width; one
    ``detect_tiled`` frame; then card f32 against the CPU."""
    import numpy as np
    import torch
    from aicamera_tpu_torch import config
    from aicamera_tpu_torch.detector import YOLODetector

    yolo = str(config.YOLO_SYNTHETIC_PATH)
    counters = sync_counters()
    det = quiet(lambda: YOLODetector(yolo, device=device))
    det.warm_up(FRAME_HW, iters=2)
    sub = frames[:FACADE_FRAMES]
    launches = {}
    for name, (cls, kw) in facade_configs().items():
        tracker = quiet(lambda: cls(device=device, **kw))
        tracker.update(*det.detect(sub[0])[:3], sub[0])  # warm-up
        tracker.reset()
        for k in kernels:
            k.launches = 0
        for c in counters.values():
            c.count = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [tracker.update(*det.detect(f)[:3], f) for f in sub]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[name] = {k.name: k.launches for k in kernels}
        check_launches(launches[name], len(sub), f"facade {name} (detect "
                       f"calls)", oru=len(sub) if "OCSort" in name else 0)
        n_tracks = sum(map(len, outs))
        check(n_tracks > 0, f"facade {name} emitted no track")
        check(all(np.isfinite(t[:4]).all() and np.isfinite(t[6])
                  for o in outs for t in o), f"facade {name}: non-finite")
        syncs = {n: c.count for n, c in counters.items()}
        check(syncs["tracker"] == 0, f"facade {name}: the step read the GPU "
              f"{syncs['tracker']} times")
        print(f"[facades] {name}: {len(sub)} frames, {len(sub) / wall:.2f} "
              f"FPS (detect + update), syncs per frame: "
              f"{syncs_line(syncs, len(sub))} (plus the reads of the "
              f"detections and the tuples); track outputs {n_tracks}, "
              f"distinct ids {len({t[4] for o in outs for t in o})}; "
              f"launches {launches[name]} (the letterbox one per detect "
              f"call, replayed from its captured engine)")
    det.detect_tiled(sub[0])  # builds and captures its engine
    for k in kernels:
        k.launches = 0
    tiled = det.detect_tiled(sub[0])
    launches["detect_tiled"] = {k.name: k.launches for k in kernels}
    check_launches(launches["detect_tiled"], 2, "detect_tiled (one frame)",
                   solves=False)
    print(f"[facades] detect_tiled 2x2 + full frame: {len(tiled[0])} "
          f"detections (detect: {len(det.detect(sub[0])[0])}); launches 2 "
          f"(one replay of its captured engine)")

    # card f32 (TF32 off) against the CPU: the same frames through both
    # detectors, each facade fed by its own device's detections
    f32 = dict(detect_dtype="f32")
    gpu_det = quiet(lambda: YOLODetector(yolo, device=device, **f32))
    cpu_det = quiet(lambda: YOLODetector(yolo, device="cpu"))
    cmp = sub[:FACADE_COMPARE]
    dets_gpu = [gpu_det.detect(f)[:3] for f in cmp]
    dets_cpu = [cpu_det.detect(f)[:3] for f in cmp]
    for g, c in zip(dets_gpu, dets_cpu):
        check(len(g[0]) == len(c[0]) and np.array_equal(g[2], c[2]),
              "facade detections: card f32 vs CPU counts or labels differ")
        check(np.abs(g[0] - c[0]).max(initial=0) <= 1e-2,
              "facade detection boxes differ by more than 1e-2 px")
    total = 0
    for name, (cls, kw) in facade_configs().items():
        kw = dict(kw, reid_dtype="f32") if kw else kw
        tr_g = quiet(lambda: cls(device=device, **kw))
        tr_c = quiet(lambda: cls(device="cpu", **kw))
        for f, dg, dc in zip(cmp, dets_gpu, dets_cpu):
            og, oc = tr_g.update(*dg, f), tr_c.update(*dc, f)
            check([t[:6] for t in og] == [t[:6] for t in oc],
                  f"facade {name}: card f32 {og} vs CPU {oc}")
            check(all(abs(a[6] - b[6]) <= 1e-4 for a, b in zip(og, oc)),
                  f"facade {name}: conf differs")
            total += len(og)
    check(total > 0, "facades: no track to compare")
    print(f"[facades] {len(cmp)} frames through all six facades, card f32 "
          f"(TF32 off) vs CPU: detection counts and labels identical, "
          f"{total} track tuples identical in ids, classes and boxes, conf "
          f"within 1e-4")
    return launches


# what [cli]'s saved run drew, for [present]: input and output paths, the
# per-frame draw calls, the CLI texts
PRESENT: dict = {}
PRESENT_SIZES = ((540, 960), (1080, 1920))   # [present]: timed frame sizes
PRESENT_FRAMES = 16                          # of them, frames a size
READER_THREADS = (1, 4)                      # NativeVideoReader workers


def cli_fps(text):
    """(FPS incl. decode+draw, FPS detect+track) from the CLI's summary."""
    line = next(ln for ln in text.splitlines() if ln.startswith("Processed"))
    wall = float(line.split("wall (")[1].split(" FPS")[0])
    compute = float(line.split("; ")[1].split(" FPS")[0])
    return wall, compute


def cli_phase(frames, kernels, workdir):
    """The CLI end to end on the card: a headless run with a checkpoint, a
    resumed run, StrongSORT; then on an MJPEG ``.avi`` of the same frames
    (written by the port's VideoWriter): the default saved run with
    ``--draw_detections --profile`` (its draw calls recorded for
    [present]), the same with ``--no_save``, and ``--native_io``."""
    import numpy as np
    from aicamera_tpu_torch import cli, config
    from aicamera_tpu_torch.runtime.checkpoint import load_state
    from aicamera_tpu_torch.core.state import TrackerParams
    from aicamera_tpu_torch.utils import visualization
    from aicamera_tpu_torch.utils.video_io import VideoWriter

    def run(argv, echo=True):
        reset_counts(kernels)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(argv)
        if echo:
            for ln in out.getvalue().splitlines():
                print(f"[cli]   {ln}")
        syncs = {n: c.count for n, c in sync_counters().items()}
        check(sum(syncs.values()) == 0, f"cli {argv[-1]}: reads {syncs}")
        return out.getvalue(), {k.name: k.launches for k in kernels}

    weights = ["--yolo_weights", str(config.YOLO_SYNTHETIC_PATH),
               "--reid_weights", str(config.REID_SYNTHETIC_PATH)]
    n = len(frames)
    workdir = Path(workdir)
    clip, ckpt = workdir / "frames.npy", workdir / "state.msgpack"
    np.save(clip, frames)
    text, launches = run(["--input", str(clip), "--no_save", "--profile",
                          "--checkpoint", str(ckpt),
                          "--checkpoint_interval", "24", *weights])
    check(f"Processed {n} frames" in text, "the CLI's frame count")
    avg = float(text.split("Average tracks per frame: ")[1].split()[0])
    check(avg > 0, "the CLI run emitted no track")
    check("detect+track" in text and "checkpoint" in text,
          "--profile printed no stage table")
    check(ckpt.exists(), "no checkpoint file")
    # one launch per chunk, the warm-up's chunks and the eager pass before
    # the step's capture included
    warm = WARM_UP_ITERS + CAPTURE_PASSES
    check_launches(launches, n // CHUNK + warm, "cli")
    state = load_state(ckpt, TrackerParams())
    check(bool(state.active.any()) and int(state.next_id) > 1,
          "the checkpoint holds no track")
    text, resumed = run(["--input", str(clip), "--no_save", "--resume",
                         str(ckpt), "--max_frames", "16", *weights])
    check(f"Resumed tracker state from {ckpt}" in text
          and "Processed 16 frames" in text, "the resumed run")
    check_launches(resumed, 16 // CHUNK + warm, "cli --resume")
    text, strong = run(["--input", str(clip), "--no_save", "--tracker",
                        "strongsort", "--max_frames", "16", *weights])
    check("Processed 16 frames" in text, "the strongsort run")
    check_launches(strong, 16 // CHUNK + warm, "cli --tracker strongsort")
    print(f"[cli] {n} frames through aicamera_tpu_torch.cli on the card: "
          f"{avg} tracks per frame, checkpoint with next_id "
          f"{int(state.next_id)} written and resumed for 16 frames; "
          f"--tracker strongsort (default --gmc affine) for 16 frames; "
          f"launches {launches}, {resumed} and {strong} (one per chunk, "
          f"{WARM_UP_ITERS} warm-up chunks and {CAPTURE_PASSES} pass before "
          f"the capture each); host reads a frame 0.000 on every counter")

    # the captured step against the eager one through the CLI, in turns:
    # the same tracks a frame and the same final state, bitwise
    from aicamera_tpu_torch.runtime.pipeline import TrackingPipeline
    turns = []
    for way in ("eager", "captured", "captured", "eager"):
        path = workdir / f"state_{way}_{len(turns)}.msgpack"
        TrackingPipeline._capture_step = way == "captured"
        try:
            reset_counts(kernels)
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                cli.main(["--input", str(clip), "--no_save", "--checkpoint",
                          str(path), *weights])
        finally:
            TrackingPipeline._capture_step = True
        turns.append((way, out.getvalue(), path.read_bytes()))
    same = all(t[2] == turns[0][2] for t in turns)
    check(same, "cli: the eager and captured steps' final states differ")
    tracks = {t[1].split("Average tracks per frame: ")[1].split()[0]
              for t in turns}
    check(len(tracks) == 1, f"cli: tracks per frame differ: {tracks}")
    print("[cli] in turns: " + ", ".join(
        "{} {:.2f} / {:.2f}".format(w, *cli_fps(t)) for w, t, _ in turns)
        + f" FPS (the CLI's own: wall / detect+track); final states bitwise "
          f"equal, tracks per frame {tracks.pop()} in all four")

    # the MJPEG input, then the default (saving) run with its draw calls
    avi_in = workdir / "clip.avi"
    w = VideoWriter(str(avi_in), 30.0, FRAME_HW)
    for f in frames:
        w.write(f)
    w.release()
    check(w.frames_written == n, "VideoWriter dropped frames")
    calls = {"dets": [], "tracks": [], "panel": []}
    orig = (visualization.draw_detections, visualization.draw_tracks,
            visualization.draw_info_panel)

    def spy_dets(frame, boxes, scores, labels, *a, **k):
        calls["dets"].append((np.array(boxes), np.array(scores),
                              np.array(labels)))
        return orig[0](frame, boxes, scores, labels, *a, **k)

    def spy_tracks(frame, tracks, *a, **k):
        calls["tracks"].append(list(tracks))
        return orig[1](frame, tracks, *a, **k)

    def spy_panel(frame, lines, *a, **k):
        calls["panel"].append(list(lines))
        return orig[2](frame, lines, *a, **k)

    (visualization.draw_detections, visualization.draw_tracks,
     visualization.draw_info_panel) = spy_dets, spy_tracks, spy_panel
    try:
        saved_text, saved = run(["--input", str(avi_in), "--draw_detections",
                                 "--profile", "--output_dir", str(workdir),
                                 "--output_filename", "run.mp4", *weights])
    finally:
        (visualization.draw_detections, visualization.draw_tracks,
         visualization.draw_info_panel) = orig
    avi_out = workdir / "run.avi"
    check(f"Saved {n} frames to {avi_out}" in saved_text,
          "the saved run's frame count")
    check("Presentation errors: 0 frames skipped" in saved_text,
          "the saved run skipped frames")
    check("draw+write" in saved_text, "--profile printed no draw+write")
    check_launches(saved, n // CHUNK + warm, "cli (saving)")
    nosave_text, nosave = run(["--input", str(avi_in), "--no_save",
                               *weights])
    check_launches(nosave, n // CHUNK + warm, "cli (.avi, no save)")
    native_text, native = run(["--input", str(avi_in), "--no_save",
                               "--native_io", *weights])
    check("Using native C++ video decoder" in native_text
          and f"Processed {n} frames" in native_text, "the --native_io run")
    check_launches(native, n // CHUNK + warm, "cli --native_io")
    PRESENT.update(input=avi_in, output=avi_out, calls=calls, n=n,
                   saved=cli_fps(saved_text), nosave=cli_fps(nosave_text),
                   native=cli_fps(native_text), launches=saved)
    print(f"[cli] MJPEG .avi input (the port's VideoWriter): the default "
          f"saved run with --draw_detections --profile wrote {n} frames, "
          f"no presentation error, launches {saved}; --no_save launches "
          f"{nosave}; --native_io launches {native} (one per chunk, "
          f"{WARM_UP_ITERS} warm-up chunks and {CAPTURE_PASSES} pass before "
          f"the capture each)")
    return launches


def present_phase():
    """[cli]'s saved video read back and held against the port's own
    drawing of each frame's recorded calls, re-encoded; then the costs of
    presentation on this host: decode, encode and draw ms a frame, the
    CLI's FPS with saving against --no_save, NativeVideoReader frames/s."""
    import numpy as np
    from aicamera_tpu_torch.scenes import moving_rectangles
    from aicamera_tpu_torch.utils import visualization as vis
    from aicamera_tpu_torch.utils.jpeg import decode_jpeg, encode_jpeg
    from aicamera_tpu_torch.utils.video_io import (NativeVideoReader,
                                                   VideoReader)
    n, calls = PRESENT["n"], PRESENT["calls"]
    r = VideoReader(str(PRESENT["input"]))
    inputs = list(r.frames())
    r.release()
    r = VideoReader(str(PRESENT["output"]))
    written = list(r.frames())
    r.release()
    check(len(written) == n == len(calls["tracks"]) == len(calls["panel"]),
          f"[present] {len(written)} frames written, {n} processed")
    for i, frame in enumerate(inputs):
        want = frame.copy()
        vis.draw_detections(want, *calls["dets"][i])
        vis.draw_tracks(want, calls["tracks"][i])
        vis.draw_info_panel(want, calls["panel"][i])
        check(np.array_equal(written[i], decode_jpeg(encode_jpeg(want))),
              f"[present] frame {i} != the port's drawing, re-encoded")
    n_tracks = sum(map(len, calls["tracks"]))
    check(n_tracks > 0, "[present] no track drawn")
    print(f"[present] {n} frames of the saved video read back: each bitwise "
          f"the port's drawing of its {n_tracks} tracks and the detections "
          f"and the info panel as the CLI drew them, JPEG-encoded (q95 "
          f"4:2:0); the saving run's launches, counted in [cli]: "
          f"{PRESENT['launches']} (one a chunk)")

    # costs a frame on this host (one thread each; the writer encodes on
    # up to 4, the native reader decodes on its workers)
    for hw in PRESENT_SIZES:
        scene = moving_rectangles(PRESENT_FRAMES, hw, n_objects=10, seed=1)
        rng = np.random.RandomState(0)
        tracks = [[(int(x), int(y), int(x) + 120, int(y) + 200, j + 1,
                    "person", 0.9) for j, (x, y) in enumerate(
                        rng.randint(0, min(hw) - 200, (10, 2)))]
                  for _ in range(PRESENT_FRAMES)]
        t0 = time.perf_counter()
        enc = [encode_jpeg(f) for f in scene]
        t1 = time.perf_counter()
        for b in enc:
            decode_jpeg(b)
        t2 = time.perf_counter()
        for f, tr in zip(scene, tracks):
            vis.draw_tracks(f, tr)
            vis.draw_info_panel(f, ["AICamera", "Input: clip", "FPS: 88.8",
                                    f"Tracks: {len(tr)}"])
        t3 = time.perf_counter()
        k = len(scene)
        print(f"[present] {hw[1]}x{hw[0]} q95 4:2:0, {k} frames: encode "
              f"{(t1 - t0) / k * 1e3:.3f} ms, decode {(t2 - t1) / k * 1e3:.3f}"
              f" ms, draw (10 tracks + info panel) "
              f"{(t3 - t2) / k * 1e3:.3f} ms a frame, "
              f"{sum(map(len, enc)) / k / 1e3:.1f} kB a frame")
    saved, nosave, native = PRESENT["saved"], PRESENT["nosave"], \
        PRESENT["native"]
    print(f"[present] CLI on the {n}-frame .avi, same call: saving "
          f"(--draw_detections) {saved[0]:.2f} FPS incl. decode+draw "
          f"({saved[1]:.2f} detect+track); --no_save {nosave[0]:.2f} "
          f"({nosave[1]:.2f}); --no_save --native_io {native[0]:.2f} "
          f"({native[1]:.2f})")
    rates = []
    for t in READER_THREADS:
        t0 = time.perf_counter()
        r = NativeVideoReader(str(PRESENT["input"]), n_threads=t)
        got = sum(len(c) for c in r.chunks(CHUNK))
        r.release()
        dt = time.perf_counter() - t0
        check(got == n, f"NativeVideoReader read {got} of {n}")
        rates.append(f"{got / dt:.1f} frames/s at n_threads {t}")
    print(f"[present] NativeVideoReader over the {n}-frame {FRAME_HW[1]}x"
          f"{FRAME_HW[0]} .avi: "
          + ", ".join(rates))


def stream_scenes(n_frames, n_streams=None):
    """``(n_streams, n_frames, 720, 1280, 3)``: each stream a different seed
    of ``scenes.moving_rectangles`` (made in threads: numpy releases the
    GIL in its array arithmetic)."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    from aicamera_tpu_torch.scenes import moving_rectangles
    n_streams = n_streams or STREAMS
    with ThreadPoolExecutor(n_streams) as ex:
        return np.stack(list(ex.map(
            lambda s: moving_rectangles(n_frames, STREAM_HW, n_objects=6,
                                        seed=SEED + 1 + s),
            range(n_streams))))


def make_streams(device, n_streams=None, **kw):
    from aicamera_tpu_torch import config
    from aicamera_tpu_torch.parallel import MultiStreamPipeline
    return MultiStreamPipeline(
        n_streams=n_streams or STREAMS, frame_hw=STREAM_HW,
        yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
        reid_weights=str(config.REID_SYNTHETIC_PATH), device=device, **kw)


def stream_tuples(outs, si):
    """Stream ``si``'s track tuples, frame by frame, over a list of
    ``step_chunk`` outputs (each ``(S, K, ...)``)."""
    from aicamera_tpu_torch.runtime.pipeline import _format_tracks
    host = [tuple(x[si].cpu().numpy() for x in o) for o in outs]
    return [_format_tracks(*(x[t] for x in h))
            for h in host for t in range(h[0].shape[0])]


def same_tracks(tag, got, want, conf_tol=1e-4):
    """Two runs' track tuples, frame by frame: ids, classes and boxes
    identical, conf within ``conf_tol``. Returns (tuples, bitwise equal)."""
    import numpy as np
    check(len(got) == len(want), f"{tag}: {len(got)} vs {len(want)} frames")
    total = exact = 0
    for i, (g, w) in enumerate(zip(got, want)):
        check([t[:6] for t in g] == [t[:6] for t in w],
              f"{tag}: frame {i}: {g} vs {w}")
        check(all(np.isfinite(t[:4]).all() and abs(a[6] - t[6]) <= conf_tol
                  for a, t in zip(g, w)), f"{tag}: frame {i}: conf")
        total += len(g)
        exact += sum(a == b for a, b in zip(g, w))
    return total, exact


def reset_counts(kernels):
    import torch
    for k in kernels:
        k.launches = 0
    for c in sync_counters().values():
        c.count = 0
    torch.cuda.synchronize()


def streams_phase(device, kernels, oru_record=None):
    """``MultiStreamPipeline`` at BASELINE config 4's width: 8 streams of
    720p, chunk 4, DeepSORT defaults; then its checks (``oru_record``: the
    ORU kernel's JSON record, which takes the row of its timing on the
    OC-SORT stack's own inputs)."""
    import dataclasses
    import numpy as np
    import torch
    from aicamera_tpu_torch import config
    from aicamera_tpu_torch.runtime.pipeline import (CudaStageTimer,
                                                     TrackingPipeline)

    s, k, d = STREAMS, STREAM_CHUNK, STREAM_DISPATCHES
    t0 = time.perf_counter()
    scenes = stream_scenes(d * k)
    chunks = [scenes[:, i * k:(i + 1) * k] for i in range(d)]
    print(f"[streams] {s} scenes of {d * k} frames at {STREAM_HW[1]}x"
          f"{STREAM_HW[0]} made in {time.perf_counter() - t0:.2f} s")
    pipe = make_streams(device)
    t0 = time.perf_counter()
    blank = np.zeros((s, k, *STREAM_HW, 3), np.uint8)
    for _ in range(WARM_UP_ITERS):
        pipe.step_chunk(blank)
    for i in range(s):
        pipe.reset_stream(i)
    torch.cuda.synchronize()
    print(f"[streams] warm-up {time.perf_counter() - t0:.2f} s")

    check(pipe.stacked, "streams: the DeepSORT streams are not one stack")

    def run(timer=None):
        for i in range(s):
            pipe.reset_stream(i)
        pipe.scan_stats.update(dict.fromkeys(pipe.scan_stats, 0))
        pipe._engine.reid_buckets.clear()
        pipe.stage_timer = timer
        reset_counts(kernels)
        replays = pipe.step_replays()
        t0 = time.perf_counter()
        outs = [tuple(x.cpu() for x in pipe.step_chunk(c)) for c in chunks]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pipe.stage_timer = None
        pipe.settle()
        return (outs, wall, {kn.name: kn.launches for kn in kernels},
                {n: c.count for n, c in sync_counters().items()},
                pipe.step_replays() - replays)

    run()
    outs, wall, launches, syncs, replays = run()
    check_launches(launches, d, "streams (one launch per dispatch)",
                   branches=d * len(step_sites(pipe)))
    check(sum(syncs.values()) == 0, f"streams: the captured step read the "
          f"GPU: {syncs}")
    # the stack: one replay a dispatch, a tracker pass (two where the small
    # pass reruns), a cascade and an IoU solve a frame for all streams
    reruns = pipe.scan_stats["rerun"]
    n_pass = passes(pipe, d)
    check(replays == d, f"streams: {replays} step replays in {d} "
          f"dispatches")
    check(launches["assignment"] == 2 * k * n_pass, f"streams: "
          f"{launches['assignment']} assignment launches in {n_pass} "
          f"passes of {k} frames")
    print(f"[streams] a dispatch: {replays / d:.2f} step replays, "
          f"{n_pass / d:.2f} tracker passes ({reruns} reruns), "
          f"{launches['assignment'] / d:.2f} assignment launches (2 K = "
          f"{2 * k} a pass, every stream's problems in each), reads "
          f"{sum(syncs.values()) / d:.2f} (bucket "
          f"{syncs['scan bucket'] / d:.2f}, ReID {syncs['ReID bucket'] / d:.2f}"
          f", tracker {syncs['tracker'] / d:.2f}); chunks "
          f"{dict(pipe.scan_stats)}, ReID buckets "
          f"{pipe._engine.reid_buckets}; {step_line(pipe)}")
    tuples = [stream_tuples(outs, si) for si in range(s)]
    n_tracks = [sum(map(len, t)) for t in tuples]
    check(all(n > 0 for n in n_tracks), f"a stream emitted no track: "
          f"{n_tracks}")
    check(all(np.isfinite(t[:4]).all() and np.isfinite(t[6])
              for ts in tuples for f in ts for t in f), "non-finite track")
    timer = CudaStageTimer()
    again = run(timer)[0]
    drop_stamped(pipe)
    stage_ms = {st: v / timer.chunks for st, v in timer.totals.items()}
    same = all(stream_tuples(again, si) == tuples[si] for si in range(s))
    n_sf = s * k * d
    print(f"[streams] {s} streams x {d} dispatches of {k} frames: "
          f"{n_sf / wall:.2f} stream-frames/s, {wall / d * 1e3:.2f} ms per "
          f"dispatch (after warm-up, bf16, scan_bucket {pipe.scan_bucket}: "
          f"chunks {pipe.scan_stats}); launches {launches} ({d} dispatches)")
    print(f"[streams] per-dispatch stage ms (CUDA events): "
          + ", ".join(f"{st} {v:.3f}" for st, v in stage_ms.items())
          + f"; the captured step {step_ms(stage_ms):.3f} ms a dispatch "
          f"(its stamps, entry to tracker); "
          f"timed rerun identical: {same}")

    def stream_run(p):
        outs, wall = run()[:2]
        return (outs, wall, dict(p.scan_stats), dict(p._engine.reid_buckets))

    eager_turns("streams", pipe, s * k * d, kernels, run=stream_run,
                label="DeepSORT stack (stream-frames/s): ")
    print(f"[streams] host syncs per stream-frame: {syncs_line(syncs, n_sf)};"
          f" track outputs per stream {n_tracks}")
    stream_stack_vs_loop(pipe, chunks, device)
    motion = motion_stacks(device, kernels, chunks, oru_record)

    # two streams masked for a whole dispatch keep their states bit for bit
    before = pipe.states
    valid = np.ones((s, k), bool)
    valid[:2] = False
    pipe.step_chunk(chunks[0], frame_valid=valid)
    after = pipe.states
    for f in dataclasses.fields(before):
        a, b = getattr(before, f.name), getattr(after, f.name)
        if a is not None:
            check(torch.equal(a[:2], b[:2]), f"masked streams: {f.name} "
                  f"changed")
    check(not torch.equal(before.age[2:], after.age[2:]),
          "the unmasked streams did not advance")

    # each stream against a single-stream pipeline on the card: bf16 (the
    # detector batch is S*K frames here, K there: reported), then f32 (TF32
    # off), which must agree
    def single(**kw):
        return TrackingPipeline(
            yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
            reid_weights=str(config.REID_SYNTHETIC_PATH), chunk_size=k,
            device=device, **kw)

    n_cmp = 2 * k
    ref = single()
    bf16_exact = bf16_total = 0
    for si in range(s):
        ref.reset()
        want = [r.tracks for r in ref.process_frames(iter(scenes[si,
                                                                 :n_cmp]))]
        got = tuples[si][:n_cmp]
        bf16_total += sum(map(len, want))
        bf16_exact += sum(g == w for gf, wf in zip(got, want)
                          for g, w in zip(gf, wf))
    f32 = dict(detect_dtype="f32", reid_dtype="f32")
    pipe32 = make_streams(device, **f32)
    outs32 = [pipe32.step_chunk(c) for c in chunks[:2]]
    ref = single(**f32)
    total = exact = 0
    for si in range(s):
        ref.reset()
        want = [r.tracks for r in ref.process_frames(iter(scenes[si,
                                                                 :n_cmp]))]
        t, e = same_tracks(f"streams f32 stream {si} vs TrackingPipeline",
                           stream_tuples(outs32, si), want)
        total, exact = total + t, exact + e
    check(total > 0, "streams f32: no track to compare")
    print(f"[streams] each stream vs TrackingPipeline on that stream alone "
          f"({n_cmp} frames each): f32 (TF32 off): ids, classes and boxes "
          f"identical on {total} tuples, {exact} bitwise with conf (conf "
          f"tolerance 1e-4); bf16: {bf16_exact} of {bf16_total} tuples "
          f"bitwise identical (batch-shape dependent, not checked)")

    # card f32 against the CPU: 2 streams x 1 chunk, three cores
    lines = []
    for name in ("deepsort", "bytetrack", "ocsort", "strongsort"):
        kw = dict(tracker=name, **tracker_configs().get(name, {}))
        card = make_streams(device, n_streams=2, **f32, **kw)
        cpu = make_streams("cpu", n_streams=2, **kw)
        o_card = [card.step_chunk(scenes[:2, :k])]
        o_cpu = [cpu.step_chunk(scenes[:2, :k])]
        total = 0
        for si in range(2):
            total += same_tracks(f"streams {name} card f32 vs CPU",
                                 stream_tuples(o_card, si),
                                 stream_tuples(o_cpu, si))[0]
        check(total > 0, f"streams {name}: no track to compare")
        gmc = f" (gmc {card.gmc_method})" if card.gmc_method else ""
        lines.append(f"{name}{gmc} {total} tuples")
    print(f"[streams] card f32 (TF32 off) vs CPU, 2 streams x {k} frames: "
          f"ids, classes and boxes identical, conf within 1e-4: "
          + ", ".join(lines))

    # StrongSORT (camera-motion compensation on) at full width: gmc ms
    strong = make_streams(device, tracker="strongsort")

    def strong_run():
        timer = CudaStageTimer()
        strong.stage_timer = timer
        strong.step_chunk(chunks[0])  # FFT plans, cuDNN, the capture
        strong.settle()
        timer.clear()
        t0 = time.perf_counter()
        for c in chunks[1:]:
            strong.step_chunk(c)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        strong.stage_timer = None
        strong.settle()
        drop_stamped(strong)
        return wall, {st: v / timer.chunks for st, v in timer.totals.items()}

    wall, captured_ms = strong_run()
    with eager_step(strong):
        g_ms = strong_run()[1]
    print(f"[streams] strongsort (gmc {strong.gmc_method}), {s} streams, "
          f"{d - 1} dispatches: {s * k * (d - 1) / wall:.2f} stream-frames/s;"
          f" the captured step {step_ms(captured_ms):.3f} ms a dispatch "
          f"(gmc {captured_ms['gmc']:.3f}); the "
          f"eager step's gmc {g_ms['gmc']:.3f} ms (all {s} streams in one "
          f"batched estimate), tracker {g_ms['tracker']:.3f} ms")
    return {"deepsort": launches, "bytetrack": motion["bytetrack"],
            "ocsort": motion["ocsort"]}


def stream_stack_vs_loop(pipe, chunks, device, tag="", bitwise=False):
    """The streams' tracker on the same detections two ways, in turns
    (loop, stack, stack, loop), each a pass over the dispatches from fresh
    states: the stack (one captured replay a dispatch, one bucket decision)
    and the streams one after another through the same stage (a replay and
    a bucket decision a stream), as the pipeline ran them before it stacked
    them. Tracker ms a dispatch (host clock around the tracker, synced),
    replays, assignment and ORU launches and bucket reads a dispatch; the
    two ways' tracks equal (ids, classes, boxes identical, conf within 1e-4;
    with ``bitwise`` every tuple bitwise)."""
    import numpy as np
    import torch
    from aicamera_tpu_torch.core.assignment import TRACKER_SYNCS
    from aicamera_tpu_torch.ops.assignment import KERNEL
    from aicamera_tpu_torch.ops.oru import KERNEL as ORU
    from aicamera_tpu_torch.runtime.pipeline import BUCKET_SYNCS

    s, k = chunks[0].shape[:2]
    detect, track = pipe._engine._get_stages(STREAM_HW)
    inputs = []
    with torch.no_grad():
        for c in chunks:
            ft = torch.from_numpy(np.ascontiguousarray(c)).to(device)
            inputs.append(detect(ft.reshape(s * k, *ft.shape[2:]))[0])
    valid = np.ones((s, k), bool)
    fresh = pipe._engine._init_tracker_state

    def counts():
        return (pipe.scan_replays(), KERNEL.launches, ORU.launches,
                BUCKET_SYNCS.count, TRACKER_SYNCS.count)

    def one_pass(way):
        before = counts()
        ms, outs = [], []
        stack = fresh(n_streams=s)
        singles = [fresh() for _ in range(s)]
        with torch.no_grad():
            for inp in inputs:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if way == "stack":
                    stack, o = track(stack, inp.by_frame(s, k), valid.T)
                    o = tuple(x.transpose(0, 1) for x in o)
                else:
                    per = []
                    for si in range(s):
                        singles[si], oi = track(
                            singles[si], inp.frames(si * k, (si + 1) * k),
                            valid[si])
                        per.append(oi)
                    o = tuple(torch.stack(x) for x in zip(*per))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                outs.append(tuple(x.cpu() for x in o))
        n = len(inputs)
        per_dispatch = [(now - was) / n for now, was in zip(counts(),
                                                            before)]
        return ms, outs, per_dispatch

    for way in ("loop", "stack"):
        one_pass(way)   # captures: the loop's per-stream scans are new
    got = {}
    for way in ("loop", "stack", "stack", "loop"):
        got.setdefault(way, []).append(one_pass(way))
    total = exact = 0
    for (_, o_stack, _), (_, o_loop, _) in zip(got["stack"], got["loop"]):
        for si in range(s):
            t, e = same_tracks(f"streams{tag} stack vs loop, stream {si}",
                               stream_tuples(o_stack, si),
                               stream_tuples(o_loop, si))
            total, exact = total + t, exact + e
    check(total > 0, f"streams{tag} stack vs loop: no track to compare")
    if bitwise:
        check(exact == total, f"streams{tag} stack vs loop: {total - exact} "
              f"of {total} tuples differ in conf")
    row = {}
    for way, runs in got.items():
        row[way] = {"tracker_ms_a_dispatch": [float(np.median(r[0]))
                                              for r in runs],
                    "replays": runs[0][2][0], "assignment_launches":
                    runs[0][2][1], "oru_launches": runs[0][2][2],
                    "bucket_reads": runs[0][2][3],
                    "tracker_reads": runs[0][2][4]}
        check(runs[0][2][4] == 0, f"streams{tag} {way}: tracker reads")
    check(row["stack"]["bucket_reads"] <= 2, f"streams{tag} stack: more "
          f"than 2 bucket reads a dispatch")
    print(f"[streams]{tag} tracker on the same detections, in turns (loop, "
          f"stack, stack, loop; median ms a dispatch, host clock, synced): "
          + "; ".join(f"{way} " + " / ".join(
              f"{t:.3f}" for t in r["tracker_ms_a_dispatch"])
              + f" ms, a dispatch {r['replays']:.2f} replays, "
                f"{r['assignment_launches']:.2f} assignment launches, "
                f"{r['oru_launches']:.2f} ORU launches, "
                f"{r['bucket_reads']:.2f} bucket reads"
              for way, r in row.items())
          + f"; tracks: ids, classes, boxes identical on {total} tuples, "
            f"{exact} bitwise with conf")
    return row


def motion_stacks(device, kernels, chunks, oru_record=None):
    """``[streams]``' ByteTrack and OC-SORT stacks (thresholds 0.4, as in
    ``[trackers]``): stream-frames/s, one scan replay a dispatch (two where
    a bucketed pass reruns), 3 K (ByteTrack) or 2 K (OC-SORT) assignment
    launches and K ORU launches (OC-SORT) a replay, at most 2 bucket reads
    and no tracker read a dispatch; then the stack against the streams one
    by one on the same detections, in turns, tracks bitwise equal; then the
    ORU kernel on the OC-SORT stack's own inputs (:func:`oru_main_path`,
    its row into ``oru_record``)."""
    import numpy as np
    import torch
    cfg = tracker_configs()
    s, k = chunks[0].shape[:2]
    d = len(chunks)
    out = {}
    for name, solves in (("bytetrack", 3), ("ocsort", 2)):
        pipe = make_streams(device, n_streams=s, tracker=name, **cfg[name])
        check(pipe.stacked, f"streams {name}: not one stack")
        blank = np.zeros((s, k, *STREAM_HW, 3), np.uint8)
        for _ in range(WARM_UP_ITERS):
            pipe.step_chunk(blank)
        for c in chunks:    # captures the capacities the chunks take
            pipe.step_chunk(c)
        for i in range(s):
            pipe.reset_stream(i)
        pipe.scan_stats.update(dict.fromkeys(pipe.scan_stats, 0))
        reset_counts(kernels)
        replays = pipe.step_replays()
        t0 = time.perf_counter()
        outs = [tuple(x.cpu() for x in pipe.step_chunk(c)) for c in chunks]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pipe.settle()
        replays = pipe.step_replays() - replays
        launches = {kn.name: kn.launches for kn in kernels}
        syncs = {n: c.count for n, c in sync_counters().items()}
        n_pass = passes(pipe, d)
        check(replays == d, f"streams {name}: {replays} step replays in {d} "
              f"dispatches")
        check_launches(launches, d, f"streams {name}",
                       oru=k * n_pass if name == "ocsort" else 0)
        check(launches["assignment"] == solves * k * n_pass, f"streams "
              f"{name}: {launches['assignment']} assignment launches in "
              f"{n_pass} passes of {k} frames")
        check(sum(syncs.values()) == 0, f"streams {name}: reads {syncs}")
        n_tracks = [sum(map(len, stream_tuples(outs, si)))
                    for si in range(s)]
        check(sum(n_tracks) > 0, f"streams {name}: no track")
        print(f"[streams] {name} stack, {s} streams x {d} dispatches of {k} "
              f"frames: {s * k * d / wall:.2f} stream-frames/s, "
              f"{wall / d * 1e3:.2f} ms per dispatch; a dispatch "
              f"{replays / d:.2f} step replays, {n_pass / d:.2f} passes, "
              f"{launches['assignment'] / d:.2f} assignment launches "
              f"({solves} K a replay), {launches['oru'] / d:.2f} ORU "
              f"launches, {syncs['scan bucket'] / d:.2f} bucket reads, "
              f"{syncs['tracker'] / d:.2f} tracker reads; chunks "
              f"{dict(pipe.scan_stats)}; track outputs per stream "
              f"{n_tracks}")
        out[name] = launches
        out[name + "_vs_loop"] = stream_stack_vs_loop(
            pipe, chunks, device, tag=f" {name}", bitwise=True)
        if name == "ocsort":
            oru_main_path(pipe, chunks, device, oru_record)
    return out


def tenant_frames(scenes, pace):
    """A tenant's frames: its scene, looped to TENANT_SECONDS at ``pace``
    frames/s (a burst: twice the scene)."""
    n = (2 * scenes.shape[0] if pace is None
         else int(round(TENANT_SECONDS * pace)))
    return [scenes[i % scenes.shape[0]] for i in range(n)]


def serving_phase(device, frames, kernels):
    """``TrackingService`` over the main scene, then
    ``MultiTenantTrackingService`` at its defaults with four tenants."""
    import threading
    import numpy as np
    from aicamera_tpu_torch import config
    from aicamera_tpu_torch.runtime.pipeline import TrackingPipeline
    from aicamera_tpu_torch.serving import (MultiTenantTrackingService,
                                            TrackingService)

    # --- TrackingService: 64 frames submitted at once ride full chunks
    pipe = make_pipeline(device)
    pipe.warm_up(FRAME_HW)
    svc = TrackingService(pipeline=pipe, chunk_size=CHUNK)
    reset_counts(kernels)
    t0 = time.perf_counter()
    futs = [svc.submit(f) for f in frames]
    got = [f.result(timeout=300) for f in futs]
    wall = time.perf_counter() - t0
    svc.shutdown()
    pipe.settle()
    single = {kn.name: kn.launches for kn in kernels}
    reads = {n: c.count for n, c in sync_counters().items()}
    check(sum(reads.values()) == 0, f"TrackingService: reads {reads}")
    check_launches(single, N_CHUNKS, "TrackingService")
    check([r.frame_index for r in got] == list(range(len(frames))),
          "TrackingService: frame indices")
    pipe.reset()
    want = [r.tracks for r in pipe.process_frames(iter(frames))]
    total, exact = same_tracks("TrackingService vs process_frames",
                               [r.tracks for r in got], want)
    check(total > 0, "TrackingService: no track")
    print(f"[serving] TrackingService: {len(frames)} frames in {wall:.3f} s "
          f"({len(frames) / wall:.2f} FPS, chunk {CHUNK}, the main path's "
          f"pipeline); launches {single}; host reads a frame "
          f"{syncs_line(reads, len(frames))}; vs process_frames: {total} "
          f"tuples, {exact} bitwise identical")

    def service_run(p):
        import torch
        p.reset()
        svc = TrackingService(pipeline=p, chunk_size=CHUNK)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        futs = [svc.submit(f) for f in frames]
        res = [f.result(timeout=300) for f in futs]
        wall = time.perf_counter() - t0
        svc.shutdown()
        return res, wall, dict(p.scan_stats), dict(p.reid_buckets)

    eager_turns("serving", pipe, len(frames), kernels, run=service_run,
                label="TrackingService: ")

    # --- the multi-tenant service at its defaults (4 slots, 720x1280, chunk
    # 4, 30 ms), f32 with TF32 off so that every tenant can be held against
    # a single-stream run (bf16 detections depend on the batch's shape)
    f32 = dict(detect_dtype="f32", reid_dtype="f32")
    weights = dict(yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
                   reid_weights=str(config.REID_SYNTHETIC_PATH))
    mt = MultiTenantTrackingService(device=device, **weights, **f32)
    scenes = stream_scenes(4 * mt.chunk_size, n_streams=mt.n_streams)
    try:
        # warm-up: one full dispatch of blank frames on every slot
        sids = [mt.open_stream() for _ in range(mt.n_streams)]
        blank = np.zeros((*mt.frame_hw, 3), np.uint8)
        warm = [mt.submit(sid, blank) for sid in sids
                for _ in range(mt.chunk_size)]
        for f in warm:
            f.result(timeout=300)
        for sid in sids:
            mt.close_stream(sid)
        mt.wait_idle(timeout=300)
        stats0 = dict(mt.stats)
        reset_counts(kernels)
        results = {}

        def tenant(key, pace):
            sid = mt.open_stream()
            futs = []
            t_start = time.perf_counter()
            for i, fr in enumerate(tenant_frames(scenes[key], pace)):
                if pace is not None:
                    time.sleep(max(0.0, t_start + i / pace
                                   - time.perf_counter()))
                futs.append(mt.submit(sid, fr))
            results[key] = (sid, [f.result(timeout=300) for f in futs])
            mt.close_stream(sid)

        threads = [threading.Thread(target=tenant, args=(i, pace))
                   for i, pace in enumerate(TENANT_PACES)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        mt.wait_idle(timeout=300)
        wall = time.perf_counter() - t0
        mt.pipeline.settle()
        multi = {kn.name: kn.launches for kn in kernels}
        tenant_reads = {n: c.count for n, c in sync_counters().items()}
        stats = {n: v - stats0[n] for n, v in mt.stats.items()}
        check(sum(tenant_reads.values()) == 0, f"tenants: reads "
              f"{tenant_reads}")
        check(len(results) == len(TENANT_PACES), "a tenant did not finish")
        check_launches(multi, stats["dispatches"],
                       "MultiTenantTrackingService (one per dispatch)")
        ref = TrackingPipeline(chunk_size=mt.chunk_size, device=device,
                               **weights, **f32)
        total = exact = 0
        waits, cycles = [], []
        for key, pace in enumerate(TENANT_PACES):
            sid, res = results[key]
            check([r.frame_index for r in res] == list(range(len(res))),
                  f"tenant {key}: frame indices")
            ref.reset()
            want = [r.tracks for r in ref.process_frames(
                iter(tenant_frames(scenes[key], pace)))]
            t, e = same_tracks(f"tenant {key} vs TrackingPipeline",
                               [r.tracks for r in res], want)
            total, exact = total + t, exact + e
            waits += [r.dispatch_ts - r.arrival_ts for r in res]
            cycles += [r.resolve_ts - r.dispatch_ts for r in res]
        check(total > 0, "tenants: no track")
        # a closed, re-leased slot starts over: ids from 1, the tuples of a
        # fresh single-stream run
        sid = mt.open_stream()
        again = [f.result(timeout=300).tracks for f in
                 [mt.submit(sid, fr) for fr in scenes[0][:mt.chunk_size]]]
        mt.close_stream(sid)
        mt.wait_idle(timeout=300)
        ref.reset()
        same_tracks("re-leased slot", again, [r.tracks for r in
                    ref.process_frames(iter(scenes[0][:mt.chunk_size]))])
        ids = [t[4] for f in again for t in f]
        check(ids and min(ids) == 1, f"re-leased slot: ids {ids}")
    finally:
        mt.shutdown()
    n = sum(len(r) for _, r in results.values())

    def pct(v, q):
        return 1e3 * float(np.percentile(np.asarray(v), q))

    print(f"[serving] MultiTenantTrackingService (4 slots, {mt.frame_hw[1]}x"
          f"{mt.frame_hw[0]}, chunk {mt.chunk_size}, 30 ms SLA, f32 with "
          f"TF32 off): tenants at " + ", ".join(
              "burst" if p is None else f"{p:g}/s" for p in TENANT_PACES)
          + f", {n} frames in {wall:.3f} s ({n / wall:.2f} frames/s); stats "
          f"{stats}; launches {multi}; reads a dispatch "
          f"{syncs_line(tenant_reads, stats['dispatches'])}")
    print(f"[serving] queue wait (dispatch - arrival) p50 {pct(waits, 50):.2f}"
          f" ms, p99 {pct(waits, 99):.2f} ms; cycle (resolve - dispatch) p50 "
          f"{pct(cycles, 50):.2f} ms, p99 {pct(cycles, 99):.2f} ms")
    print(f"[serving] every tenant vs TrackingPipeline over its frames: ids, "
          f"classes and boxes identical on {total} tuples, {exact} bitwise "
          f"(conf tolerance 1e-4); a re-leased slot restarts at id 1 "
          f"({len(ids)} track outputs over {mt.chunk_size} frames)")
    return single, multi


def server_phase(device, frames, kernels):
    """``TrackingHTTPServer`` on 127.0.0.1 over a TrackingService on the
    card: health, raw-frame POSTs against the service itself, stats, reset,
    an encoded image."""
    import json
    import urllib.error
    import urllib.request
    import torch
    from aicamera_tpu_torch.server import TrackingHTTPServer
    from aicamera_tpu_torch.serving import TrackingService

    pipe = make_pipeline(device, synthetic_load=0)
    pipe.warm_up(FRAME_HW, chunk_size=SERVER_CHUNK)
    svc = TrackingService(pipeline=pipe, chunk_size=SERVER_CHUNK,
                          max_latency_ms=5.0)
    srv = TrackingHTTPServer(host="127.0.0.1", port=0, service=svc).start()
    base = f"http://127.0.0.1:{srv.port}"
    raw = {"X-Frame-Height": str(FRAME_HW[0]),
           "X-Frame-Width": str(FRAME_HW[1])}

    def call(path, body=None, headers=None):
        req = urllib.request.Request(base + path, data=body,
                                     headers=headers or {},
                                     method="GET" if body is None
                                     else "POST")
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    sub = frames[:SERVER_FRAMES]
    try:
        status, health = call("/v1/healthz")
        check(status == 200 and health["backend"] == "cuda"
              and health["device"] == torch.cuda.get_device_name(0),
              f"healthz: {health}")
        reset_counts(kernels)
        t0 = time.perf_counter()
        posted = []
        for f in sub:
            status, body = call("/v1/track", f.tobytes(), raw)
            check(status == 200, f"POST /v1/track: {status} {body}")
            posted.append(body)
        wall = time.perf_counter() - t0
        launches = {kn.name: kn.launches for kn in kernels}
        check_launches(launches, len(sub), "server (one per request)")
        _, stats = call("/v1/stats")
        check(stats["frames"] == len(sub), f"stats: {stats}")
        status, body = call("/v1/reset", b"")
        check(status == 200 and body == {"status": "reset"}, f"reset: {body}")
        # the same frames through the service itself, one at a time as the
        # requests came: after the reset, the same tracks and ids
        direct = [svc.submit(f).result(timeout=60) for f in sub]
        want = [[[int(v) for v in t[:5]] + [t[5], round(float(t[6]), 4)]
                 for t in r.tracks] for r in direct]
        check([b["tracks"] for b in posted] == want,
              "server tracks != the service's")
        n_tracks = sum(map(len, want))
        check(n_tracks > 0, "server: no track")
        encoded = image_bodies(sub[:SERVER_IMAGES])
        reset_counts(kernels)
        for kind, bodies, decoded in encoded:
            tracks = {}
            for way in ("raw", kind):
                call("/v1/reset", b"")
                tracks[way] = []
                for body, frame in zip(bodies, decoded):
                    status, reply = (
                        call("/v1/track", frame.tobytes(), raw)
                        if way == "raw" else
                        call("/v1/track", body,
                             {"Content-Type": f"image/{kind}"}))
                    check(status == 200, f"{way} POST: {status} {reply}")
                    tracks[way].append(reply["tracks"])
            check(tracks[kind] == tracks["raw"],
                  f"{kind} bodies: tracks != the decoded frames sent raw")
            check(sum(map(len, tracks[kind])) > 0, f"{kind}: no track")
        refused = {}
        for what, body in (
                ("progressive JPEG", progressive(encoded[0][1][0])),
                ("garbage", b"not an image at all"),
                ("65535x65535 JPEG", oversized(encoded[0][1][0])),
                ("corrupt-zlib PNG", corrupt_zlib(encoded[1][1][0]))):
            status, reply = call("/v1/track", body,
                                 {"Content-Type": "image/jpeg"})
            check(status == 400, f"{what}: {status} {reply}")
            refused[what] = reply["error"].split(";")[0]
        image_launches = {kn.name: kn.launches for kn in kernels}
        # each kind: its bodies and their decoded frames sent raw, one chunk
        # a request; the refused bodies launch nothing
        check_launches(image_launches, 2 * 2 * SERVER_IMAGES,
                       "server image bodies (one per request)")
    finally:
        srv.shutdown()
    print(f"[server] healthz {health}; {len(sub)} raw {FRAME_HW[1]}x"
          f"{FRAME_HW[0]} POSTs in {wall:.3f} s ({len(sub) / wall:.2f} "
          f"requests/s, one at a time, chunk {SERVER_CHUNK}); launches "
          f"{launches}; stats {stats}; after /v1/reset the service itself "
          f"gave the same {n_tracks} tracks and ids; {SERVER_IMAGES} JPEG "
          f"(port-encoded q95) and {SERVER_IMAGES} PNG bodies answered 200 "
          f"with the tracks of their decoded frames POSTed raw (launches "
          f"{image_launches} over those {4 * SERVER_IMAGES} requests); 400 "
          f"for {refused}")
    return launches, image_launches


def image_bodies(frames):
    """(kind, encoded bodies, decoded frames) for JPEG (the port's encoder,
    q95 4:2:0) and PNG (``png_bytes``)."""
    from aicamera_tpu_torch.utils.jpeg import decode_jpeg, encode_jpeg
    from aicamera_tpu_torch.utils.png import decode_png
    jpg = [encode_jpeg(f) for f in frames]
    png = [png_bytes(f) for f in frames]
    return [("jpeg", jpg, [decode_jpeg(b) for b in jpg]),
            ("png", png, [decode_png(b) for b in png])]


def progressive(jpeg_bytes):
    """The same file with its SOF0 marker turned into SOF2 (progressive):
    what a baseline decoder must refuse."""
    i = jpeg_bytes.index(b"\xff\xc0")
    return jpeg_bytes[:i] + b"\xff\xc2" + jpeg_bytes[i + 2:]


def oversized(jpeg_bytes):
    """The same file claiming 65535x65535 in its SOF0: refused before the
    decoder allocates anything for it."""
    i = jpeg_bytes.index(b"\xff\xc0")
    return (jpeg_bytes[:i + 5] + struct.pack(">HH", 65535, 65535)
            + jpeg_bytes[i + 9:])


def corrupt_zlib(png):
    """A ``png_bytes`` file whose IDAT stream is corrupt, its CRC valid."""
    i = png.index(b"IDAT")
    (n,) = struct.unpack(">I", png[i - 4:i])
    body = png[i + 4:i + 4 + n]
    bad = body[:2] + bytes(b ^ 0x5A for b in body[2:])
    return (png[:i] + b"IDAT" + bad
            + struct.pack(">I", zlib.crc32(b"IDAT" + bad)) + png[i + 8 + n:])


def load_golden():
    """The JAX package's f32 quality on config 9's world
    (``scripts/make_quality_golden.py``)."""
    golden = json.loads(QUALITY_GOLDEN.read_text())
    check(golden["frames"] % CHUNK == 0, "golden frames not whole chunks")
    return golden


def temporal_world(world, device, seed=None):
    from aicamera_tpu_torch.synthetic import TemporalWorld, WorldSpec
    return TemporalWorld(
        WorldSpec(hw=tuple(world["hw"]), max_objects=world["max_objects"],
                  presence=world["presence"]),
        seed=world["seed"] if seed is None else seed, speed=world["speed"],
        device=device)


def frame_digest(frame, boxes, ids, cls):
    """SHA-256 of a frame and its valid ground truth (the golden's
    ``frame_sha256``, written by ``scripts/make_quality_golden.py``)."""
    import numpy as np
    h = hashlib.sha256(np.ascontiguousarray(frame).tobytes())
    h.update(np.ascontiguousarray(boxes, np.float32).tobytes())
    h.update(np.ascontiguousarray(ids, np.int64).tobytes())
    h.update(np.ascontiguousarray(cls, np.int32).tobytes())
    return h.hexdigest()


def render_world(world, n):
    """``n`` steps of a ``TemporalWorld``: ``(steps, seconds per step)``,
    each step ``(frame, boxes, ids, cls, valid)`` as ``step`` returns it."""
    steps, secs = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        steps.append(world.step())
        secs.append(time.perf_counter() - t0)
    return steps, secs


def score_run(results, steps, score_from):
    """CLEAR-MOT, HOTA and IDF1 of a run's tracks from ``score_from`` on,
    detection AP over all its frames (``benchmarks/run_configs.py::
    _replay_quality`` and config 9), and each frame's ``[x1, y1, x2, y2,
    id]`` tracks."""
    import numpy as np
    from aicamera_tpu_torch.eval import (evaluate_detections, evaluate_hota,
                                         evaluate_identity, evaluate_mot)
    gt = [(b[v], ids[v]) for _, b, ids, _, v in steps]
    gt_det = [(b[v], c[v]) for _, b, _, c, v in steps]
    hyp = [(np.asarray([t[:4] for t in r.tracks],
                       np.float32).reshape(-1, 4),
            np.asarray([t[4] for t in r.tracks], np.int64)) for r in results]
    preds = [(r.det_boxes, r.det_scores, r.det_labels) for r in results]
    w = slice(score_from, len(steps))
    return dict(mot=evaluate_mot(gt[w], hyp[w]),
                hota=evaluate_hota(gt[w], hyp[w]),
                ident=evaluate_identity(gt[w], hyp[w]),
                ap=evaluate_detections(gt_det, preds),
                tracks=[[[int(v) for v in t[:5]] for t in r.tracks]
                        for r in results])


def quality_line(tag, s):
    m, h, i, a = s["mot"], s["hota"], s["ident"], s["ap"]
    print(f"[quality] {tag}: MOTA {m.mota:.4f}, MOTP {m.motp:.4f}, ID "
          f"switches {m.id_switches}, FP {m.false_positives}, FN "
          f"{m.misses}, matches {m.matches} of {m.num_gt}; HOTA "
          f"{h.hota:.4f} (DetA {h.det_a:.4f}, AssA {h.ass_a:.4f}); IDF1 "
          f"{i.idf1:.4f}; AP50 {a.ap50:.4f}, mAP@[.5:.95] {a.map_5095:.4f} "
          f"({a.num_pred} detections)")


def quality_phase(device, kernels):
    """Config 9's world rendered on the card (against the CPU), then the
    trained detector and DeepSORT at full width over it, in bf16 and in f32
    (TF32 off), scored against the ground truth and the JAX golden."""
    import numpy as np
    golden = load_golden()
    world, n, s0 = golden["world"], golden["frames"], golden["score_from"]
    card, secs = render_world(temporal_world(world, device), n)
    cpu, _ = render_world(temporal_world(world, "cpu"), n)
    diff_px = 0
    for t, (a, b) in enumerate(zip(card, cpu)):
        for x, y in zip(a[1:], b[1:]):
            check(np.array_equal(x, y), f"frame {t}: card ground truth != "
                  f"the CPU's")
        d = np.abs(a[0].astype(np.int16) - b[0].astype(np.int16))
        check(d.max() <= 1, f"frame {t}: card pixels {d.max()} levels off")
        diff_px += int((d > 0).any(-1).sum())
    n_px = n * world["hw"][0] * world["hw"][1]
    check(diff_px <= 1e-4 * n_px, f"{diff_px} card pixels != the CPU's")
    same_jax = sum(frame_digest(f, b[v], i[v], c[v]) == want for (
        f, b, i, c, v), want in zip(card, golden["frame_sha256"]))
    live = sum(int(s[4].sum()) for s in card) / n
    print(f"[quality] config 9's world (960x540, 10 objects, seed "
          f"{world['seed']}, speed {world['speed']}): {n} frames rendered on "
          f"the card, {1e3 * np.mean(secs[1:]):.3f} ms a frame (median "
          f"{1e3 * np.median(secs[1:]):.3f}; first {1e3 * secs[0]:.1f}; "
          f"host motion, device render and ground truth, one read); "
          f"{diff_px} of {n_px} pixels differ from the CPU rendering"
          f"{' (bitwise equal)' if diff_px == 0 else ''}, ground truth "
          f"bitwise; {same_jax}/{n} frames equal the JAX golden's SHA-256; "
          f"{live:.2f} visible objects a frame")
    frames = [s[0] for s in card]
    launches = {}
    scores = {}
    for tag, kw in (("bf16", {}),
                    ("f32", dict(detect_dtype="f32", reid_dtype="f32"))):
        pipe = make_pipeline(device, synthetic_load=0, **kw)
        pipe.warm_up(FRAME_HW)
        res, wall, launches[tag], syncs, _ = counted_run(pipe, frames,
                                                         kernels)
        check_launches(launches[tag], n // CHUNK, f"quality {tag}")
        summarize(res)
        scores[tag] = s = score_run(res, card, s0)
        tracks = sum(len(r.tracks) for r in res) / n
        if tag == "bf16":
            pipe.reset()
            _, _, _, _, stage_ms = counted_run(pipe, frames, kernels,
                                               timed=True)
            print(f"[quality] bf16: {n} frames in {wall:.3f} s: {n / wall:.2f}"
                  f" FPS (chunk {CHUNK}, no synthetic boxes); per-chunk "
                  f"stage ms " + ", ".join(f"{k} {v:.3f}"
                                           for k, v in stage_ms.items()))
        else:
            print(f"[quality] f32 (TF32 off): {n} frames in {wall:.3f} s: "
                  f"{n / wall:.2f} FPS")
        print(f"[quality] {tag}: {tracks:.2f} live tracks a frame; host syncs"
              f" a frame: {syncs_line(syncs, n)}; launches "
              f"{launches[tag]} (one per chunk)")
        quality_line(f"{tag}, scored from frame {s0}", s)
    gm, gi = golden["mot"], golden["identity"]
    gh = golden["hota"]["hota"]
    print(f"[quality] JAX golden (f32, CPU): MOTA {gm['mota']:.4f}, ID "
          f"switches {gm['id_switches']}, HOTA {gh:.4f}, IDF1 "
          f"{gi['idf1']:.4f}, AP50 {golden['detection']['ap50']:.4f}")
    f32 = scores["f32"]
    flips = [(t, sorted(map(tuple, set(map(tuple, a)) ^ set(map(tuple, b)))))
             for t, (a, b) in enumerate(zip(f32["tracks"], golden["tracks"]))
             if a != b]
    print(f"[quality] f32 vs the JAX golden: tracks identical on "
          f"{n - len(flips)}/{n} frames" + "".join(
              f"; frame {t}: [x1, y1, x2, y2, id] in one run only {d[:4]}"
              for t, d in flips[:5]))
    deltas = dict(MOTA=f32["mot"].mota - gm["mota"],
                  HOTA=f32["hota"].hota - gh,
                  IDF1=f32["ident"].idf1 - gi["idf1"])
    for k, v in deltas.items():
        check(abs(v) <= 0.005, f"f32 {k} {v:+.4f} off the golden")
    check(abs(f32["mot"].id_switches - gm["id_switches"]) <= 1,
          f"f32 ID switches {f32['mot'].id_switches} vs the golden's "
          f"{gm['id_switches']}")
    bf16 = scores["bf16"]["mot"]
    check(bf16.mota >= gm["mota"] - 0.05,
          f"bf16 MOTA {bf16.mota:.4f} below the golden's minus 0.05")
    check(bf16.id_switches <= gm["id_switches"] + 4,
          f"bf16 ID switches {bf16.id_switches} above the golden's plus 4")
    print("[quality] gates passed: f32 " + ", ".join(
        f"{k} {v:+.4f}" for k, v in deltas.items())
        + f", ID switches {f32['mot'].id_switches - gm['id_switches']:+d} "
        f"(limits 0.005 and 1); bf16 MOTA {bf16.mota - gm['mota']:+.4f} "
        f"(limit -0.05), ID switches "
        f"{bf16.id_switches - gm['id_switches']:+d} (limit +4)")
    return launches, dict(steps=card, golden=golden, scores=scores)


ENGINE_FRAMES = 8     # [engine]: facade frames through each engine
ENGINE_NMS: dict = {}  # [engine]: the detect replay with the kernel and
#                        with the plain keep, for the NMS kernel's record
ENGINE_TIMED = 30     # [engine]: timed calls of each way
REID_BATCHES = (1, 5, 32)


def wall_ms(fn, n=ENGINE_TIMED, warmup=3):
    """Host wall time of one ``fn()`` call that ends in a sync."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def graph_of(engine):
    """The (single) captured graph of an engine."""
    (cap,) = engine._graphs.values()
    return cap


def engine_phase(device, frames, kernels):
    """``runtime.engine`` on the card: the detect and tiled engines against
    their eager steps, the captured letterbox against its plain version,
    ``.cudae`` round trips, the ReID engine, a capture that reads the GPU,
    and the times of each way."""
    import numpy as np
    import torch
    from aicamera_tpu_torch import config
    from aicamera_tpu_torch.detector import (YOLODetector, detect_step,
                                             tiled_step)
    from aicamera_tpu_torch.ops import letterbox as lb
    from aicamera_tpu_torch.ops.nms import greedy_keep_plain
    from aicamera_tpu_torch.ops.preprocess import letterbox_spec
    from aicamera_tpu_torch.ops.tiling import extract_tiles, tile_layout
    from aicamera_tpu_torch.runtime.engine import CUDAGraphEngine
    from aicamera_tpu_torch.tracker_api import ReIDModel

    yolo, reid = str(config.YOLO_SYNTHETIC_PATH), str(config.REID_SYNTHETIC_PATH)
    up = [torch.from_numpy(f).to(device) for f in frames[:ENGINE_FRAMES]]
    dets = {}
    for tag, kw in (("f32", dict(detect_dtype="f32")), ("bf16", {})):
        det = dets[tag] = quiet(lambda: YOLODetector(yolo, device=device,
                                                     **kw))
        eng = det.get_engine(FRAME_HW)
        teng = det._tiled_engine(FRAME_HW, (2, 2), 0.2, True, "iou")
        ways = (("detect", eng, detect_step(
                    det.model, det._dtype, det._spec(FRAME_HW),
                    det.conf_threshold, det.nms_threshold)),
                ("detect_tiled", teng, tiled_step(
                    det.model, det._dtype, FRAME_HW, det.input_shape, (2, 2),
                    0.2, True, "iou", det.conf_threshold,
                    det.nms_threshold)))
        for path, e, eager in ways:
            bitwise = n_det = 0
            for f in up:
                with torch.no_grad():
                    want = eager(f)
                got = e(f)
                same = all(torch.equal(a, b) for a, b in zip(got, want))
                valid = got[3]
                check(torch.equal(valid, want[3]) and torch.equal(
                    got[2][valid], want[2][valid]), f"[engine] {tag} {path}: "
                    f"replay and eager step differ in counts or labels")
                if tag == "f32":
                    check(same, f"[engine] f32 {path}: replay != the eager "
                          f"step (TF32 off: identical expected)")
                bitwise += same
                n_det += int(valid.sum())
            print(f"[engine] {tag} {path} (960x540): replay vs the eager step "
                  f"(the NMS kernel) on {len(up)} frames: counts and labels "
                  f"identical, outputs bitwise on {bitwise}/{len(up)}; "
                  f"{n_det} detections; captured in {e.compile_seconds:.3f} "
                  f"s after {e.warmup_seconds:.3f} s of warm-up passes; "
                  f"{e.graph_nodes()} graph nodes a replay")
    # the captured letterbox, bitwise against the plain version; each replay
    # counts one launch
    origins, tile_hw = tile_layout(FRAME_HW, (2, 2), 0.2)
    n_held = 0
    for path, src, k in facade_shapes():
        spec = letterbox_spec(src, (640, 640))
        for dt in (torch.float32, torch.bfloat16):
            if path == "detect":
                def cut(f):
                    return f[None]
            else:
                def cut(f):
                    return extract_tiles(f, origins, tile_hw)
            e = CUDAGraphEngine(lambda f: lb.letterbox(cut(f), spec, dt),
                                [up[0]], name=f"letterbox_{path}",
                                warmup_iters=1, device=device)
            before = lb.KERNEL.launches
            for f in up[:3]:
                out = e(f)
                check(torch.equal(out, lb.letterbox_plain(cut(f), spec, dt)),
                      f"[engine] captured letterbox ({path}, {dt}) != the "
                      f"plain version")
                n_held += 1
            check(lb.KERNEL.launches == before + 3,
                  f"[engine] 3 replays of the captured letterbox counted "
                  f"{lb.KERNEL.launches - before} launches")
    print(f"[engine] captured letterbox: bitwise equal to the plain version "
          f"on {n_held} replays (K=1 frame and 2x2 tiles, f32 and bf16); "
          f"each replay counted one launch")

    # .cudae round trips, in a temporary directory
    rm = quiet(lambda: ReIDModel(reid, device=device, reid_dtype="f32"))
    rng = np.random.RandomState(SEED)
    crops = {b: torch.from_numpy(rng.randn(b, *config.REID_INPUT_SHAPE, 3)
                                 .astype(np.float32)).to(device)
             for b in REID_BATCHES}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "det.cudae"
        dets["f32"].export_engine(FRAME_HW, path)
        size = path.stat().st_size
        loaded = quiet(lambda: YOLODetector(str(path), device=device))
        for f in frames[:ENGINE_FRAMES]:
            a, b = dets["f32"].detect(f), loaded.detect(f)
            check(all(np.array_equal(x, y) for x, y in zip(a, b)),
                  "[engine] the reloaded .cudae detector differs")
        rpath = Path(tmp) / "reid.cudae"
        rm.export_engine(rpath)
        rm2 = ReIDModel(str(rpath), device=device)
        for b, x in crops.items():
            check(torch.equal(rm.device_apply(x), rm2.device_apply(x)),
                  f"[engine] the reloaded ReID engine differs at batch {b}")
    print(f"[engine] .cudae round trips: the f32 detect engine ({size} bytes)"
          f" reloaded gives bitwise equal detections on {ENGINE_FRAMES} "
          f"frames; the f32 ReID engine reloaded gives bitwise equal "
          f"features at batches {REID_BATCHES} (one capture each)")

    # times, bf16 (the facades' default) at K=1
    det = dets["bf16"]
    eng = det.get_engine(FRAME_HW)
    eager = detect_step(det.model, det._dtype, det._spec(FRAME_HW),
                        det.conf_threshold, det.nms_threshold)
    cap = graph_of(eng)
    with torch.no_grad():
        t_eager = wall_ms(lambda: eager(up[0]))
    t_call = wall_ms(lambda: eng(up[0]))
    t_host_call = wall_ms(lambda: eng(torch.from_numpy(frames[0])))
    t_detect = wall_ms(lambda: det.detect(frames[0]))
    t_replay = time_ms(cap.graph.replay, iters=ENGINE_TIMED)
    t_copies = time_ms(lambda: [o.clone() for o in cap.outputs], iters=200)
    h_copies = time_host_ms(lambda: [o.clone() for o in cap.outputs])
    cost = eng.cost_analysis()
    bound = max(cost["flops"] / PEAK_BF16_FLOPS,
                cost["bytes accessed"] / PEAK_BYTES_PER_S) * 1e3
    # the same step captured with the plain fixed-K tail where the kernel
    # runs (the engines' tail before the kernel), replayed in turns
    with PlainTail():
        plain_eng = CUDAGraphEngine(eager, [up[0]], name="detect_plain_tail",
                                    warmup_iters=1, device=device)
    plain_cap = graph_of(plain_eng)
    check(all(torch.equal(a, b) for a, b in zip(plain_eng(up[0]),
                                                 eng(up[0]))),
          "[engine] the detect replay with the plain tail differs")
    turns = [time_ms(c.graph.replay, iters=ENGINE_TIMED)
             for c in (plain_cap, cap, cap, plain_cap)]
    print(f"[engine] bf16 detect at K=1 (960x540): eager step "
          f"{t_eager:.3f} ms (the NMS kernel: no read); engine call "
          f"{t_call:.3f} ms from a device frame, {t_host_call:.3f} ms from a "
          f"host frame; facade detect() {t_detect:.3f} ms (upload, replay, "
          f"four reads); replay alone {t_replay:.3f} ms on the device "
          f"({cap.nodes} graph nodes); output copies {t_copies:.4f} ms "
          f"device, {h_copies:.4f} ms host; capture "
          f"{eng.compile_seconds:.3f} s, warm-up {eng.warmup_seconds:.3f} s")
    print(f"[engine] detect replay in turns, the plain fixed-K tail in the "
          f"kernel's place / the NMS kernel / the kernel / the plain tail: "
          + " / ".join(f"{t:.3f}" for t in turns) + f" ms; graph nodes "
          f"{plain_cap.nodes} with the plain tail, {cap.nodes} with the "
          f"kernel; outputs bitwise equal")
    print(f"[engine] device_cost of the detect step: {cost['flops']:.4g} "
          f"FLOPs, {cost['bytes accessed']:.4g} bytes (letterbox included): "
          f"bound {bound:.4f} ms against the replay's {t_replay:.3f} ms")
    ENGINE_NMS.update(replay_ms=t_replay, nodes=cap.nodes,
                      plain_tail_replay_ms=[turns[0], turns[3]],
                      kernel_replay_ms=[turns[1], turns[2]],
                      plain_tail_nodes=plain_cap.nodes)

    # the ReID engine at batches 1, 5, 32 (bf16, the default)
    rb = quiet(lambda: ReIDModel(reid, device=device))
    with tempfile.TemporaryDirectory() as tmp:
        rpath = Path(tmp) / "reid.cudae"
        rb.export_engine(rpath)
        rb2 = ReIDModel(str(rpath), device=device)
    rows = []
    for b, x in crops.items():
        same = torch.equal(rb.device_apply(x), rb2.device_apply(x))
        check(torch.allclose(rb.device_apply(x), rb2.device_apply(x),
                             atol=1e-2), f"[engine] bf16 ReID engine at {b}")
        rows.append(f"{b}: eager {wall_ms(lambda: rb.device_apply(x)):.3f} "
                    f"ms, engine {wall_ms(lambda: rb2.device_apply(x)):.3f} "
                    f"ms{' (bitwise)' if same else ''}")
    print("[engine] bf16 ReID engine (dynamic batch) vs eager, wall per call "
          "at batch " + "; ".join(rows))

    # a capture that reads the GPU raises; the card keeps working
    def reads(f):
        boxes, _, _, valid = eager(f)
        return greedy_keep_plain(boxes[None], valid[None], det.nms_threshold)

    try:
        with yardstick_reads():
            CUDAGraphEngine(reads, [up[0]], name="reads", warmup_iters=1,
                            device=device)
        check(False, "[engine] capturing a step that reads the GPU did not "
              "raise")
    except RuntimeError as e:
        check("capture failed" in str(e), f"[engine] unexpected error {e}")
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(eng(up[0]), eng(up[0]))),
          "[engine] the engine after a failed capture")
    print("[engine] capturing the detect step followed by the plain keep's "
          "early-exit form (it reads the GPU) raised RuntimeError; the card "
          "kept working; the eager detect step itself captured (above)")
    reset_counts(kernels)
    for f in frames[:ENGINE_FRAMES]:
        det.detect(f)
    launches = {"detect": {kk.name: kk.launches for kk in kernels}}
    check_launches(launches["detect"], ENGINE_FRAMES, "[engine] detect",
                   solves=False)
    check(eng.replays > 0, "no replay counted")
    return launches


def int8_phase(device, kernels, world):
    """W8A8 on the card: the int8 accumulators and the quantized nets
    against the CPU, bf16 against int8 throughput, and config 9's world
    tracked with both stages in int8."""
    import numpy as np
    import torch
    from aicamera_tpu_torch import config
    from aicamera_tpu_torch.models.quant import (QConv, QuantReIDNet,
                                                 int8_conv,
                                                 quantize_reid_params)
    from aicamera_tpu_torch.models.quant_yolo import (QuantYOLOv8,
                                                      calibration_frames,
                                                      quantize_yolo_synthetic)
    from aicamera_tpu_torch.ops.letterbox import letterbox
    from aicamera_tpu_torch.ops.preprocess import letterbox_spec
    from aicamera_tpu_torch.runtime.engine import CUDAGraphEngine
    from aicamera_tpu_torch.runtime.params import (resolve_reid_params,
                                                   resolve_yolo_params)
    from aicamera_tpu_torch.runtime.pipeline import precision

    f32 = torch.float32
    reid = resolve_reid_params(str(config.REID_SYNTHETIC_PATH),
                               device=device, dtype=f32)
    qreid = QuantReIDNet(quantize_reid_params(reid)).to(device)
    qreid_cpu = QuantReIDNet(quantize_reid_params(reid))
    yolo = resolve_yolo_params("n", weights_path=str(
        config.YOLO_SYNTHETIC_PATH), device=device, dtype=f32)
    t0 = time.perf_counter()
    qyolo, _ = quantize_yolo_synthetic(yolo)
    t_cal = time.perf_counter() - t0
    qyolo_cpu = QuantYOLOv8().bind(qyolo.qparams, qyolo.scales, "cpu")
    cal_cpu = calibration_frames(device="cpu")
    check(torch.equal(calibration_frames(device=device).cpu(), cal_cpu),
          "[int8] calibration frames: card != CPU")
    rng = np.random.RandomState(SEED)
    u8 = rng.randint(0, 256, (32, *config.REID_INPUT_SHAPE, 3)).astype(
        np.float32) / 255.0
    crops = torch.from_numpy(((u8 - np.array([0.485, 0.456, 0.406],
                                             np.float32))
                              / np.array([0.229, 0.224, 0.225],
                                         np.float32)).astype(np.float32))
    spec = letterbox_spec(FRAME_HW, (640, 640))
    steps = world["steps"]
    x8 = letterbox(torch.stack([torch.from_numpy(s[0]) for s in steps[:8]])
                   .to(device), spec, f32)

    # every distinct conv (kernel, stride, input shape) of both nets: the
    # card's int32 accumulators against the CPU's, bitwise
    seen = {}
    accumulate = QConv.accumulate

    def record(self, xq, stride=None):
        out = accumulate(self, xq, stride)
        key = (self.kh, stride or self.stride, tuple(xq.shape),
               tuple(self.wmat.shape))
        if key not in seen:
            seen[key] = (self, xq, out, stride or self.stride)
        return out

    QConv.accumulate = record
    try:
        with torch.no_grad():
            f_card = qreid(crops[:8].to(device))
            lv_card = qyolo(x8[:1])
    finally:
        QConv.accumulate = accumulate
    macs = 0
    for (kh, s, shape, wshape), (m, xq, out, _) in seen.items():
        ref = int8_conv(xq.cpu(), m.wmat.cpu(), kh, kh, s, kh // 2, m.n_out)
        check(torch.equal(out.cpu(), ref), f"[int8] int32 accumulators of "
              f"a {kh}x{kh}/{s} conv on {shape}: card != CPU")
        macs += out.numel() * wshape[1]
    with torch.no_grad():
        f_cpu = qreid_cpu(crops[:8])
        rec_card, rec_cpu = {}, {}
        lv_card = qyolo.apply(qyolo.qparams, x8[:1], record=rec_card)
        lv_cpu = qyolo_cpu.apply(qyolo_cpu.qparams, x8[:1].cpu(),
                                 record=rec_cpu)
    f_err = (f_card.cpu() - f_cpu).abs().max().item()
    check(f_err <= 1e-5, f"[int8] QuantReIDNet card vs CPU: {f_err}")
    flips = total = 0
    for key, a in rec_card.items():
        if a.dtype == torch.int8:
            flips += int((a.cpu() != rec_cpu[key]).sum())
            total += a.numel()
    lv_err = max((a.cpu() - b).abs().max().item()
                 for pa, pb in zip(lv_card, lv_cpu) for a, b in zip(pa, pb))
    check(flips <= 1e-3 * total, f"[int8] QuantYOLOv8 card vs CPU: {flips} "
          f"of {total} int8 activations differ")
    print(f"[int8] int32 accumulators bitwise equal card vs CPU for "
          f"{len(seen)} distinct convs (QuantReIDNet on 8 crops, QuantYOLOv8n"
          f" on one 640x640 frame; {macs / 1e9:.2f} G int8 MACs); "
          f"QuantReIDNet features card vs CPU max |diff| {f_err:.3g} "
          f"(tolerance 1e-5); QuantYOLOv8 card vs CPU: {flips} of {total} "
          f"int8 activations differ (tolerance 1e-3 of them), levels max "
          f"|diff| {lv_err:.4g}; calibration {t_cal:.2f} s on the card, its "
          f"frames bitwise the CPU's")

    # raw throughput, bf16 against int8, each captured and replayed
    bf = torch.bfloat16
    reid_bf = resolve_reid_params(str(config.REID_SYNTHETIC_PATH),
                                  device=device, dtype=bf)
    yolo_bf = resolve_yolo_params("n", weights_path=str(
        config.YOLO_SYNTHETIC_PATH), device=device, dtype=bf)

    def fwd(model, dt):
        def run(x):
            with precision(dt):
                return model(x)
        return run

    rows = {}
    for name, model, dt, x in (
            ("embed bf16", reid_bf, bf, crops.to(device)),
            ("embed int8", qreid, f32, crops.to(device)),
            ("yolov8n bf16", yolo_bf, bf, x8.to(bf)),
            ("yolov8n int8", qyolo, f32, x8)):
        e = CUDAGraphEngine(fwd(model, dt), [x], name=name, warmup_iters=2,
                            device=device)
        cost = e.cost_analysis()
        rows[name] = (time_ms(graph_of(e).graph.replay, iters=20),
                      time_ms(lambda: fwd(model, dt)(x), iters=10), cost)
    for what, n in (("embed", 32), ("yolov8n", 8)):
        (rb, eb, cb), (ri, ei, ci) = rows[f"{what} bf16"], rows[f"{what} int8"]
        print(f"[int8] {what} at {n}: bf16 {rb:.3f} ms replayed "
              f"({n / rb * 1e3:.0f}/s; eager {eb:.3f}), int8 {ri:.3f} ms "
              f"replayed ({n / ri * 1e3:.0f}/s; eager {ei:.3f}): int8/bf16 "
              f"time {ri / rb:.2f}; device_cost bound (each "
              f"implementation's own FLOPs and bytes) bf16 "
              f"{max(cb['flops'] / PEAK_BF16_FLOPS, cb['bytes accessed'] / PEAK_BYTES_PER_S) * 1e3:.4f} ms, int8 "
              f"{max(ci['flops'] / PEAK_INT8_OPS, ci['bytes accessed'] / PEAK_BYTES_PER_S) * 1e3:.4f} ms "
              f"({ci['bytes accessed'] / 1e6:.1f} MB vs {cb['bytes accessed'] / 1e6:.1f} MB moved)")

    # config 9's world with both stages in int8, scored like the bf16 run
    golden, n = world["golden"], len(steps)
    s0 = golden["score_from"]
    pipe = make_pipeline(device, synthetic_load=0, yolo_quant="int8",
                         reid_quant="int8")
    pipe.warm_up(FRAME_HW)
    frames = [s[0] for s in steps]
    res, wall, launches, syncs, _ = counted_run(pipe, frames, kernels)
    check_launches(launches, n // CHUNK, "int8 quality")
    summarize(res)
    sc = score_run(res, steps, s0)
    pipe.reset()
    _, _, _, _, stage_ms = counted_run(pipe, frames, kernels, timed=True)
    print(f"[int8] config 9's world, yolo_quant and reid_quant int8: {n} "
          f"frames in {wall:.3f} s: {n / wall:.2f} FPS; per-chunk stage ms "
          + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items())
          + f"; launches {launches}")
    quality_line("int8, scored from frame " + str(s0), sc)
    bf16 = world["scores"]["bf16"]
    gm = golden["mot"]
    d_ap = sc["ap"].ap50 - bf16["ap"].ap50
    check(d_ap >= -0.01, f"[int8] AP50 {sc['ap'].ap50:.4f} below bf16's "
          f"{bf16['ap'].ap50:.4f} minus 0.01")
    check(sc["mot"].mota >= gm["mota"] - 0.05, f"[int8] MOTA "
          f"{sc['mot'].mota:.4f} below the golden's minus 0.05")
    check(sc["mot"].id_switches <= gm["id_switches"] + 4, f"[int8] ID "
          f"switches {sc['mot'].id_switches} above the golden's plus 4")
    print(f"[int8] gates passed: AP50 {d_ap:+.4f} vs bf16 (limit -0.01), "
          f"MOTA {sc['mot'].mota - gm['mota']:+.4f} vs the golden (limit "
          f"-0.05), ID switches {sc['mot'].id_switches - gm['id_switches']:+d}"
          f" (limit +4)")
    return {"int8": launches}


def write_png(path, bgr):
    path.write_bytes(png_bytes(bgr))


def png_bytes(bgr):
    """A minimal PNG writer (8-bit RGB, filter 0, zlib): the GPU host has
    no OpenCV."""
    import numpy as np
    h, w, _ = bgr.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           bgr[..., ::-1].reshape(h, w * 3)], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + chunk(b"IEND", b""))


def mot_phase(device, kernels):
    """``python -m aicamera_tpu_torch.mot --run --gsi`` on the card over a
    sequence of a second seed of config 9's world, written as PNG frames
    and again as JPEG frames (the port's encoder, q95 4:2:0), each report
    against an in-process scoring of the same hypotheses."""
    import numpy as np
    from aicamera_tpu_torch import config, mot
    from aicamera_tpu_torch.utils.jpeg import decode_jpeg, encode_jpeg
    from aicamera_tpu_torch.utils.png import read_png
    world = load_golden()["world"]
    steps, _ = render_world(temporal_world(world, device, seed=MOT_SEED),
                            MOT_FRAMES)
    launches = None
    for ext in ("png", "jpg"):
        with tempfile.TemporaryDirectory() as tmp:
            data, out = Path(tmp) / "data", Path(tmp) / "out"
            seq = data / "SYN-01"
            (seq / "img1").mkdir(parents=True)
            (seq / "gt").mkdir()
            rows = []
            for t, (frame, boxes, ids, _, valid) in enumerate(steps, 1):
                img = seq / "img1" / f"{t:06d}.{ext}"
                if ext == "png":
                    write_png(img, frame)
                else:
                    img.write_bytes(encode_jpeg(frame))
                for (x1, y1, x2, y2), i in zip(boxes[valid], ids[valid]):
                    rows.append(f"{t},{i},{x1 + 1:.4f},{y1 + 1:.4f},"
                                f"{x2 - x1:.4f},{y2 - y1:.4f},1,1,1")
            (seq / "gt" / "gt.txt").write_text("\n".join(rows) + "\n")
            first = seq / "img1" / f"000001.{ext}"
            want = steps[0][0] if ext == "png" else decode_jpeg(
                encode_jpeg(steps[0][0]))
            got = next(mot.sequence_frames(seq))
            check(np.array_equal(got, want) and (
                ext == "jpg" or np.array_equal(read_png(first), want)),
                f"the {ext.upper()} round trip")
            reset_counts(kernels)
            text = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(text):
                report = mot.main([
                    "--data", str(data), "--out", str(out), "--run", "--gsi",
                    "--yolo_weights", str(config.YOLO_SYNTHETIC_PATH),
                    "--reid_weights", str(config.REID_SYNTHETIC_PATH)])
            wall = time.perf_counter() - t0
            counts = {k.name: k.launches for k in kernels}
            # the harness's pipeline runs one eager pass before its capture
            check_launches(counts, MOT_FRAMES // CHUNK + CAPTURE_PASSES,
                           f"mot --run ({ext})")
            launches = launches or counts
            res, gsi = out / "SYN-01.txt", out / "SYN-01.gsi.txt"
            check(res.exists() and gsi.exists(), "mot wrote no result files")
            gt = seq / "gt" / "gt.txt"
            m = mot.evaluate_sequence(gt, res)
            h = mot.evaluate_sequence_hota(gt, res)
            i = mot.evaluate_sequence_identity(gt, res)
            row = report["SYN-01"]
            check(row["mota"] == m.mota and row["hota"] == round(h.hota, 4)
                  and row["idf1"] == round(i.idf1, 4)
                  and row["id_switches"] == m.id_switches,
                  f"mot's report {row} != the in-process scores")
            check(m.matches > 0, "mot --run matched no ground truth")
            n_boxes = len(res.read_text().splitlines())
        print(f"[mot] python -m aicamera_tpu_torch.mot --run --gsi on the "
              f"card: {MOT_FRAMES} {ext.upper()} frames of seed {MOT_SEED} "
              f"in {wall:.3f} s (pipeline construction, decode and scoring "
              f"included), {n_boxes} result rows; MOTA {m.mota:.4f}, ID "
              f"switches {m.id_switches}, HOTA {h.hota:.4f}, IDF1 "
              f"{i.idf1:.4f}, GSI MOTA {row['gsi_mota']:.4f}, GSI HOTA "
              f"{row['gsi_hota']:.4f}: the report equals an in-process "
              f"scoring of the written hypotheses; launches {counts} (one "
              f"per chunk)")
    return launches


# --- [train]: the trainers on the card, and .onnx weights --------------------
#
# A copy of the protobuf writer of tests/test_torch_onnx_import.py (the GPU
# host has no onnx package): enough of the wire format for Conv and Gemm
# nodes with float32 initializers.


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int, payload: bytes) -> bytes:
    key = _varint((num << 3) | wire)
    if wire == 2:
        return key + _varint(len(payload)) + payload
    return key + payload


def _str_field(num: int, s: str) -> bytes:
    return _field(num, 2, s.encode())


def _tensor_proto(name: str, arr) -> bytes:
    import numpy as np
    out = b"".join(_field(1, 0, _varint(d)) for d in arr.shape)
    out += _field(2, 0, _varint(1))  # data_type float32
    out += _str_field(8, name)
    return out + _field(9, 2, np.asarray(arr, np.float32).tobytes())


def _node(op: str, inputs, outputs) -> bytes:
    return (b"".join(_str_field(1, i) for i in inputs)
            + b"".join(_str_field(2, o) for o in outputs)
            + _str_field(4, op))


def write_checkpoint_onnx(tree, order, path, dfl=False):
    """A Flax-layout params tree as an ONNX file: one Conv (OIHW) or Gemm
    per ``forward_param_order`` entry, chained, a Relu between, and with
    ``dfl`` the detector's fixed arange(16) DFL conv at the end."""
    import numpy as np
    tree = tree.get("params", tree)
    nodes, inits, prev = [], {}, "images"
    for i, (path_, kind) in enumerate(order):
        leaf = tree
        for k in path_:
            leaf = leaf[k]
        w = np.asarray(leaf["kernel"], np.float32)
        inits[f"w{i}"] = w.transpose(3, 2, 0, 1) if kind == "conv" else w
        inits[f"b{i}"] = np.asarray(leaf["bias"], np.float32)
        nodes.append(_node("Conv" if kind == "conv" else "Gemm",
                           [prev, f"w{i}", f"b{i}"], [f"y{i}"]))
        nodes.append(_node("Relu", [f"y{i}"], [f"r{i}"]))
        prev = f"r{i}"
    if dfl:
        inits["dfl"] = np.arange(16, dtype=np.float32).reshape(1, 16, 1, 1)
        nodes.append(_node("Conv", [prev, "dfl"], ["output0"]))
    graph = b"".join(_field(1, 2, n) for n in nodes)
    graph += b"".join(_field(5, 2, _tensor_proto(k, a))
                      for k, a in inits.items())
    graph += _str_field(2, "checkpoint")
    Path(path).write_bytes(_field(1, 0, _varint(8)) + _field(7, 2, graph))
    return path


def train_dispatch(step, key, kernels, *args, sync_check=False):
    """One training dispatch, every launch count and the trainer's read
    count set to 0 just before: ``(losses, aux, launches, reads, wall s,
    sync warnings)``. The wall time ends with the dispatch's one read of
    its losses; ``sync_check`` runs the dispatch under CUDA's sync debug
    mode "warn" and returns what it flagged."""
    import warnings

    import numpy as np
    import torch
    from aicamera_tpu_torch import train as tt
    reset_counts(kernels)
    tt.TRAIN_SYNCS.count = 0
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn" if sync_check else "default")
        try:
            out = step(key, *args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    losses, aux = out if isinstance(out, tuple) else (out, {})
    ls, ax = tt._read(losses, aux)
    wall = time.perf_counter() - t0
    check(np.isfinite(ls).all() and all(np.isfinite(v).all()
                                        for v in ax.values()),
          f"[train] non-finite losses {ls}")
    syncs = [str(w.message) for w in caught
             if "synchroniz" in str(w.message)]
    return (ls, ax, {k.name: k.launches for k in kernels},
            tt.TRAIN_SYNCS.count, wall, syncs)


def _params_np(model):
    return {k: v.detach().float().cpu().numpy()
            for k, v in model.state_dict().items()}


def _quiet(_):
    pass


def train_phase(device, kernels):
    """The trainers on the card: a full-width detector dispatch in f32
    against the CPU; detector training in bf16 at ``TrainConfig``'s widths
    (its parts timed by CUDA events, peak memory, share of the bf16 peak);
    a warm-started fine-tune and the ReID trainer, each held to
    ``train_synthetic``'s save gates; ``finetune_on_clip`` on config 9's
    world; ``.onnx`` weights against the msgpack they were written from."""
    import copy

    import numpy as np
    import torch
    from aicamera_tpu_torch import config, prng
    from aicamera_tpu_torch import train as tt
    from aicamera_tpu_torch import train_synthetic as tts
    from aicamera_tpu_torch.detector import YOLODetector
    from aicamera_tpu_torch.models.onnx_import import forward_param_order
    from aicamera_tpu_torch.models.reid import ReIDNet
    from aicamera_tpu_torch.models.yolov8 import YOLOv8
    from aicamera_tpu_torch.ops.preprocess import letterbox_spec
    from aicamera_tpu_torch.runtime.engine import CUDAGraphEngine
    from aicamera_tpu_torch.runtime.params import (load_flax_msgpack,
                                                   resolve_reid_params,
                                                   resolve_yolo_params,
                                                   seeded_init_)
    from aicamera_tpu_torch.runtime.pipeline import CudaStageTimer, full_f32
    from aicamera_tpu_torch.runtime.profiler import device_cost
    from aicamera_tpu_torch.synthetic import WorldSpec
    from aicamera_tpu_torch.tracker_api import ReIDModel

    name = kernels[0].name
    world, in_hw = WorldSpec(), (640, 640)
    spec = letterbox_spec(world.hw, in_hw)
    counts = {}

    def committed(loader, path):
        return loader(weights_path=str(path), device=device,
                      dtype=torch.float32)

    # 1. one full-width dispatch in f32 (TF32 off), card against the CPU,
    #    both from the committed detector's weights; at warm-up 1 steps 2
    #    and 3 take full updates, and step 3's loss reads step 2's
    cfg = tt.TrainConfig(batch=TRAIN_F32_BATCH, scan=TRAIN_F32_SCAN,
                         warmup=1)
    base = resolve_yolo_params("n", weights_path=str(
        config.YOLO_SYNTHETIC_PATH), device="cpu")
    p0 = _params_np(base)
    runs = {}
    for dev in ("cuda", "cpu"):
        model = copy.deepcopy(base).to(dev)
        opt = tt.make_optimizer(model, cfg.lr, cfg.warmup, cfg.steps,
                                cfg.weight_decay)
        step = tt.make_train_step(model, world, spec, in_hw, cfg, opt,
                                  dtype=torch.float32)
        with full_f32():
            ls, _, launches, reads, wall, _ = train_dispatch(
                step, prng.PRNGKey(cfg.seed), kernels)
        runs[dev] = (ls, _params_np(model), wall)
        if dev == "cuda":
            counts["f32"] = launches[name]
            check(launches[name] == cfg.scan, f"[train] f32: {name} "
                  f"launched {launches[name]} times in {cfg.scan} steps")
            check(reads == 1, f"[train] f32: {reads} reads in a dispatch")
    (lg, pg, wg), (lc, pc, wc) = runs["cuda"], runs["cpu"]
    check(np.allclose(lg, lc, rtol=1e-4, atol=0),
          f"[train] f32 losses card {lg} != CPU {lc}")

    def beyond(a):
        """How far ``a`` lies outside rtol 5e-3, atol 1e-5 of the CPU's
        parameters (above 0: outside)."""
        return max(float((np.abs(a[k] - pc[k]) - 1e-5
                          - 5e-3 * np.abs(pc[k])).max()) for k in pc)
    worst = beyond(pg)
    check(worst <= 0, f"[train] f32 params card vs CPU beyond rtol 5e-3, "
          f"atol 1e-5 (by {worst:.3g})")
    # the tolerance tells a trained state from the start: the card's
    # parameters left as they began would fail it
    check(beyond(p0) > 0, "[train] f32: the dispatch moved the parameters "
          "less than the tolerance")
    diff = max(float(np.abs(pg[k] - pc[k]).max()) for k in pc)
    moved = max(float(np.abs(pc[k] - p0[k]).max()) for k in pc)
    same = "bitwise equal" if diff == 0 else f"max |diff| {diff:.3g}"
    print(f"[train] f32 dispatch (YOLOv8n 640x640, 540x960 world, batch "
          f"{cfg.batch}, scan {cfg.scan}, warm-up 1, TF32 off) card vs CPU: "
          f"losses {lg.tolist()} vs {lc.tolist()} (max rel "
          f"{float((np.abs(lg - lc) / np.abs(lc)).max()):.3g}); params "
          f"{same}, within rtol 5e-3, atol 1e-5 (margin {-worst:.3g}); the "
          f"steps moved them by up to {moved:.3g} (the start lies "
          f"{beyond(p0):.3g} outside the tolerance); "
          f"{wg * 1e3 / cfg.scan:.1f} ms a step on the card, "
          f"{wc * 1e3 / cfg.scan:.1f} on the CPU; {name} once a step")

    # 2. bf16 training: the first dispatches of TrainConfig() (its schedule:
    #    a 200-step warm-up to lr 2e-3 over 3000 steps), from the seeded
    #    init. (A 10-step warm-up made single steps spike to 1e4-1e9 times
    #    their neighbours' loss, on the card and the CPU alike: the net has
    #    no normalization layer to train with.)
    cfg = tt.TrainConfig()
    model = YOLOv8("n")
    seeded_init_(model)
    model = model.to(device)
    opt = tt.make_optimizer(model, cfg.lr, cfg.warmup, cfg.steps,
                            cfg.weight_decay)
    timer = CudaStageTimer(tt.TRAIN_STAGES)
    steps = [tt.make_train_step(model, world, spec, in_hw, cfg, opt),
             tt.make_train_step(model, world, spec, in_hw, cfg, opt,
                                stage_timer=timer)]
    key, means, walls = prng.PRNGKey(cfg.seed), [], []
    for i in range(TRAIN_BF16_DISPATCHES):
        key, sub = prng.split(key)
        last = i == TRAIN_BF16_DISPATCHES - 1
        if last:
            torch.cuda.reset_peak_memory_stats()
        ls, ax, launches, reads, wall, syncs = train_dispatch(
            steps[last], sub, kernels, sync_check=True)
        if last:
            timer.finish()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            counts["bf16"] = launches[name]
            # the first dispatch uploads the step's constants once
            check(not syncs, f"[train] bf16 dispatch {i + 1} synced: "
                  f"{syncs[:3]}")
        check(launches[name] == cfg.scan, f"[train] bf16: {name} launched "
              f"{launches[name]} times in {cfg.scan} steps")
        check(reads == 1, f"[train] bf16: {reads} reads in a dispatch")
        means.append(float(ls.mean()))
        walls.append(wall)
        print(f"[train] bf16 dispatch {i + 1}: mean loss {means[-1]:.4f} "
              f"(cls {ax['cls'].mean():.4f}, iou {ax['iou'].mean():.4f}, "
              f"dfl {ax['dfl'].mean():.4f}), {wall * 1e3 / cfg.scan:.1f} ms "
              f"a step, {len(syncs)} syncs flagged")
    check(means[-1] < means[0], f"[train] bf16 mean loss did not fall: "
          f"{means}")
    ms_step = walls[-1] * 1e3 / cfg.scan
    stage = {s: v / cfg.scan for s, v in timer.totals.items() if v}
    x = torch.zeros(cfg.batch, 3, *in_hw, dtype=torch.bfloat16,
                    device=device)
    engine = CUDAGraphEngine(lambda t: tt._forward(model, t, torch.bfloat16),
                             [x], name="train_forward", warmup_iters=1,
                             device=device)
    fwd_flops = device_cost(engine)["flops"]
    del engine
    share = 3 * fwd_flops / (ms_step / 1e3) / PEAK_BF16_FLOPS
    print(f"[train] bf16 detector (batch {cfg.batch}, scan {cfg.scan}, "
          f"the first {TRAIN_BF16_DISPATCHES} dispatches of {cfg.steps} "
          f"steps, seeded init): {ms_step:.1f} ms a step, "
          f"{cfg.batch * 1e3 / ms_step:.1f} images/s; CUDA-event ms a step: "
          + ", ".join(f"{s} {v:.2f}" for s, v in stage.items())
          + f"; peak memory {peak_gb:.2f} GB; forward {fwd_flops:.4g} FLOPs "
          f"(device_cost), 3x that over the step = {100 * share:.2f}% of "
          f"the bf16 peak ({PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s); "
          f"{name} once a step, one read a dispatch")

    # 3. warm start from the committed detector: the save gate holds
    tune = tt.TrainConfig(steps=TRAIN_TUNE_STEPS, scan=TRAIN_TUNE_STEPS,
                          lr=5e-4, warmup=TRAIN_TUNE_WARMUP)
    sched = tt.warmup_cosine_schedule(tune.lr, tune.warmup, tune.steps,
                                      tune.lr / 20)
    lrs = [sched(c) for c in range(tune.steps)]
    check(abs(max(lrs) - tune.lr) <= 1e-6 * tune.lr, f"[train] the "
          f"fine-tune's learning rate peaks at {max(lrs)}, not {tune.lr}")
    model = committed(resolve_yolo_params, config.YOLO_SYNTHETIC_PATH)
    before = tts.evaluate(model, world, in_hw, n_scenes=TRAIN_EVAL_SCENES)
    reset_counts(kernels)
    t0 = time.perf_counter()
    model = tt.train_detector(world=world, input_hw=in_hw, log=_quiet,
                              model=model, device=device, cfg=tune)
    wall = time.perf_counter() - t0
    counts["finetune"] = kernels[0].launches
    check(counts["finetune"] == TRAIN_TUNE_STEPS, f"[train] fine-tune: "
          f"{counts['finetune']} launches in {TRAIN_TUNE_STEPS} steps")
    after = tts.evaluate(model, world, in_hw, n_scenes=TRAIN_EVAL_SCENES)
    for tag, r in (("before", before), ("after", after)):
        check(r[0] >= 0.85 and r[1] >= 0.85, f"[train] warm start {tag}: "
              f"precision {r[0]:.4f}, recall {r[1]:.4f} below 0.85")
    print(f"[train] warm start ({TRAIN_TUNE_STEPS} steps, warm-up "
          f"{tune.warmup} to lr {tune.lr:g}, mean lr {np.mean(lrs):.3g}, "
          f"train_detector): {wall * 1e3 / TRAIN_TUNE_STEPS:.1f} ms a step "
          f"(one dispatch, its first); {TRAIN_EVAL_SCENES} scenes before: "
          f"precision {before[0]:.4f} recall {before[1]:.4f} AP50 "
          f"{before[5].ap50:.4f}; after: precision {after[0]:.4f} recall "
          f"{after[1]:.4f} AP50 {after[5].ap50:.4f} (gate 0.85)")

    # 4. the ReID trainer from the committed embedder
    model = committed(resolve_reid_params, config.REID_SYNTHETIC_PATH)
    reid_cfg = tt.ReIDTrainConfig(steps=tt.ReIDTrainConfig.scan)
    reset_counts(kernels)
    t0 = time.perf_counter()
    model = tt.train_reid(world=world, cfg=reid_cfg, model=model,
                          log=_quiet, device=device)
    wall = time.perf_counter() - t0
    counts["reid"] = kernels[0].launches
    check(counts["reid"] == 0, "[train] the ReID trainer launched the "
          "letterbox")
    intra, inter, p95, p5 = tts.evaluate_reid(model, world)
    check(p95 <= 0.15 and p5 >= 0.25, f"[train] ReID margins intra_p95 "
          f"{p95:.4f} (<= 0.15), inter_p5 {p5:.4f} (>= 0.25)")
    print(f"[train] ReID ({reid_cfg.scenes} scenes x 2 views a step, "
          f"{reid_cfg.scan} steps, train_reid): "
          f"{wall * 1e3 / reid_cfg.scan:.1f} ms a step (one dispatch, its "
          f"first); intra mean {intra:.4f} p95 {p95:.4f}, inter mean "
          f"{inter:.4f} p5 {p5:.4f} (gates 0.15, 0.25)")

    # 5. finetune_on_clip on config 9's world, labelled with its truth
    golden = load_golden()
    clip, _ = render_world(temporal_world(golden["world"], device),
                           TRAIN_CLIP_FRAMES)
    frames, boxes, _, cls, valid = (np.stack(t) for t in zip(*clip))
    model = committed(resolve_yolo_params, config.YOLO_SYNTHETIC_PATH)
    reset_counts(kernels)
    t0 = time.perf_counter()
    tt.finetune_on_clip(frames, boxes, cls, valid, model, log=_quiet,
                        device=device, cfg=tune)
    wall = time.perf_counter() - t0
    counts["clip"] = kernels[0].launches
    check(counts["clip"] == 2 * TRAIN_TUNE_STEPS, f"[train] clip: "
          f"{counts['clip']} launches in {TRAIN_TUNE_STEPS} steps")
    print(f"[train] finetune_on_clip ({TRAIN_CLIP_FRAMES} frames of config "
          f"9's world, batch 8 = 4 clip + 4 synthetic, {TRAIN_TUNE_STEPS} "
          f"steps): {wall * 1e3 / TRAIN_TUNE_STEPS:.1f} ms a step (one "
          f"dispatch, its first); {name} twice a step")

    # 6. .onnx weights written from the committed checkpoints
    with tempfile.TemporaryDirectory() as d:
        onnx = {}
        for key_, src, net, x in (
                ("yolo", config.YOLO_SYNTHETIC_PATH, YOLOv8("n"),
                 torch.zeros(1, 3, 64, 64)),
                ("reid", config.REID_SYNTHETIC_PATH, ReIDNet(512),
                 torch.zeros(1, 128, 64, 3))):
            onnx[key_] = write_checkpoint_onnx(
                load_flax_msgpack(src), forward_param_order(net, x),
                Path(d) / f"{key_}.onnx", dfl=key_ == "yolo")
        dets = [YOLODetector(str(p), device=device) for p in
                (onnx["yolo"], config.YOLO_SYNTHETIC_PATH)]
        reids = [ReIDModel(str(p), device=device) for p in
                 (onnx["reid"], config.REID_SYNTHETIC_PATH)]
        n_det = 0
        reset_counts(kernels)
        for f, b, v in zip(frames[:TRAIN_ONNX_FRAMES],
                           boxes[:TRAIN_ONNX_FRAMES],
                           valid[:TRAIN_ONNX_FRAMES]):
            got, want = (d_.detect(f) for d_ in dets)
            check(all(np.array_equal(a, w) for a, w in zip(got, want)),
                  "[train] .onnx detector != the msgpack one")
            n_det += len(got[0])
            crops = [f[int(y1):int(y2), int(x1):int(x2)]
                     for x1, y1, x2, y2 in b[v].astype(int)]
            fa, fb = (r.extract_features_batched(crops) for r in reids)
            check(np.array_equal(fa, fb), "[train] .onnx ReID != the "
                  "msgpack one")
        counts["onnx"] = kernels[0].launches
    check(n_det > 0, "[train] no detections to compare")
    print(f"[train] .onnx weights (written from the committed checkpoints): "
          f"YOLODetector and ReIDModel bitwise equal to the msgpack-loaded "
          f"ones on {TRAIN_ONNX_FRAMES} frames ({n_det} detections)")
    return counts


# --- [parallel]: worlds of ranks over torch.distributed --------------------

def parallel_chunks():
    """Config 4's first dispatches: 8 streams x 4 frames of 720p each."""
    scenes = stream_scenes(PARALLEL_DISPATCHES * STREAM_CHUNK)
    return [scenes[:, i * STREAM_CHUNK:(i + 1) * STREAM_CHUNK]
            for i in range(PARALLEL_DISPATCHES)]


def rank_streams(mesh, chunks, timed=False):
    """Config 4 in f32 (TF32 off) on ``mesh``, from fresh states: every
    stream's track tuples, this rank's letterbox launches and batches, the
    collectives by kind, and (``timed``) ms a dispatch of a second pass."""
    import torch
    from aicamera_tpu_torch.ops import letterbox as lb
    from aicamera_tpu_torch.parallel.distributed import COLLECTIVES
    from aicamera_tpu_torch.parallel.tensor_parallel import sharded_convs
    from aicamera_tpu_torch.runtime import pipeline as rp
    pipe = make_streams(None, mesh=mesh, detect_dtype="f32",
                        reid_dtype="f32")
    batches, orig = [], rp.letterbox
    rp.letterbox = lambda f, *a: batches.append(tuple(f.shape)) or orig(f, *a)
    try:
        torch.cuda.synchronize()
        lb.KERNEL.launches = 0
        COLLECTIVES.reset()
        outs = [pipe.step_chunk(c) for c in chunks]
        torch.cuda.synchronize()
        out = {"launches": lb.KERNEL.launches,
               "collectives": dict(COLLECTIVES.by_kind)}
    finally:
        rp.letterbox = orig
    out["batches"] = batches
    out["tuples"] = [stream_tuples(outs, si) for si in range(STREAMS)]
    out["sharded"] = sharded_convs(pipe._engine.yolo)
    out["yolo_bytes"] = sum(p.numel() * p.element_size()
                            for p in pipe._engine.yolo.parameters())
    if timed:
        for i in range(STREAMS):
            pipe.reset_stream(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in chunks:
            pipe.step_chunk(c)
        torch.cuda.synchronize()
        out["ms"] = (time.perf_counter() - t0) * 1e3 / len(chunks)
    return out


def parallel_world_a(rank, device):
    """World A: one NCCL rank on the card, the stream mesh of one."""
    import torch
    from aicamera_tpu_torch.parallel import make_stream_mesh
    out = rank_streams(make_stream_mesh(1), parallel_chunks(), timed=True)
    out["backend"] = torch.distributed.get_backend()
    return out


def _digest(model) -> str:
    h = hashlib.sha256()
    for k, v in sorted(model.state_dict().items()):
        h.update(k.encode())
        h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _levels_err(got, want):
    """max |got - want| over every level's outputs, and max |want|."""
    err = max(float((a.float() - b.float()).abs().max())
              for g, w in zip(got, want) for a, b in zip(g, w))
    return err, max(float(b.float().abs().max()) for w in want for b in w)


def parallel_world_b(rank, device):
    """World B: two gloo ranks sharing the card. 1. config 4 on a 2-rank
    stream mesh; 2. a channel-parallel detector on make_mesh(1, 2): (a)
    config 4 with YOLOv8n, (b) YOLOv8m on 1080p frames; 3. the DP trainer
    over ('batch', 2) against the one-process trainer (rank 0);
    4. the composed stage-split detector over the two ranks."""
    import copy

    import numpy as np
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from aicamera_tpu_torch import config, prng
    from aicamera_tpu_torch import train as tt
    from aicamera_tpu_torch.models.yolov8 import YOLOv8
    from aicamera_tpu_torch.ops import letterbox as lb
    from aicamera_tpu_torch.ops.preprocess import letterbox_spec
    from aicamera_tpu_torch.parallel import (PipelineParallelDetector,
                                             make_mesh, make_stream_mesh,
                                             replicate_params,
                                             shard_detector_params)
    from aicamera_tpu_torch.parallel.distributed import COLLECTIVES
    from aicamera_tpu_torch.runtime.params import (resolve_yolo_params,
                                                   seeded_init_)
    from aicamera_tpu_torch.runtime.pipeline import full_f32, precision
    from aicamera_tpu_torch.scenes import moving_rectangles
    from aicamera_tpu_torch.synthetic import WorldSpec

    out = {"backend": torch.distributed.get_backend()}
    t0 = time.perf_counter()
    chunks = parallel_chunks()
    # 1. streams over a 2-rank stream mesh
    out["streams"] = rank_streams(make_stream_mesh(PARALLEL_RANKS), chunks,
                                  timed=True)
    # 2a. config 4, the detector channel-parallel over two model ranks
    mesh12 = make_mesh(1, PARALLEL_RANKS)
    out["tp"] = rank_streams(mesh12, chunks)
    out["s_streams_tp"] = time.perf_counter() - t0
    # 2b. config 5's --mesh 1x2 shape: YOLOv8m (seeded init) on 1080p, K=4
    t0 = time.perf_counter()
    m = YOLOv8("m")
    seeded_init_(m)
    m = m.to(device).eval()
    frames = torch.from_numpy(moving_rectangles(
        PARALLEL_M_K, PARALLEL_M_HW, n_objects=6, seed=SEED)).to(device)
    x = lb.letterbox(frames, letterbox_spec(PARALLEL_M_HW, (640, 640)),
                     torch.float32)
    with torch.no_grad(), precision(torch.float32):
        want = replicate_params(m, mesh12)(x)
        tp = shard_detector_params(m, mesh12)
        COLLECTIVES.reset()
        got = tp(x)
    out["m_err"], out["m_scale"] = _levels_err(got, want)
    out["m_gathers"] = COLLECTIVES.by_kind.get("all_gather", 0)
    out["m_bytes"] = (sum(p.numel() * p.element_size()
                          for p in tp.parameters()),
                      sum(p.numel() * p.element_size()
                          for p in m.parameters()))
    del m, tp, want, got
    out["s_m"] = time.perf_counter() - t0
    # 3. DP training at TrainConfig's widths, f32, one dispatch of scan 2
    #    at warm-up 1 (step 1 at lr 0, step 2 a full update at lr 2e-3)
    t0 = time.perf_counter()
    cfg = tt.TrainConfig(batch=8, scan=2, warmup=1)
    world, in_hw = WorldSpec(), (640, 640)
    spec = letterbox_spec(world.hw, in_hw)
    start = YOLOv8("n")
    seeded_init_(start)
    start = start.to(device)
    model = copy.deepcopy(start)
    opt = tt.make_optimizer(model, cfg.lr, cfg.warmup, cfg.steps,
                            cfg.weight_decay)
    step = tt.make_train_step_dp(model, world, spec, in_hw, cfg, opt,
                                 DeviceMesh(device.type, torch.arange(
                                     PARALLEL_RANKS),
                                     mesh_dim_names=("batch",)),
                                 dtype=torch.float32)
    lb.KERNEL.launches = 0
    COLLECTIVES.reset()
    with full_f32():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses, _ = step(prng.PRNGKey(cfg.seed))
        torch.cuda.synchronize()
        out["dp_ms"] = (time.perf_counter() - t1) * 1e3 / cfg.scan
    out["dp_launches"] = lb.KERNEL.launches
    out["dp_collectives"] = dict(COLLECTIVES.by_kind)
    out["dp_losses"] = losses.cpu().numpy()
    out["dp_digest"] = _digest(model)
    if rank == 0:
        ref = copy.deepcopy(start)
        ropt = tt.make_optimizer(ref, cfg.lr, cfg.warmup, cfg.steps,
                                 cfg.weight_decay)
        rstep = tt.make_train_step(ref, world, spec, in_hw, cfg, ropt,
                                   dtype=torch.float32)
        with full_f32():
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rlosses, _ = rstep(prng.PRNGKey(cfg.seed))
            torch.cuda.synchronize()
            out["one_ms"] = (time.perf_counter() - t1) * 1e3 / cfg.scan
        out["one_losses"] = rlosses.cpu().numpy()
        pc = {k: v.cpu().numpy() for k, v in ref.state_dict().items()}

        def beyond(sd):
            return max(float((np.abs(v.cpu().numpy() - pc[k]) - 1e-5
                              - 5e-3 * np.abs(pc[k])).max())
                       for k, v in sd.items())
        out["dp_beyond"] = beyond(model.state_dict())
        out["start_beyond"] = beyond(start.state_dict())
        out["dp_max_diff"] = max(
            float((v - ref.state_dict()[k]).abs().max())
            for k, v in model.state_dict().items())
    del model, opt, step, start
    out["s_dp"] = time.perf_counter() - t0
    # 4. the composed stage-split detector: backbone and head
    #    channel-parallel on a 1x2 mesh, the neck on a 2x1 (stream) mesh
    t0 = time.perf_counter()
    yolo = resolve_yolo_params("n", weights_path=str(
        config.YOLO_SYNTHETIC_PATH), device=device,
        dtype=torch.float32).eval()
    frames = torch.from_numpy(moving_rectangles(
        PARALLEL_PP_K, FRAME_HW, n_objects=6, seed=SEED)).to(device)
    x = lb.letterbox(frames, letterbox_spec(FRAME_HW, (640, 640)),
                     torch.float32)
    names = ("stream", "model")
    meshes = [DeviceMesh(device.type, torch.arange(PARALLEL_RANKS)[None],
                         mesh_dim_names=names),
              DeviceMesh(device.type, torch.arange(PARALLEL_RANKS)[:, None],
                         mesh_dim_names=names)]
    pp = PipelineParallelDetector("n", meshes=meshes, dtype=torch.float32)
    pp.place_params(yolo)
    COLLECTIVES.reset()
    with torch.no_grad(), precision(torch.float32):
        got = pp.forward(x)
        want = yolo(x)
    out["pp_collectives"] = dict(COLLECTIVES.by_kind)
    out["pp_err"], out["pp_scale"] = _levels_err(got, want)
    out["pp_batch"] = tuple(got[0][0].shape)
    out["s_pp"] = time.perf_counter() - t0
    return out


def parallel_phase(device, kernels):
    """``[parallel]``: the stream mesh, the channel-parallel detector, the
    DP trainer and the stage-split detector over ``torch.distributed``.
    The card host has one GPU: world A is one NCCL rank; world B is two
    gloo ranks sharing cuda:0 (NCCL refuses two ranks of a communicator on
    one GPU; gloo carries CUDA tensors through host memory). No scaling
    figure is meaningful on one card, and none is claimed."""
    import numpy as np
    import torch
    from aicamera_tpu_torch.ops import letterbox as lb
    from aicamera_tpu_torch.ops.preprocess import letterbox_spec
    from aicamera_tpu_torch.parallel import PipelineParallelDetector
    from aicamera_tpu_torch.parallel.distributed import spawn
    from aicamera_tpu_torch.runtime.params import resolve_yolo_params
    from aicamera_tpu_torch.runtime.pipeline import precision
    from aicamera_tpu_torch.scenes import moving_rectangles
    from aicamera_tpu_torch import config

    t_phase = time.perf_counter()
    s, k, d = STREAMS, STREAM_CHUNK, PARALLEL_DISPATCHES
    # the single-device f32 run every mesh run is held to ([streams]' f32)
    chunks = parallel_chunks()
    ref_pipe = make_streams(device, detect_dtype="f32", reid_dtype="f32")
    ref_outs = [ref_pipe.step_chunk(c) for c in chunks]
    ref = [stream_tuples(ref_outs, si) for si in range(s)]
    del ref_pipe, ref_outs, chunks
    check(sum(len(t) for r in ref for t in r) > 0, "[parallel] the "
          "single-device reference emitted no track")

    # the stage-split detector in one process, devices=[cuda:0]: bitwise
    # the whole YOLOv8 at 640x640, K=8, f32
    yolo = resolve_yolo_params("n", weights_path=str(
        config.YOLO_SYNTHETIC_PATH), device=device,
        dtype=torch.float32).eval()
    frames = torch.from_numpy(moving_rectangles(
        PARALLEL_PP_K, FRAME_HW, n_objects=6, seed=SEED)).to(device)
    x = lb.letterbox(frames, letterbox_spec(FRAME_HW, (640, 640)),
                     torch.float32)
    pp = PipelineParallelDetector("n", devices=[device], dtype=torch.float32)
    pp.place_params(yolo)
    with torch.no_grad(), precision(torch.float32):
        got, want = pp.forward(x, microbatch=PARALLEL_PP_K), yolo(x)
        halves = pp.forward(x)   # the default: two microbatches in flight
    check(all(torch.equal(a, b) for g, w in zip(got, want)
              for a, b in zip(g, w)), "[parallel] the stage-split detector "
          "on one device != YOLOv8")
    err, scale = _levels_err(halves, want)
    check(err <= PP_TOL * scale, f"[parallel] the stage-split detector, "
          f"2 microbatches: max |diff| {err}")
    print(f"[parallel] PipelineParallelDetector(devices=[{device}]) at "
          f"640x640, K={PARALLEL_PP_K}, f32: one microbatch bitwise equal "
          f"to YOLOv8; two of {PARALLEL_PP_K // 2} (the default) max |diff| "
          f"{err:.3g} (outputs up to {scale:.3g}: cuDNN picks its "
          f"algorithms by batch size)")
    del pp, yolo, frames, x, got, want, halves
    torch.cuda.empty_cache()

    def same(tag, tuples):
        total = exact = 0
        for si in range(s):
            t, e = same_tracks(f"[parallel] {tag} stream {si}", tuples[si],
                               ref[si])
            total, exact = total + t, exact + e
        return total, exact

    counts = {}
    # world A
    t0 = time.perf_counter()
    [a] = spawn(parallel_world_a, 1, timeout=300.0)
    wall_a = time.perf_counter() - t0
    check(a["backend"] == "nccl", f"[parallel] world A: {a['backend']}")
    total, exact = same("world A (nccl, make_stream_mesh(1))", a["tuples"])
    # a stream mesh runs the captured step: a launch a dispatch and one in
    # the pass before its capture; the letterbox is called in that pass and
    # in the capture (a replay calls nothing)
    check(a["launches"] == d + CAPTURE_PASSES
          and a["batches"] == [(s * k, *STREAM_HW, 3)] * (1 + CAPTURE_PASSES),
          f"[parallel] world A: launches {a['launches']}, {a['batches']}")
    check(a["collectives"] == {"all_gather": d}, f"[parallel] world A: "
          f"collectives {a['collectives']}")
    counts["world_a"] = a["launches"]
    print(f"[parallel] world A: 1 rank, backend {a['backend']}, "
          f"make_stream_mesh(1), config 4 ({s} streams of "
          f"{STREAM_HW[1]}x{STREAM_HW[0]}, chunk {k}), f32 (TF32 off), {d} "
          f"dispatches: tracks identical to the single-device f32 run "
          f"({total} tuples, {exact} bitwise with conf); {a['launches']} "
          f"letterbox launches (K={s * k}), collectives {a['collectives']}; "
          f"{a['ms']:.2f} ms a dispatch; world {wall_a:.1f} s")

    # world B
    t0 = time.perf_counter()
    ranks = spawn(parallel_world_b, PARALLEL_RANKS, backend="gloo",
                  timeout=300.0)
    wall_b = time.perf_counter() - t0
    n = PARALLEL_RANKS
    for r, b in enumerate(ranks):
        check(b["backend"] == "gloo", f"[parallel] world B: {b['backend']}")
        st = b["streams"]
        same(f"world B rank {r} make_stream_mesh({n})", st["tuples"])
        check(st["launches"] == d + CAPTURE_PASSES
              and st["batches"] == [parallel_shape()[2:3]
                                    + (*STREAM_HW, 3)] * (1 + CAPTURE_PASSES),
              f"[parallel] world B rank {r}: launches {st['launches']}, "
              f"{st['batches']}")
        check(st["collectives"] == {"all_gather": d}, f"[parallel] world B "
              f"rank {r}: collectives {st['collectives']}")
        tp = b["tp"]
        same(f"world B rank {r} make_mesh(1, {n})", tp["tuples"])
        check(tp["launches"] == d and tp["collectives"] == {
            "all_gather": d * (1 + tp["sharded"])}, f"[parallel] TP rank "
            f"{r}: launches {tp['launches']}, {tp['collectives']}")
        check(b["m_err"] <= TP_TOL * b["m_scale"], f"[parallel] YOLOv8m TP "
              f"rank {r}: max |diff| {b['m_err']} (scale {b['m_scale']})")
        check(b["dp_launches"] == 2 and b["dp_collectives"] == {
            "all_reduce": 2}, f"[parallel] DP rank {r}: "
            f"{b['dp_launches']} launches, {b['dp_collectives']}")
        check(b["pp_err"] <= PP_TOL * b["pp_scale"], f"[parallel] composed "
              f"pipeline rank {r}: max |diff| {b['pp_err']}")
        check(b["pp_batch"][0] == PARALLEL_PP_K, f"[parallel] composed "
              f"pipeline rank {r}: batch {b['pp_batch']}")
        counts[f"world_b_rank{r}"] = {"streams": st["launches"],
                                      "tp": tp["launches"],
                                      "dp": b["dp_launches"]}
    b0 = ranks[0]
    check(all(b["dp_digest"] == b0["dp_digest"] for b in ranks),
          "[parallel] DP: parameters differ across ranks")
    check(all(np.array_equal(b["dp_losses"], b0["dp_losses"])
              for b in ranks), "[parallel] DP: losses differ across ranks")
    rel = float((np.abs(b0["dp_losses"] - b0["one_losses"])
                 / np.abs(b0["one_losses"])).max())
    check(rel <= 1e-6, f"[parallel] DP losses {b0['dp_losses']} vs one "
          f"process {b0['one_losses']}: rel {rel}")
    check(b0["dp_beyond"] <= 0, f"[parallel] DP params beyond rtol 5e-3, "
          f"atol 1e-5 of the one-process step (by {b0['dp_beyond']:.3g})")
    check(b0["start_beyond"] > 0, "[parallel] DP: the step moved the "
          "parameters less than the tolerance")
    local, full = b0["tp"]["yolo_bytes"], a["yolo_bytes"]
    st, tp = b0["streams"], b0["tp"]
    print(f"[parallel] world B: {n} ranks sharing one card ({device}), "
          f"backend {b0['backend']} (CUDA tensors through host memory; "
          f"point-to-point staged through host copies); world "
          f"{wall_b:.1f} s")
    print(f"[parallel] make_stream_mesh({n}), config 4, f32: every stream's "
          f"tracks identical to the single-device f32 run on both ranks; "
          f"per rank per dispatch 1 letterbox launch at "
          f"{STREAM_HW[1]}x{STREAM_HW[0]} K={parallel_shape()[2]} and 1 "
          f"collective ({st['collectives']} over {d} dispatches); ms a "
          f"dispatch per rank (two ranks sharing one card, not a scaling "
          f"figure): " + ", ".join(f"{b['streams']['ms']:.2f}"
                                   for b in ranks))
    print(f"[parallel] make_mesh(1, {n}) (YOLOv8n channel-parallel, "
          f"{tp['sharded']} split convs), config 4, f32: tracks identical to "
          f"the single-device run; {tp['collectives']['all_gather'] // d} "
          f"all-gathers a dispatch (1 + one a split conv); detector weights "
          f"{local} bytes a rank of {full} ({local / full:.3f})")
    mb = b0["m_bytes"]
    print(f"[parallel] YOLOv8m (seeded) on make_mesh(1, {n}), "
          f"{PARALLEL_M_HW[1]}x{PARALLEL_M_HW[0]} K={PARALLEL_M_K}, f32: "
          f"channel-parallel vs replicated max |diff| "
          + ", ".join(f"{b['m_err']:.3g}" for b in ranks)
          + f" (outputs up to {b0['m_scale']:.3g}; tolerance {TP_TOL} of "
          f"that); {b0['m_gathers']} all-gathers; weights {mb[0]} bytes a "
          f"rank of {mb[1]} ({mb[0] / mb[1]:.3f})")
    print(f"[parallel] DP trainer over ('batch', {n}), batch 8 (4 a rank), "
          f"640x640, 540x960 world, scan 2, warm-up 1, f32: losses "
          f"{b0['dp_losses'].tolist()} vs one process "
          f"{b0['one_losses'].tolist()} (max rel {rel:.3g}); params within "
          f"rtol 5e-3, atol 1e-5 of the one-process step (max |diff| "
          f"{b0['dp_max_diff']:.3g}; the start lies {b0['start_beyond']:.3g} "
          f"outside), bitwise equal across ranks; one all-reduce and one "
          f"letterbox launch (K=4) a step; ms a step per rank (sharing one "
          f"card): " + ", ".join(f"{b['dp_ms']:.1f}" for b in ranks)
          + f" (one process, batch 8: {b0['one_ms']:.1f})")
    print(f"[parallel] composed PipelineParallelDetector (backbone and "
          f"head on a 1x{n} mesh, neck on a {n}x1 mesh), 640x640 "
          f"K={PARALLEL_PP_K}, f32: vs YOLOv8 max |diff| "
          + ", ".join(f"{b['pp_err']:.3g}" for b in ranks)
          + f" (outputs up to {b0['pp_scale']:.3g}; tolerance {PP_TOL} of "
          f"that); collectives rank 0 {b0['pp_collectives']}")
    print(f"[parallel] rank 0 parts (s): streams+tp "
          f"{b0['s_streams_tp']:.1f}, yolov8m {b0['s_m']:.1f}, dp "
          f"{b0['s_dp']:.1f}, pipeline {b0['s_pp']:.1f}")
    print(f"[time] parallel {time.perf_counter() - t_phase:.1f} s")
    return counts


EXAMPLE_CLIP_FRAMES = 2   # [examples]: the .avi the video scripts read
# [examples]: (script, arguments, hand kernels it must launch), at the sizes
# tests/test_torch_examples.py runs them on the CPU; "{clip}" is the .avi
DETECTS = ("letterbox", "nms")
TRACKS = DETECTS + ("assignment",)
PIPELINE = TRACKS + ("branch",)
EXAMPLE_RUNS = [
    ("detect_image.py", (), DETECTS),
    ("track_video.py", ("--input", "{clip}", "--frames",
                        EXAMPLE_CLIP_FRAMES), TRACKS),
    ("bytetrack_video.py", ("--input", "{clip}", "--frames",
                            EXAMPLE_CLIP_FRAMES), TRACKS),
    ("ocsort_video.py", ("--input", "{clip}", "--frames",
                         EXAMPLE_CLIP_FRAMES), TRACKS + ("oru",)),
    ("fused_pipeline.py", ("--frames", 4, "--chunk", 2), PIPELINE),
    ("synthetic_eval.py", ("--frames", 4, "--chunk", 2), PIPELINE),
    ("quantized_pipeline.py", ("--frames", 4), PIPELINE),
    ("serialized_engines.py", (), TRACKS),
    ("serving_async.py", (), PIPELINE),
    ("multitenant_serving.py", (), PIPELINE),
    ("multistream.py", ("--streams", 4, "--steps", 2), PIPELINE),
    ("multistream.py", ("--ranks", 1, "--streams", 4, "--steps", 2),
     PIPELINE),
    ("multistream.py", ("--ranks", 2, "--streams", 4, "--steps", 2),
     PIPELINE),
    ("pipeline_parallel.py", ("--batch", 4), DETECTS),
]
RANK_LINE = re.compile(r"rank (\d+) on (\S+): streams \d+-\d+, kernel "
                       r"launches (\{.*\})")


def examples_phase(device, kernels, workdir):
    """The twelve scripts of ``examples_torch/`` on the card: each one's
    ``main(argv)`` in this process with no ``--device`` (so the GPU), at the
    CPU test's sizes, every kernel count set to 0 just before and read just
    after; ``multistream.py`` also as a world of one NCCL rank and of two
    gloo ranks sharing the card, whose launches its ranks report. Fails
    where a script raises, exits non-zero or leaves a hand kernel it runs
    unlaunched. One line a run: exit status, wall seconds, launches by
    kernel, the memory still allocated after its objects are gone."""
    import ast
    import importlib
    import torch
    from aicamera_tpu_torch.synthetic import TemporalWorld, WorldSpec
    from aicamera_tpu_torch.utils.video_io import VideoWriter

    # the clip the video scripts read: the synthetic world's frames
    clip = Path(workdir) / "examples_world.avi"
    world = TemporalWorld(WorldSpec(max_objects=8, presence=1.0), seed=3,
                          speed=2.0, device=device)
    writer = VideoWriter(str(clip), 30.0, world.spec.hw)
    try:
        for _ in range(EXAMPLE_CLIP_FRAMES):
            writer.write(world.step()[0])
    finally:
        writer.release()
    del world

    launches = {}
    for script, args, must in EXAMPLE_RUNS:
        argv = [str(clip) if a == "{clip}" else str(a) for a in args]
        tag = " ".join([script, *(a if a != str(clip) else clip.name
                                  for a in argv)])
        main = importlib.import_module(
            "examples_torch." + script[:-3]).main
        reset_counts(kernels)
        out = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                rc = main(argv)
        except Exception as e:  # noqa: BLE001 - reported, then the run fails
            print(out.getvalue()[-2000:])
            raise SmokeFailure(f"[examples] {tag} raised {e!r}") from e
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k.name: k.launches for k in kernels}
        text = out.getvalue()
        ranks = RANK_LINE.findall(text)
        if "--ranks" in argv:
            # the ranks' own counts: they launch in their processes. One
            # rank a card runs NCCL; two on the one card, gloo
            n_ranks = int(argv[argv.index("--ranks") + 1])
            backend = ("nccl" if n_ranks <= torch.cuda.device_count()
                       else "gloo")
            check(len(ranks) == n_ranks, f"[examples] {tag}: {len(ranks)} "
                  f"rank lines")
            check(f"over a {n_ranks}-rank mesh ({backend})" in text,
                  f"[examples] {tag}: not a {backend} world")
            per_rank = [ast.literal_eval(r[2]) for r in ranks]
            counts = {n: sum(r[n] for r in per_rank) for n in counts}
            check(all(r[1].startswith("cuda") for r in ranks),
                  f"[examples] {tag}: ranks on {[r[1] for r in ranks]}")
            check(all(all(r[n] > 0 for n in must) for r in per_rank),
                  f"[examples] {tag}: a rank left a kernel unlaunched: "
                  f"{per_rank}")
        gc.collect()
        torch.cuda.synchronize()
        launches[tag] = counts
        last = [ln for ln in text.splitlines()
                if ln.strip() and not ln.startswith("    ID:")]
        print(f"[examples] {tag}: exit {rc}, {wall:.2f} s, launches "
              + ", ".join(f"{n} {v}" for n, v in counts.items())
              + f"; {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
              f"allocated after; last line: {last[-1] if last else ''!r}")
        check(rc == 0, f"[examples] {tag} exited {rc}")
        missing = [n for n in must if counts[n] == 0]
        check(not missing, f"[examples] {tag}: {missing} never launched")
        check(CARD_NMS_READS[0] == 0, f"[examples] {tag}: "
              f"{CARD_NMS_READS[0]} NMS reads on the card")
        if script == "serialized_engines.py":
            check("== weight-based output (bitwise)" in text,
                  f"[examples] {tag}: the engine was not held bitwise")
    return launches


def profile_chunk(pipe, chunk):
    """GPU busy share of one more chunk, from a torch.profiler trace: the
    sum of kernel and copy times over the host wall time of the chunk."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        list(pipe.process_frames(iter(chunk)))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    if not dev:
        print("[profile] the trace holds no device time: GPU busy share "
              "not measured")
        return
    n_ops = sum(e.count for e in dev)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    print(f"[profile] one chunk of {len(chunk)} frames: wall {wall_ms:.3f} "
          f"ms (profiler on), GPU busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), {n_ops} device ops "
          f"({n_ops / len(chunk):.0f} per frame)")
    for e in top:
        print(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms "
              f"x{e.count:<5d} {e.key[:90]}")


def compare_runs(tag, ours, ref, ref_name):
    """Two runs of the same frames: counts, labels and track tuples
    identical, boxes within 1e-2 px, conf within 1e-4."""
    import numpy as np
    box_err = 0.0
    exact = total = 0
    for g, c in zip(ours, ref, strict=True):
        check(len(g.det_boxes) == len(c.det_boxes), f"frame {g.frame_index}:"
              f" {len(g.det_boxes)} vs {len(c.det_boxes)} detections")
        check(np.array_equal(g.det_labels, c.det_labels),
              f"frame {g.frame_index}: labels differ")
        if len(g.det_boxes):
            box_err = max(box_err, float(np.abs(g.det_boxes
                                                - c.det_boxes).max()))
        check(len(g.tracks) == len(c.tracks),
              f"frame {g.frame_index}: track counts differ")
        for tg, tc in zip(g.tracks, c.tracks):
            total += 1
            exact += tg == tc
            # ids, classes and integer boxes identical; conf is the
            # detector score, equal up to the conv implementations' f32
            # rounding
            check(tg[:6] == tc[:6], f"frame {g.frame_index}: {tg} vs {tc}")
            check(abs(tg[6] - tc[6]) <= 1e-4,
                  f"frame {g.frame_index}: conf {tg[6]} vs {tc[6]}")
    # tolerance: the two f32 convolution stacks round differently
    check(box_err <= 1e-2, f"detection boxes differ by {box_err} px")
    check(total > 0, f"[{tag}: no track to compare")
    print(f"[{tag}: {len(ours)} frames, card f32 (TF32 off) vs {ref_name}: "
          f"detection counts and labels identical, max box |diff| "
          f"{box_err:.3g} px (tolerance 1e-2); track tuples: ids, classes "
          f"and boxes identical on {total}, {exact} bitwise identical "
          f"including conf (conf tolerance 1e-4)")


def compare_phase(frames):
    """First chunks on the card in f32 (TF32 off) against the plain CPU
    path, and at chunk 4 against chunk 8 on the card."""
    sub = frames[:COMPARE_CHUNKS * CHUNK]
    f32 = dict(detect_dtype="f32", reid_dtype="f32")
    gpu = list(make_pipeline("cuda", **f32).process_frames(iter(sub)))
    cpu = list(make_pipeline("cpu").process_frames(iter(sub)))
    compare_runs("compare]", gpu, cpu, "CPU")
    gpu4 = list(make_pipeline("cuda", **f32).process_frames(
        iter(sub), chunk_size=CHUNK // 2))
    compare_runs("compare] chunk 4", gpu4, gpu, "the card at chunk 8")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "aicamera_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the aicamera_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel phase (build, compare, time)")
    ap.add_argument("--only", default=None,
                    help="comma-separated phases to run after the kernel "
                         "phases (assignment, oru, nms or branch: the kernel "
                         "phases alone; main, "
                         "bucket, "
                         "trackers, gmc, facades, "
                         "engine, cli, present, compare, streams, serving, "
                         "server, quality, int8, mot, train, parallel, "
                         "examples); "
                         "default all")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from aicamera_tpu_torch.ops.assignment import KERNEL as ASSIGNMENT
    from aicamera_tpu_torch.ops.assignment import AssignmentKernel
    from aicamera_tpu_torch.ops.letterbox import KERNEL as LETTERBOX
    from aicamera_tpu_torch.ops.nms import KERNEL as NMS
    from aicamera_tpu_torch.ops.nms import NmsKernel
    from aicamera_tpu_torch.ops.oru import KERNEL as ORU
    from aicamera_tpu_torch.ops.oru import OruKernel
    from aicamera_tpu_torch.runtime.branches import KERNEL as BRANCH
    from aicamera_tpu_torch.scenes import moving_rectangles

    kernels = [LETTERBOX, ASSIGNMENT, ORU, NMS, BRANCH]
    watch_nms_reads()
    # the phase probes of the assignment, ORU and NMS kernels: their own
    # builds, loaded by the [assignment], [oru] and [nms] phases only
    probe_builds = [AssignmentKernel(probe=True), OruKernel(probe=True),
                    NmsKernel(probe=True)]
    t_start = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        ident = gpu_identity()
        print(f"[gpu] {ident}")
        print(f"[gpu] torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"python {sys.version.split()[0]}")
        build_s = build_kernels(kernels + probe_builds)
        print(f"[build] {len(kernels)} kernel(s) built in {build_s:.2f} s")
        device = torch.device("cuda")
        phase_s = {}

        def timed(name, fn, *a):
            t0 = time.perf_counter()
            out = fn(*a)
            phase_s[name] = time.perf_counter() - t0
            # the phase's pipelines (and their graphs' pools) go before the
            # next phase, cycles among them too
            gc.collect()
            print(f"[memory] after {name}: "
                  f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB "
                  f"allocated, {torch.cuda.memory_reserved() / 2**30:.2f} "
                  f"GiB reserved")
            return out

        records = [timed("kernel", kernel_phase, device),
                   timed("assignment", assignment_phase, device),
                   timed("oru", oru_phase, device),
                   timed("nms", nms_phase, device),
                   timed("branch", branch_phase, device)]
        if args.kernels_only or args.only in ("assignment", "oru", "nms",
                                              "branch"):
            print(json.dumps({"kernels": records}))
            return 0
        frames = moving_rectangles(N_CHUNKS * CHUNK, FRAME_HW, n_objects=6,
                                   seed=SEED)

        only = set(args.only.split(",")) if args.only else None
        if only and "int8" in only:
            only.add("quality")  # int8 tracks the quality phase's world
        if only and "present" in only:
            only.add("cli")      # present reads the CLI's saved video

        def run(name, fn, *a):
            if only is None or name in only:
                by_path[name] = timed(name, fn, *a)

        by_path, world = {}, {}
        run("main", main_path_phase, device, frames, kernels)
        for name, fn, a in (("bucket", bucket_phase, (device, frames)),
                            ("trackers", trackers_phase, (device, frames)),
                            ("gmc", gmc_phase, (device,)),
                            ("facades", facades_phase, (device, frames)),
                            ("engine", engine_phase, (device, frames)),
                            ("cli", cli_phase, (frames,))):
            if name == "cli":
                a = (*a, kernels, workdir)
            else:
                a = (*a, kernels)
            run(name, fn, *a)
        if only is None or "present" in only:
            timed("present", present_phase)
        if only is None or "compare" in only:
            timed("compare", compare_phase, frames)
        run("streams", streams_phase, device, kernels, records[2])
        if only is None or "serving" in only:
            by_path["serving"], by_path["multi_tenant"] = timed(
                "serving", serving_phase, device, frames, kernels)
        if only is None or "server" in only:
            by_path["server"], by_path["server_images"] = timed(
                "server", server_phase, device, frames, kernels)
        if "quality" in (only or {"quality"}):
            by_path["quality"], world = timed("quality", quality_phase,
                                              device, kernels)
        run("int8", int8_phase, device, kernels, world)
        run("mot", mot_phase, device, kernels)
        run("train", train_phase, device, kernels)
        run("parallel", parallel_phase, device, kernels)
        run("examples", examples_phase, device, kernels, workdir)
        check(CARD_NMS_READS[0] == 0, f"{CARD_NMS_READS[0]} NMS reads on "
              f"the card outside the yardsticks")
        print("[nms] no path read the card in its NMS (0 reads of the plain "
              "keep's eager form on the card outside the yardsticks)")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    # the other paths, each counted from 0: bucket (its last run), every
    # tracker, the GMC pipelines, every facade (one letterbox launch per
    # detect call; detect_tiled two), the CLI (warm-up chunks included), the
    # multi-stream dispatches, the two services, the server's raw requests
    # and its JPEG and PNG requests with their raw twins, the quality runs
    # (bf16, f32), mot --run, and the trainers by part (one letterbox launch
    # a detector step, two a clip step, none in the ReID trainer; no solve)
    # The ORU kernel is not on the (DeepSORT) main path: its launches are
    # those of its own path, [trackers]' OC-SORT run, counted from 0 there.
    own_path = {"oru": ("trackers", "ocsort")}
    if ENGINE_NMS:
        records[3]["engine_detect"] = dict(ENGINE_NMS)
    for record in records:
        name = record["name"]
        path, sub = own_path.get(name, ("main", None))
        counts = by_path.get(path, {})
        record["launches"] = (counts if sub is None
                              else counts.get(sub, {})).get(name)
        record["launches_path"] = path if sub is None else f"{path} {sub}"
        record["launches_by_path"] = {
            path: (counts if path in ("train", "parallel") else
                   {t: v[name] for t, v in counts.items()}
                   if path in ("trackers", "gmc", "facades", "engine",
                               "quality", "int8", "streams", "examples")
                   else counts[name])
            for path, counts in by_path.items()
            if name == "letterbox" or path not in ("train", "parallel")}
    print(f"[time] chip_smoke.py took {time.perf_counter() - t_start:.1f} s;"
          f" by phase: " + ", ".join(f"{n} {v:.1f}"
                                     for n, v in phase_s.items()))
    print(ident)  # name, power limit: as nvidia-smi prints them
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
