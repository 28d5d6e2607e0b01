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
   ``[assignment]``: the assignment kernel (``csrc/assignment.cu``), called
   through the public ``min_cost_matching`` and ``matching_cascade`` on
   card tensors, bitwise against their plain versions on the same tensors
   on 55 seeded problems (``assignment_cases``: DeepSORT loads at 128 and
   32 track slots, ties with -0.0, nothing feasible, one row, R < C, R > C,
   n = 256 staged and in device memory, cascades over 1, 2, 5 and 70
   levels, the OC-SORT and ByteTrack costs); then its device ms a solve
   (graph replay) at the main path's 128x64, per call, the plain version's,
   ``scipy.optimize.linear_sum_assignment``'s on the host with the copy,
   and its bound: the larger of the bytes it must move (the R x C cost and
   the masks read once, the outputs written once) and an empty kernel's
   replay;
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
   per frame, tracks emitted, the kernel once per chunk; then the same 16
   frames on the card in f32 (TF32 off) against the plain CPU path;
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
   frame, the kernel once per frame (each ``detect`` a replay of its
   captured engine, counted per replay); one ``detect_tiled`` frame (two
   launches); then 8 frames through every facade on the card in f32 against
   the CPU (identical tuples);
   ``[engine]``: ``runtime.engine`` on the facades' frames: the detect
   (K=1) and tiled engines replayed against their eager steps (f32 with
   TF32 off: identical outputs; bf16: identical counts and labels), the
   captured letterbox bitwise against its plain version, ``.cudae`` round
   trips in a temporary directory (detect and ReID, bitwise), the ReID
   engine at batches 1, 5 and 32, a capture that reads the GPU (it must
   raise); times of the eager step and the replay, the fixed-K NMS keep
   alone, the output copies, the capture, ``device_cost`` beside the
   replay, and the graph nodes;
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
    stream-frame, the kernel once per dispatch (K=32); a dispatch with two
    streams masked leaves their states bitwise; in f32 (TF32 off) each
    stream equals a ``TrackingPipeline`` on that stream alone; 2 streams x
    1 chunk card f32 against the CPU for DeepSORT, ByteTrack and the
    StrongSORT preset (GMC); StrongSORT's batched GMC ms per dispatch;
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
    per rank (two ranks sharing one card: no scaling figure).

The last two lines of output are the kernels' JSON record (letterbox and
assignment, each with its launches by path) and the device JSON record.
``--kernels-only`` stops after step 3; ``--only`` runs the
kernel phase and the named phases (``int8`` brings ``quality`` along,
``present`` brings ``cli``; ``--only parallel`` runs step 17 alone).
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
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
    """A kernel's time on the device without its host side: ``rounds *
    n_sets`` launches captured into one CUDA graph, CUDA events around a
    replay, the median of ``replays`` replays over the launch count. It
    holds the gap between two kernel nodes of a graph (about a microsecond),
    so it bounds the kernel's own duration from above. ``launch(i)`` runs on
    buffer set ``i``. Where a kernel's reads from device memory are what is
    timed, the caller sizes the sets so that together they exceed the L2
    cache, so every launch finds its inputs in device memory; a
    latency-bound kernel whose inputs its path leaves in the L2 (the
    assignment solves) is timed over a few L2-resident sets."""
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
    return sorted(times)[replays // 2] / (rounds * n_sets)


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
        cuda = [pool.submit(cuda_build.build, k.source) for k in kernels]
        cxx = [pool.submit(host_build.build, src) for src in host]
        for k, fut in zip(kernels, cuda):
            lib, log = fut.result()
            print(f"[build] {k.name}: {lib.name}")
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
    return cases


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


def assignment_phase(device):
    """The assignment kernel against its plain version on the card, bitwise,
    on :func:`assignment_cases`; then its times at the main path's shapes."""
    import numpy as np
    import torch
    from aicamera_tpu_torch.core import assignment as asg
    from aicamera_tpu_torch.ops.assignment import KERNEL

    def on_card(args):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                if isinstance(a, np.ndarray) else a for a in args]

    public = {"match": asg.min_cost_matching,
              "cascade": asg.matching_cascade}
    plain = {"match": asg.min_cost_matching_plain,
             "cascade": asg.matching_cascade_plain}
    by_family, max_err = {}, 0.0
    for fam, kind, args in assignment_cases():
        a = on_card(args)
        before = KERNEL.launches
        got = public[kind](*a)
        check(KERNEL.launches == before + 1,
              f"[assignment] {fam} {kind}: the kernel did not launch once")
        want = plain[kind](*a)
        torch.cuda.synchronize()
        got, want = (got, want) if kind == "cascade" else ((got,), (want,))
        for g, w in zip(got, want):
            check(g.dtype == w.dtype and torch.equal(g, w),
                  f"[assignment] {fam} {kind} {tuple(args[0].shape)}: "
                  f"kernel {g.tolist()} != plain {w.tolist()}")
            max_err = max(max_err, float(torch.max(torch.abs(
                g.double() - w.double()))))
        by_family[fam] = by_family.get(fam, 0) + 1
    print(f"[assignment] kernel bitwise equal to the plain version on "
          f"{sum(by_family.values())} problems (max |diff| {max_err}): "
          + ", ".join(f"{f} {n}" for f, n in by_family.items()))

    # times at the main path's shapes: a DeepSORT frame's cascade and IoU
    # solve at a load of 24 tracks and 24 detections
    rng = np.random.RandomState(SEED + 1)
    card = []
    for _ in range(ASG_TIMED_SETS):
        rows = np.zeros(ASG_T, bool)
        rows[rng.choice(ASG_T, 24, replace=False)] = True
        cols = np.zeros(ASG_N, bool)
        cols[:24] = True
        app = rng.uniform(0, 0.5, (ASG_T, ASG_N)).astype(np.float32)
        app[rng.rand(ASG_T, ASG_N) < 0.6] = ASG_INFTY
        lv = np.where(rng.rand(ASG_T) < 0.8, 1, 2).astype(np.int32)
        iou = np.ones((ASG_T, ASG_N), np.float32)
        near = rng.rand(ASG_T, ASG_N) < 0.08
        iou[near] = rng.uniform(0, 1, near.sum())
        card.append({
            "cascade": on_card((app, lv, rows, cols, ASG_MAX_COS,
                                ASG_DEPTH)),
            "match": on_card((iou, rows, cols, ASG_MAX_IOU))})
    # the launch floor: an empty kernel (PyTorch's spin kernel for 0
    # cycles) replayed from a graph
    launch_floor = time_device_ms(lambda i: torch.cuda._sleep(0), 1,
                                  rounds=64)
    rows_out = []
    for kind in ("cascade", "match"):
        fn = public[kind]
        device_ms = time_device_ms(lambda i: fn(*card[i][kind]),
                                   ASG_TIMED_SETS)
        ms = sorted(time_ms(lambda: fn(*card[0][kind]))
                    for _ in range(3))[1]
        plain_ms = time_ms(lambda: plain[kind](*card[0][kind]), iters=5,
                           warmup=1)

        def library():
            host = [a.cpu().numpy() if torch.is_tensor(a) else a
                    for a in card[0][kind]]  # the copy a host solver needs
            return (scipy_cascade(*host) if kind == "cascade"
                    else scipy_solve(*host))

        library_ms = sorted(time_host_ms(library, bursts=5, burst=4)
                            for _ in range(3))[1]
        # the least work: each input read once (the R x C cost and the
        # masks), each output written once, one comparison a cost entry;
        # and no launch takes less than an empty kernel's replay
        args = card[0][kind]
        out = fn(*args)
        out = out if kind == "cascade" else (out,)
        n_bytes = sum(t.numel() * t.element_size()
                      for t in (*args, *out) if torch.is_tensor(t))
        t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
        t_ops = args[0].numel() / PEAK_F32_FLOPS * 1e3
        bound = max(t_bytes, t_ops, launch_floor)
        r = {"shape": f"{ASG_T}x{ASG_N} f32 {kind}, 24 tracks x 24 "
                      f"detections", "device_ms": device_ms, "ms": ms,
             "plain_ms": plain_ms, "library_ms": library_ms,
             "bound_ms": bound,
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "bound_term": ("launch floor" if bound == launch_floor
                            else "work"),
             "bytes": n_bytes, "bytes_ms": t_bytes,
             "launch_floor_ms": launch_floor}
        rows_out.append(r)
        print(f"[assignment] {r['shape']}: device {device_ms:.4f} ms a solve "
              f"(graph replay, L2-resident), per call {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, scipy {library_ms:.4f} ms (host, with the "
              f"copy), bound {bound:.6f} ms (the larger of {n_bytes} bytes "
              f"once, {t_bytes:.6f} ms, and an empty kernel's replay, "
              f"{launch_floor:.6f} ms: {r['bound_term']}); "
              f"{100 * bound / device_ms:.1f}% of the bound")
    KERNEL.launches = 0  # comparison and timing launches do not count
    main = rows_out[0]
    return {"name": KERNEL.name, "route": "cuda",
            "source": "aicamera_tpu_torch/csrc/assignment.cu",
            "replaces": KERNEL.replaces, "launches": None,
            "max_abs_err": max_err, "ms": main["ms"],
            "device_ms": main["device_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "bound_term": main["bound_term"],
            "library_ms": main["library_ms"],
            "launch_floor_ms": launch_floor,
            "problems_checked": sum(by_family.values()), "shapes": rows_out}


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
    puts CUDA events at the stage boundaries."""
    import torch
    from aicamera_tpu_torch.runtime.pipeline import CudaStageTimer
    counters = sync_counters()
    pipe.stage_timer = CudaStageTimer() if timed else None
    for k in kernels:
        k.launches = 0
    for c in counters.values():
        c.count = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = list(pipe.process_frames(iter(frames)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    syncs = {name: c.count for name, c in counters.items()}
    stage_ms = None
    if timed:
        stage_ms = {s: v / pipe.stage_timer.chunks
                    for s, v in pipe.stage_timer.totals.items()}
        pipe.stage_timer = None
    check(len(results) == len(frames),
          f"{len(results)} results for {len(frames)} frames")
    return results, wall, launches, syncs, stage_ms


def check_launches(launches, n_chunks, what, solves=True):
    """The letterbox once per chunk (dispatch, call); the assignment kernel
    at least once where the path must solve (``solves``: a DeepSORT or
    ByteTrack core; OC-SORT's shortcut may skip every solve of a run, and
    detection alone solves nothing): its count follows the frames and the
    cores' branches, and is printed."""
    for name, n in launches.items():
        if name == "letterbox":
            check(n == n_chunks, f"{what}: {name} launched {n} times over "
                  f"{n_chunks} chunks")
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
    check_launches(launches, N_CHUNKS, "main path")
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
          f"result read per chunk); tracker reads a frame "
          f"{syncs['tracker'] / n:.3f}; assignment launches a frame "
          f"{launches['assignment'] / n:.3f} (a cascade and an IoU solve)")
    check(syncs["tracker"] == 0, f"the DeepSORT step read the GPU "
          f"{syncs['tracker']} times")
    print("[main] sample tracks, last frame: "
          + repr(results[-1].tracks[:4]))

    # the same frames again with CUDA events at every stage boundary: the
    # tracker scans replayed from their captures, then run frame by frame
    def timed_run():
        pipe.reset()
        timer = CudaStageTimer()
        pipe.stage_timer = timer
        out = list(pipe.process_frames(iter(frames)))
        pipe.stage_timer = None
        return out, {s: v / timer.chunks for s, v in timer.totals.items()}

    again, stage_ms = timed_run()
    with eager_scans(pipe):
        pipe.warm_up(FRAME_HW)
        eager, eager_ms = timed_run()
    print("[main] per-chunk stage ms (CUDA events, includes the host "
          "launch gaps): " + ", ".join(f"{s} {v:.3f}"
                                       for s, v in stage_ms.items())
          + f"; tracker per frame {stage_ms['tracker'] / CHUNK:.3f} ms")
    print(f"[main] tracker ms a chunk: captured scan {stage_ms['tracker']:.3f}"
          f", eager scan {eager_ms['tracker']:.3f}")
    same = sum(a.tracks == b.tracks for a, b in zip(results, again))
    print(f"[main] timed rerun: {same}/{n} frames with identical tracks")
    check([r.tracks for r in eager] == [r.tracks for r in again],
          "[main] the captured scan's tracks differ from the eager scan's")
    print(f"[main] eager scan: track tuples identical to the captured "
          f"scan's on {n} frames")
    pipe.warm_up(FRAME_HW)  # captures the scans again
    profile_chunk(pipe, frames[-CHUNK:])
    return launches


@contextlib.contextmanager
def eager_scans(pipe):
    """Inside, ``pipe`` runs its DeepSORT scans frame by frame with the
    host's branches, not from CUDA-graph captures (to time and hold the two
    against each other in one call)."""
    pipe._capture_scans = False
    pipe._stages.clear()  # the stages hold their engines
    try:
        yield
    finally:
        del pipe._capture_scans
        pipe._stages.clear()


def bucket_phase(device, frames, kernels):
    """``scan_bucket=32`` against ``scan_bucket=0`` in one call, one run
    each, at the main path's load (24 synthetic boxes a frame, more live
    tracks than the small pass admits) and at a light load (8, where the
    small pass runs every chunk): identical track tuples, and the FPS and
    tracker ms of both."""
    launches = {}
    for load in (24, 8):
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
            runs[b].append((res, len(frames) / wall,
                            stage_ms["tracker"] / CHUNK, syncs,
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
        for b in (32, 0):
            print(f"[bucket] load {load}, scan_bucket {b}: FPS "
                  + " / ".join(f"{r[1]:.2f}" for r in runs[b])
                  + ", tracker ms per frame "
                  + " / ".join(f"{r[2]:.3f}" for r in runs[b])
                  + f", syncs per frame: "
                  f"{syncs_line(runs[b][0][3], len(frames))}")
        print(f"[bucket] load {load}: chunks by way {stats}; track tuples "
              f"identical over {len(frames)} frames in both runs "
              f"({summarize(ref)[0]} track outputs)")
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
    """Each new tracker at full width on the card, then against the CPU."""
    import torch
    check(not torch.backends.cuda.matmul.allow_tf32,
          "f32 matmuls run in TF32: the cores' cosine products need f32")
    sub = frames[:TRACKER_CHUNKS * CHUNK]
    by_tracker = {}
    for name, kw in tracker_configs().items():
        pipe = make_pipeline(device, tracker=name, **kw)
        pipe.warm_up(FRAME_HW)
        res, wall, launches, syncs, _ = counted_run(pipe, sub, kernels)
        check_launches(launches, TRACKER_CHUNKS, f"tracker {name}",
                       solves="ocsort" not in name)
        if pipe.tracker_kind == "deepsort":  # the StrongSORT preset
            check(syncs["tracker"] == 0, f"tracker {name}: the DeepSORT "
                  f"step read the GPU {syncs['tracker']} times")
        by_tracker[name] = launches
        n_tracks, n_ids = summarize(res)
        check(n_tracks > 0, f"tracker {name} emitted no track")
        stats = dict(pipe.scan_stats)
        pipe.reset()
        stage_ms = counted_run(pipe, sub, kernels, timed=True)[4]
        gmc = (f", gmc {pipe.gmc_method} {stage_ms['gmc']:.3f} ms per chunk"
               if pipe.gmc_method else "")
        print(f"[trackers] {name}: {len(sub)} frames, {len(sub) / wall:.2f} "
              f"FPS, tracker {stage_ms['tracker'] / CHUNK:.3f} ms per "
              f"frame{gmc}, syncs per "
              f"frame: {syncs_line(syncs, len(sub))}; track outputs "
              f"{n_tracks}, distinct ids {n_ids}, chunks {stats}, launches "
              f"{launches} (the letterbox one per chunk)")
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
            res, wall, counts, _, stage_ms = counted_run(
                pipe, frames, kernels, timed=True)
            check_launches(counts, GMC_CHUNKS, f"gmc {name} {mode}",
                           solves=name != "ocsort")
            n_tracks, n_ids = summarize(res)
            check(n_tracks > 0, f"gmc {name} {mode}: no track")
            line.append(f"{mode}: {len(frames) / wall:.2f} FPS, gmc "
                        f"{stage_ms['gmc']:.3f} ms per chunk, "
                        f"{n_ids / n_obj:.2f} ids per object, {n_tracks} "
                        f"track outputs")
            if mode == "affine":
                launches[name] = counts
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
                       f"calls)", solves="OCSort" not in name)
        n_tracks = sum(map(len, outs))
        check(n_tracks > 0, f"facade {name} emitted no track")
        check(all(np.isfinite(t[:4]).all() and np.isfinite(t[6])
                  for o in outs for t in o), f"facade {name}: non-finite")
        syncs = {n: c.count for n, c in counters.items()}
        if name in ("DeepSORT", "StrongSORT"):
            check(syncs["tracker"] == 0, f"facade {name}: the DeepSORT step "
                  f"read the GPU {syncs['tracker']} times")
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

    def run(argv):
        for k in kernels:
            k.launches = 0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(argv)
        for ln in out.getvalue().splitlines():
            print(f"[cli]   {ln}")
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
    # one launch per chunk, the warm-up's chunks included
    check_launches(launches, n // CHUNK + WARM_UP_ITERS, "cli")
    state = load_state(ckpt, TrackerParams())
    check(bool(state.active.any()) and int(state.next_id) > 1,
          "the checkpoint holds no track")
    text, resumed = run(["--input", str(clip), "--no_save", "--resume",
                         str(ckpt), "--max_frames", "16", *weights])
    check(f"Resumed tracker state from {ckpt}" in text
          and "Processed 16 frames" in text, "the resumed run")
    check_launches(resumed, 16 // CHUNK + WARM_UP_ITERS, "cli --resume")
    text, strong = run(["--input", str(clip), "--no_save", "--tracker",
                        "strongsort", "--max_frames", "16", *weights])
    check("Processed 16 frames" in text, "the strongsort run")
    check_launches(strong, 16 // CHUNK + WARM_UP_ITERS,
                   "cli --tracker strongsort")
    print(f"[cli] {n} frames through aicamera_tpu_torch.cli on the card: "
          f"{avg} tracks per frame, checkpoint with next_id "
          f"{int(state.next_id)} written and resumed for 16 frames; "
          f"--tracker strongsort (default --gmc affine) for 16 frames; "
          f"launches {launches}, {resumed} and {strong} (one per chunk, "
          f"{WARM_UP_ITERS} warm-up chunks each)")

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
    check_launches(saved, n // CHUNK + WARM_UP_ITERS, "cli (saving)")
    nosave_text, nosave = run(["--input", str(avi_in), "--no_save",
                               *weights])
    check_launches(nosave, n // CHUNK + WARM_UP_ITERS, "cli (.avi, no save)")
    native_text, native = run(["--input", str(avi_in), "--no_save",
                               "--native_io", *weights])
    check("Using native C++ video decoder" in native_text
          and f"Processed {n} frames" in native_text, "the --native_io run")
    check_launches(native, n // CHUNK + WARM_UP_ITERS, "cli --native_io")
    PRESENT.update(input=avi_in, output=avi_out, calls=calls, n=n,
                   saved=cli_fps(saved_text), nosave=cli_fps(nosave_text),
                   native=cli_fps(native_text), launches=saved)
    print(f"[cli] MJPEG .avi input (the port's VideoWriter): the default "
          f"saved run with --draw_detections --profile wrote {n} frames, "
          f"no presentation error, launches {saved}; --no_save launches "
          f"{nosave}; --native_io launches {native} (one per chunk, "
          f"{WARM_UP_ITERS} warm-up chunks each)")
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


def streams_phase(device, kernels):
    """``MultiStreamPipeline`` at BASELINE config 4's width: 8 streams of
    720p, chunk 4, DeepSORT defaults; then its checks."""
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

    def run(timer=None):
        for i in range(s):
            pipe.reset_stream(i)
        pipe.scan_stats.update(dict.fromkeys(pipe.scan_stats, 0))
        pipe.stage_timer = timer
        reset_counts(kernels)
        t0 = time.perf_counter()
        outs = [tuple(x.cpu() for x in pipe.step_chunk(c)) for c in chunks]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pipe.stage_timer = None
        return (outs, wall, {kn.name: kn.launches for kn in kernels},
                {n: c.count for n, c in sync_counters().items()})

    run()  # captures the scans of whichever capacities the chunks take
    outs, wall, launches, syncs = run()
    check_launches(launches, d, "streams (one launch per dispatch)")
    check(syncs["tracker"] == 0, f"streams: the DeepSORT steps read the GPU "
          f"{syncs['tracker']} times")
    tuples = [stream_tuples(outs, si) for si in range(s)]
    n_tracks = [sum(map(len, t)) for t in tuples]
    check(all(n > 0 for n in n_tracks), f"a stream emitted no track: "
          f"{n_tracks}")
    check(all(np.isfinite(t[:4]).all() and np.isfinite(t[6])
              for ts in tuples for f in ts for t in f), "non-finite track")
    timer = CudaStageTimer()
    again = run(timer)[0]
    stage_ms = {st: v / timer.chunks for st, v in timer.totals.items()}
    same = all(stream_tuples(again, si) == tuples[si] for si in range(s))
    n_sf = s * k * d
    print(f"[streams] {s} streams x {d} dispatches of {k} frames: "
          f"{n_sf / wall:.2f} stream-frames/s, {wall / d * 1e3:.2f} ms per "
          f"dispatch (after warm-up, bf16, scan_bucket {pipe.scan_bucket}: "
          f"chunks {pipe.scan_stats}); launches {launches} ({d} dispatches)")
    print(f"[streams] per-dispatch stage ms (CUDA events): "
          + ", ".join(f"{st} {v:.3f}" for st, v in stage_ms.items())
          + f"; tracker per stream-frame {stage_ms['tracker'] / (s * k):.3f}"
          f" ms; timed rerun identical: {same}")
    print(f"[streams] host syncs per stream-frame: {syncs_line(syncs, n_sf)};"
          f" track outputs per stream {n_tracks}")

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
    for name in ("deepsort", "bytetrack", "strongsort"):
        kw = dict(tracker=name)
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
    strong.step_chunk(chunks[0])  # FFT plans, cuDNN
    timer = CudaStageTimer()
    strong.stage_timer = timer
    t0 = time.perf_counter()
    for c in chunks[1:]:
        strong.step_chunk(c)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    strong.stage_timer = None
    g_ms = {st: v / timer.chunks for st, v in timer.totals.items()}
    print(f"[streams] strongsort (gmc {strong.gmc_method}), {s} streams, "
          f"{d - 1} dispatches: {s * k * (d - 1) / wall:.2f} stream-frames/s;"
          f" per dispatch gmc {g_ms['gmc']:.3f} ms (all {s} streams in one "
          f"batched estimate), tracker {g_ms['tracker']:.3f} ms")
    return launches


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
    single = {kn.name: kn.launches for kn in kernels}
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
          f"pipeline); launches {single}; vs process_frames: {total} tuples, "
          f"{exact} bitwise identical")

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
        multi = {kn.name: kn.launches for kn in kernels}
        stats = {n: v - stats0[n] for n, v in mt.stats.items()}
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
          f"{stats}; launches {multi}")
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
    from aicamera_tpu_torch.ops.nms import _greedy_keep
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
                    det.conf_threshold, det.nms_threshold, False)),
                ("detect_tiled", teng, tiled_step(
                    det.model, det._dtype, FRAME_HW, det.input_shape, (2, 2),
                    0.2, True, "iou", det.conf_threshold, det.nms_threshold,
                    False)))
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
                  f"(early-exit NMS) on {len(up)} frames: counts and labels "
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
                        det.conf_threshold, det.nms_threshold, False)
    fixed = detect_step(det.model, det._dtype, det._spec(FRAME_HW),
                        det.conf_threshold, det.nms_threshold, True)
    cap = graph_of(eng)
    with torch.no_grad():
        t_eager = wall_ms(lambda: eager(up[0]))
        t_fixed = wall_ms(lambda: fixed(up[0]))
    t_call = wall_ms(lambda: eng(up[0]))
    t_host_call = wall_ms(lambda: eng(torch.from_numpy(frames[0])))
    t_detect = wall_ms(lambda: det.detect(frames[0]))
    t_replay = time_ms(cap.graph.replay, iters=ENGINE_TIMED)
    t_copies = time_ms(lambda: [o.clone() for o in cap.outputs], iters=200)
    h_copies = time_host_ms(lambda: [o.clone() for o in cap.outputs])
    cost = eng.cost_analysis()
    bound = max(cost["flops"] / PEAK_BF16_FLOPS,
                cost["bytes accessed"] / PEAK_BYTES_PER_S) * 1e3
    # the fixed-K greedy keep alone, at the detect step's top_k=300
    g = torch.Generator(device=device).manual_seed(SEED)
    k = config.YOLO_NMS_TOPK
    ov = torch.rand((1, k, k), device=device, generator=g) < 0.02
    ov = ov | ov.transpose(1, 2)
    va = torch.ones((1, k), dtype=torch.bool, device=device)
    nms_eng = CUDAGraphEngine(lambda o, v: _greedy_keep(o, v, True),
                              [ov, va], name="greedy_keep_fixed",
                              warmup_iters=1, device=device)
    check(torch.equal(nms_eng(ov, va), _greedy_keep(ov, va)),
          "[engine] fixed-K greedy keep != the early-exit keep")
    t_nms = time_ms(graph_of(nms_eng).graph.replay, iters=ENGINE_TIMED)
    t_nms_eager = wall_ms(lambda: _greedy_keep(ov, va))
    print(f"[engine] bf16 detect at K=1 (960x540): eager step "
          f"{t_eager:.3f} ms (early-exit NMS, reads), eager with fixed-K NMS "
          f"{t_fixed:.3f} ms; engine call {t_call:.3f} ms from a device "
          f"frame, {t_host_call:.3f} ms from a host frame; facade detect() "
          f"{t_detect:.3f} ms (upload, replay, four reads); replay alone "
          f"{t_replay:.3f} ms on the device ({cap.nodes} graph nodes); "
          f"output copies {t_copies:.4f} ms device, {h_copies:.4f} ms host; "
          f"capture {eng.compile_seconds:.3f} s, warm-up "
          f"{eng.warmup_seconds:.3f} s")
    print(f"[engine] device_cost of the detect step: {cost['flops']:.4g} "
          f"FLOPs, {cost['bytes accessed']:.4g} bytes (letterbox included): "
          f"bound {bound:.4f} ms against the replay's {t_replay:.3f} ms")
    print(f"[engine] fixed-K greedy keep alone (K={k}, 1 frame): replay "
          f"{t_nms:.3f} ms ({graph_of(nms_eng).nodes} graph nodes); the "
          f"early-exit keep {t_nms_eager:.3f} ms wall with its reads")

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
    try:
        CUDAGraphEngine(eager, [up[0]], name="reads", warmup_iters=1,
                        device=device)
        check(False, "[engine] capturing the eager step (it reads the GPU) "
              "did not raise")
    except RuntimeError as e:
        check("capture failed" in str(e), f"[engine] unexpected error {e}")
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(eng(up[0]), eng(up[0]))),
          "[engine] the engine after a failed capture")
    print("[engine] capturing the eager step (its NMS reads the GPU) raised "
          "RuntimeError; the card kept working")
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
            check_launches(counts, MOT_FRAMES // CHUNK,
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
    check(a["launches"] == d and a["batches"] == [(s * k, *STREAM_HW, 3)] * d,
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
        check(st["launches"] == d
              and st["batches"] == [parallel_shape()[2:3]
                                    + (*STREAM_HW, 3)] * d,
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
                         "phase (main, bucket, trackers, gmc, facades, "
                         "engine, cli, present, compare, streams, serving, "
                         "server, quality, int8, mot, train, parallel); "
                         "default all")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from aicamera_tpu_torch.ops.assignment import KERNEL as ASSIGNMENT
    from aicamera_tpu_torch.ops.letterbox import KERNEL as LETTERBOX
    from aicamera_tpu_torch.scenes import moving_rectangles

    kernels = [LETTERBOX, ASSIGNMENT]
    t_start = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        ident = gpu_identity()
        print(f"[gpu] {ident}")
        print(f"[gpu] torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"python {sys.version.split()[0]}")
        build_s = build_kernels(kernels)
        print(f"[build] {len(kernels)} kernel(s) built in {build_s:.2f} s")
        device = torch.device("cuda")
        phase_s = {}

        def timed(name, fn, *a):
            t0 = time.perf_counter()
            out = fn(*a)
            phase_s[name] = time.perf_counter() - t0
            return out

        records = [timed("kernel", kernel_phase, device),
                   timed("assignment", assignment_phase, device)]
        if args.kernels_only:
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
        run("streams", streams_phase, device, kernels)
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
    for record in records:
        name = record["name"]
        record["launches"] = by_path.get("main", {}).get(name)
        record["launches_by_path"] = {
            path: (counts if path in ("train", "parallel") else
                   {t: v[name] for t, v in counts.items()}
                   if path in ("trackers", "gmc", "facades", "engine",
                               "quality", "int8")
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
