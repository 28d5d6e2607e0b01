#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``aicamera_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA GPU, the CUDA toolkit (``nvcc``) and the repository around
this file; exits non-zero otherwise. In order it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every kernel of the main path from ``aicamera_tpu_torch/csrc``;
3. holds each kernel, called through the public wrapper the pipeline calls,
   against its plain PyTorch version on the card, bitwise, at the main
   path's geometries and more, and times kernel, plain version,
   the nearest single PyTorch call, and the byte/operation bound;
4. drives the main path at full width: ``TrackingPipeline(device="cuda")``
   with YOLOv8n at 640x640, T=128 track slots, N=64 detection slots, a
   100-feature gallery of 512-d features and 32 ReID crops, on seeded
   960x540 frames of moving rectangles, ``chunk_size=8``,
   ``synthetic_load=24``; checks the kernel launch counts, confirmed tracks
   and finite outputs; prints FPS, per-stage times (CUDA events) and the GPU
   busy share of one more chunk under ``torch.profiler``;
5. runs the first chunks through the card in f32 (TF32 off) and through the
   plain CPU path, and compares detections and track tuples.

The last two lines of output are the kernels' JSON record and the device
JSON record.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

N_CHUNKS = 8          # main-path chunks (the first two are also compared)
CHUNK = 8
FRAME_HW = (540, 960)
COMPARE_CHUNKS = 2
SEED = 0
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12       # H100 SXM, f32 outside the tensor cores

KERNEL_GEOMETRIES = [  # (src_hw, dst_hw, auto)
    ((540, 960), (640, 640), False),
    ((720, 1280), (640, 640), False),
    ((1080, 1920), (640, 640), False),
    ((640, 640), (640, 640), False),
    ((240, 320), (640, 640), False),
    ((540, 960), (640, 640), True),
]


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


def build_kernels(kernels):
    """Build every kernel's source with nvcc and load it."""
    from aicamera_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    for k in kernels:
        lib, log = cuda_build.build(k.source)
        print(f"[build] {k.name}: {lib.name}")
        for ln in log.splitlines():
            if "ptxas" in ln:
                print(f"[build]   {ln.strip()}")
    for k in kernels:
        k.load()  # finds the library just built
    return time.perf_counter() - t0


def kernel_phase(device):
    """Letterbox kernel vs its plain version on the card, bitwise."""
    import torch
    import torch.nn.functional as F
    from aicamera_tpu_torch.ops import letterbox as lb
    from aicamera_tpu_torch.ops.preprocess import letterbox_spec

    gen = torch.Generator(device=device).manual_seed(SEED)
    max_err = 0.0
    n_checked = 0
    for src, dst, auto in KERNEL_GEOMETRIES:
        spec = letterbox_spec(src, dst, auto=auto)
        for k in (1, 8):
            frames = torch.randint(0, 256, (k, *src, 3), dtype=torch.uint8,
                                   device=device, generator=gen)
            for dt in (torch.float32, torch.bfloat16):
                before = lb.KERNEL.launches
                out = lb.letterbox(frames, spec, dt)  # the pipeline's call
                check(lb.KERNEL.launches == before + 1,
                      "letterbox() on a CUDA tensor did not launch the "
                      "kernel")
                ref = lb.letterbox_plain(frames, spec, dt)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                max_err = max(max_err, err)
                check(out.shape == ref.shape == (k, 3, *spec.out_hw),
                      f"letterbox shape {tuple(out.shape)}")
                check(torch.equal(out, ref),
                      f"letterbox kernel != plain version: {src}->"
                      f"{spec.out_hw} K={k} {dt}: max |err| {err}")
                n_checked += 1
    print(f"[kernel] letterbox: bitwise equal to the plain version on "
          f"{n_checked} cases (6 geometries x K in (1, 8) x f32/bf16)")

    # timing at the main path's shape: 960x540 -> 640x640, K=8, bf16
    spec = letterbox_spec(FRAME_HW, (640, 640))
    frames = torch.randint(0, 256, (CHUNK, *FRAME_HW, 3), dtype=torch.uint8,
                           device=device, generator=gen)
    dt = torch.bfloat16
    ms = time_ms(lambda: lb.letterbox(frames, spec, dt))
    plain_ms = time_ms(lambda: lb.letterbox_plain(frames, spec, dt),
                       iters=10)
    nchw = frames.permute(0, 3, 1, 2).float().contiguous()
    library_ms = time_ms(lambda: F.interpolate(
        nchw, size=spec.unpad_hw, mode="bilinear", align_corners=False))
    in_bytes = frames.numel()
    out_bytes = CHUNK * 3 * spec.out_hw[0] * spec.out_hw[1] * 2
    content = CHUNK * 3 * spec.unpad_hw[0] * spec.unpad_hw[1]
    pad = CHUNK * 3 * spec.out_hw[0] * spec.out_hw[1] - content
    ops = content * 11 + pad  # 6 mul + 3 add + round/clip/div; pad: 1
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    lb.KERNEL.launches = 0  # comparison and timing launches do not count
    print(f"[kernel] letterbox 960x540->640x640 K={CHUNK} bf16: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, F.interpolate "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({in_bytes + out_bytes} bytes, {ops} ops)")
    return {"name": "letterbox", "route": "cuda",
            "source": "aicamera_tpu_torch/csrc/letterbox.cu",
            "replaces": lb.KERNEL.replaces, "launches": None,
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def make_pipeline(device, **kw):
    from aicamera_tpu_torch import config
    from aicamera_tpu_torch.runtime.pipeline import TrackingPipeline
    return TrackingPipeline(
        yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
        reid_weights=str(config.REID_SYNTHETIC_PATH),
        chunk_size=CHUNK, synthetic_load=24, device=device, **kw)


def main_path_phase(device, frames, kernels):
    """The full-width main path on the card, with launch counts."""
    import numpy as np
    import torch
    from aicamera_tpu_torch.core.assignment import TRACKER_SYNCS
    from aicamera_tpu_torch.ops.nms import NMS_SYNCS
    from aicamera_tpu_torch.runtime.pipeline import EMBED_SYNCS, StageTimer

    pipe = make_pipeline(device)
    warm_s = pipe.warm_up(FRAME_HW)
    print(f"[main] warm-up {warm_s:.2f} s")
    # the counted run: every count at 0 just before, read just after
    counters = (NMS_SYNCS, EMBED_SYNCS, TRACKER_SYNCS)
    for k in kernels:
        k.launches = 0
    for c in counters:
        c.count = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = list(pipe.process_frames(iter(frames)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    syncs = [c.count for c in counters]

    n = len(frames)
    check(len(results) == n, f"{len(results)} results for {n} frames")
    check([r.frame_index for r in results] == list(range(n)),
          "results out of order")
    for k in kernels:
        check(launches[k.name] == N_CHUNKS,
              f"{k.name} launched {launches[k.name]} times over "
              f"{N_CHUNKS} chunks")
    n_init = pipe.tracker_params.n_init
    for r in results:
        check(np.isfinite(r.det_boxes).all() and np.isfinite(
            r.det_scores).all(), f"non-finite detections at {r.frame_index}")
        check(all(np.isfinite(t[6]) for t in r.tracks),
              f"non-finite track conf at {r.frame_index}")
        if r.frame_index >= n_init - 1:
            check(len(r.tracks) > 0, f"no confirmed track at frame "
                  f"{r.frame_index} (n_init={n_init})")
    n_tracks = sum(len(r.tracks) for r in results)
    n_dets = sum(len(r.det_boxes) for r in results)
    ids = {t[4] for r in results for t in r.tracks}
    print(f"[main] {n} frames in {wall:.3f} s: {n / wall:.2f} FPS "
          f"(chunk {CHUNK}, {N_CHUNKS} chunks, after warm-up)")
    print(f"[main] detections {n_dets}, track outputs {n_tracks}, distinct "
          f"confirmed ids {len(ids)}; launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items())
          + " (one per chunk)")
    print(f"[main] host syncs per frame: NMS {syncs[0] / n:.2f}, ReID "
          f"bucket {syncs[1] / n:.3f}, tracker {syncs[2] / n:.2f} (plus one "
          f"result read per chunk)")
    print("[main] sample tracks, last frame: "
          + repr(results[-1].tracks[:4]))

    # the same frames again with CUDA events at every stage boundary
    pipe.reset()
    timer = StageTimer()
    pipe.stage_timer = timer
    again = list(pipe.process_frames(iter(frames)))
    stage_ms = {s: v / timer.chunks for s, v in timer.totals.items()}
    print("[main] per-chunk stage ms (CUDA events, includes the host "
          "launch gaps): " + ", ".join(f"{s} {v:.3f}"
                                       for s, v in stage_ms.items())
          + f"; tracker per frame {stage_ms['tracker'] / CHUNK:.3f} ms")
    same = sum(a.tracks == b.tracks for a, b in zip(results, again))
    print(f"[main] timed rerun: {same}/{n} frames with identical tracks")
    pipe.stage_timer = None
    profile_chunk(pipe, frames[-CHUNK:])
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


def compare_phase(frames):
    """First chunks on the card in f32 (TF32 off) vs the plain CPU path."""
    import numpy as np
    sub = frames[:COMPARE_CHUNKS * CHUNK]
    gpu = list(make_pipeline("cuda", detect_dtype="f32",
                             reid_dtype="f32").process_frames(iter(sub)))
    cpu = list(make_pipeline("cpu").process_frames(iter(sub)))
    box_err = 0.0
    exact = total = 0
    for g, c in zip(gpu, cpu, strict=True):
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
    print(f"[compare] {len(sub)} frames, card f32 (TF32 off) vs CPU: "
          f"detection counts and labels identical, max box |diff| "
          f"{box_err:.3g} px (tolerance 1e-2); track tuples: ids, classes "
          f"and boxes identical on {total}, {exact} bitwise identical "
          f"including conf (conf tolerance 1e-4)")


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
    sys.path.insert(0, str(ROOT))
    from aicamera_tpu_torch.ops.letterbox import KERNEL as LETTERBOX
    from aicamera_tpu_torch.scenes import moving_rectangles

    kernels = [LETTERBOX]
    try:
        ident = gpu_identity()
        print(f"[gpu] {ident}")
        print(f"[gpu] torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"python {sys.version.split()[0]}")
        build_s = build_kernels(kernels)
        print(f"[build] {len(kernels)} kernel(s) built in {build_s:.2f} s")
        record = kernel_phase(torch.device("cuda"))
        frames = moving_rectangles(N_CHUNKS * CHUNK, FRAME_HW, n_objects=6,
                                   seed=SEED)
        launches = main_path_phase(torch.device("cuda"), frames, kernels)
        compare_phase(frames)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    record["launches"] = launches[record["name"]]
    print(ident)  # name, power limit: as nvidia-smi prints them
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
