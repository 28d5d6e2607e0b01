#!/usr/bin/env python3
"""Where the letterbox kernel's time goes on the GPU: timed variants of
``aicamera_tpu_torch/csrc/letterbox.cu``'s vector variant.

    python3 scripts/probe_letterbox_kernel.py

Needs one CUDA GPU and ``nvcc``. From the committed source it derives, by
text substitution, builds that leave work out, and times each the way
``chip_smoke.py`` times the kernel (``device_ms``: a CUDA-graph replay over
buffer sets larger than the L2), at the three timed shapes:

- ``full``: the kernel as committed;
- ``memory only``: the band is staged and every row stores the pad value
  (all the loads and stores, no arithmetic);
- ``arithmetic only``: nothing is staged, rows are blended from whatever
  shared memory holds (all the arithmetic and stores, no loads);
- ``full``, with the registers per thread capped by asking for 3 and 4
  blocks of 320 threads per SM in place of 2 (ptxas reports the spills);
- ``blend buffer``: another design, ``scripts/probe_letterbox_blend.cu``:
  the vertical blend computed once per source byte and kept in shared
  memory as f32, where the committed kernel recomputes it at every tap.

The outputs of the builds that leave work out are wrong by construction and
are not compared; the blend buffer's is held bitwise against the committed
kernel's.

Last it splits the host time of one ``letterbox()`` call on a CUDA tensor
into its pieces (argument checks, the output's allocation, the current
stream, the launch), each timed with no device sync in between.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

STAGING = """    for (int i = tid; i < n16; i += nthreads) {
      cp_async_16(dst + i, src + i);
    }
"""
PAD_TEST = "    if (y0 < 0 || inside == 0) {\n"
BOUNDS = "__launch_bounds__(kMaxThreads, 2)"

# name -> [(text in the committed source, its replacement)], or the entry
# point of scripts/probe_letterbox_blend.cu
BLEND = "aicam_letterbox_tile_blend"
VARIANTS = {
    "full": [],
    "memory only": [(PAD_TEST, "    if (true) {\n")],
    "arithmetic only": [(STAGING, "    (void)src; (void)dst; (void)n16;\n")],
    "full, 3 blocks/SM": [(BOUNDS, "__launch_bounds__(kMaxThreads, 3)")],
    "full, 4 blocks/SM": [(BOUNDS, "__launch_bounds__(kMaxThreads, 4)")],
    "blend buffer": BLEND,
}


def build(name, edits):
    from aicamera_tpu_torch.ops import cuda_build
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = "probe_" + "".join(c if c.isalnum() else "_" for c in name)
    lib = cuda_build.BUILD_DIR / f"lib{stem}.so"
    if edits == BLEND:
        cu = Path(__file__).with_name("probe_letterbox_blend.cu")
        symbol = BLEND
    else:
        source = (cuda_build.CSRC_DIR / "letterbox.cu").read_text()
        for old, new in edits:
            if source.count(old) != 1:
                raise SystemExit(f"probe '{name}': the source no longer "
                                 f"holds exactly one {old!r}")
            source = source.replace(old, new)
        cu = cuda_build.BUILD_DIR / f"{stem}.cu"
        cu.write_text(source)
        symbol = "aicam_letterbox_tile"
    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                           "-I", str(cuda_build.CSRC_DIR), "-o", str(lib),
                           str(cu)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {name}:\n{proc.stdout}")
    # ptxas names a kernel ("Compiling entry function"), then its resources
    kernel = ("letterbox_blend_kernel" if edits == BLEND
              else "letterbox_tile_kernel")
    used, current = [], ""
    for ln in proc.stdout.splitlines():
        if "Compiling entry function" in ln:
            current = ln
        elif ("Used" in ln or "spill" in ln) and kernel in current:
            used.append(ln)
    used = sorted({ln.split(":", 1)[-1].strip() for ln in used})
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 14
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, used


def main() -> int:
    import torch
    import chip_smoke
    from aicamera_tpu_torch.ops import letterbox as lb
    from aicamera_tpu_torch.ops.preprocess import letterbox_spec

    if not torch.cuda.is_available():
        print("probe_letterbox_kernel: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=device).manual_seed(0)
    print(chip_smoke.gpu_identity())
    tables = {}  # spec -> (tab_i, tab_w on the device, rounding flag)

    def device_tables(spec):
        if spec not in tables:
            tab_i, tab_w, resize = lb.tile_tables(spec)
            tables[spec] = (torch.from_numpy(tab_i).to(device),
                            torch.from_numpy(tab_w).to(device), int(resize))
        return tables[spec]

    for name, edits in VARIANTS.items():
        fn, used = build(name, edits)
        print(f"{name}: ptxas {'; '.join(used)}")

        def call(frames, spec, dt, fn=fn):
            k, h, w, _ = frames.shape
            plan = lb.launch_plan(spec, k, dt)
            tab_i, tab_w, resize = device_tables(spec)
            out = torch.empty((k, 3, *spec.out_hw), dtype=dt, device=device)
            err = fn(frames.data_ptr(), out.data_ptr(), tab_i.data_ptr(),
                     tab_w.data_ptr(), k, h, w, *spec.out_hw, *spec.unpad_hw,
                     spec.top, spec.left, resize, int(dt == torch.bfloat16),
                     plan.rows, plan.block[1], plan.smem_bytes,
                     torch.cuda.current_stream(device).cuda_stream)
            if err:
                raise SystemExit(f"{name}: CUDA error {err}")
            return out

        for src, dt in chip_smoke.bench_shapes():
            if edits == BLEND:
                spec = letterbox_spec(src, (640, 640))
                frames = torch.randint(0, 256, (2, *src, 3), device=device,
                                       dtype=torch.uint8, generator=gen)
                if not torch.equal(call(frames, spec, dt),
                                   lb.letterbox(frames, spec, dt)):
                    raise SystemExit(f"{name}: differs from the committed "
                                     f"kernel at {src} {dt}")
            r = chip_smoke.measure_letterbox(call, src, dt, device, gen)
            print(f"  {r['shape']}: device {r['device_ms']:.4f} ms "
                  f"(bound {r['bound_ms']:.4f} ms)", flush=True)
    host_pieces(device)
    return 0


def host_pieces(device):
    """Host microseconds of the wrapper's steps at the main path's shape
    (twice: a process's first calls run slower)."""
    import torch
    from chip_smoke import CHUNK, FRAME_HW, time_host_ms
    from aicamera_tpu_torch.ops import letterbox as lb
    from aicamera_tpu_torch.ops.preprocess import letterbox_spec

    spec = letterbox_spec(FRAME_HW, (640, 640))
    frames = torch.zeros((CHUNK, *FRAME_HW, 3), dtype=torch.uint8,
                         device=device)
    dt = torch.bfloat16
    shape = (CHUNK, 3, *spec.out_hw)
    pieces = {
        "letterbox()": lambda: lb.letterbox(frames, spec, dt),
        "KERNEL.launch": lambda: lb.KERNEL.launch(frames, spec, dt),
        "check_args": lambda: lb.check_args(frames, spec, dt),
        "torch.empty": lambda: torch.empty(shape, dtype=dt, device=device),
        "torch.cuda.current_stream": lambda: torch.cuda.current_stream(
            device).cuda_stream,
        "raw stream getter": lambda: lb._current_stream(device),
    }
    for rep in (1, 2):
        print(f"host us per call, pass {rep}: " + ", ".join(
            f"{name} {time_host_ms(fn) * 1e3:.2f}"
            for name, fn in pieces.items()), flush=True)


if __name__ == "__main__":
    sys.exit(main())
