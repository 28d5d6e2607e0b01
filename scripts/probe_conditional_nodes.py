"""The branch helper (``runtime/branches.py``, ``csrc/branches.cu``) on the
card, apart from the pipeline.

Run on a GPU host: ``python3 scripts/probe_conditional_nodes.py``. It
prints the versions and whether this PyTorch's ``CUDAGraph`` has IF-node
capture methods of its own (the helper does not need them), builds
``csrc/branches.cu``, then captures with ``runtime.engine.CUDAGraphEngine``
a step whose seven-way switch has bodies holding a convolution (cuDNN), a
matmul (cuBLAS), an FFT (cuFFT), allocations and in-place writes, followed
by a cond, and checks a replay at several indexes against the same bodies
run eagerly (bitwise); checks that a carried input stays in the graph from
one replay to the next; that a body which reads the GPU makes the capture
raise, and that a capture after it works; prints the graph's nodes, the
capture seconds, the launches counted by branch, and the replay time with
every body skipped against one taken. Then the pipeline's ReID forward
(f32 with TF32 off, and bf16) with cuDNN's heuristics (``cudnn.benchmark``
off, as the pipeline runs it) at every crop batch the paths give it, a
frame count times a ReID bucket: each captured alone (a plain
``torch.cuda.graph``; where that fails, again in the relaxed capture mode)
and as a cond's body (where that fails, again with deterministic
algorithms only), its replay against the eager forward bitwise. Exits 1 if
a check fails.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

FAILED = []


def check(ok, what):
    print(f"[cond] {'ok' if ok else 'FAILED'}: {what}", flush=True)
    if not ok:
        FAILED.append(what)


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    from aicamera_tpu_torch.ops import cuda_build
    from aicamera_tpu_torch.runtime import branches
    from aicamera_tpu_torch.runtime.engine import CUDAGraphEngine
    from aicamera_tpu_torch.syncs import SyncCounter
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    G = torch.cuda.CUDAGraph
    print("[cond] CUDAGraph.begin_capture_to_if_node: "
          f"{hasattr(G, 'begin_capture_to_if_node')}", flush=True)
    t0 = time.perf_counter()
    lib, out = cuda_build.build(cuda_build.CSRC_DIR / "branches.cu")
    print(f"[cond] built {lib.name} in {time.perf_counter() - t0:.1f} s\n"
          f"{out.strip()}", flush=True)
    dev = torch.device("cuda")
    torch.manual_seed(0)
    x = torch.randn(8, 16, 32, 32, device=dev)
    w = torch.randn(16, 16, 3, 3, device=dev)
    m = torch.randn(64, 64, device=dev)
    reads = SyncCounter()

    def work(out, j):
        y = F.conv2d(x, w, padding=1) * (j + 1)
        z = (m @ m)[j].sum() + torch.fft.rfft2(x).abs()[:, j].sum()
        out.copy_(y + z)

    def step(state, index):
        out = torch.zeros_like(x)
        branches.switch(index, [None] + [
            (lambda j=j: work(out, j)) for j in range(1, 7)],
            counter=reads, site="seven")
        flag = out.sum() > 0
        extra = torch.zeros((), device=dev)
        branches.cond(flag, lambda: extra.fill_(1.0),
                      lambda: extra.fill_(-1.0), counter=reads,
                      site="sign")
        return state + 1, out, extra

    state = torch.zeros((), device=dev)
    index = torch.zeros((), dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    eng = CUDAGraphEngine(step, [state, index], name="probe", carry=1,
                          warmup_iters=1, device=dev)
    print(f"[cond] engine made in {time.perf_counter() - t0:.3f} s "
          f"(capture {eng.compile_seconds:.3f} s, warm-up "
          f"{eng.warmup_seconds:.3f} s), {eng.graph_nodes(state, index)} "
          f"nodes; bodies' nodes {eng.branch_sites()}", flush=True)
    st = state
    for n, j in enumerate((0, 3, 6, 1)):
        index.fill_(j)
        st, out, extra = eng(st, index)
        want = torch.zeros_like(x)
        if j:
            work(want, j)
        torch.cuda.synchronize()
        check(torch.equal(out, want), f"switch replay, index {j}")
        check(float(extra) == (1.0 if float(want.sum()) > 0 else -1.0),
              f"cond after it, index {j}")
        check(float(st) == n + 1, f"carried state {float(st)} after "
              f"{n + 1} replays")
    check(reads.count == 0, f"{reads.count} reads on the card")

    def reading(index):
        out = torch.zeros((), device=dev)
        branches.cond(index > 0, lambda: out.fill_(float(index.sum())),
                      counter=reads, site="reads")
        return out

    raised = None
    try:
        CUDAGraphEngine(reading, [index], name="reading", warmup_iters=1,
                        device=dev)
    except RuntimeError as e:
        raised = str(e).splitlines()[0][:200]
    check(raised is not None, f"a reading body raises ({raised})")
    again = CUDAGraphEngine(step, [state, index], name="again", carry=1,
                            warmup_iters=1, device=dev)
    index.fill_(2)
    st2, out, _ = again(state.clone(), index)
    want = torch.zeros_like(x)
    work(want, 2)
    check(torch.equal(out, want), "a capture after the failed one")

    # replay time: every body skipped vs one taken (index 0 has no body)
    for j, label in ((0, "every body skipped"), (4, "one body taken")):
        index.fill_(j)
        for _ in range(5):
            st, _, _ = eng(st, index)
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(100):
            st, _, _ = eng(st, index)
        e1.record()
        e1.synchronize()
        print(f"[cond] {label}: {e0.elapsed_time(e1) / 100:.5f} ms a "
              f"replay (host-bound calls)", flush=True)
    reid_in_bodies(dev, reads)
    return 1 if FAILED else 0


# frames in a ReID batch (K of the main path and the tests, S x K of the
# stream stacks) and the ReID buckets (crops a frame)
REID_FRAMES = (1, 2, 4, 6, 8, 16, 32)
REID_BUCKETS = (4, 8, 12, 16, 24, 32)


def reid_in_bodies(dev, reads):
    """The ReID forward as a cond's body at every crop batch, heuristics'
    plans: a plain capture (global and relaxed capture modes) and a body
    capture per batch and dtype, each replay bitwise the eager forward; a
    body that fails is tried again with deterministic algorithms only."""
    from aicamera_tpu_torch import config
    from aicamera_tpu_torch.runtime import branches
    from aicamera_tpu_torch.runtime.engine import CUDAGraphEngine
    from aicamera_tpu_torch.runtime.pipeline import TrackingPipeline, precision
    assert not torch.backends.cudnn.benchmark
    batches = sorted({f * b for f in REID_FRAMES for b in REID_BUCKETS})
    h, w = config.REID_INPUT_SHAPE
    cudnn = torch.backends.cudnn
    for name in ("f32", "bf16"):
        pipe = TrackingPipeline(
            yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
            reid_weights=str(config.REID_SYNTHETIC_PATH), reid_dtype=name,
            device=dev)
        reid, dtype = pipe.reid, pipe.reid_dtype
        failed = []
        for n in batches:
            gen = torch.Generator(device=dev).manual_seed(n)
            crops = torch.rand((n, h, w, 3), generator=gen, device=dev,
                               dtype=torch.float32).to(dtype)
            with torch.no_grad(), precision(dtype):
                want = reid(crops)
            torch.cuda.synchronize()

            def attempt(run):
                try:
                    got = run()
                    torch.cuda.synchronize()
                    return "ok" if torch.equal(got, want) else "differs"
                except RuntimeError as e:
                    return str(e).splitlines()[0][:160]

            def plain(mode):
                graph = torch.cuda.CUDAGraph()
                here = torch.cuda.current_stream()
                try:
                    with torch.no_grad(), precision(dtype), \
                            torch.cuda.graph(graph, capture_error_mode=mode):
                        got = reid(crops)
                finally:
                    # a failed capture leaves its stream current
                    torch.cuda.set_stream(here)
                graph.replay()
                return got

            def step(x, flag):
                out = torch.zeros_like(want)

                def body():
                    with precision(dtype):
                        out.copy_(reid(x))
                branches.cond(flag, body, counter=reads, site="reid")
                return out

            flag = torch.ones((), dtype=torch.bool, device=dev)

            def in_body(tag=""):
                eng = CUDAGraphEngine(step, [crops, flag],
                                      name=f"reid {name} {n}{tag}",
                                      warmup_iters=1, device=dev)
                return eng(crops, flag)

            ways = {"plain": attempt(lambda: plain("global"))}
            if ways["plain"] != "ok":
                ways["plain, relaxed"] = attempt(lambda: plain("relaxed"))
            ways["body"] = attempt(in_body)
            if ways["body"] != "ok":
                cudnn.deterministic = True
                try:
                    ways["body, deterministic"] = attempt(
                        lambda: in_body(" det"))
                finally:
                    cudnn.deterministic = False
            if ways != {"plain": "ok", "body": "ok"}:
                failed.append(n)
                print(f"[cond] reid {name} batch {n}: {ways}", flush=True)
        check(not failed, f"reid {name}, cuDNN heuristics: plain captures and "
              f"cond bodies bitwise the eager forward at {len(batches)} "
              f"batches {batches[0]}-{batches[-1]} (failed at {failed})")


if __name__ == "__main__":
    sys.exit(main())
