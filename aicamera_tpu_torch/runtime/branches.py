"""Data-dependent branches of a captured step: the JAX package's
``lax.switch`` and ``lax.cond`` as CUDA-graph conditional nodes.

:func:`switch` takes a 0-d integer tensor and a list of bodies, :func:`cond`
a 0-d bool and two. A body is a function of no arguments that writes its
results in place into tensors allocated before the call (never returns
them: the code after the branch reads those tensors, whichever body ran).
What happens depends on where the call runs:

- while ``runtime.engine.CUDAGraphEngine`` captures on the GPU: a small
  kernel reads the index on the device and sets the handle of the site's
  one SWITCH node (``csrc/branches.cu``); each body is captured into a
  graph of its own, on a thread and a stream kept for bodies (the body
  worker), and becomes a child graph of the node's body for its index. The
  host reads nothing, and every body is captured. A body that reads the
  GPU, or whose capture fails, raises, and so does the engine; the parent
  graph is left whole. Each body's hand-written kernel launches are
  recorded, so that the engine counts a replay's launches from the
  branches it took.
- on the CPU: the index is read (counted by ``counter``, as the port's
  other data-dependent reads are) and the one body runs. Inside
  :func:`every_body`, every other body runs first, then the chosen one: a
  body that writes only into buffers allocated before the branch gives the
  chosen body's results all the same (the tests' check of that rule).
- during the engine's eager warm-up passes on the GPU (:func:`warming`):
  every body runs, in order, without a read, on the body worker (kernels,
  cuDNN plans, cuBLAS's per-stream workspace and other caches are made
  before the capture, on the thread that captures them; the results are
  not used).
- anywhere else on the GPU: it raises. A step with branches runs on the
  card only as a capture (the eager step decides its branches with its own
  counted reads).

The helpers return the index taken where the host knows it (the CPU), else
``None``.

The same library holds the stage stamps of a captured step
(:func:`stamp`): a one-thread kernel that writes the device's clock into a
slot of a buffer, a node of the graph, and (:func:`aside`) a count of the
nodes that instrumentation adds to a capture, which the step's node count
leaves out.
"""

from __future__ import annotations

import contextlib
import ctypes
import queue
import threading
import time
from typing import Callable, Sequence

import torch

from ..ops import cuda_build

__all__ = ["KERNEL", "BranchKernel", "branch_plain", "cond", "switch",
           "every_body", "warming", "capturing", "BranchCapture", "stamp",
           "aside"]

_local = threading.local()


class BranchKernel:
    """Builds and loads ``csrc/branches.cu``: the kernel that sets a branch
    site's conditional handle from its index on the device, and the host
    calls that add the site's SWITCH node. ``launches`` counts the set kernel:
    one a site a capture records, so a replay counts one a site it ran."""

    name = "branch"
    source = cuda_build.CSRC_DIR / "branches.cu"
    replaces = ("aicamera_tpu/runtime/pipeline.py:629 lax.switch (the ReID "
                "bucket), :109 and :121 lax.cond (the bucketed scan); over "
                "streams aicamera_tpu/parallel/multistream.py:529, 624, 634")

    def __init__(self):
        self.launches = 0
        self._lib = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = cuda_build.load_library(self.source)
                ptr, i32 = ctypes.c_void_p, ctypes.c_int
                lib.aicam_branch_begin.argtypes = [ptr, i32, ptr, ptr]
                lib.aicam_branch_begin.restype = i32
                lib.aicam_branch_stream.argtypes = [i32,
                                                    ctypes.POINTER(ptr)]
                lib.aicam_branch_stream.restype = i32
                lib.aicam_branch_body_begin.argtypes = [ptr]
                lib.aicam_branch_body_begin.restype = i32
                lib.aicam_branch_body_end.argtypes = [
                    ptr, ptr, ctypes.POINTER(ctypes.c_ulonglong)]
                lib.aicam_branch_body_end.restype = i32
                lib.aicam_branch_error.argtypes = [i32]
                lib.aicam_branch_error.restype = ctypes.c_char_p
                lib.aicam_stamp_launch.argtypes = [ptr, ptr, i32]
                lib.aicam_stamp_launch.restype = i32
                lib.aicam_capture_nodes.argtypes = [
                    ptr, ctypes.POINTER(ctypes.c_ulonglong)]
                lib.aicam_capture_nodes.restype = i32
                self._lib = lib
            return self._lib


KERNEL = BranchKernel()


def branch_plain(index: torch.Tensor, n: int) -> int:
    """The plain version of a site's decision: the host reads the index
    (a read of the GPU) and names the body it takes, ``-1`` for none."""
    j = int(index)
    return j if 0 <= j < n else -1


def _check(err: int, what: str) -> None:
    if err != 0:
        name = KERNEL.load().aicam_branch_error(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({name})")


@contextlib.contextmanager
def every_body():
    """Inside (CPU only): every body of a branch runs, the chosen one
    last."""
    saved = getattr(_local, "every", False)
    _local.every = True
    try:
        yield
    finally:
        _local.every = saved


@contextlib.contextmanager
def warming(record: "BranchCapture"):
    """Inside: a branch on the GPU, outside a capture, runs every body in
    order without reading its index, on the stream its capture will use
    (the engine's warm-up passes)."""
    saved = getattr(_local, "warming", None)
    _local.warming = record
    try:
        yield
    finally:
        _local.warming = saved


class _BodyWorker:
    """The thread that runs the branch bodies on one device, in the warm-up
    passes and in their captures, one job at a time, on a stream of its own
    (the module's, made once: a stream from PyTorch's pool may be the one a
    parent capture runs on). PyTorch keeps a cuDNN handle a thread, and each
    convolution sets that handle's stream: on the capturing thread, the
    parent's convolutions (the detector's) and the bodies' (the ReID net's)
    would move one handle between two streams inside one capture, and some
    of cuDNN's f32 engines fail there (``CUDNN_STATUS_INTERNAL_ERROR`` in
    ``cudnnBackendExecute``). Here the bodies' handle only ever sees the
    body stream."""

    def __init__(self, index: int):
        handle = ctypes.c_void_p(0)
        _check(KERNEL.load().aicam_branch_stream(index, ctypes.byref(handle)),
               "creating the body stream")
        self.stream = torch.cuda.ExternalStream(
            handle.value, device=torch.device("cuda", index))
        self._jobs = queue.SimpleQueue()
        threading.Thread(target=self._serve, name=f"branch bodies {index}",
                         daemon=True).start()

    def _serve(self):
        while True:
            fn, out, done = self._jobs.get()
            try:
                with torch.no_grad(), torch.cuda.stream(self.stream):
                    out[0] = fn()
            except BaseException as e:   # raised again by run()
                out[1] = e
            finally:
                done.set()
            # hold nothing of the job (its tensors) until the next one
            del fn, out, done

    def run(self, fn):
        """``fn()`` on the worker, with the body stream current; waits for
        it and raises what it raised."""
        out, done = [None, None], threading.Event()
        self._jobs.put((fn, out, done))
        done.wait()
        if out[1] is not None:
            raise out[1]
        return out[0]


_WORKERS = {}
_WORKERS_LOCK = threading.Lock()


def _body_worker(index: int) -> _BodyWorker:
    """The body worker of device ``index``, made once."""
    with _WORKERS_LOCK:
        if index not in _WORKERS:
            _WORKERS[index] = _BodyWorker(index)
        return _WORKERS[index]


class BranchCapture:
    """What one capture's branch sites recorded: for each site, in the
    order met, ``(site, values, launches, nodes, index)``: the index value
    of each body, its hand-written kernel launches (a tuple over the
    ``counters`` given), its graph's nodes, and the device copy of the
    index the set kernel reads. ``counters``: objects with a ``launches``
    attribute (the kernel wrappers)."""

    def __init__(self, device: torch.device, counters=()):
        self.device = device
        self.index = device.index if device.index is not None \
            else torch.cuda.current_device()
        self.counters = tuple(counters)
        self.sites = []
        #: nodes recorded inside :func:`aside` (instrumentation)
        self.aside = 0
        # where bodies are captured: the body worker's stream
        self.worker = _body_worker(self.index)
        self.stream = self.worker.stream
        # body allocations go to a pool of their own, alive with the graph
        self.pool = torch.cuda.MemPool()

    def launches(self):
        return tuple(c.launches for c in self.counters)


@contextlib.contextmanager
def capturing(record: BranchCapture):
    """Inside: the thread's branch sites are being captured into a CUDA
    graph (the engine's capture), recorded in ``record``."""
    saved = getattr(_local, "capture", None)
    _local.capture = record
    try:
        yield record
    finally:
        _local.capture = saved


@contextlib.contextmanager
def _allocate_to(rec: BranchCapture):
    """Inside: this thread's allocations come from the body pool."""
    begin = getattr(torch._C, "_cuda_beginAllocateCurrentThreadToPool", None)
    if begin is None:   # an older PyTorch routes by the current stream
        torch._C._cuda_beginAllocateCurrentStreamToPool(rec.index,
                                                        rec.pool.id)
    else:
        begin(rec.index, rec.pool.id)
    try:
        yield
    finally:
        torch._C._cuda_endAllocateToPool(rec.index, rec.pool.id)
        torch._C._cuda_releasePool(rec.index, rec.pool.id)


@contextlib.contextmanager
def _no_reads():
    """A read of the GPU inside raises before CUDA sees it (a read in a
    body's capture would invalidate the capture mid-way)."""
    saved = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(saved)


def _capture_body(rec: BranchCapture, body, graph, site, j):
    """Capture ``body`` on the body stream, on the body worker, into a
    graph of its own and add it to the SWITCH node's body graph ``graph``
    as a child graph:
    ``(launches, nodes)``. A body that raises leaves that body graph empty
    (its own capture is ended and dropped) and raises."""
    lib = KERNEL.load()
    stream = ctypes.c_void_p(rec.stream.cuda_stream)
    _check(lib.aicam_branch_body_begin(stream),
           f"branch {site!r}: starting body {j}'s capture")
    before = rec.launches()
    n = ctypes.c_ulonglong(0)
    failed = True
    def run():
        with _allocate_to(rec), _no_reads():
            body()

    try:
        rec.worker.run(run)
        failed = False
    finally:
        err = lib.aicam_branch_body_end(
            stream, None if failed else ctypes.c_void_p(graph),
            ctypes.byref(n))
        if not failed:
            _check(err, f"branch {site!r}: body {j}'s capture")
    return (tuple(a - b for a, b in zip(rec.launches(), before)),
            int(n.value))


def _capture_site(rec: BranchCapture, index: torch.Tensor, bodies, site):
    values = [j for j, b in enumerate(bodies) if b is not None]
    if not values:
        return
    lib = KERNEL.load()
    idx = index.reshape(()).to(torch.int32)
    parent = torch.cuda.current_stream(rec.device)
    graphs = (ctypes.c_void_p * len(bodies))()
    _check(lib.aicam_branch_begin(ctypes.c_void_p(parent.cuda_stream),
                                  len(bodies),
                                  ctypes.c_void_p(idx.data_ptr()), graphs),
           f"branch {site!r}: adding its conditional node")
    KERNEL.launches += 1    # the set kernel, captured ahead of the node
    launches, nodes = [], []
    for j in values:
        n_launch, n_nodes = _capture_body(rec, bodies[j], graphs[j], site, j)
        launches.append(n_launch)
        nodes.append(n_nodes)
    # the parent's copy of the index outlives the capture's use of it
    rec.sites.append((site, tuple(values), tuple(launches), tuple(nodes),
                      idx))


def switch(index: torch.Tensor, bodies: Sequence[Callable | None], *,
           counter, site: str):
    """Run ``bodies[index]`` (``lax.switch``); ``None`` bodies do nothing.
    ``index``: a 0-d integer tensor in ``range(len(bodies))``. ``counter``:
    the ``syncs.SyncCounter`` that counts the read on the CPU (``None``: a
    read the host needs not count, its outcome being implied by an earlier
    one). ``site``: the branch's name, under which a capture records it.
    Returns the index taken where the host read it, else ``None``."""
    rec = getattr(_local, "capture", None)
    if index.device.type == "cpu":
        j = int(index) if counter is None else counter.tolist(index)
        if getattr(_local, "every", False):
            for i, body in enumerate(bodies):
                if i != j and body is not None:
                    body()
        if bodies[j] is not None:
            bodies[j]()
        return j
    if rec is not None and torch.cuda.is_current_stream_capturing():
        _capture_site(rec, index, bodies, site)
        return None
    warm = getattr(_local, "warming", None)
    if warm is not None:
        here = torch.cuda.current_stream(warm.device)

        def run_all():
            # the waits too on the worker, between its captures
            warm.stream.wait_stream(here)
            for body in bodies:
                if body is not None:
                    body()
            here.wait_stream(warm.stream)

        warm.worker.run(run_all)
        return None
    raise RuntimeError(
        f"branch {site!r} on {index.device} outside a CUDA-graph capture: "
        "a step with device-decided branches runs on the GPU only through "
        "runtime.engine.CUDAGraphEngine")


def cond(pred: torch.Tensor, if_true: Callable | None,
         if_false: Callable | None = None, *, counter, site: str):
    """``lax.cond``: ``if_true()`` where the 0-d bool ``pred`` holds, else
    ``if_false()`` (``None``: nothing). As :func:`switch` on ``int(pred)``
    (0 the false body, 1 the true one); returns the index taken or
    ``None``."""
    return switch(pred.to(torch.int32), [if_false, if_true],
                  counter=counter, site=site)


def stamp(buf: torch.Tensor, slot: int) -> None:
    """The clock into ``buf[slot]`` (an int64 tensor), in nanoseconds: on
    the GPU a one-thread kernel queued on the current stream reads the
    device's global timer when the stream reaches it (inside a capture, a
    node of the graph, read again at every replay); on the CPU the host's
    ``time.time_ns()`` now. Not counted in ``KERNEL.launches``."""
    if buf.dtype != torch.int64 or buf.dim() != 1 \
            or not 0 <= slot < buf.numel():
        raise ValueError(f"stamp slot {slot} of a {tuple(buf.shape)} "
                         f"{buf.dtype} buffer (a 1-d int64 one is needed)")
    if buf.device.type == "cpu":
        buf[slot].fill_(time.time_ns())
        return
    stream = torch._C._cuda_getCurrentRawStream(buf.device.index)
    _check(KERNEL.load().aicam_stamp_launch(
        ctypes.c_void_p(stream), ctypes.c_void_p(buf.data_ptr()), slot),
        "a stage stamp")


def _capture_nodes(stream: int) -> int:
    n = ctypes.c_ulonglong(0)
    _check(KERNEL.load().aicam_capture_nodes(ctypes.c_void_p(stream),
                                             ctypes.byref(n)),
           "counting a capture's nodes")
    return int(n.value)


@contextlib.contextmanager
def aside():
    """Inside, the nodes that this thread's capture records (an engine's
    capture on the GPU) are counted in its ``BranchCapture.aside``:
    instrumentation, which ``CUDAGraphEngine.graph_nodes`` leaves out.
    Anywhere else it does nothing."""
    rec = getattr(_local, "capture", None)
    if rec is None or not torch.cuda.is_current_stream_capturing():
        yield
        return
    stream = torch.cuda.current_stream(rec.device).cuda_stream
    n0 = _capture_nodes(stream)
    yield
    rec.aside += _capture_nodes(stream) - n0
