"""CUDAGraphEngine: shape-keyed CUDA-graph capture with warm-up and I/O
introspection, and the port's own engine files (``.cudae``).

The port of ``aicamera_tpu/runtime/engine.py``. ``XLAEngine`` compiles a
jitted function ahead of time for its input shapes; its counterpart here,
:class:`CUDAGraphEngine`, runs the function eagerly a few times on a side
stream (which builds the letterbox kernel, uploads its tap tables and warms
cuDNN and cuBLAS), then captures its launches into a CUDA graph, one graph
per concrete input shape, all in one memory pool. A call copies the inputs
into the graph's static buffers, replays the graph (one launch from the host
for the whole step) and returns copies of the static outputs, which a later
call would overwrite (JAX arrays are never overwritten). The reference's
TensorRT engines were built with ``--useCudaGraph`` (``BASELINE.md:13-14``).

A function that reads the GPU during capture (``.item()``, ``.cpu()``, a
``syncs.SyncCounter`` read) makes the capture fail, and the engine raises: it
never falls back to eager execution. On the CPU the engine calls the
function directly, with the same I/O contract and introspection.

A function may branch on device values through ``runtime.branches``
(``lax.switch``/``lax.cond``): the capture holds every body as a
conditional node, the device picks one a replay, and the engine counts a
body's kernel launches only when told that the replay took it
(:meth:`CUDAGraphEngine.count_taken`). ``carry`` inputs (a step's state)
stay in the graph's buffers from one replay to the next, as the JAX
package donates them.

Engine files. A ``.xlae`` file holds an XLA executable, which PyTorch cannot
run; every loader here refuses one by name. The port's format, ``.cudae``, is
``_ENGINE_MAGIC``, a little-endian u32 header length, a JSON header (name,
kind, platforms, the exporter's compute dtype, the JAX package's metadata,
the baked settings, the input and output details) and then the weights as a
Flax msgpack tree (``runtime.params.write_flax_msgpack``): the file is
self-contained. :class:`SerializedEngine` rebuilds the step from ``kind``,
the weights and the settings, and captures it lazily, once per concrete
input shape (the ReID engine's dynamic batch).
"""

from __future__ import annotations

import ctypes
import gc
import importlib
import json
import os
import struct
import threading
import time
import warnings
from pathlib import Path
from typing import Any, Callable, NamedTuple, Sequence

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..device import resolve_device
from ..ops import cuda_build
from ..ops.assignment import KERNEL as ASSIGNMENT
from ..ops.letterbox import KERNEL as LETTERBOX
from ..ops.nms import KERNEL as NMS
from ..ops.oru import KERNEL as ORU
from . import branches
from .params import read_flax_msgpack, write_flax_msgpack

ENGINE_FILE_SUFFIX = ".cudae"
XLA_ENGINE_SUFFIX = ".xlae"
_ENGINE_MAGIC = b"AICAMCUDA1"
_XLA_MAGIC = b"AICAMXLAE1"    # the JAX package's .xlae files

#: The hand-written kernels whose launches a replay repeats: each engine
#: adds ``captured launches x replays`` to their launch counts (a branch
#: body's only when the replay took it).
KERNELS = (LETTERBOX, ASSIGNMENT, ORU, NMS, branches.KERNEL)

# kind -> (module, function) that rebuilds a serialized step:
# ``fn(header, weights, device) -> callable``
_KINDS = {"yolo_detect": ("aicamera_tpu_torch.detector", "serialized_step"),
          "reid_embed": ("aicamera_tpu_torch.tracker_api",
                         "serialized_step")}


class TensorInfo(NamedTuple):
    """An input or output of an engine (the reference's ``TensorInfo``);
    a ``None`` in ``shape`` is a dynamic axis."""
    name: str
    shape: tuple
    dtype: Any


def enable_persistent_cache(cache_dir: str | None = None) -> None:
    """The port's only compile cache is the kernel build directory
    (``ops/cuda_build.py``): put it at ``cache_dir``, else at
    ``$AICAMERA_COMPILE_CACHE`` when that is set; otherwise it stays where it
    is. A CUDA graph itself is not cached across processes."""
    path = cache_dir or os.environ.get("AICAMERA_COMPILE_CACHE")
    if path:
        cuda_build.set_build_dir(path)


def _flat(out):
    """``(tensors, tree spec)``: a function's outputs (a tensor or nested
    tuples, lists and dicts of tensors) as a list of leaves."""
    return tree_flatten(out)


def _shape_key(tensors) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in tensors)


def _graph_nodes(graph) -> int | None:
    """Nodes of a captured graph kept with ``keep_graph=True`` (CUDA's
    ``cuGraphGetNodes`` in ``libcuda``), or ``None`` where this PyTorch
    cannot say."""
    raw = getattr(graph, "raw_cuda_graph", None)
    if raw is None:
        return None
    try:
        handle = raw()
        lib = ctypes.CDLL("libcuda.so.1")
    except (RuntimeError, OSError):
        return None
    n = ctypes.c_size_t(0)
    err = lib.cuGraphGetNodes(ctypes.c_void_p(handle), None, ctypes.byref(n))
    return int(n.value) if err == 0 else None


class _Captured(NamedTuple):
    graph: Any
    inputs: list          # static input buffers
    outputs: list         # static outputs (the leaves)
    spec: Any             # their tree structure
    launches: tuple       # kernel launches outside branches, per KERNELS
    nodes: int | None     # the graph's nodes, its branch bodies' included
    branches: dict        # site -> {index value: launches of its body}


class CUDAGraphEngine:
    """A function captured into CUDA graphs, one per input shape: the
    counterpart of the JAX package's ``XLAEngine``.

    Args:
        fn: ``fn(*inputs) -> tensors`` (a tensor or nested tuples, lists
            and dicts of them), a function of tensors on ``device`` whose
            launches do not depend on the data (no read of the GPU).
            Parameters it closes over are baked into the graph, as weights
            into an engine.
        example_inputs: tensors (or :class:`TensorInfo`, zeros of that
            shape and dtype) fixing the first shape captured; a call with
            another shape captures another graph into the same memory pool.
        name: label for logs and errors.
        warmup_iters: eager passes before each capture (at least 1 on a
            GPU; a branch runs every body in them); on the CPU the engine
            calls ``fn`` directly and learns its outputs from the first
            call (or from a run on the example inputs, if they are asked
            for first).
        device: where ``fn`` runs; default the GPU.
        carry: the first ``carry`` inputs are a state that the first
            ``carry`` outputs replace: on the GPU the graph ends by copying
            those outputs into the inputs' buffers, and a call returns the
            buffers themselves (a later call overwrites them; an input that
            already is its buffer is not copied in).
        copy_outputs: False returns the other outputs as the graph's own
            buffers too, valid until the next call (read them, or queue
            their copies, before it); True returns copies.

    XLA's ``static_argnums`` and ``donate_argnums`` have no counterpart: a
    graph replays fixed launches on fixed buffers, so there is nothing
    static to key on and nothing to donate.

    ``compile_seconds`` is the capture time and ``warmup_seconds`` the
    eager passes' time, summed over the shapes captured; ``replays`` counts
    the calls.
    """

    def __init__(self, fn: Callable, example_inputs: Sequence[Any],
                 name: str = "engine", warmup_iters: int = 5, device=None,
                 carry: int = 0, copy_outputs: bool = True):
        enable_persistent_cache()
        self.name = name
        self.device = resolve_device(device)
        self.warmup_iters = int(warmup_iters)
        self.carry = int(carry)
        self.copy_outputs = bool(copy_outputs)
        self.compile_seconds = 0.0
        self.warmup_seconds = 0.0
        self.replays = 0
        self._fn = fn
        self._lock = threading.RLock()
        self._graphs = {}
        self._records = []   # the captures' branch records (their pools)
        self._cuda = self.device.type == "cuda"
        self._pool = torch.cuda.graph_pool_handle() if self._cuda else None
        self._example = [
            torch.zeros(x.shape, dtype=x.dtype, device=self.device)
            if isinstance(x, TensorInfo) else x.to(self.device)
            for x in example_inputs]
        self._in_info = [TensorInfo(f"input_{i}", tuple(x.shape), x.dtype)
                         for i, x in enumerate(self._example)]
        self._out_info = None
        if self._cuda:
            self._learn_outputs(self._capture(self._example).outputs)

    def _learn_outputs(self, outs):
        self._out_info = [TensorInfo(f"output_{i}", tuple(o.shape), o.dtype)
                          for i, o in enumerate(outs)]

    # --- capture and replay ---------------------------------------------------

    def run_eager(self):
        """``fn`` once, eagerly, on the example inputs (``device_cost``)."""
        with torch.no_grad():
            return self._fn(*self._example)

    def _capture(self, inputs) -> _Captured:
        dev = self.device
        static = [torch.empty(x.shape, dtype=x.dtype, device=dev).copy_(x)
                  for x in inputs]
        record = branches.BranchCapture(dev, KERNELS)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        t0 = time.perf_counter()
        with torch.cuda.stream(side), torch.no_grad(), \
                branches.warming(record):
            for _ in range(max(1, self.warmup_iters)):
                self._fn(*static)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        self.warmup_seconds += time.perf_counter() - t0
        try:
            graph, keep = torch.cuda.CUDAGraph(keep_graph=True), True
        except TypeError:  # a PyTorch without keep_graph
            graph, keep = torch.cuda.CUDAGraph(), False
        before = [k.launches for k in KERNELS]
        stream = torch.cuda.current_stream(dev)
        t0 = time.perf_counter()
        # no garbage collection inside the capture: a CUDA object freed
        # there (an old graph, an event) makes calls a capture forbids
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.no_grad(), torch.cuda.graph(graph, pool=self._pool), \
                    branches.capturing(record):
                out = self._fn(*static)
                if self.carry:
                    # the new state into the state's buffers, in the graph
                    new = _flat(out)[0][:self.carry]
                    for buf, x in zip(static[:self.carry], new):
                        buf.copy_(x)
        except RuntimeError as e:
            # a failed capture leaves the capture stream current, and may
            # leave the pool's allocation routing open
            torch.cuda.set_stream(stream)
            try:
                torch._C._cuda_endAllocateToPool(
                    torch.cuda.current_device() if dev.index is None
                    else dev.index, self._pool)
            except RuntimeError:
                pass
            raise RuntimeError(
                f"engine '{self.name}': CUDA-graph capture failed ({e}). A "
                "function that reads the GPU while it runs (.item(), "
                ".cpu(), a SyncCounter read) cannot be captured; the engine "
                "does not run it eagerly instead.") from e
        finally:
            if collecting:
                gc.enable()
            # the capture recorded launches; it ran none
            launches = tuple(k.launches - b for k, b in zip(KERNELS, before))
            for k, b in zip(KERNELS, before):
                k.launches = b
        taken = {}
        for site, values, body_launches, _, _ in record.sites:
            table = taken.setdefault(site, {})
            for v, n in zip(values, body_launches):
                table[v] = tuple(a + b for a, b in zip(
                    table.get(v, (0,) * len(KERNELS)), n))
                launches = tuple(a - b for a, b in zip(launches, n))
        nodes = _graph_nodes(graph) if keep else None
        if nodes is not None:
            nodes += sum(sum(site[3]) for site in record.sites)
        if keep:
            graph.instantiate()
        torch.cuda.synchronize(dev)
        self.compile_seconds += time.perf_counter() - t0
        outs, spec = _flat(out)
        if self.carry:
            outs = static[:self.carry] + outs[self.carry:]
        cap = _Captured(graph, static, outs, spec, launches, nodes, taken)
        # the branch bodies' pool and index copies live with the graph
        self._records.append(record)
        self._graphs[_shape_key(static)] = cap
        return cap

    def _check(self, inputs):
        if len(inputs) != len(self._in_info):
            raise TypeError(f"engine '{self.name}' takes "
                            f"{len(self._in_info)} inputs (got "
                            f"{len(inputs)})")
        for x, info in zip(inputs, self._in_info):
            if x.dtype != info.dtype or x.ndim != len(info.shape):
                raise TypeError(
                    f"engine '{self.name}': {info.name} must be a "
                    f"{len(info.shape)}-d {info.dtype} tensor (got "
                    f"{tuple(x.shape)} {x.dtype})")

    def __call__(self, *inputs):
        """Outputs of ``fn(*inputs)``. On the GPU: the inputs (on the host
        or the device) are copied into the static buffers, the graph of
        their shape is replayed (captured first if it is new) and the
        outputs are copies, in the structure ``fn`` returns."""
        self._check(inputs)
        if not self._cuda:
            with torch.no_grad():
                out = self._fn(*inputs)
            if self._out_info is None:
                self._learn_outputs(_flat(out)[0])
            return out
        with self._lock:
            cap = self._graphs.get(_shape_key(inputs))
            if cap is None:
                cap = self._capture([x.to(self.device) for x in inputs])
            for buf, x in zip(cap.inputs, inputs):
                if buf.data_ptr() != x.data_ptr():
                    buf.copy_(x, non_blocking=True)
            cap.graph.replay()
            self.replays += 1
            for k, n in zip(KERNELS, cap.launches):
                k.launches += n
            outs = cap.outputs[:self.carry] + [
                o.clone() if self.copy_outputs else o
                for o in cap.outputs[self.carry:]]
        return tree_unflatten(outs, cap.spec)

    def count_taken(self, taken: dict) -> None:
        """Add the hand-written kernel launches of the branch bodies that a
        replay took: ``taken`` maps a branch site to the index it took (as
        read back from the replay's outputs). The launches outside branches
        are counted at the replay itself. No-op on the CPU."""
        cap = next(iter(self._graphs.values()), None)
        if cap is None:
            return
        for site, j in taken.items():
            for k, n in zip(KERNELS, cap.branches.get(site, {}).get(j, ())):
                k.launches += n

    def branch_sites(self) -> dict:
        """``{site: {index: nodes of its body}}`` of the first graph, or
        ``{}`` (on the CPU, or before a capture)."""
        for rec in self._records[:1]:
            return {site: dict(zip(values, nodes))
                    for site, values, _, nodes, _ in rec.sites}
        return {}

    # --- introspection (TRTEngine.get_input_details/get_output_details) -------

    def get_input_details(self):
        return list(self._in_info)

    def get_output_details(self):
        if self._out_info is None:   # the CPU, before a call
            t0 = time.perf_counter()
            self._learn_outputs(_flat(self.run_eager())[0])
            self.warmup_seconds = time.perf_counter() - t0
        return list(self._out_info)

    def graph_nodes(self, *inputs) -> int | None:
        """Nodes in the graph of these inputs' shape (default: the example
        shape); ``None`` on the CPU or where this PyTorch cannot say."""
        cap = self._graphs.get(_shape_key(inputs or self._example))
        return None if cap is None else cap.nodes

    def cost_analysis(self) -> dict:
        """``{"flops", "bytes accessed"}`` of one call on the example inputs
        (``runtime.profiler.device_cost``)."""
        from .profiler import device_cost
        return device_cost(self)


# --------------------------------------------------------------------------
# Engine files (.cudae): the TensorRT ``.engine`` analog of the port.
# --------------------------------------------------------------------------

def is_engine_file(path) -> bool:
    """True if ``path`` names one of the port's engine files (by suffix)."""
    return path is not None and str(path).endswith(ENGINE_FILE_SUFFIX)


def is_xla_engine_file(path) -> bool:
    """True if ``path`` names a JAX ``.xlae`` engine (by suffix)."""
    return path is not None and str(path).endswith(XLA_ENGINE_SUFFIX)


def xla_engine_error(path) -> ValueError:
    """The error every loader of the port raises for a ``.xlae`` file."""
    return ValueError(
        f"{path}: a .xlae file is the JAX package's engine format, an XLA "
        "executable that PyTorch cannot run. Export a .cudae engine from "
        "the port instead (YOLODetector.export_engine, "
        "ReIDModel.export_engine or python -m "
        "aicamera_tpu_torch.export_engines).")


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _info_json(infos) -> list:
    return [{"name": t.name, "shape": list(t.shape),
             "dtype": _dtype_name(t.dtype)} for t in infos]


def _info_from_json(items) -> list:
    return [TensorInfo(t["name"], tuple(t["shape"]),
                       getattr(torch, t["dtype"])) for t in items]


def export_engine(path, kind: str, weights: dict, inputs, outputs,
                  name: str = "engine", metadata: dict | None = None,
                  dtype: str = "f32", settings: dict | None = None,
                  platforms: Sequence[str] = ("cuda", "cpu")) -> Path:
    """Write a ``.cudae`` engine file.

    Unlike the JAX package's ``export_engine(fn, example_inputs, ...)``,
    which serializes a traced function, the port writes what rebuilds the
    step: ``kind`` (``"yolo_detect"`` or ``"reid_embed"``), the ``weights``
    (a Flax-layout tree of numpy arrays), the compute ``dtype`` (``"bf16"``
    or ``"f32"``: export on the device you will serve on), the JAX
    package's ``metadata`` keys, the ``settings`` the step bakes in, and
    the ``inputs``/``outputs`` details (:class:`TensorInfo`, ``None`` for
    a dynamic axis)."""
    if kind not in _KINDS:
        raise ValueError(f"unknown engine kind {kind!r}")
    if is_xla_engine_file(path):
        raise xla_engine_error(path)
    header = json.dumps({
        "name": name, "kind": kind, "platforms": list(platforms),
        "dtype": dtype, "metadata": metadata or {},
        "settings": settings or {}, "inputs": _info_json(inputs),
        "outputs": _info_json(outputs)}).encode("utf-8")
    blob = write_flax_msgpack(weights)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(_ENGINE_MAGIC)
        f.write(struct.pack("<I", len(header)))
        f.write(header)
        f.write(blob)
    return path


class SerializedEngine:
    """A loaded ``.cudae`` engine: callable and introspectable, as the JAX
    package's ``SerializedEngine``. The step is rebuilt from the file at
    load; it is captured (a :class:`CUDAGraphEngine`) at the first call of
    each concrete input shape."""

    def __init__(self, header: dict, weights: dict, device=None):
        self.name = header.get("name", "engine")
        self.kind = header["kind"]
        self.metadata = header.get("metadata", {})
        self.settings = header.get("settings", {})
        self.platforms = tuple(header.get("platforms", ()))
        self.dtype = header.get("dtype", "f32")
        self.device = resolve_device(device)
        self._in_info = _info_from_json(header["inputs"])
        self._out_info = _info_from_json(header["outputs"])
        module, fn = _KINDS[self.kind]
        self._fn = getattr(importlib.import_module(module), fn)(
            header, weights, self.device)
        self.engine: CUDAGraphEngine | None = None

    @classmethod
    def load(cls, path, device=None) -> "SerializedEngine":
        """Read an engine file (``TRTEngine._init_engine`` analog)."""
        if is_xla_engine_file(path):
            raise xla_engine_error(path)
        with open(path, "rb") as f:
            data = f.read()
        if data.startswith(_XLA_MAGIC):
            raise xla_engine_error(path)
        if not data.startswith(_ENGINE_MAGIC):
            raise ValueError(
                f"{path}: not a serialized engine file (bad magic); "
                f"expected an artifact written by export_engine()")
        off = len(_ENGINE_MAGIC)
        (hlen,) = struct.unpack_from("<I", data, off)
        off += 4
        header = json.loads(data[off:off + hlen].decode("utf-8"))
        weights = read_flax_msgpack(data[off + hlen:])
        engine = cls(header, weights, device)
        if engine.device.type not in engine.platforms:
            warnings.warn(
                f"{path}: engine was exported for platforms "
                f"{list(engine.platforms)} but the device is "
                f"'{engine.device.type}'.", stacklevel=2)
        return engine

    def _check(self, inputs):
        if len(inputs) != len(self._in_info):
            raise TypeError(f"engine '{self.name}' takes "
                            f"{len(self._in_info)} inputs")
        for x, info in zip(inputs, self._in_info):
            fixed = all(a is None or a == b
                        for a, b in zip(info.shape, x.shape))
            if x.ndim != len(info.shape) or not fixed:
                raise ValueError(
                    f"engine '{self.name}': {info.name} has shape "
                    f"{tuple(x.shape)}, the engine takes {info.shape}")

    def __call__(self, *inputs):
        """Run the step (captured per input shape on a GPU)."""
        self._check(inputs)
        if self.engine is None:
            self.engine = CUDAGraphEngine(
                self._fn, [x.to(self.device) for x in inputs],
                name=self.name, warmup_iters=2, device=self.device)
        return self.engine(*inputs)

    def warm_up(self, example_inputs: Sequence[Any], iters: int = 5) -> None:
        """Capture and run the step at these inputs' shapes."""
        for _ in range(max(1, iters)):
            self(*example_inputs)

    def get_input_details(self):
        return list(self._in_info)

    def get_output_details(self):
        return list(self._out_info)

    def cost_analysis(self) -> dict:
        """``device_cost`` of the step at the first shape called; ``{}``
        before any call."""
        return {} if self.engine is None else self.engine.cost_analysis()


def load_engine(path, device=None) -> SerializedEngine:
    """Convenience alias: load a ``.cudae`` engine file."""
    return SerializedEngine.load(path, device=device)
