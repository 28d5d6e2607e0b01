"""ONNX weight import without the onnx package: a protobuf wire-format
parse, then structural matching onto the port's modules.

The port of ``aicamera_tpu/models/onnx_import.py``; the parsing and the
extraction are the same numpy code (the GPU host has no ``onnx`` either).
The reference downloads ``yolov8n.onnx`` and ``deepsort.onnx``; they import
here directly: Conv + following BatchNormalization pairs fold into conv
scale and bias, and the learned convolutions, in graph execution order,
are zipped against the module's convolutions in forward order, recorded
with forward hooks (:func:`forward_param_order`).

The result is a Flax-layout params tree (conv kernels HWIO, Dense kernels
``(in, out)``), the tree a ``.msgpack`` checkpoint holds, which
``runtime/params.py`` loads into the module and can cache as msgpack.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

# --- minimal protobuf wire-format reader -------------------------------------


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: memoryview):
    """Yield (field_number, wire_type, value) over one message's bytes."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val = bytes(buf[pos:pos + 8])
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            val = bytes(buf[pos:pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


_ONNX_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32,
                7: np.int64, 10: np.float16, 11: np.float64}


def _parse_tensor(buf: memoryview) -> Tuple[str, np.ndarray]:
    """TensorProto: dims=1, data_type=2, name=8, raw_data=9, float_data=4,
    int64_data=7, int32_data=5."""
    dims: List[int] = []
    dtype = np.float32
    name = ""
    raw = None
    floats: List[bytes] = []
    int64s: List[int] = []
    int32s: List[int] = []
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == 0:
            dims.append(val)
        elif field == 2 and wire == 0:
            dtype = _ONNX_DTYPES.get(val, np.float32)
        elif field == 8 and wire == 2:
            name = bytes(val).decode("utf-8", "replace")
        elif field == 9 and wire == 2:
            raw = bytes(val)
        elif field == 4:  # float_data (packed or repeated)
            if wire == 2:
                floats.append(bytes(val))
            else:
                floats.append(val)
        elif field == 7 and wire == 0:
            int64s.append(val)
        elif field == 5 and wire == 0:
            int32s.append(val)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype)
    elif floats:
        arr = np.frombuffer(b"".join(floats), dtype=np.float32)
    elif int64s:
        arr = np.asarray(int64s, np.int64)
    elif int32s:
        arr = np.asarray(int32s, np.int32)
    else:
        arr = np.zeros(0, dtype)
    if dims:
        arr = arr.reshape(dims)
    return name, arr.astype(np.float32) if arr.dtype == np.float16 else arr


def _parse_attribute(buf: memoryview):
    """AttributeProto: name=1, f=2, i=3, t=5, floats=7, ints=8."""
    name = ""
    value = None
    ints: List[int] = []
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == 2:
            name = bytes(val).decode("utf-8", "replace")
        elif field == 2:
            value = np.frombuffer(val, np.float32)[0] if wire == 5 else val
        elif field == 3 and wire == 0:
            value = val
        elif field == 5 and wire == 2:
            value = _parse_tensor(val)[1]
        elif field == 8 and wire == 0:
            ints.append(val)
    if ints:
        value = ints
    return name, value


class OnnxNode:
    def __init__(self):
        self.inputs: List[str] = []
        self.outputs: List[str] = []
        self.op_type = ""
        self.name = ""
        self.attrs: Dict[str, object] = {}

    def __repr__(self):
        return f"OnnxNode({self.op_type}, in={self.inputs}, out={self.outputs})"


def _parse_node(buf: memoryview) -> OnnxNode:
    node = OnnxNode()
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == 2:
            node.inputs.append(bytes(val).decode("utf-8", "replace"))
        elif field == 2 and wire == 2:
            node.outputs.append(bytes(val).decode("utf-8", "replace"))
        elif field == 3 and wire == 2:
            node.name = bytes(val).decode("utf-8", "replace")
        elif field == 4 and wire == 2:
            node.op_type = bytes(val).decode("utf-8", "replace")
        elif field == 5 and wire == 2:
            k, v = _parse_attribute(val)
            node.attrs[k] = v
    return node


def parse_onnx(path) -> Tuple[List[OnnxNode], Dict[str, np.ndarray]]:
    """Parse an ONNX file into (graph nodes, initializer arrays).

    ``Constant`` node outputs are folded into the initializer map so that
    weights routed through Constant nodes (some exporters do this for fixed
    tensors) resolve the same way as plain initializers.
    """
    data = memoryview(Path(path).read_bytes())
    graph = None
    for field, wire, val in _iter_fields(data):  # ModelProto
        if field == 7 and wire == 2:  # graph
            graph = val
            break
    if graph is None:
        raise ValueError(f"{path}: no graph found (not an ONNX file?)")
    nodes: List[OnnxNode] = []
    inits: Dict[str, np.ndarray] = {}
    for field, wire, val in _iter_fields(graph):  # GraphProto
        if field == 1 and wire == 2:
            nodes.append(_parse_node(val))
        elif field == 5 and wire == 2:
            name, arr = _parse_tensor(val)
            inits[name] = arr
    for n in nodes:
        if (n.op_type == "Constant" and n.outputs
                and isinstance(n.attrs.get("value"), np.ndarray)):
            inits.setdefault(n.outputs[0], n.attrs["value"])
    return nodes, inits


def toposort_nodes(nodes: List[OnnxNode],
                   inits: Dict[str, np.ndarray]) -> List[OnnxNode]:
    """Stable topological sort into execution order.

    torch exports nodes in forward-execution order already, in which case
    this is the identity; files whose node list was reordered (graph
    optimizers, some converters) are restored to a valid execution order
    with original file position as the tie-break among ready nodes, so
    same-level parallel branches keep their exported relative order.
    """
    import heapq

    producer: Dict[str, int] = {}
    for idx, n in enumerate(nodes):
        for o in n.outputs:
            producer[o] = idx

    indeg = [0] * len(nodes)
    users: Dict[int, List[int]] = {}
    for idx, n in enumerate(nodes):
        deps = {producer[i] for i in n.inputs
                if i in producer and producer[i] != idx}
        indeg[idx] = len(deps)
        for d in deps:
            users.setdefault(d, []).append(idx)

    ready = [i for i, d in enumerate(indeg) if d == 0]
    heapq.heapify(ready)
    order: List[OnnxNode] = []
    while ready:
        i = heapq.heappop(ready)
        order.append(nodes[i])
        for u in users.get(i, ()):
            indeg[u] -= 1
            if indeg[u] == 0:
                heapq.heappush(ready, u)
    if len(order) != len(nodes):
        raise ValueError("graph contains a cycle; not a valid ONNX graph")
    return order


# --- conv extraction with BN folding ------------------------------------------


def is_dfl_conv_weight(w: np.ndarray) -> bool:
    """True for the ultralytics DFL conv: a fixed, non-learned 1x1 kernel
    whose content is ``arange(reg_max)`` (shape ``(1, reg_max, 1, 1)``).

    The real yolov8n.onnx (the export the reference downloads,
    ``scripts/download_models.sh:7``) contains this node in its Detect
    head; it computes the DFL bin expectation as a conv and has no
    counterpart in the port's modules — ``ops/nms.py`` computes the
    expectation directly — so the
    importer must skip it rather than zip it against a learned conv.
    """
    if (w.ndim != 4 or w.shape[0] != 1 or w.shape[2:] != (1, 1)
            or w.shape[1] < 2):
        return False
    return bool(np.allclose(w.reshape(-1), np.arange(w.shape[1]),
                            atol=1e-5))


def extract_conv_weights(nodes: List[OnnxNode],
                         inits: Dict[str, np.ndarray]):
    """Collect (kernel OIHW, bias) per *learned* Conv in graph order,
    folding any BatchNormalization that consumes a conv's output and
    skipping fixed-weight DFL convs (:func:`is_dfl_conv_weight`).

    Fold: W' = W * gamma / sqrt(var + eps);  b' = (b - mean) * gamma /
    sqrt(var + eps) + beta.
    """
    bn_by_input: Dict[str, OnnxNode] = {}
    for n in nodes:
        if n.op_type == "BatchNormalization" and n.inputs:
            bn_by_input[n.inputs[0]] = n

    convs = []
    for n in nodes:
        if n.op_type != "Conv":
            continue
        w = inits.get(n.inputs[1])
        if w is None:
            raise ValueError(f"Conv {n.name}: kernel is not an initializer")
        if is_dfl_conv_weight(w):
            continue
        b = inits.get(n.inputs[2]) if len(n.inputs) > 2 else None
        if b is None:
            b = np.zeros(w.shape[0], np.float32)
        bn = bn_by_input.get(n.outputs[0]) if n.outputs else None
        if bn is not None:
            gamma, beta, mean, var = (inits[bn.inputs[i]] for i in (1, 2, 3, 4))
            eps = float(bn.attrs.get("epsilon", 1e-5))
            scale = gamma / np.sqrt(var + eps)
            w = w * scale[:, None, None, None]
            b = (b - mean) * scale + beta
        convs.append((np.asarray(w, np.float32), np.asarray(b, np.float32)))
    return convs


def extract_gemm_weights(nodes: List[OnnxNode],
                         inits: Dict[str, np.ndarray]):
    """Collect (weight, bias) per Gemm/MatMul in graph order."""
    out = []
    for n in nodes:
        if n.op_type in ("Gemm", "MatMul"):
            w = inits.get(n.inputs[1])
            if w is None:
                continue
            b = inits.get(n.inputs[2]) if len(n.inputs) > 2 else None
            if n.op_type == "Gemm" and int(n.attrs.get("transB", 0)):
                w = w.T  # store as (in, out)
            if b is None:
                b = np.zeros(w.shape[-1], np.float32)
            out.append((np.asarray(w, np.float32), np.asarray(b, np.float32)))
    return out


# --- module mapping ---------------------------------------------------------


def forward_param_order(model: torch.nn.Module, example_input: torch.Tensor
                        ) -> List[Tuple[Tuple, str]]:
    """``(path, kind)`` for every ``Conv2d``/``Linear`` in forward-execution
    order, ``path`` the Flax params path (the module's name split at the
    dots: the port's module names are the Flax names), ``kind`` ``"conv"``
    or ``"dense"``. Recorded with forward pre-hooks over one forward of
    ``example_input``; a module applied twice counts at its first
    application. A name walk would not do: the order modules are declared
    in is not the order a multi-branch net runs them in."""
    order: List[Tuple[Tuple, str]] = []
    seen = set()
    hooks = []

    def record(name, kind):
        def hook(module, args):
            if name not in seen:
                seen.add(name)
                order.append((tuple(name.split(".")), kind))
        return hook

    for name, m in model.named_modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            kind = "conv" if isinstance(m, torch.nn.Conv2d) else "dense"
            hooks.append(m.register_forward_pre_hook(record(name, kind)))
    try:
        with torch.no_grad():
            model(example_input)
    finally:
        for h in hooks:
            h.remove()
    return order


def _set_path(tree, path, kernel, bias):
    node = tree["params"] if "params" in tree else tree
    for k in path[:-1]:
        node = node[k]
    leaf = node[path[-1]]
    if kernel.shape != leaf["kernel"].shape:
        raise ValueError(
            f"shape mismatch at {'/'.join(path)}: onnx {kernel.shape} vs "
            f"flax {leaf['kernel'].shape}")
    leaf["kernel"] = kernel.astype(np.float32)
    if "bias" in leaf:
        leaf["bias"] = bias.astype(np.float32)


def _copy_tree(tree):
    return {k: _copy_tree(v) if isinstance(v, dict) else np.array(v)
            for k, v in tree.items()}


def import_conv_net_params(onnx_path, template, model, example_input,
                           strict: bool = True):
    """Zip the ONNX file's learned convs (execution order via toposort, BN
    folded, DFL skipped) and Gemm/MatMul weights onto ``model``'s convs and
    dense layers in forward order. ``template``: the model's Flax-layout
    tree (``runtime.params.flax_tree``); returns a new tree of numpy
    arrays. ``strict``: the counts must match (a torn or foreign file
    aborts instead of importing part of the net)."""
    nodes, inits = parse_onnx(onnx_path)
    nodes = toposort_nodes(nodes, inits)
    convs = extract_conv_weights(nodes, inits)
    gemms = extract_gemm_weights(nodes, inits)
    tree = _copy_tree(template)
    order = forward_param_order(model, example_input)
    conv_paths = [p for p, kind in order if kind == "conv"]
    dense_paths = [p for p, kind in order if kind == "dense"]
    if strict and len(conv_paths) != len(convs):
        raise ValueError(
            f"{onnx_path}: conv count mismatch — onnx has {len(convs)} "
            f"learned convs, model expects {len(conv_paths)}. The export "
            "likely contains extra/missing layers; import aborted.")
    if strict and len(dense_paths) != len(gemms):
        raise ValueError(
            f"{onnx_path}: dense count mismatch — onnx has {len(gemms)} "
            f"Gemm/MatMul with weights, model expects {len(dense_paths)}; "
            "import aborted.")
    for path, (w, b) in zip(conv_paths, convs):
        _set_path(tree, path, w.transpose(2, 3, 1, 0), b)   # OIHW -> HWIO
    for path, (w, b) in zip(dense_paths, gemms):
        _set_path(tree, path, w, b)
    return tree
