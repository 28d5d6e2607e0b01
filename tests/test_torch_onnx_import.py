"""Port: ONNX weight import (``models/onnx_import.py``) and ``.onnx`` weights
in the loaders, the CLI and the facades, on the CPU.

The parser and the extractors must give JAX's arrays bit for bit on
hand-serialized files (the protobuf writer below is a copy of the one in
``tests/test_onnx_import.py``) and on a file from torch's real ONNX
exporter; ``forward_param_order`` must list JAX's Flax paths in JAX's
order; and a file written from a committed checkpoint must load into
weights, detections and tracks bitwise equal to the checkpoint's.

The other port tests that load ``.onnx`` weights take their files from
:func:`checkpoint_onnx`.
"""

import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as nn  # noqa: E402

from aicamera_tpu.models import onnx_import as jimp  # noqa: E402
from aicamera_tpu.models.reid import ReIDNet as JReID  # noqa: E402
from aicamera_tpu.models.yolov8 import YOLOv8 as JYOLO  # noqa: E402
from aicamera_tpu_torch import config  # noqa: E402
from aicamera_tpu_torch.models import onnx_import as timp  # noqa: E402
from aicamera_tpu_torch.models.reid import ReIDNet  # noqa: E402
from aicamera_tpu_torch.models.yolov8 import YOLOv8  # noqa: E402
from aicamera_tpu_torch.runtime import params  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- minimal protobuf writer (copied from tests/test_onnx_import.py) --------


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


def _tensor_proto(name: str, arr: np.ndarray) -> bytes:
    out = b""
    for d in arr.shape:
        out += _field(1, 0, _varint(d))
    out += _field(2, 0, _varint(1))  # data_type float32
    out += _str_field(8, name)
    out += _field(9, 2, arr.astype(np.float32).tobytes())
    return out


def _attr_float(name: str, v: float) -> bytes:
    return _str_field(1, name) + _field(2, 5, struct.pack("<f", v)) + \
        _field(20, 0, _varint(1))  # type FLOAT


def _node(op: str, inputs, outputs, attrs=b"") -> bytes:
    out = b""
    for i in inputs:
        out += _str_field(1, i)
    for o in outputs:
        out += _str_field(2, o)
    out += _str_field(4, op)
    if attrs:
        out += _field(5, 2, attrs)
    return out


def _model(nodes, inits, name="g") -> bytes:
    graph = b"".join(_field(1, 2, n) for n in nodes)
    graph += b"".join(_field(5, 2, _tensor_proto(k, a))
                      for k, a in inits.items())
    graph += _str_field(2, name)
    return _field(1, 0, _varint(8)) + _field(7, 2, graph)


def build_onnx_bytes(convs, bns):
    """Serialize graph: conv1 -> bn1 -> conv2 (no bn) as a ModelProto."""
    inits, nodes = {}, []
    w1, b1 = convs[0]
    inits["w1"], inits["b1"] = w1, b1
    nodes.append(_node("Conv", ["x", "w1", "b1"], ["c1"]))
    g, be, m, v = bns[0]
    inits.update({"g1": g, "be1": be, "m1": m, "v1": v})
    nodes.append(_node("BatchNormalization",
                       ["c1", "g1", "be1", "m1", "v1"], ["n1"],
                       attrs=_attr_float("epsilon", 1e-5)))
    nodes.append(_node("Relu", ["n1"], ["r1"]))
    w2, _ = convs[1]
    inits["w2"] = w2
    nodes.append(_node("Conv", ["r1", "w2"], ["y"]))
    return _model(nodes, inits, "tiny")


def write_checkpoint_onnx(tree, order, path, dfl: bool = False):
    """An ONNX file holding a Flax-layout params tree: one Conv (OIHW
    kernel, bias) or Gemm (``(in, out)`` weight) per entry of ``order``
    (``forward_param_order``), chained in that order, with a Relu between
    layers and, with ``dfl``, the detector's fixed arange(16) DFL conv at
    the end. The import gives back the tree's arrays bit for bit."""
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
    path.write_bytes(_model(nodes, inits, "checkpoint"))
    return path


def checkpoint_onnx(name: str, path):
    """The committed YOLOv8n (``name="yolo"``) or ReID checkpoint written as
    an ONNX file at ``path``."""
    src, net, x = {
        "yolo": (config.YOLO_SYNTHETIC_PATH, YOLOv8("n"),
                 torch.zeros(1, 3, 64, 64)),
        "reid": (config.REID_SYNTHETIC_PATH, ReIDNet(512),
                 torch.zeros(1, 128, 64, 3))}[name]
    return write_checkpoint_onnx(params.load_flax_msgpack(src),
                                 timp.forward_param_order(net, x), path,
                                 dfl=name == "yolo")


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def assert_trees_equal(ours, ref):
    a, b = dict(_leaves(ours)), dict(_leaves(ref))
    assert set(a) == set(b)
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg="/".join(k))


def _jax_template(model, shape):
    template = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                              jnp.zeros(shape))
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), template)


def _same_nodes(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert (a.op_type, a.inputs, a.outputs, a.name) == \
            (b.op_type, b.inputs, b.outputs, b.name)
        assert set(a.attrs) == set(b.attrs)


def _same_pairs(ours, ref):
    assert len(ours) == len(ref)
    for (wa, ba), (wb, bb) in zip(ours, ref):
        np.testing.assert_array_equal(wa, wb)
        np.testing.assert_array_equal(ba, bb)
        assert wa.dtype == wb.dtype and ba.dtype == bb.dtype


# --- fixtures -------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_bn(tmp_path_factory):
    rng = np.random.RandomState(0)
    w1 = rng.randn(8, 3, 3, 3).astype(np.float32) * 0.2
    b1 = rng.randn(8).astype(np.float32) * 0.1
    w2 = rng.randn(4, 8, 1, 1).astype(np.float32) * 0.2
    bn = (rng.uniform(0.5, 1.5, 8).astype(np.float32),
          rng.uniform(-0.3, 0.3, 8).astype(np.float32),
          rng.uniform(-0.5, 0.5, 8).astype(np.float32),
          rng.uniform(0.5, 2.0, 8).astype(np.float32))
    path = tmp_path_factory.mktemp("onnx") / "tiny.onnx"
    path.write_bytes(build_onnx_bytes([(w1, b1), (w2, None)], [bn]))
    return path


@pytest.fixture(scope="module")
def nets():
    """(port module, JAX module, JAX zero template, example input NHWC)
    for YOLOv8n and the ReID net."""
    return {
        "yolo": (YOLOv8("n"), JYOLO(variant="n", dtype=jnp.float32),
                 _jax_template(JYOLO(variant="n"), (1, 64, 64, 3)),
                 (1, 64, 64, 3)),
        "reid": (ReIDNet(512), JReID(dtype=jnp.float32),
                 _jax_template(JReID(), (1, 128, 64, 3)), (1, 128, 64, 3)),
        # a 512 -> 256 Dense head: the Gemm path
        "reid_fc": (ReIDNet(256), JReID(feature_dim=256, dtype=jnp.float32),
                    _jax_template(JReID(feature_dim=256), (1, 128, 64, 3)),
                    (1, 128, 64, 3)),
    }


def _port_example(name, shape):
    x = torch.zeros(shape)
    return x.permute(0, 3, 1, 2) if name == "yolo" else x


N_LAYERS = {"yolo": 63, "reid": 20, "reid_fc": 21}


@pytest.fixture(scope="module")
def orders(nets):
    """Forward order of both packages' nets."""
    out = {}
    for name, (tm, jm, _, shape) in nets.items():
        out[name] = (timp.forward_param_order(tm, _port_example(name, shape)),
                     jimp.forward_param_order(jm, jnp.zeros(shape)))
    return out


@pytest.fixture(scope="module")
def random_files(nets, orders, tmp_path_factory):
    """Per net: an ONNX file of random weights in forward order (the
    detector's with the DFL conv), from the JAX template's shapes."""
    rng = np.random.RandomState(7)
    d = tmp_path_factory.mktemp("nets")
    out = {}
    for name, (_, _, template, _) in nets.items():
        tree = jax.tree.map(
            lambda a: (rng.randn(*a.shape) * 0.1).astype(np.float32),
            template)
        out[name] = write_checkpoint_onnx(tree, orders[name][1],
                                          d / f"{name}.onnx",
                                          dfl=name == "yolo")
    return out


# --- parser and extractors --------------------------------------------------


def test_parser_and_extractors_match_jax_on_the_bn_file(tiny_bn):
    nodes, inits = timp.parse_onnx(tiny_bn)
    jnodes, jinits = jimp.parse_onnx(tiny_bn)
    _same_nodes(nodes, jnodes)
    assert [n.op_type for n in nodes] == ["Conv", "BatchNormalization",
                                          "Relu", "Conv"]
    assert nodes[1].attrs["epsilon"] == jnodes[1].attrs["epsilon"]
    assert set(inits) == set(jinits)
    for k in inits:
        np.testing.assert_array_equal(inits[k], jinits[k])
    convs = timp.extract_conv_weights(nodes, inits)
    assert len(convs) == 2            # BN folded into the first
    _same_pairs(convs, jimp.extract_conv_weights(jnodes, jinits))


@pytest.mark.parametrize("name", ["yolo", "reid"])
def test_parser_toposort_and_extractors_match_jax(name, random_files):
    nodes, inits = timp.parse_onnx(random_files[name])
    jnodes, jinits = jimp.parse_onnx(random_files[name])
    _same_nodes(nodes, jnodes)
    for rev in (False, True):
        order = list(reversed(nodes)) if rev else nodes
        jorder = list(reversed(jnodes)) if rev else jnodes
        sorted_ = timp.toposort_nodes(order, inits)
        _same_nodes(sorted_, jimp.toposort_nodes(jorder, jinits))
        _same_pairs(timp.extract_conv_weights(sorted_, inits),
                    jimp.extract_conv_weights(
                        jimp.toposort_nodes(jorder, jinits), jinits))
    convs = timp.extract_conv_weights(nodes, inits)
    assert len(convs) == 20 if name == "reid" else 63     # DFL skipped


def test_gemm_extraction_and_dfl_rule_match_jax(tmp_path):
    rng = np.random.RandomState(3)
    w = rng.randn(4, 3, 3, 3).astype(np.float32)
    gw = rng.randn(8, 16).astype(np.float32)
    gb = rng.randn(8).astype(np.float32)
    mw = rng.randn(16, 5).astype(np.float32)
    nodes = [_node("Conv", ["x", "w", ""], ["c"]),
             _node("Gemm", ["c", "gw", "gb"], ["y"],
                   attrs=_str_field(1, "transB") + _field(3, 0, _varint(1))),
             _node("MatMul", ["y", "mw"], ["z"])]
    path = tmp_path / "gemm.onnx"
    path.write_bytes(_model(nodes, {"w": w, "gw": gw, "gb": gb, "mw": mw}))
    tn, ti = timp.parse_onnx(path)
    jn, ji = jimp.parse_onnx(path)
    _same_pairs(timp.extract_gemm_weights(tn, ti),
                jimp.extract_gemm_weights(jn, ji))
    (w0, _), _ = timp.extract_gemm_weights(tn, ti)
    np.testing.assert_array_equal(w0, gw.T)          # transB: (in, out)
    for arr in (np.arange(16, dtype=np.float32).reshape(1, 16, 1, 1),
                rng.randn(1, 16, 1, 1).astype(np.float32),
                np.arange(16, dtype=np.float32).reshape(16, 1, 1, 1)):
        assert timp.is_dfl_conv_weight(arr) == jimp.is_dfl_conv_weight(arr)


def test_malformed_files_raise(tmp_path, tiny_bn):
    for name, data in (("garbage", np.random.RandomState(0).bytes(4096)),
                       ("empty", b""),
                       ("torn", tiny_bn.read_bytes()[:200])):
        p = tmp_path / f"{name}.onnx"
        p.write_bytes(data)
        with pytest.raises(ValueError):
            timp.import_conv_net_params(
                p, params.flax_tree(ReIDNet(512)), ReIDNet(512),
                torch.zeros(1, 128, 64, 3))


# --- forward order and the import ---------------------------------------------


@pytest.mark.parametrize("name", ["yolo", "reid", "reid_fc"])
def test_forward_param_order_equals_jax(name, orders):
    ours, ref = orders[name]
    assert ours == [(tuple(p), k) for p, k in ref]
    assert ours[0] == ((("backbone", "stem", "conv") if name == "yolo"
                        else ("stem", "conv")), "conv")
    # a walk of the module names would not give it: the head's box branch
    # runs before its class branch, the neck after the backbone's SPPF
    assert len(ours) == N_LAYERS[name]


@pytest.mark.parametrize("name", ["yolo", "reid", "reid_fc"])
def test_import_equals_jax_import(name, nets, random_files):
    tm, jm, template, shape = nets[name]
    # JAX's per-net entry points are both import_conv_net_params
    jfn = (jimp.import_yolo_params if name == "yolo"
           else jimp.import_reid_params)
    ours = timp.import_conv_net_params(random_files[name],
                                       params.flax_tree(tm), tm,
                                       _port_example(name, shape))
    ref = jfn(random_files[name], template, model=jm,
              example_input=jnp.zeros(shape))
    assert_trees_equal(ours, ref)


def test_count_mismatch_aborts(random_files):
    with pytest.raises(ValueError, match="conv count mismatch"):
        timp.import_conv_net_params(random_files["reid"],
                                    params.flax_tree(YOLOv8("n")),
                                    YOLOv8("n"), torch.zeros(1, 3, 64, 64))
    with pytest.raises(ValueError, match="dense count mismatch"):
        net = ReIDNet(256)                # a 512 -> 256 Dense head
        timp.import_conv_net_params(random_files["reid"],
                                    params.flax_tree(net), net,
                                    torch.zeros(1, 128, 64, 3))


@pytest.fixture(scope="module")
def real_export(tmp_path_factory):
    """Files from torch's real (TorchScript) ONNX exporter, through the
    mirrors of ``tests/test_onnx_real_exporter.py``: skipped exactly where
    that file skips (its module-level check of the exporter's private
    path)."""
    real = pytest.importorskip("test_onnx_real_exporter")
    d = tmp_path_factory.mktemp("real")
    ty = real.TYOLOv8(input_hw=(128, 128))
    real._randomize(ty, 0)
    real._export(ty, torch.zeros(1, 3, 128, 128), d / "yolov8n.onnx")
    tr = real.TReIDNet()
    real._randomize(tr, 1)
    real._export(tr, torch.zeros(1, 3, 128, 64), d / "reid.onnx")
    return {"yolo": (ty, d / "yolov8n.onnx"), "reid": (tr, d / "reid.onnx")}


@pytest.mark.parametrize("name", ["yolo", "reid"])
def test_real_exporter_file(name, real_export, nets):
    """Parse, extraction and import equal JAX's on the exporter's file, and
    the imported module reproduces the exported net's outputs."""
    mirror, path = real_export[name]
    tm, jm, template, shape = nets[name]
    nodes, inits = timp.parse_onnx(path)
    jnodes, jinits = jimp.parse_onnx(path)
    _same_nodes(nodes, jnodes)
    _same_pairs(timp.extract_conv_weights(nodes, inits),
                jimp.extract_conv_weights(jnodes, jinits))
    hw = (128, 128) if name == "yolo" else (128, 64)
    ours = timp.import_conv_net_params(path, params.flax_tree(tm), tm,
                                       _port_example(name, shape))
    ref = jimp.import_conv_net_params(path, _jax_template(jm, (1, *hw, 3)),
                                      model=jm,
                                      example_input=jnp.zeros((1, *hw, 3)))
    assert_trees_equal(ours, ref)
    net = YOLOv8("n") if name == "yolo" else ReIDNet(512)
    params.load_state_strict(net, params._state_dict_from_flax(ours))
    x = np.random.RandomState(3).rand(2, *hw, 3).astype(np.float32)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        if name == "yolo":
            got = net(xt)
            want = mirror.levels(xt)
            for (fr, fc), (tr, tc) in zip(got, want):
                np.testing.assert_allclose(fr.numpy(), tr.permute(
                    0, 2, 3, 1).numpy(), rtol=1e-3, atol=2e-3)
                np.testing.assert_allclose(fc.numpy(), tc.permute(
                    0, 2, 3, 1).numpy(), rtol=1e-3, atol=2e-3)
        else:
            np.testing.assert_allclose(net(torch.from_numpy(x)).numpy(),
                                       mirror(xt).numpy(), rtol=1e-3,
                                       atol=1e-3)


# --- .onnx weights in the loaders, the facades and the CLI -------------------


@pytest.fixture(scope="module")
def checkpoint_files(tmp_path_factory):
    """The committed checkpoints written as ONNX files."""
    d = tmp_path_factory.mktemp("ckpt")
    return {name: checkpoint_onnx(name, d / f"{name}.onnx")
            for name in ("yolo", "reid")}


LOADERS = {"yolo": (params.resolve_yolo_params, config.YOLO_SYNTHETIC_PATH),
           "reid": (params.resolve_reid_params, config.REID_SYNTHETIC_PATH)}


@pytest.mark.parametrize("name", ["yolo", "reid"])
def test_onnx_weights_load_bitwise(name, checkpoint_files):
    loader, msgpack = LOADERS[name]
    a = loader(weights_path=str(checkpoint_files[name]), device="cpu")
    b = loader(weights_path=str(msgpack), device="cpu")
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb
        assert torch.equal(va, vb), ka


def test_default_onnx_caches_and_explicit_path_does_not(
        checkpoint_files, tmp_path, monkeypatch):
    msgpack = tmp_path / "reid.msgpack"
    monkeypatch.setattr(config, "REID_PARAMS_PATH", msgpack)
    monkeypatch.setattr(config, "REID_ONNX_PATH", tmp_path / "none.onnx")
    with pytest.warns(UserWarning, match="seeded random init"):
        params.resolve_reid_params(device="cpu")
    explicit = params.resolve_reid_params(
        weights_path=str(checkpoint_files["reid"]), device="cpu")
    assert not msgpack.exists()          # an explicit path never caches
    monkeypatch.setattr(config, "REID_ONNX_PATH", checkpoint_files["reid"])
    imported = params.resolve_reid_params(device="cpu")
    assert msgpack.exists()              # the default location does
    cached = params.resolve_reid_params(device="cpu")   # from the cache
    for m in (imported, cached):
        for k, v in explicit.state_dict().items():
            assert torch.equal(m.state_dict()[k], v), k
    ref = params.load_flax_msgpack(config.REID_SYNTHETIC_PATH)
    assert_trees_equal(params.load_flax_msgpack(msgpack), ref)
    with pytest.raises(FileNotFoundError):
        params.resolve_reid_params(weights_path=str(tmp_path / "x.onnx"),
                                   device="cpu")


def test_facades_and_cli_load_onnx(checkpoint_files, tmp_path):
    from aicamera_tpu_torch import cli
    from aicamera_tpu_torch.detector import YOLODetector
    from aicamera_tpu_torch.scenes import moving_rectangles
    from aicamera_tpu_torch.tracker_api import ReIDModel
    frames = moving_rectangles(4, (96, 128), n_objects=3, seed=3)
    kw = dict(input_shape=(128, 128), device="cpu", detect_dtype="f32")
    onnx_det = YOLODetector(str(checkpoint_files["yolo"]), **kw)
    ref_det = YOLODetector(str(config.YOLO_SYNTHETIC_PATH), **kw)
    n = 0
    for f in frames:
        got, want = onnx_det.detect(f), ref_det.detect(f)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        n += len(got[0])
    assert n > 0
    onnx_reid = ReIDModel(str(checkpoint_files["reid"]), device="cpu")
    ref_reid = ReIDModel(str(config.REID_SYNTHETIC_PATH), device="cpu")
    crops = [frames[0][10:60, 10:50], frames[0][20:90, 60:120]]
    np.testing.assert_array_equal(onnx_reid.extract_features_batched(crops),
                                  ref_reid.extract_features_batched(crops))

    clip = tmp_path / "clip.npy"
    np.save(clip, moving_rectangles(8, (96, 128), n_objects=3, seed=3))
    outs = []
    for yolo, reid in ((checkpoint_files["yolo"], checkpoint_files["reid"]),
                       (config.YOLO_SYNTHETIC_PATH,
                        config.REID_SYNTHETIC_PATH)):
        ckpt = tmp_path / f"state_{len(outs)}.msgpack"
        cli.main(["--input", str(clip), "--device", "cpu", "--no_save",
                  "--input_shape", "128", "--chunk_size", "2",
                  "--yolo_weights", str(yolo), "--reid_weights", str(reid),
                  "--checkpoint", str(ckpt)])
        outs.append(ckpt.read_bytes())
    assert outs[0] == outs[1]          # the same tracker state, bit for bit
