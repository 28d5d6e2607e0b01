"""Port: msgpack reader, Flax -> PyTorch weight mapping, import hygiene.

The reader must decode the committed Flax checkpoints exactly as
``flax.serialization.msgpack_restore`` does (bitwise, leaf by leaf), and the
port must import nothing of JAX, Flax, msgpack, cv2 or the JAX package.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from aicamera_tpu_torch import config  # noqa: E402
from aicamera_tpu_torch.models import ReIDNet, YOLOv8  # noqa: E402
from aicamera_tpu_torch.runtime import params  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    PyTorch's thread pool oversubscribes the cores (small convolutions then
    run ~100x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]
PORT_DIR = ROOT / "aicamera_tpu_torch"
SMOKE = ROOT / "chip_smoke.py"
CHECKPOINTS = [*config.COMMITTED_CHECKPOINTS["yolo"],
               *config.COMMITTED_CHECKPOINTS["reid"]]
FORBIDDEN = ("jax", "jaxlib", "flax", "msgpack", "cv2", "aicamera_tpu")


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("path", CHECKPOINTS, ids=lambda p: p.name)
def test_reader_matches_flax_msgpack_restore(path):
    from flax import serialization
    data = path.read_bytes()
    ours = dict(_leaves(params.read_flax_msgpack(data)))
    ref = dict(_leaves(serialization.msgpack_restore(data)))
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        np.testing.assert_array_equal(ours[k], v)  # tolerance: bitwise


def test_reader_covers_the_msgpack_subset():
    """Every type family Flax can write, against the msgpack package's
    encoder, including the multi-byte length forms."""
    import msgpack
    from flax import serialization
    obj = {
        "nil": None, "t": True, "f": False,
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32,
                 -33, -128, -129, -32768, -32769, -2**31 - 1],
        "floats": [0.5, -1e300],
        "s": "x" * 40, "s16": "y" * 300, "b": b"\x00\x01\x02",
        "arr16": list(range(20)), "map16": {str(i): i for i in range(20)},
        "nd": np.arange(6, dtype=np.int16).reshape(2, 3),
        "scalar": np.float32(2.5),
    }
    data = serialization.msgpack_serialize(obj)
    ours = params.read_flax_msgpack(data)
    ref = serialization.msgpack_restore(data)
    assert ours.keys() == ref.keys()
    for k in ref:
        if isinstance(ref[k], np.ndarray):
            np.testing.assert_array_equal(ours[k], ref[k])
            assert ours[k].dtype == ref[k].dtype
        else:
            assert ours[k] == ref[k], k
    with pytest.raises(ValueError):
        params.read_flax_msgpack(msgpack.packb(1) + b"\x00")  # trailing


@pytest.mark.parametrize("path", CHECKPOINTS, ids=lambda p: p.name)
def test_committed_checkpoints_load_strictly(path):
    tree = params.load_flax_msgpack(path)
    if path in config.COMMITTED_CHECKPOINTS["yolo"]:
        model, convert = YOLOv8("n"), params.yolo_state_dict_from_flax
    else:
        model, convert = ReIDNet(), params.reid_state_dict_from_flax
    state = convert(tree)
    params.load_state_strict(model, state)
    # every leaf consumed, conv kernels HWIO -> OIHW
    assert len(state) == len(list(_leaves(tree)))
    k = tree["params"]["stem"]["conv"]["kernel"] if "stem" in tree["params"] \
        else tree["params"]["backbone"]["stem"]["conv"]["kernel"]
    w = (model.stem.conv.weight if isinstance(model, ReIDNet)
         else model.backbone.stem.conv.weight)
    np.testing.assert_array_equal(w.detach().numpy(),
                                  k.transpose(3, 2, 0, 1))


def test_strict_load_rejects_missing_extra_and_misshaped():
    tree = params.load_flax_msgpack(config.REID_SYNTHETIC_PATH)
    state = params.reid_state_dict_from_flax(tree)
    missing = dict(state)
    missing.pop("block0.cv2.weight")
    with pytest.raises(KeyError):
        params.load_state_strict(ReIDNet(), missing)
    extra = dict(state, **{"block9.cv1.conv.bias": torch.zeros(3)})
    with pytest.raises(KeyError):
        params.load_state_strict(ReIDNet(), extra)
    bad = dict(state, **{"stem.conv.bias": torch.zeros(3)})
    with pytest.raises(ValueError):
        params.load_state_strict(ReIDNet(), bad)


def test_dense_kernel_is_transposed():
    tree = {"params": {"fc": {"kernel": np.arange(6, dtype=np.float32)
                              .reshape(2, 3), "bias": np.zeros(3)}}}
    state = params.reid_state_dict_from_flax(tree)
    np.testing.assert_array_equal(state["fc.weight"].numpy(),
                                  tree["params"]["fc"]["kernel"].T)


def test_missing_default_weights_warn_and_seed(tmp_path, monkeypatch):
    monkeypatch.setattr(config, "REID_PARAMS_PATH", tmp_path / "none.msgpack")
    with pytest.warns(UserWarning, match="seeded random init"):
        a = params.resolve_reid_params(device="cpu")
    with pytest.warns(UserWarning):
        b = params.resolve_reid_params(device="cpu")
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)  # deterministic from the seed
    with pytest.raises(FileNotFoundError):
        params.resolve_reid_params(weights_path=str(tmp_path / "x.msgpack"),
                                   device="cpu")
    # an .onnx file loads (it raised before ONNX import was ported)
    from test_torch_onnx_import import checkpoint_onnx
    onnx = params.resolve_reid_params(
        weights_path=str(checkpoint_onnx("reid", tmp_path / "x.onnx")),
        device="cpu")
    ref = params.resolve_reid_params(
        weights_path=str(config.REID_SYNTHETIC_PATH), device="cpu")
    for k, v in ref.state_dict().items():
        assert torch.equal(onnx.state_dict()[k], v)


LOADERS = [(params.resolve_yolo_params, config.YOLO_SYNTHETIC_PATH),
           (params.resolve_reid_params, config.REID_SYNTHETIC_PATH)]
LOADER_IDS = [f.__name__ for f, _ in LOADERS]


@pytest.mark.parametrize("loader,weights", LOADERS, ids=LOADER_IDS)
def test_loaders_default_to_the_gpu(loader, weights):
    """Without a ``device`` a loader runs on the GPU or raises; it never
    lands on the CPU silently."""
    if torch.cuda.is_available():
        p = next(loader(weights_path=str(weights)).parameters())
        assert p.device.type == "cuda" and p.dtype == torch.bfloat16
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            loader()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            loader(weights_path=str(weights))


@pytest.mark.parametrize("loader,weights", LOADERS, ids=LOADER_IDS)
def test_loaders_load_on_the_cpu_when_asked(loader, weights):
    model = loader(weights_path=str(weights), device="cpu")
    assert not model.training
    for p in model.parameters():
        assert p.device.type == "cpu" and p.dtype == torch.float32
    half = loader(weights_path=str(weights), device="cpu",
                  dtype=torch.bfloat16)
    assert next(half.parameters()).dtype == torch.bfloat16


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


# modules the scan and the blocked import below must reach
MUST_COVER = ("cli.py", "utils/__init__.py", "utils/video_io.py",
              "core/bytetrack.py", "core/ocsort.py", "runtime/checkpoint.py",
              "runtime/profiler.py", "runtime/pipeline.py", "detector.py",
              "tracker_api.py", "bytetrack_api.py", "botsort_api.py",
              "ocsort_api.py", "deepocsort_api.py", "strongsort_api.py",
              "ops/gmc.py", "ops/tiling.py", "parallel/__init__.py",
              "parallel/multistream.py", "serving.py", "server.py",
              "prng.py", "synthetic.py", "eval.py", "postprocess.py",
              "mot.py", "utils/png.py", "runtime/engine.py",
              "models/quant.py", "models/quant_yolo.py", "export_engines.py",
              "train.py", "train_synthetic.py", "models/onnx_import.py",
              "utils/visualization.py", "utils/jpeg.py", "utils/avi.py",
              "native/__init__.py", "ops/host_build.py",
              "parallel/distributed.py", "parallel/tensor_parallel.py",
              "parallel/pipeline_parallel.py", "ops/assignment.py")


# the examples' twins import neither the JAX package's examples nor its
# helpers (examples/_common.py)
EXAMPLES_FORBIDDEN = FORBIDDEN + ("examples",)
EXAMPLE_FILES = sorted((ROOT / "examples_torch").glob("*.py"))


def test_source_scan_finds_no_forbidden_import():
    files = sorted(PORT_DIR.rglob("*.py")) + [SMOKE]
    assert SMOKE.exists()
    assert {PORT_DIR / m for m in MUST_COVER} <= set(files)
    assert len(EXAMPLE_FILES) == 13   # the 12 examples and _common.py
    for f in files + EXAMPLE_FILES:
        forbidden = EXAMPLES_FORBIDDEN if f in EXAMPLE_FILES else FORBIDDEN
        bad = set(_imported_roots(f)) & set(forbidden)
        assert not bad, f"{f.relative_to(ROOT)} imports {bad}"


_BLOCKER = """
import importlib.abc, sys
FORBIDDEN = {forbidden!r}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
import importlib, pkgutil, runpy
import aicamera_tpu_torch

seen = set()
for m in pkgutil.walk_packages(aicamera_tpu_torch.__path__,
                               "aicamera_tpu_torch."):
    importlib.import_module(m.name)
    seen.add(m.name)
missing = set({must!r}) - seen
assert not missing, missing
from aicamera_tpu_torch.cli import main, parse_arguments
assert parse_arguments(["--input", "x.npy"]).device == "cuda"
from aicamera_tpu_torch.parallel import MultiStreamPipeline
from aicamera_tpu_torch.serving import (MultiTenantTrackingService,
                                        TrackingService)
from aicamera_tpu_torch.server import TrackingHTTPServer, main as serve
from aicamera_tpu_torch.mot import main as mot_main
from aicamera_tpu_torch.synthetic import TemporalWorld, WorldSpec
import numpy as np
from aicamera_tpu_torch.utils import jpeg, visualization
f = np.zeros((16, 24, 3), np.uint8)
visualization.draw_tracks(f, [(1, 1, 8, 8, 1, "person", 0.5)])
assert jpeg.decode_jpeg(jpeg.encode_jpeg(f)).shape == (16, 24, 3)
runpy.run_path({smoke!r}, run_name="chip_smoke_imported")
for name in {examples!r}:
    mod = importlib.import_module("examples_torch." + name)
    assert name == "_common" or callable(mod.main), name
print("IMPORT-OK")
"""


def test_imports_with_jax_and_the_jax_package_blocked():
    must = ["aicamera_tpu_torch." + m[:-3].replace("/", ".")
            for m in MUST_COVER if not m.endswith("__init__.py")]
    code = _BLOCKER.format(forbidden=EXAMPLES_FORBIDDEN, smoke=str(SMOKE),
                           must=must,
                           examples=[f.stem for f in EXAMPLE_FILES])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "IMPORT-OK" in out.stdout
