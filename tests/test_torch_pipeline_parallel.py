"""Port: the stage-split detector (``parallel/pipeline_parallel.py``) on the
CPU, the counterparts of ``tests/test_pipeline_parallel.py``.

The ``devices=`` mode runs in this process; the composed ``meshes=`` mode
runs on a world of 4 gloo ranks (``parallel.distributed.spawn``, one
intra-op thread a rank, a join timeout), with stage meshes of different
stream sizes (2x2, 1x2 and 4x1), so that every hop re-splits the
microbatch. YOLOv8n (f32) at 64x64 from the port's seeded init.

Tolerances: the ``devices=`` mode is bitwise the full model (the same
modules on the same device). The composed mode is within rtol 1e-5 and
atol 1e-6 of it (a stage's convolutions then run on a quarter or half of
the microbatch; measured up to 6e-10 off). Against JAX's stage-split
detector in f32 with the same weights: within 2e-3 absolute (the two
packages' f32 conv stacks round differently).
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from aicamera_tpu_torch.models.yolov8 import YOLOv8  # noqa: E402
from aicamera_tpu_torch.parallel import (  # noqa: E402
    PipelineParallelDetector, distributed, split_stage_params)
from aicamera_tpu_torch.runtime.params import seeded_init_  # noqa: E402
from aicamera_tpu_torch.runtime.pipeline import precision  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model():
    m = YOLOv8("n")
    seeded_init_(m)
    return m.eval()


def _frames(b=4):
    """(B, 3, 64, 64) f32 in [0, 1] (tests/test_pipeline_parallel.py's
    inputs, NCHW)."""
    x = np.random.RandomState(0).rand(b, 64, 64, 3).astype(np.float32)
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def _full(model, x):
    with torch.no_grad(), precision(torch.float32):
        return model(x)


@pytest.fixture(scope="module")
def setup():
    model = _model()
    return model, _frames()


def _assert_levels_equal(a, b):
    assert len(a) == len(b) == 3
    for (a_box, a_cls), (b_box, b_cls) in zip(a, b):
        assert torch.equal(a_box, b_box) and torch.equal(a_cls, b_cls)


def test_stage_split_covers_full_param_tree(setup):
    model, _ = setup
    parts = split_stage_params(model)
    assert sum(len(p) for p in parts) == len(model.state_dict())
    for prefix, part in zip(("backbone", "neck", "head"), parts):
        for k, v in part.items():
            assert model.state_dict()[f"{prefix}.{k}"] is not None
            assert torch.equal(v, model.state_dict()[f"{prefix}.{k}"])


def test_matches_full_fused_forward(setup):
    model, x = setup
    pp = PipelineParallelDetector("n", devices=["cpu"] * 3)
    pp.place_params(model)
    _assert_levels_equal(pp.forward(x, microbatch=4), _full(model, x))


def test_multi_device_bitwise_matches_single_device(setup):
    model, x = setup
    multi = PipelineParallelDetector("n", devices=["cpu", "cpu", "cpu"])
    multi.place_params(model)
    single = PipelineParallelDetector("n", devices=["cpu"])
    single.place_params(model)
    _assert_levels_equal(multi.forward(x, microbatch=2),
                         single.forward(x, microbatch=2))


def test_microbatching_concatenates_in_order(setup):
    model, x = setup
    pp = PipelineParallelDetector("n", devices=["cpu"] * 3)
    pp.place_params(model)
    out = pp.forward(x, microbatch=2)
    h1, h2 = pp.forward(x[:2], microbatch=2), pp.forward(x[2:], microbatch=2)
    want = [(torch.cat([a[0], b[0]]), torch.cat([a[1], b[1]]))
            for a, b in zip(h1, h2)]
    _assert_levels_equal(out, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stage_placement(setup, dtype):
    model, x = setup
    pp = PipelineParallelDetector("n", devices=["cpu"] * 3, dtype=dtype)
    pp.place_params(model)
    for stage, dev in zip(pp._stages, pp.devices):
        for p in stage.parameters():
            assert p.device == dev and p.dtype == dtype
    out = pp.forward(x)
    assert all(t.dtype == dtype for lv in out for t in lv)


def test_outputs_feed_decode_nms(setup):
    from aicamera_tpu_torch.ops.nms import fused_decode_nms
    model, x = setup
    pp = PipelineParallelDetector("n", devices=["cpu"] * 3)
    pp.place_params(model)
    num, boxes, scores, labels = fused_decode_nms(
        pp.forward(x, microbatch=2), score_threshold=0.25,
        iou_threshold=0.45, top_k=64, max_det=16)
    assert boxes.shape == (4, 16, 4)
    assert num.shape == (4,)


def test_validation_errors(setup):
    model, x = setup
    pp = PipelineParallelDetector("n", devices=["cpu"] * 3)
    with pytest.raises(RuntimeError, match="place_params"):
        pp.forward(x, microbatch=2)
    pp.place_params(model)
    with pytest.raises(ValueError, match="not divisible"):
        pp.forward(x, microbatch=3)
    with pytest.raises(ValueError, match="at least one device"):
        PipelineParallelDetector("n", devices=[])


def test_composed_mesh_validation():
    good = SimpleNamespace(mesh_dim_names=("stream", "model"))
    bad = SimpleNamespace(mesh_dim_names=("x",))
    with pytest.raises(ValueError, match="stream"):
        PipelineParallelDetector("n", meshes=[bad])
    with pytest.raises(ValueError, match="not both"):
        PipelineParallelDetector("n", meshes=[good], devices=["cpu"])
    with pytest.raises(ValueError, match="at least one mesh"):
        PipelineParallelDetector("n", meshes=[])


def test_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU error cannot be shown")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PipelineParallelDetector("n")


def test_matches_jax_stage_split(setup):
    """JAX's PipelineParallelDetector (f32, three of its CPU devices) on
    the same weights and frames."""
    import jax
    import jax.numpy as jnp
    from aicamera_tpu.parallel import PipelineParallelDetector as JaxPP
    from aicamera_tpu_torch.runtime.params import flax_tree
    model, x = setup
    ref = JaxPP("n", devices=jax.devices()[:3], dtype=jnp.float32)
    ref.place_params(flax_tree(model))
    want = ref.forward(jnp.asarray(x.numpy().transpose(0, 2, 3, 1)),
                       microbatch=2)
    pp = PipelineParallelDetector("n", devices=["cpu"] * 3)
    pp.place_params(model)
    for got, exp in zip(pp.forward(x, microbatch=2), want):
        for a, b in zip(got, exp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-3,
                                       rtol=1e-4)


# --- the composed mode on 4 ranks --------------------------------------------

def _stage_meshes():
    """Three stage meshes of different stream sizes over ranks 0-3."""
    from torch.distributed.device_mesh import DeviceMesh
    names = ("stream", "model")
    return [DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                       mesh_dim_names=names),
            DeviceMesh("cpu", torch.tensor([[1, 3]]), mesh_dim_names=names),
            DeviceMesh("cpu", torch.tensor([[2], [0], [1], [3]]),
                       mesh_dim_names=names)]


def _composed_world(rank, device):
    from aicamera_tpu_torch.parallel.tensor_parallel import sharded_convs
    torch.set_num_threads(1)
    pp = PipelineParallelDetector("n", meshes=_stage_meshes())
    pp.place_params(_model())
    x = _frames(8)
    out = {"sharded": [None if s is None else sharded_convs(s)
                       for s in pp._stages]}
    distributed.COLLECTIVES.reset()
    out["default"] = [tuple(t.numpy() for t in lv) for lv in pp.forward(x)]
    out["collectives"] = dict(distributed.COLLECTIVES.by_kind)
    out["mb4"] = [tuple(t.numpy() for t in lv)
                  for lv in pp.forward(x[:4], microbatch=4)]
    try:
        pp.forward(x[:3], microbatch=3)
        out["error"] = None
    except ValueError as e:
        out["error"] = str(e)
    return out


@pytest.fixture(scope="module")
def composed():
    return distributed.spawn(_composed_world, 4, device="cpu", timeout=120.0)


def test_composed_stage_meshes_match_single_device(composed):
    """All three axes in one forward: stage x stream x model. Every rank
    gets the whole batch's outputs; with the default microbatch (4, the
    lcm of the stream sizes: two microbatches of the 8 frames) and with an
    explicit one."""
    model = _model()
    want8, want4 = _full(model, _frames(8)), _full(model, _frames(4))
    for rank in composed:
        for key, want in (("default", want8), ("mb4", want4)):
            for got, exp in zip(rank[key], want):
                for a, b in zip(got, exp):
                    np.testing.assert_allclose(a, b.numpy(), rtol=1e-5,
                                               atol=1e-6)


def test_composed_mode_is_channel_parallel_and_hops_rank_to_rank(composed):
    """Stage 0 (2x2) and stage 1 (1x2) split their convolutions over two
    model ranks; stage 2 (4x1) over none. A microbatch makes at most three
    hops (into the neck, into the head, out to every rank): one batch of
    sends and receives each, on the ranks that take part."""
    for rank, out in enumerate(composed):
        back, neck, head = out["sharded"]
        assert back == 27 and head == 0
        assert neck == (18 if rank in (1, 3) else None)
        kinds = out["collectives"]
        assert set(kinds) <= {"all_gather", "p2p"}
        assert 2 <= kinds["p2p"] <= 6
    assert composed[0]["collectives"]["all_gather"] == 2 * 27


def test_composed_microbatch_validation(composed):
    for out in composed:
        assert "stream" in out["error"]
