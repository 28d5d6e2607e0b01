"""Port: YOLOv8's memory layout (``models/layers.py``'s ``layout``).

bf16 weights and activations are held channels-last, f32 ones NCHW, on
every path that builds or converts a detector; the channels-last forward
equals the NCHW forward of the same weights; and the detector's layout
counter names C2f's first bottleneck as the only conv whose input is
copied dense."""

import copy

import pytest

torch = pytest.importorskip("torch")

from aicamera_tpu_torch import config  # noqa: E402
from aicamera_tpu_torch.models import layers  # noqa: E402
from aicamera_tpu_torch.models.yolov8 import YOLOv8  # noqa: E402
from aicamera_tpu_torch.runtime import params  # noqa: E402

NHWC, NCHW = torch.channels_last, torch.contiguous_format
# Tolerance: the same f32 convolutions, summed by oneDNN in its NHWC and
# its NCHW order: the largest difference over the largest output value
REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    PyTorch's thread pool oversubscribes the cores (small convolutions then
    run ~100x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seeded(variant):
    model = YOLOv8(variant)
    params.seeded_init_(model, seed=3)
    return model.eval()


def _weights_in(model, fmt) -> bool:
    convs = [p for p in model.parameters() if p.ndim == 4]
    return bool(convs) and all(p.is_contiguous(memory_format=fmt)
                               for p in convs)


def _c2f_split_halves(model):
    """The conv of each C2f's first bottleneck, which takes a channel
    slice of the block's ``cv1`` output."""
    return sorted(f"{name}.m0.cv1.conv" for name, mod in model.named_modules()
                  if isinstance(mod, layers.C2f))


def test_the_layout_follows_the_dtype():
    assert layers.layout(torch.bfloat16) == NHWC
    assert layers.layout(torch.float16) == NHWC
    assert layers.layout(torch.float32) == NCHW
    model = _seeded("n")
    assert _weights_in(model, NCHW)
    assert _weights_in(model.to(torch.bfloat16), NHWC)
    assert _weights_in(model.float(), NCHW)


@pytest.mark.parametrize("variant", ["n", "m"])
def test_channels_last_forward_equals_the_nchw_forward(variant, monkeypatch):
    model = _seeded(variant)
    x = torch.rand((2, 3, 64, 96), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = model(x)
    # the same module, its f32 weights laid out channels-last
    monkeypatch.setattr(layers, "CHANNELS_LAST_DTYPES", (torch.float32,))
    nhwc = copy.deepcopy(model).float()
    assert _weights_in(nhwc, NHWC)
    with torch.no_grad():
        ours = nhwc(x)
    # both copied the split halves dense in their layout (B = 2), no more
    assert sorted(model.relayouts) == sorted(nhwc.relayouts) \
        == _c2f_split_halves(model)
    scale = max(float(t.abs().max()) for level in want for t in level)
    for (box, cls), (wbox, wcls), stride in zip(ours, want, (8, 16, 32)):
        h, w = 64 // stride, 96 // stride
        assert tuple(box.shape) == (2, h, w, 64)
        assert tuple(cls.shape) == (2, h, w, 80)
        assert box.is_contiguous() and cls.is_contiguous()
        for got, exp in ((box, wbox), (cls, wcls)):
            assert float((got - exp).abs().max()) <= REL * scale


@pytest.mark.parametrize("variant", ["n", "m"])
def test_layout_counter_names_only_the_c2f_split_halves(variant):
    model = _seeded(variant).to(torch.bfloat16)
    n_convs = sum(isinstance(m, torch.nn.Conv2d) for m in model.modules())
    halves = _c2f_split_halves(model)
    assert len(halves) == 8
    assert (model.conv_calls, model.relayouts) == (0, {})
    x = torch.rand((1, 3, 64, 64), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        out = model(x)                    # NCHW f32, as the letterbox writes
    assert all(t.dtype == torch.bfloat16 and t.is_contiguous()
               for level in out for t in level)
    assert model.conv_calls == n_convs
    assert model.relayouts == {name: 1 for name in halves}
    with torch.no_grad():
        model(x.to(torch.bfloat16, memory_format=NHWC))  # already laid out
    assert model.conv_calls == 2 * n_convs
    assert model.relayouts == {name: 2 for name in halves}


def test_every_loader_lays_the_weights_out_by_dtype(tmp_path, monkeypatch):
    bf16 = torch.bfloat16
    # a Flax msgpack checkpoint
    path = str(config.YOLO_SYNTHETIC_PATH)
    assert _weights_in(params.resolve_yolo_params(weights_path=path,
                                                  device="cpu"), NCHW)
    ref = params.resolve_yolo_params(weights_path=path, device="cpu",
                                     dtype=bf16)
    assert _weights_in(ref, NHWC)
    # the seeded init
    monkeypatch.setattr(config, "YOLO_PARAMS_PATH", tmp_path / "none.msgpack")
    monkeypatch.setattr(config, "YOLO_ONNX_PATH", tmp_path / "none.onnx")
    with pytest.warns(UserWarning, match="seeded random init"):
        assert _weights_in(params.resolve_yolo_params(device="cpu",
                                                      dtype=bf16), NHWC)
    # an ONNX export, imported
    from test_torch_onnx_import import checkpoint_onnx
    onnx = params.resolve_yolo_params(
        weights_path=str(checkpoint_onnx("yolo", tmp_path / "y.onnx")),
        device="cpu", dtype=bf16)
    assert _weights_in(onnx, NHWC)
    for k, v in ref.state_dict().items():
        assert torch.equal(onnx.state_dict()[k], v), k
    # load_state_dict of NCHW-contiguous tensors keeps the module's layout
    model = YOLOv8("n").to(bf16)
    model.load_state_dict({k: v.contiguous()
                           for k, v in ref.state_dict().items()})
    assert _weights_in(model, NHWC)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flax_round_trip_is_bitwise(dtype):
    model = params.resolve_yolo_params(
        weights_path=str(config.YOLO_SYNTHETIC_PATH), device="cpu",
        dtype=dtype)
    back = params.yolo_state_dict_from_flax(params.flax_tree(model))
    own = model.state_dict()
    assert set(back) == set(own)
    for k, v in own.items():
        assert torch.equal(back[k].to(dtype), v), k
    # the tree read through the weights' logical shape: the checkpoint's
    if dtype == torch.float32:
        tree = params.load_flax_msgpack(config.YOLO_SYNTHETIC_PATH)
        for k, v in params.yolo_state_dict_from_flax(tree).items():
            assert torch.equal(back[k], v), k
