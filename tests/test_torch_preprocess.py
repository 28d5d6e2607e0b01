"""Port: letterbox geometry, the plain letterbox (the kernel's CPU version)
against the JAX preprocess and the Pallas kernel, box unscaling, and the
kernel wrapper's argument checks."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aicamera_tpu.ops import preprocess as jprep  # noqa: E402
from aicamera_tpu_torch.ops import letterbox as tlb  # noqa: E402
from aicamera_tpu_torch.ops import preprocess as tprep  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    PyTorch's thread pool oversubscribes the cores (small convolutions then
    run ~100x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# The kernel phase's geometries: (src_hw, dst_hw, auto).
GEOMETRIES = [
    ((540, 960), (640, 640), False),
    ((720, 1280), (640, 640), False),
    ((1080, 1920), (640, 640), False),
    ((640, 640), (640, 640), False),    # identity: no resize, no rounding
    ((240, 320), (640, 640), False),    # pad only: no scale-up
    ((540, 960), (640, 640), True),     # auto canvas 384x640
]


def _frame(hw, seed):
    return np.random.RandomState(seed).randint(0, 256, (*hw, 3), np.uint8)


@pytest.mark.parametrize("src", [(540, 960), (720, 1280), (1080, 1920),
                                 (101, 640), (100, 200), (640, 640),
                                 (480, 640), (1000, 333), (37, 1999)])
@pytest.mark.parametrize("mode", ["square", "auto", "scale_fill", "scaleup"])
def test_letterbox_spec_matches_jax(src, mode):
    kw = {"auto": mode == "auto", "scale_fill": mode == "scale_fill",
          "scaleup": mode == "scaleup"}
    for dst in ((640, 640), (384, 640), (128, 128)):
        a = jprep.letterbox_spec(src, dst, **kw)
        b = tprep.letterbox_spec(src, dst, **kw)
        assert dataclass_tuple(a) == dataclass_tuple(b)
        assert (a.bottom, a.right) == (b.bottom, b.right)


def dataclass_tuple(s):
    return (s.src_hw, s.dst_hw, s.ratio, s.unpad_hw, s.pad_wh, s.top,
            s.left, s.out_hw)


@pytest.mark.parametrize("dst,src", [(360, 540), (640, 960), (360, 1080),
                                     (640, 1920), (7, 3), (3, 7), (5, 5),
                                     (128, 54), (1, 9)])
def test_resize_taps_equal_the_dense_jax_weights(dst, src):
    """The taps rebuild the JAX dense bilinear matrix bit for bit
    (tolerance: bitwise), including clamped and exact-integer coordinates."""
    i0, i1, w0, w1 = tprep.resize_taps(dst, src)
    dense = np.zeros((dst, src), np.float32)
    rows = np.arange(dst)
    dense[rows, i0] += w0
    dense[rows, i1] += w1
    np.testing.assert_array_equal(dense, jprep._resize_weights(dst, src))
    assert ((w1 == 0) | (i1 == i0 + 1)).all()


@pytest.mark.parametrize("src,dst,auto", GEOMETRIES)
def test_plain_letterbox_matches_jax_preprocess(src, dst, auto):
    """Tolerance: one uint8 step (1/255). The JAX version sums a dense
    matrix product (its CPU dot may fuse multiply-adds); the plain version
    rounds each product and sum, so a value at .5 can round the other way."""
    frame = _frame(src, seed=src[0])
    js = jprep.letterbox_spec(src, dst, auto=auto)
    ts = tprep.letterbox_spec(src, dst, auto=auto)
    ref = np.asarray(jax.jit(lambda f: jprep.preprocess_yolo(
        f, js, jnp.float32))(jnp.asarray(frame)))
    ours = tprep.preprocess_yolo(torch.from_numpy(frame), ts).numpy()
    assert ours.shape == ref.shape == (1, *ts.out_hw, 3)
    diff = np.abs(ours - ref)
    print(f"{src}->{ts.out_hw}: max |diff| {diff.max() * 255:.3f}/255, "
          f"share off by >= one grey level {np.mean(diff > 0.5 / 255):.2e}, "
          f"share off by an ulp or more {np.mean(diff > 0):.2e}")
    assert diff.max() <= 1.0 / 255.0 + 1e-7
    if ts.unpad_hw == ts.src_hw:
        # identity: same pixels; XLA turns the division by 255 into a
        # multiplication by its reciprocal, one f32 ulp away at most
        np.testing.assert_allclose(ours, ref, rtol=2.0 ** -23, atol=0)


@pytest.mark.parametrize("src,dst", [((54, 96), (64, 64)),
                                     ((16, 128), (192, 128)),
                                     ((270, 480), (320, 320))])
def test_plain_letterbox_matches_pallas_kernel(src, dst):
    """Against the TPU kernel in interpret mode. Tolerance: one uint8 step,
    the bound the Pallas kernel itself meets against the XLA version."""
    from aicamera_tpu.ops.pallas_preprocess import preprocess_yolo_pallas
    from jax.experimental.pallas import tpu as pltpu
    frame = _frame(src, seed=7)
    js = jprep.letterbox_spec(src, dst)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(preprocess_yolo_pallas(jnp.asarray(frame), js,
                                                jnp.float32))
    ours = tprep.preprocess_yolo(torch.from_numpy(frame),
                                 tprep.letterbox_spec(src, dst)).numpy()
    assert np.abs(ours - ref).max() <= 1.0 / 255.0 + 1e-7


def test_letterbox_batches_and_bf16():
    """(K, H, W, 3) -> (K, 3, Dh, Dw): each frame equals its own
    preprocess_yolo (tolerance: bitwise); bf16 is the f32 result rounded."""
    frames = np.stack([_frame((54, 96), s) for s in range(3)])
    spec = tprep.letterbox_spec((54, 96), (64, 64))
    out = tlb.letterbox(torch.from_numpy(frames), spec)
    assert out.shape == (3, 3, 64, 64) and out.dtype == torch.float32
    for i in range(3):
        single = tprep.preprocess_yolo(torch.from_numpy(frames[i]), spec)
        assert torch.equal(out[i], single[0].permute(2, 0, 1))
    bf = tlb.letterbox(torch.from_numpy(frames), spec, torch.bfloat16)
    assert torch.equal(bf, out.to(torch.bfloat16))
    # pad rows are exactly 114/255 in f32
    assert torch.all(out[:, :, :spec.top] == torch.tensor(114.0) / 255.0)


def test_scale_boxes_back_matches_jax():
    rng = np.random.RandomState(3)
    boxes = rng.uniform(-50, 700, (5, 40, 4)).astype(np.float32)
    for src, dst, auto in GEOMETRIES:
        js = jprep.letterbox_spec(src, dst, auto=auto)
        ts = tprep.letterbox_spec(src, dst, auto=auto)
        ref = np.asarray(jprep.scale_boxes_back(jnp.asarray(boxes), js))
        ours = tprep.scale_boxes_back(torch.from_numpy(boxes), ts).numpy()
        np.testing.assert_array_equal(ours, ref)  # tolerance: bitwise


def test_wrapper_checks_arguments_and_routes_cpu_to_plain():
    spec = tprep.letterbox_spec((54, 96), (64, 64))
    good = torch.zeros((2, 54, 96, 3), dtype=torch.uint8)
    launches = tlb.KERNEL.launches
    assert tlb.letterbox(good, spec).shape == (2, 3, 64, 64)
    assert tlb.KERNEL.launches == launches  # the plain version ran
    with pytest.raises(TypeError):
        tlb.letterbox(good.float(), spec)
    with pytest.raises(ValueError):
        tlb.letterbox(good[0], spec)                       # not 4-D
    with pytest.raises(ValueError):
        tlb.letterbox(good[..., :2], spec)                 # not 3 channels
    with pytest.raises(ValueError):
        tlb.letterbox(torch.zeros((2, 50, 96, 3), dtype=torch.uint8), spec)
    with pytest.raises(ValueError):
        tlb.letterbox(good.transpose(1, 2).contiguous().transpose(1, 2),
                      spec)                                # not contiguous
    with pytest.raises(TypeError):
        tlb.letterbox(good, spec, torch.float16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tlb.KERNEL(good, spec, torch.float32)   # no plain fallback inside
    assert tlb.KERNEL.launches == launches
