"""Port: ReID crop gather and ReIDNet against JAX at f32."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aicamera_tpu.models import ReIDNet as JaxReIDNet  # noqa: E402
from aicamera_tpu.ops.crops import extract_reid_crops as jcrops  # noqa: E402
from aicamera_tpu_torch import config  # noqa: E402
from aicamera_tpu_torch.models import ReIDNet  # noqa: E402
from aicamera_tpu_torch.ops.crops import extract_reid_crops  # noqa: E402
from aicamera_tpu_torch.runtime import params as tparams  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    PyTorch's thread pool oversubscribes the cores (small convolutions then
    run ~100x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


H, W = 90, 120


def _boxes(seed):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-20, 100, (10, 2))
    wh = rng.uniform(1, 60, (10, 2))
    boxes = np.concatenate([xy, xy + wh], 1)
    edge = np.array([
        [30.0, 20.0, 30.0, 50.0],     # empty: x1 == x2
        [30.7, 20.2, 31.4, 21.9],     # one pixel after truncation
        [-50.0, -40.0, -10.0, -5.0],  # fully outside: empty after clamp
        [W, 10.0, W + 30.0, 40.0],    # starts at the right edge: empty
        [0.0, H - 1.0, W, H + 5.0],   # one row at the bottom edge
        [5.0, 5.0, 6.0, 88.0],        # one column, tall
    ])
    return np.concatenate([boxes, edge]).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_crops_match_jax(seed):
    """Tolerance: 2e-5 on normalized values (|v| < 2.7). The JAX horizontal
    pass is a dense matrix product, the port its two non-zero taps; the sums
    agree to f32 rounding."""
    rng = np.random.RandomState(10 + seed)
    frames = rng.randint(0, 256, (2, H, W, 3), np.uint8)
    boxes = np.stack([_boxes(seed), _boxes(seed + 5)])
    ours, valid = extract_reid_crops(torch.from_numpy(frames),
                                     torch.from_numpy(boxes),
                                     compute_dtype=torch.float32)
    assert tuple(ours.shape) == (2, len(boxes[0]), 128, 64, 3)
    for i in range(2):
        ref, ref_valid = jcrops(jnp.asarray(frames[i]), jnp.asarray(boxes[i]),
                                compute_dtype=jnp.float32)
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(ref_valid))
        np.testing.assert_allclose(ours[i].numpy(), np.asarray(ref),
                                   atol=2e-5, rtol=0)
    # empty boxes are invalid and zero
    assert valid[0, -6:].tolist() == [False, True, False, False, True, True]
    assert torch.all(ours[0, -4] == 0) and torch.all(ours[0, -3] == 0)


def test_reid_features_match_flax_with_committed_weights():
    """Tolerance: 2e-5 on unit-norm 512-d features (17 f32 conv layers,
    summed in a different order by XLA:CPU and oneDNN)."""
    tree = tparams.load_flax_msgpack(config.REID_SYNTHETIC_PATH)
    x = np.random.RandomState(3).normal(0, 1, (3, 128, 64, 3)).astype(
        np.float32)
    ref = jax.jit(JaxReIDNet(dtype=jnp.float32).apply)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    model = ReIDNet()
    tparams.load_state_strict(model, tparams.reid_state_dict_from_flax(tree))
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
    assert ours.shape == (3, 512) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, np.asarray(ref), atol=2e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(ours, axis=1), 1.0, atol=1e-6)


def test_crops_then_features_match_jax():
    """Crops of a frame through the committed embedder, end to end."""
    tree = tparams.load_flax_msgpack(config.REID_SYNTHETIC_PATH)
    frame = np.random.RandomState(4).randint(0, 256, (1, H, W, 3), np.uint8)
    boxes = _boxes(2)[None, :4]
    jc, _ = jcrops(jnp.asarray(frame[0]), jnp.asarray(boxes[0]),
                   compute_dtype=jnp.float32)
    ref = jax.jit(JaxReIDNet(dtype=jnp.float32).apply)(
        jax.tree.map(jnp.asarray, tree), jc)
    model = ReIDNet()
    tparams.load_state_strict(model, tparams.reid_state_dict_from_flax(tree))
    crops, _ = extract_reid_crops(torch.from_numpy(frame),
                                  torch.from_numpy(boxes),
                                  compute_dtype=torch.float32)
    with torch.no_grad():
        ours = model(crops[0]).numpy()
    np.testing.assert_allclose(ours, np.asarray(ref), atol=5e-5, rtol=0)


def test_crop_dtype_follows_the_device_policy():
    frames = torch.zeros((1, 20, 20, 3), dtype=torch.uint8)
    boxes = torch.tensor([[[1.0, 1.0, 10.0, 10.0]]])
    crops, _ = extract_reid_crops(frames, boxes)
    assert crops.dtype == torch.float32  # CPU policy
    crops, _ = extract_reid_crops(frames, boxes, compute_dtype=torch.bfloat16)
    assert crops.dtype == torch.bfloat16
