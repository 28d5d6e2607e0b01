"""Port: YOLOv8 against Flax ``apply`` at f32, per level, NHWC."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aicamera_tpu.models import YOLOv8 as JaxYOLOv8  # noqa: E402
from aicamera_tpu.models import layers as jlayers  # noqa: E402
from aicamera_tpu.runtime.params import template_params  # noqa: E402
from aicamera_tpu_torch import config  # noqa: E402
from aicamera_tpu_torch.models import layers as tlayers  # noqa: E402
from aicamera_tpu_torch.models.yolov8 import YOLOv8  # noqa: E402
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


# Tolerance: both sides run the same f32 convolutions but sum them in a
# different order (XLA:CPU vs oneDNN), so outputs agree to f32 rounding
# grown over ~60 layers; logits are O(10).
ATOL, RTOL = 2e-4, 1e-4


def _compare(variant, flax_params, hw, seed):
    x = np.random.RandomState(seed).uniform(0, 1, (2, *hw, 3)).astype(
        np.float32)
    jm = JaxYOLOv8(variant=variant, dtype=jnp.float32)
    ref = jax.jit(jm.apply)(flax_params, jnp.asarray(x))
    tm = YOLOv8(variant=variant)
    tparams.load_state_strict(
        tm, tparams.yolo_state_dict_from_flax(jax.device_get(flax_params)))
    with torch.no_grad():
        ours = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(ours) == len(ref) == 3
    for (tb, tc), (jb, jc), stride in zip(ours, ref, (8, 16, 32)):
        h, w = hw[0] // stride, hw[1] // stride
        assert tuple(tb.shape) == (2, h, w, 64) == jb.shape
        assert tuple(tc.shape) == (2, h, w, 80) == jc.shape
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=ATOL,
                                   rtol=RTOL)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL,
                                   rtol=RTOL)


def test_yolov8n_committed_weights_match_flax():
    tree = tparams.load_flax_msgpack(config.YOLO_SYNTHETIC_PATH)
    _compare("n", jax.tree.map(jnp.asarray, tree), (96, 128), seed=0)


def test_yolov8s_template_params_match_flax():
    """A second width (s), from the JAX package's seeded template params."""
    fp = template_params(JaxYOLOv8(variant="s", dtype=jnp.float32),
                         jnp.zeros((1, 64, 64, 3), jnp.float32))
    _compare("s", fp, (64, 64), seed=1)


@pytest.mark.parametrize("variant", ["n", "s", "m", "l", "x"])
def test_variant_widths_match_flax_param_shapes(variant):
    """Every variant's module tree has exactly the Flax tree's leaves and
    shapes (checked without running either model)."""
    shapes = jax.eval_shape(
        JaxYOLOv8(variant=variant).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 64, 64, 3), jnp.float32))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    with torch.device("meta"):
        tm = YOLOv8(variant=variant)
    state = tparams.yolo_state_dict_from_flax(tree)
    own = tm.state_dict()
    assert set(own) == set(state)
    for k, v in state.items():
        assert tuple(own[k].shape) == tuple(v.shape), k


def test_channel_helpers_match():
    for v in (3.2, 8, 12.0, 47.9, 80, 640):
        assert tlayers.make_divisible(v) == jlayers.make_divisible(v)
    for w, mc in ((0.25, 1024), (0.75, 768), (1.25, 512)):
        base = [64, 128, 256, 512, 1024]
        assert tlayers.scale_channels(base, w, mc) == \
            jlayers.scale_channels(base, w, mc)


def test_sppf_pool_and_upsample_match_flax():
    """SPPF's 5x5/s1 max-pool pads with -inf as Flax SAME does; nearest 2x
    upsample duplicates pixels. Tolerance: bitwise."""
    from flax import linen as nn
    x = np.random.RandomState(2).normal(size=(2, 7, 9, 4)).astype(np.float32)
    x[:, 0, 0] = -50.0  # a border value below every interior neighbour
    ref = nn.max_pool(jnp.asarray(x), (5, 5), strides=(1, 1), padding="SAME")
    ours = torch.nn.functional.max_pool2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), 5, stride=1, padding=2)
    np.testing.assert_array_equal(ours.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(ref))
    up = tlayers.upsample2x(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(up.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jlayers.upsample2x(x)))
