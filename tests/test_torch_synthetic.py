"""Port: threefry2x32 (``prng.py``) against ``jax.random``, and the synthetic
world (``synthetic.py``) against the JAX package's, on the same keys."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aicamera_tpu import synthetic as jsyn  # noqa: E402
from aicamera_tpu_torch import prng  # noqa: E402
from aicamera_tpu_torch import synthetic as tsyn  # noqa: E402

SEEDS = (0, 1, 4, 12345, 2**31 - 1, -7)
SHAPES = ((1,), (7,), (1000,), (3, 5, 2))


def _key(seed):
    return jax.random.PRNGKey(seed)


def _kd(key):
    return np.asarray(jax.random.key_data(key))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_bitwise(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed), _kd(_key(seed)))
    for n in (1, 2, 8, 4096):
        np.testing.assert_array_equal(
            prng.split(_kd(_key(seed)), n),
            np.asarray(jax.random.split(_key(seed), n)))


def test_seed_outside_int32_raises():
    with pytest.raises(ValueError, match="int32"):
        prng.PRNGKey(2**31)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_draws_bitwise(seed, shape):
    """bits, randint (the scenes' spans 5 and 12, an empty range), bernoulli
    and every uniform range whose span is a power of two: bitwise."""
    key, kd = _key(seed), _kd(_key(seed))
    np.testing.assert_array_equal(
        prng.random_bits(kd, shape, "cpu").numpy(),
        np.asarray(jax.random.bits(key, shape, jnp.uint32)).astype(np.int64))
    for lo, hi in ((0, 5), (6, 18), (0, 12), (3, 3)):
        got = prng.randint(kd, shape, lo, hi, "cpu")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax.random.randint(key, shape, lo, hi)))
    np.testing.assert_array_equal(
        prng.bernoulli(kd, 0.75, shape, "cpu").numpy(),
        np.asarray(jax.random.bernoulli(key, 0.75, shape)))
    for lo, hi in ((0.0, 1.0), (-1.0, 1.0), (0.0, 64.0)):
        got = prng.uniform(kd, shape, lo, hi, "cpu")
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(
            got.numpy(),
            np.asarray(jax.random.uniform(key, shape, minval=lo, maxval=hi)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_uniform_with_a_fused_scale_within_one_ulp(shape):
    """[-12, 12): XLA's CPU backend may fuse ``f * 24 - 12`` into one
    multiply-add; the port always does. Within 1 ulp. Measured: 0 of the
    20,760 values these 20 seeds and four shapes draw differ (unfused, 3,404
    of the 20,000 values of the 1000-element draws did)."""
    for seed in range(20):
        a = np.asarray(jax.random.uniform(_key(seed), shape, minval=-12.0,
                                          maxval=12.0))
        b = prng.uniform(_kd(_key(seed)), shape, -12.0, 12.0, "cpu").numpy()
        np.testing.assert_array_max_ulp(a, b, maxulp=1)
        assert (b >= -12.0).all() and (b < 12.0).all()


SPECS = {
    "default-small": dict(hw=(96, 160), max_objects=6),
    "crowd-small": dict(hw=(96, 160), max_objects=12, presence=1.0,
                        size_scale=0.5, occlusion_aware_gt=True),
    "config9": dict(max_objects=10, presence=1.0),
}


def _specs(name):
    kw = SPECS[name]
    return jsyn.WorldSpec(**kw), tsyn.WorldSpec(**kw)


def _assert_objects(ours, ref):
    """valid, cls, stripe bitwise; float fields within 1e-4."""
    assert set(ours) == set(ref)
    for k in ("valid", "cls", "stripe"):
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))
    for k in ("xyxy", "color", "color2", "phase"):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=1e-4)


def _assert_frames(ours, ref, what):
    """uint8 frames within 1 level, on at most 0.01% of the pixels."""
    assert ours.shape == ref.shape and ours.dtype == np.uint8
    d = np.abs(ours.astype(np.int16) - ref.astype(np.int16))
    assert d.max() <= 1, what
    assert (d > 0).any(-1).sum() <= 1e-4 * d.shape[0] * d.shape[1], what


@pytest.mark.parametrize("name", ["default-small", "crowd-small"])
@pytest.mark.parametrize("seed", [0, 3])
def test_random_objects_matches_jax(name, seed):
    jspec, tspec = _specs(name)
    _assert_objects(tsyn.random_objects(_kd(_key(seed)), tspec, "cpu"),
                    jsyn.random_objects(_key(seed), jspec))


@pytest.mark.parametrize("name", ["default-small", "crowd-small"])
@pytest.mark.parametrize("seed", [0, 3])
def test_render_visibility_ground_truth_match_jax(name, seed):
    """On JAX's objects: frames within the render bound; visibility within
    1e-6; ground-truth valid and class bitwise, boxes within 1e-4 px."""
    jspec, tspec = _specs(name)
    jobj = jsyn.random_objects(_key(seed), jspec)
    tobj = {k: torch.from_numpy(np.array(v)) for k, v in jobj.items()}
    rkey = _key(100 + seed)
    fn = jax.jit(lambda o, k: (jsyn.render(o, jspec, k),
                               jsyn.visibility(o, jspec),
                               *jsyn.ground_truth(o, jspec)))
    jf, jvis, jb, jc, jv = (np.asarray(x) for x in fn(jobj, rkey))
    _assert_frames(tsyn.render(tobj, tspec, _kd(rkey)).numpy(), jf,
                   f"{name} seed {seed}")
    np.testing.assert_allclose(tsyn.visibility(tobj, tspec).numpy(), jvis,
                               rtol=0, atol=1e-6)
    tb, tc, tv = (x.numpy() for x in tsyn.ground_truth(tobj, tspec))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-4)
    assert tv.any()


def test_random_scene_matches_jax():
    jspec, tspec = _specs("default-small")
    ref = [np.asarray(x) for x in jsyn.random_scene(_key(9), jspec)]
    ours = [x.numpy() for x in tsyn.random_scene(_kd(_key(9)), tspec, "cpu")]
    _assert_frames(ours[0], ref[0], "random_scene")
    np.testing.assert_allclose(ours[1], ref[1], rtol=0, atol=1e-4)
    for a, b in zip(ours[2:], ref[2:]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,steps", [("default-small", 12),
                                        ("config9", 3)])
def test_temporal_world_matches_jax(name, steps):
    """Host motion, device rendering: the same ids and valid flags, boxes
    within 1e-4 px, frames within the render bound."""
    jspec, tspec = _specs(name)
    jw = jsyn.TemporalWorld(jspec, seed=4, speed=3.0)
    tw = tsyn.TemporalWorld(tspec, seed=4, speed=3.0, device="cpu")
    for t in range(steps):
        ours, ref = tw.step(), jw.step()
        _assert_frames(ours[0], ref[0], f"{name} step {t}")
        np.testing.assert_allclose(ours[1], ref[1], rtol=0, atol=1e-4)
        for a, b in zip(ours[2:], ref[2:]):
            np.testing.assert_array_equal(a, b)
        assert ours[4].any()


def test_device_defaults_to_the_gpu():
    """Without a device the world, the objects and the draws run on the GPU
    or raise; they never land on the CPU silently."""
    kd = prng.PRNGKey(0)
    calls = (lambda: tsyn.TemporalWorld(tsyn.WorldSpec(hw=(8, 8))).device,
             lambda: tsyn.random_objects(kd, tsyn.WorldSpec())["xyxy"].device,
             lambda: prng.uniform(kd, (4,)).device,
             lambda: prng.randint(kd, (4,), 0, 5).device)
    for call in calls:
        if torch.cuda.is_available():
            assert call().type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
