"""Port: camera-motion compensation (``ops/gmc.py``) against the JAX module,
piece by piece: the static geometry, the pooled gray image and its windowed
blocks, the phase correlation, the robust motion fit, the chunk estimate and
the three Kalman-bank warps."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aicamera_tpu.core import ocsort as joc  # noqa: E402
from aicamera_tpu.ops import gmc as jg  # noqa: E402
from aicamera_tpu_torch.core import ocsort as toc  # noqa: E402
from aicamera_tpu_torch.ops import gmc as tg  # noqa: E402
from aicamera_tpu_torch.scenes import (_smooth_noise,  # noqa: E402
                                       panning_rectangles)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    PyTorch's thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


A_TOL = 1e-5     # the affine's linear part
T_TOL = 1e-3     # the translation, frame pixels
REL_TOL = 1e-5   # the warps, relative to max(|reference|, 1)


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("hw", [(540, 960), (1080, 1920), (720, 1280),
                                (480, 640), (2160, 3840), (256, 384),
                                (96, 128), (64, 64), (30, 40), (100, 1000)])
def test_gmc_spec_equals_jax(hw):
    ours, ref = tg.gmc_spec(hw), jg.gmc_spec(hw)
    for f in dataclasses.fields(ref):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    assert ours.pooled_hw == ref.pooled_hw
    assert ours.n_blocks == ref.n_blocks
    np.testing.assert_array_equal(ours.centers(), ref.centers())


def test_gmc_spec_rejects_a_tiny_frame():
    for spec in (tg.gmc_spec, jg.gmc_spec):
        with pytest.raises(ValueError):
            spec((7, 7))


def _textured(hw, seed, shift=(0, 0)):
    """A smooth seeded texture, rolled by ``shift`` (dy, dx) pixels."""
    rng = np.random.RandomState(seed)
    img = 128 + 40 * _smooth_noise(rng, *hw)
    img = np.roll(img, shift, axis=(0, 1))
    return np.clip(np.round(img), 0, 255).astype(np.uint8)[..., None] \
        .repeat(3, -1)


@pytest.mark.parametrize("hw", [(540, 960), (96, 128)])
def test_gray_pooled_and_windowed_blocks(hw):
    """The pooled gray image bitwise (XLA's summation order and reciprocal,
    copied); the windowed blocks within 1e-5 of each block's largest
    magnitude (the block mean sums 4096 values in another order)."""
    frame = np.random.RandomState(0).randint(0, 256, (*hw, 3), np.uint8)
    spec = tg.gmc_spec(hw)
    g_ours = tg.gray_pooled(T(frame), spec)
    g_ref = jg.gray_pooled(jnp.asarray(frame), spec)
    np.testing.assert_array_equal(g_ours.numpy(), np.asarray(g_ref))
    b_ours = tg._windowed_blocks(g_ours, spec).numpy()
    b_ref = np.asarray(jg._windowed_blocks(g_ref, spec))
    scale = np.abs(b_ref).max(axis=(-2, -1), keepdims=True)
    assert (np.abs(b_ours - b_ref) / np.maximum(scale, 1.0)).max() <= 1e-5
    np.testing.assert_array_equal(tg._hann2(spec.block),
                                  jg._hann2(spec.block))


@pytest.mark.parametrize("shift", [(0, 0), (3, -5), (-9, 14), (12, -15)])
def test_phase_correlate_matches_jax(shift):
    """Displacement within 1e-3 pooled px (a different integer peak would
    move it by at least half a pixel), conf within 1e-4."""
    hw = (256, 384)
    spec = tg.gmc_spec(hw)
    b0, b1 = (tg._windowed_blocks(tg.gray_pooled(T(f), spec), spec)
              for f in (_textured(hw, 1), _textured(hw, 1, shift)))
    d_ours, c_ours = tg._phase_correlate(b0, b1, spec.block)
    d_ref, c_ref = jg._phase_correlate(jnp.asarray(b0.numpy()),
                                       jnp.asarray(b1.numpy()), spec.block)
    np.testing.assert_allclose(d_ours.numpy(), np.asarray(d_ref), atol=1e-3)
    np.testing.assert_allclose(c_ours.numpy(), np.asarray(c_ref), atol=1e-4)
    # the blocks see the roll: (dx, dy) = (shift x, shift y) where the
    # texture correlates
    med = np.median(d_ours.numpy(), axis=0)
    np.testing.assert_allclose(med, [shift[1], shift[0]], atol=0.5)


@pytest.mark.parametrize("method", ["affine", "translation"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_motion_matches_jax_lu(method, seed):
    """The closed-form Cholesky solve against JAX's LU, on seeded block
    displacements with a third of the blocks outliers: A within 1e-5, t
    within 1e-3 px."""
    spec = tg.gmc_spec((540, 960))
    rng = np.random.RandomState(seed)
    c = spec.centers()
    a_true = np.eye(2) + rng.normal(0, 0.01, (2, 2))
    disp = (c @ a_true.T + rng.normal(0, 3, 2) - c).astype(np.float32)
    out = rng.uniform(size=len(c)) < 0.33
    disp[out] += rng.normal(0, 10, (out.sum(), 2)).astype(np.float32)
    conf = rng.uniform(0.05, 1.0, len(c)).astype(np.float32)
    a_ours, t_ours = tg._fit_motion(T(disp), T(conf), spec, method)
    a_ref, t_ref = jg._fit_motion(jnp.asarray(disp), jnp.asarray(conf),
                                  spec, method)
    np.testing.assert_allclose(a_ours.numpy(), np.asarray(a_ref), atol=A_TOL)
    np.testing.assert_allclose(t_ours.numpy(), np.asarray(t_ref), atol=T_TOL)


def _outlier_frames(hw, seed):
    """Two frames of a texture shifted by (dy, dx) = (-2, 3), with one
    region moving on its own: the robust fit down-weights its blocks."""
    f0, f1 = _textured(hw, seed), _textured(hw, seed, (-2, 3))
    other = _textured(hw, seed + 7)
    h, w = hw
    f0[: h // 2, : w // 3] = other[: h // 2, : w // 3]
    f1[: h // 2, : w // 3] = np.roll(other, (6, -8), axis=(0, 1))[
        : h // 2, : w // 3]
    return np.stack([f0, f1])


def _scenes():
    pan, _ = panning_rectangles(5, (256, 384), n_objects=3, seed=1, pan=8)
    big, _ = panning_rectangles(3, (540, 960), n_objects=6, seed=2, pan=16)
    flat = np.full((3, 96, 128, 3), 117, np.uint8)
    return {"pan_256x384": pan, "pan_540x960": big, "flat": flat,
            "outliers": _outlier_frames((256, 384), 3)}


SCENES = _scenes()


@pytest.mark.parametrize("method", ["affine", "translation"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_estimate_chunk_and_pair_match_jax(scene, method):
    """Per-frame ``(A, t)`` of a chunk, and the same pairs one at a time:
    A within 1e-5, t within 1e-3 px of the JAX package."""
    frames = SCENES[scene]
    hw = frames.shape[1:3]
    spec = tg.gmc_spec(hw)
    a_ours, t_ours = tg.estimate_chunk(T(frames[0]), T(frames), spec, method)
    a_ref, t_ref = jax.jit(lambda p, f: jg.estimate_chunk(
        p, f, spec, method))(jnp.asarray(frames[0]), jnp.asarray(frames))
    assert a_ours.shape == (len(frames), 2, 2) and t_ours.shape == (
        len(frames), 2)
    np.testing.assert_allclose(a_ours.numpy(), np.asarray(a_ref), atol=A_TOL)
    np.testing.assert_allclose(t_ours.numpy(), np.asarray(t_ref), atol=T_TOL)
    # the chunk's head is the identity (its own first frame before it)
    np.testing.assert_allclose(a_ours[0].numpy(), np.eye(2), atol=A_TOL)
    np.testing.assert_allclose(t_ours[0].numpy(), 0.0, atol=T_TOL)
    for i in range(1, len(frames)):
        a, t = tg.estimate_pair(tg.gray_pooled(T(frames[i - 1]), spec),
                                tg.gray_pooled(T(frames[i]), spec), spec,
                                method)
        np.testing.assert_allclose(a.numpy(), np.asarray(a_ref[i]),
                                   atol=A_TOL)
        np.testing.assert_allclose(t.numpy(), np.asarray(t_ref[i]),
                                   atol=T_TOL)
    if scene == "flat":  # no texture: the ridge keeps the identity
        np.testing.assert_allclose(a_ours.numpy(), np.eye(2)[None].repeat(
            len(frames), 0), atol=A_TOL)
        np.testing.assert_allclose(t_ours.numpy(), 0.0, atol=T_TOL)
    if scene == "outliers" and method == "translation":
        # the blocks of the region moving on its own are down-weighted
        np.testing.assert_allclose(t_ours[1].numpy(), [3.0, -2.0], atol=0.5)


@pytest.mark.parametrize("method", ["affine", "translation"])
def test_panning_scene_shift_is_recovered(method):
    """The panning scene's known camera motion at 960x540: ``t`` and the
    motion of the frame's centre within 0.5 px of it on every frame."""
    frames, shifts = panning_rectangles(9, (540, 960), seed=0)
    assert np.abs(shifts[1:, 0]).min() > 0 and not shifts[:, 1].any()
    spec = tg.gmc_spec((540, 960))
    a, t = tg.estimate_chunk(T(frames[0]), T(frames[1:]), spec, method)
    np.testing.assert_allclose(t.numpy(), shifts[1:], atol=0.5)
    c = torch.tensor([480.0, 270.0])
    np.testing.assert_allclose((a @ c + t - c).numpy(), shifts[1:], atol=0.5)
    np.testing.assert_allclose(a.numpy(), np.eye(2)[None].repeat(8, 0),
                               atol=5e-3)


def test_gmc_estimator_matches_jax_and_resets():
    frames, _ = panning_rectangles(4, (256, 384), n_objects=3, seed=4, pan=8)
    ours = tg.GMCEstimator("affine", device="cpu")
    ref = jg.GMCEstimator("affine")
    for f in frames:
        a, t = ours.step(f)
        assert a.device.type == "cpu" and a.dtype == torch.float32
        a_ref, t_ref = ref.step(f)
        np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), atol=A_TOL)
        np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), atol=T_TOL)
    ours.reset()
    a, t = ours.step(T(frames[2]))  # a tensor; the first frame again
    np.testing.assert_allclose(a.numpy(), np.eye(2), atol=A_TOL)
    np.testing.assert_allclose(t.numpy(), 0.0, atol=T_TOL)
    with pytest.raises(ValueError):
        tg.GMCEstimator("homography", device="cpu")


def test_gmc_estimator_defaults_to_the_gpu():
    if torch.cuda.is_available():
        assert tg.GMCEstimator().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tg.GMCEstimator()


@pytest.mark.parametrize("value,method", [
    (False, None), (None, None), ("off", None), ("none", None), ("", None),
    (True, "affine"), ("affine", "affine"), ("translation", "translation")])
def test_gmc_method(value, method):
    assert tg.gmc_method(value) == method


def test_gmc_method_rejects_a_bad_value():
    with pytest.raises(ValueError):
        tg.gmc_method("bogus")


def _affine(seed):
    rng = np.random.RandomState(seed)
    th, zoom = rng.uniform(-0.05, 0.05), rng.uniform(0.95, 1.05)
    a = zoom * np.array([[np.cos(th), -np.sin(th)], [np.sin(th),
                                                      np.cos(th)]])
    a = a + rng.normal(0, 0.01, (2, 2))
    return a.astype(np.float32), rng.normal(0, 20, 2).astype(np.float32)


def _spd(rng, t, n):
    m = rng.normal(0, 3, (t, n, n))
    return (m @ m.transpose(0, 2, 1) + np.eye(n)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.maximum(np.abs(b), 1.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_warp_xyah_bank(seed):
    """Within 1e-5 relative; inactive slots bitwise untouched."""
    rng = np.random.RandomState(seed)
    t = 24
    mean = rng.normal(0, 100, (t, 8)).astype(np.float32)
    cov = _spd(rng, t, 8)
    active = rng.uniform(size=t) < 0.6
    a, tr = _affine(seed)
    m_o, c_o = tg.warp_xyah_bank(T(mean), T(cov), T(a), T(tr), T(active))
    m_r, c_r = jg.warp_xyah_bank(jnp.asarray(mean), jnp.asarray(cov),
                                 jnp.asarray(a), jnp.asarray(tr),
                                 jnp.asarray(active))
    assert _rel(m_o, m_r).max() <= REL_TOL
    assert _rel(c_o, c_r).max() <= REL_TOL
    np.testing.assert_array_equal(m_o.numpy()[~active], mean[~active])
    np.testing.assert_array_equal(c_o.numpy()[~active], cov[~active])
    assert not np.array_equal(m_o.numpy()[active], mean[active])


def test_warp_boxes_xyxy():
    """Within 1e-5 relative, min/max reordered."""
    rng = np.random.RandomState(3)
    xy = rng.uniform(0, 900, (5, 7, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(1, 90, (5, 7, 2)).astype(
        np.float32)], -1)
    a, tr = _affine(3)
    a[0, 0] = -a[0, 0]  # a mirror: corners swap
    ours = tg.warp_boxes_xyxy(T(boxes), T(a), T(tr)).numpy()
    ref = jg.warp_boxes_xyxy(jnp.asarray(boxes), jnp.asarray(a),
                             jnp.asarray(tr))
    assert _rel(ours, ref).max() <= REL_TOL
    assert (ours[..., 2:] >= ours[..., :2]).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_warp_ocsort_state(seed):
    """Every field within 1e-5 relative; inactive tracks, sentinel
    ``last_obs`` (score < 0), unwritten ring slots, zero momentum and
    unfrozen states bitwise untouched."""
    rng = np.random.RandomState(seed)
    kw = dict(max_tracks=20, max_detections=8, delta_t=3)
    tp, jp = toc.OCSortParams(**kw), joc.OCSortParams(**kw)
    t, k = tp.max_tracks, tp.delta_t + 1
    vel = rng.normal(size=(t, 2))
    vel /= np.linalg.norm(vel, axis=-1, keepdims=True)
    vel[rng.uniform(size=t) < 0.3] = 0.0
    last = np.concatenate([rng.uniform(0, 500, (t, 2)),
                           rng.uniform(500, 900, (t, 2)),
                           rng.uniform(0.3, 1, (t, 1))], -1)
    last[rng.uniform(size=t) < 0.3] = -1.0
    ring_xy = rng.uniform(0, 500, (t, k, 2))
    fields = dict(
        active=rng.uniform(size=t) < 0.7,
        x=np.concatenate([rng.uniform(0, 900, (t, 2)),
                          rng.uniform(100, 9000, (t, 1)),
                          rng.uniform(0.3, 3, (t, 1)),
                          rng.normal(0, 4, (t, 3))], -1),
        p=_spd(rng, t, 7),
        frozen_x=rng.normal(0, 300, (t, 7)),
        frozen_p=_spd(rng, t, 7),
        frozen_valid=rng.uniform(size=t) < 0.5,
        last_obs=last,
        obs_ring=np.concatenate([ring_xy, ring_xy + 40], -1),
        obs_age=np.where(rng.uniform(size=(t, k)) < 0.4, -1,
                         rng.randint(0, 9, (t, k))).astype(np.int32),
        velocity=vel)
    fields = {n: (v.astype(np.float32) if v.dtype == np.float64 else v)
              for n, v in fields.items()}
    ours = toc.init_state(tp, device="cpu").replace(
        **{n: T(v) for n, v in fields.items()})
    ref = joc.init_state(jp).replace(
        **{n: jnp.asarray(v) for n, v in fields.items()})
    a, tr = _affine(seed + 10)
    w_o = tg.warp_ocsort_state(ours, T(a), T(tr))
    w_r = jg.warp_ocsort_state(ref, jnp.asarray(a), jnp.asarray(tr))
    for name in fields:
        assert _rel(getattr(w_o, name), getattr(w_r, name)).max() \
            <= REL_TOL, name
    act = fields["active"]
    out = {n: getattr(w_o, n).numpy() for n in fields}
    for name in ("x", "p", "frozen_x", "frozen_p", "last_obs", "obs_ring",
                 "velocity"):
        np.testing.assert_array_equal(out[name][~act], fields[name][~act],
                                      err_msg=name)
    sentinel = last[:, 4] < 0
    np.testing.assert_array_equal(out["last_obs"][sentinel],
                                  fields["last_obs"][sentinel])
    unwritten = fields["obs_age"] < 0
    np.testing.assert_array_equal(out["obs_ring"][unwritten],
                                  fields["obs_ring"][unwritten])
    still = (vel == 0).all(-1)
    np.testing.assert_array_equal(out["velocity"][still],
                                  fields["velocity"][still])
    unfrozen = ~fields["frozen_valid"]
    np.testing.assert_array_equal(out["frozen_x"][unfrozen],
                                  fields["frozen_x"][unfrozen])
    # the warp moved what it should
    moved = act & ~sentinel
    assert not np.array_equal(out["last_obs"][moved],
                              fields["last_obs"][moved])
