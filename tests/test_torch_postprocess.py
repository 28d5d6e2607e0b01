"""Port: gap interpolation and GSI smoothing (``postprocess.py``) against
the JAX package's on seeded track lists."""

import numpy as np
import pytest

from aicamera_tpu import postprocess as jpost
from aicamera_tpu_torch import postprocess as tpost


def _tracks(seed, n_frames=60, n_tracks=5):
    """Per-frame (boxes, ids): constant-velocity tracks with jitter, short
    and long gaps (one past max_gap=20), a 3-sighting track and empty
    frames."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 500, (n_tracks, 2))
    vel = rng.normal(0, 3, (n_tracks, 2))
    size = rng.uniform(20, 80, (n_tracks, 2))
    gaps = {0: range(10, 14), 1: range(20, 45), 2: range(30, 31)}
    frames = []
    for t in range(n_frames):
        boxes, ids = [], []
        for k in range(n_tracks):
            if t in gaps.get(k, ()) or (k == 4 and t not in (5, 9, 12)):
                continue
            if 50 <= t <= 52:
                continue                      # empty frames
            p = pos[k] + t * vel[k] + rng.normal(0, 1.5, 2)
            boxes.append(np.concatenate([p, p + size[k]]))
            ids.append(k + 1)
        frames.append((np.asarray(boxes, np.float32).reshape(-1, 4),
                       np.asarray(ids, np.int64)))
    return frames


def _assert_frames_close(ours, ref):
    assert len(ours) == len(ref)
    for (ob, oi), (rb, ri) in zip(ours, ref):
        np.testing.assert_array_equal(oi, ri)
        assert ob.dtype == rb.dtype
        np.testing.assert_allclose(ob, rb, rtol=0, atol=1e-5)


@pytest.mark.parametrize("max_gap", [20, 5])
@pytest.mark.parametrize("seed", range(3))
def test_interpolate_tracks_matches_jax(seed, max_gap):
    frames = _tracks(seed)
    ours = tpost.interpolate_tracks(frames, max_gap=max_gap)
    _assert_frames_close(ours, jpost.interpolate_tracks(frames,
                                                        max_gap=max_gap))
    assert sum(map(len, (i for _, i in ours))) > sum(
        map(len, (i for _, i in frames)))


@pytest.mark.parametrize("tau,noise", [(10.0, 1.0), (4.0, 3.0)])
@pytest.mark.parametrize("seed", range(3))
def test_gsi_smooth_matches_jax(seed, tau, noise):
    frames = _tracks(seed)
    _assert_frames_close(tpost.gsi_smooth(frames, tau=tau, noise=noise),
                         jpost.gsi_smooth(frames, tau=tau, noise=noise))
