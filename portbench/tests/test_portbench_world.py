"""The frozen world renders the program's world bit for bit."""

import numpy as np
import pytest

from aicamera_tpu_torch.synthetic import TemporalWorld, WorldSpec
from portbench.world import synthetic as frozen


@pytest.mark.parametrize("seed", [0, 5400, 2 ** 31 + 7])
def test_frozen_world_is_the_programs(seed):
    kw = dict(hw=(48, 80), max_objects=4, presence=1.0)
    a = TemporalWorld(WorldSpec(**kw), seed=seed, speed=3.0, device="cpu")
    b = frozen.TemporalWorld(frozen.WorldSpec(**kw), seed=seed, speed=3.0,
                             device="cpu")
    for _ in range(6):
        fa, ba, ia, ca, va = a.step()
        fb, bb, ib, cb, vb = b.step()
        assert np.array_equal(fa, fb)
        assert np.array_equal(ba, bb) and np.array_equal(ca, cb)
        assert np.array_equal(va, vb) and np.array_equal(ia, ib)
