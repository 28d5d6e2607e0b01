"""Port: the host C++ library (``aicamera_tpu_torch/native``) against the
JAX package's (``aicamera_tpu.native``), on seeded inputs.

``lapjv``: the same assignment (and so the same total cost) on square,
wide and tall cost matrices; ``letterbox``: the same (Dh, Dw, 3) float32
image, bitwise, at the geometries the pipeline uses. Both libraries build
with the host's ``c++`` (the port's into ``aicamera_tpu_torch/_build/``);
a missing compiler fails these tests.
"""

import numpy as np
import pytest

from aicamera_tpu import native as jnative
from aicamera_tpu.ops.preprocess import letterbox_spec as jspec
from aicamera_tpu_torch import native
from aicamera_tpu_torch.ops.preprocess import letterbox_spec


def test_available_and_video_available():
    assert native.available() and native.video_available()
    assert jnative.available()


@pytest.mark.parametrize("shape", [(1, 1), (5, 5), (8, 13), (13, 8),
                                   (40, 64), (64, 40)])
def test_lapjv_matches_jax(shape):
    rng = np.random.RandomState(sum(shape))
    for trial in range(5):
        cost = rng.uniform(0, 1, shape).astype(np.float32)
        if trial % 2:    # ties and large entries, as gated costs have
            cost[rng.uniform(size=shape) < 0.3] = 1e5
        got, want = native.lapjv(cost), jnative.lapjv(cost)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,dst", [((540, 960), (640, 640)),
                                     ((96, 128), (128, 128)),
                                     ((37, 101), (64, 96)),
                                     ((640, 640), (640, 640))])
def test_letterbox_matches_jax(src, dst):
    frame = np.random.RandomState(src[0]).randint(0, 256, (*src, 3),
                                                  np.uint8)
    spec = letterbox_spec(src, dst)
    got = native.letterbox(frame, spec)
    want = jnative.letterbox(frame, jspec(src, dst))
    assert got.dtype == np.float32 and got.shape == (*dst, 3)
    np.testing.assert_array_equal(got, want)


def test_a_missing_compiler_or_a_failed_build_raises(tmp_path, monkeypatch):
    """No quiet fallback: without ``c++`` the build raises naming it; a
    source that does not compile raises with the compiler's output."""
    from aicamera_tpu_torch.ops import cuda_build, host_build
    old = cuda_build.BUILD_DIR
    cuda_build.set_build_dir(tmp_path / "build")
    try:
        bad = tmp_path / "bad.cpp"
        bad.write_text("int f( {\n")
        with pytest.raises(RuntimeError, match="failed for libbad_"):
            host_build.build(bad)
        monkeypatch.setattr(host_build.shutil, "which", lambda name: None)
        with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
            host_build.build(host_build.NATIVE_DIR / "jpeg.cpp")
    finally:
        cuda_build.set_build_dir(old)
