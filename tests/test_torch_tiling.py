"""Port: tiled detection's static grid and merge NMS (``ops/tiling.py``) and
the NMS tail's intersection-over-smaller-area criterion, against the JAX
package."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from aicamera_tpu.ops import nms as jnms  # noqa: E402
from aicamera_tpu.ops import tiling as jtl  # noqa: E402
from aicamera_tpu_torch.ops import nms as tnms  # noqa: E402
from aicamera_tpu_torch.ops import tiling as ttl  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    PyTorch's thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("hw,grid,overlap", [
    ((540, 960), (2, 2), 0.2), ((1080, 1920), (3, 3), 0.25),
    ((2160, 3840), (2, 4), 0.1), ((720, 1280), (1, 3), 0.0),
    ((97, 131), (3, 2), 0.5), ((540, 960), (1, 1), 0.2)])
def test_tile_layout_equals_jax(hw, grid, overlap):
    ours = ttl.tile_layout(hw, grid, overlap)
    ref = jtl.tile_layout(hw, grid, overlap)
    assert ours == ref
    origins, (th, tw) = ours
    # every pixel inside a tile, every tile inside the frame
    assert all(0 <= y0 and y0 + th <= hw[0] and 0 <= x0 and x0 + tw <= hw[1]
               for y0, x0 in origins)
    assert origins[-1][0] + th == hw[0] and origins[-1][1] + tw == hw[1]


@pytest.mark.parametrize("grid,overlap", [((0, 2), 0.2), ((2, 2), 1.0),
                                          ((2, 2), -0.1)])
def test_tile_layout_rejects_bad_arguments(grid, overlap):
    for layout in (ttl.tile_layout, jtl.tile_layout):
        with pytest.raises(ValueError):
            layout((540, 960), grid, overlap)


def test_extract_tiles_and_offset_boxes_equal_jax():
    frame = np.random.RandomState(0).randint(0, 256, (97, 131, 3), np.uint8)
    origins, tile_hw = ttl.tile_layout((97, 131), (2, 3), 0.3)
    ours = ttl.extract_tiles(torch.from_numpy(frame), origins, tile_hw)
    ref = jtl.extract_tiles(jnp.asarray(frame), origins, tile_hw)
    assert ours.is_contiguous()
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    boxes = np.random.RandomState(1).uniform(0, 60, (5, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        ttl.offset_boxes(torch.from_numpy(boxes), 7, 33).numpy(),
        np.asarray(jtl.offset_boxes(jnp.asarray(boxes), 7, 33)))


def _candidates(seed, n=48, hw=(540, 960)):
    """Seeded detections of a few objects, each seen several times with
    jitter, clipped fragments and tied scores, some invalid."""
    rng = np.random.RandomState(seed)
    centres = rng.uniform(0, 1, (6, 2)) * np.array([hw[1], hw[0]])
    sizes = rng.uniform(20, 200, (6, 2))
    obj = rng.randint(0, 6, n)
    c = centres[obj] + rng.normal(0, 6, (n, 2))
    s = sizes[obj] * rng.uniform(0.4, 1.1, (n, 2))
    boxes = np.concatenate([c - s / 2, c + s / 2], 1).astype(np.float32)
    scores = np.round(rng.uniform(0.2, 0.95, n), 2).astype(np.float32)
    cls = rng.choice([0, 2, 7], n).astype(np.int32)
    cls[obj % 2 == 0] = 0
    valid = rng.uniform(size=n) < 0.85
    return boxes, scores, cls, valid


@pytest.mark.parametrize("criterion", ["iou", "ios"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_detections_equals_jax(criterion, seed):
    """Identical keeps: count, boxes, scores and labels bitwise (the merge
    only selects; ties resolve to the lower index in both)."""
    boxes, scores, cls, valid = _candidates(seed)
    kw = dict(iou_threshold=0.5, max_det=20, frame_hw=(540, 960),
              criterion=criterion)
    ours = ttl.merge_detections(*(torch.from_numpy(a) for a in
                                  (boxes, scores, cls, valid)), **kw)
    ref = jtl.merge_detections(*(jnp.asarray(a) for a in
                                 (boxes, scores, cls, valid)), **kw)
    assert int(ours[0]) == int(ref[0]) > 0
    for a, b in zip(ours[1:], ref[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_ios_collapses_more_than_iou():
    """A fragment inside a larger box of its class: IoS suppresses it where
    IoU does not."""
    boxes = np.array([[100, 100, 300, 300], [110, 110, 160, 160]],
                     np.float32)
    args = [torch.from_numpy(a) for a in (
        boxes, np.array([0.9, 0.8], np.float32), np.zeros(2, np.int32),
        np.ones(2, bool))]
    assert int(ttl.merge_detections(*args, 0.5, 4, criterion="iou")[0]) == 2
    assert int(ttl.merge_detections(*args, 0.5, 4, criterion="ios")[0]) == 1


def test_pairwise_ios_equals_jax():
    boxes = _candidates(3)[0]
    ours = tnms._pairwise_ios_xyxy(torch.from_numpy(boxes)).numpy()
    ref = np.asarray(jnms._pairwise_ios_xyxy(jnp.asarray(boxes)))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)


def test_suppress_and_emit_default_is_iou_and_rejects_others():
    """The callers that pass no criterion get the IoU tail, bit for bit."""
    rng = np.random.RandomState(4)
    boxes, scores, cls, _ = _candidates(4, n=32)
    order = np.argsort(-scores, kind="stable")
    args = (torch.from_numpy(boxes[order])[None],
            torch.from_numpy(scores[order])[None],
            torch.from_numpy(cls[order])[None],
            torch.from_numpy(rng.uniform(size=32) < 0.9)[None], 0.45, 32, 40)
    default = tnms._suppress_and_emit(*args)
    named = tnms._suppress_and_emit(*args, criterion="iou")
    for a, b in zip(default, named):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tnms._suppress_and_emit(*args, criterion="giou")
