"""Port: fused DFL decode + top-k + class-aware greedy NMS against JAX, and
the fixpoint keep against a sequential greedy oracle."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aicamera_tpu.ops import nms as jnms  # noqa: E402
from aicamera_tpu_torch.ops import nms as tnms  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    PyTorch's thread pool oversubscribes the cores (small convolutions then
    run ~100x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _levels(hw, batch, seed, n_classes=80):
    """Seeded head outputs with duplicated anchors: identical logits and
    box bins at several anchors (exact score ties and identical boxes)."""
    rng = np.random.RandomState(seed)
    out = []
    for s in (8, 16, 32):
        h, w = hw[0] // s, hw[1] // s
        bins = rng.normal(0, 2, (batch, h, w, 64)).astype(np.float32)
        logits = rng.normal(-4, 2.5, (batch, h, w, n_classes)).astype(
            np.float32)
        # duplicate a few anchors onto others (ties, identical boxes)
        for b in range(batch):
            for _ in range(3):
                y0, x0, y1, x1 = rng.randint(0, h, 2).tolist() + \
                    rng.randint(0, w, 2).tolist()
                logits[b, y1 % h, x1] = logits[b, y0, x0]
                bins[b, y1 % h, x1] = bins[b, y0, x0]
        # an exact class tie inside one anchor: argmax takes the first
        logits[:, 0, 0, 5] = logits[:, 0, 0, 3] = 6.0
        out.append((bins, logits))
    return out


@pytest.mark.parametrize("hw,batch,seed", [((128, 128), 3, 0),
                                           ((96, 160), 2, 1),
                                           ((64, 64), 2, 2)])  # A=84 < 100
def test_fused_decode_nms_matches_jax(hw, batch, seed):
    """Keep sets, order and labels identical. Scores within 1e-6: the two
    libraries' sigmoids may differ by an ulp. Boxes within 1e-4 absolute
    plus 1e-6 relative: a box edge is (centre - DFL distance) * stride, so a
    one-ulp softmax difference in a distance of up to 15 cells, times stride
    32, moves an edge by ~3e-5 even where the edge itself is near 0."""
    levels = _levels(hw, batch, seed)
    ref = jax.jit(lambda lv: jnms.fused_decode_nms(lv))(
        [(jnp.asarray(b), jnp.asarray(c)) for b, c in levels])
    ours = tnms.fused_decode_nms(
        [(torch.from_numpy(b), torch.from_numpy(c)) for b, c in levels])
    num_r, boxes_r, scores_r, labels_r = (np.asarray(x) for x in ref)
    num_o, boxes_o, scores_o, labels_o = (x.numpy() for x in ours)
    assert num_r.sum() > 5 * batch  # the scene is not trivially empty
    np.testing.assert_array_equal(num_o, num_r)
    np.testing.assert_array_equal(labels_o, labels_r)
    np.testing.assert_allclose(scores_o, scores_r, atol=1e-6, rtol=0)
    np.testing.assert_allclose(boxes_o, boxes_r, atol=1e-4, rtol=1e-6)
    assert labels_o.dtype == np.int32 and num_o.dtype == np.int32


def test_score_ties_keep_lower_index_first():
    """Equal scores: lax.top_k order (lower index first) on both sides."""
    bins = np.zeros((1, 4, 4, 64), np.float32)
    logits = np.full((1, 4, 4, 80), -9.0, np.float32)
    logits[0, :, :, 0] = 2.0            # 16 identical scores, class 0
    bins[..., 0::16] = 20.0             # distances ~0: disjoint, all kept
    lv = [(bins, logits)] + [
        (np.zeros((1, 2, 2, 64), np.float32),
         np.full((1, 2, 2, 80), -9.0, np.float32)),
        (np.zeros((1, 1, 1, 64), np.float32),
         np.full((1, 1, 1, 80), -9.0, np.float32))]
    ref = jnms.fused_decode_nms([(jnp.asarray(b), jnp.asarray(c))
                                 for b, c in lv], strides=(8, 16, 32))
    ours = tnms.fused_decode_nms([(torch.from_numpy(b), torch.from_numpy(c))
                                  for b, c in lv])
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))
    assert int(ours[0][0]) == 16


def _greedy_oracle(overlap, valid):
    """The sequential greedy scan over score-ordered candidates."""
    keep = np.zeros_like(valid)
    for i in range(len(valid)):
        keep[i] = valid[i] and not np.any(keep[:i] & overlap[:i, i])
    return keep


@pytest.mark.parametrize("seed", range(6))
def test_fixpoint_keep_equals_sequential_greedy(seed):
    rng = np.random.RandomState(seed)
    b, k = 4, 60
    xy = rng.uniform(0, 100, (b, k, 2)).astype(np.float32)
    wh = rng.uniform(5, 40, (b, k, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1)
    iou = tnms._pairwise_iou_xyxy(torch.from_numpy(boxes)).numpy()
    overlap = iou > rng.uniform(0.1, 0.5)
    valid = rng.rand(b, k) < 0.9
    kept = tnms._greedy_keep(torch.from_numpy(overlap),
                             torch.from_numpy(valid)).numpy()
    for i in range(b):
        np.testing.assert_array_equal(kept[i],
                                      _greedy_oracle(overlap[i], valid[i]))
    # and the JAX fixpoint on the same inputs
    for i in range(b):
        np.testing.assert_array_equal(
            kept[i], np.asarray(jnms._greedy_keep(jnp.asarray(overlap[i]),
                                                  jnp.asarray(valid[i]))))


def test_long_suppression_chain_converges():
    """A chain where each box overlaps only its neighbour: the fixpoint needs
    many iterations and still equals the greedy scan."""
    k = 30
    x = np.arange(k, dtype=np.float32) * 6.0
    boxes = np.stack([x, np.zeros(k), x + 10.0, np.full(k, 10.0)], -1)
    boxes = boxes.astype(np.float32)[None]
    overlap = tnms._pairwise_iou_xyxy(torch.from_numpy(boxes)) > 0.2
    valid = torch.ones((1, k), dtype=torch.bool)
    kept = tnms._greedy_keep(overlap, valid).numpy()[0]
    np.testing.assert_array_equal(kept, _greedy_oracle(overlap.numpy()[0],
                                                       valid.numpy()[0]))
    assert kept.tolist() == [i % 2 == 0 for i in range(k)]
