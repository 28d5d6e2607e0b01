"""RT-DETR-L in the port (``models/rtdetr.py``) against the plain
reference (``portbench/reference/rtdetr.py``), its set-prediction loss, and
its place in the pipelines.

Weights are seeded draws at the published widths (BatchNorm statistics and
affine terms drawn too, so that folding them is exercised); inputs are
160x160, so a forward is a few hundred milliseconds on the CPU.
"""

import itertools
import sys
import warnings

import numpy as np
import pytest
import torch

from aicamera_tpu_torch import train
from aicamera_tpu_torch.models import rtdetr
from aicamera_tpu_torch.runtime import pipeline as pl
from aicamera_tpu_torch.runtime.params import (flax_tree,
                                               load_state_strict,
                                               read_flax_msgpack,
                                               rtdetr_state_dict_from_flax,
                                               write_flax_msgpack)
from aicamera_tpu_torch.runtime.profiler import CudaStageTimer
from portbench.families import rtdetr as family
from portbench.reference.rtdetr import RTDETRRef, tree_to_device

HW = (160, 160)
QUERIES = 60


@pytest.fixture(autouse=True, scope="module")
def _dynamo_importable():
    """The FLOP count's ``FlopCounterMode`` imports ``torch._dynamo``,
    which looks up the spec of any ``tensorrt`` module; collecting
    ``tests/test_facade_oracle.py`` leaves a stub without one in
    ``sys.modules``. Import dynamo once with the stub set aside (as
    ``tests/test_torch_engine.py`` does)."""
    stub = sys.modules.pop("tensorrt", None)
    try:
        import torch._dynamo  # noqa: F401
    finally:
        if stub is not None:
            sys.modules["tensorrt"] = stub
    yield


def _seeded(seed=0, queries=QUERIES):
    """An RT-DETR-L with Ultralytics' init, its BatchNorms and the
    zero-initialised heads redrawn, so that every term matters."""
    torch.manual_seed(seed)
    m = rtdetr.init_weights_(rtdetr.RTDETR(num_queries=queries), seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                n = mod.num_features
                mod.weight.copy_(0.5 + torch.rand(n, generator=g))
                mod.bias.copy_(0.1 * torch.randn(n, generator=g))
                mod.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                mod.running_var.copy_(0.5 + torch.rand(n, generator=g))
            elif isinstance(mod, torch.nn.Linear) and not mod.weight.any():
                mod.weight.copy_(0.02 * torch.randn(mod.weight.shape,
                                                    generator=g))
    return m.eval()


@pytest.fixture(scope="module")
def nets():
    """The trained-form model, its tree through the checkpoint format, the
    port's inference form (fused, f32) and the reference on that tree."""
    m = _seeded()
    tree = read_flax_msgpack(write_flax_msgpack(flax_tree(m)))
    port = rtdetr.RTDETR(num_queries=QUERIES)
    load_state_strict(port, rtdetr_state_dict_from_flax(tree))
    port = port.to_inference("cpu", torch.float32)
    ref = RTDETRRef(tree_to_device(tree, "cpu"), num_queries=QUERIES)
    x = torch.rand(2, 3, *HW, generator=torch.Generator().manual_seed(5))
    return m, tree, port, ref, x


def test_the_parameter_count_is_the_published_models():
    # Ultralytics' rtdetr-l: 32,970,476 parameters, of which 80 x 256 are
    # the denoising class embedding that the eval form does not hold
    n = sum(p.numel() for p in rtdetr.RTDETR().parameters())
    assert n == 32_970_476 - 80 * 256


def test_the_checkpoint_format_round_trips(nets):
    m, tree, _, _, _ = nets
    again = rtdetr.RTDETR(num_queries=QUERIES)
    load_state_strict(again, rtdetr_state_dict_from_flax(tree))
    for (k, a), (_, b) in zip(m.state_dict().items(),
                              again.state_dict().items()):
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(a, b), k


@torch.no_grad()
def test_the_encoder_class_logits_over_every_anchor(nets):
    _, _, port, ref, x = nets
    feats, shapes = port.encode(port.features(x))
    *_, logits = port.decoder.select(feats, shapes)
    rfeats, rshapes = ref.memory(ref.encoder(*ref.backbone(x)))
    _, rlogits = ref.encoder_scores(rfeats, rshapes)
    assert shapes == rshapes
    assert logits.shape == (2, 20 * 20 + 10 * 10 + 5 * 5, 80)
    # f32 both ways; the port folds BN into its convs and merges each
    # RepConv's branches, which reorders sums through ~60 layers: 1e-4 of
    # the logits' scale covers that reordering and not one wrong term
    scale = rlogits.abs().max()
    assert (logits - rlogits).abs().max() <= 1e-4 * scale
    assert (feats - rfeats).abs().max() <= 1e-4 * rfeats.abs().max()


@torch.no_grad()
def test_the_decoder_given_the_same_queries(nets):
    _, _, port, ref, x = nets
    rfeats, shapes = ref.memory(ref.encoder(*ref.backbone(x)))
    embed, ref_logit, index = ref.select(rfeats, shapes)
    rboxes, rlogits = ref.layers(embed, ref_logit, rfeats, shapes)
    # teacher-forced: the reference's memory and selected queries
    pembed, pref, *_ = port.decoder.select(rfeats, shapes, index)
    boxes, logits = port.decoder.layers_forward(pembed, pref, rfeats, shapes)
    # the same f32 operations in another order (fused heads, SDPA, one
    # grid_sample a level): a 1e-5 relative budget per stage
    assert (boxes - rboxes).abs().max() <= 1e-4
    assert (logits - rlogits).abs().max() <= 1e-4 * rlogits.abs().max()


@torch.no_grad()
def test_the_deformable_sampling_against_the_reference_and_bilinear_taps():
    g = torch.Generator().manual_seed(3)
    shapes = [(6, 8), (3, 4), (2, 2)]
    b, q, h, d, lv, p = 2, 5, 8, 4, 3, 4
    s = sum(a * c for a, c in shapes)
    value = torch.randn(b, s, h, d, generator=g)
    loc = torch.rand(b, q, h, lv, p, 2, generator=g) * 1.2 - 0.1
    w = torch.softmax(torch.randn(b, q, h, lv * p, generator=g), -1).reshape(
        b, q, h, lv, p)
    got = rtdetr.msda_sample(value, shapes, loc, w)
    # bilinear taps by hand: half-pixel centres, zeros outside
    want = torch.zeros(b, q, h, d)
    start = 0
    for lvl, (hh, ww) in enumerate(shapes):
        v = value[:, start:start + hh * ww].reshape(b, hh, ww, h, d)
        start += hh * ww
        for bi, qi, hi, pi in itertools.product(range(b), range(q), range(h),
                                                range(p)):
            x = float(loc[bi, qi, hi, lvl, pi, 0]) * ww - 0.5
            y = float(loc[bi, qi, hi, lvl, pi, 1]) * hh - 0.5
            x0, y0 = int(np.floor(x)), int(np.floor(y))
            acc = torch.zeros(d)
            for yy, xx in ((y0, x0), (y0, x0 + 1), (y0 + 1, x0),
                           (y0 + 1, x0 + 1)):
                if 0 <= yy < hh and 0 <= xx < ww:
                    acc += (1 - abs(x - xx)) * (1 - abs(y - yy)) \
                        * v[bi, yy, xx, hi]
            want[bi, qi, hi] += w[bi, qi, hi, lvl, pi] * acc
    # float32 sums of 48 products in two orders
    assert torch.allclose(got, want.reshape(b, q, h * d), atol=1e-5)
    # the module against the reference's, one layer's weights
    port = _seeded(4).decoder.layer0.msda
    tree = flax_tree(port)["params"]
    ref = RTDETRRef({})
    feats = torch.randn(b, s, 256, generator=g)
    query = torch.randn(b, q, 256, generator=g)
    box = torch.cat([torch.rand(b, q, 2, generator=g) * 0.8 + 0.1,
                     torch.rand(b, q, 2, generator=g) * 0.3 + 0.05], -1)
    got = port(query, box, feats, shapes)
    want = ref.msda(tree_to_device(tree, "cpu"), query, box, feats, shapes)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_the_post_process_is_the_references_exactly():
    g = torch.Generator().manual_seed(9)
    boxes = torch.rand(3, QUERIES, 4, generator=g) * 0.5 + 0.1
    logits = torch.randn(3, QUERIES, 80, generator=g) * 3
    logits[1, 7] = logits[1, 3]                     # a tie: query order
    num, xyxy, scores, labels = rtdetr.postprocess(boxes, logits, HW, 0.1, 25)
    want = family.post_process(boxes, logits, HW, 0.1, 25)
    for f, (wb, ws, wc) in enumerate(want):
        n = int(num[f])
        assert n == len(ws)
        assert torch.equal(xyxy[f, :n], wb) and torch.equal(scores[f, :n], ws)
        assert torch.equal(labels[f, :n].long(), wc.long())


def _brute(cost):
    q, g = cost.shape
    best = None
    for rows in itertools.permutations(range(q), g):
        c = sum(cost[r, j] for j, r in enumerate(rows))
        if best is None or c < best[0] - 1e-12:
            best = (c, rows)
    return best


@pytest.mark.parametrize("q,g", [(4, 1), (5, 3), (6, 4), (7, 6)])
def test_the_matcher_is_the_brute_force_minimum(q, g):
    rng = np.random.default_rng(q * 10 + g)
    cfg = train.DetrTrainConfig()
    for _ in range(3):
        prob = torch.from_numpy(rng.uniform(0.01, 0.99, (q, 80)))
        boxes = torch.from_numpy(rng.uniform(0.2, 0.5, (q, 4)))
        gt_boxes = torch.from_numpy(rng.uniform(0.2, 0.5, (g, 4)))
        gt_cls = torch.from_numpy(rng.integers(0, 80, g))
        cost = train.match_cost(prob, boxes, gt_cls, gt_boxes,
                                cfg).numpy()
        rows, cols = train.hungarian(cost)
        assert list(cols) == list(range(g))
        best, brute = _brute(cost)
        assert cost[rows, cols].sum() == pytest.approx(best, abs=1e-9)
        assert tuple(rows) == brute


def test_a_few_training_steps_lower_the_loss():
    torch.manual_seed(0)
    m = rtdetr.init_weights_(rtdetr.RTDETR(num_queries=30)).train()
    cfg = train.DetrTrainConfig(batch=2, lr=3e-4, warmup=1, steps=7)
    tx = train.AdamW(m.parameters(), train.warmup_cosine_schedule(
        cfg.lr, cfg.warmup, 100, cfg.lr / 20), cfg.weight_decay,
        cfg.max_norm)
    g = torch.Generator().manual_seed(1)
    x = torch.rand(2, 3, *HW, generator=g)
    gt = torch.tensor([[[0.3, 0.3, 0.2, 0.3], [0.7, 0.6, 0.3, 0.2]],
                       [[0.5, 0.5, 0.4, 0.4], [0.0, 0.0, 0.0, 0.0]]])
    cls = torch.tensor([[0, 2], [5, 0]])
    valid = torch.tensor([[True, True], [True, False]])
    losses = []
    for _ in range(7):      # the first update runs at learning rate 0
        loss, parts = train.detr_loss(train.detr_outputs(m, x), gt, cls,
                                      valid, cfg)
        assert set(parts) == {"class", "bbox", "giou"}
        losses.append(float(loss.detach()))
        tx.zero_grad()
        loss.backward()
        tx.step()
    # the matching moves from step to step, so the loss is not monotone:
    # the last two steps' mean against the start
    assert np.mean(losses[-2:]) < 0.9 * losses[0]


def test_the_detr_targets_are_normalized_letterbox_boxes():
    from aicamera_tpu_torch.ops.preprocess import letterbox_spec
    spec = letterbox_spec((100, 200), HW)
    boxes = torch.tensor([[[0.0, 0.0, 200.0, 100.0], [10.0, 10.0, 10.5,
                                                       20.0]]])
    out, ok = train.detr_targets(boxes, torch.zeros(1, 2, dtype=torch.int32),
                                 torch.ones(1, 2, dtype=torch.bool), spec, HW)
    # the whole frame is the letterboxed content: full width, half height
    assert torch.allclose(out[0, 0], torch.tensor([0.5, 0.5, 1.0, 0.5]))
    assert ok.tolist() == [[True, False]]       # under a pixel wide


def _frames(n=4, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (n, 120, 200, 3),
                                                dtype=np.uint8)


@pytest.fixture(scope="module")
def weights_file(tmp_path_factory, nets):
    _, tree, _, _, _ = nets
    path = tmp_path_factory.mktemp("rtdetr") / "rtdetr.msgpack"
    path.write_bytes(write_flax_msgpack(tree))
    return str(path)


def test_the_pipeline_runs_rtdetr_in_its_captured_step(weights_file):
    pipe = pl.TrackingPipeline(detector="rtdetr-l", input_shape=HW,
                               tracker="bytetrack", yolo_weights=weights_file,
                               chunk_size=2, device="cpu")
    assert pipe.yolo is None and pipe.rtdetr.fused
    timer = pipe.stage_timer = CudaStageTimer()
    frames = _frames()
    got = list(pipe.process_frames(iter(frames)))
    assert len(got) == 4
    (key, step), = pipe._steps.items()
    assert key[-1] == "stamped"
    assert step.stamps == ["entry", "letterbox", "backbone", "encoder",
                           "decoder", "post", "crops_reid", "tracker"]
    assert all(timer.totals[s] > 0 for s in step.stamps[1:])
    assert timer.dets[1] == 4
    # the detections are the model's own through its post-process
    from aicamera_tpu_torch.ops.letterbox import letterbox
    from aicamera_tpu_torch.ops.preprocess import (letterbox_spec,
                                                   scale_boxes_back)
    spec = letterbox_spec((120, 200), HW)
    with torch.no_grad():
        x = letterbox(torch.from_numpy(frames), spec, torch.float32)
        num, boxes, scores, labels = rtdetr.postprocess(
            *pipe.rtdetr(x), HW, pipe._nms_score_floor, 100)
    boxes = scale_boxes_back(boxes, spec)
    for f, r in enumerate(got):
        v = (np.arange(100) < int(num[f])) & (scores[f].numpy()
                                              >= pipe.conf_threshold)
        assert np.array_equal(r.det_scores, scores[f].numpy()[v])
        assert np.array_equal(r.det_boxes, boxes[f].numpy()[v])
        assert np.array_equal(r.det_labels, labels[f].numpy()[v])


def test_the_multistream_pipeline_takes_the_detector(weights_file):
    from aicamera_tpu_torch.parallel import MultiStreamPipeline
    m = MultiStreamPipeline(2, (120, 200), detector="rtdetr-l",
                            input_shape=HW, tracker="bytetrack",
                            yolo_weights=weights_file, device="cpu")
    assert m._engine.rtdetr is not None
    outs = m.step_chunk(_frames().reshape(2, 2, 120, 200, 3))
    assert outs[0].shape[:2] == (2, 2)


def test_combinations_without_an_rtdetr_path_raise(weights_file):
    with pytest.raises(ValueError, match="yolo_quant"):
        pl.TrackingPipeline(detector="rtdetr-l", yolo_quant="int8",
                            yolo_weights=weights_file, device="cpu")
    with pytest.raises(ValueError, match="detector must be"):
        pl.TrackingPipeline(detector="rtdetr-x", device="cpu")
    with pytest.raises(FileNotFoundError):
        pl.TrackingPipeline(detector="rtdetr-l", yolo_weights="missing.pt",
                            device="cpu")


def test_the_yolov8_default_and_its_step_are_unchanged():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a = pl.TrackingPipeline(input_shape=HW, tracker="bytetrack",
                                chunk_size=2, device="cpu")
        b = pl.TrackingPipeline(input_shape=HW, tracker="bytetrack",
                                chunk_size=2, device="cpu",
                                detector="yolov8")
    assert a.detector == "yolov8" and a.rtdetr is None
    frames = _frames()
    ra = list(a.process_frames(iter(frames)))
    rb = list(b.process_frames(iter(frames)))
    for x, y in zip(ra, rb):
        assert np.array_equal(x.det_boxes, y.det_boxes)
        assert x.tracks == y.tracks
    (_, step), = a._steps.items()
    # the untimed step packs the three decisions and no stamp
    assert step.stamps is None and step.layout.meta[-1][0] == (3,)


def test_the_flop_count_is_near_the_published_110_gflops():
    # Table 2 of the paper: 110 GFLOPs at 640 (two a multiply-add)
    flops = family.flops({"pipeline": {"input_hw": [640, 640]}})
    assert abs(flops / 110e9 - 1) <= 0.10
