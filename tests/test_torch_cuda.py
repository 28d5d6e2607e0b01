"""Port: tests that need an NVIDIA GPU (the CUDA kernels have no CPU mode).

They skip on a host without one. On the GPU host, which has no JAX (and
``tests/conftest.py`` imports the JAX package, hence ``--noconftest``):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q \
        -p no:cacheprovider
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from aicamera_tpu_torch.ops import letterbox as lb  # noqa: E402
from aicamera_tpu_torch.ops import nms as tnms  # noqa: E402
from aicamera_tpu_torch.ops.preprocess import letterbox_spec  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    PyTorch's thread pool oversubscribes the cores (small convolutions then
    run ~100x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("src,dst,auto", [((540, 960), (640, 640), False),
                                          ((1080, 1920), (640, 640), False),
                                          ((640, 640), (640, 640), False),
                                          ((240, 320), (640, 640), False),
                                          ((540, 960), (640, 640), True),
                                          ((37, 1999), (128, 96), False),
                                          # source rows off the 16-byte grid
                                          ((101, 333), (640, 640), False),
                                          ((360, 636), (640, 640), False),
                                          # a left pad that splits groups
                                          ((100, 48), (128, 120), False),
                                          # an odd Dh: a ragged last tile
                                          ((37, 64), (31, 40), False),
                                          # ratio 3: one staged row a row
                                          ((108, 192), (64, 64), False),
                                          # a band beyond 48 KB
                                          ((16, 8208), (64, 640), False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_bitwise_equals_plain_version(cuda, src, dst, auto, dtype):
    spec = letterbox_spec(src, dst, auto=auto)
    gen = torch.Generator(device=cuda).manual_seed(0)
    frames = torch.randint(0, 256, (3, *src, 3), dtype=torch.uint8,
                           device=cuda, generator=gen)
    launches = lb.KERNEL.launches
    out = lb.letterbox(frames, spec, dtype)
    assert lb.KERNEL.launches == launches + 1
    # the variant that ran is the one the plan names for these shapes
    assert lb.KERNEL.last_plan == lb.launch_plan(spec, 3, dtype)
    assert lb.KERNEL.last_plan.variant == \
        ("vector" if src[1] % 16 == 0 else "scalar")
    ref = lb.letterbox_plain(frames, spec, dtype)
    torch.cuda.synchronize()
    assert out.shape == (3, 3, *spec.out_hw) and out.dtype == dtype
    assert torch.equal(out, ref)  # tolerance: bitwise


@pytest.mark.parametrize("variant", ["scalar", "vector"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_both_variants_agree(cuda, variant, dtype):
    """An aligned shape through each variant by name. Tolerance: bitwise."""
    spec = letterbox_spec((540, 960), (640, 640))
    gen = torch.Generator(device=cuda).manual_seed(1)
    frames = torch.randint(0, 256, (2, 540, 960, 3), dtype=torch.uint8,
                           device=cuda, generator=gen)
    out = lb.KERNEL(frames, spec, dtype, variant=variant)
    assert lb.KERNEL.last_plan.variant == variant
    ref = lb.letterbox_plain(frames, spec, dtype)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def test_unaligned_pointer_takes_the_scalar_variant(cuda):
    spec = letterbox_spec((54, 96), (64, 64))
    buf = torch.randint(0, 256, (2 * 54 * 96 * 3 + 1,), dtype=torch.uint8,
                        device=cuda)
    frames = buf[1:].view(2, 54, 96, 3)
    assert frames.data_ptr() % 16 != 0
    out = lb.letterbox(frames, spec)
    assert lb.KERNEL.last_plan.variant == "scalar"
    torch.cuda.synchronize()
    assert torch.equal(out, lb.letterbox_plain(frames, spec))
    with pytest.raises(ValueError, match="vector variant"):
        lb.KERNEL(frames, spec, torch.float32, variant="vector")


def test_kernel_rejects_bad_input(cuda):
    spec = letterbox_spec((54, 96), (64, 64))
    frames = torch.zeros((2, 54, 96, 3), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        lb.letterbox(frames.transpose(1, 2).contiguous().transpose(1, 2),
                     spec)
    with pytest.raises(TypeError):
        lb.letterbox(frames.float(), spec)


def test_pipeline_launches_the_kernel_once_per_chunk(cuda):
    from aicamera_tpu_torch import config
    from aicamera_tpu_torch.core.state import TrackerParams
    from aicamera_tpu_torch.runtime.pipeline import TrackingPipeline
    from aicamera_tpu_torch.scenes import moving_rectangles
    pipe = TrackingPipeline(
        input_shape=(256, 256), chunk_size=2, synthetic_load=8,
        max_reid_crops=4,
        tracker_params=TrackerParams(max_tracks=16, max_detections=8,
                                     nn_budget=4, max_age=10),
        yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
        reid_weights=str(config.REID_SYNTHETIC_PATH))
    frames = moving_rectangles(6, (180, 320), n_objects=3, seed=3)
    launches = lb.KERNEL.launches
    results = list(pipe.process_frames(iter(frames)))
    assert lb.KERNEL.launches == launches + 3
    assert len(results) == 6
    assert all(np.isfinite(r.det_boxes).all() for r in results)
    assert len(results[-1].tracks) > 0


ASSIGNMENT_FAMILIES = sorted({f for f, _, _ in
                              chip_smoke.assignment_cases()})


@pytest.mark.parametrize("family", ASSIGNMENT_FAMILIES)
def test_assignment_kernel_bitwise_equals_plain_version(cuda, family):
    """``chip_smoke.assignment_cases``: realistic DeepSORT loads at 128 and
    32 track slots, ties (with -0.0), nothing feasible, one row, R < C and
    R > C, n = 256 (staged and in device memory), cascades over 1, 2, 5 and
    70 levels, the OC-SORT and ByteTrack costs. The public functions launch
    the kernel once each; the outputs equal the plain version's on the same
    card tensors bitwise."""
    from aicamera_tpu_torch.core import assignment as asg
    from aicamera_tpu_torch.ops.assignment import KERNEL
    public = {"match": asg.min_cost_matching,
              "cascade": asg.matching_cascade}
    plain = {"match": asg.min_cost_matching_plain,
             "cascade": asg.matching_cascade_plain}
    for fam, kind, args in chip_smoke.assignment_cases():
        if fam != family:
            continue
        a = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
             if isinstance(x, np.ndarray) else x for x in args]
        launches = KERNEL.launches
        got = public[kind](*a)
        assert KERNEL.launches == launches + 1
        want = plain[kind](*a)
        got, want = (got, want) if kind == "cascade" else ((got,), (want,))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("family", ASSIGNMENT_FAMILIES)
def test_assignment_v1_bitwise_equals_plain_version(cuda, family):
    """The first design (``variant="v1"``, kept for measurements, on no
    path) on the same problems: bitwise the plain version, as the default
    design is."""
    from aicamera_tpu_torch.core import assignment as asg
    from aicamera_tpu_torch.ops.assignment import KERNEL
    for fam, kind, args in chip_smoke.assignment_cases():
        if fam != family:
            continue
        a = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
             if isinstance(x, np.ndarray) else x for x in args]
        if kind == "cascade":
            got = KERNEL.matching_cascade(*a, variant="v1")
            want = asg.matching_cascade_plain(*a)
        else:
            got = (KERNEL.min_cost_matching(*a, variant="v1"),)
            want = (asg.min_cost_matching_plain(*a),)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


def test_assignment_takes_int32_levels_and_probes(cuda):
    """The kernel reads the tracker's int32 levels and nothing else (other
    types raise, no cast is launched); the probe's build counts its
    launches, solves and steps."""
    from aicamera_tpu_torch.core import assignment as asg
    from aicamera_tpu_torch.ops.assignment import KERNEL, AssignmentKernel
    fam, kind, args = next(c for c in chip_smoke.assignment_cases()
                           if c[0] == "5 levels")
    cost, level, elig, valid, max_d, depth = [
        torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
        if isinstance(x, np.ndarray) else x for x in args]
    want = asg.matching_cascade_plain(cost, level, elig, valid, max_d, depth)
    before = KERNEL.launches
    for bad in (level.long(), level.float()):
        with pytest.raises(TypeError, match="int32"):
            KERNEL.matching_cascade(cost, bad, elig, valid, max_d, depth)
    assert KERNEL.launches == before
    probe = AssignmentKernel(probe=True)
    probe.read_probe(reset=True)
    for variant in ("lanes", "v1"):
        got = probe.matching_cascade(cost, level, elig, valid, max_d, depth,
                                     variant=variant)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    sums = probe.read_probe()
    assert sums["problems"] == 2 and sums["solves"] >= 2
    assert sums["steps"] >= sums["rows_augmented"] > 0
    assert sums["total"] >= sums["augment"] > 0


BATCH_FAMILIES = sorted({f for f, _, _ in chip_smoke.assignment_batches()})


@pytest.mark.parametrize("family", BATCH_FAMILIES)
def test_batched_assignment_bitwise_equals_plain_version(cuda, family):
    """``chip_smoke.assignment_batches``: B = 8 problems a launch, the
    recorded main-path problems 8 at a time, seeded loads at 128x64 and
    32x64, and mixed batches (no eligible row, every row eligible, recorded
    ones). One launch a batch, each problem bitwise the plain version's,
    and the probe's build counts 8 problems a launch."""
    from aicamera_tpu_torch.core import assignment as asg
    from aicamera_tpu_torch.ops.assignment import KERNEL, AssignmentKernel
    public = {"match": asg.min_cost_matching,
              "cascade": asg.matching_cascade}
    plain = {"match": asg.min_cost_matching_plain,
             "cascade": asg.matching_cascade_plain}
    probe = AssignmentKernel(probe=True)
    probe.read_probe(reset=True)
    n = 0
    for fam, kind, args in chip_smoke.assignment_batches():
        if fam != family:
            continue
        a = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
             if isinstance(x, np.ndarray) else x for x in args]
        launches = KERNEL.launches
        got = public[kind](*a)
        assert KERNEL.launches == launches + 1
        fn = (probe.matching_cascade if kind == "cascade"
              else probe.min_cost_matching)
        probed = fn(*a)
        want = plain[kind](*a)
        got, probed, want = ((got, probed, want) if kind == "cascade"
                             else ((got,), (probed,), (want,)))
        for g, p_, w in zip(got, probed, want):
            assert g.shape[0] == 8 and g.dtype == w.dtype
            assert torch.equal(g, w) and torch.equal(p_, w)
        n += 1
    assert n and probe.read_probe()["problems"] == 8 * n


def test_a_misaligned_batch_raises(cuda):
    """A batch whose problems would not start 16-byte aligned (C % 4 != 0,
    a start off the 16-byte grid, a strided layout) raises, as does a batch
    for the single-problem first design; nothing launches or is copied."""
    from aicamera_tpu_torch.ops.assignment import KERNEL
    rows = torch.ones(8, 32, dtype=torch.bool, device=cuda)
    base = torch.rand(8 * 32 * 64 + 1, device=cuda)
    bad = [torch.rand(8, 32, 62, device=cuda),
           base[1:].view(8, 32, 64),
           torch.rand(8, 64, 32, device=cuda).transpose(1, 2)]
    before = KERNEL.launches
    for cost in bad:
        cols = torch.ones(8, cost.shape[2], dtype=torch.bool, device=cuda)
        with pytest.raises(ValueError, match="16-byte"):
            KERNEL.min_cost_matching(cost, rows, cols, 0.7)
    cost = torch.rand(8, 32, 64, device=cuda)
    cols = torch.ones(8, 64, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="one problem"):
        KERNEL.min_cost_matching(cost, rows, cols, 0.7, variant="v1")
    assert KERNEL.launches == before
    KERNEL.min_cost_matching(cost, rows, cols, 0.7)
    assert KERNEL.launches == before + 1


def test_stream_stack_scan_reads_nothing_and_replays_once(cuda):
    """A DeepSORT stream stack on the card: its chunk step (the captured
    scan of all streams) runs under CUDA's sync debug mode "error" (no read
    back), replays once a dispatch with 2 K assignment launches, and its
    tracks equal the streams stepped one by one through the same stage on
    the same detections (ids, classes, boxes identical, conf within
    1e-4). Through ``step_chunk`` with ``scan_bucket`` 8: at most two
    bucket reads and no tracker read a dispatch."""
    from aicamera_tpu_torch import config
    from aicamera_tpu_torch.core.assignment import TRACKER_SYNCS
    from aicamera_tpu_torch.core.state import TrackerParams
    from aicamera_tpu_torch.ops.assignment import KERNEL
    from aicamera_tpu_torch.parallel import MultiStreamPipeline
    from aicamera_tpu_torch.runtime.pipeline import (BUCKET_SYNCS,
                                                     _format_tracks)
    from aicamera_tpu_torch.scenes import moving_rectangles
    s, k, hw = 3, 2, (180, 320)
    kw = dict(input_shape=(256, 256), max_reid_crops=4, detect_dtype="f32",
              reid_dtype="f32",
              tracker_params=TrackerParams(max_tracks=16, max_detections=8,
                                           nn_budget=4, max_age=10),
              yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
              reid_weights=str(config.REID_SYNTHETIC_PATH))
    frames = np.stack([moving_rectangles(3 * k, hw, n_objects=3, seed=q)
                       for q in (3, 5, 7)])
    pipe = MultiStreamPipeline(s, hw, scan_bucket=0, device=cuda, **kw)
    assert pipe.stacked
    detect, track = pipe._engine._get_stages(hw)
    valid = np.ones((s, k), bool)
    valid[1, 1] = False
    stack = pipe.states
    singles = [pipe._engine._init_tracker_state() for _ in range(s)]
    got, want = [], []
    for c in range(3):
        chunk = torch.from_numpy(frames[:, c * k:(c + 1) * k]).to(cuda)
        with torch.no_grad():
            inputs, _ = detect(chunk.reshape(s * k, *chunk.shape[2:]))
            track(stack, inputs.by_frame(s, k), valid.T)   # the capture
            replays, launches = pipe.scan_replays(), KERNEL.launches
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                stack, outs = track(stack, inputs.by_frame(s, k), valid.T)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert pipe.scan_replays() == replays + 1
            assert KERNEL.launches == launches + 2 * k
            for si in range(s):
                singles[si], o = track(singles[si], inputs.frames(
                    si * k, (si + 1) * k), valid[si])
                want.append([_format_tracks(*(x[t].cpu().numpy() for x in o))
                             for t in range(k)])
                got.append([_format_tracks(*(x[t, si].cpu().numpy()
                                             for x in outs))
                            for t in range(k)])
    for g, w in zip(got, want):
        for gf, wf in zip(g, w):
            assert [t[:6] for t in gf] == [t[:6] for t in wf]
            assert all(abs(a[6] - b[6]) <= 1e-4 for a, b in zip(gf, wf))
    assert sum(len(f) for g in got for f in g) > 0

    pipe = MultiStreamPipeline(s, hw, scan_bucket=8, device=cuda, **kw)
    pipe.step_chunk(frames[:, :k])   # captures
    reads, bucket = TRACKER_SYNCS.count, BUCKET_SYNCS.count
    replays, reruns = pipe.scan_replays(), pipe.scan_stats["rerun"]
    for c in range(1, 3):
        pipe.step_chunk(frames[:, c * k:(c + 1) * k], frame_valid=valid)
    assert TRACKER_SYNCS.count == reads
    assert BUCKET_SYNCS.count - bucket <= 2 * 2
    assert pipe.scan_replays() - replays \
        == 2 + pipe.scan_stats["rerun"] - reruns


@pytest.mark.parametrize("tracker,solves", [("bytetrack", 3),
                                            ("ocsort", 2)])
def test_motion_stack_scan_reads_nothing_and_replays_once(cuda, tracker,
                                                          solves):
    """A ByteTrack and an OC-SORT stream stack on the card: the chunk step
    (the captured scan of all streams) runs under CUDA's sync debug mode
    "error" (no read back), replays once a dispatch with 3 K (ByteTrack) or
    2 K (OC-SORT) assignment launches and K ORU launches (OC-SORT), and its
    tracks equal the streams stepped one by one through the same stage on
    the same detections (ids, classes, boxes identical, conf within
    1e-4)."""
    from aicamera_tpu_torch import config
    from aicamera_tpu_torch.core.bytetrack import ByteTrackParams
    from aicamera_tpu_torch.core.ocsort import OCSortParams
    from aicamera_tpu_torch.ops.assignment import KERNEL
    from aicamera_tpu_torch.ops.oru import KERNEL as ORU
    from aicamera_tpu_torch.parallel import MultiStreamPipeline
    from aicamera_tpu_torch.runtime.pipeline import _format_tracks
    from aicamera_tpu_torch.scenes import moving_rectangles
    s, k, hw = 3, 2, (180, 320)
    slots = dict(max_tracks=16, max_detections=8)
    core = (dict(bytetrack_params=ByteTrackParams(track_thresh=0.4, **slots))
            if tracker == "bytetrack"
            else dict(ocsort_params=OCSortParams(det_thresh=0.4, **slots)))
    pipe = MultiStreamPipeline(
        s, hw, scan_bucket=0, device=cuda, input_shape=(256, 256),
        max_reid_crops=4, detect_dtype="f32", reid_dtype="f32",
        tracker=tracker, yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
        reid_weights=str(config.REID_SYNTHETIC_PATH), **core)
    frames = np.stack([moving_rectangles(3 * k, hw, n_objects=3, seed=q)
                       for q in (3, 5, 7)])
    detect, track = pipe._engine._get_stages(hw)
    valid = np.ones((s, k), bool)
    valid[1, 1] = False
    stack = pipe.states
    singles = [pipe._engine._init_tracker_state() for _ in range(s)]
    got, want = [], []
    for c in range(3):
        chunk = torch.from_numpy(frames[:, c * k:(c + 1) * k]).to(cuda)
        with torch.no_grad():
            inputs, _ = detect(chunk.reshape(s * k, *chunk.shape[2:]))
            track(stack, inputs.by_frame(s, k), valid.T)   # the capture
            counts = (pipe.scan_replays(), KERNEL.launches, ORU.launches)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                stack, outs = track(stack, inputs.by_frame(s, k), valid.T)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert (pipe.scan_replays(), KERNEL.launches, ORU.launches) \
                == (counts[0] + 1, counts[1] + solves * k,
                    counts[2] + (k if tracker == "ocsort" else 0))
            for si in range(s):
                singles[si], o = track(singles[si], inputs.frames(
                    si * k, (si + 1) * k), valid[si])
                want.append([_format_tracks(*(x[t].cpu().numpy() for x in o))
                             for t in range(k)])
                got.append([_format_tracks(*(x[t, si].cpu().numpy()
                                             for x in outs))
                            for t in range(k)])
    for g, w in zip(got, want):
        for gf, wf in zip(g, w):
            assert [t[:6] for t in gf] == [t[:6] for t in wf]
            assert all(abs(a[6] - b[6]) <= 1e-4 for a, b in zip(gf, wf))
    assert sum(len(f) for g in got for f in g) > 0


def test_oru_kernel_matches_its_plain_version(cuda):
    """Both designs of the ORU kernel on ``chip_smoke.oru_cases`` (every gap
    0 to 31, mixed masks, no replay, all slots at 8 and 31, a ragged stack
    of 111 slots, degenerate boxes and gaps): the default through
    ``oru_replay`` and v1 through the wrapper, one launch a call; the
    default bitwise v1 on every lane (NaN where NaN); both within 1e-5 of
    each slot's largest entry of ``oru_replay_plain`` on the same tensors;
    slots without a replay keep their input bitwise; CPU tensors raise."""
    from aicamera_tpu_torch.core import ocsort as oc
    from aicamera_tpu_torch.ops.oru import KERNEL, VARIANTS
    max_gap = chip_smoke.ORU_MAX_AGE + 1
    for name, args in chip_smoke.oru_cases():
        card = [a.to(cuda) for a in args]
        before = KERNEL.launches
        got = oc.oru_replay(*card, max_gap)
        assert KERNEL.launches == before + 1
        old = KERNEL(*card, max_gap, variant="v1")
        assert KERNEL.launches == before + 2
        same, lanes = chip_smoke.oru_lanes_same(got, old)
        assert same == lanes, (name, lanes - same)
        want = oc.oru_replay_plain(*card, max_gap)
        for out in (got, old):
            rel, _, _ = chip_smoke.oru_compare(out, want)
            assert rel <= chip_smoke.ORU_TOL, (name, rel)
        idle = ~card[4]
        for out in (got, old):
            assert torch.equal(out[0][idle], card[0][idle]), name
            assert torch.equal(out[1][idle], card[1][idle]), name
    for variant in VARIANTS:
        with pytest.raises(ValueError, match="CUDA"):
            KERNEL(*chip_smoke.oru_cases()[0][1], max_gap, variant=variant)


@pytest.mark.parametrize("variant", ["rows", "v1"])
def test_oru_variant_launches_once_and_rejects_unknown(cuda, variant):
    """``oru_replay(variant=...)`` on card tensors: one launch of the named
    design, bitwise the wrapper's; an unknown design raises before any
    launch."""
    from aicamera_tpu_torch.core import ocsort as oc
    from aicamera_tpu_torch.ops.oru import KERNEL
    card = [a.to(cuda) for a in chip_smoke.oru_inputs(2, seed=11)]
    max_gap = chip_smoke.ORU_MAX_AGE + 1
    before = KERNEL.launches
    got = oc.oru_replay(*card, max_gap, variant=variant)
    assert KERNEL.launches == before + 1
    want = KERNEL(*card, max_gap, variant=variant)
    assert chip_smoke.oru_lanes_same(got, want) == (256, 256)
    with pytest.raises(ValueError, match="variant"):
        oc.oru_replay(*card, max_gap, variant="lanes")
    assert KERNEL.launches == before + 2


def test_oru_designs_agree_off_the_16_byte_grid(cuda):
    """A stack whose x and p start 4 bytes past the 16-byte grid (views into
    larger buffers) takes the default design's scalar copy: still bitwise
    v1 and within 1e-5 of the plain version, idle slots unchanged."""
    from aicamera_tpu_torch.core import ocsort as oc
    from aicamera_tpu_torch.ops.oru import KERNEL
    x, p, *rest = [a.to(cuda) for a in chip_smoke.oru_inputs(3, seed=12,
                                                             t=37)]
    xs = torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape)
    ps = torch.empty(p.numel() + 1, device=cuda)[1:].view(p.shape)
    xs.copy_(x)
    ps.copy_(p)
    assert xs.data_ptr() % 16 and ps.data_ptr() % 16
    max_gap = chip_smoke.ORU_MAX_AGE + 1
    got = oc.oru_replay(xs, ps, *rest, max_gap)
    old = KERNEL(xs, ps, *rest, max_gap, variant="v1")
    assert chip_smoke.oru_lanes_same(got, old) == (111, 111)
    assert chip_smoke.oru_lanes_same(got, oc.oru_replay(
        x, p, *rest, max_gap)) == (111, 111)
    rel, _, _ = chip_smoke.oru_compare(got, oc.oru_replay_plain(
        xs, ps, *rest, max_gap))
    assert rel <= chip_smoke.ORU_TOL
    idle = ~rest[2]
    assert torch.equal(got[1][idle], p[idle])


def test_oru_probe_build_counts_slots_and_steps(cuda):
    """The probe build (``-DAICAM_ORU_PROBE``) of both designs: outputs
    bitwise the plain build's v1, one slot counted a slot, the replaying
    slots and their ``min(gap, max_gap)`` steps, one block per 8 slots
    (rows) or 128 (v1), and cycles in every phase."""
    from aicamera_tpu_torch.ops.oru import KERNEL, OruKernel
    probe = OruKernel(probe=True)
    card = [a.to(cuda) for a in chip_smoke.oru_inputs(3, seed=13, t=37)]
    max_gap = chip_smoke.ORU_MAX_AGE + 1
    want = KERNEL(*card, max_gap, variant="v1")
    replay, gap = card[4], card[5]
    steps = int(gap.clamp(max=max_gap)[replay].clamp(min=0).sum())
    for variant, per_block in (("rows", 8), ("v1", 128)):
        probe.read_probe(reset=True)
        got = probe(*card, max_gap, variant=variant)
        torch.cuda.synchronize()
        sums = probe.read_probe(reset=True)
        assert chip_smoke.oru_lanes_same(got, want) == (111, 111)
        assert sums["slots"] == 111
        assert sums["replaying"] == int(replay.sum())
        assert sums["steps"] == steps
        assert sums["blocks"] == -(-111 // per_block)
        assert min(sums[k] for k in ("load", "gain", "joseph", "predict",
                                     "store", "total")) > 0
    assert probe.launches == 2


@pytest.mark.parametrize("b", [1, 8])
def test_batched_solves_with_empty_masks_match_nothing(cuda, b):
    """The kernel with no eligible row, no eligible column or neither: -1
    everywhere (and the cascade's detections all unmatched), as the plain
    version; the read-free stages of the motion cores rely on it."""
    from aicamera_tpu_torch.core import assignment as asg
    rng = np.random.RandomState(b)
    cost = torch.from_numpy(rng.uniform(0, 1, (b, 128, 64)).astype(
        np.float32)).to(cuda)
    rows = torch.from_numpy(rng.rand(b, 128) < 0.5).to(cuda)
    cols = torch.from_numpy(rng.rand(b, 64) < 0.5).to(cuda)
    levels = torch.ones((b, 128), dtype=torch.int32, device=cuda)
    for r, c in ((torch.zeros_like(rows), cols),
                 (rows, torch.zeros_like(cols)),
                 (torch.zeros_like(rows), torch.zeros_like(cols))):
        got = asg.min_cost_matching(cost, r, c, 0.9)
        assert (got == -1).all()
        assert torch.equal(got, asg.min_cost_matching_plain(cost, r, c, 0.9))
        one = asg.min_cost_matching(cost[0], r[0], c[0], 0.9)
        assert (one == -1).all()
        match, unmatched = asg.matching_cascade(cost, levels, r, c, 0.9, 3)
        assert (match == -1).all() and torch.equal(unmatched, c)


def test_a_deepsort_frame_is_two_assignment_launches(cuda):
    """A DeepSORT frame launches the assignment kernel twice (the cascade
    and the IoU solve) and nothing for the levels: captured, the cascade
    on the tracker's int32 ``tsu`` is one graph node (the first design
    clamps and casts them first: two)."""
    from aicamera_tpu_torch.core import assignment as asg
    from aicamera_tpu_torch.core import state as tstate
    from aicamera_tpu_torch.core import tracker as ttrk
    from aicamera_tpu_torch.ops.assignment import KERNEL
    from aicamera_tpu_torch.runtime.engine import CUDAGraphEngine
    p = tstate.TrackerParams(max_tracks=16, max_detections=8, nn_budget=4,
                             feature_dim=16, n_init=1, max_age=5)
    rng = np.random.RandomState(0)
    st = tstate.init_state(p, device=cuda)
    for t in range(4):
        tlwh = np.array([[50.0 + 120 * o + 3 * t, 60.0, 40.0, 80.0]
                         for o in range(4)], np.float32)
        feat = rng.normal(0, 1, (4, 16)).astype(np.float32)
        dets = tstate.make_detections(
            tlwh, np.full(4, 0.8, np.float32), np.zeros(4, np.int32), feat,
            np.ones(4, bool), params=p, device=cuda)
        before = KERNEL.launches
        st = ttrk.update(ttrk.predict(st, p), dets, p)
        torch.cuda.synchronize()
        assert KERNEL.launches == before + 2
    assert st.tsu.dtype == torch.int32 and bool(st.active.any())
    cost = torch.rand(16, 8, device=cuda)
    elig, valid = st.active.clone(), torch.ones(8, dtype=torch.bool,
                                                device=cuda)
    for variant, nodes in (("lanes", 1), ("v1", 2)):
        eng = CUDAGraphEngine(
            lambda c, lv, e, v: KERNEL.matching_cascade(
                c, lv, e, v, 0.2, 5, variant=variant),
            [cost, st.tsu, elig, valid], name=f"cascade {variant}",
            warmup_iters=1, device=cuda)
        got = eng(cost, st.tsu, elig, valid)
        want = asg.matching_cascade_plain(cost, st.tsu, elig, valid, 0.2, 5)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        if eng.graph_nodes() is not None:
            assert eng.graph_nodes() == nodes, variant


def test_deepsort_scan_on_the_card_reads_nothing_and_replays(cuda,
                                                             monkeypatch):
    """The DeepSORT pipeline on the card: no tracker read, a cascade and an
    IoU solve a frame through the kernel, and the captured scans' tracks
    equal to the eager scans' (frame by frame, invalid frames skipped on
    the host). A capture's eager warm-up pass and its padding frames launch
    too, so only the eager run's count is exact."""
    from aicamera_tpu_torch import config
    from aicamera_tpu_torch.core.assignment import TRACKER_SYNCS
    from aicamera_tpu_torch.core.state import TrackerParams
    from aicamera_tpu_torch.ops.assignment import KERNEL
    from aicamera_tpu_torch.runtime import pipeline as pl
    from aicamera_tpu_torch.scenes import moving_rectangles

    def run():
        pipe = pl.TrackingPipeline(
            input_shape=(256, 256), chunk_size=2, synthetic_load=8,
            max_reid_crops=4, scan_bucket=0, detect_dtype="f32",
            reid_dtype="f32",
            tracker_params=TrackerParams(max_tracks=16, max_detections=8,
                                         nn_budget=4, max_age=10),
            yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
            reid_weights=str(config.REID_SYNTHETIC_PATH))
        reads, launches = TRACKER_SYNCS.count, KERNEL.launches
        out = [r.tracks for r in pipe.process_frames(iter(frames))]
        return out, TRACKER_SYNCS.count - reads, KERNEL.launches - launches

    frames = moving_rectangles(7, (180, 320), n_objects=3, seed=3)
    captured, reads, launches = run()
    assert reads == 0 and launches >= 2 * len(frames)
    monkeypatch.setattr(pl.TrackingPipeline, "_capture_scans", False)
    eager, reads, launches = run()
    assert reads == 0 and launches == 2 * len(frames)
    assert sum(map(len, captured)) > 0 and captured == eager


@pytest.mark.parametrize("tracker", ["bytetrack", "botsort", "ocsort",
                                     "deepocsort", "strongsort"])
def test_tracker_on_the_card_matches_the_cpu_path(cuda, tracker):
    """Each tracker core, card f32 (TF32 off) against the CPU path on the
    same frames: counts, labels and track tuples identical, boxes within
    1e-2 px, conf within 1e-4; the kernel runs once per chunk. StrongSORT
    runs its preset's camera-motion compensation."""
    from aicamera_tpu_torch import config
    from aicamera_tpu_torch.core.bytetrack import ByteTrackParams
    from aicamera_tpu_torch.core.ocsort import OCSortParams
    from aicamera_tpu_torch.runtime.pipeline import TrackingPipeline
    from aicamera_tpu_torch.scenes import moving_rectangles
    cap = dict(max_tracks=16, max_detections=8)
    app = dict(with_appearance=tracker in ("botsort", "deepocsort"))
    kw = dict(input_shape=(256, 256), chunk_size=2, synthetic_load=8,
              max_reid_crops=4, tracker=tracker,
              yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
              reid_weights=str(config.REID_SYNTHETIC_PATH))
    if tracker in ("bytetrack", "botsort"):
        kw["bytetrack_params"] = ByteTrackParams(track_thresh=0.4, **cap,
                                                 **app)
    elif tracker in ("ocsort", "deepocsort"):
        kw["ocsort_params"] = OCSortParams(det_thresh=0.4, **cap, **app)
    frames = moving_rectangles(6, (180, 320), n_objects=3, seed=3)
    launches = lb.KERNEL.launches
    gpu = list(TrackingPipeline(detect_dtype="f32", reid_dtype="f32",
                                **kw).process_frames(iter(frames)))
    assert lb.KERNEL.launches == launches + 3
    cpu = list(TrackingPipeline(device="cpu", **kw).process_frames(
        iter(frames)))
    assert sum(len(r.tracks) for r in gpu) > 0
    for g, c in zip(gpu, cpu, strict=True):
        assert len(g.det_boxes) == len(c.det_boxes)
        np.testing.assert_array_equal(g.det_labels, c.det_labels)
        np.testing.assert_allclose(g.det_boxes, c.det_boxes, atol=1e-2)
        assert [t[:6] for t in g.tracks] == [t[:6] for t in c.tracks]
        for tg, tc in zip(g.tracks, c.tracks):
            assert abs(tg[6] - tc[6]) <= 1e-4


def test_preprocess_yolo_launches_the_kernel(cuda):
    """The public single-frame preprocess on a CUDA tensor is the kernel (one
    launch), bitwise equal to the plain version in the JAX layout."""
    from aicamera_tpu_torch.ops.preprocess import preprocess_yolo
    spec = letterbox_spec((540, 960), (640, 640))
    gen = torch.Generator(device=cuda).manual_seed(2)
    frame = torch.randint(0, 256, (540, 960, 3), dtype=torch.uint8,
                          device=cuda, generator=gen)
    launches = lb.KERNEL.launches
    out = preprocess_yolo(frame, spec)
    assert lb.KERNEL.launches == launches + 1
    ref = lb.letterbox_plain(frame[None], spec).permute(0, 2, 3, 1)
    torch.cuda.synchronize()
    assert out.shape == (1, 640, 640, 3) and torch.equal(out, ref)


def test_detector_launches_the_kernel_per_call(cuda):
    """``detect``: one launch (K=1); ``detect_tiled``: two (the tiles, then
    the full frame), counted through the replays of their captured engines
    (the first call of each builds and captures it); card f32 against the
    CPU facade: identical counts and labels, boxes within 1e-2 px, scores
    within 1e-4."""
    from aicamera_tpu_torch import config
    from aicamera_tpu_torch.detector import YOLODetector
    from aicamera_tpu_torch.scenes import moving_rectangles
    kw = dict(input_shape=(256, 256), detect_dtype="f32")
    gpu = YOLODetector(str(config.YOLO_SYNTHETIC_PATH), **kw)
    cpu = YOLODetector(str(config.YOLO_SYNTHETIC_PATH), device="cpu", **kw)
    frame = moving_rectangles(1, (180, 320), n_objects=3, seed=3)[0]
    for call, n in (("detect", 1), ("detect_tiled", 2)):
        getattr(gpu, call)(frame)   # builds and captures the engine
        launches = lb.KERNEL.launches
        g = getattr(gpu, call)(frame)
        assert lb.KERNEL.launches == launches + n
        c = getattr(cpu, call)(frame)
        assert len(g[0]) == len(c[0]) > 0
        np.testing.assert_array_equal(g[2], c[2])
        np.testing.assert_allclose(g[0], c[0], atol=1e-2)
        np.testing.assert_allclose(g[1], c[1], atol=1e-4)


def test_gmc_on_the_card_matches_the_cpu_without_a_sync(cuda):
    """``estimate_chunk`` on the card reads nothing back (sync debug mode
    "error" raises on any synchronizing call) and agrees with the CPU: A
    within 1e-4, t within 1e-2 px."""
    from aicamera_tpu_torch.ops import gmc
    from aicamera_tpu_torch.scenes import panning_rectangles
    frames, _ = panning_rectangles(5, (540, 960), seed=1)
    spec = gmc.gmc_spec((540, 960))
    f_gpu = torch.from_numpy(frames).to(cuda)
    gmc.estimate_chunk(f_gpu[0], f_gpu, spec)  # plans and workspaces
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a, t = gmc.estimate_chunk(f_gpu[0], f_gpu, spec)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    a_cpu, t_cpu = gmc.estimate_chunk(torch.from_numpy(frames[0]),
                                      torch.from_numpy(frames), spec)
    np.testing.assert_allclose(a.cpu().numpy(), a_cpu.numpy(), atol=1e-4)
    np.testing.assert_allclose(t.cpu().numpy(), t_cpu.numpy(), atol=1e-2)


def test_multistream_on_the_card_matches_single_streams_and_the_cpu(cuda):
    """``MultiStreamPipeline`` on the card: one letterbox launch per
    dispatch for all S*K frames; in f32 (TF32 off) each stream's track
    tuples equal a single-stream ``TrackingPipeline`` on the card (ids,
    classes, boxes identical, conf within 1e-4) and the CPU path's; a
    masked stream's state is bitwise unchanged."""
    from aicamera_tpu_torch import config
    from aicamera_tpu_torch.core.state import TrackerParams
    from aicamera_tpu_torch.parallel import MultiStreamPipeline
    from aicamera_tpu_torch.runtime.pipeline import (TrackingPipeline,
                                                     _format_tracks)
    from aicamera_tpu_torch.scenes import moving_rectangles
    kw = dict(input_shape=(256, 256), max_reid_crops=4,
              tracker_params=TrackerParams(max_tracks=16, max_detections=8,
                                           nn_budget=4, max_age=10),
              yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
              reid_weights=str(config.REID_SYNTHETIC_PATH),
              detect_dtype="f32", reid_dtype="f32")
    frames = np.stack([moving_rectangles(4, (180, 320), n_objects=3,
                                         seed=s) for s in (3, 5)])
    pipes = {d: MultiStreamPipeline(2, (180, 320), device=d, **kw)
             for d in ("cuda", "cpu")}
    launches = lb.KERNEL.launches
    outs = {d: [p.step_chunk(frames[:, :2]), p.step_chunk(frames[:, 2:])]
            for d, p in pipes.items()}
    assert lb.KERNEL.launches == launches + 2
    before = pipes["cuda"].states
    pipes["cuda"].step_chunk(frames[:, 2:], frame_valid=np.array(
        [[True, True], [False, False]]))
    after = pipes["cuda"].states
    assert torch.equal(before.gallery[1], after.gallery[1])
    assert torch.equal(before.mean[1], after.mean[1])

    def tuples(o, si):
        return [_format_tracks(*(x[si, t].cpu().numpy() for x in o[c]))
                for c in range(2) for t in range(2)]

    n = 0
    for si in range(2):
        single = TrackingPipeline(chunk_size=2, device="cuda", **kw)
        want = [r.tracks for r in single.process_frames(iter(frames[si]))]
        for ref in (want, tuples(outs["cpu"], si)):
            for g, w in zip(tuples(outs["cuda"], si), ref, strict=True):
                assert [t[:6] for t in g] == [t[:6] for t in w]
                assert all(abs(a[6] - b[6]) <= 1e-4 for a, b in zip(g, w))
        n += sum(map(len, want))
    assert n > 0


def test_synthetic_world_on_the_card_matches_the_cpu(cuda):
    """The threefry draws, the rendering and the ground truth give the same
    bits on the card as on the CPU (integer hash, float64 multiply-adds)."""
    from aicamera_tpu_torch import prng
    from aicamera_tpu_torch.synthetic import TemporalWorld, WorldSpec
    kd = prng.PRNGKey(5)
    for lo, hi in ((0.0, 1.0), (-12.0, 12.0)):
        assert torch.equal(prng.uniform(kd, (1000,), lo, hi, cuda).cpu(),
                           prng.uniform(kd, (1000,), lo, hi, "cpu"))
    assert torch.equal(prng.randint(kd, (64,), 6, 18, cuda).cpu(),
                       prng.randint(kd, (64,), 6, 18, "cpu"))
    spec = WorldSpec(max_objects=10, presence=1.0)
    card = TemporalWorld(spec, seed=4, speed=3.0, device=cuda)
    host = TemporalWorld(spec, seed=4, speed=3.0, device="cpu")
    for _ in range(4):
        for a, b in zip(card.step(), host.step()):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tiled", [False, True])
def test_captured_detect_equals_the_eager_step(cuda, tiled):
    """The detect (or tiled) engine replayed from its CUDA graph against the
    eager step, f32 with TF32 off: bitwise; each replay counts the letterbox
    and NMS kernel launches it repeats (1 each, or 2 tiled)."""
    from aicamera_tpu_torch import config
    from aicamera_tpu_torch.detector import (YOLODetector, detect_step,
                                             tiled_step)
    from aicamera_tpu_torch.scenes import moving_rectangles
    det = YOLODetector(str(config.YOLO_SYNTHETIC_PATH),
                       input_shape=(256, 256), detect_dtype="f32")
    hw = (180, 320)
    if tiled:
        eng = det._tiled_engine(hw, (2, 2), 0.2, True, "iou")
        eager = tiled_step(det.model, det._dtype, hw, det.input_shape,
                           (2, 2), 0.2, True, "iou", det.conf_threshold,
                           det.nms_threshold)
    else:
        eng = det.get_engine(hw)
        eager = detect_step(det.model, det._dtype, det._spec(hw),
                            det.conf_threshold, det.nms_threshold)
    n = 0
    for f in moving_rectangles(3, hw, n_objects=3, seed=3):
        frame = torch.from_numpy(f).to(cuda)
        launches = lb.KERNEL.launches
        nms_launches = tnms.KERNEL.launches
        got = eng(frame)
        assert lb.KERNEL.launches == launches + (2 if tiled else 1)
        assert tnms.KERNEL.launches == nms_launches + (2 if tiled else 1)
        with torch.no_grad():
            want = eager(frame)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        n += int(got[3].sum())
    assert n > 0 and eng.replays == 3


def test_a_capture_that_reads_the_gpu_raises(cuda):
    """A step that reads the GPU (the detect step followed by the plain
    keep's early-exit form, which reads once an iteration): capturing it
    raises, with no eager fallback, and the card keeps working. The detect
    step itself reads nothing on the card (its keep is the NMS kernel) and
    captures."""
    from aicamera_tpu_torch import config
    from aicamera_tpu_torch.detector import YOLODetector, detect_step
    from aicamera_tpu_torch.ops.nms import greedy_keep_plain
    from aicamera_tpu_torch.runtime.engine import CUDAGraphEngine
    det = YOLODetector(str(config.YOLO_SYNTHETIC_PATH),
                       input_shape=(256, 256))
    eager = detect_step(det.model, det._dtype, det._spec((180, 320)),
                        det.conf_threshold, det.nms_threshold)

    def reads(frame):
        boxes, _, _, valid = eager(frame)
        return greedy_keep_plain(boxes[None], valid[None], 0.5)

    frame = torch.zeros((180, 320, 3), dtype=torch.uint8, device=cuda)
    with pytest.raises(RuntimeError, match="capture failed"):
        CUDAGraphEngine(reads, [frame], warmup_iters=1)
    assert torch.cuda.current_stream() == torch.cuda.default_stream()
    captured = CUDAGraphEngine(eager, [frame], warmup_iters=1)
    assert all(torch.equal(a, b) for a, b in zip(captured(frame),
                                                 eager(frame)))
    assert torch.cuda.current_stream() == torch.cuda.default_stream()
    assert det.get_engine((180, 320))(frame)[0].shape == (100, 4)


@pytest.mark.parametrize("shape,k,stride", [
    ((2, 128, 64, 3), 3, 1), ((8, 64, 32, 64), 3, 2),
    ((8, 32, 16, 128), 1, 2), ((1, 4, 2, 256), 3, 1),   # 8 rows < 17
    ((1, 80, 80, 40), 1, 1)])
def test_int8_conv_on_the_card_equals_the_cpu(cuda, shape, k, stride):
    """``torch._int_mm`` (cuBLASLt) int32 accumulators of the int8 im2col
    convolution, card against CPU: bitwise (integer sums are exact)."""
    from aicamera_tpu_torch.models.quant import gemm_weight, int8_conv
    rng = np.random.RandomState(sum(shape) + k)
    xq = torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8))
    w = torch.from_numpy(rng.randint(-127, 128, (k, k, shape[-1], 48))
                         .astype(np.int8))
    wm = gemm_weight(w)
    cpu = int8_conv(xq, wm, k, k, stride, k // 2, 48)
    gpu = int8_conv(xq.to(cuda), wm.to(cuda), k, k, stride, k // 2, 48)
    assert torch.equal(gpu.cpu(), cpu)


# --- a world on the card: NCCL, one rank ------------------------------------

_MESH_KW = dict(input_shape=(256, 256), max_reid_crops=4,
                detect_dtype="f32", reid_dtype="f32")


def _mesh_frames():
    from aicamera_tpu_torch.scenes import moving_rectangles
    return np.stack([moving_rectangles(4, (180, 320), n_objects=3, seed=s)
                     for s in (3, 5)])


def _mesh_pipeline(**kw):
    from aicamera_tpu_torch import config
    from aicamera_tpu_torch.core.state import TrackerParams
    from aicamera_tpu_torch.parallel import MultiStreamPipeline
    return MultiStreamPipeline(
        2, (180, 320), tracker_params=TrackerParams(
            max_tracks=16, max_detections=8, nn_budget=4, max_age=10),
        yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
        reid_weights=str(config.REID_SYNTHETIC_PATH), **_MESH_KW, **kw)


def _nccl_rank(rank, device):
    """The two streams on make_stream_mesh(1) and on make_mesh(1, 1)."""
    from aicamera_tpu_torch.parallel import make_mesh, make_stream_mesh
    from aicamera_tpu_torch.parallel.distributed import COLLECTIVES
    frames, out = _mesh_frames(), {}
    out["backend"] = torch.distributed.get_backend()
    for name, mesh in (("stream", make_stream_mesh(1)),
                       ("2d", make_mesh(1, 1))):
        pipe = _mesh_pipeline(mesh=mesh)
        COLLECTIVES.reset()
        launches = lb.KERNEL.launches
        out[name] = [tuple(t.cpu() for t in
                           pipe.step_chunk(frames[:, c:c + 2]))
                     for c in (0, 2)]
        out[name + "_counts"] = (COLLECTIVES.count,
                                 lb.KERNEL.launches - launches)
    out["device"] = str(device)
    return out


def test_stream_mesh_of_one_nccl_rank_equals_the_single_device(cuda):
    """A world of one rank on the card (NCCL): the mesh pipelines' outputs
    bitwise the single-device pipeline's in f32; one gather and one
    letterbox launch a dispatch."""
    from aicamera_tpu_torch.parallel import distributed
    [out] = distributed.spawn(_nccl_rank, 1, timeout=180.0)
    assert out["backend"] == "nccl" and out["device"] == "cuda:0"
    pipe = _mesh_pipeline(device="cuda")
    frames = _mesh_frames()
    want = [tuple(t.cpu() for t in pipe.step_chunk(frames[:, c:c + 2]))
            for c in (0, 2)]
    for name in ("stream", "2d"):
        assert out[name + "_counts"] == (2, 2)
        for got, ref in zip(out[name], want):
            for a, b in zip(got, ref):
                assert torch.equal(a, b)
    assert want[-1][4].any()


def _tail_bits_equal(got, want):
    """Five outputs equal bit for bit (NaN where NaN)."""
    for a, b in zip(got, want, strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


def test_nms_kernel_bitwise_equals_plain_version(cuda):
    """The NMS kernel on ``chip_smoke.nms_tail_cases(card_only=True)`` (the
    detect paths' shapes: B = 8, 32 and 1 at K = 300, the tiled merge at
    K = 500 by IoU and IoS; crowded scenes, the chain of length K, K = 1,
    33 and 1100, none and all valid, NaN, infinite and degenerate boxes,
    overlaps exactly at the threshold, the emit's cases; K = 4096 and
    ``MAX_K``): one launch a call, its five outputs bitwise the plain tail's
    eager form on the same tensors and its fixed-K form up to K = 1100; the
    first design (``keep_v1``) bitwise the plain keep on ``nms_cases``; CPU
    tensors raise. Tolerance: bitwise."""
    for name, boxes, score, cls, valid, thr, crit, max_det, offset in \
            chip_smoke.nms_tail_cases(card_only=True):
        args = (boxes.to(cuda), score.to(cuda), cls.to(cuda), valid.to(cuda),
                thr, max_det, offset, crit)
        k = valid.shape[-1]
        before = tnms.KERNEL.launches
        got = tnms.KERNEL(*args)
        assert tnms.KERNEL.launches == before + 1
        plain = args[:5] + (k,) + args[5:]
        _tail_bits_equal(got, tnms.suppress_and_emit_plain(*plain))
        if k <= 1100:
            _tail_bits_equal(got, tnms.suppress_and_emit_plain(*plain, True))
    with pytest.raises(ValueError, match="CUDA"):
        tnms.KERNEL(boxes, score, cls, valid, thr, max_det, offset, crit)
    for name, shifted, v_cpu, thr, criterion in chip_smoke.nms_cases(
            card_only=True):
        s, v = shifted.to(cuda), v_cpu.to(cuda)
        got = tnms.KERNEL.keep_v1(s, v, thr, criterion)
        assert got.dtype == torch.bool and got.shape == v.shape
        assert torch.equal(got, tnms.greedy_keep_plain(s, v, thr, criterion))


def test_nms_kernel_reads_nothing_and_captures(cuda):
    """The kernel under CUDA's sync debug mode "error" (no read back), and
    captured into a CUDA graph: replays bitwise the eager call."""
    name, boxes, score, cls, valid, thr, crit, max_det, offset = \
        chip_smoke.nms_tail_cases()[0]
    args = (boxes.to(cuda), score.to(cuda), cls.to(cuda), valid.to(cuda),
            thr, max_det, offset, crit)
    want = tnms.suppress_and_emit_plain(*args[:5], valid.shape[-1],
                                        *args[5:])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tnms.KERNEL(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _tail_bits_equal(got, want)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        tnms.KERNEL(*args)
    torch.cuda.current_stream().wait_stream(stream)
    with torch.cuda.graph(graph):
        out = tnms.KERNEL(*args)
    graph.replay()
    torch.cuda.synchronize()
    _tail_bits_equal(out, want)


def test_nms_emit_on_the_card_equals_the_cpu(cuda):
    """``_suppress_and_emit`` on card tensors (one kernel launch) against
    the same call on CPU tensors (the plain tail), bitwise, on the emit's
    cases: max_det below the kept count and past K, classes shifted by
    8192 and by the tiled merge's frame-scaled offset, IoU and IoS, scores
    with ties and a tail at or below 0; and score rows a stride apart (the
    top-k's slice of a wider sort, as ``fused_decode_nms`` passes them)."""
    cases = chip_smoke.nms_tail_cases()[-6:]
    for name, boxes, score, cls, valid, thr, crit, max_det, offset in cases:
        b, k = valid.shape
        wide = torch.zeros((b, 3 * k))
        wide[:, :k] = score
        for sc in (score, wide[:, :k]):
            launches = tnms.KERNEL.launches
            got = tnms._suppress_and_emit(
                boxes.to(cuda), sc.to(cuda) if sc is score else
                wide.to(cuda)[:, :k], cls.to(cuda), valid.to(cuda), thr, k,
                max_det, offset, crit)
            assert tnms.KERNEL.launches == launches + 1
            want = tnms._suppress_and_emit(boxes, sc, cls, valid, thr, k,
                                           max_det, offset, crit)
            _tail_bits_equal([t.cpu() for t in got], want)
            assert int(got[0].max()) <= max_det, name


def test_pipeline_on_the_card_makes_no_nms_read(cuda):
    """``TrackingPipeline(device="cuda")``: one NMS launch a chunk and no
    NMS read; the detections and tuples of the card run equal those with
    the plain tail in the kernel's place (its fixed-K form)."""
    from aicamera_tpu_torch import config
    from aicamera_tpu_torch.core.state import TrackerParams
    from aicamera_tpu_torch.runtime.pipeline import TrackingPipeline
    from aicamera_tpu_torch.scenes import moving_rectangles
    pipe = TrackingPipeline(
        input_shape=(256, 256), chunk_size=4, synthetic_load=8,
        max_reid_crops=4, device="cuda",
        tracker_params=TrackerParams(max_tracks=16, max_detections=8,
                                     nn_budget=4, max_age=10),
        yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
        reid_weights=str(config.REID_SYNTHETIC_PATH))
    frames = moving_rectangles(16, (180, 320), n_objects=3, seed=3)
    launches, reads = tnms.KERNEL.launches, tnms.NMS_SYNCS.count
    got = list(pipe.process_frames(iter(frames)))
    assert tnms.KERNEL.launches == launches + 4
    assert tnms.NMS_SYNCS.count == reads
    pipe.reset()
    with chip_smoke.PlainTail():
        want = list(pipe.process_frames(iter(frames)))
    assert sum(len(r.tracks) for r in got) > 0
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.det_boxes, w.det_boxes)
        np.testing.assert_array_equal(g.det_scores, w.det_scores)
        assert repr(g.tracks) == repr(w.tracks)
