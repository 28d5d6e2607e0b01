"""Port: streams and channels over a mesh of ranks (``parallel/``) on the
CPU, against the JAX package on its 8 virtual CPU devices and against the
port's own single-device runs.

Every world here is gloo ranks on the CPU, one process (and one intra-op
thread) a rank, started by ``parallel.distributed.spawn`` with a join
timeout, so that a hang fails one test. Each world runs once per module
(a fixture) and returns what the tests read.

Sizes: 4 streams of 96x128 (``tests/test_parallel.py``'s), detector input
128x128, T=16 track slots, N=8 detection slots, 4 ReID crops, the committed
synthetic weights; each stream a seeded scene of moving rectangles.

Tolerances: against JAX those of ``tests/test_torch_multistream.py`` (ids,
classes, masks and rounded boxes exact; boxes within 1e-3 px, conf within
1e-5; state floats within 1e-3 or 1e-4 relative). Against the port's own
single-device run: ids, classes, masks and every integer state field
exact, floats within 1e-5 (bitwise on the host these tests were written
on: a conv's output channels and a batch's frames do not change each
other's sums). The channel-parallel forward against the replicated one:
within rtol 1e-5, atol 1e-6 (bitwise on that host); against JAX's
channel-sharded forward in f32: within 2e-3 absolute on logits of
magnitude up to ~20 (the two packages' f32 conv stacks round differently).
"""

import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from aicamera_tpu_torch import config  # noqa: E402
from aicamera_tpu_torch.core import bytetrack as tbt  # noqa: E402
from aicamera_tpu_torch.core import ocsort as toc  # noqa: E402
from aicamera_tpu_torch.core.state import TrackerParams  # noqa: E402
from aicamera_tpu_torch.parallel import distributed  # noqa: E402
from aicamera_tpu_torch.scenes import moving_rectangles  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


S = 4
FRAME_HW = (96, 128)
SMALL = dict(max_tracks=16, max_detections=8, nn_budget=4, max_age=10,
             feature_dim=config.REID_FEATURE_DIM)
KW = dict(n_streams=S, frame_hw=FRAME_HW, input_shape=(128, 128),
          max_reid_crops=4, yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
          reid_weights=str(config.REID_SYNTHETIC_PATH))
CAP = dict(max_tracks=16, max_detections=8)
JOIN_S = 120.0   # each world's join timeout
# stream 1 masked for the whole dispatch, stream 2 for its second frame
MASK = np.array([[True, True], [False, False], [True, False], [True, True]])
RESET = 0        # the stream reset before the third dispatch
RESET_AFTER = (0, 3)  # the streams reset after the last one
# (name, call(pipe, frames)); the JAX run makes the first three
SEQUENCE = (
    ("chunk", lambda p, f: p.step_chunk(f[:, 0:2])),
    ("masked", lambda p, f: p.step_chunk(f[:, 2:4], frame_valid=MASK)),
    ("reset_stream", lambda p, f: (p.reset_stream(RESET),
                                   p.step_chunk(f[:, 4:6]))[1]),
    ("step", lambda p, f: p.step(f[:, 6])),
)
N_JAX = 3
RESET_CALL = 2


def _scenes(n=7, seeds=(3, 5, 7, 9)):
    return np.stack([moving_rectangles(n, FRAME_HW, n_objects=3, seed=s)
                     for s in seeds])


def _numpy(tree):
    """Outputs (a tuple) or a state (a dataclass) as numpy."""
    if isinstance(tree, tuple):
        return tuple(np.asarray(a.cpu().numpy() if torch.is_tensor(a) else a)
                     for a in tree)
    return {f.name: None if getattr(tree, f.name) is None
            else np.asarray(getattr(tree, f.name).cpu().numpy()
                            if torch.is_tensor(getattr(tree, f.name))
                            else getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


def _run(pipe, frames, calls):
    out = []
    for call in calls:
        outs = call(pipe, frames)
        out.append((_numpy(tuple(outs)), _numpy(pipe.states)))
    return out


def _count_letterbox():
    """Wrap the pipeline's letterbox (on the CPU its plain version, which
    counts no launch): the frame batch of every call."""
    from aicamera_tpu_torch.runtime import pipeline as rp
    calls, orig = [], rp.letterbox
    rp.letterbox = lambda f, *a: calls.append(tuple(f.shape)) or orig(f, *a)
    return calls


def _yolo():
    from aicamera_tpu_torch.runtime.params import resolve_yolo_params
    return resolve_yolo_params(weights_path=str(config.YOLO_SYNTHETIC_PATH),
                               device="cpu").eval()


def _tp_input():
    return torch.from_numpy(
        np.random.RandomState(0).rand(2, 3, 64, 64).astype(np.float32))


# --- the worlds --------------------------------------------------------------

def _world_of_four(rank, device):
    """4 ranks: the streams on make_mesh(2, 2); the channel-parallel
    forwards on a (1, 2) view of it and on a 4-rank 'model' mesh; the
    meshes' argument checks."""
    from torch.distributed.device_mesh import DeviceMesh
    from aicamera_tpu_torch.parallel import (MultiStreamPipeline, make_mesh,
                                             replicate_params,
                                             shard_detector_params)
    from aicamera_tpu_torch.parallel.tensor_parallel import sharded_convs
    torch.set_num_threads(1)
    out = {}
    letterbox_calls = _count_letterbox()
    pipe = MultiStreamPipeline(mesh=make_mesh(2, 2), device="cpu", **KW,
                               tracker_params=TrackerParams(**SMALL))
    out["scan_bucket"] = pipe.scan_bucket
    out["n_sharded"] = sharded_convs(pipe._engine.yolo)
    frames = _scenes()
    runs, per_dispatch = [], []
    for _, call in SEQUENCE:
        before = distributed.COLLECTIVES.count
        outs = call(pipe, frames)
        per_dispatch.append(distributed.COLLECTIVES.count - before)
        runs.append((_numpy(tuple(outs)), _numpy(pipe.states)))
    out["runs"], out["collectives"] = runs, per_dispatch
    out["letterbox"] = list(letterbox_calls)
    saved = pipe.states
    for i in RESET_AFTER:   # one stream of each rank pair
        pipe.reset_stream(i)
    out["after_reset"] = _numpy(pipe.states)
    out["fresh"] = _numpy(pipe._engine._init_tracker_state())
    pipe.states = saved     # each rank keeps its own streams' part
    out["restored"] = _numpy(pipe.states)

    # channel parallelism: placement and forwards
    model, x = _yolo(), _tp_input()
    five = _five_class_yolo()
    mesh22 = make_mesh(2, 2)
    model4 = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("model",))
    with torch.no_grad():
        out["replicated"] = _levels(replicate_params(model, mesh22)(x))
        for name, mesh in (("tp2", mesh22), ("tp4", model4)):
            tp = shard_detector_params(model, mesh)
            before = distributed.COLLECTIVES.by_kind.get("all_gather", 0)
            out[name] = _levels(tp(x))
            out[name + "_gathers"] = (
                distributed.COLLECTIVES.by_kind["all_gather"] - before,
                sharded_convs(tp))
    tp5 = shard_detector_params(five, mesh22)
    out["placement"] = {k: repr(v) for k, v in tp5.tp_placements.items()}
    out["local_shapes"] = {k: tuple(v.shape)
                           for k, v in tp5.state_dict().items()}
    out["full_shapes"] = {k: tuple(v.shape)
                          for k, v in five.state_dict().items()}
    out["errors"] = _errors(lambda: make_mesh(2, 4),
                            lambda: MultiStreamPipeline(
                                n_streams=3, frame_hw=FRAME_HW,
                                mesh=make_mesh(2, 2), device="cpu"))
    return out


def _five_class_yolo():
    from aicamera_tpu_torch.models.yolov8 import YOLOv8
    from aicamera_tpu_torch.runtime.params import seeded_init_
    m = YOLOv8("n", num_classes=5)
    seeded_init_(m)
    return m.eval()


def _levels(levels):
    return [tuple(t.numpy() for t in lv) for lv in levels]


def _errors(*calls):
    out = []
    for call in calls:
        try:
            call()
            out.append(None)
        except Exception as e:  # noqa: BLE001 -- the message is the result
            out.append((type(e).__name__, str(e)))
    return out


MOTION = {"bytetrack": dict(tracker="bytetrack",
                            bytetrack_params=tbt.ByteTrackParams(
                                track_thresh=0.4, **CAP)),
          "ocsort": dict(tracker="ocsort",
                         ocsort_params=toc.OCSortParams(det_thresh=0.4,
                                                        **CAP))}


def _identical_streams():
    one = _scenes(4, seeds=(3,))[0]
    return np.stack([one, one])


def _world_of_two(rank, device):
    """2 ranks: ByteTrack and OC-SORT on make_stream_mesh(2) with two
    identical streams; the collectives of each dispatch."""
    from aicamera_tpu_torch.parallel import (MultiStreamPipeline,
                                             make_stream_mesh)
    torch.set_num_threads(1)
    out = {}
    frames = _identical_streams()
    for name, kw in MOTION.items():
        pipe = MultiStreamPipeline(mesh=make_stream_mesh(), device="cpu",
                                   **dict(KW, n_streams=2), **kw)
        counts, runs = [], []
        for c in range(2):
            distributed.COLLECTIVES.reset()
            outs = pipe.step_chunk(frames[:, 2 * c:2 * c + 2])
            counts.append(dict(distributed.COLLECTIVES.by_kind))
            runs.append((_numpy(tuple(outs)), _numpy(pipe.states)))
        out[name] = (runs, counts)
    return out


@pytest.fixture(scope="module")
def four():
    return distributed.spawn(_world_of_four, 4, device="cpu",
                             timeout=JOIN_S)


@pytest.fixture(scope="module")
def two():
    return distributed.spawn(_world_of_two, 2, device="cpu", timeout=JOIN_S)


# --- the references ----------------------------------------------------------

@pytest.fixture(scope="module")
def single_run():
    """The port's single-device run of the same sequence."""
    from aicamera_tpu_torch.parallel import MultiStreamPipeline
    pipe = MultiStreamPipeline(device="cpu", **KW,
                               tracker_params=TrackerParams(**SMALL))
    return _run(pipe, _scenes(), [c for _, c in SEQUENCE])


@pytest.fixture(scope="module")
def jax_mesh_run():
    """JAX's MultiStreamPipeline on its make_mesh(2, 2) (channel-sharded
    detector), the first three calls."""
    from aicamera_tpu.core import state as jstate
    from aicamera_tpu.parallel import MultiStreamPipeline as JaxMulti
    from aicamera_tpu.parallel import make_mesh as jax_make_mesh
    pipe = JaxMulti(mesh=jax_make_mesh(2, 2), **KW,
                    tracker_params=jstate.TrackerParams(**SMALL))
    return _run(pipe, _scenes(), [c for _, c in SEQUENCE[:N_JAX]])


def _assert_outputs_match(ours, ref, box_atol=1e-3, conf_atol=1e-5):
    tlbr, ids, cls, conf, mask = ours
    r_tlbr, r_ids, r_cls, r_conf, r_mask = ref
    np.testing.assert_array_equal(mask, r_mask)
    np.testing.assert_array_equal(ids, r_ids)
    np.testing.assert_array_equal(cls, r_cls)
    np.testing.assert_array_equal(np.round(tlbr[mask]),
                                  np.round(r_tlbr[r_mask]))
    np.testing.assert_allclose(tlbr, r_tlbr, atol=box_atol)
    np.testing.assert_allclose(conf, r_conf, atol=conf_atol)


def _assert_states_match(ours, ref, rtol=1e-4, atol=1e-3, feat_atol=1e-4):
    assert ours.keys() == ref.keys()
    for name, a in ours.items():
        b = ref[name]
        assert (a is None) == (b is None), name
        if a is None:
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype.kind == "f":
            tol = (dict(atol=feat_atol) if name in ("gallery", "emb")
                   else dict(rtol=rtol, atol=atol))
            np.testing.assert_allclose(a, b, err_msg=name, **tol)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


# --- streams on a mesh -------------------------------------------------------

@pytest.mark.parametrize("i", range(N_JAX), ids=[n for n, _ in
                                                  SEQUENCE[:N_JAX]])
def test_streams_on_a_2x2_mesh_match_jax(four, jax_mesh_run, i):
    """Every rank's outputs and gathered states after each call against
    JAX's run on its own 2x2 ('stream', 'model') mesh."""
    for rank in four:
        ours = rank["runs"][i]
        _assert_outputs_match(ours[0], jax_mesh_run[i][0])
        _assert_states_match(ours[1], jax_mesh_run[i][1])
    if SEQUENCE[i][0] == "masked":
        assert four[0]["runs"][i][0][4].any(), "no track emitted"


def test_streams_on_a_2x2_mesh_equal_the_single_device_run(four,
                                                           single_run):
    """All four calls, on every rank: the outputs and states of the
    port's single-device pipeline."""
    for rank in four:
        for (o_out, o_st), (r_out, r_st) in zip(rank["runs"], single_run):
            _assert_outputs_match(o_out, r_out, box_atol=1e-5,
                                  conf_atol=1e-6)
            _assert_states_match(o_st, r_st, rtol=1e-5, atol=1e-5,
                                 feat_atol=1e-6)


def test_one_collective_and_one_letterbox_a_dispatch(four, two):
    """On the 2x2 mesh a dispatch is one output gather plus the detector's
    all-gathers (one a split conv); every rank letterboxes its own two
    streams' frames in one call a dispatch. On a 1-D stream mesh the
    gather is the only collective."""
    for rank in four:
        assert rank["collectives"] == [1 + rank["n_sharded"]] * 4
        assert rank["letterbox"] == [(4, *FRAME_HW, 3)] * 3 \
            + [(2, *FRAME_HW, 3)]
        assert rank["scan_bucket"] == 0
    assert four[0]["n_sharded"] == 63   # every conv of YOLOv8n at 2
    for rank in two:
        for runs, counts in rank.values():
            assert counts == [{"all_gather": 1}] * 2


def test_states_assign_on_a_mesh(four):
    """Assigning the gathered states back (a stacked checkpoint's layout)
    restores every stream on every rank, the reset ones included."""
    last = four[0]["runs"][-1][1]
    for rank in four:
        for name, a in rank["restored"].items():
            if a is not None:
                np.testing.assert_array_equal(a, last[name], err_msg=name)


def test_masked_and_reset_streams_on_a_mesh(four):
    """The masked dispatch leaves stream 1 (rank 0's) bit for bit as it
    was and advances the others; reset_stream on streams 0 and 3 (one of
    each stream block) makes them fresh states in every rank's gathered
    view and leaves streams 1 and 2 as they were."""
    (_, before), (_, after) = four[0]["runs"][:2]
    for name, a in before.items():
        if a is not None:
            np.testing.assert_array_equal(a[1], after[name][1],
                                          err_msg=name)
    assert (after["age"][0] != before["age"][0]).any()
    last = four[0]["runs"][-1][1]
    assert all(last["next_id"][i] > 1 for i in RESET_AFTER)
    assert four[0]["runs"][RESET_CALL - 1][1]["next_id"][RESET] > 1
    for rank in four:
        reset, fresh = rank["after_reset"], rank["fresh"]
        for name, a in reset.items():
            if a is None:
                continue
            for i in range(S):
                want = fresh[name] if i in RESET_AFTER else last[name][i]
                np.testing.assert_array_equal(a[i], want, err_msg=name)


@pytest.mark.parametrize("tracker", sorted(MOTION))
def test_motion_trackers_on_a_stream_mesh(two, tracker):
    """ByteTrack and OC-SORT on make_stream_mesh(2), two identical streams
    (``tests/test_parallel.py``): both streams' outputs and states equal,
    on both ranks, and equal a single-device run; tracks are emitted."""
    from aicamera_tpu_torch.parallel import MultiStreamPipeline
    frames = _identical_streams()
    single = MultiStreamPipeline(device="cpu", **dict(KW, n_streams=2),
                                 **MOTION[tracker])
    ref = _run(single, frames, [lambda p, f: p.step_chunk(f[:, 0:2]),
                                lambda p, f: p.step_chunk(f[:, 2:4])])
    for rank in two:
        runs, _ = rank[tracker]
        for (o_out, o_st), (r_out, r_st) in zip(runs, ref):
            _assert_outputs_match(o_out, r_out, box_atol=1e-5,
                                  conf_atol=1e-6)
            _assert_states_match(o_st, r_st, rtol=1e-5, atol=1e-5)
            for a in o_out:
                np.testing.assert_array_equal(a[0], a[1])
    assert two[0][tracker][0][-1][0][4].any(), "no track emitted"


# --- channel parallelism -----------------------------------------------------

def test_placement_shards_the_divisible_convs(four):
    """On a 2-rank 'model' axis every conv but the 5-class outputs is
    Shard(0) and holds out/2 of its output channels; the class outputs are
    Replicate() and whole."""
    placement = four[0]["placement"]
    local, full = four[0]["local_shapes"], four[0]["full_shapes"]
    assert set(placement) == set(full)
    for name, p in placement.items():
        head_out = name.split(".")[1].startswith("cls") \
            and name.split(".")[1].endswith("_out")
        if head_out:
            assert p == "Replicate()", name
            assert local[name] == full[name], name
        else:
            assert p == "Shard(dim=0)", name
            assert local[name] == (full[name][0] // 2, *full[name][1:]), name


@pytest.mark.parametrize("n", [2, 4])
def test_channel_parallel_forward_equals_replicated(four, n):
    for rank in four:
        for got, want in zip(rank[f"tp{n}"], rank["replicated"]):
            for a, b in zip(got, want):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_channel_parallel_gathers_once_a_sharded_conv(four):
    for rank in four:
        for n in (2, 4):
            gathers, convs = rank[f"tp{n}_gathers"]
            assert gathers == convs == 63


def test_channel_parallel_forward_matches_jax(four):
    """JAX's shard_detector_params on a 4-device 'model' mesh and
    ``model.apply`` (f32), the same weights carried across."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from aicamera_tpu.models import YOLOv8 as JYOLO
    from aicamera_tpu.parallel.tensor_parallel import shard_detector_params
    from aicamera_tpu_torch.runtime.params import flax_tree
    x = _tp_input().numpy()
    mesh = Mesh(np.array(jax.devices()[:4]), ("model",))
    params = shard_detector_params(flax_tree(_yolo()), mesh)
    ref = jax.jit(JYOLO(variant="n", dtype=jnp.float32).apply)(
        params, jnp.asarray(x.transpose(0, 2, 3, 1)))
    for rank in four:
        for got, want in zip(rank["tp4"], ref):
            for a, b in zip(got, want):
                np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4,
                                           atol=2e-3)


# --- the launcher and the meshes' checks -------------------------------------

def test_mesh_checks_raise_as_jax(four):
    too_big, indivisible = four[0]["errors"]
    assert too_big == ("ValueError", "mesh 2x4 needs 8 devices, have 4")
    assert indivisible[0] == "ValueError" and "not divisible" in \
        indivisible[1]


def test_meshes_need_a_world():
    """No world: the meshes raise, naming the launcher; none of them makes
    a world of one."""
    from aicamera_tpu_torch.parallel import make_mesh, make_stream_mesh
    for make in (lambda: make_mesh(2), make_stream_mesh):
        with pytest.raises(RuntimeError, match="spawn"):
            make()
    assert not torch.distributed.is_initialized()


_TORCHRUN_RANK = """
import torch
from aicamera_tpu_torch.parallel import make_stream_mesh
from aicamera_tpu_torch.parallel.distributed import init_world
print(init_world(device="cpu"), make_stream_mesh().size(),
      torch.distributed.get_backend())
torch.distributed.destroy_process_group()
"""


def test_init_world_joins_a_torchrun_world():
    """What torchrun gives a rank (RANK, WORLD_SIZE, MASTER_ADDR and
    MASTER_PORT on localhost) is enough for init_world; without it,
    init_world names the launchers."""
    import os
    import socket
    import subprocess
    import sys
    from aicamera_tpu_torch.parallel.distributed import init_world
    with pytest.raises(RuntimeError, match="torchrun"):
        init_world(device="cpu")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
               MASTER_PORT=str(port), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _TORCHRUN_RANK], env=env,
                         cwd=str(config.PROJECT_ROOT), capture_output=True,
                         text=True, timeout=JOIN_S)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["cpu", "1", "gloo"]


def test_spawn_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU error cannot be shown")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.spawn(_world_of_two, 2)


def _fails_on_rank_one(rank, device):
    if rank == 1:
        raise ValueError("rank one fails")
    torch.distributed.barrier()


def _hangs_on_rank_one(rank, device):
    if rank == 1:
        time.sleep(600)
    return rank


def test_a_failing_rank_fails_the_launch():
    with pytest.raises(RuntimeError, match="rank one fails"):
        distributed.spawn(_fails_on_rank_one, 2, device="cpu",
                          timeout=JOIN_S)


def test_a_hung_world_times_out():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"ranks \[1\]"):
        distributed.spawn(_hangs_on_rank_one, 2, device="cpu", timeout=15)
    assert time.monotonic() - t0 < 60
