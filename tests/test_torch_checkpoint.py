"""Port: tracker-state checkpoints. The file format is the JAX package's
(Flax msgpack of the state's field dict), so a state saved by either package
loads in the other, leaf for leaf; resume continues the ids; a failed write
leaves the old file whole."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flax import serialization  # noqa: E402

from aicamera_tpu.core import bytetrack as jbt  # noqa: E402
from aicamera_tpu.core import ocsort as joc  # noqa: E402
from aicamera_tpu.core import state as jstate  # noqa: E402
from aicamera_tpu.runtime import checkpoint as jckpt  # noqa: E402
from aicamera_tpu_torch.core import bytetrack as bt  # noqa: E402
from aicamera_tpu_torch.core import ocsort as oc  # noqa: E402
from aicamera_tpu_torch.core import state as cs  # noqa: E402
from aicamera_tpu_torch.core import tracker as trk  # noqa: E402
from aicamera_tpu_torch.runtime import checkpoint as ckpt  # noqa: E402
from aicamera_tpu_torch.runtime import params  # noqa: E402
from aicamera_tpu_torch.scenes import moving_boxes  # noqa: E402

DS = dict(max_tracks=8, max_detections=8, nn_budget=3, feature_dim=8,
          n_init=2)
BT = dict(max_tracks=8, max_detections=8)
BOT = dict(BT, with_appearance=True, feature_dim=8)
OC = dict(max_tracks=8, max_detections=8, min_hits=2)
DEEPOC = dict(OC, with_appearance=True, feature_dim=8)

# name: (port params, JAX params)
FAMILIES = {
    "deepsort": (cs.TrackerParams(**DS), jstate.TrackerParams(**DS)),
    "bytetrack": (bt.ByteTrackParams(**BT), jbt.ByteTrackParams(**BT)),
    "botsort": (bt.ByteTrackParams(**BOT), jbt.ByteTrackParams(**BOT)),
    "ocsort": (oc.OCSortParams(**OC), joc.OCSortParams(**OC)),
    "deepocsort": (oc.OCSortParams(**DEEPOC), joc.OCSortParams(**DEEPOC)),
}


def _tlwh(b):
    return np.concatenate([b[:, :2], b[:, 2:] - b[:, :2]], 1)


def _step(p, st, xyxy, score, cls, rng):
    """One frame through the port core that ``p`` belongs to."""
    feat = rng.normal(size=(len(xyxy), 8)).astype(np.float32)
    if isinstance(p, cs.TrackerParams):
        dets = cs.make_detections(_tlwh(xyxy), score, cls, feat, params=p,
                                  device="cpu")
        return trk.update(trk.predict(st, p), dets, p)
    if isinstance(p, bt.ByteTrackParams):
        return bt.step(st, bt.make_detections(
            _tlwh(xyxy), score, cls, feature=feat, params=p, device="cpu"), p)
    return oc.step(st, oc.make_detections(xyxy, score, cls, feature=feat,
                                          params=p, device="cpu"), p)


def _init(p):
    core = (cs if isinstance(p, cs.TrackerParams)
            else bt if isinstance(p, bt.ByteTrackParams) else oc)
    return core.init_state(p, device="cpu")


def _lived_in_state(p, n_frames=5):
    """A port state after a few frames of a seeded scene."""
    rng = np.random.RandomState(0)
    st = _init(p)
    scene = moving_boxes(n_frames + 3, n_objects=4, seed=1, miss=0.1,
                         low=0.0, clutter=0.0)
    for xyxy, score, cls in scene[:n_frames]:
        st = _step(p, st, xyxy, score, cls, rng)
    assert st.active.any() and int(st.next_id) > 1
    return st, scene[n_frames:], rng


def _assert_leaves_equal(ours, ref):
    """Port state against a JAX state: every leaf, dtype and shape."""
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        assert (a is None) == (b is None), f.name
        if a is None:
            continue
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_port_checkpoint_loads_in_jax_and_back(family, tmp_path):
    """save (port) -> load (JAX) -> save (JAX) -> load (port): the same
    leaves all the way, and the port's file is byte for byte what Flax
    writes for the state the JAX package loaded."""
    tp, jp = FAMILIES[family]
    st, _, _ = _lived_in_state(tp)
    ours, theirs = tmp_path / "port.msgpack", tmp_path / "jax.msgpack"
    ckpt.save_state(ours, st)
    in_jax = jckpt.load_state(ours, jp)
    assert type(in_jax).__name__ == type(st).__name__
    _assert_leaves_equal(st, in_jax)
    assert ours.read_bytes() == serialization.to_bytes(in_jax)
    jckpt.save_state(theirs, in_jax)
    back = ckpt.load_state(theirs, tp, device="cpu")
    _assert_leaves_equal(back, in_jax)
    for f in dataclasses.fields(st):
        a, b = getattr(st, f.name), getattr(back, f.name)
        assert (a is None and b is None) or torch.equal(a, b), f.name


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_resume_continues_the_ids(family, tmp_path):
    """A state that went through a file goes on exactly as the one that
    stayed in memory: same ids, same next_id."""
    tp, _ = FAMILIES[family]
    st, rest, rng = _lived_in_state(tp)
    ckpt.save_state(tmp_path / "s.msgpack", st)
    resumed = ckpt.load_state(tmp_path / "s.msgpack", tp, device="cpu")
    rng2 = np.random.RandomState(0)
    rng2.set_state(rng.get_state())
    for xyxy, score, cls in rest:
        st = _step(tp, st, xyxy, score, cls, rng)
        resumed = _step(tp, resumed, xyxy, score, cls, rng2)
    assert int(resumed.next_id) == int(st.next_id) > 1
    assert torch.equal(resumed.track_id, st.track_id)
    assert torch.equal(resumed.active, st.active)


def test_failed_write_leaves_the_old_file_whole(tmp_path, monkeypatch):
    tp, _ = FAMILIES["bytetrack"]
    st, _, _ = _lived_in_state(tp)
    path = tmp_path / "deep" / "s.msgpack"      # the directory is made
    ckpt.save_state(path, st)
    before = path.read_bytes()

    def boom(tree):
        raise OSError("disk full")
    monkeypatch.setattr(ckpt, "write_flax_msgpack", boom)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save_state(path, _init(tp))
    assert path.read_bytes() == before
    monkeypatch.undo()
    # a torn temporary file beside it does not matter either
    path.with_name(path.name + ".tmp").write_bytes(b"\x00torn")
    same = ckpt.load_state(path, tp, device="cpu")
    assert torch.equal(same.track_id, st.track_id)


def test_load_rejects_a_state_of_another_shape_or_family(tmp_path):
    tp, _ = FAMILIES["bytetrack"]
    st, _, _ = _lived_in_state(tp)
    path = tmp_path / "s.msgpack"
    ckpt.save_state(path, st)
    with pytest.raises(ValueError, match="field"):
        ckpt.load_state(path, bt.ByteTrackParams(max_tracks=16,
                                                 max_detections=8),
                        device="cpu")
    with pytest.raises(ValueError, match="with_appearance"):
        ckpt.load_state(path, FAMILIES["botsort"][0], device="cpu")
    with pytest.raises(ValueError, match="does not hold"):
        ckpt.load_state(path, FAMILIES["ocsort"][0], device="cpu")
    # a single stream's state is not a stack of two
    with pytest.raises(ValueError, match="field"):
        ckpt.load_state(path, tp, n_streams=2, device="cpu")


def _stack(states):
    first = states[0]
    return dataclasses.replace(first, **{
        f.name: None if getattr(first, f.name) is None
        else torch.stack([getattr(s, f.name) for s in states])
        for f in dataclasses.fields(first)})


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_stacked_states_load_in_jax_and_back(family, tmp_path):
    """Two streams' states stacked on a leading axis (the multi-stream
    layout): save (port) -> load (JAX, ``n_streams=2``) -> save (JAX) ->
    load (port, ``n_streams=2``), the same leaves all the way, and the
    port's file byte for byte what Flax writes."""
    tp, jp = FAMILIES[family]
    lived, _, _ = _lived_in_state(tp)
    stacked = _stack([lived, _init(tp)])
    ours, theirs = tmp_path / "port.msgpack", tmp_path / "jax.msgpack"
    ckpt.save_state(ours, stacked)
    in_jax = jckpt.load_state(ours, jp, n_streams=2)
    _assert_leaves_equal(stacked, in_jax)
    assert ours.read_bytes() == serialization.to_bytes(in_jax)
    jckpt.save_state(theirs, in_jax)
    back = ckpt.load_state(theirs, tp, n_streams=2, device="cpu")
    _assert_leaves_equal(back, in_jax)
    assert int(back.next_id[0]) > 1 and int(back.next_id[1]) == 1
    with pytest.raises(ValueError, match="field"):
        ckpt.load_state(theirs, tp, n_streams=3, device="cpu")
    with pytest.raises(ValueError, match="field"):
        ckpt.load_state(theirs, tp, device="cpu")


def test_load_defaults_to_the_gpu(tmp_path):
    """Without a ``device`` the state goes to the GPU, or the load raises;
    it never lands on the CPU silently."""
    tp, _ = FAMILIES["deepsort"]
    path = tmp_path / "s.msgpack"
    ckpt.save_state(path, _init(tp))
    if torch.cuda.is_available():
        assert ckpt.load_state(path, tp).active.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ckpt.load_state(path, tp)


def test_writer_matches_flax_on_the_msgpack_subset():
    """Maps, strings, nil and arrays of every length form, against Flax's
    own encoder, byte for byte; and the reader takes them back."""
    tree = {
        "none": None,
        "s" * 40: np.arange(3, dtype=np.int32),           # str8 key
        "scalar": np.asarray(7, np.int32),
        "b": np.array([True, False]),
        "f": np.linspace(0, 1, 70, dtype=np.float32).reshape(7, 10),  # ext16
        "big": np.zeros((300, 300), np.float32),          # ext32
        "nested": {str(i): np.float32(i) * np.ones(2, np.float32)
                   for i in range(20)},                   # map16
        "u8": np.arange(5, dtype=np.uint8),
    }
    def by_key(d):  # Flax's encoder walks a dict in the order of its keys
        return {k: by_key(v) if isinstance(v, dict) else v
                for k, v in sorted(d.items())}
    data = params.write_flax_msgpack(by_key(tree))
    assert data == serialization.msgpack_serialize(tree)
    back = params.read_flax_msgpack(data)
    assert back["none"] is None
    np.testing.assert_array_equal(back["f"], tree["f"])
    assert back["scalar"].shape == () and back["scalar"].dtype == np.int32
    with pytest.raises(TypeError):
        params.write_flax_msgpack({"x": 1.5})
