"""Port: the MOTChallenge harness (``mot.py``), its PNG reader
(``utils/png.py``) and the whole quality slice on the CPU, against the JAX
package: the same text files, frames and tracks give the same scores."""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from aicamera_tpu import mot as jmot  # noqa: E402
from aicamera_tpu_torch import config  # noqa: E402
from aicamera_tpu_torch import mot as tmot  # noqa: E402
from aicamera_tpu_torch.utils.png import decode_png, read_png  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mot_rows(seed, n_frames=40, n_obj=5, gt=True):
    """MOTChallenge text rows of seeded moving boxes. gt rows carry the
    consider flag (conf 0 rows and class 2 rows are not targets); result
    rows carry a score, jitter, misses, an id swap and false positives."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(10, 400, (n_obj, 2))
    vel = rng.normal(0, 3, (n_obj, 2))
    size = rng.uniform(20, 80, (n_obj, 2))
    rng = np.random.default_rng(seed + 1000)   # the results' noise
    rows = []
    for t in range(1, n_frames + 1):
        for k in range(n_obj):
            p = pos[k] + t * vel[k]
            if gt:
                conf = 0 if (k == 4 and t % 3 == 0) else 1
                cls = 2 if k == 3 and t > 30 else 1
                rows.append(f"{t},{k + 1},{p[0]:.2f},{p[1]:.2f},"
                            f"{size[k, 0]:.2f},{size[k, 1]:.2f},{conf},{cls},"
                            "1.0")
            elif rng.random() < 0.85:
                tid = (k + 1) if t < 20 or k > 1 else 2 - k   # ids 1, 2 swap
                q = p + rng.normal(0, 2, 2)
                rows.append(f"{t} {tid} {q[0]:.2f} {q[1]:.2f} "
                            f"{size[k, 0]:.2f} {size[k, 1]:.2f} "
                            f"{rng.uniform(0.3, 1):.3f} -1 -1 -1")
        if not gt and rng.random() < 0.3:
            rows.append(f"{t},{90 + t},5,5,30,30,0.4,-1,-1,-1")
        if t == 7:
            rows.append("")
    return "\n".join(rows) + "\n"


def _frames_equal(a, b):
    assert a.keys() == b.keys()
    for t in a:
        for f in ("boxes", "ids", "conf"):
            x, y = getattr(a[t], f), getattr(b[t], f)
            assert x.dtype == y.dtype, (t, f)
            np.testing.assert_array_equal(x, y)


@pytest.fixture
def dataset(tmp_path):
    """Two sequences with gt and results files; a third without results."""
    data, out = tmp_path / "data", tmp_path / "out"
    for i, name in enumerate(("SEQ-01", "SEQ-02", "SEQ-03")):
        (data / name / "img1").mkdir(parents=True)
        (data / name / "gt").mkdir()
        (data / name / "gt" / "gt.txt").write_text(_mot_rows(i))
        if name != "SEQ-03":
            out.mkdir(exist_ok=True)
            (out / f"{name}.txt").write_text(_mot_rows(i, gt=False))
    return data, out


def test_load_and_write_match_jax(dataset, tmp_path):
    data, out = dataset
    gt = data / "SEQ-01" / "gt" / "gt.txt"
    res = out / "SEQ-01.txt"
    for kw in ({}, dict(min_confidence=1, target_classes=(1,))):
        _frames_equal(tmp := tmot.load_mot_file(gt, **kw),
                      jmot.load_mot_file(gt, **kw))
        assert tmp
    ours = tmot.load_mot_file(res)
    _frames_equal(ours, jmot.load_mot_file(res))
    tmot.write_mot_file(tmp_path / "a" / "t.txt", ours)
    jmot.write_mot_file(tmp_path / "b" / "j.txt", jmot.load_mot_file(res))
    assert (tmp_path / "a" / "t.txt").read_text() == \
        (tmp_path / "b" / "j.txt").read_text()


def test_sequence_scores_and_aggregate_match_jax(dataset):
    data, out = dataset
    ours, ref = {}, {}
    for name in ("SEQ-01", "SEQ-02"):
        gt, res = data / name / "gt" / "gt.txt", out / f"{name}.txt"
        for iou in (0.5, 0.4):
            ours[name] = tmot.evaluate_sequence(gt, res, iou_threshold=iou)
            ref[name] = jmot.evaluate_sequence(gt, res, iou_threshold=iou)
            assert ours[name].as_dict() == ref[name].as_dict()
            assert tmot.evaluate_sequence_identity(
                gt, res, iou_threshold=iou).as_dict() == \
                jmot.evaluate_sequence_identity(
                    gt, res, iou_threshold=iou).as_dict()
        assert tmot.evaluate_sequence_hota(gt, res).as_dict() == \
            jmot.evaluate_sequence_hota(gt, res).as_dict()
        assert ref[name].id_switches > 0
    assert tmot.aggregate(ours).as_dict() == jmot.aggregate(ref).as_dict()


@pytest.mark.parametrize("gsi", [False, True])
def test_main_scoring_report_matches_jax(dataset, gsi, capsys):
    """Scoring mode (no --run): the same report, the same GSI files, the
    sequence without results skipped."""
    data, out = dataset
    flags = ["--data", str(data), "--out", str(out)] + (["--gsi"] if gsi
                                                        else [])
    ours = tmot.main(flags)
    if gsi:
        ours_gsi = {p.name: p.read_text() for p in out.glob("*.gsi.txt")}
        for p in out.glob("*.gsi.txt"):
            p.unlink()
    ref = jmot.main(flags)
    assert ours == ref
    assert set(ours) == {"SEQ-01", "SEQ-02", "OVERALL"}
    if gsi:
        assert "gsi_hota" in ours["SEQ-01"]
        assert ours_gsi == {p.name: p.read_text()
                            for p in out.glob("*.gsi.txt")}
        assert len(ours_gsi) == 2
    assert "skip SEQ-03: missing results" in capsys.readouterr().out


def test_run_defaults_to_the_gpu(dataset):
    """``--run`` builds the pipeline on the GPU unless ``--device cpu``."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    data, out = dataset
    (data / "SEQ-01" / "img1" / "000001.png").write_bytes(
        cv2.imencode(".png", np.zeros((8, 8, 3), np.uint8))[1].tobytes())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmot.main(["--data", str(data), "--out", str(out), "--run"])


# --- PNG --------------------------------------------------------------------

def _image(shape, seed):
    """Smooth gradients plus noise, so libpng's adaptive filter choice
    varies from row to row."""
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    c = shape[2] if len(shape) == 3 else 1
    base = (xx * (seed + 2) + yy * 3)[..., None] + rng.integers(
        0, 12 * (seed + 1), (h, w, c))
    img = (base % 256).astype(np.uint8)
    return img if len(shape) == 3 else img[..., 0]


def _filter_types(data: bytes):
    """The filter type byte of every scanline of an 8-bit PNG."""
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        if kind == b"IHDR":
            hdr = data[pos + 8:pos + 8 + n]
        elif kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h = int.from_bytes(hdr[:4], "big"), int.from_bytes(hdr[4:8], "big")
    bpp = {0: 1, 2: 3, 6: 4}[hdr[9]]
    raw = zlib.decompress(idat)
    return {raw[y * (w * bpp + 1)] for y in range(h)}


PNG_SHAPES = [(1, 1), (5, 9), (48, 64), (33, 70, 3), (1, 17, 3), (40, 96, 3),
              (21, 31, 4), (64, 48, 4)]


# cv2.imwrite's filter choices: its default, libpng's adaptive choice among
# all five, and single filters that the adaptive choice may leave out
PNG_FILTERS = [[], [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS],
               [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_FILTER_UP],
               [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_FILTER_AVG],
               [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_FILTER_PAETH]]


def test_png_matches_cv2_imread(tmp_path):
    """Gray, BGR and BGRA PNGs written by ``cv2.imwrite``: bitwise what
    ``cv2.imread`` returns, and every filter type 0-4 is exercised."""
    seen = set()
    for i, shape in enumerate(PNG_SHAPES):
        for seed, params in enumerate(PNG_FILTERS):
            p = tmp_path / f"f{i}_{seed}.png"
            assert cv2.imwrite(str(p), _image(shape, seed), params)
            want = cv2.imread(str(p))
            got = read_png(p)
            assert got.dtype == np.uint8 and got.flags.c_contiguous
            np.testing.assert_array_equal(got, want)
            seen |= _filter_types(p.read_bytes())
    assert seen == {0, 1, 2, 3, 4}


def test_png_rejects_what_it_does_not_read(tmp_path):
    img = _image((8, 8, 3), 0)
    ok = cv2.imencode(".png", img)[1].tobytes()
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a" + ok[6:])
    bad_crc = bytearray(ok)
    bad_crc[29] ^= 0xFF                       # the IHDR CRC
    with pytest.raises(ValueError, match="bad CRC"):
        decode_png(bytes(bad_crc))
    sixteen = cv2.imencode(".png", img.astype(np.uint16) * 257)[1].tobytes()
    with pytest.raises(ValueError, match="16-bit RGB"):
        decode_png(sixteen)
    with pytest.raises(ValueError, match="no IEND"):
        decode_png(ok[:-12])


def test_jpeg_frames_are_not_ported(tmp_path):
    """JPEG frames are read now: ``sequence_frames`` over an ``img1/*.jpg``
    layout (and ``*.jpg`` plus ``*.png``, JPEGs first) equals the JAX
    harness's ``cv2.imread`` frames bitwise."""
    seq = tmp_path / "SEQ"
    (seq / "img1").mkdir(parents=True)
    for i in range(3):
        cv2.imwrite(str(seq / "img1" / f"{i + 1:06d}.jpg"),
                    _image((37, 61, 3), i))
    cv2.imwrite(str(seq / "img1" / "000004.png"), _image((37, 61, 3), 9))
    got = list(tmot.sequence_frames(seq))
    want = list(jmot.sequence_frames(seq))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for p in (seq / "img1").iterdir():
        p.unlink()
    with pytest.raises(FileNotFoundError):
        next(tmot.sequence_frames(seq))


# --- the slice on the CPU ---------------------------------------------------

def test_slice_matches_jax_on_a_temporal_world(tmp_path):
    """A small ``TemporalWorld`` written as a PNG sequence with its ground
    truth; the port's ``TrackingPipeline`` (CPU, f32) and JAX's run
    ``run_sequence`` over it: identical ids and boxes, and identical MOT,
    HOTA and IDF1 results. conf is the detector's score: within 2e-4, since
    two f32 convolution stacks round differently (measured 8.5e-5 on a
    0.325 score of a small object)."""
    from aicamera_tpu.core import state as jstate
    from aicamera_tpu.runtime.pipeline import TrackingPipeline as JaxPipeline
    from aicamera_tpu_torch.core.state import TrackerParams
    from aicamera_tpu_torch.runtime.pipeline import TrackingPipeline
    from aicamera_tpu_torch.synthetic import TemporalWorld, WorldSpec

    seq = tmp_path / "data" / "SYN-01"
    (seq / "img1").mkdir(parents=True)
    (seq / "gt").mkdir()
    world = TemporalWorld(WorldSpec(hw=(96, 160), max_objects=4,
                                    presence=1.0, size_scale=0.35),
                          seed=2, speed=1.5, device="cpu")
    gt_rows = []
    for t in range(1, 17):
        frame, boxes, ids, _, valid = world.step()
        assert cv2.imwrite(str(seq / "img1" / f"{t:06d}.png"), frame)
        for (x1, y1, x2, y2), i in zip(boxes[valid], ids[valid]):
            gt_rows.append(f"{t},{i},{x1 + 1:.3f},{y1 + 1:.3f},"
                           f"{x2 - x1:.3f},{y2 - y1:.3f},1,1,1")
    (seq / "gt" / "gt.txt").write_text("\n".join(gt_rows) + "\n")

    small = dict(max_tracks=16, max_detections=8, nn_budget=4, max_age=10,
                 feature_dim=config.REID_FEATURE_DIM)
    kw = dict(input_shape=(128, 128), max_reid_crops=4, chunk_size=4,
              yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
              reid_weights=str(config.REID_SYNTHETIC_PATH))
    ours = tmot.run_sequence(seq, TrackingPipeline(
        tracker_params=TrackerParams(**small), device="cpu", **kw))
    ref = jmot.run_sequence(seq, JaxPipeline(
        tracker_params=jstate.TrackerParams(**small), **kw))
    assert ours.keys() == ref.keys() and len(ours) >= 10
    for t in ours:
        np.testing.assert_array_equal(ours[t].ids, ref[t].ids)
        np.testing.assert_array_equal(ours[t].boxes, ref[t].boxes)
        np.testing.assert_allclose(ours[t].conf, ref[t].conf, atol=2e-4)
    tmot.write_mot_file(tmp_path / "port.txt", ours)
    jmot.write_mot_file(tmp_path / "jax.txt", ref)
    gt = seq / "gt" / "gt.txt"
    for fn in ("evaluate_sequence", "evaluate_sequence_hota",
               "evaluate_sequence_identity"):
        a = getattr(tmot, fn)(gt, tmp_path / "port.txt").as_dict()
        b = getattr(jmot, fn)(gt, tmp_path / "jax.txt").as_dict()
        assert a == b, fn
    assert tmot.evaluate_sequence(gt, tmp_path / "port.txt").mota > 0
