"""Port: the drawing overlays (``aicamera_tpu_torch/utils/visualization.py``)
against the JAX package's (``aicamera_tpu.utils.visualization``, OpenCV)
on seeded frames, boxes and track tuples.

The port's glyphs come from ``utils/font_simplex.npz`` (written by
``scripts/make_torch_font.py`` from this OpenCV); the OpenCV build the JAX
package runs on places glyphs on whole pixels and blends each glyph's mask
once, so the text is reproduced exactly as well. Tolerance: bitwise over the
whole frame, glyph boxes included (the bound on differing glyph pixels the
module could allow is 0 here). ``get_text_size`` equals
``cv2.getTextSize`` on every label the package forms and on random ASCII
and Latin-1 strings; ``rectangle`` equals ``cv2.rectangle`` at thickness -1 to 5 on
boxes that cross every edge of the frame and on degenerate boxes.
"""

import random

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from aicamera_tpu import config as jconfig  # noqa: E402
from aicamera_tpu.utils import visualization as jvis  # noqa: E402
from aicamera_tpu_torch import config  # noqa: E402
from aicamera_tpu_torch.utils import visualization as vis  # noqa: E402

FONT = cv2.FONT_HERSHEY_SIMPLEX
PAIRS = [(0.5, 1), (0.7, 1), (0.6, 1), (0.9, 2)]
PRINTABLE = [chr(c) for c in (*range(32, 127), *range(0xA0, 0x100))]


def _frame(seed, hw=(120, 200)):
    return np.random.RandomState(seed).randint(0, 256, (*hw, 3), np.uint8)


def _tracks(rng, n, hw):
    h, w = hw
    names = ["person", "car", "bus", "truck", "motorcycle", "zebra"]
    out = []
    for _ in range(n):
        x1, y1 = int(rng.randint(-30, w)), int(rng.randint(-30, h))
        out.append((x1, y1, x1 + int(rng.randint(0, 90)),
                    y1 + int(rng.randint(0, 90)), int(rng.randint(1, 1000)),
                    names[rng.randint(len(names))], float(rng.uniform())))
    return out


def test_config_colors_are_the_jax_packages():
    assert config.CLASS_COLORS == jconfig.CLASS_COLORS
    assert config.DEFAULT_TRACK_COLOR == jconfig.DEFAULT_TRACK_COLOR
    assert (config.FONT_SCALE_ID, config.FONT_SCALE_INFO,
            config.FONT_THICKNESS) == (jconfig.FONT_SCALE_ID,
                                       jconfig.FONT_SCALE_INFO,
                                       jconfig.FONT_THICKNESS)
    for name in ("person", "nothing"):
        assert config.get_track_color(name) == jconfig.get_track_color(name)
        assert config.get_class_color(name) == jconfig.get_class_color(name)


@pytest.mark.parametrize("seed", range(6))
def test_draw_detections_and_tracks_match_jax(seed):
    rng = np.random.RandomState(seed)
    hw = (120, 200) if seed % 2 else (60, 90)
    frame = _frame(seed, hw)
    boxes = rng.uniform(-40, 240, (7, 4)).astype(np.float32)
    scores = rng.uniform(0, 1, 7).astype(np.float32)
    labels = rng.randint(-1, 82, 7)
    tracks = _tracks(rng, 6, hw)
    a, b = frame.copy(), frame.copy()
    assert jvis.draw_detections(a, boxes, scores, labels) is a
    assert vis.draw_detections(b, boxes, scores, labels) is b
    np.testing.assert_array_equal(b, a)
    assert vis.draw_tracks(b, tracks) is b
    jvis.draw_tracks(a, tracks)
    np.testing.assert_array_equal(b, a)
    for thickness in (1, 3):
        vis.draw_detections(b, boxes[:2], scores[:2], labels[:2], thickness)
        jvis.draw_detections(a, boxes[:2], scores[:2], labels[:2], thickness)
        vis.draw_tracks(b, tracks[:2], thickness)
        jvis.draw_tracks(a, tracks[:2], thickness)
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("seed", range(4))
def test_draw_fps_and_info_panel_match_jax(seed):
    rng = np.random.RandomState(100 + seed)
    frame = _frame(seed, (90, 160))
    fps = float(rng.uniform(0, 2000))
    lines = ["AICamera", f"Input: clip_{seed}", f"FPS: {fps:.1f}",
             f"Tracks: {rng.randint(0, 200)}"][:1 + seed]
    a, b = frame.copy(), frame.copy()
    assert vis.draw_fps(b, fps) is b
    jvis.draw_fps(a, fps)
    org = (int(rng.randint(-20, 150)), 80)
    vis.draw_fps(b, fps, org)
    jvis.draw_fps(a, fps, org)
    assert vis.draw_info_panel(b, lines) is b
    jvis.draw_info_panel(a, lines)
    vis.draw_info_panel(b, lines, (seed * 40 - 30, seed * 20))
    jvis.draw_info_panel(a, lines, (seed * 40 - 30, seed * 20))
    np.testing.assert_array_equal(b, a)
    assert vis.draw_info_panel(b, []) is b


def test_add_weighted_every_pair():
    a = np.repeat(np.arange(256, dtype=np.uint8), 256).reshape(256, 256)
    b = a.T.copy()
    want = b.copy()
    cv2.addWeighted(a, 0.55, b, 0.45, 0, want)
    got = b.copy()
    vis._add_weighted(a, got)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("thickness", [-1, 1, 2, 3, 4, 5])
def test_rectangle_matches_cv2(thickness):
    rng = np.random.RandomState(thickness + 10)
    for i in range(400):
        h, w = rng.randint(5, 50, 2)
        frame = rng.randint(0, 256, (h, w, 3), np.uint8)
        p1 = tuple(int(v) for v in rng.randint(-20, 70, 2))
        p2 = tuple(int(v) for v in rng.randint(-20, 70, 2))
        if i % 4 == 0:   # degenerate: a point, a line one pixel long
            p2 = (p1[0] + int(rng.randint(-1, 2)),
                  p1[1] + int(rng.randint(-1, 2)))
        color = tuple(int(v) for v in rng.randint(0, 256, 3))
        a, b = frame.copy(), frame.copy()
        cv2.rectangle(a, p1, p2, color, thickness)
        vis.rectangle(b, p1, p2, color, thickness)
        np.testing.assert_array_equal(b, a, err_msg=f"{p1} {p2}")


@pytest.mark.parametrize("scale,thickness", PAIRS)
def test_get_text_size_matches_cv2(scale, thickness):
    """Every label form the package draws, and random ASCII and Latin-1
    strings."""
    rng = random.Random(int(scale * 10) + thickness)
    labels = [f"{n} {s:.2f}" for n in (*config.CLASSES[:20], "Unknown")
              for s in (0.0, 0.5, 0.999)]
    labels += [f"ID:{i} {n} {c:.2f}" for i in (1, 17, 345, 9999)
               for n in ("person", "car", "motorcycle") for c in (0.31, 1.0)]
    labels += ["AICamera", "Input: tiny", "FPS: 88.2", "Tracks: 12", "",
               "FPS: 1234.5", " ", "   "]
    labels += ["".join(rng.choice(PRINTABLE)
                       for _ in range(rng.randint(1, 30)))
               for _ in range(300)]
    for text in labels:
        assert vis.get_text_size(text, scale, thickness) == \
            cv2.getTextSize(text, FONT, scale, thickness), repr(text)


@pytest.mark.parametrize("scale,thickness", PAIRS)
def test_put_text_matches_cv2(scale, thickness):
    rng = random.Random(7 + thickness)
    nr = np.random.RandomState(thickness)
    for _ in range(60):
        text = "".join(rng.choice(PRINTABLE)
                       for _ in range(rng.randint(1, 16)))
        frame = nr.randint(0, 256, (70, 160, 3), np.uint8)
        org = (rng.randint(-40, 170), rng.randint(-10, 90))
        color = tuple(int(v) for v in nr.randint(0, 256, 3))
        a, b = frame.copy(), frame.copy()
        cv2.putText(a, text, org, FONT, scale, color, thickness, cv2.LINE_AA)
        vis.put_text(b, text, org, scale, color, thickness)
        np.testing.assert_array_equal(b, a, err_msg=repr(text))


def test_unknown_font_pair_raises_and_unheld_characters_draw_as_a_mark():
    """A pair the data lacks raises; a character beyond ASCII and Latin-1
    (or a control character) is sized and drawn as ``?`` and never
    raises, so a file name in any script still gets its frames drawn."""
    with pytest.raises(ValueError, match="font scale 1.3"):
        vis.get_text_size("x", 1.3, 1)
    for text in ("caf\u4e2d", "caf\u0416", "caf\t"):
        assert vis.get_text_size(text, 0.6, 1) == \
            vis.get_text_size("caf?", 0.6, 1)
        a, b = _frame(1, (40, 120)), _frame(1, (40, 120))
        vis.put_text(a, text, (5, 30), 0.6, (255, 255, 255), 1)
        vis.put_text(b, "caf?", (5, 30), 0.6, (255, 255, 255), 1)
        np.testing.assert_array_equal(a, b)
