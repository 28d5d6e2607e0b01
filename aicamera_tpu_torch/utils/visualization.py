"""Drawing overlays on the host, in numpy, without OpenCV.

The port of ``aicamera_tpu/utils/visualization.py``: ``draw_detections``,
``draw_tracks``, ``draw_fps`` and ``draw_info_panel`` with the same
signatures and label formats. Each draws into ``frame`` in place and returns
it, as the OpenCV calls they replace do.

What each OpenCV call becomes:

- ``cv2.rectangle`` at ``LINE_8``: a filled box (thickness < 0) is the
  inclusive box, clipped; thickness 1 its outline; a thicker one a band of
  ``(t + 1) // 2`` pixels on each side of every edge plus OpenCV's filled
  midpoint circle of that radius at every corner (``ThickLine`` with
  ``FillConvexPoly``), so the corners are rounded as OpenCV's are.
- ``cv2.getTextSize`` / ``cv2.putText`` (``FONT_HERSHEY_SIMPLEX``,
  ``LINE_AA``): the glyphs come from ``font_simplex.npz``, written by
  ``scripts/make_torch_font.py`` from the OpenCV the JAX package runs on,
  at the four (scale, thickness) pairs the package draws with, for
  printable ASCII and Latin-1 (other characters are drawn as ``?``, which
  is where the port's text can differ from OpenCV's). That OpenCV
  places each glyph on a whole pixel, a string's width is the sum of its
  glyphs' integer advances plus 1, and each glyph's alpha mask blends as
  ``(pixel * (255 - a) + color * a + 127) // 255``, one glyph after another
  (in ``native/aicam_host.cpp``, one call a string). Other pairs raise
  ``ValueError``.
- ``cv2.addWeighted(overlay, 0.55, frame, 0.45, 0, frame)``: float32
  weights, ``overlay * 0.55f + (frame * 0.45f)`` with one rounding (a fused
  multiply-add), then round-half-even and saturation; applied to the
  panel's box only, since it returns every pixel value blended with
  itself unchanged.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Sequence, Tuple

import numpy as np

from .. import config

_FONT_PATH = Path(__file__).resolve().parent / "font_simplex.npz"
_fonts: dict | None = None
_glyph_of: dict = {}    # code point -> glyph row


def _load_fonts() -> dict:
    """{(scale, thickness): (advances, baselines, height, glyph table,
    alpha)}: row ``i`` of the table is ``(dy, dx, rows, cols, offset in
    alpha)`` of the character ``chars[i]`` of the data."""
    global _fonts
    if _fonts is None:
        data = np.load(_FONT_PATH)
        _glyph_of.update((int(c), i) for i, c in enumerate(data["chars"]))
        fonts = {}
        for i, (scale, thickness) in enumerate(data["pairs"]):
            boxes = data[f"box{i}"].astype(np.int32)
            sizes = boxes[:, 2] * boxes[:, 3]
            offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
            table = np.concatenate([boxes, offsets[:, None].astype(np.int32)],
                                   axis=1)
            fonts[(float(scale), int(thickness))] = (
                data[f"adv{i}"].astype(np.int64),
                data[f"base{i}"].astype(np.int64), int(data[f"height{i}"]),
                table, np.ascontiguousarray(data[f"alpha{i}"], np.uint8))
        _fonts = fonts
    return _fonts


def _font(scale: float, thickness: int):
    font = _load_fonts().get((float(scale), int(thickness)))
    if font is None:
        raise ValueError(f"no glyphs for font scale {scale} at thickness "
                         f"{thickness}; scripts/make_torch_font.py writes "
                         f"{sorted(_load_fonts())}")
    return font


def _indices(text: str):
    """Glyph rows of ``text``; a character the font data does not hold
    (beyond printable ASCII and Latin-1) is drawn and sized as ``?``."""
    _load_fonts()
    unheld = _glyph_of[ord("?")]
    return [_glyph_of.get(ord(c), unheld) for c in text]


def get_text_size(text: str, scale: float,
                  thickness: int) -> Tuple[Tuple[int, int], int]:
    """``((width, height), baseline)`` as ``cv2.getTextSize(text,
    FONT_HERSHEY_SIMPLEX, scale, thickness)`` gives them."""
    if not text:
        return (0, 0), 0
    adv, base, height, _, _ = _font(scale, thickness)
    idx = _indices(text)
    return (int(adv[idx].sum()) + 1, height), int(base[idx].max())


def put_text(frame: np.ndarray, text: str, org: Tuple[int, int],
             scale: float, color, thickness: int = 1) -> np.ndarray:
    """``cv2.putText(frame, text, org, FONT_HERSHEY_SIMPLEX, scale, color,
    thickness, LINE_AA)`` on an ``(H, W, 3)`` uint8 frame: one call into
    ``native/aicam_host.cpp::blend_glyphs``."""
    import ctypes
    from .. import native
    adv, _, _, table, alpha = _font(scale, thickness)
    idx = np.asarray(_indices(text), np.int64)
    if not len(idx):
        return frame
    x, y = int(org[0]), int(org[1])
    pen = x + np.concatenate([[0], np.cumsum(adv[idx])[:-1]])
    g = table[idx].astype(np.int32)
    g[:, 0] += y
    g[:, 1] += pen.astype(np.int32)
    g = np.ascontiguousarray(g)
    col = np.ascontiguousarray(np.asarray(color, np.int32)[:3])
    out = frame if frame.flags.c_contiguous else np.ascontiguousarray(frame)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    i32 = ctypes.POINTER(ctypes.c_int)
    native.host_lib().blend_glyphs(
        out.ctypes.data_as(u8), out.shape[0], out.shape[1],
        alpha.ctypes.data_as(u8), g.ctypes.data_as(i32), len(g),
        col.ctypes.data_as(i32))
    if out is not frame:
        frame[...] = out
    return frame


def _fill(frame, x0, y0, x1, y1, color):
    """Fill the inclusive box, clipped to the frame."""
    h, w = frame.shape[:2]
    xa, xb = max(min(x0, x1), 0), min(max(x0, x1), w - 1)
    ya, yb = max(min(y0, y1), 0), min(max(y0, y1), h - 1)
    if xa <= xb and ya <= yb:
        frame[ya:yb + 1, xa:xb + 1] = color


def _circle(frame, cx, cy, r, color):
    """OpenCV's filled midpoint circle (``Circle`` with ``fill``)."""
    err, dx, dy, plus, minus = 0, r, 0, 1, (r << 1) - 1
    while dx >= dy:
        _fill(frame, cx - dx, cy - dy, cx + dx, cy - dy, color)
        _fill(frame, cx - dx, cy + dy, cx + dx, cy + dy, color)
        _fill(frame, cx - dy, cy - dx, cx + dy, cy - dx, color)
        _fill(frame, cx - dy, cy + dx, cx + dy, cy + dx, color)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def rectangle(frame: np.ndarray, pt1, pt2, color,
              thickness: int = 1) -> np.ndarray:
    """``cv2.rectangle(frame, pt1, pt2, color, thickness)`` at ``LINE_8``."""
    color = np.asarray(color, frame.dtype)[:3]
    (x0, y0), (x1, y1) = (int(v) for v in pt1), (int(v) for v in pt2)
    if thickness < 0:
        _fill(frame, x0, y0, x1, y1, color)
        return frame
    if thickness <= 1:
        for ya, yb in ((y0, y0), (y1, y1)):
            _fill(frame, x0, ya, x1, yb, color)
        for xa in (x0, x1):
            _fill(frame, xa, y0, xa, y1, color)
        return frame
    r = (thickness + 1) // 2
    if x0 != x1:   # the horizontal edges; a zero-length edge has no band
        for y in (y0, y1):
            _fill(frame, x0, y - r, x1, y + r, color)
    if y0 != y1:
        for x in (x0, x1):
            _fill(frame, x - r, y0, x + r, y1, color)
    for cx, cy in ((x0, y0), (x1, y0), (x1, y1), (x0, y1)):
        _circle(frame, cx, cy, r, color)
    return frame


def _add_weighted(overlay: np.ndarray, frame: np.ndarray) -> None:
    """``cv2.addWeighted(overlay, 0.55, frame, 0.45, 0, frame)``."""
    a = overlay.astype(np.float64) * np.float64(np.float32(0.55))
    b = (frame.astype(np.float32) * np.float32(0.45)).astype(np.float64)
    frame[...] = np.clip(np.rint(np.float32(a + b)), 0, 255)


def draw_detections(frame: np.ndarray,
                    bboxes_xyxy: np.ndarray,
                    scores: np.ndarray,
                    class_ids: np.ndarray,
                    thickness: int = 2) -> np.ndarray:
    """Draw raw detection boxes with class-name + score labels."""
    for box, score, cid in zip(bboxes_xyxy, scores, class_ids):
        cid = int(cid)
        name = config.CLASSES[cid] if 0 <= cid < len(config.CLASSES) \
            else "Unknown"
        color = config.get_class_color(name)
        x1, y1, x2, y2 = (int(round(float(v))) for v in box[:4])
        rectangle(frame, (x1, y1), (x2, y2), color, thickness)
        label = f"{name} {float(score):.2f}"
        (tw, th), _ = get_text_size(label, 0.5, 1)
        rectangle(frame, (x1, y1 - th - 6), (x1 + tw + 2, y1), color, -1)
        put_text(frame, label, (x1 + 1, y1 - 4), 0.5, (0, 0, 0), 1)
    return frame


def draw_tracks(frame: np.ndarray,
                tracks: Iterable[Tuple[int, int, int, int, int, str, float]],
                thickness: int = 2) -> np.ndarray:
    """Draw tracked boxes labeled ``ID:{id} {class} {conf}``."""
    for (x1, y1, x2, y2, track_id, class_name, conf) in tracks:
        color = config.get_track_color(class_name)
        rectangle(frame, (x1, y1), (x2, y2), color, thickness)
        label = f"ID:{track_id} {class_name} {conf:.2f}"
        (tw, th), _ = get_text_size(label, config.FONT_SCALE_ID, 1)
        y_text = max(y1, th + 8)
        rectangle(frame, (x1, y_text - th - 8), (x1 + tw + 4, y_text),
                  color, -1)
        put_text(frame, label, (x1 + 2, y_text - 4), config.FONT_SCALE_ID,
                 (0, 0, 0), 1)
    return frame


def draw_fps(frame: np.ndarray, fps: float,
             position: Tuple[int, int] = (10, 30)) -> np.ndarray:
    """FPS overlay."""
    put_text(frame, f"FPS: {fps:.1f}", position, config.FONT_SCALE_INFO,
             (0, 255, 0), config.FONT_THICKNESS)
    return frame


def draw_info_panel(frame: np.ndarray, lines: Sequence[str],
                    origin: Tuple[int, int] = (10, 10)) -> np.ndarray:
    """Multi-line top-left info panel with a background box."""
    if not lines:
        return frame
    pad = 8
    line_h = 26
    width = 0
    for line in lines:
        (tw, _), _ = get_text_size(line, 0.6, 1)
        width = max(width, tw)
    x0, y0 = origin
    x1 = x0 + width + 2 * pad
    y1 = y0 + line_h * len(lines) + pad
    # addWeighted of a pixel with itself gives it back (every value 0-255),
    # so only the box, clipped, is blended
    h, w = frame.shape[:2]
    ya, yb = max(min(y0, y1), 0), min(max(y0, y1), h - 1) + 1
    xa, xb = max(min(x0, x1), 0), min(max(x0, x1), w - 1) + 1
    if ya < yb and xa < xb:
        box = frame[ya:yb, xa:xb]
        _add_weighted(np.zeros_like(box), box)
    for i, line in enumerate(lines):
        put_text(frame, line, (x0 + pad, y0 + pad + line_h * i + 14), 0.6,
                 (255, 255, 255), 1)
    return frame
