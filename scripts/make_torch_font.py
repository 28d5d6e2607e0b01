#!/usr/bin/env python3
"""Write ``aicamera_tpu_torch/utils/font_simplex.npz``: the text that
``cv2.putText(..., cv2.FONT_HERSHEY_SIMPLEX, scale, color, thickness,
cv2.LINE_AA)`` draws, as data, for the port's ``utils/visualization.py``.

    python scripts/make_torch_font.py   (needs OpenCV; run once, commit)

For each (scale, thickness) pair the package draws with, (0.5, 1), (0.7, 1),
(0.6, 1) and (0.9, 2), and for every printable ASCII and Latin-1
character it stores:

- the advance in whole pixels (``getTextSize`` of ``c * 2`` minus that of
  ``c``): this OpenCV build places glyphs on whole pixels, and the width of a
  string is the sum of its advances plus 1;
- the baseline (``getTextSize``'s second value for ``c``): a string's is the
  largest of its characters';
- the glyph's alpha mask, drawn white on black at an integer origin, cropped
  to its ink, with the offset of the crop from the origin.

It also stores the text height of each pair (one value for every string)
and the code point of each glyph (``chars``). The script checks the model on
random strings against ``getTextSize`` before it writes anything.
"""

from __future__ import annotations

import random
from pathlib import Path

import cv2
import numpy as np

PAIRS = ((0.5, 1), (0.7, 1), (0.6, 1), (0.9, 2))
CHARS = [chr(c) for c in (*range(32, 127), *range(0xA0, 0x100))]
OUT = (Path(__file__).resolve().parent.parent / "aicamera_tpu_torch" /
       "utils" / "font_simplex.npz")
FONT = cv2.FONT_HERSHEY_SIMPLEX
CANVAS, ORIGIN = (120, 200), (40, 80)   # (h, w), (x, y)


def measure(scale, thickness):
    adv, base, masks = [], [], []
    heights = set()
    for c in CHARS:
        (w1, h), b = cv2.getTextSize(c, FONT, scale, thickness)
        (w2, _), _ = cv2.getTextSize(c * 2, FONT, scale, thickness)
        adv.append(w2 - w1)
        base.append(b)
        heights.add(h)
        m = np.zeros(CANVAS, np.uint8)
        cv2.putText(m, c, ORIGIN, FONT, scale, 255, thickness, cv2.LINE_AA)
        ys, xs = np.nonzero(m)
        if len(ys) == 0:
            masks.append((0, 0, np.zeros((0, 0), np.uint8)))
            continue
        y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
        assert 0 < y0 and y1 < CANVAS[0] and 0 < x0 and x1 < CANVAS[1], c
        masks.append((y0 - ORIGIN[1], x0 - ORIGIN[0], m[y0:y1, x0:x1]))
    assert len(heights) == 1, (scale, thickness, heights)
    return np.array(adv), np.array(base), heights.pop(), masks


def main():
    arrays = {"chars": np.array([ord(c) for c in CHARS], np.int32),
              "pairs": np.array(PAIRS, np.float64)}
    for i, (scale, thickness) in enumerate(PAIRS):
        adv, base, height, masks = measure(scale, thickness)
        rng = random.Random(i)
        for _ in range(2000):
            text = "".join(rng.choice(CHARS)
                           for _ in range(rng.randint(1, 24)))
            idx = [CHARS.index(c) for c in text]
            want = cv2.getTextSize(text, FONT, scale, thickness)
            assert want == ((int(adv[idx].sum()) + 1, height),
                            int(base[idx].max())), text
        arrays[f"adv{i}"] = adv.astype(np.int16)
        arrays[f"base{i}"] = base.astype(np.int16)
        arrays[f"height{i}"] = np.int16(height)
        arrays[f"box{i}"] = np.array([(dy, dx, *m.shape)
                                      for dy, dx, m in masks], np.int16)
        arrays[f"alpha{i}"] = np.concatenate([m.ravel()
                                              for _, _, m in masks])
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
