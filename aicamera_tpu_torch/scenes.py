"""Seeded scenes of moving rectangles, in numpy, for smoke runs and tests.

A small numpy counterpart of the JAX package's synthetic world: class-
coloured, two-tone striped rectangles with a dark rim (person red, car blue,
bus green, truck yellow, motorcycle magenta, in BGR) over a gradient-plus-
noise background, each moving at a constant velocity and bouncing off the
frame edges. The committed synthetic detector was trained on scenes of this
kind, so it finds the rectangles. :func:`panning_rectangles` films such a
scene with a panning camera over a textured background and returns the true
camera motion, for camera-motion compensation.
"""

from __future__ import annotations

import numpy as np

# class id: (BGR base colour, aspect w/h range, height range as a fraction
# of the frame height)
_CLASSES = {
    0: ((40, 40, 200), (0.25, 0.45), (0.13, 0.40)),   # person
    2: ((200, 90, 40), (1.6, 2.6), (0.09, 0.24)),     # car
    3: ((200, 60, 200), (0.5, 0.9), (0.09, 0.22)),    # motorcycle
    5: ((50, 190, 60), (1.8, 3.0), (0.17, 0.44)),     # bus
    7: ((40, 190, 200), (1.5, 2.5), (0.15, 0.40)),    # truck
}


def _objects(rng, n_objects: int, h: int, w: int) -> list:
    """Seeded rectangles of random classes in an ``h x w`` world."""
    cls = rng.choice(list(_CLASSES), n_objects)
    objs = []
    for c in cls:
        color, (a_lo, a_hi), (h_lo, h_hi) = _CLASSES[int(c)]
        bh = rng.uniform(h_lo, h_hi) * h
        bw = min(bh * rng.uniform(a_lo, a_hi), 0.6 * w)
        objs.append(dict(
            size=np.array([bw, bh]),
            pos=np.array([rng.uniform(0, w - bw), rng.uniform(0, h - bh)]),
            vel=rng.uniform(-0.01, 0.01, 2) * np.array([w, h]),
            c1=np.clip(np.array(color) + rng.uniform(-30, 30, 3), 0, 255),
            c2=np.clip(np.array(color) * 0.7 + rng.uniform(-20, 20, 3),
                       0, 255),
            stripe=rng.uniform(4, 12) * w / 960.0))
    return objs


def _draw_and_move(img, objs, xx, yy, h: int, w: int, x_off: int = 0):
    """Draw every rectangle into ``img`` (screen pixels ``xx``, ``yy``; the
    world is seen from ``x_off`` pixels to the right), then move each at its
    constant velocity, bouncing off the edges of the ``h x w`` world."""
    img = np.array(img, np.float64)
    for o in objs:
        x1, y1 = o["pos"]
        x2, y2 = o["pos"] + o["size"]
        # the pixels of the box's bounding rows and columns (and one more
        # on each side); the tests below decide which are inside
        ya, yb = max(0, int(np.floor(y1))), min(yy.shape[0],
                                                int(np.ceil(y2)) + 1)
        xa = max(0, int(np.floor(x1)) - x_off)
        xb = min(xx.shape[1], int(np.ceil(x2)) + 1 - x_off)
        if ya >= yb or xa >= xb:
            continue
        sy, sx = yy[ya:yb, xa:xb], xx[ya:yb, xa:xb] + x_off
        inside = (sx >= x1) & (sx < x2) & (sy >= y1) & (sy < y2)
        stripes = (np.floor(sx / o["stripe"]) % 2)[..., None] > 0
        fill = np.where(stripes, o["c2"], o["c1"])
        rim = ((sx < x1 + 2) | (sx >= x2 - 2) | (sy < y1 + 2)
               | (sy >= y2 - 2))[..., None]
        fill = np.where(rim, fill * 0.45, fill)
        img[ya:yb, xa:xb] = np.where(inside[..., None], fill,
                                     img[ya:yb, xa:xb])
        o["pos"] = o["pos"] + o["vel"]
        for ax, lim in ((0, w), (1, h)):
            if o["pos"][ax] < 0 or o["pos"][ax] + o["size"][ax] > lim:
                o["vel"][ax] = -o["vel"][ax]
                o["pos"][ax] = np.clip(o["pos"][ax], 0,
                                       lim - o["size"][ax])
    return img


def moving_rectangles(n_frames: int, hw=(540, 960), n_objects: int = 6,
                      seed: int = 0) -> np.ndarray:
    """``(n_frames, H, W, 3)`` uint8 BGR frames of ``n_objects`` moving
    rectangles, made from ``seed``."""
    rng = np.random.RandomState(seed)
    h, w = hw
    objs = _objects(rng, n_objects, h, w)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = rng.uniform(90, 160, 3)
    grad = (xx[..., None] * rng.uniform(-30, 30, 3) / w
            + yy[..., None] * rng.uniform(-30, 30) / h)
    frames = np.empty((n_frames, h, w, 3), np.uint8)
    for f in range(n_frames):
        img = base + grad + rng.uniform(-12, 12, (h, w, 1))
        img = _draw_and_move(img, objs, xx, yy, h, w)
        frames[f] = np.clip(np.round(img), 0, 255).astype(np.uint8)
    return frames


def _smooth_noise(rng, h: int, w: int, width: int = 5,
                  passes: int = 2) -> np.ndarray:
    """``(h, w)`` seeded Gaussian noise blurred by ``passes`` box filters of
    ``width`` pixels along each axis (edges clamped), rescaled to unit
    standard deviation."""
    x = rng.normal(0.0, 1.0, (h, w))
    r = width // 2
    for _ in range(passes):
        for ax in (0, 1):
            pad = [(0, 0), (0, 0)]
            pad[ax] = (r + 1, r)
            c = np.cumsum(np.pad(x, pad, mode="edge"), axis=ax)
            n = x.shape[ax]
            x = (np.take(c, np.arange(width, width + n), axis=ax)
                 - np.take(c, np.arange(n), axis=ax)) / width
    return x / x.std()


def panning_rectangles(n_frames: int, hw=(540, 960), n_objects: int = 6,
                       seed: int = 0, pan: int = 24, texture: float = 24.0,
                       speed: float = 0.25):
    """Moving rectangles filmed by a panning camera, for camera-motion
    compensation: ``(frames (n_frames, H, W, 3) uint8 BGR, shifts (n_frames,
    2) f32)``.

    The world is ``pan`` pixels wider than the frame: the rectangles of
    :func:`moving_rectangles`, at ``speed`` times their velocity, over a
    gradient and a fixed texture (seeded noise, blurred so that 64-pixel
    blocks correlate, ``texture`` levels standard deviation). The camera's window oscillates between the world's
    left edge and ``pan`` pixels to the right, a flip every frame, as a
    shaking camera. ``shifts[i]`` is the true camera motion from frame
    ``i - 1`` to frame ``i`` in the ``(A, t)`` convention of
    ``ops/gmc.py`` (``A`` the identity): a point at ``p`` in frame ``i - 1``
    is at ``p + shifts[i]`` in frame ``i``; ``shifts[0]`` is zero."""
    rng = np.random.RandomState(seed)
    h, w = hw
    ww = w + pan
    objs = _objects(rng, n_objects, h, ww)
    for o in objs:
        o["vel"] = o["vel"] * speed
    wy, wx = np.mgrid[0:h, 0:ww].astype(np.float32)
    world = (rng.uniform(90, 160, 3)
             + wx[..., None] * rng.uniform(-30, 30, 3) / ww
             + wy[..., None] * rng.uniform(-30, 30) / h
             + texture * _smooth_noise(rng, h, ww)[..., None])
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = np.empty((n_frames, h, w, 3), np.uint8)
    shifts = np.zeros((n_frames, 2), np.float32)
    off = 0
    for f in range(n_frames):
        if f:
            new = pan if off == 0 else 0
            shifts[f, 0] = off - new
            off = new
        img = world[:, off:off + w] + rng.uniform(-3, 3, (h, w, 1))
        img = _draw_and_move(img, objs, xx, yy, h, ww, x_off=off)
        frames[f] = np.clip(np.round(img), 0, 255).astype(np.uint8)
    return frames, shifts


def moving_boxes(n_frames: int, n_objects: int = 6, seed: int = 0,
                 hw=(540, 960), miss: float = 0.1, low: float = 0.2,
                 clutter: float = 0.3, gaps=()):
    """Seeded per-frame detections of ``n_objects`` boxes at constant
    velocity, for driving a tracker core without a detector: a list of
    ``(xyxy (n, 4) f32, score (n,) f32, class_id (n,) int32)`` per frame.

    Each object is missed with probability ``miss`` and scores below 0.5
    with probability ``low`` (else 0.65 to 0.95). With probability
    ``clutter`` a frame gets one stray box, and every seventh frame a
    near-duplicate of its first box. ``gaps``: ``(object, first, last)``
    frame ranges in which an object is hidden (an occlusion to be revived
    from). Detections are shuffled."""
    rng = np.random.RandomState(seed)
    h, w = hw
    size = np.stack([rng.uniform(0.04, 0.12, n_objects) * w,
                     rng.uniform(0.10, 0.30, n_objects) * h], 1)
    pos = rng.uniform(0, 1, (n_objects, 2)) * (np.array([w, h]) - size)
    vel = rng.uniform(-0.012, 0.012, (n_objects, 2)) * np.array([w, h])
    cls = rng.choice([0, 2, 5], n_objects)
    frames = []
    for f in range(n_frames):
        boxes, scores, classes = [], [], []
        for o in range(n_objects):
            hidden = any(g[0] == o and g[1] <= f <= g[2] for g in gaps)
            seen = rng.uniform() >= miss
            weak = rng.uniform() < low
            jitter = rng.normal(0, 1.0, 4)
            s = rng.uniform(0.15, 0.45) if weak else rng.uniform(0.65, 0.95)
            if seen and not hidden:
                boxes.append(np.concatenate([pos[o], pos[o] + size[o]])
                             + jitter)
                scores.append(s)
                classes.append(cls[o])
        if rng.uniform() < clutter:
            xy = rng.uniform(0, 0.8, 2) * np.array([w, h])
            boxes.append(np.concatenate([xy, xy + rng.uniform(20, 90, 2)]))
            scores.append(rng.uniform(0.55, 0.9))
            classes.append(0)
        if f % 7 == 6 and boxes:
            boxes.append(boxes[0] + 1.5)
            scores.append(0.7)
            classes.append(classes[0])
        order = rng.permutation(len(boxes))
        frames.append((
            np.asarray(boxes, np.float32).reshape(-1, 4)[order],
            np.asarray(scores, np.float32)[order],
            np.asarray(classes, np.int32)[order]))
        pos = pos + vel
        for ax, lim in ((0, w), (1, h)):
            out = (pos[:, ax] < 0) | (pos[:, ax] + size[:, ax] > lim)
            vel[out, ax] = -vel[out, ax]
            pos[:, ax] = np.clip(pos[:, ax], 0, lim - size[:, ax])
    return frames
