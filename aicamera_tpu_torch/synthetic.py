"""Synthetic tracking world: procedural scenes with exact ground truth.

The port of ``aicamera_tpu/synthetic.py``: class-styled rectangles with
per-instance appearance (two-tone stripes, a dark 2 px rim) over a gradient
and noise background, moving with constant velocity plus noise and bouncing
off the frame edges. The committed synthetic detector and ReID net were
trained on these scenes, so the world gives the port a workload its weights
know, with ground truth to score tracking and detection against
(:mod:`.eval`).

The draws are ``jax.random``'s, bit for bit (:mod:`.prng`), so a seed gives
the JAX package's scene. Rendering and ground truth are torch on the device
of the objects; functions that take only a key take a ``device`` (default the
GPU). The float arithmetic follows what XLA's CPU backend compiles the JAX
functions to, including the multiply-adds it fuses: each ``_fma`` below is
one of those, computed in float64 and rounded once. The card and the CPU
give the same bits; against JAX a pixel may still round to the next level
where XLA fused differently (``PERF.md`` counts them).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from . import prng
from .prng import _fma
from .device import resolve_device

# Tracked classes (reference config.py:53): COCO ids.
CLASS_IDS = (0, 2, 3, 5, 7)          # person, car, motorcycle, bus, truck

# Per-class priors: (h_min, h_max, aspect_min, aspect_max) in source pixels
# (aspect = w / h).
_PRIORS = {
    0: (70, 220, 0.25, 0.45),        # person: tall, thin
    2: (45, 130, 1.6, 2.6),          # car: wide, low
    3: (50, 120, 0.5, 0.9),          # motorcycle
    5: (90, 240, 1.8, 3.0),          # bus: very wide, tall
    7: (80, 220, 1.5, 2.5),          # truck
}

# Class colour families: BGR base and per-channel jitter span.
_COLORS = {
    0: ((40, 40, 200), (40, 40, 55)),     # person: red
    2: ((200, 90, 40), (55, 50, 40)),     # car: blue
    3: ((200, 60, 200), (55, 40, 55)),    # motorcycle: magenta
    5: ((50, 190, 60), (40, 60, 40)),     # bus: green
    7: ((40, 190, 200), (40, 60, 55)),    # truck: yellow
}

_CLS_TABLE = np.asarray(CLASS_IDS, np.int32)
_PRIOR_TABLE = np.asarray([_PRIORS[c] for c in CLASS_IDS], np.float32)
_COLOR_BASE = np.asarray([_COLORS[c][0] for c in CLASS_IDS], np.float32)
_COLOR_SPAN = np.asarray([_COLORS[c][1] for c in CLASS_IDS], np.float32)


@dataclasses.dataclass(frozen=True)
class WorldSpec:
    """Static scene configuration."""
    hw: Tuple[int, int] = (540, 960)
    max_objects: int = 12
    presence: float = 0.75            # probability a slot holds an object
    noise: float = 12.0               # background noise amplitude (levels)
    # Also invalidate objects whose visible (z-order-owned) pixel fraction
    # falls below ground_truth's min_visible: the MOTChallenge-style
    # visibility filter crowd worlds need.
    occlusion_aware_gt: bool = False
    size_scale: float = 1.0           # object size multiplier on the priors


_TABLES = {"prior": _PRIOR_TABLE, "color_base": _COLOR_BASE,
           "color_span": _COLOR_SPAN, "cls": _CLS_TABLE}


@functools.lru_cache(maxsize=None)
def _table(name: str, device) -> torch.Tensor:
    """A class table on ``device``, uploaded once and shared (read only): a
    copy from host memory would wait for the device on every scene."""
    return torch.from_numpy(_TABLES[name]).to(device)


def random_objects(key: np.ndarray, spec: WorldSpec, device=None) -> dict:
    """Sample one scene's object slots. Returns a dict of tensors: ``valid``
    (N,) bool, ``cls`` (N,) int32 index into CLASS_IDS, ``xyxy`` (N, 4)
    source-pixel boxes, ``color``/``color2`` (N, 3), ``phase`` (N,),
    ``stripe`` (N,) float32.

    Boxes may extend up to 25% beyond the frame edge; ground truth clips."""
    dev = resolve_device(device)
    h, w = spec.hw
    n = spec.max_objects
    ks = prng.split(key, 8)
    valid = prng.bernoulli(ks[0], spec.presence, (n,), dev)
    ci = prng.randint(ks[1], (n,), 0, len(CLASS_IDS), dev)
    pri = _table("prior", dev)[ci]                            # (N, 4)
    u = prng.uniform(ks[2], (n, 2), device=dev)
    bh = _fma(u[:, 0], pri[:, 1] - pri[:, 0], pri[:, 0])
    if spec.size_scale != 1.0:
        bh = bh * spec.size_scale
    bw = bh * _fma(u[:, 1], pri[:, 3] - pri[:, 2], pri[:, 2])
    c = prng.uniform(ks[3], (n, 2), device=dev)
    half_w, half_h = bw * 0.5, bh * 0.5
    cx = _fma(c[:, 0], _fma(bw, 0.5, float(w)), -(bw * 0.25))
    cy = _fma(c[:, 1], _fma(bh, 0.5, float(h)), -(bh * 0.25))
    xyxy = torch.stack([cx - half_w, cy - half_h,
                        cx + half_w, cy + half_h], dim=-1)
    jit1 = prng.uniform(ks[4], (n, 3), -1.0, 1.0, device=dev)
    jit2 = prng.uniform(ks[5], (n, 3), -1.0, 1.0, device=dev)
    color = torch.clamp(_fma(jit1, _table("color_span", dev)[ci],
                             _table("color_base", dev)[ci]), 0, 255)
    color2 = torch.clamp(color * _fma(jit2, 0.25, 0.55), 0, 255)
    phase = prng.uniform(ks[6], (n,), maxval=64.0, device=dev)
    stripe = prng.randint(ks[7], (n,), 6, 18, dev).float()
    return {"valid": valid, "cls": ci, "xyxy": xyxy, "color": color,
            "color2": color2, "phase": phase, "stripe": stripe}


def _grid(spec: WorldSpec, device):
    h, w = spec.hw
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return yy, xx


def _inside(objects, yy, xx) -> torch.Tensor:
    """(N, H, W): pixel centres inside each valid slot's box."""
    b = objects["xyxy"][:, :, None, None]
    return ((xx >= b[:, 0]) & (xx < b[:, 2]) & (yy >= b[:, 1])
            & (yy < b[:, 3]) & objects["valid"][:, None, None])


def _owner(inside: torch.Tensor) -> torch.Tensor:
    """(H, W) int64: 1 + the highest slot covering each pixel, 0 for the
    background (later slots paint over earlier ones)."""
    n = inside.shape[0]
    idx = torch.arange(1, n + 1, dtype=torch.int16, device=inside.device)
    return torch.where(inside, idx[:, None, None],
                       torch.zeros((), dtype=torch.int16,
                                   device=inside.device)).amax(0).long()


def render(objects: dict, spec: WorldSpec, key: np.ndarray) -> torch.Tensor:
    """Rasterize one scene to an (H, W, 3) uint8 BGR frame on the objects'
    device. Each object: striped two-tone fill with a darker 2 px rim.
    Background: a random linear gradient plus uniform noise."""
    dev = objects["xyxy"].device
    h, w = spec.hw
    n = spec.max_objects
    kg, kn = prng.split(key)
    yy, xx = _grid(spec, dev)

    g = prng.uniform(kg, (8,), device=dev)
    base = _fma(g[:3], 70.0, 90.0)                            # (3,) BGR
    gx = (g[3:6] - 0.5) * float(np.float32(60.0 / w))
    gy = (g[6] + g[7] - 1.0) * float(np.float32(60.0 / h))
    bg = _fma(gx, xx[..., None], base) + gy * yy[..., None]
    bg = prng.uniform(kn, (h, w, 1), -spec.noise, spec.noise,
                      device=dev) + bg

    inside = _inside(objects, yy, xx)
    own = _owner(inside) - 1                                  # -1 = bg
    sel = own.clamp(0, n - 1)
    x1, y1 = objects["xyxy"][:, 0][sel], objects["xyxy"][:, 1][sel]
    x2, y2 = objects["xyxy"][:, 2][sel], objects["xyxy"][:, 3][sel]
    t = torch.remainder(torch.floor((xx + objects["phase"][sel])
                                    / objects["stripe"][sel]), 2.0)
    rim = ((xx < x1 + 2.0) | (xx >= x2 - 2.0) | (yy < y1 + 2.0)
           | (yy >= y2 - 2.0))
    fill = torch.where((t > 0)[..., None], objects["color2"][sel],
                       objects["color"][sel])
    fill = torch.where(rim[..., None], fill * 0.45, fill)
    frame = torch.where((own >= 0)[..., None], fill, bg)
    return torch.clamp(torch.round(frame), 0, 255).to(torch.uint8)


def visibility(objects: dict, spec: WorldSpec) -> torch.Tensor:
    """(N,) float32: the pixels each slot owns in the rendered frame over
    its in-frame box pixels (the ownership of :func:`render`); 0 for
    invalid slots."""
    yy, xx = _grid(spec, objects["xyxy"].device)
    inside = _inside(objects, yy, xx)
    owner = _owner(inside)
    idx = torch.arange(1, spec.max_objects + 1, device=owner.device)
    owned = (owner[None] == idx[:, None, None]).sum((1, 2)).float()
    in_frame = inside.sum((1, 2)).float()
    return owned / torch.clamp_min(in_frame, 1.0)


def ground_truth(objects: dict, spec: WorldSpec, min_visible: float = 0.25):
    """Frame-clipped gt boxes: ``(xyxy (N, 4), cls_coco (N,) int32, valid
    (N,) bool)``. Slots whose clipped area is below ``min_visible`` of the
    full box are invalid; with ``spec.occlusion_aware_gt`` the same
    threshold also applies to the visible fraction (:func:`visibility`)."""
    h, w = spec.hw
    b = objects["xyxy"]
    lim = (w, h, w, h)
    cl = torch.stack([torch.clamp(b[:, i], 0, lim[i]) for i in range(4)],
                     dim=-1)
    area = (torch.clamp_min(b[:, 2] - b[:, 0], 1e-6)
            * torch.clamp_min(b[:, 3] - b[:, 1], 1e-6))
    carea = (torch.clamp_min(cl[:, 2] - cl[:, 0], 0)
             * torch.clamp_min(cl[:, 3] - cl[:, 1], 0))
    valid = objects["valid"] & (carea / area >= min_visible)
    if spec.occlusion_aware_gt:
        valid = valid & (visibility(objects, spec) >= min_visible)
    cls = _table("cls", b.device)[objects["cls"].long()]
    return cl, cls, valid


def random_scene(key: np.ndarray, spec: WorldSpec, device=None):
    """One-call scene: ``(frame_u8, gt_xyxy, gt_cls, gt_valid)``."""
    ko, kr = prng.split(key)
    obj = random_objects(ko, spec, device)
    frame = render(obj, spec, kr)
    boxes, cls, valid = ground_truth(obj, spec)
    return frame, boxes, cls, valid


class TemporalWorld:
    """Temporal simulator for tracking runs: host-side motion, device-side
    rendering and ground truth.

    Objects move with constant velocity plus small acceleration noise and
    bounce off the frame edges; the ground-truth track id is the slot index
    plus one. The motion is the JAX package's: the same numpy generator,
    draw order and float32 updates.
    """

    def __init__(self, spec: WorldSpec = WorldSpec(), seed: int = 0,
                 speed: float = 4.0, device=None):
        self.spec = spec
        self.speed = speed
        self.device = resolve_device(device)
        self._rng = np.random.default_rng(seed)
        key = prng.PRNGKey(self._rng.integers(2**31))
        self.obj = {k: v.cpu().numpy() for k, v in
                    random_objects(key, spec, self.device).items()}
        n = spec.max_objects
        self.vel = self._rng.normal(0.0, speed, (n, 2)).astype(np.float32)
        self._frame_keys = prng.split(
            prng.PRNGKey(self._rng.integers(2**31)), 4096)
        self._static = {k: torch.from_numpy(v).to(self.device)
                        for k, v in self.obj.items() if k != "xyxy"}
        self.t = 0

    def step(self):
        """Advance one frame; returns ``(frame_u8 (H, W, 3), gt_xyxy (N, 4),
        gt_ids (N,), gt_cls (N,), gt_valid (N,))`` as numpy arrays."""
        h, w = self.spec.hw
        b = self.obj["xyxy"]
        self.vel += self._rng.normal(0.0, 0.3, self.vel.shape).astype(
            np.float32)
        self.vel = np.clip(self.vel, -2.5 * self.speed, 2.5 * self.speed)
        b[:, 0::2] += self.vel[:, :1]
        b[:, 1::2] += self.vel[:, 1:]
        # bounce: reflect velocity when the box centre exits the frame
        cx = (b[:, 0] + b[:, 2]) / 2
        cy = (b[:, 1] + b[:, 3]) / 2
        self.vel[:, 0] = np.where((cx < 0) | (cx > w),
                                  -self.vel[:, 0], self.vel[:, 0])
        self.vel[:, 1] = np.where((cy < 0) | (cy > h),
                                  -self.vel[:, 1], self.vel[:, 1])
        obj = dict(self._static, xyxy=torch.from_numpy(b).to(self.device))
        frame = render(obj, self.spec, self._frame_keys[self.t % 4096])
        boxes, cls, valid = ground_truth(obj, self.spec)
        frame, boxes, cls, valid = _read(frame, boxes, cls, valid)
        ids = np.arange(1, self.spec.max_objects + 1)
        self.t += 1
        return frame, boxes, ids, cls, valid


def _read(frame, boxes, cls, valid):
    """The frame and its ground truth to the host in one copy."""
    h, w, _ = frame.shape
    n = boxes.shape[0]
    packed = torch.cat([frame.reshape(-1), boxes.contiguous().view(
        torch.uint8).reshape(-1), cls.contiguous().view(torch.uint8)
        .reshape(-1), valid.to(torch.uint8)]).cpu().numpy()
    o1 = h * w * 3
    o2 = o1 + 16 * n
    o3 = o2 + 4 * n
    return (packed[:o1].reshape(h, w, 3), packed[o1:o2].view(np.float32)
            .reshape(n, 4), packed[o2:o3].view(np.int32),
            packed[o3:].astype(bool))
