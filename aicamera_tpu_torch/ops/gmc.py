"""Global (camera) motion compensation (GMC) in PyTorch.

The port of ``aicamera_tpu/ops/gmc.py``: BoT-SORT-style compensation (warp
every Kalman state by the inter-frame camera affine before association),
estimated on the device with no host round trip. Batched block **phase
correlation** (``rfft2`` over Hann-windowed, mean-pooled grayscale tiles)
gives one translation per block; a Huber-IRLS weighted least-squares fit
turns the block translations into an affine. Degenerate scenes (flat
texture, all peaks weak) fall back toward the identity through a ridge
prior.

Conventions: the returned ``(A, t)`` maps a point ``p`` in the previous
frame to ``A @ p + t`` in the current frame, with ``p = (x, y)`` in original
frame pixels.

Parity details the JAX package gets from XLA and this module spells out:
every small matrix product is an explicit f32 multiply-and-sum (never
TF32), the 3x3 normal equations are solved by a closed-form Cholesky (SPD
by the ridge; no singularity check, so no read back from the GPU), integer
and float folds use floor semantics (``%`` on tensors), and the peak is the
first maximum (``torch.argmax``). Entries the warps must not touch
(inactive slots, sentinel observations, unwritten ring slots) pass through
``torch.where`` bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device

# --- static geometry -------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GMCSpec:
    """Static estimation geometry for one frame shape."""
    frame_hw: Tuple[int, int]
    pool: int                    # mean-pool factor applied to the gray image
    block: int                   # block side, pooled pixels
    tops: Tuple[int, ...]        # block row offsets (pooled coords)
    lefts: Tuple[int, ...]       # block col offsets (pooled coords)
    affine: bool                 # enough blocks for a full affine fit

    @property
    def pooled_hw(self) -> Tuple[int, int]:
        return (self.frame_hw[0] // self.pool, self.frame_hw[1] // self.pool)

    @property
    def n_blocks(self) -> int:
        return len(self.tops) * len(self.lefts)

    def centers(self) -> np.ndarray:
        """(B, 2) block centers in pooled (x, y) coords."""
        cy = np.asarray(self.tops, np.float32) + self.block / 2.0
        cx = np.asarray(self.lefts, np.float32) + self.block / 2.0
        gx, gy = np.meshgrid(cx, cy)
        return np.stack([gx.ravel(), gy.ravel()], axis=-1)


def gmc_spec(frame_hw: Tuple[int, int], target: int = 288,
             max_grid: int = 4) -> GMCSpec:
    """Choose pooling + block grid for a frame shape. ``target`` bounds the
    pooled short side: large enough that 64-px blocks see real texture."""
    h, w = int(frame_hw[0]), int(frame_hw[1])
    pool = max(1, int(round(min(h, w) / float(target))))
    ph, pw = h // pool, w // pool
    block = 64
    while block > 8 and (ph < 2 * block or pw < 2 * block):
        block //= 2
    rows = min(max_grid, ph // block)
    cols = min(max_grid, pw // block)
    if rows < 1 or cols < 1:
        raise ValueError(f"frame {frame_hw} too small for GMC estimation")
    tops = tuple(int(v) for v in
                 np.linspace(0, ph - block, rows).round().astype(int))
    lefts = tuple(int(v) for v in
                  np.linspace(0, pw - block, cols).round().astype(int))
    return GMCSpec(frame_hw=(h, w), pool=pool, block=block, tops=tops,
                   lefts=lefts, affine=(rows >= 2 and cols >= 2))


# --- small f32 products ----------------------------------------------------


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over the last two axes as an f32 multiply-and-sum (exact
    products, never TF32: ``lax.Precision.HIGHEST``)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _apply2(a_mat: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """``(..., 2)`` points through a 2x2 matrix (broadcast over the lead)."""
    return (a_mat[..., None, :, :] * xy[..., None, :]).sum(-1)


# --- estimation ------------------------------------------------------------


def gray_pooled(frames_u8: torch.Tensor, spec: GMCSpec) -> torch.Tensor:
    """``(..., H, W, 3)`` uint8 -> ``(..., H//p, W//p)`` f32 channel mean +
    mean pool, each a sum in row-major order times the f32 reciprocal of its
    count (XLA's arithmetic for these means, so the result equals the JAX
    package's bit for bit on the CPU)."""
    ph, pw = spec.pooled_hw
    p = spec.pool
    x = frames_u8[..., :ph * p, :pw * p, :].float()
    x = (x[..., 0] + x[..., 1] + x[..., 2]) * (1.0 / 3.0)
    if p > 1:
        x = x.reshape(*x.shape[:-2], ph, p, pw, p)
        s = x[..., 0, :, 0]
        for i in range(p):
            for j in range(p):
                if i or j:
                    s = s + x[..., i, :, j]
        x = s * (1.0 / (p * p))
    return x


def _hann2(block: int) -> np.ndarray:
    n = np.arange(block, dtype=np.float32)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / max(block - 1, 1))
    return np.outer(w, w).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _constants(spec: GMCSpec, device: torch.device):
    """The spec's constant tensors on ``device``, uploaded once (a copy from
    pageable host memory waits for the device's stream): the Hann window
    ``(b, b)``, the fit's design matrix ``(B, 3)`` over normalized block
    centres, the centres' mean ``(2,)`` and their scale (a float)."""
    centers = spec.centers()
    c_mean = centers.mean(0)
    c_scale = max(float(np.abs(centers - c_mean).max()), 1.0)
    u = (centers - c_mean) / c_scale
    x_mat = np.concatenate([u, np.ones((len(u), 1), np.float32)], axis=-1)
    return (torch.from_numpy(_hann2(spec.block)).to(device),
            torch.from_numpy(x_mat).to(device),
            torch.from_numpy(np.asarray(c_mean, np.float32)).to(device),
            c_scale)


def _windowed_blocks(gray: torch.Tensor, spec: GMCSpec) -> torch.Tensor:
    """``(..., Hp, Wp)`` -> ``(..., B, b, b)`` mean-subtracted,
    Hann-windowed tiles."""
    b = spec.block
    tiles = torch.stack([gray[..., t:t + b, l:l + b]
                         for t in spec.tops for l in spec.lefts], dim=-3)
    tiles = tiles - tiles.mean(dim=(-2, -1), keepdim=True)
    return tiles * _constants(spec, gray.device)[0]


def _phase_correlate(b0: torch.Tensor, b1: torch.Tensor, block: int):
    """Per-block displacement of ``b1``'s content relative to ``b0``.

    ``b0``, ``b1``: ``(..., B, b, b)`` windowed tiles. Returns disp ``(...,
    B, 2)`` (dx, dy) with sub-pixel parabolic refinement and conf ``(...,
    B)``, the phase-correlation peak heights (about 1 for a clean whole-block
    translation, about 0 for decorrelated content)."""
    f0 = torch.fft.rfft2(b0)
    f1 = torch.fft.rfft2(b1)
    r = f1 * torch.conj(f0)
    r = r / (torch.abs(r) + 1e-9)
    corr = torch.fft.irfft2(r, s=(block, block))
    flat = corr.reshape(*corr.shape[:-2], block * block)
    idx = torch.argmax(flat, dim=-1)            # the first maximum
    py, px = idx // block, idx % block

    def at(dy, dx):
        pos = ((py + dy) % block) * block + (px + dx) % block
        return torch.gather(flat, -1, pos[..., None])[..., 0]

    peak = at(0, 0)
    zero = torch.zeros((), dtype=flat.dtype, device=flat.device)

    def parab(m, p0, p):
        denom = m - 2.0 * p0 + p
        off = torch.where(torch.abs(denom) > 1e-9, 0.5 * (m - p) / denom,
                          zero)
        return torch.clamp(off, -0.5, 0.5)

    dy = py + parab(at(-1, 0), peak, at(1, 0))
    dx = px + parab(at(0, -1), peak, at(0, 1))
    # argmax lives on a circular surface: fold into [-b/2, b/2)
    half = block / 2.0
    dy = (dy + half) % block - half
    dx = (dx + half) % block - half
    return torch.stack([dx, dy], dim=-1), torch.clamp(peak, min=0.0)


def _cholesky_solve3(n_mat: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """``(..., 3, 3)`` SPD systems with ``(..., 3, m)`` right-hand sides,
    closed form: no pivot or singularity check, so nothing is read back."""
    a = n_mat
    l11 = torch.sqrt(a[..., 0, 0])
    l21 = a[..., 1, 0] / l11
    l31 = a[..., 2, 0] / l11
    l22 = torch.sqrt(a[..., 1, 1] - l21 * l21)
    l32 = (a[..., 2, 1] - l31 * l21) / l22
    l33 = torch.sqrt(a[..., 2, 2] - l31 * l31 - l32 * l32)
    l11, l21, l31, l22, l32, l33 = (v[..., None] for v in
                                    (l11, l21, l31, l22, l32, l33))
    y1 = rhs[..., 0, :] / l11
    y2 = (rhs[..., 1, :] - l21 * y1) / l22
    y3 = (rhs[..., 2, :] - l31 * y1 - l32 * y2) / l33
    x3 = y3 / l33
    x2 = (y2 - l32 * x3) / l22
    x1 = (y1 - l21 * x2 - l31 * x3) / l11
    return torch.stack([x1, x2, x3], dim=-2)


def _fit_motion(disp: torch.Tensor, conf: torch.Tensor, spec: GMCSpec,
                method: str, huber_px: float = 1.5, ridge: float = 1e-3,
                iters: int = 2):
    """Robust fit of ``dst = A @ src + t`` from block correspondences,
    batched over the leading axes of ``disp (..., B, 2)`` and ``conf (...,
    B)`` (pooled coords).

    The fit solves for the residual displacement field ``d = M u + t0`` over
    normalized centers ``u`` (so the ridge prior pulls toward the identity
    and the 3x3 normal system stays well-conditioned in f32), then returns
    ``A = I + M`` ``(..., 2, 2)`` and ``t`` ``(..., 2)`` in original frame
    pixels."""
    dev = disp.device
    _, x_mat, c_mean, c_scale = _constants(spec, dev)               # (B, 3)
    d = disp
    lead = d.shape[:-2]
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)

    w = conf
    beta = None
    for _ in range(iters + 1):
        if method == "translation" or not spec.affine:
            wsum = torch.sum(w, dim=-1) + ridge
            t0 = (w[..., :, None] * d).sum(-2) / wsum[..., None]
            beta = torch.cat([torch.zeros((*lead, 2, 2), dtype=torch.float32,
                                          device=dev), t0[..., None, :]],
                             dim=-2)
        else:
            xtw = x_mat.T * w[..., None, :]                         # (.., 3, B)
            n_mat = _mm(xtw, x_mat) + ridge * eye3
            rhs = _mm(xtw, d)                                       # (.., 3, 2)
            beta = _cholesky_solve3(n_mat, rhs)
        resid = d - _mm(x_mat, beta)
        rn = torch.sqrt((resid * resid).sum(-1))
        w = conf * torch.clamp(huber_px / torch.clamp(rn, min=1e-6), max=1.0)

    m_mat = beta[..., :2, :].transpose(-1, -2) / c_scale  # d/d(src), pooled
    t0 = beta[..., 2, :] - (m_mat * c_mean).sum(-1)
    a_mat = torch.eye(2, dtype=torch.float32, device=dev) + m_mat
    return a_mat, t0 * float(spec.pool)


def estimate_pair(prev_gray: torch.Tensor, cur_gray: torch.Tensor,
                  spec: GMCSpec, method: str = "affine"):
    """Camera motion between two pooled gray images -> ``(A, t)`` (both
    may carry leading batch axes)."""
    b0 = _windowed_blocks(prev_gray, spec)
    b1 = _windowed_blocks(cur_gray, spec)
    disp, conf = _phase_correlate(b0, b1, spec.block)
    return _fit_motion(disp, conf, spec, method)


def estimate_chunk(prev_frame_u8: torch.Tensor, frames_u8: torch.Tensor,
                   spec: GMCSpec, method: str = "affine"):
    """Per-frame camera motion across a chunk, batched over its frames.

    ``prev_frame_u8`` ``(..., H, W, 3)``: the frame before the chunk (for
    the first chunk of a stream, its own first frame: the estimate is then
    the identity). ``frames_u8`` ``(..., K, H, W, 3)``. Returns ``A (..., K,
    2, 2)``, ``t (..., K, 2)``: frame i-1 -> frame i coordinates. Leading
    axes (several streams' chunks) are batched too."""
    grays = gray_pooled(torch.cat([prev_frame_u8.unsqueeze(-4), frames_u8],
                                  dim=-4), spec)
    blocks = _windowed_blocks(grays, spec)                # (..., K+1, B, b, b)
    disp, conf = _phase_correlate(blocks[..., :-1, :, :, :],
                                  blocks[..., 1:, :, :, :], spec.block)
    return _fit_motion(disp, conf, spec, method)


_GMC_OFF = (False, None, "off", "none", "")


def gmc_method(gmc) -> str | None:
    """The estimation method a ``gmc=`` argument asks for: ``None`` (off),
    ``"affine"`` (``True`` too) or ``"translation"``."""
    if gmc in _GMC_OFF:
        return None
    if gmc is True or gmc == "affine":
        return "affine"
    if gmc == "translation":
        return "translation"
    raise ValueError(f"gmc must be off/affine/translation or a bool "
                     f"(got {gmc!r})")


class GMCEstimator:
    """Per-frame estimation for the facades.

    Keeps the previous frame on its device and returns the camera ``(A (2,
    2), t (2,))`` for each new one as device tensors, read back never. The
    first frame of a stream yields the identity. ``device``: where the
    frames go (default the GPU, as every entry point); a tensor passed to
    :meth:`step` is moved there."""

    def __init__(self, method: str = "affine", device=None):
        if method not in ("affine", "translation"):
            raise ValueError(f"gmc method must be 'affine' or "
                             f"'translation' (got {method!r})")
        self.method = method
        self.device = resolve_device(device)
        self._prev = None
        self._specs = {}

    def reset(self):
        self._prev = None

    def step(self, frame_bgr):
        """``(H, W, 3)`` uint8 (numpy or tensor) -> ``(A, t)`` on the
        device."""
        if isinstance(frame_bgr, np.ndarray):
            frame = torch.from_numpy(np.ascontiguousarray(frame_bgr)).to(
                self.device)
        else:
            frame = frame_bgr.to(self.device)
        hw = tuple(frame.shape[:2])
        spec = self._specs.get(hw)
        if spec is None:
            spec = self._specs[hw] = gmc_spec(hw)
        prev = self._prev if self._prev is not None else frame
        a_mat, t = estimate_pair(gray_pooled(prev, spec),
                                 gray_pooled(frame, spec), spec, self.method)
        # the caller may reuse its buffer (a CPU tensor can share a numpy
        # array's memory): keep a copy
        self._prev = frame.clone()
        return a_mat, t


# --- Kalman-bank warps -----------------------------------------------------


def _safe_det(a_mat: torch.Tensor) -> torch.Tensor:
    det = a_mat[..., 0, 0] * a_mat[..., 1, 1] \
        - a_mat[..., 0, 1] * a_mat[..., 1, 0]
    return torch.clamp(torch.abs(det), min=1e-6)


def _jacobian(n: int, a_mat: torch.Tensor, diag: dict) -> torch.Tensor:
    """The ``n x n`` state Jacobian: ``a_mat`` on the position block (0:2)
    and the velocity block (4:6), ``diag`` entries ``{index: 0-d tensor}``
    on the diagonal, identity elsewhere."""
    j = torch.eye(n, dtype=torch.float32, device=a_mat.device)
    j[0:2, 0:2] = a_mat
    j[4:6, 4:6] = a_mat
    for i, v in diag.items():
        j[i, i] = v
    return j


def _congruence(j: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    """``J P Jᵀ`` for a bank ``(T, n, n)`` of covariances."""
    return _mm(_mm(j, cov), j.T)


def warp_xyah_bank(mean: torch.Tensor, cov: torch.Tensor,
                   a_mat: torch.Tensor, t: torch.Tensor,
                   active: torch.Tensor):
    """Warp a bank of 8-dim xyah Kalman states by the camera affine.

    Position and velocity get the full 2x2 linear part plus translation
    (position only); height scales by ``sqrt(|det A|)`` (the isotropic zoom
    factor); the aspect ratio is scale-invariant and stays. The covariance
    transforms by the same Jacobian, ``P' = J P Jᵀ``. Inactive slots pass
    through untouched."""
    s = torch.sqrt(_safe_det(a_mat))
    j = _jacobian(8, a_mat, {3: s, 7: s})
    shift = torch.zeros(8, dtype=torch.float32, device=mean.device)
    shift[0:2] = t
    new_mean = (j[None] * mean[:, None, :]).sum(-1) + shift
    new_cov = _congruence(j, cov)
    return (torch.where(active[:, None], new_mean, mean),
            torch.where(active[:, None, None], new_cov, cov))


def warp_boxes_xyxy(boxes: torch.Tensor, a_mat: torch.Tensor,
                    t: torch.Tensor) -> torch.Tensor:
    """Warp ``(..., 4)`` xyxy boxes: both corners through the affine, then
    re-ordered min/max (a rotation component can swap corner extremes)."""
    p1 = _apply2(a_mat, boxes[..., 0:2]) + t
    p2 = _apply2(a_mat, boxes[..., 2:4]) + t
    return torch.cat([torch.minimum(p1, p2), torch.maximum(p1, p2)], dim=-1)


def _warp_ocsort_x(x: torch.Tensor, a_mat: torch.Tensor, t: torch.Tensor,
                   det: torch.Tensor, aniso: torch.Tensor) -> torch.Tensor:
    """(T, 7) (cx, cy, s, r, vcx, vcy, vs) through the affine."""
    pos = _apply2(a_mat, x[:, 0:2]) + t
    vel = _apply2(a_mat, x[:, 4:6])
    return torch.cat([pos, (x[:, 2] * det)[:, None],
                      (x[:, 3] * aniso)[:, None], vel,
                      (x[:, 6] * det)[:, None]], dim=-1)


def warp_ocsort_state(state, a_mat: torch.Tensor, t: torch.Tensor):
    """Warp an :class:`..core.ocsort.OCSortState` by the camera affine.

    Beyond the KF bank the observation history moves too: ``last_obs``, the
    ``obs_ring``, the frozen ORU state, and the (dy, dx) momentum direction.
    Area ``s`` scales by ``|det A|``; the aspect ratio by the axis-aligned
    anisotropy ``a00/a11``. Sentinel entries (``last_obs`` score < 0,
    unwritten ring slots, inactive tracks) pass through untouched."""
    det = _safe_det(a_mat)
    aniso = torch.abs(a_mat[0, 0]) / torch.clamp(torch.abs(a_mat[1, 1]),
                                                 min=1e-6)
    act = state.active
    j = _jacobian(7, a_mat, {2: det, 3: aniso, 6: det})

    new_x = _warp_ocsort_x(state.x, a_mat, t, det, aniso)
    new_p = _congruence(j, state.p)
    new_fx = _warp_ocsort_x(state.frozen_x, a_mat, t, det, aniso)
    new_fp = _congruence(j, state.frozen_p)
    froz = act & state.frozen_valid

    has_obs = act & (state.last_obs[:, 4] >= 0)
    new_last = torch.cat([warp_boxes_xyxy(state.last_obs[:, :4], a_mat, t),
                          state.last_obs[:, 4:5]], dim=-1)
    ring_written = act[:, None] & (state.obs_age >= 0)
    new_ring = warp_boxes_xyxy(state.obs_ring, a_mat, t)

    # momentum is a unit (dy, dx); rotate its (dx, dy) form and renormalize
    v_xy = _apply2(a_mat, state.velocity.flip(-1))
    norm = torch.sqrt((v_xy * v_xy).sum(-1, keepdim=True))
    v_xy = v_xy / torch.clamp(norm, min=1e-6)
    new_vel = v_xy.flip(-1)
    has_vel = act & (torch.sqrt((state.velocity * state.velocity).sum(-1))
                     > 0)

    return state.replace(
        x=torch.where(act[:, None], new_x, state.x),
        p=torch.where(act[:, None, None], new_p, state.p),
        frozen_x=torch.where(froz[:, None], new_fx, state.frozen_x),
        frozen_p=torch.where(froz[:, None, None], new_fp, state.frozen_p),
        last_obs=torch.where(has_obs[:, None], new_last, state.last_obs),
        obs_ring=torch.where(ring_written[..., None], new_ring,
                             state.obs_ring),
        velocity=torch.where(has_vel[:, None], new_vel, state.velocity),
    )
