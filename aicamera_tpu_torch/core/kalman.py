"""Batched constant-velocity Kalman filter for bounding-box tracking.

The port of ``aicamera_tpu/core/kalman.py``. State is 8-dimensional
``(cx, cy, a, h, v_cx, v_cy, v_a, v_h)``; every function works on a whole
bank of tracks, ``(T, 8)`` means and ``(T, 8, 8)`` covariances. The 4x4
Cholesky factor and its triangular solves are the JAX package's closed-form
recurrences, written out the same way (not ``torch.linalg.cholesky``), so the
gating distances follow the same arithmetic. Matrix products are full f32.
"""

from __future__ import annotations

import torch

# Chi-squared inverse CDF at 0.95 for N degrees of freedom (gating threshold).
CHI2INV95 = {
    1: 3.841458820694124,
    2: 5.991464547107979,
    3: 7.814727903251179,
    4: 9.487729036781154,
    5: 11.070497693516351,
    6: 12.591587243743977,
    7: 14.067140449349192,
    8: 15.50731305586545,
    9: 16.918977604620448,
}

_STD_WEIGHT_POSITION = 1.0 / 20
_STD_WEIGHT_VELOCITY = 1.0 / 160

_NDIM = 4


def _motion_mat(device, dt: float = 1.0) -> torch.Tensor:
    """State transition matrix F (8x8): x' = x + dt * v."""
    f = torch.eye(2 * _NDIM, dtype=torch.float32, device=device)
    # a fill on the device (an indexed store of a Python number copies it
    # from the host, which a CUDA graph cannot capture)
    f.diagonal(_NDIM).fill_(dt)
    return f


def initiate(measurement_xyah: torch.Tensor):
    """Create state (mean ``(..., 8)``, cov ``(..., 8, 8)``) from
    ``(..., 4)`` measurements in (cx, cy, a, h)."""
    m = measurement_xyah.float()
    mean = torch.cat([m, torch.zeros_like(m)], dim=-1)
    h = m[..., 3]
    wp, wv = _STD_WEIGHT_POSITION, _STD_WEIGHT_VELOCITY
    std = torch.stack([
        2 * wp * h, 2 * wp * h, torch.full_like(h, 1e-2), 2 * wp * h,
        10 * wv * h, 10 * wv * h, torch.full_like(h, 1e-5), 10 * wv * h,
    ], dim=-1)
    return mean, torch.diag_embed(torch.square(std))


def predict(mean: torch.Tensor, cov: torch.Tensor):
    """KF prediction step for a bank of tracks (``(..., 8)``,
    ``(..., 8, 8)``)."""
    f = _motion_mat(mean.device)
    h = mean[..., 3]
    wp, wv = _STD_WEIGHT_POSITION, _STD_WEIGHT_VELOCITY
    std = torch.stack([
        wp * h, wp * h, torch.full_like(h, 1e-2), wp * h,
        wv * h, wv * h, torch.full_like(h, 1e-5), wv * h,
    ], dim=-1)
    motion_cov = torch.diag_embed(torch.square(std))
    new_mean = torch.matmul(mean, f.T)
    new_cov = torch.matmul(torch.matmul(f, cov), f.T) + motion_cov
    return new_mean, new_cov


def project(mean: torch.Tensor, cov: torch.Tensor, confidence=None):
    """Project state to measurement space: ``(Hx (..., 4), S (..., 4, 4))``.

    ``confidence`` (optional ``(...)``) scales the measurement stds by
    ``1 - confidence`` (noise-scale-adaptive update); ``None`` keeps the
    fixed noise model.
    """
    h = mean[..., 3]
    wp = _STD_WEIGHT_POSITION
    std = torch.stack([wp * h, wp * h, torch.full_like(h, 1e-1), wp * h],
                      dim=-1)
    if confidence is not None:
        scale = torch.clamp(1.0 - confidence.float(), 0.0, 1.0)
        std = std * scale[..., None]
    innovation_cov = torch.diag_embed(torch.square(std))
    # H selects the first four state dims, so H x and H P H^T are slices.
    return (mean[..., :_NDIM].clone(),
            cov[..., :_NDIM, :_NDIM] + innovation_cov)


def _chol_small(s, d: int):
    """Closed-form lower Cholesky of tiny ``(..., d, d)`` SPD matrices, as a
    list of lists of ``(...)`` tensors (``l[i][j]``, j <= i). Non-PD input
    gives NaN, which callers map to +inf."""
    l = [[None] * d for _ in range(d)]
    for i in range(d):
        for j in range(i + 1):
            acc = s[..., i, j]
            for k in range(j):
                acc = acc - l[i][k] * l[j][k]
            l[i][j] = torch.sqrt(acc) if i == j else acc / l[j][j]
    return l


def _solve_lower(l, b, d: int):
    """Forward substitution: solve L y = b for ``b (..., d, M)``; returns d
    rows of ``(..., M)``."""
    ys = []
    for i in range(d):
        acc = b[..., i, :]
        for k in range(i):
            acc = acc - l[i][k][..., None] * ys[k]
        ys.append(acc / l[i][i][..., None])
    return ys


def _solve_upper_t(l, ys, d: int):
    """Back substitution: solve L^T x = y; returns ``(..., d, M)``."""
    xs = [None] * d
    for i in reversed(range(d)):
        acc = ys[i]
        for k in range(i + 1, d):
            acc = acc - l[k][i][..., None] * xs[k]
        xs[i] = acc / l[i][i][..., None]
    return torch.stack(xs, dim=-2)


def _cho_solve_small(s, b, d: int):
    """Solve S x = b for tiny SPD ``(..., d, d)`` S and ``(..., d, M)`` b."""
    l = _chol_small(s, d)
    return _solve_upper_t(l, _solve_lower(l, b, d), d)


def update(mean: torch.Tensor, cov: torch.Tensor,
           measurement_xyah: torch.Tensor,
           confidence: torch.Tensor | None = None):
    """KF correction step over a bank of tracks: ``mean (T, 8)``, ``cov
    (T, 8, 8)``, ``measurement_xyah (T, 4)``, optional ``confidence (T,)``."""
    meas = measurement_xyah.float()
    proj_mean, s = project(mean, cov, confidence)
    ph_t = cov[..., :, :_NDIM]                        # P H^T, (T, 8, 4)
    gain = _cho_solve_small(s, ph_t.transpose(-1, -2), _NDIM)
    gain = gain.transpose(-1, -2)                     # (T, 8, 4)
    innovation = meas - proj_mean
    new_mean = mean + torch.matmul(gain, innovation[..., None])[..., 0]
    new_cov = cov - torch.matmul(torch.matmul(gain, s),
                                 gain.transpose(-1, -2))
    return new_mean, new_cov


def gating_distance(mean: torch.Tensor, cov: torch.Tensor,
                    measurements_xyah: torch.Tensor,
                    only_position: bool = False) -> torch.Tensor:
    """Squared Mahalanobis distance ``(T, N)`` from each track to each
    measurement; +inf where the projected covariance is not PD."""
    proj_mean, proj_cov = project(mean, cov)
    d = 2 if only_position else 4
    proj_mean = proj_mean[..., :d]
    proj_cov = proj_cov[..., :d, :d]
    meas = measurements_xyah.float()[..., :d]
    l = _chol_small(proj_cov, d)                                # (T,) each
    delta = meas[None, :, :] - proj_mean[:, None, :]            # (T, N, d)
    z = _solve_lower(l, delta.transpose(-1, -2), d)             # d x (T, N)
    dist = sum(zi * zi for zi in z)
    return torch.where(torch.isnan(dist),
                       torch.full_like(dist, float("inf")), dist)
