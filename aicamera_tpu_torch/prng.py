"""Counter-based random numbers: ``jax.random``'s threefry2x32, on tensors.

The JAX package draws its synthetic scenes with ``jax.random`` (default
implementation ``threefry2x32``, partitionable mode). The port reproduces
those draws bit for bit, so that the same seed gives the same scene on both
packages: the same Threefry-2x32 hash (Salmon et al., SC 2011: 20 rounds,
key injection every 4), the same counters and the same bit-to-value maps as
``jax/_src/prng.py`` and ``jax/_src/random.py`` of JAX 0.9.

Keys are ``(2,)`` uint32 numpy arrays, the form ``jax.random.key_data``
gives, so that a test can hand one key to both packages. Draws come back as
tensors on the device passed in. The hash works on int64 tensors holding
uint32 values, masked after every add and shift: CUDA's uint32 support in
PyTorch is partial, and integer arithmetic gives equal bits on the CPU and
the GPU.

One rounding differs: where XLA's CPU backend fuses ``uniform``'s
``f * (maxval - minval) + minval`` into a fused multiply-add (it did on
large draws, not on a 7-element one), this module always computes the
fused form: the product and sum in float64, rounded once to float32. The
unfused form gives the same value whenever ``maxval - minval`` is a power of
two, which is every range the scenes draw but the background noise.

``normal`` is ``sqrt(2) * erfinv(u)`` as XLA's CPU backend computes it:
Giles' single-precision polynomial for ``erfinv`` over XLA's ``log1p`` (a
Cephes rational function near 0, else the Cephes ``logf`` polynomial), with
the multiply-adds LLVM fuses computed fused. ``torch.special.erfinv`` rounds
differently (up to 91 ulps off on 2e5 draws).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .device import resolve_device

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off: ``(0, seed)``, the
    seed taken as int32."""
    seed = int(seed)
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit in int32")
    return np.array([0, seed & _MASK], np.uint32)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(key: np.ndarray, x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 hash of the counter pairs ``(x1, x2)`` (int64
    tensors of uint32 values) under ``key``; two such tensors."""
    k1, k2 = (int(k) for k in np.asarray(key, np.uint32))
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x1, x2


def _hash_iota(key, shape, device):
    """Threefry of the row-major element index of ``shape``, split into
    high and low words (JAX's ``iota_2x32_shape``)."""
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(key, i >> 32, i & _MASK)
    return b1.view(shape), b2.view(shape)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split``: ``(num, 2)`` uint32 keys, hashed on the host."""
    b1, b2 = _hash_iota(key, (int(num),), "cpu")
    return torch.stack([b1, b2], 1).numpy().astype(np.uint32)


def random_bits(key: np.ndarray, shape, device=None) -> torch.Tensor:
    """``jax.random.bits`` at 32 bits: an int64 tensor of uint32 values."""
    b1, b2 = _hash_iota(key, tuple(shape), resolve_device(device))
    return b1 ^ b2


def uniform(key: np.ndarray, shape, minval: float = 0.0,
            maxval: float = 1.0, device=None) -> torch.Tensor:
    """``jax.random.uniform`` in float32 on ``[minval, maxval)``, with the
    scaling fused (see the module's docstring)."""
    bits = random_bits(key, shape, device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    out = (f.double() * span + lo).float()
    return torch.clamp_min(out, lo)


def randint(key: np.ndarray, shape, minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """``jax.random.randint`` in int32 on ``[minval, maxval)``: two draws of
    32 bits reduced modulo the span, wrapping at 32 bits as JAX's uint32
    arithmetic does."""
    k1, k2 = split(key)
    higher = random_bits(k1, shape, device)
    lower = random_bits(k2, shape, device)
    span = int(maxval) - int(minval) if maxval > minval else 1
    if not 0 < span <= _MASK:
        raise ValueError(f"randint span {span} is outside uint32")
    mult = (2**16 % span) ** 2 % span
    offset = (((higher % span) * mult) & _MASK) + lower % span
    offset = (offset & _MASK) % span
    return (offset + int(minval)).to(torch.int32)


def bernoulli(key: np.ndarray, p: float, shape, device=None) -> torch.Tensor:
    """``jax.random.bernoulli`` (mode "low"): ``uniform < p`` in float32."""
    u = uniform(key, shape, device=device)
    return u < float(np.float32(p))


def _f32(v: float) -> float:
    return float(np.float32(v))


def _fma(a, b, c):
    """``a * b + c`` rounded once to float32, as a fused multiply-add; each
    operand a float32 tensor or a Python number, which is a float32
    constant, as in JAX."""
    def wide(v):
        return v.double() if isinstance(v, torch.Tensor) else _f32(v)
    return (wide(a) * wide(b) + wide(c)).float()


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    """``coeffs[0] * x**n + ... + coeffs[n]``, one fused multiply-add a
    step; ``coeffs`` are Python floats or tensors broadcasting with ``x``."""
    p = torch.zeros_like(x) + coeffs[0]
    for c in coeffs[1:]:
        p = _fma(p, x, c)
    return p


# Cephes logf: log(m * 2**e) with m in [sqrt(1/2), sqrt(2)), as XLA's CPU
# backend vectorizes it.
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)
_MIN_NORMAL_F32 = float(np.finfo(np.float32).tiny)


def _log(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log`` for x in [0, 1): a normalized mantissa in [0.5,
    1) and an exponent, then the Cephes polynomial."""
    bits = torch.clamp_min(x, _MIN_NORMAL_F32).view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    low = m < _f32(0.707106781186547524)
    t = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    e = e - low.float()
    x2 = t * t
    x3 = x2 * t
    p = _fma(_horner(t, [_f32(c) for c in _LOG_P[:3]]), x3,
             _horner(t, [_f32(c) for c in _LOG_P[3:6]]))
    p = _fma(p, x3, _horner(t, [_f32(c) for c in _LOG_P[6:]]))
    p = _fma(p, x3, _f32(-2.12194440E-4) * e)
    t = _fma(-0.5, x2, t) + p
    t = _fma(_f32(0.693359375), e, t)
    return torch.where(x == 0, torch.full_like(x, -math.inf), t)


_LOG1P_NUM = (2.0039553499201281259E1, 5.7112963590585538103E1,
              6.0949667980987787057E1, 2.9911919328553073277E1,
              6.5787325942061044846E0, 4.9854102823193375972E-1,
              4.5270000862445199635E-5)
_LOG1P_DEN = (6.0118660497603843919E1, 2.1642788614495947685E2,
              3.0909872225312059774E2, 2.2176239823732856465E2,
              8.3047565967967209469E1, 1.5062909083469192198E1, 1.)


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log1p`` for x in (-1, 0]: a Cephes rational
    approximation where ``|x| < sqrt(2) - 1``, else ``log(1 + x)``."""
    x2 = x * x
    small = (_horner(x, [_f32(c) for c in _LOG1P_NUM[::-1]])
             / _horner(x, [_f32(c) for c in _LOG1P_DEN[::-1]]))
    small = x + (-0.5 * x2 + (x * x2) * small)
    return torch.where(x.abs() < _f32(math.sqrt(2.0) - 1.0), small,
                       _log(x + 1.0))


# Giles, "Approximating the erfinv function" (GPU Computing Gems, 2011):
# single-precision coefficients for w < 5 and w >= 5, highest power first.
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` on (-1, 1)."""
    w = -_log1p(x * -x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    coeffs = [torch.where(small, _f32(a), _f32(b))
              for a, b in zip(_ERFINV_SMALL, _ERFINV_LARGE)]
    return _horner(w, coeffs) * x


def normal(key: np.ndarray, shape, device=None) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erfinv(u)`` for ``u``
    uniform on ``[nextafter(-1, 0), 1)``. Bitwise JAX's on all but about one
    draw in 1e5, which is 1-2 ulps off (see the module's docstring)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0, device)
    return _f32(math.sqrt(2.0)) * _erfinv(u)
