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
    return u < torch.tensor(float(np.float32(p)), device=u.device)
