"""The reference's key-based random draws, bit for bit, in torch ops.

The JAX package draws with ``jax.random`` from threefry2x32 keys: a
key is two uint32 words.  The port's draws take their two words from
the scope's ``torch.Generator`` (`ops.seeds`) and compute from them
what ``jax.random`` computes from the same key, on the key's own
device: `split`, `fold_in`, `random_bits` (32-bit), `uniform`,
`bernoulli` and `normal`, and the pieces of ``randint`` and
``bernoulli`` (`randint_reduce`, `unit_floats`) that
`gluon.data.DeviceAugment` combines.  jax's threefry is the partitionable one
(``jax_threefry_partitionable``, jax's default): element ``i`` of a
draw of ``shape`` hashes the counter pair ``(i div 2^32, i mod 2^32)``
and takes both output words, xor-ed for 32-bit bits.

Words are held as uint32 values in int64 tensors (torch's uint32
coverage is thin), every sum masked back to 32 bits; a key is an int64
tensor whose last axis holds its two words.  Everything but `normal`
is exact integer arithmetic and equals ``jax.random`` bitwise;
`normal` runs XLA's f32 ``erf_inv`` polynomial (Giles), whose
``log1p`` rounds on its own, so it lands within a few f32 ulps.
"""
from __future__ import annotations

import numpy as onp
import torch

__all__ = ["threefry2x32", "key_of", "split", "fold_in", "random_bits",
           "unit_floats", "uniform", "bernoulli", "randint_reduce", "erfinv",
           "normal"]

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl32(x, r):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32 (20 rounds) of the counter pair ``(c0, c1)`` under
    the key ``(k0, k1)``, both output words; int64 tensors holding uint32
    values, broadcasting."""
    k0, k1, c0, c1 = (torch.as_tensor(a, dtype=torch.int64) & M32
                      for a in (k0, k1, c0, c1))
    ks2 = 0x1BD11BDA ^ k0 ^ k1
    x0 = (c0 + k0) & M32
    x1 = (c1 + k1) & M32
    inj = ((k1, ks2), (ks2, k0), (k0, k1), (k1, ks2), (ks2, k0))
    for i, (a, b) in enumerate(inj):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + a) & M32
        x1 = (x1 + b + (i + 1)) & M32
    return x0, x1


def key_of(words):
    """A key from two uint32 words: an int32 (2,) tensor as `ops.seeds`
    hands them out (any device), or two Python ints."""
    return torch.as_tensor(words).to(torch.int64) & M32


def _counters(n, device):
    """(hi, lo) words of the flat indices 0..n-1."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & M32


def split(key, num=2):
    """``jax.random.split(key, num)``: (..., num, 2) keys.  ``key`` may
    carry leading axes (several keys split at once)."""
    hi, lo = _counters(num, key.device)
    b0, b1 = threefry2x32(key[..., :1], key[..., 1:], hi, lo)
    return torch.stack([b0, b1], dim=-1)


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``: the key hashed with the counter
    pair ``(0, data)`` (``data`` a uint32, as jax's ``threefry_seed``
    makes it a key), both output words."""
    b0, b1 = threefry2x32(key[..., 0], key[..., 1], 0, int(data) & M32)
    return torch.stack([b0, b1], dim=-1)


def random_bits(key, n):
    """``jax.random.bits(key, (n,), uint32)`` as int64 values; ``key`` may
    carry leading axes, which lead the result's."""
    hi, lo = _counters(n, key.device)
    b0, b1 = threefry2x32(key[..., :1], key[..., 1:], hi, lo)
    return b0 ^ b1


def unit_floats(bits):
    """Floats in [0, 1) from 32 random bits, as jax's ``uniform`` builds
    them: the top 23 bits as the mantissa of a number in [1, 2), minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key, n, minval=0.0, maxval=1.0):
    """``jax.random.uniform(key, (n,), float32, minval, maxval)``; the
    bounds and their span are rounded to f32 first, as jax does."""
    lo = onp.float32(minval)
    span = onp.float32(maxval) - lo
    return torch.clamp_min(unit_floats(random_bits(key, n)) * float(span)
                           + float(lo), float(lo))


def bernoulli(key, p, shape):
    """``jax.random.bernoulli(key, p, shape)`` for a Python float ``p``
    (rounded to f32, as jax takes it): a bool tensor, True where the f32
    `uniform` draw of the element is below ``p``."""
    n = 1
    for s in shape:
        n *= int(s)
    u = unit_floats(random_bits(key, n))
    return (u < float(onp.float32(p))).reshape(tuple(shape))


def randint_reduce(higher, lower, minval, maxval):
    """The last step of ``jax.random.randint(key, shape, minval, maxval)``
    (int32, Python int bounds): 64 random bits a value (``higher`` and
    ``lower``, the `random_bits` of ``split(key)``'s two keys) reduced
    modulo the span in uint32 arithmetic, with jax's wraps."""
    span = int(maxval) - int(minval)
    if span <= 0:
        return torch.full_like(higher, int(minval))
    mult = (((2 ** 16 % span) ** 2) & M32) % span
    off = (((higher % span) * mult) & M32) + (lower % span)
    return int(minval) + (off & M32) % span


# XLA's f32 erf_inv (M. Giles, "Approximating the erfinv function"): a
# degree-8 polynomial in w = -log1p(-x^2), one for w < 5 and one beyond
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x):
    """f32 ``erf_inv`` as XLA computes it (its ``log1p`` aside)."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = None
    for a, b in zip(_ERFINV_LT5, _ERFINV_GE5):
        c = torch.where(small, a, b)
        p = c if p is None else c + p * w
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       p * x)


_SQRT2 = float(onp.float32(onp.sqrt(2.0)))
_NEXT_ABOVE_MINUS_1 = float(onp.nextafter(onp.float32(-1), onp.float32(0)))


def normal(key, n):
    """``jax.random.normal(key, (n,), float32)``: sqrt(2) erfinv of a
    uniform draw in (-1, 1)."""
    return erfinv(uniform(key, n, _NEXT_ABOVE_MINUS_1, 1.0)) * _SQRT2
