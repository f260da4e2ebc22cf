"""Low-level uint32 hashing / scrambling primitives for QMC sampling.

Re-implements (bit-exactly, on numpy uint32 arrays) the scramble chain of the
reference renderer's ``Source/Utility/Random.h:36-108``:
Burley hash, Laine-Karras permutation, bit reversal, and the nested uniform
(Owen) scramble from Burley's "Practical Hash-based Owen Scrambling"
(JCGT 2020).

All functions are vectorized over numpy uint32 arrays and wrap mod 2^32
exactly like C++ unsigned arithmetic.
"""

from __future__ import annotations

import functools

import numpy as np

_U32 = np.uint32


def _wrapping(fn):
    """uint32 arithmetic here wraps mod 2^32 by design (C++ unsigned
    semantics); silence numpy's overflow warnings inside these functions."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with np.errstate(over="ignore"):
            return fn(*args, **kwargs)

    return wrapped


def u32(x) -> np.ndarray:
    """Cast to a numpy uint32 array (values wrap mod 2^32)."""
    return np.asarray(x).astype(np.uint64).astype(np.uint32)


def to_uint32(f: np.ndarray) -> np.ndarray:
    """float in [0, 1) -> uint32, matching ``Random.h:26`` semantics.

    The C++ code computes ``uint32_t(f * float(0xffffffff))`` where
    ``float(0xffffffff)`` rounds to exactly 2^32, so the product is an exact
    exponent shift and the conversion truncates.  We clamp the (measure-zero)
    f == 1.0 case to 0xffffffff instead of C++ UB.
    """
    p = np.floor(np.asarray(f, dtype=np.float64) * float(2**32))
    return np.clip(p, 0, float(2**32 - 1)).astype(np.uint64).astype(np.uint32)


def to_normalized_float(x: np.ndarray) -> np.ndarray:
    """uint32 -> float32 in [0, 1], matching ``Random.h:31``.

    ``float(u) * (1.0f / float(0xffffffff))`` where the reciprocal rounds to
    exactly 2^-32 in float32.
    """
    return (np.asarray(x).astype(np.float32) * np.float32(2.0**-32)).astype(
        np.float32
    )


@_wrapping
def burley_hash(x: np.ndarray) -> np.ndarray:
    """``Random.h:36-45`` (finalizer from MurmurHash3)."""
    x = u32(x)
    x = x ^ (x >> _U32(16))
    x = x * _U32(0x85EBCA6B)
    x = x ^ (x >> _U32(13))
    x = x * _U32(0xC2B2AE35)
    x = x ^ (x >> _U32(16))
    return x


@_wrapping
def burley_hash_combine(seed: np.ndarray, v) -> np.ndarray:
    """``Random.h:47-50``."""
    seed = u32(seed)
    v = u32(v)
    return seed ^ (v + (seed << _U32(6)) + (seed >> _U32(2)))


@_wrapping
def laine_karras_permutation(x: np.ndarray, seed: np.ndarray) -> np.ndarray:
    """``Random.h:52-60``."""
    x = u32(x) + u32(seed)
    x = x ^ (x * _U32(0x6C50B47C))
    x = x ^ (x * _U32(0xB82F1E52))
    x = x ^ (x * _U32(0xC7AFE638))
    x = x ^ (x * _U32(0x8D22F6E6))
    return x


@_wrapping
def reverse_bits(bits: np.ndarray) -> np.ndarray:
    """``Random.h:62-70``."""
    b = u32(bits)
    b = (b << _U32(16)) | (b >> _U32(16))
    b = ((b & _U32(0x55555555)) << _U32(1)) | ((b & _U32(0xAAAAAAAA)) >> _U32(1))
    b = ((b & _U32(0x33333333)) << _U32(2)) | ((b & _U32(0xCCCCCCCC)) >> _U32(2))
    b = ((b & _U32(0x0F0F0F0F)) << _U32(4)) | ((b & _U32(0xF0F0F0F0)) >> _U32(4))
    b = ((b & _U32(0x00FF00FF)) << _U32(8)) | ((b & _U32(0xFF00FF00)) >> _U32(8))
    return b


def nested_uniform_scramble(x: np.ndarray, seed: np.ndarray) -> np.ndarray:
    """Owen scramble via bit-reversed Laine-Karras hash, ``Random.h:72-78``."""
    x = reverse_bits(x)
    x = laine_karras_permutation(x, seed)
    x = reverse_bits(x)
    return x


def fnv1a_bytes(data: bytes) -> int:
    """64-bit FNV-1a over raw bytes, ``Source/Utility/Hash.h:17-30``.

    Note the reference iterates over *signed* chars, so bytes >= 0x80 are
    sign-extended before the XOR; we replicate that quirk.
    """
    h = 0xCBF29CE484222325
    for byte in data:
        c = byte - 256 if byte >= 128 else byte  # signed char sign-extension
        h ^= c & 0xFFFFFFFFFFFFFFFF
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def fnv1a_u32(value: int) -> int:
    """FNV-1a of a 4-byte little-endian integer (C++ ``FNV1a(T const&)``)."""
    return fnv1a_bytes(int(value & 0xFFFFFFFF).to_bytes(4, "little"))


def fnv1a_u64(value: int) -> int:
    """FNV-1a of an 8-byte little-endian integer."""
    return fnv1a_bytes(int(value & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little"))
