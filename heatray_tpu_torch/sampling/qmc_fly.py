"""On-the-fly Owen-scrambled Sobol samples (port of
``heatray_tpu.sampling.qmc_fly``), bit-identical to the host tables.

PyTorch has no uint32 shift or add on every device, and a signed 32-bit
``>>`` is arithmetic, which would silently break the chain.  So every uint32
value here lives in an int64 tensor in [0, 2^32): a logical shift of such a
value is the int64 shift, sums are masked back to 32 bits, and each multiply
by a 32-bit constant is split into 16-bit halves so that no partial product
reaches 2^63.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF

# Superset-XOR (GF(2) zeta transform) steps of the dim-1 generator matrix;
# see heatray_tpu.sampling.qmc_fly._sobol_dim1.
_ZETA_STEPS = [
    (1, 0x55555555),
    (2, 0x33333333),
    (4, 0x0F0F0F0F),
    (8, 0x00FF00FF),
    (16, 0x0000FFFF),
]


def _mul(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32) and a 32-bit constant c."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _shl(x, s: int):
    return (x << s) & _MASK


def _burley_hash(x):
    x = x ^ (x >> 16)
    x = _mul(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def _hash_combine(seed, v: int):
    return seed ^ ((v + _shl(seed, 6) + (seed >> 2)) & _MASK)


def _laine_karras(x, seed):
    x = (x + seed) & _MASK
    x = x ^ _mul(x, 0x6C50B47C)
    x = x ^ _mul(x, 0xB82F1E52)
    x = x ^ _mul(x, 0xC7AFE638)
    x = x ^ _mul(x, 0x8D22F6E6)
    return x


def _reverse_bits(b):
    b = _shl(b, 16) | (b >> 16)
    b = _shl(b & 0x55555555, 1) | ((b & 0xAAAAAAAA) >> 1)
    b = _shl(b & 0x33333333, 2) | ((b & 0xCCCCCCCC) >> 2)
    b = _shl(b & 0x0F0F0F0F, 4) | ((b & 0xF0F0F0F0) >> 4)
    b = _shl(b & 0x00FF00FF, 8) | ((b & 0xFF00FF00) >> 8)
    return b


def _nested_uniform_scramble(x, seed):
    return _reverse_bits(_laine_karras(_reverse_bits(x), seed))


def _to_normalized_float(x):
    """uint32 -> float32 in [0, 1]: the int64 -> float32 conversion rounds
    to nearest even, as the uint32 -> float32 one of the JAX chain does."""
    return x.to(torch.float32) * (2.0 ** -32)


def _to_uint32(f):
    """floor(f * 2^32) with the f == 1 clamp; the f32 product is exact."""
    x = (f * 4294967296.0).to(torch.int64)
    return torch.where(f >= 1.0, torch.full_like(x, _MASK), x)


def _sobol_dim1(idx):
    x = idx
    for s, m in _ZETA_STEPS:
        x = x ^ ((x >> s) & m)
    return _reverse_bits(x)


def sobol_value(sequence_index, sample_index, num_sequences: int, length: int):
    """Owen-scrambled 2D Sobol sample, bit-identical to
    ``tables.get_sequence_value`` on a sobol table.  Integer tensors in,
    float32 ``(u, v)`` out."""
    seq = torch.remainder(sequence_index, num_sequences).to(torch.int64)
    idx = torch.remainder(sample_index, length).to(torch.int64)
    seed = _burley_hash(seq + 1)
    sidx = _nested_uniform_scramble(idx, seed)
    raw0 = _to_normalized_float(_reverse_bits(sidx))
    raw1 = _to_normalized_float(_sobol_dim1(sidx))
    u = _to_normalized_float(
        _nested_uniform_scramble(_to_uint32(raw0), _hash_combine(seed, 0))
    )
    v = _to_normalized_float(
        _nested_uniform_scramble(_to_uint32(raw1), _hash_combine(seed, 1))
    )
    return u, v
