"""Owen-scrambled low-discrepancy sequence generators.

Re-implements the generators of the reference renderer's
``Source/Utility/Random.h:110-264`` and ``Source/Utility/BlueNoise.h`` with
numpy (host-side table generation).  The uint32 scramble chain is bit-exact;
float arithmetic follows the same op order in float32 so generated tables
match the reference's sample streams.

Every generator returns a ``(count, 2) float32`` array in [0, 1].
"""

from __future__ import annotations

import numpy as np

from .bits import (
    burley_hash,
    burley_hash_combine,
    fnv1a_u32,
    fnv1a_u64,
    nested_uniform_scramble,
    reverse_bits,
    to_normalized_float,
    to_uint32,
    u32,
)

# The 16 coprime base pairs used for the Halton sequences
# (``Random.h:172-189``; note some entries are not prime and (5, 11) repeats —
# reproduced verbatim for stream parity).
HALTON_BASES = np.array(
    [
        [2, 3], [2, 5], [2, 7], [3, 7],
        [4, 5], [5, 7], [5, 9], [5, 11],
        [6, 11], [5, 11], [8, 11], [3, 5],
        [11, 15], [2, 15], [3, 19], [7, 10],
    ],
    dtype=np.uint32,
)

# Sobol direction numbers for dimension 1 (``Random.h:236-243``); dimension 0's
# directions are simply single bits so dim-0 reduces to bit reversal.
_SOBOL_DIR1 = np.array(
    [
        0x80000000, 0xC0000000, 0xA0000000, 0xF0000000,
        0x88000000, 0xCC000000, 0xAA000000, 0xFF000000,
        0x80800000, 0xC0C00000, 0xA0A00000, 0xF0F00000,
        0x88880000, 0xCCCC0000, 0xAAAA0000, 0xFFFF0000,
        0x80008000, 0xC000C000, 0xA000A000, 0xF000F000,
        0x88008800, 0xCC00CC00, 0xAA00AA00, 0xFF00FF00,
        0x80808080, 0xC0C0C0C0, 0xA0A0A0A0, 0xF0F0F0F0,
        0x88888888, 0xCCCCCCCC, 0xAAAAAAAA, 0xFFFFFFFF,
    ],
    dtype=np.uint32,
)


def owen_scramble_sequence(generator, count: int, sequence_index: int) -> np.ndarray:
    """Wrap a raw generator with Burley's Owen scrambling, ``Random.h:85-108``.

    ``generator(sample_index, array_index)`` receives the scrambled sample
    index and the original array index (both uint32 arrays) and must return an
    ``(n, 2) float32`` array.
    """
    seed = burley_hash(u32(np.uint32(sequence_index) + np.uint32(1)))
    arr_idx = np.arange(count, dtype=np.uint32)
    sample_idx = nested_uniform_scramble(arr_idx, seed)
    sample = np.asarray(generator(sample_idx, arr_idx), dtype=np.float32)
    out = np.empty((count, 2), dtype=np.float32)
    out[:, 0] = to_normalized_float(
        nested_uniform_scramble(to_uint32(sample[:, 0]), burley_hash_combine(seed, 0))
    )
    out[:, 1] = to_normalized_float(
        nested_uniform_scramble(to_uint32(sample[:, 1]), burley_hash_combine(seed, 1))
    )
    return out


def _sobol_dim(sample_index: np.ndarray, dim: int) -> np.ndarray:
    """Raw Sobol value for dimension 0 or 1, ``Random.h:225-253``."""
    idx = u32(sample_index)
    if dim == 0:
        return to_normalized_float(reverse_bits(idx))
    result = np.zeros_like(idx)
    for bit in range(32):
        mask = (idx >> np.uint32(bit)) & np.uint32(1)
        result ^= mask * _SOBOL_DIR1[bit]
    return to_normalized_float(result)


def sobol(count: int, sequence_index: int) -> np.ndarray:
    """Owen-scrambled 2D Sobol sequence, ``Random.h:221-264``."""

    def gen(sample_idx, _arr_idx):
        out = np.empty((len(sample_idx), 2), dtype=np.float32)
        out[:, 0] = _sobol_dim(sample_idx, 0)
        out[:, 1] = _sobol_dim(sample_idx, 1)
        return out

    return owen_scramble_sequence(gen, count, sequence_index)


def _radical_inverse_vdc(bits: np.ndarray) -> np.ndarray:
    """Base-2 radical inverse (bit reversal), ``Random.h:137-142``."""
    return (reverse_bits(u32(bits)).astype(np.float32) * np.float32(2.3283064365386963e-10)).astype(np.float32)


def hammersley(count: int, sequence_index: int) -> np.ndarray:
    """Owen-scrambled Hammersley set, ``Random.h:134-154``."""
    divisor = np.float32(1.0) / np.float32(count)

    def gen(sample_idx, arr_idx):
        out = np.empty((len(sample_idx), 2), dtype=np.float32)
        out[:, 0] = (arr_idx.astype(np.float32) * divisor).astype(np.float32)
        out[:, 1] = _radical_inverse_vdc(sample_idx)
        return out

    return owen_scramble_sequence(gen, count, sequence_index)


def _halton_value(index: np.ndarray, base: int) -> np.ndarray:
    """Vectorized radical inverse in an arbitrary base, ``Random.h:192-204``.

    Accumulates in float32 with the same op order as the reference's scalar
    loop.  A uint32 index has at most 32 digits in any base >= 2.
    """
    n = u32(index).copy()
    f = np.ones(n.shape, dtype=np.float32)
    result = np.zeros(n.shape, dtype=np.float32)
    denom = np.float32(base)
    b = np.uint32(base)
    for _ in range(32):
        active = n > 0
        if not active.any():
            break
        f_next = (f / denom).astype(np.float32)
        f = np.where(active, f_next, f)
        digit = (n % b).astype(np.float32)
        result = np.where(
            active, (result + (f * digit).astype(np.float32)).astype(np.float32), result
        )
        n = n // b
    return result


def halton(count: int, sequence_index: int) -> np.ndarray:
    """Owen-scrambled Halton sequence, ``Random.h:169-217``."""
    base_x, base_y = HALTON_BASES[sequence_index % len(HALTON_BASES)]

    def gen(sample_idx, _arr_idx):
        out = np.empty((len(sample_idx), 2), dtype=np.float32)
        out[:, 0] = _halton_value(sample_idx, int(base_x))
        out[:, 1] = _halton_value(sample_idx, int(base_y))
        return out

    return owen_scramble_sequence(gen, count, sequence_index)


def uniform_random(count: int, sequence_index: int) -> np.ndarray:
    """Mersenne-Twister uniform floats, ``Random.h:113-130``.

    The reference's ``std::uniform_real_distribution`` is not bit-reproducible
    across standard libraries, so this uses numpy's MT19937 stream seeded the
    same way (by sequence index).
    """
    rng = np.random.Generator(np.random.MT19937(sequence_index))
    return rng.random((count, 2), dtype=np.float32)


def blue_noise(count: int, sequence_index: int) -> np.ndarray:
    """Mitchell's best-candidate blue noise, ``Source/Utility/BlueNoise.h:52-102``.

    30 candidates per point; each new point is the candidate farthest from the
    existing set.  The FNV1a-chain RNG matches the reference
    (``BlueNoise.h:97-100``).
    """
    # C++: ``int seed = int(FNV1a(seedParam))`` — truncate the 64-bit hash to a
    # signed 32-bit int.
    seed = int(np.int32(np.uint32(fnv1a_u32(sequence_index) & 0xFFFFFFFF)))

    def rand(s: int) -> float:
        return np.float32(
            np.float64(fnv1a_u64(fnv1a_u32(s))) / np.float64(2.0**64)
        )

    points = np.empty((count, 2), dtype=np.float32)
    points[0, 0] = rand(seed)
    points[0, 1] = rand(seed + 1)
    seed += 2
    for i in range(1, count):
        cands = np.empty((30, 2), dtype=np.float32)
        for c in range(30):
            cands[c, 0] = rand(seed)
            cands[c, 1] = rand(seed + 1)
            seed += 2
        # Distance from each candidate to its nearest existing point.
        d = np.linalg.norm(cands[:, None, :] - points[None, :i, :], axis=-1)
        nearest = d.min(axis=1)
        points[i] = cands[int(nearest.argmax())]
    return points


GENERATORS = {
    "random": uniform_random,
    "halton": halton,
    "hammersley": hammersley,
    "bluenoise": blue_noise,
    "sobol": sobol,
}
