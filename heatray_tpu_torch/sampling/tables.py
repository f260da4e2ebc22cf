"""QMC sample tables and their lookups (port of
``heatray_tpu.sampling.tables``).

The tables are generated on the host in numpy, exactly as the JAX package
generates them, then moved to the device: a ``(num_sequences * length,)``
main table and aperture table per 2D component, plus per-pixel sequence ids
and index offsets.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import bokeh as bokeh_mod
from . import qmc

NUM_RANDOM_SEQUENCES = 16


@dataclasses.dataclass
class SampleTables:
    """Sampling data of one render configuration.  Flat tables, row-major
    entry ``seq * length + index``; per-pixel maps are (H, W) int32."""

    seq_u: torch.Tensor
    seq_v: torch.Tensor
    aperture_u: torch.Tensor
    aperture_v: torch.Tensor
    pixel_sequence_id: torch.Tensor
    pixel_sequence_offset: torch.Tensor
    num_sequences: int = NUM_RANDOM_SEQUENCES
    sequence_length: int = 0


def glsl_random(st: np.ndarray) -> np.ndarray:
    """``fract(sin(dot(st, (12.9898, 78.233))) * 43758.5453123)`` in float32
    (``utility.rlsl:15-18``)."""
    st = np.asarray(st, dtype=np.float32)
    d = (st[..., 0] * np.float32(12.9898) + st[..., 1] * np.float32(78.233)).astype(
        np.float32
    )
    v = (np.sin(d, dtype=np.float32) * np.float32(43758.5453123)).astype(np.float32)
    return (v - np.floor(v)).astype(np.float32)


def build_tables(
    width: int,
    height: int,
    max_passes: int,
    sample_mode: str = "sobol",
    bokeh_shape: str = "circular",
    device=None,
) -> SampleTables:
    """Generate the tables of a render configuration on the host and move
    them to ``device``."""
    gen = qmc.GENERATORS[sample_mode]
    seqs = np.stack([gen(max_passes, i) for i in range(NUM_RANDOM_SEQUENCES)], axis=0)
    bok = bokeh_mod.BOKEH_SHAPES[bokeh_shape]
    aperture = np.stack([bok(max_passes, i) for i in range(NUM_RANDOM_SEQUENCES)], axis=0)

    # Per-pixel sequence id from the pixel centre; row 0 is the image bottom.
    ys, xs = np.meshgrid(
        np.arange(height, dtype=np.float32), np.arange(width, dtype=np.float32),
        indexing="ij",
    )
    st = np.stack(
        [(xs + 0.5) / np.float32(width), (ys + 0.5) / np.float32(height)], axis=-1
    )
    seq_id = np.floor(glsl_random(st) * np.float32(NUM_RANDOM_SEQUENCES)).astype(np.int32)
    seq_id = np.minimum(seq_id, NUM_RANDOM_SEQUENCES - 1)

    # Per-pixel index offset: Sobol sequence 0 over all pixels.
    offsets = qmc.sobol(width * height, 0)[:, 0].reshape(height, width)
    seq_offset = np.floor(offsets * np.float32(max_passes)).astype(np.int32)
    seq_offset = np.minimum(seq_offset, max_passes - 1)

    seqs = seqs.reshape(-1, 2)
    aperture = aperture.reshape(-1, 2)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return SampleTables(
        seq_u=dev(seqs[:, 0]),
        seq_v=dev(seqs[:, 1]),
        aperture_u=dev(aperture[:, 0]),
        aperture_v=dev(aperture[:, 1]),
        pixel_sequence_id=dev(seq_id),
        pixel_sequence_offset=dev(seq_offset),
        num_sequences=NUM_RANDOM_SEQUENCES,
        sequence_length=max_passes,
    )


def get_sequence_value(tables: SampleTables, sequence_index, sample_index):
    """Wrapped 2D sample lookup (``sequence.rlsl:18-28``); integer tensors
    of one shape in, float32 ``(u, v)`` out."""
    length = tables.sequence_length
    seq = torch.remainder(sequence_index, tables.num_sequences)
    idx = torch.remainder(torch.as_tensor(sample_index), length)
    entry = (seq * length + idx).long()
    return tables.seq_u[entry], tables.seq_v[entry]


def get_aperture_sample(tables: SampleTables, sequence_id, sample_index):
    """Aperture table lookup (``perspective.rlsl:78``), sample index
    wrapped."""
    idx = torch.remainder(torch.as_tensor(sample_index), tables.sequence_length)
    entry = (sequence_id * tables.sequence_length + idx).long()
    return tables.aperture_u[entry], tables.aperture_v[entry]
