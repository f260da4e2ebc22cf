"""Aperture (bokeh) sample distributions for depth of field.

Re-implements ``Source/Utility/Random.h:266-355``: concentric-disk Sobol
("circular" bokeh) and rejection-sampled N-gon distributions (pentagon,
hexagon, octagon).  Samples are compressed to [0, 1] for storage, exactly as
the reference stores them for its aperture uniform block; the camera maps them
back to [-1, 1] (``Resources/shaders/perspective.rlsl:78-80``).
"""

from __future__ import annotations

import numpy as np

from .qmc import sobol


def radial_sobol(count: int, sequence_index: int) -> np.ndarray:
    """Sobol points warped onto a disk, ``Random.h:268-289``."""
    s = sobol(count, sequence_index)
    sqrt_t = np.sqrt(s[:, 1])
    two_pi_s = np.float32(2.0 * np.pi) * s[:, 0]
    x = sqrt_t * np.cos(two_pi_s)
    y = sqrt_t * np.sin(two_pi_s)
    out = np.empty((count, 2), dtype=np.float32)
    out[:, 0] = (x + 1.0) * 0.5
    out[:, 1] = (y + 1.0) * 0.5
    return out.astype(np.float32)


def random_polygonal(num_edges: int, count: int, seed: int) -> np.ndarray:
    """Uniform samples on a regular N-gon via its triangle fan,
    ``Random.h:293-355``.

    The reference uses mt19937 + rejection sampling for the barycentric
    coordinate; we keep the same distribution (uniform over the polygon) with
    numpy's MT19937 stream.
    """
    step = 2.0 * np.pi / num_edges
    theta = step * np.arange(num_edges)
    ring = np.stack([np.cos(theta), np.sin(theta)], axis=-1)  # (E, 2)
    v0 = np.zeros(2)  # center
    v1 = ring
    v2 = ring[(np.arange(num_edges) + 1) % num_edges]

    rng = np.random.Generator(np.random.MT19937(seed))
    tri = rng.integers(0, num_edges, size=count)
    alpha = rng.random(count)
    beta = rng.random(count)
    # Fold the rejection step into a reflection (same uniform distribution).
    over = alpha + beta > 1.0
    alpha = np.where(over, 1.0 - alpha, alpha)
    beta = np.where(over, 1.0 - beta, beta)
    gamma = 1.0 - alpha - beta
    pts = (
        v0[None, :] * alpha[:, None]
        + v1[tri] * beta[:, None]
        + v2[tri] * gamma[:, None]
    )
    return ((pts + 1.0) * 0.5).astype(np.float32)


BOKEH_SHAPES = {
    "circular": lambda count, seq: radial_sobol(count, seq),
    "pentagon": lambda count, seq: random_polygonal(5, count, seq),
    "hexagon": lambda count, seq: random_polygonal(6, count, seq),
    "octagon": lambda count, seq: random_polygonal(8, count, seq),
}
