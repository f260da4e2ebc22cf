"""QMC sequence visualization (port of ``heatray_tpu.sampling.visualize``).

The original renderer scatter-plots any sequence/prefix in an ImGui window
(``HeatrayRenderer.cpp:455-498``, UI at ``:1566-1594``); the headless
equivalent generates the same point sets and rasterizes them to an image the
CLI writes as a PNG (``heatray_tpu sequence-vis``).
"""

from __future__ import annotations

import numpy as np

from . import bokeh as bokeh_mod
from . import qmc


def sequence_points(
    sample_mode: str = "sobol",
    bokeh_shape: str = "circular",
    sequence_index: int = 0,
    count: int = 64,
    aperture: bool = False,
) -> np.ndarray:
    """(count, 2) float32 points of the requested sequence prefix.

    ``aperture=False`` draws the main pixel-jitter sequence in [0, 1)^2;
    ``aperture=True`` draws the bokeh aperture distribution in [-1, 1]^2
    (``HeatrayRenderer::generateSequenceVisualizationData``,
    ``HeatrayRenderer.cpp:455-498``).
    """
    if aperture:
        gen = bokeh_mod.BOKEH_SHAPES[bokeh_shape]
        return np.asarray(gen(count, sequence_index), np.float32)
    gen = qmc.GENERATORS[sample_mode]
    return np.asarray(gen(count, sequence_index), np.float32)


def scatter_image(
    points: np.ndarray,
    size: int = 256,
    aperture: bool = False,
    dot: int = 1,
) -> np.ndarray:
    """Rasterize (N, 2) points to an (size, size, 3) float image in [0, 1].

    Points render white on black; ``aperture`` rescales [-1, 1] -> [0, 1].
    ``dot`` is the splat radius in pixels.
    """
    pts = np.asarray(points, np.float64)
    if aperture:
        pts = pts * 0.5 + 0.5
    img = np.zeros((size, size, 3), np.float32)
    xy = np.clip((pts * size).astype(np.int64), 0, size - 1)
    for dy in range(-dot, dot + 1):
        for dx in range(-dot, dot + 1):
            x = np.clip(xy[:, 0] + dx, 0, size - 1)
            # Image row 0 is the top; sequence v grows upward.
            y = np.clip(size - 1 - (xy[:, 1] + dy), 0, size - 1)
            img[y, x, :] = 1.0
    return img
