"""QMC sampling: Owen-scrambled sequences and bokeh distributions (numpy,
host), the device sample tables, and the on-the-fly Sobol chain."""

from . import bits, bokeh, qmc
from .tables import (
    NUM_RANDOM_SEQUENCES,
    SampleTables,
    build_tables,
    get_aperture_sample,
    get_sequence_value,
    glsl_random,
)

__all__ = [
    "bits",
    "bokeh",
    "qmc",
    "NUM_RANDOM_SEQUENCES",
    "SampleTables",
    "build_tables",
    "get_aperture_sample",
    "get_sequence_value",
    "glsl_random",
]
