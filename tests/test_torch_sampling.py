"""The port's sampling chain against the JAX package: the on-the-fly Sobol
chain bit for bit, and the host tables and their lookups exactly."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatray_tpu.sampling import qmc_fly as jax_fly
from heatray_tpu.sampling import tables as jax_tables
from heatray_tpu_torch.bridge import tables_from_arrays
from heatray_tpu_torch.sampling import qmc_fly, tables
from heatray_tpu_torch.utils.threads import share_cores

share_cores(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))


def _grid(seed=0):
    """4096 (sequence, sample) index pairs: a 64 x 64 grid whose sample
    indices straddle 2^16, plus random large ones."""
    rng = np.random.default_rng(seed)
    seq = np.repeat(np.arange(64, dtype=np.int32), 64) * 37
    smp = np.tile(np.arange(65536 - 32, 65536 + 32, dtype=np.int32), 64)
    smp[::2] = rng.integers(0, 2**31 - 1, smp[::2].shape, dtype=np.int32)
    return seq, smp


@pytest.mark.parametrize("length", [4, 64, 2**20, 2**31 - 1])
def test_sobol_value_bit_exact(length):
    seq, smp = _grid()
    ju, jv = jax_fly.sobol_value(jnp.asarray(seq), jnp.asarray(smp), 16, length)
    u, v = qmc_fly.sobol_value(torch.from_numpy(seq), torch.from_numpy(smp), 16, length)
    assert u.dtype == torch.float32 and v.dtype == torch.float32
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def _both_tables(width, height, passes, bokeh):
    ours = tables.build_tables(width, height, passes, bokeh_shape=bokeh)
    ref = jax_tables.build_tables(width, height, passes, bokeh_shape=bokeh)
    return ours, ref


@pytest.mark.parametrize("bokeh", ["circular", "hexagon"])
def test_build_tables_equal(bokeh):
    ours, ref = _both_tables(24, 16, 8, bokeh)
    for f in dataclasses.fields(ref):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if isinstance(a, torch.Tensor):
            assert a.numpy().dtype == np.asarray(b).dtype, f.name
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f.name)
        else:
            assert a == b, f.name


def test_lookups_equal():
    ours, ref = _both_tables(24, 16, 8, "circular")
    rng = np.random.default_rng(3)
    seq = rng.integers(0, 100, 2048).astype(np.int32)
    idx = rng.integers(0, 1000, 2048).astype(np.int32)
    ju, jv = jax_tables.get_sequence_value(ref, jnp.asarray(seq), jnp.asarray(idx))
    u, v = tables.get_sequence_value(ours, torch.from_numpy(seq), torch.from_numpy(idx))
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))

    pix_seq = rng.integers(0, 16, 2048).astype(np.int32)
    for sample_index in (0, 5, 13):
        ja, jb = jax_tables.get_aperture_sample(ref, jnp.asarray(pix_seq), sample_index)
        a, b = tables.get_aperture_sample(ours, torch.from_numpy(pix_seq), sample_index)
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


def test_sobol_value_matches_table():
    """The recomputed chain equals the lookup into the port's own table."""
    ours = tables.build_tables(8, 8, 16)
    seq, smp = _grid(1)
    u, v = qmc_fly.sobol_value(torch.from_numpy(seq), torch.from_numpy(smp), 16, 16)
    tu, tv = tables.get_sequence_value(ours, torch.from_numpy(seq), torch.from_numpy(smp))
    assert torch.equal(u, tu) and torch.equal(v, tv)


def test_bridged_tables_equal():
    ours, ref = _both_tables(24, 16, 8, "circular")
    arrays = {f.name: np.asarray(getattr(ref, f.name)) for f in dataclasses.fields(ref)}
    bridged = tables_from_arrays(arrays, ref.num_sequences, ref.sequence_length, device="cpu")
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(bridged, f.name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f.name
