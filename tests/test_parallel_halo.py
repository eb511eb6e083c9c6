"""Multi-device halo-exchange tests on the virtual 8-device CPU mesh.

Shard-boundary bit-exactness is the hard part of sequence parallelism
(SURVEY.md §7.3 item 3): off-by-one halos break bit-exactness only at
block edges, so every test compares the full sharded output against the
unsharded golden, elementwise.
"""

import jax
import numpy as np
import pytest

from warmup_fir_filter_tpu.models.filters import FILTER_BANKS
from warmup_fir_filter_tpu.models.golden import fir1d_fixed_golden_rows
from warmup_fir_filter_tpu.ops.qformat import QFormat
from warmup_fir_filter_tpu.parallel import fir1d_fixed_sharded, make_mesh


@pytest.fixture
def devices(require_devices):
    return require_devices(8)


def _random(rng, c, t):
    return rng.integers(0, 256, size=(c, t), dtype=np.uint8)


@pytest.mark.parametrize("tap", [3, 5])
def test_time_sharded_bit_exact(rng, devices, tap):
    mesh = make_mesh({"data": 1, "time": 8}, devices=devices[:8])
    h = np.asarray(FILTER_BANKS[tap]["sharpen"])
    x = _random(rng, 4, 8 * 40)
    out = np.asarray(fir1d_fixed_sharded(x, h, mesh=mesh))
    np.testing.assert_array_equal(out, fir1d_fixed_golden_rows(x, h))


def test_2d_mesh_channels_and_time(rng, devices):
    mesh = make_mesh({"data": 2, "time": 4}, devices=devices[:8])
    h = np.asarray(FILTER_BANKS[5]["edge"])
    x = _random(rng, 6, 4 * 64)
    out = np.asarray(fir1d_fixed_sharded(x, h, mesh=mesh))
    np.testing.assert_array_equal(out, fir1d_fixed_golden_rows(x, h))


def test_even_tap_asymmetric_halo(rng, devices):
    # L=4, center=2: left halo 1, right halo 2 — asymmetric on purpose.
    mesh = make_mesh({"data": 1, "time": 4}, devices=devices[:4])
    h = np.array([0.25, 0.25, 0.25, 0.25])
    x = _random(rng, 3, 4 * 32)
    out = np.asarray(fir1d_fixed_sharded(x, h, mesh=mesh))
    np.testing.assert_array_equal(out, fir1d_fixed_golden_rows(x, h))


def test_single_tap_no_halo(rng, devices):
    mesh = make_mesh({"data": 1, "time": 8}, devices=devices[:8])
    x = _random(rng, 2, 8 * 16)
    out = np.asarray(fir1d_fixed_sharded(x, [1.0], mesh=mesh))
    np.testing.assert_array_equal(out, x)


def test_wraparound_qformat_sharded(rng, devices):
    mesh = make_mesh({"data": 2, "time": 2}, devices=devices[:4])
    qf = QFormat(acc_bits=16)
    h = np.array([7.5, -8.0, 7.5])
    x = _random(rng, 4, 2 * 48)
    out = np.asarray(fir1d_fixed_sharded(x, h, qf, mesh=mesh))
    np.testing.assert_array_equal(out, fir1d_fixed_golden_rows(x, h, qf))


def test_indivisible_shapes_rejected(rng, devices):
    mesh = make_mesh({"data": 1, "time": 8}, devices=devices[:8])
    with pytest.raises(ValueError, match="not divisible"):
        fir1d_fixed_sharded(_random(rng, 2, 100), [0.5], mesh=mesh)


def test_halo_wider_than_shard_rejected_or_exact(rng, devices):
    # Shard width 8 with a 5-tap halo (2+2) still fits; verify exactness
    # at the extreme where halo ≈ half the shard.
    mesh = make_mesh({"data": 1, "time": 8}, devices=devices[:8])
    h = np.asarray(FILTER_BANKS[5]["moving_avg"])
    x = _random(rng, 2, 8 * 8)
    out = np.asarray(fir1d_fixed_sharded(x, h, mesh=mesh))
    np.testing.assert_array_equal(out, fir1d_fixed_golden_rows(x, h))


class Test2DSharded:
    """2-D image sharded rows x cols: corner halos are the hard part."""

    def test_2d_mesh_bit_exact_gauss5(self, rng, devices):
        from warmup_fir_filter_tpu.ops.fir2d import (
            FILTER_BANK_2D,
            fir2d_fixed_golden,
        )
        from warmup_fir_filter_tpu.parallel import fir2d_fixed_sharded

        mesh = make_mesh({"data": 2, "time": 4}, devices=devices[:8])
        h = FILTER_BANK_2D["gauss5"]
        x = rng.integers(0, 256, size=(2 * 24, 4 * 32), dtype=np.uint8)
        out = np.asarray(fir2d_fixed_sharded(x, h, mesh=mesh))
        np.testing.assert_array_equal(out, fir2d_fixed_golden(x, h))

    def test_2d_even_taps_asymmetric_corners(self, rng, devices):
        # (2, 4) kernel: top halo 1 / bottom 0? no — Lr=2, center_r=1:
        # top 0, bottom 1; Lc=4, center_c=2: left 1, right 2. The
        # corners carried by the two-phase exchange are asymmetric in
        # every direction.
        from warmup_fir_filter_tpu.ops.fir2d import fir2d_fixed_golden
        from warmup_fir_filter_tpu.parallel import fir2d_fixed_sharded

        mesh = make_mesh({"data": 4, "time": 2}, devices=devices[:8])
        h = rng.uniform(-0.5, 0.5, (2, 4))
        x = rng.integers(0, 256, size=(4 * 16, 2 * 40), dtype=np.uint8)
        out = np.asarray(fir2d_fixed_sharded(x, h, mesh=mesh))
        np.testing.assert_array_equal(out, fir2d_fixed_golden(x, h))

    def test_2d_shard_smaller_than_halo_rejected_or_exact(self, rng,
                                                          devices):
        # Tall 9-row kernel across 4 row shards of 8 rows each: the halo
        # (8 rows total) spans a full neighbor shard. ppermute only
        # reaches nearest neighbors, so this must either stay bit-exact
        # or be out of contract; it is exact because 8 <= shard rows.
        from warmup_fir_filter_tpu.ops.fir2d import fir2d_fixed_golden
        from warmup_fir_filter_tpu.parallel import fir2d_fixed_sharded

        mesh = make_mesh({"data": 4, "time": 1}, devices=devices[:4])
        h = rng.uniform(-0.5, 0.5, (9, 3))
        x = rng.integers(0, 256, size=(4 * 8, 32), dtype=np.uint8)
        out = np.asarray(fir2d_fixed_sharded(x, h, mesh=mesh))
        np.testing.assert_array_equal(out, fir2d_fixed_golden(x, h))

    def test_2d_not_divisible_raises(self, rng, devices):
        from warmup_fir_filter_tpu.ops.fir2d import FILTER_BANK_2D
        from warmup_fir_filter_tpu.parallel import fir2d_fixed_sharded

        mesh = make_mesh({"data": 2, "time": 4}, devices=devices[:8])
        x = rng.integers(0, 256, size=(31, 4 * 32), dtype=np.uint8)
        with pytest.raises(ValueError, match="not divisible"):
            fir2d_fixed_sharded(x, FILTER_BANK_2D["gauss5"], mesh=mesh)


def test_sharded_output_spans_mesh(rng, require_devices):
    """Each device holds its own time block of the result."""
    devices = require_devices(4)
    mesh = make_mesh({"data": 1, "time": 4}, devices=devices)
    x = rng.integers(0, 256, size=(2, 4 * 64), dtype=np.uint8)
    out = fir1d_fixed_sharded(x, FILTER_BANKS[5]["sharpen"], mesh=mesh)
    assert out.sharding.device_set == set(devices)
    assert {s.data.shape for s in out.addressable_shards} == {(2, 64)}
