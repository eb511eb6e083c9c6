"""jnp (device sim/model path) vs numpy golden oracle cross-checks.

The fixed-point jnp path must be bit-identical to the golden for every
acc_bits ≤ 32 (SURVEY.md §7.3 item 1); the float jnp path must be within
f32 accumulation tolerance of the float64 golden.
"""

import numpy as np
import pytest

from warmup_fir_filter_tpu.models.filters import FILTER_BANKS
from warmup_fir_filter_tpu.models.golden import (
    fir1d_fixed_golden_rows,
    fir1d_ideal_golden_rows,
)
from warmup_fir_filter_tpu.ops.fir1d import (
    fir1d_fixed_rows_jnp,
    fir1d_ideal_rows_jnp,
)
from warmup_fir_filter_tpu.ops.qformat import QFormat


def _random_rows(rng, batch, n):
    return rng.integers(0, 256, size=(batch, n), dtype=np.uint8)


@pytest.mark.parametrize("tap", [3, 5])
@pytest.mark.parametrize("name", ["moving_avg", "simple_lp", "edge", "sharpen"])
def test_fixed_jnp_bit_exact_filter_bank(rng, tap, name):
    h = np.asarray(FILTER_BANKS[tap][name])
    x = _random_rows(rng, 4, 97)
    golden = fir1d_fixed_golden_rows(x, h)
    jnp_out = np.asarray(fir1d_fixed_rows_jnp(x, h))
    np.testing.assert_array_equal(jnp_out, golden)


@pytest.mark.parametrize("acc_bits", [8, 12, 16, 20, 24, 31, 32])
def test_fixed_jnp_bit_exact_wraparound(rng, acc_bits):
    # Max-magnitude coefficients to force accumulator wraparound.
    qf = QFormat(acc_bits=acc_bits)
    h = np.array([qf.max_coeff_real, -8.0, qf.max_coeff_real])
    x = _random_rows(rng, 3, 64)
    golden = fir1d_fixed_golden_rows(x, h, qf)
    jnp_out = np.asarray(fir1d_fixed_rows_jnp(x, h, qf))
    np.testing.assert_array_equal(jnp_out, golden)


@pytest.mark.parametrize("coeff_bits", [8, 16, 32])
def test_fixed_jnp_bit_exact_coeff_widths(rng, coeff_bits):
    qf = QFormat(coeff_bits=coeff_bits, frac_bits=6)
    h = np.array([0.5, -0.25, 0.75, 0.125, -0.5])
    x = _random_rows(rng, 2, 130)
    golden = fir1d_fixed_golden_rows(x, h, qf)
    jnp_out = np.asarray(fir1d_fixed_rows_jnp(x, h, qf))
    np.testing.assert_array_equal(jnp_out, golden)


def test_fixed_jnp_rejects_wide_acc(rng):
    with pytest.raises(ValueError, match="int32 device path"):
        fir1d_fixed_rows_jnp(_random_rows(rng, 1, 8), [0.5],
                             QFormat(acc_bits=48))


@pytest.mark.parametrize("tap", [3, 5])
def test_ideal_jnp_close_to_golden_f64(rng, tap):
    for name, h in FILTER_BANKS[tap].items():
        h = np.asarray(h)
        x = _random_rows(rng, 4, 257)
        golden = fir1d_ideal_golden_rows(x, h)
        jnp_out = np.asarray(fir1d_ideal_rows_jnp(x, h), dtype=np.float64)
        # f32 accumulation over ≤5 taps of |h·x| ≤ 2040: abs tol ~1e-2.
        np.testing.assert_allclose(jnp_out, golden, atol=1e-2, rtol=1e-5)


def test_single_sample_row():
    h = np.array([0.25, 0.5, 0.25])
    x = np.array([[200]], dtype=np.uint8)
    np.testing.assert_array_equal(
        np.asarray(fir1d_fixed_rows_jnp(x, h)),
        fir1d_fixed_golden_rows(x, h),
    )


# Cases carried over from the retired kernel suites (tap ranges, edge
# shapes, wraparound), now against the one device path.  They straddle
# ``TAP_BLOCK``: unrolled below it, blocked ``fori_loop`` above.

@pytest.mark.parametrize("num_taps", [1, 2, 3, 4, 7, 31, 63, 64, 65, 127,
                                      128, 129, 200, 257, 258, 511, 1001,
                                      2048, 4096])
def test_fixed_jnp_bit_exact_tap_counts(rng, num_taps):
    from warmup_fir_filter_tpu.ops.resample import design_lowpass

    h = design_lowpass(num_taps, 0.2) if num_taps > 2 else \
        rng.uniform(-0.5, 0.5, num_taps)
    x = _random_rows(rng, 3, 1500)
    np.testing.assert_array_equal(
        np.asarray(fir1d_fixed_rows_jnp(x, h)),
        fir1d_fixed_golden_rows(x, h))


@pytest.mark.parametrize("num_taps", [5, 63, 65, 257, 1001])
def test_ideal_jnp_long_taps_close_to_golden(rng, num_taps):
    from warmup_fir_filter_tpu.ops.resample import design_lowpass

    h = design_lowpass(num_taps, 0.25)
    x = rng.uniform(-3, 3, size=(2, 2000)).astype(np.float32)
    got = np.asarray(fir1d_ideal_rows_jnp(x, h), np.float64)
    # f32 sum of L terms of |h·x| ≤ 3·Σ|h| (≈ 3.3): ≤ L·2^-24·3.3.
    np.testing.assert_allclose(got, fir1d_ideal_golden_rows(x, h),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize(
    "shape",
    [
        (9, 512),      # batch not a power of two
        (4, 4096),     # wide aligned row
        (5, 129),      # just past a power of two
        (1, 16),       # tiny
        (3, 128 * 7),  # odd multiple
        (1, 1),        # single sample
        (2, 3),        # row shorter than the filter
        (7, 4097),     # ragged wide row
    ],
)
def test_fixed_jnp_alignment_classes(rng, shape):
    h = np.asarray(FILTER_BANKS[5]["edge"])
    x = rng.integers(0, 256, size=shape, dtype=np.uint8)
    np.testing.assert_array_equal(
        np.asarray(fir1d_fixed_rows_jnp(x, h)),
        fir1d_fixed_golden_rows(x, h))


@pytest.mark.parametrize("num_taps", [258, 1001])
def test_fixed_jnp_row_shorter_than_filter(rng, num_taps):
    from warmup_fir_filter_tpu.ops.resample import design_lowpass

    h = design_lowpass(num_taps, 0.3)
    x = _random_rows(rng, 2, 64)
    np.testing.assert_array_equal(
        np.asarray(fir1d_fixed_rows_jnp(x, h)),
        fir1d_fixed_golden_rows(x, h))


@pytest.mark.parametrize("acc_bits", [12, 16, 24, 32])
def test_fixed_jnp_wraparound_long_filter(rng, acc_bits):
    # Large coefficients + narrow accumulator force the wrap path through
    # the blocked loop (270 taps).
    qf = QFormat(acc_bits=acc_bits)
    h = np.array([qf.max_coeff_real, -8.0, 7.5] * 90)
    x = _random_rows(rng, 2, 640)
    np.testing.assert_array_equal(
        np.asarray(fir1d_fixed_rows_jnp(x, h, qf)),
        fir1d_fixed_golden_rows(x, h, qf))


def test_fixed_jnp_single_tap_identity(rng):
    x = _random_rows(rng, 2, 64)
    np.testing.assert_array_equal(
        np.asarray(fir1d_fixed_rows_jnp(x, [1.0])), x)


@pytest.mark.parametrize("num_taps", [3, 64, 65, 300])
def test_shift_mac_matches_numpy_convolution(rng, num_taps):
    """The unrolled and blocked forms of ``shift_mac`` are one same-mode
    correlation: check against ``np.convolve`` in exact int64."""
    import jax.numpy as jnp

    from warmup_fir_filter_tpu.ops.fir1d import pad_rows_same_mode, shift_mac

    h = rng.integers(-1000, 1000, size=num_taps).astype(np.int32)
    x = rng.integers(0, 256, size=(2, 400)).astype(np.int32)
    xp = pad_rows_same_mode(jnp.asarray(x), num_taps)
    got = np.asarray(shift_mac(xp, jnp.asarray(h), num_taps,
                               jnp.zeros(x.shape, jnp.int32)))
    center = num_taps // 2
    for row in range(2):
        full = np.convolve(x[row].astype(np.int64), h.astype(np.int64))
        np.testing.assert_array_equal(got[row], full[center:center + 400])
