"""Polyphase resampler tests: brute-force oracle + bit-exactness."""

import numpy as np
import pytest

from warmup_fir_filter_tpu.models.golden import fir1d_ideal_golden_rows
from warmup_fir_filter_tpu.ops.qformat import QFormat
from warmup_fir_filter_tpu.ops.resample import (
    design_lowpass,
    resample_poly,
    resample_poly_fixed,
    resample_poly_fixed_golden,
    resample_poly_golden,
)


def brute_force_resample(x64: np.ndarray, h: np.ndarray, up: int,
                         down: int) -> np.ndarray:
    """Oracle: materialize the zero-stuffed upsample, same-mode FIR,
    then decimate — definitionally what polyphase must equal."""
    channels, n = x64.shape
    xu = np.zeros((channels, n * up))
    xu[:, ::up] = x64
    center = len(h) // 2
    left, right = len(h) - 1 - center, center
    xp = np.pad(xu, ((0, 0), (left, right)))
    z = np.zeros_like(xu)
    for k in range(len(h)):
        start = len(h) - 1 - k
        z += h[k] * xp[:, start : start + n * up]
    m = np.arange(-(-n * up // down))
    return z[:, m * down]


class TestFloatPolyphase:
    @pytest.mark.parametrize("up,down", [(2, 3), (3, 2), (1, 4), (5, 1),
                                         (4, 7)])
    def test_matches_brute_force(self, rng, up, down):
        x = rng.normal(size=(3, 97))
        h = design_lowpass(24, 0.4 / max(up, down), gain=up)
        expected = brute_force_resample(x, h, up, down)
        got = resample_poly_golden(x, h, up, down)
        np.testing.assert_allclose(got, expected, atol=1e-12)

    def test_jnp_matches_golden(self, rng):
        x = rng.normal(size=(2, 150))
        h = design_lowpass(33, 0.3, gain=2)
        np.testing.assert_allclose(
            np.asarray(resample_poly(x, h, 2, 3), np.float64),
            resample_poly_golden(x, h, 2, 3),
            atol=1e-4,
        )

    def test_identity_resample(self, rng):
        # up=down=1 with an impulse filter = same-mode FIR identity.
        x = rng.integers(0, 256, size=(2, 64)).astype(np.float64)
        h = np.zeros(5)
        h[2] = 1.0
        out = resample_poly_golden(x, h, 1, 1)
        np.testing.assert_allclose(out, fir1d_ideal_golden_rows(
            x.astype(np.uint8), h))

    def test_tone_preserved_2_3(self, rng):
        # A low tone must survive a 2/3 resample with correct frequency.
        t = np.arange(3000)
        freq = 0.02  # cycles/sample, far below cutoff
        x = np.cos(2 * np.pi * freq * t)[None, :]
        h = design_lowpass(63, 0.45, gain=2)
        y = resample_poly_golden(x, h, 2, 3)
        # New rate = 2/3 original → tone at freq·3/2 cycles/sample.
        spectrum = np.abs(np.fft.rfft(y[0, 200:-200]))
        peak = np.argmax(spectrum)
        expected_bin = freq * 1.5 * (y.shape[1] - 400)
        assert abs(peak - expected_bin) <= 1

    def test_coprime_required(self):
        with pytest.raises(ValueError, match="coprime"):
            resample_poly_golden(np.zeros((1, 10)), np.ones(5), 2, 4)


class TestFixedPolyphase:
    def test_jnp_bit_exact_vs_golden(self, rng):
        x = rng.integers(0, 256, size=(3, 120), dtype=np.uint8)
        h = design_lowpass(21, 0.3, gain=2)
        got = np.asarray(resample_poly_fixed(x, h, 2, 3))
        expected = resample_poly_fixed_golden(x, h, 2, 3)
        np.testing.assert_array_equal(got, expected)

    def test_wraparound_format(self, rng):
        qf = QFormat(acc_bits=18, frac_bits=8)
        x = rng.integers(0, 256, size=(2, 90), dtype=np.uint8)
        h = design_lowpass(15, 0.4, gain=3) * 2.0
        got = np.asarray(resample_poly_fixed(x, h, 3, 2, qf))
        expected = resample_poly_fixed_golden(x, h, 3, 2, qf)
        np.testing.assert_array_equal(got, expected)

    def test_output_length_contract(self, rng):
        x = rng.integers(0, 256, size=(1, 100), dtype=np.uint8)
        h = design_lowpass(15, 0.3, gain=2)
        assert resample_poly_fixed_golden(x, h, 2, 3).shape == (1, 67)
        assert resample_poly_fixed_golden(x, h, 3, 2).shape == (1, 150)


# Cases carried over from the retired resampler kernel suite, now against
# the phase-split slice path: ratios, long rows, long branch filters.

@pytest.mark.parametrize("up,down", [(2, 3), (1, 2), (4, 3), (8, 5),
                                     (3, 2), (5, 4)])
def test_resample_matches_golden_ratios(rng, up, down):
    h = design_lowpass(63, 0.8 / max(up, down), gain=up)
    x = rng.integers(0, 256, size=(3, 2000)).astype(np.float32)
    got = np.asarray(resample_poly(x, h, up, down), np.float64)
    gold = resample_poly_golden(x, h, up, down)
    assert got.shape == gold.shape
    # f32 sums of ≤ 32 branch taps on u8-scale data.
    np.testing.assert_allclose(got, gold, rtol=1e-5, atol=2e-3)


@pytest.mark.parametrize("time_len", [3000, 60_000])
def test_resample_long_rows(rng, time_len):
    h = design_lowpass(63, 0.3, gain=2)
    x = rng.integers(0, 256, size=(3, time_len)).astype(np.float32)
    got = np.asarray(resample_poly(x, h, 2, 3), np.float64)
    np.testing.assert_allclose(got, resample_poly_golden(x, h, 2, 3),
                               rtol=1e-5, atol=2e-3)


def test_resample_long_branch_filter(rng):
    # 1025 taps → 513 taps per polyphase branch.
    h = design_lowpass(1025, 0.2, gain=2)
    x = rng.integers(0, 256, size=(2, 3000)).astype(np.float32)
    got = np.asarray(resample_poly(x, h, 2, 3), np.float64)
    np.testing.assert_allclose(got, resample_poly_golden(x, h, 2, 3),
                               rtol=1e-4, atol=2e-2)


@pytest.mark.parametrize("up,down", [(2, 3), (1, 2), (4, 3), (3, 2)])
def test_resample_fixed_bit_exact_ratios(rng, up, down):
    h = design_lowpass(31, 0.8 / max(up, down), gain=up)
    x = rng.integers(0, 256, size=(2, 777), dtype=np.uint8)
    np.testing.assert_array_equal(
        np.asarray(resample_poly_fixed(x, h, up, down)),
        resample_poly_fixed_golden(x, h, up, down))
