"""2-D FIR tests: golden contract + jnp bit-equality + sim-vs-model."""

import numpy as np
import pytest

from warmup_fir_filter_tpu.ops.fir2d import (
    FILTER_BANK_2D,
    fir2d_fixed_golden,
    fir2d_fixed_jnp,
    fir2d_ideal_golden,
    fir2d_ideal_jnp,
)
from warmup_fir_filter_tpu.ops.qformat import QFormat


class TestIdeal2D:
    def test_identity_kernel(self, synthetic_rows):
        h = np.zeros((3, 3))
        h[1, 1] = 1.0
        out = fir2d_ideal_golden(synthetic_rows, h)
        np.testing.assert_array_equal(out, synthetic_rows.astype(np.float64))

    def test_hand_computed_box(self):
        x = np.array([[0, 9], [18, 27]], dtype=np.uint8)
        h = np.full((3, 3), 1.0)
        out = fir2d_ideal_golden(x, h)
        # Every output = sum of all in-window pixels (zero pad outside).
        assert out[0, 0] == 0 + 9 + 18 + 27
        assert out[1, 1] == 54.0

    def test_shift_kernel(self):
        # h[0, 0] = 1 with center (1,1): y[r,c] = x[r+1, c+1].
        x = np.arange(9, dtype=np.uint8).reshape(3, 3)
        h = np.zeros((3, 3))
        h[0, 0] = 1.0
        out = fir2d_ideal_golden(x, h)
        np.testing.assert_array_equal(out[:2, :2], x[1:, 1:].astype(float))
        np.testing.assert_array_equal(out[2, :], [0, 0, 0])


class TestFixed2D:
    def test_identity_bit_exact(self, synthetic_rows):
        h = np.zeros((3, 3))
        h[1, 1] = 1.0
        np.testing.assert_array_equal(
            fir2d_fixed_golden(synthetic_rows, h), synthetic_rows
        )

    @pytest.mark.parametrize("name", sorted(FILTER_BANK_2D))
    def test_jnp_matches_golden(self, rng, name):
        h = FILTER_BANK_2D[name]
        x = rng.integers(0, 256, size=(37, 53), dtype=np.uint8)
        np.testing.assert_array_equal(
            np.asarray(fir2d_fixed_jnp(x, h)), fir2d_fixed_golden(x, h)
        )

    def test_wraparound_acc_bits(self, rng):
        qf = QFormat(acc_bits=20)
        h = np.full((5, 5), 7.5)
        x = rng.integers(0, 256, size=(16, 24), dtype=np.uint8)
        np.testing.assert_array_equal(
            np.asarray(fir2d_fixed_jnp(x, h, qf)),
            fir2d_fixed_golden(x, h, qf),
        )

    def test_wide_acc_rejected_on_tpu_path(self, rng):
        with pytest.raises(ValueError, match="int32 device path"):
            fir2d_fixed_jnp(np.zeros((4, 4), np.uint8), np.ones((3, 3)),
                            QFormat(acc_bits=48))

    def test_even_kernel_center(self, rng):
        # 2x2 kernel, centers (1, 1): y[r,c] = Σ h[kr,kc]·x[r-kr+1, c-kc+1].
        x = rng.integers(0, 256, size=(8, 8), dtype=np.uint8)
        h = np.array([[1.0, 0.0], [0.0, 0.0]])
        out = fir2d_fixed_golden(x, h)
        np.testing.assert_array_equal(out[:7, :7], x[1:, 1:])


class TestSimVsModel2D:
    def test_crosscheck_gauss5_512(self, rng):
        """BASELINE config 3: 5x5 fixed 2D FIR on a 512x512 tile."""
        x = rng.integers(0, 256, size=(512, 512), dtype=np.uint8)
        h = FILTER_BANK_2D["gauss5"]
        sim = np.asarray(fir2d_fixed_jnp(x, h))
        model = fir2d_ideal_golden(x, h)
        diff = sim.astype(np.float64) - model
        rmse = float(np.sqrt(np.mean(diff**2)))
        # Gaussian low-pass: quantization error well below 1 LSB
        # (reference acceptance interpretation, SURVEY.md §4.4).
        assert rmse < 0.5
        # And the device float model tracks the f64 model closely.
        f32 = np.asarray(fir2d_ideal_jnp(x, h), np.float64)
        np.testing.assert_allclose(f32, model, atol=1e-2)


# Cases carried over from the retired 2-D kernel suite: filter bank ×
# image shapes (tile seams, ragged edges, multi-block heights), even and
# tall kernels, wraparound formats, and degenerate filters.

@pytest.mark.parametrize("shape", [(20, 40), (17, 33), (70, 40), (12, 700),
                                   (1, 1), (5, 3)])
@pytest.mark.parametrize("name", ["box3", "gauss5", "laplacian",
                                  "sharpen5"])
def test_jnp_bank_by_shape(rng, name, shape):
    h = FILTER_BANK_2D[name]
    x = rng.integers(0, 256, size=shape, dtype=np.uint8)
    np.testing.assert_array_equal(
        np.asarray(fir2d_fixed_jnp(x, h)), fir2d_fixed_golden(x, h))


@pytest.mark.parametrize("kshape", [(2, 4), (9, 3), (1, 2), (4, 1), (7, 7)])
def test_jnp_even_and_tall_kernels(rng, kshape):
    x = rng.integers(0, 256, size=(17, 33), dtype=np.uint8)
    h = rng.uniform(-0.5, 0.5, kshape)
    np.testing.assert_array_equal(
        np.asarray(fir2d_fixed_jnp(x, h)), fir2d_fixed_golden(x, h))


@pytest.mark.parametrize("acc_bits", [12, 18, 24, 32])
def test_jnp_wraparound_formats(rng, acc_bits):
    qf = QFormat(acc_bits=acc_bits)
    h = rng.uniform(-4, 4, (3, 3))
    x = rng.integers(0, 256, size=(12, 24), dtype=np.uint8)
    np.testing.assert_array_equal(
        np.asarray(fir2d_fixed_jnp(x, h, qf)), fir2d_fixed_golden(x, h, qf))


def test_jnp_all_zero_filter(rng):
    # No taps at all: the output is the pure bias/rounding path.
    x = rng.integers(0, 256, size=(12, 20), dtype=np.uint8)
    h = np.zeros((3, 3))
    np.testing.assert_array_equal(
        np.asarray(fir2d_fixed_jnp(x, h)), fir2d_fixed_golden(x, h))


def test_jnp_cross_filter(rng):
    x = rng.integers(0, 256, size=(16, 24), dtype=np.uint8)
    h = np.zeros((3, 3))
    h[0, 1], h[1, 1], h[2, 1] = 0.25, -0.5, 0.25
    np.testing.assert_array_equal(
        np.asarray(fir2d_fixed_jnp(x, h)), fir2d_fixed_golden(x, h))


def test_jnp_chained_applies_match_repeated_golden(rng):
    h = FILTER_BANK_2D["box3"]
    x = rng.integers(0, 256, size=(20, 260), dtype=np.uint8)
    twice = fir2d_fixed_jnp(fir2d_fixed_jnp(x, h), h)
    np.testing.assert_array_equal(
        np.asarray(twice), fir2d_fixed_golden(fir2d_fixed_golden(x, h), h))


@pytest.mark.parametrize("name", ["gauss5", "sharpen5"])
def test_ideal_jnp_close_to_golden(rng, name):
    h = FILTER_BANK_2D[name]
    x = rng.integers(0, 256, size=(40, 150), dtype=np.uint8)
    np.testing.assert_allclose(
        np.asarray(fir2d_ideal_jnp(x, h), np.float64),
        fir2d_ideal_golden(x, h), atol=1e-3)
