"""Fixed-point golden model contract tests.

Re-derives the reference's fixed-model test contract
(``fir_1d/sim/tests/test_1d_fixed.py``, 20 tests — SURVEY.md §4.1),
including the Q4.12 bit-exact oracle, saturation, Q-range boundaries, and
bit-parameter validation.
"""

import numpy as np
import pytest

from warmup_fir_filter_tpu.models import fir_1d_fixed_golden
from warmup_fir_filter_tpu.ops.qformat import QFormat

# Largest real value representable in Q4.12 with 16-bit coeffs:
# (2^15 - 1) / 2^12.
Q412_MAX_REAL = 32767 / 4096  # 7.999755859375


class TestFixedBitExactOracle:
    def test_q412_hand_oracle(self):
        # Reference bit-exact oracle (test_1d_fixed.py:9-16):
        # [10,20,30,40] * [.25,.5,.25] in Q4.12 → [10,20,30,28].
        y = fir_1d_fixed_golden([10, 20, 30, 40], [0.25, 0.5, 0.25])
        np.testing.assert_array_equal(y, np.array([10, 20, 30, 28], np.uint8))

    def test_identity_q412(self):
        y = fir_1d_fixed_golden([0, 1, 127, 254, 255], [1.0])
        np.testing.assert_array_equal(
            y, np.array([0, 1, 127, 254, 255], np.uint8)
        )

    def test_bias_rounding_half_up(self):
        # h = 0.5 over x=[1]: acc = 1*2048 = 2048; +bias 2048 = 4096;
        # >>12 = 1 → rounds 0.5 up to 1.
        y = fir_1d_fixed_golden([1], [0.5])
        np.testing.assert_array_equal(y, np.array([1], np.uint8))

    def test_saturation_high(self):
        y = fir_1d_fixed_golden([255, 255, 255], [Q412_MAX_REAL])
        np.testing.assert_array_equal(y, np.array([255] * 3, np.uint8))

    def test_saturation_low(self):
        y = fir_1d_fixed_golden([255, 255, 255], [-8.0])
        np.testing.assert_array_equal(y, np.array([0] * 3, np.uint8))


class TestFixedValidation:
    @pytest.mark.parametrize("bad", [float("nan"), float("inf"), float("-inf")])
    def test_nonfinite_x_rejected(self, bad):
        with pytest.raises(ValueError, match="x must be finite"):
            fir_1d_fixed_golden([1.0, bad], [0.5])

    @pytest.mark.parametrize("bad", [float("nan"), float("inf")])
    def test_nonfinite_h_rejected(self, bad):
        with pytest.raises(ValueError, match="must be finite"):
            fir_1d_fixed_golden([1, 2], [bad])

    def test_empty_h_rejected(self):
        with pytest.raises(ValueError, match="must not be empty"):
            fir_1d_fixed_golden([1, 2], [])

    def test_coeff_bits_12_rejected(self):
        with pytest.raises(ValueError, match="coeff_bits"):
            fir_1d_fixed_golden([1, 2], [0.5], coeff_bits=12)

    @pytest.mark.parametrize("frac_bits", [0, -1])
    def test_nonpositive_frac_bits_rejected(self, frac_bits):
        with pytest.raises(ValueError, match="frac_bits"):
            fir_1d_fixed_golden([1, 2], [0.5], frac_bits=frac_bits)

    @pytest.mark.parametrize("acc_bits", [0, -4])
    def test_nonpositive_acc_bits_rejected(self, acc_bits):
        with pytest.raises(ValueError, match="acc_bits"):
            fir_1d_fixed_golden([1, 2], [0.5], acc_bits=acc_bits)

    def test_q_range_upper_boundary_accepted(self):
        # Q4.12 max real = 7.999755859375 must pass; 8.0 must not.
        fir_1d_fixed_golden([1, 2], [Q412_MAX_REAL])
        with pytest.raises(ValueError, match="out of Q-format real range"):
            fir_1d_fixed_golden([1, 2], [8.0])

    def test_q_range_lower_boundary(self):
        fir_1d_fixed_golden([1, 2], [-8.0])  # exactly representable

    def test_custom_format_range(self):
        # Q1.7-style: coeff_bits=8, frac_bits=7 → real range
        # [-1.0, 127/128]. 0.999 quantizes fine; 1.0 is out of range.
        fir_1d_fixed_golden([1, 2], [127 / 128], coeff_bits=8, frac_bits=7)
        with pytest.raises(ValueError, match="out of Q-format real range"):
            fir_1d_fixed_golden([1, 2], [1.0], coeff_bits=8, frac_bits=7)


class TestFixedOutputContract:
    def test_output_is_uint8_ndarray_same_length(self, synthetic_rows):
        row = synthetic_rows[0].tolist()
        y = fir_1d_fixed_golden(row, [0.25, 0.5, 0.25])
        assert isinstance(y, np.ndarray)
        assert y.dtype == np.uint8
        assert y.shape == (len(row),)
        assert y.min() >= 0 and y.max() <= 255

    def test_edge_filter_saturates_at_zero(self):
        # edge filter output is signed; negative values saturate to 0.
        y = fir_1d_fixed_golden([255, 0, 0, 0], [-1.0, 0.0, 1.0])
        # y[1] = -x[2] + x[0] = 255 ; y[0] = -x[1] = 0 (sat)
        np.testing.assert_array_equal(y, np.array([0, 255, 0, 0], np.uint8))


class TestQFormatDataclass:
    def test_defaults_are_q412(self):
        qf = QFormat()
        assert (qf.coeff_bits, qf.frac_bits, qf.acc_bits) == (16, 12, 32)
        assert qf.scale == 4096
        assert qf.min_coeff_real == -8.0
        assert qf.max_coeff_real == Q412_MAX_REAL
        assert qf.int32_exact

    def test_quantize_ties_to_even(self):
        qf = QFormat(frac_bits=1, coeff_bits=8)
        # 0.75 * 2 = 1.5 → rint ties-to-even → 2 ; 1.25 * 2 = 2.5 → 2.
        h = qf.quantize_coeffs([0.75, 1.25])
        np.testing.assert_array_equal(h, np.array([2, 2], np.int8))

    def test_quantize_clip(self):
        qf = QFormat()
        h = qf.quantize_coeffs([7.99999])  # rint → 32768, clip → 32767
        np.testing.assert_array_equal(h, np.array([32767], np.int16))


class TestAccumulatorWraparound:
    def test_small_acc_bits_wraps(self):
        # x = [255], h = [7.999755859375] (Q4.12 max): acc = 255 * 32767
        # = 8355585. With acc_bits=16: 8355585 mod 2^16 = 32513 (positive);
        # bias-round: (32513 + 2048) >> 12 = 8.
        y = fir_1d_fixed_golden([255], [Q412_MAX_REAL], acc_bits=16)
        np.testing.assert_array_equal(y, np.array([8], np.uint8))
        # Same input with a 32-bit accumulator saturates high instead.
        y32 = fir_1d_fixed_golden([255], [Q412_MAX_REAL], acc_bits=32)
        np.testing.assert_array_equal(y32, np.array([255], np.uint8))

    def test_acc_bits_wider_than_64_is_identity(self):
        y = fir_1d_fixed_golden([10, 20, 30, 40], [0.25, 0.5, 0.25],
                                acc_bits=96)
        np.testing.assert_array_equal(y, np.array([10, 20, 30, 28], np.uint8))
