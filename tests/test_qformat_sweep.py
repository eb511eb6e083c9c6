"""Randomized device-vs-golden sweep over QFormats and tap counts.

Breadth ring: every (coeff_bits, frac_bits, acc_bits, L) cell runs the
same random vectors through the numpy golden and the jnp int32 device
path, asserting bit-equality.

Two layers:

- the hand-picked boundary cells of ``SWEEP`` (they pin the corner
  cases by name);
- a seeded *randomized* sweep of ~100 cells over coeff_bits ×
  frac_bits × acc_bits 8-32 × taps {1,2,3,5,63,129,257} × ragged
  widths (the fuzz net for rounding/wraparound interactions no one
  hand-picks; golden spec ``fir_1d_golden_spec_v1.md:28-90`` of the
  reference).
"""

import numpy as np
import pytest

from warmup_fir_filter_tpu.models.golden import fir1d_fixed_golden_rows
from warmup_fir_filter_tpu.ops.fir1d import fir1d_fixed_rows_jnp
from warmup_fir_filter_tpu.ops.qformat import QFormat

SWEEP = [
    # (coeff_bits, frac_bits, acc_bits, num_taps)
    (8, 4, 32, 3),
    (8, 7, 16, 7),
    (16, 12, 32, 5),
    (16, 12, 20, 5),
    (16, 8, 24, 11),
    (16, 15, 31, 4),
    (32, 24, 32, 3),
    (32, 12, 28, 6),
    (16, 1, 8, 2),
]


@pytest.mark.parametrize("coeff_bits,frac_bits,acc_bits,num_taps", SWEEP)
def test_three_way_bit_equality(rng, coeff_bits, frac_bits, acc_bits,
                                num_taps):
    """Device path vs golden on the named boundary cells."""
    qf = QFormat(coeff_bits=coeff_bits, frac_bits=frac_bits,
                 acc_bits=acc_bits)
    span = min(qf.max_coeff_real, 8.0)
    h = rng.uniform(-span, span, size=num_taps)
    h = np.clip(h, max(qf.min_coeff_real, -8.0), span)
    x = rng.integers(0, 256, size=(3, 150), dtype=np.uint8)

    golden = fir1d_fixed_golden_rows(x, h, qf)
    jnp_out = np.asarray(fir1d_fixed_rows_jnp(x, h, qf))
    np.testing.assert_array_equal(jnp_out, golden)


def _random_cells(num_cells: int, seed: int) -> list:
    """Seeded random (coeff_bits, frac_bits, acc_bits, taps, width) cells."""
    rng = np.random.default_rng(seed)
    tap_choices = np.array([1, 2, 3, 5, 63, 129, 257])
    cells = []
    for _ in range(num_cells):
        coeff_bits = int(rng.choice([8, 16, 32]))
        frac_bits = int(rng.integers(1, min(coeff_bits, 25)))
        acc_bits = int(rng.integers(8, 33))
        num_taps = int(rng.choice(tap_choices))
        width = int(rng.integers(num_taps, 600))  # ragged, incl. < 1 lane
        cells.append((coeff_bits, frac_bits, acc_bits, num_taps, width))
    return cells


@pytest.mark.parametrize("batch_idx", range(4))
def test_randomized_fuzz_sweep(batch_idx):
    """~100-cell seeded fuzz: golden vs device bit-equality.

    Split into 4 parametrized batches so a failure names its quarter;
    the cell parameters are printed in the assert message for replay.
    """
    cells = _random_cells(num_cells=25, seed=20260819 + batch_idx)
    rng = np.random.default_rng(777 + batch_idx)
    for coeff_bits, frac_bits, acc_bits, num_taps, width in cells:
        qf = QFormat(coeff_bits=coeff_bits, frac_bits=frac_bits,
                     acc_bits=acc_bits)
        span = min(qf.max_coeff_real, 8.0)
        h = np.clip(rng.uniform(-span, span, size=num_taps),
                    max(qf.min_coeff_real, -8.0), span)
        x = rng.integers(0, 256, size=(2, width), dtype=np.uint8)
        cell = (f"cell(coeff={coeff_bits}, frac={frac_bits}, "
                f"acc={acc_bits}, taps={num_taps}, width={width})")

        golden = fir1d_fixed_golden_rows(x, h, qf)
        jnp_out = np.asarray(fir1d_fixed_rows_jnp(x, h, qf))
        np.testing.assert_array_equal(jnp_out, golden, err_msg=f"jnp {cell}")


class TestQFormat2DSweep:
    """Randomized 2-D QFormat fuzz: golden vs the device path, including
    wraparound formats (one accumulator wrap per output pixel)."""

    def test_randomized_2d_cells(self):
        from warmup_fir_filter_tpu.ops.fir2d import (
            fir2d_fixed_golden,
            fir2d_fixed_jnp,
        )

        rng = np.random.default_rng(20260820)
        shapes = [(1, 1), (1, 3), (3, 1), (3, 3), (2, 4), (5, 5), (4, 2)]
        for _ in range(12):
            cb = int(rng.choice([8, 16, 32]))
            fb = int(rng.integers(1, min(cb, 15)))
            ab = int(rng.integers(max(fb + 2, 8), 33))
            qf = QFormat(coeff_bits=cb, frac_bits=fb, acc_bits=ab)
            taps_r, taps_c = shapes[int(rng.integers(len(shapes)))]
            h = rng.uniform(-2.0, 2.0, (taps_r, taps_c))
            x = rng.integers(
                0, 256,
                size=(int(rng.integers(3, 20)), int(rng.integers(2, 50))),
                dtype=np.uint8,
            )
            golden = fir2d_fixed_golden(x, h, qf)
            label = f"qf=({cb},{fb},{ab}) h={taps_r}x{taps_c} x={x.shape}"
            np.testing.assert_array_equal(
                np.asarray(fir2d_fixed_jnp(x, h, qf)), golden,
                err_msg=f"jnp {label}")


@pytest.mark.parametrize("num_taps", [300, 1001, 4096])
def test_long_filter_formats(rng, num_taps):
    """Formats × the blocked (fori_loop) shift-MAC beyond TAP_BLOCK."""
    for coeff_bits, frac_bits, acc_bits in ((8, 4, 32), (16, 12, 20),
                                            (32, 24, 28)):
        qf = QFormat(coeff_bits=coeff_bits, frac_bits=frac_bits,
                     acc_bits=acc_bits)
        span = min(qf.max_coeff_real, 8.0)
        h = np.clip(rng.uniform(-span, span, size=num_taps),
                    max(qf.min_coeff_real, -8.0), span)
        x = rng.integers(0, 256, size=(2, num_taps + 37), dtype=np.uint8)
        np.testing.assert_array_equal(
            np.asarray(fir1d_fixed_rows_jnp(x, h, qf)),
            fir1d_fixed_golden_rows(x, h, qf),
            err_msg=f"qf=({coeff_bits},{frac_bits},{acc_bits})")
