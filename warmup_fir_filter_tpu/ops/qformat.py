"""Q-format fixed-point arithmetic: the single source of numeric truth.

The reference repo implements its hardware numerics inline inside a scalar
Python loop (``fir_1d/model/python/fir_1d_fixed_ref.py:12-130``).  Here the
same contract is factored into a :class:`QFormat` config plus a small set of
bit-exact primitives that run identically in numpy (the trusted host oracle)
and in jnp int32 (the device sim path).

The three distinct rounding modes of the reference (SURVEY.md §3.2) are kept
strictly separate:

1. input *round-half-up*: ``floor(x + 0.5)`` (``fir_1d_ref.py:35-38``),
2. coefficient quantization *rint ties-to-even* then clip
   (``fir_1d_fixed_ref.py:79-81``),
3. output *bias-add then arithmetic shift* (round-half-up in two's
   complement, ``fir_1d_fixed_ref.py:118-120``).

Device note: everything here is formulated so that it is exact in **int32
modular arithmetic** (XLA integers wrap two's-complement).  In particular:

- accumulator wraparound to ``acc_bits`` ≤ 32 is a pair of arithmetic
  shifts (sign-extension), matching the reference's
  ``acc & mask`` + MSB sign-restore (``fir_1d_fixed_ref.py:94,110-115``);
- the bias-round-shift is decomposed as ``(acc >> fb) + carry`` with
  ``carry = ((acc & (2^fb - 1)) + 2^(fb-1)) >> fb ∈ {0, 1}`` so it can
  never overflow int32, unlike a naive ``(acc + bias) >> fb``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

MAX_PIXEL = 255
MIN_PIXEL = 0
#: Maximum admissible |h| for any filter coefficient (reference
#: ``fir_1d_ref.py:6``: MAX_ABS_H_COEFF = 8.0).
MAX_ABS_H_COEFF = 8.0

_COEFF_DTYPES = {8: np.int8, 16: np.int16, 32: np.int32}
VALID_COEFF_BITS = tuple(sorted(_COEFF_DTYPES))


@dataclasses.dataclass(frozen=True)
class QFormat:
    """Fixed-point number format for the golden/sim FIR path.

    Mirrors the keyword surface of the reference golden model
    (``fir_1d_fixed_ref.py:12-17``): Q4.12 with a 32-bit accumulator and
    16-bit coefficients by default.
    """

    coeff_bits: int = 16
    frac_bits: int = 12
    acc_bits: int = 32

    def __post_init__(self) -> None:
        # Reference validation contract: fir_1d_fixed_ref.py:39-47.
        if self.frac_bits <= 0:
            raise ValueError(
                f"Invalid frac_bits={self.frac_bits}. frac_bits must be > 0."
            )
        if self.acc_bits <= 0:
            raise ValueError(
                f"Invalid acc_bits={self.acc_bits}. acc_bits must be > 0."
            )
        if self.coeff_bits not in VALID_COEFF_BITS:
            raise ValueError(
                f"Invalid coeff_bits={self.coeff_bits}. coeff_bits must be "
                f"one of {VALID_COEFF_BITS}."
            )

    # -- derived constants (fir_1d_fixed_ref.py:51-61) ---------------------
    @property
    def scale(self) -> int:
        return 1 << self.frac_bits

    @property
    def min_coeff(self) -> int:
        return -(1 << (self.coeff_bits - 1))

    @property
    def max_coeff(self) -> int:
        return (1 << (self.coeff_bits - 1)) - 1

    @property
    def min_coeff_real(self) -> float:
        return self.min_coeff / self.scale

    @property
    def max_coeff_real(self) -> float:
        return self.max_coeff / self.scale

    @property
    def coeff_dtype(self) -> np.dtype:
        return np.dtype(_COEFF_DTYPES[self.coeff_bits])

    @property
    def int32_exact(self) -> bool:
        """True when the jnp int32 device path reproduces this format exactly.

        int32 modular arithmetic emulates any ``acc_bits`` ≤ 32 (a single
        truncate-and-sign-extend recovers ``sum mod 2^acc_bits`` because
        reduction mod 2^32 commutes with reduction mod 2^acc_bits).
        """
        return self.acc_bits <= 32

    def validate_h_range(self, h) -> None:
        """Reject coefficients outside the Q-format real range.

        Reference contract: fir_1d_fixed_ref.py:67-72 (checked on the *real*
        values, before quantization).
        """
        lo, hi = self.min_coeff_real, self.max_coeff_real
        for index, coeff in enumerate(np.asarray(h, dtype=np.float64).tolist()):
            if coeff < lo or coeff > hi:
                raise ValueError(
                    f"Invalid h[{index}]={coeff}: out of Q-format real range "
                    f"[{lo}, {hi}]."
                )

    def quantize_coeffs(self, h) -> np.ndarray:
        """Real coefficients → fixed-point integers (host-side, tiny).

        rint (ties-to-even) → clip → integer dtype, exactly as
        fir_1d_fixed_ref.py:79-81.
        """
        h64 = np.asarray(h, dtype=np.float64)
        h_fixed = np.rint(h64 * self.scale)
        h_fixed = np.clip(h_fixed, self.min_coeff, self.max_coeff)
        return h_fixed.astype(self.coeff_dtype)


# ---------------------------------------------------------------------------
# numpy-side primitives (trusted oracle building blocks)
# ---------------------------------------------------------------------------


def round_half_up_np(x: np.ndarray) -> np.ndarray:
    """``floor(x + 0.5)`` elementwise (reference ``fir_1d_ref.py:35-38``)."""
    return np.floor(np.asarray(x, dtype=np.float64) + 0.5).astype(np.int64)


def clamp_pixel_np(x: np.ndarray) -> np.ndarray:
    """Clamp integer samples into [0, 255] (reference ``fir_1d_ref.py:40-41``)."""
    return np.clip(x, MIN_PIXEL, MAX_PIXEL)


def wrap_to_acc_bits_np(acc: np.ndarray, acc_bits: int) -> np.ndarray:
    """Truncate an int64 accumulator to ``acc_bits`` and sign-extend.

    Equivalent to the reference's ``acc &= mask`` followed by the MSB-test
    sign restore (``fir_1d_fixed_ref.py:94,110-115``), expressed as a shift
    pair.  ``acc_bits`` ≥ 64 is the identity (no int64-representable sum can
    wrap a ≥64-bit accumulator).
    """
    acc = np.asarray(acc, dtype=np.int64)
    if acc_bits >= 64:
        return acc
    s = np.int64(64 - acc_bits)
    return (acc << s) >> s


def bias_round_shift_np(acc: np.ndarray, frac_bits: int) -> np.ndarray:
    """Round-half-up rescale: ``(acc + 2^(fb-1)) >> fb`` without overflow.

    Decomposed into arithmetic shift + {0,1} carry so the identical
    formulation is reusable in int32 on the device.  Matches
    ``fir_1d_fixed_ref.py:118-120`` bit-for-bit for any int64 ``acc``.
    """
    acc = np.asarray(acc, dtype=np.int64)
    low = acc & np.int64((1 << frac_bits) - 1)
    carry = (low + np.int64(1 << (frac_bits - 1))) >> np.int64(frac_bits)
    return (acc >> np.int64(frac_bits)) + carry


def saturate_pixel_np(v: np.ndarray) -> np.ndarray:
    """Saturate to uint8 pixels (``fir_1d_fixed_ref.py:123-128``)."""
    return np.clip(v, MIN_PIXEL, MAX_PIXEL).astype(np.uint8)
