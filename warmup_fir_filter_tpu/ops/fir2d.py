"""2-D FIR: the generalization the reference scaffolded but never built.

The reference's ``fir_2d/`` tree is an empty skeleton (SURVEY.md §1);
BASELINE.json config 3 mandates "5x5 fixed-point 2D FIR over 512x512
image tiles, sim-vs-model cross-check".  The numeric contract here is the
natural 2-D extension of the 1-D golden spec (``fir_1d_golden_spec_v1``):

- same-mode, center-aligned in both axes (``center = L // 2`` per axis),
  zero padding outside the image;
- fixed path: quantize the (Lr, Lc) kernel with rint-ties-even → clip
  (per-element, as 1-D), integer MAC over the full window, ONE
  accumulator wraparound to ``acc_bits`` per output pixel, bias-round-
  shift by ``frac_bits``, saturate to uint8;
- ideal path: float64 (host golden) / float32 (device), unclamped.

A dense 2-D FIR is expressed as Lr·Lc shifted multiply-adds accumulated
in int32, with the 1-D path's epilogue.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from warmup_fir_filter_tpu.ops.fir1d import fixed_epilogue_i32
from warmup_fir_filter_tpu.ops.qformat import (
    QFormat,
    bias_round_shift_np,
    saturate_pixel_np,
    wrap_to_acc_bits_np,
)


def _pad_2d(x: np.ndarray | jnp.ndarray, taps_r: int, taps_c: int, xp):
    cr, cc = taps_r // 2, taps_c // 2
    return xp.pad(
        x,
        (
            (taps_r - 1 - cr, cr),
            (taps_c - 1 - cc, cc),
        ),
    )


def fir2d_ideal_golden(x_u8: np.ndarray, h: np.ndarray) -> np.ndarray:
    """Float64 ideal 2-D FIR over an (H, W) image. Unclamped output."""
    h64 = np.asarray(h, dtype=np.float64)
    taps_r, taps_c = h64.shape
    rows, cols = x_u8.shape
    xp = _pad_2d(x_u8.astype(np.float64), taps_r, taps_c, np)
    acc = np.zeros((rows, cols), np.float64)
    for kr in range(taps_r):
        for kc in range(taps_c):
            acc += h64[kr, kc] * xp[
                taps_r - 1 - kr : taps_r - 1 - kr + rows,
                taps_c - 1 - kc : taps_c - 1 - kc + cols,
            ]
    return acc


def fir2d_fixed_golden(
    x_u8: np.ndarray, h: np.ndarray, qformat: QFormat = QFormat()
) -> np.ndarray:
    """Bit-accurate Q-format fixed-point 2-D FIR (trusted host oracle)."""
    h_fixed = qformat.quantize_coeffs(np.asarray(h)).astype(np.int64)
    taps_r, taps_c = h_fixed.shape
    rows, cols = x_u8.shape
    xp = _pad_2d(x_u8.astype(np.int64), taps_r, taps_c, np)
    acc = np.zeros((rows, cols), np.int64)
    for kr in range(taps_r):
        for kc in range(taps_c):
            acc += h_fixed[kr, kc] * xp[
                taps_r - 1 - kr : taps_r - 1 - kr + rows,
                taps_c - 1 - kc : taps_c - 1 - kc + cols,
            ]
    acc = wrap_to_acc_bits_np(acc, qformat.acc_bits)
    return saturate_pixel_np(bias_round_shift_np(acc, qformat.frac_bits))


@partial(jax.jit, static_argnames=("taps_r", "taps_c", "frac_bits",
                                   "acc_bits"))
def _fixed2d_core(x_i32, h_i32, taps_r, taps_c, frac_bits, acc_bits):
    rows, cols = x_i32.shape
    xp = _pad_2d(x_i32, taps_r, taps_c, jnp)
    acc = jnp.zeros((rows, cols), jnp.int32)
    for kr in range(taps_r):
        for kc in range(taps_c):
            window = jax.lax.dynamic_slice(
                xp,
                (taps_r - 1 - kr, taps_c - 1 - kc),
                (rows, cols),
            )
            acc = acc + h_i32[kr, kc] * window
    return fixed_epilogue_i32(acc, frac_bits, acc_bits)


@partial(jax.jit, static_argnames=("taps_r", "taps_c", "frac_bits",
                                   "acc_bits"))
def fixed_fir2d_prehaloed_i32(
    x_ext, h_i32, taps_r, taps_c, frac_bits, acc_bits
):
    """Fixed 2-D FIR core over a PRE-HALOED int32 block.

    ``x_ext`` carries ``taps_r - 1 - taps_r//2`` extra rows on top,
    ``taps_r//2`` on the bottom, and the analogous ``taps_c`` margins on
    the columns (the same margins :func:`_pad_2d` zero-fills) — supplied
    by the caller, e.g. a ``ppermute`` halo exchange
    (``parallel/halo.py``).  Output shape is the margin-stripped core;
    identical epilogue to ``_fixed2d_core``, so a shard computing over
    true neighbor samples is bit-identical to the global computation.
    """
    rows = x_ext.shape[0] - (taps_r - 1)
    cols = x_ext.shape[1] - (taps_c - 1)
    acc = jnp.zeros((rows, cols), jnp.int32)
    for kr in range(taps_r):
        for kc in range(taps_c):
            window = jax.lax.dynamic_slice(
                x_ext,
                (taps_r - 1 - kr, taps_c - 1 - kc),
                (rows, cols),
            )
            acc = acc + h_i32[kr, kc] * window
    return fixed_epilogue_i32(acc, frac_bits, acc_bits)


def fir2d_fixed_jnp(
    x_u8, h, qformat: QFormat = QFormat()
) -> jax.Array:
    """Bit-exact fixed-point 2-D FIR on the device (int32 sim path)."""
    if not qformat.int32_exact:
        raise ValueError(
            f"acc_bits={qformat.acc_bits} > 32 is not representable in the "
            "int32 device path; use fir2d_fixed_golden."
        )
    h_fixed = qformat.quantize_coeffs(np.asarray(h)).astype(np.int32)
    taps_r, taps_c = h_fixed.shape
    return _fixed2d_core(
        jnp.asarray(x_u8, jnp.int32),
        jnp.asarray(h_fixed),
        taps_r,
        taps_c,
        qformat.frac_bits,
        qformat.acc_bits,
    )


@partial(jax.jit, static_argnames=("taps_r", "taps_c"))
def _ideal2d_core(x_f32, h_f32, taps_r, taps_c):
    rows, cols = x_f32.shape
    xp = _pad_2d(x_f32, taps_r, taps_c, jnp)
    acc = jnp.zeros((rows, cols), jnp.float32)
    for kr in range(taps_r):
        for kc in range(taps_c):
            window = jax.lax.dynamic_slice(
                xp, (taps_r - 1 - kr, taps_c - 1 - kc), (rows, cols)
            )
            acc = acc + h_f32[kr, kc] * window
    return acc


def fir2d_ideal_jnp(x_u8, h) -> jax.Array:
    """Float32 ideal 2-D FIR on the device (model path). Unclamped."""
    h64 = np.asarray(h, dtype=np.float64)
    return _ideal2d_core(
        jnp.asarray(x_u8, jnp.float32),
        jnp.asarray(h64, jnp.float32),
        int(h64.shape[0]),
        int(h64.shape[1]),
    )


FILTER_BANK_2D: dict[str, np.ndarray] = {
    "box3": np.full((3, 3), 1.0 / 9.0),
    "gauss5": (
        np.outer([1, 4, 6, 4, 1], [1, 4, 6, 4, 1]).astype(np.float64) / 256.0
    ),
    "laplacian": np.array(
        [[0.0, 1.0, 0.0], [1.0, -4.0, 1.0], [0.0, 1.0, 0.0]]
    ),
    "sharpen5": (
        -np.outer([1, 4, 6, 4, 1], [1, 4, 6, 4, 1]).astype(np.float64) / 256.0
        + np.pad([[2.0]], 2)
    ),
}
