"""1-D FIR compute paths in jnp (the device "model" and "sim" paths).

Two jit-compiled paths over batched rows, mirroring the reference's
model/sim split (SURVEY.md §7.1) as two configs of one kernel library:

- :func:`fir1d_ideal_rows_jnp` — the float *model* path (f32 on device).
- :func:`fir1d_fixed_rows_jnp` — the bit-exact int32 *sim* path,
  reproducing the golden contract of ``fir_1d_fixed_ref.py:75-130``
  for every ``acc_bits`` ≤ 32 via int32 modular arithmetic.

Why int32 is exact (SURVEY.md §7.3 item 1): XLA integer arithmetic wraps
two's-complement, so products and sums are computed mod 2^32; reducing the
final accumulator mod 2^acc_bits (a truncate-and-sign-extend shift pair)
yields the same value as the reference's unbounded-int MAC followed by
``& mask`` + MSB sign restore.  The bias-round-shift is decomposed into
``(acc >> fb) + carry`` (carry ∈ {0,1}) so no step can overflow int32.

The convolution itself is L shifted multiply-adds over a zero-padded row
block (:func:`shift_mac`), in blocks of at most ``TAP_BLOCK`` unrolled
taps.  A short filter is one block, which XLA fuses into one elementwise
loop; the blocks after the first run in a ``fori_loop``, so a 4096-tap
filter traces to two 64-tap blocks instead of 4096 slices.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from warmup_fir_filter_tpu.ops.qformat import QFormat

#: Most taps per unrolled block of :func:`shift_mac`.
TAP_BLOCK = 64


def pad_rows_same_mode(x: jnp.ndarray, num_taps: int) -> jnp.ndarray:
    """Zero-pad (B, N) rows for same-mode center-aligned convolution.

    Left pad = L-1-center, right pad = center with center = L // 2, so
    ``y[n] = Σ_k h[k] * xp[n + (L-1) - k]`` (see ``fir_1d_ref.py:49-60``).
    """
    center = num_taps // 2
    return jnp.pad(x, ((0, 0), (num_taps - 1 - center, center)))


def shift_mac(xp: jnp.ndarray, h: jnp.ndarray, num_taps: int,
              acc: jnp.ndarray) -> jnp.ndarray:
    """``acc + Σ_k h[k] · xp[:, L-1-k : L-1-k+N]`` over halo'd rows.

    ``xp`` is (B, N + L - 1) with the same-mode halo attached.  Taps are
    taken in reversed order ``j = L-1-k`` so window ``j`` starts at
    column ``j``, and zero-padded to whole blocks of
    ``min(L, TAP_BLOCK)`` taps, each unrolled.  Block 0 runs before the
    ``fori_loop`` over the rest, so the loop's carry already depends on
    ``xp`` (as ``shard_map`` requires of a carry that varies per shard).
    Integer sums wrap mod 2^32 and are exact in any order.
    """
    n = acc.shape[1]
    width = min(num_taps, TAP_BLOCK)
    blocks = -(-num_taps // width)
    pad = blocks * width - num_taps
    h_rev = jnp.pad(h[::-1], (0, pad)).reshape(blocks, width)
    xp = jnp.pad(xp, ((0, 0), (0, pad)))

    def block(b, acc):
        for j in range(width):
            window = lax.dynamic_slice_in_dim(xp, b * width + j, n, 1)
            acc = acc + h_rev[b, j] * window
        return acc

    return lax.fori_loop(1, blocks, block, block(0, acc))


@partial(jax.jit, static_argnames=("num_taps",))
def _ideal_core(x_f32: jnp.ndarray, h_f32: jnp.ndarray, num_taps: int):
    xp = pad_rows_same_mode(x_f32, num_taps)
    return shift_mac(xp, h_f32, num_taps, jnp.zeros_like(x_f32))


def fir1d_ideal_rows_jnp(x_u8, h) -> jax.Array:
    """Float32 ideal FIR over (B, N) uint8 rows. Unclamped f32 output.

    The on-device float model path; for the bit-exact float64 contract use
    the host golden (``models/golden.py``).  f32 accumulation error is
    bounded by L·eps·max|h·x| ≈ 1e-3 absolute for the reference filter
    banks — well inside the compare-report SNR bounds (SURVEY.md §6).
    """
    h64 = np.asarray(h, dtype=np.float64)
    x_f32 = jnp.asarray(x_u8, dtype=jnp.float32)
    return _ideal_core(x_f32, jnp.asarray(h64, dtype=jnp.float32), int(h64.size))


def fixed_epilogue_i32(acc: jnp.ndarray, frac_bits: int,
                       acc_bits: int) -> jnp.ndarray:
    """Wraparound → bias-round-shift → saturate, all int32-exact.

    The shared hardware epilogue of the golden contract
    (``fir_1d_fixed_ref.py:94,110-128``), reused by the 1-D, 2-D,
    resampling, streaming and sharded paths.
    """
    # Accumulator wraparound to acc_bits (+ sign extension) expressed as
    # an arithmetic shift pair.
    if acc_bits < 32:
        s = 32 - acc_bits
        acc = (acc << s) >> s

    # Bias round + rescale, overflow-free decomposition.
    low = acc & ((1 << frac_bits) - 1)
    carry = (low + (1 << (frac_bits - 1))) >> frac_bits
    final = (acc >> frac_bits) + carry

    return jnp.clip(final, 0, 255).astype(jnp.uint8)


def fixed_fir_prehaloed_i32(
    x_ext_i32: jnp.ndarray,
    h_fixed_i32: jnp.ndarray,
    num_taps: int,
    frac_bits: int,
    acc_bits: int,
) -> jnp.ndarray:
    """Fixed FIR over rows whose halo columns are already attached.

    ``x_ext`` has width N + L - 1: ``L-1-center`` left halo columns and
    ``center`` right halo columns around the N-sample core (zeros at
    stream edges).  This is the building block shared by the single-chip
    padded path and the multi-chip halo-exchange path, so shard
    boundaries are bit-identical to the zero-padded global computation.
    """
    n = x_ext_i32.shape[1] - (num_taps - 1)
    acc = jnp.zeros(x_ext_i32.shape[:1] + (n,), jnp.int32)
    acc = shift_mac(x_ext_i32, h_fixed_i32, num_taps, acc)  # wraps mod 2^32
    return fixed_epilogue_i32(acc, frac_bits, acc_bits)


@partial(jax.jit, static_argnames=("num_taps", "frac_bits", "acc_bits"))
def _fixed_core(
    x_i32: jnp.ndarray,
    h_fixed_i32: jnp.ndarray,
    num_taps: int,
    frac_bits: int,
    acc_bits: int,
):
    xp = pad_rows_same_mode(x_i32, num_taps)
    return fixed_fir_prehaloed_i32(xp, h_fixed_i32, num_taps, frac_bits,
                                   acc_bits)


def fir1d_fixed_rows_jnp(
    x_u8, h, qformat: QFormat = QFormat()
) -> jax.Array:
    """Bit-exact fixed-point FIR over (B, N) uint8 rows on the device.

    Requires ``qformat.int32_exact`` (acc_bits ≤ 32); wider accumulators
    fall back to the host golden model.
    """
    if not qformat.int32_exact:
        raise ValueError(
            f"acc_bits={qformat.acc_bits} > 32 is not representable in the "
            "int32 device path; use models.golden.fir1d_fixed_golden_rows."
        )
    h_fixed = qformat.quantize_coeffs(h).astype(np.int32)
    x_i32 = jnp.asarray(x_u8, dtype=jnp.int32)
    return _fixed_core(
        x_i32,
        jnp.asarray(h_fixed),
        int(h_fixed.size),
        qformat.frac_bits,
        qformat.acc_bits,
    )
