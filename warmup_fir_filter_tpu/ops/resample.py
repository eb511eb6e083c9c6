"""Polyphase rational resampling (the north-star's resample stage).

Rational rate change by P/Q (upsample P, anti-alias low-pass, downsample
Q) computed in true polyphase form — the zero-stuffed upsampled stream is
never materialized.  Derivation from the same-mode contract:

With ``xu[i] = x[i/P]`` when ``P | i`` else 0, and ``z = FIR(xu, h)``
(same-mode, center ``c = L // 2``), the retained outputs are
``y[m] = z[m·Q]``.  Substituting::

    y[m] = Σ_j h[r_m + P·j] · x[b_m − j]
    r_m  = (m·Q + c) mod P            (polyphase branch)
    b_m  = (m·Q + c − r_m) / P        (input anchor)

Output length is ``ceil(N·P / Q)`` (every m with ``m·Q < N·P``).

Both numeric paths share this skeleton:

- float model path (float64 host oracle / float32 jnp);
- bit-exact fixed sim path: quantized taps, int32 MAC, accumulator
  wraparound, bias-round-shift, saturate — the 1-D golden contract
  applied to each polyphase branch (one epilogue per output sample).
"""

from __future__ import annotations

from functools import partial
from math import gcd

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


def design_lowpass(num_taps: int, cutoff: float, *, gain: float = 1.0) -> np.ndarray:
    """Windowed-sinc low-pass (Hamming), normalized to ``gain`` at DC.

    ``cutoff`` is the normalized frequency in (0, 1) relative to Nyquist.
    Standard textbook design (parity with scipy.signal.firwin semantics).
    """
    if not 0.0 < cutoff < 1.0:
        raise ValueError(f"cutoff={cutoff} must be in (0, 1)")
    n = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0
    h = np.sinc(cutoff * n) * cutoff
    window = 0.54 - 0.46 * np.cos(
        2.0 * np.pi * np.arange(num_taps) / (num_taps - 1)
    )
    h *= window
    return h * (gain / h.sum())


def _plan(n: int, up: int, down: int, num_taps: int):
    """Per-output (branch, anchor) index plan, host-side numpy."""
    if up < 1 or down < 1:
        raise ValueError(f"up={up} and down={down} must be >= 1")
    if gcd(up, down) != 1:
        raise ValueError(f"up={up} and down={down} must be coprime")
    center = num_taps // 2
    m = np.arange(-(-n * up // down))  # ceil(N·P / Q) outputs
    u = m * down + center
    branch = u % up
    anchor = (u - branch) // up
    return m.size, branch, anchor, center


def _polyphase_taps(h: np.ndarray, up: int) -> np.ndarray:
    """(P, J) branch taps: ``taps[r, j] = h[r + P·j]`` (zero-padded)."""
    num_taps = h.shape[0]
    branches = -(-num_taps // up)
    padded = np.zeros(up * branches, h.dtype)
    padded[:num_taps] = h
    return padded.reshape(branches, up).T.copy()


def resample_poly_golden(
    x, h, up: int, down: int
) -> np.ndarray:
    """Float64 host oracle over (C, T) rows."""
    x64 = np.asarray(x, np.float64)
    h64 = np.asarray(h, np.float64)
    channels, n = x64.shape
    out_len, branch, anchor, _ = _plan(n, up, down, h64.size)
    taps = _polyphase_taps(h64, up)  # (P, J)
    num_branches = taps.shape[1]
    y = np.zeros((channels, out_len), np.float64)
    # Same float64 accumulation order as the golden FIR: ascending j.
    xp = np.pad(x64, ((0, 0), (num_branches, num_branches)))
    for j in range(num_branches):
        idx = anchor - j + num_branches  # in-bounds via padding
        idx = np.clip(idx, 0, xp.shape[1] - 1)
        valid = ((anchor - j) >= 0) & ((anchor - j) < n)
        y += np.where(valid, taps[branch, j] * xp[:, idx], 0.0)
    return y


def resample_poly_fixed_golden(
    x_u8, h, up: int, down: int, qformat: QFormat = QFormat()
) -> np.ndarray:
    """Bit-accurate fixed-point resampler (trusted host oracle)."""
    x64 = np.asarray(x_u8, np.int64)
    h_fixed = qformat.quantize_coeffs(np.asarray(h)).astype(np.int64)
    channels, n = x64.shape
    out_len, branch, anchor, _ = _plan(n, up, down, h_fixed.size)
    taps = _polyphase_taps(h_fixed, up)
    num_branches = taps.shape[1]
    acc = np.zeros((channels, out_len), np.int64)
    xp = np.pad(x64, ((0, 0), (num_branches, num_branches)))
    for j in range(num_branches):
        idx = anchor - j + num_branches
        idx = np.clip(idx, 0, xp.shape[1] - 1)
        valid = ((anchor - j) >= 0) & ((anchor - j) < n)
        acc += np.where(valid, taps[branch, j] * xp[:, idx], 0)
    acc = wrap_to_acc_bits_np(acc, qformat.acc_bits)
    return saturate_pixel_np(bias_round_shift_np(acc, qformat.frac_bits))


def _phase_plan(up: int, down: int, center: int, out_len: int):
    """Static per-phase decomposition of the output stream.

    Outputs split into ``P = up`` interleaved phases: phase ``t`` holds
    the outputs ``m ≡ t (mod P)``, whose polyphase branch is constant
    (``r_t = (t·Q + c) mod P``) and whose input anchor is affine
    (``a0_t + Q·k`` for the k-th output of the phase).  This turns the
    per-output gather formulation into **strided slices**.
    """
    plan = []
    for t in range(up):
        u = t * down + center
        r = u % up
        a0 = (u - r) // up
        count = -(-max(out_len - t, 0) // up)  # outputs m = t, t+P, ...
        plan.append((r, a0, count))
    return tuple(plan)


def _poly_core(xp, taps_np, plan, up, down, num_branches, pad_left, dtype):
    """Shared gather-free polyphase accumulation over padded rows.

    ``xp`` is pre-padded so every ``a0 - j`` index is in bounds; the pad
    zeros realize the golden contract's out-of-range zero contributions
    exactly.  Returns the phase-interleaved (C, ceil·P) accumulator
    (callers crop to ``out_len``).

    Data movement: the Q downsample phases are split once up front (Q
    strided slices, the only non-contiguous accesses); every tap
    contribution is then a *contiguous* static slice of a phase.
    """
    channels = xp.shape[0]
    max_count = max(count for _, _, count in plan)
    total = xp.shape[1]
    total_q = -(-total // down)
    if total_q * down != total:
        xp = jnp.pad(xp, ((0, 0), (0, total_q * down - total)))
    xq = [
        jax.lax.slice(xp, (0, q), (channels, total_q * down), (1, down))
        for q in range(down)
    ]

    phases = []
    for r, a0, count in plan:
        acc_t = jnp.zeros((channels, max_count), dtype)
        for j in range(num_branches):
            tap = taps_np[r, j]
            if tap == 0:
                continue
            start = pad_left + a0 - j
            q, k0 = start % down, start // down
            sl = jax.lax.slice(xq[q], (0, k0), (channels, k0 + max_count))
            acc_t = acc_t + dtype(tap) * sl
        phases.append(acc_t)
    # Interleave phases: output m = t + P·k ↔ (k, t) in the stacked view.
    return jnp.stack(phases, axis=-1).reshape(channels, max_count * up)


@partial(jax.jit, static_argnames=("plan", "up", "down", "num_branches",
                                   "out_len", "taps_key"))
def _poly_float_core(x_f32, plan, up, down, num_branches, out_len, taps_key):
    pad_left = num_branches
    pad_right = down * (max(c for _, _, c in plan)) + num_branches
    xp = jnp.pad(x_f32, ((0, 0), (pad_left, pad_right)))
    taps_np = np.frombuffer(taps_key[0], np.float64).reshape(taps_key[1])
    out = _poly_core(xp, taps_np, plan, up, down, num_branches, pad_left,
                     jnp.float32)
    return out[:, :out_len]


def resample_poly(x, h, up: int, down: int) -> jax.Array:
    """Float32 polyphase resampler on device over (C, T) rows.

    The phase-split slice path: ~P·J elementwise multiply-adds in f32,
    in a fixed accumulation order (ascending branch tap).
    """
    h64 = np.asarray(h, np.float64)
    x_f32 = jnp.asarray(x, jnp.float32)
    n = int(x_f32.shape[1])
    out_len, _, _, center = _plan(n, up, down, h64.size)
    taps = _polyphase_taps(h64, up)
    plan = _phase_plan(up, down, center, out_len)
    # Taps ride the static cache key (they are host constants baked into
    # the unrolled kernel; hash via bytes).
    taps_key = (taps.tobytes(), taps.shape)
    return _poly_float_core(
        x_f32, plan, up, down, int(taps.shape[1]), out_len, taps_key
    )


@partial(jax.jit, static_argnames=("plan", "up", "down", "num_branches",
                                   "out_len", "frac_bits", "acc_bits",
                                   "taps_key"))
def _poly_fixed_core(x_i32, plan, up, down, num_branches, out_len,
                     frac_bits, acc_bits, taps_key):
    pad_left = num_branches
    pad_right = down * (max(c for _, _, c in plan)) + num_branches
    xp = jnp.pad(x_i32, ((0, 0), (pad_left, pad_right)))
    taps_np = np.frombuffer(taps_key[0], np.int64).reshape(taps_key[1])
    acc = _poly_core(xp, taps_np, plan, up, down, num_branches, pad_left,
                     jnp.int32)
    return fixed_epilogue_i32(acc[:, :out_len], frac_bits, acc_bits)


def resample_poly_fixed(
    x_u8, h, up: int, down: int, qformat: QFormat = QFormat()
) -> jax.Array:
    """Bit-exact fixed-point polyphase resampler on device."""
    if not qformat.int32_exact:
        raise ValueError(
            f"acc_bits={qformat.acc_bits} > 32 is not representable in the "
            "int32 device path; use resample_poly_fixed_golden."
        )
    h_fixed = qformat.quantize_coeffs(np.asarray(h)).astype(np.int64)
    x_i32 = jnp.asarray(x_u8, jnp.int32)
    n = int(x_i32.shape[1])
    out_len, _, _, center = _plan(n, up, down, h_fixed.size)
    taps = _polyphase_taps(h_fixed, up)
    plan = _phase_plan(up, down, center, out_len)
    taps_key = (taps.tobytes(), taps.shape)
    return _poly_fixed_core(
        x_i32, plan, up, down, int(taps.shape[1]), out_len,
        qformat.frac_bits, qformat.acc_bits, taps_key,
    )
