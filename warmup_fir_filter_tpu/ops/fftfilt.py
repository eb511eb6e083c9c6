"""FFT overlap-save filtering: the long-tap fast path.

BASELINE.json config 4: a 63-tap FIR applied to multi-channel streams via
block FFTs instead of direct MACs.  The float FFT path is the *model*;
its agreement contract with the bit-exact fixed *sim* path is an SNR
bound, not bit-equality (SURVEY.md §7.3 item 4) — mirroring the
reference's clip-aware tolerance judgment for high-gain filters
(``fir_1d_3tap_compare_analysis_v1.md:221-228``).

Alignment: the framework-wide same-mode contract ``y[n] = Σ_k h[k] ·
x[n - k + center]`` is kept by reading each length-``nfft`` segment
starting at ``n0 - (L - 1) + center`` in the zero-padded stream and
discarding the first ``L - 1`` circular-convolution outputs (the
overlap-save discard region).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from warmup_fir_filter_tpu.ops.qformat import QFormat


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def pick_nfft(num_taps: int) -> int:
    """Block size heuristic: ≥8× taps keeps discard overhead ≤ ~12%."""
    return max(256, _next_pow2(8 * num_taps))


def frame_overlap(xp, nfft: int, step: int, num_blocks: int) -> jnp.ndarray:
    """(C, T) → (C, num_blocks, nfft) overlapping frames, hop ``step``.

    Gather-free framing: the stream is cut into ``step``-sized hops
    with a reshape and each frame is the concatenation of
    ``ceil(nfft/step)`` consecutive hops, so no index gather is needed.
    """
    channels = xp.shape[0]
    m = -(-nfft // step)  # hops spanned by one frame
    total = (num_blocks + m) * step
    xp = jnp.pad(xp, ((0, 0), (0, total - xp.shape[1])))
    hops = xp.reshape(channels, num_blocks + m, step)
    parts = [hops[:, i : i + num_blocks, :] for i in range(m)]
    return jnp.concatenate(parts, axis=-1)[:, :, :nfft]


@partial(jax.jit, static_argnames=("num_taps", "nfft", "time"))
def _overlap_save_core(x_f32, h_f32, num_taps, nfft, time):
    channels = x_f32.shape[0]
    center = num_taps // 2
    step = nfft - (num_taps - 1)
    num_blocks = -(-time // step)

    # Zero-pad so every segment read is in bounds:
    # segment b starts at b*step - (L-1) + center in the original stream.
    left = num_taps - 1 - center
    right = num_blocks * step - time + center + (num_taps - 1)
    xp = jnp.pad(x_f32, ((0, 0), (left, right)))

    segments = frame_overlap(xp, nfft, step, num_blocks)  # (C, B, nfft)

    h_freq = jnp.fft.rfft(h_f32, n=nfft)  # (nfft//2+1,)
    spec = jnp.fft.rfft(segments, axis=-1)
    y_blocks = jnp.fft.irfft(spec * h_freq, n=nfft, axis=-1)

    # Overlap-save discard: first L-1 samples of each block are circular.
    valid = y_blocks[:, :, num_taps - 1 :]  # (C, B, step)
    return valid.reshape(channels, num_blocks * step)[:, :time]


def fir_overlap_save(x, h, *, nfft: int | None = None) -> jax.Array:
    """Float32 same-mode FIR via FFT overlap-save over (C, T) rows."""
    h64 = np.asarray(h, np.float64)
    num_taps = int(h64.size)
    nfft = pick_nfft(num_taps) if nfft is None else nfft
    if nfft < num_taps:
        raise ValueError(f"nfft={nfft} must be >= num_taps={num_taps}")
    x_f32 = jnp.asarray(x, jnp.float32)
    return _overlap_save_core(
        x_f32, jnp.asarray(h64, jnp.float32), num_taps, nfft,
        int(x_f32.shape[1])
    )


def fir_overlap_save_quantized(
    x_u8, h, qformat: QFormat = QFormat(), *, nfft: int | None = None
) -> jax.Array:
    """FFT path + hardware output stage → uint8, comparable to the sim.

    Applies the golden output contract (round-half-up at the implied
    fixed-point scale, then saturate) to the float FFT result, using the
    *quantized* coefficients so the only divergence from the bit-exact
    sim path is FFT arithmetic noise — bounded in tests by an SNR floor.
    """
    h_fixed = qformat.quantize_coeffs(np.asarray(h)).astype(np.float64)
    h_real = h_fixed / qformat.scale
    y = fir_overlap_save(x_u8, h_real, nfft=nfft)
    return jnp.clip(jnp.floor(y + 0.5), 0, 255).astype(jnp.uint8)


def snr_db(reference: np.ndarray, test: np.ndarray) -> float:
    """Signal-to-error ratio in dB between two outputs."""
    ref = np.asarray(reference, np.float64)
    err = np.asarray(test, np.float64) - ref
    power = float(np.mean(ref**2))
    noise = float(np.mean(err**2))
    if noise == 0.0:
        return float("inf")
    return float(10.0 * np.log10(power / noise)) if power > 0 else float("-inf")
