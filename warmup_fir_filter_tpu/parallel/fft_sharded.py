"""Time-sharded FFT overlap-save over a device mesh.

BASELINE.json config 4: "FFT overlap-save equivalent of 63-tap FIR on
16 channels x 10M samples, sharded across chips with halo exchange."
Each device owns a T/n time block of every channel, exchanges the
asymmetric same-mode halo with its neighbors (``ppermute``, via
:func:`parallel.halo.exchange_halo_1d`), and runs the *local* overlap-
save pipeline on its extended block.  Each shard frames its FFT blocks
from its own offset, so the result matches the unsharded FFT path to
float rounding, not bit for bit.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from warmup_fir_filter_tpu.ops.fftfilt import frame_overlap, pick_nfft
from warmup_fir_filter_tpu.parallel.halo import exchange_halo_1d


def make_overlap_save_step(
    h,
    *,
    mesh: Mesh,
    time_axis: str = "time",
    channel_axis: str = "data",
    nfft: int | None = None,
    steps: int = 1,
):
    """Build a reusable jitted sharded overlap-save step.

    Returns ``run(x_sharded, seed=0.0) -> (C, T) float32`` — a callable
    holding ONE ``jax.jit`` object, so repeated invocations hit the
    compile cache instead of re-tracing.

    ``steps > 1`` chains the filter that many times inside the jit
    (shape-preserving (C, T) → (C, T), halo exchange per application),
    for timing by the slope between two chain lengths
    (``utils/benchmarking.py``).  ``seed`` is added to the input
    in-graph so repeated timed calls see fresh data.
    """
    h64 = np.asarray(h, np.float64)
    num_taps = int(h64.size)
    nfft = pick_nfft(num_taps) if nfft is None else nfft
    if nfft < num_taps:
        raise ValueError(f"nfft={nfft} must be >= num_taps={num_taps}")
    center = num_taps // 2
    left_w, right_w = num_taps - 1 - center, center
    step = nfft - (num_taps - 1)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(channel_axis, time_axis), P(), P()),
        out_specs=P(channel_axis, time_axis),
    )
    def _sharded(x_loc, h_f32, seed):
        local_time = x_loc.shape[1]
        num_blocks = -(-local_time // step)

        def apply(y_loc):
            # Halo exchange gives each shard the same neighborhood it
            # would see inside the global zero-padded stream.
            x_ext = exchange_halo_1d(
                y_loc, axis_name=time_axis, left_width=left_w,
                right_width=right_w,
            )
            # Local overlap-save over the extended block: segment b
            # covers ext indices [b·step, b·step + nfft); local output t
            # lives at ext index t + left_w, and y[t] needs
            # ext[t ... t + L - 1], i.e. the standard
            # discard-first-(L-1) alignment.  Last segment ends at
            # (num_blocks-1)·step + nfft = num_blocks·step + (L-1) in
            # extended coordinates.
            pad_right = num_blocks * step + (num_taps - 1) - x_ext.shape[1]
            xp = jnp.pad(x_ext, ((0, 0), (0, max(0, pad_right))))
            segments = frame_overlap(xp, nfft, step, num_blocks)
            # The filter spectrum is built in-graph from the real taps.
            h_freq = jnp.fft.rfft(h_f32, n=nfft)
            spec = jnp.fft.rfft(segments, axis=-1)
            y = jnp.fft.irfft(spec * h_freq, n=nfft, axis=-1)
            valid = y[:, :, num_taps - 1:]
            out = valid.reshape(y_loc.shape[0], num_blocks * step)
            return out[:, :local_time]

        y0 = x_loc.astype(jnp.float32) + seed
        if steps == 1:
            return apply(y0)
        from jax import lax

        return lax.fori_loop(0, steps, lambda i, y: apply(y), y0)

    jitted = jax.jit(_sharded)
    h_f32 = jnp.asarray(h64, jnp.float32)

    def run(x_sharded, seed: float = 0.0):
        return jitted(x_sharded, h_f32, jnp.float32(seed))

    return run


def fir_overlap_save_sharded(
    x,
    h,
    *,
    mesh: Mesh,
    time_axis: str = "time",
    channel_axis: str = "data",
    nfft: int | None = None,
) -> jax.Array:
    """Float32 same-mode FIR via FFT overlap-save, (C, T) sharded C×T."""
    run = make_overlap_save_step(
        h, mesh=mesh, time_axis=time_axis, channel_axis=channel_axis,
        nfft=nfft,
    )
    x = x if isinstance(x, jax.Array) else np.asarray(x)
    channels, time = x.shape
    for size, axis in ((channels, channel_axis), (time, time_axis)):
        if size % mesh.shape[axis]:
            raise ValueError(
                f"Dimension {size} not divisible by mesh axis "
                f"{axis!r}={mesh.shape[axis]}."
            )
    x_sharded = jax.device_put(
        x, NamedSharding(mesh, P(channel_axis, time_axis))
    )
    return run(x_sharded)
