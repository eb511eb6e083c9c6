"""Flagship DSP chain: resample → channelize → FM demod.

BASELINE.json config 5 ("full chain: polyphase 2/3 resample + 63-tap
channelizer + FM demod").  The chain operates on complex baseband rows
carried as split I/Q float planes of shape (channels, time) and is pure
row-wise dataflow, so it shards as data parallelism over a mesh axis;
the time-sharded variants of the FIR stages live in ``parallel/``.
All three stages are plain ``jnp`` left to XLA: the polyphase slice
resampler, FFT overlap-save, and the phase discriminator.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from warmup_fir_filter_tpu.models.golden import fir1d_ideal_golden_rows
from warmup_fir_filter_tpu.ops.demod import fm_demodulate, fm_demodulate_golden
from warmup_fir_filter_tpu.ops.fftfilt import fir_overlap_save
from warmup_fir_filter_tpu.ops.fir1d import fir1d_ideal_rows_jnp
from warmup_fir_filter_tpu.ops.resample import (
    design_lowpass,
    resample_poly,
    resample_poly_golden,
)


@dataclasses.dataclass(frozen=True)
class ChainConfig:
    """Static configuration of the DSP chain."""

    resample_up: int = 2
    resample_down: int = 3
    resample_taps: int = 63
    channelizer_taps: int = 63
    channelizer_cutoff: float = 0.25
    demod_k_f: float = 0.05
    #: True: the channelizer is the float FFT overlap-save filter
    #: (``ops/fftfilt.py``); False: the direct f32 shift-MAC FIR
    #: (``ops/fir1d.py``).
    use_fft_channelizer: bool = True

    def resample_filter(self) -> np.ndarray:
        cutoff = 0.9 / max(self.resample_up, self.resample_down)
        return design_lowpass(self.resample_taps, cutoff,
                              gain=self.resample_up)

    def channelizer_filter(self) -> np.ndarray:
        return design_lowpass(self.channelizer_taps, self.channelizer_cutoff)


def chain_forward(re, im, config: ChainConfig = ChainConfig()) -> jax.Array:
    """Run the full chain on (C, T) I/Q rows → (C, T') message rows.

    Both I/Q planes go through each filter stage as one (2C, T) row
    batch: rows are independent, so this is one call per stage.
    """
    channels = jnp.asarray(re).shape[0]
    both = jnp.concatenate([jnp.asarray(re, jnp.float32),
                            jnp.asarray(im, jnp.float32)], axis=0)
    both = resample_poly(both, config.resample_filter(), config.resample_up,
                         config.resample_down)
    h_ch = config.channelizer_filter()
    if config.use_fft_channelizer:
        both = fir_overlap_save(both, h_ch)
    else:
        both = fir1d_ideal_rows_jnp(both, h_ch)
    return fm_demodulate(both[:channels], both[channels:], config.demod_k_f)


def chain_forward_golden(re, im,
                         config: ChainConfig = ChainConfig()) -> np.ndarray:
    """Float64 host oracle of :func:`chain_forward`.

    Polyphase resample → direct-form channelizer FIR → discriminator, all
    in float64 (either channelizer of the device path computes the same
    same-mode FIR).
    """
    channels = np.asarray(re).shape[0]
    both = resample_poly_golden(np.concatenate([re, im]),
                                config.resample_filter(), config.resample_up,
                                config.resample_down)
    both = fir1d_ideal_golden_rows(both, config.channelizer_filter())
    return fm_demodulate_golden(both[:channels], both[channels:],
                                config.demod_k_f)


def chain_forward_sharded(
    re,
    im,
    config: ChainConfig = ChainConfig(),
    *,
    mesh: Mesh,
    channel_axis: str = "data",
) -> jax.Array:
    """Data-parallel chain: channels sharded over ``channel_axis``.

    Every stage is row-independent, so each device runs the full chain
    on its local channel rows under ``shard_map`` and the result matches
    the single-device run row for row (asserted in tests).
    """
    channels = np.asarray(re).shape[0]
    if channels % mesh.shape[channel_axis]:
        raise ValueError(
            f"channels={channels} not divisible by mesh axis "
            f"{channel_axis!r}={mesh.shape[channel_axis]}."
        )
    spec = P(channel_axis, None)
    sharding = NamedSharding(mesh, spec)
    re_s = jax.device_put(np.asarray(re, np.float32), sharding)
    im_s = jax.device_put(np.asarray(im, np.float32), sharding)

    @partial(jax.shard_map, mesh=mesh, in_specs=(spec, spec),
             out_specs=spec)
    def _run(re_in, im_in):
        return chain_forward(re_in, im_in, config)

    return jax.jit(_run)(re_s, im_s)
