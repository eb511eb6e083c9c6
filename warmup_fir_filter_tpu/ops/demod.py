"""FM demodulation (the north-star chain's final stage).

Quadrature (polar-discriminator) FM demod over complex baseband rows:

    y[n] = angle( x[n] · conj(x[n-1]) ) / (2π · k_f)

which recovers the instantaneous frequency normalized by the deviation
``k_f`` (cycles/sample per unit message).  Complex samples are carried as
separate I/Q float planes — real arrays on the device (and
the realization of the reference's ``MyComplex`` scaffolding,
``lib/mycomplex.h:10-41``, as data layout rather than a class).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def fm_modulate(message: np.ndarray, k_f: float) -> tuple[np.ndarray, np.ndarray]:
    """Test-signal generator: message rows → complex baseband I/Q rows.

    ``phase[n] = 2π·k_f·Σ_{m≤n} message[m]`` (host-side, float64).
    """
    msg = np.asarray(message, np.float64)
    phase = 2.0 * np.pi * k_f * np.cumsum(msg, axis=-1)
    return np.cos(phase), np.sin(phase)


@partial(jax.jit, static_argnames=())
def _fm_demod_core(i_q: tuple[jnp.ndarray, jnp.ndarray], inv_gain: jnp.ndarray):
    re, im = i_q
    # x[n] · conj(x[n-1]) with x[-1] treated as x[0] (zero first output).
    re_prev = jnp.concatenate([re[:, :1], re[:, :-1]], axis=1)
    im_prev = jnp.concatenate([im[:, :1], im[:, :-1]], axis=1)
    dot = re * re_prev + im * im_prev
    cross = im * re_prev - re * im_prev
    # Sample 0 is exactly 0: with fused multiply-adds ``cross`` there is
    # one product's rounding error, not 0.
    return (jnp.arctan2(cross, dot) * inv_gain).at[:, 0].set(0.0)


def fm_demodulate(re, im, k_f: float) -> jax.Array:
    """Demodulate complex baseband rows; returns message estimate rows.

    First output sample of each row is 0 (no previous sample).
    """
    if k_f <= 0:
        raise ValueError(f"k_f={k_f} must be > 0")
    re = jnp.asarray(re, jnp.float32)
    im = jnp.asarray(im, jnp.float32)
    inv_gain = jnp.float32(1.0 / (2.0 * np.pi * k_f))
    return _fm_demod_core((re, im), inv_gain)


def fm_demodulate_golden(re, im, k_f: float) -> np.ndarray:
    """Float64 host oracle of the same discriminator."""
    if k_f <= 0:
        raise ValueError(f"k_f={k_f} must be > 0")
    re = np.asarray(re, np.float64)
    im = np.asarray(im, np.float64)
    re_prev = np.concatenate([re[:, :1], re[:, :-1]], axis=1)
    im_prev = np.concatenate([im[:, :1], im[:, :-1]], axis=1)
    dot = re * re_prev + im * im_prev
    cross = im * re_prev - re * im_prev
    return np.arctan2(cross, dot) / (2.0 * np.pi * k_f)
