"""Channel↔time resharding (the Ulysses analogue for DSP).

A (C, T) stream bank can live on a mesh axis in two layouts:

- **channel-sharded**: each device owns C/n whole channels — right for
  per-channel FIR/demod (no halos at all);
- **time-sharded**: each device owns a T/n time block of every channel —
  right for FFT overlap-save and halo-exchange convolution along time.

``jax.lax.all_to_all`` inside ``shard_map`` flips between them in one
collective (SURVEY.md §2.3 "Ulysses-style").
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map


def channel_to_time(x, *, mesh: Mesh, axis: str = "data") -> jax.Array:
    """Reshard (C, T): channel-sharded → time-sharded.

    Input sharding P(axis, None) → output sharding P(None, axis), moved
    with a single all_to_all instead of a host round-trip.
    """
    num = mesh.shape[axis]
    channels, time = x.shape
    if channels % num or time % num:
        raise ValueError(
            f"C={channels} and T={time} must both divide mesh axis "
            f"{axis!r}={num}."
        )

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=P(axis, None),
        out_specs=P(None, axis),
    )
    def _flip(x_loc):  # (C/n, T) → (C, T/n)
        # Split the local rows into n time-blocks; send block d to device
        # d; concatenate the n received (C/n, T/n) pieces along channels.
        blocks = x_loc.reshape(x_loc.shape[0], num, time // num)
        out = jax.lax.all_to_all(
            blocks, axis, split_axis=1, concat_axis=0, tiled=True
        )
        return out.reshape(channels, time // num)

    return jax.jit(_flip)(
        jax.device_put(x, NamedSharding(mesh, P(axis, None)))
    )


def time_to_channel(x, *, mesh: Mesh, axis: str = "data") -> jax.Array:
    """Reshard (C, T): time-sharded → channel-sharded (inverse flip)."""
    num = mesh.shape[axis]
    channels, time = x.shape
    if channels % num or time % num:
        raise ValueError(
            f"C={channels} and T={time} must both divide mesh axis "
            f"{axis!r}={num}."
        )

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=P(None, axis),
        out_specs=P(axis, None),
    )
    def _flip(x_loc):  # (C, T/n) → (C/n, T)
        blocks = x_loc.reshape(num, channels // num, x_loc.shape[1])
        out = jax.lax.all_to_all(
            blocks, axis, split_axis=0, concat_axis=2, tiled=True
        )
        return out.reshape(channels // num, time)

    return jax.jit(_flip)(
        jax.device_put(x, NamedSharding(mesh, P(None, axis)))
    )
