"""Overlap-save halo exchange: sequence-parallel FIR over a device mesh.

The convolution analogue of ring attention (SURVEY.md §2.3): a long
stream is sharded along time across mesh devices; each shard exchanges
``L-1`` boundary samples with its neighbors via ``jax.lax.ppermute``
(NVLink between the cards of one host) and then runs the *same*
pre-haloed fixed-point core
as the single-chip path, so shard boundaries are bit-identical to the
global zero-padded computation.

Halo asymmetry follows same-mode center alignment (``center = L // 2``,
``fir_1d_ref.py:49-60``): each shard needs ``L-1-center`` trailing
samples from its left neighbor and ``center`` leading samples from its
right neighbor.  Edge shards receive zeros — exactly ``ppermute``'s
semantics for unmatched destinations, which realizes the global zero-pad
boundary (SURVEY.md §7.3 item 3).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from warmup_fir_filter_tpu.ops.fir1d import fixed_fir_prehaloed_i32
from warmup_fir_filter_tpu.ops.fir2d import fixed_fir2d_prehaloed_i32
from warmup_fir_filter_tpu.ops.qformat import QFormat


def exchange_halo_1d(
    x_local: jnp.ndarray,
    *,
    axis_name: str,
    left_width: int,
    right_width: int,
) -> jnp.ndarray:
    """Attach neighbor halos along the last axis of a sharded block.

    Must be called inside ``shard_map``.  Returns the local block extended
    to ``N_local + left_width + right_width`` columns; out-of-mesh halos
    are zero (global zero-pad semantics).
    """
    num = jax.lax.axis_size(axis_name)
    parts = []
    if left_width:
        tail = x_local[..., -left_width:]
        # Device i sends its tail to device i+1; device 0 receives zeros.
        left = jax.lax.ppermute(
            tail, axis_name, [(i, i + 1) for i in range(num - 1)]
        )
        parts.append(left)
    parts.append(x_local)
    if right_width:
        head = x_local[..., :right_width]
        # Device i sends its head to device i-1; last device receives zeros.
        right = jax.lax.ppermute(
            head, axis_name, [(i, i - 1) for i in range(1, num)]
        )
        parts.append(right)
    return jnp.concatenate(parts, axis=-1) if len(parts) > 1 else x_local


def fir1d_fixed_sharded(
    x_u8,
    h,
    qformat: QFormat = QFormat(),
    *,
    mesh: Mesh,
    channel_axis: str = "data",
    time_axis: str = "time",
) -> jax.Array:
    """Bit-exact fixed-point FIR over (C, T), sharded C×T across a mesh.

    - channels (C) shard over ``channel_axis``: pure data parallelism
      (independent rows — the reference's independent-case structure,
      ``gen_fixed_output.py:88-105``);
    - time (T) shards over ``time_axis``: sequence parallelism with
      ppermute halo exchange.

    Requires C and T divisible by the respective mesh axis sizes (pad at
    the caller for ragged streams).
    """
    if not qformat.int32_exact:
        raise ValueError(
            f"acc_bits={qformat.acc_bits} > 32 is not representable in the "
            "int32 device path."
        )
    h_fixed = qformat.quantize_coeffs(h).astype(np.int32)
    num_taps = int(h_fixed.size)
    center = num_taps // 2
    left_w, right_w = num_taps - 1 - center, center

    # Shards go straight from the host (or their current placement) to
    # their devices; the int32 widening happens per shard in the jit.
    x = x_u8 if isinstance(x_u8, jax.Array) else np.asarray(x_u8)
    channels, time = x.shape
    for size, axis in ((channels, channel_axis), (time, time_axis)):
        if size % mesh.shape[axis]:
            raise ValueError(
                f"Dimension {size} not divisible by mesh axis "
                f"{axis!r}={mesh.shape[axis]}."
            )

    core = partial(fixed_fir_prehaloed_i32, num_taps=num_taps,
                   frac_bits=qformat.frac_bits, acc_bits=qformat.acc_bits)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(channel_axis, time_axis), P()),
        out_specs=P(channel_axis, time_axis),
    )
    def _step(x_loc, h_i32):
        x_loc = x_loc.astype(jnp.int32)
        # Comm/compute overlap (r4): issue the halo ppermutes FIRST,
        # compute the interior — the N−(L−1) outputs that need no
        # neighbor data — while they fly, then finish the two boundary
        # strips from the received halos.  Same core op on sub-windows
        # ⇒ bit-identical to the exchange-then-compute form; XLA's
        # latency-hiding scheduler can start the interior between
        # collective-permute-start and -done.
        if x_loc.shape[-1] < num_taps:
            # Shard too narrow for an interior: plain exchange+compute.
            x_ext = exchange_halo_1d(
                x_loc, axis_name=time_axis, left_width=left_w,
                right_width=right_w)
            return core(x_ext, h_i32)
        num = jax.lax.axis_size(time_axis)
        left = right = None
        if left_w:
            left = jax.lax.ppermute(
                x_loc[..., -left_w:], time_axis,
                [(i, i + 1) for i in range(num - 1)])
        if right_w:
            right = jax.lax.ppermute(
                x_loc[..., :right_w], time_axis,
                [(i, i - 1) for i in range(1, num)])
        interior = core(x_loc, h_i32)
        parts = []
        if left_w:
            left_ext = jnp.concatenate(
                [left, x_loc[..., : left_w + right_w]], axis=-1)
            parts.append(core(left_ext, h_i32))
        parts.append(interior)
        if right_w:
            right_ext = jnp.concatenate(
                [x_loc[..., x_loc.shape[-1] - (left_w + right_w):], right],
                axis=-1)
            parts.append(core(right_ext, h_i32))
        return jnp.concatenate(parts, axis=-1) if len(parts) > 1 \
            else interior

    x_sharded = jax.device_put(
        x, NamedSharding(mesh, P(channel_axis, time_axis))
    )
    return jax.jit(_step)(x_sharded, jnp.asarray(h_fixed))


def exchange_halo_2d(
    x_local: jnp.ndarray,
    *,
    row_axis: str,
    col_axis: str,
    top_width: int,
    bottom_width: int,
    left_width: int,
    right_width: int,
) -> jnp.ndarray:
    """Attach neighbor halos on both image axes of a 2-D-sharded block.

    Must be called inside ``shard_map``.  Two sequential 1-D exchanges:
    rows first, then columns of the row-EXTENDED block — the column
    phase thereby also carries the four corner halos, so no explicit
    diagonal ``ppermute`` is needed.  Out-of-mesh halos are zero
    (global zero-pad semantics).
    """
    num_rows = jax.lax.axis_size(row_axis)
    parts = []
    if top_width:
        tail = x_local[-top_width:, :]
        # Device i sends its bottom rows to device i+1; row-shard 0
        # receives zeros.
        parts.append(jax.lax.ppermute(
            tail, row_axis, [(i, i + 1) for i in range(num_rows - 1)]
        ))
    parts.append(x_local)
    if bottom_width:
        head = x_local[:bottom_width, :]
        parts.append(jax.lax.ppermute(
            head, row_axis, [(i, i - 1) for i in range(1, num_rows)]
        ))
    x_rows = jnp.concatenate(parts, axis=0) if len(parts) > 1 else x_local
    return exchange_halo_1d(
        x_rows, axis_name=col_axis, left_width=left_width,
        right_width=right_width,
    )


def fir2d_fixed_sharded(
    x_u8,
    h,
    qformat: QFormat = QFormat(),
    *,
    mesh: Mesh,
    row_axis: str = "data",
    col_axis: str = "time",
) -> jax.Array:
    """Bit-exact fixed 2-D FIR over an (H, W) image, sharded H×W.

    The 2-D extension of :func:`fir1d_fixed_sharded`: image rows shard
    over ``row_axis`` and columns over ``col_axis``; every shard
    exchanges its ``(Lr-1, Lc-1)`` same-mode-asymmetric halos (corners
    included) with its mesh neighbors and runs the pre-haloed
    int32 core (``ops/fir2d.py::fixed_fir2d_prehaloed_i32``), so shard
    boundaries are bit-identical to the global zero-padded golden
    contract (``fir2d_fixed_golden``).

    Requires H and W divisible by the respective mesh axis sizes (pad
    at the caller for ragged images).
    """
    if not qformat.int32_exact:
        raise ValueError(
            f"acc_bits={qformat.acc_bits} > 32 is not representable in the "
            "int32 device path."
        )
    h_fixed = qformat.quantize_coeffs(np.asarray(h)).astype(np.int32)
    taps_r, taps_c = h_fixed.shape
    center_r, center_c = taps_r // 2, taps_c // 2
    top_w, bottom_w = taps_r - 1 - center_r, center_r
    left_w, right_w = taps_c - 1 - center_c, center_c

    x = x_u8 if isinstance(x_u8, jax.Array) else np.asarray(x_u8)
    rows, cols = x.shape
    for size, axis in ((rows, row_axis), (cols, col_axis)):
        if size % mesh.shape[axis]:
            raise ValueError(
                f"Dimension {size} not divisible by mesh axis "
                f"{axis!r}={mesh.shape[axis]}."
            )

    core2d = partial(fixed_fir2d_prehaloed_i32, taps_r=taps_r,
                     taps_c=taps_c, frac_bits=qformat.frac_bits,
                     acc_bits=qformat.acc_bits)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(row_axis, col_axis), P()),
        out_specs=P(row_axis, col_axis),
    )
    def _step(x_loc, h_i32):
        x_loc = x_loc.astype(jnp.int32)
        h_loc, w_loc = x_loc.shape
        if h_loc < taps_r or w_loc < taps_c:
            # Shard too small for an interior: plain exchange+compute.
            x_ext = exchange_halo_2d(
                x_loc, row_axis=row_axis, col_axis=col_axis,
                top_width=top_w, bottom_width=bottom_w,
                left_width=left_w, right_width=right_w,
            )
            return core2d(x_ext, h_i32)
        # Comm/compute overlap (r4, 1-D split generalized): start the
        # two-phase halo exchange, compute the fully-interior region —
        # outputs untouched by any halo — while it flies, then finish
        # the four boundary strips from slices of the extended block.
        # Same core on sub-windows ⇒ bit-identical assembly.
        x_ext = exchange_halo_2d(
            x_loc, row_axis=row_axis, col_axis=col_axis,
            top_width=top_w, bottom_width=bottom_w,
            left_width=left_w, right_width=right_w,
        )
        interior = core2d(x_loc, h_i32)  # (H−(Lr−1), W−(Lc−1)) outputs
        dr, dc = taps_r - 1, taps_c - 1
        # Top/bottom strips span all W output columns; left/right strips
        # cover the interior rows only.
        top_strip = core2d(x_ext[: top_w + dr, :], h_i32)
        bottom_strip = core2d(x_ext[top_w + h_loc - dr:, :], h_i32)
        left_strip = core2d(
            x_ext[top_w : top_w + h_loc, : left_w + dc], h_i32)
        right_strip = core2d(
            x_ext[top_w : top_w + h_loc, left_w + w_loc - dc:], h_i32)
        middle = jnp.concatenate([left_strip, interior, right_strip],
                                 axis=-1)
        return jnp.concatenate([top_strip, middle, bottom_strip], axis=0)

    x_sharded = jax.device_put(
        x, NamedSharding(mesh, P(row_axis, col_axis))
    )
    return jax.jit(_step)(x_sharded, jnp.asarray(h_fixed))
