"""SPMD collective pipeline: stages on a mesh axis, ppermute transport.

The second, fully-compiled realization of the PP axis (SURVEY.md §2.3):
where ``pipeline_parallel.PipelinedChain`` orchestrates per-device jits
from the host (flexible shapes, async-dispatch overlap), this module
compiles the ENTIRE pipeline schedule into one ``shard_map``-ed XLA
program — the GPipe-style schedule as pure dataflow:

- the mesh axis ``stage`` holds one pipeline stage per device;
- one ``lax.fori_loop`` runs ``T + S - 1`` ticks; at tick ``t`` device
  ``s`` processes microbatch ``t - s`` (the 1F schedule);
- activations move to the next stage with a single
  ``lax.ppermute`` per tick — the halo pattern's cousin;
- stage heterogeneity comes from the stage index (``lax.axis_index``):
  the stage function receives it and selects parameters/behavior
  (``lax.switch``, gathered parameter banks, ...) — SPMD-style, every
  device runs the same program.

All stages must therefore be shape-preserving over the activation
(pad/crop inside the stage function if needed).  Inputs are replicated;
outputs are collected at the last stage and broadcast back (``psum`` of
a masked buffer), so the result is replicated like any shard_map output
with ``P()`` specs.

No host round-trips, no per-tick dispatch: on a real slice the whole
schedule is one XLA program whose ppermutes overlap with the next tick's
compute under XLA's async collectives.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P


def make_spmd_pipeline(
    stage_fn: Callable,
    *,
    mesh: Mesh,
    axis: str = "stage",
) -> Callable:
    """Build the jitted pipelined runner (reusable across calls).

    Returns ``run(microbatches) -> outputs`` holding ONE ``jax.jit``
    object: repeated same-shape invocations hit the compile cache
    (constructing the closure per call — what :func:`spmd_pipeline`
    does for convenience — re-traces every time, which distorts
    benchmarks).
    """
    num_stages = int(mesh.shape[axis])

    @partial(shard_map, mesh=mesh, in_specs=(P(),), out_specs=P())
    def run(mb):
        num_batches = mb.shape[0]
        s = jax.lax.axis_index(axis)
        is_first = s == 0
        is_last = s == num_stages - 1

        def tick(t, carry):
            x, outs = carry
            # Stage 0 injects microbatch t (guarded past the stream end).
            inj = mb[jnp.minimum(t, num_batches - 1)]
            take = is_first & (t < num_batches)
            x = jnp.where(take, inj, x)

            y = stage_fn(s, x)

            # Last stage retires microbatch m = t - (S - 1).
            m = t - (num_stages - 1)
            write = is_last & (m >= 0)
            idx = jnp.clip(m, 0, num_batches - 1)
            current = jax.lax.dynamic_index_in_dim(outs, idx, 0,
                                                   keepdims=False)
            outs = jax.lax.dynamic_update_index_in_dim(
                outs, jnp.where(write, y, current), idx, 0
            )

            # Ship activations one stage to the right (no wraparound:
            # stage 0's next value comes from injection, the last
            # stage's output was just retired).
            x_next = jax.lax.ppermute(
                y, axis, [(i, i + 1) for i in range(num_stages - 1)]
            )
            return (x_next, outs)

        # The loop body produces stage-varying values (axis_index masks,
        # ppermute), so the initial carry must be marked varying too.
        x0 = jax.lax.pcast(jnp.zeros(mb.shape[1:], mb.dtype), (axis,),
                           to="varying")
        outs0 = jax.lax.pcast(jnp.zeros_like(mb), (axis,), to="varying")
        _, outs = jax.lax.fori_loop(
            0, num_batches + num_stages - 1, tick, (x0, outs0)
        )
        # Replicate the last stage's buffer to every device.
        keep = jnp.where(is_last, jnp.ones((), outs.dtype),
                         jnp.zeros((), outs.dtype))
        return jax.lax.psum(outs * keep, axis)

    return jax.jit(run)


def spmd_pipeline(
    stage_fn: Callable,
    microbatches: jax.Array,
    *,
    mesh: Mesh,
    axis: str = "stage",
) -> jax.Array:
    """Run ``microbatches`` through a device-pipelined stage chain.

    Args:
        stage_fn: ``(stage_index, x) -> y`` with ``y.shape == x.shape``;
            ``stage_index`` is a traced int32 scalar in ``[0, S)``.
        microbatches: ``(T, *item_shape)`` array; microbatch ``t`` enters
            stage 0 at tick ``t``.
        mesh: mesh whose ``axis`` dimension (size S) hosts the stages.
        axis: mesh axis name holding the pipeline stages.

    Returns:
        ``(T, *item_shape)`` outputs (replicated), bit-identical to
        applying stages ``0..S-1`` sequentially to each microbatch.
    """
    microbatches = jnp.asarray(microbatches)
    if int(microbatches.shape[0]) == 0:
        return microbatches
    return make_spmd_pipeline(stage_fn, mesh=mesh, axis=axis)(microbatches)
