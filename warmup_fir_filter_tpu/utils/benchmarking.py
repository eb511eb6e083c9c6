"""Chained-slope throughput timing for shape-preserving u8 steps.

The step is applied K times back to back inside one ``lax.fori_loop``
jit, for two chain lengths; the slope between the two times is the
per-application time with the fixed per-call cost (dispatch, transfer
of the probe) cancelled.  A fresh per-call seed is XOR-ed into the
input in-graph so no call sees the previous call's data.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
from jax import lax


def chained_throughput(
    step_fn,
    x_dev,
    *,
    chain_short: int = 8,
    chain_long: int = 104,
    repeats: int = 5,
    best_of: int = 1,
) -> dict:
    """Samples/s of a shape-preserving uint8 step function.

    Args:
        step_fn: u8 array → u8 array of the same shape (applied K times
            back-to-back on device).
        x_dev: device-resident uint8 input.
        best_of: number of independent timing sweeps (compiled closures
            are reused, so extra sweeps cost only device time).  The
            returned ``seconds_per_apply`` is the best sweep; all sweep
            slopes are returned under ``"slopes"`` so callers can report
            the run-to-run spread.

    Returns:
        dict with per-application seconds, samples/s, and raw timings.
    """

    import numpy as np

    def make(k):
        @jax.jit
        def run(x0, seed_u8):
            x0 = x0 ^ seed_u8  # defeat value-level result caching
            y = lax.fori_loop(0, k, lambda i, y: step_fn(y), x0)
            # Return a tiny probe slice: downloading it waits for the
            # whole chain to finish.
            return y[:1, :128]

        return run

    runs = {k: make(k) for k in (chain_short, chain_long)}
    for k, run in runs.items():
        np.asarray(run(x_dev, jnp.uint8(255)))  # compile + warm + sync

    seed_counter = 0
    slopes: list[float] = []
    last_times: dict[int, float] = {}
    for _ in range(max(1, best_of)):
        times: dict[int, float] = {}
        for k, run in runs.items():
            best = float("inf")
            for _ in range(repeats):
                seed_counter = (seed_counter + 1) % 255
                seed = jnp.uint8(seed_counter)
                t0 = time.perf_counter()
                np.asarray(run(x_dev, seed))  # download forces execution
                best = min(best, time.perf_counter() - t0)
            times[k] = best
        slopes.append(
            (times[chain_long] - times[chain_short])
            / (chain_long - chain_short)
        )
        last_times = times

    positive = [s for s in slopes if s > 0]
    per_apply = min(positive) if positive else slopes[0]
    med = float(np.median(positive)) if positive else slopes[0]
    num_samples = 1
    for dim in x_dev.shape:
        num_samples *= dim
    return {
        # Headline = best-of-N sweeps; the median fields are unbiased by
        # the best-of choice.
        "seconds_per_apply": per_apply,
        "samples_per_second": num_samples / per_apply if per_apply > 0 else 0.0,
        "seconds_per_apply_median": med,
        "samples_per_second_median": num_samples / med if med > 0 else 0.0,
        "best_of": max(1, best_of),
        "times": last_times,
        "slopes": slopes,
        "num_samples": num_samples,
    }
