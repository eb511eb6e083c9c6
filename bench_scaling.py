"""Multi-device scaling benchmark for the sharded fixed-point FIR.

BASELINE.json target: ≥90% scaling efficiency from 1 chip to N.

Two modes:

- ``--mode overhead`` (default; correct for a *virtual* CPU mesh, where
  all "devices" share one host's cores and absolute weak-scaling numbers
  are meaningless): runs the same total workload on the same n devices
  twice — sharded along **time** (requires ppermute halo exchange) and
  sharded along **channels** (embarrassingly parallel, no collectives).
  Their ratio isolates the communication/sharding overhead, which is the
  quantity that maps to real-pod scaling efficiency: efficiency ≈
  1 / (1 + overhead).

- ``--mode weak`` (for real devices, e.g. four GPUs of one host):
  constant per-device work, efficiency = throughput(n) / (n ·
  throughput(1)).

- ``--mode pp``: measures the pipeline-parallel executor's *actual*
  overlap — sleep-weighted stages on distinct devices, pipelined vs
  forced-sequential wall clock, reported against the theoretical
  ``T·S / (T + S - 1)`` bound.

Prints ONE JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

_REPO_ROOT = str(Path(__file__).resolve().parent)
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)


def _sync(out) -> None:
    import numpy as np

    np.asarray(out[0, :8])  # tiny download forces full execution


def _best_time(fn, repeats: int) -> float:
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        _sync(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def _measure_spmd_pipeline(devices, num_stages, num_batches, delay_s):
    """Overlap of the fully-compiled GPipe schedule (spmd_pipeline).

    Sleep-weighted stages via ``pure_callback`` (sleeps don't trace into
    XLA arithmetic, but callbacks DO execute per-device-thread, so
    concurrent stages genuinely overlap on the virtual mesh — the same
    device model PipelinedChain is measured under).  Pipelined wall
    clock ≈ (T+S−1)·d vs the sequential chain's T·S·d.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from warmup_fir_filter_tpu.parallel import make_mesh
    from warmup_fir_filter_tpu.parallel.spmd_pipeline import (
        make_spmd_pipeline,
    )

    def sleep_cb(x):
        time.sleep(delay_s)
        return x

    def stage_fn(s, x):
        y = jax.pure_callback(
            sleep_cb, jax.ShapeDtypeStruct(x.shape, x.dtype), x,
            vmap_method="sequential",
        )
        return y + s.astype(jnp.float32)

    mesh = make_mesh({"stage": num_stages}, devices=devices[:num_stages])
    batches = jnp.asarray(
        np.arange(num_batches * 4 * 8, dtype=np.float32).reshape(
            num_batches, 4, 8)
    )
    run = make_spmd_pipeline(stage_fn, mesh=mesh)

    @jax.jit
    def seq(mb):
        def apply_one(x):
            y = x
            for s in range(num_stages):
                y = stage_fn(jnp.int32(s), y)
            return y

        return jax.lax.map(apply_one, mb)  # lax.map = sequential scan

    out = np.asarray(run(batches))  # compile + warm + correctness
    expected = np.asarray(batches) + sum(range(num_stages))
    assert np.allclose(out, expected), "spmd_pipeline output mismatch"
    np.asarray(seq(batches))

    pp_s = _best_time(lambda: run(batches), 3)
    seq_s = _best_time(lambda: seq(batches), 3)
    speedup = seq_s / pp_s
    theoretical = (num_batches * num_stages) / (
        num_batches + num_stages - 1
    )
    return {
        "speedup": round(speedup, 2),
        "theoretical": round(theoretical, 2),
        "fraction_of_theoretical": round(speedup / theoretical, 3),
        "sequential_s": round(seq_s, 3),
        "pipelined_s": round(pp_s, 3),
        "stages": num_stages,
        "microbatches": num_batches,
        "stage_delay_s": delay_s,
    }


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--platform", default="cpu", choices=("cpu", "cuda"))
    parser.add_argument("--mode", default="overhead",
                        choices=("overhead", "weak", "pp"))
    parser.add_argument("--devices", type=int, default=8)
    parser.add_argument("--channels", type=int, default=8)
    parser.add_argument("--time", type=int, default=1 << 14)
    parser.add_argument("--repeats", type=int, default=7)
    args = parser.parse_args()

    if args.platform == "cpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags
                + f" --xla_force_host_platform_device_count={args.devices}"
            ).strip()

    import jax

    jax.config.update("jax_platforms", args.platform)
    from warmup_fir_filter_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    import numpy as np

    from warmup_fir_filter_tpu.models.filters import FILTER_BANK_5TAP
    from warmup_fir_filter_tpu.parallel import fir1d_fixed_sharded, make_mesh
    from warmup_fir_filter_tpu.parallel.distributed import (
        initialize_multihost,
    )

    initialize_multihost()
    devices = jax.devices()[: args.devices]
    n = len(devices)
    h = np.asarray(FILTER_BANK_5TAP["sharpen"])
    rng = np.random.default_rng(7)

    if args.mode == "pp":
        from warmup_fir_filter_tpu.parallel.pipeline_parallel import (
            PipelinedChain,
        )

        num_stages = min(4, n)
        num_batches = 8
        delay_s = 0.05

        def make_stage(tag):
            def callback(x):
                time.sleep(delay_s)
                return x

            def stage(x):
                return jax.pure_callback(
                    callback, jax.ShapeDtypeStruct(x.shape, x.dtype), x,
                    vmap_method="sequential",
                ) + tag

            return stage

        chain = PipelinedChain(
            [make_stage(float(i)) for i in range(num_stages)],
            devices=devices[:num_stages],
        )
        batches = [np.full((4, 8), float(m), np.float32)
                   for m in range(num_batches)]
        chain.run_microbatches(batches[:1])  # warm/compile
        chain.run_microbatches(batches[:1], force_sequential=True)

        t0 = time.perf_counter()
        chain.run_microbatches(batches, force_sequential=True)
        seq_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        chain.run_microbatches(batches)
        pp_s = time.perf_counter() - t0

        speedup = seq_s / pp_s
        theoretical = (num_batches * num_stages) / (
            num_batches + num_stages - 1
        )
        payload = {
            "metric": "pipeline_parallel_overlap",
            "value": round(speedup, 2),
            "unit": f"x speedup, {num_stages} stages x {num_batches} "
                    "microbatches (theoretical "
                    f"{theoretical:.2f}x)",
            "vs_baseline": round(speedup / theoretical, 3),
            "platform": args.platform,
            "sequential_s": round(seq_s, 3),
            "pipelined_s": round(pp_s, 3),
            "stage_delay_s": delay_s,
        }
        payload["spmd_pipeline"] = _measure_spmd_pipeline(
            devices, num_stages, num_batches, delay_s)
    elif args.mode == "overhead":
        x = rng.integers(
            0, 256, size=(args.channels * n, args.time * n), dtype=np.uint8
        )
        mesh_time = make_mesh({"data": 1, "time": n}, devices=devices)
        mesh_data = make_mesh({"data": n, "time": 1}, devices=devices)

        run_time = lambda: fir1d_fixed_sharded(x, h, mesh=mesh_time)  # noqa: E731
        run_data = lambda: fir1d_fixed_sharded(x, h, mesh=mesh_data)  # noqa: E731
        _sync(run_time())
        _sync(run_data())
        # Interleave the two modes so shared-host load noise hits both
        # measurements alike (r4: back-to-back sweeps showed ±8% drift
        # that dominated the ratio).
        t_halo = t_plain = float("inf")
        for _ in range(args.repeats):
            t_halo = min(t_halo, _best_time(run_time, 1))
            t_plain = min(t_plain, _best_time(run_data, 1))
        overhead = max(0.0, t_halo / t_plain - 1.0)
        efficiency = 1.0 / (1.0 + overhead)
        payload = {
            "metric": "halo_sharding_efficiency",
            "value": round(efficiency, 3),
            "unit": f"fraction at {n} devices (comm-overhead proxy)",
            "vs_baseline": round(efficiency / 0.9, 3),
            "platform": args.platform,
            "time_sharded_s": round(t_halo, 4),
            "channel_sharded_s": round(t_plain, 4),
            "workload": (
                f"5-tap fixed FIR, {args.channels * n}ch x "
                f"{args.time * n} samples, {n}-device mesh"
            ),
        }
    else:
        results = {}
        m = 1
        while m <= n:
            mesh = make_mesh({"data": 1, "time": m}, devices=devices[:m])
            x = rng.integers(
                0, 256, size=(args.channels, args.time * m), dtype=np.uint8
            )
            run = lambda: fir1d_fixed_sharded(x, h, mesh=mesh)  # noqa: E731
            _sync(run())
            best = _best_time(run, args.repeats)
            results[m] = x.size / best / 1e6
            m *= 2
        base = results[1]
        max_n = max(results)
        efficiency = results[max_n] / (base * max_n)
        payload = {
            "metric": "scaling_efficiency_weak",
            "value": round(efficiency, 3),
            "unit": f"fraction at {max_n} devices",
            "vs_baseline": round(efficiency / 0.9, 3),
            "platform": args.platform,
            "msps_per_n": {str(k): round(v, 1) for k, v in results.items()},
            "workload": (
                f"5-tap fixed FIR, {args.channels}ch x {args.time}/device"
            ),
        }
    print(json.dumps(payload))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
