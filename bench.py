"""Headline benchmark: 5-tap fixed-point FIR throughput per device.

Measures the bit-exact Q4.12 fixed-point 5-tap FIR (the reference's
headline workload, ``pipeline_fir_1d.py`` stage 3) through the library's
fixed-FIR entry point (``ops/fir1d.py::fir1d_fixed_rows_jnp``) in
Msamples/s, at 19456×8192 and 81920×8192 u8, and prints ONE JSON line::

    {"metric": ..., "value": N, "unit": "Msamples/s/device", ...}

Whatever is timed is first checked bit-exact against the golden on 64
rows; a mismatch or any failure ends the run with a non-zero status.
``vs_baseline`` divides by the reference's own scalar golden model
(``fir_1d_fixed_ref.py:95-128``), recorded at 0.57 Msamples/s on a CPU
host.  Timing: ``utils/benchmarking.py::chained_throughput``.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

_REPO_ROOT = str(Path(__file__).resolve().parent)
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

import numpy as np

from warmup_fir_filter_tpu.utils.benchmarking import chained_throughput
from warmup_fir_filter_tpu.utils.compile_cache import enable_compile_cache

#: The reference's scalar golden model, Msamples/s on a CPU host.
REFERENCE_MSPS = 0.57

WIDTH = 8192
BATCH, BATCH_LARGE = 19456, 81920  # ≈160 MB and ≈640 MB of u8 input


def main() -> int:
    start = time.perf_counter()
    enable_compile_cache()

    import jax
    import jax.numpy as jnp

    from warmup_fir_filter_tpu.models.filters import FILTER_BANK_5TAP
    from warmup_fir_filter_tpu.models.golden import fir1d_fixed_golden_rows
    from warmup_fir_filter_tpu.ops.fir1d import fir1d_fixed_rows_jnp

    h = np.asarray(FILTER_BANK_5TAP["sharpen"])
    rng = np.random.default_rng(20260817)

    def step(a):
        return fir1d_fixed_rows_jnp(a, h)

    legs = {}
    for batch in (BATCH, BATCH_LARGE):
        x = rng.integers(0, 256, size=(batch, WIDTH), dtype=np.uint8)
        check = x[:64]
        if not np.array_equal(np.asarray(step(jnp.asarray(check))),
                              fir1d_fixed_golden_rows(check, h)):
            raise AssertionError("fixed FIR is not bit-exact vs golden")
        res = chained_throughput(step, jax.device_put(x), best_of=5)
        legs[batch] = {
            "msps": x.size / res["seconds_per_apply"] / 1e6,
            "runs_msps": sorted(x.size / s / 1e6
                                for s in res["slopes"] if s > 0),
        }

    msps = legs[BATCH]["msps"]
    d = jax.devices()[0]
    print(json.dumps({
        "metric": "fixed5_fir_msps_per_device",
        "value": msps,
        "unit": "Msamples/s/device",
        "vs_baseline": msps / REFERENCE_MSPS,
        "workload": f"5-tap Q4.12 fixed FIR over {BATCH}x{WIDTH} uint8",
        "runs_msps": legs[BATCH]["runs_msps"],
        "large_workload": f"same over {BATCH_LARGE}x{WIDTH} uint8",
        "large_msps": legs[BATCH_LARGE]["msps"],
        "large_runs_msps": legs[BATCH_LARGE]["runs_msps"],
        "bit_exact_vs_golden": True,
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(jax.devices())},
        "elapsed_s": time.perf_counter() - start,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
