"""2-D FIR throughput benchmark (BASELINE config 3 at 8192²).

Measures the bit-exact fixed-point 5×5 2-D FIR (``sharpen5`` and
``gauss5``) through ``ops/fir2d.py::fir2d_fixed_jnp`` in Msamples/s on
one device and prints ONE JSON line.  Each filter is checked bit-exact
against the 2-D golden on a 256×512 tile first; any failure ends the run
with a non-zero status.

Usage: ``python bench_2d.py [--quick] [--size N]``
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

_REPO_ROOT = str(Path(__file__).resolve().parent)
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

import numpy as np

from warmup_fir_filter_tpu.utils.compile_cache import enable_compile_cache


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--size", type=int, default=8192)
    args = parser.parse_args()
    enable_compile_cache()

    import jax
    import jax.numpy as jnp

    from warmup_fir_filter_tpu.ops.fir2d import (
        FILTER_BANK_2D,
        fir2d_fixed_golden,
        fir2d_fixed_jnp,
    )
    from warmup_fir_filter_tpu.utils.benchmarking import chained_throughput

    start = time.perf_counter()
    size = 2048 if args.quick else args.size
    rng = np.random.default_rng(20260819)
    x = rng.integers(0, 256, size=(size, size), dtype=np.uint8)
    x_dev = jax.device_put(x)
    check = x[:256, :512]

    per_filter = {}
    for name in ("sharpen5", "gauss5"):
        h = FILTER_BANK_2D[name]
        if not np.array_equal(np.asarray(fir2d_fixed_jnp(jnp.asarray(check),
                                                         h)),
                              fir2d_fixed_golden(check, h)):
            raise AssertionError(f"{name} is not bit-exact vs golden")
        r = chained_throughput(lambda a, h=h: fir2d_fixed_jnp(a, h), x_dev,
                               repeats=5, best_of=5)
        per_filter[name] = {
            "msps": x.size / r["seconds_per_apply"] / 1e6,
            "runs_msps": sorted(x.size / s / 1e6
                                for s in r["slopes"] if s > 0),
        }

    d = jax.devices()[0]
    print(json.dumps({
        "metric": "fixed2d_5x5_msps_per_device",
        "value": per_filter["sharpen5"]["msps"],
        "unit": "Msamples/s/device",
        "workload": f"5x5 fixed 2-D FIR over {size}x{size} u8",
        "per_filter": per_filter,
        "bit_exact_vs_golden": True,
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(jax.devices())},
        "elapsed_s": time.perf_counter() - start,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
