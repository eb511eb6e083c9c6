"""Tap-count sweep of the bit-exact fixed FIR (one JSON line).

For each L in the sweep: bit-exactness of ``ops/fir1d.py``'s fixed path
vs the numpy golden oracle is a hard gate (a mismatch ends the run with
a non-zero status), then sustained Msps via the chained-slope harness on
the headline-scale workload (~160 MB).  Emits ONE JSON line::

    {"metric": "fixed_fir_tap_sweep", "value": <63-tap Msps>, ...,
     "per_taps": {"5": ..., "63": ..., "257": ..., "1001": ..., "4096": ...}}
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

from warmup_fir_filter_tpu.utils.compile_cache import enable_compile_cache

TAP_SWEEP = (5, 63, 257, 1001, 4096)
BATCH, WIDTH = 19456, 8192  # headline-scale stream, ~159.4 Msamples


def main() -> int:
    start = time.perf_counter()
    quick = "--quick" in sys.argv
    enable_compile_cache()

    import jax
    import jax.numpy as jnp

    from warmup_fir_filter_tpu.models.golden import fir1d_fixed_golden_rows
    from warmup_fir_filter_tpu.ops.fir1d import fir1d_fixed_rows_jnp
    from warmup_fir_filter_tpu.ops.resample import design_lowpass
    from warmup_fir_filter_tpu.utils.benchmarking import chained_throughput

    batch, width = (512, 4096) if quick else (BATCH, WIDTH)
    rng = np.random.default_rng(20260820)
    x = rng.integers(0, 256, size=(batch, width), dtype=np.uint8)
    x_dev = jax.device_put(jnp.asarray(x))
    check = x[:16]

    per_taps: dict[str, float] = {}
    for taps in TAP_SWEEP:
        h = design_lowpass(taps, 0.25)
        got = np.asarray(fir1d_fixed_rows_jnp(jnp.asarray(check), h))
        if not np.array_equal(got, fir1d_fixed_golden_rows(check, h)):
            raise AssertionError(f"{taps} taps: not bit-exact vs golden")
        r = chained_throughput(
            lambda a, hh=h: fir1d_fixed_rows_jnp(a, hh), x_dev,
            chain_short=8, chain_long=104, repeats=3)
        per_taps[str(taps)] = x.size / r["seconds_per_apply"] / 1e6

    d = jax.devices()[0]
    print(json.dumps({
        "metric": "fixed_fir_tap_sweep",
        "value": per_taps["63"],
        "unit": "Msamples/s/device at 63 taps (bit-exact gated)",
        "per_taps_msps": per_taps,
        "workload": f"Q4.12 fixed FIR over {batch}x{width} uint8",
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(jax.devices())},
        "elapsed_s": time.perf_counter() - start,
    }))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
