"""Run every BASELINE.json config end-to-end and report pass/fail.

The five configs (BASELINE.json:6-12) are the acceptance scenarios of
the north star.  Each run checks its numeric contract (bit-exactness vs
golden, or SNR bound vs the float ideal) and reports throughput where
meaningful.  Prints ONE JSON line with per-config results.

Usage: ``python bench_configs.py [--quick]`` (``--quick`` shrinks the
stream lengths ~16x for CI-speed smoke runs).
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


def config1_bit_compare(results: dict) -> None:
    """3-tap fixed FIR over 1k-sample vectors, bit-compare vs golden."""
    import jax.numpy as jnp

    from warmup_fir_filter_tpu.models.filters import FILTER_BANK_3TAP
    from warmup_fir_filter_tpu.models.golden import fir1d_fixed_golden_rows
    from warmup_fir_filter_tpu.ops.fir1d import fir1d_fixed_rows_jnp

    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, size=(64, 1024), dtype=np.uint8)
    ok = True
    for name, h in FILTER_BANK_3TAP.items():
        out = np.asarray(fir1d_fixed_rows_jnp(jnp.asarray(x), np.asarray(h)))
        ok &= bool(np.array_equal(out, fir1d_fixed_golden_rows(x, np.asarray(h))))
    results["config1_3tap_1k_bitexact"] = {"pass": ok}


def config2_stream_snr(results: dict, scale: int) -> None:
    """5-tap fixed FIR over a 1M-sample stream, SNR vs float ideal."""
    from warmup_fir_filter_tpu.models.filters import FILTER_BANK_5TAP
    from warmup_fir_filter_tpu.models.golden import fir1d_ideal_golden_rows
    from warmup_fir_filter_tpu.ops.fftfilt import snr_db
    from warmup_fir_filter_tpu.ops.fir1d import fir1d_fixed_rows_jnp

    rng = np.random.default_rng(2)
    n = 1_000_000 // scale
    h = np.asarray(FILTER_BANK_5TAP["simple_lp"])
    x = rng.integers(0, 256, size=(1, n), dtype=np.uint8)
    fixed = np.asarray(fir1d_fixed_rows_jnp(x, h)).astype(np.float64)
    ideal = fir1d_ideal_golden_rows(x, h)
    snr = snr_db(ideal, fixed)
    # Q4.12 quantization of a low-pass: error ≪ 1 LSB → very high SNR.
    results["config2_5tap_1M_snr"] = {
        "pass": snr > 40.0, "snr_db": round(snr, 2), "samples": n,
    }


def config3_fir2d(results: dict) -> None:
    """5x5 fixed 2D FIR on 512x512 tiles, sim-vs-model cross-check."""
    from warmup_fir_filter_tpu.ops.fir2d import (
        FILTER_BANK_2D,
        fir2d_fixed_golden,
        fir2d_fixed_jnp,
        fir2d_ideal_golden,
    )

    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, size=(512, 512), dtype=np.uint8)
    h = FILTER_BANK_2D["gauss5"]
    sim = np.asarray(fir2d_fixed_jnp(x, h))
    bit_ok = bool(np.array_equal(sim, fir2d_fixed_golden(x, h)))
    model = fir2d_ideal_golden(x, h)
    rmse = float(np.sqrt(np.mean((sim.astype(np.float64) - model) ** 2)))
    results["config3_fir2d_512"] = {
        "pass": bit_ok and rmse < 0.5,
        "bit_exact_vs_golden": bit_ok,
        "rmse_vs_model": round(rmse, 4),
    }


def config4_fft_sharded(results: dict, scale: int) -> None:
    """63-tap FFT overlap-save, 16ch x 10M, sharded with halo exchange.

    Runs the full workload (16 × 10,000,000 u8 samples, 160 MB,
    BASELINE.json:10) unless ``--quick`` shrinks it; the time axis spans
    up to four of the devices present.  Reports SNR vs the float64 ideal
    oracle, and (full size only) throughput by chain-slope timing.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from warmup_fir_filter_tpu.models.golden import fir1d_ideal_golden_rows
    from warmup_fir_filter_tpu.ops.fftfilt import snr_db
    from warmup_fir_filter_tpu.ops.resample import design_lowpass
    from warmup_fir_filter_tpu.parallel import make_mesh
    from warmup_fir_filter_tpu.parallel.fft_sharded import (
        make_overlap_save_step,
    )

    devices = jax.devices()
    n_dev = min(4, len(devices))
    mesh = make_mesh({"data": 1, "time": n_dev}, devices=devices[:n_dev])
    rng = np.random.default_rng(4)
    time_len = (10_000_000 // scale // n_dev) * n_dev
    if scale > 1:  # --quick: CI-speed smoke shape
        time_len = (10_000_000 // scale // 64 // n_dev) * n_dev
    x = rng.integers(0, 256, size=(16, time_len), dtype=np.uint8)
    h = design_lowpass(63, 0.25)
    sharding = NamedSharding(mesh, P("data", "time"))
    x_sh = jax.device_put(x, sharding)
    run1 = make_overlap_save_step(h, mesh=mesh)
    out = np.asarray(run1(x_sh), np.float64)
    finite = bool(np.all(np.isfinite(out)))
    snr = snr_db(fir1d_ideal_golden_rows(x, h), out) if finite else None
    entry = {
        "pass": finite and snr > 70.0,
        "snr_db": snr,
        "devices": n_dev,
        "shape": list(x.shape),
    }
    if scale == 1:
        # Throughput via the chain-length slope (1 vs 5 applications).
        run5 = make_overlap_save_step(h, mesh=mesh, steps=5)
        np.asarray(run5(x_sh)[0, :8])  # compile + warm
        times = {}
        for k, run in ((1, run1), (5, run5)):
            best = float("inf")
            for seed in range(3):
                t0 = time.perf_counter()
                np.asarray(run(x_sh, float(seed + 1))[0, :8])
                best = min(best, time.perf_counter() - t0)
            times[k] = best
        per_apply = max((times[5] - times[1]) / 4, 1e-9)
        entry["msps"] = x.size / per_apply / 1e6
    results["config4_fft63_sharded"] = entry


def config5_full_chain(results: dict, scale: int) -> None:
    """Polyphase 2/3 resample + 63-tap channelizer + FM demod chain.

    Correctness (message recovery) runs on a modest 2-channel signal;
    throughput runs at a REAL shape — 16 channels × 2M complex samples
    (row-rich: a 2-row workload only measures sublane waste,
    ``models/chain.py`` notes) — with per-stage attribution and the
    bottleneck stage named.
    """
    from warmup_fir_filter_tpu.models.chain import ChainConfig, chain_forward
    from warmup_fir_filter_tpu.ops.demod import fm_modulate
    from warmup_fir_filter_tpu.utils.debugging import nan_guard

    cfg = ChainConfig()
    t = np.arange(max(200_000 // scale, 20_000))
    message = np.stack([
        0.4 * np.cos(2 * np.pi * 0.001 * t),
        0.3 * np.sin(2 * np.pi * 0.0015 * t),
    ])
    re, im = fm_modulate(message, cfg.demod_k_f)
    # nan_guard: the demod chain is the one float path with divisions /
    # arctangents — fail at the producing op, not in the final corr.
    with nan_guard():
        out = np.asarray(chain_forward(re, im, cfg), np.float64)
    t_out = np.arange(out.shape[1]) * 1.5
    expected = 0.4 * np.cos(2 * np.pi * 0.001 * t_out)
    core = slice(300, -300)
    corr = float(np.corrcoef(out[0, core], expected[core])[0, 1])
    entry = {
        "pass": corr > 0.99, "message_corr": corr,
        "out_shape": list(out.shape),
    }
    entry.update(_chain_throughput(cfg, scale))
    results["config5_full_chain"] = entry


def _chain_throughput(cfg, scale) -> dict:
    """Chain + per-stage Msamples/s at a row-rich shape (16ch × 2M).

    The chain changes shape (2/3 resample), so the shape-preserving
    chained harness does not apply; instead a fori_loop times K
    independent applications with per-iteration input perturbation, and
    the K-slope cancels the fixed per-call cost — the method of
    utils/benchmarking.py.  Each stage is timed the same way on its own
    input shape, so the per-stage numbers attribute the chain's time.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    from warmup_fir_filter_tpu.models.chain import chain_forward
    from warmup_fir_filter_tpu.ops.demod import fm_demodulate
    from warmup_fir_filter_tpu.ops.fftfilt import fir_overlap_save
    from warmup_fir_filter_tpu.ops.resample import resample_poly

    channels = 16
    time_len = 2_000_000 // (scale * 8 if scale > 1 else 1)
    rng = np.random.default_rng(5)
    re = rng.standard_normal((channels, time_len)).astype(np.float32)
    im = rng.standard_normal((channels, time_len)).astype(np.float32)

    re_d = jax.device_put(re)
    im_d = jax.device_put(im)
    h_rs = cfg.resample_filter()
    h_ch = cfg.channelizer_filter()

    def timed(fn, args, k_pair=(2, 10), repeats=3):
        """Per-apply seconds of fn(*args) via the fori_loop k-slope."""

        def make(k):
            @jax.jit
            def run(*xs):
                def body(i, acc):
                    eps = (1e-6 * i.astype(jnp.float32)).astype(xs[0].dtype)
                    out = fn(xs[0] + eps, *xs[1:])
                    return acc + out.ravel()[:8]
                return lax.fori_loop(0, k, body, jnp.zeros(8, jnp.float32))
            return run

        times = {}
        for k in k_pair:
            run = make(k)
            np.asarray(run(*args))  # compile + warm
            best = float("inf")
            for _ in range(repeats):
                t0 = time.perf_counter()
                np.asarray(run(*args))
                best = min(best, time.perf_counter() - t0)
            times[k] = best
        return (times[k_pair[1]] - times[k_pair[0]]) / (k_pair[1]
                                                        - k_pair[0])

    # Stage inputs: both I/Q planes stacked as rows (what the chain does).
    both = jnp.concatenate([re_d, im_d], axis=0)
    t_chain = timed(lambda r, i: chain_forward(r, i, cfg), (re_d, im_d))
    t_rs = timed(
        lambda b: resample_poly(b, h_rs, cfg.resample_up, cfg.resample_down),
        (both,),
    )
    both_rs = resample_poly(both, h_rs, cfg.resample_up, cfg.resample_down)
    t_ch = timed(lambda b: fir_overlap_save(b, h_ch), (both_rs,),
                 k_pair=(4, 24))
    re_ch, im_ch = both_rs[:channels], both_rs[channels:]
    t_dm = timed(
        lambda r, i: fm_demodulate(r, i, cfg.demod_k_f), (re_ch, im_ch),
        k_pair=(8, 48),
    )

    n_in = re.size  # complex input samples
    n_rs = int(both_rs.shape[1]) * channels
    stages = {
        "resample": {"seconds": t_rs, "msps": n_in / t_rs / 1e6},
        "channelize": {"seconds": t_ch, "msps": n_rs / t_ch / 1e6},
        "demod": {"seconds": t_dm, "msps": n_rs / t_dm / 1e6},
    }
    return {
        "chain_msps": n_in / t_chain / 1e6,
        "chain_shape": [channels, time_len],
        "stages_msps": {k: v["msps"] for k, v in stages.items()},
        "stages_seconds": {k: v["seconds"] for k, v in stages.items()},
        "bottleneck_stage": max(stages, key=lambda s: stages[s]["seconds"]),
        "stage_sum_seconds": t_rs + t_ch + t_dm,
        "chain_seconds": t_chain,
    }


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true")
    args = parser.parse_args()
    scale = 16 if args.quick else 1
    enable_compile_cache()

    import jax

    results: dict = {}
    start = time.perf_counter()
    config1_bit_compare(results)
    config2_stream_snr(results, scale)
    config3_fir2d(results)
    config4_fft_sharded(results, scale)
    config5_full_chain(results, scale)

    all_pass = all(entry["pass"] for entry in results.values())
    d = jax.devices()[0]
    print(json.dumps({
        "metric": "baseline_configs_pass",
        "value": sum(int(e["pass"]) for e in results.values()),
        "unit": f"of {len(results)} configs",
        "vs_baseline": 1.0 if all_pass else 0.0,
        "elapsed_s": time.perf_counter() - start,
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(jax.devices())},
        "configs": results,
    }))
    return 0 if all_pass else 1


if __name__ == "__main__":
    raise SystemExit(main())
