"""Drive the library's main paths once on a GPU and check every result.

Usage::

    python chip_smoke.py           # one card: the seven phases below
    python chip_smoke.py --four    # four cards: the sharded paths only

One card runs, in order: the five-stage pipeline CLI over a synthetic
corpus at the reference's seven image sizes; the 5-tap fixed FIR at
19456×8192; the tap sweep 63/257/1001/4096; the 5×5 2-D FIR at 8192²;
63-tap FFT overlap-save on 16×10M (BASELINE config 4); the resample →
channelize → FM demod chain on 16×2M (config 5); and checkpointed
streaming at 16 ch × 4M per block.  ``--four`` runs the time-sharded
halo FIR, the time-sharded overlap-save and the data-parallel chain over
four cards, each against its one-card result.

Every phase compares the device result with the repository's golden
reference (bit-exact, or an SNR floor for the float paths) and raises on
a mismatch.  Each phase prints one ``PHASE {json}`` line with its shape,
compile and run seconds and its check; the last line of standard output
is ``{"ok": true, "device": {...}}``.  With no GPU, JAX's platform is
not ``gpu`` and the script exits with status 2 before any phase.

"compile_s" is the first call's time minus the steady call's time (the
persistent compile cache directory is printed; a warm cache shrinks it).
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from warmup_fir_filter_tpu import cli
from warmup_fir_filter_tpu.models.chain import (
    ChainConfig,
    chain_forward,
    chain_forward_golden,
    chain_forward_sharded,
)
from warmup_fir_filter_tpu.models.filters import FILTER_BANK_5TAP, filter_bank
from warmup_fir_filter_tpu.models.golden import (
    fir1d_fixed_golden_rows,
    fir1d_ideal_golden_rows,
)
from warmup_fir_filter_tpu.ops.demod import fm_modulate
from warmup_fir_filter_tpu.ops.fftfilt import fir_overlap_save, snr_db
from warmup_fir_filter_tpu.ops.fir1d import fir1d_fixed_rows_jnp
from warmup_fir_filter_tpu.ops.fir2d import (
    FILTER_BANK_2D,
    fir2d_fixed_golden,
    fir2d_fixed_jnp,
)
from warmup_fir_filter_tpu.ops.resample import design_lowpass
from warmup_fir_filter_tpu.ops.streaming import (
    Fir1DStream,
    FirStreamState,
    host_emit_checksums,
    stream_scanned,
)
from warmup_fir_filter_tpu.parallel import (
    fir1d_fixed_sharded,
    fir_overlap_save_sharded,
    make_mesh,
)
from warmup_fir_filter_tpu.pipeline.artifacts import ArtifactStore
from warmup_fir_filter_tpu.pipeline.synthetic import (
    REFERENCE_SPECS,
    synthesize_corpus,
)
from warmup_fir_filter_tpu.utils.compile_cache import enable_compile_cache

WORK_DIR = Path(__file__).resolve().parent / "artifacts" / "chip_smoke"
SEED = 20260817
SHARPEN = np.asarray(FILTER_BANK_5TAP["sharpen"])

#: BASELINE config 4's floor (bench_configs.py): f32 FFT overlap-save vs
#: the float64 direct FIR.
OVERLAP_SAVE_SNR_DB = 70.0
#: The chain against its float64 composition.  Each f32 stage adds
#: rounding near 2^-24 of full scale (the 63-tap resampler sum, the
#: 512-point FFT round trip, the discriminator's products), and the
#: discriminator divides the phase step by 2π·k_f ≈ 0.31, which lifts the
#: relative error of a ±0.4 message about tenfold; ~110 dB is expected
#: and 80 dB leaves margin.  A wrong tap, phase or alignment reads below
#: 20 dB.
CHAIN_SNR_DB = 80.0
#: FM message recovery (bench_configs.py config 5).
CHAIN_MIN_CORR = 0.99
#: The four-card chain against the one-card chain.  Rows are independent,
#: but XLA may choose another FFT plan or fusion for 4 rows than for 16,
#: so only the last float32 bits of the ±0.4 message may differ.
CHAIN_SHARD_ATOL = 1e-6


def _check(ok: bool, message: str) -> None:
    if not ok:
        raise AssertionError(message)


def _timed(fn, *args, steady: int = 2):
    """(output, {"compile_s", "run_s"}) of ``fn(*args)`` on the device."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    runs = []
    for _ in range(steady):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        runs.append(time.perf_counter() - t0)
    run = min(runs)
    return out, {"compile_s": max(first - run, 0.0), "run_s": run}


def _equal_in_chunks(got: np.ndarray, x: np.ndarray, h, rows: int) -> None:
    """Bit-compare rows of ``got`` with the 1-D golden, ``rows`` at a time."""
    for r0 in range(0, x.shape[0], rows):
        want = fir1d_fixed_golden_rows(x[r0:r0 + rows], h)
        _check(np.array_equal(got[r0:r0 + rows], want),
               f"rows {r0}..{r0 + rows} differ from the golden")


def _random_u8(shape, seed: int = SEED) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=shape,
                                                dtype=np.uint8)


def phase_pipeline(work: Path = WORK_DIR, specs=REFERENCE_SPECS) -> dict:
    """The five-stage CLI over a synthetic corpus, cold then warm."""
    shutil.rmtree(work, ignore_errors=True)
    image_dir, root = work / "img", work / "pipeline"
    synthesize_corpus(image_dir, specs=specs)
    argv = ["--image-dir", str(image_dir), "--artifact-root", str(root),
            "--backend", "device", "--strict-report"]
    times = []
    for extra in ([], ["--overwrite-vectors", "--overwrite-images"]):
        t0 = time.perf_counter()
        _check(cli.main(argv + extra) == 0, "pipeline CLI failed")
        times.append(time.perf_counter() - t0)

    store = ArtifactStore(root)
    inputs = store.iter_input_vectors()
    _check(len(inputs) == len(specs), f"{len(inputs)} input vectors")
    cases = 0
    for tap in (3, 5):
        bank = filter_bank(tap)
        for in_path in inputs:
            x = np.load(in_path)
            stem = ArtifactStore.case_stem_of_input(in_path)
            for name, h in bank.items():
                got = np.load(store.output_vector_path("fixed", tap, stem,
                                                       name))
                want = fir1d_fixed_golden_rows(x, np.asarray(h))
                _check(np.array_equal(got, want),
                       f"fixed {tap}tap {stem}/{name} differs from golden")
                cases += 1
        summary = json.loads((store.report_dir(tap)
                              / f"compare_{tap}tap_summary.json").read_text())
        _check(summary["overall"]["num_cases"] == len(inputs) * len(bank),
               f"{tap}tap report counts {summary['overall']['num_cases']}")
    restored = json.loads(
        (root / "output_img" / "restore_summary.json").read_text())
    # The warm run rewrites every image: ideal + fixed for every case.
    _check(restored["num_converted"] == 2 * cases,
           f"restored {restored['num_converted']} of {2 * cases} images")
    samples = sum(r * c for _, _, (r, c) in specs)
    return {"shape": [list(s) for _, _, s in specs],
            "fixed_cases": cases, "samples_per_case_set": samples,
            "compile_s": max(times[0] - times[1], 0.0), "run_s": times[1],
            "check": "all fixed outputs bit-exact vs golden; 2 reports; "
                     f"{2 * cases} images restored"}


def phase_headline(batch: int = 19456, width: int = 8192,
                   chunk: int = 2048) -> dict:
    """5-tap Q4.12 sharpen on u8, the headline shape, every row checked."""
    x = _random_u8((batch, width))
    x_dev = jax.device_put(x)
    out, t = _timed(lambda a: fir1d_fixed_rows_jnp(a, SHARPEN), x_dev)
    _equal_in_chunks(np.asarray(out), x, SHARPEN, chunk)
    return {"shape": [batch, width], **t,
            "check": "bit-exact vs golden, all rows"}


def phase_taps(taps=(63, 257, 1001, 4096), batch: int = 32,
               width: int = 65536) -> dict:
    """Long filters through the blocked shift-MAC path, bit-exact."""
    x = _random_u8((batch, width), SEED + 1)
    x_dev = jax.device_put(x)
    per_taps = {}
    for num_taps in taps:
        h = design_lowpass(num_taps, 0.25)
        out, t = _timed(lambda a, h=h: fir1d_fixed_rows_jnp(a, h), x_dev)
        _check(np.array_equal(np.asarray(out),
                              fir1d_fixed_golden_rows(x, h)),
               f"{num_taps} taps differ from golden")
        per_taps[str(num_taps)] = t
    return {"shape": [batch, width], "per_taps": per_taps,
            "compile_s": sum(t["compile_s"] for t in per_taps.values()),
            "run_s": sum(t["run_s"] for t in per_taps.values()),
            "check": "bit-exact vs golden at every tap count"}


def phase_fir2d(size: int = 8192, names=("sharpen5", "gauss5")) -> dict:
    """5×5 fixed 2-D FIR, bit-exact against the 2-D golden."""
    x = _random_u8((size, size), SEED + 2)
    x_dev = jax.device_put(x)
    per_filter = {}
    for name in names:
        h = FILTER_BANK_2D[name]
        out, t = _timed(lambda a, h=h: fir2d_fixed_jnp(a, h), x_dev)
        _check(np.array_equal(np.asarray(out), fir2d_fixed_golden(x, h)),
               f"2-D {name} differs from golden")
        per_filter[name] = t
    return {"shape": [size, size], "per_filter": per_filter,
            "compile_s": sum(t["compile_s"] for t in per_filter.values()),
            "run_s": sum(t["run_s"] for t in per_filter.values()),
            "check": "bit-exact vs golden for " + ", ".join(names)}


def phase_overlap_save(channels: int = 16, time_len: int = 10_000_000,
                       check_channels: int = 2) -> dict:
    """BASELINE config 4: 63-tap FFT overlap-save, SNR vs float64 FIR."""
    x = _random_u8((channels, time_len), SEED + 3)
    h = design_lowpass(63, 0.25)
    x_dev = jax.device_put(x)
    out, t = _timed(lambda a: fir_overlap_save(a, h), x_dev)
    got = np.asarray(out[:check_channels], np.float64)
    _check(bool(np.all(np.isfinite(np.asarray(out)))), "non-finite output")
    snr = snr_db(fir1d_ideal_golden_rows(x[:check_channels], h), got)
    _check(snr > OVERLAP_SAVE_SNR_DB, f"SNR {snr:.2f} dB")
    return {"shape": [channels, time_len], **t, "snr_db": snr,
            "check": f"SNR > {OVERLAP_SAVE_SNR_DB} dB vs float64 FIR on "
                     f"{check_channels} channels"}


def chain_signal(channels: int, time_len: int, config: ChainConfig):
    """FM baseband rows carrying one tone per channel, and the tones."""
    t = np.arange(time_len)
    freqs = 0.001 * (1.0 + np.arange(channels) / channels)
    message = 0.4 * np.cos(2 * np.pi * freqs[:, None] * t[None, :])
    re, im = fm_modulate(message, config.demod_k_f)
    return re.astype(np.float32), im.astype(np.float32), freqs


def phase_chain(channels: int = 16, time_len: int = 2_000_000,
                check_channels: int = 2) -> dict:
    """BASELINE config 5: resample → channelize → FM demod."""
    config = ChainConfig()
    re, im, freqs = chain_signal(channels, time_len, config)
    re_dev, im_dev = jax.device_put(re), jax.device_put(im)
    out, t = _timed(lambda a, b: chain_forward(a, b, config), re_dev, im_dev)
    got = np.asarray(out, np.float64)
    want = chain_forward_golden(re[:check_channels], im[:check_channels],
                                config)
    snr = snr_db(want, got[:check_channels])
    _check(snr > CHAIN_SNR_DB, f"chain SNR {snr:.2f} dB")
    # Message recovery: the output is the tone at the resampled rate.
    t_out = np.arange(got.shape[1]) * config.resample_down / config.resample_up
    core = slice(300, -300)
    corr = min(
        float(np.corrcoef(got[c, core],
                          0.4 * np.cos(2 * np.pi * freqs[c] * t_out[core]))
              [0, 1])
        for c in range(check_channels))
    _check(corr > CHAIN_MIN_CORR, f"message correlation {corr:.5f}")
    return {"shape": [channels, time_len], "out_shape": list(got.shape),
            **t, "snr_db": snr, "message_corr": corr,
            "check": f"SNR > {CHAIN_SNR_DB} dB vs float64 composition and "
                     f"corr > {CHAIN_MIN_CORR} on {check_channels} channels"}


def phase_streaming(work: Path = WORK_DIR, channels: int = 16,
                    block: int = 4_000_000, num_blocks: int = 6) -> dict:
    """Scanned stream, checkpoint at the midpoint, resume, compare."""
    noise = jax.device_put(_random_u8((channels, block), SEED + 4))

    def block_fn(b):
        s = b.astype(jnp.uint32) * jnp.uint32(2654435761)
        s = (s ^ (s >> 13)) * jnp.uint32(1274126177)
        return noise ^ ((s >> 8) & jnp.uint32(255)).astype(jnp.uint8)

    def run_full():
        stream = Fir1DStream(SHARPEN, channels)
        return stream_scanned(stream, block_fn, num_blocks), stream

    (sums_full, full), t = _timed(run_full, steady=1)
    half = num_blocks // 2
    first = Fir1DStream(SHARPEN, channels)
    sums_a = stream_scanned(first, block_fn, half)
    work.mkdir(parents=True, exist_ok=True)
    ckpt = work / "stream_state.npz"
    first.state.save(ckpt)
    resumed = Fir1DStream(SHARPEN, channels)
    resumed.state = FirStreamState.load(ckpt)
    sums_b = stream_scanned(resumed, block_fn, num_blocks - half,
                            start_block=half)
    _check(np.array_equal(np.concatenate([sums_a, sums_b]), sums_full),
           "resumed checksums differ from the uninterrupted run")
    _check(np.array_equal(resumed.state.carry, full.state.carry)
           and resumed.state.samples_seen == full.state.samples_seen,
           "resumed state differs from the uninterrupted run")

    # Block 0 emitted = same-mode golden of the stream zero-prepended by
    # ``center`` samples (the delay-line contract, ops/streaming.py).
    x0 = np.asarray(block_fn(jnp.int32(0)))
    y0 = Fir1DStream(SHARPEN, channels).process(x0)
    center = SHARPEN.size // 2
    want = fir1d_fixed_golden_rows(np.pad(x0, ((0, 0), (center, 0))),
                                   SHARPEN)[:, :block]
    _check(np.array_equal(y0, want), "first block differs from golden")
    _check(np.array_equal(host_emit_checksums(y0),
                          np.asarray(sums_full[0], np.uint64)),
           "scanned checksum of block 0 differs from the blockwise run")
    return {"shape": [channels, block], "blocks": num_blocks, **t,
            "check": "resume checksums + state equal; block 0 bit-exact"}


def _spans(out: jax.Array, devices) -> None:
    """The output lives on every device, and each device holds memory."""
    _check(out.sharding.device_set == set(devices),
           f"output on {len(out.sharding.device_set)} devices")
    for d in devices:
        stats = d.memory_stats()
        if d.platform == "gpu":
            _check(stats is not None and stats["bytes_in_use"] > 0,
                   f"device {d.id} holds no memory")


def phase_four_halo(devices, channels: int = 16,
                    time_len: int = 64 * 1024 * 1024) -> dict:
    """5-tap FIR with the time axis over the devices, vs one card."""
    x = _random_u8((channels, time_len), SEED + 5)
    mesh = make_mesh({"data": 1, "time": len(devices)}, devices=devices)
    out, t = _timed(lambda a: fir1d_fixed_sharded(a, SHARPEN, mesh=mesh), x)
    _spans(out, devices)
    got = np.asarray(out)
    one = np.asarray(fir1d_fixed_rows_jnp(jax.device_put(x, devices[0]),
                                          SHARPEN))
    _check(np.array_equal(got, one), "sharded differs from one card")
    _equal_in_chunks(got, x, SHARPEN, 1)
    return {"shape": [channels, time_len], "mesh": dict(mesh.shape),
            "bytes_per_device": x.nbytes // len(devices), **t,
            "check": "bit-exact vs one card and golden; spans devices"}


def phase_four_overlap_save(devices, channels: int = 16,
                            time_len: int = 10_000_000) -> dict:
    """Config 4 with the time axis over the devices, SNR vs one card."""
    x = _random_u8((channels, time_len), SEED + 3)
    h = design_lowpass(63, 0.25)
    mesh = make_mesh({"data": 1, "time": len(devices)}, devices=devices)
    out, t = _timed(lambda a: fir_overlap_save_sharded(a, h, mesh=mesh), x)
    _spans(out, devices)
    one = np.asarray(fir_overlap_save(jax.device_put(x, devices[0]), h),
                     np.float64)
    snr = snr_db(one, np.asarray(out, np.float64))
    _check(snr > OVERLAP_SAVE_SNR_DB, f"sharded SNR {snr:.2f} dB")
    return {"shape": [channels, time_len], "mesh": dict(mesh.shape), **t,
            "snr_db_vs_one_card": snr,
            "check": f"SNR > {OVERLAP_SAVE_SNR_DB} dB vs one card"}


def phase_four_chain(devices, channels: int = 16,
                     time_len: int = 2_000_000) -> dict:
    """Config 5 with channels over the devices, vs the one-card chain."""
    config = ChainConfig()
    re, im, _ = chain_signal(channels, time_len, config)
    mesh = make_mesh({"data": len(devices)}, devices=devices)
    out, t = _timed(
        lambda a, b: chain_forward_sharded(a, b, config, mesh=mesh), re, im)
    _spans(out, devices)
    got = np.asarray(out)
    one = np.asarray(chain_forward(jax.device_put(re, devices[0]),
                                   jax.device_put(im, devices[0]), config))
    diff = float(np.abs(got - one).max())
    _check(diff <= CHAIN_SHARD_ATOL, f"sharded chain differs by {diff}")
    return {"shape": [channels, time_len], "mesh": dict(mesh.shape), **t,
            "max_abs_diff_vs_one_card": diff,
            "bit_equal": bool(np.array_equal(got, one)),
            "check": f"max |diff| <= {CHAIN_SHARD_ATOL} vs one card"}


def _report(name: str, record: dict) -> None:
    print("PHASE " + json.dumps({"name": name, **record}), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run the sharded paths on four cards only")
    args = parser.parse_args(argv)

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX platform is {devices[0].platform!r}",
              file=sys.stderr)
        return 2
    count = 4 if args.four else 1
    if len(devices) < count:
        print(f"needs {count} GPUs, found {len(devices)}", file=sys.stderr)
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    print(f"compile cache: {enable_compile_cache()}", flush=True)

    if args.four:
        phases = [
            ("four_halo_fir", lambda: phase_four_halo(devices[:4])),
            ("four_overlap_save",
             lambda: phase_four_overlap_save(devices[:4])),
            ("four_chain", lambda: phase_four_chain(devices[:4])),
        ]
    else:
        phases = [
            ("pipeline", phase_pipeline),
            ("headline_fir", phase_headline),
            ("tap_sweep", phase_taps),
            ("fir2d", phase_fir2d),
            ("overlap_save", phase_overlap_save),
            ("chain", phase_chain),
            ("streaming", phase_streaming),
        ]
    for name, phase in phases:
        t0 = time.perf_counter()
        record = phase()
        _report(name, {**record, "phase_s": time.perf_counter() - t0})

    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
