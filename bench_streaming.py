"""Long-stream streaming + checkpoint/resume demonstration (one JSON line).

The reference's C++ model defines streaming semantics
(``fir_1d_ref.cpp:16-33``) but never exercises them at scale.  This
runner pushes a multi-billion-sample synthetic stream through the
checkpointable block-streaming FIR (``ops/streaming.py``) ON DEVICE:

1. **Sustained throughput**: the whole block loop runs as one
   ``lax.scan`` (``stream_scanned``) — the carry never leaves the device,
   blocks are generated in-graph, only per-block checksums return.
2. **Kill/resume**: the run is split at the midpoint; the delay-line
   state is saved to disk (``FirStreamState.save``), a FRESH stream
   object reloads it, and the second half's checksums must match the
   uninterrupted run block for block.
3. **Bit-exact stitching**: the two blocks straddling the resume point
   are recomputed from the checkpoint and compared bit-for-bit against
   the offline pre-haloed kernel over the regenerated input window.

Emits ONE JSON line with sustained Msps and both verification verdicts.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

_REPO_ROOT = str(Path(__file__).resolve().parent)
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

import numpy as np

from warmup_fir_filter_tpu.utils.compile_cache import enable_compile_cache

CHANNELS = 16
BLOCK = 4_000_000          # samples per channel per block
NUM_BLOCKS = 252           # ≈ 16.1e9 total samples


def main() -> int:
    start = time.perf_counter()
    quick = "--quick" in sys.argv
    enable_compile_cache()

    import jax
    import jax.numpy as jnp

    from warmup_fir_filter_tpu.models.filters import FILTER_BANK_5TAP
    from warmup_fir_filter_tpu.ops.fir1d import fixed_fir_prehaloed_i32
    from warmup_fir_filter_tpu.ops.qformat import QFormat
    from warmup_fir_filter_tpu.ops.streaming import (
        Fir1DStream,
        stream_scanned,
    )

    channels = CHANNELS
    block = BLOCK // (64 if quick else 1)
    num_blocks = 15 if quick else NUM_BLOCKS
    h = np.asarray(FILTER_BANK_5TAP["sharpen"])
    qf = QFormat()

    # Deterministic synthetic source: a device-resident noise table XOR
    # a per-block scalar tweak — memory-bound (1 B read + 1 B write per
    # sample) and fully deterministic/resumable: block_fn(b) is a pure
    # function of b, so kill/resume regeneration (below) and the
    # offline stitch window rebuild unchanged.
    noise = jnp.asarray(np.random.default_rng(0x5EED).integers(
        0, 256, size=(channels, block), dtype=np.uint8))

    def block_fn(b):
        s = b.astype(jnp.uint32) * jnp.uint32(2654435761)
        s = (s ^ (s >> 13)) * jnp.uint32(1274126177)
        tweak = ((s >> 8) & jnp.uint32(255)).astype(jnp.uint8)
        return noise ^ tweak

    # --- 1. uninterrupted scan, timed (second run: steady-state) ---
    stream = Fir1DStream(h, channels, qf)
    sums_full = np.asarray(stream_scanned(stream, block_fn, num_blocks))
    stream.reset()
    t0 = time.perf_counter()
    sums_full = np.asarray(stream_scanned(stream, block_fn, num_blocks))
    elapsed = time.perf_counter() - t0
    total = channels * block * num_blocks
    msps = total / elapsed / 1e6
    final_state_full = stream.state

    # --- 2. kill/resume at the midpoint ---
    half = num_blocks // 2
    stream_a = Fir1DStream(h, channels, qf)
    sums_a = np.asarray(stream_scanned(stream_a, block_fn, half))
    with tempfile.TemporaryDirectory() as td:
        ckpt = Path(td) / "stream_state.npz"
        stream_a.state.save(ckpt)
        # "Kill": a fresh stream object resumes purely from disk state.
        stream_b = Fir1DStream(h, channels, qf)
        stream_b.state = type(stream_b.state).load(ckpt)
    sums_b = np.asarray(stream_scanned(
        stream_b, block_fn, num_blocks - half, start_block=half))
    resumed = np.concatenate([sums_a, sums_b], axis=0)
    resume_ok = bool(np.array_equal(resumed, sums_full))
    state_ok = bool(
        np.array_equal(stream_b.state.carry, final_state_full.carry)
        and stream_b.state.samples_seen == final_state_full.samples_seen)

    # --- 3. bit-exact stitch across the resume boundary ---
    # Recompute blocks half-1 and half (one before, one after the
    # checkpoint) block-wise, and compare against the offline pre-haloed
    # kernel over the regenerated window.  emitted[t] = y_global[t-c],
    # so blocks [b0, b0+2) equal offline outputs for stream positions
    # [b0·S - c, (b0+2)·S - c) — all interior for b0 ≥ 1.
    stream_c = Fir1DStream(h, channels, qf)
    sums_c = np.asarray(stream_scanned(stream_c, block_fn, half - 1))
    y_pair = [stream_c.process(np.asarray(block_fn(jnp.int32(b))))
              for b in (half - 1, half)]
    got = np.concatenate(y_pair, axis=1)
    taps, center = h.size, h.size // 2
    left = taps - 1 - center
    lo = (half - 1) * block - center - left
    hi = (half + 1) * block - center + center
    xs = []
    for b in range(max(0, lo // block), (hi - 1) // block + 1):
        xs.append(np.asarray(block_fn(jnp.int32(b))))
    xcat = np.concatenate(xs, axis=1)
    off = lo - (lo // block) * block
    window = xcat[:, off : off + (got.shape[1] + taps - 1)]
    expected = np.asarray(fixed_fir_prehaloed_i32(
        jnp.asarray(window, jnp.int32), jnp.asarray(
            qf.quantize_coeffs(h).astype(np.int32)),
        taps, qf.frac_bits, qf.acc_bits))
    stitch_ok = bool(np.array_equal(got, expected))
    # Cross-path check: the scanned loop and the blockwise process()
    # path must produce identical checksums for the same block.
    from warmup_fir_filter_tpu.ops.streaming import host_emit_checksums

    want = host_emit_checksums(y_pair[0])
    got_ck = sums_full[half - 1].astype(np.uint64)
    cross_core_ok = bool(np.array_equal(got_ck, want))
    del sums_c

    d = jax.devices()[0]
    print(json.dumps({
        "metric": "streaming_checkpoint_sustained",
        "value": msps,
        "unit": "Msamples/s sustained (on-device scan)",
        "total_samples": total,
        "blocks": num_blocks,
        "block_shape": [channels, block],
        "resume_checksums_match": resume_ok,
        "resume_state_match": state_ok,
        "stitch_bit_exact": stitch_ok,
        "scan_vs_blockwise_checksums_match": cross_core_ok,
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(jax.devices())},
        "elapsed_s": time.perf_counter() - start,
    }))
    sys.stdout.flush()
    return 0 if (resume_ok and state_ok and stitch_ok
                 and cross_core_ok) else 1


if __name__ == "__main__":
    raise SystemExit(main())
