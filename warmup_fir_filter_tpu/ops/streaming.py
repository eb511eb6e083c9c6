"""Stateful block-streaming FIR with checkpointable carry state.

Device successor of the reference's C++ streaming model
(``fir_1d/model/cpp/fir_1d_ref.cpp:16-33``: a Direct-Form-I delay line
shifted one sample at a time) and of its implicit checkpoint/resume
subsystem (SURVEY.md §5.4): here the delay line is a ``(C, L-1)`` carry
block processed a whole block at a time, and the carry *is* the resume
state — exactly the halo that the multi-device path exchanges.

Semantics: feeding blocks x_0, x_1, … of width S emits blocks y_0, y_1,…
such that ``concat(y_b)`` equals the same-mode filtering of the
zero-prepended stream delayed by ``center = L // 2`` samples:

    emitted[t] = y_global[t - center]      (zero-pad before t = 0)

``flush()`` pushes ``center`` zeros to emit the final tail, after which
``concat(all emitted)[center:]`` is bit-identical to the offline
``fir1d_fixed_rows_jnp`` output of the whole stream.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from warmup_fir_filter_tpu.ops.fir1d import fixed_fir_prehaloed_i32
from warmup_fir_filter_tpu.ops.qformat import QFormat


@dataclasses.dataclass
class FirStreamState:
    """Checkpointable streaming state: the delay line + sample count."""

    carry: np.ndarray  # (C, L-1) int32 — last L-1 input samples
    samples_seen: int

    def save(self, path: Path) -> None:
        np.savez(path, carry=self.carry,
                 samples_seen=np.int64(self.samples_seen))

    @classmethod
    def load(cls, path: Path) -> "FirStreamState":
        data = np.load(path)
        return cls(
            carry=np.asarray(data["carry"], np.int32),
            samples_seen=int(data["samples_seen"]),
        )


class Fir1DStream:
    """Block-streaming bit-exact fixed-point FIR over C channels.

    Drop-in capability parity with the reference C++ ``Fir1D``
    (``set_taps``/``process``/``reset``, ``fir_1d_ref.h:8-27``) but
    block-oriented, jit-compiled, and with first-class state
    checkpointing.
    """

    def __init__(self, h, channels: int, qformat: QFormat = QFormat()):
        if not qformat.int32_exact:
            raise ValueError(
                f"acc_bits={qformat.acc_bits} > 32 is not representable in "
                "the int32 device path."
            )
        self.qformat = qformat
        self.channels = int(channels)
        self.set_taps(h)

    def set_taps(self, h) -> None:
        self._h_fixed = self.qformat.quantize_coeffs(h).astype(np.int32)
        self.num_taps = int(self._h_fixed.size)
        self.center = self.num_taps // 2
        self.reset()

    def reset(self) -> None:
        """Zero the delay line (``fir_1d_ref.cpp:35``)."""
        self.state = FirStreamState(
            carry=np.zeros((self.channels, self.num_taps - 1), np.int32),
            samples_seen=0,
        )

    def process(self, x_block) -> np.ndarray:
        """Feed a (C, S) uint8 block; returns the (C, S) uint8 output."""
        x = np.asarray(x_block)
        if x.shape[0] != self.channels:
            raise ValueError(
                f"Expected {self.channels} channels, got {x.shape[0]}."
            )
        y, new_carry = _stream_step(
            jnp.asarray(x, jnp.int32),
            jnp.asarray(self.state.carry),
            jnp.asarray(self._h_fixed),
            self.num_taps,
            self.qformat.frac_bits,
            self.qformat.acc_bits,
        )
        self.state = FirStreamState(
            carry=np.asarray(new_carry, np.int32),
            samples_seen=self.state.samples_seen + x.shape[1],
        )
        return np.asarray(y)

    def flush(self) -> np.ndarray:
        """Emit the final ``center`` outputs by pushing zeros."""
        if self.center == 0:
            return np.zeros((self.channels, 0), np.uint8)
        return self.process(
            np.zeros((self.channels, self.center), np.uint8)
        )


@partial(jax.jit, static_argnames=("num_taps", "frac_bits", "acc_bits"))
def _stream_step(x_i32, carry_i32, h_i32, num_taps, frac_bits, acc_bits):
    if num_taps > 1:
        ext = jnp.concatenate([carry_i32, x_i32], axis=1)
        new_carry = ext[:, -(num_taps - 1):]
    else:
        ext = x_i32
        new_carry = carry_i32
    y = fixed_fir_prehaloed_i32(ext, h_i32, num_taps, frac_bits, acc_bits)
    return y, new_carry


def default_emit_checksums(y):
    """Order-sensitive block checksums: three uint32 sums.

    ``[Σy, Σ y·w, Σ y·(w·φ)]`` with ``w = 1..S`` and ``φ`` an odd
    (bijective mod 2³²) Weyl constant, all accumulated **mod 2³²**
    (full 64-bit sums would need x64, disabled by default; two
    independent weighted residues give ~2⁻⁶⁴ combined collision odds
    for the resume/bit-identity gates).  The host-side
    mirror formula is ``(y·w).sum() % 2**32`` in any wider dtype.
    """
    yu = y.astype(jnp.uint32)
    w = jax.lax.broadcasted_iota(jnp.uint32, y.shape, y.ndim - 1) \
        + jnp.uint32(1)
    return jnp.stack([
        jnp.sum(yu),
        jnp.sum(yu * w),
        jnp.sum(yu * (w * jnp.uint32(2654435761))),
    ])


#: (block_fn, emit_fn, jitted scan) entries keyed by scan geometry —
#: see the cache note inside :func:`stream_scanned`.  Bounded FIFO:
#: entries pin their closures (and any device buffers they capture)
#: plus a compiled executable, so unbounded growth would leak memory
#: under churned block_fns.
_SCAN_CACHE: dict = {}
_SCAN_CACHE_MAX = 16


def host_emit_checksums(y) -> np.ndarray:
    """Numpy mirror of :func:`default_emit_checksums` (uint64 values
    of the three uint32 residues) for host-side cross-checks."""
    yu = np.asarray(y, np.uint64)
    w = np.arange(1, yu.shape[-1] + 1, dtype=np.uint64)
    mod = np.uint64(1) << np.uint64(32)
    w2 = (w * np.uint64(2654435761)) % mod
    return np.array([
        yu.sum() % mod,
        (yu * w).sum() % mod,
        (yu * w2).sum() % mod,
    ], np.uint64)




def stream_scanned(
    stream: "Fir1DStream",
    block_fn,
    num_blocks: int,
    *,
    emit_fn=None,
    start_block: int = 0,
):
    """Run ``num_blocks`` streaming steps in ONE device program.

    The per-block host round trip of :meth:`Fir1DStream.process` (state
    download + next-block upload) bounds sustained throughput by host
    latency; for long streams the whole block loop belongs on device.
    This rolls it into a ``lax.scan``: ``block_fn(b)`` builds block ``b``
    IN-GRAPH (e.g. a synthetic generator, or a ``dynamic_slice`` of a
    device-resident buffer), the delay-line carry stays on device for
    the whole scan, and only ``emit_fn(y_block)`` (default:
    :func:`default_emit_checksums`, three uint32 residues mod 2³²)
    returns per block.

    The stream's checkpointable state is updated exactly as if the
    blocks had been fed one by one: resuming a second ``stream_scanned``
    call from a saved :class:`FirStreamState` is bit-identical to one
    uninterrupted run (asserted in tests and bench_streaming.py).

    Returns the stacked ``emit_fn`` outputs (leading axis num_blocks).
    """
    if emit_fn is None:
        emit_fn = default_emit_checksums

    num_taps = stream.num_taps
    frac_bits = stream.qformat.frac_bits
    acc_bits = stream.qformat.acc_bits
    block_width = int(jax.eval_shape(block_fn, jnp.int32(0)).shape[-1])

    # Compiled-scan cache: a fresh ``jax.jit`` closure per call would
    # retrace on every invocation; identical (block_fn, emit_fn,
    # geometry, filter) requests reuse one compiled executable.  Strong
    # references to block_fn/emit_fn in the cache entry prevent id-reuse
    # aliasing.  The key holds ``block_fn`` by IDENTITY: callers wanting
    # the reuse pass a stable function object, not a fresh per-call
    # lambda (the bounded FIFO keeps such churn from leaking memory).
    key = (id(block_fn), id(emit_fn), num_blocks, num_taps, frac_bits,
           acc_bits)
    cached = _SCAN_CACHE.get(key)
    if cached is not None and cached[0] is block_fn \
            and cached[1] is emit_fn:
        _run = cached[2]
    else:
        @jax.jit
        def _run(carry0, h_i32, b0):
            def body(carry, b):
                x = jnp.asarray(block_fn(b), jnp.int32)
                y, carry = _stream_step(
                    x, carry, h_i32, num_taps, frac_bits, acc_bits)
                return carry, emit_fn(y)
            return jax.lax.scan(
                body, carry0, b0 + jnp.arange(num_blocks, dtype=jnp.int32))

        if len(_SCAN_CACHE) >= _SCAN_CACHE_MAX:
            _SCAN_CACHE.pop(next(iter(_SCAN_CACHE)))
        _SCAN_CACHE[key] = (block_fn, emit_fn, _run)

    carry, emitted = _run(
        jnp.asarray(stream.state.carry),
        jnp.asarray(stream._h_fixed),
        jnp.int32(start_block),
    )
    # One batched host transfer for both outputs.
    carry, emitted = jax.device_get((carry, emitted))
    stream.state = FirStreamState(
        carry=np.asarray(carry, np.int32),
        samples_seen=stream.state.samples_seen + num_blocks * block_width,
    )
    return emitted
