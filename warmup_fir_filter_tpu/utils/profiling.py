"""Tracing / profiling subsystem (SURVEY.md §5.1 build equivalent).

The reference's observability is `perf_counter` elapsed lines; here the
same structured-log habit is kept and extended with:

- :func:`trace` — context manager wrapping ``jax.profiler.trace`` so any
  region can be captured for TensorBoard/XProf (gated: profiling is a
  no-op if the profiler cannot start, e.g. on exotic backends);
- :class:`StageTimer` — per-stage wall clock with achieved Msamples/s
  in the same ``[OK] ...`` line format.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

@contextmanager
def trace(log_dir: str, *, enabled: bool = True):
    """Capture a jax.profiler trace of the enclosed region (best effort)."""
    if not enabled:
        yield
        return
    import jax

    started = False
    try:
        jax.profiler.start_trace(log_dir)
        started = True
    except Exception:
        pass  # profiling unavailable on this backend — run untraced
    try:
        yield
    finally:
        if started:
            try:
                jax.profiler.stop_trace()
            except Exception:
                pass


class StageTimer:
    """Wall-clock + throughput accounting for a processing stage.

    Used as the status-line emitter of pipeline stages 2/3 (``stages.py``):
    carries arbitrary ``counts`` (generated/skipped/...), accumulates
    processed sample counts, and prints the reference-shaped structured
    line extended with achieved Msamples/s.  On exception a ``[FAIL]`` line is printed and
    the exception propagates (the reference's fail-fast contract,
    ``pipeline_fir_1d.py:232-241``).
    """

    def __init__(self, name: str, **counts: int):
        self.name = name
        self.samples = 0
        self.counts: dict = dict(counts)
        self._elapsed = 0.0
        self._start: float | None = None

    def __enter__(self) -> "StageTimer":
        self._start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        assert self._start is not None
        self._elapsed += time.perf_counter() - self._start
        self._start = None
        if exc_type is None:
            print(self.status_line())
        else:
            print(self.status_line(ok=False, error=str(exc)))

    def __getitem__(self, key: str) -> int:
        return self.counts[key]

    def __setitem__(self, key: str, value: int) -> None:
        self.counts[key] = value

    def add_samples(self, count: int) -> None:
        self.samples += int(count)

    @property
    def elapsed(self) -> float:
        return self._elapsed

    @property
    def msps(self) -> float:
        return self.samples / self._elapsed / 1e6 if self._elapsed else 0.0

    def status_line(self, *, ok: bool = True, error: str | None = None) -> str:
        parts = ["[OK]" if ok else "[FAIL]", self.name]
        parts += [f"{key}={value}" for key, value in self.counts.items()]
        parts += [f"samples={self.samples}", f"elapsed={self._elapsed:.3f}s",
                  f"msps={self.msps:.1f}"]
        if error is not None:
            parts.append(f'error="{error}"')
        return " ".join(parts)
