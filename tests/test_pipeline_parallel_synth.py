"""Pipeline-parallel executor + synthetic corpus tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from warmup_fir_filter_tpu.parallel.pipeline_parallel import PipelinedChain
from warmup_fir_filter_tpu.pipeline.synthetic import (
    DEFAULT_SPECS,
    synthesize_corpus,
)


class TestPipelinedChain:
    def test_stages_on_distinct_devices(self):
        devices = jax.devices()
        stages = [
            lambda x: x * 2.0,
            lambda x: x + 1.0,
            lambda x: x - 0.5,
        ]
        chain = PipelinedChain(stages, devices=devices[:3])
        assert len(set(chain.placements)) == min(3, len(devices[:3]))

    def test_microbatch_results_match_sequential(self, rng):
        stages = [
            lambda x: x * 2.0,
            lambda x: jnp.tanh(x),
            lambda x: x.sum(axis=-1),
        ]
        chain = PipelinedChain(stages, devices=jax.devices()[:3])
        batches = [rng.normal(size=(4, 16)).astype(np.float32)
                   for _ in range(5)]
        out = chain.run_microbatches(batches)
        for got, batch in zip(out, batches):
            expected = np.tanh(batch * 2.0).sum(axis=-1)
            # Looser tolerance: an accelerator's f32 tanh can differ
            # from numpy's at ~1e-5 relative before the 16-element
            # reduction.
            np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-4)

    def test_single_device_degrades_gracefully(self, rng):
        chain = PipelinedChain([lambda x: x + 1], devices=jax.devices()[:1])
        out = chain.run_microbatches([np.zeros((2, 2), np.float32)])
        np.testing.assert_array_equal(out[0], np.ones((2, 2)))

    def test_empty_stages_rejected(self):
        with pytest.raises(ValueError, match="stages"):
            PipelinedChain([])

    def test_in_flight_window_bounds_and_matches(self, rng):
        stages = [lambda x: x * 2.0, lambda x: x + 1.0]
        chain = PipelinedChain(stages, devices=jax.devices()[:2])
        batches = [rng.normal(size=(3, 8)).astype(np.float32)
                   for _ in range(7)]
        for window in (1, 2, 5):
            out = chain.run_microbatches(batches, max_in_flight=window)
            for got, batch in zip(out, batches):
                np.testing.assert_allclose(got, batch * 2.0 + 1.0, rtol=1e-6)
        with pytest.raises(ValueError, match="max_in_flight"):
            chain.run_microbatches(batches, max_in_flight=0)

    def test_overlap_measured_vs_forced_sequential(self):
        """PP must actually overlap: sleep-weighted stages on distinct
        devices, pipelined wall-clock vs forced-sequential wall-clock.

        Theoretical ratio for T microbatches, S stages of equal cost:
        T·S / (T + S - 1) = 24/9 ≈ 2.67x here; require >= 1.4x (the CPU
        backend's callback concurrency is wobbly — measured 1.6-2.8x
        across runs; bench_scaling.py --mode pp records the number).
        """
        import time as _time

        if len(jax.devices()) < 4:
            pytest.skip("needs >= 4 devices for a meaningful overlap test")

        delay_s = 0.05

        def make_stage(tag):
            def callback(x):
                _time.sleep(delay_s)
                return x

            def stage(x):
                return jax.pure_callback(
                    callback, jax.ShapeDtypeStruct(x.shape, x.dtype), x,
                    vmap_method="sequential",
                ) + tag

            return stage

        stages = [make_stage(float(i)) for i in range(4)]
        chain = PipelinedChain(stages, devices=jax.devices()[:4])
        batches = [np.full((4, 8), float(m), np.float32) for m in range(6)]

        # Warm both paths (compiles excluded from timing).
        chain.run_microbatches(batches[:1])
        chain.run_microbatches(batches[:1], force_sequential=True)

        # Under pytest-xdist the host's callback concurrency is shared
        # with the other workers; demand less there (bench_scaling.py
        # --mode pp records the real number on an idle host: 1.6-2.8x).
        import os

        bar = 1.15 if os.environ.get("PYTEST_XDIST_WORKER") else 1.4
        best = 0.0
        for _attempt in range(3):
            t0 = _time.perf_counter()
            out_seq = chain.run_microbatches(batches, force_sequential=True)
            seq_s = _time.perf_counter() - t0

            t0 = _time.perf_counter()
            out_pp = chain.run_microbatches(batches)
            pp_s = _time.perf_counter() - t0

            for a, b, batch in zip(out_pp, out_seq, batches):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(a, batch + 0.0 + 1.0 + 2.0 + 3.0)
            best = max(best, seq_s / pp_s)
            if best >= bar:
                break
        assert best >= bar, (
            f"pipeline overlap not happening: best speedup over 3 attempts "
            f"= {best:.2f}x (bar {bar}x)"
        )

    def test_dsp_chain_stages_pipelined(self, rng):
        # Realistic: FIR stage → abs stage → decimate stage on 3 devices.
        from warmup_fir_filter_tpu.ops.fir1d import fir1d_ideal_rows_jnp

        h = np.array([0.25, 0.5, 0.25])
        stages = [
            lambda x: fir1d_ideal_rows_jnp(x, h),
            lambda x: jnp.abs(x),
            lambda x: x[:, ::2],
        ]
        chain = PipelinedChain(stages, devices=jax.devices()[:3])
        batches = [rng.integers(0, 256, size=(2, 64), dtype=np.uint8)
                   for _ in range(3)]
        out = chain.run_microbatches(batches)
        for got, batch in zip(out, batches):
            expected = np.abs(
                np.asarray(fir1d_ideal_rows_jnp(batch, h))
            )[:, ::2]
            np.testing.assert_allclose(got, expected, atol=1e-5)


class TestSyntheticCorpus:
    def test_generates_deterministic_pngs(self, tmp_path):
        paths = synthesize_corpus(tmp_path / "img")
        assert len(paths) == len(DEFAULT_SPECS)
        from warmup_fir_filter_tpu.utils.imageio import load_gray_u8

        first = load_gray_u8(paths[0])
        assert first.shape == (512, 768)
        # Regenerating with the same seed is byte-identical.
        again = synthesize_corpus(tmp_path / "img2")
        np.testing.assert_array_equal(first, load_gray_u8(again[0]))

    def test_idempotent_no_overwrite(self, tmp_path):
        paths = synthesize_corpus(tmp_path / "img")
        mtimes = [p.stat().st_mtime_ns for p in paths]
        synthesize_corpus(tmp_path / "img")
        assert [p.stat().st_mtime_ns for p in paths] == mtimes

    def test_pipeline_runs_on_synthetic_corpus(self, tmp_path):
        from warmup_fir_filter_tpu.cli import run_pipeline

        img_dir = tmp_path / "img"
        synthesize_corpus(
            img_dir,
            specs=(("img_a", "gradient", (16, 24)),
                   ("img_b", "noise", (16, 16))),
        )
        result = run_pipeline(
            image_dir=img_dir,
            artifact_root=tmp_path / "artifacts",
            tap="3",
            backend="golden",
            skip_restore=True,
        )
        assert result["stages"]["input"]["generated"] == 2
        assert result["stages"]["report_3tap"]["num_cases"] == 8


@pytest.mark.parametrize("kind", ["gradient", "checker", "stripes", "noise",
                                  "steps", "mix"])
def test_rendered_image_has_spec_shape(kind):
    """Every kind fills the whole (rows, cols) frame (a 1-row stripes
    image once slipped through at any requested height)."""
    from warmup_fir_filter_tpu.pipeline.synthetic import _render

    img = _render(kind, (37, 53), np.random.default_rng(0))
    assert img.shape == (37, 53)
    assert img.dtype == np.uint8


def test_reference_specs_sample_count():
    from warmup_fir_filter_tpu.pipeline.synthetic import REFERENCE_SPECS

    # 28-case matrix of the reference corpus: 7 images × 4 filters.
    assert 4 * sum(r * c for _, _, (r, c) in REFERENCE_SPECS) == 67_975_252
