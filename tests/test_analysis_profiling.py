"""Analysis-doc generation + profiling utilities tests."""

import numpy as np
import pytest

from warmup_fir_filter_tpu.pipeline.analysis import (
    _pct,
    generate_analysis_doc,
    generate_comparison_doc,
)
from warmup_fir_filter_tpu.pipeline.artifacts import ArtifactStore, save_npy
from warmup_fir_filter_tpu.pipeline.report import generate_compare_report
from warmup_fir_filter_tpu.utils.profiling import StageTimer, trace


@pytest.fixture
def reported_store(tmp_path):
    store = ArtifactStore(tmp_path / "artifacts")
    rng = np.random.default_rng(11)
    for stem in ("case_000_a", "case_001_b"):
        for coeff in ("moving_avg", "edge"):
            ideal = rng.uniform(-20, 280, size=(6, 9))
            fixed = np.clip(np.rint(ideal), 0, 255).astype(np.uint8)
            save_npy(store.output_vector_path("ideal", 3, stem, coeff), ideal)
            save_npy(store.output_vector_path("fixed", 3, stem, coeff), fixed)
    generate_compare_report(store, tap=3)
    return store


@pytest.fixture
def reported_store_both(reported_store):
    """The 3-tap store of ``reported_store`` plus a 5-tap report."""
    rng = np.random.default_rng(12)
    for stem in ("case_000_a", "case_001_b"):
        for coeff in ("moving_avg", "edge"):
            ideal = rng.uniform(-10, 270, size=(6, 9))
            fixed = np.clip(np.rint(ideal), 0, 255).astype(np.uint8)
            save_npy(
                reported_store.output_vector_path("ideal", 5, stem, coeff),
                ideal,
            )
            save_npy(
                reported_store.output_vector_path("fixed", 5, stem, coeff),
                fixed,
            )
    generate_compare_report(reported_store, tap=5)
    return reported_store


class TestAnalysisDoc:
    def test_generates_markdown_sections(self, reported_store):
        path = generate_analysis_doc(reported_store, tap=3)
        text = path.read_text()
        for section in (
            "# Fixed vs Ideal Compare Analysis — 3-tap",
            "## 1. Overall",
            "## 2. Sample-weighted",
            "## 3. Per-coefficient rollup",
            "## 4. Worst cases by RMSE",
            "## 5. Non-edge acceptance view",
            "0.2887",  # quantization floor
        ):
            assert section in text
        assert "| moving_avg |" in text
        assert "| edge |" in text

    def test_non_edge_excludes_edge_cases(self, reported_store):
        import json

        path = generate_analysis_doc(reported_store, tap=3)
        summary = json.loads(
            (reported_store.report_dir(3) / "compare_3tap_summary.json")
            .read_text()
        )
        from warmup_fir_filter_tpu.pipeline.report import summarize_weighted

        non_edge = summarize_weighted(
            [r for r in summary["cases"] if r["coeff_name"] != "edge"]
        )
        assert f"{non_edge['weighted_mae']:.4f}" in path.read_text()

    def test_missing_report_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError, match="summary"):
            generate_analysis_doc(ArtifactStore(tmp_path), tap=5)


class TestComparisonDoc:
    """Cross-tap comparison doc — parity with the reference's
    ``fir_1d_fixed_3tap_vs_5tap_comparison_v1.md`` structure."""

    def test_generates_all_sections(self, reported_store_both):
        path = generate_comparison_doc(reported_store_both)
        text = path.read_text()
        for section in (
            "# Fixed 3-tap vs 5-tap Comparison",
            "## 1. Overall comparison (case-mean)",
            "## 2. Overall comparison (sample-weighted)",
            "## 3. Per-coefficient comparison (sample-weighted)",
            "## 4. Quick summary",
            "## 5. Interpretation",
            "Delta (5-3)",
        ):
            assert section in text
        assert "| moving_avg |" in text
        assert "| edge |" in text

    def test_digits_match_summaries(self, reported_store_both):
        import json

        path = generate_comparison_doc(reported_store_both)
        text = path.read_text()
        for tap in (3, 5):
            summary = json.loads(
                (
                    reported_store_both.report_dir(tap)
                    / f"compare_{tap}tap_summary.json"
                ).read_text()
            )
            # section 1: case-mean values appear verbatim
            assert f"{summary['overall']['avg_mae']:.4f}" in text
            assert f"{summary['overall']['avg_rmse']:.4f}" in text
            # section 2: weighted values appear verbatim
            assert f"{summary['weighted']['weighted_rmse']:.4f}" in text

    def test_delta_percent_formatting(self):
        assert _pct(2.0, 1.0) == "-50.00%"
        assert _pct(1.0, 2.0) == "+100.00%"
        assert _pct(1.0, 1.0) == "0.00%"
        assert _pct(0.0, 0.0) == "0.00%"
        assert _pct(0.0, 1.0) == "n/a"

    def test_missing_tap_raises(self, reported_store):
        # Only the 3-tap report exists.
        with pytest.raises(FileNotFoundError, match="summary"):
            generate_comparison_doc(reported_store)

    def test_case_count_mismatch_raises(self, reported_store_both):
        import json

        json_path = (
            reported_store_both.report_dir(5) / "compare_5tap_summary.json"
        )
        summary = json.loads(json_path.read_text())
        summary["overall"]["num_cases"] += 1
        json_path.write_text(json.dumps(summary))
        with pytest.raises(ValueError, match="Case-count mismatch"):
            generate_comparison_doc(reported_store_both)


class TestProfiling:
    def test_stage_timer_line(self, capsys):
        with StageTimer("unit_stage", generated=2) as timer:
            timer.add_samples(50_000)
        out = capsys.readouterr().out
        assert "[OK] unit_stage generated=2 samples=50000" in out
        assert "msps=" in out
        assert timer.msps > 0

    def test_trace_noop_when_disabled(self, tmp_path):
        with trace(str(tmp_path), enabled=False):
            pass  # must not start the profiler at all

    def test_trace_best_effort(self, tmp_path):
        # Must never raise even if the backend can't profile.
        with trace(str(tmp_path / "prof")):
            _ = 1 + 1
