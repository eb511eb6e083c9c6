"""Integration tests for pipeline stages 1-3 (artifact contracts).

Mirrors the reference's integration test strategy (SURVEY.md §4.2):
tmp_path trees, file count + naming convention checks, shape/dtype/range
assertions, and spot-checks of written vectors against direct model calls.
"""

import json

import numpy as np
import pytest

from warmup_fir_filter_tpu.models import fir_1d_fixed_golden, fir_1d_ideal
from warmup_fir_filter_tpu.models.filters import FILTER_BANKS
from warmup_fir_filter_tpu.ops.qformat import QFormat
from warmup_fir_filter_tpu.pipeline.artifacts import ArtifactStore
from warmup_fir_filter_tpu.pipeline.stages import (
    generate_fixed_outputs,
    generate_ideal_outputs,
    generate_input_vectors,
)
from warmup_fir_filter_tpu.utils.imageio import save_gray_png


@pytest.fixture
def image_dir(tmp_path, synthetic_rows):
    d = tmp_path / "img"
    d.mkdir()
    save_gray_png(d / "tiny_a.png", synthetic_rows)
    save_gray_png(d / "tiny_b.png", synthetic_rows[::-1].copy())
    return d


@pytest.fixture
def store(tmp_path):
    return ArtifactStore(tmp_path / "artifacts")


class TestInputStage:
    def test_artifacts_and_manifest(self, image_dir, store):
        manifest = generate_input_vectors(image_dir, store)
        assert manifest["num_images"] == 2
        assert manifest["generated_cases"] == 2
        names = [c["case_name"] for c in manifest["cases"]]
        assert names == ["case_000_tiny_a", "case_001_tiny_b"]
        for case in manifest["cases"]:
            npy = store.input_dir / case["data_npy"]
            arr = np.load(npy)
            assert arr.dtype == np.uint8 and arr.ndim == 2
            preview = json.loads(
                (store.input_dir / case["preview_json"]).read_text()
            )
            assert preview["preview_kind"] == "top_left_patch"
            assert preview["stats"]["min"] >= 0
            assert preview["dtype"] == "uint8"
        assert store.manifest_path().exists()

    def test_idempotent_skip_then_overwrite(self, image_dir, store):
        generate_input_vectors(image_dir, store)
        second = generate_input_vectors(image_dir, store)
        assert second["generated_cases"] == 0
        assert second["skipped_cases"] == 2
        third = generate_input_vectors(image_dir, store, overwrite=True)
        assert third["generated_cases"] == 2

    def test_missing_dir_raises(self, tmp_path, store):
        with pytest.raises(FileNotFoundError):
            generate_input_vectors(tmp_path / "nope", store)


class TestOutputStages:
    @pytest.mark.parametrize("tap", [3, 5])
    def test_counts_and_naming(self, image_dir, store, tap):
        generate_input_vectors(image_dir, store)
        n_ideal = generate_ideal_outputs(store, tap=tap)
        n_fixed = generate_fixed_outputs(store, tap=tap, backend="golden")
        bank = FILTER_BANKS[tap]
        assert n_ideal == 2 * len(bank)
        assert n_fixed == 2 * len(bank)
        for kind, tag in (("ideal", "f64"), ("fixed", "u8")):
            files = sorted(store.vector_dir(kind, tap).glob("*.npy"))
            assert len(files) == 2 * len(bank)
            for f in files:
                assert f.name.endswith(f"_{kind}_{tap}tap_y_{tag}.npy")

    def test_shape_dtype_range(self, image_dir, store, synthetic_rows):
        generate_input_vectors(image_dir, store)
        generate_ideal_outputs(store, tap=3)
        generate_fixed_outputs(store, tap=3, backend="golden")
        shape = synthetic_rows.shape
        for f in store.vector_dir("ideal", 3).glob("*.npy"):
            arr = np.load(f)
            assert arr.dtype == np.float64 and arr.shape == shape
        for f in store.vector_dir("fixed", 3).glob("*.npy"):
            arr = np.load(f)
            assert arr.dtype == np.uint8 and arr.shape == shape
            assert arr.min() >= 0 and arr.max() <= 255

    def test_spot_check_rows_against_models(self, image_dir, store,
                                            synthetic_rows):
        generate_input_vectors(image_dir, store)
        generate_ideal_outputs(store, tap=3)
        generate_fixed_outputs(store, tap=3, backend="golden")
        h = FILTER_BANKS[3]["simple_lp"]
        ideal = np.load(
            store.output_vector_path("ideal", 3, "case_000_tiny_a", "simple_lp")
        )
        fixed = np.load(
            store.output_vector_path("fixed", 3, "case_000_tiny_a", "simple_lp")
        )
        for r in range(synthetic_rows.shape[0]):
            row = synthetic_rows[r].tolist()
            np.testing.assert_allclose(ideal[r], np.asarray(fir_1d_ideal(row, h)))
            np.testing.assert_array_equal(fixed[r], fir_1d_fixed_golden(row, h))

    def test_tpu_backend_matches_golden(self, image_dir, store):
        generate_input_vectors(image_dir, store)
        generate_fixed_outputs(store, tap=5, backend="golden")
        golden_files = {
            f.name: np.load(f)
            for f in store.vector_dir("fixed", 5).glob("*.npy")
        }
        # Regenerate with the device backend into a fresh store.
        store2 = ArtifactStore(store.root.parent / "artifacts_device")
        generate_input_vectors(image_dir, store2)
        generate_fixed_outputs(store2, tap=5, backend="device")
        for f in store2.vector_dir("fixed", 5).glob("*.npy"):
            np.testing.assert_array_equal(np.load(f), golden_files[f.name])

    def test_idempotent_skip(self, image_dir, store):
        generate_input_vectors(image_dir, store)
        generate_ideal_outputs(store, tap=3)
        assert generate_ideal_outputs(store, tap=3) == 0
        assert generate_fixed_outputs(store, tap=3, backend="golden") == 8
        assert generate_fixed_outputs(store, tap=3, backend="golden") == 0

    def test_out_of_range_filter_rejected(self, image_dir, store):
        generate_input_vectors(image_dir, store)
        with pytest.raises(ValueError, match="Q-format real range"):
            generate_fixed_outputs(
                store, tap=3, backend="golden",
                qformat=QFormat(coeff_bits=8, frac_bits=7),
                coeff_map={"edge": FILTER_BANKS[3]["sharpen"]},
            )


def test_fixed_backend_auto_dispatch(synthetic_rows):
    """The device backend stays bit-exact on both sides of the unrolled /
    blocked shift-MAC split (``ops/fir1d.py::TAP_BLOCK``)."""
    import numpy as np

    from warmup_fir_filter_tpu.models.golden import fir1d_fixed_golden_rows
    from warmup_fir_filter_tpu.pipeline.stages import _fixed_compute

    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, size=(4, 400), dtype=np.uint8)
    for num_taps in (5, 63, 131):  # unrolled, unrolled, blocked
        h = rng.uniform(-0.02, 0.02, num_taps)
        got = _fixed_compute("device", x, h, QFormat())
        np.testing.assert_array_equal(got, fir1d_fixed_golden_rows(x, h))


def test_fixed_backend_unknown_rejected(synthetic_rows):
    with pytest.raises(ValueError, match="Unknown fixed backend"):
        from warmup_fir_filter_tpu.pipeline.stages import _fixed_compute

        _fixed_compute("mxu", synthetic_rows, np.ones(3) / 3, QFormat())
