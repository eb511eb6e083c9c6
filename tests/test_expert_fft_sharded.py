"""Expert (filter-bank) parallelism + time-sharded FFT overlap-save."""

import jax
import numpy as np
import pytest

from warmup_fir_filter_tpu.models.filters import FILTER_BANKS
from warmup_fir_filter_tpu.models.golden import (
    fir1d_fixed_golden_rows,
    fir1d_ideal_golden_rows,
)
from warmup_fir_filter_tpu.ops.fftfilt import fir_overlap_save, snr_db
from warmup_fir_filter_tpu.parallel import make_mesh
from warmup_fir_filter_tpu.parallel.expert import filter_bank_fixed_sharded
from warmup_fir_filter_tpu.parallel.fft_sharded import (
    fir_overlap_save_sharded,
)


@pytest.fixture
def mesh4(require_devices):
    return make_mesh({"data": 4}, devices=require_devices(4))


class TestExpertParallel:
    def test_bank_matches_per_filter_golden(self, rng, mesh4):
        bank = np.stack([
            FILTER_BANKS[5][name]
            for name in ("moving_avg", "simple_lp", "edge", "sharpen")
        ])
        x = rng.integers(0, 256, size=(6, 200), dtype=np.uint8)
        out = np.asarray(filter_bank_fixed_sharded(x, bank, mesh=mesh4))
        assert out.shape == (4, 6, 200)
        for f in range(4):
            np.testing.assert_array_equal(
                out[f], fir1d_fixed_golden_rows(x, bank[f])
            )

    def test_bank_size_must_divide(self, rng, mesh4):
        with pytest.raises(ValueError, match="not divisible"):
            filter_bank_fixed_sharded(
                np.zeros((2, 32), np.uint8), np.ones((3, 5)) * 0.1,
                mesh=mesh4,
            )

    def test_bank_shape_validated(self, mesh4):
        with pytest.raises(ValueError, match=r"\(F, L\)"):
            filter_bank_fixed_sharded(
                np.zeros((2, 32), np.uint8), np.ones(5), mesh=mesh4
            )


class TestShardedOverlapSave:
    def test_matches_unsharded_fft_path(self, rng, require_devices):
        mesh = make_mesh({"data": 1, "time": 4}, devices=require_devices(4))
        h = rng.uniform(-0.2, 0.2, 63)
        x = rng.integers(0, 256, size=(3, 4 * 2048), dtype=np.uint8)
        sharded = np.asarray(
            fir_overlap_save_sharded(x, h, mesh=mesh), np.float64
        )
        ideal = fir1d_ideal_golden_rows(x, h)
        assert snr_db(ideal, sharded) > 70.0
        # And agrees with the single-device FFT path to float tolerance.
        single = np.asarray(fir_overlap_save(x, h), np.float64)
        np.testing.assert_allclose(sharded, single, atol=2e-2)

    def test_2d_mesh_channels_and_time(self, rng, require_devices):
        mesh = make_mesh({"data": 2, "time": 4}, devices=require_devices(8))
        h = rng.uniform(-0.1, 0.1, 31)
        x = rng.integers(0, 256, size=(4, 4 * 1024), dtype=np.uint8)
        sharded = np.asarray(
            fir_overlap_save_sharded(x, h, mesh=mesh), np.float64
        )
        ideal = fir1d_ideal_golden_rows(x, h)
        assert snr_db(ideal, sharded) > 70.0

    def test_small_shard_with_short_nfft(self, rng, require_devices):
        # Shard length not a multiple of the FFT hop exercises the tail
        # truncation path.
        mesh = make_mesh({"data": 1, "time": 4}, devices=require_devices(4))
        h = np.zeros(9)
        h[4] = 1.0  # identity
        x = rng.integers(0, 256, size=(2, 4 * 100), dtype=np.uint8)
        out = np.asarray(
            fir_overlap_save_sharded(x, h, mesh=mesh, nfft=64)
        )
        np.testing.assert_allclose(out, x.astype(np.float32), atol=1e-3)

    def test_indivisible_rejected(self, rng, require_devices):
        mesh = make_mesh({"data": 1, "time": 4}, devices=require_devices(4))
        with pytest.raises(ValueError, match="not divisible"):
            fir_overlap_save_sharded(
                np.zeros((2, 101), np.uint8), np.ones(5) * 0.1, mesh=mesh
            )


    @pytest.mark.parametrize("taps,nfft", [(31, None), (63, None),
                                           (63, 128), (129, None)])
    def test_tap_and_block_sizes(self, rng, require_devices, taps, nfft):
        from warmup_fir_filter_tpu.ops.resample import design_lowpass

        mesh = make_mesh({"data": 2, "time": 4}, devices=require_devices(8))
        h = design_lowpass(taps, 0.25)
        x = rng.integers(0, 256, size=(4, 4 * 1500), dtype=np.uint8)
        sharded = np.asarray(
            fir_overlap_save_sharded(x, h, mesh=mesh, nfft=nfft), np.float64)
        assert snr_db(fir1d_ideal_golden_rows(x, h), sharded) > 70.0

    def test_output_spans_mesh(self, rng, require_devices):
        devices = require_devices(4)
        mesh = make_mesh({"data": 1, "time": 4}, devices=devices)
        x = rng.integers(0, 256, size=(2, 4 * 256), dtype=np.uint8)
        out = fir_overlap_save_sharded(x, np.ones(5) / 5, mesh=mesh)
        assert out.sharding.device_set == set(devices)
        assert {s.data.shape for s in out.addressable_shards} == {(2, 256)}
