"""FM demod + full-chain tests (BASELINE config 5 shape)."""

import jax
import numpy as np
import pytest

from warmup_fir_filter_tpu.models.chain import (
    ChainConfig,
    chain_forward,
    chain_forward_golden,
    chain_forward_sharded,
)
from warmup_fir_filter_tpu.ops.demod import (
    fm_demodulate,
    fm_demodulate_golden,
    fm_modulate,
)
from warmup_fir_filter_tpu.parallel import make_mesh


class TestFMDemod:
    def test_roundtrip_recovers_message(self, rng):
        k_f = 0.05
        message = rng.uniform(-1, 1, size=(3, 2000))
        re, im = fm_modulate(message, k_f)
        recovered = np.asarray(fm_demodulate(re, im, k_f), np.float64)
        # First sample undefined; rest must match the message closely.
        np.testing.assert_allclose(recovered[:, 1:], message[:, 1:],
                                   atol=1e-3)

    def test_constant_tone_gives_constant_freq(self):
        k_f = 0.1
        message = np.full((1, 500), 0.5)
        re, im = fm_modulate(message, k_f)
        out = fm_demodulate_golden(re, im, k_f)
        np.testing.assert_allclose(out[0, 1:], 0.5, atol=1e-9)

    def test_jnp_matches_golden(self, rng):
        k_f = 0.08
        message = rng.uniform(-1, 1, size=(2, 300))
        re, im = fm_modulate(message, k_f)
        np.testing.assert_allclose(
            np.asarray(fm_demodulate(re, im, k_f), np.float64),
            fm_demodulate_golden(re, im, k_f),
            atol=1e-4,
        )

    def test_invalid_kf_rejected(self):
        with pytest.raises(ValueError, match="k_f"):
            fm_demodulate(np.ones((1, 4)), np.ones((1, 4)), 0.0)


class TestChain:
    def test_chain_recovers_lowpass_message(self, rng):
        # Band-limited message → modulate → full chain; the recovered
        # message must correlate strongly with the (resampled) original.
        config = ChainConfig()
        t = np.arange(6000)
        message = 0.5 * np.cos(2 * np.pi * 0.002 * t)[None, :].repeat(2, 0)
        re, im = fm_modulate(message, config.demod_k_f)
        out = np.asarray(chain_forward(re, im, config), np.float64)
        assert out.shape[0] == 2
        assert out.shape[1] == -(-6000 * 2 // 3)
        # Compare against the message at the resampled rate (skip edges).
        t_out = np.arange(out.shape[1]) * 1.5
        expected = 0.5 * np.cos(2 * np.pi * 0.002 * t_out)
        core = slice(200, -200)
        corr = np.corrcoef(out[0, core], expected[core])[0, 1]
        assert corr > 0.99

    def test_sharded_chain_matches_single_device(self, rng, require_devices):
        mesh = make_mesh({"data": 4}, devices=require_devices(4))
        config = ChainConfig(channelizer_taps=33)
        message = rng.uniform(-1, 1, size=(8, 1200))
        re, im = fm_modulate(message, config.demod_k_f)
        single = np.asarray(chain_forward(
            jax.numpy.asarray(re, jax.numpy.float32),
            jax.numpy.asarray(im, jax.numpy.float32), config))
        sharded = np.asarray(chain_forward_sharded(re, im, config, mesh=mesh))
        np.testing.assert_allclose(sharded, single, atol=1e-5)

    def test_indivisible_channels_rejected(self, rng, require_devices):
        mesh = make_mesh({"data": 4}, devices=require_devices(4))
        with pytest.raises(ValueError, match="divisible"):
            chain_forward_sharded(np.ones((3, 600)), np.ones((3, 600)),
                                  mesh=mesh)




@pytest.mark.parametrize("up,down,rs_taps,ch_taps,channels", [
    (2, 3, 63, 63, 8),      # flagship geometry
    (4, 3, 47, 31, 8),      # larger upsample, shorter filters
    (2, 1, 33, 97, 8),      # pure upsample, long channelizer
    (8, 5, 63, 129, 16),    # deep polyphase, long channelizer
    (1, 2, 31, 63, 8),      # pure decimation
    (2, 3, 95, 63, 24),     # longer resampler branches, 24 channels
])
@pytest.mark.parametrize("use_fft", [True, False])
def test_chain_config_sweep_matches_golden(rng, up, down, rs_taps, ch_taps,
                                           channels, use_fft):
    """Every (up, down, taps, channels) geometry, with either channelizer,
    against the float64 composition of the three stages."""
    import dataclasses

    from warmup_fir_filter_tpu.ops.fftfilt import snr_db

    cfg = dataclasses.replace(
        ChainConfig(), resample_up=up, resample_down=down,
        resample_taps=rs_taps, channelizer_taps=ch_taps,
        use_fft_channelizer=use_fft)
    msg = rng.standard_normal((channels, 3000)) * 0.3
    re, im = fm_modulate(msg, cfg.demod_k_f)
    got = np.asarray(chain_forward(re, im, cfg), np.float64)
    want = chain_forward_golden(re, im, cfg)
    assert got.shape == want.shape
    # f32 stages against float64 (chip_smoke.py CHAIN_SNR_DB states why).
    assert float(snr_db(want, got)) > 80.0, (up, down, rs_taps, ch_taps)


def test_chain_first_sample_zero(rng):
    cfg = ChainConfig()
    re, im = fm_modulate(rng.standard_normal((4, 3000)) * 0.3, cfg.demod_k_f)
    out = np.asarray(chain_forward(re, im, cfg))
    np.testing.assert_array_equal(out[:, 0], 0.0)
