"""FFT overlap-save tests: alignment exactness + SNR contracts."""

import numpy as np
import pytest

from warmup_fir_filter_tpu.models.golden import (
    fir1d_fixed_golden_rows,
    fir1d_ideal_golden_rows,
)
from warmup_fir_filter_tpu.ops.qformat import QFormat
from warmup_fir_filter_tpu.ops.fftfilt import (
    fir_overlap_save,
    fir_overlap_save_quantized,
    pick_nfft,
    snr_db,
)


def test_matches_ideal_small(rng):
    h = rng.uniform(-0.5, 0.5, 7)
    x = rng.integers(0, 256, size=(3, 500), dtype=np.uint8)
    ideal = fir1d_ideal_golden_rows(x, h)
    fft_out = np.asarray(fir_overlap_save(x, h), np.float64)
    np.testing.assert_allclose(fft_out, ideal, atol=2e-2)
    assert snr_db(ideal, fft_out) > 80.0


def test_63tap_snr_contract(rng):
    """BASELINE config 4 numeric contract: 63-tap FFT path vs direct."""
    h = rng.uniform(-0.1, 0.1, 63)
    x = rng.integers(0, 256, size=(4, 10_000), dtype=np.uint8)
    ideal = fir1d_ideal_golden_rows(x, h)
    fft_out = np.asarray(fir_overlap_save(x, h), np.float64)
    assert snr_db(ideal, fft_out) > 70.0


def test_block_boundary_alignment(rng):
    # Output must be continuous across overlap-save block boundaries:
    # use a short nfft so many boundaries occur, and an impulse filter so
    # misalignment is a hard shift error, not noise.
    h = np.zeros(9)
    h[4] = 1.0  # identity at center
    x = rng.integers(0, 256, size=(2, 777), dtype=np.uint8)
    out = np.asarray(fir_overlap_save(x, h, nfft=32))
    np.testing.assert_allclose(out, x.astype(np.float32), atol=1e-3)


def test_even_tap_alignment(rng):
    h = np.array([1.0, 0.0])  # L=2, center=1 → y[n] = x[n+1]
    x = rng.integers(0, 256, size=(1, 100), dtype=np.uint8)
    out = np.asarray(fir_overlap_save(x, h, nfft=16))
    expected = fir1d_ideal_golden_rows(x, h)
    np.testing.assert_allclose(out, expected, atol=1e-3)


def test_quantized_fft_vs_fixed_sim(rng):
    # The u8 FFT output must track the bit-exact fixed sim within the
    # reference-style SNR bound (quantization-limited, not FFT-limited).
    h = rng.uniform(-0.05, 0.05, 63)
    x = rng.integers(0, 256, size=(2, 8_000), dtype=np.uint8)
    fixed = fir1d_fixed_golden_rows(x, h)
    fft_u8 = np.asarray(fir_overlap_save_quantized(x, h))
    # Difference may only be occasional ±1 rounding flips.
    diff = fft_u8.astype(np.int32) - fixed.astype(np.int32)
    assert np.abs(diff).max() <= 1
    assert float(np.mean(diff != 0)) < 0.02


def test_nfft_too_small_rejected():
    with pytest.raises(ValueError, match="nfft"):
        fir_overlap_save(np.zeros((1, 10), np.uint8), np.ones(63), nfft=32)


def test_pick_nfft():
    assert pick_nfft(5) == 256
    assert pick_nfft(63) == 512


# Cases carried over from the retired FFT kernel suite: stream shapes
# with edges, ragged widths and the tap range, now through the jnp.fft
# path (cuFFT on a GPU).

@pytest.mark.parametrize("channels,time,taps", [
    (3, 2000, 63),
    (2, 1111, 63),
    (1, 700, 5),
    (4, 4096, 129),
    (2, 900, 257),
    (2, 513, 63),
    (3, 300, 63),
    (2, 257, 1),
])
def test_matches_ideal_stream_shapes(rng, channels, time, taps):
    from warmup_fir_filter_tpu.ops.resample import design_lowpass

    h = design_lowpass(taps, 0.2) if taps > 1 else np.array([1.0])
    x = rng.standard_normal((channels, time)).astype(np.float32)
    got = np.asarray(fir_overlap_save(x, h), np.float64)
    assert float(snr_db(fir1d_ideal_golden_rows(x, h), got)) > 90.0


@pytest.mark.parametrize("nfft", [64, 128, 256, 512, 2048])
def test_block_boundary_alignment_nfft(rng, nfft):
    # Identity-at-center filter makes any misalignment a hard error.
    h = np.zeros(9)
    h[4] = 1.0
    x = rng.integers(0, 256, size=(2, 3000), dtype=np.uint8)
    out = np.asarray(fir_overlap_save(x, h, nfft=nfft))
    np.testing.assert_allclose(out, x.astype(np.float32), atol=1e-2)


@pytest.mark.parametrize("num_taps", [1, 5, 31, 63, 64, 257, 1000, 3000])
def test_pick_nfft_bounds(num_taps):
    nfft = pick_nfft(num_taps)
    assert nfft & (nfft - 1) == 0          # power of two
    assert nfft >= max(256, 8 * num_taps)  # ≤ ~12% discard overhead
    assert nfft < max(512, 16 * num_taps)  # the smallest such power


@pytest.mark.parametrize("nfft,step,blocks", [(16, 9, 5), (32, 32, 3),
                                              (64, 20, 7), (256, 194, 4)])
def test_frame_overlap_matches_gather(rng, nfft, step, blocks):
    from warmup_fir_filter_tpu.ops.fftfilt import frame_overlap

    x = rng.standard_normal((2, step * blocks + nfft)).astype(np.float32)
    got = np.asarray(frame_overlap(x, nfft, step, blocks))
    idx = np.arange(blocks)[:, None] * step + np.arange(nfft)[None, :]
    np.testing.assert_array_equal(got, x[:, idx])


def test_u8_quantized_output_rounding(rng):
    from warmup_fir_filter_tpu.ops.resample import design_lowpass

    h = design_lowpass(63, 0.25)
    x = rng.integers(0, 256, size=(2, 3000), dtype=np.uint8)
    got = np.asarray(fir_overlap_save_quantized(x, h))
    # The quantized path filters with the Q4.12-quantized taps, then
    # rounds half up and saturates; the float64 direct FIR with the same
    # taps may differ only where the f32 FFT noise crosses a .5 tie.
    qf = QFormat()
    h_q = qf.quantize_coeffs(h).astype(np.float64) / qf.scale
    ref = np.clip(np.floor(fir1d_ideal_golden_rows(x, h_q) + 0.5), 0, 255)
    assert got.dtype == np.uint8
    assert float((got == ref).mean()) > 0.999
