"""Streaming FIR tests: offline equivalence + checkpoint/resume."""

import numpy as np
import pytest

from warmup_fir_filter_tpu.models.filters import FILTER_BANKS
from warmup_fir_filter_tpu.models.golden import fir1d_fixed_golden_rows
from warmup_fir_filter_tpu.ops.qformat import QFormat
from warmup_fir_filter_tpu.ops.streaming import (
    Fir1DStream,
    FirStreamState,
    host_emit_checksums,
)


def _stream_all(stream, x, block):
    chunks = [
        stream.process(x[:, i : i + block])
        for i in range(0, x.shape[1], block)
    ]
    chunks.append(stream.flush())
    return np.concatenate(chunks, axis=1)


@pytest.mark.parametrize("block", [1, 7, 32, 100])
@pytest.mark.parametrize("tap", [3, 5])
def test_streaming_equals_offline(rng, tap, block):
    h = np.asarray(FILTER_BANKS[tap]["sharpen"])
    x = rng.integers(0, 256, size=(3, 100), dtype=np.uint8)
    stream = Fir1DStream(h, channels=3)
    emitted = _stream_all(stream, x, block)
    offline = fir1d_fixed_golden_rows(x, h)
    center = tap // 2
    # Emitted stream is the offline output delayed by `center` samples.
    np.testing.assert_array_equal(emitted[:, center:center + 100], offline)


def test_checkpoint_resume_bit_exact(rng, tmp_path):
    h = np.asarray(FILTER_BANKS[5]["edge"])
    x = rng.integers(0, 256, size=(2, 240), dtype=np.uint8)

    # Uninterrupted run.
    s1 = Fir1DStream(h, channels=2)
    full = np.concatenate(
        [s1.process(x[:, :120]), s1.process(x[:, 120:]), s1.flush()], axis=1
    )

    # Interrupted run: checkpoint after the first block, resume fresh.
    s2 = Fir1DStream(h, channels=2)
    part1 = s2.process(x[:, :120])
    s2.state.save(tmp_path / "ckpt.npz")

    s3 = Fir1DStream(h, channels=2)
    s3.state = FirStreamState.load(tmp_path / "ckpt.npz")
    part2 = np.concatenate([s3.process(x[:, 120:]), s3.flush()], axis=1)

    np.testing.assert_array_equal(np.concatenate([part1, part2], 1), full)
    assert s3.state.samples_seen == 240 + 2  # +flush zeros


def test_reset_zeroes_delay_line(rng):
    h = np.asarray(FILTER_BANKS[3]["moving_avg"])
    x = rng.integers(0, 256, size=(1, 50), dtype=np.uint8)
    stream = Fir1DStream(h, channels=1)
    first = stream.process(x)
    stream.reset()
    second = stream.process(x)
    np.testing.assert_array_equal(first, second)


def test_single_tap_stream(rng):
    x = rng.integers(0, 256, size=(2, 40), dtype=np.uint8)
    stream = Fir1DStream([1.0], channels=2)
    np.testing.assert_array_equal(stream.process(x), x)
    assert stream.flush().shape == (2, 0)


def test_custom_qformat_stream(rng):
    qf = QFormat(acc_bits=16, frac_bits=8)
    h = np.array([7.5, -8.0, 7.5])
    x = rng.integers(0, 256, size=(2, 64), dtype=np.uint8)
    stream = Fir1DStream(h, channels=2, qformat=qf)
    emitted = _stream_all(stream, x, 16)
    offline = fir1d_fixed_golden_rows(x, h, qf)
    np.testing.assert_array_equal(emitted[:, 1:65], offline)


def test_wrong_channel_count_rejected(rng):
    stream = Fir1DStream([0.5], channels=2)
    with pytest.raises(ValueError, match="channels"):
        stream.process(np.zeros((3, 8), np.uint8))


class TestStreamScanned:
    """The on-device lax.scan block loop (r4, ops/streaming.py)."""

    def _gen(self, channels, width):
        import jax
        import jax.numpy as jnp

        def block_fn(b):
            base = b.astype(jnp.uint32) * jnp.uint32(2654435761)
            col = jax.lax.broadcasted_iota(jnp.uint32, (channels, width), 1)
            row = jax.lax.broadcasted_iota(jnp.uint32, (channels, width), 0)
            v = (col * jnp.uint32(747796405)
                 + row * jnp.uint32(2891336453) + base)
            v = (v ^ (v >> 13)) * jnp.uint32(1274126177)
            return ((v >> 8) & jnp.uint32(255)).astype(jnp.uint8)

        return block_fn

    def test_matches_blockwise_process(self):
        import jax.numpy as jnp

        from warmup_fir_filter_tpu.ops.streaming import stream_scanned

        h = np.array([0.25, 1.0, -0.5, 0.125, 0.0625])
        channels, width, blocks = 4, 96, 5
        block_fn = self._gen(channels, width)

        scanned = Fir1DStream(h, channels)
        sums = np.asarray(stream_scanned(scanned, block_fn, blocks))
        assert sums.shape == (blocks, 3)

        manual = Fir1DStream(h, channels)
        for b in range(blocks):
            y = manual.process(np.asarray(block_fn(jnp.int32(b))))
            got = sums[b].astype(np.uint64)
            want = host_emit_checksums(y)
            # default emit checksums are uint32 residues mod 2**32
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(manual.state.carry,
                                      scanned.state.carry)
        assert manual.state.samples_seen == scanned.state.samples_seen

    def test_resume_from_checkpoint(self, tmp_path):
        from warmup_fir_filter_tpu.ops.streaming import stream_scanned

        h = np.array([0.5, 1.0, 0.5])
        channels, width, blocks = 2, 64, 6
        block_fn = self._gen(channels, width)

        full = Fir1DStream(h, channels)
        sums_full = np.asarray(stream_scanned(full, block_fn, blocks))

        a = Fir1DStream(h, channels)
        sums_a = np.asarray(stream_scanned(a, block_fn, 3))
        a.state.save(tmp_path / "ck.npz")
        b = Fir1DStream(h, channels)
        b.state = FirStreamState.load(tmp_path / "ck.npz")
        sums_b = np.asarray(stream_scanned(b, block_fn, 3, start_block=3))
        np.testing.assert_array_equal(
            np.concatenate([sums_a, sums_b]), sums_full)
        np.testing.assert_array_equal(b.state.carry, full.state.carry)



@pytest.mark.parametrize("block", [1, 33, 100])
@pytest.mark.parametrize("num_taps", [7, 63, 129, 300])
def test_streaming_long_filters_equal_offline(rng, num_taps, block):
    """Delay lines longer than a block, and filters past the unrolled
    tap block (``ops/fir1d.py::TAP_BLOCK``), keep the stream contract."""
    from warmup_fir_filter_tpu.ops.resample import design_lowpass

    h = design_lowpass(num_taps, 0.3)
    x = rng.integers(0, 256, size=(2, 400), dtype=np.uint8)
    emitted = _stream_all(Fir1DStream(h, channels=2), x, block)
    center = num_taps // 2
    np.testing.assert_array_equal(emitted[:, center:center + 400],
                                  fir1d_fixed_golden_rows(x, h))


@pytest.mark.parametrize("num_taps", [3, 5, 63, 257])
def test_scanned_matches_blockwise_taps(num_taps):
    import jax.numpy as jnp

    from warmup_fir_filter_tpu.ops.resample import design_lowpass
    from warmup_fir_filter_tpu.ops.streaming import stream_scanned

    h = design_lowpass(num_taps, 0.3)
    channels, width, blocks = 3, 200, 4
    block_fn = TestStreamScanned()._gen(channels, width)
    scanned = Fir1DStream(h, channels)
    sums = np.asarray(stream_scanned(scanned, block_fn, blocks))
    manual = Fir1DStream(h, channels)
    for b in range(blocks):
        y = manual.process(np.asarray(block_fn(jnp.int32(b))))
        np.testing.assert_array_equal(sums[b].astype(np.uint64),
                                      host_emit_checksums(y))
    np.testing.assert_array_equal(manual.state.carry, scanned.state.carry)


def test_scanned_custom_emit(rng):
    """A custom ``emit_fn`` sees each output block in order."""
    import jax
    import jax.numpy as jnp

    from warmup_fir_filter_tpu.ops.streaming import stream_scanned

    h = np.asarray(FILTER_BANKS[5]["sharpen"])
    data = rng.integers(0, 256, size=(3, 2, 50), dtype=np.uint8)
    dev = jnp.asarray(data)
    block_fn = lambda b: jax.lax.dynamic_index_in_dim(dev, b, 0, False)  # noqa: E731
    got = np.asarray(stream_scanned(Fir1DStream(h, 2), block_fn, 3,
                                    emit_fn=lambda y: y))
    manual = Fir1DStream(h, 2)
    want = np.stack([manual.process(data[b]) for b in range(3)])
    np.testing.assert_array_equal(got, want)
