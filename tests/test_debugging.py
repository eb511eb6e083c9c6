"""Numerical-safety utilities tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from warmup_fir_filter_tpu.utils.debugging import (
    assert_deterministic,
    nan_guard,
)


def test_nan_guard_raises_on_nan():
    with nan_guard():
        with pytest.raises(FloatingPointError):
            jax.jit(lambda x: x / 0.0)(jnp.float32(0.0)).block_until_ready()


def test_nan_guard_restores_config():
    before = jax.config.jax_debug_nans
    with nan_guard():
        pass
    assert jax.config.jax_debug_nans == before


def test_nan_guard_disabled_passthrough():
    with nan_guard(enabled=False):
        out = jax.jit(lambda x: x * 0.0)(jnp.float32(1.0))
    assert float(out) == 0.0


def test_assert_deterministic_passes_for_fixed_path(rng):
    from warmup_fir_filter_tpu.ops.fir1d import fir1d_fixed_rows_jnp

    x = rng.integers(0, 256, size=(3, 64), dtype=np.uint8)
    assert_deterministic(lambda: fir1d_fixed_rows_jnp(x, [0.25, 0.5, 0.25]))


def test_assert_deterministic_detects_mutation():
    state = {"n": 0}

    def flaky():
        state["n"] += 1
        return np.array([state["n"]])

    with pytest.raises(AssertionError, match="Non-deterministic"):
        assert_deterministic(flaky)
