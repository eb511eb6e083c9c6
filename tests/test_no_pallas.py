"""No public entry point lowers to a Pallas kernel.

Every device path is plain ``jnp``/``lax`` left to XLA, so the traced
program of each entry point must hold no ``pallas_call`` (a Pallas
kernel written for another platform runs in the interpreter on a GPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from warmup_fir_filter_tpu.models.chain import ChainConfig, chain_forward
from warmup_fir_filter_tpu.models.filters import FILTER_BANK_5TAP
from warmup_fir_filter_tpu.ops.demod import fm_demodulate
from warmup_fir_filter_tpu.ops.fftfilt import (
    fir_overlap_save,
    fir_overlap_save_quantized,
)
from warmup_fir_filter_tpu.ops.fir1d import (
    fir1d_fixed_rows_jnp,
    fir1d_ideal_rows_jnp,
)
from warmup_fir_filter_tpu.ops.fir2d import (
    FILTER_BANK_2D,
    fir2d_fixed_jnp,
    fir2d_ideal_jnp,
)
from warmup_fir_filter_tpu.ops.qformat import QFormat
from warmup_fir_filter_tpu.ops.resample import (
    design_lowpass,
    resample_poly,
    resample_poly_fixed,
)
from warmup_fir_filter_tpu.ops.streaming import _stream_step
from warmup_fir_filter_tpu.parallel import (
    fir1d_fixed_sharded,
    fir2d_fixed_sharded,
    fir_overlap_save_sharded,
    make_mesh,
)

H5 = np.asarray(FILTER_BANK_5TAP["sharpen"])
H63 = design_lowpass(63, 0.25)
H2D = FILTER_BANK_2D["gauss5"]
U8 = jax.ShapeDtypeStruct((4, 512), jnp.uint8)
F32 = jax.ShapeDtypeStruct((4, 512), jnp.float32)


def _mesh():
    return make_mesh({"data": 1, "time": 4}, devices=jax.devices()[:4])


def _stream(x):
    h = jnp.asarray(QFormat().quantize_coeffs(H5).astype(np.int32))
    return _stream_step(x.astype(jnp.int32), jnp.zeros((4, 4), jnp.int32),
                        h, 5, 12, 32)


ENTRY_POINTS = {
    "fir1d_fixed": (lambda x: fir1d_fixed_rows_jnp(x, H5), (U8,)),
    "fir1d_fixed_4096": (
        lambda x: fir1d_fixed_rows_jnp(x, design_lowpass(4096, 0.25)),
        (U8,)),
    "fir1d_ideal": (lambda x: fir1d_ideal_rows_jnp(x, H63), (U8,)),
    "fir2d_fixed": (lambda x: fir2d_fixed_jnp(x, H2D), (U8,)),
    "fir2d_ideal": (lambda x: fir2d_ideal_jnp(x, H2D), (U8,)),
    "overlap_save": (lambda x: fir_overlap_save(x, H63), (F32,)),
    "overlap_save_u8": (lambda x: fir_overlap_save_quantized(x, H63), (U8,)),
    "resample": (lambda x: resample_poly(x, H63, 2, 3), (F32,)),
    "resample_fixed": (lambda x: resample_poly_fixed(x, H5, 2, 3), (U8,)),
    "demod": (lambda a, b: fm_demodulate(a, b, 0.05), (F32, F32)),
    "chain": (lambda a, b: chain_forward(a, b, ChainConfig()), (F32, F32)),
    "stream_step": (_stream, (U8,)),
    "fir1d_sharded": (
        lambda x: fir1d_fixed_sharded(x, H5, mesh=_mesh()), (U8,)),
    "fir2d_sharded": (
        lambda x: fir2d_fixed_sharded(
            x, H2D, mesh=make_mesh({"data": 2, "time": 2},
                                   devices=jax.devices()[:4])), (U8,)),
    "overlap_save_sharded": (
        lambda x: fir_overlap_save_sharded(x, H63, mesh=_mesh()), (U8,)),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_has_no_pallas_call(name):
    fn, args = ENTRY_POINTS[name]
    jaxpr = str(jax.make_jaxpr(fn)(*args))
    assert "pallas_call" not in jaxpr
    assert "custom_call" not in jaxpr
