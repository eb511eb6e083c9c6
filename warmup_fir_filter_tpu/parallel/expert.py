"""Filter-bank (expert) parallelism: different filters on different chips.

The EP axis of SURVEY.md §2.3: the reference iterates its coefficient
bank sequentially per case (``gen_fixed_output.py:92``); here the bank
itself is sharded — each device holds F/n filters, the input block is
replicated, and every device produces its filters' outputs locally, so
the only communication is the initial broadcast (free when the input is
already replicated) and none at all afterwards.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from warmup_fir_filter_tpu.ops.fir1d import (
    fixed_fir_prehaloed_i32,
    pad_rows_same_mode,
)
from warmup_fir_filter_tpu.ops.qformat import QFormat


def filter_bank_fixed_sharded(
    x_u8,
    h_bank,
    qformat: QFormat = QFormat(),
    *,
    mesh: Mesh,
    expert_axis: str = "data",
) -> jax.Array:
    """Apply an (F, L) filter bank to (C, T) rows; F sharded over a mesh axis.

    Returns (F, C, T) uint8, sharded along the filter axis.  Bit-exact
    per filter against the single-chip fixed path.
    """
    if not qformat.int32_exact:
        raise ValueError(
            f"acc_bits={qformat.acc_bits} > 32 is not representable in the "
            "int32 device path."
        )
    h_bank = np.asarray(h_bank, np.float64)
    if h_bank.ndim != 2:
        raise ValueError(f"h_bank must be (F, L), got shape {h_bank.shape}")
    num_filters, num_taps = h_bank.shape
    num_experts = mesh.shape[expert_axis]
    if num_filters % num_experts:
        raise ValueError(
            f"F={num_filters} not divisible by mesh axis "
            f"{expert_axis!r}={num_experts}."
        )
    h_fixed = np.stack(
        [qformat.quantize_coeffs(h).astype(np.int32) for h in h_bank]
    )

    x = jnp.asarray(x_u8, jnp.int32)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(expert_axis, None)),
        out_specs=P(expert_axis, None, None),
    )
    def _apply(x_rep, h_loc):
        xp = pad_rows_same_mode(x_rep, num_taps)

        def one_filter(h_i32):
            return fixed_fir_prehaloed_i32(
                xp, h_i32, num_taps, qformat.frac_bits, qformat.acc_bits
            )

        return jax.vmap(one_filter)(h_loc)

    x_rep = jax.device_put(x, NamedSharding(mesh, P()))
    h_sharded = jax.device_put(
        jnp.asarray(h_fixed), NamedSharding(mesh, P(expert_axis, None))
    )
    return jax.jit(_apply)(x_rep, h_sharded)
