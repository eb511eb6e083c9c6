"""Worker process for the 2-process jax.distributed test.

Invoked by ``tests/test_multihost.py`` as::

    python tests/_multihost_worker.py <process_id> <num_processes> <port>

Each process contributes 2 virtual CPU devices; the combined 4-device
mesh runs the halo-exchange sharded FIR and each process bit-checks its
addressable output shards against the numpy golden.  This is the
multi-process code path (multi-process runtime + cross-process
collectives) that the reference's filesystem-as-transport never had
(SURVEY.md §5.8).  Both processes stay on the CPU.
"""

import os
import sys

proc_id, num_procs, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from warmup_fir_filter_tpu.models.filters import FILTER_BANK_5TAP  # noqa: E402
from warmup_fir_filter_tpu.models.golden import (  # noqa: E402
    fir1d_fixed_golden_rows,
)
from warmup_fir_filter_tpu.parallel import (  # noqa: E402
    fir1d_fixed_sharded,
    make_mesh,
)
from warmup_fir_filter_tpu.parallel.distributed import (  # noqa: E402
    initialize_multihost,
)


def main() -> int:
    initialized = initialize_multihost(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=num_procs,
        process_id=proc_id,
    )
    assert initialized, "initialize_multihost() reported single-process"
    assert jax.process_count() == num_procs, jax.process_count()
    assert len(jax.devices()) == 2 * num_procs, len(jax.devices())
    assert len(jax.local_devices()) == 2, len(jax.local_devices())

    # Identical global input on every process (SPMD lockstep).
    rng = np.random.default_rng(42)
    x = rng.integers(0, 256, size=(8, 256), dtype=np.uint8)
    h = np.asarray(FILTER_BANK_5TAP["sharpen"])

    golden = fir1d_fixed_golden_rows(x, h)
    checked = 0

    # Two mesh layouts: (a) data axis crossing processes, time within;
    # (b) the time axis spanning ALL devices, so the overlap-save halo
    # ppermute ring itself crosses the process boundary.
    for axes in ({"data": 2, "time": num_procs},
                 {"data": 1, "time": 2 * num_procs}):
        mesh = make_mesh(axes)
        sharding = NamedSharding(mesh, P("data", "time"))
        x_global = jax.make_array_from_callback(
            x.shape, sharding, lambda idx: x[idx]
        )
        out = fir1d_fixed_sharded(x_global, h, mesh=mesh)
        for shard in out.addressable_shards:
            got = np.asarray(shard.data)
            expected = golden[shard.index]
            if not np.array_equal(got, expected):
                print(f"[FAIL] process {proc_id} mesh={axes} shard "
                      f"{shard.index}: mismatch vs golden", flush=True)
                return 1
            checked += 1
    assert checked > 0, "process owned no output shards"

    # --- all_to_all: channel↔time reshard roundtrip across processes ---
    # The flat 4-device axis spans both processes, so every all_to_all
    # lane crosses the process boundary.
    from warmup_fir_filter_tpu.parallel.reshard import (
        channel_to_time,
        time_to_channel,
    )

    n_dev = 2 * num_procs
    flip_mesh = make_mesh({"data": n_dev})
    xb = (np.arange(n_dev * 4 * n_dev * 8) % 255).astype(
        np.uint8).reshape(n_dev * 4, n_dev * 8)
    flipped = channel_to_time(xb, mesh=flip_mesh)
    back = time_to_channel(flipped, mesh=flip_mesh)
    for shard in back.addressable_shards:
        if not np.array_equal(np.asarray(shard.data), xb[shard.index]):
            print(f"[FAIL] process {proc_id} all_to_all roundtrip shard "
                  f"{shard.index}: mismatch", flush=True)
            return 1

    # --- psum: global metric reduction across process boundaries ---
    # Each device reduces its local |fixed − ideal| sum; one psum yields
    # the global MAE numerator on every device — the collective form of
    # the report stage's overall rollup (SURVEY.md §3.3).
    from functools import partial

    import jax.numpy as jnp
    from jax import shard_map

    from warmup_fir_filter_tpu.models.golden import fir1d_ideal_golden_rows

    ideal = fir1d_ideal_golden_rows(x, h)
    mesh = make_mesh({"data": 1, "time": n_dev})
    sharding = NamedSharding(mesh, P("data", "time"))
    fixed_g = jax.make_array_from_callback(
        golden.shape, sharding, lambda idx: golden[idx])
    ideal_g = jax.make_array_from_callback(
        ideal.shape, sharding, lambda idx: ideal.astype(np.float64)[idx])

    @partial(shard_map, mesh=mesh, in_specs=(P("data", "time"),) * 2,
             out_specs=P())
    def _global_abs_err(fx, idl):
        local = jnp.sum(jnp.abs(fx.astype(jnp.float64) - idl))
        return jax.lax.psum(jax.lax.psum(local, "time"), "data")[None]

    got_sum = float(np.asarray(jax.jit(_global_abs_err)(fixed_g, ideal_g))[0])
    want_sum = float(np.abs(golden.astype(np.float64) - ideal).sum())
    if abs(got_sum - want_sum) > 1e-6 * max(want_sum, 1.0):
        print(f"[FAIL] process {proc_id} psum metric reduction: "
              f"{got_sum} != {want_sum}", flush=True)
        return 1

    # --- flagship chain, data-parallel across BOTH processes (r4) ---
    # shard_map row-parallelism: every process computes its local
    # channel rows; outputs must match the single-device chain exactly.
    from warmup_fir_filter_tpu.models.chain import (
        ChainConfig,
        chain_forward,
        chain_forward_sharded,
    )

    chain_cfg = ChainConfig()
    ch_c, ch_t = n_dev * 2, 4096
    ch_re = rng.standard_normal((ch_c, ch_t)).astype(np.float32)
    ch_im = rng.standard_normal((ch_c, ch_t)).astype(np.float32)
    chain_mesh = make_mesh({"data": n_dev})
    out_chain = chain_forward_sharded(ch_re, ch_im, chain_cfg,
                                      mesh=chain_mesh)
    expected_chain = np.asarray(chain_forward(ch_re, ch_im, chain_cfg))
    for shard in out_chain.addressable_shards:
        if not np.allclose(np.asarray(shard.data),
                           expected_chain[shard.index],
                           rtol=1e-5, atol=1e-5):
            print(f"[FAIL] process {proc_id} chain shard {shard.index}: "
                  "mismatch vs single-device", flush=True)
            return 1

    # --- 2-D corner-carrying halo FIR across the process boundary (r4) ---
    from warmup_fir_filter_tpu.ops.fir2d import (
        FILTER_BANK_2D,
        fir2d_fixed_golden,
    )
    from warmup_fir_filter_tpu.parallel.halo import fir2d_fixed_sharded

    img = rng.integers(0, 256, size=(64, 64), dtype=np.uint8)
    h2 = np.asarray(FILTER_BANK_2D["gauss5"])
    golden_2d = fir2d_fixed_golden(img, h2)
    mesh_2d = make_mesh({"data": 2, "time": num_procs})
    out_2d = fir2d_fixed_sharded(img, h2, mesh=mesh_2d)
    for shard in out_2d.addressable_shards:
        if not np.array_equal(np.asarray(shard.data), golden_2d[shard.index]):
            print(f"[FAIL] process {proc_id} 2-D halo shard {shard.index}: "
                  "mismatch vs golden", flush=True)
            return 1

    print(f"[OK] multihost worker process={proc_id} shards={checked} "
          "bit-exact (incl. cross-process halo ring); all_to_all "
          "roundtrip + psum metric reduction + data-parallel chain + "
          "2-D corner halo crossed the process boundary", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
