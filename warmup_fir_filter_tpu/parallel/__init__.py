"""Multi-chip sharding layer: mesh helpers, halo exchange, resharding.

The reference has zero parallelism (SURVEY.md §2.3); this package supplies
the axes mandated by BASELINE.json's north star: data parallel over
channels/cases, sequence parallel over time blocks with overlap-save halo
exchange (``ppermute``), and channel↔time resharding (``all_to_all``).
"""

from warmup_fir_filter_tpu.parallel.mesh import make_mesh
from warmup_fir_filter_tpu.parallel.halo import (
    exchange_halo_1d,
    exchange_halo_2d,
    fir1d_fixed_sharded,
    fir2d_fixed_sharded,
)
from warmup_fir_filter_tpu.parallel.reshard import (
    channel_to_time,
    time_to_channel,
)
from warmup_fir_filter_tpu.parallel.expert import filter_bank_fixed_sharded
from warmup_fir_filter_tpu.parallel.fft_sharded import (
    fir_overlap_save_sharded,
)
from warmup_fir_filter_tpu.parallel.pipeline_parallel import PipelinedChain
from warmup_fir_filter_tpu.parallel.spmd_pipeline import spmd_pipeline
from warmup_fir_filter_tpu.parallel.distributed import initialize_multihost

__all__ = [
    "make_mesh",
    "exchange_halo_1d",
    "exchange_halo_2d",
    "fir1d_fixed_sharded",
    "fir2d_fixed_sharded",
    "channel_to_time",
    "time_to_channel",
    "filter_bank_fixed_sharded",
    "fir_overlap_save_sharded",
    "PipelinedChain",
    "spmd_pipeline",
    "initialize_multihost",
]
