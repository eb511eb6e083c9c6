"""warmup_fir_filter_tpu — a JAX DSP verification framework.

A from-scratch JAX/XLA re-design of the capabilities of the
``young-0320/warmup-fir-filter`` reference repo (see SURVEY.md): a float
"ideal" FIR model, a bit-accurate Q-format fixed-point "golden" FIR model,
a 5-stage verification pipeline (input vectors → ideal outputs → fixed
outputs → compare reports → restored images), error/saturation metrics,
plus the extensions mandated by BASELINE.json: 2D FIR, FFT overlap-save,
polyphase resampling, FM demod, and multi-device sharding with halo
exchange.

Layout
------
- ``ops/``       bit-exact fixed-point primitives + jnp compute paths
- ``parallel/``  mesh / shard_map / halo-exchange layer
- ``models/``    golden (trusted numpy oracle) + reference-parity API + chain
- ``pipeline/``  artifact store, stages, reports, restore
- ``utils/``     logging, image IO, compile cache, profiling
"""

from warmup_fir_filter_tpu.ops.qformat import QFormat

__version__ = "0.1.0"

__all__ = ["QFormat", "__version__"]
