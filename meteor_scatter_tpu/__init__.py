"""meteor_scatter_tpu — a meteor-scatter detection framework for the GPU.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
th-nuernberg/meteor-scatter (reference mounted read-only at /root/reference):
forward-scatter radio meteor echo detection from SDR audio around the BRAMS
49.97 MHz beacon tone, covering

* the DSP batch analyzer        (reference: dsp/src/main.py)
* the streaming state-machine   (reference: dsp/src/live/backend/processor.py)
* the spectrogram-image path    (reference: meteor_detect_class/)
* the CSV ledger + dashboard    (reference: app.py / plot.py / database.py)

The compute path is pure JAX: framed band power is computed as a windowed
DFT-selector *matmul*, spectrograms as batched XLA rFFTs, the
sequential detectors as `lax.scan`, and multi-device scaling via
`jax.sharding.Mesh` + `shard_map` with collective halo exchange.
"""

__version__ = "0.1.0"

from meteor_scatter_tpu.config import (  # noqa: F401
    AnalyzeConfig,
    BandPowerConfig,
    DetectionConfig,
    ShardingConfig,
    SpecExportConfig,
    VisualizationConfig,
)
