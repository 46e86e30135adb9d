"""Multi-chip execution: device meshes, halo exchange, sharded pipelines.

No reference equivalent exists — the reference is a single sequential CPU
process (SURVEY.md §2.6).  The scaling model here follows BASELINE.json
configs 3-5:

* ``station`` mesh axis — beacon channels / stations, embarrassingly
  data parallel;
* ``time`` mesh axis — one long stream split into contiguous sample
  ranges; STFT overlap and FIR warm-up tails cross shard seams and are
  exchanged as halos via ``lax.ppermute`` between neighbouring shards;
* detections are reduced per shard and merged at seams so the sharded
  event list equals the unsharded one.
"""

from meteor_scatter_tpu.parallel.mesh import make_mesh, station_time_specs  # noqa: F401
from meteor_scatter_tpu.parallel.halo import halo_exchange  # noqa: F401
from meteor_scatter_tpu.parallel.sharded import (  # noqa: F401
    sharded_delta_power,
    sharded_detect_fixed,
    sharded_detect_adaptive,
    sharded_detect_adaptive_exact,
    sharded_spectrogram_psd,
    sharded_fir_filter,
    sharded_welch_blocks,
)
