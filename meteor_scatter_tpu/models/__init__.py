"""Detector model families.

Four detectors re-create the reference's detection capabilities as
compiled array programs with static shapes:

* :mod:`fixed`      — global mean+σ threshold   (dsp/src/main.py:396-448)
* :mod:`adaptive`   — rolling window + freeze   (dsp/src/main.py:450-522)
* :mod:`streaming`  — 3-state machine           (dsp/src/live/backend/processor.py:444-510)
* :mod:`image`      — spectrogram cluster path  (meteor_detect_class/)
"""

from meteor_scatter_tpu.models.events import (  # noqa: F401
    Events,
    events_from_mask,
    merge_adjacent,
)
from meteor_scatter_tpu.models.fixed import detect_fixed  # noqa: F401
from meteor_scatter_tpu.models.adaptive import adaptive_thresholds, detect_adaptive  # noqa: F401
from meteor_scatter_tpu.models.image import (  # noqa: F401
    cluster_bursts,
    corner_keypoints,
    detect_and_cluster_bursts,
    spectrogram_image,
)
from meteor_scatter_tpu.models.streaming import (  # noqa: F401
    StreamConfig,
    StreamState,
    stream_init,
    stream_process,
)
