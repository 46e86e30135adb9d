"""Core DSP ops: windows, framing, band-power projection, Welch PSD,
spectrograms, FIR/polyphase filtering, and the Pallas streaming kernel."""

from meteor_scatter_tpu.ops.window import hann_symmetric, hann_periodic, get_window  # noqa: F401
from meteor_scatter_tpu.ops.framing import frame_signal, num_frames  # noqa: F401
from meteor_scatter_tpu.ops.bandpower import (  # noqa: F401
    band_projection_matrix,
    band_power_db,
    delta_power_db,
)
from meteor_scatter_tpu.ops.welch import welch_psd, welch_freqs  # noqa: F401
from meteor_scatter_tpu.ops.spectrogram import (  # noqa: F401
    spectrogram_scipy,
    spectrogram_mpl,
    spectrogram_db,
)
from meteor_scatter_tpu.ops.fir import (  # noqa: F401
    firwin_lowpass,
    firwin_bandpass,
    fir_filter,
    polyphase_decimate,
    resample_poly,
)
