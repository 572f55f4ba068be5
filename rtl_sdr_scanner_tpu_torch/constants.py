"""Runtime tunables read by the device program (copy of the JAX package's
``constants.py`` fields this package uses, with the same defaults)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Tunables:
    # scanning / signal detection (reference config.h:24-33)
    noise_learning_time_ms: int = 2000
    grouping_x: int = 21  # frequency-domain smoothing width (bins)
    grouping_y: int = 21  # time-domain smoothing depth (frames)
    signal_detection_fps: int = 50
    signal_detection_max_step: int = 250  # max Hz per FFT bin

    # spectrogram (config.h:36-38)
    spectrogram_preferred_max_step: int = 1000
    spectrogram_max_fft: int = 16384

    # device-program switches
    dense_detection: bool = False
    # selection sweeps read bf16 copies of the rows; reported values stay f32
    detection_bf16: bool = True
    # hand-written PSD kernel (ops/cuda/psd_kernel.py) for int8 ingest
    use_pallas_psd: bool = False
    # hand-written selection kernel (ops/cuda/select_kernel.py)
    use_pallas_select: bool = False


DEFAULT = Tunables()

# Sentinel emitted while the noise floor / averager warm up
# (reference radio_utils.cpp:72-76 setNoData).
NO_DATA = -100.0
