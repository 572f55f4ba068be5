"""Runtime tunables (copy of the JAX package's ``constants.py``: every field,
with the same defaults, but the kernel switches).

The reference keeps ~25 compile-time constexpr knobs in sources/config.h:10-38;
here they live as a dataclass with reference defaults, and Config
(runtime/config.py) can override any of them from JSON ("tunables" section).

No kernel switches: the reference's ``use_pallas_psd`` / ``use_pallas_select``
/ ``use_pallas_fir`` have no counterpart. Each kernel's wrapper picks its
route by the tensor's device (CPU: the plain version; CUDA: the kernel, or
it raises); a config that sets one gets the "unknown tunables ignored"
warning.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Tunables:
    # debug raw-dump sinks (reference config.h:11-13)
    debug_save_full_raw_iq: bool = False
    debug_save_full_power: bool = False
    debug_save_recording_raw_iq: bool = False

    # lifecycle (config.h:14-21)
    initial_delay_ms: int = 1000
    log_file_name: str = "sdr_scanner.log"
    log_file_size: int = 10 * 1024 * 1024
    log_files_count: int = 9
    performance_logger_interval: int = 1000
    recorder_flush_interval_ms: int = 100
    resampler_threshold: int = 125
    transmission_max_time_ms: int = 10 * 60 * 1000

    # scanning (config.h:24-25)
    noise_learning_time_ms: int = 2000
    range_scanning_time_ms: int = 500

    # signal detection (config.h:28-33)
    grouping_x: int = 21  # frequency-domain smoothing width (bins)
    grouping_y: int = 21  # time-domain smoothing depth (frames)
    default_recording_start_level: float = 8.0
    default_recording_stop_level: float = 5.0
    signal_detection_fps: int = 50
    signal_detection_max_step: int = 250  # max Hz per FFT bin

    # spectrogram (config.h:36-38)
    spectrogram_preferred_max_step: int = 1000
    spectrogram_max_fft: int = 16384
    spectrogram_send_interval_ms: int = 1000

    # additions over the reference
    # process every FFT frame instead of decimating to signal_detection_fps
    # (an accuracy upgrade, off by default for parity)
    dense_detection: bool = False
    # frames handed to the device per block step (the session grows it so a
    # block divides the DDC chain, sdr_device._fix_block_multiple)
    frames_per_block: int = 16
    # upload IQ as int8 (cs8) and dequantize on the device: a quarter of the
    # host->device bytes of complex64
    int8_ingest: bool = True
    # keep the detector math on the device and fetch compact top-K candidate
    # summaries instead of full power rows (ops/detect.py); full-row mode is
    # the exact parity reference
    compact_detection: bool = True
    # compact mode geometry: candidate capacity and tracked-key slots
    detection_top_k: int = 64
    detection_key_slots: int = 16
    # tolerance mode: the selection sweeps read bf16 copies of the rows;
    # every reported value stays f32 (held to decision parity)
    detection_bf16: bool = True
    # deeper tolerance mode: store the noise-subtracted rows (and the
    # averager ring) in bf16
    power_bf16: bool = False
    # persist learned noise floors across restarts ("" = relearn like the
    # reference, noise_learner.cpp:69-72); path gets the device name appended
    noise_state_path: str = ""
    # keep one block in flight on the device while the host consumes the
    # previous one (hop decisions shift by <= 1 block); off by default for
    # deterministic replay parity
    pipelined_ingest: bool = False
    # write a torch.profiler trace of replayed scans to this directory
    # ("" = off); on the card it shows graph replays and their kernels, each
    # stage of a replayed step between its two marker kernels
    # (trace_enter_<stage>, trace_exit_<stage>: utils/trace.py)
    profile_dir: str = ""
    # multi-device bands mesh: a wideband device's channels in band shards
    # over this many cards (-1: every visible card; 0: none), shrunk until it
    # divides the channels
    mesh_bands: int = 0
    # wideband mode: fuse the banded DDC into the channelize+scan dispatch
    wideband_fused_dispatch: bool = False
    # wideband front-end: 1 = the critically sampled polyphase bank, 2 = a
    # 2x-oversampled one
    channelizer_oversample: int = 1
    # wideband tolerance mode: bf16 bank operands, f32 accumulation
    channelizer_bf16: bool = False
    # live ingest ring overflow policy: drops are always logged and counted
    # (SoapySource.dropped_bytes); fatal stops the stream on the first drop
    ingest_overflow_fatal: bool = False
    # live ingest ring capacity in seconds of CF32 at the device sample rate
    ingest_ring_seconds: float = 2.0
    # multi-host runtime: join the process group the JAX_COORDINATOR_ADDRESS
    # / JAX_NUM_PROCESSES / JAX_PROCESS_ID environment names
    multihost: bool = False
    # multi-device time mesh: one band's block split over this many cards
    # (0: none)
    mesh_time: int = 0

# Module-level default instance; runtime code takes a Tunables argument and
# defaults to this.
DEFAULT = Tunables()

# Sentinel emitted while the noise floor / averager warm up
# (reference radio_utils.cpp:72-76 setNoData).
NO_DATA = -100.0
