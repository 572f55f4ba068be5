"""IQ sample sources (host side).

Two backends behind one interface:

- ReplaySource: recorded-IQ files (cf32 / cs8 / cu8, conventions from
  scripts/converter.py:30-39 of the reference). First-class test/bench
  backend -- the reference has no equivalent (its weak spot per SURVEY.md
  section 4); every BASELINE.json config starts from replayed IQ.
- SoapySource: real hardware via SoapySDR python bindings (reference
  sources/radio/blocks/sdr_source.cpp), gated on the bindings' presence.

Sources produce fixed-size blocks of samples for the device pipeline. A block
is (samples, stream_time_ms). Stream time derives from the sample counter --
deterministic for replay, wall-clock-anchored for hardware.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np

from rtl_sdr_scanner_tpu_torch import native
from rtl_sdr_scanner_tpu_torch.runtime.config import DeviceSpec
from rtl_sdr_scanner_tpu_torch.utils import logger

LABEL = "source"



class ReplaySource:
    """Block reader over a recorded IQ capture.

    Formats (converter.py:30-39): cf32 = interleaved float32 I/Q;
    cs8 = interleaved int8 (x/127.5); cu8 = interleaved uint8 offset-binary
    ((x-127.5)/127.5, rtl_sdr convention).
    """

    def __init__(self, device: DeviceSpec, loop: bool = False):
        if not device.file:
            raise ValueError("replay device has no file")
        self._path = device.file
        self._format = device.file_format
        self._rate = device.sample_rate
        self._loop = loop
        self._offset = 0  # in samples
        self._center: int = 0
        self._exhausted = False
        if self._format == "cf32":
            self._raw = np.memmap(self._path, dtype=np.float32, mode="r")
            self._total = self._raw.size // 2
        elif self._format == "cs8":
            self._raw = np.memmap(self._path, dtype=np.int8, mode="r")
            self._total = self._raw.size // 2
        elif self._format == "cu8":
            self._raw = np.memmap(self._path, dtype=np.uint8, mode="r")
            self._total = self._raw.size // 2
        else:
            raise ValueError(f"unknown replay format: {self._format}")
        logger.info(
            LABEL,
            "replay source: {}, format: {}, rate: {}, samples: {}",
            self._path,
            self._format,
            self._rate,
            self._total,
        )

    @property
    def sample_rate(self) -> int:
        return self._rate

    @property
    def session_epoch_ms(self) -> int:
        """Epoch milliseconds at stream start. Replay is deterministic: the
        stream clock IS the payload clock (0 epoch), so replay payloads carry
        stream-relative time and tests stay reproducible."""
        return 0

    @property
    def exhausted(self) -> bool:
        """True once a read could not be satisfied (non-loop mode)."""
        return self._exhausted

    def set_center_frequency(self, frequency: int) -> bool:
        """Replay captures are fixed-band; retunes are bookkeeping only."""
        self._center = frequency
        return True

    def reset_buffers(self) -> None:
        pass

    def stream_time_ms(self) -> int:
        """Milliseconds of stream consumed so far (monotonic sample clock)."""
        return int(self._offset * 1000 // self._rate)

    def read_block(self, n_samples: int) -> Optional[np.ndarray]:
        """Next n_samples as complex64, or None when exhausted.

        Wraps around in loop mode (bench/soak); the partial tail of a
        non-looping file is dropped like the reference's stream_to_vector
        partial vector.
        """
        if self._offset + n_samples > self._total:
            if not self._loop:
                self._exhausted = True
                return None
            self._offset = self._offset % max(1, self._total - n_samples + 1)
        start = self._offset * 2
        raw = np.asarray(self._raw[start : start + n_samples * 2])
        self._offset += n_samples
        if self._format == "cf32":
            return raw.view(np.complex64).copy()
        if self._format == "cs8":
            return native.cs8_to_complex64(raw)
        return native.cu8_to_complex64(raw)

    def read_block_int8(self, n_samples: int) -> Optional[np.ndarray]:
        """Next n_samples as raw int8 [n, 2] (cs8) for on-device dequant --
        quarter host->device bandwidth. Only for cs8 captures."""
        if self._format != "cs8":
            return None
        if self._offset + n_samples > self._total:
            if not self._loop:
                self._exhausted = True
                return None
            self._offset = self._offset % max(1, self._total - n_samples + 1)
        start = self._offset * 2
        raw = np.asarray(self._raw[start : start + n_samples * 2])
        self._offset += n_samples
        return raw.reshape(-1, 2)


class SoapySource:
    """Hardware source via SoapySDR (reference sdr_source.cpp:11-90).

    Disables AGC, applies per-element gains, sets the sample rate; readStream
    with a 0.5 s timeout. Stream errors raise (the reference exit(1)s --
    sdr_source.cpp:38-41 -- recovery is the supervisor's job).
    """

    def __init__(self, device: DeviceSpec, tunables=None):
        import SoapySDR  # type: ignore

        from rtl_sdr_scanner_tpu_torch.constants import DEFAULT

        self._tunables = tunables if tunables is not None else DEFAULT
        self._soapy = SoapySDR
        self._device = SoapySDR.Device({"serial": device.serial, "driver": device.driver})
        self._rate = device.sample_rate
        self._driver = device.driver
        self._dev_spec = device
        try:
            self._device.setGainMode(SoapySDR.SOAPY_SDR_RX, 0, False)  # AGC off
        except Exception:
            pass
        for name, value in device.gains:
            self._device.setGain(SoapySDR.SOAPY_SDR_RX, 0, name, value)
        self._device.setSampleRate(SoapySDR.SOAPY_SDR_RX, 0, device.sample_rate)
        self._stream = self._device.setupStream(SoapySDR.SOAPY_SDR_RX, "CF32")
        self._device.activateStream(self._stream)
        self._samples_read = 0
        self._epoch_ms = int(time.time() * 1000)

    @property
    def sample_rate(self) -> int:
        return self._rate

    @property
    def session_epoch_ms(self) -> int:
        """Epoch ms at stream start: payload time = epoch + stream ms, the
        reference's wire contract (utils.cpp:14 getTime, data_controller.cpp:33
        time.count() are epoch milliseconds)."""
        return self._epoch_ms

    @property
    def exhausted(self) -> bool:
        return False

    def stream_time_ms(self) -> int:
        return int(self._samples_read * 1000 // self._rate)

    def set_center_frequency(self, frequency: int) -> bool:
        """x10 retry like sdr_source.cpp:82-88."""
        for _ in range(10):
            try:
                self._device.setFrequency(self._soapy.SOAPY_SDR_RX, 0, frequency)
                return True
            except Exception:
                time.sleep(0.01)
        return False

    def reset_buffers(self) -> None:
        """rtlsdr quirk handling (sdr_source.cpp:68-78): re-set sample rate for
        rtlsdr, reopen the stream otherwise."""
        if self._driver == "rtlsdr":
            self._device.setSampleRate(self._soapy.SOAPY_SDR_RX, 0, self._rate)
        else:
            self._device.deactivateStream(self._stream)
            self._device.activateStream(self._stream)

    def start_streaming(self) -> None:
        """Decouple the USB read loop from the device feeder via the native
        SPSC ingest ring (native/ring.cpp): a reader thread readStream()s into
        the ring at line rate; read_block() consumes from it. Overflow drops
        newest data with a counter instead of back-pressuring the hardware
        (the GR scheduler gave the reference this decoupling for free)."""
        import threading

        from rtl_sdr_scanner_tpu_torch.native import IngestRing

        if getattr(self, "_reader", None) is not None:
            return
        self._ring = IngestRing(int(self._rate * 8 * self._tunables.ingest_ring_seconds))
        self._streaming = True
        self._overflowed = False
        self._drop_warnings = 0
        self._last_drop_log = 0.0

        def reader():
            buf = np.empty(65536, dtype=np.complex64)
            dropped_seen = 0
            while self._streaming:
                sr = self._device.readStream(self._stream, [buf], len(buf), timeoutUs=500000)
                if sr.ret > 0:
                    self._ring.write(buf[: sr.ret])
                    dropped = self._ring.dropped_bytes
                    if dropped > dropped_seen:
                        # overflow: the feeder fell behind line rate. Loud,
                        # like the reference's stream-error path
                        # (sdr_source.cpp:34-41) -- never a silent IQ gap.
                        dropped_seen = dropped
                        now = time.monotonic()
                        if now - self._last_drop_log >= 1.0:
                            self._last_drop_log = now
                            self._drop_warnings += 1
                            logger.warn(
                                LABEL,
                                "ingest ring overflow: {} bytes of IQ dropped "
                                "total (feeder slower than {} sps)",
                                dropped,
                                self._rate,
                            )
                        if self._tunables.ingest_overflow_fatal:
                            logger.error(LABEL, "ingest overflow is fatal; stopping stream")
                            self._overflowed = True
                            self._streaming = False
                elif sr.ret not in (self._soapy.SOAPY_SDR_TIMEOUT,):
                    logger.error(LABEL, "readStream error: {}", sr.ret)
                    self._streaming = False

        self._reader = threading.Thread(target=reader, name="sdr-reader", daemon=True)
        self._reader.start()

    @property
    def dropped_bytes(self) -> int:
        """Total IQ bytes lost to ingest-ring overflow (0 before streaming)."""
        ring = getattr(self, "_ring", None)
        return ring.dropped_bytes if ring is not None else 0

    def stop_streaming(self) -> None:
        self._streaming = False
        if getattr(self, "_reader", None) is not None:
            self._reader.join(timeout=2)
            self._reader = None

    def read_block(self, n_samples: int) -> Optional[np.ndarray]:
        if getattr(self, "_reader", None) is not None:
            need = n_samples * 8  # complex64 bytes
            chunks = []
            while need > 0:
                if not self._streaming:
                    if getattr(self, "_overflowed", False):
                        raise RuntimeError(
                            f"ingest ring overflow (fatal mode): "
                            f"{self.dropped_bytes} bytes dropped"
                        )
                    raise RuntimeError("reader thread stopped on stream error")
                got = self._ring.read(need, dtype=np.uint8)
                if got.size:
                    chunks.append(got)
                    need -= got.size
                else:
                    time.sleep(0.005)
            out = np.concatenate(chunks).view(np.complex64)
            self._samples_read += n_samples
            return out
        out = np.empty(n_samples, dtype=np.complex64)
        got = 0
        while got < n_samples:
            sr = self._device.readStream(
                self._stream, [out[got:]], n_samples - got, timeoutUs=500000
            )
            if sr.ret <= 0:
                raise RuntimeError(f"readStream error: {sr.ret}")
            got += sr.ret
        self._samples_read += n_samples
        return out

    def read_block_int8(self, n_samples: int):  # pragma: no cover
        return None

    def close(self) -> None:
        self.stop_streaming()
        self._device.deactivateStream(self._stream)
        self._device.closeStream(self._stream)


def make_source(device: DeviceSpec, loop: bool = False, tunables=None):
    """Backend factory: file-backed devices replay; others need SoapySDR."""
    if device.file:
        return ReplaySource(device, loop=loop)
    return SoapySource(device, tunables=tunables)
