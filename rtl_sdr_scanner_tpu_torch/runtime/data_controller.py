"""Wire codec + egress (host side).

Bit-identical payloads to the reference DataController
(sources/network/data_controller.cpp:27-57):

transmission -> topic sdr/{driver}_{serial}/transmission/uint8
  u64 time_ms | i32 start | i32 stop | u32 sample_rate | int8 IQ pairs ^ 0x80
spectrogram -> topic sdr/{driver}_{serial}/spectrogram
  u64 time_ms | i32 start | i32 stop | i32 step | u32 size | int8 dB bins

All integers little-endian native layout (the reference memcpy's host-order
structs on x86/ARM LE). The XOR 0x80 turns signed int8 IQ into offset-binary
uint8. The XOR runs through the native C++ codec when built
(native/codec.cpp), numpy otherwise.
"""

from __future__ import annotations

import struct

import numpy as np

from rtl_sdr_scanner_tpu_torch.native import xor_offset_binary

LABEL = "data"


class DataController:
    def __init__(self, mqtt, device_name: str):
        self._mqtt = mqtt
        self._spectrogram_topic = f"sdr/{device_name}/spectrogram"
        self._transmissions_topic = f"sdr/{device_name}/transmission/uint8"

    def push_transmission(
        self, time_ms: int, frequency: int, sample_rate: int, iq_int8: np.ndarray
    ) -> None:
        """iq_int8: [n, 2] int8 (I, Q). frequency is the absolute recording
        center; start/stop = center -/+ rate/2 (data_controller.cpp:28-29)."""
        payload = encode_transmission(time_ms, frequency, sample_rate, iq_int8)
        if self._mqtt is not None:
            self._mqtt.publish(self._transmissions_topic, payload)

    def push_spectrogram(
        self, time_ms: int, frequency: int, sample_rate: int, bins_int8: np.ndarray
    ) -> None:
        payload = encode_spectrogram(time_ms, frequency, sample_rate, bins_int8)
        if self._mqtt is not None:
            self._mqtt.publish(self._spectrogram_topic, payload)


def encode_transmission(
    time_ms: int, frequency: int, sample_rate: int, iq_int8: np.ndarray
) -> bytes:
    start = frequency - sample_rate // 2
    stop = frequency + sample_rate // 2
    header = struct.pack("<QiiI", time_ms, start, stop, sample_rate)
    body = xor_offset_binary(np.ascontiguousarray(iq_int8, dtype=np.int8))
    return header + body.tobytes()


def decode_transmission(payload: bytes):
    """Inverse codec (for tests and downstream tooling)."""
    time_ms, start, stop, rate = struct.unpack_from("<QiiI", payload)
    body = np.frombuffer(payload, dtype=np.uint8, offset=20).copy()
    iq = (body ^ np.uint8(0x80)).view(np.int8).reshape(-1, 2)
    return time_ms, start, stop, rate, iq


def encode_spectrogram(
    time_ms: int, frequency: int, sample_rate: int, bins_int8: np.ndarray
) -> bytes:
    start = frequency - sample_rate // 2
    stop = frequency + sample_rate // 2
    step = sample_rate // len(bins_int8)
    header = struct.pack("<QiiiI", time_ms, start, stop, step, len(bins_int8))
    return header + np.ascontiguousarray(bins_int8, dtype=np.int8).tobytes()


def decode_spectrogram(payload: bytes):
    time_ms, start, stop, step, size = struct.unpack_from("<QiiiI", payload)
    bins = np.frombuffer(payload, dtype=np.int8, offset=24)
    return time_ms, start, stop, step, bins[:size]
