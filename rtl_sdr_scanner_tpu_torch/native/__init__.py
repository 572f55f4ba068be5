"""Native C++ host runtime acceleration, loaded via ctypes.

The reference's runtime is C++ end to end; here the byte-level host hot paths
(wire codec, IQ format conversion for the data loader) are native too, with
numpy fallbacks so the package works before the library is built.

The shared library builds at first use if a toolchain is present (g++ -O3),
into ``build/native/<hash of the sources and flags>/`` at the repository
root; nothing is written into the package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRCS = [_DIR / "codec.cpp", _DIR / "ring.cpp"]
# no -march=native: a build directory may travel to another host's CPU
_FLAGS = ["-O3", "-shared", "-fPIC"]
BUILD_ROOT = _DIR.parents[1] / "build" / "native"

_lib: Optional[ctypes.CDLL] = None


def lib_path() -> Path:
    """Where the library for these sources, flags and machine lives."""
    h = hashlib.sha256(" ".join(_FLAGS + [platform.machine()]).encode())
    for src in _SRCS:
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libsdrnative.so"


def _build(path: Path) -> bool:
    """Compile into a fresh directory, then move it into place (concurrent
    builds of the same sources race harmlessly)."""
    try:
        BUILD_ROOT.mkdir(parents=True, exist_ok=True)
        tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT, prefix="tmp-"))
        subprocess.run(
            ["g++", *_FLAGS, *map(str, _SRCS), "-o", str(tmp / path.name)],
            check=True,
            capture_output=True,
            timeout=120,
        )
        try:
            os.replace(tmp, path.parent)
        except OSError:  # another process finished the same build first
            shutil.rmtree(tmp, ignore_errors=True)
        return path.exists()
    except (OSError, subprocess.SubprocessError):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    path = lib_path()
    if not path.exists() and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.sdr_xor80.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.sdr_cs8_to_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
    lib.sdr_cu8_to_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
    lib.sdr_f32_to_cs8.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.c_float,
    ]
    lib.sdr_ring_create.argtypes = [ctypes.c_size_t]
    lib.sdr_ring_create.restype = ctypes.c_void_p
    lib.sdr_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.sdr_ring_capacity.argtypes = [ctypes.c_void_p]
    lib.sdr_ring_capacity.restype = ctypes.c_size_t
    lib.sdr_ring_available.argtypes = [ctypes.c_void_p]
    lib.sdr_ring_available.restype = ctypes.c_size_t
    lib.sdr_ring_dropped.argtypes = [ctypes.c_void_p]
    lib.sdr_ring_dropped.restype = ctypes.c_ulonglong
    lib.sdr_ring_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
    lib.sdr_ring_write.restype = ctypes.c_size_t
    lib.sdr_ring_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
    lib.sdr_ring_read.restype = ctypes.c_size_t
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def xor_offset_binary(iq_int8: np.ndarray) -> np.ndarray:
    """int8 array -> uint8 array with every byte XOR 0x80 (offset binary).

    Reference data_controller.cpp:38-40.
    """
    out = np.ascontiguousarray(iq_int8, dtype=np.int8).view(np.uint8).copy()
    lib = _load()
    if lib is not None:
        lib.sdr_xor80(out.ctypes.data, out.size)
    else:
        out ^= 0x80
    return out


def cs8_to_complex64(raw: np.ndarray) -> np.ndarray:
    """Interleaved int8 IQ -> complex64 (scale 1/127.5, converter.py:31)."""
    raw = np.ascontiguousarray(raw, dtype=np.int8)
    lib = _load()
    if lib is not None:
        flat = np.empty(raw.size, dtype=np.float32)
        lib.sdr_cs8_to_f32(raw.ctypes.data, flat.ctypes.data, raw.size)
    else:
        flat = raw.astype(np.float32) / 127.5
    return flat.view(np.complex64) if raw.size % 2 == 0 else flat[:-1].view(np.complex64)


def cu8_to_complex64(raw: np.ndarray) -> np.ndarray:
    """Interleaved uint8 offset-binary IQ -> complex64 (rtl_sdr convention)."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    lib = _load()
    if lib is not None:
        flat = np.empty(raw.size, dtype=np.float32)
        lib.sdr_cu8_to_f32(raw.ctypes.data, flat.ctypes.data, raw.size)
    else:
        flat = (raw.astype(np.float32) - 127.5) / 127.5
    return flat.view(np.complex64)


class IngestRing:
    """Lock-free SPSC byte ring (native/ring.cpp) for live IQ ingest.

    One hardware reader thread writes (never blocks; overflow drops and
    counts), one feeder thread reads. Replaces the GR ring buffers that
    decouple the reference's SdrSource from its flowgraph. Falls back to a
    locked deque-free numpy ring when the native library is unavailable.
    """

    def __init__(self, capacity_bytes: int):
        self._lib = _load()
        if self._lib is not None:
            self._h = self._lib.sdr_ring_create(capacity_bytes)
            if not self._h:  # pragma: no cover - allocation failure
                self._lib = None
        if self._lib is None:  # pure-python fallback (locked)
            import threading

            self._buf = bytearray()
            self._cap = capacity_bytes
            self._lock = threading.Lock()
            self._dropped = 0

    @property
    def capacity(self) -> int:
        if self._lib is not None:
            return int(self._lib.sdr_ring_capacity(self._h))
        return self._cap

    @property
    def available(self) -> int:
        if self._lib is not None:
            return int(self._lib.sdr_ring_available(self._h))
        with self._lock:
            return len(self._buf)

    @property
    def dropped_bytes(self) -> int:
        if self._lib is not None:
            return int(self._lib.sdr_ring_dropped(self._h))
        with self._lock:
            return self._dropped

    def write(self, data: np.ndarray) -> int:
        """Store what fits, return the byte count stored. The remainder is
        counted in dropped_bytes (write-once producers = true drop stats;
        producers that retry partial writes should ignore the counter)."""
        data = np.ascontiguousarray(data)
        n = data.nbytes
        if self._lib is not None:
            return int(self._lib.sdr_ring_write(self._h, data.ctypes.data, n))
        with self._lock:
            take = min(n, self._cap - len(self._buf))
            self._buf += data.tobytes()[:take]
            self._dropped += n - take
            return take

    def read(self, n_bytes: int, dtype=np.int8) -> np.ndarray:
        """Read up to n_bytes; returns a (possibly shorter) 1-D array."""
        if self._lib is not None:
            out = np.empty(n_bytes, dtype=np.uint8)
            got = int(self._lib.sdr_ring_read(self._h, out.ctypes.data, n_bytes))
            return out[:got].view(dtype)
        with self._lock:
            got = min(n_bytes, len(self._buf))
            chunk = bytes(self._buf[:got])
            del self._buf[:got]
        return np.frombuffer(chunk, dtype=dtype)

    def __del__(self):  # pragma: no cover - interpreter teardown
        lib = getattr(self, "_lib", None)
        h = getattr(self, "_h", None)
        if lib is not None and h:
            lib.sdr_ring_destroy(h)
            self._h = None


def complex64_to_cs8(iq: np.ndarray, scale: float = 127.0) -> np.ndarray:
    """complex64 -> interleaved int8 with round+saturate (recorder.cpp:36)."""
    flat = np.ascontiguousarray(iq, dtype=np.complex64).view(np.float32)
    lib = _load()
    if lib is not None:
        out = np.empty(flat.size, dtype=np.int8)
        lib.sdr_f32_to_cs8(flat.ctypes.data, out.ctypes.data, flat.size, scale)
    else:
        out = np.clip(np.round(flat * scale), -128, 127).astype(np.int8)
    return out.reshape(-1, 2)
