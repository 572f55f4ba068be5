"""Build and load the hand-written Hopper kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` and linked into one shared library with a plain C
interface, loaded with ``ctypes``. The build lands in ``build/kernels/<hash>``
at the repository root, keyed by a hash of the sources and flags, at first
use; nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures of the library's entry points (the launchers return
# cudaGetLastError; the psd_ queries return a count, psd_scratch_bytes a
# 64-bit one; trace_marks_load returns a CUDA error, trace_mark_count a
# count)
SIGNATURES = {
    "psd_frames_int8": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "psd_form": [_I],
    "psd_scratch_bytes": [_I, _I],
    "psd_max_active_clusters": [_I, _I],
    "fused_selection": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P, _P, _P],
    "fir_decimate": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "history_vote": [_P, _I, _L, _L, _P, _I, _L, _L, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "analysis_bank": [_P, _I, _L, _L, _L, _P, _P, _P, _P, _P, _I, _I, _P],
    "modtap_stage1": [_P, _I, _L, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "modtap_fold": [_P, _I, _L, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "trace_mark": [_I, _P],
    "trace_marks_load": [],
    "trace_mark_count": [],
}
RESTYPES = {"psd_scratch_bytes": ctypes.c_longlong}  # the others return int


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the kernels build only where the CUDA toolkit is")
    return str(path)


def _sources():
    return sorted(SRC_DIR.glob("*.cu")), sorted(SRC_DIR.glob("*.cuh"))


def build_key() -> str:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in cu + cuh:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the sources (if this hash is not built yet); return the .so."""
    out_dir = BUILD_ROOT / build_key()
    lib = out_dir / "libkernels.so"
    if lib.exists():
        return lib
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cu, _ = _sources()
    tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT, prefix="tmp-"))
    t0 = time.perf_counter()
    procs = []
    for src in cu:
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(SRC_DIR), "-c", str(src), "-o", str(obj)]
        procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    log = []
    failed = []
    for src, proc in procs:
        text = proc.communicate()[0].decode(errors="replace")
        log.append(f"== {src.name} (rc {proc.returncode})\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    (tmp / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    objs = [str(tmp / (src.stem + ".o")) for src in cu]
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o", str(tmp / lib.name), *objs],
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
    )
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout.decode(errors="replace"))
    if verbose:
        print("\n".join(log))
        print(f"kernels built in {time.perf_counter() - t0:.1f} s -> {out_dir}")
    try:
        os.replace(tmp, out_dir)
    except OSError:  # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = RESTYPES.get(name, ctypes.c_int)
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a launcher reported a CUDA error (cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
