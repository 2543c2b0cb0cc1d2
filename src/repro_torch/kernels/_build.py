"""Build the CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface and compiles on
its own into ``build/<name>-<digest>.so`` at the repository root, where the
digest covers the source, every ``csrc/*.cuh`` header and the flags, so an
edited source or header rebuilds and an unchanged one loads at once.
Nothing here runs at import time: a library is built the first time a
wrapper launches its kernel (or when ``build_all`` is called), so the
package imports on a host without ``nvcc`` or a card.

``LAUNCHES`` counts kernel launches per wrapper; each wrapper adds one
where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("fingerprint", "fp_index", "cdc", "histogram", "paged_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES: Dict[str, int] = {
    "fingerprint": 0, "fp_probe": 0, "fp_insert": 0, "fp_remove": 0,
    "cdc_candidates": 0, "chunk_fingerprint": 0, "ffh": 0, "paged_attention": 0,
}
# ptxas register/spill report of each library built or loaded by this process
BUILD_LOG: Dict[str, str] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

_SIGNATURES = {
    "fingerprint": {
        "fingerprint_launch": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                               ctypes.c_int, ctypes.c_void_p],
    },
    "fp_index": {
        f"{op}_launch": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                         ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        for op in ("fp_probe", "fp_insert", "fp_remove")
    },
    "cdc": {
        "cdc_candidates_launch": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                  ctypes.c_uint, ctypes.c_void_p],
        "chunk_fingerprint_launch": [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_void_p],
    },
    "histogram": {
        "ffh_launch": [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p],
    },
    "paged_attention": {
        "paged_attention_launch": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
    },
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # any source may include any header
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; returns (process, temp output, target)
    or None when the library is already built (its ptxas report, kept
    beside it, then goes to ``BUILD_LOG``)."""
    target = _target(name)
    if target.exists():
        log = target.with_suffix(".log")
        if log.exists():
            BUILD_LOG[name] = log.read_text()
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp, target


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, target = started
    out, err = proc.communicate()
    BUILD_LOG[name] = (out + err).strip()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{out}{err}")
    target.with_suffix(".log").write_text(BUILD_LOG[name])
    os.replace(tmp, target)  # atomic: a concurrent build never loads a partial file


def build_all() -> float:
    """Build every source, one ``nvcc`` each, all started together; returns
    the seconds it took."""
    t0 = time.perf_counter()
    with _lock:
        started = {name: _start(name) for name in SOURCES}
        for name, st in started.items():
            _finish(name, st)
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {err}")
