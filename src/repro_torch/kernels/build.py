"""Build and load the CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  Builds run
at first use, one ``nvcc`` per source, all started together; a library is
named by a hash of its sources and flags, so an edit rebuilds and an
unchanged tree reuses what is built.  The build directory is
``<repo>/build/kernels`` (listed in ``.gitignore``).  Each library's
``-Xptxas -v`` output (registers, shared memory and spills of every
kernel) is kept beside it (:func:`report_path`), so a reused build still
has its resource report (``analysis.smem`` reads it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

__all__ = ["SOURCES", "KERNELS", "BUILD_DIR", "build_all", "library",
           "build_log", "report_path", "report"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: kernel name -> source file under csrc/
SOURCES = {"gemv_stacked": "pcilt_gemv_stacked.cu",
           "gemv_staged": "pcilt_gemv_staged.cu",
           "dwconv1d": "pcilt_dwconv1d.cu",
           "shared_gemv": "pcilt_shared_gemv.cu",
           "conv2d": "pcilt_conv2d.cu",
           "gemv_host": "pcilt_gemv.cu",
           "crc32": "pcilt_crc32.cu"}

#: kernel name (the key of its launch count) -> the library that holds it
KERNELS = {"gemv_stacked": "gemv_stacked", "dwconv1d": "dwconv1d",
           "shared_gemv": "shared_gemv", "fused_conv2d": "conv2d",
           "shared_conv2d": "conv2d", "gemv_host": "gemv_host",
           "conv2d_host": "gemv_host", "fused_gemv": "gemv_stacked",
           "gemv_paired": "gemv_stacked",
           "gemv_paired_stacked": "gemv_stacked",
           "gemv_plan": "gemv_stacked", "dwconv1d_host": "dwconv1d",
           "crc32": "crc32"}

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
#: C entry point suffix -> argtypes (each entry exists as ``_f32``/``_bf16``,
#: or as ``_f32`` alone)
_SIGNATURES = {
    "pcilt_gemv_fused": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _LL,
                         _LL, _I, _I, _P],
    "pcilt_gemv_plan": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I,
                        _P],
    "pcilt_gemv_staged": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _LL,
                          _LL, _I, _P],
    "pcilt_dwconv1d": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                       _I, _I, _P],
    "pcilt_dwconv1d_host": [_P, _P, _P, _LL, _I, _I, _I, _P],
    "pcilt_shared_gemv": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                          _I, _P],
    "pcilt_fused_conv2d": [_P, _P, _P, _P] + [_I] * 16 + [_F, _I, _I, _P],
    "pcilt_shared_conv2d": [_P, _P, _P, _P] + [_I] * 16 + [_F, _I, _I, _P],
    "pcilt_fused_conv2d_staged": [_P, _P, _P, _P] + [_I] * 19 + [_P],
    "pcilt_shared_conv2d_staged": [_P, _P, _P, _P] + [_I] * 19 + [_P],
    "pcilt_conv2d_codes": [_P, _P] + [_I] * 8 + [_F, _P],
    "pcilt_gemv_host": [_P, _P, _P, _LL, _I, _I, _I, _I, _P],
}
#: the C entry points without a dtype suffix (a design's constants, and the
#: CRC-32, which reads bytes) -> argtypes
_CONFIG_SIGNATURES = {
    "pcilt_conv2d_staged_config": [_P],
    "pcilt_gemv_split_config": [_P],
    "pcilt_gemv_split_plan": [_I, _I, _I, _I, _P],
    "pcilt_gemv_staged_config": [_P],
    "pcilt_gemv_staged_plan": [_I, _I, _I, _I, _I, _P],
    "pcilt_shared_gemv_split_config": [_P],
    "pcilt_shared_gemv_split_plan": [_I, _I, _I, _I, _P],
    "pcilt_dwconv1d_staged_config": [_P],
    "pcilt_dwconv1d_staged_plan": [_LL, _I, _I, _I, _P],
    "pcilt_dwconv1d_tiled_config": [_P],
    "pcilt_dwconv1d_tiled_plan": [_I, _I, _I, _P],
    "pcilt_gemv_host_staged_config": [_P],
    "pcilt_crc32": [_P, _I, _LL, _I, _P, _P, _P, _P, _I, _P, _P],
    "pcilt_crc32_config": [_P],
}

_libs: Dict[str, ctypes.CDLL] = {}
_log: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh") and (f.suffix == ".cuh"
                                             or f.name == SOURCES[name]):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f"libpcilt_{name}_{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every kernel library that is not built yet, in parallel.
    Returns the seconds spent; raises with the compiler's output on error."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in SOURCES.items():
        out = _lib_path(name)
        if out.exists() and report_path(name).exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        _log[name] = text
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{text}")
            continue
        report_path(name).write_text(text)  # before the library appears
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def build_log() -> Dict[str, str]:
    """The compiler output (``-Xptxas -v``: registers, shared memory,
    spills) of each library this process built."""
    return dict(_log)


def report_path(name: str) -> Path:
    """The file of library ``name``'s ``-Xptxas -v`` report, beside the
    library (named by the same hash of its sources and flags)."""
    return _lib_path(name).with_suffix(".ptxas.txt")


def report(name: str) -> str:
    """Library ``name``'s ``-Xptxas -v`` report, from its file (built
    first if needed)."""
    path = report_path(name)
    if not path.exists():
        build_all()
    return path.read_text()


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in _SIGNATURES.items():
            for dt in ("f32", "bf16"):
                sym = getattr(lib, f"{fn}_{dt}", None)
                if sym is not None:
                    sym.argtypes = argtypes
                    sym.restype = ctypes.c_int
        for fn, argtypes in _CONFIG_SIGNATURES.items():
            sym = getattr(lib, fn, None)
            if sym is not None:
                sym.argtypes, sym.restype = argtypes, ctypes.c_int
        _libs[name] = lib
    return lib
