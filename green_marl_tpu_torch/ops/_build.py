"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

The sources are compiled by ``nvcc`` for ``sm_90a``, one process per
source started together, and linked into one shared library with a plain C
interface, loaded with ctypes.  The library's file name
carries a hash of the sources, the headers they share and the flags, so an
edited kernel is rebuilt and an unchanged one is loaded as it is.  Nothing here runs at import time:
machines without ``nvcc`` (the CPU test runs) import the package freely and
only a CUDA launch asks for the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "green_marl_tpu_torch")
SOURCES = ("segment_reduce.cu", "cumsum.cu", "segmented_scan.cu",
           "gather_probe.cu")
HEADERS = ("lookback.cuh",)     # included by the sources: rebuild on change
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_LIB: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build green_marl_tpu_torch's kernels")
    return path


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libgm_kernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless this version is already built; returns
    the library's path.  Raises ``RuntimeError`` with nvcc's output when
    the build fails."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tmp = f"{so}.tmp{os.getpid()}"
    objs = [f"{tmp}.{os.path.splitext(s)[0]}.o" for s in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, os.path.join(CSRC_DIR, src)]
            for src, obj in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    try:
        for cmd, p, out in zip(cmds, procs, outs):
            if p.returncode != 0:
                raise RuntimeError("nvcc failed:\n" + " ".join(cmd) + "\n"
                                   + out)
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + " ".join(link) + "\n"
                               + proc.stdout + proc.stderr)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, so)          # atomic: concurrent builders agree
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    if _LIB is None:
        cdll = ctypes.CDLL(build())
        vp, i64, cint = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        cdll.gm_segment_reduce.restype = cint
        cdll.gm_segment_reduce.argtypes = [vp, i64, vp, i64, i64, vp, vp,
                                           cint, cint, vp]
        cdll.gm_segment_reduce_tile_size.restype = cint
        cdll.gm_segment_reduce_tile_size.argtypes = []
        cdll.gm_cumsum.restype = cint
        cdll.gm_cumsum.argtypes = [vp, vp, vp, i64, cint, cint, vp]
        cdll.gm_cumsum_tile_size.restype = cint
        cdll.gm_cumsum_tile_size.argtypes = []
        cdll.gm_segmented_scan.restype = cint
        cdll.gm_segmented_scan.argtypes = [vp, vp, vp, vp, i64, cint, cint,
                                           vp]
        cdll.gm_segmented_scan_tile_size.restype = cint
        cdll.gm_segmented_scan_tile_size.argtypes = []
        cdll.gm_take_along.restype = cint
        cdll.gm_take_along.argtypes = [vp, vp, vp, i64, cint, cint, i64,
                                       cint, cint, cint, cint, vp]
        cdll.gm_row_gather.restype = cint
        cdll.gm_row_gather.argtypes = [vp, i64, cint, vp, i64, cint, cint,
                                       vp, vp, vp]
        _LIB = cdll
    return _LIB
