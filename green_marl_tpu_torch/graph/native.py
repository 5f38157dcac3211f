"""ctypes binding to the native host runtime (``native/gm_io.cc``).

The CSR+CSC freeze, the RMAT generator, the reference's xorshift edge
lengths and triangle counting's host preprocessing (the degree-ordered DAG
and its descending-pair row layout) run in C++.  The library is built with
the repo's ``native/Makefile`` into ``build/green_marl_tpu_torch/``, under
a name keyed by a hash of the sources and flags, on first use.

It is built without OpenMP (``CXXFLAGS`` below replaces the Makefile's):
the GPU machines' g++ cannot link OpenMP (no ``libgomp.spec``), and
``gm_rmat_edges`` splits its random stream by OpenMP thread, so a serial
build also gives one graph per seed on every machine.  Its stream differs
from an OpenMP build's on more than one thread, such as
``green_marl_tpu.graph.native``'s.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_REPO, "native")
BUILD_DIR = os.path.join(_REPO, "build", "green_marl_tpu_torch")
CXXFLAGS = "-O3 -march=native -fPIC -shared -Wall -Wno-unknown-pragmas"

_LIB: Optional[ctypes.CDLL] = None
_ERROR: Optional[str] = None


def _build() -> str:
    src = os.path.join(NATIVE_DIR, "gm_io.cc")
    mk = os.path.join(NATIVE_DIR, "Makefile")
    h = hashlib.sha256(CXXFLAGS.encode())
    for path in (src, mk):
        with open(path, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, f"libgmtpu_io-{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        # VPATH finds gm_io.cc in native/; -B rebuilds here even when
        # native/ holds a library of its own
        subprocess.run(["make", "-s", "-B", "-C", tmp, "-f", mk,
                        f"VPATH={NATIVE_DIR}", f"CXXFLAGS={CXXFLAGS}",
                        "libgmtpu_io.so"],
                       check=True, capture_output=True, text=True,
                       timeout=300)
        os.replace(os.path.join(tmp, "libgmtpu_io.so"), so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded library, built on first call.  Raises ``RuntimeError``
    when it cannot be built or loaded."""
    global _LIB, _ERROR
    if _LIB is not None:
        return _LIB
    if _ERROR is None:
        try:
            cdll = ctypes.CDLL(_build())
        except subprocess.CalledProcessError as e:
            _ERROR = f"make failed: {e.stderr}"
        except (OSError, subprocess.SubprocessError) as e:
            _ERROR = f"{type(e).__name__}: {e}"
        else:
            i32p = ctypes.POINTER(ctypes.c_int32)
            cdll.gm_build_csr.restype = ctypes.c_int
            cdll.gm_build_csr.argtypes = [i32p, i32p, ctypes.c_int64,
                                          ctypes.c_int32] + [i32p] * 8
            cdll.gm_rmat_edges.restype = None
            cdll.gm_rmat_edges.argtypes = [
                ctypes.c_int32, ctypes.c_int64, ctypes.c_uint64,
                ctypes.c_double, ctypes.c_double, ctypes.c_double,
                ctypes.c_int32, i32p, i32p]
            cdll.gm_xorshift_lengths.restype = None
            cdll.gm_xorshift_lengths.argtypes = [
                ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, i32p]
            cdll.gm_build_dag.restype = ctypes.c_int64
            cdll.gm_build_dag.argtypes = [i32p, i32p, ctypes.c_int32, i32p,
                                          i32p]
            cdll.gm_desc_layout.restype = None
            cdll.gm_desc_layout.argtypes = [i32p, i32p, ctypes.c_int32, i32p,
                                            i32p]
            _LIB = cdll
            return _LIB
    raise RuntimeError(f"native library native/gm_io.cc unavailable: "
                       f"{_ERROR}")


def available() -> bool:
    try:
        lib()
    except RuntimeError:
        return False
    return True


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def build_csr(src: np.ndarray, dst: np.ndarray, n: int):
    """CSR+CSC build of int32 edges: returns ``(begin, csr_dst, csr_src,
    csr_perm, r_begin, csc_src, csc_dst, e_rev2idx)`` as
    ``csr.from_edges``'s numpy form does."""
    native = lib()
    e = src.shape[0]
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    begin = np.empty(n + 1, np.int32)
    r_begin = np.empty(n + 1, np.int32)
    csr_dst, csr_src, csr_perm, csc_src, csc_dst, e_rev2idx = (
        np.empty(e, np.int32) for _ in range(6))
    rc = native.gm_build_csr(_ptr(src), _ptr(dst), e, n, _ptr(begin),
                             _ptr(csr_dst), _ptr(csr_src), _ptr(csr_perm),
                             _ptr(r_begin), _ptr(csc_src), _ptr(csc_dst),
                             _ptr(e_rev2idx))
    if rc != 0:
        raise ValueError("edge endpoint out of range")
    return (begin, csr_dst, csr_src, csr_perm, r_begin, csc_src, csc_dst,
            e_rev2idx)


def rmat_edges(n: int, m: int, seed: int = 0, a: float = 0.45,
               b: float = 0.22, c: float = 0.22,
               permute: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """RMAT edge stream, one per seed on every machine.  It differs from
    ``green_marl_tpu.graph.generate.rmat_edges`` (numpy) and from OpenMP
    builds of ``gm_io.cc`` run on several threads."""
    native = lib()
    src = np.empty(m, np.int32)
    dst = np.empty(m, np.int32)
    native.gm_rmat_edges(n, m, seed, a, b, c, int(permute), _ptr(src),
                         _ptr(dst))
    return src, dst


def xorshift_lengths(n: int, mod: int = 100, add: int = 1) -> np.ndarray:
    """The reference's gm_rand32 sequence as ``(rand() % mod) + add`` per
    CSR slot (sssp_main.cc:31-33)."""
    out = np.empty(n, np.int32)
    lib().gm_xorshift_lengths(n, mod, add, _ptr(out))
    return out


def build_dag(begin: np.ndarray, dst: np.ndarray,
              n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Degree-ordered DAG of an undirected CSR (rows sorted by value,
    parallel edges allowed): ``(dag_begin [n+1], dag_dst [D])`` int32, rows
    indexed by rank (ascending degree, ties by id), values the destination
    ranks, sorted and deduplicated."""
    native = lib()
    begin = np.ascontiguousarray(begin, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    dag_begin = np.empty(n + 1, np.int32)
    dag_dst = np.empty(max(dst.shape[0], 1), np.int32)
    d = native.gm_build_dag(_ptr(begin), _ptr(dst), n, _ptr(dag_begin),
                            _ptr(dag_dst))
    if d < 0:
        raise ValueError("gm_build_dag: bad CSR")
    return dag_begin, dag_dst[:d]


def desc_layout(dag_begin: np.ndarray, dag_dst: np.ndarray, n: int,
                d: int) -> Tuple[np.ndarray, np.ndarray]:
    """Rows of a DAG reordered by descending pair count (stable):
    ``(perm_dst [d], new_begin [n+1])`` int32."""
    native = lib()
    dag_begin = np.ascontiguousarray(dag_begin, np.int32)
    dag_dst = np.ascontiguousarray(dag_dst, np.int32)
    perm_dst = np.empty(max(d, 1), np.int32)
    nb = np.empty(n + 1, np.int32)
    native.gm_desc_layout(_ptr(dag_begin), _ptr(dag_dst), n, _ptr(perm_dst),
                          _ptr(nb))
    return perm_dst[:d], nb
