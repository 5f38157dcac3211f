"""File-scheme handling (``gm_file_handling.cc`` analog).

A copy of ``green_marl_tpu/graph/fs.py``, which the port cannot import
(the JAX package's ``__init__`` imports jax).

The reference routes graph I/O through a path layer that supports local
files and, behind ``SUPPORT_HDFS`` (libhdfs/JNI, ``setup.mk.in:58-76``),
``hdfs:`` paths.  Here the same role is played by a resolver that maps
remote schemes to a local staging copy via the ``hdfs``/``gsutil`` CLIs
when present — the JNI dependency becomes a subprocess, and everything
downstream (binary/Avro/edge-list codecs) keeps operating on local
files.  Absent tooling fails fast with a clear error (the reference
fails at link time instead).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile


def is_remote(path: str) -> bool:
    return path.startswith(("hdfs://", "gs://"))


def fetch(path: str) -> str:
    """Resolve ``path`` to a local file, staging remote schemes."""
    if not is_remote(path):
        return path
    h = hashlib.sha1(path.encode()).hexdigest()[:10]
    tmp = os.path.join(tempfile.gettempdir(),
                       f"gmtpu_{h}_" + os.path.basename(path))
    if path.startswith("hdfs://"):
        tool, argv = "hdfs", ["hdfs", "dfs", "-get", "-f", path, tmp]
    else:
        tool, argv = "gsutil", ["gsutil", "cp", path, tmp]
    if shutil.which(tool) is None:
        raise RuntimeError(
            f"{path}: '{tool}' CLI not available in this environment "
            "(the reference equally requires libhdfs; build with "
            "SUPPORT_HDFS)")
    res = subprocess.run(argv, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"fetch {path} failed: {res.stderr[-500:]}")
    return tmp


def publish(local: str, path: str) -> None:
    """Copy a locally-written file to its remote destination."""
    if not is_remote(path):
        if local != path:
            shutil.copyfile(local, path)
        return
    if path.startswith("hdfs://"):
        argv = ["hdfs", "dfs", "-put", "-f", local, path]
    else:
        argv = ["gsutil", "cp", local, path]
    res = subprocess.run(argv, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"publish {path} failed: {res.stderr[-500:]}")
