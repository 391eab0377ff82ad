"""Build the hand-written CUDA kernels at first use and load them.

Each source under ``paddle_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). Libraries land
in ``paddle_tpu_torch/_build/`` under a name that carries a hash of the
sources and flags, so an edited kernel is rebuilt and a stale library is
never loaded. ``build()`` compiles several sources at once, one ``nvcc``
process each; ``library()`` builds one on demand.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

__all__ = ["CSRC", "BUILD_DIR", "SOURCES", "nvcc_path", "build", "library"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu",
           "paged_attention.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or PATH; raises if absent."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built on a machine with the CUDA toolkit")
    return found


def _target(source: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        digest.update(path.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:12]}.so"


def build(sources: Sequence[str] = SOURCES) -> Dict[str, dict]:
    """Compile every source whose library is missing, all in parallel.
    Returns {source: {"seconds", "log"}} for the sources compiled now
    (the log holds ptxas' register and shared-memory report)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = {}
    for src in sources:
        target = _target(src)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / src)]
        jobs[src] = (target, tmp, time.perf_counter(),
                     subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    report, failed = {}, []
    for src, (target, tmp, t0, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{src}:\n{log}")
            continue
        os.replace(tmp, target)   # atomic: a concurrent loader sees all or none
        report[src] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            target = _target(source)
            if not target.exists():
                build([source])
            lib = _loaded[source] = ctypes.CDLL(str(target))
        return lib
