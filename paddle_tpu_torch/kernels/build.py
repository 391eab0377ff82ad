"""Build the hand-written CUDA kernels at first use and load them.

Each source under ``paddle_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). Libraries land
in ``paddle_tpu_torch/_build/`` under a name that carries a hash of the
sources and flags, so an edited kernel is rebuilt and a stale library is
never loaded. ``build()`` compiles several sources at once, one ``nvcc``
process each; ``library()`` builds one on demand.

The kernel wrappers share the rest: ``bind`` gives a typed entry point
of a library (bound once, then cached); ``on_card`` decides between the
plain version (a CPU tensor) and the kernel (a CUDA tensor), ``check``
refuses what a kernel does not take, ``device_guard`` makes a tensor's
device current only where it is not, ``stream`` gives the current
stream's handle, ``launch`` raises on a launch error, ``sm_count`` sizes
grids.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

__all__ = ["CSRC", "BUILD_DIR", "SOURCES", "nvcc_path", "build", "library",
           "bind", "sm_count", "on_card", "check", "device_guard",
           "stream", "launch"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu",
           "flash_attention_bf16.cu", "paged_attention.cu", "fused_conv.cu",
           "fused_lstm.cu", "fused_lstm_bf16.cu", "fused_block.cu",
           "fused_block_bwd.cu", "fused_block_bf16.cu")
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


@functools.cache
def bind(source: str, symbol: str, argtypes: tuple):
    """Entry point `symbol` of the library of `source`, with its argument
    types and an int (cudaError_t) result."""
    fn = getattr(library(source), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def on_card(name: str, t: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version runs), True for a CUDA
    one; any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {t.device}")
    return True


def check(name: str, t: torch.Tensor, device: torch.device, shape,
          dtype: torch.dtype = torch.float32, aligned: bool = False) -> None:
    """Raise unless t is a contiguous tensor of `dtype` and `shape` on
    `device`, and 16-byte aligned where `aligned`."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}; the kernel takes "
                        f"{str(dtype).rsplit('.', 1)[-1]}")
    if t.shape != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


_CURRENT = contextlib.nullcontext()


def device_guard(device: torch.device):
    """A context in which `device` is the current CUDA device: none to
    enter where it already is."""
    if device.index == torch.cuda.current_device():
        return _CURRENT
    return torch.cuda.device(device)


def stream(device: torch.device) -> int:
    """The handle of the current stream of `device`."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def launch(name: str, fn, *args) -> None:
    """Call an entry point; raise if it reports a CUDA error."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
