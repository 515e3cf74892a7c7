"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under ``csrc/`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds).  The helpers at the end are what every kernel wrapper needs
around a launch: input checks, raw pointers, the current stream, and the C
launcher with its ctypes signature.  Libraries land in ``build/kernels/`` at the repository root,
named by a digest of their sources and flags, so an edited source never
reuses a stale library.  There is no fallback: a missing ``nvcc`` or a
failed build raises.  ``recording()`` collects the sources whose library
a piece of code reaches (the on-disk plan cache stores them beside its
entries, ``core/aot.py``), and ``BUILDS`` logs every ``nvcc`` run with its
wall time.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from ..core.schema import Metric

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("scan_topk.cu", "scan_topk_batch.cu", "range_scan.cu",
           "range_scan_batch.cu", "quant_scan_topk_batch.cu",
           "quant_keys_batch.cu", "replay_keys.cu", "pairwise_keys.cu")
HEADERS = ("topk_common.cuh", "fp32_tile.cuh", "select_tile.cuh",
           "range_tile.cuh")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: dict[str, ctypes.CDLL] = {}
_recorders: list[set] = []
_recorders_lock = threading.Lock()
# one record per build() that ran nvcc: {"sources": [...], "seconds": wall}
BUILDS: list[dict] = []


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def target(source: str) -> Path:
    """The shared library a source builds into."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in (source,) + HEADERS:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources=SOURCES) -> dict[str, float]:
    """Compile every source whose library is missing, all ``nvcc`` runs
    started together.  Returns {source: seconds} for the sources built;
    the compiler's report (registers, shared memory, spills) is kept beside
    each library as ``.log``."""
    todo = [s for s in sources if not target(s).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    started = time.perf_counter()
    procs = {}
    for s in todo:
        tmp = target(s).with_suffix(f".tmp{os.getpid()}")
        procs[s] = (tmp, subprocess.Popen(
            [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    seconds, failed = {}, []
    for s, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        seconds[s] = time.perf_counter() - started
        target(s).with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{s}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target(s))
    BUILDS.append({"sources": list(todo),
                   "seconds": time.perf_counter() - started})
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


@contextlib.contextmanager
def recording():
    """Collect, into the set this yields, every source whose library is
    reached (``library``) while the block runs, on any thread."""
    used: set = set()
    with _recorders_lock:
        _recorders.append(used)
    try:
        yield used
    finally:
        with _recorders_lock:
            _recorders.remove(used)


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    if _recorders:
        with _recorders_lock:
            for used in _recorders:
                used.add(source)
    lib = _loaded.get(source)
    if lib is None:
        build((source,))
        lib = ctypes.CDLL(str(target(source)))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _loaded[source] = lib
    return lib


def check(lib: ctypes.CDLL, what: str, err: int) -> None:
    """Raise if a launcher returned a non-zero ``cudaError_t``."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: cudaError {err} ({msg})")


# ---------------------------------------------------------------------------
# around a launch
# ---------------------------------------------------------------------------

METRIC_CODES = {Metric.INNER_PRODUCT: 0, Metric.L2: 1, Metric.COSINE: 2}
P, I = ctypes.c_void_p, ctypes.c_int   # pointer / int launcher arguments


def launcher(source: str, name: str, argtypes: list):
    """(library, C launcher with its ctypes signature) of one kernel."""
    lib = library(source)
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib, fn


def check_tensor(t: torch.Tensor | None, name: str, shape: tuple, dtype,
                 device: torch.device) -> None:
    """Raise unless ``t`` (None passes) has this shape, dtype and device and
    is contiguous."""
    if t is None:
        return
    if tuple(t.shape) != shape or t.dtype != dtype or t.device != device:
        raise ValueError(f"{name}: expected {shape} {dtype} on {device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(t: torch.Tensor | None) -> int | None:
    """A tensor's device address for a launcher (None for a null pointer)."""
    return None if t is None else t.data_ptr()


def stream(dev: torch.device) -> int:
    """The current CUDA stream of ``dev``, as the launchers take it."""
    return torch.cuda.current_stream(dev).cuda_stream
