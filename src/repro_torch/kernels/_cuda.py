"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``. Libraries are built at
first use into ``build/kernels/`` of the checkout, named by a hash of the
source and the shared headers (``csrc/*.cuh``), so an edited kernel is
rebuilt and an unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per source at once and waits for all.

A failed build raises :class:`KernelBuildError` with the compiler's output;
a launch whose ``cudaGetLastError()`` is not 0 raises :class:`RuntimeError`.

A launch made while the current stream is capturing a CUDA graph runs
nothing: it is tallied on the graph (:func:`capture_tally`), and each
replay adds the tally to the counters (:mod:`repro_torch.graphs`). A
:class:`LaunchCounter` counts a subset of a kernel's launches (a mode it
ran in) the same way.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p   # every pointer and the stream
I = ctypes.c_int

# storage types the walker and the LM kernels take (fp32 arithmetic either
# way)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


class KernelBuildError(RuntimeError):
    pass


# {counter: launches} of the graph being captured (None: no tally open)
_TALLY: Optional[Dict["LaunchCounter", int]] = None


@contextlib.contextmanager
def capture_tally(tally: Dict["LaunchCounter", int]):
    """Within the block, launches made on a capturing stream add to
    ``tally`` instead of the counters' ``launches``."""
    global _TALLY
    prev, _TALLY = _TALLY, tally
    try:
        yield tally
    finally:
        _TALLY = prev


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise KernelBuildError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda)")


def _capturing(name: str) -> bool:
    """Whether the current stream is capturing a CUDA graph; raises when
    it is and no :func:`capture_tally` is open to count on."""
    capturing = torch.cuda.is_current_stream_capturing()
    if capturing and _TALLY is None:
        raise RuntimeError(
            f"{name}: launched on a stream that is capturing a CUDA graph "
            f"with no capture_tally open; capture through "
            f"repro_torch.graphs.CapturedGraph so that each replay counts "
            f"its launches")
    return capturing


class LaunchCounter:
    """A count of launches on the card: ``launches`` counts eager
    launches, plus, for each replay of a CUDA graph, the launches captured
    in it (tallied on the graph while it is captured); callers reset it to
    0 to count one run."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0

    def _add(self, capturing: bool) -> None:
        if capturing:
            _TALLY[self] = _TALLY.get(self, 0) + 1
        else:
            self.launches += 1

    def count(self, device: torch.device) -> None:
        """Count one launch just made on ``device``'s current stream."""
        with torch.cuda.device(device):
            self._add(_capturing(self.name))


class CudaKernel(LaunchCounter):
    """One ``.cu`` source, its C entry point and its launch counter:
    ``launches`` counts the successful launches made through
    :meth:`launch`, as a :class:`LaunchCounter` does."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        super().__init__(symbol)
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.build_log = ""
        self.build_s = 0.0
        self._fn = None
        self._err = None

    @property
    def library(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for f in (self.source, *sorted(CSRC.glob("*.cuh"))):
            h.update(f.read_bytes())
        digest = h.hexdigest()
        return BUILD_DIR / f"{self.source.stem}-{digest[:16]}.so"

    def _start_build(self) -> Optional[subprocess.Popen]:
        if self.library.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.library.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        self._t0 = time.perf_counter()
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    def _finish_build(self, proc: subprocess.Popen) -> None:
        out, _ = proc.communicate()
        self.build_s = time.perf_counter() - self._t0
        self.build_log = out
        tmp = self.library.with_suffix(f".{os.getpid()}.tmp")
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed on {self.source.name} (exit {proc.returncode}):"
                f"\n{out}")
        os.replace(tmp, self.library)

    def _load(self):
        if self._fn is None:
            build_all([self])
            lib = ctypes.CDLL(str(self.library))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, "cuda_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._err = fn, err
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream (appended as the last
        argument) and count it; raise if the launch was refused. On a
        capturing stream the launch is recorded, not run: it goes to the
        open :func:`capture_tally`, not to ``launches``; with no tally
        open, the launch raises before it is recorded."""
        fn = self._load()
        with torch.cuda.device(device):
            capturing = _capturing(self.symbol)
            stream = torch.cuda.current_stream(device).cuda_stream
            code = fn(*args, stream)
        if code != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {code} "
                               f"({self._err(code).decode()})")
        self._add(capturing)


def build_all(kernels: Iterable[CudaKernel]) -> Dict[str, float]:
    """Build every kernel not built yet, all ``nvcc`` processes at once.
    Returns {source name: build seconds} (0.0 when it was already built)."""
    kernels = list(kernels)
    procs = [(k, k._start_build()) for k in kernels]
    failures = []
    for k, proc in procs:
        if proc is None:
            continue
        try:
            k._finish_build(proc)
        except KernelBuildError as e:
            failures.append(str(e))
    if failures:
        raise KernelBuildError("\n".join(failures))
    return {k.source.name: k.build_s for k in kernels}


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """Device pointer of a tensor (None for an absent optional buffer)."""
    return None if t is None else t.data_ptr()


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                      device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
