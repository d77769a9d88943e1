"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/*.cu`` file, with the ``csrc/*.cuh`` headers it includes, is
one shared library with a plain C interface, compiled by ``nvcc`` for
``sm_90a`` at first CUDA use into ``build/torch_kernels/`` at the root of
the checkout and loaded with ``ctypes``.  Nothing here runs when a module
is imported, and nothing runs for tensors on the CPU.

A :class:`Kernel` is one exported C function with its launch count:
``launches`` rises by one at every launch its wrapper makes and nowhere
else.  :func:`build_all` compiles every source at once, one ``nvcc`` process
per file.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "torch_kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _nvcc() -> str:
    return shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
    )


class Library:
    """One source file and its shared library (built once per process)."""

    def __init__(self, source: str):
        self.source = os.path.join(CSRC, source)
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        self.build_seconds: Optional[float] = None
        #: the compiler's report (registers, spills) of the last build
        self.build_log = ""

    @property
    def built(self) -> bool:
        """Whether the library has been loaded in this process."""
        return self._lib is not None

    def _so_path(self) -> str:
        """The library's path under :data:`BUILD_DIR`, named by a digest of
        the source, every header beside it (any source may include one) and
        the compiler's flags, so that an edit to any of them builds anew."""
        h = hashlib.sha1()
        headers = sorted(glob.glob(os.path.join(os.path.dirname(self.source), "*.cuh")))
        for path in [self.source, *headers]:
            with open(path, "rb") as f:
                h.update(f.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        digest = h.hexdigest()[:12]
        stem = os.path.splitext(os.path.basename(self.source))[0]
        return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")

    def _start(self):
        """Start ``nvcc`` unless the library exists; returns (process, tmp, so)."""
        so = self._so_path()
        if os.path.exists(so):
            return None, None, so
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        return proc, tmp, so

    def _finish(self, proc, tmp: Optional[str], so: str, t0: float) -> ctypes.CDLL:
        if proc is not None:
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {os.path.basename(self.source)} "
                    f"({proc.returncode}):\n{out}\n{err}"
                )
            os.replace(tmp, so)
            self.build_log = err
        lib = ctypes.CDLL(so)
        self.build_seconds = time.perf_counter() - t0
        return lib

    def load(self) -> ctypes.CDLL:
        """Build (if needed) and load the library."""
        with self._lock:
            if self._lib is None:
                t0 = time.perf_counter()
                self._lib = self._finish(*self._start(), t0)
            return self._lib


_LIBRARIES: Dict[str, Library] = {}


def library(source: str) -> Library:
    """The process-wide :class:`Library` of ``csrc/<source>``."""
    if source not in _LIBRARIES:
        _LIBRARIES[source] = Library(source)
    return _LIBRARIES[source]


def build_all() -> List[Library]:
    """Compile every ``csrc/*.cu`` in parallel (one ``nvcc`` each, all
    started together) and load them; raises if any build fails."""
    libs = [library(os.path.basename(p)) for p in sorted(glob.glob(os.path.join(CSRC, "*.cu")))]
    t0 = time.perf_counter()
    started = []
    for lib in libs:
        with lib._lock:
            started.append(None if lib._lib is not None else lib._start())
    errors = []
    for lib, job in zip(libs, started):
        if job is None:
            continue
        with lib._lock:
            try:
                lib._lib = lib._finish(*job, t0)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return libs


class Kernel:
    """One exported C function of a :class:`Library` and its launch count."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.library = library(source)
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def function(self):
        """The C function, building and loading the library on first use.
        It returns ``cudaGetLastError()`` after its launch."""
        if self._fn is None:
            fn = getattr(self.library.load(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        """Call the C function and count the launch; raises on a CUDA error."""
        rc = self.function()(*args)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} kernel launch failed: cudaError {rc}")
        self.launches += 1
