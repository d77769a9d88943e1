"""The static separable ELL gather-sum: a hand-written CUDA kernel for
Hopper (``csrc/gather_sum_static.cu``) and its plain PyTorch version.

``gather_sum_static`` launches the kernel for tensors on the card and runs
the plain version for tensors on the CPU; there is no other route.  The
kernel is compiled by ``nvcc`` for ``sm_90a`` at first CUDA use, from the
source in this package, into ``build/torch_kernels/`` at the root of the
checkout, and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "csrc", "gather_sum_static.cu")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(_HERE)), "build", "torch_kernels"
)
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


class _Kernel:
    """The kernel's shared library (built once per process) and its launch
    count: ``launches`` rises by one at every kernel launch and nowhere
    else."""

    def __init__(self):
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        self.launches = 0
        self.build_seconds: Optional[float] = None
        #: the compiler's report (registers, spills) of the last build
        self.build_log = ""

    def library(self) -> ctypes.CDLL:
        """Build (if needed) and load the library."""
        with self._lock:
            if self._lib is None:
                self._lib = self._build()
            return self._lib

    def _build(self) -> ctypes.CDLL:
        t0 = time.perf_counter()
        with open(_SRC, "rb") as f:
            digest = hashlib.sha1(f.read()).hexdigest()[:12]
        so = os.path.join(_BUILD_DIR, f"libgather_sum_static_{digest}.so")
        if not os.path.exists(so):
            nvcc = shutil.which("nvcc") or os.path.join(
                os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
            )
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run(
                [nvcc, *_NVCC_FLAGS, "-o", tmp, _SRC],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
                )
            os.replace(tmp, so)
            self.build_log = proc.stderr
        lib = ctypes.CDLL(so)
        fn = lib.gather_sum_static
        p = ctypes.c_void_p
        i64 = ctypes.c_int64
        fn.argtypes = [p, ctypes.c_int, p, p, p, p, i64, i64, i64, i64, ctypes.c_int, p]
        fn.restype = ctypes.c_int
        self.build_seconds = time.perf_counter() - t0
        return lib


KERNEL = _Kernel()

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(table, feats: torch.Tensor, b: int, post_scale: Optional[torch.Tensor]):
    if feats.dim() != 2 or feats.dtype not in _DTYPE_CODE:
        raise ValueError(
            f"feats must be [N_src, B*F] float32 or bfloat16, got "
            f"{tuple(feats.shape)} {feats.dtype}"
        )
    n, w = table.nbr.shape[0], feats.shape[1]
    if b < 1 or w % b:
        raise ValueError(f"feature width {w} is not a multiple of b={b}")
    if table.nbr.dtype != torch.int32 or table.nbr.device != feats.device:
        raise ValueError("table.nbr must be int32 on the features' device")
    if table.n_src > feats.shape[0]:
        raise ValueError(
            f"table reads source row {table.n_src - 1} of {feats.shape[0]}"
        )
    if post_scale is not None and (
        tuple(post_scale.shape) != (n, b)
        or post_scale.dtype != torch.float32
        or post_scale.device != feats.device
    ):
        raise ValueError(
            f"post_scale must be [{n}, {b}] float32 on the features' device"
        )


def gather_sum_static_plain(
    table, feats: torch.Tensor, b: int, post_scale: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: a loop over the K slots with
    a select on ``k < deg``, so memory stays ``[N, B*F]`` and non-finite
    values in rows that no valid slot names cannot reach the sum."""
    n, k = table.nbr.shape
    w = feats.shape[1]
    deg = table.deg
    out = torch.zeros((n, w), dtype=torch.float32, device=feats.device)
    zero = out.new_zeros(())
    for j in range(k):
        take = (deg > j)[:, None]
        out += torch.where(take, feats[table.nbr[:, j]].float(), zero)
    if post_scale is not None:
        out = (out.view(n, b, w // b) * post_scale[:, :, None]).view(n, w)
    return out


def gather_sum_static(
    table, feats: torch.Tensor, b: int, post_scale: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``out[v, s*F:(s+1)*F] = post_scale[v, s] * sum_{k < deg[v]}
    feats[nbr[v, k], s*F:(s+1)*F]`` over a prefix-valid
    :class:`.ell.NeighborTable`; float32 ``[N, B*F]``.

    On a CUDA tensor this launches the kernel (or raises); on a CPU tensor
    it runs :func:`gather_sum_static_plain`.
    """
    _check(table, feats, b, post_scale)
    if feats.device.type == "cpu":
        return gather_sum_static_plain(table, feats, b, post_scale)
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    deg = table.deg
    tensors = [feats, table.nbr, deg] + ([post_scale] if post_scale is not None else [])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("gather_sum_static needs contiguous tensors")
    n, k = table.nbr.shape
    w = feats.shape[1]
    f = w // b
    out = torch.empty((n, w), dtype=torch.float32, device=feats.device)
    if n == 0 or w == 0:
        return out
    vec = 16 // feats.element_size()
    if f % vec or feats.data_ptr() % 16 or out.data_ptr() % 16:
        vec = 1
    lib = KERNEL.library()
    with torch.cuda.device(feats.device):
        rc = lib.gather_sum_static(
            feats.data_ptr(), _DTYPE_CODE[feats.dtype], table.nbr.data_ptr(),
            deg.data_ptr(), None if post_scale is None else post_scale.data_ptr(),
            out.data_ptr(), n, k, w, f, vec,
            torch.cuda.current_stream(feats.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"gather_sum_static kernel launch failed: cudaError {rc}")
    KERNEL.launches += 1
    return out
