"""Build and bind the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled on first use with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``build/kernels/<name>-<hash>.so`` at the repo root (the hash covers the
source and every ``*.cuh`` header, so an edited source rebuilds), and loaded with
ctypes. Device pointers and the stream go in as ``c_void_p``; each C
function returns ``cudaGetLastError()`` and a non-zero code raises.
``Kernel.call`` is the one place a C function is called: with the tensors'
device current and that device's stream.

Nothing here runs at import: the CPU tests import every wrapper module on a
host with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


class Kernel:
    """One CUDA source, its shared library, and a count of launches.

    ``launches`` is a plain integer: each wrapper adds one where it launches
    the kernel, so a run can show that its path went through the kernel.
    """

    def __init__(self, source: str, functions: dict):
        self.source = CSRC / source
        self.functions = functions      # exported name -> ctypes argtypes
        self.launches = 0
        self.build_log = ""
        self._lib = None

    @property
    def name(self) -> str:
        return self.source.stem

    def so_path(self) -> Path:
        h = hashlib.sha1(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:12]}.so"

    def start_build(self):
        """Start nvcc for this source; None when the library is built."""
        out = self.so_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, out

    def finish_build(self, job) -> None:
        if job is None:
            return
        proc, tmp, out = job
        self.build_log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source}:\n{self.build_log}")
        os.replace(tmp, out)

    def lib(self):
        if self._lib is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self.so_path()))
            for fn, argtypes in self.functions.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.cista_error_string.argtypes = [ctypes.c_int]
            lib.cista_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def call(self, fn: str, *args, device: torch.device) -> None:
        """Run one exported function on the tensors' ``device``: the call
        runs with ``device`` the thread's current device (the sources read
        ``cudaGetDevice``) and gets that device's current stream as its
        last argument. Raise on a non-zero CUDA error."""
        lib = self.lib()
        with torch.cuda.device(device):
            rc = getattr(lib, fn)(*args, stream_ptr(device))
        if rc != 0:
            msg = lib.cista_error_string(rc).decode()
            raise RuntimeError(f"{self.name}.{fn}: CUDA error {rc} ({msg})")

    def launch(self, fn: str, *args, device: torch.device) -> None:
        """``call`` and count it as one launch of this kernel."""
        self.call(fn, *args, device=device)
        self.launches += 1


class SharedKernel:
    """A second wrapper over a library that another ``Kernel`` builds, with
    a launch count of its own (K3a beside K3 in ista.cu, K4s beside K4 in
    norm.cu)."""

    def __init__(self, kernel: Kernel):
        self.kernel = kernel
        self.launches = 0

    def call(self, fn: str, *args, device: torch.device) -> None:
        self.kernel.call(fn, *args, device=device)

    def launch(self, fn: str, *args, device: torch.device) -> None:
        self.kernel.call(fn, *args, device=device)
        self.launches += 1


def kernel_counters() -> dict:
    """Each kernel's launch counter, by its key in the kernel table (K3a and
    K4s count launches of K3's and K4's library)."""
    from . import cuda_aug, cuda_conv, cuda_corr, cuda_ista, cuda_ista2, cuda_norm
    return {"K1": cuda_corr.KERNEL, "K2": cuda_aug.KERNEL, "K3": cuda_ista2.KERNEL,
            "K3a": cuda_ista2.KERNEL_V2, "K4": cuda_norm.KERNEL,
            "K4s": cuda_norm.KERNEL_STATS, "K5": cuda_conv.KERNEL, "K6": cuda_ista.KERNEL}


def build_all(kernels) -> float:
    """Compile every kernel's source in parallel (one nvcc each, all
    started together; a ``SharedKernel`` has none of its own), then load
    them. Returns the seconds taken."""
    kernels = [k for k in kernels if isinstance(k, Kernel)]
    t0 = time.perf_counter()
    jobs = [(k, k.start_build()) for k in kernels]
    for k, job in jobs:
        k.finish_build(job)
    for k in kernels:
        k.lib()
    return time.perf_counter() - t0


def check_cuda(name: str, dtypes, *tensors) -> None:
    """Validate what every kernel needs of its tensor arguments: one
    device, contiguous, an accepted dtype. Raises rather than letting a
    kernel read a bad buffer."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous tensors")
        if t.dtype not in dtypes:
            raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")


def stream_ptr(device: torch.device) -> int:
    """The current stream's raw ``cudaStream_t`` on ``device``, read without
    building a ``torch.cuda.Stream`` object (which costs the host several
    microseconds on every launch). ``torch._C._cuda_getCurrentRawStream`` is
    private to PyTorch; where a build lacks it, the public
    ``current_stream().cuda_stream`` gives the same pointer."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream(index).cuda_stream
    return raw(index)


def on_cpu(t: torch.Tensor) -> bool:
    """The plain PyTorch version runs only for tensors on the CPU; any
    other device must reach the kernel (or raise)."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return False
