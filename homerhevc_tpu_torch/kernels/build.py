"""Build and bind the hand-written CUDA kernels.

Route: `nvcc -shared -Xcompiler -fPIC` compiles each `kernels/<name>.cu`
into its own shared library with a plain C interface, loaded with ctypes.
Each launcher takes raw device pointers and the CUDA stream as integers
and returns the cudaError_t of the launch (0 = success). The sources
include no PyTorch header, so a build takes seconds.

Libraries are built at first use into `kernels/_build/` (listed in
.gitignore), named by a hash of source + flags so an edited source is
rebuilt; what `-Xptxas -v` prints (registers, shared memory and spills of
every kernel) is kept beside each library as `<library>.ptxas.txt`. A failed
build or launch raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (no CUDA_HOME, no nvcc)")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


def build_library(name: str) -> Path:
    """Compile kernels/<name>.cu (if not already built) -> library path."""
    src = _DIR / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes()
                         + repr(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"lib{name}-{key[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name}:\n{res.stderr}")
    ptxas_log(lib).write_text(res.stderr)
    os.replace(tmp, lib)
    return lib


def ptxas_log(lib: Path) -> Path:
    """Where build_library keeps the `-Xptxas -v` output of a library."""
    return lib.with_name(lib.name + ".ptxas.txt")


def build_all(names) -> list:
    """Build several kernel libraries at once, one nvcc process each."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return list(pool.map(build_library, names))


KERNELS: list = []               # every CudaKernel, in order of creation


class CudaKernel:
    """One kernel library: lazy build + bind, launch with error check, and
    a count of launches (`launches`) so a run can show the main path went
    through it. It counts launches as the device runs them: one per eager
    `launch`; a launch recorded into a CUDA graph counts on each replay of
    the graph, not at its capture (pipeline/p_graph.py)."""

    def __init__(self, name: str, argtypes, floor_argtypes):
        KERNELS.append(self)
        self.name = name
        self.source = f"homerhevc_tpu_torch/kernels/{name}.cu"
        self.argtypes = list(argtypes)
        self.floor_argtypes = list(floor_argtypes)
        self.launches = 0
        self._lib = None
        self._fn = None
        self._floor = None
        self._err = None

    def load(self):
        """Build (first use) and bind the launcher; returns it."""
        if self._fn is None:
            lib = self._lib = ctypes.CDLL(str(build_library(self.name)))
            fn = getattr(lib, f"{self.name}_launch")
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            floor = getattr(lib, f"{self.name}_floor_launch")
            floor.argtypes = self.floor_argtypes
            floor.restype = ctypes.c_int
            err = getattr(lib, f"{self.name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._floor, self._err = fn, floor, err
        return self._fn

    def _check(self, rc: int) -> None:
        if rc != 0:
            raise RuntimeError(f"{self.name} launch failed: cudaError {rc} "
                               f"({self._err(rc).decode()})")

    def launch(self, *args) -> None:
        self._check(self.load()(*args))
        self.launches += 1

    def launch_on(self, device, *args) -> None:
        """Launch on `device`'s current stream with `device` made current
        for the call (the stream's own device: a launch on another device's
        stream fails), the stream being the launcher's last argument."""
        import torch
        with torch.cuda.device(device):
            self.launch(*args, torch.cuda.current_stream(device).cuda_stream)

    def entry(self, symbol: str, argtypes=None):
        """Another C entry of the library, bound with `argtypes` (default:
        the launcher's) and returning an int."""
        self.load()
        fn = getattr(self._lib, symbol)
        fn.argtypes = self.argtypes if argtypes is None else list(argtypes)
        fn.restype = ctypes.c_int
        return fn

    def launch_other(self, symbol: str, *args, argtypes=None) -> None:
        """Launch another entry of the library (a yardstick for timing; not
        counted as a launch of the kernel); `argtypes` as for `entry`."""
        self._check(self.entry(symbol, argtypes)(*args))

    def launch_floor(self, *args) -> None:
        """Launch the library's empty kernel of the same grid and CTA size
        (a yardstick for timing; not counted as a launch of the kernel)."""
        self.load()
        self._check(self._floor(*args))
