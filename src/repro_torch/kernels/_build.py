"""Build the port's CUDA sources and bind them with ``ctypes``.

Each ``repro_torch/csrc/<name>.cu`` exposes one plain C entry point per
kernel variant: pointers and the stream as ``void*``, sizes as ``int``,
returning ``cudaGetLastError()`` after its launch.  On first use it is
compiled by ``nvcc`` for ``sm_90a`` into ``build/repro_torch_kernels/`` at
the root of the checkout (listed in ``.gitignore``).  The library's file
name carries a hash of its source and of the shared headers
(``csrc/*.cuh``), so an edited source is rebuilt and a stale library is
never loaded.  :func:`build_all` starts one ``nvcc`` per source, all at once,
and waits for every one of them.

Nothing here runs at import time: the CPU tests import every module of the
port, and ``nvcc`` is only reached when a kernel is launched on a CUDA
tensor (or a caller asks for :func:`build_all`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

import torch

__all__ = ["KernelLibrary", "build_all", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_BUILD_LOCK = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # resolves nvcc's toolkit

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


class KernelLibrary:
    """One ``csrc/<name>.cu``: its build, its C entry points and their
    launch counts.

    ``variants`` maps each variant's name to its C entry point's symbol and
    argtypes.
    ``counts[variant]`` is a plain integer that :meth:`launch` raises by one
    each time that variant's kernel is launched, and nowhere else: a run
    reads the counts to show that its path went through the kernels.
    ``launches`` is their total.
    """

    def __init__(self, name: str, variants: Dict[str, Tuple[str, Sequence[type]]]):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.variants = dict(variants)
        self.counts = {v: 0 for v in variants}
        self._lib = None
        self._fns: Dict[str, object] = {}
        self._error_string = None

    @property
    def launches(self) -> int:
        return sum(self.counts.values())

    def reset(self) -> None:
        """Set every variant's count to 0."""
        self.counts = {v: 0 for v in self.variants}

    @property
    def path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    @property
    def log_path(self) -> Path:
        return self.path.with_suffix(".log")

    def _load(self):
        build_all([self])
        lib = ctypes.CDLL(str(self.path))
        fns = {}
        for variant, (entry, argtypes) in self.variants.items():
            fn = getattr(lib, entry)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            fns[variant] = fn
        err = getattr(lib, f"{self.name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._lib, self._fns, self._error_string = lib, fns, err

    def launch(self, variant: str, *args) -> None:
        """Call ``variant``'s C entry point; raise if the launch reported an
        error."""
        if not self._fns:
            self._load()
        code = self._fns[variant](*args)
        if code != 0:
            msg = self._error_string(code).decode()
            raise RuntimeError(
                f"{self.name} ({variant}) kernel launch failed: CUDA error {code} ({msg})")
        self.counts[variant] += 1

    def size(self, entry: str, *args: int) -> int:
        """The 64-bit integer the C function ``entry`` returns for integer
        ``args``: a size the kernels decide (a scratch buffer's), which the
        wrapper allocates.  Builds the library if need be; counts nothing."""
        if not self._fns:
            self._load()
        fn = getattr(self._lib, entry)
        fn.argtypes = [ctypes.c_int] * len(args)
        fn.restype = ctypes.c_longlong
        return int(fn(*args))

    def account(self, variant: str) -> None:
        """Count the launch of ``variant`` that a call on ``meta`` tensors
        stands for: the one a CUDA call of those shapes makes.  Nothing is
        built or launched."""
        self.counts[variant] += 1


def build_all(libs: Iterable[KernelLibrary]) -> Dict[str, float]:
    """Compile every library that is not built yet, one ``nvcc`` each, all
    started together.  Returns the seconds each compile took (0.0 for a
    library that was already built); raises with nvcc's output on failure."""
    libs = list(libs)
    with _BUILD_LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        started: List[tuple] = []
        seconds = {lib.name: 0.0 for lib in libs}
        for lib in libs:
            out = lib.path
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(lib.source)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            started.append((lib, proc, tmp, time.perf_counter()))
        failures: List[str] = []
        for lib, proc, tmp, t0 in started:
            log, _ = proc.communicate()
            seconds[lib.name] = time.perf_counter() - t0
            lib.log_path.write_text(log)
            if proc.returncode != 0:
                failures.append(f"{lib.source}:\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, lib.path)
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        return seconds


def stream_handle(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_aligned(name: str, tensors: Sequence[torch.Tensor]) -> None:
    """Raise ``ValueError`` unless every tensor starts on a 16-byte boundary,
    as TMA and 16-byte ``cp.async`` copies need."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must start on a 16-byte boundary")


def check_cuda_operands(name: str, tensors: Sequence[torch.Tensor],
                        dtypes: Sequence[torch.dtype], contiguous: bool = True) -> int:
    """Validate operands for a kernel launch (or, on ``meta`` tensors, for
    the launch they stand for); return the kernel's dtype code (0 = float32,
    1 = bfloat16).  Raises ``ValueError`` on what the kernel does not take:
    another device type, mixed devices or dtypes, an unsupported dtype, or
    (unless the kernel takes strides) a non-contiguous tensor."""
    first = tensors[0]
    if first.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name}: expected CPU, CUDA or meta tensors, got {first.device}")
    for t in tensors:
        if t.device != first.device:
            raise ValueError(f"{name}: operands on {first.device} and {t.device}")
        if t.dtype != first.dtype:
            raise ValueError(f"{name}: mixed dtypes {first.dtype} and {t.dtype}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if first.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {first.dtype} not supported (takes {list(dtypes)})")
    return list(dtypes).index(first.dtype)
