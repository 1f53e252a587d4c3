"""Build and load the port's CUDA kernels; the table of kernels and their
launch counts.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
``ctypes``. Libraries are keyed by a hash of their source, the shared
headers (``csrc/*.cuh``) and the flags, and kept
under ``build/torch_kernels/`` at the repository root, so a second run does
not rebuild. Nothing is compiled at import time: the CPU tests import every
module, and this machine may have no ``nvcc``.

Every C entry point launches on the stream it is given (PyTorch's current
stream), allocates nothing, does not synchronise, and returns
``cudaGetLastError()`` after its launch; :func:`check` raises on non-zero.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import importlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Mapping, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
SOURCES = ("scatter", "window_attention", "ffn", "pixel_shuffle", "transp_conv", "pixelweight",
           "instance_norm", "winograd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


@dataclass(frozen=True)
class KernelInfo:
    name: str  # wrapper function name, also the kernel's name in reports
    module: str  # module of this package that holds the wrapper
    source: str  # CUDA source, relative to the repository root
    replaces: str  # the Pallas kernel it ports (file:line in the JAX package)
    # the __global__ functions one counted launch runs exactly one of (a
    # packing or filter launch beside it is not counted)
    symbols: Tuple[str, ...]


KERNELS: Tuple[KernelInfo, ...] = (
    KernelInfo("scatter_add_windows", "ops.scatter",
               "hybrid_ctunet_tpu_torch/csrc/scatter.cu",
               "hybrid_ctunet_tpu/ops/scatter_pallas.py:108",
               ("scatter_rows",)),
    KernelInfo("window_attention", "ops.attention",
               "hybrid_ctunet_tpu_torch/csrc/window_attention.cu",
               "hybrid_ctunet_tpu/ops/attention_pallas.py:68",
               ("window_attention_kernel",)),
    KernelInfo("ffn", "ops.ffn",
               "hybrid_ctunet_tpu_torch/csrc/ffn.cu",
               "hybrid_ctunet_tpu/ops/ffn_pallas.py:227",
               ("ffn_kernel",)),
    KernelInfo("ffn_pair", "ops.ffn",
               "hybrid_ctunet_tpu_torch/csrc/ffn.cu",
               "hybrid_ctunet_tpu/ops/ffn_pallas.py:153",
               ("pair_kernel",)),
    KernelInfo("pixel_shuffle_linear", "ops.shuffle",
               "hybrid_ctunet_tpu_torch/csrc/pixel_shuffle.cu",
               "hybrid_ctunet_tpu/ops/shuffle_pallas.py:111",
               ("shuffle_kernel",)),
    KernelInfo("transp_conv_kxs", "ops.shuffle",
               "hybrid_ctunet_tpu_torch/csrc/transp_conv.cu",
               "hybrid_ctunet_tpu/ops/shuffle_pallas.py:240",
               ("transp_conv_kernel",)),
    KernelInfo("pixelweight", "ops.pixelweight",
               "hybrid_ctunet_tpu_torch/csrc/pixelweight.cu",
               "hybrid_ctunet_tpu/ops/pixelweight.py:128",
               ("pixelweight_kernel",)),
    KernelInfo("instance_norm", "ops.norm",
               "hybrid_ctunet_tpu_torch/csrc/instance_norm.cu",
               "hybrid_ctunet_tpu/ops/norm_pallas.py:45",
               ("in_onchip_kernel", "in_normalize_kernel")),
    KernelInfo("conv3x3_winograd", "ops.winograd",
               "hybrid_ctunet_tpu_torch/csrc/winograd.cu",
               "hybrid_ctunet_tpu/ops/winograd_pallas.py:210",
               ("wino_kernel",)),
)


def wrapper(info: KernelInfo):
    mod = importlib.import_module(f"{__package__.rsplit('.', 1)[0]}.{info.module}")
    return getattr(mod, info.name)


def reset_launch_counts() -> None:
    """Zero every wrapper's launch counter and the recompute counter."""
    from ..ops.recompute import checkpoint

    for info in KERNELS:
        wrapper(info).launches = 0
    checkpoint.recomputes = 0


def launch_counts() -> Dict[str, int]:
    return {info.name: wrapper(info).launches for info in KERNELS}


def recomputes() -> int:
    """Rematerialized regions run again in a backward since the last reset
    (``ops.recompute.checkpoint.recomputes``)."""
    from ..ops.recompute import checkpoint

    return checkpoint.recomputes


def traced_counts(names: Iterable[str]) -> Dict[str, int]:
    """Records of each kernel among the device-kernel names of a trace (one
    name a record), matched by the kernel's CUDA symbols."""
    pats = {info.name: re.compile(r"(?:^|[\s:])(?:%s)[<(]" % "|".join(info.symbols))
            for info in KERNELS}
    counts = dict.fromkeys(pats, 0)
    for name in names:
        for kernel, pat in pats.items():
            if pat.search(name):
                counts[kernel] += 1
    return counts


def reconcile(traced: Mapping[str, int], launched: Mapping[str, int]) -> None:
    """Raise unless a trace holds one record per counted launch of every
    kernel: a trace that lost records would report a partial table."""
    diff = {k: (traced.get(k, 0), n) for k, n in launched.items() if traced.get(k, 0) != n}
    if diff:
        raise RuntimeError("the trace's kernel records differ from the launch counters "
                           f"(kernel: (traced, launched)): {diff}")


@contextlib.contextmanager
def gates_off():
    """Every kernel module's gate declines while this stands, so each site
    takes its plain version."""
    from ..ops import attention, ffn, norm, pixelweight, shuffle, winograd

    saved = [(m, n, getattr(m, n)) for m, n in (
        (attention, "supports"), (ffn, "supports"), (ffn, "pair_supports"),
        (shuffle, "supports"), (shuffle, "transp_supports"), (pixelweight, "supports"),
        (norm, "supports"), (winograd, "supports"))]
    for m, n, _ in saved:
        setattr(m, n, lambda *a, **k: False)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME  # CUDA_HOME env or the default install

    path = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if not CUDA_HOME or not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _compile(name: str) -> Path:
    out = _lib_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    return out


def build_all() -> float:
    """Compile every source that has no library yet, in parallel; return the
    seconds it took."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as ex:
        for fut in [ex.submit(_compile, n) for n in SOURCES]:
            fut.result()
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use. Every C
    entry point returns ``int`` (a ``cudaError_t``)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(_compile(name)))
        _LIBS[name] = lib
    return lib


def bind(name: str, fn: str, *argtypes) -> ctypes._CFuncPtr:
    """Entry point ``fn`` of library ``name`` with its argument types set
    (``ctypes.c_void_p`` for pointers and the stream)."""
    key = (name, fn)
    f = _FNS.get(key)
    if f is None:
        f = getattr(library(name), fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
        _FNS[key] = f
    return f


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
    """PyTorch's current stream on ``device``, as the raw pointer a C entry
    takes (the accessor that does not build a ``torch.cuda.Stream``: that
    one costs each kernel call some 6 us of host time)."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
