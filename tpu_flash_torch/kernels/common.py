"""Shared helpers for the hand-written CUDA kernels.

Counterpart of ``tpu_flash/kernels/common.py``: the mask constant and the
integer helpers, plus what a CUDA port needs and Pallas did not — device
resolution, the ``nvcc`` build of ``csrc/`` at first use, the ``ctypes``
binding, and a launch counter per kernel.

The kernels are built with ``nvcc`` into ``_build/`` beside this file (listed
in ``.gitignore``) the first time one is launched, and loaded as shared
libraries with a plain C interface.  Importing this module builds nothing and
needs no card, so the CPU tests import every module of the package.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

MASK_VALUE = -1e7  # the JAX package's additive mask constant

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "--warn-on-spills", "-Xptxas", "-v",
)

# Launches per kernel name.  A wrapper adds one where it launches its kernel
# and nowhere else, so a run can show that its path went through the kernel.
launch_counts: collections.Counter[str] = collections.Counter()
# A kernel's tensor-core form counts its launches under the name + TC; the
# quantized matmuls' tensor-core decode form under the name + DEC; the flash
# kernels' fp32 form on the tensor cores (six bf16 products a product)
# under the name + X6; the quantized matmuls' fp32-x prefill form on the
# tensor cores (three bf16 products a product) under the name + X3, and
# their fp32-x decode form on the tensor cores under the name + DEC_X3.
TC = "_tc"
DEC = "_dec"
X6 = "_x6"
X3 = "_x3"
DEC_X3 = "_dec_x3"

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def split3_bf16(x: torch.Tensor):
    """fp32 ``x`` as three bf16 tensors ``(hi, mid, lo)``, each rounded to
    the nearest (ties to even): ``hi = bf16(x)``, ``mid = bf16(x - hi)``,
    ``lo = bf16(x - hi - mid)``.  Each subtraction is exact in fp32, so
    ``hi + mid + lo == x`` wherever the residuals stay normal: the operand
    split of the fp32 kernels' tensor-core forms (``split3_pair`` in
    csrc/mma.cuh)."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Without one this raises rather than
    dropping to the CPU: CPU runs must ask for ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.index is None:     # "cuda" names the current card
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@functools.lru_cache(maxsize=16)
def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors, which launch plans fill."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def resolve_impl(impl: str | None, x: torch.Tensor) -> str:
    """``"kernel"`` for a CUDA tensor and ``"plain"`` for a CPU one, unless
    the caller names one.  A CPU tensor cannot take the kernel."""
    if impl is None:
        return "kernel" if x.is_cuda else "plain"
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    if impl == "kernel" and not x.is_cuda:
        raise ValueError("impl='kernel' needs CUDA tensors")
    return impl


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine with the card")


@dataclasses.dataclass
class BuildResult:
    path: Path
    seconds: float        # 0.0 when an earlier build was reused
    log: str              # nvcc's output: ptxas's report of each kernel
                          # (registers, stack, spills) and its warnings


def _lib_path(name: str) -> Path:
    """The library's path, named by a digest of its source, the other files
    of ``csrc/`` (the shared headers, and the sources that a ``_kvq``
    source includes) and the flags, so that editing any of them rebuilds
    it."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for other in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(other.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names, rebuild: bool = False) -> dict[str, BuildResult]:
    """Compile ``csrc/<name>.cu`` for each name, one ``nvcc`` process per
    source, all started together.  Reuses a library whose source and flags
    are unchanged, unless ``rebuild`` (which gets ptxas's report anew)."""
    names = list(names)
    BUILD_DIR.mkdir(exist_ok=True)
    results, running = {}, []
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists() and not rebuild:
            results[name] = BuildResult(out, 0.0, "")
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running.append((name, out, tmp, proc))
    for name, out, tmp, proc in running:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{stdout}{stderr}")
        os.replace(tmp, out)
        results[name] = BuildResult(out, time.perf_counter() - t0,
                                    stdout + stderr)
    return results


def load_library(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built at first use.  Every
    source exports ``tf_cuda_error_string`` beside its entries."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build([name])[name].path))
            lib.tf_cuda_error_string.argtypes = [ctypes.c_int]
            lib.tf_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def entry(name: str, symbol: str, argtypes):
    """``(library, function)``: the C entry ``symbol`` of ``csrc/<name>.cu``
    returning an ``int``, with its argument types declared."""
    lib = load_library(name)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return lib, fn


def kernel_input(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (a copy where it is not), after
    checking that it lies on ``device``."""
    if t.device != device:
        raise ValueError(f"a kernel input lies on {t.device}, not {device}")
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def call_on_stream(fn, device: torch.device, *args) -> int:
    """``fn(*args, stream)`` with ``device`` current and its current
    stream as the last argument: a kernel launches on PyTorch's stream."""
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


def check_cuda(code: int, lib: ctypes.CDLL, what: str) -> None:
    """Raise if a C entry returned a CUDA error (``cudaGetLastError()``)."""
    if code != 0:
        msg = lib.tf_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
