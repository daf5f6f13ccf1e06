"""Build the CUDA sources of ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on first use into its own shared
library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/lib<name>-<hash>.so

(no ``--use_fast_math``: it flushes subnormals, and the codec is
bit-exact in the subnormal band). The file name carries a hash of the
sources, so an edited kernel is rebuilt and a stale library is never
loaded. :func:`build_all` starts one nvcc per source at once and waits for
all of them. Every C entry point returns ``cudaGetLastError()``;
:func:`check` raises on anything but 0.

Nothing here runs at import time: the CPU tests import every module of
the package on hosts with no nvcc and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

__all__ = ["SOURCES", "CSRC", "BUILD_DIR", "build_all", "library", "check",
           "BUILD_INFO", "stream_of", "format_code", "KIND_CODES",
           "POSIT8_LUT", "IDENTITY_BITS", "launched", "posit8_lut",
           "aligned", "CODEC_WIDTHS", "SERVED_WIDTHS"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("codec", "qmatmul", "attention", "flash_attention",
           "flash_attention_wide", "lns_matmul", "fake_quant")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# per source: {"path", "seconds", "log"} of the build that produced it
BUILD_INFO: Dict[str, dict] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME/bin): the CUDA "
                       "kernels of repro_torch cannot be built on this host")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every source in ``names`` whose library is missing, one
    nvcc process each, all started together. Raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: _target(n) for n in names}
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        if out.exists():
            BUILD_INFO.setdefault(name, {"path": str(out), "seconds": 0.0,
                                         "log": "(cached)"})
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        BUILD_INFO[name] = {"path": str(out),
                            "seconds": time.perf_counter() - t0, "log": log}
    if errors:
        raise RuntimeError("\n".join(errors))
    return todo


def library(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (building all sources on
    first use), with ``argtypes`` set from ``signatures`` and every
    ``restype`` an int (the ``cudaError_t`` the entry point returns)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all()[name]
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


# The C entry points' format codes (csrc/wire.cuh, ``Kind``): the kernels
# are templated on the word width and on this code.
KIND_CODES = {"linear": 0, "lns": 1, "posit": 2, "none": 4}
POSIT8_LUT = 3          # posit8 through the shared-memory table
# the float caches of the identity codec, by word width (attention only)
IDENTITY_BITS = {"torch.bfloat16": 16, "torch.float32": 32}


# The word widths of the codec and fake-quant kernels (csrc/codec.cu,
# csrc/fake_quant.cu: n a kernel argument, words in 8-, 16-, 32- or 64-bit
# storage); every other kernel takes SERVED_WIDTHS only.
CODEC_WIDTHS = tuple(range(6, 65))
SERVED_WIDTHS = (8, 16)


def format_code(spec, device, kinds=("linear", "lns", "posit"),
                dtype=None, widths=SERVED_WIDTHS) -> int:
    """The format code a kernel is launched with for ``spec``'s words on
    ``device``: posit8 takes the table code when
    ``spec.lut_decode(device)``; the identity codec (kind ``"none"``, in
    ``kinds`` only for the attention kernels) takes its own code for a
    bf16 or f32 cache ``dtype``. Raises ``ValueError`` for a kind outside
    ``kinds``, a width outside ``widths`` (the codec and fake-quant take
    :data:`CODEC_WIDTHS`, the other kernels 8 and 16), or another float
    dtype: before any launch."""
    if spec.is_identity and "none" in kinds:
        if str(dtype) not in IDENTITY_BITS:
            raise ValueError(f"the CUDA attention kernels read bf16 or f32 "
                             f"float caches, got {dtype}")
        return KIND_CODES["none"]
    if spec.kind not in kinds or spec.n not in widths:
        bits = ("8- and 16-bit" if widths == SERVED_WIDTHS else
                f"{widths[0]}- to {widths[-1]}-bit")
        raise ValueError(f"this CUDA kernel takes {bits} words of "
                         f"kind {' / '.join(kinds)}, got {spec.name!r}")
    if spec.lut_decode(device):
        return POSIT8_LUT
    return KIND_CODES[spec.kind]


def posit8_lut():
    """The posit8 table decode of ``csrc/wire.cuh``: not a kernel of its
    own but a decode path inside the codec, matmul, attention and
    fake-quant kernels. ``posit8_lut.launches`` counts the launches of
    those kernels that ran it (see :func:`launched`)."""


posit8_lut.launches = 0


def launched(fn, code: int) -> None:
    """Count one launch of ``fn``'s kernel with format code ``code`` (and
    one of :func:`posit8_lut` when the kernel decodes through the table)."""
    fn.launches += 1
    if code == POSIT8_LUT:
        posit8_lut.launches += 1


def stream_of(t) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer-sized int."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def aligned(t):
    """``t`` contiguous and 16-byte aligned (the kernels' vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
