"""Build and load the port's CUDA kernels (``paddle_tpu_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with :mod:`ctypes`.  A file
that includes no PyTorch header builds in seconds, where
``torch.utils.cpp_extension.load`` takes minutes.  A library of several
translation units (``UNITS``: flash attention's forward, dq and dk/dv
entries, each instantiating only its kernels) is compiled one ``nvcc``
a unit, all at once with the other libraries, then linked.

 - The library name carries a digest of the source, the shared headers
   (``csrc/*.cuh``) and the flags, so a changed source is rebuilt and an
   unchanged one is reused.
 - The output goes to ``paddle_tpu_torch/_build/`` (git-ignored),
   written to a temporary name and renamed into place.
 - A failed compile raises with nvcc's output; nothing falls back.
 - Every C entry returns ``cudaGetLastError()`` after its launch, and
   :func:`check` raises on a non-zero status.
 - Each library compiled is one compile of the telemetry
   (``record_compile("nvcc:<name>")``); a library already built is not.

Nothing here runs at import: the first CUDA tensor that reaches a
kernel wrapper builds and loads its library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

from ..observability.telemetry import get_telemetry

__all__ = ["SOURCES", "UNITS", "BUILD_DIR", "NVCC_FLAGS", "build", "load",
           "check"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("paged_attention", "w8a16", "layer_norm", "flash_attention",
           "softmax_xent", "block_gemm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
#: the libraries built from several translation units (``csrc/<unit>.cu``)
UNITS = {"flash_attention": ("flash_attention", "flash_attention_dq",
                             "flash_attention_dkv")}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def _units(name: str) -> Tuple[str, ...]:
    return UNITS.get(name, (name,))


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256()
    for unit in _units(name):
        digest.update((CSRC / f"{unit}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # what a source may include
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES, *, verbose: bool = False
          ) -> Dict[str, Tuple[Path, str]]:
    """Compile every named source whose library is missing, one ``nvcc``
    per translation unit, all started together (a library of several
    units linked once its units are compiled).

    Returns ``{name: (library path, nvcc's output)}`` (the output is
    empty for a library that was already built).  ``verbose`` adds
    ``-Xptxas -v``, which reports each kernel's registers, shared memory
    and spills; it does not change the library.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = {}
    result = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            result[name] = (out, "")
            continue
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        units = _units(name)
        if len(units) == 1:
            cmds = [[_nvcc(), *NVCC_FLAGS, *extra, "-o", str(tmp),
                     str(CSRC / f"{name}.cu")]]
            objs = []
        else:
            flags = [f for f in NVCC_FLAGS if f != "-shared"]
            objs = [tmp.with_name(f"{tmp.name}.{u}.o") for u in units]
            cmds = [[_nvcc(), *flags, *extra, "-c", "-o", str(o),
                     str(CSRC / f"{u}.cu")] for u, o in zip(units, objs)]
        procs[name] = ([subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True)
                        for cmd in cmds], objs, tmp, out)
    failed = []
    for name, (running, objs, tmp, out) in procs.items():
        logs, codes = [], []
        for proc in running:
            log, _ = proc.communicate()
            logs.append(log)
            codes.append(proc.returncode)
        if objs and not any(codes):
            link = subprocess.run(
                [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                 "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
                 *map(str, objs)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
            logs.append(link.stdout)
            codes.append(link.returncode)
        for o in objs:
            o.unlink(missing_ok=True)
        log = "".join(logs)
        if any(codes):
            failed.append(f"{name}.cu (nvcc exit {max(codes)}):\n{log}")
            continue
        os.replace(tmp, out)
        result[name] = (out, log)
        get_telemetry().record_compile(f"nvcc:{name}", out.name)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return result


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``.

    ``signatures`` maps each C entry to its ``argtypes`` tuple; every
    entry returns an ``int`` CUDA status.  Pointers and the stream must
    be declared ``ctypes.c_void_p`` so they are not cut to 32 bits.
    """
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path, _ = build([name])[name]
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            lib.ptt_error_string.argtypes = [ctypes.c_int]
            lib.ptt_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise when a C entry reported a CUDA error for its launch."""
    if status != 0:
        msg = lib.ptt_error_string(status).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {status}: {msg}")
