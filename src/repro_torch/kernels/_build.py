"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel directory holds one ``csrc/<name>.cu`` with a plain C interface
(no PyTorch headers), so a build takes seconds. The shared library goes to
``build/kernels/<name>-<hash>/lib<name>.so`` at the root of the checkout,
keyed by a hash of the source and the flags, so an edited source rebuilds
and an unchanged one is reused. Nothing is built at import: a wrapper builds
its library on its first launch, and :func:`build_all` builds every kernel
at once, one ``nvcc`` process per source, all started together.

Every C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_KERNELS_DIR = Path(__file__).resolve().parent
_ROOT = _KERNELS_DIR.parents[2]
BUILD_DIR = _ROOT / "build" / "kernels"

#: Every kernel of the port, by the name of its directory and source.
NAMES = ("rmsnorm", "decode_attention", "flash_attention", "pricing")

FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_libs: dict[str, ctypes.CDLL] = {}
_bound: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_lock = threading.Lock()


def source(name: str) -> Path:
    return _KERNELS_DIR / name / "csrc" / f"{name}.cu"


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    digest = hashlib.sha256(
        source(name).read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}" / f"lib{name}.so"


def _start(name: str, verbose: bool) -> tuple[Path, Path, subprocess.Popen]:
    out = library_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(source(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp: Path,
            proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)       # atomic: a concurrent build sees old or new
    return log


def build_all(verbose: bool = False) -> dict[str, str]:
    """Compile every kernel, one ``nvcc`` per source, all in parallel.

    Rebuilds even where a library exists, so that ``verbose`` output
    (``-Xptxas -v``: registers, shared memory, spills) is always produced.
    Returns the compiler's output per kernel and loads the new libraries.
    """
    started = {n: _start(n, verbose) for n in NAMES}
    logs = {n: _finish(n, *started[n]) for n in NAMES}
    with _lock:
        for n in NAMES:
            _libs[n] = ctypes.CDLL(str(library_path(n)))
        _bound.clear()
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                _finish(name, *_start(name, verbose=False))
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib


def bind(name: str, fn: str, argtypes: list) -> ctypes._CFuncPtr:
    """Entry point ``fn`` of kernel ``name`` with its argument types set;
    looked up once, then served from a table (wrappers call this on every
    launch)."""
    f = _bound.get((name, fn))
    if f is None:
        f = getattr(load(name), fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _bound[(name, fn)] = f
    return f


def check(name: str, err: int) -> None:
    """Raise if a C entry point of kernel ``name`` reported a CUDA error."""
    if err != 0:
        describe = getattr(load(name), "kernel_error_string")
        describe.argtypes, describe.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({describe(err).decode()})")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def rows_aligned(t) -> bool:
    """Every row of ``t`` starts on 16 bytes: a unit last stride, the other
    strides multiples of 16 bytes and a 16-byte aligned base address, as
    the kernels' vector loads need."""
    return (t.stride(-1) == 1
            and all(s * t.element_size() % 16 == 0 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
