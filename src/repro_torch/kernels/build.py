"""The one way the port builds and binds a CUDA source: ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``.

A library is compiled at its first use into ``build/kernels/`` at the
repository root, named by a hash of the source, the headers it includes
from its own directory and the flags, so an edited source or header
rebuilds and an unchanged one is loaded as it is.  Nothing is built
when a module is imported: the CPU tests import every module, and the CPU
has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "CudaLibrary", "local_headers",
           "raise_on", "source_tag"]

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def local_headers(source: Path) -> list[Path]:
    """The headers ``source`` includes by ``#include "name"`` from its own
    directory, and theirs, each once, in the order first met."""
    found: list[Path] = []
    todo = [Path(source)]
    while todo:
        path = todo.pop(0)
        for name in _INCLUDE.findall(path.read_bytes()):
            header = path.parent / name.decode()
            if header.is_file() and header not in found:
                found.append(header)
                todo.append(header)
    return found


def source_tag(source: Path) -> str:
    """The library's tag: a hash of the source, of each header it includes
    from its directory (:func:`local_headers`) and of the flags."""
    digest = hashlib.sha256(Path(source).read_bytes())
    for header in local_headers(source):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or at /usr/local/cuda/bin/nvcc: the "
            "CUDA kernels cannot be built")
    return path


class CudaLibrary:
    """One CUDA source and its ``ctypes`` binding.

    ``declare(lib)`` sets ``argtypes``/``restype`` of every C entry and may
    raise if the library and its wrapper disagree.  :meth:`build` compiles
    (when needed) and loads once per process; :attr:`lib` is the loaded
    library, built on first access.
    """

    def __init__(self, source: Path, stem: str,
                 declare: Callable[[ctypes.CDLL], None]):
        self.source = Path(source)
        self.stem = stem
        self._declare = declare
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self._info: dict = {}

    def build(self) -> dict:
        """Compile (when the source, a header it includes or the flags
        changed) and load.  Returns
        ``{"path", "seconds", "compiled", "log"}``, where ``log`` is nvcc's
        output (``-Xptxas -v``: registers and shared memory per kernel).
        Raises if nvcc fails."""
        with self._lock:
            if self._lib is not None:
                return self._info
            so = self.path
            t0 = time.perf_counter()
            log, compiled = "", not so.exists()
            if compiled:
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                    capture_output=True, text=True, check=False)
                log = proc.stdout + proc.stderr
                if proc.returncode:
                    raise RuntimeError(
                        f"nvcc failed on {self.source.name} with exit code "
                        f"{proc.returncode}:\n{log}")
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            self._declare(lib)
            self._info.update(path=str(so), compiled=compiled, log=log,
                              seconds=time.perf_counter() - t0)
            self._lib = lib
        return self._info

    @property
    def path(self) -> Path:
        """The shared library's file: ``build/kernels/lib<stem>_<tag>.so``,
        the tag :func:`source_tag` of the source as it is now."""
        return BUILD_DIR / f"lib{self.stem}_{source_tag(self.source)}.so"

    @property
    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            self.build()
        return self._lib


def raise_on(err: int, name: str) -> None:
    """A C entry returns ``cudaGetLastError()``: non-zero is a refused or
    failed launch, raised here (``synchronize`` would not report it)."""
    if err:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{err}")
