"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``.  A library is
built at first use into ``build/kernels/`` at the root of the checkout,
named by a hash of its source, the shared headers and the flags, so an edited
source rebuilds and an unchanged one is reused.  :func:`build_all` starts
one ``nvcc`` per source, all at once.

Every C entry point launches on the stream it is given and returns the
``cudaError_t`` of the launch; :class:`Kernel` raises when it is not 0 and
counts each launch in ``launches``.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

__all__ = ["Kernel", "KERNELS", "build_all", "reset_launches", "library",
           "BUILD_DIR", "CSRC"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v", ARCH)
_HEADERS = ("xdma_common.cuh", "hopper.cuh")
# what a source links beyond the runtime: kernel 6 encodes its TMA tensor
# maps with the driver API (cuTensorMapEncodeTiled)
LINK = {"flash_attention.cu": ("-lcuda",)}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# source name -> nvcc's output (kept beside the library as ``.log``, and
# read back from there when the library was built by an earlier process)
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc" if cand else None
        if path is not None and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _target(source: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS + LINK.get(source, ())).encode())
    for name in (source,) + _HEADERS:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def _start(source: str) -> Optional[subprocess.Popen]:
    out = _target(source)
    if out.exists():
        if out.with_suffix(".log").exists():
            BUILD_LOG[source] = out.with_suffix(".log").read_text()
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / source),
           *LINK.get(source, ())]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(source: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    BUILD_LOG[source] = log
    out = _target(source)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{log}")
    tmp_log = out.with_suffix(f".{os.getpid()}.logtmp")
    tmp_log.write_text(log)
    os.replace(tmp_log, out.with_suffix(".log"))
    os.replace(tmp, out)                # atomic: concurrent builders agree


def build_all(sources: Optional[Sequence[str]] = None) -> List[Path]:
    """Build every kernel library not yet built, one ``nvcc`` per source,
    all started together.  Returns the library paths."""
    if sources is None:
        sources = sorted(p.name for p in CSRC.glob("*.cu"))
    with _LOCK:
        procs = [(s, _start(s)) for s in sources]
        for s, proc in procs:
            _finish(s, proc)
    return [_target(s) for s in sources]


def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built first if needed."""
    lib = _LIBS.get(source)
    if lib is None:
        build_all([source])
        with _LOCK:
            lib = _LIBS.get(source)
            if lib is None:
                lib = _LIBS[source] = ctypes.CDLL(str(_target(source)))
    return lib


class Kernel:
    """One C entry point of one CUDA source, with its launch count.

    ``replaces`` names the TPU kernel of the reference it ports, as
    ``file:line``.  Calling the object launches on the current CUDA stream
    and raises ``RuntimeError`` when the launch status is not 0; a launch
    made with ``path=`` is also counted in ``paths`` under that name (the
    kernel's own code path, where it has more than one)."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence, replaces: str):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]   # + stream
        self.replaces = replaces
        self.launches = 0
        self.paths: Dict[str, int] = {}
        self._fn = None

    def _entry(self):
        if self._fn is None:
            fn = getattr(library(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, *args, path: Optional[str] = None) -> None:
        fn = self._entry()
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(*args, stream)
        if status != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with "
                               f"cudaError_t {status}")
        self.launches += 1
        if path is not None:
            self.paths[path] = self.paths.get(path, 0) + 1

    def __repr__(self):
        return f"Kernel({self.name!r}, launches={self.launches})"


KERNELS: List[Kernel] = []


def register(kernel: Kernel) -> Kernel:
    KERNELS.append(kernel)
    return kernel


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
        k.paths.clear()
