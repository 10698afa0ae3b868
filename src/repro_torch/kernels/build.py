"""Build the CUDA kernels under ``csrc/`` and load them with ``ctypes``.

The sources have a plain C interface (no PyTorch headers), so ``nvcc``
compiles each in seconds.  The library is built on first use into
``build/repro_torch/`` at the root of the checkout, named by a hash of the
sources and flags so an edited source is rebuilt and an unchanged one is
reused.  Each source compiles in its own ``nvcc`` process, all started
together, then one link makes the shared library.

Nothing here runs at import time: this module is imported on machines
without a GPU or a CUDA toolkit, where only the plain versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("pac.cu", "por.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the last build in this process did: seconds, whether it was cached,
# and the compiler's -Xptxas -v report (registers, shared memory, spills)
build_info: Dict[str, object] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libcodec_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: List[List[str]]) -> str:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        logs.append(out)
        if p.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return "".join(logs)


def build() -> Path:
    """Compile and link the kernel library unless it already exists."""
    out = library_path()
    if out.is_file():
        build_info.update(seconds=0.0, cached=True, log="")
        return out
    t0 = time.perf_counter()
    nvcc = nvcc_path()
    tmp_dir = BUILD_DIR / f"tmp-{os.getpid()}"
    tmp_dir.mkdir(parents=True, exist_ok=True)
    try:
        objs = [tmp_dir / (Path(s).stem + ".o") for s in SOURCES]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o",
                         str(o)] for s, o in zip(SOURCES, objs)])
        tmp_lib = tmp_dir / out.name
        log += _run_all([[nvcc, "-shared", "-gencode",
                          "arch=compute_90a,code=sm_90a",
                          *map(str, objs), "-o", str(tmp_lib)]])
        os.replace(tmp_lib, out)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    build_info.update(seconds=time.perf_counter() - t0, cached=False, log=log)
    return out


def _declare(lib: ctypes.CDLL) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.codec_pac.argtypes = ([P, I, P, P, P, P, P, I] + [P] * 7 + [P] * 3
                              + [I] * 8 + [F, P])
    lib.codec_pac.restype = I
    lib.codec_pac_smem_bytes.argtypes = [I, I, I, I]
    lib.codec_pac_smem_bytes.restype = ctypes.c_size_t
    lib.codec_por.argtypes = [P] * 9 + [ctypes.c_longlong, I, P]
    lib.codec_por.restype = I


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
