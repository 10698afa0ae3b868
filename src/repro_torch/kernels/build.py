"""Build the CUDA kernels under ``csrc/`` and load them with ``ctypes``.

The sources have a plain C interface (no PyTorch headers), so ``nvcc``
compiles each in seconds.  The library is built on first use into
``build/repro_torch/`` at the root of the checkout, named by a hash of
every file under ``csrc/`` (sources and headers) and the flags, so an
edited source or header is rebuilt and an unchanged one is reused.  Each
source compiles in its own ``nvcc`` process, all started together, then
one link makes the shared library.

Nothing here runs at import time: this module is imported on machines
without a GPU or a CUDA toolkit, where only the plain versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("pac.cu", "por.cu", "flash_decode.cu")
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


def library_path(csrc: Path = CSRC) -> Path:
    """The library's path, named by a hash of every file under ``csrc``
    (the sources and the headers they include) and the flags."""
    h = hashlib.sha256()
    for path in sorted(p for p in csrc.iterdir() if p.is_file()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
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


def build(csrc: Path = CSRC) -> Path:
    """Compile and link the kernel library from ``SOURCES`` in ``csrc``
    (the package's own by default; a changed copy for an A/B build) unless
    it already exists."""
    out = library_path(csrc)
    if out.is_file():
        build_info.update(seconds=0.0, cached=True, log="")
        return out
    t0 = time.perf_counter()
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp_dir = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_DIR))
    try:
        objs = [tmp_dir / (Path(s).stem + ".o") for s in SOURCES]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(csrc / s), "-o",
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


def open_library(path: Path) -> ctypes.CDLL:
    """A built kernel library, loaded, its entry points declared."""
    lib = ctypes.CDLL(str(path))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.codec_pac.argtypes = ([P, I, P, P, P, P, P, I] + [P] * 7 + [P] * 3
                              + [I] * 8 + [F, P])
    lib.codec_pac.restype = I
    lib.codec_pac_smem_bytes.argtypes = [I, I]
    lib.codec_pac_smem_bytes.restype = ctypes.c_size_t
    lib.codec_pac_blocks_per_sm.argtypes = [I, I]
    lib.codec_pac_blocks_per_sm.restype = I
    lib.codec_por.argtypes = [P] * 9 + [ctypes.c_longlong, I, P]
    lib.codec_por.restype = I
    lib.codec_por_epilogue.argtypes = ([P, I] + [P] * 7 + [I] + [P] * 5
                                       + [I] + [P] * 2 + [I] * 7 + [F, P])
    lib.codec_por_epilogue.restype = I
    lib.codec_mesh_merge.argtypes = [P] * 7 + [I] + [P] * 2 + [I] * 6 + [P]
    lib.codec_mesh_merge.restype = I
    lib.codec_flash_decode.argtypes = ([P, I, P, P, I] + [P] * 5 + [I] * 7
                                       + [F, P])
    lib.codec_flash_decode.restype = I
    lib.codec_flash_decode_chunk.argtypes = [I, I]
    lib.codec_flash_decode_chunk.restype = I
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = open_library(build())
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
