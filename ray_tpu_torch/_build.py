"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

At first use every source is compiled by ``nvcc`` for ``sm_90a`` — one
``nvcc -c`` per source, all started together — and the objects are linked
into ``_build/libray_tpu_torch_kernels.so``, which is bound with
``ctypes``.  The kernels expose a plain C interface (no PyTorch headers),
so a build takes seconds.  A stamp of the sources and flags decides when
to rebuild, and a file lock keeps concurrent builders from racing.

Nothing here runs at import: the CPU tests import every module of the
package on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libray_tpu_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I = ctypes.c_int
_F = ctypes.c_float

# C entry point -> argtypes.  Every pointer and the stream are c_void_p so
# ctypes never cuts them to 32 bits.  Each returns cudaGetLastError().
SIGNATURES: Dict[str, List] = {
    "rtt_layer_norm_fwd": [_P, _I64, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P],
    "rtt_flash_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I64, _I64, _I64, _I64, _I64, _I64,
                                _I64, _I64, _I64, _I64, _I64, _I64,
                                _I, _F, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


class KernelError(RuntimeError):
    """A kernel failed to build or to launch."""


def find_nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(env)
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")   # the toolkit's default
    if default.exists():
        return str(default)
    raise KernelError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _stamp(srcs: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless the stamp of
    the current sources matches the last build.  Returns its path."""
    srcs = sources()
    BUILD_DIR.mkdir(exist_ok=True)
    lib_path = BUILD_DIR / LIB_NAME
    stamp_path = BUILD_DIR / "stamp"
    want = _stamp(srcs)
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib_path.exists() and stamp_path.exists() \
                    and stamp_path.read_text() == want:
                return lib_path
            nvcc = find_nvcc()
            objs = [BUILD_DIR / (s.stem + ".o") for s in srcs]
            extra = ["-Xptxas", "-v"] if verbose else []
            procs = [subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *extra, "-c", str(s), "-o", str(o)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for s, o in zip(srcs, objs)]
            failed = []
            for s, p in zip(srcs, procs):
                out, _ = p.communicate()
                if verbose and out:
                    print(out, flush=True)
                if p.returncode != 0:
                    failed.append(f"{s.name}:\n{out}")
            if failed:
                raise KernelError("nvcc failed:\n" + "\n".join(failed))
            tmp = BUILD_DIR / (LIB_NAME + ".tmp")
            link = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o",
                 str(tmp)], capture_output=True, text=True)
            if link.returncode != 0:
                raise KernelError("nvcc link failed:\n" + link.stdout
                                  + link.stderr)
            os.replace(tmp, lib_path)
            stamp_path.write_text(want)
            return lib_path
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def lib() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            cdll = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(cdll, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = cdll
        return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise KernelError(f"{name} failed to launch: cudaError {rc}")
