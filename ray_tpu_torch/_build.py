"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

At first use every source is compiled by ``nvcc`` for ``sm_90a`` — one
``nvcc -c`` per source, all started together — and the objects are linked
into ``_build/libray_tpu_torch_kernels.so``, which is bound with
``ctypes``.  The kernels expose a plain C interface (no PyTorch headers),
so a build takes seconds.  A stamp of the sources (``*.cu`` and the
``*.cuh`` headers they share) and flags decides when to rebuild, and a
file lock keeps concurrent builders from racing.  Each source's compiler
output, with ptxas's registers, shared memory and spills per kernel, is
kept in ``_build/<source>.log``.

Nothing here runs at import: the CPU tests import every module of the
package on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libray_tpu_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I = ctypes.c_int
_F = ctypes.c_float
_PI = ctypes.POINTER(ctypes.c_int)

# C entry point -> argtypes.  Every pointer and the stream are c_void_p so
# ctypes never cuts them to 32 bits.  Each returns cudaGetLastError().
SIGNATURES: Dict[str, List] = {
    "rtt_layer_norm_fwd": [_P, _I64, _P, _P, _P, _P, _P, _I, _I, _F, _I,
                           _I, _I, _P],
    "rtt_layer_norm_bwd": [_P, _I64, _P, _P, _I64, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _P],
    "rtt_flash_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I64, _I64, _I64, _I64, _I64, _I64,
                                _I64, _I64, _I64, _I64, _I64, _I64,
                                _I, _F, _I, _I, _P],
    "rtt_flash_attention_fwd_occupancy": [_I, _I, _PI, _PI],
    "rtt_flash_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I,
                                _I64, _I64, _I64, _I64, _I64, _I64,
                                _I64, _I64, _I64, _I64, _I64, _I64,
                                _I, _F, _F, _I, _P],
    "rtt_flash_attention_bwd_occupancy": [_I, _PI, _PI],
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
    for s in srcs + sorted(CSRC_DIR.glob("*.cuh")):
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
            procs = [subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for s, o in zip(srcs, objs)]
            failed = []
            for s, p in zip(srcs, procs):
                out, _ = p.communicate()
                (BUILD_DIR / (s.stem + ".log")).write_text(out)
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


_entries: Dict[str, Callable[..., int]] = {}


def entry(name: str) -> Callable[..., int]:
    """One C entry point of the bound library, looked up once."""
    fn = _entries.get(name)
    if fn is None:
        fn = _entries[name] = getattr(lib(), name)
    return fn


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise KernelError(f"{name} failed to launch: cudaError {rc}")


def kernel_resources() -> Dict[str, dict]:
    """Per kernel (mangled name) of the last build, from ptxas's report
    in ``_build/*.log``: registers a thread, static shared memory a
    block, and the bytes of spill stores and loads."""
    out: Dict[str, dict] = {}
    for log in sorted(BUILD_DIR.glob("*.log")):
        cur: Optional[dict] = None
        for line in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                cur = out.setdefault(m.group(1), {})
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                cur["spill_stores"] = int(m.group(1))
                cur["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", line)
                cur["smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


_sass: Dict[int, str] = {}   # the library's mtime -> its SASS listing


def _sass_listing() -> str:
    """``cuobjdump -sass`` of the built library, run once a build."""
    path = BUILD_DIR / LIB_NAME
    stamp = path.stat().st_mtime_ns
    if stamp not in _sass:
        tool = Path(find_nvcc()).parent / "cuobjdump"
        res = subprocess.run([str(tool), "-sass", str(path)],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise KernelError(f"cuobjdump failed: {res.stderr}")
        _sass.clear()
        _sass[stamp] = res.stdout
    return _sass[stamp]


def sass_counts(opcode: str) -> Dict[str, int]:
    """Per kernel (mangled name) of the built library, the SASS
    instructions with this opcode (``cuobjdump -sass``), e.g. ``HMMA``
    for tensor-core products."""
    counts: Dict[str, int] = {}
    cur: Optional[str] = None
    op = re.compile(r"\b" + re.escape(opcode) + r"[.\s]")
    for line in _sass_listing().splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = 0
        elif cur is not None and op.search(line):
            counts[cur] += 1
    return counts
