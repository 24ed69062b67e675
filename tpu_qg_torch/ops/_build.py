"""Build and load the CUDA kernels of ``tpu_qg_torch/csrc``.

All ``csrc/*.cu`` files are compiled into one shared library with a plain C
interface, ``tpu_qg_torch/_build/libtpu_qg_torch-<hash>.so``, at first use:
one ``nvcc -c`` per source, all started together, then one link. The hash
covers the sources and the flags, so an edited source rebuilds and an
unchanged one loads the library already built. The library is loaded with
``ctypes``; each kernel module declares its entry points' ``argtypes``
(every pointer and the stream as ``c_void_p``).

Each C entry point returns ``cudaGetLastError()`` after its launch, and
``check`` raises on a non-zero code, so a launch the device refuses (too
many threads, too much shared memory) fails where it happened.

``--use_fast_math`` is deliberately absent: it would replace the float32
``sin``/``sinpi`` and division that the twiddles and spectral symbols rest on
with approximations.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class _Library:
    """The loaded kernel library, built at most once per process."""

    def __init__(self):
        self.lib = None
        self.path = None
        self.build_seconds = 0.0
        self.log = ""


_LIB = _Library()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME/bin): the CUDA kernels "
                       "of tpu_qg_torch need the CUDA toolkit to build")


def _sources() -> list[pathlib.Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def load() -> ctypes.CDLL:
    """The kernel library, compiled now if no build of these sources exists."""
    if _LIB.lib is not None:
        return _LIB.lib
    out = BUILD_DIR / f"libtpu_qg_torch-{_source_hash()}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        _LIB.log = _compile(out)
        _LIB.build_seconds = time.perf_counter() - t0
        (BUILD_DIR / f"{out.stem}.log").write_text(_LIB.log)
    _LIB.lib = ctypes.CDLL(str(out))
    _LIB.path = out
    return _LIB.lib


def _compile(out: pathlib.Path) -> str:
    """Compile every .cu source in parallel and link them into ``out``
    (written atomically); returns the compiler's output."""
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in _sources():
        if src.suffix != ".cu":
            continue
        obj = BUILD_DIR / f".{src.stem}.{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    log = "".join(p.communicate()[0] for p in procs)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    try:
        if any(p.returncode for p in procs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *(str(o) for o in objs)],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return log


def build_info() -> dict:
    """Build seconds of this process (0 when a previous build was loaded),
    library path and the compiler's register/shared-memory report."""
    return {"seconds": _LIB.build_seconds, "path": str(_LIB.path),
            "ptxas": _LIB.log}


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def declare(fn, argtypes) -> None:
    """Set a C entry point's argument types (ints as c_int, pointers and the
    stream as c_void_p so that ctypes never truncates them) and its
    cudaError_t return type."""
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
