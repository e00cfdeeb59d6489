"""Build the CUDA kernels of ``csrc/`` at first use and load them with ctypes.

Every ``csrc/<name>.cu`` becomes ``build/kernels/<key>/<name>.so`` under the
repository root, compiled by ``nvcc`` with a plain C interface (no PyTorch
headers, so a build takes seconds). ``<key>`` is a hash of every source and
header in ``csrc/`` and of the flags, so an edited source builds anew and an
unchanged one is loaded from the last build. All missing libraries are
compiled at once, one ``nvcc`` process per source.

No ``--use_fast_math``: it swaps ``cosf``, ``sinf`` and ``logf`` for the
``__`` intrinsics, whose error grows with the argument, and Griewank's
arguments reach 600.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME to build the "
                           "kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_all() -> dict:
    """Compile every source whose library is missing, all in parallel.

    Returns ``{"seconds": wall time, "built": [names], "log": {name: the
    compiler's report, registers and spills included}}``. Raises with the
    compiler's output if any source fails.
    """
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = {}
    for src in sources():
        lib = out / f"{src.stem}.so"
        if lib.exists():
            continue
        tmp = out / f"{src.stem}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        jobs[src.stem] = (tmp, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    log, failed = {}, []
    for name, (tmp, lib, proc) in jobs.items():
        log[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            continue
        (out / f"{name}.log").write_text(log[name])
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(log[n] for n in failed))
    return {"seconds": time.perf_counter() - t0, "built": sorted(jobs),
            "log": log}


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, building first if needed."""
    with _lock:
        if name not in _libs:
            lib = build_dir() / f"{name}.so"
            if not lib.exists():
                build_all()
            _libs[name] = ctypes.CDLL(str(lib))
        return _libs[name]


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code other than 0."""
    if code != 0:
        lib.kernel_error_string.restype = ctypes.c_char_p
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
