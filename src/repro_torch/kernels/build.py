"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each source under ``repro_torch/csrc/`` is compiled on first use into
``build/kernels/<name>-<hash>.so`` at the repository root, keyed on a hash
of the source and the compiler flags, so an edited source rebuilds and an
unchanged one is loaded as built. The sources expose a plain C interface
(pointers, sizes and the stream as ``void*``/``int64``) and include no
PyTorch header, which keeps a build to seconds; ``--split-compile=0``
optimises a source's kernel instances on every core (decode_attn's 31 in
18 s, not 39, on the card's machine). Every C entry returns
``cudaGetLastError()`` after its launch; the Python wrappers raise on a
nonzero code.

The first ``load`` that finds its library missing builds every source
whose library is missing, one nvcc process each, all at once: a process
that serves the port needs them all, and in parallel they build in the
time of the slowest.

There is deliberately no fallback: without ``nvcc`` a CUDA tensor cannot
be served, and ``load`` raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME or "
                           "/usr/local/cuda): the port's kernels cannot be "
                           "built")
    return path


def source(name: str) -> Path:
    return CSRC / f"{name}.cu"


def kernel_names() -> list[str]:
    """Every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def lib_path(name: str) -> Path:
    digest = hashlib.sha256(source(name).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names) -> dict[str, str]:
    """Compile every named kernel whose library is missing, one nvcc process
    per source, all started together. Returns each source's compiler log
    (``-Xptxas -v``: registers, shared memory, spills); raises if any
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source(name))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library for ``name``, built on first use (with every
    other missing one, in parallel)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = lib_path(name)
            if not path.exists():
                build(kernel_names())
            lib = _LIBS[name] = ctypes.CDLL(str(path))
        return lib
