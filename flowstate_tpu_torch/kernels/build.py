"""Build and load the port's CUDA kernels.

Every ``flowstate_tpu_torch/csrc/<name>.cu`` is compiled by its own
``nvcc`` for Hopper (``sm_90a``) into a shared library with a plain C
interface, at first use, and loaded with ``ctypes``.  The compilers of all
sources start together and run in parallel.  Each library lands in
``kernels/_build/<hash>/``, keyed by a hash of its source, the headers
beside it (``csrc/*.cuh``) and the flags, so an edited source or header
builds anew and an unchanged one is reused.  Nothing
is built when this module is imported.

    python -m flowstate_tpu_torch.kernels.build    # build, print ptxas report
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "kernels", "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class BuildResult:
    """The loaded libraries by source name (``"metropolis_moves"`` for
    ``csrc/metropolis_moves.cu``), where they lie, the wall seconds of the
    build (0 if every library was already built) and the compilers'
    reports."""

    def __init__(self, libs: Dict[str, ctypes.CDLL], paths: Dict[str, str],
                 seconds: float, log: str):
        self.libs, self.paths, self.seconds, self.log = (libs, paths, seconds,
                                                         log)


_LOADED: BuildResult | None = None


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def headers() -> list:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME``, ``PATH`` or ``/usr/local/cuda``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built on the machine with the card")


def _name(src: str) -> str:
    return os.path.splitext(os.path.basename(src))[0]


def _library_path(src: str) -> str:
    """Where the library of one source lies once built: keyed by the
    source, every header (a source may include any) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + headers():
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, h.hexdigest()[:16], f"lib{_name(src)}.so")


def build() -> BuildResult:
    """Compile (unless already built) and load every kernel's library."""
    global _LOADED
    if _LOADED is not None:
        return _LOADED
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    paths = {_name(s): _library_path(s) for s in srcs}
    todo = [s for s in srcs if not os.path.exists(paths[_name(s)])]
    nvcc = nvcc_path() if todo else None
    t0 = time.perf_counter()
    jobs = []
    for src in todo:
        path = paths[_name(src)]
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
        jobs.append((path, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for path, tmp, cmd, proc in jobs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}")
            continue
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or none
        with open(os.path.join(os.path.dirname(path), "build.log"), "w") as f:
            f.write(out)
    if failed:
        raise RuntimeError("\n".join(failed))
    seconds = time.perf_counter() - t0 if jobs else 0.0
    _LOADED = BuildResult({name: ctypes.CDLL(p) for name, p in paths.items()},
                          paths, seconds, "".join(logs))
    return _LOADED


if __name__ == "__main__":
    res = build()
    print(res.log)
    for name, path in res.paths.items():
        print(f"{name}: {path}")
    print(f"built in {res.seconds:.1f} s")
