"""Build and load the port's CUDA kernels.

Every ``flowstate_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, at first
use, and loaded with ``ctypes``.  The library lands in
``kernels/_build/<hash>/``, keyed by a hash of the sources and the flags,
so an edited source builds anew and an unchanged one is reused.  Nothing
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

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "kernels", "_build")
LIB_NAME = "libflowstate_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class BuildResult:
    """The loaded library, where it lies, the build seconds (0 if it was
    already built) and the compiler's report."""

    def __init__(self, lib: ctypes.CDLL, path: str, seconds: float,
                 log: str):
        self.lib, self.path, self.seconds, self.log = lib, path, seconds, log


_LOADED: BuildResult | None = None


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


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


def _digest(srcs: list) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> BuildResult:
    """Compile (unless already built) and load the kernels' library."""
    global _LOADED
    if _LOADED is not None:
        return _LOADED
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    out_dir = os.path.join(BUILD_DIR, _digest(srcs))
    lib_path = os.path.join(out_dir, LIB_NAME)
    seconds, log = 0.0, ""
    if not os.path.exists(lib_path):
        os.makedirs(out_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *srcs]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")
        os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or none
        with open(os.path.join(out_dir, "build.log"), "w") as f:
            f.write(log)
    _LOADED = BuildResult(ctypes.CDLL(lib_path), lib_path, seconds, log)
    return _LOADED


if __name__ == "__main__":
    res = build()
    print(res.log)
    print(f"built {res.path} in {res.seconds:.1f} s")
