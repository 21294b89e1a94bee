"""Build and bind the package's CUDA kernels.

The one source, ``csrc/flash_attention.cu``, compiles at first use into a
shared library with a plain C interface (``nvcc ... -shared``), which is
loaded with ``ctypes``.  That route takes seconds; a source that includes
PyTorch's headers takes minutes.  The library goes to
``horovod_tpu_torch/_build/`` under a name that carries a hash of the
source and the flags, so an edited source rebuilds and an unchanged one
loads at once.

A build failure raises: there is no fallback to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
SOURCE = CSRC_DIR / "flash_attention.cu"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of every exported entry: (argtypes, restype).
SIGNATURES = {
    "hvd_flash_fwd": ([_P] * 5 + [_I] * 5 + [_F, _I, _P], _I),
    "hvd_flash_bwd_dq": ([_P] * 7 + [_I] * 5 + [_F, _I, _P], _I),
    "hvd_flash_bwd_dkv": ([_P] * 8 + [_I] * 5 + [_F, _I, _P], _I),
    "hvd_cuda_error_string": ([_I], ctypes.c_char_p),
}


class KernelLibrary:
    """The built kernel library of this checkout, loaded once.

    ``function(name)`` returns the bound C entry; ``build_seconds`` and
    ``ptxas_log`` say what the build took and what ``ptxas`` reported
    (registers, shared memory and spills per kernel)."""

    def __init__(self) -> None:
        self._lib: ctypes.CDLL | None = None
        self.build_seconds = 0.0
        self.ptxas_log = ""

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            t0 = time.perf_counter()
            path, self.ptxas_log = build()
            lib = ctypes.CDLL(str(path))
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            self.build_seconds = time.perf_counter() - t0
            self._lib = lib
        return self._lib

    def function(self, name: str):
        return getattr(self.load(), name)

    def error_string(self, err: int) -> str:
        return self.function("hvd_cuda_error_string")(err).decode()


LIBRARY = KernelLibrary()


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of "
        "horovod_tpu_torch are built from source at first use")


def _library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{source.stem}-{digest[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the source unless its library is built; return the library
    path and the compiler's log (empty when nothing was compiled)."""
    target = _library_path(SOURCE)
    if target.exists():
        return target, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC_DIR),
                           "-o", tmp, str(SOURCE)],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{log}")
    os.replace(tmp, target)   # atomic: concurrent builds agree
    return target, log
