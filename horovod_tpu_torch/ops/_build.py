"""Build and bind the package's CUDA kernels.

``csrc/flash_attention.cu`` (with the header ``csrc/hopper.cuh``)
compiles at first use into a shared library with a plain C interface
(``nvcc ... -shared``), which is loaded with ``ctypes``.  That route takes
seconds; a source that includes PyTorch's headers takes minutes.  The
library goes to ``horovod_tpu_torch/_build/`` under a name that carries a
hash of every source file under ``csrc/`` and of the flags, so an edit to
any of them rebuilds and an unchanged tree loads at once.  The compiler's
log (``ptxas -v``: registers, shared memory and spills per kernel) is kept
beside the library.

A build failure raises: there is no fallback to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
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

    ``function(name)`` returns the bound C entry; ``path``,
    ``build_seconds`` and ``ptxas_log`` say where the library is, what the
    build took and what ``ptxas`` reported (registers, shared memory and
    spills per kernel)."""

    def __init__(self) -> None:
        self._lib: ctypes.CDLL | None = None
        self.path: Path | None = None
        self.build_seconds = 0.0
        self.ptxas_log = ""

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            t0 = time.perf_counter()
            self.path, self.ptxas_log = build()
            lib = ctypes.CDLL(str(self.path))
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


SOURCE_SUFFIXES = (".cu", ".cuh", ".h")


def library_path(csrc_dir: Path = CSRC_DIR,
                 build_dir: Path = BUILD_DIR) -> Path:
    """Where the library of the sources under ``csrc_dir`` is built: its
    name carries a hash of every source file there (name and bytes) and
    of the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(csrc_dir.rglob("*")):
        if path.suffix in SOURCE_SUFFIXES and path.is_file():
            digest.update(path.relative_to(csrc_dir).as_posix().encode()
                          + b"\0" + path.read_bytes() + b"\0")
    return build_dir / f"{SOURCE.stem}-{digest.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the source unless its library is built; return the library
    path and the compiler's log."""
    target = library_path()
    log_path = target.with_suffix(".log")
    if target.exists():
        return target, log_path.read_text() if log_path.exists() else ""
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
    log_path.write_text(log)
    os.replace(tmp, target)   # atomic: concurrent builds agree
    return target, log


# ---------------------------------------------------------------------------
# What was compiled: ptxas's report and the SASS, per kernel
# ---------------------------------------------------------------------------
# SASS opcodes that show the Hopper design, by what they are.
SASS_GROUPS = {"HGMMA": ("HGMMA",),           # wgmma
               "TMA": ("UTMALDG", "UBLKCP"),  # tensor-map and bulk loads
               "HMMA": ("HMMA",),             # mma.sync
               "SYNCS": ("SYNCS",)}           # mbarrier operations
_MANGLED = re.compile(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)"
                      r"I(13__nv_bfloat16|6__half)Li(\d+)E")
_SASS_OP = re.compile(r"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)")


def kernel_label(mangled: str) -> str:
    """``flash_fwd_kernel<bf16,64>`` for a mangled instance name (the name
    itself when it is not one of the flash kernels)."""
    m = _MANGLED.search(mangled)
    if m is None:
        return mangled
    dtype = "bf16" if "bfloat16" in m.group(2) else "fp16"
    return f"{m.group(1)}<{dtype},{m.group(3)}>"


def ptxas_usage(log: str) -> dict[str, dict[str, int]]:
    """Registers and spill bytes of each kernel in a ``ptxas -v`` log."""
    usage: dict[str, dict[str, int]] = {}
    current = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([^'\s]+)'?", line)
        if m:
            current = usage.setdefault(kernel_label(m.group(1)), {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and current is not None:
            current["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            current["registers"] = int(m.group(1))
    return usage


def sass_counts(sass: str) -> dict[str, dict[str, int]]:
    """Counts of the SASS_GROUPS opcodes in each function of a
    ``cuobjdump -sass`` listing."""
    counts: dict[str, dict[str, int]] = {}
    current = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = counts.setdefault(kernel_label(m.group(1)),
                                        dict.fromkeys(SASS_GROUPS, 0))
            continue
        m = _SASS_OP.match(line)
        if m and current is not None:
            op = m.group(1)
            for group, prefixes in SASS_GROUPS.items():
                if op.startswith(prefixes):
                    current[group] += 1
    return counts


def disassemble(library: Path) -> str:
    """``cuobjdump -sass`` of a built library (the tool beside nvcc)."""
    tool = Path(nvcc_path()).parent / "cuobjdump"
    proc = subprocess.run([str(tool if tool.exists() else "cuobjdump"),
                           "-sass", str(library)],
                          capture_output=True, text=True, check=True)
    return proc.stdout
