"""Native (C++) host kernels of the eager core, loaded via ctypes.

The port's copy of ``horovod_tpu/native/__init__.py``: ``kernels.cc`` (a
copy of the reference's, whole) holds fusion-buffer pack/unpack, buffer
scaling, the ring allreduce over socket fds, the blockwise quantizer's
encode/decode and the Adasum helpers.  It is compiled once per source
digest and CPU with ``g++ -O3 -march=native -ffp-contract=off`` into
``horovod_tpu_torch/_build/`` at first use.

**This differs from the reference on purpose.**  The reference returns
``None`` when the build or load fails and every caller quietly takes its
numpy path.  Here a failed build raises ``RuntimeError`` with the
compiler's stderr.  Each entry point also has a plain version in torch,
and it runs only when ``HOROVOD_TPU_DISABLE_NATIVE=1`` is set: the tests
set it to hold each kernel against its plain version, and nothing else
does.  ``ring_allreduce`` returns False for a dtype the kernel does not
cover (anything but float32/64 and int32/64 accumulators); the TCP
plane's Python ring then runs, as in the reference.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
import time

import torch

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "kernels.cc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC",
         "-std=c++17", "-pthread"]
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# Seconds the g++ build took in this process (0.0 when the library was
# already built).
build_seconds = 0.0
# Calls of each entry point that ran the native kernel in this process
# (the plain versions do not count).
calls: dict[str, int] = {}

_DTYPE_CODES = {
    torch.float32: 0,
    torch.float64: 1,
    torch.int32: 2,
    torch.int64: 3,
}


def disabled() -> bool:
    """True when HOROVOD_TPU_DISABLE_NATIVE asks for the plain versions."""
    return os.environ.get("HOROVOD_TPU_DISABLE_NATIVE", "") in ("1", "true")


def cpu_tag() -> str:
    """CPU-generation fingerprint: -march=native code must never be loaded
    on a different microarchitecture."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags")):
                    return hashlib.sha256(line.encode()).hexdigest()[:8]
    except OSError:
        pass
    return hashlib.sha256(platform.processor().encode()).hexdigest()[:8]


def library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode()) \
            .hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"hvd_native_{digest}_{cpu_tag()}.so")


def _build() -> str:
    global build_seconds
    so_path = library_path()
    if os.path.exists(so_path):
        return so_path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *FLAGS, _SRC, "-o", tmp]
    t0 = time.monotonic()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as exc:
        os.unlink(tmp)
        raise RuntimeError(f"native kernels: {' '.join(cmd)} did not run: "
                           f"{exc}") from exc
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"native kernels: {' '.join(cmd)} failed "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so_path)   # atomic: concurrent builds race safely
    build_seconds = time.monotonic() - t0
    return so_path


def load() -> ctypes.CDLL:
    """Build (once) and load the library; raises when either fails."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build())
        lib.hvd_abi_version.restype = ctypes.c_int32
        if lib.hvd_abi_version() != 1:
            raise RuntimeError("native kernels: ABI version mismatch")
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
        lib.hvd_pack.argtypes = [ctypes.POINTER(vp), ctypes.POINTER(i64),
                                 i32, vp]
        lib.hvd_unpack.argtypes = [vp, ctypes.POINTER(i64), i32,
                                   ctypes.POINTER(vp)]
        lib.hvd_ring_allreduce.argtypes = [i32, i32, vp, i64, i32, i32,
                                           i32]
        lib.hvd_ring_allreduce.restype = i32
        lib.hvd_scale_f32.argtypes = [vp, i64, ctypes.c_float]
        lib.hvd_scale_f64.argtypes = [vp, i64, ctypes.c_double]
        lib.hvd_qencode.argtypes = [vp, i64, i32, i32, i32, vp]
        lib.hvd_qencode.restype = i32
        lib.hvd_qdecode.argtypes = [vp, i64, i32, i32, vp, i32]
        lib.hvd_qdecode.restype = i32
        lib.hvd_dot_norms_f64.argtypes = [vp, vp, i64, vp]
        lib.hvd_scaled_add_f64.argtypes = [vp, vp, i64, ctypes.c_double,
                                           ctypes.c_double]
        _lib = lib
        return lib


def loaded() -> bool:
    """True once the native library is loaded in this process."""
    return _lib is not None


def _native() -> ctypes.CDLL | None:
    return None if disabled() else load()


def _cpu_contiguous(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cpu" or not t.is_contiguous():
            raise ValueError("native kernels take contiguous CPU tensors")


# ---------------------------------------------------------------------------
# Entry points; each one's plain version is the branch under ``lib is None``.
# ---------------------------------------------------------------------------
def pack(parts: list[torch.Tensor | None], sizes: list[int],
         out: torch.Tensor) -> torch.Tensor:
    """Concatenate flattened tensors (None → zeros) into ``out``, the
    persistent staging buffer (reference: fusion_buffer_manager.cc)."""
    if out.numel() != sum(sizes):
        raise ValueError(f"pack: out holds {out.numel()} elements, the "
                         f"parts {sum(sizes)}")
    for p, sz in zip(parts, sizes):
        if p is not None and (p.numel() != sz or p.dtype != out.dtype):
            raise ValueError("pack: a part disagrees with its size or dtype")
    lib = _native()
    if lib is None:
        offset = 0
        for p, sz in zip(parts, sizes):
            view = out[offset:offset + sz]
            if p is None:
                view.zero_()
            else:
                view.copy_(p.reshape(-1))
            offset += sz
        return out
    _cpu_contiguous(out, *(p for p in parts if p is not None))
    n = len(parts)
    src_ptrs = (ctypes.c_void_p * n)()
    nbytes = (ctypes.c_int64 * n)()
    for i, (p, sz) in enumerate(zip(parts, sizes)):
        nbytes[i] = sz * out.element_size()
        src_ptrs[i] = None if p is None else p.data_ptr()
    calls["pack"] = calls.get("pack", 0) + 1
    lib.hvd_pack(src_ptrs, nbytes, n, out.data_ptr())
    return out


def unpack(src: torch.Tensor, outs: list[torch.Tensor]) -> None:
    """Split the flat ``src`` into ``outs`` in order (the inverse of
    pack)."""
    if sum(o.numel() for o in outs) != src.numel() or \
            any(o.dtype != src.dtype for o in outs):
        raise ValueError("unpack: the outputs do not tile the source")
    lib = _native()
    if lib is None:
        offset = 0
        for o in outs:
            o.view(-1).copy_(src[offset:offset + o.numel()])
            offset += o.numel()
        return
    _cpu_contiguous(src, *outs)
    n = len(outs)
    dst_ptrs = (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs])
    nbytes = (ctypes.c_int64 * n)(*[o.numel() * o.element_size()
                                    for o in outs])
    calls["unpack"] = calls.get("unpack", 0) + 1
    lib.hvd_unpack(src.data_ptr(), nbytes, n, dst_ptrs)


def scale_(buf: torch.Tensor, factor: float) -> torch.Tensor:
    """In-place ``buf *= factor`` for float32 (factor rounded to float32)
    and float64 buffers."""
    if buf.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"scale_: float32 or float64, not {buf.dtype}")
    lib = _native()
    if lib is None:
        return buf.mul_(factor)
    _cpu_contiguous(buf)
    fn = lib.hvd_scale_f32 if buf.dtype == torch.float32 \
        else lib.hvd_scale_f64
    calls["scale_"] = calls.get("scale_", 0) + 1
    fn(buf.data_ptr(), buf.numel(), factor)
    return buf


def ring_allreduce(send_fd: int, recv_fd: int, buf: torch.Tensor,
                   rank: int, size: int) -> bool:
    """In-place sum ring allreduce over raw socket fds, with the TCP
    plane's schedule.  Returns False when the native path does not cover
    this call (the plain version is the Python ring of backend/tcp.py)."""
    code = _DTYPE_CODES.get(buf.dtype)
    if code is None or not buf.is_contiguous():
        return False
    lib = _native()
    if lib is None:
        return False
    calls["ring_allreduce"] = calls.get("ring_allreduce", 0) + 1
    rc = lib.hvd_ring_allreduce(send_fd, recv_fd, buf.data_ptr(),
                                buf.numel(), code, rank, size)
    if rc == -1:
        raise ConnectionError("native ring allreduce: peer socket failed")
    return rc == 0


def _nblocks(n: int, block_size: int) -> int:
    return (n + block_size - 1) // block_size


def wire_nbytes(n: int, block_size: int, pack4: bool) -> int:
    """Bytes of a quantized wire image: scales || zero points || payload."""
    return _nblocks(n, block_size) * 8 + ((n + 1) // 2 if pack4 else n)


def qencode(x: torch.Tensor, block_size: int, levels: int, pack4: bool,
            wire: torch.Tensor) -> torch.Tensor:
    """Blockwise affine quantize of contiguous fp32 ``x`` into the uint8
    wire image ``scales || zero_points || payload`` (the layout of the
    reference's compress/quantize.py, byte for byte)."""
    n = x.numel()
    if x.dtype != torch.float32 or wire.dtype != torch.uint8 or \
            wire.numel() < wire_nbytes(n, block_size, pack4):
        raise ValueError("qencode: fp32 input and a large enough uint8 wire")
    lib = _native()
    if lib is None:
        if n == 0:
            return wire
        nb = _nblocks(n, block_size)
        flat = x.reshape(-1)
        pad = nb * block_size - n
        if pad:
            flat = torch.cat([flat, flat[-1:].expand(pad)])
        blocks = flat.reshape(nb, block_size)
        lo = blocks.amin(dim=1)
        hi = blocks.amax(dim=1)
        scales = (hi - lo) / torch.tensor(levels - 1, dtype=torch.float32)
        scales = torch.where(scales > 0, scales, torch.ones_like(scales))
        q = torch.round((blocks - lo[:, None]) / scales[:, None])
        q = q.clamp(0, levels - 1).to(torch.uint8).reshape(-1)[:n]
        if pack4:
            if n % 2:
                q = torch.cat([q, q.new_zeros(1)])
            q = (q[0::2] << 4) | q[1::2]
        wire[:nb * 4] = scales.view(torch.uint8)
        wire[nb * 4:nb * 8] = lo.view(torch.uint8)
        wire[nb * 8:nb * 8 + q.numel()] = q
        return wire
    _cpu_contiguous(x, wire)
    calls["qencode"] = calls.get("qencode", 0) + 1
    lib.hvd_qencode(x.data_ptr(), n, block_size, levels, int(pack4),
                    wire.data_ptr())
    return wire


def qdecode(wire: torch.Tensor, n: int, block_size: int, pack4: bool,
            dst: torch.Tensor, accumulate: bool) -> torch.Tensor:
    """Dequantize a wire image into contiguous fp32 ``dst`` (``q·scale +
    zero_point``, rounded after the multiply and after the add); with
    ``accumulate`` the values are added into ``dst``."""
    if dst.dtype != torch.float32 or dst.numel() < n:
        raise ValueError("qdecode: an fp32 destination of n elements")
    lib = _native()
    if lib is None:
        if n == 0:
            return dst
        nb = _nblocks(n, block_size)
        raw = wire.reshape(-1)
        scales = raw[:nb * 4].clone().view(torch.float32)
        zps = raw[nb * 4:nb * 8].clone().view(torch.float32)
        pl = raw[nb * 8:]
        if pack4:
            q = torch.stack([pl >> 4, pl & 0x0F], dim=1).reshape(-1)[:n]
        else:
            q = pl[:n]
        blk = torch.arange(n) // block_size
        v = q.to(torch.float32) * scales[blk]
        v = v + zps[blk]
        if accumulate:
            dst[:n] += v
        else:
            dst[:n] = v
        return dst
    _cpu_contiguous(wire, dst)
    calls["qdecode"] = calls.get("qdecode", 0) + 1
    lib.hvd_qdecode(wire.data_ptr(), n, block_size, int(pack4),
                    dst.data_ptr(), int(accumulate))
    return dst


def dot_norms(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float,
                                                          float]:
    """(a·b, |a|², |b|²) of two float64 vectors, summed in index order
    (the Adasum statistics)."""
    if a.dtype != torch.float64 or b.dtype != torch.float64:
        raise ValueError("dot_norms: float64 vectors")
    lib = _native()
    if lib is None:
        dot = na = nb = 0.0
        for x, y in zip(a.tolist(), b.tolist()):
            dot += x * y
            na += x * x
            nb += y * y
        return dot, na, nb
    _cpu_contiguous(a, b)
    out = torch.empty(3, dtype=torch.float64)
    calls["dot_norms"] = calls.get("dot_norms", 0) + 1
    lib.hvd_dot_norms_f64(a.data_ptr(), b.data_ptr(), a.numel(),
                          out.data_ptr())
    return tuple(out.tolist())


def scaled_add_(a: torch.Tensor, b: torch.Tensor, ca: float,
                cb: float) -> torch.Tensor:
    """In-place ``a = ca·a + cb·b`` on float64 vectors (the Adasum
    combine)."""
    if a.dtype != torch.float64 or b.dtype != torch.float64:
        raise ValueError("scaled_add_: float64 vectors")
    lib = _native()
    if lib is None:
        return a.copy_(a * ca + b * cb)
    _cpu_contiguous(a, b)
    calls["scaled_add_"] = calls.get("scaled_add_", 0) + 1
    lib.hvd_scaled_add_f64(a.data_ptr(), b.data_ptr(), a.numel(), ca, cb)
    return a
