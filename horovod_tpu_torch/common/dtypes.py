"""Canonical dtype table shared by the wire format, controller and backends.

The port's copy of ``horovod_tpu/common/dtypes.py`` with ``torch.dtype`` in
place of numpy's: the ``DataType`` ids are the reference's (they ride the
wire), bfloat16 is ``torch.bfloat16``.  Where numpy must hold a 16-bit
brain float (the socket and mmap views) it is viewed as int16, as
``horovod_tpu/torch/mpi_ops.py`` does; nothing here needs ``ml_dtypes``.
"""
from __future__ import annotations

import enum

import torch


class DataType(enum.IntEnum):
    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    INT32 = 4
    INT64 = 5
    FLOAT16 = 6
    FLOAT32 = 7
    FLOAT64 = 8
    BOOL = 9
    BFLOAT16 = 10


_TORCH_BY_DTYPE: dict[DataType, torch.dtype] = {
    DataType.UINT8: torch.uint8,
    DataType.INT8: torch.int8,
    DataType.UINT16: torch.uint16,
    DataType.INT16: torch.int16,
    DataType.INT32: torch.int32,
    DataType.INT64: torch.int64,
    DataType.FLOAT16: torch.float16,
    DataType.FLOAT32: torch.float32,
    DataType.FLOAT64: torch.float64,
    DataType.BOOL: torch.bool,
    DataType.BFLOAT16: torch.bfloat16,
}
_DTYPE_BY_TORCH = {v: k for k, v in _TORCH_BY_DTYPE.items()}

_FLOATING = {
    DataType.FLOAT16,
    DataType.FLOAT32,
    DataType.FLOAT64,
    DataType.BFLOAT16,
}


def element_size(dt: DataType) -> int:
    return _TORCH_BY_DTYPE[dt].itemsize


def is_floating(dt: DataType) -> bool:
    return dt in _FLOATING


def to_torch(dt: DataType) -> torch.dtype:
    return _TORCH_BY_DTYPE[dt]


def from_any(dtype_like) -> DataType:
    """Map a ``torch.dtype`` to the canonical DataType."""
    dt = _DTYPE_BY_TORCH.get(dtype_like)
    if dt is None:
        raise ValueError(f"Unsupported dtype: {dtype_like!r}")
    return dt
