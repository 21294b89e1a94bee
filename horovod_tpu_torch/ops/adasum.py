"""Adasum: scale-insensitive gradient reduction on the host planes.

The port's copy of ``horovod_tpu/ops/adasum.py`` (``adasum_combine``,
``_group_scalar_allreduce``, ``adasum_tcp``, ``adasum_reference``); the
arithmetic is numpy float64, as the reference's, so the TCP plane's
results are its bits.

Recursive vector-halving distance-doubling (VHDD; upstream
horovod/common/ops/adasum/adasum.h): at each level ranks pair up
(partner = rank XOR distance), split their fragment in half, exchange the
half they do not keep, compute the pairwise dot products, sum those dots
over the aligned 2·distance rank group, and combine with

    a' = a·(1 − ab/(2·aa)) + b·(1 − ab/(2·bb))

which orthogonalises the pair of gradients instead of summing them.  After
the down-sweep each rank holds the combined result for its fragment; the
reverse sweep reassembles the full vector.  ``backend/nccl.py`` runs the
same schedule on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from ..backend.base import cast


def adasum_combine(a: np.ndarray, b: np.ndarray,
                   aa: float, bb: float, ab: float) -> np.ndarray:
    """Combine fragments a,b given *global* dot products aa=‖a‖², bb=‖b‖²,
    ab=a·b (upstream adasum.h ComputeDotAndNormSqrds + ScaledAdd)."""
    if aa == 0.0 and bb == 0.0:
        return a + b
    acoef = 1.0 if aa == 0.0 else 1.0 - ab / (2.0 * aa)
    bcoef = 1.0 if bb == 0.0 else 1.0 - ab / (2.0 * bb)
    return acoef * a + bcoef * b


def is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _group_scalar_allreduce(coll, values: np.ndarray,
                            group_bits: int) -> np.ndarray:
    """Sum small fp64 vectors over the aligned 2^group_bits rank group by
    recursive doubling."""
    acc = values.astype(np.float64, copy=True)
    for j in range(group_bits):
        peer = coll.rank ^ (1 << j)
        data = coll._sendrecv(peer, acc.tobytes(), peer)
        acc += np.frombuffer(data, dtype=np.float64)
    return acc


def adasum_tcp(coll, buf: torch.Tensor) -> torch.Tensor:
    """Adasum allreduce of a flat host tensor over the TCP PeerMesh, in
    float64, returned in ``buf``'s dtype.  Needs a power-of-2 world (the
    VHDD pairing)."""
    size, rank = coll.size, coll.rank
    if size == 1:
        return buf
    if not is_pow2(size):
        raise ValueError(
            f"Adasum requires a power-of-2 world size, got {size}")

    frag = buf.double().numpy().copy()
    path: list[tuple[int, bool, int]] = []   # (partner, kept_first, my_len)

    distance = 1
    level = 0
    while distance < size:
        partner = rank ^ distance
        n = frag.size
        mid = n // 2
        kept_first = rank < partner
        keep = frag[:mid] if kept_first else frag[mid:]
        give = frag[mid:] if kept_first else frag[:mid]
        data = coll._sendrecv(partner, give.tobytes(), partner)
        partner_frag = np.frombuffer(data, dtype=np.float64)

        # One vector identity across the pair: `a` is the vector held by
        # the lower half of the group (bit `level` clear), `b` by the
        # upper half.
        a_frag, b_frag = (keep, partner_frag) if kept_first \
            else (partner_frag, keep)
        dots = np.array([a_frag @ a_frag, b_frag @ b_frag, a_frag @ b_frag],
                        dtype=np.float64)
        # The dots cover the whole vectors being combined, whose
        # fragments are spread over the aligned 2·distance rank group.
        dots = _group_scalar_allreduce(coll, dots, level + 1)
        aa, bb, ab = dots
        frag = adasum_combine(a_frag, b_frag, aa, bb, ab)
        path.append((partner, kept_first, frag.size))
        distance <<= 1
        level += 1

    # Reverse sweep: reassemble the full combined vector.
    for partner, kept_first, _ in reversed(path):
        data = coll._sendrecv(partner, frag.tobytes(), partner)
        other = np.frombuffer(data, dtype=np.float64)
        frag = np.concatenate([frag, other] if kept_first else [other, frag])

    return cast(torch.from_numpy(frag), buf.dtype)


def adasum_reference(tensors: list[np.ndarray]) -> np.ndarray:
    """Serial n-way Adasum for test oracles: combine in the same pairwise
    tree order VHDD uses ((0,1),(2,3)) → ((01),(23)) → ..."""
    vals = [np.asarray(t, dtype=np.float64).reshape(-1) for t in tensors]
    while len(vals) > 1:
        nxt = []
        for i in range(0, len(vals), 2):
            a, b = vals[i], vals[i + 1]
            nxt.append(adasum_combine(a, b, float(a @ a), float(b @ b),
                                      float(a @ b)))
        vals = nxt
    return vals[0].reshape(np.asarray(tensors[0]).shape)
