"""The eager world's NCCL group, formed over the rendezvous control plane.

The port's counterpart of ``horovod_tpu/parallel/multihost.py``.  Where
the reference negotiates a JAX coordinator address through the rendezvous
KV store and calls ``jax.distributed.initialize``, rank 0 here opens a
``torch.distributed.TCPStore``, publishes its ``host:port`` under the
same KV, and every rank joins the default ``torch.distributed`` process
group with ``device_id`` its own card (``local_card``), once every rank
has offered a card of its own (``agree_on_cards``): the group the device plane
(``backend/nccl.py``) runs its collectives on, and the one
``parallel.build_mesh`` finds afterwards, as the reference's SPMD step
finds the JAX world.  ``backend="gloo"`` forms the same group on the CPU.
``kv_barrier`` is the reference's barrier over the rendezvous KV (no
collective), across the ranks of the group formed here.

``make_global_batch`` is SPMD and stays out.
"""
from __future__ import annotations

import datetime
import logging
import os
import threading
from typing import Any

import torch

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_initialized_here = False
# (rank, size, kv, epoch) of the group formed here, for kv_barrier.
_world: tuple | None = None
_barrier_seq = 0

_STORE_SCOPE = "ncclstore"
_CARD_SCOPE = "ncclcard"


def is_initialized() -> bool:
    return _initialized_here


def init_process_group(rank: int, size: int, kv: Any,
                       card: int = 0, timeout: float = 120.0,
                       backend: str = "nccl") -> bool:
    """Form the world's process group; returns True if it is formed.

    Rank 0 opens a ``TCPStore`` on a free port and publishes
    ``host:port`` under the ``ncclstore`` scope of the rendezvous KV
    store ``kv``; everyone else waits on that key, and every rank then
    calls ``torch.distributed.init_process_group``, NCCL on
    ``cuda:<card>``.  A world of one forms nothing.
    """
    global _initialized_here, _world, _barrier_seq
    with _lock:
        if _initialized_here or size <= 1:
            return _initialized_here
        import torch.distributed as dist

        epoch = os.environ.get("HOROVOD_RENDEZVOUS_EPOCH", "0")
        key = f"store:{epoch}"
        wait = datetime.timedelta(seconds=timeout)
        if rank == 0:
            from ..runner.network import PeerMesh
            store = dist.TCPStore("0.0.0.0", 0, size, is_master=True,
                                  timeout=wait, wait_for_workers=False)
            host = PeerMesh._advertised_host()
            kv.put(_STORE_SCOPE, key, f"{host}:{store.port}".encode())
        else:
            host, port = kv.wait(_STORE_SCOPE, key, timeout).decode() \
                .rsplit(":", 1)
            store = dist.TCPStore(host, int(port), size, is_master=False,
                                  timeout=wait, wait_for_workers=False)
        kwargs: dict[str, Any] = dict(backend=backend, store=store,
                                      rank=rank, world_size=size,
                                      timeout=wait)
        if backend == "nccl":
            kwargs["device_id"] = torch.device("cuda", card)
        logger.debug("init_process_group rank=%d size=%d backend=%s",
                     rank, size, backend)
        dist.init_process_group(**kwargs)
        _world = (rank, size, kv, epoch)
        # Every member of the (possibly re-formed elastic) world starts
        # the barrier sequence from zero — a survivor carrying its old
        # counter would wait on keys no newcomer ever writes.
        _barrier_seq = 0
        _initialized_here = True
        return True


def shutdown() -> None:
    """Destroy the group formed here (a no-op when none was)."""
    global _initialized_here, _world
    with _lock:
        if not _initialized_here:
            return
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
        _initialized_here = False
        _world = None


def kv_barrier(tag: str, timeout: float = 300.0) -> None:
    """Rendezvous-KV barrier across the world — pure HTTP, NO collective
    (reference: ``horovod_tpu/parallel/multihost.py`` ``kv_barrier``).
    No-op outside a multi-process world.

    SYMMETRIC-CALL CONTRACT: every rank must call kv_barrier the same
    number of times, in the same order — keys are derived from an
    implicit per-process sequence counter, so an asymmetric extra call
    on one rank permanently misaligns every later barrier.  A timeout
    therefore means ONE of two distinct faults, and the raised error
    carries enough state (rank/tag/seq/waited-on key) to tell them
    apart: a dead or wedged peer (its key for THIS seq never appears),
    or a seq mismatch (the peer is alive but publishing under a
    different sequence number)."""
    global _barrier_seq
    if not _initialized_here or _world is None:
        return
    rank, size, kv, epoch = _world
    if kv is None or size <= 1:
        return
    with _lock:
        _barrier_seq += 1
        seq = _barrier_seq
    key = f"{epoch}:{tag}:{seq}"
    kv.put("barrier", f"{key}:{rank}", b"1")
    for r in range(size):
        try:
            kv.wait("barrier", f"{key}:{r}", timeout)
        except TimeoutError as exc:
            raise TimeoutError(
                _barrier_timeout_diagnosis(kv, key, rank, size, tag, seq,
                                           timeout)) from exc


def _barrier_timeout_diagnosis(kv, key: str, rank: int, size: int,
                               tag: str, seq: int,
                               timeout: float) -> str:
    """Name WHICH ranks are missing from the barrier (one probe per
    rank), cross-checked against the resilience liveness table when
    fault tolerance is on."""
    missing: list[int] = []
    for r in range(size):
        try:
            if kv.get("barrier", f"{key}:{r}") is None:
                missing.append(r)
        except Exception:  # noqa: BLE001 - KV gone: report what we know
            missing.append(r)
    dead: list[int] = []
    try:
        from ..resilience import active_state
        state = active_state()
        if state is not None:
            dead = sorted(set(missing) & state.failed_ranks())
    except Exception:  # noqa: BLE001 - diagnosis must never mask the timeout
        pass
    verdict = (f"rank(s) {dead} are DEAD/unreachable per the liveness "
               f"table — elastic recovery or HOROVOD_ON_FAILURE applies."
               if dead else
               "all missing ranks still heartbeat (or fault tolerance is "
               "off): either they are wedged/slow, or the barrier "
               "sequence numbers have diverged — every rank must call "
               "kv_barrier symmetrically (same count, same order).")
    return (f"kv_barrier timeout: rank {rank}/{size} waited {timeout}s on "
            f"tag={tag!r} seq={seq}; missing ranks: "
            f"{missing or '<none — raced to completion>'} "
            f"(keys barrier/{key}:<r>). {verdict}")


def local_card(local_rank: int) -> int | None:
    """The card this rank would run the plane on, None without CUDA:
    ``cuda:<local_rank>`` among the cards the process sees, wrapping
    when it sees fewer (a launcher that shows each process only its own
    card gives every rank ``cuda:0``)."""
    if not torch.cuda.is_available():
        return None
    return local_rank % torch.cuda.device_count()


def _card_identity(index: int) -> str:
    """A name of the physical card that two processes agree on whatever
    each one's ``CUDA_VISIBLE_DEVICES``: its UUID."""
    return str(torch.cuda.get_device_properties(index).uuid)


def should_init(size: int, local_rank: int = 0) -> bool:
    """Whether this rank offers the plane in a world of ``size`` ranks
    under ``HOROVOD_NCCL_OPERATIONS``: never at 0 or in a world of one,
    otherwise when this process sees a CUDA card and NCCL.  Whether the
    plane forms is up to every rank (``agree_on_cards``), and with the
    knob at 1 a plane that does not form raises on every rank."""
    from ..common import config
    mode = config.parse_tristate(config.NCCL_OPERATIONS.get())
    if mode is False or size <= 1:
        return False
    import torch.distributed as dist
    return local_card(local_rank) is not None and dist.is_available() \
        and dist.is_nccl_available()


def agree_on_cards(rank: int, size: int, kv: Any, card: int | None,
                   timeout: float = 120.0) -> str | None:
    """Every rank publishes the card it offers (``card`` None: none)
    under the rendezvous KV and reads everyone's.  The plane forms only
    when every rank offers a card and no two offer the same physical
    one (NCCL refuses two ranks on one card): None then, and otherwise
    the reason it does not form, the same on every rank.  A world on
    fewer cards than ranks thus keeps the TCP and shm planes for its
    CPU tensors, as the reference's XLA plane falls through to TCP when
    its world does not span the ranks."""
    epoch = os.environ.get("HOROVOD_RENDEZVOUS_EPOCH", "0")
    mine = "" if card is None else _card_identity(card)
    kv.put(_CARD_SCOPE, f"{epoch}:{rank}", mine.encode())
    cards = [kv.wait(_CARD_SCOPE, f"{epoch}:{r}", timeout).decode()
             for r in range(size)]
    lacking = [r for r, c in enumerate(cards) if not c]
    if lacking:
        return f"rank(s) {lacking} offer no CUDA card with NCCL"
    shared = [r for r, c in enumerate(cards) if cards.count(c) > 1]
    if shared:
        return f"rank(s) {shared} share a card; NCCL needs one per rank"
    return None
