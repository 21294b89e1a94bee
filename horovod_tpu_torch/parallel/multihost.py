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
    global _initialized_here
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
        _initialized_here = True
        return True


def shutdown() -> None:
    """Destroy the group formed here (a no-op when none was)."""
    global _initialized_here
    with _lock:
        if not _initialized_here:
            return
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
        _initialized_here = False


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
