"""One port world of more than two ranks at a time, across test processes.

The tier-1 run starts six test processes at once (pytest-xdist,
``--dist loadfile``), beside the JAX package's load-sensitive
multi-rank batteries (``tests/test_fleet.py``'s 4-rank world,
``tests/test_fleetsim.py``).  A port test that starts a world of more
than two ranks holds ``world_lock(ranks)`` while that world runs (a
function that runs one world is decorated ``@world_locked("size")``,
naming its argument that holds the rank count), so at most one such
world runs at a time beside them.  The lock is an ``flock`` on
``tests/.torch_worlds.lock`` (ignored by git), which the kernel frees
when its holder exits.  At two ranks or fewer it does nothing.
"""
from __future__ import annotations

import contextlib
import fcntl
import functools
import inspect
import os

LOCK_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".torch_worlds.lock")


@contextlib.contextmanager
def world_lock(ranks: int):
    """Hold the lock while a world of ``ranks`` ranks (more than two)
    runs; every thread and process takes it in turn."""
    if ranks <= 2:
        yield
        return
    with open(LOCK_FILE, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def world_locked(ranks_arg: str):
    """Decorate a function that runs one world: it holds ``world_lock``
    of its argument ``ranks_arg`` while it runs."""
    def decorate(fn):
        signature = inspect.signature(fn)

        @functools.wraps(fn)
        def run(*args, **kwargs):
            ranks = signature.bind(*args, **kwargs).arguments[ranks_arg]
            with world_lock(ranks):
                return fn(*args, **kwargs)
        return run
    return decorate
