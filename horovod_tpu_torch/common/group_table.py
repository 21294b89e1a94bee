"""Explicit tensor-group registry for grouped collectives.

The port's copy of ``horovod_tpu/common/group_table.py``.

Reference: horovod/common/group_table.{cc,h}.  A grouped allreduce registers
its member tensor names under one group id; the controller only marks the
group ready when *all* members are ready on *all* ranks, and fuses the group
as a unit (or not at all when group fusion is disabled,
reference: controller.cc:199-223,311-357).
"""
from __future__ import annotations

import threading


class GroupTable:
    def __init__(self) -> None:
        self._mutex = threading.Lock()
        self._next_id = 0
        self._group_ids: dict[str, int] = {}        # tensor name -> group id
        self._groups: dict[int, list[str]] = {}     # group id -> member names

    def register_group(self, tensor_names: list[str]) -> int:
        with self._mutex:
            gid = self._next_id
            self._next_id += 1
            self._groups[gid] = list(tensor_names)
            for name in tensor_names:
                self._group_ids[name] = gid
            return gid

    def get_group_id(self, tensor_name: str) -> int:
        with self._mutex:
            return self._group_ids.get(tensor_name, -1)

    def get_group_tensor_names(self, group_id: int) -> list[str]:
        with self._mutex:
            return list(self._groups.get(group_id, []))

    def deregister_groups(self, finished_names: list[str]) -> None:
        with self._mutex:
            gids = {self._group_ids.get(n, -1) for n in finished_names}
            gids.discard(-1)
            for gid in gids:
                for name in self._groups.pop(gid, []):
                    self._group_ids.pop(name, None)

    def empty(self) -> bool:
        with self._mutex:
            return not self._groups
