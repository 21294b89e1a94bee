"""One rank of a gloo world serving with the port's ``ReplicaExecutor``.

    python torch_serve_worker.py RANK WORLD STORE_FILE SPEC.json OUT.json

``SPEC.json`` holds ``cfg`` (``ServeConfig`` keyword arguments),
``prompts``, ``n`` and ``max_new``: the front end (rank 0) submits ``n``
requests cycling through the prompts, and every rank serves until the
front end has drained.  The rank writes to ``OUT.json`` the plans it
executed (each a list of ``[rid, replica]``), its step count, the
streams its replica group generated, and the front's ``offered`` and
``served``.  It imports torch and the port only.
"""
from __future__ import annotations

import datetime
import json
import sys

import torch.distributed as dist

from horovod_tpu_torch.serving import ReplicaExecutor, ServeConfig


def main(rank: int, world: int, store: str, spec_path: str,
         out: str) -> None:
    with open(spec_path) as f:
        spec = json.load(f)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        ex = ReplicaExecutor(ServeConfig(**spec["cfg"]), device="cpu",
                             group=dist.group.WORLD)
        plans, streams = [], {}
        exchange, collect = ex._exchange_plan, ex._collect_completions

        def record_plan(plan):
            plan = exchange(plan)
            plans.append([[a.rid, a.replica] for a in plan.assign])
            return plan

        def record_streams():
            for s in ex.slots:
                if s is not None and s.remaining == 0:
                    streams[s.rid] = list(s.generated)
            collect()
        ex._exchange_plan = record_plan
        ex._collect_completions = record_streams
        if rank == ex.front:
            for i in range(spec["n"]):
                ex.stats["offered"] += 1
                ex.queue.submit(spec["prompts"][i % len(spec["prompts"])],
                                spec["max_new"])
        ex.serve_loop(stop_when=lambda: True)
        with open(out, "w") as f:
            json.dump({"plans": plans, "steps": ex._step,
                       "streams": streams, "offered": ex.stats["offered"],
                       "served": ex.stats["served"]}, f)
        ex.close()
        # The loop's last collective is the front's stop broadcast; let
        # every rank finish it before the group is torn down.
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
