"""One rank of a port eager world serving with ``ReplicaExecutor``.

    python torch_serve_worker.py RANK WORLD RENDEZVOUS_PORT SPEC.json OUT.json

``SPEC.json`` holds ``cfg`` (``ServeConfig`` keyword arguments),
``prompts``, ``n``, ``max_new`` and ``env`` (extra ``HOROVOD_*``
settings: fault tolerance and chaos for the kill case): the rank calls
``hvd.init()`` against the port's rendezvous server, the front end (rank
0) submits ``n`` requests cycling through the prompts, and every rank
serves until the front end has drained.  The rank writes to ``OUT.json``
the plans it executed (each a list of ``[rid, replica]``) and the
generation each plan exchange ran under (``serve.plan.g<gen>``), its step
count, the streams its replica group generated, the front's ``offered``,
``served``, ``lost`` and ``expired``, the shrinks its loop rode, and the
``RanksFailedError`` that ended its loop, if one did (failed ranks, op,
phase and seconds from the last completed exchange to the error).  It
imports torch and the port only.
"""
from __future__ import annotations

import json
import os
import sys
import time

import torch


def main(rank: int, world: int, port: int, spec_path: str,
         out: str) -> None:
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(world),
                      HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
                      HOROVOD_GLOO_RENDEZVOUS_PORT=str(port),
                      HOROVOD_RENDEZVOUS_EPOCH=spec.get("epoch", "serve"),
                      **spec.get("env", {}))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.serving import ReplicaExecutor, ServeConfig
    hvd.init()
    try:
        ex = ReplicaExecutor(ServeConfig(**spec["cfg"]), device="cpu")
        plans, streams, gens = [], {}, []
        exchange, collect = ex._exchange_plan, ex._collect_completions
        gather = ex._exchange_completions
        last_exchange = [time.monotonic()]

        def record_plan(plan):
            gens.append(ex._gen)
            plan = exchange(plan)
            last_exchange[0] = time.monotonic()
            plans.append([[a.rid, a.replica] for a in plan.assign])
            return plan

        def record_gather():
            done = gather()
            last_exchange[0] = time.monotonic()
            return done

        def record_streams():
            for s in ex.slots:
                if s is not None and s.remaining == 0:
                    streams[s.rid] = list(s.generated)
            collect()
        ex._exchange_plan = record_plan
        ex._exchange_completions = record_gather
        ex._collect_completions = record_streams
        if rank == ex.front:
            for i in range(spec["n"]):
                ex.stats["offered"] += 1
                ex.queue.submit(spec["prompts"][i % len(spec["prompts"])],
                                spec["max_new"])
        failure = None
        try:
            ex.serve_loop(stop_when=lambda: True)
        except hvd.RanksFailedError as e:
            failure = {"failed_ranks": sorted(e.failed_ranks), "op": e.op,
                       "phase": e.phase,
                       "seconds": time.monotonic() - last_exchange[0],
                       "inflight": len(ex.inflight_rids())}
        with open(out, "w") as f:
            json.dump({"plans": plans, "plan_gens": gens,
                       "steps": ex._step, "streams": streams,
                       "offered": ex.stats["offered"],
                       "served": ex.stats["served"],
                       "lost": ex.stats["lost"],
                       "expired": ex.stats["expired"],
                       "shrinks": ex.stats["shrinks"], "gen": ex._gen,
                       "failure": failure}, f)
        ex.close()
    finally:
        hvd.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
         *sys.argv[4:6])
