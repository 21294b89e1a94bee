"""The launcher and the rendezvous of the eager world: the port's copy of
``horovod_tpu/runner/`` (``launch.py`` — ``horovodrun-tpu-torch`` —,
``run_api.py`` — ``hvd.run`` —, their worker bootstraps, ``hosts.py``,
``safe_shell_exec.py``, ``driver_service.py``, ``network.py`` and the KV
part of ``controlplane.py``).  The MPI and jsrun starters and the
replicated control plane are ROADMAP queue A item 12."""
