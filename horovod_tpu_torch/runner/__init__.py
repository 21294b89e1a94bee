"""The launcher and the rendezvous of the eager world: the port's copy of
``horovod_tpu/runner/`` (``launch.py`` — ``horovodrun-tpu-torch`` —,
``run_api.py`` — ``hvd.run`` —, their worker bootstraps, ``hosts.py``,
``safe_shell_exec.py``, ``driver_service.py``, the mpirun and jsrun
starters ``mpi_run.py`` and ``js_run.py``, ``network.py`` and the
write-ahead-logged replica set of ``controlplane.py``).  The reference's
``specs.py`` (the model-checked protocol specs) waits for the port's
analysis passes, ROADMAP queue A item 12."""
