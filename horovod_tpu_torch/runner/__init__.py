"""Rendezvous and peer sockets of the eager world (the port's copy of
``horovod_tpu/runner/``'s ``network.py`` and the KV part of
``controlplane.py``); the launcher is ROADMAP queue A item 12."""
