"""Numerical optimization helpers for the autotuner (GP + Bayesian opt):
the port's own copy of ``horovod_tpu/common/optim``."""
