"""mpirun command construction for MPI-controller clusters.

The port's copy of ``horovod_tpu/runner/mpi_run.py`` (upstream
horovod/runner/mpi_run.py): detect the installed MPI flavor and build one
big ``mpirun`` invocation carrying host slots, process binding and the
HOROVOD_* environment.  MPI is the *process starter* only: the built
command execs one worker per slot with the same env contract as the TCP
launcher, each worker adopts its rank from the OMPI/PMI variables
(``js_run.adopt_jsm_env``) and dials back to the launcher's rendezvous;
the data plane stays the port's (NCCL on the cards, TCP or shm on the
host).
"""
from __future__ import annotations

import os
import shutil
import subprocess

_OMPI_FLAGS = ["-mca", "pml", "ob1", "-mca", "btl", "^openib"]
_SMPI_FLAGS = ["-tcp"]
_MPICH_FLAGS: list[str] = []
_INTEL_FLAGS: list[str] = []
_NO_BINDING_ARGS = ["-bind-to", "none", "-map-by", "slot"]


def mpi_available(env: dict | None = None) -> bool:
    return _mpirun_path(env) is not None


def _mpirun_path(env: dict | None = None) -> str | None:
    path = (env or os.environ).get("PATH")
    return shutil.which("mpirun", path=path)


def flavor(env: dict | None = None,
           version_text: str | None = None) -> str:
    """Detect openmpi / spectrum / mpich / intel / unknown
    (reference: mpi_run.py:24-120)."""
    if version_text is None:
        mpirun = _mpirun_path(env)
        if mpirun is None:
            return "none"
        try:
            version_text = subprocess.run(
                [mpirun, "--version"], capture_output=True, timeout=10,
                text=True).stdout
        except (subprocess.SubprocessError, OSError):
            return "unknown"
    text = version_text.lower()
    if "open mpi" in text or "openrte" in text:
        return "openmpi"
    if "ibm spectrum mpi" in text:
        return "spectrum"
    if "mpich" in text or "hydra" in text:
        return "mpich"
    if "intel(r) mpi" in text:
        return "intel"
    return "unknown"


def build_mpi_command(command: list[str], *, np: int,
                      hosts: str | None = None,
                      env: dict | None = None,
                      mpi_flavor: str | None = None,
                      ssh_port: int | None = None,
                      extra_mpi_args: str | None = None) -> list[str]:
    """Build the mpirun argv (reference: mpi_run.py:210-254)."""
    env = dict(env if env is not None else os.environ)
    mpi_flavor = mpi_flavor or flavor(env)
    impl_flags = {
        "openmpi": _OMPI_FLAGS,
        "spectrum": _SMPI_FLAGS,
        "mpich": _MPICH_FLAGS,
        "intel": _INTEL_FLAGS,
    }.get(mpi_flavor, _OMPI_FLAGS)

    # 'unknown' (version probe failed/unparseable) keeps the OpenMPI
    # treatment throughout — matching the impl_flags fallback above.
    ompi_style = mpi_flavor not in ("mpich", "intel")
    cmd = ["mpirun"]
    if ompi_style:
        # OpenMPI-only flag: mpich/intel Hydra mpirun rejects it and
        # would fail at launch (advisor finding).
        cmd.append("--allow-run-as-root")
    cmd += ["-np", str(np)]
    if hosts:
        # OpenMPI takes -H host:slots; Hydra (mpich/intel) spells the
        # same list -hosts and rejects -H outright.
        cmd += ["-H" if ompi_style else "-hosts", hosts]
    if ompi_style:
        cmd += _NO_BINDING_ARGS
        cmd += impl_flags
        if ssh_port:
            cmd += ["-mca", "plm_rsh_args", f"-p {ssh_port}"]
        for name in sorted(env):
            if name.startswith("HOROVOD_") or name in ("PATH", "PYTHONPATH",
                                                       "LD_LIBRARY_PATH"):
                cmd += ["-x", name]
    else:
        cmd += impl_flags
        exported = [n for n in sorted(env)
                    if n.startswith("HOROVOD_")
                    or n in ("PATH", "PYTHONPATH", "LD_LIBRARY_PATH")]
        if exported:
            cmd += ["-genvlist", ",".join(exported)]
    if extra_mpi_args:
        cmd += extra_mpi_args.split()
    return cmd + list(command)
