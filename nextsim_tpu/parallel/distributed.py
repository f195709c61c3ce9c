"""Multi-process initialisation — the Environment/MPI_Init analog.

The reference boots through boost::mpi (reference: core/src/environment.cpp:
23-60: MPI_Init + config parse + data-dir resolution). The jax equivalent
is `jax.distributed.initialize()`, after which `jax.devices()` spans every
process and the GSPMD-sharded step runs unchanged — device meshes from
parallel/sharding.py simply see more devices.

Call `init_distributed()` once at program start (the CLI does this). With no
coordinator named it is a no-op. With one named it needs the process count
and this process's id too, and any failure to join raises: a rank that
quietly ran alone would write a wrong single-process result.

One process per card: a JAX process reserves most of the memory of every
card it can see, so each process is restricted to its own card(s) —
``local_device_ids`` (or ``JAX_LOCAL_DEVICE_IDS="i,j"``), by default the card
whose index is the process id, which is the layout of one host with one
process per card. On several hosts, set ``JAX_LOCAL_DEVICE_IDS`` per process.
"""

from __future__ import annotations

import os


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, local_device_ids=None) -> bool:
    """Initialise jax.distributed when a coordinator is named (argument,
    ``JAX_COORDINATOR_ADDRESS`` or ``COORDINATOR_ADDRESS``). Returns True
    when a multi-process runtime was initialised."""
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("JAX_COORDINATOR_ADDRESS") or env.get(
            "COORDINATOR_ADDRESS"
        )
    if coordinator_address is None:
        return False
    if num_processes is None and env.get("JAX_NUM_PROCESSES"):
        num_processes = int(env["JAX_NUM_PROCESSES"])
    if process_id is None and env.get("JAX_PROCESS_ID"):
        process_id = int(env["JAX_PROCESS_ID"])
    if num_processes is None or process_id is None:
        raise ValueError(
            f"coordinator {coordinator_address} named but the process count "
            "or this process's id is missing: set JAX_NUM_PROCESSES and "
            "JAX_PROCESS_ID"
        )
    if not 0 <= process_id < num_processes:
        raise ValueError(
            f"process id {process_id} outside 0..{num_processes - 1}"
        )
    if local_device_ids is None and not env.get("JAX_LOCAL_DEVICE_IDS"):
        local_device_ids = [process_id]  # else JAX reads the variable

    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    return jax.process_count() > 1


def use_local_devices(local_device_ids) -> None:
    """Restrict a process that runs without a coordinator to its own cards
    (see the module docstring). Call before the first device use."""
    import jax

    ids = ",".join(str(int(i)) for i in local_device_ids)
    jax.config.update("jax_cuda_visible_devices", ids)
