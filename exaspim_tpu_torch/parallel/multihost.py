"""Multi-process runtime initialization over ``torch.distributed``.

Counterpart of ``exaspim_tpu/parallel/multihost.py``. The reference is
single-process (reference train.py:41); the JAX package joins a pod with
``jax.distributed.initialize``. Here one process drives one GPU, and
:func:`initialize_multihost` joins the processes into one
``torch.distributed`` process group: from its arguments, or from the
environment ``torchrun`` sets (``MASTER_ADDR``/``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``). Call it once at program start::

    from exaspim_tpu_torch.parallel import initialize_multihost
    initialize_multihost()                       # under torchrun
    initialize_multihost("host0:29500", num_processes=4, process_id=i)

Then build a mesh over the group (:func:`~exaspim_tpu_torch.parallel.mesh.
make_mesh`); checkpoints and logs are written where :func:`is_primary`.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

__all__ = ["initialize_multihost", "is_primary", "default_backend"]


def default_backend(device):
    """``"nccl"`` for a CUDA device, ``"gloo"`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_multihost(coordinator_address=None, num_processes=None,
                         process_id=None, local_device_ids=None,
                         backend=None, device="cuda"):
    """Initialize the default process group (idempotent, safe solo).

    ``coordinator_address`` (``"host:port"``), ``num_processes`` and
    ``process_id`` take the place of torchrun's ``MASTER_ADDR`` /
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``. On ``device="cuda"`` the
    process's card becomes the current CUDA device, before the group is
    joined: ``local_device_ids[0]`` when given, else ``LOCAL_RANK`` (default
    0); an NCCL group is bound to that card (``device_id``), so its
    communicator is built at once. ``backend`` defaults to
    :func:`default_backend` of ``device`` (``nccl`` on the card, ``gloo`` on
    the CPU); the code never switches backends on its own.

    Returns True when the group is (now) initialized, False for a plain
    single-process run with nothing configured. A second call on an
    initialized group is ignored.
    """
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return False  # plain single-process run
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "initialize_multihost needs the coordinator address, the number "
            "of processes and this process's id (arguments or torchrun's "
            "MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK); got "
            f"{coordinator_address!r}, {num_processes!r}, {process_id!r}")
    backend = backend or default_backend(device)
    bind = {}
    if torch.device(device).type == "cuda":
        local = (int(local_device_ids[0]) if local_device_ids
                 else int(env.get("LOCAL_RANK", 0)))
        if local >= torch.cuda.device_count():
            raise ValueError(
                f"local device {local} but this host has "
                f"{torch.cuda.device_count()} CUDA devices")
        torch.cuda.set_device(local)
        if backend == "nccl":
            # Bound to its card, the group builds its NCCL communicator
            # here, not lazily inside the first (timed) collective.
            bind["device_id"] = torch.device("cuda", local)
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id), **bind,
    )
    return True


def is_primary():
    """True on rank 0, or when no process group is initialized: the
    process that writes checkpoints, logs and outputs."""
    return not dist.is_initialized() or dist.get_rank() == 0
