"""Multi-process proving: ``torch.distributed`` init and 2-axis (DCN x ICI)
meshes.

Counterpart of ``thaler_study_tpu/parallel/multihost.py``. The JAX package
is pure SPMD: every host runs the same protocol loop, and GSPMD inserts
the collectives. The port keeps the first part: every process runs the same
loop (the sumcheck and GKR state machines are deterministic and tiny), so
every process derives the same challenges and writes the same transcript,
with no broadcast. The collectives are explicit instead: one function,
``parallel/sharded.collective``, issues the round sums' reduction (within
the process over the ICI axis, then one ``all_reduce`` over the DCN axis)
and the residual gather.

The layout is the JAX package's: the trailing shard variables split with
the highest bits on the DCN axis (one row per process) and the lower bits
on the ICI axis (this process's devices), so every fold is local and only
the (degree + 1) round sums cross processes.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from .sharded import Mesh, default_devices, resolve_devices

DCN_AXIS = "dcn"
ICI_AXIS = "ici"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the default process group, once (a second call returns).

    With no arguments ``torch.distributed`` reads the environment that
    ``torchrun`` sets (``init_method="env://"``). Else
    ``coordinator_address`` is an init URL (``tcp://host:port``,
    ``file:///path``) or ``host:port``, with the world size and this
    process's rank. The group holds both of torch's backends, ``gloo``
    for CPU tensors and ``nccl`` for CUDA ones, so CPU and CUDA meshes
    need no choice."""
    if dist.is_initialized():
        return
    if coordinator_address is None and num_processes is None and process_id is None:
        dist.init_process_group(init_method="env://")
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("give coordinator_address, num_processes and process_id together, or none of them")
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(init_method=url, world_size=num_processes, rank=process_id)


def make_mesh_2d(devices: Optional[Sequence] = None, dcn_size: Optional[int] = None) -> Mesh:
    """A 2-axis (``dcn``, ``ici``) mesh.

    In a process group (:func:`init_distributed`) with ``dcn_size`` equal to
    the world size (the default), each process is one DCN row and
    ``devices`` are its own (default: every visible CUDA device); the
    DCN reduction of the round sums is a ``torch.distributed`` all-reduce,
    even in a group of one. Otherwise the mesh is one process's:
    ``devices`` (default: every visible CUDA device; repeats allowed)
    reshaped to ``dcn_size`` (default 1) rows, which emulates host
    boundaries as the JAX package's virtual meshes do."""
    devs = default_devices() if devices is None else resolve_devices(devices)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if dcn_size is None:
        dcn_size = world
    if dist.is_initialized() and dcn_size == world:
        arr = np.empty((dcn_size, len(devs)), dtype=object)
        for row in range(dcn_size):
            for col, d in enumerate(devs):
                arr[row, col] = d
        return Mesh(arr, (DCN_AXIS, ICI_AXIS), group=dist.group.WORLD, rank=dist.get_rank())
    if world > 1:
        raise ValueError(f"a mesh over {world} processes has one DCN row per process, not {dcn_size}")
    if len(devs) % dcn_size != 0:
        raise ValueError(f"{len(devs)} devices do not split into {dcn_size} DCN groups")
    arr = np.empty((dcn_size, len(devs) // dcn_size), dtype=object)
    for i, d in enumerate(devs):
        arr.flat[i] = d
    return Mesh(arr, (DCN_AXIS, ICI_AXIS))


def mesh_axis_spec(mesh: Mesh) -> Tuple[str, ...]:
    """The axes the hypercube dimension is sharded over: all of them,
    outermost (DCN) first, so the highest shard bits land on the slowest
    links."""
    return tuple(mesh.axis_names)
