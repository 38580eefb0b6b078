"""Process group, device mesh and batch sharding of the port (the JAX
package's ``parallel/mesh.py``).

The JAX package drives one program over a ``jax.sharding.Mesh``: the
batch is sharded over the ``data`` axis, the parameters are replicated and
XLA reduces the gradients inside the jitted step. The port keeps the
reference's own layout for training (one process a card, launched as
``torchrun`` launches: ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``), which computes what the JAX package's
global-batch program computes:

- each rank loads its rows of the global batch (``data/pipeline.py``:
  ``HostLoader`` gives rank r the samples ``order[r::world]``, so global
  batch i is rank 0's batch i followed by rank 1's);
- the parameters are broadcast from rank 0 once, at start
  (``replicate``, the port of ``replicated_sharding``);
- each step sums the ranks' gradients in one flat all-reduce
  (``parallel/collectives.py``).

Serving (``LayoutPredictor(mesh=...)``) stays one process, as in the JAX
package: a ``Mesh`` of the process's devices, a replica of the nets on each
and a slice of the request for each (``shard_batch``).

Nothing here starts a group at import time, and outside a group every
helper is the one-process identity.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# the variables ``torchrun`` sets for each process; all four must be there
LAUNCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def in_group() -> bool:
    """Whether this process belongs to a ``torch.distributed`` group."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 outside a group)."""
    return dist.get_rank() if in_group() else 0


def process_count() -> int:
    """The number of processes of the run (1 outside a group)."""
    return dist.get_world_size() if in_group() else 1


def is_primary() -> bool:
    """Rank 0 (the reference's ``rank == 0``): the one process that logs,
    writes TensorBoard events, dumps predictions and saves checkpoints."""
    return process_index() == 0


def local_rank() -> int:
    """The card of this process: ``LOCAL_RANK`` as the launcher set it."""
    return int(os.environ.get("LOCAL_RANK", 0))


def maybe_initialize_distributed(device="cuda",
                                 backend: Optional[str] = None) -> bool:
    """Join the process group that the launcher's variables describe
    (``LAUNCH_ENV``); runs without them are untouched. NCCL for a CUDA
    ``device`` (after ``torch.cuda.set_device(LOCAL_RANK)``), Gloo for the
    CPU, unless ``backend`` names one (Gloo also takes CUDA tensors: two
    ranks on one card, which NCCL refuses). Returns True when it
    initialised a group. The JAX package's version reads
    ``JAX_COORDINATOR_ADDRESS``."""
    if in_group() or not all(os.environ.get(k) for k in LAUNCH_ENV):
        return False
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.set_device(local_rank())
    dist.init_process_group(backend or ("nccl" if on_card else "gloo"),
                            init_method="env://")
    return True


def cross_process_barrier(name: str, timeout_s: int = 1200) -> None:
    """Block until every process of the group reaches this barrier; no-op
    outside a group. ``name`` labels the barrier in Gloo's timeout
    message."""
    if not in_group():
        return
    if dist.get_backend() == "gloo":
        dist.monitored_barrier(timeout=datetime.timedelta(seconds=timeout_s))
    else:
        dist.barrier(device_ids=[local_rank()])


def build_then_barrier(device, name: str = "kernels built",
                       timeout_s: int = 1200) -> None:
    """Build the CUDA kernels on every rank, then barrier (the JAX
    package's ``compile_then_barrier``): the port has no ahead-of-time
    compile, and its nearest counterpart is the ``nvcc`` build at first
    use. Building first means no rank is still inside ``nvcc`` when the
    first collective's rendezvous, with its own deadline, begins. The build
    is race-safe across ranks (``ops/kernels/_build.py`` writes a per-pid
    file and renames it)."""
    if torch.device(device).type == "cuda":
        from ..ops.kernels import _build
        _build.build()
    cross_process_barrier(name, timeout_s)


@dataclass(frozen=True)
class Mesh:
    """The port's mesh: its ``shape`` and ``axis_names``, and the devices
    of this process in mesh order (``devices``). Under a group the mesh
    spans the ranks, one device each, and ``devices`` holds this rank's."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))


def _local_devices() -> List[torch.device]:
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(devices: Optional[Sequence] = None,
              shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data",)) -> Mesh:
    """A mesh over ``devices`` (default: every card of the process, or the
    CPU; under a group: one card a rank). ``shape`` defaults to every
    device on the first axis; a shape that needs more devices than exist
    raises the JAX package's ``ValueError``."""
    if devices is None and in_group():
        have = process_count()
        mine = [torch.device("cuda", local_rank())
                if torch.cuda.is_available() else torch.device("cpu")]
    else:
        mine = [torch.device(d) for d in (devices if devices is not None
                                          else _local_devices())]
        have = len(mine)
    if shape is None:
        shape = [have] + [1] * (len(axis_names) - 1)
    n = int(np.prod(shape))
    if n > have:
        hint = ("" if in_group() else
                f"; training runs one process a device: launch with "
                f"torchrun --nproc_per_node {n}")
        raise ValueError(f"mesh shape {shape} needs {n} devices, "
                         f"have {have}{hint}")
    if not in_group():
        mine = mine[:n]
    return Mesh(tuple(int(s) for s in shape), tuple(axis_names), tuple(mine))


def training_mesh(shape: Optional[Sequence[int]]) -> Mesh:
    """The mesh of a training run: one device a rank, so ``shape`` must
    multiply out to the world size (``torchrun --nproc_per_node N``)."""
    mesh = make_mesh(shape=[process_count()] if shape is None
                     else list(shape))
    if mesh.size != process_count():
        raise ValueError(
            f"mesh shape {list(mesh.shape)} has {mesh.size} devices but the "
            f"run has {process_count()} processes; training runs one process "
            f"a device: launch with torchrun --nproc_per_node {mesh.size}")
    return mesh


def local_rows(x, index: int, count: int):
    """Rows ``index`` of ``count`` equal parts of ``x``'s leading axis."""
    n = x.shape[0] // count
    return x[index * n:(index + 1) * n]


def shard_batch(batch: Dict[str, object], mesh: Mesh) -> List[dict]:
    """A global batch (host arrays or tensors) as the shards this process
    holds: for each of its devices, that device's rows on it. Under a group
    that is this rank's rows; in one process, a slice for each device of
    the mesh."""
    if in_group():
        parts = [(process_index(), process_count())]
    else:
        parts = [(i, mesh.size) for i in range(mesh.size)]
    return [{k: torch.as_tensor(local_rows(v, i, n)).to(dev)
             for k, v in batch.items()}
            for (i, n), dev in zip(parts, mesh.devices)]


@torch.no_grad()
def replicate(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Broadcast ``tensors`` from rank ``src`` into every rank's own, in
    place (the port of ``replicated_sharding``: the parameters start equal
    on every rank). No-op outside a group."""
    if not in_group():
        return
    for t in tensors:
        dist.broadcast(t.data, src)
