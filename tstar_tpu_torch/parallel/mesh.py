"""A device mesh over the ranks of a ``torch.distributed`` process group
(port of ``tstar_tpu/parallel/mesh.py``).

Two axes, as in the reference:

  * ``data``: videos.  Each data index owns whole videos: their frame
    caches, search states and detector batches.  Nothing is exchanged while
    they search; the result rows are gathered once at the end.
  * ``model``: tensor parallelism inside the detector and the VLM (heads and
    MLP widths sharded, ``parallel/shardings.py``); a row-parallel layer
    all-reduces its product over the model group.

The groups are torch's ``init_device_mesh`` over (data, model): rank r
sits at (r // model, r % model), the reference's contiguous
``np.reshape(devices, (data, model))``; the ranks of one data row form a
model group, the ranks of one model column a data group.  Each rank drives
one device: ``cuda:LOCAL_RANK`` unless the caller names one (the tests pass
``cpu``; two ranks sharing one card pass ``cuda:0`` and ask for gloo).

The backend is NCCL on a CUDA device and gloo on the CPU.  Gloo on CUDA
tensors is taken only when asked for: it stages every collective through
the host, so a step whose forward holds one cannot be captured in a CUDA
graph (``search/step_graphs.py`` and ``models/generate.py`` then step
eagerly).  NCCL refuses two ranks on one device; ``make_mesh`` says so
before NCCL is reached.  The mesh's backend is the default process
group's: ``make_mesh`` raises when the two differ.

Launch with ``torchrun --nproc-per-node N`` (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` from the environment);
without those variables ``init_distributed`` makes a one-rank group on a
free local port.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import socket
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"
# how long a collective waits for the other ranks before it raises
TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a (data, model) mesh."""

    data: int
    model: int
    rank: int
    device: torch.device
    backend: str
    device_mesh: Any             # torch's DeviceMesh; None where only shapes are read

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def model_group(self):
        """The process group of this rank's data row."""
        return self.device_mesh.get_group(MODEL_AXIS)

    @property
    def model_ranks(self) -> Tuple[int, ...]:
        return tuple(self.device_mesh.mesh[self.data_index].tolist())


def free_port() -> int:
    """A free local TCP port for a process group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(backend: str) -> None:
    """Initialize the default process group from torchrun's variables
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), or as a
    one-rank group on a free local port when they are absent."""
    if dist.is_initialized():
        raise RuntimeError("the default process group is already initialized")
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if "MASTER_PORT" in os.environ:
        addr = os.environ.get("MASTER_ADDR", "localhost")
        init = f"tcp://{addr}:{os.environ['MASTER_PORT']}"
    elif world == 1:
        init = f"tcp://localhost:{free_port()}"
    else:
        raise RuntimeError(
            f"WORLD_SIZE={world} without MASTER_PORT: launch with torchrun, or call "
            "torch.distributed.init_process_group yourself"
        )
    # no device_id: NCCL's communicators stay lazy, so make_mesh checks the
    # ranks' devices before NCCL is reached
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                            timeout=TIMEOUT)


def check_devices(keys: List[str], backend: str) -> None:
    """Raise if NCCL would run two ranks on one device (``keys``: each
    rank's host and device)."""
    if backend == "nccl" and len(set(keys)) < len(keys):
        raise ValueError(
            f"NCCL cannot run two ranks on one device (ranks' devices {keys}); "
            "ask for backend='gloo', which stages collectives through the host"
        )


def _device_keys(device: torch.device) -> List[str]:
    """Every rank's (host, device) key, exchanged through the default
    group's store: no collective, so no backend is reached."""
    store = dist.distributed_c10d._get_default_store()
    key = f"{socket.gethostname()}/{device}"
    rank, world = dist.get_rank(), dist.get_world_size()
    store.set(f"tstar_mesh_device/{rank}", key)
    return [store.get(f"tstar_mesh_device/{r}").decode() for r in range(world)]


def make_mesh(
    data: Optional[int] = None,
    model: int = 1,
    backend: Optional[str] = None,
    device=None,
) -> Mesh:
    """A (data, model) mesh over the default process group, initialized
    here (``init_distributed``) if it is not yet.  ``data`` defaults to the
    world size over ``model``.  Raises, never falls back: on a mesh shape
    that is not the world size, on NCCL for a CPU device or for two ranks on
    one device, on a backend other than the default group's, on a CUDA
    device the machine does not have."""
    if device is None:                  # cuda:LOCAL_RANK (0 without torchrun)
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass device='cpu' to ask for the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}: 'nccl' or 'gloo'")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL needs a CUDA device, got {device}")
    if not dist.is_initialized():
        init_distributed(backend)
    world, rank = dist.get_world_size(), dist.get_rank()
    if model < 1 or world % model:
        raise ValueError(f"mesh model={model} does not divide the world size {world}")
    data = world // model if data is None else data
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != world size {world}")
    check_devices(_device_keys(device), backend)
    if dist.get_backend() != backend:
        raise ValueError(f"the default process group runs {dist.get_backend()}; a {backend} "
                         f"mesh needs a {backend} group")
    mesh = Mesh(data=data, model=model, rank=rank, device=device, backend=backend,
                device_mesh=init_device_mesh(device.type, (data, model),
                                             mesh_dim_names=(DATA_AXIS, MODEL_AXIS)))
    logger.info("mesh %dx%d (%s): rank %d at (%d, %d) on %s", data, model, backend, rank,
                mesh.data_index, mesh.model_index, device)
    return mesh


def data_sharding(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous, equal share of a leading (video) axis of
    ``n``: the reference's ``P("data", ...)``.  Raises when the data degree
    does not divide ``n``, as the reference's ``device_put`` does."""
    if n % mesh.data:
        raise ValueError(f"{n} videos do not split evenly over data={mesh.data}")
    share = n // mesh.data
    return slice(mesh.data_index * share, (mesh.data_index + 1) * share)


def replicated(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` kept whole on every rank: rank 0's copy, broadcast in
    place over the world (the reference's ``P()``)."""
    if mesh.world > 1:
        dist.broadcast(tensor, src=0)
    return tensor


def gather_rows(mesh: Mesh, rows: Any) -> List[Any]:
    """Every data index's ``rows`` (any picklable object, from its model
    index 0), in data order, on every rank."""
    if mesh.world == 1:
        return [rows]
    out: List[Any] = [None] * mesh.world
    dist.all_gather_object(out, rows if mesh.model_index == 0 else None)
    return [out[d * mesh.model] for d in range(mesh.data)]
