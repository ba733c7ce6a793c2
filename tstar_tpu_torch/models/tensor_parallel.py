"""Tensor parallelism inside the port's models: what
``parallel/shardings.shard_module`` leaves on a sharded model, and the
collectives its layers run over the model group.

This module imports no model and nothing of ``parallel``, so the models,
the search drivers and ``parallel`` all import it.  On a model group of one
rank the collectives are kept under NCCL (so a captured graph holds them,
as on N ranks) and skipped under gloo, whose one-rank sum is the identity.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(eq=False)
class TensorParallel:
    """What ``shard_module`` did to a model: the mesh
    (``parallel/mesh.Mesh``) whose model group holds its shards."""

    mesh: Any

    @property
    def group(self):
        """The model group's process group."""
        return self.mesh.model_group

    @property
    def ranks(self):
        return self.mesh.model_ranks

    @property
    def size(self) -> int:
        return self.mesh.model

    @property
    def index(self) -> int:
        return self.mesh.model_index

    @property
    def collectives(self) -> bool:
        """Whether the layers' collectives run: every group under NCCL,
        groups of more than one rank under gloo."""
        return self.size > 1 or self.mesh.backend == "nccl"

    @property
    def graph_safe(self) -> bool:
        """Whether a CUDA graph can hold this model's collectives: NCCL's,
        or none at all; gloo stages them through the host."""
        return self.mesh.backend == "nccl" or not self.collectives

    def __deepcopy__(self, memo):
        # copies of a sharded module share its groups (a ProcessGroup
        # cannot be copied)
        return self


def tensor_parallel(module) -> Optional[TensorParallel]:
    """The ``TensorParallel`` of a model ``shard_module`` sharded, or None."""
    return getattr(module, "_tensor_parallel", None)


def graph_blocker(module) -> Optional[str]:
    """Why a CUDA graph cannot hold ``module``'s forward, or None: its model
    group runs collectives over gloo."""
    tp = tensor_parallel(module)
    if tp is None or tp.graph_safe:
        return None
    return (f"the model is sharded over a gloo model group of {tp.size} ranks, whose "
            "collectives stage through the host and cannot be captured")


def all_reduce_(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """``x`` summed over the model group, in place."""
    if tp.collectives:
        dist.all_reduce(x, group=tp.group)
    return x


def all_reduce_max_(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """``x``'s elementwise max over the model group, in place."""
    if tp.collectives:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=tp.group)
    return x


def all_gather_last(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The model group's shards of ``x`` concatenated on the last axis."""
    if not tp.collectives:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(tp.size)]
    dist.all_gather(parts, x, group=tp.group)
    return torch.cat(parts, dim=-1)


def broadcast_first_(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """``x`` of the model group's first rank, on every rank of the group."""
    if tp is not None and tp.collectives:
        dist.broadcast(x, src=tp.ranks[0], group=tp.group)
    return x


def agree(values: List[int], tp: TensorParallel, what: str, device) -> None:
    """Raise unless every rank of ``tp``'s model group holds the same
    ``values``: an all-reduced max of the values and of their negatives.
    Called where a rank's next collectives depend on a value (a loop flag,
    a count), so that ranks that part raise instead of waiting in
    collectives the other never reaches."""
    if tp.size == 1:
        return
    t = torch.tensor(list(values) + [-v for v in values], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=tp.group)
    hi, neg_lo = t.tolist()[:len(values)], t.tolist()[len(values):]
    if any(h != -n for h, n in zip(hi, neg_lo)):
        raise RuntimeError(
            f"model ranks {tp.ranks} disagree on {what}: this rank has {list(values)}, "
            f"the group's max {hi}, min {[-n for n in neg_lo]}"
        )
