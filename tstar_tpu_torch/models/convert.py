"""Name tables between Hugging Face checkpoints and the port's state dicts.

A model's table is a list of ``Rule``: a port parameter, the checkpoint
names it is made from (each given as a tuple of alternatives, the first
present is read), and how.  The same table converts a checkpoint into a
state dict (``convert_state_dict``, as the reference's ``convert_hf_*``
do) and writes a state dict back under the checkpoint's names
(``export_state_dict``: what a checkpoint of the same weights would hold).

Kinds:
  ``=``     copy;
  ``T``     a ``nn.Linear`` weight (out, in) -> a Dense kernel (in, out);
  ``hwio``  a conv weight (O, I, H, W) -> flax's (H, W, I, O);
  ``flat``  a conv weight (O, ...) -> one matmul kernel (prod(...), O);
  ``cat``   several vectors concatenated (fused q|k|v bias);
  ``catT``  several Linear weights, each transposed, side by side (fused
            q|k|v kernel, columns [q | k | v]).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Rule:
    port: str
    sources: Tuple[Tuple[str, ...], ...]   # per source tensor, its alternative names
    kind: str = "="
    shape: Tuple[int, ...] = ()            # ``flat``: the checkpoint tensor's shape


def rule(port: str, *names, kind: str = "=", shape: Sequence[int] = ()) -> Rule:
    """One source tensor: ``names`` are its alternatives; ``cat``/``catT``:
    each of ``names`` is a tuple of alternatives for one part."""
    if kind in ("cat", "catT"):
        sources = tuple(tuple(n) if isinstance(n, tuple) else (n,) for n in names)
    else:
        sources = (tuple(names),)
    return Rule(port, sources, kind, tuple(shape))


def _pick(sd: Mapping[str, torch.Tensor], names: Tuple[str, ...]) -> torch.Tensor:
    for n in names:
        if n in sd:
            return sd[n]
    raise KeyError(f"checkpoint has none of {names}")


def convert_state_dict(sd: Mapping[str, torch.Tensor], rules: List[Rule]) -> Dict[str, torch.Tensor]:
    """Checkpoint tensors -> the port's state dict (dtype and device kept)."""
    out: Dict[str, torch.Tensor] = {}
    for r in rules:
        parts = [_pick(sd, names) for names in r.sources]
        w = parts[0]
        if r.kind == "=":
            out[r.port] = w
        elif r.kind == "T":
            out[r.port] = w.t().contiguous()
        elif r.kind == "hwio":
            out[r.port] = w.permute(2, 3, 1, 0).contiguous()
        elif r.kind == "flat":
            out[r.port] = w.reshape(w.shape[0], -1).t().contiguous()
        elif r.kind == "cat":
            out[r.port] = torch.cat(parts, dim=0)
        elif r.kind == "catT":
            out[r.port] = torch.cat([p.t() for p in parts], dim=1).contiguous()
        else:
            raise ValueError(f"unknown rule kind {r.kind!r}")
    return out


def export_state_dict(state: Mapping[str, torch.Tensor], rules: List[Rule]) -> Dict[str, torch.Tensor]:
    """The port's state dict -> checkpoint tensors under each source's first
    name (the inverse of ``convert_state_dict``)."""
    out: Dict[str, torch.Tensor] = {}
    for r in rules:
        w = state[r.port]
        names = [alts[0] for alts in r.sources]
        if r.kind == "=":
            parts = [w]
        elif r.kind == "T":
            parts = [w.t()]
        elif r.kind == "hwio":
            parts = [w.permute(3, 2, 0, 1)]
        elif r.kind == "flat":
            parts = [w.t().reshape(r.shape)]
        elif r.kind == "cat":
            parts = list(w.chunk(len(names), dim=0))
        elif r.kind == "catT":
            parts = [p.t() for p in w.chunk(len(names), dim=1)]
        else:
            raise ValueError(f"unknown rule kind {r.kind!r}")
        for n, p in zip(names, parts):
            out[n] = p.contiguous()
    return out
