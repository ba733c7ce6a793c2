"""Megatron tensor parallelism for the port's models (port of
``tstar_tpu/parallel/shardings.py``).

The reference's rule table, carried over by parameter name (``_rule_for``):
q/k/v projections, ``fc1``, ``gate_proj``, ``up_proj`` and the fused
``qkv`` shard their output features (column-parallel); ``out_proj``,
``fc2``, ``o_proj``, ``down_proj`` and ``proj`` their input features
(row-parallel, one all-reduce after each such pair); ``lm_head`` shards the
vocabulary columns and ``embed_tokens`` the vocabulary rows; norms, patch
embeddings, heads, projectors and every other parameter stay whole.

The reference annotates its variables and lets GSPMD place and move the
data.  Here ``shard_module`` slices each parameter of a loaded model to
this rank's shard in place, and marks the modules that exchange data:

  * a column-parallel layer's bias is sliced with its columns (the
    reference keeps it whole and GSPMD slices it);
  * a row-parallel ``Dense`` all-reduces its product over the model group,
    then adds its whole bias once;
  * the fused q|k|v weights ((D, 3D): ``MultiHeadAttention.qkv_kernel``,
    the Qwen vision blocks' ``qkv``) give each rank [q_r | k_r | v_r], heads
    [r H/T, (r+1) H/T) of each section, bias likewise.  A contiguous slice
    of the 3D columns would give rank 0 all of q and half of k; the
    reference survives that only because GSPMD reshards (its grouped
    shard-major layout, ``tp_groups``, exists for that).  Within a rank the
    layout is the plain one at H/T heads, so K1 runs on it unchanged;
  * ``Embed`` looks up its vocabulary rows with the others masked, then
    all-reduces; ``lm_head`` (or the tied embedding's ``attend``)
    all-gathers the vocabulary shards of the logits.

Each attention module's head counts (``num_heads``, ``num_kv_heads``)
become this rank's here, and its forward reads them.  A model degree that
does not divide a layer's heads, kv heads, features or vocabulary raises,
naming the layer (the reference would reshard).  The collectives and the
``TensorParallel`` mark are in ``models/tensor_parallel.py``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tstar_tpu_torch.models.qwen2vl import Embed, Qwen2DecoderLayer
from tstar_tpu_torch.models.tensor_parallel import TensorParallel, tensor_parallel
from tstar_tpu_torch.models.transformer import Dense, MultiHeadAttention
from tstar_tpu_torch.parallel.mesh import Mesh

COLUMN_KEYS = ("q_proj", "k_proj", "v_proj", "fc1", "gate_proj", "up_proj", "qkv")
ROW_KEYS = ("out_proj", "fc2", "o_proj", "down_proj", "/proj/")


def _rule_for(path: str, ndim: int) -> Optional[int]:
    """The reference's table: the axis of a (in, out) parameter sharded over
    ``model`` (1: output features / vocabulary columns, 0: input features /
    vocabulary rows), or None for a whole one.  ``path`` is '/'-joined."""
    if ndim < 2:
        return None
    if any(k in path for k in COLUMN_KEYS):
        return 1
    if any(k in path for k in ROW_KEYS):
        return 0
    if "lm_head" in path:
        return 1
    if "embed_tokens" in path:
        return 0
    return None


def param_path(name: str) -> str:
    """A parameter's dotted name as the '/'-joined path the rules read."""
    return name.replace(".", "/")


def _slice(n: int, tp: TensorParallel, what: str) -> slice:
    if n % tp.size:
        raise ValueError(f"{what}: {n} does not split over model={tp.size}")
    share = n // tp.size
    return slice(tp.index * share, (tp.index + 1) * share)


def _set(module: nn.Module, name: str, value: torch.Tensor) -> None:
    old = module._parameters[name]
    module._parameters[name] = nn.Parameter(value.contiguous(), requires_grad=old.requires_grad)


def _sections(t: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """[q_r | k_r | v_r] of a fused (..., 3D) q|k|v weight or bias: heads
    [r H/T, (r+1) H/T) of each section (the caller checks that T divides
    the heads)."""
    d = t.shape[-1] // 3
    cols = slice(tp.index * d // tp.size, (tp.index + 1) * d // tp.size)
    return torch.cat([s[..., cols] for s in t.split(d, dim=-1)], dim=-1)


@torch.no_grad()
def shard_module(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Slice ``model``'s parameters in place to this rank's tensor-parallel
    shard over ``mesh``'s model group and mark its collectives (module
    docstring).  Works on a loaded model and on one on the meta device
    (shapes only).  Every layer is checked before any is sliced.  Returns
    ``model``."""
    if tensor_parallel(model) is not None:
        raise ValueError("model is already sharded")
    tp = TensorParallel(mesh)
    modules = dict(model.named_modules())
    todo = []           # (module, attribute, new value) once all layers pass

    def local_heads(module, what, *counts):
        # the one place a module's head counts become this rank's
        for attr in counts:
            heads = getattr(module, attr)
            if heads % tp.size:
                raise ValueError(f"{what}: {heads} {attr[4:].replace('_', ' ')} do not split "
                                 f"over model={tp.size}")
            todo.append((module, attr, heads // tp.size))

    for name, module in modules.items():
        what = name or type(model).__name__
        if isinstance(module, MultiHeadAttention):
            if _rule_for(param_path(f"{name}.qkv_kernel"), 2) != 1:
                continue
            local_heads(module, what, "num_heads")
            todo += [(module, p, _sections(getattr(module, p), tp))
                     for p in ("qkv_kernel", "qkv_bias")]
        elif isinstance(module, Qwen2DecoderLayer):
            local_heads(module, what, "num_heads", "num_kv_heads")
        elif isinstance(module, Dense):
            axis = _rule_for(param_path(f"{name}.kernel"), module.kernel.ndim)
            if axis is None:
                continue
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "qkv":           # a vision block's fused q|k|v
                owner = modules[name.rsplit(".", 1)[0]] if "." in name else model
                local_heads(owner, what, "num_heads")
                todo += [(module, p, _sections(getattr(module, p), tp))
                         for p in ("kernel", "bias") if getattr(module, p) is not None]
            elif axis == 1:
                cols = _slice(module.kernel.shape[1], tp, what)
                todo.append((module, "kernel", module.kernel[:, cols]))
                if leaf == "lm_head":
                    if module.bias is not None:
                        raise ValueError(f"{what}: a vocabulary-parallel head with a bias")
                    todo.append((module, "gather", tp))
                elif module.bias is not None:
                    todo.append((module, "bias", module.bias[cols]))
            else:
                rows = _slice(module.kernel.shape[0], tp, what)
                todo += [(module, "kernel", module.kernel[rows]), (module, "reduce", tp)]
        elif isinstance(module, Embed):
            if _rule_for(param_path(f"{name}.embedding"), 2) != 0:
                continue
            rows = _slice(module.embedding.shape[0], tp, f"{what} vocabulary")
            todo += [(module, "embedding", module.embedding[rows]),
                     (module, "vocab_start", rows.start), (module, "tp", tp)]
    for module, attr, value in todo:
        if isinstance(value, torch.Tensor):
            _set(module, attr, value)
        else:
            setattr(module, attr, value)
    model._tensor_parallel = tp
    return model
