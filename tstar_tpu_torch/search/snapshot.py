"""Search-state snapshot and resume (port of ``tstar_tpu/search/snapshot.py``).

A state saves to one ``.npz`` with the reference's array names (``scores``,
``visited``, ``P``, ``remaining``, ``budget``, ``n_valid``, ``iteration``,
``rng``).  Where the reference stores its PRNG key's data, ``rng`` here holds
the state of the search's ``torch.Generator`` (``Generator.get_state()``),
so a search resumed from a snapshot taken mid-search draws the noise the
uninterrupted one would have drawn and continues its trajectory exactly.
The port's noise is not the reference's, so a snapshot of one package does
not resume in the other.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tstar_tpu_torch.search.state import SearchState


def save_state(state: SearchState, path: str) -> str:
    """Write ``state`` to ``path`` (.npz); its noise source must be a
    ``torch.Generator``."""
    if not isinstance(state.rng, torch.Generator):
        raise TypeError("a snapshot needs the search's torch.Generator as its noise source")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(
        path,
        scores=state.scores.cpu().numpy(),
        visited=state.visited.cpu().numpy(),
        P=state.P.cpu().numpy(),
        remaining=state.remaining.cpu().numpy(),
        budget=np.int64(state.budget),
        n_valid=np.int64(state.n_valid),
        iteration=np.int64(state.iteration),
        rng=state.rng.get_state().numpy(),
    )
    return path


def load_state(path: str, device="cuda") -> SearchState:
    """A snapshot as a state on ``device`` (the card unless the caller asks
    for the CPU), with a new generator on that device in the saved
    generator's state: a generator's state loads only on the kind of device
    it was saved from."""
    device = torch.device(device)
    with np.load(path) as data:
        rng = torch.Generator(device=device)
        rng.set_state(torch.from_numpy(data["rng"].copy()))
        return SearchState(
            scores=torch.from_numpy(data["scores"].copy()).to(device),
            visited=torch.from_numpy(data["visited"].copy()).to(device),
            P=torch.from_numpy(data["P"].copy()).to(device),
            remaining=torch.from_numpy(data["remaining"].copy()).to(device),
            budget=int(data["budget"]),
            n_valid=int(data["n_valid"]),
            iteration=int(data["iteration"]),
            rng=rng,
        )
