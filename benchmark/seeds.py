"""Seeds derived from a run's ``--seed``: one 63-bit seed for each purpose,
so that the weights, each video and each search draw apart, and any whole
number (negative or wider than 64 bits) is a valid run seed."""

from __future__ import annotations

import hashlib


def derive(seed: int, *tags) -> int:
    text = ":".join(str(t) for t in (seed,) + tags)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") >> 1
