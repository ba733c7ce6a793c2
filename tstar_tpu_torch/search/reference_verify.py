"""Reference-fidelity verification (port of
``tstar_tpu/search/reference_verify.py``): the raw frame decoded again and
resized to ``config.verify_hw`` (600x285), as the reference's searcher
verifies, where the engine rescores the frame cache's row.

``run_search_reference_verify`` steps the search without verification
(``step_graphs.Stepper(verify=False)``: CUDA graphs on a CUDA device unless
``graphs=False``) and after each step verifies on the host: the candidate
frames' raw pixels (``frame_source``) are rescored by
``scorer.score_verify_raw``, then ``engine.verification_replay`` applies
them frame by frame in slot order (the rescore overwrites the score, at
most one removal a frame, the remaining mask evolving), and the loop
condition is read again.  ``make_raw_frame_source`` resizes with the port's
own bilinear code (``kernels/image.bilinear_resize``, the interpolation of
cv2's INTER_LINEAR, rounded to uint8) where the reference calls
``cv2.resize``, so a pixel may sit one level apart.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from tstar_tpu_torch.search.engine import pop_frame_secs, verification_replay
from tstar_tpu_torch.search.state import SearchState
from tstar_tpu_torch.search.step_graphs import StepStats, Stepper
from tstar_tpu_torch.utils.config import SearchConfig
from tstar_tpu_torch.utils.images import resize_uint8
from tstar_tpu_torch.video.decoder import open_video


def make_raw_frame_source(
    video_path: str, config: SearchConfig, raw_fps: Optional[float] = None, decoder=None,
) -> Callable[[List[int]], np.ndarray]:
    """A frame source: sampled seconds -> their raw frames at native size,
    resized to ``config.verify_hw`` (K, h, w, 3) uint8.  Reads ``decoder``
    when given, else opens ``video_path``; call ``source.close()`` when done
    (it closes only a decoder it opened)."""
    dec = decoder if decoder is not None else open_video(video_path)
    fps = raw_fps or dec.meta.fps

    def source(secs: List[int]) -> np.ndarray:
        idxs = [int(s / config.sampling_fps * fps) for s in secs]
        return resize_uint8(dec.decode_batch(idxs), config.verify_hw)

    source.close = (lambda: None) if decoder is not None else dec.close
    return source


@torch.no_grad()
def run_search_reference_verify(
    state: SearchState,
    scorer,
    config: SearchConfig,
    frame_source: Callable[[List[int]], np.ndarray],
    collect_decisions: bool = False,
    graphs: Optional[bool] = None,
    stats: Optional[StepStats] = None,
) -> Tuple[SearchState, torch.Tensor, List[dict]]:
    """Search with the verification done on the host from
    ``frame_source(secs)``'s uint8 frames.  Returns (final state, keyframe
    seconds, decisions): with ``collect_decisions``, one
    {"iteration", "sec", "vconf", "removed_slot"} per frame whose rescore
    was applied, in order."""
    stepper = Stepper.single(state, scorer, config, graphs, stats, verify=False)
    t_max, k = config.max_targets, config.frames_per_iteration
    dev = stepper.dev
    decisions: List[dict] = []
    active = stepper.setup()
    steps = 0
    while any(active):
        stepper.step(active)
        steps += 1
        secs = stepper.secs[0].cpu()
        pres = stepper.tp[0].cpu()
        scores = stepper.scores[0].cpu()
        remaining = stepper.remaining[0].cpu()
        # a superset of the frames that can trigger (remaining only shrinks)
        cand = [j for j in range(k) if bool((pres[j] & remaining).any())]
        if cand:
            frames = frame_source([int(secs[j]) for j in cand])
            vconf, vpres = scorer.score_verify_raw(torch.from_numpy(np.asarray(frames)).to(dev))
            vconf = vconf.float().cpu()
            vpres = vpres[:, :t_max].cpu()
            changed = False
            for i, j in enumerate(cand):
                if not bool((pres[j] & remaining).any()):
                    continue   # an earlier removal deactivated this trigger
                before = remaining
                scores, remaining = verification_replay(
                    scores, remaining, secs[j:j + 1], pres[j:j + 1], vconf[i:i + 1],
                    vpres[i:i + 1], config,
                )
                changed = True
                if collect_decisions:
                    gone = (before & ~remaining).nonzero().flatten().tolist()
                    decisions.append({
                        "iteration": int(state.iteration) + steps,
                        "sec": int(secs[j]),
                        "vconf": float(vconf[i]),
                        "removed_slot": gone[0] if gone else None,
                    })
            if changed:
                stepper.scores[0].copy_(scores)
                stepper.remaining[0].copy_(remaining)
        budget = int(state.budget) - steps * k
        active = [bool(remaining.any()) and budget > 0]
    final = stepper.single_state(state, steps)
    return final, pop_frame_secs(final, config), decisions
