"""Batched multi-video search (port of ``tstar_tpu/parallel``, one device)."""

from tstar_tpu_torch.parallel.batched import (  # noqa: F401
    run_search_batched,
    run_search_batched_auto,
    run_search_batched_chained,
    run_search_batched_with_history,
    stack_scorers,
)
from tstar_tpu_torch.parallel.multi_video import VideoTask, search_videos  # noqa: F401
