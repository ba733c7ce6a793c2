from tstar_tpu_torch.search.engine import (  # noqa: F401
    pop_frame_secs,
    run_search,
    sample_frame_secs,
    search_step,
)
from tstar_tpu_torch.search.scorers import TableScorer  # noqa: F401
from tstar_tpu_torch.search.state import SearchState, init_state  # noqa: F401
