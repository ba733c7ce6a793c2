from tstar_tpu_torch.framework.heuristics import (  # noqa: F401
    OwlVitHeuristic,
    initialize_heuristic,
)
