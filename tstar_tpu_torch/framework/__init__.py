from tstar_tpu_torch.framework.heuristics import (  # noqa: F401
    OwlVitHeuristic,
    YoloWorldHeuristic,
    initialize_heuristic,
)
