from tstar_tpu_torch.framework.heuristics import (  # noqa: F401
    ColorProbeHeuristic,
    OwlVitHeuristic,
    YoloWorldHeuristic,
    initialize_heuristic,
)
from tstar_tpu_torch.framework.framework import TStarFramework, run_tstar  # noqa: F401
