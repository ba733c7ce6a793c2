from tstar_tpu_torch.ops.percentile import masked_percentile  # noqa: F401
from tstar_tpu_torch.ops.sampling import (  # noqa: F401
    draw_gumbel,
    gumbel_topk_without_replacement,
    topk_indices,
    uniform_stride_indices,
)
from tstar_tpu_torch.ops.smoother import smoothing_spline_distribution  # noqa: F401
from tstar_tpu_torch.ops.splat import (  # noqa: F401
    splat_detections_to_cells,
    window_splat,
)
