"""Visualization sinks (port of ``tstar_tpu/viz``): score plots, search GIFs,
grid renders and box annotation, all on the host."""

from tstar_tpu_torch.viz.artifacts import (  # noqa: F401
    plot_score_distribution,
    render_grid_image,
    save_search_gif,
)
from tstar_tpu_torch.viz.boxes import draw_boxes  # noqa: F401
