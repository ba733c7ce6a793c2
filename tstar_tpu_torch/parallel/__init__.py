"""Batched multi-video search and the multi-device layer (port of
``tstar_tpu/parallel``): ``mesh`` (a ``torch.distributed`` mesh of data x
model ranks), ``shardings`` (Megatron tensor parallelism for the models),
``batched`` (the batched drivers) and ``multi_video`` (``search_videos``,
one device or a mesh)."""

from tstar_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    data_sharding,
    init_distributed,
    make_mesh,
    replicated,
)
from tstar_tpu_torch.parallel.shardings import shard_module  # noqa: F401
from tstar_tpu_torch.parallel.batched import (  # noqa: F401
    run_search_batched,
    run_search_batched_auto,
    run_search_batched_chained,
    run_search_batched_with_history,
    stack_scorers,
)
from tstar_tpu_torch.parallel.multi_video import VideoTask, search_videos  # noqa: F401
