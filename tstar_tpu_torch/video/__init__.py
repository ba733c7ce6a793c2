from tstar_tpu_torch.video.cache import (  # noqa: F401
    FrameCache,
    StreamingFrameCache,
    build_frame_cache,
    build_frame_cache_host,
    fit_cache_hw,
)
from tstar_tpu_torch.video.decoder import NativeDecoder, VideoMeta, open_video  # noqa: F401
from tstar_tpu_torch.video.synthetic import SyntheticDecoder  # noqa: F401
