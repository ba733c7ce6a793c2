from tstar_tpu_torch.models.clip_tokenizer import HashTokenizer  # noqa: F401
from tstar_tpu_torch.models.owlvit import (  # noqa: F401
    OwlViTConfig,
    OwlViTDetector,
    TextConfig,
    VisionConfig,
    init_params,
    owlvit_base_patch32,
    params_from_jax,
    postprocess_detections,
)
