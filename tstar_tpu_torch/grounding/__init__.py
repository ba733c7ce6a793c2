"""Grounding and QA stages (port of ``tstar_tpu/grounding``): the facade, the
VLM backend and the fake one, prompts and the response parse."""

from tstar_tpu_torch.grounding.universal import UniversalGrounder, TStarUniversalGrounder  # noqa: F401
from tstar_tpu_torch.grounding.fake import FakeGrounder  # noqa: F401
from tstar_tpu_torch.grounding.prompts import normalize_object_name  # noqa: F401
