"""tstar_tpu_torch — the PyTorch + CUDA port of ``tstar_tpu``.

The JAX package ``tstar_tpu`` stays the reference; this package mirrors its
module layout (``ops/``, ``search/``, ``kernels/``, ``models/``, ``video/``,
``framework/``, ``parallel/``) so each module has a counterpart of the same
name.  Ported: the single-video T* search with the OWL-ViT detector and the
batched multi-video search, both stepping through CUDA graphs on the card
(``search/step_graphs.py``):

    KeyframeSearcher.search() -> engine.run_search -> OwlVitScorer
      -> resident FrameCache
    parallel.search_videos -> run_search_batched_auto -> stacked OwlVitScorer

the VLM stages, grounding and QA, from a local checkpoint, decoding
through a CUDA graph on the card (``models/generate.py``), or through the
OpenAI API:

    grounding.UniversalGrounder("llava..." | "qwen...", model_path=dir)
      -> TorchVLMBackend -> prepare_*_inputs -> generate

and the T* pipeline end to end, which chains them (``framework/``, and the
demo CLI ``python -m tstar_tpu_torch.cli.demo``):

    run_tstar / TStarFramework.run()
      -> grounding (UniversalGrounder.inference_query_grounding)
      -> search (KeyframeSearcher.search_with_visualization: the same graph
         steps, with each iteration's history)
      -> QA (UniversalGrounder.inference_qa)

Every Pallas kernel on that path has a hand-written Hopper kernel beside a
plain PyTorch version of the same math (``kernels/``).  On a CPU tensor a
kernel wrapper runs the plain version; on a CUDA tensor it launches the
kernel or raises.

The package imports ``torch`` and never ``jax``, and nothing of the JAX
package: it keeps its own ``SearchConfig`` and ``FrameworkConfig``
(``utils/config.py``).
"""

__version__ = "0.1.0"

from tstar_tpu_torch.utils.config import FrameworkConfig, SearchConfig  # noqa: F401
from tstar_tpu_torch.framework.framework import TStarFramework, run_tstar  # noqa: F401
