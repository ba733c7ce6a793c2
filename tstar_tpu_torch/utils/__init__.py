from tstar_tpu_torch.utils.config import SearchConfig  # noqa: F401
