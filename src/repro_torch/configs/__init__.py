from repro_torch.configs.base import FAMILIES, ModelConfig  # noqa: F401
from repro_torch.configs.paper_zoo import PAPER_MODELS  # noqa: F401
