from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS, FAMILIES, ModelConfig, get_config, list_archs)
from repro_torch.configs.paper_zoo import PAPER_MODELS  # noqa: F401
