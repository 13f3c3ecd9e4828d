from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS, FAMILIES, INPUT_SHAPES, ModelConfig, ShapeConfig, get_config,
    get_shape, list_archs)
from repro_torch.configs.paper_zoo import PAPER_MODELS  # noqa: F401
