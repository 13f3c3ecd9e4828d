from repro_torch.core.precision import (  # noqa: F401
    ALL_FORMATS, BFLOAT16, FLOAT16, FLOAT32, INT8, NF4, QUANTIZED_FORMATS,
    PrecisionPolicy, make_policy,
)
from repro_torch.core.profiler import (  # noqa: F401
    GenerateProfile, PhaseProfiler, WallClock,
)
