from repro_torch.quant.int8 import (  # noqa: F401
    Int8Weight, dequantize_int8, int8_matmul, quantize_int8,
)
from repro_torch.quant.nf4 import (  # noqa: F401
    NF4_CODEBOOK, NF4Weight, dequantize_nf4, quantize_nf4,
)
# repro_torch.quant.apply is imported by its full name: it depends on the
# kernels package, which itself imports repro_torch.quant.nf4.
