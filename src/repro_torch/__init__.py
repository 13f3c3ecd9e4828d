"""PyTorch/CUDA port of the ``repro`` package, for one NVIDIA H100.

Module paths mirror ``repro``'s, so each counterpart is found by name.
The port imports ``torch`` and never ``jax`` or anything under
``repro``: the JAX package is the reference the tests hold it against.

Slice 1 serves the paper's dense decoders (``configs.paper_zoo``) under
the five precision formats. The int8 and nf4 projections run through
hand-written CUDA kernels (:mod:`repro_torch.kernels.quant_matmul`).
"""
