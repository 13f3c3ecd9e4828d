"""On a CUDA device only: each CUDA quant_matmul kernel against its plain
PyTorch version, through every loop the launcher picks. Imports no JAX,
so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.quant_matmul import kernel as K  # noqa: E402
from repro_torch.quant import int8 as pt_int8  # noqa: E402
from repro_torch.quant import nf4 as pt_nf4  # noqa: E402


def _rel(got, ref) -> float:
    got, ref = got.float().cpu(), ref.float().cpu()
    return ((got - ref).abs().max() / (ref.abs().max() + 1e-12)).item()


@pytest.mark.gpu
@pytest.mark.parametrize("Kd,N", [(512, 208), (320, 200)])
@pytest.mark.parametrize("M", [1, 5, 8, 9, 130])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain(M, dtype, Kd, N):
    """On the card: each CUDA kernel against its plain version. (512, 208)
    takes the decode loop (M <= 8) and, in bf16, the tensor-core loop;
    (320, 200) and f32 take the tile loop, with ragged M/N/K edges. f32 at
    1e-5; bf16 at 1e-2 relative (one bf16 rounding of f32 sums taken in
    other orders)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    td = getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 1e-2
    gen = torch.Generator(device="cuda").manual_seed(M)
    x = torch.randn((M, Kd), generator=gen, device="cuda").to(td)
    w = torch.randn((Kd, N), generator=gen, device="cuda") * 0.05
    q8 = pt_int8.quantize_int8(w)
    q4 = pt_nf4.quantize_nf4(w, 64)
    before = dict(K.LAUNCHES)
    got8 = K.int8_matmul(x, q8.codes, q8.scale, td)
    got4 = K.nf4_matmul(x, q4.packed, q4.absmax, td)
    torch.cuda.synchronize()
    assert K.LAUNCHES["int8_matmul"] == before["int8_matmul"] + 1
    assert K.LAUNCHES["nf4_matmul"] == before["nf4_matmul"] + 1
    assert _rel(got8, K.int8_matmul_plain(x, q8.codes, q8.scale, td)) < tol
    assert _rel(got4, K.nf4_matmul_plain(x, q4.packed, q4.absmax, td)) < tol
