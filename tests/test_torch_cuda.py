"""On a CUDA device only: each CUDA kernel against its plain PyTorch
version: the quant_matmul kernels through every loop the launcher picks,
the attention kernels at ragged shapes. Imports no JAX,
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


def _row_rel(got, ref) -> float:
    """The worst output row (one query token and head): max |got - ref|
    over its max |ref|, so that a late row of a long causal sequence,
    whose values are far smaller than row 0's, is held to its own size."""
    diff = (got.float() - ref.float()).abs().amax(-1)
    return (diff / ref.float().abs().amax(-1).clamp_min(1e-30)).max().item()


def _flash_inputs(B, S, H, Kv, d, td, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=gen, device="cuda").to(td)
            for shape in ((B, S, H, d), (B, S, Kv, d), (B, S, Kv, d))]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,Kv,d", [(1, 81, 8, 2, 128), (2, 130, 4, 1, 64),
                                        (1, 175, 14, 2, 64), (1, 1, 4, 4, 128)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 37),
                                           (False, None)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_matches_plain(B, S, H, Kv, d, causal, window,
                                            dtype):
    """On the card: the flash kernel against its plain version at ragged
    lengths, G = 1, 4 and 7, d = 64 and 128, row by row. f32 at 1e-5
    relative (the same f32 sums in other orders); bf16 at 1e-2 (p and the
    output are rounded to bf16 once each: an output that lands across a
    rounding boundary is one ulp, at most 2^-7 of its row's largest
    value, away)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import kernel as FK
    td = getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 1e-2
    q, k, v = _flash_inputs(B, S, H, Kv, d, td, S)
    before = FK.LAUNCHES["flash_attention"]
    got = FK.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FK.LAUNCHES["flash_attention"] == before + 1
    ref = FK.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == td and torch.isfinite(got.float()).all()
    assert _row_rel(got, ref) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("page,H,Kv,d", [(8, 32, 8, 128), (29, 14, 2, 64),
                                         (64, 4, 1, 128), (261, 8, 2, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_paged_attention_matches_plain(page, H, Kv, d, dtype):
    """On the card: the paged kernel against its plain version with
    ragged lengths, an unassigned page, a row of length 0 and pages of
    8, 29, 64 and 261 slots. Row by row, tolerances as for flash
    attention."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.paged_attention import kernel as PK
    td = getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 1e-2
    B, n_max = 4, max(1, 300 // page)
    gen = torch.Generator(device="cuda").manual_seed(page)
    kp, vp = (torch.randn((B * n_max, page, Kv, d), generator=gen,
                          device="cuda").to(td) for _ in range(2))
    q = torch.randn((B, H, d), generator=gen, device="cuda").to(td)
    pt = torch.randperm(B * n_max, generator=gen, device="cuda") \
        .view(B, n_max).to(torch.int32)
    pt[1, n_max // 2] = -1
    full = n_max * page
    sl = torch.tensor([full, full - 3, 0, max(1, full // 3)],
                      dtype=torch.int32, device="cuda")
    before = PK.LAUNCHES["paged_attention"]
    got = PK.paged_attention(q, kp, vp, pt, sl)
    torch.cuda.synchronize()
    assert PK.LAUNCHES["paged_attention"] == before + 1
    ref = PK.paged_attention_plain(q, kp, vp, pt, sl)
    assert got.dtype == td and torch.isfinite(got.float()).all()
    assert not got[2].float().any()
    assert _row_rel(got, ref) < tol
