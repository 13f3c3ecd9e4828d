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
    takes the decode loop (M <= 8) and, in bf16, the wgmma loop; (320,
    200) and f32 take the tile loop, with ragged M/N/K edges. f32 at
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


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [(256, 128), (256, 64), (128, 128),
                                  (128, 64), (64, 128), (64, 64)])
@pytest.mark.parametrize("Kd,N", [(512, 208), (1024, 1040)])
@pytest.mark.parametrize("M", [9, 81, 130, 464])
def test_cuda_wgmma_loop_matches_plain(M, Kd, N, tile, monkeypatch):
    """On the card: the bf16 prefill loop (TMA ring + wgmma) at each of
    its six output tiles, forced through the plan, against the plain
    versions: int8, and nf4 with blocks 64 and 32. N is no multiple of
    128 (and 208 none of 64), so the last column tile reads past N; K
    spans 8 and 16 stages of the 4-stage ring; M is ragged. A grid of
    fewer blocks than tiles makes blocks walk several tiles. 1e-2
    relative (one bf16 rounding of f32 sums taken in other orders)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(K, "WG_TILES", (tile,))
    K._device_plan.cache_clear()
    try:
        gen = torch.Generator(device="cuda").manual_seed(M + N)
        x = torch.randn((M, Kd), generator=gen, device="cuda").to(
            torch.bfloat16)
        w = torch.randn((Kd, N), generator=gen, device="cuda") * 0.05
        q8 = pt_int8.quantize_int8(w)
        before = {n: dict(c) for n, c in K.LOOP_LAUNCHES.items()}
        got = K.int8_matmul(x, q8.codes, q8.scale)
        ref = K.int8_matmul_plain(x, q8.codes, q8.scale)
        torch.cuda.synchronize()
        assert _rel(got, ref) < 1e-2
        for block in (64, 32):
            q4 = pt_nf4.quantize_nf4(w, block)
            got = K.nf4_matmul(x, q4.packed, q4.absmax)
            ref = K.nf4_matmul_plain(x, q4.packed, q4.absmax)
            torch.cuda.synchronize()
            assert _rel(got, ref) < 1e-2, block
        assert K.LOOP_LAUNCHES["int8_matmul"]["wgmma"] == \
            before["int8_matmul"]["wgmma"] + 1
        assert K.LOOP_LAUNCHES["nf4_matmul"]["wgmma"] == \
            before["nf4_matmul"]["wgmma"] + 2
        plan = K._device_plan(M, N, Kd, True, None, True, x.get_device())
        assert (plan.loop, plan.bm, plan.bn) == ("wgmma", *tile)
    finally:
        K._device_plan.cache_clear()


@pytest.mark.gpu
def test_cuda_wgmma_loop_walks_several_tiles():
    """On the card: a grid of 3 blocks over 4 x 9 tiles of (128, 128), so
    every block walks 12 tiles through one ring, against the plain
    versions at 1e-2 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    M, Kd, N = 464, 1024, 1040
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((M, Kd), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((Kd, N), generator=gen, device="cuda") * 0.05
    q8 = pt_int8.quantize_int8(w)
    q4 = pt_nf4.quantize_nf4(w, 64)
    plan = K.Plan("wgmma", 128, 128, 3)
    for name, wargs, block in (("int8_matmul", (q8.codes, q8.scale), None),
                               ("nf4_matmul", (q4.packed, q4.absmax), 64)):
        out = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
        extra = (block,) if block else ()
        K._launch(name, plan, x.data_ptr(), wargs[0].data_ptr(),
                  wargs[1].data_ptr(), out.data_ptr(), M, N, Kd, *extra, 1)
        ref = getattr(K, name + "_plain")(x, *wargs)
        torch.cuda.synchronize()
        assert _rel(out, ref) < 1e-2, name


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
