"""On a CUDA device only: each CUDA kernel against its plain PyTorch
version: the quant_matmul kernels through every loop the launcher picks
(the decode loop also row by row against M = 1 calls and under graph
replay), their grouped launch over the experts of an MoE layer at
qwen3-moe-30b-a3b's and granite-moe-1b-a400m's shapes, the attention
kernels at ragged shapes, and the attention uses of the vlm, audio and
hybrid families (unmasked flash over S != T keys, paged attention over
the encoder K/V, a hybrid decode step against the masked attention).
Imports no JAX,
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
    in bf16 takes the decode loop (M <= 8) and the wgmma loop; (320, 200)
    and f32 take the tile loop, with ragged M/N/K edges. f32 at
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
        K._launch(name, name, plan, x, wargs, out, M, N, Kd, *extra, 1)
        ref = getattr(K, name + "_plain")(x, *wargs)
        torch.cuda.synchronize()
        assert _rel(out, ref) < 1e-2, name


def _decode_case(M, Kd, N, seed):
    """x (M, Kd) bf16 and the weight quantized as int8 and as nf4 with
    blocks 64 and 32: (name, weight tensors) for each."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((M, Kd), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((Kd, N), generator=gen, device="cuda") * Kd ** -0.5
    q8 = pt_int8.quantize_int8(w)
    cases = [("int8_matmul", (q8.codes, q8.scale))]
    for block in (64, 32):
        q4 = pt_nf4.quantize_nf4(w, block)
        cases.append(("nf4_matmul", (q4.packed, q4.absmax)))
    return x, cases


def _blocks_per_tile(plan, N, Kd):
    """The most blocks any column tile's K steps fall to."""
    per = {}
    for b, t, _, _ in K.decode_segments(plan, N, Kd):
        per.setdefault(t, set()).add(b)
    return max(len(bs) for bs in per.values())


@pytest.mark.gpu
@pytest.mark.parametrize("Kd,N,split", [(64, 208, "one"), (128, 16, "two"),
                                        (640, 400, "many"),
                                        (4096, 1040, "many")])
@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 6, 7, 8])
def test_cuda_decode_loop_matches_plain(M, Kd, N, split):
    """On the card: the bf16 decode loop (TMA ring, products on the tensor
    cores, the K steps split among the blocks) against the plain versions
    for int8 and nf4 with blocks 64 and 32, at M = 1..8 and shapes whose
    column tiles fall to one block, two, or many (several K ranges a
    tile, blocks that cross tile boundaries, N no multiple of 128). 1e-2
    relative (one bf16 rounding of f32 sums taken in other orders)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plan = K._device_plan(M, N, Kd, True, None, True, 0)
    assert plan.loop == "decode"
    most = _blocks_per_tile(plan, N, Kd)
    assert {"one": most == 1, "two": most == 2, "many": most > 2}[split]
    x, cases = _decode_case(M, Kd, N, M + Kd + N)
    for name, wargs in cases:
        before = K.LOOP_LAUNCHES[name]["decode"]
        got = getattr(K, name)(x, *wargs)
        ref = getattr(K, name + "_plain")(x, *wargs)
        torch.cuda.synchronize()
        assert K.LOOP_LAUNCHES[name]["decode"] == before + 1
        assert _rel(got, ref) < 1e-2, name


@pytest.mark.gpu
@pytest.mark.parametrize("Kd,N", [(4096, 1024), (640, 400), (14336, 4096)])
def test_cuda_decode_rows_do_not_depend_on_the_batch(Kd, N):
    """On the card: row i of an M = 4 decode call is, bit for bit, an
    M = 1 call on row i alone (the plan and every sum's order do not
    depend on M), and a second call gives the same bits, for int8 and
    nf4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, cases = _decode_case(4, Kd, N, Kd + N)
    for name, wargs in cases:
        fn = getattr(K, name)
        got = fn(x, *wargs)
        again = fn(x, *wargs)
        rows = [fn(x[i:i + 1].contiguous(), *wargs) for i in range(4)]
        torch.cuda.synchronize()
        assert torch.equal(got, again), name
        for i in range(4):
            assert torch.equal(got[i:i + 1], rows[i]), (name, i)


@pytest.mark.gpu
def test_cuda_decode_replays_in_a_graph():
    """On the card: a decode call whose tiles are split among many blocks,
    captured in a CUDA graph and replayed twice with new x copied into
    the captured input, gives what an eager call gives each time, and
    leaves every counter of the merge at 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, cases = _decode_case(4, 4096, 1040, 9)
    gen = torch.Generator(device="cuda").manual_seed(10)
    for name, wargs in cases:
        fn = getattr(K, name)
        fn(x, *wargs)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = fn(x, *wargs)
        for _ in range(2):
            x.copy_(torch.randn(x.shape, generator=gen, device="cuda"))
            g.replay()
            want = fn(x, *wargs)
            torch.cuda.synchronize()
            assert torch.equal(out, want), name
            assert _rel(out, getattr(K, name + "_plain")(x, *wargs)) < 1e-2
            counters = K.cuda_build.counters(x.device, 1)
            assert not counters.any(), name


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 4, 8])
def test_cuda_decode_call_is_one_kernel_node(M):
    """On the card: one decode call (its workspace from the caching
    allocator, the counters made before) captured in a CUDA graph is one
    kernel node and nothing else, as chip_smoke checks the attention
    kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    x, cases = _decode_case(M, 4096, 1024, 12)
    for name, wargs in cases:
        fn = getattr(K, name)
        assert chip_smoke.graph_nodes(torch, lambda: fn(x, *wargs)) == [0]


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


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,T,H,Kv,d,causal,window", [
    (1, 37, 37, 64, 1, 128, True, None),     # G = 64: 2 positions a block
    (1, 300, 300, 8, 8, 64, True, None),     # G = 1: 128 positions a block
    (2, 50, 333, 8, 2, 128, False, None),    # ragged T past S, no mask
    (1, 70, 200, 4, 1, 64, True, 33),        # causal over T > S, a window
    (1, 2049, 2049, 32, 8, 128, True, None),  # one past a tile, long
    (3, 5, 5, 7, 1, 128, True, None),        # G = 7, bq = 18 > S
])
def test_cuda_flash_wgmma_matches_plain(B, S, T, H, Kv, d, causal, window):
    """On the card: the bf16 TMA + wgmma kernel at G = 1, 7 and 64 (2 to
    128 positions a block), d = 64 and 128, T other than S, a window and
    a long causal row, against the plain version row by row at 1e-2
    (one bf16 rounding of p and of the output)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import kernel as FK
    gen = torch.Generator(device="cuda").manual_seed(S + T)
    q = torch.randn((B, S, H, d), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((B, T, Kv, d), generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    got = FK.flash_attention(q, k, v, causal=causal, window=window)
    ref = FK.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert _row_rel(got, ref) < 1e-2


@pytest.mark.gpu
def test_cuda_flash_wgmma_keeps_to_its_batch_row():
    """On the card: B = 2 with S = 100, not a multiple of the 32 positions
    of a block at G = 4, and batch 1's K and V a thousand times batch
    0's: a box that read past S into the next sequence, or before it,
    would move batch 0's rows far past 1e-2 (and batch 1's scores would
    overflow batch 0's softmax). Each batch row also equals the same
    sequence run alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import kernel as FK
    gen = torch.Generator(device="cuda").manual_seed(100)
    B, S, H, Kv, d = 2, 100, 32, 8, 128
    q = torch.randn((B, S, H, d), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((B, S, Kv, d), generator=gen, device="cuda")
            for _ in range(2))
    k[1] *= 1000.0
    v[1] *= 1000.0
    k, v = k.bfloat16(), v.bfloat16()
    got = FK.flash_attention(q, k, v, causal=False)
    ref = FK.flash_attention_plain(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert _row_rel(got, ref) < 1e-2
    for b in range(B):
        alone = FK.flash_attention(q[b:b + 1].contiguous(),
                                   k[b:b + 1].contiguous(),
                                   v[b:b + 1].contiguous(), causal=False)
        torch.cuda.synchronize()
        assert torch.equal(alone[0], got[b])


@pytest.mark.gpu
def test_cuda_flash_wgmma_replays_in_a_graph():
    """On the card: the bf16 kernel captured in a CUDA graph and replayed
    twice over new inputs copied into the captured tensors gives, each
    time, what an eager launch gives on those inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import kernel as FK
    gen = torch.Generator(device="cuda").manual_seed(5)
    shape_q, shape_kv = (2, 130, 32, 128), (2, 130, 8, 128)
    q = torch.randn(shape_q, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn(shape_kv, generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    FK.flash_attention(q, k, v)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = FK.flash_attention(q, k, v)
    for _ in range(2):
        for t in (q, k, v):
            t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
        g.replay()
        want = FK.flash_attention(q, k, v)
        torch.cuda.synchronize()
        assert torch.equal(out, want)
        assert _row_rel(out, FK.flash_attention_plain(q, k, v)) < 1e-2


def _paged_case(page, H, Kv, d, td, seed, poison):
    """A pool of 4 rows of pages, ragged lengths (full, full - 3, 0, a
    third), one unassigned page, one page id at n_pool, and, with
    ``poison``, NaN in every slot the kernel must not read."""
    B, n_max = 4, max(2, 300 // page)
    n_pool = B * n_max
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kp, vp = (torch.randn((n_pool, page, Kv, d), generator=gen,
                          device="cuda").to(td) for _ in range(2))
    q = torch.randn((B, H, d), generator=gen, device="cuda").to(td)
    pt = torch.randperm(n_pool, generator=gen, device="cuda") \
        .view(B, n_max).to(torch.int32)
    full = n_max * page
    sl = torch.tensor([full, full - 3, 0, max(1, full // 3)],
                      dtype=torch.int32, device="cuda")
    pt[1, n_max // 2] = -1
    pt[3, 0] = n_pool                 # past the pool: masked, never read
    if poison:
        used = torch.zeros((n_pool, page), dtype=torch.bool, device="cuda")
        slot = torch.arange(full, device="cuda")
        for b in range(B):
            ids = pt[b].long().repeat_interleave(page)
            ok = (slot < sl[b]) & (ids >= 0) & (ids < n_pool)
            used[ids[ok], slot[ok] % page] = True
        kp[~used] = float("nan")
        vp[~used] = float("nan")
    return q, kp, vp, pt, sl


def _paged_plain(PK, q, kp, vp, pt, sl):
    """The plain version (which reads page 0 for a masked page) with the
    page id past the pool masked as -1 and the NaN of never-read slots
    out of its way."""
    pt = torch.where(pt >= kp.shape[0], -1, pt)
    return PK.paged_attention_plain(q, torch.nan_to_num(kp),
                                    torch.nan_to_num(vp), pt, sl)


@pytest.mark.gpu
@pytest.mark.parametrize("page,H,Kv,d", [(8, 32, 8, 128), (29, 14, 2, 64),
                                         (261, 32, 8, 128), (64, 4, 4, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_paged_never_reads_a_masked_slot(page, H, Kv, d, dtype):
    """On the card: every slot past a row's length, of an unassigned page
    or of a page id at n_pool holds NaN; the kernel's output stays finite
    and matches the plain version row by row (bf16 1e-2, f32 1e-5), the
    row of length 0 is 0, and the call is one launch. Pages of 8, 29, 261
    (several boxes a page) and 64 slots; G = 4, 7 and 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.paged_attention import kernel as PK
    td = getattr(torch, dtype)
    q, kp, vp, pt, sl = _paged_case(page, H, Kv, d, td, page + d, True)
    before = PK.LAUNCHES["paged_attention"]
    got = PK.paged_attention(q, kp, vp, pt, sl)
    torch.cuda.synchronize()
    assert PK.LAUNCHES["paged_attention"] == before + 1
    assert torch.isfinite(got.float()).all()
    assert not got[2].float().any()
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert _row_rel(got, _paged_plain(PK, q, kp, vp, pt, sl)) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_paged_replays_in_a_graph_with_new_lengths(dtype):
    """On the card: one paged call over 4 rows of 4096 slots (several
    splits a row, so the last split merges them through the counter)
    captured in a CUDA graph and replayed twice with other lengths
    written into the captured seq_lens: each replay matches the plain
    version, which it could not if a replay found the counters of the
    one before not reset to 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.paged_attention import kernel as PK
    td = getattr(torch, dtype)
    B, H, Kv, d, page, n_max = 4, 32, 8, 128, 64, 64
    gen = torch.Generator(device="cuda").manual_seed(11)
    kp, vp = (torch.randn((B * n_max, page, Kv, d), generator=gen,
                          device="cuda").to(td) for _ in range(2))
    q = torch.randn((B, H, d), generator=gen, device="cuda").to(td)
    pt = torch.arange(B * n_max, dtype=torch.int32,
                      device="cuda").view(B, n_max)
    sl = torch.tensor([4096, 3000, 17, 2048], dtype=torch.int32,
                      device="cuda")
    min_split = PK.MIN_SPLIT if td == torch.bfloat16 else PK.MIN_SPLIT_F32
    assert PK._launch_plan(B, Kv, n_max * page, q.get_device(),
                           min_split)[1] > 1
    PK.paged_attention(q, kp, vp, pt, sl)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = PK.paged_attention(q, kp, vp, pt, sl)
    tol = 1e-5 if dtype == "float32" else 1e-2
    for lens in ([1, 4096, 2500, 64], [4000, 65, 0, 3333]):
        sl.copy_(torch.tensor(lens, dtype=torch.int32))
        g.replay()
        torch.cuda.synchronize()
        assert _row_rel(out, PK.paged_attention_plain(q, kp, vp, pt, sl)) \
            < tol


def _graph_nodes(fn) -> list:
    """chip_smoke's reading of one captured call's CUDA graph nodes."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke.graph_nodes(torch, fn)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [96, 120])
@pytest.mark.parametrize("B,S,H,Kv,causal,window", [
    (1, 81, 32, 8, True, None),      # ragged S, G = 4 (h2o-danube's heads)
    (2, 130, 32, 32, True, 37),      # G = 1 (phi-3-vision's heads), window
    (1, 200, 8, 2, False, None),     # no mask
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_head_dims_96_and_120(B, S, H, Kv, causal,
                                                   window, d, dtype):
    """On the card: head_dim 96 and 120 (the 128-column instance with the
    columns past d zero-filled) against the plain version row by row,
    f32 at 1e-5 and bf16 at 1e-2 as at d = 64 and 128; one launch a
    call, and one kernel node under graph capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import kernel as FK
    td = getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 1e-2
    q, k, v = _flash_inputs(B, S, H, Kv, d, td, S + d)
    before = FK.LAUNCHES["flash_attention"]
    got = FK.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FK.LAUNCHES["flash_attention"] == before + 1
    ref = FK.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.shape == (B, S, H, d) and got.dtype == td
    assert torch.isfinite(got.float()).all()
    assert _row_rel(got, ref) < tol
    assert _graph_nodes(lambda: FK.flash_attention(
        q, k, v, causal=causal, window=window)) == [0]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_head_dim_120_sees_the_mask_edge(dtype):
    """On the card, d = 120: a control, the plain version without each
    row's diagonal key, reads above the tolerance over the second half of
    the rows while the kernel reads below it, so the check would see a
    one-key error at the mask edge."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models.layers import attention
    td = getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 1e-2
    B, S, H, Kv, d = 2, 256, 32, 8, 120
    q, k, v = _flash_inputs(B, S, H, Kv, d, td, 120)
    got = FK.flash_attention(q, k, v, causal=True)
    ref = FK.flash_attention_plain(q, k, v, causal=True)
    pos = torch.arange(S, device="cuda")
    ctrl = attention(q, k, v, causal=True,
                     mask=(pos[None, :] < pos[:, None])[None])
    torch.cuda.synchronize()
    assert _row_rel(got, ref) < tol
    assert _row_rel(ctrl[:, S // 2:], ref[:, S // 2:]) > tol


@pytest.mark.gpu
@pytest.mark.parametrize("page,H,Kv,d", [(8, 32, 8, 120), (29, 32, 32, 96),
                                         (261, 32, 8, 120), (64, 8, 2, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_paged_attention_head_dims_96_and_120(page, H, Kv, d, dtype):
    """On the card: head_dim 96 and 120 with NaN in every slot the kernel
    must not read (ragged lengths, a row of length 0, an unassigned page,
    a page id at n_pool): finite, row by row against the plain version at
    the d = 64 and 128 tolerances, one launch a call, one kernel node
    under graph capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.paged_attention import kernel as PK
    td = getattr(torch, dtype)
    q, kp, vp, pt, sl = _paged_case(page, H, Kv, d, td, page + d, True)
    before = PK.LAUNCHES["paged_attention"]
    got = PK.paged_attention(q, kp, vp, pt, sl)
    torch.cuda.synchronize()
    assert PK.LAUNCHES["paged_attention"] == before + 1
    assert got.shape == (4, H, d) and torch.isfinite(got.float()).all()
    assert not got[2].float().any()
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert _row_rel(got, _paged_plain(PK, q, kp, vp, pt, sl)) < tol
    assert _graph_nodes(lambda: PK.paged_attention(q, kp, vp, pt, sl)) \
        == [0]


@pytest.mark.gpu
@pytest.mark.parametrize("d", [96, 120])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_paged_head_dims_merge_their_splits(d, dtype):
    """On the card: 4 rows of 4096 slots (several splits a row, merged by
    the last through the counter, the scratch sized for the 128-column
    instance) at d = 96 and 120 match the plain version, and the counters
    are back at 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.paged_attention import kernel as PK
    td = getattr(torch, dtype)
    B, H, Kv, page, n_max = 4, 32, 8, 64, 64
    gen = torch.Generator(device="cuda").manual_seed(d)
    kp, vp = (torch.randn((B * n_max, page, Kv, d), generator=gen,
                          device="cuda").to(td) for _ in range(2))
    q = torch.randn((B, H, d), generator=gen, device="cuda").to(td)
    pt = torch.arange(B * n_max, dtype=torch.int32,
                      device="cuda").view(B, n_max)
    sl = torch.tensor([4096, 3000, 17, 2048], dtype=torch.int32,
                      device="cuda")
    min_split = PK.MIN_SPLIT if td == torch.bfloat16 else PK.MIN_SPLIT_F32
    assert PK._launch_plan(B, Kv, n_max * page, q.get_device(),
                           min_split)[1] > 1
    got = PK.paged_attention(q, kp, vp, pt, sl)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert _row_rel(got, PK.paged_attention_plain(q, kp, vp, pt, sl)) < tol
    assert not PK.cuda_build.counters(q.device, B * Kv).any()


@pytest.mark.gpu
def test_cuda_attention_refuses_other_head_dims():
    """On the card: head_dim 80 raises in both wrappers before any launch,
    with no fallback to the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.paged_attention import kernel as PK
    q, k, v = _flash_inputs(1, 16, 4, 2, 80, torch.bfloat16, 0)
    before = FK.LAUNCHES["flash_attention"], PK.LAUNCHES["paged_attention"]
    with pytest.raises(ValueError, match="head_dim 80"):
        FK.flash_attention(q, k, v)
    pages = torch.zeros((2, 8, 2, 80), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="head_dim 80"):
        PK.paged_attention(q[:, 0], pages, pages,
                           torch.zeros((1, 2), dtype=torch.int32,
                                       device="cuda"),
                           torch.ones((1,), dtype=torch.int32,
                                      device="cuda"))
    assert (FK.LAUNCHES["flash_attention"],
            PK.LAUNCHES["paged_attention"]) == before


# ---------------------------------------------------------------------------
# the grouped launch: every expert of an MoE projection in one launch
# ---------------------------------------------------------------------------
def _grouped_case(E, C, Kd, N, seed, td=torch.bfloat16):
    """x (E, C, Kd) and an (E, Kd, N) weight quantized as int8 and as nf4
    (block 64): (entry point, weight tensors) for each."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((E, C, Kd), generator=gen, device="cuda").to(td)
    w = torch.randn((E, Kd, N), generator=gen, device="cuda") * Kd ** -0.5
    q8 = pt_int8.quantize_int8(w)
    q4 = pt_nf4.quantize_nf4(w, 64)
    return x, [("int8_matmul", (q8.codes, q8.scale)),
               ("nf4_matmul", (q4.packed, q4.absmax))]


@pytest.mark.gpu
@pytest.mark.parametrize("E,C,Kd,N", [
    (128, 8, 2048, 768), (128, 8, 768, 2048),       # qwen3 decode
    (128, 40, 2048, 768), (128, 40, 768, 2048),     # qwen3 prefill
    (32, 8, 1024, 512), (32, 8, 512, 1024),         # granite decode
    (32, 160, 1024, 512), (32, 160, 512, 1024),     # granite prefill
    (3, 5, 320, 208), (3, 130, 320, 208)])          # ragged C and N
def test_cuda_grouped_matches_plain(E, C, Kd, N):
    """On the card: one grouped call over all experts against the plain
    grouped version at qwen3-moe-30b-a3b's and granite-moe-1b-a400m's
    expert shapes, on the decode loop for C <= 8 and the wgmma loop
    above, one launch a call; 1e-2 relative (one bf16 rounding of f32
    sums taken in other orders)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, cases = _grouped_case(E, C, Kd, N, E + C + N)
    loop = "decode" if C <= 8 else "wgmma"
    for name, wargs in cases:
        entry = name + "_grouped"
        before = dict(K.LOOP_LAUNCHES[entry])
        launches = K.LAUNCHES[entry]
        got = getattr(K, entry)(x, *wargs)
        ref = getattr(K, name + "_plain")(x, *wargs)
        torch.cuda.synchronize()
        assert K.LAUNCHES[entry] == launches + 1
        assert K.LOOP_LAUNCHES[entry][loop] == before[loop] + 1
        assert got.shape == (E, C, N)
        assert _rel(got, ref) < 1e-2, entry
        # every expert holds its own product, not a neighbour's
        worst = max(_rel(got[e], ref[e]) for e in (0, E // 2, E - 1))
        assert worst < 1e-2, entry


@pytest.mark.gpu
def test_cuda_grouped_decode_rows_do_not_depend_on_the_batch():
    """On the card: row i of each expert of a C = 4 grouped decode call
    is, bit for bit, a C = 1 call on that row (the grouped plan and every
    sum's order do not depend on C)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, cases = _grouped_case(16, 4, 768, 2048, 3)
    for name, wargs in cases:
        fn = getattr(K, name + "_grouped")
        got = fn(x, *wargs)
        for i in range(4):
            row = fn(x[:, i:i + 1].contiguous(), *wargs)
            torch.cuda.synchronize()
            assert torch.equal(got[:, i:i + 1], row), (name, i)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [4, 40])
def test_cuda_grouped_call_is_one_kernel_node(C):
    """On the card: one grouped call captured in a CUDA graph is one
    kernel node and nothing else, and replays of it with new x give the
    eager result, the merge's counters back at 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, cases = _grouped_case(128, C, 2048, 768, 5)
    gen = torch.Generator(device="cuda").manual_seed(6)
    for name, wargs in cases:
        fn = getattr(K, name + "_grouped")
        assert _graph_nodes(lambda: fn(x, *wargs)) == [0]
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = fn(x, *wargs)
        x.copy_(torch.randn(x.shape, generator=gen, device="cuda"))
        g.replay()
        want = fn(x, *wargs)
        torch.cuda.synchronize()
        assert torch.equal(out, want), name
        assert not K.cuda_build.counters(x.device, 1).any(), name


@pytest.mark.gpu
def test_cuda_grouped_float32_takes_the_tile_loop():
    """On the card: f32 compute runs the grouped form on the CUDA-core
    tile loop (one grid layer per expert) at 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, cases = _grouped_case(5, 9, 256, 208, 8, td=torch.float32)
    for name, wargs in cases:
        entry = name + "_grouped"
        before = K.LOOP_LAUNCHES[entry]["tile"]
        got = getattr(K, entry)(x, *wargs, torch.float32)
        ref = getattr(K, name + "_plain")(x, *wargs, torch.float32)
        torch.cuda.synchronize()
        assert K.LOOP_LAUNCHES[entry]["tile"] == before + 1
        assert _rel(got, ref) < 1e-5, entry


@pytest.mark.gpu
def test_cuda_grouped_bf16_refuses_what_no_loop_takes():
    """On the card: a bf16 grouped call the Hopper loops do not take (K
    not a multiple of 64) raises before any launch, with no fallback to
    the plain version or a loop of 2-D calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn((2, 8, 96), generator=gen, device="cuda").to(
        torch.bfloat16)
    q8 = pt_int8.quantize_int8(
        torch.randn((2, 96, 64), generator=gen, device="cuda"))
    before = dict(K.LAUNCHES)
    with pytest.raises(ValueError, match="no grouped bf16 kernel"):
        K.int8_matmul_grouped(x, q8.codes, q8.scale)
    assert K.LAUNCHES == before


def _dispatch_rows(E, C, T, top_k, seed):
    """Each expert's kept rows of a seeded top-k routing of T tokens
    through the port's capacity dispatch (int32 (E,) on the card)."""
    from repro_torch.models.moe import _dispatch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((T, 64), generator=gen, device="cuda")
    w_router = torch.randn((64, E), generator=gen, device="cuda")
    return _dispatch(x, w_router, top_k, E, C)[1][-1]


def _rows_cases(E, C, seed):
    """(label, rows) of a grouped call: the dispatch's counts of a top-8
    routing (4 tokens at C <= 8, a prefill's 8 C E / 10 above), counts
    drawn in 0..C with every third expert at 0, and no expert kept."""
    T = 4 if C <= 8 else max(1, 8 * C * E // 80)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    drawn = torch.randint(0, C + 1, (E,), generator=gen, device="cuda",
                          dtype=torch.int32)
    drawn[::3] = 0
    return [("dispatch", _dispatch_rows(E, C, T, min(8, E), seed)),
            ("drawn", drawn),
            ("none", torch.zeros(E, dtype=torch.int32, device="cuda"))]


@pytest.mark.gpu
@pytest.mark.parametrize("E,C,Kd,N", [
    (128, 8, 2048, 768), (128, 8, 768, 2048),       # qwen3 decode
    (128, 40, 2048, 768),                           # qwen3 prefill
    (32, 8, 1024, 512), (32, 160, 512, 1024),       # granite
    (3, 5, 320, 208), (3, 130, 320, 208)])          # ragged C and N
def test_cuda_grouped_rows_match_plain(E, C, Kd, N):
    """On the card: a grouped call given each expert's kept rows (the
    dispatch's counts, drawn counts, none kept) against the plain version
    with the same rows at 1e-2 relative, one launch a call, and the rows
    at or past each count exactly zero, though x's rows there are not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, cases = _grouped_case(E, C, Kd, N, 7 * E + C)
    for label, rows in _rows_cases(E, C, E + C):
        past = (torch.arange(C, device="cuda") >= rows[:, None])
        for name, wargs in cases:
            entry = name + "_grouped"
            launches = K.LAUNCHES[entry]
            got = getattr(K, entry)(x, *wargs, rows=rows)
            ref = getattr(K, name + "_plain")(x, *wargs, rows=rows)
            torch.cuda.synchronize()
            assert K.LAUNCHES[entry] == launches + 1
            assert not got[past].any(), (entry, label)
            if label != "none":
                assert _rel(got, ref) < 1e-2, (entry, label)


@pytest.mark.gpu
def test_cuda_grouped_float32_rows_take_the_tile_loop():
    """On the card: f32 compute with kept rows on the CUDA-core tile loop
    at 1e-5, zeros past the counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, cases = _grouped_case(5, 9, 256, 208, 8, td=torch.float32)
    rows = torch.tensor([0, 9, 3, 1, 8], dtype=torch.int32, device="cuda")
    past = torch.arange(9, device="cuda") >= rows[:, None]
    for name, wargs in cases:
        got = getattr(K, name + "_grouped")(x, *wargs, torch.float32, rows)
        ref = getattr(K, name + "_plain")(x, *wargs, torch.float32, rows)
        torch.cuda.synchronize()
        assert not got[past].any(), name
        assert _rel(got, ref) < 1e-5, name


@pytest.mark.gpu
@pytest.mark.parametrize("E,C,Kd,N", [(128, 8, 2048, 768),
                                      (128, 8, 768, 2048),
                                      (32, 8, 1024, 512),
                                      (128, 40, 2048, 768)])
def test_cuda_grouped_expert_rows_do_not_depend_on_the_others(E, C, Kd, N):
    """On the card: one expert's kept rows are, bit for bit, the same
    when it is the only expert kept, among the dispatch's experts, among
    all (every count C) and with rows=None: each tile's K segments and
    their order are fixed by the shapes alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, cases = _grouped_case(E, C, Kd, N, 11)
    rows = _dispatch_rows(E, C, 4 if C <= 8 else 8 * C * E // 80, 8, 12)
    rows[5] = min(3, C)
    alone = torch.zeros_like(rows)
    alone[5] = rows[5]
    full = torch.full_like(rows, C)
    r = int(rows[5])
    for name, wargs in cases:
        fn = getattr(K, name + "_grouped")
        outs = [fn(x, *wargs, rows=rs)[5, :r] for rs in (alone, rows, full)]
        outs.append(fn(x, *wargs)[5, :r])
        torch.cuda.synchronize()
        for o in outs[1:]:
            assert torch.equal(outs[0], o), name


@pytest.mark.gpu
@pytest.mark.parametrize("C", [4, 40])
def test_cuda_grouped_rows_call_is_one_kernel_node(C):
    """On the card: a grouped call with rows, captured in a CUDA graph, is
    one kernel node and nothing else; replays read the rows tensor as it
    stands (new counts, written in place, give the eager result), and
    the merge's counters are back at 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, cases = _grouped_case(128, C, 2048, 768, 5)
    rows = _dispatch_rows(128, C, 4, 8, 13)
    for name, wargs in cases:
        fn = getattr(K, name + "_grouped")
        assert _graph_nodes(lambda: fn(x, *wargs, rows=rows)) == [0]
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = fn(x, *wargs, rows=rows)
        rows.copy_(_dispatch_rows(128, C, 4, 8, 14))
        g.replay()
        want = fn(x, *wargs, rows=rows)
        torch.cuda.synchronize()
        assert torch.equal(out, want), name
        assert not K.cuda_build.counters(x.device, 1).any(), name


@pytest.mark.gpu
def test_cuda_grouped_rows_on_another_device_raise():
    """On the card: rows on the CPU, or of another dtype or shape, with x
    on the card raise before any launch; nothing falls back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, cases = _grouped_case(4, 8, 256, 128, 15)
    bad = [torch.ones(4, dtype=torch.int32),
           torch.ones(4, dtype=torch.int64, device="cuda"),
           torch.ones(3, dtype=torch.int32, device="cuda")]
    for name, wargs in cases:
        entry = name + "_grouped"
        before = K.LAUNCHES[entry]
        for rows in bad:
            with pytest.raises((ValueError, TypeError), match="rows"):
                getattr(K, entry)(x, *wargs, rows=rows)
        assert K.LAUNCHES[entry] == before


# ---------------------------------------------------------------------------
# the vlm, audio and hybrid families' attention uses
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("S,T", [(256, 64), (37, 64), (64, 64), (1, 61)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_without_mask_at_seamless_heads(S, T, dtype):
    """On the card: flash attention without a mask at
    seamless-m4t-large-v2's heads (16/16/64), S queries over T keys: the
    decoder's cross-attention (S other than T, T = 64 or 61 frames) and
    the encoder (S = T). Row by row, tolerances as above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import kernel as FK
    td = getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 1e-2
    gen = torch.Generator(device="cuda").manual_seed(S * T)
    q = torch.randn((2, S, 16, 64), generator=gen, device="cuda").to(td)
    k, v = (torch.randn((2, T, 16, 64), generator=gen, device="cuda").to(td)
            for _ in range(2))
    before = FK.LAUNCHES["flash_attention"]
    got = FK.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert FK.LAUNCHES["flash_attention"] == before + 1
    ref = FK.flash_attention_plain(q, k, v, causal=False)
    assert torch.isfinite(got.float()).all()
    assert _row_rel(got, ref) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("T_enc", [37, 61, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_paged_over_encoder_kv(T_enc, dtype):
    """On the card: a decode step's cross-attention, the paged kernel over
    the encoder K/V (L, B, T_enc, Kv, hd) viewed as pages by
    ``encoder_kv_pages`` (one page a row when T_enc is no multiple of 8,
    seq_lens = T_enc for every row), layer by layer, against the plain
    version and against the direct attention over every frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.paged_attention import kernel as PK
    from repro_torch.models.layers import attention, encoder_kv_pages
    td = getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 1e-2
    L, B, Kv, hd = 2, 3, 16, 64
    gen = torch.Generator(device="cuda").manual_seed(T_enc)
    k, v = (torch.randn((L, B, T_enc, Kv, hd), generator=gen,
                        device="cuda").to(td) for _ in range(2))
    q = torch.randn((B, Kv, hd), generator=gen, device="cuda").to(td)
    k_pages, v_pages, table, lens = encoder_kv_pages(k, v)
    assert lens.tolist() == [T_enc] * B
    assert k_pages.data_ptr() == k.data_ptr()          # a view, no copy
    for i in range(L):
        got = PK.paged_attention(q, k_pages[i], v_pages[i], table, lens)
        ref = PK.paged_attention_plain(q, k_pages[i], v_pages[i], table,
                                       lens)
        direct = attention(q[:, None], k[i], v[i])[:, 0]
        torch.cuda.synchronize()
        assert _row_rel(got, ref) < tol
        assert _row_rel(got, direct) < tol


@pytest.mark.gpu
def test_cuda_hybrid_decode_matches_masked_attention():
    """On the card: reduced zamba2-1.2b in float32, a right-padded prefill
    (lengths 12 and 9) with buf_len 8 (the rings take the prompt's 12 and
    wrap), then 8 decode steps whose attention at each site is the paged
    kernel over the site's ring, against the same steps from a copy of
    the cache with the direct attention under the decode mask (what the
    reference computes): logits within 2e-5 of their max |logit|, the
    same greedy tokens, and the paged kernel launched once a site and
    step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import kernel as PK
    from repro_torch.models import build_model
    from repro_torch.models import hybrid as phyb
    from repro_torch.models.layers import attention, decode_attention_mask
    cfg = get_config("zamba2-1.2b").reduced()
    model = build_model(cfg, fmt="float32", device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen,
                         device="cuda")
    lengths = torch.tensor([12, 9], dtype=torch.int32, device="cuda")
    _, cache = model.prefill(params, {"tokens": toks}, buf_len=8,
                             lengths=lengths)
    assert cache["shared_k"].shape[2] == 12
    masked_cache = {k: v.clone() for k, v in cache.items()}

    def masked(q, k_pages, v_pages, table, seq_lens):
        B, W = masked_cache["slot_pos"].shape
        k = k_pages.reshape(B, W, *k_pages.shape[2:])
        v = v_pages.reshape(B, W, *v_pages.shape[2:])
        allow = decode_attention_mask(masked_cache["slot_pos"],
                                      masked_cache["pos"], None)
        return attention(q[:, None], k, v, mask=allow[:, None, :])[:, 0]

    tok = toks[:, -1:]
    sites = phyb.n_attn_sites(cfg)
    for _ in range(8):
        before = PK.LAUNCHES["paged_attention"]
        got, cache = model.decode_step(params, tok, cache)
        assert PK.LAUNCHES["paged_attention"] == before + sites
        paged = phyb.paged_attention
        phyb.paged_attention = masked
        try:
            ref, masked_cache = model.decode_step(params, tok, masked_cache)
        finally:
            phyb.paged_attention = paged
        torch.cuda.synchronize()
        assert torch.equal(got.argmax(-1), ref.argmax(-1))
        assert _rel(got, ref) < 2e-5
        tok = ref.argmax(-1)[:, None]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,T,H,Kv,d,causal,window", [
    (1, 70, 70, 4, 2, 64, True, None), (2, 33, 33, 8, 2, 64, True, None),
    (2, 20, 33, 4, 4, 64, False, None), (1, 40, 70, 4, 2, 96, True, None),
    (1, 70, 40, 4, 1, 120, True, None), (1, 131, 131, 2, 1, 120, True, 64),
    (1, 200, 200, 4, 2, 128, True, None), (1, 2, 2, 2, 2, 64, True, None)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_backward_matches_plain(B, S, T, H, Kv, d, causal, window,
                                           dtype):
    """On the card: the backward kernel, through the autograd Function,
    against ``flash_attention_backward_plain`` on the forward kernel's
    output and logsumexp, at ragged S and T (S != T both ways), G = 1, 2
    and 4, head dims 64, 96, 120 and 128, windowed and unmasked: dq, dk
    and dv each within 1e-5 (f32: the same f32 sums in other orders) or
    1e-2 (bf16: each output rounded once) of its max |plain|; the forward
    with the logsumexp kept gives the output it gives without; the kernel
    is counted once a backward. ((2, 2) is the smallest shape whose dq and
    dk are not all zero: over a single key the softmax is constant, so
    they are 0 and the kernel and the plain version each return its
    rounding noise.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import kernel as FK
    td = getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 1e-2
    gen = torch.Generator(device="cuda").manual_seed(S + T + d)
    q, do = (torch.randn((B, S, H, d), generator=gen, device="cuda").to(td)
             for _ in range(2))
    k, v = (torch.randn((B, T, Kv, d), generator=gen, device="cuda").to(td)
            for _ in range(2))
    kw = dict(causal=causal, window=window)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = dict(FK.LAUNCHES)
    out = FK.flash_attention(*leaves, **kw)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert FK.LAUNCHES[FK.NAME] == before[FK.NAME] + 1
    assert FK.LAUNCHES[FK.BWD] == before[FK.BWD] + 1
    assert torch.equal(out.detach(), FK.flash_attention(q, k, v, **kw))
    _, lse = FK.flash_attention_forward(q, k, v, with_lse=True, **kw)
    ref = FK.flash_attention_backward_plain(q, k, v, out.detach(), lse, do,
                                            **kw)
    for got, want in zip(grads, ref):
        assert got.dtype == td and torch.isfinite(got.float()).all()
        assert _rel(got, want) < tol


@pytest.mark.gpu
def test_cuda_flash_backward_is_deterministic():
    """No atomics: two backward calls on the same inputs agree bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import kernel as FK
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, do = (torch.randn((2, 300, 8, 64), generator=gen, device="cuda")
             .bfloat16() for _ in range(2))
    k, v = (torch.randn((2, 300, 2, 64), generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    out, lse = FK.flash_attention_forward(q, k, v, with_lse=True)
    a = FK.flash_attention_backward(q, k, v, out, lse, do)
    b = FK.flash_attention_backward(q, k, v, out, lse, do)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,T,H,Kv,d,causal,window", [
    (1, 300, 300, 16, 2, 128, True, 100),
    (4, 1024, 1024, 32, 32, 64, True, None)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_backward_at_wide_cells(B, S, T, H, Kv, d, causal, window,
                                          dtype):
    """On the card, at head_dim 128 with G = 8 and a window (the bf16
    dK/dV pass walks eight heads a block, its query walk cut by the
    window) and at stablelm-1.6b's training shape: the backward kernel
    against ``flash_attention_backward_plain`` within 1e-5 (f32) or 1e-2
    (bf16) of each output's max |plain|, bit for bit the same on a second
    call, and three CUDA kernels a call (D, dK/dV, dQ)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import kernel as FK
    td = getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 1e-2
    gen = torch.Generator(device="cuda").manual_seed(S + H + d)
    q, do = (torch.randn((B, S, H, d), generator=gen, device="cuda").to(td)
             for _ in range(2))
    k, v = (torch.randn((B, T, Kv, d), generator=gen, device="cuda").to(td)
            for _ in range(2))
    kw = dict(causal=causal, window=window)
    out, lse = FK.flash_attention_forward(q, k, v, with_lse=True, **kw)
    got = FK.flash_attention_backward(q, k, v, out, lse, do, **kw)
    again = FK.flash_attention_backward(q, k, v, out, lse, do, **kw)
    ref = FK.flash_attention_backward_plain(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    for g, a, want in zip(got, again, ref):
        assert g.dtype == td and torch.isfinite(g.float()).all()
        assert torch.equal(g, a)
        assert _rel(g, want) < tol
    assert _graph_nodes(lambda: FK.flash_attention_backward(
        q, k, v, out, lse, do, **kw)) == [0, 0, 0]
