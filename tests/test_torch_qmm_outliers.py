"""LLM.int8's outlier product inside the int8 kernel
(``repro_torch.kernels.quant_matmul``): the plain version with outliers,
2-D and grouped, against the reference's ``ops.int8_matmul_kernel`` (the
Pallas kernel in interpret mode plus its XLA outlier product; under
``jax.vmap`` for the grouped form), f32 at 1e-5 and bf16 at 2e-2
relative; the CPU wrappers bit for bit against the separate product they
replace; the meta record against ``kernels/cost.py``. The tests marked
``gpu`` hold the CUDA kernel against its plain version on the card (every
loop, one launch a call, zeros past a grouped call's counts) and import
no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_qmm_outliers.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.op_analysis import OpCounter  # noqa: E402
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.kernels.quant_matmul import kernel as K  # noqa: E402
from repro_torch.kernels.quant_matmul import ops as pt_ops  # noqa: E402
from repro_torch.quant import int8 as pt_int8  # noqa: E402


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _weight(shape, seed, big_rows=(3, 17)):
    """A weight (..., K, N) with a few input rows 40x the rest, which the
    outlier split picks."""
    w = _rand(shape, seed, 0.05)
    for r in big_rows:
        w[..., r, :] *= 40
    return w


@pytest.fixture
def ref():
    """The reference's side, imported on the CPU only."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.quant_matmul import ops as jax_ops
    from repro.quant import quantize_int8
    import _torch_parity as tp
    return jax, jnp, jax_ops, quantize_int8, tp


def _carry(tp, q):
    return pt_int8.Int8Weight(*(tp.to_torch(a) for a in q))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("M,Kd,N,frac", [(1, 256, 128, 0.02),
                                         (8, 512, 64, 0.05),
                                         (40, 1024, 96, 0.08),
                                         (130, 256, 128, 0.01)])
def test_int8_plain_with_outliers_matches_reference(ref, M, Kd, N, frac,
                                                    dtype, tol):
    """2-D: n_out = 3, 26, 82 (two 64-outlier chunks) and 3 rows; the
    reference's Pallas kernel and its outlier product (f32 at 1e-5, bf16
    at 2e-2 relative: roundings of f32 sums taken in other orders)."""
    jax, jnp, jax_ops, quantize_int8, tp = ref
    x = _rand((M, Kd), 0)
    q = quantize_int8(jnp.asarray(_weight((Kd, N), 1)),
                      outlier_fraction=frac)
    assert q.outlier_idx.shape[0] == round(frac * Kd)
    want = jax_ops.int8_matmul_kernel(jnp.asarray(x), q,
                                      compute_dtype=getattr(jnp, dtype))
    pq = _carry(tp, q)
    got = K.int8_matmul_plain(torch.from_numpy(x), pq.codes, pq.scale,
                              getattr(torch, dtype), None, pq.outlier_idx,
                              pq.outlier_w)
    assert got.dtype == getattr(torch, dtype)
    assert tp.rel_err(got, want) < tol


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("C", [8, 40])
def test_grouped_plain_with_outliers_matches_reference(ref, C, dtype, tol):
    """E = 3 experts, each with its own outlier rows (n_out = 10 of
    K = 512), against the reference's ops under jax.vmap; with the
    dispatch's counts (x zero past them) the kept rows agree and the rest
    are exact zeros."""
    jax, jnp, jax_ops, quantize_int8, tp = ref
    E, Kd, N = 3, 512, 128
    x = _rand((E, C, Kd), 2)
    w = _weight((E, Kd, N), 3, big_rows=(5, 100))
    qs = [quantize_int8(jnp.asarray(w[e]), outlier_fraction=0.02)
          for e in range(E)]
    q = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *qs)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax.vmap(lambda x_, q_: jax_ops.int8_matmul_kernel(
        x_, q_, compute_dtype=jd))(jnp.asarray(x), q)
    pq = _carry(tp, q)
    got = K.int8_matmul_grouped(torch.from_numpy(x), pq.codes, pq.scale, td,
                                None, pq.outlier_idx, pq.outlier_w)
    assert got.shape == (E, C, N) and got.dtype == td
    assert tp.rel_err(got, want) < tol
    rows = torch.tensor([C, C // 2, 0], dtype=torch.int32)
    keep = (torch.arange(C) < rows[:, None])[..., None]
    got = K.int8_matmul_grouped(torch.from_numpy(x) * keep, pq.codes,
                                pq.scale, td, rows, pq.outlier_idx,
                                pq.outlier_w)
    assert not got[~keep.expand_as(got)].view(-1).float().any()
    for e in range(E):
        r = int(rows[e])
        if r:
            assert tp.rel_err(got[e, :r], np.asarray(want)[e, :r]) < tol


def _separate(x, q, cd):
    """The parent's path: the kernel's output without outliers, then the
    outlier columns of x, an f32 product, a rounding and an add."""
    x2 = x.reshape(-1, x.shape[-1]).to(cd)
    out = K.int8_matmul_plain(x2, q.codes, q.scale, cd)
    x_out = torch.index_select(x2, -1, q.outlier_idx.long())
    out = out + torch.matmul(x_out.float(),
                             q.outlier_w.to(cd).float()).to(out.dtype)
    return out.reshape(*x.shape[:-1], out.shape[-1])


def _separate_grouped(x, q, cd, rows=None):
    x3 = x.to(cd)
    out = K.int8_matmul_plain(x3, q.codes, q.scale, cd, rows)
    n_out = q.outlier_idx.shape[-1]
    cols = q.outlier_idx.long()[:, None, :].expand(*x3.shape[:2], n_out)
    return out + torch.bmm(torch.gather(x3, 2, cols).float(),
                           q.outlier_w.to(cd).float()).to(out.dtype)


@pytest.mark.parametrize("cd", [torch.bfloat16, torch.float32])
def test_cpu_wrappers_equal_the_separate_product(cd):
    """On the CPU the wrappers and the ops (2-D over a 3-D x, grouped
    with and without the dispatch's counts) give the bits of the product
    they replace, with no launch."""
    K.reset_launches()
    x = torch.from_numpy(_rand((2, 5, 256), 4))
    q = pt_int8.quantize_int8(torch.from_numpy(_weight((256, 96), 5)), 0.03)
    want = _separate(x, q, cd)
    assert torch.equal(pt_ops.int8_matmul_kernel(x, q, cd), want)
    assert torch.equal(K.int8_matmul(x[0].to(cd), q.codes, q.scale, cd,
                                     q.outlier_idx, q.outlier_w), want[0])
    xg = torch.from_numpy(_rand((3, 6, 256), 6))
    qg = pt_int8.quantize_int8(
        torch.from_numpy(_weight((3, 256, 96), 7, big_rows=(9,))), 0.03)
    assert torch.equal(pt_ops.int8_matmul_grouped_kernel(xg, qg, cd),
                       _separate_grouped(xg, qg, cd))
    rows = torch.tensor([6, 2, 0], dtype=torch.int32)
    xz = xg * (torch.arange(6) < rows[:, None])[..., None]
    assert torch.equal(pt_ops.int8_matmul_grouped_kernel(xz, qg, cd, rows),
                       _separate_grouped(xz, qg, cd, rows))
    assert not any(K.LAUNCHES.values())


def test_a_weight_without_outlier_rows_takes_the_plain_product():
    """n_out = 0: the ops pass no outlier argument, and the bits are the
    kernel's alone."""
    x = torch.from_numpy(_rand((4, 128), 8)).to(torch.bfloat16)
    q = pt_int8.quantize_int8(torch.from_numpy(_weight((128, 32), 9)), 0.0)
    assert q.outlier_idx.shape == (0,)
    assert torch.equal(pt_ops.int8_matmul_kernel(x, q),
                       K.int8_matmul_plain(x, q.codes, q.scale))


@pytest.mark.parametrize("grouped", [False, True])
def test_meta_record_is_the_cost_formula(grouped):
    """On the meta device under a cost analysis one call is one record:
    every weight field's bytes (the outlier rows and weights too) and the
    outlier product's FLOPs, by kernels/cost.py's formula, which prices
    chip_smoke's bound the same way."""
    E, M, Kd, N, n_out = (4, 8, 512, 256, 5) if grouped else (1, 9, 512,
                                                              256, 5)
    lead = (E,) if grouped else ()
    x = torch.empty((*lead, M, Kd), dtype=torch.bfloat16, device="meta")
    wargs = (torch.empty((*lead, Kd, N), dtype=torch.int8, device="meta"),
             torch.empty((*lead, N), device="meta"),
             torch.empty((*lead, n_out), dtype=torch.int32, device="meta"),
             torch.empty((*lead, n_out, N), dtype=torch.bfloat16,
                         device="meta"))
    fn = K.int8_matmul_grouped if grouped else K.int8_matmul
    with OpCounter() as c:
        if grouped:
            out = fn(x, wargs[0], wargs[1], torch.bfloat16, None, *wargs[2:])
        else:
            out = fn(x, *wargs[:2], torch.bfloat16, *wargs[2:])
    assert out.shape == (*lead, M, N) and out.device.type == "meta"
    wbytes = E * (Kd * N + 4 * N + 4 * n_out + 2 * n_out * N)
    nbytes, flops = cost.quant_matmul(M, Kd, N, wbytes, 2, E, n_out)
    assert flops == 2 * E * M * (Kd + n_out) * N
    assert (c.cost.dot_flops, c.cost.dot_bytes) == (flops, nbytes)
    assert c.cost.kernels == {fn.__name__: 1}


def test_int8_ops_record_one_fused_call_on_meta():
    """The ops' meta path: one int8 record with the outliers in it, and no
    separate product (no other FLOPs counted)."""
    x = torch.empty((2, 3, 256), dtype=torch.bfloat16, device="meta")
    q = pt_int8.Int8Weight(
        torch.empty((256, 64), dtype=torch.int8, device="meta"),
        torch.empty((64,), device="meta"),
        torch.empty((3,), dtype=torch.int32, device="meta"),
        torch.empty((3, 64), dtype=torch.bfloat16, device="meta"))
    with OpCounter() as c:
        out = pt_ops.int8_matmul_kernel(x, q)
    assert out.shape == (2, 3, 64)
    assert c.cost.kernels == {"int8_matmul": 1}
    assert c.cost.dot_flops == 2 * 6 * (256 + 3) * 64


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _rel(got, ref) -> float:
    got, ref = got.float().cpu(), ref.float().cpu()
    return ((got - ref).abs().max() / (ref.abs().max() + 1e-12)).item()


def _card_weight(gen, shape, frac):
    w = torch.randn(shape, generator=gen, device="cuda") * 0.05
    w[..., 3, :] *= 40
    return pt_int8.quantize_int8(w, frac)


def _graph_nodes(fn) -> list:
    """chip_smoke's reading of one captured call's CUDA graph nodes."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke.graph_nodes(torch, fn)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("Kd,N,frac", [(2048, 1040, 0.05), (512, 208, 0.02),
                                       (4096, 1024, 0.01), (320, 200, 0.03)])
@pytest.mark.parametrize("M", [1, 4, 8, 9, 130, 464])
def test_cuda_int8_outliers_match_plain(M, Kd, N, frac, dtype):
    """On the card: the int8 kernel with outliers against its plain
    version, one launch a call. bf16: (2048, 1040) with 102 outliers (two
    64-outlier chunks of the prefill pass), (512, 208) and llama's (4096,
    1024) with 41 on the decode loop (M <= 8, split tiles) and the wgmma
    loop; (320, 200) and f32 on the tile loop. bf16 at 1e-2 relative, f32
    at 1e-5."""
    _cuda()
    td = getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 1e-2
    gen = torch.Generator(device="cuda").manual_seed(M + Kd)
    x = torch.randn((M, Kd), generator=gen, device="cuda").to(td)
    q = _card_weight(gen, (Kd, N), frac)
    before = K.LAUNCHES["int8_matmul"]
    got = K.int8_matmul(x, q.codes, q.scale, td, q.outlier_idx, q.outlier_w)
    torch.cuda.synchronize()
    assert K.LAUNCHES["int8_matmul"] == before + 1
    want = K.int8_matmul_plain(x, q.codes, q.scale, td, None,
                               q.outlier_idx, q.outlier_w)
    assert _rel(got, want) < tol
    # the outlier term moves the output past the tolerance
    bare = K.int8_matmul_plain(x, q.codes, q.scale, td)
    assert _rel(bare, want) > tol


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [(256, 128), (256, 64), (128, 128),
                                  (128, 64), (64, 128), (64, 64)])
@pytest.mark.parametrize("M", [9, 130, 464])
def test_cuda_wgmma_loop_outliers_at_every_tile(M, tile, monkeypatch):
    """On the card: the prefill loop's outlier pass at each of its six
    tiles, forced through the plan (tiles past N and rows past M, several
    tiles a block), 1e-2 relative."""
    _cuda()
    monkeypatch.setattr(K, "WG_TILES", (tile,))
    K._device_plan.cache_clear()
    try:
        gen = torch.Generator(device="cuda").manual_seed(M)
        x = torch.randn((M, 2048), generator=gen, device="cuda").to(
            torch.bfloat16)
        q = _card_weight(gen, (2048, 1040), 0.05)
        before = dict(K.LOOP_LAUNCHES["int8_matmul"])
        got = K.int8_matmul(x, q.codes, q.scale, torch.bfloat16,
                            q.outlier_idx, q.outlier_w)
        torch.cuda.synchronize()
        assert K.LOOP_LAUNCHES["int8_matmul"]["wgmma"] == before["wgmma"] + 1
        want = K.int8_matmul_plain(x, q.codes, q.scale, torch.bfloat16,
                                   None, q.outlier_idx, q.outlier_w)
        assert _rel(got, want) < 1e-2
    finally:
        K._device_plan.cache_clear()


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 4, 8])
def test_cuda_decode_rows_alone_equal_rows_in_a_batch(M):
    """On the card: row i of an M-row decode call with outliers has the
    bits of a 1-row call of that row."""
    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((M, 4096), generator=gen, device="cuda").to(
        torch.bfloat16)
    q = _card_weight(gen, (4096, 1024), 0.01)
    args = (q.codes, q.scale, torch.bfloat16, q.outlier_idx, q.outlier_w)
    got = K.int8_matmul(x, *args)
    for i in range(M):
        assert torch.equal(K.int8_matmul(x[i:i + 1].contiguous(), *args),
                           got[i:i + 1])


@pytest.mark.gpu
@pytest.mark.parametrize("M", [4, 464])
def test_cuda_int8_call_with_outliers_is_one_kernel_node(M):
    """On the card: one call with outliers captured in a CUDA graph is one
    kernel node, at decode and at prefill."""
    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn((M, 4096), generator=gen, device="cuda").to(
        torch.bfloat16)
    q = _card_weight(gen, (4096, 1024), 0.01)
    assert _graph_nodes(lambda: K.int8_matmul(
        x, q.codes, q.scale, torch.bfloat16, q.outlier_idx,
        q.outlier_w)) == [0]


@pytest.mark.gpu
@pytest.mark.parametrize("E,C,Kd,N", [(128, 8, 2048, 768),
                                      (128, 40, 768, 2048),
                                      (32, 160, 1024, 512)])
def test_cuda_grouped_outliers_match_plain(E, C, Kd, N):
    """On the card: the grouped call with each expert's outliers (qwen3's
    and granite's expert shapes at 1% outliers) against the plain version
    with every row and with a dispatch's counts: zeros past the counts,
    kept rows the same bits whatever the other experts' counts, one kernel
    node a call."""
    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(E + C)
    x = torch.randn((E, C, Kd), generator=gen, device="cuda").to(
        torch.bfloat16)
    q = _card_weight(gen, (E, Kd, N), 0.01)
    assert q.outlier_idx.shape == (E, round(0.01 * Kd))
    args = (q.codes, q.scale, torch.bfloat16)
    out = (q.outlier_idx, q.outlier_w)
    got = K.int8_matmul_grouped(x, *args, None, *out)
    assert _rel(got, K.int8_matmul_plain(x, *args, None, *out)) < 1e-2
    rows = torch.randint(0, C + 1, (E,), generator=gen, device="cuda",
                         dtype=torch.int32)
    rows[::3] = 0
    keep = (torch.arange(C, device="cuda") < rows[:, None])[..., None]
    xz = x * keep.to(x.dtype)
    got = K.int8_matmul_grouped(xz, *args, rows, *out)
    assert not got[~keep.expand_as(got)].view(torch.int16).any()
    assert _rel(got, K.int8_matmul_plain(xz, *args, rows, *out)) < 1e-2
    e = int(torch.nonzero(rows)[0])
    alone = torch.zeros_like(rows)
    alone[e] = rows[e]
    r = int(rows[e])
    assert torch.equal(K.int8_matmul_grouped(xz, *args, alone, *out)[e, :r],
                       got[e, :r])
    assert _graph_nodes(lambda: K.int8_matmul_grouped(
        xz, *args, rows, *out)) == [0]
