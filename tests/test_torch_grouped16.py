"""An MoE's 16-bit expert stacks through the grouped kernels
(``repro_torch.kernels.quant_matmul.kernel.bf16_matmul_grouped`` and
``fp16_matmul_grouped``): on the CPU their plain versions bit for bit
against ``torch.matmul(x.to(cd), w.to(cd))``, the product they replace,
at the kept rows, with exact zeros past the counts; ``linear_apply`` on a
3-D bf16 and float16 weight against the reference's ``_expert_dense``;
a product that autograd records keeping ``torch.matmul`` and its
gradient; an MoE layer bit for bit against today's product; the meta
records against ``kernels/cost.py``; the plans. The tests marked ``gpu``
hold the CUDA kernels against their plain versions on the card (every
loop, each prefill tile forced, zeros past the counts, a kept expert's
bits alone and among others, one kernel node a call); they import no
JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_grouped16.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.op_analysis import OpCounter  # noqa: E402
from repro_torch.core.precision import make_policy  # noqa: E402
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.kernels.quant_matmul import kernel as K  # noqa: E402
from repro_torch.kernels.quant_matmul import ops as qops  # noqa: E402
from repro_torch.models import moe as pt_moe  # noqa: E402
from repro_torch.quant import apply as pt_apply  # noqa: E402

# each 16-bit weight dtype's grouped entry point
WDTYPES = {"bfloat16": "bf16_matmul_grouped",
           "float16": "fp16_matmul_grouped"}


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _case(E, C, Kd, N, wdtype, seed):
    """x (E, C, Kd) f32, non-zero in every row, and an (E, Kd, N) weight
    of ``wdtype``."""
    x = torch.from_numpy(_rand((E, C, Kd), seed))
    w = torch.from_numpy(_rand((E, Kd, N), seed + 1, Kd ** -0.5)).to(
        getattr(torch, wdtype))
    return x, w


def _today(x, w, cd=torch.bfloat16):
    """The product the grouped kernels replace."""
    return torch.matmul(x.to(cd), w.to(cd))


# each expert's kept rows at C = 6: none, partial and all
ROWS = [0, 4, 6, 1, 3]


@pytest.mark.parametrize("wdtype", list(WDTYPES))
@pytest.mark.parametrize("rows", [None, ROWS, [0] * 5])
def test_plain_grouped_is_todays_product_at_the_kept_rows(wdtype, rows):
    """The wrapper on a CPU tensor and the plain version give, at the kept
    rows, the bits of ``torch.matmul(x.to(cd), w.to(cd))``, and exact +0
    at or past each count, though x's rows there are not zero; no launch
    is counted."""
    entry = WDTYPES[wdtype]
    K.reset_launches()
    x, w = _case(5, 6, 128, 96, wdtype, 1)
    xb = x.to(torch.bfloat16)
    r = None if rows is None else torch.tensor(rows, dtype=torch.int32)
    want = _today(x, w)
    for fn in (getattr(K, entry), K.fp16_matmul_plain, K.bf16_matmul_plain):
        got = fn(xb, w, torch.bfloat16, r)
        assert got.dtype == torch.bfloat16 and got.shape == (5, 6, 96)
        for e in range(5):
            n = 6 if r is None else rows[e]
            assert torch.equal(got[e, :n], want[e, :n]), (fn, e)
            assert torch.equal(got[e, n:].view(torch.int16),
                               torch.zeros_like(got[e, n:]).view(
                                   torch.int16)), (fn, e)
    assert not any(K.LAUNCHES.values())


@pytest.mark.parametrize("wdtype", list(WDTYPES))
def test_linear_apply_is_todays_product_bit_for_bit(wdtype):
    """``linear_apply`` of a 3-D 16-bit weight under a bf16 compute dtype,
    with the dispatch's counts: the kept rows bit for bit today's
    batched product, zeros past them; without counts, today's product."""
    x, w = _case(5, 6, 128, 96, wdtype, 2)
    rows = torch.tensor(ROWS, dtype=torch.int32)
    pol = make_policy(wdtype)
    want = _today(x, w)
    got = pt_apply.linear_apply(w, x, pol, rows)
    past = torch.arange(6) >= rows[:, None]
    assert torch.equal(got[~past], want[~past])
    assert not got[past].any()
    assert torch.equal(pt_apply.linear_apply(w, x, pol), want)


@pytest.mark.parametrize("wdtype", list(WDTYPES))
def test_linear_apply_matches_reference_expert_dense(wdtype):
    """The port's ``_expert_dense`` (the grouped kernel's plain version on
    the CPU) against the reference's (``jax.vmap`` of ``linear_apply``
    over the experts) on the same numpy inputs under the format's policy,
    2e-2 relative (bf16 outputs of f32 sums taken in other orders), at
    the kept rows with the dispatch's counts and at every row without."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core.precision import make_policy as jax_policy
    from repro.models import moe as jax_moe
    import _torch_parity as tp
    x = _rand((4, 6, 128), 3)
    w = _rand((4, 128, 96), 4, 128 ** -0.5).astype(
        np.float16 if wdtype == "float16" else np.float32)
    wj = jnp.asarray(w).astype(getattr(jnp, wdtype))
    want = np.asarray(jax_moe._expert_dense(wj, jnp.asarray(x),
                                            jax_policy(wdtype)).astype(
                                                jnp.float32))
    wt = torch.from_numpy(w).to(getattr(torch, wdtype))
    pol = make_policy(wdtype)
    got = pt_moe._expert_dense(wt, torch.from_numpy(x), pol)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (4, 6, 96)
    assert tp.rel_err(got, want) < 2e-2
    rows = torch.tensor([6, 2, 0, 5], dtype=torch.int32)
    got_r = pt_moe._expert_dense(wt, torch.from_numpy(x), pol, rows)
    for e, n in enumerate(rows.tolist()):
        if n:
            assert tp.rel_err(got_r[e, :n], want[e, :n]) < 2e-2, e
        assert not got_r[e, n:].any(), e


@pytest.mark.parametrize("wdtype", list(WDTYPES))
def test_recorded_product_keeps_torch_matmul_and_its_gradient(wdtype,
                                                              monkeypatch):
    """A product autograd records (grad mode on, w requiring grad, as in
    MoE training) keeps the batched ``torch.matmul``: the grouped kernels
    are never called, the counts are ignored, and the gradient is
    ``torch.matmul``'s. Under ``no_grad`` the same weight takes the
    kernel's route (zeros past the counts)."""
    x, w = _case(5, 6, 128, 96, wdtype, 5)
    w = w.requires_grad_()
    rows = torch.tensor(ROWS, dtype=torch.int32)
    pol = make_policy(wdtype)
    routed = []
    kernel = qops.f16_matmul_grouped_kernel

    def spy(*a, **kw):
        routed.append(1)
        return kernel(*a, **kw)
    monkeypatch.setattr(qops, "f16_matmul_grouped_kernel", spy)
    got = pt_apply.linear_apply(w, x, pol, rows)
    assert not routed and got.requires_grad
    w2 = w.detach().clone().requires_grad_()
    want = _today(x, w2)
    assert torch.equal(got, want)
    g = torch.from_numpy(_rand(tuple(got.shape), 6)).to(torch.bfloat16)
    got.backward(g)
    want.backward(g)
    assert w.grad is not None and torch.equal(w.grad, w2.grad)
    with torch.no_grad():
        got_ng = pt_apply.linear_apply(w, x, pol, rows)
    assert routed == [1]
    assert not got_ng[torch.arange(6) >= rows[:, None]].any()


def test_recorded_2d_fp16_product_keeps_torch_matmul():
    """The same rule for a 2-D float16 weight (a float16 model trained):
    a product autograd records keeps ``torch.matmul`` and its gradient
    (the fp16 kernel has no backward); on the meta device it records no
    kernel, under ``no_grad`` one ``fp16_matmul``."""
    x = torch.from_numpy(_rand((4, 128), 9))
    w = torch.from_numpy(_rand((128, 48), 10, 0.1)).half().requires_grad_()
    y = pt_apply.linear_apply(w, x, make_policy("float16"))
    assert y.requires_grad and torch.equal(y, _today(x, w.detach()))
    y.float().sum().backward()
    assert w.grad is not None and w.grad.dtype == torch.float16
    xm = torch.empty((4, 128), dtype=torch.bfloat16, device="meta")
    wm = torch.empty((128, 48), dtype=torch.float16, device="meta")
    with OpCounter() as c:
        pt_apply.linear_apply(wm.requires_grad_(), xm, make_policy("float16"))
    assert c.cost.kernels == {}
    with torch.no_grad(), OpCounter() as c2:
        pt_apply.linear_apply(wm, xm, make_policy("float16"))
    assert c2.cost.kernels == {"fp16_matmul": 1}


def test_f32_compute_keeps_torch_matmul(monkeypatch):
    """No 16-bit stage takes f32 compute: a 3-D bf16 weight under an f32
    compute dtype keeps ``torch.matmul`` in f32 and ignores the counts."""
    monkeypatch.setattr(qops, "f16_matmul_grouped_kernel", None)
    x, w = _case(5, 6, 128, 96, "bfloat16", 7)
    got = pt_apply.linear_apply(w, x, make_policy("bfloat16", torch.float32),
                                torch.tensor(ROWS, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.matmul(x, w.float()))


@pytest.mark.parametrize("wdtype", list(WDTYPES))
def test_moe_layer_is_todays_bit_for_bit(wdtype, monkeypatch):
    """``moe_ffn`` over 16-bit experts (8 experts, top 2, 64 tokens, a
    capacity factor of 0.5, so that rows drop and counts differ) through
    the grouped route gives the bits of the same layer through today's
    batched product."""
    rng = np.random.default_rng(8)
    D, F, E = 64, 96, 8
    td = getattr(torch, wdtype)

    def t(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32))
    p = {"w_router": t((D, E), D ** -0.5).to(torch.bfloat16),
         "experts_gate": t((E, D, F), D ** -0.5).to(td),
         "experts_up": t((E, D, F), D ** -0.5).to(td),
         "experts_down": t((E, F, D), F ** -0.5).to(td)}
    x = t((64, D), 1.0).to(torch.bfloat16)
    pol = make_policy(wdtype)
    with torch.no_grad():
        y, aux = pt_moe.moe_ffn(p, x, top_k=2, policy=pol,
                                capacity_factor=0.5)
        assert aux["dropped_fraction"] > 0
        monkeypatch.setattr(qops, "f16_matmul_grouped_kernel",
                            lambda x_, w_, compute_dtype, rows=None:
                            _today(x_, w_, compute_dtype))
        y_today, _ = pt_moe.moe_ffn(p, x, top_k=2, policy=pol,
                                    capacity_factor=0.5)
    assert torch.equal(y, y_today)


@pytest.mark.parametrize("wdtype", list(WDTYPES))
def test_meta_record_prices_every_expert(wdtype):
    """On the meta device under a cost analysis: a 3-D 16-bit weight under
    a bf16 compute dtype is one record of its grouped entry point, priced
    by kernels/cost.py over every expert's 16-bit bytes (with rows or
    without: a meta tensor holds no counts); f32 compute and a weight
    that requires grad under grad mode record no kernel."""
    entry = WDTYPES[wdtype]
    E, C, Kd, N = 6, 5, 256, 192
    x = torch.empty((E, C, Kd), dtype=torch.bfloat16, device="meta")
    w = torch.empty((E, Kd, N), dtype=getattr(torch, wdtype), device="meta")
    with OpCounter() as c:
        out = pt_apply.linear_apply(w, x, make_policy(wdtype))
    assert out.shape == (E, C, N) and out.dtype == torch.bfloat16
    assert c.cost.kernels == {entry: 1}
    nbytes, flops = cost.quant_matmul(C, Kd, N, 2 * E * Kd * N, 2, E)
    assert (c.cost.dot_flops, c.cost.dot_bytes) == (flops, nbytes)
    for w_, pol in ((w, make_policy(wdtype, torch.float32)),
                    (w.requires_grad_(), make_policy(wdtype))):
        with OpCounter() as c2:
            pt_apply.linear_apply(w_, x, pol)
        assert c2.cost.kernels == {}


def test_wrappers_refuse_grads_other_devices_and_bad_rows():
    x = torch.empty((2, 4, 128), dtype=torch.bfloat16, device="meta")
    w = torch.empty((2, 128, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        K.bf16_matmul_grouped(x, w)
    xg = torch.randn(2, 4, 128, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        K.fp16_matmul_grouped(xg, torch.randn(2, 128, 64).half())
    with pytest.raises(TypeError, match="dtype"):
        K.bf16_matmul_grouped(torch.randn(2, 4, 128), torch.randn(
            2, 128, 64).bfloat16(), rows=torch.tensor([1, 2]))


def test_ring_and_plans_keep_off_the_256_by_128_tile():
    """A bf16 stage holds fp16's bytes: the 256 x 128 ring holds four and
    is never planned; the decode ring eight. The grouped plans at qwen3's
    and granite's expert shapes: the decode loop at C <= 8 (4 segments a
    tile at qwen3's w_gate), the wgmma loop above."""
    for bm, bn in K.WG_TILES:
        assert K.ring_stages("bf16", bm, bn) == K.ring_stages("fp16", bm, bn)
    assert K.ring_stages("bf16", 256, 128) == 4
    assert K.ring_stages("bf16", K.DEC_M, K.DEC_BN) == 8
    for fmt in ("bf16", "fp16"):
        p = K.matmul_plan(8, 768, 2048, 132, experts=128, grouped=True,
                          fmt=fmt)
        assert (p.loop, p.seg, p.grid) == ("decode", 4, 132)
        for E, C, Kd, N in ((128, 40, 2048, 768), (128, 40, 768, 2048),
                            (32, 160, 1024, 512), (32, 160, 512, 1024),
                            (32, 512, 512, 1024)):
            p = K.matmul_plan(C, N, Kd, 132, experts=E, grouped=True,
                              fmt=fmt)
            assert p.loop == "wgmma" and (p.bm, p.bn) != (256, 128)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _rel(got, ref) -> float:
    got, ref = got.float().cpu(), ref.float().cpu()
    return ((got - ref).abs().max() / (ref.abs().max() + 1e-12)).item()


def _cuda_case(E, C, Kd, N, wdtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((E, C, Kd), generator=gen, device="cuda").to(
        torch.bfloat16)
    w = (torch.randn((E, Kd, N), generator=gen, device="cuda")
         * Kd ** -0.5).to(getattr(torch, wdtype))
    return x, w


def _dispatch_rows(E, C, T, seed):
    """Each expert's kept rows of a seeded top-8 routing of T tokens
    through the port's dispatch (int32 (E,) on the card)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((T, 64), generator=gen, device="cuda")
    w_router = torch.randn((64, E), generator=gen, device="cuda")
    return pt_moe._dispatch(x, w_router, min(8, E), E, C)[1][-1]


SHAPES = [(128, 8, 2048, 768), (128, 8, 768, 2048),       # qwen3 decode
          (128, 40, 2048, 768), (128, 40, 768, 2048),     # qwen3 prefill
          (32, 8, 1024, 512), (32, 8, 512, 1024),         # granite decode
          (32, 160, 1024, 512), (32, 160, 512, 1024),     # granite prefill
          (3, 5, 320, 208), (3, 130, 320, 208)]           # ragged C and N


@pytest.mark.gpu
@pytest.mark.parametrize("wdtype", list(WDTYPES))
@pytest.mark.parametrize("E,C,Kd,N", SHAPES)
def test_cuda_grouped16_matches_plain(E, C, Kd, N, wdtype):
    """On the card: one call over all experts against the plain version,
    on the decode loop for C <= 8 and the wgmma loop above, one launch a
    call, 1e-2 relative (one bf16 rounding of f32 sums taken in other
    orders), each expert its own product."""
    _cuda()
    entry = WDTYPES[wdtype]
    fn = getattr(K, entry)
    x, w = _cuda_case(E, C, Kd, N, wdtype, E + C + N)
    loop = "decode" if C <= 8 else "wgmma"
    before = dict(K.LOOP_LAUNCHES[entry])
    launches = K.LAUNCHES[entry]
    got = fn(x, w)
    ref = K.fp16_matmul_plain(x, w)
    torch.cuda.synchronize()
    assert K.LAUNCHES[entry] == launches + 1
    assert K.LOOP_LAUNCHES[entry][loop] == before[loop] + 1
    assert _rel(got, ref) < 1e-2
    assert max(_rel(got[e], ref[e]) for e in (0, E // 2, E - 1)) < 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("wdtype", list(WDTYPES))
@pytest.mark.parametrize("tile", [(256, 64), (128, 128), (128, 64),
                                  (64, 128), (64, 64)])
def test_cuda_grouped16_wgmma_loop_at_every_tile(tile, wdtype, monkeypatch):
    """On the card: the prefill loop at each tile it may take, forced
    through the plan, with the dispatch's rows, 1e-2 relative and zeros
    past the counts."""
    _cuda()
    entry = WDTYPES[wdtype]
    monkeypatch.setattr(K, "WG_TILES", (tile,))
    K._device_plan.cache_clear()
    try:
        x, w = _cuda_case(16, 130, 512, 1040, wdtype, 3)
        rows = _dispatch_rows(16, 130, 200, 4)
        before = K.LOOP_LAUNCHES[entry]["wgmma"]
        got = getattr(K, entry)(x, w, rows=rows)
        ref = K.fp16_matmul_plain(x, w, rows=rows)
        torch.cuda.synchronize()
        assert K.LOOP_LAUNCHES[entry]["wgmma"] == before + 1
        assert not got[torch.arange(130, device="cuda")
                       >= rows[:, None]].any()
        assert _rel(got, ref) < 1e-2
    finally:
        K._device_plan.cache_clear()


@pytest.mark.gpu
@pytest.mark.parametrize("wdtype", list(WDTYPES))
@pytest.mark.parametrize("E,C,Kd,N", [(128, 8, 2048, 768),
                                      (128, 40, 768, 2048),
                                      (32, 160, 512, 1024),
                                      (3, 5, 320, 208)])
def test_cuda_grouped16_rows(E, C, Kd, N, wdtype):
    """On the card, with each expert's kept rows (the dispatch's, drawn
    with every third expert at 0, none): 1e-2 relative at the kept rows,
    exact zeros past the counts though x's rows there are not; one
    expert's kept rows the same bits alone, among the dispatch's experts,
    among all and with rows=None."""
    _cuda()
    entry = WDTYPES[wdtype]
    fn = getattr(K, entry)
    x, w = _cuda_case(E, C, Kd, N, wdtype, 7 * E + C)
    gen = torch.Generator(device="cuda").manual_seed(E + C)
    drawn = torch.randint(0, C + 1, (E,), generator=gen, device="cuda",
                          dtype=torch.int32)
    drawn[::3] = 0
    T = 4 if C <= 8 else max(1, 8 * C * E // 80)
    dispatch = _dispatch_rows(E, C, T, E + C)
    for rows in (dispatch, drawn, torch.zeros_like(drawn)):
        got = fn(x, w, rows=rows)
        ref = K.fp16_matmul_plain(x, w, rows=rows)
        torch.cuda.synchronize()
        assert not got[torch.arange(C, device="cuda")
                       >= rows[:, None]].any()
        if rows.any():
            assert _rel(got, ref) < 1e-2
    e = int(torch.nonzero(dispatch)[0])
    r = int(dispatch[e])
    alone = torch.zeros_like(dispatch)
    alone[e] = r
    among = fn(x, w, rows=dispatch)[e, :r]
    for rows in (alone, torch.full_like(dispatch, C), None):
        assert torch.equal(fn(x, w, rows=rows)[e, :r], among), rows


@pytest.mark.gpu
@pytest.mark.parametrize("wdtype", list(WDTYPES))
@pytest.mark.parametrize("C", [4, 40])
def test_cuda_grouped16_call_is_one_kernel_node(C, wdtype):
    """On the card: one call with the dispatch's rows, captured in a CUDA
    graph, is one kernel node and nothing else; a replay with new x and
    new counts gives the eager result, the merge's counters back at 0."""
    _cuda()
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    entry = WDTYPES[wdtype]
    fn = getattr(K, entry)
    x, w = _cuda_case(128, C, 2048, 768, wdtype, 5)
    rows = _dispatch_rows(128, C, 4 if C <= 8 else 512, 6)
    assert chip_smoke.graph_nodes(torch, lambda: fn(x, w, rows=rows)) == [0]
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fn(x, w, rows=rows)
    gen = torch.Generator(device="cuda").manual_seed(7)
    x.copy_(torch.randn(x.shape, generator=gen, device="cuda"))
    rows.copy_(_dispatch_rows(128, C, 4 if C <= 8 else 512, 8))
    g.replay()
    want = fn(x, w, rows=rows)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert not K.cuda_build.counters(x.device, 1).any()


@pytest.mark.gpu
@pytest.mark.parametrize("wdtype", list(WDTYPES))
@pytest.mark.parametrize("C", [8, 64])
def test_cuda_one_hot_rows_give_the_weights(C, wdtype):
    """On the card: x rows of the identity, so expert e's out row i is
    w[e][i] in bf16 bit for bit (a bf16 weight as it is; an fp16 one
    rounded to nearest even), on both loops: the fragments' byte
    permutes put every weight where the product needs it."""
    _cuda()
    entry = WDTYPES[wdtype]
    E, Kd, N = 4, 256, 208
    gen = torch.Generator(device="cuda").manual_seed(C)
    w = torch.randn((E, Kd, N), generator=gen, device="cuda").to(
        getattr(torch, wdtype))
    eye = torch.eye(Kd, device="cuda", dtype=torch.bfloat16)
    for i in range(0, Kd, C):
        x = eye[i:i + C].expand(E, C, Kd).contiguous()
        got = getattr(K, entry)(x, w)
        assert torch.equal(got, w[:, i:i + C].to(torch.bfloat16)), i


@pytest.mark.gpu
def test_cuda_grouped16_refuses_what_no_loop_takes():
    """On the card: f32 compute (TypeError) and a shape neither loop
    takes (K not a multiple of 64) raise before any launch."""
    _cuda()
    x, w = _cuda_case(2, 8, 96, 64, "bfloat16", 9)
    before = dict(K.LAUNCHES)
    with pytest.raises(ValueError, match="no grouped bf16 kernel"):
        K.bf16_matmul_grouped(x, w)
    with pytest.raises(TypeError):
        K.bf16_matmul_grouped(x.float(), w, torch.float32)
    assert K.LAUNCHES == before


@pytest.mark.gpu
@pytest.mark.parametrize("wdtype", list(WDTYPES))
def test_cuda_linear_apply_routes_16bit_experts(wdtype):
    """On the card: ``linear_apply`` of a 3-D 16-bit weight under bf16
    compute is one grouped launch with the counts; with a weight that
    requires grad under grad mode it launches nothing and keeps the
    gradient."""
    _cuda()
    entry = WDTYPES[wdtype]
    x, w = _cuda_case(8, 8, 256, 128, wdtype, 10)
    rows = torch.tensor([0, 8, 3, 1, 0, 5, 2, 8], dtype=torch.int32,
                        device="cuda")
    pol = make_policy(wdtype)
    before = K.LAUNCHES[entry]
    got = pt_apply.linear_apply(w, x, pol, rows)
    torch.cuda.synchronize()
    assert K.LAUNCHES[entry] == before + 1
    assert _rel(got, K.fp16_matmul_plain(x, w, rows=rows)) < 1e-2
    w.requires_grad_()
    y = pt_apply.linear_apply(w, x, pol, rows)
    y.float().sum().backward()
    torch.cuda.synchronize()
    assert K.LAUNCHES[entry] == before + 1 and w.grad is not None
