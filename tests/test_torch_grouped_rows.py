"""The grouped quant kernels given each expert's kept rows (the capacity
dispatch's counts), on the CPU: the plain grouped versions with ``rows``
against the reference's Pallas kernels under ``jax.vmap`` on the kept
rows, with exact zeros past the counts; the counts ``_dispatch`` returns;
``moe_ffn`` with the counts against itself without them, bit for bit;
the host mirror of the grouped decode walk (``decode_segments``) at
qwen3-moe-30b-a3b's and granite-moe-1b-a400m's decode shapes; and the
meta branch's cost with and without rows. tests/test_torch_cuda.py holds
the kernels against the same plain versions on the card."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.quant_matmul.kernel import (  # noqa: E402
    int8_matmul_pallas, nf4_matmul_pallas)
from repro.quant import quantize_int8, quantize_nf4  # noqa: E402

from repro_torch.core.op_analysis import OpCounter  # noqa: E402
from repro_torch.core.precision import make_policy  # noqa: E402
from repro_torch.kernels.quant_matmul import kernel as K  # noqa: E402
from repro_torch.models import moe as pt_moe  # noqa: E402
from repro_torch.quant.apply import quantize_params  # noqa: E402

from _torch_parity import to_torch  # noqa: E402


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _routed_rows(E, C, T, top_k, seed):
    """The dispatch's kept rows of a top-k routing of T seeded tokens."""
    x = torch.from_numpy(_rand((T, 32), seed))
    w_router = torch.from_numpy(_rand((32, E), seed + 1))
    return pt_moe._dispatch(x, w_router, top_k, E, C)[1][-1]


# ---------------------------------------------------------------------------
# the plain grouped versions with rows against the Pallas kernels
# ---------------------------------------------------------------------------
GE, GK, GN = 4, 256, 128
# each expert's kept rows: none, partial and all C
ROWS = {8: [0, 3, 8, 1], 40: [40, 0, 17, 9]}


@pytest.mark.parametrize("C", [8, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ["int8", "nf4"])
def test_grouped_plain_rows_match_pallas_on_kept_rows(fmt, dtype, C):
    """Kept rows at the reference's tolerances (f32 1e-5, bf16 2e-2
    relative: one bf16 rounding of f32 sums taken in other orders); every
    row at or past its expert's count exactly +0, though x's rows there
    are not zero."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    x = _rand((GE, C, GK), 1)
    w = _rand((GE, GK, GN), 2, 0.05)
    rows = torch.tensor(ROWS[C], dtype=torch.int32)
    if fmt == "int8":
        qs = [quantize_int8(jnp.asarray(w[e])) for e in range(GE)]
        a, b = (jnp.stack([q.codes for q in qs]),
                jnp.stack([q.scale for q in qs]))
        pallas, grouped = int8_matmul_pallas, K.int8_matmul_grouped
    else:
        qs = [quantize_nf4(jnp.asarray(w[e]), 64) for e in range(GE)]
        a, b = (jnp.stack([q.packed for q in qs]),
                jnp.stack([q.absmax for q in qs]))
        pallas, grouped = nf4_matmul_pallas, K.nf4_matmul_grouped
    ref = np.asarray(jax.vmap(lambda x_, a_, b_: pallas(
        x_, a_, b_, compute_dtype=jd, bm=C, bn=64, bk=128))(
        jnp.asarray(x), a, b).astype(jnp.float32))
    got = grouped(torch.from_numpy(x), to_torch(a), to_torch(b), td, rows)
    assert got.shape == (GE, C, GN) and got.dtype == td
    past = (torch.arange(C) >= rows[:, None]).numpy()
    g = got.float().numpy()
    assert (g[past] == 0).all() and not np.signbit(g[past]).any()
    kept = ~past
    err = np.abs(g[kept] - ref[kept]).max() / np.abs(ref[kept]).max()
    assert err < tol
    # rows=None is every row: the kept rows are the same bits
    full = grouped(torch.from_numpy(x), to_torch(a), to_torch(b), td)
    assert torch.equal(got[torch.from_numpy(kept)],
                       full[torch.from_numpy(kept)])


@pytest.mark.parametrize("fmt", ["int8", "nf4"])
def test_grouped_rows_are_checked_on_the_cpu(fmt):
    """rows must be int32 (E,) on x's device: the CPU path checks it as
    the card's does (a 2-D call takes no rows)."""
    x = torch.from_numpy(_rand((3, 4, 128), 0))
    w = torch.from_numpy(_rand((3, 128, 32), 1))
    q = quantize_params({"experts_up": w}, make_policy(fmt))["experts_up"]
    fn = K.int8_matmul_grouped if fmt == "int8" else K.nf4_matmul_grouped
    wargs = (q.codes, q.scale) if fmt == "int8" else (q.packed, q.absmax)
    for bad, err in ((torch.ones(3, dtype=torch.int64), TypeError),
                     (torch.ones(2, dtype=torch.int32), ValueError),
                     (torch.ones(3, dtype=torch.int32, device="meta"),
                      ValueError)):
        with pytest.raises(err, match="rows"):
            fn(x, *wargs, rows=bad)
    with pytest.raises(ValueError, match="grouped"):
        K.int8_matmul_plain(x[0], torch.zeros((128, 32), dtype=torch.int8),
                            torch.ones(32), rows=torch.ones(1,
                                                            dtype=torch.int32))


# ---------------------------------------------------------------------------
# the dispatch's counts, and the MoE layer with and without them
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("T,E,k,cf", [(4, 128, 8, 1.25), (512, 128, 8, 1.25),
                                      (4, 32, 8, 1.25), (40, 8, 2, 1.25),
                                      (100, 4, 2, 8.0)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dispatch_counts_are_kept_assignments(T, E, k, cf, seed):
    """_dispatch's counts are min(assignments of the expert, C), int32 on
    the routing's device; an expert's buffer holds its tokens in rows 0
    .. count - 1 and zeros past them."""
    C = pt_moe.expert_capacity(T, E, k, cf)
    x = torch.from_numpy(_rand((T, 32), seed))
    w_router = torch.from_numpy(_rand((32, E), seed + 10))
    buf, routing = pt_moe._dispatch(x, w_router, k, E, C)
    rows = routing[-1]
    ids = routing[2].reshape(-1).numpy()
    want = np.minimum(np.bincount(ids, minlength=E), C)
    assert rows.dtype == torch.int32 and rows.shape == (E,)
    np.testing.assert_array_equal(rows.numpy(), want)
    filled = buf.abs().amax(-1) > 0
    past = torch.arange(C) >= rows[:, None]
    assert not filled[past].any()
    assert filled[~past].all()


MOE_D, MOE_F, MOE_E = 64, 96, 8


@pytest.mark.parametrize("fmt", ["int8", "nf4"])
@pytest.mark.parametrize("T,cf", [(5, 1.25), (48, 1.25), (48, 4.0)])
def test_moe_ffn_with_counts_equals_without(fmt, T, cf, monkeypatch):
    """moe_ffn hands every grouped product the dispatch's counts, and its
    output with them is, bit for bit, its output with rows=None: the
    combine reads only kept rows."""
    p = {"w_router": _rand((MOE_D, MOE_E), 0, MOE_D ** -0.5),
         "experts_gate": _rand((MOE_E, MOE_D, MOE_F), 1, MOE_D ** -0.5),
         "experts_up": _rand((MOE_E, MOE_D, MOE_F), 2, MOE_D ** -0.5),
         "experts_down": _rand((MOE_E, MOE_F, MOE_D), 3, MOE_F ** -0.5)}
    pol = make_policy(fmt)
    q = quantize_params({k: torch.from_numpy(v) for k, v in p.items()}, pol)
    x = torch.from_numpy(_rand((T, MOE_D), 4))
    kw = dict(top_k=2, policy=pol, capacity_factor=cf)
    seen = []
    dense = pt_moe._expert_dense

    def recording(w, x_, policy, rows=None):
        seen.append(rows)
        return dense(w, x_, policy, rows)

    monkeypatch.setattr(pt_moe, "_expert_dense", recording)
    y_rows, aux = pt_moe.moe_ffn(q, x, **kw)
    assert len(seen) == 3
    C = pt_moe.expert_capacity(T, MOE_E, 2, cf)
    for rows in seen:
        assert rows.dtype == torch.int32 and rows.shape == (MOE_E,)
        assert int(rows.sum()) == round(T * 2 * (1 - float(
            aux["dropped_fraction"])))
        assert int(rows.max()) <= C
    monkeypatch.setattr(pt_moe, "_expert_dense",
                        lambda w, x_, policy, rows=None: dense(w, x_,
                                                               policy))
    y_none, _ = pt_moe.moe_ffn(q, x, **kw)
    assert torch.equal(y_rows, y_none)


# ---------------------------------------------------------------------------
# the host mirror of the grouped decode walk
# ---------------------------------------------------------------------------
DECODE_SHAPES = [(2048, 768, 128, None), (768, 2048, 128, 64),     # qwen3
                 (1024, 512, 32, None), (512, 1024, 32, 64)]       # granite


def _walk(Kd, N, E, block, rows):
    plan = K.matmul_plan(8, N, Kd, 132, block=block, experts=E,
                         grouped=True)
    return plan, K.decode_segments(plan, N, Kd, rows)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, None])
@pytest.mark.parametrize("Kd,N,E,block", DECODE_SHAPES)
def test_grouped_decode_walk_covers_kept_experts_once(Kd, N, E, block,
                                                      seed):
    """At the serve cells' batch-4 decode (C = 8, top 8) with counts from
    seeded routings, and with one expert kept (None: fewer segments than
    blocks): every K step of every kept expert's column tiles is walked
    exactly once, no step of another expert is, the blocks' shares
    differ by at most one segment, each tile's segments are the fixed cut
    of its K steps, every block from a split tile's first to its last
    holds part of it (its merge waits for each of them), and the split
    tiles' slots and counters lie inside the worst case's scratch, one
    split tile per first block."""
    rows = ([0, 0, 5] + [0] * (E - 3) if seed is None
            else _routed_rows(E, 8, 4, 8, seed).tolist())
    plan, segs = _walk(Kd, N, E, block, rows)
    n_col, nk, S = -(-N // plan.bn), Kd // K.WG_BK, plan.seg
    assert plan.loop == "decode" and S == (
        1 if E * n_col <= 132 else max(1, nk // K.DEC_SEG_STEPS))
    kept = {e for e in range(E) if rows[e] > 0}
    seen, share, blocks = {}, {}, {}
    for b, t, k0, k1 in segs:
        e, col = divmod(t, n_col)
        assert e in kept
        s = k0 * S // nk
        assert (k0, k1) == (s * nk // S, (s + 1) * nk // S)
        for k in range(k0, k1):
            seen[(e, col, k)] = seen.get((e, col, k), 0) + 1
        share[b] = share.get(b, 0) + 1
        blocks.setdefault(t, []).append((b, s))
    assert seen == {(e, c, k): 1 for e in kept for c in range(n_col)
                    for k in range(nk)}
    counts = [share.get(b, 0) for b in range(plan.grid)]
    assert max(counts) - min(counts) <= 1
    n_part, n_count = K.decode_scratch(plan, N)
    firsts = []
    for t, bs in blocks.items():
        b0, b1 = min(b for b, _ in bs), max(b for b, _ in bs)
        assert {b for b, _ in bs} == set(range(b0, b1 + 1))
        if b0 != b1:
            firsts.append(b0)
            assert b0 < n_count
            assert all((b0 * S + s + 1) * K.DEC_M * plan.bn <= n_part
                       for _, s in bs)
    assert len(firsts) == len(set(firsts))


@pytest.mark.parametrize("Kd,N,E,block", DECODE_SHAPES)
def test_grouped_decode_walk_segments_do_not_depend_on_other_experts(
        Kd, N, E, block):
    """A kept expert's pieces (column tile, K steps) are the same alone,
    among the dispatch's experts of several routings, among all and with
    rows=None: only which block walks them moves."""
    def pieces(rows, e):
        plan, segs = _walk(Kd, N, E, block, rows)
        n_col = -(-N // plan.bn)
        return sorted((t % n_col, k0, k1) for _, t, k0, k1 in segs
                      if t // n_col == e)

    e = 3
    want = pieces([0] * e + [1] + [0] * (E - e - 1), e)
    assert want
    for seed in range(3):
        rows = _routed_rows(E, 8, 4, 8, seed).tolist()
        rows[e] = 2
        assert pieces(rows, e) == want
    assert pieces([8] * E, e) == want
    assert pieces(None, e) == want


def test_grouped_decode_walk_without_a_kept_expert_is_empty():
    plan, segs = _walk(2048, 768, 128, None, [0] * 128)
    assert segs == []
    assert plan.grid == 132


def test_two_d_decode_walk_is_unchanged_by_the_grouped_one():
    """A 2-D call keeps the even split of K steps (seg 0), which no
    count reaches."""
    plan = K.matmul_plan(4, 14336, 4096, 132)
    assert plan.seg == 0
    assert K.decode_segments(plan, 14336, 4096) \
        == K.decode_segments(plan, 14336, 4096, [0])


# ---------------------------------------------------------------------------
# the meta branch: the dry run cannot see the counts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["int8", "nf4"])
@pytest.mark.parametrize("C", [8, 40])
def test_meta_grouped_cost_is_the_same_with_rows(fmt, C):
    E, Kd, N = 16, 256, 128
    x = torch.empty((E, C, Kd), dtype=torch.bfloat16, device="meta")
    rows = torch.empty((E,), dtype=torch.int32, device="meta")
    if fmt == "int8":
        fn = K.int8_matmul_grouped
        wargs = (torch.empty((E, Kd, N), dtype=torch.int8, device="meta"),
                 torch.empty((E, N), device="meta"))
    else:
        fn = K.nf4_matmul_grouped
        wargs = (torch.empty((E, Kd // 2, N), dtype=torch.uint8,
                             device="meta"),
                 torch.empty((E, Kd // 64, N), device="meta"))
    costs = []
    for kw in ({}, {"rows": rows}):
        with OpCounter() as c:
            out = fn(x, *wargs, **kw)
        assert out.shape == (E, C, N) and out.device.type == "meta"
        costs.append((c.cost.dot_flops, c.cost.dot_bytes, c.cost.kernels))
    assert costs[0] == costs[1]
    assert costs[0][2] == {fn.__name__: 1}
