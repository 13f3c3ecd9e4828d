"""The port's MoE (repro_torch.models.moe) and its grouped quant kernels
against the JAX package: ``moe_ffn`` against the reference's
``_moe_ffn_local`` (with and without drops), the grouped plain versions
against the Pallas kernels under ``jax.vmap``, stacked quantization
against per-slice quantization, the grouped launch plan, and the
layer-by-layer weight build. tests/test_torch_archs.py runs the MoE
configs end to end."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.precision import make_policy as jax_policy  # noqa: E402
from repro.kernels.quant_matmul import ops as jax_ops  # noqa: E402
from repro.kernels.quant_matmul.kernel import (  # noqa: E402
    int8_matmul_pallas, nf4_matmul_pallas)
from repro.models import moe as jax_moe  # noqa: E402
from repro.quant import apply as jax_apply  # noqa: E402
from repro.quant import quantize_int8, quantize_nf4  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.paper_zoo import PAPER_MODELS  # noqa: E402
from repro_torch.core.precision import make_policy  # noqa: E402
from repro_torch.kernels.quant_matmul import kernel as K  # noqa: E402
from repro_torch.kernels.quant_matmul import ops as pt_ops  # noqa: E402
from repro_torch.launch.serve import build_params  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as pt_moe  # noqa: E402
from repro_torch.quant import apply as pt_apply  # noqa: E402
from repro_torch.quant import int8 as pt_int8  # noqa: E402
from repro_torch.quant import nf4 as pt_nf4  # noqa: E402

from _torch_parity import (host_expert_product, rel_err,  # noqa: E402
                           to_numpy, to_torch)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# moe_ffn against _moe_ffn_local
# ---------------------------------------------------------------------------
D, F, E, TOP_K = 64, 96, 8, 2


def _moe_params(seed=0):
    return {
        "w_router": _rand((D, E), seed, D ** -0.5),
        "experts_gate": _rand((E, D, F), seed + 1, D ** -0.5),
        "experts_up": _rand((E, D, F), seed + 2, D ** -0.5),
        "experts_down": _rand((E, F, D), seed + 3, F ** -0.5),
    }


def _both(fmt, p_np):
    """The reference's and the port's MoE params (the port's quantized
    leaves carried across from the reference's stacked ones)."""
    jpol, tpol = jax_policy(fmt), make_policy(fmt)
    jp = {k: jnp.asarray(v).astype(jnp.float32 if k == "w_router"
                                   else jpol.param_dtype)
          for k, v in p_np.items()}
    jp = jax_apply.quantize_params(jp, jpol)
    tp = {k: _carry(v) for k, v in jp.items()}
    return jp, tp, jpol, tpol


def _carry(v):
    """A reference array or quantized leaf as the port's."""
    if isinstance(v, tuple):
        cls = {"Int8Weight": pt_int8.Int8Weight,
               "NF4Weight": pt_nf4.NF4Weight}[type(v).__name__]
        return cls(*(to_torch(f) for f in v))
    return to_torch(v)


# (fmt, T, capacity factor, relative tolerance): f32 and bf16 without
# drops (capacity 8 x the mean load) and with drops (capacity 1.0 at
# T = 64: 128 assignments over 8 experts of 16 rows). bf16 at 2e-2 (one
# bf16 rounding of f32 sums taken in other orders per product); int8 and
# nf4 at 5e-2: the reference path applies int8's scale before the
# product, the port's kernel after it (TEACHER_TOL of the model tests).
MOE_CASES = [("float32", 16, 8.0, 1e-5), ("float32", 64, 1.0, 1e-5),
             ("bfloat16", 16, 8.0, 2e-2), ("bfloat16", 64, 1.0, 2e-2),
             ("int8", 64, 1.0, 5e-2), ("nf4", 64, 1.0, 5e-2)]


def _ref_moe(jp, x, jpol, cf):
    """The reference's ``_moe_ffn_local``, compiled."""
    return jax.jit(lambda p, x_: jax_moe._moe_ffn_local(
        p, x_, top_k=TOP_K, policy=jpol, capacity_factor=cf))(jp, x)


@pytest.mark.parametrize("fmt,T,cf,tol", MOE_CASES)
def test_moe_ffn_matches_reference(fmt, T, cf, tol, monkeypatch):
    """Output within ``tol`` of the max |y|, relative; dropped_fraction
    equal; load-balance and z-loss within 1e-6 (both f32 from the same
    f32 router)."""
    jp, tp, jpol, tpol = _both(fmt, _moe_params())
    x = _rand((T, D), 7)
    xd = "float32" if fmt == "float32" else "bfloat16"
    if fmt == "int8":
        host_expert_product(monkeypatch)
    jy, jaux = _ref_moe(jp, jnp.asarray(x).astype(xd), jpol, cf)
    ty, taux = pt_moe.moe_ffn(tp, torch.from_numpy(x).to(getattr(torch, xd)),
                              top_k=TOP_K, policy=tpol, capacity_factor=cf)
    assert ty.dtype == tpol.compute_dtype
    assert rel_err(ty, jy) < tol
    assert float(taux["dropped_fraction"]) == float(jaux["dropped_fraction"])
    if cf == 1.0:
        assert float(taux["dropped_fraction"]) > 0   # the trash slot ran
    for k in ("load_balance_loss", "router_z_loss"):
        assert abs(float(taux[k]) - float(jaux[k])) <= 1e-6 * max(
            1.0, abs(float(jaux[k]))), k


def test_moe_routing_ties_take_the_lower_expert():
    """Equal router probabilities: top-k takes the lower expert ids, as
    jax.lax.top_k does, and the combine is the reference's."""
    p = _moe_params(3)
    p["w_router"][:, 4:] = p["w_router"][:, :4]    # experts e and e + 4 tie
    x = _rand((16, D), 8)
    jp, tp, jpol, tpol = _both("float32", p)
    _, _, _, ids = pt_moe.route(torch.from_numpy(x), tp["w_router"], TOP_K)
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["w_router"], -1)
    np.testing.assert_array_equal(ids.numpy(),
                                  np.asarray(jax.lax.top_k(probs, TOP_K)[1]))
    # the top two are a tied pair: the lower id first
    assert (ids[:, 0] < 4).all() and (ids[:, 1] == ids[:, 0] + 4).all()
    jy, _ = _ref_moe(jp, jnp.asarray(x), jpol, 8.0)
    ty, _ = pt_moe.moe_ffn(tp, torch.from_numpy(x), top_k=TOP_K,
                           policy=tpol, capacity_factor=8.0)
    assert rel_err(ty, jy) < 1e-5


@pytest.mark.parametrize("T,E_,k,cf", [(4, 128, 8, 1.25), (512, 128, 8, 1.25),
                                       (4, 128, 8, 16.0), (512, 32, 8, 1.25),
                                       (100, 4, 2, 8.0)])
def test_expert_capacity_matches_reference(T, E_, k, cf):
    assert pt_moe.expert_capacity(T, E_, k, cf) \
        == jax_moe.expert_capacity(T, E_, k, cf)


# ---------------------------------------------------------------------------
# the grouped plain versions against the Pallas kernels under jax.vmap
# ---------------------------------------------------------------------------
GE, GK, GN = 4, 256, 128


@pytest.mark.parametrize("C", [8, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ["int8", "nf4"])
def test_grouped_plain_matches_pallas_under_vmap(fmt, dtype, C):
    """E = 4 experts: f32 at 1e-5, bf16 at 2e-2 relative (one bf16
    rounding of f32 sums taken in other orders)."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    x = _rand((GE, C, GK), 1)
    w = _rand((GE, GK, GN), 2, 0.05)
    if fmt == "int8":
        qs = [quantize_int8(jnp.asarray(w[e])) for e in range(GE)]
        a, b = (jnp.stack([q.codes for q in qs]),
                jnp.stack([q.scale for q in qs]))
        ref = jax.vmap(lambda x_, a_, b_: int8_matmul_pallas(
            x_, a_, b_, compute_dtype=jd, bm=C, bn=64, bk=128))(
            jnp.asarray(x), a, b)
        got = K.int8_matmul_grouped(torch.from_numpy(x), to_torch(a),
                                    to_torch(b), td)
    else:
        qs = [quantize_nf4(jnp.asarray(w[e]), 64) for e in range(GE)]
        a, b = (jnp.stack([q.packed for q in qs]),
                jnp.stack([q.absmax for q in qs]))
        ref = jax.vmap(lambda x_, a_, b_: nf4_matmul_pallas(
            x_, a_, b_, compute_dtype=jd, bm=C, bn=64, bk=128))(
            jnp.asarray(x), a, b)
        got = K.nf4_matmul_grouped(torch.from_numpy(x), to_torch(a),
                                   to_torch(b), td)
    assert got.shape == (GE, C, GN) and got.dtype == td
    assert rel_err(got, ref) < tol


@pytest.mark.parametrize("fmt", ["int8", "nf4"])
def test_grouped_ops_match_reference_ops_under_vmap(fmt):
    """The grouped entry points with int8's outlier product, against the
    reference's ops under jax.vmap (its ``_expert_dense`` with the Pallas
    kernels), f32 at 1e-5."""
    x = _rand((GE, 8, GK), 3)
    w = jnp.asarray(_rand((GE, GK, GN), 4, 0.05))
    pol = jax_policy(fmt)
    pol = dataclasses.replace(pol, compute_dtype=jnp.float32)
    q = jax_apply._quantize_leaf("/experts_gate", w, pol)
    fn = jax_ops.int8_matmul_kernel if fmt == "int8" \
        else jax_ops.nf4_matmul_kernel
    ref = jax.vmap(lambda x_, q_: fn(x_, q_, compute_dtype=jnp.float32))(
        jnp.asarray(x), q)
    tq = _carry(q)
    gfn = pt_ops.int8_matmul_grouped_kernel if fmt == "int8" \
        else pt_ops.nf4_matmul_grouped_kernel
    got = gfn(torch.from_numpy(x), tq, torch.float32)
    np.testing.assert_allclose(to_numpy(got), to_numpy(ref), rtol=1e-5,
                               atol=1e-5)


def test_grouped_cpu_calls_take_the_plain_version_without_a_launch():
    K.reset_launches()
    x = torch.from_numpy(_rand((3, 5, 128), 0))
    w = torch.from_numpy(_rand((3, 128, 32), 1))
    q8, q4 = pt_int8.quantize_int8(w), pt_nf4.quantize_nf4(w, 64)
    assert torch.equal(K.int8_matmul_grouped(x, q8.codes, q8.scale),
                       K.int8_matmul_plain(x, q8.codes, q8.scale))
    assert torch.equal(K.nf4_matmul_grouped(x, q4.packed, q4.absmax),
                       K.nf4_matmul_plain(x, q4.packed, q4.absmax))
    assert not any(K.LAUNCHES.values())


def test_grouped_calls_on_other_devices_raise():
    x = torch.empty((2, 4, 128), device="meta")
    codes = torch.empty((2, 128, 32), dtype=torch.int8, device="meta")
    scale = torch.empty((2, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        K.int8_matmul_grouped(x, codes, scale)


# ---------------------------------------------------------------------------
# stacked quantization
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["int8", "nf4"])
def test_stacked_quantization_is_per_slice_bytes(fmt):
    """An (E, in, out) leaf quantized batched gives, slice by slice, the
    bytes of quantizing the slice alone (int8's outlier rows included,
    with tied rows), and the reference's stacked leaf byte for byte."""
    w = _rand((4, 256, 96), 5)
    w[1, 10] = w[1, 20]                 # tied outlier candidates
    w[2, 3] = 0.0
    pol = make_policy(fmt)
    got = pt_apply._quantize_leaf("/experts_up", torch.from_numpy(w), pol)
    ref = jax_apply._quantize_leaf("/experts_up", jnp.asarray(w),
                                   jax_policy(fmt))
    assert type(got).__name__ == type(ref).__name__
    for e in range(4):
        one = pt_apply._quantize_leaf("/w_up", torch.from_numpy(w[e]), pol)
        for g, o in zip(got, one):
            assert torch.equal(g[e], o)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(to_numpy(g), to_numpy(r))
    if fmt == "int8":
        assert got.outlier_idx.shape == (4, 3)
        deq = pt_int8.dequantize_int8(got, torch.float32)
    else:
        deq = pt_nf4.dequantize_nf4(got, torch.float32)
    assert deq.shape == w.shape


# ---------------------------------------------------------------------------
# the grouped launch plan and walks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("C,Kd,N,experts,block", [
    (8, 2048, 768, 128, None), (8, 768, 2048, 128, 64),
    (8, 1024, 512, 32, None), (4, 256, 208, 3, 32), (1, 64, 16, 5, 64)])
def test_grouped_decode_walk_covers_every_k_step_once(C, Kd, N, experts,
                                                      block):
    """qwen3 and granite decode shapes, every expert kept (rows=None):
    every (expert, column tile, K step) is walked by exactly one block,
    each tile's steps in its fixed K segments, the blocks' shares differ
    by at most one segment, and the scratch covers every split tile's
    slots and counter."""
    plan = K.matmul_plan(C, N, Kd, 132, block=block, experts=experts,
                         grouped=True)
    assert plan.loop == "decode" and plan.experts == experts
    n_tiles, nk = -(-N // plan.bn), Kd // K.WG_BK
    assert plan.seg == (1 if experts * n_tiles <= 132
                        else max(1, nk // K.DEC_SEG_STEPS))
    seen = {}
    share = {}
    blocks = {}
    for b, t, k0, k1 in K.decode_segments(plan, N, Kd):
        e, col = divmod(t, n_tiles)
        assert 0 <= e < experts
        for k in range(k0, k1):
            seen[(e, col, k)] = seen.get((e, col, k), 0) + 1
        share[b] = share.get(b, 0) + 1
        blocks.setdefault(t, set()).add(b)
    assert seen == {(e, c, k): 1 for e in range(experts)
                    for c in range(n_tiles) for k in range(nk)}
    assert max(share.values()) - min(share.values()) <= 1
    assert plan.grid == min(132, experts * n_tiles * plan.seg)
    n_part, n_count = K.decode_scratch(plan, N)
    assert n_count == plan.grid
    assert n_part == plan.grid * plan.seg * K.DEC_M * plan.bn
    assert all(min(bs) < n_count for bs in blocks.values())


@pytest.mark.parametrize("C,Kd,N,experts,block", [
    (40, 2048, 768, 128, None), (40, 768, 2048, 128, 64),
    (160, 1024, 512, 32, None), (160, 512, 1024, 32, 64),
    (130, 256, 208, 3, 32)])
def test_grouped_wgmma_plan_covers_every_tile_once(C, Kd, N, experts,
                                                   block):
    """qwen3 and granite prefill shapes: the grouped tile numbering
    (expert outermost) reaches every (expert, row, column) of the output
    exactly once, and the grid is at most one block per SM."""
    plan = K.matmul_plan(C, N, Kd, 132, block=block, experts=experts)
    assert plan.loop == "wgmma" and plan.experts == experts
    m_tiles, tiles = K.wgmma_tiles(C, N, plan.bm, plan.bn)
    assert plan.grid == min(132, experts * tiles)
    covered = np.zeros((experts, m_tiles * plan.bm, -(-N // plan.bn)
                        * plan.bn), np.int32)
    for t in range(experts * tiles):
        e, r = divmod(t, tiles)
        m0, n0 = K.tile_origin(r, m_tiles, plan.bm, plan.bn)
        covered[e, m0:m0 + plan.bm, n0:n0 + plan.bn] += 1
    assert (covered == 1).all()


def test_grouped_plan_is_the_2d_plan_for_one_expert():
    for M, N, Kd in ((4, 14336, 4096), (464, 4096, 4096), (40, 768, 2048)):
        assert K.matmul_plan(M, N, Kd, 132) \
            == K.matmul_plan(M, N, Kd, 132, experts=1)


# ---------------------------------------------------------------------------
# the layer-by-layer weight build
# ---------------------------------------------------------------------------
def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield f"{path}.{i}", v
    else:
        yield path, tree


@pytest.mark.parametrize("fmt", ["int8", "nf4"])
@pytest.mark.parametrize("cfg", [PAPER_MODELS["llama-3.1-8b"].reduced(),
                                 get_config("qwen3-moe-30b-a3b").reduced()],
                         ids=["llama-3.1-8b", "qwen3-moe-30b-a3b"])
def test_layerwise_build_is_draw_all_then_quantize(cfg, fmt):
    """build_params quantizes each layer as it is drawn: the same bytes
    as drawing every master weight, then quantizing the tree."""
    model = build_model(cfg, fmt=fmt, device="cpu")
    got = dict(_leaves(build_params(model, seed=0)))
    gen = torch.Generator(device="cpu").manual_seed(0)
    ref = dict(_leaves(model.quantize(model.init(gen))))
    assert got.keys() == ref.keys()
    assert any(".0" in k for k in got)          # quantized leaves
    for k in ref:
        assert got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k]), k
