"""Flash attention's gradient in the port: the backward kernel's plain
version (``flash_attention_backward_plain``) and the autograd Function's
CPU path (``flash_attention`` on inputs that require grad) against
``jax.vjp`` of the reference's ``repro.models.layers.attention`` (the
attention its training differentiates), f32, within 2e-5: causal,
windowed, GQA and unmasked cross-attention, head_dim 64, 96 and 120,
ragged S != T. In bf16, the plain backward against the same ``jax.vjp``
in f32 on the bf16-rounded inputs, and its rounding points (P and dS to
bf16 before their products, as the kernel's tensor cores take them)
against explicit f32 einsums. Also the logsumexp the forward keeps, and
the wrappers
that have no backward (the quant and paged kernels) refusing inputs
that require grad. tests/test_torch_cuda.py holds the CUDA kernels
against these plain versions on the card."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models.layers import attention as jax_attention  # noqa: E402

from repro_torch.kernels.flash_attention import kernel as K  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as PK  # noqa: E402
from repro_torch.kernels.quant_matmul import kernel as QK  # noqa: E402
from repro_torch.quant import int8 as pt_int8  # noqa: E402
from repro_torch.quant import nf4 as pt_nf4  # noqa: E402

from _torch_parity import check_allclose  # noqa: E402
from _torch_training import few_threads  # noqa: E402,F401

TOL = 2e-5      # tests/test_kernels.py's f32 attention tolerance

# (B, S, T, H, Kv, d, causal, window)
CASES = [
    (2, 70, 70, 4, 2, 64, True, None),         # causal, ragged tiles
    (1, 150, 150, 4, 4, 64, True, 40),         # windowed
    (2, 33, 33, 8, 2, 64, True, None),         # GQA, G = 4
    (2, 20, 33, 4, 4, 64, False, None),        # cross: unmasked S != T
    (1, 40, 70, 4, 2, 96, True, None),         # head_dim 96, S < T
    (1, 70, 40, 4, 1, 120, True, None),        # head_dim 120, S > T
    (1, 131, 131, 2, 1, 120, True, 64),        # head_dim 120, windowed
]
IDS = [f"B{c[0]}S{c[1]}T{c[2]}H{c[3]}Kv{c[4]}d{c[5]}"
       f"{'c' if c[6] else 'x'}{c[7] or ''}" for c in CASES]
# bf16: GQA, windowed, head_dim 120 with S > T, unmasked S < T
BF16 = [2, 1, 5, 3]
# bf16 plain backward vs the f32 reference on the same rounded inputs:
# max |error| over max |reference|, each of dq, dk, dv. The output, P and
# dS each round to bf16 (2^-9 of an element), so an output is off by a few
# 2^-9 of the max (about 5e-3 at these shapes); chip_smoke holds the
# kernel to its plain version within the same 1e-2
BF16_TOL = 1e-2


def _inputs(B, S, T, H, Kv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, d)).astype(np.float32),
            rng.standard_normal((B, T, Kv, d)).astype(np.float32),
            rng.standard_normal((B, T, Kv, d)).astype(np.float32),
            rng.standard_normal((B, S, H, d)).astype(np.float32))


def _bf16(a):
    return torch.from_numpy(a).bfloat16()


@functools.lru_cache(maxsize=None)
def _reference(case, rounded=False):
    """The case's inputs (with ``rounded``, rounded to bf16 and held in
    f32), and the reference's output and gradients: one compiled
    ``jax.vjp``, shared by the tests of a case."""
    B, S, T, H, Kv, d, causal, window = case
    q, k, v, do = _inputs(B, S, T, H, Kv, d)
    if rounded:
        q, k, v, do = (_bf16(a).float().numpy() for a in (q, k, v, do))

    @jax.jit
    def fwd_bwd(q_, k_, v_, do_):
        out, vjp = jax.vjp(lambda a, b, c: jax_attention(
            a, b, c, causal=causal, window=window), q_, k_, v_)
        return out, vjp(do_)

    out, grads = fwd_bwd(*map(jnp.asarray, (q, k, v, do)))
    return (q, k, v, do), np.asarray(out), [np.asarray(g) for g in grads]


def _close(got, want):
    check_allclose(got.detach().numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_backward_plain_matches_jax_vjp(case):
    causal, window = case[6:]
    (q, k, v, do), out_ref, grads_ref = _reference(case)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = K.flash_attention_plain(tq, tk, tv, causal=causal,
                                       window=window, return_lse=True)
    _close(out, out_ref)
    grads = K.flash_attention_backward_plain(tq, tk, tv, out, lse, tdo,
                                             causal=causal, window=window)
    for got, want in zip(grads, grads_ref):
        _close(got, want)


@pytest.mark.parametrize("case", [CASES[i] for i in BF16],
                         ids=[IDS[i] for i in BF16])
def test_bf16_backward_plain_matches_jax_vjp(case):
    """The bf16 plain backward (the kernel's rounding points) on the
    plain bf16 forward's output and logsumexp, against the reference's
    f32 gradients on the same bf16-rounded inputs, within BF16_TOL."""
    causal, window = case[6:]
    (q, k, v, do), _, grads_ref = _reference(case, rounded=True)
    tq, tk, tv, tdo = map(_bf16, (q, k, v, do))
    out, lse = K.flash_attention_plain(tq, tk, tv, causal=causal,
                                       window=window, return_lse=True)
    grads = K.flash_attention_backward_plain(tq, tk, tv, out, lse, tdo,
                                             causal=causal, window=window)
    for got, want in zip(grads, grads_ref):
        assert got.dtype == torch.bfloat16
        err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
        assert err < BF16_TOL


def _explicit_bf16_grads(q, k, v, o, lse, do, causal, window, rounded):
    """(dq, dk, dv) as f32 einsums over every head and key at once, from
    bf16 inputs: P and dS rounded to bf16 before their products when
    ``rounded``, else kept in f32; each output rounded once to bf16."""
    B, S, H, d = q.shape
    T, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    scale = 1.0 / d ** 0.5
    qf, of, dof = q.float(), o.float(), do.float()
    kf, vf = (t.float().repeat_interleave(G, dim=2) for t in (k, v))
    s = torch.einsum("bshd,bthd->bhst", qf, kf) * scale
    allow = K.visible(S, T, causal, window, "cpu")
    p = torch.where(allow, torch.exp(s - lse[..., None]), torch.zeros(()))
    delta = (dof * of).sum(-1).permute(0, 2, 1)
    ds = p * (torch.einsum("bshd,bthd->bhst", dof, vf) - delta[..., None])
    if rounded:
        p, ds = p.bfloat16().float(), ds.bfloat16().float()
    dq = torch.einsum("bhst,bthd->bshd", ds, kf) * scale
    dk = torch.einsum("bhst,bshd->bthd", ds, qf) * scale
    dv = torch.einsum("bhst,bshd->bthd", p, dof)
    return (dq.bfloat16(),
            dk.reshape(B, T, Kv, G, d).sum(3).bfloat16(),
            dv.reshape(B, T, Kv, G, d).sum(3).bfloat16())


@pytest.mark.parametrize("case", [CASES[i] for i in BF16],
                         ids=[IDS[i] for i in BF16])
def test_bf16_backward_plain_rounds_p_and_ds(case):
    """The bf16 plain backward equals the explicit einsums that round P
    and dS to bf16 (up to one bf16 step where the two sums in other
    orders straddle a rounding point, on at most 1e-3 of the elements),
    and not the ones that keep them in f32 (which differ on about 40% of
    the elements): the rounding points the kernel mirrors."""
    B, S, T, H, Kv, d, causal, window = case
    q, k, v, do = map(_bf16, _inputs(B, S, T, H, Kv, d))
    out, lse = K.flash_attention_plain(q, k, v, causal=causal,
                                       window=window, return_lse=True)
    got = K.flash_attention_backward_plain(q, k, v, out, lse, do,
                                           causal=causal, window=window)
    want = _explicit_bf16_grads(q, k, v, out, lse, do, causal, window, True)
    f32 = _explicit_bf16_grads(q, k, v, out, lse, do, causal, window, False)
    for g, w, f in zip(got, want, f32):
        gf, wf = g.float(), w.float()
        assert ((gf - wf).abs() <= wf.abs() * 2.0 ** -7).all()
        assert (g != w).float().mean().item() <= 1e-3
        assert (g != f).float().mean().item() > 0.1


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_autograd_function_matches_jax_vjp(case):
    """The autograd Function's CPU path: the plain forward keeping lse and
    the plain backward, as the card runs the two kernels."""
    causal, window = case[6:]
    (q, k, v, do), out_ref, grads_ref = _reference(case)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = K.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    _close(out, out_ref)
    out.backward(torch.from_numpy(do))
    for got, want in zip((tq.grad, tk.grad, tv.grad), grads_ref):
        _close(got, want)


def test_lse_is_the_rows_logsumexp():
    q, k, v, _ = _inputs(2, 70, 70, 4, 2, 64)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    _, lse = K.flash_attention_plain(tq, tk, tv, causal=True, window=20,
                                     return_lse=True)
    s = torch.einsum("bshd,bthd->bhst", tq,
                     tk.repeat_interleave(2, dim=2)) / 8.0
    allow = K.visible(70, 70, True, 20, "cpu")
    want = torch.logsumexp(s.masked_fill(~allow, -float("inf")), dim=-1)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), rtol=TOL,
                               atol=TOL)


def test_no_grad_forward_keeps_no_graph():
    q, k, v, _ = _inputs(1, 16, 16, 2, 2, 64)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    with torch.no_grad():
        out = K.flash_attention(tq, tk, tv)
    assert out.grad_fn is None
    plain = K.flash_attention_plain(tq.detach(), tk.detach(), tv.detach())
    assert torch.equal(out, plain)


def _quant_calls(x):
    w = torch.randn((64, 32), generator=torch.Generator().manual_seed(0))
    q8, q4 = pt_int8.quantize_int8(w), pt_nf4.quantize_nf4(w, 64)
    return {
        "int8_matmul": lambda: QK.int8_matmul(x, q8.codes, q8.scale,
                                              torch.float32),
        "nf4_matmul": lambda: QK.nf4_matmul(x, q4.packed, q4.absmax,
                                            torch.float32),
        "int8_matmul_grouped": lambda: QK.int8_matmul_grouped(
            x[None], q8.codes[None], q8.scale[None], torch.float32),
        "nf4_matmul_grouped": lambda: QK.nf4_matmul_grouped(
            x[None], q4.packed[None], q4.absmax[None], torch.float32),
    }


@pytest.mark.parametrize("name", ["int8_matmul", "nf4_matmul",
                                  "int8_matmul_grouped",
                                  "nf4_matmul_grouped"])
def test_quant_kernels_refuse_grad(name):
    """The quant kernels have no backward (the reference cannot train
    quantized weights either): an input that requires grad raises while
    grad mode is on, and runs under no_grad."""
    x = torch.randn((4, 64), requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        _quant_calls(x)[name]()
    with torch.no_grad():
        assert _quant_calls(x)[name]().shape[-1] == 32


def test_paged_attention_refuses_grad():
    q = torch.randn((2, 4, 64), requires_grad=True)
    pages = torch.randn((3, 16, 2, 64))
    table = torch.tensor([[0, 1], [2, -1]], dtype=torch.int32)
    lens = torch.tensor([20, 9], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no backward"):
        PK.paged_attention(q, pages, pages, table, lens)
    with torch.no_grad():
        out = PK.paged_attention(q, pages, pages, table, lens)
    assert out.shape == q.shape
