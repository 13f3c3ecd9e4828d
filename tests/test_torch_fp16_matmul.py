"""The float16 format's product through the fp16 kernel
(``repro_torch.kernels.quant_matmul.kernel.fp16_matmul``): its plain
version against the reference's ``linear_apply`` under the float16
policy; the CPU path bit for bit against ``torch.matmul(x.to(cd),
w.to(cd))``, which it replaces; the routing of ``linear_apply``; the meta
record against ``kernels/cost.py``; the plan's tiles. The tests marked
``gpu`` hold the CUDA kernel against its plain version on the card, with
one launch a call, and check the conversion bit for bit (ties included)
through one-hot rows of x; they import no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_fp16_matmul.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.op_analysis import OpCounter  # noqa: E402
from repro_torch.core.precision import make_policy  # noqa: E402
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.kernels.quant_matmul import kernel as K  # noqa: E402
from repro_torch.quant import apply as pt_apply  # noqa: E402


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("shape", [(4, 256), (2, 9, 512), (130, 128)])
def test_fp16_plain_matches_reference_linear_apply(shape):
    """x (..., K) @ an fp16 weight under the float16 policy: the port's
    ``linear_apply`` (the fp16 kernel's plain version on the CPU) against
    the reference's, 2e-2 relative (bf16 outputs of f32 sums taken in
    other orders)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core.precision import make_policy as jax_policy
    from repro.quant import apply as jax_apply
    import _torch_parity as tp
    Kd = shape[-1]
    x = _rand(shape, 0)
    w = _rand((Kd, 96), 1, Kd ** -0.5).astype(np.float16)
    want = jax_apply.linear_apply(jnp.asarray(w), jnp.asarray(x),
                                  jax_policy("float16"))
    got = pt_apply.linear_apply(torch.from_numpy(w), torch.from_numpy(x),
                                make_policy("float16"))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == \
        shape[:-1] + (96,)
    assert tp.rel_err(got, want) < 2e-2


@pytest.mark.parametrize("shape", [(4, 256), (2, 9, 256), (3, 1, 256)])
def test_cpu_path_is_the_expression_it_replaces(shape):
    """On the CPU ``linear_apply`` and the kernel's wrapper give the bits
    of ``torch.matmul(x.to(bf16), w.to(bf16))``, with no launch."""
    K.reset_launches()
    x = torch.from_numpy(_rand(shape, 2))
    w = torch.from_numpy(_rand((256, 48), 3, 0.06)).half()
    want = torch.matmul(x.to(torch.bfloat16), w.to(torch.bfloat16))
    got = pt_apply.linear_apply(w, x, make_policy("float16"))
    assert torch.equal(got, want)
    x2 = x.reshape(-1, 256).to(torch.bfloat16)
    assert torch.equal(K.fp16_matmul(x2, w), want.reshape(-1, 48))
    assert torch.equal(K.fp16_matmul_plain(x2, w), want.reshape(-1, 48))
    assert not any(K.LAUNCHES.values())


def _recorded(w, x, policy):
    with OpCounter() as c:
        out = pt_apply.linear_apply(w, x, policy)
    return out, c.cost


def test_linear_apply_routes_2d_fp16_weights_under_bf16_to_the_kernel():
    """On the meta device under a cost analysis: a 2-D float16 weight with
    the float16 policy (bf16 compute) is one fp16_matmul record, priced by
    kernels/cost.py over the fp16 bytes, as chip_smoke prices its bound;
    a 3-D float16 stack (experts) is one fp16_matmul_grouped record
    (tests/test_torch_grouped16.py); an f32 compute dtype and a 2-D bf16
    weight keep the plain product and record no kernel."""
    M, Kd, N = 6, 512, 384
    x = torch.empty((2, 3, Kd), dtype=torch.bfloat16, device="meta")
    w = torch.empty((Kd, N), dtype=torch.float16, device="meta")
    out, c = _recorded(w, x, make_policy("float16"))
    assert out.shape == (2, 3, N) and out.dtype == torch.bfloat16
    assert c.kernels == {"fp16_matmul": 1}
    nbytes, flops = cost.quant_matmul(M, Kd, N, 2 * Kd * N)
    assert (c.dot_flops, c.dot_bytes) == (flops, nbytes)
    with OpCounter() as c3:
        pt_apply.linear_apply(torch.empty((4, Kd, N), dtype=torch.float16,
                                          device="meta"),
                              x[:1].expand(4, 3, Kd),
                              make_policy("float16"))
    assert c3.cost.kernels == {"fp16_matmul_grouped": 1}
    for w_, pol in ((w, make_policy("float16", torch.float32)),
                    (w.to(torch.bfloat16), make_policy("bfloat16"))):
        with OpCounter() as c2:
            pt_apply.linear_apply(w_, x, pol)
        assert c2.cost.kernels == {}


def test_fp16_wrapper_refuses_other_devices_and_grads():
    x = torch.empty((4, 128), device="meta")
    w = torch.empty((128, 32), dtype=torch.float16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        K.fp16_matmul(x, w)
    xg = torch.randn(4, 128, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        K.fp16_matmul(xg, torch.randn(128, 32).half())


def test_ring_stages_mirror_the_kernel_layout():
    """Every int8 and nf4 tile keeps a ring of at least five stages (the
    plan is theirs as before); fp16's 256 x 128 holds four and is never
    planned, its others five or more."""
    for fmt in ("int8", "nf4"):
        assert all(K.ring_stages(fmt, *t) >= 5 for t in K.WG_TILES), fmt
    assert K.ring_stages("fp16", 256, 128) == 4
    assert all(K.ring_stages("fp16", *t) >= 5 for t in K.WG_TILES
               if t != (256, 128))
    for M in (9, 130, 464, 512, 2064):
        for Kd, N in ((4096, 4096), (4096, 1024), (4096, 14336),
                      (14336, 4096), (4096, 128256)):
            plan = K.matmul_plan(M, N, Kd, 132, fmt="fp16")
            assert plan.loop == "wgmma"
            assert (plan.bm, plan.bn) != (256, 128)


@pytest.mark.parametrize("M", [1, 4, 8])
def test_lm_head_decode_plan_tiles_its_vocabulary(M):
    """llama's (4096, 128256) lm_head at decode: 1002 column tiles of 128,
    their K steps shared out over one block per SM, each step once."""
    plan = K.matmul_plan(M, 128256, 4096, 132, fmt="fp16")
    assert (plan.loop, plan.bn, plan.grid) == ("decode", 128, 132)
    segs = K.decode_segments(plan, 128256, 4096)
    steps = sorted((t, k) for _, t, k0, k1 in segs for k in range(k0, k1))
    assert steps == [(t, k) for t in range(1002) for k in range(64)]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _rel(got, ref) -> float:
    got, ref = got.float().cpu(), ref.float().cpu()
    return ((got - ref).abs().max() / (ref.abs().max() + 1e-12)).item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("Kd,N", [(512, 208), (1024, 1040), (4096, 1024),
                                  (320, 200)])
@pytest.mark.parametrize("M", [1, 5, 8, 9, 130, 464])
def test_cuda_fp16_matches_plain(M, Kd, N, dtype):
    """On the card: the fp16 kernel against its plain version, one launch
    a call: bf16 on the decode loop (M <= 8) and the wgmma loop, (208:
    the last 128-column tile's second box past N; 1040), f32 and (320,
    200) on the tile loop; bf16 at 1e-2 relative, f32 at 1e-5."""
    _cuda()
    td = getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 1e-2
    gen = torch.Generator(device="cuda").manual_seed(M + N)
    x = torch.randn((M, Kd), generator=gen, device="cuda").to(td)
    w = (torch.randn((Kd, N), generator=gen, device="cuda")
         * Kd ** -0.5).half()
    before = K.LAUNCHES["fp16_matmul"]
    got = K.fp16_matmul(x, w, td)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fp16_matmul"] == before + 1
    assert _rel(got, K.fp16_matmul_plain(x, w, td)) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [(256, 64), (128, 128), (128, 64),
                                  (64, 128), (64, 64)])
@pytest.mark.parametrize("M", [9, 130, 464])
def test_cuda_fp16_wgmma_loop_at_every_tile(M, tile, monkeypatch):
    """On the card: the fp16 prefill loop at each tile it may take, forced
    through the plan, 1e-2 relative."""
    _cuda()
    monkeypatch.setattr(K, "WG_TILES", (tile,))
    K._device_plan.cache_clear()
    try:
        gen = torch.Generator(device="cuda").manual_seed(M)
        x = torch.randn((M, 1024), generator=gen, device="cuda").to(
            torch.bfloat16)
        w = (torch.randn((1024, 1040), generator=gen, device="cuda")
             / 32).half()
        before = K.LOOP_LAUNCHES["fp16_matmul"]["wgmma"]
        got = K.fp16_matmul(x, w)
        torch.cuda.synchronize()
        assert K.LOOP_LAUNCHES["fp16_matmul"]["wgmma"] == before + 1
        assert _rel(got, K.fp16_matmul_plain(x, w)) < 1e-2
    finally:
        K._device_plan.cache_clear()


def _tie_weights(gen, Kd, N):
    """fp16 weights, finite and non-zero, half of them exactly halfway
    between two bf16 values (the 3 mantissa bits bf16 drops are 100), of
    both parities of the bf16 mantissa, over the fp16 exponents."""
    bits = torch.randint(0, 1 << 16, (Kd, N), generator=gen, device="cuda",
                         dtype=torch.int32)
    exp = (bits >> 10) & 0x1F
    bits = torch.where(exp == 0x1F, bits & ~(0x1F << 10) | (0x0F << 10),
                       bits)
    tie = torch.rand((Kd, N), generator=gen, device="cuda") < 0.5
    bits = torch.where(tie, (bits & ~0x7) | 0x4, bits)
    bits = torch.where((bits & 0x7FFF) == 0, bits | 0x3C00, bits)
    bits = torch.where(bits >= 1 << 15, bits - (1 << 16), bits)
    return bits.to(torch.int16).view(torch.float16)


@pytest.mark.gpu
@pytest.mark.parametrize("Kd,N", [(512, 208), (256, 1040)])
def test_cuda_one_hot_rows_give_the_converted_weights(Kd, N):
    """On the card: x the identity's rows, so out = w.to(bfloat16) bit for
    bit, ties to even included: at decode 8 rows a call (x = I[8i:8i+8])
    and at prefill all K rows in one call."""
    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(Kd + N)
    w = _tie_weights(gen, Kd, N)
    want = w.to(torch.bfloat16)
    eye = torch.eye(Kd, device="cuda", dtype=torch.bfloat16)
    assert ((w.view(torch.int16) & 0x7) == 0x4).float().mean() > 0.4
    assert torch.equal(K.fp16_matmul(eye, w).view(torch.int16),
                       want.view(torch.int16))
    for i in range(0, Kd, 8):
        got = K.fp16_matmul(eye[i:i + 8].contiguous(), w)
        assert torch.equal(got.view(torch.int16),
                           want[i:i + 8].view(torch.int16)), i


@pytest.mark.gpu
@pytest.mark.parametrize("M", [4, 464])
def test_cuda_fp16_call_is_one_kernel_node(M):
    """On the card: one call captured in a CUDA graph is one kernel node
    (no conversion kernel)."""
    _cuda()
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    gen = torch.Generator(device="cuda").manual_seed(M)
    x = torch.randn((M, 4096), generator=gen, device="cuda").to(
        torch.bfloat16)
    w = (torch.randn((4096, 1024), generator=gen, device="cuda")
         / 64).half()
    assert chip_smoke.graph_nodes(torch, lambda: K.fp16_matmul(x, w)) == [0]


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 4])
def test_cuda_fp16_lm_head(M):
    """On the card: llama's (4096, 128256) lm_head at decode, 1e-2."""
    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(M)
    x = torch.randn((M, 4096), generator=gen, device="cuda").to(
        torch.bfloat16)
    w = (torch.randn((4096, 128256), generator=gen, device="cuda")
         / 64).half()
    assert _rel(K.fp16_matmul(x, w), K.fp16_matmul_plain(x, w)) < 1e-2
