"""The fused elementwise passes (``repro_torch.kernels.fused``): RMS
normalisation, RoPE over q and k, and ``silu(g) * u``. Their plain
versions against the reference's functions (``repro.models.layers``
``rms_norm`` and ``apply_rope``, ``jax.nn.silu(g) * u``); ``rope_qk`` bit
for bit two ``apply_rope`` calls; the cached frequency table bit for bit a
fresh ``rope_frequencies``; the routing of the model's layer functions
(no launch on the CPU, the plain version's gradient for a call autograd
records, one record each on the meta device, DTensors through each
rank's shards); the host plans. The tests marked ``gpu`` hold each CUDA
kernel against its plain version on the card at the served shapes, one
kernel node a call, a call autograd records through the kernel, and a
graph replay bit for bit the eager calls; they import no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_fused.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.op_analysis import OpCounter  # noqa: E402
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.kernels.fused import kernel as K  # noqa: E402
from repro_torch.models import layers  # noqa: E402

#: the three kernels this file holds (``tests/test_torch_ssm_step.py``
#: holds the Mamba2 step's two)
NAMES = ("rms_norm", "rope_qk", "silu_mul")
SSM_NAMES = ("ssm_conv_step", "ssd_step")
HEAD_DIMS = (64, 96, 120, 128)
THETA = 500000.0
F32_TOL = 2e-5          # tests/test_torch_model.py's f32 layer tolerance
BF16_TOL = 1e-2         # one rounding of the same f32 value


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _rel(got, ref) -> float:
    got = np.asarray(torch.as_tensor(got).float().cpu())
    ref = np.asarray(ref, dtype=np.float32)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12))


def _jnp(a, dtype):
    import jax.numpy as jnp
    return jnp.asarray(a).astype(dtype)


def _np(a):
    return np.asarray(a.astype("float32"))


# ---------------------------------------------------------------------------
# the plain versions against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("gamma_dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [64, 96, 1000, 2560])
def test_rms_norm_plain_matches_reference(D, dtype, gamma_dtype):
    from repro.models import layers as jl
    x, g = _rand((3, 5, D), D), _rand((D,), D + 1)
    ref = jl.rms_norm(_jnp(x, dtype), _jnp(g, gamma_dtype))
    td, tg = getattr(torch, dtype), getattr(torch, gamma_dtype)
    xt, gt = torch.from_numpy(x).to(td), torch.from_numpy(g).to(tg)
    got = K.rms_norm_plain(xt, gt)
    assert got.dtype == td and got.shape == xt.shape
    assert _rel(got, _np(ref)) < (1e-6 if dtype == "float32" else BF16_TOL)
    assert torch.equal(layers.rms_norm(xt, gt), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_rope_plain_matches_reference(hd, batched, dtype):
    """Halves, not interleaved, at every served head_dim (halves 32, 48,
    60, 64), positions (S,) or (B, S) up to a ring of 4096."""
    from repro.models import layers as jl
    B, S, H, Kv = 2, 5, 4, 2
    q, k = _rand((B, S, H, hd), hd), _rand((B, S, Kv, hd), hd + 1)
    rng = np.random.default_rng(hd)
    pos = (rng.integers(0, 4096, (B, S)) if batched
           else np.arange(4090, 4090 + S)).astype(np.int32)
    td = getattr(torch, dtype)
    got_q, got_k = K.rope_qk_plain(torch.from_numpy(q).to(td),
                                   torch.from_numpy(k).to(td),
                                   torch.from_numpy(pos), THETA)
    for got, x in ((got_q, q), (got_k, k)):
        ref = _np(jl.apply_rope(_jnp(x, dtype), _jnp(pos, "int32"), THETA))
        assert got.dtype == td
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), ref, rtol=F32_TOL,
                                       atol=F32_TOL)
        else:
            assert _rel(got, ref) < BF16_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 1536), (3, 7, 40), (6, 8, 96),
                                   (13,)])
def test_silu_mul_plain_matches_reference(shape, dtype):
    import jax
    g, u = _rand(shape, 7, 3.0), _rand(shape, 8)
    ref = _np(jax.nn.silu(_jnp(g, dtype)) * _jnp(u, dtype))
    td = getattr(torch, dtype)
    got = K.silu_mul_plain(torch.from_numpy(g).to(td),
                           torch.from_numpy(u).to(td))
    assert got.dtype == td and got.shape == shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=F32_TOL,
                                   atol=F32_TOL)
    else:
        assert _rel(got, ref) < BF16_TOL


# ---------------------------------------------------------------------------
# the CPU path, the table, autograd
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("pos_shape", ["S", "BS", "B1"])
def test_rope_qk_is_two_apply_rope_calls(hd, pos_shape):
    """The layer function and the wrapper give the bits of two
    apply_rope calls, on a strided q (a slice of a wider tensor) too,
    with int32 and int64 positions, and launch nothing."""
    K.reset_launches()
    B, S, H, Kv = 2, 3, 4, 2
    wide = torch.from_numpy(_rand((B, S, H + Kv, hd), hd)).to(
        torch.bfloat16)
    q, k = wide[:, :, :H], wide[:, :, H:]
    if pos_shape == "B1":
        S, q, k = 1, q[:, :1], k[:, :1]
    pos = {"S": torch.arange(7, 7 + S), "BS": torch.tensor(
        [[5, 9, 4000], [0, 1, 2]], dtype=torch.int32)[:, :S],
        "B1": torch.tensor([[3], [4095]], dtype=torch.int32)}[pos_shape]
    want = (layers.apply_rope(q, pos, THETA), layers.apply_rope(k, pos,
                                                                THETA))
    for got in (layers.rope_qk(q, k, pos, THETA),
                K.rope_qk(q, k, pos, THETA)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not any(K.LAUNCHES.values())


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_cached_frequencies_are_a_fresh_table(hd, theta):
    table = K.cached_frequencies(hd, theta, torch.device("cpu"))
    assert torch.equal(table, layers.rope_frequencies(hd, theta))
    assert K.cached_frequencies(hd, theta, "cpu") is table


def test_a_new_table_inside_a_capture_raises(monkeypatch):
    """A table first asked for while the current stream captures a CUDA
    graph raises: the ops that would fill it would not run."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="capture"):
        K.cached_frequencies(64, 12345.0, torch.device("cuda", 0))


def test_cpu_layer_calls_launch_nothing():
    K.reset_launches()
    x = torch.from_numpy(_rand((4, 256), 1)).to(torch.bfloat16)
    gamma = torch.from_numpy(_rand((256,), 2))
    assert torch.equal(layers.rms_norm(x, gamma), K.rms_norm_plain(x, gamma))
    assert torch.equal(layers.silu_mul(x, x), K.silu_mul_plain(x, x))
    assert not any(K.LAUNCHES.values())


@pytest.mark.parametrize("which", ["rms_norm", "rope_qk", "silu_mul"])
def test_a_call_autograd_records_takes_the_plain_gradient(which):
    """With grad on and an input requiring grad the layer function goes
    through ``KernelWithPlainGrad``: its output is the wrapper's (the
    plain version's on the CPU), its gradient the plain version's bit for
    bit, also where only one input requires grad; the kernel's wrapper
    itself refuses such a call; on the meta device under a cost analysis
    such a call records its kernel once."""
    x0 = torch.from_numpy(_rand((2, 3, 4, 64), 3))
    k0 = torch.from_numpy(_rand((2, 3, 2, 64), 4))
    gamma = torch.from_numpy(_rand((64,), 5))
    pos = torch.arange(3)

    def layer(fn, x, k):
        if which == "rms_norm":
            return fn["norm"](x, k[0, 0, 0])
        if which == "rope_qk":
            q, kk = fn["rope"](x, k, pos.to(x.device), THETA)
            return q * 2 + kk.sum() * 3
        return fn["silu"](x, x * 2 + k.sum())

    lay = {"norm": layers.rms_norm, "rope": layers.rope_qk,
           "silu": layers.silu_mul}
    plain = {"norm": K.rms_norm_plain, "rope": K.rope_qk_plain,
             "silu": K.silu_mul_plain}
    for k_grad in (True, False):
        outs, grads = [], []
        for fn in (lay, plain):
            x = x0.clone().requires_grad_()
            k = k0.clone().requires_grad_(k_grad)
            out = layer(fn, x, k)
            assert out.grad_fn is not None
            (out * torch.from_numpy(_rand(out.shape, 6))).sum().backward()
            outs.append(out.detach())
            grads.append((x.grad, k.grad))
        assert torch.equal(outs[0], outs[1])
        assert torch.equal(grads[0][0], grads[1][0])
        if k_grad:
            assert torch.equal(grads[0][1], grads[1][1])
        else:
            assert grads[0][1] is None and grads[1][1] is None
    kern = {"norm": K.rms_norm, "rope": K.rope_qk, "silu": K.silu_mul}
    with pytest.raises(RuntimeError, match="no backward"):
        layer(kern, x0.clone().requires_grad_(), k0)
    with OpCounter() as c:
        layer(lay, x0.to("meta").requires_grad_(), k0.to("meta"))
    assert c.cost.kernels == {which: 1}


@pytest.mark.parametrize("remat", [False, True])
def test_a_train_step_records_each_fused_call(remat):
    """The gradient of a reduced llama's loss on the meta device under
    OpCounter: the forward records 2L + 1 rms_norm, L rope_qk and L
    silu_mul (a layer's twice under remat, which reruns it in the
    backward); the backward records none (it reruns the plain ops)."""
    from repro_torch.launch.serve import arch_config
    from repro_torch.models.api import build_model
    from repro_torch.training.losses import lm_loss
    from repro_torch.training.optimizer import tree_leaves, tree_unflatten
    cfg = arch_config("llama-3.1-8b").reduced()
    m = build_model(cfg, fmt="bfloat16", device="meta")
    params = m.abstract_params()
    toks = torch.zeros((2, 16), dtype=torch.int32, device="meta")
    with OpCounter() as c:
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        total, _ = lm_loss(m, tree_unflatten(params, leaves),
                           {"tokens": toks, "labels": toks}, remat=remat)
        torch.autograd.grad(total, leaves, allow_unused=True)
    L, r = cfg.num_layers, 2 if remat else 1
    assert {n: c.cost.kernels.get(n) for n in NAMES} == {
        "rms_norm": 2 * L * r + 1, "rope_qk": L * r, "silu_mul": L * r}


# ---------------------------------------------------------------------------
# the meta device and DTensors
# ---------------------------------------------------------------------------
def test_meta_records_are_the_cost_formulas():
    x = torch.empty((3, 5, 1024), dtype=torch.bfloat16, device="meta")
    gamma = torch.empty((1024,), dtype=torch.float16, device="meta")
    q = torch.empty((2, 7, 32, 128), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 7, 8, 128), dtype=torch.bfloat16, device="meta")
    pos = torch.empty((2, 7), dtype=torch.int32, device="meta")
    g = torch.empty((16, 8, 768), dtype=torch.float32, device="meta")
    want = [("rms_norm", cost.rms_norm(15, 1024, 2, 2)),
            ("rope_qk", cost.rope_qk(14, 32, 8, 128, 2, 4, 14)),
            ("silu_mul", cost.silu_mul(16 * 8 * 768, 4))]
    calls = [lambda: layers.rms_norm(x, gamma),
             lambda: layers.rope_qk(q, k, pos, THETA),
             lambda: layers.silu_mul(g, g)]
    for (name, (nbytes, flops)), call in zip(want, calls):
        with torch.no_grad(), OpCounter() as c:
            out = call()
        assert c.cost.kernels == {name: 1}
        assert (c.cost.dot_bytes, c.cost.dot_flops) == (nbytes, flops)
        for o in (out if isinstance(out, tuple) else (out,)):
            assert o.device.type == "meta"
    assert tuple(out.shape) == tuple(g.shape)


def test_meta_without_a_cost_analysis_has_no_kernel():
    x = torch.empty((4, 64), device="meta")
    with torch.no_grad(), pytest.raises(ValueError, match="no rms_norm"):
        layers.rms_norm(x, torch.empty((64,), device="meta"))


@pytest.mark.parametrize("bad", [
    dict(x_dtype=torch.float16), dict(gamma_dtype=torch.int32),
    dict(gamma_len=63)])
def test_rms_norm_checks(bad):
    x = torch.empty((4, 64), dtype=bad.get("x_dtype", torch.bfloat16),
                    device="meta")
    gamma = torch.empty((bad.get("gamma_len", 64),),
                        dtype=bad.get("gamma_dtype", torch.float32),
                        device="meta")
    with pytest.raises((TypeError, ValueError)):
        K.check_rms_norm(x, gamma)


@pytest.mark.parametrize("bad", [
    dict(hd=130 * 4 + 2), dict(hd=63), dict(k_dtype=torch.float32),
    dict(pos_dtype=torch.float32), dict(pos_shape=(3, 5)),
    dict(q_dtype=torch.float16, k_dtype=torch.float16)])
def test_rope_checks(bad):
    hd = bad.get("hd", 64)
    q = torch.empty((2, 5, 4, hd), dtype=bad.get("q_dtype", torch.bfloat16),
                    device="meta")
    k = torch.empty((2, 5, 2, hd), dtype=bad.get("k_dtype", q.dtype),
                    device="meta")
    pos = torch.empty(bad.get("pos_shape", (2, 5)),
                      dtype=bad.get("pos_dtype", torch.int32), device="meta")
    with pytest.raises((TypeError, ValueError)):
        K.check_rope(q, k, pos)


@pytest.mark.parametrize("bad", ["dtype", "shape", "mixed"])
def test_silu_mul_checks(bad):
    g = torch.empty((4, 64), dtype=torch.float16 if bad == "dtype"
                    else torch.bfloat16, device="meta")
    u = torch.empty((4, 65) if bad == "shape" else (4, 64),
                    dtype=torch.float32 if bad == "mixed" else g.dtype,
                    device="meta")
    with pytest.raises((TypeError, ValueError)):
        K.check_silu_mul(g, u)


def _kernel_calls(arch, fmt="bfloat16", prefill=False):
    from repro_torch.core.op_analysis import analyze_step
    from repro_torch.launch.serve import arch_config
    from repro_torch.models.api import build_model
    cfg = arch_config(arch).reduced()
    m = build_model(cfg, fmt=fmt, device="meta")
    params = m.abstract_params(quantize=fmt in ("int8", "nf4"))
    B = 2
    if prefill:
        batch = {"tokens": torch.empty((B, 16), dtype=torch.int32,
                                       device="meta")}
        step = lambda: m.prefill(params, batch, buf_len=32)  # noqa: E731
    else:
        cache = m.init_cache(B, 32)
        toks = torch.empty((B, 1), dtype=torch.int32, device="meta")
        step = lambda: m.decode_step(params, toks, cache)  # noqa: E731
    with torch.no_grad():
        _, c = analyze_step(step)
    return cfg, c.kernels


@pytest.mark.parametrize("prefill", [False, True])
@pytest.mark.parametrize("arch,fmt", [
    ("llama-3.1-8b", "bfloat16"), ("llama-3.1-8b", "int8"),
    ("qwen3-moe-30b-a3b", "bfloat16"), ("stablelm-1.6b", "float32")])
def test_a_step_records_each_fused_call(arch, fmt, prefill):
    """A decode step or prefill of a reduced dense or MoE model on the
    meta device under OpCounter: 2L + 1 rms_norm (two a layer and the
    final norm), L rope_qk and L silu_mul, whatever the format."""
    cfg, calls = _kernel_calls(arch, fmt, prefill)
    L = cfg.num_layers
    assert {n: calls.get(n) for n in NAMES} == {
        "rms_norm": 2 * L + 1, "rope_qk": L, "silu_mul": L}


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_ssm_and_hybrid_steps_record_their_norms(arch):
    """Mamba2: a layer's norm and its gate norm, and the final norm;
    zamba2 adds its shared block's two norms, RoPE and activation at each
    site; each Mamba layer's conv and state update."""
    from repro_torch.models.hybrid import n_attn_sites
    cfg, calls = _kernel_calls(arch)
    L = cfg.num_layers
    sites = n_attn_sites(cfg) if cfg.family == "hybrid" else 0
    assert {n: calls.get(n, 0) for n in NAMES + SSM_NAMES} == {
        "rms_norm": 2 * L + 1 + 2 * sites, "rope_qk": sites,
        "silu_mul": sites, "ssm_conv_step": L, "ssd_step": L}


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_dry_run_on_a_fake_mesh_records_them_shard_by_shard(kind):
    """The dry run's DTensors on a (2, 4) fake mesh: each fused call runs
    on every rank's shards and records once (rank 0's program)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.serve import arch_config
    cfg = arch_config("minitron-8b").reduced()
    shape = ShapeConfig(f"tiny_{kind}", 64, 4, kind)
    rec, c = dryrun.dry_run("minitron-8b", shape.name, False, "bfloat16",
                            cfg=cfg, shape=shape,
                            mesh=((2, 4), ("data", "model")))
    L = cfg.num_layers
    assert rec["ok"]
    assert {n: c.kernels.get(n) for n in NAMES} == {
        "rms_norm": 2 * L + 1, "rope_qk": L, "silu_mul": L}


# ---------------------------------------------------------------------------
# the host plans
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tokens,heads,want", [
    (4, 40, 2), (1, 40, 1), (8, 40, 3), (132, 40, 40), (7936, 40, 40),
    (4, 72, 3), (2, 33, 1)])
def test_rope_plan(tokens, heads, want):
    """One token a block; decode's few tokens split their heads into runs
    until tokens x runs come near a block a SM of 132."""
    assert K.rope_plan(tokens, heads, 132) == want


@pytest.mark.parametrize("n,vec,want", [
    (4 * 14336, 8, 28), (128 * 8 * 768, 8, 384), (7, 1, 1),
    (7936 * 14336, 8, 2112)])
def test_silu_mul_plan(n, vec, want):
    assert K.silu_mul_plan(n, vec, 132) == want


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _tol(dtype) -> float:
    return 1e-5 if dtype == torch.float32 else 1e-2


def _graph_nodes(fn):
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke.graph_nodes(torch, fn)


@pytest.mark.gpu
@pytest.mark.parametrize("gamma_dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("D", [1024, 2048, 2560, 3072, 3840, 4096, 5120,
                               8192, 1000, 36])
@pytest.mark.parametrize("rows", [1, 4, 464])
def test_cuda_rms_norm_matches_plain(rows, D, dtype, gamma_dtype):
    """Every served D (and two that take the element-wise loads) at decode
    and prefill rows, each gamma dtype: 1e-2 (bf16), 1e-5 (f32) relative,
    one launch a call."""
    _cuda()
    td = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(rows * D)
    x = (torch.randn((rows, D), generator=gen, device="cuda") * 3).to(td)
    gamma = torch.randn((D,), generator=gen, device="cuda").to(
        getattr(torch, gamma_dtype))
    before = K.LAUNCHES["rms_norm"]
    got = K.rms_norm(x, gamma)
    torch.cuda.synchronize()
    assert K.LAUNCHES["rms_norm"] == before + 1
    assert got.dtype == td
    assert _rel(got, K.rms_norm_plain(x, gamma).float().cpu()) < _tol(td)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("pos", ["S_i64", "BS_i32"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("B,S,H,Kv", [(4, 1, 32, 8), (2, 256, 32, 8),
                                      (1, 81, 32, 32), (8, 1, 64, 8)])
def test_cuda_rope_matches_plain(B, S, H, Kv, hd, pos, dtype):
    """Every served head_dim, decode and prefill, positions up to 4096,
    q a strided slice of a wider tensor: bit for bit the plain version
    (the same roundings), one launch a call."""
    _cuda()
    td = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(hd * S + H)
    wide = torch.randn((B, S, H + Kv, hd), generator=gen,
                       device="cuda").to(td)
    q, k = wide[:, :, :H], wide[:, :, H:].contiguous()
    positions = (torch.arange(4096 - S, 4096, device="cuda")
                 if pos == "S_i64" else
                 torch.randint(0, 4096, (B, S), generator=gen,
                               device="cuda", dtype=torch.int32))
    before = K.LAUNCHES["rope_qk"]
    got = K.rope_qk(q, k, positions, THETA)
    torch.cuda.synchronize()
    assert K.LAUNCHES["rope_qk"] == before + 1
    want = K.rope_qk_plain(q, k, positions, THETA)
    for a, b in zip(got, want):
        assert a.is_contiguous() and a.dtype == td
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(4, 14336), (464, 14336), (1, 1536),
                                   (128, 8, 768), (32, 160, 512),
                                   (3, 7, 5)])
def test_cuda_silu_mul_matches_plain(shape, dtype):
    """Dense and MoE expert shapes (rows past a count zero stay zero), a
    tail that is not a whole vector, and an unaligned view (element-wise
    loads): bit for bit the plain version, one launch a call."""
    _cuda()
    td = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    g = (torch.randn(shape, generator=gen, device="cuda") * 4).to(td)
    u = torch.randn(shape, generator=gen, device="cuda").to(td)
    if len(shape) == 3:
        g[:, shape[1] // 2:] = 0
        u[:, shape[1] // 2:] = 0
    flat_g = torch.cat([torch.zeros(1, dtype=td, device="cuda"),
                        g.flatten()])[1:]
    for gg in (g, flat_g.view(shape)):
        before = K.LAUNCHES["silu_mul"]
        got = K.silu_mul(gg, u)
        torch.cuda.synchronize()
        assert K.LAUNCHES["silu_mul"] == before + 1
        assert torch.equal(got, K.silu_mul_plain(gg, u))
        if len(shape) == 3:
            assert not got[:, shape[1] // 2:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["rms_norm", "rope_qk", "silu_mul"])
def test_cuda_a_call_autograd_records_launches_the_kernel(which):
    """A layer call that autograd records launches its kernel once, gives
    the kernel's output, and takes the plain version's gradient."""
    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(2)
    bf16 = torch.bfloat16
    x0 = torch.randn((2, 16, 8, 128), generator=gen, device="cuda").to(bf16)
    k0 = torch.randn((2, 16, 2, 128), generator=gen, device="cuda").to(bf16)
    gamma0 = torch.randn((128,), generator=gen, device="cuda")
    pos = torch.arange(100, 116, device="cuda")
    calls = {
        "rms_norm": (layers.rms_norm, K.rms_norm, K.rms_norm_plain,
                     lambda x, k, g: (x, g)),
        "rope_qk": (layers.rope_qk, K.rope_qk, K.rope_qk_plain,
                    lambda x, k, g: (x, k, pos, THETA)),
        "silu_mul": (layers.silu_mul, K.silu_mul, K.silu_mul_plain,
                     lambda x, k, g: (x, x * 2))}
    layer, kern, plain, args = calls[which]
    got = []
    for fn in (layer, plain):
        x, k = x0.clone().requires_grad_(), k0.clone().requires_grad_()
        g = gamma0.clone().requires_grad_()
        before = K.LAUNCHES[which]
        out = fn(*args(x, k, g))
        launched = K.LAUNCHES[which] - before
        outs = out if isinstance(out, tuple) else (out,)
        sum((o.float() * (i + 1)).sum() for i, o in enumerate(outs)
            ).backward()
        got.append((launched, [o.detach() for o in outs],
                    [t.grad for t in (x, k, g)]))
    with torch.no_grad():
        want = kern(*args(x0, k0, gamma0))
    want = want if isinstance(want, tuple) else (want,)
    assert got[0][0] == 1 and got[1][0] == 0
    assert all(torch.equal(a, b) for a, b in zip(got[0][1], want))
    for a, b in zip(got[0][2], got[1][2]):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_each_call_is_one_kernel_node():
    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    x = torch.randn((4, 4096), generator=gen, device="cuda").to(bf16)
    gamma = torch.randn((4096,), generator=gen, device="cuda").to(bf16)
    q = torch.randn((4, 1, 32, 128), generator=gen, device="cuda").to(bf16)
    k = torch.randn((4, 1, 8, 128), generator=gen, device="cuda").to(bf16)
    pos = torch.tensor([[5], [70], [300], [511]], dtype=torch.int32,
                       device="cuda")
    g = torch.randn((4, 14336), generator=gen, device="cuda").to(bf16)
    for fn in (lambda: K.rms_norm(x, gamma),
               lambda: K.rope_qk(q, k, pos, THETA),
               lambda: K.silu_mul(g, g)):
        assert _graph_nodes(fn) == [0]


@pytest.mark.gpu
def test_cuda_graph_replay_is_the_eager_calls_bit_for_bit():
    """A captured run of the three kernels (the frequency table filled by
    an eager call first) replays to the eager calls' bits, inputs changed
    in place between replays, with the launch counts of a replay added
    through cuda_build.counted."""
    _cuda()
    from repro_torch.kernels import cuda_build
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16 = torch.bfloat16
    x = torch.randn((4, 1, 3840), generator=gen, device="cuda").to(bf16)
    gamma = torch.randn((3840,), generator=gen, device="cuda").to(bf16)
    q = torch.randn((4, 1, 32, 120), generator=gen, device="cuda").to(bf16)
    k = torch.randn((4, 1, 8, 120), generator=gen, device="cuda").to(bf16)
    pos = torch.tensor([[5], [70], [300], [4095]], dtype=torch.int32,
                       device="cuda")

    def step():
        h = K.rms_norm(x, gamma)
        qr, kr = K.rope_qk(q, k, pos, THETA)
        return K.silu_mul(h, h), qr, kr

    step()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs, added = cuda_build.counted(step)
    for i in range(3):
        x.mul_(1.5)
        pos.add_(7)
        want = step()
        K.reset_launches()
        graph.replay()
        cuda_build.add_counted(added)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(outs, want)), i
        assert K.LAUNCHES == {"rms_norm": 1, "rope_qk": 1, "silu_mul": 1,
                              "ssm_conv_step": 0, "ssd_step": 0}
