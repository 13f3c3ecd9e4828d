"""The Mamba2 decode step's two kernels (``repro_torch.kernels.fused``:
``ssm_conv_step``, the one-token causal conv, and ``ssd_step``, the state
update with its gated output). Their plain versions against the
reference's ``conv_step``, ``ssd_decode_step`` and the dt, A and gate
lines of ``mamba_block_decode`` (``repro.models.ssm``), at the reduced
mamba2 and zamba2 shapes and with two groups, f32 within 1e-5 and bf16
within 2e-2 of the max |value|; ``mamba_block_decode`` and a stacked
``decode_step`` against the reference, the conv cache and the state
updated in place in their layer only; the meta cost records against the
bytes counted by hand; the dry run's DTensors on a fake mesh; the checks.
The tests marked ``gpu`` hold each CUDA kernel against its plain version
on the card at the served widths (mamba2-2.7b, zamba2-1.2b), a row of a
batch bit for bit the row alone, one kernel node a call; they import no
JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_ssm_step.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.op_analysis import OpCounter  # noqa: E402
from repro_torch.core.precision import make_policy  # noqa: E402
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.kernels.fused import kernel as K  # noqa: E402
from repro_torch.models import ssm as pssm  # noqa: E402

F32_TOL = 1e-5
BF16_TOL = 2e-2
ARCHS = ("mamba2-2.7b", "zamba2-1.2b")
BATCHES = (1, 3, 4)
#: (nh, hd, ng, ds) beside the reduced configs': two groups of heads
TWO_GROUPS = (8, 16, 2, 8)


def _tol(dtype: str) -> float:
    return F32_TOL if dtype == "float32" else BF16_TOL


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


def _dims(arch):
    """(nh, hd, ng, ds, K) of a reduced config, or TWO_GROUPS."""
    if arch == "two_groups":
        return (*TWO_GROUPS, 4)
    cfg = get_config(arch).reduced()
    d = pssm.ssm_dims(cfg)
    return (d["nheads"], d["headdim"], d["ngroups"], d["dstate"],
            cfg.ssm_conv_width)


def _proj(B, nh, hd, ng, ds, seed):
    """The input projection (B, d_in_proj) = [z | x | B | C | dt] and its
    (z, xBC, dt) views, as the block splits it."""
    di, gs = nh * hd, ng * ds
    zx = _rand((B, 2 * di + 2 * gs + nh), seed)
    return zx, (slice(0, di), slice(di, 2 * di + 2 * gs),
                slice(2 * di + 2 * gs, None))


# ---------------------------------------------------------------------------
# the plain versions against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("arch", ARCHS + ("two_groups",))
def test_conv_step_plain_matches_reference(arch, B, dtype):
    """x a view of the projection (its row stride d_in_proj); the cache
    shifted in place to the reference's new cache, bit for bit."""
    from repro.models import ssm as jssm
    nh, hd, ng, ds, Kw = _dims(arch)
    zx, (_, xs, _) = _proj(B, nh, hd, ng, ds, B)
    C = xs.stop - xs.start
    cache = _rand((B, Kw - 1, C), B + 1)
    w, b = _rand((Kw, C), 2, 0.3), _rand((C,), 3, 0.1)
    ref_y, ref_cache = jssm.conv_step(
        _jnp(zx, dtype)[:, xs], _jnp(cache, dtype), _jnp(w, dtype),
        _jnp(b, dtype))
    td = getattr(torch, dtype)
    tx = torch.from_numpy(zx).to(td)[:, xs]
    assert tx.stride(0) == zx.shape[1]
    tc, tw, tb = (torch.from_numpy(a).to(td) for a in (cache, w, b))
    got = K.ssm_conv_step(tx, tc, tw, tb)
    assert got.dtype == td and got.shape == (B, C)
    assert _rel(got, _np(ref_y)) < _tol(dtype)
    np.testing.assert_array_equal(tc.float().numpy(), _np(ref_cache))
    assert not any(K.LAUNCHES.values())


def _ssd_reference(zx, slices, nh, hd, ng, ds, params, h, dtype):
    """The reference's lines 249-255 of mamba_block_decode: dt and A, its
    ssd_decode_step, the gate. Returns (gated output (B, nh, hd), h)."""
    import jax
    import jax.numpy as jnp
    from repro.models import ssm as jssm
    B, di, gs = zx.shape[0], nh * hd, ng * ds
    z, xBC, dt = (_jnp(zx, dtype)[:, s] for s in slices)
    dt_bias, A_log, D = (_jnp(p, dtype) for p in params)
    x = xBC[:, :di].reshape(B, nh, hd)
    Bm = xBC[:, di:di + gs].reshape(B, ng, ds)
    Cm = xBC[:, di + gs:].reshape(B, ng, ds)
    dt = jax.nn.softplus(dt.astype(jnp.float32)
                         + dt_bias.astype(jnp.float32))
    A = -jnp.exp(A_log.astype(jnp.float32))
    y, h_new = jssm.ssd_decode_step(x, dt, A, Bm, Cm,
                                    D.astype(jnp.float32), jnp.asarray(h))
    y = y.reshape(B, di)
    g = y * jax.nn.silu(z.astype(jnp.float32)).astype(y.dtype)
    return _np(g).reshape(B, nh, hd), np.asarray(h_new)


def _ssd_inputs(B, nh, hd, ng, ds, seed, dtype):
    """The projection (its xBC part standing for the conv output), the
    parameters as the reference draws them, and a random state; torch's
    views (x, B, C, z, dt), parameters and state."""
    zx, slices = _proj(B, nh, hd, ng, ds, seed)
    params = (np.log(np.expm1(np.linspace(1e-3, 1e-1, nh))),
              np.log(np.linspace(1.0, 16.0, nh)), np.linspace(0.5, 1.5, nh))
    params = tuple(np.asarray(p, np.float32) for p in params)
    h = _rand((B, nh, hd, ds), seed + 1)
    td = getattr(torch, dtype)
    t = torch.from_numpy(zx).to(td)
    z, xBC, dt = (t[:, s] for s in slices)
    di, gs = nh * hd, ng * ds
    views = (xBC[:, :di].reshape(B, nh, hd),
             xBC[:, di:di + gs].reshape(B, ng, ds),
             xBC[:, di + gs:].reshape(B, ng, ds), z.reshape(B, nh, hd), dt)
    tparams = tuple(torch.from_numpy(p).to(td) for p in params)
    return (zx, slices, params, h), (views, tparams, torch.from_numpy(
        h.copy()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("arch", ARCHS + ("two_groups",))
def test_ssd_step_plain_matches_reference(arch, B, dtype):
    """x, B, C, z and dt views of the projection (no copy); the state
    updated in place to the reference's new state; the gated output the
    reference's ``y * silu(z)``."""
    nh, hd, ng, ds, _ = _dims(arch)
    (zx, slices, params, h), (views, tparams, th) = _ssd_inputs(
        B, nh, hd, ng, ds, 10 * B, dtype)
    ref_g, ref_h = _ssd_reference(zx, slices, nh, hd, ng, ds, params, h,
                                  dtype)
    got = K.ssd_step(*views, *tparams, th)
    assert got.shape == (B, nh, hd) and got.dtype == views[0].dtype
    assert _rel(got, ref_g) < _tol(dtype)
    assert _rel(th, ref_h) < F32_TOL
    assert not any(K.LAUNCHES.values())


# ---------------------------------------------------------------------------
# the block and the stack against the reference
# ---------------------------------------------------------------------------
def _layers(arch, dtype, n, seed=0):
    """n reference layers of the reduced config (non-trivial norms, conv
    bias and skip) and the port's copies."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.models import ssm as jssm
    from _torch_parity import to_torch
    jcfg = jax_get_config(arch).reduced()
    out = []
    for i in range(n):
        jp = jssm.init_mamba_layer(jax.random.PRNGKey(seed + i), jcfg,
                                   jnp.float32)
        for j, k in enumerate(("norm", "gate_norm", "conv_b", "D")):
            jp[k] = jp[k] + jnp.asarray(_rand(jp[k].shape, 20 + j, 0.1))
        jp = {k: v.astype(dtype) for k, v in jp.items()}
        out.append((jp, {k: to_torch(v) for k, v in jp.items()}))
    return jcfg, out


def _state(cfg, L, B, seed):
    d = pssm.ssm_dims(cfg)
    return (_rand((L, B, d["nheads"], d["headdim"], d["dstate"]), seed, 0.1),
            _rand((L, B, cfg.ssm_conv_width - 1, d["conv_channels"]),
                  seed + 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_mamba_block_decode_matches_reference(arch, B, dtype):
    """The block through both kernels' plain versions: its output, and the
    state and conv cache it updates in place and returns (the cache holds
    the input projection, whose products round as each framework's)."""
    import jax.numpy as jnp
    from repro.core.precision import make_policy as jax_policy
    from repro.models import ssm as jssm
    cfg = get_config(arch).reduced()
    jcfg, [(jp, tp)] = _layers(arch, dtype, 1, seed=B)
    h, conv = _state(cfg, 1, B, 40 + B)
    x = _rand((B, cfg.d_model), 30 + B)
    ref = jssm.mamba_block_decode(jp, _jnp(x, dtype), jcfg,
                                  jax_policy(dtype), jnp.asarray(h[0]),
                                  _jnp(conv[0], dtype))
    th = torch.from_numpy(h[0].copy())
    tc = torch.from_numpy(conv[0]).to(getattr(torch, dtype))
    got = pssm.mamba_block_decode(tp, torch.from_numpy(x).to(tc.dtype), cfg,
                                  make_policy(dtype), th, tc)
    assert got[1] is th and got[2] is tc
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        assert _rel(a, _np(b)) < _tol(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_updates_each_layer_in_place(arch, dtype):
    """Three layers through ``ssm.decode_step`` against the reference's
    blocks one after another: the hidden state, each layer's state and
    conv cache, ``pos`` advanced; a fourth layer of the stacked cache, which
    no layer runs, keeps its bits."""
    import jax.numpy as jnp
    from repro.core.precision import make_policy as jax_policy
    from repro.models import ssm as jssm
    cfg = get_config(arch).reduced()
    jcfg, layers = _layers(arch, dtype, 3, seed=7)
    B = 3
    h, conv = _state(cfg, 4, B, 50)
    x = _rand((B, cfg.d_model), 51)
    jx, jh, jc = _jnp(x, dtype), [], []
    for i, (jp, _) in enumerate(layers):
        jx, hi, ci = jssm.mamba_block_decode(
            jp, jx, jcfg, jax_policy(dtype), jnp.asarray(h[i]),
            _jnp(conv[i], dtype))
        jh.append(_np(hi))
        jc.append(_np(ci))
    td = getattr(torch, dtype)
    cache = {"ssm_state": torch.from_numpy(h.copy()),
             "conv": torch.from_numpy(conv).to(td),
             "pos": torch.tensor([5, 9, 0], dtype=torch.int32)}
    untouched = {k: v[3].clone() for k, v in cache.items() if k != "pos"}
    got = pssm.decode_step([tp for _, tp in layers],
                           torch.from_numpy(x).to(td), cache, cfg,
                           make_policy(dtype))
    assert _rel(got, _np(jx)) < _tol(dtype)
    for i in range(3):
        assert _rel(cache["ssm_state"][i], jh[i]) < _tol(dtype)
        assert _rel(cache["conv"][i], jc[i]) < _tol(dtype)
    for k, v in untouched.items():
        assert torch.equal(cache[k][3], v)
    assert cache["pos"].tolist() == [6, 10, 1]


# ---------------------------------------------------------------------------
# the meta device, the dry run's DTensors, the checks
# ---------------------------------------------------------------------------
def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("arch,want", [
    # mamba2-2.7b at batch 4, bf16: C = 5376, K = 4; x and y 2 x 4 x C
    # elements, the cache read and written 2 x 4 x 3 x C, the taps and
    # bias 5 x C, two bytes each; (2 K + 5) f32 operations an element
    ("mamba2-2.7b", ((2 * 4 * 5376 + 2 * 4 * 3 * 5376 + 5 * 5376) * 2,
                     13 * 4 * 5376)),
    # zamba2-1.2b: C = 4224
    ("zamba2-1.2b", ((2 * 4 * 4224 + 2 * 4 * 3 * 4224 + 5 * 4224) * 2,
                     13 * 4 * 4224))])
def test_meta_conv_record_is_the_bytes_counted_by_hand(arch, want):
    d = pssm.ssm_dims(get_config(arch))
    C = d["conv_channels"]
    with torch.no_grad(), OpCounter() as c:
        y = K.ssm_conv_step(_meta((4, C)), _meta((4, 3, C)), _meta((4, C)),
                            _meta((C,)))
    assert y.device.type == "meta" and tuple(y.shape) == (4, C)
    assert c.cost.kernels == {"ssm_conv_step": 1}
    assert (c.cost.dot_bytes, c.cost.dot_flops) == want
    assert cost.ssm_conv_step(4, C, 4, 2, 2) == want


@pytest.mark.parametrize("arch,want_bytes", [
    # mamba2-2.7b at batch 4: the f32 state 4 x 80 x 64 x 128 read and
    # written; x, z, g 3 x 4 x 80 x 64, B and C 2 x 4 x 128, dt 4 x 80 in
    # bf16; dt_bias, A_log, D 3 x 80 in bf16
    ("mamba2-2.7b", 8 * 4 * 80 * 64 * 128
     + 2 * (3 * 4 * 80 * 64 + 2 * 4 * 128 + 4 * 80) + 2 * 3 * 80),
    # zamba2-1.2b: 64 heads of 64, a state of 64
    ("zamba2-1.2b", 8 * 4 * 64 * 64 * 64
     + 2 * (3 * 4 * 64 * 64 + 2 * 4 * 64 + 4 * 64) + 2 * 3 * 64)])
def test_meta_ssd_record_is_the_bytes_counted_by_hand(arch, want_bytes):
    d = pssm.ssm_dims(get_config(arch))
    nh, hd, ng, ds = d["nheads"], d["headdim"], d["ngroups"], d["dstate"]
    with torch.no_grad(), OpCounter() as c:
        g = K.ssd_step(_meta((4, nh, hd)), _meta((4, ng, ds)),
                       _meta((4, ng, ds)), _meta((4, nh, hd)),
                       _meta((4, nh)), _meta((nh,)), _meta((nh,)),
                       _meta((nh,)), _meta((4, nh, hd, ds), torch.float32))
    assert g.device.type == "meta" and tuple(g.shape) == (4, nh, hd)
    assert c.cost.kernels == {"ssd_step": 1}
    flops = 5 * 4 * nh * hd * ds + 8 * 4 * nh * hd + 9 * 4 * nh
    assert (c.cost.dot_bytes, c.cost.dot_flops) == (want_bytes, flops)


def test_meta_without_a_cost_analysis_has_no_kernel():
    with torch.no_grad(), pytest.raises(ValueError, match="no ssm_conv"):
        K.ssm_conv_step(_meta((4, 64)), _meta((4, 3, 64)), _meta((4, 64)),
                        _meta((64,)))


@pytest.mark.parametrize("arch", ARCHS)
def test_a_decode_step_records_each_layer_once(arch):
    """A reduced model's decode step on the meta device: one record of
    each kernel a Mamba layer; its prefill none."""
    from repro_torch.core.op_analysis import analyze_step
    from repro_torch.models.api import build_model
    cfg = get_config(arch).reduced()
    m = build_model(cfg, fmt="bfloat16", device="meta")
    params = m.abstract_params(quantize=False)
    cache = m.init_cache(2, 32)
    toks = torch.empty((2, 1), dtype=torch.int32, device="meta")
    batch = {"tokens": torch.empty((2, 16), dtype=torch.int32,
                                   device="meta")}
    with torch.no_grad():
        _, step = analyze_step(lambda: m.decode_step(params, toks, cache))
        _, pre = analyze_step(lambda: m.prefill(params, batch, buf_len=32))
    L = cfg.num_layers
    assert {n: step.kernels.get(n) for n in ("ssm_conv_step", "ssd_step")} \
        == {"ssm_conv_step": L, "ssd_step": L}
    assert not {"ssm_conv_step", "ssd_step"} & set(pre.kernels)


@pytest.mark.parametrize("mesh", [((2, 4), ("data", "model")),
                                  ((1, 8), ("data", "model")),
                                  ((8, 1), ("data", "model"))])
@pytest.mark.parametrize("arch", ARCHS)
def test_dry_run_on_a_fake_mesh_runs_them_shard_by_shard(arch, mesh):
    """The dry run's DTensors: each kernel runs on every rank's shards
    (heads or channels split on ``model``, rows on ``data``) and records
    once a layer (rank 0's program); the record comes out ok."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    cfg = get_config(arch).reduced()
    shape = ShapeConfig("tiny_decode", 64, 8, "decode")
    rec, c = dryrun.dry_run(arch, shape.name, False, "bfloat16", cfg=cfg,
                            shape=shape, mesh=mesh)
    L = cfg.num_layers
    assert rec["ok"]
    assert {n: c.kernels.get(n) for n in ("ssm_conv_step", "ssd_step")} \
        == {"ssm_conv_step": L, "ssd_step": L}


@pytest.mark.parametrize("bad", [
    dict(x_dtype=torch.float16), dict(w_dtype=torch.int32),
    dict(cache_len=2), dict(b_len=63), dict(K=1), dict(x_stride=2)])
def test_conv_step_checks(bad):
    Kw = bad.get("K", 4)
    xd = bad.get("x_dtype", torch.bfloat16)
    wide = _meta((4, 128), xd)
    x = wide[:, ::2] if "x_stride" in bad else wide[:, :64]
    cache = _meta((4, bad.get("cache_len", Kw - 1), 64), xd)
    w = _meta((Kw, 64), bad.get("w_dtype", torch.bfloat16))
    b = _meta((bad.get("b_len", 64),), w.dtype)
    with pytest.raises((TypeError, ValueError)):
        K.check_ssm_conv_step(x, cache, w, b)


@pytest.mark.parametrize("bad", [
    "x_dtype", "groups", "state", "mixed", "h_dtype", "param_dtype",
    "param_len", "z_stride"])
def test_ssd_step_checks(bad):
    b, nh, hd = 2, 8, 16
    ng = 3 if bad == "groups" else 2
    ds = 6 if bad == "state" else 8
    ad = torch.float16 if bad == "x_dtype" else torch.bfloat16
    x = _meta((b, nh, hd), ad)
    z = _meta((b, nh, 2 * hd), ad)[..., ::2] if bad == "z_stride" \
        else _meta((b, nh, hd), ad)
    Bm = _meta((b, ng, ds), torch.float32 if bad == "mixed" else ad)
    pd = torch.int32 if bad == "param_dtype" else torch.float32
    p = _meta((nh - (bad == "param_len"),), pd)
    h = _meta((b, nh, hd, ds),
              torch.bfloat16 if bad == "h_dtype" else torch.float32)
    with pytest.raises((TypeError, ValueError)):
        K.check_ssd_step(x, Bm, Bm, z, _meta((b, nh), ad), p, p, p, h)


def test_the_checks_take_the_block_s_views():
    """The views the block passes (x, B, C of the conv output; z, dt of
    the projection) and the layer's state pass both checks."""
    (_, _, _, _), (views, params, h) = _ssd_inputs(3, *TWO_GROUPS, 0,
                                                    "bfloat16")
    K.check_ssd_step(*views, *params, h)
    zx = torch.zeros((3, 300), dtype=torch.bfloat16)
    K.check_ssm_conv_step(zx[:, 10:138], torch.zeros((3, 3, 128),
                                                     dtype=zx.dtype),
                          torch.zeros((4, 128)), torch.zeros(128))


def test_the_kernels_refuse_grad():
    x = torch.zeros((2, 8), requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        K.ssm_conv_step(x, torch.zeros((2, 3, 8)), torch.zeros((4, 8)),
                        torch.zeros(8))
    with pytest.raises(RuntimeError, match="no backward"):
        K.ssd_step(torch.zeros((1, 2, 4), requires_grad=True),
                   torch.zeros((1, 1, 4)), torch.zeros((1, 1, 4)),
                   torch.zeros((1, 2, 4)), torch.zeros((1, 2)),
                   torch.zeros(2), torch.zeros(2), torch.zeros(2),
                   torch.zeros((1, 2, 4, 4)))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
#: (C, nh, hd, ng, ds) of the served SSM and hybrid configs, and two groups
SERVED = {"mamba2-2.7b": (5376, 80, 64, 1, 128),
          "zamba2-1.2b": (4224, 64, 64, 1, 64),
          "two_groups": (8 * 32 + 2 * 4 * 64, 8, 32, 4, 64)}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _card_inputs(arch, B, dtype, pdtype, seed):
    """A projection on the card and its views, as the block makes them:
    (x_conv, cache, w, b) for the conv; (x, B, C, z, dt, dt_bias, A_log,
    D, h) for ssd_step, xBC standing for the conv output."""
    C, nh, hd, ng, ds = SERVED[arch]
    di, gs = nh * hd, ng * ds
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(shape, dt=dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dt)

    zx = randn((B, di + C + nh))
    z, xBC, dt = zx[:, :di], zx[:, di:di + C], zx[:, di + C:]
    conv = (xBC, randn((B, 3, C)), randn((4, C), pdtype, 0.3),
            randn((C,), pdtype, 0.1))
    nhs = torch.linspace(0, 1, nh, device="cuda")
    ssd = (xBC[:, :di].reshape(B, nh, hd),
           xBC[:, di:di + gs].reshape(B, ng, ds),
           xBC[:, di + gs:].reshape(B, ng, ds), z.reshape(B, nh, hd), dt,
           (nhs - 3).to(pdtype), torch.log1p(15 * nhs).to(pdtype),
           (0.5 + nhs).to(pdtype), randn((B, nh, hd, ds), torch.float32))
    return conv, ssd


def _rel_cuda(got, ref) -> float:
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


@pytest.mark.gpu
@pytest.mark.parametrize("pdtype", ["bfloat16", "float32", "float16"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("B", [1, 2, 3, 4])
@pytest.mark.parametrize("arch", list(SERVED))
def test_cuda_kernels_match_plain(arch, B, dtype, pdtype):
    """Both kernels against their plain versions on clones of the same
    state: the conv's output and cache bit for bit, ssd_step's output and
    state within 1e-5 (f32) / 2e-2 (bf16) (its sum over ds in another
    order), one launch a call."""
    _cuda()
    conv, ssd = _card_inputs(arch, B, getattr(torch, dtype),
                             getattr(torch, pdtype), B)
    for name, kern, plain, args, state in (
            ("ssm_conv_step", K.ssm_conv_step, K.ssm_conv_step_plain, conv,
             1), ("ssd_step", K.ssd_step, K.ssd_step_plain, ssd, 8)):
        mine, theirs = list(args), list(args)
        mine[state], theirs[state] = args[state].clone(), args[state].clone()
        before = K.LAUNCHES[name]
        got = kern(*mine)
        torch.cuda.synchronize()
        assert K.LAUNCHES[name] == before + 1
        want = plain(*theirs)
        tol = 0.0 if name == "ssm_conv_step" else _tol(dtype)
        assert _rel_cuda(got, want) <= tol, name
        assert _rel_cuda(mine[state], theirs[state]) <= (
            0.0 if name == "ssm_conv_step" else F32_TOL), name


@pytest.mark.gpu
@pytest.mark.parametrize("arch", list(SERVED))
def test_cuda_a_row_of_a_batch_is_the_row_alone(arch):
    """ssd_step's grid depends on the batch; a row's bits do not."""
    _cuda()
    _, ssd = _card_inputs(arch, 4, torch.bfloat16, torch.bfloat16, 9)
    h = ssd[8].clone()
    batched = K.ssd_step(*ssd[:8], h)
    for r in range(4):
        hr = ssd[8][r:r + 1].clone()
        alone = K.ssd_step(*(t[r:r + 1] for t in ssd[:5]), *ssd[5:8], hr)
        assert torch.equal(alone, batched[r:r + 1])
        assert torch.equal(hr, h[r:r + 1])


@pytest.mark.gpu
def test_cuda_each_call_is_one_kernel_node():
    _cuda()
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    conv, ssd = _card_inputs("mamba2-2.7b", 4, torch.bfloat16,
                             torch.bfloat16, 1)
    for fn in (lambda: K.ssm_conv_step(*conv), lambda: K.ssd_step(*ssd)):
        assert chip_smoke.graph_nodes(torch, fn) == [0]
