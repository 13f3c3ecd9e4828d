"""The port's Mamba2 (repro_torch.models.ssm), hybrid
(repro_torch.models.hybrid) and cross-attention modules against the JAX
package's, function by function: float32, numpy inputs from a seed,
weights drawn by the reference and carried across, each output within
2e-5 of its max |value| (the chunked SSD scan reads up to 5.2e-6 at
these inputs: f32 sums in other orders)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.precision import make_policy as jax_policy  # noqa: E402
from repro.models import hybrid as jhyb  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jt  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.precision import make_policy  # noqa: E402
from repro_torch.models import hybrid as phyb  # noqa: E402
from repro_torch.models import ssm as pssm  # noqa: E402
from repro_torch.models import transformer as pt  # noqa: E402
from repro_torch.models.layers import encoder_kv_pages  # noqa: E402

from _torch_parity import carry_params, rel_err, to_torch  # noqa: E402

TOL = 2e-5
JPOL, TPOL = jax_policy("float32"), make_policy("float32")
SSM_CFG = get_config("mamba2-2.7b").reduced()
JSSM_CFG = jax_get_config("mamba2-2.7b").reduced()


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _both(*arrays):
    """Each numpy array as (jax array, CPU tensor)."""
    return [(jnp.asarray(a), torch.from_numpy(a.copy())) for a in arrays]


def _tree(jtree):
    """A JAX params dict (no stacked layers) as the port's tensors."""
    if isinstance(jtree, dict):
        return {k: _tree(v) for k, v in jtree.items()}
    return to_torch(jtree)


def _close(got, ref, tol=TOL):
    err = rel_err(got, ref)
    assert err < tol, err


# ---------------------------------------------------------------------------
# conv
# ---------------------------------------------------------------------------
def test_causal_conv():
    (jx, tx), (jw, tw), (jb, tb) = _both(_rand((2, 10, 24), 0),
                                         _rand((4, 24), 1, 0.3),
                                         _rand((24,), 2, 0.1))
    _close(pssm.causal_conv(tx, tw, tb), jssm.causal_conv(jx, jw, jb))


def test_conv_step():
    (jx, tx), (jc, tc), (jw, tw), (jb, tb) = _both(
        _rand((2, 24), 3), _rand((2, 3, 24), 4), _rand((4, 24), 5, 0.3),
        _rand((24,), 6, 0.1))
    j_out, j_cache = jssm.conv_step(jx, jc, jw, jb)
    t_out, t_cache = pssm.conv_step(tx, tc, tw, tb)
    _close(t_out, j_out)
    np.testing.assert_array_equal(t_cache.numpy(), np.asarray(j_cache))


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------
def _ssd_inputs(S, seed, dt_shift=0.0, nh=16, hd=32, ng=2, ds=16, b=2):
    """Unit-normal x, B and C, dt = softplus(N(dt_shift, 1)), the
    reference's A and D, a random incoming state."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, nh, hd)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, S, nh)) + dt_shift, 0) \
        .astype(np.float32)
    A = -np.exp(np.log(np.linspace(1.0, 16.0, nh))).astype(np.float32)
    B = rng.standard_normal((b, S, ng, ds)).astype(np.float32)
    C = rng.standard_normal((b, S, ng, ds)).astype(np.float32)
    D = np.linspace(0.5, 1.5, nh).astype(np.float32)
    h0 = rng.standard_normal((b, nh, hd, ds)).astype(np.float32)
    return x, dt, A, B, C, D, h0


_JIT_SSD = jax.jit(jssm.ssd_chunked, static_argnames="chunk")


@pytest.mark.parametrize("S", [128, 40])
def test_ssd_chunked(S):
    """S = 128: two chunks of 64 and the recurrence between them; S = 40:
    the one-chunk fallback (64 does not divide S)."""
    arrays = _ssd_inputs(S, S)
    j_y, j_h = _JIT_SSD(*(jnp.asarray(a) for a in arrays))
    t_y, t_h = pssm.ssd_chunked(*(torch.from_numpy(a) for a in arrays))
    assert t_y.shape == (2, S, 16, 32) and t_h.dtype == torch.float32
    _close(t_y, j_y)
    _close(t_h, j_h)


def test_ssd_chunked_long_single_chunk_stays_finite():
    """S = 232 (a serve prefill padded to a multiple of 8, one chunk) with
    large dt: exp(l_i - l_j) above the diagonal overflows to inf, and the
    select must drop it (a 0/1 mask multiplied in would make NaN)."""
    arrays = _ssd_inputs(232, 7, dt_shift=3.0)
    x, dt, A = arrays[:3]
    l = np.cumsum(dt * A, axis=1)
    assert (l[:, 0] - l[:, -1]).max() > 89.0     # exp overflows in f32
    j_y, j_h = _JIT_SSD(*(jnp.asarray(a) for a in arrays))
    t_y, t_h = pssm.ssd_chunked(*(torch.from_numpy(a) for a in arrays))
    assert torch.isfinite(t_y).all() and torch.isfinite(t_h).all()
    _close(t_y, j_y)
    _close(t_h, j_h)


def test_ssd_decode_step():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((2, 16)), 0).astype(np.float32)
    A = -np.linspace(1.0, 16.0, 16).astype(np.float32)
    B, C = (rng.standard_normal((2, 2, 16)).astype(np.float32)
            for _ in range(2))
    D = np.linspace(0.5, 1.5, 16).astype(np.float32)
    h = rng.standard_normal((2, 16, 32, 16)).astype(np.float32)
    arrays = (x, dt, A, B, C, D, h)
    j_y, j_h = jssm.ssd_decode_step(*(jnp.asarray(a) for a in arrays))
    t_y, t_h = pssm.ssd_decode_step(*(torch.from_numpy(a) for a in arrays))
    _close(t_y, j_y)
    _close(t_h, j_h)


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------
def _mamba_layer(seed=0):
    jp = jssm.init_mamba_layer(jax.random.PRNGKey(seed), JSSM_CFG,
                               jnp.float32)
    # non-trivial norms, conv bias and skip, so that each one counts
    for i, k in enumerate(("norm", "gate_norm", "conv_b", "D")):
        jp[k] = jp[k] + jnp.asarray(_rand(jp[k].shape, 20 + i, 0.1))
    return jp, _tree(jp)


@pytest.mark.parametrize("S,lengths", [(12, (12, 2)), (128, (128, 77))])
def test_mamba_block_with_padding(S, lengths):
    """A right-padded batch (a row shorter than the conv's tail of 3, and
    S = 128 for two chunks): the output, the final state (dt = 0 on
    padding) and the conv tail gathered at each row's true length."""
    jp, tp = _mamba_layer()
    dims = pssm.ssm_dims(SSM_CFG)
    x = _rand((2, S, SSM_CFG.d_model), 9)
    h0 = _rand((2, dims["nheads"], dims["headdim"], dims["dstate"]), 10,
               0.1)
    mask = (np.arange(S)[None, :] < np.array(lengths)[:, None]) \
        .astype(np.float32)
    j_out, j_h, j_tail = jax.jit(
        lambda p, x, h, m: jssm.mamba_block(p, x, JSSM_CFG, JPOL, h,
                                            seq_mask=m))(
        jp, jnp.asarray(x), jnp.asarray(h0), jnp.asarray(mask))
    t_out, t_h, t_tail = pssm.mamba_block(
        tp, torch.from_numpy(x), SSM_CFG, TPOL, torch.from_numpy(h0),
        seq_mask=torch.from_numpy(mask))
    for got, ref in ((t_out, j_out), (t_h, j_h), (t_tail, j_tail)):
        assert got.shape == ref.shape
        _close(got, ref)
    if lengths[1] == 2:
        # the conv tail holds 3 inputs and the row has 2: one zero row
        assert not t_tail[1, 0].any() and t_tail[1, 1:].all()


def test_mamba_block_decode():
    jp, tp = _mamba_layer(1)
    dims = pssm.ssm_dims(SSM_CFG)
    x = _rand((2, SSM_CFG.d_model), 11)
    h = _rand((2, dims["nheads"], dims["headdim"], dims["dstate"]), 12, 0.1)
    conv = _rand((2, SSM_CFG.ssm_conv_width - 1, dims["conv_channels"]), 13)
    ref = jssm.mamba_block_decode(jp, jnp.asarray(x), JSSM_CFG, JPOL,
                                  jnp.asarray(h), jnp.asarray(conv))
    got = pssm.mamba_block_decode(tp, torch.from_numpy(x), SSM_CFG, TPOL,
                                  torch.from_numpy(h),
                                  torch.from_numpy(conv))
    for a, b in zip(got, ref):
        _close(a, b)


def test_init_mamba_layer_matches_reference_layout():
    """The port's draw has the reference's keys, shapes and constants."""
    jp = jssm.init_mamba_layer(jax.random.PRNGKey(0), JSSM_CFG, jnp.float32)
    tp = pssm.init_mamba_layer(torch.Generator().manual_seed(0), SSM_CFG,
                               torch.float32)
    assert set(tp) == set(jp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape, k
    for k in ("norm", "conv_b", "A_log", "D", "dt_bias", "gate_norm"):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the hybrid stack
# ---------------------------------------------------------------------------
HYB_CFG = get_config("zamba2-1.2b").reduced()
JHYB_CFG = jax_get_config("zamba2-1.2b").reduced()


@pytest.mark.parametrize("buf_len", [8, 32])
def test_hybrid_forward_seq_and_decode(buf_len, tmp_path, monkeypatch):
    """forward_seq on a right-padded batch (lengths 12 and 9), then 8
    decode steps, against the reference's (whose decode attention is the
    masked attention): hidden states and every cache entry. buf_len 8 is
    shorter than the prompt, so the rings take buf = S = 12 and wrap
    during decode; buf_len 32 leaves pad slots ahead of the short row.
    Each step's attention goes through the paged kernel, once per site."""
    jparams = jhyb.init_params(jax.random.PRNGKey(2), JHYB_CFG, jnp.float32)
    tparams = carry_params(jparams, tmp_path)
    calls = []
    paged = phyb.paged_attention
    monkeypatch.setattr(phyb, "paged_attention",
                        lambda *a: calls.append(1) or paged(*a))
    S, lengths = 12, np.array([12, 9], np.int32)
    x = _rand((2, S, HYB_CFG.d_model), 14)
    j_h, j_cache = jax.jit(lambda p, x, l: jhyb.forward_seq(
        p, x, JHYB_CFG, JPOL, collect_cache=True, buf_len=buf_len,
        lengths=l))(jparams, jnp.asarray(x), jnp.asarray(lengths))
    t_h, t_cache = phyb.forward_seq(
        tparams, torch.from_numpy(x), HYB_CFG, TPOL, buf_len,
        torch.from_numpy(lengths))
    _close(t_h, j_h)
    assert set(t_cache) == set(j_cache)
    assert t_cache["shared_k"].shape[2] == max(buf_len, S)
    step = jax.jit(lambda p, x, c: jhyb.decode_step(p, x, c, JHYB_CFG, JPOL))
    for i in range(8):
        xt = _rand((2, 1, HYB_CFG.d_model), 30 + i)
        j_h, j_cache = step(jparams, jnp.asarray(xt), j_cache)
        t_h = phyb.decode_step(tparams, torch.from_numpy(xt), t_cache,
                               HYB_CFG, TPOL)
        _close(t_h, j_h)
        for k in j_cache:
            _close(t_cache[k].float(), j_cache[k])
    assert len(calls) == 8 * phyb.n_attn_sites(HYB_CFG)


# ---------------------------------------------------------------------------
# cross-attention (audio decoder)
# ---------------------------------------------------------------------------
def test_cross_attn_block():
    """Prefill (S = 7 queries over T_enc = 11 frames: the flash kernel,
    non-causal) and a one-token step (the paged kernel over the encoder
    K/V viewed as one page a row, 11 slots, every frame visible), against
    the reference's cross_attn_block."""
    cfg = get_config("seamless-m4t-large-v2").reduced()
    jcfg = jax_get_config("seamless-m4t-large-v2").reduced()
    jp = jt.init_decoder_layer(jax.random.PRNGKey(3), jcfg, jnp.float32,
                               cross_attention=True)
    tp = _tree(jp)
    B, T, Kv, hd = 2, 11, cfg.num_kv_heads, cfg.head_dim
    (jk, tk), (jv, tv) = _both(_rand((B, T, Kv, hd), 15),
                               _rand((B, T, Kv, hd), 16))
    for S in (7, 1):
        (jx, tx), = _both(_rand((B, S, cfg.d_model), 17 + S))
        ref = jt.cross_attn_block(jp, jx, jk, jv, jcfg, JPOL)
        _close(pt.cross_attn_block(tp, tx, tk, tv, cfg, TPOL), ref)
        if S == 1:
            pages = encoder_kv_pages(tk[None], tv[None])
            assert pages[0].shape == (1, B, T, Kv, hd)   # one page a row
            assert pages[3].tolist() == [T] * B
            got = pt.cross_attn_block(
                tp, tx, None, None, cfg, TPOL,
                pages=(pages[0][0], pages[1][0], pages[2], pages[3]))
            _close(got, ref)
