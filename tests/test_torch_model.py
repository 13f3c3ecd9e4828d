"""The port's dense decoder (repro_torch.models) against the JAX package:
the layer functions one by one, then reduced llama-3.1-8b end to end
through prefill and 8 decode steps on weights carried across through the
reference's npz checkpoint."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.paper_zoo import PAPER_MODELS  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import transformer as jt  # noqa: E402

from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as pl  # noqa: E402
from repro_torch.models import transformer as pt  # noqa: E402

from _torch_parity import carry_params, rel_err, to_numpy  # noqa: E402

CFG = PAPER_MODELS["llama-3.1-8b"].reduced()


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# layer functions (f32 at 2e-5 unless stated)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    x, g = _rand((2, 5, 64), 0), _rand((64,), 1)
    ref = jl.rms_norm(jnp.asarray(x).astype(dtype), jnp.asarray(g))
    got = pl.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                      torch.from_numpy(g))
    # bf16: one rounding of the same f32 value, at most one ulp apart
    assert rel_err(got, ref) < (1e-6 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("decode", [False, True])
def test_apply_rope(decode):
    """Halves, not interleaved; prefill positions (S,) and decode (B, 1)."""
    x = _rand((2, 6, 4, 32), 2)
    pos = (np.array([[7], [40]], np.int32) if decode
           else np.arange(6, dtype=np.int32))
    if decode:
        x = x[:, :1]
    ref = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = pl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                        10000.0)
    np.testing.assert_allclose(to_numpy(got), to_numpy(ref), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("causal,window,masked", [
    (True, None, False), (False, None, False), (True, 5, False),
    (False, None, True)])
def test_attention(causal, window, masked):
    B, S, T, H, Kv, d = 2, 9, 9, 8, 2, 16
    q, k, v = _rand((B, S, H, d), 3), _rand((B, T, Kv, d), 4), \
        _rand((B, T, Kv, d), 5)
    mask = np.random.default_rng(6).random((B, S, T)) > 0.3
    mask[..., 0] = True
    kw = dict(causal=causal, window=window)
    ref = jl.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       mask=jnp.asarray(mask) if masked else None, **kw)
    got = pl.attention(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v),
                       mask=torch.from_numpy(mask) if masked else None, **kw)
    np.testing.assert_allclose(to_numpy(got), to_numpy(ref), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("window", [None, 300])
def test_chunked_attention(window):
    B, S, H, Kv, d = 1, 1024, 4, 2, 16
    q, k, v = _rand((B, S, H, d), 7), _rand((B, S, Kv, d), 8), \
        _rand((B, S, Kv, d), 9)
    ref = jl.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True, window=window)
    got = pl.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=True,
                               window=window)
    np.testing.assert_allclose(to_numpy(got), to_numpy(ref), rtol=2e-5,
                               atol=2e-5)
    direct = pl.attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True, window=window)
    np.testing.assert_allclose(to_numpy(got), to_numpy(direct), rtol=2e-5,
                               atol=2e-5)


def test_cache_functions():
    """cache_write_decode (in place), the decode mask with and without a
    window, slot positions after a padded prefill, int8 KV codes."""
    B, W, Kv, d = 3, 8, 2, 4
    ck, cv = _rand((B, W, Kv, d), 10), _rand((B, W, Kv, d), 11)
    k, v = _rand((B, 1, Kv, d), 12), _rand((B, 1, Kv, d), 13)
    pos = np.array([3, 9, 0], np.int32)
    rk, rv = jl.cache_write_decode(jnp.asarray(ck), jnp.asarray(cv),
                                   jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(pos))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    pl.cache_write_decode(tk, tv, torch.from_numpy(k), torch.from_numpy(v),
                          torch.from_numpy(pos))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))

    slot_pos = np.array([[0, 1, 2, 3, -1, -1, -1, -1],
                         [8, 9, 2, 3, 4, 5, 6, 7],
                         [0, -1, -1, -1, -1, -1, -1, -1]], np.int32)
    for window in (None, 4):
        ref = jl.decode_attention_mask(jnp.asarray(slot_pos),
                                       jnp.asarray(pos), window)
        got = pl.decode_attention_mask(torch.from_numpy(slot_pos),
                                       torch.from_numpy(pos), window)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

    lengths = np.array([5, 12, 1], np.int32)
    for padded in (6, 12):
        ref = jl.slot_positions_after_prefill(W, jnp.asarray(lengths),
                                              padded)
        got = pl.slot_positions_after_prefill(W, torch.from_numpy(lengths),
                                              padded)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

    x = _rand((2, 3, Kv, 16), 14)
    x[0, 0, 0] = 0.0
    rc, rs = jt.quantize_kv(jnp.asarray(x))
    gc, gs = pt.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(
        to_numpy(pt.dequantize_kv(gc, gs, torch.bfloat16)),
        to_numpy(jt.dequantize_kv(rc, rs, jnp.bfloat16)))


# ---------------------------------------------------------------------------
# end to end: reduced llama-3.1-8b, prefill + 8 decode steps
# ---------------------------------------------------------------------------
PROMPT_LENS = np.array([12, 9], np.int32)
N_DECODE = 8


def _models(fmt, tmp_path, kv_quant=False, window=None):
    jm = jax_build_model(CFG, fmt=fmt, kv_quant=kv_quant,
                         window_override=window)
    params = jm.init(jax.random.PRNGKey(0))
    params = jm.quantize(params)
    tm = build_model(CFG, fmt=fmt, kv_quant=kv_quant, window_override=window,
                     device="cpu")
    return jm, params, tm, carry_params(params, tmp_path)


def _prompt():
    toks = np.random.default_rng(3).integers(
        0, CFG.vocab_size, (2, int(PROMPT_LENS.max()))).astype(np.int32)
    toks[1, PROMPT_LENS[1]:] = 0
    return toks


def _run(jm, jparams, tm, tparams, buf_len, teacher_forced):
    """Prefill, then N_DECODE steps. Greedy per package, or both fed the
    JAX tokens (teacher forcing). Returns each package's per-step
    logits."""
    toks = _prompt()
    jl_, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                         buf_len=buf_len, lengths=jnp.asarray(PROMPT_LENS))
    tl_, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                         buf_len=buf_len,
                         lengths=torch.from_numpy(PROMPT_LENS))
    j_logits, t_logits = [np.asarray(jl_)], [to_numpy(tl_)]
    step = jax.jit(jm.decode_step)
    for _ in range(N_DECODE):
        jt_ = np.array(jnp.argmax(j_logits[-1], -1))
        tt_ = jt_ if teacher_forced else t_logits[-1].argmax(-1)
        jl_, jc = step(jparams, jnp.asarray(jt_[:, None], jnp.int32), jc)
        tl_, tc = tm.decode_step(tparams, torch.from_numpy(tt_[:, None]), tc)
        j_logits.append(np.asarray(jl_))
        t_logits.append(to_numpy(tl_))
    return j_logits, t_logits


@pytest.mark.parametrize("window", [None, 16])
def test_float32_greedy_tokens_identical(window, tmp_path):
    """f32: identical greedy tokens, logits within 1e-4. With window 16
    the ring buffer wraps (prompt 12 + 8 new > 16)."""
    jm, jp, tm, tp = _models("float32", tmp_path, window=window)
    j_logits, t_logits = _run(jm, jp, tm, tp, buf_len=32,
                              teacher_forced=False)
    for a, b in zip(t_logits, j_logits):
        np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


# 16-bit activations: the two packages round to bf16 at the same points,
# but f32 sums taken in other orders can land one bf16 ulp (2^-8
# relative) apart, and over 2 layers and 8 steps such differences
# compound. int8 adds the scale-order difference (after the product here,
# before it in the JAX reference path); nf4 adds nothing.
TEACHER_TOL = 5e-2


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("fmt", ["bfloat16", "int8", "nf4"])
def test_teacher_forced_logits(fmt, kv_quant, tmp_path):
    """Prefill logits and 8 teacher-forced decode steps within
    TEACHER_TOL of the max |logit|, relative."""
    jm, jp, tm, tp = _models(fmt, tmp_path, kv_quant=kv_quant)
    j_logits, t_logits = _run(jm, jp, tm, tp, buf_len=32,
                              teacher_forced=True)
    for i, (a, b) in enumerate(zip(t_logits, j_logits)):
        assert np.isfinite(a).all()
        assert rel_err(a, b) < TEACHER_TOL, f"step {i}"


def test_config_parity():
    """The paper's zoo and every ARCH_IDS config: the same fields and
    param counts (total and active) in both packages, full and
    reduced."""
    from repro.configs import get_config as jax_get_config
    from repro.configs.base import ARCH_IDS as J_IDS
    from repro.configs.paper_zoo import PAPER_MODELS as JZ
    from repro_torch.configs import ARCH_IDS as T_IDS
    from repro_torch.configs import get_config as torch_get_config
    from repro_torch.configs.paper_zoo import PAPER_MODELS as TZ
    import dataclasses
    assert set(JZ) == set(TZ)
    assert tuple(J_IDS) == tuple(T_IDS)
    pairs = [(JZ[name], TZ[name]) for name in JZ] \
        + [(jax_get_config(a), torch_get_config(a)) for a in J_IDS]
    for full_j, full_t in pairs:
        for c_j, c_t in ((full_j, full_t),
                         (full_j.reduced(), full_t.reduced())):
            assert dataclasses.asdict(c_j) == dataclasses.asdict(c_t)
            assert c_j.param_count() == c_t.param_count()
            assert c_j.param_count(active_only=True) \
                == c_t.param_count(active_only=True)
