"""The vlm, audio, SSM and hybrid families of the port against the JAX
package, the torch twin of tests/test_arch_smoke.py over
phi-3-vision-4.2b, seamless-m4t-large-v2, mamba2-2.7b and zamba2-1.2b:
reduced configs, weights carried across through the reference's npz
checkpoint, prefill and 8 decode steps (vlm with patch embeddings, audio
with frame embeddings, hybrid with a prompt past its ring). float32
greedy tokens identical and logits within F32_TOL; bf16, int8 and nf4
teacher-forced within TEACHER_TOL. And every ARCH_IDS config builds and
steps. The serving path of these families is held in
tests/test_torch_families_serve.py.

XLA:CPU cannot compile the reference's int8 SSM and hybrid models, so
in those runs the reference's int8 product runs op by op on the host,
called back from the compiled model (``_torch_parity.host_int8_matmul``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402

from repro_torch.batching.continuous import CACHE_BATCH_AXIS  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

from _torch_parity import (carry_params, host_int8_matmul,  # noqa: E402
                           rel_err, to_numpy)

FAMILIES = ("phi-3-vision-4.2b", "seamless-m4t-large-v2", "mamba2-2.7b",
            "zamba2-1.2b")
N_DECODE = 8
# as tests/test_torch_archs.py
F32_TOL = 1e-5
TEACHER_TOL = 5e-2
T_ENC = 5               # audio frames a request (no multiple of 8)


def _setup(arch):
    """(reduced config, prompt lengths, buf_len): hybrid's buf_len is
    shorter than the prompt, so its rings take the prompt's length and
    wrap during decode."""
    cfg = get_config(arch).reduced()
    return cfg, np.array([12, 9], np.int32), 8 if arch == "zamba2-1.2b" \
        else 32


def _batch(cfg, toks):
    """numpy inputs: tokens, and the stub patches (vlm) or frames
    (audio) in f32, which each model casts to its activation dtype."""
    rng = np.random.default_rng(5)
    b = {"tokens": toks}
    if cfg.family == "vlm":
        b["patches"] = (rng.standard_normal(
            (toks.shape[0], cfg.num_patches, cfg.d_model)) * 0.1
        ).astype(np.float32)
    if cfg.family == "audio":
        b["frames"] = (rng.standard_normal(
            (toks.shape[0], T_ENC, cfg.d_model)) * 0.1).astype(np.float32)
    return b


def _models(arch, fmt, tmp_path):
    jm = jax_build_model(jax_get_config(arch).reduced(), fmt=fmt)
    params = jm.quantize(jm.init(jax.random.PRNGKey(0)))
    tm = build_model(get_config(arch).reduced(), fmt=fmt, device="cpu")
    return jm, params, tm, carry_params(params, tmp_path)


def _run(arch, jm, jparams, tm, tparams, teacher_forced):
    """Prefill, then N_DECODE steps; greedy per package, or both fed the
    JAX tokens. Returns each package's per-step logits."""
    cfg, lens, buf_len = _setup(arch)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, int(lens.max()))).astype(np.int32)
    toks[1, lens[1]:] = 0
    batch = _batch(cfg, toks)
    jl_, jc = jm.prefill(jparams, {k: jnp.asarray(v)
                                   for k, v in batch.items()},
                         buf_len=buf_len, lengths=jnp.asarray(lens))
    tl_, tc = tm.prefill(tparams, {k: torch.from_numpy(v)
                                   for k, v in batch.items()},
                         buf_len=buf_len, lengths=torch.from_numpy(lens))
    j_logits, t_logits = [np.asarray(jl_)], [to_numpy(tl_)]
    step = jax.jit(jm.decode_step)
    for _ in range(N_DECODE):
        jt_ = np.array(jnp.argmax(j_logits[-1], -1))
        tt_ = torch.from_numpy(
            jt_ if teacher_forced else t_logits[-1].argmax(-1))[:, None]
        jl_, jc = step(jparams, jnp.asarray(jt_[:, None], jnp.int32), jc)
        tl_, tc = tm.decode_step(tparams, tt_, tc)
        j_logits.append(np.asarray(jl_))
        t_logits.append(to_numpy(tl_))
    return j_logits, t_logits, tc


@pytest.mark.parametrize("arch", FAMILIES)
def test_float32_greedy_tokens_identical(arch, tmp_path):
    """f32: identical greedy tokens over prefill and 8 decode steps;
    logits within F32_TOL of the max |logit|."""
    jm, jp, tm, tp = _models(arch, "float32", tmp_path)
    j_logits, t_logits, cache = _run(arch, jm, jp, tm, tp,
                                     teacher_forced=False)
    for i, (a, b) in enumerate(zip(t_logits, j_logits)):
        np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))
        assert rel_err(a, b) < F32_TOL, f"step {i}"
    if arch == "zamba2-1.2b":       # the prompt ran past buf_len
        assert cache["shared_k"].shape[2] == 12


@pytest.mark.parametrize("fmt", ["bfloat16", "int8", "nf4"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_teacher_forced_logits(arch, fmt, tmp_path, monkeypatch):
    """Prefill logits and 8 teacher-forced decode steps within
    TEACHER_TOL of the max |logit|, relative."""
    jm, jp, tm, tp = _models(arch, fmt, tmp_path)
    if fmt == "int8" and jm.cfg.family in ("ssm", "hybrid"):
        host_int8_matmul(monkeypatch)
    j_logits, t_logits, _ = _run(arch, jm, jp, tm, tp, teacher_forced=True)
    for i, (a, b) in enumerate(zip(t_logits, j_logits)):
        assert np.isfinite(a).all()
        assert rel_err(a, b) < TEACHER_TOL, f"step {i}"


# ---------------------------------------------------------------------------
# every config
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_builds_and_steps(arch):
    """build_model(get_config(arch).reduced(), device="cpu") for every
    ARCH_IDS id: weights drawn and quantized layer by layer, a prefill
    (with patches or frames where the family takes them) and a decode
    step, finite logits of the vocabulary's width."""
    cfg = get_config(arch).reduced()
    for fmt in ("bfloat16", "nf4"):
        m = build_model(cfg, fmt=fmt, device="cpu")
        p = m.init(torch.Generator().manual_seed(0), quantize=True)
        toks = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, 10)).astype(np.int32)
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, toks).items()}
        logits, cache = m.prefill(p, batch, buf_len=48)
        logits, cache = m.decode_step(p, logits.argmax(-1)[:, None], cache)
        assert logits.shape == (2, cfg.vocab_size)
        assert torch.isfinite(logits).all()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_cache_has_the_prefill_cache_layout(arch):
    """The serving backend slots prefill caches into init_cache's lanes:
    the empty cache has the keys, dtypes and per-lane shapes of a
    prefill's. An audio cache holds the encoder K/V of its frames and has
    no empty form: init_cache refuses it."""
    cfg = get_config(arch).reduced()
    m = build_model(cfg, fmt="bfloat16", device="cpu")
    if cfg.family == "audio":
        with pytest.raises(ValueError, match="prefill"):
            m.init_cache(2, 48)
        return
    p = m.init(torch.Generator().manual_seed(0))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 10))
    _, cache = m.prefill(p, {"tokens": torch.from_numpy(toks)}, buf_len=48)
    empty = m.init_cache(3, 48)
    assert set(empty) == set(cache)
    for k, v in cache.items():
        assert empty[k].dtype == v.dtype, k
        lane = CACHE_BATCH_AXIS[k]
        want = v.shape[:lane] + (3,) + v.shape[lane + 1:]
        assert empty[k].shape == want, k
