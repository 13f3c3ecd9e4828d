"""The port on the ARCH_IDS it builds (four dense, two MoE) against the JAX
package, the torch twin of tests/test_arch_smoke.py: reduced configs,
weights carried across through the reference's npz checkpoint, prefill
and 8 decode steps. float32 greedy tokens identical and logits within
1e-5; bf16, int8 and nf4 teacher-forced within TEACHER_TOL; float32 with
an int8 KV cache with identical tokens and its own stated logit bound.
Also: each of the six serves through the port's engine, and the other
families still raise.

MoE runs record both packages' routing (the top-k expert ids of every
token, layer and forward). A 16-bit step whose logits miss TEACHER_TOL is
a fault unless the two packages routed some token of that forward to
different experts at a near-tie of the reference's router probabilities
(ROADMAP fault C3); that forward is then run again with the port routing
every token to the reference's experts, and held to the bound.

XLA:CPU cannot compile the reference's int8 expert product, so in the
int8 MoE runs that one function runs op by op on the host, called back
from the compiled reference model (``_torch_parity.host_expert_product``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as pt_moe  # noqa: E402

from _torch_parity import (carry_params, host_expert_product,  # noqa: E402
                           rel_err, to_numpy)

PORTED = ("stablelm-1.6b", "minitron-8b", "h2o-danube-3-4b",
          "command-r-35b", "qwen3-moe-30b-a3b", "granite-moe-1b-a400m")
UNPORTED = tuple(a for a in ARCH_IDS if a not in PORTED)
N_DECODE = 8
# as tests/test_torch_model.py: 16-bit activations round at the same
# points in both packages, but f32 sums in other orders can land one bf16
# ulp apart and compound over 2 layers and 8 steps; int8 adds the scale
# order (after the product in the port's kernel, before it in the JAX
# reference path)
TEACHER_TOL = 5e-2
# float32 without an int8 KV cache: the same arithmetic with sums in
# other orders
F32_TOL = 1e-5
# float32 with kv_quant: one int8 K/V code can round the other way when
# the f32 K/V it quantizes differs in its last bit, which moves that
# entry by one code step (1/127 of its row's absmax); seen up to 1.3e-4
# of the max |logit| (h2o-danube, minitron), with identical tokens
KV_QUANT_TOL = 5e-4
# a routing flip is explained only at a near-tie: the reference's k-th
# and (k+1)-th router probabilities of the token within the relative
# drift that TEACHER_TOL bounds. The 16-bit hidden states of the two
# packages drift apart by about 1e-2 relative over layers and steps (the
# logits show it), and the router reads them in f32: the flip seen
# (qwen3, bf16, decode step 5) was at a margin of 1.7% in the reference
# and 0.75% the other way in the port.
NEAR_TIE = TEACHER_TOL


def _setup(arch):
    """(reduced config, prompt lengths, buf_len) of an arch: h2o-danube's
    prompts run past its window of 64 (its ring)."""
    cfg = get_config(arch).reduced()
    if cfg.sliding_window:
        return cfg, np.array([80, 50], np.int32), 64
    return cfg, np.array([12, 9], np.int32), 32


def _models(arch, fmt, tmp_path, kv_quant=False):
    jcfg = jax_get_config(arch).reduced()
    jm = jax_build_model(jcfg, fmt=fmt, kv_quant=kv_quant)
    params = jm.init(jax.random.PRNGKey(0))
    if jcfg.use_bias:
        # stablelm's qkv biases, non-zero so that the bias path counts
        attn = params["layers"]["attn"]
        for i, k in enumerate(("bq", "bk", "bv")):
            attn[k] = jnp.asarray(np.random.default_rng(10 + i)
                                  .standard_normal(attn[k].shape) * 0.5,
                                  attn[k].dtype)
    params = jm.quantize(params)
    tm = build_model(get_config(arch).reduced(), fmt=fmt, kv_quant=kv_quant,
                     device="cpu")
    return jm, params, tm, carry_params(params, tmp_path)


class Routes:
    """Both packages' routing, forward by forward: per MoE layer call, the
    top-k expert ids of each token and (reference) the relative margin of
    its k-th over its (k+1)-th router probability."""

    def __init__(self, monkeypatch):
        self.jax, self.torch = [], []
        # the reference's ids of each layer call, while a forward is run
        # again routed as the reference was
        self.forced = None
        ref_local, port_route = jax_moe._moe_ffn_local, pt_moe.route

        def ref_hook(p, x, *, top_k, **kw):
            logits = jnp.einsum("td,de->te", x.astype(jnp.float32),
                                p["w_router"].astype(jnp.float32))
            vals, ids = jax.lax.top_k(jax.nn.softmax(logits, -1), top_k + 1)
            margin = (vals[:, top_k - 1] - vals[:, top_k]) / vals[:, top_k - 1]
            jax.debug.callback(
                lambda i, m: self.jax.append((np.asarray(i), np.asarray(m))),
                ids[:, :top_k], margin, ordered=True)
            return ref_local(p, x, top_k=top_k, **kw)

        def port_hook(x, w_router, top_k):
            logits, probs, gates, ids = port_route(x, w_router, top_k)
            if self.forced is not None:
                ids = torch.from_numpy(np.array(self.forced.pop(0),
                                                np.int64))
                gates = probs.gather(-1, ids)
                gates = gates / gates.sum(dim=-1, keepdim=True)
            else:
                self.torch.append(ids.numpy().copy())
            return logits, probs, gates, ids

        monkeypatch.setattr(jax_moe, "_moe_ffn_local", ref_hook)
        monkeypatch.setattr(pt_moe, "route", port_hook)

    def take(self):
        """The flips since the last call: (token, port ids, reference
        ids, reference margin) wherever the two chose other experts; and
        the reference's ids of each layer call."""
        jax.effects_barrier()
        flips = []
        for (jids, margin), tids in zip(self.jax, self.torch):
            for t in range(len(tids)):
                if set(jids[t]) != set(tids[t]):
                    flips.append((t, tids[t].tolist(), jids[t].tolist(),
                                  float(margin[t])))
        assert len(self.jax) == len(self.torch)
        ids = [jids for jids, _ in self.jax]
        self.jax, self.torch = [], []
        return flips, ids

    def routed_as_reference(self, ids, forward):
        """The logits of the port's ``forward()`` with every MoE layer
        call routed to the reference's experts ``ids`` (the port's gates
        at those experts, renormalised)."""
        self.forced = list(ids)
        try:
            logits = to_numpy(forward()[0])
        finally:
            assert not self.forced, "unused reference routes"
            self.forced = None
        return logits


def _clone(cache):
    return {k: v.clone() if torch.is_tensor(v) else v
            for k, v in cache.items()}


def _run(arch, jm, jparams, tm, tparams, teacher_forced, routes=None):
    """Prefill, then N_DECODE steps; greedy per package, or both fed the
    JAX tokens (teacher forcing). Returns each package's per-step logits
    and, with ``routes``, the routing flips of each step and, for a step
    with flips, the port's logits of that step routed as the reference
    was (None for the others)."""
    cfg, lens, buf_len = _setup(arch)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, int(lens.max()))).astype(np.int32)
    toks[1, lens[1]:] = 0
    jl_, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                         buf_len=buf_len, lengths=jnp.asarray(lens))

    def prefill():
        return tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                          buf_len=buf_len, lengths=torch.from_numpy(lens))

    tl_, tc = prefill()
    j_logits, t_logits = [np.asarray(jl_)], [to_numpy(tl_)]
    flips, forced = [], []

    def record(forward):
        f, ids = routes.take()
        flips.append(f)
        forced.append(routes.routed_as_reference(ids, forward) if f
                      else None)

    if routes:
        record(prefill)
    step = jax.jit(jm.decode_step)
    for _ in range(N_DECODE):
        jt_ = np.array(jnp.argmax(j_logits[-1], -1))
        tt_ = torch.from_numpy(
            jt_ if teacher_forced else t_logits[-1].argmax(-1))[:, None]
        jl_, jc = step(jparams, jnp.asarray(jt_[:, None], jnp.int32), jc)
        before = _clone(tc) if routes else None
        tl_, tc = tm.decode_step(tparams, tt_, tc)
        j_logits.append(np.asarray(jl_))
        t_logits.append(to_numpy(tl_))
        if routes:
            record(lambda: tm.decode_step(tparams, tt_, _clone(before)))
    return j_logits, t_logits, flips, forced


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("arch", PORTED)
def test_float32_greedy_tokens_identical(arch, kv_quant, tmp_path):
    """f32: identical greedy tokens over prefill and 8 decode steps;
    logits within F32_TOL of the max |logit|, or KV_QUANT_TOL with an
    int8 KV cache."""
    jm, jp, tm, tp = _models(arch, "float32", tmp_path, kv_quant)
    j_logits, t_logits, *_ = _run(arch, jm, jp, tm, tp,
                                  teacher_forced=False)
    tol = KV_QUANT_TOL if kv_quant else F32_TOL
    for i, (a, b) in enumerate(zip(t_logits, j_logits)):
        np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))
        assert rel_err(a, b) < tol, f"step {i}"


@pytest.mark.parametrize("fmt", ["bfloat16", "int8", "nf4"])
@pytest.mark.parametrize("arch", PORTED)
def test_teacher_forced_logits(arch, fmt, tmp_path, monkeypatch):
    """Prefill logits and 8 teacher-forced decode steps within
    TEACHER_TOL of the max |logit|, relative; for MoE, a step past it
    only where the packages routed a token differently at a near-tie,
    and that step routed as the reference was within TEACHER_TOL
    (module docstring)."""
    jm, jp, tm, tp = _models(arch, fmt, tmp_path)
    if jm.cfg.is_moe and fmt == "int8":
        host_expert_product(monkeypatch)
    routes = Routes(monkeypatch) if jm.cfg.is_moe else None
    j_logits, t_logits, flips, forced = _run(
        arch, jm, jp, tm, tp, teacher_forced=True, routes=routes)
    for i, (a, b) in enumerate(zip(t_logits, j_logits)):
        assert np.isfinite(a).all()
        err = rel_err(a, b)
        if err < TEACHER_TOL:
            continue
        assert routes and flips[i], f"step {i}: {err}, no routing flip"
        assert all(m < NEAR_TIE for *_, m in flips[i]), \
            f"step {i}: {err}, flips {flips[i]}"
        rerun = rel_err(forced[i], b)
        assert rerun < TEACHER_TOL, \
            f"step {i}: {err}, and {rerun} routed as the reference"


@pytest.mark.parametrize("arch", PORTED)
def test_serves_at_reduced_size(arch):
    """build_model(get_config(arch)) serves through the engine on the
    CPU: every request gets its tokens, all in the vocabulary; an MoE
    model records its router metrics per prefill."""
    res = serve(arch, "bfloat16", n=3, max_batch=2, max_prefill_batch=2,
                device="cpu", buf_len=64)
    vocab = res.model.cfg.vocab_size
    for r in res.requests:
        assert len(r.generated) == r.max_new_tokens
        assert all(0 <= t < vocab for t in r.generated)
    aux = res.engine.backend.prefill_aux
    if res.model.cfg.is_moe:
        assert aux and all(a["dropped_fraction"] == 0.0 for a in aux)
    else:
        assert aux == []


@pytest.mark.parametrize("arch", UNPORTED)
def test_unported_families_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        build_model(get_config(arch).reduced(), device="cpu")
