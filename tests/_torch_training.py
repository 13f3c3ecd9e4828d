"""One train step of a reduced config in both packages, for the port's
training tests: the reference's ``lm_loss`` and ``jax.grad`` against the
port's ``lm_loss`` and torch autograd on the same carried f32 weights and
the same batch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import batch_for
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.training.losses import lm_loss as jax_lm_loss
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.training import AdamWConfig, adamw_init, make_train_step
from repro_torch.training.losses import lm_loss
from repro_torch.training.optimizer import (tree_leaves, tree_map,
                                            tree_unflatten)

from _torch_parity import (carry_params, finite_ssd_grad, to_numpy,
                           to_torch, two_threads)

LOSS_RTOL = 1e-5    # the loss, relative
GRAD_TOL = 1e-4     # each grad leaf, of that leaf's max |g|
B, S = 2, 16


def batches(cfg):
    """The reference's batch (tokens, labels and a family's stub inputs,
    as tests/test_arch_smoke.py builds it) and the port's copy."""
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S + 1))
    jbatch = batch_for(cfg, jnp.asarray(toks[:, :-1], jnp.int32))
    jbatch["labels"] = jnp.asarray(toks[:, 1:], jnp.int32)
    return jbatch, {k: to_torch(v) for k, v in jbatch.items()}


def step_parity(arch, tmp_path, monkeypatch):
    """Hold one f32 train step of ``arch`` (reduced) against the
    reference: the loss, the metrics' keys and every grad leaf; then the
    port's whole step (``make_train_step``) must move the params."""
    jcfg = jax_get_config(arch).reduced()
    if jcfg.family in ("ssm", "hybrid"):
        finite_ssd_grad(monkeypatch)
    jm = jax_build_model(jcfg, fmt="float32")
    jparams = jax.jit(jm.init)(jax.random.PRNGKey(0))
    jbatch, batch = batches(jcfg)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(jm, p, jbatch), has_aux=True))(jparams)

    model = build_model(get_config(arch).reduced(), fmt="float32",
                        device="cpu")
    params = carry_params(jparams, tmp_path)
    want = carry_params(jgrads, tmp_path, "grads.npz")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss, met = lm_loss(model, tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)

    assert sorted(met) == sorted(jmet)
    loss = float(loss.detach())
    assert abs(loss - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    checked = []

    def check(p, g, w):
        w = to_numpy(w)
        g = np.zeros_like(w) if g is None else to_numpy(g)
        assert g.shape == w.shape == tuple(p.shape)
        assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max(), \
            (g.shape, np.abs(g - w).max(), np.abs(w).max())
        checked.append(g.size)

    tree_map(check, params, tree_unflatten(params, list(grads)), want)
    assert len(checked) == len(tree_leaves(want)) == len(leaves)

    params = tree_unflatten(params, [p.detach() for p in leaves])
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=2))
    new, opt, metrics = step(params, adamw_init(params), batch)
    assert np.isfinite(float(metrics["lm_loss"]))
    assert int(opt["step"]) == 1
    moved = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(tree_leaves(params), tree_leaves(new)))
    assert moved > 0



@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """The training tests' modules run on two intra-op threads
    (``_torch_parity.two_threads``)."""
    with two_threads():
        yield
