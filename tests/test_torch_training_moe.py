"""Training through the MoE FFN. One f32 train step of each MoE config of
ARCH_IDS (reduced) against ``jax.grad`` of the reference's ``lm_loss``,
as test_torch_training_step.py holds the dense ones; and the router's
gradient through each aux loss alone: ``moe_ffn``'s load-balance and
z-loss, routed in f64 and cast back to f32, against ``jax.grad`` of the
reference's ``_moe_ffn_local`` (with drops, so that the dispatch's trash
slot takes writes), f32, within 1e-4 of the max |g|, and the gradient
of the output through the dispatch scatter and the combine."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.precision import make_policy as jax_policy  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.core.precision import make_policy  # noqa: E402
from repro_torch.models import moe as pt_moe  # noqa: E402

from _torch_training import few_threads, GRAD_TOL, step_parity  # noqa: E402,F401

ARCHS = ["qwen3-moe-30b-a3b", "granite-moe-1b-a400m"]
D, F, E, TOP_K, T = 32, 48, 8, 2, 64


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_reference(arch, tmp_path, monkeypatch):
    step_parity(arch, tmp_path, monkeypatch)


def _params():
    rng = np.random.default_rng(0)
    return {"w_router": rng.standard_normal((D, E)).astype(np.float32)
            * D ** -0.5,
            "experts_gate": rng.standard_normal((E, D, F)).astype(np.float32)
            * D ** -0.5,
            "experts_up": rng.standard_normal((E, D, F)).astype(np.float32)
            * D ** -0.5,
            "experts_down": rng.standard_normal((E, F, D)).astype(np.float32)
            * F ** -0.5}


@pytest.mark.parametrize("key", ["load_balance_loss", "router_z_loss",
                                 "output"])
def test_moe_gradients_match_reference(key):
    p = _params()
    x = np.random.default_rng(1).standard_normal((T, D)).astype(np.float32)
    dy = np.random.default_rng(2).standard_normal((T, D)).astype(np.float32)

    def objective(y, aux, dy_):
        return (y * dy_).sum() if key == "output" else aux[key]

    def ref(p_, x_):
        y, aux = jax_moe._moe_ffn_local(p_, x_, top_k=TOP_K,
                                        policy=jax_policy("float32"),
                                        capacity_factor=1.0)
        return objective(y, aux, jnp.asarray(dy))

    jg_p, jg_x = jax.jit(jax.grad(ref, argnums=(0, 1)))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = pt_moe.moe_ffn(tp, tx, top_k=TOP_K, policy=make_policy(
        "float32"), capacity_factor=1.0)
    assert float(aux["dropped_fraction"]) > 0
    objective(y, aux, torch.from_numpy(dy)).backward()
    pairs = [(tp[k].grad, jg_p[k]) for k in p] + [(tx.grad, jg_x)]
    if key != "output":     # the aux losses reach the router only
        assert tp["experts_gate"].grad is None
        pairs = [(tp["w_router"].grad, jg_p["w_router"]), (tx.grad, jg_x)]
    assert float(tp["w_router"].grad.abs().max()) > 0
    for got, want in pairs:
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() \
            <= GRAD_TOL * np.abs(want).max()
