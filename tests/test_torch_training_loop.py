"""The port's optimizer and training loop against the reference:
``adamw_update`` on the same numpy params, grads and state (f32, within
1e-6, decay on matrices only, the global-norm clip on and off), the
loop's loss falling over 25 steps (the twin of tests/test_system.py's
``test_training_reduces_loss``), the loop's log line, a quantized
``forward_train`` under ``torch.no_grad()`` (the twin of
``test_quantized_model_generates_same_scale_logits``), and ``train``
refusing to fall back to the CPU."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.training import optimizer as jax_opt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import (AdamWConfig, adamw_init,  # noqa: E402
                                  adamw_update, train)
from repro_torch.training.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.training.optimizer import (global_norm,  # noqa: E402
                                            tree_leaves, tree_map)

from _torch_training import few_threads  # noqa: E402,F401

OPT_TOL = 1e-6


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def a(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"w": a(8, 16), "b": a(16), "experts": a(3, 4, 5),
            "layers": [{"m": a(4, 4), "g": a(4)}, {"m": a(4, 4), "g": a(4)}]}


@pytest.mark.parametrize("grad_scale", [0.01, 3.0])   # unclipped, clipped
def test_adamw_matches_reference(grad_scale):
    cfg = AdamWConfig(lr=1e-2, warmup_steps=3, weight_decay=0.1)
    jcfg = jax_opt.AdamWConfig(lr=1e-2, warmup_steps=3, weight_decay=0.1)
    params = _tree(0)
    jp = tree_map(jnp.asarray, params)
    tp = tree_map(torch.from_numpy, params)
    jstate, tstate = jax_opt.adamw_init(jp), adamw_init(tp)
    for step in range(4):
        grads = _tree(10 + step, grad_scale)
        jp, jstate, jm = jax_opt.adamw_update(
            jcfg, jp, tree_map(jnp.asarray, grads), jstate)
        tp, tstate, tm = adamw_update(cfg, tp, tree_map(torch.from_numpy,
                                                        grads), tstate)
        assert int(tstate["step"]) == int(jstate["step"]) == step + 1
        assert tstate["step"].dtype == torch.int32
        for k in ("grad_norm", "lr"):
            assert abs(float(tm[k]) - float(jm[k])) <= OPT_TOL * max(
                1.0, abs(float(jm[k])))
        def close(got, want):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=OPT_TOL, atol=OPT_TOL)

        for got, want in ((tp, jp), (tstate["m"], jstate["m"]),
                          (tstate["v"], jstate["v"])):
            tree_map(close, got, want)
    clipped = float(tm["grad_norm"]) > cfg.grad_clip
    assert clipped == (grad_scale > 1)


def test_adamw_decays_matrices_only_and_keeps_dtypes():
    """Zero gradients: a matrix shrinks by lr * weight_decay * p, a vector
    does not move; bf16 params stay bf16 with f32 moments."""
    cfg = AdamWConfig(lr=0.5, warmup_steps=1, weight_decay=0.1)
    params = {"w": torch.ones((2, 3), dtype=torch.bfloat16),
              "b": torch.ones((3,), dtype=torch.bfloat16)}
    state = adamw_init(params)
    assert all(t.dtype == torch.float32 for t in tree_leaves(state["m"]))
    new, state, metrics = adamw_update(cfg, params, tree_map(
        torch.zeros_like, params), state)
    assert new["w"].dtype == new["b"].dtype == torch.bfloat16
    assert torch.equal(new["b"], params["b"])
    assert torch.equal(new["w"], torch.full((2, 3), 0.95).bfloat16())
    assert float(metrics["grad_norm"]) == 0.0
    assert float(global_norm({"a": torch.full((4,), 2.0)})) == 4.0


def test_training_reduces_loss(capsys):
    cfg = get_config("h2o-danube-3-4b").reduced()
    m = build_model(cfg, fmt="float32")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  batch_size=4))
    losses = []
    state = train(m, data.batches(), n_steps=25, log_every=10,
                  opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=5),
                  callback=lambda s, met: losses.append(
                      float(met["lm_loss"])),
                  torch_device="cpu")
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.8
    assert state.step == 25 and int(state.opt_state["step"]) == 25
    assert all(t.device.type == "cpu" for t in tree_leaves(state.params))
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in lines] == ["0", "10", "20", "24"]
    assert all("loss=" in ln and "grad_norm=" in ln for ln in lines)


def test_train_refuses_to_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device exists")
    cfg = get_config("stablelm-1.6b").reduced()
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=8,
                                  batch_size=2))
    with pytest.raises(ValueError, match="torch_device"):
        train(build_model(cfg, fmt="float32"), data.batches(), n_steps=1)


def test_quantized_forward_train_under_no_grad():
    """PTQ int8 forward_train produces logits close to f32, through the
    quant kernels' plain versions."""
    cfg = get_config("minitron-8b").reduced()
    m32 = build_model(cfg, fmt="float32", device="cpu")
    params = m32.init(torch.Generator().manual_seed(0))
    m8 = build_model(cfg, fmt="int8", device="cpu")
    q = m8.quantize(params)
    toks = torch.randint(0, cfg.vocab_size, (1, 16),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        h32, _ = m32.forward_train(params, {"tokens": toks})
        h8, _ = m8.forward_train(q, {"tokens": toks})
        l32 = m32.logits(params, h32[:, -1])
        l8 = m8.logits(q, h8[:, -1])
    rel = float(torch.linalg.norm(l8 - l32) / torch.linalg.norm(l32))
    assert rel < 0.25
    # with grad on and a param that requires grad, the int8 kernel refuses
    q["embed"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        m8.forward_train(q, {"tokens": toks})
