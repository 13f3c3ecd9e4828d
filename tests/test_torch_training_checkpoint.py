"""The port's npz checkpoints against the reference's (the twin of
tests/test_system.py's ``test_checkpoint_then_serve``): a reference
checkpoint of params and AdamW moments, read by the port's
``load_checkpoint`` and written again by its ``save_checkpoint``, is the
reference's file array for array (keys, dtypes and values: bf16 as its
uint16 view, int8 and nf4 leaves by their field tags, the layers stacked
on a leading axis, moments too), and the reference's ``load_checkpoint``
reads it; ``repro_torch.weights`` reads the port's file; a reference
checkpoint loaded by the port serves the reference's f32 greedy
tokens."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.training import adamw_init as jax_adamw_init  # noqa: E402
from repro.training.checkpoint import (  # noqa: E402
    load_checkpoint as jax_load, save_checkpoint as jax_save)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training.checkpoint import (  # noqa: E402
    load_checkpoint, save_checkpoint)
from repro_torch.training.optimizer import tree_leaves  # noqa: E402
from repro_torch.weights import load_jax_checkpoint  # noqa: E402

from _torch_training import few_threads  # noqa: E402,F401

# (arch, format): bf16 and int8 decoder layers, nf4 MoE experts (3-D
# quantized leaves), the audio encoder's stack, the hybrid's shared block
CASES = [("stablelm-1.6b", "bfloat16"), ("stablelm-1.6b", "int8"),
         ("granite-moe-1b-a400m", "nf4"),
         ("seamless-m4t-large-v2", "bfloat16"), ("zamba2-1.2b", "bfloat16")]


def _reference_checkpoint(arch, fmt, path):
    """Reference params under ``fmt`` and AdamW moments holding random
    values at step 7, saved by the reference at step 7."""
    m = jax_build_model(jax_get_config(arch).reduced(), fmt=fmt)
    params = jax.jit(lambda key: m.quantize(m.init(key)))(
        jax.random.PRNGKey(0))
    opt = jax_adamw_init(params)
    rng = np.random.default_rng(1)
    for k in ("m", "v"):
        opt[k] = jax.tree.map(lambda z: jnp.asarray(
            rng.standard_normal(z.shape), jnp.float32), opt[k])
    opt["step"] = jnp.asarray(7, jnp.int32)
    jax_save(path, params, opt, step=7)
    return params, opt


def _npz(path):
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("arch,fmt", CASES)
def test_port_rewrites_the_reference_checkpoint(arch, fmt, tmp_path):
    ref_path, port_path = str(tmp_path / "ref.npz"), str(tmp_path / "pt.npz")
    _reference_checkpoint(arch, fmt, ref_path)
    params, opt, step = load_checkpoint(ref_path, device="cpu")
    assert step == 7 and int(opt["step"]) == 7
    assert isinstance(params["layers"], list)
    assert isinstance(opt["m"]["layers"], list)
    save_checkpoint(port_path, params, opt, step)
    ref, got = _npz(ref_path), _npz(port_path)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    jparams, jopt, jstep = jax_load(port_path)
    assert jstep == 7 and int(jopt["step"]) == 7
    # repro_torch.weights reads the port's file: the same params
    again = load_jax_checkpoint(port_path, device="cpu")
    for a, b in zip(tree_leaves(again), tree_leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_reference_checkpoint_serves_reference_tokens(tmp_path):
    """A reference f32 checkpoint, loaded by the port, greedy-decodes the
    reference's tokens from the same prompts."""
    cfg = jax_get_config("stablelm-1.6b").reduced()
    jm = jax_build_model(cfg, fmt="float32")
    jparams = jax.jit(jm.init)(jax.random.PRNGKey(0))
    path = str(tmp_path / "ck.npz")
    jax_save(path, jparams, step=3)
    params, opt, step = load_checkpoint(path, device="cpu")
    assert opt is None and step == 3
    tm = build_model(get_config("stablelm-1.6b").reduced(), fmt="float32",
                     device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8))
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                        buf_len=32)
    with torch.no_grad():
        tl, tc = tm.prefill(params, {"tokens": torch.from_numpy(toks)},
                            buf_len=32)
    step_fn = jax.jit(jm.decode_step)
    jtoks, ttoks = [], []
    for _ in range(6):
        jt, tt = np.asarray(jnp.argmax(jl, -1)), tl.argmax(-1).numpy()
        jtoks.append(jt)
        ttoks.append(tt)
        jl, jc = step_fn(jparams, jnp.asarray(jt[:, None], jnp.int32), jc)
        with torch.no_grad():
            tl, tc = tm.decode_step(params, torch.from_numpy(tt[:, None]),
                                    tc)
    np.testing.assert_array_equal(np.stack(ttoks), np.stack(jtoks))
