"""Helpers shared by the tests that hold the PyTorch port against the JAX
package: moving arrays across as numpy, carrying a JAX model's weights
into the port through the reference's npz checkpoint, and compiling the
reference's int8 MoE layer on the CPU."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import moe as jax_moe
from repro.training.checkpoint import save_checkpoint
from repro_torch.weights import load_jax_checkpoint


def to_torch(a) -> torch.Tensor:
    """A JAX (or numpy) array as a CPU tensor of the same dtype."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()) \
            .view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def to_numpy(t) -> np.ndarray:
    """A tensor or JAX array as f32 numpy (bf16 widened exactly)."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def rel_err(got, ref) -> float:
    got, ref = to_numpy(got), to_numpy(ref)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12))


def carry_params(params, tmp_path, name="ckpt.npz"):
    """JAX params -> ``save_checkpoint`` npz -> the port's params (CPU)."""
    path = os.path.join(str(tmp_path), name)
    save_checkpoint(path, params)
    return load_jax_checkpoint(path, device="cpu")


def host_expert_product(monkeypatch):
    """Run the reference's int8 expert product (``moe._expert_dense``)
    op by op on the host, called back from the compiled reference: XLA:CPU
    cannot compile its batched bf16 x bf16 -> f32 dots (DotThunk), and
    running the whole reference op by op compiles every primitive on its
    own (about 30 s in each test process)."""
    expert_dense = jax_moe._expert_dense

    def host(w, x, policy):
        with jax.disable_jit():
            return np.asarray(expert_dense(w, x, policy))

    def called_back(w, x, policy):
        out = jax.ShapeDtypeStruct(x.shape[:-1] + (w.codes.shape[-1],),
                                   policy.compute_dtype)
        return jax.pure_callback(lambda w_, x_: host(w_, x_, policy), out,
                                 w, x)

    monkeypatch.setattr(jax_moe, "_expert_dense", called_back)
