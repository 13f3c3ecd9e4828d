"""Helpers shared by the tests that hold the PyTorch port against the JAX
package: moving arrays across as numpy, and carrying a JAX model's
weights into the port through the reference's npz checkpoint."""
import os

import jax.numpy as jnp
import numpy as np
import torch

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
