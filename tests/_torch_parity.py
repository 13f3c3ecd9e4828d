"""Helpers shared by the tests that hold the PyTorch port against the JAX
package: moving arrays across as numpy, carrying a JAX model's weights
into the port through the reference's npz checkpoint, and compiling the
reference's int8 MoE, SSM and hybrid models on the CPU."""
import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import moe as jax_moe
from repro.training.checkpoint import save_checkpoint
from repro_torch.weights import load_jax_checkpoint


# ---------------------------------------------------------------------------
# diagnostics for an f32 comparison that misses now and then (ROADMAP C12)
# ---------------------------------------------------------------------------
_COMPARED_IN = []        # this process's test files, in the order seen
#                          (by the helpers here that they called)


def process_state() -> str:
    """The process-global state an f32 product on the CPU depends on, and
    the test files this process compared arrays in before."""
    mk = torch.backends.mkldnn
    state = {
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
        "mkldnn.enabled": mk.enabled,
        "mkldnn.matmul.fp32_precision": getattr(
            getattr(mk, "matmul", None), "fp32_precision", None),
        "num_threads": torch.get_num_threads(),
        "num_interop_threads": torch.get_num_interop_threads(),
        "deterministic": torch.are_deterministic_algorithms_enabled(),
        "cpu_capability": torch.backends.cpu.get_cpu_capability(),
        "jax_enable_x64": jax.config.jax_enable_x64,
        "worker": os.environ.get("PYTEST_XDIST_WORKER"),
        "env": {k: v for k, v in os.environ.items()
                if k.startswith(("ONEDNN", "DNNL", "MKL", "OMP", "XLA"))},
        "earlier_test_files": _COMPARED_IN[:-1],   # that used this module
    }
    return "process state (ROADMAP C12): " + repr(state)


def _note_test_file() -> None:
    test = os.environ.get("PYTEST_CURRENT_TEST", "")
    name = test.split("::")[0]
    if name and (not _COMPARED_IN or _COMPARED_IN[-1] != name):
        if name in _COMPARED_IN:
            _COMPARED_IN.remove(name)
        _COMPARED_IN.append(name)


def check_allclose(actual, desired, **kwargs) -> None:
    """``numpy.testing.assert_allclose``, whose failure message also
    carries :func:`process_state`: the comparisons ROADMAP C12 names."""
    _note_test_file()
    try:
        np.testing.assert_allclose(actual, desired, **kwargs)
    except AssertionError as e:
        raise AssertionError(f"{e}\n{process_state()}") from None


def to_torch(a) -> torch.Tensor:
    """A JAX (or numpy) array as a CPU tensor of the same dtype."""
    _note_test_file()
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()) \
            .view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def to_numpy(t) -> np.ndarray:
    """A tensor or JAX array as f32 numpy (bf16 widened exactly)."""
    _note_test_file()
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


def host_int8_matmul(monkeypatch):
    """Run the reference's 2-D int8 product (``repro.quant.apply``'s
    ``int8_matmul``) op by op on the host, called back from the compiled
    reference: XLA:CPU cannot compile it inside the SSM and hybrid
    models' layer scans (DotThunk: BF16 x BF16 = F32)."""
    from repro.quant import apply as jax_apply
    int8_matmul = jax_apply.int8_matmul

    def host(x, w, cd):
        with jax.disable_jit():
            return np.asarray(int8_matmul(x, w, cd))

    def called_back(x, w, cd):
        out = jax.ShapeDtypeStruct(x.shape[:-1] + (w.codes.shape[-1],), cd)
        return jax.pure_callback(lambda x_, w_: host(x_, w_, cd), out, x, w)

    monkeypatch.setattr(jax_apply, "int8_matmul", called_back)


@jax.custom_jvp
def _exp_finite_grad(x):
    return jnp.exp(x)


@_exp_finite_grad.defjvp
def _exp_finite_grad_jvp(primals, tangents):
    (x,), (t,) = primals, tangents
    y = jnp.exp(x)
    return y, jnp.where(jnp.isinf(y), 0.0, y) * t


class _JnpFiniteExpGrad:
    """``jax.numpy`` with an ``exp`` whose derivative is 0 where its value
    is infinite: the same forward, bit for bit."""

    exp = staticmethod(_exp_finite_grad)

    def __getattr__(self, name):
        return getattr(jnp, name)


def finite_ssd_grad(monkeypatch):
    """Give the reference's SSD scan (``repro.models.ssm``) a finite
    gradient. Its intra-chunk decay exponentiates l_i - l_j over the whole
    chunk, infinite above the diagonal, and drops those entries with a
    select after the exp: the forward is right, but the gradient through
    the dropped entries is 0 * inf = NaN in every SSM and hybrid param
    (ROADMAP C11). The port sets the exponent to 0 there before the exp;
    here the reference's ``exp`` gets a derivative of 0 where its value is
    infinite, which leaves its forward as it is and its gradient the
    exact one."""
    from repro.models import ssm as jax_ssm
    monkeypatch.setattr(jax_ssm, "jnp", _JnpFiniteExpGrad())


@contextlib.contextmanager
def two_threads():
    """Two intra-op threads for torch inside the block: the suite's
    workers share the host's cores, and eager ops on small tensors stall
    when each worker asks for all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)
