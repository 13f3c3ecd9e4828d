"""The expert-parallel MoE path (``repro_torch.models.moe.expert_parallel``)
on four gloo ranks laid out as a (2, 2) data x model mesh: reduced
granite-moe-1b-a400m's f32 forward through it, on the JAX package's
weights carried across through the reference's npz checkpoint, matches
the JAX model's logits within 2e-4 on every rank, and the port's local
forward too: the reference's bar (tests/test_perf_features.py).
And each hand-written kernel's ``meta`` branch, under a cost analysis:
the CPU plain version's output shape and dtype, and its formula's FLOPs
(``repro_torch.kernels.cost``)."""
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.core.op_analysis import OpCounter
from repro_torch.kernels import cost
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.paged_attention import kernel as PK
from repro_torch.kernels.quant_matmul import kernel as QK
from repro_torch.quant.int8 import quantize_int8
from repro_torch.quant.nf4 import quantize_nf4

EP_TOL = 2e-4
WORLD = 4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


ARCH = "granite-moe-1b-a400m"


def _jax_reference(tmp_path):
    """The JAX package's reduced granite-moe-1b-a400m in f32: its weights
    saved as the reference's npz checkpoint, the tokens, and its logits
    at the last position (the reference's local MoE path)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.models import build_model as jax_build_model
    from repro.training.checkpoint import save_checkpoint
    cfg = jax_get_config(ARCH).reduced()
    m = jax_build_model(cfg, fmt="float32")
    params = m.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 8)).astype(np.int32)

    def fwd(p, t):
        h, _ = m.forward_train(p, {"tokens": t})
        return m.logits(p, h[:, -1])

    logits = np.asarray(jax.jit(fwd)(params, jnp.asarray(toks)))
    path = str(tmp_path / "granite.npz")
    save_checkpoint(path, params)
    return path, toks, logits


def _ep_rank(rank, port, ckpt, toks, out):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.api import build_model
    from repro_torch.weights import load_jax_checkpoint
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        m = build_model(get_config(ARCH).reduced(), fmt="float32",
                        device="cpu")
        params = load_jax_checkpoint(ckpt, device="cpu")
        toks = torch.from_numpy(toks)
        calls = []
        body = moe._ep_body
        moe._ep_body = lambda *a, **k: calls.append(1) or body(*a, **k)

        def fwd():
            h, aux = m.forward_train(params, {"tokens": toks})
            return m.logits(params, h[:, -1]), aux

        with torch.no_grad():
            local, _ = fwd()
            with moe.expert_parallel(mesh, data_axes=("data",)):
                got, aux = fwd()
        out[rank] = (local.numpy(), got.numpy(), len(calls),
                     {k: float(v) for k, v in aux.items()})
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ep_run(tmp_path_factory):
    """(the JAX model's logits, each rank's (local logits, expert-parallel
    logits, expert-parallel calls, aux)) from one run of four ranks."""
    ckpt, toks, jax_logits = _jax_reference(tmp_path_factory.mktemp("ep"))
    ctx = mp.get_context("spawn")
    with ctx.Manager() as manager:
        out = manager.dict()
        mp.start_processes(_ep_rank, args=(_free_port(), ckpt, toks, out),
                           nprocs=WORLD, start_method="spawn")
        results = dict(out)
    assert sorted(results) == list(range(WORLD))
    return jax_logits, results


def test_expert_parallel_matches_local_on_four_gloo_ranks(ep_run):
    _, results = ep_run
    cfg_layers = 2
    for rank, (local, got, calls, aux) in results.items():
        assert calls == cfg_layers, rank        # every MoE layer took it
        err = float(np.abs(local - got).max())
        assert err < EP_TOL, (rank, err)
        assert all(np.isfinite(v) for v in aux.values())
    # every rank ends with the same (whole) batch
    for rank in range(1, WORLD):
        np.testing.assert_array_equal(results[rank][1], results[0][1])


def test_expert_parallel_matches_jax_on_four_gloo_ranks(ep_run):
    jax_logits, results = ep_run
    for rank, (local, got, _, _) in results.items():
        assert got.shape == jax_logits.shape, rank
        err = float(np.abs(got - jax_logits).max())
        assert err < EP_TOL, (rank, err)
        # the local path, on the same carried weights, too
        err = float(np.abs(local - jax_logits).max())
        assert err < EP_TOL, (rank, "local", err)


# ---------------------------------------------------------------------------
# the kernels' meta branches
# ---------------------------------------------------------------------------
def _pair(shape, dtype=torch.bfloat16, seed=0):
    """(a CPU tensor, a meta tensor) of ``shape``."""
    g = torch.Generator().manual_seed(seed)
    t = torch.randn(shape, generator=g).to(dtype)
    return t, torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None)])
def test_flash_meta_branch(causal, window):
    B, S, H, Kv, d = 2, 80, 8, 2, 64
    (q, qm), (k, km), (v, vm) = (_pair(s, seed=i) for i, s in enumerate(
        ((B, S, H, d), (B, S, Kv, d), (B, S, Kv, d))))
    plain = FK.flash_attention_plain(q, k, v, causal=causal, window=window)
    with OpCounter() as c:
        out = FK.flash_attention(qm, km, vm, causal=causal, window=window)
    assert (out.shape, out.dtype, out.device.type) == (
        plain.shape, plain.dtype, "meta")
    pairs = cost.attention_pairs(S, S, causal, window)
    assert c.cost.dot_flops == cost.flash_attention(
        B, S, S, H, Kv, d, pairs, 2)[1]
    assert c.cost.kernels == {"flash_attention": 1}


def test_flash_backward_meta_branch():
    B, S, H, Kv, d = 1, 64, 4, 4, 64
    shapes = ((B, S, H, d), (B, S, Kv, d), (B, S, Kv, d))
    metas = [torch.empty(s, dtype=torch.bfloat16, device="meta")
             .requires_grad_(True) for s in shapes]
    with OpCounter() as c:
        out = FK.flash_attention(*metas, causal=True)
        grads = torch.autograd.grad(out.sum(), metas)
    for g, s in zip(grads, shapes):
        assert g.shape == s and g.dtype == torch.bfloat16
    pairs = cost.attention_pairs(S, S, True)
    assert c.cost.kernels == {"flash_attention": 1,
                              "flash_attention_bwd": 1}
    fwd = cost.flash_attention(B, S, S, H, Kv, d, pairs, 2)[1]
    bwd = cost.flash_attention_bwd(B, S, S, H, Kv, d, pairs, 2)[1]
    assert c.cost.dot_flops == fwd + bwd


def test_paged_meta_branch():
    B, H, Kv, d, page, n_max = 3, 8, 2, 64, 16, 4
    (q, qm), (kp, kpm), (vp, vpm) = (_pair(s, seed=i) for i, s in enumerate(
        ((B, H, d), (B * n_max, page, Kv, d), (B * n_max, page, Kv, d))))
    table = torch.arange(B * n_max, dtype=torch.int32).view(B, n_max)
    lens = torch.tensor([5, 64, 30], dtype=torch.int32)
    plain = PK.paged_attention_plain(q, kp, vp, table, lens)
    with OpCounter() as c:
        out = PK.paged_attention(qm, kpm, vpm, table.to("meta"),
                                 lens.to("meta"))
    assert (out.shape, out.dtype) == (plain.shape, plain.dtype)
    # the lengths are data: every slot of the table counts
    assert c.cost.dot_flops == cost.paged_attention(
        B, H, Kv, d, B * n_max * page, B * n_max, 2)[1]


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("fmt", ["int8", "nf4"])
def test_quant_meta_branch(fmt, grouped):
    E, M, K, N = (3 if grouped else 1), 5, 128, 96
    w = torch.randn((E, K, N) if grouped else (K, N),
                    generator=torch.Generator().manual_seed(1))
    q = quantize_int8(w) if fmt == "int8" else quantize_nf4(w)
    wargs = (q.codes, q.scale) if fmt == "int8" else (q.packed, q.absmax)
    x, xm = _pair((E, M, K) if grouped else (M, K))
    name = f"{fmt}_matmul" + ("_grouped" if grouped else "")
    plain = getattr(QK, f"{fmt}_matmul_plain")(x, *wargs)
    with OpCounter() as c:
        out = getattr(QK, name)(xm, *(t.to("meta") for t in wargs))
    assert (out.shape, out.dtype) == (plain.shape, plain.dtype)
    wbytes = sum(t.numel() * t.element_size() for t in wargs)
    assert (c.cost.dot_bytes, c.cost.dot_flops) == cost.quant_matmul(
        M, K, N, wbytes, 2, E)
    assert c.cost.kernels == {name: 1}
