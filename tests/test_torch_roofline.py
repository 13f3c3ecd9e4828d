"""The port's roofline terms and dispatched-op cost analysis
(``repro_torch.core.roofline``, ``repro_torch.core.op_analysis``): twins
of tests/test_roofline.py. The terms equal the reference's on the same
inputs; the counter's FLOPs are exact for a matmul and scale with a
Python loop's trip count; a collective counts its output bytes; a reduced
model's forward counts within 2x of the workload estimate."""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.hardware import H100_SXM as JAX_H100
from repro.core.hlo_analysis import analyze_hlo
from repro.core.roofline import RooflineTerms as JaxTerms
from repro_torch.core import workload as W
from repro_torch.core.hardware import H100_SXM
from repro_torch.core.op_analysis import OpCost, analyze_step
from repro_torch.core.roofline import RooflineTerms, terms_from_counts

TERMS = [dict(arch="a", shape="s", mesh="m", n_chips=256, hlo_flops=1e15,
              hlo_bytes=1e13, collective_bytes=1e10, model_flops=8e14),
         dict(arch="b", shape="t", mesh="m2", n_chips=512, hlo_flops=3e12,
              hlo_bytes=7e14, collective_bytes=0.0, model_flops=2.5e12),
         dict(arch="c", shape="u", mesh="m", n_chips=1, hlo_flops=0.0,
              hlo_bytes=5e9, collective_bytes=4e11, model_flops=0.0)]


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("kw", TERMS)
@pytest.mark.parametrize("bits", [16, 32])
def test_terms_equal_the_reference(kw, bits):
    ours = RooflineTerms(**kw, collective_breakdown={}, peak_bits=bits)
    ref = JaxTerms(**kw, collective_breakdown={}, device=JAX_H100,
                   peak_bits=bits)
    assert ours.device is H100_SXM
    for name in ("t_compute", "t_memory", "t_collective", "bottleneck",
                 "useful_flop_ratio", "step_time", "roofline_fraction"):
        assert getattr(ours, name) == getattr(ref, name), name
    assert ours.row() == ref.row()


def test_terms_and_bottleneck_on_the_h100():
    t = RooflineTerms(**TERMS[0], collective_breakdown={})
    assert t.t_compute == 1e15 / (256 * 989e12)
    assert t.t_memory == 1e13 / (256 * 3.35e12)
    assert t.t_collective == 1e10 / (256 * 450e9 / 18)
    assert t.bottleneck == "memory"
    assert t.useful_flop_ratio == pytest.approx(0.8)
    assert 0 < t.roofline_fraction <= 1.001


def test_terms_from_counts_multiply_by_the_chips():
    cost = OpCost(dot_flops=2.0, dot_bytes=3.0, collective_bytes=5.0,
                  parameter_bytes=7.0)
    cost.collective_breakdown["all-reduce"] = 5.0
    t = terms_from_counts(cost, arch="a", shape="s", mesh="m", n_chips=4,
                          model_flops=1.0)
    assert (t.hlo_flops, t.hlo_bytes, t.collective_bytes) == (8, 40, 20)
    assert t.collective_breakdown["all-reduce"] == 20


class TestDispatchedCounts:
    def test_plain_matmul(self):
        a = _meta(256, 256)
        _, c = analyze_step(lambda x, y: x @ y, a, a)
        assert c.dot_flops == 2 * 256 ** 3
        assert c.dot_bytes == 3 * 256 * 256 * 4
        assert c.parameter_bytes == 2 * 256 * 256 * 4

    def test_loop_counts_every_iteration(self):
        x = _meta(128, 128)

        def g(x):
            c = x
            for _ in range(7):
                c = c @ x
            return c

        _, c = analyze_step(g, x)
        assert c.dot_flops == 7 * 2 * 128 ** 3

    def test_nested_loops(self):
        x = _meta(64, 64)

        def g(x):
            c = x
            for _ in range(5):
                for _ in range(3):
                    c = c @ x
            return c

        _, c = analyze_step(g, x)
        assert c.dot_flops == 15 * 2 * 64 ** 3

    def test_batched_and_backward_products(self):
        """bmm, and the backward's two products of each matmul."""
        a, b = _meta(4, 32, 16), _meta(4, 16, 8)
        _, c = analyze_step(torch.bmm, a, b)
        assert c.dot_flops == 2 * 4 * 32 * 16 * 8
        w = _meta(16, 8).requires_grad_(True)
        x = _meta(32, 16).requires_grad_(True)
        _, c = analyze_step(lambda x, w: (x @ w).sum().backward(), x, w)
        assert c.dot_flops == 3 * 2 * 32 * 16 * 8

    def test_peak_of_live_intermediates(self):
        """Two live (64, 64) f32 intermediates at most (a is freed before
        the third product), and the 4-byte sum beside them."""
        x = _meta(64, 64)

        def g(x):
            a = x @ x
            b = a @ x
            del a
            return (b @ x).sum()

        _, c = analyze_step(g, x)
        assert c.peak_bytes == 2 * 64 * 64 * 4 + 4


class TestCollectiveCounts:
    """Like TestCollectiveParser: each collective counts its output."""

    def test_all_reduce_and_all_gather(self):
        from torch.distributed import _functional_collectives as funcol
        from repro_torch.launch.mesh import fake_mesh
        with fake_mesh((4,), ("x",)) as mesh:
            gather = getattr(funcol, "all_gather_single",
                             funcol.all_gather_tensor)

            def g(a, b):
                return (funcol.wait_tensor(funcol.all_reduce(a, "sum",
                                                             (mesh, 0))),
                        funcol.wait_tensor(gather(b, 0, (mesh, 0))))

            _, c = analyze_step(g, torch.zeros(16, 16),
                                torch.zeros(2, 128, dtype=torch.bfloat16))
        assert c.collective_breakdown["all-reduce"] == 16 * 16 * 4
        assert c.collective_breakdown["all-gather"] == 8 * 128 * 2
        assert c.collective_breakdown["all-to-all"] == 0
        assert c.collective_bytes == 16 * 16 * 4 + 8 * 128 * 2

    def test_dtensor_redistribution_is_rank_local(self):
        """A Shard -> Replicate move of a (64, 32) f32 DTensor over 4
        ranks is one all-gather of the whole tensor; the matmul after it
        counts this rank's shard of the rows only."""
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.launch.mesh import fake_mesh
        with fake_mesh((4,), ("x",)) as mesh:
            a = distribute_tensor(_meta(64, 32), mesh, [Shard(1)])
            w = distribute_tensor(_meta(32, 8), mesh, [Replicate()])
            x = distribute_tensor(_meta(64, 32), mesh, [Shard(0)])

            def g(a, w, x):
                return a.redistribute(placements=[Replicate()]), x @ w

            _, c = analyze_step(g, a, w, x)
        assert c.collective_breakdown["all-gather"] == 64 * 32 * 4
        assert c.dot_flops == 2 * 16 * 32 * 8


def test_model_forward_matches_workload_estimate():
    """Reduced stablelm-1.6b's f32 forward, counted on the meta device,
    within 2x of the analytic workload model (the reference's bar); the
    ratio to the reference's compiled count is printed."""
    from repro.configs import get_config as jax_get_config
    from repro.models import build_model as jax_build_model
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    cfg = get_config("stablelm-1.6b").reduced()
    m = build_model(cfg, fmt="float32", device="meta")
    params = m.abstract_params()
    B, S = 2, 64
    tokens = torch.empty((B, S), dtype=torch.int32, device="meta")

    def fwd(p, t):
        h, _ = m.forward_train(p, {"tokens": t})
        return m.logits(p, h)

    with torch.no_grad():
        logits, c = analyze_step(fwd, params, tokens)
    assert logits.shape == (B, S, cfg.vocab_size)
    est = W.prefill_workload(cfg, B, S).flops
    assert est / 2 < c.dot_flops < est * 2
    L = cfg.num_layers
    # attention through flash, and the norms, RoPE and gated activation
    # through the fused kernels' records (2 norms a layer and the final)
    assert c.kernels == {"flash_attention": L, "rms_norm": 2 * L + 1,
                         "rope_qk": L, "silu_mul": L}

    jm = jax_build_model(jax_get_config("stablelm-1.6b").reduced(),
                         fmt="float32")
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))

    def jfwd(p, b):
        h, _ = jm.forward_train(p, b)
        return jm.logits(p, h)

    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    hlo = analyze_hlo(jax.jit(jfwd).lower(jp, batch).compile().as_text())
    print(f"dot FLOPs: port {c.dot_flops:.6g}, reference {hlo.dot_flops:.6g}"
          f" (ratio {c.dot_flops / hlo.dot_flops:.4f}), estimate {est:.6g}")
