"""The serving path of the vlm, SSM and hybrid families against the JAX
package: reduced mamba2-2.7b, zamba2-1.2b and phi-3-vision-4.2b (text
only, as the reference serves it) through the port's ServeEngine against
the reference ServeEngine(execute=True) on the same weights and
requests; and the audio family, which neither package serves."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.batching.policy import SlotCountPolicy  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServeEngine as JaxServeEngine  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import Request, ServeEngine  # noqa: E402
from repro_torch.serving.backend import ExecutedBackend  # noqa: E402

from _torch_parity import carry_params  # noqa: E402

# ---------------------------------------------------------------------------
SERVED = ("mamba2-2.7b", "zamba2-1.2b", "phi-3-vision-4.2b")
# as tests/test_torch_energy.py
REPORT_FIELDS = ("total_energy_j", "busy_energy_j", "idle_energy_j",
                 "wall_time_s", "busy_time_s", "mean_batch",
                 "n_prefill_batches", "n_decode_steps", "gated_energy_j",
                 "gated_time_s", "idle_time_s", "prefill_computed_tokens",
                 "prefill_effective_tokens", "mean_energy_per_request_wh",
                 "mean_attributed_energy_wh", "mean_latency_s",
                 "mean_ttft_s", "tokens_per_s", "mean_energy_per_token_wh")
REQUEST_FIELDS = ("energy_j", "t_prefill_start", "t_first_token", "t_done",
                  "tokens_generated", "prefilled_tokens")


def _reqs(cls, vocab, n=6):
    rng = np.random.default_rng(7)
    out = []
    for i in range(n):
        n = int(rng.integers(4, 40))
        out.append(cls(req_id=i, prompt=rng.integers(0, vocab, n)
                       .astype(np.int32), prompt_len=n,
                       max_new_tokens=int(rng.integers(1, 6)),
                       arrival_time=0.0))
    return out


def _engines(arch, fmt, mode, tmp_path):
    jcfg = jax_get_config(arch).reduced()
    jm = jax_build_model(jcfg, fmt=fmt)
    jparams = jm.init(jax.random.PRNGKey(1))
    want = JaxServeEngine(jcfg, fmt=fmt, mode=mode, execute=True, model=jm,
                          params=jparams, buf_len=64,
                          batch_policy=SlotCountPolicy(max_batch=4,
                                                       max_prefill_batch=2))
    got = ServeEngine(build_model(get_config(arch).reduced(), fmt=fmt,
                                  device="cpu"),
                      carry_params(jparams, tmp_path), mode=mode,
                      max_batch=4, max_prefill_batch=2, buf_len=64, fmt=fmt)
    return want, got


@pytest.mark.parametrize("fmt,mode", [("float32", "continuous"),
                                      ("float32", "sequential"),
                                      ("bfloat16", "continuous")])
@pytest.mark.parametrize("arch", SERVED)
def test_serve_report_matches_reference_engine(arch, fmt, mode, tmp_path):
    """6 requests at t=0 (4 in sequential mode), max_batch=4,
    max_prefill_batch=2, buf_len=64: every report field, each request's
    energy and times and summary() equal the reference
    ServeEngine(execute=True)'s float for float; float32 greedy tokens
    are identical. The reference's sequential mode runs its model
    eagerly, compiling each request's prefill anew, the slowest part of
    this file: hence 4 requests there (each runs alone, so more would add
    no case), and bf16 in the continuous mode only (the report is
    analytic and the same in every format)."""
    want_eng, eng = _engines(arch, fmt, mode, tmp_path)
    vocab = eng.backend.model.cfg.vocab_size
    n = 4 if mode == "sequential" else 6
    want = want_eng.run(_reqs(JaxRequest, vocab, n))
    got = eng.run(_reqs(Request, vocab, n))
    for name in REPORT_FIELDS:
        assert getattr(got, name) == getattr(want, name), name
    assert got.summary() == want.summary()
    for a, b in zip(got.requests, want.requests):
        for name in REQUEST_FIELDS:
            assert getattr(a, name) == getattr(b, name), (a.req_id, name)
        assert len(a.generated) == a.max_new_tokens
        assert all(0 <= t < vocab for t in a.generated)
        if fmt == "float32":
            assert a.generated == b.generated, a.req_id
    assert eng.backend.prefill_aux == []


def test_audio_is_refused_by_both_serving_paths(tmp_path):
    """Neither package serves the audio family: the reference's backend
    passes only tokens to a prefill that reads frames (KeyError: 'frames',
    ROADMAP C4); the port's refuses the model when it is built, naming
    the missing frames."""
    arch = "seamless-m4t-large-v2"
    jcfg = jax_get_config(arch).reduced()
    jm = jax_build_model(jcfg, fmt="float32")
    want = JaxServeEngine(jcfg, fmt="float32", execute=True, model=jm,
                          params=jm.init(jax.random.PRNGKey(1)), buf_len=64,
                          batch_policy=SlotCountPolicy(max_batch=2))
    with pytest.raises(KeyError, match="frames"):
        want.run(_reqs(JaxRequest, jcfg.vocab_size))
    model = build_model(get_config(arch).reduced(), fmt="float32",
                        device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="no frames"):
        ExecutedBackend(model, params, max_batch=2)
    with pytest.raises(ValueError, match="no frames"):
        ServeEngine(model, params, max_batch=2)
