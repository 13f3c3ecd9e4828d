"""The port's arrival generators and request samplers
(repro_torch.serving.arrival, repro_torch.training.data) against the JAX
package's, on the same seeds: every arrival list, every sampled length,
every prompt id and every synthetic batch equal (numpy on both sides)."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.serving import arrival as jax_arrival  # noqa: E402
from repro.training import data as jax_data  # noqa: E402

from repro_torch.serving import arrival as pt_arrival  # noqa: E402
from repro_torch.training import data as pt_data  # noqa: E402

# (function name, args, kwargs)
CASES = [
    ("fixed_arrivals", (40, 0.05), {}),
    ("fixed_arrivals", (7, 0.3), {"start": 2.5}),
    ("uniform_random_arrivals", (60, 0.01, 0.2), {"seed": 3}),
    ("uniform_random_arrivals", (25, 0.0, 0.1), {"seed": 9, "start": 1.0}),
    ("poisson_arrivals", (80, 8.0), {"seed": 0}),
    ("poisson_arrivals", (33, 20.0), {"seed": 5, "start": 0.25}),
    ("burst_arrivals", (50, 7, 0.5), {}),
    ("burst_arrivals", (9, 4, 2.0), {"start": 3.0}),
    ("diurnal_arrivals", (500, 0.05), {"seed": 1}),
    ("diurnal_arrivals", (400, 0.02), {"amp_frac": 0.3, "phase_h": 6.0,
                                       "bursts_per_day": 4.0,
                                       "burst_size": 16, "seed": 2}),
    ("diurnal_arrivals", (0, 1.0), {}),
]


@pytest.mark.parametrize("name,args,kw", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_arrivals_equal_reference(name, args, kw):
    got = getattr(pt_arrival, name)(*args, **kw)
    want = getattr(jax_arrival, name)(*args, **kw)
    assert len(got) == len(want)
    np.testing.assert_array_equal(np.asarray(got, np.float64),
                                  np.asarray(want, np.float64))


@pytest.mark.parametrize("kw", [dict(base_rate_per_s=0.0),
                                dict(base_rate_per_s=1.0, amp_frac=1.0)])
def test_diurnal_refuses_what_the_reference_refuses(kw):
    with pytest.raises(ValueError):
        jax_arrival.diurnal_arrivals(10, **kw)
    with pytest.raises(ValueError):
        pt_arrival.diurnal_arrivals(10, **kw)


def _fields(reqs):
    return [(r.req_id, r.prompt_len, r.max_new_tokens, r.arrival_time,
             None if r.prompt is None else r.prompt.tolist())
            for r in reqs]


@pytest.mark.parametrize("vocab_size", [None, 1000, 128256])
@pytest.mark.parametrize("seed,ranges", [
    (0, {}), (4, dict(prompt_range=(200, 4000), output_range=(10, 64))),
    (11, dict(prompt_range=[16, 48], output_range=[2, 6]))])
def test_paper_requests_equal_reference(seed, ranges, vocab_size):
    """Lengths from RequestDistribution(seed), prompt ids (when a
    vocabulary is given) from default_rng(seed + 1), without moving the
    length stream: a simulated and an executed run of one seed see the
    same shapes."""
    arrivals = pt_arrival.poisson_arrivals(20, 5.0, seed=seed)
    got = pt_arrival.paper_requests(20, arrivals, seed=seed,
                                    vocab_size=vocab_size, **ranges)
    want = jax_arrival.paper_requests(20, arrivals, seed=seed,
                                      vocab_size=vocab_size, **ranges)
    assert _fields(got) == _fields(want)
    sim = pt_arrival.paper_requests(20, arrivals, seed=seed, **ranges)
    assert [r.prompt_len for r in sim] == [r.prompt_len for r in got]
    if vocab_size is not None:
        assert all(r.prompt.dtype == np.int32 for r in got)
        assert all(0 <= r.prompt.min() and r.prompt.max() < vocab_size
                   for r in got)


@pytest.mark.parametrize("seed", [0, 3])
def test_request_distribution_equals_reference(seed):
    got = pt_data.RequestDistribution(seed=seed).sample_n(50)
    want = jax_data.RequestDistribution(seed=seed).sample_n(50)
    assert [(s.prompt_len, s.output_len) for s in got] \
        == [(s.prompt_len, s.output_len) for s in want]


@pytest.mark.parametrize("cfg", [dict(vocab_size=97, seq_len=16,
                                      batch_size=3),
                                 dict(vocab_size=500, seq_len=7,
                                      batch_size=2, seed=5, zipf_a=1.1)])
def test_synthetic_lm_equals_reference(cfg):
    got = pt_data.SyntheticLM(pt_data.DataConfig(**cfg))
    want = jax_data.SyntheticLM(jax_data.DataConfig(**cfg))
    np.testing.assert_array_equal(got.marginal, want.marginal)
    np.testing.assert_array_equal(got.succ, want.succ)
    for a, b in zip(got.batches(4), want.batches(4)):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
