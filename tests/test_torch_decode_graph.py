"""The served decode step as a replayed CUDA graph (the port's counterpart
of the reference's ``jax.jit(model.decode_step)``).

On the CPU: ``Model.decode_step`` keeps the storage of every cache tensor
(``pos`` too) over several steps in every family, a prefill cache's
``pos`` owns its storage, the launch-count bookkeeping of
``cuda_build.counted`` and ``serving.backend.DecodeGraph``, and the
executed backend's ``slot_tokens`` is one tensor over a served run whose
tokens equal the JAX engine's. The cases marked ``gpu`` replay the graph
on the card against the eager step, bit for bit, with the launch counts;
they import no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_decode_graph.py
"""
import contextlib
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import cuda_build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.fused import kernel as FU  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as PK  # noqa: E402
from repro_torch.kernels.quant_matmul import kernel as QK  # noqa: E402
from repro_torch.launch.serve import arch_config, build_params, serve  # noqa: E402,E501
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import backend as backend_mod  # noqa: E402
from repro_torch.serving.backend import DecodeGraph, ExecutedBackend  # noqa: E402,E501

KERNELS = (QK, FK, PK, FU)

#: (arch, fmt, kv_quant), reduced: dense in bf16 and int8, an int8 KV
#: cache, a sliding window, MoE, SSM and hybrid
FAMILY_CASES = [
    ("llama-3.1-8b", "bfloat16", False),
    ("llama-3.1-8b", "int8", False),
    ("llama-3.1-8b", "bfloat16", True),
    ("h2o-danube-3-4b", "bfloat16", False),
    ("granite-moe-1b-a400m", "bfloat16", False),
    ("mamba2-2.7b", "bfloat16", False),
    ("zamba2-1.2b", "bfloat16", False),
]
STEPS = 3
PROMPT_LENS = (9, 5)


@functools.lru_cache(maxsize=None)
def _model(arch, fmt, kv_quant, device="cpu"):
    """A reduced model and its seeded weights (a decode step leaves both
    as they are, so the tests share them)."""
    cfg = arch_config(arch).reduced()
    model = build_model(cfg, fmt=fmt, kv_quant=kv_quant, device=device)
    return model, build_params(model, seed=0)


def _prefill(model, params, device="cpu"):
    """Two right-padded prompts into a ring of 32; returns (the caller's
    lengths, the cache)."""
    gen = torch.Generator(device=device).manual_seed(1)
    toks = torch.randint(0, model.cfg.vocab_size, (2, max(PROMPT_LENS)),
                         generator=gen, device=device)
    lengths = torch.tensor(PROMPT_LENS, dtype=torch.int32, device=device)
    _, cache = model.prefill(params, {"tokens": toks}, buf_len=32,
                             lengths=lengths)
    return lengths, cache


def _storage(cache):
    return {k: (v, v.data_ptr()) for k, v in cache.items()}


@pytest.mark.parametrize("arch,fmt,kv_quant", FAMILY_CASES)
def test_decode_step_keeps_cache_storage(arch, fmt, kv_quant):
    """Over STEPS decode steps, from a prefill cache and from an empty
    one, every cache tensor stays the same tensor at the same address,
    and ``pos`` advances by one a step in place."""
    model, params = _model(arch, fmt, kv_quant)
    lengths, cache = _prefill(model, params)
    empty = model.init_cache(2, 16)
    with torch.no_grad():
        for c, start in ((cache, lengths.clone()),
                         (empty, torch.zeros(2, dtype=torch.int32))):
            before = _storage(c)
            tok = torch.zeros((2, 1), dtype=torch.long)
            for _ in range(STEPS):
                logits, out = model.decode_step(params, tok, c)
                assert out is c
                tok = logits.argmax(-1)[:, None]
            assert c.keys() == before.keys()
            for k, (t, ptr) in before.items():
                assert c[k] is t and c[k].data_ptr() == ptr, k
            assert torch.equal(c["pos"], start + STEPS)


@pytest.mark.parametrize("arch,fmt,kv_quant", FAMILY_CASES)
def test_decode_leaves_prefill_lengths(arch, fmt, kv_quant):
    """A prefill cache's ``pos`` owns its storage: decode steps advance it
    and leave the caller's int32 ``lengths`` as they were."""
    model, params = _model(arch, fmt, kv_quant)
    lengths, cache = _prefill(model, params)
    assert cache["pos"].data_ptr() != lengths.data_ptr()
    with torch.no_grad():
        for _ in range(STEPS):
            model.decode_step(params, torch.zeros((2, 1), dtype=torch.long),
                              cache)
    assert lengths.tolist() == list(PROMPT_LENS)


def test_counted_takes_back_and_adds():
    """``cuda_build.counted`` returns what a stretch added to every
    registered count and leaves the counts as they were before it;
    ``add_counted`` adds it again."""
    for m in KERNELS:
        m.reset_launches()
    PK.LAUNCHES["paged_attention"] = 3

    def work():
        PK.LAUNCHES["paged_attention"] += 2
        PK.CASES["slot_positions"] += 2
        QK.LOOP_LAUNCHES["int8_matmul"]["decode"] += 7
        return "out"

    out, added = cuda_build.counted(work)
    assert out == "out"
    assert PK.LAUNCHES["paged_attention"] == 3
    assert PK.CASES["slot_positions"] == 0
    assert QK.LOOP_LAUNCHES["int8_matmul"]["decode"] == 0
    for _ in range(2):
        cuda_build.add_counted(added)
    assert PK.LAUNCHES["paged_attention"] == 7
    assert PK.CASES == {"int8_pages": 0, "slot_positions": 4}
    assert QK.LOOP_LAUNCHES["int8_matmul"] == {"decode": 14, "wgmma": 0,
                                               "tile": 0}
    assert QK.LAUNCHES["int8_matmul"] == 0 and FK.LAUNCHES[FK.NAME] == 0
    with pytest.raises(ValueError):
        cuda_build.counted(lambda: (work(), int("x")))
    assert PK.LAUNCHES["paged_attention"] == 7
    for m in KERNELS:
        m.reset_launches()


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU: a replay runs
    nothing, as a real one runs no Python."""

    made = []

    def __init__(self, keep_graph=False):
        assert keep_graph
        self.replays = 0
        self.instantiated = False
        _FakeGraph.made.append(self)

    def instantiate(self):
        self.instantiated = True

    def replay(self):
        assert self.instantiated
        self.replays += 1


#: whether a fake capture is open
_CAPTURING = []


@contextlib.contextmanager
def _fake_capture(graph):
    _CAPTURING.append(graph)
    try:
        yield
    finally:
        _CAPTURING.pop()


def test_decode_graph_counts_the_steps_that_ran(monkeypatch):
    """DecodeGraph: the first call runs the step eagerly, the second
    captures it (its launches taken back) and replays it, every later
    call replays; the counts end at one step's launches a call. A step
    that fails while it is captured raises, and the counts stay those of
    the steps that ran."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _fake_capture)
    _FakeGraph.made.clear()
    PK.reset_launches()
    calls = []

    def step():
        calls.append(1)
        PK.LAUNCHES["paged_attention"] += 2
        return torch.full((2,), float(len(calls)))

    g = DecodeGraph(step)
    for n in range(1, 6):
        out = g()
        assert PK.LAUNCHES["paged_attention"] == 2 * n
    assert len(calls) == 2              # the eager step and the capture
    assert g.replays == 4 and _FakeGraph.made[0].replays == 4
    assert out is g.logits and out.tolist() == [2.0, 2.0]

    def failing():
        PK.LAUNCHES["paged_attention"] += 2
        if _CAPTURING:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return torch.zeros(2)

    PK.reset_launches()
    g = DecodeGraph(failing)
    g()
    with pytest.raises(RuntimeError, match="capturing"):
        g()
    assert g.graph is None and PK.LAUNCHES["paged_attention"] == 2
    PK.reset_launches()


def test_cpu_backend_runs_the_step_eagerly():
    """On the CPU the backend has no graph and steps eagerly."""
    model, params = _model("llama-3.1-8b", "float32", False)
    be = ExecutedBackend(model.cfg, model, params, max_batch=2, buf_len=16)
    assert be.decode_graph is None
    assert backend_mod.DecodeGraph is DecodeGraph


class _Watched(ExecutedBackend):
    """The executed backend recording, at every decode step, its slot
    tokens' and cache's tensors and addresses."""

    def start(self):
        super().start()
        self.seen = []

    def _execute_decode(self, batch):
        super()._execute_decode(batch)
        self.seen.append((self.slot_tokens, self.slot_tokens.data_ptr(),
                          _storage(self.cache)))


def test_served_slot_tokens_one_tensor_tokens_match_jax(tmp_path):
    """float32 reduced llama, 6 requests of mixed lengths over 4 lanes
    (tests/test_torch_serving.py's run): ``slot_tokens`` and every cache
    tensor stay one tensor at one address over the served run, and every
    request gets the JAX engine's greedy tokens."""
    jax = pytest.importorskip("jax")
    from repro.batching.policy import SlotCountPolicy
    from repro.models import build_model as jax_build_model
    from repro.serving import Request as JaxRequest
    from repro.serving import ServeEngine as JaxServeEngine
    from repro_torch.batching.policy import SlotCountPolicy as PtPolicy
    from repro_torch.serving import Request, ServeEngine
    from _torch_parity import carry_params

    cfg = arch_config("llama-3.1-8b").reduced()
    jm = jax_build_model(cfg, fmt="float32")
    jparams = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, rng.integers(4, 12))
               .astype(np.int32) for _ in range(6)]
    new = (5, 3, 7, 5, 1, 6)

    def reqs(cls):
        return [cls(req_id=i, prompt=p, prompt_len=len(p),
                    max_new_tokens=new[i], arrival_time=0.0)
                for i, p in enumerate(prompts)]

    jreqs = reqs(JaxRequest)
    JaxServeEngine(cfg, mode="continuous", execute=True, model=jm,
                   params=jparams, buf_len=32,
                   batch_policy=SlotCountPolicy(max_batch=4,
                                                max_prefill_batch=2)
                   ).run(jreqs)
    tparams = carry_params(jparams, tmp_path)
    tm = build_model(cfg, fmt="float32", device="cpu")
    be = _Watched(cfg, tm, tparams, max_batch=4, buf_len=32)
    treqs = reqs(Request)
    ServeEngine(cfg, mode="continuous", execute=True, model=tm,
                params=tparams, buf_len=32, backend=be,
                batch_policy=PtPolicy(max_batch=4, max_prefill_batch=2)
                ).run(treqs)
    assert len(be.seen) >= 6
    first = be.seen[0]
    for toks, ptr, storage in be.seen:
        assert toks is first[0] and ptr == first[1]
        assert {k: (id(t), p) for k, (t, p) in storage.items()} \
            == {k: (id(t), p) for k, (t, p) in first[2].items()}
    for a, b in zip(treqs, jreqs):
        assert a.generated == b.generated, a.req_id


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
#: (arch, fmt, kv_quant): llama in the five formats and with an int8 KV
#: cache, and each other family
GPU_CASES = ([("llama-3.1-8b", f, False) for f in
              ("float32", "float16", "bfloat16", "int8", "nf4")]
             + [("llama-3.1-8b", "bfloat16", True),
                ("h2o-danube-3-4b", "bfloat16", False),
                ("qwen3-moe-30b-a3b", "int8", False),
                ("granite-moe-1b-a400m", "nf4", False),
                ("phi-3-vision-4.2b", "bfloat16", False),
                ("mamba2-2.7b", "bfloat16", False),
                ("zamba2-1.2b", "int8", False)])
GPU_STEPS = 4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _counts():
    return ({n: c for m in KERNELS for n, c in m.LAUNCHES.items()},
            dict(PK.CASES),
            {n: dict(c) for n, c in QK.LOOP_LAUNCHES.items()})


def _served(arch, fmt, kv_quant):
    """A reduced model on the card and its backend after a served run of
    four one-token requests: every lane holds a prefilled cache and the
    decode graph is still to run its first step."""
    model, params = _model(arch, fmt, kv_quant, device="cuda")
    res = serve(model=model, params=params, mode="continuous", n=4,
                max_batch=4, max_prefill_batch=4, buf_len=64,
                prompt_len=(8, 24), new_tokens=(1, 1), seed=0)
    be = res.engine.backend
    assert be.decode_graph is not None and be.decode_graph.logits is None
    return model, params, be


@pytest.mark.gpu
@pytest.mark.parametrize("arch,fmt,kv_quant", GPU_CASES)
def test_cuda_graph_matches_eager(arch, fmt, kv_quant):
    """On the card, GPU_STEPS steps of the backend (eager, then captured
    and replayed, then replayed) each against ``Model.decode_step`` run
    eagerly on a copy of the same cache and tokens: the logits, the next
    feed tokens and the whole cache bit for bit, and each step's launch
    counts (launches, paged cases, quant loops) equal the eager step's."""
    _card()
    model, params, be = _served(arch, fmt, kv_quant)
    g = be.decode_graph
    with torch.no_grad():
        for step in range(GPU_STEPS):
            twin = {k: v.clone() for k, v in be.cache.items()}
            toks = be.slot_tokens.clone()
            for m in KERNELS:
                m.reset_launches()
            ref, _ = model.decode_step(params, toks, twin)
            eager = _counts()
            for m in KERNELS:
                m.reset_launches()
            got = g()
            torch.cuda.synchronize()
            assert _counts() == eager, step
            assert torch.equal(got, ref), step
            assert torch.equal(be.slot_tokens[:, 0], ref.argmax(-1)), step
            for k in twin:
                assert torch.equal(be.cache[k], twin[k]), (step, k)
    assert g.graph is not None and g.replays == GPU_STEPS - 1
    assert eager[0]["paged_attention"] == (
        0 if model.cfg.family == "ssm" else
        model.cfg.num_layers // (model.cfg.attn_period or 1)
        if model.cfg.family == "hybrid" else model.cfg.num_layers)


@pytest.mark.gpu
def test_cuda_graph_recaptured_after_start():
    """On the card: ``start()`` makes a new cache and drops the graph; the
    new cache's first step is eager and its second captures anew."""
    _card()
    model, params, be = _served("llama-3.1-8b", "int8", False)
    g = be.decode_graph
    g()
    g()
    assert g.graph is not None
    old = be.cache
    be.start()
    g2 = be.decode_graph
    assert g2 is not g and g2.graph is None and be.cache is not old
    g2()
    assert g2.graph is None
    g2()
    assert g2.graph is not None and g2.graph is not g.graph
    assert g2.replays == 1


@pytest.mark.gpu
def test_cuda_failed_capture_raises(monkeypatch):
    """On the card: a step that reads a value on the host cannot be
    captured; the backend raises and does not carry on eagerly."""
    _card()
    model, params, be = _served("llama-3.1-8b", "bfloat16", False)
    step = model.decode_step

    def syncing(params_, tokens, cache):
        logits, cache = step(params_, tokens, cache)
        float(logits[0, 0])          # a device-to-host read
        return logits, cache

    monkeypatch.setattr(model, "decode_step", syncing)
    batch = types.SimpleNamespace(slots=[], requests=[])
    be._execute_decode(batch)        # the eager first step
    with pytest.raises(RuntimeError):
        be._execute_decode(batch)
    assert be.decode_graph.graph is None
    torch.cuda.synchronize()
