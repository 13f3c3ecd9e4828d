"""The port's batching bookkeeping (repro_torch.batching: the KV page
pool, static padding, the continuous batcher and the four batch
policies) against the JAX package's, driven by the same seeded operation
sequences: every page table, free list, slot set and prefill plan
equal."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.batching import continuous as jax_cont  # noqa: E402
from repro.batching import kvcache as jax_kv  # noqa: E402
from repro.batching import policy as jax_policy  # noqa: E402
from repro.batching import static as jax_static  # noqa: E402
from repro.serving.requests import Request as JaxRequest  # noqa: E402

from repro_torch.batching import continuous as pt_cont  # noqa: E402
from repro_torch.batching import kvcache as pt_kv  # noqa: E402
from repro_torch.batching import policy as pt_policy  # noqa: E402
from repro_torch.batching import static as pt_static  # noqa: E402
from repro_torch.serving.requests import Request  # noqa: E402


# --------------------------------------------------------------------------
# the KV page pool
# --------------------------------------------------------------------------
def _pool_state(kv):
    return (list(kv.free),
            {s: (list(t.pages), t.n_tokens) for s, t in kv.tables.items()},
            {s: (list(t.pages), t.n_tokens)
             for s, t in kv.lingering.items()},
            dict(kv._shared), dict(kv._pins), kv.free_pages,
            kv.used_pages, kv.utilization())


def _kv_ops(kv, seed, n_ops=300):
    """Apply a seeded random operation sequence; return what each
    operation returned (or the exception type it raised) and the pool
    after it."""
    rng = np.random.default_rng(seed)
    log = []
    next_id = 0
    for _ in range(n_ops):
        live = sorted(kv.tables)
        op = rng.integers(0, 10)
        try:
            if op <= 2 or not live:
                out = kv.allocate(next_id, int(rng.integers(0, 200))).pages
                next_id += 1
            elif op == 3:
                out = kv.extend(live[rng.integers(len(live))],
                                int(rng.integers(1, 40))).pages
            elif op == 4:
                ids = list(rng.choice(live, size=min(3, len(live)),
                                      replace=False))
                out = kv.extend_many([int(i) for i in ids],
                                     int(rng.integers(1, 30)))
            elif op == 5:
                out = kv.release(live[rng.integers(len(live))])
            elif op == 6:
                sid = live[rng.integers(len(live))]
                kv.pin(sid, int(rng.integers(0, 3)))
                out = kv.has_seq(sid)
            elif op == 7:
                pool = live + sorted(kv.lingering)
                sid = pool[rng.integers(len(pool))]
                if rng.integers(2):
                    out = kv.unpin(sid)
                else:
                    out = kv.unpin_all(sid)
            elif op == 8:
                pool = live + sorted(kv.lingering)
                parent = pool[rng.integers(len(pool))]
                t = kv.tables.get(parent) or kv.lingering[parent]
                share = kv.page_size * int(rng.integers(0, len(t.pages) + 1))
                out = kv.fork_prefix(parent, next_id, share,
                                     share + int(rng.integers(0, 100)))
                out = out.pages
                next_id += 1
            else:
                ids = [int(i) for i in rng.choice(
                    live, size=min(4, len(live)), replace=False)]
                out = (kv.max_uniform_extend(ids, int(rng.integers(0, 500))),
                       kv.can_allocate(int(rng.integers(0, 300))),
                       kv.page_table_array(ids[0], 40).tolist())
        except (KeyError, ValueError, MemoryError) as e:
            out = type(e).__name__
        kv.check_invariants()
        log.append((int(op), out, _pool_state(kv)))
    return log


@pytest.mark.parametrize("n_pages,page_size", [(64, 16), (200, 8),
                                               (32, 128)])
@pytest.mark.parametrize("seed", range(4))
def test_kv_pool_operation_sequences_equal_reference(seed, n_pages,
                                                     page_size):
    """Allocation, extension (one and many), release, pinning, prefix
    forks, the uniform-extend bound and page-table rows, with the
    refusals (MemoryError, KeyError, ValueError) where the reference
    refuses."""
    got = _kv_ops(pt_kv.PagedKVAllocator(n_pages, page_size), seed)
    want = _kv_ops(jax_kv.PagedKVAllocator(n_pages, page_size), seed)
    assert got == want


def test_max_uniform_extend_is_the_feasibility_edge():
    """Where the pool binds, the bound is the reference's, every sequence
    extends by it, and one token more fails."""
    pools = [mod.PagedKVAllocator(12, 16) for mod in (pt_kv, jax_kv)]
    for kv in pools:
        for sid, n in enumerate((30, 17, 5)):
            kv.allocate(sid, n)
    j, want = (kv.max_uniform_extend([0, 1, 2], 200) for kv in pools)
    assert j == want and 0 < j < 200
    kv = pools[0]
    kv.extend_many([0, 1, 2], j)
    with pytest.raises(MemoryError):
        kv.extend_many([0, 1, 2], 1)


# --------------------------------------------------------------------------
# static padding
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 100, 128, 129, 4096, 4097, 9000])
def test_bucket_length_equals_reference(n):
    assert pt_static.bucket_length(n) == jax_static.bucket_length(n)


@pytest.mark.parametrize("bucket,pad_multiple", [(False, 1), (True, 1),
                                                 (False, 8), (True, 64)])
def test_pad_batch_and_static_batcher_equal_reference(bucket, pad_multiple):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 50, int(rng.integers(1, 300)))
               .astype(np.int32) for _ in range(7)]
    got = pt_static.pad_batch(prompts, bucket=bucket,
                              pad_multiple=pad_multiple)
    want = jax_static.pad_batch(prompts, bucket=bucket,
                                pad_multiple=pad_multiple)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert (got.effective_tokens, got.computed_tokens,
            got.padding_fraction) == (want.effective_tokens,
                                      want.computed_tokens,
                                      want.padding_fraction)
    for a, b in zip(pt_static.StaticBatcher(3, bucket).batches(prompts),
                    jax_static.StaticBatcher(3, bucket).batches(prompts)):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    with pytest.raises(ValueError):
        pt_static.pad_batch([])


# --------------------------------------------------------------------------
# the continuous batcher under each batch policy
# --------------------------------------------------------------------------
POLICIES = [("slot_count", {}), ("slot_count", {"bucket_prefill": False}),
            ("token_budget", {"token_budget": 900}),
            ("length_sorted", {"window": 6, "patience": 2}),
            ("chunked_prefill", {"chunk_tokens": 64})]


def _drive(mods, name, params, seed, n_steps=240):
    """A seeded serving loop without a clock: arrivals join the queue,
    the policy plans each prefill (chunks and adoption included), ready
    slots decode a token, finished slots leave. Returns every plan and
    the batcher's sets and counters after each step."""
    pol_mod, cont_mod, req_cls = mods
    rng = np.random.default_rng(seed)
    pol = pol_mod.make_batch_policy(name, max_batch=4, max_prefill_batch=3,
                                    **params)
    b = cont_mod.ContinuousBatcher(policy=pol, kv_pages=96, page_size=16)
    pending = []
    for i in range(24):
        r = req_cls(req_id=i, prompt=None,
                    prompt_len=int(rng.integers(5, 300)),
                    max_new_tokens=int(rng.integers(1, 16)))
        if rng.random() < 0.15:             # a handed-off request
            r.prefilled_tokens = r.prompt_len
            r.tokens_generated = 1
        pending.append(r)
    log = []
    for step in range(n_steps):
        for _ in range(int(rng.integers(0, 3))):
            if pending:
                b.admit(pending.pop(0))
        can = pol.can_admit(b)
        plan = pol.schedule_prefill(b, float(step))
        if plan is not None and plan.picks:
            log.append(("plan", [(s, r.req_id) for s, r in plan.picks],
                        plan.pad_len, plan.chunk_start, plan.chunk_len,
                        plan.adopt))
            if plan.is_chunk:
                slot, r = plan.picks[0]
                if b.note_chunk(slot, plan.chunk_len):
                    r.tokens_generated = 1
            elif not plan.adopt:
                for slot, r in plan.picks:
                    r.tokens_generated = 1
                    b.complete_prefill(slot)
        elif b.n_ready:
            ready = b.step_decode_bookkeeping()
            for i in ready:
                b.slots[i].request.tokens_generated += 1
            pol.note_decode()
        for i in b.decode_ready_slots():
            r = b.slots[i].request
            if r.tokens_generated >= r.max_new_tokens:
                log.append(("done", i, b.finish(i).req_id))
        log.append((can, b.free_slots(), b.live_slots(),
                    b.decode_ready_slots(), b.partial_slots(), b.n_waiting,
                    b.waiting_tokens, b.live_committed_tokens,
                    b.outstanding_tokens(), pol.outstanding_tokens(b),
                    b.kv.free_pages, pol.decode_horizon_cap(b),
                    [r.req_id for r in b.waiting]))
    return log


PT = (pt_policy, pt_cont, Request)
JAX = (jax_policy, jax_cont, JaxRequest)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("name,params", POLICIES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(POLICIES)])
def test_policy_plans_equal_reference(name, params, seed):
    got = _drive(PT, name, params, seed)
    assert got == _drive(JAX, name, params, seed)
    assert any(e[0] == "plan" for e in got)


def test_policy_registry_and_refusals_match_reference():
    assert pt_policy.BATCH_POLICIES == jax_policy.BATCH_POLICIES
    for name in pt_policy.BATCH_POLICIES:
        pol = pt_policy.make_batch_policy(
            name, **({"token_budget": 10} if name == "token_budget" else {}))
        assert pol.name == name
        assert pol.PARAMS == jax_policy._POLICY_CLASSES[name].PARAMS
    for name, kw in (("nope", {}), ("slot_count", {"chunk_tokens": 4}),
                     ("token_budget", {}), ("slot_count", {"max_batch": 0}),
                     ("chunked_prefill", {"chunk_tokens": 0}),
                     ("length_sorted", {"window": 0})):
        with pytest.raises(ValueError):
            jax_policy.make_batch_policy(name, **kw)
        with pytest.raises(ValueError):
            pt_policy.make_batch_policy(name, **kw)


@pytest.mark.parametrize("mods", [PT, JAX], ids=["port", "reference"])
def test_batcher_direct_entry_points(mods):
    """The legacy ``schedule_prefill``, waiting-queue eviction and
    removal, and slot lookup, on both packages alike."""
    _, cont, req_cls = mods
    b = cont.ContinuousBatcher(2, kv_pages=64, page_size=16,
                               max_prefill_batch=2)
    reqs = [req_cls(req_id=i, prompt=None, prompt_len=20 + i,
                    max_new_tokens=3) for i in range(5)]
    for r in reqs:
        b.admit(r)
    picks = b.schedule_prefill()
    assert [(s, r.req_id) for s, r in picks] == [(0, 0), (1, 1)]
    assert b.decode_ready_slots() == [0, 1] and b.n_waiting == 3
    assert b.find_slot(reqs[1]) == 1 and b.find_slot(reqs[3]) is None
    assert b.remove_waiting(reqs[3]) and not b.remove_waiting(reqs[3])
    assert [r.req_id for r in b.evict_waiting()] == [2, 4]
    assert b.n_waiting == 0 and b.waiting_tokens == 0
    assert b.finish(0).req_id == 0 and b.free_slots() == [0]
    with pytest.raises(ValueError):
        cont.ContinuousBatcher(4, policy=pt_policy.SlotCountPolicy(
            max_batch=2) if cont is pt_cont
            else jax_policy.SlotCountPolicy(max_batch=2))
