"""The attention kernels on the port's model path: prefill goes through
flash attention and decode through paged attention over the ring cache
viewed as pages (repro_torch.models.layers.ring_cache_pages). The view
selects exactly the slots the reference's decode mask allows, in every
state the serving path produces; windowed models, int8-KV models and a
cache built by a prefill padded past its ring decode through the same
paged call, its position test (slot_pos, pos, window) dropping the slots
of the view the mask refuses."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs.paper_zoo import PAPER_MODELS  # noqa: E402
from repro_torch.launch.serve import build_params, serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as pl  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

CFG = PAPER_MODELS["llama-3.1-8b"].reduced()


@pytest.mark.parametrize("W,page", [(512, 64), (96, 32), (48, 16), (24, 8),
                                    (261, 261), (7, 7)])
def test_ring_page_size(W, page):
    assert pl.ring_page_size(W) == page


def test_ring_cache_pages_is_a_view():
    k = torch.randn((3, 2, 48, 2, 16))          # (L, B, W, Kv, hd)
    v = torch.randn_like(k)
    pos = torch.tensor([5, 60], dtype=torch.int32)
    kp, vp, table, lens = pl.ring_cache_pages(k, v, pos)
    assert kp.shape == (3, 6, 16, 2, 16)
    assert kp.data_ptr() == k.data_ptr() and vp.data_ptr() == v.data_ptr()
    assert table.dtype == lens.dtype == torch.int32
    assert table.tolist() == [[0, 1, 2], [3, 4, 5]]
    assert lens.tolist() == [6, 48]
    # row 1's page 2 is ring slots 32..47 of row 1
    assert torch.equal(kp[1][table[1, 2]], k[1, 1, 32:48])


def _view_mask(pos, W):
    return torch.arange(W)[None, :] < torch.clamp(pos + 1, max=W)[:, None]


@pytest.mark.parametrize("mode", ["continuous", "sequential"])
def test_page_view_selects_the_decode_mask_on_the_serve_path(monkeypatch,
                                                             mode):
    """Serve 9 requests with a 16-slot ring: padded prefill rows (pad
    slots -1), lanes released and reused, rows that wrap the ring. Before
    every decode step the slots the page view selects equal the slots
    decode_attention_mask allows once this step's slot is written."""
    states = {"steps": 0, "wrapped": 0, "pad_slots": 0}
    inner = tfm.decoder_decode_step

    def checking_step(layers, x, cache, cfg, policy, *, window=None):
        pos, W = cache["pos"], cache["slot_pos"].shape[1]
        slot_pos = cache["slot_pos"].clone()
        slot_pos[torch.arange(pos.shape[0]), pos.long() % W] = pos
        want = pl.decode_attention_mask(slot_pos, pos, window)
        assert torch.equal(_view_mask(pos, W), want), (pos, slot_pos)
        states["steps"] += 1
        states["wrapped"] += int((pos >= W).any())
        states["pad_slots"] += int((slot_pos < 0).any())
        return inner(layers, x, cache, cfg, policy, window=window)

    monkeypatch.setattr(tfm, "decoder_decode_step", checking_step)
    res = serve(n=9, max_batch=3, max_prefill_batch=2, buf_len=16,
                prompt_len=(3, 11), new_tokens=(6, 14), device="cpu",
                mode=mode, seed=4)
    assert all(len(r.generated) == r.max_new_tokens for r in res.requests)
    assert states["steps"] > 0
    if mode == "continuous":
        assert states["wrapped"] and states["pad_slots"]


def _count_calls(monkeypatch):
    """Calls of the flash, paged and masked attention from the model:
    the masked one wherever the decoder could reach it (the layers
    module's, and a name bound in the transformer module)."""
    calls = {"flash": 0, "paged": 0, "masked": 0}
    flash, paged = tfm.flash_attention, tfm.paged_attention
    masked = pl.attention

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tfm, "flash_attention", count("flash", flash))
    monkeypatch.setattr(tfm, "paged_attention", count("paged", paged))
    monkeypatch.setattr(pl, "attention", count("masked", masked))
    monkeypatch.setattr(tfm, "attention", count("masked", masked),
                        raising=False)
    return calls


def _prefill_and_decode(model, steps=3):
    params = build_params(model, seed=0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, CFG.vocab_size, (2, 10)))
    logits, cache = model.prefill(params, {"tokens": toks}, buf_len=24,
                                  lengths=torch.tensor([10, 7]))
    yield "prefill"
    for _ in range(steps):
        tok = torch.argmax(logits, -1)[:, None]
        logits, cache = model.decode_step(params, tok, cache)
        assert torch.isfinite(logits).all()
        yield "decode"


@pytest.mark.parametrize("fmt", ["float32", "bfloat16"])
def test_prefill_and_decode_go_through_the_kernels(monkeypatch, fmt):
    """Reduced llama-3.1-8b (2 layers): one flash call per layer per
    prefill, one paged call per layer per decode step, and no masked
    attention."""
    calls = _count_calls(monkeypatch)
    model = build_model(CFG, fmt=fmt, device="cpu")
    for phase in _prefill_and_decode(model):
        want = {"prefill": {"flash": 2, "paged": 0, "masked": 0},
                "decode": {"flash": 0, "paged": 2, "masked": 0}}[phase]
        assert calls == want, phase
        calls.update(flash=0, paged=0, masked=0)


@pytest.mark.parametrize("kw", [dict(window_override=6),
                                dict(kv_quant=True)])
def test_windowed_and_int8_kv_models_decode_through_the_paged_kernel(
        monkeypatch, kw):
    """Windowed models and int8 caches (which hold codes) decode through
    one paged call a layer (int8 pages with their scales, the window in
    its position test) and no masked attention; prefill runs flash
    attention (with the window)."""
    calls = _count_calls(monkeypatch)
    model = build_model(CFG, fmt="float32", device="cpu", **kw)
    for phase in _prefill_and_decode(model):
        want = {"prefill": {"flash": 2, "paged": 0, "masked": 0},
                "decode": {"flash": 0, "paged": 2, "masked": 0}}[phase]
        assert calls == want, phase
        calls.update(flash=0, paged=0, masked=0)


@pytest.mark.parametrize("lengths", [[12, 9], [12, 12]])
def test_prefill_past_the_ring_decodes_as_the_reference(monkeypatch, lengths,
                                                        tmp_path):
    """A prefill padded past its ring (S = 12 > buf_len = 8) keeps the
    last 8 padded positions, so a shorter row keeps -1 pad slots inside
    the ring that min(pos + 1, W) selects. The paged call's position test
    drops them: f32 greedy tokens and logits match the JAX model over 6
    steps (logits within 1e-4), with no masked attention."""
    import jax
    import jax.numpy as jnp
    from repro.models import build_model as jax_build_model
    from _torch_parity import carry_params, to_numpy

    calls = _count_calls(monkeypatch)
    jm = jax_build_model(CFG, fmt="float32")
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(CFG, fmt="float32", device="cpu")
    tp = carry_params(jp, tmp_path)
    lens = np.array(lengths, np.int32)
    toks = np.random.default_rng(5).integers(
        0, CFG.vocab_size, (2, 12)).astype(np.int32)
    jlog, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, buf_len=8,
                          lengths=jnp.asarray(lens))
    tlog, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, buf_len=8,
                          lengths=torch.from_numpy(lens))
    # a shorter row keeps pad slots inside the ring
    assert bool((tc["slot_pos"] < 0).any()) == (min(lengths) < 12)
    step = jax.jit(jm.decode_step)
    for i in range(7):
        jlog, tlog = np.asarray(jlog), to_numpy(tlog)
        np.testing.assert_array_equal(tlog.argmax(-1), jlog.argmax(-1))
        np.testing.assert_allclose(tlog, jlog, rtol=1e-4, atol=1e-4,
                                   err_msg=f"step {i}")
        if i == 6:
            break
        tok = jlog.argmax(-1)[:, None].astype(np.int32)
        jlog, jc = step(jp, jnp.asarray(tok), jc)
        tlog, tc = tm.decode_step(tp, torch.from_numpy(tok), tc)
    assert calls["paged"] == 6 * CFG.num_layers and calls["masked"] == 0


def test_inserting_a_prefill_past_the_ring_decodes_as_its_own_cache(
        monkeypatch):
    """The serving backend's decode cache, given a row of a prefill padded
    past the ring (pad slots -1 inside the ring) and, after eviction of
    another lane, decoding through the paged kernel: that lane's logits
    equal the same step over the prefill's own cache, bit for bit (f32),
    one paged call a layer and no masked attention."""
    from repro_torch.batching.continuous import (evict_cache_slot,
                                                 insert_cache_slot)
    calls = _count_calls(monkeypatch)
    model = build_model(CFG, fmt="float32", device="cpu")
    params = build_params(model, seed=0)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, CFG.vocab_size, (2, 12)))
    _, short = model.prefill(params, {"tokens": toks[:, :6]}, buf_len=8)
    _, past = model.prefill(params, {"tokens": toks}, buf_len=8,
                            lengths=torch.tensor([12, 9]))
    assert (past["slot_pos"][1] < 0).any()
    cache = model.init_cache(3, 8)
    insert_cache_slot(cache, short, 0, 0)
    insert_cache_slot(cache, past, 1, 1)
    insert_cache_slot(cache, short, 1, 2)
    evict_cache_slot(cache, 2)
    tok = torch.tensor([[3], [5], [0]])
    got, _ = model.decode_step(params, tok, cache)
    assert calls["paged"] == CFG.num_layers and calls["masked"] == 0
    want, _ = model.decode_step(params, tok[:2], past)
    assert torch.equal(got[1], want[1])
