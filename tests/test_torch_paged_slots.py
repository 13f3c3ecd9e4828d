"""The paged attention call's optional parts: int8 K/V pages with their
f32 scales, and the per-slot position test (slot_pos, pos, window).

The plain version (repro_torch.kernels.paged_attention.kernel) over int8
pages equals it over pages dequantized by the reference's
``dequantize_kv``, bit for bit, and on those pages matches the Pallas
kernel in interpret mode; with slot positions it matches the reference's
masked ``attention`` under ``decode_attention_mask``; the wrapper's
checks and its meta cost; and at model level the port's decode, every
step through the paged call, against the reference's decode step for an
int8 KV cache, a window narrower than the ring and a prefill padded past
its ring. tests/test_torch_cuda.py holds the CUDA kernel against the
plain version on the card.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.paged_attention.kernel import (  # noqa: E402
    paged_attention_pallas)
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models.layers import attention as jax_attention  # noqa: E402
from repro.models.layers import (  # noqa: E402
    decode_attention_mask as jax_decode_mask)
from repro.models.transformer import dequantize_kv  # noqa: E402

from repro_torch.configs.paper_zoo import PAPER_MODELS  # noqa: E402
from repro_torch.core.op_analysis import OpCounter  # noqa: E402
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as K  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pt_ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as pl  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.transformer import quantize_kv  # noqa: E402

from _torch_parity import (  # noqa: E402
    carry_params, rel_err, to_numpy, to_torch)

F32_TOL = 2e-5      # tests/test_kernels.py's f32 attention tolerance
BF16_TOL = 2 ** -7  # tests/test_torch_paged_attention.py's bf16 tolerance
TOL = {"float32": F32_TOL, "bfloat16": BF16_TOL}
# as tests/test_torch_model.py: 16-bit logits teacher-forced over steps
TEACHER_TOL = 5e-2
# as tests/test_torch_archs.py: an f32 int8 code can round the other way
# when the f32 K/V it quantizes differs in its last bit
KV_QUANT_TOL = 5e-4
CFG = PAPER_MODELS["llama-3.1-8b"].reduced()


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _int8_pool(n_pool, page, Kv, d, seed):
    """int8 K and V pools with their f32 scales, from the port's
    quantize_kv of a seeded f32 pool (numpy arrays)."""
    out = []
    for s in (seed, seed + 1):
        codes, scale = quantize_kv(torch.from_numpy(
            _rand((n_pool, page, Kv, d), s)))
        out += [codes.numpy(), scale.numpy()]
    return out


def _deq(codes, scale, dtype):
    """The reference's dequantize_kv, as a torch tensor."""
    return to_torch(dequantize_kv(jnp.asarray(codes), jnp.asarray(scale),
                                  getattr(jnp, dtype)))


# ---------------------------------------------------------------------------
# int8 pages
# ---------------------------------------------------------------------------
CASE = dict(n_pool=10, page=16, Kv=2, d=64, H=8)
TABLE = np.array([[0, 1, 2], [3, -1, 4], [5, 6, 7]], np.int32)
LENS = np.array([40, 47, 0], np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_pages_equal_pages_dequantized_by_the_reference(dtype):
    """Bit for bit: the plain version over int8 pages and scales, and over
    the pages the reference's dequantize_kv makes of them; then those
    pages against the Pallas kernel in interpret mode (f32 2e-5, bf16
    2^-7), and the row of length 0 is 0."""
    c = CASE
    kc, ks, vc, vs = _int8_pool(c["n_pool"], c["page"], c["Kv"], c["d"], 3)
    q = to_torch(jnp.asarray(_rand((3, c["H"], c["d"]), 4))
                 .astype(getattr(jnp, dtype)))
    pt, sl = torch.from_numpy(TABLE), torch.from_numpy(LENS)
    got = K.paged_attention_plain(
        q, torch.from_numpy(kc), torch.from_numpy(vc), pt, sl,
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    kd, vd = _deq(kc, ks, dtype), _deq(vc, vs, dtype)
    want = K.paged_attention_plain(q, kd, vd, pt, sl)
    assert got.dtype == q.dtype
    assert torch.equal(got, want)
    assert not got[2].float().any()
    ref = paged_attention_pallas(*(jnp.asarray(to_numpy(t)).astype(
        getattr(jnp, dtype)) for t in (q, kd, vd)), jnp.asarray(TABLE),
        jnp.asarray(LENS))
    np.testing.assert_allclose(to_numpy(got), to_numpy(ref),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_ops_keeps_q_over_int8_pages():
    """The entry point keeps q in its dtype over int8 pages (there is no
    pool dtype to bring it to) and casts the table, lengths and positions
    to int32."""
    c = CASE
    kc, ks, vc, vs = (torch.from_numpy(a) for a in _int8_pool(
        c["n_pool"], c["page"], c["Kv"], c["d"], 5))
    q = torch.from_numpy(_rand((3, c["H"], c["d"]), 6)).to(torch.bfloat16)
    pt, sl = torch.from_numpy(TABLE), torch.from_numpy(LENS)
    sp = torch.arange(c["n_pool"] * c["page"]).view(c["n_pool"], c["page"])
    pos = torch.tensor([100, 100, 100])
    got = pt_ops.paged_attention(q, kc, vc, pt.long(), sl.long(),
                                 k_scale=ks, v_scale=vs, slot_pos=sp,
                                 pos=pos)
    want = K.paged_attention_plain(q, kc, vc, pt, sl, k_scale=ks,
                                   v_scale=vs, slot_pos=sp.int(),
                                   pos=pos.int())
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


# ---------------------------------------------------------------------------
# slot positions
# ---------------------------------------------------------------------------
def _ring_case(dtype, quant):
    """A ring cache of 3 rows of W = 32 slots in pages of 8, with -1 pad
    slots inside the prefix (row 0), a window narrower than the ring over
    a wrapped row (row 1, its slots holding positions 40..71, pos 71), and
    a row whose every slot fails the test (row 2: positions past pos)."""
    B, W, Kv, d, H = 3, 32, 2, 64, 8
    td = getattr(torch, dtype)
    k32, v32 = (torch.from_numpy(_rand((B, W, Kv, d), s)) for s in (7, 8))
    q = torch.from_numpy(_rand((B, H, d), 9)).to(td)
    slot_pos = torch.stack([
        torch.where(torch.arange(W) % 5 == 3, -1, torch.arange(W)),
        40 + (torch.arange(W) - 8) % W,
        torch.arange(W) + 50]).to(torch.int32)
    pos = torch.tensor([W - 1, 71, 20], dtype=torch.int32)
    if quant:
        (kc, ks), (vc, vs) = quantize_kv(k32), quantize_kv(v32)
        k, v = (c.float() * s[..., None] for c, s in ((kc, ks), (vc, vs)))
        k, v = k.to(td), v.to(td)
        pages = dict(k=kc, v=vc, k_scale=ks, v_scale=vs)
    else:
        k, v = k32.to(td), v32.to(td)
        pages = dict(k=k, v=v)
    return q, k, v, slot_pos, pos, pages


def _plain_over_ring(q, pages, slot_pos, pos, window, lens=None):
    kp, vp, pt, sl = pl.ring_cache_pages(pages["k"], pages["v"], pos)
    if lens is not None:
        sl = lens
    kw = dict(slot_pos=pl.ring_pages(slot_pos, 0), pos=pos, window=window)
    if "k_scale" in pages:
        kw.update(k_scale=pl.ring_pages(pages["k_scale"], 0),
                  v_scale=pl.ring_pages(pages["v_scale"], 0))
    return K.paged_attention_plain(q, kp, vp, pt, sl, **kw)


@pytest.mark.parametrize("quant", [False, True], ids=["16bit", "int8"])
@pytest.mark.parametrize("window", [None, 12])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slot_positions_match_the_reference_mask(dtype, window, quant):
    """Every slot of each row in the prefix (seq_lens = W): the plain
    version with slot_pos, pos and window against the reference's
    attention under decode_attention_mask (f32 2e-5, bf16 2^-7), over
    16-bit or f32 pages and over int8 pages (the reference reading them
    dequantized); the row with no valid slot is exactly 0, where the
    softmax oracle would average."""
    q, k, v, slot_pos, pos, pages = _ring_case(dtype, quant)
    W = slot_pos.shape[1]
    full = torch.full((3,), W, dtype=torch.int32)
    got = _plain_over_ring(q, pages, slot_pos, pos, window, lens=full)
    allow = jax_decode_mask(jnp.asarray(slot_pos.numpy()),
                            jnp.asarray(pos.numpy()), window)
    assert not np.asarray(allow)[2].any() and np.asarray(allow)[:2].any()
    if window is not None:      # the window drops slots of row 1
        assert np.asarray(allow)[1].sum() == window
    ref = jax_attention(*(jnp.asarray(to_numpy(t)).astype(getattr(
        jnp, dtype)) for t in (q[:, None], k, v)), mask=allow[:, None, :])
    np.testing.assert_allclose(to_numpy(got[:2]), to_numpy(ref[:2, 0]),
                               rtol=TOL[dtype], atol=TOL[dtype])
    assert got.dtype == q.dtype and not got[2].float().any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_positions_that_reduce_to_the_prefix_change_no_bit(dtype):
    """Slots holding positions 0..pos in order (an unwrapped ring from a
    prefill within it): the call with the position test gives the same
    bits as the call without it."""
    B, W, Kv, d = 3, 40, 2, 64
    td = getattr(torch, dtype)
    k, v = (torch.from_numpy(_rand((B, W, Kv, d), s)).to(td)
            for s in (11, 12))
    q = torch.from_numpy(_rand((B, 8, d), 13)).to(td)
    pos = torch.tensor([39, 17, 3], dtype=torch.int32)
    slot_pos = torch.where(torch.arange(W)[None, :] <= pos[:, None],
                           torch.arange(W)[None, :], -1).to(torch.int32)
    kp, vp, pt, sl = pl.ring_cache_pages(k, v, pos)
    without = K.paged_attention_plain(q, kp, vp, pt, sl)
    with_pos = K.paged_attention_plain(
        q, kp, vp, pt, sl, slot_pos=pl.ring_pages(slot_pos, 0), pos=pos,
        window=W)
    assert torch.equal(without, with_pos)


def test_ring_pages_are_views_aligned_with_the_pool():
    k = torch.randn((2, 3, 48, 2, 16))          # (L, B, W, Kv, hd)
    scale = torch.randn((2, 3, 48, 2))
    slot_pos = torch.arange(3 * 48, dtype=torch.int32).view(3, 48)
    kp, _, table, _ = pl.ring_cache_pages(
        k, k, torch.zeros(3, dtype=torch.int32))
    sp, sc = pl.ring_pages(slot_pos, 0), pl.ring_pages(scale, 1)
    assert sp.shape == kp.shape[1:3] and sc.shape == kp.shape[:4]
    assert sp.data_ptr() == slot_pos.data_ptr()
    assert sc.data_ptr() == scale.data_ptr()
    # row 2's page 1 is ring slots 16..31 of row 2 in all three
    page = table[2, 1]
    assert torch.equal(sp[page], slot_pos[2, 16:32])
    assert torch.equal(sc[1, page], scale[1, 2, 16:32])


# ---------------------------------------------------------------------------
# the wrapper's checks and its meta cost
# ---------------------------------------------------------------------------
def _meta_call(H=8, Kv=2, d=64, B=2, n_pool=6, page=16, n_max=3,
               kv=torch.int8, sdt=torch.float32, scales=True,
               positions=True, sp_shape=None, scale_device="meta"):
    def e(*shape, dtype=torch.float32, device="meta"):
        return torch.empty(shape, dtype=dtype, device=device)
    kw = {}
    if scales:
        kw.update(k_scale=e(n_pool, page, Kv, dtype=sdt,
                            device=scale_device),
                  v_scale=e(n_pool, page, Kv, dtype=sdt,
                            device=scale_device))
    if positions:
        kw.update(slot_pos=e(*(sp_shape or (n_pool, page)),
                             dtype=torch.int32),
                  pos=e(B, dtype=torch.int32))
    return (e(B, H, d, dtype=torch.bfloat16),
            e(n_pool, page, Kv, d, dtype=kv), e(n_pool, page, Kv, d,
                                                dtype=kv),
            e(B, n_max, dtype=torch.int32), e(B, dtype=torch.int32)), kw


@pytest.mark.parametrize("bad,err", [
    (dict(kv=torch.bfloat16), ValueError),          # scales, 16-bit pages
    (dict(scales=False), ValueError),               # int8 pages, no scales
    (dict(sdt=torch.bfloat16), TypeError),          # scales not f32
    (dict(sp_shape=(6, 8)), ValueError),            # slot_pos off the pool
    (dict(Kv=1, d=120, H=4), ValueError),           # Kv * d % 16
    (dict(scale_device="cpu"), ValueError),         # scales off q's device
])
def test_check_inputs_raises_on_what_the_kernel_does_not_take(bad, err):
    args, kw = _meta_call(**bad)
    with pytest.raises(err):
        K.check_inputs(*args, **kw)


def test_check_inputs_raises_on_lone_tensors():
    args, kw = _meta_call()
    K.check_inputs(*args, **kw)
    for drop in ("v_scale", "pos", "slot_pos"):
        with pytest.raises(ValueError):
            K.check_inputs(*args, **{k: t for k, t in kw.items()
                                     if k != drop})
    no_pos = {k: t for k, t in kw.items() if k not in ("slot_pos", "pos")}
    with pytest.raises(ValueError, match="window"):
        K.check_inputs(*args, window=4, **no_pos)
    with pytest.raises(ValueError, match="window"):
        K.check_inputs(*args, window=0, **kw)


@pytest.mark.parametrize("scales,positions", [(False, False), (True, False),
                                              (False, True), (True, True)])
def test_meta_reports_codes_scales_and_positions(scales, positions):
    """Under a cost analysis the meta branch reports the cost formula's
    bytes: codes at a byte, 8 bytes of scales a slot and head, 4 bytes of
    position a slot (and pos) over every slot of the table."""
    kv = torch.int8 if scales else torch.bfloat16
    args, kw = _meta_call(kv=kv, scales=scales, positions=positions)
    with OpCounter() as c:
        out = K.paged_attention(*args, **kw)
    assert out.shape == (2, 8, 64) and out.device.type == "meta"
    n_valid = 2 * 3 * 16
    want = cost.paged_attention(2, 8, 2, 64, n_valid, 6, 2,
                                kv_es=1 if scales else 2, scales=scales,
                                positions=positions)
    assert (c.cost.dot_bytes, c.cost.dot_flops) == want
    assert c.cost.kernels == {"paged_attention": 1}
    # q and out in bf16; K and V codes (1 byte) or bf16; the scales;
    # slot positions and pos; the table and lengths
    assert want[0] == (2 * 2 * 2 * 8 * 64
                       + (1 if scales else 2) * 2 * n_valid * 2 * 64
                       + (8 * n_valid * 2 if scales else 0)
                       + (4 * (n_valid + 2) if positions else 0)
                       + 4 * (6 + 2))


def test_dry_run_counts_the_kernel_for_int8_and_windowed_decode():
    """The dry run's decode over an int8 cache (the reference's __kvq
    records) and a windowed model's decode count one paged call a layer
    where they counted eager attention."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    shape = ShapeConfig("tiny_decode", 64, 4, "decode")
    for arch, kv_quant in (("minitron-8b", True), ("h2o-danube-3-4b", False)):
        cfg = get_config(arch).reduced()
        _, c = dryrun.dry_run(arch, "tiny_decode", False, "bfloat16",
                              kv_quant, cfg=cfg, shape=shape,
                              mesh=((2, 4), ("data", "model")))
        assert c.kernels.get("paged_attention") == cfg.num_layers, arch


# ---------------------------------------------------------------------------
# model level: the decode step against the reference
# ---------------------------------------------------------------------------
PROMPT = np.array([12, 9], np.int32)
STEPS = 6
MODELS = {
    "kv_quant": dict(kw=dict(kv_quant=True), buf_len=32),
    "window": dict(kw=dict(window_override=6), buf_len=32),
    "past_ring": dict(kw={}, buf_len=8),
    "kv_quant_past_ring": dict(kw=dict(kv_quant=True), buf_len=8),
}


def _decode_against_reference(name, fmt, tmp_path, monkeypatch):
    """Prefill and STEPS decode steps of reduced llama-3.1-8b in both
    packages: greedy per package in f32, the reference's tokens fed to
    both otherwise. Returns (per-step logits of each, paged calls,
    masked calls)."""
    m = MODELS[name]
    jm = jax_build_model(CFG, fmt=fmt, **m["kw"])
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(CFG, fmt=fmt, device="cpu", **m["kw"])
    tp = carry_params(jp, tmp_path)
    calls = {"paged": 0, "masked": 0}
    paged, masked = tfm.paged_attention, pl.attention

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tfm, "paged_attention", count("paged", paged))
    monkeypatch.setattr(pl, "attention", count("masked", masked))
    toks = np.random.default_rng(3).integers(
        0, CFG.vocab_size, (2, int(PROMPT.max()))).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        buf_len=m["buf_len"], lengths=jnp.asarray(PROMPT))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        buf_len=m["buf_len"],
                        lengths=torch.from_numpy(PROMPT))
    js, ts = [np.asarray(jl)], [to_numpy(tl)]
    step = jax.jit(jm.decode_step)
    for _ in range(STEPS):
        jt = js[-1].argmax(-1)
        tt = ts[-1].argmax(-1) if fmt == "float32" else jt
        jl, jc = step(jp, jnp.asarray(jt[:, None], jnp.int32), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(tt[:, None]), tc)
        js.append(np.asarray(jl))
        ts.append(to_numpy(tl))
    return js, ts, calls


@pytest.mark.parametrize("name", list(MODELS))
def test_float32_decode_matches_the_reference(name, tmp_path, monkeypatch):
    """f32: identical greedy tokens over the prefill and STEPS decode
    steps, logits within 1e-4 of the max |logit| (KV_QUANT_TOL with an
    int8 cache), every decode layer one paged call, no masked
    attention."""
    js, ts, calls = _decode_against_reference(name, "float32", tmp_path,
                                              monkeypatch)
    tol = KV_QUANT_TOL if "kv_quant" in name else 1e-4
    for i, (a, b) in enumerate(zip(ts, js)):
        np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))
        assert rel_err(a, b) < tol, f"step {i}"
    assert calls == {"paged": STEPS * CFG.num_layers, "masked": 0}


@pytest.mark.parametrize("name", ["kv_quant", "window", "past_ring"])
def test_bfloat16_decode_teacher_forced(name, tmp_path, monkeypatch):
    """bf16: the prefill and STEPS teacher-forced decode steps within
    TEACHER_TOL of the max |logit|, through the paged call only."""
    js, ts, calls = _decode_against_reference(name, "bfloat16", tmp_path,
                                              monkeypatch)
    for i, (a, b) in enumerate(zip(ts, js)):
        assert np.isfinite(a).all()
        assert rel_err(a, b) < TEACHER_TOL, f"step {i}"
    assert calls == {"paged": STEPS * CFG.num_layers, "masked": 0}
