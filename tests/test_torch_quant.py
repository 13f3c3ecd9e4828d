"""The port's quantization (repro_torch.quant) against the JAX package:
byte-equal quantized weights, the same quantize_params tree, and
linear_apply per precision format."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.paper_zoo import PAPER_MODELS  # noqa: E402
from repro.core.precision import make_policy as jax_make_policy  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.quant import apply as jax_apply  # noqa: E402
from repro.quant import int8 as jax_int8  # noqa: E402
from repro.quant import nf4 as jax_nf4  # noqa: E402

from repro_torch.core.precision import make_policy  # noqa: E402
from repro_torch.quant import apply as pt_apply  # noqa: E402
from repro_torch.quant import int8 as pt_int8  # noqa: E402
from repro_torch.quant import nf4 as pt_nf4  # noqa: E402

from _torch_parity import carry_params, rel_err, to_numpy, to_torch  # noqa: E402,E501

FORMATS = ("float32", "float16", "bfloat16", "int8", "nf4")


def _weights(seed, shape, scale=0.05):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _tied_weights():
    """Ties everywhere: duplicate rows (equal outlier magnitudes, broken
    by index) and values exactly halfway between int8 codes."""
    w = np.arange(-127, 129, dtype=np.float32).reshape(64, 4) * 0.5
    w[10] = w[3]
    w[20] = -w[3]
    return w


def _assert_int8_equal(pt, ref):
    for field in ("codes", "scale", "outlier_idx", "outlier_w"):
        a = getattr(pt, field)
        b = to_torch(getattr(ref, field))
        assert a.dtype == b.dtype, field
        assert torch.equal(a, b), field


@pytest.mark.parametrize("outlier_fraction", [0.0, 0.02, 0.1])
@pytest.mark.parametrize("w", [_weights(0, (128, 96)), _tied_weights()],
                         ids=["random", "ties"])
def test_quantize_int8_bytes(w, outlier_fraction):
    """Exact bytes: argsort ties (stable), round half to even."""
    ref = jax_int8.quantize_int8(jnp.asarray(w), outlier_fraction)
    pt = pt_int8.quantize_int8(torch.from_numpy(w), outlier_fraction)
    _assert_int8_equal(pt, ref)


@pytest.mark.parametrize("block", [16, 32, 64])
def test_quantize_nf4_bytes(block):
    w = _weights(1, (128, 80))
    w[:, 5] = 0.0                          # absmax 0 -> 1
    w[:block, 7] = np.linspace(-1, 1, block)   # code points hit exactly
    ref = jax_nf4.quantize_nf4(jnp.asarray(w), block)
    pt = pt_nf4.quantize_nf4(torch.from_numpy(w), block)
    assert torch.equal(pt.packed, to_torch(ref.packed))
    assert torch.equal(pt.absmax, to_torch(ref.absmax))
    assert pt.block == ref.block == block


def test_nearest_code_chunks_match_one_pass(monkeypatch):
    """Chunking along N (needed at full width) changes no code."""
    x = torch.from_numpy(_weights(2, (64, 50), scale=0.5)).clamp(-1, 1)
    whole = pt_nf4._nearest_code(x)
    monkeypatch.setattr(pt_nf4, "_NEAREST_CHUNK_ELEMS", 64 * 16 * 3)
    assert torch.equal(pt_nf4._nearest_code(x), whole)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_matches(dtype):
    w = _weights(3, (128, 64))
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    q8 = jax_int8.quantize_int8(jnp.asarray(w), 0.05)
    q4 = jax_nf4.quantize_nf4(jnp.asarray(w), 32)
    p8 = pt_int8.Int8Weight(*(to_torch(a) for a in q8))
    p4 = pt_nf4.NF4Weight(*(to_torch(a) for a in q4))
    np.testing.assert_array_equal(
        to_numpy(pt_int8.dequantize_int8(p8, td)),
        to_numpy(jax_int8.dequantize_int8(q8, jd)))
    np.testing.assert_array_equal(
        to_numpy(pt_nf4.dequantize_nf4(p4, td)),
        to_numpy(jax_nf4.dequantize_nf4(q4, jd)))


def test_int8_reference_formula():
    """quant.int8.int8_matmul: scale before the product, as in JAX."""
    w = _weights(4, (128, 64))
    x = _weights(5, (3, 7, 128), scale=1.0)
    q = jax_int8.quantize_int8(jnp.asarray(w), 0.02)
    p = pt_int8.Int8Weight(*(to_torch(a) for a in q))
    for jd, td, tol in ((jnp.float32, torch.float32, 1e-5),
                        (jnp.bfloat16, torch.bfloat16, 2e-2)):
        ref = jax_int8.int8_matmul(jnp.asarray(x), q, jd)
        got = pt_int8.int8_matmul(torch.from_numpy(x), p, td)
        assert got.dtype == td
        assert rel_err(got, ref) < tol


@pytest.mark.parametrize("fmt", ["int8", "nf4"])
def test_quantize_params_tree(fmt, tmp_path):
    """Same tree, same skips (lm_head, norms, embed stay), same bytes:
    the port quantizes the carried master weights layer by layer."""
    cfg = PAPER_MODELS["llama-3.1-8b"].reduced()
    m = jax_build_model(cfg, fmt=fmt)
    master = m.init(jax.random.PRNGKey(0))
    ref = m.quantize(master)
    pt_master = carry_params(master, tmp_path)
    got = pt_apply.quantize_params(pt_master, make_policy(fmt))
    ref_layers = carry_params(ref, tmp_path, "q.npz")
    assert set(got) == set(ref_layers)
    for key in ("embed", "lm_head", "final_norm"):
        assert isinstance(got[key], torch.Tensor)
        assert torch.equal(got[key], ref_layers[key])
    assert len(got["layers"]) == cfg.num_layers
    for lg, lr in zip(got["layers"], ref_layers["layers"]):
        for block in ("attn", "mlp"):
            assert set(lg[block]) == set(lr[block])
            for name, leaf in lg[block].items():
                assert type(leaf) is type(lr[block][name]), name
                for a, b in zip(leaf, lr[block][name]):
                    assert torch.equal(a, b), name
        assert torch.equal(lg["attn_norm"], lr["attn_norm"])


def test_quantize_params_is_identity_for_float_formats():
    params = {"layers": [{"attn": {"wq": torch.ones(64, 64)}}]}
    assert pt_apply.quantize_params(params, make_policy("bfloat16")) \
        is params


@pytest.mark.parametrize("fmt", FORMATS)
def test_linear_apply_formats(fmt):
    """f32 at 1e-5; the 16-bit and quantized formats at 2e-2 relative.

    int8: the port applies the per-column scale after the product (the
    kernel's order, as the JAX Pallas kernel does); the JAX reference
    path applies it before, so the two differ by bf16 rounding."""
    w = _weights(6, (128, 96))
    x = _weights(7, (2, 5, 128), scale=1.0)
    jpol = jax_make_policy(fmt)
    ppol = make_policy(fmt)
    jw = jnp.asarray(w).astype(jpol.param_dtype)
    if fmt in ("int8", "nf4"):
        jw = jax_apply.quantize_params({"w_up": jw}, jpol)["w_up"]
        cls = pt_int8.Int8Weight if fmt == "int8" else pt_nf4.NF4Weight
        pw = cls(*(to_torch(a) for a in jw))
    else:
        pw = to_torch(jw)
    ref = jax_apply.linear_apply(
        jw, jnp.asarray(x).astype(jpol.activation_dtype), jpol)
    got = pt_apply.linear_apply(
        pw, torch.from_numpy(x).to(ppol.activation_dtype), ppol)
    assert got.dtype == ppol.compute_dtype
    assert tuple(got.shape) == ref.shape
    tol = 1e-5 if fmt == "float32" else 2e-2
    assert rel_err(got, ref) < tol


def test_precision_policy_fields():
    for fmt in FORMATS:
        a, b = jax_make_policy(fmt), make_policy(fmt)
        assert a.weight_bits == b.weight_bits
        assert a.is_quantized == b.is_quantized
        assert a.needs_dequant_pass == b.needs_dequant_pass
        assert a.tensor_core_path == b.tensor_core_path
        assert str(jnp.dtype(a.param_dtype)) == str(b.param_dtype) \
            .replace("torch.", "")
        assert str(jnp.dtype(a.compute_dtype)) == str(b.compute_dtype) \
            .replace("torch.", "")
    with pytest.raises(ValueError):
        make_policy("fp8")
