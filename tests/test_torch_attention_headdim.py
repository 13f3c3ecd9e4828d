"""Head dims 96 and 120 (h2o-danube-3-4b: 3840 / 32 = 120; phi-3-vision:
3072 / 32 = 96): the attention kernels' plain versions against the JAX
Pallas kernels in interpret mode, at tests/test_kernels.py's tolerances,
and the wrappers' head_dim checks without a card (on the meta device).
tests/test_torch_cuda.py holds the CUDA kernels at these head dims on
the card."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_pallas)
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro.kernels.paged_attention.kernel import (  # noqa: E402
    paged_attention_pallas)

from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as PK  # noqa: E402

from _torch_parity import check_allclose, to_numpy, to_torch  # noqa: E402

F32_TOL = 2e-5      # tests/test_kernels.py's f32 attention tolerance
BF16_ABS = 0.05     # and its bf16 flash bound, absolute
HEAD_DIMS = (96, 120)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


# (B, S, H, Kv, window): ragged S (one Pallas tile of S), h2o-danube's and
# phi-3-vision's head groups, a window
FLASH_CASES = [(1, 81, 8, 2, None), (2, 100, 4, 4, None), (1, 128, 8, 2, 37)]


@pytest.mark.parametrize("B,S,H,Kv,window", FLASH_CASES)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_plain_matches_pallas(d, B, S, H, Kv, window):
    q, k, v = (_rand(s, i + d) for i, s in
               enumerate(((B, S, H, d), (B, S, Kv, d), (B, S, Kv, d))))
    bq = 64 if S % 64 == 0 else S
    ref = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True, window=window,
                                 bq=bq, bkv=bq)
    got = FK.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True,
                                   window=window)
    assert got.shape == (B, S, H, d)
    check_allclose(to_numpy(got), to_numpy(ref), rtol=F32_TOL, atol=F32_TOL)
    oracle = attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=True, window=window)
    check_allclose(to_numpy(got), to_numpy(oracle), rtol=F32_TOL,
                   atol=F32_TOL)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_plain_bf16_matches_pallas(d):
    """bf16 in: within 0.05 absolute of the Pallas kernel and of the f32
    oracle, as tests/test_kernels.py bounds bf16 flash attention."""
    q, k, v = (_rand(s, i) for i, s in
               enumerate(((1, 128, 8, d), (1, 128, 2, d), (1, 128, 2, d))))
    qb, kb, vb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    pallas = flash_attention_pallas(qb, kb, vb, bq=64, bkv=64)
    got = FK.flash_attention_plain(to_torch(qb), to_torch(kb), to_torch(vb))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(to_numpy(got), to_numpy(pallas), atol=BF16_ABS)
    oracle = attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(to_numpy(got), to_numpy(oracle),
                               atol=BF16_ABS)


@pytest.mark.parametrize("page", [16, 29])
@pytest.mark.parametrize("H,Kv", [(8, 2), (4, 4)])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_paged_plain_matches_pallas(d, H, Kv, page):
    """Ragged lengths, a row of length 0, an unassigned page (-1)."""
    kp, vp = _rand((10, page, Kv, d), d), _rand((10, page, Kv, d), d + 1)
    q = _rand((3, H, d), d + 2)
    pt = np.array([[0, 1, 2], [3, -1, 4], [5, 6, 7]], np.int32)
    sl = np.array([2 * page + 3, 3 * page - 1, 0], np.int32)
    ref = paged_attention_pallas(jnp.asarray(q), jnp.asarray(kp),
                                 jnp.asarray(vp), jnp.asarray(pt),
                                 jnp.asarray(sl))
    got = PK.paged_attention_plain(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(pt), torch.from_numpy(sl))
    assert got.shape == (3, H, d) and not got[2].any()
    np.testing.assert_allclose(to_numpy(got), to_numpy(ref), rtol=F32_TOL,
                               atol=F32_TOL)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_head_dims_and_plans_take_96_and_120():
    """HEAD_DIMS names the four widths; the bf16 flash plan takes two
    64-column boxes for 96 and 120 (the second zero-filled past d); the
    paged kernel runs them on its 128-column instance, whose merge
    scratch rows keep 128 + 2 floats."""
    assert FK.HEAD_DIMS == PK.HEAD_DIMS == (64, 96, 120, 128)
    for d, boxes in ((64, 1), (96, 2), (120, 2), (128, 2)):
        plan = FK.flash_plan(2, 256, 32, 8, d)
        assert plan.d_boxes == boxes and plan.q_box == (64, 4, 32, 1)
        assert PK.instance_d(d) == (64 if d == 64 else 128)
    assert PK.scratch_sizes(4, 8, 120, 3) == PK.scratch_sizes(4, 8, 128, 3)
    assert PK.scratch_sizes(4, 8, 96, 3)[0] == 4 * 8 * 3 * 8 * 130


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 96, 120, 128])
def test_wrappers_accept_the_four_head_dims(d, dtype):
    """The CUDA path's checks, run on the meta device, pass at every
    width the kernels take and keep the row pitch a multiple of 16 bytes
    (TMA's stride rule)."""
    FK.check_inputs(_meta(2, 81, 32, d, dtype=dtype),
                    _meta(2, 81, 8, d, dtype=dtype),
                    _meta(2, 81, 8, d, dtype=dtype))
    PK.check_inputs(_meta(4, 32, d, dtype=dtype),
                    _meta(16, 64, 8, d, dtype=dtype),
                    _meta(16, 64, 8, d, dtype=dtype),
                    _meta(4, 4, dtype=torch.int32),
                    _meta(4, dtype=torch.int32))
    assert (d * (torch.finfo(dtype).bits // 8)) % 16 == 0


@pytest.mark.parametrize("d", [80, 112, 256])
def test_wrappers_refuse_other_head_dims(d):
    """Any other head_dim raises on the CUDA path's checks, with no
    fallback to the plain version."""
    with pytest.raises(ValueError, match=f"head_dim {d}"):
        FK.check_inputs(_meta(1, 16, 4, d), _meta(1, 16, 2, d),
                        _meta(1, 16, 2, d))
    with pytest.raises(ValueError, match=f"head_dim {d}"):
        PK.check_inputs(_meta(1, 4, d), _meta(2, 8, 2, d), _meta(2, 8, 2, d),
                        _meta(1, 2, dtype=torch.int32),
                        _meta(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        FK.flash_attention(_meta(1, 16, 4, 96), _meta(1, 16, 2, 96),
                           _meta(1, 16, 2, 96))
