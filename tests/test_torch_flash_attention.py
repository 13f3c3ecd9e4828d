"""The flash attention kernel's plain version (repro_torch.kernels.
flash_attention) against the JAX Pallas kernel in interpret mode, on
tests/test_kernels.py's sweeps, and against the JAX oracle at ragged
lengths the Pallas kernel cannot tile; the wrapper's CPU and device
behaviour. tests/test_torch_cuda.py holds the CUDA kernel against the
plain version on the card."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_pallas)
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402

from repro_torch.kernels.flash_attention import kernel as K  # noqa: E402
from repro_torch.kernels.flash_attention import ops as pt_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as pt_ref  # noqa: E402
from repro_torch.models import layers as pl  # noqa: E402

from _torch_parity import check_allclose, to_numpy, to_torch  # noqa: E402

F32_TOL = 2e-5      # tests/test_kernels.py's f32 attention tolerance
BF16_ABS = 0.05     # and its bf16 flash bound, absolute against f32


def _qkv(B, S, H, Kv, d, seed=0, T=None):
    rng = np.random.default_rng(seed)
    T = S if T is None else T
    return (rng.standard_normal((B, S, H, d)).astype(np.float32),
            rng.standard_normal((B, T, Kv, d)).astype(np.float32),
            rng.standard_normal((B, T, Kv, d)).astype(np.float32))


def _plain(q, k, v, **kw):
    return K.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), **kw)


@pytest.mark.parametrize("S,bq,bkv", [(128, 64, 64), (256, 64, 128),
                                      (256, 256, 256)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_shapes(S, bq, bkv, causal):
    q, k, v = _qkv(2, S, 4, 2, 64)
    ref = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal, bq=bq,
                                 bkv=bkv)
    got = _plain(q, k, v, causal=causal)
    np.testing.assert_allclose(to_numpy(got), to_numpy(ref), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("window", [32, 64, 100])
def test_plain_matches_pallas_sliding_window(window):
    q, k, v = _qkv(1, 256, 4, 4, 32)
    ref = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True, window=window,
                                 bq=64, bkv=64)
    got = _plain(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(to_numpy(got), to_numpy(ref), rtol=F32_TOL,
                               atol=F32_TOL)


def test_plain_matches_pallas_gqa_groups():
    q, k, v = _qkv(2, 128, 8, 2, 32)
    ref = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), bq=64, bkv=64)
    got = _plain(q, k, v)
    np.testing.assert_allclose(to_numpy(got), to_numpy(ref), rtol=F32_TOL,
                               atol=F32_TOL)


def test_plain_bf16_matches_pallas_and_f32_oracle():
    """bf16 in: both round p to bf16 before the PV product and the output
    once; within 0.05 absolute of the f32 oracle, as the Pallas kernel."""
    q, k, v = _qkv(1, 128, 4, 2, 64)
    qb, kb, vb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    pallas = flash_attention_pallas(qb, kb, vb, bq=64, bkv=64)
    oracle = attention_ref(qb.astype(jnp.float32), kb.astype(jnp.float32),
                           vb.astype(jnp.float32))
    got = K.flash_attention_plain(to_torch(qb), to_torch(kb), to_torch(vb))
    assert got.dtype == torch.bfloat16
    assert np.abs(to_numpy(got) - to_numpy(oracle)).max() < BF16_ABS
    assert np.abs(to_numpy(pallas) - to_numpy(oracle)).max() < BF16_ABS
    # against Pallas itself: one bf16 ulp of the output at most
    np.testing.assert_allclose(to_numpy(got), to_numpy(pallas), rtol=2 ** -7,
                               atol=2 ** -7)


@pytest.mark.parametrize("S", [81, 175])
@pytest.mark.parametrize("window", [None, 50])
def test_plain_ragged_lengths_match_oracle(S, window):
    """The serve path's unpadded prompts: S = T not a multiple of any
    tile, which the Pallas kernel refuses."""
    q, k, v = _qkv(2, S, 4, 2, 64, seed=S)
    ref = attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=True, window=window)
    got = _plain(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(to_numpy(got), to_numpy(ref), rtol=F32_TOL,
                               atol=F32_TOL)


def test_plain_group_of_seven_head_dim_64():
    """qwen2.5-0.5b's heads: H = 14, Kv = 2 (G = 7), d = 64."""
    q, k, v = _qkv(1, 81, 14, 2, 64, seed=7)
    ref = attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = _plain(q, k, v)
    np.testing.assert_allclose(to_numpy(got), to_numpy(ref), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("tile", [16, 64, 1000])
def test_plain_tiling_does_not_change_the_result(tile):
    """Any tile, ragged or larger than the problem: the same function as
    the port's direct attention."""
    q, k, v = _qkv(1, 100, 4, 2, 16, seed=3)
    got = _plain(q, k, v, causal=True, window=30, tile=tile)
    direct = pl.attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True, window=30)
    check_allclose(to_numpy(got), to_numpy(direct), rtol=F32_TOL,
                   atol=F32_TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 40)])
def test_port_oracle_matches_jax_oracle(causal, window):
    q, k, v = _qkv(2, 70, 4, 2, 32, seed=5)
    ref = attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal, window=window)
    got = pt_ref.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal,
                               window=window)
    np.testing.assert_allclose(to_numpy(got), to_numpy(ref), rtol=F32_TOL,
                               atol=F32_TOL)


def test_ops_entry_point_takes_views_and_other_dtypes():
    """ops.flash_attention makes its inputs contiguous and brings k, v to
    q's dtype before the kernel's wrapper."""
    q, k, v = _qkv(1, 40, 4, 2, 32, seed=9)
    kt = torch.from_numpy(k).transpose(1, 2).contiguous().transpose(1, 2)
    assert not kt.is_contiguous()
    got = pt_ops.flash_attention(torch.from_numpy(q), kt,
                                 torch.from_numpy(v).double())
    np.testing.assert_array_equal(to_numpy(got), to_numpy(_plain(q, k, v)))


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    K.reset_launches()
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 20, 4, 2, 16))
    assert torch.equal(K.flash_attention(q, k, v, window=7),
                       K.flash_attention_plain(q, k, v, window=7))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    K.flash_attention(*leaves, window=7).sum().backward()
    assert K.LAUNCHES == {"flash_attention": 0, "flash_attention_bwd": 0}


def test_other_devices_raise_instead_of_falling_back():
    q = torch.empty((1, 8, 4, 64), device="meta")
    k = torch.empty((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        K.flash_attention(q, k, k)


def test_bad_window_raises():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 1, 16))
    with pytest.raises(ValueError, match="window"):
        K.flash_attention(q, k, v, window=0)
