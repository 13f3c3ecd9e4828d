"""The paged attention kernel's plain version (repro_torch.kernels.
paged_attention) against the JAX Pallas kernel in interpret mode, on
tests/test_kernels.py's sweeps, plus a row of length 0 and page sizes
that are no power of two; the wrapper's CPU and device behaviour.
tests/test_torch_cuda.py holds the CUDA kernel against the plain version
on the card."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro.kernels.paged_attention.kernel import (  # noqa: E402
    paged_attention_pallas)
from repro.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_ref)

from repro_torch.kernels.paged_attention import kernel as K  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pt_ops  # noqa: E402
from repro_torch.kernels.paged_attention import ref as pt_ref  # noqa: E402

from _torch_parity import to_numpy, to_torch  # noqa: E402

F32_TOL = 2e-5      # tests/test_kernels.py's f32 attention tolerance


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _pool(n_pool, page, Kv, d, seed=0):
    return _rand((n_pool, page, Kv, d), seed), \
        _rand((n_pool, page, Kv, d), seed + 1)


def _both(q, kp, vp, pt, sl):
    """(Pallas in interpret mode, the port's plain version)."""
    ref = paged_attention_pallas(jnp.asarray(q), jnp.asarray(kp),
                                 jnp.asarray(vp), jnp.asarray(pt),
                                 jnp.asarray(sl))
    got = K.paged_attention_plain(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(pt), torch.from_numpy(sl))
    return ref, got


@pytest.mark.parametrize("page", [16, 32, 128])
def test_plain_matches_pallas_page_sizes(page):
    kp, vp = _pool(12, page, 2, 64)
    q = _rand((2, 8, 64), 5)
    pt = np.array([[0, 1, 2], [3, 4, -1]], np.int32)
    sl = np.array([2 * page + 3, page + 1], np.int32)
    ref, got = _both(q, kp, vp, pt, sl)
    np.testing.assert_allclose(to_numpy(got), to_numpy(ref), rtol=F32_TOL,
                               atol=F32_TOL)
    oracle = paged_attention_ref(jnp.asarray(q), jnp.asarray(kp),
                                 jnp.asarray(vp), jnp.asarray(pt),
                                 jnp.asarray(sl))
    np.testing.assert_allclose(to_numpy(got), to_numpy(oracle),
                               rtol=F32_TOL, atol=F32_TOL)


def test_plain_matches_contiguous_attention():
    """Each row against ordinary attention over its gathered cache."""
    kp, vp = _pool(8, 32, 4, 32)
    q = _rand((2, 4, 32), 9)
    pt = np.array([[2, 0], [5, -1]], np.int32)
    sl = np.array([50, 20], np.int32)
    ref, got = _both(q, kp, vp, pt, sl)
    np.testing.assert_allclose(to_numpy(got), to_numpy(ref), rtol=F32_TOL,
                               atol=F32_TOL)
    for b in range(2):
        pages = [p for p in pt[b] if p >= 0]
        kc = np.concatenate([kp[p] for p in pages], 0)[:sl[b]]
        vc = np.concatenate([vp[p] for p in pages], 0)[:sl[b]]
        one = attention_ref(jnp.asarray(q[b:b + 1, None]),
                            jnp.asarray(kc[None]), jnp.asarray(vc[None]),
                            causal=False)
        np.testing.assert_allclose(to_numpy(got[b]), to_numpy(one[0, 0]),
                                   rtol=F32_TOL, atol=F32_TOL)


def test_plain_matches_pallas_single_page():
    kp, vp = _pool(4, 16, 1, 32)
    q = _rand((1, 2, 32), 3)
    ref, got = _both(q, kp, vp, np.array([[1]], np.int32),
                     np.array([7], np.int32))
    np.testing.assert_allclose(to_numpy(got), to_numpy(ref), rtol=F32_TOL,
                               atol=F32_TOL)


def test_row_of_length_zero_returns_zero():
    """seq_len 0: every slot masked, p = 0, acc / max(0, 1e-20) = 0, as
    in the Pallas kernel (the softmax oracle would average instead)."""
    kp, vp = _pool(6, 8, 2, 64)
    q = _rand((3, 4, 64), 11)
    pt = np.array([[0, 1], [2, 3], [4, -1]], np.int32)
    sl = np.array([11, 0, 5], np.int32)
    ref, got = _both(q, kp, vp, pt, sl)
    np.testing.assert_allclose(to_numpy(got), to_numpy(ref), rtol=F32_TOL,
                               atol=F32_TOL)
    assert not to_numpy(got[1]).any()


@pytest.mark.parametrize("page,seq", [(261, 200), (29, 150)])
def test_plain_odd_page_sizes_and_group_of_seven(page, seq):
    """A page that is no power of two (the sequential path's one-page rows
    of W = 261), and qwen2.5-0.5b's G = 7 at d = 64."""
    kp, vp = _pool(2 * ((seq + page - 1) // page) + 1, page, 2, 64, seed=4)
    n = (seq + page - 1) // page
    q = _rand((2, 14, 64), 12)
    pt = np.stack([np.arange(n), np.arange(n, 2 * n)]).astype(np.int32)
    sl = np.array([seq, seq - 17], np.int32)
    ref, got = _both(q, kp, vp, pt, sl)
    np.testing.assert_allclose(to_numpy(got), to_numpy(ref), rtol=F32_TOL,
                               atol=F32_TOL)


def test_plain_bf16_rounds_like_pallas():
    """bf16 pool: both round p to bf16 before the PV product and the
    output once; one bf16 ulp apart at most."""
    kp, vp = _pool(6, 16, 2, 64, seed=2)
    q = _rand((2, 8, 64), 6)
    pt = np.array([[0, 1, 2], [3, -1, 4]], np.int32)
    sl = np.array([40, 48], np.int32)
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, kp, vp)]
    ref = paged_attention_pallas(*jb, jnp.asarray(pt), jnp.asarray(sl))
    got = K.paged_attention_plain(*(to_torch(a) for a in jb),
                                  torch.from_numpy(pt), torch.from_numpy(sl))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(to_numpy(got), to_numpy(ref), rtol=2 ** -7,
                               atol=2 ** -7)


def test_port_oracle_matches_jax_oracle():
    kp, vp = _pool(8, 16, 2, 32, seed=8)
    q = _rand((2, 4, 32), 13)
    pt = np.array([[3, 1, -1], [0, 2, 4]], np.int32)
    sl = np.array([30, 45], np.int32)
    ref = paged_attention_ref(jnp.asarray(q), jnp.asarray(kp),
                              jnp.asarray(vp), jnp.asarray(pt),
                              jnp.asarray(sl))
    got = pt_ref.paged_attention_ref(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(pt), torch.from_numpy(sl))
    np.testing.assert_allclose(to_numpy(got), to_numpy(ref), rtol=F32_TOL,
                               atol=F32_TOL)


def test_ops_entry_point_casts_table_and_query():
    kp, vp = _pool(4, 16, 2, 32, seed=1)
    q = _rand((1, 4, 32), 2)
    pt = np.array([[2, 0]], np.int32)
    sl = np.array([20], np.int32)
    got = pt_ops.paged_attention(torch.from_numpy(q).double(),
                                 torch.from_numpy(kp), torch.from_numpy(vp),
                                 torch.from_numpy(pt).long(),
                                 torch.from_numpy(sl).long())
    _, plain = _both(q, kp, vp, pt, sl)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(to_numpy(got), to_numpy(plain))


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    K.reset_launches()
    kp, vp = (torch.from_numpy(a) for a in _pool(3, 8, 1, 16))
    q = torch.from_numpy(_rand((1, 2, 16), 0))
    pt = torch.tensor([[0, 2]], dtype=torch.int32)
    sl = torch.tensor([13], dtype=torch.int32)
    assert torch.equal(K.paged_attention(q, kp, vp, pt, sl),
                       K.paged_attention_plain(q, kp, vp, pt, sl))
    assert K.LAUNCHES == {"paged_attention": 0}


def test_other_devices_raise_instead_of_falling_back():
    q = torch.empty((1, 8, 64), device="meta")
    kp = torch.empty((2, 16, 2, 64), device="meta")
    pt = torch.empty((1, 2), dtype=torch.int32, device="meta")
    sl = torch.empty((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        K.paged_attention(q, kp, kp, pt, sl)


@pytest.mark.parametrize("B,Kv,slots", [(1, 8, 4096), (4, 8, 512),
                                        (8, 8, 4096), (2, 2, 40),
                                        (1, 8, 261), (64, 8, 4096)])
def test_split_covers_the_slots_in_multiples_of_32(B, Kv, slots):
    """The wrapper's split of each row over blocks: a multiple of 32 (a
    warp's chunk), no more splits than MIN_SPLIT slots each would need,
    and no more blocks than it takes to give every SM two."""
    split = K.split_slots(B, Kv, slots, n_sm=132)
    n_split = -(-slots // split)
    assert split % 32 == 0 and n_split * split >= slots
    assert n_split <= -(-slots // K.MIN_SPLIT)
    assert n_split == 1 or B * Kv * (n_split - 1) < 2 * 132
