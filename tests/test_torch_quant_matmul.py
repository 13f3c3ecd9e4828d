"""The quant_matmul kernels' plain versions (repro_torch.kernels.
quant_matmul) against the JAX Pallas kernels in interpret mode, on
tests/test_kernels.py's shape, block and dtype sweeps; the wrappers'
CPU and device behaviour. tests/test_torch_cuda.py holds the CUDA kernels
against the plain versions on the card."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.quant_matmul import ops as jax_ops  # noqa: E402
from repro.kernels.quant_matmul.kernel import (  # noqa: E402
    int8_matmul_pallas, nf4_matmul_pallas)
from repro.quant import quantize_int8, quantize_nf4  # noqa: E402

from repro_torch.kernels.quant_matmul import kernel as K  # noqa: E402
from repro_torch.kernels.quant_matmul import ops as pt_ops  # noqa: E402
from repro_torch.kernels.quant_matmul import ref as pt_ref  # noqa: E402
from repro_torch.quant import int8 as pt_int8  # noqa: E402
from repro_torch.quant import nf4 as pt_nf4  # noqa: E402

from _torch_parity import rel_err, to_numpy, to_torch  # noqa: E402


def _rand(shape, seed, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("m,k,n,bm,bk,bn", [
    (32, 128, 64, 32, 64, 64),
    (64, 256, 128, 32, 128, 64),
    (128, 512, 256, 64, 256, 128),
    (8, 128, 128, 8, 128, 128),
])
def test_int8_plain_matches_pallas(m, k, n, bm, bk, bn):
    """f32 compute at 1e-5."""
    x = _rand((m, k), 0)
    q = quantize_int8(jnp.asarray(_rand((k, n), 1, scale=0.05)))
    ref = int8_matmul_pallas(jnp.asarray(x), q.codes, q.scale, bm=bm,
                             bn=bn, bk=bk, compute_dtype=jnp.float32)
    got = K.int8_matmul_plain(torch.from_numpy(x), to_torch(q.codes),
                              to_torch(q.scale), torch.float32)
    np.testing.assert_allclose(to_numpy(got), to_numpy(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("jd,td,tol", [(jnp.float32, torch.float32, 1e-5),
                                       (jnp.bfloat16, torch.bfloat16, 2e-2)])
def test_int8_plain_dtypes(jd, td, tol):
    """bf16 at 2e-2 relative (one bf16 rounding of f32 sums taken in
    other orders)."""
    x = _rand((32, 256), 0)
    q = quantize_int8(jnp.asarray(_rand((256, 128), 1, scale=0.05)))
    ref = int8_matmul_pallas(jnp.asarray(x), q.codes, q.scale, bm=32,
                             bn=128, bk=128, compute_dtype=jd)
    got = K.int8_matmul_plain(torch.from_numpy(x), to_torch(q.codes),
                              to_torch(q.scale), td)
    assert got.dtype == td
    assert rel_err(got, ref) < tol


@pytest.mark.parametrize("block", [16, 32, 64])
@pytest.mark.parametrize("m,k,n", [(32, 128, 64), (64, 256, 128)])
def test_nf4_plain_matches_pallas(block, m, k, n):
    """f32 compute at 1e-5."""
    x = _rand((m, k), 0)
    q = quantize_nf4(jnp.asarray(_rand((k, n), 1, scale=0.05)), block)
    ref = nf4_matmul_pallas(jnp.asarray(x), q.packed, q.absmax, bm=m,
                            bn=n, bk=min(128, k), compute_dtype=jnp.float32)
    got = K.nf4_matmul_plain(torch.from_numpy(x), to_torch(q.packed),
                             to_torch(q.absmax), torch.float32)
    np.testing.assert_allclose(to_numpy(got), to_numpy(ref), rtol=1e-5,
                               atol=1e-5)


def test_nf4_plain_bf16_rounds_weights_like_pallas():
    """bf16: each dequantized weight is rounded to bf16 before the
    product in both; 2e-2 relative."""
    x = _rand((16, 128), 2)
    q = quantize_nf4(jnp.asarray(_rand((128, 64), 3, scale=0.05)), 64)
    ref = nf4_matmul_pallas(jnp.asarray(x), q.packed, q.absmax, bm=16,
                            bn=64, bk=128, compute_dtype=jnp.bfloat16)
    got = K.nf4_matmul_plain(torch.from_numpy(x), to_torch(q.packed),
                             to_torch(q.absmax), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert rel_err(got, ref) < 2e-2


def test_int8_ops_wrapper_with_outliers():
    """3-D input, a forced outlier row: the port's ops wrapper against
    the JAX ops wrapper (Pallas, interpret mode) in f32 at 1e-5, and
    against the f32 product of the unquantized weight at 2e-2."""
    x = _rand((4, 16, 128), 0, scale=1.0)
    w = _rand((128, 64), 1, scale=0.05)
    w[3] *= 50
    q = quantize_int8(jnp.asarray(w), outlier_fraction=0.02)
    ref = jax_ops.int8_matmul_kernel(jnp.asarray(x), q,
                                     compute_dtype=jnp.float32)
    pq = pt_int8.Int8Weight(*(to_torch(a) for a in q))
    got = pt_ops.int8_matmul_kernel(torch.from_numpy(x), pq,
                                    compute_dtype=torch.float32)
    assert tuple(got.shape) == (4, 16, 64)
    np.testing.assert_allclose(to_numpy(got), to_numpy(ref), rtol=1e-5,
                               atol=1e-5)
    assert rel_err(got, np.einsum("bsk,kn->bsn", x, w)) < 0.02
    full = pt_ref.int8_weight_matmul_ref(torch.from_numpy(x), pq)
    np.testing.assert_allclose(to_numpy(got), to_numpy(full), rtol=1e-4,
                               atol=1e-4)


def test_nf4_ops_wrapper():
    x = _rand((2, 8, 128), 0, scale=1.0)
    q = quantize_nf4(jnp.asarray(_rand((128, 64), 1, scale=0.05)), 64)
    ref = jax_ops.nf4_matmul_kernel(jnp.asarray(x), q,
                                    compute_dtype=jnp.float32)
    got = pt_ops.nf4_matmul_kernel(
        torch.from_numpy(x), pt_nf4.NF4Weight(*(to_torch(a) for a in q)),
        compute_dtype=torch.float32)
    np.testing.assert_allclose(to_numpy(got), to_numpy(ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        to_numpy(got).reshape(-1, 64),
        to_numpy(pt_ref.nf4_matmul_ref(torch.from_numpy(x).reshape(-1, 128),
                                       to_torch(q.packed),
                                       to_torch(q.absmax))),
        rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    K.reset_launches()
    x = torch.from_numpy(_rand((4, 128), 0))
    q8 = pt_int8.quantize_int8(torch.from_numpy(_rand((128, 32), 1)))
    q4 = pt_nf4.quantize_nf4(torch.from_numpy(_rand((128, 32), 1)), 64)
    assert torch.equal(K.int8_matmul(x, q8.codes, q8.scale),
                       K.int8_matmul_plain(x, q8.codes, q8.scale))
    assert torch.equal(K.nf4_matmul(x, q4.packed, q4.absmax),
                       K.nf4_matmul_plain(x, q4.packed, q4.absmax))
    assert K.LAUNCHES == {"int8_matmul": 0, "nf4_matmul": 0}


def test_other_devices_raise_instead_of_falling_back():
    x = torch.empty((4, 128), device="meta")
    codes = torch.empty((128, 32), dtype=torch.int8, device="meta")
    scale = torch.empty((32,), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        K.int8_matmul(x, codes, scale)
    with pytest.raises(ValueError, match="no kernel"):
        K.nf4_matmul(x, codes.view(torch.uint8)[:64],
                     torch.empty((2, 32), device="meta"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(K.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(K, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.build()


def test_library_path_follows_the_sources():
    a = K._library_path("int8_matmul")
    b = K._library_path("nf4_matmul")
    assert a != b and a.parent == b.parent == K.BUILD_DIR
    assert a.suffix == ".so"
