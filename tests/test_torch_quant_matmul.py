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
    w16 = torch.from_numpy(_rand((128, 32), 1)).half()
    assert torch.equal(K.fp16_matmul(x, w16), K.fp16_matmul_plain(x, w16))
    assert K.LAUNCHES == {"int8_matmul": 0, "nf4_matmul": 0,
                          "int8_matmul_grouped": 0, "nf4_matmul_grouped": 0,
                          "fp16_matmul": 0, "bf16_matmul_grouped": 0,
                          "fp16_matmul_grouped": 0}


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


def test_library_path_follows_the_sources(tmp_path):
    a = K._library_path("int8_matmul")
    b = K._library_path("nf4_matmul")
    assert a != b and a.parent == b.parent == K.BUILD_DIR
    assert a.suffix == ".so"
    # every header the loops live in is part of the hash: an edit to
    # either rebuilds both libraries
    import dataclasses
    import shutil
    assert set(K.HEADERS) == {"quant_matmul.cuh", "qmm_wgmma.cuh",
                              "../../csrc/hopper.cuh"}
    # the two 16-bit libraries share their weight stage's header too
    assert K.HEADERS16 == K.HEADERS + ("f16_stage.cuh",)
    for name in K.KERNELS:
        assert K.SOURCES[name].headers == (
            K.HEADERS16 if name in ("fp16_matmul", "bf16_matmul")
            else K.HEADERS)
    # the module's csrc and the shared csrc two levels up, as in the tree
    csrc = tmp_path / "quant_matmul" / "csrc"
    shutil.copytree(K.CSRC, csrc)
    shutil.copytree(K.CSRC.parents[1] / "csrc", tmp_path / "csrc")
    for name in K.KERNELS:
        src = dataclasses.replace(K.SOURCES[name], csrc=csrc)
        before = K.cuda_build.library_path(src)
        for header in src.headers:
            with open(csrc / header, "a") as f:
                f.write("// edited\n")
            after = K.cuda_build.library_path(src)
            assert after != before, header
            before = after


# ---------------------------------------------------------------------------
# the launch plan (pure, from shapes alone)
# ---------------------------------------------------------------------------
LLAMA_KN = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
SERVE_M = [81, 201, 352, 464, 512]


@pytest.mark.parametrize("block", [None, 64])
@pytest.mark.parametrize("Kd,N", LLAMA_KN + [(512, 208), (1024, 1040)])
@pytest.mark.parametrize("M", SERVE_M + [9, 130])
def test_wgmma_grid_covers_every_output_tile_once(M, Kd, N, block):
    """The persistent grid: block b walks tiles b, b + grid, ...; their
    origins, as the kernel computes them, cover the M x N output in
    whole tiles, each exactly once, with no block idle."""
    plan = K.matmul_plan(M, N, Kd, n_sm=132, block=block)
    assert plan.loop == "wgmma" and (plan.bm, plan.bn) in K.WG_TILES
    m_tiles, tiles = K.wgmma_tiles(M, N, plan.bm, plan.bn)
    assert plan.grid == min(tiles, 132)
    walked = [K.tile_origin(t, m_tiles, plan.bm, plan.bn)
              for b in range(plan.grid)
              for t in range(b, tiles, plan.grid)]
    assert len(walked) == len(set(walked)) == tiles
    assert set(walked) == {(m, n) for m in range(0, M, plan.bm)
                           for n in range(0, N, plan.bn)}


@pytest.mark.parametrize("block", [None, 64, 32, 128])
@pytest.mark.parametrize("Kd,N", LLAMA_KN)
@pytest.mark.parametrize("M", SERVE_M)
def test_serve_shapes_take_the_wgmma_loop(M, Kd, N, block):
    """Every projection of the serve path's prefills (batched M = 352-512,
    the sequential run's B=1 prompts 81-251) takes the wgmma loop, for
    int8 and for nf4 with block 64 (and 32 or 128)."""
    plan = K.matmul_plan(M, N, Kd, n_sm=132, block=block)
    assert plan.loop == "wgmma"


DECODE_M = [1, 2, 3, 4, 5, 6, 7, 8]


@pytest.mark.parametrize("block", [None, 64, 32, 128])
@pytest.mark.parametrize("Kd,N", LLAMA_KN)
@pytest.mark.parametrize("M", DECODE_M)
def test_decode_shapes_take_the_decode_loop(M, Kd, N, block):
    """Every bf16 projection of a decode step (M = 1..8) takes the decode
    loop, int8 and nf4 (blocks 64, 32, 128), with the same plan as M = 1:
    the plan does not depend on M, so a row of x gets the same sums
    alone or in a batch."""
    plan = K.matmul_plan(M, N, Kd, 132, block=block)
    assert plan.loop == "decode" and plan.bm == K.DEC_M
    assert plan == K.matmul_plan(1, N, Kd, 132, block=block)


@pytest.mark.parametrize("Kd,N", LLAMA_KN)
@pytest.mark.parametrize("M", [1, 4, 8])
def test_f32_decode_takes_the_tile_loop(M, Kd, N):
    """f32 compute at M <= 8 is off the serve path (int8 and nf4 compute
    in bf16) and goes to the CUDA-core tile loop."""
    for block in (None, 64):
        assert K.matmul_plan(M, N, Kd, 132, bf16=False,
                             block=block).loop == "tile"


def _segments_by_tile(plan, N, Kd):
    tiles = {}
    for b, t, k0, k1 in K.decode_segments(plan, N, Kd):
        tiles.setdefault(t, []).append((b, k0, k1))
    return tiles


@pytest.mark.parametrize("block", [None, 64])
@pytest.mark.parametrize("Kd,N", LLAMA_KN + [(64, 208), (128, 16),
                                             (640, 400), (4096, 1040)])
def test_decode_segments_cover_every_k_step_once(Kd, N, block):
    """The decode grid's segments, as the kernel walks them: every
    (column tile, K step) exactly once, each tile's K ranges in block
    order end to end, every block busy, and the blocks' step counts
    within one of each other."""
    plan = K.matmul_plan(4, N, Kd, 132, block=block)
    nk, tiles = Kd // K.WG_BK, -(-N // plan.bn)
    by_tile = _segments_by_tile(plan, N, Kd)
    assert sorted(by_tile) == list(range(tiles))
    for t, segs in by_tile.items():
        blocks = [b for b, _, _ in segs]
        assert blocks == list(range(blocks[0], blocks[-1] + 1)), t
        edges = [k0 for _, k0, _ in segs] + [segs[-1][2]]
        assert edges[0] == 0 and edges[-1] == nk, t
        assert all(k1 == k0n for (_, _, k1), k0n in zip(segs, edges[1:])), t
    steps = [0] * plan.grid
    for b, _, k0, k1 in K.decode_segments(plan, N, Kd):
        steps[b] += k1 - k0
    assert sum(steps) == tiles * nk
    assert min(steps) >= 1 and max(steps) - min(steps) <= 1


@pytest.mark.parametrize("block", [None, 64])
@pytest.mark.parametrize("Kd,N", LLAMA_KN)
def test_decode_grid_fills_the_card(Kd, N, block):
    """One block on every one of 132 SMs at every decode shape, wk/wv (8
    column tiles of 128) included: the split, not the column tiles, fills
    the card."""
    plan = K.matmul_plan(4, N, Kd, 132, block=block)
    assert plan.grid == 132
    assert len({b for b, *_ in K.decode_segments(plan, N, Kd)}) == 132


@pytest.mark.parametrize("Kd,N", LLAMA_KN + [(640, 400), (128, 16)])
def test_decode_scratch_matches_the_plan(Kd, N):
    """The workspace the wrapper asks for holds a slot (block + tile) for
    every segment of a split tile, no two segments sharing one, and the
    counters one per column tile; the wrapper's own scratch holds those
    sizes."""
    plan = K.matmul_plan(4, N, Kd, 132)
    n_part, n_count = K.decode_scratch(plan, N)
    slot = K.DEC_M * plan.bn
    assert n_part % slot == 0 and n_count == -(-N // plan.bn)
    split = [(b, t) for t, segs in _segments_by_tile(plan, N, Kd).items()
             if len(segs) > 1 for b, _, _ in segs]
    slots = [b + t for b, t in split]
    assert len(set(slots)) == len(slots)
    assert max(slots) < n_part // slot
    part, counter = K._scratch(plan, N, torch.device("cpu"))
    assert part.numel() >= n_part and part.dtype == torch.float32
    assert counter.numel() >= n_count and not counter.any()


@pytest.mark.parametrize("M,Kd,N,bf16,block,aligned", [
    (512, 4096, 4096, False, None, True),     # f32 compute
    (512, 4096, 4096, False, 64, True),
    (130, 320, 200, True, None, True),        # N % 16, K % 64
    (130, 4096, 200, True, None, True),       # N % 16
    (130, 4128, 256, True, None, True),       # K % 64
    (130, 4096, 4096, True, 16, True),        # a small nf4 block
    (130, 4096, 4096, True, 2, True),
    (130, 4096, 4096, True, None, False),     # a pointer off 16 bytes
    (4, 320, 200, True, None, True),          # decode, unaligned shape
    (4, 4096, 4096, True, None, False),
    (8, 4128, 256, True, None, True),         # decode, K % 64
    (1, 4096, 4096, True, 16, True),          # decode, a small nf4 block
])
def test_other_shapes_take_the_tile_loop(M, Kd, N, bf16, block, aligned):
    assert K.matmul_plan(M, N, Kd, 132, bf16=bf16, block=block,
                         aligned=aligned).loop == "tile"


@pytest.mark.parametrize("block", [None, 64])
def test_plan_fills_the_card_at_wk_wv(block):
    """(K, N) = (4096, 1024) at M = 512: at least 100 of 132 SMs busy."""
    plan = K.matmul_plan(512, 1024, 4096, 132, block=block)
    assert plan.loop == "wgmma" and plan.grid >= 100


@pytest.mark.parametrize("block", [None, 64])
def test_plan_walks_w_gate_in_at_most_two_tiles_a_block(block):
    """(4096, 14336) at M = 512: 448 tiles of 128 x 128 would be 3.4
    waves; the plan's persistent grid gives no block more than two
    tiles, and every SM one."""
    plan = K.matmul_plan(512, 14336, 4096, 132, block=block)
    tiles = K.wgmma_tiles(512, 14336, plan.bm, plan.bn)[1]
    assert plan.grid == 132 and -(-tiles // plan.grid) <= 2


def test_every_planned_tile_has_a_step_time():
    for fmt, times in K.WG_STEP_US.items():
        assert set(times) == set(K.WG_TILES), fmt


def test_cpu_wrappers_count_no_loop():
    K.reset_launches()
    x = torch.from_numpy(_rand((16, 128), 0))
    q8 = pt_int8.quantize_int8(torch.from_numpy(_rand((128, 32), 1)))
    K.int8_matmul(x, q8.codes, q8.scale)
    K.int8_matmul_grouped(x[None], q8.codes[None], q8.scale[None])
    assert K.LOOP_LAUNCHES == {name: {loop: 0 for loop in K.LOOPS}
                               for name in K.ENTRY_POINTS}
