"""The host-side plans of the two attention kernels, on the CPU: the bf16
flash kernel's grid and tensor-map boxes (``flash_plan``), and the paged
kernel's split of a row over blocks, its TMA boxes and its scratch. The
kernels compute their offsets as these functions do; the ``gpu`` tests in
``test_torch_cuda.py`` hold the kernels themselves on the card."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as PK  # noqa: E402

GROUPS = [1, 2, 4, 7, 8, 64]
SEQS = [1, 81, 130, 256, 2049]


@pytest.mark.parametrize("S", SEQS)
@pytest.mark.parametrize("d", [64, 96, 120, 128])
@pytest.mark.parametrize("G", GROUPS)
def test_flash_plan_covers_every_row_once(G, d, S):
    """Every (batch, position, head) row of q (B = 2, Kv = 2) is stored
    by exactly one block; a block's rows all lie in one batch row and its
    q box starts inside it (TMA fills the rest of the box with zeros, so a
    box never reads the next sequence); a block holds at most 128 rows."""
    B, Kv = 2, 2
    H = G * Kv
    plan = FK.flash_plan(B, S, H, Kv, d)
    assert plan.bq == 128 // G and plan.rows == plan.bq * G <= 128
    assert plan.grid == (B * Kv, -(-S // plan.bq))
    assert plan.q_box == (64, G, plan.bq, 1)
    assert plan.kv_box == (64, 1, 64, 1)
    assert plan.d_boxes == -(-d // 64) and all(x <= 256 for x in plan.q_box)
    seen = []
    for bx, by in itertools.product(range(plan.grid[0]),
                                    range(plan.grid[1])):
        b, kv, q0 = FK.block_origin(plan, bx, by, Kv)
        assert 0 <= q0 < S and 0 <= b < B
        rows = FK.block_rows(plan, bx, by, S, H, Kv)
        assert rows and {r[0] for r in rows} == {b}
        assert all(kv * G <= h < (kv + 1) * G for _, _, h in rows)
        seen += rows
    assert len(seen) == len(set(seen)) == B * S * H
    assert set(seen) == set(itertools.product(range(B), range(S), range(H)))


@pytest.mark.parametrize("window", [None, 512])
@pytest.mark.parametrize("G", GROUPS)
def test_flash_blocks_with_most_key_tiles_start_first(G, window):
    """Causal: the blocks the grid's y index takes first walk the most key
    tiles (the q tile index is reversed), so the causal tail does not end
    on one SM. Without a window the counts never rise along y; with one
    (where a row's first blocks see fewer keys than the window) the first
    half of the launch order holds at least the second half's tiles."""
    S = 2049
    plan = FK.flash_plan(1, S, G, 1, 128)
    tiles = [FK.key_tiles(FK.block_origin(plan, 0, by, 1)[2], plan.bq, S, S,
                          True, window) for by in range(plan.grid[1])]
    if window is None:
        assert tiles == sorted(tiles, reverse=True)
    else:
        half = len(tiles) // 2
        assert sum(tiles[:half]) >= sum(tiles[-half:])
    assert FK.key_tiles(0, plan.bq, S, S, False, None) == -(-S // 64)


# (S, T, G, d, causal, window): the shapes of the flash gradient tests
# (test_torch_training_flash.py CASES), chip_smoke's BWD_CELLS
# (stablelm-1.6b, granite-moe-1b-a400m, h2o-danube-3-4b plain and windowed,
# seamless's unmasked cross-attention) and an unmasked windowed call
BWD_SHAPES = [(70, 70, 2, 64, True, None), (150, 150, 1, 64, True, 40),
              (33, 33, 4, 64, True, None), (20, 33, 1, 64, False, None),
              (40, 70, 2, 96, True, None), (70, 40, 4, 120, True, None),
              (131, 131, 2, 120, True, 64), (1024, 1024, 1, 64, True, None),
              (1024, 1024, 2, 64, True, None),
              (1024, 1024, 4, 120, True, None),
              (1024, 1024, 4, 120, True, 256), (256, 64, 1, 64, False, None),
              (200, 300, 64, 128, False, 30)]


@pytest.mark.parametrize("S,T,G,d,causal,window", BWD_SHAPES)
def test_flash_bwd_plan_walks_cover_every_visible_pair_once(S, T, G, d,
                                                            causal, window):
    """The bf16 backward's two walks over (query, key) pairs, for each
    head: the dK/dV blocks' query tiles and the dQ blocks' key tiles each
    cover every pair of ``visible`` exactly once, and no tile without a
    visible pair, except an unmasked windowed call's (the window narrows
    the walks only under the causal mask, as the forward's key walk).
    The dQ pass is the forward's plan; the boxes stay within TMA's 256."""
    B, Kv = 2, 2
    plan = FK.flash_bwd_plan(B, S, T, G * Kv, Kv, d, causal, window)
    assert plan.keys == (128 if d == 64 else 64)
    assert plan.dkdv_grid == (B * Kv, -(-T // plan.keys))
    assert plan.q_box == (64, 1, FK.BWD_Q_TILE, 1)
    assert plan.kv_box == (64, 1, plan.keys, 1)
    assert plan.dq == FK.flash_plan(B, S, G * Kv, Kv, d)
    assert plan.d_boxes == -(-d // 64)
    assert all(x <= 256 for x in plan.q_box + plan.kv_box)
    vis = FK.visible(S, T, causal, window, "cpu").numpy()
    empty_ok = not causal and window is not None
    for walk in ("dkdv", "dq"):
        cover = np.zeros((S, T), dtype=np.int64)
        if walk == "dkdv":
            tiles = [(q0, q0 + FK.BWD_Q_TILE, k0, k0 + plan.keys)
                     for by, k0 in enumerate(range(0, T, plan.keys))
                     for q0 in FK.dkdv_query_tiles(plan, by)]
        else:
            tiles = []
            for by in range(plan.dq.grid[1]):
                q0 = FK.block_origin(plan.dq, 0, by, Kv)[2]
                tiles += [(q0, q0 + plan.dq.bq, k0, k0 + FK.KEY_TILE)
                          for k0 in FK.key_tile_starts(q0, plan.dq.bq, S, T,
                                                       causal, window)]
        for q0, q1, k0, k1 in tiles:
            assert 0 <= q0 < S and 0 <= k0 < T
            cover[q0:q1, k0:k1] += 1
            assert vis[q0:q1, k0:k1].any() or empty_ok, (walk, q0, k0)
        assert cover.max() <= 1 and (cover[vis] == 1).all(), walk


def _valid_slots(table_row, seq_len, page, n_pool):
    return {t for t in range(seq_len)
            if 0 <= table_row[t // page] < n_pool}


@pytest.mark.parametrize("page", [8, 29, 64, 261])
def test_paged_boxes_cover_the_valid_slots_and_nothing_else(page):
    """The producer's TMA boxes for each 64-slot chunk of a row: rows one
    of 64, 32, ..., 1, each box inside one page, together covering every
    slot below seq_len on an assigned page in the pool exactly once, and
    no slot of an unassigned page (-1), of a page id at n_pool, or past
    seq_len. A page of 261 slots takes several boxes."""
    n_max = max(2, 600 // page)
    n_pool = 2 * n_max
    table = list(range(n_max))
    table[1] = -1
    table[n_max - 1] = n_pool          # past the pool
    seq_len = n_max * page - 5
    split = PK.split_slots(1, 8, n_max * page, 132)
    got = []
    for s0 in range(0, seq_len, split):
        s1 = min(seq_len, s0 + split)
        for c0 in range(s0, s1, PK.CHUNK):
            c1 = min(c0 + PK.CHUNK, s1)
            for row, rows, r in PK.chunk_boxes(c0, c1, page, table, n_pool):
                assert rows in PK.BOX_ROWS and 0 <= r and r + rows <= c1 - c0
                pid, off = divmod(row, page)
                assert off + rows <= page      # one page
                j = table.index(pid)
                got += [j * page + off + i for i in range(rows)]
                assert [c0 + r + i for i in range(rows)] == \
                    [j * page + off + i for i in range(rows)]
    assert len(got) == len(set(got))
    assert set(got) == _valid_slots(table, seq_len, page, n_pool)
    if page == 261:
        first = PK.chunk_boxes(0, 64, page, table, n_pool)
        assert [b[1] for b in first] == [64]
        boxes_of_page0 = sum(
            len(PK.chunk_boxes(c, min(c + 64, 261), page, table, n_pool))
            for c in range(0, 261, 64))
        assert boxes_of_page0 == 6       # 4 x 64, then 4 + 1


@pytest.mark.parametrize("B,Kv,slots", [(1, 8, 4096), (4, 8, 512),
                                        (8, 8, 4096), (2, 2, 40),
                                        (1, 8, 261), (64, 8, 4096),
                                        (4, 8, 4096)])
@pytest.mark.parametrize("min_split", [PK.MIN_SPLIT, PK.MIN_SPLIT_F32])
def test_paged_split_is_one_wave_of_whole_chunks(B, Kv, slots, min_split):
    """The split is a multiple of a 64-slot chunk and covers the row; with
    more than one split the blocks fit one wave (one a SM) and each split
    holds at least min_split slots' worth of the row."""
    split = PK.split_slots(B, Kv, slots, 132, min_split)
    n_split = -(-slots // split)
    assert split % PK.CHUNK == 0 and n_split * split >= slots
    assert n_split <= max(1, -(-slots // min_split))
    assert n_split == 1 or B * Kv * n_split <= 132


def test_paged_split_plan_at_the_serve_cells():
    """bf16 streams 8 chunks a block before it splits a row: the serve
    phase's decode (B = 4 over 512 slots) and the sequential ring (261)
    take one block per (row, KV head) and so no merge; f32 splits down to
    single chunks."""
    assert PK.split_slots(4, 8, 512, 132) == 512
    assert PK.split_slots(1, 8, 320, 132) >= 320
    assert -(-4096 // PK.split_slots(1, 8, 4096, 132)) == 8
    assert PK.split_slots(4, 8, 512, 132, PK.MIN_SPLIT_F32) == 128


@pytest.mark.parametrize("n_split", [1, 2, 5])
def test_paged_scratch_sizes(n_split):
    """The merge scratch: none with one split; otherwise B * Kv * splits
    rows of 8 heads x (d + 2) f32 values and B * Kv counters."""
    part, count = PK.scratch_sizes(4, 8, 128, n_split)
    if n_split == 1:
        assert (part, count) == (0, 0)
    else:
        assert part == 4 * 8 * n_split * 8 * 130 and count == 32
