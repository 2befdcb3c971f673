"""Host models of the grid kernels (``csrc/ffn_grid.cuh``) and of the
walker's tile mode (``csrc/walk.cu``), at small sizes: the live list a
walker CTA merges from the work-list segments of the row blocks it covers
(K1 at ``bm_rows`` dividing 32), the MAC counts the CTAs of the dense-grid
conv (K2) and of the LM kernels (K3) add, the launch geometry with a
partial last 32-row tile, and the tile mode's CTA tiles (``walk_tiles``:
every output once, its choice at VGG16's pair counts). No kernel runs
here: these are the plain models the card tests and ``chip_smoke.py``
hold the kernels to.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.bitmask_spmm import subblock_macs
from repro_torch.kernels.grid import (ROW_BLOCK, count_partials,
                                      grid_geometry, lm_grid_problem,
                                      walk_lists)
from repro_torch.kernels.sparse_conv import conv_grid_geometry
from repro_torch.kernels.worklist_core import (activation_occupancy,
                                               build_worklist)


def _chunk_lists(rng, nb, max_nz, kb, dead=0.25):
    idx = np.stack([rng.permutation(kb)[:max_nz]
                    for _ in range(nb)]).astype(np.int32)
    idx[rng.random(idx.shape) < dead] = -1
    return idx


# (bm_rows, M): the compact FFN's 8-row blocks at decode (one partial
# 32-row tile), a few tiles and a prefill; 16- and 32-row blocks
WALK_SHAPES = [(8, 8), (8, 24), (8, 40), (8, 128), (16, 48), (16, 128),
               (32, 96), (32, 128)]


@pytest.mark.parametrize("bm_rows,M", WALK_SHAPES)
def test_walk_lists_reproduce_every_segment(bm_rows, M):
    """Each stream's merged per-CTA lists hold every live (pair, j) step of
    the work list once, in each pair's schedule order, and nothing else;
    row masks cover whole pairs inside x."""
    rng = np.random.default_rng(bm_rows * 1000 + M)
    nb, max_nz, kb = 5, 6, 8
    mb = M // bm_rows
    idx = _chunk_lists(rng, nb, max_nz, kb)
    gidx = _chunk_lists(rng, nb, max_nz, kb)
    occ = rng.random((mb, kb)) < 0.4
    idx[0] = gidx[0] = -1                        # dead pairs
    idx[1, 0], gidx[1, 0] = 0, 1                 # gate-only steps
    occ[:, 0], occ[:, 1] = False, True
    if mb > 1:
        occ[-1] = False                          # a dead row block
    wl = build_worklist(idx, mb, occ_blk=occ, gate_indices=gidx)
    assert ((wl.k < 0) & (wl.k2 < 0)).any()      # flush-only steps
    assert ((wl.k < 0) & (wl.k2 >= 0)).any()     # gate-only steps
    ptr = wl.pair_ptr()
    for ks in (wl.k, wl.k2):
        lists = walk_lists(torch.as_tensor(ptr), torch.as_tensor(ks),
                           torch.as_tensor(wl.j), nb=nb, mb=mb,
                           bm_rows=bm_rows)
        seen = []
        for (tile, n), ents in lists.items():
            assert 0 <= n < nb and 0 <= tile * ROW_BLOCK < M
            js = [j for j, _, _ in ents]
            assert js == sorted(set(js))         # one entry a slot, by j
            for j, chunk, mask in ents:
                assert mask and mask >> min(ROW_BLOCK,
                                            M - tile * ROW_BLOCK) == 0
                for q in range(ROW_BLOCK // bm_rows):
                    bits = ((1 << bm_rows) - 1) << (q * bm_rows)
                    if mask & bits:
                        assert mask & bits == bits
                        m = (tile * ROW_BLOCK + q * bm_rows) // bm_rows
                        seen.append((n, m, j, chunk))
        want = []
        for p in range(nb * mb):
            n, m = divmod(p, mb)
            seg = [(int(wl.j[t]), int(ks[t]))
                   for t in range(ptr[p], ptr[p + 1]) if ks[t] >= 0]
            want += [(n, m, j, k) for j, k in seg]
            row = m * bm_rows
            got = [(j, c) for j, c, mask in
                   lists.get((row // ROW_BLOCK, n), [])
                   if mask >> (row % ROW_BLOCK) & 1]
            assert got == seg                    # the pair's own order
        assert sorted(seen) == sorted(want)
        assert len(seen) == len(set(seen))


def test_walk_lists_refuse_a_slot_with_two_chunks():
    """The merge keeps one chunk per slot: a list that names two for one
    slot of an n-block is no schedule the grid can run."""
    ptr = torch.tensor([0, 1, 2])
    with pytest.raises(ValueError):
        walk_lists(ptr, torch.tensor([3, 4]), torch.tensor([0, 0]), nb=1,
                   mb=2, bm_rows=8)


def _counts_case(rng, M, K, bk, nb, max_nz):
    x = torch.as_tensor(rng.normal(size=(M, K)).astype(np.float32))
    x[torch.as_tensor(rng.random(M // 4) < 0.5).repeat_interleave(4)] = 0
    x[:, :bk][torch.as_tensor(rng.random(M) < 0.5)] = 0
    x[:min(M, 32)] = 0                           # an all-dead 32-row tile
    idx = torch.as_tensor(_chunk_lists(rng, nb, max_nz, K // bk, dead=0.2))
    vals = torch.zeros(1, 1, 1, 1).expand(nb, max_nz, bk, 8)
    return x, idx, vals


@pytest.mark.parametrize("two_sided", [True, False])
@pytest.mark.parametrize("bm_rows", [64, 128, 256])
def test_conv_grid_counts_reduce_to_subblock_macs(two_sided, bm_rows):
    """The dense-grid conv's per-CTA MAC counts (32-row x 32-column CTAs,
    integer atomics into [nb, mb]) add up to the plain version's."""
    rng = np.random.default_rng(bm_rows + two_sided)
    bk, sub_m, nb = 64, 8, 3
    x, idx, vals = _counts_case(rng, 512, 6 * bk, bk, nb, 4)
    _, want = subblock_macs(x, idx, vals, bk=bk, bm=bm_rows, sub_m=sub_m,
                            two_sided=two_sided)
    geom = conv_grid_geometry(512, nb, bm_rows=bm_rows, bn=64)
    assert geom.col_group == 32 and geom.groups == 2
    part = count_partials(geom, activation_occupancy(x, sub_m, bk), idx,
                          sub_m=sub_m, two_sided=two_sided)
    assert part.shape == geom.counts_shape
    assert bool((part[:, :, 1:] == 0).all())     # column group 0 counts
    assert torch.equal(geom.reduce_counts(part), want)


# (bm, sub_m, M): row blocks that divide 32, with a partial last tile
SMALL_BLOCKS = [(8, 8, 8), (8, 8, 40), (8, 4, 24), (16, 8, 48),
                (32, 8, 96), (4, 4, 12)]


@pytest.mark.parametrize("two_sided", [True, False])
@pytest.mark.parametrize("bm,sub_m,M", SMALL_BLOCKS)
def test_count_partials_small_row_blocks(two_sided, bm, sub_m, M):
    """With row blocks of at most 32 rows a CTA adds to each row block it
    covers; the counts still add up to the plain version's."""
    rng = np.random.default_rng(bm * 100 + M)
    bk, nb = 128, 3
    x, idx, vals = _counts_case(rng, M, 3 * bk, bk, nb, 3)
    _, want = subblock_macs(x, idx, vals, bk=bk, bm=bm, sub_m=sub_m,
                            two_sided=two_sided)
    geom = grid_geometry(M, nb, bm=bm, bn=128)
    part = count_partials(geom, activation_occupancy(x, sub_m, bk), idx,
                          sub_m=sub_m, two_sided=two_sided)
    assert part.shape == geom.counts_shape
    assert torch.equal(geom.reduce_counts(part), want)


@pytest.mark.parametrize("M,bm", [(8, 8), (24, 8), (40, 8), (48, 16),
                                  (96, 32), (12, 4), (384, 128)])
def test_grid_geometry_partial_last_tile(M, bm):
    """Every output element lies in exactly one CTA, the last 32-row tile
    cut at M."""
    geom = grid_geometry(M, 3, bm=bm, bn=96)
    cover = torch.zeros(M, 3 * 96, dtype=torch.int32)
    for rows, cols in geom.tiles():
        assert rows.stop <= M
        cover[rows, cols] += 1
    assert bool((cover == 1).all())
    assert geom.blocks == len(list(geom.tiles())) \
        == -(-M // ROW_BLOCK) * 3 * geom.groups


@pytest.mark.parametrize("M,bm", [(96, 48), (40, 24), (40, 16), (60, 12)])
def test_grid_geometry_rejects_other_row_blocks(M, bm):
    with pytest.raises(ValueError):
        grid_geometry(M, 3, bm=bm, bn=128)
    with pytest.raises(ValueError):
        conv_grid_geometry(M, 3, bm_rows=bm, bn=128)


@pytest.mark.parametrize("pattern", ["chunk", "unstructured"])
def test_every_vgg16_layer_fits_the_conv_grid_copies(pattern):
    """The dense-grid conv's tensor copies take every VGG16 layer's packed
    tile and patch rows, the stem's padded K included."""
    from repro_torch.core import simulator as S
    from repro_torch.sparsity.structured import choose_chunk_layout
    for spec in S.BENCHMARKS["VGGNet"].layers:
        shape = (spec.k, spec.k, spec.d, spec.n)
        _, bk, bn = choose_chunk_layout(shape) if pattern == "chunk" \
            else ("channel", 128, 128)
        K = -(-spec.k * spec.k * spec.d // bk) * bk
        assert lm_grid_problem(torch.zeros(8, K), [], bk, bn) is None, spec


# The walker's tile mode (csrc/walk.cu): (M, nb, bm, bn) with row blocks the
# tiles cut (bm 96, 200) and n-blocks they cut (bn 100, 48)
TILE_SHAPES = [(512, 3, 128, 128), (512, 3, 128, 64), (384, 2, 96, 96),
               (400, 2, 200, 128), (256, 3, 64, 100), (512, 2, 256, 48)]


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("depth", [4, 48])
@pytest.mark.parametrize("M,nb,bm,bn", TILE_SHAPES)
def test_walk_tiles_cover_every_output_once(M, nb, bm, bn, depth, gated):
    """Every output element lies in exactly one CTA tile, partial slices of
    a row block and partial column groups of an n-block cut at bm and bn;
    whole warp bands, at most 256 computing threads and a producer warp."""
    from repro_torch.kernels.grid import walk_tiles
    t = walk_tiles(M, nb, bm=bm, bn=bn, depth=depth, gated=gated)
    cover = torch.zeros(M, nb * bn, dtype=torch.int32)
    for rows, cols in t.tiles():
        assert rows.stop - rows.start <= t.rows
        assert cols.stop - cols.start <= t.cols
        cover[rows, cols] += 1
    assert bool((cover == 1).all())
    assert t.blocks == len(list(t.tiles())) == M // bm * nb * t.slices \
        * t.groups
    assert t.rows % t.band == 0 and t.thread_rows in (4, 8)
    assert 32 < t.threads <= 288 and t.threads % 32 == 0
    if gated:
        assert t.thread_rows == 4


@pytest.mark.parametrize("pairs,mb,nb,bn,depth,want", [
    # VGG16 layer 1 (4 images at 224 px): 64-column n-blocks, 3 live
    # chunks of 64 a pair
    (1568, 1568, 1, 64, 6, (64, 64, 4, 3136)),
    # layer 8: 12 live chunks of 128 a pair, 896 warps of 8 x 8
    (112, 28, 4, 128, 48, (32, 128, 8, 448)),
    # layer 10: 32 pairs, 256 warps of 8 x 8 for 132 SMs
    (32, 8, 4, 128, 48, (32, 128, 4, 128))])
def test_walk_tiles_choice_at_vgg16_pair_counts(pairs, mb, nb, bn, depth,
                                                want):
    """The tile choice at 1568, 112 and 32 pairs on 132 SMs: CTA tiles of
    4096 outputs; 8 x 8 threads only where a CTA walks 24 stages or more
    and the launch gives every SM 4 warps of them."""
    from repro_torch.kernels.grid import H100_SMS, walk_tiles
    assert mb * nb == pairs
    t = walk_tiles(mb * 128, nb, bm=128, bn=bn, depth=depth, sms=H100_SMS)
    assert (t.rows, t.cols, t.thread_rows, t.blocks) == want
    assert walk_tiles(mb * 128, nb, bm=128, bn=bn, depth=depth,
                      gated=True).thread_rows == 4
    # fewer SMs make the same launch fill them: 8 x 8 at layer 10 too
    if pairs == 32:
        assert walk_tiles(mb * 128, nb, bm=128, bn=bn, depth=depth,
                          sms=32).thread_rows == 8


@pytest.mark.parametrize("M,bm,bn", [(512, 128, 200), (512, 96, 0),
                                     (500, 128, 64)])
def test_walk_tiles_rejects_what_the_mode_cannot_take(M, bm, bn):
    from repro_torch.kernels.grid import walk_tiles
    with pytest.raises(ValueError):
        walk_tiles(M, 2, bm=bm, bn=bn, depth=4)


def test_walk_tma_problem_names_the_shapes_for_plain_copies():
    """The tile mode's tensor copies need 16-byte rows and alignment; the
    shapes they refuse run its plain copies (worklist_core.walk_mode)."""
    from repro_torch.kernels.grid import walk_tma_problem
    x = torch.zeros(64, 3 * 64)
    w = torch.zeros(4, 3, 64, 64)
    assert walk_tma_problem(x, [("vals", w)], 64, 64) is None
    assert walk_tma_problem(torch.zeros(64, 30), [], 64, 10) is not None
    assert walk_tma_problem(x.bfloat16(), [], 36, 64) is not None
    assert walk_tma_problem(torch.zeros(64 * 192 + 1)[1:].view(64, 192), [],
                            64, 64) is not None


def test_worklist_live_items_count_both_streams():
    """The walk's chunk multiplies (the depth walk_tiles reads): live steps
    of each stream."""
    rng = np.random.default_rng(3)
    idx = _chunk_lists(rng, 4, 5, 8)
    gidx = _chunk_lists(rng, 4, 5, 8)
    occ = rng.random((6, 8)) < 0.5
    one = build_worklist(idx, 6, occ_blk=occ)
    two = build_worklist(idx, 6, occ_blk=occ, gate_indices=gidx)
    assert one.live_items == int((one.k >= 0).sum()) == one.mac_steps
    assert two.live_items == int((two.k >= 0).sum() + (two.k2 >= 0).sum())
    assert two.live_items >= two.mac_steps


def test_walk_tma_problem_needs_aligned_chunks():
    """A box of x starts at a chunk's first column: chunks whose bytes are
    not a multiple of 16 take the plain copies even where the rows are."""
    from repro_torch.kernels.grid import walk_tma_problem
    x = torch.zeros(64, 180)                      # 720-byte rows
    assert walk_tma_problem(x, [], 64, bk=10) is not None   # 40 bytes
    assert walk_tma_problem(x, [], 64, bk=12) is None       # 48 bytes
    xb = x.bfloat16()[:, :176].contiguous()       # 352-byte rows
    assert walk_tma_problem(xb, [], 64, bk=8) is None
    assert walk_tma_problem(xb, [], 64, bk=4) is not None


# ---------------------------------------------------------------------------
# the tile mode's tap-slab operand (lazy im2col): its host model
# ---------------------------------------------------------------------------
TAP_GEOMS = [(1, "SAME", 3), (2, "SAME", 3), (2, "VALID", 3), (1, "VALID", 1),
             ((1, 2), ((2, 0), (1, 1)), 3)]


@pytest.mark.parametrize("stride,padding,k", TAP_GEOMS)
def test_tap_geometry_matches_conv_out_size(stride, padding, k):
    from repro_torch.kernels.grid import tap_geometry
    from repro_torch.kernels.sparse_conv import conv_out_size
    oh, ow = conv_out_size(13, 9, k, k, stride, padding)
    m_pad = oh * ow + (-(oh * ow)) % 32
    g = tap_geometry((3, 13, 9, 16), k, k, stride, padding, m_pad=m_pad)
    assert (g.oh, g.ow, g.m_img) == (oh, ow, oh * ow)
    assert g.rows == 3 * m_pad and g.k == k * k * 16
    with pytest.raises(ValueError):
        tap_geometry((3, 13, 9, 16), k, k, stride, padding,
                     m_pad=oh * ow - 1)


@pytest.mark.parametrize("stride,padding,k", TAP_GEOMS)
def test_tap_row_pixel_map_names_the_patch_matrix(stride, padding, k):
    """Row r, chunk (tap, sub) of the taps patch matrix is the map's pixel
    (oy * sh + dy - ph0, ox * sw + dx - pw0) of image r // m_pad, zero
    outside the map and on pad rows: the address map of the operand."""
    from repro_torch.kernels.grid import tap_geometry, tap_row_pixels
    from repro_torch.kernels.sparse_conv import extract_patches
    B, H, W, cin, bk = 2, 13, 9, 16, 8
    x = torch.arange(1, B * H * W * cin + 1, dtype=torch.float32) \
        .reshape(B, H, W, cin)
    patches, (oh, ow) = extract_patches(x, k, k, stride, padding,
                                        strategy="taps")
    m_pad = oh * ow + 5
    g = tap_geometry(x.shape, k, k, stride, padding, m_pad=m_pad)
    flat = torch.nn.functional.pad(patches, (0, 0, 0, 5)).reshape(
        B * m_pad, -1)
    img, oy, ox, valid = tap_row_pixels(g, torch.arange(g.rows))
    assert int(valid.sum()) == B * oh * ow
    for c in range(g.k // bk):
        tap, sub = divmod(c, cin // bk)
        dy, dx = divmod(tap, k)
        iy, ix = oy * g.sh + dy - g.ph0, ox * g.sw + dx - g.pw0
        inside = valid & (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
        want = torch.zeros(g.rows, bk)
        want[inside] = x[img[inside], iy[inside], ix[inside],
                         sub * bk:(sub + 1) * bk]
        assert torch.equal(flat[:, c * bk:(c + 1) * bk], want), c


def test_tap_rows_past_m_img_at_vgg16_sizes():
    """VGG16's 56, 28 and 14 px maps against 128-row blocks: the tiles
    whose rows pass m_img hold only the image's last pixels (the next
    image's, which the im2col copy fetches there, are zeroed), and tiles of
    pad rows only walk nothing."""
    from repro_torch.kernels.grid import tap_geometry, tap_rows_real
    for px, real_last in ((56, 64), (28, 16), (14, 68)):
        m_img = px * px
        m_pad = m_img + (-m_img) % 128
        g = tap_geometry((4, px, px, 64), 3, 3, 1, "SAME", m_pad=m_pad)
        assert g.m_img == m_img and m_pad % 128 == 0 and m_pad > m_img
        last_block = m_pad - 128
        assert tap_rows_real(g, last_block, 128) == real_last
        for img in range(4):
            base = img * m_pad
            real = [tap_rows_real(g, base + r, 32)
                    for r in range(0, m_pad, 32)]
            assert sum(real) == m_img
            assert real[:m_img // 32] == [32] * (m_img // 32)
            assert all(r == 0 for r in real[-(-m_img // 32):])


def test_walk_im2col_problem_names_what_the_copies_refuse():
    from repro_torch.kernels.grid import tap_geometry, walk_im2col_problem
    g = tap_geometry((4, 56, 56, 128), 3, 3, 1, "SAME", m_pad=3200)
    x = torch.zeros(4, 56, 56, 128)
    w = [("vals", torch.zeros(4, 9, 128, 128))]
    assert walk_im2col_problem(x, g, w, 128, 128, 32) is None
    assert walk_im2col_problem(x.bfloat16(), g, w, 128, 64, 64) is None
    assert walk_im2col_problem(x, g, w, 10, 128, 32) is not None   # 40 B
    assert walk_im2col_problem(x, g, w, 128, 128, 512) is not None  # pixels
    assert walk_im2col_problem(x, g, w, 128, 6, 32) is not None    # w rows
    odd_w = [("vals", torch.zeros(4 * 9 * 128 * 128 + 1)[1:])]
    assert walk_im2col_problem(x, g, odd_w, 128, 128, 32) is not None
    g20 = tap_geometry((4, 9, 9, 20), 3, 3, 1, "SAME", m_pad=128)
    assert walk_im2col_problem(torch.zeros(4, 9, 9, 20).bfloat16(), g20, [],
                               4, 64, 32) is not None          # 40-byte px
    g9 = tap_geometry((1, 64, 64, 16), 3, 3, 9, "SAME", m_pad=64)
    assert walk_im2col_problem(torch.zeros(1, 64, 64, 16), g9, [], 16, 64,
                               32) is not None                 # stride 9
    gp = tap_geometry((1, 8, 8, 16), 3, 3, 1, ((200, 0), (0, 0)),
                      m_pad=1664)
    assert walk_im2col_problem(torch.zeros(1, 8, 8, 16), gp, [], 16, 64,
                               32) is not None                 # corner
    odd = torch.zeros(4 * 56 * 56 * 128 + 1)[1:].view(4, 56, 56, 128)
    assert walk_im2col_problem(odd, g, w, 128, 128, 32) is not None


def test_map_pixels_contiguous_takes_a_layer_output_view():
    """The tap-slab operand reads images of contiguous NHWC pixels any
    distance apart: a layer's output cut from its padded rows qualifies, a
    transposed or channel-sliced map does not."""
    from repro_torch.kernels.worklist_core import map_pixels_contiguous
    buf = torch.zeros(3, 14 * 14 + 60, 64)
    view = buf[:, :196].reshape(3, 14, 14, 64)
    assert not view.is_contiguous() and map_pixels_contiguous(view)
    assert map_pixels_contiguous(torch.zeros(2, 5, 7, 16))
    assert not map_pixels_contiguous(torch.zeros(2, 5, 7, 16).transpose(1, 2))
    assert not map_pixels_contiguous(torch.zeros(2, 5, 7, 32)[..., :16])
