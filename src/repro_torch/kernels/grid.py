"""Launch geometry of the grid kernels (``csrc/ffn_grid.cuh``) and of the
walker's tile mode (``csrc/walk.cu``), and host models of what their CTAs
compute before the first multiply.

One grid serves the predicated sparse matmul (K3), the fused FFN (K4), the
dense-grid conv (K2) and the walker's small-row-block mode (K1 at
``bm_rows`` dividing 32): 64-thread CTAs, each owning ``ROW_BLOCK`` rows x
``col_group`` columns of one n-block, 32-row blocks outermost in the launch.
The last 32-row block may be partial (rows past ``M`` are neither read nor
written), so a row block ``bm`` may divide 32 (several row blocks per CTA)
or be a multiple of it (several CTAs per row block).

:func:`count_partials` is the host model of the MAC counts each CTA adds,
and :func:`walk_lists` of the per-CTA live list the walker merges from the
work-list segments of the row blocks a CTA covers.

The walker's tile mode (K1 at ``bm_rows`` not dividing 32, VGG16's 128-row
blocks) owns one tile of one (n, m) pair per CTA: :func:`walk_tiles` picks
its rows x columns and the rows a thread owns from the pairs' shape and
depth and the SM count (:class:`WalkTiles`). Its tap-slab operand (lazy
im2col) reads x from the NHWC input map through the conv geometry
(:class:`TapGeometry`): :func:`tap_row_pixels` is the host model of its row
-> pixel map, :func:`tap_rows_real` of the rows a tile zeroes, and
:func:`walk_im2col_problem` says where its im2col tensor copies cannot go.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.core.sparse import normalize_stride, resolve_pads

ROW_BLOCK = 32
H100_SMS = 132

# The walker's tile mode (csrc/walk.cu)
WALK_KS = 32                      # k depth of a ring stage
WALK_STAGES = 2                   # ring stages of tensor copies
WALK_TILE_OUTPUTS = 4096          # outputs of a CTA tile
WALK_TILE_COLS = (128, 64, 32)
# 8 rows a thread where a CTA walks at least this many ring stages and the
# launch gives every SM this many warps of 8 x 8 threads
WALK_TM8_STAGES, WALK_TM8_WARPS = 24, 4


def check_row_block(M: int, bm: int) -> None:
    """The grid takes row blocks of a divisor or a multiple of 32 rows that
    tile ``M``."""
    if bm <= 0 or M % bm or (bm % ROW_BLOCK and ROW_BLOCK % bm):
        raise ValueError(f"the grid takes row blocks that divide or are a "
                         f"multiple of {ROW_BLOCK} rows and tile M, got "
                         f"M={M}, bm={bm}")


@dataclasses.dataclass(frozen=True)
class GridGeometry:
    """Launch geometry of the grid. Block ``b`` is numbered
    ``(row_block * nb + n) * groups + cg``, ``row_block`` counting 32-row
    blocks: outermost, so a decode step's busy blocks (the first rows of
    each row block) come first in the launch."""

    M: int
    nb: int
    bm: int
    bn: int
    col_group: int                # columns per block
    groups: int                   # column groups per n-block

    @property
    def row_tiles(self) -> int:
        """32-row blocks, the last one partial when 32 does not divide M."""
        return -(-self.M // ROW_BLOCK)

    @property
    def blocks(self) -> int:
        return self.row_tiles * self.nb * self.groups

    @property
    def per_tile(self) -> int:
        """Row blocks whose first row lies in one 32-row block."""
        return max(ROW_BLOCK // self.bm, 1)

    @property
    def counts_shape(self) -> Tuple[int, int, int, int]:
        """Shape of the per-block MAC counts, in launch order, by the row
        block (of those starting in the block) they are added to."""
        return (self.row_tiles, self.nb, self.groups, self.per_tile)

    def reduce_counts(self, partial: torch.Tensor) -> torch.Tensor:
        """Per-block counts summed to int32 ``[nb, mb]`` counts."""
        mb = self.M // self.bm
        p = partial.sum(2, dtype=torch.int32)        # [tiles, nb, per_tile]
        if self.bm >= ROW_BLOCK:
            p = p.reshape(mb, self.bm // ROW_BLOCK, self.nb).sum(
                1, dtype=torch.int32)
        else:
            p = p.permute(0, 2, 1).reshape(-1, self.nb)[:mb]
        return p.T.contiguous()

    def tiles(self) -> Iterator[Tuple[slice, slice]]:
        """(rows of x / out, columns of out) of every block, in launch
        order; the rows stop at M."""
        for b in range(self.blocks):
            b, cg = divmod(b, self.groups)
            rb, n = divmod(b, self.nb)
            c0 = n * self.bn + cg * self.col_group
            yield (slice(rb * ROW_BLOCK, min((rb + 1) * ROW_BLOCK, self.M)),
                   slice(c0, min(c0 + self.col_group, (n + 1) * self.bn)))


def grid_geometry(M: int, nb: int, *, bm: int, bn: int,
                  sms: int = H100_SMS) -> GridGeometry:
    """32-column groups when a decode step (live rows in the first 32 of a
    row block) still gets ``2 * sms`` busy blocks of 2 warps, one busy warp
    per SM scheduler; else 16-column groups, twice the blocks for the same
    columns. Wider groups give each thread more FMAs per shared-memory
    load."""
    check_row_block(M, bm)
    col = 32 if nb * -(-bn // 32) >= 2 * sms else 16
    return GridGeometry(M=M, nb=nb, bm=bm, bn=bn, col_group=col,
                        groups=-(-bn // col))


def count_partials(geom: GridGeometry, occ: torch.Tensor,
                   indices: torch.Tensor, *, sub_m: int,
                   two_sided: bool) -> torch.Tensor:
    """The kernel's count rule in plain PyTorch: the int32 MAC counts each
    block adds into ``counts[n, m]``, in ``geom.counts_shape``. Column group
    0 counts; two-sided, each occupied ``sub_m``-row sub-block of a stored
    chunk counts once, in the block of its first row; one-sided, each
    stored slot counts once per row block, in the block of its first
    row."""
    valid = indices >= 0
    if two_sided:
        # live[q, n]: stored slots of n-block n whose chunk is occupied in q
        ks = indices.clamp_min(0).long()
        live = (occ.bool()[:, ks] & valid).sum(-1, dtype=torch.int32)
        first = torch.arange(occ.shape[0], device=occ.device) * sub_m
    else:
        live = valid.sum(1, dtype=torch.int32).expand(geom.M // geom.bm, -1)
        first = torch.arange(geom.M // geom.bm, device=indices.device) \
            * geom.bm
    # (32-row block, row block within it) of each counted first row
    slot = first // ROW_BLOCK * geom.per_tile \
        + first % ROW_BLOCK // min(geom.bm, ROW_BLOCK)
    acc = torch.zeros((geom.row_tiles * geom.per_tile, geom.nb),
                      dtype=torch.int32, device=indices.device)
    acc.index_add_(0, slot, live)
    out = torch.zeros(geom.counts_shape, dtype=torch.int32,
                      device=indices.device)
    out[:, :, 0, :] = acc.reshape(geom.row_tiles, geom.per_tile,
                                  geom.nb).permute(0, 2, 1)
    return out


def walk_lists(pair_ptr: torch.Tensor, ks: torch.Tensor, js: torch.Tensor,
               *, nb: int, mb: int, bm_rows: int
               ) -> Dict[Tuple[int, int], List[Tuple[int, int, int]]]:
    """Host model of the live list a walker CTA merges (``csrc/ffn_grid.cuh``,
    ``bm_rows`` dividing 32) for one weight stream, whose step chunks are
    ``ks`` (-1 where the stream is dead). A CTA owns 32 rows of n-block
    ``n``, so the segments of the ``32 / bm_rows`` pairs ``(n, m)`` its rows
    cover: it keeps one entry per slot ``j`` some of them schedule live,
    with that slot's chunk and the 32-bit mask of the rows of those pairs,
    in ascending ``j``. Returns ``{(row_tile, n): [(j, chunk, mask), ...]}``
    for every CTA with a live entry."""
    ptr = pair_ptr.tolist()
    kl, jl = ks.tolist(), js.tolist()
    lists: Dict[Tuple[int, int], Dict[int, List[int]]] = {}
    for n in range(nb):
        for m in range(mb):
            row = m * bm_rows
            bits = ((1 << bm_rows) - 1) << (row % ROW_BLOCK)
            cta = lists.setdefault((row // ROW_BLOCK, n), {})
            for t in range(ptr[n * mb + m], ptr[n * mb + m + 1]):
                if kl[t] < 0:
                    continue
                ent = cta.setdefault(jl[t], [kl[t], 0])
                if ent[0] != kl[t]:
                    raise ValueError(f"slot {jl[t]} of n-block {n} names "
                                     f"chunks {ent[0]} and {kl[t]}")
                ent[1] |= bits
    return {key: [(j, c, mk) for j, (c, mk) in sorted(ents.items())]
            for key, ents in lists.items() if ents}


# csrc/ffn_grid.cuh: extra x columns of a box (and weight rows), rows of
# the one-tile layout, mbarriers a CTA keeps
GRID_PAD, GRID_TILE, GRID_MAX_STAGES = 8, 8, 6


def _grid_region(elem_bytes: int, col_group: int, bk: int):
    """``(stage, front, region)``: elements of a ring stage of ``rows`` x
    rows (a function), of the one-tile layout's fp32 operands, and of the
    shared region (``csrc/ffn_grid.cuh``'s ``region_elems``)."""
    def stage(rows):
        return rows * (bk + GRID_PAD) + (bk + GRID_PAD) * col_group
    wide_w = elem_bytes == 2 and col_group == 16
    front = (bk + GRID_PAD) * (GRID_TILE + (col_group if wide_w else 0)) \
        * 4 // elem_bytes
    region = max(2 * stage(ROW_BLOCK), front + 3 * stage(GRID_TILE))
    return stage, front, region


def ring_stages(elem_bytes: int, col_group: int, bk: int) -> Tuple[int, int]:
    """Ring stages (whole chunks) of a CTA in the 32-row and in the one-tile
    thread layout, as ``csrc/ffn_grid.cuh`` sizes its shared region."""
    stage, front, region = _grid_region(elem_bytes, col_group, bk)
    return (min(GRID_MAX_STAGES, region // stage(ROW_BLOCK)),
            min(GRID_MAX_STAGES, (region - front) // stage(GRID_TILE)))


def grid_smem_bytes(elem_bytes: int, col_group: int, bk: int,
                    slots: int) -> int:
    """Dynamic shared memory a grid launch asks for (``csrc/ffn_grid.cuh``'s
    ``smem_bytes``): 128 bytes of alignment, the shared region, and an
    ``int4`` and an ``int2`` for each of the ``slots`` (``max_nz``) slots
    of the CTA's live list."""
    return 128 + _grid_region(elem_bytes, col_group, bk)[2] * elem_bytes \
        + slots * (16 + 8)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's SM count (grid_geometry sizes the decode grid by it)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def lm_grid_problem(x: torch.Tensor, tensors, bk: int,
                    bn: int) -> Optional[str]:
    """Why the grid's tensor copies cannot take these operands (None when
    they can): they need bk and bn multiples of 8, bk at most 248 and bn at
    most 128, and 16-byte-aligned operands whose rows are a multiple of 16
    bytes."""
    if bk % 8 or bn % 8 or bk > 248 or bn > 128:
        return (f"the kernel takes bk and bn multiples of 8, bk <= 248 and "
                f"bn <= 128, got bk={bk}, bn={bn}")
    if x.shape[-1] * x.element_size() % 16:
        return f"x rows of {x.shape[-1]} elements are not a multiple of 16 " \
               f"bytes"
    for name, t in (("x", x), *tensors):
        if t is not None and t.data_ptr() % 16:
            return f"{name} is not 16-byte aligned"
    return None


def check_lm_grid(x: torch.Tensor, tensors, bk: int, bn: int) -> None:
    """Raise ``ValueError`` where :func:`lm_grid_problem` finds one."""
    problem = lm_grid_problem(x, tensors, bk, bn)
    if problem is not None:
        raise ValueError(problem)


@dataclasses.dataclass(frozen=True)
class WalkTiles:
    """Launch geometry of the walker's tile mode. A CTA owns ``rows`` x
    ``cols`` outputs of one (n, m) pair: ``slices`` tiles down a row block
    (the last one cut at ``bm``), ``groups`` across an n-block (the last one
    cut at ``bn``). Block ``b`` is numbered ``((m * nb + n) * slices + s) *
    groups + cg``, row block outermost. Each computing thread owns
    ``thread_rows`` x 8 outputs; a warp a band of ``band`` rows. ``tma``:
    a ring of ``WALK_STAGES`` stages of tensor copies, else plain copies
    into one stage."""

    M: int
    nb: int
    bm: int
    bn: int
    rows: int
    cols: int
    thread_rows: int
    tma: bool = True

    @property
    def mb(self) -> int:
        return self.M // self.bm

    @property
    def slices(self) -> int:
        return -(-self.bm // self.rows)

    @property
    def groups(self) -> int:
        return -(-self.bn // self.cols)

    @property
    def threads(self) -> int:
        """Threads of a CTA: the computing ones, and with tensor copies a
        warp that only issues them."""
        return self.rows * self.cols // (8 * self.thread_rows) \
            + (32 if self.tma else 0)

    @property
    def band(self) -> int:
        """Rows of a warp: its row groups (32 lanes over cols / 8 column
        lanes) times the rows a thread owns."""
        return self.thread_rows * 256 // self.cols

    @property
    def blocks(self) -> int:
        return self.mb * self.nb * self.slices * self.groups

    def tiles(self) -> Iterator[Tuple[slice, slice]]:
        """(rows of x / out, columns of out) each block stores, in launch
        order."""
        for b in range(self.blocks):
            b, cg = divmod(b, self.groups)
            b, s = divmod(b, self.slices)
            m, n = divmod(b, self.nb)
            r0 = m * self.bm + s * self.rows
            c0 = n * self.bn + cg * self.cols
            yield (slice(r0, min(r0 + self.rows, (m + 1) * self.bm)),
                   slice(c0, min(c0 + self.cols, (n + 1) * self.bn)))

    def describe(self) -> str:
        copies = (f"ring of {WALK_STAGES} stages of tensor copies"
                  if self.tma else "plain copies")
        return (f"tile mode: {self.blocks} CTAs of {self.rows}x{self.cols} "
                f"({self.threads} threads, {self.thread_rows}x8 a computing "
                f"thread, warp bands of {self.band} rows), {copies}")


def walk_tiles(M: int, nb: int, *, bm: int, bn: int, depth: float,
               sms: int = H100_SMS, gated: bool = False) -> WalkTiles:
    """The tile mode's geometry, a rule fitted to a sweep of every tile
    shape at VGG16 layers 1, 4, 8 and 10 on an H100:

    * CTA tiles of ``WALK_TILE_OUTPUTS`` outputs: the columns of
      ``WALK_TILE_COLS`` that cut the fewest from an n-block of ``bn``
      (the larger on a tie), rows the rest (32 at 128 columns, at least a
      warp band); at those layers the fastest tile of the sweep or close
      to it;
    * threads of 8 x 8 outputs where a CTA walks at least
      ``WALK_TM8_STAGES`` ring stages (``depth``: a pair's live chunks
      times its stages a chunk) and the launch gives every SM
      ``WALK_TM8_WARPS`` warps of them, else 4 x 8 (always for two
      streams, whose accumulators double): the 4-row threads' finer warp
      bands skip more zero rows and their CTAs hide the walk's start where
      a CTA is short (layers 1 and 4) or the launch small (layer 10); 8 x 8
      issues fewer loads a FMA, faster at layer 8.

    Raises ``ValueError`` for a row block that does not tile M or bn outside
    1..128."""
    if bm <= 0 or M % bm or bn <= 0 or bn > 128:
        raise ValueError(f"the tile mode takes row blocks that tile M and "
                         f"bn <= 128, got M={M}, bm={bm}, bn={bn}")
    cols = min(WALK_TILE_COLS, key=lambda c: (-(-bn // c) * c - bn, -c))
    rows = WALK_TILE_OUTPUTS // cols
    mb, groups = M // bm, -(-bn // cols)
    warps8 = mb * nb * -(-bm // rows) * groups * rows * cols // (64 * 32)
    tm = 8 if (not gated and depth >= WALK_TM8_STAGES
               and warps8 >= WALK_TM8_WARPS * sms) else 4
    band = tm * 256 // cols
    return WalkTiles(M=M, nb=nb, bm=bm, bn=bn, rows=max(rows, band),
                     cols=cols, thread_rows=tm)


def tile_smem_bytes(tiles: WalkTiles, elem_bytes: int, max_nz: int) -> int:
    """Dynamic shared memory a tile-mode launch asks for (``csrc/walk.cu``,
    ``launch_tile_ct``): 1024 bytes of alignment, the ring (``WALK_STAGES``
    stages with tensor copies, else one) of ``rows x WALK_KS`` x and
    ``WALK_KS x cols`` weight elements, the CTA's live list (two ``int2`` a
    slot) and each warp band's fp32 copy of x (``WALK_KS + 1`` k of
    ``band + 4`` floats). The kernel's static shared memory (under 1 KB)
    comes on top."""
    stage = tiles.rows * WALK_KS + WALK_KS * tiles.cols
    stages = WALK_STAGES if tiles.tma else 1
    xt = (WALK_KS + 1) * (tiles.band + 4)
    return 1024 + stages * stage * elem_bytes + 2 * max(max_nz, 1) * 8 \
        + tiles.rows // tiles.band * xt * 4


def walk_tma_problem(x: torch.Tensor, tensors, bn: int,
                     bk: int) -> Optional[str]:
    """Why the tile mode's tensor copies cannot take these operands (None
    when they can): x rows and weight rows a multiple of 16 bytes, every
    operand 16-byte aligned, and chunks of a multiple of 16 bytes, so that
    every box of x starts 16-byte aligned (an H100 stops a swizzled box
    that does not with an illegal instruction)."""
    eb = x.element_size()
    if x.shape[-1] * eb % 16:
        return f"x rows of {x.shape[-1]} elements are not a multiple of 16 " \
               f"bytes"
    if bk * eb % 16:
        return f"chunks of {bk} elements are not a multiple of 16 bytes"
    if bn * eb % 16:
        return f"weight rows of {bn} elements are not a multiple of 16 bytes"
    for name, t in (("x", x), *tensors):
        if t is not None and t.data_ptr() % 16:
            return f"{name} is not 16-byte aligned"
    return None


# ---------------------------------------------------------------------------
# The tile mode's tap-slab operand (lazy im2col)
# ---------------------------------------------------------------------------
# What one im2col tensor copy takes (cuTensorMapEncodeIm2col, a rank-4 map):
# at most this many pixels a column, element strides 1..8 and box corners
# in a signed byte
IM2COL_PIXELS = 256
IM2COL_STRIDES = 8
IM2COL_CORNER = 128


@dataclasses.dataclass(frozen=True)
class TapGeometry:
    """The conv geometry through which the walker's tile mode reads x
    straight from the NHWC input map ``[B, H, W, cin]`` (lazy im2col, the
    ``layout="tap"`` packing): output row ``r`` is pixel ``p = r % m_pad``
    of image ``r // m_pad``, a real pixel when ``p < m_img``; K-chunk
    ``c = tap * (cin / bk) + sub`` of it is channels ``sub * bk ..`` of the
    input pixel ``(oy * sh + dy - ph0, ox * sw + dx - pw0)``, ``(dy, dx) =
    divmod(tap, kw)``, zero outside the map."""

    B: int
    H: int
    W: int
    cin: int
    kh: int
    kw: int
    sh: int
    sw: int
    ph0: int
    ph1: int
    pw0: int
    pw1: int
    m_pad: int

    @property
    def oh(self) -> int:
        return (self.H + self.ph0 + self.ph1 - self.kh) // self.sh + 1

    @property
    def ow(self) -> int:
        return (self.W + self.pw0 + self.pw1 - self.kw) // self.sw + 1

    @property
    def m_img(self) -> int:
        return self.oh * self.ow

    @property
    def rows(self) -> int:
        """Rows of the output: every image's ``m_pad``."""
        return self.B * self.m_pad

    @property
    def k(self) -> int:
        """Columns of the patch matrix the map stands for."""
        return self.kh * self.kw * self.cin


def tap_geometry(shape, kh: int, kw: int, stride, padding, *,
                 m_pad: int) -> TapGeometry:
    """The :class:`TapGeometry` of a conv over an NHWC map of ``shape``."""
    B, H, W, cin = (int(v) for v in shape)
    sh, sw = normalize_stride(stride)
    (ph0, ph1), (pw0, pw1) = resolve_pads((H, W), kh, kw, stride, padding)
    g = TapGeometry(B, H, W, cin, kh, kw, sh, sw, ph0, ph1, pw0, pw1, m_pad)
    if m_pad < g.m_img:
        raise ValueError(f"m_pad={m_pad} is below the {g.m_img} output "
                         f"pixels of an image")
    return g


def tap_row_pixels(geom: TapGeometry, rows: torch.Tensor
                   ) -> Tuple[torch.Tensor, ...]:
    """Host model of the row -> pixel map: ``(img, oy, ox, valid)`` of each
    output row (``oy``, ``ox`` 0 where the row is a pad row)."""
    img = rows // geom.m_pad
    p = rows % geom.m_pad
    valid = p < geom.m_img
    p = torch.where(valid, p, torch.zeros_like(p))
    return img, p // geom.ow, p % geom.ow, valid


def tap_rows_real(geom: TapGeometry, row_base: int, rows: int) -> int:
    """How many of the ``rows`` rows from ``row_base`` (all in one image,
    as a tile of one row block is) are real pixels; the walker zeroes the
    rest (and, at 0, skips the tile's walk)."""
    p0 = row_base % geom.m_pad
    return max(0, min(rows, geom.m_img - p0))


def walk_im2col_problem(x: torch.Tensor, geom: TapGeometry, tensors,
                        bk: int, bn: int, rows: int) -> Optional[str]:
    """Why the tile mode's tensor copies cannot take this map and these
    weights (None when they can): ``bk`` and a stage's ``WALK_KS`` channels
    a multiple of 16 bytes, the map's pixels (``cin`` channels) a multiple
    of 16 bytes and its images 16-byte aligned, at most ``IM2COL_PIXELS``
    rows a tile, strides 1..8 and the window's corners within a signed byte
    (the im2col copies of x); weight rows a multiple of 16 bytes and the
    weights 16-byte aligned (their tiled copies)."""
    eb = x.element_size()
    if bn * eb % 16:
        return f"weight rows of {bn} elements are not a multiple of 16 bytes"
    for name, t in tensors:
        if t is not None and t.data_ptr() % 16:
            return f"{name} is not 16-byte aligned"
    if bk * eb % 16 or WALK_KS * eb % 16:
        return f"a chunk of {bk} channels is not a multiple of 16 bytes"
    if geom.cin * eb % 16:
        return f"pixels of {geom.cin} channels are not a multiple of 16 " \
               f"bytes"
    if x.data_ptr() % 16 or (x.shape[0] > 1 and x.stride(0) * eb % 16):
        return "the map's images are not 16-byte aligned"
    if rows > IM2COL_PIXELS:
        return f"a tile of {rows} rows is more than {IM2COL_PIXELS} pixels"
    if not (1 <= geom.sh <= IM2COL_STRIDES and 1 <= geom.sw <= IM2COL_STRIDES):
        return f"strides ({geom.sh}, {geom.sw}) are outside 1..8"
    corners = (-geom.pw0, -geom.ph0, geom.pw1 - (geom.kw - 1),
               geom.ph1 - (geom.kh - 1), geom.kw - 1, geom.kh - 1)
    if any(not -IM2COL_CORNER <= c < IM2COL_CORNER for c in corners):
        return f"the window's corners {corners} do not fit a signed byte"
    return None
