"""A CPU model of K3's tile design (``csrc/cc.cu::cc_tile_kernel``) held
exactly against JAX's ``connected_components`` and the port's plain version.

The model runs the kernel's three phases on numpy arrays, step for step:
Phase A builds each tile's local forest (each pixel starts at the last pixel
of its run in the row, then one union per pair of runs that touch vertically
or diagonally, with the kernel's skips; every pixel then points at its local
root) and
writes the parent words -(g) - 1 of the tile's edge pixels and local roots
into the output plane; Phase B unites each tile's top- and left-edge pixels
with their neighbours across the edge (and across the corners for
connectivity 2) through those words; Phase C finds each local root's root
(a positive word is a final id) and writes every pixel's id.  Unions and
tiles run in a shuffled order, as the card's blocks and atomics may, and
every word that Phase A leaves unwritten holds a sentinel that a read
rejects.  The model runs with one tile a block and with fewer blocks than
tiles (Phase C rebuilds the local forest), at tile sizes 8 (so small masks
cross many tiles) and the kernel's 32 and 64.  The kernel itself is held against the plain version
on the card (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from microbeseg_tpu.ops.cc import connected_components as jax_cc
from microbeseg_torch.ops import cc as tcc

UNWRITTEN = np.iinfo(np.int64).min


class _Words:
    """The output plane as the kernel uses it: parent words, then ids."""

    def __init__(self, n):
        self.w = np.full(n, UNWRITTEN, np.int64)

    def read(self, x):
        v = int(self.w[x])
        assert v != UNWRITTEN, f"read of the unwritten word {x}"
        return v

    def cas(self, x, expected, new):
        old = self.read(x)
        if old == expected:
            self.w[x] = new
        return old


def _enc(g):
    return -g - 1


def _sfind(sp, x):
    while sp[x] != x:
        p = sp[x]
        if sp[p] != p:
            sp[x] = sp[p]   # halving
        x = p
    return x


def _sunite(sp, a, b):
    a, b = _sfind(sp, a), _sfind(sp, b)
    if a != b:
        sp[min(a, b)] = max(a, b)


def _gfind(w, x):
    while True:
        p = -w.read(x) - 1
        assert p >= 0, "Phase B reads a final id"
        if p == x:
            return x
        v2 = w.read(p)
        if -v2 - 1 != p:
            w.cas(x, _enc(p), v2)
        x = p


def _gunite(w, a, b):
    while True:
        a, b = _gfind(w, a), _gfind(w, b)
        if a == b:
            return
        a, b = max(a, b), min(a, b)
        if w.cas(b, _enc(b), _enc(a)) == _enc(b):
            return


def _gresolve(w, x, base):
    while True:
        v = w.read(x)
        if v > 0:
            return v
        p = -v - 1
        if p == x:
            return x - base + 1
        v2 = w.read(p)
        if v2 > 0:
            return v2
        if -v2 - 1 != p:
            w.cas(x, v, v2)
        x = p


class TileModel:
    """``cc_tile_kernel`` on numpy: ``run()`` returns the (B, H, W) ids."""

    def __init__(self, mask, connectivity, tile, n_blocks=None, seed=0):
        self.mask = np.ascontiguousarray(mask, bool)
        self.B, self.H, self.W = self.mask.shape
        self.flat = self.mask.reshape(-1)
        self.diag = connectivity == 2
        self.T = tile
        self.tiles_x = -(-self.W // tile)
        self.tiles_per_image = -(-self.H // tile) * self.tiles_x
        self.n_tiles = self.B * self.tiles_per_image
        self.n_blocks = min(self.n_tiles, n_blocks or self.n_tiles)
        self.rng = np.random.default_rng(seed)

    def tile(self, t):
        """(y0, x0, th, tw, base) of tile t, as ``cc_tile``."""
        img, r = divmod(t, self.tiles_per_image)
        y0, x0 = (r // self.tiles_x) * self.T, (r % self.tiles_x) * self.T
        return (y0, x0, min(self.T, self.H - y0), min(self.T, self.W - x0),
                img * self.H * self.W)

    def glob(self, c, li):
        y0, x0, _, _, base = c
        return base + (y0 + li // self.T) * self.W + x0 + li % self.T

    def local_forest(self, c):
        """sp: -1 background, else the pixel's local root.  Each pixel
        starts at the last pixel of its run in the row; one union per pair
        of runs that touch vertically (or diagonally), between run ends."""
        T = self.T
        y0, x0, th, tw, base = c
        fg = np.zeros((T, T), bool)
        fg[:th, :tw] = self.mask[base // (self.H * self.W),
                                 y0:y0 + th, x0:x0 + tw]

        bits = [sum(1 << x for x in range(T) if fg[ly, x])
                for ly in range(T)]

        def end(ly, lx):
            """The run end of the foreground pixel (ly, lx), by the
            kernel's bit arithmetic: before the first clear bit from lx on,
            or the row's last column when there is none."""
            clear = ~(bits[int(ly)] >> int(lx)) & ((1 << 64) - 1)
            n = (clear & -clear).bit_length()   # __ffsll: 0 for none
            return ly * T + (lx + n - 2 if n else T - 1)

        sp = np.full(T * T, -1, np.int64)
        for ly, lx in zip(*np.nonzero(fg)):
            sp[ly * T + lx] = end(ly, lx)
        for li in self.rng.permutation(np.arange(T, T * T)):
            ly, lx = divmod(li, T)
            if not fg[ly, lx]:
                continue
            up = fg[ly - 1, lx]
            left = lx > 0 and fg[ly, lx - 1]
            up_left = lx > 0 and fg[ly - 1, lx - 1]
            e = end(ly, lx)
            if up:
                if not (left and up_left):
                    _sunite(sp, e, end(ly - 1, lx))
            elif self.diag:
                if up_left and not left:
                    _sunite(sp, e, end(ly - 1, lx - 1))
                if lx < T - 1 and fg[ly - 1, lx + 1] and not fg[ly, lx + 1]:
                    _sunite(sp, e, end(ly - 1, lx + 1))
        # run ends to their roots, then every pixel to its run end's root
        ends = [li for li in range(T * T) if sp[li] >= 0
                and (li % T == T - 1 or not fg[li // T, li % T + 1])]
        for li in ends:
            sp[li] = _sfind(sp, li)
        for li in range(T * T):
            if sp[li] >= 0:
                sp[li] = sp[sp[li]]
        return sp

    def border_pairs(self, c):
        """Phase B's unions of one tile, (p, q) global indices."""
        y0, x0, th, tw, base = c
        W, H, m = self.W, self.H, self.flat
        pairs = []
        if y0 > 0:
            for i in range(tw):
                x = x0 + i
                p = base + y0 * W + x
                if not m[p]:
                    continue
                up = bool(m[p - W])
                if up:
                    pairs.append((p, p - W))
                if self.diag and not up:
                    if x > 0 and not m[p - 1] and m[p - W - 1]:
                        pairs.append((p, p - W - 1))
                    if x < W - 1 and not m[p + 1] and m[p - W + 1]:
                        pairs.append((p, p - W + 1))
        if x0 > 0:
            for ly in range(th):
                y = y0 + ly
                p = base + y * W + x0
                if not m[p]:
                    continue
                left = bool(m[p - 1])
                if left:
                    pairs.append((p, p - 1))
                if self.diag and not left:
                    if y > 0 and not m[p - W] and m[p - W - 1]:
                        pairs.append((p, p - W - 1))
                    if y < H - 1 and not m[p + W] and m[p + W - 1]:
                        pairs.append((p, p + W - 1))
        return pairs

    def run(self):
        T = self.T
        w = _Words(self.B * self.H * self.W)
        rebuild = self.n_tiles > self.n_blocks
        kept = {}
        # Phase A, the tiles in a shuffled order
        for t in self.rng.permutation(self.n_tiles):
            c = self.tile(t)
            sp = self.local_forest(c)
            if not rebuild:
                kept[t] = sp
            for li in range(T * T):
                r = sp[li]
                if r < 0:
                    continue
                ly, lx = divmod(li, T)
                if (r == li or ly == 0 or lx == 0 or ly == c[2] - 1
                        or lx == c[3] - 1):
                    w.w[self.glob(c, li)] = _enc(self.glob(c, r))
        # Phase B, every tile's border unions in a shuffled order
        pairs = [pq for t in range(self.n_tiles)
                 for pq in self.border_pairs(self.tile(t))]
        for k in self.rng.permutation(len(pairs)):
            _gunite(w, *pairs[k])
        # Phase C, tile by tile in a shuffled order
        for t in self.rng.permutation(self.n_tiles):
            c = self.tile(t)
            sp = kept[t] if not rebuild else self.local_forest(c)
            ids = {}
            for li in range(T * T):
                if sp[li] == li:
                    ids[li] = _gresolve(w, self.glob(c, li), c[4])
            for li in range(T * T):
                ly, lx = divmod(li, T)
                if ly < c[2] and lx < c[3]:
                    w.w[self.glob(c, li)] = 0 if sp[li] < 0 else ids[sp[li]]
        out = w.w.reshape(self.B, self.H, self.W)
        assert (out != UNWRITTEN).all()
        return out.astype(np.int32)


# ---------------------------------------------------------------------------
# the masks


def _spiral(H, W):
    """A square spiral of 1-pixel arms, 2 pixels apart."""
    m = np.zeros((H, W), bool)
    top, left, bottom, right = 1, 1, H - 2, W - 2
    y, x = top, left
    while top <= bottom and left <= right:
        m[top, left:right + 1] = True
        m[top:bottom + 1, right] = True
        if bottom - top >= 2:
            m[bottom, left:right + 1] = True
        if right - left >= 2:
            m[top + 2:bottom + 1, left] = True
        top, left, bottom, right = top + 2, left + 2, bottom - 2, right - 2
        if top <= bottom and left <= right:
            m[top - 1, left] = True   # the step inwards
    return m


def _snake(H, W):
    """A serpentine: rows 1, 4, 7, ... joined at alternating ends."""
    m = np.zeros((H, W), bool)
    rows = list(range(1, H - 1, 3))
    for k, y in enumerate(rows):
        m[y, 1:W - 1] = True
        if k + 1 < len(rows):
            x = W - 2 if k % 2 == 0 else 1
            m[y:rows[k + 1] + 1, x] = True
    return m


def _checkerboard(H, W, tile):
    """Tiles on and off in a checkerboard: on tiles meet only at corners,
    so 4- and 8-connectivity differ only across the tile corners."""
    yy, xx = np.mgrid[0:H, 0:W]
    return (yy // tile + xx // tile) % 2 == 0


def _diagonal_checkerboard(H, W, tile):
    """The checkerboard, plus a main diagonal and an anti-diagonal of single
    pixels that run through off tiles and cross between them at tile
    corners, where only 8-connectivity joins them."""
    yy, xx = np.mgrid[0:H, 0:W]
    return (_checkerboard(H, W, tile) | ((yy - xx) == tile)
            | ((yy + xx) == 2 * tile - 1))


MASKS = {
    "seeded": lambda tile: np.random.default_rng(7).random((2, 40, 52)) < 0.55,
    "spiral": lambda tile: _spiral(70, 66)[None],
    "snake": lambda tile: _snake(67, 75)[None],
    "diagonal_checkerboard": lambda tile: _diagonal_checkerboard(
        2 * tile + 5, 3 * tile - 3, tile)[None],
    "all_on": lambda tile: np.ones((1, 30, 46), bool),
    "empty": lambda tile: np.zeros((1, 30, 46), bool),
    "ragged_30x46": lambda tile: np.random.default_rng(8).random(
        (1, 30, 46)) < 0.6,
    "ragged_12x70": lambda tile: np.random.default_rng(9).random(
        (1, 12, 70)) < 0.6,
    "batch_3": lambda tile: np.stack([
        _snake(33, 41), np.random.default_rng(10).random((33, 41)) < 0.5,
        _spiral(33, 41)]),
}


def _jax(mask, connectivity):
    return np.stack([np.asarray(jax_cc(jnp.asarray(m),
                                       connectivity=connectivity))
                     for m in mask])


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("tile", [8, 32, 64])
@pytest.mark.parametrize("case", sorted(MASKS))
def test_tile_model_matches_jax_and_plain(case, tile, connectivity):
    mask = MASKS[case](tile)
    want = _jax(mask, connectivity)
    np.testing.assert_array_equal(
        tcc.connected_components_plain(torch.from_numpy(mask),
                                       connectivity).numpy(), want)
    model = TileModel(mask, connectivity, tile, seed=tile + connectivity)
    np.testing.assert_array_equal(model.run(), want)
    # fewer blocks than tiles: Phase C rebuilds each local forest
    if model.n_tiles > 1:
        fewer = TileModel(mask, connectivity, tile, n_blocks=2, seed=3)
        np.testing.assert_array_equal(fewer.run(), want)


def test_masks_cross_tiles_and_corners():
    """The crafted masks do what their names say at tile 8."""
    # a single component that crosses every tile border of its frame
    for make in (_spiral, _snake):
        m = make(40, 48)
        ids = _jax(m[None], 1)[0]
        assert len(np.unique(ids[m])) == 1
        for k in range(8, 40, 8):
            assert (m[k - 1] & m[k]).any()
        for k in range(8, 48, 8):
            assert (m[:, k - 1] & m[:, k]).any()
    # the checkerboard alone: no pair of pixels 4-adjacent across a tile
    # edge, so 4-connectivity keeps each tile apart and 8 joins them at the
    # corners; the diagonals add components that only 8 joins
    m = _checkerboard(21, 21, 8)
    for k in (8, 16):
        assert not (m[k - 1] & m[k]).any() and not (m[:, k - 1] & m[:, k]).any()
    assert len(np.unique(_jax(m[None], 1))) - 1 == 5
    assert len(np.unique(_jax(m[None], 2))) - 1 == 1
    m = _diagonal_checkerboard(21, 21, 8)
    assert len(np.unique(_jax(m[None], 1))) - 1 > 5
    assert len(np.unique(_jax(m[None], 2))) - 1 == 1


def test_model_rejects_an_unwritten_word():
    """The sentinel is live: a find that reaches an unwritten word fails."""
    w = _Words(4)
    w.w[1] = _enc(2)
    with pytest.raises(AssertionError, match="unwritten word 2"):
        _gfind(w, 1)
