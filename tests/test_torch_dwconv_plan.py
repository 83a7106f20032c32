"""The launch plan of csrc/dwconv.cu (rcot_torch/ops/dwconv.py), on the CPU.

dwconv_tile and dwconv_rows cut a depthwise convolution into blocks of
`tc` columns by `cv` channel vectors, each walking a band of `rows` rows,
and the kernels take the pieces as they are: the forward and dx with the
plan as it is, dtaps with its bands capped at DTAPS_MAX_PIXELS pixels a
block and one partial of 9C floats per (image, band, column tile) in its
workspace. These tests hold the plan at every block shape of
chip_smoke.py, at both widths the depthwise tier runs (3C and the GDFN's
2h), and at odd ones, on several cards (SMs, and blocks an SM holds): the
pieces cover every column, channel and row once with none empty, a block
has at most 256 threads, dtaps's blocks hold the cap, and the blocks come
to at most DW_BLOCKS_PER_SM an SM where any bands allow it (the most
such, on the longest bands), else fill the card's waves as the plan
states; the workspace holds one partial per block range.
"""

import pytest

import chip_smoke
from rcot_torch.ops import dwconv as tdw

H100_SMS = 132
# (SMs, blocks an SM holds): an H100 at 3, 5 or 8 (the kernels' registers
# decide), and odd cards
CARDS = ((H100_SMS, 3), (H100_SMS, 5), (H100_SMS, 8), (1, 1), (7, 2), (200, 3))

# (b, h, w, c) of every depthwise shape of chip_smoke.py's serving (B = 1)
# and training (B = 3) paths, at 3C and at 2h
MAIN = [(b, res, res, width) for b, shapes in ((1, chip_smoke.MAIN_SHAPES),
                                               (chip_smoke.TRAIN_B, chip_smoke.TRAIN_SHAPES))
        for _, res, c, _ in shapes for width in (3 * c, 2 * int(c * 2.66))]
ODD = [(1, 20, 19, 6), (1, 9, 33, 1021), (1, 1, 1, 5), (2, 7, 5, 1), (3, 11, 29, 255),
       (1, 13, 37, 2042), (2, 19, 23, 144), (8, 600, 600, 144), (1, 1, 300, 3),
       (4, 250, 321, 510), (1, 3, 1, 4096)]


def _covered_once(total, pieces, per):
    """`pieces` runs of `per` cover [0, total) once, the last one not empty."""
    assert pieces >= 1 and per >= 1
    assert per * (pieces - 1) < total <= per * pieces


@pytest.mark.parametrize("max_pixels", [0, tdw.DTAPS_MAX_PIXELS], ids=["fwd", "dtaps"])
@pytest.mark.parametrize("b,h,w,c", sorted(set(MAIN)) + ODD)
def test_the_plan_covers_every_pixel_and_channel_once_within_its_limits(b, h, w, c,
                                                                        max_pixels):
    vec = tdw.dwconv_vec(c)
    assert c % vec == 0 and vec == (4 if c % 4 == 0 else 2 if c % 2 == 0 else 1)
    cv, tc = tdw.dwconv_tile(c, w, vec)
    assert 1 <= cv <= tdw.DW_VECTORS and 1 <= tc * cv <= tdw.DW_THREADS
    tiles, chunks = -(-w // tc), -(-(c // vec) // cv)
    _covered_once(w, tiles, tc)
    _covered_once(c // vec, chunks, cv)
    most = min(h, max_pixels // tc) if max_pixels else h
    # every band length the plan may take, and its blocks
    runs = {-(-h // n) for n in range(-(-h // most), -(-h // min(tdw.DW_MIN_ROWS, most)) + 1)}
    blocks_of = {r: b * tiles * chunks * -(-h // r) for r in runs}
    for n_sm, per_sm in CARDS:
        rows = tdw.dwconv_rows(b, h, w, c, vec, n_sm, per_sm, max_pixels)
        assert rows in runs
        bands = -(-h // rows)
        _covered_once(h, bands, rows)
        if max_pixels:
            assert tc * rows <= max_pixels
        dense = min(tdw.DW_BLOCKS_PER_SM, per_sm) * n_sm
        fitting = [r for r, n in blocks_of.items() if n <= dense]
        if fitting:
            assert blocks_of[rows] == max(blocks_of[r] for r in fitting)
            assert rows == max(r for r in fitting if blocks_of[r] == blocks_of[rows])
        else:
            wave = per_sm * n_sm
            fill = {r: n / (-(-n // wave) * wave) for r, n in blocks_of.items()}
            assert fill[rows] >= min(tdw.DW_WAVE_FILL, max(fill.values()))
        assert tdw.dtaps_workspace_numel(b, h, w, c, tc, rows) == b * bands * tiles * 9 * c


@pytest.mark.parametrize("c,ptrs,vec", [(144, (0, 256), 4), (144, (0, 8), 2),
                                        (144, (4, 0), 1), (2042, (0,), 2), (255, (0,), 1),
                                        (6, (8, 16), 2), (1, (0,), 1)])
def test_the_copy_width_divides_c_and_every_pointer(c, ptrs, vec):
    assert tdw.dwconv_vec(c, *ptrs) == vec


def test_the_main_path_plans():
    """At train L1, 3C = 144 (36 vectors of 16 bytes: two chunks of 18, 14
    columns a block, ten column tiles), six bands of 22 rows give 360
    blocks, up to three an SM of 132, for the forward, dx and dtaps alike
    (22 x 14 pixels a block is under the cap); dtaps then sums 3 x 6 x 10
    partials. At the training latent (16^2, 1,152 channels) the bands stop
    at four rows: 216 blocks. At serve decoder L1, 2h = 510 (255 vectors
    of 8 bytes: eight chunks of 32, 32 column tiles), one band is 256
    blocks and two would pass three an SM, so a card that holds five an SM
    takes one band of 256 rows; at serve L1, 2h = 254, three bands of 86
    rows make 384 blocks. Batch 8 at serve L1, 3C, is one band of 304
    blocks."""
    assert tdw.dwconv_tile(144, 128, 4) == (18, 14)
    assert tdw.dwconv_rows(3, 128, 128, 144, 4, H100_SMS, 3) == 22
    assert tdw.dwconv_rows(3, 128, 128, 144, 4, H100_SMS, 3, tdw.DTAPS_MAX_PIXELS) == 22
    assert tdw.dtaps_workspace_numel(3, 128, 128, 144, 14, 22) == 180 * 9 * 144
    assert tdw.dwconv_tile(1152, 16, 4) == (32, 8)
    assert tdw.dwconv_rows(3, 16, 16, 1152, 4, H100_SMS, 3) == 4
    assert tdw.dwconv_tile(510, 256, 2) == (32, 8)
    assert tdw.dwconv_rows(1, 256, 256, 510, 2, H100_SMS, 5) == 256
    assert tdw.dwconv_rows(1, 256, 256, 254, 2, H100_SMS, 5) == 86
    assert tdw.dwconv_rows(8, 256, 256, 144, 4, H100_SMS, 3) == 256
