"""The launch plans of csrc/gram.cu (rcot_torch/ops/gram.py), on the CPU.

Each plan cuts a kernel's work into contiguous pieces by the card's SM
count, and the kernel takes the pieces as they are: the pixel ranges of
each (b, head) of the Gram forward and of the apply backward's dattn sum
(gram_plan), and the runs of tiles of the apply forward (apply_plan) and
of the Gram backward (gram_bwd_plan). These tests hold each at every
block shape of chip_smoke.py and at odd ones, for several SM counts: the
pieces cover the work exactly once with none empty, in whole kernel
stages, and the blocks stay within the waves each design states. The
workspaces are one partial per range when a (b, head) is split (G | nq | nk
for the Gram, dattn for the apply backward), and none otherwise. A head
wider than 128 channels runs as channel blocks (channel_blocks) in a grid
of block pairs: the blocks cover the head once, at most 128 channels each;
the pairs count as heads for the Gram's ranges and share the card's SMs
for the runs of tiles; a sum over blocks takes one slot per block; and a
head of ch <= 128 keeps the plans it had before it could be cut.
"""

import pytest

import chip_smoke
from rcot_torch.ops import gram as tgram

H100_SMS = 132
SM_COUNTS = (H100_SMS, 1, 7, 200)

# (b, hw, heads, ch) of every block shape of chip_smoke.py's serving (B = 1)
# and training (B = 3) paths
MAIN = [(1, res * res, heads, c // heads) for _, res, c, heads in chip_smoke.MAIN_SHAPES]
MAIN += [(chip_smoke.TRAIN_B, res * res, heads, c // heads)
         for _, res, c, heads in chip_smoke.TRAIN_SHAPES]
ODD = [(2, 9, 2, 5), (2, 33 * 7, 4, 24), (3, 33 * 7, 1, 5), (3, 257, 3, 48),
       (1, 1, 1, 1), (1, 64 * 64, 1, 128), (2, 16 * 16, 4, 96), (3, 8 * 9, 1, 128),
       (1, 65536, 8, 48), (3, 100_000, 1, 24), (4, 1000, 64, 8), (1, 131, 2, 7)]


def _tiles_once(work, pieces, per):
    """`pieces` runs of `per` cover [0, work) once, the last one not empty."""
    assert pieces >= 1 and per >= 1
    assert per * (pieces - 1) < work <= per * pieces


def test_the_main_path_shapes_are_the_sixteen_of_chip_smoke():
    """(L3 and noise_level2 share a shape, as do their training twins.)"""
    assert len(MAIN) == 16 and len(set(MAIN)) == 14


@pytest.mark.parametrize("b,hw,heads,ch", sorted(set(MAIN)) + ODD)
def test_every_plan_covers_its_work_once_within_its_waves(b, hw, heads, ch):
    bh = b * heads
    for n_sm in SM_COUNTS:
        splits, per = tgram.gram_plan(b, hw, heads, n_sm)
        _tiles_once(hw, splits, per)
        n = tgram.GRAM_BLOCKS_PER_SM * n_sm
        assert per <= tgram.GRAM_MAX_PIXELS
        if per < tgram.GRAM_MAX_PIXELS:
            assert splits == 1 if bh >= n else splits * bh <= n + bh - 1
        assert splits == 1 or per % tgram.GRAM_PIXEL_STEP == 0
        assert tgram.gram_workspace_numel(splits, b, heads, ch) == (
            0 if splits == 1 else splits * bh * (ch * ch + 2 * ch))

        tiles = bh * -(-hw // tgram.APPLY_TILE)
        blocks, per = tgram.apply_plan(b, hw, heads, ch, n_sm)
        _tiles_once(tiles, blocks, per)
        assert blocks <= (2 if ch <= tgram.APPLY_TWO_MAX_CH else 1) * n_sm

        tiles = bh * -(-hw // tgram.GRAM_BWD_TILE)
        blocks, per = tgram.gram_bwd_plan(b, hw, heads, ch, n_sm)
        _tiles_once(tiles, blocks, per)
        assert blocks <= (2 if ch <= tgram.GRAM_BWD_TWO_MAX_CH else 1) * n_sm
        # the apply backward's dattn ranges are the Gram's, in whole tiles
        splits, per = tgram.gram_plan(b, hw, heads, n_sm)
        assert splits == 1 or per % tgram.GRAM_BWD_TILE == 0
        assert tgram.apply_bwd_workspace_numel(splits, b, heads, ch) == (
            0 if splits == 1 else splits * bh * ch * ch)


def test_the_large_shapes_fill_the_card():
    """At the 256^2 level-1 shapes (one head) the Gram's ranges give every
    SM one block but four; at the training latent (24 pairs of 256 pixels)
    each pair splits into four 64-pixel ranges, and a pair that alone
    fills the card is not split, so it needs no workspace. Batch 8 at L1
    would give ranges of 3,904 pixels: they are cut to 512. The apply at
    serve L1 (512 tiles, ch = 48) runs 256 blocks of two tiles, at decoder
    L1 (ch = 96) 128 blocks of four."""
    assert tgram.gram_plan(1, 256 * 256, 1, H100_SMS) == (128, 512)
    assert tgram.gram_plan(3, 16 * 16, 8, H100_SMS) == (4, 64)
    assert tgram.gram_workspace_numel(4, 3, 8, 48) == 4 * 24 * (48 * 48 + 96)
    assert tgram.gram_plan(3, 16 * 16, 44, H100_SMS) == (1, 256)
    assert tgram.gram_workspace_numel(1, 3, 44, 48) == 0
    assert tgram.gram_plan(8, 256 * 256, 1, H100_SMS) == (128, 512)
    assert tgram.apply_plan(1, 256 * 256, 1, 48, H100_SMS) == (256, 2)
    assert tgram.apply_plan(1, 256 * 256, 1, 96, H100_SMS) == (128, 4)


def test_the_gram_backward_fills_the_card():
    """At train L1 (B = 3, one head, ch = 48: 768 tiles of 64 pixels) the
    Gram backward runs 256 blocks of three tiles, two an SM; at train
    decoder L1 (ch = 96) 128 blocks of six, one an SM; at the training
    latent (24 pairs of four tiles) 96 blocks of one tile. Its dattn sum
    takes the Gram's ranges: at train L1 43 of 384 pixels a pair, one
    partial each in the workspace; at the training latent 4 of 64; none
    once the pairs alone fill the card."""
    assert tgram.gram_bwd_plan(3, 128 * 128, 1, 48, H100_SMS) == (256, 3)
    assert tgram.gram_bwd_plan(3, 128 * 128, 1, 96, H100_SMS) == (128, 6)
    assert tgram.gram_bwd_plan(3, 16 * 16, 8, 48, H100_SMS) == (96, 1)
    assert tgram.gram_plan(3, 128 * 128, 1, H100_SMS) == (43, 384)
    assert tgram.apply_bwd_workspace_numel(43, 3, 1, 48) == 43 * 3 * 48 * 48
    assert tgram.apply_bwd_workspace_numel(4, 3, 8, 48) == 4 * 24 * 48 * 48
    assert tgram.apply_bwd_workspace_numel(1, 3, 44, 48) == 0



# heads past 128 channels: the one-head-a-level model's 192 and 384 at the
# serving and training shapes, two blocks of 68 (136) and of 75 (150), and
# 33 blocks (4,100)
WIDE = [(1, 64 * 64, 1, 192), (3, 32 * 32, 1, 192), (1, 32 * 32, 1, 384),
        (3, 16 * 16, 1, 384), (2, 24 * 20, 2, 136), (2, 33 * 7, 1, 150), (1, 9, 1, 4100)]


@pytest.mark.parametrize("ch", [1, 5, 24, 48, 96, 128, 129, 130, 136, 150, 192, 255, 256,
                                257, 260, 384, 1000, 4100])
def test_channel_blocks_cover_a_head_once(ch):
    """As few blocks as 128 channels a block allow, every channel once,
    none empty; more than 64 channels each where a head is cut (the
    kernels' block variants are compiled for those alone), a multiple of 4
    where ch is (16-byte copies stay aligned); ch <= 128 is one block."""
    nb, cb = tgram.channel_blocks(ch)
    _tiles_once(ch, nb, cb)
    assert nb == -(-ch // tgram.HEAD_BLOCK) and cb <= tgram.HEAD_BLOCK
    if nb == 1:
        assert cb == ch
    else:
        assert cb > 64 and (ch % 4 != 0 or cb % 4 == 0)


@pytest.mark.parametrize("b,hw,heads,ch", sorted(set(MAIN)) + ODD + WIDE)
def test_heads_up_to_128_keep_their_plans_and_wider_ones_share_the_card(b, hw, heads, ch):
    nb, cb = tgram.channel_blocks(ch)
    pairs = nb * nb
    for n_sm in SM_COUNTS:
        splits, per = tgram.gram_pairs_plan(b, hw, heads, ch, n_sm)
        assert (splits, per) == tgram.gram_plan(b, hw, heads * pairs, n_sm)
        _tiles_once(hw, splits, per)
        for plan, tile, two_max in ((tgram.apply_plan, tgram.APPLY_TILE, tgram.APPLY_TWO_MAX_CH),
                                    (tgram.gram_bwd_plan, tgram.GRAM_BWD_TILE,
                                     tgram.GRAM_BWD_TWO_MAX_CH)):
            tiles = b * heads * -(-hw // tile)
            blocks, per = plan(b, hw, heads, ch, n_sm)
            _tiles_once(tiles, blocks, per)
            per_sm = 2 if cb <= two_max else 1
            assert blocks <= per_sm * max(1, n_sm // pairs)
            if nb == 1:  # the plan of a head that is not cut, as it always was
                want = -(-tiles // min(tiles, per_sm * n_sm))
                assert (blocks, per) == (-(-tiles // want), want)
        for width in (1, 2):
            assert tgram.slots_numel(b, hw, heads, ch, width) == (
                0 if nb == 1 else nb * b * hw * width * heads * ch)


def _offsets_fit(b, hw, heads, ch, ptr, vec):
    """Every row of a head's q, k and v slices and of its channel blocks
    starts on a copy: offsets (in bf16) b hw 3C + p 3C + h ch + third C + k cb,
    and the copy's bytes align with ptr + 2 offset."""
    nb, cb = tgram.channel_blocks(ch)
    c = heads * ch
    offs = {bb * hw * 3 * c + p * 3 * c + h * ch + third * c + k * cb
            for bb in range(min(b, 2)) for p in range(min(hw, 3)) for h in range(heads)
            for third in range(3) for k in range(nb)}
    return (ch % vec == 0 and cb % vec == 0
            and all((ptr + 2 * o) % min(16, 2 * vec) == 0 for o in offs))


@pytest.mark.parametrize("b,hw,heads,ch", sorted(set(MAIN)) + ODD + WIDE)
@pytest.mark.parametrize("ptr", [0, 4, 2])
def test_the_bf16_copies_fit_every_row_of_a_head(b, hw, heads, ch, ptr):
    """The bf16 Gram and apply (csrc/gram_bf16.cu) copy a head's rows 8
    bf16 (16 bytes) at a time where the head, its channel blocks and the
    pointer allow, 2 (4 bytes) where they are even and 4-byte aligned, and
    load single bf16 otherwise (ch = 150 cuts into blocks of 75)."""
    vec = tgram.bf16_copy_width(ch, tgram.channel_blocks(ch)[1], ptr)
    assert vec in (8, 2, 1)
    assert _offsets_fit(b, hw, heads, ch, ptr, vec)
    wider = {8: None, 2: 8, 1: 2}[vec]
    if wider is not None:  # the widest that fits
        assert not _offsets_fit(b, hw, heads, ch, ptr, wider)
    if (b, hw, heads, ch) in MAIN and ptr == 0:
        assert vec == 8  # every head of the main path: 16-byte copies


# the bf16 apply forward's and Gram backward's plans (csrc/gram_bf16.cu
# apply_bf16_kernel, csrc/gram_bwd.cuh on bf16 tiles) at the main path's
# shapes: training at 128^2, B = 3, heads of 48 and 96; serving at 256^2,
# B = 1 and 8; the one-head-a-level model's heads of 192 and 384
BF16_PLAN_SHAPES = [(3, 128 * 128, 1, 48), (3, 128 * 128, 1, 96), (1, 256 * 256, 1, 48),
                    (1, 256 * 256, 1, 96), (8, 256 * 256, 1, 48), (8, 256 * 256, 1, 96),
                    (1, 64 * 64, 1, 192), (3, 32 * 32, 1, 192), (1, 32 * 32, 1, 384),
                    (3, 16 * 16, 1, 384)]


@pytest.mark.parametrize("b,hw,heads,ch", BF16_PLAN_SHAPES + sorted(set(MAIN)) + ODD + WIDE)
def test_the_bf16_plans_cover_every_tile_once_within_an_sms_shared_memory(b, hw, heads, ch):
    """Every tile once, none of the blocks empty, at most the blocks an SM
    the design counts on (the pairs sharing the card's SMs), each block's
    shared memory within what a block may have and the blocks an SM within
    what an SM has; the Gram backward needs no workspace where the head is
    one channel block (only the slots of a cut head)."""
    nb, cb = tgram.channel_blocks(ch)
    for plan, tile, per_sm, smem in (
            (tgram.apply_bf16_plan, tgram.APPLY_TILE, tgram.apply_bf16_per_sm,
             tgram.apply_bf16_smem),
            (tgram.gram_bwd_bf16_plan, tgram.GRAM_BWD_TILE, tgram.gram_bwd_bf16_per_sm,
             tgram.gram_bwd_bf16_smem)):
        assert smem(cb) <= 232_448 and smem(cb) % 16 == 0
        assert 1 <= per_sm(cb) and per_sm(cb) * (smem(cb) + tgram.SMEM_RESERVED) <= (
            tgram.SMEM_PER_SM)
        for n_sm in SM_COUNTS:
            tiles = b * heads * -(-hw // tile)
            blocks, per = plan(b, hw, heads, ch, n_sm)
            _tiles_once(tiles, blocks, per)
            assert blocks <= per_sm(cb) * max(1, n_sm // (nb * nb))
    assert tgram.slots_numel(b, hw, heads, ch, 2) == (0 if ch <= tgram.HEAD_BLOCK else
                                                      nb * b * hw * 2 * heads * ch)


@pytest.mark.parametrize("ch,apply_smem,apply_per_sm,bwd_smem,bwd_per_sm", [
    (16, 26_368, 4, 27_776, 2), (32, 47_616, 3, 51_456, 2), (48, 71_936, 2, 79_232, 2),
    (64, 99_328, 2, 111_104, 1),
    (96, 110_080, 2, 160_512, 1), (128, 169_984, 1, 175_104, 1)])
def test_the_bf16_designs_blocks_an_sm(ch, apply_smem, apply_per_sm, bwd_smem, bwd_per_sm):
    """The apply: a ring of four 128-pixel v tiles up to R = 4 (two above),
    attn in bf16 and in fp32, as many blocks an SM as that leaves room for
    and the registers a thread needs without spilling allow (four at R = 1,
    three at R = 2, two up to R = 6, one above). The Gram backward: a ring
    of four stages of a q and a k tile in bf16 up to R = 4 (three above), dG
    split in its tf32 parts and dnq | dnk, two blocks an SM up to R = 3 (the
    registers), one above."""
    assert tgram.apply_bf16_smem(ch) == apply_smem
    assert tgram.apply_bf16_per_sm(ch) == apply_per_sm
    assert tgram.gram_bwd_bf16_smem(ch) == bwd_smem
    assert tgram.gram_bwd_bf16_per_sm(ch) == bwd_per_sm


def test_the_bf16_plans_at_the_main_path_shapes():
    """Serve L1 (512 tiles of 128 pixels at ch = 48) and decoder L1 (ch =
    96), two blocks an SM: 256 blocks of two tiles, each block's whole run
    in flight at once; batch 8 at L1 256 blocks of sixteen.
    Train L1 (768 tiles of 64 pixels, ch = 48, two blocks an SM): 256
    blocks of three tiles, a ring of four stages holding all three; train
    decoder L1 (ch = 96, one an SM) 128 blocks of six. A head of 192 runs
    its four block pairs on a quarter of the SMs each."""
    assert tgram.apply_bf16_plan(1, 256 * 256, 1, 48, H100_SMS) == (256, 2)
    assert tgram.apply_bf16_plan(1, 256 * 256, 1, 96, H100_SMS) == (256, 2)
    assert tgram.apply_bf16_plan(8, 256 * 256, 1, 48, H100_SMS) == (256, 16)
    assert tgram.apply_bf16_plan(3, 128 * 128, 1, 48, H100_SMS) == (192, 2)
    assert tgram.gram_bwd_bf16_plan(3, 128 * 128, 1, 48, H100_SMS) == (256, 3)
    assert tgram.gram_bwd_bf16_plan(3, 128 * 128, 1, 96, H100_SMS) == (128, 6)
    assert tgram.gram_bwd_bf16_plan(3, 16 * 16, 8, 48, H100_SMS) == (96, 1)
    assert tgram.gram_bwd_bf16_plan(1, 64 * 64, 1, 192, H100_SMS) == (32, 2)
    assert tgram.apply_bf16_plan(1, 64 * 64, 1, 192, H100_SMS) == (32, 1)


@pytest.mark.parametrize("b,hw,heads,ch", BF16_PLAN_SHAPES + sorted(set(MAIN)) + ODD + WIDE)
def test_the_bf16_apply_backward_keeps_the_fp32_ranges_within_an_sms_shared_memory(
        b, hw, heads, ch):
    """The bf16 apply backward (csrc/apply_bwd_bf16.cu) sums dattn over the
    fp32 kernel's pixel ranges (gram_pairs_plan): every pixel of each (b,
    head) and channel-block pair once, none of the ranges empty, in whole
    64-pixel tiles of at most GRAM_MAX_PIXELS; its block's shared memory
    within what a block may have and its blocks an SM within what an SM
    has; one workspace, the dattn partials where a (b, head) is split and
    the slots of dv where the head is cut into channel blocks."""
    nb, cb = tgram.channel_blocks(ch)
    smem, per_sm = tgram.apply_bwd_bf16_smem(cb), tgram.apply_bwd_bf16_per_sm(cb)
    assert smem <= 232_448 and smem % 16 == 0
    assert 1 <= per_sm and per_sm * (smem + tgram.SMEM_RESERVED) <= tgram.SMEM_PER_SM
    for n_sm in SM_COUNTS:
        splits, per = tgram.gram_pairs_plan(b, hw, heads, ch, n_sm)
        _tiles_once(hw, splits, per)
        assert per % tgram.GRAM_BWD_TILE == 0 and per <= tgram.GRAM_MAX_PIXELS
        n_ws = tgram.apply_bwd_workspace_numel(splits, b, heads, ch)
        assert n_ws == (0 if splits == 1 else splits * b * heads * ch * ch)
    assert tgram.slots_numel(b, hw, heads, ch, 1) == (0 if nb == 1 else nb * b * hw * heads * ch)


@pytest.mark.parametrize("ch,smem,per_sm", [
    (16, 30_720, 2), (24, 56_320, 1), (32, 56_320, 1), (48, 86_016, 1), (64, 119_808, 1),
    (96, 173_056, 1), (112, 215_040, 1), (128, 191_488, 1)])
def test_the_bf16_apply_backwards_blocks_an_sm(ch, smem, per_sm):
    """A ring of four stages of a g and a v tile in bf16 up to R = 4 (three
    above), dv's bf16 staging tile, or the warp groups' dattn partials where
    larger, then attn split into its tf32 parts (whole at R = 8): two
    blocks an SM at R = 1, one above (the registers: up to R = 3 a warp
    holds its attn fragments in them)."""
    assert tgram.apply_bwd_bf16_smem(ch) == smem
    assert tgram.apply_bwd_bf16_per_sm(ch) == per_sm


@pytest.mark.parametrize("b,hw,heads,ch", MAIN)
def test_the_bf16_apply_backward_at_the_sixteen_main_path_shapes(b, hw, heads, ch):
    """At every main-path shape every range is in flight at once on an H100:
    the grid (splits ranges of each (b, head)) is at most one block an SM,
    and the blocks an SM are pinned: one at heads of 24, 48 and 96
    channels."""
    splits, _ = tgram.gram_pairs_plan(b, hw, heads, ch, H100_SMS)
    assert splits * b * heads <= H100_SMS
    assert tgram.apply_bwd_bf16_per_sm(ch) == {24: 1, 48: 1, 96: 1}[ch]
