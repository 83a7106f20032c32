"""The port's CUDA kernels against their plain twins, on a CUDA card.

Every test here is marked `cuda` and skips without a card (the kernels have
no CPU mode). The file imports neither JAX nor rcot_tpu, so it also runs on
a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

TF32 is off for the plain twins. Tolerance: max|kernel - plain| <= 1e-5 *
max|plain| (fp32 sums in another order). The block head and tail (3xTF32
products, sums in a fixed order) are held against their plain twins run in
float64, and two calls agree bitwise. The Gram, whose sums run over
every pixel with cancelling terms, is held against its plain twin run in
float64: in fp32 on the card the twin's own rounding comes near the
tolerance. Its kernel sums in a fixed order, so two calls agree bitwise. The
backward kernels, whose weight grads are such sums too, are held against
their plain twins run in float64, every output at the same 1e-5; the MDTA,
block and fused dwconv kernels sum in a fixed order too, and two calls
agree bitwise.

The autograd case holds a small T_net on the card against the same model
on the CPU: every parameter's gradient agrees within 1e-4 of that
parameter's largest gradient (fp32 through some eighty ops, forward and
backward, in another order of sums; cuDNN in fp32 with TF32 off), in each
of the four block compositions, and with the opt-in attention core and
depthwise tier (ops/mdta.py, ops/dwconv.py). The fused MDTA attend, whose
Gram and norms are pixel sums added with atomics, and the depthwise
kernel's backward (dx by the same kernel, dtaps a pixel sum in a fixed
order, bitwise repeatable) are held against float64 twins at the same
1e-5.

bf16 serving (rows 1-4 in bf16, csrc/block_fwd_bf16.cu and gram_bf16.cu):
each bf16 output within BF16_RTOL = 2^-6 of max(max|twin|, 1) of its plain
bf16 twin (four bf16 ulps of the largest value: where a sum falls next to a
rounding boundary the kernel and the twin round it apart, and later stages
carry that on), the Gram's fp32 outputs (sums of exact bf16 products)
within 1e-5 of the float64 twin's; every bf16 kernel repeats bitwise; a
tensor of another dtype than a kernel takes (fp32 beside bf16, bf16 taps at
row 11's bf16 forms, which take fp32 ones) raises and names its dtype.

bf16 in the opt-in tiers (rows 10-11 in bf16, csrc/mdta.cu and dwconv.cu on
bf16 tiles): the same gates, dtaps (fp32) within 1e-5 of its float64 twin;
a small T_net served in off/mdta/dwconv and trained in tail/mdta/dwconv on
the card against the CPU by the quarter rule, each form launched once a
block; the JAX wrapper's jnp route (ops/mdta.py mdta_route) launches no
kernel.

bf16 training (row 8's qkv forward, rows 5 (tail), 6-7 and 9 (qkv)
backward: csrc/fused_dwconv_bf16.cu, block_bwd_bf16.cu, gram_bwd_bf16.cu):
each bf16 output within BF16_RTOL of its plain bf16 twin, each fp32 output
(dln_w, dln_b, dattn: pixel sums) against the twin's arithmetic in float64,
dattn within 1e-5 of max(max|twin|, 1), dln_w and dln_b within BF16_FLIP_RTOL
(they follow bf16 rounding points, t, u and h: where two fp32 sums fall on
either side of a rounding boundary they round a value one bf16 ulp apart,
and the pixel sums carry that; chip_smoke.py measured 1.2e-4, the fp32 twin
itself 2.9e-4 from float64); every kernel repeats bitwise; a small T_net's
bf16 gradients on the card against the CPU's under the quarter rule on the
mean taken over every gradient entry together (sum|card - CPU bf16| <=
sum|fp32 - bf16| / 4; per tensor an MDTA temperature's cancelling sum of a
few entries breaks it, chip_smoke.py BF16_MODEL_RATIO).

bf16 operands in the backward products (--bwd-bf16, RCOT_BWD_BF16: rows 5,
6-7 and 9 on fp32 and bf16 activations, counted *_b16ops): each form
against its plain twin with bf16 operands, within 1/16 of what its 3xTF32
form is from the twin on the mean of every output rounding reaches (a
quarter for the _bf16 forms, which carry flips of their own) and
2^-7 of the largest value at most (an ulp), bitwise on a repeat; a small fp32 T_net
with every tier on against the CPU, summed within 0.9 of what the option
changes (chip_smoke.py B16OPS_MODEL_RATIO says why no tighter), only the
_b16ops backward forms launched.
"""

import pytest
import torch

from rcot_torch.kernels import build
from rcot_torch.models.restormer import TNet
from rcot_torch.ops import block as tblock
from rcot_torch.ops import dwconv as tdw
from rcot_torch.ops import fused as tfused
from rcot_torch.ops import gram as tgram
from rcot_torch.ops import mdta as tmdta
from rcot_torch.utils.config import ModelConfig

RTOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-6))


def _block_inputs(gen, b, h, w, c, ln_bias):
    hid = int(c * 2.66)
    m = 3 * c

    def r(*shape, loc=0.0, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale + loc
    return dict(
        x=r(b, h, w, c), a=r(b, h, w, c),
        ln_w=r(c, loc=1.0, scale=0.1), ln_b=r(c, scale=0.1) if ln_bias else None,
        w_qkv=r(m, c, scale=c ** -0.5), dw_qkv=r(m, 3, 3, scale=0.3),
        w_proj=r(c, c, scale=c ** -0.5), w_in=r(2 * hid, c, scale=c ** -0.5),
        dw_in=r(2 * hid, 3, 3, scale=0.3), w_out=r(c, hid, scale=hid ** -0.5))


def _block_fwd_calls(p):
    """{name: (kernel, plain twin, inputs)} of both row 1-2 configurations."""
    head = [p["x"], p["ln_w"], p["ln_b"], p["w_qkv"], p["dw_qkv"]]
    tail = [p[k] for k in ("x", "a", "w_proj", "ln_w", "ln_b", "w_in", "dw_in", "w_out")]
    return {"block_head": (tblock.block_head, tblock.block_head_plain, head),
            "block_tail": (tblock.block_tail, tblock.block_tail_plain, tail)}


# rows 1-2 against their float64 twins, one launch of each count a call:
# C = 6 (h = 15), widths that are no multiple of a tile, odd h (127, 255,
# 1,021) and h = 510, split products (the latent), B = 3
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 20, 19, 6), (2, 32, 32, 48), (1, 16, 16, 192),
                                   (1, 9, 33, 384), (3, 16, 16, 384), (1, 24, 40, 96)])
@pytest.mark.parametrize("ln_bias", [True, False], ids=["WithBias", "BiasFree"])
def test_block_kernels_match_plain(cuda_device, shape, ln_bias):
    p = _block_inputs(torch.Generator(device="cuda").manual_seed(5), *shape, ln_bias)
    for name, (fn, plain, args) in _block_fwd_calls(p).items():
        n0 = build.LAUNCHES[name]
        got = fn(*args)
        torch.cuda.synchronize()
        assert build.LAUNCHES[name] == n0 + 1, name
        assert _rel_err(got.double(), plain(*_double(args))) < RTOL, name


# rows 1-2 sum in a fixed order (no atomics): two calls give the same bits
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 20, 19, 6), (3, 32, 32, 48), (1, 9, 33, 384),
                                   (2, 16, 24, 96)])
def test_block_fwd_kernels_repeat_bitwise(cuda_device, shape):
    p = _block_inputs(torch.Generator(device="cuda").manual_seed(16), *shape, True)
    for name, (fn, _, args) in _block_fwd_calls(p).items():
        first, again = fn(*args), fn(*args)
        torch.cuda.synchronize()
        assert torch.equal(first, again), name


def _shifted(t):
    """A copy of t that starts 4 bytes past its allocation."""
    if t is None:
        return None
    out = torch.empty(t.numel() + 1, device="cuda")[1:].view(t.shape)
    return out.copy_(t)


# every operand 4 bytes past its allocation takes 4-byte copies
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 12, 13, 48), (1, 8, 9, 192)])
def test_block_fwd_kernels_take_unaligned_operands(cuda_device, shape):
    p = _block_inputs(torch.Generator(device="cuda").manual_seed(17), *shape, True)
    p = {k: _shifted(v) for k, v in p.items()}
    for name, (fn, plain, args) in _block_fwd_calls(p).items():
        got = fn(*args)
        torch.cuda.synchronize()
        assert _rel_err(got.double(), plain(*_double(args))) < RTOL, name


@pytest.mark.cuda
def test_block_tail_w_out_product_does_not_drift_at_k_1021(cuda_device):
    """y is the W_out product alone (x = a = 0, so t = 0) over K = h = 1,021
    positive terms (LN2(0) = ln_b, W_in, the taps and W_out positive): a
    chain of mma.sync into one accumulator would drift toward zero here
    (rcot_torch/csrc/mm.cuh, mm_kernel), past the gate."""
    p = _block_inputs(torch.Generator(device="cuda").manual_seed(18), 1, 32, 32, 384, True)
    p["x"], p["a"] = torch.zeros_like(p["x"]), torch.zeros_like(p["a"])
    for k in ("ln_b", "w_in", "dw_in", "w_out"):
        p[k] = p[k].abs()
    fn, plain, args = _block_fwd_calls(p)["block_tail"]
    got = fn(*args)
    torch.cuda.synchronize()
    assert bool((got > 0).all())
    assert _rel_err(got.double(), plain(*_double(args))) < RTOL


@pytest.mark.cuda
def test_block_fwd_wrappers_refuse_more_channels_than_the_layernorm_holds(cuda_device):
    c = tblock.LN_MAX_CHANNELS + 1
    p = _block_inputs(torch.Generator(device="cuda").manual_seed(19), 1, 2, 2, c, True)
    for name, (fn, _, args) in _block_fwd_calls(p).items():
        with pytest.raises(ValueError, match=str(tblock.LN_MAX_CHANNELS)):
            fn(*args)


# past 512 channels the LayerNorm walks a pixel's channels in device memory
# (and its backward keeps 48-96 KB of partials in shared memory, 768 past
# the 48 KB that needs no attribute): rows 1-2 and 5 against their float64
# twins, two calls bitwise equal
@pytest.mark.cuda
@pytest.mark.parametrize("c", [576, 768])
@pytest.mark.parametrize("ln_bias", [True, False], ids=["WithBias", "BiasFree"])
def test_block_kernels_past_512_channels_match_float64_and_repeat(cuda_device, c, ln_bias):
    gen = torch.Generator(device="cuda").manual_seed(20)
    p = _block_inputs(gen, 1, 12, 11, c, ln_bias)
    for name, (fn, plain, args) in _block_fwd_calls(p).items():
        got, again = fn(*args), fn(*args)
        torch.cuda.synchronize()
        assert _rel_err(got.double(), plain(*_double(args))) < RTOL, name
        assert torch.equal(got, again), name
    head = [p["x"], p["ln_w"], p["ln_b"], p["w_qkv"], p["dw_qkv"]]
    tail = [p[k] for k in ("x", "a", "w_proj", "ln_w", "ln_b", "w_in", "dw_in", "w_out")]
    for fn, plain, args, width, names in (
            (tblock.block_head_bwd, tblock.block_head_bwd_plain, head, 3 * c,
             ["dx", "dln_w", "dln_b", "dw_qkv", "ddw"]),
            (tblock.block_tail_bwd, tblock.block_tail_bwd_plain, tail, c,
             ["dx", "da", "dw_proj", "dln_w", "dln_b", "dw_in", "ddw", "dw_out"])):
        g = torch.randn(1, 12, 11, width, device="cuda", generator=gen)
        got, again = fn(*args, g), fn(*args, g)
        torch.cuda.synchronize()
        _assert_grads_match(got, plain(*_double(args + [g])), names)
        assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got, again))


# (B, heads, ch, (H, W)): the forward kernels' 16-byte (ch % 4 == 0) and
# 4-byte (ch = 5) copies, one range per (b, head) and split ones, hw that
# is no multiple of any tile (37 * 29, 33 * 7), train-like B = 3, ch = 128
GRAM_CASES = [(2, 1, 48, (64, 64)), (2, 4, 96, (16, 16)), (2, 4, 24, (33, 7)),
              (2, 2, 5, (3, 3)), (3, 1, 48, (128, 128)), (3, 1, 128, (37, 29)),
              (3, 8, 48, (16, 16)), (3, 2, 5, (41, 43))]


@pytest.mark.cuda
@pytest.mark.parametrize("b,heads,ch,hw", GRAM_CASES)
def test_gram_kernels_match_plain(cuda_device, b, heads, ch, hw):
    g = torch.Generator(device="cuda").manual_seed(6)
    qkv = torch.randn(b, *hw, 3 * heads * ch, device=cuda_device, generator=g)
    n0 = build.LAUNCHES["mdta_gram_fwd"]
    got = tgram.mdta_gram_fwd(qkv, heads)
    torch.cuda.synchronize()
    assert build.LAUNCHES["mdta_gram_fwd"] == n0 + 1
    for a, want in zip(got, tgram.mdta_gram_plain(qkv.double(), heads)):
        assert a.shape == want.shape and a.is_contiguous()
        assert _rel_err(a, want) < RTOL
    attn = torch.softmax(torch.randn(b, heads, ch, ch, device=cuda_device, generator=g), -1)
    n0 = build.LAUNCHES["attn_apply_fwd"]
    out = tgram.attn_apply_fwd(qkv, attn)
    torch.cuda.synchronize()
    assert build.LAUNCHES["attn_apply_fwd"] == n0 + 1
    assert _rel_err(out, tgram.attn_apply_plain(qkv, attn)) < RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("b,heads,ch,hw", [(1, 1, 48, (256, 256)), (3, 8, 48, (16, 16)),
                                           (2, 2, 5, (41, 43))])
def test_the_gram_forward_is_bitwise_repeatable(cuda_device, b, heads, ch, hw):
    """Its sums run in a fixed order (no atomics): two calls, same bits."""
    g = torch.Generator(device="cuda").manual_seed(14)
    qkv = torch.randn(b, *hw, 3 * heads * ch, device=cuda_device, generator=g)
    first = tgram.mdta_gram_fwd(qkv, heads)
    second = tgram.mdta_gram_fwd(qkv, heads)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("b,heads,ch,hw", [(1, 1, 48, (64, 64)), (3, 4, 24, (33, 7)),
                                           (3, 1, 96, (32, 32))])
def test_the_mdta_core_on_the_card_matches_float64(cuda_device, b, heads, ch, hw):
    """The whole Gram core, forward kernels (rows 3-4) feeding the backward
    kernels (rows 6-7), against autograd of the plain core in float64. The
    temperature's gradient, a sum of cancelling terms dlogits * g_hat, is
    held to RTOL of the sum of their magnitudes; dqkv as every output."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    qkv = torch.randn(b, *hw, 3 * heads * ch, device=cuda_device, generator=gen)
    temp = torch.rand(heads, 1, 1, device=cuda_device, generator=gen) + 0.5
    cot = torch.randn(b, *hw, heads * ch, device=cuda_device, generator=gen)
    before = dict(build.LAUNCHES)
    leaves = [temp.clone().requires_grad_(), qkv.clone().requires_grad_()]
    out = tgram.mdta_core_gram(*leaves, heads)
    got = torch.autograd.grad(out, leaves, cot)
    torch.cuda.synchronize()
    for k in ("mdta_gram_fwd", "attn_apply_fwd", "mdta_gram_bwd", "attn_apply_bwd"):
        assert build.LAUNCHES[k] - before.get(k, 0) == 1, k
    leaves64 = [t.detach().double().requires_grad_() for t in (temp, qkv)]
    g, nq, nk = tgram.mdta_gram_plain(leaves64[1], heads)
    ghat = g / (nq.sqrt()[..., :, None] * nk.sqrt()[..., None, :])
    logits = ghat * leaves64[0][None]
    out64 = tgram.attn_apply_plain(leaves64[1], logits.softmax(-1))
    want = torch.autograd.grad(out64, leaves64 + [logits], cot.double())
    assert _rel_err(out.double(), out64) < RTOL
    _assert_grads_match(got[1:], want[1:2], ["dqkv"])
    terms = (want[2] * ghat.detach()).abs().sum(dim=(0, 2, 3)).reshape(heads, 1, 1)
    assert bool(((got[0].double() - want[0]).abs() <= RTOL * terms).all())


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    p = _block_inputs(torch.Generator(device="cuda").manual_seed(7), 1, 8, 8, 8, True)
    with pytest.raises(ValueError, match="contiguous"):
        tblock.block_head(p["x"].transpose(1, 2), p["ln_w"], p["ln_b"],
                          p["w_qkv"], p["dw_qkv"])
    with pytest.raises(ValueError, match="float32"):
        tblock.block_head(p["x"].double(), p["ln_w"], p["ln_b"], p["w_qkv"], p["dw_qkv"])
    with pytest.raises(ValueError):
        tblock.block_head(p["x"], p["ln_w"].cpu(), p["ln_b"], p["w_qkv"], p["dw_qkv"])
    with pytest.raises(ValueError, match="contiguous"):
        tgram.mdta_gram_fwd(torch.zeros(1, 2, 2, 3 * 130, device="cuda").transpose(1, 2), 1)


def _double(ts):
    return [None if t is None else t.double() for t in ts]


def _within(got, want64):
    """max|got - want| <= RTOL * max(max|want|, 1), want a float64 twin's."""
    assert got.shape == want64.shape
    err = float((got.double() - want64).abs().max())
    return err <= RTOL * max(float(want64.abs().max()), 1.0)


def _assert_grads_match(got, want64, names):
    for name, a, b in zip(names, got, want64):
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert _rel_err(a.double(), b) < RTOL, name


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 20, 19, 6), (2, 32, 32, 48), (1, 16, 16, 192),
                                   (1, 9, 33, 384)])
@pytest.mark.parametrize("ln_bias", [True, False], ids=["WithBias", "BiasFree"])
def test_block_bwd_kernels_match_float64_plain(cuda_device, shape, ln_bias):
    gen = torch.Generator(device="cuda").manual_seed(8)
    p = _block_inputs(gen, *shape, ln_bias)
    b, h, w, c = shape
    head = [p["x"], p["ln_w"], p["ln_b"], p["w_qkv"], p["dw_qkv"]]
    g = torch.randn(b, h, w, 3 * c, device="cuda", generator=gen)
    n0 = build.LAUNCHES["block_head_bwd"]
    got = tblock.block_head_bwd(*head, g)
    torch.cuda.synchronize()
    assert build.LAUNCHES["block_head_bwd"] == n0 + 1
    _assert_grads_match(got, tblock.block_head_bwd_plain(*_double(head + [g])),
                        ["dx", "dln_w", "dln_b", "dw_qkv", "ddw"])
    tail = [p[k] for k in ("x", "a", "w_proj", "ln_w", "ln_b", "w_in", "dw_in", "w_out")]
    g = torch.randn(b, h, w, c, device="cuda", generator=gen)
    n0 = build.LAUNCHES["block_tail_bwd"]
    got = tblock.block_tail_bwd(*tail, g)
    torch.cuda.synchronize()
    assert build.LAUNCHES["block_tail_bwd"] == n0 + 1
    _assert_grads_match(got, tblock.block_tail_bwd_plain(*_double(tail + [g])),
                        ["dx", "da", "dw_proj", "dln_w", "dln_b", "dw_in", "ddw",
                         "dw_out"])


def _block_bwd_calls(p, b, h, w, c, gen):
    """{name: (wrapper, its inputs with a cotangent)} of both row-5 configs."""
    head = [p["x"], p["ln_w"], p["ln_b"], p["w_qkv"], p["dw_qkv"]]
    tail = [p[k] for k in ("x", "a", "w_proj", "ln_w", "ln_b", "w_in", "dw_in", "w_out")]
    return {"block_head_bwd": (tblock.block_head_bwd, head + [
                torch.randn(b, h, w, 3 * c, device="cuda", generator=gen)]),
            "block_tail_bwd": (tblock.block_tail_bwd, tail + [
                torch.randn(b, h, w, c, device="cuda", generator=gen)])}


# row 5 sums in a fixed order (no atomics): two calls give the same bits,
# and each call is one launch of its own count and of no other; fewer than
# 512 pixels (one range), widths that are no multiple of a tile, odd h
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 20, 19, 6), (3, 32, 32, 48), (1, 9, 33, 384),
                                   (2, 16, 24, 96)])
@pytest.mark.parametrize("ln_bias", [True, False], ids=["WithBias", "BiasFree"])
def test_block_bwd_kernels_repeat_bitwise_in_one_launch_each(cuda_device, shape, ln_bias):
    gen = torch.Generator(device="cuda").manual_seed(9)
    p = _block_inputs(gen, *shape, ln_bias)
    for name, (fn, args) in _block_bwd_calls(p, *shape, gen).items():
        before = dict(build.LAUNCHES)
        first = fn(*args)
        torch.cuda.synchronize()
        after = dict(build.LAUNCHES)
        assert after.pop(name) == before.pop(name, 0) + 1, name
        assert after == before, name
        again = fn(*args)
        torch.cuda.synchronize()
        for i, (x, y) in enumerate(zip(first, again)):
            assert (x is None) == (y is None), (name, i)
            assert x is None or torch.equal(x, y), (name, i)


# operands at a 4-byte offset from their allocation take 4-byte copies
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 12, 13, 48), (1, 8, 9, 96)])
def test_block_bwd_kernels_take_unaligned_operands(cuda_device, shape):
    gen = torch.Generator(device="cuda").manual_seed(10)
    p = {k: _shifted(v) for k, v in _block_inputs(gen, *shape, True).items()}
    for name, (fn, args) in _block_bwd_calls(p, *shape, gen).items():
        args = [_shifted(t) for t in args]
        got = fn(*args)
        torch.cuda.synchronize()
        plain = (tblock.block_head_bwd_plain if name == "block_head_bwd"
                 else tblock.block_tail_bwd_plain)
        want = plain(*_double(args))
        for i, (a, b) in enumerate(zip(got, want)):
            assert (a is None) == (b is None), (name, i)
            assert a is None or _rel_err(a.double(), b) < RTOL, (name, i)


@pytest.mark.cuda
def test_block_bwd_wrappers_refuse_more_channels_than_the_layernorm_holds(cuda_device):
    c = tblock.LN_MAX_CHANNELS + 1
    p = _block_inputs(torch.Generator(device="cuda").manual_seed(11), 1, 2, 2, c, True)
    with pytest.raises(ValueError, match=str(tblock.LN_MAX_CHANNELS)):
        tblock.block_tail_bwd(*[p[k] for k in ("x", "a", "w_proj", "ln_w", "ln_b", "w_in",
                                               "dw_in", "w_out")], p["x"])


# (heads, ch, (H, W)) at B = 2: 16-byte copies and 4-byte ones (ch = 5,
# 20 is no multiple of 16), hw that is no multiple of the 64-pixel tile,
# one pixel range per (b, head) and many (the workspace and its reduce),
# ch = 96 (R = 6: two ring stages, dG pre-split, one block an SM) and 128
# (dG split at each use), the widest head the wrappers take
@pytest.mark.cuda
@pytest.mark.parametrize("heads,ch,hw", [(1, 48, (64, 64)), (4, 96, (16, 16)),
                                         (4, 24, (33, 7)), (2, 5, (3, 3)),
                                         (1, 128, (8, 9)), (1, 5, (41, 43)),
                                         (3, 20, (37, 29)), (2, 24, (100, 100)),
                                         (1, 96, (64, 64)), (1, 128, (33, 31))])
def test_gram_bwd_kernels_match_float64_plain(cuda_device, heads, ch, hw):
    """Both kernels against their plain twins in float64, and two calls on
    one input bitwise equal (their pixel sums run in a fixed order)."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    r = lambda *s: torch.randn(*s, device="cuda", generator=gen)  # noqa: E731
    qkv = r(2, *hw, 3 * heads * ch)
    cot = [r(2, heads, ch, ch), r(2, heads, ch), r(2, heads, ch)]
    n0 = build.LAUNCHES["mdta_gram_bwd"]
    got = tgram.mdta_gram_bwd(qkv, *cot, heads)
    again = tgram.mdta_gram_bwd(qkv, *cot, heads)
    torch.cuda.synchronize()
    assert build.LAUNCHES["mdta_gram_bwd"] == n0 + 2
    want = tgram.mdta_gram_bwd_plain(*_double([qkv] + cot), heads)
    assert _rel_err(got.double(), want) < RTOL
    assert torch.equal(got, again)
    attn = torch.softmax(r(2, heads, ch, ch), -1)
    g = r(2, *hw, heads * ch)
    got = tgram.attn_apply_bwd(qkv, attn, g)
    again = tgram.attn_apply_bwd(qkv, attn, g)
    torch.cuda.synchronize()
    _assert_grads_match(got, tgram.attn_apply_bwd_plain(*_double([qkv, attn, g])),
                        ["dv", "dattn"])
    assert all(torch.equal(x, y) for x, y in zip(got, again))


FUSED_SHAPES = pytest.mark.parametrize("shape", [(1, 20, 19, 6), (2, 32, 32, 48),
                                                  (1, 16, 16, 192), (1, 9, 33, 384)])


@pytest.mark.cuda
@FUSED_SHAPES
@pytest.mark.parametrize("gdfn", [False, True], ids=["conv1x1_dw", "gdfn_fused"])
def test_fused_kernels_match_plain(cuda_device, shape, gdfn):
    gen = torch.Generator(device="cuda").manual_seed(10)
    p = _block_inputs(gen, *shape, False)
    args = ((p["x"], p["w_in"], p["dw_in"], p["w_out"]) if gdfn
            else (p["x"], p["w_qkv"], p["dw_qkv"], None))
    name = "gdfn_fused" if gdfn else "conv1x1_dw"
    n0 = build.LAUNCHES[name]
    got = tfused.fused_dwconv_fwd(*args)
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == n0 + 1
    assert _rel_err(got, tfused.fused_dwconv_plain(*args)) < RTOL
    g = torch.randn(*got.shape, device="cuda", generator=gen)
    n0 = build.LAUNCHES[name + "_bwd"]
    got = tfused.fused_dwconv_bwd(*args, g)
    torch.cuda.synchronize()
    assert build.LAUNCHES[name + "_bwd"] == n0 + 1
    _assert_grads_match(got, tfused.fused_dwconv_bwd_plain(*_double(list(args) + [g])),
                        ["dx", "dw_in", "ddw", "dw_out"])


# rows 8-9 sum in a fixed order (no atomics, no memsets): two calls give
# the same bits, forward and backward, in both configurations, at C = 6
# (h = 15), a split product (the latent), odd h = 127 and a gate pass
# (C = 96)
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 20, 19, 6), (3, 32, 32, 48), (1, 9, 33, 384),
                                   (2, 16, 24, 96)])
@pytest.mark.parametrize("gdfn", [False, True], ids=["conv1x1_dw", "gdfn_fused"])
def test_fused_kernels_repeat_bitwise(cuda_device, shape, gdfn):
    gen = torch.Generator(device="cuda").manual_seed(21)
    p = _block_inputs(gen, *shape, False)
    args = ((p["x"], p["w_in"], p["dw_in"], p["w_out"]) if gdfn
            else (p["x"], p["w_qkv"], p["dw_qkv"], None))
    first, again = tfused.fused_dwconv_fwd(*args), tfused.fused_dwconv_fwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    g = torch.randn(*first.shape, device="cuda", generator=gen)
    first, again = tfused.fused_dwconv_bwd(*args, g), tfused.fused_dwconv_bwd(*args, g)
    torch.cuda.synchronize()
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(first, again))


# the GDFN on terms that never cancel (everything positive): its W_out
# product chains K = h = 1,021 steps, its dx product K = 2h = 2,042
@pytest.mark.cuda
def test_fused_gdfn_products_do_not_drift_at_k_1021_and_2042(cuda_device):
    gen = torch.Generator(device="cuda").manual_seed(22)
    p = {k: None if v is None else v.abs()
         for k, v in _block_inputs(gen, 1, 32, 32, 384, False).items()}
    args = [p["x"], p["w_in"], p["dw_in"], p["w_out"]]
    got = tfused.fused_dwconv_fwd(*args)
    g = torch.rand(*got.shape, device="cuda", generator=gen)
    grads = tfused.fused_dwconv_bwd(*args, g)
    torch.cuda.synchronize()
    assert _rel_err(got.double(), tfused.fused_dwconv_plain(*_double(args))) < RTOL
    _assert_grads_match(grads, tfused.fused_dwconv_bwd_plain(*_double(args + [g])),
                        ["dx", "dw_in", "ddw", "dw_out"])


@pytest.mark.cuda
def test_fused_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    p = _block_inputs(torch.Generator(device="cuda").manual_seed(11), 1, 8, 8, 8, False)
    with pytest.raises(ValueError, match="contiguous"):
        tfused.conv1x1_dw_fused(p["x"].transpose(1, 2), p["w_qkv"], p["dw_qkv"])
    with pytest.raises(ValueError, match="even"):
        tfused.gdfn_fused(p["x"], p["w_qkv"][:-1], p["dw_qkv"][:-1], p["w_out"])
    with pytest.raises(ValueError, match="w_out"):
        tfused.gdfn_fused(p["x"], p["w_in"], p["dw_in"], p["w_out"][:, :-1])


# (B, heads, c, N): serve L1 and decoder L1, train L1 (B = 3), the latent's
# eight heads, N = 80,250 (250 x 321 unpadded: N % 4 == 2, 4-byte copies)
# and odd N, c = 5 and 128, a head of 136 channels (two blocks of 68)
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 48, 65536), (2, 4, 24, 231), (3, 8, 96, 256),
                                   (1, 2, 5, 9), (1, 1, 128, 1000), (1, 1, 96, 65536),
                                   (3, 1, 48, 16384), (2, 8, 48, 1024), (1, 1, 48, 80250),
                                   (1, 1, 48, 20125), (2, 1, 136, 999)])
def test_mdta_attend_kernel_matches_float64_plain(cuda_device, shape):
    """Against the float64 twin, and two calls bitwise equal (csrc/mdta.cu
    sums in a fixed order)."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    q, k, v = (torch.randn(*shape, device="cuda", generator=gen) for _ in range(3))
    temp = torch.rand(shape[1], 1, 1, device="cuda", generator=gen) * 1.5 + 0.5
    n0 = build.LAUNCHES["mdta_attend"]
    got = tmdta.mdta_attend_fwd(q, k, v, temp)
    again = tmdta.mdta_attend_fwd(q, k, v, temp)
    torch.cuda.synchronize()
    assert build.LAUNCHES["mdta_attend"] == n0 + 2
    assert _rel_err(got.double(), tmdta.mdta_attend_plain(*_double([q, k, v, temp]))) < RTOL
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 20, 19, 6), (3, 32, 32, 254), (1, 9, 33, 1021),
                                   (3, 16, 16, 144), (1, 1, 1, 5)])
def test_dwconv3x3_kernel_and_backward_match_plain(cuda_device, shape):
    gen = torch.Generator(device="cuda").manual_seed(13)
    x = torch.randn(*shape, device="cuda", generator=gen)
    taps = torch.randn(shape[-1], 3, 3, device="cuda", generator=gen) * 0.3
    g = torch.randn(*shape, device="cuda", generator=gen)
    n0 = build.LAUNCHES["dwconv3x3"]
    got = tdw.dwconv3x3_fwd(x, taps)
    torch.cuda.synchronize()
    assert build.LAUNCHES["dwconv3x3"] == n0 + 1
    assert _rel_err(got, tdw.dwconv3x3_plain(x, taps)) < RTOL
    leaves = [x.clone().requires_grad_(), taps.clone().requires_grad_()]
    n0 = {k: build.LAUNCHES[k] for k in ("dwconv3x3_dx", "dwconv3x3_dtaps")}
    tdw.dwconv3x3(*leaves).backward(g)
    torch.cuda.synchronize()
    assert {k: build.LAUNCHES[k] - n for k, n in n0.items()} == {
        "dwconv3x3_dx": 1, "dwconv3x3_dtaps": 1}
    want = tblock._vjp_plain(tdw.dwconv3x3_plain, _double([x, taps]), g.double())
    _assert_grads_match([t.grad for t in leaves], want, ["dx", "dtaps"])


# one shape of each copy width (16, 8 and 4 bytes: C % 4 == 0, C % 2 == 0,
# odd C), each with a ragged column tile, channel chunk or row band
@pytest.mark.cuda
@pytest.mark.parametrize("shape,vec", [((2, 19, 23, 144), 4), ((1, 13, 37, 2042), 2),
                                       ((3, 11, 29, 255), 1)])
def test_dwconv3x3_and_its_rotated_dx_match_plain_at_each_copy_width(cuda_device, shape,
                                                                      vec):
    gen = torch.Generator(device="cuda").manual_seed(14)
    x = torch.randn(*shape, device="cuda", generator=gen)
    taps = torch.randn(shape[-1], 3, 3, device="cuda", generator=gen) * 0.3
    assert tdw.dwconv_vec(shape[-1], x.data_ptr()) == vec
    n0 = build.LAUNCHES["dwconv3x3_dx"]
    got_fwd, got_dx = tdw.dwconv3x3_fwd(x, taps), tdw.dwconv3x3_dx(x, taps)
    torch.cuda.synchronize()
    assert build.LAUNCHES["dwconv3x3_dx"] == n0 + 1
    assert _rel_err(got_fwd, tdw.dwconv3x3_plain(x, taps)) < RTOL
    assert _rel_err(got_dx, tdw.dwconv3x3_plain(x, taps.flip(1, 2))) < RTOL
    # a row not aligned to 16 bytes takes the narrower copies
    off = torch.empty(x.numel() + 1, device="cuda")[1:].view(shape).copy_(x)
    assert tdw.dwconv_vec(shape[-1], off.data_ptr()) == 1
    assert torch.equal(tdw.dwconv3x3_fwd(off, taps), got_fwd)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 20, 19, 6), (3, 16, 16, 144), (2, 9, 33, 1021),
                                   (1, 13, 37, 2042), (3, 64, 64, 288), (1, 1, 1, 5),
                                   (2, 7, 5, 1), (3, 128, 128, 144)])
def test_dwconv3x3_dtaps_kernel_matches_float64_and_repeats_bitwise(cuda_device, shape):
    """Ragged shapes, odd C, C = 1, a width of each copy class, and train
    L1 at 3C."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    x, g = (torch.randn(*shape, device="cuda", generator=gen) for _ in range(2))
    n0 = build.LAUNCHES["dwconv3x3_dtaps"]
    got, again = tdw.dwconv3x3_dtaps(x, g), tdw.dwconv3x3_dtaps(x, g)
    torch.cuda.synchronize()
    assert build.LAUNCHES["dwconv3x3_dtaps"] == n0 + 2
    assert got.shape == (shape[-1], 3, 3)
    assert _rel_err(got.double(), tdw.dwconv3x3_dtaps_plain(x.double(), g.double())) < RTOL
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_mdta_and_dwconv_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros(1, 1, 130, 4, device="cuda")
    with pytest.raises(ValueError, match="temperature"):
        tmdta.mdta_attend_fwd(q, q, q, torch.ones(2, 1, 1, device="cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        tmdta.mdta_attend_fwd(q, q.transpose(2, 3), q, torch.ones(1, 1, 1, device="cuda"))
    x = torch.zeros(1, 4, 4, 6, device="cuda")
    with pytest.raises(ValueError, match="taps"):
        tdw.dwconv3x3_fwd(x, torch.zeros(5, 3, 3, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("composition,core,depthwise", [
    ("off", "mdta", "dwconv"), ("tail", "mdta", "dwconv"), ("head", "gram", "dwconv"),
    ("full", "mdta", "fused")])
def test_opt_in_tiers_on_the_card_match_the_cpu(cuda_device, composition, core, depthwise):
    """A T_net on the card in the opt-in attention core and depthwise tier
    gives the outputs and every gradient the CPU model gives, through the
    fused attend and the depthwise kernel, each launched once per block."""
    cfg = ModelConfig(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                      parity_params=False)
    kw = dict(seed=3, composition=composition, attention_core=core, depthwise=depthwise)
    cpu, card = TNet(cfg, device="cpu", **kw), TNet(cfg, device="cuda", **kw)
    gen = torch.Generator().manual_seed(5)
    x = torch.rand(2, 16, 24, 3, generator=gen)
    wts = torch.randn(3, 2, 16, 24, 3, generator=gen)

    def run(net, dev):
        net.zero_grad()
        outs = net(x.to(dev))
        sum((o * w.to(dev)).sum() for o, w in zip(outs, wts)).backward()
        return outs[0].detach().cpu(), {n: p.grad for n, p in net.named_parameters()}

    before = dict(build.LAUNCHES)
    got_out, got = run(card, "cuda")
    torch.cuda.synchronize()
    n_dw = 22 * ((composition in ("tail", "off")) + (composition in ("head", "off")))
    want_launches = {"mdta_attend": 22 if core == "mdta" else 0,
                     "dwconv3x3": n_dw if depthwise == "dwconv" else 0}
    want_launches["dwconv3x3_dx"] = want_launches["dwconv3x3"]
    want_launches["dwconv3x3_dtaps"] = want_launches["dwconv3x3"]
    for k, n in want_launches.items():
        assert build.LAUNCHES[k] - before.get(k, 0) == n, k
    want_out, want = run(cpu, "cpu")
    assert float((got_out - want_out).abs().max()) <= 1e-4
    for name, gw in want.items():
        err = float((got[name].cpu() - gw).abs().max())
        assert err <= 1e-4 * float(gw.abs().max()), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("ln,composition", [("WithBias", "full"), ("BiasFree", "full"),
                                            ("WithBias", "head"), ("WithBias", "tail"),
                                            ("BiasFree", "tail"), ("WithBias", "off")])
def test_tnet_grads_on_the_card_match_the_cpu(cuda_device, ln, composition):
    """The kernels are autograd Functions: a T_net on the card gives every
    parameter the gradient the CPU model (plain twins) gives."""
    cfg = ModelConfig(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                      parity_params=False, layernorm_type=ln)
    cpu = TNet(cfg, device="cpu", seed=3, composition=composition)
    card = TNet(cfg, device="cuda", seed=3, composition=composition)
    gen = torch.Generator().manual_seed(4)
    x = torch.rand(2, 16, 24, 3, generator=gen)
    wts = torch.randn(3, 2, 16, 24, 3, generator=gen)

    def grads(net, dev):
        net.zero_grad()
        outs = net(x.to(dev))
        sum((o * w.to(dev)).sum() for o, w in zip(outs, wts)).backward()
        return {n: p.grad for n, p in net.named_parameters()}

    before = dict(build.LAUNCHES)
    got = grads(card, "cuda")
    torch.cuda.synchronize()
    head = "block_head_bwd" if composition in ("full", "head") else "conv1x1_dw_bwd"
    tail = "block_tail_bwd" if composition in ("full", "tail") else "gdfn_fused_bwd"
    for k in (head, tail, "mdta_gram_bwd", "attn_apply_bwd"):
        assert build.LAUNCHES[k] - before.get(k, 0) == 22, k
    want = grads(cpu, "cpu")
    for name, gw in want.items():
        gc = got[name]
        assert gc is not None, f"{name} has no gradient on the card"
        err = float((gc.cpu() - gw).abs().max())
        assert err <= 1e-4 * float(gw.abs().max()), (name, err)


# Heads wider than 128 channels (csrc/gram.cu and csrc/mdta.cu, "Heads of
# any width"): two blocks of 68 (136) and of 96 (192), three of 128 (384),
# two of 75 (150, 4-byte copies), split ranges (64^2) and whole ones.
WIDE_CORE = [(2, 1, 136, (16, 16)), (1, 2, 192, (24, 40)), (3, 1, 384, (8, 9)),
             (2, 1, 150, (33, 7)), (1, 1, 192, (64, 64))]


@pytest.mark.cuda
@pytest.mark.parametrize("b,heads,ch,hw", WIDE_CORE)
def test_mdta_core_kernels_at_wide_heads_match_float64_and_repeat(cuda_device, b, heads,
                                                                   ch, hw):
    """Rows 3-4 and 6-7, each output against its float64 twin within
    RTOL * max(max|twin|, 1), two calls bitwise equal, one count a call."""
    gen = torch.Generator(device="cuda").manual_seed(18)
    r = lambda *s: torch.randn(*s, device="cuda", generator=gen)  # noqa: E731
    qkv = r(b, *hw, 3 * heads * ch)
    attn = torch.softmax(r(b, heads, ch, ch), -1)
    cot = [r(b, heads, ch, ch), r(b, heads, ch), r(b, heads, ch)]
    g = r(b, *hw, heads * ch)
    calls = {
        "mdta_gram_fwd": (lambda: tgram.mdta_gram_fwd(qkv, heads),
                          lambda: tgram.mdta_gram_plain(qkv.double(), heads)),
        "attn_apply_fwd": (lambda: (tgram.attn_apply_fwd(qkv, attn),),
                           lambda: (tgram.attn_apply_plain(*_double([qkv, attn])),)),
        "mdta_gram_bwd": (lambda: (tgram.mdta_gram_bwd(qkv, *cot, heads),),
                          lambda: (tgram.mdta_gram_bwd_plain(*_double([qkv, *cot]), heads),)),
        "attn_apply_bwd": (lambda: tgram.attn_apply_bwd(qkv, attn, g),
                           lambda: tgram.attn_apply_bwd_plain(*_double([qkv, attn, g]))),
    }
    for name, (kernel, plain) in calls.items():
        n0 = build.LAUNCHES[name]
        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        assert build.LAUNCHES[name] == n0 + 2, name
        for i, (x, y, z) in enumerate(zip(got, plain(), again)):
            assert _within(x, y), (name, i)
            assert torch.equal(x, z), (name, i)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1, 136, 256), (1, 2, 192, 999), (1, 1, 384, 1024),
                                   (3, 1, 150, 300)])
def test_mdta_attend_at_wide_heads_matches_float64_and_repeats(cuda_device, shape):
    gen = torch.Generator(device="cuda").manual_seed(19)
    q, k, v = (torch.randn(*shape, device="cuda", generator=gen) for _ in range(3))
    temp = torch.rand(shape[1], 1, 1, device="cuda", generator=gen) + 0.5
    got, again = (tmdta.mdta_attend_fwd(q, k, v, temp) for _ in range(2))
    torch.cuda.synchronize()
    assert _within(got, tmdta.mdta_attend_plain(*_double([q, k, v, temp])))
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("ch", [48, 96, 128])
def test_pixel_sums_do_not_drift_over_512_pixel_ranges(cuda_device, ch):
    """The Gram's and dattn's sums (rows 3 and 7) and row 10's Gram on
    terms that never cancel (q, k, v and g positive), at 256^2 with one
    head: 128 ranges of 512 pixels, the longest a range holds; a tensor-core
    accumulation that drifts toward zero shows in full. Against float64."""
    gen = torch.Generator(device="cuda").manual_seed(20)
    qkv = torch.rand(1, 256, 256, 3 * ch, device="cuda", generator=gen)
    g = torch.rand(1, 256, 256, ch, device="cuda", generator=gen)
    attn = torch.softmax(torch.randn(1, 1, ch, ch, device="cuda", generator=gen), -1)
    assert tgram.gram_plan(1, 256 * 256, 1, tgram.sm_count(0)) == (128, 512)
    for x, y in zip(tgram.mdta_gram_fwd(qkv, 1), tgram.mdta_gram_plain(qkv.double(), 1)):
        assert _within(x, y)
    dattn = tgram.attn_apply_bwd(qkv, attn, g)[1]
    assert _within(dattn, tgram.attn_apply_bwd_plain(*_double([qkv, attn, g]))[1])
    q, k, v = (t.reshape(1, 256 * 256, 1, ch).permute(0, 2, 3, 1).contiguous()
               for t in qkv.split(ch, dim=-1))
    temp = torch.ones(1, 1, 1, device="cuda")
    assert _within(tmdta.mdta_attend_fwd(q, k, v, temp),
                   tmdta.mdta_attend_plain(*_double([q, k, v, temp])))


@pytest.mark.cuda
@pytest.mark.parametrize("core,composition,depthwise", [("gram", "full", "fused"),
                                                        ("mdta", "off", "dwconv"),
                                                        ("gram", "tail", "fused"),
                                                        ("mdta", "tail", "dwconv")])
def test_one_head_a_level_runs_on_the_card_as_on_the_cpu(cuda_device, core, composition,
                                                         depthwise):
    """heads = (1, 1, 1, 1) at dim 48: heads of 192 channels at level 3 and
    384 at the latent, which the JAX package serves. The outputs and every
    gradient on the card against the CPU model's, as
    test_opt_in_tiers_on_the_card_match_the_cpu holds them."""
    cfg = ModelConfig(dim=48, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                      heads=(1, 1, 1, 1), parity_params=False)
    kw = dict(seed=3, composition=composition, attention_core=core, depthwise=depthwise)
    cpu, card = TNet(cfg, device="cpu", **kw), TNet(cfg, device="cuda", **kw)
    gen = torch.Generator().manual_seed(6)
    x = torch.rand(1, 32, 32, 3, generator=gen)
    wts = torch.randn(3, 1, 32, 32, 3, generator=gen)

    def run(net, dev):
        net.zero_grad()
        outs = net(x.to(dev))
        sum((o * w.to(dev)).sum() for o, w in zip(outs, wts)).backward()
        return outs[0].detach().cpu(), {n: p.grad for n, p in net.named_parameters()}

    before = dict(build.LAUNCHES)
    got_out, got = run(card, "cuda")
    torch.cuda.synchronize()
    kernel = "mdta_attend" if core == "mdta" else "mdta_gram_fwd"
    assert build.LAUNCHES[kernel] - before.get(kernel, 0) == 22
    want_out, want = run(cpu, "cpu")
    assert float((got_out - want_out).abs().max()) <= 1e-4
    for name, gw in want.items():
        err = float((got[name].cpu() - gw).abs().max())
        assert err <= 1e-4 * float(gw.abs().max()), (name, err)


@pytest.mark.cuda
def test_metric_nets_on_the_card_match_the_cpu(cuda_device):
    """The evaluation nets (no kernel of their own: cuDNN convolutions) on
    the card against the CPU, on the surrogate weights: Inception pool3 at
    rtol 2e-3, atol 2e-4 (upscale and downscale to 299), LPIPS within 1e-5."""
    import warnings

    from rcot_torch.metrics import inception, lpips

    gen = torch.Generator().manual_seed(7)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        inc = {d: inception.InceptionV3(device=d) for d in ("cuda", "cpu")}
        lp = {d: lpips.LPIPS(device=d) for d in ("cuda", "cpu")}
    for shape in ((2, 96, 80, 3), (1, 320, 331, 3)):
        x = torch.rand(*shape, generator=gen)
        got, want = (inception.inception_pool3(inc[d], x).cpu() for d in ("cuda", "cpu"))
        torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-4)
    x, y = torch.rand(2, 2, 64, 72, 3, generator=gen)
    got, want = (lpips.lpips(lp[d], x, y).cpu() for d in ("cuda", "cpu"))
    assert float((got - want).abs().max()) <= 1e-5


# ------------------------------------------------------------ bf16 serving

BF16_RTOL = 2.0 ** -6


def _bf16_within(got, want):
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    err = float((got.float() - want.float()).abs().max())
    return err <= BF16_RTOL * max(float(want.float().abs().max()), 1.0)


def _to_bf16(p):
    return {k: v if v is None or k.startswith("ln_") else v.bfloat16() for k, v in p.items()}


# rows 1-2 in bf16: C = 6 (h = 15), odd h (127, 255, 1,021: W_out's rows
# 2-byte aligned) and h = 510, split products (the latent), B = 3
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 20, 19, 6), (2, 32, 32, 48), (1, 16, 16, 192),
                                   (1, 9, 33, 384), (3, 16, 16, 384), (1, 24, 40, 96)])
@pytest.mark.parametrize("ln_bias", [True, False], ids=["WithBias", "BiasFree"])
def test_bf16_block_kernels_match_their_bf16_twins_and_repeat(cuda_device, shape, ln_bias):
    p = _to_bf16(_block_inputs(torch.Generator(device="cuda").manual_seed(15), *shape,
                               ln_bias))
    for name, (fn, plain, args) in _block_fwd_calls(p).items():
        n0, n32 = build.LAUNCHES[name + "_bf16"], build.LAUNCHES[name]
        got, again = fn(*args), fn(*args)
        torch.cuda.synchronize()
        assert build.LAUNCHES[name + "_bf16"] == n0 + 2 and build.LAUNCHES[name] == n32, name
        assert _bf16_within(got, plain(*args)), name
        assert torch.equal(got, again), name


@pytest.mark.cuda
@pytest.mark.parametrize("b,heads,ch,hw", [(1, 1, 48, (64, 64)), (2, 8, 48, (16, 16)),
                                           (3, 4, 24, (33, 7)), (1, 1, 192, (32, 32)),
                                           (1, 1, 150, (9, 9)), (2, 2, 5, (6, 7))])
def test_bf16_gram_and_apply_match_their_twins_and_repeat(cuda_device, b, heads, ch, hw):
    """Heads of 48 (16-byte copies), 24, 192 (two blocks of 96), 150 (blocks
    of 75: 2-byte loads) and 5."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    qkv = torch.randn(b, *hw, 3 * heads * ch, device="cuda", generator=gen).bfloat16()
    got, again = tgram.mdta_gram_fwd(qkv, heads), tgram.mdta_gram_fwd(qkv, heads)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, tgram.mdta_gram_plain(qkv.double(), heads)):
        assert g.dtype == torch.float32 and _within(g, w) and torch.equal(g, a)
    attn = torch.softmax(torch.randn(b, heads, ch, ch, device="cuda", generator=gen), -1)
    out, again = tgram.attn_apply_fwd(qkv, attn), tgram.attn_apply_fwd(qkv, attn)
    torch.cuda.synchronize()
    assert _bf16_within(out, tgram.attn_apply_plain(qkv, attn)) and torch.equal(out, again)


@pytest.mark.cuda
def test_fp32_only_kernels_refuse_bf16_by_its_dtype(cuda_device):
    """Every row has a bf16 form now; what a form does not take raises by
    dtype, never casts: bf16 taps at row 11's bf16 forms (which take the
    fp32 taps the dwconv tier passes), an fp32 k beside a bf16 q at row 10.
    Row 5's head configuration and rows 8-9's GDFN in bf16: a bf16 call
    launches them, once each, and returns bf16 (dln fp32)."""
    p = _to_bf16(_block_inputs(torch.Generator(device="cuda").manual_seed(17), 1, 8, 8, 8,
                               True))
    head = [p["x"], p["ln_w"], p["ln_b"], p["w_qkv"], p["dw_qkv"]]
    gdfn = [p["x"], p["w_in"], p["dw_in"], p["w_out"]]
    q = torch.zeros(1, 1, 8, 64, device="cuda", dtype=torch.bfloat16)
    for call in (lambda: tdw.dwconv3x3(p["x"], p["dw_qkv"][:8]),
                 lambda: tmdta.mdta_attend(q, q.float(), q, torch.ones(1, 1, 1, device="cuda"))):
        with pytest.raises(ValueError, match="bfloat16|float32"):
            call()
    for name, call in (
            ("block_head_bwd_bf16",
             lambda: tblock.block_head_bwd(*head, torch.zeros_like(p["x"]).repeat(1, 1, 1, 3))),
            ("gdfn_fused_bf16", lambda: (tfused.fused_dwconv_fwd(*gdfn),)),
            ("gdfn_fused_bwd_bf16",
             lambda: tfused.fused_dwconv_bwd(*gdfn, torch.zeros_like(p["x"])))):
        n0 = build.LAUNCHES[name]
        outs = [t for t in call() if t is not None]
        assert build.LAUNCHES[name] == n0 + 1, name
        assert {t.dtype for t in outs} <= {torch.bfloat16, torch.float32}
        assert outs[0].dtype == torch.bfloat16, name


@pytest.mark.cuda
def test_a_bf16_tnet_on_the_card_matches_the_cpu(cuda_device):
    """A small T_net served in bf16 (make_restorer's dtype) on the card
    against the same restorer on the CPU: mean|card - CPU| within a quarter
    of mean|fp32 - bf16| (tests/test_torch_bf16.py says why the mean), each
    bf16 kernel launched once a block and no fp32 row 1-4 kernel."""
    import numpy as np

    from rcot_torch.models.inference import make_restorer
    cfg = ModelConfig(dim=16, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                      parity_params=False)
    net = TNet(cfg, device="cpu", seed=3).eval()
    img = np.random.default_rng(3).uniform(0, 1, (64, 64, 3)).astype(np.float32)
    cpu16 = make_restorer(net, cfg, device="cpu", dtype=torch.bfloat16)(img)
    cpu32 = make_restorer(net, cfg, device="cpu")(img)
    before = dict(build.LAUNCHES)
    card = make_restorer(net.cuda(), cfg, device="cuda", dtype=torch.bfloat16)(img)
    launched = {k: v - before.get(k, 0) for k, v in build.LAUNCHES.items()
                if v != before.get(k, 0)}
    assert set(launched) == {"block_head_bf16", "block_tail_bf16", "mdta_gram_fwd_bf16",
                             "attn_apply_fwd_bf16"}
    assert len(set(launched.values())) == 1
    err, gap = np.abs(card - cpu16).mean(), np.abs(cpu32 - cpu16).mean()
    assert err <= gap / 4, (err, gap)


# ------------------------------------------------------------ bf16 training

def _bf16_train_calls(p, g_m, g_c):
    """{name: (kernel, bf16 twin, the twin's arithmetic in float64)} of row
    8's forward and rows 9 and 5 backward, both configurations each, on
    bf16 p."""
    import functools
    qkv = [p["x"], p["w_qkv"], p["dw_qkv"]]
    gdfn = [p["x"], p["w_in"], p["dw_in"], p["w_out"]]
    head = [p[k] for k in ("x", "ln_w", "ln_b", "w_qkv", "dw_qkv")]
    tail = [p[k] for k in ("x", "a", "w_proj", "ln_w", "ln_b", "w_in", "dw_in", "w_out")]
    rounded = functools.partial(tblock._block_tail_rounded, torch.bfloat16)
    head_rounded = functools.partial(tblock._block_head_rounded, torch.bfloat16)
    return {
        "gdfn_fused_bf16": (lambda: (tfused.fused_dwconv_fwd(*gdfn),),
                            lambda: (tfused.fused_dwconv_plain(*gdfn),), None),
        "gdfn_fused_bwd_bf16": (lambda: tfused.fused_dwconv_bwd(*gdfn, g_c),
                                lambda: tfused.fused_dwconv_bwd_plain(*gdfn, g_c), None),
        "block_head_bwd_bf16": (lambda: tblock.block_head_bwd(*head, g_m),
                                lambda: tblock.block_head_bwd_plain(*head, g_m),
                                lambda: tblock._vjp_plain(head_rounded, _double(head),
                                                          g_m.double())),
        "conv1x1_dw_bf16": (lambda: (tfused.fused_dwconv_fwd(*qkv, None),),
                            lambda: (tfused.fused_dwconv_plain(*qkv, None),), None),
        "conv1x1_dw_bwd_bf16": (lambda: tfused.fused_dwconv_bwd(*qkv, None, g_m)[:3],
                                lambda: tfused.fused_dwconv_bwd_plain(*qkv, None, g_m)[:3],
                                None),
        "block_tail_bwd_bf16": (lambda: tblock.block_tail_bwd(*tail, g_c),
                                lambda: tblock.block_tail_bwd_plain(*tail, g_c),
                                lambda: tblock._vjp_plain(rounded, _double(tail), g_c.double())),
    }


BF16_FLIP_RTOL = 1e-3
BF16_MODEL_RATIO = 0.25
F32_RTOL = {"block_tail_bwd_bf16": BF16_FLIP_RTOL, "block_head_bwd_bf16": BF16_FLIP_RTOL,
            "attn_apply_bwd_bf16": RTOL}


def _check_bf16_outputs(name, got, again, want, want64):
    for i, (gt, ag, wt) in enumerate(zip(got, again, want)):
        if gt is None:
            continue
        assert torch.equal(gt, ag), (name, i)
        if gt.dtype == torch.bfloat16:
            assert _bf16_within(gt, wt), (name, i)
            continue
        assert gt.dtype == wt.dtype == torch.float32
        err = float((gt.double() - want64[i]).abs().max())
        scale = max(float(want64[i].abs().max()), 1.0)
        assert err <= F32_RTOL[name] * scale, (name, i, err, scale)


# rows 8-9 and 5 in bf16, both configurations each: C = 6 (h = 15), odd h (127, 255,
# 1,021), h = 510, split products (the latent), B = 3
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 20, 19, 6), (3, 16, 16, 48), (1, 16, 16, 192),
                                   (1, 9, 33, 384), (3, 8, 8, 384), (1, 24, 40, 96)])
@pytest.mark.parametrize("ln_bias", [True, False], ids=["WithBias", "BiasFree"])
def test_bf16_train_block_kernels_match_their_twins_and_repeat(cuda_device, shape, ln_bias):
    gen = torch.Generator(device="cuda").manual_seed(18)
    p = _to_bf16(_block_inputs(gen, *shape, ln_bias))
    g_m = torch.randn(*shape[:3], 3 * shape[3], device="cuda", generator=gen).bfloat16()
    g_c = torch.randn(*shape, device="cuda", generator=gen).bfloat16()
    for name, (fn, plain, plain64) in _bf16_train_calls(p, g_m, g_c).items():
        n0 = build.LAUNCHES[name]
        got, again = fn(), fn()
        torch.cuda.synchronize()
        assert build.LAUNCHES[name] == n0 + 2, name
        _check_bf16_outputs(name, got, again, plain(), plain64() if plain64 else None)


@pytest.mark.cuda
@pytest.mark.parametrize("b,heads,ch,hw", [(1, 1, 48, (64, 64)), (2, 8, 48, (16, 16)),
                                           (3, 4, 24, (33, 7)), (1, 1, 192, (32, 32)),
                                           (1, 1, 150, (9, 9)), (2, 2, 5, (6, 7))])
def test_bf16_mdta_backward_kernels_match_their_twins_and_repeat(cuda_device, b, heads, ch,
                                                                 hw):
    """Rows 6-7 on a bf16 qkv and cotangent: d[q|k] and dv bf16, dattn fp32
    (against float64), at the heads of the bf16 Gram's test."""
    gen = torch.Generator(device="cuda").manual_seed(19)

    def r(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)
    qkv = r(b, *hw, 3 * heads * ch).bfloat16()
    dgram, dnq, dnk = r(b, heads, ch, ch), r(b, heads, ch), r(b, heads, ch)
    attn = torch.softmax(r(b, heads, ch, ch), -1)
    g = r(b, *hw, heads * ch).bfloat16()
    n0 = build.LAUNCHES["mdta_gram_bwd_bf16"], build.LAUNCHES["attn_apply_bwd_bf16"]
    got, again = (tgram.mdta_gram_bwd(qkv, dgram, dnq, dnk, heads) for _ in range(2))
    apply, apply2 = (tgram.attn_apply_bwd(qkv, attn, g) for _ in range(2))
    torch.cuda.synchronize()
    assert (build.LAUNCHES["mdta_gram_bwd_bf16"], build.LAUNCHES["attn_apply_bwd_bf16"]) == (
        n0[0] + 2, n0[1] + 2)
    _check_bf16_outputs("mdta_gram_bwd_bf16", (got,), (again,),
                        (tgram.mdta_gram_bwd_plain(qkv, dgram, dnq, dnk, heads),), None)
    want64 = tgram.attn_apply_bwd_plain(qkv.double(), attn.double(), g.double())
    _check_bf16_outputs("attn_apply_bwd_bf16", apply, apply2,
                        tgram.attn_apply_bwd_plain(qkv, attn, g), want64)


# the bf16 kernels of one training block in each composition
BF16_TRAIN_SIDES = {"full": ("block_head_bf16", "block_tail_bf16"),
                    "head": ("block_head_bf16", "gdfn_fused_bf16"),
                    "tail": ("conv1x1_dw_bf16", "block_tail_bf16"),
                    "off": ("conv1x1_dw_bf16", "gdfn_fused_bf16")}


@pytest.mark.cuda
@pytest.mark.parametrize("composition", list(BF16_TRAIN_SIDES))
def test_a_bf16_tnet_trains_on_the_card_as_on_the_cpu(cuda_device, composition):
    """A small T_net in each composition on a bf16 input, differentiated
    for a bf16 cotangent of its output, on the card against the CPU: the
    gradients, all together, within a quarter of what bf16 changes on the
    CPU; each bf16 kernel of the composition, forward and backward,
    launched once a block, and no fp32 form of rows 1-9."""
    import copy

    cfg = ModelConfig(dim=16, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                      parity_params=False)
    net = TNet(cfg, device="cpu", seed=4, composition=composition)
    gen = torch.Generator().manual_seed(4)
    x = torch.rand(2, 32, 32, 3, generator=gen)
    g = torch.randn(2, 32, 32, 3, generator=gen).bfloat16()

    def grads(n, dtype, dev):
        named = list(n.named_parameters())
        out = n(x.to(dev, dtype))[0]
        gs = torch.autograd.grad(out, [q for _, q in named], g.to(dev, dtype),
                                 allow_unused=True)
        return {k: t.float().cpu() for (k, _), t in zip(named, gs) if t is not None}
    cpu16, cpu32 = grads(net, torch.bfloat16, "cpu"), grads(net, torch.float32, "cpu")
    before = dict(build.LAUNCHES)
    card = grads(copy.deepcopy(net).cuda(), torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    launched = {k: v - before.get(k, 0) for k, v in build.LAUNCHES.items()
                if v != before.get(k, 0)}
    sides = BF16_TRAIN_SIDES[composition]
    assert set(launched) == {*sides, *(k.replace("_bf16", "_bwd_bf16") for k in sides),
                             "mdta_gram_fwd_bf16", "attn_apply_fwd_bf16",
                             "mdta_gram_bwd_bf16", "attn_apply_bwd_bf16"}, launched
    assert len(set(launched.values())) == 1
    assert card.keys() == cpu16.keys()
    err = sum(float((card[k] - cpu16[k]).abs().sum()) for k in card)
    gap = sum(float((cpu32[k] - cpu16[k]).abs().sum()) for k in card)
    assert err <= BF16_MODEL_RATIO * gap, (err, gap)


# ------------------------------------------------------- bf16 opt-in tiers

@pytest.mark.cuda
@pytest.mark.parametrize("b,heads,ch,n", [(1, 1, 48, 4096), (3, 2, 48, 1024), (1, 1, 192, 1024),
                                          (2, 2, 24, 1025), (1, 1, 48, 80250), (2, 4, 16, 63)])
def test_bf16_mdta_attend_matches_its_twin_and_repeats(cuda_device, b, heads, ch, n):
    """Row 10 in bf16: 16-byte copies (N % 8 == 0), a head of 192 (two
    channel blocks, slots summed and rounded once), element copies (N odd,
    N % 8 == 2); one count a call, no fp32 launch."""
    gen = torch.Generator(device="cuda").manual_seed(20)
    q, k, v = (torch.randn(b, heads, ch, n, device="cuda", generator=gen).bfloat16()
               for _ in range(3))
    temp = torch.rand(heads, 1, 1, device="cuda", generator=gen) + 0.5
    n0, n32 = build.LAUNCHES["mdta_attend_bf16"], build.LAUNCHES["mdta_attend"]
    got, again = (tmdta.mdta_attend_fwd(q, k, v, temp) for _ in range(2))
    torch.cuda.synchronize()
    assert (build.LAUNCHES["mdta_attend_bf16"], build.LAUNCHES["mdta_attend"]) == (n0 + 2, n32)
    assert _bf16_within(got, tmdta.mdta_attend_bf16_plain(q, k, v, temp))
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 16, 16, 144), (3, 8, 8, 254), (1, 20, 19, 6),
                                   (2, 9, 33, 1020), (1, 1, 300, 42)])
def test_bf16_dwconv3x3_forms_match_their_twins_and_repeat(cuda_device, shape):
    """Row 11 in bf16 on fp32 taps: the forward and dx bf16 (copies of 8, 2
    and 4 bf16), dtaps fp32 against float64; each one count a call and
    bitwise on a repeat."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    x, g = (torch.randn(*shape, device="cuda", generator=gen).bfloat16() for _ in range(2))
    taps = torch.randn(shape[-1], 3, 3, device="cuda", generator=gen) * 0.3
    for name, fn, plain in (
            ("dwconv3x3_bf16", lambda: tdw.dwconv3x3_fwd(x, taps),
             lambda: tdw.dwconv3x3_bf16_plain(x, taps)),
            ("dwconv3x3_dx_bf16", lambda: tdw.dwconv3x3_dx(g, taps),
             lambda: tdw.dwconv3x3_bf16_plain(g, taps.flip(1, 2)))):
        n0 = build.LAUNCHES[name]
        got, again = fn(), fn()
        torch.cuda.synchronize()
        assert build.LAUNCHES[name] == n0 + 2, name
        assert _bf16_within(got, plain()) and torch.equal(got, again), name
    n0 = build.LAUNCHES["dwconv3x3_dtaps_bf16"]
    got, again = tdw.dwconv3x3_dtaps(x, g), tdw.dwconv3x3_dtaps(x, g)
    torch.cuda.synchronize()
    assert build.LAUNCHES["dwconv3x3_dtaps_bf16"] == n0 + 2
    assert got.dtype == torch.float32 and torch.equal(got, again)
    want = tdw.dwconv3x3_dtaps_plain(x.double(), g.double())
    assert float((got.double() - want).abs().max()) <= RTOL * max(float(want.abs().max()), 1.0)


@pytest.mark.cuda
def test_the_jnp_route_launches_no_kernel(cuda_device):
    """At N = 2,112 (no chunk of the JAX kernel) bf16 takes the jnp formula,
    counted as mdta_attend_jnp_bf16; fp32 takes the kernel at every N."""
    q = torch.randn(1, 1, 48, 2112, device="cuda").bfloat16()
    temp = torch.ones(1, 1, 1, device="cuda")
    before = dict(build.LAUNCHES)
    out = tmdta.mdta_attend(q, q, q, temp)
    tmdta.mdta_attend(q.float(), q.float(), q.float(), temp)
    torch.cuda.synchronize()
    launched = {k: v - before.get(k, 0) for k, v in build.LAUNCHES.items()
                if v != before.get(k, 0)}
    assert launched == {"mdta_attend_jnp_bf16": 1, "mdta_attend": 1}
    assert torch.equal(out, tmdta.mdta_attend_jnp_bf16(q, q, q, temp))


@pytest.mark.cuda
def test_a_bf16_tnet_in_the_opt_in_tiers_on_the_card_matches_the_cpu(cuda_device):
    """A small T_net served in bf16 in off/mdta/dwconv and its gradients in
    tail/mdta/dwconv, on the card against the CPU: the quarter rule on the
    mean (serving) and summed (training); each bf16 form launched as often
    a block as its tier runs it, no fp32 row."""
    import copy

    import numpy as np

    from rcot_torch.models.inference import make_restorer
    cfg = ModelConfig(dim=16, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                      parity_params=False)
    net = TNet(cfg, device="cpu", seed=6).eval()
    tiers = dict(composition="off", attention_core="mdta", depthwise="dwconv")
    img = np.random.default_rng(6).uniform(0, 1, (64, 64, 3)).astype(np.float32)
    cpu16 = make_restorer(net, cfg, device="cpu", dtype=torch.bfloat16, **tiers)(img)
    cpu32 = make_restorer(net, cfg, device="cpu", **tiers)(img)
    before = dict(build.LAUNCHES)
    card = make_restorer(copy.deepcopy(net).cuda(), cfg, device="cuda", dtype=torch.bfloat16,
                         **tiers)(img)
    launched = {k: v - before.get(k, 0) for k, v in build.LAUNCHES.items()
                if v != before.get(k, 0)}
    # 22 blocks a two-pass forward: 4 + 4 encoding, 7 a decoder pass
    assert launched == {"mdta_attend_bf16": 22, "dwconv3x3_bf16": 44}, launched
    err, gap = np.abs(card - cpu16).mean(), np.abs(cpu32 - cpu16).mean()
    assert err <= gap / 4, (err, gap)

    net.composition, net.attention_core, net.depthwise = "tail", "mdta", "dwconv"
    gen = torch.Generator().manual_seed(6)
    x = torch.rand(2, 32, 32, 3, generator=gen)
    g = torch.randn(2, 32, 32, 3, generator=gen).bfloat16()

    def grads(n, dtype, dev):
        named = list(n.named_parameters())
        out = n(x.to(dev, dtype))[0]
        gs = torch.autograd.grad(out, [q for _, q in named], g.to(dev, dtype),
                                 allow_unused=True)
        return {k: t.float().cpu() for (k, _), t in zip(named, gs) if t is not None}
    cpu16, cpu32 = grads(net, torch.bfloat16, "cpu"), grads(net, torch.float32, "cpu")
    before = dict(build.LAUNCHES)
    card = grads(copy.deepcopy(net).cuda(), torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    launched = {k: v - before.get(k, 0) for k, v in build.LAUNCHES.items()
                if v != before.get(k, 0)}
    assert launched == {k: 22 for k in ("mdta_attend_bf16", "dwconv3x3_bf16",
                                        "dwconv3x3_dx_bf16", "dwconv3x3_dtaps_bf16",
                                        "block_tail_bf16", "block_tail_bwd_bf16")}, launched
    err = sum(float((card[k] - cpu16[k]).abs().sum()) for k in card)
    gap = sum(float((cpu32[k] - cpu16[k]).abs().sum()) for k in card)
    assert err <= BF16_MODEL_RATIO * gap, (err, gap)


# ------------------------------------------- bf16 operands (--bwd-bf16)

# A bf16-operand form against its plain twin with bf16 operands, by the rule
# that tells a form that rounds from one that does not (chip_smoke.py
# B16OPS_SHARE): on every output rounding reaches, mean|form - twin| <= 1/16
# of mean|3xTF32 form - twin|, max|form - twin| <= 2^-7 of max(max|twin|, 1)
# (one bf16 flip of an intermediate or of a bf16 output, an ulp: at most
# 2^-7 of the value); an output no
# rounded product reaches (UNREACHED: ddw where dconv is g itself or comes
# from bf16 operands, dattn on bf16 g and v) is held as the 3xTF32 form is.
B16OPS_SHARE, B16OPS_MAX_RTOL = 1.0 / 16, 2.0 ** -7
# the _bf16 forms round at the forward's rounding points and at their bf16
# outputs, flips the same in both distances: a quarter of the gap there
# (chip_smoke.py B16OPS_BF16_SHARE says why)
B16OPS_BF16_SHARE = 1.0 / 4
UNREACHED = {("block_head_bwd", 4), ("conv1x1_dw_bwd", 2), ("block_head_bwd_bf16", 4),
             ("conv1x1_dw_bwd_bf16", 2), ("block_tail_bwd_bf16", 6),
             ("gdfn_fused_bwd_bf16", 2), ("attn_apply_bwd_bf16", 1)}


def _b16ops_calls(p, g_m, g_c, qkv, heads, gen):
    """{base name: (wrapper, plain twin, arguments)} of rows 5, 6-7, 9."""
    b, h, w, c = p["x"].shape
    ch = c // heads

    def r(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)
    dgram, dnq, dnk = r(b, heads, ch, ch), r(b, heads, ch), r(b, heads, ch)
    attn = torch.softmax(r(b, heads, ch, ch), -1)
    head = [p["x"], p["ln_w"], p["ln_b"], p["w_qkv"], p["dw_qkv"], g_m]
    tail = [p[k] for k in ("x", "a", "w_proj", "ln_w", "ln_b", "w_in", "dw_in", "w_out")] + [g_c]
    return {
        "block_head_bwd": (tblock.block_head_bwd, tblock.block_head_bwd_plain, head),
        "block_tail_bwd": (tblock.block_tail_bwd, tblock.block_tail_bwd_plain, tail),
        "conv1x1_dw_bwd": (tfused.fused_dwconv_bwd, tfused.fused_dwconv_bwd_plain,
                           [p["x"], p["w_qkv"], p["dw_qkv"], None, g_m]),
        "gdfn_fused_bwd": (tfused.fused_dwconv_bwd, tfused.fused_dwconv_bwd_plain,
                           [p["x"], p["w_in"], p["dw_in"], p["w_out"], g_c]),
        "mdta_gram_bwd": (lambda *a, **k: (tgram.mdta_gram_bwd(*a, **k),),
                          lambda *a, **k: (tgram.mdta_gram_bwd_plain(*a, **k),),
                          [qkv, dgram, dnq, dnk, heads]),
        "attn_apply_bwd": (tgram.attn_apply_bwd, tgram.attn_apply_bwd_plain, [qkv, attn, g_c]),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("shape,heads", [((1, 20, 19, 6), 1), ((3, 16, 16, 48), 1),
                                         ((1, 16, 16, 192), 4), ((1, 9, 33, 384), 8),
                                         ((2, 8, 8, 144), 1)])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_bf16_operand_forms_match_their_twins_and_repeat(cuda_device, shape, heads, dtype):
    """Rows 5 (head, tail), 6-7 and 9 (qkv, GDFN) with bf16_ops, on fp32 and
    bf16 activations: one count a call under the form's _b16ops name, two
    calls bitwise equal, the rule above B16OPS_SHARE against the twin."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    p = _block_inputs(gen, *shape, True)
    bf = dtype == "bf16"
    p = _to_bf16(p) if bf else p
    dt = torch.bfloat16 if bf else torch.float32
    g_m = torch.randn(*shape[:3], 3 * shape[3], device="cuda", generator=gen).to(dt)
    g_c = torch.randn(*shape, device="cuda", generator=gen).to(dt)
    qkv = torch.randn(*shape[:3], 3 * shape[3], device="cuda", generator=gen).to(dt)
    for base, (fn, plain, args) in _b16ops_calls(p, g_m, g_c, qkv, heads, gen).items():
        name = build.counted(f"{base}_bf16" if bf else base, True)
        n0 = build.LAUNCHES[name]
        got, again = fn(*args, bf16_ops=True), fn(*args, bf16_ops=True)
        torch.cuda.synchronize()
        assert build.LAUNCHES[name] == n0 + 2, name
        want, old = plain(*args, bf16_ops=True), fn(*args)
        for i, (x, y, w, o) in enumerate(zip(got, again, want, old)):
            if x is None:
                continue
            assert torch.equal(x, y), (name, i)
            assert x.dtype == w.dtype and x.shape == w.shape, (name, i)
            d = (x.double() - w.double()).abs()
            gap = float((o.double() - w.double()).abs().mean())
            scale = max(float(w.abs().max()), 1.0)
            if (name.replace("_b16ops", ""), i) in UNREACHED:
                assert float(d.max()) <= (BF16_RTOL if bf else RTOL) * scale, (name, i)
                continue
            share = B16OPS_BF16_SHARE if bf else B16OPS_SHARE
            assert float(d.mean()) <= share * gap, (name, i, float(d.mean()), gap)
            assert float(d.max()) <= B16OPS_MAX_RTOL * scale, (name, i)


@pytest.mark.cuda
@pytest.mark.parametrize("composition", ["full", "tail", "head", "off"])
def test_a_tnet_with_every_tier_on_bf16_operands_trains_on_the_card_as_on_the_cpu(
        cuda_device, composition):
    """A small fp32 T_net with bwd_bf16="all" on the card against the CPU:
    each backward of its composition launched once a block in its _b16ops
    form and none in its 3xTF32 form; the gradients, all together, within
    0.9 of what the option changes on the CPU (chip_smoke.py
    B16OPS_MODEL_RATIO says why the rule is no tighter)."""
    import copy

    cfg = ModelConfig(dim=16, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                      parity_params=False)
    net = TNet(cfg, device="cpu", seed=4, composition=composition, bwd_bf16="all")
    gen = torch.Generator().manual_seed(4)
    x = torch.rand(2, 32, 32, 3, generator=gen)
    g = torch.randn(2, 32, 32, 3, generator=gen)

    def grads(n, dev):
        named = list(n.named_parameters())
        out = n(x.to(dev))[0]
        gs = torch.autograd.grad(out, [q for _, q in named], g.to(dev), allow_unused=True)
        return {k: t.cpu() for (k, _), t in zip(named, gs) if t is not None}
    cpu16 = grads(net, "cpu")
    net.bwd_bf16 = "0"
    cpu32 = grads(net, "cpu")
    net.bwd_bf16 = "all"
    before = dict(build.LAUNCHES)
    card = grads(copy.deepcopy(net).cuda(), "cuda")
    torch.cuda.synchronize()
    launched = {k: v - before.get(k, 0) for k, v in build.LAUNCHES.items()
                if v != before.get(k, 0)}
    bwd = {"full": ("block_head_bwd", "block_tail_bwd"), "tail": ("conv1x1_dw_bwd",
                                                                  "block_tail_bwd"),
           "head": ("block_head_bwd", "gdfn_fused_bwd"),
           "off": ("conv1x1_dw_bwd", "gdfn_fused_bwd")}[composition]
    assert {k for k in launched if k.endswith("_bwd") or "_bwd_" in k} == {
        f"{k}_b16ops" for k in (*bwd, "mdta_gram_bwd", "attn_apply_bwd")}, launched
    assert len(set(launched.values())) == 1
    err = sum(float((card[k] - cpu16[k]).abs().sum()) for k in card)
    gap = sum(float((cpu32[k] - cpu16[k]).abs().sum()) for k in card)
    assert 0.0 < err <= 0.9 * gap, (err, gap)


# Row 6's bf16 forms on bf16 tiles and row 4's bf16 form with its own plan
# (csrc/gram_bwd.cuh on bf16, csrc/gram_bf16.cu apply_bf16_kernel): odd
# widths (25: 2-byte copies; 26: 4-byte), a ragged pixel count (250 x 321),
# the main path's heads (48, 96), the latent's eight heads and a head of
# 192 (two channel blocks of 96)
BF16_REDESIGN_SHAPES = [(2, 9, 13, 3, 25), (2, 17, 19, 2, 26), (1, 250, 321, 1, 48),
                        (3, 128, 128, 1, 48), (3, 64, 64, 1, 96), (3, 16, 16, 8, 48),
                        (1, 64, 64, 1, 192)]


def _device_records(fn):
    """Kernels, memsets and copies one call of fn puts on the card. The
    profiler may drop a window's records (a window of 0 of 18 and one of
    18 of 19 were seen on the card) but never adds one, so the call is
    profiled up to three times, until two windows agree, and the longest
    window is returned: every count asserted on it stays exact."""
    fn()
    torch.cuda.synchronize()
    windows = []
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if any(sorted(names) == sorted(seen) for seen in windows):
            return names
        windows.append(names)
    return max(windows, key=len)


# The bf16 head's and qkv's product-depthwise (csrc/pw_dw.cu): the
# redesign shapes with C = heads x ch made even (the bf16 depthwise's
# copies move two bf16), which holds the training latent's split K (16^2 x
# 384 at B = 3: two ranges), and three more splits (three, four and five
# ranges, the fixed-order sum's groups of two and four) and C past 512 (a
# step of one row, a ring of two)
PW_DW_SHAPES = ([(b, h, w, heads * ch + (heads * ch) % 2)
                 for b, h, w, heads, ch in BF16_REDESIGN_SHAPES]
                + [(1, 9, 33, 384), (1, 12, 12, 576), (1, 8, 9, 1024)])


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c", PW_DW_SHAPES)
def test_the_bf16_head_and_qkv_take_the_product_in_the_depthwise_with_the_launches_bits(
        cuda_device, b, h, w, c):
    """block_head_bf16 (both LayerNorm kinds) and conv1x1_dw_bf16: the
    product-depthwise (after the head's ln_fwd) equals, bit for bit, the
    bf16 product and the depthwise in launches of their own that it
    replaces (the wrappers' `launches`), at every split of K; a second call
    is bitwise equal; a call counts one launch and puts one kernel on the
    card (two in the head: its LayerNorm), none of them the depthwise or
    the product alone, and allocates its output and, in the head, one
    workspace (u and stats); each sits within BF16_RTOL of its plain twin."""
    gen = torch.Generator(device="cuda").manual_seed(24)
    p = _to_bf16(_block_inputs(gen, b, h, w, c, True))
    for name, call, plain in (
            ("block_head_bf16",
             lambda launches=False: tblock._block_head_bf16(
                 p["x"], p["ln_w"], p["ln_b"], p["w_qkv"], p["dw_qkv"], launches),
             lambda: tblock.block_head_plain(p["x"], p["ln_w"], p["ln_b"], p["w_qkv"],
                                             p["dw_qkv"])),
            ("block_head_bf16",
             lambda launches=False: tblock._block_head_bf16(
                 p["x"], p["ln_w"], None, p["w_qkv"], p["dw_qkv"], launches),
             lambda: tblock.block_head_plain(p["x"], p["ln_w"], None, p["w_qkv"], p["dw_qkv"])),
            ("conv1x1_dw_bf16",
             lambda launches=False: tfused._conv1x1_dw_bf16(p["x"], p["w_qkv"], p["dw_qkv"],
                                                            launches),
             lambda: tfused.fused_dwconv_plain(p["x"], p["w_qkv"], p["dw_qkv"], None))):
        head = name == "block_head_bf16"
        n0 = build.LAUNCHES[name]
        torch.cuda.synchronize()
        allocs0 = torch.cuda.memory_stats()["allocation.all.allocated"]
        got = call()
        allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - allocs0
        again, launches = call(), call(launches=True)
        torch.cuda.synchronize()
        assert build.LAUNCHES[name] == n0 + 3
        assert got.dtype == torch.bfloat16 and torch.equal(got, again)
        assert torch.equal(got, launches), (name, int((got != launches).sum()))
        assert _bf16_within(got, plain())
        records = _device_records(call)
        assert sum("pw_dw_kernel" in r for r in records) == 1, records
        assert len(records) == (2 if head else 1), records
        assert not any("dwconv3x3_kernel" in r or "mm_kernel" in r for r in records), records
        assert allocs == (2 if head else 1), allocs


@pytest.mark.cuda
@pytest.mark.parametrize("c", [2, 6, 25, 26, 48, 96, 128, 192, 256, 384, 576, 768, 1024, 2048,
                               2880])
def test_the_product_depthwises_blocks_an_sm_are_the_plans(cuda_device, c):
    """The shared memory and the launch bound that ops/dwconv.py mirrors
    (pw_dw_smem, PW_BLOCKS_PER_SM) are the kernel's own at the plan's chunk
    and ring, for the instance of C's step (pw_dw_group), and the card's
    occupancy calculator holds at least the plan's blocks an SM."""
    import ctypes
    cw, stages = tdw.pw_dw_fit(c, 3 * c)
    got, nbytes, least = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    assert build.library().rcot_pw_dw_bf16_blocks_per_sm(
        c, cw, stages, ctypes.byref(got), ctypes.byref(nbytes), ctypes.byref(least)) == 0
    assert (nbytes.value, least.value) == (tdw.pw_dw_smem(c, cw, stages), tdw.PW_BLOCKS_PER_SM)
    assert got.value >= tdw.pw_dw_per_sm(c, cw, stages) >= 1, got.value


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,heads,ch", BF16_REDESIGN_SHAPES)
@pytest.mark.parametrize("bf16_ops", [False, True], ids=["3xtf32", "ops16"])
def test_bf16_gram_backward_is_one_launch_with_the_widening_designs_bits(cuda_device, b, h, w,
                                                                         heads, ch, bf16_ops):
    """d[q|k] on a bf16 qkv equals, bit for bit, the fp32 kernel's on the
    widened qkv rounded once (the design it replaces: the dropped term added
    exact zeros, every other sum keeps its order), sits within BF16_RTOL of
    its twin, repeats bitwise, counts one launch a call and puts one kernel
    on the card (two where the head is cut into channel blocks: the slots'
    sum), and allocates nothing but d[q|k] (and the slots of a head cut
    into channel blocks): no fp32 copy of qkv or d[q|k]."""
    gen = torch.Generator(device="cuda").manual_seed(23)

    def r(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)
    qkv = r(b, h, w, 3 * heads * ch).bfloat16()
    cot = [r(b, heads, ch, ch), r(b, heads, ch), r(b, heads, ch)]
    name = build.counted("mdta_gram_bwd_bf16", bf16_ops)
    n0 = build.LAUNCHES[name]
    torch.cuda.synchronize()
    allocs0 = torch.cuda.memory_stats()["allocation.all.allocated"]
    got = tgram.mdta_gram_bwd(qkv, *cot, heads, bf16_ops)
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - allocs0
    again = tgram.mdta_gram_bwd(qkv, *cot, heads, bf16_ops)
    widened = tgram.mdta_gram_bwd(qkv.float(), *cot, heads, bf16_ops).bfloat16()
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == n0 + 2
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    assert torch.equal(got, widened)
    assert _bf16_within(got, tgram.mdta_gram_bwd_plain(qkv, *cot, heads, bf16_ops))
    nb = tgram.channel_blocks(ch)[0]
    records = _device_records(lambda: tgram.mdta_gram_bwd(qkv, *cot, heads, bf16_ops))
    assert len(records) == (1 if nb == 1 else 2), records
    assert allocs == (1 if nb == 1 else 2), allocs


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,heads,ch", BF16_REDESIGN_SHAPES)
def test_bf16_apply_matches_its_twin_and_repeats_in_one_launch(cuda_device, b, h, w, heads,
                                                               ch):
    gen = torch.Generator(device="cuda").manual_seed(24)
    qkv = torch.randn(b, h, w, 3 * heads * ch, device="cuda", generator=gen).bfloat16()
    attn = torch.softmax(torch.randn(b, heads, ch, ch, device="cuda", generator=gen), -1)
    n0 = build.LAUNCHES["attn_apply_fwd_bf16"]
    out, again = tgram.attn_apply_fwd(qkv, attn), tgram.attn_apply_fwd(qkv, attn)
    torch.cuda.synchronize()
    assert build.LAUNCHES["attn_apply_fwd_bf16"] == n0 + 2
    assert _bf16_within(out, tgram.attn_apply_plain(qkv, attn)) and torch.equal(out, again)
    nb = tgram.channel_blocks(ch)[0]
    records = _device_records(lambda: tgram.attn_apply_fwd(qkv, attn))
    assert len(records) == (1 if nb == 1 else 2), records


@pytest.mark.cuda
@pytest.mark.parametrize("ch", [16, 25, 32, 48, 64, 96, 112, 128, 192, 384])
def test_the_bf16_plans_blocks_an_sm_fit_on_the_card(cuda_device, ch):
    """The blocks an SM that apply_bf16_plan and gram_bwd_bf16_plan count on
    fit there: the card's occupancy calculator, given each kernel's shared
    memory and registers, holds at least as many; and the plans' copies of
    the kernels' shared memory and launch bounds are the kernels' own."""
    import ctypes
    cb = tgram.channel_blocks(ch)[1]
    lib = build.library()
    got, nbytes, least = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    outs = (ctypes.byref(got), ctypes.byref(nbytes), ctypes.byref(least))
    assert lib.rcot_attn_apply_bf16_blocks_per_sm(ch, cb, *outs) == 0
    assert got.value >= tgram.apply_bf16_per_sm(cb), (got.value, tgram.apply_bf16_per_sm(cb))
    assert (nbytes.value, least.value) == (tgram.apply_bf16_smem(cb),
                                           tgram.apply_bf16_per_sm(cb))
    reg_blocks = tgram._gram_bwd_bf16_reg_blocks(tgram._width(cb)[0])
    for form in ("mdta_gram_bwd_bf16", "mdta_gram_bwd_bf16_b16ops"):
        assert getattr(lib, f"rcot_{form}_blocks_per_sm")(ch, cb, *outs) == 0
        assert got.value >= tgram.gram_bwd_bf16_per_sm(cb), (form, got.value)
        assert (nbytes.value, least.value) == (tgram.gram_bwd_bf16_smem(cb), reg_blocks), form


# Row 7's bf16 forms on bf16 tiles (csrc/apply_bwd_bf16.cu, gram_bwd.cuh's
# apply backward on bf16): BF16_REDESIGN_SHAPES and two shapes whose (b,
# head) is one pixel range (splits == 1: one launch)
BF16_APPLY_BWD_SHAPES = BF16_REDESIGN_SHAPES + [(2, 8, 8, 2, 48), (1, 8, 8, 1, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,heads,ch", BF16_APPLY_BWD_SHAPES)
@pytest.mark.parametrize("bf16_ops", [False, True], ids=["3xtf32", "ops16"])
def test_bf16_apply_backward_on_bf16_tiles_keeps_the_widening_designs_bits(
        cuda_device, b, h, w, heads, ch, bf16_ops):
    """dv and dattn on a bf16 qkv and g equal, bit for bit, the fp32
    kernel's on the widened qkv and g with dv rounded once to bf16 (RNE; the
    design it replaces: the dropped terms added exact zeros, every other sum
    keeps its order); dv sits within BF16_RTOL of its twin and dattn within
    RTOL of the twin's arithmetic in float64; both repeat bitwise; a call
    counts one launch and puts one kernel on the card where a (b, head) is
    one pixel range and one channel block (gram_pairs_plan's splits == 1),
    with the fixed-order reduce of dattn's partials where it is more and the
    slots' sum where the head is cut into channel blocks; and it allocates
    nothing but dv, dattn and one workspace (the partials and the slots)
    where there is one: no fp32 copy of qkv, g or dv."""
    gen = torch.Generator(device="cuda").manual_seed(25)

    def r(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)
    qkv = r(b, h, w, 3 * heads * ch).bfloat16()
    attn = torch.softmax(r(b, heads, ch, ch), -1)
    g = r(b, h, w, heads * ch).bfloat16()
    name = build.counted("attn_apply_bwd_bf16", bf16_ops)
    n0 = build.LAUNCHES[name]
    torch.cuda.synchronize()
    allocs0 = torch.cuda.memory_stats()["allocation.all.allocated"]
    dv, dattn = tgram.attn_apply_bwd(qkv, attn, g, bf16_ops)
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - allocs0
    dv2, dattn2 = tgram.attn_apply_bwd(qkv, attn, g, bf16_ops)
    wide_dv, wide_dattn = tgram.attn_apply_bwd(qkv.float(), attn, g.float(), bf16_ops)
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == n0 + 2
    assert dv.dtype == torch.bfloat16 and dattn.dtype == torch.float32
    assert torch.equal(dv, dv2) and torch.equal(dattn, dattn2)
    assert torch.equal(dv, wide_dv.bfloat16()) and torch.equal(dattn, wide_dattn)
    assert _bf16_within(dv, tgram.attn_apply_bwd_plain(qkv, attn, g, bf16_ops)[0])
    assert _within(dattn, tgram.attn_apply_bwd_plain(qkv.double(), attn.double(), g.double(),
                                                     bf16_ops)[1])
    nb = tgram.channel_blocks(ch)[0]
    splits = tgram.gram_pairs_plan(b, h * w, heads, ch, tgram.sm_count(0))[0]
    records = _device_records(lambda: tgram.attn_apply_bwd(qkv, attn, g, bf16_ops))
    assert len(records) == 1 + (splits > 1) + (nb > 1), records
    assert allocs == 2 + (splits > 1 or nb > 1), allocs


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,heads,ch", BF16_APPLY_BWD_SHAPES)
def test_bf16_gram_forward_matches_float64_and_repeats_bitwise(cuda_device, b, h, w, heads, ch):
    """G, nq and nk on a bf16 qkv each within RTOL of its largest value
    (the fp32 Gram's gate) against the twin's arithmetic in float64, bitwise
    on a repeat; a
    call counts one launch and puts the kernel on the card, with the
    fixed-order reduce of its ranges' partials where a (b, head) is more
    than one range (gram_pairs_plan) and nothing else."""
    gen = torch.Generator(device="cuda").manual_seed(26)
    qkv = torch.randn(b, h, w, 3 * heads * ch, device="cuda", generator=gen).bfloat16()
    n0 = build.LAUNCHES["mdta_gram_fwd_bf16"]
    got, again = tgram.mdta_gram_fwd(qkv, heads), tgram.mdta_gram_fwd(qkv, heads)
    torch.cuda.synchronize()
    assert build.LAUNCHES["mdta_gram_fwd_bf16"] == n0 + 2
    for x, y, z in zip(got, again, tgram.mdta_gram_plain(qkv.double(), heads)):
        assert x.dtype == torch.float32 and torch.equal(x, y) and _within(x, z)
    splits = tgram.gram_pairs_plan(b, h * w, heads, ch, tgram.sm_count(0))[0]
    records = _device_records(lambda: tgram.mdta_gram_fwd(qkv, heads))
    assert len(records) == 1 + (splits > 1), records


@pytest.mark.cuda
@pytest.mark.parametrize("ch", [16, 24, 25, 32, 48, 64, 96, 112, 128, 192])
def test_the_bf16_apply_backwards_blocks_an_sm_fit_on_the_card(cuda_device, ch):
    """The blocks an SM that apply_bwd_bf16_per_sm counts on fit there, in
    both operand policies, and the Python copies of the kernel's shared
    memory and launch bounds are the kernel's own."""
    import ctypes
    cb = tgram.channel_blocks(ch)[1]
    lib = build.library()
    got, nbytes, least = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    outs = (ctypes.byref(got), ctypes.byref(nbytes), ctypes.byref(least))
    reg_blocks = tgram._apply_bwd_bf16_reg_blocks(tgram._width(cb)[0])
    for form in ("attn_apply_bwd_bf16", "attn_apply_bwd_bf16_b16ops"):
        assert getattr(lib, f"rcot_{form}_blocks_per_sm")(ch, cb, *outs) == 0
        assert got.value >= tgram.apply_bwd_bf16_per_sm(cb), (form, got.value)
        assert (nbytes.value, least.value) == (tgram.apply_bwd_bf16_smem(cb), reg_blocks), form


# Rows 5 and 9's backwards in bf16 on bf16 tiles, both configurations each
# (csrc/block_bwd_bf16.cu, fused_dwconv_bf16.cu on mm.cuh's tf32 path with
# bf16 tiles, dwconv.cu's conv_taps16, conv_bf16_rot and dtaps_16,
# ln_bwd.cuh on bf16): C = 6 (h = 15), the level-1 shapes at B = 3, odd h (127, 255,
# 1,021), a split latent and C = 576, past the 512 channels the LayerNorm
# holds in registers
BF16_TILE_SHAPES = [(1, 20, 19, 6), (3, 128, 128, 48), (3, 128, 128, 96), (2, 12, 13, 192),
                    (1, 9, 33, 384), (1, 8, 9, 576)]


def _exact_recompute_inputs(gen, b, h, w, c):
    """bf16 block inputs on which the bf16 recompute rounds nothing: x in
    [-2, 2] and a in [-1, 1] integers, 1x1 weights with four entries of +-1 a
    row, ln_w 0 and ln_b in {-1, 0, 1}, so t, u = ln_b and h are small
    integers, exact in bf16 and in the fp32 kernels alike; the taps, W_out
    and everything after the recompute random."""
    hid = int(c * 2.66)

    def ints(*shape, lo, hi):
        return torch.randint(lo, hi + 1, shape, device="cuda", generator=gen).float()

    def sparse(rows, cols):
        m = torch.zeros(rows, cols, device="cuda")
        idx = torch.rand(rows, cols, device="cuda", generator=gen).argsort(dim=1)[:, :4]
        return m.scatter_(1, idx, ints(rows, min(4, cols), lo=0, hi=1) * 2 - 1)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale
    p = dict(x=ints(b, h, w, c, lo=-2, hi=2), a=ints(b, h, w, c, lo=-1, hi=1),
             ln_w=torch.zeros(c, device="cuda"), ln_b=ints(c, lo=-1, hi=1),
             w_qkv=sparse(3 * c, c), dw_qkv=r(3 * c, 3, 3, scale=0.3), w_proj=sparse(c, c),
             w_in=sparse(2 * hid, c), dw_in=r(2 * hid, 3, 3, scale=0.3),
             w_out=r(c, hid, scale=hid ** -0.5))
    return _to_bf16(p)


def _exact_layernorm_inputs(gen, b, h, w, c):
    """bf16 block-head inputs on which the bf16 recompute rounds nothing and
    whose LayerNorm is not trivial: at each pixel half the channels +s and
    half -s in a random order, s a random power of two from 2^8 to 2^11 (the
    mean 0 and the variance s^2 exactly, eps below half its last bit, so inv
    = 1/s), ln_w and ln_b random multiples of 1/8 in [-1, 1] (u = +-ln_w +
    ln_b, exact in bf16), W_qkv four entries of +-1 a row (h exact too); the
    taps random. C even."""
    sign = torch.rand(b, h, w, c, device="cuda", generator=gen).argsort(dim=-1) < c // 2
    s = 2.0 ** torch.randint(8, 12, (b, h, w, 1), device="cuda", generator=gen).float()

    def eighths():
        return torch.randint(-8, 9, (c,), device="cuda", generator=gen).float() / 8
    p = _exact_recompute_inputs(gen, b, h, w, c)
    return {**p, "x": torch.where(sign, s, -s).bfloat16(), "ln_w": eighths(), "ln_b": eighths()}


# form -> (its call on args, the cotangent g and bf16_ops; the block input
# names of its args)
BF16_TILE_FORMS = {
    "block_tail_bwd_bf16": (lambda args, g, o: tblock.block_tail_bwd(*args, g, o),
                            ("x", "a", "w_proj", "ln_w", "ln_b", "w_in", "dw_in", "w_out")),
    "conv1x1_dw_bwd_bf16": (lambda args, g, o: tfused.fused_dwconv_bwd(*args, None, g, o)[:3],
                            ("x", "w_qkv", "dw_qkv")),
    "block_head_bwd_bf16": (lambda args, g, o: tblock.block_head_bwd(*args, g, o),
                            ("x", "ln_w", "ln_b", "w_qkv", "dw_qkv")),
    "gdfn_fused_bwd_bf16": (lambda args, g, o: tfused.fused_dwconv_bwd(*args, g, o),
                            ("x", "w_in", "dw_in", "w_out")),
}


def _bf16_tile_call(form, args, g, bf16_ops):
    """A call of the form (or, on fp32 args and g, of its fp32 kernel)."""
    return lambda: BF16_TILE_FORMS[form][0](args, g, bf16_ops)


def _bf16_tile_args(form, p):
    return [p[k] for k in BF16_TILE_FORMS[form][1]]


def _assert_same_bits_with_g_two_bytes_off(form, args, g, bf16_ops, want):
    buf = torch.empty(g.numel() + 1, dtype=torch.bfloat16, device="cuda")
    g_off = buf[1:].view_as(g).copy_(g)
    assert g_off.data_ptr() % 4 == 2
    for x, y in zip(_bf16_tile_call(form, args, g_off, bf16_ops)(), want):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BF16_TILE_SHAPES)
@pytest.mark.parametrize("form", ["block_tail_bwd_bf16", "conv1x1_dw_bwd_bf16"])
@pytest.mark.parametrize("bf16_ops", [False, True], ids=["3xtf32", "ops16"])
def test_bf16_tail_and_qkv_backwards_on_bf16_tiles_keep_the_widening_designs_bits(
        cuda_device, shape, form, bf16_ops):
    """On inputs whose recompute rounds nothing, every output equals, bit
    for bit, the fp32 kernel's on the widened inputs with each bf16 output
    rounded once (RNE): the design these forms replace, which widened every
    operand, ran the fp32 design and rounded after; both repeat bitwise; a
    call counts one launch and puts on the card as many kernels as the fp32
    design, none of them a widening or rounding pass; it allocates its
    outputs, one workspace and the sums, no fp32 copy. Those inputs leave u
    and h the same at every pixel, so the same forms also run on random
    inputs, held against their plain bf16 twins (with the policy's operands)
    at the bf16 training gates: bf16 outputs within BF16_RTOL, the tail's
    dln_w and dln_b within BF16_FLIP_RTOL of the twin's arithmetic in
    float64. On both, a cotangent 2 bytes off its allocation gives the same
    bits."""
    import functools
    b, h, w, c = shape
    gen = torch.Generator(device="cuda").manual_seed(27)
    tail = form == "block_tail_bwd_bf16"
    args = _bf16_tile_args(form, _exact_recompute_inputs(gen, b, h, w, c))
    g = torch.randn(b, h, w, c if tail else 3 * c, device="cuda", generator=gen).bfloat16()
    call = _bf16_tile_call(form, args, g, bf16_ops)
    wide = _bf16_tile_call(form, [None if t is None else t.float() for t in args], g.float(),
                           bf16_ops)
    name = build.counted(form, bf16_ops)
    n0 = build.LAUNCHES[name]
    torch.cuda.synchronize()
    allocs0 = torch.cuda.memory_stats()["allocation.all.allocated"]
    got = call()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - allocs0
    again, want = call(), wide()
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == n0 + 2
    for x, y, z in zip(got, again, want):
        assert x.dtype == (torch.float32 if z.shape == (c,) and tail else torch.bfloat16)
        assert torch.equal(x, y) and torch.equal(x, z.to(x.dtype))
    records, records32 = _device_records(call), _device_records(wide)
    assert not any("cast" in r for r in records), records
    assert len(records) == len(records32), (records, records32)
    assert allocs == len(got) + 2, allocs
    _assert_same_bits_with_g_two_bytes_off(form, args, g, bf16_ops, got)

    args = _bf16_tile_args(form, _to_bf16(_block_inputs(gen, b, h, w, c, True)))
    g = torch.randn(b, h, w, c if tail else 3 * c, device="cuda", generator=gen).bfloat16()
    call = _bf16_tile_call(form, args, g, bf16_ops)
    got, again = call(), call()
    torch.cuda.synchronize()
    if tail:
        plain = tblock.block_tail_bwd_plain(*args, g, bf16_ops)
        rounded = functools.partial(tblock._block_tail_rounded, torch.bfloat16,
                                    bf16_ops=bf16_ops)
        plain64 = tblock._vjp_plain(rounded, _double(args), g.double())
    else:
        plain, plain64 = tfused.fused_dwconv_bwd_plain(*args, None, g, bf16_ops)[:3], None
    _check_bf16_outputs(form, got, again, plain, plain64)
    _assert_same_bits_with_g_two_bytes_off(form, args, g, bf16_ops, got)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BF16_TILE_SHAPES)
@pytest.mark.parametrize("form", ["block_head_bwd_bf16", "gdfn_fused_bwd_bf16"])
@pytest.mark.parametrize("bf16_ops", [False, True], ids=["3xtf32", "ops16"])
def test_bf16_head_and_gdfn_backwards_on_bf16_tiles_keep_the_widening_designs_bits(
        cuda_device, shape, form, bf16_ops):
    """As the tail's and the qkv's above, for row 5's head and row 9's GDFN:
    on inputs that vary by pixel and whose recompute rounds nothing (the
    head's with a LayerNorm of random weights and statistics, the GDFN's
    with random integers), every output equals, bit for bit, the fp32
    kernel's on the widened inputs with each bf16 output rounded once (RNE),
    also with the cotangent 2 bytes off; both repeat bitwise; a call counts
    one launch and puts on the card as many kernels as the fp32 design (10
    in the head, 11 in the GDFN at the level-1 shapes), none of them a widening or
    rounding pass, and allocates its outputs, one workspace and the sums. On
    random inputs, against the plain bf16 twins at the bf16 training gates."""
    import functools
    b, h, w, c = shape
    gen = torch.Generator(device="cuda").manual_seed(29)
    head = form == "block_head_bwd_bf16"
    args = _bf16_tile_args(form, (_exact_layernorm_inputs if head else _exact_recompute_inputs)(
        gen, b, h, w, c))
    wide_args = [None if t is None else t.float() for t in args]
    if head:  # the recompute rounds nothing: the bf16 and fp32 forwards agree
        assert torch.equal(tblock.block_head_fwd(*args),
                           tblock.block_head_fwd(*wide_args).bfloat16())
    g = torch.randn(b, h, w, 3 * c if head else c, device="cuda", generator=gen).bfloat16()
    call = _bf16_tile_call(form, args, g, bf16_ops)
    wide = _bf16_tile_call(form, wide_args, g.float(), bf16_ops)
    name = build.counted(form, bf16_ops)
    n0 = build.LAUNCHES[name]
    torch.cuda.synchronize()
    allocs0 = torch.cuda.memory_stats()["allocation.all.allocated"]
    got = call()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - allocs0
    again, want = call(), wide()
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == n0 + 2
    for x, y, z in zip(got, again, want):
        assert x.dtype == (torch.float32 if z.shape == (c,) and head else torch.bfloat16)
        assert torch.equal(x, y) and torch.equal(x, z.to(x.dtype))
    records, records32 = _device_records(call), _device_records(wide)
    assert not any("cast" in r for r in records), records
    assert len(records) == len(records32), (records, records32)
    if h == 128:  # the level-1 shapes: no product split
        assert len(records) == (10 if head else 11), records
    assert allocs == len(got) + 2, allocs
    _assert_same_bits_with_g_two_bytes_off(form, args, g, bf16_ops, got)

    args = _bf16_tile_args(form, _to_bf16(_block_inputs(gen, b, h, w, c, True)))
    g = torch.randn(b, h, w, 3 * c if head else c, device="cuda", generator=gen).bfloat16()
    call = _bf16_tile_call(form, args, g, bf16_ops)
    got, again = call(), call()
    torch.cuda.synchronize()
    if head:
        plain = tblock.block_head_bwd_plain(*args, g, bf16_ops)
        rounded = functools.partial(tblock._block_head_rounded, torch.bfloat16,
                                    bf16_ops=bf16_ops)
        plain64 = tblock._vjp_plain(rounded, _double(args), g.double())
    else:
        plain, plain64 = tfused.fused_dwconv_bwd_plain(*args, g, bf16_ops), None
    _check_bf16_outputs(form, got, again, plain, plain64)
    _assert_same_bits_with_g_two_bytes_off(form, args, g, bf16_ops, got)


# The bf16 forwards of row 2's tail and row 8's GDFN take their gate in the
# gated depthwise (csrc/dwconv.cu dwconv3x3_gate_kernel): h = 15 (C = 6),
# 127 and 255 (odd: c2 staged from the column before it), 510 (even) and
# 1,021, ragged tiles and bands
GATE_SHAPES = [(1, 20, 19, 6), (1, 256, 256, 48), (3, 128, 128, 48), (3, 128, 128, 96),
               (2, 12, 13, 192), (1, 9, 33, 384), (1, 250, 321, 48)]


def _conv_in_kernel_order(x, taps):
    """conv_bf16's fp32 conv of a bf16 x on bf16 taps, on the card: each
    tap's product is exact in fp32 (eight bits by eight), and the sums run
    in the kernel's order (input rows y - 1, y, y + 1; in each the right,
    middle and left taps), one rounding an add, as its fmaf chain rounds."""
    b, h, w, _ = x.shape
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))
    t = taps.float()
    acc = torch.zeros(x.shape, device=x.device)
    for i in range(3):
        for j in (2, 1, 0):
            acc = acc + xp[:, i:i + h, j:j + w] * t[:, i, j]
    return acc


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c", GATE_SHAPES)
def test_the_gated_depthwise_takes_the_gate_of_conv_bf16s_conv(cuda_device, b, h, w, c):
    """conv_gate_bf16 against conv_bf16's fp32 conv (in its order) followed
    by the gate gelu(c1) c2 in PyTorch's fp32 ops, rounded once: equal on
    at least 99.9% of entries and within one bf16 ulp everywhere (PyTorch's
    erf and the card's erff may differ by an fp32 ulp); zeros past h in the
    gate's padded rows; bitwise on a repeat; one launch a call."""
    hid = int(c * 2.66)
    gen = torch.Generator(device="cuda").manual_seed(31)
    x = torch.randn(b, h, w, 2 * hid, device="cuda", generator=gen).bfloat16()
    taps = (torch.randn(2 * hid, 3, 3, device="cuda", generator=gen) * 0.3).bfloat16()
    n0 = build.LAUNCHES["conv_gate_bf16"]
    got, again = tdw.conv_gate_bf16(x, taps), tdw.conv_gate_bf16(x, taps)
    torch.cuda.synchronize()
    assert build.LAUNCHES["conv_gate_bf16"] == n0 + 2
    ld = tdw.gate_ld(hid)
    assert got.shape == (b, h, w, ld) and torch.equal(got, again)
    assert not got[..., hid:].any()
    c1, c2 = _conv_in_kernel_order(x, taps).chunk(2, dim=-1)
    want = (c1 * (0.5 * (1.0 + torch.erf(c1 * 0.70710678118654752))) * c2).bfloat16()
    g = got[..., :hid].float()
    diff = (g - want.float()).abs()
    ulp = 2.0 ** (torch.floor(torch.log2(want.float().abs().clamp_min(2.0 ** -126))) - 7)
    assert float((diff == 0).float().mean()) >= 0.999
    assert bool((diff <= ulp).all()), float((diff / ulp).max())
    assert _bf16_within(got, tdw.conv_gate_plain(x, taps))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c", GATE_SHAPES)
def test_the_bf16_tail_and_gdfn_forwards_take_the_gate_in_their_depthwise(cuda_device, b, h, w,
                                                                          c):
    """block_tail_bf16 and gdfn_fused_bf16: each within BF16_RTOL of its
    plain bf16 twin and bitwise on a second call; a call counts one launch,
    puts 5 (the tail) and 3 (the GDFN) kernels on the card where no product
    splits, one of them the gated depthwise and none a gate pass, and
    allocates its output, one workspace and the sums (where a product
    splits); the GDFN's output is its W_out product of conv_gate_bf16's gate
    (the same bits)."""
    gen = torch.Generator(device="cuda").manual_seed(33)
    p = _to_bf16(_block_inputs(gen, b, h, w, c, True))
    hid = int(c * 2.66)
    n = b * h * w
    for name, call, plain, prods in (
            ("block_tail_bf16",
             lambda: tblock.block_tail_fwd(p["x"], p["a"], p["w_proj"], p["ln_w"], p["ln_b"],
                                           p["w_in"], p["dw_in"], p["w_out"]),
             lambda: tblock.block_tail_plain(p["x"], p["a"], p["w_proj"], p["ln_w"], p["ln_b"],
                                             p["w_in"], p["dw_in"], p["w_out"]),
             ((c, c), (2 * hid, c), (c, hid))),
            ("gdfn_fused_bf16",
             lambda: tfused.fused_dwconv_fwd(p["x"], p["w_in"], p["dw_in"], p["w_out"]),
             lambda: tfused.fused_dwconv_plain(p["x"], p["w_in"], p["dw_in"], p["w_out"]),
             ((2 * hid, c), (c, hid)))):
        n0 = build.LAUNCHES[name]
        torch.cuda.synchronize()
        allocs0 = torch.cuda.memory_stats()["allocation.all.allocated"]
        got = call()
        allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - allocs0
        again = call()
        torch.cuda.synchronize()
        assert build.LAUNCHES[name] == n0 + 2
        assert torch.equal(got, again) and _bf16_within(got, plain())
        splits = sum(tblock.split_plan(n, nn, k, tgram.sm_count(0))[0] > 1 for nn, k in prods)
        records = _device_records(call)
        assert sum("dwconv3x3_gate_kernel" in r for r in records) == 1, records
        assert not any("gate_pass" in r for r in records), records
        # a split product adds its fixed-order sum's launch
        assert len(records) == (5 if name == "block_tail_bf16" else 3) + splits, records
        assert allocs == (3 if splits else 2), allocs
    if not any(tblock.split_plan(n, nn, k, tgram.sm_count(0))[0] > 1
               for nn, k in ((2 * hid, c), (c, hid))):
        h_ = torch.nn.functional.linear(p["x"], p["w_in"])  # bf16, as the W_in product rounds
        gate = tdw.conv_gate_bf16(h_.contiguous(), p["dw_in"])
        y = torch.nn.functional.linear(gate[..., :hid], p["w_out"])
        assert _bf16_within(got, y)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c", GATE_SHAPES)
def test_the_gated_depthwises_blocks_an_sm_are_the_plans(cuda_device, b, h, w, c):
    """The shared memory and the launch bound that ops/dwconv.py mirrors
    (conv_gate_smem, GATE_BLOCKS_PER_SM) are the kernel's own, and the
    card's occupancy calculator holds at least the plan's blocks an SM of
    each of its two modes (even h and odd)."""
    import ctypes
    hid = int(c * 2.66)
    _, cv, tc, _ = tdw.conv_gate_plan(b, h, w, hid, tgram.sm_count(0))
    got, nbytes, least = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    assert build.library().rcot_conv_gate_bf16_blocks_per_sm(
        cv, tc, ctypes.byref(got), ctypes.byref(nbytes), ctypes.byref(least)) == 0
    assert (nbytes.value, least.value) == (tdw.conv_gate_smem(cv, tc), tdw.GATE_BLOCKS_PER_SM)
    assert got.value >= tdw.conv_gate_per_sm(cv, tc), got.value
