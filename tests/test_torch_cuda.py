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
within 1e-5 of the float64 twin's; every bf16 kernel repeats bitwise; a bf16
tensor at a kernel with no bf16 form (rows 10-11) raises and names its dtype,
one at a configuration with none (row 5's head, rows 8-9's GDFN) stops by
name.

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
    """Rows 10-11 have no bf16 form: a bf16 tensor raises, never casts; row
    5's head configuration and rows 8-9's GDFN have none either ("full" and
    "head"/"off" bf16 training) and stop by name."""
    p = _to_bf16(_block_inputs(torch.Generator(device="cuda").manual_seed(17), 1, 8, 8, 8,
                               True))
    head = [p["x"], p["ln_w"], p["ln_b"], p["w_qkv"], p["dw_qkv"]]
    gdfn = [p["x"], p["w_in"], p["dw_in"], p["w_out"]]
    q = torch.zeros(1, 1, 8, 64, device="cuda", dtype=torch.bfloat16)
    for call in (lambda: tdw.dwconv3x3(p["x"], p["dw_qkv"][:8]),
                 lambda: tmdta.mdta_attend(q, q, q, torch.ones(1, 1, 1, device="cuda"))):
        with pytest.raises(ValueError, match="bfloat16"):
            call()
    for call in (lambda: tblock.block_head_bwd(*head, torch.zeros_like(p["x"]).repeat(1, 1, 1, 3)),
                 lambda: tfused.fused_dwconv_fwd(*gdfn),
                 lambda: tfused.fused_dwconv_bwd(*gdfn, torch.zeros_like(p["x"]))):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            call()


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
    8's qkv forward and rows 9 (qkv) and 5 (tail) backward on bf16 p."""
    import functools
    qkv = [p["x"], p["w_qkv"], p["dw_qkv"]]
    tail = [p[k] for k in ("x", "a", "w_proj", "ln_w", "ln_b", "w_in", "dw_in", "w_out")]
    rounded = functools.partial(tblock._block_tail_rounded, torch.bfloat16)
    return {
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
F32_RTOL = {"block_tail_bwd_bf16": BF16_FLIP_RTOL, "attn_apply_bwd_bf16": RTOL}


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


# rows 8-9 (qkv) and 5 (tail) in bf16: C = 6 (h = 15), odd h (127, 255,
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


@pytest.mark.cuda
def test_a_bf16_tnet_trains_on_the_card_as_on_the_cpu(cuda_device):
    """A small T_net in "tail" on a bf16 input, differentiated for a bf16
    cotangent of its output, on the card against the CPU: the gradients,
    all together, within a quarter of what bf16 changes on the CPU;
    each bf16 training kernel launched once a block, and no fp32 form of
    rows 2-9."""
    import copy

    cfg = ModelConfig(dim=16, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                      parity_params=False)
    net = TNet(cfg, device="cpu", seed=4, composition="tail")
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
    assert set(launched) == {"conv1x1_dw_bf16", "block_tail_bf16", "mdta_gram_fwd_bf16",
                             "attn_apply_fwd_bf16", "block_tail_bwd_bf16",
                             "mdta_gram_bwd_bf16", "attn_apply_bwd_bf16",
                             "conv1x1_dw_bwd_bf16"}, launched
    assert len(set(launched.values())) == 1
    assert card.keys() == cpu16.keys()
    err = sum(float((card[k] - cpu16[k]).abs().sum()) for k in card)
    gap = sum(float((cpu32[k] - cpu16[k]).abs().sum()) for k in card)
    assert err <= BF16_MODEL_RATIO * gap, (err, gap)
