"""The port's CUDA kernels against their plain twins, on a CUDA card.

Every test here is marked `cuda` and skips without a card (the kernels have
no CPU mode). The file imports neither JAX nor rcot_tpu, so it also runs on
a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

TF32 is off for the plain twins. Tolerance: max|kernel - plain| <= 1e-5 *
max|plain| (fp32 sums in another order). The Gram, whose sums run over
every pixel with cancelling terms and whose kernel adds partial sums with
atomics in no fixed order, is held against its plain twin run in float64:
in fp32 on the card the twin's own rounding comes near the tolerance. The
backward kernels, whose weight grads are such sums too, are held against
their plain twins run in float64, every output at the same 1e-5.

The autograd case holds a small T_net on the card against the same model
on the CPU: every parameter's gradient agrees within 1e-4 of that
parameter's largest gradient (fp32 through some eighty ops, forward and
backward, in another order of sums; cuDNN in fp32 with TF32 off), in each
of the four block compositions.
"""

import pytest
import torch

from rcot_torch.kernels import build
from rcot_torch.models.restormer import TNet
from rcot_torch.ops import block as tblock
from rcot_torch.ops import fused as tfused
from rcot_torch.ops import gram as tgram
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 20, 19, 6), (2, 32, 32, 48), (1, 16, 16, 192),
                                   (1, 9, 33, 384)])
@pytest.mark.parametrize("ln_bias", [True, False], ids=["WithBias", "BiasFree"])
def test_block_kernels_match_plain(cuda_device, shape, ln_bias):
    p = _block_inputs(torch.Generator(device="cuda").manual_seed(5), *shape, ln_bias)
    head = (p["x"], p["ln_w"], p["ln_b"], p["w_qkv"], p["dw_qkv"])
    n0 = build.LAUNCHES["block_head"]
    got = tblock.block_head(*head)
    torch.cuda.synchronize()
    assert build.LAUNCHES["block_head"] == n0 + 1
    assert _rel_err(got, tblock.block_head_plain(*head)) < RTOL
    tail = [p[k] for k in ("x", "a", "w_proj", "ln_w", "ln_b", "w_in", "dw_in", "w_out")]
    n0 = build.LAUNCHES["block_tail"]
    got = tblock.block_tail(*tail)
    torch.cuda.synchronize()
    assert build.LAUNCHES["block_tail"] == n0 + 1
    assert _rel_err(got, tblock.block_tail_plain(*tail)) < RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("heads,ch,hw", [(1, 48, (64, 64)), (4, 96, (16, 16)),
                                         (4, 24, (33, 7)), (2, 5, (3, 3))])
def test_gram_kernels_match_plain(cuda_device, heads, ch, hw):
    g = torch.Generator(device="cuda").manual_seed(6)
    qkv = torch.randn(2, *hw, 3 * heads * ch, device=cuda_device, generator=g)
    got = tgram.mdta_gram_fwd(qkv, heads)
    torch.cuda.synchronize()
    for a, b in zip(got, tgram.mdta_gram_plain(qkv.double(), heads)):
        assert _rel_err(a, b) < RTOL
    attn = torch.softmax(torch.randn(2, heads, ch, ch, device=cuda_device, generator=g), -1)
    out = tgram.attn_apply_fwd(qkv, attn)
    torch.cuda.synchronize()
    assert _rel_err(out, tgram.attn_apply_plain(qkv, attn)) < RTOL


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
    with pytest.raises(ValueError, match="128"):
        tgram.mdta_gram_fwd(torch.zeros(1, 2, 2, 3 * 130, device="cuda"), 1)


def _double(ts):
    return [None if t is None else t.double() for t in ts]


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


@pytest.mark.cuda
@pytest.mark.parametrize("heads,ch,hw", [(1, 48, (64, 64)), (4, 96, (16, 16)),
                                         (4, 24, (33, 7)), (2, 5, (3, 3)),
                                         (1, 128, (8, 9))])
def test_gram_bwd_kernels_match_float64_plain(cuda_device, heads, ch, hw):
    gen = torch.Generator(device="cuda").manual_seed(9)
    r = lambda *s: torch.randn(*s, device="cuda", generator=gen)  # noqa: E731
    qkv = r(2, *hw, 3 * heads * ch)
    cot = [r(2, heads, ch, ch), r(2, heads, ch), r(2, heads, ch)]
    got = tgram.mdta_gram_bwd(qkv, *cot, heads)
    torch.cuda.synchronize()
    want = tgram.mdta_gram_bwd_plain(*_double([qkv] + cot), heads)
    assert _rel_err(got.double(), want) < RTOL
    attn = torch.softmax(r(2, heads, ch, ch), -1)
    g = r(2, *hw, heads * ch)
    got = tgram.attn_apply_bwd(qkv, attn, g)
    torch.cuda.synchronize()
    _assert_grads_match(got, tgram.attn_apply_bwd_plain(*_double([qkv, attn, g])),
                        ["dv", "dattn"])


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


@pytest.mark.cuda
def test_fused_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    p = _block_inputs(torch.Generator(device="cuda").manual_seed(11), 1, 8, 8, 8, False)
    with pytest.raises(ValueError, match="contiguous"):
        tfused.conv1x1_dw_fused(p["x"].transpose(1, 2), p["w_qkv"], p["dw_qkv"])
    with pytest.raises(ValueError, match="even"):
        tfused.gdfn_fused(p["x"], p["w_qkv"][:-1], p["dw_qkv"][:-1], p["w_out"])
    with pytest.raises(ValueError, match="w_out"):
        tfused.gdfn_fused(p["x"], p["w_in"], p["dw_in"], p["w_out"][:, :-1])


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
