"""The port's CUDA kernels against their plain twins, on a CUDA card.

Every test here is marked `cuda` and skips without a card (the kernels have
no CPU mode). The file imports neither JAX nor rcot_tpu, so it also runs on
a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

TF32 is off for the plain twins. Tolerance: max|kernel - plain| <= 1e-5 *
max|plain| (fp32 sums in another order). The Gram, whose sums run over
every pixel with cancelling terms and whose kernel adds partial sums with
atomics in no fixed order, is held against its plain twin run in float64:
in fp32 on the card the twin's own rounding comes near the tolerance.
"""

import pytest
import torch

from rcot_torch.kernels import build
from rcot_torch.ops import block as tblock
from rcot_torch.ops import gram as tgram

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
