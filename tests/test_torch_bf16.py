"""bf16 serving in the port against the JAX package's, on the CPU.

The JAX package serves in bf16 (make_restorer(dtype=jnp.bfloat16)): the
input is cast to bf16, every weight is used in bf16 but the LayerNorms' and
the temperatures, and its Pallas kernels take bf16 operands with fp32 sums,
rounding to bf16 at fixed points (rcot_tpu/ops/pallas_block.py:111-142,
pallas_gram.py:81,171). Here the port's plain bf16 twins (ops/block.py,
ops/gram.py), which the CUDA kernels of csrc/block_fwd_bf16.cu and
csrc/gram_bf16.cu are held against on the card, and the port's whole bf16
forward are held against the JAX functions with their Pallas kernels in
interpret mode, on bf16 inputs drawn with numpy from a seed.

The JAX side is compiled with XLA's xla_allow_excess_precision off
(`_strict`): on the CPU, XLA otherwise drops a bf16 rounding that a value
takes and at once undoes (a convert to bf16 and back to fp32 inside one
fusion), so the interpreted kernels skip most of their rounding points
(a quarter of block_tail's outputs then differ by a bf16 ulp). With it off
they round where the kernels' code says, as on the TPU, whose matrix unit
reads the bf16 operands, and the port's twins agree with them bit for bit
here.

Tolerances:
- each module's bf16 output (block_head, block_tail, the apply, the whole
  Gram core) within a quarter of max|JAX fp32 - JAX bf16| on the same
  inputs: closer to JAX's bf16 than a quarter of what bf16 itself changes,
  which an fp32 computation rounded only at its end is not;
- the whole tiny T_net's restored image: the same quarter rule on the mean
  absolute difference, mean|port - JAX bf16| <= mean|JAX fp32 - JAX bf16| / 4.
  On the largest difference the rule cannot hold: the two frameworks' fp32
  sums, taken in other orders, now and then round a value next to a bf16
  boundary apart (a one-ulp flip), the flip travels to the output, and the
  output is itself bf16, so any output that differs at all differs by an ulp,
  about max|fp32 - bf16| (measured: 6% of the outputs differ, by one ulp,
  at a mean ratio of 0.086; an fp32 forward rounded only at its end reads a
  mean ratio of 0.82, JAX with XLA's excess precision 0.70);
- the Gram's fp32 outputs (G, nq, nk: sums of exact products) within
  1e-5 * max(max|JAX|, 1);
- cli.test --dtype bfloat16's per-image PSNR within PSNR_DB of the JAX
  CLI's in bf16 (the fp32 CLIs agree to 1e-3 dB, tests/test_torch_inference.py);
- every choice serves in bf16: each composition, and since the opt-in
  tiers have bf16 forms (rows 10-11, tests/test_torch_bf16_opt_in.py)
  `--attention-core mdta` and `--depthwise dwconv` too.
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rcot_torch.cli import test as t_test
from rcot_torch.compat.jax_params import tnet_state_dict_from_jax
from rcot_torch.models import inference as tinf
from rcot_torch.models.restormer import TNet
from rcot_torch.ops import block as tblock
from rcot_torch.ops import gram as tgram
from rcot_torch.utils.config import ModelConfig as TModelConfig
from rcot_tpu.cli import test as j_test
from rcot_tpu.models import inference as jinf
from rcot_tpu.models.restormer import init_tnet
from rcot_tpu.ops import dispatch as jdispatch
from rcot_tpu.ops.pallas_block import block_head as j_block_head
from rcot_tpu.ops.pallas_block import block_tail as j_block_tail
from rcot_tpu.ops.pallas_gram import attn_apply_fwd as j_apply
from rcot_tpu.ops.pallas_gram import mdta_core_gram as j_core_gram
from rcot_tpu.ops.pallas_gram import mdta_gram_fwd as j_gram

PSNR_DB = 0.01
BF = jnp.bfloat16
STRICT = {"xla_allow_excess_precision": False}
PALLAS_ENV = {"RCOT_PALLAS": "1", "RCOT_PALLAS_INTERPRET": "1"}


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bf(a):
    """numpy fp32 -> the bf16 torch tensor (None stays None)."""
    return None if a is None else torch.from_numpy(a).to(torch.bfloat16)


def _jbf(a):
    return None if a is None else jnp.asarray(a, BF)


def _j32(a):
    return None if a is None else jnp.asarray(a)


def _strict(fn, *args):
    """fn(*args) compiled by XLA with every bf16 rounding kept (docstring)."""
    return jax.jit(fn).lower(*args).compile(STRICT)(*args)


def _strict_restorer(r):
    """A JAX Restorer whose forwards compile as _strict does."""
    jitted, cache = r._jitted, {}

    def fwd(*args):
        key = tuple((a.shape, a.dtype) for a in jax.tree_util.tree_leaves(args))
        if key not in cache:
            cache[key] = jitted.lower(*args).compile(STRICT)
        return cache[key](*args)
    r._jitted = fwd
    return r


def _f32(a) -> np.ndarray:
    """A torch or JAX array as fp32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _within_quarter_gap(name, got, want16, want32, stat=np.max):
    """stat|got - want16| <= stat|want32 - want16| / 4 (stat: max or mean)."""
    got, want16, want32 = _f32(got), _f32(want16), _f32(want32)
    assert got.shape == want16.shape, name
    gap = float(stat(np.abs(want32 - want16)))
    err = float(stat(np.abs(got - want16)))
    assert gap > 0, f"{name}: bf16 changed nothing"
    assert err <= gap / 4, (f"{name}: {stat.__name__}|port - JAX| {err:.3e} > "
                            f"{stat.__name__}|fp32 - bf16| {gap:.3e} / 4")


def _block_inputs(rng, b, h, w, c, ln_bias):
    hid = int(c * 2.66)
    m = 3 * c
    f = lambda *s, loc=0.0, scale=1.0: rng.normal(loc, scale, s).astype(np.float32)  # noqa: E731
    return dict(
        x=f(b, h, w, c), a=f(b, h, w, c),
        ln_w=f(c, loc=1.0, scale=0.1), ln_b=f(c, scale=0.1) if ln_bias else None,
        w_qkv=f(m, c, scale=c ** -0.5), dw_qkv=f(m, 3, 3, scale=0.3),
        w_proj=f(c, c, scale=c ** -0.5), w_in=f(2 * hid, c, scale=c ** -0.5),
        dw_in=f(2 * hid, 3, 3, scale=0.3), w_out=f(c, hid, scale=hid ** -0.5))


def _taps(dw):
    """(M, 3, 3) torch taps -> (3, 3, M) Pallas taps."""
    return np.transpose(dw, (1, 2, 0))


# ------------------------------------------------------------ the kernels

@pytest.mark.parametrize("c", [6, 8], ids=["M18_hid15", "M24_hid21"])
@pytest.mark.parametrize("ln_bias", [True, False], ids=["WithBias", "BiasFree"])
def test_block_head_bf16_twin_matches_pallas(c, ln_bias):
    p = _block_inputs(np.random.default_rng(10), 2, 6, 5, c, ln_bias)

    def jax_head(cast):
        return _strict(lambda *a: j_block_head(*a, interpret=True), cast(p["x"]),
                       _j32(p["ln_w"]), _j32(p["ln_b"]), cast(p["w_qkv"].T),
                       cast(_taps(p["dw_qkv"])))
    got = tblock.block_head(_bf(p["x"]), torch.from_numpy(p["ln_w"]),
                            None if p["ln_b"] is None else torch.from_numpy(p["ln_b"]),
                            _bf(p["w_qkv"]), _bf(p["dw_qkv"]))
    assert got.dtype == torch.bfloat16
    _within_quarter_gap("block_head", got, jax_head(_jbf), jax_head(_j32))


@pytest.mark.parametrize("c", [6, 8], ids=["M18_hid15", "M24_hid21"])
@pytest.mark.parametrize("ln_bias", [True, False], ids=["WithBias", "BiasFree"])
def test_block_tail_bf16_twin_matches_pallas(c, ln_bias):
    p = _block_inputs(np.random.default_rng(11), 2, 6, 5, c, ln_bias)

    def jax_tail(cast):
        return _strict(lambda *a: j_block_tail(*a, interpret=True), cast(p["x"]),
                       cast(p["a"]), cast(p["w_proj"].T), _j32(p["ln_w"]), _j32(p["ln_b"]),
                       cast(p["w_in"].T), cast(_taps(p["dw_in"])), cast(p["w_out"].T))
    ln = [None if p[k] is None else torch.from_numpy(p[k]) for k in ("ln_w", "ln_b")]
    got = tblock.block_tail(_bf(p["x"]), _bf(p["a"]), _bf(p["w_proj"]), *ln,
                            _bf(p["w_in"]), _bf(p["dw_in"]), _bf(p["w_out"]))
    assert got.dtype == torch.bfloat16
    _within_quarter_gap("block_tail", got, jax_tail(_jbf), jax_tail(_j32))


@pytest.mark.parametrize("heads,ch", [(1, 8), (2, 6), (4, 5)])
def test_gram_and_apply_bf16_twins_match_pallas(heads, ch):
    rng = np.random.default_rng(12)
    c = heads * ch
    qkv = rng.normal(size=(2, 6, 7, 3 * c)).astype(np.float32)
    got = tgram.mdta_gram_fwd(_bf(qkv), heads)
    want = _strict(lambda q: j_gram(q, heads, interpret=True), _jbf(qkv))
    for name, g, w in zip(("G", "nq", "nk"), got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and w.dtype == np.float32, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, err_msg=name,
                                   atol=1e-5 * max(float(np.abs(w).max()), 1.0))
    attn = torch.softmax(torch.from_numpy(rng.normal(size=(2, heads, ch, ch))
                                          .astype(np.float32)), -1)
    out = tgram.attn_apply_fwd(_bf(qkv), attn)
    assert out.dtype == torch.bfloat16
    ja = jnp.asarray(attn.numpy())

    def apply(q):
        return _strict(lambda q, a: j_apply(q, a, interpret=True), q, ja)
    _within_quarter_gap("attn_apply", out, apply(_jbf(qkv)), apply(_j32(qkv)))


@pytest.mark.parametrize("heads,ch", [(1, 8), (2, 6), (4, 5)])
def test_mdta_core_gram_bf16_matches_pallas(heads, ch):
    rng = np.random.default_rng(13)
    c = heads * ch
    qkv = rng.normal(size=(1, 5, 9, 3 * c)).astype(np.float32)
    temp = rng.uniform(0.5, 2.0, (heads, 1, 1)).astype(np.float32)
    got = tgram.mdta_core_gram(torch.from_numpy(temp), _bf(qkv), heads)
    assert got.dtype == torch.bfloat16
    def core(q):
        return _strict(lambda t, q: j_core_gram(t, q, heads, interpret=True),
                       jnp.asarray(temp), q)
    _within_quarter_gap("mdta_core_gram", got, core(_jbf(qkv)), core(_j32(qkv)))


# ------------------------------------------------------------ the T_net

@pytest.fixture
def pallas_env():
    """The JAX package with its Pallas kernels on, in interpret mode."""
    saved = {k: os.environ.get(k) for k in PALLAS_ENV}
    os.environ.update(PALLAS_ENV)
    jdispatch.pallas_enabled.cache_clear()
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    jdispatch.pallas_enabled.cache_clear()


def test_tiny_tnet_serves_bf16_as_jax_pallas(tiny_model_cfg, pallas_env):
    """The whole two-pass tiny T_net in bf16 through make_restorer, one 32^2
    bucket, "full" composition (JAX's inference default with its Pallas
    kernels): the port's CPU forward against JAX's in bf16, the mean
    difference within a quarter of what bf16 changes in JAX (docstring)."""
    params = init_tnet(jax.random.PRNGKey(0), tiny_model_cfg)
    sd = tnet_state_dict_from_jax(params, tiny_model_cfg)
    tcfg = TModelConfig(**dataclasses.asdict(tiny_model_cfg))
    img = np.random.default_rng(14).uniform(0, 1, (32, 32, 3)).astype(np.float32)
    outs = {}
    for name, dtype in (("bf16", BF), ("fp32", jnp.float32)):
        r = _strict_restorer(jinf.make_restorer(params, tiny_model_cfg, dtype=dtype))
        r.buckets = (32,)
        outs[name] = np.asarray(r(img))
    port = tinf.make_restorer(sd, tcfg, device="cpu", dtype=torch.bfloat16)
    port.buckets = (32,)
    got = port(img)
    assert got.dtype == np.float32 and got.shape == img.shape
    _within_quarter_gap("tiny T_net", got, outs["bf16"], outs["fp32"], np.mean)


def test_the_bf16_copy_of_the_weights_is_made_once(tiny_model_cfg):
    """make_restorer casts the weights once; LayerNorm weights and the
    temperatures stay fp32, and the caller's TNet is left in fp32."""
    tcfg = TModelConfig(**dataclasses.asdict(tiny_model_cfg))
    net = TNet(tcfg, device="cpu", seed=0)
    r = tinf.make_restorer(net, tcfg, device="cpu", dtype=torch.bfloat16)
    served = r.model_fn.__closure__
    copies = [c.cell_contents for c in served if isinstance(c.cell_contents, TNet)]
    assert len(copies) == 1 and copies[0] is not net
    for name, p in copies[0].named_parameters():
        keep = ".body.weight" in name and p.dim() == 1 or ".body.bias" in name or (
            name.endswith("temperature"))
        assert p.dtype == (torch.float32 if keep else torch.bfloat16), name
    assert all(p.dtype == torch.float32 for p in net.parameters())
    ptrs = {n: p.data_ptr() for n, p in copies[0].named_parameters()}
    r(np.zeros((16, 16, 3), np.float32))
    assert ptrs == {n: p.data_ptr() for n, p in copies[0].named_parameters()}


# ------------------------------------------------------------ the CLI

def test_cli_test_bf16_matches_the_jax_cli(tiny_config, tmp_path, capsys, pallas_env,
                                           monkeypatch):
    """cli.test --dtype bfloat16 on a JAX trainer checkpoint against the JAX
    CLI with --dtype bfloat16 (its Pallas kernels in interpret mode, its
    restorer compiled as _strict does): per-image PSNR within PSNR_DB."""
    from rcot_tpu.train.steps import create_train_state
    from rcot_tpu.utils.checkpoint import save_checkpoint

    state = create_train_state(jax.random.PRNGKey(0), tiny_config)
    ckpt = save_checkpoint(str(tmp_path / "m_step0"), state,
                           metadata={"config": tiny_config.to_dict()})
    rng = np.random.default_rng(15)
    deg_dir, tar_dir = tmp_path / "deg", tmp_path / "tar"
    os.makedirs(deg_dir)
    os.makedirs(tar_dir)
    for i in range(2):
        tar = rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)
        deg = np.clip(tar.astype(int) + rng.integers(-40, 40, tar.shape), 0, 255).astype(np.uint8)
        Image.fromarray(deg).save(deg_dir / f"im{i}.png")
        Image.fromarray(tar).save(tar_dir / f"im{i}.png")
    argv = ["--ckpt", ckpt, "--degset", str(deg_dir), "--tarset", str(tar_dir),
            "--dtype", "bfloat16"]

    def psnrs(text):
        return {m[0]: float(m[1]) for m in re.findall(r"^(im\d\.png): psnr ([\d.]+)", text, re.M)}
    t_test.main(argv + ["--device", "cpu"])
    got = psnrs(capsys.readouterr().out)
    make = jinf.make_restorer
    monkeypatch.setattr(jinf, "make_restorer", lambda *a, **k: _strict_restorer(make(*a, **k)))
    j_test.main(argv)
    want = psnrs(capsys.readouterr().out)
    assert got.keys() == want.keys() == {"im0.png", "im1.png"}
    for k in got:
        assert abs(got[k] - want[k]) <= PSNR_DB, (k, got[k], want[k])


@pytest.mark.parametrize("choice,flag", [
    (dict(composition="off"), "--composition off"),
    (dict(composition="tail"), "--composition tail"),
    (dict(attention_core="mdta"), "--attention-core mdta"),
    (dict(depthwise="dwconv"), "--depthwise dwconv")])
def test_bf16_refuses_every_other_choice_by_name(tiny_model_cfg, choice, flag):
    """On the CPU as on the card, nothing is refused any more: every
    composition serves in bf16 ("off" and "tail" here, beside "full"), and
    so do the opt-in attention core and depthwise tier, through
    make_restorer and a bias-free block's forward (their outputs against the
    JAX package: tests/test_torch_bf16_opt_in.py). `flag` names the choice."""
    assert flag.split()[1] == next(iter(choice.values()))
    tcfg = TModelConfig(**dataclasses.asdict(tiny_model_cfg))
    net = TNet(tcfg, device="cpu", seed=0)
    out = tinf.make_restorer(net, tcfg, device="cpu", dtype=torch.bfloat16, **choice)(
        np.random.default_rng(16).uniform(0, 1, (16, 16, 3)).astype(np.float32))
    assert out.dtype == np.float32 and np.isfinite(out).all()
    for k, v in choice.items():
        setattr(net, k, v)
    with torch.no_grad():
        out = net(torch.zeros(1, 16, 16, 3, dtype=torch.bfloat16))[0]
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
