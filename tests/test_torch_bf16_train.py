"""bf16 training in the port against the JAX package's, on the CPU: the
kernels of its path and the train CLI.

The JAX package trains in bf16 (`cli.train --dtype bfloat16`) on bf16
batches, with fp32 parameters cast to bf16 at each use, through its Pallas
kernels in the trainer's default composition at the port's batch, "tail"
with the Gram core and the fused tier. Their backward kernels widen every
bf16 operand to fp32 and work in fp32 (RCOT_BWD_BF16 unset), but recompute
the forward with its rounding points, and they round their bf16 outputs
once (rcot_tpu/ops/pallas_block.py:208-397, pallas_fused.py:297-410,
pallas_gram.py:120-138, 195-216). The port's plain bf16 twins of those
kernels (ops/fused.py, ops/block.py, ops/gram.py), which the CUDA kernels
of csrc/fused_dwconv_bf16.cu, block_bwd_bf16.cu and gram_bwd_bf16.cu are
held against on the card, are held here against the JAX functions with
their Pallas kernels in interpret mode, on bf16 inputs drawn with numpy from
a seed, the JAX side compiled with xla_allow_excess_precision off
(tests/test_torch_bf16.py says why).

Gates (the bf16 serving kernels' rule): a bf16 output within 2^-6 of
max(max|JAX|, 1) (four bf16 ulps of the largest value: the two sides' fp32
sums, in other orders, now and then round a value next to a bf16 boundary
apart, and later stages carry it); an fp32 output (dln_w, dln_b, dtemperature)
within 1e-4 of its largest entry. The share of elements that differ at all
is printed (`-s`). Autograd through the bf16 forward twins (ops/block.py
_vjp_plain) is not what the JAX backward kernels compute: it rounds every
cotangent and takes the rounded gate and attention. On the same inputs it
differs from JAX in a larger share of elements than the twins do, which
the block tail's and the Gram core's tests pin.

The train CLI trains a tiny T_net for two epochs in bf16 on the CPU, with
an injected failure and a resume, its checkpoints fp32, its validation
fp32, its sample dump through the bf16 training forward, and its config
hash the JAX CLI's for the same flags. Every composition trains in bf16,
and so do the opt-in attention core and depthwise tier
(tests/test_torch_bf16_opt_in.py holds their bf16 forms).

The whole tiny T_net's bf16 gradients (tests/test_torch_bf16_train_tnet.py)
and one bf16 minimax iteration (tests/test_torch_bf16_train_iteration.py)
are held against the JAX package in files of their own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcot_torch.cli import train as tcli
from rcot_torch.data.synthetic import write_synthetic_tree
from rcot_torch.ops import block as tblock
from rcot_torch.ops import fused as tfused
from rcot_torch.ops import gram as tgram
from rcot_torch.train import steps as tsteps
from rcot_torch.train.trainer import InjectedFailure, Trainer
from rcot_torch.utils import checkpoint as tckpt
from rcot_torch.utils import config as tconfig
from rcot_tpu.cli import train as jcli
from rcot_tpu.ops.pallas_block import block_tail as j_block_tail
from rcot_tpu.ops.pallas_fused import conv1x1_dw_fused as j_qkv
from rcot_tpu.ops.pallas_gram import mdta_core_gram as j_core_gram
from rcot_tpu.utils import config as jconfig

BF = jnp.bfloat16
STRICT = {"xla_allow_excess_precision": False}
BF16_RTOL = 2.0 ** -6
F32_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _strict_vjp(fn, primals, cot):
    """(fn(*primals), its VJP for cot), compiled by XLA with every bf16
    rounding kept."""
    def f(primals, cot):
        out, vjp = jax.vjp(fn, *primals)
        return out, vjp(cot)
    return jax.jit(f).lower(primals, cot).compile(STRICT)(primals, cot)


def _np(a) -> np.ndarray:
    """A torch or JAX array as fp32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _differ(got, want) -> float:
    """The share of elements that differ at all."""
    return float((_np(got) != _np(want)).mean())


def _check(name, got, want, shares=None):
    """got (torch) against want (JAX) under the gates of the docstring."""
    assert tuple(got.shape) == tuple(want.shape), name
    bf16 = want.dtype == BF
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32), name
    g, w = _np(got), _np(want)
    err = float(np.abs(g - w).max())
    big = float(np.abs(w).max())
    tol = BF16_RTOL * max(big, 1.0) if bf16 else F32_RTOL * big
    share = _differ(got, want)
    if shares is not None:
        shares[name] = share
    print(f"{name}: max|port - JAX| {err:.3e} (gate {tol:.3e}), {share:.4f} of the "
          "elements differ")
    assert err <= tol, (name, err, tol)


def _bf(a):
    return None if a is None else torch.from_numpy(a).to(torch.bfloat16)


def _jbf(a):
    return None if a is None else jnp.asarray(a, BF)


def _inputs(rng, b, h, w, c, ln_bias):
    hid = int(c * 2.66)
    m = 3 * c
    f = lambda *s, loc=0.0, scale=1.0: rng.normal(loc, scale, s).astype(np.float32)  # noqa: E731
    return dict(
        x=f(b, h, w, c), a=f(b, h, w, c), g_c=f(b, h, w, c), g_m=f(b, h, w, m),
        ln_w=f(c, loc=1.0, scale=0.1), ln_b=f(c, scale=0.1) if ln_bias else None,
        w_qkv=f(m, c, scale=c ** -0.5), dw_qkv=f(m, 3, 3, scale=0.3),
        w_proj=f(c, c, scale=c ** -0.5), w_in=f(2 * hid, c, scale=c ** -0.5),
        dw_in=f(2 * hid, 3, 3, scale=0.3), w_out=f(c, hid, scale=hid ** -0.5))


def _taps(dw):
    """(M, 3, 3) torch taps -> (3, 3, M) Pallas taps."""
    return np.transpose(dw, (1, 2, 0))


def _untaps(dw):
    """(3, 3, M) Pallas taps (or their grads) -> (M, 3, 3)."""
    return jnp.transpose(dw, (2, 0, 1))


# ------------------------------------------------------------ the kernels

@pytest.mark.parametrize("c", [8, 24], ids=["M24", "M72"])
def test_qkv_bf16_twins_match_pallas(c):
    """Row 8 forward and row 9 backward, qkv configuration
    (conv1x1_dw_fused), under jax.vjp."""
    p = _inputs(np.random.default_rng(20), 2, 6, 5, c, False)
    (out, (dx, dw_in, ddw)) = _strict_vjp(
        lambda *a: j_qkv(*a, interpret=True),
        (_jbf(p["x"]), _jbf(p["w_qkv"].T), _jbf(_taps(p["dw_qkv"]))), _jbf(p["g_m"]))
    args = (_bf(p["x"]), _bf(p["w_qkv"]), _bf(p["dw_qkv"]))
    _check("conv1x1_dw forward", tfused.conv1x1_dw_fused(*args), out)
    got = tfused.fused_dwconv_bwd(*args, None, _bf(p["g_m"]))
    assert got[3] is None
    for name, g, w in zip(("dx", "dw_in", "ddw"), got, (dx, dw_in.T, _untaps(ddw))):
        _check(f"conv1x1_dw {name}", g, w)


@pytest.mark.parametrize("c,ln_bias", [(8, True), (24, False)],
                         ids=["C8_hid21_WithBias", "C24_hid63_BiasFree"])
def test_block_tail_bf16_backward_twin_matches_pallas(c, ln_bias):
    """Row 5, tail configuration (block_tail), under jax.vjp; and the trap:
    autograd through the bf16 forward twin differs from JAX in more of the
    elements."""
    p = _inputs(np.random.default_rng(21), 2, 6, 5, c, ln_bias)
    ln = [None if p[k] is None else jnp.asarray(p[k]) for k in ("ln_w", "ln_b")]
    j_args = (_jbf(p["x"]), _jbf(p["a"]), _jbf(p["w_proj"].T), *ln, _jbf(p["w_in"].T),
              _jbf(_taps(p["dw_in"])), _jbf(p["w_out"].T))
    if ln_bias:
        fn = lambda *a: j_block_tail(*a, interpret=True)  # noqa: E731
    else:  # a None primal has no cotangent
        j_args = j_args[:4] + j_args[5:]
        fn = lambda x, a, wp, lw, wi, dw, wo: j_block_tail(  # noqa: E731
            x, a, wp, lw, None, wi, dw, wo, interpret=True)
    _, grads = _strict_vjp(fn, j_args, _jbf(p["g_c"]))
    if not ln_bias:
        grads = grads[:4] + (None,) + grads[4:]
    dx, da, dwp, dlnw, dlnb, dwin, ddw, dwout = grads
    want = (dx, da, dwp.T, dlnw, dlnb, dwin.T, _untaps(ddw), dwout.T)
    t_ln = [None if p[k] is None else torch.from_numpy(p[k]) for k in ("ln_w", "ln_b")]
    args = (_bf(p["x"]), _bf(p["a"]), _bf(p["w_proj"]), *t_ln, _bf(p["w_in"]),
            _bf(p["dw_in"]), _bf(p["w_out"]))
    g = _bf(p["g_c"])
    names = ("dx", "da", "dw_proj", "dln_w", "dln_b", "dw_in", "ddw", "dw_out")
    twin, trap = {}, {}
    for name, got, w, autograd in zip(names, tblock.block_tail_bwd(*args, g), want,
                                      tblock._vjp_plain(tblock.block_tail_plain, args, g)):
        if w is None:
            assert got is None and autograd is None
            continue
        _check(f"block_tail {name}", got, w, twin)
        trap[name] = _differ(autograd, w)
    n = {k: _np(w).size for k, w in zip(names, want) if w is not None}
    share = sum(twin[f"block_tail {k}"] * n[k] for k in n) / sum(n.values())
    autograd_share = sum(trap[k] * n[k] for k in n) / sum(n.values())
    print(f"block_tail backward: {share:.4f} of the elements differ from JAX, autograd "
          f"through the bf16 forward twin {autograd_share:.4f}")
    assert share < autograd_share


@pytest.mark.parametrize("b,heads,ch,hw", [(2, 2, 6, (5, 6)), (1, 1, 136, (4, 5))],
                         ids=["two_heads", "one_head_ch136"])
def test_mdta_core_gram_bf16_backward_matches_pallas(b, heads, ch, hw):
    """Rows 6-7 through the fp32 glue (MdtaCore's backward) on a bf16 qkv,
    against the JAX core's VJP (its Gram and apply backward kernels); and
    the trap, autograd through the bf16 forward twins."""
    rng = np.random.default_rng(22)
    c = heads * ch
    qkv = rng.normal(size=(b, *hw, 3 * c)).astype(np.float32)
    temp = rng.uniform(0.5, 2.0, (heads, 1, 1)).astype(np.float32)
    g = rng.normal(size=(b, *hw, c)).astype(np.float32)
    _, (dtemp, dqkv) = _strict_vjp(lambda t, q: j_core_gram(t, q, heads, interpret=True),
                                   (jnp.asarray(temp), _jbf(qkv)), _jbf(g))

    def port(fn):
        t = torch.from_numpy(temp).requires_grad_()
        q = _bf(qkv).requires_grad_()
        return torch.autograd.grad(fn(t, q), (t, q), _bf(g))

    def forward_twins(t, q):
        return tgram.attn_apply_plain(q, tgram._glue(*tgram.mdta_gram_plain(q, heads), t))
    got_t, got_q = port(lambda t, q: tgram.mdta_core_gram(t, q, heads))
    shares = {}
    _check("mdta_core_gram dtemperature", got_t, dtemp, shares)
    _check("mdta_core_gram dqkv", got_q, dqkv, shares)
    autograd_q = port(forward_twins)[1]
    trap = _differ(autograd_q, dqkv)
    print(f"mdta_core_gram dqkv: {shares['mdta_core_gram dqkv']:.4f} of the elements differ "
          f"from JAX, autograd through the bf16 forward twins {trap:.4f}")
    assert shares["mdta_core_gram dqkv"] < trap


# ------------------------------------------------------------ the refusals

@pytest.mark.parametrize("choice,flag", [
    (dict(composition="full"), "--composition full"),
    (dict(composition="head"), "--composition head"),
    (dict(composition="off"), "--composition off"),
    (dict(attention_core="mdta"), "--attention-core mdta"),
    (dict(depthwise="dwconv"), "--depthwise dwconv")])
def test_bf16_training_refuses_every_other_choice_by_name(choice, flag, monkeypatch):
    """Nothing is refused any more: every composition trains in bf16, and
    so do the opt-in attention core and depthwise tier (rows 10-11 in bf16):
    a Trainer in bf16, a tiny T_net's bf16 forward and backward (fp32
    parameter gradients, finite) and the CLI's flags pass in each choice
    as in "tail"."""
    from rcot_torch.train import trainer as ttrainer
    tail = dict(composition="tail", attention_core="gram", depthwise="fused")
    cfg = tconfig.Config(model=TINY, train=tconfig.TrainConfig(dtype="bfloat16"))
    monkeypatch.setattr(ttrainer, "TrainLoader", lambda *a, **k: None)
    trainer = Trainer(cfg, device="cpu", **{**tail, **choice})
    assert all(getattr(trainer, k) == v for k, v in choice.items())
    state = tsteps.create_train_state(cfg, seed=0, device="cpu", **{**tail, **choice})
    x = torch.rand(1, 16, 16, 3, generator=torch.Generator().manual_seed(25))
    out = state.t_net(x.to(torch.bfloat16))[0]
    params = list(state.t_net.parameters())
    grads = torch.autograd.grad(out.float().square().sum(), params, allow_unused=True)
    live = [g for g in grads if g is not None]
    assert out.dtype == torch.bfloat16 and len(live) == len(params)
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in live)
    tcli._refuse_unported(tcli.build_parser().parse_args(
        ["--dtype", "bfloat16", *flag.split()]))  # does not raise


def test_the_gdfn_and_head_configurations_refuse_bf16_by_name():
    """Rows 8-9's GDFN configuration and row 5's head now have bf16 forms:
    on the CPU a bf16 call runs their plain bf16 twins (their outputs bf16,
    dln fp32) and launches nothing; on the card, their kernels
    (tests/test_torch_cuda.py). Their twins against the JAX kernels:
    tests/test_torch_bf16_head_gdfn.py."""
    from rcot_torch.kernels import build
    p = _inputs(np.random.default_rng(23), 1, 4, 4, 8, True)
    gdfn = (_bf(p["x"]), _bf(p["w_in"]), _bf(p["dw_in"]), _bf(p["w_out"]))
    head = (_bf(p["x"]), torch.from_numpy(p["ln_w"]), torch.from_numpy(p["ln_b"]),
            _bf(p["w_qkv"]), _bf(p["dw_qkv"]))
    before = dict(build.LAUNCHES)
    y = tfused.gdfn_fused(*gdfn)
    assert y.dtype == torch.bfloat16 and torch.equal(y, tfused.fused_dwconv_plain(*gdfn))
    for got, want in ((tfused.fused_dwconv_bwd(*gdfn, _bf(p["g_c"])),
                       tfused.fused_dwconv_bwd_plain(*gdfn, _bf(p["g_c"]))),
                      (tblock.block_head_bwd(*head, _bf(p["g_m"])),
                       tblock.block_head_bwd_bf16_plain(*head, _bf(p["g_m"])))):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert [t.dtype for t in tblock.block_head_bwd(*head, _bf(p["g_m"]))] == [
        torch.bfloat16, torch.float32, torch.float32, torch.bfloat16, torch.bfloat16]
    assert dict(build.LAUNCHES) == before


# ------------------------------------------------------------ the train CLI

TINY = tconfig.ModelConfig(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                           parity_params=False)


@pytest.fixture
def tiny_presets(monkeypatch, tmp_path):
    """The CLI's presets with the tiny T_net, a log line every step and the
    sample grids every epoch."""
    real = tconfig.get_preset

    def tiny(name):
        cfg = real(name)
        return cfg.replace(model=TINY, train=tconfig.dataclasses.replace(
            cfg.train, log_every=1, sample_every=1, sample_dir=str(tmp_path / "samples")))
    monkeypatch.setattr(tcli, "get_preset", tiny)


def _flags(tree, run, *extra):
    return ["--device", "cpu", "--dtype", "bfloat16", "--preset", "dehaze", "--de-type",
            "denoise_15", "dehaze", "--patch-size", "32", "--batch-size", "3", "--pairnum",
            "3", "--n-epochs", "2", "--num-workers", "2",
            "--denoise-dir", f"{tree}/Train/Denoise/", "--dehaze-dir", f"{tree}/Train/Dehaze/",
            "--data-file-dir", f"{tree}/manifests/", "--degset", f"{tree}/val/input/",
            "--tarset", f"{tree}/val/target/", "--ckpt-dir", f"{run}/ckpt",
            "--log-file", f"{run}/log.jsonl", "--type", "Bf16", *extra]


def test_cli_trains_in_bf16_and_resumes(tmp_path, tiny_presets, monkeypatch):
    """cli.train --dtype bfloat16 on a seeded tree: a failure at step 3, a
    resume from latest.npz at the epoch step its metadata holds, finite
    metrics, the bf16 batch and the sample dump's bf16 forward, validation
    in fp32, fp32 checkpoints; the config hash the JAX CLI's."""
    import json
    tree, run = tmp_path / "tree", tmp_path / "run"
    write_synthetic_tree(str(tree), seed=1, n_denoise=1, n_rain=0, n_haze=2, size=48,
                         val_sizes=((32, 32), (20, 27)))
    seen = {"batch": set(), "validation": set(), "samples": set()}
    real_inputs = tsteps.step_inputs
    from rcot_torch.train import trainer as ttrainer

    def step_inputs(*a, **k):
        out = real_inputs(*a, **k)
        seen["batch"].add((out[0].degraded.dtype, out[1].dtype))
        return out
    monkeypatch.setattr(ttrainer, "step_inputs", step_inputs)
    real_restorer = ttrainer.make_restorer

    def make_restorer(*a, **k):
        seen["validation"].add(k.get("dtype", torch.float32))
        return real_restorer(*a, **k)
    monkeypatch.setattr(ttrainer, "make_restorer", make_restorer)
    real_grid = ttrainer.save_sample_grid

    def save_sample_grid(*a, **k):
        seen["samples"].update(v.dtype for v in k.values())
        return real_grid(*a, **k)
    monkeypatch.setattr(ttrainer, "save_sample_grid", save_sample_grid)

    with pytest.raises(InjectedFailure, match="step 3"):
        tcli.main(_flags(tree, run, "--fail-at-step", "3", "--ckpt-every-steps", "1"))
    latest = run / "ckpt" / "latest.npz"
    meta = tckpt.read_metadata(str(latest))
    trainer = tcli.main(_flags(tree, run, "--ckpt-every-steps", "1", "--resume", str(latest)))
    with open(run / "log.jsonl") as f:
        ev = [json.loads(line) for line in f]
    resumed = [e for e in ev if e["event"] == "resumed"]
    assert [(e["epoch"], e["epoch_step"]) for e in resumed] == [(meta["epoch"],
                                                                 meta["epoch_step"])]
    steps = [e for e in ev if e["event"] == "train_step"]
    assert steps and all(np.isfinite(e[k]) for e in steps
                         for k in ("f_wgan", "f_gp", "t_loss", "rmse", "fourier"))
    vals = [e for e in ev if e["event"] == "validation"]
    assert vals and all(np.isfinite(v["psnr"]) for v in vals)
    assert seen["batch"] == {(torch.bfloat16, torch.bfloat16)}
    assert seen["validation"] == {torch.float32}
    assert seen["samples"] == {np.dtype(np.float32)}
    assert trainer.host_step == 4 and trainer.dtype == torch.bfloat16
    state = tsteps.create_train_state(trainer.cfg, seed=None, device="cpu")
    tckpt.load_checkpoint(str(latest), state)
    for net in (state.t_net, state.f_net):
        assert all(p.dtype == torch.float32 for p in net.parameters())
    for (n, p), q in zip(state.t_net.named_parameters(), trainer.state.t_net.parameters()):
        assert torch.equal(p, q), n
    assert tckpt.read_metadata(str(latest))["config_hash"] == trainer.cfg.hash()
    flags = [a for a in _flags(tree, run) if a not in ("--device", "cpu")]
    args, jargs = tcli.build_parser().parse_args(flags), jcli.build_parser().parse_args(flags)
    t_cfg = tcli.overlay_config(tconfig.get_preset(args.preset), args)
    j_cfg = jcli.overlay_config(jconfig.get_preset(jargs.preset), jargs)
    assert t_cfg.train.dtype == j_cfg.train.dtype == "bfloat16"
    assert t_cfg.hash() == j_cfg.hash()


@pytest.mark.parametrize("composition", ["full", "head", "off"])
def test_cli_trains_in_bf16_in_every_composition(tmp_path, tiny_presets, composition):
    """cli.train --dtype bfloat16 --composition full, head or off for one
    epoch on the CPU: the T_net's blocks in that composition, finite
    metrics and validation, fp32 parameters."""
    import json
    tree, run = tmp_path / "tree", tmp_path / "run"
    write_synthetic_tree(str(tree), seed=2, n_denoise=1, n_rain=0, n_haze=2, size=48,
                         val_sizes=((32, 32),))
    flags = _flags(tree, run, "--composition", composition)
    flags[flags.index("--n-epochs") + 1] = "1"
    trainer = tcli.main(flags)
    assert trainer.state.t_net.composition == composition
    assert all(p.dtype == torch.float32 for p in trainer.state.t_net.parameters())
    with open(run / "log.jsonl") as f:
        ev = [json.loads(line) for line in f]
    steps = [e for e in ev if e["event"] == "train_step"]
    vals = [e for e in ev if e["event"] == "validation"]
    assert steps and all(np.isfinite(e[k]) for e in steps for k in ("f_wgan", "t_loss"))
    assert vals and all(np.isfinite(v["psnr"]) for v in vals)


def test_bf16_plan_workspaces():
    """The bf16 tail backward's workspaces (csrc/block_bwd_bf16.cu's order):
    the recompute's bf16 t, u, h two to a float, then fp32 stats, conv/dh,
    dconv, the gate, du and dt; no fp32 copy of an operand, a weight or an
    output."""
    n, c, hid = 3 * 16 * 16, 48, 127
    sizes = tblock.bwd_bf16_workspace_numel(n, c, hid)
    assert len(sizes) == 9
    assert sizes[:3] == (n * c // 2, n * c // 2, n * hid)
    assert sizes[3:] == (2 * n, 2 * n * hid, 2 * n * hid, n * hid, n * c, n * c)
    assert tblock.bwd_bf16_workspace_numel(5, 7, 9)[0] == 18  # an odd count rounds up


def test_trap_helpers_round_where_jax_rounds():
    """_st rounds the value and passes the gradient; in fp32 it is the
    identity, so the fp32 twins keep their bits."""
    v = torch.tensor([1.0 + 2.0 ** -10, 3.0], requires_grad=True)
    r = tblock._st(v, torch.bfloat16)
    assert r.tolist() == [1.0, 3.0]
    (g,) = torch.autograd.grad((r * torch.tensor([2.0, 5.0])).sum(), v)
    assert g.tolist() == [2.0, 5.0]
    assert torch.equal(tblock._st(v, torch.float32), v)
    p = _inputs(np.random.default_rng(24), 1, 4, 4, 8, True)
    x, w, dw = (torch.from_numpy(p[k]) for k in ("x", "w_qkv", "dw_qkv"))
    assert torch.equal(tfused.fused_dwconv_plain(x, w, dw, None),
                       tfused.depthwise3x3(tfused.conv1x1(x, w), dw))
