"""Drive the rcot_torch port on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from rcot_torch/csrc with nvcc (sm_90a);
  3. hold each kernel against its plain PyTorch twin on the card at every
     block shape of a 256x256 forward, B = 1 and 2, both LayerNorm types;
  4. serve the full-width T_net (ModelConfig(), 46,853,150 parameters,
     seeded random weights) through make_restorer: restore_batch on 256^2
     images plus a 250x321 one, and a tiled 600x600 restore; check shapes,
     finiteness and that every kernel ran 94 times per two-pass forward;
     compare a 128^2 forward with the same model on the CPU, and the
     reference golden (tests/goldens/tnet_full.npz) on the card;
  5. time images/s at 256 px, batch 1 and 8, and each kernel at the
     level-1 and latent shapes beside its bound, its plain twin and, where
     one exists, a single PyTorch call computing the same product; split
     one 256 px forward into the four kernels (each timed at every block
     shape, times the blocks at that shape) and the rest.

TF32 is off for every matmul and cuDNN convolution in this script, so the
plain twins and the CPU reference run in full fp32. Kernel agreement is
checked as max|kernel - plain| <= 1e-5 * max(max|plain|, 1) (fp32 sums in
another order). The Gram's plain twin runs in float64: its sums run over
every pixel with cancelling terms, and in fp32 on the card the twin's own
rounding comes near the tolerance (printed as
gram_plain_fp32_vs_float64_rel_err), while the kernel, which adds its
partial sums with atomics in no fixed order, stays an order of magnitude
inside it.

Prints the kernels' JSON line and, last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from rcot_torch.kernels import build
from rcot_torch.models.inference import make_restorer
from rcot_torch.models.restormer import TNet, count_params
from rcot_torch.ops import block as kblock
from rcot_torch.ops import gram as kgram
from rcot_torch.utils.config import ModelConfig

PEAK_FLOPS = 67e12   # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
KERNEL_RTOL = 1e-5
MODEL_ATOL, MODEL_RTOL = 2e-4, 1e-3
FORWARD_LAUNCHES = 94  # blocks per two-pass forward at ModelConfig()

# (name, resolution, C, heads) of every block group of a 256x256 forward
MAIN_SHAPES = [
    ("L1", 256, 48, 1), ("L2", 128, 96, 2), ("L3", 64, 192, 4),
    ("latent", 32, 384, 8), ("noise_level3", 32, 384, 4),
    ("noise_level2", 64, 192, 4), ("noise_level1", 128, 96, 4),
    ("decoder_level1", 256, 96, 1),
]
# blocks at each of those shapes in one two-pass forward: the encoder and
# the residual encoder once each, the decoder (with its conditioning blocks
# and the refinement) once per pass
BLOCKS_PER_FORWARD = {"L1": 8, "L2": 24, "L3": 24, "latent": 16, "noise_level3": 2,
                      "noise_level2": 2, "noise_level1": 2, "decoder_level1": 16}
assert sum(BLOCKS_PER_FORWARD.values()) == FORWARD_LAUNCHES

KERNELS = {
    "block_head": ("rcot_torch/csrc/block_fwd.cu", "rcot_tpu/ops/pallas_block.py:586"),
    "block_tail": ("rcot_torch/csrc/block_fwd.cu", "rcot_tpu/ops/pallas_block.py:597"),
    "mdta_gram_fwd": ("rcot_torch/csrc/gram_fwd.cu", "rcot_tpu/ops/pallas_gram.py:99"),
    "attn_apply_fwd": ("rcot_torch/csrc/gram_fwd.cu", "rcot_tpu/ops/pallas_gram.py:178"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


# ------------------------------------------------------------ inputs

def block_inputs(gen, b, res, c, ln_bias):
    hid = int(c * 2.66)
    m = 3 * c

    def r(*shape, loc=0.0, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale + loc
    return dict(
        x=r(b, res, res, c), a=r(b, res, res, c),
        ln_w=r(c, loc=1.0, scale=0.1), ln_b=r(c, scale=0.1) if ln_bias else None,
        w_qkv=r(m, c, scale=c ** -0.5), dw_qkv=r(m, 3, 3, scale=0.3),
        w_proj=r(c, c, scale=c ** -0.5), w_in=r(2 * hid, c, scale=c ** -0.5),
        dw_in=r(2 * hid, 3, 3, scale=0.3), w_out=r(c, hid, scale=hid ** -0.5))


def head_args(p):
    return (p["x"], p["ln_w"], p["ln_b"], p["w_qkv"], p["dw_qkv"])


def tail_args(p):
    return tuple(p[k] for k in ("x", "a", "w_proj", "ln_w", "ln_b", "w_in",
                                "dw_in", "w_out"))


def check(name, got, want, errs) -> None:
    """Kernel outputs (a tensor or a tuple) against the plain twin's; the
    largest absolute and relative errors per kernel are kept in errs."""
    kernel = name.split()[0]
    for g, w in zip(*((t,) if torch.is_tensor(t) else t for t in (got, want))):
        if g.shape != w.shape:
            raise AssertionError(f"{name}: shape {tuple(g.shape)} != {tuple(w.shape)}")
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        worst = errs.setdefault(kernel, [0.0, 0.0])
        worst[0] = max(worst[0], err)
        worst[1] = max(worst[1], err / max(scale, 1.0))
        if not err <= KERNEL_RTOL * max(scale, 1.0):
            raise AssertionError(f"{name}: max|err| {err:.3e} > {KERNEL_RTOL:g} * "
                                 f"max|plain| {scale:.3e}")


# ------------------------------------------------------------ phases

def phase_kernels(gen) -> dict:
    """Every kernel against its plain twin at the main-path shapes."""
    errs: dict = {}
    for label, res, c, heads in MAIN_SHAPES:
        for b in (1, 2):
            for ln_bias in (True, False):
                p = block_inputs(gen, b, res, c, ln_bias)
                tag = f"{label} B={b} {'WithBias' if ln_bias else 'BiasFree'}"
                qkv = kblock.block_head(*head_args(p))
                torch.cuda.synchronize()
                check(f"block_head {tag}", qkv, kblock.block_head_plain(*head_args(p)), errs)
                y = kblock.block_tail(*tail_args(p))
                torch.cuda.synchronize()
                check(f"block_tail {tag}", y, kblock.block_tail_plain(*tail_args(p)), errs)
            gram = kgram.mdta_gram_fwd(qkv, heads)
            torch.cuda.synchronize()
            exact = kgram.mdta_gram_plain(qkv.double(), heads)
            check(f"mdta_gram_fwd {label} B={b}", gram, exact, errs)
            # the fp32 twin's own rounding, for the record (docstring above)
            fp32_err = max(float((f - e).abs().max() / e.abs().max())
                           for f, e in zip(kgram.mdta_gram_plain(qkv, heads), exact))
            errs["gram_plain_fp32_rel"] = max(errs.get("gram_plain_fp32_rel", 0.0), fp32_err)
            ch = c // heads
            attn = torch.softmax(torch.randn(b, heads, ch, ch, device="cuda",
                                             generator=gen), -1)
            out = kgram.attn_apply_fwd(qkv, attn)
            torch.cuda.synchronize()
            check(f"attn_apply_fwd {label} B={b}", out,
                  kgram.attn_apply_plain(qkv, attn), errs)
            log(f"kernels ok at {label} {res}^2 C={c} heads={heads} B={b}")
    return errs


def phase_model(gen_np) -> dict:
    cfg = ModelConfig()
    t0 = time.perf_counter()
    net = TNet(cfg, device="cuda", seed=0).eval()
    n_params = count_params(net)
    if n_params != 46_853_150:
        raise AssertionError(f"T_net has {n_params} parameters, not 46,853,150")
    log(f"T_net built: {n_params} parameters, seeded weights "
        f"({time.perf_counter() - t0:.1f} s)")
    restorer = make_restorer(net, cfg, device="cuda")
    tiled = make_restorer(net, cfg, tile=256, tile_overlap=32, device="cuda")
    forwards = [0]
    for r in (restorer, tiled):
        fn = r.model_fn

        def counted(x, fn=fn):
            forwards[0] += 1
            return fn(x)
        r.model_fn = counted

    imgs = [gen_np.uniform(0, 1, (256, 256, 3)).astype(np.float32) for _ in range(3)]
    imgs.append(gen_np.uniform(0, 1, (250, 321, 3)).astype(np.float32))
    big = gen_np.uniform(0, 1, (600, 600, 3)).astype(np.float32)

    # ---- the main path, counted
    build.reset_launches()
    outs = restorer.restore_batch(imgs)
    out_big = tiled(big)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    n_fwd = forwards[0]
    for im, o in zip(imgs + [big], outs + [out_big]):
        if o.shape != im.shape or not np.isfinite(o).all():
            raise AssertionError(f"bad output {o.shape} for input {im.shape}")
    for name in KERNELS:
        if launches.get(name, 0) != FORWARD_LAUNCHES * n_fwd or n_fwd == 0:
            raise AssertionError(f"{name}: {launches.get(name, 0)} launches over "
                                 f"{n_fwd} forwards, want {FORWARD_LAUNCHES} each")
    log(f"main path: {n_fwd} two-pass forwards, launches {launches}")

    # ---- agreement with the same model on the CPU
    x = torch.from_numpy(gen_np.uniform(0, 1, (1, 128, 128, 3)).astype(np.float32))
    with torch.inference_mode():
        on_card = net(x.cuda())
        cpu_net = TNet(cfg, device="cpu", seed=None).eval()
        cpu_net.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
        on_cpu = cpu_net(x)
    for name, a, b in zip(("out2", "out1", "res"), on_card, on_cpu):
        a = a.cpu()
        err = float((a - b).abs().max())
        log(f"card vs CPU 128^2 {name}: max|err| {err:.3e}")
        torch.testing.assert_close(a, b, atol=MODEL_ATOL, rtol=MODEL_RTOL)
    del cpu_net

    # ---- the reference golden (reference PyTorch model, tools/make_goldens.py)
    golden_err = golden_check()
    return dict(net=net, restorer=restorer, launches=launches, n_fwd=n_fwd,
                golden_err=golden_err)


def golden_check() -> float:
    z = np.load(Path(__file__).resolve().parent / "tests" / "goldens" / "tnet_full.npz")
    sd = {}
    for n, s in zip(z["names"], z["shapes"]):
        n = str(n)
        shape = tuple(int(v) for v in str(s).split(","))
        rng = np.random.default_rng(zlib.crc32(n.encode()) & 0xFFFFFFFF)
        sd[n] = torch.from_numpy((rng.standard_normal(shape) * 0.02).astype(np.float32))
    net = TNet(ModelConfig(), device="cuda", seed=None).eval()
    net.load_state_dict(sd, strict=True)
    x = torch.from_numpy(np.transpose(z["input"], (0, 2, 3, 1)).copy()).cuda()
    with torch.inference_mode():
        out2 = net(x)[0].permute(0, 3, 1, 2).cpu()
    want = torch.from_numpy(z["out2"])
    err = float((out2 - want).abs().max())
    log(f"golden 32^2 out2 on the card: max|err| {err:.3e}")
    torch.testing.assert_close(out2, want, atol=MODEL_ATOL, rtol=MODEL_RTOL)
    return err


# ------------------------------------------------------------ timing

def cuda_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_timings(gen, label, res, c, heads) -> dict:
    b, n = 1, res * res
    p = block_inputs(gen, b, res, c, True)
    m, hid, ch = 3 * c, int(c * 2.66), c // heads
    qkv = kblock.block_head(*head_args(p))
    attn = torch.softmax(torch.randn(b, heads, ch, ch, device="cuda", generator=gen), -1)
    # the same products as single PyTorch calls, on pre-transposed tensors
    qt = qkv[..., :c].reshape(b, n, heads, ch).permute(0, 2, 3, 1).reshape(b * heads, ch, n).contiguous()
    kt = qkv[..., c:2 * c].reshape(b, n, heads, ch).permute(0, 2, 1, 3).reshape(b * heads, n, ch).contiguous()
    vt = qkv[..., 2 * c:].reshape(b, n, heads, ch).permute(0, 2, 3, 1).reshape(b * heads, ch, n).contiguous()
    at = attn.reshape(b * heads, ch, ch)
    f4 = 4.0
    rows = {
        "block_head": (lambda: kblock.block_head(*head_args(p)),
                       lambda: kblock.block_head_plain(*head_args(p)), None,
                       b * n * (2 * c * m + 18 * m + 8 * c),
                       f4 * (b * n * (c + m) + 2 * c + m * c + 9 * m)),
        "block_tail": (lambda: kblock.block_tail(*tail_args(p)),
                       lambda: kblock.block_tail_plain(*tail_args(p)), None,
                       b * n * (2 * c * c + 4 * c * hid + 2 * hid * c + 36 * hid
                                + 10 * hid + 10 * c),
                       f4 * (3 * b * n * c + c * c + 2 * c + 2 * hid * c + 18 * hid
                             + c * hid)),
        "mdta_gram_fwd": (lambda: kgram.mdta_gram_fwd(qkv, heads),
                          lambda: kgram.mdta_gram_plain(qkv, heads),
                          lambda: torch.bmm(qt, kt),
                          b * n * (2 * c * ch + 4 * c),
                          f4 * (b * n * 2 * c + b * heads * (ch * ch + 2 * ch))),
        "attn_apply_fwd": (lambda: kgram.attn_apply_fwd(qkv, attn),
                           lambda: kgram.attn_apply_plain(qkv, attn),
                           lambda: torch.bmm(at, vt),
                           b * n * 2 * c * ch,
                           f4 * (2 * b * n * c + b * heads * ch * ch)),
    }
    out = {}
    for name, (kern, plain, lib, flops, nbytes) in rows.items():
        bms, by = bound(flops, nbytes)
        out[name] = dict(shape=f"{label} {res}^2 C={c} heads={heads} B={b}",
                         ms=cuda_ms(kern), plain_ms=cuda_ms(plain), bound_ms=bms,
                         bound_by=by, library_ms=cuda_ms(lib) if lib else None)
    return out


def images_per_sec(restorer, gen_np, batch, iters) -> float:
    imgs = [gen_np.uniform(0, 1, (256, 256, 3)).astype(np.float32) for _ in range(batch)]
    for _ in range(2):
        restorer.restore_batch(imgs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        restorer.restore_batch(imgs)
    torch.cuda.synchronize()
    return batch * iters / (time.perf_counter() - t0)


def forward_breakdown(gen, net, timings) -> dict:
    """Device time of one two-pass forward at 256 px, batch 1, beside each
    kernel's time at every block shape times the blocks at that shape; the
    rest is the convolutions, resamplers, glue and launch gaps outside them."""
    x = torch.rand(1, 256, 256, 3, device="cuda", generator=gen)
    with torch.inference_mode():
        fwd = cuda_ms(lambda: net(x), iters=10, warmup=2)
    per_kernel = {name: sum(BLOCKS_PER_FORWARD[label] * timings[label][name]["ms"]
                            for label in BLOCKS_PER_FORWARD) for name in KERNELS}
    return dict(forward_ms=fwd, kernels_ms=per_kernel,
                outside_kernels_ms=fwd - sum(per_kernel.values()))


# ------------------------------------------------------------ main

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "measures the CUDA port and has nothing to run here", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    log(f"kernels built: {lib.name} in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device="cuda").manual_seed(0)
    gen_np = np.random.default_rng(0)
    errs = phase_kernels(gen)
    model = phase_model(gen_np)

    ips1 = images_per_sec(model["restorer"], gen_np, 1, 10)
    ips8 = images_per_sec(model["restorer"], gen_np, 8, 3)
    log(f"256px restore_batch: {ips1:.3f} img/s at batch 1, {ips8:.3f} img/s "
        f"at batch 8 ({card})")

    timings = {label: kernel_timings(gen, label, res, c, heads)
               for label, res, c, heads in MAIN_SHAPES}
    breakdown = forward_breakdown(gen, model["net"], timings)
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        l1, lat = timings["L1"][name], timings["latent"][name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=model["launches"][name],
            launches_per_forward=model["launches"][name] // model["n_fwd"],
            max_abs_err=errs[name][0], max_rel_err=errs[name][1],
            ms=l1["ms"], plain_ms=l1["plain_ms"],
            bound_ms=l1["bound_ms"], bound_by=l1["bound_by"],
            library_ms=l1["library_ms"], at=l1["shape"], latent=lat))
    for label in BLOCKS_PER_FORWARD:
        log(json.dumps({"shape": label, **{
            name: {k: v for k, v in t.items() if k != "shape"}
            for name, t in timings[label].items()}}))
    log(json.dumps({"e2e_256px": {"batch1_img_per_s": ips1, "batch8_img_per_s": ips8,
                                  "card": card},
                    "forward_256px_b1": breakdown,
                    "gram_plain_fp32_vs_float64_rel_err": errs["gram_plain_fp32_rel"],
                    "golden_max_abs_err": model["golden_err"],
                    "seconds": time.perf_counter() - t_start}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
