"""Times the fused MDTA attend (row 10: mdta_attend) of an rcot_torch tree on
one CUDA card, at every block shape of the serving path (256^2, B = 1) and
of the training path (128^2, B = 3).

    python tools/port_mdta_times.py [--root DIR] [--digest]

As tools/port_gram_times.py does: rcot_torch and its kernels are DIR's
(default: this checkout), timed with this checkout's
chip_smoke.kernel_timings (`ms`, `device_ms`, the bound, the plain twin,
and `two_bmm_ms`, two bmm on pre-normalised heads, as the library's
yardstick). Beside each shape it prints the device time of one call split
by launch (tools/port_block_bwd_times.py stage_split: `by_launch` names each
kernel, memset and copy of a call in launch order). Then the sums: 94 calls
make a two-pass forward in off/mdta/dwconv and a tail/mdta/dwconv training
iteration (chip_smoke.BLOCKS_PER_FORWARD). With --digest it first prints a
SHA-256 of the attend's output on seeded inputs at every shape, computed
twice: where the sums run in a fixed order the two agree. Last come the
root and the card's name and power limit. To hold two trees against each
other, run them in turns in one call (A, B, B, A).
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import port_block_bwd_times as bwd_times  # noqa: E402
import port_gram_times  # noqa: E402

NAME = "mdta_attend"


def shapes(smoke):
    """(tag, b, label, res, c, heads) of every serving and training shape."""
    return ([("serve", 1, *s) for s in smoke.MAIN_SHAPES]
            + [("train", smoke.TRAIN_B, *s) for s in smoke.TRAIN_SHAPES])


def inputs(smoke, gen, b, res, c, heads):
    """q, k, v (b, heads, c / heads, res^2) and a temperature (heads, 1, 1)."""
    torch = smoke.torch
    q, k, v = (torch.randn(b, heads, c // heads, res * res, device="cuda", generator=gen)
               for _ in range(3))
    return q, k, v, torch.rand(heads, 1, 1, device="cuda", generator=gen) + 0.5


def digests(smoke) -> dict:
    """{shape: [SHA-256 of a call's output, of a second call's]}."""
    gen = smoke.torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for tag, b, label, res, c, heads in shapes(smoke):
        args = inputs(smoke, gen, b, res, c, heads)
        out[f"{tag} {label}"] = [
            hashlib.sha256(smoke.kmdta.mdta_attend_fwd(*args).cpu().numpy().tobytes()).hexdigest()
            for _ in range(2)]
    return out


def main() -> int:
    flag = "--digest" in sys.argv
    sys.argv = [a for a in sys.argv if a != "--digest"]
    smoke = port_gram_times.load(__doc__)
    if smoke is None:
        return 1
    if flag:
        print(json.dumps({"digests": digests(smoke)}), flush=True)
    gen = smoke.torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for tag, b, label, res, c, heads in shapes(smoke):
        row = smoke.kernel_timings(gen, label, res, c, heads, b, [NAME])[NAME]
        args = inputs(smoke, gen, b, res, c, heads)
        row["stage_split"] = bwd_times.stage_split(
            smoke, lambda: smoke.kmdta.mdta_attend_fwd(*args))
        rows[f"{tag} {label}"] = row
        print(json.dumps({"shape": f"{tag} {label}", NAME: row}), flush=True)
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "two_bmm_ms")
    print(json.dumps({f"per_{what}": {k: sum(n * rows[f"{tag} {label}"][k]
                                             for label, n in smoke.BLOCKS_PER_FORWARD.items())
                                      for k in keys}
                      for tag, what in (("serve", "serving_forward_off_mdta_dwconv"),
                                        ("train", "train_iteration_tail_mdta_dwconv"))}),
          flush=True)
    print(json.dumps({"root": str(smoke.root), "card": smoke.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
