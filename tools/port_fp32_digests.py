"""SHA-256 digests of the fp32 kernels' outputs of an rcot_torch tree on
one CUDA card: rows 1-2 (tools/port_block_fwd_times.py), 3-4 and 6-7
(port_gram_times.py), 5 (port_block_bwd_times.py) and 8-9
(port_fused_times.py), each tool's `digests` alone, without its timings.

    python tools/port_fp32_digests.py [--root DIR]

rcot_torch and its kernels are DIR's (default: this checkout). Two trees
whose digests agree computed the same bits. Prints one JSON line with the
root and the card's name and power limit.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import port_block_bwd_times  # noqa: E402
import port_block_fwd_times  # noqa: E402
import port_fused_times  # noqa: E402
import port_gram_times  # noqa: E402


def main() -> int:
    smoke = port_gram_times.load(__doc__)
    if smoke is None:
        return 1
    out = {name: mod.digests(smoke) for name, mod in (
        ("block_fwd", port_block_fwd_times), ("gram", port_gram_times),
        ("block_bwd", port_block_bwd_times), ("fused", port_fused_times))}
    print(json.dumps({"root": str(smoke.root), "card": smoke.card_line(), "digests": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
