"""Which kernels a bias-free transformer block composes.

Counterpart of rcot_tpu/ops/dispatch.py `block_mode()` (:117-156) as a pure
function: the composition is an argument of the model, never read from the
environment. The four values are those of RCOT_PALLAS_BLOCK:

  full: block_head -> Gram core -> block_tail
  head: block_head -> Gram core -> x + proj(a) -> x + gdfn_fused(LN2(x))
  tail: LN1 -> conv1x1_dw_fused -> Gram core -> block_tail
  off:  LN1 -> conv1x1_dw_fused -> Gram core -> x + proj(a)
        -> x + gdfn_fused(LN2(x))        (the JAX package's fused tier)

"auto" resolves as the JAX package resolves it with its Gram tier on:
"full" when serving (its inference scope, dispatch.py:123-139) and "tail"
when training (dispatch.py:156).
"""

from __future__ import annotations

COMPOSITIONS = ("full", "head", "tail", "off")


def resolve_composition(requested: str, *, training: bool) -> str:
    if requested == "auto":
        return "tail" if training else "full"
    if requested not in COMPOSITIONS:
        raise ValueError(f"unknown composition {requested!r}; one of "
                         f"{('auto',) + COMPOSITIONS}")
    return requested
