"""Which kernels a bias-free transformer block composes.

Counterpart of rcot_tpu/ops/dispatch.py `block_mode()` (:117-156) and its
opt-in switches, as pure functions: every choice is an argument of the
model, never read from the environment. Three axes.

The composition, the values of RCOT_PALLAS_BLOCK:

  full: block_head -> attention core -> block_tail
  head: block_head -> attention core -> x + proj(a) -> x + gdfn(LN2(x))
  tail: LN1 -> qkv -> attention core -> block_tail
  off:  LN1 -> qkv -> attention core -> x + proj(a) -> x + gdfn(LN2(x))

"auto" resolves as the JAX package resolves it with its Gram tier on:
"full" when serving (its inference scope, dispatch.py:123-139) and "tail"
when training (dispatch.py:156). RCOT_PALLAS_MDTA does not move that
choice: with it, the JAX package's Gram switch is still on.

The attention core (rcot_tpu/ops/attention.py:56-86):

  gram: the transpose-free Gram and apply kernels (ops/gram.py), the JAX
        package's default;
  mdta: heads transposed to (B, heads, ch, HW), the fused attend kernel
        (ops/mdta.py), transposed back: RCOT_PALLAS_MDTA=1.

The depthwise tier of the qkv and the GDFN outside the block kernels
(rcot_tpu/ops/attention.py:89-117, gdfn.py:44-75), that is "qkv" and
"gdfn" above:

  fused:  conv1x1_dw_fused and gdfn_fused (ops/fused.py), the default;
  dwconv: the 1x1 convs as products and the standalone depthwise kernel
          (ops/dwconv.py): RCOT_PALLAS_FUSED=0 RCOT_PALLAS_DWCONV=1.

In "full" the depthwise tier changes nothing: the head and tail kernels do
their own depthwise convs, in the JAX package as here.

In bf16 every choice runs, in serving (--dtype bfloat16 on cli.test and
cli.eval_all) and in training (cli.train --dtype bfloat16) alike: rows 1-4
and 8 forward, rows 5-7 and 9 backward, each in the configurations its
composition calls, and with `--attention-core mdta` and `--depthwise
dwconv` the bf16 forms of rows 10 and 11 (ops/mdta.py, ops/dwconv.py), as
the JAX package runs each of them on a bf16 input.
"""

from __future__ import annotations

COMPOSITIONS = ("full", "head", "tail", "off")
ATTENTION_CORES = ("gram", "mdta")
DEPTHWISE = ("fused", "dwconv")


def resolve_composition(requested: str, *, training: bool) -> str:
    if requested == "auto":
        return "tail" if training else "full"
    if requested not in COMPOSITIONS:
        raise ValueError(f"unknown composition {requested!r}; one of "
                         f"{('auto',) + COMPOSITIONS}")
    return requested


def resolve_attention_core(requested: str) -> str:
    if requested not in ATTENTION_CORES:
        raise ValueError(f"unknown attention core {requested!r}; one of "
                         f"{ATTENTION_CORES}")
    return requested


def resolve_depthwise(requested: str) -> str:
    if requested not in DEPTHWISE:
        raise ValueError(f"unknown depthwise tier {requested!r}; one of {DEPTHWISE}")
    return requested

