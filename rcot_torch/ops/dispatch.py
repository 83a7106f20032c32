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

A fourth choice, of training alone: which backward kernels round the
operands of their products to bf16 (RCOT_BWD_BF16, resolve_bwd_bf16). It
changes nothing in serving, which runs no backward.
"""

from __future__ import annotations

COMPOSITIONS = ("full", "head", "tail", "off")
ATTENTION_CORES = ("gram", "mdta")
DEPTHWISE = ("fused", "dwconv")
BWD_BF16_TIERS = ("fused", "block", "gram")


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



def resolve_bwd_bf16(requested) -> frozenset:
    """The backward tiers whose products take bf16 operands, as
    RCOT_BWD_BF16 names them (rcot_tpu/ops/pallas_fused.py:123-141
    _bwd_dot_dtype, read through dispatch.resolved_env, dispatch.py:43-51):
    "0" or "" none; "1" or "all" every tier; else a comma list of "fused"
    (row 9, fused_dwconv_bwd), "block" (row 5, fused_block_bwd) and "gram"
    (rows 6-7, mdta_gram_bwd and attn_apply_bwd). In those kernels each
    backward product rounds both operands to bf16 (round to nearest even)
    and sums in fp32 (_bwd_dot, :144-148); nothing else changes. A resolved
    set is taken as it is. An unknown tier name raises."""
    if isinstance(requested, (set, frozenset)):
        names = requested
    elif requested in (None, "", "0"):
        return frozenset()
    elif requested in ("1", "all"):
        return frozenset(BWD_BF16_TIERS)
    else:
        names = requested.split(",")
    bad = [n for n in names if n not in BWD_BF16_TIERS]
    if bad:
        raise ValueError(f"unknown backward tier {bad[0]!r} in {requested!r}; 0, 1, all or "
                         f"a comma list of {BWD_BF16_TIERS}")
    return frozenset(names)
