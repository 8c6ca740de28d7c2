"""Operator taxonomy — the paper's GEMM / NonGEMM operator groups.

A copy of ``repro.core.taxonomy``'s group enum, the NonGEMM umbrella and
the ``ng:<group>:<name>`` scope-tag grammar (a test pins the copies equal
to their originals). The jaxpr-primitive fallback table becomes an
aten-op table: an op captured outside every ``ng:`` scope is classified by
its aten name (``aten.mm`` -> GEMM, ``aten.view`` -> Memory, ...).

A hand-written kernel of this package (namespace ``repro_torch``) that
runs outside a scope tag is classed ``fused``: it is one launch standing
for a NonGEMM chain, as an untagged ``pallas_call`` is in the JAX package.
"""

from __future__ import annotations

import enum
import re
from typing import Optional, Tuple


class OpGroup(str, enum.Enum):
    GEMM = "gemm"
    NORMALIZATION = "normalization"
    ACTIVATION = "activation"
    MEMORY = "memory"
    ELEMENTWISE = "elementwise"
    LOGIT = "logit"
    QUANT = "quantization"
    FUSED = "fused"
    ROI = "roi"
    INTERPOLATION = "interpolation"
    REDUCTION = "reduction"
    COLLECTIVE = "collective"
    CONTROL = "control"
    OTHER = "other"

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


#: The paper's NonGEMM umbrella: everything that is not a GEMM and not pure
#: program structure. Collectives are reported separately.
NONGEMM_GROUPS = frozenset(
    {
        OpGroup.NORMALIZATION,
        OpGroup.ACTIVATION,
        OpGroup.MEMORY,
        OpGroup.ELEMENTWISE,
        OpGroup.LOGIT,
        OpGroup.QUANT,
        OpGroup.FUSED,
        OpGroup.ROI,
        OpGroup.INTERPOLATION,
        OpGroup.REDUCTION,
        OpGroup.OTHER,
    }
)

_TAG_PREFIX = "ng:"
_TAG_RE = re.compile(r"ng:([a-z_]+):([A-Za-z0-9_.\-]+)")

_GROUP_BY_VALUE = {g.value: g for g in OpGroup}


def scope_tag(group: OpGroup | str, name: str) -> str:
    """Build the scope tag for an operator site."""
    g = group.value if isinstance(group, OpGroup) else str(group)
    if g not in _GROUP_BY_VALUE:
        raise ValueError(f"unknown operator group {g!r}")
    return f"{_TAG_PREFIX}{g}:{name}"


def parse_scope(scope_path: str) -> Optional[Tuple[OpGroup, str]]:
    """Extract the innermost ``ng:<group>:<name>`` tag from a scope path."""
    matches = _TAG_RE.findall(scope_path or "")
    if not matches:
        return None
    g, name = matches[-1]  # innermost tag wins
    group = _GROUP_BY_VALUE.get(g)
    if group is None:
        return None
    return group, name


# --------------------------------------------------------------------------
# aten op name -> group (fallback when no scope tag is present)
# --------------------------------------------------------------------------

_ATEN_GROUPS: dict[str, OpGroup] = {}


def _reg(group: OpGroup, *names: str) -> None:
    for n in names:
        _ATEN_GROUPS[f"aten.{n}"] = group


_reg(OpGroup.GEMM, "mm", "addmm", "bmm", "baddbmm", "matmul", "dot", "mv",
     "linear", "convolution", "_scaled_dot_product_flash_attention",
     "_scaled_dot_product_efficient_attention")
_reg(OpGroup.ACTIVATION, "tanh", "sigmoid", "silu", "gelu", "relu", "erf")
_reg(OpGroup.NORMALIZATION, "rsqrt", "_fused_rms_norm", "native_layer_norm")
_reg(OpGroup.LOGIT, "_softmax", "softmax", "_log_softmax")
_reg(
    OpGroup.MEMORY,
    "view", "_unsafe_view", "reshape", "permute", "transpose", "t",
    "expand", "unsqueeze", "squeeze", "select", "slice", "narrow", "cat",
    "stack", "split", "split_with_sizes", "index", "index_select",
    "embedding", "gather", "scatter", "index_put", "index_put_", "copy_",
    "_to_copy", "clone", "contiguous", "empty", "empty_like", "zeros",
    "zeros_like", "full", "full_like", "new_zeros", "new_empty", "new_full",
    "arange",
    "alias", "detach", "lift_fresh", "_unsafe_index_put", "slice_scatter",
    "fill_", "zero_", "as_strided", "unbind", "repeat", "flatten",
)
_reg(
    OpGroup.ELEMENTWISE,
    "add", "add_", "sub", "mul", "mul_", "div", "div_", "neg", "maximum",
    "minimum", "pow", "abs", "sign", "floor", "ceil", "round", "exp", "log",
    "log1p", "expm1", "sqrt", "square", "where", "clamp", "eq", "ne", "lt",
    "le", "gt", "ge", "logical_and", "logical_or", "logical_not",
    "bitwise_and", "bitwise_or", "bitwise_not", "sin", "cos", "reciprocal",
    "masked_fill", "_assert_async", "lerp",
    # the ring cache's slot arithmetic (floor mod, as jnp.mod)
    "remainder",
)
_reg(
    OpGroup.REDUCTION,
    "sum", "mean", "amax", "amin", "max", "min", "prod", "any", "all",
    "argmax", "argmin", "cumsum", "cumprod", "topk", "sort", "var", "std",
    # the vision heads' pooling
    "max_pool2d", "max_pool2d_with_indices", "avg_pool2d",
)
_reg(OpGroup.INTERPOLATION, "upsample_bilinear2d")
_reg(OpGroup.OTHER, "_local_scalar_dense", "item")

#: namespace of this package's hand-written kernels (torch.library ops)
KERNEL_NAMESPACE = "repro_torch"


def classify_op(op_name: str) -> OpGroup:
    """Group of an op captured outside every ``ng:`` scope.

    ``op_name`` is the overload packet's dotted name (``aten.mm``,
    ``repro_torch.decode_core``).
    """
    if op_name.startswith(KERNEL_NAMESPACE + "."):
        return OpGroup.FUSED
    return _ATEN_GROUPS.get(op_name, OpGroup.OTHER)


def classify(op_name: str, scope_path: str = "") -> Tuple[OpGroup, str]:
    """Classify an op, preferring the semantic scope tag over the op name.

    Returns ``(group, op_site_name)``; untagged ops use the op name as the
    site name.
    """
    tagged = parse_scope(scope_path)
    if tagged is not None:
        return tagged
    return classify_op(op_name), op_name


def is_gemm(group: OpGroup) -> bool:
    return group == OpGroup.GEMM


def is_nongemm(group: OpGroup) -> bool:
    return group in NONGEMM_GROUPS
