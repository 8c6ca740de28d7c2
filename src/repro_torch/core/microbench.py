"""NonGEMM operator micro-benchmark suite (paper §3.2.4, Table 2).

The port of ``repro.core.microbench``: the same operators, in the same
order, under the same names and groups, at the same Table-2 shapes. Each
entry runs one NonGEMM operator standalone through the port's ``nn`` ops
(the attention rows through the kernel wrappers of ``kernels.ops``, where
JAX calls ``attn_template.get``), on the card unless the caller asks for
the CPU.

Per op:

* ``device_us`` — the whole call: on the card its device time, through
  :class:`repro_torch.core.graph.Timer` (L2 flushed, host dispatch padded
  away); on the CPU its host wall time. It takes the place of JAX's
  ``jit_us``.
* ``eager_us`` — the sum of the per-op times of one call, each op
  dispatched and synchronised alone (``core.graph.timed_run``): device
  times on the card, host times on the CPU.
* ``bound_us`` — ``bytes_touched`` over ``hardware.H100.hbm_bw`` (3.35
  TB/s, the H100 SXM data sheet's memory rate): the least time an H100
  could take to move the call's inputs and outputs once, whatever device
  ran it. It takes the place of JAX's ``tpu_model_us`` (a TPU v5e model,
  not carried over).
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import time
from typing import Callable, Dict, Optional, Sequence

import torch

from repro_torch import nn
from repro_torch.kernels import ops

from .graph import Timer, _tensors, timed_run
from .hardware import H100
from .taxonomy import OpGroup


@dataclasses.dataclass
class MicroOp:
    name: str
    group: OpGroup
    make: Callable            # (shape, dtype, generator) -> (fn, args)


@dataclasses.dataclass
class MicroResult:
    name: str
    group: str
    shape: tuple
    dtype: str
    device: str               # "cuda" or "cpu": where the times were taken
    device_us: float
    eager_us: float
    bound_us: float
    bytes_touched: float


_REGISTRY: Dict[str, MicroOp] = {}


def register(name: str, group: OpGroup):
    def deco(make):
        _REGISTRY[name] = MicroOp(name=name, group=group, make=make)
        return make
    return deco


def registry() -> Dict[str, MicroOp]:
    return dict(_REGISTRY)


def _rng(gen: torch.Generator, shape, dtype):
    return torch.randn(shape, generator=gen, device=gen.device).to(dtype)


def _uniform(gen: torch.Generator, shape):
    return torch.rand(shape, generator=gen, device=gen.device)


# --- Table-2 operator suite -------------------------------------------------

@register("layer_norm", OpGroup.NORMALIZATION)
def _mk_layer_norm(shape, dtype, gen):
    x = _rng(gen, shape, dtype)
    scale = torch.ones(shape[-1], dtype=dtype, device=gen.device)
    bias = torch.zeros(shape[-1], dtype=dtype, device=gen.device)
    return (lambda x: nn.layer_norm(x, scale, bias)), (x,)


@register("rms_norm", OpGroup.NORMALIZATION)
def _mk_rms_norm(shape, dtype, gen):
    x = _rng(gen, shape, dtype)
    scale = torch.ones(shape[-1], dtype=dtype, device=gen.device)
    return (lambda x: nn.rms_norm(x, scale)), (x,)


@register("gelu", OpGroup.ACTIVATION)
def _mk_gelu(shape, dtype, gen):
    return nn.gelu, (_rng(gen, shape, dtype),)


@register("silu", OpGroup.ACTIVATION)
def _mk_silu(shape, dtype, gen):
    return nn.silu, (_rng(gen, shape, dtype),)


@register("relu", OpGroup.ACTIVATION)
def _mk_relu(shape, dtype, gen):
    return nn.relu, (_rng(gen, shape, dtype),)


@register("softmax", OpGroup.LOGIT)
def _mk_softmax(shape, dtype, gen):
    return (lambda x: nn.softmax(x, dim=-1)), (_rng(gen, shape, dtype),)


@register("add", OpGroup.ELEMENTWISE)
def _mk_add(shape, dtype, gen):
    return nn.residual_add, (_rng(gen, shape, dtype), _rng(gen, shape, dtype))


@register("mul", OpGroup.ELEMENTWISE)
def _mk_mul(shape, dtype, gen):
    return torch.mul, (_rng(gen, shape, dtype), _rng(gen, shape, dtype))


@register("true_div", OpGroup.ELEMENTWISE)
def _mk_div(shape, dtype, gen):
    x = _rng(gen, shape, dtype)
    d = x.new_full((), math.sqrt(shape[-1]), dtype=torch.float32)
    return (lambda x: x / d), (x,)


@register("neg", OpGroup.ELEMENTWISE)
def _mk_neg(shape, dtype, gen):
    return torch.neg, (_rng(gen, shape, dtype),)


@register("reshape_permute", OpGroup.MEMORY)
def _mk_reshape(shape, dtype, gen):
    x = _rng(gen, shape, dtype)

    def f(x):
        # attention-style (B, S, H*D) -> (B, H, S, D) -> back; forces a copy
        b, s, e = x.shape[0], x.shape[1], math.prod(x.shape[2:])
        h = max(1, e // 64)
        y = x.reshape(b, s, h, e // h).permute(0, 2, 1, 3)
        return y.reshape(b, h, -1) + 0.0
    return f, (x,)


@register("concat_split", OpGroup.MEMORY)
def _mk_concat(shape, dtype, gen):
    a, b = _rng(gen, shape, dtype), _rng(gen, shape, dtype)

    def f(a, b):
        c = torch.cat([a, b], dim=-1)
        lo, hi = torch.chunk(c, 2, dim=-1)
        return lo + hi
    return f, (a, b)


@register("rope", OpGroup.MEMORY)
def _mk_rope(shape, dtype, gen):
    if len(shape) < 4:
        shape = (1, max(shape[0], 1), 8, 64)
    x = _rng(gen, shape, dtype)
    pos = torch.arange(shape[1], dtype=torch.int32, device=gen.device)[None, :]
    return (lambda x: nn.apply_rope(x, pos)), (x,)


@register("cross_entropy", OpGroup.LOGIT)
def _mk_xent(shape, dtype, gen):
    if len(shape) < 2:
        shape = (64, 32000)
    logits = _rng(gen, shape, dtype)
    labels = torch.randint(0, shape[-1], shape[:-1], generator=gen,
                           device=gen.device)
    return (lambda l: nn.softmax_cross_entropy(l, labels).mean()), (logits,)


@register("nms", OpGroup.ROI)
def _mk_nms(shape, dtype, gen):
    n = shape[0] if shape else 1024
    centers = _uniform(gen, (n, 2)) * 100
    wh = _uniform(gen, (n, 2)) * 10 + 1
    boxes = torch.cat([centers - wh / 2, centers + wh / 2], -1)
    scores = _uniform(gen, (n,))
    return (lambda b, s: nn.nms(b, s, iou_threshold=0.5)), (boxes, scores)


@register("interpolate", OpGroup.INTERPOLATION)
def _mk_interp(shape, dtype, gen):
    if len(shape) != 4:
        shape = (2, 256, 64, 64)
    x = _rng(gen, shape, dtype)
    out_hw = (shape[2] * 2, shape[3] * 2)
    return (lambda x: nn.interpolate_bilinear(x, out_hw)), (x,)


@register("swiglu", OpGroup.ACTIVATION)
def _mk_swiglu(shape, dtype, gen):
    return nn.swiglu, (_rng(gen, shape, dtype), _rng(gen, shape, dtype))


# --- fused operators: unfused twins sit above so the micro table shows each
# --- chain side by side with its fused rewrite


@register("add_rms_norm", OpGroup.NORMALIZATION)
def _mk_add_rms_norm(shape, dtype, gen):
    """The unfused residual-add -> rms_norm chain as one measurable site."""
    x, r = _rng(gen, shape, dtype), _rng(gen, shape, dtype)
    scale = torch.ones(shape[-1], dtype=dtype, device=gen.device)
    return (lambda x, r: nn.add_rms_norm(x, r, scale)[0]), (x, r)


@register("fused_add_rms_norm", OpGroup.FUSED)
def _mk_fused_add_rms_norm(shape, dtype, gen):
    x, r = _rng(gen, shape, dtype), _rng(gen, shape, dtype)
    scale = torch.ones(shape[-1], dtype=dtype, device=gen.device)

    def f(x, r):
        with nn.fuse():
            return nn.add_rms_norm(x, r, scale)[0]
    return f, (x, r)


@register("fused_rope", OpGroup.FUSED)
def _mk_fused_rope(shape, dtype, gen):
    if len(shape) < 4:
        shape = (1, max(shape[0], 1), 8, 64)
    x = _rng(gen, shape, dtype)
    pos = torch.arange(shape[1], dtype=torch.int32, device=gen.device)[None, :]

    def f(x):
        with nn.fuse():
            return nn.apply_rope(x, pos)
    return f, (x,)


@register("fused_dequant_add_rms_norm", OpGroup.FUSED)
def _mk_fused_dequant_add_rms_norm(shape, dtype, gen):
    """The QDQ epilogue: int8 operand in, one pass to the normed output
    (the dequant_add_rms_norm kernel on the card)."""
    q = torch.randint(-127, 128, shape, generator=gen, device=gen.device,
                      dtype=torch.int8)
    qs = torch.full((), 0.02, dtype=torch.float32, device=gen.device)
    res = _rng(gen, shape, dtype)
    scale = torch.ones(shape[-1], dtype=dtype, device=gen.device)
    return (lambda q, res: nn.dequant_add_rms_norm(q, qs, res, scale)[0]), \
        (q, res)


# --- attention template family: one row per variant of the JAX template
# --- (kernels/attn_template.py there), each a kernel wrapper here


def _attn_maker(variant: str, window: Optional[int] = None,
                decode: bool = False):
    """Micro maker for one attention variant; ``shape`` is (batch, kv_seq,
    heads, head_dim), the decode variant one query row against the full KV
    depth."""
    def make(shape, dtype, gen):
        b, s, h, d = shape
        q = _rng(gen, (b, 1, h, d) if decode else shape, dtype)
        k = _rng(gen, (b, s, h, d), dtype)
        v = _rng(gen, (b, s, h, d), dtype)
        if decode:
            lengths = torch.full((b,), s, dtype=torch.int32, device=gen.device)
            return ops.decode_core, (q, k, v, lengths)
        if window is not None:
            return (lambda q, k, v: ops.attention_window(q, k, v, window)), \
                (q, k, v)
        fn = ops.attention_core if variant == "causal" else ops.attention_full
        return fn, (q, k, v)
    return make


for _name, _variant, _kw in (
        ("attn_template:causal:d64", "causal", {}),
        ("attn_template:causal:d128", "causal", {}),
        ("attn_template:full:d64", "full", {}),
        ("attn_template:full:d128", "full", {}),
        ("attn_template:window64:d64", "window", {"window": 64}),
        ("attn_template:window256:d64", "window", {"window": 256}),
        ("attn_template:decode:d64", "decode", {"decode": True}),
        ("attn_template:decode:d128", "decode", {"decode": True}),
):
    register(_name, OpGroup.FUSED)(_attn_maker(_variant, **_kw))
del _name, _variant, _kw


#: Paper Table 2 example shapes (a copy of ``repro.core.microbench``'s,
#: pinned equal to it by the tests).
TABLE2_SHAPES: Dict[str, tuple] = {
    "relu": (2, 64, 533),
    "gelu": (1, 8, 6400),          # GPT2-XL row
    "silu": (1, 10, 11008),        # Llama-2 row
    "layer_norm": (2, 16384, 32),  # Segformer row
    "rms_norm": (1, 10, 4096),     # LlamaRMSNorm row
    "add": (2, 16384, 32),
    "mul": (1, 10, 11008),
    "neg": (1, 32, 10, 64),
    "true_div": (2, 1, 16384, 256),
    "reshape_permute": (1, 8, 1600),
    "concat_split": (1, 8, 2400),
    "softmax": (2, 1, 16384, 256),
    "nms": (4663, 4),
    "interpolate": (2, 256, 64, 64),
    "rope": (1, 128, 32, 128),
    "cross_entropy": (256, 32000),
    "swiglu": (1, 10, 11008),
    # fused operators next to their unfused twins
    "add_rms_norm": (1, 10, 4096),
    "fused_add_rms_norm": (1, 10, 4096),
    "fused_rope": (1, 128, 32, 128),
    "fused_dequant_add_rms_norm": (1, 10, 4096),
    # attention variants: (batch, kv_seq, heads, head_dim)
    "attn_template:causal:d64": (1, 256, 8, 64),
    "attn_template:causal:d128": (1, 256, 8, 128),
    "attn_template:full:d64": (1, 256, 8, 64),
    "attn_template:full:d128": (1, 256, 8, 128),
    "attn_template:window64:d64": (1, 512, 8, 64),
    "attn_template:window256:d64": (1, 512, 8, 64),
    "attn_template:decode:d64": (4, 512, 8, 64),
    "attn_template:decode:d128": (4, 512, 8, 128),
}


def io_bytes(args, out) -> float:
    """Bytes of every tensor among the inputs and the outputs, each once."""
    return float(sum(t.numel() * t.element_size()
                     for t in _tensors((args, out))))


def _host_us(fn, args, repeats: int) -> float:
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args)
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e6


def run_micro(name: str, shape: Optional[tuple] = None,
              dtype: str = "float32", repeats: int = 20,
              device: str = "cuda", measure_eager: bool = True,
              timer: Optional[Timer] = None) -> MicroResult:
    """One Table-2 row on ``device`` (the card unless the caller asks for
    the CPU); ``timer`` is reused across rows on the card."""
    op = _REGISTRY[name]
    shape = tuple(shape or TABLE2_SHAPES.get(name, (1, 1024, 1024)))
    dev = torch.device(device)
    gen = torch.Generator(dev).manual_seed(0)
    fn, args = op.make(shape, getattr(torch, dtype), gen)
    out = fn(*args)
    if dev.type == "cuda":
        timer = timer or Timer(iters=repeats)
        device_us = timer(lambda: fn(*args)) * 1e3
    else:
        device_us = _host_us(fn, args, repeats)
    eager_us = 0.0
    if measure_eager:
        _, ops = timed_run(fn, *args, repeats=3)
        eager_us = 1e6 * sum(t.seconds for t in ops)
    nbytes = io_bytes(args, out)
    return MicroResult(name=name, group=op.group.value, shape=shape,
                       dtype=dtype, device=dev.type, device_us=device_us,
                       eager_us=eager_us,
                       bound_us=1e6 * nbytes / H100.hbm_bw,
                       bytes_touched=nbytes)


def run_suite(names: Optional[Sequence[str]] = None, repeats: int = 10,
              device: str = "cuda") -> list:
    names = list(names or TABLE2_SHAPES.keys())
    timer = Timer(iters=repeats) if torch.device(device).type == "cuda" \
        else None
    return [run_micro(n, repeats=repeats, device=device, timer=timer)
            for n in names]
