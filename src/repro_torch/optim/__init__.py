"""Optimizer substrate: AdamW, cosine schedule, global-norm clipping, and
int8 error-feedback gradient compression.

The port of ``repro.optim`` on dicts (and lists) of tensors, the port's
param trees: every function maps over the leaves in the tree's order, and
a state's moments have their parameters' structure and shapes, in f32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    end_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # int8 error-feedback compression of the cross-pod gradient all-reduce
    compress_grads: bool = False


class OptState(NamedTuple):
    step: torch.Tensor        # int32 scalar
    mu: Any                   # first moment (a tree like params)
    nu: Any                   # second moment
    err: Optional[Any] = None  # error-feedback residual (if compressing)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and of trees of its structure,
    ``rest``): dicts, lists and tuples are structure, None stays None,
    anything else is a leaf. A NamedTuple keeps its type."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def cosine_schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then a cosine to ``end_lr_frac`` of it
    at ``total_steps``; f32, on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.end_lr_frac + (1 - cfg.end_lr_frac) * cos
    return cfg.peak_lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


# ---------------------------------------------------------------------------
# int8 error-feedback gradient compression
# ---------------------------------------------------------------------------
# JAX uses it on the cross-pod hop of a hierarchical gradient reduction: the
# pod-level partial sum is quantized to int8 with a per-tensor scale,
# exchanged, and dequantized; the quantization error is carried in an
# accumulator and re-injected into the next step's gradient. On one card
# there is no such hop: the pair expresses the same numerics.

def quantize_int8(x) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    scale = torch.clamp(torch.amax(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale) -> torch.Tensor:
    return q.float() * scale


def compress_decompress(g, err):
    """One error-feedback round: ``(g_hat, new_err)``, ``g_hat =
    Q^-1(Q(g + err))`` in g's dtype and ``new_err = (g + err) - g_hat``."""
    gf = g.float() + err
    q, scale = quantize_int8(gf)
    g_hat = dequantize_int8(q, scale)
    return g_hat.to(g.dtype), gf - g_hat


def apply_error_feedback(grads, err_tree):
    pairs = tree_map(compress_decompress, grads, err_tree)
    return _unzip(pairs, 0, grads), _unzip(pairs, 1, grads)


def _unzip(pairs, i: int, like):
    """Element ``i`` of each pair-leaf of ``pairs`` (built by
    :func:`tree_map` over ``like``), in ``like``'s structure."""
    if isinstance(like, dict):
        return {k: _unzip(pairs[k], i, v) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        out = [_unzip(pairs[j], i, v) for j, v in enumerate(like)]
        return type(like)(out) if isinstance(like, tuple) else out
    return pairs[i]


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _is_matrix(p) -> bool:
    return p.ndim >= 2


def init_opt_state(params, cfg: OptimizerConfig) -> OptState:
    """Zero f32 moments (and residual, compressing) of the params' shapes,
    on their devices; step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                    err=tree_map(zeros, params) if cfg.compress_grads
                    else None)


def adamw_update(grads, state: OptState, params,
                 cfg: OptimizerConfig) -> Tuple[Any, OptState, dict]:
    """One AdamW step. Returns ``(new_params, new_state, {"lr",
    "grad_norm"})``: the (compressed,) clipped gradient, bias-corrected
    moments in f32, weight decay on matrices (ndim >= 2) only; new params
    in their own dtypes."""
    err = state.err
    if cfg.compress_grads:
        grads, err = apply_error_feedback(grads, err)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = cosine_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    c1 = 1 - b1 ** stepf
    c2 = 1 - b2 ** stepf

    def upd(g, m, v, p):
        gf = g.float()
        m_new = b1 * m + (1 - b1) * gf
        v_new = b2 * v + (1 - b2) * torch.square(gf)
        delta = (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps)
        if cfg.weight_decay and _is_matrix(p):
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m_new, v_new

    triples = tree_map(upd, grads, state.mu, state.nu, params)
    new_state = OptState(step=step, mu=_unzip(triples, 1, params),
                         nu=_unzip(triples, 2, params), err=err)
    return (_unzip(triples, 0, params), new_state,
            {"lr": lr, "grad_norm": gnorm})
