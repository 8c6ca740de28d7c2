"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The port of ``repro.models.recurrent``. The temporal mixer is: x ->
[branch A: linear -> causal conv1d (width 4) -> RG-LRU] * [branch B:
linear -> GeLU] -> linear out.

RG-LRU recurrence (per channel):
    r_t = sigmoid(W_a x_t + b_a)            recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            input gate
    a_t = exp(c * softplus(lam) * (-r_t))   in (0, 1), c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * x_t)

A prompt runs the recurrence as a parallel scan of the (a, b) pairs of
``h = a h + b``, by the algorithm of ``jax.lax.associative_scan`` (the
odd/even recursion: pairs combined, the half-length scan recursed, the
even outputs from the odd ones), so it takes O(log S) tensor operations
over the sequence axis and combines in JAX's order. Decode carries the
state ``h`` (f32) and the conv's last ``conv_width - 1`` inputs, a fixed
size, and writes both in place into the cache it is given: the engines'
decode step is a captured CUDA graph that replays against those tensors.

Everything here is NonGEMM but the five projections: the gates under
``rglru_gates`` (Activation), the scan under ``rglru_scan``
(Element-wise), the conv's shifted adds under ``causal_conv1d``
(Memory), each the JAX package's tag. The scan has no Pallas kernel in
the JAX package, so it stays plain PyTorch on the card too.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch import nn
from repro_torch.core.taxonomy import OpGroup
from repro_torch.models.common import ModelConfig, dense_init

_C = 8.0


def init_recurrent(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """The mixer's params, with the JAX package's leaves and shapes."""
    d = cfg.d_model
    w = cfg.lru_width or d
    pd, dev = cfg.torch_param_dtype, generator.device
    # lam so that a = exp(-c * softplus(lam) * r) spans useful timescales
    lam = torch.empty((w,), dtype=torch.float32, device=dev)
    lam.uniform_(0.001, 0.1, generator=generator)
    lam = torch.log(torch.expm1(-torch.log(lam) / _C))   # inverse softplus
    return {
        "w_in": dense_init(generator, (d, w), dtype=pd),
        "w_gate_branch": dense_init(generator, (d, w), dtype=pd),
        "w_out": dense_init(generator, (w, d), dtype=pd),
        "conv_w": dense_init(generator, (cfg.conv_width, w), dtype=pd),
        "conv_b": torch.zeros((w,), dtype=pd, device=dev),
        "w_a": dense_init(generator, (w, w), dtype=pd),
        "b_a": torch.zeros((w,), dtype=pd, device=dev),
        "w_x": dense_init(generator, (w, w), dtype=pd),
        "b_x": torch.zeros((w,), dtype=pd, device=dev),
        "lam": lam.to(pd),
    }


def _causal_conv1d(x, w, b):
    """Depthwise causal conv: x (B, S, W), w (K, W), as K shifted adds in
    x's dtype."""
    with nn.scope(OpGroup.MEMORY, "causal_conv1d"):
        k = w.shape[0]
        out = x * w[-1].to(x.dtype)
        for i in range(1, k):
            shifted = F.pad(x, (0, 0, i, 0))[:, :x.shape[1]]
            out = out + shifted * w[-1 - i].to(x.dtype)
        return out + b.to(x.dtype)


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _rglru_coeffs(params, x):
    """Per-step (a, b) of the linear recurrence h = a h + b, in f32.
    x: (..., W)."""
    with nn.scope(OpGroup.ACTIVATION, "rglru_gates"):
        r = torch.sigmoid(nn.linear(x, params["w_a"].to(x.dtype)).float()
                          + params["b_a"].float())
        i = torch.sigmoid(nn.linear(x, params["w_x"].to(x.dtype)).float()
                          + params["b_x"].float())
    log_a = -_C * _softplus(params["lam"].float()) * r
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = mult * (i * x.float())
    return a, b


def _combine(c1: List[torch.Tensor], c2: List[torch.Tensor]):
    """(a1, b1) then (a2, b2): h -> a2 (a1 h + b1) + b2."""
    (a1, b1), (a2, b2) = c1, c2
    return [a1 * a2, a2 * b1 + b2]


def associative_scan(fn: Callable, elems: List[torch.Tensor],
                     dim: int = 1) -> List[torch.Tensor]:
    """Inclusive scan of the associative ``fn`` over ``dim`` of every
    tensor of ``elems``, by ``jax.lax.associative_scan``'s recursion: the
    adjacent pairs combined, the half-length scan of them recursed (the
    odd outputs), each even output the odd one before it combined with
    its own element, the two interleaved. Log-depth in the length."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def take(e, start, stop=None, step=1):
        idx = [slice(None)] * e.dim()
        idx[dim] = slice(start, stop, step)
        return e[tuple(idx)]

    odd = associative_scan(
        fn, fn([take(e, 0, -1, 2) for e in elems],
               [take(e, 1, None, 2) for e in elems]), dim)
    if n % 2 == 0:
        even = fn([take(o, 0, -1) for o in odd],
                  [take(e, 2, None, 2) for e in elems])
    else:
        even = fn(odd, [take(e, 2, None, 2) for e in elems])
    out = []
    for e, ev, od in zip(elems, even, odd):
        r = torch.empty_like(e)
        take(r, 0, 1).copy_(take(e, 0, 1))      # the first element as it is
        take(r, 2, None, 2).copy_(ev)
        take(r, 1, None, 2).copy_(od)
        out.append(r)
    return out


def _scan(a, b):
    """h_t of the (a, b) pairs over the sequence axis, in f32."""
    with nn.scope(OpGroup.ELEMENTWISE, "rglru_scan"):
        return associative_scan(_combine, [a, b], dim=1)[1]


def rglru_scan(params, x):
    """Parallel RG-LRU over (B, S, W), in x's dtype."""
    a, b = _rglru_coeffs(params, x)
    return _scan(a, b).to(x.dtype)


def rglru_step(params, x_t, h_prev):
    """One decode step. x_t: (B, 1, W); h_prev: (B, W) f32 -> (the output
    (B, 1, W) in x_t's dtype, the new state (B, W) f32)."""
    a, b = _rglru_coeffs(params, x_t)
    h = a[:, 0] * h_prev + b[:, 0]
    return h.to(x_t.dtype)[:, None, :], h


def _branches(params, x):
    """(u, g): the recurrence branch's input projection and the GeLU gate
    branch."""
    u = nn.linear(x, params["w_in"].to(x.dtype))
    g = nn.gelu(nn.linear(x, params["w_gate_branch"].to(x.dtype)))
    return u, g


def recurrent_forward(params, x, cfg: ModelConfig):
    """Full-sequence Griffin recurrent mixer. x: (B, S, D)."""
    u, g = _branches(params, x)
    u = _causal_conv1d(u, params["conv_w"], params["conv_b"])
    h = rglru_scan(params, u)
    return nn.linear(h * g, params["w_out"].to(x.dtype))


def _conv_tail(u, cfg: ModelConfig):
    """The last ``conv_width - 1`` rows of the conv's input stream ``u``
    (B, S, W) in the activation dtype, left zero-padded where the prompt is
    shorter (the conv sees zeros before the first token)."""
    kw = cfg.conv_width - 1
    tail = u[:, -kw:]
    tail = F.pad(tail, (0, 0, kw - tail.shape[1], 0))
    return tail.to(cfg.activation_dtype).contiguous()


def recurrent_prefill(params, x, cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """Full-sequence forward that also returns the decode state: the final
    RG-LRU state (f32) and the last ``conv_width - 1`` conv inputs, left
    zero-padded where the prompt is shorter (the conv sees zeros before
    the first token). Every token of ``x`` enters the state: the caller
    prefills the exact prompt, unpadded."""
    u, g = _branches(params, x)
    u_c = _causal_conv1d(u, params["conv_w"], params["conv_b"])
    a, b = _rglru_coeffs(params, u_c)
    h_f32 = _scan(a, b)
    y = nn.linear(h_f32.to(x.dtype) * g, params["w_out"].to(x.dtype))
    cache = {"h": h_f32[:, -1].contiguous(), "conv": _conv_tail(u, cfg)}
    return y, cache


def init_recurrent_cache(cfg: ModelConfig, batch: int, device="cuda") -> dict:
    w = cfg.lru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, w),
                            dtype=cfg.activation_dtype, device=device),
    }


def recurrent_decode(params, x, cfg: ModelConfig, cache: dict,
                     pos) -> Tuple[torch.Tensor, dict]:
    """One-token Griffin step. x: (B, 1, D). ``h`` and ``conv`` are
    written in place (``copy_``) and the same dict is returned."""
    del pos
    u, g = _branches(params, x)
    # the conv over the (K-1)-tail and the current input: the JAX
    # package's einsum, accumulated in f32
    window = torch.cat([cache["conv"], u], dim=1)                 # (B, K, W)
    u_c = (window.float() * params["conv_w"].to(x.dtype).float()).sum(1)
    u_c = u_c.to(x.dtype)[:, None, :] + params["conv_b"].to(x.dtype)
    h_out, h_new = rglru_step(params, u_c, cache["h"])
    y = nn.linear(h_out * g, params["w_out"].to(x.dtype))
    cache["h"].copy_(h_new)
    cache["conv"].copy_(window[:, 1:])
    return y, cache
