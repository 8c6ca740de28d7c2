"""repro_torch.nn — scope-tagged operator library (the dense-LM slice).

Every semantic operator runs under a tag ``ng:<group>:<name>`` pushed on a
tag stack, with an inner per-invocation ``c<N>`` marker, as
``repro.nn.tagged`` does with ``jax.named_scope``. The capture and the
timed profile (``repro_torch.core.graph``) read the stack to attribute each
aten op to the paper's operator groups.

A backend switch selects the implementation of the kernel-backed ops
(``rms_norm``, ``swiglu``, prefill and decode attention):

    None    (default) the hand-written kernels for CUDA tensors, the plain
            PyTorch code for CPU tensors
    "torch" plain PyTorch code on every device (on the card: the yardstick
            ``chip_smoke.py`` holds the kernel path against)
    "cuda"  the kernel wrappers (``repro_torch.kernels.ops``) on every
            device; for a CPU tensor a wrapper takes its plain version,
            which is how the CPU tests reach the wrappers
"""

from __future__ import annotations

import contextlib
import functools
import itertools
from typing import List, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.taxonomy import OpGroup, scope_tag
from repro_torch.kernels import ref

BACKENDS = ("torch", "cuda")

_BACKEND: Optional[str] = None


def set_backend(name: Optional[str]) -> None:
    global _BACKEND
    if name is not None and name not in BACKENDS:
        raise ValueError(f"unknown nn backend {name!r}; known: {BACKENDS}")
    _BACKEND = name


def get_backend() -> Optional[str]:
    return _BACKEND


@contextlib.contextmanager
def backend(name: Optional[str]):
    prev = get_backend()
    set_backend(name)
    try:
        yield
    finally:
        set_backend(prev)


def use_kernels(x: torch.Tensor) -> bool:
    """Whether a kernel-backed op on ``x`` goes through the kernel wrappers."""
    return _BACKEND == "cuda" or (_BACKEND is None and x.is_cuda)


def _kernels():
    from repro_torch.kernels import ops as kops
    return kops


# ---------------------------------------------------------------------------
# the tag stack
# ---------------------------------------------------------------------------

#: scope tags of the ops now running, outermost first
_TAGS: List[str] = []
#: monotone per-process invocation counter for tagged ops
_CALLS = itertools.count()


def scope_path() -> str:
    """The current tag stack as a ``/``-joined scope path."""
    return "/".join(_TAGS)


@contextlib.contextmanager
def scope(group: OpGroup, name: str):
    """Run a block under one ``ng:`` tag (no ``c<N>`` marker), as the JAX
    models' inline ``jax.named_scope(nn.scope_tag(...))`` blocks do."""
    _TAGS.append(scope_tag(group, name))
    try:
        yield
    finally:
        _TAGS.pop()


def tagged(group: OpGroup, name: str):
    """Decorator: run the op body under its ``ng:`` tag.

    An inner ``c<N>`` marker makes every invocation distinct in the scope
    path, so back-to-back calls of one op (rope on q, then on k) stay two
    sites runs. The marker carries no ``ng:`` tag, so classification is
    unaffected.
    """
    tag = scope_tag(group, name)

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            _TAGS.append(tag)
            _TAGS.append(f"c{next(_CALLS)}")
            try:
                return fn(*args, **kwargs)
            finally:
                del _TAGS[-2:]
        wrapper.op_group = group
        wrapper.op_tag = tag
        return wrapper
    return deco


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

@tagged(OpGroup.NORMALIZATION, "rms_norm")
def rms_norm(x, scale, eps: float = 1e-6, zero_centered: bool = False):
    if use_kernels(x):
        return _kernels().rms_norm(x, scale, eps=eps,
                                   zero_centered=zero_centered)
    return ref.rms_norm(x, scale, eps=eps, zero_centered=zero_centered)


def add_rms_norm(x, residual, scale, eps: float = 1e-6,
                 zero_centered: bool = False):
    """``(rms_norm(x + residual), x + residual)`` — the pre-norm boundary,
    unfused: a residual_add op followed by an rms_norm op."""
    r = residual_add(x, residual)
    return rms_norm(r, scale, eps=eps, zero_centered=zero_centered), r


# ---------------------------------------------------------------------------
# Activation
# ---------------------------------------------------------------------------

@tagged(OpGroup.ACTIVATION, "silu")
def silu(x):
    return x * torch.sigmoid(x)


@tagged(OpGroup.ACTIVATION, "swiglu")
def swiglu(gate, up):
    """SiLU(gate) * up — fused Activation + Elem-wise mul."""
    if use_kernels(gate):
        return _kernels().swiglu(gate, up)
    return (gate * torch.sigmoid(gate.float()).to(gate.dtype)) * up


# ---------------------------------------------------------------------------
# Logit computation
# ---------------------------------------------------------------------------

@tagged(OpGroup.LOGIT, "softmax")
def softmax(x, dim: int = -1):
    xf = x.float()
    m = torch.amax(xf, dim=dim, keepdim=True)
    e = torch.exp(xf - m)
    return (e / torch.sum(e, dim=dim, keepdim=True)).to(x.dtype)


# ---------------------------------------------------------------------------
# Memory
# ---------------------------------------------------------------------------

@tagged(OpGroup.MEMORY, "split_heads")
def split_heads(x, n_heads: int):
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, -1)


@tagged(OpGroup.MEMORY, "merge_heads")
def merge_heads(x):
    b, s, h, d = x.shape
    return x.reshape(b, s, h * d)


@tagged(OpGroup.MEMORY, "embedding_lookup")
def embedding_lookup(table, ids):
    return F.embedding(ids, table)


@tagged(OpGroup.MEMORY, "kv_cache_update")
def kv_cache_update(cache, new, index):
    """Write ``new`` (B, S, ...) into ``cache`` (B, T, ...) at ``index``,
    in place, and return ``cache``.

    ``index`` is a Python int or a 0-d tensor (every row writes at the
    same position) or a per-row ``(B,)`` tensor (continuous batching).
    JAX's ``dynamic_update_slice`` clamps an out-of-range start and
    silently overwrites the edge rows; here a start outside
    ``[0, T - S]`` raises instead: at once for a host index, and through a
    device-side assert for an index on the card (no host sync).

    In place because the cache is the largest tensor of a serving step: the
    JAX engine donates it for the same reason.
    """
    b, s = new.shape[:2]
    limit = cache.shape[1] - s
    new = new.to(cache.dtype)
    if isinstance(index, int) or (torch.is_tensor(index) and index.dim() == 0
                                  and not index.is_cuda):
        i = int(index)
        if not 0 <= i <= limit:
            raise ValueError(f"kv_cache_update index {i} outside [0, {limit}]")
        cache[:, i:i + s] = new
        return cache
    index = torch.as_tensor(index, device=cache.device)
    if index.dim() == 0:
        index = index.expand(b)
    if index.shape != (b,):
        raise ValueError(f"kv_cache_update index must be scalar or ({b},), "
                         f"got {tuple(index.shape)}")
    in_range = ((index >= 0) & (index <= limit)).all()
    if index.is_cuda:
        torch._assert_async(in_range, f"kv_cache_update index outside [0, {limit}]")
    elif not bool(in_range):
        raise ValueError(f"kv_cache_update index {index.tolist()} outside "
                         f"[0, {limit}]")
    rows = torch.arange(b, device=cache.device)[:, None]
    cols = index.long()[:, None] + torch.arange(s, device=cache.device)[None]
    cache[rows, cols] = new
    return cache


@tagged(OpGroup.MEMORY, "apply_rope")
def apply_rope(x, positions, base: float = 10000.0, fraction: float = 1.0):
    """Rotary embedding on (B, S, H, D); optionally on a leading fraction."""
    d = x.shape[-1]
    rot = int(d * fraction) // 2 * 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    freq = base ** (-torch.arange(0, half, dtype=torch.float32,
                                  device=x.device) / half)
    theta = positions[..., None].float() * freq                # (B,S,half)
    cos = torch.cos(theta)[:, :, None, :]
    sin = torch.sin(theta)[:, :, None, :]
    x1, x2 = x_rot[..., :half].float(), x_rot[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1) \
        if rot < d else out.to(x.dtype)


# ---------------------------------------------------------------------------
# Element-wise arithmetic
# ---------------------------------------------------------------------------

@tagged(OpGroup.ELEMENTWISE, "residual_add")
def residual_add(x, y):
    return x + y


@tagged(OpGroup.ELEMENTWISE, "scale")
def scale(x, factor):
    return x * factor


# ---------------------------------------------------------------------------
# GEMM sites (tagged so attribution is exact, not heuristic). The large
# products stay torch.matmul, as the JAX package leaves them to XLA.
# ---------------------------------------------------------------------------

@tagged(OpGroup.GEMM, "linear")
def linear(x, w, b=None):
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


@tagged(OpGroup.GEMM, "einsum")
def einsum(spec: str, *operands):
    return torch.einsum(spec, *operands)
