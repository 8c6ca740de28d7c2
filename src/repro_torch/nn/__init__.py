"""repro_torch.nn — scope-tagged operator library (dense LMs, encoders,
vision).

Every semantic operator runs under a tag ``ng:<group>:<name>`` pushed on a
tag stack, with an inner per-invocation ``c<N>`` marker, as
``repro.nn.tagged`` does with ``jax.named_scope``. The capture and the
timed profile (``repro_torch.core.graph``) read the stack to attribute each
aten op to the paper's operator groups.

A backend switch selects the implementation of the kernel-backed ops
(the norms, ``swiglu``, the fused ops, prefill and decode attention,
``nms``; unfused ``geglu`` is the plain op chain on every backend, as in
the JAX package):

    None    (default) the hand-written kernels for CUDA tensors, the plain
            PyTorch code for CPU tensors
    "torch" plain PyTorch code on every device (on the card: the yardstick
            ``chip_smoke.py`` holds the kernel path against)
    "cuda"  the kernel wrappers (``repro_torch.kernels.ops``) on every
            device; for a CPU tensor a wrapper takes its plain version,
            which is how the CPU tests reach the wrappers

A second, orthogonal switch, :func:`fuse` (``repro.nn.fuse``), routes the
fusable call sites through single fused operators tagged
``ng:fused:<name>``: ``add_rms_norm`` / ``add_layer_norm`` (residual add +
the norm after it), ``swiglu``, ``geglu``, ``apply_rope`` and the decode
attention
(``fused_attn_decode``). On the kernel backend each fused op is one kernel
launch; on the plain backend the same fused math runs untagged under the
fused tag (the ``kernels/ref.py`` twins), so both attribute it to the
``fused`` group.

A third switch, :func:`fake_quant` (``repro.nn.fake_quant``, the paper's
§4.4 QDQ setting), round-trips both operands of every tagged GEMM site
(``linear``, ``einsum``, ``conv2d``) through symmetric per-tensor int8
(``quantize_int8`` then ``dequantize_int8``; under :func:`fuse` one
``_fused_qdq`` op), with the JAX package's arithmetic: a true division by
the scale, round half to even, clamp to [-127, 127]. The attention
products are no ``nn.einsum`` and stay free of QDQ, as in JAX.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
from typing import List, Optional, Tuple

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


#: process-global fusion switch: while True, the fusable call sites emit
#: single fused operators under ``ng:fused:`` tags instead of their unfused
#: op chains
_FUSION = False


def set_fusion(enabled: bool) -> None:
    global _FUSION
    _FUSION = bool(enabled)


def fusion_enabled() -> bool:
    return _FUSION


@contextlib.contextmanager
def fuse(enabled: bool = True):
    prev = fusion_enabled()
    set_fusion(enabled)
    try:
        yield
    finally:
        set_fusion(prev)


#: process-global fake-quant switch (None | "int8"): while set, every
#: tagged GEMM site wraps its operands in simulated quantize/dequantize ops
_FAKE_QUANT: Optional[str] = None

_QUANT_MODES = ("int8",)


def set_fake_quant(mode: Optional[str]) -> None:
    global _FAKE_QUANT
    if mode is not None and mode not in _QUANT_MODES:
        raise ValueError(f"unknown fake-quant mode {mode!r}; "
                         f"known: {_QUANT_MODES}")
    _FAKE_QUANT = mode


def get_fake_quant() -> Optional[str]:
    return _FAKE_QUANT


@contextlib.contextmanager
def fake_quant(mode: Optional[str] = "int8"):
    prev = get_fake_quant()
    set_fake_quant(mode)
    try:
        yield
    finally:
        set_fake_quant(prev)


#: debug-mode bounds checking of the paged KV ops' block ids and positions
#: (``repro.nn.debug_bounds``). Off, a bad block table or position is left
#: to torch's own indexing checks; on, each op checks its indices first: on
#: the CPU it raises, on the card through a device-side assert (no host
#: sync). ``kv_cache_update`` checks its index whatever this says.
_DEBUG_BOUNDS = False


def set_debug_bounds(enabled: bool) -> None:
    global _DEBUG_BOUNDS
    _DEBUG_BOUNDS = bool(enabled)


def debug_bounds_enabled() -> bool:
    return _DEBUG_BOUNDS


@contextlib.contextmanager
def debug_bounds(enabled: bool = True):
    prev = debug_bounds_enabled()
    set_debug_bounds(enabled)
    try:
        yield
    finally:
        set_debug_bounds(prev)


def _assert_in_range(ok: torch.Tensor, what: str) -> None:
    """Fail where the bool tensor ``ok`` has a False: a device-side assert
    for a CUDA tensor (no host sync), a ValueError on the CPU."""
    ok = ok.all()
    if ok.is_cuda:
        torch._assert_async(ok, what)
    elif not bool(ok):
        raise ValueError(what)


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

@tagged(OpGroup.NORMALIZATION, "layer_norm")
def layer_norm(x, scale, bias, eps: float = 1e-5):
    if use_kernels(x):
        return _kernels().layer_norm(x, scale, bias, eps=eps)
    return ref.layer_norm(x, scale, bias, eps=eps)


@tagged(OpGroup.NORMALIZATION, "rms_norm")
def rms_norm(x, scale, eps: float = 1e-6, zero_centered: bool = False):
    if use_kernels(x):
        return _kernels().rms_norm(x, scale, eps=eps,
                                   zero_centered=zero_centered)
    return ref.rms_norm(x, scale, eps=eps, zero_centered=zero_centered)


@tagged(OpGroup.NORMALIZATION, "fused_add_rms_norm")
def fused_add_rms_norm(x, residual, scale, eps: float = 1e-6,
                       zero_centered: bool = False):
    """residual += x; y = rms_norm(residual) — one kernel on the card."""
    if use_kernels(x):
        return _kernels().fused_add_rms_norm(x, residual, scale, eps=eps,
                                             zero_centered=zero_centered)
    r = (x.float() + residual.float()).to(x.dtype)
    return rms_norm(r, scale, eps=eps, zero_centered=zero_centered), r


# ---------------------------------------------------------------------------
# Activation
# ---------------------------------------------------------------------------

@tagged(OpGroup.ACTIVATION, "relu")
def relu(x):
    return torch.relu(x)


@tagged(OpGroup.ACTIVATION, "gelu")
def gelu(x):
    """GELU, tanh approximation (``repro.nn.gelu``'s default)."""
    return F.gelu(x, approximate="tanh")


@tagged(OpGroup.ACTIVATION, "silu")
def silu(x):
    return x * torch.sigmoid(x)


@tagged(OpGroup.ACTIVATION, "sigmoid")
def sigmoid(x):
    """Plain sigmoid in f32 (detection class scores)."""
    return torch.sigmoid(x.float()).to(x.dtype)


@tagged(OpGroup.ACTIVATION, "swiglu")
def swiglu(gate, up):
    """SiLU(gate) * up — fused Activation + Elem-wise mul."""
    if _FUSION:
        return _fused_swiglu(gate, up)
    if use_kernels(gate):
        return _kernels().swiglu(gate, up)
    return (gate * torch.sigmoid(gate.float()).to(gate.dtype)) * up


@tagged(OpGroup.ACTIVATION, "geglu")
def geglu(gate, up):
    """GELU-tanh(gate) * up in the gate's dtype. Unfused it is the plain op
    chain on every backend (the JAX package's unfused ``geglu`` reaches no
    kernel); under :func:`fuse`, one fused operator (the geglu kernel on
    the card)."""
    if _FUSION:
        return _fused_geglu(gate, up)
    return F.gelu(gate, approximate="tanh") * up


# ---------------------------------------------------------------------------
# Logit computation
# ---------------------------------------------------------------------------

@tagged(OpGroup.LOGIT, "softmax")
def softmax(x, dim: int = -1):
    xf = x.float()
    m = torch.amax(xf, dim=dim, keepdim=True)
    e = torch.exp(xf - m)
    return (e / torch.sum(e, dim=dim, keepdim=True)).to(x.dtype)


@tagged(OpGroup.LOGIT, "softmax_cross_entropy")
def softmax_cross_entropy(logits, labels):
    """Per-position CE, logits (..., V) in f32, integer labels (...): the
    plain chain on every backend, as ``repro.nn.softmax_cross_entropy``
    (the softmax_xent kernel is reached only through
    ``kernels.ops.softmax_xent``, as the JAX package reaches its own)."""
    lf = logits.float()
    m = torch.amax(lf, dim=-1, keepdim=True)
    lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m.squeeze(-1)
    label_logit = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return lse - label_logit


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
    _assert_in_range((index >= 0) & (index <= limit),
                     f"kv_cache_update index outside [0, {limit}]")
    rows = torch.arange(b, device=cache.device)[:, None]
    cols = index.long()[:, None] + torch.arange(s, device=cache.device)[None]
    cache[rows, cols] = new
    return cache


def _check_blocks(pool, block_ids, op: str) -> None:
    n = pool.shape[0]
    _assert_in_range((block_ids >= 0) & (block_ids < n),
                     f"{op}: a block id outside [0, {n})")


@tagged(OpGroup.MEMORY, "paged_kv_gather")
def paged_kv_gather(pool, block_table, max_len: int):
    """Gather paged KV blocks into a contiguous (B, max_len, ...) view.

    ``pool`` is (N, bs, ...): N blocks of bs positions each;
    ``block_table`` (B, nb) int maps each sequence's logical blocks to pool
    block ids (0 = the reserved scratch block). The view feeds the
    unchanged contiguous-cache decode path, which is what makes the paged
    engine bit-identical to the contiguous one. It is contiguous, so the
    decode kernel takes it.
    """
    if _DEBUG_BOUNDS:
        _check_blocks(pool, block_table, "paged_kv_gather")
    return ref.paged_kv_gather(pool, block_table, max_len)


@tagged(OpGroup.MEMORY, "paged_kv_write")
def paged_kv_write(pool, new, block_table, index):
    """Scatter one decode row per sequence into its paged block, in place.

    ``new`` is (B, 1, ...); ``index`` (B,) is each sequence's position. Row
    ``b`` lands in pool block ``block_table[b, index[b] // bs]`` at offset
    ``index[b] % bs``. Sequences whose table slot is 0 write the reserved
    scratch block (dead and prefilling slots stay harmless). Returns
    ``pool``.
    """
    if _DEBUG_BOUNDS:
        bs, nb = pool.shape[1], block_table.shape[1]
        index = torch.as_tensor(index, device=pool.device)
        _assert_in_range((index >= 0) & (index < nb * bs),
                         f"paged_kv_write: a position outside [0, {nb * bs})")
        _check_blocks(pool, block_table, "paged_kv_write")
    return ref.paged_kv_write(pool, new, block_table, index)


@tagged(OpGroup.MEMORY, "paged_kv_scatter")
def paged_kv_scatter(pool, rows, block_table, start, lo, hi):
    """Scatter a prefill chunk (R, ...) at positions start + arange(R) of
    one sequence's (nb,) table row, in place; returns ``pool``.

    Positions outside [lo, hi) (the left overlap with already-cached prefix
    blocks, the right padding past the prompt) divert to the reserved
    scratch block 0, so chunk buckets never need to match the prompt length
    exactly. Several rows may land on one slot of block 0; which one stays
    is unspecified, and no unmasked read ever touches it.
    """
    if _DEBUG_BOUNDS:
        bs, nb = pool.shape[1], block_table.shape[0]
        idx = start + torch.arange(rows.shape[0], device=pool.device)
        kept = (idx >= lo) & (idx < hi)
        _assert_in_range(~kept | ((idx >= 0) & (idx < nb * bs)),
                         f"paged_kv_scatter: a kept position outside "
                         f"[0, {nb * bs})")
        _check_blocks(pool, block_table, "paged_kv_scatter")
    return ref.paged_kv_scatter(pool, rows, block_table, start, lo, hi)


@tagged(OpGroup.MEMORY, "apply_rope")
def apply_rope(x, positions, base: float = 10000.0, fraction: float = 1.0):
    """Rotary embedding on (B, S, H, D); optionally on a leading fraction.

    Unfused, the plain op chain on every backend (as the JAX package runs
    it); under :func:`fuse`, one fused operator (the rope kernel on the
    card)."""
    if _FUSION:
        return _fused_rope(x, positions, base=base, fraction=fraction)
    return ref.rope(x, positions, base=base, fraction=fraction)


# ---------------------------------------------------------------------------
# Element-wise arithmetic
# ---------------------------------------------------------------------------

@tagged(OpGroup.ELEMENTWISE, "residual_add")
def residual_add(x, y):
    return x + y


@tagged(OpGroup.ELEMENTWISE, "scale")
def scale(x, factor):
    return x * factor


@tagged(OpGroup.ELEMENTWISE, "box_decode")
def box_decode(raw, anchors):
    """Anchor-relative box decode: raw (..., 4) offsets -> xyxy (..., 4).

    ``anchors`` are (..., 4) as (cx, cy, w, h): shift the centers, exp the
    clipped log-sizes, convert to corners, in f32."""
    rf = raw.float()
    af = anchors.float()
    cx = af[..., 0] + rf[..., 0] * af[..., 2]
    cy = af[..., 1] + rf[..., 1] * af[..., 3]
    w = af[..., 2] * torch.exp(torch.clamp(rf[..., 2], -4.0, 4.0))
    h = af[..., 3] * torch.exp(torch.clamp(rf[..., 3], -4.0, 4.0))
    out = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)
    return out.to(raw.dtype)


# ---------------------------------------------------------------------------
# Quantization (paper §4.4: QDQ operators around the GEMMs)
# ---------------------------------------------------------------------------

def _quantize_int8_impl(x):
    xf = x.float()
    amax = torch.amax(torch.abs(xf))
    # 127 as a tensor on x's device: a CUDA op given a host scalar divisor
    # multiplies by its reciprocal, which differs from JAX's division in
    # the last bit of some quotients (scripts/qdq_division_check.py)
    scale = torch.clamp(amax, min=1e-8) / amax.new_full((), 127.0)
    q = torch.clamp(torch.round(xf / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def _dequantize_int8_impl(q, scale, dtype=torch.float32):
    return (q.float() * scale).to(dtype)


@tagged(OpGroup.QUANT, "quantize")
def quantize_int8(x):
    """Simulated symmetric per-tensor int8 quantization: ``(q, scale)``, q
    int8 and a 0-d f32 scale ``max(amax, 1e-8) / 127`` (absmax reduction,
    divide, round half to even, clamp, cast)."""
    return _quantize_int8_impl(x)


@tagged(OpGroup.QUANT, "dequantize")
def dequantize_int8(q, scale, dtype=torch.float32):
    """Inverse of :func:`quantize_int8` (cast + scale multiply)."""
    return _dequantize_int8_impl(q, scale, dtype)


def fake_quant_int8(x):
    """Round-trip ``x`` through the int8 grid (quantize -> dequantize), in
    ``x``'s dtype; under :func:`fuse` one ``_fused_qdq`` op."""
    if _FUSION:
        return _fused_qdq(x)
    q, s = quantize_int8(x)
    return dequantize_int8(q, s, x.dtype)


def _maybe_fake_quant(*operands):
    if _FAKE_QUANT == "int8":
        return tuple(fake_quant_int8(o) for o in operands)
    return operands


# ---------------------------------------------------------------------------
# Fused operators (paper §6). Each is ONE operator under one ng:fused: tag
# and, on the kernel backend, one kernel launch. The plain backend calls
# the untagged kernels/ref.py twins, so no inner ng: tag shadows the fused
# attribution.
# ---------------------------------------------------------------------------

@tagged(OpGroup.FUSED, "fused_add_rms_norm")
def _fused_add_rms_norm(x, residual, scale, eps: float = 1e-6,
                        zero_centered: bool = False):
    if use_kernels(x):
        return _kernels().fused_add_rms_norm(x, residual, scale, eps=eps,
                                             zero_centered=zero_centered)
    return ref.fused_add_rms_norm(x, residual, scale, eps=eps,
                                  zero_centered=zero_centered)


@tagged(OpGroup.FUSED, "fused_add_layer_norm")
def _fused_add_layer_norm(x, residual, scale, bias, eps: float = 1e-5):
    if use_kernels(x):
        return _kernels().fused_add_layer_norm(x, residual, scale, bias,
                                               eps=eps)
    return ref.fused_add_layer_norm(x, residual, scale, bias, eps=eps)


def add_rms_norm(x, residual, scale, eps: float = 1e-6,
                 zero_centered: bool = False):
    """``(rms_norm(x + residual), x + residual)`` — the pre-norm boundary.

    Unfused, a residual_add op followed by an rms_norm op; under
    :func:`fuse`, one fused operator."""
    if _FUSION:
        return _fused_add_rms_norm(x, residual, scale, eps=eps,
                                   zero_centered=zero_centered)
    r = residual_add(x, residual)
    return rms_norm(r, scale, eps=eps, zero_centered=zero_centered), r


def add_layer_norm(x, residual, scale, bias, eps: float = 1e-5):
    """LayerNorm twin of :func:`add_rms_norm` (returns ``(y, x+residual)``)."""
    if _FUSION:
        return _fused_add_layer_norm(x, residual, scale, bias, eps=eps)
    r = residual_add(x, residual)
    return layer_norm(r, scale, bias, eps=eps), r


@tagged(OpGroup.FUSED, "fused_dequant_add_rms_norm")
def dequant_add_rms_norm(q, qscale, residual, scale, eps: float = 1e-6,
                         zero_centered: bool = False):
    """The fused QDQ epilogue ``(rms_norm(q * qscale + residual), r)``:
    int8 ``q``, a 0-d f32 ``qscale``; one kernel launch on the card."""
    if use_kernels(q):
        return _kernels().dequant_add_rms_norm(q, qscale, residual, scale,
                                               eps=eps,
                                               zero_centered=zero_centered)
    return ref.dequant_add_rms_norm(q, qscale, residual, scale, eps=eps,
                                    zero_centered=zero_centered)


@tagged(OpGroup.FUSED, "fused_qdq")
def _fused_qdq(x):
    """The int8 round-trip as one fused op: plain PyTorch on every backend
    (the JAX package has no kernel for it either)."""
    q, s = _quantize_int8_impl(x)
    return _dequantize_int8_impl(q, s, x.dtype)


@tagged(OpGroup.FUSED, "fused_swiglu")
def _fused_swiglu(gate, up):
    if use_kernels(gate):
        return _kernels().swiglu(gate, up)
    return ref.swiglu(gate, up)


@tagged(OpGroup.FUSED, "fused_geglu")
def _fused_geglu(gate, up):
    if use_kernels(gate):
        return _kernels().geglu(gate, up)
    # JAX's jnp fallback: the activation in f32, rounded, times ``up``
    return F.gelu(gate.float(), approximate="tanh").to(gate.dtype) * up


@tagged(OpGroup.FUSED, "fused_rope")
def _fused_rope(x, positions, base: float = 10000.0, fraction: float = 1.0):
    if use_kernels(x):
        return _kernels().rope(x, positions, base=base, fraction=fraction)
    return ref.rope(x, positions, base=base, fraction=fraction)


@tagged(OpGroup.FUSED, "fused_attn_decode")
def fused_attn_decode(q, k, v, lengths, scale: Optional[float] = None):
    """One-query decode attention over a per-row valid KV prefix as ONE
    operator: the ``decode_core`` kernel on the card.

    q: (B, 1, Hq, Dk); k: (B, T, Hkv, Dk); v: (B, T, Hkv, Dv);
    lengths: (B,) int32 attendable prefix -> (B, 1, Hq, Dv), f32 from the
    plain twin and v's dtype from the kernel (the caller casts).
    """
    if use_kernels(q):
        return _kernels().decode_core(q, k, v, lengths, scale=scale)
    return ref.decode_attention(q, k, v, lengths, scale=scale)


# ---------------------------------------------------------------------------
# GEMM sites (tagged so attribution is exact, not heuristic). The large
# products stay torch.matmul, as the JAX package leaves them to XLA.
# ---------------------------------------------------------------------------

@tagged(OpGroup.GEMM, "linear")
def linear(x, w, b=None):
    x, w = _maybe_fake_quant(x, w)
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


@tagged(OpGroup.GEMM, "einsum")
def einsum(spec: str, *operands):
    dt = operands[0].dtype
    operands = _maybe_fake_quant(*operands)
    return torch.einsum(spec, *operands).to(dt)


@tagged(OpGroup.GEMM, "conv2d")
def conv2d(x, w, b=None, stride: int = 1, padding: str = "VALID"):
    """Strided 2D convolution: NCHW input x OIHW kernel -> NHWC output
    (channels last, so the vision models feed it straight into the
    token-major encoder stack). GEMM-group work in the paper's taxonomy;
    ``F.conv2d`` computes it, as XLA does outside any Pallas kernel in the
    JAX package, accumulating in f32. Under :func:`fake_quant` both
    operands round-trip through int8 first, ``w`` in its own dtype."""
    if padding != "VALID":
        raise ValueError(f"conv2d: padding {padding!r} not ported (VALID only)")
    x, w = _maybe_fake_quant(x, w)
    y = F.conv2d(x, w.to(x.dtype), stride=stride).permute(0, 2, 3, 1)
    y = y.contiguous()
    if b is not None:
        y = y + b.to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# RoI selection
# ---------------------------------------------------------------------------

@tagged(OpGroup.ROI, "nms")
def nms(boxes, scores, iou_threshold: float = 0.5,
        score_threshold: float = 0.0):
    """Greedy NMS keep mask (N,) over (N, 4) xyxy boxes, torchvision
    semantics: the nms kernel on the card, the plain version otherwise."""
    if use_kernels(boxes):
        return _kernels().nms(boxes, scores, iou_threshold=iou_threshold,
                              score_threshold=score_threshold)
    return ref.nms(boxes, scores, iou_threshold=iou_threshold,
                   score_threshold=score_threshold)


# ---------------------------------------------------------------------------
# Interpolation
# ---------------------------------------------------------------------------

@tagged(OpGroup.INTERPOLATION, "interpolate_bilinear")
def interpolate_bilinear(x, out_hw: Tuple[int, int]):
    """Bilinear resize of NCHW, align_corners=False (torch's default).

    The two row gathers are hoisted (each output row pair is gathered once
    and read by both column corners), the lerp runs in f32 and the result
    is cast back to ``x.dtype``, as ``repro.nn.interpolate_bilinear``."""
    _, _, h, w = x.shape
    oh, ow = out_hw
    y0, y1, x0, x1, wy, wx = ref.bilinear_taps(h, w, oh, ow, x.device)
    rows0 = x[:, :, y0].float()                     # (N, C, OH, W)
    rows1 = x[:, :, y1].float()
    top = rows0[..., x0] * (1 - wx) + rows0[..., x1] * wx
    bot = rows1[..., x0] * (1 - wx) + rows1[..., x1] * wx
    return (top * (1 - wy) + bot * wy).to(x.dtype)


# ---------------------------------------------------------------------------
# Pooling / windowed reductions over NHWC (Reduction group)
# ---------------------------------------------------------------------------

def _pool_nchw(x, window: int, stride: Optional[int], padding: str,
               fill: float):
    """``x`` (N, H, W, C) as an NCHW view, padded as ``padding`` asks
    (``"SAME"``: XLA's split, the odd cell at the end), and the stride."""
    s = window if stride is None else stride
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        pads = []
        for n in (xc.shape[3], xc.shape[2]):
            total = max((-(-n // s) - 1) * s + window - n, 0)
            pads += [total // 2, total - total // 2]
        xc = F.pad(xc, pads, value=fill)
    elif padding != "VALID":
        raise ValueError(f"unknown padding {padding!r}")
    return xc, s


@tagged(OpGroup.REDUCTION, "max_pool2d")
def max_pool2d(x, window: int = 2, stride: Optional[int] = None,
               padding: str = "VALID"):
    """2D max pool over NHWC (windowed reduction)."""
    xc, s = _pool_nchw(x, window, stride, padding, float("-inf"))
    return F.max_pool2d(xc, window, s).permute(0, 2, 3, 1)


@tagged(OpGroup.REDUCTION, "avg_pool2d")
def avg_pool2d(x, window: int = 2, stride: Optional[int] = None,
               padding: str = "VALID"):
    """2D average pool over NHWC; f32 accumulation, result in ``x.dtype``
    (padding counts as zeros, as XLA's reduce_window sum does)."""
    xc, s = _pool_nchw(x.float(), window, stride, padding, 0.0)
    return F.avg_pool2d(xc, window, s).permute(0, 2, 3, 1).to(x.dtype)


@tagged(OpGroup.REDUCTION, "global_avg_pool")
def global_avg_pool(x, axes: Tuple[int, ...] = (1, 2)):
    """Mean over the spatial axes, in f32 — the classifier-head pooling."""
    return torch.mean(x.float(), dim=axes).to(x.dtype)
