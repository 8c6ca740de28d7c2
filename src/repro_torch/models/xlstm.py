"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM (scalar).

The port of ``repro.models.xlstm``. The mLSTM runs in the
**chunkwise-parallel** form: the sequence is cut into chunks of
``cfg.mlstm_chunk``; within a chunk the stabilised quadratic
(attention-like) form runs as batched products, and a (C, n, m)
matrix-memory state is carried across chunks by a Python loop over the
chunks, the counterpart of the JAX package's ``lax.scan`` (never a loop
over tokens). Log-space cumulative sums of the forget gates and a running
max stabiliser ``m`` keep the exponential input gates finite. Decode is the
recurrent step on an O(1) state.

The sLSTM's recurrence is sequential: prefill loops over the tokens, the
counterpart of ``lax.scan`` over time, then a GeGLU FFN tail.

Decode writes every state tensor in place (``copy_``) into the cache it is
given, as ``recurrent_decode`` does: the engines' decode step is a captured
CUDA graph that replays against those tensors.

Both mixers are mostly NonGEMM, under the JAX package's tags: the mLSTM
gates (``mlstm_gates``, Activation), its stabilised D-matrix
(``mlstm_dmatrix``, Logit), its normaliser (``mlstm_normalizer``,
Normalization), the causal conv (``causal_conv1d``, Memory) and the sLSTM's
per-token loop (``slstm_scan``, Element-wise). The JAX package has no Pallas
kernel for either cell, so both stay plain PyTorch on the card; the norms
(``rms_norm``, ``layer_norm``) and the fused GeGLU reach the port's kernels.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import nn
from repro_torch.core.taxonomy import OpGroup
from repro_torch.models.common import ModelConfig, dense_init, rounded
from repro_torch.models.recurrent import _causal_conv1d, _conv_tail

NEG_INF = -1e30
#: the stabiliser ``m`` of an empty state
M_INIT = -1e9


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """The mixer's params, with the JAX package's leaves and shapes."""
    d = cfg.d_model
    di = int(d * cfg.mlstm_proj_factor)
    h = cfg.n_heads
    pd, dev = cfg.torch_param_dtype, generator.device
    return {
        "w_up": dense_init(generator, (d, di), dtype=pd),
        "w_z": dense_init(generator, (d, di), dtype=pd),
        "conv_w": dense_init(generator, (cfg.conv_width, di), dtype=pd),
        "conv_b": torch.zeros((di,), dtype=pd, device=dev),
        "w_q": dense_init(generator, (di, di), dtype=pd),
        "w_k": dense_init(generator, (di, di), dtype=pd),
        "w_v": dense_init(generator, (di, di), dtype=pd),
        "w_i": dense_init(generator, (di, h), dtype=pd),
        "b_i": torch.zeros((h,), dtype=pd, device=dev),
        "w_f": dense_init(generator, (di, h), dtype=pd),
        "b_f": torch.full((h,), 3.0, dtype=pd, device=dev),  # open forget gates
        "out_norm": torch.ones((di,), dtype=pd, device=dev),
        "w_down": dense_init(generator, (di, d), dtype=pd),
    }


def _mlstm_qkvif(params, x, cfg: ModelConfig):
    """The pre-cell computation. x: (B, S, D) -> q, k, v (B, S, H, dh) in
    x's dtype, i_raw and logf (B, S, H) in f32, and the output gate's z."""
    h = cfg.n_heads
    up = nn.linear(x, params["w_up"].to(x.dtype))
    z = nn.linear(x, params["w_z"].to(x.dtype))
    c = nn.silu(_causal_conv1d(up, params["conv_w"], params["conv_b"]))
    q = nn.split_heads(nn.linear(c, params["w_q"].to(x.dtype)), h)
    k = nn.split_heads(nn.linear(c, params["w_k"].to(x.dtype)), h)
    v = nn.split_heads(nn.linear(up, params["w_v"].to(x.dtype)), h)
    with nn.scope(OpGroup.ACTIVATION, "mlstm_gates"):
        i_raw = (nn.linear(up, params["w_i"].to(x.dtype)).float()
                 + params["b_i"].float())
        f_raw = (nn.linear(up, params["w_f"].to(x.dtype)).float()
                 + params["b_f"].float())
        logf = F.logsigmoid(f_raw)                       # (B, S, H)
    # sqrt(dh) rounded to k's dtype first, as the JAX package's
    k = k / rounded(math.sqrt(q.shape[-1]), k.dtype)
    return q, k, v, i_raw, logf, z


def _chunk_step(state, qj, kj, vj, ij, fj):
    """One chunk of the stabilised cell. state: (C (B,H,dh,dh), n (B,H,dh),
    m (B,H)) f32; qj, kj, vj (B,L,H,dh); ij, fj (B,L,H) f32. Returns the
    state at the chunk's end and its output (B,L,H,dh) f32."""
    C, n, m = state
    L = qj.shape[1]
    F_ = torch.cumsum(fj, dim=1)                         # (B,L,H) inclusive
    Fi = F_.transpose(1, 2)                              # (B,H,L)
    it = ij.transpose(1, 2)                              # (B,H,L)
    with nn.scope(OpGroup.LOGIT, "mlstm_dmatrix"):
        # D[b,h,i,j] = F_i - F_j + i_j   for j <= i (intra-chunk)
        Dlog = Fi[:, :, :, None] - Fi[:, :, None, :] + it[:, :, None, :]
        tri = torch.ones((L, L), dtype=torch.bool, device=Dlog.device).tril()
        Dlog = torch.where(tri, Dlog, torch.full_like(Dlog, NEG_INF))
        carry_log = Fi + m[:, :, None]                   # (B,H,L)
        m_new_i = torch.maximum(Dlog.amax(-1), carry_log)
        D = torch.exp(Dlog - m_new_i[..., None])         # (B,H,L,L)
        carry_w = torch.exp(carry_log - m_new_i)         # (B,H,L)
    with nn.scope(OpGroup.GEMM, "mlstm_intra"):
        qf = qj.transpose(1, 2).float()                  # (B,H,L,dh)
        kf = kj.transpose(1, 2).float()
        vf = vj.transpose(1, 2).float()
        scores = torch.matmul(qf, kf.transpose(-1, -2)) * D
        num_intra = torch.matmul(scores, vf)
        den_intra = torch.matmul(D, kf)
    with nn.scope(OpGroup.GEMM, "mlstm_inter"):
        num_inter = torch.matmul(qf, C) * carry_w[..., None]
        den_inter = n[:, :, None, :] * carry_w[..., None]
    num = num_intra + num_inter
    den = (qf * (den_intra + den_inter)).sum(-1)         # (B,H,L)
    with nn.scope(OpGroup.NORMALIZATION, "mlstm_normalizer"):
        denom = torch.maximum(den.abs(), torch.exp(-m_new_i))
        h_out = num / denom[..., None]                   # (B,H,L,dh)

    # the state at the chunk's end
    F_L = Fi[:, :, -1]                                   # (B,H)
    state_log = F_L[:, :, None] - Fi + it                # (B,H,L)
    m_next = torch.maximum(F_L + m, state_log.amax(-1))
    w_src = torch.exp(state_log - m_next[:, :, None])
    w_old = torch.exp(F_L + m - m_next)
    kw = kf * w_src[..., None]
    C_next = C * w_old[:, :, None, None] + torch.matmul(kw.transpose(-1, -2),
                                                        vf)
    n_next = n * w_old[:, :, None] + kw.sum(2)
    return (C_next, n_next, m_next), h_out.transpose(1, 2)


def mlstm_cell_chunked(q, k, v, i_raw, logf, chunk: int):
    """Chunkwise-parallel stabilised mLSTM cell from an empty state.

    q, k, v: (B, S, H, dh); i_raw, logf: (B, S, H) f32. Returns (h_out
    (B, S, H, dh) f32, the final state (C (B,H,dh,dh), n (B,H,dh), m (B,H))
    f32). A length that is no multiple of the chunk pads the last chunk
    with ``i_raw`` NEG_INF and ``logf`` 0, which leave the state as it is.
    """
    b, s, h, dh = q.shape
    L = min(chunk, s)
    nchunk = -(-s // L)
    pad = nchunk * L - s
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        i_raw = F.pad(i_raw, (0, 0, 0, pad), value=NEG_INF)
        logf = F.pad(logf, (0, 0, 0, pad))
    dev = q.device
    state = (torch.zeros((b, h, dh, dh), dtype=torch.float32, device=dev),
             torch.zeros((b, h, dh), dtype=torch.float32, device=dev),
             torch.full((b, h), M_INIT, dtype=torch.float32, device=dev))
    outs = []
    for j in range(nchunk):
        sl = slice(j * L, (j + 1) * L)
        state, hj = _chunk_step(state, q[:, sl], k[:, sl], v[:, sl],
                                i_raw[:, sl], logf[:, sl])
        outs.append(hj)
    out = torch.cat(outs, dim=1) if nchunk > 1 else outs[0]
    return out[:, :s].contiguous(), state


def mlstm_cell_step(q, k, v, i_raw, logf, state):
    """Recurrent mLSTM step (decode, and the chunked cell's oracle).
    q, k, v: (B, 1, H, dh); i_raw, logf (B, 1, H) f32. Returns (h (B, 1,
    H, dh) f32, the new state), fresh tensors."""
    C, n, m = state
    qf, kf, vf = (a[:, 0].float() for a in (q, k, v))
    it, ft = i_raw[:, 0], logf[:, 0]
    m_new = torch.maximum(ft + m, it)
    fw = torch.exp(ft + m - m_new)[..., None]            # (B,H,1)
    iw = torch.exp(it - m_new)[..., None]
    C_new = C * fw[..., None] + iw[..., None] * (kf[..., :, None]
                                                 * vf[..., None, :])
    n_new = n * fw + iw * kf
    num = torch.matmul(qf[:, :, None, :], C_new)[:, :, 0]  # (B,H,dh)
    den = torch.maximum((qf * n_new).sum(-1).abs(), torch.exp(-m_new))
    h = num / den[..., None]
    return h[:, None], (C_new, n_new, m_new)


def _mlstm_out(params, h_cell, z, x_dtype, cfg: ModelConfig):
    """The cell's output in the activation dtype, RMS-normed, gated by
    silu(z), projected down."""
    b, s, h, dh = h_cell.shape
    flat = h_cell.reshape(b, s, h * dh).to(x_dtype)
    flat = nn.rms_norm(flat, params["out_norm"].to(x_dtype))
    gated = flat * nn.silu(z)
    return nn.linear(gated, params["w_down"].to(x_dtype))


def mlstm_forward(params, x, cfg: ModelConfig):
    """Full-sequence mLSTM mixer. x: (B, S, D)."""
    q, k, v, i_raw, logf, z = _mlstm_qkvif(params, x, cfg)
    h_cell, _ = mlstm_cell_chunked(q, k, v, i_raw, logf, cfg.mlstm_chunk)
    return _mlstm_out(params, h_cell, z, x.dtype, cfg)


def mlstm_prefill(params, x, cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """Chunked mLSTM forward that also returns the decode state. Every
    token of ``x`` enters the state: the caller prefills the exact prompt,
    unpadded."""
    q, k, v, i_raw, logf, z = _mlstm_qkvif(params, x, cfg)
    h_cell, (C, n, m) = mlstm_cell_chunked(q, k, v, i_raw, logf,
                                           cfg.mlstm_chunk)
    y = _mlstm_out(params, h_cell, z, x.dtype, cfg)
    # the conv tail over the *pre-conv* up-projection stream
    up = nn.linear(x, params["w_up"].to(x.dtype))
    cache = {"C": C.contiguous(), "n": n.contiguous(), "m": m.contiguous(),
             "conv": _conv_tail(up, cfg)}
    return y, cache


def init_mlstm_cache(cfg: ModelConfig, batch: int, device="cuda") -> dict:
    di = int(cfg.d_model * cfg.mlstm_proj_factor)
    h = cfg.n_heads
    dh = di // h
    return {
        "C": torch.zeros((batch, h, dh, dh), dtype=torch.float32,
                         device=device),
        "n": torch.zeros((batch, h, dh), dtype=torch.float32, device=device),
        "m": torch.full((batch, h), M_INIT, dtype=torch.float32,
                        device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, di),
                            dtype=cfg.activation_dtype, device=device),
    }


def mlstm_decode(params, x, cfg: ModelConfig, cache: dict,
                 pos) -> Tuple[torch.Tensor, dict]:
    """One-token mLSTM step. x: (B, 1, D). ``C``, ``n``, ``m`` and
    ``conv`` are written in place (``copy_``) and the same dict is
    returned."""
    del pos
    h = cfg.n_heads
    up = nn.linear(x, params["w_up"].to(x.dtype))
    z = nn.linear(x, params["w_z"].to(x.dtype))
    # the conv over the (K-1)-tail and the current input: the JAX
    # package's untagged einsum, accumulated in f32
    window = torch.cat([cache["conv"], up], dim=1)                 # (B, K, W)
    conv_w = params["conv_w"].to(x.dtype)
    conv = (window.float() * conv_w.float()).sum(1).to(x.dtype)
    c = nn.silu(conv[:, None] + params["conv_b"].to(x.dtype))
    q = nn.split_heads(nn.linear(c, params["w_q"].to(x.dtype)), h)
    k = nn.split_heads(nn.linear(c, params["w_k"].to(x.dtype)), h)
    v = nn.split_heads(nn.linear(up, params["w_v"].to(x.dtype)), h)
    i_raw = (nn.linear(up, params["w_i"].to(x.dtype)).float()
             + params["b_i"].float())
    logf = F.logsigmoid(nn.linear(up, params["w_f"].to(x.dtype)).float()
                        + params["b_f"].float())
    k = k / rounded(math.sqrt(q.shape[-1]), k.dtype)
    h_cell, (C, n, m) = mlstm_cell_step(q, k, v, i_raw, logf,
                                        (cache["C"], cache["n"], cache["m"]))
    y = _mlstm_out(params, h_cell.to(x.dtype), z, x.dtype, cfg)
    cache["C"].copy_(C)
    cache["n"].copy_(n)
    cache["m"].copy_(m)
    cache["conv"].copy_(window[:, 1:])
    return y, cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """The mixer's params, with the JAX package's leaves and shapes. The
    input bias is JAX's flat ``[0]*d, [3]*d, [0]*2d``, which the step
    reshapes to (H, 4 dh) per head as JAX's does."""
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    pd, dev = cfg.torch_param_dtype, generator.device
    d_ff = int(d * cfg.slstm_ff_factor)
    b_in = torch.cat([torch.zeros((d,)), torch.full((d,), 3.0),
                      torch.zeros((2 * d,))])
    return {
        "w_in": dense_init(generator, (d, 4 * d), dtype=pd),
        "b_in": b_in.to(device=dev, dtype=pd),            # open forget gates
        "r": dense_init(generator, (h, dh, 4 * dh), in_axis=1, dtype=pd),
        "out_norm": torch.ones((d,), dtype=pd, device=dev),
        "ff_up": dense_init(generator, (d, 2 * d_ff), dtype=pd),
        "ff_down": dense_init(generator, (d_ff, d), dtype=pd),
    }


def _slstm_step(params, x_t, state, cfg: ModelConfig):
    """One token. x_t: (B, D) raw token features in the activation dtype,
    projected here; state (c, n, m, h) each (B, H, dh) f32. Returns (the
    new state, h)."""
    c, n, m, h_prev = state
    b, d = x_t.shape
    nh = cfg.n_heads
    dh = d // nh
    zx = (nn.linear(x_t, params["w_in"].to(x_t.dtype))
          + params["b_in"].to(x_t.dtype))
    rh = torch.einsum("bhd,hde->bhe", h_prev.to(x_t.dtype),
                      params["r"].to(x_t.dtype))           # (B, H, 4 dh)
    z_all = zx.reshape(b, nh, 4 * dh) + rh
    i_raw, f_raw, z_raw, o_raw = torch.split(z_all.float(), dh, dim=-1)
    logf = F.logsigmoid(f_raw)
    m_new = torch.maximum(logf + m, i_raw)
    i_w = torch.exp(i_raw - m_new)
    f_w = torch.exp(logf + m - m_new)
    c_new = f_w * c + i_w * torch.tanh(z_raw)
    n_new = f_w * n + i_w
    h_new = torch.sigmoid(o_raw) * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, m_new, h_new), h_new


def _slstm_state0(b: int, cfg: ModelConfig, device):
    """(c, n, m, h) of an empty state, four tensors (B, H, dh) f32."""
    shape = (b, cfg.n_heads, cfg.d_model // cfg.n_heads)
    return tuple(torch.full(shape, v, dtype=torch.float32, device=device)
                 for v in (0.0, 0.0, M_INIT, 0.0))


def _slstm_scan(params, x, cfg: ModelConfig):
    """The recurrence over every token of x (B, S, D), one step a token.
    Returns (the final state, h (B, S, D) in x's dtype)."""
    b, s, d = x.shape
    state = _slstm_state0(b, cfg, x.device)
    hs = []
    with nn.scope(OpGroup.ELEMENTWISE, "slstm_scan"):
        for t in range(s):
            state, h = _slstm_step(params, x[:, t], state, cfg)
            hs.append(h)
    return state, torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)


def _slstm_ffn(params, h):
    """RMSNorm, then the GeGLU FFN tail. ``ff_up``'s halves are given to
    ``geglu`` as contiguous copies (the fused kernel takes contiguous
    operands; XLA materialises the JAX package's slices alike)."""
    h = nn.rms_norm(h, params["out_norm"].to(h.dtype))
    up = nn.linear(h, params["ff_up"].to(h.dtype))
    gate, val = (t.contiguous() for t in up.chunk(2, dim=-1))
    return nn.linear(nn.geglu(gate, val), params["ff_down"].to(h.dtype))


def slstm_forward(params, x, cfg: ModelConfig):
    """Sequential sLSTM over (B, S, D), then the GeGLU FFN."""
    _, h = _slstm_scan(params, x, cfg)
    return _slstm_ffn(params, h)


def slstm_prefill(params, x, cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """Sequential sLSTM forward that also returns the decode state."""
    (c, n, m, hh), h = _slstm_scan(params, x, cfg)
    return _slstm_ffn(params, h), {"c": c, "n": n, "m": m, "h": hh}


def init_slstm_cache(cfg: ModelConfig, batch: int, device="cuda") -> dict:
    return dict(zip(("c", "n", "m", "h"), _slstm_state0(batch, cfg, device)))


def slstm_decode(params, x, cfg: ModelConfig, cache: dict,
                 pos) -> Tuple[torch.Tensor, dict]:
    """One-token sLSTM step. x: (B, 1, D). ``c``, ``n``, ``m`` and ``h``
    are written in place (``copy_``) and the same dict is returned."""
    del pos
    state = (cache["c"], cache["n"], cache["m"], cache["h"])
    new_state, h = _slstm_step(params, x[:, 0], state, cfg)
    b, d = x.shape[0], x.shape[2]
    y = _slstm_ffn(params, h.reshape(b, 1, d).to(x.dtype))
    for name, t in zip(("c", "n", "m", "h"), new_state):
        cache[name].copy_(t)
    return y, cache
