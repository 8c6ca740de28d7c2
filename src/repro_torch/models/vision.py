"""The vision family: the ViT classifier and the single-stage detector.

The port of ``repro.models.vision`` (the paper's Torchvision half): pure
functions over a params dict, built on the encoder blocks of
``models/transformer.py`` (full-mask attention):

* **ViT classifier** (``vit_classify``): conv patch embedding (GEMM),
  learned 2D position embeddings resized bilinearly when the runtime grid
  differs from the stored one (Interpolation), encoder blocks, a pooled
  head (``avg_pool2d``/``max_pool2d`` + ``global_avg_pool``: Reduction),
  a linear classifier.
* **Detector** (``detect_forward``): ViT backbone -> bilinear feature
  upsample (Interpolation) -> learned location prior -> box / class heads
  -> sigmoid scores, CenterNet-style peak pooling (``max_pool2d`` stride
  1), score sort (Reduction) -> DETR-style refinement of the top-K boxes
  by cross-attention over the feature map (the full-mask attention
  kernel) -> greedy NMS per image (RoI Selection, the nms kernel).

Every semantic site carries the JAX package's scope tag, so the capture
sees the same (group, op_site) pairs.

Public API:

    init_vision(generator, cfg)        -> params (classifier or detector)
    vit_classify(params, images, cfg)  -> logits (B, n_classes)
    detect_forward(params, images, cfg)-> (boxes (B, K, 4), scores (B, K),
                                           keep (B, K) bool)
    vision_forward(params, images, cfg)-> dispatches on ``cfg.is_detector``
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import nn
from repro_torch.core.taxonomy import OpGroup
from repro_torch.models import attention as A
from repro_torch.models.common import ModelConfig, dense_init
from repro_torch.models.transformer import (_apply_norm, _init_norm,
                                            block_forward, check_supported,
                                            init_block)


def _check_vision(cfg: ModelConfig) -> None:
    if not cfg.is_vision:
        raise ValueError(f"{cfg.name!r} is not a vision config "
                         f"(image_size={cfg.image_size})")
    if cfg.image_size % cfg.patch_size:
        raise ValueError(f"image_size {cfg.image_size} not divisible by "
                         f"patch_size {cfg.patch_size}")
    if cfg.n_classes <= 0:
        raise ValueError("vision configs need n_classes > 0")
    check_supported(cfg)


def _normal(generator: torch.Generator, shape, std: float, dtype):
    return (std * torch.randn(shape, generator=generator,
                              device=generator.device)).to(dtype)


def _dense(generator, d_in: int, d_out: int, dtype) -> dict:
    return {"w": dense_init(generator, (d_in, d_out), dtype=dtype),
            "b": torch.zeros((d_out,), dtype=dtype, device=generator.device)}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_vision(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """Random params on ``generator``'s device, drawn from it in order: the
    classifier, or the detector where ``cfg.det_top_k > 0``."""
    _check_vision(cfg)
    d, p, g = cfg.d_model, cfg.patch_size, cfg.patch_grid
    pd, dev = cfg.torch_param_dtype, generator.device
    params: dict = {
        # OIHW conv kernel; fan-in C * P * P (dense_init's in_axis=1 spans
        # C only, so scale by hand like a flattened linear patch embed)
        "patch": {
            "w": dense_init(generator, (d, cfg.n_channels, p, p), in_axis=1,
                            dtype=pd) / float(p),
            "b": torch.zeros((d,), dtype=pd, device=dev),
        },
        "pos2d": _normal(generator, (g, g, d), 0.02, pd),
        "blocks": [init_block(generator, cfg) for _ in range(cfg.n_layers)],
        "final_norm": _init_norm(cfg, dev),
    }
    if cfg.is_detector:
        gu = g * cfg.det_upsample
        params["neck_prior"] = _normal(generator, (d, gu, gu), 0.02, pd)
        params["box_head"] = _dense(generator, d, 4, pd)
        params["cls_head"] = _dense(generator, d, cfg.n_classes, pd)
        params["xattn"] = {
            name: dense_init(generator, (d, d), dtype=pd)
            for name in ("wq", "wk", "wv", "wo")}
        params["xattn"]["delta"] = _dense(generator, d, 4, pd)
    else:
        params["head"] = _dense(generator, d, cfg.n_classes, pd)
    return params


# ---------------------------------------------------------------------------
# backbone: patchify -> 2D positions -> encoder blocks
# ---------------------------------------------------------------------------

def resize_pos_embed(pos2d: torch.Tensor, grid_hw: Tuple[int, int]):
    """(gh0, gw0, D) learned grid -> (gh, gw, D) by bilinear resize (the
    Interpolation group inside a classifier); a no-op at the stored grid."""
    gh0, gw0, _ = pos2d.shape
    if (gh0, gw0) == tuple(grid_hw):
        return pos2d
    as_nchw = pos2d.permute(2, 0, 1)[None]            # (1, D, gh0, gw0)
    resized = nn.interpolate_bilinear(as_nchw, grid_hw)
    return resized[0].permute(1, 2, 0)                # (gh, gw, D)


def vision_backbone(params, images, cfg: ModelConfig):
    """images (B, C, H, W) -> (normed tokens (B, gh*gw, D), (gh, gw))."""
    p = cfg.patch_size
    b, _, hh, ww = images.shape
    gh, gw = hh // p, ww // p
    x = nn.conv2d(images.to(cfg.activation_dtype), params["patch"]["w"],
                  params["patch"]["b"], stride=p)     # (B, gh, gw, D)
    pos = resize_pos_embed(params["pos2d"], (gh, gw))
    with nn.scope(OpGroup.MEMORY, "pos_2d"):
        x = x + pos.to(x.dtype)
    with nn.scope(OpGroup.MEMORY, "patches_to_tokens"):
        tokens = x.reshape(b, gh * gw, cfg.d_model)
    positions = torch.arange(gh * gw, dtype=torch.int32,
                             device=images.device)[None].expand(b, gh * gw)
    for blk in params["blocks"]:
        tokens, _ = block_forward(blk, tokens, cfg, "attn", positions)
    return _apply_norm(params["final_norm"], tokens, cfg), (gh, gw)


# ---------------------------------------------------------------------------
# classifier head
# ---------------------------------------------------------------------------

def vit_classify(params, images, cfg: ModelConfig):
    """Patchify-ViT image classification: (B, C, H, W) -> (B, n_classes)."""
    h, (gh, gw) = vision_backbone(params, images, cfg)
    b = h.shape[0]
    with nn.scope(OpGroup.MEMORY, "tokens_to_grid"):
        feat = h.reshape(b, gh, gw, cfg.d_model)
    if min(gh, gw) >= 2:
        pool = nn.max_pool2d if cfg.pool == "max" else nn.avg_pool2d
        feat = pool(feat, window=2)
    pooled = nn.global_avg_pool(feat)                  # (B, D)
    return nn.linear(pooled, params["head"]["w"].to(pooled.dtype),
                     params["head"]["b"])


# ---------------------------------------------------------------------------
# detection head
# ---------------------------------------------------------------------------

def _anchor_grid(gh: int, gw: int, stride: float, dtype, device):
    """(gh*gw, 4) anchors as (cx, cy, w, h) in pixels, one per cell."""
    with nn.scope(OpGroup.MEMORY, "anchor_grid"):
        ys = (torch.arange(gh, dtype=torch.float32, device=device) + 0.5) \
            * stride
        xs = (torch.arange(gw, dtype=torch.float32, device=device) + 0.5) \
            * stride
        cy, cx = torch.meshgrid(ys, xs, indexing="ij")
        wh = torch.full_like(cx, stride)
        anchors = torch.stack([cx, cy, wh, wh], dim=-1).reshape(-1, 4)
        return anchors.to(dtype)


def _refine_boxes(xp, tokens, idx, top_b, stride: float, cfg: ModelConfig):
    """DETR-style second stage: the top-K peak queries cross-attend the
    full feature map (full-mask attention, Sq = K != Skv) and regress a
    per-box correction in units of the feature stride."""
    hq = cfg.n_heads
    with nn.scope(OpGroup.MEMORY, "gather_queries"):
        qf = torch.take_along_dim(tokens, idx[..., None], dim=1)  # (B,K,D)
    q = nn.split_heads(nn.linear(qf, xp["wq"].to(tokens.dtype)), hq)
    kk = nn.split_heads(nn.linear(tokens, xp["wk"].to(tokens.dtype)), hq)
    vv = nn.split_heads(nn.linear(tokens, xp["wv"].to(tokens.dtype)), hq)
    att = A._attention_impl(q, kk, vv, causal=False)
    att = nn.linear(nn.merge_heads(att), xp["wo"].to(tokens.dtype))
    delta = nn.linear(att, xp["delta"]["w"].to(tokens.dtype),
                      xp["delta"]["b"])                           # (B,K,4)
    with nn.scope(OpGroup.ELEMENTWISE, "box_refine"):
        return top_b + delta.to(top_b.dtype) * stride


def detect_forward(params, images, cfg: ModelConfig):
    """Single-stage detection: (B, C, H, W) -> (boxes (B, K, 4) xyxy,
    scores (B, K), keep (B, K) bool), K = det_top_k.

    The NonGEMM spine the paper measures on Torchvision detectors:
    interpolation (feature upsample), pooling (peak selection), reduction
    (score sort) and RoI selection (greedy NMS), after a GEMM-heavy
    backbone, all scope-tagged."""
    h, (gh, gw) = vision_backbone(params, images, cfg)
    b, d = h.shape[0], cfg.d_model
    with nn.scope(OpGroup.MEMORY, "tokens_to_grid"):
        feat = h.reshape(b, gh, gw, d).permute(0, 3, 1, 2)      # NCHW
    gh_u, gw_u = gh * cfg.det_upsample, gw * cfg.det_upsample
    up = nn.interpolate_bilinear(feat, (gh_u, gw_u))
    pmap = nn.residual_add(up, params["neck_prior"].to(up.dtype))
    with nn.scope(OpGroup.MEMORY, "grid_to_tokens"):
        t = pmap.reshape(b, d, gh_u * gw_u).permute(0, 2, 1)  # (B,N,D)

    cls_logits = nn.linear(t, params["cls_head"]["w"].to(t.dtype),
                           params["cls_head"]["b"])             # (B, N, K)
    box_raw = nn.linear(t, params["box_head"]["w"].to(t.dtype),
                        params["box_head"]["b"])                # (B, N, 4)

    probs = nn.sigmoid(cls_logits)
    with nn.scope(OpGroup.REDUCTION, "score_max"):
        scores = torch.amax(probs.float(), dim=-1)              # (B, N)

    # CenterNet-style peak NMS: a score survives only where it equals its
    # 3x3 local max (windowed Reduction doing RoI pre-selection)
    smap = scores.reshape(b, gh_u, gw_u, 1)
    peak = nn.max_pool2d(smap, window=3, stride=1, padding="SAME")
    with nn.scope(OpGroup.ELEMENTWISE, "peak_mask"):
        scores = torch.where(smap >= peak, smap, 0.0).reshape(b, gh_u * gw_u)

    stride = float(cfg.patch_size) / cfg.det_upsample
    anchors = _anchor_grid(gh_u, gw_u, stride, box_raw.dtype, images.device)
    boxes = nn.box_decode(box_raw, anchors)                     # (B, N, 4)

    k = min(cfg.det_top_k, gh_u * gw_u)
    with nn.scope(OpGroup.REDUCTION, "topk_scores"):
        # lax.top_k puts the lower index first among equal scores; the
        # peak mask zeroes most cells, so ties are certain. torch.topk
        # promises no order among them: a stable descending sort does
        top_s, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
        top_s, idx = top_s[:, :k], idx[:, :k]
    with nn.scope(OpGroup.MEMORY, "gather_boxes"):
        top_b = torch.take_along_dim(boxes, idx[..., None], dim=1)

    if "xattn" in params:
        top_b = _refine_boxes(params["xattn"], t, idx, top_b, stride, cfg)

    # one NMS per image, as the JAX package calls it
    keep = torch.stack([
        nn.nms(top_b[i].float(), top_s[i],
               iou_threshold=cfg.det_iou_threshold,
               score_threshold=cfg.det_score_threshold)
        for i in range(b)])
    return top_b, top_s, keep


def vision_forward(params, images, cfg: ModelConfig):
    """One entry point for both vision shapes."""
    if cfg.is_detector:
        return detect_forward(params, images, cfg)
    return vit_classify(params, images, cfg)


__all__ = ["init_vision", "resize_pos_embed", "vision_backbone",
           "vit_classify", "detect_forward", "vision_forward"]
