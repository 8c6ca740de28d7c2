"""Weight bridge: the JAX package's param and cache pytrees, given as numpy,
into the port's dicts of tensors.

``repro.models.transformer.init_lm`` splits the layers into ``lead``
(unstacked leaders), ``scan`` and ``trail`` (the unstacked remainder of a
partial pattern: gemma3-27b's 62 layers are 10 repeats of 6 and 2 more).
It keeps each pattern position's blocks stacked along a leading layer dim
when ``cfg.scan_layers`` (the default, kept by ``reduced``):
``params["scan"][j]`` leaves are ``(n_rep, ...)``, and layer
``len(lead) + r * len(pattern) + j`` is slice ``r`` of position ``j``. The
port's params hold one dict per layer (``params["layers"]``) in layer
order, lead, then scan, then trail; ``init_lm_cache``'s caches unstack the
same way (a ring's int32 ``"pos"`` side-car and MLA's ``"c"`` / ``"kr"``
cross as they are, as do a recurrent layer's mixer and its ``"h"`` /
``"conv"`` state: recurrentgemma-2b's 26 layers are 8 repeats of
(rec, rec, local) and a (rec, rec) trail). An MoE layer's expert leaves
keep their leading (E,) dim; deepseek-v2-lite's dense first layer is
``lead``. Every
other top-level entry (``embed``, absent where the config takes
embeddings; the learned position table ``pos``, ``final_norm``, ``head``)
is carried as it is, and an entry this module does not know raises
instead of being dropped. ``repro.models.vision.init_vision``'s tree keeps
its blocks in a plain list and crosses as it is
(:func:`vision_params_from_jax`). The caller turns the JAX
leaves into numpy (``jax.tree_util.tree_map(np.asarray, t)``), so this
module imports nothing of JAX.
"""

from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch

from repro_torch.models.common import ModelConfig


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 torch can read: widen exactly, narrow again
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _unstack(stacked: List[Any], cfg: ModelConfig, n_rep: int) -> List[Any]:
    """Per-layer trees from the per-pattern-position stacks of ``n_rep``
    repeats, in layer order."""
    pattern = cfg.block_pattern
    if len(stacked) != len(pattern):
        raise ValueError(f"{len(stacked)} stacks for a pattern of {len(pattern)}")
    layers = []
    for r in range(n_rep):
        for j in range(len(pattern)):
            s = stacked[j]
            layers.append(s[r] if isinstance(s, list)
                          else _map(lambda a, r=r: np.asarray(a)[r], s))
    return layers


def _layers(tree: dict, cfg: ModelConfig) -> List[Any]:
    """Every layer's tree in layer order: lead, the unstacked scan, trail.
    The scan holds the layers the leaders and the trail leave: an MoE
    config's ``first_dense_layers`` dense leaders are ``lead``, with
    another structure than the MoE layers of the scan."""
    lead, trail = tree.get("lead", []), tree.get("trail", [])
    n_rep = (cfg.n_layers - len(lead) - len(trail)) // len(cfg.block_pattern)
    layers = [*lead, *_unstack(tree["scan"], cfg, n_rep), *trail]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: {len(layers)} layers in the tree for "
                         f"{cfg.n_layers}")
    return layers


def tensors_from_jax(tree: Any, device="cuda") -> Any:
    """Any tree of numpy leaves (a JAX ``init_moe`` / ``init_mla`` tree,
    a cache) as the same tree of tensors, lists for tuples."""
    return _map(lambda a: _tensor(a, device), tree)


#: top-level entries of ``init_lm``'s tree carried as they are
_CARRIED = ("embed", "pos", "final_norm", "head")
#: the layer stacks, unstacked into ``layers``
_STACKS = ("lead", "scan", "trail")


def params_from_jax(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """The port's params from ``repro.models.init_lm``'s tree (numpy)."""
    unknown = sorted(set(tree) - set(_CARRIED) - set(_STACKS))
    if unknown:
        raise ValueError(f"{cfg.name}: params entries the bridge does not "
                         f"know: {unknown}")
    out = {k: tensors_from_jax(tree[k], device)
           for k in _CARRIED if k in tree}
    out["layers"] = [tensors_from_jax(layer, device)
                     for layer in _layers(tree, cfg)]
    return out


#: top-level entries of ``init_vision``'s tree: the classifier's head, or
#: the detector's neck prior, heads and refinement cross-attention
_VISION = ("patch", "pos2d", "blocks", "final_norm", "head", "neck_prior",
           "box_head", "cls_head", "xattn")


def vision_params_from_jax(tree: dict, cfg: ModelConfig,
                           device="cuda") -> dict:
    """The port's params from ``repro.models.vision.init_vision``'s tree
    (numpy): every entry carried as it is, ``blocks`` a list of per-layer
    dicts in both."""
    unknown = sorted(set(tree) - set(_VISION))
    if unknown:
        raise ValueError(f"{cfg.name}: vision params entries the bridge does "
                         f"not know: {unknown}")
    if len(tree["blocks"]) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: {len(tree['blocks'])} blocks for "
                         f"{cfg.n_layers} layers")
    return {k: tensors_from_jax(v, device) for k, v in tree.items()}


def caches_from_jax(tree: dict, cfg: ModelConfig, device="cuda") -> List[dict]:
    """The port's per-layer caches from ``init_lm_cache`` / ``lm_prefill``'s
    cache tree (numpy)."""
    unknown = sorted(set(tree) - set(_STACKS))
    if unknown:
        raise ValueError(f"{cfg.name}: cache entries the bridge does not "
                         f"know: {unknown}")
    return [tensors_from_jax(layer, device)
            for layer in _layers(tree, cfg)]
