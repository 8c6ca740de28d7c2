"""Operator fusion pass — graph-level NonGEMM chain rewriting (paper §6).

A copy of ``repro.core.fusion`` over the port's captured
:class:`~repro_torch.core.graph.OpRecord` stream (a test holds its
rewrites, reports and chain lists equal to JAX's on the same records).
The paper's closing observation is that operator fusion *reduces but does
not eliminate* the NonGEMM bottleneck. This module is the rewriter that
collapses the dominant NonGEMM chains into single fused operators, each
backed, where ``kernel`` names one, by a hand-written CUDA kernel of
``repro_torch.kernels.ops`` and attributed to the ``fused`` operator group
via an ``ng:fused:<name>`` scope tag.

Two cooperating layers:

* **Record rewriting** (this module): ``fuse_records(records)`` walks the
  op stream, groups records into *site runs* (maximal runs of records
  emitted under the same ``ng:`` scope), and matches
  :data:`FUSION_PATTERNS` against consecutive runs. A match replaces the
  chain's records with ONE fused record whose FLOPs are the chain's sum
  and whose bytes follow the kernel-boundary IO model (intermediates stay
  on chip: they are neither written to nor re-read from HBM). The modeled
  eager backends charge one kernel-launch overhead per record, so an
  N-op chain collapsing to one record also drops N-1 launches.

* **Execution routing** (``repro_torch.nn`` under ``nn.fuse()``): the
  model zoo's fusable call sites (residual-add→norm, SwiGLU / GeGLU,
  rope, the QDQ epilogue, one-query decode attention) dispatch to the
  fused kernel-backed ops under the same ``ng:fused:`` tags the rewriter
  would emit.

Both are driven by :class:`FusionTransform`, a composable
:class:`~repro_torch.core.workload.Transform`, so
``workload.with_transform(FusionTransform())`` composes with
:class:`~repro_torch.core.workload.QuantizeDequantTransform` into the
paper's 2×2: bf16 / fused / int8-qdq / int8-qdq+fused.

Matching rules:

* runs must be **adjacent** in the record stream;
* every run must share the same **scope prefix** (the scope path outside
  the ``ng:`` tags);
* **dataflow** must connect: the consumer reads a tensor the producer
  wrote (the capture's tensor serials; the output shape among the
  consumer's input shapes for records that carry none);
* ``trip_count`` must agree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .graph import OpRecord, dtype_bytes
from .taxonomy import OpGroup, scope_tag

#: the prim name fused records carry (never a real op name)
FUSED_PRIM = "fused_kernel"


def _numel(shape) -> int:
    return math.prod(shape) if shape else 1


def _out_bytes(r: OpRecord) -> float:
    return float(sum(_numel(s) * dtype_bytes(d)
                     for s, d in zip(r.out_shapes, r.out_dtypes))
                 ) * r.trip_count


def _in_bytes(r: OpRecord) -> float:
    return max(r.bytes_accessed - _out_bytes(r), 0.0)


def scope_prefix(scope: str) -> str:
    """The name-stack path outside the ``ng:`` tags — the fusion boundary.

    ``"layer0/ng:elementwise:residual_add"`` -> ``"layer0"``;
    untagged scopes are their own prefix. Normalized (no trailing slash)
    so a tagged run and an untagged neighbor in the same user scope
    compare equal — softmax->argmax must fuse inside ``named_scope`` too.
    """
    i = scope.find("ng:")
    return (scope[:i] if i >= 0 else scope).rstrip("/")


@dataclasses.dataclass(frozen=True)
class FusionPattern:
    """One rewrite rule: a chain of (group, op_site) matchers.

    A single-site pattern is an *intra-site* collapse: the site's many
    ops (e.g. rope's sin/cos/mul/concat train) become one kernel
    launch; ``min_records`` keeps a 1-op site from being relabeled
    for nothing. Multi-site patterns fuse across operator boundaries.
    ``kernel`` names the backing entry of ``repro_torch.kernels.ops.KERNELS``
    (None for a chain no single kernel of the port computes: the record is
    modeled as one launch, as JAX models it).
    """

    name: str
    sites: Tuple[Tuple[OpGroup, str], ...]
    min_records: int = 1
    kernel: Optional[str] = None

    def __post_init__(self):
        if not self.sites:
            raise ValueError(f"pattern {self.name!r} has no site matchers")


#: tried in order per stream position — keep longer chains before their
#: sub-patterns (dequant→add→norm before add→norm before the norm collapse)
FUSION_PATTERNS: Tuple[FusionPattern, ...] = (
    # PR-3 QDQ epilogue: dequantize -> residual add -> norm, one pass
    FusionPattern("fused_dequant_add_rms_norm",
                  ((OpGroup.QUANT, "dequantize"),
                   (OpGroup.ELEMENTWISE, "residual_add"),
                   (OpGroup.NORMALIZATION, "rms_norm")),
                  kernel="dequant_add_rms_norm"),
    # residual add + following norm (every pre-norm block boundary)
    FusionPattern("fused_add_rms_norm",
                  ((OpGroup.ELEMENTWISE, "residual_add"),
                   (OpGroup.NORMALIZATION, "rms_norm")),
                  kernel="fused_add_rms_norm"),
    FusionPattern("fused_add_layer_norm",
                  ((OpGroup.ELEMENTWISE, "residual_add"),
                   (OpGroup.NORMALIZATION, "layer_norm")),
                  kernel="fused_add_layer_norm"),
    # QK-norm -> rotary application (qk_norm attention stacks); modeled
    # only — fused_rope covers the rotation but not the norm, so no
    # single kernel backs the whole chain yet
    FusionPattern("fused_rms_norm_rope",
                  ((OpGroup.NORMALIZATION, "rms_norm"),
                   (OpGroup.MEMORY, "apply_rope"))),
    # the QDQ round-trip itself (absmax/div/round/clamp/cast + cast/mul)
    FusionPattern("fused_qdq",
                  ((OpGroup.QUANT, "quantize"),
                   (OpGroup.QUANT, "dequantize"))),
    # silu(gate) * up split across two sites
    FusionPattern("fused_swiglu",
                  ((OpGroup.ACTIVATION, "silu"),
                   (OpGroup.ELEMENTWISE, "mul")),
                  kernel="swiglu"),
    # vision neck: bilinear upsample feeding the lateral/prior add (the
    # FPN-style merge every detector pays once per level) — one pass over
    # the upsampled map instead of write + re-read
    FusionPattern("fused_interpolate_add",
                  ((OpGroup.INTERPOLATION, "interpolate_bilinear"),
                   (OpGroup.ELEMENTWISE, "residual_add"))),
    # logit chain: softmax feeding greedy sampling
    FusionPattern("fused_softmax_sample",
                  ((OpGroup.LOGIT, "softmax"),
                   (OpGroup.REDUCTION, "argmax"))),
    # one-query decode attention: qk GEMM -> mask -> softmax -> pv GEMM
    # as ONE kernel-boundary record (decode_core, which nn.fused_attn_decode
    # launches). Prefill never matches: its softmax site is
    # "online_softmax", not "softmax".
    FusionPattern("fused_attn_decode",
                  ((OpGroup.GEMM, "attn_qk"),
                   (OpGroup.ELEMENTWISE, "attn_mask"),
                   (OpGroup.LOGIT, "softmax"),
                   (OpGroup.GEMM, "attn_pv")),
                  kernel="decode_core"),
    # intra-site collapses: one launch instead of the site's op train
    FusionPattern("fused_swiglu", ((OpGroup.ACTIVATION, "swiglu"),),
                  min_records=2, kernel="swiglu"),
    FusionPattern("fused_geglu", ((OpGroup.ACTIVATION, "geglu"),),
                  min_records=2, kernel="geglu"),
    FusionPattern("fused_rms_norm", ((OpGroup.NORMALIZATION, "rms_norm"),),
                  min_records=2, kernel="rms_norm"),
    FusionPattern("fused_layer_norm",
                  ((OpGroup.NORMALIZATION, "layer_norm"),),
                  min_records=2, kernel="layer_norm"),
    FusionPattern("fused_softmax", ((OpGroup.LOGIT, "softmax"),),
                  min_records=2),
    # the chunked-prefill online-softmax rescale train (max/exp/sum/mul
    # per KV chunk) — one launch per chunk, pure relabel like
    # fused_softmax (the attention kernels already execute it fused)
    FusionPattern("fused_online_softmax",
                  ((OpGroup.LOGIT, "online_softmax"),),
                  min_records=2),
    FusionPattern("fused_gelu", ((OpGroup.ACTIVATION, "gelu"),),
                  min_records=2),
    FusionPattern("fused_silu", ((OpGroup.ACTIVATION, "silu"),),
                  min_records=2),
    FusionPattern("fused_rope", ((OpGroup.MEMORY, "apply_rope"),),
                  min_records=2, kernel="rope"),
    # vision intra-site collapses: the bilinear gather/lerp train and the
    # detection head's box-decode elementwise train, one launch each
    FusionPattern("fused_interpolate",
                  ((OpGroup.INTERPOLATION, "interpolate_bilinear"),),
                  min_records=2),
    FusionPattern("fused_box_decode",
                  ((OpGroup.ELEMENTWISE, "box_decode"),),
                  min_records=2),
)


@dataclasses.dataclass
class FusionReport:
    """What the pass did — per-pattern fire counts and the traffic delta."""

    fired: Dict[str, int] = dataclasses.field(default_factory=dict)
    records_before: int = 0
    records_after: int = 0
    bytes_before: float = 0.0
    bytes_after: float = 0.0

    @property
    def n_fused(self) -> int:
        return sum(self.fired.values())

    @property
    def records_fused(self) -> int:
        return self.records_before - self.records_after

    def to_dict(self) -> dict:
        return {
            "fired": dict(self.fired),
            "records_before": self.records_before,
            "records_after": self.records_after,
            "bytes_before": self.bytes_before,
            "bytes_after": self.bytes_after,
        }


@dataclasses.dataclass
class _SiteRun:
    """Maximal run of adjacent records from one op-site occurrence."""

    group: OpGroup
    op_site: str
    scope: str
    trip_count: int
    records: List[OpRecord]
    start: int = 0          # stream position of the first record

    @property
    def prefix(self) -> str:
        return scope_prefix(self.scope)

    @property
    def stop(self) -> int:
        return self.start + len(self.records)


def _site_runs(records: Sequence[OpRecord]) -> List[_SiteRun]:
    runs: List[_SiteRun] = []
    for pos, r in enumerate(records):
        if runs and (runs[-1].group, runs[-1].op_site, runs[-1].scope,
                     runs[-1].trip_count) == (r.group, r.op_site, r.scope,
                                              r.trip_count):
            runs[-1].records.append(r)
        else:
            runs.append(_SiteRun(r.group, r.op_site, r.scope, r.trip_count,
                                 [r], start=pos))
    return runs


def _dataflow_connects(producer: _SiteRun, consumer: _SiteRun) -> bool:
    """True when the consumer actually reads something the producer made.

    Exact tensor-identity check when the capture recorded serials (it
    always does; synthetic records may not) — this is what keeps e.g. an
    MHA qk-norm stack's norm(k) from "fusing" with the adjacent rope(q)
    just because their shapes coincide. Shape overlap is the fallback.
    """
    out_ids = {i for r in producer.records for i in r.out_var_ids}
    in_ids = {i for r in consumer.records for i in r.in_var_ids}
    if out_ids and in_ids:
        return bool(out_ids & in_ids)
    last = producer.records[-1]
    first = consumer.records[0]
    return any(s in first.in_shapes for s in last.out_shapes)


def _match(runs: List[_SiteRun], i: int,
           pattern: FusionPattern) -> Optional[List[_SiteRun]]:
    n = len(pattern.sites)
    if i + n > len(runs):
        return None
    window = runs[i:i + n]
    prefix = window[0].prefix
    trip = window[0].trip_count
    for run, (group, site) in zip(window, pattern.sites):
        if run.group != group or run.op_site != site:
            return None
        if run.prefix != prefix or run.trip_count != trip:
            return None  # never fuse across a scope/loop boundary
    for a, b in zip(window, window[1:]):
        if not _dataflow_connects(a, b):
            return None
    if sum(len(r.records) for r in window) < max(pattern.min_records, n):
        return None
    return window


def find_fusable_chains(records: Sequence[OpRecord],
                        patterns: Optional[Sequence[FusionPattern]] = None
                        ) -> List[Tuple[FusionPattern, List[OpRecord]]]:
    """Enumerate every :data:`FUSION_PATTERNS` match in an op stream.

    Read-only twin of :func:`fuse_records` — same site-run grouping, same
    ``_match`` semantics (scope-prefix / trip-count / dataflow guards),
    greedy left-to-right with the same pattern precedence — but it only
    *reports* ``(pattern, chain_records)`` pairs instead of rewriting.
    On a correctly fused stream this returns ``[]``: anything it finds in
    a post-rewrite graph is a chain the fusion pass left on the table
    (nglint rule NG002).
    """
    patterns = FUSION_PATTERNS if patterns is None else tuple(patterns)
    runs = _site_runs(list(records))
    found: List[Tuple[FusionPattern, List[OpRecord]]] = []
    i = 0
    while i < len(runs):
        run = runs[i]
        if run.group == OpGroup.FUSED and len(run.records) > 1:
            # executed-fused site not yet collapsed to one launch
            found.append((FusionPattern(run.op_site,
                                        ((OpGroup.FUSED, run.op_site),),
                                        min_records=2),
                          list(run.records)))
            i += 1
            continue
        matched = None
        for p in patterns:
            window = _match(runs, i, p)
            if window is not None:
                matched = (p, window)
                break
        if matched is None:
            i += 1
            continue
        p, window = matched
        found.append((p, [r for w in window for r in w.records]))
        i += len(window)
    return found


def fused_bytes_model(records: Sequence[OpRecord],
                      live: Optional[Sequence[bool]] = None) -> float:
    """Kernel-boundary IO of a fused chain (analytic, deterministic).

    A *dead* intermediate — an output re-read only inside the chain —
    stays on chip: the fused kernel neither writes nor re-reads it, so it
    drops out of the HBM traffic twice. A *live* intermediate (consumed
    downstream of the chain, e.g. the residual stream the add→norm
    kernels explicitly write back as their second output) must still be
    materialized: only its in-chain re-read is saved. ``live[i]`` flags
    record ``i``'s outputs as externally consumed (all-dead when absent —
    the final record is never an intermediate). Floored at "read the
    widest operand once + write the results": a fused kernel can never
    move less than its own IO.
    """
    total = sum(r.bytes_accessed for r in records)
    live = [False] * len(records) if live is None else list(live)
    saved = live_out = 0.0
    for r, is_live in zip(records[:-1], live[:-1]):
        ob = _out_bytes(r)
        saved += ob if is_live else 2.0 * ob
        live_out += ob if is_live else 0.0
    floor = _out_bytes(records[-1]) + live_out \
        + max(_in_bytes(r) for r in records)
    return max(total - saved, floor)


def _fused_record(name: str, window: List[_SiteRun], index: int,
                  kernel: Optional[str],
                  live: Optional[Sequence[bool]] = None) -> OpRecord:
    recs = [r for run in window for r in run.records]
    first, last = recs[0], recs[-1]
    # the /c<index> marker mirrors the execution path's per-invocation
    # scope marker: adjacent same-pattern launches stay distinct runs, so
    # re-grouping a rewritten stream never merges two separate launches
    tag = scope_tag(OpGroup.FUSED, name) + f"/c{index}"
    return OpRecord(
        index=index, prim=FUSED_PRIM, group=OpGroup.FUSED, op_site=name,
        scope=(window[0].prefix + tag), in_shapes=first.in_shapes,
        in_dtypes=first.in_dtypes, out_shapes=last.out_shapes,
        out_dtypes=last.out_dtypes,
        flops=float(sum(r.flops for r in recs)),
        bytes_accessed=fused_bytes_model(recs, live=live),
        trip_count=window[0].trip_count,
        params={"fused_sites": [run.op_site for run in window],
                "fused_records": len(recs),
                "kernel": kernel},
    )


def fuse_records(records: Sequence[OpRecord],
                 patterns: Optional[Sequence[FusionPattern]] = None
                 ) -> Tuple[List[OpRecord], FusionReport]:
    """Apply the fusion pass to a captured op stream.

    Returns the rewritten stream (indices renumbered, order preserved) and
    a :class:`FusionReport`. Records already tagged ``fused`` by the
    ``nn.fuse()`` execution path are collapsed to one launch each — the
    rewriter and the executor agree on what a fused op costs.
    """
    patterns = FUSION_PATTERNS if patterns is None else tuple(patterns)
    stream = list(records)
    runs = _site_runs(stream)
    # serial -> stream positions that read it, for intermediate liveness: an
    # in-chain output also consumed OUTSIDE the chain must still be
    # written to HBM by the fused kernel (fused_bytes_model)
    readers: Dict[int, List[int]] = {}
    for pos, r in enumerate(stream):
        for vid in r.in_var_ids:
            readers.setdefault(vid, []).append(pos)

    def _liveness(window: List[_SiteRun]) -> List[bool]:
        lo, hi = window[0].start, window[-1].stop
        recs = [r for run in window for r in run.records]
        return [any(p < lo or p >= hi
                    for vid in r.out_var_ids
                    for p in readers.get(vid, ()))
                for r in recs]

    out: List[OpRecord] = []
    report = FusionReport(records_before=len(stream),
                          bytes_before=sum(r.bytes_accessed
                                           for r in stream))
    i = 0
    while i < len(runs):
        run = runs[i]
        # an executed-fused site (ng:fused: tag from nn.fuse()) is one
        # kernel launch no matter how many ops its plain twin dispatches
        if run.group == OpGroup.FUSED and len(run.records) > 1:
            out.append(_fused_record(run.op_site, [run], len(out), None,
                                     live=_liveness([run])))
            report.fired[run.op_site] = report.fired.get(run.op_site, 0) + 1
            i += 1
            continue
        matched = None
        for p in patterns:
            window = _match(runs, i, p)
            if window is not None:
                matched = (p, window)
                break
        if matched is None:
            for r in run.records:
                out.append(dataclasses.replace(r, index=len(out)))
            i += 1
            continue
        p, window = matched
        out.append(_fused_record(p.name, window, len(out), p.kernel,
                                 live=_liveness(window)))
        report.fired[p.name] = report.fired.get(p.name, 0) + 1
        i += len(window)
    report.records_after = len(out)
    report.bytes_after = sum(r.bytes_accessed for r in out)
    return out, report


def fusion_report(fn: Callable, *args, **kwargs) -> FusionReport:
    """Capture ``fn`` and report what the fusion pass would do to it."""
    from .graph import capture

    _, report = fuse_records(capture(fn, *args, **kwargs))
    return report


# ---------------------------------------------------------------------------
# The composable workload transform
# ---------------------------------------------------------------------------

from .workload import Transform  # noqa: E402  (no cycle: workload never imports fusion)


class FusionTransform(Transform):
    """Route a workload through the operator-fusion subsystem.

    * **wrap** — the built callable runs under ``repro_torch.nn.fuse()``:
      the model zoo's fusable sites execute their fused ops under
      ``ng:fused:`` tags, on the card through the hand-written kernels.
      This is the same path the serving engine's ``Engine(fused=True)``
      decode step takes.
    * **rewrite_records** — the captured stream additionally goes through
      :func:`fuse_records`, so chains the call sites cannot see (e.g. the
      cross-block add→norm pair, softmax→argmax logit chains, the QDQ
      round-trips) fuse in the modeled eager views as well.

    Composes with ``QuantizeDequantTransform`` in either order; the
    canonical 2×2 is bf16 / fused / int8-qdq / int8-qdq+fused.
    """

    name = "fused"

    def __init__(self, patterns: Optional[Sequence[FusionPattern]] = None):
        self.patterns = None if patterns is None else tuple(patterns)

    def wrap(self, fn: Callable, workload) -> Callable:
        def fused(*args, **kwargs):
            from repro_torch import nn
            with nn.fuse():
                return fn(*args, **kwargs)

        return fused

    def rewrite_records(self, records, workload):
        fused, _ = fuse_records(records, patterns=self.patterns)
        return fused
