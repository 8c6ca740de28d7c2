"""The built-in nglint rules (NG001–NG009) over the port's captures.

The port of ``repro.analysis.builtin``: each rule keeps JAX's id, title,
severity and scope, and polices the same invariant of the port's records
(:class:`~repro_torch.core.graph.OpRecord`: aten ops and ``repro_torch::``
kernel ops, bytes from the real tensors, dtypes as ``str(torch.dtype)``):

====== ===================================================================
NG001  every untagged captured op has an explicit entry in the aten table
       (``core/taxonomy.py``) or is a kernel of the package (no silent
       ``OpGroup.OTHER`` fallback)
NG002  the fusion rewriter leaves no matchable ``FUSION_PATTERNS`` chain
       in a post-rewrite graph
NG003  tagged low-precision sites do not leak f32 intermediates into the
       surrounding dataflow (dtypes compared without the ``torch.``
       prefix)
NG004  quantize→dequantize round-trips feed a GEMM, and no untagged
       ``aten._to_copy`` X→Y is undone by its only reader
NG005  the kernel specs are sound: fusion patterns name real kernels,
       every spec's op is registered with a fake, has a plain version and
       sources ``_build`` compiles, is counted in ``ops.launches``, and
       declares its partial-tile handling; every attention entry has a spec
NG006  no zero-FLOP / zero-byte records (estimator holes in
       ``estimate_flops`` / the record's byte count)
NG007  scope-tag discipline: every ``ng:`` tag in a captured scope parses
       back to a known operator group
NG008  per-group modeled shares stay within tolerance of the committed
       baseline (``repro_torch/analysis/analysis_baseline.json``)
NG009  the paged-KV bookkeeping ops classify as ``OpGroup.MEMORY`` with
       nonzero bytes
====== ===================================================================

JAX's NG010 (the tensor-parallel collectives ``nn.tp_psum`` /
``nn.tp_vocab_gather``) has no port yet: the port has no tensor-parallel
serving to capture. Rules are registered on import
(``repro_torch.analysis`` imports this module).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import fusion as _fusion
from repro_torch.core import taxonomy as _tax
from repro_torch.core.graph import OpRecord
from repro_torch.core.taxonomy import OpGroup, parse_scope

from .rules import AnalysisContext, Finding, rule, static_device

#: dtypes whose presence marks a record as low-precision dataflow (NG003),
#: JAX's names; the port's ``"torch.bfloat16"`` is read without its prefix
LOW_PRECISION_DTYPES = frozenset({
    "bfloat16", "float16",
    "float8_e4m3fn", "float8_e5m2", "float8_e4m3b11_fnuz",
    "float8_e4m3", "float8_e5m2fnuz", "float8_e4m3fnuz",
    "float4_e2m1fn",
})

#: structural groups whose ops always do arithmetic — a 0-FLOP record in
#: one of these is an ``estimate_flops`` hole, not a memory op (NG006)
COMPUTE_GROUPS = frozenset({
    OpGroup.GEMM, OpGroup.ELEMENTWISE, OpGroup.ACTIVATION,
    OpGroup.NORMALIZATION, OpGroup.REDUCTION,
})

#: the op of an untagged cast (JAX: ``convert_element_type``)
CAST_OP = "aten._to_copy"


def dtype_name(dtype) -> str:
    """A record's dtype string without the ``torch.`` prefix: JAX's name."""
    return str(dtype).removeprefix("torch.")


def _readers(records: Sequence[OpRecord]) -> Dict[int, List[int]]:
    """var id -> stream positions that read it."""
    readers: Dict[int, List[int]] = {}
    for pos, r in enumerate(records):
        for vid in r.in_var_ids:
            readers.setdefault(vid, []).append(pos)
    return readers


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


# ---------------------------------------------------------------------------
# NG001 — unknown primitive binned to OTHER
# ---------------------------------------------------------------------------

@rule("NG001", "unknown primitive binned to OpGroup.OTHER",
      severity="error")
def check_unknown_primitives(ctx: AnalysisContext):
    seen: set = set()
    for r in ctx.records:
        if r.group is not OpGroup.OTHER or r.prim in seen:
            continue
        if parse_scope(r.scope) is not None:
            continue  # deliberately tagged ng:other:<site>
        if _tax.is_known_primitive(r.prim):
            continue
        seen.add(r.prim)
        yield Finding(
            rule="NG001", severity="error", workload=ctx.key,
            where=f"{r.prim} @ {r.scope or '<toplevel>'}",
            message=f"primitive {r.prim!r} has no taxonomy entry and fell "
                    "through to OpGroup.OTHER — its latency is untracked "
                    "in every per-group share",
            fix_hint="register it via _reg(...) in "
                     "repro_torch/core/taxonomy.py (see UNKNOWN_PRIMS for "
                     "occurrence counts)")


# ---------------------------------------------------------------------------
# NG002 — fusable chain left in a post-rewrite graph
# ---------------------------------------------------------------------------

@rule("NG002", "matchable FUSION_PATTERNS chain left unfused",
      severity="error")
def check_unfused_chains(ctx: AnalysisContext):
    if not ctx.fused:
        return  # only a fused variant promises a fully-rewritten stream
    for pattern, chain in _fusion.find_fusable_chains(ctx.rewritten):
        first = chain[0]
        yield Finding(
            rule="NG002", severity="error", workload=ctx.key,
            where=f"{pattern.name} @ {first.scope or '<toplevel>'}",
            message=f"chain of {len(chain)} record(s) matching fusion "
                    f"pattern {pattern.name!r} survived the rewrite "
                    f"(sites: {[s for _, s in pattern.sites]})",
            fix_hint="the FusionTransform pattern list is narrower than "
                     "FUSION_PATTERNS, or fuse_records skipped the match; "
                     "re-run with the full pattern set")


# ---------------------------------------------------------------------------
# NG003 — f32 leaking out of a low-precision tagged site
# ---------------------------------------------------------------------------

@rule("NG003", "f32 intermediate leaks out of a low-precision site",
      severity="warning")
def check_dtype_drift(ctx: AnalysisContext):
    records = ctx.records
    readers = _readers(records)
    reported: set = set()
    for r in records:
        if parse_scope(r.scope) is None:
            continue  # only tagged sites carry the cast-back contract
        if not any(dtype_name(d) in LOW_PRECISION_DTYPES
                   for d in r.in_dtypes):
            continue
        for vid, dtype in zip(r.out_var_ids, r.out_dtypes):
            if dtype_name(dtype) != "float32":
                continue
            for pos in readers.get(vid, ()):
                c = records[pos]
                if (c.group, c.op_site) == (r.group, r.op_site):
                    continue  # still inside the site
                key = (r.group, r.op_site, c.op_site)
                if key in reported:
                    continue
                reported.add(key)
                yield Finding(
                    rule="NG003", severity="warning", workload=ctx.key,
                    where=f"{r.op_site} -> {c.op_site} @ {r.scope}",
                    message=f"{r.op_site} ({r.group.value}) takes "
                            "low-precision inputs but hands a float32 "
                            f"result to {c.op_site} — the site dropped "
                            "its cast-back and doubles downstream traffic",
                    fix_hint="cast the site's result back to the input "
                             "dtype (the interpolate_bilinear fix in "
                             "repro_torch/nn)")


# ---------------------------------------------------------------------------
# NG004 — cancelling quantize→dequantize round-trips
# ---------------------------------------------------------------------------

@rule("NG004", "quantize->dequantize round-trip feeds no GEMM",
      severity="warning")
def check_cancelling_qdq(ctx: AnalysisContext):
    records = ctx.records
    readers = _readers(records)
    # tagged fake-quant sites: every dequantize run must feed a GEMM
    for run in _fusion._site_runs(records):
        if (run.group, run.op_site) != (OpGroup.QUANT, "dequantize"):
            continue
        lo, hi = run.start, run.stop
        outside = sorted({
            pos
            for r in run.records
            for vid in r.out_var_ids
            for pos in readers.get(vid, ())
            if pos < lo or pos >= hi
        })
        if not outside:
            yield Finding(
                rule="NG004", severity="warning", workload=ctx.key,
                where=f"dequantize @ {run.scope}",
                message="dequantize result is never consumed by another "
                        "op — the quantize->dequantize pair is pure "
                        "cancelling overhead",
                fix_hint="drop the fake-quant wrapper at this site or "
                         "feed the dequantized value into the GEMM it "
                         "was meant for")
        elif not any(records[p].group in (OpGroup.GEMM, OpGroup.FUSED)
                     for p in outside):
            consumers = sorted({records[p].op_site for p in outside})
            yield Finding(
                rule="NG004", severity="warning", workload=ctx.key,
                where=f"dequantize @ {run.scope}",
                message="dequantize feeds only non-GEMM consumers "
                        f"({consumers}) — QDQ outside a fake-quant GEMM "
                        "site cancels out and only adds QUANT-group "
                        "latency",
                fix_hint="fake_quant wraps GEMM operands (nn.linear / "
                         "nn.einsum / nn.conv2d); remove stray "
                         "quantize/dequantize calls elsewhere")
    # untagged cast round-trips: _to_copy X->Y feeding only _to_copy Y->X
    for r in records:
        if r.prim != CAST_OP or not r.in_dtypes:
            continue
        if parse_scope(r.scope) is not None:
            continue  # tagged sites are policed above / by NG003
        src = dtype_name(r.in_dtypes[0])
        for vid in r.out_var_ids:
            consumer_pos = readers.get(vid, ())
            if len(consumer_pos) != 1:
                continue
            c = records[consumer_pos[0]]
            if (c.prim == CAST_OP and c.out_dtypes
                    and dtype_name(c.out_dtypes[0]) == src
                    and parse_scope(c.scope) is None):
                yield Finding(
                    rule="NG004", severity="warning", workload=ctx.key,
                    where=f"{CAST_OP} @ {r.scope or '<toplevel>'}",
                    message=f"cast {src} -> "
                            f"{dtype_name(r.out_dtypes[0])} is undone "
                            "immediately by the only consumer "
                            "(cast back) — a cancelling round-trip",
                    fix_hint="delete both casts or keep the intermediate "
                             "in one dtype")


# ---------------------------------------------------------------------------
# NG005 — kernel spec soundness (static)
# ---------------------------------------------------------------------------

#: how a spec may make a partial last tile legal (``KernelSpec``)
REMAINDER_HANDLING = ("mask",)


def _has_fake(qualname: str) -> bool:
    """Whether ``qualname`` (``repro_torch::rms_norm``) has a fake
    implementation: the capture and ``torch.compile`` see the launch
    through it."""
    from torch._library import simple_registry

    entry = simple_registry.singleton.find(qualname)
    impl = getattr(entry, "fake_impl", None) or getattr(
        entry, "abstract_impl", None)
    return impl is not None and impl.kernel is not None


def _spec_findings(name: str, spec) -> List[Tuple[str, str]]:
    """(message, fix hint) of each fault of one ``KernelSpec``."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as kops

    out = []
    if not hasattr(torch.ops.repro_torch, spec.op):
        out.append((f"kernel {name!r} names op {spec.qualname!r}, which is "
                    "not registered — no call reaches the kernel",
                    "register the wrapper with torch.library.custom_op "
                    "in repro_torch/kernels/ops.py"))
    elif not _has_fake(spec.qualname):
        out.append((f"op {spec.qualname!r} has no fake implementation — "
                    "the capture and torch.compile cannot see the launch "
                    "as one call",
                    "add @<op>.register_fake beside the wrapper in "
                    "repro_torch/kernels/ops.py"))
    if not callable(spec.plain):
        out.append((f"kernel {name!r} has no plain version — the wrapper "
                    "has nothing to run on CPU tensors and the kernel "
                    "nothing to be held against",
                    "name its repro_torch/kernels/ref.py function"))
    built = {p.name for p in _build.sources()}
    missing = [s for s in spec.sources if s not in built]
    if not spec.sources or missing:
        out.append((f"kernel {name!r} names sources {missing or '()'} "
                    "that _build does not compile",
                    "name the kernel's csrc/*.cu files"))
    if name not in kops.launches:
        out.append((f"kernel {name!r} is not counted in ops.launches — "
                    "its launches on a main path cannot be shown",
                    "add it to repro_torch/kernels/ops.KERNELS and count "
                    "it with _count(...) where the wrapper launches"))
    if spec.handles_remainder not in REMAINDER_HANDLING:
        out.append((f"kernel {name!r} declares no partial-tile handling "
                    f"({spec.handles_remainder!r}) — an operand dim that "
                    "no tile divides would read or write out of bounds",
                    f"declare one of {REMAINDER_HANDLING} in its "
                    "KernelSpec"))
    return out


@rule("NG005", "Pallas kernel spec soundness", severity="error",
      scope="static")
def check_kernel_specs(_ctx: Optional[AnalysisContext]):
    from repro_torch.kernels import attn_template as _tmpl
    from repro_torch.kernels.ops import KERNEL_SPECS

    # every FUSION_PATTERNS kernel= name must resolve to a real kernel
    for p in _fusion.FUSION_PATTERNS:
        if p.kernel is not None and p.kernel not in KERNEL_SPECS:
            yield Finding(
                rule="NG005", severity="error", workload="static",
                where=f"FUSION_PATTERNS:{p.name}",
                message=f"pattern {p.name!r} claims kernel {p.kernel!r} "
                        "but repro_torch.kernels.ops.KERNEL_SPECS has no "
                        "such entry — the fused record models a launch "
                        "that cannot execute",
                fix_hint="add the kernel to KERNEL_SPECS or fix the "
                         "pattern's kernel= name")
    for name, spec in KERNEL_SPECS.items():
        for message, hint in _spec_findings(name, spec):
            yield Finding(rule="NG005", severity="error", workload="static",
                          where=f"kernel:{name}", message=message,
                          fix_hint=hint)
    # every attention launch entry must have a spec: an entry without one
    # would launch without any of the static vetting above
    for entry in _tmpl.ENTRIES:
        if not callable(getattr(_tmpl, entry, None)) \
                or entry not in KERNEL_SPECS:
            yield Finding(
                rule="NG005", severity="error", workload="static",
                where=f"attn_template:{entry}",
                message=f"attention entry {entry!r} has no launch function "
                        "or no repro_torch.kernels.ops.KERNEL_SPECS entry "
                        "— the variant escapes static vetting",
                fix_hint="add a KernelSpec for it (and its wrapper in "
                         "repro_torch/kernels/ops.py)")


# ---------------------------------------------------------------------------
# NG006 — zero-FLOP / zero-byte records (estimator holes)
# ---------------------------------------------------------------------------

@rule("NG006", "zero-FLOP / zero-byte record (estimator hole)",
      severity="warning")
def check_estimator_holes(ctx: AnalysisContext):
    seen: set = set()
    for r in ctx.rewritten:
        out_numel = sum(_numel(s) for s in r.out_shapes)
        if out_numel == 0:
            continue  # produces nothing (e.g. a zero-width slice):
            # zero bytes / zero flops is the correct estimate
        structural = _tax.lookup_primitive(r.prim)
        hole = None
        if r.bytes_accessed <= 0.0:
            hole = "bytes_accessed == 0"
        elif structural in COMPUTE_GROUPS and r.flops <= 0.0:
            hole = f"flops == 0 for a {structural.value} primitive"
        if hole is None or (r.prim, hole) in seen:
            continue
        seen.add((r.prim, hole))
        yield Finding(
            rule="NG006", severity="warning", workload=ctx.key,
            where=f"{r.prim} @ {r.scope or '<toplevel>'}",
            message=f"record {r.index} ({r.prim}, "
                    f"{r.group.value}): {hole} — the roofline model "
                    "assigns this op no cost, so its latency vanishes "
                    "from every share",
            fix_hint="extend estimate_flops in repro_torch/core/graph.py, "
                     "or the byte count of _record there, to cover this "
                     "op")


# ---------------------------------------------------------------------------
# NG007 — scope-tag discipline
# ---------------------------------------------------------------------------

@rule("NG007", "unresolvable ng: scope tag", severity="error")
def check_scope_tags(ctx: AnalysisContext):
    seen: set = set()
    for r in ctx.records:
        if "ng:" not in r.scope or parse_scope(r.scope) is not None:
            continue
        if r.scope in seen:
            continue
        seen.add(r.scope)
        yield Finding(
            rule="NG007", severity="error", workload=ctx.key,
            where=r.scope,
            message="scope carries an ng: tag the taxonomy cannot parse "
                    "— the record silently falls back to primitive "
                    "classification and the site's latency scatters "
                    "across structural groups",
            fix_hint="emit tags via taxonomy.scope_tag(group, name) "
                     "(group must be an OpGroup value, name "
                     "[A-Za-z0-9_.-]+)")


# ---------------------------------------------------------------------------
# NG008 — per-group share drift vs the committed baseline
# ---------------------------------------------------------------------------

@rule("NG008", "per-group share drift vs committed baseline",
      severity="warning")
def check_share_drift(ctx: AnalysisContext):
    if not ctx.baseline_shares:
        return  # no committed entry for this workload/variant yet
    tol = ctx.share_tolerance
    groups = set(ctx.group_shares) | set(ctx.baseline_shares)
    for g in sorted(groups):
        new = ctx.group_shares.get(g, 0.0)
        old = ctx.baseline_shares.get(g, 0.0)
        if abs(new - old) <= tol:
            continue
        yield Finding(
            rule="NG008", severity="warning", workload=ctx.key,
            where=f"group:{g}",
            message=f"modeled {g} share moved {old:.1%} -> {new:.1%} "
                    f"(|Δ| {abs(new - old):.1%} > tolerance {tol:.1%}) "
                    "vs repro_torch/analysis/analysis_baseline.json",
            fix_hint="if intentional, regenerate the baseline on the card "
                     "with `python -m repro_torch.analyze --all "
                     "--write-baseline`")


# ---------------------------------------------------------------------------
# NG009 — paged-KV bookkeeping ops land in MEMORY with nonzero bytes (static)
# ---------------------------------------------------------------------------

@rule("NG009", "paged-KV bookkeeping ops classify as MEMORY with bytes",
      severity="error", scope="static")
def check_paged_kv_ops(_ctx: Optional[AnalysisContext]):
    """Captures the paged serving ops on tiny tensors on the analysis
    device (:func:`~repro_torch.analysis.rules.static_device`) and asserts
    every tagged record lands in ``OpGroup.MEMORY`` with bytes > 0 — if the
    block-table gather/scatter bookkeeping ever falls out of MEMORY (or
    counts zero traffic), the traffic section's "NonGEMM share of serving"
    silently underreports."""
    import torch

    from repro_torch import nn
    from repro_torch.core.graph import capture

    dev = torch.device(static_device())
    pool = torch.zeros((4, 2, 3), device=dev)          # (blocks, bs, d)
    table = torch.tensor([[1, 2]], dtype=torch.int32, device=dev)
    row = torch.tensor([1, 2], dtype=torch.int32, device=dev)
    sites = (
        ("paged_kv_gather", lambda p, t: nn.paged_kv_gather(p, t, 4),
         (pool, table)),
        ("paged_kv_write", nn.paged_kv_write,
         (pool, torch.ones((1, 1, 3), device=dev), table,
          torch.tensor([1], dtype=torch.int32, device=dev))),
        ("paged_kv_scatter", nn.paged_kv_scatter,
         (pool, torch.ones((2, 3), device=dev), row, 0, 0, 2)),
    )
    for site, fn, args in sites:
        tagged = [r for r in capture(fn, *args) if r.op_site == site]
        where = f"nn.{site}"
        if not tagged:
            yield Finding(
                rule="NG009", severity="error", workload="static",
                where=where,
                message=f"no captured record carries op_site {site!r} — "
                        "the op lost its taxonomy tag and its latency "
                        "scatters across structural groups",
                fix_hint="keep the @tagged(OpGroup.MEMORY, ...) decorator "
                         "on the op in repro_torch/nn")
            continue
        off_group = sorted({r.prim for r in tagged
                            if r.group is not OpGroup.MEMORY})
        if off_group:
            yield Finding(
                rule="NG009", severity="error", workload="static",
                where=where,
                message=f"record(s) {off_group} inside the {site!r} site "
                        "classify outside OpGroup.MEMORY — paged "
                        "bookkeeping must be attributed to MEMORY for the "
                        "serving NonGEMM share",
                fix_hint="tag the op with OpGroup.MEMORY (repro_torch/nn)")
        if sum(r.bytes_accessed for r in tagged) <= 0.0:
            yield Finding(
                rule="NG009", severity="error", workload="static",
                where=where,
                message=f"{site!r} records model zero bytes_accessed — "
                        "the gather/scatter traffic vanishes from every "
                        "roofline and share",
                fix_hint="the byte count of _record in "
                         "repro_torch/core/graph.py covers the op's tensors")


#: Mapping rule id -> short description, for docs / --list-rules
def rule_catalog() -> List[Tuple[str, str, str]]:
    from .rules import all_rules

    return [(r.id, r.severity, r.title) for r in all_rules()]
