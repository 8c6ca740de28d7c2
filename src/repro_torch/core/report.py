"""Post-processing: aggregate profiles into the paper's tables & figures.

A copy of ``repro.core.report`` over the port's
:class:`~repro_torch.core.profiler.ModelProfile` (a test holds every
renderer's text to the original's on the same inputs). Everything renders
as aligned text / CSV. The verdict lines of the fusion, vision and
platforms renderers read the shared gates of ``repro_torch.bench.schema``.
:func:`render_artifact` renders a whole bench artifact
(``repro_torch.bench``). One renderer differs by design:
:func:`render_kernel_rows` reads the port's kernel-site rows
(``eager_mb``, ``kernel_mb``, ``eager_over_kernel``), where JAX's reads
its XLA and Pallas byte counts.
"""

from __future__ import annotations

import io
from typing import Iterable, Sequence

from .profiler import ModelProfile
from .taxonomy import OpGroup

GROUP_ORDER = [
    OpGroup.GEMM, OpGroup.NORMALIZATION, OpGroup.ACTIVATION, OpGroup.MEMORY,
    OpGroup.ELEMENTWISE, OpGroup.LOGIT, OpGroup.QUANT, OpGroup.FUSED,
    OpGroup.ROI, OpGroup.INTERPOLATION, OpGroup.REDUCTION,
    OpGroup.COLLECTIVE, OpGroup.CONTROL, OpGroup.OTHER,
]


def _fmt_pct(x: float) -> str:
    return f"{100.0 * x:5.1f}%"


def profile_row(p: ModelProfile) -> dict:
    """Serialize the share-bearing view of a ModelProfile — the row format
    every breakdown/opgroups renderer (and the bench artifact) consumes."""
    total = p.total_seconds or 1.0
    split = p.split
    row = {
        "case": p.name,
        "mode": p.mode,
        "total_s": p.total_seconds,
        "gemm_frac": split["gemm_frac"],
        "nongemm_frac": split["nongemm_frac"],
        "group_fracs": {g.value: p.group_seconds.get(g.value, 0.0) / total
                        for g in GROUP_ORDER},
        "n_ops": p.n_ops,
    }
    if p.compiled is not None:
        # the compiled view: how busy the device was over the call, and
        # the kernels no origin gave a group
        row.update(p.compiled,
                   busy_frac=p.total_seconds / p.compiled["wall_s"],
                   other_kernels=sorted(k for g, k in p.op_seconds
                                        if g == OpGroup.OTHER.value))
    return row


def breakdown_table(profiles: Sequence[ModelProfile]) -> str:
    """Fig 1/5/8/10 analogue: GEMM vs NonGEMM share per (model, mode)."""
    return render_breakdown_table(profile_row(p) for p in profiles)


def group_table(profiles: Sequence[ModelProfile]) -> str:
    """Fig 9/11/12 analogue: per-operator-group share of total latency."""
    return render_group_rows(profile_row(p) for p in profiles)


def top_group_table(profiles: Sequence[ModelProfile]) -> str:
    """Table 5 analogue: most expensive NonGEMM group per model."""
    rows = []
    for p in profiles:
        tops = p.top_nongemm_groups(k=1)
        if tops:
            g, _t, pct = tops[0]
            row = profile_row(p)
            row.update(top_group=g, top_pct=pct)
            rows.append(row)
    return render_top_rows(rows)


def breakdown_csv(profiles: Sequence[ModelProfile]) -> str:
    return render_breakdown_csv(profile_row(p) for p in profiles)


def shift_summary(cpu_profiles: Sequence[ModelProfile],
                  acc_profiles: Sequence[ModelProfile]) -> str:
    """The headline claim (paper §4.5): NonGEMM share CPU->accelerated.

    The paper reports 27% (CPU) -> 55% (GPU) averaged over its zoo.
    """
    def avg(ps):
        fr = [p.split["nongemm_frac"] for p in ps]
        return sum(fr) / len(fr) if fr else 0.0

    a, b = avg(cpu_profiles), avg(acc_profiles)
    return (f"average NonGEMM share: eager/cpu {100*a:.1f}%  ->  "
            f"accelerated {100*b:.1f}%   "
            f"(paper: 27% -> 55%; direction {'REPRODUCED' if b > a else 'NOT reproduced'})\n")


# ---------------------------------------------------------------------------
# Renderers over the machine-readable bench artifact (repro.bench.schema).
#
# The JSON artifact is the source of truth; these turn its per-section rows
# back into the aligned-text tables above, so humans and CI read identical
# numbers.  Row formats are documented in repro/bench/schema.py.
# ---------------------------------------------------------------------------

def render_breakdown_table(rows: Iterable[dict]) -> str:
    """The share table alone (no cross-mode summaries)."""
    buf = io.StringIO()
    buf.write(f"{'model':<28} {'mode':<22} {'total':>12} "
              f"{'GEMM%':>7} {'NonGEMM%':>9}\n")
    for r in rows:
        buf.write(f"{r['case']:<28} {r['mode']:<22} "
                  f"{r['total_s']*1e3:>10.3f}ms "
                  f"{_fmt_pct(r['gemm_frac']):>7} "
                  f"{_fmt_pct(r['nongemm_frac']):>9}\n")
    return buf.getvalue()


def render_breakdown_rows(rows: Iterable[dict]) -> str:
    rows = list(rows)
    buf = io.StringIO()
    buf.write(render_breakdown_table(rows))

    def avg(mode_prefix):
        fr = [r["nongemm_frac"] for r in rows
              if r["mode"].startswith(mode_prefix)]
        return sum(fr) / len(fr) if fr else None

    cpu, acc, comp = avg("eager_cpu"), avg("eager_a100"), avg("accelerated")
    if cpu is not None and acc is not None:
        buf.write(f"\naverage NonGEMM share: eager/cpu {100*cpu:.1f}%  ->  "
                  f"accelerated {100*acc:.1f}%   (paper: 27% -> 55%; "
                  f"direction "
                  f"{'REPRODUCED' if acc > cpu else 'NOT reproduced'})\n")
    if comp is not None and acc is not None:
        buf.write(f"beyond-paper: XLA-fused TPU roofline pulls the average "
                  f"NonGEMM share back to {100*comp:.1f}% "
                  f"(from {100*acc:.1f}% eager-accelerated)\n")
    # the port's compiled view: measured, beside the eager measured rows of
    # the same device
    for dev, eager_mode in (("cuda", "measured_cuda"), ("cpu", "eager_cpu")):
        torch_comp, eager = avg(f"compiled_{dev}"), avg(eager_mode)
        if torch_comp is None:
            continue
        busy = [r["busy_frac"] for r in rows
                if r["mode"] == f"compiled_{dev}" and "busy_frac" in r]
        buf.write(f"beyond-paper: torch.compile-fused, measured on {dev}: "
                  f"average NonGEMM share {100*torch_comp:.1f}%"
                  + (f" (from {100*eager:.1f}% eager measured)"
                     if eager is not None else "")
                  + (f", device busy {100*sum(busy)/len(busy):.1f}% of the "
                     f"compiled call" if busy else "") + "\n")
    return buf.getvalue()


def render_breakdown_csv(rows: Iterable[dict]) -> str:
    lines = ["model,mode,total_s,gemm_frac,nongemm_frac," +
             ",".join(g.value for g in GROUP_ORDER)]
    for r in rows:
        lines.append(
            f"{r['case']},{r['mode']},{r['total_s']:.6e},"
            f"{r['gemm_frac']:.4f},{r['nongemm_frac']:.4f}," +
            ",".join(f"{r['group_fracs'].get(g.value, 0.0):.4f}"
                     for g in GROUP_ORDER))
    return "\n".join(lines) + "\n"


def render_group_rows(rows: Iterable[dict]) -> str:
    buf = io.StringIO()
    cols = [g.value[:8] for g in GROUP_ORDER]
    buf.write(f"{'model':<28} {'mode':<22} " +
              " ".join(f"{c:>8}" for c in cols) + "\n")
    for r in rows:
        fracs = r.get("group_fracs", {})
        buf.write(f"{r['case']:<28} {r['mode']:<22} " +
                  " ".join(f"{100*fracs.get(g.value, 0.0):>7.1f}%"
                           for g in GROUP_ORDER) + "\n")
    return buf.getvalue()


def render_top_rows(rows: Iterable[dict]) -> str:
    buf = io.StringIO()
    buf.write(f"{'model':<28} {'mode':<22} {'top NonGEMM group':<18} "
              f"{'% of exec time':>14}\n")
    for r in rows:
        buf.write(f"{r['case']:<28} {r['mode']:<22} {r['top_group']:<18} "
                  f"{r['top_pct']:>13.1f}%\n")
    return buf.getvalue()


def render_micro_rows(rows: Iterable[dict]) -> str:
    buf = io.StringIO()
    buf.write(f"{'operator':<18} {'group':<14} {'shape':<22} "
              f"{'jit_us':>10} {'eager_us':>10} {'tpu_model_us':>12}\n")
    for r in rows:
        shape = tuple(r["shape"])
        buf.write(f"{r['operator']:<18} {r['group']:<14} {str(shape):<22} "
                  f"{r['jit_us']:>10.1f} {r.get('eager_us', 0.0):>10.1f} "
                  f"{r['tpu_model_us']:>12.2f}\n")
    return buf.getvalue()


def render_kernel_rows(rows: Iterable[dict]) -> str:
    """§4.5 kernel sites: the eager chain's traffic against the
    hand-written kernel's boundary traffic, and its allclose."""
    buf = io.StringIO()
    buf.write(f"{'kernel site':<20} {'eager_MB':>9} {'kernel_MB':>10} "
              f"{'eager/kernel':>13} {'allclose':>9}\n")
    for r in rows:
        buf.write(f"{r['site']:<20} {r['eager_mb']:>9.1f} "
                  f"{r['kernel_mb']:>10.1f} "
                  f"{r['eager_over_kernel']:>12.2f}x "
                  f"{str(bool(r['allclose'])):>9}\n")
    return buf.getvalue()


def render_roofline_rows(rows: Iterable[dict]) -> str:
    buf = io.StringIO()
    last_hdr = None
    for r in rows:
        hdr = (r.get("mesh", "single"), r.get("label", "baseline"),
               r.get("model", "kernels"))
        if hdr != last_hdr:
            model = "XLA-only" if hdr[2] == "xla_only" else "Pallas-kernel"
            buf.write(f"== roofline ({hdr[0]}-pod, {hdr[1]}, "
                      f"{model} model) ==\n")
            buf.write(f"{'arch':<22} {'shape':<12} {'compute_s':>10} "
                      f"{'memory_s':>10} {'collective_s':>13} {'bound':>11} "
                      f"{'useful':>7} {'MFU':>6}\n")
            last_hdr = hdr
        if r.get("status") == "skipped":
            buf.write(f"{r['arch']:<22} {r['shape']:<12} "
                      f"{'skip: ' + r.get('skipped', '')}\n")
        elif r.get("status") == "error":
            buf.write(f"{r['arch']:<22} {r['shape']:<12} ERROR\n")
        else:
            buf.write(f"{r['arch']:<22} {r['shape']:<12} "
                      f"{r['compute_s']:>10.4f} {r['memory_s']:>10.4f} "
                      f"{r['collective_s']:>13.4f} {r['dominant']:>11} "
                      f"{r['useful_ratio']:>7.2f} {r['mfu']:>6.3f}\n")
    return buf.getvalue()


def render_quantized_rows(rows: Iterable[dict]) -> str:
    """Quantization section: fp32 vs simulated-int8 QDQ shares per case."""
    buf = io.StringIO()
    buf.write(f"{'model':<28} {'mode':<18} {'variant':<10} {'GEMM%':>7} "
              f"{'NonGEMM%':>9} {'QDQ%':>7}\n")
    rows = list(rows)
    for r in rows:
        buf.write(f"{r['case']:<28} {r['mode']:<18} {r['variant']:<10} "
                  f"{_fmt_pct(r['gemm_frac']):>7} "
                  f"{_fmt_pct(r['nongemm_frac']):>9} "
                  f"{_fmt_pct(r.get('qdq_frac', 0.0)):>7}\n")

    def avg(variant):
        fr = [r["nongemm_frac"] for r in rows if r["variant"] == variant]
        return sum(fr) / len(fr) if fr else None

    fp32, int8 = avg("fp32"), avg("int8-qdq")
    if fp32 is not None and int8 is not None:
        buf.write(f"\naverage NonGEMM share: fp32 {100*fp32:.1f}%  ->  "
                  f"int8-QDQ {100*int8:.1f}%   (paper §4.4: QDQ operators "
                  f"aggravate the NonGEMM bottleneck; direction "
                  f"{'REPRODUCED' if int8 >= fp32 else 'NOT reproduced'})\n")
    return buf.getvalue()


def render_fusion_rows(rows: Iterable[dict]) -> str:
    """Fusion section (§6): the 2×2 unfused/fused shares per case."""
    buf = io.StringIO()
    buf.write(f"{'model':<28} {'mode':<18} {'variant':<16} {'total':>12} "
              f"{'GEMM%':>7} {'NonGEMM%':>9} {'fused%':>7} {'ops':>6}\n")
    rows = list(rows)
    for r in rows:
        buf.write(f"{r['case']:<28} {r['mode']:<18} {r['variant']:<16} "
                  f"{r['total_s']*1e3:>10.3f}ms "
                  f"{_fmt_pct(r['gemm_frac']):>7} "
                  f"{_fmt_pct(r['nongemm_frac']):>9} "
                  f"{_fmt_pct(r.get('fused_frac', 0.0)):>7} "
                  f"{r.get('n_ops', 0):>6}\n")

    def avg(variant):
        fr = [r["nongemm_frac"] for r in rows if r["variant"] == variant]
        return sum(fr) / len(fr) if fr else None

    unfused, fused = avg("fp32"), avg("fused")
    if unfused is not None and fused is not None:
        # lazy import: bench owns the §6 invariant; core must not import
        # bench at module load (bench imports core). The verdict is THE
        # shared gate, so the rendered line can never disagree with
        # what the section/compare gates enforce.
        from repro_torch.bench.schema import check_fusion_invariant
        residual = max((r["nongemm_frac"] for r in rows
                        if "fused" in r["variant"]), default=0.0)
        ok = not check_fusion_invariant(rows)
        buf.write(f"\naverage NonGEMM share: unfused {100*unfused:.1f}%  ->  "
                  f"fused {100*fused:.1f}%; max residual post-fusion "
                  f"{100*residual:.1f}%   (paper §6: fusion reduces but "
                  f"does not eliminate the bottleneck — 15%-48% remains; "
                  f"direction "
                  f"{'REPRODUCED' if ok else 'NOT reproduced'})\n")
    return buf.getvalue()


def render_vision_rows(rows: Iterable[dict]) -> str:
    """Vision section: fp32 vs fused shares with the RoI / Interpolation /
    Reduction(pooling) groups broken out per case."""
    buf = io.StringIO()
    buf.write(f"{'model':<24} {'kind':<15} {'variant':<8} {'total':>12} "
              f"{'GEMM%':>7} {'NonGEMM%':>9} {'RoI%':>7} {'Interp%':>8} "
              f"{'Reduce%':>8}\n")
    rows = list(rows)
    for r in rows:
        gf = r.get("group_fracs") or {}
        buf.write(f"{r['case']:<24} {r.get('kind', '?'):<15} "
                  f"{r['variant']:<8} {r['total_s']*1e3:>10.3f}ms "
                  f"{_fmt_pct(r['gemm_frac']):>7} "
                  f"{_fmt_pct(r['nongemm_frac']):>9} "
                  f"{_fmt_pct(r.get('roi_frac', 0.0)):>7} "
                  f"{_fmt_pct(r.get('interp_frac', 0.0)):>8} "
                  f"{_fmt_pct(gf.get('reduction', 0.0)):>8}\n")
    det = [r for r in rows
           if r.get("kind") == "detection" and r.get("variant") == "fp32"]
    if det:
        share = max(r.get("roi_frac", 0.0) + r.get("interp_frac", 0.0)
                    for r in det)
        buf.write(f"\ndetection RoI+Interpolation share {100*share:.1f}% "
                  f"(paper: RoI selection/interpolation/pooling dominate "
                  f"accelerated detection)\n")
    if rows:
        # lazy import for the same reason as the fusion renderer: the
        # verdict is THE shared gate (section + compare), never a reprint
        from repro_torch.bench.schema import check_vision_invariant
        violations = check_vision_invariant(rows)
        if violations:
            for where, message in violations:
                buf.write(f"invariant VIOLATED — {where}: {message}\n")
        else:
            buf.write("vision invariant REPRODUCED (detection RoI/Interp "
                      "nonzero, pooling in Reduction, fused < fp32)\n")
    return buf.getvalue()


def render_platform_rows(rows: Iterable[dict]) -> str:
    """Platforms section: the Table 3 sweep — NonGEMM share per case
    across the five hardware models, plus the measured / calibrated host
    rows with their drift vs the modeled ``cpu`` spec."""
    buf = io.StringIO()
    buf.write(f"{'model':<16} {'platform':<15} {'kind':<11} {'total':>12} "
              f"{'GEMM':>11} {'GEMM%':>7} {'NonGEMM%':>9} {'max|lg2 drift|':>15}\n")
    rows = list(rows)
    for r in rows:
        drift = r.get("max_abs_log2_drift")
        drift_cell = f"{drift:>15.2f}" if drift is not None else f"{'—':>15}"
        buf.write(f"{r['case']:<16} {r['platform']:<15} {r['kind']:<11} "
                  f"{r['total_s']*1e3:>10.3f}ms {r['gemm_s']*1e3:>9.3f}ms "
                  f"{_fmt_pct(r['gemm_frac']):>7} "
                  f"{_fmt_pct(r['nongemm_frac']):>9} {drift_cell}\n")
    if rows:
        # lazy import for the same reason as the fusion renderer: the
        # verdict is THE shared gate (section + compare), never a reprint
        from repro_torch.bench.schema import check_platforms_invariant
        violations = check_platforms_invariant(rows)
        if violations:
            for where, message in violations:
                buf.write(f"invariant VIOLATED — {where}: {message}\n")
        else:
            buf.write("platforms invariant REPRODUCED (NonGEMM share grows "
                      "as GEMM gets cheaper; NPU-like point highest; host "
                      "drift rows present)\n")
    return buf.getvalue()


def render_timing_table(sections: Iterable) -> str:
    """Per-section wall-clock summary of a bench run.

    ``sections`` are SectionResults or their dict forms — the artifact
    records ``wall_s`` per section; this makes the spend visible in every
    run's output before a slow section becomes a CI problem.
    """
    rows = [s if isinstance(s, dict) else s.to_dict() for s in sections]
    buf = io.StringIO()
    buf.write(f"{'section':<18} {'status':<9} {'rows':>5} {'wall':>9} "
              f"{'share':>7}\n")
    total = sum(float(r.get("wall_s", 0.0)) for r in rows) or 1.0
    for r in rows:
        w = float(r.get("wall_s", 0.0))
        buf.write(f"{r['name']:<18} {r.get('status', '?'):<9} "
                  f"{len(r.get('rows', [])):>5} {w:>8.1f}s "
                  f"{100.0 * w / total:>6.1f}%\n")
    buf.write(f"{'total':<18} {'':<9} {'':>5} {total:>8.1f}s {100.0:>6.1f}%\n")
    return buf.getvalue()


def render_serving_rows(rows: Iterable[dict]) -> str:
    """Serving section: one engine-throughput line per case plus the
    prefill/decode GEMM-vs-NonGEMM split lines."""
    buf = io.StringIO()
    for r in rows:
        if r.get("phase") == "engine":
            buf.write(
                f"{r['case']:<28} engine    "
                f"reqs {r['requests']:>3}  "
                f"decode {r['decode_tok_per_s']:>8.1f} tok/s  "
                f"TTFT {r['mean_ttft_s']*1e3:>8.1f}ms  "
                f"queue {r['mean_queue_wait_s']*1e3:>8.1f}ms  "
                f"tok-lat {r['mean_decode_tok_latency_s']*1e3:>7.1f}ms\n")
        else:
            buf.write(
                f"{r['case']:<28} {r.get('phase', '?'):<9} "
                f"{r.get('mode', ''):<22} "
                f"GEMM {_fmt_pct(r['gemm_frac'])}  "
                f"NonGEMM {_fmt_pct(r['nongemm_frac'])}\n")
    return buf.getvalue()


def render_sharded_rows(rows: Iterable[dict]) -> str:
    """serving_sharded section: the TP scaling table — devices, measured
    and per-device throughput, modeled step time/efficiency, and the
    COLLECTIVE share climbing with the TP degree."""
    buf = io.StringIO()
    for r in rows:
        parity = "ok" if r.get("parity_ok") is True else "FAIL"
        buf.write(
            f"{r['case']:<28} tp {r['tp']:>2} x{r['devices']:>2}dev  "
            f"decode {r['decode_tok_per_s']:>8.1f} tok/s "
            f"({r['per_device_tok_per_s']:>7.1f}/dev)  "
            f"step {r['modeled_step_s']*1e6:>7.2f}us  "
            f"eff {r['modeled_eff']:>5.3f}  "
            f"collective {_fmt_pct(r['collective_frac'])}  "
            f"parity {parity}\n")
    return buf.getvalue()


#: section name -> row renderer
SECTION_RENDERERS = {
    "breakdown": render_breakdown_rows,
    "opgroups": render_group_rows,
    "top_table": render_top_rows,
    "micro": render_micro_rows,
    "micro_harvested": render_micro_rows,
    "kernels": render_kernel_rows,
    "roofline": render_roofline_rows,
    "serving": render_serving_rows,
    "serving_sharded": render_sharded_rows,
    "quantized": render_quantized_rows,
    "fusion": render_fusion_rows,
    "vision": render_vision_rows,
    "platforms": render_platform_rows,
}


def render_section(section) -> str:
    """Render one SectionResult (or its dict form) to aligned text."""
    d = section if isinstance(section, dict) else section.to_dict()
    head = f"=== {d.get('title', d['name'])} ===\n"
    status = d.get("status", "ok")
    if status != "ok":
        reason = (d.get("error") or "").strip().splitlines()
        tail = f" ({reason[-1]})" if reason else ""
        return head + f"section {status}{tail}\n"
    renderer = SECTION_RENDERERS.get(d["name"])
    if renderer is None:
        return head + f"({len(d.get('rows', []))} rows; no renderer)\n"
    return head + renderer(d.get("rows", []))


def render_artifact(result) -> str:
    """Render a whole BenchResult (or its dict form) — the human report."""
    d = result if isinstance(result, dict) else result.to_dict()
    version = d["jax_version"]
    if not version.startswith("torch "):
        version = f"jax {version}"
    parts = [f"bench artifact: schema v{d['schema_version']}, "
             f"tier={d['tier']}, backend={d['backend']}, "
             f"{version}, {len(d['cases'])} case(s)\n"]
    parts += [render_section(s) for s in d["sections"]]
    parts += ["=== section wall-clock ===\n" +
              render_timing_table(d["sections"])]
    return "\n".join(parts)
