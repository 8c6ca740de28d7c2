"""Benchmark sections of the port: one per paper table/figure.

The port of ``repro.bench.sections``: the same sections, registered in
the same order under the same names and timeouts, each returning a list
of plain-dict rows (the serializable facts) through the port's
``report.profile_row``. Text tables are rendered from these rows by
``repro_torch.core.report``; nothing here formats strings. Every section
runs on ``ctx.device``, the card unless the caller asks for the CPU.

Where the port's columns differ from JAX's:

* ``breakdown`` has two columns, not three: the card's own per-op device
  time (``measured``; ``eager-cpu`` on the CPU) and the modeled eager
  A100; JAX's compiled-TPU column reads XLA's HLO.
* ``platforms``' measured and calibrated rows carry ``platform="h100"``
  on the card, their ``drift`` against the ``h100`` model of the same
  capture (``"cpu"`` and the analytic ``cpu`` spec on the CPU, as JAX's).
* ``micro``: ``jit_us`` is the whole call, the card's device time on the
  clean-L2 ``graph.Timer`` (host wall time on the CPU); ``tpu_model_us``
  is JAX's TPU-v5e pricing of the same bytes (the port's pinned copy of
  that spec), kept so the two packages' artifacts compare; ``bound_us``
  is the H100's byte bound.
* ``kernels``: ``kernel_mb`` (the hand-written kernel's boundary traffic)
  where JAX has ``xla_mb`` / ``pallas_mb``.
* ``serving`` and ``traffic`` serve stablelm-3b at its published size on
  the card (``cases.build_serving``), the decode step as a CUDA graph:
  ``serving`` in the config's own bf16, ``traffic`` in f32, where its
  parity gate can hold (``TRAFFIC_DTYPE``).
* ``serving_sharded`` skips: tensor-parallel serving is not ported yet.
"""

from __future__ import annotations

import glob
import json
import os
from typing import List, Sequence

import torch

from repro_torch import nn
from repro_torch.core.graph import capture
from repro_torch.core.microbench import TABLE2_SHAPES, io_bytes, run_micro
from repro_torch.core.report import profile_row
from repro_torch.kernels import ops, ref
from repro_torch.models.attention import _attention_impl

from .cases import (SERVING_CASES, TRAFFIC_CASES, VISION_CASES, build,
                    build_serving, profile_case, profile_case_calibrated,
                    profile_case_fused, profile_case_measured,
                    profile_case_modeled_on, profile_case_platforms,
                    profile_case_quantized, profile_case_vision, tier_cases)
from .runner import BenchContext, SkipSection, register_section
from .schema import (BenchCase, check_fusion_invariant,
                     check_platforms_invariant, check_traffic_invariant,
                     check_vision_invariant)


def _results_root() -> str:
    """Anchor results/ at the repo root (not the caller's cwd) when the
    package runs from a checkout; $REPRO_RESULTS_DIR overrides."""
    env = os.environ.get("REPRO_RESULTS_DIR")
    if env:
        return env
    repo = os.path.abspath(os.path.join(os.path.dirname(__file__),
                                        "..", "..", ".."))
    cand = os.path.join(repo, "results")
    return cand if os.path.isdir(cand) else "results"


RESULTS_DRYRUN = os.path.join(_results_root(), "dryrun")
RESULTS_DRYRUN_OPT = os.path.join(_results_root(), "dryrun_opt")

#: the spec a measured or calibrated profile's drift is read against, per
#: device: the card's own, or JAX's analytic ``cpu`` point
DRIFT_SPEC = {"cuda": "h100", "cpu": "cpu"}


def _case_profiles(cases: Sequence[BenchCase], device: str):
    measured, acc = [], []
    for c in cases:
        m, a = profile_case(c.alias, c.arch, c.batch, c.seq, device)
        measured.append(m)
        acc.append(a)
    return measured, acc


# ---------------------------------------------------------------------------
# Fig 1/5/8/10 — GEMM vs NonGEMM breakdown
# ---------------------------------------------------------------------------

def breakdown_rows(cases: Sequence[BenchCase],
                   device: str = "cuda") -> List[dict]:
    measured, acc = _case_profiles(cases, device)
    return [profile_row(p) for p in measured + acc]


@register_section(
    "breakdown",
    title="Fig 1/5/8/10 — GEMM vs NonGEMM breakdown "
          "(eager measured on the card, or eager CPU / eager A100 modeled; "
          "no compiled column)",
    timeout_s=360.0)
def section_breakdown(ctx: BenchContext) -> List[dict]:
    return breakdown_rows(ctx.cases, ctx.device)


# ---------------------------------------------------------------------------
# Fig 9/11/12 — per-operator-group shares
# ---------------------------------------------------------------------------

@register_section(
    "opgroups",
    title="Fig 9/11/12 — per-operator-group shares",
    timeout_s=240.0)
def section_opgroups(ctx: BenchContext) -> List[dict]:
    measured, acc = _case_profiles(ctx.cases, ctx.device)
    rows = []
    for m, a in zip(measured, acc):
        rows += [profile_row(m), profile_row(a)]
    return rows


# ---------------------------------------------------------------------------
# Table 5 — most expensive NonGEMM group (accelerated)
# ---------------------------------------------------------------------------

@register_section(
    "top_table",
    title="Table 5 — most expensive NonGEMM group "
          "(measured on the card, and accelerated modeled)",
    timeout_s=240.0)
def section_top_table(ctx: BenchContext) -> List[dict]:
    measured, acc = _case_profiles(ctx.cases, ctx.device)
    profiles = acc if ctx.device == "cpu" else measured + acc
    rows = []
    for p in profiles:
        tops = p.top_nongemm_groups(k=1)
        if not tops:
            continue
        g, _t, pct = tops[0]
        row = profile_row(p)
        row.update(top_group=g, top_pct=pct)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# §4.4 — quantization: fp32 vs simulated int8 QDQ (workload transform)
# ---------------------------------------------------------------------------

def quantized_rows(cases: Sequence[BenchCase],
                   device: str = "cuda") -> List[dict]:
    """Two rows per case (variant fp32 / int8-qdq), deterministic modeled
    eager-A100 shares. Structurally asserts the paper's §4.4 finding:
    the QDQ variant's NonGEMM share must not drop below fp32's."""
    rows = []
    for c in cases:
        fp32, int8 = profile_case_quantized(c.alias, c.arch, c.batch, c.seq,
                                            device)
        for variant, p in (("fp32", fp32), ("int8-qdq", int8)):
            row = profile_row(p)
            row["variant"] = variant
            row["qdq_frac"] = row["group_fracs"].get("quantization", 0.0)
            rows.append(row)
        lo, hi = fp32.split["nongemm_frac"], int8.split["nongemm_frac"]
        if hi + 1e-9 < lo:
            raise AssertionError(
                f"{c.alias}: int8-QDQ NonGEMM share {hi:.4f} fell below "
                f"fp32's {lo:.4f} — contradicts the paper's quantization "
                f"finding (QDQ operators aggravate the NonGEMM bottleneck)")
    return rows


@register_section(
    "quantized",
    title="§4.4 — quantization raises the NonGEMM share "
          "(fp32 vs simulated int8 QDQ, modeled eager A100)",
    timeout_s=240.0)
def section_quantized(ctx: BenchContext) -> List[dict]:
    return quantized_rows(ctx.cases, ctx.device)


# ---------------------------------------------------------------------------
# §6 — operator fusion: unfused vs fused NonGEMM chains (FusionTransform)
# ---------------------------------------------------------------------------

def fusion_rows(cases: Sequence[BenchCase],
                device: str = "cuda") -> List[dict]:
    """The fusion 2×2 per case: fp32 / fused / int8-qdq / int8-qdq+fused.

    Deterministic modeled eager-A100 shares, gated by the same
    ``check_fusion_invariant`` the compare CLI re-runs on candidates.
    """
    rows: List[dict] = []
    for c in cases:
        fp32, fused, int8, int8_fused = profile_case_fused(
            c.alias, c.arch, c.batch, c.seq, device)
        for variant, p in (("fp32", fp32), ("fused", fused),
                           ("int8-qdq", int8),
                           ("int8-qdq+fused", int8_fused)):
            row = profile_row(p)
            row["variant"] = variant
            row["fused_frac"] = row["group_fracs"].get("fused", 0.0)
            rows.append(row)
    violations = check_fusion_invariant(rows)
    if violations:
        raise AssertionError("; ".join(f"{w}: {m}" for w, m in violations))
    return rows


@register_section(
    "fusion",
    title="§6 — operator fusion lowers but does not eliminate the NonGEMM "
          "share (FusionTransform 2×2, modeled eager A100)",
    timeout_s=240.0)
def section_fusion(ctx: BenchContext) -> List[dict]:
    return fusion_rows(ctx.cases, ctx.device)


# ---------------------------------------------------------------------------
# §Vision — ViT classification + detection (RoI / Interpolation / Pooling)
# ---------------------------------------------------------------------------

def vision_rows(cases: Sequence[BenchCase],
                device: str = "cuda") -> List[dict]:
    """Two rows per vision case (variant fp32 / fused), deterministic
    modeled eager-A100 shares, with the RoI and Interpolation shares
    broken out per row, gated by ``check_vision_invariant``."""
    from repro_torch.configs import get_config

    rows: List[dict] = []
    for c in cases:
        fp32, fused = profile_case_vision(c.alias, c.arch, c.batch, device)
        kind = ("detection" if get_config(c.arch).is_detector
                else "classification")
        for variant, p in (("fp32", fp32), ("fused", fused)):
            row = profile_row(p)
            row["variant"] = variant
            row["kind"] = kind
            row["roi_frac"] = row["group_fracs"].get("roi", 0.0)
            row["interp_frac"] = row["group_fracs"].get("interpolation", 0.0)
            rows.append(row)
    violations = check_vision_invariant(rows)
    if violations:
        raise AssertionError("; ".join(f"{w}: {m}" for w, m in violations))
    return rows


@register_section(
    "vision",
    title="§Vision — ViT classification + detection: RoI / Interpolation / "
          "Pooling NonGEMM groups (fp32 vs fused, modeled eager A100)",
    timeout_s=300.0)
def section_vision(ctx: BenchContext) -> List[dict]:
    cases = tier_cases(ctx.tier, VISION_CASES)
    if not cases:
        raise SkipSection(f"no vision cases in tier {ctx.tier!r}")
    return vision_rows(cases, ctx.device)


# ---------------------------------------------------------------------------
# Table 3 — multi-platform hardware sweep + measured drift
# ---------------------------------------------------------------------------

def platform_rows(cases: Sequence[BenchCase],
                  device: str = "cuda") -> List[dict]:
    """The platform sweep plus the measured-vs-modeled evidence.

    Per case, one ``kind="modeled"`` row per
    :data:`~repro_torch.bench.schema.PLATFORM_SWEEP` spec — one capture,
    re-modeled per platform. For the first case, two rows ride along:
    ``kind="measured"`` (:func:`~repro_torch.bench.cases.profile_case`'s
    measured column) and ``kind="calibrated"`` (micro-bench-fitted
    factors), each with a per-group ``drift`` map against the model of
    the same capture on :data:`DRIFT_SPEC` (``h100`` on the card, the
    analytic ``cpu`` spec on the CPU). Gated by
    ``check_platforms_invariant`` (paper Table 3).
    """
    from repro_torch.core.calibrate import drift_by_group, max_abs_log2_drift

    rows: List[dict] = []
    for c in cases:
        for hw, p in profile_case_platforms(c.alias, c.arch, c.batch, c.seq,
                                            device):
            row = profile_row(p)
            row.update(platform=hw, kind="modeled",
                       gemm_s=p.group_seconds.get("gemm", 0.0))
            rows.append(row)
    c0 = cases[0]
    spec = DRIFT_SPEC[device]
    reference = profile_case_modeled_on(c0.alias, c0.arch, c0.batch, c0.seq,
                                        spec, device)
    for kind, p in (
            ("measured",
             profile_case_measured(c0.alias, c0.arch, c0.batch, c0.seq,
                                   device)),
            ("calibrated",
             profile_case_calibrated(c0.alias, c0.arch, c0.batch, c0.seq,
                                     device))):
        drift = drift_by_group(p.group_seconds, reference.group_seconds)
        row = profile_row(p)
        row.update(platform=spec, kind=kind,
                   gemm_s=p.group_seconds.get("gemm", 0.0),
                   drift=drift,
                   max_abs_log2_drift=max_abs_log2_drift(drift))
        rows.append(row)
    violations = check_platforms_invariant(rows)
    if violations:
        raise AssertionError("; ".join(f"{w}: {m}" for w, m in violations))
    return rows


@register_section(
    "platforms",
    title="Table 3 — platform sweep: NonGEMM share vs GEMM cost across "
          "five hardware models, with measured drift",
    timeout_s=360.0)
def section_platforms(ctx: BenchContext) -> List[dict]:
    return platform_rows(ctx.cases, ctx.device)


# ---------------------------------------------------------------------------
# Table 2 — NonGEMM operator micro-benchmark
# ---------------------------------------------------------------------------

def _micro_row(r) -> dict:
    """A Table-2 row with JAX's keys (see the module docstring)."""
    from repro_torch.core.hardware import TPU_V5E

    return {
        "operator": r.name, "group": r.group, "shape": list(r.shape),
        "dtype": r.dtype, "jit_us": r.device_us, "eager_us": r.eager_us,
        "tpu_model_us": 1e6 * TPU_V5E.group_mem_time(r.group,
                                                     r.bytes_touched),
        "bytes_touched": r.bytes_touched, "bound_us": r.bound_us,
        "device": r.device,
    }


def micro_rows(repeats: int = 5, measure_eager: bool = True,
               device: str = "cuda") -> List[dict]:
    from repro_torch.core.graph import Timer

    timer = Timer(iters=repeats) if torch.device(device).type == "cuda" \
        else None
    return [_micro_row(run_micro(name, repeats=repeats, device=device,
                                 measure_eager=measure_eager, timer=timer))
            for name in TABLE2_SHAPES]


@register_section(
    "micro",
    title="Table 2 — NonGEMM operator micro-benchmark",
    timeout_s=300.0)
def section_micro(ctx: BenchContext) -> List[dict]:
    quick = ctx.tier == "quick"
    return micro_rows(repeats=3 if quick else 5, measure_eager=not quick,
                      device=ctx.device)


#: the captured op sites the harvested micro-bench runs, each a Table-2
#: operator of the same name (JAX's set)
HARVESTED_SITES = ("rms_norm", "softmax", "silu", "gelu", "add")


def harvested_rows(arch: str = "llama2-7b", repeats: int = 3,
                   device: str = "cuda") -> List[dict]:
    """Micro-bench driven by shapes harvested from a real model trace —
    the paper's 'input argument specification extracted from real data'.

    A site outside ``HARVESTED_SITES``, or one captured without an input
    shape, is left out before any call; a run that fails raises, so the
    section fails (JAX's catches it and drops the row)."""
    from repro_torch.core import harvest_shapes

    fwd, params, inputs = build(arch, 1, 16, device)
    shapes = harvest_shapes(capture(fwd, params, inputs))
    rows = []
    for (group, site), shape_list in sorted(shapes.items()):
        if site not in HARVESTED_SITES or not shape_list or not shape_list[0]:
            continue
        shape = shape_list[0][0]
        if not shape:
            continue
        r = run_micro(site, shape=shape, repeats=repeats, measure_eager=False,
                      device=device)
        rows.append(dict(_micro_row(r), operator=site, group=group,
                         harvested_from=arch))
    return rows


@register_section(
    "micro_harvested",
    title="Table 2b — micro-bench on shapes harvested from a real trace",
    timeout_s=240.0)
def section_micro_harvested(ctx: BenchContext) -> List[dict]:
    return harvested_rows(device=ctx.device)


# ---------------------------------------------------------------------------
# §4.5 — kernel fusion: eager against kernel-boundary traffic + correctness
# ---------------------------------------------------------------------------

def kernel_sites(device, generator: torch.Generator):
    """(name, plain nn fn, args, kernel fn, plain oracle fn, atol) per
    kernel site, inputs drawn with ``generator`` on ``device``."""
    def randn(shape, dt):
        return torch.randn(shape, generator=generator, device=device).to(dt)

    bf16 = torch.bfloat16
    d = 2048
    x = randn((8, 512, d), bf16)
    res = randn((8, 512, d), bf16)
    w = torch.ones(d, dtype=bf16, device=device)
    b = torch.zeros(d, dtype=bf16, device=device)
    gate = randn((8, 512, 2 * d), bf16)
    up = randn((8, 512, 2 * d), bf16)
    logits = randn((256, 32000), torch.float32)
    labels = torch.randint(0, 32000, (256,), generator=generator,
                           device=device, dtype=torch.int32)
    q = randn((1, 1024, 8, 64), bf16)
    kk = randn((1, 1024, 2, 64), bf16)
    v = randn((1, 1024, 2, 64), bf16)

    return [
        ("rms_norm", lambda a: nn.rms_norm(a, w), (x,),
         lambda: ops.rms_norm(x, w), lambda: ref.rms_norm(x, w), 3e-2),
        ("layer_norm", lambda a: nn.layer_norm(a, w, b), (x,),
         lambda: ops.layer_norm(x, w, b), lambda: ref.layer_norm(x, w, b),
         3e-2),
        ("fused_add_rms_norm",
         lambda a, r: nn.fused_add_rms_norm(a, r, w), (x, res),
         lambda: ops.fused_add_rms_norm(x, res, w)[0],
         lambda: ref.fused_add_rms_norm(x, res, w)[0], 3e-2),
        ("swiglu", nn.swiglu, (gate, up),
         lambda: ops.swiglu(gate, up), lambda: ref.swiglu(gate, up), 3e-2),
        ("softmax_xent",
         lambda lg: nn.softmax_cross_entropy(lg, labels), (logits,),
         lambda: ops.softmax_xent(logits, labels),
         lambda: ref.softmax_xent(logits, labels), 1e-4),
        ("flash_attention",
         lambda a, b_, c: _attention_impl(a, b_, c, causal=True), (q, kk, v),
         lambda: ops.attention_core(q, kk, v),
         lambda: ref.attention(q, kk, v, causal=True), 5e-2),
    ]


def section_kernels(device="cuda") -> List[dict]:
    """One row per kernel site: traffic of the eager chain against the
    kernel's, and the kernel against its plain version. On the card unless
    the caller asks for the CPU. Per site, two traffic counts of the same
    computation:

        eager_mb    every operator its own kernel: the sum of per-op
                    operand and result bytes from the port's capture of
                    the plain nn chain (the paper's eager setting)
        kernel_mb   kernel-boundary IO, inputs once and outputs once: what
                    the hand-written kernel moves (JAX's ``pallas_mb``)

    ``eager_over_kernel`` is their ratio (JAX's ``eager_over_pallas``).
    ``allclose`` holds the kernel wrapper's output against the plain
    version at JAX's tolerances (3e-2 for the bf16 sites, 1e-4 for
    softmax_xent in f32, 5e-2 for attention): on the card the kernel
    launches, on the CPU the wrapper takes its plain version."""
    gen = torch.Generator(device).manual_seed(0)
    rows = []
    for name, fn, args, kernel, oracle, atol in kernel_sites(device, gen):
        with nn.backend("torch"):
            records = capture(fn, *args)
            out = fn(*args)
        eager_b = sum(r.bytes_accessed for r in records)
        io_b = io_bytes(args, out)
        got, want = kernel(), oracle()
        rows.append({
            "site": name,
            "eager_mb": eager_b / 1e6,
            "kernel_mb": io_b / 1e6,
            "eager_over_kernel": eager_b / io_b if io_b else 0.0,
            "allclose": bool(torch.allclose(got.float(), want.float(),
                                            atol=atol)),
        })
    return rows


@register_section(
    "kernels",
    title="§4.5 — kernel fusion: eager against kernel-boundary HBM traffic "
          "+ correctness (hand-written CUDA kernels)",
    timeout_s=300.0)
def section_kernel_sites(ctx: BenchContext) -> List[dict]:
    return section_kernels(ctx.device)


# ---------------------------------------------------------------------------
# §Serving — continuous-batching engine: throughput + phase GEMM/NonGEMM split
# ---------------------------------------------------------------------------

def serving_rows(case: BenchCase, requests: int = 6,
                 max_new_tokens: int = 5, device: str = "cuda") -> List[dict]:
    """Three row kinds per serving case:

    * ``phase="engine"`` — measured continuous-batching throughput and
      latency stats (TTFT, queue wait, per-token decode latency) from a
      real engine run over mixed-length prompts (on the card the decode
      step runs as a CUDA graph, captured at the first decode: the
      counterpart of JAX's jitted step, whose compile its row includes);
    * ``phase="prefill"`` / ``phase="decode"`` — the paper's
      GEMM/NonGEMM split of the two serving programs, modeled eager A100
      (per-op roofline, no fusion) on the functions the engine runs
      (vectorized per-slot ``pos``).
    """
    import numpy as np

    from repro_torch.core import Workload
    from repro_torch.models import init_lm_cache, lm_decode, lm_prefill
    from repro_torch.serving import Engine

    alias, arch, max_batch, max_len = case
    cfg, params = build_serving(arch, device)

    eng = Engine(cfg, params, max_batch=max_batch, max_len=max_len)
    rng = np.random.RandomState(0)
    for _ in range(requests):
        plen = int(rng.randint(3, 17))
        prompt = rng.randint(1, cfg.vocab_size, size=plen).tolist()
        eng.add_request(prompt, max_new_tokens=max_new_tokens)
    done = eng.run()
    s = eng.stats
    rows = [{
        "case": alias, "mode": "engine_measured", "phase": "engine",
        "requests": len(done),
        "prefill_tokens": s.prefill_tokens,
        "decode_tokens": s.decode_tokens,
        "first_tokens": s.first_tokens,
        "decode_steps": s.decode_steps,
        "decode_tok_per_s": s.decode_tok_per_s,
        "mean_ttft_s": s.mean_ttft_s,
        "mean_queue_wait_s": s.mean_queue_wait_s,
        "mean_decode_tok_latency_s": s.mean_decode_tok_latency_s,
    }]
    del eng

    bucket = 16
    gen = torch.Generator(torch.device(device)).manual_seed(1)
    toks = torch.randint(1, cfg.vocab_size, (1, bucket), generator=gen,
                         device=device)
    lengths = torch.full((1,), bucket - 3, dtype=torch.int32, device=device)

    def prefill_fn(params, toks, lengths):
        return lm_prefill(params, toks, cfg, max_len=max_len,
                          lengths=lengths)[0]

    caches = init_lm_cache(cfg, max_batch, max_len, device=device)
    token = torch.ones((max_batch,), dtype=torch.int32, device=device)
    pos = torch.arange(4, 4 + max_batch, dtype=torch.int32, device=device)

    def decode_fn(params, token, pos, caches):
        return lm_decode(params, token, pos, caches, cfg)[0]

    for phase, fn, args in (
            ("prefill", prefill_fn, (params, toks, lengths)),
            ("decode", decode_fn, (params, token, pos, caches))):
        w = Workload(
            name=alias, arch=arch, phase=phase,
            batch=(1 if phase == "prefill" else max_batch),
            seq=(bucket if phase == "prefill" else max_len), dtype=cfg.dtype,
            builder=lambda _w, _dev, fn=fn, args=args: (fn, args[1:],
                                                        args[0]))
        row = profile_row(w.profile("eager-modeled:a100", device=device))
        row["phase"] = phase
        rows.append(row)
    return rows


@register_section(
    "serving",
    title="§Serving — continuous-batching engine throughput + "
          "prefill/decode GEMM vs NonGEMM split",
    timeout_s=300.0)
def section_serving(ctx: BenchContext) -> List[dict]:
    cases = tier_cases(ctx.tier, SERVING_CASES)
    if not cases:
        raise SkipSection(f"no serving cases in tier {ctx.tier!r}")
    rows: List[dict] = []
    for c in cases:
        rows += serving_rows(c, device=ctx.device)
    return rows


# ---------------------------------------------------------------------------
# §Traffic — paged-KV engine under trace-driven load
# ---------------------------------------------------------------------------

#: the op sites of the paged bookkeeping (``paged_frac``)
PAGED_SITES = ("paged_kv_gather", "paged_kv_write", "paged_kv_scatter",
               "kv_cache_update")
#: the paged engine's blocks and prefill chunks in every traffic run
TRAFFIC_BLOCK, TRAFFIC_CHUNK = 8, 16
#: the traffic section's dtype on the card. Its parity gate holds the
#: paged engine's 16-token chunked prefill bit for bit to the contiguous
#: engine's whole prefill: two summation orders, which agree in f32 and
#: round apart in bf16, where a greedy token at a near-tie may flip
#: (``scripts/paged_parity.py`` prints the margin at each flip)
TRAFFIC_DTYPE = "float32"


def parity_trace(vocab: int, n_requests: int = 8):
    """The parity row's Poisson trace (JAX's: seed 0, 200 requests/s,
    prompts of 3-40 tokens, 2-6 new tokens)."""
    from repro_torch.traffic import poisson_trace
    return poisson_trace(0, n_requests, 200.0, vocab, prompt_len=(3, 40),
                         output_len=(2, 6))


def parity_outputs(cfg, params, trace, max_batch: int, max_len: int,
                   engines=None) -> List[dict]:
    """The parity row's two runs: ``trace`` served greedily to its end by
    the contiguous ``Engine``, then by the ``PagedEngine`` (the section's
    blocks and chunks), each freed before the next is built. Returns
    their ``{prompt: output tokens}``. ``engines``: the two classes in
    place of ``(Engine, PagedEngine)`` (subclasses that record logits)."""
    from repro_torch.serving import Engine, PagedEngine

    contiguous, paged = engines or (Engine, PagedEngine)
    outs = []
    for make in (lambda: contiguous(cfg, params, max_batch=max_batch,
                                    max_len=max_len, greedy=True),
                 lambda: paged(cfg, params, max_batch=max_batch,
                               max_len=max_len, block_size=TRAFFIC_BLOCK,
                               chunk_size=TRAFFIC_CHUNK, greedy=True)):
        eng = make()
        for r in trace:
            eng.add_request(r.prompt, r.max_new_tokens)
        outs.append({tuple(r.prompt): r.output for r in eng.run()})
        del eng
    return outs


def traffic_rows(case: BenchCase, n_requests: int = 8,
                 device: str = "cuda") -> List[dict]:
    """Four row kinds per traffic case, gated by the same
    ``check_traffic_invariant`` the compare CLI re-runs on candidates:

    * ``phase="parity"`` — the paged-KV engine replays the contiguous
      engine's exact requests; outputs must match bit for bit;
    * ``phase="load"`` — trace-driven Poisson load through the paged
      engine (primed on a token-remapped shadow trace first: on the card
      that captures its decode graph): TTFT percentiles, queue wait,
      per-token latency, goodput;
    * ``phase="prefix"`` — shared-prefix trace, prefix cache on vs off:
      hit rate, warm-vs-cold mean service TTFT, and output parity;
    * ``phase="profile"`` — modeled eager-A100 GEMM/NonGEMM split of the
      paged decode step, with ``paged_frac`` attributing the block-table
      gather/scatter bookkeeping through the OpGroup taxonomy.

    The engines are built one after another, each freed before the next.
    On the card the model is the published one in ``TRAFFIC_DTYPE``.
    """
    from repro_torch.core import Workload
    from repro_torch.models import init_lm_cache
    from repro_torch.serving import PagedEngine, make_paged_decode_step
    from repro_torch.traffic import drive, prime, shared_prefix_trace

    alias, arch, max_batch, max_len = case
    cfg, params = build_serving(arch, device, TRAFFIC_DTYPE)
    vocab = cfg.vocab_size

    def mk(**kw):
        return PagedEngine(cfg, params, max_batch=max_batch, max_len=max_len,
                           block_size=TRAFFIC_BLOCK, chunk_size=TRAFFIC_CHUNK,
                           greedy=True, **kw)

    def outputs(finished):
        return {tuple(r.prompt): r.output for r in finished}

    # parity: identical requests through the contiguous and paged engines
    trace = parity_trace(vocab, n_requests)
    ref_out = parity_outputs(cfg, params, trace, max_batch, max_len)
    rows = [{"case": alias, "phase": "parity",
             "parity_ok": ref_out[0] == ref_out[1],
             "requests": n_requests}]

    # load: the same Poisson trace, replayed through the trace driver
    eng = mk()
    prime(eng, trace, vocab)
    _, rep = drive(eng, trace, time_scale=1e5)
    del eng
    rows.append({"case": alias, "phase": "load", "trace": "poisson",
                 **rep.to_dict()})

    # prefix: shared-prefix trace with the cache on vs off (both primed
    # on a shadow trace, so TTFT compares service time, not warm-up)
    sp = shared_prefix_trace(7, n_requests, vocab, prefix_len=32,
                             suffix_len=(4, 8))
    runs = []
    for caching in (True, False):
        eng = mk(prefix_caching=caching)
        prime(eng, sp, vocab)
        runs.append(drive(eng, sp, time_scale=1e5))
        del eng
    (fin_w, rep_w), (fin_c, rep_c) = runs
    rows.append({
        "case": alias, "phase": "prefix", "trace": "shared_prefix",
        "hit_rate": rep_w.prefix_hit_rate,
        "warm_service_ttft_s": rep_w.mean_service_ttft_s,
        "cold_service_ttft_s": rep_c.mean_service_ttft_s,
        "parity_ok": outputs(fin_w) == outputs(fin_c),
    })

    # profile: modeled eager-A100 split of the paged decode step itself
    blocks_per_seq = -(-max_len // TRAFFIC_BLOCK)
    num_blocks = 1 + max_batch * blocks_per_seq
    pools = init_lm_cache(cfg, num_blocks, TRAFFIC_BLOCK, device=device)
    tables = torch.arange(1, num_blocks, dtype=torch.int32,
                          device=device).reshape(max_batch, blocks_per_seq)
    token = torch.ones((max_batch,), dtype=torch.int32, device=device)
    pos = torch.arange(4, 4 + max_batch, dtype=torch.int32, device=device)
    step = make_paged_decode_step(cfg, max_len, greedy=True)

    def decode_fn(params, token, pos, pools, tables):
        return step(params, token, pos, pools, tables)[0]

    w = Workload(name=alias, arch=arch, phase="decode", batch=max_batch,
                 seq=max_len, dtype=cfg.dtype,
                 builder=lambda _w, _dev: (decode_fn,
                                           (token, pos, pools, tables),
                                           params))
    prof = w.profile("eager-modeled:a100", device=device)
    row = profile_row(prof)
    total = prof.total_seconds or 1.0
    paged_s = sum(t for (_g, site), t in prof.op_seconds.items()
                  if site in PAGED_SITES)
    row.update(phase="profile",
               memory_frac=row["group_fracs"].get("memory", 0.0),
               paged_frac=paged_s / total)
    rows.append(row)

    violations = check_traffic_invariant(rows)
    if violations:
        raise AssertionError("; ".join(f"{w}: {m}" for w, m in violations))
    return rows


@register_section(
    "traffic",
    title="§Traffic — paged-KV engine under trace-driven load "
          "(parity, TTFT/goodput, prefix-cache, NonGEMM share of serving)",
    timeout_s=300.0)
def section_traffic(ctx: BenchContext) -> List[dict]:
    cases = tier_cases(ctx.tier, TRAFFIC_CASES)
    if not cases:
        raise SkipSection(f"no traffic cases in tier {ctx.tier!r}")
    rows: List[dict] = []
    for c in cases:
        rows += traffic_rows(c, device=ctx.device)
    return rows


# ---------------------------------------------------------------------------
# §Sharded serving — waits on tensor-parallel serving
# ---------------------------------------------------------------------------

@register_section(
    "serving_sharded",
    title="§Sharded serving — TP decode: parity, per-device scaling, and "
          "the COLLECTIVE NonGEMM horizon",
    timeout_s=560.0)
def section_serving_sharded(ctx: BenchContext) -> List[dict]:
    raise SkipSection("tensor-parallel serving is not ported yet "
                      "(ROADMAP queue 1 item 8)")


# ---------------------------------------------------------------------------
# §Roofline — dry-run roofline table (results/dryrun)
# ---------------------------------------------------------------------------

def load_dryrun(mesh: str = "single", root: str = RESULTS_DRYRUN):
    rows = []
    for path in sorted(glob.glob(os.path.join(root, mesh, "*.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    return rows


def _roofline_rows(mesh: str, root: str, label: str,
                   kernels: bool = True) -> List[dict]:
    key = "roofline" if kernels else "roofline_xla_only"
    rows = []
    for r in load_dryrun(mesh, root):
        base = {"arch": r.get("arch", "?"), "shape": r.get("shape", "?"),
                "mesh": mesh, "label": label,
                "model": "kernels" if kernels else "xla_only"}
        if "skipped" in r:
            base.update(status="skipped", skipped=r["skipped"])
        elif "error" in r:
            base.update(status="error")
        else:
            t = r[key]
            base.update(
                status="ok", compute_s=t["compute_s"],
                memory_s=t["memory_s"], collective_s=t["collective_s"],
                dominant=t["dominant"], useful_ratio=t["useful_ratio"],
                mfu=t["mfu"])
        rows.append(base)
    return rows


@register_section(
    "roofline",
    title="§Roofline — dry-run roofline table (results/dryrun)",
    timeout_s=60.0)
def section_roofline(ctx: BenchContext) -> List[dict]:
    rows = _roofline_rows("single", RESULTS_DRYRUN, "baseline")
    if glob.glob(os.path.join(RESULTS_DRYRUN, "multi", "*.json")):
        rows += _roofline_rows("multi", RESULTS_DRYRUN, "baseline")
    if glob.glob(os.path.join(RESULTS_DRYRUN_OPT, "single", "*.json")):
        rows += _roofline_rows("single", RESULTS_DRYRUN_OPT, "optimized")
    if glob.glob(os.path.join(RESULTS_DRYRUN_OPT, "multi", "*.json")):
        rows += _roofline_rows("multi", RESULTS_DRYRUN_OPT, "optimized")
    if not rows:
        # nothing generated yet: not a failure, the dry-run just hasn't run
        raise SkipSection("no dry-run artifacts under results/dryrun")
    return rows
