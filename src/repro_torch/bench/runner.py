"""Tiered section runner with per-section timeouts.

The port of ``repro.bench.runner``. Sections register themselves via
:func:`register_section`; the runner executes the requested tier's
sections in registration order, wraps each in a wall-clock budget
(SIGALRM on the main thread), and assembles one :class:`BenchResult`
artifact no matter which sections failed, timed out, or were skipped.

Everything runs on ``device``, the card unless the caller asks for the
CPU; :func:`run_bench` raises where CUDA is absent and the card was asked
for. On the card a section's clock stops after the card has finished the
work it queued (a synchronize), so a section's ``wall_s`` and a timeout
both count its device time, and the next section starts on an idle card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import signal
import subprocess
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence

import torch

from .schema import (PORT_VERSION_PREFIX, SCHEMA_VERSION, BenchCase,
                     BenchResult, SectionResult)


class SkipSection(Exception):
    """Raised by a section to mark itself skipped (with a reason)."""


class SectionTimeout(BaseException):
    """Section exceeded its wall-clock budget.

    Deliberately a BaseException: sections that contain per-row failures
    with a blanket ``except Exception`` (e.g. harvested micro-bench) must
    not be able to swallow the runner's SIGALRM — the alarm is one-shot,
    so a swallowed timeout would let the section run unbounded.
    """


@dataclasses.dataclass
class BenchContext:
    """Everything a section needs to run."""

    tier: str                          # "quick" | "full"
    cases: List[BenchCase]
    device: str = "cuda"               # "cuda" | "cpu"


@dataclasses.dataclass
class Section:
    name: str
    title: str
    fn: Callable[[BenchContext], List[dict]]
    tiers: tuple = ("quick", "full")
    timeout_s: float = 300.0


#: registration order == execution order
SECTIONS: Dict[str, Section] = {}


def register_section(name: str, title: Optional[str] = None,
                     tiers: tuple = ("quick", "full"),
                     timeout_s: float = 300.0):
    def deco(fn):
        SECTIONS[name] = Section(name=name, title=title or name, fn=fn,
                                 tiers=tiers, timeout_s=timeout_s)
        return fn
    return deco


@contextlib.contextmanager
def _deadline(seconds: float):
    """SIGALRM-based wall-clock budget; no-op off the main thread."""
    if seconds <= 0 or threading.current_thread() is not threading.main_thread():
        yield
        return

    def _raise(signum, frame):
        raise SectionTimeout(f"exceeded {seconds:.0f}s budget")

    prev = signal.signal(signal.SIGALRM, _raise)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, prev)


def _synchronize(device: str) -> None:
    """Wait for the work queued on the card (no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_section(section: Section, ctx: BenchContext,
                timeout_scale: float = 1.0) -> SectionResult:
    t0 = time.perf_counter()
    try:
        with _deadline(section.timeout_s * timeout_scale):
            rows = section.fn(ctx)
            _synchronize(ctx.device)
        status, error = "ok", None
    except SkipSection as e:
        rows, status, error = [], "skipped", str(e)
    except SectionTimeout as e:
        rows, status, error = [], "timeout", str(e)
    except Exception:
        rows, status, error = [], "failed", traceback.format_exc(limit=8)
    if status != "ok":
        # what the section queued before it stopped is its work, not the
        # next section's
        _synchronize(ctx.device)
    return SectionResult(name=section.name, title=section.title,
                         status=status, wall_s=time.perf_counter() - t0,
                         rows=rows, error=error)


def card_meta() -> dict:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=name,
    power.limit`` gives them for the current device."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()
    name, limit = (f.strip() for f in
                   out[torch.cuda.current_device()].split(","))
    return {"device_name": name, "power_limit_w": float(limit)}


def run_bench(tier: str = "quick",
              section_names: Optional[Sequence[str]] = None,
              timeout_scale: float = 1.0,
              progress: Optional[Callable[[str], None]] = None,
              device: str = "cuda") -> BenchResult:
    """Run every registered section of ``tier`` on ``device``; never raises
    per-section. Raises where ``device`` is the card and CUDA is absent.

    Cases whose architecture the port cannot build yet are left out before
    any section runs, and named in ``meta["cases_not_ported"]``. The
    kernels' launches during the run are in ``meta["kernel_launches"]``.
    """
    from repro_torch.core.workload import _check_device
    from repro_torch.kernels import ops

    dev = _check_device(device)
    from . import sections as _sections  # noqa: F401  (registers sections)
    from .cases import CASES, clear_caches, is_ported, tier_cases

    if section_names:
        unknown = sorted(set(section_names) - set(SECTIONS))
        if unknown:
            raise ValueError(f"unknown section(s) {unknown}; "
                             f"known: {sorted(SECTIONS)}")

    cases = tier_cases(tier)
    not_ported = [c for c in cases if not is_ported(c.arch)]
    if not_ported and progress:
        progress("cases not ported yet, left out: "
                 + ", ".join(f"{c.alias} ({c.arch})" for c in not_ported))
    ctx = BenchContext(tier=tier,
                       cases=[c for c in cases if c not in not_ported],
                       device=dev.type)
    todo = [s for s in SECTIONS.values()
            if tier in s.tiers and (not section_names or
                                    s.name in section_names)]
    launches0 = dict(ops.launches)
    results: List[SectionResult] = []
    try:
        for s in todo:
            if progress:
                progress(f"=== {s.title} ===")
            r = run_section(s, ctx, timeout_scale=timeout_scale)
            if progress:
                progress(f"[{s.name}: {r.status} in {r.wall_s:.1f}s]")
            results.append(r)
    finally:
        # drop memoized params/profiles so a long-lived caller (or a
        # second tier in the same process) doesn't hold the whole zoo
        clear_caches()
    meta = {"n_devices": (torch.cuda.device_count() if dev.type == "cuda"
                          else 1),
            "all_cases": [c.to_dict() for c in CASES],
            "cases_not_ported": [c.to_dict() for c in not_ported],
            # per-section wall_s lives on each SectionResult; the total
            # here makes run-cost regressions greppable from the artifact
            "total_wall_s": sum(r.wall_s for r in results),
            "kernel_launches": {k: n - launches0[k]
                                for k, n in ops.launches.items()}}
    if dev.type == "cuda":
        meta.update(card_meta())
    return BenchResult(
        tier=tier,
        backend=dev.type,
        jax_version=PORT_VERSION_PREFIX + torch.__version__,
        cases=list(ctx.cases),
        sections=results,
        meta=meta,
        schema_version=SCHEMA_VERSION,
    )
