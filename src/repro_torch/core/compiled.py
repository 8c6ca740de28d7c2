"""The compiled view: a ``torch.compile``'d forward, measured, each kernel
given the paper's operator group.

The port's twin of JAX's ``compiled:<hw>`` view (``repro.core.workload``'s
``CompiledBackend`` over ``repro.core.hlo``), which jits, parses the HLO
and prices each fusion on a TPU spec. Here the forward goes through
PyTorch's own compiler, ``torch.compile(fn, fullgraph=True,
dynamic=False)`` in its default mode (Inductor, no CUDA graphs, no
autotuning), and the program is measured, not modeled:

* :func:`compile_forward` compiles on one call. The port's kernel ops
  (``repro_torch::<name>``, ``kernels/ops.py``) are custom ops with fake
  implementations, so each stays one opaque call inside the program, and
  Inductor fuses the plain chains around them. While it compiles, every
  kernel Inductor emits is recorded with its origin FX nodes, whose meta
  carries the ``ng:`` scope path of the op that traced them
  (``nn.COMPILED_SCOPE_KEY``); the custom ops' own nodes are listed in
  graph order.
* :func:`measure` (and :func:`profile_compiled`, which compiles first)
  holds the compiled output against the eager forward (the guard: a
  compiled view of another function measures nothing), times the
  un-instrumented call (median of ``repeats``), and profiles one call
  with ``torch.profiler``, after a warm-up step, until the profile holds
  every hand-written launch the wrappers counted. Each kernel is
  attributed through the op that launched it (:func:`kernel_group`): an
  extern aten op by the aten table (``aten::mm`` and the other products:
  GEMM), a ``repro_torch::`` op by the group its tag gives it in eager
  mode, an Inductor kernel by :func:`fusion_group`'s vote over its
  origins.

:func:`fusion_group` is ``repro.core.hlo._fusion_group``'s rule, copied: a
tagged origin votes 2, an untagged one 1 (its group from the aten table),
``OTHER`` and ``CONTROL`` do not vote, a tie goes to the group counted
first, and a kernel with no vote is ``OTHER``. A graph break raises
(``fullgraph=True``) and nothing runs the eager forward in the compiled
one's place.

Inductor's and Triton's caches go under the repo's ``build/``. Inductor's
FX-graph caches are off while a forward compiles: a cached graph skips
the code generation that gives each kernel its origins.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import statistics
import sys
import time
import types
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from .profiler import ModelProfile
from .taxonomy import KERNEL_NAMESPACE, OpGroup, lookup_primitive, parse_scope

#: the repo's build directory (``.gitignore`` lists it)
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"

#: the compiled output against the eager forward's, ``|c - e| <= atol +
#: rtol * |e|``: the kernels' limits of PERF.md §2 (f32's atol is
#: ``tests/test_kernels.py``'s ``_tol``)
TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (3e-2, 2 ** -7)}
#: on the card, the anchored logit rule of PERF.md §2: the compiled logits
#: within twice the eager kernel path's distance from the plain path's,
#: LOGIT_ATOL at the least
LOGIT_ATOL = 0.125
F32_ANCHOR = 2.0

#: the Inductor function that every kernel's code generation calls with
#: the kernel's scheduler nodes and its name
_PROVENANCE = "set_kernel_post_grad_provenance_tracing"

Vote = Tuple[OpGroup, bool]
#: custom ops counted under another name in ``kernels/ops.launches``
_COUNTER = {"nms_sorted": "nms"}
#: profiles :func:`measure` takes at most to find every counted kernel
PROFILE_ATTEMPTS = 3


def fusion_group(origins: Iterable[Vote]) -> OpGroup:
    """The group of a fused kernel from its origins' ``(group, tagged)``:
    ``repro.core.hlo._fusion_group``'s majority vote (a tagged origin
    votes 2, an untagged one 1, ``OTHER`` and ``CONTROL`` do not vote, a
    tie goes to the group counted first; no vote gives ``OTHER``)."""
    votes: Dict[OpGroup, int] = {}
    for g, tagged in origins:
        if g in (OpGroup.OTHER, OpGroup.CONTROL):
            continue
        w = 2 if tagged else 1
        votes[g] = votes.get(g, 0) + w
    if not votes:
        return OpGroup.OTHER
    return max(votes, key=votes.get)


def _prim(node) -> str:
    """An FX node's op as the taxonomy names it (``aten.add``)."""
    packet = getattr(node.target, "overloadpacket", None)
    return str(packet if packet is not None else node.target)


def origin_vote(node) -> Vote:
    """``(group, tagged)`` of one origin FX node: the group its carried
    scope path gives it, else the aten table's; tagged where the path holds
    an ``ng:`` tag (JAX's ``"ng:" in op_name``)."""
    from repro_torch.nn import COMPILED_SCOPE_KEY

    scope = (node.meta.get("custom") or {}).get(COMPILED_SCOPE_KEY, "")
    tagged = parse_scope(scope)
    # a graph's nodes are no captured ops: no miss is counted as unknown
    group = tagged[0] if tagged is not None else (
        lookup_primitive(_prim(node)) or OpGroup.OTHER)
    return group, "ng:" in scope


@dataclasses.dataclass
class CompiledForward:
    """A compiled forward and what its compile recorded."""

    fn: Callable                    # the torch.compile'd callable
    #: Inductor kernel name -> its origin FX nodes' votes, in graph order
    kernels: Dict[str, List[Vote]]
    #: custom op (``repro_torch::<name>``) -> its calls' eager groups, in
    #: graph order
    ops: Dict[str, List[OpGroup]]
    #: how many of the graph's nodes carried a tag, of how many ops
    tagged_nodes: int
    graph_nodes: int
    output: object                  # what the compiling call returned
    compile_seconds: float          # the compiling call's host seconds

    def __call__(self, *args):
        return self.fn(*args)


def _origins(node_schedule, is_extern: bool) -> list:
    """The origin FX nodes of one emitted kernel (Inductor's own reading in
    ``debug.set_kernel_post_grad_provenance_tracing``)."""
    if is_extern:
        one = getattr(node_schedule, "origin_node", None)
        return [one] if one is not None else list(node_schedule.origins)
    out = []
    for snode in node_schedule:
        nodes = snode.get_nodes() if hasattr(snode, "get_nodes") else [snode]
        for n in nodes:
            ir = getattr(n, "node", None)
            if ir is not None:
                out.extend(ir.origins)
    return out


@contextlib.contextmanager
def _recording_kernels(kernels: Dict[str, list]):
    """Record every kernel Inductor emits, ``name -> origin FX nodes``, by
    wrapping the provenance function its code generators call (in every
    ``torch._inductor`` module that holds it)."""
    import torch._inductor.debug as idebug

    original = getattr(idebug, _PROVENANCE, None)
    if original is None:
        raise RuntimeError(
            f"torch {torch.__version__}: torch._inductor.debug has no "
            f"{_PROVENANCE}; the compiled view cannot attribute its kernels")

    def record(node_schedule, kernel_name, is_extern=False):
        if kernel_name and not is_extern:
            seen = kernels.setdefault(str(kernel_name), [])
            for o in _origins(node_schedule, is_extern):
                if o.op == "call_function" and o not in seen:
                    seen.append(o)
        return original(node_schedule, kernel_name, is_extern)

    def swap(old, new):
        for mod in list(sys.modules.values()):
            if getattr(mod, "__name__", "").startswith("torch._inductor") \
                    and getattr(mod, _PROVENANCE, None) is old:
                setattr(mod, _PROVENANCE, new)

    swap(original, record)
    try:
        yield
    finally:
        swap(record, original)


def _cache_dirs() -> None:
    """Inductor's and Triton's caches under ``build/``. Set, not defaulted:
    torch sets ``TORCHINDUCTOR_CACHE_DIR`` to a directory under the system's
    temporary one the first time it asks for it (an eager capture does)."""
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(BUILD_ROOT / sub)


def _fresh(fn: Callable) -> Callable:
    """``fn`` behind a function with a code object of its own. Dynamo keeps
    its compiled programs on the code object it compiled: a second compile
    of one function would reuse the first program and record nothing."""
    def forward(*args):
        return fn(*args)
    return types.FunctionType(forward.__code__.replace(),
                              forward.__globals__, forward.__name__, None,
                              forward.__closure__)


def compile_forward(fn: Callable, *args) -> CompiledForward:
    """``torch.compile(fn, fullgraph=True, dynamic=False)`` in the default
    mode, compiled by one call on ``args``; a graph break raises. Returns
    the compiled callable with each Inductor kernel's origins and the
    custom ops' groups, in graph order."""
    import torch._inductor.config as iconfig
    from torch._inductor.custom_graph_pass import CustomGraphPass

    _cache_dirs()
    graph: list = []

    class _Grab(CustomGraphPass):
        """Keeps the post-grad graph's call nodes (the kernels' origins)."""

        def __call__(self, g):
            graph.extend(n for n in g.nodes if n.op == "call_function")

        def uuid(self):
            return "repro_torch.compiled"

    compiled = torch.compile(_fresh(fn), fullgraph=True, dynamic=False)
    origins: Dict[str, list] = {}
    t0 = time.perf_counter()
    with iconfig.patch({"fx_graph_cache": False,
                        "post_grad_custom_post_pass": _Grab(),
                        "cpp.enable_kernel_profile": True}), \
            torch._functorch.config.patch(enable_autograd_cache=False), \
            _recording_kernels(origins):
        out = compiled(*args)
    seconds = time.perf_counter() - t0
    index = {n: i for i, n in enumerate(graph)}
    kernels = {k: [origin_vote(n) for n in sorted(
        v, key=lambda n: index.get(n, len(index)))]
        for k, v in origins.items()}
    ops: Dict[str, List[OpGroup]] = defaultdict(list)
    for n in graph:
        prim = _prim(n)
        if prim.startswith(KERNEL_NAMESPACE + "."):
            name = prim.replace(".", "::", 1)
            ops[name].append(origin_vote(n)[0])
    tagged = sum(origin_vote(n)[1] for n in graph)
    return CompiledForward(compiled, kernels, dict(ops), tagged, len(graph),
                           out, seconds)


def kernel_group(name: str, compiled: CompiledForward,
                 calls: Dict[str, int]) -> Optional[OpGroup]:
    """The group of a kernel launched by the op named ``name`` in a
    profile (``calls`` counts the custom ops' calls so far, for their
    graph order); None where ``name`` launches no kernel of the program."""
    if name in compiled.kernels:
        return fusion_group(compiled.kernels[name])
    if name.startswith(KERNEL_NAMESPACE + "::"):
        groups = compiled.ops.get(name, [])
        i = calls[name]
        calls[name] += 1
        if i >= len(groups):
            raise RuntimeError(f"{name}: call {i + 1} in the profile, "
                               f"{len(groups)} in the compiled graph")
        return groups[i]
    if name.startswith("aten::"):
        return lookup_primitive("aten." + name[len("aten::"):]) or OpGroup.OTHER
    return None


def _kernel_name(name: str, compiled: CompiledForward) -> str:
    """An event's name as the compile recorded it: the CPU kernels' events
    carry a ``graph_<n>_`` prefix."""
    if name.startswith("graph_") and name not in compiled.kernels:
        rest = name.split("_", 2)[-1]
        if rest in compiled.kernels:
            return rest
    return name


#: aten ops a compiled program calls that compute nothing (allocations,
#: views): on the CPU, where there are no device kernels to read, they are
#: not kernels
_NO_KERNEL = frozenset({
    "aten::empty", "aten::empty_strided", "aten::as_strided", "aten::view",
    "aten::_reshape_alias", "aten::resolve_conj", "aten::resolve_neg",
    "aten::detach", "aten::alias", "aten::lift_fresh"})


def _launching(evt, compiled: CompiledForward):
    """The outermost op among ``evt`` and its ancestors that launches a
    kernel of the program (an Inductor kernel, a custom op, an aten op),
    or None."""
    out = None
    while evt is not None:
        name = _kernel_name(evt.name, compiled)
        if name in compiled.kernels or name.startswith(
                (KERNEL_NAMESPACE + "::", "aten::")):
            out = evt
        evt = evt.cpu_parent
    return out


def attribute(events, compiled: CompiledForward,
              on_card: bool) -> List[Tuple[str, OpGroup, float]]:
    """``(kernel, group, seconds)`` of each kernel of one profiled call, in
    launch order. On the card, each device kernel's time goes to the op
    that launched it; on the CPU, each outermost launching op is a kernel
    and its host time is the kernel's. A kernel no op of the program
    launched is ``OTHER`` under its own name."""
    from torch.autograd import DeviceType

    calls: Dict[str, int] = defaultdict(int)
    groups: dict = {}           # id(launching event) -> (kernel, group)
    out = []
    cpu = sorted((e for e in events
                  if e.device_type == DeviceType.CPU and not e.is_async),
                 key=lambda e: e.time_range.start)
    for e in cpu:
        if on_card and not e.kernels:
            continue
        top = _launching(e, compiled)
        if not on_card and (top is not e or e.name in _NO_KERNEL):
            continue
        seconds = (sum(k.duration for k in e.kernels) if on_card
                   else e.time_range.elapsed_us()) / 1e6
        if top is None:
            out.append((e.name, OpGroup.OTHER, seconds))
            continue
        if id(top) not in groups:
            name = _kernel_name(top.name, compiled)
            g = kernel_group(name, compiled, calls)
            groups[id(top)] = (name, OpGroup.OTHER if g is None else g)
        out.append((*groups[id(top)], seconds))
    return out


def _max_excess(got: torch.Tensor, want: torch.Tensor, atol: float,
                rtol: float) -> float:
    """Largest ``|got - want| - (atol + rtol * |want|)``: > 0 fails."""
    g, w = got.double(), want.double()
    return float(((g - w).abs() - (atol + rtol * w.abs())).max())


def check_output(got, fn: Callable, args, on_card: bool) -> dict:
    """The guard: the compiled output ``got`` against the eager forward
    ``fn(*args)``; raises past the limit. On the CPU, ``|c - e| <= atol +
    rtol * |e|`` at the dtype's :data:`TOL`; on the card the anchored
    logit rule against the plain path (``nn.backend("torch")``). Returns
    the reading."""
    from repro_torch import nn

    want = fn(*args)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"compiled output {tuple(got.shape)} "
                             f"{got.dtype}, eager {tuple(want.shape)} "
                             f"{want.dtype}")
    diff = float((got.double() - want.double()).abs().max())
    if on_card:
        with nn.backend("torch"):
            plain = fn(*args)
        vs_plain = float((want.double() - plain.double()).abs().max())
        limit = max(LOGIT_ATOL, F32_ANCHOR * vs_plain)
        ok = math.isfinite(diff) and diff <= limit
        reading = dict(max_abs_diff=diff, eager_vs_plain=vs_plain,
                       limit=limit)
    else:
        atol, rtol = TOL[want.dtype]
        ok = math.isfinite(diff) and _max_excess(got, want, atol, rtol) <= 0
        reading = dict(max_abs_diff=diff, atol=atol, rtol=rtol)
    if not ok:
        raise AssertionError(f"compiled output differs from the eager "
                             f"forward's: {reading}")
    return reading


def _sync(on_card: bool) -> None:
    if on_card:
        torch.cuda.synchronize()


def _wall(compiled: CompiledForward, args, on_card: bool,
          repeats: int) -> float:
    """Median seconds of ``repeats`` un-instrumented calls: CUDA events
    around each call on the card, ``perf_counter`` on the CPU."""
    ts = []
    for _ in range(repeats):
        _sync(on_card)
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            compiled(*args)
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            compiled(*args)
            ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def _profiled(compiled: CompiledForward, args: tuple, on_card: bool):
    """The kernels of one call under ``torch.profiler`` (:func:`attribute`),
    after one call under the started profiler (device activity at a
    profiler's start can be missed), and the hand-written kernels the
    wrappers counted in a call (none on the CPU, where they launch
    nothing): ``(kernels, {kernel name: launches})``."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.kernels import ops

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    counted = dict(ops.launches)
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            compiled(*args)
            _sync(on_card)
            prof.step()
    per_call = {k: (n - counted[k]) // 2 for k, n in ops.launches.items()
                if n > counted[k]}
    return attribute(prof.events(), compiled, on_card), per_call


def measure(compiled: CompiledForward, fn: Callable, args: tuple,
            name: str = "model", device="cuda",
            repeats: int = 5) -> ModelProfile:
    """The compiled view of a compiled forward (mode ``compiled_cuda`` on
    the card, ``compiled_cpu`` on the CPU): its output held to the eager
    ``fn(*args)`` (:func:`check_output`), the median of ``repeats``
    un-instrumented calls, then one profiled call (:func:`_profiled`):
    ``group_seconds`` / ``op_seconds`` (keyed ``(group, kernel)``) sum its
    kernels' times. On the card the profile must hold each hand-written
    kernel as often as the wrappers counted it: a profile that lost one (a
    device record the profiler did not tie to its op) is taken again, up
    to PROFILE_ATTEMPTS times, then raises. ``ModelProfile.compiled`` keeps
    the median (``wall_s``), the compile's seconds, the profiled call's
    launches per kernel, the profiles taken and the guard's reading. A
    recompile while timing raises."""
    on_card = torch.device(device).type == "cuda"
    guard = check_output(compiled.output, fn, args, on_card)
    with torch._dynamo.config.patch(error_on_recompile=True):
        wall = _wall(compiled, args, on_card, repeats)
        for attempt in range(1, PROFILE_ATTEMPTS + 1):
            kernels, counted = _profiled(compiled, args, on_card)
            launches: dict = defaultdict(int)
            for kernel, _, _ in kernels:
                launches[kernel] += 1
            seen = {_COUNTER.get(k, k): n for k, n in
                    ((k.split("::", 1)[1], n) for k, n in launches.items()
                     if k.startswith(KERNEL_NAMESPACE + "::"))}
            if not on_card or seen == counted:
                break
        else:
            raise RuntimeError(f"{PROFILE_ATTEMPTS} profiles held the "
                               f"hand-written kernels {seen}; the wrappers "
                               f"counted {counted} a call")
    group_s: dict = defaultdict(float)
    op_s: dict = defaultdict(float)
    for kernel, group, seconds in kernels:
        group_s[group.value] += seconds
        op_s[(group.value, kernel)] += seconds
    return ModelProfile(
        name=name, mode="compiled_cuda" if on_card else "compiled_cpu",
        group_seconds=dict(group_s), total_seconds=sum(group_s.values()),
        op_seconds=dict(op_s), n_ops=len(kernels),
        compiled=dict(wall_s=wall, compile_s=compiled.compile_seconds,
                      launches=dict(launches), profiles=attempt,
                      guard=guard))


def profile_compiled(fn: Callable, *args, name: str = "model",
                     device="cuda", repeats: int = 5) -> ModelProfile:
    """Compile ``fn`` on ``args`` (:func:`compile_forward`; the compiling
    call is the warm-up) and :func:`measure` it."""
    return measure(compile_forward(fn, *args), fn, args, name=name,
                   device=device, repeats=repeats)
