"""Op capture and the timed per-op run, through a ``TorchDispatchMode``.

The port of ``repro.core.graph.capture`` and of the eqn-by-eqn timing of
``repro.core.interpreter.ProfilingInterpreter``. PyTorch runs eagerly, so
there is no graph to trace: the function runs once under a dispatch mode
that sees every aten op (and every ``repro_torch::`` kernel op) as it is
dispatched. Each op becomes an :class:`OpRecord` whose group and site come
from the innermost ``ng:`` tag on ``repro_torch.nn``'s tag stack, or else
from the aten-op table of ``core/taxonomy.py``.

:func:`timed_run` times every op on its own: the op runs, and is
synchronised, alone — CUDA events on the card, ``perf_counter`` on the CPU
— and keeps the best of its runs. On the card the time is device time: the
card is kept busy while the host dispatches the op, so the host's launch
overhead is not counted (an eager run pays it on top; compare the
function's un-instrumented wall time). An op that mutates an input (an
in-place cache write) runs once only: running it again would change the
state the rest of the function reads; so does a collective (every rank of
its group must run it as often).

A backward op (a training capture: ``torch.autograd`` running the
gradient inside the captured function) carries its forward op's site, as
JAX's transposed equations carry their scope: the capture writes each
forward op's scope path into the metadata of the autograd node made for
it (:data:`BWD_SCOPE_KEY`), and an op dispatched while the tag stack is
empty takes ``transpose(<that path>)`` from the node autograd is running
(``torch._C._current_autograd_node``), so it classifies to the forward
op's (group, site) with JAX's vocabulary. A checkpointed region's
recompute runs under its own tags: a forward op.

Each record carries the dataflow identities the fusion pass reads
(``core/fusion.py``): a serial per live tensor, given the first time the
capture sees the tensor and anew to every output, as a jaxpr gives every
equation new output vars. The serials sit in a weak dictionary keyed by
tensor identity, so a freed tensor's reused ``id()`` never inherits a
serial and fakes an edge. PyTorch runs eagerly: ``trip_count`` is 1.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import time
from typing import Callable, Iterable, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

from .taxonomy import COLLECTIVE_PRIMS, OpGroup, classify, lookup_primitive

_DTYPE_BYTES = {
    "float32": 4, "float64": 8, "float16": 2, "bfloat16": 2,
    "int64": 8, "int32": 4, "int16": 2, "int8": 1,
    "uint64": 8, "uint32": 4, "uint16": 2, "uint8": 1,
    "bool": 1, "complex64": 8, "complex128": 16,
    "float8_e4m3fn": 1, "float8_e5m2": 1, "float8_e4m3fnuz": 1,
    "float8_e5m2fnuz": 1,
}


def dtype_bytes(dtype) -> int:
    """Bytes an element of ``dtype`` takes: a ``torch.dtype`` or its string
    (``"torch.bfloat16"``, or JAX's ``"bfloat16"``); 4 when unknown."""
    return _DTYPE_BYTES.get(str(dtype).removeprefix("torch."), 4)


@dataclasses.dataclass
class OpRecord:
    """One captured operator occurrence."""

    index: int
    prim: str               # overload packet: "aten.mm", "repro_torch.swiglu"
    group: OpGroup
    op_site: str            # semantic operator name from the ng: tag (or prim)
    scope: str              # full tag-stack path
    in_shapes: tuple
    in_dtypes: tuple
    out_shapes: tuple
    out_dtypes: tuple
    flops: float            # analytic estimate from the shapes
    bytes_accessed: float   # tensor inputs + outputs
    trip_count: int = 1     # always 1: PyTorch runs eagerly, no loop bodies
    params: dict = dataclasses.field(default_factory=dict, repr=False)
    #: tensor serials (see the module docstring), only meaningful within
    #: one captured stream: the fusion pass's producer -> consumer check
    in_var_ids: tuple = dataclasses.field(default=(), repr=False)
    out_var_ids: tuple = dataclasses.field(default=(), repr=False)
    device: str = "cpu"     # device type the op ran on

    @property
    def is_gemm(self) -> bool:
        return self.group == OpGroup.GEMM


@dataclasses.dataclass
class TimedOp:
    record: OpRecord
    seconds: float          # best-of-runs time of one execution

    @property
    def group(self) -> OpGroup:
        return self.record.group


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _numel(shape) -> int:
    return math.prod(shape) if shape else 1


_GEMM_FLOPS = {
    "aten.mm": lambda a: 2.0 * a[0][0] * a[0][1] * a[1][1],
    "aten.addmm": lambda a: 2.0 * a[1][0] * a[1][1] * a[2][1],
    "aten.bmm": lambda a: 2.0 * a[0][0] * a[0][1] * a[0][2] * a[1][2],
    "aten.baddbmm": lambda a: 2.0 * a[1][0] * a[1][1] * a[1][2] * a[2][2],
}


#: transcendentals cost a handful of flops each (JAX's ``estimate_flops``)
_TRANSCENDENTALS = frozenset(f"aten.{n}" for n in (
    "tanh", "sigmoid", "erf", "exp", "log", "rsqrt", "sqrt", "pow"))


def estimate_flops(prim: str, group: OpGroup, in_shapes, out_shapes) -> float:
    """Analytic per-op FLOP estimate, by the op itself as JAX's is by its
    primitive: GEMMs, convolutions and attention by their shapes,
    transcendentals 8 a element, sorts n log n, other arithmetic one a
    output element (reductions one a input element), data movement zero.
    The site's tag does not change an op's arithmetic (a ``mul`` in a rope
    or QDQ site costs what it costs anywhere); ``group`` prices only ops
    the aten table lacks."""
    if prim in _GEMM_FLOPS:
        return _GEMM_FLOPS[prim](in_shapes)
    if prim == "aten.convolution":
        # 2 * out elements * (in channels / groups) * kernel taps: the
        # weight is (O, I / groups, *kernel)
        return 2.0 * _numel(out_shapes[0]) * _numel(in_shapes[1][1:])
    if prim in ("repro_torch.attention_core", "repro_torch.attention_full",
                "repro_torch.attention_window", "repro_torch.decode_core",
                "repro_torch.attention_lse"):
        # every (q, k) pair of the shapes: the masks are not read
        (b, sq, hq, dk), (_, skv, _, _), (_, _, _, dv) = in_shapes[:3]
        return 2.0 * b * hq * sq * skv * (dk + dv)
    if prim == "repro_torch.attention_bwd":
        # the five products of JAX's flash backward, every (q, k) pair:
        # the scores and dQ, dK over Dk, dP and dV over Dv
        (b, sq, hq, dk), (_, skv, _, _), (_, _, _, dv) = in_shapes[:3]
        return 2.0 * b * hq * sq * skv * (3 * dk + 2 * dv)
    if prim in ("aten.sort", "aten.topk"):
        n = _numel(in_shapes[0]) if in_shapes else 0
        return float(n) * max(1.0, math.log2(max(n, 2)))
    if prim in _TRANSCENDENTALS:
        return 8.0 * _numel(out_shapes[0]) if out_shapes else 0.0
    structural = lookup_primitive(prim)
    g = group if structural is None else structural
    if g in (OpGroup.ELEMENTWISE, OpGroup.NORMALIZATION,
             OpGroup.ACTIVATION, OpGroup.LOGIT, OpGroup.FUSED):
        return float(_numel(out_shapes[0])) if out_shapes else 0.0
    if g == OpGroup.REDUCTION:
        return float(_numel(in_shapes[0])) if in_shapes else 0.0
    return 0.0


#: a collective's argument that is only written, never read: the buffer
#: ``dist.all_gather_into_tensor`` fills (an output, not an input)
_COLLECTIVE_OUT_ARGS = {"c10d._allgather_base_": 0}


def _record(index: int, func, scope: str, args, kwargs, out,
            serial) -> OpRecord:
    """``serial(t, fresh)``: the tensor's serial, a new one if ``fresh``.

    A collective's bytes are JAX's rule for them (``estimate_bytes``):
    its input and its output, never 0, the link bytes per rank (an
    all-reduce sends and receives about its payload, an all-gather
    receives the full result); the buffer an all-gather fills is its
    output alone."""
    prim = str(func.overloadpacket)
    if prim in _COLLECTIVE_OUT_ARGS:
        args = tuple(a for i, a in enumerate(args)
                     if i != _COLLECTIVE_OUT_ARGS[prim])
    ins, outs = _tensors((args, kwargs)), _tensors(out)
    in_shapes = tuple(tuple(t.shape) for t in ins)
    out_shapes = tuple(tuple(t.shape) for t in outs)
    group, op_site = classify(prim, scope)
    nbytes = sum(t.numel() * t.element_size() for t in ins + outs)
    if prim in COLLECTIVE_PRIMS:
        nbytes = max(nbytes, 1)
    return OpRecord(
        index=index, prim=prim, group=group, op_site=op_site, scope=scope,
        in_shapes=in_shapes, in_dtypes=tuple(str(t.dtype) for t in ins),
        out_shapes=out_shapes, out_dtypes=tuple(str(t.dtype) for t in outs),
        flops=estimate_flops(prim, group, in_shapes, out_shapes),
        bytes_accessed=float(nbytes),
        in_var_ids=tuple(serial(t, False) for t in ins),
        out_var_ids=tuple(serial(t, True) for t in outs),
        device=(ins + outs)[0].device.type if ins + outs else "cpu")


#: GPU cycles (~0.5 ms) the card spins before a timed op's start event, so
#: the op's host-side dispatch is enqueued before the start event is reached
#: and the event pair measures device time only, not the host's launch gap
HOST_PAD_CYCLES = 1_000_000


def _event_pair():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def empty_event_seconds(n: int = 10) -> float:
    """Least time an event pair with nothing between reports: the floor
    every on-card op time carries, subtracted from each (a view op launches
    no kernel and measures ~0)."""
    best = float("inf")
    for _ in range(n):
        torch.cuda.synchronize()
        start, end = _event_pair()
        torch.cuda._sleep(HOST_PAD_CYCLES)
        start.record()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def time_once(func, args, kwargs, floor: Optional[float]):
    """Run ``func`` once; returns (result, seconds). ``floor`` is the empty
    event pair's time on the card, ``None`` for an op on the CPU."""
    if floor is not None:
        torch.cuda.synchronize()
        start, end = _event_pair()
        torch.cuda._sleep(HOST_PAD_CYCLES)
        start.record()
        out = func(*args, **kwargs)
        end.record()
        end.synchronize()
        return out, max(start.elapsed_time(end) / 1e3 - floor, 0.0)
    t0 = time.perf_counter()
    out = func(*args, **kwargs)
    return out, time.perf_counter() - t0


class Timer:
    """Device time of one call in ms on the card (median over runs), each
    run timed by :func:`time_once` as the per-op profile times an op
    (device time only, the empty event pair subtracted), with the L2 cache
    flushed before each run: a main path finds its operands cold, with GBs
    of weights passing between two launches of one layer's kernel. The
    flush zeroes 128 MB and then reads them, so the L2 holds clean lines:
    zeroing alone would leave ~50 MB dirty, and a timed kernel would pay
    their write-back as it reads.

    :meth:`eager` is the other view: host clock over back-to-back calls,
    synchronised once — what a call costs an eager loop, host dispatch
    included."""

    def __init__(self, iters: int = 20, warmup: int = 3):
        self.floor = empty_event_seconds()
        self.iters, self.warmup = iters, warmup
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        for _ in range(self.warmup):
            fn()
        ts = []
        for _ in range(self.iters):
            self.flush.zero_()
            self.flush.sum(dtype=torch.int64)
            ts.append(time_once(fn, (), {}, self.floor)[1])
        return statistics.median(ts) * 1e3

    def eager(self, fn, n: int = 100) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3


#: the key under an autograd node's ``metadata`` that holds the scope
#: path of the forward op it differentiates
BWD_SCOPE_KEY = "ng_scope"


def backward_scope() -> str:
    """``transpose(<forward scope>)`` of the autograd node now running, or
    "" outside a backward (or for a node the capture did not see made)."""
    node = torch._C._current_autograd_node()
    fwd = node.metadata.get(BWD_SCOPE_KEY) if node is not None else None
    return f"transpose({fwd})" if fwd else ""


class _OpMode(TorchDispatchMode):
    """Records every dispatched op; times each when ``repeats`` is set."""

    def __init__(self, repeats: Optional[int] = None):
        super().__init__()
        self.repeats = repeats
        self.records: List[OpRecord] = []
        self.timed: List[TimedOp] = []
        self._floor: Optional[float] = None     # measured at the first card op
        self._serials = WeakIdKeyDictionary()
        self._next_serial = 0
        #: (output, scope) of the last op: autograd gives an output its
        #: node after the op's dispatch returns, before the next op runs
        self._pending: list = []

    def _tag_nodes(self) -> None:
        """Write the last op's scope into its outputs' autograd nodes (an
        inner op's first: the innermost tag wins, as in classification)."""
        for t, scope in self._pending:
            node = t.grad_fn
            if node is not None and BWD_SCOPE_KEY not in node.metadata:
                node.metadata[BWD_SCOPE_KEY] = scope
        self._pending.clear()

    def _serial(self, t: torch.Tensor, fresh: bool) -> int:
        if fresh or t not in self._serials:
            self._serials[t] = self._next_serial
            self._next_serial += 1
        return self._serials[t]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from repro_torch import nn

        kwargs = kwargs or {}
        self._tag_nodes()
        scope = nn.scope_path() or backward_scope()
        best = 0.0
        if self.repeats is None or func.is_view:
            # a view launches no kernel: no device time to take
            out = func(*args, **kwargs)
        else:
            on_card = any(t.is_cuda for t in _tensors((args, kwargs))) \
                or torch.device(kwargs.get("device") or "cpu").type == "cuda"
            if on_card and self._floor is None:
                self._floor = empty_event_seconds()
            floor = self._floor if on_card else None
            out, best = time_once(func, args, kwargs, floor)
            # a collective runs once: every rank of its group must run it
            # as often, and an all-reduce sums into its argument
            if not func._schema.is_mutable \
                    and str(func.overloadpacket) not in COLLECTIVE_PRIMS:
                for _ in range(self.repeats):
                    best = min(best, time_once(func, args, kwargs, floor)[1])
        rec = _record(len(self.records), func, scope, args, kwargs, out,
                      self._serial)
        self.records.append(rec)
        if scope:
            self._pending = [(t, scope) for t in _tensors(out)]
        if self.repeats is not None:
            self.timed.append(TimedOp(rec, best))
        return out


def capture(fn: Callable, *args, **kwargs) -> List[OpRecord]:
    """Run ``fn`` once and return its classified operator list."""
    with _OpMode() as mode:
        fn(*args, **kwargs)
    return mode.records


def timed_run(fn: Callable, *args, repeats: int = 3, **kwargs):
    """Run ``fn`` op by op, each op synchronised and timed on its own.

    Returns ``(fn's result, [TimedOp, ...])``. Each op that does not
    mutate an input runs ``1 + repeats`` times and keeps its best time; a
    view op (an alias of its input, no kernel) runs once and takes 0.
    """
    with _OpMode(repeats=repeats) as mode:
        out = fn(*args, **kwargs)
    return out, mode.timed


def harvest_shapes(records: Iterable[OpRecord]) -> dict:
    """Paper Table 2: realistic input shapes per NonGEMM op site.

    Returns ``{(group, op_site): [in_shapes, ...]}`` with duplicates removed,
    harvested from a real capture — the paper's "input argument
    specification extracted from real data".
    """
    out: dict = {}
    for r in records:
        key = (r.group.value, r.op_site)
        shapes = out.setdefault(key, [])
        if r.in_shapes not in shapes:
            shapes.append(r.in_shapes)
    return out
