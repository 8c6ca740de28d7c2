"""The port's traffic harness (``repro_torch.traffic``) against the JAX
package's: each test of ``tests/test_traffic.py`` again on the port, on
the same reduced granite-3-8b (2 layers) with weights bridged from JAX's
``init_lm`` (f32 on the CPU), and beside them

* traces: every generator and ``shadow_trace`` give JAX's traces for the
  same seeds, and each side reads the other's JSONL;
* ``summarize`` equals JAX's field for field on the same request
  timelines;
* ``drive`` at ``time_scale=1e5`` over the port's ``PagedEngine`` and
  ``Engine`` gives JAX's per-request tokens on the same trace;
* under tick clocks (the engines' ``clock=`` and the drivers' own), the
  whole ``LoadReport`` and every request's timeline equal JAX's.
"""

import dataclasses
import itertools
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import nn as jnn  # noqa: E402
from repro import traffic as jtraffic  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import init_lm  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import PagedEngine as JPagedEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.traffic import driver as jdriver  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.serving import Engine, PagedEngine, Request  # noqa: E402
from repro_torch.traffic import (TraceRequest, bursty_trace, drive,  # noqa: E402
                                 load_trace, poisson_trace, prime, save_trace,
                                 shadow_trace, shared_prefix_trace, summarize)
from repro_torch.traffic import driver as tdriver  # noqa: E402


@pytest.fixture(scope="module")
def traffic_model():
    """(jax config, port config, JAX params, bridged port params)."""
    jcfg = jreduced(jget_config("granite-3-8b")).replace(n_layers=2,
                                                         loss_chunk=0)
    cfg = reduced(get_config("granite-3-8b")).replace(n_layers=2, loss_chunk=0)
    jparams = init_lm(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                    cfg, device="cpu")
    return jcfg, cfg, jparams, params


def _dicts(trace):
    return [r.to_dict() for r in trace]


# -- traces: the counterparts of tests/test_traffic.py ----------------------

def test_traces_are_seed_deterministic():
    for gen in (lambda s: poisson_trace(s, 12, 100.0, 503),
                lambda s: bursty_trace(s, 12, 503),
                lambda s: shared_prefix_trace(s, 12, 503)):
        a, b = gen(7), gen(7)
        assert _dicts(a) == _dicts(b)
        assert _dicts(a) != _dicts(gen(8))


def test_trace_jsonl_roundtrip(tmp_path):
    """The port's round trip, and each side reading the other's file."""
    tr = poisson_trace(3, 10, 50.0, 503, prompt_len=(3, 24))
    path = str(tmp_path / "trace.jsonl")
    save_trace(path, tr)
    assert _dicts(load_trace(path)) == _dicts(tr)
    assert _dicts(jtraffic.load_trace(path)) == _dicts(tr)
    jpath = str(tmp_path / "jax.jsonl")
    jtraffic.save_trace(jpath, jtraffic.poisson_trace(3, 10, 50.0, 503,
                                                      prompt_len=(3, 24)))
    assert _dicts(load_trace(jpath)) == _dicts(tr)


def test_poisson_trace_arrivals_and_bounds():
    tr = poisson_trace(0, 50, 100.0, 503, prompt_len=(4, 9),
                       output_len=(2, 3))
    arrivals = [r.arrival_s for r in tr]
    assert arrivals == sorted(arrivals) and arrivals[0] > 0
    assert all(4 <= len(r.prompt) <= 9 for r in tr)
    assert all(2 <= r.max_new_tokens <= 3 for r in tr)
    assert all(0 < t < 503 for r in tr for t in r.prompt)  # pad id 0 unused


def test_bursty_trace_has_idle_gaps():
    tr = bursty_trace(1, 8, 503, burst_len=4, burst_gap_s=0.001, off_s=0.5)
    gaps = [b.arrival_s - a.arrival_s for a, b in zip(tr, tr[1:])]
    assert sum(g > 0.4 for g in gaps) == 1      # one off period
    assert all(g >= 0 for g in gaps)


def test_shared_prefix_trace_shares_exactly_the_prefix():
    tr = shared_prefix_trace(2, 6, 503, prefix_len=16, suffix_len=(4, 6))
    prefix = tr[0].prompt[:16]
    assert all(r.prompt[:16] == prefix for r in tr)
    suffixes = {tuple(r.prompt[16:]) for r in tr}
    assert len(suffixes) == len(tr)             # suffixes all distinct


def test_shadow_trace_preserves_structure_disjoint_tokens():
    tr = shared_prefix_trace(5, 4, 503, prefix_len=16)
    sh = shadow_trace(tr, 503)
    for r, s in zip(tr, sh):
        assert (s.arrival_s, len(s.prompt), s.max_new_tokens) == \
            (r.arrival_s, len(r.prompt), r.max_new_tokens)
        assert all(0 < t < 503 for t in s.prompt)
        assert s.prompt != r.prompt
    prefix = sh[0].prompt[:16]
    assert all(s.prompt[:16] == prefix for s in sh)


#: each generator by name, as a function of (traffic module, seed): the
#: port's and JAX's traces from the same seed and arguments
GENERATORS = {
    "poisson": lambda m, s: m.poisson_trace(s, 12, 100.0, 503,
                                            prompt_len=(3, 40),
                                            output_len=(1, 9)),
    "bursty": lambda m, s: m.bursty_trace(s, 11, 503, burst_len=3,
                                          burst_gap_s=0.004, off_s=0.2),
    "shared_prefix": lambda m, s: m.shared_prefix_trace(s, 7, 503,
                                                        prefix_len=20),
    "shadow": lambda m, s: m.shadow_trace(
        m.shared_prefix_trace(s, 5, 1000, prefix_len=12), 1000),
}


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_traces_equal_jax(gen, seed):
    import repro_torch.traffic as ttraffic
    got = GENERATORS[gen](ttraffic, seed)
    want = GENERATORS[gen](jtraffic, seed)
    assert got and _dicts(got) == _dicts(want)
    assert all(type(r) is TraceRequest for r in got)


# -- the driver: the counterparts of tests/test_traffic.py ------------------

def test_drive_completes_trace_and_reports(traffic_model):
    _, cfg, _, params = traffic_model
    eng = PagedEngine(cfg, params, max_batch=2, max_len=64, block_size=8,
                      chunk_size=16)
    tr = poisson_trace(11, 6, 200.0, cfg.vocab_size, prompt_len=(3, 30),
                       output_len=(2, 4))
    prime(eng, tr, cfg.vocab_size)
    assert eng.stats.completed == 0              # prime resets stats
    finished, rep = drive(eng, tr, time_scale=1e5)
    assert rep.completed == len(finished) == 6
    assert rep.emitted_tokens == sum(r.max_new_tokens for r in tr)
    assert rep.goodput_tok_per_s > 0
    assert rep.p99_ttft_s >= rep.p50_ttft_s > 0
    assert rep.mean_ttft_s >= rep.mean_service_ttft_s > 0
    assert rep.mean_ttft_s >= rep.mean_queue_wait_s >= 0
    # replaying the same trace on a fresh engine gives identical outputs
    eng2 = PagedEngine(cfg, params, max_batch=2, max_len=64, block_size=8,
                       chunk_size=16)
    finished2, _ = drive(eng2, tr, time_scale=1e5)
    outs = {tuple(r.prompt): r.output for r in finished}
    outs2 = {tuple(r.prompt): r.output for r in finished2}
    assert outs == outs2


def test_drive_max_wall_guard(traffic_model):
    _, cfg, _, params = traffic_model
    eng = PagedEngine(cfg, params, max_batch=1, max_len=64, block_size=8)
    tr = [TraceRequest(10_000.0, [1, 2, 3], 2)]
    with pytest.raises(RuntimeError, match="max_wall_s"):
        drive(eng, tr, time_scale=1.0, max_wall_s=0.2)


def test_summarize_handles_empty_run(traffic_model):
    _, cfg, _, params = traffic_model
    eng = PagedEngine(cfg, params, max_batch=1, max_len=64, block_size=8)
    rep = summarize(eng, [], 1.0)
    assert rep.completed == 0 and rep.goodput_tok_per_s == 0.0
    assert rep.p99_ttft_s == 0.0 and rep.mean_queue_wait_s == 0.0
    assert rep.n_devices == 1
    assert rep.per_device_goodput_tok_per_s == rep.goodput_tok_per_s


def test_summarize_normalizes_goodput_per_device(traffic_model):
    _, cfg, _, params = traffic_model
    eng = PagedEngine(cfg, params, max_batch=1, max_len=64, block_size=8)
    eng.tp = 4      # as JAX's test: n_devices comes from getattr(engine, "tp")
    done = []
    for p, n in (([1, 2, 3], 4), ([4, 5], 6)):
        r = Request(uid=len(done), prompt=p, max_new_tokens=n)
        r.output = list(range(n))
        done.append(r)
    rep = summarize(eng, done, 2.0)
    assert rep.n_devices == 4
    assert rep.goodput_tok_per_s == pytest.approx(10 / 2.0)
    assert rep.per_device_goodput_tok_per_s == pytest.approx(10 / 2.0 / 4)


# -- against JAX -------------------------------------------------------------

#: request timelines: (enqueue, admit, first token, finish, outputs)
#: with a request never admitted and one that emitted no decode token
TIMELINES = [
    [(0.5, 0.75, 1.25, 4.0, 5), (0.6, 1.5, 2.0, 2.0, 1), (1.0, 1.0, 3.5, 9.0, 8)],
    [(2.0, 0.0, 0.0, 0.0, 0), (0.1, 0.2, 0.3, 0.4, 2)],
    [],
]


@pytest.mark.parametrize("engine", [dict(prefix_cache=None, tp=1),
                                    dict(prefix_cache=types.SimpleNamespace(
                                        hit_rate=0.375), tp=2),
                                    dict()])
@pytest.mark.parametrize("case", range(len(TIMELINES)))
def test_summarize_equals_jax(case, engine):
    def requests(R):
        out = []
        for i, (enq, adm, first, fin, n) in enumerate(TIMELINES[case]):
            r = R(uid=i, prompt=[1, 2, 3], max_new_tokens=max(n, 1),
                  enqueue_t=enq, admit_t=adm, first_token_t=first, finish_t=fin)
            r.output = list(range(n))
            out.append(r)
        return out
    eng = types.SimpleNamespace(**engine)
    got = summarize(eng, requests(Request), 3.5)
    want = jtraffic.summarize(eng, requests(JRequest), 3.5)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert list(dataclasses.asdict(got)) == list(dataclasses.asdict(want))


def _engines(kind, jcfg, cfg, jparams, params, clock=None):
    """(the port's engine, JAX's) of one kind, on the same weights; with
    ``clock``, each engine gets its own ``clock()``."""
    kw = dict(block_size=8, chunk_size=16) if kind == "paged" else {}
    E, JE = (PagedEngine, JPagedEngine) if kind == "paged" else (Engine, JEngine)
    clocks = [dict(clock=clock()) if clock else {} for _ in range(2)]
    return (E(cfg, params, max_batch=2, max_len=64, **kw, **clocks[0]),
            JE(jcfg, jparams, max_batch=2, max_len=64, **kw, **clocks[1]))


@pytest.mark.parametrize("kind", ["paged", "contiguous"])
def test_drive_tokens_equal_jax(traffic_model, kind):
    """The same trace through the port's engine and JAX's, each by its own
    driver at time_scale=1e5: every request's tokens equal."""
    jcfg, cfg, jparams, params = traffic_model
    tr = shared_prefix_trace(3, 4, cfg.vocab_size, prefix_len=17,
                             suffix_len=(2, 9), output_len=(2, 5)) + \
        poisson_trace(4, 3, 200.0, cfg.vocab_size, prompt_len=(3, 30),
                      output_len=(2, 4))
    eng, jeng = _engines(kind, jcfg, cfg, jparams, params)
    finished, rep = drive(eng, tr, time_scale=1e5)
    with jnn.backend("jnp"):
        jfinished, jrep = jtraffic.drive(jeng, tr, time_scale=1e5)
    outs = {tuple(r.prompt): r.output for r in finished}
    assert len(outs) == rep.completed == jrep.completed == len(tr)
    assert outs == {tuple(r.prompt): r.output for r in jfinished}
    assert rep.emitted_tokens == jrep.emitted_tokens == \
        sum(r.max_new_tokens for r in tr)
    assert rep.prefix_hit_rate == jrep.prefix_hit_rate


def _tick_time(dt):
    """A stand-in for the driver's ``time`` module: ``perf_counter``
    advances by ``dt`` at every read, ``sleep`` returns at once."""
    ticks = itertools.count(1)
    return types.SimpleNamespace(perf_counter=lambda: next(ticks) * dt,
                                 sleep=lambda s: None)


@pytest.mark.parametrize("kind", ["paged", "contiguous"])
def test_drive_accounting_equals_jax_under_tick_clocks(traffic_model,
                                                        monkeypatch, kind):
    """Arrivals spread over the run at time_scale 1: with the drivers'
    clocks and the engines' ``clock=`` both ticking, requests arrive at the
    same steps, so every stamp, TTFT, queue wait and the whole LoadReport
    equal JAX's."""
    jcfg, cfg, jparams, params = traffic_model
    tr = poisson_trace(5, 6, 8.0, cfg.vocab_size, prompt_len=(3, 30),
                       output_len=(2, 5))
    monkeypatch.setattr(tdriver, "time", _tick_time(0.05))
    monkeypatch.setattr(jdriver, "time", _tick_time(0.05))
    eng, jeng = _engines(kind, jcfg, cfg, jparams, params,
                         clock=lambda: itertools.count(1).__next__)
    finished, rep = drive(eng, tr, time_scale=1.0, max_wall_s=1e6)
    with jnn.backend("jnp"):
        jfinished, jrep = jtraffic.drive(jeng, tr, time_scale=1.0,
                                         max_wall_s=1e6)

    def timeline(done):
        return sorted((r.enqueue_t, r.admit_t, r.first_token_t, r.finish_t,
                       tuple(r.output)) for r in done)
    assert timeline(finished) == timeline(jfinished)
    assert rep.to_dict() == jrep.to_dict()
    # the requests did not all arrive at once: some waited in the queue
    assert rep.mean_queue_wait_s > 0 and rep.completed == len(tr)
    assert len({r.enqueue_t for r in finished}) > 1
