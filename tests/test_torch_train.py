"""The port's training side against the JAX package, f32 on the CPU.

* ``kernels/ref.py``'s flash twins, ``attention_fwd_lse`` and
  ``attention_bwd``, against ``repro.models.attention._flash_fwd_impl`` /
  ``_flash_bwd_impl`` (JAX's flash custom VJP, GQA expanded before its core
  as ``flash_attention_jnp`` does, its per-head dK / dV summed over the
  group as its head gather's transpose does);
* ``lm_loss`` and its gradient for reduced granite-3-8b with 2 KV heads
  (GQA kept) and reduced stablelm-3b (LayerNorm, partial rope), loss_chunk
  0 and 16, on JAX's weights (``params_from_jax``), on both ``nn``
  backends;
* one ``make_train_step`` step at 1 and 2 microbatches: loss, new params,
  ``mu``, ``nu``, lr and grad norm (``opt_state_from_jax``);
* ``Workload(phase="train")``'s capture: JAX's tagged (group, site) pairs,
  every backward record of a tagged op carrying its site, GEMM FLOPs within
  1 % of JAX's estimate.

Port only: the kernel wrappers' gradients under ``nn.backend("cuda")`` on
CPU tensors against autograd of the plain chains; the remat policies
giving equal gradients, ``proj`` holding two tensors a block; a train step
of every reduced LM config of the zoo.

Tolerances: f32 at 1e-5 of each leaf's (or tensor's) largest magnitude
(the readings are 1e-7 to 2e-6, summation order). JAX's references are
computed once per module fixture.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import graph as jax_graph
from repro.core.taxonomy import parse_scope as jax_parse_scope
from repro.core.workload import Workload as JaxWorkload
from repro.models import init_lm as jax_init_lm
from repro.models import lm_loss as jax_lm_loss
from repro.models.attention import _flash_bwd_impl, _flash_fwd_impl
from repro.optim import OptimizerConfig as JaxOptimizerConfig
from repro.optim import init_opt_state as jax_init_opt_state
from repro.runtime import TrainState as JaxTrainState
from repro.runtime import make_train_step as jax_make_train_step
from repro.runtime import microbatch_split as jax_microbatch_split
from repro_torch import nn
from repro_torch.bridge import opt_state_from_jax, params_from_jax
from repro_torch.configs import _CONFIGS, get_config, reduced
from repro_torch.core import graph
from repro_torch.core.taxonomy import parse_scope
from repro_torch.core.workload import Workload
from repro_torch.kernels import ops, ref
from repro_torch.models import init_lm, lm_loss
from repro_torch.models import transformer as T
from repro_torch.optim import OptimizerConfig, init_opt_state, tree_leaves
from repro_torch.runtime import (TrainState, make_train_step,
                                 microbatch_split, value_and_grad)

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tensors are tiny: on one intra-op thread, as on a pool of
    them, but a pool makes every op a barrier across its threads, which
    is two orders of magnitude slower when the CPU is shared (pytest's
    workers); the thread count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, rtol=RTOL):
    a = np.asarray(a.detach().float() if torch.is_tensor(a) else a)
    b = np.asarray(b.detach().float() if torch.is_tensor(b) else b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=rtol * max(np.abs(b).max(), 1e-30))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- the flash twins --------------------------------------------------------

# (b, sq, skv, hq, hkv, d, causal, window, q_offset, chunk_q, chunk_kv):
# chunks that do not divide the lengths pad both in JAX's
FLASH_CASES = [
    (2, 37, 37, 4, 2, 16, True, None, 0, 16, 16),
    (1, 20, 50, 4, 1, 8, True, None, 30, 8, 16),
    (2, 40, 40, 2, 2, 8, True, 7, 0, 16, 16),
    (1, 24, 64, 4, 2, 16, True, 9, 40, 16, 32),
    (1, 33, 29, 4, 4, 8, False, None, 0, 16, 8),
]


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[f"c{c[6]}-w{c[7]}-o{c[8]}" for c in FLASH_CASES])
def test_flash_twins_match_jax(case):
    b, sq, skv, hq, hkv, d, causal, window, off, cq, ck = case
    rng = np.random.default_rng(sum(case[:6]))
    q, do = (rng.standard_normal((b, sq, hq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
            for _ in range(2))
    g = hq // hkv
    ke, ve = (jnp.asarray(np.repeat(t, g, axis=2)) for t in (k, v))
    o_j, lse_j = _flash_fwd_impl(jnp.asarray(q), ke, ve, causal, window, off,
                                 cq, ck, None)
    dq_j, dk_j, dv_j = _flash_bwd_impl(jnp.asarray(q), ke, ve, o_j, lse_j,
                                       jnp.asarray(do), causal, window, off,
                                       cq, ck)
    group_sum = lambda t: np.asarray(t).reshape(b, skv, hkv, g, d).sum(3)  # noqa: E731
    t = torch.from_numpy
    o, lse = ref.attention_fwd_lse(t(q), t(k), t(v), causal=causal,
                                   window=window, q_offset=off)
    dq, dk, dv = ref.attention_bwd(t(q), t(k), t(v), o, lse, t(do),
                                   causal=causal, window=window, q_offset=off)
    _close(o, o_j)
    _close(lse, lse_j)
    _close(dq, dq_j)
    _close(dk, group_sum(dk_j))
    _close(dv, group_sum(dv_j))


def test_flash_backward_of_a_row_that_sees_no_key_is_zero():
    """A window of 3 at positions 11-18 over 10 keys: row 0 sees key 9,
    the others none. They give zeros out, a NEG_INF lse and zero gradients,
    and move no key's gradient: dV is that of row 0 alone (JAX's
    exp(NEG_INF - lse) reads 1 at such rows; the port's select, 0)."""
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(s, generator=g) for s in
                   ((1, 8, 2, 16), (1, 10, 1, 16), (1, 10, 1, 16),
                    (1, 8, 2, 16)))
    o, lse = ref.attention_fwd_lse(q, k, v, window=3, q_offset=11)
    dq, dk, dv = ref.attention_bwd(q, k, v, o, lse, do, window=3, q_offset=11)
    assert torch.all(o[:, 1:] == 0) and torch.all(lse[..., 1:] == ref.NEG_INF)
    assert torch.all(dq[:, 1:] == 0) and bool(dq[:, 0].abs().sum() > 0)
    o1, lse1 = ref.attention_fwd_lse(q[:, :1], k, v, window=3, q_offset=11)
    _, _, dv1 = ref.attention_bwd(q[:, :1], k, v, o1, lse1, do[:, :1],
                                    window=3, q_offset=11)
    # one key seen: p is 1 and dk the cancellation dp - delta, ~0
    _close(dv, dv1)
    _close(dv[0, 9, 0], do[0, 0].sum(0))
    assert torch.all(dk[:, :9] == 0) and torch.all(dv[:, :9] == 0)


# -- lm_loss and its gradient ------------------------------------------------

LOSS_CASES = [(arch, chunk) for arch in ("granite-3-8b", "stablelm-3b")
              for chunk in (0, 16)]


def _cfg_pair(arch, **kw):
    if arch == "granite-3-8b":
        kw.setdefault("n_kv_heads", 2)      # reduced() leaves it at 4 / 4
    return (jax_reduced(jax_get_config(arch)).replace(**kw),
            reduced(get_config(arch)).replace(**kw))


def _batch(vocab, b=2, s=40, masked=True):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    if masked:
        labels[0, -3:] = -1
    return toks, labels


@pytest.fixture(scope="module")
def jax_losses():
    """(arch, chunk) -> (numpy params, cfg, batch, loss, metrics, grads)."""
    out = {}
    for arch, chunk in LOSS_CASES:
        jc, pc = _cfg_pair(arch, loss_chunk=chunk)
        jp = jax_init_lm(jax.random.PRNGKey(0), jc)
        toks, labels = _batch(jc.vocab_size)
        batch = {"inputs": jnp.asarray(toks), "labels": jnp.asarray(labels)}
        (loss, met), grads = jax.jit(jax.value_and_grad(
            lambda p: jax_lm_loss(p, batch, jc), has_aux=True))(jp)
        out[arch, chunk] = (_np(jp), pc, (toks, labels), float(loss),
                            _np(met), _np(grads))
    return out


@pytest.mark.parametrize("backend", [None, "cuda"])
@pytest.mark.parametrize("arch,chunk", LOSS_CASES)
def test_lm_loss_and_grads_match_jax(jax_losses, arch, chunk, backend):
    jp, cfg, (toks, labels), loss_j, met_j, grads_j = jax_losses[arch, chunk]
    params = params_from_jax(jp, cfg, device="cpu")
    batch = {"inputs": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()}
    with nn.backend(backend):
        (loss, met), grads = value_and_grad(
            lambda p, b: lm_loss(p, b, cfg))(params, batch)
    assert float(loss) == pytest.approx(loss_j, rel=RTOL)
    assert float(met["tokens"]) == float(met_j["tokens"]) == 77
    assert float(met["ce"]) == pytest.approx(float(met_j["ce"]), rel=RTOL)
    want = params_from_jax(grads_j, cfg, device="cpu")
    for a, b in zip(tree_leaves(grads), tree_leaves(want)):
        _close(a, b)


def test_lm_loss_clamps_and_masks_labels():
    """Labels < 0 are masked out, and the CE reads max(label, 0): a masked
    -5 takes no part, the loss equals the unmasked positions' mean."""
    cfg = reduced(get_config("llama2-7b"))
    params = init_lm(torch.Generator().manual_seed(0), cfg)
    toks, labels = _batch(cfg.vocab_size, masked=False)
    x, lab = torch.from_numpy(toks).long(), torch.from_numpy(labels).long()
    lab_masked = lab.clone()
    lab_masked[:, -5:] = -5
    loss, met = lm_loss(params, {"inputs": x, "labels": lab_masked}, cfg)
    logits = T.lm_forward(params, x, cfg)
    ce = torch.nn.functional.cross_entropy(
        logits[:, :-5].reshape(-1, cfg.vocab_size), lab[:, :-5].reshape(-1))
    assert float(met["tokens"]) == 2 * 35
    assert float(loss) == pytest.approx(float(ce), rel=RTOL)


# -- the kernel wrappers' gradients on CPU tensors ---------------------------

def _grads(fn, inputs, seed=3):
    inputs = [t.detach().clone().requires_grad_(t.is_floating_point())
              for t in inputs]
    outs = fn(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    g = torch.Generator().manual_seed(seed)
    w = [torch.randn(o.shape, generator=g) for o in outs]
    total = sum((o.float() * ww).sum() for o, ww in zip(outs, w))
    diff = [t for t in inputs if t.requires_grad]
    return outs, torch.autograd.grad(total, diff)


def _rand(*shape, seed=0):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


WRAPPER_CASES = {
    "rms_norm": (lambda x, s: ops.rms_norm(x, s, zero_centered=True),
                 lambda x, s: ref.rms_norm(x, s, zero_centered=True),
                 [(2, 5, 64), (64,)]),
    "fused_add_rms_norm": (ops.fused_add_rms_norm, ref.fused_add_rms_norm,
                           [(2, 5, 64), (2, 5, 64), (64,)]),
    "layer_norm": (ops.layer_norm, ref.layer_norm,
                   [(2, 5, 48), (48,), (48,)]),
    "fused_add_layer_norm": (ops.fused_add_layer_norm,
                             ref.fused_add_layer_norm,
                             [(2, 5, 48), (2, 5, 48), (48,), (48,)]),
    "swiglu": (ops.swiglu, ref.swiglu, [(3, 40), (3, 40)]),
    "geglu": (ops.geglu, ref.geglu, [(3, 40), (3, 40)]),
    "attention_core": (lambda q, k, v: ops.attention_core(q, k, v, q_offset=3),
                       lambda q, k, v: ref.attention(q, k, v, q_offset=3),
                       [(2, 9, 4, 16), (2, 12, 2, 16), (2, 12, 2, 16)]),
    "attention_window": (lambda q, k, v: ops.attention_window(q, k, v, 4),
                         lambda q, k, v: ref.attention(q, k, v, window=4),
                         [(2, 11, 4, 16), (2, 11, 1, 16), (2, 11, 1, 16)]),
    "attention_full": (ops.attention_full,
                       lambda q, k, v: ref.attention(q, k, v, causal=False),
                       [(1, 7, 2, 16), (1, 13, 2, 16), (1, 13, 2, 16)]),
}


@pytest.mark.parametrize("name", sorted(WRAPPER_CASES) + ["rope"])
def test_wrapper_gradients_match_the_plain_chains(name):
    """Each kernel-backed op differentiated through its ``register_autograd``
    (the attention ops: the lse forward and ``attention_bwd``'s plain
    twin; the rest: the gradient of their plain version) against autograd
    of the plain chain; no launch is counted for CPU tensors."""
    if name == "rope":
        pos = torch.arange(6, dtype=torch.int32)[None].expand(2, 6)
        ins = [_rand(2, 6, 3, 20)]
        op = lambda x: ops.rope(x, pos, fraction=0.5)          # noqa: E731
        plain = lambda x: ref.rope(x, pos, fraction=0.5)       # noqa: E731
    else:
        op, plain, shapes = WRAPPER_CASES[name]
        ins = [_rand(*s, seed=i) for i, s in enumerate(shapes)]
    ops.reset_launches()
    outs, g_op = _grads(op, ins)
    want, g_plain = _grads(plain, ins)
    for a, b in zip(outs, want):
        _close(a, b)
    for a, b in zip(g_op, g_plain):
        _close(a, b)
    assert not any(ops.launches.values())


@pytest.mark.parametrize("name", ["decode_core", "softmax_xent",
                                  "dequant_add_rms_norm", "nms_sorted"])
def test_ops_without_a_training_path_refuse_a_gradient(name):
    x = _rand(4, 64).requires_grad_(True)
    if name == "decode_core":
        q = _rand(2, 1, 2, 16).requires_grad_(True)
        out = ops.decode_core(q, _rand(2, 5, 1, 16), _rand(2, 5, 1, 16),
                              torch.full((2,), 3, dtype=torch.int32))
    elif name == "softmax_xent":
        out = ops.softmax_xent(x, torch.zeros(4, dtype=torch.int64))
    elif name == "dequant_add_rms_norm":
        out = ops.dequant_add_rms_norm(torch.ones(4, 64, dtype=torch.int8),
                                       torch.tensor(0.5), x, torch.ones(64))[0]
    else:
        boxes = torch.rand(5, 4).cumsum(-1).requires_grad_(True)
        out = ops.nms_sorted(boxes, torch.ones(5, dtype=torch.bool)).float()
        if not out.requires_grad:       # a bool output carries no graph
            return
    with pytest.raises(RuntimeError, match="no gradient"):
        out.float().sum().backward()


@pytest.mark.parametrize("name", ["attention_core", "attention_window",
                                  "attention_full"])
def test_prefill_gradient_runs_through_the_lse_op(name):
    """A prefill wrapper asked for a gradient returns the output of the
    ``repro_torch::attention_lse`` op, whose autograd formula holds the
    rows' log-sum-exp as a real output (not differentiable); under
    ``no_grad`` the same inputs take the op without the lse; the raw
    prefill op refuses a gradient, naming the wrapper."""
    op, _, shapes = WRAPPER_CASES[name]
    ins = [_rand(*s, seed=i).requires_grad_(True) for i, s in enumerate(shapes)]
    out = op(*ins)
    assert "attention_lse" in type(out.grad_fn).__name__
    with torch.no_grad():
        assert op(*ins).grad_fn is None
    mask = {"attention_core": "causal", "attention_window": "window",
            "attention_full": "full"}[name]
    o, lse = ops.attention_with_lse(*ins, mask, 4 if mask == "window" else 1)
    assert o.requires_grad and not lse.requires_grad
    assert lse.dtype == torch.float32 and lse.shape == (
        ins[0].shape[0], ins[0].shape[2], ins[0].shape[1])
    raw = getattr(torch.ops.repro_torch, name)
    extra = (4,) if name == "attention_window" else ()
    with pytest.raises(RuntimeError, match=f"call ops.{name}"):
        raw(*ins, *extra).sum().backward()


def test_attention_gradient_refuses_a_softcap():
    q = _rand(1, 4, 2, 16).requires_grad_(True)
    with pytest.raises(ValueError, match="takes no cap"):
        ops.attention_core(q, _rand(1, 4, 2, 16), _rand(1, 4, 2, 16),
                           softcap=30.0)


# -- remat ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def remat_setup():
    cfg = reduced(get_config("granite-3-8b")).replace(n_kv_heads=2,
                                                      loss_chunk=16)
    params = init_lm(torch.Generator().manual_seed(0), cfg)
    toks, labels = _batch(cfg.vocab_size)
    batch = {"inputs": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()}
    return cfg, params, batch


def _loss_grads(cfg, params, batch):
    return value_and_grad(lambda p, b: lm_loss(p, b, cfg))(params, batch)


@pytest.mark.parametrize("backend", [None, "cuda"])
@pytest.mark.parametrize("policy", ["full", "proj", "dots"])
def test_remat_moves_memory_not_values(remat_setup, policy, backend):
    cfg, params, batch = remat_setup
    with nn.backend(backend):
        (l0, _), g0 = _loss_grads(cfg, params, batch)
        (l1, _), g1 = _loss_grads(cfg.replace(remat=True,
                                              remat_policy=policy),
                                  params, batch)
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
        assert torch.equal(a, b)


def test_proj_holds_two_tensors_a_block(remat_setup, monkeypatch):
    """``proj``: two checkpointed regions a block, whose activation inputs
    (what the backward holds; the params are the caller's) are exactly the
    block's input and the attention out-projection's output."""
    cfg, params, batch = remat_setup
    cfg = cfg.replace(remat=True, remat_policy="proj", loss_chunk=0)
    held = []
    real = T._checkpoint

    def spy(fn, *args, **kw):
        if fn in (T._block_mixer, T._block_rest):
            held.append({id(a) for a in args[1:] if torch.is_tensor(a)
                         and a.dim() == 3})
        return real(fn, *args, **kw)

    monkeypatch.setattr(T, "_checkpoint", spy)
    _loss_grads(cfg, params, batch)
    assert len(held) == 2 * cfg.n_layers
    for mixer, rest in zip(held[::2], held[1::2]):
        assert len(mixer) == 1 and len(rest) == 2 and mixer < rest


# -- one train step ------------------------------------------------------------

@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches_jax(micro):
    """One step of ``make_train_step``: loss, lr and grad norm at 1e-5; mu
    and nu (linear in the gradient and its square) at 1e-5 of each leaf's
    largest; the new params at 1e-5 of each leaf's largest where the
    gradient element is above 1e-4 of the leaf's largest (below, AdamW's
    m / (sqrt(v) + eps) turns a 1e-6 difference of a gradient near eps
    into a visible one), and everywhere within 2 lr of each other (the most
    a first step can move an element apart). JAX's layers unstacked
    (``scan_layers=False``): its ``_is_matrix`` decays the stacked (n_rep,
    d) norm scales, a layout the port's per-layer tree has not (ROADMAP
    queue 3)."""
    jc, pc = _cfg_pair("granite-3-8b", scan_layers=False)
    kw = dict(warmup_steps=2, total_steps=10)
    jo, po = JaxOptimizerConfig(**kw), OptimizerConfig(**kw)
    jp = jax_init_lm(jax.random.PRNGKey(0), jc)
    toks, labels = _batch(jc.vocab_size, b=4, s=24, masked=False)
    jb = jax_microbatch_split({"inputs": jnp.asarray(toks),
                               "labels": jnp.asarray(labels)}, micro)
    js, jm = jax.jit(jax_make_train_step(jc, jo, num_microbatches=micro))(
        JaxTrainState(jp, jax_init_opt_state(jp, jo)), jb)
    pp = params_from_jax(_np(jp), pc, "cpu")
    pb = microbatch_split({"inputs": torch.from_numpy(toks).long(),
                           "labels": torch.from_numpy(labels).long()}, micro)
    ps, pm = make_train_step(pc, po, num_microbatches=micro)(
        TrainState(pp, init_opt_state(pp, po)), pb)
    for key in ("loss", "lr", "grad_norm", "ce"):
        assert float(pm[key]) == pytest.approx(float(jm[key]), rel=RTOL), key
    want_p = params_from_jax(_np(js.params), pc, "cpu")
    want_o = opt_state_from_jax(_np(js.opt), pc, "cpu")
    assert int(ps.opt.step) == int(want_o.step) == 1
    for ours, theirs in ((ps.opt.mu, want_o.mu), (ps.opt.nu, want_o.nu)):
        for a, b in zip(tree_leaves(ours), tree_leaves(theirs)):
            _close(a, b)
    lr = float(jm["lr"])
    for a, b, m in zip(tree_leaves(ps.params), tree_leaves(want_p),
                       tree_leaves(want_o.mu)):
        assert float((a - b).abs().max()) <= 2 * lr
        sure = m.abs() > 1e-4 * m.abs().max()
        _close(a[sure], b[sure])


# -- the train capture ----------------------------------------------------------

@pytest.fixture(scope="module")
def train_captures():
    spec = dict(name="train", arch="granite-3-8b", phase="train", batch=1,
                seq=16)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jfn, jargs = JaxWorkload(**spec).build()
        jrec = jax_graph.capture(jfn, *jargs)
    out = {}
    for backend in (None, "cuda"):
        with nn.backend(backend):
            fn, args = Workload(**spec).build(device="cpu")
            out[backend] = graph.capture(fn, *args)
    return jrec, out


@pytest.mark.parametrize("backend", [None, "cuda"])
def test_train_capture_sites_match_jax(train_captures, backend):
    """Reduced granite-3-8b's train capture (remat off): JAX's tagged
    (group, site) pairs, forward and backward. JAX 0.9.0's capture
    records each ``jit`` equation as one untagged OTHER op (ROADMAP queue
    3); here its three carry no tagged pair, so no pair is lost."""
    jrec, recs = train_captures[0], train_captures[1][backend]
    pairs = lambda rs, parse: {(r.group.value, r.op_site)             # noqa: E731
                               for r in rs if parse(r.scope)}
    assert pairs(recs, parse_scope) == pairs(jrec, jax_parse_scope)
    jax_bwd = pairs([r for r in jrec if "transpose(" in r.scope],
                    jax_parse_scope)
    bwd = [r for r in recs if r.scope.startswith("transpose(")]
    assert bwd and all(parse_scope(r.scope) for r in bwd)
    assert pairs(bwd, parse_scope) == jax_bwd
    gemm = lambda rs: sum(r.flops for r in rs if r.group.value == "gemm")  # noqa: E731
    assert gemm(recs) == pytest.approx(gemm(jrec), rel=0.01)
    if backend == "cuda":
        sites = {r.op_site for r in recs if r.prim == "repro_torch.attention_bwd"}
        assert sites == {"flash_attention"}


# -- the zoo ----------------------------------------------------------------------

LM_ARCHS = sorted(n for n in _CONFIGS if not get_config(n).is_vision)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_every_reduced_lm_trains(arch):
    """One loss and gradient of every reduced LM config through the kernel
    wrappers (``nn.backend("cuda")``: on CPU tensors each takes its plain
    version under its autograd formula): a finite loss, a finite gradient
    for every leaf, none of them all zero."""
    cfg = reduced(get_config(arch))
    params = init_lm(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(1)
    x = (torch.randint(0, cfg.vocab_size, (2, 24), generator=g)
         if cfg.input_mode == "tokens"
         else torch.randn(2, 24, cfg.d_model, generator=g))
    labels = torch.randint(0, cfg.vocab_size, (2, 24), generator=g)
    with nn.backend("cuda"):
        (loss, _), grads = _loss_grads(cfg, params,
                                       {"inputs": x, "labels": labels})
    assert torch.isfinite(loss)
    leaves = tree_leaves(grads)
    assert len(leaves) == len(tree_leaves(params))
    for t in leaves:
        assert torch.isfinite(t).all() and bool(t.abs().sum() > 0)


def test_workload_train_no_longer_raises():
    fn, args = Workload(name="t", arch="llama2-7b", phase="train",
                        seq=8).build(device="cpu")
    grads = fn(*args)
    assert set(grads) == set(args[0]) == {"embed", "layers", "final_norm",
                                          "head"}
