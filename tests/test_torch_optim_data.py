"""The port's optimizer, data pipeline, checkpoints and training loop
(``repro_torch.optim``, ``data``, ``checkpoint``, ``runtime``): the tests of
``tests/test_optim.py``, ``tests/test_data_checkpoint.py`` and the trainer
tests of ``tests/test_runtime_serving.py`` again on the port, and
``adamw_update`` against ``repro.optim.adamw_update`` on the same gradients,
with and without int8 compression."""

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch.checkpoint import CheckpointManager, checksum
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig, TokenStream, host_slice, make_batch
from repro_torch.models import init_lm
from repro_torch.optim import (OptimizerConfig, adamw_update,
                               clip_by_global_norm, compress_decompress,
                               cosine_schedule, dequantize_int8, global_norm,
                               init_opt_state, quantize_int8, tree_leaves)
from repro_torch.runtime import (StragglerWatchdog, Trainer, cast_params,
                                 microbatch_split, pick_microbatches)


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


# -- optim -----------------------------------------------------------------

def test_adamw_minimizes_quadratic():
    cfg = OptimizerConfig(peak_lr=0.1, warmup_steps=0, total_steps=200,
                          weight_decay=0.0, grad_clip=1e9)
    target = torch.tensor([[1.0, -2.0], [3.0, 0.5]])
    params = {"w": torch.zeros((2, 2))}
    state = init_opt_state(params, cfg)
    for _ in range(200):
        grads = {"w": params["w"] - target}
        params, state, _ = adamw_update(grads, state, params, cfg)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=0.05)


def test_weight_decay_only_on_matrices():
    cfg = OptimizerConfig(peak_lr=0.1, warmup_steps=0, weight_decay=0.5)
    params = {"w": torch.ones((2, 2)), "b": torch.ones((2,))}
    state = init_opt_state(params, cfg)
    grads = {"w": torch.zeros((2, 2)), "b": torch.zeros((2,))}
    new, _, _ = adamw_update(grads, state, params, cfg)
    assert float(new["w"].max()) < 1.0      # decayed
    np.testing.assert_allclose(new["b"].numpy(), 1.0)    # not decayed


def test_clip_by_global_norm():
    g = {"a": torch.full((10,), 3.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(np.sqrt(90.0))
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    same, _ = clip_by_global_norm({"a": torch.full((4,), 0.1)}, 10.0)
    np.testing.assert_allclose(same["a"].numpy(), 0.1)


def test_cosine_schedule_shape():
    cfg = OptimizerConfig(peak_lr=1e-3, warmup_steps=10, total_steps=100,
                          end_lr_frac=0.1)
    lrs = [float(cosine_schedule(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in (0, 5, 10, 55, 100)]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(5e-4)
    assert lrs[2] == pytest.approx(1e-3)
    assert lrs[2] > lrs[3] > lrs[4]
    assert lrs[4] == pytest.approx(1e-4, rel=1e-3)


@pytest.mark.parametrize("seed,scale", [(0, 1e-3), (1, 0.37), (2, 1.0),
                                        (3, 29.0), (4, 1e3)])
def test_int8_quantization_error_bound(seed, scale):
    x = torch.randn(64, generator=torch.Generator().manual_seed(seed)) * scale
    q, s = quantize_int8(x)
    err = (dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) / 2 + 1e-6


def test_error_feedback_recovers_signal():
    g = torch.randn(128, generator=torch.Generator().manual_seed(0)) * 1e-2
    err = torch.zeros_like(g)
    total = torch.zeros_like(g)
    for _ in range(50):
        g_hat, err = compress_decompress(g, err)
        total = total + g_hat
    np.testing.assert_allclose(total.numpy(), (50 * g).numpy(), rtol=0.02,
                               atol=1e-3)


def test_compressed_adamw_roughly_tracks_uncompressed():
    cfg_c = OptimizerConfig(peak_lr=0.05, warmup_steps=0, weight_decay=0.0,
                            compress_grads=True)
    cfg_u = OptimizerConfig(peak_lr=0.05, warmup_steps=0, weight_decay=0.0)
    target = torch.tensor([[0.7, -1.2]])
    pc, pu = {"w": torch.zeros((1, 2))}, {"w": torch.zeros((1, 2))}
    sc, su = init_opt_state(pc, cfg_c), init_opt_state(pu, cfg_u)
    for _ in range(150):
        pc, sc, _ = adamw_update({"w": pc["w"] - target}, sc, pc, cfg_c)
        pu, su, _ = adamw_update({"w": pu["w"] - target}, su, pu, cfg_u)
    np.testing.assert_allclose(pc["w"].numpy(), pu["w"].numpy(), atol=0.05)


@pytest.mark.parametrize("compress", [False, True])
def test_adamw_update_matches_jax(compress):
    """Three steps of the port's ``adamw_update`` and JAX's on the same
    params and gradients (numpy, f32): new params, moments, residual, lr and
    grad norm at 1e-5 of each leaf's largest magnitude. The gradients keep
    every element far from eps (1e-8), where AdamW's normalisation would
    amplify a last-bit difference; the int8 rounding sees identical
    inputs, so compression takes the same codes."""
    rng = np.random.default_rng(0)
    shapes = {"w": (8, 16), "b": (16,), "nested": [(4, 4, 3), (5,)]}

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        if isinstance(s, list):
            return [draw(v) for v in s]
        x = rng.standard_normal(s).astype(np.float32)
        return np.sign(x) * (0.01 + np.abs(x))

    params = draw(shapes)
    grads = [draw(shapes) for _ in range(3)]
    kw = dict(peak_lr=1e-2, warmup_steps=1, total_steps=5,
              compress_grads=compress)
    jcfg, pcfg = jopt.OptimizerConfig(**kw), OptimizerConfig(**kw)
    T = lambda t: jax.tree_util.tree_map(torch.from_numpy, t)     # noqa: E731
    jp, pp = jax.tree_util.tree_map(jnp.asarray, params), T(params)
    js, ps = jopt.init_opt_state(jp, jcfg), init_opt_state(pp, pcfg)
    for g in grads:
        jp, js, jm = jopt.adamw_update(jax.tree_util.tree_map(jnp.asarray, g),
                                       js, jp, jcfg)
        pp, ps, pm = adamw_update(T(g), ps, pp, pcfg)
        for key in ("lr", "grad_norm"):
            assert float(pm[key]) == pytest.approx(float(jm[key]), rel=1e-5)
    pairs = [(pp, jp), (ps.mu, js.mu), (ps.nu, js.nu)]
    if compress:
        pairs.append((ps.err, js.err))
    for ours, theirs in pairs:
        for a, b in zip(tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=1e-5 * np.abs(b).max())
    assert int(ps.step) == int(js.step) == 3


# -- data ------------------------------------------------------------------

CFG = DataConfig(vocab_size=256, seq_len=32, global_batch=4, seed=7)


def test_batch_shapes_and_labels_shift():
    b = make_batch(CFG, 0)
    assert b["inputs"].shape == (4, 32) and b["labels"].shape == (4, 32)
    assert torch.equal(b["labels"][:, :-1], b["inputs"][:, 1:])
    assert int(b["inputs"].min()) >= 0 and int(b["inputs"].max()) < 256


def test_step_indexed_determinism():
    a, b, c = make_batch(CFG, 5), make_batch(CFG, 5), make_batch(CFG, 6)
    assert torch.equal(a["inputs"], b["inputs"])
    assert not torch.equal(a["inputs"], c["inputs"])


def test_stream_restart_exactness():
    s1 = TokenStream(CFG, start_step=0)
    seen = [next(s1) for _ in range(4)]
    s2 = TokenStream(CFG, start_step=2)     # "restart from step 2"
    assert torch.equal(seen[2]["inputs"], next(s2)["inputs"])


def test_host_slice_partitions():
    b = make_batch(CFG, 0)
    parts = [host_slice(b, i, 4) for i in range(4)]
    assert torch.equal(torch.cat([p["inputs"] for p in parts]), b["inputs"])


def test_distribution_is_learnable_not_uniform():
    """Zipf + bigram: the top token far more frequent than the median."""
    b = make_batch(DataConfig(vocab_size=128, seq_len=256, global_batch=8,
                              seed=0), 0)
    counts = np.bincount(b["inputs"].numpy().ravel(), minlength=128)
    assert counts.max() > 2.5 * max(np.median(counts), 1)


def test_bigram_shift_shows_in_the_pairs():
    """The bigram table: the next token, less the current one times the
    shift, follows the Zipf ranks (rank 0 the likeliest), so the residue 0
    comes far above uniform's 1/V (0.129 at this seed: 8x)."""
    cfg = DataConfig(vocab_size=64, seq_len=256, global_batch=4, seed=0)
    b = make_batch(cfg, 0)
    shift = int(torch.randint(1, 97, (), generator=torch.Generator()
                              .manual_seed(cfg.seed + 1)))
    resid = (b["labels"] - b["inputs"] * shift) % 64
    assert float((resid == 0).float().mean()) > 4 / 64


def test_embedding_frontend_mode():
    cfg = DataConfig(vocab_size=64, seq_len=16, global_batch=2, seed=0,
                     embed_dim=24)
    b = make_batch(cfg, 0)
    assert b["inputs"].shape == (2, 16, 24) and b["labels"].shape == (2, 16)
    assert torch.equal(b["token_inputs"][:, 1:], b["labels"][:, :-1])


# -- checkpoint -------------------------------------------------------------

def tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": [torch.ones((4,), dtype=torch.bfloat16) * 1.5,
                       torch.zeros((2, 2), dtype=torch.int32)]}


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = tree()
    mgr.save(3, t, async_=False)
    restored, step = mgr.restore(t)
    assert step == 3 and checksum(restored) == checksum(t)
    assert restored["nested"][0].dtype == torch.bfloat16
    with open(os.path.join(mgr._step_dir(3), "DONE")) as f:
        assert f.read() == "ok"


def test_async_save_then_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = tree()
    mgr.save(1, t, async_=True)
    t["a"] += 1           # the snapshot was taken before the write
    mgr.wait()
    restored, step = mgr.restore(t)
    assert step == 1 and torch.equal(restored["a"], t["a"] - 1)


def test_uncommitted_checkpoint_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree(), async_=False)
    d = mgr._step_dir(2)          # a writer killed mid-flight: no DONE
    os.makedirs(d)
    open(os.path.join(d, "arrays.npz"), "wb").close()
    assert mgr.latest_step() == 1


def test_gc_keeps_last(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree(), async_=False)
    assert mgr.steps() == [3, 4]


@pytest.mark.parametrize("change", ["shape", "structure"])
def test_restore_rejects_changed_config(tmp_path, change):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree(), async_=False)
    wrong = tree()
    if change == "shape":
        wrong["a"] = torch.zeros((5, 5))
    else:
        wrong = {"b": wrong["a"], "nested": wrong["nested"]}
    with pytest.raises(ValueError):
        mgr.restore(wrong)


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path)).restore(tree())


# -- runtime -----------------------------------------------------------------

def tiny_cfg():
    return reduced(get_config("granite-3-8b")).replace(n_layers=2,
                                                       loss_chunk=0)


def mk_trainer(tmp, cfg, micro=1, seed=0, total=60, lr=1e-3):
    # the data seed stays fixed: a restored job must see the same stream
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                          global_batch=4, seed=0)
    opt_cfg = OptimizerConfig(peak_lr=lr, warmup_steps=5, total_steps=total)
    return Trainer(cfg, opt_cfg, data_cfg,
                   init_params_fn=lambda: init_lm(
                       torch.Generator().manual_seed(seed), cfg),
                   ckpt_dir=tmp, ckpt_every=10, num_microbatches=micro,
                   log_every=100, log_fn=lambda *a: None, device="cpu")


def test_training_reduces_loss(tmp_path):
    tr = mk_trainer(str(tmp_path), tiny_cfg(), total=120, lr=3e-3)
    tr.log_every = 20
    tr.ckpt_every = 10_000
    hist = tr.train(120)["history"]
    early = sum(l for _, l in hist[:2]) / 2
    late = sum(l for _, l in hist[-2:]) / 2
    assert early > late + 0.05, hist


def test_resume_is_bit_exact(tmp_path):
    """5 + 5 steps with a restart in between == 10 straight steps."""
    cfg = tiny_cfg()
    a = mk_trainer(str(tmp_path / "a"), cfg)
    a.ckpt_every = 5
    a.train(5)                                    # checkpoints at step 5
    a2 = mk_trainer(str(tmp_path / "a"), cfg, seed=99)   # another init
    assert a2.try_resume() and a2.step == 5
    a2.train(10)
    b = mk_trainer(str(tmp_path / "b"), cfg)
    b.train(10)
    assert checksum(a2.state.params) == checksum(b.state.params)
    assert checksum(a2.state.opt) == checksum(b.state.opt)


def test_microbatch_equivalence(tmp_path):
    """Gradient accumulation over 2 microbatches ~= one large batch."""
    cfg = tiny_cfg()
    t1 = mk_trainer(str(tmp_path / "m1"), cfg, micro=1)
    t2 = mk_trainer(str(tmp_path / "m2"), cfg, micro=2)
    t1.train(3)
    t2.train(3)
    worst = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(tree_leaves(t1.state.params),
                                tree_leaves(t2.state.params)))
    assert worst < 0.05, worst     # the loss normalisation differs slightly


def test_microbatch_split_layout():
    b = {"inputs": torch.arange(12).reshape(6, 2)}
    out = microbatch_split(b, 3)
    assert out["inputs"].shape == (3, 2, 2)
    assert torch.equal(out["inputs"][0], b["inputs"][:2])


def test_pick_microbatches_budget():
    n = pick_microbatches(get_config("gemma3-27b"), 4096, 16,
                          budget_bytes=4e9)
    assert n >= 8 and (16 % n == 0 or n <= 16)


def test_straggler_watchdog():
    w = StragglerWatchdog(window=20, z_threshold=3.0)
    for _ in range(15):
        assert not w.observe(0.1 + np.random.RandomState(0).rand() * 1e-3)
    assert w.observe(5.0) and w.flagged == 1


def test_preemption_checkpoint(tmp_path):
    tr = mk_trainer(str(tmp_path), tiny_cfg())
    orig_step, calls = tr._train_step, {"n": 0}

    def step_and_preempt(state, batch):
        calls["n"] += 1
        if calls["n"] == 3:
            tr._on_sigterm(None, None)
        return orig_step(state, batch)

    tr._train_step = step_and_preempt
    out = tr.train(50)
    assert out["preempted"] and out["step"] == 3
    assert tr.ckpt.latest_step() == 3


def test_preemption_handler_restored(tmp_path):
    before = signal.getsignal(signal.SIGTERM)
    tr = mk_trainer(str(tmp_path), tiny_cfg())
    tr.install_preemption_handler()
    assert signal.getsignal(signal.SIGTERM) == tr._on_sigterm
    tr.train(2)
    assert signal.getsignal(signal.SIGTERM) == before
    with tr.preemption_handler():
        assert signal.getsignal(signal.SIGTERM) == tr._on_sigterm
    assert signal.getsignal(signal.SIGTERM) == before


def test_no_double_final_checkpoint(tmp_path):
    tr = mk_trainer(str(tmp_path), tiny_cfg())
    tr.ckpt_every = 5
    saves, orig_save = [], tr.ckpt.save
    tr.ckpt.save = lambda step, state, **kw: (saves.append(step),
                                             orig_save(step, state, **kw))
    tr.train(10)
    assert saves == [5, 10]


def test_trainer_refuses_a_mesh(tmp_path):
    cfg = tiny_cfg()
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        Trainer(cfg, OptimizerConfig(), DataConfig(cfg.vocab_size, 8, 2),
                init_params_fn=lambda: None, mesh=object(), device="cpu")


def test_cast_params_keeps_the_masters_reachable():
    p = {"w": torch.ones((2, 3), requires_grad=True),
         "b": torch.ones((3,), requires_grad=True)}
    w = cast_params(p, torch.bfloat16)
    assert w["w"].dtype == torch.bfloat16 and w["b"] is p["b"]
    (w["w"].float().sum() * 2).backward()
    assert torch.equal(p["w"].grad, torch.full((2, 3), 2.0))
