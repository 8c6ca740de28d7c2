"""Training runtime: the step builder and the fault-tolerant loop.

The port of ``repro.runtime``. :func:`make_train_step` builds the step:
the loss of a working copy of the f32 masters in the activation dtype
(:func:`cast_params`), its gradient with respect to the masters (over
``num_microbatches`` microbatches, accumulated in f32), then AdamW.
:class:`Trainer` owns the loop: async checkpoints, SIGTERM-graceful
preemption, a straggler watchdog, restart-exact resume (the data is a
function of the step). PyTorch runs eagerly: the step is a plain
function, where JAX jits and donates it.

JAX's mesh half (``sharding.use_rules``, a ``Trainer`` given a mesh) is not
taken: a ``Trainer`` with a mesh raises (ROADMAP queue 1 item 5).
"""

from __future__ import annotations

import contextlib
import dataclasses
import signal
import time
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, make_batch
from repro_torch.models import lm_loss
from repro_torch.models.common import ModelConfig
from repro_torch.optim import (OptState, OptimizerConfig, adamw_update,
                               init_opt_state, tree_leaves, tree_map)


class TrainState(NamedTuple):
    params: Any
    opt: OptState


def cast_params(params, dtype):
    """The working copy: every f32 leaf of ndim >= 2 in ``dtype``, the rest
    as they are. The cast is an op of the graph, so gradients flow back
    through it to the f32 masters."""
    return tree_map(lambda p: p.to(dtype) if p.dtype == torch.float32
                    and p.ndim >= 2 else p, params)


def value_and_grad(loss_fn: Callable) -> Callable:
    """``jax.value_and_grad(loss_fn, has_aux=True)`` over a tree of tensors:
    ``loss_fn(params, *args) -> (loss, aux)`` becomes ``(params, *args) ->
    ((loss, aux), grads)``, ``grads`` the loss's gradient with respect to
    every leaf of ``params``, in ``params``' structure; loss and aux
    detached."""
    def run(params, *args):
        req = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        it = iter(req)
        loss, aux = loss_fn(tree_map(lambda p: next(it), params), *args)
        it = iter(torch.autograd.grad(loss, req))
        grads = tree_map(lambda p: next(it), params)
        aux = tree_map(lambda t: t.detach(), aux)
        return (loss.detach(), aux), grads
    return run


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                    mesh=None, num_microbatches: int = 1) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``. With
    ``num_microbatches > 1`` the batch arrives split, every leaf (n_micro,
    B_micro, ...) (:func:`microbatch_split`): the gradients are summed in
    f32 over the microbatches and divided by their count, the loss is the
    mean, the other metrics the last microbatch's."""
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step: a mesh (JAX's sharding.use_rules) is not "
            "ported; ROADMAP queue 1 item 5")

    def loss_fn(params, mb):
        working = cast_params(params, cfg.activation_dtype)
        return lm_loss(working, mb, cfg)

    grad_fn = value_and_grad(loss_fn)

    def train_step(state: TrainState, batch: dict):
        params = state.params
        if num_microbatches == 1:
            (loss, metrics), grads = grad_fn(params, batch)
        else:
            gacc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
            lacc = None
            for i in range(num_microbatches):
                mb = {k: v[i] for k, v in batch.items()}
                (loss, metrics), g = grad_fn(params, mb)
                gacc = tree_map(lambda a, b: a + b.float(), gacc, g)
                lacc = loss if lacc is None else lacc + loss
            grads = tree_map(lambda g: g / num_microbatches, gacc)
            loss = lacc / num_microbatches
        new_params, new_opt, om = adamw_update(grads, state.opt, params,
                                               opt_cfg)
        return TrainState(new_params, new_opt), {"loss": loss, **metrics,
                                                 **om}

    return train_step


def microbatch_split(batch: dict, num_microbatches: int) -> dict:
    """(B, ...) -> (n_micro, B / n_micro, ...) for every entry."""
    if num_microbatches == 1:
        return batch

    def sp(x):
        b = x.shape[0]
        assert b % num_microbatches == 0, (b, num_microbatches)
        return x.reshape(num_microbatches, b // num_microbatches,
                         *x.shape[1:])
    return {k: sp(v) for k, v in batch.items()}


def pick_microbatches(cfg: ModelConfig, seq_len: int, per_device_batch: int,
                      budget_bytes: float = 4e9) -> int:
    """Largest power-of-two split keeping the residual stashes under
    ``budget_bytes`` per device: n_layers x (B_mb x S x D) x 2 bytes."""
    per_layer = seq_len * cfg.d_model * 2.0
    total = cfg.n_layers * per_device_batch * per_layer
    n = 1
    while total / n > budget_bytes and n < max(per_device_batch, 1):
        n *= 2
    return min(n, max(per_device_batch, 1))


# ---------------------------------------------------------------------------
# fault-tolerant loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StragglerWatchdog:
    """Flags steps whose wall time is a z-score outlier against recent
    history (the detection half of a slow-host replacement)."""
    window: int = 50
    z_threshold: float = 4.0
    times: list = dataclasses.field(default_factory=list)
    flagged: int = 0

    def observe(self, seconds: float) -> bool:
        hist = self.times[-self.window:]
        is_straggler = False
        if len(hist) >= 10:
            mu = float(np.mean(hist))
            sd = float(np.std(hist)) + 1e-9
            if (seconds - mu) / sd > self.z_threshold:
                self.flagged += 1
                is_straggler = True
        self.times.append(seconds)
        return is_straggler


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    """Owns the loop: data, step, checkpoints, preemption, watchdog.
    ``init_params_fn()`` makes the f32 master params on ``device``;
    batches are drawn there."""

    def __init__(self, cfg: ModelConfig, opt_cfg: OptimizerConfig,
                 data_cfg: DataConfig, init_params_fn: Callable,
                 mesh=None, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 100, num_microbatches: int = 1,
                 log_every: int = 10, log_fn: Callable = print,
                 device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "Trainer: a mesh (JAX's sharding.use_rules / GSPMD) is not "
                "ported; ROADMAP queue 1 item 5")
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.data_cfg = data_cfg
        self.mesh = mesh
        self.device = device
        self.num_microbatches = num_microbatches
        self.ckpt_every = ckpt_every
        self.log_every = log_every
        self.log = log_fn
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.watchdog = StragglerWatchdog()
        self._preempted = False
        self._old_handler = None
        self._handler_installed = False

        params = init_params_fn()
        self.state = TrainState(params, init_opt_state(params, opt_cfg))
        self.step = 0
        self._train_step = make_train_step(cfg, opt_cfg, mesh,
                                           num_microbatches)

    # -- preemption -------------------------------------------------------
    def _on_sigterm(self, signum, frame):
        self._preempted = True

    def install_preemption_handler(self):
        if self._handler_installed:
            return
        self._old_handler = signal.signal(signal.SIGTERM, self._on_sigterm)
        self._handler_installed = True

    def restore_signal_handler(self):
        """Put the previous SIGTERM handler back (a no-op if none was
        installed); :meth:`train` calls it on exit."""
        if not self._handler_installed:
            return
        signal.signal(signal.SIGTERM, self._old_handler)
        self._old_handler = None
        self._handler_installed = False

    @contextlib.contextmanager
    def preemption_handler(self):
        """Context-manager form: install on enter, restore on exit."""
        self.install_preemption_handler()
        try:
            yield self
        finally:
            self.restore_signal_handler()

    # -- resume -----------------------------------------------------------
    def try_resume(self) -> bool:
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return False
        self.state, self.step = self.ckpt.restore(self.state)
        self.log(f"[resume] restored step {self.step} "
                 f"from {self.ckpt.directory}")
        return True

    # -- loop ---------------------------------------------------------------
    def _next_batch(self):
        batch = make_batch(self.data_cfg, self.step, self.device)
        return microbatch_split(batch, self.num_microbatches)

    def train(self, total_steps: int) -> dict:
        history = []
        last_saved_step = None
        try:
            while self.step < total_steps and not self._preempted:
                batch = self._next_batch()
                t0 = time.perf_counter()
                self.state, metrics = self._train_step(self.state, batch)
                _sync(self.device)
                dt = time.perf_counter() - t0
                if self.watchdog.observe(dt):
                    self.log(f"[watchdog] step {self.step} straggler: "
                             f"{dt:.3f}s")
                self.step += 1
                if self.step % self.log_every == 0:
                    loss = float(metrics["loss"])
                    history.append((self.step, loss))
                    self.log(f"step {self.step:>6d}  loss {loss:.4f}  "
                             f"lr {float(metrics['lr']):.2e}  {dt*1e3:.1f}ms")
                if self.ckpt and self.step % self.ckpt_every == 0:
                    self.ckpt.save(self.step, self.state)
                    last_saved_step = self.step
            if self.ckpt and (self._preempted or self.step == total_steps) \
                    and last_saved_step != self.step:
                # not when the periodic branch just saved this very step
                self.ckpt.save(self.step, self.state, async_=False)
                last_saved_step = self.step
                if self._preempted:
                    self.log(f"[preempt] final checkpoint at step "
                             f"{self.step}")
            if self.ckpt:
                self.ckpt.wait()
        finally:
            self.restore_signal_handler()
        return {"history": history, "stragglers": self.watchdog.flagged,
                "preempted": self._preempted, "step": self.step}
