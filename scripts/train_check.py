"""Training on one GPU: granite-3-8b at full width through the kernel path,
held to the plain path, resumed from a checkpoint, timed and split.

``chip_smoke.py``'s phase ``train`` (:func:`train_phase`) and its phase-5
rows of the training pair (:func:`time_train_pair`), and standalone::

    python3 scripts/train_check.py [--ptxas-dir DIR]

granite-3-8b (JAX's training driver's model, ``repro/launch/train.py``) at
its full width (d_model 4096, GQA 32/8 of 128, d_ff 12800, vocab 49155,
tied) and its first TRAIN_LAYERS layers, f32 masters with a bf16 working
copy, batch TRAIN_BATCH x TRAIN_SEQ, ``loss_chunk`` 512, remat ``proj``,
seed 0, unfused:

(a) one loss and gradient on the kernel path, the plain path in bf16
    (``nn.backend("torch")``) and the plain path in f32 (the anchor), from
    the same weights and batch: the kernel path's loss and every leaf's
    gradient at most twice the bf16 plain path's distance from the anchor,
    a floor at the least (GRAD_FLOOR of the leaf's RMS in the anchor; the
    loss's :func:`loss_floor`), each limit printed with the arm that set
    it;
(b) the ``Trainer`` for TRAIN_STEPS steps with a checkpoint at
    TRAIN_CKPT_STEP: a fresh ``Trainer`` (another init) resumes from it and
    runs the rest; its params against an uninterrupted run's (equal, and
    max |delta|);
(c) the uninterrupted run's steps after its first: median step ms and
    tokens/s with min and max, ``torch.cuda.max_memory_allocated``, the
    launches a step of the training kernels against their analytic count
    (:func:`step_launches`), and one ``Workload(phase="train")`` measured
    split at s512 (device ms by group, the backward's share, the top
    sites).

With ``--ptxas-dir`` the standalone run first writes ``nvcc -Xptxas -v``'s
registers and spills of ``attention.cu``, ``attention_lse.cu`` and
``attention_bwd.cu``. Prints JSON lines; needs a GPU.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))

TRAIN_ARCH = "granite-3-8b"
#: the depth the card trains at: the first layers, the cut the served
#: models take; the embedding and head stay whole
TRAIN_LAYERS = 2
TRAIN_BATCH, TRAIN_SEQ = 2, 2048
TRAIN_LOSS_CHUNK = 512
TRAIN_STEPS, TRAIN_CKPT_STEP = 6, 3
TRAIN_SPLIT_SEQ = 512
#: the anchored rule's floor for a gradient leaf: this share of the leaf's
#: RMS in the f32 anchor, half a bf16 ulp of a typical entry (the largest
#: entries round by up to 2^-8 of themselves, so 2 * d_p sets every leaf
#: whose largest entries the bf16 plain path rounds at all)
GRAD_FLOOR = 2.0 ** -8
#: the card's dense peaks, as chip_smoke.py's
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
#: the kernels a training step of a dense model runs, unfused; rope is the
#: plain chain unfused (as JAX's), so its count is 0
STEP_KERNELS = ("attention_lse", "attention_bwd", "rms_norm", "rope",
                "swiglu", "attention_core")


def train_config(get_config):
    return get_config(TRAIN_ARCH).replace(
        n_layers=TRAIN_LAYERS, loss_chunk=TRAIN_LOSS_CHUNK, remat=True,
        remat_policy="proj")


def step_launches(cfg) -> dict:
    """The training kernels' launches in one step of a dense rmsnorm /
    swiglu model with remat ``proj``, unfused: each layer's forward runs
    norm1, the lse forward, norm2 and swiglu; its backward recomputes both
    regions (the same four again) and runs the flash backward once; the
    final norm runs once, outside any region. No kernel has a backward of
    its own but attention's (the norms' and swiglu's are their plain
    versions' gradients)."""
    n = cfg.n_layers
    return {"attention_lse": 2 * n, "attention_bwd": n, "rms_norm": 4 * n + 1,
            "rope": 0, "swiglu": 2 * n, "attention_core": 0}


def _tree_leaves(tree):
    from repro_torch.optim import tree_leaves
    return tree_leaves(tree)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def loss_floor(loss: float, tokens: int) -> float:
    """The anchored rule's floor for the loss, a mean over ``tokens``
    cross-entropies in f32 of bf16 logits: GRAD_FLOOR of the loss (each
    token's loss moved by its logits' rounding) over sqrt(tokens), as
    independent roundings average out."""
    return GRAD_FLOOR * abs(loss) / math.sqrt(tokens)


def anchored_grads(torch, nn, cfg, params, batch, emit, fail) -> dict:
    """(a): loss and gradients on the three paths; the rule on each, and
    which arm set each limit (``2*d_p`` or ``floor``)."""
    from repro_torch.models import lm_loss
    from repro_torch.runtime import cast_params, value_and_grad

    def run(c, backend):
        fn = value_and_grad(lambda p, b: lm_loss(
            cast_params(p, c.activation_dtype), b, c))
        with nn.backend(backend):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (loss, _), grads = fn(params, batch)
            torch.cuda.synchronize()
        return float(loss), dict(_paths(grads)), time.perf_counter() - t0

    def limit(d_p, floor):
        return (2 * d_p, "2*d_p") if 2 * d_p >= floor else (floor, "floor")

    def share(d, lim):
        return d / lim if lim else (0.0 if d == 0 else math.inf)

    kernel = run(cfg, None)
    plain = run(cfg, "torch")
    anchor = run(cfg.replace(dtype="float32"), "torch")
    rows, bad = [], []
    for name, ga in anchor[1].items():
        ga = ga.float()
        d_k = float((kernel[1][name].float() - ga).abs().max())
        d_p = float((plain[1][name].float() - ga).abs().max())
        lim, arm = limit(d_p, GRAD_FLOOR * float(ga.square().mean().sqrt()))
        if not math.isfinite(d_k) or d_k > lim:
            bad.append(name)
        rows.append((name, d_k, d_p, lim, arm))
    worst = max(rows, key=lambda r: share(r[1], r[3]))
    tokens = int((batch["labels"] >= 0).sum())
    loss_limit, loss_arm = limit(abs(plain[0] - anchor[0]),
                                 loss_floor(anchor[0], tokens))
    loss_ok = abs(kernel[0] - anchor[0]) <= loss_limit
    emit(phase="train", step="anchored", config=cfg.name, layers=cfg.n_layers,
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, loss_kernel=kernel[0],
         loss_plain_bf16=plain[0], loss_f32_anchor=anchor[0],
         loss_limit=loss_limit, loss_limit_arm=loss_arm,
         loss_share_of_limit=share(abs(kernel[0] - anchor[0]), loss_limit),
         loss_ok=loss_ok, leaves=len(rows),
         worst_leaf=worst[0], worst_kernel_dist=worst[1],
         worst_plain_dist=worst[2], worst_limit=worst[3],
         worst_limit_arm=worst[4],
         worst_share_of_limit=round(share(worst[1], worst[3]), 4),
         leaves_by_arm={a: sum(r[4] == a for r in rows)
                        for a in ("2*d_p", "floor")},
         leaf_share_arm=[[r[0], round(share(r[1], r[3]), 4), r[4]]
                         for r in rows],
         bad_leaves=bad, floor=GRAD_FLOOR,
         step_s=[round(kernel[2], 3), round(plain[2], 3), round(anchor[2], 3)])
    if bad or not loss_ok:
        fail(f"train: the kernel path's loss or gradients break the anchored "
             f"rule: loss {kernel[0]} vs {anchor[0]} (limit {loss_limit}), "
             f"leaves {bad[:5]}")
    return {"worst_leaf": worst[0]}


def trainer_resume(torch, ops, cfg, emit, fail) -> dict:
    """(b) and (c): the uninterrupted run (its steps after the first timed,
    its launches counted), the run stopped at TRAIN_CKPT_STEP and a fresh
    trainer resumed from its checkpoint; returns the launches of the timed
    steps (the main path's run)."""
    from repro_torch.data import DataConfig
    from repro_torch.models import init_lm
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime import Trainer

    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=0)
    opt = OptimizerConfig(peak_lr=3e-4, warmup_steps=2,
                          total_steps=TRAIN_STEPS)

    def trainer(seed, ckpt_dir=None):
        return Trainer(cfg, opt, data, init_params_fn=lambda: init_lm(
            torch.Generator("cuda").manual_seed(seed), cfg),
            ckpt_dir=ckpt_dir, ckpt_every=TRAIN_CKPT_STEP, log_every=1,
            log_fn=lambda *a: None, device="cuda")

    torch.cuda.reset_peak_memory_stats()
    full = trainer(0)
    full.train(1)                       # the first step: warm-up, untimed
    ops.reset_launches()
    out = full.train(TRAIN_STEPS)
    launched = dict(ops.launches)
    times = full.watchdog.times[1:]
    per_step = {k: launched[k] / (TRAIN_STEPS - 1) for k in STEP_KERNELS}
    want = step_launches(cfg)
    ms = [t * 1e3 for t in times]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    emit(phase="train", step="timing", steps=len(times),
         step_ms_median=statistics.median(ms), step_ms_min=min(ms),
         step_ms_max=max(ms),
         tokens_per_s=tokens / statistics.median(times),
         tokens_per_s_min=tokens / max(times),
         tokens_per_s_max=tokens / min(times),
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         launches_per_step=per_step, launches_analytic=want,
         loss_history=out["history"])
    if per_step != {k: float(v) for k, v in want.items()}:
        fail(f"train: launches a step {per_step}, expected {want}")
    with tempfile.TemporaryDirectory(prefix="train_ckpt_") as tmp:
        t0 = time.perf_counter()
        first = trainer(0, tmp)
        first.train(TRAIN_CKPT_STEP)        # saves at TRAIN_CKPT_STEP
        saved = first.ckpt.steps()
        del first
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        resumed = trainer(1, tmp)           # another init: the restore wins
        ok = resumed.try_resume() and resumed.step == TRAIN_CKPT_STEP
        t2 = time.perf_counter()
        resumed.ckpt = None                 # no further checkpoint
        resumed.train(TRAIN_STEPS)
        pairs = list(zip(_tree_leaves(resumed.state.params),
                         _tree_leaves(full.state.params)))
        same = all(torch.equal(a, b) for a, b in pairs)
        delta = max(float((a.float() - b.float()).abs().max())
                    for a, b in pairs)
        emit(phase="train", step="resume", checkpoints=saved,
             resumed_at=TRAIN_CKPT_STEP, steps=TRAIN_STEPS,
             params_equal=same, max_abs_delta=delta,
             run_and_save_s=round(t1 - t0, 2), restore_s=round(t2 - t1, 2),
             wall_s=round(time.perf_counter() - t0, 2))
        if not ok or saved != [TRAIN_CKPT_STEP] or not math.isfinite(delta):
            fail(f"train: resume from step {TRAIN_CKPT_STEP} failed "
                 f"(checkpoints {saved}, max |delta| {delta})")
    return launched


def train_split(torch, cfg, emit, fail) -> None:
    """(c): one ``Workload(phase="train")`` measured split at s512: every
    op of the step (forward, the regions' recompute, backward, the f32
    master gradients) timed on the card, by group, with the backward's
    share (the records that carry ``transpose(...)``)."""
    from repro_torch.core import Workload
    from repro_torch.models import init_lm, lm_loss
    from repro_torch.runtime import cast_params, value_and_grad

    def builder(w, device):
        params = init_lm(torch.Generator(device).manual_seed(0), cfg)
        gen = torch.Generator(device).manual_seed(1)
        x = torch.randint(0, cfg.vocab_size, (w.batch, w.seq),
                          generator=gen, device=device)
        grad = value_and_grad(lambda p, b: lm_loss(
            cast_params(p, cfg.activation_dtype), b, cfg))
        return (lambda p, b: grad(p, b)[1]), ({"inputs": x, "labels": x},), params

    w = Workload(name=f"{cfg.name} train b-1 s-{TRAIN_SPLIT_SEQ}",
                 arch=cfg.name, phase="train", batch=1, seq=TRAIN_SPLIT_SEQ,
                 dtype="bfloat16", builder=builder)
    prof = w.profile("measured", repeats=1)
    bwd = sum(t.seconds for t in prof.timed_ops
              if t.record.scope.startswith("transpose("))
    total = prof.total_seconds
    split = prof.split
    emit(phase="train", step="split", model=prof.name, n_ops=prof.n_ops,
         device_ms=total * 1e3, gemm_frac=split["gemm_frac"],
         backward_ms=bwd * 1e3, backward_frac=bwd / total if total else None,
         group_ms={g: t * 1e3 for g, t in sorted(
             prof.group_seconds.items(), key=lambda kv: -kv[1])},
         top_op_sites=[[f"{g}:{s}", round(t * 1e3, 4), round(p, 2)]
                       for (g, s), t, p in prof.top_op_sites(10)])
    if prof.mode != "measured_cuda" or not bwd > 0:
        fail(f"train: the split timed no backward op on the card ({prof.mode})")


def train_phase(torch, emit, fail) -> dict:
    """Phase ``train``: (a), (b), (c) in turn, each freeing what it made.
    Returns the kernels' launches of the uninterrupted run's timed steps."""
    from repro_torch import nn
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.kernels import ops
    from repro_torch.models import init_lm

    cfg = train_config(get_config)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()

    def emit_card(**kw):                # every figure beside the card
        emit(**kw, nvidia_smi=smi)
    params = init_lm(torch.Generator("cuda").manual_seed(0), cfg)
    n_params = sum(t.numel() for t in _tree_leaves(params))
    batch = make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=0), 0, "cuda")
    emit_card(phase="train", step="init", config=cfg.name,
              layers=cfg.n_layers, n_params=n_params,
              param_dtype=cfg.param_dtype, dtype=cfg.dtype,
              remat_policy=cfg.remat_policy, loss_chunk=cfg.loss_chunk)
    anchored_grads(torch, nn, cfg, params, batch, emit_card, fail)
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    launched = trainer_resume(torch, ops, cfg, emit_card, fail)
    gc.collect()
    torch.cuda.empty_cache()
    train_split(torch, cfg, emit_card, fail)
    gc.collect()
    torch.cuda.empty_cache()
    return launched


def time_train_pair(torch, ops, ref, entry, randn) -> dict:
    """Phase 5's rows of the training pair at granite-3-8b's shape (q
    [2,2048,32,128], kv [2,2048,8,128], bf16, causal): the lse forward
    beside the entry without the lse (``no_lse_ms``) and beside the flash
    SDPA forward, which also returns the rows' log-sum-exp, KV expanded to
    32 heads; attention_bwd beside ``aten._scaled_dot_product_flash_
    attention_backward`` (the efficient backend's where flash is absent)
    on the same KV expansion, the plain twins beside each. Bounds: the
    bytes each reads and writes once; the forward's two products and the
    backward's five (the scores and dQ, dK over Dk, dP and dV over Dv)
    over the visible pairs, at the bf16 rate."""
    b, s, hq, hkv, d = 2, 2048, 32, 8, 128
    q, do = randn((b, s, hq, d)), randn((b, s, hq, d))
    k, v = randn((b, s, hkv, d)), randn((b, s, hkv, d))
    out, lse = ops.attention_with_lse(q, k, v, "causal")
    qt, dot, ot = (t.transpose(1, 2).contiguous() for t in (q, do, out))
    kt, vt = (t.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
              for t in (k, v))
    visible = b * hq * s * (s + 1) // 2
    shape = (f"q[{b},{s},{hq},{d}] kv[{b},{s},{hkv},{d}] bf16 causal "
             "(granite-3-8b training)")
    io = 2 * (2 * b * s * hq * d + 2 * b * s * hkv * d)
    flash = torch.ops.aten._scaled_dot_product_flash_attention
    try:
        fwd = flash(qt, kt, vt, 0.0, True)
        library_fwd = lambda: flash(qt, kt, vt, 0.0, True)        # noqa: E731
        bwd_op = torch.ops.aten._scaled_dot_product_flash_attention_backward
        library_bwd = lambda: bwd_op(                             # noqa: E731
            dot, qt, kt, vt, fwd[0], fwd[1], fwd[2], fwd[3], fwd[4], fwd[5],
            0.0, True, fwd[6], fwd[7])
        library = "flash"
    except RuntimeError:
        eff = torch.ops.aten._scaled_dot_product_efficient_attention
        fwd = eff(qt, kt, vt, None, True, 0.0, True)
        library_fwd = lambda: eff(qt, kt, vt, None, True, 0.0, True)  # noqa: E731
        bwd_op = torch.ops.aten._scaled_dot_product_efficient_attention_backward
        library_bwd = lambda: bwd_op(                             # noqa: E731
            dot, qt, kt, vt, None, fwd[0], fwd[1], fwd[2], fwd[3], 0.0,
            [True, True, True, False], True)
        library = "efficient"
    lse_row = entry(shape, lambda: ops.attention_with_lse(q, k, v, "causal"),
                    lambda: ref.attention_fwd_lse(q, k, v), library_fwd,
                    io + 4 * b * hq * s, 2 * visible * 2 * d, "bfloat16")
    lse_row["no_lse_ms"] = entry(shape, lambda: ops.attention_core(q, k, v),
                                 None, None, io, 0)["ms"]
    lse_row["library"] = f"aten._scaled_dot_product_{library}_attention"
    bwd_row = entry(shape,
                    lambda: ops.attention_bwd(q, k, v, out, lse, do, "causal"),
                    lambda: ref.attention_bwd(q, k, v, out, lse, do),
                    library_bwd,
                    2 * io + 4 * b * hq * s,
                    2 * visible * (3 * d + 2 * d), "bfloat16")
    bwd_row["library"] = f"aten._scaled_dot_product_{library}_attention_backward"
    return {"attention_lse": lse_row, "attention_bwd": bwd_row}


def _ptxas_entries(text: str) -> dict:
    """{mangled kernel name from its template on (the translation unit's
    namespace prefix cut): (registers, spill store bytes)} of one ``nvcc
    -Xptxas -v`` report."""
    out, name, spill = {}, None, 0
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            name = name[name.find("attn"):] if "attn" in name else name
        elif "bytes spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif "Used" in line and "registers" in line and name:
            out[name] = (int(line.split("Used ")[1].split(" reg")[0]), spill)
            name, spill = None, 0
    return out


def _ptxas(torch, out: Path) -> None:
    """Registers and spills of the attention sources; each lse
    instantiation beside the same template without the lse (its last
    template argument, ``LSE``, set to false) in ``attention.cu``."""
    from repro_torch.kernels import _build
    out.mkdir(parents=True, exist_ok=True)
    reports = {}
    for src in ("attention", "attention_lse", "attention_bwd"):
        r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                            "-o", str(out / f"ptxas_{src}.so"),
                            str(_build.CSRC / f"{src}.cu")],
                           capture_output=True, text=True)
        (out / f"ptxas_{src}.txt").write_text(r.stderr)
        reports[src] = _ptxas_entries(r.stderr)
        regs = sorted({v[0] for v in reports[src].values()})
        spilled = sorted({v[1] for v in reports[src].values() if v[1]})
        print(json.dumps({"ptxas": src, "kernels": len(reports[src]),
                          "registers": regs, "spill_store_bytes": spilled}),
              flush=True)
    pairs = []
    for name, (regs, spill) in reports["attention_lse"].items():
        twin = name.replace("Lb1EEEv", "Lb0EEEv", 1)
        if twin in reports["attention"]:
            pairs.append([regs, spill, *reports["attention"][twin]])
    print(json.dumps({"ptxas": "lse vs without", "pairs": len(pairs),
                      "same_registers": sum(p[0] == p[2] for p in pairs),
                      "lse_regs_spill_vs_without": pairs}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptxas-dir", default=None,
                    help="write nvcc -Xptxas -v's reports here first")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("train_check: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.core import graph
    from repro_torch.kernels import _build, ops, ref

    t0 = time.time()
    _build.build()
    print(json.dumps({"build_s": round(time.time() - t0, 2)}), flush=True)
    if args.ptxas_dir:
        _ptxas(torch, Path(args.ptxas_dir))
    torch.backends.cuda.matmul.allow_tf32 = False

    def emit(**kw):
        print(json.dumps(kw), flush=True)

    def fail(msg):
        raise SystemExit(f"train_check: {msg}")

    train_phase(torch, emit, fail)
    timer = graph.Timer()
    gen = torch.Generator("cuda").manual_seed(0)

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    def entry(shape, kernel, plain, library, nbytes, flops, peak="float32"):
        from repro_torch.core.hardware import H100
        peak_flops = PEAK_FLOPS[peak]
        t_b, t_o = nbytes / H100.hbm_bw, flops / peak_flops
        return dict(shape=shape, ms=timer(kernel),
                    plain_ms=None if plain is None else timer(plain),
                    library_ms=None if library is None else timer(library),
                    bound=(max(t_b, t_o) * 1e3,
                           "bytes" if t_b >= t_o else "operations"))

    for name, row in time_train_pair(torch, ops, ref, entry, randn).items():
        emit(phase="timing", kernel=name, **row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
