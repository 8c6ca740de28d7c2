"""Training driver.

The port of ``repro.launch.train``, with its flags and its output; it
trains on the card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \\
        --steps 20 --seq 64 --batch 4 --reduced --device cpu --ckpt /tmp/ck

``--resume auto`` restores the latest committed checkpoint of ``--ckpt``;
the data being a function of the step, the resumed run is the run that
never stopped. The weights are ``init_lm``'s from ``--seed`` on the
training device, not JAX's.
"""

from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig
from repro_torch.models import init_lm
from repro_torch.optim import OptimizerConfig
from repro_torch.runtime import Trainer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", choices=["auto", "never"], default="auto")
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced config (CPU-scale)")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        print("train: no CUDA device; pass --device cpu", file=sys.stderr)
        return 2
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    data_cfg = DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed,
        embed_dim=cfg.d_model if cfg.input_mode == "embeddings" else 0)
    opt_cfg = OptimizerConfig(peak_lr=args.lr, warmup_steps=args.warmup,
                              total_steps=args.steps,
                              compress_grads=args.compress_grads)

    trainer = Trainer(
        cfg, opt_cfg, data_cfg,
        init_params_fn=lambda: init_lm(
            torch.Generator(args.device).manual_seed(args.seed), cfg),
        ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every,
        num_microbatches=args.micro, device=args.device)
    trainer.install_preemption_handler()
    if args.resume == "auto":
        trainer.try_resume()
    out = trainer.train(args.steps)
    print(f"done: step={out['step']} stragglers={out['stragglers']} "
          f"preempted={out['preempted']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
