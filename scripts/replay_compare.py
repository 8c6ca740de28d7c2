"""Device time of one model's graphed decode step, replayed, for one tree
of the port on one GPU.

Serves ``chip_smoke.py``'s phase-3 workload (the model at full size in
bf16, random weights from seed 0; an ``Engine`` of 4 slots and ``max_len``
512; 6 prompts of 5-200 tokens drawn from seed 0, 16 new tokens each)
with the decode step captured as a CUDA graph, unfused and fused, and
times the last step's replay as ``chip_smoke.replay_timing`` does: 20
replays back to back between CUDA events after 3 more, here in ``rounds``
rounds (median and all). ``--src`` names the tree's ``src/`` (an unpacked
``git archive`` of another commit), so that trees are compared in one
call on one card; run them in turns (A, B, B, A).

    python3 scripts/replay_compare.py                          # this tree
    python3 scripts/replay_compare.py --src DIR/src --label parent

Prints one JSON line per variant; needs a GPU.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SEED = 0
NEW_TOKENS, MAX_LEN, SLOTS = 16, 512, 4


def replays_ms(torch, engine, n: int = 20, rounds: int = 5) -> list:
    """ms of one replay of ``engine``'s captured step, per round."""
    graph = engine._run_step._graph
    out = []
    for _ in range(rounds):
        for _ in range(3):
            graph.replay()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(n):
            graph.replay()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1) / n)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(HERE.parent / "src"),
                    help="the src/ directory whose repro_torch is timed")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--arch", default="stablelm-3b")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("replay_compare: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import init_lm
    from repro_torch.serving import Engine

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    _build.build()
    cfg = get_config(args.arch).replace(dtype="bfloat16", param_dtype="bfloat16")
    params = init_lm(torch.Generator("cuda").manual_seed(SEED), cfg)
    rng = np.random.default_rng(SEED)
    plens = [int(n) for n in rng.integers(5, 201, 6)]
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)] for n in plens]
    for fused in (False, True):
        engine = Engine(cfg, params, max_batch=SLOTS, max_len=MAX_LEN,
                        fused=fused, cuda_graph=True)
        for _ in range(2):                    # the first run captures
            for p in prompts:
                engine.add_request(p, max_new_tokens=NEW_TOKENS)
            engine.run()
        torch.cuda.synchronize()
        ms = replays_ms(torch, engine)
        pos = engine._run_step._inputs[1].cpu().tolist()
        print(json.dumps({"label": args.label, "src": args.src, "card": smi,
                          "model": cfg.name, "fused": fused, "positions": pos,
                          "replay_ms": round(statistics.median(ms), 4),
                          "rounds_ms": [round(x, 4) for x in ms]}), flush=True)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
