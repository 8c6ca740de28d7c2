"""The traffic section's parity gate in f32 and in bf16, with the logit
margin at every token where the two engines part, on one GPU.

The bench's traffic section (``repro_torch.bench.sections.traffic_rows``)
gates bit-identical greedy outputs of the contiguous ``Engine`` (whole
prefill) and the ``PagedEngine`` (16-token chunked prefill) on one
Poisson trace. This script runs that gate's own two runs
(``sections.parity_outputs`` on ``sections.parity_trace``) on the traffic
case's model at its published size (``cases.build_serving``), in f32 and
in bf16, and prints per dtype how many requests agree. It then serves the
trace again through subclasses of the two engines that keep every
token's logits (the decode step returning logits, the argmax taken
outside it, which gives the same tokens) and prints, at the first token
where a request's outputs part: each engine's top-2 logit gap (top-1
minus top-2) and the max |logit difference| between the two engines at
that token; and, over every token where the outputs agree, the largest
and the median such difference. A flip at a gap below the two paths'
logit difference is a near-tie that rounding moved; a flip at a gap far
above it is a fault. Prints JSON lines; needs a GPU.

    python3 scripts/paged_parity.py
"""

from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))


def recording(engine_cls, store: dict):
    """``engine_cls`` whose every emitted token's f32 logits row lands in
    ``store[(prompt, index of the token in the output)]``."""
    import torch

    class Recording(engine_cls):
        def __init__(self, *args, **kw):
            kw["greedy"] = False        # the decode step returns its logits
            super().__init__(*args, **kw)
            self._req = None

        def _sample(self, logits):
            self._last = logits.float()
            return torch.argmax(self._last, dim=-1)

        def _admit_whole(self, slot, req):
            self._req = req
            return super()._admit_whole(slot, req)

        def _prefill_chunk(self, slot):
            self._req = self._prefilling[slot]["req"]
            return super()._prefill_chunk(slot)

        def _first_token(self, logits):
            row = logits.float()[0]
            store[(tuple(self._req.prompt), 0)] = row.cpu()
            return int(row.argmax())

        def _decode(self):
            prefilling = getattr(self, "_prefilling", {})
            live = [(i, r) for i, r in enumerate(self.slots)
                    if r is not None and i not in prefilling]
            out = super()._decode()
            for i, r in live:
                store[(tuple(r.prompt), len(r.output))] = self._last[i].cpu()
            return out

    return Recording


def main() -> int:
    import torch

    from repro_torch.bench.cases import TRAFFIC_CASES, build_serving
    from repro_torch.bench.sections import parity_outputs, parity_trace
    from repro_torch.serving import Engine, PagedEngine

    if not torch.cuda.is_available():
        print("paged_parity: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    _, arch, max_batch, max_len = TRAFFIC_CASES[0]
    for dtype in ("float32", "bfloat16"):
        cfg, params = build_serving(arch, "cuda", dtype)
        trace = parity_trace(cfg.vocab_size)
        want, got = parity_outputs(cfg, params, trace, max_batch, max_len)
        stores = ({}, {})
        rec = parity_outputs(cfg, params, trace, max_batch, max_len,
                             engines=(recording(Engine, stores[0]),
                                      recording(PagedEngine, stores[1])))
        flips, agree = [], []
        for p, o in want.items():
            g = got.get(p, [])
            k = next((i for i, (a, b) in enumerate(zip(o, g)) if a != b),
                     None)
            for i in range(len(o) if k is None else k):
                agree.append(float((stores[0][(p, i)]
                                    - stores[1][(p, i)]).abs().max()))
            if k is None:
                continue
            a, b = stores[0][(p, k)], stores[1][(p, k)]
            flips.append(dict(
                prompt_len=len(p), token=k, engine_token=o[k],
                paged_token=g[k],
                engine_top2_gap=float(a.topk(2).values.diff().abs()[0]),
                paged_top2_gap=float(b.topk(2).values.diff().abs()[0]),
                logit_max_abs_diff=float((a - b).abs().max())))
        print(json.dumps(dict(
            arch=arch, dtype=dtype, requests=len(want),
            equal=sum(got.get(p) == o for p, o in want.items()),
            recorded_tokens_equal=rec == [want, got],
            agreeing_tokens=len(agree),
            agreeing_max_abs_diff_max=max(agree, default=0.0),
            agreeing_max_abs_diff_median=statistics.median(agree)
            if agree else 0.0,
            flips=flips)), flush=True)
        del params
        build_serving.cache_clear()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
