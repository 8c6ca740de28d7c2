"""Why the port's int8 quantize divides by a device tensor, on one GPU.

PyTorch's CUDA division by a host scalar multiplies by the scalar's
reciprocal, which can differ from a true division in the last bit; JAX's
``quantize_int8`` divides. This prints how many of 2^22 values differ
between ``x / 127.0`` and ``x / <0-d CUDA tensor 127>``, whether the
latter equals the CPU's division, and whether
``repro_torch.nn._quantize_int8_impl`` gives the same codes and scale on
the card as on the CPU (where the CPU tests hold it bit-exact against
JAX). Run from the repository root:

    python scripts/qdq_division_check.py
"""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch import nn  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("qdq_division_check: needs a GPU", file=sys.stderr)
        return 2
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1 << 22, generator=g) * 100
    xc = x.cuda()
    dev = xc / torch.full((), 127.0, device="cuda")
    print("cuda: x / 127.0 differs from x / device(127) in",
          int((xc / 127.0 != dev).sum()), "of", x.numel())
    print("cuda x / device(127) equals cpu x / 127:",
          bool(torch.equal(dev.cpu(), x / 127.0)))
    for dt in (torch.float32, torch.bfloat16):
        a = (torch.randn(64, 4099, generator=g) * 3).to(dt)
        qc, sc = nn._quantize_int8_impl(a)
        qg, sg = nn._quantize_int8_impl(a.cuda())
        print(dt, "card quantize == cpu quantize:",
              bool(torch.equal(qc, qg.cpu())) and float(sc) == float(sg))
    return 0


if __name__ == "__main__":
    sys.exit(main())
