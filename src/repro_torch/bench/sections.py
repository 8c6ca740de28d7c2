"""Benchmark sections of the port: the §4.5 kernel-site table.

The port of ``repro.bench.sections._kernel_sites`` and
``section_kernels``: the same six sites, shapes and dtypes, each row a
plain dict. Per site, two traffic counts of the same computation:

    eager_mb    every operator its own kernel: the sum of per-op operand
                and result bytes from the port's capture of the plain nn
                chain (the paper's eager setting)
    kernel_mb   kernel-boundary IO, inputs once and outputs once: what the
                hand-written kernel moves (JAX's ``pallas_mb``)

``eager_over_kernel`` is their ratio (JAX's ``eager_over_pallas``).
JAX's ``xla_mb`` / ``xla_over_pallas`` parse compiled XLA HLO and have no
counterpart here. ``allclose`` holds the kernel wrapper's output against
the plain version at JAX's tolerances (3e-2 for the bf16 sites, 1e-4 for
softmax_xent in f32, 5e-2 for attention): on the card the kernel
launches, on the CPU the wrapper takes its plain version.
"""

from __future__ import annotations

from typing import List

import torch

from repro_torch import nn
from repro_torch.core.graph import capture
from repro_torch.core.microbench import io_bytes
from repro_torch.kernels import ops, ref
from repro_torch.models.attention import _attention_impl


def kernel_sites(device, generator: torch.Generator):
    """(name, plain nn fn, args, kernel fn, plain oracle fn, atol) per
    kernel site, inputs drawn with ``generator`` on ``device``."""
    def randn(shape, dt):
        return torch.randn(shape, generator=generator, device=device).to(dt)

    bf16 = torch.bfloat16
    d = 2048
    x = randn((8, 512, d), bf16)
    res = randn((8, 512, d), bf16)
    w = torch.ones(d, dtype=bf16, device=device)
    b = torch.zeros(d, dtype=bf16, device=device)
    gate = randn((8, 512, 2 * d), bf16)
    up = randn((8, 512, 2 * d), bf16)
    logits = randn((256, 32000), torch.float32)
    labels = torch.randint(0, 32000, (256,), generator=generator,
                           device=device, dtype=torch.int32)
    q = randn((1, 1024, 8, 64), bf16)
    kk = randn((1, 1024, 2, 64), bf16)
    v = randn((1, 1024, 2, 64), bf16)

    return [
        ("rms_norm", lambda a: nn.rms_norm(a, w), (x,),
         lambda: ops.rms_norm(x, w), lambda: ref.rms_norm(x, w), 3e-2),
        ("layer_norm", lambda a: nn.layer_norm(a, w, b), (x,),
         lambda: ops.layer_norm(x, w, b), lambda: ref.layer_norm(x, w, b),
         3e-2),
        ("fused_add_rms_norm",
         lambda a, r: nn.fused_add_rms_norm(a, r, w), (x, res),
         lambda: ops.fused_add_rms_norm(x, res, w)[0],
         lambda: ref.fused_add_rms_norm(x, res, w)[0], 3e-2),
        ("swiglu", nn.swiglu, (gate, up),
         lambda: ops.swiglu(gate, up), lambda: ref.swiglu(gate, up), 3e-2),
        ("softmax_xent",
         lambda lg: nn.softmax_cross_entropy(lg, labels), (logits,),
         lambda: ops.softmax_xent(logits, labels),
         lambda: ref.softmax_xent(logits, labels), 1e-4),
        ("flash_attention",
         lambda a, b_, c: _attention_impl(a, b_, c, causal=True), (q, kk, v),
         lambda: ops.attention_core(q, kk, v),
         lambda: ref.attention(q, kk, v, causal=True), 5e-2),
    ]


def section_kernels(device="cuda") -> List[dict]:
    """One row per kernel site: traffic of the eager chain against the
    kernel's, and the kernel against its plain version. On the card unless
    the caller asks for the CPU."""
    gen = torch.Generator(device).manual_seed(0)
    rows = []
    for name, fn, args, kernel, oracle, atol in kernel_sites(device, gen):
        with nn.backend("torch"):
            records = capture(fn, *args)
            out = fn(*args)
        eager_b = sum(r.bytes_accessed for r in records)
        io_b = io_bytes(args, out)
        got, want = kernel(), oracle()
        rows.append({
            "site": name,
            "eager_mb": eager_b / 1e6,
            "kernel_mb": io_b / 1e6,
            "eager_over_kernel": eager_b / io_b if io_b else 0.0,
            "allclose": bool(torch.allclose(got.float(), want.float(),
                                            atol=atol)),
        })
    return rows
