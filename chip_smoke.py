#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py               # from the repository root
    python3 chip_smoke.py --paths-only  # phase 1 and the path comparisons

Phases, each printing JSON lines:

1. device  - requires CUDA; prints the card's name and power limit (as
             ``nvidia-smi --query-gpu=name,power.limit`` gives them),
             builds the hand-written kernels from ``src/repro_torch/kernels/csrc``
             and prints the ``h100`` spec the modeled views price on
             (``core/hardware.H100``) beside the card's total memory and SMs;
2. kernels - holds each of the sixteen kernels against its plain PyTorch
             version on the card, in bf16 and f32, at the main paths' shapes
             (llama2-7b; stablelm-3b's LayerNorm at 2560, SwiGLU at 6912,
             rope on a quarter of 80 (half 10, scalar), attention at head
             dim 80 and at a 64-token chunk of a 512-deep cache;
             gpt2-xl's 25 heads of 64; gemma3-27b's 2048-token
             window prefill over 16 KV heads, its GeGLU rows and its
             qk-norm; the encoders' and the detector's full-mask attention;
             the detector's NMS; the Table-2 dequant row; the §4.5
             cross-entropy site and gemma3's 262144-token vocabulary, with
             few rows split over many CTAs; the bench's quick tier: the
             16-token prefills of llama2-7b and gpt2-xl b1 and b8, bert-base
             b1, stablelm-3b's 16-token chunks over a 64-deep paged view
             and its 3- and 4-slot decode over 64 keys) and
             odd ones (attention head dims 34, 48, 80, 96, Sq = 1, a causal
             q_offset with Sq < Skv, a chunk whose keys and values past it
             are NaN; decode over 4096 keys in 64 splits and
             lengths on and one past a split boundary; row norms at
             gemma3-27b's s2048 qk-norm and block norms, the Table-2
             Segformer rows, bert-base at b8 and a partial last row group,
             each naming the body of ``csrc/norms.cu`` it ran, every body
             reached; rope at gemma3-27b's prefill, rows walked by a grid
             stride with a ragged last step, a decode column near 4095,
             rows in chunks and half 6144, each naming its plan; swiglu
             and geglu at the decode steps, a prefill, tails, views 4 and 1
             elements into their storage and extremes of the gate, each
             naming its plan; NMS at the
             mask's word boundaries, 4663 and 8192 boxes, every third box
             invalid, IoU pairs at exactly 0.5 and one ulp above, pairs
             whose IoU an FMA would move across 0.5; softmax_xent on
             split plans with misaligned spans, int32 and int64 labels,
             labels in the first and last spans and outside [0, V), each
             naming its plan); NMS keep
             masks and the dequant kernel's ``r`` must be identical;
             MLA's shapes: attention_core at Dk 192 / Dv 128 (s16, s256,
             the last 64-token chunk of a 512-deep cache at q_offset 448)
             and decode_core's wide bodies at Dk 576 / Dv 512, one KV
             head for 16 query heads (the tensor cores' in bf16, the FMA
             units' in f32, each case naming its body and split plan; kv
             512 with ragged lengths, 0, 1, 31-33, 511 and 512 among them,
             NaN keys past the lengths, and 4096 keys in many splits); phase
             moe's shapes of the other kernels (MOE_KERNEL_BATCHES): the
             2048-wide norms and the 512-d kv_norm, rope on qwen2's heads
             and on MLA's q_rope copy and kr, swiglu on the expert buffers
             at each batch's capacity, the shared experts and the dense
             first layer; recurrentgemma-2b's shapes (rg_kernel_cases):
             the window fragment at Dk = Dv = 256, 10 query heads over one
             KV head, window 2048, at 2048 and 2100 tokens and a short
             prompt; decode at (256, 256), G 10, over rings of 2048 at
             lengths 0, 1, 31-33, full and the serve run's, and with
             peaked queries; rope on its 10 and 1 heads of 256; GeGLU at
             7680; the row norms at 2560; xlstm-350m's shapes
             (xl_kernel_cases): layer_norm at 1024 and rms_norm at 2048 and
             1024 at its decode step and a 512-token prefill, geglu on the
             contiguous halves of its ff_up (1365 a row: vectors straddle
             rows; at 97 and 2 tokens the last vector is partial), and the
             kernel refusing the strided halves; the softcap fragment
             (scripts/softcap_check.py's cases): caps 50, 20 and 5 on the
             causal, window and full masks and decode, head dims 64, 80
             and 128, a chunk's q_offset, rows that see no key held to
             exact zeros, decode in many splits over 4096 keys;
             musicgen-large's shapes (mg_kernel_cases): the LayerNorms at
             2048, causal attention at 32 heads of 64 over its prefill,
             decode at group 1 over a 2048-deep cache; the training pair
             (train_kernel_cases): the lse forward (out and lse) and
             attention_bwd (dq, dk, dv, two launches bit-identical) on
             the causal, window and full masks, GQA groups 1, 4 and 8,
             head dims 64, 80 and 128, lengths 97 and 1000, a q_offset,
             granite-3-8b's training shape and rows that see no key
             (zeros, NEG_INF, zero gradients);
   train   - granite-3-8b at full width, its first 2 layers, f32 masters
             with a bf16 working copy, b2 x s2048, loss_chunk 512, remat
             ``proj`` (``scripts/train_check.py``): (a) one loss and
             gradient on the kernel path, the plain path in bf16 and in
             f32 (the anchor): the loss and every gradient leaf under the
             anchored rule, the worst leaf printed; (b) the ``Trainer``
             for 6 steps, a fresh one resumed from its step-3 checkpoint
             against the uninterrupted run (equal, max |delta|); (c) the
             step ms and tokens/s after the first step, the peak memory,
             the launches a step against their analytic count, and one
             ``Workload(phase="train")`` measured split at s512 with its
             backward share;
   moe     - qwen2-moe-a2.7b and deepseek-v2-lite-16b (MLA, a dense first
             layer) at full width and depth in bf16 (random weights from
             a seeded generator on the card), one after the other, each
             freed before the next: one MoE layer of the served weights on
             256 tokens against a reference computed apart from
             ``models/moe.py``, at the config's capacity and at 0.5 (choices
             dropped); unfused and fused, the ``Engine`` serves 6 requests
             of 16 new tokens, eager then graphed, tokens identical, with
             one repeat (MOE_REPEATS), launch and
             counter checks and its graph
             vs eager line (the step's byte bound reads every expert's
             weights); the ``PagedEngine`` graphed, cold with the
             ``Engine``'s tokens exactly and in 64-token chunks with prefix
             hits, every request finished and every block back; the
             (token, layer) pairs whose top-k experts differ between the
             kernel and plain paths; the kernel path's logits against the
             plain path's (and fused against unfused) under the anchored
             rule; the measured split of one eager b1 s16 forward with the
             shares of the MoE sites, beside its ``eager-modeled:h100`` view;
   recurrent - recurrentgemma-2b in bf16 (the full model's 2.895 B
             parameters made and counted; (rec, rec, local) x 8 and a (rec,
             rec) trail), served at full width and its first 9 layers
             (RG_LAYERS): the Engine (4 slots, max_len 4096) prefills each
             prompt at its
             exact length (``_bucket``; the RG-LRU state would consume
             pads), one prompt past the 2048-token window, one that wraps
             its rings in decode; the PagedEngine refuses the model;
             unfused and fused, eager then graphed, tokens identical, with
             ``serve``'s repeats, launch and counter checks and its graph
             vs eager line (the step's byte bound reads the recurrent
             state too); the kernel path's logits against the plain path's
             under the anchored rule; the measured split of one eager b1
             forward at s16 (9 layers) and s2048 (one pattern repeat, 3
             layers) with the shares of the recurrent mixer's sites
             (``rglru_scan``, ``rglru_gates``, ``causal_conv1d``), the GEMMs
             and attention;
   xlstm   - xlstm-350m in bf16 (the full model's 528,361,640 parameters
             made and counted; (mlstm x 7, slstm) x 3), served at full width
             and one pattern repeat, 8 layers (XL_LAYERS): the Engine (4 slots,
             max_len 512) prefills each prompt at its exact length (a
             prompt that pads the mLSTM's last 256-token chunk, one that
             fills it, one shorter than the conv tail); the PagedEngine
             refuses the model; unfused and fused, eager then graphed,
             tokens identical, with ``serve``'s checks and its graph vs
             eager line (the step's byte bound reads and writes the mLSTM's
             matrix memory and the sLSTM's state); the anchored logit rule;
             the measured split of one eager b1 forward at s16 and s512
             (8 layers) with the shares of the xLSTM sites;
   musicgen - musicgen-large at full size in bf16 (48 layers, 2.42 B
             parameters, the config's count; served and split at its
             first 12, ``MG_LAYERS``) on frame embeddings from
             seeded generators (its EnCodec frontend is a stub):
             ``make_prefill_step`` on 4 rows of 1500, 750, 250 and 37
             frames, right-padded with ``lengths``, then 16 steps of
             ``make_serve_step`` over the 4 slots, each fed a fresh frame a
             slot, eager and as a ``StepGraph`` (float frames through its
             pinned buffers), unfused and fused: codebook tokens identical,
             launches exactly what the prefill and the steps need, the
             replay beside the step's byte bound; the kernel path's last
             prefill logits and one decode step's logits against the plain
             path's under the anchored rule; the measured split of one
             eager b1 forward at s16 and s1500 with the shares of
             ``pos_sinusoidal``, the LayerNorms and GELU;
3. serve   - for each of llama2-7b, stablelm-3b, gpt2-xl and gemma3-27b at
             full width in bf16, at their first layers (SERVE_LAYERS: 4,
             4, 12 and 6; random weights from a seeded
             generator on the card), the continuous-batching ``Engine``
             unfused and fused
             (``Engine(fused=True)``: ``nn.fuse()``) serves 6 requests of 16
             new tokens (gemma3-27b's prompts cross its 1024-token window in
             prefill and wrap its rings in decode), first with the eager
             decode step (``cuda_graph=False``), then with the step as a
             CUDA graph, tokens identical to the eager run's; each engine
             serves the prompts 3 more times: decode tok/s graph against
             eager (median, spread), and the graph's replay in device ms
             beside the step's byte bound; checks the outputs, that each run
             launched exactly its kernels, as many times as its forwards
             need (replays included), that the kernels' counters read zero
             after every run and that deleting the engine gave back its
             memory; then holds the kernel path's prefill logits
             and one decode step's logits against the plain path's, and the
             fused path's against the unfused path's, and for llama2-7b and
             stablelm-3b a 300-token prompt's chunked prefill (``lm_prefill``
             of 128 tokens, then ``lm_extend`` chunks of 64 at their
             offsets) against its whole prefill and against the plain
             path's chunked prefill (``--paths-only`` runs only these
             comparisons, to read what they see of a kernel broken on
             purpose);
   softcap - after gemma3-27b's serve phase, its first 6 layers (one
             repeat of its pattern) with Gemma 2's published logit caps
             (attention 50, final 30; ``cfg.replace``, no new config): the
             Engine serves phase 3's prompts unfused and fused, eager then
             graphed, tokens identical, with ``serve``'s checks; the same
             engine without the caps graphed once beside it (the replay's
             cost of the cap); the kernel path's logits against the plain
             path's under the anchored rule;
   paged   - llama2-7b and stablelm-3b through the ``PagedEngine``
             (``max_batch=4``, ``max_len=512``, 16-token blocks), unfused
             and fused: (a) cold, the serve phase's prompts, tokens
             identical to the ``Engine``'s from the same run; (b) chunks of
             64 and the prefix cache, four prompts sharing a 160-token
             prefix and two of 300-400 tokens: every request finished, a
             prefix-cache hit, the count of requests whose tokens equal the
             ``Engine``'s printed. Both: eager, then graphed with the eager
             run's tokens; launches equal to what the cold prefills, extend
             chunks and decode steps need, counters zero, every block back
             to the allocator or the prefix cache, memory back; (a) is
             repeated and timed as ``serve`` is, beside the ``Engine``;
   traffic - stablelm-3b at full width, its first 8 layers, through
             ``repro_torch.traffic`` (every drive
             primed on its trace's shadow first): (a) a Poisson trace through
             the ``Engine`` and the cold ``PagedEngine``, tokens identical;
             (b) 16 requests at 8/s in real time through the ``PagedEngine``
             (64-token chunks, prefix cache), graph and eager, each
             ``LoadReport`` printed, every request completed; (c) a
             192-token shared prefix with the cache on and off: a hit, every
             block back, warm and cold service TTFT; (d) the measured GEMM /
             NonGEMM split of one eager paged decode step and ``paged_frac``;
   tp      - stablelm-3b at full width through the tensor-parallel
             ``PagedEngine`` (``mesh=``), fused, in TP_RANKS ranks spawned
             once (``repro_torch.launch``) that time-share the card over
             gloo through host memory, at tp 2 and 4 beside the one-device
             ``PagedEngine`` (tp 1, rank 0): (a) in f32 at its first
             TP_F32_LAYERS layers, 6 requests of 4-20 tokens and 12 new
             tokens, and a chunked wave whose prompts share 16-token
             prefixes with the first's (a prefix hit on both engines):
             tokens identical; in bf16 at full depth, 4 rows served
             through the engine (each row's cold prefill into its pools,
             then one paged decode step with the logits out), prefill and
             decode logits under the anchored rule; (b) measured, per degree:
             decode tok/s of the eager engines and rank 0's decode step
             split with its COLLECTIVE share; (c) modeled on the ``h100``
             spec: the full-width decode step at tp 1, 2 and 4 from rank
             0's capture (2 psum records a layer and one all_gather), with
             its collective share and efficiency; (d) every rank's kernel
             launches in each dtype, equal to the one-device engine's;
4. profile - a per-op measured profile of ``lm_forward`` (batch 1, seq 16)
             on the kernel path, unfused and fused, for the three models
             at their serve depth,
             and gemma3-27b (its first 6 layers) at seq 16 and 2048,
             where its window bites, unfused and fused (its GeGLU kernel at
             the 2048 bucket): the measured
             GEMM / NonGEMM split;
   qdq     - for llama2-7b and gpt2-xl at their first 4 layers, the
             paper's §4.4 2x2 on one eager
             ``lm_forward`` (b1 s16, bf16): ``bf16`` / ``fused`` /
             ``int8-qdq`` / ``int8-qdq+fused`` (``nn.fake_quant("int8")``:
             both operands of every GEMM site round-trip through int8),
             through the profiling API (``core/workload.py``: a
             ``Workload`` a variant with ``QuantizeDequantTransform`` /
             ``FusionTransform``): the ``wallclock`` backend, whose calls
             give exact launches per forward, and the ``measured`` split
             with its QDQ share; beside each, the ``eager-modeled:h100``
             and ``eager-modeled:a100`` views of one capture, the measured
             profile's drift against ``h100`` and the capture's fusion
             report; the QDQ kernel path against the QDQ plain path and QDQ
             fused against QDQ unfused, under the anchored logit rule;
   encode  - bert-base (b1 and b8, s128) and the vit-b16 embeddings stub
             (b1, s197) through ``lm_forward`` at full width and depth in
             bf16, unfused and fused: launches, the kernel path's logits
             against the plain path's and the fused path's against the
             unfused, and a measured profile of each (batch 1);
   vision  - vit-b16-cls (224 px) and detector-vit-s (256 px) through
             ``vision_forward`` at full width and their first 4 of 12
             layers (``VISION_LAYERS``), bf16: images/s at batch 1 and
             batch 8, the classifier's logits and the detector's backbone
             features and sorted top-K scores against the plain path, the
             NMS kernel against the plain NMS on the kernel path's own
             boxes, and a measured profile of each (batch 1) in which the
             detector must show RoI, Interpolation and Reduction time;
             then vit-b16-cls at b1 through phase ``qdq``'s 2x2
             (``conv2d``'s QDQ), checked and profiled the same way;
   nglint  - the port's nglint (``repro_torch.analysis``, NG001–NG010):
             (a) over the reduced zoo, every id and variant of ``python -m
             repro_torch.analyze --all``, captured on the card and gated
             against the committed baseline (a new finding fails); (b) the
             graph rules over phase ``qdq``'s eight full-width bf16
             captures of llama2-7b and gpt2-xl, raw and rewritten (an
             ``error`` finding fails; warnings printed by rule and site);
             (c) one reduced cell's card capture against the CPU's under
             ``nn.backend("cuda")``, record field by field, printed;
  micro   - the Table-2 NonGEMM micro-benchmark (``core/microbench``,
             f32): one line per operator, the fused dequant row through its
             kernel; then ``h100`` calibrated from these rows
             (``core/calibrate.py``) and the ``calibrated:h100`` view of
             every variant phase ``qdq`` kept, beside its drift;
   kernel_sites - the §4.5 kernel-site table (``bench/sections``): per
             site the eager chain's bytes against the kernel's, and the
             kernel against its plain version (the cross-entropy site
             through softmax_xent);
   bench   - ``python -m repro_torch.bench run --quick --out
             results/bench_h100.json`` in a process of its own (the paper's
             tables at bench widths: the four quick LM cases at full width,
             two layers, f32, measured on the card beside the modeled eager
             A100 and beside their ``torch.compile``'d forwards, measured
             kernel by kernel (the compiled view: each case's row printed
             beside its measured one with its busy share, the kernels no
             origin gave a group, and the hand-written kernels it launched
             from inside the compiled program); the QDQ and fusion 2x2,
             vision, the platform sweep with
             ``calibrated:h100``, Table 2 and its harvested rows, the
             kernel sites, stablelm-3b at its published size served in bf16
             and under traffic in f32, the tensor-parallel sweep over 8
             spawned ranks at the reduced sharded config): rc 0, the
             artifact validates, every section ``ok`` but ``roofline``
             (skipped, with its reason), the harvested rows llama2-7b's
             capture gives, every kernel site allclose, the traffic parity
             true, the ``serving_sharded`` rows printed;
             the kernels it launched (its last line) join the record, each
             of the twelve the quick tier reaches at least once;
5. timing  - kernel, plain version, one PyTorch library call computing the
             same function (where there is one) and the card's bound, at the
             main paths' shapes, gemma3-27b's global causal prefill and ring
             decode included, and recurrentgemma-2b's window prefill (s2048)
             and ring decode (four full rings of 2048) beside SDPA with the
             one KV head expanded to 10 (in the kernels line under
             ``recurrentgemma``, with phase recurrent's launches); the
             attention rows name the body that ran
             (``mma bf16`` on the tensor cores, ``fma f32``); the row norms
             at their wider shapes and an empty kernel, the launch floor
             (``scripts/norm_timing.py``); rope at gemma3-27b's prefill q
             and k, NMS at the Table-2 row and at 8192 boxes
             (``scripts/rope_nms_timing.py``); swiglu and geglu at the
             decode steps and the served prefills beside ``torch.mul`` of
             the same operands (``scripts/glu_timing.py``); softmax_xent
             at gemma3-27b's vocabulary with 8 rows, its loss chunk and
             llama2-7b's 2048-token loss beside ``F.cross_entropy`` and
             ``torch.amax`` (``scripts/xent_timing.py``); rope at
             stablelm-3b's decode step (the scalar plan) and attention_core
             at the last 64-token chunk of a 512-deep cache beside SDPA with
             the causal-offset mask spelled out; MLA's prefill (s256) and its
             absorbed decode (kv 512, the serve run's lengths) beside SDPA,
             also in the kernels line under each kernel's ``mla``;
             xlstm-350m's layer_norm, rms_norm and geglu at its decode step
             (in the kernels line under ``xlstm``, with phase xlstm's
             launches) and at a 512-token prefill, beside ``F.layer_norm``,
             ``F.rms_norm`` and ``torch.mul`` of the same operands; the
             capped attention_window, attention_core and decode_core at
             gemma3-27b's shapes beside compiled ``flex_attention`` with
             the cap as its score modification, the same kernels uncapped
             and SDPA uncapped (under each kernel's ``softcap``) and
             musicgen-large's prefill attention and decode beside SDPA
             (under ``musicgen``); the training pair at granite-3-8b's
             shape: the lse forward beside the entry without the lse and
             flash SDPA's forward, attention_bwd beside SDPA's flash
             backward, each beside its plain twin
             (``scripts/train_check.py``).

The line before the last is the per-kernel JSON record, the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
before that line is printed.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

SEED = 0
ARCHS = ("llama2-7b", "stablelm-3b", "gpt2-xl", "gemma3-27b")
#: the served models' engine depth and prompt lengths (None: six seeded
#: lengths of 5-200 tokens). gemma3-27b's: two past its 1024-token window
#: (right-padded to the 2048 bucket, the rings fill from the true tail),
#: one of 1015 whose decode wraps its rings at 1024, one short;
#: compare_paths takes the first four
SERVE = {"llama2-7b": (512, None), "stablelm-3b": (512, None),
         "gpt2-xl": (512, None),
         "gemma3-27b": (2048, (1500, 1100, 1015, 37, 600, 250))}
#: the models phase ``paged`` serves through the PagedEngine (every layer
#: global: gemma3-27b's rings cannot page)
PAGED_ARCHS = ("llama2-7b", "stablelm-3b")
#: the paged engine's blocks and chunks; the chunked run's prompts: four
#: that share a 160-token prefix, each with its own 40-token suffix, and
#: two long ones (five to seven chunks), in the order (shared, long, long,
#: shared, shared, shared), so that the last two find the first one's
#: prefix cached
BLOCK_SIZE, CHUNK = 16, 64
SHARED_PREFIX, SUFFIX, LONG_PROMPTS = 160, 40, (300, 400)
#: compare_paths' chunked prefill: a prompt of EXTEND_PROMPT tokens as
#: lm_prefill of the first EXTEND_FIRST, then lm_extend in chunks of CHUNK
EXTEND_PROMPT, EXTEND_FIRST = 300, 128
#: the depth phases 3 and 4 serve a dense model at where it is cut, full
#: width, its first layers: gemma3-27b two repeats of its five-local,
#: one-global pattern (at its 62 layers, serving it took 76 s of the
#: script's time, PERF.md §6; with phase moe added, the script would
#: pass the time it is held to); llama2-7b and stablelm-3b half their 32
#: (at full depth they took 73 and 67 s of a 573 s run; with phase
#: recurrent added, the script would pass its time; phase bench serves
#: stablelm-3b whole), and with phase xlstm added an eighth of their 32
#: (at 16 they took 37 and 42 s of a 506 s run, at 8 20 and 19 s of a
#: 643 s one) and gpt2-xl a quarter of its 48 (22 s at 48, 12 at 24), and
#: with phases softcap and musicgen added gemma3-27b one repeat (17.3 s at
#: 12 layers of a 581 s run; PERF.md §4), and with the bench's compiled
#: view added (four Inductor compiles, 52.4 s) llama2-7b and stablelm-3b
#: at 2 and gpt2-xl at 6 (at 2, 2 and 6 they took 10.35, 10.25 and 5.89 s
#: of a 522 s run on an H100 80GB HBM3 at 700 W). The
#: MoE models stay whole: at half depth qwen2-moe-a2.7b's kernel path read
#: 0.308 from its plain path against a limit of 0.272 (its routing flips
#: between the paths, and the limit shrinks with the depth)
SERVE_LAYERS = {"gemma3-27b": 6, "llama2-7b": 2, "stablelm-3b": 2,
                "gpt2-xl": 6}
#: (batch, seq) of the measured profiles of each served model
PROFILES = {"gemma3-27b": ((16, False), (16, True), (2048, False), (2048, True))}
#: the depth gemma3-27b's profiles run at: the first layers of the served
#: params, one repeat of its five-local, one-global pattern (at 62 layers
#: its four profiles took 44 s of the script's time; PERF.md §6, PR 24)
PROFILE_LAYERS = {"gemma3-27b": 6}
NEW_TOKENS = 16
#: each served run repeated on the same engine, its decode graph captured:
#: decode tok/s as the median and spread of the repeats (two single runs
#: of one tree read 40.4 and 59.4 tok/s on a shared host)
REPEATS = 3
#: what an engine may leave allocated once deleted: state of the shared
#: capture stream made once in the process (its cuBLAS workspace, the
#: kernels' counters)
MEM_SLACK = 64 << 20
#: bytes a cached key or value element takes (bf16 caches)
KV_BYTES = 2
#: phase traffic: the JAX traffic case's model (repro/bench/cases.py:44-46)
#: at full width and TRAFFIC_LAYERS deep (at its 32 layers the phase took
#: 73 s of the script's time, at 4 13.79 s of a 522 s run on an H100 80GB
#: HBM3 at 700 W; phase bench serves the model whole under
#: JAX's traffic section), through the PagedEngine with these blocks and
#: chunks
TRAFFIC_ARCH = "stablelm-3b"
TRAFFIC_LAYERS = 2
TRAFFIC_ENGINE = dict(max_batch=4, max_len=512, block_size=16)
TRAFFIC_CHUNK = 64
#: the op sites of the paged bookkeeping in a decode step's profile
#: (``paged_frac``, as JAX's traffic section attributes it)
PAGED_SITES = ("paged_kv_gather", "paged_kv_write", "paged_kv_scatter",
               "kv_cache_update")
PEAK_FLOPS = {"bfloat16": 989e12,    # dense tensor-core rate
              "float32": 67e12}      # outside the tensor cores
# |kernel - plain| <= atol + rtol * |plain|: both compute in f32; bf16 output
# may round the other way by one ulp (2^-8 relative), f32 only differs in
# summation order and in the exp / rsqrt intrinsics. The window fragment's
# cases, the capped causal and decode cases and musicgen-large's attention
# scale atol by the plain output's RMS (where below 1): a row over
# 1024 keys of randn q, k, v averages ~377 effective values, RMS ~0.05, so
# a flat 3e-2 could let through a key too many or too few; rtol still
# covers the ulp of each rounded output
TOL = {"bfloat16": (3e-2, 2 ** -7), "float32": (2e-5, 1e-5)}
# a LayerNorm row whose mean is 1e3 standard deviations from zero: either
# version's f32 mean carries ~2^-24 * 1e3 * log2(d) of summation-order
# error, which the normalized row shows unscaled (9.4e-5 read on an H100);
# a one-pass E[x^2] - E[x]^2 variance errs by ~0.1 there
LARGE_MEAN_TOL = {"bfloat16": TOL["bfloat16"], "float32": (1e-3, 1e-5)}
# logits, kernel path vs plain path (and fused vs unfused), all layers in
# bf16: each layer may round its outputs differently by an ulp and the
# differences compound, by how much depends on the model. The limit is
# anchored in what bf16 costs the model: the same plain path with f32
# activations (on the same bf16 weights) is computed too, and a pair may
# differ by at most F32_ANCHOR times the reference path's distance from it
# (the plain path, or the unfused kernel path for the fused comparison),
# LOGIT_ATOL at the least. On an H100 the sound paths of llama2-7b and
# gpt2-xl read at most 0.0625 and 0.0586, logits up to 4.2; for llama2-7b,
# decode_core dropping its newest key reads 0.25 on the decode step,
# attention_core masking the diagonal 2.1-2.8 on prefill. gemma3-27b's
# logits (to ~11) pass through 62 layers whose post-norms rescale each
# sub-block's output, rounding included, to unit RMS: its sound kernel
# path reads 0.19-0.28 against the plain path, both 0.17-0.23 from the f32
# run (readings per model: PERF.md)
LOGIT_ATOL = 0.125
F32_ANCHOR = 2.0
# finite extremes of the gate in phase 2's swiglu and geglu cases: e^-g and
# e^-2z overflow, g^3 overflows, the denominator of csrc/swiglu.cu's
# quotient passes 2^126 (-87.5 for SiLU, -9.7 for GeLU)
GLU_EXTREMES = [1e-30, -1e-30, 20.0, -20.0, -88.8, 100.0, -100.0, 1e4, -1e4,
                1e13, -1e13, -87.5, -9.7]
# the encoders' logits and the vision outputs, kernel path against plain
# path and fused against unfused, all 12 layers in bf16 (readings: PERF.md)
ENCODE_ATOL = 0.125
# the detector's top-K scores (sigmoid probabilities in [0, 1]) as value
# sets: every score of one path within this of a score of the other
SCORE_ATOL = 0.03

SOURCES = {
    "rms_norm": ("src/repro_torch/kernels/csrc/norms.cu",
                 "src/repro/kernels/norms.py:47"),
    "fused_add_rms_norm": ("src/repro_torch/kernels/csrc/norms.cu",
                           "src/repro/kernels/norms.py:79"),
    "layer_norm": ("src/repro_torch/kernels/csrc/norms.cu",
                   "src/repro/kernels/norms.py:226"),
    "fused_add_layer_norm": ("src/repro_torch/kernels/csrc/norms.cu",
                             "src/repro/kernels/norms.py:181"),
    "rope": ("src/repro_torch/kernels/csrc/rope.cu",
             "src/repro/kernels/rope.py:27"),
    "swiglu": ("src/repro_torch/kernels/csrc/swiglu.cu",
               "src/repro/kernels/swiglu.py:21"),
    "geglu": ("src/repro_torch/kernels/csrc/swiglu.cu",
              "src/repro/kernels/swiglu.py:27"),
    "attention_core": ("src/repro_torch/kernels/csrc/attention.cu",
                       "src/repro/kernels/attn_template.py:170"),
    "attention_window": ("src/repro_torch/kernels/csrc/attention.cu",
                         "src/repro/kernels/attn_template.py:170"),
    "decode_core": ("src/repro_torch/kernels/csrc/decode.cu",
                    "src/repro/kernels/attn_template.py:185"),
    "attention_full": ("src/repro_torch/kernels/csrc/attention.cu",
                       "src/repro/kernels/attn_template.py:170"),
    "nms": ("src/repro_torch/kernels/csrc/nms.cu",
            "src/repro/kernels/nms.py:25"),
    "dequant_add_rms_norm": ("src/repro_torch/kernels/csrc/norms.cu",
                             "src/repro/kernels/norms.py:125"),
    "softmax_xent": ("src/repro_torch/kernels/csrc/softmax_xent.cu",
                     "src/repro/kernels/softmax_xent.py:26"),
    # the training pair: the forward's lse fragment and the flash backward,
    # counterparts of JAX's flash VJP (no Pallas kernel: the jnp twin)
    "attention_lse": ("src/repro_torch/kernels/csrc/attention_lse.cu",
                      "src/repro/models/attention.py:172"),
    "attention_bwd": ("src/repro_torch/kernels/csrc/attention_bwd.cu",
                      "src/repro/models/attention.py:243"),
}
#: the served models the qdq phase measures (gemma3-27b is left out: weight
#: QDQ makes f32 temporaries of its 262144 x 5376 tied embedding, 5.6 GB
#: each, beside 54 GB of weights)
QDQ_ARCHS = ("llama2-7b", "gpt2-xl")
#: the depth phase qdq runs them at: the first layers of the served
#: params, so that the script keeps its time with phase bench (the 2x2's
#: per-op profiles grow with depth; the bench's cases are cut alike): at
#: most the served depth of each
QDQ_LAYERS = 2
#: JAX's variant labels (core/workload.py ``Workload.variant``) of the 2x2:
#: (label, fake-quant mode, fused)
QDQ_VARIANTS = (("bf16", None, False), ("fused", None, True),
                ("int8-qdq", "int8", False), ("int8-qdq+fused", "int8", True))
#: phase nglint: the reduced configs ``repro_torch.analysis`` sweeps on the
#: card (None: every id, ``python -m repro_torch.analyze --all``), and the
#: cell whose card capture is held against the CPU's under
#: ``nn.backend("cuda")`` (what lets the CPU tests hold the committed
#: baseline), field by field
NGLINT_IDS = None
NGLINT_CPU_CELL = ("llama2-7b", "fused")
NGLINT_FIELDS = ("prim", "group", "op_site", "in_shapes", "out_shapes",
                 "in_dtypes", "out_dtypes", "bytes_accessed")
#: the qdq phase's eager wall: the median of this many forwards after one
#: warm-up (which warms cuBLAS), through the ``wallclock`` backend
WALL_REPEATS = 5
# softmax_xent's output is f32 whatever the logits' dtype, from the same
# logits on both sides: JAX's sweep tolerance (tests/test_kernels.py)
XENT_TOL = {"bfloat16": (1e-5, 1e-5), "float32": (1e-5, 1e-5)}
# the dequant kernel in bf16: y may differ from the plain version's by an
# ulp only where the f32 row statistic's summation order tips a rounding
# (~1e-7 relative against a bf16 ulp of 2^-8: a few elements in 1e5); a
# kernel that normalised the unrounded r (off by up to half an ulp of r)
# tips a large share
Y_BITS_DIFFER_MAX = 0.01
ENCODERS = (("bert-base", ((1, 128), (8, 128))), ("vit-b16", ((1, 197),)))
VISION = ("vit-b16-cls", "detector-vit-s")
VISION_BATCH, VISION_FORWARDS = 8, 8
#: the depth phase vision and its QDQ 2x2 run both models at: the first 4
#: of their 12 layers, full width and resolution (at 12 the phase took
#: 20.26–22.40 s of 478–522 s runs on an H100 80GB HBM3 at 700 W, which the
#: bench's compiled view needed; at 6 11.05–12.73 s of 514–619 s runs on
#: the same card, which phase tp and the bench's serving_sharded needed)
VISION_LAYERS = 4
#: phase bench: the quick tier of ``python -m repro_torch.bench`` in a
#: process of its own, its artifact here (under the checkout's results/)
BENCH_OUT = "results/bench_h100.json"
BENCH_TIMEOUT_S = 900
#: the sections the quick tier skips, each with a word of its reason
BENCH_SKIPS = {"roofline": "no dry-run artifacts"}
#: the micro_harvested rows of the quick tier: of the sites the section
#: runs, llama2-7b's b1 s16 capture holds only its RMSNorm (the SiLU sits
#: in the swiglu site, the residual adds in residual_add, the softmax in
#: the flash-attention site), as JAX's capture of the model does
BENCH_HARVESTED = [("rms_norm", [1, 16, 4096], "cuda")]
#: what the quick tier launches: every kernel but the window fragment and
#: GeGLU, which only gemma3-27b's full-tier case runs
#: phase tp: stablelm-3b (JAX's sharded case, repro/bench/cases.py) at full
#: width through the tensor-parallel PagedEngine, fused, in TP_RANKS spawned
#: ranks time-sharing the card over gloo; the f32 parity runs at its first
#: TP_F32_LAYERS layers (each layer adds two all-reduces a step, 6–14 ms
#: each at 2–4 ranks on an H100 80GB HBM3 at 700 W: at 8 layers the phase
#: took 130 s of a 60 s budget); the bf16 rows served for their logits,
#: the captured and the timed decode step (each op timed once) at full
#: depth
TP_ARCH = "stablelm-3b"
TP_DEGREES = (1, 2, 4)
TP_RANKS = 4
TP_F32_LAYERS = 4
TP_ENGINE = (("max_batch", 4), ("max_len", 64), ("block_size", 8),
             ("fused", True))
TP_CHUNK = 8
TP_TIMEOUT_S = 240.0
TP_LABEL = "ranks time-sharing one H100 over gloo through host memory"
#: the kernels the tensor-parallel path runs (fused)
TP_KERNELS = ("attention_core", "decode_core", "layer_norm",
              "fused_add_layer_norm", "rope", "swiglu")
#: the rank-local widths of stablelm-3b at tp 2, 4 and 8: its heads of 80
#: and its FFN, which phase 2 holds the kernels at
TP_SHARDS = (2, 4, 8)
#: phase moe: the mixture-of-experts models at full size in bf16, one after
#: the other (28.6 and 31.4 GB of weights), served at full depth
MOE_ARCHS = ("qwen2-moe-a2.7b", "deepseek-v2-lite-16b")
#: phase moe's layer check: one MoE layer of the served weights on this
#: many tokens, at the config's capacity factor and at one that drops
#: choices for certain, against a reference computed apart from
#: models/moe.py (its own top-k, capacity walk and per-expert products, in
#: f32); a token row may differ from it by this fraction of its norm (bf16
#: roundings of the products, the activation and the combine: a few 2^-9;
#: a dropped choice read back, or a kept one lost, moves a row by its
#: gate, 1/6 to 1/2 of it)
MOE_LAYER_TOKENS = 256
MOE_LAYER_CFS = (None, 0.5)
MOE_ROW_RTOL = 0.03
#: (B, S) of the token batches phase moe's models give their kernels: a
#: prefill at the 256 bucket (its longest prompts), the Engine's 4-slot
#: decode step and the PagedEngine's 64-token chunk; phase 2 checks the
#: row norms, rope and swiglu at each, the expert buffers at the capacity
#: each sets
MOE_KERNEL_BATCHES = ((1, 256), (4, 1), (1, CHUNK))
#: the op sites whose share phase moe's measured split prints
MOE_SITES = ("moe_dispatch", "moe_combine", "router_gate", "router_aux",
             "expert_ffn")
#: the repeats of phase moe's serves, eager and graphed: the eager MoE
#: step is host-bound, ~4.5 s a run of the prompts, so three more runs of
#: both models, unfused and fused, cost ~50 s of the script's time, which
#: musicgen and softcap needed; the graphed serve's tok/s read within
#: 1.0 % over three repeats on an H100, and its two more went to phase
#: train
MOE_REPEATS = 1
#: the depth of phase moe's measured split: the first layers of the served
#: params (deepseek-v2-lite-16b's dense first layer among them); the split
#: times each of its ops four times behind a 0.5 ms pad, ~25 s for the two
#: whole models (4567 and 5895 ops) on an H100 80GB HBM3 at 700 W, which
#: the bench's compiled view needed; the serves and the logit rule keep the
#: whole models
MOE_PROFILE_LAYERS = 3
#: phase recurrent: recurrentgemma-2b at full size in bf16 (2.895 B
#: parameters, 5.79 GB), its Engine at RG_MAX_LEN; prompt lengths that are
#: no powers of two (the engine prefills a recurrent model at the exact
#: length): the first past the 2048-token window (its rings wrap in
#: prefill), the second 8 short of it (its rings wrap in decode)
RG_ARCH = "recurrentgemma-2b"
RG_MAX_LEN = 4096
RG_PROMPTS = (2100, 2040, 333, 37, 700, 90)
#: the depth phase recurrent serves it at: its first (rec, rec, local)
#: repeat of eight, full width, its local layer to run the window and the
#: rings (at 26 layers phase recurrent took 29.6–47.1 s of 459–594 s runs,
#: PERF.md §4; at 6, 11.73 s of a 522 s run on an H100 80GB HBM3 at 700 W)
RG_LAYERS = 3
#: the sequence lengths of its measured b1 splits, each with the times its
#: ops are timed past the first (the measured backend's ``repeats``) and the
#: layers it runs (None: the served depth; s2048 one (rec, rec, local)
#: repeat: at 26 layers it took 9.9 s of a 581 s run, PERF.md §4), and the
#: op sites whose shares they print: the recurrent mixer's NonGEMM sites,
#: then its GEMMs and attention (GEMM by tag, as in JAX)
RG_PROFILE_SEQS = ((16, 3, None), (2048, 3, 3))
RG_SITES = (("rglru_scan", "rglru_gates", "causal_conv1d"),
            ("linear", "einsum", "flash_attention"))
#: phase xlstm: xlstm-350m at full size in bf16 (528,361,640 parameters,
#: 1.057 GB), its Engine at XL_MAX_LEN; prompt lengths (prefilled at the
#: exact length) that pad the mLSTM's last 256-token chunk (300: one whole
#: chunk and 44 of the next), fill one exactly (256), stay inside one (97,
#: 33, 12) and run shorter than the conv's 3-row tail (2)
XL_ARCH = "xlstm-350m"
XL_MAX_LEN = 512
XL_PROMPTS = (300, 256, 97, 2, 33, 12)
#: the sequence lengths of its measured b1 splits, each with the times its
#: ops are timed past the first (the measured backend's ``repeats``: at
#: s512 the forward runs 64,235 ops, each timed behind a 0.5 ms pad, so
#: the best of 4 took 128 s; there each op is timed once) and the layers
#: they run (None: the served depth; at 24 layers the s512 split took
#: 39.1 s of a 581 s run, PERF.md §4), and the op sites whose shares they
#: print: the xLSTM mixers' NonGEMM sites, then the cells' products and
#: the projections (GEMM by tag, as in JAX)
XL_PROFILE_SEQS = ((16, 3, None), (512, 0, None))
#: the depth phase xlstm serves it at: one (mlstm x 7, slstm) repeat of
#: its three, full width (at 24 layers phase xlstm took 56.6–98.7 s of
#: 459–594 s runs, PERF.md §4)
XL_LAYERS = 8
XL_SITES = (("slstm_scan", "mlstm_dmatrix", "mlstm_normalizer", "mlstm_gates",
             "causal_conv1d", "rms_norm"),
            ("mlstm_intra", "mlstm_inter", "linear"))
#: (B, S) of the token batches phase xlstm gives its kernels: the Engine's
#: 4-slot decode step and a 512-token prefill (XL_MAX_LEN, the split's)
XL_KERNEL_BATCHES = ((4, 1), (1, 512))
#: phase softcap: gemma3-27b at full width, its first SC_LAYERS layers of
#: phase 3's served params (one repeat of its five-local, one-global
#: pattern), with Gemma 2's published logit caps (google/gemma-2-27b's
#: config.json: attn_logit_softcapping 50.0, final_logit_softcapping 30.0)
#: set by cfg.replace: no new config
SC_ARCH, SC_LAYERS = "gemma3-27b", 6
SC_CAPS = dict(attn_logit_softcap=50.0, final_logit_softcap=30.0)
#: phase musicgen: musicgen-large at full size in bf16 (48 layers), frame
#: embeddings in place of tokens (its EnCodec frontend is a stub, as in
#: JAX): a prefill of 4 rows of 1500, 750, 250 and 37 frames (30, 15, 5
#: and 0.74 s of audio at EnCodec's 50 Hz), right-padded, into caches of
#: MG_MAX_LEN, then NEW_TOKENS decode steps over the 4 slots
MG_ARCH, MG_MAX_LEN = "musicgen-large", 2048
#: the depth it is served and split at: its first 12 of 48 layers, the
#: full model made and counted (at 48 the phase took 12.25–13.02 s of
#: 478–522 s runs on an H100 80GB HBM3 at 700 W, which the bench's
#: compiled view needed; at 24 6.56–6.80 s of 514–619 s runs on the same
#: card, which phase tp and the bench's serving_sharded needed)
MG_LAYERS = 12
MG_FRAMES = (1500, 750, 250, 37)
#: its measured b1 splits (seq, repeats) and the sites they print: the
#: NonGEMM sites of its blocks, then the GEMMs and attention
MG_PROFILE_SEQS = ((16, 3), (1500, 0))
MG_SITES = (("pos_sinusoidal", "layer_norm", "gelu"),
            ("linear", "flash_attention"))
#: the hand-written kernels each quick LM case's compiled forward calls
#: (f32, unfused: the bench's own forwards), as opaque ops of the program
BENCH_COMPILED_KERNELS = {
    "llama2-7b": ("rms_norm", "swiglu", "attention_core"),
    "gpt2-xl": ("layer_norm", "attention_core"),
    "bert-base": ("layer_norm", "attention_full")}
BENCH_KERNELS = ("rms_norm", "fused_add_rms_norm", "layer_norm",
                 "fused_add_layer_norm", "rope", "swiglu", "attention_core",
                 "decode_core", "attention_full", "nms",
                 "dequant_add_rms_norm", "softmax_xent")


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def per_forward_launches(cfg, fused: bool, decode: bool = False,
                         extend: bool = False) -> dict:
    """Kernel launches of one forward on the kernel path: a prefill (or
    ``lm_forward``) runs ``attention_core`` in each global layer and
    ``attention_window`` in each local one (an encoder ``attention_full``),
    a decode step ``decode_core`` in every attention layer; a recurrent
    layer runs no attention and no rope, only its norms and FFN; a chunk of
    a chunked prefill (``lm_extend``, global layers only) runs what a
    prefill does.
    RMSNorm models launch one norm per pre-norm, post-norm and q/k-norm and
    the final one, of which fusion folds one a layer into
    ``fused_add_rms_norm``; LayerNorm models two a layer and the final one,
    of which fusion folds one into ``fused_add_layer_norm``. SwiGLU is a
    kernel fused or not; unfused GeGLU and rope are the plain op chains, as
    in the JAX package. MLA adds its latent's RMSNorm a layer; an MoE layer
    runs SwiGLU on its experts and, with shared experts, on theirs. An
    xLSTM layer (``mlstm``, ``slstm``) is its pre-norm, its mixer and the
    residual add: one block norm, the mixer's RMSNorm, and in an sLSTM
    layer under fusion its FFN's GeGLU; no attention, no second norm."""
    n = cfg.n_layers
    kinds = cfg.layer_kinds()
    n_local = kinds.count("local")
    n_x = kinds.count("mlstm") + kinds.count("slstm")   # xLSTM layers
    n_blk = n - n_x                             # layers with norm2 and an FFN
    n_attn = n_blk - kinds.count("rec")         # layers with attention
    if extend and n_attn < n:
        fail(f"{cfg.name}: a local, recurrent or xLSTM layer has no chunked "
             "prefill")
    if decode:
        out = {"decode_core": n_attn}
    elif not cfg.causal:
        out = {"attention_full": n}
    else:
        out = {"attention_core": n_attn - n_local, "attention_window": n_local}
    if cfg.norm == "rmsnorm":
        per_layer = 2 + 2 * cfg.post_norm + 2 * cfg.qk_norm + cfg.mla
        out["rms_norm"] = n_blk * (per_layer - fused) + 1 + n_x
        if fused:
            out["fused_add_rms_norm"] = n_blk
    else:
        out["layer_norm"] = (n_blk + 1 if fused else 2 * n_blk + 1) + n_x
        out["rms_norm"] = n_x
        if fused:
            out["fused_add_layer_norm"] = n_blk
    if cfg.ffn == "swiglu" or (fused and cfg.ffn == "geglu"):
        n_moe = n - cfg.first_dense_layers if cfg.is_moe else 0
        out[cfg.ffn] = n_blk + n_moe * bool(cfg.n_shared_experts)
    if fused and "slstm" in kinds:
        out["geglu"] = out.get("geglu", 0) + kinds.count("slstm")
    if fused and cfg.pos_emb == "rope":
        out["rope"] = 2 * n_attn
    return {k: v for k, v in out.items() if v}


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def bound_ms(nbytes: float, flops: float, dtype: str):
    from repro_torch.core.hardware import H100

    t_bytes = nbytes / H100.hbm_bw
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def glu_sweep(torch, gen, dt, n: int = 1 << 16):
    """(gate, up) of phase 2's sweep case: 2^16 gates evenly over [-8, 8]
    against ups of +-8 with random signs. Where 1 + tanh(z) is small (g in
    [-4, -1]) an approximate tanh's error is many times the f32 limit, while
    the identity's stays under 7 % of it (numpy emulation,
    tests/test_torch_glu_design.py)."""
    g = torch.linspace(-8.0, 8.0, n, device="cuda")
    sign = torch.randint(0, 2, (n,), generator=gen, device="cuda") * 2 - 1
    return g.to(dt), (8.0 * sign).to(dt)


def check_kernels(torch, ops, ref, gen):
    """Every kernel vs its plain version at the main path's shapes and odd
    ones, bf16 and f32. Returns ({kernel: max abs error over its cases},
    the same over the MLA shapes, over recurrentgemma-2b's, over
    xlstm-350m's, over the capped attention cases, over musicgen-large's
    shapes)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import attn_template, norms, rope
    from repro_torch.kernels import softmax_xent as xent
    from repro_torch.kernels import swiglu as glu
    from repro_torch.models import moe as M

    dts = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    # phase moe's shapes: qwen2-moe-a2.7b's and deepseek-v2-lite-16b's
    # 2048-wide rows and MLA's 512-d latent (kv_norm); qwen2's heads of
    # 128 (rope on all of each); the expert buffers (1, E, C, 1408) at the
    # capacity C of each batch, the shared experts' rows (1, T, 1408 *
    # n_shared) and deepseek's dense first layer's (B, S, 10944)
    moe_cfgs = [get_config(a) for a in MOE_ARCHS]
    mla = next(c for c in moe_cfgs if c.mla)
    moe_rows = [(b, s, w) for b, s in MOE_KERNEL_BATCHES
                for w in (moe_cfgs[0].d_model, mla.kv_lora_rank)]
    moe_glu = sorted({(1, c.n_experts, M.capacity(b * s, c), c.moe_d_ff)
                      for c in moe_cfgs for b, s in MOE_KERNEL_BATCHES})
    moe_glu += [(1, b * s, c.moe_d_ff * c.n_shared_experts)
                for c in moe_cfgs for b, s in MOE_KERNEL_BATCHES]
    moe_glu += [(b, s, mla.d_ff) for b, s in MOE_KERNEL_BATCHES]
    moe_p0 = {(b, s): 448 if s == CHUNK else 186 if s == 1 else 0
              for b, s in MOE_KERNEL_BATCHES}
    moe_rope = [(b, s, moe_cfgs[0].n_heads, moe_cfgs[0].head_dim, 1.0,
                 moe_p0[b, s], s == 1) for b, s in MOE_KERNEL_BATCHES]
    # phase tp's rank-local shapes: stablelm-3b's heads and FFN split over
    # tp 2, 4 and 8, at its 4-slot decode over a 64-deep paged view, a
    # 32-token prefill bucket and an 8-token chunk at offset 16
    slm = get_config(TP_ARCH)
    tp_heads = [slm.n_heads // t for t in TP_SHARDS]
    tp_ff = [slm.d_ff // t for t in TP_SHARDS]
    hd = slm.resolved_head_dim
    tp_rope = [(b, s, h, hd, slm.rope_fraction, p0, s == 1)
               for h in tp_heads for b, s, p0 in ((4, 1, 21), (1, 32, 0))]
    tp_glu = [(b, s, f) for f in tp_ff for b, s in ((4, 1), (1, 32))]
    tp_attn = [(1, sq, skv, h, h, hd, hd, off) for h in tp_heads
               for sq, skv, off in ((32, 32, 0), (8, 64, 16))]
    tp_decode = [(4, 64, h, h, hd, hd, [17, 4, 0, 64]) for h in tp_heads]
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def split_chunk(b, hkv, t):
        """Keys per split of decode_core's plan on this card."""
        return attn_template.decode_chunk(
            t, attn_template.decode_splits(b, hkv, t, sms))

    def decode_plan(b, hq, hkv, t, dk, dv, dt):
        """decode_core's body and (n_split, chunk) on this card."""
        return (f"body={attn_template.decode_body(dk, dv, dt)} (n_split, chunk)="
                f"{attn_template.decode_plan(b, hq, hkv, t, dk, dv, sms)}")

    def randn(shape, dt, scale=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                + mean).to(dt)

    def compare(name, got, want, dtname, case, tol=TOL, rms_scaled=False,
                body=None, mla=False, rg=False, xl=False, sc=False, mg=False,
                zero_rows=None, **extra):
        """``rms_scaled``: atol times the plain output's RMS where that is
        below 1 (attention over long rows, see the note at TOL);
        ``body``: the row norms' plan body, printed with the case, as is
        ``extra`` (rope's plan); ``mla``, ``rg``, ``xl``, ``sc``, ``mg``: an
        MLA, a recurrentgemma-2b, an xlstm-350m shape, a capped case or a
        musicgen-large shape, whose worst error is kept apart too;
        ``zero_rows``: the (row, head) outputs that see no key, which must
        be exact zeros in the kernel's output as in the plain version's."""
        torch.cuda.synchronize()
        atol, rtol = tol[dtname]
        err = (got.float() - want.float()).abs()
        info = dict(extra) if body is None else dict(extra, body=body)
        if rms_scaled:      # a case whose every row sees no key: atol 0
            rms = float(want.float().square().mean().sqrt())
            atol *= min(1.0, rms)
            info.update(plain_rms=rms, max_abs_err_over_rms=float(err.max()) / rms
                        if rms else None)
        lim = atol + rtol * want.float().abs()
        ok = bool((err <= lim).all()) and bool(torch.isfinite(got.float()).all())
        if zero_rows is not None:
            dead = want.float().abs().amax(-1) == 0
            exact = int(dead.sum()) == zero_rows and not got[dead].float().any()
            info.update(zero_rows=zero_rows, zero_rows_exact=exact)
            ok = ok and exact
        emit(phase="kernels", kernel=name, case=case, dtype=dtname,
             max_abs_err=float(err.max()), atol=atol, rtol=rtol, ok=ok, **info)
        if not ok:
            fail(f"{name} {case} {dtname}: kernel disagrees with plain version"
                 + ("" if info.get("zero_rows_exact", True) else
                    "; a row that sees no key is not exact zeros"))
        worst[name] = max(worst[name], float(err.max()))
        for hit, errs in ((mla, worst_mla), (rg, worst_rg), (xl, worst_xl),
                          (sc, worst_sc), (mg, worst_mg)):
            if hit:
                errs[name] = max(errs.get(name, 0.0), float(err.max()))

    def exact(name, got, want, dtname, case, body=None):
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        emit(phase="kernels", kernel=name, case=case, dtype=dtname,
             residual_bit_identical=same, **({} if body is None else {"body": body}))
        if not same:
            fail(f"{name} {case} {dtname}: r = x + res differs from the plain "
                 "version's (one f32 add, rounded once, on both sides)")

    worst = dict.fromkeys(SOURCES, 0.0)
    worst_mla, worst_rg, worst_xl, worst_sc, worst_mg = {}, {}, {}, {}, {}
    bodies = set()

    def body(x, dt, *others):
        """The body of csrc/norms.cu that a row norm on x runs."""
        b = norms.plan_for(x, dt, *others).body
        bodies.add(b)
        return b

    for dtname, dt in dts.items():
        # gemma3-27b's zero-centred norms (5376) and its qk-norm (128, off),
        # at the decode step and at s2048; a partial last row group (21
        # rows of 128, 16 a CTA); the widest rows of body B (bf16) and of
        # body C's 16-byte loads (f32); the bench's llama2-7b b1 s16;
        # phase moe's rows (moe_rows)
        for shape, zc in [((4, 1, 4096), False), ((1, 256, 4096), False),
                          ((1, 16, 4096), False),
                          ((2, 33, 257), False), ((3, 7, 1000), True),
                          ((4, 1, 5376), True), ((1, 37, 32, 128), False),
                          ((3, 7, 128), False), ((1, 2048, 32, 128), False),
                          ((1, 2048, 5376), True), ((2, 1, 16384), False)
                          ] + [(r, False) for r in moe_rows]:
            x, w = randn(shape, dt), randn(shape[-1:], dt)
            bd = body(x, dt, w)
            compare("rms_norm", ops.rms_norm(x, w, zero_centered=zc),
                    ref.rms_norm(x, w, zero_centered=zc), dtname,
                    f"x{list(shape)} zero_centered={zc}", body=bd)
            res = randn(shape, dt, 4.0)
            (y, r), (wy, wr) = (f.fused_add_rms_norm(x, res, w, zero_centered=zc)
                                for f in (ops, ref))
            case = f"x,res{list(shape)} zero_centered={zc}"
            compare("fused_add_rms_norm", y, wy, dtname, case, body=bd)
            exact("fused_add_rms_norm", r, wr, dtname, case, body=bd)
        # gpt2-xl's width and stablelm-3b's; a row whose mean is far from
        # zero (1e3 + N(0,1)); the Table-2 Segformer rows (32 wide) and
        # bert-base at b8; the bench's gpt2-xl b1 and b8 s16, bert-base b1,
        # and stablelm-3b's 16-token chunks and 3-slot decode
        for shape, mean in [((4, 1, 1600), 0.0), ((1, 256, 1600), 3.0),
                            ((1, 16, 1600), 0.0), ((8, 16, 1600), 3.0),
                            ((1, 128, 768), 3.0), ((1, 16, 2560), 0.0),
                            ((3, 1, 2560), 0.0),
                            ((4, 1, 2560), 0.0), ((1, 256, 2560), 3.0),
                            ((2, 33, 257), 0.0), ((3, 7, 1000), 0.0),
                            ((2, 1600), 1e3), ((2, 16384, 32), 0.0),
                            ((8, 128, 768), 3.0)]:
            x = randn(shape, dt, mean=mean)
            w, b = randn(shape[-1:], dt), randn(shape[-1:], dt)
            tol = LARGE_MEAN_TOL if mean > 100 else TOL
            case = f"x{list(shape)} mean={mean}"
            bd = body(x, dt, w, b)
            compare("layer_norm", ops.layer_norm(x, w, b),
                    ref.layer_norm(x, w, b), dtname, case, tol, body=bd)
            res = randn(shape, dt, 4.0)
            (y, r), (wy, wr) = (f.fused_add_layer_norm(x, res, w, b)
                                for f in (ops, ref))
            compare("fused_add_layer_norm", y, wy, dtname, case, tol, body=bd)
            exact("fused_add_layer_norm", r, wr, dtname, case, body=bd)
        # (B, S, H, D, fraction, first position, positions as a (B, 1)
        # column): llama decode and prefill, partial rotary at 25 heads of
        # 64, an odd head dim at 4091+, and half 48, where -i / half and
        # -i * (1 / half) differ in f32; gemma3-27b's q at a 2048-token
        # prefill and k at 2049, whose last row group is ragged (rows
        # walked by a grid stride); a decode column near 4095; rows of
        # more vectors than a CTA's threads (in chunks); half at its 6144
        # limit, scalar; stablelm-3b's decode step and prefill (head dim 80,
        # a quarter rotated: half 10, scalar); the bench's llama2-7b s16,
        # stablelm-3b's 16-token chunk at 16 and its 3-slot decode; qwen2-
        # moe-a2.7b's heads at phase moe's batches (moe_rope)
        for b, s, h, d, frac, p0, column in [(4, 1, 32, 80, 0.25, 215, True),
                                             (1, 16, 32, 128, 1.0, 0, False),
                                             (1, 16, 32, 80, 0.25, 16, False),
                                             (3, 1, 32, 80, 0.25, 40, True),
                                             (1, 256, 32, 80, 0.25, 0, False),
                                             (4, 1, 32, 128, 1.0, 186, False),
                                             (1, 256, 32, 128, 1.0, 0, False),
                                             (2, 7, 25, 64, 0.25, 500, False),
                                             (3, 7, 25, 64, 0.25, 500, False),
                                             (1, 5, 3, 34, 1.0, 4091, False),
                                             (1, 5, 3, 96, 1.0, 4091, False),
                                             (1, 2048, 32, 128, 1.0, 0, False),
                                             (1, 2049, 16, 128, 1.0, 0, False),
                                             (4, 1, 32, 128, 1.0, 4092, True),
                                             (2, 3, 72, 256, 1.0, 7, False),
                                             (1, 3, 2, 12289, 1.0, 4093, False)
                                             ] + moe_rope + tp_rope:
            x = randn((b, s, h, d), dt)
            ar = p0 + torch.arange(b if column else s, dtype=torch.int32,
                                   device="cuda")
            pos = ar[:, None] if column else ar[None].expand(b, s)
            y = ops.rope(x, pos, fraction=frac)
            compare("rope", y, ref.rope(x, pos, fraction=frac), dtname,
                    f"x{[b, s, h, d]} fraction={frac} positions {p0}.."
                    f"{int(ar[-1])}{' (B, 1)' if column else ''}",
                    plan=rope.plan_for(x, frac, y)._asdict())
        # MLA's rope (deepseek-v2-lite-16b), all of each head rotated: q_rope,
        # the last qk_rope_dim of each head's nope + rope columns copied
        # contiguous as _mla_q copies it, and the shared rope key kr, one head
        nope, rd = mla.qk_nope_dim, mla.qk_rope_dim
        for b, s in MOE_KERNEL_BATCHES:
            q = randn((b, s, mla.n_heads, nope + rd), dt)
            ar = moe_p0[b, s] + torch.arange(b if s == 1 else s,
                                             dtype=torch.int32, device="cuda")
            pos = ar[:, None] if s == 1 else ar[None].expand(b, s)
            for what, x in (("q_rope", q[..., nope:].contiguous()),
                            ("kr", randn((b, s, 1, rd), dt))):
                y = ops.rope(x, pos, fraction=1.0)
                compare("rope", y, ref.rope(x, pos, fraction=1.0), dtname,
                        f"MLA {what} x{list(x.shape)} positions "
                        f"{moe_p0[b, s]}..{int(ar[-1])}"
                        f"{' (B, 1)' if s == 1 else ''}",
                        plan=rope.plan_for(x, 1.0, y)._asdict())
        # swiglu: llama2-7b's decode step and prefill bucket; geglu:
        # gemma3-27b's decode rows, a prefill and its fused prefill at the
        # 2048 bucket (the launch phase 5 times); no multiple of 4, a tail
        # of 1; both on a view 4 elements into its storage (8-byte aligned,
        # not 16), and one element in (the scalar body), and at finite
        # extremes of the gate (e^-g, e^-2z and g^3 overflowing, the
        # denominator past 2^126), each naming its plan; the bench's
        # llama2-7b s16 and stablelm-3b's chunk and 3-slot decode; phase
        # moe's expert, shared and dense rows (moe_glu)
        for kernel, shapes in (("swiglu", [(4, 1, 11008), (1, 256, 11008),
                                           (1, 16, 11008), (1, 16, 6912),
                                           (3, 1, 6912),
                                           (4, 1, 6912), (1, 256, 6912),
                                           (2, 37, 257), (1, 13)] + moe_glu
                                           + tp_glu),
                               ("geglu", [(4, 1, 21504), (1, 256, 21504),
                                          (1, 2048, 21504), (2, 37, 257),
                                          (1, 17), (1, 1)])):
            fn, plain = getattr(ops, kernel), getattr(ref, kernel)
            cases = [(randn(s, dt, 3.0), randn(s, dt), f"{list(s)}") for s in shapes]
            gb, ub = randn((44036,), dt, 3.0), randn((44036,), dt)
            cases += [(gb[k:], ub[k:], f"[{44036 - k}] {k} elements into its storage")
                      for k in (4, 1)]
            ext = torch.tensor(GLU_EXTREMES, device="cuda").repeat(2, 8).to(dt)
            cases.append((ext, randn(tuple(ext.shape), dt), "extremes of the gate"))
            cases.append((*glu_sweep(torch, gen, dt), "gate swept over [-8, 8], |up| 8"))
            for g, u, case in cases:
                compare(kernel, fn(g, u), plain(g, u), dtname, case,
                        plan=glu.plan_for(g, u)._asdict())
        # window: (B, Sq, Skv, Hq, Hkv, D, q_offset, window): gemma3-27b's
        # prefill at the 2048 bucket and past the window at 1100; windows
        # of 1, 63, 64, 65 keys at 197 (no multiple of the 64-key tile),
        # GQA groups 1 and 2, a window longer than S, a q_offset, scalar
        # tile staging
        for b, sq, skv, hq, hkv, d, off, w in [
                (1, 2048, 2048, 32, 16, 128, 0, 1024),
                (1, 1100, 1100, 32, 16, 128, 0, 1024),
                (2, 197, 197, 4, 2, 64, 0, 1),
                (2, 197, 197, 4, 4, 64, 0, 63),
                (1, 197, 197, 8, 4, 128, 0, 64),
                (2, 197, 197, 4, 2, 64, 0, 65),
                (1, 37, 37, 4, 4, 64, 0, 1000),
                (1, 13, 140, 4, 2, 64, 127, 70),
                (1, 21, 21, 2, 2, 34, 0, 5)]:
            q = randn((b, sq, hq, d), dt)
            k, v = randn((b, skv, hkv, d), dt), randn((b, skv, hkv, d), dt)
            compare("attention_window",
                    ops.attention_window(q, k, v, w, q_offset=off),
                    ref.attention(q, k, v, q_offset=off, window=w), dtname,
                    f"q{[b, sq, hq, d]} kv{[b, skv, hkv]} q_offset={off} "
                    f"window={w}", rms_scaled=True)
        # (B, Sq, Skv, Hq, Hkv, Dk, Dv, q_offset)
        for b, sq, skv, hq, hkv, dk, dv, off in [
                (1, 256, 256, 32, 32, 128, 128, 0),   # llama prefill bucket
                (1, 256, 256, 25, 25, 64, 64, 0),     # gpt2-xl prefill bucket
                (1, 2048, 2048, 32, 16, 128, 128, 0),  # gemma3-27b global
                (2, 37, 37, 4, 4, 64, 64, 0),         # seq 37
                (1, 100, 100, 8, 2, 128, 128, 0),     # GQA 8/2
                (2, 35, 35, 4, 4, 48, 16, 0),         # Dv != Dk
                (1, 13, 40, 4, 2, 32, 32, 27),        # q_offset
                (1, 21, 21, 2, 2, 34, 18, 0),         # scalar tile staging
                (1, 50, 50, 4, 4, 80, 80, 0),         # head dims that are
                (1, 70, 70, 4, 2, 96, 96, 0),         # multiples of 16, no pow2
                (2, 1, 70, 4, 2, 128, 128, 69),       # Sq = 1
                (1, 100, 300, 8, 4, 128, 128, 200),   # q_offset, Sq < Skv
                (1, 256, 256, 32, 32, 80, 80, 0),     # stablelm-3b prefill
                (1, 64, 512, 32, 32, 80, 80, 448),    # its last 64-chunk
                (1, 16, 16, 32, 32, 128, 128, 0),     # bench: llama2-7b s16,
                (1, 16, 16, 25, 25, 64, 64, 0),       # gpt2-xl b1 and b8,
                (8, 16, 16, 25, 25, 64, 64, 0),
                (1, 16, 16, 32, 32, 80, 80, 0),       # stablelm-3b's bucket
                (1, 16, 64, 32, 32, 80, 80, 0),       # and its 16-token
                (1, 16, 64, 32, 32, 80, 80, 16),      # chunks over a
                (1, 16, 64, 32, 32, 80, 80, 32),      # 64-deep paged view
                (1, 16, 16, 16, 16, 192, 128, 0),     # deepseek-v2-lite's
                (1, 256, 256, 16, 16, 192, 128, 0),   # MLA prefill, and its
                (1, 64, 512, 16, 16, 192, 128, 448),  # last 64-chunk
                (2, 37, 200, 4, 2, 192, 128, 100)     # its GQA, a ragged chunk
                ] + tp_attn:
            q = randn((b, sq, hq, dk), dt)
            k, v = randn((b, skv, hkv, dk), dt), randn((b, skv, hkv, dv), dt)
            compare("attention_core", ops.attention_core(q, k, v, q_offset=off),
                    ref.attention(q, k, v, q_offset=off), dtname,
                    f"q{[b, sq, hq, dk]} kv{[b, skv, hkv]} dv={dv} q_offset={off}",
                    mla=dk > 128)
        # a chunk of a chunked prefill over a deeper cache whose rows past
        # the chunk are NaN (stale rows of a paged cache are finite, NaN
        # shows any of them read): the output stays finite and equals the
        # plain version over the keys up to the chunk's end
        for b, sq, skv, hq, hkv, dk, off in [(1, 64, 512, 32, 32, 80, 160),
                                             (1, 37, 512, 32, 32, 80, 160),
                                             (1, 44, 300, 8, 2, 128, 256),
                                             (2, 5, 140, 4, 4, 64, 70)]:
            q = randn((b, sq, hq, dk), dt)
            k, v = randn((b, skv, hkv, dk), dt), randn((b, skv, hkv, dk), dt)
            end = off + sq
            want = ref.attention(q, k[:, :end], v[:, :end], q_offset=off)
            k[:, end:], v[:, end:] = float("nan"), float("nan")
            compare("attention_core", ops.attention_core(q, k, v, q_offset=off),
                    want, dtname, f"q{[b, sq, hq, dk]} kv{[b, skv, hkv]} "
                    f"q_offset={off}, NaN keys and values from {end}")
        # the split over the cache: chunk C of this card's plan for one
        # row of one KV head over 4096 keys (the most splits) and for
        # gemma3's rings; lengths on a split boundary and one past it
        c1 = split_chunk(1, 1, 4096)
        c4 = split_chunk(4, 16, 1024)
        for b, t, hq, hkv, dk, dv, lens in [
                (4, 512, 32, 32, 128, 128, [1, 200, 512, 0]),   # llama, a dead slot
                (4, 512, 25, 25, 64, 64, [186, 512, 0, 72]),    # gpt2-xl
                (4, 512, 32, 32, 80, 80, [216, 20, 61, 512]),   # stablelm-3b
                (4, 64, 32, 32, 80, 80, [17, 4, 21, 64]),       # bench serving
                (3, 64, 32, 32, 80, 80, [40, 7, 0]),            # bench traffic
                (4, 1024, 32, 16, 128, 128, [1024, 1024, 1024, 53]),  # rings
                (4, 2048, 32, 16, 128, 128, [1516, 1116, 1031, 53]),  # gemma3
                (3, 100, 8, 2, 64, 64, [0, 37, 100]),           # GQA 8/2
                (2, 70, 4, 4, 48, 16, [70, 5]),                 # Dv != Dk
                (2, 30, 4, 2, 34, 18, [30, 7]),                 # scalar staging
                (1, 4096, 1, 1, 128, 128, [4096]),              # most splits
                (1, 4096, 8, 1, 128, 128, [c1 + 1]),
                (1, 4096, 8, 1, 64, 64, [c1]),
                (4, 1024, 32, 16, 128, 128, [c4, c4 + 1, 2 * c4, 0])
                ] + tp_decode:
            q = randn((b, 1, hq, dk), dt)
            k, v = randn((b, t, hkv, dk), dt), randn((b, t, hkv, dv), dt)
            n = torch.tensor(lens, dtype=torch.int32, device="cuda")
            got = ops.decode_core(q, k, v, n)
            compare("decode_core", got, ref.decode_attention(q, k, v, n), dtname,
                    f"q{[b, 1, hq, dk]} kv{[b, t, hkv]} dv={dv} lengths={lens} "
                    f"n_split={attn_template.decode_splits(b, hkv, t, sms)}")
            if 0 in lens and got[lens.index(0)].float().abs().any():
                fail("decode_core: lengths 0 must give exact zeros")
        # decode's wide bodies: deepseek-v2-lite's absorbed MLA decode (q
        # [B,1,16,576] over the latent keys [B,T,1,576] and values
        # [B,T,1,512], scale 1/sqrt(192)) at kv 512 with ragged lengths: 0,
        # 1, either side of a 32-key tile and of a 64-key split, 511 and
        # 512; the serve run's; over 4096 keys in many splits; and with NaN
        # keys and values past each row's length (stale rows of a cache
        # reach no product: the output stays finite and equals the plain
        # version over the clean cache). The bodies take these dims at this
        # group alone: the tensor cores' in bf16, the FMA units' in f32
        sc = 1.0 / math.sqrt(192)
        for b, t, hq, dk, dv, lens, nan in [
                (4, 512, 16, 576, 512, [1, 0, 300, 512], False),
                (4, 512, 16, 576, 512, [64, 65, 511, 129], False),
                (4, 512, 16, 576, 512, [31, 32, 33, 0], False),
                (4, 512, 16, 576, 512, [186, 144, 120, 72], True),
                (4, 512, 16, 576, 512, [0, 1, 33, 511], True),
                (2, 4096, 16, 576, 512, [4096, 17], False)]:
            q = randn((b, 1, hq, dk), dt)
            k, v = randn((b, t, 1, dk), dt), randn((b, t, 1, dv), dt)
            n = torch.tensor(lens, dtype=torch.int32, device="cuda")
            want = ref.decode_attention(q, k, v, n, scale=sc)
            if nan:
                for i, m in enumerate(lens):
                    k[i, m:], v[i, m:] = float("nan"), float("nan")
            got = ops.decode_core(q, k, v, n, scale=sc)
            compare("decode_core", got, want, dtname,
                    f"q{[b, 1, hq, dk]} kv{[b, t, 1]} dv={dv} lengths={lens} "
                    f"scale=1/sqrt(192)"
                    f"{', NaN keys and values past each length' if nan else ''} "
                    f"{decode_plan(b, hq, 1, t, dk, dv, dt)}", mla=True)
            if 0 in lens and got[lens.index(0)].float().abs().any():
                fail("decode_core: lengths 0 must give exact zeros")
        # recurrentgemma-2b (phase recurrent): its own shapes of each kernel
        # its main path runs (rg_kernel_cases)
        for name, fn, plain, case, kw in rg_kernel_cases(torch, ops, ref,
                                                          randn, dt):
            compare(name, fn(), plain(), dtname, case, rg=True, **kw)
        # xlstm-350m (phase xlstm): its shapes of the three kernels its main
        # path runs (xl_kernel_cases)
        for name, fn, plain, case, kw in xl_kernel_cases(torch, ops, ref,
                                                          randn, dt):
            compare(name, fn(), plain(), dtname, case, xl=True, **kw)
        # the softcap fragment (phase softcap): caps 50, 20 and 5 on the
        # three masks and decode at head dims 64, 80 and 128, rows that see
        # no key exact zeros (scripts/softcap_check.py's cases)
        for name, fn, plain, case, kw in _script("softcap_check").softcap_cases(
                torch, ops, ref, randn, dt, sms):
            compare(name, fn(), plain(), dtname, case, sc=True, **kw)
        # musicgen-large (phase musicgen): its shapes of the four kernels
        # its main path runs (mg_kernel_cases)
        for name, fn, plain, case, kw in mg_kernel_cases(torch, ops, ref,
                                                          randn, dt):
            compare(name, fn(), plain(), dtname, case, mg=True, **kw)
        # the training pair (phase train): the lse forward and the flash
        # backward, two launches bit-identical (train_kernel_cases); every
        # case is held, then the sweep fails naming each that disagreed
        missed = []
        for name, fn, plain, case, kw in train_kernel_cases(torch, ops, ref,
                                                             randn, dt):
            try:
                if not kw.get("bit_identical", True):
                    fail(f"{name} {case} {dtname}: two launches on the same "
                         "inputs differ")
                compare(name, fn(), plain(), dtname, case, **kw)
            except RuntimeError as e:
                missed.append(str(e))
        if missed:
            fail(f"{len(missed)} training-pair cases: " + " | ".join(missed))
        # full mask: (B, Sq, Skv, Hq, Hkv, Dk, Dv); 196 and 197 are not
        # multiples of the 64-key tile, 128 / 256 / 1024 are
        for b, sq, skv, hq, hkv, dk, dv in [
                (1, 197, 197, 12, 12, 64, 64),     # the vit-b16 stub
                (1, 196, 196, 12, 12, 64, 64),     # vit-b16-cls
                (8, 128, 128, 12, 12, 64, 64),     # bert-base b8
                (1, 128, 128, 12, 12, 64, 64),     # bert-base b1 (bench)
                (2, 256, 1024, 6, 6, 64, 64),      # detector refinement
                (1, 37, 301, 4, 2, 64, 32),        # GQA, Dv != Dk, odd
                (1, 21, 23, 2, 2, 34, 18),         # scalar tile staging
                (1, 50, 70, 4, 4, 80, 80),         # head 80
                (1, 1, 96, 4, 2, 96, 96)]:         # Sq = 1, head 96
            q = randn((b, sq, hq, dk), dt)
            k, v = randn((b, skv, hkv, dk), dt), randn((b, skv, hkv, dv), dt)
            compare("attention_full", ops.attention_full(q, k, v),
                    ref.attention(q, k, v, causal=False), dtname,
                    f"q{[b, sq, hq, dk]} kv{[b, skv, hkv]} dv={dv}")
        # dequant_add_rms_norm: the reference sweep's shapes, the Table-2
        # row and a decode step's
        for shape in [(4, 128), (2, 33, 257), (1, 7, 3, 64), (1, 10, 4096),
                      (4, 1, 4096)]:
            for zc in (False, True):
                q = torch.randint(-127, 128, shape, generator=gen,
                                  device="cuda", dtype=torch.int8)
                qs = torch.full((), 0.031, device="cuda")
                res, w = randn(shape, dt, 4.0), randn(shape[-1:], dt)
                (y, r), (wy, wr) = (f.dequant_add_rms_norm(
                    q, qs, res, w, zero_centered=zc) for f in (ops, ref))
                case = f"q,res{list(shape)} zero_centered={zc}"
                bd = body(q, dt, res, w)
                compare("dequant_add_rms_norm", y, wy, dtname, case, body=bd)
                exact("dequant_add_rms_norm", r, wr, dtname, case, body=bd)
                if dt == torch.bfloat16:
                    frac = float((y != wy).float().mean())
                    emit(phase="kernels", kernel="dequant_add_rms_norm",
                         case=case, dtype=dtname, y_bits_differ_frac=frac,
                         limit=Y_BITS_DIFFER_MAX)
                    if frac > Y_BITS_DIFFER_MAX:
                        fail(f"dequant_add_rms_norm {case}: {frac} of y "
                             "differs from the plain version's bits")
        # softmax_xent: the reference sweep's shapes, the §4.5 site and
        # gemma3-27b's vocabulary with 8 and 2 rows (split into many spans),
        # splits whose rows and span edges are misaligned ((5, 4099),
        # (3, 100003), (9, 24577)); labels in the first and last spans, int32
        # and int64 in turn, and from 4 rows up -1 and V in rows 1 and 2 (a
        # label outside [0, V) picks nothing: the row's logsumexp). Each
        # case runs with fresh logits, so a split plan whose counters were
        # left set, or a merge that read stale partials, disagrees
        for i, (rows, vocab) in enumerate([
                (7, 1000), (32, 50304), (3, 130), (256, 32000), (8, 262144),
                (5, 4099), (2, 262144), (3, 100003), (9, 24577)]):
            logits = randn((rows, vocab), dt, 5.0)
            ldt = (torch.int32, torch.int64)[i % 2]
            labels = torch.randint(0, vocab, (rows,), generator=gen,
                                   device="cuda", dtype=ldt)
            labels[0], labels[-1] = 0, vocab - 1
            outside = torch.zeros(rows, dtype=torch.bool, device="cuda")
            if rows >= 4:
                labels[1], labels[2] = -1, vocab
                outside[1:3] = True
            want = torch.where(
                outside, torch.logsumexp(logits.float(), -1),
                ref.softmax_xent(logits, labels.clamp(0, vocab - 1)))
            compare("softmax_xent", ops.softmax_xent(logits, labels), want,
                    dtname, f"logits[{rows},{vocab}] labels {str(ldt)[6:]}"
                    f"{' with -1 and V' if rows >= 4 else ''}", XENT_TOL,
                    plan=xent.xent_plan(rows, vocab, dt, sms)._asdict())
    if bodies != set(norms.BODY_CODE):
        fail(f"row norms: the cases reached the bodies {sorted(bodies)}, not "
             f"all of {sorted(norms.BODY_CODE)}")
    for case, (boxes, scores, thr, score_thr) in nms_cases(np.random.default_rng(SEED)):
        bt = torch.from_numpy(boxes).cuda()
        st = torch.from_numpy(scores).cuda()
        got = ops.nms(bt, st, thr, score_thr)
        want = ref.nms(bt, st, thr, score_thr)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        emit(phase="kernels", kernel="nms", case=case, n=len(boxes),
             iou_threshold=thr, score_threshold=score_thr,
             kept=int(got.sum()), plain_kept=int(want.sum()), identical=same)
        if not same:
            fail(f"nms {case}: keep mask differs from the plain version's in "
                 f"{int((got != want).sum())} of {len(boxes)} boxes")
        if case == "exact_threshold_pairs" and got.tolist() != [True, True,
                                                                 True, False]:
            fail("nms: IoU exactly 0.5 must keep, one ulp above suppress")
        if case == "fma_sensitive_pairs" and got.tolist() != fma_pairs()[1].tolist():
            fail("nms: a pair whose IoU an FMA would move across 0.5 fell the "
                 "wrong way")
    for case, (boxes, valid, thr, at, above) in nms_word_cases(
            np.random.default_rng(SEED)):
        bt, vt = torch.from_numpy(boxes).cuda(), torch.from_numpy(valid).cuda()
        got = ops.nms_sorted(bt, vt, thr)
        want = ref.nms_sorted(bt, vt, thr)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        emit(phase="kernels", kernel="nms", case=case, n=len(boxes),
             iou_threshold=thr, valid=int(valid.sum()), kept=int(got.sum()),
             plain_kept=int(want.sum()), identical=same)
        if not same:
            fail(f"nms {case}: keep mask differs from the plain version's in "
                 f"{int((got != want).sum())} of {len(boxes)} boxes")
        if not (got[at + 1] and not got[above + 1]):
            fail(f"nms {case}: IoU exactly 0.5 must keep (box {at + 1}), one "
                 f"ulp above suppress (box {above + 1})")
    return worst, worst_mla, worst_rg, worst_xl, worst_sc, worst_mg


def mg_kernel_cases(torch, ops, ref, randn, dt):
    """musicgen-large's shapes of the kernels its main path runs, as
    (kernel, launch, plain version, case, compare's keywords): the
    LayerNorms on 2048-wide rows (plain and fused with the residual) at its
    prefill batch of MG_FRAMES rows and its 4-slot decode step; causal
    attention at 32 heads of 64 (MHA) over the prefill batch, each row
    padded to the longest; decode at group 1, head dim 64, over the
    MG_MAX_LEN-deep cache at the serve run's first and last lengths. The
    attention cases' atol is scaled by the plain output's RMS: rows over
    hundreds of keys average to outputs of about bf16's atol."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import attn_template

    cfg = get_config(MG_ARCH)
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    b, s = len(MG_FRAMES), max(MG_FRAMES)
    cases = []
    for shape in ((b, s, d), (b, 1, d)):
        x, w, bias = randn(shape, dt), randn((d,), dt), randn((d,), dt)
        res = randn(shape, dt, 4.0)
        cases.append(("layer_norm",
                      lambda x=x, w=w, bias=bias: ops.layer_norm(x, w, bias),
                      lambda x=x, w=w, bias=bias: ref.layer_norm(x, w, bias),
                      f"x{list(shape)}", {}))
        cases.append(("fused_add_layer_norm",
                      lambda x=x, r=res, w=w, bias=bias:
                          ops.fused_add_layer_norm(x, r, w, bias)[0],
                      lambda x=x, r=res, w=w, bias=bias:
                          ref.fused_add_layer_norm(x, r, w, bias)[0],
                      f"x,res{list(shape)}", {}))
    q = randn((b, s, h, dh), dt)
    k, v = randn((b, s, h, dh), dt), randn((b, s, h, dh), dt)
    cases.append(("attention_core",
                  lambda: ops.attention_core(q, k, v),
                  lambda: ref.attention(q, k, v),
                  f"q,k,v{[b, s, h, dh]} causal (musicgen prefill)",
                  dict(rms_scaled=True)))
    for step in (0, NEW_TOKENS - 1):
        lens = [n + step for n in MG_FRAMES]
        q1 = randn((b, 1, h, dh), dt)
        k1, v1 = randn((b, MG_MAX_LEN, h, dh), dt), randn((b, MG_MAX_LEN, h, dh), dt)
        n = torch.tensor(lens, dtype=torch.int32, device="cuda")
        cases.append(("decode_core",
                      lambda q=q1, k=k1, v=v1, n=n: ops.decode_core(q, k, v, n),
                      lambda q=q1, k=k1, v=v1, n=n: ref.decode_attention(q, k, v, n),
                      f"q[{b},1,{h},{dh}] kv[{b},{MG_MAX_LEN},{h},{dh}] "
                      f"lengths={lens} (musicgen decode, group 1)",
                      dict(rms_scaled=True,
                           body=attn_template.decode_body(dh, dh, dt))))
    return cases


#: phase 2's cases of the training pair, (B, Sq, Skv, Hq, Hkv, D, mask,
#: window, q_offset): GQA groups 1, 4 and 8, head dims 64, 80 and 128 (the
#: bf16 tensor-core body) and 40 (no whole k16 steps: bf16 on the FMA
#: body), odd lengths, a q_offset, the three masks, granite-3-8b's training
#: shape; the last case's rows all see no key (window 8 from position 107
#: over 100 keys): zeros, NEG_INF and zero gradients
TRAIN_KERNEL_CASES = [
    (2, 97, 97, 8, 1, 64, "causal", 1, 0),
    (1, 97, 97, 4, 2, 40, "causal", 1, 0),
    (2, 97, 97, 4, 4, 80, "causal", 1, 0),
    (1, 1000, 1000, 32, 8, 128, "causal", 1, 0),
    (1, 64, 200, 8, 2, 128, "causal", 1, 136),
    (2, 2048, 2048, 32, 8, 128, "causal", 1, 0),
    (1, 300, 300, 8, 1, 128, "window", 50, 0),
    (1, 1000, 1000, 4, 4, 64, "window", 256, 0),
    (1, 40, 100, 4, 2, 80, "window", 8, 100),
    (2, 77, 130, 4, 4, 80, "full", 1, 0),
    (1, 97, 97, 8, 1, 128, "full", 1, 0),
    (1, 40, 100, 4, 2, 64, "window", 8, 107),
]


def train_kernel_cases(torch, ops, ref, randn, dt):
    """The training pair against its plain twins, as (kernel, launch,
    plain version, case, compare's keywords): the lse forward's output
    (atol scaled by its RMS where below 1, as the other attention cases)
    and its lse; attention_bwd's dq, dk and dv from the kernel's own out
    and lse, each launched twice and held bit-identical (no atomics), at
    atol times the plain gradient's RMS (uncapped) and rtol: dK and dV sum
    up to Sq x G rows, dQ up to Skv keys, so a gradient's scale is its
    sums', and the RMS of a causal dK / dV is set by its late keys (a few
    hundred rows each), which a fault in the later query steps moves by
    about their size; the largest entries (the first keys', up to ~10 at
    2048 rows) lie under rtol, an ulp of bf16."""
    cases = []
    for b, sq, skv, hq, hkv, d, mask, w, off in TRAIN_KERNEL_CASES:
        q, do = randn((b, sq, hq, d), dt), randn((b, sq, hq, d), dt)
        k, v = randn((b, skv, hkv, d), dt), randn((b, skv, hkv, d), dt)
        kw = dict(causal=mask != "full", window=w if mask == "window" else None,
                  q_offset=off)
        out, lse = ops.attention_with_lse(q, k, v, mask, w, off)
        p_out, p_lse = ref.attention_fwd_lse(q, k, v, **kw)
        blind = off >= skv + w - 1 and mask == "window"
        shape = f"q{[b, sq, hq, d]} kv{[b, skv, hkv, d]} {mask}" + (
            f" w={w}" if mask == "window" else "") + f" q_offset={off}" + (
            " (no row sees a key)" if blind else "")
        zero = dict(zero_rows=b * sq * hq) if blind else {}
        cases.append(("attention_lse", lambda o=out: o, lambda o=p_out: o,
                      f"out {shape}", dict(rms_scaled=True, **zero)))
        cases.append(("attention_lse", lambda t=lse: t, lambda t=p_lse: t,
                      f"lse {shape}", {}))
        grads = ops.attention_bwd(q, k, v, out, lse, do, mask, w, off)
        again = ops.attention_bwd(q, k, v, out, lse, do, mask, w, off)
        same = all(torch.equal(a, c) for a, c in zip(grads, again))
        want = ref.attention_bwd(q, k, v, out, lse, do, **kw)
        for what, got, plain in zip(("dq", "dk", "dv"), grads, want):
            rms = float(plain.float().square().mean().sqrt())
            err = float((got.float() - plain.float()).abs().max())
            tol = {k_: (a * rms, r) for k_, (a, r) in TOL.items()}
            cases.append(("attention_bwd", lambda g=got: g,
                          lambda p_=plain: p_, f"{what} {shape}",
                          dict(tol=tol, bit_identical=same, plain_rms=rms,
                               max_abs_err_over_rms=err / rms if rms else None,
                               plain_max=float(plain.float().abs().max()),
                               **({"zero_rows": got.numel() // d}
                                  if blind else {}))))
    return cases


def rg_kernel_cases(torch, ops, ref, randn, dt):
    """recurrentgemma-2b's shapes of the kernels its main path runs, as
    (kernel, launch, plain version, case, compare's keywords): the window
    fragment at Dk = Dv = 256, 10 query heads over one KV head, window
    2048, at phase 5's 2048-token prefill, the serve run's longest (past
    the window) and a short one; decode over rings of 2048 at lengths 0,
    1, 31-33 (either side of a 32-key tile), full and the serve run's last
    step; rope on the 10 query heads and the one key head at a prefill and
    a decode step; GeGLU at 7680; the row norms at 2560."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import attn_template, rope

    cfg = get_config(RG_ARCH)
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    w, long = cfg.window_size, max(RG_PROMPTS)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = []
    for s in (w, long, RG_PROMPTS[3]):
        q = randn((1, s, hq, d), dt)
        k, v = randn((1, s, hkv, d), dt), randn((1, s, hkv, d), dt)
        cases.append(("attention_window",
                      lambda q=q, k=k, v=v: ops.attention_window(q, k, v, w),
                      lambda q=q, k=k, v=v: ref.attention(q, k, v, window=w),
                      f"q{[1, s, hq, d]} kv{[1, s, hkv]} window={w}",
                      dict(rms_scaled=True, body=attn_template.body(dt))))
    last = [min(n + NEW_TOKENS - 1, w) for n in RG_PROMPTS[:4]]
    # (lengths, q's scale): the last case's queries make each head's
    # softmax peak on a few keys, so a split whose partials were lost or
    # overwritten moves the output by about a value's size
    for lens, qs in (([0, 1, 31, 32], 1.0), ([33, w, w, 2], 1.0), (last, 1.0),
                     ([w, w, 1500, 700], 4.0)):
        q = randn((4, 1, hq, d), dt, qs)
        k, v = randn((4, w, hkv, d), dt), randn((4, w, hkv, d), dt)
        n = torch.tensor(lens, dtype=torch.int32, device="cuda")
        plan = attn_template.decode_plan(4, hq, hkv, w, d, d, sms)
        cases.append(("decode_core",
                      lambda q=q, k=k, v=v, n=n: ops.decode_core(q, k, v, n),
                      lambda q=q, k=k, v=v, n=n: ref.decode_attention(q, k, v, n),
                      f"q{[4, 1, hq, d]} x{qs} kv{[4, w, hkv]} dv={d} "
                      f"lengths={lens}",
                      dict(body=attn_template.decode_body(d, d, dt),
                           plan=list(plan))))
    for b, s, p0, column in ((1, long, 0, False), (4, 1, long + 14, True)):
        ar = p0 + torch.arange(b if column else s, dtype=torch.int32,
                               device="cuda")
        pos = ar[:, None] if column else ar[None].expand(b, s)
        for h in (hq, hkv):
            x = randn((b, s, h, d), dt)
            cases.append(("rope",
                          lambda x=x, pos=pos: ops.rope(x, pos),
                          lambda x=x, pos=pos: ref.rope(x, pos),
                          f"x{[b, s, h, d]} positions {p0}..{int(ar[-1])}"
                          f"{' (B, 1)' if column else ''}",
                          dict(plan=rope.plan_for(x, 1.0, ops.rope(x, pos))._asdict())))
    for shape in ((4, 1, cfg.d_ff), (1, long, cfg.d_ff)):
        g, u = randn(shape, dt, 3.0), randn(shape, dt)
        cases.append(("geglu", lambda g=g, u=u: ops.geglu(g, u),
                      lambda g=g, u=u: ref.geglu(g, u), f"{list(shape)}", {}))
    for shape in ((4, 1, cfg.d_model), (1, long, cfg.d_model)):
        x, sc = randn(shape, dt), randn(shape[-1:], dt)
        res = randn(shape, dt, 4.0)
        cases.append(("rms_norm", lambda x=x, sc=sc: ops.rms_norm(x, sc),
                      lambda x=x, sc=sc: ref.rms_norm(x, sc), f"x{list(shape)}",
                      {}))
        cases.append(("fused_add_rms_norm",
                      lambda x=x, sc=sc, r=res: ops.fused_add_rms_norm(x, r, sc)[0],
                      lambda x=x, sc=sc, r=res: ref.fused_add_rms_norm(x, r, sc)[0],
                      f"x,res{list(shape)}", {}))
    return cases


def xl_kernel_cases(torch, ops, ref, randn, dt):
    """xlstm-350m's shapes of the kernels its main path runs, as (kernel,
    launch, plain version, case, compare's keywords), at each of
    XL_KERNEL_BATCHES: ``layer_norm`` on the blocks' 1024-wide rows,
    ``rms_norm`` on the mLSTM's 2048-wide cell output (and the sLSTM's
    1024), ``geglu`` on the halves of an ``ff_up`` output of 2 x 1365 split
    as ``models/xlstm.py`` splits it (contiguous copies; 1365 is odd, so
    the kernel's 8-byte vectors straddle rows), also at the serve run's
    prefills of 97 and 2 tokens, whose last vector is partial (1 and 2 of
    4 bf16 elements; 1 and 0 of 2 f32). Also checks that the kernel refuses
    the strided halves themselves."""
    from repro_torch.configs import get_config

    cfg = get_config(XL_ARCH)
    d, di = cfg.d_model, int(cfg.d_model * cfg.mlstm_proj_factor)
    d_ff = int(d * cfg.slstm_ff_factor)
    cases = []
    for b, s in XL_KERNEL_BATCHES + ((1, 97), (1, 2)):
        up = randn((b, s, 2 * d_ff), dt, 3.0)
        gate, val = up.chunk(2, dim=-1)
        try:
            ops.geglu(gate, val)
            fail(f"geglu took the strided halves of ff_up {[b, s, 2 * d_ff]}")
        except ValueError:
            pass
        g, u = gate.contiguous(), val.contiguous()
        width = 8 // g.element_size()
        cases.append(("geglu", lambda g=g, u=u: ops.geglu(g, u),
                      lambda gate=gate, val=val: ref.geglu(gate, val),
                      f"halves of ff_up{[b, s, 2 * d_ff]} ({b * s * d_ff} "
                      f"elements, {b * s * d_ff % width} in a last partial "
                      "vector)", {}))
    for b, s in XL_KERNEL_BATCHES:
        x, w, bias = randn((b, s, d), dt), randn((d,), dt), randn((d,), dt)
        cases.append(("layer_norm",
                      lambda x=x, w=w, bias=bias: ops.layer_norm(x, w, bias),
                      lambda x=x, w=w, bias=bias: ref.layer_norm(x, w, bias),
                      f"x{[b, s, d]}", {}))
        for width in (di, d):
            x, w = randn((b, s, width), dt), randn((width,), dt)
            cases.append(("rms_norm", lambda x=x, w=w: ops.rms_norm(x, w),
                          lambda x=x, w=w: ref.rms_norm(x, w),
                          f"x{[b, s, width]}", {}))
    return cases


def random_boxes(rng, n, span=60.0):
    centers = rng.uniform(size=(n, 2)) * span
    wh = rng.uniform(size=(n, 2)) * 12 + 1
    return (np.concatenate([centers - wh / 2, centers + wh / 2], -1)
            .astype(np.float32), rng.uniform(size=n).astype(np.float32))


def nms_cases(rng):
    """(name, (boxes (N, 4) f32, scores (N,) f32, iou threshold, score
    threshold)) of phase 2's NMS checks."""
    for n in (1, 37, 256, 1000, 4096):
        yield f"random-{n}", (*random_boxes(rng, n, span=2 * math.sqrt(n) + 20),
                              0.5, 0.0)
    boxes, scores = random_boxes(rng, 256)
    yield "duplicate_scores", (boxes, np.round(scores * 3) / 3, 0.5, 0.0)
    boxes[:2] = [[5, 5, 5, 5], [9, 9, 3, 3]]
    yield "zero_area", (boxes, scores, 0.5, 0.0)
    jitter = rng.uniform(size=(72, 4)).astype(np.float32) * 0.1
    yield "all_suppressed", (np.float32([10, 10, 20, 20]) + jitter,
                             np.linspace(0.9, 0.1, 72, dtype=np.float32), 0.3, 0.0)
    off = np.arange(40, dtype=np.float32) * 30
    yield "none_suppressed", (np.stack([off, off, off + 10, off + 10], -1),
                              rng.uniform(0.25, 0.75, 40).astype(np.float32),
                              0.5, 0.0)
    yield "score_threshold", (*random_boxes(rng, 1000), 0.5, 0.4)
    # f32 IoU exactly 0.5 (kept: only an IoU above the threshold
    # suppresses) and one ulp above it (suppressed)
    s = np.nextafter(np.float32(1 / 3), np.float32(0))
    yield "exact_threshold_pairs", (
        np.array([[10, 0, 13, 1], [11, 0, 14, 1], [0, 0, 1, 1],
                  [s, 0, np.float32(s + 1), 1]], np.float32),
        np.array([0.9, 0.8, 0.7, 0.6], np.float32), 0.5, 0.0)
    yield "fma_sensitive_pairs", (fma_pairs()[0],
                                  np.linspace(0.9, 0.1, 2 * len(FMA_PAIRS),
                                              dtype=np.float32), 0.5, 0.0)
    # 2048 pairs of equal boxes a third of their width apart: IoU 1/2 up
    # to rounding, so each pair's f32 IoU falls a few ulps either side
    x, y, w, h = rng.uniform(5, 40, (4, 2048))
    ox, oy = (np.arange(2048) % 64) * 100.0, (np.arange(2048) // 64) * 100.0
    a = np.stack([ox + x, oy + y, ox + x + w, oy + y + h], -1)
    pairs = np.stack([a, a + np.stack([w / 3, 0 * w, w / 3, 0 * w], -1)], 1)
    yield "near_threshold_pairs", (pairs.reshape(-1, 4).astype(np.float32),
                                   np.linspace(0.99, 0.5, 4096, dtype=np.float32),
                                   0.5, 0.0)


#: box pairs (a, b), a scored above b, whose f32 IoU falls on one side of
#: 0.5 with every product and sum rounded on its own and on the other side
#: where nvcc fuses a product into an FMA: the first four where
#: (area_j + area_i) - iw * ih is fused, the others where area_j + area_i
#: is fused with area_i's product (found by an exact search; the property
#: is checked in tests/test_torch_rope_nms_design.py). True: b suppressed
FMA_PAIRS = [
    (("0x1.92b46ep+4", "0x1.49090ap+4", "0x1.a43a12p+5", "0x1.259f7ep+5"),
     ("0x1.124f8p+5", "0x1.49090ap+4", "0x1.ed2f5cp+5", "0x1.259f7ep+5"), True),
    (("0x1.44f968p+4", "0x1.16d42p+5", "0x1.4c8accp+5", "0x1.0b1662p+6"),
     ("0x1.b65822p+4", "0x1.16d42p+5", "0x1.853a2ap+5", "0x1.0b1662p+6"), True),
    (("0x1.17b464p+5", "0x1.a7d144p+4", "0x1.6f161ap+5", "0x1.161158p+6"),
     ("0x1.34d4f6p+5", "0x1.a7d144p+4", "0x1.8c36acp+5", "0x1.161158p+6"), True),
    (("0x1.39b9fp+5", "0x1.49ef3cp+4", "0x1.0eac4ep+6", "0x1.07dc66p+6"),
     ("0x1.85997ep+5", "0x1.49ef3cp+4", "0x1.349c16p+6", "0x1.07dc66p+6"), True),
    (("0x1.5686fp+3", "0x1.19b4dp+5", "0x1.35280ep+5", "0x1.395716p+6"),
     ("0x1.4047aep+4", "0x1.19b4dp+5", "0x1.7faa2ap+5", "0x1.395716p+6"), True),
    (("0x1.2b58ecp+4", "0x1.5e7c8ep+4", "0x1.31a708p+5", "0x1.e5b862p+5"),
     ("0x1.93554ep+4", "0x1.5e7c8ep+4", "0x1.65a538p+5", "0x1.e5b862p+5"), True),
    (("0x1.6f9cd6p+4", "0x1.96639p+0", "0x1.0033e8p+6", "0x1.8e534p+5"),
     ("0x1.2556e2p+5", "0x1.96639p+0", "0x1.36f824p+6", "0x1.8e534p+5"), False),
    (("0x1.a0844ap+4", "0x1.12c91ep+3", "0x1.c331a2p+5", "0x1.c0d378p+5"),
     ("0x1.213ca4p+5", "0x1.12c91ep+3", "0x1.0a161p+6", "0x1.c0d378p+5"), False)]


def fma_pairs():
    """FMA_PAIRS as one set of score-sorted boxes (a0, b0, a1, b1, ...),
    pair k scaled by 16^k (a power of two: every rounding as at 1), so that
    no two pairs touch; and the keep mask the rounded IoUs give."""
    boxes, keep = [], []
    for k, (a, b, suppressed) in enumerate(FMA_PAIRS):
        for box in (a, b):
            boxes.append([float.fromhex(v) * 16.0 ** k for v in box])
        keep += [True, not suppressed]
    return np.array(boxes, np.float32), np.array(keep)


def nms_word_cases(rng):
    """(name, (score-sorted boxes (N, 4) f32, valid (N,), iou threshold,
    a, b)) at the mask's word boundaries and above, for ``nms_sorted``
    directly: every third box invalid, and two pairs far from the rest,
    one at an f32 IoU of exactly 0.5 at sorted places (a, a + 1), across a
    word boundary where N allows, one an ulp above it at (b, b + 1)."""
    s = np.nextafter(np.float32(1 / 3), np.float32(0))
    for n in (63, 64, 65, 129, 4663, 8192):
        boxes, _ = random_boxes(rng, n, span=2 * math.sqrt(n) + 20)
        valid = np.arange(n) % 3 != 1
        a = 63 if n > 64 else n // 2 - 1
        b = 127 if n > 128 else (a + 3 if a + 4 < n else a - 3)
        boxes[a:a + 2] = [[10010, 0, 10013, 1], [10011, 0, 10014, 1]]
        boxes[b:b + 2] = [[0, 1000, 1, 1001], [s, 1000, np.float32(s + 1), 1001]]
        valid[[a, a + 1, b, b + 1]] = True
        yield f"words-{n}", (boxes, valid, 0.5, a, b)


# ---------------------------------------------------------------------------
# phase 5: times at the main path's shapes
# ---------------------------------------------------------------------------

def time_kernels(torch, ops, ref, gen, decode_lengths, graph, nms_inputs):
    """Kernel, plain and library times at the serve phase's main-path shapes
    (bf16), with the bound each function's bytes and operations set. The
    row-wise kernels do their arithmetic in f32 on the CUDA cores, so their
    operations are bounded by the f32 rate; attention's products could run
    on the tensor cores, so theirs by the bf16 rate. Returns the kernels
    line's entries and prints the gpt2-xl attention shapes, the other
    full-mask ones, gemma3-27b's GeGLU prefill, global causal prefill and
    ring decode, the row norms' wider shapes and the empty kernel on lines
    of their own. The attention rows name the body that ran (``mma bf16``
    or ``fma f32``, attn_template.body), the row norms theirs (``warp``,
    ``cta`` or ``smem``, norms.row_norm_plan)."""
    import torch.nn.functional as F

    from repro_torch.kernels import attn_template, norms, rope
    from repro_torch.kernels import softmax_xent as xent
    from repro_torch.kernels import swiglu as glu

    timer = graph.Timer()
    dt = torch.bfloat16

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    def entry(shape, kernel, plain, library, nbytes, flops, peak="float32",
              body=None, plain_runs=None):
        """``plain_runs``: the plain version timed over that many runs
        without a warm-up, not the timer's 20 (NMS's greedy loop)."""
        plain_timer = timer if plain_runs is None else graph.Timer(
            iters=plain_runs, warmup=0)
        row = dict(shape=shape, ms=timer(kernel), eager_ms=timer.eager(kernel),
                   plain_ms=None if plain is None else plain_timer(plain),
                   library_ms=None if library is None else timer(library),
                   bound=bound_ms(nbytes, flops, peak))
        if body is not None:
            row["body"] = body
        return row

    body = attn_template.body(dt)

    # the row norms: the kernels line's five rows (the decode step's and
    # the Table-2 dequant row), then gemma3-27b's qk-norm and block norms at
    # s2048, the Table-2 Segformer row, bert-base at b8 and an empty
    # kernel (the launch floor), on lines of their own
    out, extra = {}, {}
    for key, row in _script("norm_timing").time_row_norms(
            torch, ops, ref, entry, gen, norms).items():
        (out if key in SOURCES else extra)[key] = row
    # rope at the decode step (the kernels line) and gemma3-27b's prefill
    # q and k; nms on the detector's first image (the kernels line), the
    # Table-2 RoI row and MAX_BOXES (scripts/rope_nms_timing.py)
    for key, row in _script("rope_nms_timing").time_rope_nms(
            torch, ops, ref, entry, gen, rope, nms_inputs,
            [[n - 1] for n in decode_lengths["llama2-7b"]], floor=False).items():
        (out if key in SOURCES else extra)[key] = row
    # stablelm-3b's decode step: head dim 80, rope on a quarter of it (half
    # 10: no 16-byte vector, the scalar plan), positions as a (4, 1) column
    x = randn((4, 1, 32, 80))
    col = torch.tensor([[n - 1] for n in decode_lengths["stablelm-3b"]],
                       dtype=torch.int32, device="cuda")
    rot = x.numel() // 4                        # the rotated quarter
    extra["rope stablelm"] = entry(
        "q[4,1,32,80] bf16, fraction 0.25 (half 10), positions (4,1) "
        "(stablelm-3b fused decode step)",
        lambda: ops.rope(x, col, fraction=0.25),
        lambda: ref.rope(x, col, fraction=0.25), None,
        2 * 2 * x.numel() + 4 * col.numel(), 3 * rot + 3 * 4 * 10)
    extra["rope stablelm"]["plan"] = rope.plan_for(
        x, 0.25, ops.rope(x, col, fraction=0.25))._asdict()
    # swiglu and geglu at the decode step (the kernels line) and the served
    # prefills, with torch.mul of the same operands (scripts/glu_timing.py)
    for key, row in _script("glu_timing").time_glu(
            torch, ops, ref, entry, gen, glu, floor=False).items():
        (out if key in SOURCES else extra)[key] = row
    # attention_window: gemma3-27b's local-layer prefill at the 2048 bucket;
    # the library call is SDPA over KV heads repeated to 32 with the band
    # mask spelled out
    b, s, hq, hkv, dh, w = 1, 2048, 32, 16, 128, 1024
    q = randn((b, s, hq, dh))
    k, v = randn((b, s, hkv, dh)), randn((b, s, hkv, dh))
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (a.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
              for a in (k, v))
    ar = torch.arange(s, device="cuda")
    band = (ar[:, None] >= ar[None, :]) & (ar[:, None] - ar[None, :] < w)
    visible = int(band.sum())               # (q, k) pairs per head
    out["attention_window"] = entry(
        f"q[1,{s},{hq},{dh}] kv[1,{s},{hkv},{dh}] bf16 window={w} "
        "(gemma3-27b local prefill, 2048 bucket)",
        lambda: ops.attention_window(q, k, v, w),
        lambda: ref.attention(q, k, v, window=w),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band),
        2 * b * s * dh * (2 * hq + 2 * hkv), 2 * b * hq * visible * 2 * dh,
        "bfloat16", body)
    # attention_core: gemma3-27b's global layers at the same bucket; the
    # library call is causal SDPA over the KV heads repeated to 32
    visible = s * (s + 1) // 2
    extra["attention_core gemma3"] = entry(
        f"q[1,{s},{hq},{dh}] kv[1,{s},{hkv},{dh}] bf16 causal "
        "(gemma3-27b global prefill, 2048 bucket)",
        lambda: ops.attention_core(q, k, v), lambda: ref.attention(q, k, v),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
        2 * b * s * dh * (2 * hq + 2 * hkv), 2 * b * hq * visible * 2 * dh,
        "bfloat16", body)
    # decode_core: gemma3-27b's ring decode, its 4 slots' local caches of
    # depth 1024 at the serve run's lengths (min(pos + 1, 1024))
    b, t = 4, 1024
    lens_l = [min(n, t) for n in decode_lengths["gemma3-27b"]]
    q1 = randn((b, 1, hq, dh))
    k1, v1 = randn((b, t, hkv, dh)), randn((b, t, hkv, dh))
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    mask = (torch.arange(t, device="cuda")[None] < lens[:, None])[:, None, None, :]
    qt1 = q1.transpose(1, 2).contiguous()
    kt1, vt1 = (a.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
                for a in (k1, v1))
    kv = sum(lens_l)
    extra["decode_core gemma3 ring"] = entry(
        f"q[4,1,{hq},{dh}] kv[4,{t},{hkv},{dh}] bf16 lengths={lens_l} "
        "(gemma3-27b ring decode)",
        lambda: ops.decode_core(q1, k1, v1, lens),
        lambda: ref.decode_attention(q1, k1, v1, lens),
        lambda: F.scaled_dot_product_attention(qt1, kt1, vt1, attn_mask=mask),
        2 * (2 * b * hq * dh + 2 * kv * hkv * dh), 4 * kv * hq * dh, "bfloat16")

    # MLA (deepseek-v2-lite-16b): attention_core's (192, 128) instantiation
    # at its 256-token prefill bucket, causal SDPA beside it; decode_core's
    # bf16 wide body (the tensor cores') on the absorbed decode of its 4
    # slots over a 512-deep latent cache at the serve run's lengths, SDPA
    # beside it with the mask spelled out and the one KV head expanded to
    # the 16 query heads, its body and split plan named
    b, s, h, dk, dv = 1, 256, 16, 192, 128
    q, k, v = randn((b, s, h, dk)), randn((b, s, h, dk)), randn((b, s, h, dv))
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    visible = s * (s + 1) // 2
    mla_prefill = entry(
        f"q,k[1,{s},{h},{dk}] v[1,{s},{h},{dv}] bf16 causal "
        "(deepseek-v2-lite MLA prefill bucket)",
        lambda: ops.attention_core(q, k, v), lambda: ref.attention(q, k, v),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
        2 * b * s * h * (2 * dk + 2 * dv),
        2 * b * h * visible * (dk + dv), "bfloat16", body)
    b, t, h, dk, dv = 4, 512, 16, 576, 512
    lens_l = decode_lengths["deepseek-v2-lite-16b"]
    sc = 1.0 / math.sqrt(192)
    q1 = randn((b, 1, h, dk))
    k1, v1 = randn((b, t, 1, dk)), randn((b, t, 1, dv))
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    mask = (torch.arange(t, device="cuda")[None] < lens[:, None])[:, None, None, :]
    qt1 = q1.transpose(1, 2).contiguous()
    kt1, vt1 = (a.expand(b, t, h, a.shape[3]).transpose(1, 2).contiguous()
                for a in (k1, v1))
    kv = sum(lens_l)
    mla_decode = entry(
        f"q[4,1,{h},{dk}] kv[4,{t},1,{dk}/{dv}] bf16 lengths={lens_l} "
        "scale=1/sqrt(192) (deepseek-v2-lite absorbed MLA decode)",
        lambda: ops.decode_core(q1, k1, v1, lens, scale=sc),
        lambda: ref.decode_attention(q1, k1, v1, lens, scale=sc),
        lambda: F.scaled_dot_product_attention(qt1, kt1, vt1, attn_mask=mask,
                                               scale=sc),
        2 * (b * h * dk + kv * (dk + dv) + b * h * dv),
        2 * kv * h * (dk + dv), "bfloat16")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mla_decode["body"] = attn_template.decode_body(dk, dv, q1.dtype)
    mla_decode["plan"] = list(attn_template.decode_plan(b, h, 1, t, dk, dv, sms))
    extra["attention_core mla prefill"] = mla_prefill
    extra["decode_core mla"] = mla_decode

    # recurrentgemma-2b's local layers: attention_window's (256, 256)
    # instantiation at a 2048-token prefill (its window is 2048, so every
    # key of the causal triangle is seen), causal SDPA beside it over the
    # one KV head expanded to the 10 query heads; decode_core's wide body
    # at (256, 256), G 10, over its 4 slots' full rings of 2048 (a long
    # decode's steady state), SDPA beside it with the mask spelled out
    b, s, h, hkv, d, w = 1, 2048, 10, 1, 256, 2048
    q, k, v = randn((b, s, h, d)), randn((b, s, hkv, d)), randn((b, s, hkv, d))
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (a.expand(b, s, h, d).transpose(1, 2).contiguous() for a in (k, v))
    visible = s * (s + 1) // 2
    rg_prefill = entry(
        f"q[1,{s},{h},{d}] kv[1,{s},{hkv},{d}] bf16 window={w} "
        "(recurrentgemma-2b local prefill)",
        lambda: ops.attention_window(q, k, v, w),
        lambda: ref.attention(q, k, v, window=w),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
        2 * b * s * d * (2 * h + 2 * hkv), 2 * b * h * visible * 2 * d,
        "bfloat16", body)
    b, t = 4, w
    lens_l = [t] * b
    q1 = randn((b, 1, h, d))
    k1, v1 = randn((b, t, hkv, d)), randn((b, t, hkv, d))
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    mask = (torch.arange(t, device="cuda")[None] < lens[:, None])[:, None, None, :]
    qt1 = q1.transpose(1, 2).contiguous()
    kt1, vt1 = (a.expand(b, t, h, d).transpose(1, 2).contiguous()
                for a in (k1, v1))
    kv = sum(lens_l)
    rg_decode = entry(
        f"q[4,1,{h},{d}] kv[4,{t},{hkv},{d}] bf16 lengths={lens_l} "
        "(recurrentgemma-2b ring decode)",
        lambda: ops.decode_core(q1, k1, v1, lens),
        lambda: ref.decode_attention(q1, k1, v1, lens),
        lambda: F.scaled_dot_product_attention(qt1, kt1, vt1, attn_mask=mask),
        2 * (2 * b * h * d + 2 * kv * hkv * d), 4 * kv * h * d, "bfloat16")
    rg_decode["body"] = attn_template.decode_body(d, d, q1.dtype)
    rg_decode["plan"] = list(attn_template.decode_plan(b, h, hkv, t, d, d, sms))
    extra["attention_window recurrentgemma"] = rg_prefill
    extra["decode_core recurrentgemma"] = rg_decode

    # attention_core at the last 64-token chunk of a chunked prefill into a
    # 512-deep cache (stablelm-3b, q_offset 448); the library call is SDPA
    # with the causal-offset mask spelled out
    b, sq, t, h, dh, off = 1, 64, 512, 32, 80, 448
    q, k, v = randn((b, sq, h, dh)), randn((b, t, h, dh)), randn((b, t, h, dh))
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    mask = (torch.arange(t, device="cuda")[None, :]
            <= off + torch.arange(sq, device="cuda")[:, None])
    visible = sum(off + i + 1 for i in range(sq))
    extra["attention_core extend"] = entry(
        f"q[1,{sq},{h},{dh}] kv[1,{t},{h},{dh}] bf16 causal q_offset={off} "
        "(stablelm-3b, the last chunk of a chunked prefill)",
        lambda: ops.attention_core(q, k, v, q_offset=off),
        lambda: ref.attention(q, k, v, q_offset=off),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
        2 * b * h * dh * (2 * sq + 2 * t), 2 * b * h * visible * 2 * dh,
        "bfloat16", body)
    for arch, (h, dh) in (("llama2-7b", (32, 128)), ("gpt2-xl", (25, 64))):
        # attention_core: the serve phase's largest prefill bucket
        b, s = 1, 256
        q, k, v = randn((b, s, h, dh)), randn((b, s, h, dh)), randn((b, s, h, dh))
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        visible = s * (s + 1) // 2                 # causal (q, k) pairs per head
        attn = entry(
            f"q,k,v[1,256,{h},{dh}] bf16 causal ({arch} prefill bucket)",
            lambda: ops.attention_core(q, k, v), lambda: ref.attention(q, k, v),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
            4 * b * s * h * dh * 2, 2 * b * h * visible * 2 * dh, "bfloat16",
            body)
        # decode_core: the 4-slot cache of depth 512 at the serve run's lengths
        b, t = 4, 512
        lens_l = decode_lengths[arch]
        q = randn((b, 1, h, dh))
        k, v = randn((b, t, h, dh)), randn((b, t, h, dh))
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        mask = (torch.arange(t, device="cuda")[None] < lens[:, None])[:, None, None, :]
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        kv = sum(lens_l)
        dec = entry(
            f"q[4,1,{h},{dh}] kv[4,512,{h},{dh}] bf16 lengths={lens_l} ({arch})",
            lambda: ops.decode_core(q, k, v, lens),
            lambda: ref.decode_attention(q, k, v, lens),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
            2 * (2 * b * h * dh + 2 * kv * h * dh), 4 * kv * h * dh, "bfloat16")
        if arch == "llama2-7b":
            out["attention_core"], out["decode_core"] = attn, dec
            attn["mla"], dec["mla"] = mla_prefill, mla_decode
        else:
            extra["attention_core"], extra["decode_core"] = attn, dec
    # attention_full: vit-b16-cls's 196 tokens (the kernels line), the
    # detector's refinement (K = 256 queries over its 1024 cells) and
    # bert-base at b8 s128 (lines of their own)
    for key, (b, sq, skv, h, what) in (
            ("attention_full", (1, 196, 196, 12, "vit-b16-cls, 224 px")),
            ("attention_full refine", (1, 256, 1024, 6,
                                       "detector-vit-s refinement")),
            ("attention_full bert", (8, 128, 128, 12, "bert-base b8 s128"))):
        dh = 64
        q = randn((b, sq, h, dh))
        k, v = randn((b, skv, h, dh)), randn((b, skv, h, dh))
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        row = entry(
            f"q[{b},{sq},{h},{dh}] kv[{b},{skv},{h},{dh}] bf16 full ({what})",
            lambda: ops.attention_full(q, k, v),
            lambda: ref.attention(q, k, v, causal=False),
            lambda: F.scaled_dot_product_attention(qt, kt, vt),
            2 * b * h * dh * (2 * sq + 2 * skv),
            2 * b * h * sq * skv * 2 * dh, "bfloat16", body)
        if key == "attention_full":
            out[key] = row
        else:
            extra[key] = row
    # softmax_xent at the §4.5 site, (256, 32000) f32 (the kernels line),
    # gemma3-27b's vocabulary with 8 rows, its loss chunk and llama2-7b's
    # loss over 2048 tokens; the library call is F.cross_entropy per row,
    # beside torch.amax of the same logits (scripts/xent_timing.py)
    for key, row in _script("xent_timing").time_xent(
            torch, ops, ref, entry, gen, xent, floor=False).items():
        (out if key in SOURCES else extra)[key] = row
    for name, tm in extra.items():
        emit(phase="timing", kernel=name, **{k: v for k, v in tm.items()
                                             if k != "bound"},
             bound_ms=tm["bound"][0], bound_by=tm["bound"][1])
    out["attention_window"]["recurrentgemma"] = rg_prefill
    out["decode_core"]["recurrentgemma"] = rg_decode
    # the softcap fragment at gemma3-27b's shapes (phase softcap; the
    # kernels line under "softcap"), each beside capped flex_attention, the
    # same kernel uncapped and SDPA uncapped, timed in this call; and
    # musicgen-large's prefill attention and decode (phase musicgen; under
    # "musicgen")
    capped, mg = time_capped_and_musicgen(torch, ops, ref, timer, entry,
                                          randn, body, out, extra)
    for name, row in capped.items():
        out[name]["softcap"] = row
    for name, row in mg.items():
        out[name]["musicgen"] = row
    # xlstm-350m (phase xlstm): its three kernels at the 4-slot decode step
    # (the kernels line, under "xlstm") and at a 512-token prefill (lines of
    # their own): layer_norm on the blocks' rows, rms_norm on the mLSTM's
    # cell output, geglu on the contiguous halves of ff_up (torch.mul of
    # the same operands beside it; no one PyTorch call computes GeGLU)
    glu_flops = _script("glu_timing").FLOPS["geglu"]
    for b, s in XL_KERNEL_BATCHES:
        what = "decode step" if s == 1 else f"prefill s{s}"
        x, w, bias = randn((b, s, 1024)), randn((1024,)), randn((1024,))
        n = x.numel()
        ln = entry(f"x[{b},{s},1024] bf16 (xlstm-350m {what})",
                   lambda x=x, w=w, bias=bias: ops.layer_norm(x, w, bias),
                   lambda x=x, w=w, bias=bias: ref.layer_norm(x, w, bias),
                   lambda x=x, w=w, bias=bias: F.layer_norm(x, (1024,), w,
                                                            bias, 1e-5),
                   2 * n * 2 + 2 * 1024 * 2, 8 * n)
        x, w = randn((b, s, 2048)), randn((2048,))
        n = x.numel()
        rms = entry(f"x[{b},{s},2048] bf16 (xlstm-350m mLSTM out_norm, {what})",
                    lambda x=x, w=w: ops.rms_norm(x, w),
                    lambda x=x, w=w: ref.rms_norm(x, w),
                    (lambda x=x, w=w: F.rms_norm(x, (2048,), w, 1e-6))
                    if hasattr(F, "rms_norm") else None,
                    2 * n * 2 + 2048 * 2, 4 * n)
        gate, val = randn((b, s, 2730)).chunk(2, dim=-1)
        g, u = gate.contiguous(), val.contiguous()
        n = g.numel()
        glu = entry(f"halves of ff_up[{b},{s},2730] bf16 (xlstm-350m sLSTM "
                    f"FFN, {what})", lambda g=g, u=u: ops.geglu(g, u),
                    lambda g=g, u=u: ref.geglu(g, u), None, 3 * 2 * n,
                    glu_flops * n)
        glu["mul_ms"] = entry("torch.mul of the same operands",
                              lambda g=g, u=u: torch.mul(g, u), None, None,
                              0, 0)["ms"]
        rows = {"layer_norm": ln, "rms_norm": rms, "geglu": glu}
        for name, row in rows.items():
            if s == 1:
                out[name]["xlstm"] = row
            else:
                emit(phase="timing", kernel=f"{name} xlstm prefill",
                     **{k: v for k, v in row.items() if k != "bound"},
                     bound_ms=row["bound"][0], bound_by=row["bound"][1])
    # the training pair at granite-3-8b's shape (phase train): the lse
    # forward beside the entry without it and flash SDPA's forward, the
    # flash backward beside SDPA's (scripts/train_check.py)
    out.update(_script("train_check").time_train_pair(torch, ops, ref, entry,
                                                      randn))
    return out


def time_capped_and_musicgen(torch, ops, ref, timer, entry, randn, body, out,
                             extra):
    """Phase 5's rows of the softcap fragment at gemma3-27b's shapes, each
    with the uncapped kernel's and SDPA's (uncapped, a reference only) ms
    of the same inputs, timed in this call (``uncapped_ms``,
    ``sdpa_uncapped_ms``): the window prefill q[1,2048,32,128] at window
    1024, the global causal prefill, the ring decode kv[4,1024,16,128]; and
    musicgen-large's causal prefill over its MG_FRAMES rows and its decode
    at group 1 over kv[4,MG_MAX_LEN,32,64] beside SDPA. The capped rows'
    library call is compiled ``flex_attention`` with the cap as its score
    modification and the mask as its block mask
    (``scripts/softcap_check.py``'s ``flex_capped``), its distance from the
    plain version kept as ``library_max_abs_err``. The capped bound is the
    largest of the bytes' time, the products' at the bf16 rate and the
    cap's three f32 operations a visible score (division, tanh, product)
    at the f32 rate: the tensor cores and the FMA units run at once."""
    import torch.nn.functional as F

    from repro_torch.core.hardware import H100

    cap = SC_CAPS["attn_logit_softcap"]
    flex_capped = _script("softcap_check").flex_capped

    def capped_row(shape, kernel, plain, library, nbytes, flops, scores,
                   uncapped):
        lib_call, lib_out = library
        row = entry(f"{shape} softcap={cap}", kernel, plain, lib_call, nbytes,
                    flops, "bfloat16", body)
        t_bytes = nbytes / H100.hbm_bw
        t_ops = max(flops / PEAK_FLOPS["bfloat16"],
                    3 * scores / PEAK_FLOPS["float32"])
        row["bound"] = (max(t_bytes, t_ops) * 1e3,
                        "bytes" if t_bytes >= t_ops else "operations")
        row["library_max_abs_err"] = float(
            (lib_out().float() - plain().float()).abs().max())
        row["uncapped_ms"] = timer(uncapped["kernel"])
        row["sdpa_uncapped_ms"] = timer(uncapped["sdpa"])
        return row

    b, s, hq, hkv, dh, w = 1, 2048, 32, 16, 128, 1024
    q = randn((b, s, hq, dh))
    k, v = randn((b, s, hkv, dh)), randn((b, s, hkv, dh))
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (a.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
              for a in (k, v))
    ar = torch.arange(s, device="cuda")
    band = (ar[:, None] >= ar[None, :]) & (ar[:, None] - ar[None, :] < w)
    nbytes = 2 * b * s * dh * (2 * hq + 2 * hkv)
    rows = {}
    vis = int(band.sum())
    rows["attention_window"] = capped_row(
        f"q[1,{s},{hq},{dh}] kv[1,{s},{hkv},{dh}] bf16 window={w} "
        "(gemma3-27b local prefill, 2048 bucket)",
        lambda: ops.attention_window(q, k, v, w, softcap=cap),
        lambda: ref.attention(q, k, v, window=w, softcap=cap),
        flex_capped(torch, cap, q, k, v,
                    lambda b, h, qi, ki: (qi >= ki) & (qi - ki < w)), nbytes,
        2 * b * hq * vis * 2 * dh, b * hq * vis,
        dict(kernel=lambda: ops.attention_window(q, k, v, w),
             sdpa=lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                         attn_mask=band)))
    vis = s * (s + 1) // 2
    rows["attention_core"] = capped_row(
        f"q[1,{s},{hq},{dh}] kv[1,{s},{hkv},{dh}] bf16 causal "
        "(gemma3-27b global prefill, 2048 bucket)",
        lambda: ops.attention_core(q, k, v, softcap=cap),
        lambda: ref.attention(q, k, v, softcap=cap),
        flex_capped(torch, cap, q, k, v, lambda b, h, qi, ki: qi >= ki),
        nbytes, 2 * b * hq * vis * 2 * dh, b * hq * vis,
        dict(kernel=lambda: ops.attention_core(q, k, v),
             sdpa=lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                         is_causal=True)))
    b, t = 4, 1024
    lens_l = [t, t, t, 53]
    q1 = randn((b, 1, hq, dh))
    k1, v1 = randn((b, t, hkv, dh)), randn((b, t, hkv, dh))
    ring = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    mask = (torch.arange(t, device="cuda")[None] < ring[:, None])[:, None, None, :]
    qt1 = q1.transpose(1, 2).contiguous()
    kt1, vt1 = (a.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
                for a in (k1, v1))
    kv = sum(lens_l)
    rows["decode_core"] = capped_row(
        f"q[4,1,{hq},{dh}] kv[4,{t},{hkv},{dh}] bf16 lengths={lens_l} "
        "(gemma3-27b ring decode)",
        lambda: ops.decode_core(q1, k1, v1, ring, softcap=cap),
        lambda: ref.decode_attention(q1, k1, v1, ring, softcap=cap),
        flex_capped(torch, cap, q1, k1, v1,
                    lambda b, h, qi, ki: ki < ring[b], batch=b),
        2 * (2 * b * hq * dh + 2 * kv * hkv * dh), 4 * kv * hq * dh, kv * hq,
        dict(kernel=lambda: ops.decode_core(q1, k1, v1, ring),
             sdpa=lambda: F.scaled_dot_product_attention(qt1, kt1, vt1,
                                                         attn_mask=mask)))
    rows["decode_core"]["body"] = "fma"
    # musicgen-large: 32 heads of 64, MHA
    h, dh = 32, 64
    b, s = len(MG_FRAMES), max(MG_FRAMES)
    q, k, v = (randn((b, s, h, dh)) for _ in range(3))
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    vis = s * (s + 1) // 2
    mg = {"attention_core": entry(
        f"q,k,v[{b},{s},{h},{dh}] bf16 causal (musicgen-large prefill of "
        f"{list(MG_FRAMES)} frames, padded to {s})",
        lambda: ops.attention_core(q, k, v), lambda: ref.attention(q, k, v),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
        4 * b * s * h * dh * 2, 2 * b * h * vis * 2 * dh, "bfloat16", body)}
    t = MG_MAX_LEN
    lens_l = [n + NEW_TOKENS - 1 for n in MG_FRAMES]
    q1 = randn((b, 1, h, dh))
    k1, v1 = randn((b, t, h, dh)), randn((b, t, h, dh))
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    mask = (torch.arange(t, device="cuda")[None] < lens[:, None])[:, None, None, :]
    qt1, kt1, vt1 = (a.transpose(1, 2).contiguous() for a in (q1, k1, v1))
    kv = sum(lens_l)
    mg["decode_core"] = entry(
        f"q[4,1,{h},{dh}] kv[4,{t},{h},{dh}] bf16 lengths={lens_l} "
        "(musicgen-large decode, group 1)",
        lambda: ops.decode_core(q1, k1, v1, lens),
        lambda: ref.decode_attention(q1, k1, v1, lens),
        lambda: F.scaled_dot_product_attention(qt1, kt1, vt1, attn_mask=mask),
        2 * (2 * b * h * dh + 2 * kv * h * dh), 4 * kv * h * dh, "bfloat16")
    mg["decode_core"]["body"] = "fma"
    for tag, group in (("softcap", rows), ("musicgen", mg)):
        for name, tm in group.items():
            emit(phase="timing", kernel=f"{name} {tag}",
                 **{k: v for k, v in tm.items() if k != "bound"},
                 bound_ms=tm["bound"][0], bound_by=tm["bound"][1])
    return rows, mg


def _script(name: str):
    """``scripts/<name>.py`` of this tree: the row norms' timed cases
    (``norm_timing``), rope's and NMS's (``rope_nms_timing``), the gated
    activations' (``glu_timing``), softmax_xent's (``xent_timing``)."""
    spec = importlib.util.spec_from_file_location(
        name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# phase 3: serve, and the paths against each other
# ---------------------------------------------------------------------------

def compare_paths(torch, nn, params, cfg, prompts, fused: bool,
                  max_len: int, extend_prompt=None, frames=None):
    """The model's kernel path against another path of the same model, on
    the card, on the same weights: for the unfused model the plain path
    (``"torch"`` backend), for the fused one both the fused plain path and
    the unfused kernel path. Compared are the prefill logits of each prompt
    alone, then one decode step of all of them together from the kernel
    path's caches, each row at its own position (``decode_core``'s per-row
    lengths). With ``extend_prompt``, also its chunked prefill
    (``lm_prefill`` of the first EXTEND_FIRST tokens, then ``lm_extend`` of
    the rest in chunks of CHUNK at their absolute offsets: ``attention_core``
    at ``q_offset`` over the whole cache depth): the kernel path's last-token
    logits against ``lm_prefill`` of the whole prompt on the same path, and
    against the plain path's chunked prefill. With ``frames`` (an
    ``input_mode="embeddings"`` model: right-padded frame embeddings
    (B, S, d_model), their lengths, the (B, d_model) frame fed to decode;
    ``prompts`` unused), one prefill of the whole batch with its lengths
    and the decode step on the fed frame. Prints every reading, then
    fails if one is past its limit: F32_ANCHOR times the reference path's
    distance from the plain path run with f32 activations, LOGIT_ATOL at
    the least."""
    from repro_torch.models import lm_decode, lm_extend, lm_prefill

    kernel = ("cuda", fused)
    others = [("torch", fused)] + ([("cuda", False)] if fused else [])
    # the plain path with f32 activations, on the same bf16 weights
    cfg32 = cfg.replace(dtype="float32")

    def run(setting, fn, c=cfg):
        backend, fz = setting
        with nn.backend(backend), nn.fuse(fz):
            return fn(c)

    bad = []
    phase = "serve" if frames is None else "musicgen"

    def check(step, vs, lk, lt, l32, **info):
        check_anchored(phase, step, bad, lk, lt, l32, model=cfg.name,
                       fused=fused, against=f"{vs[0]} fused={vs[1]}", **info)

    if frames is not None:
        x, pos, feed = frames

        def prefill(c):
            return lm_prefill(params, x, c, max_len=max_len, lengths=pos)
        lk, caches = run(kernel, prefill)
        l32 = run(("torch", False), prefill, cfg32)[0]
        for vs in others:
            check("prefill_logits", vs, lk, run(vs, prefill)[0], l32,
                  frames=pos.tolist())
        del l32
        token = torch.from_numpy(feed).cuda()
    else:
        rows = []
        for p in prompts:
            toks = torch.tensor([p], device="cuda")

            def prefill(c):
                return lm_prefill(params, toks, c, max_len=max_len)
            lk, caches = run(kernel, prefill)
            l32 = run(("torch", False), prefill, cfg32)[0]
            for vs in others:
                check("prefill_logits", vs, lk, run(vs, prefill)[0], l32,
                      prompt_len=len(p))
            rows.append((lk, caches))
            del l32

        token = torch.cat([lk.argmax(-1) for lk, _ in rows])
        pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                           device="cuda")
        # every leaf: a ring's "pos" side-car too
        caches = [{n: torch.cat([c[i][n] for _, c in rows])
                   for n in rows[0][1][i]} for i in range(cfg.n_layers)]

    def decode(c):                      # each path writes its own copy
        # the activations' leaves in the path's dtype; a recurrent state's
        # f32 and a ring's int32 side-car as they are
        fresh = [{n: t.to(c.activation_dtype, copy=True)
                  if t.dtype == cfg.activation_dtype else t.clone()
                  for n, t in layer.items()}
                 for layer in caches]
        return lm_decode(params, token, pos, fresh, c)[0]

    lk = run(kernel, decode)
    l32 = run(("torch", False), decode, cfg32)
    for vs in others:
        check("decode_logits", vs, lk, run(vs, decode), l32,
              positions=pos.tolist())
    if extend_prompt is not None:
        toks = torch.tensor([extend_prompt], device="cuda")
        starts = list(range(EXTEND_FIRST, len(extend_prompt), CHUNK))

        def chunked(c):
            _, cs = lm_prefill(params, toks[:, :EXTEND_FIRST], c,
                               max_len=max_len)
            for start in starts:
                logits, cs = lm_extend(params, toks[:, start:start + CHUNK],
                                       start, cs, c)
            return logits[:, -1]

        def whole(c):
            return lm_prefill(params, toks, c, max_len=max_len)[0]
        lk = run(kernel, chunked)
        l32 = run(("torch", False), whole, cfg32)
        info = dict(prompt_len=len(extend_prompt), first=EXTEND_FIRST,
                    chunk_starts=starts)
        check("extend_vs_whole_prefill", kernel, lk, run(kernel, whole), l32,
              **info)
        check("extend_logits", ("torch", fused), lk,
              run(("torch", fused), chunked), l32, **info)
    if bad:
        fail(f"{phase}: {cfg.name} fused={fused} logits past their limits: "
             + "; ".join(bad))


def serve_prompts(torch, ops, engine, prompts):
    """``prompts`` served to the end on ``engine``, NEW_TOKENS each, its
    launches counted from zero: (the finished requests in the order of
    ``prompts``, None for one that did not finish; launches; wall s)."""
    ops.reset_launches()
    t0 = time.perf_counter()
    uids = [engine.add_request(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    done = {r.uid: r for r in engine.run()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return ([done.get(u) for u in uids],
            {k: v for k, v in ops.launches.items() if v}, wall)


def engine_launches(cfg, engine) -> dict:
    """What an engine's run since ``reset_stats()`` must have launched:
    its whole-prompt prefills (one a first token on the ``Engine``; the
    cold ones on the ``PagedEngine``), extend chunks and decode steps, each
    at the path's per-forward count. A graph's replays count."""
    paged = hasattr(engine, "cold_prefills")
    need = {}
    for per, times in (
            (per_forward_launches(cfg, engine.fused),
             engine.cold_prefills if paged else engine.stats.first_tokens),
            (per_forward_launches(cfg, engine.fused, extend=True) if paged
             else {}, engine.extend_chunks if paged else 0),
            (per_forward_launches(cfg, engine.fused, decode=True),
             engine.stats.decode_steps)):
        for k, n in per.items():
            need[k] = need.get(k, 0) + n * times
    return {k: v for k, v in need.items() if v}


def check_counters(torch, _build, what: str) -> None:
    """The decode and NMS kernels leave their counters zeroed: after every
    run, eager or replayed, each buffer must read zero."""
    torch.cuda.synchronize()
    bad = {str(key): int(buf.count_nonzero())
           for key, buf in _build._COUNTERS.items() if buf.count_nonzero()}
    if bad:
        fail(f"{what}: kernel counters left nonzero: {bad}")


def check_memory_back(torch, before: int, what: str) -> int:
    """After an engine is deleted, the card holds at most MEM_SLACK bytes
    more than before it was built; returns the difference."""
    gc.collect()
    torch.cuda.synchronize()
    extra = torch.cuda.memory_allocated() - before
    if extra > MEM_SLACK:
        fail(f"{what}: {extra} bytes still allocated after the engine was "
             "deleted")
    return extra


def step_bytes(cfg, params, pos, max_len: int, paged: bool) -> int:
    """The bytes one decode step must move at positions ``pos``: every
    weight once (an untied embedding's and a learned position table's
    lookups read one row a slot, a tied one is read whole by the logits;
    the MoE dispatch runs every expert, so every expert's weights),
    each row's ``pos + 1`` cached keys and values in every attention layer
    (a ring's at most its window), each recurrent layer's state (``h`` in
    f32 and the conv's last inputs), each mLSTM layer's (``C``, ``n``,
    ``m`` in f32 and the conv's last inputs) and each sLSTM layer's (``c``,
    ``n``, ``m``, ``h`` in f32) read and written once a row and, paged,
    the (B, max_len) view gathered: read from the pools once and written
    once."""
    b = len(pos)
    weights = sum(t.numel() * t.element_size() for t in _leaves(params))
    for table in ("embed", "pos"):
        t = params.get(table)
        if t is not None and (table == "pos" or "head" in params):
            weights -= (t.shape[0] - b) * t.shape[1] * t.element_size()
    kv_row = 2 * cfg.n_kv_heads * cfg.resolved_head_dim * KV_BYTES
    if cfg.mla:                       # the latent and the rope key
        kv_row = (cfg.kv_lora_rank + cfg.qk_rope_dim) * KV_BYTES
    kinds = cfg.layer_kinds()
    keys = sum(min(int(p) + 1, cfg.window_size if kind == "local" else max_len)
               for kind in kinds if kind in ("attn", "local") for p in pos)
    w = cfg.lru_width or cfg.d_model
    di = int(cfg.d_model * cfg.mlstm_proj_factor)
    dh = di // cfg.n_heads
    per_row = {"rec": 4 * w + (cfg.conv_width - 1) * w * KV_BYTES,
               "mlstm": (4 * cfg.n_heads * (dh * dh + dh + 1)
                         + (cfg.conv_width - 1) * di * KV_BYTES),
               "slstm": 4 * 4 * cfg.d_model}
    state = sum(b * 2 * per_row[k] for k in kinds if k in per_row)
    view = 2 * b * max_len * kv_row * cfg.n_layers if paged else 0
    return weights + keys * kv_row + state + view


def replay_timing(torch, engine, cfg, params, n: int = 20) -> dict:
    """Device ms of one replay of ``engine``'s captured decode step (its
    last step, the positions left in its static buffer: a free slot decodes
    at 0), ``n`` replays back to back between CUDA events after 3 more,
    beside the step's byte bound. Run after the engine's last request: the
    replays write KV rows that no later admission reads, and are not
    counted in ``ops.launches``."""
    graph = engine._run_step                     # serving/cuda_graph.StepGraph
    pos = graph._inputs[1].cpu().tolist()
    for _ in range(3):
        graph._graph.replay()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(n):
        graph._graph.replay()
    e1.record()
    torch.cuda.synchronize()
    nbytes = step_bytes(cfg, params, pos, engine.max_len,
                        paged=hasattr(engine, "allocator"))
    ms = e0.elapsed_time(e1) / n
    b_ms, _ = bound_ms(nbytes, 0.0, "bfloat16")
    return {"replay_ms": round(ms, 4), "bound_ms": round(b_ms, 4),
            "bound_by": "bytes", "step_bytes": nbytes, "positions": pos,
            "bound_frac": round(b_ms / ms, 4)}


def first_differing(got, want) -> list:
    return [next((i for i, (a, b) in enumerate(zip(g or [], w)) if a != b),
                 None) for g, w in zip(got, want)]


def emit_graph_vs_eager(phase, cfg, fused, step, graph, eager, **info):
    """Decode tok/s and ms a step (host clock; median and [min, max] of the
    repeats) of the graph against the eager step, and the replay's device
    ms beside the step's byte bound."""
    def med(xs):
        return round(statistics.median(xs), 3) if xs else None

    def spread(xs):
        return [round(min(xs), 3), round(max(xs), 3)] if xs else None
    emit(phase=phase, model=cfg.name, fused=fused,
         step=f"{step}: graph vs eager", repeats=len(graph["tok_s"]),
         graph_decode_tok_per_s=med(graph["tok_s"]),
         graph_spread=spread(graph["tok_s"]),
         eager_decode_tok_per_s=med(eager["tok_s"]),
         eager_spread=spread(eager["tok_s"]),
         speedup=round(med(graph["tok_s"]) / med(eager["tok_s"]), 3)
         if eager["tok_s"] else None,
         graph_step_ms=med(graph["step_ms"]),
         eager_step_ms=med(eager["step_ms"]),
         mem_extra_bytes=[graph["mem_extra"], eager["mem_extra"]],
         **graph.get("replay", {}), **info)


def paged_prompts(rng, cfg):
    """Phase ``paged`` (b)'s prompts: (shared, long, long, shared, shared,
    shared), the shared ones a common SHARED_PREFIX and SUFFIX tokens of
    their own, the long ones LONG_PROMPTS[0]..LONG_PROMPTS[1] tokens."""
    def draw(n):
        return [int(t) for t in rng.integers(1, cfg.vocab_size, n)]
    prefix = draw(SHARED_PREFIX)
    shared = [prefix + draw(SUFFIX) for _ in range(4)]
    long = [draw(int(n)) for n in rng.integers(*LONG_PROMPTS, 2, endpoint=True)]
    return [shared[0], *long, *shared[1:]]


def check_blocks(alloc, pc, what: str) -> None:
    """Every block back to the allocator or held by the prefix cache."""
    cached = 0 if pc is None else len(pc)
    if alloc.free_blocks + cached != alloc.num_blocks - 1:
        fail(f"{what}: {alloc.free_blocks} blocks free and {cached} cached "
             f"of {alloc.num_blocks - 1}")


def logits_replay_diff(torch, engine, cfg) -> float:
    """One decode step's logits (``make_serve_step(greedy=False)``) on the
    engine's cache at its last step's tokens and positions, through a new
    CUDA graph: its warm-up (the eager step) against its replay on the same
    inputs and the same state; the max |difference|, 0 where the replay is
    bit-identical. The step rewrites the same KV rows each time; a running
    state (a recurrent or xLSTM layer's), which the step advances, is put
    back before the replay. Launches are not checked after this."""
    from repro_torch.serving import make_serve_step
    from repro_torch.serving.cuda_graph import StepGraph

    step = make_serve_step(cfg, greedy=False, fused=engine.fused)
    params, caches = engine.params, engine._caches
    inputs = [x.cpu().numpy() for x in engine._run_step._inputs]
    running = [c for c, kind in zip(caches, cfg.layer_kinds())
               if kind not in ("attn", "local")]
    saved = [{n: t.clone() for n, t in c.items()} for c in running]

    def restore():
        for c, s in zip(running, saved):
            for n, t in c.items():
                t.copy_(s[n])
    graph = StepGraph(lambda t, p: step(params, t, p, caches)[0], inputs,
                      engine.device)
    eager = graph(*inputs).float().clone()     # the warm-up, then capture
    restore()
    return (graph(*inputs).float() - eager).abs().max().item()


def serve(torch, ops, _build, E, params, cfg, prompts, fused: bool,
          max_len: int, step: str, cuda_graph: bool = True, same_as=None,
          want=None, exact: bool = False, repeats: int = 0,
          **engine_kw) -> dict:
    """One engine ``E`` (``Engine`` or ``PagedEngine``, ``max_batch=4``)
    serving ``prompts``, its decode step a CUDA
    graph or, with ``cuda_graph=False``, eager; then ``repeats`` more times
    on the same engine (paged: prefix caching off only, since a warm cache
    would move the chunk boundaries). Returns the first run's launches and
    tokens (in the order of ``prompts``), the repeats' decode tok/s and ms
    a step (host clock) and, for a graph that repeats, its replay's device
    ms beside its bound.

    Fails unless every request finished with NEW_TOKENS tokens; every run
    launched exactly what its prefills, extend chunks and decode steps
    need (replays included); the kernels' counters read zero after every
    run; every paged block came back to the allocator or the prefix cache,
    and a prefix cache was hit; every repeat gave the first run's tokens,
    and these equal ``same_as`` (the eager step's, same engine) where
    given; deleting the engine gave its memory back. ``want``: the
    contiguous Engine's tokens for the same prompts in the same run; with
    ``exact`` the tokens must equal them (the cold paged path), otherwise
    the number that do is printed (a bf16 chunk may move an argmax at a
    near-tie)."""
    mem0 = torch.cuda.memory_allocated()
    engine = E(cfg, params, max_batch=4, max_len=max_len, fused=fused,
               cuda_graph=cuda_graph, **engine_kw)
    paged = hasattr(engine, "allocator")
    phase = "paged" if paged else "serve"
    what = f"{phase}: {cfg.name} fused={fused} {step} cuda_graph={cuda_graph}"
    if repeats and getattr(engine, "prefix_cache", None) is not None:
        fail(f"{what}: repeats need prefix_caching=False")
    out = {"tok_s": [], "step_ms": []}
    for rep in range(1 + repeats):
        engine.reset_stats()
        done, launches, wall = serve_prompts(torch, ops, engine, prompts)
        st, pc = engine.stats, getattr(engine, "prefix_cache", None)
        got = [r.output if r else [] for r in done]
        if rep == 0:
            info = {}
            if paged:
                info = dict(
                    cold_prefills=engine.cold_prefills,
                    extend_chunks=engine.extend_chunks,
                    prefix_hits=0 if pc is None else pc.hits,
                    hit_rate=0.0 if pc is None else round(pc.hit_rate, 4),
                    num_blocks=engine.allocator.num_blocks,
                    free_blocks=engine.allocator.free_blocks,
                    cached_blocks=0 if pc is None else len(pc))
            if want is not None:
                info.update(
                    tokens_equal_contiguous=f"{sum(g == w for g, w in zip(got, want))}"
                                            f" of {len(prompts)}",
                    first_differing_token=first_differing(got, want))
            emit(phase=phase, model=cfg.name, fused=fused, step=step,
                 cuda_graph=cuda_graph,
                 prompt_lens=[len(p) for p in prompts], completed=st.completed,
                 wall_s=round(wall, 4),
                 tok_per_s=round(st.emitted_tokens / wall, 2),
                 decode_tok_per_s=round(st.decode_tok_per_s, 2),
                 mean_ttft_s=round(st.mean_ttft_s, 4),
                 mean_decode_tok_latency_s=round(
                     st.mean_decode_tok_latency_s, 5),
                 prefill_s=round(st.prefill_s, 4),
                 decode_s=round(st.decode_s, 4),
                 decode_steps=st.decode_steps, **info, launches=launches)
            if any(len(o) != NEW_TOKENS for o in got):
                fail(f"{what}: {st.completed} of {len(prompts)} requests "
                     f"finished, lengths {[len(o) for o in got]}")
            if any(not 0 <= t < cfg.vocab_size for o in got for t in o):
                fail(f"{what}: a token outside the vocabulary")
            if exact and got != want:
                fail(f"{what}: the tokens of "
                     f"{sum(g != w for g, w in zip(got, want))} requests "
                     "differ from the contiguous Engine's")
            if pc is not None and not pc.hit_rate > 0:
                fail(f"{what}: no prefix-cache hit")
            out["launches"], out["tokens"] = launches, got
        else:
            if got != out["tokens"]:
                fail(f"{what}: repeat {rep} gave other tokens than the first "
                     "run")
            out["tok_s"].append(st.decode_tok_per_s)
            out["step_ms"].append(st.decode_s / st.decode_steps * 1e3)
        need = engine_launches(cfg, engine)
        if launches != need:
            fail(f"{what} run {rep} launched {launches}; its "
                 f"{st.first_tokens} prefills and {st.decode_steps} decode "
                 f"steps (paged: {getattr(engine, 'cold_prefills', 0)} cold, "
                 f"{getattr(engine, 'extend_chunks', 0)} chunks) need {need}")
        check_counters(torch, _build, what)
        if paged:
            check_blocks(engine.allocator, pc, what)
    if same_as is not None and out["tokens"] != same_as:
        fail(f"{what}: the graph's tokens differ from the eager step's: "
             f"first differing token per request "
             f"{first_differing(out['tokens'], same_as)}")
    if cuda_graph and repeats:
        out["replay"] = replay_timing(torch, engine, cfg, params)
        if not paged:
            out["replay"]["logits_max_abs_diff"] = logits_replay_diff(
                torch, engine, cfg)
    del engine
    out["mem_extra"] = check_memory_back(torch, mem0, what)
    return out


# ---------------------------------------------------------------------------
# phase moe: qwen2-moe-a2.7b and deepseek-v2-lite-16b served at full size
# ---------------------------------------------------------------------------

def moe_reference(torch, p, x, cfg):
    """One MoE layer on x (1, T, D), computed apart from models/moe.py:
    the router logits by the same bf16 product, the softmax in f32, each
    token's top k by a stable descending sort on the host (ties to the
    lower expert), the capacity walk over the flat (token, choice) stream
    in a host loop, each expert's SwiGLU FFN on its kept rows in f32 and
    the gate-weighted sum, plus the shared experts in f32. Returns (y (T,
    D) f32, dropped choices)."""
    import torch.nn.functional as F

    t, e, k = x.shape[1], cfg.n_experts, cfg.top_k
    logits = torch.matmul(x, p["router"])[0]
    probs = torch.softmax(logits.float(), dim=-1).cpu().numpy()
    ids = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
    gates = np.take_along_axis(probs, ids, -1)
    gates = gates / np.maximum(gates.sum(-1, keepdims=True), 1e-9)
    cap = max(int(t * k / e * cfg.capacity_factor), 4)
    seen, kept = np.zeros(e, np.int64), np.zeros((t, k), bool)
    for i in range(t):
        for j in range(k):
            kept[i, j] = seen[ids[i, j]] < cap
            seen[ids[i, j]] += 1
    xf = x[0].float()

    def ffn(w, h, ex=None):
        pick = (lambda a: a.float()) if ex is None else (lambda a: a[ex].float())
        return (F.silu(h @ pick(w["w_gate"])) * (h @ pick(w["w_up"]))) \
            @ pick(w["w_down"])
    y = torch.zeros_like(xf)
    for ex in range(e):
        rows, js = np.nonzero((ids == ex) & kept)
        if len(rows):
            r = torch.from_numpy(rows).cuda()
            g = torch.from_numpy(gates[rows, js]).float().cuda()
            y.index_add_(0, r, ffn(p["experts"], xf[r], ex) * g[:, None])
    if cfg.n_shared_experts:
        y += ffn(p["shared"], xf)
    return y, int((~kept).sum())


def moe_layer_check(torch, ops, gen, params, cfg) -> None:
    """The last layer's MoE on MOE_LAYER_TOKENS random rows, on the kernel
    path, against :func:`moe_reference`, at each of MOE_LAYER_CFS; fails
    where a token row differs by more than MOE_ROW_RTOL of its norm, or no
    choice was dropped at the low capacity."""
    from repro_torch.models import moe as M

    p = params["layers"][-1]["moe"]
    x = (torch.randn((1, MOE_LAYER_TOKENS, cfg.d_model), generator=gen,
                     device="cuda")).to(torch.bfloat16)
    for cf in MOE_LAYER_CFS:
        c = cfg if cf is None else cfg.replace(capacity_factor=cf)
        before = ops.launches["swiglu"]
        y, _ = M.moe_forward(p, x, c, with_aux=False)
        want, dropped = moe_reference(torch, p, x, c)
        torch.cuda.synchronize()
        err = (y[0].float() - want).norm(dim=-1) / want.norm(dim=-1)
        worst = float(err.max())
        swiglus = ops.launches["swiglu"] - before
        emit(phase="moe", model=cfg.name, step="layer vs reference",
             tokens=MOE_LAYER_TOKENS, capacity_factor=c.capacity_factor,
             capacity=M.capacity(MOE_LAYER_TOKENS, c), dropped_choices=dropped,
             worst_row_rel_err=worst, limit=MOE_ROW_RTOL,
             swiglu_launches=swiglus)
        if not worst <= MOE_ROW_RTOL or not torch.isfinite(y).all():
            fail(f"moe: {cfg.name} cf={c.capacity_factor}: a token row "
                 f"{worst:.4f} of its norm from the reference")
        if cf is not None and dropped == 0:
            fail(f"moe: {cfg.name} cf={cf} dropped no choice")
        if swiglus != 1 + bool(cfg.n_shared_experts):
            fail(f"moe: {cfg.name}: {swiglus} swiglu launches in one layer")


def routing_swaps(torch, nn, params, cfg, prompts, fused: bool,
                  max_len: int) -> None:
    """Prints how many (token, MoE layer) pairs choose another top-k set
    of experts on the kernel path than on the plain path, over the
    prefills of ``prompts``: the routing is discontinuous, so an ulp apart
    upstream can swap an expert near a tie."""
    from repro_torch.models import lm_prefill
    from repro_torch.models import moe as M

    orig = M.top_k

    def routes(backend):
        got = []

        def record(probs, k):
            vals, idx = orig(probs, k)
            got.append(torch.sort(idx, dim=-1).values)
            return vals, idx
        M.top_k = record
        try:
            with nn.backend(backend), nn.fuse(fused):
                for prompt in prompts:
                    lm_prefill(params, torch.tensor([prompt], device="cuda"),
                               cfg, max_len=max_len)
        finally:
            M.top_k = orig
        return got
    kern, plain = routes("cuda"), routes("torch")
    swapped = sum(int((a != b).any(-1).sum()) for a, b in zip(kern, plain))
    emit(phase="moe", model=cfg.name, fused=fused,
         step="routing swaps, kernel vs plain path (prefills)",
         prompt_lens=[len(p) for p in prompts], swapped_token_layers=swapped,
         token_layers=sum(a.shape[0] * a.shape[1] for a in kern))


def moe_split(torch, nn, ops, params, cfg, rng) -> None:
    """The measured split of one eager b1 s16 ``lm_forward`` of ``cfg``'s
    layers (the first MOE_PROFILE_LAYERS of the served params; the kernel
    path, unfused) through ``Workload.profile("measured")``, with the
    shares of the MoE sites, beside the ``eager-modeled:h100`` view of its
    capture."""
    from repro_torch.core import H100, capture, model_records
    from repro_torch.models import lm_forward

    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (1, 16))).cuda()
    name = f"{cfg.name} unfused b-1 s-16 bf16"
    w, prof, wall_ms, per = measured(ops, lm_forward, (params, toks, cfg),
                                     name, False)
    if per != per_forward_launches(cfg, False):
        fail(f"moe: {name}: launched {per} per forward, expected "
             f"{per_forward_launches(cfg, False)}")
    sites = {}
    for (g, site), t, _ in prof.top_op_sites(10 ** 6):
        if site in MOE_SITES:
            sites[site] = sites.get(site, 0.0) + t
    emit_profile("moe", prof, wall_ms, per, layers=cfg.n_layers,
                 site_frac={k: round(sites.get(k, 0.0) / prof.total_seconds, 4)
                            for k in MOE_SITES},
                 site_ms={k: round(sites.get(k, 0.0) * 1e3, 4)
                          for k in MOE_SITES})
    missing = [k for k in MOE_SITES if not sites.get(k)]
    if missing:
        fail(f"moe: {name}: no device time at the sites {missing}")
    fn, args = w.build()
    modeled = model_records(capture(fn, *args), w.name, H100)
    emit_modeled("eager-modeled:h100", modeled, prof, phase="moe")


def moe(torch, nn, ops, _build, Engine, PagedEngine, init_lm, get_config,
        launches: dict, decode_lengths: dict, paths_only: bool = False) -> None:
    """Phase ``moe``: each of MOE_ARCHS at full size in bf16 (random
    weights from SEED): its MoE layer against the reference; then unfused
    and fused, the ``Engine`` (4 slots, ``max_len`` 512, 6 requests of
    NEW_TOKENS tokens) eager and graphed, tokens identical, decode tok/s
    and the replay beside the step's byte bound; the ``PagedEngine``
    graphed, cold with the Engine's tokens, and in 64-token chunks with
    prefix hits, every request finished and every block back;
    the routing swaps and the kernel path's logits against the plain
    path's under the anchored rule; and the measured split of one eager
    forward. Each model's memory comes back before the next. The lengths
    of the last decode step of the first 4 requests go to
    ``decode_lengths`` (phase 5 times the MLA decode there)."""
    gen = torch.Generator("cuda").manual_seed(SEED)
    for arch in MOE_ARCHS:
        cfg = get_config(arch).replace(dtype="bfloat16", param_dtype="bfloat16")
        t0 = time.perf_counter()
        mem0 = torch.cuda.memory_allocated()
        params = init_lm(torch.Generator("cuda").manual_seed(SEED), cfg)
        torch.cuda.synchronize()
        emit(phase="moe", step="init", config=cfg.name,
             n_params=sum(t.numel() for t in _leaves(params)),
             init_s=round(time.perf_counter() - t0, 3),
             mem_gb=round(torch.cuda.memory_allocated() / 1e9, 3))
        rng = np.random.default_rng(SEED)
        plens = [int(n) for n in rng.integers(5, 201, 6)]
        prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
                   for n in plens]
        chunked_set = paged_prompts(np.random.default_rng(SEED + 1), cfg)
        decode_lengths[arch] = [n + NEW_TOKENS - 1 for n in plens[:4]]
        moe_layer_check(torch, ops, gen, params, cfg)
        max_len = 512
        for fused in (False, True):
            if not paths_only:
                eager = serve(torch, ops, _build, Engine, params, cfg, prompts,
                              fused, max_len, "engine", cuda_graph=False,
                              repeats=MOE_REPEATS)
                graphed = serve(torch, ops, _build, Engine, params, cfg,
                                prompts, fused, max_len, "engine",
                                same_as=eager["tokens"],
                                repeats=MOE_REPEATS)
                emit_graph_vs_eager("moe", cfg, fused, "engine", graphed, eager)
                # the PagedEngine as it serves by default, its step graphed:
                # cold, the Engine's tokens exactly; chunked with prefix
                # hits, held to finishing (a chunk's tokens set the
                # capacity, so the routing may differ from a whole prefill)
                p_graph = serve(torch, ops, _build, PagedEngine, params, cfg,
                                prompts, fused, max_len, "cold",
                                want=graphed["tokens"], exact=True,
                                block_size=BLOCK_SIZE, prefix_caching=False,
                                chunk_size=None)
                c_graph = serve(torch, ops, _build, PagedEngine, params, cfg,
                                chunked_set, fused, max_len, "chunked+cached",
                                block_size=BLOCK_SIZE, prefix_caching=True,
                                chunk_size=CHUNK)
                for run in (eager, graphed, p_graph, c_graph):
                    for k, n in run["launches"].items():
                        launches[k] += n
            routing_swaps(torch, nn, params, cfg, prompts[:4], fused, max_len)
            compare_paths(torch, nn, params, cfg, prompts[:4], fused, max_len)
        if not paths_only:
            moe_split(torch, nn, ops, params,
                      cfg.replace(n_layers=MOE_PROFILE_LAYERS), rng)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        # the weights are gone (state made once in the process, the shared
        # capture stream's workspace among it, may stay)
        left = torch.cuda.memory_allocated() - mem0
        emit(phase="moe", step="freed", config=cfg.name, left_bytes=left)
        if left > 1 << 30:
            fail(f"moe: {cfg.name}: {left} bytes left after its weights were "
                 "freed")


# ---------------------------------------------------------------------------
# phases recurrent and xlstm: a model whose layers carry a running state
# ---------------------------------------------------------------------------

def mixer_split(torch, ops, params, cfg, rng, phase: str, seq: int,
                repeats: int, sites, inputs=None) -> None:
    """The measured split of one eager b1 ``lm_forward`` of ``seq`` tokens
    (the kernel path, unfused) through ``Workload.profile("measured")``
    (each op timed ``1 + repeats`` times), with the shares of ``sites``
    (the mixer's NonGEMM sites, the others) and of the mixer's NonGEMM
    sites together, and the profile's own wall. ``inputs``: the (1, seq,
    d_model) frames of a model that takes embeddings, in place of tokens."""
    from repro_torch.models import lm_forward

    toks = inputs if inputs is not None else torch.from_numpy(
        rng.integers(1, cfg.vocab_size, (1, seq))).cuda()
    name = f"{cfg.name} unfused b-1 s-{seq} bf16"
    t0 = time.perf_counter()
    _, prof, wall_ms, per = measured(ops, lm_forward, (params, toks, cfg),
                                     name, False, repeats=repeats)
    if per != per_forward_launches(cfg, False):
        fail(f"{phase}: {name}: launched {per} per forward, expected "
             f"{per_forward_launches(cfg, False)}")
    found = dict.fromkeys(sites[0] + sites[1], 0.0)
    for (g, site), t, _ in prof.top_op_sites(10 ** 6):
        if site in found:
            found[site] += t
    total = prof.total_seconds
    mixer = sum(found[k] for k in sites[0])
    emit_profile(phase, prof, wall_ms, per, layers=cfg.n_layers, seq=seq,
                 site_frac={k: round(t / total, 4) for k, t in found.items()},
                 site_ms={k: round(t * 1e3, 4) for k, t in found.items()},
                 mixer_nongemm_ms=round(mixer * 1e3, 4),
                 mixer_nongemm_frac=round(mixer / total, 4),
                 measured_repeats=repeats,
                 profile_s=round(time.perf_counter() - t0, 2))
    missing = [k for k, t in found.items() if not t]
    if missing:
        fail(f"{phase}: {name}: no device time at the sites {missing}")


def stateful(torch, nn, ops, _build, Engine, PagedEngine, init_lm, get_config,
             phase: str, arch: str, layers: int, max_len: int, prompt_lens,
             profiles, sites, launches: dict, own_launches: dict,
             paths_only: bool = False) -> None:
    """Phase ``phase`` (``recurrent``, ``xlstm``): ``arch``, whose layers
    carry a running state (RG-LRU, mLSTM, sLSTM), made at full size in
    bf16 (random weights from SEED; the parameter count the config's) and
    served at full width, its first ``layers`` layers: the Engine (4 slots,
    ``max_len``) prefills each of ``prompt_lens`` at its
    exact length (``_bucket``: a state would consume pads); the
    PagedEngine refuses the model; unfused and fused, the Engine serves
    them eager and graphed, tokens identical, decode tok/s and the replay
    beside the step's byte bound (which reads and writes the state); the
    kernel path's logits against the plain path's under the anchored rule;
    the measured split of one eager b1 forward at each (seq, repeats,
    layers) of ``profiles`` (``mixer_split``; its first ``layers``, all
    where None). The launches of its served runs go to
    ``launches`` and to ``own_launches``; the walls of its parts to a
    ``walls`` line. Its memory comes back at the end."""
    cfg = get_config(arch).replace(dtype="bfloat16", param_dtype="bfloat16")
    t0 = time.perf_counter()
    mem0 = torch.cuda.memory_allocated()
    params = init_lm(torch.Generator("cuda").manual_seed(SEED), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    emit(phase=phase, step="init", config=cfg.name, n_params=n_params,
         layer_kinds=cfg.layer_kinds(), init_s=round(time.perf_counter() - t0, 3),
         mem_gb=round(torch.cuda.memory_allocated() / 1e9, 3))
    if n_params != cfg.n_params():
        fail(f"{phase}: {n_params} parameters, the config counts "
             f"{cfg.n_params()}")
    # the served depth: its first ``layers`` layers, full width
    params = {**params, "layers": params["layers"][:layers]}
    cfg = cfg.replace(n_layers=layers)
    emit(phase=phase, step="served depth", layers=layers,
         layer_kinds=cfg.layer_kinds())
    rng = np.random.default_rng(SEED)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
               for n in prompt_lens]
    probe = Engine(cfg, params, max_batch=4, max_len=max_len)
    buckets = [probe._bucket(n) for n in prompt_lens]
    del probe
    try:
        PagedEngine(cfg, params, max_batch=4, max_len=max_len)
        refused = None
    except ValueError as e:
        refused = str(e)
    emit(phase=phase, step="engines", prompt_lens=list(prompt_lens),
         prefill_lens=buckets, paged_engine_refused=refused)
    if buckets != list(prompt_lens):
        fail(f"{phase}: the Engine pads the prompts to {buckets}: a running "
             "state would consume the pads")
    if refused is None:
        fail(f"{phase}: the PagedEngine took a model with {cfg.layer_kinds()[0]}"
             " layers")
    walls = {}
    for fused in (False, True):
        t1 = time.perf_counter()
        if not paths_only:
            eager = serve(torch, ops, _build, Engine, params, cfg, prompts,
                          fused, max_len, "engine", cuda_graph=False,
                          repeats=REPEATS)
            graphed = serve(torch, ops, _build, Engine, params, cfg, prompts,
                            fused, max_len, "engine",
                            same_as=eager["tokens"], repeats=REPEATS)
            emit_graph_vs_eager(phase, cfg, fused, "engine", graphed, eager)
            for run in (eager, graphed):
                for k, n in run["launches"].items():
                    launches[k] += n
                    own_launches[k] = own_launches.get(k, 0) + n
        t2 = time.perf_counter()
        compare_paths(torch, nn, params, cfg, prompts[:4], fused, max_len)
        walls[f"serve fused={fused}"] = round(t2 - t1, 2)
        walls[f"compare_paths fused={fused}"] = round(time.perf_counter() - t2, 2)
    if not paths_only:
        for seq, repeats, cut in profiles:     # the first ``cut`` layers
            mixer_split(torch, ops,
                        {**params, "layers": params["layers"][:cut]},
                        cfg.replace(n_layers=cut or layers), rng, phase, seq,
                        repeats, sites)
    emit(phase=phase, step="walls", walls_s=walls)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - mem0
    emit(phase=phase, step="freed", config=cfg.name, left_bytes=left)
    if left > 1 << 30:
        fail(f"{phase}: {left} bytes left after its weights were freed")


# ---------------------------------------------------------------------------
# phase softcap: gemma3-27b with Gemma 2's logit caps
# ---------------------------------------------------------------------------

def softcap_phase(torch, nn, ops, _build, Engine, params, cfg, prompts,
                  max_len: int, launches: dict, own_launches: dict,
                  paths_only: bool = False) -> None:
    """Phase ``softcap``: ``cfg`` (gemma3-27b at full width, phase 3's
    served ``params``) cut to its first SC_LAYERS layers with SC_CAPS set:
    the capped attention kernels (window in the local layers, causal in
    the global one, decode in both) and the final logit cap on the main
    path. Unfused and fused, the Engine (4 slots, ``max_len``) serves
    ``prompts`` (phase 3's, past the 1024-token window) eager then graphed,
    tokens identical, with ``serve``'s repeats, launch, counter and memory
    checks; the same engine without the caps is served graphed once in
    the same process, its replay beside the capped one's; then the kernel
    path's logits against the plain path's under the anchored rule. The
    capped runs' launches go to ``launches`` and ``own_launches``."""
    ccfg = cfg.replace(n_layers=SC_LAYERS, **SC_CAPS)
    ucfg = cfg.replace(n_layers=SC_LAYERS)
    cut = {**params, "layers": params["layers"][:SC_LAYERS]}
    emit(phase="softcap", step="config", config=ccfg.name,
         layers=SC_LAYERS, layer_kinds=ccfg.layer_kinds(), **SC_CAPS,
         n_params=sum(t.numel() for t in _leaves(cut)))
    for fused in (False, True):
        if not paths_only:
            eager = serve(torch, ops, _build, Engine, cut, ccfg, prompts, fused,
                          max_len, "engine, capped", cuda_graph=False,
                          repeats=REPEATS)
            graphed = serve(torch, ops, _build, Engine, cut, ccfg, prompts,
                            fused, max_len, "engine, capped",
                            same_as=eager["tokens"], repeats=REPEATS)
            uncapped = serve(torch, ops, _build, Engine, cut, ucfg, prompts,
                             fused, max_len, "engine, uncapped", repeats=1)
            cap_ms = graphed["replay"]["replay_ms"]
            plain_ms = uncapped["replay"]["replay_ms"]
            emit_graph_vs_eager("softcap", ccfg, fused, "engine, capped",
                                graphed, eager, uncapped_replay_ms=plain_ms,
                                cap_replay_cost_ms=round(cap_ms - plain_ms, 4))
            for run in (eager, graphed):
                for k, n in run["launches"].items():
                    launches[k] += n
                    own_launches[k] = own_launches.get(k, 0) + n
        compare_paths(torch, nn, cut, ccfg, prompts[:4], fused, max_len)


# ---------------------------------------------------------------------------
# phase musicgen: musicgen-large through the step builders, on frames
# ---------------------------------------------------------------------------

def musicgen_phase(torch, nn, ops, _build, init_lm, get_config,
                   launches: dict, own_launches: dict,
                   paths_only: bool = False) -> None:
    """Phase ``musicgen``: musicgen-large at full size in bf16 (random
    weights from SEED, the parameter count the config's), served through
    ``make_prefill_step`` and ``make_serve_step`` on frame embeddings from
    seeded generators: the prefill of MG_FRAMES right-padded rows with
    their ``lengths``, then NEW_TOKENS decode steps of the 4 slots, each fed
    a fresh (4, d_model) frame batch, eager and as a ``StepGraph`` (float
    frames and int32 positions through its pinned buffers), from copies of
    the same caches: codebook tokens identical, launches exactly what the
    prefill and the steps need, counters zero, the replay beside the
    step's byte bound (every weight and each row's valid keys and values);
    unfused and fused. Then the kernel path's last prefill logits and one
    decode step's logits against the plain path's (the fused path's also
    against the unfused kernel path's) under the anchored rule, and the
    measured b1 split at each of MG_PROFILE_SEQS."""
    from repro_torch.serving import make_prefill_step, make_serve_step
    from repro_torch.serving.cuda_graph import StepGraph

    cfg = get_config(MG_ARCH).replace(dtype="bfloat16", param_dtype="bfloat16")
    t0 = time.perf_counter()
    mem0 = torch.cuda.memory_allocated()
    params = init_lm(torch.Generator("cuda").manual_seed(SEED), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    emit(phase="musicgen", step="init", config=cfg.name, n_params=n_params,
         weight_gb=round(2 * n_params / 1e9, 3),
         init_s=round(time.perf_counter() - t0, 3),
         mem_gb=round(torch.cuda.memory_allocated() / 1e9, 3))
    if n_params != cfg.n_params():
        fail(f"musicgen: {n_params} parameters, the config counts "
             f"{cfg.n_params()}")
    # the served depth: its first MG_LAYERS layers, full width
    params = {**params, "layers": params["layers"][:MG_LAYERS]}
    cfg = cfg.replace(n_layers=MG_LAYERS)
    b, s, d = len(MG_FRAMES), max(MG_FRAMES), cfg.d_model
    gen = torch.Generator("cuda").manual_seed(SEED + 2)
    frames = torch.randn((b, s, d), generator=gen, device="cuda")
    for i, n in enumerate(MG_FRAMES):
        frames[i, n:] = 0.0                          # right-padded
    lengths = torch.tensor(MG_FRAMES, dtype=torch.int32, device="cuda")
    feeds = torch.randn((NEW_TOKENS, b, d),
                        generator=torch.Generator().manual_seed(SEED + 3)).numpy()
    pos0 = np.array(MG_FRAMES, np.int32)
    walls = {}
    for fused in (False, True):
        t1 = time.perf_counter()
        prefill = make_prefill_step(cfg, MG_MAX_LEN, fused=fused)
        step = make_serve_step(cfg, greedy=True, fused=fused)
        if not paths_only:
            ops.reset_launches()
            logits, caches = prefill(params, frames, lengths)
            runs = {}
            for graphed in (False, True):
                cs = [{n: t.clone() for n, t in c.items()} for c in caches]

                def run(f, p, cs=cs):
                    return step(params, f, p, cs)[0]
                if graphed:
                    runner = StepGraph(run, [feeds[0], pos0], torch.device("cuda"))
                else:
                    def runner(f, p, run=run):
                        return run(torch.from_numpy(f).cuda(),
                                   torch.from_numpy(p).cuda())
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                toks = [runner(feeds[i], pos0 + i).cpu().numpy()
                        for i in range(NEW_TOKENS)]
                torch.cuda.synchronize()
                runs[graphed] = dict(tokens=np.stack(toks).tolist(),
                                     s=time.perf_counter() - t2,
                                     graph=runner if graphed else None)
                del cs
            need = {}
            for per, times in ((per_forward_launches(cfg, fused), 1),
                               (per_forward_launches(cfg, fused, decode=True),
                                2 * NEW_TOKENS)):
                for k, n in per.items():
                    need[k] = need.get(k, 0) + n * times
            got = {k: v for k, v in ops.launches.items() if v}
            check_counters(torch, _build, f"musicgen fused={fused}")
            graph = runs[True]["graph"]
            for _ in range(3):
                graph._graph.replay()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            for _ in range(20):
                graph._graph.replay()
            e1.record()
            torch.cuda.synchronize()
            replay = e0.elapsed_time(e1) / 20
            last = (pos0 + NEW_TOKENS - 1).tolist()
            nbytes = step_bytes(cfg, params, last, MG_MAX_LEN, paged=False)
            b_ms, _ = bound_ms(nbytes, 0.0, "bfloat16")
            emit(phase="musicgen", model=cfg.name, fused=fused,
                 step="prefill_step, then serve_step eager vs graph",
                 frames=list(MG_FRAMES), max_len=MG_MAX_LEN,
                 prefill_logits_shape=list(logits.shape),
                 tokens_identical=runs[False]["tokens"] == runs[True]["tokens"],
                 first_tokens=[int(t) for t in logits.float().argmax(-1)],
                 tokens=runs[True]["tokens"],
                 eager_decode_tok_per_s=round(b * NEW_TOKENS / runs[False]["s"], 2),
                 graph_decode_tok_per_s=round(b * NEW_TOKENS / runs[True]["s"], 2),
                 replay_ms=round(replay, 4), bound_ms=round(b_ms, 4),
                 bound_by="bytes", step_bytes=nbytes, positions=last,
                 bound_frac=round(b_ms / replay, 4), launches=got, need=need)
            if runs[False]["tokens"] != runs[True]["tokens"]:
                fail(f"musicgen fused={fused}: the graph's codebook tokens "
                     "differ from the eager step's")
            if any(not 0 <= t < cfg.vocab_size for row in runs[True]["tokens"]
                   for t in row):
                fail(f"musicgen fused={fused}: a token outside the codebook")
            if got != need:
                fail(f"musicgen fused={fused}: launched {got}, the prefill and "
                     f"{2 * NEW_TOKENS} steps need {need}")
            for k, n in got.items():
                launches[k] += n
                own_launches[k] = own_launches.get(k, 0) + n
            del runs, graph, runner, run, caches, logits
            gc.collect()
        t2 = time.perf_counter()
        compare_paths(torch, nn, params, cfg, None, fused, MG_MAX_LEN,
                      frames=(frames, lengths, feeds[0]))
        walls[f"serve fused={fused}"] = round(t2 - t1, 2)
        walls[f"compare_paths fused={fused}"] = round(time.perf_counter() - t2, 2)
    if not paths_only:
        rng = np.random.default_rng(SEED)
        for seq, repeats in MG_PROFILE_SEQS:
            x = torch.randn((1, seq, d), generator=gen, device="cuda")
            mixer_split(torch, ops, params, cfg, rng, "musicgen", seq, repeats,
                        MG_SITES, inputs=x)
    emit(phase="musicgen", step="walls", walls_s=walls)
    del params, frames
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - mem0
    emit(phase="musicgen", step="freed", config=cfg.name, left_bytes=left)
    if left > 1 << 30:
        fail(f"musicgen: {left} bytes left after its weights were freed")


# ---------------------------------------------------------------------------
# phase traffic: the PagedEngine under trace-driven load
# ---------------------------------------------------------------------------

def traffic(torch, nn, ops, _build, init_lm, get_config, launched: dict):
    """Phase ``traffic`` (JAX's traffic section, ``repro/bench/sections.py``
    ``traffic_rows``, on the card): TRAFFIC_ARCH at full width,
    TRAFFIC_LAYERS deep, every drive
    primed first on its trace's shadow (kernels built, decode graph
    captured). (a) parity: a Poisson trace through the ``Engine`` and the
    cold ``PagedEngine``, identical tokens; (b) load: a Poisson trace at
    8 requests/s in real time, graph and eager, every request completed;
    (c) prefix: a shared-prefix trace with the prefix cache on and off, a
    hit and every block back, warm and cold service TTFT, equal outputs
    counted; (d) the measured GEMM / NonGEMM split of one eager paged
    decode step at (b)'s shapes and ``paged_frac``, the share of the paged
    bookkeeping's device time. Every drive: launches exact, counters zero,
    the engine's memory back."""
    from repro_torch.models import init_lm_cache
    from repro_torch.serving import Engine, PagedEngine, make_paged_decode_step
    from repro_torch.traffic import (drive, poisson_trace, prime,
                                     shared_prefix_trace)

    cfg = get_config(TRAFFIC_ARCH).replace(dtype="bfloat16",
                                           param_dtype="bfloat16",
                                           n_layers=TRAFFIC_LAYERS)
    params = init_lm(torch.Generator("cuda").manual_seed(SEED), cfg)
    vocab = cfg.vocab_size

    def run(name, make, trace, time_scale):
        mem0 = torch.cuda.memory_allocated()
        engine = make()
        t0 = time.perf_counter()
        prime(engine, trace, vocab)
        prime_s = time.perf_counter() - t0
        ops.reset_launches()
        done, rep = drive(engine, trace, time_scale=time_scale)
        torch.cuda.synchronize()
        launches = {k: v for k, v in ops.launches.items() if v}
        pc = getattr(engine, "prefix_cache", None)
        what = f"traffic: {name}"
        emit(phase="traffic", run=name, engine=type(engine).__name__,
             cuda_graph=engine.cuda_graph, requests=len(trace),
             time_scale=time_scale, prime_s=round(prime_s, 3),
             report=rep.to_dict(), decode_steps=engine.stats.decode_steps,
             cold_prefills=getattr(engine, "cold_prefills", None),
             extend_chunks=getattr(engine, "extend_chunks", None),
             cached_blocks=None if pc is None else len(pc), launches=launches)
        if rep.completed != len(trace) or any(
                len(r.output) != r.max_new_tokens for r in done):
            fail(f"{what}: {rep.completed} of {len(trace)} requests completed")
        need = engine_launches(cfg, engine)
        if launches != need:
            fail(f"{what}: launched {launches}, the run needs {need}")
        check_counters(torch, _build, what)
        if hasattr(engine, "allocator"):
            check_blocks(engine.allocator, pc, what)
        for k, n in launches.items():
            launched[k] += n
        del engine
        check_memory_back(torch, mem0, what)
        return {tuple(r.prompt): r.output for r in done}, rep

    def paged_engine(**kw):
        return lambda: PagedEngine(cfg, params, **{**TRAFFIC_ENGINE, **kw})

    # (a) parity: the contiguous engine and the cold paged path
    trace = poisson_trace(0, 12, 200.0, vocab, prompt_len=(16, 200),
                          output_len=(8, 32))
    want, _ = run("parity, Engine", lambda: Engine(
        cfg, params, max_batch=TRAFFIC_ENGINE["max_batch"],
        max_len=TRAFFIC_ENGINE["max_len"]), trace, 1e5)
    got, _ = run("parity, PagedEngine cold",
                 paged_engine(prefix_caching=False, chunk_size=None), trace, 1e5)
    same = sum(got.get(p) == o for p, o in want.items())
    emit(phase="traffic", check="parity", requests=len(trace),
         tokens_equal=f"{same} of {len(want)}")
    if got != want:
        fail(f"traffic: parity: {len(want) - same} requests' tokens differ "
             "between the Engine and the cold PagedEngine")

    # (b) load: real-time Poisson arrivals, the decode step graphed and eager
    load = poisson_trace(1, 16, 8.0, vocab, prompt_len=(16, 200),
                         output_len=(8, 32))
    for graph in (True, False):
        run(f"load, cuda_graph={graph}",
            paged_engine(chunk_size=TRAFFIC_CHUNK, cuda_graph=graph), load, 1.0)

    # (c) prefix: one 192-token system prompt, the cache on and off
    sp = shared_prefix_trace(7, 16, vocab, prefix_len=192, suffix_len=(16, 48),
                             gap_s=0.05, output_len=(8, 16))
    warm_out, warm = run("prefix, cache on",
                         paged_engine(chunk_size=TRAFFIC_CHUNK), sp, 1.0)
    cold_out, cold = run("prefix, cache off",
                         paged_engine(chunk_size=TRAFFIC_CHUNK,
                                      prefix_caching=False), sp, 1.0)
    emit(phase="traffic", check="prefix", hit_rate=warm.prefix_hit_rate,
         warm_service_ttft_s=warm.mean_service_ttft_s,
         cold_service_ttft_s=cold.mean_service_ttft_s,
         outputs_equal=f"{sum(cold_out.get(p) == o for p, o in warm_out.items())}"
                       f" of {len(warm_out)}")
    if not warm.prefix_hit_rate > 0:
        fail("traffic: prefix: no prefix-cache hit")

    # (d) the measured split of one paged decode step at the load's shapes:
    # the first four requests of (b) half way through their budgets
    b, max_len, bs = (TRAFFIC_ENGINE[k] for k in ("max_batch", "max_len",
                                                  "block_size"))
    per_seq = max_len // bs
    pools = init_lm_cache(cfg, 1 + b * per_seq, bs, device="cuda")
    tables = torch.arange(1, 1 + b * per_seq, dtype=torch.int32,
                          device="cuda").reshape(b, per_seq)
    positions = [len(r.prompt) + r.max_new_tokens // 2 for r in load[:b]]
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    token = torch.ones(b, dtype=torch.int64, device="cuda")
    step = make_paged_decode_step(cfg, max_len, greedy=True, fused=False)
    _, prof, wall, per = measured(
        ops, lambda: step(params, token, pos, pools, tables)[0], (),
        f"{TRAFFIC_ARCH} paged decode b{b} L{max_len}", False)
    paged_s = sum(t for (_, site), t in prof.op_seconds.items()
                  if site in PAGED_SITES)
    emit_profile("traffic", prof, wall, per, check="paged decode split",
                 positions=positions, paged_ms=round(paged_s * 1e3, 4),
                 paged_frac=round(paged_s / prof.total_seconds, 4),
                 paged_site_ms={site: round(sum(
                     t for (_, s), t in prof.op_seconds.items() if s == site)
                     * 1e3, 4) for site in PAGED_SITES})
    if not paged_s > 0:
        fail("traffic: the paged decode step measured no paged bookkeeping")


# ---------------------------------------------------------------------------
# phase 4: profile
# ---------------------------------------------------------------------------

def tp_phase(torch, launched: dict) -> None:
    """Phase ``tp`` (module docstring): one spawn of TP_RANKS ranks serves
    both jobs at every degree of TP_DEGREES; the checks and the readings
    here. Every rank's served launches join ``launched``."""
    from repro_torch.configs import get_config
    from repro_torch.core.hardware import H100
    from repro_torch.core.profiler import model_records
    from repro_torch.launch import sharded_serving as S

    full = get_config(TP_ARCH)
    f32 = full.replace(dtype="float32", param_dtype="float32",
                       n_layers=TP_F32_LAYERS)
    bf16 = full.replace(dtype="bfloat16", param_dtype="bfloat16")
    cold = S.prompts(f32, 6, 4, 20, seed=SEED)
    toks = np.zeros((4, 24), np.int64)
    for i, p in enumerate(cold[:4]):
        toks[i, :len(p)] = p
    rows = (toks, np.array([len(p) for p in cold[:4]], np.int32),
            np.array([p[0] for p in cold[:4]], np.int64))
    # a chunked prompt and, in a second wave, one sharing its first 16
    # tokens: a prefix hit
    base, hit = S.prefix_waves(f32)
    jobs = [S.Job(f32, SEED, TP_DEGREES,
                  (S.Run("cold", (cold,)),
                   S.Run("prefix", ((base[0],), (hit[0],)), 4,
                         (("chunk_size", TP_CHUNK),))),
                  engine=TP_ENGINE),
            # the logit rows served: their engine's decode step captured
            # and timed
            S.Job(bf16, SEED, TP_DEGREES, engine=TP_ENGINE, logits=rows,
                  anchor=True, capture=True, measure=True)]
    t0 = time.perf_counter()
    timeline = {}
    ranks = S.run_jobs(jobs, "cuda", world=TP_RANKS, timeout_s=TP_TIMEOUT_S,
                       timeline=timeline)
    wall = time.perf_counter() - t0
    r32, r16 = ranks[0]
    bad = []
    # (a) f32 tokens identical to the one-device engine's, a prefix hit on
    # both; bf16 logits under the anchored rule
    for tp in TP_DEGREES[1:]:
        for name in ("cold", "prefix"):
            got, want = r32[tp]["runs"][name], r32[1]["runs"][name]
            same = got["tokens"] == want["tokens"]
            emit(phase="tp", check="f32 tokens", run=name, tp=tp,
                 layers=f32.n_layers, identical=same, hits=got["hits"],
                 hits_one_device=want["hits"])
            if not same:
                bad.append(f"f32 {name} tokens at tp {tp} differ from the "
                           "one-device engine's")
            if name == "prefix" and not (got["hits"] and want["hits"]):
                bad.append(f"prefix wave at tp {tp}: no prefix-cache hit")
        for which in ("prefill", "decode"):
            check_anchored("tp", f"bf16 {which} logits", bad,
                           r16[tp]["logits"][which], r16[1]["logits"][which],
                           r16[1]["anchor"][which], tp=tp,
                           layers=bf16.n_layers)
    # (b) measured on the card, (c) modeled on the h100 spec
    step1 = None
    for tp in TP_DEGREES:
        for name, run in r32[tp]["runs"].items():
            emit(phase="tp", measured="eager engine", run=name, tp=tp,
                 dtype=f32.dtype, layers=f32.n_layers,
                 decode_tok_s=run["decode_tok_per_s"],
                 decode_steps=run["decode_steps"],
                 decode_s=run["decode_s"], prefill_s=run["prefill_s"],
                 label=TP_LABEL)
        prof = r16[tp]["split"]
        tot = prof.total_seconds or 1.0
        emit(phase="tp", measured="rank-0 decode step split", tp=tp,
             dtype=bf16.dtype, layers=bf16.n_layers,
             total_ms=prof.total_seconds * 1e3,
             collective_frac=prof.group_seconds.get("collective", 0.0) / tot,
             **prof.split, group_ms={g: t * 1e3 for g, t
                                     in sorted(prof.group_seconds.items())},
             label=TP_LABEL)
        recs = r16[tp]["records"]
        coll = [r for r in recs if r.group.value == "collective"]
        n_psum = sum(r.op_site == "psum" for r in coll)
        want_coll = (2 * bf16.n_layers, 1) if tp > 1 else (0, 0)
        if (n_psum, len(coll) - n_psum) != want_coll:
            bad.append(f"tp {tp}: {n_psum} psum and {len(coll) - n_psum} "
                       f"other collective records, want {want_coll}")
        m = model_records(recs, name=f"{TP_ARCH} decode tp{tp}", hw=H100,
                          launch_overhead_s=0.0, mode=f"modeled_tp{tp}")
        step1 = step1 or m.total_seconds
        emit(phase="tp", modeled="h100", tp=tp, dtype=bf16.dtype,
             layers=bf16.n_layers, launch_overhead_s=0.0,
             step_ms=m.total_seconds * 1e3,
             collective_frac=m.group_seconds.get("collective", 0.0)
             / (m.total_seconds or 1.0),
             eff=step1 / (tp * m.total_seconds),
             collective_bytes=sum(r.bytes_accessed for r in coll),
             records=len(recs))
    # (d) every rank's served launches: the one-device engine's, kernel by
    # kernel
    for tp in TP_DEGREES:
        for rank in range(tp):
            for j, job in enumerate(jobs):
                counts = {k: n for k, n in ranks[rank][j][tp]["launches"].items()
                          if n}
                emit(phase="tp", launches=counts, tp=tp, rank=rank,
                     dtype=job.cfg.dtype)
                want = {k: n for k, n in ranks[0][j][1]["launches"].items()
                        if n}
                if counts != want:
                    bad.append(f"tp {tp} rank {rank} {job.cfg.dtype}: "
                               f"launches {counts} differ from the one-device "
                               "engine's")
                missing = [k for k in TP_KERNELS if not counts.get(k)]
                if missing:
                    bad.append(f"tp {tp} rank {rank} {job.cfg.dtype}: "
                               f"{missing} never launched")
                for k, n in ranks[rank][j][tp]["launches"].items():
                    launched[k] += n
    emit(phase="tp", wall_s=round(wall, 2), ranks=TP_RANKS, **timeline,
         degrees=list(TP_DEGREES), label=TP_LABEL)
    if bad:
        fail("tp: " + "; ".join(bad))


def profile(torch, nn, ops, params, cfg, fused: bool, rng, seq: int = 16):
    """Measured split of one eager ``lm_forward`` (b1, ``seq`` tokens) on
    the kernel path, beside its un-instrumented wall time; checks one
    forward's launches against the path's table on the way."""
    from repro_torch.models import lm_forward

    ptoks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (1, seq))).cuda()
    name = f"{cfg.name} {'fused' if fused else 'unfused'} b-1 s-{seq} bf16"
    _, prof, wall_ms, per = measured(ops, lm_forward, (params, ptoks, cfg),
                                     name, fused)
    want = per_forward_launches(cfg, fused)
    if per != want:
        fail(f"profile: {name}: launched {per} per forward, expected {want}")
    emit_profile("profile", prof, wall_ms, per, layers=cfg.n_layers)


def qdq_share(prof) -> dict:
    """Device ms and share of the QDQ ops of a profile: the quantization
    group (quantize, dequantize) and, under fusion, the ``fused_qdq`` site,
    to which fusion moves the same launches."""
    fused_qdq = prof.op_seconds.get(("fused", "fused_qdq"), 0.0)
    quant = prof.group_seconds.get("quantization", 0.0)
    t = quant + fused_qdq
    return dict(qdq_ms=round(t * 1e3, 4),
                qdq_frac=round(t / prof.total_seconds, 4),
                quantization_group_frac=round(quant / prof.total_seconds, 4),
                fused_qdq_ms=round(fused_qdq * 1e3, 4))


def check_anchored(phase, what, bad, got, vs, anchor, **info):
    """The anchored logit rule (PERF.md §2): ``got`` may lie at most
    F32_ANCHOR times the reference path ``vs``'s distance from the
    f32-activation run ``anchor`` from ``vs``, LOGIT_ATOL at the least.
    Prints the reading; appends a failure to ``bad``."""
    diff, ref_vs_anchor = _max_diff(got, vs), _max_diff(vs, anchor)
    lim = max(LOGIT_ATOL, F32_ANCHOR * ref_vs_anchor)
    emit(phase=phase, check=what, max_abs_diff=diff,
         mean_abs_diff=float((got.float() - vs.float()).abs().mean()),
         kernel_vs_f32=_max_diff(got, anchor), against_vs_f32=ref_vs_anchor,
         atol=lim, max_abs_logit=float(vs.float().abs().max()),
         same_argmax=bool((got.argmax(-1) == vs.argmax(-1)).all()),
         finite=bool(got.float().isfinite().all()), **info)
    if not (math.isfinite(diff) and diff <= lim):
        bad.append(f"{what} {info}: {diff} (limit {lim})")


def qdq(torch, nn, ops, fwd, args32, args, per_forward, name, launches,
        kept: list, paths_only: bool = False):
    """Phase ``qdq`` for one model: ``fwd(*args)`` (``args32``: the same
    with f32 activations) under ``nn.fake_quant("int8")`` on the kernel
    path against the plain path, fused against unfused, under the anchored
    logit rule; then (not with ``paths_only``) the measured 2x2 of
    QDQ_VARIANTS through the profiling API (:func:`qdq_2x2`), whose
    (name, variant, profile, records, raw capture) go to ``kept``.
    ``per_forward(fused)``: the kernel launches of one forward, which QDQ
    does not change."""
    out = {}
    with nn.fake_quant("int8"):
        for backend, fused in (("cuda", False), ("torch", False),
                               ("cuda", True)):
            ops.reset_launches()
            with nn.backend(backend), nn.fuse(fused):
                out[backend, fused] = fwd(*args)
            torch.cuda.synchronize()
            got = {k: v for k, v in ops.launches.items() if v}
            want = per_forward(fused) if backend == "cuda" else {}
            if got != want:
                fail(f"qdq: {name} {backend} fused={fused} launched {got}, "
                     f"expected {want}")
            for k, n in got.items():
                launches[k] += n
        with nn.backend("torch"), nn.fuse(False):
            l32 = fwd(*args32)
    bad = []
    plain, unfused = out["torch", False], out["cuda", False]
    check_anchored("qdq", "int8-qdq kernel vs plain", bad, unfused, plain,
                   l32, model=name)
    check_anchored("qdq", "int8-qdq+fused vs int8-qdq", bad, out["cuda", True],
                   unfused, l32, model=name)
    if bad:
        fail(f"qdq: {name} logits past their limits: " + "; ".join(bad))
    if paths_only:
        return
    kept += [(name, *k) for k in qdq_2x2(ops, fwd, args, per_forward, name)]


def qdq_2x2(ops, fwd, args, per_forward, name) -> list:
    """The measured 2x2 of QDQ_VARIANTS through the profiling API
    (:func:`measured`: one ``Workload`` a variant over ``fwd(*args)`` on
    the card), then one capture of each variant priced on ``h100`` and
    ``a100`` (``model_records``, the ``eager-modeled`` view), the drift of
    the measured profile against each, and the fusion report of the
    capture. Returns [(variant, measured profile, the records the modeled
    views priced, the raw capture)] for the calibrated view after phase
    ``micro`` and the graph rules of phase ``nglint``."""
    from repro_torch.core import GPU_A100, H100, capture, fuse_records, model_records

    kept = []
    for label, mode, fused in QDQ_VARIANTS:
        w, prof, wall, per = measured(ops, fwd, args, f"{name} {label}", fused,
                                      mode)
        if w.variant != label or per != per_forward(fused):
            fail(f"qdq: {name} {w.variant} launched {per} per forward, "
                 f"expected {per_forward(fused)}")
        share = qdq_share(prof)
        emit_profile("qdq", prof, wall, per, variant=label, **share)
        if (share["qdq_ms"] > 0) != (mode is not None):
            fail(f"qdq: {name} {label}: QDQ time {share['qdq_ms']} ms")
        fn, fargs = w.build()
        raw = capture(fn, *fargs)
        records = raw
        for t in w.transforms:
            records = t.rewrite_records(records, w)
        for hw in (H100, GPU_A100):
            emit_modeled(f"eager-modeled:{hw.name}",
                         model_records(records, w.name, hw), prof, variant=label)
        report = fuse_records(raw)[1]
        emit(phase="qdq", model=w.name, variant=label,
             fusion_report=report.to_dict(), records_fused=report.records_fused)
        kept.append((label, prof, records, raw))
    return kept


def calibrated(kept, rows) -> None:
    """The ``calibrated:h100`` view of phase ``qdq``: ``h100`` fitted once
    from the Table-2 ``rows`` phase ``micro`` has just measured
    (``calibrate_from_microbench(rows=...)``, JAX's default ops), applied
    to the records each measured variant kept, beside its drift."""
    from repro_torch.core import H100, calibrate_from_microbench, model_records

    cal = calibrate_from_microbench(H100, rows=rows)
    emit(phase="qdq", calibration=cal.to_dict())
    for name, label, prof, records, _ in kept:
        emit_modeled("calibrated:h100",
                     model_records(records, prof.name, cal,
                                   mode=f"calibrated_{H100.name}"),
                     prof, variant=label)


def emit_modeled(view, modeled, measured, phase="qdq", **info):
    """One JSON line of a modeled profile of the records a measured one
    ran: its split and per-group ms, and the measured profile's drift
    against it (measured / modeled per group, the worst in doublings)."""
    from repro_torch.core import drift_by_group, max_abs_log2_drift

    split = modeled.split
    drift = drift_by_group(measured.group_seconds, modeled.group_seconds)
    emit(phase=phase, model=modeled.name, view=view, mode=modeled.mode,
         n_ops=modeled.n_ops, modeled_ms=round(modeled.total_seconds * 1e3, 4),
         measured_ms=round(measured.total_seconds * 1e3, 4),
         gemm_frac=round(split["gemm_frac"], 4),
         nongemm_frac=round(split["nongemm_frac"], 4),
         group_ms={g: round(t * 1e3, 4) for g, t in
                   sorted(modeled.group_seconds.items(), key=lambda kv: -kv[1])},
         drift_by_group={g: round(r, 4) for g, r in drift.items()},
         max_abs_log2_drift=round(max_abs_log2_drift(drift), 4), **info)
    if not (modeled.total_seconds > 0 and drift):
        fail(f"{phase}: {modeled.name} {view}: nothing modeled")


def emit_profile(phase, prof, wall_ms, per_forward, **info):
    """One JSON line of a measured profile beside its eager wall time."""
    split = prof.split
    emit(phase=phase, model=prof.name, mode=prof.mode, n_ops=prof.n_ops,
         launches_per_forward=per_forward,
         device_ms=round(prof.total_seconds * 1e3, 4),
         eager_wall_ms=round(wall_ms, 4),
         device_busy_frac=round(prof.total_seconds * 1e3 / wall_ms, 4),
         gemm_ms=round(split["gemm_s"] * 1e3, 4),
         nongemm_ms=round(split["nongemm_s"] * 1e3, 4),
         gemm_frac=round(split["gemm_frac"], 4),
         nongemm_frac=round(split["nongemm_frac"], 4),
         group_ms={g: round(t * 1e3, 4) for g, t in
                   sorted(prof.group_seconds.items(), key=lambda kv: -kv[1])},
         group_frac={g: round(t / prof.total_seconds, 4) for g, t in
                     sorted(prof.group_seconds.items(), key=lambda kv: -kv[1])},
         top_nongemm_groups=[[g, round(t * 1e3, 4), round(p, 2)]
                             for g, t, p in prof.top_nongemm_groups(5)],
         top_op_sites=[[f"{g}:{s}", round(t * 1e3, 4), round(p, 2)]
                       for (g, s), t, p in prof.top_op_sites(10)],
         top_site_ops=_top_site_ops(prof, 15), **info)
    if prof.mode != "measured_cuda" or not split["gemm_s"] > 0:
        fail(f"{phase}: {prof.name}: no device time measured")


def measured(ops, fn, args, name, fused, mode=None, repeats=3):
    """(workload, measured profile, median eager wall ms, launches per call)
    of ``fn(*args)`` on the kernel path, through the profiling API: a
    ``Workload`` over the call, with ``QuantizeDequantTransform(mode)``
    where ``mode`` is set and ``FusionTransform`` where ``fused``; its
    ``wallclock`` backend (one warm-up call, which warms cuBLAS, then the
    median of WALL_REPEATS; their launches give the launches per call),
    then its ``measured`` backend, each op timed ``1 + repeats`` times (the
    best kept)."""
    from repro_torch.core import (FusionTransform, QuantizeDequantTransform,
                                  Workload)

    w = Workload(name=name, arch=name.split()[0], dtype="bfloat16",
                 builder=lambda w, device: ((lambda _: fn(*args)), (), None))
    w = w.with_transform(*([QuantizeDequantTransform(mode)] if mode else []),
                         *([FusionTransform()] if fused else []))
    ops.reset_launches()
    wall = w.profile("wallclock", repeats=WALL_REPEATS)
    calls = WALL_REPEATS + 1
    if any(v % calls for v in ops.launches.values()):
        fail(f"{name}: {dict(ops.launches)} launches in {calls} calls")
    per = {k: v // calls for k, v in ops.launches.items() if v}
    return (w, w.profile("measured", repeats=repeats),
            wall.total_seconds * 1e3, per)


def _max_diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _set_distance(a, b) -> float:
    """Largest Hausdorff distance between the value sets of matching rows
    of ``a`` and ``b`` (B, K): how far a value of one row lies from the
    nearest value of the other."""
    d = (a.float()[:, :, None] - b.float()[:, None, :]).abs()
    return max(float(d.amin(2).amax()), float(d.amin(1).amax()))


def encoder_launches(cfg, fused: bool, extra_full: int = 0) -> dict:
    """Kernel launches of one encoder forward on the kernel path: the
    LayerNorm blocks' norms, ``attention_full`` per layer (and once more
    for the detector's refinement)."""
    per = per_forward_launches(cfg, fused)
    per["attention_full"] += extra_full
    return per


def encode(torch, nn, ops, init_lm, lm_forward, arch, cases, launches,
           paths_only: bool = False):
    """Phase ``encode``: an encoder at full width and depth in bf16, unfused
    and fused, through ``lm_forward`` at each (batch, seq) case; then (not
    with ``paths_only``) the measured profile of the first case."""
    from repro_torch.configs import get_config

    cfg = get_config(arch).replace(dtype="bfloat16", param_dtype="bfloat16")
    gen = torch.Generator("cuda").manual_seed(SEED)
    params = init_lm(gen, cfg)
    emit(phase="encode", step="init", config=cfg.name,
         n_params=sum(t.numel() for t in _leaves(params)))

    def inputs(b, s):
        if cfg.input_mode == "tokens":
            return torch.randint(1, cfg.vocab_size, (b, s), generator=gen,
                                 device="cuda")
        return torch.randn((b, s, cfg.d_model), generator=gen,
                           device="cuda").to(torch.bfloat16)

    bad = []
    for b, s in cases:
        x = inputs(b, s)
        out = {}
        for backend, fused in (("cuda", False), ("torch", False),
                               ("cuda", True), ("torch", True)):
            ops.reset_launches()
            with nn.backend(backend), nn.fuse(fused):
                out[backend, fused] = lm_forward(params, x, cfg)
            torch.cuda.synchronize()
            got = {k: v for k, v in ops.launches.items() if v}
            want = encoder_launches(cfg, fused) if backend == "cuda" else {}
            if got != want:
                fail(f"encode: {arch} b{b} s{s} {backend} fused={fused} "
                     f"launched {got}, expected {want}")
            if backend == "cuda":
                for k, n in got.items():
                    launches[k] += n
        for (got, vs), label in (((("cuda", False), ("torch", False)), "plain"),
                                 ((("cuda", True), ("torch", True)), "plain"),
                                 ((("cuda", True), ("cuda", False)), "unfused")):
            diff = _max_diff(out[got], out[vs])
            emit(phase="encode", model=arch, batch=b, seq=s, fused=got[1],
                 against=f"{label} ({vs[0]} fused={vs[1]})",
                 max_abs_diff=diff,
                 max_abs_logit=float(out[vs].float().abs().max()),
                 atol=ENCODE_ATOL, shape=list(out[got].shape),
                 finite=bool(torch.isfinite(out[got].float()).all()))
            if not (math.isfinite(diff) and diff <= ENCODE_ATOL):
                bad.append(f"{arch} b{b} s{s} {got} vs {vs}: {diff}")
    if bad:
        fail("encode: outputs past their limit: " + "; ".join(bad))
    if paths_only:
        return
    b, s = cases[0]
    x = inputs(b, s)
    for fused in (False, True):
        name = f"{arch} {'fused' if fused else 'unfused'} b-{b} s-{s} bf16"
        _, prof, wall, per = measured(ops, lm_forward, (params, x, cfg),
                                      name, fused)
        if per != encoder_launches(cfg, fused):
            fail(f"encode: {name}: launched {per} per forward")
        emit_profile("encode", prof, wall, per)


def vision(torch, nn, ops, arch, launches, paths_only: bool = False):
    """Phase ``vision``: the classifier or the detector at full width, its
    first VISION_LAYERS layers, in bf16, unfused and fused, through
    ``vision_forward`` (with ``paths_only``, only the comparisons of the
    paths). Returns the
    detector kernel path's first image: its score-sorted top-K boxes, their
    validity and the IoU threshold (phase 5 times the NMS kernel on them)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.models.vision import (init_vision, vision_backbone,
                                           vision_forward)

    cfg = get_config(arch).replace(dtype="bfloat16", param_dtype="bfloat16",
                                   n_layers=VISION_LAYERS)
    gen = torch.Generator("cuda").manual_seed(SEED)
    params = init_vision(gen, cfg)
    size = cfg.image_size
    emit(phase="vision", step="init", config=cfg.name,
         n_params=sum(t.numel() for t in _leaves(params)), image_size=size)
    imgs = torch.randn((VISION_BATCH, cfg.n_channels, size, size),
                       generator=gen, device="cuda")
    det = cfg.is_detector

    def per_forward(fused, b):
        per = encoder_launches(cfg, fused, extra_full=int(det))
        if det:
            per["nms"] = b
        return per

    bad, nms_inputs = [], None

    def check(what, diff, atol, **info):
        emit(phase="vision", model=arch, check=what, max_abs_diff=diff,
             atol=atol, **info)
        if not (math.isfinite(diff) and diff <= atol):
            bad.append(f"{arch} {what}: {diff}")

    for fused in (False, True):
        # throughput: batch 1 and batch 8 on the host clock
        rates = {}
        for b in () if paths_only else (1, VISION_BATCH):
            x = imgs[:b]
            with nn.fuse(fused):
                vision_forward(params, x, cfg)          # warm
                ops.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(VISION_FORWARDS):
                    vision_forward(params, x, cfg)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = {k: v for k, v in ops.launches.items() if v}
            want = {k: n * VISION_FORWARDS for k, n in per_forward(fused, b).items()}
            if got != want:
                fail(f"vision: {arch} b{b} fused={fused} launched {got}, "
                     f"expected {want}")
            for k, n in got.items():
                launches[k] += n
            rates[b] = dict(images_per_s=b * VISION_FORWARDS / wall,
                            ms_per_forward=wall / VISION_FORWARDS * 1e3)
        if rates:
            emit(phase="vision", model=arch, fused=fused, step="throughput",
                 forwards=VISION_FORWARDS,
                 **{f"b{b}": r for b, r in rates.items()})

        # the kernel path against the plain path (and the unfused one)
        x = imgs
        with nn.fuse(fused):
            kern = vision_forward(params, x, cfg)
            with nn.backend("torch"):
                plain = vision_forward(params, x, cfg)
        with nn.fuse(False):
            unfused = vision_forward(params, x, cfg)
        if not det:
            check("logits", _max_diff(kern, plain), ENCODE_ATOL, fused=fused,
                  against="plain", shape=list(kern.shape),
                  max_abs_logit=float(plain.float().abs().max()),
                  finite=bool(torch.isfinite(kern.float()).all()))
            if fused:
                check("logits", _max_diff(kern, unfused), ENCODE_ATOL,
                      fused=fused, against="unfused")
            continue
        with nn.fuse(fused):
            hk = vision_backbone(params, x, cfg)[0]
            with nn.backend("torch"):
                hp = vision_backbone(params, x, cfg)[0]
        check("backbone_features", _max_diff(hk, hp), ENCODE_ATOL,
              fused=fused, against="plain", shape=list(hk.shape),
              max_abs=float(hp.float().abs().max()))
        (boxes, scores, keep), (_, pscores, pkeep) = kern, plain
        # Near-tied bf16 scores may swap places between the paths, so the
        # boxes are not compared row by row across them. Nor are the sorted
        # scores place by place: two neighbouring cells whose scores tie in
        # bf16 both pass the 3x3 peak test in one path and one of them not
        # in the other, which shifts the sorted list by a place (a shift
        # at the last nonzero score reads ~0.9). The scores are held as
        # value sets, and NMS to the plain NMS on the kernel path's boxes.
        check("top_scores", _set_distance(scores, pscores), SCORE_ATOL,
              measure="value-set distance", fused=fused, against="plain",
              shape=list(scores.shape),
              sorted_max_abs_diff=_max_diff(scores, pscores),
              nonzero=(scores > 0).sum(-1).tolist(),
              plain_nonzero=(pscores > 0).sum(-1).tolist(),
              kept=int(keep.sum()), plain_kept=int(pkeep.sum()),
              finite=bool(torch.isfinite(boxes.float()).all()))
        if fused:
            check("top_scores", _set_distance(scores, unfused[1]),
                  SCORE_ATOL, measure="value-set distance", fused=fused,
                  against="unfused",
                  sorted_max_abs_diff=_max_diff(scores, unfused[1]))
        for i in range(x.shape[0]):
            want = ref.nms(boxes[i].float(), scores[i], cfg.det_iou_threshold,
                           cfg.det_score_threshold)
            if not torch.equal(keep[i], want):
                fail(f"vision: {arch} image {i}: the NMS kernel's keep mask "
                     "differs from the plain NMS on the same boxes")
        emit(phase="vision", model=arch, fused=fused, check="nms_keep",
             images=x.shape[0], identical=True,
             kept_per_image=keep.sum(-1).tolist())
        if nms_inputs is None:
            order = ref.nms_order(scores[0])
            nms_inputs = (boxes[0].float()[order].contiguous(),
                          scores[0][order] > cfg.det_score_threshold,
                          cfg.det_iou_threshold)
    if bad:
        fail("vision: outputs past their limit: " + "; ".join(bad))

    for fused in () if paths_only else (False, True):
        name = f"{arch} {'fused' if fused else 'unfused'} b-1 {size}px bf16"
        _, prof, wall, per = measured(ops, vision_forward,
                                      (params, imgs[:1], cfg), name, fused)
        if per != per_forward(fused, 1):
            fail(f"vision: {name}: launched {per} per forward")
        g = prof.group_seconds
        pool_other = sorted({t.record.prim for t in prof.timed_ops
                             if t.record.group.value == "other"})
        emit_profile("vision", prof, wall, per, other_ops=pool_other)
        if any("pool" in p for p in pool_other):
            fail(f"vision: {name}: pooling classed OTHER: {pool_other}")
        need = ("roi", "interpolation", "reduction") if det else ("reduction",)
        if not all(g.get(k, 0) > 0 for k in need):
            fail(f"vision: {name}: no device time in {need}: {g}")
    return nms_inputs


def qdq_vision(torch, nn, ops, launches, kept: list,
               paths_only: bool = False):
    """Phase ``qdq`` for vit-b16-cls at b1 (224 px): the patch ``conv2d``
    and every ``linear`` under ``nn.fake_quant("int8")``, as for the
    served models."""
    from repro_torch.configs import get_config
    from repro_torch.models.vision import init_vision, vision_forward

    cfg = get_config("vit-b16-cls").replace(dtype="bfloat16",
                                            param_dtype="bfloat16",
                                            n_layers=VISION_LAYERS)
    gen = torch.Generator("cuda").manual_seed(SEED)
    params = init_vision(gen, cfg)
    imgs = torch.randn((1, cfg.n_channels, cfg.image_size, cfg.image_size),
                       generator=gen, device="cuda")
    qdq(torch, nn, ops, vision_forward,
        (params, imgs, cfg.replace(dtype="float32")), (params, imgs, cfg),
        lambda fused: encoder_launches(cfg, fused),
        f"vit-b16-cls b-1 {cfg.image_size}px bf16", launches, kept, paths_only)


# ---------------------------------------------------------------------------
# phase nglint: repro_torch.analysis on the card
# ---------------------------------------------------------------------------

def nglint(nn, kept: list) -> None:
    """Phase ``nglint``: (a) the rules NG001–NG010 over the reduced zoo,
    each capture on the card, gated against the committed baseline
    (``repro_torch/analysis/analysis_baseline.json``): a new finding fails;
    (b) the graph rules over the full-width bf16 captures phase ``qdq``
    kept for QDQ_ARCHS (raw and rewritten, captured once there): an
    ``error`` finding fails, warnings are printed by rule and site; (c)
    NGLINT_CPU_CELL's card capture against the CPU's under
    ``nn.backend("cuda")``, NGLINT_FIELDS record by record: printed."""
    from collections import Counter

    from repro_torch.analysis import (AnalysisContext, analyze, build_context,
                                      gate_findings, load_baseline, run_rules)
    from repro_torch.analysis.baseline import DEFAULT_BASELINE
    from repro_torch.analysis.cli import zoo_ids
    from repro_torch.core import Workload

    t0 = time.perf_counter()
    baseline = load_baseline(DEFAULT_BASELINE)
    ids = list(NGLINT_IDS or zoo_ids())
    ctxs, findings = analyze(ids, baseline=baseline, device="cuda")
    new = gate_findings(findings, baseline)
    emit(phase="nglint", part="zoo", ids=len(ids), cells=len(ctxs),
         findings=len(findings),
         by_rule=dict(Counter(f.rule for f in findings)),
         accepted=len(findings) - len(new),
         new_findings=[f.to_dict() for f in new],
         records=sum(len(c.records) for c in ctxs),
         wall_s=round(time.perf_counter() - t0, 3))
    if new:
        fail(f"nglint: {len(new)} new finding(s) against {DEFAULT_BASELINE}: "
             + "; ".join(f"{f.rule} {f.workload} {f.where}" for f in new))

    t0 = time.perf_counter()
    errors = []
    for name, label, _, records, raw in kept:
        arch = name.split()[0]
        if arch not in QDQ_ARCHS:
            continue
        ctx = AnalysisContext(workload=Workload(name=name, arch=arch,
                                                dtype="bfloat16"),
                              variant=label, records=raw, rewritten=records,
                              fused=label.endswith("fused"))
        fs = run_rules(ctx)
        errors += [f for f in fs if f.severity == "error"]
        emit(phase="nglint", part="full_width", model=name, variant=label,
             records=len(raw), rewritten=len(records),
             by_rule=dict(Counter(f.rule for f in fs)),
             warnings=sorted(Counter(f"{f.rule} {f.where}" for f in fs
                                     if f.severity != "error").items()),
             errors=[f.to_dict() for f in fs if f.severity == "error"])
    emit(phase="nglint", part="full_width", captures=sum(
        1 for k in kept if k[0].split()[0] in QDQ_ARCHS),
        wall_s=round(time.perf_counter() - t0, 3))
    if errors:
        fail(f"nglint: {len(errors)} error finding(s) on the full-width "
             "captures: " + "; ".join(f"{f.rule} {f.workload} {f.where}"
                                      for f in errors))

    t0 = time.perf_counter()
    arch, variant = NGLINT_CPU_CELL
    card = next(c for c in ctxs if c.key == f"{arch}/{variant}")
    with nn.backend("cuda"):
        cpu = build_context(arch, variant, device="cpu")

    def row(r):
        return tuple(getattr(r, f) for f in NGLINT_FIELDS)
    differ = [(i, row(a), row(b)) for i, (a, b) in
              enumerate(zip(card.records, cpu.records)) if row(a) != row(b)]
    shares = {g: card.group_shares.get(g, 0.0) - cpu.group_shares.get(g, 0.0)
              for g in set(card.group_shares) | set(cpu.group_shares)}
    emit(phase="nglint", part="card_vs_cpu", cell=card.key,
         fields=list(NGLINT_FIELDS), card_records=len(card.records),
         cpu_records=len(cpu.records), records_differ=len(differ),
         agree=not differ and len(card.records) == len(cpu.records),
         first_differences=[[i, str(a), str(b)] for i, a, b in differ[:5]],
         max_abs_share_diff=max((abs(d) for d in shares.values()),
                                default=0.0),
         wall_s=round(time.perf_counter() - t0, 3))


# ---------------------------------------------------------------------------
# phase bench: python -m repro_torch.bench run --quick
# ---------------------------------------------------------------------------

def bench(launched: dict) -> float:
    """Phase ``bench``: the quick tier of the bench CLI in a process of its
    own, as a user runs it: rc 0, the artifact validates, every section
    ``ok`` but the two BENCH_SKIPS (skipped, with their reasons), every
    kernel site allclose, the traffic parity rows true, the breakdown's
    measured rows the card's own device times and its compiled rows
    (:func:`compiled_rows`), the harvested micro rows
    those of BENCH_HARVESTED; the sections' status and
    wall, and the breakdown and top-table rows printed. The process's
    kernel launches (its last line) are added to ``launched``; each of
    BENCH_KERNELS must have launched. Returns the phase's wall seconds."""
    from repro_torch.bench.schema import BenchResult

    out = REPO / BENCH_OUT
    out.unlink(missing_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench", "run", "--quick",
         "--out", str(out)], cwd=REPO, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
        timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"bench: rc {proc.returncode}\n{proc.stdout[-4000:]}\n"
             f"{proc.stderr[-4000:]}")
    art = BenchResult.load(str(out))        # validates
    for s in art.sections:
        emit(phase="bench", section=s.name, status=s.status,
             wall_s=round(s.wall_s, 3), rows=len(s.rows),
             **({"reason": s.error} if s.status == "skipped" else {}))
    not_ok = {s.name: (s.status, s.error or "") for s in art.sections
              if s.status != "ok"}
    if set(not_ok) != set(BENCH_SKIPS) or any(
            status != "skipped" or BENCH_SKIPS[name] not in error
            for name, (status, error) in not_ok.items()):
        fail(f"bench: sections not ok: {not_ok}")
    for name in ("breakdown", "top_table"):
        for r in art.section(name).rows:
            emit(phase="bench", section=name, case=r["case"], mode=r["mode"],
                 total_ms=round(r["total_s"] * 1e3, 4),
                 gemm_pct=round(100 * r["gemm_frac"], 2),
                 nongemm_pct=round(100 * r["nongemm_frac"], 2),
                 **({"top_group": r["top_group"],
                     "top_pct": round(r["top_pct"], 2)}
                    if "top_group" in r else {}))
    measured = [r for r in art.section("breakdown").rows
                if r["mode"].startswith("measured")]
    if len(measured) != len(art.cases) or \
            {r["mode"] for r in measured} != {"measured_cuda"}:
        fail(f"bench: the breakdown's measured rows are not the card's: "
             f"{[(r['case'], r['mode']) for r in measured]}")
    compiled_rows(art, {r["case"]: r for r in measured})
    harvested = [(r["operator"], r["shape"], r["device"])
                 for r in art.section("micro_harvested").rows]
    if harvested != BENCH_HARVESTED:
        fail(f"bench: micro_harvested gave {harvested}, the llama2-7b "
             f"capture's sites give {BENCH_HARVESTED}")
    sites = art.section("kernels").rows
    if not sites or not all(r["allclose"] for r in sites):
        fail(f"bench: a kernel site disagrees with its plain version: {sites}")
    for r in art.section("serving_sharded").rows:
        emit(phase="bench", section="serving_sharded", label=TP_LABEL,
             **{k: r[k] for k in ("tp", "decode_tok_per_s", "modeled_step_s",
                                  "modeled_eff", "collective_frac",
                                  "parity_ok")})
    traffic = {r["phase"]: r for r in art.section("traffic").rows}
    if not (traffic["parity"]["parity_ok"] and traffic["prefix"]["parity_ok"]):
        fail(f"bench: traffic parity: {traffic['parity']}, {traffic['prefix']}")
    tail = proc.stdout.strip().splitlines()[-1]
    if not tail.startswith("kernel launches "):
        fail(f"bench: no launch counts at the end of its output: {tail!r}")
    counts = json.loads(tail[len("kernel launches "):])
    if counts != art.meta["kernel_launches"]:
        fail(f"bench: printed launches {counts} differ from the artifact's "
             f"{art.meta['kernel_launches']}")
    emit(phase="bench", wall_s=round(wall, 2), artifact=BENCH_OUT,
         device_name=art.meta["device_name"],
         power_limit_w=art.meta["power_limit_w"],
         total_section_s=round(art.meta["total_wall_s"], 2),
         launches={k: n for k, n in counts.items() if n})
    missing = [k for k in BENCH_KERNELS if not counts.get(k)]
    if missing:
        fail(f"bench: kernels the quick tier never launched: {missing}")
    for k, n in counts.items():
        launched[k] += n
    return wall


def compiled_rows(art, measured: dict) -> None:
    """The breakdown's compiled view: one ``compiled_cuda`` row per quick
    case (its output passed the guard in the bench, or the section would
    have failed), printed beside the case's ``measured_cuda`` row with its
    busy share, compile seconds, kernels left ``OTHER`` and the
    hand-written kernels it launched from inside the compiled program, which
    must hold BENCH_COMPILED_KERNELS of its arch."""
    rows = [r for r in art.section("breakdown").rows
            if r["mode"].startswith("compiled")]
    if sorted((r["case"], r["mode"]) for r in rows) != sorted(
            (c.alias, "compiled_cuda") for c in art.cases):
        fail(f"bench: the breakdown's compiled rows: "
             f"{[(r['case'], r['mode']) for r in rows]}")
    by_case = {r["case"]: r for r in rows}
    for case in art.cases:
        r, m = by_case[case.alias], measured[case.alias]
        kernels = {k.split("::", 1)[1]: n for k, n in r["launches"].items()
                   if k.startswith("repro_torch::")}
        emit(phase="bench", view="compiled beside measured", case=case.alias,
             measured_ms=round(m["total_s"] * 1e3, 4),
             measured_gemm_pct=round(100 * m["gemm_frac"], 2),
             measured_nongemm_pct=round(100 * m["nongemm_frac"], 2),
             compiled_ms=round(r["total_s"] * 1e3, 4),
             compiled_gemm_pct=round(100 * r["gemm_frac"], 2),
             compiled_nongemm_pct=round(100 * r["nongemm_frac"], 2),
             compiled_wall_ms=round(r["wall_s"] * 1e3, 4),
             compiled_busy_pct=round(100 * r["busy_frac"], 2),
             compile_s=round(r["compile_s"], 2), kernels_launched=r["n_ops"],
             other_kernels=len(r["other_kernels"]),
             other=r["other_kernels"], hand_written=kernels,
             guard=r["guard"])
        missing = [k for k in BENCH_COMPILED_KERNELS[case.arch]
                   if not kernels.get(k)]
        if missing:
            fail(f"bench: {case.alias}'s compiled forward launched none of "
                 f"{missing}: {r['launches']}")


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths-only", action="store_true",
                    help="phase 1, then only the model-level comparisons of "
                         "the kernel paths with the plain and unfused paths; "
                         "prints their readings and no result line")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2

    from repro_torch import nn
    from repro_torch.configs import get_config
    from repro_torch.core import graph
    from repro_torch.core.hardware import H100
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.models import init_lm, lm_forward
    from repro_torch.serving import Engine, PagedEngine

    t_start = time.perf_counter()
    walls = {}          # phase -> wall seconds, in the done line
    t_mark = [t_start]

    def lap(name):
        now = time.perf_counter()
        walls[name] = round(walls.get(name, 0.0) + now - t_mark[0], 2)
        t_mark[0] = now
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1: device ---------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[torch.cuda.current_device()]
    print(smi, flush=True)
    t0 = time.perf_counter()
    logs = _build.build()
    props = torch.cuda.get_device_properties(0)
    emit(phase="device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         built=sorted(logs), build_s=round(time.perf_counter() - t0, 3))
    # the spec the modeled views price on, beside what the card reports
    emit(phase="device", spec=dataclasses.asdict(H100), card=dict(
        nvidia_smi=smi, total_memory=props.total_memory,
        sms=props.multi_processor_count))

    # phase tp's ranks fork from a server whose imports run now, beside
    # the phases before it
    from repro_torch.launch.mesh import start_rank_server
    start_rank_server()

    lap("device")
    # -- phase 2: kernels --------------------------------------------------
    gen = torch.Generator("cuda").manual_seed(SEED)
    if not args.paths_only:
        (worst, worst_mla, worst_rg, worst_xl, worst_sc,
         worst_mg) = check_kernels(torch, ops, ref, gen)

    lap("kernels")
    launches = dict.fromkeys(SOURCES, 0)
    # -- phase train: granite-3-8b trained at full width, 2 layers --------
    if not args.paths_only:
        for k, n in _script("train_check").train_phase(torch, emit,
                                                       fail).items():
            launches[k] += n
    lap("train")
    decode_lengths = {}
    # -- phase moe: qwen2-moe-a2.7b and deepseek-v2-lite-16b, full size -----
    moe(torch, nn, ops, _build, Engine, PagedEngine, init_lm, get_config,
        launches, decode_lengths, args.paths_only)

    lap("moe")
    # -- phase recurrent: recurrentgemma-2b, full size -----------------------
    rg_launches = {}
    stateful(torch, nn, ops, _build, Engine, PagedEngine, init_lm, get_config,
             "recurrent", RG_ARCH, RG_LAYERS, RG_MAX_LEN, RG_PROMPTS,
             RG_PROFILE_SEQS,
             RG_SITES, launches, rg_launches, args.paths_only)

    lap("recurrent")
    # -- phase xlstm: xlstm-350m, full size ----------------------------------
    xl_launches = {}
    stateful(torch, nn, ops, _build, Engine, PagedEngine, init_lm, get_config,
             "xlstm", XL_ARCH, XL_LAYERS, XL_MAX_LEN, XL_PROMPTS,
             XL_PROFILE_SEQS,
             XL_SITES, launches, xl_launches, args.paths_only)

    lap("xlstm")
    # -- phase musicgen: musicgen-large, full size, on frames ----------------
    mg_launches = {}
    musicgen_phase(torch, nn, ops, _build, init_lm, get_config, launches,
                   mg_launches, args.paths_only)

    lap("musicgen")
    sc_launches = {}
    # -- phases 3 and 4, one model at a time -------------------------------
    qdq_kept = []   # (model, variant, measured profile, records, raw capture)
    nms_inputs = None
    for arch in ARCHS:
        cfg = get_config(arch)
        cfg = cfg.replace(dtype="bfloat16", param_dtype="bfloat16",
                          n_layers=SERVE_LAYERS.get(arch, cfg.n_layers))
        t0 = time.perf_counter()
        params = init_lm(torch.Generator("cuda").manual_seed(SEED), cfg)
        torch.cuda.synchronize()
        emit(phase="serve", step="init", config=cfg.name,
             n_params=sum(t.numel() for t in _leaves(params)),
             init_s=round(time.perf_counter() - t0, 3),
             mem_gb=round(torch.cuda.memory_allocated() / 1e9, 3))
        rng = np.random.default_rng(SEED)
        max_len, plens = SERVE[arch]
        plens = plens or [int(n) for n in rng.integers(5, 201, 6)]
        prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
                   for n in plens]
        extend_prompt = chunked_set = None
        if arch in PAGED_ARCHS:        # drawn apart: rng's later draws stay
            prng = np.random.default_rng(SEED + 1)
            extend_prompt = [int(t) for t in prng.integers(
                1, cfg.vocab_size, EXTEND_PROMPT)]
            chunked_set = paged_prompts(prng, cfg)
        for fused in (False, True):
            if not args.paths_only:
                # the eager decode step, then the graph, tokens identical
                eager = serve(torch, ops, _build, Engine, params, cfg, prompts,
                              fused, max_len, "engine", cuda_graph=False,
                              repeats=REPEATS)
                graphed = serve(torch, ops, _build, Engine, params, cfg,
                                prompts, fused, max_len, "engine",
                                same_as=eager["tokens"], repeats=REPEATS)
                emit_graph_vs_eager("serve", cfg, fused, "engine", graphed,
                                    eager)
                runs = [eager, graphed]
                if arch in PAGED_ARCHS:
                    # phase paged: (a) cold, tokens equal to the Engine's;
                    # (b) chunked prefill and prefix-cache hits, beside the
                    # Engine's tokens for the same prompts; each eager,
                    # then graphed with the eager run's tokens
                    cold = dict(want=graphed["tokens"], exact=True,
                                block_size=BLOCK_SIZE, prefix_caching=False,
                                chunk_size=None)
                    p_eager = serve(torch, ops, _build, PagedEngine, params,
                                    cfg, prompts, fused, max_len, "cold",
                                    cuda_graph=False, repeats=REPEATS, **cold)
                    p_graph = serve(torch, ops, _build, PagedEngine, params,
                                    cfg, prompts, fused, max_len, "cold",
                                    same_as=p_eager["tokens"],
                                    repeats=REPEATS, **cold)
                    emit_graph_vs_eager(
                        "paged", cfg, fused, "cold", p_graph, p_eager,
                        paged_over_engine_tok_s=round(
                            statistics.median(p_graph["tok_s"])
                            / statistics.median(graphed["tok_s"]), 3),
                        engine_over_paged_replay=round(
                            graphed["replay"]["replay_ms"]
                            / p_graph["replay"]["replay_ms"], 3))
                    more = serve(torch, ops, _build, Engine, params, cfg,
                                 chunked_set, fused, max_len,
                                 "engine, the chunked run's prompts")
                    chunked = dict(want=more["tokens"], block_size=BLOCK_SIZE,
                                   prefix_caching=True, chunk_size=CHUNK)
                    c_eager = serve(torch, ops, _build, PagedEngine, params,
                                    cfg, chunked_set, fused, max_len,
                                    "chunked+cached", cuda_graph=False,
                                    **chunked)
                    runs += [p_eager, p_graph, more, c_eager,
                             serve(torch, ops, _build, PagedEngine, params,
                                   cfg, chunked_set, fused, max_len,
                                   "chunked+cached",
                                   same_as=c_eager["tokens"], **chunked)]
                for run in runs:
                    for k, n in run["launches"].items():
                        launches[k] += n
            compare_paths(torch, nn, params, cfg, prompts[:4], fused, max_len,
                          extend_prompt)
        lap(f"{arch} serve")
        if arch == SC_ARCH:
            # -- phase softcap: its first layers with Gemma 2's caps -------
            softcap_phase(torch, nn, ops, _build, Engine, params, cfg,
                          prompts, max_len, launches, sc_launches,
                          args.paths_only)
            lap("softcap")
        if not args.paths_only:
            pcfg = cfg.replace(n_layers=PROFILE_LAYERS.get(arch, cfg.n_layers))
            for seq, fused in PROFILES.get(arch, ((16, False), (16, True))):
                profile(torch, nn, ops, params, pcfg, fused, rng, seq)
        lap(f"{arch} profile")
        if arch in QDQ_ARCHS:
            toks = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                                 (1, 16))).cuda()
            qcfg = cfg.replace(n_layers=QDQ_LAYERS)     # the first layers
            qdq(torch, nn, ops, lm_forward,
                (params, toks, qcfg.replace(dtype="float32")),
                (params, toks, qcfg),
                lambda fused, c=qcfg: per_forward_launches(c, fused),
                f"{arch} b-1 s-16 bf16 {QDQ_LAYERS} layers", launches,
                qdq_kept, args.paths_only)
            lap(f"{arch} qdq")
        # the last step of the 4 slots serving the first 4 requests, cut off
        # at their 16th token
        decode_lengths[arch] = [n + NEW_TOKENS - 1 for n in plens[:4]]
        del params
        gc.collect()
        torch.cuda.empty_cache()
        lap(f"{arch} free")

    # -- phase traffic: the PagedEngine under trace-driven load --------------
    if not args.paths_only:
        traffic(torch, nn, ops, _build, init_lm, get_config, launches)
        gc.collect()
        torch.cuda.empty_cache()

    lap("traffic")
    # -- phase tp: tensor-parallel serving over spawned ranks ---------------
    if not args.paths_only:
        tp_phase(torch, launches)

    lap("tp")
    # -- phase encode: bert-base and the vit-b16 stub -----------------------
    for arch, cases in ENCODERS:
        encode(torch, nn, ops, init_lm, lm_forward, arch, cases, launches,
               args.paths_only)
        gc.collect()
        torch.cuda.empty_cache()

    lap("encode")
    # -- phase vision: vit-b16-cls and detector-vit-s -----------------------
    for arch in VISION:
        nms_inputs = vision(torch, nn, ops, arch, launches,
                            args.paths_only) or nms_inputs
    qdq_vision(torch, nn, ops, launches, qdq_kept, args.paths_only)
    if args.paths_only:
        return 0

    lap("vision")
    # -- phase nglint: the port's nglint on the card -------------------------
    nglint(nn, qdq_kept)
    gc.collect()
    torch.cuda.empty_cache()

    lap("nglint")
    # -- phase micro: the Table-2 suite, f32 ----------------------------------
    from repro_torch.core.microbench import run_suite
    ops.reset_launches()
    rows = run_suite(repeats=20)
    for r in rows:
        emit(phase="micro", **dataclasses.asdict(r))
        if not (r.device == "cuda" and r.device_us > 0 and r.eager_us > 0):
            fail(f"micro: {r.name}: no device time measured ({r})")
    for k, n in ops.launches.items():
        launches[k] += n
    calibrated(qdq_kept, rows)

    lap("micro")
    # -- phase kernel_sites: the §4.5 table -----------------------------------
    from repro_torch.bench.sections import section_kernels
    ops.reset_launches()
    sites = section_kernels("cuda")
    for row in sites:
        emit(phase="kernel_sites", **row)
    for k, n in ops.launches.items():
        launches[k] += n
    if len(sites) != 6 or not all(r["allclose"] for r in sites):
        fail(f"kernel_sites: a kernel disagrees with its plain version: {sites}")

    lap("kernel_sites")
    # -- phase bench: the quick tier of the bench CLI ---------------------
    gc.collect()
    torch.cuda.empty_cache()
    bench_s = bench(launches)
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        fail(f"kernels never launched on the main paths: {missing}")

    lap("bench")
    # -- phase 5: timing ---------------------------------------------------
    timing = time_kernels(torch, ops, ref, gen, decode_lengths, graph,
                          nms_inputs)

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        tm = timing[name]
        b_ms, b_by = tm["bound"]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": worst[name], "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": tm["library_ms"], "eager_ms": tm["eager_ms"],
            "shape": tm["shape"], **{k: tm[k] for k in ("body", "plan", "mul_ms",
                                                         "amax_ms", "no_lse_ms",
                                                         "library")
                                     if k in tm}})
        for key, errs in (("mla", worst_mla), ("recurrentgemma", worst_rg),
                          ("xlstm", worst_xl), ("softcap", worst_sc),
                          ("musicgen", worst_mg)):
            if key in tm:       # MLA's, recurrentgemma-2b's, xlstm-350m's,
                m = tm[key]     # the capped and musicgen-large's shapes
                kernels[-1][key] = {
                    "shape": m["shape"], "ms": m["ms"], "plain_ms": m["plain_ms"],
                    "library_ms": m["library_ms"], "eager_ms": m["eager_ms"],
                    "bound_ms": m["bound"][0], "bound_by": m["bound"][1],
                    "max_abs_err": errs[name],
                    **{k: m[k] for k in ("body", "plan", "mul_ms",
                                         "uncapped_ms", "sdpa_uncapped_ms",
                                         "library_max_abs_err")
                       if k in m}}
        for key, counts in (("recurrentgemma", rg_launches),
                            ("xlstm", xl_launches), ("softcap", sc_launches),
                            ("musicgen", mg_launches)):
            if key in tm:
                kernels[-1][key]["launches"] = counts.get(name, 0)
    lap("timing")
    emit(phase="done", seconds=round(time.perf_counter() - t_start, 2),
         bench_s=round(bench_s, 2), phase_s=walls)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _top_site_ops(prof, k: int) -> list:
    """[site:op, ms, calls] of the costliest (op site, aten op) pairs."""
    ms, calls = {}, {}
    for t in prof.timed_ops:
        key = f"{t.record.op_site}:{t.record.prim}"
        ms[key] = ms.get(key, 0.0) + t.seconds * 1e3
        calls[key] = calls.get(key, 0) + 1
    top = sorted(ms, key=ms.get, reverse=True)[:k]
    return [[key, round(ms[key], 4), calls[key]] for key in top]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
