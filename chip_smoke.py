#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

Drives the port's main paths on the card at full width:

* the simulator path, one Dragonfly phase: the default Aries machine
  (``TopologyParams(n_groups=12)``: 4,608 nodes, 56,448 directed
  links), a 120,000-flow Pareto-sized phase (the size
  ``benchmarks/perf_sim.py`` uses, and ``SimParams.max_flows``), a
  64-rank inter-group allocation, ``ADAPTIVE_0`` and 4 feedback
  iterations;
* the serving path: mamba2-130m at its published width (24 layers,
  d_model 768, vocab 50,280; random weights from a seed) behind the
  port's ``ServeEngine``, 8 requests of 512-token prompts and 32 new
  tokens each, greedy;
* the dense serving path: qwen2-1.5b at its published width (28 layers,
  d_model 1536, 12 heads over 2 KV heads of 128, d_ff 8960, vocab
  151,936; random weights from a seed), the same requests;
* the paper's §5 protocol with Algorithm 1: fig8's Piz-Daint
  configuration (``repro_torch.benchmarks.fig8_microbench.run``: the
  same machine, 1,024 ranks over 6 groups, ``max_flows`` 60,000, planned
  phases), ADAPTIVE, HIGH BIAS and application-aware routing alternating
  for 8 iterations, on its ``allreduce`` 262,144-element row (10 phases
  of 1,024 flows) and its ``alltoall`` 65,536-byte row (1,047,552 flows
  cut to 60,000);
* the MoE serving path: granite-moe-3b-a800m at its published width
  (32 layers, d_model 1536, 24 heads over 8 KV heads of 64, 40 experts
  top-8 with d_ff 512, vocab 49,155; random weights from a seed) behind
  ``ServeEngine(..., ServeConfig(comm_policy="app_aware"))``, the same
  requests, its KV transfer routed by Algorithm 1;
* the multi-tenant simulator: the interference matrix's first column
  (``repro_torch.benchmarks.interference_matrix``: ``halo3d-vs-alltoall``
  at its published 64 and 96 ranks, the victim arms adaptive, minimal
  and app_aware, ``SimParams(seed=7, bg_enable=False)``) on the same
  Aries machine, in lockstep through ``repro_torch.tenancy.sweep`` (one
  batched dispatch of the 3 cells' phases per round, B1 over 3 x 56,448
  segments), and the published interference matrix (8 rounds, its
  384-node machine and the Dragonfly+ row);
* the hybrid serving path: zamba2-7b at its published width and depth
  (81 Mamba2 layers, d_model 3584, N = 64; the shared attention block,
  32 heads of 112, applied 12 times; vocab 32,000; random weights from a
  seed), the same requests: B2, B3 and B4 in one forward;
* the enc-dec serving path: whisper-large-v3 at its published width and
  depth (32 encoder and 32 decoder layers, d_model 1280, 20 heads of 64,
  1504 frames; random weights from a seed), 8 requests of 1504 stub
  frames and a 128-token decoder prompt each, 32 new tokens;
* the VLM serving path: paligemma-3b at its published width and depth
  (18 layers, d_model 2048, 8 heads over one KV head of 256, GeGLU d_ff
  16384, tied vocab 257,216; random weights from a seed), 8 requests of
  256 stub patch embeddings and a 512-token prompt each, 32 new tokens:
  B2 at head dim 256 in its prefix-LM mode;
* the training path: qwen2-1.5b at its published width and depth
  (random weights from a seed) through ``repro_torch.launch.train.
  train_loop``: 8 AdamW steps of 8 x 512 tokens of the synthetic stream,
  bf16 compute over float32 masters, Algorithm 1 over the gradient
  buckets; B2's and B4's backward kernels (``flash_attention_bwd``,
  ``rmsnorm_bwd``) on every step;
* the SSM training path: mamba2-130m at its published width and depth
  through ``train_loop``, 8 steps of 8 x 512 tokens: B3's backward
  (``ssd_inner_bwd``) and B4's on every step;
* the hybrid training path: zamba2-7b at its published width and 14 of
  its 81 layers (at 81 its float32 masters, gradients and AdamW moments
  exceed the card), 3 steps of 8 x 512 tokens: B2's, B3's and B4's
  backward kernels on every step;
* the VLM training path: paligemma-3b at its published width and depth
  through ``train_loop``, 8 steps of 8 x (256 stub patches + 512
  tokens), the prefix-LM mask over the patches: B2's backward at head
  dim 256 (its hd-256 tensor-core build) and B4's on every step;
* the MoE training path: granite-moe-3b-a800m at its published width
  and the deepest depth whose reckoned peak stays under 76 GB (26 of its
  32 layers; at 32 its float32 masters and moments, bf16 copies and
  saved one-hot dispatch tensors exceed the card), 8 steps of 8 x 512
  tokens with ``comm_policy="app_aware"``: the router's gradient
  through the dispatch and the load-balancing loss, B2's and B4's
  backward kernels on every step;
* the enc-dec training path: whisper-large-v3 at its published width and
  depth through ``train_loop``, 8 steps of 8 x (1504 stub frames + 448
  tokens, its ``max_target_positions``): B2's backward non-causal over
  the frames, causal over the tokens and across to the frames, and
  B4's, on every step;
* the configs served at full size since phases 41-44 were added:
  stablelm-1.6b (24 layers, d_model 2048, 32 heads of 64), qwen2-moe-a2.7b
  at its 24 layers from bf16 parameters (60 experts top-4 and 4 shared,
  16 heads of 128, vocab 151,936; its float32 masters and their bf16 copy
  exceed the card), codeqwen1.5-7b (32 layers, d_model 4096, 32 heads of
  128 with the QKV bias, vocab 92,416) and llama3-8b (32 layers, d_model
  4096, 32 heads over 8 KV heads of 128, vocab 128,256, RoPE theta 5e5),
  the same requests as the other serves; their weights, drawn on the host
  from the seed by one CPU generator each (about 0.1 G values a second),
  are drawn by a background thread while the earlier phases run;
* the port's user entry points: ``python -m repro_torch.examples.
  quickstart`` and ``python -m repro_torch.benchmarks.run --only
  selector,model``.

To fit the training phases 34-38 in the time limit, phase 15 compares
granite-moe-3b-a800m card vs CPU at 8 of its 32 layers, and phase 20
whisper-large-v3 at 8 + 8 of its 32 + 32.

Phases:

1. the card's name, power limit and compute capability (must be 9.0);
2. build of every kernel library (one ``nvcc`` per source, all started
   together), a probe of the flash and SSD libraries' SASS for
   ``HGMMA`` (the tensor-core ``wgmma`` of their bf16 kernels), and
   ptxas's report that B4's wide-route builds spill nothing;
3. the segment-sum kernels against their plain PyTorch versions' sums
   in float64 on the card, at the simulator path's shapes (the scatter form also on
   slices that start off a 16-byte boundary), with the ids per link the
   scatter form meets, their times (the scatter form's at the NIC and
   background-tail shapes), the plain versions', PyTorch library calls'
   (yardsticks the port never calls: ``torch.bincount``, which syncs,
   eager; ``torch.segment_reduce`` and ``Tensor.index_add_`` by graph
   replay) and their memory bound;
4. the simulator path: a planned phase, 1 warm-up and 5 timed, then one
   planless, one notifying and one faulted phase, each checked for the
   kernel launches it must make;
5. the same seeded phase on the CPU, whose ``t_us`` must agree with the
   card's at rtol 2e-2;
6. the SSD (B3) and RMSNorm (B4) kernels against their plain versions
   on inputs taken from a warm-up serve, at the serving path's shapes:
   B3's bf16 tensor-core route on the serve's own bf16 inputs (B and C
   per group) and its float32 SIMT route on the same inputs cast to
   float32, with both routes' times and bounds, the plain version's;
   B4 at all four of its shapes on the route each takes and on the
   generic route (a copy of x one element off a 16-byte boundary), with
   its time and ``F.rms_norm``'s by graph replay over a ring of copies
   of x larger than the L2 (so x comes from HBM, as its bound counts)
   and over one x, a copy of x over the ring (the same bytes), and
   ``F.rms_norm``'s eager time and B4's bound;
7. the serving path: one timed ``ServeEngine.run``, every prefill and
   decode step checked for its kernel launches (every B3 launch on the
   tensor-core route), then one run with the prefill and one decode step
   under ``torch.profiler``;
8. the same seeded model on the CPU: 2 prompts of 256 tokens, last-token
   prefill logits against the card's in float32 and bfloat16 at 24
   layers, and in bfloat16 at 2 layers;
9. the flash-attention kernel (B2) against its plain version on inputs
   taken from a warm-up serve of qwen2-1.5b, in bfloat16 and float32 at
   the prefill's shape and at ragged lengths, and in bfloat16 at
   stablelm-1.6b's head dim of 64, with its time, the plain version's,
   ``F.scaled_dot_product_attention``'s (a yardstick the port never
   calls) and its bound; B4 at that serve's shapes, as in phase 6;
10. the dense serving path as phase 7: qwen2-1.5b, every prefill and
    decode step checked for its kernel launches, then profiled;
11. as phase 8 for qwen2-1.5b at 28 layers and at 2;
12. the §5 protocol: B1 against its plain versions (as in phase 3) on
    the last allreduce phase and the subsampled alltoall phase of two
    app-aware iterations, with the modes Algorithm 1 chose; then the
    protocol through the port's fig8 benchmark, every phase checked
    for a planned phase's B1 launches; per row and arm the median time,
    the normalised median, Algorithm 1's share of default-routed
    traffic, wall seconds per iteration and the shares of it spent in
    ``engine.decide`` and in ``run_phase`` (``trace_protocol``'s
    records); one app-aware alltoall iteration under
    ``torch.profiler``; then the same seeded rows (allreduce at 2
    iterations, alltoall at 1) on the CPU: the card's run, anchored to
    the CPU run's carried state before each phase, must keep its
    generator in lockstep, leave the CPU run's carried state before each
    phase, agree on phase and median times at rtol 2e-2 and choose the
    same modes under the tie rule (``repro_torch.benchmarks.parity``);
13. the lockstep tenancy sweep: one round's batch of the column
    (``torch_backend.prepare_batch``), its B1 launches per dispatch
    asserted equal to one phase's, both B1 forms at the batched shape
    held against their plain versions' float64 sums (the sorted form
    over the round's pairs sorted by id) and timed by graph replay; the
    same seeded column through ``run_phase_batch`` and through
    sequential ``run_phase`` for 3 rounds, ``t_us`` per cell within
    1e-4; the column's 8 rounds and baselines through the sweep in
    turns, lockstep, sequential, sequential, lockstep (B1's launches
    counted from 0 over the first and asserted: 6 scatter per dispatch),
    with each run's wall seconds, the ratio of the sums and the
    dispatches per round; one lockstep round under ``torch.profiler``;
    the published interference matrix in lockstep, every cell and the
    checks held against the committed ``BENCH_interference.json`` at
    rtol 2e-2;
14. the MoE serving path: B2 at granite's prefill shape (q
    ``[8,24,512,64]``, GQA group 3) against its plain version (the bf16
    limits of phase 9) and timed, B4 at the serve's shapes; one timed
    ``ServeEngine.run`` with ``comm_policy="app_aware"``, every prefill
    (32 B2, 65 B4) and decode step (0, 65) checked, the KV transfer's
    decision and bytes; one prefill and one decode step under
    ``torch.profiler``; one MoE layer in its parts (router and dispatch,
    the dispatch einsum, the experts, the combine einsum) and their
    share of the prefill;
15. granite card vs CPU at 8 and 2 layers, and qwen2-moe-a2.7b at full
    width and 2 layers, in float32 and bf16, each card run anchored to
    the CPU's expert choices, its routing flips counted per layer and
    held to the tie rule (``moe_cpu_compare``), then the logits as in
    phases 8 and 11;
16. the collective schedules in an NCCL world of one on a (1, 1, 1)
    mesh (each the identity: only that the calls reach NCCL), and
    ``moe_ep`` against ``moe_ep_ref`` on granite's layer-0 weights and
    the serve's input to that layer;
17. zamba2-7b built on the card (parameters, build time, peak memory);
    on a warm-up serve's own inputs B2 at head dim 112 (the 128 build),
    B3 at N = 64 with 112 heads on both routes and B4 at `[4096,3584]`,
    `[4096,7168]` (the wide route), `[8,3584]` and `[8,7168]` (wide), each
    against its plain version under the rules of phases 6 and 9, timed,
    with its bound (B2 beside SDPA); B4's generic route at the two
    7168-wide shapes on copies no vector route takes, held and timed;
18. the hybrid serving path as phase 7: every prefill (12 B2, 81 B3, 187
    B4) and decode step (0, 0, 187) checked, then profiled;
19. whisper-large-v3: B2 at the encoder's non-causal `[8,20,1504,64]`,
    the cross-attention's non-causal 128 queries over 1504 keys and the
    decoder's causal `[8,20,128,64]`, B4 at `[12032,1280]`,
    `[1024,1280]` and `[8,1280]`, held and timed as in phase 17; then
    the serve (96 B2 and 162 B4 per prefill, 0 and 97 per decode step),
    with ``encode_s`` inside ``prefill_s``, profiled;
20. card vs CPU prefill logits for zamba2-7b at 14 layers (2
    super-blocks, 1 shared-block application, 2 trailing layers) and
    whisper-large-v3 at 8 + 8 layers, float32 at ``LOGITS_F32_TOL``
    times the largest logit (the form that tests/test_torch_hybrid.py::
    test_float32_drift_grows_with_width sets against a float64 oracle),
    bf16 by the accuracy rule of phases 8 and 11;
21. paligemma-3b built on the card (parameters, build time, peak
    memory); on a warm-up serve's own inputs B2 at q ``[8,8,768,256]``,
    k, v ``[8,1,768,256]`` with the prefix at 256 (the hd-256 builds, in
    bf16 and on the inputs cast to float32; also cut to 200 rows with a
    prefix of 100, and causal without a prefix), held against its plain
    version and timed beside SDPA with the prefix as a boolean mask (its
    backend printed), and B4 at ``[6144,2048]`` and ``[8,2048]``; then
    the serve (18 B2 and 37 B4 per prefill, 0 and 37 per decode step),
    profiled;
22. card vs CPU prefill logits for paligemma-3b at full width and 4
    layers over ``CPU_BATCH`` x (256 patches + ``CPU_PROMPT`` tokens),
    as phase 20 holds them;
23. the backward kernels on inputs captured from one qwen2-1.5b train
    step (B2's q, k, v, o, dO and the forward's LSE at q
    ``[8,12,512,128]``, k, v ``[8,2,512,128]``; B4's x, gamma and dy at
    ``[4096,1536]``), in bf16 (B2's tensor-core route, whose kernels'
    ``HGMMA`` count in the SASS must be above 0; B4's register route) and
    on the inputs cast to float32 (the SIMT routes), and B2's on seeded
    causal, non-causal and prefix cases in both dtypes, against their
    plain versions (float32 within ``BWD_F32_RTOL`` of each gradient's
    largest entry, bf16 by the spread rule); B4's dx and dgamma the same
    bits in two runs; each timed by graph replay beside its plain
    version and the library's autograd backward (SDPA, ``F.rms_norm``;
    forward subtracted), with its bound;
24. the training path: ``train_loop`` for 8 steps, loss, lr and grad
    norm per step, the launches of B2, its backward, B4 and its backward
    over the run asserted (28, 28, 57 and 57 a step), ``train_step_s``
    (mean of steps 2-7), tokens/s, peak memory, Algorithm 1's bucket
    decisions, one more step under ``torch.profiler``, in which each
    backward call's kernels must run once each (28 a step of the four
    tensor-core kernels, 57 of B4's two), their times printed; the loss
    finite and lower at step 7 than at step 0;
25. card vs CPU, one float32 train step of qwen2-1.5b at full width and
    2 layers from the same weights and batch (TF32 off): loss, gradient
    norm, every gradient, and the updated parameters under the sign
    rule of tests/test_torch_train.py;
26. B3's backward on the inputs of a bf16 mamba2-130m train step's
    first backward call (x ``[8,4,24,128,64]``, N = 128, one group), in
    bf16 (the tensor-core route, asserted) and cast to float32 (the SIMT
    route), against its plain version under phase 23's rules, the same
    bits in two runs, timed by graph replay in one run beside the plain
    version, with its bound, its share of the bound, TFLOP/s and its
    scratch;
27. the SSM training path: ``train_loop`` on mamba2-130m for 8 steps,
    24 B3 and 24 B3-backward calls and 49 B4 and 49 B4-backward calls a
    step asserted, every B3 and B3-backward call on the tensor-core
    route, ``train_step_s``, tokens/s, peak memory, one more step
    profiled (B3's two tensor-core backward kernels 24 times each); the
    loss finite and lower at step 7 than at step 0;
28. as phase 25 for mamba2-130m at full width and 2 layers;
29. the hybrid training path: ``train_loop`` on zamba2-7b at 14 layers
    for 3 steps, the launches of B2, B3, B4 and their backward calls a
    step asserted (every B3-backward call on the tensor-core route),
    every loss finite and step 1's below step 0's; again for 5 steps at
    a tenth of the lr, every loss after step 0's below it, and one more
    step of that run profiled (B3's two tensor-core backward kernels 14
    times each); then, on the first run's captured inputs, B3's backward at
    ``[8,4,112,128,64]``, N = 64, B2's at q, k, v ``[8,32,512,112]`` and
    B4's at widths 3584 and 7168 (its wide route; and its generic route on
    copies no vector route takes, held and timed), each held and timed as
    in phases 23 and 26;
30. as phase 25 for zamba2-7b at full width and 3 layers with the
    shared block between each two, so that its gradient sums over two
    applications;
31. B2's backward on the inputs of a bf16 paligemma-3b train step's
    first backward call (q, o, dO ``[8,8,768,256]``, k, v
    ``[8,1,768,256]``, the prefix at 256, the forward's LSE), in bf16
    (the tensor-core route of the hd-256 build, asserted, its kernels'
    ``HGMMA`` count in the SASS above 0) and cast to float32 (the SIMT
    route), and on seeded cases in both dtypes (ragged rows with a
    prefix, causal without one, non-causal with Sq != Skv, head dim
    192), held as phase 23 holds them, the same bits in two runs, timed
    beside the plain version and SDPA's autograd backward with the
    prefix as a boolean mask (its backend printed), with its bound (the
    bf16 call must reach a tenth of it); B4's backward at
    ``[6144,2048]`` (its register route) likewise;
32. the VLM training path: ``train_loop`` on paligemma-3b for 8 steps,
    18 B2 and 18 B2-backward calls (every one on the tensor-core route)
    and 37 B4 and 37 B4-backward calls a step asserted,
    ``train_step_s``, tokens/s (text tokens, positions beside), peak
    memory, one more step profiled (each backward call's kernels once
    each); every loss finite and the last below step 0's;
33. as phase 25 for paligemma-3b at full width and 2 layers over 2 x
    (256 patches + 64 tokens);
34. the MoE training path: the depth reckoned (printed with each term
    of the reckoning), then ``train_loop`` on granite-moe-3b-a800m at
    that depth L for 8 steps with ``comm_policy="app_aware"``, L B2 and
    L B2-backward calls (every one on the tensor-core route) and 2L + 1
    B4 and B4-backward calls a step asserted, ``train_step_s``,
    tokens/s, the measured peak beside the reckoned, one more step
    profiled; every loss finite and step 7's below step 0's;
35. as phase 25 for granite-moe-3b-a800m at full width and 2 layers,
    the card's routing anchored to the CPU's expert choices and each
    flip held to the tie rule, as phase 15 holds them; the aux loss at
    the loss's limit;
36. the enc-dec training path: ``train_loop`` on whisper-large-v3 for 8
    steps of 8 x (1504 frames + 448 tokens), 96 B2 and 96 B2-backward
    calls (every one on the tensor-core route) and 162 B4 and 162
    B4-backward calls a step asserted, ``train_step_s``, tokens/s and
    positions/s, peak memory, one more step profiled; every loss finite
    and step 7's below step 0's;
37. as phase 25 for whisper-large-v3 at full width and 2 + 2 layers over
    2 x (1504 frames + 64 tokens);
38. on the inputs of the first steps of phases 34 and 36: B2's backward
    at granite's causal q ``[8,24,512,64]`` over k, v ``[8,8,512,64]``,
    whisper's non-causal encoder ``[8,20,1504,64]`` (a ragged last kv
    tile), its non-causal cross-attention of 448 queries over 1504 keys
    and its causal decoder ``[8,20,448,64]``; B4's backward at
    ``[12032,1280]`` and ``[3584,1280]``; each as phase 23 holds and
    times them;
39. phase 24's trained state restored by ``reshard_checkpoint`` onto a
    (1, 1) mesh, every leaf bit for bit, one step's loss bits;
40. the dry run's reckoning of three measured cells at mesh (1, 1);
41-44. stablelm-1.6b, qwen2-moe-a2.7b (bf16 parameters), codeqwen1.5-7b
    and llama3-8b, each moved to the card from its host draw; the serve's
    peak reckoned from the config (parameters, compute copies, KV cache)
    beside the measured; on a warm-up serve's own inputs B2 at the
    prefill's shape (and cut to 200 rows) against its plain version, timed
    beside SDPA with its bound, and the model's head order into B2
    (``flash_attend``) against the reference's grouping (``gqa_attend``);
    B4 at the prefill's and decode step's shapes (``[4096,4096]``, the
    register route's 16 vectors a lane, and ``[4096,2048]``) held and
    timed as in phase 17, and at the prefill's shape in float32 (the
    register route at 2048, the wide one at 4096); the serve as phase 10's (B2 / B4 launches per prefill
    and decode step: 24/49 and 0/49, 24/49 and 0/49, 32/65 and 0/65,
    32/65 and 0/65), profiled; for the three dense configs card vs CPU at
    2 layers, float32 at ``LOGITS_F32_TOL`` per element as phase 11 holds
    it, bf16 by the accuracy rule;
45. ``repro_torch.examples.quickstart`` (30 steps of the smoke qwen2 at
    8 x 64, a 4-request serve, the 8-group alltoall sweep with Algorithm
    1) and ``repro_torch.benchmarks.run --only selector,model`` on the
    card, their outputs checked.

Prints the kernel summary as one JSON line, then the ``ok`` line last.
Any failed check exits non-zero; so does a machine without CUDA, and a
directory without the rest of the repository.

    python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import copy
import gc
import io
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.benchmarks import fig8_microbench as fig8  # noqa: E402
from repro_torch.benchmarks import interference_matrix  # noqa: E402
from repro_torch.benchmarks.hold import differences  # noqa: E402
from repro_torch.benchmarks.common import (DAINT, MODE_LABEL,  # noqa: E402
                                           bench_topology, group_spread)
from repro_torch.benchmarks.parity import (compare_traces,  # noqa: E402
                                           mode_counts, trace_protocol)
from repro_torch.analysis import H100  # noqa: E402
from repro_torch.ckpt import reshard_checkpoint  # noqa: E402
from repro_torch.ckpt.checkpoint import to_host  # noqa: E402
from repro_torch.core.strategies import RoutingMode  # noqa: E402
from repro_torch.dragonfly import (DragonflySimulator, DragonflyTopology,  # noqa: E402
                                   RoutingPolicy, SimParams, TopologyParams,
                                   make_allocation)
from repro_torch.dragonfly import torch_backend  # noqa: E402
from repro_torch.dragonfly import traffic  # noqa: E402
from repro_torch.dragonfly.simulator import run_phase_batch  # noqa: E402
from repro_torch.faults import FaultSchedule, link_down  # noqa: E402
from repro_torch.collectives import (CollectiveMode,  # noqa: E402
                                     allreduce_direct,
                                     allreduce_hierarchical, alltoall_direct,
                                     alltoall_hierarchical, grad_allreduce)
from repro_torch.collectives.moe_ep import moe_ep, moe_ep_ref  # noqa: E402
from repro_torch.configs.granite_moe_3b_a800m import \
    CONFIG as GRANITE  # noqa: E402
from repro_torch.configs.codeqwen15_7b import \
    CONFIG as CODEQWEN  # noqa: E402
from repro_torch.configs.llama3_8b import CONFIG as LLAMA3  # noqa: E402
from repro_torch.configs.mamba2_130m import CONFIG as MAMBA2  # noqa: E402
from repro_torch.configs.paligemma_3b import \
    CONFIG as PALIGEMMA  # noqa: E402
from repro_torch.configs.qwen2_moe_a2_7b import \
    CONFIG as QWEN2_MOE  # noqa: E402
from repro_torch.configs.qwen2_1_5b import CONFIG as QWEN2  # noqa: E402
from repro_torch.configs.stablelm_1_6b import CONFIG as STABLELM  # noqa: E402
from repro_torch.configs.whisper_large_v3 import \
    CONFIG as WHISPER  # noqa: E402
from repro_torch.configs.zamba2_7b import CONFIG as ZAMBA2  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import _route, libraries  # noqa: E402
from repro_torch.kernels._build import build_all, find_nvcc  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
    flash_attention_fwd, flash_attention_plain)
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.build import LIB as FLASH_LIB  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import (  # noqa: E402
    rmsnorm_bwd, rmsnorm_bwd_plain, rmsnorm_fused, rmsnorm_plain)
from repro_torch.kernels.segment_sum import (  # noqa: E402
    segment_sum_scatter, segment_sum_scatter_plain, segment_sum_sorted,
    segment_sum_sorted_plain)
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    ssd_inner, ssd_inner_bwd, ssd_inner_bwd_plain, ssd_inner_plain)
from repro_torch.kernels.ssd_scan.build import LIB as SSD_LIB  # noqa: E402
from repro_torch.models import attention as model_attention  # noqa: E402
from repro_torch.models import common as model_common  # noqa: E402
from repro_torch.models import encdec as model_encdec  # noqa: E402
from repro_torch.models import mamba2 as model_mamba2  # noqa: E402
from repro_torch.models import moe as model_moe  # noqa: E402
from repro_torch.models import moe_parity  # noqa: E402
from repro_torch.models import registry as model_registry  # noqa: E402
from repro_torch.models import transformer as model_tf  # noqa: E402
from repro_torch.models.common import CastCache, Family  # noqa: E402
from repro_torch.models.hybrid import hybrid_layout  # noqa: E402
from repro_torch.policy import PolicyEngine  # noqa: E402
from repro_torch.runtime import on_hopper  # noqa: E402
from repro_torch.serve import Request, ServeConfig, ServeEngine  # noqa: E402
from repro_torch.tenancy import InterferenceEngine, sweep  # noqa: E402

N_GROUPS = 12
N_FLOWS = 120_000
FEEDBACK_ITERS = 4
TIMED_PHASES = 5
#: kernel vs the plain version's float64 sums: float32 sums of positive
#: values (the sorted form's 32 lane sums, then a tree; the scatter
#: form's in atomic order) — a relative error of a few 1e-7 per term
#: over a lane's share of a segment
KERNEL_RTOL = 1e-5
#: target for the scatter form's time by graph replay at the NIC shape:
#: reported, not enforced (a miss goes into PERF.md)
SCATTER_US = 3.0
#: card vs CPU run of the same phase (the jax engine's JAX_RTOL)
CPU_RTOL = 2e-2
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s, dense
#: bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
KERNEL_SOURCE = "src/repro_torch/kernels/segment_sum/csrc/segment_sum.cu"
TPU_KERNEL = "src/repro/kernels/segment_sum/segment_sum.py:48"
SSD_SOURCE = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
SSD_TPU = "src/repro/kernels/ssd_scan/ssd_scan.py:54"
RMS_SOURCE = "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu"
RMS_TPU = "src/repro/kernels/rmsnorm/rmsnorm.py:29"
FLASH_SOURCE = \
    "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FLASH_TPU = "src/repro/kernels/flash_attention/flash_attention.py:84"
#: serving path: requests x prompt tokens, new tokens, weight seed
SERVE_BATCH, PROMPT_LEN, NEW_TOKENS, SEED = 8, 512, 32, 0
#: whisper's decoder prompt (under its 448 decoder positions); its
#: encoder takes the config's 1504 frames per request
WHISPER_PROMPT = 128
#: card vs CPU prefill: prompts x tokens
CPU_BATCH, CPU_PROMPT = 2, 256
#: SSD kernel vs plain version in float32: float32 sums of at most 128
#: products, relative to the largest output (the tests' SSD_RTOL); in
#: bf16 per output within ssd_ops.bf16_limits (the witness
#: tests/test_torch_ssd_scan.py::test_bf16_route_witness)
SSD_RTOL = 1e-5
#: targets for B3's bf16 route at the prefill's shape: at most this many
#: us per launch, and this many times faster than the float32 route in the
#: same run; reported, not enforced (a miss goes into PERF.md)
SSD_BF16_US, SSD_F32_FACTOR = 110.0, 4.0
#: RMSNorm kernel vs plain version in bf16: one bf16 ulp of the value
BF16_RTOL = 2.0 ** -7
#: target for B4 by graph replay over a ring of x at the mamba2-130m
#: prefill's [4096, 768] in bf16 (beside F.rms_norm at every main-path shape): reported, not
#: enforced (a miss goes into PERF.md)
RMS_US = 4.5
#: flash kernel vs plain version in float32: the same float32 math in
#: other orders (the kernel scales q before the dot, the plain version
#: the scores after it), at the JAX kernel tests' 3e-5
FLASH_TOL = 3e-5
#: in bf16 the kernel rounds each kv tile's unnormalised P to bf16 and
#: the plain version the normalised probabilities, each p_j to within
#: 2**-8 p_j: outputs to one bf16 ulp of the value (BF16_RTOL) plus, per
#: output, FLASH_BF16_ATOL_PER_PV * sum_j p_j |v_j|, the worst case of
#: the two placements (flash_bf16_atol; the witness
#: tests/test_torch_flash_attention.py::test_kernel_order_witness)
FLASH_BF16_ATOL_PER_PV = 2.0 ** -7
#: the target for B2's bf16 time, as a multiple of SDPA's: reported, not
#: enforced (a miss goes into PERF.md with its numbers)
FLASH_SDPA_FACTOR = 2.0
#: card vs CPU logits of the full-width model in float32: the same math
#: in other summation orders over 24 or 28 layers
LOGITS_F32_TOL = 1e-3
#: card vs CPU logits in bf16 at full width and 2 layers: the tests' bf16
#: tolerance (tests/test_torch_mamba2.py), at the depth they hold it
LOGITS_BF16_TOL = 4e-2
#: card vs CPU logits of mamba2-130m in bf16 at 24 layers, as a share of
#: the CPU's bf16 vs float32 difference: there the two bf16 runs share
#: most of their rounding (readings: 0.40-0.50 card vs CPU, PERF.md
#: section 6).  Not held for qwen2-1.5b at 28 layers, where any two bf16
#: runs that sum in other orders share little of it (readings: 0.93 and
#: 0.86 card vs CPU; tests/test_torch_transformer.py::
#: test_bf16_rounding_spread_grows_with_depth)
BF16_SPREAD_SHARE = {MAMBA2.name: 0.75}
#: the card's bf16 logits at full depth vs the CPU's float32 ones, as a
#: multiple of the CPU's bf16 vs float32 difference: a bf16 run that sums
#: in another order is as close to float32 as the first (the witness
#: above: 0.97-0.99 in mean, at most 1.0 in max)
BF16_ACCURACY_RATIO = 1.25


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_inputs(topo, n_flows: int, seed: int = 42):
    """The Pareto-sized random many-to-many phase of perf_sim.py."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, topo.params.n_nodes, size=n_flows)
    dst = (src + rng.integers(1, topo.params.n_nodes, size=n_flows)) \
        % topo.params.n_nodes
    size = rng.pareto(1.2, size=n_flows) * 65536 + 1024
    return src, dst, size


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per eager call of ``fn`` over ``iters`` calls,
    between CUDA events: device time, or the host's enqueue time when
    the host is slower."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean device milliseconds per launch: ``iters`` calls captured in
    one CUDA graph and replayed, so the host's per-call Python cost is
    out of the measurement."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


#: bytes of input copies a timing ring holds: three times the H100's 50 MB
#: L2, so that a call finds none of its input there
RING_BYTES = 150 * 2**20


def graph_ms_ring(fn, x: torch.Tensor, iters: int) -> float:
    """As :func:`graph_ms` for ``fn(x)``, with call i reading copy i % k of
    ``x`` from a ring of k copies that holds RING_BYTES (at most ``iters``
    copies), and every call's output kept apart: where the ring outgrows
    the L2, each call reads its input from HBM and writes lines of its
    own, as the bound counts."""
    k = max(1, min(iters, -(-RING_BYTES // (x.numel() * x.element_size()))))
    ring = [x.clone() for _ in range(k)]
    fn(ring[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    kept = []
    with torch.cuda.graph(graph):
        for i in range(iters):
            kept.append(fn(ring[i % k]))
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


#: device_profile's numbers by label
PROFILES: dict = {}
#: device_profile's device events by label: {kernel name: (count, us)}
PROFILE_KERNELS: dict = {}


def device_profile(fn, label: str = "phase"):
    """Call ``fn`` once under ``torch.profiler`` and print its device
    time by kernel (kernels, copies and fills on the card); returns
    ``fn``'s result and keeps wall, busy and idle share in
    ``PROFILES[label]``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_s = sum(us for _, us in by_name.values()) * 1e-6
    if not by_name:
        print("  device time: not measured (the trace holds no device "
              "events)")
        return res
    PROFILE_KERNELS[label] = by_name
    PROFILES[label] = {"wall_s": wall_s, "busy_s": busy_s,
                       "idle_share": 1 - busy_s / wall_s,
                       "events": sum(n for n, _ in by_name.values())}
    print(f"  profiled {label}: wall {wall_s:.6f} s, device busy "
          f"{busy_s:.6f} s, device idle share {1 - busy_s / wall_s:.4f}, "
          f"{sum(n for n, _ in by_name.values())} device events")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"    {us:10.1f} us  x{n:<4d} {name[:90]}")
    return res


def hgmma_by_function(lib) -> dict:
    """HGMMA (``wgmma``) instructions in a built library's SASS by
    (mangled) function name, read with the toolkit's ``cuobjdump``."""
    out = subprocess.run(
        [str(Path(find_nvcc()).parent / "cuobjdump"), "--dump-sass",
         str(lib.path)], capture_output=True, text=True, check=True,
        timeout=300)
    counts: dict = {}
    fn = ""
    for line in out.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
        elif "HGMMA" in line:
            counts[fn] = counts.get(fn, 0) + 1
    return counts


def hgmma_count(lib) -> int:
    """HGMMA instructions in a built library's SASS."""
    return sum(hgmma_by_function(lib).values())


def flash_bf16_atol(q, k, v, causal: bool,
                    prefix_len: int = 0) -> torch.Tensor:
    """Per output, ``FLASH_BF16_ATOL_PER_PV * sum_j p_j |v_j|`` with the
    plain version's float32 probabilities."""
    return FLASH_BF16_ATOL_PER_PV * flash_attention_plain(
        q.float(), k.float(), v.float().abs(), causal=causal,
        prefix_len=prefix_len)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def hold(name: str, got: torch.Tensor, plain) -> float:
    """Kernel result vs the plain version on the same inputs, which
    ``plain(dtype)`` computes with the values and the output in
    ``dtype``: the kernel is held against the float64 sums; the float32
    plain version's own distance from them is printed beside."""
    want = plain(torch.float64)
    want32 = plain(torch.float32)
    torch.cuda.synchronize()
    err = max_err(got.double(), want)
    tol = KERNEL_RTOL * float(want.abs().max())
    ok = bool(torch.allclose(got.double(), want, rtol=KERNEL_RTOL, atol=tol))
    print(f"  {name}: max_abs_err {err:.3e} against the float64 sums "
          f"(rtol {KERNEL_RTOL}, atol {tol:.3e}; the float32 plain "
          f"version's {max_err(want32.double(), want):.3e}) "
          f"{'ok' if ok else 'MISMATCH'}")
    check(ok, f"{name} disagrees with its plain version")
    return err


def sorted_plain(values, seg_off, n: int):
    return lambda dt: segment_sum_sorted_plain(
        values.to(dt), seg_off, torch.zeros(n, dtype=dt,
                                            device=values.device))


def scatter_plain(values, ids, n: int):
    return lambda dt: segment_sum_scatter_plain(
        values.to(dt), ids, torch.zeros(n, dtype=dt, device=values.device))


# ------------------------------------------------------------ phase 3
def b1_parts(x: dict) -> dict:
    """The pairs one phase or one batch ``x`` (prepared pipeline inputs:
    ``_prepare_inputs`` or ``prepare_batch``) hands B1: the spray values
    over every pair, cut into the sorted head and the unsorted tail, and
    the NIC ids with their values."""
    dev = x["size_all"].device
    shape = x["safe"].shape[:-1]                  # [(B,) n, ncand]
    w = torch.full(shape, 1.0 / shape[-1], device=dev)
    vals = ((x["size_all"][..., None] * w).reshape(-1)[x["pair_fc"]]
            .contiguous())
    p_sorted = x["p_sorted"]
    return dict(vals=vals, head=vals[:p_sorted], tail=vals[p_sorted:],
                tail_ids=x["pair_links"][p_sorted:],
                nic_ids=x["nic_ids"].reshape(-1).contiguous(),
                nic_vals=torch.minimum(x["size_all"],
                                       x["cap_window"][x["nic_ids"]])
                .reshape(-1).contiguous())


def b1_holds(x: dict, n_links: int, what: str) -> tuple:
    """Both forms of B1 against their plain versions on phase ``x``'s
    pairs: the sorted head, the NIC ids, the tail, and head and tail
    summed into one buffer.  Returns the sorted and scatter forms'
    largest errors."""
    b = b1_parts(x)
    seg_off, dev = x["seg_off"], b["vals"].device

    def zeros():
        return torch.zeros(n_links, device=dev)

    err_sorted = hold(f"{what}sorted head",
                      segment_sum_sorted(b["head"], seg_off, zeros()),
                      sorted_plain(b["head"], seg_off, n_links))
    err_scatter = hold(
        f"{what}scatter NIC ids",
        segment_sum_scatter(b["nic_vals"], b["nic_ids"], zeros()),
        scatter_plain(b["nic_vals"], b["nic_ids"], n_links))
    err_scatter = max(err_scatter, hold(
        f"{what}scatter background tail (bucket-padded)",
        segment_sum_scatter(b["tail"], b["tail_ids"], zeros()),
        scatter_plain(b["tail"], b["tail_ids"], n_links)))
    # one buffer for head and tail = the plain sum over every pair
    both = segment_sum_scatter(b["tail"], b["tail_ids"], segment_sum_sorted(
        b["head"], seg_off, zeros()))
    err_sorted = max(err_sorted, hold(
        f"{what}sorted head + scatter tail into one buffer", both,
        scatter_plain(b["vals"], x["pair_links"], n_links)))
    return err_sorted, err_scatter


def kernel_checks(x: dict, n_links: int) -> list:
    """Both kernel forms against their plain versions at the shapes of
    one planned phase ``x`` (prepared pipeline inputs)."""
    b = b1_parts(x)
    dev = b["vals"].device
    head, tail, tail_ids = b["head"], b["tail"], b["tail_ids"]
    nic_ids, nic_vals = b["nic_ids"], b["nic_vals"]
    p_sorted, seg_off = x["p_sorted"], x["seg_off"]
    head_ids = x["pair_links"][:p_sorted].long()
    n_all = nic_ids.shape[0]

    def zeros():
        return torch.zeros(n_links, device=dev)

    print(f"phase 3: kernels vs plain on the card (P = {p_sorted} sorted "
          f"pairs, {tail.shape[0]} tail pairs, {n_all} NIC ids, "
          f"{n_links} segments)")
    # real offsets have empty segments
    n_empty = int((seg_off[1:] == seg_off[:-1]).sum())
    check(n_empty > 0, "the main path's offsets have no empty segment")
    err_sorted, err_scatter = b1_holds(x, n_links, "")
    # a handful of segments, most of them empty
    few_off = torch.tensor([0, 0, 3, 3, 3, 7, 7], dtype=torch.int32,
                           device=dev)
    few = head[:7].contiguous()
    err_sorted = max(err_sorted, hold(
        "sorted, empty segments",
        segment_sum_sorted(few, few_off, torch.zeros(6, device=dev)),
        sorted_plain(few, few_off, 6)))
    # out-of-range ids vanish
    rng = np.random.default_rng(0)
    bad_ids = torch.from_numpy(rng.choice(
        np.array([-5, -1, n_links, n_links + 7, 3, 17], dtype=np.int32),
        size=nic_ids.shape[0])).to(dev)
    err_scatter = max(err_scatter, hold(
        "scatter, out-of-range ids",
        segment_sum_scatter(nic_vals, bad_ids, zeros()),
        scatter_plain(nic_vals, bad_ids, n_links)))

    # odd-length slices at an odd offset
    for start, length in ((1, 9), (3, 5), (1, 1)):
        err_scatter = max(err_scatter, hold(
            f"scatter, NIC slice [{start}:{start + length}]",
            segment_sum_scatter(nic_vals[start:start + length],
                                nic_ids[start:start + length], zeros()),
            scatter_plain(nic_vals[start:start + length],
                          nic_ids[start:start + length], n_links)))

    # the ids per link the scatter form's atomics meet
    tail_keep = (tail_ids >= 0) & (tail_ids < n_links)
    tail_in_ids, tail_in_vals = tail_ids[tail_keep].long(), tail[tail_keep]
    touched = {}
    for label, ids in (("NIC", nic_ids.long()), ("tail", tail_in_ids)):
        per_link = torch.bincount(ids, minlength=n_links)
        hit = per_link[per_link > 0]
        touched[label] = int(hit.numel())
        print(f"  scatter {label} ids: {int(ids.numel())} in range over "
              f"{touched[label]} links, ids per link touched: mean "
              f"{float(hit.float().mean()):.2f}, max {int(hit.max())}")

    # times: kernel, plain version, library yardsticks, memory bound
    out = zeros()
    nonempty = int((seg_off[1:] > seg_off[:-1]).sum())
    nic_ids_long = nic_ids.long()
    seg_off_long = seg_off.long()
    rows = {}
    for name, prefix, kernel, plain, library, (yard_name, yard), n_pairs, \
            nbytes in (
            ("segment_sum_sorted", "",
             lambda: segment_sum_sorted(head, seg_off, out),
             lambda: segment_sum_sorted_plain(head, seg_off, out),
             lambda: torch.bincount(head_ids, head, minlength=n_links),
             ("torch.segment_reduce", lambda: torch.segment_reduce(
                 head, "sum", offsets=seg_off_long, unsafe=True)),
             p_sorted,
             4 * p_sorted + 4 * (n_links + 1) + 8 * nonempty),
            ("segment_sum_scatter", "",
             lambda: segment_sum_scatter(nic_vals, nic_ids, out),
             lambda: segment_sum_scatter_plain(nic_vals, nic_ids, out),
             lambda: torch.bincount(nic_ids_long, nic_vals,
                                    minlength=n_links),
             ("Tensor.index_add_",
              lambda: out.index_add_(0, nic_ids_long, nic_vals)),
             n_all, 8 * n_all + 8 * touched["NIC"]),
            ("segment_sum_scatter", "tail_",
             lambda: segment_sum_scatter(tail, tail_ids, out),
             lambda: segment_sum_scatter_plain(tail, tail_ids, out),
             lambda: torch.bincount(tail_in_ids, tail_in_vals,
                                    minlength=n_links),
             ("Tensor.index_add_",
              lambda: out.index_add_(0, tail_in_ids, tail_in_vals)),
             tail.shape[0], 8 * tail.shape[0] + 8 * touched["tail"])):
        ms = graph_ms(kernel, 200)
        eager_ms = cuda_ms(kernel, 200)
        plain_ms = cuda_ms(plain, 20)
        library_ms = cuda_ms(library, 200)
        yard_ms = graph_ms(yard, 200)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_pairs / F32_FLOP_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        print(f"  {name}{' (tail)' if prefix else ''}: {ms * 1e3:.2f} "
              f"us/launch (graph replay; eager call {eager_ms * 1e3:.2f} "
              f"us), plain {plain_ms * 1e3:.2f} us, torch.bincount "
              f"{library_ms * 1e3:.2f} us, {yard_name} "
              f"{yard_ms * 1e3:.2f} us (graph replay), bound "
              f"{bound_ms * 1e3:.2f} us ({nbytes} bytes at "
              f"{HBM_BYTES_PER_S:.3g} B/s) over {n_pairs} pairs")
        if name == "segment_sum_scatter":
            print(f"  scatter{' (tail)' if prefix else ''} "
                  f"{ms * 1e3:.2f} us: "
                  f"{'within' if ms * 1e3 <= SCATTER_US else 'MISSES'} "
                  f"{SCATTER_US} us")
        row = rows.setdefault(name, {
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": TPU_KERNEL, "launches": 0,
            "max_abs_err": err_sorted if "sorted" in name else err_scatter})
        row.update({f"{prefix}ms": ms, f"{prefix}plain_ms": plain_ms,
                    f"{prefix}bound_ms": bound_ms,
                    f"{prefix}bound_by": "bytes" if bytes_ms >= ops_ms
                    else "operations",
                    f"{prefix}library_ms": library_ms,
                    f"{prefix}eager_ms": eager_ms,
                    f"{prefix}library_graph_ms": yard_ms,
                    f"{prefix}library_graph_call": yard_name,
                    f"{prefix}pairs": n_pairs})
    scatter = rows["segment_sum_scatter"]
    # what the scatter form's time at the NIC shape follows: the same
    # pairs with their ids spread over the whole link range (an injective
    # map, so the same number of ids per link, on more cache lines)
    lo, hi = int(nic_ids.min()), int(nic_ids.max())
    step = max(1, (n_links - 1) // max(1, hi - lo))
    spread_ids = ((nic_ids - lo) * step).to(torch.int32)
    spread_ms = graph_ms(lambda: segment_sum_scatter(nic_vals, spread_ids,
                                                     out), 200)
    print(f"  diagnostic: the NIC ids span links {lo}..{hi} "
          f"({(hi - lo + 1) * 4} bytes of counters); spread {step} floats "
          f"apart the same pairs take {spread_ms * 1e3:.2f} us/launch "
          f"(graph replay), against {scatter['ms'] * 1e3:.2f}")
    scatter["nic_spread_ms"] = spread_ms
    return list(rows.values())


# ------------------------------------------------------------ phase 4
def launches() -> tuple:
    return segment_sum_sorted.launches, segment_sum_scatter.launches


def run_counted(what: str, want: tuple, fn):
    """Run one phase; check the kernel launches it made."""
    before = launches()
    t0 = time.perf_counter()
    res = fn()
    dt = time.perf_counter() - t0
    got = tuple(a - b for a, b in zip(launches(), before))
    print(f"  {what}: {dt:.4f} s, launches sorted/scatter {got[0]}/"
          f"{got[1]} (want {want[0]}/{want[1]})")
    check(got == want, f"{what}: launches {got}, want {want}")
    check(bool(np.isfinite(res.t_us).all()) and res.t_us.shape[0] > 0,
          f"{what}: non-finite or empty t_us")
    return res, dt



# ----------------------------------------------------------- phases 6-11
def serve_launches(cfg) -> tuple:
    """The kernels of a serving path and the launches of each in one
    prefill and in one decode step: ``(kernels, prefill, step)``.  The
    mixer (B3 or B2) runs once per layer in a prefill and never in a
    decode step; B4 twice per layer and once for the final norm in both.
    The hybrid adds B2 and two norms per shared-block application; the
    enc-dec family runs B2 once per encoder layer and twice per decoder
    layer in a prefill, and B4 twice per encoder layer, once for the
    encoder's final norm and three times per decoder layer."""
    n = cfg.n_layers
    if cfg.family == Family.SSM:
        return (ssd_inner, rmsnorm_fused), (n, 2 * n + 1), (0, 2 * n + 1)
    if cfg.family == Family.HYBRID:
        n_apps = hybrid_layout(cfg)[3]
        norms = 2 * n + 2 * n_apps + 1
        return ((flash_attention, ssd_inner, rmsnorm_fused),
                (n_apps, n, norms), (0, 0, norms))
    if cfg.family == Family.ENCDEC:
        enc = cfg.n_encoder_layers
        return ((flash_attention, rmsnorm_fused),
                (enc + 2 * n, 2 * enc + 1 + 3 * n + 1), (0, 3 * n + 1))
    return (flash_attention, rmsnorm_fused), (n, 2 * n + 1), (0, 2 * n + 1)


def launch_counts(kernels) -> tuple:
    return tuple(k.launches for k in kernels)


def prompts(vocab: int, batch: int, length: int, seed: int) -> list:
    """Random prompts, as ``repro_torch.launch.serve`` draws them."""
    rng = np.random.default_rng(seed)
    return [list(rng.integers(1, vocab, length)) for _ in range(batch)]


def prompt_len(cfg) -> int:
    """Prompt tokens per request: whisper's decoder prompt is shorter."""
    return WHISPER_PROMPT if cfg.family == Family.ENCDEC else PROMPT_LEN


def frames(cfg, batch: int, rng) -> np.ndarray:
    """The enc-dec family's stub frame embeddings, as
    ``repro_torch.launch.serve`` draws them after the prompts."""
    return rng.standard_normal((batch, cfg.encoder_frames, cfg.d_model)) \
        .astype(np.float32) * 0.02


class Checked:
    """Wraps an engine's prefill or decode step: each call synchronises,
    is timed on the host clock, and must launch exactly ``want`` of each
    of ``kernels``; ``profile_at`` names calls to run under
    :func:`device_profile` instead."""

    def __init__(self, fn, what: str, kernels, want: tuple, profile_at=()):
        self.fn, self.what, self.kernels, self.want = fn, what, kernels, want
        self.profile_at = set(profile_at)
        self.times: list = []

    def __call__(self, *args):
        before = launch_counts(self.kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if len(self.times) in self.profile_at:
            out = device_profile(lambda: self.fn(*args), self.what)
        else:
            out = self.fn(*args)
        torch.cuda.synchronize()
        self.times.append(time.perf_counter() - t0)
        got = tuple(a - b for a, b in zip(launch_counts(self.kernels),
                                        before))
        names = "/".join(k.__name__ for k in self.kernels)
        check(got == self.want, f"{self.what} call {len(self.times)}: "
              f"launches {names} {got}, want {self.want}")
        return out


def serve_engine(cfg, model, cuda, profile=False, **scfg):
    """A ServeEngine of ``cfg`` (``scfg``: more ServeConfig fields) whose
    prefill and decode steps are Checked for the launches
    ``serve_launches(cfg)`` gives."""
    kernels, per_prefill, per_step = serve_launches(cfg)
    eng = ServeEngine(cfg, model,
                      ServeConfig(batch=SERVE_BATCH,
                                  max_len=prompt_len(cfg) + NEW_TOKENS + 8
                                  + image_tokens(cfg), **scfg),
                      device=cuda)
    eng._prefill = Checked(eng._prefill, f"{cfg.name} prefill", kernels,
                           per_prefill, profile_at=(0,) if profile else ())
    eng._step = Checked(eng._step, f"{cfg.name} decode step", kernels,
                        per_step, profile_at=(1,) if profile else ())
    return eng


def image_tokens(cfg) -> int:
    """The VLM's image positions before each prompt (0 elsewhere)."""
    return cfg.img_tokens if cfg.family == Family.VLM else 0


def patches(cfg, batch: int, rng) -> np.ndarray:
    """The VLM's stub patch embeddings, as ``repro_torch.launch.serve``
    draws them after the prompts."""
    return rng.standard_normal((batch, cfg.img_tokens, cfg.d_model)) \
        .astype(np.float32) * 0.02


def serve_inputs(cfg) -> tuple:
    """The serving path's requests and ``run``'s ``extra``, drawn as
    ``repro_torch.launch.serve`` draws them from ``SEED``: the prompts,
    then (enc-dec) the frames or (VLM) the patches."""
    rng = np.random.default_rng(SEED)
    reqs = [Request(prompt=list(rng.integers(1, cfg.vocab, prompt_len(cfg))),
                    max_new_tokens=NEW_TOKENS) for _ in range(SERVE_BATCH)]
    extra = None
    if cfg.family == Family.ENCDEC:
        extra = {"frames": frames(cfg, SERVE_BATCH, rng)}
    elif cfg.family == Family.VLM:
        extra = {"patches": patches(cfg, SERVE_BATCH, rng)}
    return reqs, extra


def capture_inputs(cfg, model, cuda) -> dict:
    """One warm-up serve; keeps the first inputs of each shape that the
    B2 (keyed with its prefix), B3 and B4 wrappers were given (B3's
    rebuilt from the scan's
    arguments by ``chunk_inputs``, as ``ssd_scan_op`` builds them: x, B,
    C, dacum and dt on the bf16 route), and the first MoE layer's
    weights and input of each shape."""
    seen: dict = {}
    real_scan, real_norm, real_flash = model_mamba2.ssd_scan_op, \
        model_common.rmsnorm_fused, model_attention.flash_attention
    real_moe = model_tf.moe_einsum

    def moe_layer(w, x, cfg):
        seen.setdefault(("moe",) + tuple(x.shape), [w, x.clone()])
        return real_moe(w, x, cfg)

    def scan(x, dt, a_log, b_mat, c_mat, chunk, **kw):
        key = ("ssd",) + tuple(x.shape)
        if key not in seen:
            seen[key] = [t.clone() for t in ssd_ops.chunk_inputs(
                x, dt, a_log, b_mat, c_mat, chunk)]
        return real_scan(x, dt, a_log, b_mat, c_mat, chunk, **kw)

    def norm(x, gamma, eps):
        seen.setdefault(("rms",) + tuple(x.shape),
                        [x.clone(), gamma.clone(), eps])
        return real_norm(x, gamma, eps)

    def flash(q, k, v, *, causal=True, prefix_len=0):
        seen.setdefault(("flash",) + tuple(q.shape) + tuple(k.shape)
                        + (prefix_len,),
                        [q.clone(), k.clone(), v.clone(), causal])
        return real_flash(q, k, v, causal=causal, prefix_len=prefix_len)

    model_mamba2.ssd_scan_op, model_common.rmsnorm_fused, \
        model_attention.flash_attention = scan, norm, flash
    model_tf.moe_einsum = moe_layer
    try:
        reqs, extra = serve_inputs(cfg)
        serve_engine(cfg, model, cuda).run(reqs, seed=SEED, extra=extra)
    finally:
        model_mamba2.ssd_scan_op, model_common.rmsnorm_fused, \
            model_attention.flash_attention = real_scan, real_norm, real_flash
        model_tf.moe_einsum = real_moe
    return seen


def serve_kernel_checks(seen: dict) -> list:
    """B3 and B4 against their plain versions on the serving path's own
    inputs; times and bounds.  Returns the JSON rows (B3, then B4 at the
    prefill's ``[B*S, d_model]``)."""
    print("phase 6: SSD and RMSNorm kernels vs plain on the card, inputs "
          "from a warm-up serve")
    ssd_keys = [k for k in seen if k[0] == "ssd"]
    check(len(ssd_keys) == 1, f"the serve gave B3 shapes {ssd_keys}")
    row = ssd_row(seen[ssd_keys[0]])
    print(f"  B3 bf16 {row['ms'] * 1e3:.2f} us: "
          f"{'within' if row['ms'] * 1e3 <= SSD_BF16_US else 'MISSES'} "
          f"{SSD_BF16_US} us; float32 / bf16 = {row['f32_factor']:.2f}: "
          f"{'within' if row['f32_factor'] >= SSD_F32_FACTOR else 'MISSES'} "
          f"{SSD_F32_FACTOR}x")
    rows = [dict(row, by_shape=[ssd_entry(row, MAMBA2.name)])]

    rms_keys = sorted(k for k in seen if k[0] == "rms")
    rms_rows = [rms_row(*seen[key]) for key in rms_keys]
    check(len(rms_rows) == 4, f"the serve gave B4 shapes {rms_keys}")
    row = next(r for r in rms_rows if r["shape"] == [
        SERVE_BATCH * PROMPT_LEN, MAMBA2.d_model])
    row["max_abs_err"] = max(r["max_abs_err"] for r in rms_rows)
    row["by_shape"] = [rms_entry(r, MAMBA2.name) for r in rms_rows]
    us = row["ms"] * 1e3
    print(f"  B4 at {row['shape']}: {us:.2f} us: "
          f"{'within' if us <= RMS_US else 'MISSES'} {RMS_US} us")
    rows.append(row)
    return rows


def ssd_row(bf) -> dict:
    """B3 on one serve's inputs ``bf`` (x, B, C, dacum, dt; bf16): its
    bf16 tensor-core route within ``ssd_ops.bf16_limits`` and its float32
    SIMT route on the same inputs cast to float32 within ``SSD_RTOL``,
    both timed by graph replay beside the plain version, with their
    bounds.  Returns the JSON row (float32 figures under ``f32_*``)."""
    x, bm, cm, da, dt = bf
    bsz, nc, heads, q, p = x.shape
    groups, n = bm.shape[2], bm.shape[-1]
    check(x.dtype == bm.dtype == cm.dtype == torch.bfloat16 and
          dt is not None and groups == 1, f"B3 saw x {x.dtype}, b "
          f"{tuple(bm.shape)} {bm.dtype}: want bf16, dt, one group")
    f32 = [t.float() for t in (x, bm, cm)] + [da, dt]
    row = {"name": "ssd_inner", "route": "cuda", "source": SSD_SOURCE,
           "replaces": SSD_TPU, "launches": 0,
           "shape": list(x.shape) + [n, groups]}
    cells = bsz * nc * heads
    # the function's own work: C.B^T once per group over the causal half
    # (j <= i), scores . xdt over it and the state; the elementwise decay
    # terms (under 1 %) are left out
    flops = cells * (q * (q + 1) * p + 2 * q * n * p) + \
        bsz * nc * groups * q * (q + 1) * n
    for prefix, args in (("", bf), ("f32_", f32)):
        label = "bf16 (wgmma)" if prefix == "" else "float32 (SIMT)"
        y, st = ssd_inner(*args)
        torch.cuda.synchronize()
        want_y, want_st = ssd_inner_plain(*args)
        if prefix == "":
            limits = ssd_ops.bf16_limits(*args)
            what = "per output bf16_limits"
        else:
            limits = [SSD_RTOL * (w.abs() + float(w.abs().max()))
                      for w in (want_y, want_st)]
            what = f"rtol {SSD_RTOL}, atol {SSD_RTOL} max|want|"
        err = share = 0.0
        for name, got, want, lim in (("y", y, want_y, limits[0]),
                                     ("states", st, want_st, limits[1])):
            gap = (got - want).abs()
            ok = bool((gap <= lim).all())
            sh = float((gap / lim.clamp_min(1e-30)).max())
            print(f"  ssd_inner {label} {name} {tuple(got.shape)}: "
                  f"max_abs_err {float(gap.max()):.3e} ({what}; largest gap "
                  f"{sh:.3f} of its limit) {'ok' if ok else 'MISMATCH'}")
            check(ok, f"ssd_inner {label} {name} disagrees with its plain "
                  f"version")
            err, share = max(err, float(gap.max())), max(share, sh)
        nbytes = sum(t.numel() * t.element_size() for t in args) + \
            4 * (y.numel() + st.numel())
        del y, st, want_y, want_st, limits
        ms = graph_ms(lambda: ssd_inner(*args), 20)
        plain_ms = cuda_ms(lambda: ssd_inner_plain(*args), 10)
        plain_graph_ms = graph_ms(lambda: ssd_inner_plain(*args), 10)
        peak = BF16_FLOP_PER_S if prefix == "" else F32_FLOP_PER_S
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / peak * 1e3
        print(f"  ssd_inner {label} {tuple(x.shape)} N={n} G={groups}: "
              f"{ms * 1e3:.2f} us/launch (graph replay), plain "
              f"{plain_ms * 1e3:.2f} us (graph replay "
              f"{plain_graph_ms * 1e3:.2f} us), bound "
              f"{max(bytes_ms, ops_ms) * 1e3:.2f} us ({flops} flop at "
              f"{peak:.3g} flop/s: {ops_ms * 1e3:.2f} us; {nbytes} bytes: "
              f"{bytes_ms * 1e3:.2f} us), {flops / (ms * 1e-3) / 1e12:.2f} "
              f"TFLOP/s")
        row.update({f"{prefix}max_abs_err": err, f"{prefix}limit_share": share,
                    f"{prefix}ms": ms, f"{prefix}plain_ms": plain_ms,
                    f"{prefix}bound_ms": max(bytes_ms, ops_ms),
                    f"{prefix}bound_by": "bytes" if bytes_ms >= ops_ms
                    else "operations", f"{prefix}library_ms": None,
                    f"{prefix}plain_graph_ms": plain_graph_ms})
    row["f32_factor"] = row["f32_ms"] / row["ms"]
    return row


def ssd_entry(row: dict, model: str) -> dict:
    """B3's ``by_shape`` entry of one row."""
    return dict({k: row[k] for k in (
        "shape", "max_abs_err", "limit_share", "ms", "plain_ms", "bound_ms",
        "bound_by", "library_ms", "f32_ms", "f32_bound_ms")}, model=model)


def rms_row(x, gamma, eps, iters: int = 200) -> dict:
    """B4 at one of a serve's shapes: held (``rms_hold``) and timed, by
    graph replay over a ring of copies of x and over one x, beside
    ``F.rms_norm``, a copy of x over the ring and the plain version.
    ``iters`` calls per timing (each keeps its output)."""
    import torch.nn.functional as F

    x2 = x.reshape(-1, x.shape[-1])
    e = rms_hold(x2, gamma, eps)
    d = x2.shape[-1]
    nbytes = 2 * x2.numel() * x2.element_size() + d * gamma.element_size()
    flops = 4 * x2.numel()
    ms = graph_ms_ring(lambda xi: rmsnorm_fused(xi, gamma, eps), x2, iters)
    library_graph_ms = graph_ms_ring(
        lambda xi: F.rms_norm(xi, (d,), gamma, eps), x2, iters)
    # the same bytes moved by PyTorch's copy kernel: what this card
    # gives one graph-replayed launch of this size
    copy_ms = graph_ms_ring(lambda xi: xi.clone(), x2, iters)
    warm_ms = graph_ms(lambda: rmsnorm_fused(x2, gamma, eps), iters)
    library_warm_graph_ms = graph_ms(
        lambda: F.rms_norm(x2, (d,), gamma, eps), iters)
    plain_ms = cuda_ms(lambda: rmsnorm_plain(x2, gamma, eps), 50)
    library_ms = cuda_ms(lambda: F.rms_norm(x2, (d,), gamma, eps), iters)
    plain_graph_ms = graph_ms(lambda: rmsnorm_plain(x2, gamma, eps), 50)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"  rmsnorm {tuple(x2.shape)}: {ms * 1e3:.2f} us/launch "
          f"(graph replay over a ring of x; one x: "
          f"{warm_ms * 1e3:.2f} us), plain {plain_ms * 1e3:.2f} us "
          f"(graph replay {plain_graph_ms * 1e3:.2f} us), F.rms_norm "
          f"{library_ms * 1e3:.2f} us (graph replay over the ring "
          f"{library_graph_ms * 1e3:.2f} us; one x "
          f"{library_warm_graph_ms * 1e3:.2f} us), bound "
          f"{bound_ms * 1e3:.2f} us ({nbytes} bytes, "
          f"{bound_ms / ms:.1%} of it; a copy of x over the ring "
          f"{copy_ms * 1e3:.2f} us); B4 / F.rms_norm "
          f"(ring) = {ms / library_graph_ms:.3f}: "
          f"{'within' if ms <= library_graph_ms else 'MISSES'} 1")
    return {"name": "rmsnorm_fused", "route": "cuda",
            "source": RMS_SOURCE, "replaces": RMS_TPU,
            "launches": 0, "max_abs_err": e, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms, "shape": list(x2.shape),
            "kernel_route": list(rms_ops.route(x2, gamma)),
            "plain_graph_ms": plain_graph_ms,
            "library_graph_ms": library_graph_ms, "warm_ms": warm_ms,
            "library_warm_graph_ms": library_warm_graph_ms,
            "copy_graph_ms": copy_ms}


def rms_entry(row: dict, model: str) -> dict:
    """B4's ``by_shape`` entry of one shape's row (with the generic
    route's time where ``rms_generic_check`` took one)."""
    return dict({k: row[k] for k in (
        "shape", "kernel_route", "ms", "library_graph_ms", "bound_ms",
        "warm_ms", "library_warm_graph_ms", "copy_graph_ms", "max_abs_err",
        "plain_ms", "library_ms", "generic_ms") if k in row}, model=model)


def route_by_width(x2) -> str:
    """The route B4 takes for aligned rows of ``x2``'s width: whole
    16-byte vectors, at most 16 per lane of a warp on the register
    route, at most 2,048 a row on the wide route; else the generic
    route."""
    row_bytes = x2.shape[-1] * x2.element_size()
    if row_bytes % 16:
        return "generic"
    vectors = row_bytes // 16
    return ("register" if vectors <= 32 * 16 else
            "wide" if vectors <= 2048 else "generic")


def shifted_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` one element off a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def rms_hold(x2, gamma, eps) -> float:
    """B4 against its plain version at one shape (one bf16 ulp), on the
    route the shape takes (``route_by_width``) and on the generic route
    (a copy of ``x`` one element off a 16-byte boundary); prints the
    routes.  Returns the largest gap to the plain version."""
    want = rmsnorm_plain(x2, gamma, eps)
    e = 0.0
    for label, xin in (("", x2), ("unaligned copy, ", shifted_copy(x2))):
        route = rms_ops.route(xin, gamma)
        got = rmsnorm_fused(xin, gamma, eps)
        torch.cuda.synchronize()
        gap = max_err(got.float(), want.float())
        n_diff = int((got != want).sum())
        ok = bool(torch.allclose(got.float(), want.float(), rtol=BF16_RTOL,
                                 atol=0.0))
        print(f"  rmsnorm {tuple(x2.shape)} {str(x2.dtype)[6:]}, {label}"
              f"{route[0]} route (kV {route[1]}, {route[2]} rows per "
              f"block): max_abs_err {gap:.3e} (rtol {BF16_RTOL:.4g}; "
              f"{n_diff} of {got.numel()} differ from the plain version) "
              f"{'ok' if ok else 'MISMATCH'}")
        check(ok, f"rmsnorm {tuple(x2.shape)} on the {route[0]} route "
              f"disagrees with its plain version")
        check(route[0] == ("generic" if label else route_by_width(x2)),
              f"rmsnorm {tuple(x2.shape)}: {label or 'aligned, '}"
              f"{route[0]} route")
        e = max(e, gap)
    return e


def rms_generic_check(x2, gamma, eps, dy2=None) -> float:
    """B4's generic route (``dy2`` None), or its backward's, at one of
    the shapes the wide routes take: each held against its plain version
    on two copies that no vector route takes, x (and dy) one element off
    a 16-byte boundary, and gamma so with x, dy and the outputs aligned
    (the generic kernels as they ran such rows before the wide routes:
    the forward's two-pass 16-byte loop, the backward's block a row);
    the second timed over a ring of x.  Returns its milliseconds."""
    shape = tuple(x2.shape)
    off_g = shifted_copy(gamma)
    if dy2 is None:
        want = rmsnorm_plain(x2, gamma, eps)
        for label, ins in (("x", (shifted_copy(x2), gamma)),
                           ("gamma", (x2, off_g))):
            route = rms_ops.route(*ins)
            got = rmsnorm_fused(*ins, eps)
            torch.cuda.synchronize()
            ok = bool(torch.allclose(got.float(), want.float(),
                                     rtol=BF16_RTOL, atol=0.0))
            gap = max_err(got.float(), want.float())
            print(f"  rmsnorm {shape}, {label} off 16 bytes: {route[0]} "
                  f"route, max_abs_err {gap:.3e} (rtol {BF16_RTOL:.4g}) "
                  f"{'ok' if ok else 'MISMATCH'}")
            check(route[0] == "generic" and ok, f"rmsnorm {shape} with "
                  f"{label} off 16 bytes: {route[0]} route, ok {ok}")
        ms = graph_ms_ring(lambda xi: rmsnorm_fused(xi, off_g, eps), x2,
                           RMS_ITERS)
    else:
        for label, ins in (("x and dy", (shifted_copy(x2), gamma,
                                         shifted_copy(dy2))),
                           ("gamma", (x2, off_g, dy2))):
            route = rms_ops.bwd_route(*ins)
            check(route[0] == "generic", f"rmsnorm_bwd {shape} with {label} "
                  f"off 16 bytes: {route[0]} route")
            print(f"  rmsnorm_bwd {shape}, {label} off 16 bytes: generic "
                  f"route")
            hold_grads(f"generic, {label} off", rmsnorm_bwd(*ins, eps),
                       lambda *t: rmsnorm_bwd_plain(*t, eps), ins)
        ms = graph_ms_ring(lambda xi: rmsnorm_bwd(xi, off_g, dy2, eps), x2,
                           50)
    print(f"  {'rmsnorm' if dy2 is None else 'rmsnorm_bwd'} {shape} on the "
          f"generic route (gamma off 16 bytes): {ms * 1e3:.2f} us/call "
          f"(graph replay over a ring of x)")
    return ms


def flash_checks(seen: dict) -> dict:
    """Phase 9: B2 against its plain version on the dense serving path's
    own inputs (the first layer's q, k and v of the prefill), in bf16 and
    float32, also at ragged lengths, and on seeded inputs at
    stablelm-1.6b's head dim of 64; time, plain and library times and
    bound at the prefill's shape; B4 at that path's shapes.  Returns the
    JSON row (the bf16 prefill; float32 figures under ``f32_*``)."""
    print("phase 9: flash attention (B2) vs plain on the card, inputs from "
          "a warm-up serve")
    keys = [k for k in seen if k[0] == "flash"]
    check(len(keys) == 1, f"the serve gave B2 shapes {keys}")
    q, k, v, causal = seen[keys[0]]
    bsz, heads, seq, hd = q.shape
    kv_heads = k.shape[1]
    check(causal and q.dtype == torch.bfloat16 and
          (bsz, heads, seq, hd) == (SERVE_BATCH, QWEN2.n_heads, PROMPT_LEN,
                                    QWEN2.hd) and kv_heads == QWEN2.n_kv_heads,
          f"B2 saw q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)}")

    def cut(t, b, s):
        return t[:b, :, :s].contiguous()

    f32 = [t.float() for t in (q, k, v)]
    gen = torch.Generator(device=q.device).manual_seed(SEED)
    hd64 = [torch.randn((2, n, PROMPT_LEN, STABLELM.hd), generator=gen,
                        device=q.device).to(torch.bfloat16)
            for n in (STABLELM.n_heads, STABLELM.n_kv_heads,
                      STABLELM.n_kv_heads)]
    cases = [("bf16", (q, k, v), True), ("float32", f32, True),
             ("bf16, S = 200", [cut(t, 2, 200) for t in (q, k, v)], True),
             ("float32, S = 200", [cut(t, 2, 200) for t in f32], True),
             ("bf16, Sq = 7, Skv = 333, non-causal",
              (cut(q, 1, 7), cut(k, 1, 333), cut(v, 1, 333)), False),
             (f"bf16, {STABLELM.name} head dim (randn)", hd64, True)]
    err = max(flash_hold(label, a, b, c, is_causal)
              for label, (a, b, c), is_causal in cases)
    row = {"name": "flash_attention", "route": "cuda",
           "source": FLASH_SOURCE, "replaces": FLASH_TPU, "launches": 0,
           "max_abs_err": err, "shape": [bsz, heads, kv_heads, seq, hd]}
    for prefix, (a, b, c) in (("", (q, k, v)), ("f32_", f32)):
        row.update({prefix + key: val
                    for key, val in flash_times(a, b, c).items()})

    for key in sorted(k for k in seen if k[0] == "rms"):
        x, gamma, eps = seen[key]
        rms_hold(x.reshape(-1, x.shape[-1]), gamma, eps)
    return row


def flash_hold(label: str, a, b, c, is_causal: bool,
               prefix_len: int = 0) -> float:
    """B2 against its plain version on q, k, v = ``a``, ``b``, ``c``
    (with the prefix-LM mask over ``prefix_len`` positions): float32 at
    ``FLASH_TOL``, bf16 at one bf16 ulp plus ``flash_bf16_atol``; returns
    the largest gap."""
    got = flash_attention(a, b, c, causal=is_causal, prefix_len=prefix_len)
    torch.cuda.synchronize()
    want = flash_attention_plain(a, b, c, causal=is_causal,
                                 prefix_len=prefix_len)
    e = max_err(got.float(), want.float())
    if a.dtype == torch.float32:
        rtol, atol, what = FLASH_TOL, FLASH_TOL, f"atol {FLASH_TOL:.4g}"
    else:
        rtol, atol = BF16_RTOL, flash_bf16_atol(a, b, c, is_causal,
                                                prefix_len)
        what = f"atol 2**-7 sum p|v|, {float(atol.min()):.3e} to " \
            f"{float(atol.max()):.3e}"
    gap = (got.float() - want.float()).abs()
    limit = atol + rtol * want.float().abs()
    ok = bool((gap <= limit).all())
    share = float((gap / limit.clamp_min(1e-30)).max())
    print(f"  flash_attention {label} q {tuple(a.shape)} k "
          f"{tuple(b.shape)}: max_abs_err {e:.3e} (rtol {rtol:.4g}, "
          f"{what}; largest gap {share:.3f} of its limit; "
          f"{int((got != want).sum())} of {got.numel()} differ) "
          f"{'ok' if ok else 'MISMATCH'}")
    check(ok, f"flash_attention {label} disagrees with its plain version")
    return e


def sdpa_backend(q, k, v, mask, is_causal: bool) -> str:
    """The backend PyTorch's SDPA picks for this call (a diagnostic
    printed beside its time; ``unknown`` where this torch's private
    chooser takes other arguments)."""
    from torch.nn.attention import SDPBackend
    names = {int(getattr(SDPBackend, n)): n for n in dir(SDPBackend)
             if n.isupper()}
    try:
        choice = torch._fused_sdp_choice(q, k, v, mask, 0.0, is_causal,
                                         scale=None, enable_gqa=True)
    except (AttributeError, TypeError, RuntimeError) as e:
        return f"unknown ({type(e).__name__})"
    return names.get(int(choice), str(choice))


def visible_pairs(sq: int, skv: int, causal: bool, prefix: int) -> int:
    """(q, k) pairs one head sees: row i sees ``min(Skv, max(i, prefix -
    1) + 1)`` keys under the causal mask, every key otherwise."""
    if not causal:
        return sq * skv
    limit = np.maximum(np.arange(sq), prefix - 1)
    return int(np.minimum(skv, limit + 1).sum())


def prefix_mask(sq: int, skv: int, prefix: int, device) -> torch.Tensor:
    """The prefix-LM mask as SDPA's boolean ``attn_mask``: key j is seen
    by row i where ``j <= max(i, prefix - 1)``."""
    rows = torch.arange(sq, device=device).clamp(min=prefix - 1)
    return torch.arange(skv, device=device)[None, :] <= rows[:, None]


def flash_times(a, b, c, causal: bool = True, prefix_len: int = 0) -> dict:
    """B2's time on q, k, v = ``a``, ``b``, ``c`` by graph replay, the
    plain version's and SDPA's (the prefix-LM mask as a boolean
    ``attn_mask``), and the bound (the function's own work: q.k and p.v
    over the visible pairs: row i sees ``min(Skv, max(i, prefix_len -
    1) + 1)`` keys under the causal mask, every key otherwise)."""
    import torch.nn.functional as F

    bsz, heads, seq, hd = a.shape
    skv = b.shape[2]
    flops = 4 * hd * bsz * heads * visible_pairs(seq, skv, causal,
                                                 prefix_len)
    nbytes = (2 * a.numel() + b.numel() + c.numel()) * a.element_size()
    ms = graph_ms(lambda: flash_attention(a, b, c, causal=causal,
                                          prefix_len=prefix_len), 20)
    plain_ms = cuda_ms(lambda: flash_attention_plain(
        a, b, c, causal=causal, prefix_len=prefix_len), 10)
    mask = prefix_mask(seq, skv, prefix_len, a.device) if prefix_len \
        else None

    def sdpa():
        if mask is None:
            return F.scaled_dot_product_attention(a, b, c, is_causal=causal,
                                                  enable_gqa=True)
        return F.scaled_dot_product_attention(a, b, c, attn_mask=mask,
                                              enable_gqa=True)

    backend = sdpa_backend(a, b, c, mask, causal and mask is None)
    library_ms = cuda_ms(sdpa, 20)
    library_graph_ms = graph_ms(sdpa, 20)
    # bf16 runs on the tensor cores, float32 on the FMA pipe
    peak = BF16_FLOP_PER_S if a.dtype == torch.bfloat16 else F32_FLOP_PER_S
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / peak * 1e3
    print(f"  flash_attention {str(a.dtype)[6:]} {tuple(a.shape)} / "
          f"{tuple(b.shape)}{'' if causal else ' non-causal'}"
          f"{f', prefix {prefix_len}' if prefix_len else ''}: "
          f"{ms * 1e3:.2f} us/launch (graph replay), "
          f"plain {plain_ms * 1e3:.2f} us, SDPA ({backend}"
          f"{', boolean mask' if mask is not None else ''}) "
          f"{library_ms * 1e3:.2f} "
          f"us (graph replay {library_graph_ms * 1e3:.2f} us), bound "
          f"{max(bytes_ms, ops_ms) * 1e3:.2f} us ({flops} "
          f"flop at {peak:.3g} flop/s: {ops_ms * 1e3:.2f} us; {nbytes} "
          f"bytes: {bytes_ms * 1e3:.2f} us), "
          f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s")
    out = {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": library_ms, "library_graph_ms": library_graph_ms,
           "sdpa_backend": backend}
    if a.dtype == torch.bfloat16:
        factor = ms / library_graph_ms
        print(f"  bf16 B2 / SDPA (graph replay) = {factor:.3f}: "
              f"{'within' if factor <= FLASH_SDPA_FACTOR else 'MISSES'}"
              f" {FLASH_SDPA_FACTOR}x")
        out["sdpa_factor"] = factor
    return out


def serve_path(cfg, model, cuda, phase: int, **scfg) -> dict:
    """Phases 7, 10, 14, 18, 19 and 21: a serving path (``scfg``: more
    ServeConfig fields), counted and timed, then profiled.  For the
    enc-dec family the encoder's share of the prefill is timed apart
    (``encode_s``, inside ``prefill_s``)."""
    n_layers, plen = cfg.n_layers, prompt_len(cfg)
    kernels, per_prefill, per_step = serve_launches(cfg)
    names = [k.__name__ for k in kernels]
    print(f"phase {phase}: serve {cfg.name} ({n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab}), {SERVE_BATCH} requests "
          f"x {plen} prompt tokens"
          + (f" after {image_tokens(cfg)} image tokens" if image_tokens(cfg)
             else "") + f", {NEW_TOKENS} new tokens, greedy"
          + "".join(f", {k} {v}" for k, v in scfg.items()))
    torch.cuda.reset_peak_memory_stats()   # the serve's own peak
    eng = serve_engine(cfg, model, cuda, **scfg)
    reqs, extra = serve_inputs(cfg)
    encode_s = []
    real_encode = model_encdec.encode

    def timed_encode(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_encode(*args)
        torch.cuda.synchronize()
        encode_s.append(time.perf_counter() - t0)
        return out

    for k in kernels:
        k.launches = 0
    ssd_inner.bf16_launches = 0
    model_encdec.encode = timed_encode
    try:
        t0 = time.perf_counter()
        out = eng.run(reqs, seed=SEED, extra=extra)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        model_encdec.encode = real_encode
    counts = dict(zip(names, launch_counts(kernels)))
    steps = eng._step.times
    check(len(eng._prefill.times) == 1 and len(steps) == NEW_TOKENS,
          f"{len(eng._prefill.times)} prefills, {len(steps)} decode steps")
    want = {n: a + NEW_TOKENS * b
            for n, a, b in zip(names, per_prefill, per_step)}
    check(counts == want, f"serve launches {counts}, want {want}")
    if ssd_inner in kernels:
        n_ssd = per_prefill[kernels.index(ssd_inner)]
        check(ssd_inner.bf16_launches == n_ssd, f"{ssd_inner.bf16_launches}"
              f" of {n_ssd} B3 launches on the tensor-core route")
    toks = [t for r in out for t in r.out_tokens]
    check(len(toks) == SERVE_BATCH * NEW_TOKENS and
          all(0 <= t < cfg.vocab for t in toks),
          "served tokens out of range or missing")
    prefill_s = eng._prefill.times[0]
    step_s = float(np.mean(steps))
    stats = {"prefill_s": prefill_s, "decode_step_s": step_s,
             "decode_step_min_s": float(np.min(steps)),
             "decode_step_max_s": float(np.max(steps)),
             "decode_tok_per_s": SERVE_BATCH / step_s,
             "prefill_tok_per_s": SERVE_BATCH * plen / prefill_s,
             "run_s": run_s, "launches": counts,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if image_tokens(cfg):          # the image positions the prefill also runs
        stats["prefill_positions_per_s"] = \
            SERVE_BATCH * (plen + image_tokens(cfg)) / prefill_s
    if cfg.family == Family.ENCDEC:
        check(len(encode_s) == 1, f"{len(encode_s)} encoder runs")
        stats["encode_s"] = encode_s[0]
    print(f"  prefill_s {prefill_s:.6f} ({stats['prefill_tok_per_s']:.1f} "
          f"prompt tok/s"
          + (f"; encode_s {encode_s[0]:.6f} of it" if encode_s else "")
          + (f"; {stats['prefill_positions_per_s']:.1f} positions/s with "
             f"the {image_tokens(cfg)} image tokens" if image_tokens(cfg)
             else "")
          + f"), decode_step_s {step_s:.6f} (min "
          f"{stats['decode_step_min_s']:.6f}, max "
          f"{stats['decode_step_max_s']:.6f}), decode_tok_per_s "
          f"{stats['decode_tok_per_s']:.1f}, run {run_s:.4f} s, launches "
          f"{counts} (per prefill {'/'.join(map(str, per_prefill))}, per "
          f"decode step {'/'.join(map(str, per_step))}), peak "
          f"memory {stats['peak_mem_gb']:.2f} GB")
    print(f"  req0 tokens: {out[0].out_tokens[:12]}")
    if eng.policy_decisions:
        stats["kv_transfer"] = [[n, m.value]
                                for n, m in eng.policy_decisions]
        print(f"  KV transfer ({scfg.get('comm_policy')}): "
              + ", ".join(f"{n} bytes -> {m.value}"
                          for n, m in eng.policy_decisions))
    prof = serve_engine(cfg, model, cuda, profile=True, **scfg)
    reqs, extra = serve_inputs(cfg)
    prof.run(reqs, seed=SEED, extra=extra)
    for label in ("prefill", "decode step"):
        got = PROFILES.get(f"{cfg.name} {label}", {})
        stats[f"{label.split()[0]}_idle_share"] = got.get("idle_share")
        stats[f"{label.split()[0]}_busy_s"] = got.get("busy_s")
        stats[f"{label.split()[0]}_device_events"] = got.get("events")
    return stats


def cpu_compare(cfg, cuda) -> None:
    """Phases 8 and 11: the same seeded model on the CPU, last-token
    prefill logits against the card's, at full depth and at 2 layers.

    float32 is held at ``LOGITS_F32_TOL``.  bf16 is held at the tests'
    ``LOGITS_BF16_TOL`` at full width and 2 layers, the depth at which the
    tests hold it.  At full depth the bf16 model's own rounding error
    against float32 can be of the order of the logits themselves (so it
    is for mamba2-130m at 24 layers, in the reference as in the port:
    tests/test_torch_mamba2.py::
    test_bf16_spread_grows_with_depth_like_reference), and two bf16 runs
    that sum in other orders can differ by nearly as much as either
    differs from float32 (so they do for qwen2-1.5b at 28 layers:
    tests/test_torch_transformer.py::
    test_bf16_rounding_spread_grows_with_depth).  So there the card's
    bf16 logits must be no farther from the CPU's float32 ones than
    ``BF16_ACCURACY_RATIO`` times the CPU's bf16 ones are, in the largest
    and in the mean absolute difference, and pick the CPU bf16 run's
    argmax; for the models in ``BF16_SPREAD_SHARE`` they must also lie
    within that share of the CPU's bf16 vs float32 spread from the CPU's
    bf16 logits."""
    toks = torch.from_numpy(np.array(
        prompts(cfg.vocab, CPU_BATCH, CPU_PROMPT, 1)))

    def last_logits(cfg, dev):
        model = model_registry.init_params(cfg, SEED, dev)
        state = model_registry.make_decode_state(cfg, CPU_BATCH, CPU_PROMPT,
                                                 device=dev)
        lg, _ = model_registry.prefill(model, {"tokens": toks.to(dev)}, cfg,
                                       state)
        return lg[:, -1, :cfg.vocab].float().cpu()

    def mean_err(a, b):
        return float((a - b).abs().mean())

    logits = {}
    for n_layers in (cfg.n_layers, 2):
        for dtype in (torch.float32, torch.bfloat16):
            for where, dev in (("card", cuda), ("cpu", torch.device("cpu"))):
                if n_layers == 2 and (where, dtype) == ("card", torch.float32):
                    continue
                t0 = time.perf_counter()
                logits[n_layers, where, dtype] = last_logits(
                    cfg.scaled(n_layers=n_layers, dtype=dtype), dev)
                print(f"  {where} {str(dtype)[6:]} prefill, {n_layers} "
                      f"layers: {time.perf_counter() - t0:.2f} s (with init)")
    full = cfg.n_layers
    card, host = logits[full, "card", torch.float32], \
        logits[full, "cpu", torch.float32]
    check(bool(torch.isfinite(card).all()), "non-finite logits on the card")
    err = max_err(card, host)
    ok = bool(torch.allclose(card, host, rtol=LOGITS_F32_TOL,
                             atol=LOGITS_F32_TOL))
    print(f"  float32, {full} layers: logits max_abs_err {err:.3e} (max "
          f"|logit| {float(host.abs().max()):.3f}; rtol = atol = "
          f"{LOGITS_F32_TOL}) {'ok' if ok else 'MISMATCH'}")
    check(ok, "card and CPU logits disagree in float32")

    bf_card, bf_host = logits[full, "card", torch.bfloat16], \
        logits[full, "cpu", torch.bfloat16]
    err, spread = max_err(bf_card, bf_host), max_err(bf_host, host)
    err_mean, spread_mean = mean_err(bf_card, bf_host), mean_err(bf_host, host)
    acc, acc_mean = max_err(bf_card, host), mean_err(bf_card, host)
    same = bool((bf_card.argmax(-1) == bf_host.argmax(-1)).all())
    share = BF16_SPREAD_SHARE.get(cfg.name)
    ok = (acc <= BF16_ACCURACY_RATIO * spread
          and acc_mean <= BF16_ACCURACY_RATIO * spread_mean and same
          and bool(torch.isfinite(bf_card).all()))
    if share is not None:
        ok = ok and err <= share * spread and err_mean <= share * spread_mean
    print(f"  bfloat16, {full} layers: card vs CPU max_abs_err {err:.3e} "
          f"(mean {err_mean:.3e}); CPU bf16 vs float32 {spread:.3e} (mean "
          f"{spread_mean:.3e}): shares {err / spread:.3f} and "
          f"{err_mean / spread_mean:.3f} (limit {share}); card bf16 vs "
          f"float32 {acc:.3e} (mean {acc_mean:.3e}): ratios "
          f"{acc / spread:.3f} and {acc_mean / spread_mean:.3f} (limit "
          f"{BF16_ACCURACY_RATIO}); argmax "
          f"{'same' if same else 'DIFFERS'} {'ok' if ok else 'MISMATCH'}")
    check(ok, f"card and CPU logits disagree in bf16 at {full} layers")

    bf_card, bf_host = logits[2, "card", torch.bfloat16], \
        logits[2, "cpu", torch.bfloat16]
    err = max_err(bf_card, bf_host)
    ok = bool(torch.allclose(bf_card, bf_host, rtol=LOGITS_BF16_TOL,
                             atol=LOGITS_BF16_TOL))
    print(f"  bfloat16, 2 layers: card vs CPU max_abs_err {err:.3e} (mean "
          f"{mean_err(bf_card, bf_host):.3e}; rtol = atol = "
          f"{LOGITS_BF16_TOL}); CPU bf16 vs float32 "
          f"{max_err(bf_host, logits[2, 'cpu', torch.float32]):.3e} "
          f"{'ok' if ok else 'MISMATCH'}")
    check(ok, "card and CPU logits disagree in bf16 at 2 layers")


# ----------------------------------------------------------- phase 12
#: fig8's Piz-Daint rows that phase 12 drives, as
#: ``repro_torch.benchmarks.fig8_microbench.run`` defines the machine:
#: 1,024 ranks over 6 of 12 groups, SimParams(seed=0, max_flows=60,000),
#: planned phases, arms ADAPTIVE_0, ADAPTIVE_3 and "app_aware"
PROTOCOL_ROWS = {"allreduce": dict(elements=262144),
                 "alltoall": dict(size_per_pair=65536)}
PROTOCOL_ITERS = 8
PROTOCOL_MAX_FLOWS = 60_000
#: the card-vs-CPU check's iterations per row
PROTOCOL_CPU_ITERS = {"allreduce": 2, "alltoall": 1}
#: fig8's DAINT machine (None); rehearsals pass a small spec
PROTOCOL_TOPOLOGY = None
#: the adaptive arm (fig8's default policy)
POLICY_ARM = "app_aware"


def protocol_setup(cuda, bench: str):
    """fig8's machine, allocation and phases for one row, a fresh
    seed-0 simulator on the card and an engine for the adaptive arm."""
    topo = bench_topology(PROTOCOL_TOPOLOGY, DAINT)
    n_ranks = min(1024, topo.n_nodes)
    sim = DragonflySimulator(topo, SimParams(
        seed=0, max_flows=PROTOCOL_MAX_FLOWS), device=cuda)
    alloc = make_allocation(topo, n_ranks, spread=group_spread(topo, 6),
                            seed=0)
    phases = traffic.PATTERNS[bench](n_ranks, **PROTOCOL_ROWS[bench])
    return sim, alloc, phases, traffic.engine_for_arm(POLICY_ARM, sim)


def engine_iteration(sim, alloc, phases, engine, bench: str):
    return traffic.run_iteration_engine(
        sim, alloc, phases, engine, site=bench,
        kind=traffic.PATTERN_KIND[bench], use_plans=True)


def protocol_kernel_checks(cuda, n_links: int) -> tuple:
    """B1 against its plain versions at the protocol's shapes, with the
    modes Algorithm 1 chose: the last phase of two app-aware iterations
    of each row (an allreduce phase of 1,024 flows; the alltoall's
    subsampled phase, whose NIC ids crowd onto the allocation's links),
    rebuilt on the probe simulator that ran them.  Returns the sorted
    and scatter forms' largest errors."""
    errs = (0.0, 0.0)
    for bench in PROTOCOL_ROWS:
        sim, alloc, phases, engine = protocol_setup(cuda, bench)
        seen = []
        with trace_protocol(DragonflySimulator, PolicyEngine,
                            on_phase=lambda s, a, k, r: seen.append((a, k))):
            for _ in range(2):
                engine_iteration(sim, alloc, phases, engine, bench)
        args, kwargs = seen[-1]
        check(kwargs.get("modes") is not None and kwargs.get("plan")
              is not None, f"{bench}: the phase carried no modes or plan")
        x = torch_backend._prepare_inputs(sim, sim._phase_begin(*args,
                                                                **kwargs))
        modes = ", ".join(f"{m} x {n}" for m, n in
                          mode_counts(kwargs["modes"]))
        lens = x["seg_off"][1:] - x["seg_off"][:-1]
        print(f"  {bench} phase: {x['nic_ids'].shape[0]} NIC ids, modes "
              f"{modes}; P = {x['p_sorted']} sorted pairs over "
              f"{int((lens > 0).sum())} links (at most {int(lens.max())} "
              f"on one), {x['pair_links'].shape[0] - x['p_sorted']} tail "
              f"pairs")
        errs = tuple(max(e, f) for e, f in zip(
            errs, b1_holds(x, n_links, f"{bench} ")))
    return errs


@contextlib.contextmanager
def protocol_timers(want: tuple):
    """Wall time per arm of the protocol's iterations and, from
    ``trace_protocol``'s records, of the ``engine.decide`` and
    ``run_phase`` calls inside them (the recording's own time taken
    out); every phase's B1 launches are checked against ``want`` (a
    planned phase's)."""
    stats: dict = {}
    saved = (traffic.run_iteration, traffic.run_iteration_engine)
    last = [launches()]

    def timed(fn, label_of):
        def iteration(sim, alloc, phases, arm, **kw):
            st = stats.setdefault(label_of(arm), dict.fromkeys(
                ("iters", "phases", "wall_s", "decide_s", "run_phase_s"), 0))
            first = len(trace.phases)
            t0 = time.perf_counter()
            res = fn(sim, alloc, phases, arm, **kw)
            wall = time.perf_counter() - t0
            recs = trace.phases[first:]
            st["wall_s"] += wall - sum(r.trace_s for r in recs)
            st["iters"] += 1
            st["phases"] += len(recs)
            st["decide_s"] += sum(r.decide_s for r in recs)
            st["run_phase_s"] += sum(r.run_phase_s for r in recs)
            return res
        return iteration

    def check_launches(sim, args, kwargs, res):
        now = launches()
        got = tuple(a - b for a, b in zip(now, last[0]))
        last[0] = now
        check(got == want, f"protocol phase: launches {got}, want {want}")

    traffic.run_iteration = timed(saved[0], lambda pol: MODE_LABEL[pol.mode])
    traffic.run_iteration_engine = timed(
        saved[1], lambda eng: MODE_LABEL[POLICY_ARM])
    try:
        with trace_protocol(DragonflySimulator, PolicyEngine,
                            on_phase=check_launches) as trace:
            yield stats
    finally:
        traffic.run_iteration, traffic.run_iteration_engine = saved


def protocol_path(cuda, want: tuple) -> dict:
    """Phase 12: fig8's two rows on the card, every phase's B1 launches
    checked; per row and arm the median time, the normalised median,
    Algorithm 1's share of default-routed traffic, wall seconds per
    iteration and the shares of it in decide() and run_phase()."""
    out = {}
    for bench, args in PROTOCOL_ROWS.items():
        with protocol_timers(want) as stats:
            t0 = time.perf_counter()
            (key, row), = fig8.run(
                "daint", iters=PROTOCOL_ITERS, seed=0,
                max_flows=PROTOCOL_MAX_FLOWS, policy=POLICY_ARM,
                topology=PROTOCOL_TOPOLOGY, sweep={bench: [args]},
                device=cuda).items()
            wall = time.perf_counter() - t0
        print(f"  fig8.{key}: {wall:.2f} s wall, {PROTOCOL_ITERS} "
              f"iterations x 3 arms, policy_pct_default_traffic "
              f"{row['policy_pct_default_traffic']:.1f}")
        for label, st in stats.items():
            med = row["default_median_us"] * row[label]["norm_median"]
            per_iter = st["wall_s"] / st["iters"]
            st.update(median_time_us=med,
                      norm_median=row[label]["norm_median"],
                      wall_s_per_iter=per_iter,
                      decide_share=st["decide_s"] / st["wall_s"],
                      run_phase_share=st["run_phase_s"] / st["wall_s"])
            print(f"    {label:9s} median time_us {med:.3f} norm "
                  f"{row[label]['norm_median']:.4f}; {per_iter:.4f} s per "
                  f"iteration ({st['phases'] // st['iters']} phases), "
                  f"decide {st['decide_share']:.4f}, run_phase "
                  f"{st['run_phase_share']:.4f} of it")
            check(np.isfinite(med) and med > 0, f"fig8.{key}.{label}: {med}")
        out[key] = dict(row=row, wall_s=wall, arms=stats)
    return out


def protocol_profile(cuda) -> None:
    """One app-aware alltoall iteration under ``torch.profiler`` (after a
    warm-up iteration that builds its plan): the device idle share."""
    sim, alloc, phases, engine = protocol_setup(cuda, "alltoall")
    engine_iteration(sim, alloc, phases, engine, "alltoall")
    device_profile(lambda: engine_iteration(sim, alloc, phases, engine,
                                            "alltoall"),
                   "appaware alltoall iteration")


def protocol_cpu_check(cuda) -> None:
    """The same seeded rows on the CPU and on the card: the card's run is
    anchored to the CPU's carried state before each phase
    (``repro_torch.benchmarks.parity``); generators in lockstep, the
    state the card's own update leaves before each phase, phase times
    and the rows' median times at rtol 2e-2, modes per phase under the
    tie rule.  (How soon two free runs part is
    ``scripts/protocol_drift.py``'s measurement.)"""
    for bench, args in PROTOCOL_ROWS.items():
        def run(device):
            return fig8.run("daint", iters=PROTOCOL_CPU_ITERS[bench], seed=0,
                            max_flows=PROTOCOL_MAX_FLOWS, policy=POLICY_ARM,
                            topology=PROTOCOL_TOPOLOGY,
                            sweep={bench: [args]}, device=device)

        t0 = time.perf_counter()
        with trace_protocol(DragonflySimulator, PolicyEngine,
                            record_state=True) as cpu_trace:
            (key, want), = run("cpu").items()
        cpu_s = time.perf_counter() - t0
        with trace_protocol(DragonflySimulator, PolicyEngine,
                            anchor=cpu_trace) as card_trace:
            got = run(cuda)[key]
        n = len(cpu_trace.phases)
        try:
            compared = compare_traces(cpu_trace, card_trace, CPU_RTOL)
        except AssertionError as err:
            check(False, f"card vs CPU, fig8.{key}: {err}")
        check(compared >= n / 2, f"card vs CPU, fig8.{key}: {compared} of "
              f"{n} phases compared")
        worst = max(abs(b.phase_time_us / a.phase_time_us - 1)
                    for a, b in zip(cpu_trace.phases[:compared],
                                    card_trace.phases[:compared]))
        print(f"  fig8.{key}: CPU run {cpu_s:.2f} s; anchored card run: "
              f"{compared} of {n} phases compared (carried state "
              f"included), phase_time_us max rel diff {worst:.3e} "
              f"(rtol {CPU_RTOL})")
        if compared == n:
            for label in ("default", "highbias", MODE_LABEL[POLICY_ARM]):
                a = want["default_median_us"] * want[label]["norm_median"]
                b = got["default_median_us"] * got[label]["norm_median"]
                print(f"    {label:9s} median time_us card {b:.3f} cpu "
                      f"{a:.3f}")
                check(bool(np.isclose(b, a, rtol=CPU_RTOL, atol=0.0)),
                      f"card vs CPU, fig8.{key}.{label}: {b} vs {a}")
            check(got["policy_pct_default_traffic"]
                  == want["policy_pct_default_traffic"],
                  f"card vs CPU, fig8.{key}: policy_pct_default_traffic")


# ----------------------------------------------------------- phase 13
#: the interference matrix's first column (``halo3d-vs-alltoall``, its
#: published ranks 64 and 96, the victim arms adaptive, minimal and
#: app_aware, ``SimParams(seed=7, bg_enable=False)``) on the default Aries
#: machine (None: ``TopologyParams(n_groups=12)``; rehearsals pass a
#: small spec)
TENANCY_TOPOLOGY = None
TENANCY_SEED = 7
TENANCY_ROUNDS = 8
#: rounds of the batched-vs-sequential check
TENANCY_CHECK_ROUNDS = 3
#: batched vs sequential on the card, per cell: the same draws; only the
#: scatter form's atomic order differs
BATCH_RTOL = 1e-4
#: the published interference matrix, held against the committed
#: reference output (read as data) at the jax engine's JAX_RTOL
INTERFERENCE_JSON = ROOT / "BENCH_interference.json"
INTERFERENCE_ROUNDS, INTERFERENCE_SCALE = 8, 1.0


def tenancy_column():
    """(machine, mix, params, cells) of the column."""
    topo = bench_topology(TENANCY_TOPOLOGY, TopologyParams(n_groups=N_GROUPS))
    mix = interference_matrix.make_mixes(1.0)[0]
    params = SimParams(seed=TENANCY_SEED, bg_enable=False)
    cells = [mix.with_victim_arm(arm)
             for arm in interference_matrix.ARMS.values()]
    return topo, mix, params, cells


def column_steps(cuda) -> list:
    """The column's cells as the lockstep driver runs them: one
    ``_run_steps`` generator each, on a fresh engine and simulator."""
    topo, _, params, cells = tenancy_column()
    gens = []
    for cell in cells:
        eng = InterferenceEngine(topo, params, seed=TENANCY_SEED,
                                 device=cuda)
        gens.append(eng._run_steps(
            cell.workloads, cell.materialize(topo, seed=TENANCY_SEED),
            TENANCY_ROUNDS, topo=topo))
    return gens


def sorted_layout(x: dict, n_seg: int) -> dict:
    """A batch ``x`` whose pairs are all unsorted (planless phases) with
    a sorted head added: its in-range pairs ordered by id over the
    ``n_seg`` segments, so that the sorted form runs at the batched
    shape; the original pairs stay as the tail."""
    pl, fc = x["pair_links"][x["p_sorted"]:], x["pair_fc"][x["p_sorted"]:]
    keep = pl < n_seg
    ids = pl[keep].long()
    order = torch.argsort(ids, stable=True)
    off = torch.zeros(n_seg + 1, dtype=torch.int64, device=ids.device)
    off[1:] = torch.cumsum(torch.bincount(ids, minlength=n_seg), 0)
    return dict(x, pair_links=torch.cat([pl[keep][order], pl]),
                pair_fc=torch.cat([fc[keep][order], fc]),
                seg_off=off.to(torch.int32), p_sorted=int(keep.sum()))


def b1_batched_times(x: dict, n_seg: int) -> dict:
    """B1 at the batched shape by graph replay: the sorted form over the
    sorted head, the scatter form over the batch's pairs (5 of a
    dispatch's 6 launches) and over its NIC ids; the plain versions',
    ``Tensor.index_add_``'s (by graph replay) and the bounds."""
    b = b1_parts(x)
    out = torch.zeros(n_seg, device=b["vals"].device)
    seg_off, head = x["seg_off"], b["head"]
    n_sorted = head.shape[0]
    nonempty = int((seg_off[1:] > seg_off[:-1]).sum())
    rows = {}
    for key, name, kernel, plain, ids, vals, nbytes, n_pairs in (
            ("segment_sum_sorted", "sorted head",
             lambda: segment_sum_sorted(head, seg_off, out),
             lambda: segment_sum_sorted_plain(head, seg_off, out),
             None, head,
             4 * n_sorted + 4 * (n_seg + 1) + 8 * nonempty, n_sorted),
            ("segment_sum_scatter", "scatter pairs",
             lambda: segment_sum_scatter(b["tail"], b["tail_ids"], out),
             lambda: segment_sum_scatter_plain(b["tail"], b["tail_ids"],
                                               out),
             b["tail_ids"], b["tail"], None, b["tail"].shape[0]),
            ("segment_sum_scatter", "scatter NIC ids",
             lambda: segment_sum_scatter(b["nic_vals"], b["nic_ids"], out),
             lambda: segment_sum_scatter_plain(b["nic_vals"], b["nic_ids"],
                                               out),
             b["nic_ids"], b["nic_vals"], None, b["nic_ids"].shape[0])):
        if ids is not None:
            keep = (ids >= 0) & (ids < n_seg)
            in_ids, in_vals = ids[keep].long(), vals[keep]
            touched = int((torch.bincount(in_ids, minlength=n_seg) > 0)
                          .sum())
            nbytes = 8 * ids.shape[0] + 8 * touched
        else:
            in_ids = torch.repeat_interleave(
                torch.arange(n_seg, device=out.device),
                (seg_off[1:] - seg_off[:-1]).long(), output_size=n_sorted)
            in_vals = head
        ms = graph_ms(kernel, 200)
        plain_ms = cuda_ms(plain, 20)
        library_ms = graph_ms(lambda: out.index_add_(0, in_ids, in_vals),
                              200)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_pairs / F32_FLOP_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        print(f"  {name} at {n_seg} segments, {n_pairs} pairs: "
              f"{ms * 1e3:.2f} us/launch (graph replay), plain "
              f"{plain_ms * 1e3:.2f} us, Tensor.index_add_ "
              f"{library_ms * 1e3:.2f} us (graph replay), bound "
              f"{bound_ms * 1e3:.2f} us ({nbytes} bytes)")
        prefix = "batched_nic_" if "NIC" in name else "batched_"
        rows.setdefault(key, {})
        rows[key].update({
            f"{prefix}segments": n_seg, f"{prefix}pairs": n_pairs,
            f"{prefix}ms": ms, f"{prefix}plain_ms": plain_ms,
            f"{prefix}bound_ms": bound_ms,
            f"{prefix}bound_by": "bytes" if bytes_ms >= ops_ms
            else "operations",
            f"{prefix}library_ms": library_ms,
            f"{prefix}library_call": "Tensor.index_add_"})
    return rows


def tenancy_kernel_checks(cuda, n_links: int) -> tuple:
    """B1 at the lockstep round's batched shape: one round's batch of the
    column, its launches per dispatch against one phase's, both forms
    held against the plain versions' float64 sums and timed.  Returns
    (the forms' largest errors, per-kernel row additions)."""
    gens = column_steps(cuda)
    reqs = [g.send(None) for g in gens]
    batch = [(sim, sim._phase_begin(**kw)) for sim, kw in reqs]
    sigs = {torch_backend.batch_signature(sim, ctx) for sim, ctx in batch}
    check(len(sigs) == 1, f"the column's phases split into {len(sigs)} "
          "groups")
    x = torch_backend.prepare_batch(batch)
    n_seg = len(batch) * n_links
    print(f"  one round: {len(batch)} cells x "
          f"{batch[0][1]['safe'].shape[0]} flows, "
          f"{x['pair_links'].shape[0]} pairs (padded) over {n_seg} "
          f"segments")
    before = launches()
    torch_backend.fixed_point_torch(*batch[0])
    one = tuple(a - b for a, b in zip(launches(), before))
    before = launches()
    torch_backend.fixed_point_torch_batch(batch)
    got = tuple(a - b for a, b in zip(launches(), before))
    print(f"  launches sorted/scatter: one phase {one[0]}/{one[1]}, the "
          f"batched dispatch of {len(batch)} {got[0]}/{got[1]}")
    check(got == one and sum(one) > 0,
          f"batched dispatch launched {got}, one phase {one}")
    xs = sorted_layout(x, n_seg)
    errs = b1_holds(xs, n_seg, "batched ")
    return errs, b1_batched_times(xs, n_seg)


def tenancy_batch_check(cuda) -> float:
    """The same seeded column through run_phase_batch and through
    sequential run_phase, TENANCY_CHECK_ROUNDS rounds; per cell t_us
    within BATCH_RTOL.  Returns the largest relative gap."""
    batched, sequential = column_steps(cuda), column_steps(cuda)
    res_b = res_s = [None] * len(batched)
    worst = 0.0
    for r in range(TENANCY_CHECK_ROUNDS):
        req_b = [g.send(x) for g, x in zip(batched, res_b)]
        req_s = [g.send(x) for g, x in zip(sequential, res_s)]
        res_b = run_phase_batch(req_b)
        res_s = [sim.run_phase(**kw) for sim, kw in req_s]
        for i, (a, b) in enumerate(zip(res_b, res_s)):
            check(np.array_equal(a.flits, b.flits),
                  f"round {r} cell {i}: flits differ batched vs sequential")
            gap = float(np.max(np.abs(a.t_us - b.t_us) / np.abs(b.t_us)))
            worst = max(worst, gap)
            check(bool(np.allclose(a.t_us, b.t_us, rtol=BATCH_RTOL,
                                   atol=0.0)),
                  f"round {r} cell {i}: t_us batched vs sequential, "
                  f"largest relative gap {gap:.3e} (rtol {BATCH_RTOL})")
    print(f"  batched vs sequential run_phase, {TENANCY_CHECK_ROUNDS} "
          f"rounds x {len(batched)} cells: t_us largest relative gap "
          f"{worst:.3e} (rtol {BATCH_RTOL})")
    return worst


def tenancy_column_timed(cuda) -> dict:
    """The column through the port's sweep, TENANCY_ROUNDS rounds plus
    each tenant's run-alone baselines, in turns: lockstep, sequential,
    sequential, lockstep (B1's launches counted from 0 over the first
    lockstep run: the tenancy path's own); wall seconds of each run, the
    ratio of the sums, dispatches per round; records held at CPU_RTOL."""
    topo, mix, params, _ = tenancy_column()
    n_cells = len(interference_matrix.ARMS)
    # lockstep rounds: the mix's, then each tenant's baselines'
    n_rounds = TENANCY_ROUNDS * (1 + len(mix))
    out = {"lockstep": {"wall_s": []}, "sequential": {"wall_s": []}}
    recs = {}
    for lockstep in (True, False, False, True):
        label = "lockstep" if lockstep else "sequential"
        first = label not in recs
        if lockstep and first:
            segment_sum_sorted.launches = 0
            segment_sum_scatter.launches = 0
        before = dict(torch_backend.PIPELINE_CALLS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = sweep(topo, [mix], interference_matrix.ARMS, params=params,
                    rounds=TENANCY_ROUNDS, seed=TENANCY_SEED, device=cuda,
                    lockstep=lockstep)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        calls = {k: torch_backend.PIPELINE_CALLS[k] - before[k]
                 for k in before}
        recs.setdefault(label, rec)
        out[label]["wall_s"].append(wall)
        out[label].update(dispatches=calls, dispatches_per_round=sum(
            calls.values()) / n_rounds)
        if lockstep and first:
            out["launches"] = launches()
            check(out["launches"] == (0, 6 * n_rounds),
                  f"tenancy lockstep launches {out['launches']}, want "
                  f"(0, {6 * n_rounds}): 6 scatter sums per planless "
                  "dispatch")
        want = {"single": 0, "batched": n_rounds} if lockstep \
            else {"single": n_cells * n_rounds, "batched": 0}
        check(calls == want, f"{label} dispatches {calls}, want {want}")
        print(f"  column {mix.name}, {n_cells} cells, {TENANCY_ROUNDS} "
              f"rounds + baselines ({n_rounds} rounds): {label} "
              f"{wall:.3f} s wall, dispatches {calls} "
              f"({out[label]['dispatches_per_round']:g} per round)")
    ratio = sum(out["sequential"]["wall_s"]) / sum(out["lockstep"]["wall_s"])
    out["sequential_over_lockstep"] = ratio
    print(f"  sequential / lockstep wall, summed over both turns: "
          f"{ratio:.3f}; B1 launches on the first lockstep run "
          f"sorted/scatter {out['launches'][0]}/{out['launches'][1]}")
    worst = 0.0
    for a, b in zip(recs["lockstep"], recs["sequential"]):
        for key in ("victim_time_us", "victim_alone_us", "victim_slowdown"):
            gap = abs(a[key] / b[key] - 1)
            worst = max(worst, gap)
            check(gap <= CPU_RTOL, f"lockstep vs sequential {a['policy']}."
                  f"{key}: {a[key]} vs {b[key]}")
        print(f"    {a['policy']:9s} victim_slowdown {a['victim_slowdown']:.4f}"
              f" (sequential {b['victim_slowdown']:.4f}), victim_time_us "
              f"{a['victim_time_us']:.3f}")
    out["records_max_rel_gap"] = worst
    return out


def tenancy_profile(cuda) -> None:
    """One lockstep round of the column under ``torch.profiler`` (its
    second round, after one that builds nothing the profiled one reuses
    but warms the path): the device idle share."""
    gens = column_steps(cuda)
    reqs = [g.send(None) for g in gens]
    res = run_phase_batch(reqs)
    reqs = [g.send(r) for g, r in zip(gens, res)]
    device_profile(lambda: run_phase_batch(reqs), "tenancy lockstep round")


def published_interference(cuda) -> dict:
    """interference_matrix.run(8, 1.0, seed=7) on the card in lockstep,
    every cell and the checks held against BENCH_interference.json."""
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        doc = interference_matrix.run(INTERFERENCE_ROUNDS,
                                      INTERFERENCE_SCALE,
                                      seed=TENANCY_SEED, device=cuda)
    wall = time.perf_counter() - t0
    doc = json.loads(json.dumps(doc))           # as the JSON file holds it
    want = json.loads(INTERFERENCE_JSON.read_text())
    diffs, worst = differences(doc, want)
    n_cells = sum(len(row) for row in doc["matrix"].values())
    print(f"  interference_matrix.run({INTERFERENCE_ROUNDS}, "
          f"{INTERFERENCE_SCALE}, seed={TENANCY_SEED}): {wall:.2f} s wall, "
          f"{n_cells} cells; against {INTERFERENCE_JSON.name}: "
          f"{len(diffs)} differences, largest relative gap {worst:.3e} "
          f"(rtol {CPU_RTOL}); checks {doc['checks']}")
    for d in diffs:
        print("    DIFFERS", d)
    check(not diffs, f"the interference matrix differs from "
          f"{INTERFERENCE_JSON.name} in {len(diffs)} places")
    check(doc["checks"] == want["checks"], "interference matrix checks")
    for mix, row in doc["matrix"].items():
        print(f"    {mix:28s} " + ", ".join(
            f"{pol} {c['victim_slowdown']:.4f}" for pol, c in row.items()))
    return dict(wall_s=wall, cells=n_cells, max_rel_gap=worst)


# ----------------------------------------------------------- phases 14-16
#: card vs CPU depths of phase 15: granite-moe-3b-a800m at 8 of its 32
#: layers (cut to fit the training phases 34-38 in the time limit: its
#: CPU prefills at 32 layers took 24 s, beside a 13 GB copy of the model
#: to the host) and at 2; qwen2-moe-a2.7b at full width and 2 layers (its
#: 24 layers need 57.3 GB of float32 masters and a 28.6 GB bf16 copy, more
#: than the card holds)
MOE_CPU_LAYERS = {GRANITE.name: (8, 2), QWEN2_MOE.name: (2,)}


def recast(model, cfg) -> None:
    """Compute with ``model``'s masters in ``cfg.dtype`` from here on
    (the model and every cast cache in it, such as a hybrid's Mamba2
    blocks)."""
    for m in model.modules():
        if isinstance(m, CastCache):
            m.cfg = cfg
            m._cw = None


def moe_breakdown(w: dict, h: torch.Tensor, cfg, n_layers: int,
                  busy_s) -> dict:
    """One MoE layer of the prefill (``moe_einsum`` on the layer-0 input
    ``h`` of the serve) in its parts, by CUDA events over eager calls:
    the router and ``topk_dispatch``, the dispatch einsum, the experts,
    the combine einsum; and their share of the prefill's device busy
    time over ``n_layers`` layers."""
    bsz, seq, d = h.shape
    n_tok = bsz * seq
    g = max(1, n_tok // model_moe.MOE_GROUP)
    while n_tok % g:
        g -= 1
    sg = n_tok // g
    cap = max(cfg.top_k, int(np.ceil(sg * cfg.top_k * 1.25
                                     / cfg.n_experts)))
    xg = h.reshape(n_tok, d)
    xt = xg.reshape(g, sg, d)
    probs = model_moe.router_probs(w, xg, cfg).reshape(g, sg, -1)
    disp, comb, _ = model_moe.topk_dispatch(probs, cfg, cap)
    xe = torch.einsum("gsec,gsd->egcd", disp.to(cfg.dtype), xt)
    ye = model_moe.expert_ffn(w, xe, cfg)
    parts = {
        "route": lambda: model_moe.topk_dispatch(
            model_moe.router_probs(w, xg, cfg).reshape(g, sg, -1), cfg, cap),
        "dispatch_einsum": lambda: torch.einsum(
            "gsec,gsd->egcd", disp.to(cfg.dtype), xt),
        "experts": lambda: model_moe.expert_ffn(w, xe, cfg),
        "combine_einsum": lambda: torch.einsum(
            "gsec,egcd->gsd", comb.to(cfg.dtype), ye),
        "moe_einsum": lambda: model_moe.moe_einsum(w, h, cfg)}
    ms = {name: cuda_ms(fn, 10) for name, fn in parts.items()}
    einsum_s = n_layers * (ms["dispatch_einsum"] + ms["combine_einsum"]) \
        * 1e-3
    out = {"groups": g, "capacity": cap, "ms": ms,
           "dispatch_einsums_s": einsum_s,
           "moe_s": n_layers * ms["moe_einsum"] * 1e-3}
    if busy_s:
        out["dispatch_einsums_share"] = einsum_s / busy_s
        out["moe_share"] = out["moe_s"] / busy_s
    print(f"  MoE layer at {tuple(h.shape)} ({g} groups, capacity {cap}; "
          "CUDA events over eager calls): " + ", ".join(
              f"{k} {v * 1e3:.1f} us" for k, v in ms.items())
          + f"; x {n_layers} layers: dispatch + combine einsums "
          f"{einsum_s * 1e3:.2f} ms, the MoE layers {out['moe_s'] * 1e3:.2f}"
          f" ms" + (f", of a prefill busy {busy_s * 1e3:.2f} ms: "
                    f"{out['dispatch_einsums_share']:.3f} and "
                    f"{out['moe_share']:.3f}" if busy_s else ""))
    return out


def granite_flash_check(seen: dict) -> dict:
    """Phase 14: B2 at granite's prefill shape (head dim 64, GQA group 3)
    against its plain version on the serve's own inputs, then timed;
    B4 at the serve's shapes.  Returns a ``by_shape`` entry."""
    keys = [k for k in seen if k[0] == "flash"]
    check(len(keys) == 1, f"the granite serve gave B2 shapes {keys}")
    q, k, v, causal = seen[keys[0]]
    want = (SERVE_BATCH, GRANITE.n_heads, PROMPT_LEN, GRANITE.hd)
    check(causal and q.dtype == torch.bfloat16 and tuple(q.shape) == want
          and k.shape[1] == GRANITE.n_kv_heads,
          f"B2 saw q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)}")
    err = flash_hold(f"bf16, {GRANITE.name} prefill", q, k, v, True)
    err = max(err, flash_hold(f"bf16, {GRANITE.name}, S = 200",
                              *[t[:2, :, :200].contiguous()
                                for t in (q, k, v)], True))
    entry = {"shape": [q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                       q.shape[3]], "max_abs_err": err}
    entry.update(flash_times(q, k, v))
    for key in sorted(k for k in seen if k[0] == "rms"):
        x, gamma, eps = seen[key]
        rms_hold(x.reshape(-1, x.shape[-1]), gamma, eps)
    return entry


def moe_cpu_compare(cfg, cuda) -> dict:
    """Phase 15: the same seeded model on the card and on the CPU,
    last-token prefill logits of ``CPU_BATCH`` x ``CPU_PROMPT`` tokens
    at each depth of ``MOE_CPU_LAYERS`` in float32 and bf16.

    Each card run is anchored to the CPU run of its dtype
    (``repro_torch.models.moe_parity``): it takes the CPU's expert
    choices, and every choice of its own that differs (a routing flip)
    is counted per layer and held to the tie rule: the CPU's logit margin
    between its expert and the card's at that (token, layer) is at most
    ``2 * 2**-8 * sum_d |x_d| |R_da - R_dc|``, what one bf16 rounding of
    each element of the router's input in each run can move.  The logits
    are then held: float32 at ``LOGITS_F32_TOL``; bf16 as phases 8 and 11
    hold it at full depth, no farther from the CPU's float32 logits than
    ``BF16_ACCURACY_RATIO`` times the CPU's bf16 ones (largest and mean
    difference), with the same argmax at full depth (no depth of
    MOE_CPU_LAYERS is one since PR 27: the argmax is printed).  At these
    widths the bf16 model's own error against float32 exceeds the tests'
    4e-2 already at 2 layers (granite 9.1e-2, qwen2-moe 7.1e-2), so two
    bf16 runs that round in other places are not held to 4e-2 of each
    other (qwen2-moe-a2.7b's read 4.9e-2); the gap is printed."""
    toks = torch.from_numpy(np.array(
        prompts(cfg.vocab, CPU_BATCH, CPU_PROMPT, 1)))
    report = {}
    for n_layers in MOE_CPU_LAYERS[cfg.name]:
        c = cfg.scaled(n_layers=n_layers)
        t0 = time.perf_counter()
        host = model_registry.init_params(c, SEED, "cpu")
        on_card = model_tf.DenseLM(c, device=cuda)
        on_card.load_state_dict(host.state_dict())
        print(f"  {cfg.name}, {n_layers} layers: the model on both "
              f"devices in {time.perf_counter() - t0:.2f} s")
        logits = {}
        for dtype in (torch.float32, torch.bfloat16):
            cd = c.scaled(dtype=dtype)
            for m in (host, on_card):
                recast(m, cd)

            def last(model, dev):
                state = model_registry.make_decode_state(
                    cd, CPU_BATCH, CPU_PROMPT, device=dev)
                lg, _ = model_registry.prefill(
                    model, {"tokens": toks.to(dev)}, cd, state)
                return lg[:, -1, :cfg.vocab].float().cpu()

            t0 = time.perf_counter()
            with moe_parity.recording(moe_parity.RouterTrace()) as anchor:
                host_lg = last(host, torch.device("cpu"))
            cpu_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            with moe_parity.anchored(anchor,
                                     moe_parity.RouterTrace()) as own:
                card_lg = last(on_card, cuda)
            card_s = time.perf_counter() - t0
            fl = moe_parity.flips(own, anchor, n_layers)
            name = str(dtype)[6:]
            print(f"  {name}, {n_layers} layers: CPU prefill {cpu_s:.2f} s, "
                  f"card {card_s:.2f} s; routing flips card vs CPU "
                  f"{fl['n']} in {fl['calls']} router calls of "
                  f"{CPU_BATCH * CPU_PROMPT} tokens, per layer "
                  f"{fl['per_layer']}; largest margin {fl['share']:.4f} of "
                  f"its tie bound {'ok' if fl['share'] <= 1 else 'BEYOND'}")
            check(fl["share"] <= 1.0, f"{cfg.name} {name} {n_layers} layers:"
                  f" a routing flip beyond the tie rule ({fl})")
            logits[dtype] = (card_lg, host_lg)
            report[f"{n_layers}_{name}"] = {
                "flips": fl["n"], "flips_per_layer": fl["per_layer"],
                "tie_share": fl["share"], "cpu_s": cpu_s, "card_s": card_s,
                "max_abs_err": max_err(card_lg, host_lg)}
        card32, host32 = logits[torch.float32]
        check(bool(torch.isfinite(card32).all()), "non-finite logits")
        err = max_err(card32, host32)
        ok = bool(torch.allclose(card32, host32, rtol=LOGITS_F32_TOL,
                                 atol=LOGITS_F32_TOL))
        print(f"  float32, {n_layers} layers: logits max_abs_err {err:.3e} "
              f"(max |logit| {float(host32.abs().max()):.3f}; rtol = atol = "
              f"{LOGITS_F32_TOL}) {'ok' if ok else 'MISMATCH'}")
        check(ok, f"{cfg.name}: card and CPU logits disagree in float32 at "
              f"{n_layers} layers")
        bf_card, bf_host = logits[torch.bfloat16]
        err = max_err(bf_card, bf_host)
        spread = max_err(bf_host, host32)
        acc = max_err(bf_card, host32)
        acc_mean = float((bf_card - host32).abs().mean())
        spread_mean = float((bf_host - host32).abs().mean())
        same = bool((bf_card.argmax(-1) == bf_host.argmax(-1)).all())
        ok = (acc <= BF16_ACCURACY_RATIO * spread and acc_mean
              <= BF16_ACCURACY_RATIO * spread_mean
              and bool(torch.isfinite(bf_card).all())
              and (same or n_layers < cfg.n_layers))
        within = bool(torch.allclose(bf_card, bf_host, rtol=LOGITS_BF16_TOL,
                                     atol=LOGITS_BF16_TOL))
        print(f"  bfloat16, {n_layers} layers: card vs CPU max_abs_err "
              f"{err:.3e} (mean {float((bf_card - bf_host).abs().mean()):.3e}"
              f"; {'within' if within else 'beyond'} the tests' "
              f"{LOGITS_BF16_TOL}, shown, not held); CPU bf16 vs float32 "
              f"{spread:.3e} (mean {spread_mean:.3e}); card bf16 vs float32 "
              f"{acc:.3e} (mean {acc_mean:.3e}): ratios {acc / spread:.3f} "
              f"and {acc_mean / spread_mean:.3f} (limit "
              f"{BF16_ACCURACY_RATIO}); argmax {'same' if same else 'DIFFERS'}"
              f"{'' if n_layers == cfg.n_layers else ' (held at full depth)'}"
              f" {'ok' if ok else 'MISMATCH'}")
        report[f"{n_layers}_bfloat16"].update(
            accuracy_ratio=acc / spread, accuracy_ratio_mean=acc_mean
            / spread_mean, cpu_bf16_vs_f32=spread)
        check(ok, f"{cfg.name}: card and CPU logits disagree in bf16 at "
              f"{n_layers} layers")
        del host, on_card
        torch.cuda.empty_cache()
    return report


def collectives_on_card(cuda, w: dict, h: torch.Tensor, cfg) -> dict:
    """Phase 16: the collective schedules in an NCCL world of one on a
    (1, 1, 1) mesh: each returns its input, which shows only that the
    port's calls reach NCCL on CUDA tensors; then ``moe_ep`` (ep = 1,
    both schedules) against ``moe_ep_ref`` on granite's layer-0 weights
    ``w`` and the serve's prefill input ``h`` to that layer, at one bf16
    ulp of the value."""
    import os

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    out = {}
    try:
        mesh = init_device_mesh("cuda", (1, 1, 1),
                                mesh_dim_names=("pod", "data", "model"))
        gen = torch.Generator(device=cuda).manual_seed(SEED)
        x = torch.randn((1000, 37), generator=gen, device=cuda)
        cases = {
            "allreduce_direct": lambda: allreduce_direct(x, mesh,
                                                         ("pod", "data")),
            "allreduce_hierarchical": lambda: allreduce_hierarchical(
                x, mesh, "pod", "data"),
            "alltoall_direct": lambda: alltoall_direct(x, mesh, "model"),
            "alltoall_hierarchical": lambda: alltoall_hierarchical(
                x, mesh, "pod", "model")}
        for mode in CollectiveMode:
            cases[f"grad_allreduce {mode.value}"] = (
                lambda mode=mode: grad_allreduce({"g": x}, mesh,
                                                 mode=mode)["g"])
        for name, fn in cases.items():
            got = fn()
            torch.cuda.synchronize()
            same = got.device == x.device and bool(torch.equal(got, x))
            print(f"  {name}: {'identity' if same else 'NOT the identity'}")
            check(same, f"{name} in a world of one is not the identity")
        want, aux_ref = moe_ep_ref(w, h, cfg)
        for mode in CollectiveMode:
            got, aux = moe_ep(w, h, cfg, mesh, mode=mode)
            torch.cuda.synchronize()
            gap = (got.float() - want.float()).abs()
            ok = bool((gap <= BF16_RTOL * want.float().abs()).all()) and \
                abs(float(aux) - float(aux_ref)) <= 1e-6 * abs(float(aux_ref))
            print(f"  moe_ep {mode.value} (ep = 1) vs moe_ep_ref at "
                  f"{tuple(h.shape)}: max_abs_err {float(gap.max()):.3e} "
                  f"({int((got != want).sum())} of {got.numel()} differ; "
                  f"rtol {BF16_RTOL:.4g}), aux {float(aux):.6f} against "
                  f"{float(aux_ref):.6f} {'ok' if ok else 'MISMATCH'}")
            check(ok, f"moe_ep {mode.value} disagrees with moe_ep_ref")
            out[mode.value] = float(gap.max())
    finally:
        dist.destroy_process_group()
    return out


# ----------------------------------------------------------- phases 17-20
#: card vs CPU depths of phase 20: zamba2-7b at 14 layers (2 super-blocks,
#: 1 shared-block application, 2 trailing layers); whisper-large-v3 at
#: this many encoder and decoder layers (cut from its 32 + 32 to fit the
#: training phases 34-38 in the time limit: the CPU's prefills at full
#: depth took 79 s)
ZAMBA2_CPU_LAYERS = 14
WHISPER_CPU_LAYERS = 8
#: the CPU's float32 prefill in phase 20 should take at most this many
#: seconds: reported, not enforced (a miss cuts the depth next time)
FAMILY_CPU_S = 60.0
#: B4's timing calls at the new families' shapes (each keeps its
#: output: [4096, 7168] bf16 is 58.7 MB)
RMS_ITERS = 50


def flash_entry(label: str, model: str, q, k, v, causal: bool,
                ragged: bool = False) -> dict:
    """B2 on one of a serve's shapes: held against its plain version (and,
    with ``ragged``, on its first 2 rows cut to 200 tokens), then timed;
    returns a ``by_shape`` entry."""
    err = flash_hold(f"bf16, {model} {label}", q, k, v, causal)
    if ragged:
        err = max(err, flash_hold(f"bf16, {model} {label}, S = 200",
                                  *[t[:2, :, :200].contiguous()
                                    for t in (q, k, v)], causal))
    entry = {"model": model, "attention": label,
             "shape": [q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                       k.shape[2], q.shape[3]], "causal": causal,
             "max_abs_err": err}
    entry.update(flash_times(q, k, v, causal))
    return entry


def family_rms_rows(seen: dict, n_shapes: int, model: str) -> list:
    """B4 at each of a serve's ``n_shapes`` shapes, held and timed."""
    keys = sorted(k for k in seen if k[0] == "rms")
    check(len(keys) == n_shapes, f"the {model} serve gave B4 shapes {keys}")
    return [rms_row(*seen[key], iters=RMS_ITERS) for key in keys]


def zamba2_kernel_checks(seen: dict) -> dict:
    """Phase 17: B2 at zamba2's head dim of 112 (served from the 128
    build, the tensor map zero-padding the columns), B3 at N = 64 with
    112 heads (padded into the N = 128 build) on both routes, and B4 at
    widths 3584 and 7168 (7168 past the register route's reach), each on
    the serve's own inputs against its plain version, timed, with its
    bound."""
    keys = [k for k in seen if k[0] == "flash"]
    check(len(keys) == 1, f"the {ZAMBA2.name} serve gave B2 shapes {keys}")
    q, k, v, causal = seen[keys[0]]
    want = (SERVE_BATCH, ZAMBA2.n_heads, PROMPT_LEN, ZAMBA2.hd)
    check(causal and q.dtype == torch.bfloat16 and tuple(q.shape) == want
          and tuple(k.shape) == want, f"B2 saw q {tuple(q.shape)} "
          f"{q.dtype}, k {tuple(k.shape)}")
    flash = flash_entry("shared block", ZAMBA2.name, q, k, v, True,
                        ragged=True)
    ssd_keys = [k for k in seen if k[0] == "ssd"]
    check(len(ssd_keys) == 1, f"the {ZAMBA2.name} serve gave B3 shapes "
          f"{ssd_keys}")
    ssd = ssd_row(seen[ssd_keys[0]])
    d_inner = ZAMBA2.ssm_expand * ZAMBA2.d_model
    check(ssd["shape"] == [SERVE_BATCH, PROMPT_LEN // ZAMBA2.ssm_chunk,
                           d_inner // ZAMBA2.ssm_head_dim, ZAMBA2.ssm_chunk,
                           ZAMBA2.ssm_head_dim, ZAMBA2.ssm_state, 1],
          f"B3 saw {ssd['shape']}")
    rms = family_rms_rows(seen, 4, ZAMBA2.name)
    for key, row in zip(sorted(k for k in seen if k[0] == "rms"), rms):
        x, gamma, eps = seen[key]
        if x.shape[-1] == d_inner:
            row["generic_ms"] = rms_generic_check(
                x.reshape(-1, d_inner), gamma, eps)
    return {"flash": flash, "ssd": ssd, "rms": rms}


def whisper_kernel_checks(seen: dict) -> dict:
    """Phase 19: B2 at whisper's three shapes (the encoder's non-causal
    1504 x 1504 self-attention, the prefill's non-causal cross-attention
    of 128 queries over 1504 keys, the decoder's causal self-attention)
    and B4 at its three widths-1280 shapes, each on the serve's own
    inputs against its plain version, timed, with its bound."""
    keys = sorted(k for k in seen if k[0] == "flash")
    check(len(keys) == 3, f"the {WHISPER.name} serve gave B2 shapes {keys}")
    heads, hd, n_frames = WHISPER.n_heads, WHISPER.hd, WHISPER.encoder_frames
    want = {"encoder": ((n_frames, n_frames), False),
            "cross": ((WHISPER_PROMPT, n_frames), False),
            "decoder self": ((WHISPER_PROMPT, WHISPER_PROMPT), True)}
    flash = []
    for label, ((sq, skv), is_causal) in want.items():
        got = [seen[k] for k in keys if k[3] == sq and k[7] == skv]
        check(len(got) == 1, f"no B2 call of {label} shape in {keys}")
        q, k, v, causal = got[0]
        check(causal == is_causal and q.dtype == torch.bfloat16 and
              tuple(q.shape) == (SERVE_BATCH, heads, sq, hd) and
              tuple(k.shape) == (SERVE_BATCH, heads, skv, hd),
              f"B2 {label} saw q {tuple(q.shape)}, k {tuple(k.shape)}, "
              f"causal {causal}")
        flash.append(flash_entry(label, WHISPER.name, q, k, v, causal))
    rms = family_rms_rows(seen, 3, WHISPER.name)
    return {"flash": flash, "rms": rms}


def family_cpu_compare(cfg, cuda, host=None) -> dict:
    """Phases 20, 22 and 41-44: the same seeded model (``cfg``, cut in
    depth; ``host``: that model already drawn on the CPU) on the card
    and on the CPU, last-token prefill logits of ``CPU_BATCH`` x
    ``CPU_PROMPT`` tokens (and, for whisper, frames of the config's
    length; for paligemma, its image tokens' patches), in float32 and
    bf16.  float32 is held at ``LOGITS_F32_TOL`` times the largest
    logit, and for the dense family also per element at rtol = atol =
    ``LOGITS_F32_TOL``, as phases 8 and 11 hold it; bf16 by the accuracy
    rule of phases 8 and 11:
    the card's bf16 logits no farther from the CPU's float32 ones than
    ``BF16_ACCURACY_RATIO`` times the CPU's bf16 ones, in the largest and
    in the mean difference, with the CPU's argmax at the family's full
    depth (printed at a cut depth, as phase 15 does)."""
    full = FULL_DEPTH[cfg.name]
    toks = torch.from_numpy(np.array(
        prompts(cfg.vocab, CPU_BATCH, CPU_PROMPT, 1)))
    batch = {"tokens": toks}
    if cfg.family == Family.ENCDEC:
        batch["frames"] = torch.from_numpy(
            frames(cfg, CPU_BATCH, np.random.default_rng(2)))
    if cfg.family == Family.VLM:
        batch["patches"] = torch.from_numpy(
            patches(cfg, CPU_BATCH, np.random.default_rng(2)))
    t0 = time.perf_counter()
    if host is None:
        host = model_registry.init_params(cfg, SEED, "cpu")
    on_card = type(host)(cfg, device=cuda)
    on_card.load_state_dict(host.state_dict())
    print(f"  {cfg.name}, {cfg.n_layers} layers"
          + (f" (+ {cfg.n_encoder_layers} encoder layers)"
             if cfg.family == Family.ENCDEC else "")
          + f": {sum(p.numel() for p in host.parameters())} parameters on "
          f"both devices in {time.perf_counter() - t0:.2f} s")
    logits, report = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        cd = cfg.scaled(dtype=dtype)
        for m in (host, on_card):
            recast(m, cd)

        def last(model, dev):
            state = model_registry.make_decode_state(
                cd, CPU_BATCH, CPU_PROMPT + image_tokens(cd), device=dev)
            lg, _ = model_registry.prefill(
                model, {k: t.to(dev) for k, t in batch.items()}, cd, state)
            return lg[:, -1, :cfg.vocab].float().cpu()

        t0 = time.perf_counter()
        host_lg = last(host, torch.device("cpu"))
        cpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        card_lg = last(on_card, cuda)
        card_s = time.perf_counter() - t0
        name = str(dtype)[6:]
        print(f"  {name}: CPU prefill {cpu_s:.2f} s, card {card_s:.2f} s"
              + (f": {'within' if cpu_s <= FAMILY_CPU_S else 'OVER'} "
                 f"{FAMILY_CPU_S} s" if dtype == torch.float32 else ""))
        logits[dtype] = (card_lg, host_lg)
        report[name] = {"cpu_s": cpu_s, "card_s": card_s,
                        "max_abs_err": max_err(card_lg, host_lg)}
    card32, host32 = logits[torch.float32]
    check(bool(torch.isfinite(card32).all()), "non-finite logits")
    err, scale = max_err(card32, host32), float(host32.abs().max())
    limit = LOGITS_F32_TOL * max(1.0, scale)
    per_element = bool(torch.allclose(card32, host32, rtol=LOGITS_F32_TOL,
                                      atol=LOGITS_F32_TOL))
    ok = err <= limit and (per_element or cfg.family != Family.DENSE)
    print(f"  float32: logits max_abs_err {err:.3e} (max |logit| "
          f"{scale:.3f}; limit {LOGITS_F32_TOL} x max(1, max |logit|) = "
          f"{limit:.3e}, {err / limit:.3f} of it; per element at rtol = "
          f"atol = {LOGITS_F32_TOL}: {'within' if per_element else 'beyond'}"
          f"{', held' if cfg.family == Family.DENSE else ', shown, not held'}"
          f") {'ok' if ok else 'MISMATCH'}")
    report["float32"]["limit_share"] = err / limit
    check(ok, f"{cfg.name}: card and CPU logits disagree in float32")
    bf_card, bf_host = logits[torch.bfloat16]
    spread, acc = max_err(bf_host, host32), max_err(bf_card, host32)
    spread_mean = float((bf_host - host32).abs().mean())
    acc_mean = float((bf_card - host32).abs().mean())
    same = bool((bf_card.argmax(-1) == bf_host.argmax(-1)).all())
    ok = (acc <= BF16_ACCURACY_RATIO * spread
          and acc_mean <= BF16_ACCURACY_RATIO * spread_mean
          and bool(torch.isfinite(bf_card).all())
          and (same or cfg.n_layers < full))
    within = bool(torch.allclose(bf_card, bf_host, rtol=LOGITS_BF16_TOL,
                                 atol=LOGITS_BF16_TOL))
    print(f"  bfloat16: card vs CPU max_abs_err "
          f"{max_err(bf_card, bf_host):.3e} (mean "
          f"{float((bf_card - bf_host).abs().mean()):.3e}; "
          f"{'within' if within else 'beyond'} the tests' "
          f"{LOGITS_BF16_TOL}, shown, not held); CPU bf16 vs float32 "
          f"{spread:.3e} (mean {spread_mean:.3e}); card bf16 vs float32 "
          f"{acc:.3e} (mean {acc_mean:.3e}): ratios {acc / spread:.3f} and "
          f"{acc_mean / spread_mean:.3f} (limit {BF16_ACCURACY_RATIO}); "
          f"argmax {'same' if same else 'DIFFERS'}"
          f"{'' if cfg.n_layers == full else ' (held at full depth)'} "
          f"{'ok' if ok else 'MISMATCH'}")
    report["bfloat16"].update(accuracy_ratio=acc / spread,
                              accuracy_ratio_mean=acc_mean / spread_mean,
                              cpu_bf16_vs_f32=spread, argmax_same=same)
    check(ok, f"{cfg.name}: card and CPU logits disagree in bf16")
    del host, on_card
    torch.cuda.empty_cache()
    return report


# ----------------------------------------------------------- phases 21-22
#: card vs CPU depth of phase 22: paligemma-3b at full width and this many
#: layers
PALIGEMMA_CPU_LAYERS = 4
#: the published depth of each config that a card-vs-CPU check cuts
FULL_DEPTH = {c.name: c.n_layers for c in (ZAMBA2, WHISPER, PALIGEMMA,
                                          STABLELM, CODEQWEN, LLAMA3,
                                          QWEN2_MOE)}


def paligemma_kernel_checks(seen: dict) -> dict:
    """Phase 21: B2 at paligemma's prefill shape, head dim 256 with the
    prefix-LM mask over the 256 image tokens, on the serve's own inputs:
    bf16 (the serve's) and the same inputs cast to float32 (the float32
    model's, phase 22), cut to 200 rows with a prefix of 100, and causal
    without a prefix, each against its plain version; bf16 and float32
    timed beside SDPA with a boolean mask, with their bounds.  B4 at the
    serve's two shapes, held and timed."""
    keys = [k for k in seen if k[0] == "flash"]
    check(len(keys) == 1, f"the {PALIGEMMA.name} serve gave B2 shapes "
          f"{keys}")
    q, k, v, causal = seen[keys[0]]
    prefix = keys[0][-1]
    seq = PALIGEMMA.img_tokens + PROMPT_LEN
    want_q = (SERVE_BATCH, PALIGEMMA.n_heads, seq, PALIGEMMA.hd)
    want_k = (SERVE_BATCH, PALIGEMMA.n_kv_heads, seq, PALIGEMMA.hd)
    check(causal and prefix == PALIGEMMA.img_tokens and
          q.dtype == torch.bfloat16 and tuple(q.shape) == want_q and
          tuple(k.shape) == want_k, f"B2 saw q {tuple(q.shape)} {q.dtype}, "
          f"k {tuple(k.shape)}, causal {causal}, prefix {prefix}")
    f32 = [t.float() for t in (q, k, v)]
    cases = [("bf16", (q, k, v), prefix), ("float32", f32, prefix),
             ("bf16, S = 200", [t[:2, :, :200].contiguous()
                                for t in (q, k, v)], 100),
             ("bf16, no prefix", (q, k, v), 0)]
    err = max(flash_hold(f"{label}, {PALIGEMMA.name}"
                         + (f", prefix {pl}" if pl else ""), a, b, c, True,
                         pl)
              for label, (a, b, c), pl in cases)
    entry = {"model": PALIGEMMA.name, "attention": "prefix-LM",
             "shape": [q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                       k.shape[2], q.shape[3]], "causal": True,
             "prefix_len": prefix, "max_abs_err": err}
    entry.update(flash_times(q, k, v, True, prefix))
    entry.update({"f32_" + key: val for key, val in
                  flash_times(*f32, True, prefix).items()})
    rms = family_rms_rows(seen, 2, PALIGEMMA.name)
    return {"flash": entry, "rms": rms}


# --------------------------------------------------------- phases 23-25
FLASH_BWD_SOURCE = \
    "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu"
RMS_BWD_SOURCE = "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm_bwd.cu"
#: the training path: batch x sequence, steps, learning rate
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 8, 512, 8, 1e-3
#: steps whose mean host wall is train_step_s (the first two warm up)
TRAIN_TIMED = slice(2, 8)
#: qwen2-1.5b's parameters (tied embedding over the padded vocab)
QWEN2_PARAMS = 1_543_714_304
#: backward kernel vs plain version: a float32 gradient within this share
#: of its largest entry (float32 sums of up to G Skv = 3072 products in
#: other orders); a bf16 gradient's largest gap to the plain version run
#: in float32 within BWD_SPREAD times the bf16 plain version's own
#: (tests/test_torch_cuda.py's rules)
BWD_F32_RTOL = 1e-4
BWD_SPREAD = 2.0
#: phase 25: card vs CPU, one float32 step at full width and 2 layers
STEP_CPU_LAYERS, STEP_CPU_BATCH, STEP_CPU_SEQ = 2, 2, 64
STEP_LOSS_RTOL, STEP_GNORM_RTOL, STEP_GRAD_TOL = 1e-5, 1e-4, 1e-4
#: the sign rule (tests/test_torch_train.py): updated parameters compared
#: where |g_cpu| exceeds SIGN_FLOOR of its tensor's largest, at PARAM_TOL
#: plus what the gradient limits allow where the clipped g nears AdamW's
#: eps: the first step moves an entry by lr g / (|g| + eps), so a gap dg
#: in g (STEP_GRAD_TOL of the tensor's largest |g|, STEP_GNORM_RTOL of
#: |g| through the clip) moves it by up to lr eps dg / (|g| + eps)^2,
#: which vanishes where |g| >> eps
SIGN_FLOOR, PARAM_TOL = 1e-3, 1e-6
#: the optimizer of phase 25: a one-step warm-up, so the step moves each
#: parameter by about lr
STEP_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=8)


#: the backward wrappers a capture records, by name: their key
BACKWARDS = {"flash_attention_bwd": "flash", "rmsnorm_bwd": "rms",
             "ssd_inner_bwd": "ssd"}


@contextlib.contextmanager
def backward_inputs(distinct: bool = False):
    """Records the first call of each backward wrapper of BACKWARDS at
    each shape of its first input while the block runs, through the
    wrappers' observers (``kernels._route.OBSERVERS``): ``{(key, shape):
    (args, kwargs)}``, tensors detached.  With ``distinct`` a call is
    told apart also by its second input's shape and its mask (whisper's
    cross- and decoder self-attention share q's shape): keys ``(key,
    shape, second shape, causal)``.  Launches nothing, and leaves the
    wrappers and their counts as they are."""
    seen: dict = {}

    def keep(name, args, kw):
        key = (BACKWARDS[name], tuple(args[0].shape))
        if distinct:
            key += (tuple(args[1].shape), kw.get("causal", True))
        seen.setdefault(key, (tuple(
            a.detach() if isinstance(a, torch.Tensor) else a
            for a in args), kw))

    _route.OBSERVERS.append(keep)
    try:
        yield seen
    finally:
        _route.OBSERVERS.remove(keep)


def capture_train_inputs(cfg, cuda) -> dict:
    """One bf16 train step of ``cfg`` on the card (its first forward and
    backward, no update; the launcher's batch, with the VLM's patches),
    recording the first call of each backward wrapper
    at each shape (:func:`backward_inputs`), by (key, shape): B2's q, k,
    v, o and dO, B3's x, B, C, dA, gy, gS and dt, B4's x, gamma and
    dy."""
    from repro_torch.launch.train import make_batch_np
    from repro_torch.train.train_step import TrainConfig, value_and_grad

    with backward_inputs() as seen:
        model = model_registry.init_params(cfg, SEED, cuda)
        batch = make_batch_np(cfg, SyntheticLM(vocab=cfg.vocab,
                                               seq_len=TRAIN_SEQ),
                              step=0, batch=TRAIN_BATCH, seed=SEED)
        batch = {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}
        value_and_grad(model, batch, cfg, TrainConfig())
        torch.cuda.synchronize()
    del model
    torch.cuda.empty_cache()
    return seen


def first_call(seen: dict, key: str) -> tuple:
    """The first call that :func:`capture_train_inputs` recorded of the
    backward wrapper ``key``, at whatever shape."""
    return next(call for (k, _), call in seen.items() if k == key)


def hold_grads(label: str, got, plain_fn, inputs) -> float:
    """Each gradient of ``got`` against ``plain_fn(*inputs)`` under the
    rules above (a gradient the plain version does not give, None, the
    kernel must not give either); prints and returns the largest gap to
    the plain version."""
    want = plain_fn(*inputs)
    ref = plain_fn(*(t.float() for t in inputs))
    torch.cuda.synchronize()
    worst = 0.0
    for i, (g, w, r) in enumerate(zip(got, want, ref)):
        name = f"d{i}"
        if w is None:
            check(g is None, f"{label}: {name} given, the plain version "
                  f"gives none")
            continue
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{label}: {name} {g.dtype} {tuple(g.shape)}")
        gap = max_err(g.float(), w.float())
        if g.dtype == torch.float32:
            limit = BWD_F32_RTOL * float(w.abs().max())
            print(f"    {label} {name}: max_abs_err {gap:.3e} (limit "
                  f"{limit:.3e}, float32)")
            check(gap <= limit, f"{label} {name}: {gap} > {limit}")
        else:
            own = max_err(w.float(), r)
            mine = max_err(g.float(), r)
            print(f"    {label} {name}: max_abs_err {gap:.3e}; gap to the "
                  f"float32 plain run {mine:.3e}, the bf16 plain run's "
                  f"{own:.3e} (ratio {mine / max(own, 1e-30):.3f}, limit "
                  f"{BWD_SPREAD})")
            check(mine <= BWD_SPREAD * own, f"{label} {name}: spread "
                  f"{mine} > {BWD_SPREAD} x {own}")
        worst = max(worst, gap)
    return worst


def library_bwd_ms(fwd, leaves, iters: int = 10) -> float:
    """A library call's backward alone: eager autograd of ``fwd`` over
    ``leaves`` (forward and backward, between CUDA events) less the
    forward's time."""
    xs = [t.detach().requires_grad_() for t in leaves]
    dout = torch.randn_like(fwd(*xs))

    def both():
        torch.autograd.grad(fwd(*xs), xs, dout)

    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: fwd(*xs), iters)
    return cuda_ms(both, iters) - fwd_ms


#: B2's backward kernels on its tensor-core route, one launch each a call
#: (the parts' sum where the G heads are split, as at the train step)
FLASH_BWD_WG = ("flash_bwd_rows", "flash_bwd_dkdv_wg", "flash_bwd_kv_sum",
                "flash_bwd_dq_wg")
#: B4's backward kernels on its register route
RMS_BWD_REGS = ("rmsnorm_bwd_regs", "rmsnorm_bwd_gamma")


def kernels_named(label: str, names) -> dict:
    """Device events of ``device_profile(label)`` whose kernel name holds
    each of ``names``: {name: (count, us)}."""
    found = {n: (0, 0.0) for n in names}
    for kname, (cnt, us) in PROFILE_KERNELS.get(label, {}).items():
        for n in names:
            if n + "<" in kname or n + "(" in kname:
                c, t = found[n]
                found[n] = (c + cnt, t + us)
    return found


#: phase 23's seeded cases of B2's backward: (causal, prefix, q, k shapes)
FLASH_BWD_CASES = ((True, 0, (2, 6, 130, 128), (2, 2, 130, 128)),
                   (False, 0, (1, 3, 65, 64), (1, 1, 130, 64)),
                   (True, 70, (1, 6, 150, 72), (1, 1, 150, 72)))


def flash_bwd_row(args, lse, full: bool = True, *, prefix: int = 0,
                  cases=FLASH_BWD_CASES, build: int = 0,
                  min_share: float = 0.0, causal: bool = True) -> dict:
    """B2's backward at a train step's shape (``causal``, with the
    prefix-LM mask over ``prefix`` rows; else every query sees every
    key, as whisper's encoder and cross-attention): held in bf16 (the
    tensor-core route,
    with the forward's LSE) and in float32 (the inputs cast; the SIMT
    route), the same bits in two runs of each, timed by graph replay
    beside the plain backward and SDPA's autograd backward (the prefix
    as a boolean mask), with its bound; the bf16 call must reach
    ``min_share`` of its bound.  With ``full``, also its kernels' HGMMA
    counts (only the hd-``build`` build's where ``build`` is given;
    phase 24's profiled step times them) and the seeded ``cases``."""
    import torch.nn.functional as F

    q, k, v, o, do = args
    bsz, heads, seq, hd = q.shape
    skv = k.shape[2]
    route = flash_ops.bwd_route(q, k, v, o, do)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    parts = flash_ops.dkdv_parts(bsz, k.shape[1], k.shape[2],
                                 heads // k.shape[1], sms)
    print(f"  flash_attention_bwd on the train step's inputs: q, o, dO "
          f"{tuple(q.shape)}, k, v {tuple(k.shape)}"
          f"{'' if causal else ', non-causal'}"
          f"{f', prefix {prefix}' if prefix else ''}, the forward's LSE "
          f"{tuple(lse.shape)}; route {route}, G split into {parts} parts")
    check(route == "wgmma" and lse is not None,
          f"the train step's bf16 backward takes the {route} route")
    hgmma = None
    if full:
        tag = f"ILi{build}E" if build else ""
        hgmma = {n: sum(c for f, c in hgmma_by_function(FLASH_LIB).items()
                        if n in f and tag in f) for n in FLASH_BWD_WG}
        print(f"  HGMMA instructions in the SASS"
              f"{f' of the hd-{build} build' if build else ''}: {hgmma}")
        check(hgmma["flash_bwd_dkdv_wg"] > 0 and hgmma["flash_bwd_dq_wg"]
              > 0, f"the tensor-core backward's SASS holds no HGMMA: "
              f"{hgmma}")

    def plain(*t, c_=causal, p_=prefix):
        return flash_attention_bwd_plain(*t, causal=c_, prefix_len=p_)

    def held(label, ins, ll, c_=causal, p_=0):
        first = flash_attention_bwd(*ins, causal=c_, prefix_len=p_, lse=ll)
        again = flash_attention_bwd(*ins, causal=c_, prefix_len=p_, lse=ll)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(first, again)),
              f"flash_attention_bwd {label}: two runs differ")
        return hold_grads(label, first, lambda *t: plain(*t, c_=c_, p_=p_),
                          ins)

    f32 = [t.float() for t in args]
    err = max(held("bf16", args, lse, p_=prefix),
              held("float32", f32, None, p_=prefix))
    print("  dq, dk and dv the same bits in two runs, bf16 and float32")
    rng = torch.Generator(device=q.device).manual_seed(SEED)
    for causal, pre, qs, ks in cases if full else ():
        for dt in (torch.bfloat16, torch.float32):
            a, b, c = (torch.randn(s, device=q.device, generator=rng).to(dt)
                       for s in (qs, ks, ks))
            with torch.no_grad():
                out, ll = (flash_attention_fwd(a, b, c, causal=causal,
                                               prefix_len=pre)
                           if dt == torch.bfloat16 else
                           (flash_attention(a, b, c, causal=causal,
                                            prefix_len=pre), None))
            dout = torch.randn(qs, device=q.device, generator=rng).to(dt)
            want = "wgmma" if dt == torch.bfloat16 else "simt"
            check(flash_ops.bwd_route(a, b, c, out, dout) == want,
                  f"flash_attention_bwd {qs} {dt} off the {want} route")
            err = max(err, held(
                f"{str(dt)[6:]} {qs}{'' if causal else ' non-causal'}"
                f"{f' prefix {pre}' if pre else ''}",
                (a, b, c, out, dout), ll, causal, pre))
    flops = 5 * 2 * hd * bsz * heads * visible_pairs(seq, skv, causal,
                                                     prefix)
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size()
    mask = prefix_mask(seq, skv, prefix, q.device) if prefix else None

    def sdpa(a, b, c):
        if mask is None:
            return F.scaled_dot_product_attention(a, b, c, is_causal=causal,
                                                  enable_gqa=True)
        return F.scaled_dot_product_attention(a, b, c, attn_mask=mask,
                                              enable_gqa=True)

    times = {}
    for label, ins, ll in (("bf16", args, lse), ("float32", f32, None)):
        ms = graph_ms(lambda: flash_attention_bwd(
            *ins, causal=causal, prefix_len=prefix, lse=ll), 10)
        plain_ms = cuda_ms(lambda: plain(*ins), 5)
        library_ms = library_bwd_ms(sdpa, ins[:3])
        backend = sdpa_backend(*ins[:3], mask, causal and mask is None)
        peak = BF16_FLOP_PER_S if label == "bf16" else F32_FLOP_PER_S
        bytes_ms = nbytes * ins[0].element_size() / q.element_size() \
            / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / peak * 1e3
        bound = max(bytes_ms, ops_ms)
        times[label] = {"ms": ms, "plain_ms": plain_ms,
                        "library_ms": library_ms, "sdpa_backend": backend,
                        "bound_ms": bound,
                        "bound_by": "bytes" if bytes_ms >= ops_ms
                        else "operations"}
        print(f"  flash_attention_bwd {label}: {ms * 1e3:.2f} us/call "
              f"({'4 tensor-core' if label == 'bf16' else '3 SIMT'} "
              f"kernels, graph replay), plain {plain_ms * 1e3:.2f} us, "
              f"SDPA ({backend}{', boolean mask' if prefix else ''}) "
              f"autograd backward (forward subtracted) "
              f"{library_ms * 1e3:.2f} us, bound "
              f"{bound * 1e3:.2f} us ({flops} flop at "
              f"{peak:.3g} flop/s: {ops_ms * 1e3:.2f} us; bytes "
              f"{bytes_ms * 1e3:.2f} us), {flops / (ms * 1e-3) / 1e12:.2f} "
              f"TFLOP/s, {bound / ms:.1%} of the bound")
    share = times["bf16"]["bound_ms"] / times["bf16"]["ms"]
    check(share >= min_share, f"flash_attention_bwd bf16 at {share:.1%} of "
          f"its bound, below {min_share:.0%}")
    return dict({"name": "flash_attention_bwd", "route": "cuda",
                 "source": FLASH_BWD_SOURCE, "replaces": FLASH_TPU,
                 "launches": 0, "max_abs_err": err,
                 "shape": [list(q.shape), list(k.shape)], "causal": causal,
                 "prefix_len": prefix, "kernel_route": route,
                 "parts": parts, "hgmma": hgmma,
                 "float32": times["float32"]}, **times["bf16"])


def rms_bwd_row(args, want_route: str = "register") -> dict:
    """Phase 23, B4's backward at a train step's shape: held in bf16 and
    float32, timed by graph replay over a ring of copies of x beside the
    plain backward, ``F.rms_norm``'s autograd backward and ``x + dy``
    (the same bytes), with its bound; the route must be
    ``want_route``."""
    import torch.nn.functional as F

    x, gamma, dy = args[:3]
    eps = args[3] if len(args) > 3 else QWEN2.norm_eps
    x2, dy2 = x.reshape(-1, x.shape[-1]), dy.reshape(-1, x.shape[-1])
    d = x2.shape[-1]
    print(f"  rmsnorm_bwd on the train step's inputs: x, dy "
          f"{tuple(x2.shape)} {str(x.dtype)[6:]}, gamma {str(gamma.dtype)[6:]}")
    ins = (x2, gamma, dy2)
    route = rms_ops.bwd_route(*ins)
    print(f"  route {route}")
    check(route[0] == want_route, f"B4's backward at {tuple(x2.shape)} "
          f"takes the {route} route")
    first = rmsnorm_bwd(*ins, eps)
    again = rmsnorm_bwd(*ins, eps)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          "rmsnorm_bwd: two runs differ")
    print("  dx and dgamma the same bits in two runs")
    err = hold_grads("bf16", first, lambda *t: rmsnorm_bwd_plain(*t, eps),
                     ins)
    f32 = [t.float() for t in ins]
    err = max(err, hold_grads("float32", rmsnorm_bwd(*f32, eps),
                              lambda *t: rmsnorm_bwd_plain(*t, eps), f32))
    nbytes = 3 * x2.numel() * x2.element_size() + 2 * d * gamma.element_size()
    flops = 8 * x2.numel()
    ms = graph_ms_ring(lambda xi: rmsnorm_bwd(xi, gamma, dy2, eps), x2, 50)
    # the bytes of the bound (read x and dy, write one such tensor) moved
    # by one PyTorch elementwise kernel, as the timed call moves them
    copy_ms = graph_ms_ring(lambda xi: torch.add(xi, dy2), x2, 50)
    warm_ms = graph_ms(lambda: rmsnorm_bwd(x2, gamma, dy2, eps), 50)
    plain_ms = cuda_ms(lambda: rmsnorm_bwd_plain(x2, gamma, dy2, eps), 20)
    library_ms = library_bwd_ms(
        lambda a, g: F.rms_norm(a, (d,), g, eps), (x2, gamma), 20)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOP_PER_S * 1e3
    bound = max(bytes_ms, ops_ms)
    print(f"  rmsnorm_bwd {tuple(x2.shape)}: {ms * 1e3:.2f} us/call (2 "
          f"kernels, {route[0]} route, graph replay over a ring of x; one x "
          f"{warm_ms * 1e3:.2f} us), plain {plain_ms * 1e3:.2f} us, "
          f"F.rms_norm autograd backward (forward subtracted) "
          f"{library_ms * 1e3:.2f} us, bound {bound * 1e3:.2f} us ({nbytes} "
          f"bytes), {bound / ms:.1%} of it; x + dy over the ring (the same "
          f"bytes) {copy_ms * 1e3:.2f} us")
    return {"name": "rmsnorm_bwd", "route": "cuda", "source": RMS_BWD_SOURCE,
            "replaces": RMS_TPU, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms, "shape": list(x2.shape),
            "warm_ms": warm_ms, "copy_graph_ms": copy_ms,
            "kernel_route": list(route)}


def backward_kernel_checks(cuda) -> list:
    """Phase 23: both backward kernels on inputs captured from a
    qwen2-1.5b train step, against their plain versions, timed."""
    t0 = time.perf_counter()
    print(f"phase 23: the backward kernels on a {QWEN2.name} train step's "
          f"inputs ({TRAIN_BATCH} x {TRAIN_SEQ} tokens, bf16)")
    seen = capture_train_inputs(QWEN2, cuda)
    (fa, fkw), (ra, rkw) = (first_call(seen, key)
                            for key in ("flash", "rms"))
    check(not fkw.get("prefix_len") and fkw.get("causal", True),
          f"the train step's B2 backward ran with {fkw}")
    rows = [flash_bwd_row(fa, fkw.get("lse")),
            rms_bwd_row(ra + tuple(rkw.values()))]
    del seen, fa, ra
    torch.cuda.empty_cache()
    print(f"phase 23: {time.perf_counter() - t0:.1f} s wall")
    return rows


TRAINED = (flash_attention, flash_attention_bwd, rmsnorm_fused, rmsnorm_bwd)


def train_run(cfg, cuda, trained: tuple, per_step: tuple,
              steps: int = TRAIN_STEPS, lr: float = TRAIN_LR,
              seq: int | None = None, **loop) -> tuple:
    """``train_loop`` on ``cfg`` (bf16 compute, TRAIN_BATCH x ``seq``
    tokens (default TRAIN_SEQ), ``steps`` AdamW steps at peak ``lr``; ``loop``: more of its
    arguments) with the counts of ``trained`` set to 0 just before and
    read just after: ``per_step`` launches of each a step asserted, every
    loss finite, the peak memory under the card's 80 GB.  Prints each
    step, ``train_step_s`` (the mean of steps TRAIN_TIMED of 8, else of
    every step after the first), tokens/s and peak memory; returns
    (model, opt, stats, history)."""
    from repro_torch.launch.train import train_loop

    seq = seq or TRAIN_SEQ
    for k in trained:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    history: list = []
    t0 = time.perf_counter()
    model, opt, losses = train_loop(
        cfg, steps=steps, batch=TRAIN_BATCH, seq=seq, seed=SEED,
        ckpt_dir=None, ckpt_every=0, lr=lr, log_every=1, device=cuda,
        history=history, **loop)
    wall = time.perf_counter() - t0
    counts = {k.__name__: k.launches for k in trained}
    want = {k.__name__: steps * n for k, n in zip(trained, per_step)}
    print(f"  launches over {steps} steps {counts} (want {want})")
    check(counts == want, f"training launches {counts}, want {want}")
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in model.parameters())
    check(all(np.isfinite(losses)) and len(losses) == steps,
          f"losses {losses}")
    check(peak < 80e9, f"peak memory {peak / 1e9:.3f} GB")
    for h in history:
        print(f"  step {h['step']}: loss {h['loss']:.6f} lr {h['lr']:.6e} "
              f"grad_norm {h['grad_norm']:.6f} step_s {h['step_s']:.6f} "
              f"modes {dict((m, h['modes'].count(m)) for m in set(h['modes']))}")
    timed = history[TRAIN_TIMED] if steps == TRAIN_STEPS else history[1:]
    step_s = float(np.mean([h["step_s"] for h in timed]))
    tokens = TRAIN_BATCH * seq
    mfu = 6 * n_params * tokens / step_s / BF16_FLOP_PER_S
    print(f"  train_step_s {step_s:.6f} (mean of steps {timed[0]['step']}-"
          f"{timed[-1]['step']}, host wall, synchronised), tokens_per_s "
          f"{tokens / step_s:.1f}, peak memory {peak / 1e9:.3f} GB, "
          f"{n_params} parameters, loop {wall:.1f} s wall; for information "
          f"only 6 N tokens / train_step_s / 989e12 = {mfu:.4f}")
    return model, opt, {
        "launches": counts, "train_step_s": step_s,
        "tokens_per_s": tokens / step_s, "peak_memory_gb": peak / 1e9,
        "losses": losses, "mfu_info": mfu, "loop_wall_s": wall,
        "n_params": n_params,
        "grad_norm": [h["grad_norm"] for h in history],
        "lr": [h["lr"] for h in history]}, history


def profile_train_step(cfg, model, opt, cuda, label: str,
                       want: dict, seq: int | None = None) -> None:
    """One more train step (TRAIN_BATCH x ``seq`` tokens, default
    TRAIN_SEQ) under
    ``torch.profiler``; where the trace has device events, the launches
    of the kernels named in ``want`` (a name: count) must be those
    counts."""
    from repro_torch.launch.train import make_batch_np
    from repro_torch.train.train_step import TrainConfig, train_step

    b = make_batch_np(cfg, SyntheticLM(vocab=cfg.vocab,
                                       seq_len=seq or TRAIN_SEQ),
                      step=TRAIN_STEPS, batch=TRAIN_BATCH, seed=SEED)
    b = {k: torch.from_numpy(v).to(cuda) for k, v in b.items()}
    device_profile(lambda: train_step(model, opt, b, cfg=cfg,
                                      tcfg=TrainConfig()), label)
    if label in PROFILE_KERNELS:
        got = kernels_named(label, want)
        print("  the profiled step's backward kernels: " + ", ".join(
            f"{n} x{c} {us / 1e3:.3f} ms" for n, (c, us) in got.items()))
        check({n: c for n, (c, _) in got.items()} == want,
              f"backward kernel launches in the profiled step {got}, "
              f"want {want}")


def bwd_kernel_counts(cfg, shapes: list, per_step: tuple) -> dict:
    """The launches of each tensor-core backward kernel of B2 and each
    register-route kernel of B4's in one train step: ``per_step`` (B2's
    backward calls, B4's) and, for the G-split sum, the calls at each
    ``(count, skv)`` of ``shapes`` whose heads split into parts."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    split = sum(n for n, skv in shapes
                if flash_ops.dkdv_parts(TRAIN_BATCH, cfg.n_kv_heads, skv,
                                        cfg.n_heads // cfg.n_kv_heads,
                                        sms) > 1)
    want = {n: per_step[0] for n in FLASH_BWD_WG}
    want["flash_bwd_kv_sum"] = split
    want.update({n: per_step[1] for n in RMS_BWD_REGS})
    return want


def train_path(cuda) -> dict:
    """Phase 24: ``repro_torch.launch.train.train_loop`` on qwen2-1.5b at
    full width, bf16 compute, with Algorithm 1 over the gradient
    buckets; the launches of every kernel per step asserted; one more
    step profiled."""
    cfg = QWEN2
    print(f"phase 24: train {cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} of "
          f"{cfg.hd}, vocab {cfg.vocab}), bf16 compute, {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens, {TRAIN_STEPS} AdamW steps, lr {TRAIN_LR}, "
          f"comm_policy app_aware")
    per_step = (cfg.n_layers, cfg.n_layers, 2 * cfg.n_layers + 1,
                2 * cfg.n_layers + 1)
    print(f"  per step: B2 {per_step[0]} forward calls (each writing its "
          f"LSE) and {per_step[1]} backward calls of 4 tensor-core kernels, "
          f"B4 {per_step[2]} and {per_step[3]} of 2")
    model, opt, stats, history = train_run(cfg, cuda, TRAINED, per_step,
                                           comm_policy="app_aware")
    losses = stats["losses"]
    check(stats["n_params"] == QWEN2_PARAMS, f"{stats['n_params']} "
          f"parameters")
    check(losses[7] < losses[0], f"loss at step 7 {losses[7]} is not below "
          f"step 0's {losses[0]}")
    buckets = history[0]["modes"]
    print(f"  Algorithm 1: {len(buckets)} gradient buckets a step, "
          f"decisions per step {[h['modes'] for h in history[:1]]} ... "
          f"{sum(m == 'HIERARCHICAL' for h in history for m in h['modes'])}"
          f" HIERARCHICAL of {sum(len(h['modes']) for h in history)}")
    profile_train_step(cfg, model, opt, cuda, "train step",
                       bwd_kernel_counts(cfg, [(per_step[1], TRAIN_SEQ)],
                                         per_step[1::2]))
    # the trained state, as a checkpoint holds it, for phase 39
    SNAPSHOTS[cfg.name] = to_host((model.state_dict(), opt))
    del model, opt
    torch.cuda.empty_cache()
    return dict(stats, idle=PROFILES.get("train step"), buckets=len(buckets),
                hierarchical_share=float(np.mean(
                    [m == "HIERARCHICAL" for h in history
                     for m in h["modes"]])))


def step_positions(cfg, seq: int) -> str:
    """A train row's positions in words: ``seq`` tokens, after the VLM's
    patches or beside the enc-dec family's frames."""
    if cfg.family == Family.VLM:
        return f"({cfg.img_tokens} patches + {seq} tokens)"
    if cfg.family == Family.ENCDEC:
        return f"({cfg.encoder_frames} frames + {seq} tokens)"
    return f"{seq} tokens"


def train_cpu_compare(cuda, base=QWEN2, phase: int = 25, **cut) -> dict:
    """Phase 25 (28 for mamba2-130m, 30 for zamba2-7b, 33 for
    paligemma-3b, 35 for granite-moe-3b-a800m, 37 for whisper-large-v3):
    one float32 step of ``base`` at full width and STEP_CPU_LAYERS layers
    (or the fields ``cut`` gives) on the card and on the CPU, from the
    same weights and batch (the launcher's, with the VLM's patches or
    the enc-dec family's frames): loss, gradient norm, every gradient,
    and the updated parameters under the sign rule.  An MoE model's card
    run is anchored to the CPU run's expert choices
    (``moe_parity.anchored``, as phase 15 anchors its prefills), and each
    choice of the card's own that differs is held to the tie rule."""
    from repro_torch.launch.train import make_batch_np
    from repro_torch.train.optimizer import AdamWConfig, adamw_init, \
        adamw_update
    from repro_torch.train.train_step import TrainConfig, value_and_grad

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 stays float32
    torch.backends.cudnn.allow_tf32 = False
    cut = {"n_layers": STEP_CPU_LAYERS, **cut}
    cfg = base.scaled(dtype=torch.float32, **cut)
    print(f"phase {phase}: card vs CPU, one float32 train step of {cfg.name} "
          f"at full width, {', '.join(f'{k} {v}' for k, v in cut.items())}, "
          f"{STEP_CPU_BATCH} x {step_positions(cfg, STEP_CPU_SEQ)} "
          f"(TF32 off for matmul and cuDNN)")
    t0 = time.perf_counter()
    host = model_registry.init_params(cfg, SEED, "cpu")
    batch = make_batch_np(cfg, SyntheticLM(vocab=cfg.vocab,
                                           seq_len=STEP_CPU_SEQ),
                          step=0, batch=STEP_CPU_BATCH, seed=SEED)
    tcfg = TrainConfig(optimizer=AdamWConfig(**STEP_OPT))
    moe = cfg.family == Family.MOE
    on_card = copy.deepcopy(host).to(cuda)
    anchor = moe_parity.RouterTrace()
    out, aux, routing = {}, {}, None
    # the CPU first where the card's routing is anchored to it
    for label in (("cpu", "card") if moe else ("card", "cpu")):
        model, dev = ((on_card, cuda) if label == "card"
                      else (host, torch.device("cpu")))
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        t1 = time.perf_counter()
        if not moe:
            hook = contextlib.nullcontext()
        elif label == "cpu":
            hook = moe_parity.recording(anchor)
        else:
            hook = moe_parity.anchored(anchor, moe_parity.RouterTrace())
        with hook as own:
            loss, metrics, grads = value_and_grad(model, b, cfg, tcfg)
        aux[label] = float(metrics["aux"])
        if moe and label == "card":
            routing = moe_parity.flips(own, anchor, cfg.n_layers)
        g_host = {k: g.detach().cpu().clone() for k, g in grads.items()}
        params = dict(model.named_parameters())
        _, _, m = adamw_update(tcfg.optimizer, params, grads,
                               adamw_init(params))
        lr_used = m["lr"]
        out[label] = (float(loss), float(m["grad_norm"]), g_host,
                      {k: p.detach().cpu().clone() for k, p in params.items()})
        print(f"  {label}: loss {float(loss):.7f}, grad_norm "
              f"{float(m['grad_norm']):.7f}"
              + (f", aux {aux[label]:.7f}" if moe else "")
              + f", step {time.perf_counter() - t1:.2f} s")
        del model, grads, params
    del on_card
    if routing is not None:
        routing["aux_rel"] = abs(aux["card"] - aux["cpu"]) / aux["cpu"]
        print(f"  routing flips card vs CPU {routing['n']} in "
              f"{routing['calls']} router calls of "
              f"{STEP_CPU_BATCH * STEP_CPU_SEQ} tokens, per layer "
              f"{routing['per_layer']}; largest margin {routing['share']:.4f}"
              f" of its tie bound; aux rel diff {routing['aux_rel']:.3e} "
              f"(limit {STEP_LOSS_RTOL})")
        check(routing["calls"] == cfg.n_layers and routing["share"] <= 1.0,
              f"{cfg.name}: a routing flip beyond the tie rule ({routing})")
        check(routing["aux_rel"] <= STEP_LOSS_RTOL,
              f"{cfg.name}: aux {aux['card']} vs {aux['cpu']}")
    (lc, nc, gc, pc), (lh, nh, gh, ph) = out["card"], out["cpu"]
    loss_rel = abs(lc - lh) / abs(lh)
    gnorm_rel = abs(nc - nh) / abs(nh)
    grad_gap = max(float((gc[k] - g).abs().max() / g.abs().max())
                   for k, g in gh.items())
    eps, lr = tcfg.optimizer.eps, float(lr_used)
    clip = min(1.0, tcfg.optimizer.grad_clip_norm / nh)
    compared = total = 0
    param_gap, worst = 0.0, (0.0, "-", 0.0, 0.0)
    for k, g in gh.items():
        a = g.abs()
        keep = a > SIGN_FLOOR * a.max()
        dg = clip * (STEP_GRAD_TOL * a.max() + STEP_GNORM_RTOL * a)
        limit = PARAM_TOL + lr * eps * dg / (clip * a + eps) ** 2
        gap = (pc[k] - ph[k]).abs()
        share = torch.where(keep, gap / limit, 0.0)
        at = int(share.argmax())
        if keep.any():
            param_gap = max(param_gap, float(gap[keep].max()))
        worst = max(worst, (float(share.flatten()[at]), k,
                            float(gap.flatten()[at]),
                            float(a.flatten()[at] * clip / eps)))
        compared += int(keep.sum())
        total += keep.numel()
    print(f"  loss rel diff {loss_rel:.3e} (limit {STEP_LOSS_RTOL}), "
          f"grad_norm rel diff {gnorm_rel:.3e} (limit {STEP_GNORM_RTOL}), "
          f"largest gradient gap {grad_gap:.3e} of its tensor's largest "
          f"entry (limit {STEP_GRAD_TOL}), updated parameters: largest gap "
          f"{param_gap:.3e} (limit {PARAM_TOL}, more where the clipped |g| "
          f"nears eps) over the {compared / total:.1%} of entries whose |g| "
          f"exceeds {SIGN_FLOOR} of their tensor's largest; nearest its "
          f"limit: {worst[2]:.3e}, {worst[0]:.3f} of it ({worst[1]}, "
          f"clipped |g| {worst[3]:.1f} eps); "
          f"{time.perf_counter() - t0:.1f} s wall")
    check(loss_rel <= STEP_LOSS_RTOL, f"loss {lc} vs {lh}")
    check(gnorm_rel <= STEP_GNORM_RTOL, f"grad_norm {nc} vs {nh}")
    check(grad_gap <= STEP_GRAD_TOL, f"gradient gap {grad_gap}")
    check(worst[0] <= 1.0, f"updated parameter gap {worst[2]} at {worst[1]}, "
          f"{worst[0]} of its limit")
    return dict({"loss_rel": loss_rel, "grad_norm_rel": gnorm_rel,
                 "grad_gap": grad_gap, "param_gap": param_gap,
                 "compared_share": compared / total,
                 "param_limit_share": worst[0]},
                **({"routing": routing} if routing else {}))


# --------------------------------------------------------- phases 26-30
SSD_BWD_SOURCE = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_bwd.cu"
#: B3's backward kernels by route, one launch each a call: the tensor
#: cores' (bf16, every trained shape) and the SIMT route's (float32; the
#: heads' sum where a group has several)
SSD_BWD = ("ssd_bwd_wg", "ssd_bwd_gbc")
SSD_BWD_SIMT = ("ssd_bwd_head", "ssd_bwd_sum", "ssd_bwd_group")
#: the SSM family's kernels on its training path
SSM_TRAINED = (ssd_inner, ssd_inner_bwd, rmsnorm_fused, rmsnorm_bwd)
#: mamba2-130m's parameters (tied embedding over the padded vocab)
MAMBA2_PARAMS = 129_001_920
#: zamba2-7b's training depth: its float32 masters, gradients and AdamW
#: moments take 16 bytes a parameter, 108 GB at 81 layers; at 14 (two
#: super-blocks of 6 with the shared block once between them, 2 trailing
#: layers; phase 20's depth) they take 24.4 GB
ZAMBA2_TRAIN_LAYERS, ZAMBA2_TRAIN_STEPS = 14, 3
#: phase 29's second run: ZAMBA2_LOW_STEPS steps at a tenth of TRAIN_LR,
#: where every loss after step 0's must be below it (at TRAIN_LR the
#: warm-up reaches 6e-4 at step 2, and the loss of this 3584-wide model
#: rises there above step 0's, as qwen2-1.5b's does in phase 24)
ZAMBA2_LOW_LR, ZAMBA2_LOW_STEPS = TRAIN_LR / 10, 5
#: phase 30's cut of zamba2-7b: 3 layers, the shared block between each two
#: (period 1), so that it is applied twice and its gradient sums over
#: both applications
ZAMBA2_CPU_CUT = dict(n_layers=3, shared_attn_period=1)


def ssd_bwd_row(args, model: str, full: bool = True) -> dict:
    """B3's backward on a train step's captured inputs (x, B, C, dA, gy,
    gS, dt): its route (the tensor cores in bf16, asserted; the SIMT
    kernels in float32), held in bf16 (as captured) and in float32 (x, B
    and C cast), the same bits in two runs, both timed by graph replay in
    this run beside the plain version, with its bound, its share of the
    bound, TFLOP/s and its scratch; with ``full``, also its tensor-core
    kernels' HGMMA counts in the SASS (each must be above 0)."""
    x, b, c, da, gy, gs, dt = args
    bsz, nc, heads, q, p = x.shape
    groups, n = b.shape[2], b.shape[-1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    print(f"  ssd_inner_bwd on the {model} train step's inputs: x "
          f"{tuple(x.shape)} {str(x.dtype)[6:]}, B, C {tuple(b.shape)}, gy, "
          f"gS float32, dt given")
    check(x.dtype == torch.bfloat16 and dt is not None,
          f"the {model} train step's B3 backward ran on {x.dtype}")
    f32 = [t.float() for t in args]
    plans = {"bf16": ssd_ops.bwd_plan(x, b, c, gy, gs, sms),
             "float32": ssd_ops.bwd_plan(f32[0], f32[1], f32[2], gy, gs,
                                         sms)}
    check(plans["bf16"][0] == "wgmma" and plans["float32"][0] == "simt",
          f"ssd_inner_bwd routes {plans}")
    before = ssd_inner_bwd.bf16_launches
    first = ssd_inner_bwd(*args)
    again = ssd_inner_bwd(*args)
    torch.cuda.synchronize()
    check(ssd_inner_bwd.bf16_launches == before + 2,
          "ssd_inner_bwd: a bf16 call off the tensor-core route")
    check(all(torch.equal(f, g) for f, g in zip(first, again)),
          "ssd_inner_bwd: two runs differ")
    print(f"  bf16: the tensor-core route ({', '.join(SSD_BWD)}; "
          f"{plans['bf16'][1]} head slices a group); gx, gB, gC, gdA and "
          f"gdt the same bits in two runs")
    if full:
        hgmma = {k: sum(c for fn, c in hgmma_by_function(SSD_LIB).items()
                        if k in fn) for k in SSD_BWD}
        print(f"  HGMMA instructions in the SASS: {hgmma}")
        check(all(c > 0 for c in hgmma.values()),
              f"the tensor-core backward's SASS holds no HGMMA: {hgmma}")
    err = hold_grads("bf16", first, ssd_inner_bwd_plain, args)
    err = max(err, hold_grads("float32", ssd_inner_bwd(*f32),
                              ssd_inner_bwd_plain, f32))
    cells, pairs = bsz * nc * heads, q * (q + 1) // 2
    flops = 2 * (cells * (2 * pairs * p + 2 * q * n * p)
                 + bsz * nc * groups * 3 * pairs * n)
    times = {}
    for label, ins in (("bf16", args), ("float32", f32)):
        route, slices, floats = plans[label]
        nbytes = sum(t.numel() * t.element_size() for t in ins) + \
            sum(t.numel() * t.element_size() for t in (ins[0], ins[1],
                                                       ins[2], ins[3], ins[6]))
        ms = graph_ms(lambda: ssd_inner_bwd(*ins), 10)
        plain_ms = cuda_ms(lambda: ssd_inner_bwd_plain(*ins), 3)
        peak = BF16_FLOP_PER_S if label == "bf16" else F32_FLOP_PER_S
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / peak * 1e3
        bound = max(bytes_ms, ops_ms)
        names = SSD_BWD if route == "wgmma" else SSD_BWD_SIMT
        times[label] = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                        "bound_ms": bound,
                        "bound_by": "bytes" if bytes_ms >= ops_ms
                        else "operations", "route_kernels": names,
                        "scratch_mb": floats * 4 / 1e6,
                        "bound_share": bound / ms,
                        "tflops": flops / (ms * 1e-3) / 1e12}
        print(f"  ssd_inner_bwd {label}: {ms * 1e3:.2f} us/call ({route} "
              f"route: {', '.join(names)}; graph replay), plain "
              f"{plain_ms * 1e3:.2f} us, bound {bound * 1e3:.2f} us "
              f"({nbytes} bytes: {bytes_ms * 1e3:.2f} us; {flops} flop at "
              f"{peak:.3g} flop/s: {ops_ms * 1e3:.2f} us), {bound / ms:.1%} "
              f"of the bound, {flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s; "
              f"scratch {floats * 4 / 1e6:.1f} MB a call")
    print(f"  ssd_inner_bwd bf16 against float32 in this run: "
          f"{times['float32']['ms'] / times['bf16']['ms']:.2f}x faster")
    return dict({"name": "ssd_inner_bwd", "route": "cuda",
                 "source": SSD_BWD_SOURCE, "replaces": SSD_TPU,
                 "launches": 0, "max_abs_err": err, "model": model,
                 "shape": list(x.shape) + [n, groups],
                 "float32": times["float32"]}, **times["bf16"])


def ssm_backward_checks(cuda) -> dict:
    """Phase 26: B3's backward on the inputs of a mamba2-130m train
    step's first backward call (the last layer's), against its plain
    version, timed."""
    t0 = time.perf_counter()
    print(f"phase 26: B3's backward on a {MAMBA2.name} train step's inputs "
          f"({TRAIN_BATCH} x {TRAIN_SEQ} tokens, bf16)")
    seen = capture_train_inputs(MAMBA2, cuda)
    args, kw = first_call(seen, "ssd")
    check(not kw, f"the train step's B3 backward ran with {kw}")
    row = ssd_bwd_row(args, MAMBA2.name)
    del seen, args
    torch.cuda.empty_cache()
    print(f"phase 26: {time.perf_counter() - t0:.1f} s wall")
    return row


def ssm_train_path(cuda) -> dict:
    """Phase 27: ``train_loop`` on mamba2-130m at full width and depth,
    bf16 compute, TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens;
    per step 24 B3 and 24 B3-backward calls, 49 B4 and 49 B4-backward
    calls asserted; one more step profiled."""
    cfg = MAMBA2
    d_inner = cfg.ssm_expand * cfg.d_model
    print(f"phase 27: train {cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {d_inner // cfg.ssm_head_dim} SSD heads of "
          f"{cfg.ssm_head_dim}, N = {cfg.ssm_state}, chunk {cfg.ssm_chunk}, "
          f"vocab {cfg.vocab}), bf16 compute, {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens, {TRAIN_STEPS} AdamW steps, lr {TRAIN_LR}")
    per_step = (cfg.n_layers, cfg.n_layers, 2 * cfg.n_layers + 1,
                2 * cfg.n_layers + 1)
    ssd_inner.bf16_launches = ssd_inner_bwd.bf16_launches = 0
    model, opt, stats, _ = train_run(cfg, cuda, SSM_TRAINED, per_step)
    losses = stats["losses"]
    check(stats["n_params"] == MAMBA2_PARAMS, f"{stats['n_params']} "
          f"parameters")
    check(losses[7] < losses[0], f"loss at step 7 {losses[7]} is not below "
          f"step 0's {losses[0]}")
    check(ssd_inner.bf16_launches == ssd_inner.launches,
          f"{ssd_inner.launches - ssd_inner.bf16_launches} B3 launches "
          f"off the tensor-core route")
    check(ssd_inner_bwd.bf16_launches == ssd_inner_bwd.launches,
          f"{ssd_inner_bwd.launches - ssd_inner_bwd.bf16_launches} B3 "
          f"backward calls off the tensor-core route")
    print(f"  every B3 call ({ssd_inner.launches}) and B3 backward call "
          f"({ssd_inner_bwd.launches}) on the tensor-core route")
    want_k = {n: per_step[1] for n in SSD_BWD}
    want_k.update({n: per_step[3] for n in RMS_BWD_REGS})
    profile_train_step(cfg, model, opt, cuda, "ssm train step", want_k)
    del model, opt
    torch.cuda.empty_cache()
    return dict(stats, idle=PROFILES.get("ssm train step"))


def hybrid_train_path(cuda) -> tuple:
    """Phase 29: ``train_loop`` on zamba2-7b at full width and
    ZAMBA2_TRAIN_LAYERS layers for ZAMBA2_TRAIN_STEPS steps, the launches
    of B2, B3, B4 and their backward calls per step asserted, every loss
    finite and step 1's below step 0's; again for ZAMBA2_LOW_STEPS steps
    at ZAMBA2_LOW_LR, every loss after step 0's below it; then the backward
    kernels on the first run's captured inputs (B3's, B2's at head dim
    112, B4's at widths 3584 and 7168) against their plain versions,
    timed.  Returns (stats, rows)."""
    cfg = ZAMBA2.scaled(n_layers=ZAMBA2_TRAIN_LAYERS)
    n_super, period, rem, apps = hybrid_layout(cfg)
    d_inner = cfg.ssm_expand * cfg.d_model
    print(f"phase 29: train {cfg.name} at full width, {cfg.n_layers} of "
          f"{ZAMBA2.n_layers} Mamba2 layers ({n_super} super-blocks of "
          f"{period}, the shared block {apps} time(s), {rem} trailing; "
          f"d_model {cfg.d_model}, {d_inner // cfg.ssm_head_dim} SSD heads "
          f"at N = {cfg.ssm_state}, the shared block's {cfg.n_heads} heads "
          f"of {cfg.hd}), bf16 compute, {TRAIN_BATCH} x {TRAIN_SEQ} tokens, "
          f"{ZAMBA2_TRAIN_STEPS} AdamW steps")
    t0 = time.perf_counter()
    trained = TRAINED + (ssd_inner, ssd_inner_bwd)
    norms = 2 * cfg.n_layers + 2 * apps + 1
    per_step = (apps, apps, norms, norms, cfg.n_layers, cfg.n_layers)
    ssd_inner_bwd.bf16_launches = 0
    with backward_inputs() as seen:
        model, opt, stats, _ = train_run(cfg, cuda, trained, per_step,
                                         steps=ZAMBA2_TRAIN_STEPS)
    del model, opt
    torch.cuda.empty_cache()
    check(ssd_inner_bwd.bf16_launches == ssd_inner_bwd.launches,
          f"{ssd_inner_bwd.launches - ssd_inner_bwd.bf16_launches} B3 "
          f"backward calls off the tensor-core route")
    print(f"  every B3 backward call ({ssd_inner_bwd.launches}) on the "
          f"tensor-core route")
    losses = stats["losses"]
    check(losses[1] < losses[0], f"loss at step 1 {losses[1]} is not below "
          f"step 0's {losses[0]}")
    print(f"  again at lr {ZAMBA2_LOW_LR} for {ZAMBA2_LOW_STEPS} steps")
    model, opt, low, _ = train_run(cfg, cuda, trained, per_step,
                                   steps=ZAMBA2_LOW_STEPS, lr=ZAMBA2_LOW_LR)
    profile_train_step(cfg, model, opt, cuda, "hybrid train step",
                       {n: cfg.n_layers for n in SSD_BWD})
    stats["idle"] = PROFILES.get("hybrid train step")
    del model, opt
    torch.cuda.empty_cache()
    check(max(low["losses"][1:]) < low["losses"][0],
          f"losses at lr {ZAMBA2_LOW_LR} {low['losses']}: one after step 0 "
          f"is not below step 0's")
    stats["low_lr"] = {k: low[k] for k in ("losses", "grad_norm", "lr")}
    print(f"  {time.perf_counter() - t0:.1f} s wall to here")
    calls = {}
    for (key, shape), call in seen.items():
        calls.setdefault((key, shape[-1]), call)
    check(sorted(calls) == [("flash", cfg.hd), ("rms", cfg.d_model),
                            ("rms", d_inner), ("ssd", cfg.ssm_head_dim)],
          f"backward calls seen {sorted(calls)}")
    (fa, fkw) = calls["flash", cfg.hd]
    rows = {"flash": flash_bwd_row(fa, fkw.get("lse"), full=False),
            "ssd": ssd_bwd_row(calls["ssd", cfg.ssm_head_dim][0], ZAMBA2.name,
                               full=False),
            "rms": []}
    for ra, rkw in (calls["rms", cfg.d_model], calls["rms", d_inner]):
        args = ra + tuple(rkw.values())
        row = rms_bwd_row(args, "wide")
        x, gamma, dy = args[:3]
        row["generic_ms"] = rms_generic_check(
            x.reshape(-1, x.shape[-1]), gamma,
            args[3] if len(args) > 3 else cfg.norm_eps,
            dy.reshape(-1, x.shape[-1]))
        rows["rms"].append(row)
    del seen, calls, fa, ra, args, x, gamma, dy
    torch.cuda.empty_cache()
    print(f"phase 29: {time.perf_counter() - t0:.1f} s wall")
    return stats, rows


# --------------------------------------------------------- phases 31-33
#: phase 31's seeded cases of B2's backward at head dims 129-256 (G = 8 as
#: paligemma's, but for the non-causal and the hd-192 cases): (causal,
#: prefix, q, k shapes)
VLM_BWD_CASES = ((True, 100, (1, 8, 200, 256), (1, 1, 200, 256)),
                 (True, 0, (2, 8, 130, 256), (2, 1, 130, 256)),
                 (False, 0, (1, 2, 65, 256), (1, 1, 130, 256)),
                 (True, 0, (1, 4, 150, 192), (1, 2, 150, 192)))
#: the least share of its bound the bf16 backward call at paligemma's
#: train shape must reach (54.3 us: at most 543 us)
VLM_BWD_MIN_SHARE = 0.10
#: paligemma-3b's parameters (tied embedding over the padded vocab)
PALIGEMMA_PARAMS = 2_508_793_856


@contextlib.contextmanager
def flash_bwd_routes():
    """Counts the route (``flash_ops.bwd_route``) of each call of B2's
    backward wrapper while the block runs, through the wrappers'
    observers: ``{route: calls}``.  Launches nothing."""
    routes: dict = {}

    def count(name, args, _kw):
        if name == "flash_attention_bwd":
            r = flash_ops.bwd_route(*args[:5])
            routes[r] = routes.get(r, 0) + 1

    _route.OBSERVERS.append(count)
    try:
        yield routes
    finally:
        _route.OBSERVERS.remove(count)


def vlm_backward_checks(cuda) -> dict:
    """Phase 31: B2's backward at head dim 256 under the prefix-LM mask
    and B4's at ``[6144,2048]``, on inputs captured from one bf16
    paligemma-3b train step, against their plain versions (phase 23's
    rules), timed; B2's also at the seeded VLM_BWD_CASES."""
    t0 = time.perf_counter()
    cfg = PALIGEMMA
    positions = cfg.img_tokens + TRAIN_SEQ
    print(f"phase 31: the backward kernels on a {cfg.name} train step's "
          f"inputs ({TRAIN_BATCH} x ({cfg.img_tokens} patches + "
          f"{TRAIN_SEQ} tokens), bf16)")
    seen = capture_train_inputs(cfg, cuda)
    want = {("flash", (TRAIN_BATCH, cfg.n_heads, positions, cfg.hd)),
            ("rms", (TRAIN_BATCH, positions, cfg.d_model)),
            ("rms", (TRAIN_BATCH, TRAIN_SEQ, cfg.d_model))}
    check(set(seen) == want, f"backward calls seen {sorted(seen)}")
    fa, fkw = seen["flash", (TRAIN_BATCH, cfg.n_heads, positions, cfg.hd)]
    check(fkw.get("prefix_len") == cfg.img_tokens and
          fkw.get("causal", True), f"the train step's B2 backward ran with "
          f"{ {k: v for k, v in fkw.items() if k != 'lse'} }")
    ra, rkw = seen["rms", (TRAIN_BATCH, positions, cfg.d_model)]
    rows = {"flash": flash_bwd_row(fa, fkw.get("lse"),
                                   prefix=cfg.img_tokens,
                                   cases=VLM_BWD_CASES, build=256,
                                   min_share=VLM_BWD_MIN_SHARE),
            "rms": rms_bwd_row(ra + tuple(rkw.values()))}
    del seen, fa, ra
    torch.cuda.empty_cache()
    print(f"phase 31: {time.perf_counter() - t0:.1f} s wall")
    return rows


def vlm_train_path(cuda) -> dict:
    """Phase 32: ``train_loop`` on paligemma-3b at full width and depth,
    bf16 compute, TRAIN_STEPS steps of TRAIN_BATCH x (256 patches +
    TRAIN_SEQ tokens); per step 18 B2 and 18 B2-backward calls (every
    one on the tensor-core route), 37 B4 and 37 B4-backward calls
    asserted; one more step profiled; every loss finite and the last
    below step 0's."""
    cfg = PALIGEMMA
    positions = TRAIN_BATCH * (cfg.img_tokens + TRAIN_SEQ)
    print(f"phase 32: train {cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} of "
          f"{cfg.hd}, prefix-LM over {cfg.img_tokens} patches, vocab "
          f"{cfg.vocab}), bf16 compute, {TRAIN_BATCH} x ({cfg.img_tokens} "
          f"patches + {TRAIN_SEQ} tokens) = {positions} positions a step, "
          f"{TRAIN_STEPS} AdamW steps, lr {TRAIN_LR}")
    per_step = (cfg.n_layers, cfg.n_layers, 2 * cfg.n_layers + 1,
                2 * cfg.n_layers + 1)
    with flash_bwd_routes() as routes:
        model, opt, stats, _ = train_run(cfg, cuda, TRAINED, per_step)
    losses = stats["losses"]
    check(stats["n_params"] == PALIGEMMA_PARAMS, f"{stats['n_params']} "
          f"parameters")
    check(routes == {"wgmma": TRAIN_STEPS * per_step[1]},
          f"B2's backward routes {routes}")
    print(f"  every B2 backward call ({routes['wgmma']}) on the tensor-core "
          f"route; {positions} positions a step, "
          f"{positions / stats['train_step_s']:.1f} positions/s beside "
          f"tokens_per_s {stats['tokens_per_s']:.1f} (text tokens)")
    check(losses[-1] < losses[0], f"loss at step {TRAIN_STEPS - 1} "
          f"{losses[-1]} is not below step 0's {losses[0]}")
    profile_train_step(cfg, model, opt, cuda, "vlm train step",
                       bwd_kernel_counts(cfg, [(per_step[1], cfg.img_tokens
                                                + TRAIN_SEQ)],
                                         per_step[1::2]))
    del model, opt
    torch.cuda.empty_cache()
    return dict(stats, idle=PROFILES.get("vlm train step"),
                positions_per_step=positions, flash_bwd_routes=routes)


# --------------------------------------------------------- phases 34-38
#: whisper-large-v3's parameters (32 + 32 layers, untied head)
WHISPER_PARAMS = 1_603_176_960
#: whisper's decoder tokens a train row: its published
#: max_target_positions (openai/whisper-large-v3, config.json); the
#: encoder takes the config's 1504 stub frames a row
WHISPER_TRAIN_SEQ = 448
#: the reckoned peak (GB) that granite's training depth stays under, below
#: the card's 80 GB (paligemma-3b's run peaked at 75.3 GB)
GRANITE_BUDGET_GB = 76.0
#: bytes a parameter live at the end of a train step's forward: the
#: float32 master and two AdamW moments, and the bf16 compute copy (the
#: gradients come as the backward frees the activations)
FWD_BYTES_PER_PARAM = 14
#: bytes a parameter live in the AdamW update: the master, its gradient,
#: the two moments and the update's two float32 temporaries
UPDATE_BYTES_PER_PARAM = 24
#: phase 37's cut of whisper-large-v3: 2 encoder and 2 decoder layers
WHISPER_CPU_CUT = dict(n_layers=2, n_encoder_layers=2)


def granite_reckoning(n_layers: int) -> dict:
    """The reckoned peak of one granite-moe-3b-a800m train step at
    ``n_layers`` layers and full width (TRAIN_BATCH x TRAIN_SEQ tokens,
    bf16 compute), in bytes: the larger of the update's
    UPDATE_BYTES_PER_PARAM a parameter and the forward's end, where
    FWD_BYTES_PER_PARAM a parameter live beside, per layer, what
    autograd keeps of the forward (``moe_einsum``'s top_k float32
    one-hot slot tensors ``[G,S,E,C]`` that ``sel * topv`` saves, the
    bf16 dispatch and combine, ``xe`` and ``ye`` ``[E,G,C,D]``, the
    experts' joined in/gate product and their activation, the router's
    float32 input, and the attention block's bf16 tensors), the loss
    (bf16 logits ``[B,S,Vp]`` and three float32 tensors of that shape:
    the logits read in float32, their exponentials, the gradient) and
    the tied head's first gradient (float32 and bf16 ``[Vp,D]``)."""
    cfg = GRANITE.scaled(n_layers=n_layers)
    params = sum(p.numel() for p in model_tf.DenseLM(
        cfg, device="meta").parameters())
    tokens = TRAIN_BATCH * TRAIN_SEQ
    groups = max(1, tokens // model_moe.MOE_GROUP)
    per_group = tokens // groups
    cap = max(cfg.top_k, int(np.ceil(per_group * cfg.top_k * 1.25
                                     / cfg.n_experts)))
    slots = groups * per_group * cfg.n_experts * cap
    expert_rows = cfg.n_experts * groups * cap
    qkv = (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd
    layer = {"one_hot_slots": cfg.top_k * slots * 4,
             "dispatch_combine": 2 * slots * 2,
             "xe_ye": 2 * expert_rows * cfg.d_model * 2,
             "experts_hidden": 4 * expert_rows * cfg.d_ff_expert * 2,
             "router_input": tokens * cfg.d_model * 4,
             "attention": tokens * (4 * cfg.d_model + 2 * qkv
                                    + 2 * cfg.n_heads * cfg.hd) * 2}
    loss = tokens * cfg.vocab_padded * (2 + 3 * 4) \
        + cfg.vocab_padded * cfg.d_model * (4 + 2)
    fwd = FWD_BYTES_PER_PARAM * params + n_layers * sum(layer.values()) \
        + loss
    update = UPDATE_BYTES_PER_PARAM * params
    return {"n_layers": n_layers, "params": params,
            "bytes": max(fwd, update), "update_bytes": update,
            "state_bytes": FWD_BYTES_PER_PARAM * params,
            "layer_bytes": layer, "loss_bytes": loss, "capacity": cap,
            "groups": groups}


def granite_depth() -> dict:
    """The deepest granite training depth whose reckoned peak
    (:func:`granite_reckoning`) stays under GRANITE_BUDGET_GB, printed
    beside the full depth's."""
    best = None
    for n in range(1, GRANITE.n_layers + 1):
        r = granite_reckoning(n)
        if r["bytes"] <= GRANITE_BUDGET_GB * 1e9:
            best = r
    full = granite_reckoning(GRANITE.n_layers)
    check(best is not None, "no granite depth fits the budget")
    for r in (full, best):
        print(f"  reckoned peak at {r['n_layers']} layers: "
              f"{r['bytes'] / 1e9:.2f} GB: at the forward's end "
              f"{r['params']} parameters x {FWD_BYTES_PER_PARAM} B "
              f"{r['state_bytes'] / 1e9:.2f} GB + {r['n_layers']} x "
              f"{sum(r['layer_bytes'].values()) / 1e9:.3f} GB of saved "
              f"activations + the loss and the head's gradient "
              f"{r['loss_bytes'] / 1e9:.2f} GB; in the update "
              f"{UPDATE_BYTES_PER_PARAM} B a parameter, "
              f"{r['update_bytes'] / 1e9:.2f} GB")
    print("  per layer: " + ", ".join(
        f"{k} {v / 1e9:.3f} GB" for k, v in best["layer_bytes"].items())
          + f" ({best['groups']} groups, capacity {best['capacity']})")
    print(f"  the deepest depth under {GRANITE_BUDGET_GB} GB: "
          f"{best['n_layers']} of {GRANITE.n_layers} layers")
    return best


def moe_train_path(cuda) -> tuple:
    """Phase 34: ``train_loop`` on granite-moe-3b-a800m at full width and
    the depth :func:`granite_depth` reckons, bf16 compute, TRAIN_STEPS
    steps of TRAIN_BATCH x TRAIN_SEQ tokens, ``comm_policy="app_aware"``;
    per step L B2 and L B2-backward calls (every one on the tensor-core
    route) and 2L + 1 B4 and B4-backward calls asserted; the measured
    peak beside the reckoned; one more step profiled; every loss finite
    and step 7's below step 0's.  Returns (stats, the first step's
    backward inputs)."""
    print(f"phase 34: train {GRANITE.name} at full width (d_model "
          f"{GRANITE.d_model}, {GRANITE.n_heads} heads over "
          f"{GRANITE.n_kv_heads} of {GRANITE.hd}, {GRANITE.n_experts} "
          f"experts top-{GRANITE.top_k} of d_ff {GRANITE.d_ff_expert}, vocab "
          f"{GRANITE.vocab}), bf16 compute, {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens, {TRAIN_STEPS} AdamW steps, lr {TRAIN_LR}, comm_policy "
          f"app_aware")
    reckon = granite_depth()
    cfg = GRANITE.scaled(n_layers=reckon["n_layers"])
    n = cfg.n_layers
    per_step = (n, n, 2 * n + 1, 2 * n + 1)
    with backward_inputs() as seen, flash_bwd_routes() as routes:
        model, opt, stats, history = train_run(cfg, cuda, TRAINED, per_step,
                                               comm_policy="app_aware")
    losses = stats["losses"]
    check(stats["n_params"] == reckon["params"], f"{stats['n_params']} "
          f"parameters, reckoned {reckon['params']}")
    check(routes == {"wgmma": TRAIN_STEPS * n}, f"B2's backward routes "
          f"{routes}")
    print(f"  every B2 backward call ({routes['wgmma']}) on the tensor-core "
          f"route; peak memory {stats['peak_memory_gb']:.3f} GB measured, "
          f"{reckon['bytes'] / 1e9:.3f} GB reckoned "
          f"({stats['peak_memory_gb'] / (reckon['bytes'] / 1e9):.3f} of it)")
    aux = [h["aux"] for h in history]
    print(f"  aux (the {n} layers' load-balancing losses, summed) per step "
          f"{[round(a, 4) for a in aux]}, {cfg.router_aux_coef} x it in the "
          f"loss")
    check(all(np.isfinite(aux)) and min(aux) > 0, f"aux {aux}")
    check(losses[7] < losses[0], f"loss at step 7 {losses[7]} is not below "
          f"step 0's {losses[0]}")
    profile_train_step(cfg, model, opt, cuda, "moe train step",
                       bwd_kernel_counts(cfg, [(n, TRAIN_SEQ)],
                                         per_step[1::2]))
    del model, opt
    torch.cuda.empty_cache()
    return dict(stats, idle=PROFILES.get("moe train step"),
                n_layers=n, reckoned_peak_gb=reckon["bytes"] / 1e9,
                flash_bwd_routes=routes, aux=aux), seen


def encdec_train_path(cuda) -> tuple:
    """Phase 36: ``train_loop`` on whisper-large-v3 at full width and
    depth, bf16 compute, TRAIN_STEPS steps of TRAIN_BATCH x (1504 stub
    frames + WHISPER_TRAIN_SEQ tokens); per step 96 B2 and 96
    B2-backward calls (32 encoder non-causal, 32 decoder causal, 32
    cross non-causal; every backward on the tensor-core route) and 162
    B4 and 162 B4-backward calls asserted; one more step profiled; every
    loss finite and step 7's below step 0's.  Returns (stats, the first
    step's backward inputs, each attention told apart)."""
    cfg = WHISPER
    print(f"phase 36: train {cfg.name} ({cfg.n_encoder_layers} + "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads of {cfg.hd}, vocab {cfg.vocab}), bf16 compute, "
          f"{TRAIN_BATCH} x {step_positions(cfg, WHISPER_TRAIN_SEQ)}, "
          f"{TRAIN_STEPS} AdamW steps, lr {TRAIN_LR}")
    attn = cfg.n_encoder_layers + 2 * cfg.n_layers
    norms = 2 * cfg.n_encoder_layers + 1 + 3 * cfg.n_layers + 1
    per_step = (attn, attn, norms, norms)
    with backward_inputs(distinct=True) as seen, \
            flash_bwd_routes() as routes:
        model, opt, stats, _ = train_run(cfg, cuda, TRAINED, per_step,
                                         seq=WHISPER_TRAIN_SEQ)
    losses = stats["losses"]
    check(stats["n_params"] == WHISPER_PARAMS, f"{stats['n_params']} "
          f"parameters")
    check(routes == {"wgmma": TRAIN_STEPS * attn}, f"B2's backward routes "
          f"{routes}")
    positions = TRAIN_BATCH * (cfg.encoder_frames + WHISPER_TRAIN_SEQ)
    print(f"  every B2 backward call ({routes['wgmma']}) on the tensor-core "
          f"route; {positions} positions a step (frames and tokens), "
          f"{positions / stats['train_step_s']:.1f} positions/s beside "
          f"tokens_per_s {stats['tokens_per_s']:.1f} (decoder tokens)")
    check(losses[7] < losses[0], f"loss at step 7 {losses[7]} is not below "
          f"step 0's {losses[0]}")
    from repro_torch.launch.train import make_batch_np
    gen = SyntheticLM(vocab=cfg.vocab, seq_len=WHISPER_TRAIN_SEQ)
    t0 = time.perf_counter()
    make_batch_np(cfg, gen, step=0, batch=TRAIN_BATCH, seed=SEED)
    draw_s = time.perf_counter() - t0
    print(f"  the launcher's host draw of one step's batch (the stub frames "
          f"[{TRAIN_BATCH},{cfg.encoder_frames},{cfg.d_model}] in NumPy, "
          f"inside step_s): {draw_s:.6f} s")
    shapes = [(cfg.n_encoder_layers, cfg.encoder_frames),
              (cfg.n_layers, cfg.encoder_frames),
              (cfg.n_layers, WHISPER_TRAIN_SEQ)]
    profile_train_step(cfg, model, opt, cuda, "encdec train step",
                       bwd_kernel_counts(cfg, shapes, per_step[1::2]),
                       seq=WHISPER_TRAIN_SEQ)
    del model, opt
    torch.cuda.empty_cache()
    return dict(stats, idle=PROFILES.get("encdec train step"),
                positions_per_step=positions, flash_bwd_routes=routes,
                batch_draw_s=draw_s), seen


# --------------------------------------------------------- phases 39-40
#: the host copies of trained states (``to_host`` of ``(state dict,
#: AdamWState)``, what a checkpoint writes), by config name
SNAPSHOTS: dict = {}
#: phase 40: the reckoned peak, less the attention core's saved bytes,
#: over the measured peak must lie in this band
RECKON_PEAK_BAND = (0.85, 1.15)


def _bits(t: torch.Tensor) -> bytes:
    return t.detach().float().cpu().numpy().tobytes()


def state_step(cfg, cuda, params: dict, opt) -> dict:
    """One train step of ``cfg`` from ``params`` (name: tensor on
    ``cuda``, taken as the model's parameters) and ``opt``, on step
    TRAIN_STEPS's batch; returns the loss's and the gradient norm's
    float32 bits."""
    from repro_torch.launch.train import make_batch_np
    from repro_torch.train.train_step import TrainConfig, train_step

    model = model_tf.DenseLM(cfg, device="meta")
    model.load_state_dict(params, assign=True)
    b = make_batch_np(cfg, SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ),
                      step=TRAIN_STEPS, batch=TRAIN_BATCH, seed=SEED)
    b = {k: torch.from_numpy(v).to(cuda) for k, v in b.items()}
    _, _, metrics = train_step(model, opt, b, cfg=cfg, tcfg=TrainConfig())
    return {"loss": _bits(metrics["loss"]),
            "grad_norm": _bits(metrics["grad_norm"]),
            "loss_value": float(metrics["loss"])}


def elastic_restart(cuda) -> dict:
    """Phase 39: qwen2-1.5b's parameters and AdamW state after phase 24's
    steps (the host copy a checkpoint writes) restored by
    ``reshard_checkpoint`` onto a (1, 1) ("data", "model") mesh of a
    world of one (NCCL on the card); every leaf's local tensor on the
    device equal to the host array bit for bit; one train step from the
    restored state and one from the host copy moved to the device as it
    is give the same loss and gradient-norm bits."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.train.optimizer import AdamWState

    cfg = QWEN2
    saved = SNAPSHOTS.pop(cfg.name)
    params, opt = saved
    n_bytes = sum(a.nbytes for tree in (params, opt.m, opt.v)
                  for a in tree.values())
    print(f"phase 39: elastic restart of {cfg.name} after phase 24's "
          f"{TRAIN_STEPS} steps: {len(params)} parameters and their AdamW "
          f"moments ({n_bytes / 1e9:.3f} GB of host arrays, step "
          f"{int(opt.step)}) onto a (1, 1) mesh of a world of one")
    dist.init_process_group("nccl" if cuda.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh_for((1, 1), ("data", "model"),
                             device_type=cuda.type)
        t0 = time.perf_counter()
        placed = reshard_checkpoint(saved, cfg, mesh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        leaves = [(f"params {n}", placed[0][n], params[n]) for n in params]
        for part in ("m", "v"):
            leaves += [(f"{part} {n}", getattr(placed[1], part)[n],
                        getattr(opt, part)[n]) for n in params]
        leaves.append(("step", placed[1].step, opt.step))
        bad = [name for name, got, host in leaves
               if got.to_local().device.type != cuda.type
               or not torch.equal(got.to_local(),
                                  torch.from_numpy(host).to(cuda))]
        print(f"  restored {len(leaves)} leaves in {restore_s:.2f} s; "
              f"{len(leaves) - len(bad)} equal to the host arrays bit for "
              f"bit on the device")
        check(not bad, f"restored leaves differ: {bad[:5]}")
        got = state_step(
            cfg, cuda, {n: t.to_local() for n, t in placed[0].items()},
            AdamWState(step=int(placed[1].step.to_local()),
                       m={n: t.to_local() for n, t in placed[1].m.items()},
                       v={n: t.to_local() for n, t in placed[1].v.items()}))
        del placed
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    def on_card(tree):
        return {n: torch.from_numpy(a).to(cuda) for n, a in tree.items()}

    want = state_step(cfg, cuda, on_card(params),
                      AdamWState(step=int(opt.step), m=on_card(opt.m),
                                 v=on_card(opt.v)))
    del saved, params, opt
    torch.cuda.empty_cache()
    print(f"  one step: loss {got['loss_value']:.6f} restored, "
          f"{want['loss_value']:.6f} from the host copy; loss bits "
          f"{'equal' if got['loss'] == want['loss'] else 'DIFFER'}, "
          f"gradient-norm bits "
          f"{'equal' if got['grad_norm'] == want['grad_norm'] else 'DIFFER'}")
    check(got["loss"] == want["loss"] and got["grad_norm"] == want["grad_norm"],
          "a step from the restored state differs from one from the host "
          "copy")
    return {"leaves": len(leaves), "restore_s": restore_s,
            "host_gb": n_bytes / 1e9, "loss": got["loss_value"]}


#: phase 40's cells: (arch, layers or None, kind, sequence, rows)
RECKON_SCRIPT = """
import json, sys
from repro_torch.configs import InputShape, get_config
from repro_torch.launch.dryrun import lower_cell
out = []
for arch, layers, kind, seq, rows in json.loads(sys.argv[1]):
    cfg = get_config(arch)
    if layers:
        cfg = cfg.scaled(n_layers=layers)
    rep, costs = lower_cell(cfg, InputShape(kind, seq, rows, kind),
                            mesh_override=((1, 1), ("data", "model")))
    out.append(dict(rep, peak_bytes=costs.peak_bytes,
                    saved_bytes=costs.scope_saved_bytes["attn_core"]))
print(json.dumps(out))
"""


def dryrun_reckoning(serve_stats: dict, trains: dict) -> list:
    """Phase 40: the dry run (``repro_torch.launch.dryrun.lower_cell``) at
    mesh (1, 1), in a subprocess that sees no card, reckons three cells
    that this run measured: qwen2-1.5b's train step (phase 24),
    granite-moe-3b-a800m's at phase 34's depth, and qwen2-1.5b's prefill
    (phase 10), each TRAIN_BATCH x TRAIN_SEQ or SERVE_BATCH x PROMPT_LEN;
    each cell's bound, ``max(compute, memory_flash, collective)`` on the
    datasheet H100, at most its measured ``train_step_s`` or
    ``prefill_s``, and its reckoned peak less the attention core's saved
    bytes within RECKON_PEAK_BAND of its measured peak."""
    import os

    granite = trains[GRANITE.name]
    cells = [(QWEN2.name, None, "train", TRAIN_SEQ, TRAIN_BATCH,
              trains[QWEN2.name]["train_step_s"],
              trains[QWEN2.name]["peak_memory_gb"], "phase 24"),
             (GRANITE.name, granite["n_layers"], "train", TRAIN_SEQ,
              TRAIN_BATCH, granite["train_step_s"],
              granite["peak_memory_gb"], "phase 34"),
             (QWEN2.name, None, "prefill", PROMPT_LEN, SERVE_BATCH,
              serve_stats[QWEN2.name]["prefill_s"],
              serve_stats[QWEN2.name]["peak_mem_gb"], "phase 10")]
    print(f"phase 40: the dry run's reckoning at mesh (1, 1) beside this "
          f"run's steps (bounds on the datasheet {H100.name}: "
          f"{H100.peak_flops:.4g} FLOP/s, {H100.hbm_bw:.4g} B/s)")
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-c", RECKON_SCRIPT,
         json.dumps([c[:5] for c in cells])],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=600)
    check(run.returncode == 0, f"the reckoning failed: {run.stderr[-3000:]}")
    reps = json.loads(run.stdout.strip().splitlines()[-1])
    print(f"  reckoned in {time.perf_counter() - t0:.1f} s")
    out = []
    for (arch, layers, kind, seq, rows, step_s, peak_gb, phase), rep in \
            zip(cells, reps):
        bound_ms = max(rep["compute_ms"], rep["memory_ms_flash"],
                       rep["collective_ms"])
        peak = (rep["peak_bytes"] - rep["saved_bytes"]) / 1e9
        ratio = peak / peak_gb
        share = rep["model_flops"] / H100.peak_flops / step_s
        label = f"{arch}{f' at {layers} layers' if layers else ''} {kind}"
        print(f"  {label} {rows} x {seq} ({phase}): bound {bound_ms:.4f} ms "
              f"(compute {rep['compute_ms']:.4f}, memory {rep['memory_ms']:.4f}"
              f", flash-adjusted {rep['memory_ms_flash']:.4f}, collective "
              f"{rep['collective_ms']:.4f}) against {step_s * 1e3:.4f} ms "
              f"measured, {bound_ms / (step_s * 1e3):.4f} of it; peak "
              f"{rep['peak_bytes'] / 1e9:.3f} GB reckoned, less "
              f"{rep['saved_bytes'] / 1e9:.3f} GB the attention core saves, "
              f"{peak:.3f} against {peak_gb:.3f} measured ({ratio:.4f}); "
              f"useful_flops_ratio {rep['useful_flops_ratio']:.4f}; model "
              f"FLOPs {rep['model_flops']:.4g}, {share:.4f} of the "
              f"datasheet H100's peak over the measured step")
        check(bound_ms <= step_s * 1e3, f"{label}: the bound "
              f"{bound_ms:.4f} ms exceeds the measured "
              f"{step_s * 1e3:.4f} ms")
        check(RECKON_PEAK_BAND[0] <= ratio <= RECKON_PEAK_BAND[1],
              f"{label}: reckoned peak {peak:.3f} GB is {ratio:.4f} of the "
              f"measured {peak_gb:.3f}")
        out.append({"cell": label, "bound_ms": bound_ms,
                    "measured_ms": step_s * 1e3,
                    "peak_reckoned_gb": peak, "peak_measured_gb": peak_gb,
                    "peak_ratio": ratio,
                    "useful_flops_ratio": rep["useful_flops_ratio"],
                    "model_flop_share": share, "trace_s": rep["trace_s"],
                    "compute_ms": rep["compute_ms"],
                    "memory_ms": rep["memory_ms"],
                    "memory_ms_flash": rep["memory_ms_flash"]})
    return out


def new_shape_backward_checks(granite: dict, whisper: dict) -> dict:
    """Phase 38: B2's backward at granite's causal q ``[8,24,512,64]``
    over k, v ``[8,8,512,64]`` (G = 3) and at whisper's three shapes
    (the encoder's non-causal 1504 x 1504, whose last kv tile is ragged;
    the cross-attention's non-causal 448 queries over 1504 keys; the
    decoder's causal 448 x 448), and B4's at ``[12032,1280]`` and
    ``[3584,1280]`` (its register route, 5 vectors a lane), each on the
    inputs of the first step of phases 34 and 36, under phase 23's
    rules, the same bits in two runs, timed beside the plain version
    and the library's autograd backward, with its bound."""
    t0 = time.perf_counter()
    print("phase 38: the backward kernels at the MoE and enc-dec training "
          "shapes, on the inputs of phases 34 and 36's first steps")
    b, d = TRAIN_BATCH, WHISPER.d_model
    n_frames, seq = WHISPER.encoder_frames, WHISPER_TRAIN_SEQ
    enc = (b, WHISPER.n_heads, n_frames, WHISPER.hd)
    dec = (b, WHISPER.n_heads, seq, WHISPER.hd)
    want_w = {("flash", enc, enc, False), ("flash", dec, enc, False),
              ("flash", dec, dec, True),
              ("rms", (b, n_frames, d), (d,), True),
              ("rms", (b, seq, d), (d,), True)}
    check(set(whisper) == want_w, f"{WHISPER.name}'s backward calls seen "
          f"{sorted(whisper)}")
    gq = (b, GRANITE.n_heads, TRAIN_SEQ, GRANITE.hd)
    check(set(granite) == {("flash", gq), ("rms", (b, TRAIN_SEQ,
                                                   GRANITE.d_model))},
          f"{GRANITE.name}'s backward calls seen {sorted(granite)}")
    flash = []
    for model, label, (args, kw) in (
            (GRANITE.name, "self", granite["flash", gq]),
            (WHISPER.name, "encoder", whisper["flash", enc, enc, False]),
            (WHISPER.name, "cross", whisper["flash", dec, enc, False]),
            (WHISPER.name, "decoder self", whisper["flash", dec, dec, True])):
        print(f"  {model} {label}:")
        row = flash_bwd_row(args, kw.get("lse"), full=False,
                            causal=kw.get("causal", True))
        flash.append(dict(row, model=model, attention=label))
    rms = []
    for key in (("rms", (b, n_frames, d), (d,), True),
                ("rms", (b, seq, d), (d,), True)):
        ra, rkw = whisper[key]
        rms.append(dict(rms_bwd_row(ra + tuple(rkw.values())),
                        model=WHISPER.name))
    print(f"phase 38: {time.perf_counter() - t0:.1f} s wall")
    return {"flash": flash, "rms": rms}


# --------------------------------------------------------- phases 41-45
#: qwen2-moe-a2.7b at its 24 layers serves from bf16 parameters: its
#: float32 masters (57.3 GB) and their bf16 copy (28.6 GB) exceed the card.
#: The same seed gives the same bf16 values, and the serve the same bits
#: (tests/test_torch_serve.py::test_bf16_params_serve_the_same_bits)
QWEN2_MOE_SERVED = QWEN2_MOE.scaled(param_dtype=torch.bfloat16)
#: codeqwen1.5-7b's served depth: the valve of the time limit (its shapes,
#: head dim 128 with G = 1 and the QKV bias, show at any depth)
CODEQWEN_LAYERS = 32
CODEQWEN_SERVED = CODEQWEN.scaled(n_layers=CODEQWEN_LAYERS)
#: phases 41-44: the configs not served at full size before, in order
NEW_SERVES = (STABLELM, QWEN2_MOE_SERVED, CODEQWEN_SERVED, LLAMA3)
#: card vs CPU depth of the dense ones (qwen2-moe keeps phase 15's)
DENSE_CPU_LAYERS = 2
#: the host draws of phases 41-44 (``HostDraws``), in the order they
#: start: qwen2-moe-a2.7b's 138 s first, while phases 34-39 run; the rest
#: once phase 39 has freed its snapshot, llama3-8b's before the twins so
#: that it starts as soon as qwen2-moe's host copy is gone
DRAW_ORDER = (QWEN2_MOE.name, STABLELM.name, f"{STABLELM.name} twin",
              CODEQWEN.name, LLAMA3.name, f"{CODEQWEN.name} twin",
              f"{LLAMA3.name} twin")
#: GB of drawn models the draws may hold: none until phase 33's float32
#: CPU step is done (it holds about 27 GB beside phase 24's 18.5 GB
#: snapshot, and 48 GB of draws held through it exceeded the machine's 96
#: GiB); qwen2-moe's 28.6 GB through phases 34-39; more once phase 39 has
#: freed the snapshot
DRAW_BUDGET_GB = (0.0, 30.0, 72.0)
#: host memory a draw must leave available (GB)
HOST_RESERVE_GB = 12.0
#: threads drawing at once
DRAW_WORKERS = 2


def host_available() -> float:
    """Bytes of host memory available: MemAvailable, or the cgroup's
    limit less its use where that is less (read, never written)."""
    avail = float("inf")
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                avail = int(line.split()[1]) * 1024
    try:
        limit = Path("/sys/fs/cgroup/memory.max").read_text().strip()
        used = int(Path("/sys/fs/cgroup/memory.current").read_text())
        if limit != "max":
            avail = min(avail, int(limit) - used)
    except (OSError, ValueError):
        pass
    return avail


def param_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


class HostDraws:
    """Models drawn from ``SEED`` on the host by ``DRAW_WORKERS`` threads,
    each taking the next of ``jobs`` (``(key, cfg)``), which start in
    their order, while the earlier phases run: a draw is one host core's
    sequential work (one CPU generator), about 0.1 G values a second.  ``init_params(cfg, SEED,
    "cpu")`` draws on the host exactly what ``init_params(cfg, SEED,
    cuda)`` copies to the card as it draws, so a model taken here and
    moved with ``.to(cuda)`` holds the same bits.  A draw starts only
    where the models drawn and not yet released stay within ``budget``
    bytes and the host keeps ``HOST_RESERVE_GB`` available after it.  A
    monitor samples the host's available memory twice a second, its
    lowest reading kept per window of phases (:meth:`window`)."""

    def __init__(self, jobs, budget_gb: float):
        self.jobs = list(jobs)
        self.next_job = self.started = 0
        self.budget = budget_gb * 1e9
        self.held = 0
        self.ready: dict = {}
        self.log: dict = {}
        self.low_water: dict = {}
        self.error = None
        self.done = False
        self.cond = threading.Condition()
        self.t0 = time.perf_counter()
        self.window("phases 3-23")
        self.threads = [threading.Thread(target=self._work, daemon=True,
                                         name=f"host-draws-{i}")
                        for i in range(DRAW_WORKERS)]
        self.threads.append(threading.Thread(target=self._monitor,
                                             daemon=True, name="host-memory"))
        for t in self.threads:
            t.start()

    def window(self, name: str) -> None:
        """Lowest available host memory from here on goes under ``name``."""
        self.low_water[name] = host_available()
        self.current = name

    def set_budget(self, budget_gb: float) -> None:
        with self.cond:
            self.budget = budget_gb * 1e9
            self.cond.notify_all()

    def _monitor(self) -> None:
        while not self.done:
            name = self.current
            self.low_water[name] = min(self.low_water[name],
                                       host_available())
            time.sleep(0.5)

    def _work(self) -> None:
        try:
            while True:
                with self.cond:
                    if self.next_job == len(self.jobs) or self.error:
                        return
                    index = self.next_job
                    key, cfg = self.jobs[index]
                    self.next_job += 1
                need = param_bytes(model_tf.DenseLM(cfg, device="meta"))
                t_wait = time.perf_counter()
                with self.cond:
                    while not (self.started == index and
                               self.held + need <= self.budget and
                               host_available() - need
                               >= HOST_RESERVE_GB * 1e9):
                        self.cond.wait(timeout=1.0)   # freed memory shows
                    self.held += need                 # by polling too
                    self.started += 1
                    self.cond.notify_all()
                t0 = time.perf_counter()
                free = host_available()
                model = model_registry.init_params(cfg, SEED, "cpu")
                draw_s = time.perf_counter() - t0
                n = sum(p.numel() for p in model.parameters())
                with self.cond:
                    self.ready[key] = (model, need)
                    self.log[key] = {
                        "gb": need / 1e9, "params": n, "draw_s": draw_s,
                        "values_per_s": n / draw_s,
                        "held_back_s": t0 - t_wait,
                        "host_available_gb": free / 1e9,
                        "started_at_s": t0 - self.t0,
                        "ready_at_s": time.perf_counter() - self.t0}
                    self.cond.notify_all()
        except BaseException as e:     # handed to the main thread's take
            with self.cond:
                self.error = e
                self.cond.notify_all()

    def take(self, key: str) -> tuple:
        """The drawn model of ``key`` (waiting for it) and its bytes,
        which the caller hands back to :meth:`release` once the host
        copy is gone."""
        t0 = time.perf_counter()
        with self.cond:
            while key not in self.ready and self.error is None:
                self.cond.wait(timeout=1.0)
            if key not in self.ready:
                raise SystemExit(f"chip_smoke FAILED: drawing {key} on the "
                                 f"host: {self.error!r}")
            model, need = self.ready.pop(key)
            self.log[key]["main_waited_s"] = time.perf_counter() - t0
        return model, need

    def release(self, need: int) -> None:
        with self.cond:
            self.held -= need
            self.cond.notify_all()

    def finish(self) -> dict:
        self.done = True
        for t in self.threads:
            t.join(timeout=60)
        check(not any(t.is_alive() for t in self.threads) and not self.ready
              and self.error is None, "the host draws did not finish: "
              f"{sorted(self.ready)} {self.error!r}")
        return dict(self.log, host_low_water_gb={
            k: v / 1e9 for k, v in self.low_water.items()})


def serve_reckoning(cfg) -> dict:
    """The serve's device bytes reckoned from ``cfg`` on the meta device
    (nothing allocated): the parameters; the compute dict's copies
    (``DenseLM.weights()``: every cast and every join; a ``.to()`` that
    changes no dtype and the tied head's transpose are the parameter's
    own storage); the KV cache of ``SERVE_BATCH`` x the serve's
    ``max_len``.  The measured peak adds the prefill's activations and
    the allocator's blocks."""
    meta = model_tf.DenseLM(cfg, device="meta")
    own = {id(p) for p in meta.parameters()}

    def copies(tree) -> int:
        if isinstance(tree, dict):
            return sum(copies(v) for v in tree.values())
        if isinstance(tree, (list, tuple)):
            return sum(copies(v) for v in tree)
        if torch.is_tensor(tree) and id(tree) not in own and \
                tree._base is None:
            return tree.numel() * tree.element_size()
        return 0

    cache = model_attention.init_cache(
        cfg, SERVE_BATCH, PROMPT_LEN + NEW_TOKENS + 8, device="meta")
    out = {"params_gb": param_bytes(meta) / 1e9,
           "copies_gb": copies(meta._cast()) / 1e9,
           "kv_cache_gb": sum(t.numel() * t.element_size()
                              for t in cache) / 1e9}
    out["peak_gb"] = sum(out.values())
    return out


def head_order_hold(cfg, q, k, v) -> float:
    """The model's way into B2 (``models.attention.flash_attend``: q's
    heads from the reference's ``[G, Hkv]`` grouping into the kernel's
    ``[Hkv, G]`` and back) against the reference's plain grouped
    attention (``gqa_attend``) on the same heads: B2's captured q, k, v
    (``[B, H, S, hd]``, the kernel's head order) put back into the
    model's order and layout.  Held as ``flash_hold`` holds bf16; returns
    the largest gap."""
    bsz, heads, seq, hd = q.shape
    kv_heads = k.shape[1]
    group = heads // kv_heads

    def model_order(t):        # kernel head j * G + g -> model g * Hkv + j
        return t.view(bsz, kv_heads, group, seq, hd) \
            .permute(0, 3, 2, 1, 4).reshape(bsz, seq, heads, hd)

    qm, km, vm = model_order(q), k.transpose(1, 2), v.transpose(1, 2)
    got = model_attention.flash_attend(qm, km, vm, causal=True)
    want = model_attention.gqa_attend(qm, km, vm, causal=True)
    torch.cuda.synchronize()
    gap = (got.float() - want.float()).abs()
    limit = model_order(flash_bf16_atol(q, k, v, True)) \
        + BF16_RTOL * want.float().abs()
    ok = bool((gap <= limit).all())
    share = float((gap / limit.clamp_min(1e-30)).max())
    print(f"  flash_attend vs gqa_attend, {cfg.name}, {heads} q heads over "
          f"{kv_heads} kv heads (G = {group}): max_abs_err "
          f"{float(gap.max()):.3e}, largest gap {share:.3f} of its limit "
          f"{'ok' if ok else 'MISMATCH'}")
    check(ok, f"{cfg.name}: flash_attend's head order disagrees with the "
          f"reference's grouping")
    return float(gap.max())


def dense_kernel_checks(cfg, seen: dict) -> dict:
    """Phases 41-44: on a warm-up serve's own inputs, B2 at the prefill's
    shape (and its first 2 rows cut to 200 tokens) against its plain
    version, timed beside SDPA with its bound, and the model's head
    order into it against the reference's grouping; B4 at the prefill's
    and the decode step's shapes (its register route, or the wide one
    past 16 vectors a lane, and the generic one on an unaligned copy),
    held and timed, and at the prefill's shape cast to float32 (the
    float32 model's rows of phases 41-44's card vs CPU, which take the
    wide route past 8 KB)."""
    keys = [k for k in seen if k[0] == "flash"]
    check(len(keys) == 1, f"the {cfg.name} serve gave B2 shapes {keys}")
    q, k, v, causal = seen[keys[0]]
    want_q = (SERVE_BATCH, cfg.n_heads, PROMPT_LEN, cfg.hd)
    want_k = (SERVE_BATCH, cfg.n_kv_heads, PROMPT_LEN, cfg.hd)
    check(causal and q.dtype == torch.bfloat16 and tuple(q.shape) == want_q
          and tuple(k.shape) == want_k, f"B2 saw q {tuple(q.shape)} "
          f"{q.dtype}, k {tuple(k.shape)}, causal {causal}")
    flash = flash_entry("prefill", cfg.name, q, k, v, True, ragged=True)
    flash["group"] = cfg.n_heads // cfg.n_kv_heads
    flash["head_order_err"] = head_order_hold(cfg, q, k, v)
    rms = family_rms_rows(seen, 2, cfg.name)
    x, gamma, eps = seen[("rms", SERVE_BATCH, PROMPT_LEN, cfg.d_model)]
    rms_hold(x.reshape(-1, cfg.d_model).float(), gamma.float(), eps)
    return {"flash": flash, "rms": rms}


def new_serve(cfg, cuda, draws: HostDraws, phase: int) -> tuple:
    """One of phases 41-44: ``cfg``'s model, drawn on the host by
    ``draws``, moved to the card; its kernels on a warm-up serve's
    inputs (``dense_kernel_checks``); the serve as phases 10 and 14 run
    it, with its reckoned peak (``serve_reckoning``) beside the
    measured; for the dense family, card vs CPU at ``DENSE_CPU_LAYERS``
    layers (``family_cpu_compare``).  Returns the serve's stats and the
    kernel checks."""
    t0 = time.perf_counter()
    host, need = draws.take(cfg.name)
    drawn = draws.log[cfg.name]
    gc.collect()               # what earlier phases left in reference cycles
    torch.cuda.empty_cache()
    before_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    model = host.to(cuda)
    torch.cuda.synchronize()
    move_s = time.perf_counter() - t1
    del host
    draws.release(need)
    reckoned = serve_reckoning(cfg)
    dtypes = sorted({str(p.dtype)[6:] for p in model.parameters()})
    print(f"phase {phase}: serving model {cfg.name} ({cfg.n_layers} layers"
          f", d_model {cfg.d_model}, {cfg.n_heads} heads over "
          f"{cfg.n_kv_heads} of {cfg.hd}, vocab {cfg.vocab}, parameters in "
          f"{'/'.join(dtypes)}): {drawn['params']} parameters, drawn on the "
          f"host in {drawn['draw_s']:.2f} s ({drawn['values_per_s'] / 1e6:.1f}"
          f" M values/s, ready {drawn['ready_at_s']:.1f} s after the draws "
          f"began; this phase waited {drawn['main_waited_s']:.2f} s), moved "
          f"to the card in {move_s:.2f} s; "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB on the card, "
          f"{before_gb:.3f} of it before the move")
    print(f"  reckoned serve peak {reckoned['peak_gb']:.3f} GB: parameters "
          f"{reckoned['params_gb']:.3f}, compute copies "
          f"{reckoned['copies_gb']:.3f}, KV cache "
          f"{reckoned['kv_cache_gb']:.3f}")
    if cfg.n_layers < FULL_DEPTH[cfg.name]:
        full = serve_reckoning(cfg.scaled(n_layers=FULL_DEPTH[cfg.name]))
        print(f"  at its full {FULL_DEPTH[cfg.name]} layers the reckoned "
              f"serve peak is {full['peak_gb']:.3f} GB (parameters "
              f"{full['params_gb']:.3f}, copies {full['copies_gb']:.3f})")
        reckoned["full_depth_peak_gb"] = full["peak_gb"]
    seen = capture_inputs(cfg, model, cuda)
    print(f"  after the warm-up serve (the compute copies made): peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    checks = dense_kernel_checks(cfg, seen)
    del seen
    stats = serve_path(cfg, model, cuda, phase)
    stats.update(n_layers=cfg.n_layers, reckoned=reckoned, drawn=drawn,
                 move_s=move_s, before_gb=before_gb)
    print(f"  peak {stats['peak_mem_gb']:.3f} GB measured, "
          f"{reckoned['peak_gb']:.3f} reckoned "
          f"({reckoned['peak_gb'] / stats['peak_mem_gb']:.4f} of it; "
          f"{before_gb:.3f} GB were on the card before the move)")
    del model
    torch.cuda.empty_cache()
    if cfg.family == Family.DENSE:
        twin, need = draws.take(f"{cfg.name} twin")
        print(f"phase {phase}: card vs CPU, {cfg.name} at {DENSE_CPU_LAYERS}"
              f" layers, prefill of {CPU_BATCH} x {CPU_PROMPT} tokens (drawn"
              f" on the host in {draws.log[f'{cfg.name} twin']['draw_s']:.2f}"
              f" s)")
        stats["card_vs_cpu"] = family_cpu_compare(
            cfg.scaled(n_layers=DENSE_CPU_LAYERS), cuda, host=twin)
        del twin
        draws.release(need)
    print(f"phase {phase}: {time.perf_counter() - t0:.1f} s wall")
    return stats, checks


def draw_jobs() -> list:
    """The host draws of phases 41-44 in ``DRAW_ORDER``: the models of
    ``NEW_SERVES`` and the dense ones' twins at ``DENSE_CPU_LAYERS``
    layers."""
    jobs = {cfg.name: cfg for cfg in NEW_SERVES}
    jobs.update({f"{cfg.name} twin": cfg.scaled(n_layers=DENSE_CPU_LAYERS)
                 for cfg in NEW_SERVES if cfg.family == Family.DENSE})
    check(sorted(jobs) == sorted(DRAW_ORDER), f"draws {sorted(jobs)}")
    return [(key, jobs[key]) for key in DRAW_ORDER]


def entry_points() -> dict:
    """Phase 45: the port's quickstart (``repro_torch.examples.
    quickstart``: the smoke qwen2 trained 30 steps at 8 x 64, a
    4-request serve, the 8-group alltoall sweep with Algorithm 1) and
    the figure runner's ``selector`` and ``model`` suites
    (``repro_torch.benchmarks.run``), on the card as a user runs them;
    each output checked for its shape and finite values."""
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.configs import get_smoke_config
    from repro_torch.examples import quickstart

    t0 = time.perf_counter()
    print("phase 45: python -m repro_torch.examples.quickstart")
    got = quickstart.main([])
    losses = got["losses"]
    vocab = get_smoke_config("qwen2-1.5b").vocab
    check(len(losses) == 30 and bool(np.isfinite(losses).all())
          and losses[-1] < losses[0], f"quickstart losses {losses}")
    check(len(got["generated"]) == 4 and all(
        len(t) == 8 and all(0 <= x < vocab for x in t)
        for t in got["generated"]), f"quickstart tokens {got['generated']}")
    check(sorted(got["medians"]) == ["ADAPTIVE_0", "ADAPTIVE_3",
                                     "app_aware"]
          and all(np.isfinite(m) and m > 0
                  for m in got["medians"].values()),
          f"quickstart medians {got['medians']}")
    quick_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    print("phase 45: python -m repro_torch.benchmarks.run --only "
          "selector,model")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench_run.main(["--only", "selector,model"])
    lines = buf.getvalue().splitlines()
    print("\n".join(f"  {line}" for line in lines))
    rows = [line.split(",", 2) for line in lines[1:]]
    check(lines[0] == "name,us_per_call,derived" and all(
        len(r) == 3 and np.isfinite(float(r[1])) for r in rows),
        "benchmarks.run printed a malformed row")
    names = [r[0] for r in rows]
    check(sum(n.startswith("h100_selector.sweep.") for n in names) == 21
          and "h100_selector.crossover_bytes" in names
          and sum(n.startswith("model_validation.") for n in names) == 7,
          f"benchmarks.run rows {names}")
    out = {"quickstart_s": quick_s, "run_s": time.perf_counter() - t1,
           "losses": [losses[0], losses[-1]], "medians": got["medians"],
           "rows": len(rows)}
    print(f"phase 45: {time.perf_counter() - t0:.1f} s wall")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path needs one",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    cuda = torch.device("cuda")
    card = card_line()
    cap = torch.cuda.get_device_capability(0)
    print("phase 1:", card, "| capability", cap, "| torch", torch.__version__,
          "cuda", torch.version.cuda)
    check(on_hopper(), f"compute capability {cap}, want (9, 0)")

    t0 = time.perf_counter()
    libs = libraries()
    infos = build_all(libs)
    for lib in libs:
        lib.load()
    print(f"phase 2: built {len(infos)} kernel libraries in "
          f"{time.perf_counter() - t0:.2f} s wall")
    wide_spills = []
    for info in infos:
        print(f"  {info.path}: {info.seconds:.2f} s")
        entry = ""
        for line in info.log.splitlines():
            if "Compiling entry function" in line:   # mangled: cut the
                entry = line.split("'")[1]           # file's namespace
                entry = entry[entry.find("_cu_") + 4:][:48] \
                    if "_cu_" in entry else entry[:48]
            elif "registers" in line or "spill" in line:
                print("   ", entry, line.strip())
                if "spill stores" in line and ("rmsnorm_wide" in entry or
                                               "rmsnorm_bwd_wide" in entry):
                    wide_spills.append(int(line.split("bytes spill stores")[0]
                                           .split(",")[-1]))
    if any(info.path == rms_ops.LIB.path and info.log for info in infos):
        check(len(wide_spills) == 12 and not any(wide_spills),
              f"B4's wide-route builds spill: {wide_spills} bytes of spill "
              f"stores")
        print(f"  B4's {len(wide_spills)} wide-route builds: no spill")
    for lib in (FLASH_LIB, SSD_LIB):
        n_hgmma = hgmma_count(lib)
        print(f"  {lib.path.name}: {n_hgmma} HGMMA instructions in its "
              f"SASS ({'present' if n_hgmma else 'ABSENT'})")
        check(n_hgmma > 0, f"{lib.path.name}'s SASS holds no HGMMA")

    # phases 41-44's models are drawn on the host meanwhile
    draws = HostDraws(draw_jobs(), DRAW_BUDGET_GB[0])
    print(f"  host draws begun for phases 41-44 ({DRAW_WORKERS} threads): "
          f"{', '.join(key for key, _ in draws.jobs)} (at most "
          f"{DRAW_BUDGET_GB[0]:.0f}, {DRAW_BUDGET_GB[1]:.0f} and "
          f"{DRAW_BUDGET_GB[2]:.0f} GB held in phases 3-33, 34-39 and "
          f"40-44; "
          f"{host_available() / 1e9:.1f} GB of host memory available)")

    topo = DragonflyTopology(TopologyParams(n_groups=N_GROUPS))
    n_links = int(topo.n_links)
    check(n_links == 56_448 and topo.n_nodes == 4_608,
          f"unexpected machine: {n_links} links, {topo.n_nodes} nodes")
    src, dst, size = phase_inputs(topo, N_FLOWS)
    alloc = make_allocation(topo, 64, spread="inter_groups", seed=3)
    pol = RoutingPolicy(RoutingMode.ADAPTIVE_0)
    params = SimParams(seed=0, route_feedback_iters=FEEDBACK_ITERS,
                       profile_stages=True)

    # phase 3 on a probe simulator, so the main path's draws stay its own
    probe = DragonflySimulator(topo, params, device=cuda)
    pplan = probe.plan_for(src, dst, size)
    x = torch_backend._prepare_inputs(
        probe, probe._phase_begin(src, dst, size, pol, alloc, plan=pplan))
    kernels = kernel_checks(x, n_links)
    del probe, pplan, x

    # phase 4: the main path; launch counts from here on are its own
    loads = FEEDBACK_ITERS + 1
    planned = (loads, 1 + loads)      # sorted head + scattered tail each
    planless = (0, 1 + loads)
    segment_sum_sorted.launches = 0
    segment_sum_scatter.launches = 0
    print(f"phase 4: main path, {N_FLOWS} flows on {topo.n_nodes} nodes / "
          f"{n_links} links")
    sim = DragonflySimulator(topo, params, device=cuda)
    t0 = time.perf_counter()
    plan = sim.plan_for(src, dst, size)
    print(f"  plan_for: {time.perf_counter() - t0:.4f} s, "
          f"P = {plan.pair_links.shape[0]} app pairs")

    def planned_phase(s, p):
        return lambda: s.run_phase(src, dst, size, pol, alloc, plan=p)

    run_counted("warm-up phase", planned, planned_phase(sim, plan))
    sim.stage_time_s.clear()
    times = [run_counted(f"timed phase {i}", planned,
                         planned_phase(sim, plan))[1]
             for i in range(TIMED_PHASES)]
    phase_s = float(np.mean(times))
    stages = {k: v / TIMED_PHASES for k, v in sim.stage_time_s.items()}
    print(f"  phase_s {phase_s:.6f} (min {min(times):.6f}, max "
          f"{max(times):.6f}), flows_per_s {N_FLOWS / phase_s:.1f}, "
          f"launches per phase {sum(planned)}")
    print("  stages_s " + json.dumps({k: round(v, 6)
                                      for k, v in stages.items()}))
    run_counted("profiled phase", planned,
                lambda: device_profile(planned_phase(sim, plan)))
    run_counted("planless phase", planless,
                lambda: sim.run_phase(src, dst, size, pol, alloc))

    nsim = DragonflySimulator(
        topo, SimParams(seed=1, route_feedback_iters=FEEDBACK_ITERS,
                        notify_threshold_s=1e-5), device=cuda)
    for i in range(2):      # a raised flag shows after one phase's delay
        run_counted(f"notify warm-up phase {i}", planned,
                    planned_phase(nsim, nsim.plan_for(src, dst, size)))
    check(bool(nsim.notified_links.any()), "no congestion flag is visible")
    res, _ = run_counted("notifying phase", planned,
                         planned_phase(nsim, nsim.plan_for(src, dst, size)))
    check(res.notified is not None and bool((res.notified > 0).any()),
          "no flow crossed a flagged link")

    fsim = DragonflySimulator(
        topo, SimParams(seed=2, route_feedback_iters=FEEDBACK_ITERS),
        faults=FaultSchedule.of(link_down(n_random=2, seed=1)), device=cuda)
    res, _ = run_counted("faulted phase (2 global links down)", planned,
                         planned_phase(fsim, fsim.plan_for(src, dst, size)))
    check(res.stranded is not None, "the faulted phase carried no mask")

    counts = {"segment_sum_sorted": segment_sum_sorted.launches,
              "segment_sum_scatter": segment_sum_scatter.launches}
    for row in kernels:
        row["launches_by_path"] = {"simulator phase": counts[row["name"]]}

    # phase 5: the same seeded phase on the CPU
    print("phase 5: card vs CPU, one planned phase of seed 7")
    out = []
    for dev in (cuda, torch.device("cpu")):
        s = DragonflySimulator(topo, SimParams(
            seed=7, route_feedback_iters=FEEDBACK_ITERS), device=dev)
        out.append(s.run_phase(src, dst, size, pol, alloc,
                               plan=s.plan_for(src, dst, size)))
    a, b = out
    check(np.array_equal(a.flits, b.flits), "flits differ card vs CPU")
    rel = np.abs(a.t_us - b.t_us) / np.abs(b.t_us)
    print(f"  t_us max rel diff {rel.max():.3e} (rtol {CPU_RTOL}), "
          f"phase_time_us card {a.phase_time_us:.3f} cpu "
          f"{b.phase_time_us:.3f}")
    check(bool(np.allclose(a.t_us, b.t_us, rtol=CPU_RTOL, atol=0.0)),
          "card and CPU t_us disagree")

    # phases 6-8: the serving path
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 stays float32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    model = model_registry.init_params(MAMBA2, SEED, cuda)
    print(f"serving model: {sum(p.numel() for p in model.parameters())} "
          f"parameters, built in {time.perf_counter() - t0:.2f} s")
    kernels += serve_kernel_checks(capture_inputs(MAMBA2, model, cuda))
    serve_stats = {MAMBA2.name: serve_path(MAMBA2, model, cuda, 7)}
    del model
    torch.cuda.empty_cache()
    print(f"phase 8: card vs CPU, {MAMBA2.name} prefill of {CPU_BATCH} x "
          f"{CPU_PROMPT} tokens")
    cpu_compare(MAMBA2, cuda)

    # phases 9-11: the dense serving path
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = model_registry.init_params(QWEN2, SEED, cuda)
    print(f"dense serving model: {sum(p.numel() for p in model.parameters())}"
          f" parameters, built in {time.perf_counter() - t0:.2f} s")
    kernels.append(flash_checks(capture_inputs(QWEN2, model, cuda)))
    serve_stats[QWEN2.name] = serve_path(QWEN2, model, cuda, 10)
    del model
    torch.cuda.empty_cache()
    print(f"phase 11: card vs CPU, {QWEN2.name} prefill of {CPU_BATCH} x "
          f"{CPU_PROMPT} tokens")
    cpu_compare(QWEN2, cuda)

    # phase 12: the §5 protocol; B1 at its shapes first, then launch
    # counts from the main path's run are its own
    print(f"phase 12: the section-5 protocol, fig8's Piz-Daint rows "
          f"{list(PROTOCOL_ROWS)}, {PROTOCOL_ITERS} iterations")
    t0 = time.perf_counter()
    errs = dict(zip(("segment_sum_sorted", "segment_sum_scatter"),
                    protocol_kernel_checks(cuda, n_links)))
    for row in (r for r in kernels if r["name"] in errs):
        row["max_abs_err"] = max(row["max_abs_err"], errs[row["name"]])
    segment_sum_sorted.launches = 0
    segment_sum_scatter.launches = 0
    protocol = protocol_path(cuda, planned)
    counts = {"segment_sum_sorted": segment_sum_sorted.launches,
              "segment_sum_scatter": segment_sum_scatter.launches}
    for row in (r for r in kernels if r["name"] in counts):
        by_path = row["launches_by_path"]
        by_path["fig8 protocol"] = counts[row["name"]]
        check(all(n > 0 for n in by_path.values()),
              f"{row['name']} never ran on a simulator path: {by_path}")
        row["launches"] = sum(by_path.values())
    print("  protocol " + json.dumps(
        {key: {"wall_s": st["wall_s"], "policy_pct_default_traffic":
               st["row"]["policy_pct_default_traffic"], "arms": st["arms"]}
         for key, st in protocol.items()}))
    protocol_profile(cuda)
    print("phase 12: card vs CPU")
    protocol_cpu_check(cuda)
    print(f"phase 12: {time.perf_counter() - t0:.1f} s wall")

    # phase 13: the lockstep tenancy sweep; B1 at the batched shape
    # first, then launch counts from the lockstep run are its own
    print(f"phase 13: the lockstep tenancy sweep, the interference "
          f"matrix's first column on {n_links} links, "
          f"{TENANCY_ROUNDS} rounds")
    t0 = time.perf_counter()
    errs, batched_rows = tenancy_kernel_checks(cuda, n_links)
    errs = dict(zip(("segment_sum_sorted", "segment_sum_scatter"), errs))
    for row in (r for r in kernels if r["name"] in errs):
        row["max_abs_err"] = max(row["max_abs_err"], errs[row["name"]])
        row.update(batched_rows[row["name"]])
    tenancy_batch_check(cuda)
    column = tenancy_column_timed(cuda)
    counts = dict(zip(("segment_sum_sorted", "segment_sum_scatter"),
                      column["launches"]))
    for row in (r for r in kernels if r["name"] in counts):
        row["launches_by_path"]["tenancy lockstep"] = counts[row["name"]]
        row["launches"] = sum(row["launches_by_path"].values())
    tenancy_profile(cuda)
    interference = published_interference(cuda)
    print("  tenancy " + json.dumps(
        {"column": {k: v for k, v in column.items() if k != "launches"},
         "published_interference": interference,
         "idle": PROFILES.get("tenancy lockstep round")}))
    print(f"phase 13: {time.perf_counter() - t0:.1f} s wall")

    # phase 14: the MoE serving path, granite-moe-3b-a800m at full width
    # with its KV transfer routed by Algorithm 1; B2 at its shape first,
    # then launch counts from the serve are its own
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = model_registry.init_params(GRANITE, SEED, cuda)
    print(f"phase 14: MoE serving model {GRANITE.name}: "
          f"{sum(p.numel() for p in model.parameters())} parameters, "
          f"built in {time.perf_counter() - t0:.2f} s")
    seen = capture_inputs(GRANITE, model, cuda)
    entry = granite_flash_check(seen)
    flash_row = next(r for r in kernels if r["name"] == "flash_attention")
    flash_row["by_shape"] = [
        {k: flash_row[k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms",
                                   "library_graph_ms", "sdpa_factor")},
        entry]
    flash_row["max_abs_err"] = max(flash_row["max_abs_err"],
                                   entry["max_abs_err"])
    stats = serve_stats[GRANITE.name] = serve_path(
        GRANITE, model, cuda, 14, comm_policy="app_aware")
    w0, h0 = seen[("moe", SERVE_BATCH, PROMPT_LEN, GRANITE.d_model)]
    stats["moe_layer"] = moe_breakdown(w0, h0, GRANITE, GRANITE.n_layers,
                                       stats["prefill_busy_s"])
    print(f"phase 14: {time.perf_counter() - t0:.1f} s wall")

    # phase 15: card vs CPU, anchored routing under the tie rule
    t0 = time.perf_counter()
    print(f"phase 15: card vs CPU, {GRANITE.name} and {QWEN2_MOE.name} "
          f"prefill of {CPU_BATCH} x {CPU_PROMPT} tokens")
    del model
    torch.cuda.empty_cache()
    moe_cpu = {GRANITE.name: moe_cpu_compare(GRANITE, cuda)}
    moe_cpu[QWEN2_MOE.name] = moe_cpu_compare(QWEN2_MOE, cuda)
    print(f"phase 15: {time.perf_counter() - t0:.1f} s wall")

    # phase 16: the collectives in an NCCL world of one
    print("phase 16: the collective schedules and moe_ep on the card, an "
          "NCCL world of one")
    collectives = collectives_on_card(cuda, w0, h0, GRANITE)
    del seen, w0, h0
    print("  moe " + json.dumps({"card_vs_cpu": moe_cpu,
                                 "moe_ep_vs_ref": collectives}))

    # phases 17-18: the hybrid family, zamba2-7b at full width and depth;
    # its kernels at their shapes first, then launch counts from the
    # serve are its own
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = model_registry.init_params(ZAMBA2, SEED, cuda)
    torch.cuda.synchronize()
    print(f"phase 17: hybrid serving model {ZAMBA2.name} ({ZAMBA2.n_layers} "
          f"Mamba2 layers, shared block every {ZAMBA2.shared_attn_period}, "
          f"d_model {ZAMBA2.d_model}): "
          f"{sum(p.numel() for p in model.parameters())} parameters, built "
          f"in {time.perf_counter() - t0:.2f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    zamba2 = zamba2_kernel_checks(capture_inputs(ZAMBA2, model, cuda))
    print(f"phase 17: {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    serve_stats[ZAMBA2.name] = serve_path(ZAMBA2, model, cuda, 18)
    del model
    torch.cuda.empty_cache()
    print(f"phase 18: {time.perf_counter() - t0:.1f} s wall")

    # phase 19: the enc-dec family, whisper-large-v3 at full width and depth
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = model_registry.init_params(WHISPER, SEED, cuda)
    torch.cuda.synchronize()
    print(f"phase 19: enc-dec serving model {WHISPER.name} "
          f"({WHISPER.n_encoder_layers} + {WHISPER.n_layers} layers, "
          f"d_model {WHISPER.d_model}, {WHISPER.encoder_frames} frames): "
          f"{sum(p.numel() for p in model.parameters())} parameters, built "
          f"in {time.perf_counter() - t0:.2f} s")
    whisper = whisper_kernel_checks(capture_inputs(WHISPER, model, cuda))
    serve_stats[WHISPER.name] = serve_path(WHISPER, model, cuda, 19)
    del model
    torch.cuda.empty_cache()
    print(f"phase 19: {time.perf_counter() - t0:.1f} s wall")

    # the new shapes join each kernel's row
    rows = {r["name"]: r for r in kernels}
    new_flash = [zamba2["flash"]] + whisper["flash"]
    rows["flash_attention"]["by_shape"] += new_flash
    rows["ssd_inner"]["by_shape"].append(ssd_entry(zamba2["ssd"],
                                                   ZAMBA2.name))
    rows["rmsnorm_fused"]["by_shape"] += \
        [rms_entry(r, ZAMBA2.name) for r in zamba2["rms"]] + \
        [rms_entry(r, WHISPER.name) for r in whisper["rms"]]
    for name, errs in (("flash_attention", [e["max_abs_err"]
                                            for e in new_flash]),
                       ("ssd_inner", [zamba2["ssd"]["max_abs_err"]]),
                       ("rmsnorm_fused", [r["max_abs_err"] for r in
                                          zamba2["rms"] + whisper["rms"]])):
        rows[name]["max_abs_err"] = max([rows[name]["max_abs_err"]] + errs)

    # phase 20: card vs CPU for both families
    t0 = time.perf_counter()
    print(f"phase 20: card vs CPU, {ZAMBA2.name} at {ZAMBA2_CPU_LAYERS} "
          f"layers and {WHISPER.name} at {WHISPER_CPU_LAYERS} + "
          f"{WHISPER_CPU_LAYERS} layers, prefill of {CPU_BATCH} x "
          f"{CPU_PROMPT} tokens")
    family_cpu = {
        ZAMBA2.name: family_cpu_compare(
            ZAMBA2.scaled(n_layers=ZAMBA2_CPU_LAYERS), cuda),
        WHISPER.name: family_cpu_compare(
            WHISPER.scaled(n_layers=WHISPER_CPU_LAYERS,
                           n_encoder_layers=WHISPER_CPU_LAYERS), cuda)}
    print("  families " + json.dumps(family_cpu))
    print(f"phase 20: {time.perf_counter() - t0:.1f} s wall")

    # phase 21: the VLM family, paligemma-3b at full width and depth; B2
    # and B4 at their shapes first, then launch counts from the serve are
    # its own
    t0 = time.perf_counter()
    check(serve_launches(PALIGEMMA) == ((flash_attention, rmsnorm_fused),
                                        (18, 37), (0, 37)),
          f"{PALIGEMMA.name}: launches per prefill and step "
          f"{serve_launches(PALIGEMMA)[1:]}")
    torch.cuda.reset_peak_memory_stats()
    model = model_registry.init_params(PALIGEMMA, SEED, cuda)
    torch.cuda.synchronize()
    print(f"phase 21: VLM serving model {PALIGEMMA.name} "
          f"({PALIGEMMA.n_layers} layers, d_model {PALIGEMMA.d_model}, "
          f"{PALIGEMMA.n_heads} heads over {PALIGEMMA.n_kv_heads} of "
          f"{PALIGEMMA.hd}, {PALIGEMMA.img_tokens} image tokens): "
          f"{sum(p.numel() for p in model.parameters())} parameters, built "
          f"in {time.perf_counter() - t0:.2f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    paligemma = paligemma_kernel_checks(capture_inputs(PALIGEMMA, model,
                                                       cuda))
    serve_stats[PALIGEMMA.name] = serve_path(PALIGEMMA, model, cuda, 21)
    del model
    torch.cuda.empty_cache()
    rows["flash_attention"]["by_shape"].append(paligemma["flash"])
    rows["rmsnorm_fused"]["by_shape"] += [rms_entry(r, PALIGEMMA.name)
                                          for r in paligemma["rms"]]
    for name, errs in (("flash_attention", [paligemma["flash"][
            "max_abs_err"]]), ("rmsnorm_fused", [r["max_abs_err"] for r in
                                                 paligemma["rms"]])):
        rows[name]["max_abs_err"] = max([rows[name]["max_abs_err"]] + errs)
    print(f"phase 21: {time.perf_counter() - t0:.1f} s wall")

    # phase 22: card vs CPU for the VLM at a cut depth
    t0 = time.perf_counter()
    print(f"phase 22: card vs CPU, {PALIGEMMA.name} at "
          f"{PALIGEMMA_CPU_LAYERS} layers, prefill of {CPU_BATCH} x "
          f"({PALIGEMMA.img_tokens} image + {CPU_PROMPT}) tokens")
    vlm_cpu = family_cpu_compare(
        PALIGEMMA.scaled(n_layers=PALIGEMMA_CPU_LAYERS), cuda)
    print("  vlm " + json.dumps({PALIGEMMA.name: vlm_cpu}))
    print(f"phase 22: {time.perf_counter() - t0:.1f} s wall")

    # phase 23: the backward kernels on a qwen2-1.5b train step's inputs
    kernels += backward_kernel_checks(cuda)

    # phase 24: the training path; launch counts from here on are its own
    draws.window("phases 24-33")
    t0 = time.perf_counter()
    train = train_path(cuda)
    print(f"phase 24: {time.perf_counter() - t0:.1f} s wall")

    # phase 25: card vs CPU, one float32 train step at 2 layers
    train["card_vs_cpu"] = train_cpu_compare(cuda)
    trains = {QWEN2.name: train}

    # phase 26: B3's backward on a mamba2-130m train step's inputs
    kernels.append(ssm_backward_checks(cuda))

    # phase 27: the SSM training path; launch counts from here on are its
    # own
    t0 = time.perf_counter()
    trains[MAMBA2.name] = ssm_train_path(cuda)
    print(f"phase 27: {time.perf_counter() - t0:.1f} s wall")

    # phase 28: card vs CPU, one float32 mamba2-130m step at 2 layers
    trains[MAMBA2.name]["card_vs_cpu"] = train_cpu_compare(cuda, MAMBA2, 28)

    # phase 29: the hybrid training path at a cut depth, then its backward
    # kernels on its first step's inputs
    trains[ZAMBA2.name], zrows = hybrid_train_path(cuda)

    # phase 30: card vs CPU, one float32 zamba2-7b step at full width with
    # the shared block applied twice
    trains[ZAMBA2.name]["card_vs_cpu"] = train_cpu_compare(
        cuda, ZAMBA2, 30, **ZAMBA2_CPU_CUT)

    # phase 31: B2's backward at head dim 256 and B4's at [6144,2048] on a
    # paligemma-3b train step's inputs
    vrows = vlm_backward_checks(cuda)

    # phase 32: the VLM training path; launch counts from here on are its
    # own
    t0 = time.perf_counter()
    trains[PALIGEMMA.name] = vlm_train_path(cuda)
    print(f"phase 32: {time.perf_counter() - t0:.1f} s wall")

    # phase 33: card vs CPU, one float32 paligemma-3b step at 2 layers
    trains[PALIGEMMA.name]["card_vs_cpu"] = train_cpu_compare(
        cuda, PALIGEMMA, 33)
    draws.set_budget(DRAW_BUDGET_GB[1])
    draws.window("phases 34-39")

    # phase 34: the MoE training path at the reckoned depth; launch counts
    # from here on are its own, its first step's backward inputs kept
    t0 = time.perf_counter()
    trains[GRANITE.name], granite_seen = moe_train_path(cuda)
    print(f"phase 34: {time.perf_counter() - t0:.1f} s wall")

    # phase 35: card vs CPU, one float32 granite step at 2 layers, the
    # card's routing anchored to the CPU's
    trains[GRANITE.name]["card_vs_cpu"] = train_cpu_compare(cuda, GRANITE,
                                                            35)

    # phase 36: the enc-dec training path at full depth; launch counts
    # from here on are its own, its first step's backward inputs kept
    t0 = time.perf_counter()
    trains[WHISPER.name], whisper_seen = encdec_train_path(cuda)
    print(f"phase 36: {time.perf_counter() - t0:.1f} s wall")

    # phase 37: card vs CPU, one float32 whisper step at 2 + 2 layers
    trains[WHISPER.name]["card_vs_cpu"] = train_cpu_compare(
        cuda, WHISPER, 37, **WHISPER_CPU_CUT)

    # phase 38: B2's and B4's backward at the new families' shapes
    nrows = new_shape_backward_checks(granite_seen, whisper_seen)
    del granite_seen, whisper_seen
    torch.cuda.empty_cache()

    # phase 39: elastic restart of phase 24's trained state
    t0 = time.perf_counter()
    trains[QWEN2.name]["elastic"] = elastic_restart(cuda)
    draws.set_budget(DRAW_BUDGET_GB[2])    # the snapshot is gone
    draws.window("phases 40-44")
    print(f"phase 39: {time.perf_counter() - t0:.1f} s wall")

    # phase 40: the dry run's reckoning beside this run's steps
    t0 = time.perf_counter()
    reckoning = dryrun_reckoning(serve_stats, trains)
    print(f"phase 40: {time.perf_counter() - t0:.1f} s wall")
    print("  reckoning " + json.dumps(reckoning))

    # phases 41-44: the configs not served at full size before, their
    # kernels at their shapes first, then launch counts from each serve
    # are its own
    rows = {r["name"]: r for r in kernels}
    for phase, cfg in enumerate(NEW_SERVES, 41):
        serve_stats[cfg.name], got = new_serve(cfg, cuda, draws, phase)
        rows["flash_attention"]["by_shape"].append(got["flash"])
        rows["rmsnorm_fused"]["by_shape"] += [rms_entry(r, cfg.name)
                                              for r in got["rms"]]
        for name, errs in (("flash_attention", [
                got["flash"]["max_abs_err"], got["flash"]["head_order_err"]]),
                ("rmsnorm_fused", [r["max_abs_err"] for r in got["rms"]])):
            rows[name]["max_abs_err"] = max([rows[name]["max_abs_err"]]
                                            + errs)
    print("  host draws " + json.dumps(draws.finish()))

    # phase 45: the port's examples and figure runner, as a user runs them
    entry = entry_points()
    print("  entry points " + json.dumps(entry))
    for name, entries in (("flash_attention_bwd", [zrows["flash"],
                                                   vrows["flash"]]
                           + nrows["flash"]),
                          ("ssd_inner_bwd", [zrows["ssd"]]),
                          ("rmsnorm_bwd", zrows["rms"] + [vrows["rms"]]
                           + nrows["rms"])):
        rows[name].setdefault("by_shape", []).extend(
            {k: e[k] for k in ("model", "attention", "shape", "causal",
                               "prefix_len", "max_abs_err", "ms", "plain_ms",
                               "bound_ms", "bound_by", "library_ms",
                               "float32", "kernel_route", "generic_ms",
                               "copy_graph_ms")
             if k in e} for e in entries)
        rows[name]["max_abs_err"] = max([rows[name]["max_abs_err"]] +
                                        [e["max_abs_err"] for e in entries])

    # each kernel's launches on the serving and training paths that run
    # it; the backward kernels on a training path
    paths = {f"serve {name}": st["launches"]
             for name, st in serve_stats.items()}
    paths.update({f"train {name}": st["launches"]
                  for name, st in trains.items()})
    for row in kernels:
        if row["name"].startswith("segment_sum"):
            continue
        by_path = {name: counts[row["name"]]
                   for name, counts in paths.items() if row["name"] in counts}
        check(all(n > 0 for n in by_path.values()) and by_path,
              f"{row['name']} never ran on a serving or training path: "
              f"{by_path}")
        if row["name"].endswith("_bwd"):
            check(any(n > 0 for name, n in by_path.items()
                      if name.startswith("train ")),
                  f"{row['name']} never ran on a training path")
        row["launches"], row["launches_by_path"] = sum(by_path.values()), \
            by_path
    for name, st in serve_stats.items():
        print(f"  serve {name} " + json.dumps(
            {k: v for k, v in st.items() if k != "launches"}))
    for name, st in trains.items():
        print(f"  train {name} " + json.dumps(
            {k: v for k, v in st.items() if k != "launches"}))

    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
