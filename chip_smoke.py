#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--only 8,9]

Run it from the root of a checkout on a machine with an NVIDIA H100 (any
``sm_90a`` card) and the CUDA toolkit.  It imports neither JAX nor the JAX
package, and runs twenty-eight phases; any failure raises and exits non-zero
(``--only`` runs the build and the listed phases, and prints no result):

1. build — compiles every CUDA kernel of the port from ``src/repro_torch/
   kernels/csrc`` with ``nvcc`` (one process per source, all at once);
2. kernel — holds the sparse-gather decision kernel against its plain
   PyTorch version on the card, at T=50, N=100 and at T=500, N=10 000:
   candidates, scores and choices exact; times both with CUDA events;
   then the edge cases of the decision template (below);
3. testbed — the batched Dodoor driver on the paper's 100-server testbed
   under the Azure and FunctionBench traces (m=4000, b=50) on the card,
   against the same runs on the CPU: placements exact (or the first
   divergent task picked its other sampled candidate), the four-field
   message ledger exact, no capacity violation, one kernel launch per
   decision block;
4. scale — the 10 000-server Azure point (m=200 000, qps=400, b=500): every
   task on a server whose capacity admits it, the ledger equal to its
   closed form, one kernel launch per block; the first SCALE_CPU_TASKS
   tasks run on both devices, placements as in phase 3 and the ledger
   equal to the CPU run's;
5. masked kernel — holds K2 (down-window availability in the prefilter)
   against its plain version at the shapes of phase 2, with windows from
   ``random_outages`` merged with ``random_churn`` and rows whose every
   server is down (the fallback), as phase 2 checks K1; with every window
   at +inf K2 must equal K1 bit for bit; K2 is timed on the window-major
   planes made once, as the engine passes them; then the edge cases with
   1, 8 and 11 windows (11: above the unrolled bound);
6. scenario testbed — the six scenarios of the scenario benchmark and a
   "maintenance" scenario (rolling restart, stragglers, a store outage) on
   the 100-server testbed (FunctionBench m=4000 at 60 qps, b=50), each
   against the same run on the CPU as in phase 3, plus: no task on a
   server that is down at its submit time unless all its feasible servers
   were, no start inside a gate window, one K2 launch per block under down
   windows and one K1 launch per block otherwise;
7. scale with dynamics — the point of phase 4 under node churn and 2 000
   outage windows, with the checks of phase 6 (the capacity check sampled
   200 times over the run) and the ledger against its closed form; its
   first SCALE_CPU_TASKS tasks against the CPU as in phase 4;
8. locality kernel — holds K3, the locality form of K1 and of K2, against
   its plain version at (T, N, P) = (50, 100, 8), (50, 100, 40),
   (50, 100, 100) (three padded windows in the parent sum) and
   (500, 10 000, 8), with parents on about three quarters of the P slots,
   non-integer MB and γ/bandwidth = 0.7/1.3: candidates, scores and
   choices exact; with γ = 0 each form equals K1 (K2) bit for bit; then
   the edge cases with 8 and 40 parents, without windows and with 8;
9. DAG testbed — the frontier loop on the testbed (FunctionBench
   m=``DAG_TASKS`` at 60 qps, b=50): the chain (on the first ``CHAIN_TASKS`` tasks, a
   wave each),
   fan-out and map-reduce shapes of the DAG
   benchmark without a LocalityModel and with γ = 2, a layered DAG under
   γ/bandwidth = 0.7/1.3, and map-reduce under γ = 2 and 25 outages (the
   masked K3); each against its CPU run (placements as in phase 3, then
   the ledger and every time plane exact), no start before a parent's
   finish plus the edge delay, one launch per block of every wave, and
   fewer parent bytes moved at γ = 2 for fan-out and map-reduce;
10. DAG scale — fan-out (width 8) at 10 000 servers over the Azure trace
   of phase 4 under γ = 2: three waves, 400 K3 launches, no task before
   its parents; the graph of the first SCALE_CPU_TASKS tasks against the
   CPU run;
11. retries testbed — the densest point of the fault benchmark (25
   outages, FunctionBench m=3000 at 60 qps on the testbed) under the
   default, the aggressive and a hard-capacity retry policy: every plane
   (attempts, failed and wasted_ms included) and the ledger equal to the
   CPU run's, one K2 launch per block of every wave;
12. retries scale — phase 7's point, cut to SCALE_CPU_TASKS tasks, under
   the default retry policy, checked as phase 11;
13. K5 — first the launch floor (an empty kernel between the two events
   of ``event_ms``); then the two-stage selection kernel against its
   plain version at (T, N) = (50, 100), (2048, 100) and (500, 10 000),
   with identical candidates and exact ties (which keep A): choices and
   scores exact, two calls bit for bit with each tasks a block
   ``plan_k5`` can pick; its edge cases (``K5_EDGES``: one task, N = 1,
   odd N, operands 8-byte but not 16-byte aligned; rows on servers 0 and
   N − 1, identical, tied and idle candidates) through the wrapper and the
   launcher with 32, 64, 256 and the plan's tasks a block, on outputs
   filled with sentinels; the tasks a block swept (``K5_TPBS``); then
   ``dodoor_select_batch(use_kernel=True)`` on the card against
   ``use_kernel=False`` on the card and against the same call on the
   CPU, one K5 launch per call; then the library decision loop (below)
   through ``dodoor_select_batch(use_kernel=True)``;
14. K4 — the dense megakernel in both forms against its plain version at
   (50, 100), (500, 10 000) and (1024, 10 000): candidates, choices and
   scores exact; K4 on ``d = d_types[:, node_type]`` equal to K1 and
   K4-masked with ``avail = avail_rows(windows)`` (phase 5's windows,
   all-down rows included) equal to K2 bit for bit; the edge cases in
   both forms (availability from 1, 8 and 11 windows); then the library
   loop through ``dodoor_fused`` without and with an availability plane,
   on the testbed and at 10 000 servers;
15. K6 — the RL score matrix against its plain version at (T, N, K) =
   (2048, 100, 2), (500, 10 000, 2), (1024, 10 000, 2), (384, 257, 8)
   and (50, 100, 2), the library loop's shape: exact;
   ``torch.mm(r, L.T) * inv`` timed beside it as the library call; its
   edge cases at every (T, N, K) of T ∈ {1, 50, 2 048}, N ∈ {1, 3, 4,
   100, 257, 10 000}, K = 1..8, through the wrapper (two calls bit for
   bit) and the launcher under the plans of ``k6_plans`` on NaN-filled
   outputs; the rows a thread swept (``K6_RPT_SWEEP``); then the library
   loop recording each block's score matrix.
16. K7 — flash attention against ``attention_ref`` on the card at the
   reference's seven float32 pins (GQA, Lq < Lk, decode, window 64,
   ragged 100/200, non-causal D = 128; rtol 2e-4 / atol 2e-5) and its
   bf16 pin (the float32 bound plus one bf16 rounding of the output),
   then at tinyllama-1.1b's prefill (B, H, Hkv, L, D) = (4, 32, 4, 1024,
   64) and decode (Lq = 1, Lk = 1024), timed beside the plain version and
   ``scaled_dot_product_attention(enable_gqa=True)``, and the serving
   decode: a float32 query over the prefix of a bf16 cache read in place,
   the step's own key and value as the last row (timed); then the two
   regimes' edge cases (``K7_EDGES``: 16 and 17 rows a group, Lk = 1,
   63, 65 and 1 025, a window shorter than a run of keys, D = 32 and 128
   in both regimes, bf16 queries, the last row over a bf16 cache with
   several runs, a causal Lq < Lk prefill), each through the wrapper and,
   for the split kernel, through the launcher with 1, 2, 3, the planned
   and more runs than tiles (empty runs) on NaN-filled outputs; two calls
   bit for bit at the prefill and the decode; and the split kernel timed
   at 1, 2, 4, 8, 16 and the planned runs (``K7_SPLIT_SWEEP``);
17. K8 — the SSD chunk kernel against ``ssd_chunk_ref`` (y_intra, H_out,
   exp_s within rtol = atol = 2e-4) and ``ssd`` against the recurrence
   ``ssd_ref`` at the reference's four pins, a 12-step chunk and
   mamba2-1.3b's geometry at B = 2, L = 1024 (timed; two calls bit for
   bit equal); then the block design's edge cases (``K8_EDGES``), each
   through the wrapper and through the launcher with 1, 2, 3, 4 and all
   heads of a group a block (short last runs, idle teams), and on
   misaligned views;
18. tinyllama-1.1b serving at full width and depth, weights from a seed:
   ``forward`` on 4 × 1024 tokens (finite logits, 22 K7 launches); four
   128-token prompts through ``decode_step`` into a float32 cache (22
   launches a step; logits within 1e-3 of the largest |logit| of
   ``forward``'s on the prompts) and into the default bf16 cache (within
   5e-2), then 32 greedy tokens on the bf16 cache; a 2-layer copy with
   the same weights on the card against the CPU (within 1e-4 of the
   largest |logit|); prefill and decode tokens/s;
19. mamba2-1.3b serving, as phase 18 with ``forward`` on 2 × 1024 tokens
   (48 K8 launches), ``decode_step`` launching no kernel (the one-token
   recurrence, as in the reference), decode within 5e-3 and its default
   cache float32;
20. profiled scale runs — phases 4 and 7's card runs once more, on their
   first ``PROFILED_TASKS`` tasks, under
   ``torch.profiler`` (device activity): the decision kernel's total
   device time and launches, the device's busy share of the wall time,
   and the wall (inflated by the profiler); the timed runs of phases 4
   and 7 stay unprofiled;
21. sequential oracle — ``simulate(mode="sequential")`` on the testbed
   (the first ``SEQ_TASKS`` tasks of FunctionBench m=4000 at 300 qps,
   b=50) for random, PoT, dodoor,
   (1+β) and Prequal on the card, each against the same run on the CPU
   (the ledger exact, placements exact or a candidate flip as in phase
   3, every time plane within rtol 1e-6 / atol 1e-3 up to a divergence)
   and dodoor's also against the batched driver on the card; it launches
   no kernel, and syncs the card no more for 300 tasks than for 100;
   then the message-reduction point of the fault benchmark (25 outages,
   FunctionBench m=3000 at 60 qps, the default RetryPolicy, b=50, seeds
   0 and 1) for dodoor, PoT and Prequal on the card: every seed's message
   total, the msgs/task means and the reductions equal to the JAX
   reference's, printed as a ``message_reduction`` JSON line; last,
   ``core.balls_bins.run_balls_into_bins`` on the card (m=2000 balls, 100
   bins, β ∈ {1, 0.5}), its loads against the CPU's bit for bit, with no
   more host syncs for 300 balls than for 100.
22. batched probing and serving — PoT's speculative commit and Prequal's
   segment scan on the batched driver: on the testbed (the first
   ``PROBE_TASKS`` tasks of FunctionBench m=4000 at 300 qps, b=50) each
   card run against its CPU run bit for
   bit and against the sequential oracle on the CPU (ledger and
   placements exact, time planes within rtol 1e-6 / atol 1e-3, printed
   whether bit for bit), no kernel launched, and no host sync beyond one
   a speculative iteration (PoT) or a chunk (Prequal), counted at 100
   and 300 tasks; at 10 000 servers (phase 4's Azure trace cut to its
   first 20 000 tasks, Prequal's to 5 000, b=500) against the CPU run
   bit for bit; the fault
   benchmark's message point in the batched driver for dodoor, PoT and
   Prequal, seeds 0 and 1, equal to phase 21's constants; then
   ``serve_workload`` on the card for all five policies on the testbed
   (chunks of 50 and 37 tasks) and for dodoor at the 10 000-server
   point, each bit for bit equal to ``simulate(device="cuda")`` with one
   K1 launch a block for dodoor and (1+β) and none for the others, and a
   checkpoint at task 2 000 resumed bit for bit (dodoor, Prequal):
   decisions/s, the step's p50/p99 and host syncs a block.
23. trace, cache faults and grids — (a) ``EngineConfig(trace=True)``:
   phase 3's FunctionBench testbed trace for dodoor and (1+β), traced and
   untraced in turns (untraced, traced, traced, untraced), the traced run
   bit for bit equal to the untraced one and, with its six trace planes,
   to the CPU's traced run, one K1 launch a block, and as many host
   syncs traced as untraced (300 tasks, with the syncing lines named on
   a mismatch); phase 6's outage storm traced (K2) and phase 9's
   map-reduce under γ = 2 traced (K3), each against its CPU run; dodoor
   at 10⁴ servers on phase 22's 20 000-task cut (b = 500) traced and
   untraced in turns, both decisions/s printed, traced equal to untraced;
   (b) the fault benchmark's loss point (FunctionBench m = 3000 at 60
   qps, ``CacheFaults(loss_rate=0.5, seed=5)``) timed against the
   unfaulted run in turns, then with 0 and 25 outages in both modes,
   each against its CPU run and launching no kernel, and the service
   under the same dynamics against ``simulate`` on the card; (c)
   ``benchmarks/bench_study.py``'s 18-point grid (seeds 0, 1 × α 0.3,
   0.5, 0.7 × steady / bursty MMPP / outage storm, m = ``STUDY_TASKS``)
   through
   ``run_study`` on the card, every point equal to the card's
   ``run_scenario`` (both walls printed, K1 and K2 launches counted),
   ``simulate_many`` traced over b ∈ {25, 50} × α ∈ {0.5, 1.0} against
   the CPU with each point's staleness and misplacement,
   ``run_study(server_shards=4)`` against ``simulate_hierarchical``, and
   the mean-field check of ``tests/test_meanfield.py:108`` at n = 10³
   (λ = 0.7, m = 30 000, b = 50; PoT and dodoor inside
   ``tolerance_band``; card only).
24. MoE serving and the serve launcher — qwen3-moe-235b-a22b at full
   width (d 4096, 64 heads of 128 over 4 KV heads, 128 experts top-8,
   ``moe_d_ff`` 1536, vocab 151 936) cut to 2 of 94 layers, float32
   weights from a seed: K7 at its prefill and its decode over the bf16
   cache (timed, against the plain version); ``forward`` on 4 × 1024
   tokens (two 2048-token groups, so the dodoor load carries across a
   group) with the published ``topk`` router and with ``dodoor`` on the
   same weights (finite logits, one K7 launch a layer; tokens per expert
   max/mean and the dropped share of the choices printed); four
   128-token prompts through ``decode_step`` and 32 greedy tokens (one
   K7 launch a layer-step, ms a step); a 1-layer copy with the same
   weights on 1 × 2 100 tokens (a full group and a mostly padded one),
   card against CPU, for each router: at most 0.1 % of the (token,
   choice) routes (expert and kept) differ, logits within 1e-4 of the
   largest |logit| on the tokens whose routes agree, ``moe_aux`` within
   1e-5 relative (widened only by what differing routes can move it);
   then dbrx-132b (2 of 40 layers, 16 experts top-4) the same way without
   decode and copy; then ``repro_torch.launch.serve.main`` (qwen3-moe's
   400-request trace, all four policies through the sequential oracle,
   eight router placements, the smoke model's greedy decode) on the card
   against the same call with ``--device cpu``: the policy rows and
   placements equal, 16 in-vocabulary tokens on each, one K7 launch a
   layer-step of the demo.
25. VLM, hybrid and audio serving — K7 at head width 256 against its
   plain version at recurrentgemma-2b's prefill (2 × 4096 tokens, 10
   heads over one KV head, window 2048) and decode (the 2048-slot ring,
   float32 and over the bf16 ring with the step's own row), timed beside
   the plain version and SDPA; then qwen2-vl-2b (28 layers), recurrentgemma-2b
   (26) and whisper-base (6 + 6) at full width and depth, float32
   weights from a seed: ``forward`` on 4 × 1024 positions (256 patch
   embeddings on a 16 × 16 grid with their M-RoPE streams), 2 × 4096
   tokens and 1500 frames with 4 × 448 tokens (finite logits, one K7
   launch an attention call); decode against ``forward`` on a prompt
   (128, 64 and 32 tokens; whisper's cache primed from the frames) in a
   float32 cache and in the default bf16 cache, then greedy tokens (one
   K7 launch an attention call a step); a copy card against CPU (2
   layers; recurrentgemma one (R, R, A) block on 300 tokens; whisper two
   encoder and two decoder layers) within 1e-4 of the largest |logit|.
26. training — (a) K7's backward (``flash_attention`` under autograd, one
   forward, which writes the lse, and one backward launch, and
   ``flash_attention_bwd``) against ``attention_bwd_ref`` on the card in
   float32 at ``K7_BWD_CASES`` (GQA, Lq < Lk, a window, non-causal,
   ragged, D = 32 / 64 / 128, two runs of rows, a 16-row group, D = 128
   causal with a window) and ``K7_BWD_TIMED`` (tinyllama-1.1b's and
   qwen3-moe's prefill): each of dq, dk, dv within 2e-4·|ref| +
   2e-5·max|ref|, autograd equal to the wrapper, the forward's lse
   against ``attention_lse_ref`` and its output equal to the forward's
   without lse, two calls bit for bit, the backward given the forward's
   lse and output timed beside the plain version and SDPA's backward; a
   bf16 call at head width 256 and ``kv_last`` under grad each raise
   before any launch; the
   forward's output against float64 attention at ``K7_BIAS_SHAPES``, its
   mean signed error within ``K7_BIAS_MAX`` (F7); (b)
   tinyllama-1.1b trained at full width and depth
   (``TRAIN_STEPS`` steps of ``SyntheticLM`` 4 × 1024, lr 1e-3 on the
   cosine schedule, remat): finite losses, the last below the first, K7
   launches 2 × 22 forward and 22 backward a step, ms a step, tokens/s
   and peak memory; (c) a 2-layer copy of those weights, one step's loss
   (1e-5 relative) and gradients (1e-4 of each leaf's largest value) on
   the card against the CPU; (d) ``repro_torch.launch.train`` twice on
   smollm-135m at full width (``LAUNCH_LAYERS`` deep; 8 × 256, 30 steps,
   a checkpoint every 10, a failure at 15): the losses bit for bit, and
   the state saved at step 20 restored bit for bit; (e) tinyllama-1.1b's
   ``forward`` under ``precision.options(dtype=torch.bfloat16)``: finite
   logits, argmax equal to float32's on ≥ 0.9 of positions, both timed.
27. training of every family — (a) K8's backward (``ssd_chunk_bwd``)
   against ``ssd_chunk_bwd_ref`` at ``K8_SHAPES`` and ``K8_BWD_MORE``
   (several runs of heads, one head a group, a short chunk), through the
   wrapper and through the launcher with 1, 2, 3 and all heads a block,
   each of dx, ddelta, ddt, dB, dC within 2e-4·|ref| + 2e-5·max|ref|, two
   calls bit for bit, each gradient's mean signed error against the
   plain version in float64 printed beside the float32 plain version's,
   timed at mamba2-1.3b's training shape
   (``TRAIN_SSM_SHAPE``) beside the plain version; (b) K7's backward at
   head width 256 at ``K7_BWD_256_CASES`` (GQA over one KV head, a window,
   non-causal, Lq < Lk, 16 rows a group, two runs) with phase 26's
   checks, timed at recurrentgemma-2b's prefill beside the plain version
   and SDPA's backward (its window as a mask); (c) mamba2-1.3b at full
   width and depth and recurrentgemma-2b at full width
   (``TRAIN_HYBRID_LAYERS`` deep) trained ``TRAIN_STEPS`` steps on
   ``SyntheticLM`` (lr 1e-3, cosine): finite losses, the last below the
   first, launches a step (remat checkpoints every layer or block, F9)
   96 K8 (48 and their recomputation) and 48 K8 backward, and two K7
   forwards and one backward an attention layer; ms a step, tokens/s,
   peak memory beside the peaks without remat (``NO_REMAT_PEAK_GB``);
   (d) one train step of cut copies of mamba2-1.3b, recurrentgemma-2b,
   qwen3-moe-235b-a22b (1 layer, a batch whose routes agree on both
   devices), qwen2-vl-2b and whisper-base, card against CPU, within phase
   26's gates.
28. sizing and dry-run — (a) ``train.abstract_train_state`` (meta
   tensors) of tinyllama-1.1b, mamba2-1.3b and the 6-layer
   recurrentgemma-2b equal, leaf for leaf in shape and dtype, to the
   state phases 26–27 trained; (b) the cost model
   (``launch/costmodel.py`` on ``MeshDims(1, 1, 1)`` with remat for
   every family, the roofline at the H100's FP32 peak) and
   ``launch.dryrun.state_bytes`` at the
   shapes those phases trained, beside each run's step time and peak
   memory (the predicted state at most the peak), and recurrentgemma-2b's
   state at full depth; (c) a world-1 NCCL group on an in-process store,
   a (1, 1) ``DeviceMesh``, smollm-135m's parameters laid out by
   ``sharding.to_shardings`` and resharded by ``ft.reshard`` onto
   ``survivor_mesh(0, data=1, model=1)``, every value bit for bit; the
   group destroyed after.
29. bf16 training — (a) K7's bf16 backward (bf16 q, k, v, dO; the
   forward under grad also writes its output unrounded in float32)
   against ``attention_bwd_ref`` on the widened operands at
   ``K7_BWD_CASES``, each of dq, dk, dv within 2e-4·|ref| +
   2e-5·max|ref| plus one bf16 rounding of |ref|, bf16, autograd equal to
   the wrapper, the bf16 output the float32 one rounded once; at
   ``K7_BWD_TIMED`` two calls bit for bit and the backward timed beside
   the plain version, the float32 backward on the same values and SDPA's
   bf16 backward, and the bf16 grad forward (``flash_attention_lse``,
   which writes lse and the float32 output) beside SDPA's bf16 forward;
   the bf16 passes' registers, local (spilled) bytes, shared memory and
   blocks an SM at each head width, none spilling; (b) tinyllama-1.1b
   trained as in phase 26 (b) under
   ``precision.options(dtype=torch.bfloat16)``: finite, falling losses,
   44 K7 forwards and 22 bf16 backwards a step, ms a step, tokens/s, peak
   memory beside the cost model's bf16 bound; (c) qwen3-moe-235b-a22b at
   full width cut to ``BF16_MOE_LAYERS`` layers, ``BF16_MOE_STEPS``
   bf16 steps of ``loss_and_grads`` and a sign update on one batch (its
   AdamW state does not fit): finite, falling losses, two K7 forwards
   and one backward a layer-step, ms, tokens/s, peak, bound; (d) bf16
   copies of tinyllama-1.1b (2 layers) and qwen3-moe (1 layer, a batch
   whose routes agree), card against CPU, within the band of
   ``tests/test_torch_bf16_grad.py``; a ``bf16`` JSON line of (b) and
   (c).

The edge cases of the decision template (K1–K4 share it) hold the kernel
to its plain version, every output exact, at (T, N) = (50, 1), (50, 31),
(50, 33), (64, 1 000), (50, 10 007), (1, 100), (1, 10 007), (2 048, 100)
and (2 048, 10 000), with edge rows: row 0 fits nowhere (the uniform
fallback), rows 1-2 fall where every server is down (masked forms), row 3
fits exactly one server, and row 4 exactly two, which its key draws as A
and B: the first and the last admissible server.

The library loop is a scheduler written against the library API: the
FunctionBench trace on the testbed (m=4000, b=50) or the Azure trace at
10 000 servers (m=20 000, b=500), placed block by block against a cache
view that each block's placements update (in float64, rounded once, so
the card and the CPU hold the same view).  Each run on the card is held
to the same run on the CPU (placements, and for K6 every score matrix,
exact), with the launch counts set to 0 just before it and read just
after: one launch per block.

It prints the card's name and power limit, every phase's wall time, a
``profile`` JSON line of phase 20's readings, phase 21's
``message_reduction`` line and phase 22's ``message_reduction_batched``
line, the readings of phases 23 to 29 (phase 28's as a ``sizing`` JSON
line, phase 29's as a ``bf16`` one), a JSON line of per-kernel
measurements, and as its last line
``{"ok": true, "device": {...}}``.
Without a CUDA device it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Peak rates of one H100 SXM (NVIDIA data sheet) for the roofline bound,
# from the port's one source of them.
from repro_torch.launch.mesh import (  # noqa: E402
    HBM_BW as HBM_BYTES_PER_S, PEAK_FLOPS_BF16 as BF16_OPS_PER_S,
    PEAK_FLOPS_FP32 as FP32_OPS_PER_S, PEAK_FLOPS_TF32 as TF32_OPS_PER_S)
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/dodoor_fused_sparse.cu"
KERNEL_SOURCES = {
    "rl_score_matrix": "src/repro_torch/kernels/csrc/rl_score.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_attention_bwd": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_attention_bwd_d256":
        "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_attention_bwd_bf16":
        "src/repro_torch/kernels/csrc/flash_attention.cu",
    "ssd_chunk": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
    "ssd_chunk_bwd": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
}
KERNEL_REPLACES = {
    "dodoor_fused_sparse": "src/repro/kernels/dodoor_choice/kernel.py:455",
    "dodoor_fused_sparse_masked":
        "src/repro/kernels/dodoor_choice/kernel.py:510",
    "dodoor_fused_sparse_locality":
        "src/repro/kernels/dodoor_choice/kernel.py:436",
    "dodoor_fused_sparse_masked_locality":
        "src/repro/kernels/dodoor_choice/kernel.py:436",
    "dodoor_choice": "src/repro/kernels/dodoor_choice/kernel.py:175",
    "dodoor_fused": "src/repro/kernels/dodoor_choice/kernel.py:280",
    "dodoor_fused_masked": "src/repro/kernels/dodoor_choice/kernel.py:313",
    "rl_score_matrix": "src/repro/kernels/rl_score/kernel.py:38",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:87",
    # K7's backward: the Pallas kernel has no backward (no custom_vjp);
    # the reference differentiates its jnp attention instead.
    "flash_attention_bwd": "src/repro/kernels/flash_attention/kernel.py:87",
    "flash_attention_bwd_d256":
        "src/repro/kernels/flash_attention/kernel.py:87",
    "flash_attention_bwd_bf16":
        "src/repro/kernels/flash_attention/kernel.py:87",
    "ssd_chunk": "src/repro/kernels/ssd_chunk/kernel.py:65",
    # K8's backward: the Pallas kernel has no backward either; the
    # reference differentiates its jnp chunk scan (models/mamba2.py:30).
    "ssd_chunk_bwd": "src/repro/kernels/ssd_chunk/kernel.py:65",
}
#: K3's penalty per remote MB in phase 8: γ/bandwidth = 0.7/1.3, which is
#: not a power of two, so a wrong rounding of the penalty shows.
GAMMA_BW = float(np.float32(0.7 / 1.3))


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_ms(torch, fn, reps: int = 30, warmup: int = 5) -> float:
    """Median device time of ``fn`` in ms over ``reps`` calls.  Each call
    is queued behind a spin kernel that outlasts the host's enqueueing of
    ``fn`` (measured on the warm-up), so the events time the device work
    and not the host's launch overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin_cycles = int(4e9 * host_s) + 2_000_000     # ~2x the host time
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(spin_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def row_of(name, T, N, ms, plain_ms, nbytes, ops, max_abs_err,
           library_ms=None, op_rate=FP32_OPS_PER_S, **extra):
    """A kernels-line row: the bound is the larger of the bytes at the
    memory rate and the operations at ``op_rate`` (the float32 rate, or
    the TF32 tensor-core rate for a kernel that runs its products
    there)."""
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = ops / op_rate * 1e3
    row = dict(name=name, T=T, N=N, ms=ms, plain_ms=plain_ms,
               bound_ms=max(byte_ms, op_ms),
               bound_by="bytes" if byte_ms > op_ms else "operations",
               max_abs_err=max_abs_err, library_ms=library_ms, **extra)
    lib = ("" if row["library_ms"] is None
           else f", library {row['library_ms'] * 1e3:.3f} us")
    shape = " ".join(f"{k}={v}" for k, v in dict(T=T, N=N, **extra).items())
    print(f"kernel {name} {shape}: {ms * 1e3:.3f} us, plain "
          f"{plain_ms * 1e3:.3f} us{lib}, bound {row['bound_ms'] * 1e3:.4f} "
          f"us ({row['bound_by']}), max |dscore| {max_abs_err:.3g}",
          flush=True)
    return row


def block_host(T: int, N: int, seed: int):
    """A decision block at the main path's shapes, as numpy arrays: the
    paper's testbed (N=100) or a scaled fleet, task demands that include
    infeasible rows (the uniform fallback), random cached loads and
    per-type durations."""
    from repro_torch.sim import make_scaled, make_testbed

    cl = make_testbed() if N == 100 else make_scaled(N)
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, 2 ** 32, size=(T, 2), dtype=np.uint64)
    cores = rng.choice([1, 2, 4, 8, 16, 28, 32], size=T).astype(np.float32)
    mem = rng.uniform(1e3, 1.4e5, size=T).astype(np.float32)
    r = np.stack([cores, mem], axis=1)
    r[0] = (64.0, 1e9)                       # feasible nowhere
    L = (rng.uniform(0, 2, size=(N, 2)) * cl.C).astype(np.float32)
    D = rng.uniform(0, 5e5, size=N).astype(np.float32)
    d_types = rng.uniform(100, 2e4, size=(T, 4)).astype(np.float32)
    return [keys.astype(np.int64), r, d_types,
            np.asarray(cl.node_type, np.int32), L, D,
            np.asarray(cl.C, np.float32)]


def to_device(torch, host, device: str = "cuda"):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in host)


def kernel_inputs(torch, T: int, N: int, seed: int):
    """:func:`block_host` on the card."""
    return to_device(torch, block_host(T, N, seed))


def kernel_windows(torch, T: int, N: int, seed: int):
    """Down-window planes at the main path's sizes: ``random_outages(N,
    N//5)`` merged with ``random_churn(N, 0.15, 0.15)`` over a horizon H,
    plus a window taking every server down on [1.1H, 1.2H); task times
    spread over [0, H), with rows 1 and 2 at 1.15H (every server down:
    the uniform fallback)."""
    from repro_torch.sim import Dynamics, random_churn, random_outages
    from repro_torch.sim.engine import _lower_dynamics

    H = 1e5
    dyn = random_outages(N, N // 5, 0.6 * H, mean_down_ms=0.2 * H,
                         seed=seed).merge(
        random_churn(N, 0.15, 0.15, H, seed=seed + 1),
        Dynamics(outages=tuple((s, 1.1 * H, 1.2 * H) for s in range(N))))
    win = _lower_dynamics(dyn, N, device="cuda")
    now = np.random.RandomState(seed).uniform(0, H, T).astype(np.float32)
    now[1:3] = np.float32(1.15 * H)
    return win.down0, win.down1, torch.from_numpy(now).cuda()


def kernel_parents(torch, T: int, N: int, P: int, seed: int,
                   device: str = "cuda"):
    """K3's parent planes: psrv in [-1, N) with about a quarter -1 pads
    (the first column on the fleet's first four servers, so some
    candidates hold a parent), and non-integer MB, 0 at the pads."""
    rng = np.random.RandomState(seed)
    psrv = rng.randint(0, N, (T, P)).astype(np.int32)
    psrv[rng.rand(T, P) < 0.25] = -1
    psrv[:, 0] = rng.randint(0, 4, T)
    pbytes = rng.uniform(0.1, 9.0, (T, P)).astype(np.float32)
    pbytes[psrv < 0] = 0.0
    return (torch.from_numpy(psrv).to(device),
            torch.from_numpy(pbytes).to(device))


#: Edge shapes at which phases 2, 5, 8 and 14 hold the decision template
#: to its plain version, besides their main shapes: N = 1, 31, 33, 1 000
#: and 10⁴ + 7 (no multiple of a segment), one task, 2 048 tasks.
EDGE_SHAPES = ((50, 1), (50, 31), (50, 33), (64, 1000), (50, 10_007),
               (1, 100), (1, 10_007), (2048, 100), (2048, 10_000))
#: K2's window counts at the edge shapes: one, the largest the kernel
#: unrolls (8), and one above it (a loop over the windows).
EDGE_WD = (1, 8, 11)
EDGE_H = 1e5


def edge_servers(N: int) -> tuple:
    """The first and the last server admissible to edge row 4."""
    return min(5, N // 3), N - 1 - min(3, N // 3)


def edge_host(T: int, N: int, seed: int):
    """:func:`block_host` with edge rows (T ≥ 5): row 0 fits nowhere (the
    uniform fallback); row 3 fits exactly one server and row 4 exactly
    two, the first and the last admissible (:func:`edge_servers`), and
    row 4's key draws them as A and B.  A lone task fits most servers."""
    import torch

    from repro_torch.core.prefilter import (feasible_mask,
                                            sample_feasible_batch)

    host = block_host(T, N, seed)
    keys, r, C = host[0], host[1], host[6]
    if T < 5:
        r[0] = (1.0, 1e3)
        return host
    b0, b1 = edge_servers(N)
    top = C.max(0)
    C[b0], C[b1] = top + 1.0, top + 2.0
    r[3], r[4] = top + 2.0, top + 1.0
    # A key whose two ranks over row 4's two servers are 1 and 2.
    rng = np.random.RandomState(seed)
    tries = rng.randint(0, 2 ** 32, size=(64, 2), dtype=np.uint64)
    tries = torch.from_numpy(tries.astype(np.int64))
    mask = feasible_mask(torch.from_numpy(r[4:5]),
                         torch.from_numpy(C)).expand(64, N)
    cand = sample_feasible_batch(tries, mask, 2).numpy()
    hit = np.flatnonzero((cand[:, 0] == b0) & (cand[:, 1] == b1))
    keys[4] = tries[int(hit[0]) if hit.size else 0].numpy()
    return host


def edge_windows(T: int, N: int, Wd: int, seed: int):
    """[N, Wd] down-window planes with ``Wd`` windows a server: random
    spans within [0, H) (a fifth of them +inf pads, a twentieth leaves
    with a +inf end) and, last, [1.1H, 1.2H) on every server; task times
    in [0, H), rows 1-2 at 1.15H (every server down: the fallback) and
    rows 3-4 at -1 (before every window)."""
    H = EDGE_H
    rng = np.random.RandomState(seed)
    d0 = rng.uniform(0, H, (N, Wd)).astype(np.float32)
    d1 = (d0 + rng.uniform(0, 0.3 * H, (N, Wd))).astype(np.float32)
    d1[rng.rand(N, Wd) < 0.05] = np.inf
    pad = rng.rand(N, Wd) < 0.2
    d0[pad] = np.inf
    d1[pad] = np.inf
    d0[:, -1], d1[:, -1] = 1.1 * H, 1.2 * H
    now = rng.uniform(0, H, T).astype(np.float32)
    now[1:3] = 1.15 * H
    now[3:5] = -1.0
    return [d0, d1, now]


def edge_case(torch, form: str, T: int, N: int, Wd: int = 0, P: int = 0,
              device: str = "cuda"):
    """Operands of one edge case of the template, for ``form`` "sparse"
    (K1; K2 with ``Wd`` windows; K3 with ``P`` parents) or "dense" (K4;
    K4-masked with ``Wd`` windows' availability): (positional,
    keyword) arguments of the form's wrapper, which its plain version
    takes too."""
    from repro_torch.core.prefilter import avail_rows

    seed = T + N + Wd + P
    keys, r, d_types, nt, L, D, C = to_device(
        torch, edge_host(T, N, seed), device)
    kw = {}
    if Wd:
        down0, down1, now = to_device(torch, edge_windows(T, N, Wd, seed),
                                      device)
        kw = dict(down0=down0, down1=down1, now=now)
    if P:
        psrv, pbytes = kernel_parents(torch, T, N, P, seed, device)
        kw.update(psrv=psrv, pbytes=pbytes, gamma_bw=GAMMA_BW)
    if form == "sparse":
        return (keys, r, d_types, nt, L, D, C), kw
    d = d_types[:, nt.long()].contiguous()
    avail = (avail_rows(kw["down0"], kw["down1"], kw["now"]).float()
             if Wd else None)
    return (keys, r, d, L, D, C), dict(avail=avail) if Wd else {}


def edge_check(name, got, want, T: int, N: int) -> None:
    """The template against its plain version, every output exact, and
    the edge rows where they should be: row 3 on its one server, row 4
    on the first and the last admissible."""
    for what, a, b in zip(("choices", "candidates", "scores"), got, want):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        check(np.array_equal(a, b), f"{name}: {what} differ in "
              f"{int((a != b).reshape(T, -1).any(1).sum())} rows")
    if T >= 5:
        b0, b1 = edge_servers(N)
        cand = want[1].cpu().numpy()
        check(tuple(cand[3]) == (b1, b1) and tuple(cand[4]) == (b0, b1),
              f"{name}: edge rows drew {cand[3]} and {cand[4]}, not "
              f"{(b1, b1)} and {(b0, b1)}")


def edge_phase(torch, form: str, Wds=(0,), Ps=(0,)) -> int:
    """The template against its plain version at every edge shape, for
    each window count in ``Wds`` and parent count in ``Ps``; returns the
    number of cases."""
    from repro_torch.kernels.dodoor_choice import (dodoor_fused,
                                                   dodoor_fused_ref,
                                                   dodoor_fused_sparse,
                                                   dodoor_fused_sparse_ref)

    fn, plain = ((dodoor_fused_sparse, dodoor_fused_sparse_ref)
                 if form == "sparse" else (dodoor_fused, dodoor_fused_ref))
    n = 0
    for T, N in EDGE_SHAPES:
        for Wd in Wds:
            for P in Ps:
                args, kw = edge_case(torch, form, T, N, Wd, P)
                got = fn(*args, alpha=0.5, **kw)
                torch.cuda.synchronize()
                want = plain(*args, 0.5, **kw)
                edge_check(f"{form} T={T} N={N} Wd={Wd} P={P}", got, want,
                           T, N)
                n += 1
    print(f"  {form} template: {n} edge cases (N in "
          f"{sorted({N for _, N in EDGE_SHAPES})}, T in "
          f"{sorted({T for T, _ in EDGE_SHAPES})}, Wd in {list(Wds)}, P in "
          f"{list(Ps)}) exact against the plain version", flush=True)
    return n


def kernel_phase(torch, T: int, N: int, masked: bool = False,
                 P: int = 0) -> dict:
    """K1 (or K2, ``masked``; K3 in either form with ``P`` parents)
    against its plain version on the card, then both timed; returns the
    measurements of the kernels JSON line."""
    from repro_torch.kernels.dodoor_choice import (dodoor_fused_sparse,
                                                   dodoor_fused_sparse_ref)
    from repro_torch.core.prefilter import avail_rows

    name = ("dodoor_fused_sparse" + ("_masked" if masked else "")
            + ("_locality" if P else ""))
    args = kernel_inputs(torch, T, N, seed=T + N)
    kw = {}
    if masked:
        down0, down1, now = kernel_windows(torch, T, N, seed=N)
        kw = dict(down0=down0, down1=down1, now=now)
        up = avail_rows(down0, down1, now)
        print(f"  K2 T={T} N={N} Wd={down0.shape[1]}: "
              f"{1.0 - float(up.float().mean()):.3f} of (task, server) "
              f"pairs down, {int((~up).all(1).sum())} rows all down",
              flush=True)
    base_kw = dict(kw)
    if P:
        psrv, pbytes = kernel_parents(torch, T, N, P, seed=T + N + P)
        kw.update(psrv=psrv, pbytes=pbytes, gamma_bw=GAMMA_BW)
    choice, cand, scores = dodoor_fused_sparse(*args, alpha=0.5, **kw)
    torch.cuda.synchronize()
    p_choice, p_cand, p_scores = dodoor_fused_sparse_ref(*args, alpha=0.5,
                                                         **kw)
    cand, p_cand = cand.cpu().numpy(), p_cand.cpu().numpy()
    scores, p_scores = scores.cpu().numpy(), p_scores.cpu().numpy()
    choice, p_choice = choice.cpu().numpy(), p_choice.cpu().numpy()
    check(np.array_equal(cand, p_cand),
          f"{name} T={T} N={N}: candidates differ in "
          f"{int((cand != p_cand).any(1).sum())} rows")
    check(np.isfinite(scores).all(), f"{name} T={T} N={N}: non-finite")
    if P:
        # With γ = 0, K3 is K1 (K2) bit for bit.
        zero = dodoor_fused_sparse(*args, alpha=0.5,
                                   **dict(kw, gamma_bw=0.0))
        plain = dodoor_fused_sparse(*args, alpha=0.5, **base_kw)
        check(all(torch.equal(a, b) for a, b in zip(zero, plain)),
              f"{name} with gamma 0 differs from its form without "
              f"parents at T={T} N={N} P={P}")
    # Counts and ranks are integers and the score arithmetic is the plain
    # version's: scores and choices exact.
    check(np.array_equal(scores, p_scores), f"{name} T={T} N={N}: scores "
          f"differ by up to {np.abs(scores - p_scores).max()}")
    check(np.array_equal(choice, p_choice),
          f"{name} T={T} N={N}: choices differ")
    near_tie = np.abs(p_scores[:, 0] - p_scores[:, 1]) <= 1e-6
    if masked and not P:
        # With every window at +inf, K2 is K1 bit for bit.
        inf = torch.full_like(kw["down0"], float("inf"))
        k2 = dodoor_fused_sparse(*args, alpha=0.5, down0=inf, down1=inf,
                                 now=kw["now"])
        k1 = dodoor_fused_sparse(*args, alpha=0.5)
        check(all(torch.equal(a, b) for a, b in zip(k2, k1)),
              f"K2 with +inf windows differs from K1 at T={T} N={N}")
    plain_kw = dict(kw)
    if masked:       # the window-major pair, made once as the engine does
        kw["down_t"] = (kw["down0"].t().contiguous(),
                        kw["down1"].t().contiguous())
    ms = event_ms(torch, lambda: dodoor_fused_sparse(*args, alpha=0.5, **kw))
    plain_ms = event_ms(
        torch, lambda: dodoor_fused_sparse_ref(*args, alpha=0.5, **plain_kw))
    K, TT = 2, args[2].shape[1]
    Wd = kw["down0"].shape[1] if masked else 0
    # Each input read once, each output written once: per task the key
    # (16 B), demand (4K B) and per-type durations (4TT B) in and choice,
    # candidates and scores (20 B) out; per server L, D, C and node_type;
    # K2 also reads the two [N, Wd] window planes and the task times.
    nbytes = (T * (16 + 4 * K + 4 * TT + 20) + N * (4 * K + 4 + 4 * K + 4)
              + (N * Wd * 8 + T * 4 if masked else 0))
    # K capacity compares and one count per (task, server); K2 adds two
    # window compares per window; K3 a compare and an add per parent and
    # candidate, and reads the [T, P] server ids and MB.
    ops = T * N * (K + 1 + 2 * Wd) + 2 * T * P * 2
    nbytes += T * P * 8
    return row_of(name, T, N, ms, plain_ms, nbytes, ops,
                  float(np.abs(scores - p_scores).max()), P=P,
                  near_ties=int(near_tie.sum()))


def first_divergence_ok(gpu, cpu, wl, cluster, seed: int = 0,
                        dynamics=None, order=None) -> bool:
    """Placements equal, or the first divergent task picked one of its
    two sampled candidates on both devices (a near-tie flip).  Under down
    windows the candidates are drawn over the servers that are feasible
    and up at the task's (effective) submit time.  ``order`` is the
    decision order of a task graph's tasks (default: index order)."""
    if (gpu.server == cpu.server).all():
        return True
    import torch

    from repro_torch.core.prefilter import (avail_rows, feasible_mask,
                                            sample_feasible)
    from repro_torch.random import PRNGKey, fold_in, split
    from repro_torch.sim.engine import _lower_dynamics

    order = np.arange(gpu.server.shape[0]) if order is None else order
    i = int(order[np.argmax(gpu.server[order] != cpu.server[order])])
    key = fold_in(PRNGKey(seed, device="cpu"), torch.tensor(i))
    mask = feasible_mask(torch.from_numpy(wl.r_submit[i]),
                         torch.from_numpy(cluster.C))
    if dynamics is not None and dynamics.has_down_windows:
        win = _lower_dynamics(dynamics, cluster.num_servers)
        now = torch.tensor([float(cpu.submit_ms[i])], dtype=torch.float32)
        mask = mask & avail_rows(win.down0, win.down1, now)[0]
    cand = set(sample_feasible(split(key)[0], mask, 2).tolist())
    print(f"  placements diverge first at task {i}: gpu "
          f"{int(gpu.server[i])}, cpu {int(cpu.server[i])}, candidates "
          f"{sorted(cand)}", flush=True)
    return {int(gpu.server[i]), int(cpu.server[i])} <= cand


def ledger(res):
    return (res.msgs_base, res.msgs_probe, res.msgs_push, res.msgs_flush)


def timed_run(torch, wl, cluster, cfg, dynamics=None, dag=None):
    """One run on the card; returns (result, wall s, launches by kernel),
    the launch counts set to 0 just before the run and read just after."""
    from repro_torch.kernels.dodoor_choice import LAUNCHES
    from repro_torch.sim import simulate

    LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = simulate(wl, cluster, cfg, device="cuda", dynamics=dynamics,
                   dag=dag)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, wall, dict(LAUNCHES)


def testbed_phase(torch) -> None:
    from repro_torch.sim import (EngineConfig, make_testbed,
                                 resource_violations, simulate, summarize)
    from repro_torch.workloads import azure, functionbench

    tb = make_testbed()
    cfg = EngineConfig(policy="dodoor", b=50)
    for name, wl in (("azure", azure.synthesize(m=4000, qps=10.0)),
                     ("functionbench",
                      functionbench.synthesize(m=4000, qps=300.0))):
        m = wl.r_submit.shape[0]
        gpu, wall, counts = timed_run(torch, wl, tb, cfg)
        launches = counts.get("dodoor_fused_sparse", 0)
        cpu = simulate(wl, tb, cfg, device="cpu")
        blocks = -(-m // cfg.b)
        check(first_divergence_ok(gpu, cpu, wl, tb),
              f"{name}: placements diverge beyond a candidate flip")
        check(ledger(gpu) == ledger(cpu),
              f"{name}: ledger {ledger(gpu)} != cpu {ledger(cpu)}")
        for f in ("start_ms", "finish_ms", "enqueue_ms"):
            check(np.isfinite(getattr(gpu, f)).all(), f"{name}: {f} NaN")
        check(resource_violations(gpu, tb) == 0,
              f"{name}: capacity violated")
        check(launches == blocks,
              f"{name}: {launches} kernel launches for {blocks} blocks")
        same = bool((gpu.server == cpu.server).all())
        s = summarize(gpu)
        print(f"testbed {name}: m={m} b={cfg.b} {m / wall:.1f} decisions/s "
              f"(wall {wall:.3f} s), launches {launches}/{blocks} blocks, "
              f"placements equal to cpu: {same}, msgs/task "
              f"{s.msgs_per_task:.4f}, makespan mean {s.makespan_mean_ms:.1f}"
              f" ms p95 {s.makespan_p95_ms:.1f} ms", flush=True)


#: Phases 4, 7 and 10 run their 200 000 tasks on the card and hold the
#: card against the CPU on the first SCALE_CPU_TASKS of them (a run of the
#: prefix on each device); phase 12 runs SCALE_CPU_TASKS tasks.  The
#: script's time limit: at 200 000 the four CPU runs took 54–79 s each,
#: and the whole script 1 118 s, on a slow host; 50 000 until the script
#: passed 875 s again (948 s with 27 phases), 25 000 until the whole
#: script took 924.6 s on a slow host with 29 phases.
SCALE_CPU_TASKS = 12_500


def cpu_prefix(wl, cluster, cfg, dynamics=None, dag=None) -> tuple:
    """The first ``SCALE_CPU_TASKS`` tasks of ``wl`` run on the card and
    on the CPU: (the prefix, card result, CPU result, CPU s)."""
    from repro_torch.sim import simulate

    wl = head(wl, SCALE_CPU_TASKS)
    gpu = simulate(wl, cluster, cfg, device="cuda", dynamics=dynamics,
                   dag=dag)
    t0 = time.perf_counter()
    cpu = simulate(wl, cluster, cfg, device="cpu", dynamics=dynamics,
                   dag=dag)
    return wl, gpu, cpu, time.perf_counter() - t0


def scale_setup():
    """Phase 4's point: (workload, cluster, config, dynamics)."""
    from repro_torch.sim import EngineConfig, make_scaled
    from repro_torch.workloads import azure

    return (azure.synthesize(m=200_000, qps=400.0), make_scaled(10_000),
            EngineConfig(policy="dodoor", b=500), None)


def scale_dynamics_setup(m: int = 200_000):
    """Phase 7's point: phase 4's under node churn and n/5 outages."""
    from repro_torch.sim import (EngineConfig, make_scaled, random_churn,
                                 random_outages)
    from repro_torch.workloads import azure

    cl = make_scaled(10_000)
    n = cl.num_servers
    wl = azure.synthesize(m=m, qps=400.0)
    H = float(wl.submit_ms[-1])
    dyn = random_churn(n, 0.15, 0.15, H).merge(
        random_outages(n, n // 5, 0.6 * H, mean_down_ms=0.2 * H))
    return wl, cl, EngineConfig(policy="dodoor", b=500), dyn


def scale_phase(torch) -> int:
    from repro_torch.sim import expected_messages_per_task

    wl, cl, cfg, _ = scale_setup()
    m = wl.r_submit.shape[0]
    res, wall, counts = timed_run(torch, wl, cl, cfg)
    launches = counts.get("dodoor_fused_sparse", 0)
    blocks = -(-m // cfg.b)
    check(res.server.shape == (m,), "scale: wrong result shape")
    check(((res.server >= 0) & (res.server < cl.num_servers)).all(),
          "scale: server index out of range")
    admits = (wl.r_submit <= cl.C[res.server]).all(axis=1)
    check(admits.all(), f"scale: {int((~admits).sum())} tasks on servers "
          "whose capacity does not admit them")
    want = expected_messages_per_task("dodoor", b=cfg.b,
                                      num_schedulers=cfg.num_schedulers,
                                      flush_every=cfg.flush_every)
    check(abs(res.msgs_per_task - want) < 1e-9,
          f"scale: {res.msgs_per_task} msgs/task, closed form {want}")
    check(np.isfinite(res.finish_ms).all(), "scale: non-finite finish")
    check(launches == blocks,
          f"scale: {launches} kernel launches for {blocks} blocks")
    wl_k, gpu, cpu, cpu_wall = cpu_prefix(wl, cl, cfg)
    check(first_divergence_ok(gpu, cpu, wl_k, cl),
          "scale: placements diverge from the cpu run beyond a candidate "
          "flip")
    check(ledger(gpu) == ledger(cpu), "scale: ledger differs from cpu")
    print(f"scale: n={cl.num_servers} m={m} b={cfg.b} "
          f"{m / wall:.1f} decisions/s (wall {wall:.3f} s), launches "
          f"{launches}/{blocks} blocks, msgs/task {res.msgs_per_task:.4f}, "
          f"placements of the first {SCALE_CPU_TASKS} equal to cpu: "
          f"{bool((gpu.server == cpu.server).all())} (cpu run "
          f"{cpu_wall:.1f} s)", flush=True)
    return launches


def dynamics_checks(name, res, wl, cluster, dynamics) -> None:
    """What the windows promise: no task on a server that is down at its
    submit time unless every feasible server was, and no start inside a
    gate window (outage or join)."""
    from repro_torch.sim.engine import _lower_dynamics

    win = _lower_dynamics(dynamics, cluster.num_servers)
    d0, d1, g0, g1 = (p.numpy() for p in win[:4])
    j, now = res.server, res.submit_ms[:, None]
    on_down = ((d0[j] <= now) & (now < d1[j])).any(1)
    for i in np.flatnonzero(on_down):       # the fallback, or a fault
        up = ~((d0 <= now[i]) & (now[i] < d1)).any(1)
        fits = (wl.r_submit[i] <= cluster.C).all(1)
        check(not (up & fits).any(),
              f"{name}: task {i} placed on down server {j[i]} while a "
              "feasible server was up")
    s = res.start_ms[:, None]
    check(not ((g0[j] <= s) & (s < g1[j])).any(),
          f"{name}: a start falls inside a gate window")
    print(f"  {name}: {int(on_down.sum())} tasks placed on a down server "
          "(each in the all-down fallback)", flush=True)


def launches_ok(name, counts, masked: bool, blocks: int) -> None:
    want = ({"dodoor_fused_sparse_masked": blocks} if masked
            else {"dodoor_fused_sparse": blocks})
    check(counts == want, f"{name}: launches {counts}, want {want}")


def scenario_phase(torch) -> None:
    from repro_torch.sim import (Dynamics, EngineConfig, Scenario,
                                 make_testbed, random_churn, random_outages,
                                 random_stragglers, resource_violations,
                                 rolling_restart, run_scenario,
                                 scenario_workload, summarize)
    from repro_torch.workloads import (BatchArrivals, DiurnalArrivals,
                                       OnOffArrivals, PoissonArrivals,
                                       functionbench)

    tb = make_testbed()
    n, qps = tb.num_servers, 60.0
    base = functionbench.synthesize(m=4000, qps=qps)
    H = float(base.submit_ms[-1])
    on, off = 4.0 * qps, qps / 6.0
    # benchmarks/bench_scenarios.py:make_scenarios(100, H, 60), and a
    # maintenance scenario: start gate, straggler stretch, push suppression.
    scenarios = (
        Scenario("steady", arrivals=PoissonArrivals(qps)),
        Scenario("bursty_mmpp", arrivals=OnOffArrivals(
            on, off, mean_on_s=1.0, mean_off_s=3.0)),
        Scenario("diurnal", arrivals=DiurnalArrivals(
            qps, amplitude=0.85, period_s=H / 4e3)),
        Scenario("batch_heavy", arrivals=BatchArrivals(
            qps / 6.0, pareto_alpha=1.4, max_batch=64)),
        Scenario("outage_storm", arrivals=PoissonArrivals(qps),
                 dynamics=random_outages(n, max(2, n // 5), 0.6 * H,
                                         mean_down_ms=0.2 * H, seed=7)),
        Scenario("churn", arrivals=PoissonArrivals(qps),
                 dynamics=random_churn(n, leave_frac=0.15, join_frac=0.15,
                                       horizon_ms=H, seed=11)),
        Scenario("maintenance", dynamics=rolling_restart(
            n, 0.05 * H, 0.08 * H, stride=10).merge(
                random_stragglers(n, 20, H, mean_slow_ms=0.1 * H, mult=4.0),
                Dynamics(store_outages=((0.3 * H, 0.4 * H),)))),
    )
    cfg = EngineConfig(policy="dodoor", b=50)
    blocks = -(-base.r_submit.shape[0] // cfg.b)
    for sc in scenarios:
        wl = scenario_workload(base, sc, 0)
        dyn = sc.dynamics
        gpu, wall, counts = timed_run(torch, wl, tb, cfg, dyn)
        cpu = run_scenario(base, tb, sc, cfg, device="cpu")
        check(first_divergence_ok(gpu, cpu, wl, tb, dynamics=dyn),
              f"{sc.name}: placements diverge beyond a candidate flip")
        check(ledger(gpu) == ledger(cpu),
              f"{sc.name}: ledger {ledger(gpu)} != cpu {ledger(cpu)}")
        check(np.isfinite(gpu.finish_ms).all(), f"{sc.name}: finish NaN")
        check(resource_violations(gpu, tb) == 0,
              f"{sc.name}: capacity violated")
        dynamics_checks(sc.name, gpu, wl, tb, dyn)
        launches_ok(sc.name, counts, dyn.has_down_windows, blocks)
        s = summarize(gpu)
        m = wl.r_submit.shape[0]
        print(f"scenario {sc.name}: m={m} b={cfg.b} {m / wall:.1f} "
              f"decisions/s (wall {wall:.3f} s), launches {counts}, "
              f"placements equal to cpu: "
              f"{bool((gpu.server == cpu.server).all())}, msgs/task "
              f"{s.msgs_per_task:.4f} (push {gpu.msgs_push}), makespan "
              f"mean {s.makespan_mean_ms:.1f} ms p95 "
              f"{s.makespan_p95_ms:.1f} ms", flush=True)


def scale_dynamics_phase(torch, m: int = 200_000) -> int:
    from repro_torch.sim import (expected_messages_per_task,
                                 resource_violations)

    wl, cl, cfg, dyn = scale_dynamics_setup(m)
    n = cl.num_servers
    res, wall, counts = timed_run(torch, wl, cl, cfg, dyn)
    blocks = -(-m // cfg.b)
    launches_ok("scale+dynamics", counts, True, blocks)
    check(res.server.shape == (m,), "scale+dynamics: wrong result shape")
    admits = (wl.r_submit <= cl.C[res.server]).all(axis=1)
    check(admits.all(), f"scale+dynamics: {int((~admits).sum())} tasks on "
          "servers whose capacity does not admit them")
    want = expected_messages_per_task("dodoor", b=cfg.b,
                                      num_schedulers=cfg.num_schedulers,
                                      flush_every=cfg.flush_every)
    check(abs(res.msgs_per_task - want) < 1e-9,
          f"scale+dynamics: {res.msgs_per_task} msgs/task, closed form "
          f"{want}")
    check(np.isfinite(res.finish_ms).all(), "scale+dynamics: non-finite")
    # Azure VMs run for hours: sample the capacity check 200 times over
    # the run instead of once a second.
    span = float(res.finish_ms.max() - res.submit_ms.min())
    check(resource_violations(res, cl, dt_ms=span / 200) == 0,
          "scale+dynamics: capacity violated")
    dynamics_checks("scale+dynamics", res, wl, cl, dyn)
    wl_k, gpu, cpu, cpu_wall = cpu_prefix(wl, cl, cfg, dyn)
    check(first_divergence_ok(gpu, cpu, wl_k, cl, dynamics=dyn),
          "scale+dynamics: placements diverge from the cpu run beyond a "
          "candidate flip")
    check(ledger(gpu) == ledger(cpu), "scale+dynamics: ledger differs")
    print(f"scale+dynamics: n={n} m={m} b={cfg.b} "
          f"({len(dyn.outages)} outage windows, {len(dyn.joins)} joins, "
          f"{len(dyn.leaves)} leaves) {m / wall:.1f} decisions/s (wall "
          f"{wall:.3f} s), launches {counts}, msgs/task "
          f"{res.msgs_per_task:.4f}, placements of the first "
          f"{SCALE_CPU_TASKS} equal to cpu: "
          f"{bool((gpu.server == cpu.server).all())} (cpu run "
          f"{cpu_wall:.1f} s)", flush=True)
    return counts["dodoor_fused_sparse_masked"]


def busy_us(spans) -> float:
    """Length of the union of [start, end) spans (µs)."""
    total, end = 0.0, -np.inf
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


#: Phase 20 profiles the first PROFILED_TASKS of the 200 000 tasks of
#: phases 4 and 7: the profiler's post-pass over 160 000 device events took
#: ~70 s of the phase's 83 s (948 s for the whole script with 27 phases);
#: 50 000 until the script took 924.6 s on a slow host with 29 phases
#: (the phase 16.9-24.9 s).
PROFILED_TASKS = 25_000


def profiled_phase(torch) -> dict:
    """Phases 4 and 7 once more on their first ``PROFILED_TASKS`` tasks,
    untimed by them, under ``torch.profiler``
    (device activity only): the decision kernel's total device time and
    launches, the device's busy time (the union of its kernels' spans)
    and its share of the run's wall time, and the wall, which the
    profiler inflates.  A profiler that records no device activity leaves
    the numbers unmeasured (None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.sim import simulate

    out = []
    for name, setup in (("4 scale", scale_setup),
                        ("7 scale with dynamics", scale_dynamics_setup)):
        wl, cl, cfg, dyn = setup()
        wl = head(wl, PROFILED_TASKS)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            simulate(wl, cl, cfg, device="cuda", dynamics=dyn)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        spans, kern, launches = [], 0.0, 0
        for ev in prof.events():
            if ev.device_type != DeviceType.CUDA:
                continue
            spans.append((ev.time_range.start, ev.time_range.end))
            if "dodoor_fused_sparse_kernel" in ev.name:
                kern += ev.time_range.elapsed_us()
                launches += 1
        busy = busy_us(spans)
        row = {"phase": name, "wall_s": wall, "device_kernels": len(spans),
               "decision_kernel_ms": kern / 1e3 if spans else None,
               "decision_launches": launches if spans else None,
               "device_busy_ms": busy / 1e3 if spans else None,
               "busy_share": busy / 1e6 / wall if spans else None}
        print(f"  profiled {name}: {json.dumps(row)}", flush=True)
        out.append(row)
    return out


TIME_PLANES = ("submit_ms", "enqueue_ms", "start_ms", "finish_ms",
               "sched_ms", "cores", "mem_mb")


def wave_blocks(sizes, b: int) -> int:
    """Decision blocks of a wave loop: Σ over waves of ⌈wave / b⌉."""
    return int(sum(-(-int(w) // b) for w in sizes if w))


def dag_check(name, gpu, cpu, wl, cluster, plan, dynamics=None) -> bool:
    """A task graph's card run against its CPU run: placements exact, or
    the first divergence in decision order (level, then effective submit
    time, then index) a candidate flip; the ledger exact; and, where the
    placements are equal, every time plane exact.  Also: no task starts
    before a parent's finish plus the edge delay.  Returns whether the
    placements were equal."""
    order = np.lexsort((np.arange(plan.m), cpu.submit_ms, plan.level))
    check(first_divergence_ok(gpu, cpu, wl, cluster, dynamics=dynamics,
                              order=order),
          f"{name}: placements diverge beyond a candidate flip")
    check(ledger(gpu) == ledger(cpu),
          f"{name}: ledger {ledger(gpu)} != cpu {ledger(cpu)}")
    same = bool((gpu.server == cpu.server).all())
    if same:
        for f in TIME_PLANES:
            check(np.array_equal(getattr(gpu, f), getattr(cpu, f)),
                  f"{name}: {f} differs from the cpu run")
    gate_check(name, gpu, plan)
    return same


def gate_check(name, gpu, plan) -> None:
    """No task of a graph's run starts before a parent's finish plus the
    edge delay, and every finish is finite."""
    v = np.repeat(np.arange(plan.m), np.diff(plan.par_indptr))
    gate = (gpu.finish_ms[plan.par_idx].astype(np.float64)
            + plan.par_delay)
    check((gpu.start_ms[v] >= gate - 1e-3).all(),
          f"{name}: a task starts before a parent's finish + delay")
    check(np.isfinite(gpu.finish_ms).all(), f"{name}: non-finite finish")


#: Phase 9's chain runs on the trace's first 400 tasks (400 waves of the
#: DAG benchmark's 2 400): the script's time limit (at 1 200 tasks here
#: and 2 000 in phase 21 the whole script took 1 111 s on a slow host; at
#: 800 here and 1 200 in phase 21, 948 s with 27 phases).
CHAIN_TASKS = 400
#: Phase 9's other shapes run on a FunctionBench trace of DAG_TASKS tasks
#: (the DAG benchmark's 2 400 before phase 29): the script's time limit.
#: With phase 29 and 2 400 tasks the whole script took 933.0 s on a slow
#: host (H100 80GB HBM3, 700 W), phase 9 83.3 s of it, half of it the CPU
#: runs.
DAG_TASKS = 1200


def dag_phase(torch, m: int = DAG_TASKS) -> int:
    """Phase 9: the shapes of the DAG benchmark on the testbed, each
    without a LocalityModel and with γ = 2 (the chain cut to
    ``CHAIN_TASKS``); a layered DAG under γ/bw = 0.7/1.3 with non-integer
    MB; map-reduce under γ = 2 and outages (the masked K3).  Returns the
    masked K3's launches."""
    from repro_torch.sim import (EngineConfig, LocalityModel, make_testbed,
                                 random_outages, simulate, summarize_dag)
    from repro_torch.workloads import (ChainDAG, FanOutDAG, LayeredDAG,
                                       MapReduceDAG, dag_plan,
                                       functionbench)

    tb = make_testbed()
    wl = functionbench.synthesize(m=m, qps=60.0, seed=0)
    H = float(wl.submit_ms[-1])
    outages = random_outages(tb.num_servers, 25, 0.6 * H,
                             mean_down_ms=0.15 * H, seed=7)
    # benchmarks/bench_dags.py:35-44
    chain = ChainDAG(edge_delay_ms=0.2, edge_bytes_mb=4.0)
    fanout = FanOutDAG(width=8, edge_delay_ms=0.5, edge_bytes_mb=8.0)
    mapred = MapReduceDAG(mappers=8, reducers=2, edge_delay_ms=0.5,
                          edge_bytes_mb=8.0)
    layered = LayeredDAG(width=8, density=0.25, edge_delay_ms=0.5,
                         edge_bytes_mb=3.3)
    g2 = LocalityModel(gamma=2.0)
    runs = [("chain", chain, None, None), ("chain", chain, g2, None),
            ("fanout", fanout, None, None), ("fanout", fanout, g2, None),
            ("mapreduce", mapred, None, None),
            ("mapreduce", mapred, g2, None),
            ("layered", layered, LocalityModel(0.7, 1.3), None),
            ("mapreduce+outages", mapred, g2, outages)]
    moved = {}
    masked_launches = 0
    for shape, spec, loc, dyn in runs:
        name = f"{shape} {'no model' if loc is None else loc}"
        cfg = EngineConfig(policy="dodoor", b=50, locality=loc)
        wl_s = head(wl, CHAIN_TASKS) if shape == "chain" else wl
        m_s = wl_s.r_submit.shape[0]
        plan = dag_plan(spec, m_s)
        gpu, wall, counts = timed_run(torch, wl_s, tb, cfg, dyn, spec)
        cpu = simulate(wl_s, tb, cfg, device="cpu", dynamics=dyn, dag=spec)
        same = dag_check(name, gpu, cpu, wl_s, tb, plan, dyn)
        kernel = ("dodoor_fused_sparse" + ("_masked" if dyn else "")
                  + ("_locality" if loc else ""))
        blocks = wave_blocks(np.bincount(plan.level), cfg.b)
        check(counts == {kernel: blocks},
              f"{name}: launches {counts}, want {kernel}: {blocks}")
        masked_launches += counts.get("dodoor_fused_sparse_masked_locality",
                                      0)
        s = summarize_dag(gpu, plan)
        moved[(shape, loc is not None)] = s["bytes_moved_mb"]
        print(f"dag {name}: m={m_s} b={cfg.b} waves {plan.num_levels} "
              f"{m_s / wall:.1f} decisions/s (wall {wall:.3f} s), launches "
              f"{counts}, equal to cpu: {same}, summarize_dag "
              f"{json.dumps(s)}", flush=True)
    for shape in ("fanout", "mapreduce"):
        check(moved[(shape, True)] < moved[(shape, False)],
              f"{shape}: gamma 2 moved {moved[(shape, True)]} MB, no "
              f"model {moved[(shape, False)]} MB")
    return masked_launches


def dag_scale_phase(torch) -> int:
    """Phase 10: fan-out at 10⁴ servers under γ = 2 — three waves of
    20 000 roots, 160 000 children and 20 000 sinks, P = 8; the graph of
    the first ``SCALE_CPU_TASKS`` tasks against the CPU."""
    from repro_torch.sim import (EngineConfig, LocalityModel, make_scaled,
                                 summarize_dag)
    from repro_torch.workloads import FanOutDAG, azure, dag_plan

    cl = make_scaled(10_000)
    wl = azure.synthesize(m=200_000, qps=400.0)
    spec = FanOutDAG(width=8, edge_delay_ms=0.5, edge_bytes_mb=8.0)
    cfg = EngineConfig(policy="dodoor", b=500,
                       locality=LocalityModel(gamma=2.0))
    m = wl.r_submit.shape[0]
    plan = dag_plan(spec, m)
    gpu, wall, counts = timed_run(torch, wl, cl, cfg, dag=spec)
    blocks = wave_blocks(np.bincount(plan.level), cfg.b)
    check(counts == {"dodoor_fused_sparse_locality": blocks},
          f"dag scale: launches {counts}, want {blocks}")
    admits = (wl.r_submit <= cl.C[gpu.server]).all(axis=1)
    check(admits.all(), f"dag scale: {int((~admits).sum())} tasks on "
          "servers whose capacity does not admit them")
    gate_check("dag scale", gpu, plan)
    wl_k, gpu_k, cpu, cpu_wall = cpu_prefix(wl, cl, cfg, dag=spec)
    same = dag_check("dag scale", gpu_k, cpu, wl_k, cl,
                     dag_plan(spec, SCALE_CPU_TASKS))
    s = summarize_dag(gpu, plan)
    print(f"dag scale: n={cl.num_servers} m={m} b={cfg.b} waves "
          f"{np.bincount(plan.level).tolist()} P={plan.max_parents} "
          f"{m / wall:.1f} decisions/s (wall {wall:.3f} s), launches "
          f"{counts}, the first {SCALE_CPU_TASKS} equal to cpu: {same} "
          f"(cpu run {cpu_wall:.1f} s), "
          f"bytes moved {s['bytes_moved_mb']:.1f} of "
          f"{s['bytes_total_mb']:.1f} MB, critical path "
          f"{s['critical_path_ms']:.1f} ms", flush=True)
    return counts["dodoor_fused_sparse_locality"]


def retry_check(name, gpu, cpu, counts, b: int, masked: bool) -> None:
    """A retry run on the card equals its CPU run in every plane, and the
    decision kernel launched once per block of every wave."""
    check(np.array_equal(gpu.server, cpu.server),
          f"{name}: placements differ from the cpu run")
    for f in TIME_PLANES + ("attempts", "failed", "wasted_ms"):
        check(np.array_equal(getattr(gpu, f), getattr(cpu, f)),
              f"{name}: {f} differs from the cpu run")
    check(ledger(gpu) == ledger(cpu),
          f"{name}: ledger {ledger(gpu)} != cpu {ledger(cpu)}")
    waves = [int((gpu.attempts >= a).sum())
             for a in range(1, int(gpu.attempts.max()) + 1)]
    kernel = "dodoor_fused_sparse_masked" if masked else "dodoor_fused_sparse"
    want = {kernel: wave_blocks(waves, b)}
    check(counts == want, f"{name}: launches {counts}, want {want} "
          f"(waves {waves})")


def retry_phase(torch) -> None:
    """Phase 11: the densest point of the fault benchmark (25 outages on
    the testbed) under the default, the aggressive and a hard-capacity
    retry policy."""
    from repro_torch.sim import (EngineConfig, RetryPolicy, fault_stats,
                                 make_testbed, random_outages, simulate,
                                 time_to_recover_ms)
    from repro_torch.workloads import functionbench

    tb = make_testbed()
    wl = functionbench.synthesize(m=3000, qps=60.0, seed=0)
    H = float(wl.submit_ms[-1])
    dyn = random_outages(tb.num_servers, 25, 0.6 * H,
                         mean_down_ms=0.15 * H, seed=7)
    # benchmarks/bench_faults.py:39-41, and a queue cap of 2 × cores.
    policies = (("default", RetryPolicy()),
                ("aggressive", RetryPolicy(max_attempts=5, backoff_ms=50.0,
                                           backoff_mult=1.5)),
                ("reject2", RetryPolicy(reject_queue_factor=2.0)))
    for pname, rp in policies:
        cfg = EngineConfig(policy="dodoor", b=50, retry=rp)
        gpu, wall, counts = timed_run(torch, wl, tb, cfg, dyn)
        cpu = simulate(wl, tb, cfg, device="cpu", dynamics=dyn)
        retry_check(f"retry {pname}", gpu, cpu, counts, cfg.b, True)
        m = wl.r_submit.shape[0]
        print(f"retry {pname}: m={m} b={cfg.b} {m / wall:.1f} decisions/s "
              f"(wall {wall:.3f} s), launches {counts}, equal to cpu: "
              f"True, fault_stats {json.dumps(fault_stats(gpu))}, "
              f"time_to_recover_ms {time_to_recover_ms(gpu, dyn):.3f}, "
              f"ledger {ledger(gpu)}", flush=True)


def retry_scale_phase(torch, m: int = 200_000) -> None:
    """Phase 12: phase 7's point (10⁴ servers, churn and outages, on m
    tasks) under the default retry policy, against the CPU run."""
    from repro_torch.sim import (RetryPolicy, fault_stats, simulate,
                                 time_to_recover_ms)

    wl, cl, cfg, dyn = scale_dynamics_setup(m)
    n = cl.num_servers
    cfg = cfg._replace(retry=RetryPolicy())
    gpu, wall, counts = timed_run(torch, wl, cl, cfg, dyn)
    t0 = time.perf_counter()
    cpu = simulate(wl, cl, cfg, device="cpu", dynamics=dyn)
    cpu_wall = time.perf_counter() - t0
    retry_check("retry scale", gpu, cpu, counts, cfg.b, True)
    print(f"retry scale: n={n} m={m} b={cfg.b} {m / wall:.1f} decisions/s "
          f"(wall {wall:.3f} s), launches {counts}, equal to cpu: True "
          f"(cpu run {cpu_wall:.1f} s), fault_stats "
          f"{json.dumps(fault_stats(gpu))}, time_to_recover_ms "
          f"{time_to_recover_ms(gpu, dyn):.3f}", flush=True)


def same(name, got, want) -> None:
    """Every tensor of ``got`` equal to its partner in ``want``."""
    for i, (a, b) in enumerate(zip(got, want)):
        check(torch_equal(a, b), f"{name}: output {i} differs (max "
              f"{float((a.double() - b.double().to(a.device)).abs().max())})")


def torch_equal(a, b) -> bool:
    return a.shape == b.shape and bool((a.cpu() == b.cpu()).all())


def pair_inputs(torch, T: int, N: int, seed: int):
    """K5's operands at the main path's shapes: kernel_inputs' demands and
    view, candidates drawn uniformly, rows 1-4 with two identical
    candidates, and rows 5-8 on servers 0 and 1, which hold identical
    rows and durations (an exact tie: A must win)."""
    _, r, _, _, L, D, C = kernel_inputs(torch, T, N, seed)
    L, D, C = L.clone(), D.clone(), C.clone()
    L[1], D[1], C[1] = L[0], D[0], C[0]
    rng = np.random.RandomState(seed)
    cand = rng.randint(0, N, (T, 2)).astype(np.int32)
    d_cand = rng.uniform(100, 2e4, (T, 2)).astype(np.float32)
    cand[1:5, 1] = cand[1:5, 0]
    cand[5:9] = (0, 1)
    d_cand[5:9, 1] = d_cand[5:9, 0]
    return (r, torch.from_numpy(cand).cuda(),
            torch.from_numpy(d_cand).cuda(), L, D, C)


def k5_phase(torch, T: int, N: int) -> dict:
    """K5 against its plain version on the card, then both timed."""
    from repro_torch.kernels.dodoor_choice import (dodoor_choice,
                                                   dodoor_choice_ref)

    args = pair_inputs(torch, T, N, seed=T + N)
    choice, scores = dodoor_choice(*args, alpha=0.5)
    torch.cuda.synchronize()
    p_choice, p_scores = dodoor_choice_ref(*args, alpha=0.5)
    same(f"dodoor_choice T={T} N={N}", (choice, scores), (p_choice, p_scores))
    check(bool((choice[5:9] == 0).all()), "dodoor_choice: a tie took B")
    check(bool(torch.isfinite(scores).all()), "dodoor_choice: non-finite")
    ms = event_ms(torch, lambda: dodoor_choice(*args, alpha=0.5))
    plain_ms = event_ms(torch, lambda: dodoor_choice_ref(*args, alpha=0.5))
    # Per task r, cand, d_cand in (24 B) and choice, scores out (12 B);
    # per server touched L, C and D (20 B).  About 30 operations a task.
    servers = int(torch.unique(args[1]).numel())
    return row_of("dodoor_choice", T, N, ms, plain_ms,
                  T * 36 + servers * 20, T * 30,
                  float((scores - p_scores).abs().max()))


def select_batch_check(torch, T: int, N: int) -> None:
    """``dodoor_select_batch(use_kernel=True)`` on the card: one K5 launch,
    choices equal to ``use_kernel=False`` on the card and to the same
    call on the CPU."""
    from repro_torch.core import (DodoorParams, SchedulerView,
                                  dodoor_select_batch)
    from repro_torch.kernels import LAUNCHES
    from repro_torch.random import PRNGKey

    _, r, d_types, node_type, L, D, C = kernel_inputs(torch, T, N, T * N)
    d = d_types[:, node_type.long()].contiguous()
    view = SchedulerView(L=L, D=D, rif=torch.zeros_like(D), C=C)
    key = PRNGKey(N, device="cuda")
    params = DodoorParams()
    LAUNCHES.clear()
    got = dodoor_select_batch(key, r, d, view, params, use_kernel=True)
    torch.cuda.synchronize()
    check(dict(LAUNCHES) == {"dodoor_choice": 1},
          f"select_batch: launches {dict(LAUNCHES)}")
    two_stage = dodoor_select_batch(key, r, d, view, params)
    cpu = dodoor_select_batch(
        key.cpu(), r.cpu(), d.cpu(),
        SchedulerView(*(t.cpu() for t in view)), params, use_kernel=True)
    check(torch_equal(got, two_stage), f"select_batch T={T} N={N}: "
          "use_kernel=True differs from use_kernel=False")
    check(torch_equal(got, cpu), f"select_batch T={T} N={N}: the card "
          "differs from the cpu")
    print(f"  dodoor_select_batch T={T} N={N}: use_kernel=True equal to "
          "use_kernel=False and to the cpu, 1 K5 launch", flush=True)


#: K5's edge shapes (T, N): one task; N = 1 and odd N; the main path's
#: shapes and T = 2048 at 10⁴ servers (the plan's largest blocks).
K5_EDGES = ((1, 1), (1, 100), (50, 1), (50, 7), (50, 101), (50, 100),
            (2048, 100), (300, 819), (500, 10_000), (2048, 10_000))
#: K5 timed with each of these tasks a block at the main path's shapes:
#: the data behind plan_k5.
K5_TPBS = (32, 64, 128, 256)


def launch_floor_us(torch) -> float:
    """An empty launch in :func:`event_ms`'s harness (a spin kernel of 0
    cycles between the two events), in µs: the floor under every
    launch-sized kernel time."""
    return 1e3 * event_ms(torch, lambda: torch.cuda._sleep(0))


def k5_plans(torch, T: int) -> list:
    """Tasks a block to force at a shape: 32, 64, 256 and the plan's."""
    from repro_torch.kernels._wrap import sm_count
    from repro_torch.kernels.dodoor_choice.ops import plan_k5

    return sorted({32, 64, 256, plan_k5(T, sm_count(torch.device("cuda")))})


def k5_edge_host(T: int, N: int, seed: int):
    """K5's operands with edge rows, as numpy arrays: row 0 pairs servers
    0 and N − 1, row 1 the reverse; row 2 two identical candidates with
    equal durations; row 3 servers 0 and 1, which hold identical rows and
    durations (an exact tie: A must win); row 4 two idle servers (no load,
    no durations: both fractions fall back to 0.5)."""
    rng = np.random.RandomState(seed)
    r = rng.uniform(0.5, 8, (T, 2)).astype(np.float32)
    cand = rng.randint(0, N, (T, 2)).astype(np.int32)
    d_cand = rng.uniform(0, 1e3, (T, 2)).astype(np.float32)
    L = rng.uniform(0, 50, (N, 2)).astype(np.float32)
    D = rng.uniform(0, 5e3, N).astype(np.float32)
    C = (8.0 + rng.uniform(0, 100, (N, 2))).astype(np.float32)
    rows = [((0, N - 1), None), ((N - 1, 0), None), ((N // 2,) * 2, "tie")]
    if N >= 2:
        L[1], D[1], C[1] = L[0], D[0], C[0]
        rows.append(((0, 1), "tie"))
    if N >= 4:
        L[N - 2:], D[N - 2:] = 0.0, 0.0
        rows.append(((N - 2, N - 1), "idle"))
    for i, (pair, kind) in enumerate(rows[:T]):
        cand[i] = pair
        if kind == "tie":
            d_cand[i, 1] = d_cand[i, 0]
        elif kind == "idle":
            d_cand[i] = 0.0
    return [r, cand, d_cand, L, D, C]


def k5_edge_operands(torch, T: int, N: int, seed: int, misaligned: bool):
    """:func:`k5_edge_host` on the card; ``misaligned`` puts every
    operand one row into a larger allocation (8-byte aligned, which the
    kernel's float2 loads need, but not 16)."""
    ops = []
    for a in k5_edge_host(T, N, seed):
        t = torch.from_numpy(a).cuda()
        if misaligned:
            big = torch.empty((a.shape[0] + 1,) + a.shape[1:], dtype=t.dtype,
                              device="cuda")
            big[1:] = t
            t = big[1:]
        ops.append(t)
    return ops


def k5_forced(torch, args, tpb: int, alpha: float = 0.5, outs=None):
    """K5 through its launcher with ``tpb`` tasks a block, on ``outs`` or
    on outputs filled with -7 and NaN so that an unwritten one shows."""
    from repro_torch.kernels.dodoor_choice.kernel import launch_dodoor_choice

    T = args[0].shape[0]
    choice, scores = outs or (
        torch.full((T,), -7, dtype=torch.int32, device="cuda"),
        torch.full((T, 2), float("nan"), device="cuda"))
    launch_dodoor_choice(*args, np.float32(alpha), np.float32(1.0 - alpha),
                         choice, scores, tpb)
    return choice, scores


def k5_edge_phase(torch) -> int:
    """K5 at :data:`K5_EDGES`, aligned and misaligned, through the wrapper
    and with each tasks a block of :func:`k5_plans`, against its plain
    version; the edge rows where they should be; returns the number of
    launches checked."""
    from repro_torch.kernels.dodoor_choice import (dodoor_choice,
                                                   dodoor_choice_ref)

    n = 0
    for T, N in K5_EDGES:
        for misaligned in (False, True):
            args = k5_edge_operands(torch, T, N, T + N, misaligned)
            want = dodoor_choice_ref(*args, alpha=0.3)
            name = f"dodoor_choice edge T={T} N={N} misaligned={misaligned}"
            same(name, dodoor_choice(*args, alpha=0.3), want)
            for tpb in k5_plans(torch, T):
                same(f"{name} tpb={tpb}", k5_forced(torch, args, tpb, 0.3),
                     want)
                n += 1
            choice, scores = (w.cpu().numpy() for w in want)
            if T >= 3:
                check(scores[2, 0] == scores[2, 1],
                      f"{name}: identical candidates scored apart")
            if T >= 4 and N >= 2:
                check(choice[3] == 0 and scores[3, 0] == scores[3, 1],
                      f"{name}: the tie did not keep A")
            if T >= 5 and N >= 4:
                check((scores[4] == np.float32(0.5)).all(),
                      f"{name}: idle candidates did not fall back")
    print(f"  dodoor_choice: {n} forced launches at {len(K5_EDGES)} edge "
          "shapes (aligned and misaligned, 32 to 256 tasks a block) exact "
          "against the plain version", flush=True)
    return n


def k5_repeatable(torch, T: int, N: int) -> None:
    """Two calls of K5 bit for bit equal, with each tasks a block."""
    from repro_torch.kernels.dodoor_choice import dodoor_choice

    args = pair_inputs(torch, T, N, seed=T + N)
    same(f"dodoor_choice T={T} N={N}: two calls",
         dodoor_choice(*args, alpha=0.5), dodoor_choice(*args, alpha=0.5))
    for tpb in k5_plans(torch, T):
        same(f"dodoor_choice T={T} N={N} tpb={tpb}: two calls",
             k5_forced(torch, args, tpb), k5_forced(torch, args, tpb))


def k5_sweep(torch) -> dict:
    """K5 timed with each of :data:`K5_TPBS` tasks a block at the main
    path's shapes."""
    times = {}
    for T, N in ((50, 100), (2048, 100), (500, 10_000)):
        args = pair_inputs(torch, T, N, seed=T + N)
        outs = (torch.empty((T,), dtype=torch.int32, device="cuda"),
                torch.empty((T, 2), device="cuda"))
        for tpb in K5_TPBS:
            times[f"T={T} N={N} tpb={tpb}"] = 1e3 * event_ms(
                torch, lambda: k5_forced(torch, args, tpb, outs=outs))
    print("  dodoor_choice tasks a block (us): " + ", ".join(
        f"{k} {v:.3f}" for k, v in times.items()), flush=True)
    return times


def k4_phase(torch, T: int, N: int, masked: bool) -> dict:
    """K4 (K4-masked) against its plain version, and against K1 (K2) on
    the expanded plane; then both timed."""
    from repro_torch.core.prefilter import avail_rows
    from repro_torch.kernels.dodoor_choice import (dodoor_fused,
                                                   dodoor_fused_ref,
                                                   dodoor_fused_sparse)

    name = "dodoor_fused" + ("_masked" if masked else "")
    keys, r, d_types, node_type, L, D, C = kernel_inputs(torch, T, N,
                                                         seed=T + N)
    d = d_types[:, node_type.long()].contiguous()
    kw, sparse_kw = {}, {}
    if masked:
        down0, down1, now = kernel_windows(torch, T, N, seed=N)
        kw["avail"] = avail_rows(down0, down1, now).float()
        sparse_kw = dict(down0=down0, down1=down1, now=now)
        check(bool((kw["avail"][1:3] == 0).all()), "rows 1-2 not all down")
    args = (keys, r, d, L, D, C)
    got = dodoor_fused(*args, alpha=0.5, **kw)
    torch.cuda.synchronize()
    plain = dodoor_fused_ref(*args, 0.5, kw.get("avail"))
    same(f"{name} T={T} N={N}", got, plain)
    sparse = dodoor_fused_sparse(keys, r, d_types, node_type, L, D, C,
                                 alpha=0.5, **sparse_kw)
    same(f"{name} against its sparse form T={T} N={N}", got, sparse)
    cand = got[1]
    check(bool(((cand >= 0) & (cand < N)).all()), f"{name}: bad candidate")
    ms = event_ms(torch, lambda: dodoor_fused(*args, alpha=0.5, **kw))
    plain_ms = event_ms(
        torch, lambda: dodoor_fused_ref(*args, 0.5, kw.get("avail")))
    # Per task the key, demand and the two durations the function needs
    # in (32 B), choice, candidates and scores out (20 B); per server L, D
    # and C (20 B); the masked form reads the whole availability row.
    # K capacity compares and a count per (task, server), one more
    # compare masked.
    nbytes = T * 52 + N * 20 + (T * N * 4 if masked else 0)
    ops = T * N * (2 + 1 + (1 if masked else 0))
    return row_of(name, T, N, ms, plain_ms, nbytes, ops,
                  float((got[2] - plain[2]).abs().max()))


def k6_phase(torch, T: int, N: int, K: int) -> dict:
    """K6 against its plain version, then both and ``torch.mm(r, L.T) *
    inv`` timed."""
    from repro_torch.kernels.rl_score import (rl_score_matrix,
                                              rl_score_matrix_ref)

    rng = np.random.RandomState(T + N + K)
    r, L, C = (torch.from_numpy(a).cuda() for a in (
        (rng.rand(T, K) * 8).astype(np.float32),
        (rng.rand(N, K) * 100).astype(np.float32),
        (1.0 + rng.rand(N, K) * 100).astype(np.float32)))
    got = rl_score_matrix(r, L, C)
    torch.cuda.synchronize()
    plain = rl_score_matrix_ref(r, L, C)
    same(f"rl_score_matrix T={T} N={N} K={K}", (got,), (plain,))
    check(bool(torch.isfinite(got).all()), "rl_score_matrix: non-finite")
    inv = 1.0 / (C * C).sum(1)
    Lt = L.t()
    ms = event_ms(torch, lambda: rl_score_matrix(r, L, C))
    plain_ms = event_ms(torch, lambda: rl_score_matrix_ref(r, L, C))
    lib_ms = event_ms(torch, lambda: torch.mm(r, Lt) * inv)
    # (T + 2N)·K + N floats in (the reciprocal norms are computed in the
    # call), T·N out; 2K operations an output, 2K + 1 a server.
    return row_of("rl_score_matrix", T, N, ms, plain_ms,
                  ((T + 2 * N) * K + T * N) * 4,
                  T * N * 2 * K + N * (2 * K + 1),
                  float((got - plain).abs().max()), library_ms=lib_ms, K=K)


#: K6's edge shapes: every (T, N) of these two lists at K = 1..8.  N = 1,
#: 3 (rows shifted by 1, 2 and 3 columns), 4, 100, 257 (a scalar head and
#: tail on three rows of four) and 10⁴ (79 column tiles).
K6_EDGE_T = (1, 50, 2048)
K6_EDGE_N = (1, 3, 4, 100, 257, 10_000)


def k6_plans(torch, T: int, N: int, K: int) -> list:
    """K6 plans to force at a shape: the plan's tiling with its own rows
    a thread and with 1, 2, 4, 5 and 16 (the kernel stores 4 rows at a
    time: one short and several whole runs of 4), and 3 groups a tile
    (several column tiles, rows shifted across tile edges) with 4 rows a
    block."""
    from repro_torch.kernels._wrap import sm_count
    from repro_torch.kernels.rl_score.ops import plan_k6

    G, R, rpt = plan_k6(T, N, sm_count(torch.device("cuda")))
    return sorted({(G, R, p) for p in (1, 2, 4, 5, 16, rpt)} | {(3, 4, 2)})


def k6_operands(torch, T: int, N: int, K: int):
    rng = np.random.RandomState(T + N + K)
    return [torch.from_numpy(a).cuda() for a in (
        (rng.rand(T, K) * 8).astype(np.float32),
        (rng.rand(N, K) * 100).astype(np.float32),
        (1.0 + rng.rand(N, K) * 100).astype(np.float32))]


def k6_forced(torch, r, L, C, plan):
    """K6 through its launcher under ``plan`` (G, R, rpt), on an output
    filled with NaN so that an unwritten score shows."""
    from repro_torch.kernels.rl_score.kernel import launch_rl_score

    out = torch.full((r.shape[0], L.shape[0]), float("nan"), device="cuda")
    launch_rl_score(r, L, C, out, plan)
    return out


def k6_edge_phase(torch) -> int:
    """K6 at every (T, N, K) of :data:`K6_EDGE_T` × :data:`K6_EDGE_N` ×
    1..8, through the wrapper and under each plan of :func:`k6_plans`,
    against its plain version (compared on the card); two calls bit for
    bit at each shape.  Returns the number of launches checked."""
    from repro_torch.kernels.rl_score import (rl_score_matrix,
                                              rl_score_matrix_ref)

    n = 0
    for T in K6_EDGE_T:
        for N in K6_EDGE_N:
            for K in range(1, 9):
                r, L, C = k6_operands(torch, T, N, K)
                want = rl_score_matrix_ref(r, L, C)
                name = f"rl_score_matrix edge T={T} N={N} K={K}"
                got = rl_score_matrix(r, L, C)
                check(torch.equal(got, want), f"{name}: differs")
                check(torch.equal(got, rl_score_matrix(r, L, C)),
                      f"{name}: two calls differ")
                for plan in k6_plans(torch, T, N, K):
                    check(torch.equal(k6_forced(torch, r, L, C, plan), want),
                          f"{name} plan={plan}: differs")
                    n += 1
    print(f"  rl_score_matrix: {n} forced launches at "
          f"{len(K6_EDGE_T) * len(K6_EDGE_N) * 8} edge shapes (T in "
          f"{list(K6_EDGE_T)}, N in {list(K6_EDGE_N)}, K = 1..8) exact "
          "against the plain version, two calls equal", flush=True)
    return n


#: K6 timed under its plan's (G, R) with each of these rows a thread,
#: at the 10⁴-server shapes and the testbed's: the data behind plan_k6.
K6_RPT_SWEEP = ((500, 10_000, 2), (1024, 10_000, 2), (2048, 100, 2),
                (384, 257, 8), (50, 100, 2))
K6_RPTS = (1, 2, 4, 8, 16, 32)


def k6_sweep(torch) -> dict:
    from repro_torch.kernels._wrap import sm_count
    from repro_torch.kernels.rl_score.kernel import launch_rl_score
    from repro_torch.kernels.rl_score.ops import plan_k6

    times = {}
    for T, N, K in K6_RPT_SWEEP:
        r, L, C = k6_operands(torch, T, N, K)
        G, R, _ = plan_k6(T, N, sm_count(torch.device("cuda")))
        out = torch.empty((T, N), device="cuda")
        for rpt in K6_RPTS:
            times[f"T={T} N={N} rpt={rpt}"] = 1e3 * event_ms(
                torch, lambda: launch_rl_score(r, L, C, out, (G, R, rpt)))
    print("  rl_score_matrix rows a thread (us): " + ", ".join(
        f"{k} {v:.3f}" for k, v in times.items()), flush=True)
    return times


def library_loop(torch, device: str, route: str, wl, cl, b: int,
                 dynamics=None):
    """A scheduler written against the library API: the trace's tasks in
    blocks of ``b`` (task ``i`` keyed by the first key of
    ``split(fold_in(PRNGKey(0), i))``) against a cache view that each
    block's placements update.  ``route``: "select" places through
    ``dodoor_select_batch(use_kernel=True)`` (K5); "fused" through
    ``dodoor_fused`` (K4, or K4-masked with the availability of
    ``dynamics``' windows at each task's submit time); "rl" through
    ``dodoor_select_batch(use_kernel=False)``, recording each block's
    ``rl_score_matrix`` against the view (K6).  The view is updated in
    float64, where the block's sums are exact, and rounded once, so the
    card and the CPU hold the same view.  Returns (placements, the score
    matrices or None, wall s)."""
    from repro_torch.core import (DodoorParams, SchedulerView,
                                  dodoor_select_batch)
    from repro_torch.core.prefilter import avail_rows
    from repro_torch.kernels.dodoor_choice import dodoor_fused
    from repro_torch.kernels.rl_score import rl_score_matrix
    from repro_torch.random import PRNGKey, fold_in, split
    from repro_torch.sim.engine import _lower_dynamics

    dev = torch.device(device)
    m = wl.r_submit.shape[0]
    r_all = torch.tensor(wl.r_submit, device=dev)
    d_est = torch.tensor(wl.d_est, device=dev)
    submit = torch.tensor(wl.submit_ms, dtype=torch.float32, device=dev)
    nt = torch.from_numpy(np.asarray(cl.node_type, np.int64)).to(dev)
    C = torch.from_numpy(np.asarray(cl.C, np.float32)).to(dev)
    n = C.shape[0]
    L = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    D = torch.zeros((n,), dtype=torch.float32, device=dev)
    ids = torch.arange(m, device=dev)
    keys = split(fold_in(PRNGKey(0, device=dev), ids))[:, 0].contiguous()
    win = (None if dynamics is None
           else _lower_dynamics(dynamics, n, device=device))
    params = DodoorParams()
    placed, mats = [], []
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo in range(0, m, b):
        hi = min(m, lo + b)
        r, k = r_all[lo:hi], keys[lo:hi]
        d = d_est[lo:hi][:, nt]                                  # [T, n]
        view = SchedulerView(L=L, D=D, rif=torch.zeros_like(D), C=C)
        if route == "select":
            j = dodoor_select_batch(None, r, d, view, params, keys=k,
                                    use_kernel=True)
        elif route == "fused":
            avail = None
            if win is not None:
                avail = avail_rows(win.down0, win.down1,
                                   submit[lo:hi]).float()
            j = dodoor_fused(k, r, d, L, D, C, params.alpha,
                             avail=avail)[0]
        else:
            mats.append(rl_score_matrix(r, L, C))
            j = dodoor_select_batch(None, r, d, view, params, keys=k)
        jl = j.long()
        dj = d.gather(1, jl[:, None])[:, 0]
        L = L.double().index_add_(0, jl, r.double()).float()
        D = D.double().index_add_(0, jl, dj.double()).float()
        placed.append(j)
    out = torch.cat(placed)
    mats = torch.cat(mats).cpu() if mats else None
    out = out.cpu().numpy()
    return out, mats, time.perf_counter() - t0


def library_phase(torch, route: str, kernel: str, scale: bool = False,
                  dynamics: bool = False) -> int:
    """The library loop on the card against the same loop on the CPU, its
    launches counted; returns the kernel's launches."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.sim import (make_scaled, make_testbed, random_churn,
                                 random_outages)
    from repro_torch.workloads import azure, functionbench

    if scale:
        cl, b = make_scaled(10_000), 500
        wl = azure.synthesize(m=20_000, qps=400.0)
    else:
        cl, b = make_testbed(), 50
        wl = functionbench.synthesize(m=4000, qps=60.0)
    dyn = None
    if dynamics:
        n, H = cl.num_servers, float(wl.submit_ms[-1])
        dyn = random_churn(n, 0.15, 0.15, H, seed=11).merge(
            random_outages(n, max(2, n // 5), 0.6 * H,
                           mean_down_ms=0.2 * H, seed=7))
    m = wl.r_submit.shape[0]
    blocks = -(-m // b)
    LAUNCHES.clear()
    gpu, gmats, wall = library_loop(torch, "cuda", route, wl, cl, b, dyn)
    counts = dict(LAUNCHES)
    cpu, cmats, cpu_wall = library_loop(torch, "cpu", route, wl, cl, b, dyn)
    name = f"library {route} {'scale' if scale else 'testbed'}" + (
        " under churn and outages" if dynamics else "")
    check(counts == {kernel: blocks},
          f"{name}: launches {counts}, want {kernel}: {blocks}")
    check(np.array_equal(gpu, cpu), f"{name}: placements differ from the "
          f"cpu run at {int((gpu != cpu).sum())} tasks")
    if gmats is not None:
        check(torch.equal(gmats, cmats), f"{name}: score matrices differ")
    C = np.asarray(cl.C)
    fits = (wl.r_submit[:, None, :] <= C[None]).all(-1).any(1)
    admits = (wl.r_submit <= C[gpu]).all(1)
    check((admits | ~fits).all(), f"{name}: a task on a server that does "
          "not admit it")
    print(f"{name}: n={cl.num_servers} m={m} b={b} {m / wall:.1f} "
          f"decisions/s (wall {wall:.3f} s, cpu {cpu_wall:.1f} s), "
          f"launches {counts}, placements equal to cpu: True, distinct "
          f"servers {len(np.unique(gpu))}", flush=True)
    return counts[kernel]


def k5_family_phase(torch) -> tuple:
    print(f"launch floor {launch_floor_us(torch):.3f} us (an empty kernel "
          "between two events)", flush=True)
    rows = [k5_phase(torch, T, N)
            for T, N in ((50, 100), (2048, 100), (500, 10_000))]
    for T, N in ((50, 100), (2048, 100), (500, 10_000)):
        k5_repeatable(torch, T, N)
    k5_edge_phase(torch)
    k5_sweep(torch)
    for T, N in ((2048, 100), (500, 10_000)):
        select_batch_check(torch, T, N)
    return rows, library_phase(torch, "select", "dodoor_choice")


def k4_family_phase(torch) -> tuple:
    rows = [k4_phase(torch, T, N, masked)
            for masked in (False, True)
            for T, N in ((50, 100), (500, 10_000), (1024, 10_000))]
    edge_phase(torch, "dense", Wds=(0,) + EDGE_WD)
    launches = {
        "dodoor_fused": library_phase(torch, "fused", "dodoor_fused"),
        "dodoor_fused_masked": library_phase(
            torch, "fused", "dodoor_fused_masked", dynamics=True)}
    library_phase(torch, "fused", "dodoor_fused", scale=True)
    library_phase(torch, "fused", "dodoor_fused_masked", scale=True,
                  dynamics=True)
    return rows, launches


def k6_family_phase(torch) -> tuple:
    # (50, 100, 2), the library loop's shape, comes last: the kernels
    # line takes row 2, (1024, 10⁴).
    rows = [k6_phase(torch, T, N, K)
            for T, N, K in ((2048, 100, 2), (500, 10_000, 2),
                            (1024, 10_000, 2), (384, 257, 8),
                            (50, 100, 2))]
    k6_edge_phase(torch)
    k6_sweep(torch)
    return rows, library_phase(torch, "rl", "rl_score_matrix")


# --------------------------------------------------------------------------
# phases 16-19: the LM serving path (K7, K8, tinyllama-1.1b, mamba2-1.3b)
# --------------------------------------------------------------------------

#: K7 at the reference's pins (tests/test_kernels.py:534-541), then at
#: tinyllama-1.1b's prefill and decode: (B, H, Hkv, Lq, Lk, D, causal,
#: window).
K7_PINS = [
    (1, 2, 2, 128, 128, 64, True, None),
    (2, 4, 2, 128, 128, 64, True, None),
    (1, 8, 2, 64, 256, 64, True, None),
    (1, 2, 1, 1, 384, 64, True, None),
    (1, 2, 2, 128, 256, 64, True, 64),
    (1, 2, 2, 100, 200, 32, True, None),
    (1, 2, 2, 64, 64, 128, False, None),
]
K7_PREFILL = (4, 32, 4, 1024, 1024, 64, True, None)
K7_DECODE = (4, 32, 4, 1, 1024, 64, True, None)
#: The serving decode: (B, H, Hkv, Lk, D, cache slots).
K7_CACHE = (4, 32, 4, 1024, 64, 1152)
#: K7's tolerances: the reference pin's in float32; for bf16 inputs the
#: plain version gets the same rounded inputs, so the only extra error is
#: one rounding of the output to bf16 (half a step, 2^-8 relative).
K7_F32_TOL = dict(rtol=2e-4, atol=2e-5)
K7_BF16_TOL = dict(rtol=2 ** -8 + 2e-4, atol=2e-5)
#: K7's edge cases, (B, H, Hkv, Lq, Lk, D, causal, window, q's dtype,
#: cache): ``cache`` "bfloat16" makes k, v the prefix of a bf16 cache of
#: Lk + 64 slots read in place with a float32 query, the step's own key
#: and value as the last row (the serving decode); None, k and v in q's
#: dtype.  The split kernel takes groups of at most 16 rows (H / Hkv · Lq),
#: the tensor-core kernel the rest.
K7_EDGES = [
    (2, 16, 1, 1, 1024, 64, True, None, "float32", None),   # 16 rows
    (2, 17, 1, 1, 1024, 64, True, None, "float32", None),   # 17 rows
    (1, 8, 1, 2, 640, 64, True, None, "float32", None),     # 2 positions
    (2, 8, 2, 1, 1, 64, True, None, "float32", None),       # Lk = 1
    (1, 32, 1, 1, 1, 64, True, None, "float32", None),
    (2, 8, 2, 1, 63, 64, True, None, "float32", None),      # Lk = 63
    (1, 4, 2, 63, 63, 64, True, None, "float32", None),
    (2, 8, 2, 1, 65, 64, True, None, "float32", None),      # Lk = 65
    (1, 4, 2, 65, 65, 64, True, None, "float32", None),
    (2, 8, 1, 1, 1025, 64, True, None, "float32", None),    # Lk = 1 025
    (1, 4, 2, 40, 1025, 64, True, None, "float32", None),
    (1, 8, 1, 2, 1024, 64, True, 40, "float32", None),      # window 40
    (1, 4, 2, 256, 256, 64, True, 40, "float32", None),
    (2, 8, 1, 1, 1024, 32, True, None, "float32", None),    # D = 32
    (1, 4, 2, 200, 200, 32, True, None, "float32", None),
    (2, 8, 1, 1, 1024, 128, True, None, "float32", None),   # D = 128
    (1, 4, 2, 200, 200, 128, False, None, "float32", None),
    (2, 8, 2, 1, 1024, 64, True, None, "bfloat16", None),   # bf16 q
    (1, 4, 2, 200, 200, 64, True, None, "bfloat16", None),
    (2, 8, 2, 1, 1025, 64, True, None, "float32", "bfloat16"),  # last row
    (1, 32, 1, 1, 300, 64, True, None, "float32", "bfloat16"),
    (1, 8, 2, 100, 300, 64, True, None, "float32", None),   # Lq < Lk
    (2, 10, 1, 1, 1000, 256, True, None, "float32", None),  # D = 256
    (1, 4, 1, 1, 300, 256, True, None, "float32", "bfloat16"),
    (1, 10, 1, 70, 70, 256, True, 40, "float32", None),
    (1, 2, 1, 100, 200, 256, False, None, "float32", None),
    (1, 4, 2, 40, 40, 256, True, None, "bfloat16", None),
]
#: The split kernel timed at several run counts, to size ``plan_k7``: the
#: reference's decode pin and tinyllama-1.1b's decode at Lk = 512 and
#: 1024: (B, H, Hkv, Lk, D).
K7_SPLIT_SWEEP = [(1, 2, 1, 384, 64), (4, 32, 4, 512, 64),
                  (4, 32, 4, 1024, 64)]
#: K8 at the reference's pins (tests/test_kernels.py:569-573), a 12-step
#: chunk, and mamba2-1.3b's geometry at B = 2, L = 1024: (B, L, H, P, G,
#: S, chunk).
K8_SHAPES = [
    (1, 64, 2, 16, 1, 32, 32),
    (2, 128, 4, 32, 2, 64, 64),
    (1, 256, 2, 64, 1, 128, 64),
    (1, 64, 4, 16, 4, 16, 16),
    (2, 12, 2, 32, 1, 32, 12),
    (2, 1024, 64, 64, 1, 128, 64),
]
#: K8's edge cases, (B, L, H, P, G, S, chunk, scale of A): 3 and 5 heads
#: a group (runs of nh heads with a short last one), G = 4 with one head a
#: group, Q = 1, 17 and 33 (a cut 4-row tile), P = 8 and 24, S = 16 and
#: 48, odd widths P = 5 and S = 9 (4-byte copies and stores), and A × 20,
#: so that decays underflow to 0 (exp_s reaches 0; |s| stays near 10²,
#: where both sides' cumulative sums round within the tolerance).
K8_EDGES = [
    (2, 128, 3, 32, 1, 64, 64, 1.0),
    (1, 64, 10, 16, 2, 32, 32, 1.0),
    (2, 64, 4, 32, 4, 32, 32, 1.0),
    (1, 4, 2, 16, 1, 32, 1, 1.0),
    (1, 34, 4, 24, 2, 48, 17, 1.0),
    (2, 66, 2, 8, 1, 16, 33, 1.0),
    (2, 60, 6, 5, 2, 9, 20, 1.0),
    (1, 128, 4, 64, 1, 128, 64, 20.0),
]
#: Serving checks: decode logits against forward logits, and the 2-layer
#: copy on the card against the CPU, as max |Δ| over max |logit| (the
#: logits of a random-weight model are O(1); an elementwise rtol is
#: meaningless on the near-zero ones).  Dense: the reference pin's rtol
#: 1e-3, and the same for the VLM backbone, Whisper and the RG-LRU
#: hybrid (one multiply-add a step against the associative scan, 1.1e-6
#: of the largest logit at 5 layers on the CPU); Mamba-2: its 5e-3
#: (recurrence against the chunked SSD).  The
#: 2-layer copies differ only in summation order (cuBLAS, K7/K8 against
#: MKL and the CPU forms): 1e-4.
DECODE_TOL = {"dense": 1e-3, "ssm": 5e-3, "vlm": 1e-3, "audio": 1e-3,
              "hybrid": 1e-3}
CPU_COPY_TOL = 1e-4
#: The default bf16 KV cache rounds K and V to 8 mantissa bits (relative
#: error 2^-9 a value); over 22 layers that is ~1 % of the largest logit
#: (0.45 % at the 3-layer smoke size on the CPU): 5e-2 leaves a margin.
BF16_DECODE_TOL = 5e-2


def no_tf32(torch) -> None:
    """The comparisons below hold float32 to float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def close(name, got, want, rtol: float, atol: float) -> float:
    """Raise unless |got − want| ≤ atol + rtol·|want| everywhere (and both
    are finite); return max |got − want|."""
    g, w = got.double().cpu(), want.double().cpu()
    check(g.shape == w.shape, f"{name}: shape {tuple(g.shape)} against "
          f"{tuple(w.shape)}")
    check(bool(g.isfinite().all()), f"{name}: non-finite output")
    err = (g - w).abs()
    bad = err > atol + rtol * w.abs()
    check(not bool(bad.any()), f"{name}: {int(bad.sum())} values outside "
          f"rtol {rtol} / atol {atol} (max |Δ| {float(err.max()):.3g})")
    return float(err.max())


def k7_case(torch, B, H, Hkv, Lq, Lk, D, causal, window, dtype="float32",
            timed: bool = False):
    """K7 against ``attention_ref`` on the card; with ``timed`` also both
    and ``scaled_dot_product_attention(enable_gqa=True)`` timed.  Returns
    a kernels-line row."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)

    rng = np.random.RandomState(Lq + Lk)
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32) * sc)
               .cuda().to(dt) for s, sc in (((B, H, Lq, D), 0.5),
                                            ((B, Hkv, Lk, D), 0.5),
                                            ((B, Hkv, Lk, D), 1.0)))
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    check(got.dtype == dt, f"flash_attention: output dtype {got.dtype}")
    want = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                         window=window)
    shape = f"B={B} H={H} Hkv={Hkv} Lq={Lq} Lk={Lk} D={D} causal={causal} " \
            f"window={window} {dtype}"
    tol = K7_BF16_TOL if dtype == "bfloat16" else K7_F32_TOL
    err = close(f"flash_attention {shape}", got, want, **tol)
    if not timed:
        print(f"kernel flash_attention {shape}: max |Δ| {err:.3g} (within "
              f"rtol {tol['rtol']} / atol {tol['atol']})", flush=True)
        return None
    ms = event_ms(torch, lambda: flash_attention(q, k, v, causal=causal,
                                                 window=window))
    plain_ms = event_ms(torch, lambda: attention_ref(q, k, v, causal=causal,
                                                     window=window))
    # SDPA's causal mask is top-left aligned: for one query against the
    # whole cache the right-aligned causal mask is no mask at all.
    lib_ms = event_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal and Lq > 1, enable_gqa=True))
    # The unmasked (query, key) pairs this call needs, 4·D flops each
    # (q·k and p·v); q, k, v read once and o written once.
    qpos = np.arange(Lq)[:, None] + (Lk - Lq)
    kpos = np.arange(Lk)[None, :]
    mask = np.ones((Lq, Lk), bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    pairs = int(mask.sum())
    nbytes = (2 * B * H * Lq + 2 * B * Hkv * Lk) * D * q.element_size()
    ops, rate = k7_ops(B, H, Hkv, Lq, pairs, D, dt == torch.float32)
    return row_of("flash_attention", B * H, Lk, ms, plain_ms, nbytes, ops,
                  err, library_ms=lib_ms, op_rate=rate, Lq=Lq, D=D,
                  rep=H // Hkv)


def k7_ops(B, H, Hkv, Lq, pairs, D, f32: bool) -> tuple:
    """K7's operations and their rate for ``pairs`` unmasked (query, key)
    pairs a head.  A group of more than 16 rows runs its products as
    TF32 MMAs on the tensor cores: 3 a product in float32 (lo·hi, hi·lo,
    hi·hi), 1 for q·k and 2 for p·v when q is bf16 (its lo and k's are
    0); 2·D flops each for q·k and p·v.  A smaller group (decode) runs
    4·D float32 flops a pair on the FMA pipes."""
    if (H // Hkv) * Lq <= 16:
        return 4 * B * H * pairs * D, FP32_OPS_PER_S
    terms = (3 + 3) if f32 else (1 + 2)
    return 2 * B * H * pairs * D * terms, TF32_OPS_PER_S


def k7_cache_case(torch, B, H, Hkv, Lk, D, slots):
    """A serving decode step as ``attn_decode`` launches K7: a float32
    query over the first Lk slots of a preallocated bf16 cache of
    ``slots`` slots, read where it lies, with the step's own float32 key
    and value as the last row; against the plain version on the card.
    Timed; returns a row (no single library call casts the cache and
    replaces a row, so no library time)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ops import _plain

    rng = np.random.RandomState(Lk)
    q = torch.from_numpy(rng.randn(B, H, 1, D).astype(np.float32) * 0.5)
    kc, vc = (torch.from_numpy(rng.randn(B, Hkv, slots, D)
                               .astype(np.float32) * sc).to(torch.bfloat16)
              for sc in (0.5, 1.0))
    kt, vt = (torch.from_numpy(rng.randn(B, Hkv, 1, D).astype(np.float32)
                               * sc) for sc in (0.5, 1.0))
    kc[:, :, Lk - 1:Lk], vc[:, :, Lk - 1:Lk] = kt, vt
    q, kc, vc, kt, vt = (t.cuda() for t in (q, kc, vc, kt, vt))
    k, v = kc[:, :, :Lk], vc[:, :, :Lk]
    got = flash_attention(q, k, v, kv_last=(kt, vt))
    want = _plain(q, k, v, causal=True, window=None, scale=D ** -0.5,
                  kv_last=(kt, vt))
    shape = (f"B={B} H={H} Hkv={Hkv} Lq=1 Lk={Lk} of {slots} D={D} float32 "
             f"over a bfloat16 cache")
    err = close(f"flash_attention {shape}", got, want, **K7_F32_TOL)
    ms = event_ms(torch, lambda: flash_attention(q, k, v, kv_last=(kt, vt)))
    plain_ms = event_ms(torch, lambda: _plain(
        q, k, v, causal=True, window=None, scale=D ** -0.5,
        kv_last=(kt, vt)))
    # q, the last rows and o in float32; Lk - 1 bf16 keys and values.
    nbytes = 4 * 2 * B * H * D + 4 * 2 * B * Hkv * D \
        + 2 * 2 * B * Hkv * (Lk - 1) * D
    return row_of("flash_attention", B * H, Lk, ms, plain_ms, nbytes,
                  4 * B * H * Lk * D, err, Lq=1, D=D, rep=H // Hkv,
                  cache="bfloat16")


def k7_edge_inputs(B, H, Hkv, Lq, Lk, D, causal, window, dtype, cache):
    """A ``K7_EDGES`` case's inputs as numpy float32 arrays: q [B, H, Lq,
    D], k, v [B, Hkv, slots, D] (slots = Lk, or Lk + 64 for a cache of
    which the call reads the first Lk) and, for a cache, the step's own
    key and value [B, Hkv, 1, D] (else None), which the cache also holds
    at slot Lk − 1 (rounded, as ``attn_decode`` writes it)."""
    rng = np.random.RandomState(7 * Lq + Lk + D)
    slots = Lk + 64 if cache else Lk
    q = rng.randn(B, H, Lq, D).astype(np.float32) * 0.5
    k = rng.randn(B, Hkv, slots, D).astype(np.float32) * 0.5
    v = rng.randn(B, Hkv, slots, D).astype(np.float32)
    if not cache:
        return q, k, v, None, None
    kl = rng.randn(B, Hkv, 1, D).astype(np.float32) * 0.5
    vl = rng.randn(B, Hkv, 1, D).astype(np.float32)
    k[:, :, Lk - 1:Lk], v[:, :, Lk - 1:Lk] = kl, vl
    return q, k, v, kl, vl


def k7_edge_tensors(torch, edge, device: str):
    """A ``K7_EDGES`` case's operands on ``device``: (q, k, v, kv_last),
    k and v the first Lk slots of their arrays, in the case's dtypes."""
    B, H, Hkv, Lq, Lk, D, causal, window, dtype, cache = edge
    q, k, v, kl, vl = k7_edge_inputs(*edge)
    dt = getattr(torch, dtype)
    kvdt = getattr(torch, cache) if cache else dt
    q = torch.from_numpy(q).to(device=device, dtype=dt)
    k, v = (torch.from_numpy(a).to(device=device, dtype=kvdt)[:, :, :Lk]
            for a in (k, v))
    last = None if kl is None else tuple(
        torch.from_numpy(a).to(device=device, dtype=dt) for a in (kl, vl))
    return q, k, v, last


def k7_want(torch, q, k, v, last, causal, window):
    """The float32 oracle of a K7 call: ``attention_ref`` on the keys and
    values as the kernel reads them (in q's dtype, the last row in place
    of key Lk − 1), widened; a bf16 kernel output is one rounding from
    it."""
    from repro_torch.kernels.flash_attention import attention_ref

    if last is not None:
        k = torch.cat([k[:, :, :-1].to(q.dtype), last[0]], dim=2)
        v = torch.cat([v[:, :, :-1].to(q.dtype), last[1]], dim=2)
    return attention_ref(q.float(), k.to(q.dtype).float(),
                         v.to(q.dtype).float(), causal=causal, window=window)


def k7_edge(torch, edge) -> None:
    """One ``K7_EDGES`` case on the card against the plain version,
    through the wrapper; a split-kernel case also through the launcher
    with 1, 2, 3, the planned and more runs than key tiles (the runs past
    the end empty), each on NaN-filled outputs and scratch."""
    from repro_torch.kernels._wrap import sm_count
    from repro_torch.kernels.flash_attention.kernel import (
        launch_flash_attention)
    from repro_torch.kernels.flash_attention.ops import (K7_TILE,
                                                         flash_attention,
                                                         k7_visible, plan_k7)

    B, H, Hkv, Lq, Lk, D, causal, window, dtype, cache = edge
    q, k, v, last = k7_edge_tensors(torch, edge, "cuda")
    want = k7_want(torch, q, k, v, last, causal, window)
    tol = K7_BF16_TOL if dtype == "bfloat16" else K7_F32_TOL
    name = (f"flash_attention edge B={B} H={H} Hkv={Hkv} Lq={Lq} Lk={Lk} "
            f"D={D} causal={causal} window={window} {dtype}"
            + (f" over a {cache} cache" if cache else ""))
    got = flash_attention(q, k, v, causal=causal, window=window,
                          kv_last=last)
    torch.cuda.synchronize()
    err = close(name, got, want, **tol)
    plan = plan_k7(B, H, Hkv, Lq, Lk, window, sm_count(q.device))
    runs = []
    if plan.regime == "decode":
        lo, hi = k7_visible(Lq, Lk, window)
        tiles = -(-(hi - lo) // K7_TILE)
        runs = sorted({1, 2, 3, plan.splits, tiles + 1})
        for splits in runs:
            out = torch.full_like(q, float("nan"))
            part = torch.full((B * H * Lq * splits * (D + 2),), float("nan"),
                              device="cuda")
            launch_flash_attention(q, k, v, out, causal=causal,
                                   window=window, scale=D ** -0.5,
                                   kv_last=last, splits=splits, part=part)
            torch.cuda.synchronize()
            err = max(err, close(f"{name} with {splits} runs", out, want,
                                 **tol))
    print(f"kernel {name}: {plan.regime}, {plan.splits} run(s) planned"
          + (f", launched with {runs}" if runs else "")
          + f", max |Δ| {err:.3g}", flush=True)


def k7_repeatable(torch, B, H, Hkv, Lq, Lk, D, causal, window) -> None:
    """Two calls on the same inputs give the same bits."""
    from repro_torch.kernels.flash_attention import flash_attention

    rng = np.random.RandomState(Lq + Lk)
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32)).cuda()
               for s in ((B, H, Lq, D), (B, Hkv, Lk, D), (B, Hkv, Lk, D)))
    first = flash_attention(q, k, v, causal=causal, window=window)
    again = flash_attention(q, k, v, causal=causal, window=window)
    check(torch.equal(first, again), f"flash_attention B={B} H={H} Lq={Lq} "
          f"Lk={Lk}: two calls differ")
    print(f"kernel flash_attention B={B} H={H} Hkv={Hkv} Lq={Lq} Lk={Lk} "
          f"D={D}: two calls bit for bit equal", flush=True)


def k7_split_sweep(torch, B, H, Hkv, Lk, D) -> None:
    """The split kernel at one decode shape with 1, 2, 4, 8, 16 and the
    planned runs (CUDA events), to size ``plan_k7``'s choices."""
    from repro_torch.kernels._wrap import sm_count
    from repro_torch.kernels.flash_attention.kernel import (
        launch_flash_attention)
    from repro_torch.kernels.flash_attention.ops import plan_k7

    rng = np.random.RandomState(Lk)
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32)).cuda()
               for s in ((B, H, 1, D), (B, Hkv, Lk, D), (B, Hkv, Lk, D)))
    plan = plan_k7(B, H, Hkv, 1, Lk, None, sm_count(q.device))
    out = torch.empty_like(q)
    us = {}
    for splits in sorted({1, 2, 4, 8, 16, plan.splits}):
        part = torch.empty(B * H * splits * (D + 2), device="cuda")
        us[splits] = 1e3 * event_ms(torch, lambda: launch_flash_attention(
            q, k, v, out, causal=True, window=None, scale=D ** -0.5,
            splits=splits, part=part))
    print(f"kernel flash_attention split sweep B={B} H={H} Hkv={Hkv} Lq=1 "
          f"Lk={Lk} D={D} (planned {plan.splits}): "
          + ", ".join(f"{s} run(s) {t:.3f} us" for s, t in us.items()),
          flush=True)


def k7_phase(torch) -> dict:
    no_tf32(torch)
    for shape in K7_PINS:
        k7_case(torch, *shape)
    k7_case(torch, 1, 2, 2, 128, 128, 64, True, None, dtype="bfloat16")
    rows = [k7_case(torch, *K7_PREFILL, timed=True),
            k7_case(torch, *K7_DECODE, timed=True),
            k7_cache_case(torch, *K7_CACHE)]
    for edge in K7_EDGES:
        k7_edge(torch, edge)
    for shape in (K7_PREFILL, K7_DECODE):
        k7_repeatable(torch, *shape)
    for shape in K7_SPLIT_SWEEP:
        k7_split_sweep(torch, *shape)
    return rows


def ssd_inputs(B, L, H, P, G, S, seed, a_scale=1.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, L, H, P).astype(np.float32) * 0.5,
            (0.01 + rng.rand(B, L, H)).astype(np.float32),
            -(0.1 + rng.rand(H)).astype(np.float32) * np.float32(a_scale),
            rng.randn(B, L, G, S).astype(np.float32) * 0.3,
            rng.randn(B, L, G, S).astype(np.float32) * 0.3)


def k8_operands(torch, B, L, H, P, G, S, chunk, a_scale=1.0):
    """``ssd``'s inputs on the card, and K8's operands laid out as ``ssd``
    lays them out, with the heads a group."""
    x, dt, A, Bm, Cm = (torch.from_numpy(a).cuda() for a in
                        ssd_inputs(B, L, H, P, G, S, L + S, a_scale))
    NC = L // chunk
    ops = [t.contiguous() for t in (
        x.transpose(1, 2).reshape(B * H, NC, chunk, P),
        dt.transpose(1, 2).reshape(B * H, NC, chunk) * A.repeat(B)[:, None,
                                                                    None],
        dt.transpose(1, 2).reshape(B * H, NC, chunk),
        Bm.transpose(1, 2).reshape(B, G, NC, chunk, S),
        Cm.transpose(1, 2).reshape(B, G, NC, chunk, S))]
    return (x, dt, A, Bm, Cm), ops, H // G


def ssd_check(torch, shape, ins, chunk) -> float:
    """``ssd`` (K8 plus the inter-chunk scan) against the recurrence."""
    from repro_torch.kernels.ssd_chunk import ssd, ssd_ref

    y, h = ssd(*ins, chunk=chunk)
    ry, rh = ssd_ref(*ins)
    return max(close(f"ssd {shape} y", y, ry, 2e-4, 2e-4),
               close(f"ssd {shape} h", h, rh, 2e-4, 2e-4))


def k8_case(torch, B, L, H, P, G, S, chunk, timed: bool = False):
    """K8 against ``ssd_chunk_ref`` on the card, and ``ssd`` against the
    recurrence ``ssd_ref``; with ``timed``, two calls bit for bit equal
    and K8 and its plain version timed.  Returns a kernels-line row or
    None."""
    from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_ref

    ins, ops, hpg = k8_operands(torch, B, L, H, P, G, S, chunk)
    NC = L // chunk
    got = ssd_chunk(*ops, heads_per_group=hpg)
    torch.cuda.synchronize()
    want = ssd_chunk_ref(*ops, heads_per_group=hpg)
    shape = f"B={B} L={L} H={H} P={P} G={G} S={S} Q={chunk}"
    err = max(close(f"ssd_chunk {shape} {name}", g, w, 2e-4, 2e-4)
              for name, g, w in zip(("y_intra", "H_out", "exp_s"), got,
                                    want))
    ssd_err = ssd_check(torch, shape, ins, chunk)
    print(f"kernel ssd_chunk {shape}: max |Δ| {err:.3g} against the plain "
          f"version, ssd against ssd_ref {ssd_err:.3g} (within rtol 2e-4 / "
          f"atol 2e-4)", flush=True)
    if not timed:
        return None
    again = ssd_chunk(*ops, heads_per_group=hpg)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"ssd_chunk {shape}: two calls differ")
    ms = event_ms(torch, lambda: ssd_chunk(*ops, heads_per_group=hpg))
    plain_ms = event_ms(torch, lambda: ssd_chunk_ref(*ops,
                                                     heads_per_group=hpg))
    BH = B * H
    # x, delta, dt, B, C in; y_intra, H_out, exp_s out (float32).
    nbytes = 4 * (BH * L * P + 2 * BH * L + 2 * B * G * L * S
                  + BH * L * P + BH * NC * S * P + BH * L)
    # The work the function needs: C·Bᵀ once per (batch, group, chunk)
    # and, like G·x, only over the causal triangle of Q(Q+1)/2 pairs;
    # the chunk state (B·w)ᵀ·x per (bh, chunk).
    tri = chunk * (chunk + 1) // 2
    ops_n = (B * G * NC * 2 * tri * S
             + BH * NC * (2 * tri * P + 2 * chunk * S * P))
    return row_of("ssd_chunk", BH, NC, ms, plain_ms, nbytes, ops_n, err,
                  Q=chunk, P=P, S=S)


def k8_edge(torch, B, L, H, P, G, S, chunk, a_scale) -> None:
    """An edge case of K8's block design: the wrapper (its own nh) and the
    launcher with 1, 2, 3, 4 and all heads of a group a block, each
    against ``ssd_chunk_ref`` on outputs first filled with NaN; and
    ``ssd`` against ``ssd_ref``."""
    from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_ref
    from repro_torch.kernels.ssd_chunk.kernel import launch_ssd_chunk

    ins, ops, hpg = k8_operands(torch, B, L, H, P, G, S, chunk, a_scale)
    want = ssd_chunk_ref(*ops, heads_per_group=hpg)
    shape = (f"B={B} L={L} H={H} P={P} G={G} S={S} Q={chunk} "
             f"A×{a_scale:g}")
    if a_scale != 1.0:
        check(bool((want[2] == 0).any()), f"ssd_chunk {shape}: no decay "
              "underflows")
    runs = {"wrapper": ssd_chunk(*ops, heads_per_group=hpg)}
    for nh in sorted({1, 2, 3, 4, hpg} & set(range(1, hpg + 1))):
        out = [torch.full_like(w, float("nan")) for w in want]
        launch_ssd_chunk(*ops, *out, heads_per_group=hpg, nh=nh)
        runs[f"nh={nh}"] = out
    torch.cuda.synchronize()
    err = max(close(f"ssd_chunk {shape} {run} {name}", g, w, 2e-4, 2e-4)
              for run, got in runs.items()
              for name, g, w in zip(("y_intra", "H_out", "exp_s"), got,
                                    want))
    ssd_err = ssd_check(torch, shape, ins, chunk)
    print(f"kernel ssd_chunk edge {shape}: {', '.join(runs)}: max |Δ| "
          f"{err:.3g}, ssd against ssd_ref {ssd_err:.3g}", flush=True)


def k8_misaligned(torch) -> None:
    """K8 on inputs that start one float into their buffers (contiguous
    views): the launcher gives up its 16-byte copies for 4-byte ones."""
    from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_ref

    _, ops, hpg = k8_operands(torch, 1, 256, 2, 64, 1, 128, 64)
    views = []
    for t in ops:
        v = torch.empty(t.numel() + 1, device="cuda")[1:].view(t.shape)
        views.append(v.copy_(t))
    got = ssd_chunk(*views, heads_per_group=hpg)
    torch.cuda.synchronize()
    want = ssd_chunk_ref(*ops, heads_per_group=hpg)
    err = max(close(f"ssd_chunk misaligned {name}", g, w, 2e-4, 2e-4)
              for name, g, w in zip(("y_intra", "H_out", "exp_s"), got,
                                    want))
    print(f"kernel ssd_chunk on misaligned views: max |Δ| {err:.3g}",
          flush=True)


def k8_phase(torch) -> list:
    no_tf32(torch)
    rows = [k8_case(torch, *shape, timed=shape == K8_SHAPES[-1])
            for shape in K8_SHAPES]
    for edge in K8_EDGES:
        k8_edge(torch, *edge)
    k8_misaligned(torch)
    return [r for r in rows if r is not None]


#: Decode prompt steps of the serving checks, by family where not 128
#: (the hybrid's and Whisper's steps cost the most), and the greedy steps
#: after them.
PROMPT_STEPS = {"hybrid": 64, "audio": 32}
GEN_STEPS = 32
#: Tokens of the card-against-CPU 2-layer copies where not 2 × 128
#: (recurrentgemma: 1 × 300, a scan length that is no power of two).
COPY_TOKENS = {"qwen2-vl-2b": (2, 64), "recurrentgemma-2b": (1, 300),
               "whisper-base": (1, 64)}


def mrope_streams(B: int, grid: int, n_text: int):
    """Qwen2-VL's three position streams for ``grid`` × ``grid`` patches
    followed by ``n_text`` tokens: the patches at (t, h, w) = (0, row,
    column), the text from max + 1 on with equal streams.  [B, 3, grid² +
    n_text] int64."""
    rows = np.repeat(np.arange(grid), grid)
    cols = np.tile(np.arange(grid), grid)
    img = np.stack([np.zeros_like(rows), rows, cols])
    text = np.broadcast_to(grid + np.arange(n_text), (3, n_text))
    return np.broadcast_to(np.concatenate([img, text], 1),
                           (B, 3, grid * grid + n_text)).copy()


def family_batch(torch, cfg, B: int, L: int, seed: int, device: str):
    """A forward batch of B × L positions for ``cfg``'s family, from a
    seed: tokens; qwen2-vl also patch embeddings (a quarter of the
    positions, at most VLM_PATCHES, on a square grid) with their M-RoPE
    streams; whisper the 1500 encoder frames."""
    rng = np.random.RandomState(seed)
    batch = {}
    n_tok = L
    if cfg.family == "vlm":
        grid = min(VLM_GRID, int(np.sqrt(L // 4)))
        n_tok = L - grid * grid
        batch["patches"] = torch.from_numpy(rng.randn(
            B, grid * grid, cfg.d_model).astype(np.float32)).to(device)
        batch["positions3"] = torch.from_numpy(
            mrope_streams(B, grid, n_tok)).to(device)
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.randn(
            B, cfg.encoder_frames, cfg.d_model).astype(np.float32)
            * 0.5).to(device)
    batch["tokens"] = torch.from_numpy(rng.randint(
        0, cfg.vocab, (B, n_tok))).to(device)
    return batch


def kernel_calls(cfg, step: bool) -> int:
    """Launches of the model's kernel (K7; K8 for the SSM) in one
    ``forward`` or, with ``step``, one decode step: one an attention (or
    SSD) layer.  The SSM's decode step runs its recurrence instead."""
    if cfg.family == "ssm":
        return 0 if step else cfg.n_layers
    if cfg.family == "hybrid":
        return sum(1 for k in cfg._layer_kinds() if k == "attn")
    if cfg.family == "audio":
        return 2 * cfg.n_layers + (0 if step else cfg.encoder_layers)
    return cfg.n_layers


def two_layers(cfg, params) -> tuple:
    """(config, parameters) of a 2-layer copy with the same weights (the
    hybrid: one (R, R, A) block; Whisper: two encoder and two decoder
    layers)."""
    from dataclasses import replace

    from repro_torch.models.common import tree_map

    cut = lambda t: tree_map(lambda a: a[:2], t)          # noqa: E731
    if cfg.family == "hybrid":
        p2 = {k: v for k, v in params.items() if k != "rem"}
        p2["blocks"] = tree_map(lambda a: a[:1], params["blocks"])
        return replace(cfg, n_layers=len(cfg.block_pattern)), p2
    if cfg.family == "audio":
        return (replace(cfg, n_layers=2, encoder_layers=2),
                dict(params, enc_layers=cut(params["enc_layers"]),
                     dec_layers=cut(params["dec_layers"])))
    return replace(cfg, n_layers=2), dict(params, layers=cut(params["layers"]))


def cache_dtype(torch, cache):
    """The dtype a decode cache keeps its keys (or states) in: that of its
    tensors other than float32 ones (the hybrid's ``h`` stays float32),
    else float32."""
    from repro_torch.models.common import tree_map

    kinds = []
    tree_map(lambda a: kinds.append(getattr(a, "dtype", None)), cache)
    low = [d for d in kinds if d is not None and d != torch.float32]
    return low[0] if low else torch.float32


def scan_share(torch, cfg, B: int, L: int, fwd_ms: float) -> str:
    """The hybrid's prefill scan (``rglru.associative_scan``) on the card
    at the forward's shape, in the card's float32 multiply-add and, for
    comparison, in the CPU's float64 FMA replay, with the card form's
    share of the forward (one scan a recurrent layer)."""
    from repro_torch.models import rglru

    gen = torch.Generator(device="cuda").manual_seed(4)
    W = cfg.lru_width or cfg.d_model
    a = torch.rand((B, L, W), generator=gen, device="cuda") * 0.1 + 0.9
    b = torch.randn((B, L, W), generator=gen, device="cuda")

    def scan_ms():
        return event_ms(torch, lambda: rglru.associative_scan(a, b),
                        reps=10, warmup=2)

    ms = scan_ms()
    madd = rglru._madd
    try:
        rglru._madd = rglru.fma
        fma_ms = scan_ms()
    finally:
        rglru._madd = madd
    n_rec = sum(1 for k in cfg._layer_kinds() if k != "attn")
    return (f"; prefill scan [{B}, {L}, {W}] {ms:.3f} ms (float64 FMA "
            f"replay {fma_ms:.3f} ms), x{n_rec} recurrent layers = "
            f"{n_rec * ms / fwd_ms:.3f} of the forward")


def serving_phase(torch, name: str, kernel: str, B: int, L: int) -> int:
    """A model of the repo at full width and depth on the card, weights
    from a seed: ``forward`` on a B × L batch of its family (finite
    logits, one ``kernel`` launch a layer of that kind); prompts fed
    through ``decode_step`` from an empty cache (Whisper's primed from the
    frames), float32 and then the default dtype, their logits against
    ``forward``'s; ``GEN_STEPS`` greedy tokens; and a 2-layer copy with
    the same weights on the card against the CPU.  Returns the kernel's
    launches in the forward and decode runs."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import registry
    from repro_torch.models.common import tree_map

    no_tf32(torch)
    cfg = ARCHS[name]
    t0 = time.perf_counter()
    params = registry.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    sizes = []
    tree_map(lambda a: sizes.append(a.numel()), params)
    batch = family_batch(torch, cfg, B, L, 0, "cuda")
    registry.forward(cfg, params, family_batch(torch, cfg, 1, 64, 9,
                                               "cuda"))      # warm-up
    torch.cuda.synchronize()

    LAUNCHES.clear()
    t0 = time.perf_counter()
    logits, _ = registry.forward(cfg, params, batch)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    fwd_counts = dict(LAUNCHES)
    want = {kernel: kernel_calls(cfg, False)}
    check(fwd_counts == want, f"{name} forward: launches {fwd_counts}, "
          f"want {want}")
    check(tuple(logits.shape) == (B, L, cfg.vocab) and
          bool(logits.isfinite().all()), f"{name} forward: logits "
          f"{tuple(logits.shape)} not finite or of the wrong shape")
    del logits
    scan = (scan_share(torch, cfg, B, L, fwd_s * 1e3)
            if cfg.family == "hybrid" else "")

    # Four prompts from a seed (text only for the VLM: its decode is plain
    # RoPE, which M-RoPE's equal streams reproduce; Whisper's with frames).
    n_req, n_prompt = 4, PROMPT_STEPS.get(cfg.family, 128)
    rng = np.random.RandomState(1)
    prompt = {"tokens": torch.from_numpy(rng.randint(
        0, cfg.vocab, (n_req, n_prompt))).cuda()}
    if cfg.family == "vlm":
        prompt["patches"] = torch.zeros((n_req, 0, cfg.d_model),
                                        device="cuda")
    if cfg.family == "audio":
        prompt["frames"] = family_batch(torch, cfg, n_req, 1, 1,
                                        "cuda")["frames"]
    ref, _ = registry.forward(cfg, params, prompt)
    scale = float(ref.abs().max())
    primes = 0

    def feed(**kw):
        """The prompts through ``decode_step`` from an empty cache (of
        the model's default dtype unless ``kw`` names one).  Returns max
        |decode − forward| over the prompt positions, the cache, the last
        step's logits and the wall time a step."""
        nonlocal primes
        cache = registry.init_cache(cfg, n_req, n_prompt + GEN_STEPS,
                                    device="cuda", **kw)
        if cfg.family == "audio":
            cache = registry.prime_cache(cfg, params, cache,
                                         prompt["frames"])
            primes += 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = []
        for t in range(n_prompt):
            lg, cache = registry.decode_step(cfg, params, cache,
                                             prompt["tokens"][:, t:t + 1])
            outs.append(lg)
        torch.cuda.synchronize()
        dec = torch.cat(outs, dim=1)
        err = float((dec - ref).abs().max())
        check(bool(dec.isfinite().all()), f"{name}: non-finite decode")
        return err, cache, lg, (time.perf_counter() - t0) / n_prompt

    LAUNCHES.clear()
    # Float32 cache: decode against forward at the reference pin's bound.
    dec_err, cache, lg, prompt_s = feed(dtype=torch.float32)
    check(dec_err <= DECODE_TOL[cfg.family] * scale,
          f"{name}: decode logits differ from forward by {dec_err:.3g} "
          f"(max |logit| {scale:.3g}, bound {DECODE_TOL[cfg.family]} of it)")
    steps = n_prompt
    default = cache_dtype(torch, registry.init_cache(cfg, 1, 1,
                                                     device="cuda"))
    bf16_err = None
    if default != torch.float32:
        # The default (bf16) cache, which serving uses: K and V are
        # rounded to 8 bits of mantissa, so the bound is bf16's.
        bf16_err, cache, lg, _ = feed()
        check(bf16_err <= BF16_DECODE_TOL * scale,
              f"{name}: decode with the {default} cache differs from "
              f"forward by {bf16_err:.3g} (max |logit| {scale:.3g}, bound "
              f"{BF16_DECODE_TOL} of it)")
        steps += n_prompt
    nxt = lg[:, -1].argmax(-1, keepdim=True)
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GEN_STEPS):
        lg, cache = registry.decode_step(cfg, params, cache, nxt)
        finite &= lg.isfinite().all()
        nxt = lg[:, -1].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    gen_s = (time.perf_counter() - t0) / GEN_STEPS
    check(bool(finite), f"{name}: non-finite greedy logits")
    steps += GEN_STEPS
    dec_counts = dict(LAUNCHES)
    n = kernel_calls(cfg, True) * steps + primes * cfg.encoder_layers
    want = {kernel: n} if n else {}
    check(dec_counts == want, f"{name} decode: launches {dec_counts}, want "
          f"{want}")

    cfg2, p2 = two_layers(cfg, params)
    B2, L2 = COPY_TOKENS.get(name, (2, 128))
    batch2 = family_batch(torch, cfg2, B2, L2, 3, "cuda")
    LAUNCHES.clear()
    gpu, _ = registry.forward(cfg2, p2, batch2)
    torch.cuda.synchronize()
    want = {kernel: kernel_calls(cfg2, False)}
    check(dict(LAUNCHES) == want, f"{name} 2-layer copy: launches "
          f"{dict(LAUNCHES)}, want {want}")
    t0 = time.perf_counter()
    cpu, _ = registry.forward(cfg2, tree_map(lambda a: a.cpu(), p2),
                              {k: v.cpu() for k, v in batch2.items()})
    cpu_s = time.perf_counter() - t0
    scale2 = float(cpu.abs().max())
    cpu_err = float((gpu.cpu() - cpu).abs().max())
    check(bool(gpu.isfinite().all()) and cpu_err <= CPU_COPY_TOL * scale2,
          f"{name} 2-layer copy: card and CPU differ by {cpu_err:.3g} (max "
          f"|logit| {scale2:.3g}, bound {CPU_COPY_TOL} of it)")
    print(f"serving {name}: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"vocab={cfg.vocab}, {sum(sizes) * 4 / 1e9:.2f} GB of float32 "
          f"weights, init {init_s * 1e3:.1f} ms; forward B={B} L={L}: "
          f"{fwd_s * 1e3:.1f} ms, {B * L / fwd_s:.1f} prefill tokens/s, "
          f"launches {fwd_counts}{scan}; decode of {n_req} requests: "
          f"{n_prompt} prompt steps {prompt_s * 1e3:.2f} ms a step "
          f"(float32 cache), {GEN_STEPS} greedy steps {gen_s * 1e3:.2f} ms "
          f"a step ({default} cache), {n_req / gen_s:.1f} decode tokens/s, "
          f"launches {dec_counts} in {steps} steps; decode vs forward max "
          f"|Δ| {dec_err:.3g} of max |logit| {scale:.3g} "
          f"({dec_err / scale:.3g}; {default} cache: "
          f"{'-' if bf16_err is None else f'{bf16_err / scale:.3g}'}); "
          f"2-layer copy card vs CPU max |Δ| {cpu_err:.3g} of {scale2:.3g} "
          f"({cpu_err / scale2:.3g}; CPU run {cpu_s:.1f} s)", flush=True)
    del params, batch, cache
    torch.cuda.empty_cache()
    return fwd_counts.get(kernel, 0) + dec_counts.get(kernel, 0)


# --------------------------------------------------------------------------
# phase 21: the sequential oracle on the card
# --------------------------------------------------------------------------

SEQ_POLICIES = ("random", "pot", "dodoor", "one_plus_beta", "prequal")
#: Phase 21's testbed runs take the first SEQ_TASKS tasks of phase 3's
#: FunctionBench trace (m = 4 000): the script's time limit (see
#: ``CHAIN_TASKS`` and ``DAG_TASKS``; 1 200 with 27 phases, 800 with 28).
SEQ_TASKS = 400
#: tests/test_engine_batched.py:22's bound on the time planes.
SEQ_RTOL, SEQ_ATOL = 1e-6, 1e-3
#: The message-reduction point of benchmarks/bench_faults.py:86-145 (the
#: testbed, FunctionBench m = 3000 at 60 qps, 25 outages, the default
#: RetryPolicy, b = 50): each policy's total messages at seeds 0 and 1,
#: the seed means of msgs/task and the reductions rounded as the
#: benchmark rounds them.  Provenance: the JAX reference on the CPU (JAX
#: 0.9; its sequential and batched drivers give the same ledgers).
MESSAGE_TOTALS = {"dodoor": (7858, 7885), "pot": (18186, 18198),
                  "prequal": (24208, 24200)}
MESSAGE_MEANS = {"dodoor": 2.6238, "pot": 6.064, "prequal": 8.068}
MESSAGE_REDUCTION = {"vs_pot": 0.5673, "vs_prequal": 0.6748}


def seq_run(torch, wl, cluster, cfg, device: str, seed: int = 0,
            dynamics=None):
    """One sequential run; returns (result, wall s).  The oracle launches
    no kernel: the launch counts stay empty."""
    from repro_torch.kernels.dodoor_choice import LAUNCHES
    from repro_torch.sim import simulate

    LAUNCHES.clear()
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = simulate(wl, cluster, cfg, seed, mode="sequential", device=device,
                   dynamics=dynamics)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(not dict(LAUNCHES), f"sequential run launched {dict(LAUNCHES)}")
    return res, wall


def seq_check(name, got, want, wl, cluster, policy: str) -> bool:
    """``got`` against ``want``: the ledger exact; placements exact or, for
    the policies that score two sampled candidates, the first divergent
    task picked one of its candidates on both (a near-tie flip); every
    time plane within tests/test_engine_batched.py:22's bound up to the
    first divergence.  Returns whether every plane was bit for bit
    equal."""
    from repro_torch.sim import resource_violations

    check(ledger(got) == ledger(want),
          f"{name}: ledger {ledger(got)} != {ledger(want)}")
    diff = np.flatnonzero(got.server != want.server)
    upto = int(diff[0]) if diff.size else got.server.shape[0]
    if diff.size:
        check(policy in ("dodoor", "one_plus_beta")
              and first_divergence_ok(got, want, wl, cluster),
              f"{name}: placements diverge at task {upto}")
    exact = not diff.size
    for f in TIME_PLANES:
        a = getattr(got, f)[:upto].astype(np.float64)
        b = getattr(want, f)[:upto].astype(np.float64)
        check(bool(np.all(np.abs(a - b) <= SEQ_ATOL + SEQ_RTOL * np.abs(b))),
              f"{name}: {f} beyond rtol {SEQ_RTOL} / atol {SEQ_ATOL}")
        exact = exact and np.array_equal(getattr(got, f), getattr(want, f))
    check(np.isfinite(got.finish_ms).all(), f"{name}: non-finite finish")
    check(resource_violations(got, cluster) == 0,
          f"{name}: capacity violated")
    return exact


def sync_count(torch, fn) -> int:
    """Host syncs the card reports while ``fn`` runs (CUDA sync debug mode,
    one warning a sync)."""
    return sum(sync_sites(torch, fn).values())


def sync_sites(torch, fn) -> dict:
    """``{"file:line": syncs}`` of the Python lines that synced the card
    while ``fn`` ran."""
    import collections
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return dict(collections.Counter(
        f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught))


def sequential_phase(torch) -> dict:
    """Phase 21: (a) the sequential oracle on the testbed for every
    policy, each card run against its CPU run and dodoor's also against
    the batched driver on the card; that the per-task loop syncs the card
    no more for 300 tasks than for 100; (b) the message-reduction point
    under failure on the card, against the reference's ledgers; (c) the
    balls-into-bins loop on the card against the CPU."""
    from repro_torch.sim import (EngineConfig, RetryPolicy, make_testbed,
                                 random_outages, simulate)
    from repro_torch.workloads import functionbench

    tb = make_testbed()
    wl = head(functionbench.synthesize(m=4000, qps=300.0), SEQ_TASKS)
    m = wl.r_submit.shape[0]
    for policy in SEQ_POLICIES:
        cfg = EngineConfig(policy=policy, b=50)
        gpu, wall = seq_run(torch, wl, tb, cfg, "cuda")
        cpu, cpu_wall = seq_run(torch, wl, tb, cfg, "cpu")
        exact = seq_check(f"sequential {policy}", gpu, cpu, wl, tb, policy)
        line = (f"sequential {policy}: m={m} b={cfg.b} {m / wall:.1f} "
                f"decisions/s on the card (wall {wall:.3f} s; cpu "
                f"{m / cpu_wall:.1f}/s), bit for bit equal to cpu: {exact}, "
                f"ledger {ledger(gpu)}")
        if policy == "dodoor":
            bat = simulate(wl, tb, cfg, device="cuda")
            same = seq_check("sequential vs batched", gpu, bat, wl, tb,
                             policy)
            line += f", equal to the batched driver on the card: {same}"
        print(line, flush=True)

    for policy in ("pot", "dodoor", "prequal"):
        cfg = EngineConfig(policy=policy, b=50)
        n100, n300 = (sync_count(torch, lambda k=k: simulate(
            functionbench.synthesize(m=k, qps=300.0, seed=3), tb, cfg,
            mode="sequential", device="cuda")) for k in (100, 300))
        print(f"sequential {policy}: {n100} host syncs for 100 tasks, "
              f"{n300} for 300", flush=True)
        check(n300 == n100, f"sequential {policy}: the per-task loop syncs "
              f"the card ({n100} syncs for 100 tasks, {n300} for 300)")

    # (b) benchmarks/bench_faults.py's message_reduction point.
    wl = functionbench.synthesize(m=3000, qps=60.0, seed=0)
    m = wl.r_submit.shape[0]
    H = float(wl.submit_ms[-1])
    dyn = random_outages(tb.num_servers, 25, 0.6 * H,
                         mean_down_ms=0.15 * H, seed=7)
    totals, means = {}, {}
    for policy in ("dodoor", "pot", "prequal"):
        cfg = EngineConfig(policy=policy, b=50, retry=RetryPolicy())
        runs = []
        for seed in (0, 1):
            res, wall = seq_run(torch, wl, tb, cfg, "cuda", seed, dyn)
            runs.append(res.msgs_total)
            print(f"message point {policy} seed {seed}: msgs/task "
                  f"{res.msgs_per_task:.6f} (ledger {ledger(res)}), "
                  f"{int(res.attempts.sum()) / wall:.1f} decisions/s (wall "
                  f"{wall:.3f} s)", flush=True)
        totals[policy] = tuple(runs)
        means[policy] = round(float(np.mean([t / m for t in runs])), 4)
    reduction = {f"vs_{p}": round(1.0 - means["dodoor"] / means[p], 4)
                 for p in ("pot", "prequal")}
    out = {"per_policy_msgs_per_task": means, "reduction": reduction,
           "totals": {p: list(t) for p, t in totals.items()}}
    print(json.dumps({"message_reduction": out}), flush=True)
    check(totals == MESSAGE_TOTALS,
          f"message point: totals {totals} != {MESSAGE_TOTALS}")
    check(means == MESSAGE_MEANS and reduction == MESSAGE_REDUCTION,
          f"message point: {means}, {reduction}")

    # (c) core.balls_bins: the placement loop runs on the key's device.
    from repro_torch.core import balls_bins
    from repro_torch.random import PRNGKey

    w = np.random.RandomState(5).randint(1, 5, 2000).astype(np.float32)
    for beta, batch in ((1.0, 1), (0.5, 16)):
        def throw(dev, k=w.shape[0]):
            return balls_bins.run_balls_into_bins(
                PRNGKey(5, device=dev), w[:k], 100, 2, beta, batch)
        t0 = time.perf_counter()
        gpu = throw("cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cpu = throw("cpu")
        check(gpu.device.type == "cuda" and torch.equal(gpu.cpu(), cpu),
              f"balls_bins beta={beta} batch={batch}: card != cpu")
        n100, n300 = (sync_count(torch, lambda k=k: throw("cuda", k))
                      for k in (100, 300))
        check(n300 == n100, f"balls_bins: the placement loop syncs the "
              f"card ({n100} syncs for 100 balls, {n300} for 300)")
        print(f"balls_bins beta={beta} batch={batch}: m=2000 n=100 on the "
              f"card in {wall:.3f} s, loads equal to cpu, gap "
              f"{float(balls_bins.gap(gpu))}; {n100} host syncs for 100 "
              f"balls, {n300} for 300", flush=True)
    return out


# --------------------------------------------------------------------------
# phase 22: PoT and Prequal on the batched driver; the decision service
# --------------------------------------------------------------------------

def exact_check(name, got, want) -> None:
    """``got`` equal to ``want`` bit for bit: placements, the ledger and
    every time plane."""
    check(np.array_equal(got.server, want.server),
          f"{name}: placements differ at "
          f"{int(np.argmax(got.server != want.server))}")
    check(ledger(got) == ledger(want),
          f"{name}: ledger {ledger(got)} != {ledger(want)}")
    for f in TIME_PLANES:
        check(np.array_equal(getattr(got, f), getattr(want, f)),
              f"{name}: {f} differs")


def batched_run(torch, wl, cluster, cfg, device: str, seed: int = 0,
                dynamics=None):
    """One batched run; returns (result, wall s, launches by kernel), the
    launch counts set to 0 just before the run and read just after."""
    from repro_torch.kernels.dodoor_choice import LAUNCHES
    from repro_torch.sim import simulate

    LAUNCHES.clear()
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = simulate(wl, cluster, cfg, seed, device=device, dynamics=dynamics)
    if device == "cuda":
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0, dict(LAUNCHES)


def syncs_and_commits(torch, run) -> tuple:
    """(host syncs, calls of the engine's ``_commit_servers``) while
    ``run`` runs: PoT commits once a speculative iteration and Prequal
    once a chunk, each after one host read."""
    from repro_torch.sim import engine

    orig = engine._commit_servers
    calls = [0]

    def counting(*args):
        calls[0] += 1
        return orig(*args)

    engine._commit_servers = counting
    try:
        syncs = sync_count(torch, run)
    finally:
        engine._commit_servers = orig
    return syncs, calls[0]


#: Phase 22's Prequal run at 10⁴ servers takes the first 5 000 tasks (10
#: blocks of 500) of the 20 000 the other runs there take: the script's
#: time limit.
PREQUAL_SCALE_TASKS = 5000


def head(wl, k: int):
    """The first ``k`` tasks of a workload trace."""
    import dataclasses

    return dataclasses.replace(wl, **{
        f.name: getattr(wl, f.name)[:k] for f in dataclasses.fields(wl)})


def served(torch, wl, cluster, cfg, chunk: int) -> tuple:
    """``serve_workload`` on the card; returns (service, result, wall s,
    launches by kernel), the counts set to 0 just before and read just
    after."""
    from repro_torch.kernels.dodoor_choice import LAUNCHES
    from repro_torch.serve import serve_workload

    LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svc, res = serve_workload(wl, cluster, cfg, chunk=chunk)
    wall = time.perf_counter() - t0
    return svc, res, wall, dict(LAUNCHES)


#: Phase 22's testbed runs (a, d) take the first PROBE_TASKS tasks of
#: phase 3's FunctionBench trace (m = 4 000 before phase 29): the script's
#: time limit (see ``DAG_TASKS``; at 4 000 the phase took 86.8-125.4 s on
#: an H100 80GB HBM3 at 700 W).  The service's checkpoint stays at task
#: 2 000.
PROBE_TASKS = 2400


def probing_phase(torch) -> dict:
    """Phase 22: (a) PoT and Prequal on the batched driver on the testbed,
    each card run against its CPU run (bit for bit) and against the
    sequential oracle on the CPU (ledger and placements exact, time
    planes within SEQ_RTOL / SEQ_ATOL), host syncs a block; (b) the same
    at 10⁴ servers; (c) the fault benchmark's message point in the
    batched driver; (d) the decision service for all five policies on
    the testbed and for dodoor at 10⁴ servers against ``simulate`` on the
    card, and a mid-stream checkpoint resumed."""
    from repro_torch.serve import DecisionService
    from repro_torch.sim import (EngineConfig, RetryPolicy, make_scaled,
                                 make_testbed, random_outages)
    from repro_torch.workloads import azure, functionbench

    out = {}
    tb = make_testbed()
    wl = head(functionbench.synthesize(m=4000, qps=300.0), PROBE_TASKS)
    m = wl.r_submit.shape[0]
    for policy in ("pot", "prequal"):
        cfg = EngineConfig(policy=policy, b=50)
        gpu, wall, counts = batched_run(torch, wl, tb, cfg, "cuda")
        check(not counts, f"batched {policy} launched {counts}")
        cpu, cpu_wall, _ = batched_run(torch, wl, tb, cfg, "cpu")
        exact_check(f"batched {policy} (card vs cpu)", gpu, cpu)
        seq, _ = seq_run(torch, wl, tb, cfg, "cpu")
        bitwise = seq_check(f"batched {policy} vs sequential", gpu, seq, wl,
                            tb, policy)
        syncs = {}
        for k in (100, 300):
            short = functionbench.synthesize(m=k, qps=300.0, seed=3)
            syncs[k] = syncs_and_commits(torch, lambda w=short: batched_run(
                torch, w, tb, cfg, "cuda"))
        (s1, c1), (s3, c3) = syncs[100], syncs[300]
        check(s3 - c3 == s1 - c1, f"batched {policy}: syncs beyond one a "
              f"{'iteration' if policy == 'pot' else 'chunk'} ({s1}/{c1} "
              f"for 100 tasks, {s3}/{c3} for 300)")
        out[f"testbed {policy}"] = m / wall
        print(f"batched {policy}: testbed m={m} b={cfg.b} {m / wall:.1f} "
              f"decisions/s on the card (wall {wall:.3f} s; cpu "
              f"{m / cpu_wall:.1f}/s), bit for bit equal to cpu: True, "
              f"equal to the sequential oracle (ledger, placements): True, "
              f"every time plane bit for bit: {bitwise}; host syncs for 300 "
              f"tasks (6 blocks) {s3} = {c3} "
              f"{'speculative iterations' if policy == 'pot' else 'chunks'}"
              f" + {s3 - c3} a run ({c3 / 6:.1f} a block), ledger "
              f"{ledger(gpu)}", flush=True)

    # (b) 10⁴ servers: phase 4's Azure trace cut to its first 20 000 tasks
    # (Prequal: PREQUAL_SCALE_TASKS).
    cl = make_scaled(10_000)
    big = head(azure.synthesize(m=200_000, qps=400.0), 20_000)
    mb = big.r_submit.shape[0]
    for policy, cut in (("pot", mb), ("prequal", PREQUAL_SCALE_TASKS)):
        wl_p = head(big, cut)
        m_p = wl_p.r_submit.shape[0]
        cfg = EngineConfig(policy=policy, b=500)
        gpu, wall, counts = batched_run(torch, wl_p, cl, cfg, "cuda")
        check(not counts, f"batched {policy} at scale launched {counts}")
        cpu, cpu_wall, _ = batched_run(torch, wl_p, cl, cfg, "cpu")
        exact_check(f"batched {policy} at scale (card vs cpu)", gpu, cpu)
        out[f"scale {policy}"] = m_p / wall
        print(f"batched {policy}: n={cl.num_servers} m={m_p} (cut from "
              f"200 000) b={cfg.b} {m_p / wall:.1f} decisions/s on the card "
              f"(wall {wall:.3f} s; cpu {m_p / cpu_wall:.1f}/s), bit for bit "
              f"equal to cpu, msgs/task {gpu.msgs_per_task:.4f}",
              flush=True)

    # (c) benchmarks/bench_faults.py's message point, mode="batched".
    wlf = functionbench.synthesize(m=3000, qps=60.0, seed=0)
    mf = wlf.r_submit.shape[0]
    H = float(wlf.submit_ms[-1])
    dyn = random_outages(tb.num_servers, 25, 0.6 * H,
                         mean_down_ms=0.15 * H, seed=7)
    totals, means = {}, {}
    for policy in ("dodoor", "pot", "prequal"):
        cfg = EngineConfig(policy=policy, b=50, retry=RetryPolicy())
        runs = []
        for seed in (0, 1):
            res, wall, _ = batched_run(torch, wlf, tb, cfg, "cuda", seed,
                                       dyn)
            runs.append(res.msgs_total)
            print(f"batched message point {policy} seed {seed}: msgs/task "
                  f"{res.msgs_per_task:.6f} (ledger {ledger(res)}), "
                  f"{int(res.attempts.sum()) / wall:.1f} decisions/s (wall "
                  f"{wall:.3f} s)", flush=True)
        totals[policy] = tuple(runs)
        means[policy] = round(float(np.mean([t / mf for t in runs])), 4)
    reduction = {f"vs_{p}": round(1.0 - means["dodoor"] / means[p], 4)
                 for p in ("pot", "prequal")}
    print(json.dumps({"message_reduction_batched": {
        "per_policy_msgs_per_task": means, "reduction": reduction,
        "totals": {p: list(t) for p, t in totals.items()}}}), flush=True)
    check(totals == MESSAGE_TOTALS,
          f"batched message point: totals {totals} != {MESSAGE_TOTALS}")
    check(means == MESSAGE_MEANS and reduction == MESSAGE_REDUCTION,
          f"batched message point: {means}, {reduction}")

    # (d) the streaming decision service against simulate on the card.
    blocks = -(-m // 50)
    for policy in SEQ_POLICIES:
        cfg = EngineConfig(policy=policy, b=50)
        off, _, _ = batched_run(torch, wl, tb, cfg, "cuda")
        kernel = policy in ("dodoor", "one_plus_beta")
        for chunk in (50, 37):
            svc, res, wall, counts = served(torch, wl, tb, cfg, chunk)
            exact_check(f"serve {policy} chunk {chunk}", res, off)
            want = {"dodoor_fused_sparse": blocks} if kernel else {}
            check(counts == want, f"serve {policy}: launches {counts}, "
                  f"want {want}")
            step = svc.step_wall.summary()
            out[f"serve {policy} chunk {chunk}"] = m / wall
            print(f"serve {policy}: testbed m={m} b=50 chunk {chunk} "
                  f"{m / wall:.1f} decisions/s (wall {wall:.3f} s), step "
                  f"p50 {step['p50_ms']} ms p99 {step['p99_ms']} ms, "
                  f"launches {counts.get('dodoor_fused_sparse', 0)}/"
                  f"{blocks} blocks, bit for bit equal to simulate",
                  flush=True)
        if policy in ("dodoor", "prequal"):
            cut = 2000
            a = DecisionService(tb, cfg, capacity=m)
            a.submit_workload(wl, 0, cut)
            a.drain()
            ck = a.export_checkpoint()
            b = DecisionService.from_checkpoint(tb, cfg, ck, capacity=m)
            b.submit_workload(wl, cut, m)
            b.flush()
            exact_check(f"serve {policy} resumed", b.result(), head_of(
                off, cut))
            n1, n3 = (sync_count(torch, lambda k=k: served(
                torch, head(wl, k), tb, cfg, 50)) for k in (100, 300))
            print(f"serve {policy}: checkpoint at {cut} resumed bit for "
                  f"bit; host syncs {n1} for 2 blocks, {n3} for 6 "
                  f"({(n3 - n1) / 4:.1f} a block)", flush=True)
    cfg = EngineConfig(policy="dodoor", b=500)
    off, _, _ = batched_run(torch, big, cl, cfg, "cuda")
    svc, res, wall, counts = served(torch, big, cl, cfg, 500)
    exact_check("serve dodoor at scale", res, off)
    want = {"dodoor_fused_sparse": -(-mb // 500)}
    check(counts == want, f"serve dodoor at scale: {counts}, want {want}")
    step = svc.step_wall.summary()
    out["serve dodoor scale"] = mb / wall
    print(f"serve dodoor: n={cl.num_servers} m={mb} b=500 {mb / wall:.1f} "
          f"decisions/s (wall {wall:.3f} s), step p50 {step['p50_ms']} ms "
          f"p99 {step['p99_ms']} ms, launches "
          f"{counts['dodoor_fused_sparse']}/{-(-mb // 500)} blocks, bit for "
          f"bit equal to simulate", flush=True)
    return out


# --------------------------------------------------------------------------
# phase 23: decision-trace telemetry, cache faults, the grid planners
# --------------------------------------------------------------------------

TRACE_FIELDS = ("view_age_ms", "view_err", "misplaced", "cache_push",
                "sched_id", "decision_ms")


def trace_check(name, got, want) -> None:
    """``got`` equal to ``want`` bit for bit, the six trace planes too."""
    exact_check(name, got, want)
    for f in TRACE_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        check(a is not None and b is not None and np.array_equal(a, b),
              f"{name}: trace plane {f} differs")


def stats_line(res) -> str:
    from repro_torch.obs import decision_stats

    s = decision_stats(res)
    return (f"staleness mean {s['staleness_mean_ms']:.3f} ms p99 "
            f"{s['staleness_p99_ms']:.3f} ms, view err "
            f"{s['view_err_mean']:.4f}, misplacement "
            f"{s['misplacement_rate']:.4f}, pushes {s['cache_pushes']}")


def in_turns(torch, wl, cluster, cfg_a, cfg_b, dynamics=None) -> tuple:
    """``cfg_a`` and ``cfg_b`` on the card in turns (a, b, b, a): returns
    (a's first result, b's first result, b's launches, a's walls, b's
    walls)."""
    runs = [batched_run(torch, wl, cluster, c, "cuda", dynamics=d)
            for c, d in ((cfg_a, None), (cfg_b, dynamics),
                         (cfg_b, dynamics), (cfg_a, None))]
    return (runs[0][0], runs[1][0], runs[1][2],
            (runs[0][1], runs[3][1]), (runs[1][1], runs[2][1]))


def trace_runs(torch) -> dict:
    """Phase 23 (a): traced runs on the card — phase 3's testbed trace for
    dodoor and (1+β) (traced against untraced, and against the CPU's
    traced run; K1 once a block; host syncs traced = untraced), phase 6's
    outage storm (K2), phase 9's map-reduce under γ = 2 (K3), and the
    10⁴-server cut traced and untraced."""
    from repro_torch.kernels.dodoor_choice import LAUNCHES
    from repro_torch.sim import (EngineConfig, LocalityModel, Scenario,
                                 make_scaled, make_testbed, random_outages,
                                 run_scenario, simulate)
    from repro_torch.workloads import (MapReduceDAG, PoissonArrivals, azure,
                                       dag_plan, functionbench)

    out = {}
    tb = make_testbed()
    wl = functionbench.synthesize(m=4000, qps=300.0)
    m = wl.r_submit.shape[0]
    for policy in ("dodoor", "one_plus_beta"):
        cfg = EngineConfig(policy=policy, b=50)
        tcfg = cfg._replace(trace=True)
        plain, traced, counts, w_plain, w_tr = in_turns(torch, wl, tb, cfg,
                                                        tcfg)
        check(counts == {"dodoor_fused_sparse": m // 50},
              f"trace {policy}: launches {counts}, want {m // 50}")
        exact_check(f"trace {policy}: traced vs untraced", traced, plain)
        cpu, _, _ = batched_run(torch, wl, tb, tcfg, "cpu")
        trace_check(f"trace {policy} (card vs cpu)", traced, cpu)
        short = functionbench.synthesize(m=300, qps=300.0, seed=3)
        s_plain, s_tr = (sync_sites(torch, lambda c=c: simulate(
            short, tb, c, device="cuda")) for c in (cfg, tcfg))
        n_plain, n_tr = sum(s_plain.values()), sum(s_tr.values())
        check(n_tr == n_plain, f"trace {policy}: {n_tr} host syncs traced "
              f"{s_tr}, {n_plain} untraced {s_plain}")
        out[f"testbed {policy}"] = (w_plain, w_tr)
        print(f"trace {policy}: testbed m={m} b=50 in turns (untraced, "
              f"traced, traced, untraced): untraced "
              f"{m / w_plain[0]:.1f} / {m / w_plain[1]:.1f}, traced "
              f"{m / w_tr[0]:.1f} / {m / w_tr[1]:.1f} decisions/s "
              f"({sum(w_plain) / sum(w_tr):.3f}x), launches {counts}, bit "
              f"for bit equal to untraced and to cpu; host syncs {n_tr} "
              f"traced = "
              f"{n_plain} untraced (300 tasks); {stats_line(traced)}",
              flush=True)

    # Phase 6's outage storm, traced (K2).
    base = functionbench.synthesize(m=4000, qps=60.0)
    H = float(base.submit_ms[-1])
    storm = Scenario("outage_storm", arrivals=PoissonArrivals(60.0),
                     dynamics=random_outages(tb.num_servers, 20, 0.6 * H,
                                             mean_down_ms=0.2 * H, seed=7))
    tcfg = EngineConfig(policy="dodoor", b=50, trace=True)
    LAUNCHES.clear()
    gpu = run_scenario(base, tb, storm, tcfg, device="cuda")
    counts = dict(LAUNCHES)
    cpu = run_scenario(base, tb, storm, tcfg, device="cpu")
    trace_check("trace outage_storm (card vs cpu)", gpu, cpu)
    check(counts == {"dodoor_fused_sparse_masked": 80},
          f"trace outage_storm: launches {counts}")
    print(f"trace outage_storm: launches {counts}, bit for bit equal to "
          f"cpu; {stats_line(gpu)}", flush=True)

    # Phase 9's map-reduce under γ = 2, traced (K3).
    wl_d = functionbench.synthesize(m=2400, qps=60.0, seed=0)
    spec = MapReduceDAG(mappers=8, reducers=2, edge_delay_ms=0.5,
                        edge_bytes_mb=8.0)
    dcfg = EngineConfig(policy="dodoor", b=50, trace=True,
                        locality=LocalityModel(gamma=2.0))
    gpu, wall, counts = timed_run(torch, wl_d, tb, dcfg, dag=spec)
    cpu = simulate(wl_d, tb, dcfg, device="cpu", dag=spec)
    trace_check("trace mapreduce gamma 2 (card vs cpu)", gpu, cpu)
    blocks = wave_blocks(np.bincount(dag_plan(spec, 2400).level), 50)
    check(counts == {"dodoor_fused_sparse_locality": blocks},
          f"trace mapreduce: launches {counts}, want {blocks}")
    print(f"trace mapreduce gamma 2: m=2400 {2400 / wall:.1f} decisions/s, "
          f"launches {counts}, bit for bit equal to cpu; "
          f"{stats_line(gpu)}", flush=True)

    # The 10⁴-server point: phase 22's 20 000-task Azure cut, b = 500.
    cl = make_scaled(10_000)
    big = head(azure.synthesize(m=200_000, qps=400.0), 20_000)
    mb = big.r_submit.shape[0]
    cfg = EngineConfig(policy="dodoor", b=500)
    plain, traced, counts, w_plain, w_tr = in_turns(
        torch, big, cl, cfg, cfg._replace(trace=True))
    exact_check("trace at scale: traced vs untraced", traced, plain)
    check(counts == {"dodoor_fused_sparse": mb // 500},
          f"trace at scale: launches {counts}")
    out["scale dodoor"] = (w_plain, w_tr)
    print(f"trace at scale: n={cl.num_servers} m={mb} b=500 in turns: "
          f"untraced {mb / w_plain[0]:.1f} / {mb / w_plain[1]:.1f}, traced "
          f"{mb / w_tr[0]:.1f} / {mb / w_tr[1]:.1f} decisions/s "
          f"({sum(w_plain) / sum(w_tr):.3f}x), launches {counts}, bit for "
          f"bit equal to untraced; {stats_line(traced)}", flush=True)
    return out


def fault_runs(torch) -> dict:
    """Phase 23 (b): the fault benchmark's loss point (testbed,
    FunctionBench m = 3000 at 60 qps, loss 0.5, seed 5) with 0 and 25
    outages, dodoor in both modes on the card against the CPU, launching
    no kernel; the service under the same dynamics against ``simulate``
    on the card."""
    from repro_torch.kernels.dodoor_choice import LAUNCHES
    from repro_torch.serve import serve_workload
    from repro_torch.sim import (CacheFaults, Dynamics, EngineConfig,
                                 make_testbed, random_outages, simulate)
    from repro_torch.workloads import functionbench

    out = {}
    tb = make_testbed()
    wl = functionbench.synthesize(m=3000, qps=60.0, seed=0)
    m = wl.r_submit.shape[0]
    H = float(wl.submit_ms[-1])
    lossy = Dynamics(cache_faults=CacheFaults(loss_rate=0.5, seed=5))
    cfg = EngineConfig(policy="dodoor", b=50)
    _, _, counts, w_plain, w_lossy = in_turns(torch, wl, tb, cfg, cfg, lossy)
    out["faults vs unfaulted"] = (w_plain, w_lossy)
    print(f"faults: in turns (unfaulted, loss 0.5, loss 0.5, unfaulted): "
          f"unfaulted {m / w_plain[0]:.1f} / {m / w_plain[1]:.1f}, faulted "
          f"{m / w_lossy[0]:.1f} / {m / w_lossy[1]:.1f} decisions/s "
          f"({sum(w_plain) / sum(w_lossy):.3f}x), faulted launches {counts}",
          flush=True)
    for outages in (0, 25):
        dyn = lossy if not outages else random_outages(
            tb.num_servers, outages, 0.6 * H, mean_down_ms=0.15 * H,
            seed=7).merge(lossy)
        for mode in ("batched", "sequential"):
            LAUNCHES.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gpu = simulate(wl, tb, cfg, mode=mode, device="cuda",
                           dynamics=dyn)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(LAUNCHES)
            check(not counts, f"faults {mode} out{outages}: launched "
                  f"{counts}")
            cpu = simulate(wl, tb, cfg, mode=mode, device="cpu",
                           dynamics=dyn)
            exact_check(f"faults {mode} out{outages} (card vs cpu)", gpu,
                        cpu)
            out[f"{mode} out{outages}"] = m / wall
            print(f"faults {mode} loss 0.5 outages {outages}: m={m} "
                  f"{m / wall:.1f} decisions/s, no launch, bit for bit "
                  f"equal to cpu, msgs/task {gpu.msgs_per_task:.4f}, "
                  f"ledger {ledger(gpu)}", flush=True)
        want = simulate(wl, tb, cfg, device="cuda", dynamics=dyn)
        LAUNCHES.clear()
        svc, got = serve_workload(wl, tb, cfg, dynamics=dyn, chunk=37)
        check(not dict(LAUNCHES), f"faulted service launched "
              f"{dict(LAUNCHES)}")
        exact_check(f"faulted service out{outages} vs simulate", got, want)
        print(f"faults service outages {outages}: bit for bit equal to "
              f"simulate on the card, faulted checkpoint "
              f"{svc.export_checkpoint()['faulted']}", flush=True)
    return out


#: Phase 23 (c)'s trace: FunctionBench m = STUDY_TASKS at 60 qps
#: (bench_study.py's 3 000 before phase 29): the script's time limit (see
#: ``DAG_TASKS``).  Every point is held to its ``run_scenario``, which no
#: trace length changes.
STUDY_TASKS = 1500


def grid_runs(torch) -> dict:
    """Phase 23 (c): ``bench_study.py``'s 18-point grid on the card, each
    point against the card's ``run_scenario`` (walls of both); the
    staleness grid of ``bench_obs.py`` through ``simulate_many`` traced,
    card against CPU; ``server_shards = 4`` against
    ``simulate_hierarchical``; the mean-field check at n = 10³."""
    from repro_torch.kernels.dodoor_choice import LAUNCHES
    from repro_torch.sim import (EngineConfig, Scenario, Study,
                                 make_scaled, make_service_workload,
                                 make_testbed, measured_mean_queue,
                                 pod_mean_queue, random_outages, run_scenario,
                                 run_study, simulate, simulate_hierarchical,
                                 simulate_many, tolerance_band)
    from repro_torch.workloads import (OnOffArrivals, PoissonArrivals,
                                       functionbench)

    out = {}
    tb = make_testbed()
    n, qps = tb.num_servers, 60.0
    base = functionbench.synthesize(m=STUDY_TASKS, qps=qps, seed=0)
    H = float(base.submit_ms[-1])
    # benchmarks/bench_study.py:53-65
    configs = tuple(EngineConfig(policy="dodoor", b=n // 2, alpha=a)
                    for a in (0.3, 0.5, 0.7))
    scens = (Scenario("steady", arrivals=PoissonArrivals(qps)),
             Scenario("bursty_mmpp", arrivals=OnOffArrivals(
                 4.0 * qps, qps / 6.0, mean_on_s=1.0, mean_off_s=3.0)),
             Scenario("outage_storm", arrivals=PoissonArrivals(qps),
                      dynamics=random_outages(n, n // 5, 0.6 * H,
                                              mean_down_ms=0.2 * H, seed=7)))
    seeds = (0, 1)
    LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = run_study(base, tb, Study(seeds=seeds, configs=configs,
                                   scenarios=scens), device="cuda")
    torch.cuda.synchronize()
    w_study = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    t0 = time.perf_counter()
    loop = [run_scenario(base, tb, sc, cfg, sd, device="cuda")
            for sd in seeds for cfg in configs for sc in scens]
    torch.cuda.synchronize()
    w_loop = time.perf_counter() - t0
    it = iter(loop)
    for si in range(len(seeds)):
        for gi in range(len(configs)):
            for ki, sc in enumerate(scens):
                exact_check(f"study point {si},{gi},{sc.name}",
                            st.point(si, gi, ki), next(it))
    blocks = STUDY_TASKS // 50
    want = {"dodoor_fused_sparse": 2 * 3 * 2 * blocks,
            "dodoor_fused_sparse_masked": 2 * 3 * blocks}
    check(counts == want, f"study launches {counts}, want {want}")
    points = len(loop)
    out["study"] = (w_study, w_loop)
    print(f"study: {points} points (bench_study grid, m={STUDY_TASKS}) in "
          f"{w_study:.3f} s, nested run_scenario loop {w_loop:.3f} s "
          f"({w_loop / w_study:.3f}x), {points * STUDY_TASKS / w_study:.1f} "
          f"decisions/s, launches {counts}, every point bit for bit equal "
          f"to run_scenario on the card", flush=True)

    # benchmarks/bench_obs.py's staleness grid: b × α, traced, seed 0.
    for b in (25, 50):
        cfgs = tuple(EngineConfig(policy="dodoor", b=b, alpha=a,
                                  trace=True) for a in (0.5, 1.0))
        gpu = simulate_many(base, tb, cfgs, seeds=(0,), device="cuda")
        cpu = simulate_many(base, tb, cfgs, seeds=(0,), device="cpu")
        for gi, cfg in enumerate(cfgs):
            trace_check(f"simulate_many b={b} alpha={cfg.alpha}",
                        gpu.point(0, gi), cpu.point(0, gi))
            print(f"simulate_many traced b={b} alpha={cfg.alpha}: "
                  f"{stats_line(gpu.point(0, gi))}; bit for bit equal to "
                  f"cpu", flush=True)

    # server_shards = 4 against simulate_hierarchical on the card.
    cfg = EngineConfig(policy="dodoor", b=50)
    sh = run_study(base, tb, Study(seeds=(0,), configs=cfg,
                                   scenarios=Scenario("steady")),
                   server_shards=4, device="cuda").point(0, 0, 0)
    hier = simulate_hierarchical(base, tb, cfg, 4, 0, mode="batched", b=50,
                                 device="cuda")
    exact_check("server_shards=4 vs simulate_hierarchical", sh, hier)
    print("server_shards=4: bit for bit equal to simulate_hierarchical "
          f"on the card, msgs/task {sh.msgs_per_task:.4f}", flush=True)

    # tests/test_meanfield.py:108's validation at n = 10³ (card only).
    cl = make_scaled(1000, het=0.0)
    lam = 0.7
    wl = make_service_workload(cl, lam, 30_000, seed=0)
    H = float(wl.submit_ms[-1])
    pred = pod_mean_queue(lam, d=2)
    for policy in ("pot", "dodoor"):
        cfg = EngineConfig(policy=policy, b=50, interference=0.0,
                           rbuf_slots=64, mem_units=8)
        t0 = time.perf_counter()
        res = simulate(wl, cl, cfg, device="cuda")
        wall = time.perf_counter() - t0
        q = measured_mean_queue(res, 1000, 0.25 * H, 0.95 * H)
        lo, hi = tolerance_band(pred, 1000,
                                b=50 if policy == "dodoor" else None)
        check(lo <= q <= hi, f"mean field {policy}: queue {q} outside "
              f"[{lo}, {hi}]")
        out[f"meanfield {policy}"] = q
        print(f"mean field {policy}: n=1000 lambda=0.7 m=30000 b=50 mean "
              f"queue {q:.4f} in [{lo:.4f}, {hi:.4f}] (JSQ(2) "
              f"{pred:.4f}), {30_000 / wall:.1f} decisions/s", flush=True)
    return out


def observability_phase(torch) -> dict:
    """Phase 23: (a) traced runs, (b) cache faults, (c) the grids."""
    out = trace_runs(torch)
    out.update(fault_runs(torch))
    out.update(grid_runs(torch))
    return out


# --------------------------------------------------------------------------
# phase 24: MoE serving and the serve launcher
# --------------------------------------------------------------------------

#: The MoE models at full width, cut to 2 layers (of 94 / 40): ≈ 24.9 /
#: 31.0 GB of float32 weights from a seed.
MOE_MODELS = ("qwen3-moe-235b-a22b", "dbrx-132b")
MOE_LAYERS = 2
#: K7 at the MoE models' attention shapes: qwen3-moe's prefill (64 heads
#: of 128 over 4 KV heads) and decode over the bf16 cache, dbrx's prefill.
K7_MOE = {"qwen3-moe-235b-a22b": (4, 64, 4, 1024, 1024, 128, True, None),
          "dbrx-132b": (4, 48, 8, 1024, 1024, 128, True, None)}
K7_MOE_CACHE = (4, 64, 4, 160, 128, 160)
#: The 1-layer copy, card against CPU, on 1 × 2100 tokens (a full group
#: of 2048 and a mostly padded one): at most this share of (token, choice)
#: routes may differ (near-ties of the router's softmax, summed in another
#: order); logits on the tokens whose routes agree within CPU_COPY_TOL of
#: the largest |logit|; moe_aux within MOE_AUX_RTOL, widened only by what
#: the differing routes can move it.
MOE_COPY_TOKENS = 2100
MOE_ROUTE_SHARE = 1e-3
MOE_AUX_RTOL = 1e-5
#: The launcher's call: four policy rows and eight placements, then the
#: smoke model's 16 greedy tokens.
SERVE_ARCH = "qwen3-moe-235b-a22b"
SERVE_ARGV = ["--arch", SERVE_ARCH, "--requests", "400", "--decode-demo"]
SERVE_DEMO_STEPS = 16


def moe_recorded(fn):
    """``fn()`` with every MoE group's routing recorded, in call order
    (layer-major, group-minor): (experts [g, k] sorted in each row, kept
    [g, k] in the same order, choices per expert [E], mean gate
    probabilities [E]).  The groups run ``moe_group_apply`` as in any
    forward; the routes are read again from the same inputs."""
    from repro_torch.models import transformer as tf

    apply_group = tf.moe_group_apply
    rec = []

    def recording(p, x, cfg, load):
        probs, idx, _ = tf.moe_route(p, x, cfg, load)
        pos, counts = tf.moe_queue(idx, cfg.n_experts)
        keep = pos < tf._capacity(x.shape[0], cfg)
        order = idx.argsort(dim=1)
        rec.append((idx.gather(1, order), keep.gather(1, order), counts,
                    probs.mean(0)))
        return apply_group(p, x, cfg, load)

    tf.moe_group_apply = recording
    try:
        out = fn()
    finally:
        tf.moe_group_apply = apply_group
    return out, rec


def route_stats(rec) -> str:
    """Tokens per expert (the largest over the mean, worst group) and the
    dropped share of the choices, over every layer and group."""
    worst = max(float(c.max() / c.mean()) for _, _, c, _ in rec)
    kept = sum(int(k.sum()) for _, k, _, _ in rec)
    total = sum(k.numel() for _, k, _, _ in rec)
    return (f"tokens per expert max/mean {worst:.3f} (worst group), dropped "
            f"{1 - kept / total:.4f} of {total} choices")


def moe_forward(torch, name, cfg, params, tokens) -> tuple:
    """One ``forward`` on the card, timed, with the launches set to 0
    just before and read just after (one K7 launch a layer), then a
    recorded run for the route statistics.  Returns (K7 launches, ms)."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import registry

    B, L = tokens.shape
    LAUNCHES.clear()
    t0 = time.perf_counter()
    logits, aux = registry.forward(cfg, params, {"tokens": tokens})
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = dict(LAUNCHES)
    check(counts == {"flash_attention": cfg.n_layers}, f"{name} "
          f"{cfg.router} forward: launches {counts}")
    check(tuple(logits.shape) == (B, L, cfg.vocab) and
          bool(logits.isfinite().all()), f"{name} {cfg.router} forward: "
          f"logits {tuple(logits.shape)} not finite or of the wrong shape")
    moe_aux = float(aux["moe_aux"])
    del logits
    _, rec = moe_recorded(lambda: registry.forward(cfg, params,
                                                   {"tokens": tokens}))
    print(f"moe {name} router={cfg.router}: forward B={B} L={L} "
          f"{ms:.1f} ms, {B * L / ms * 1e3:.1f} prefill tokens/s, moe_aux "
          f"{moe_aux:.6f}, launches {counts}; {route_stats(rec)}",
          flush=True)
    return counts["flash_attention"], ms


def moe_decode(torch, name, cfg, params) -> int:
    """Four 128-token prompts through ``decode_step`` (the default bf16
    cache), then 32 greedy tokens: finite logits, one K7 launch a
    layer-step, ms a step.  Returns the K7 launches."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import registry

    n_req, n_prompt, n_gen = 4, 128, 32
    prompts = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab, (n_req, n_prompt))).cuda()
    cache = registry.init_cache(cfg, n_req, n_prompt + n_gen, device="cuda")
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    for t in range(n_prompt):
        lg, cache = registry.decode_step(cfg, params, cache,
                                         prompts[:, t:t + 1])
        finite &= lg.isfinite().all()
    torch.cuda.synchronize()
    prompt_ms = (time.perf_counter() - t0) * 1e3 / n_prompt
    nxt = lg[:, -1].argmax(-1, keepdim=True)
    t0 = time.perf_counter()
    for _ in range(n_gen):
        lg, cache = registry.decode_step(cfg, params, cache, nxt)
        finite &= lg.isfinite().all()
        nxt = lg[:, -1].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t0) * 1e3 / n_gen
    counts = dict(LAUNCHES)
    want = {"flash_attention": cfg.n_layers * (n_prompt + n_gen)}
    check(counts == want, f"{name} decode: launches {counts}, want {want}")
    check(bool(finite), f"{name} decode: non-finite logits")
    print(f"moe {name} decode of {n_req} requests ({cache['k'].dtype} "
          f"cache): {n_prompt} prompt steps {prompt_ms:.2f} ms a step, "
          f"{n_gen} greedy steps {gen_ms:.2f} ms a step, "
          f"{n_req / gen_ms * 1e3:.1f} decode tokens/s, launches {counts}",
          flush=True)
    return counts["flash_attention"]


def moe_cpu_copy(torch, name, cfg, params) -> None:
    """A 1-layer copy with the same weights, card against CPU, on 1 ×
    ``MOE_COPY_TOKENS`` tokens, for each router."""
    from dataclasses import replace

    from repro_torch.models import registry
    from repro_torch.models.common import tree_map

    p1 = dict(params, layers=tree_map(lambda a: a[:1], params["layers"]))
    t0 = time.perf_counter()
    cpu_p = tree_map(lambda a: a.cpu(), p1)
    copy_s = time.perf_counter() - t0
    tokens = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab, (1, MOE_COPY_TOKENS)))
    for router in ("topk", "dodoor"):
        cfg1 = replace(cfg, n_layers=1, router=router)
        (gpu, gaux), grec = moe_recorded(lambda: registry.forward(
            cfg1, p1, {"tokens": tokens.cuda()}))
        t0 = time.perf_counter()
        (cpu, caux), crec = moe_recorded(lambda: registry.forward(
            cfg1, cpu_p, {"tokens": tokens}))
        cpu_s = time.perf_counter() - t0
        T = MOE_COPY_TOKENS
        g_idx, g_keep = (torch.cat([r[i].cpu() for r in grec])[:T]
                         for i in (0, 1))
        c_idx, c_keep = (torch.cat([r[i] for r in crec])[:T]
                         for i in (0, 1))
        diff = (g_idx != c_idx) | (g_keep != c_keep)       # [T, k]
        share = float(diff.float().mean())
        agree = ~diff.any(dim=1)
        check(share <= MOE_ROUTE_SHARE, f"{name} {router} 1-layer copy: "
              f"{share:.4g} of the routes differ (bound {MOE_ROUTE_SHARE})")
        gpu = gpu.cpu()
        check(bool(gpu.isfinite().all()), f"{name} {router} 1-layer copy: "
              "non-finite logits on the card")
        scale = float(cpu.abs().max())
        err = float((gpu[0, agree] - cpu[0, agree]).abs().max())
        check(err <= CPU_COPY_TOL * scale, f"{name} {router} 1-layer copy: "
              f"card and CPU differ by {err:.3g} on the tokens whose routes "
              f"agree (max |logit| {scale:.3g}, bound {CPU_COPY_TOL} of it)")
        # A differing choice moves two experts' f by 1/g in its group:
        # aux (the mean over groups of E·Σ f·P) by at most 2E/g·max P.
        g = min(2048, T)
        max_p = max(float(r[3].max()) for r in crec)
        n_diff = int(diff.sum())
        ga, ca = float(gaux["moe_aux"]), float(caux["moe_aux"])
        aux_tol = MOE_AUX_RTOL * abs(ca) + n_diff * 2 * cfg.n_experts / g \
            * max_p / len(crec)
        check(abs(ga - ca) <= aux_tol, f"{name} {router} 1-layer copy: "
              f"moe_aux {ga!r} on the card, {ca!r} on the CPU (bound "
              f"{aux_tol:.3g})")
        print(f"moe {name} router={router} 1-layer copy card vs CPU on "
              f"{T} tokens: {n_diff} of {diff.numel()} routes differ "
              f"({share:.3g}), {int(agree.sum())} tokens agree; logits max "
              f"|Δ| {err:.3g} of {scale:.3g} ({err / scale:.3g}); moe_aux "
              f"{ga:.7f} / {ca:.7f} (rel {abs(ga - ca) / abs(ca):.3g}); CPU "
              f"run {cpu_s:.1f} s (copy {copy_s:.1f} s)", flush=True)


def moe_model(torch, name: str, decode: bool) -> tuple:
    """One MoE model at full width, ``MOE_LAYERS`` layers, weights from a
    seed: K7 at its attention shapes, ``forward`` on 4 × 1024 tokens (two
    2048-token groups) with the published ``topk`` router and with
    ``dodoor`` on the same weights, and with ``decode`` the decode run and
    the 1-layer card-against-CPU copy.  Returns (K7 launches, K7 rows)."""
    from dataclasses import replace

    from repro_torch.configs import ARCHS
    from repro_torch.models import registry

    cfg = replace(ARCHS[name], n_layers=MOE_LAYERS)
    rows = [k7_case(torch, *K7_MOE[name], timed=True)]
    if decode:
        rows.append(k7_cache_case(torch, *K7_MOE_CACHE))
    t0 = time.perf_counter()
    params = registry.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"moe {name}: {cfg.n_layers} of {ARCHS[name].n_layers} layers, "
          f"d={cfg.d_model}, {cfg.n_experts} experts top-{cfg.top_k}, "
          f"moe_d_ff={cfg.moe_d_ff}, vocab={cfg.vocab}: "
          f"{cfg.param_count() * 4 / 1e9:.2f} GB of float32 weights, init "
          f"{init_s:.2f} s", flush=True)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (4, 1024))).cuda()
    registry.forward(cfg, params, {"tokens": tokens[:1, :64]})  # warm-up
    launches = 0
    for router in ("topk", "dodoor"):
        n, _ = moe_forward(torch, name, replace(cfg, router=router), params,
                           tokens)
        launches += n
    if decode:
        launches += moe_decode(torch, name, cfg, params)
        moe_cpu_copy(torch, name, cfg, params)
    del params, tokens
    torch.cuda.empty_cache()
    return launches, rows


def launcher_lines(argv) -> list:
    """``repro_torch.launch.serve.main(argv)``'s printed lines."""
    import contextlib
    import io

    from repro_torch.launch import serve

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(argv)
    return buf.getvalue().splitlines()


def launcher_run(torch) -> int:
    """The serve launcher on the card (K7 launched once a layer-step of
    the decode demo, counted), against the same call on the CPU: the
    fleet line, the four policy rows and the eight placements equal; the
    demo's 16 tokens in the smoke vocabulary on both.  Returns the K7
    launches."""
    import ast

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import LAUNCHES

    LAUNCHES.clear()
    t0 = time.perf_counter()
    card = launcher_lines(SERVE_ARGV)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    smoke = ARCHS[SERVE_ARCH].smoke()
    want = {"flash_attention": smoke.n_layers * SERVE_DEMO_STEPS}
    check(counts == want, f"launcher: launches {counts}, want {want}")
    t0 = time.perf_counter()
    cpu = launcher_lines(SERVE_ARGV + ["--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    check(len(card) == 14 and len(cpu) == 14, f"launcher: {len(card)} / "
          f"{len(cpu)} lines, want 14")
    check(card[:13] == cpu[:13], "launcher: the card's rows differ from "
          "the CPU's:\n" + "\n".join(card[:13] + cpu[:13]))
    head = "greedy decode (smoke model): "
    for side, lines in (("card", card), ("cpu", cpu)):
        check(lines[13].startswith(head), f"launcher {side}: {lines[13]}")
        toks = ast.literal_eval(lines[13][len(head):])
        check(len(toks) == SERVE_DEMO_STEPS and all(
            isinstance(t, int) and 0 <= t < smoke.vocab for t in toks),
            f"launcher {side}: decode tokens {toks}")
    for line in card:
        print(f"launcher: {line}", flush=True)
    print(f"launcher: card {card_s:.1f} s, cpu {cpu_s:.1f} s, the rows and "
          f"placements equal, launches {counts}", flush=True)
    return counts["flash_attention"]


def moe_phase(torch) -> tuple:
    """Phase 24: qwen3-moe-235b-a22b (forward, decode, the 1-layer copy),
    then dbrx-132b (forward), then the launcher.  Returns (K7 launches,
    K7 rows at the MoE shapes)."""
    no_tf32(torch)
    launches, rows = moe_model(torch, MOE_MODELS[0], decode=True)
    n, more = moe_model(torch, MOE_MODELS[1], decode=False)
    return launches + n + launcher_run(torch), rows + more


# --------------------------------------------------------------------------
# phase 25: the VLM backbone, the RG-LRU hybrid and Whisper
# --------------------------------------------------------------------------

#: K7 at recurrentgemma-2b's local attention (10 heads of 256 over one KV
#: head): its prefill on 2 × 4096 tokens under the 2048-token window, and
#: a decode step over the full ring of 2048 slots (float32 and over the
#: bf16 ring read in place, the step's own key and value as the last row).
K7_RG_PREFILL = (2, 10, 1, 4096, 4096, 256, True, 2048)
K7_RG_DECODE = (2, 10, 1, 1, 2048, 256, True, None)
K7_RG_CACHE = (2, 10, 1, 2048, 256, 2048)
#: qwen2-vl-2b's forward: B × L positions, the first VLM_PATCHES of them
#: patch embeddings from a seed on a VLM_GRID × VLM_GRID grid.
VLM_FORWARD = (4, 1024)
VLM_PATCHES = 256
VLM_GRID = 16
#: recurrentgemma-2b's forward (the 2048 window cuts keys).
RG_FORWARD = (2, 4096)
#: whisper-base's forward: B × 448 tokens over the 1500 encoder frames.
WHISPER_FORWARD = (4, 448)


def families_phase(torch) -> tuple:
    """Phase 25: K7 at head width 256 (recurrentgemma-2b's prefill and
    decode, timed), then qwen2-vl-2b, recurrentgemma-2b and whisper-base
    at full width and depth.  Returns (K7 launches, K7 rows at D = 256)."""
    no_tf32(torch)
    rows = [k7_case(torch, *K7_RG_PREFILL, timed=True),
            k7_case(torch, *K7_RG_DECODE, timed=True),
            k7_cache_case(torch, *K7_RG_CACHE)]
    launches = sum(serving_phase(torch, name, "flash_attention", *shape)
                   for name, shape in (("qwen2-vl-2b", VLM_FORWARD),
                                       ("recurrentgemma-2b", RG_FORWARD),
                                       ("whisper-base", WHISPER_FORWARD)))
    return launches, rows


# --------------------------------------------------------------------------
# phase 26: training (K7's backward, tinyllama-1.1b, the train launcher)
# --------------------------------------------------------------------------

#: K7's backward against ``attention_bwd_ref``: (B, H, Hkv, Lq, Lk, D,
#: causal, window) — the reference's GQA pin, Lq < Lk (24/56), window 16,
#: non-causal D = 128, ragged 100-row tiles, D = 32 / 64 / 128, a group of
#: 16 rows (the split kernel's regime without grad), D = 128 causal with a
#: window, then timed at tinyllama-1.1b's prefill and at qwen3-moe's (D =
#: 128).
K7_BWD_CASES = [
    (2, 4, 2, 128, 128, 64, True, None),
    (1, 4, 1, 24, 56, 32, True, None),
    (1, 2, 2, 128, 256, 64, True, 16),
    (1, 2, 2, 64, 64, 128, False, None),
    (1, 4, 2, 100, 100, 32, True, None),
    (2, 8, 2, 100, 300, 128, False, 40),
    (1, 8, 1, 150, 260, 32, True, 30),      # two runs of rows (dk/dv)
    (2, 8, 2, 4, 40, 64, True, None),       # 16 rows a group
    (1, 4, 2, 130, 200, 128, True, 48),
]
K7_BWD_TIMED = [(4, 32, 4, 1024, 1024, 64, True, None),
                (4, 64, 4, 1024, 1024, 128, True, None)]
#: |Δ| ≤ rtol·|ref| + atol·max|ref| for each of dq, dk, dv: float32 sums
#: of up to a few thousand products in another order than the plain
#: version's einsums.
K7_BWD_RTOL, K7_BWD_ATOL_OF_MAX = 2e-4, 2e-5
#: The forward's lse against ``attention_lse_ref``, in log2 units: 1e-5
#: of a logit's scale moves P by under 1e-5 relative.
K7_LSE_TOL = dict(rtol=1e-5, atol=1e-5)
#: The bias of K7's forward output (``k7_bias_rows``: the mean signed error
#: along the exact value's sign over the mean |exact|, against float64
#: attention on the card), (B, H, Hkv, Lq, Lk, D, causal, window):
#: whisper-base's cross-attention (64 queries over 1 500 frames),
#: tinyllama-1.1b's and recurrentgemma-2b's causal prefills.  The backward
#: takes Δ = rowsum(dO ∘ o) from this output, and a bias of o does not
#: cancel in dQ.  ``K7_BIAS_MAX`` bounds |bias| shape by shape: a tenth of
#: what a running tensor-core accumulator over every key tile gave (−9.07e-6,
#: −2.11e-6 and −7.03e-6 of |o| on an H100 80GB HBM3 at 700 W,
#: ``tools/k7_output_bias.py``), while the plain float32 version gives
#: −6e-9 to −1e-10.
K7_BIAS_SHAPES = [(1, 8, 8, 64, 1500, 64, False, None),
                  (4, 32, 4, 1024, 1024, 64, True, None),
                  (2, 10, 1, 4096, 4096, 256, True, 2048)]
K7_BIAS_MAX = (9.07e-7, 2.1e-7, 7.0e-7)
#: (b): tinyllama-1.1b at full width and depth, B × L tokens a step.
TRAIN_ARCH = "tinyllama-1.1b"
TRAIN_BATCH = (4, 1024)
TRAIN_STEPS = 8
#: (c): the 2-layer copy, card against CPU.
TRAIN_COPY = (2, 256)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_OF_MAX = 1e-4
#: (d): the launcher's call, run twice, on smollm-135m at full width
#: (d 576, vocab 49152) cut to LAUNCH_LAYERS of its 30 layers: its
#: checkpoints (1.6 GB of float32 parameters and moments at 30 layers)
#: took 2.4 s to write and 4.3 s to read back on the card's machine, and
#: with them phase 26 ran 77.5 s against the 60 s it may take.
LAUNCH_ARCH = "smollm-135m"
LAUNCH_LAYERS = 10
LAUNCH_ARGV = ["--arch", LAUNCH_ARCH, "--steps", "30", "--batch", "8",
               "--seq", "256", "--ckpt-every", "10", "--fail-at", "15:4",
               "--log-every", "100"]
#: (e): argmax agreement of the bf16 forward with the float32 one, and
#: |Δlogit| against the largest float32 |logit| (the bound
#: tests/test_torch_precision.py holds on the CPU).
BF16_ARGMAX_SHARE = 0.9
BF16_LOGIT_OF_MAX = 2e-2


def signed_error(got, want) -> tuple:
    """(max |got − want| / max |want|, the mean signed error along want's
    sign over the mean |want|: negative when got is shrunk towards zero),
    computed in float64."""
    d = got.double() - want
    return (float(d.abs().max() / want.abs().max()),
            float((d * want.sign()).mean() / want.abs().mean()))


def k7_exact(torch, q, k, v, causal, window, scale):
    """Attention in float64 on q's device, a head at a time, GQA by
    repeating k and v."""
    rep = q.shape[1] // k.shape[1]
    Lq, Lk = q.shape[2], k.shape[2]
    qpos = torch.arange(Lq, device=q.device)[:, None] + (Lk - Lq)
    kpos = torch.arange(Lk, device=q.device)[None, :]
    mask = torch.ones((Lq, Lk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    for h in range(q.shape[1]):
        s = torch.matmul(q[:, h].double(), k[:, h // rep].double()
                         .transpose(1, 2)) * scale
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out[:, h] = torch.matmul(p, v[:, h // rep].double())
        del s, p
    return out


def k7_bias_inputs(torch, B, H, Hkv, Lq, Lk, D):
    """q, k, v, dO for ``K7_BIAS_SHAPES`` from a seed, on the card."""
    rng = np.random.RandomState(Lq + Lk + D)
    return [torch.from_numpy(rng.randn(*s).astype(np.float32) * sc).cuda()
            for s, sc in (((B, H, Lq, D), 0.5), ((B, Hkv, Lk, D), 0.5),
                          ((B, Hkv, Lk, D), 1.0), ((B, H, Lq, D), 1.0))]


def k7_bias_rows(torch, shapes=K7_BIAS_SHAPES) -> list:
    """For each shape, K7's forward output (``flash_attention``; the grad
    forward's equals it bit for bit) and the plain version's
    (``attention_ref``, float32 on the card) against float64 attention:
    ``signed_error`` of o and of Δ = rowsum(dO ∘ o)."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)

    rows = []
    for B, H, Hkv, Lq, Lk, D, causal, window in shapes:
        q, k, v, do = k7_bias_inputs(torch, B, H, Hkv, Lq, Lk, D)
        want = k7_exact(torch, q, k, v, causal, window, D ** -0.5)
        delta = (do.double() * want).sum(-1)
        row = {"shape": [B, H, Hkv, Lq, Lk, D], "causal": causal,
               "window": window}
        with torch.no_grad():
            for name, o in (("k7", flash_attention(q, k, v, causal=causal,
                                                   window=window)),
                            ("plain", attention_ref(q, k, v, causal=causal,
                                                    window=window))):
                row[name] = {"o": signed_error(o, want),
                             "delta": signed_error((do * o).sum(-1), delta)}
        rows.append(row)
        del q, k, v, do, want, delta
        torch.cuda.empty_cache()
    return rows


def k7_bias_check(torch) -> None:
    """F7's gate: |bias of K7's o| ≤ ``K7_BIAS_MAX`` at each of
    ``K7_BIAS_SHAPES``."""
    for row, limit in zip(k7_bias_rows(torch), K7_BIAS_MAX):
        bias = row["k7"]["o"][1]
        print(f"bias flash_attention {row['shape']} causal={row['causal']} "
              f"window={row['window']}: o {bias:.3g} of |o| (limit "
              f"{limit:.3g}; plain {row['plain']['o'][1]:.3g}), Δ "
              f"{row['k7']['delta'][1]:.3g} (plain "
              f"{row['plain']['delta'][1]:.3g}); max |Δo| "
              f"{row['k7']['o'][0]:.3g} of max |o|", flush=True)
        check(abs(bias) <= limit, f"flash_attention {row['shape']}: the "
              f"output's mean signed error {bias:.3g} of |o| exceeds "
              f"{limit:.3g} (F7)")


def k7_bwd_inputs(torch, B, H, Hkv, Lq, Lk, D):
    rng = np.random.RandomState(B + H + Lq + Lk + D)
    return [torch.from_numpy(rng.randn(*s).astype(np.float32) * sc).cuda()
            for s, sc in (((B, H, Lq, D), 0.5), ((B, Hkv, Lk, D), 0.5),
                          ((B, Hkv, Lk, D), 1.0), ((B, H, Lq, D), 1.0))]


def k7_bwd_case(torch, B, H, Hkv, Lq, Lk, D, causal, window,
                timed: bool = False):
    """K7's backward through autograd (``flash_attention`` then
    ``backward``: one forward, which writes the lse, and one backward
    launch) and through its wrapper (given no lse), against
    ``attention_bwd_ref`` on the card; the forward's lse
    (``flash_attention_lse``) against ``attention_lse_ref``, and its
    output equal to the forward without lse (bit for bit where both take
    the tensor-core kernel, more than 16 rows a group; else within
    ``K7_F32_TOL``).  With ``timed`` also two calls bit for bit, and the
    backward given the forward's lse and output (what a train step pays),
    the plain version and SDPA's backward (``torch.autograd.grad`` on a
    retained graph) timed.  Returns a kernels-line row (timed) or
    None."""
    import torch.nn.functional as F

    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention import (
        attention_bwd_ref, attention_lse_ref, flash_attention,
        flash_attention_bwd, flash_attention_lse)
    from repro_torch.kernels.flash_attention.ops import K7_SPLIT_ROWS

    q, k, v, do = k7_bwd_inputs(torch, B, H, Hkv, Lq, Lk, D)
    want = attention_bwd_ref(q, k, v, do, causal=causal, window=window)
    shape = (f"B={B} H={H} Hkv={Hkv} Lq={Lq} Lk={Lk} D={D} causal={causal} "
             f"window={window}")
    o_l, lse = flash_attention_lse(q, k, v, causal=causal, window=window)
    lse_err = close(f"flash_attention lse {shape}", lse,
                    attention_lse_ref(q, k, causal=causal, window=window),
                    **K7_LSE_TOL)
    o_n = flash_attention(q, k, v, causal=causal, window=window)
    if (H // Hkv) * Lq > K7_SPLIT_ROWS:
        check(torch.equal(o_l, o_n), f"flash_attention {shape}: o with "
              f"and without the lse differ")
    else:
        close(f"flash_attention {shape} o with the lse", o_l, o_n,
              **K7_F32_TOL)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    LAUNCHES.clear()
    o = flash_attention(qg, kg, vg, causal=causal, window=window)
    o.backward(do)
    torch.cuda.synchronize()
    check(dict(LAUNCHES) == {"flash_attention": 1, "flash_attention_bwd": 1},
          f"flash_attention backward: launches {dict(LAUNCHES)}")
    err = 0.0
    o = o.detach()
    check(torch.equal(o, o_l), f"flash_attention {shape}: the grad "
          f"forward's o differs from flash_attention_lse's")
    got = flash_attention_bwd(q, k, v, do, causal=causal, window=window)
    for name, a, b, w in zip(("dq", "dk", "dv"), (qg.grad, kg.grad, vg.grad),
                             got, want):
        atol = K7_BWD_ATOL_OF_MAX * float(w.abs().max())
        err = max(err, close(f"flash_attention_bwd {shape} {name}", b, w,
                             rtol=K7_BWD_RTOL, atol=atol))
        check(torch.equal(a, b), f"flash_attention_bwd {shape} {name}: "
              f"autograd and the wrapper differ")
    if not timed:
        print(f"kernel flash_attention_bwd {shape}: max |Δ| {err:.3g} "
              f"(within rtol {K7_BWD_RTOL} + {K7_BWD_ATOL_OF_MAX} of max); "
              f"lse max |Δ| {lse_err:.3g}", flush=True)
        return None
    again = flash_attention_bwd(q, k, v, do, causal=causal, window=window,
                                lse=lse, o=o_l)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"flash_attention_bwd {shape}: two calls differ")
    ms = event_ms(torch, lambda: flash_attention_bwd(
        q, k, v, do, causal=causal, window=window, lse=lse, o=o_l), reps=20)
    plain_ms = event_ms(torch, lambda: attention_bwd_ref(
        q, k, v, do, causal=causal, window=window), reps=10, warmup=2)
    qpos = np.arange(Lq)[:, None] + (Lk - Lq)
    kpos = np.arange(Lk)[None, :]
    mask = np.ones((Lq, Lk), bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    lib_ms = None
    if causal and Lq == Lk:
        # A window goes to SDPA as a boolean mask (True: attend).
        kw = (dict(is_causal=True) if window is None else
              dict(attn_mask=torch.from_numpy(mask).cuda()))
        qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
        os_ = F.scaled_dot_product_attention(qs, ks, vs, enable_gqa=True,
                                             **kw)
        lib_ms = event_ms(torch, lambda: torch.autograd.grad(
            os_, (qs, ks, vs), do, retain_graph=True), reps=20)
        del os_
    pairs = int(mask.sum())
    # q, o, dO read and dq written; k, v read and dk, dv written; 10·D
    # flops an unmasked pair (q·k, dO·v, P·dO, dS·k, dS·q).  The card's
    # fastest float32-accurate product is three TF32 MMAs (lo·hi, hi·lo,
    # hi·hi), as K7's forward and backward run it (``k7_ops``), so the
    # bound counts 3 terms a product at the TF32 rate; the bound on the
    # CUDA cores' float32 rate is printed beside it.
    nbytes = 4 * (4 * B * H * Lq + 4 * B * Hkv * Lk) * D
    flops = 10 * D * B * H * pairs
    row = row_of("flash_attention_bwd", B * H, Lk, ms, plain_ms, nbytes,
                 3 * flops, err, library_ms=lib_ms, op_rate=TF32_OPS_PER_S,
                 Lq=Lq, D=D, rep=H // Hkv)
    # 14·D a pair executed (the dk/dv pass's four products, the dq pass's
    # three), three TF32 products each.
    executed = 14 * 3 * flops / 10
    print(f"kernel flash_attention_bwd {shape}: {flops / ms / 1e9:.2f} T "
          f"op/s (10·D an unmasked pair), {executed / ms / 1e9:.2f} T op/s "
          f"TF32 executed (14·D, three products each); "
          f"{row['bound_ms'] / ms:.4f} of the 3xTF32 bound; bound on the CUDA "
          f"cores {flops / FP32_OPS_PER_S * 1e6:.3f} us; given the "
          f"forward's lse; two calls bit for bit", flush=True)
    return row


def k7_bwd_refusals(torch) -> None:
    """What the card cannot differentiate raises before any launch: a
    bf16 call at head width 256 (the bf16 backward is built for 32-128,
    phase 29) and ``kv_last`` under grad (head width 256 in float32 and
    K8 have backwards since phase 27's kernels, which it checks)."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention import flash_attention

    def refused(name, fn):
        LAUNCHES.clear()
        try:
            fn()
        except NotImplementedError as e:
            check(not LAUNCHES, f"{name}: launched {dict(LAUNCHES)} before "
                  f"refusing")
            print(f"refused {name}: {e}", flush=True)
            return
        raise RuntimeError(f"chip_smoke: {name} did not raise")

    def attn(D, dtype, last=False):
        q, k, v, _ = k7_bwd_inputs(torch, 1, 2, 1, 8, 8, D)
        q, k, v = (t.to(dtype) for t in (q, k, v))
        kv = (k[:, :, -1:].clone(), v[:, :, -1:].clone()) if last else None
        return lambda: flash_attention(q.requires_grad_(True), k, v,
                                       kv_last=kv)

    refused("bf16 backward at head width 256", attn(256, torch.bfloat16))
    refused("kv_last with grad", attn(64, torch.float32, last=True))


def train_run(torch, cfg, holder: dict, shape=None, want=None) -> dict:
    """(b): ``TRAIN_STEPS`` steps of ``make_train_step`` (remat on, lr 1e-3
    on the cosine schedule) on ``SyntheticLM`` batches of ``shape`` (B, L)
    (``TRAIN_BATCH``), the launches set to 0 just before and read just
    after and held to ``want`` (the dense family's by default).  The
    initial parameters come in ``holder["params"]``, which is emptied, so
    that each step's old state is freed and the peak memory is the loop's
    own."""
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import LAUNCHES
    from repro_torch.optim import adamw_init, cosine_schedule
    from repro_torch.train import make_train_step

    B, L = shape or TRAIN_BATCH
    params = holder.pop("params")
    data = SyntheticLM(cfg.vocab, L, B, seed=0, device="cuda")
    step_fn = make_train_step(cfg, lr=cosine_schedule(
        1e-3, warmup=5, total=TRAIN_STEPS), remat=True)
    opt = adamw_init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    losses, walls = [], []
    for step in range(TRAIN_STEPS):
        batch = data.batch(step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        walls.append(time.perf_counter() - t0)
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = want or {"flash_attention": 2 * cfg.n_layers * TRAIN_STEPS,
                    "flash_attention_bwd": cfg.n_layers * TRAIN_STEPS}
    check(counts == want, f"training {cfg.name}: launches {counts}, want "
          f"{want}")
    check(all(np.isfinite(losses)), f"training: losses {losses}")
    check(losses[-1] < losses[0], f"training: loss {losses[0]} → "
          f"{losses[-1]} did not fall")
    ms = 1e3 * float(np.median(walls[1:]))
    print(f"train {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"batch {B} x {L}, {TRAIN_STEPS} steps (remat): losses "
          f"{[round(x, 4) for x in losses]}; {ms:.1f} ms a step (median of "
          f"steps 1-{TRAIN_STEPS - 1}; first {walls[0] * 1e3:.1f} ms), "
          f"{B * L / ms * 1e3:.1f} tokens/s, peak memory "
          f"{peak / 1e9:.2f} GB, launches {counts}", flush=True)
    return {"params": params, "counts": counts, "ms": ms, "peak": peak,
            "cfg": cfg, "shape": (B, L), "state": state_shapes((params, opt))}


def state_shapes(tree) -> dict:
    """{path: (shape, dtype)} of a tree of tensors (meta ones included)."""
    from repro_torch.sharding import leaves_with_paths

    return {path: (tuple(x.shape), x.dtype)
            for path, x in leaves_with_paths(tree)}


def train_copy(torch, cfg, params) -> None:
    """(c): a 2-layer copy of the weights, one step's loss and gradients
    (``loss_and_grads``) on the card against the CPU."""
    from dataclasses import replace

    from repro_torch.data import SyntheticLM
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.train import loss_and_grads

    cfg2 = replace(cfg, n_layers=2)
    p2 = dict(params, layers=tree_map(lambda a: a[:2].clone(),
                                      params["layers"]))
    B, L = TRAIN_COPY
    batch = SyntheticLM(cfg.vocab, L, B, seed=5, device="cuda").batch(0)
    total, ce, g_card = loss_and_grads(cfg2, p2, batch)
    t0 = time.perf_counter()
    cpu_total, cpu_ce, g_cpu = loss_and_grads(
        cfg2, tree_map(lambda a: a.cpu(), p2),
        {k: v.cpu() for k, v in batch.items()})
    cpu_s = time.perf_counter() - t0
    rel = abs(float(ce) - float(cpu_ce)) / abs(float(cpu_ce))
    check(rel <= TRAIN_LOSS_RTOL, f"train copy: loss {float(ce)!r} on the "
          f"card, {float(cpu_ce)!r} on the CPU (rel {rel:.3g})")
    worst = 0.0
    for a, b in zip(tree_leaves(g_card), tree_leaves(g_cpu)):
        scale = float(b.abs().max())
        err = float((a.cpu() - b).abs().max())
        check(err <= TRAIN_GRAD_OF_MAX * scale, f"train copy: a gradient "
              f"leaf {tuple(b.shape)} differs by {err:.3g} (max {scale:.3g})")
        worst = max(worst, err / max(scale, 1e-30))
    print(f"train 2-layer copy card vs CPU on {B} x {L} tokens: loss "
          f"{float(ce):.6f} / {float(cpu_ce):.6f} (rel {rel:.3g}); "
          f"gradients within {worst:.3g} of each leaf's largest value; CPU "
          f"run {cpu_s:.1f} s", flush=True)


def launcher_train_runs(torch) -> None:
    """(d): ``repro_torch.launch.train.main`` twice at full width
    (``LAUNCH_LAYERS`` deep) with a checkpoint every 10 steps and a
    failure at 15: the losses bit for bit (R5 replayed: 35 steps), and the
    state saved at step 20 restored bit for bit."""
    import shutil
    from dataclasses import replace

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch import train
    from repro_torch.models.common import tree_leaves

    saved, io_s = {}, {"save": 0.0, "restore": 0.0}
    save, restore = Checkpointer.save, Checkpointer.restore

    def recording(self, step, tree):
        # The train step builds a new state each step and never writes
        # into an old one, so the saved tensors are kept as they are.
        saved[step] = tree
        t0 = time.perf_counter()
        out = save(self, step, tree)
        io_s["save"] += time.perf_counter() - t0
        return out

    def timed_restore(self, *args, **kw):
        t0 = time.perf_counter()
        out = restore(self, *args, **kw)
        io_s["restore"] += time.perf_counter() - t0
        return out

    runs = []
    ckpt_dir = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    archs = train.ARCHS
    train.ARCHS = dict(archs, **{LAUNCH_ARCH: replace(
        archs[LAUNCH_ARCH], n_layers=LAUNCH_LAYERS)})
    Checkpointer.save, Checkpointer.restore = recording, timed_restore
    try:
        for _ in range(2):
            shutil.rmtree(ckpt_dir, ignore_errors=True)
            t0 = time.perf_counter()
            losses = train.main(LAUNCH_ARGV + ["--ckpt-dir", ckpt_dir])
            torch.cuda.synchronize()
            runs.append((losses, time.perf_counter() - t0))
    finally:
        Checkpointer.save, Checkpointer.restore = save, restore
        train.ARCHS = archs
    (a, wall_a), (b, wall_b) = runs
    check(len(a) == 35, f"launcher: {len(a)} losses, want 35 (steps 0-14, "
          f"then 10-29 after the restore)")
    check(a == b, f"launcher: two runs' losses differ:\n{a}\n{b}")
    restored, _ = Checkpointer(ckpt_dir).restore(saved[20], step=20)
    check(all(torch.equal(x, y) for x, y in zip(tree_leaves(restored),
                                                tree_leaves(saved[20]))),
          "launcher: the restored state differs from the saved one")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"launcher {LAUNCH_ARCH} ({LAUNCH_LAYERS} layers): 2 runs of "
          f"{len(a)} steps, losses bit for bit ({a[0]:.4f} → {a[-1]:.4f}); "
          f"the state saved at step 20 restored bit for bit; {wall_a:.1f} / "
          f"{wall_b:.1f} s a run, of which checkpoint writes "
          f"{io_s['save']:.1f} s and reads {io_s['restore']:.1f} s over both",
          flush=True)


def bf16_forward(torch, cfg, params) -> None:
    """(e): ``forward`` under ``precision.options(dtype=bf16)`` beside the
    float32 one: finite logits, the largest |Δlogit| against the largest
    |logit|, the argmax share and the distinct argmax tokens (a share
    over near-constant argmaxes says little), both times."""
    from repro_torch.models import precision, registry

    tokens = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab, TRAIN_BATCH)).cuda()
    out = {}
    with torch.no_grad():
        for name, dtype in (("float32", None), ("bf16", torch.bfloat16)):
            with precision.options(dtype=dtype):
                registry.forward(cfg, params, {"tokens": tokens[:1, :64]})
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, _ = registry.forward(cfg, params, {"tokens": tokens})
                torch.cuda.synchronize()
                out[name] = ((time.perf_counter() - t0) * 1e3, logits)
                del logits
    (bf_ms, bf), (f32_ms, f32) = out["bf16"], out["float32"]
    finite = bool(bf.isfinite().all()) and bool(f32.isfinite().all())
    top = float(f32.abs().max())
    diff = float((bf.float() - f32).abs().max())
    pick = f32.argmax(-1)
    share = float((bf.argmax(-1) == pick).float().mean())
    distinct = int(pick.unique().numel())
    print(f"bf16 forward {cfg.name} on {TRAIN_BATCH[0]} x {TRAIN_BATCH[1]}: "
          f"{bf_ms:.1f} ms against {f32_ms:.1f} ms in float32; max |Δlogit| "
          f"{diff:.4g} = {diff / top:.4g} of max |logit| {top:.4g}; argmax "
          f"agrees on {share:.4f} of positions, {distinct} distinct float32 "
          f"argmax tokens of {pick.numel()}", flush=True)
    check(finite, "bf16 forward: non-finite logits")
    check(diff <= BF16_LOGIT_OF_MAX * top, f"bf16 forward: max |Δlogit| "
          f"{diff:.4g} above {BF16_LOGIT_OF_MAX} of max |logit| {top:.4g}")
    check(share >= BF16_ARGMAX_SHARE, f"bf16 forward: argmax agrees with "
          f"float32 on {share:.3f} of positions (bound {BF16_ARGMAX_SHARE})")


def training_phase(torch) -> tuple:
    """Phase 26: (a) K7's backward against its plain version and its
    refusals, and the forward's bias (F7), (b) tinyllama-1.1b training,
    (c) its 2-layer copy card against CPU, (d) the launcher twice, (e) the
    bf16 forward.  Returns (K7 forward launches, K7 backward launches,
    backward rows, (b)'s run record for phase 28)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import registry

    no_tf32(torch)
    for case in K7_BWD_CASES:
        k7_bwd_case(torch, *case)
    rows = [k7_bwd_case(torch, *case, timed=True) for case in K7_BWD_TIMED]
    k7_bwd_refusals(torch)
    k7_bias_check(torch)
    torch.cuda.empty_cache()
    cfg = ARCHS[TRAIN_ARCH]
    params = registry.init_params(cfg, 0, device="cuda")
    train_copy(torch, cfg, params)
    holder = {"params": params}
    del params
    run = train_run(torch, cfg, holder)
    bf16_forward(torch, cfg, run.pop("params"))
    torch.cuda.empty_cache()
    launcher_train_runs(torch)
    return (run["counts"]["flash_attention"],
            run["counts"]["flash_attention_bwd"], rows, run)


# --------------------------------------------------------------------------
# phase 27: training of every family (K8's backward, K7's backward at head
# width 256, mamba2-1.3b and recurrentgemma-2b trained, five copies)
# --------------------------------------------------------------------------

#: (a): K8's backward against ``ssd_chunk_bwd_ref`` at ``K8_SHAPES`` and
#: three more, (B, L, H, P, G, S, chunk): five heads a group (runs of
#: nh < hpg, a short last one), one head a group, a 17-step chunk with
#: odd widths.  Each through the wrapper and through the launcher with 1,
#: 2, 3 and all heads of a group a block, on NaN-filled outputs.
K8_BWD_MORE = [(1, 128, 10, 16, 2, 32, 32), (2, 64, 4, 32, 4, 32, 32),
               (2, 34, 4, 24, 2, 48, 17)]
K8_BWD_NAMES = ("dx", "ddelta", "ddt", "dB", "dC")
#: |Δ| ≤ rtol·|ref| + atol·max|ref| for each of K8's five gradients (the
#: K7 backward's gate): float32 sums of up to a few thousand products in
#: another order than the plain version's einsums, and ddelta a reverse
#: cumulative sum of differences.
K8_BWD_RTOL, K8_BWD_ATOL_OF_MAX = 2e-4, 2e-5
#: (c): mamba2-1.3b trained at full width and depth (48 layers) on B × L
#: tokens a step; K8's backward is timed at this shape in (a).  With remat
#: (F9 closed) each layer is checkpointed, as the reference's is:
#: K8 runs twice a layer-step (the forward and its recomputation).
TRAIN_SSM_SHAPE = (2, 1024)
#: Phase 27's peaks while ``remat`` did nothing in these families (F9;
#: H100 80GB HBM3 at 700 W), printed beside this run's: every layer's
#: activations were kept.
NO_REMAT_PEAK_GB = {"mamba2-1.3b": 52.45, "recurrentgemma-2b": 37.37}
#: (b): K7's backward at head width 256 against ``attention_bwd_ref``:
#: GQA over one KV head, causal with a window and Lq < Lk, non-causal,
#: non-causal Lq < Lk with a window, a group of 16 rows, and 5 000 rows a
#: group (two runs of the dk/dv pass); timed at recurrentgemma-2b's
#: prefill, ``K7_RG_PREFILL`` (phase 25's forward shape).
K7_BWD_256_CASES = [
    (2, 10, 1, 128, 128, 256, True, None),
    (1, 4, 1, 200, 300, 256, True, 64),
    (1, 2, 2, 100, 100, 256, False, None),
    (1, 4, 2, 50, 120, 256, False, 30),
    (2, 8, 1, 2, 40, 256, True, None),
    (1, 10, 1, 500, 500, 256, True, 100),
]
#: (c): recurrentgemma-2b trained at full width, cut to TRAIN_HYBRID_LAYERS
#: of its 26 layers (two (R, R, A) blocks: two attention layers) on B × L
#: tokens past its 2048 window: at full depth its float32 parameters,
#: gradients and AdamW's old and new state (≈ 2.7 B parameters × 7
#: copies) do not fit 80 GB.
TRAIN_HYBRID_LAYERS = 6
TRAIN_HYBRID_SHAPE = (1, 4096)
#: (d): the copies, card against CPU, (B, L) each: mamba2 and qwen2-vl at
#: 2 layers, recurrentgemma one (R, R, A) block, whisper two encoder and
#: two decoder layers (``two_layers``), qwen3-moe 1 layer (1 × 128: at
#: 1 × 256 its CPU side took 20.4 s).
TRAIN_COPIES = {"mamba2-1.3b": (2, 256), "recurrentgemma-2b": (1, 300),
                "qwen3-moe-235b-a22b": (1, 128), "qwen2-vl-2b": (1, 128),
                "whisper-base": (1, 64)}
#: The MoE copy's batch: seeds tried in turn until every (token, choice)
#: route of the forward agrees, card and CPU (a flipped route moves the
#: gradients of two experts' weights); the serving gate's allowance,
#: ``MOE_ROUTE_SHARE`` of the routes, bounds each try.
TRAIN_MOE_SEEDS = 8


def k8_bwd_operands(torch, B, L, H, P, G, S, chunk):
    """K8's operands as ``ssd`` lays them out, then output gradients dy,
    dH, des from a seed; and the heads a group."""
    _, ops, hpg = k8_operands(torch, B, L, H, P, G, S, chunk)
    rng = np.random.RandomState(L + H + S)
    BH, NC = B * H, L // chunk
    grads = [torch.from_numpy(rng.randn(*s).astype(np.float32)).cuda()
             for s in ((BH, NC, chunk, P), (BH, NC, S, P), (BH, NC, chunk))]
    return ops + grads, hpg


def k8_bwd_case(torch, B, L, H, P, G, S, chunk, timed: bool = False):
    """K8's backward against ``ssd_chunk_bwd_ref`` on the card through the
    wrapper (two calls bit for bit) and, untimed, the launcher with 1, 2,
    3 and all heads a block on NaN-filled outputs and scratch; with
    ``timed`` the wrapper and the plain version timed.  Returns a
    kernels-line row (timed) or None."""
    from repro_torch.kernels.ssd_chunk import ssd_chunk_bwd, ssd_chunk_bwd_ref
    from repro_torch.kernels.ssd_chunk.kernel import launch_ssd_chunk_bwd

    args, hpg = k8_bwd_operands(torch, B, L, H, P, G, S, chunk)
    want = ssd_chunk_bwd_ref(*args, heads_per_group=hpg)
    shape = f"B={B} L={L} H={H} P={P} G={G} S={S} Q={chunk}"
    runs = {"wrapper": ssd_chunk_bwd(*args, heads_per_group=hpg)}
    for nh in ([] if timed else
               sorted({1, 2, 3, hpg} & set(range(1, hpg + 1)))):
        out = [torch.full_like(w, float("nan")) for w in want]
        nblk = -(-hpg // nh)
        part = (torch.full((2 * nblk * args[3].numel(),), float("nan"),
                           device="cuda") if nblk > 1 else None)
        launch_ssd_chunk_bwd(*args, *out, part, heads_per_group=hpg, nh=nh)
        runs[f"nh={nh}"] = out
    torch.cuda.synchronize()
    err = 0.0
    for run, got in runs.items():
        for name, g, w in zip(K8_BWD_NAMES, got, want):
            err = max(err, close(
                f"ssd_chunk_bwd {shape} {run} {name}", g, w, K8_BWD_RTOL,
                K8_BWD_ATOL_OF_MAX * float(w.abs().max())))
    again = ssd_chunk_bwd(*args, heads_per_group=hpg)
    check(all(torch.equal(a, b) for a, b in zip(runs["wrapper"], again)),
          f"ssd_chunk_bwd {shape}: two calls differ")
    # The mean signed error of each gradient, the kernel's and the plain
    # version's, against the plain version evaluated in float64.
    exact = ssd_chunk_bwd_ref(*(a.double() for a in args),
                              heads_per_group=hpg)
    bias = ", ".join(
        f"{name} {signed_error(g, w)[1]:.3g} (plain "
        f"{signed_error(p, w)[1]:.3g})"
        for name, g, p, w in zip(K8_BWD_NAMES, runs["wrapper"], want, exact))
    del exact
    print(f"kernel ssd_chunk_bwd {shape}: {', '.join(runs)}: max |Δ| "
          f"{err:.3g} (within rtol {K8_BWD_RTOL} + {K8_BWD_ATOL_OF_MAX} of "
          f"max); two calls bit for bit; mean signed error of |ref| "
          f"against float64: {bias}", flush=True)
    if not timed:
        return None
    ms = event_ms(torch, lambda: ssd_chunk_bwd(*args, heads_per_group=hpg))
    plain_ms = event_ms(torch, lambda: ssd_chunk_bwd_ref(
        *args, heads_per_group=hpg), reps=10, warmup=2)
    BH, NC = B * H, L // chunk
    # x, dy, dx [BH, L, P]; delta, dt, des in and ddelta, ddt out [BH, L];
    # B, C in and dB, dC out [B, G, L, S]; dH [BH, NC, S, P] in.
    nbytes = 4 * (3 * BH * L * P + 5 * BH * L + 4 * B * G * L * S
                  + BH * NC * S * P)
    # The work the function needs: C·Bᵀ, ΣZ·B and ΣZᵀ·C over the causal
    # triangle once per (batch, group, chunk), Z summed over the group's
    # heads; per (bh, chunk) dy·xᵀ and Gᵀ·dy on the triangle, x·dHᵀ and
    # B·dH.  The kernel runs every product as three TF32 MMAs (float32
    # accurate), so the bound counts three terms a product at the TF32
    # rate; the bound on the CUDA cores' float32 rate is printed beside it.
    tri = chunk * (chunk + 1) // 2
    ops_n = (B * G * NC * 3 * 2 * tri * S
             + BH * NC * (4 * tri * P + 4 * chunk * S * P))
    row = row_of("ssd_chunk_bwd", BH, NC, ms, plain_ms, nbytes, 3 * ops_n,
                 err, op_rate=TF32_OPS_PER_S, Q=chunk, P=P, S=S)
    print(f"kernel ssd_chunk_bwd {shape}: bound of the operations "
          f"{3 * ops_n / TF32_OPS_PER_S * 1e6:.3f} us (3xTF32), "
          f"{ops_n / FP32_OPS_PER_S * 1e6:.3f} us on the CUDA cores; bytes "
          f"{nbytes / HBM_BYTES_PER_S * 1e6:.3f} us", flush=True)
    return row


def family_train_batch(torch, cfg, B: int, L: int, seed: int, device: str):
    """A train batch for ``cfg``'s family: ``family_batch``'s inputs and
    labels for its text positions, from a seed."""
    batch = family_batch(torch, cfg, B, L, seed, device)
    n_tok = batch["tokens"].shape[1]
    batch["labels"] = torch.from_numpy(np.random.RandomState(seed + 1)
                                       .randint(0, cfg.vocab, (B, n_tok))
                                       ).to(device)
    return batch


def copy_config(cfg):
    """The copy's config: ``two_layers``' cut, the MoE's 1 layer."""
    from dataclasses import replace

    if cfg.family == "moe":
        return replace(cfg, n_layers=1)
    if cfg.family == "hybrid":
        return replace(cfg, n_layers=len(cfg.block_pattern))
    if cfg.family == "audio":
        return replace(cfg, n_layers=2, encoder_layers=2)
    return replace(cfg, n_layers=2)


def family_copy(torch, name: str, shape=None, dtype=None,
                loss_rtol: float = TRAIN_LOSS_RTOL,
                grad_of_max: float = TRAIN_GRAD_OF_MAX,
                seeds: int = TRAIN_MOE_SEEDS) -> None:
    """(d): one train step's loss and gradients (``loss_and_grads``) of a
    cut copy of ``name`` at full width, weights from a seed, on the card
    against the CPU: the loss within ``loss_rtol`` and each gradient leaf
    within ``grad_of_max`` of its largest value.  The MoE's batch is the
    first of ``seeds`` whose routes agree on both devices (read from a
    ``forward`` without the unembedding, which no route depends on; the
    step's own routes are compared again); in float32 each try's share
    of differing routes is also bounded by ``MOE_ROUTE_SHARE``.
    ``shape``: (B, L), ``TRAIN_COPIES``' by default; ``dtype``: the
    compute dtype of both sides (``precision.options``; phase 29's bf16
    copies), float32 by default."""
    import contextlib

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import precision, registry
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.train import loss_and_grads

    cfg = copy_config(ARCHS[name])
    B, L = shape or TRAIN_COPIES[name]

    def opts():
        return (precision.options(dtype=dtype) if dtype is not None
                else contextlib.nullcontext())
    params = registry.init_params(cfg, 1, device="cuda")
    t0 = time.perf_counter()
    cpu_p = tree_map(lambda a: a.cpu(), params)
    moe = cfg.family == "moe"

    def routes(fn):
        out, rec = moe_recorded(fn) if moe else (fn(), [])
        return out, torch.cat([torch.cat([r[0].cpu(), r[1].cpu()], 1)
                               for r in rec]) if rec else None

    seed, tries = 11, []
    if moe:
        # The probes' weights, cast to the compute dtype once (``forward``
        # casts them again, which leaves a tensor of that dtype as it is).
        with opts():
            probe_p, probe_c = (precision.cast_params(p)
                                for p in (params, cpu_p))
    for seed in range(11, 11 + (seeds if moe else 1)):
        batch = family_train_batch(torch, cfg, B, L, seed, "cuda")
        cpu_b = {k: v.cpu() for k, v in batch.items()}
        if not moe:
            break
        with torch.no_grad(), opts():
            _, g_r = routes(lambda: registry.forward(cfg, probe_p, batch,
                                                     unembed=False))
            _, c_r = routes(lambda: registry.forward(cfg, probe_c, cpu_b,
                                                     unembed=False))
        share = float((g_r != c_r).float().mean())
        check(dtype is not None or share <= MOE_ROUTE_SHARE, f"train copy "
              f"{name}: {share:.4g} of the routes differ (bound "
              f"{MOE_ROUTE_SHARE})")
        tries.append(share)
        if share == 0.0:
            break
    else:
        raise RuntimeError(f"chip_smoke: train copy {name}: no batch of "
                           f"{seeds} seeds with every route equal "
                           f"(shares {tries})")
    if moe:
        del probe_p, probe_c
    LAUNCHES.clear()
    with opts():
        (total, ce, g_card), g_r = routes(lambda: loss_and_grads(
            cfg, params, batch))
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        (c_total, c_ce, g_cpu), c_r = routes(lambda: loss_and_grads(
            cfg, cpu_p, cpu_b))
    cpu_s = time.perf_counter() - t0
    if moe:
        check(torch.equal(g_r, c_r), f"train copy {name}: the step's routes "
              f"differ, card against CPU")
    rel = abs(float(ce) - float(c_ce)) / abs(float(c_ce))
    check(rel <= loss_rtol, f"train copy {name}: loss {float(ce)!r} on "
          f"the card, {float(c_ce)!r} on the CPU (rel {rel:.3g})")
    worst = 0.0
    for a, b in zip(tree_leaves(g_card), tree_leaves(g_cpu)):
        scale = float(b.abs().max())
        err = float((a.cpu() - b).abs().max())
        check(err <= grad_of_max * scale, f"train copy {name}: a "
              f"gradient leaf {tuple(b.shape)} differs by {err:.3g} (max "
              f"{scale:.3g})")
        worst = max(worst, err / max(scale, 1e-30))
    kernel = "ssd_chunk" if cfg.family == "ssm" else "flash_attention"
    check(counts.get(kernel, 0) > 0 and counts.get(kernel + "_bwd", 0) > 0,
          f"train copy {name}: launches {counts}")
    extra = (f"; routes equal on seed {seed} (shares of the tries {tries})"
             if moe else "")
    print(f"train copy {name} ({cfg.n_layers} layers"
          f"{'' if dtype is None else ', ' + str(dtype)}) card vs CPU on {B} x "
          f"{L}: loss {float(ce):.6f} / {float(c_ce):.6f} (rel {rel:.3g}); "
          f"gradients within {worst:.3g} of each leaf's largest value; "
          f"launches {counts}{extra}; CPU side {cpu_s:.1f} s", flush=True)


def family_training_phase(torch) -> tuple:
    """Phase 27: (a) K8's backward, (b) K7's backward at head width 256,
    (c) mamba2-1.3b and recurrentgemma-2b trained on the card, (d) five
    copies card against CPU.  Returns (launches by kernel in (c), rows of
    the kernels line, (c)'s run records for phase 28)."""
    from dataclasses import replace

    from repro_torch.configs import ARCHS
    from repro_torch.models import registry

    no_tf32(torch)
    for shape in K8_SHAPES + K8_BWD_MORE:
        k8_bwd_case(torch, *shape)
    rows = [k8_bwd_case(torch, TRAIN_SSM_SHAPE[0], TRAIN_SSM_SHAPE[1], 64,
                        64, 1, 128, 64, timed=True)]
    for case in K7_BWD_256_CASES:
        k7_bwd_case(torch, *case)
    rows.append(dict(k7_bwd_case(torch, *K7_RG_PREFILL, timed=True),
                     name="flash_attention_bwd_d256"))
    torch.cuda.empty_cache()
    launches, records = {}, []
    ssm = ARCHS["mamba2-1.3b"]
    hybrid = replace(ARCHS["recurrentgemma-2b"],
                     n_layers=TRAIN_HYBRID_LAYERS)
    attn = sum(1 for k in hybrid._layer_kinds() if k == "attn")
    # F9's gates: every mixer and attention layer sits in a checkpointed
    # unit (two (R, R, A) blocks, no remainder), so its forward kernel
    # runs twice a step and its backward once.
    for cfg, shape, want in (
            (ssm, TRAIN_SSM_SHAPE,
             {"ssd_chunk": 2 * ssm.n_layers * TRAIN_STEPS,
              "ssd_chunk_bwd": ssm.n_layers * TRAIN_STEPS}),
            (hybrid, TRAIN_HYBRID_SHAPE,
             {"flash_attention": 2 * attn * TRAIN_STEPS,
              "flash_attention_bwd": attn * TRAIN_STEPS})):
        holder = {"params": registry.init_params(cfg, 0, device="cuda")}
        run = train_run(torch, cfg, holder, shape=shape, want=want)
        print(f"train {cfg.name}: peak memory {run['peak'] / 1e9:.2f} GB "
              f"with remat (F9) against {NO_REMAT_PEAK_GB[cfg.name]:.2f} GB "
              f"without", flush=True)
        for k, n in run["counts"].items():
            launches[k] = launches.get(k, 0) + n
        del run["params"], holder
        records.append(run)
        torch.cuda.empty_cache()
    for name in TRAIN_COPIES:
        family_copy(torch, name)
        torch.cuda.empty_cache()
    return launches, rows, records


# --------------------------------------------------------------------------
# phase 28: sizing and the dry-run's tooling beside what the card did
# --------------------------------------------------------------------------

#: (c): the model whose parameters go through ``to_shardings`` and
#: ``reshard`` on the card (full width and depth: 135 M parameters).
SHARD_ARCH = "smollm-135m"


def sizing_phase(torch, trained) -> dict:
    """Phase 28: (a) ``abstract_train_state`` of every model phases 26-27
    trained (``trained``: their run records) against the state they
    allocated, leaf for leaf in shape and dtype; (b) the cost model and
    ``state_bytes`` of each run on one card beside its measured step and
    peak memory (predicted state ≤ peak), and recurrentgemma-2b's state at
    full depth; (c) a world-1 NCCL group and a (1, 1) ``DeviceMesh``:
    ``SHARD_ARCH``'s parameters laid out by ``to_shardings``, resharded
    through ``survivor_mesh(0, data=1, model=1)``, bit for bit.  Returns
    the figures of (b)."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.dryrun import state_bytes
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import abstract_train_state

    check(trained and all(r is not None for r in trained),
          "phase 28 reads phases 26 and 27's runs: run it with them "
          "(--only 26,27,28)")
    one = make_mesh((1, 1), ("data", "model"))
    figures = []
    for run in trained:
        cfg, (B, L) = run["cfg"], run["shape"]
        t0 = time.perf_counter()
        meta = state_shapes(abstract_train_state(cfg))
        check(meta == run["state"], f"sizing {cfg.name}: the meta state "
              f"differs from the trained one in "
              f"{sorted(set(meta.items()) ^ set(run['state'].items()))[:4]}")
        # Every family checkpoints its layers (blocks) under remat, as
        # the reference does (F9).
        bound_ms, flops, nbytes, terms = cost_terms(cfg, B, L)
        parts = state_bytes(cfg, ShapeSpec(f"train_{B}x{L}", L, B, "train"),
                            one)
        predicted = sum(parts.values())
        sized_s = time.perf_counter() - t0
        check(predicted <= run["peak"], f"sizing {cfg.name}: predicted "
              f"state {predicted} B above the measured peak {run['peak']} B")
        row = {"arch": cfg.name, "layers": cfg.n_layers, "batch": [B, L],
               "remat": True, "flops": flops, "hbm_bytes": nbytes,
               "compute_s": terms["compute_s"],
               "memory_s": terms["memory_s"], "state_bytes": predicted,
               "state_bytes_by_part": parts, "step_ms": run["ms"],
               "peak_bytes": run["peak"],
               "measured_over_bound": run["ms"] / bound_ms}
        figures.append(row)
        print(f"sizing {cfg.name} ({cfg.n_layers} layers, {B} x {L}, "
              f"remat): meta state = trained state ({len(meta)} "
              f"leaves); cost model {flops / 1e12:.3f} Tflop, "
              f"{nbytes / 1e9:.3f} GB of HBM traffic: compute_s "
              f"{terms['compute_s']:.6f} (FP32 peak), memory_s "
              f"{terms['memory_s']:.6f}; measured {run['ms']:.1f} ms a step "
              f"= {row['measured_over_bound']:.3f}x the bound; state "
              f"{predicted / 1e9:.3f} GB predicted ({parts}) against a "
              f"{run['peak'] / 1e9:.3f} GB peak "
              f"({predicted / run['peak']:.3f}); sized in {sized_s:.2f} s",
              flush=True)
    rg = ARCHS["recurrentgemma-2b"]
    parts = state_bytes(rg, ShapeSpec("train_1x4096", 4096, 1, "train"), one)
    full = {"arch": rg.name, "layers": rg.n_layers,
            "state_bytes": sum(parts.values()), "state_bytes_by_part": parts,
            "seven_copies_bytes": 7 * parts["params"]}
    figures.append(full)
    print(f"sizing {rg.name} at full depth ({rg.n_layers} layers) on one "
          f"card: params + AdamW state + a 1 x 4096 batch "
          f"{full['state_bytes'] / 1e9:.3f} GB ({parts}); with gradients "
          f"and AdamW's new state beside the old (7 float32 copies) "
          f"{full['seven_copies_bytes'] / 1e9:.3f} GB against "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.3f} "
          f"GB on the card", flush=True)
    shard_round_trip(torch, "nccl", "cuda")
    return {"sizing": figures}


def shard_round_trip(torch, backend: str, device: str) -> None:
    """(c): a world-1 process group on an in-process store (no address, no
    port) and the loopback device, a (1, 1) ``DeviceMesh`` on ``device``,
    ``SHARD_ARCH``'s parameters placed by ``to_shardings`` and resharded
    through ``survivor_mesh(0, data=1, model=1)``: every value bit for bit
    on ``device``.  The group is destroyed after, also on failure."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.configs import ARCHS
    from repro_torch.ft import reshard, survivor_mesh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry
    from repro_torch.sharding import (leaves_with_paths, param_specs,
                                      to_shardings)

    check(not dist.is_initialized(), "a process group is already up")
    for var in ("NCCL_SOCKET_IFNAME", "GLOO_SOCKET_IFNAME"):
        os.environ.setdefault(var, "lo")
    t0 = time.perf_counter()
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        dm = mesh.device_mesh(device)
        params = registry.init_params(ARCHS[SHARD_ARCH], 0, device=device)
        shardings = dict(leaves_with_paths(to_shardings(
            param_specs(params, mesh), dm)))
        placed = {path: distribute_tensor(x, dm, shardings[path].placements)
                  for path, x in leaves_with_paths(params)}
        new_mesh, new_data = survivor_mesh(0, data=1, model=1)
        check(new_data == 1, f"survivor mesh: {new_data} data slices")
        out = reshard(placed, new_mesh)
        leaves = dict(leaves_with_paths(params))
        for path, x in out.items():
            check(isinstance(x, DTensor)
                  and x.device_mesh.mesh_dim_names == ("data", "model"),
                  f"reshard: {path} is not a DTensor on the survivor mesh")
            full = x.full_tensor()
            check(full.device.type == device
                  and full.dtype == leaves[path].dtype
                  and torch.equal(full, leaves[path]),
                  f"reshard: {path} differs after the round trip")
        n = sum(x.numel() for x in leaves.values())
    finally:
        dist.destroy_process_group()
    print(f"sharding on {device} ({backend}, world 1): {len(leaves)} "
          f"tensors, {n} values of {SHARD_ARCH} through to_shardings and "
          f"reshard onto survivor_mesh(0, data=1, model=1), bit for bit, in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


# --------------------------------------------------------------------------
# phase 29: bf16 training (K7's bf16 backward, bf16 train steps, copies)
# --------------------------------------------------------------------------

#: (a): the pin of K7's bf16 backward against ``attention_bwd_ref`` on the
#: widened bf16 operands: phase 26's, plus one bf16 rounding of |ref|
#: (2⁻⁸·|ref|), since the kernel rounds its float32 sums once to bf16 and
#: the plain version returns them unrounded.  At every case of
#: ``K7_BWD_CASES`` (each D ≤ 128) and timed at ``K7_BWD_TIMED``.
K7_BF16_ROUND = 2.0 ** -8
#: (c): qwen3-moe-235b-a22b at full width cut to BF16_MOE_LAYERS of its 94
#: layers on BF16_MOE_BATCH tokens.  AdamW's state does not fit at this
#: width (6.2 B float32 parameters; with gradients, m, v and the new
#: state 7 copies, 174 GB), so each step is ``loss_and_grads`` followed by
#: an in-place update p −= BF16_MOE_LR · sign(g) (AdamW's first step) on
#: one fixed batch.
BF16_MOE_ARCH = "qwen3-moe-235b-a22b"
BF16_MOE_LAYERS = 2
BF16_MOE_BATCH = (2, 1024)
BF16_MOE_STEPS = 4
BF16_MOE_LR = 1e-4
#: (d): the bf16 copies card against CPU, (B, L) each: tinyllama-1.1b at
#: 2 layers, qwen3-moe at 1 layer on the first of BF16_MOE_SEEDS batches
#: whose routes agree.  Its router's logits are bf16 products, and a
#: float32 sum in another order rounds to the neighbouring bf16 value now
#: and then: 0.1-0.9 % of the (token, choice) routes differed, card
#: against CPU, on seven of the first eight 1 x 128 batches (H100 80GB
#: HBM3, 700 W), where the float32 copy's agree on its first seed.  Fewer tokens
#: do not help: the loss is a mean over the tokens of bf16 logits of a
#: 151 936-word vocabulary, and on 1 x 32 tokens it stood 1.34e-4 apart
#: on the same card, outside the band, where 1 x 128 gave 4.47e-5.
BF16_COPIES = {"tinyllama-1.1b": TRAIN_COPY, "qwen3-moe-235b-a22b": (1, 128)}
BF16_MOE_SEEDS = 32
#: The band of tests/test_torch_bf16_grad.py (the port's bf16 step against
#: the reference's on the CPU: losses within 3.4e-5–4.6e-5 relative, the
#: worst leaf 2.05e-2–2.41e-2 of its largest value): the loss within 1e-4
#: relative and each gradient leaf within 3e-2 of its largest value.
BF16_LOSS_RTOL, BF16_GRAD_OF_MAX = 1e-4, 3e-2


def k7_bwd_bf16_case(torch, B, H, Hkv, Lq, Lk, D, causal, window,
                     timed: bool = False):
    """K7's bf16 backward: q, k, v, dO rounded to bf16; through autograd
    (one forward, which writes the lse and the float32 output, and one
    backward launch) and through the wrapper (given no lse), against
    ``attention_bwd_ref`` on the widened operands within phase 26's pin
    plus ``K7_BF16_ROUND``; autograd equal to the wrapper, dq, dk, dv
    bf16; the forward's bf16 output its float32 one rounded once, and
    equal to the forward without lse where both take the tensor-core
    kernel.  With ``timed`` also two calls bit for bit, and the backward
    given the forward's lse and float32 output timed beside the plain
    version, the float32 backward on the same values and SDPA's bf16
    backward.  Returns a kernels-line row (timed) or None."""
    import torch.nn.functional as F

    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention import (
        attention_bwd_ref, attention_lse_ref, flash_attention,
        flash_attention_bwd, flash_attention_lse)
    from repro_torch.kernels.flash_attention.ops import K7_SPLIT_ROWS

    bf = torch.bfloat16
    q, k, v, do = (t.to(bf) for t in k7_bwd_inputs(torch, B, H, Hkv, Lq,
                                                     Lk, D))
    want = attention_bwd_ref(q, k, v, do, causal=causal, window=window)
    shape = (f"B={B} H={H} Hkv={Hkv} Lq={Lq} Lk={Lk} D={D} causal={causal} "
             f"window={window} bf16")
    o32, lse = flash_attention_lse(q, k, v, causal=causal, window=window)
    check(o32.dtype == torch.float32, f"flash_attention_lse {shape}: "
          f"output {o32.dtype}, not float32")
    close(f"flash_attention lse {shape}", lse,
          attention_lse_ref(q, k, causal=causal, window=window),
          **K7_LSE_TOL)
    if (H // Hkv) * Lq > K7_SPLIT_ROWS:
        check(torch.equal(o32.to(bf), flash_attention(q, k, v, causal=causal,
                                                      window=window)),
              f"flash_attention {shape}: o with and without the lse differ")
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    LAUNCHES.clear()
    o = flash_attention(qg, kg, vg, causal=causal, window=window)
    o.backward(do)
    torch.cuda.synchronize()
    check(dict(LAUNCHES) == {"flash_attention": 1, "flash_attention_bwd": 1},
          f"flash_attention bf16 backward: launches {dict(LAUNCHES)}")
    check(o.dtype == bf and torch.equal(o.detach(), o32.to(bf)),
          f"flash_attention {shape}: the grad forward's bf16 o is not "
          f"flash_attention_lse's float32 output rounded once")
    got = flash_attention_bwd(q, k, v, do, causal=causal, window=window)
    err = 0.0
    for name, a, b, w in zip(("dq", "dk", "dv"), (qg.grad, kg.grad, vg.grad),
                             got, want):
        check(a.dtype == bf and b.dtype == bf, f"flash_attention_bwd "
              f"{shape} {name}: dtype {a.dtype} / {b.dtype}")
        atol = K7_BWD_ATOL_OF_MAX * float(w.abs().max())
        err = max(err, close(f"flash_attention_bwd {shape} {name}", b, w,
                             rtol=K7_BWD_RTOL + K7_BF16_ROUND, atol=atol))
        check(torch.equal(a, b), f"flash_attention_bwd {shape} {name}: "
              f"autograd and the wrapper differ")
    if not timed:
        print(f"kernel flash_attention_bwd {shape}: max |Δ| {err:.3g} "
              f"(within rtol {K7_BWD_RTOL} + 2^-8 + {K7_BWD_ATOL_OF_MAX} of "
              f"max)", flush=True)
        return None
    again = flash_attention_bwd(q, k, v, do, causal=causal, window=window,
                                lse=lse, o=o32)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"flash_attention_bwd {shape}: two calls differ")
    ms = event_ms(torch, lambda: flash_attention_bwd(
        q, k, v, do, causal=causal, window=window, lse=lse, o=o32), reps=20)
    plain_ms = event_ms(torch, lambda: attention_bwd_ref(
        q, k, v, do, causal=causal, window=window), reps=10, warmup=2)
    fwd_ms = event_ms(torch, lambda: flash_attention_lse(
        q, k, v, causal=causal, window=window), reps=20)
    with torch.no_grad():
        fwd_lib_ms = event_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, enable_gqa=True, is_causal=True), reps=20)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    of, lf = flash_attention_lse(qf, kf, vf, causal=causal, window=window)
    f32_ms = event_ms(torch, lambda: flash_attention_bwd(
        qf, kf, vf, dof, causal=causal, window=window, lse=lf, o=of),
        reps=20)
    del qf, kf, vf, dof, of, lf
    check(causal and Lq == Lk and window is None, "the timed bf16 cases "
          "are causal prefills")
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
    os_ = F.scaled_dot_product_attention(qs, ks, vs, enable_gqa=True,
                                         is_causal=True)
    lib_ms = event_ms(torch, lambda: torch.autograd.grad(
        os_, (qs, ks, vs), do, retain_graph=True), reps=20)
    del os_
    pairs = B * H * Lq * (Lq + 1) // 2
    # bf16 q, k, v, dO read and dq, dk, dv written, float32 o read.  An
    # unmasked pair: q·k and dO·v have bf16 operands on both sides, one
    # product each (2·D flops); P·dO, dS·k and dS·q have a float32 operand
    # (P, dS) that enters as three bf16 pieces, three products each: 22·D
    # flops at the bf16 tensor-core rate.
    nbytes = 2 * (3 * B * H * Lq + 4 * B * Hkv * Lk) * D + 4 * B * H * Lq * D
    row = row_of("flash_attention_bwd_bf16", B * H, Lk, ms, plain_ms, nbytes,
                 22 * D * pairs, err, library_ms=lib_ms,
                 op_rate=BF16_OPS_PER_S, Lq=Lq, D=D, rep=H // Hkv)
    # The grad forward: bf16 q, k, v read, bf16 o, float32 o32 and lse
    # written; q·k one product, P·v (P float32) three: 8·D flops a pair at
    # the bf16 rate.
    fwd_bytes = (2 * (2 * B * H * Lq + 2 * B * Hkv * Lk) * D
                 + 4 * B * H * Lq * (D + 1))
    fwd_bound = max(fwd_bytes / HBM_BYTES_PER_S,
                    8 * D * pairs / BF16_OPS_PER_S) * 1e3
    row.update(f32_ms=f32_ms, fwd_ms=fwd_ms, fwd_library_ms=fwd_lib_ms,
               fwd_bound_ms=fwd_bound)
    print(f"kernel flash_attention_bwd {shape}: {ms * 1e3:.3f} us against "
          f"the float32 backward's {f32_ms * 1e3:.3f} us on the same values "
          f"and SDPA's bf16 backward {lib_ms * 1e3:.3f} us; "
          f"{row['bound_ms'] / ms:.4f} of its bound; given the forward's lse "
          f"and float32 output; two calls bit for bit", flush=True)
    print(f"kernel flash_attention_lse {shape}: {fwd_ms * 1e3:.3f} us "
          f"(the bf16 grad forward, o32 and lse written) against SDPA's bf16 "
          f"forward {fwd_lib_ms * 1e3:.3f} us; bound {fwd_bound * 1e3:.3f} us "
          f"(8·D a pair at the bf16 rate)", flush=True)
    return row


def k7_bwd_bf16_attrs(torch) -> dict:
    """The bf16 backward's passes as built for this card at each of
    ``BWD_BF16_HEAD_DIMS``: registers, local bytes (spills), dynamic shared
    memory and blocks an SM, against ``plan_k7_bwd_bf16``; none may spill
    and each must keep eight warps an SM."""
    from repro_torch.kernels.flash_attention.kernel import bwd_bf16_attrs
    from repro_torch.kernels.flash_attention.ops import (BWD_BF16_HEAD_DIMS,
                                                         plan_k7_bwd_bf16)

    out = {}
    for D in BWD_BF16_HEAD_DIMS:
        attrs = bwd_bf16_attrs(D)
        plan = plan_k7_bwd_bf16(D)
        for name, want in (("dkdv", plan.smem_dkdv), ("dq", plan.smem_dq)):
            a = attrs[name]
            print(f"flash_attention_bwd bf16 {name} D={D}: {a['registers']} "
                  f"registers, {a['local_bytes']} local bytes, "
                  f"{a['smem_bytes']} B shared memory, {a['blocks_per_sm']} "
                  f"blocks an SM", flush=True)
            check(a["smem_bytes"] == want, f"bf16 {name} D={D}: shared memory "
                  f"{a['smem_bytes']}, plan_k7_bwd_bf16 says {want}")
            check(a["local_bytes"] == 0, f"bf16 {name} D={D}: "
                  f"{a['local_bytes']} local (spilled) bytes")
            warps = (8 if name == "dkdv" else 4) * a["blocks_per_sm"]
            check(warps >= 8, f"bf16 {name} D={D}: {warps} warps an SM")
        out[D] = attrs
    return out


def cost_terms(cfg, B: int, L: int, bf16: bool = False) -> tuple:
    """The cost model's remat train step of ``cfg`` on B × L tokens on one
    card (``launch/costmodel.py`` on ``MeshDims(1, 1, 1)``; the bf16 or
    the FP32 peak): (bound ms, flops, HBM bytes, roofline terms)."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import costmodel as cm
    from repro_torch.launch.hlo_analysis import roofline_terms
    from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16

    opts = cm.PerfOpts(bf16=bf16, remat=True)
    dims = cm.MeshDims(data=1, model=1, chips=1)
    shape = ShapeSpec(f"train_{B}x{L}", L, B, "train")
    flops = cm.flops_per_device(cfg, shape, dims, opts)
    nbytes = cm.bytes_per_device(cfg, shape, dims, opts)
    terms = roofline_terms(flops, nbytes, 0.0,
                           peak_flops=PEAK_FLOPS_BF16 * opts.peak_scale,
                           hbm_bw=HBM_BW, link_bw=LINK_BW)
    return (1e3 * max(terms["compute_s"], terms["memory_s"]), flops, nbytes,
            terms)


def bf16_moe_run(torch) -> dict:
    """(c): ``BF16_MOE_STEPS`` bf16 steps of the cut qwen3-moe on one
    batch (``loss_and_grads`` under bf16, then p −= lr·sign(g) in place):
    finite, falling losses, two K7 forwards and one bf16 backward a layer
    a step, ms a step, tokens/s, peak memory."""
    from dataclasses import replace

    from repro_torch.configs import ARCHS
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import precision, registry
    from repro_torch.models.common import tree_leaves
    from repro_torch.train import loss_and_grads

    cfg = replace(ARCHS[BF16_MOE_ARCH], n_layers=BF16_MOE_LAYERS)
    B, L = BF16_MOE_BATCH
    params = registry.init_params(cfg, 0, device="cuda")
    leaves = tree_leaves(params)
    batch = SyntheticLM(cfg.vocab, L, B, seed=0, device="cuda").batch(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    losses, walls = [], []
    with precision.options(dtype=torch.bfloat16):
        for _ in range(BF16_MOE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, ce, grads = loss_and_grads(cfg, params, batch)
            with torch.no_grad():
                for p, g in zip(leaves, tree_leaves(grads)):
                    p.add_(torch.sign(g, out=g), alpha=-BF16_MOE_LR)
            del grads
            losses.append(float(ce))
            walls.append(time.perf_counter() - t0)
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_attention": 2 * cfg.n_layers * BF16_MOE_STEPS,
            "flash_attention_bwd": cfg.n_layers * BF16_MOE_STEPS}
    check(counts == want, f"bf16 {cfg.name}: launches {counts}, want {want}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"bf16 {cfg.name}: losses {losses}")
    ms = 1e3 * float(np.median(walls[1:]))
    bound, flops, nbytes, _ = cost_terms(cfg, B, L, bf16=True)
    print(f"train bf16 {cfg.name}: {cfg.n_layers} layers at full width, "
          f"batch {B} x {L}, {BF16_MOE_STEPS} steps (remat; loss_and_grads "
          f"then p -= {BF16_MOE_LR} sign(g)): losses "
          f"{[round(x, 4) for x in losses]}; {ms:.1f} ms a step (median of "
          f"steps 1-{BF16_MOE_STEPS - 1}; first {walls[0] * 1e3:.1f} ms), "
          f"{B * L / ms * 1e3:.1f} tokens/s, peak memory {peak / 1e9:.2f} "
          f"GB, launches {counts}; cost model bf16 {flops / 1e12:.3f} Tflop "
          f"{nbytes / 1e9:.3f} GB: bound {bound:.1f} ms ({ms / bound:.2f}x)",
          flush=True)
    del params, leaves, batch
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "layers": cfg.n_layers, "batch": [B, L],
            "step_ms": ms, "peak_bytes": peak, "bound_ms": bound,
            "losses": losses, "counts": counts}


def bf16_training_phase(torch) -> tuple:
    """Phase 29: (a) K7's bf16 backward at phase 26's cases and timed at
    its two prefills; (b) tinyllama-1.1b trained ``TRAIN_STEPS`` steps in
    bf16 (phase 26 (b)'s run under ``precision.options(dtype=bf16)``)
    beside the cost model's bf16 bound; (c) the cut qwen3-moe's bf16
    steps; (d) the bf16 copies card against CPU.  Returns (K7 forward
    launches, K7 bf16 backward launches, the kernels-line row, the
    figures)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import precision, registry

    from repro_torch.kernels.flash_attention.ops import BWD_BF16_HEAD_DIMS

    no_tf32(torch)
    for case in K7_BWD_CASES:
        if case[5] in BWD_BF16_HEAD_DIMS:
            k7_bwd_bf16_case(torch, *case)
    rows = [k7_bwd_bf16_case(torch, *case, timed=True)
            for case in K7_BWD_TIMED]
    attrs = k7_bwd_bf16_attrs(torch)
    torch.cuda.empty_cache()
    cfg = ARCHS[TRAIN_ARCH]
    holder = {"params": registry.init_params(cfg, 0, device="cuda")}
    with precision.options(dtype=torch.bfloat16):
        run = train_run(torch, cfg, holder)
    del run["params"], holder
    torch.cuda.empty_cache()
    bound, flops, nbytes, _ = cost_terms(cfg, *TRAIN_BATCH,
                                         bf16=True)
    print(f"train bf16 {cfg.name}: {run['ms']:.1f} ms a step, peak "
          f"{run['peak'] / 1e9:.2f} GB; cost model bf16 {flops / 1e12:.3f} "
          f"Tflop {nbytes / 1e9:.3f} GB: bound {bound:.1f} ms "
          f"({run['ms'] / bound:.2f}x)", flush=True)
    figures = [{"arch": cfg.name, "layers": cfg.n_layers,
                "batch": list(TRAIN_BATCH), "step_ms": run["ms"],
                "peak_bytes": run["peak"], "bound_ms": bound},
               bf16_moe_run(torch),
               {"k7_bwd_bf16": [
                   {k: r[k] for k in ("D", "ms", "f32_ms", "library_ms",
                                      "bound_ms", "fwd_ms", "fwd_library_ms",
                                      "fwd_bound_ms")} for r in rows],
                "attrs": attrs}]
    for name, shape in BF16_COPIES.items():
        family_copy(torch, name, shape=shape, dtype=torch.bfloat16,
                    loss_rtol=BF16_LOSS_RTOL, grad_of_max=BF16_GRAD_OF_MAX,
                    seeds=BF16_MOE_SEEDS)
        torch.cuda.empty_cache()
    fwd = run["counts"]["flash_attention"] + figures[1]["counts"][
        "flash_attention"]
    bwd = run["counts"]["flash_attention_bwd"] + figures[1]["counts"][
        "flash_attention_bwd"]
    return fwd, bwd, rows[0], figures


def head_of(res, k: int):
    """A result's tasks from ``k`` on, ledger kept."""
    arrays = {f: getattr(res, f)[k:] for f in ("server",) + TIME_PLANES}
    return res._replace(**arrays)


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="",
                    help="comma-separated phase numbers (2-29) to run after "
                         "the build; a partial run prints no result line")
    only = {int(p) for p in ap.parse_args(argv).only.split(",") if p}

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    print(card_line(), flush=True)
    t0 = time.perf_counter()
    report = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{sorted(report) or 'nothing (cached)'}", flush=True)
    for name, (_, log) in report.items():
        for line in log.splitlines():
            if "ptxas" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    walls = {}

    def phase(name, fn, *args):
        if only and int(name.split()[0]) not in only:
            return None
        t = time.perf_counter()
        out = fn(torch, *args)
        walls[name] = time.perf_counter() - t
        print(f"phase {name}: {walls[name]:.1f} s", flush=True)
        return out

    def with_edges(rows, *edge_args, **edge_kw):
        edge_phase(torch, *edge_args, **edge_kw)
        return rows

    k1 = phase("2 kernel K1", lambda tc: with_edges(
        [kernel_phase(tc, 50, 100), kernel_phase(tc, 500, 10_000)],
        "sparse"))
    phase("3 testbed", testbed_phase)
    launches = {"dodoor_fused_sparse": phase("4 scale", scale_phase)}
    k2 = phase("5 kernel K2", lambda tc: with_edges(
        [kernel_phase(tc, 50, 100, masked=True),
         kernel_phase(tc, 500, 10_000, masked=True)],
        "sparse", Wds=EDGE_WD))
    phase("6 scenario testbed", scenario_phase)
    launches["dodoor_fused_sparse_masked"] = phase(
        "7 scale with dynamics", scale_dynamics_phase)
    k3 = phase("8 kernel K3", lambda tc: with_edges(
        [kernel_phase(tc, T, N, masked=masked, P=P)
         for masked in (False, True)
         for T, N, P in ((50, 100, 8), (50, 100, 40), (50, 100, 100),
                         (500, 10_000, 8))],
        "sparse", Wds=(0, 8), Ps=(8, 40)))
    launches["dodoor_fused_sparse_masked_locality"] = phase(
        "9 dag testbed", dag_phase)
    launches["dodoor_fused_sparse_locality"] = phase(
        "10 dag scale", dag_scale_phase)
    phase("11 retries testbed", retry_phase)
    phase("12 retries scale", retry_scale_phase, SCALE_CPU_TASKS)
    k5 = phase("13 kernel K5", k5_family_phase)
    k4 = phase("14 kernel K4", k4_family_phase)
    k6 = phase("15 kernel K6", k6_family_phase)
    k7 = phase("16 kernel K7", k7_phase)
    k8 = phase("17 kernel K8", k8_phase)
    launches["flash_attention"] = phase(
        "18 serving tinyllama-1.1b", serving_phase, "tinyllama-1.1b",
        "flash_attention", 4, 1024)
    launches["ssd_chunk"] = phase(
        "19 serving mamba2-1.3b", serving_phase, "mamba2-1.3b", "ssd_chunk",
        2, 1024)
    profiled = phase("20 profiled scale runs", profiled_phase)
    phase("21 sequential oracle", sequential_phase)
    phase("22 batched probing and serving", probing_phase)
    phase("23 trace, cache faults and grids", observability_phase)
    moe = phase("24 MoE serving and the serve launcher", moe_phase)
    fam = phase("25 VLM, hybrid and audio serving", families_phase)
    train = phase("26 training", training_phase)
    fam_train = phase("27 training of every family", family_training_phase)
    sizing = phase("28 sizing and dry-run", sizing_phase,
                   [train and train[3], *(fam_train[2] if fam_train
                                          else [None])])
    bf16 = phase("29 bf16 training", bf16_training_phase)
    print(f"phase walls: {json.dumps(walls)}", flush=True)
    if only:
        print(f"chip_smoke: phases {sorted(only)} passed (partial run: no "
              "result)", flush=True)
        return 0

    launches["flash_attention"] += (moe[0] + fam[0] + train[0]
                                    + fam_train[0]["flash_attention"]
                                    + bf16[0])
    launches["flash_attention_bwd_bf16"] = bf16[1]
    launches["flash_attention_bwd"] = train[1]
    launches["ssd_chunk"] += fam_train[0]["ssd_chunk"]
    launches["ssd_chunk_bwd"] = fam_train[0]["ssd_chunk_bwd"]
    launches["flash_attention_bwd_d256"] = fam_train[0]["flash_attention_bwd"]
    launches["dodoor_choice"] = k5[1]
    launches.update(k4[1])
    launches["rl_score_matrix"] = k6[1]
    kernels = []
    # Each kernel's row at its largest shape (K6 at K = 2; K7 and its
    # backward at tinyllama-1.1b's prefill, K8 at mamba2-1.3b's forward,
    # K8's backward at mamba2-1.3b's training shape, K7's backward at
    # head width 256 at recurrentgemma-2b's prefill, its bf16 form at
    # tinyllama-1.1b's).
    for big in (k1[-1], k2[-1], k3[3], k3[-1], k5[0][-1], k4[0][2],
                k4[0][-1], k6[0][2], k7[0], k8[0], train[2][0],
                *fam_train[1], bf16[2]):
        kernels.append({
            "name": big["name"], "route": "cuda",
            "source": KERNEL_SOURCES.get(big["name"], KERNEL_SOURCE),
            "replaces": KERNEL_REPLACES[big["name"]],
            "launches": launches[big["name"]],
            "max_abs_err": big["max_abs_err"], "ms": big["ms"],
            "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
            "bound_by": big["bound_by"],
            "library_ms": big.get("library_ms")})
    print("profile " + json.dumps({"profiled": profiled}), flush=True)
    print("sizing " + json.dumps(sizing), flush=True)
    print("bf16 " + json.dumps({"bf16": bf16[3]}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
