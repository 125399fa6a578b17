#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card, and check it.

    python3 chip_smoke.py        (from the root of the checkout, one card)

1. Prints the card (name, power limit) and builds the CUDA kernels from
   the sources in this checkout (one nvcc per source, all at once); counts
   the walking kernels' SASS instructions per instance (cuobjdump -sass).
2. Kernel phase: holds each kernel against its plain PyTorch version on
   the card -- the Bellman backup at the reference test shapes, the
   solver's path shape (129, 33, 129) and (4097, 33, 4097), then at the
   edges of its design (T 1 / 63 / 65 / 129 x A 1 / 9 / 33 / 64 / 65 x K
   1 / 255 / 256 / 257 / 4097, batched N 1 / 17 / 108, unaligned h_len
   and bases, negative hso, zero tails); its batched form at the reference
   batched shapes, also against per-spec scalar launches; the serving
   event kernel on a few thousand epochs -- and times each against its
   bound.  Every instance of the event kernel (plain, managed queue,
   adaptive, both; one lane or a grid) is held against the plain walk on
   the inputs of the launch that times it: counts, clocks, sums,
   histograms, surviving queues and records equal.  The Bellman rows also carry the launch floor (an empty kernel
   with the same grid, block and shared memory, built beside the kernels),
   the split, the blocks, the shared memory and the registers from the
   ptxas log.  The first design's times (PREVIOUS_MS, naming their runs)
   are printed on a line of their own, marked as quoted: this run does
   not measure them.
3. Main path, with every launch counter zeroed just before and read just
   after: solve the paper's Table-I point (GoogLeNet on a Tesla P4,
   b_max = 32, rho = 0.7, w2 = 1.6) with the Bellman kernel, then serve
   100 000 decision epochs through the event kernel.
4. Checks: the solve went through one kernel launch per backup; its
   policy equals the float64 banded path on the card and the plain CPU
   path; the same at rho = 0.9; verify_backends (Python event loop vs the
   kernel) at the serving size on a Poisson trace.
4b. Sweep path, counters zeroed just before and read just after:
   sweep_solve with backup="pallas" (every lockstep backup of the f32
   coarse phase one launch of the spec-batched Bellman kernel) over the
   Fig. 5 grid (rho = 0.7, 12 weights), sweep_scaling's 17-point grid at
   rho = 0.3 and 0.7, a rho = 0.9 grid from s_max 32 (regrow rounds) and
   sweep_bank's 9 x 12 lambda x w2 bank, plus the tradeoff_sweep CLI.
   Checks: every batched-RVI call launched the kernel; no guard rung
   fired; every spec equals the scalar f64 solve() on the card (s_max;
   g, W, P within rtol 1e-9; the policy, up to near-ties certified by the
   oracle's own span residual, at most one per spec and four in all, each
   of stationary mass <= 1e-12) and the banded sweep; the bank's table at
   the Table-I point equals the main path's and serves 10^5 epochs
   within 5% of the analytic W and P.  Holds the kernel against its plain
   version and its scalar launches at every shape the sweep launched,
   times it there and profiles one sweep's device busy share.
4c. Poisoned grid: four Table-I specs, one with w2 = NaN, on
   backup="pallas": the sweep completes with that row quarantined and
   failed (the reference's guard ladder), the other rows equal the grid
   without it, and the batched kernel's launch count rose.
4k. The paper's own figures and tables (launch/paper_figures.py: Figs. 3,
   4, 7-10, Tables II-III, App. E) at the benchmarks' full size, every
   solve and sweep with backup="pallas", counters zeroed just before and
   read just after: one bellman_banded launch per backup of every kernel
   RVI call (+1 for its policy), every sweep and accel-ladder call on the
   spec-batched kernel, no guard rung.  Held against the reference's
   full-size numbers (FIG_REF): Fig. 10's smallest acceptable s_max per
   c_o (its search's solves converged wherever the reference's did), then
   s_min acceptable and s_min - 8 not on the float64 banded path on the
   card, Table II's space and time cuts from the kernel's and the f64
   path's iterations (the f64 ones equal to the reference's) beside the
   paper's 63.5% / 98%, the busy share of one Fig. 10 solve; Fig. 3's
   60/60 control-limit and 40/40 Prop. 4 matches; App. E's four counts,
   each breaking spec's policy equal to one f64 banded RVI at its final
   truncation; every sweep spec of Figs. 4, 7, 8, 9 against the scalar f64
   solve() (the sweep phase's near-tie rule), their verdicts, Fig. 8's
   power range and Fig. 9's W per family at rtol 1e-6; Table III's
   baselines' g and the accel ladder's policy matches.  The Bellman
   kernels are held against their plain versions and timed at the phase's
   shapes.
4d. Overload shedding on one server (benchmarks/degraded_frontier.py's
   shedding section, through ServingEngine / simulate_compiled instead of
   the M = 1 fleet), counters zeroed just before and read just after:
   GoogLeNet-P4, b_max 16, waiting room 24, rho 1.2, c_drop 50, w2 1.  The
   drop-cost-aware finite-buffer solve through the Bellman kernel (one
   launch per backup, policy equal to the f64 banded and CPU paths), the
   blind rho 0.7 table, verify_backends with buffer 24, slo 2.0 and
   shed_expired on both tables and both arrival families (decisions,
   latencies, n_shed, n_expired equal), then 4 seeds x 8000 arrivals per
   family through the managed-queue lane.  Gate: aware serves from a
   lower queue and wins MMPP2 goodput, seed-averaged.
4e. The adaptive bank under bursty MMPP (benchmarks/mmpp_bursty.py's
   bursty scenario: rho 0.08 / 0.85, dwell 4000 / 800, w2 0.5, horizon
   40 000, 5 grid points and the mean rate), counters zeroed just before
   and read just after: sweep_bank on the spec-batched kernel;
   verify_backends(scheduler=AdaptiveController) on the first trace, also
   with a finite room; run_grid over 6 seeds x (bank + greedy) and
   run_grid_adaptive over 6 seeds, one launch each, every lane's W + w2 P
   held against the Python engines at rtol 1e-9 and the switch counts
   exactly; events/s of both backends.
4f. MMPP-aware serving (examples/serve_mmpp_exact.py, serve_belief_compiled.py,
   mmpp_bursty.py's exact_modulated section), counters zeroed just before
   and read just after: the exact (phase, queue) solve at rho 0.10 / 0.85,
   dwell 4000 / 800, w2 0.5, s_max 128 up to 384 on the card (float64 torch
   ops), equal to the CPU path (policy, s_max; g, W, P at rtol 1e-9), no
   guard rung, busy share profiled; the per-phase heuristic (solves on the
   Bellman kernel) no better on the exact chain; the K = 1 rail equal to
   the main path's policy.  One 20 000 ms trace served five ways (exact +
   oracle phase, heuristic + oracle, exact + belief argmax, exact + belief
   mix, AdaptiveController(phase_filter=) on a sweep_bank(phases=) bank),
   each through ServingEngine(backend="compiled") and verify_backends.  The
   bursty scenario: the exact_modulated gaps (chain and simulated, 5
   seeds), the belief kernel over the 6-seed batch against its plain
   version on the card (atol 1e-12, argmax rows equal) and against its
   own one-chunk call (C = N, a serial fold), deterministic and equal over
   prefixes bit for bit, timed as its earlier design was (CUDA events
   around one call) and in a CUDA graph, beside the chain floors and the
   earlier time (with the chunks pass B folded exactly), then timed where
   pass B must fold chunks exactly (the batch's times rounded to 1 ms,
   through this filter, a two-phase filter whose E(0) rounds below zero and
   a 3-phase cycle), run_grid with
   belief_argmax and belief_mix (one launch each, W + w2 P of every lane
   against its Python engine at rtol 1e-9).  The mix instance is also held
   and timed on the main path's inputs with two equal phase rows, where it
   must equal the plain lane.
4g. The routed fleet and degraded mode, counters zeroed just before and
   read just after: benchmarks/fleet_frontier.py at its full size (M = 4
   replicas solved at lambda / M on the Bellman kernel against one fat
   server solved at lambda on latency / M; Poisson, MMPP2 and diurnal
   traces of 20 000 arrivals x 4 seeds, each scenario one run_fleet_grid
   launch over the 4 routers, the fat server through simulate_compiled;
   W, P95, power and mean batch printed); every grid cell equal to
   simulate_fleet of its lane; one seed per scenario x 4 routers through
   verify_fleet (PythonFleet against the fleet kernel), and an MMPP-aware
   fleet (per-phase tables, the posterior from the belief kernel, the mix
   rule) through it too; a 16-chunk FleetStream equal to the one-shot run
   on every aggregate; chunked FleetStreams in both belief modes (faults,
   a room of 24) equal to simulate_fleet with one belief_forward call's
   beliefs on every aggregate; examples/serve_fleet.py (M = 8, 20 000 arrivals x 3
   seeds x 4 routers, one launch); benchmarks/degraded_frontier.py (§1
   verify_faults for every router on Poisson and MMPP2 with the moderate
   schedule, buffer 24, slo 2.0, and the no-fault rail; §2 the fault
   matrix, 3 severities x 4 routers x 4 seeds x 8000 arrivals at M = 3;
   §3 aware against blind through the M = 1 fleet with buffer 24, gate:
   aware serves from a lower queue and wins MMPP2 goodput).  Then the
   fleet kernel's one-lane (faults, buffer), grid and mix instances are
   held against their plain walk on the inputs of those launches and
   timed, each beside its chain floor (csrc/chain_floor.cu: the walk's
   dependent chain alone, operands in registers and shared memory, for
   the steps each lane's plain walk took) and the time before its
   redesign (EARLIER_MS, quoted from PERF.md).
4h. Durable sweeps and streams, the on-device samplers and the independent
   simulator, counters zeroed just before and read just after:
   launch/resume_sweep.py --self-preempt with backup="pallas" (SIGTERM
   after the first commit, SweepPreempted, a resume bitwise equal to the
   uninterrupted checkpointed card run in policy, g and h; every chunk
   launched the spec-batched Bellman kernel), a SIGKILL drill in a child
   process resumed by a second child, a CPU checkpoint refused on the
   card, and benchmarks/resilience_overhead.py at its full size in a fresh
   child process (64 specs at rho 0.88, s_max 384, chunk 16, both paths
   warmed, 10 alternating runs a path in fresh directories; gate: the
   checkpointed sweep's median within 5% of the same chunking unsaved;
   FleetStream.save ms a save at 200 000 arrivals, chunk 8000, best of 3).
   FleetStream saved halfway and resumed on the card in the poisson, mmpp2
   and belief modes, equal to the uninterrupted stream on every aggregate.
   mmpp2_times(with_phases=True) over the bursty scenario's 6 lanes (one
   launch of the MMPP sampler kernel) into run_grid(phases=) and
   belief_forward (every lane's arrivals served); poisson_times and
   diurnal_times into simulate_compiled (rates within 5% / 10%).
   benchmarks/fig6_percentiles.py at its full size through the port's
   simulate (150 000 epochs; static-8 and the SMDP at w2 1.6 and 2.2,
   solved on the Bellman kernel; P, W, P50, P90, P95 printed beside the
   paper's anchors; W and P within 2% of evaluate_policy and Little's law
   within 2%, asserted) and simulate_events(backend="compiled").  Then the
   MMPP sampler and simulator kernels are held against their plain walks
   on the inputs of the launches that time them, exactly; each beside its
   chain floor (the walk's dependent chain alone: the simulator's run's E
   epochs, the sampler's n steps) and its time before the redesign.
5. Attention kernels: flash (prefill; bf16 on the tensor cores, f32 on
   the CUDA cores) and split-K decode held against their plain versions
   at the reference test shapes (f32 at 2e-5, bf16 at 2e-2, softcap 50
   included) and at the serving path's shapes in bf16 and f32, and timed
   there against their bound and torch's SDPA; then at the edge cases of
   their designs (lengths off the 64-row tiles, causal rows that see no
   key, every head size, softcap, q / k / v as views of one fused qkv, a
   misaligned view refused; decode lengths 0, 1, S and inside a split,
   4096-deep caches at b = 1 and 8, b x KV >= the SM count).  Then both
   under the local layers' masks: flash at Gemma2-9B's 16 / 8 x 256 and
   -27B's 32 / 16 x 128 heads over a 6144-token prefill under the 4096
   window (softcap 50), Llama-4's 40 / 8 x 128 over 9216 tokens under its
   8192 chunk, an append of 512 rows onto a 4096-row cache under the
   window; decode at Gemma2-9B's and Llama-4's heads over 8192- / 9216-deep
   caches at ragged lengths below, at and past the window and the chunk
   boundary; edge cases with windows and chunks below a 64-key block and
   not multiples of one, rows that see no key, causal off.  Each held at
   2e-5 (f32) and 2e-2 (bf16), the local shapes timed in bf16 beside the
   plain version, SDPA with the equivalent boolean mask and the bound of
   the masked work (the visible pairs; the keys the span holds).
6. Whole-model checks in f32: the reduced Qwen2.5-32B on the card
   (kernels) against the CPU (plain versions) from the same weights, and
   Qwen2.5-32B at full width with 2 layers, decode path (decode kernel)
   against a fresh prefill (flash kernel), both at atol 3e-4.
7. LLM serving path, counters zeroed just before and read just after:
   Qwen2.5-32B at its published width with 8 of its 64 layers (bf16,
   random weights from a seed) -- l(b) profile for b = 1..8 (prompt 128, 16 tokens),
   SMDP solve on it through the Bellman kernel, then 32 Poisson requests
   at rho = 0.6 served in wall-clock executor mode by the SMDP, greedy and
   static schedulers.  Checks one flash launch per layer per segment, one
   decode launch per layer per decode step, one Bellman launch per backup.
   Profiles of a prefill and of decode steps say where their device time
   goes, by kernel.
8. Phase 4i, the Mamba2 hybrid: the SSD scan kernel against its plain
   version (S 1 / 7 / 128 / 129 / 300 x chunk 8 / 128 x b 1 / 8, zero and
   random incoming state, f32 at 2e-5 and bf16 at 2e-2, at Zamba2's 64
   heads of 64 x state 64 and a reduced shape; in place) and timed at the
   serving path's prefill (8 x 128) and decode (8 x 1), the first
   design's times quoted in the log beside them; bf16 also held at 1e-4,
   against a control that rounds the carried state to bf16 and must miss
   it; flash and decode
   attention at Zamba2's 32 / 32 heads of 64, held and timed beside SDPA;
   the reduced Zamba2 in f32 on the card against the CPU (launch counts
   exact), full width at depth 7 (decode path against fresh prefills);
   then Zamba2-1.2B at its published width with 12 of its 38 layers (the
   shared block twice, bf16) through serve_llm.run_pipeline with the
   Qwen path's constants, launch counts exact (flash 2 x segments, decode
   2 x 15 x segments, SSD 12 x 16 x segments with the first pass 12 x
   segments, Bellman the solve's backups), peak memory, and a profiled
   b = 8 prefill and decode step with the SSD kernels' share.
8b. Phase 4l, local masks and experts, counters zeroed just before and
   read just after each model's serving run: Gemma2-9B at its published
   width with 14 of its 42 layers (7 local / global pairs, bf16, random
   weights) and Llama-4 Scout at its published width with 4 of its 48
   layers (3 chunked-local, 1 full; 16 experts top-1 plus the shared
   expert) through serve_llm.run_pipeline
   with the Qwen path's constants, launch counts exact (flash one a layer
   a segment, decode one a layer a step, Bellman the solve's backups),
   peak memory, each model freed before the next.  Long contexts in f32 at full width, b = 1, each decode
   path's logits held to a one-shot forward of the same tokens at 3e-4:
   Gemma2-9B at 8 layers, a 6144-token prefill, a 512-token append (flash
   over the cache's prefix) and 32 decode steps past the window; Llama-4
   at 4 layers with drop-free experts, an 8176-token prefill and 32
   decode steps across the 8192 chunk boundary against a 9216-token
   forward.  Grok-1 at full width with 1 layer in f32 (8 experts top-2,
   softcap 30): the kernel path against the plain path on the card.
8c. Phase 4m, RWKV6 (Finch): the WKV6 scan kernel against its plain
   version at 2e-5 of the largest |entry| of y and of the final state (S 1
   / 2 / 16 / 17 / 32 / 33 / 63 / 64 / 65 / 1000 x P 16 / 32 / 64 x B H 1
   / 680, decays 0.9999 to 6e-4, a nonzero bonus, zero and random incoming
   state, f32 and bf16 r / k / v; in place) and at the serving path's
   prefill (8 x 128, 40 heads of 64), decode (8 x 1) and b 1 x 2048, timed
   at the first two beside its plain version and its bound.  Then
   RWKV6-3B at its published width with 16 of its 32 layers (bf16, random
   weights) through serve_llm.run_pipeline with the
   Qwen path's constants, counters zeroed just before and read just after:
   one WKV6 launch a layer a step (16 x 16 a segment), Bellman the solve's
   backups, peak memory.  Long context in f32 at full width, 4 layers, b =
   1: a 2048-token prefill, a 128-token continuation from the cache and 32
   decode steps, each position's logits held to a one-shot forward of the
   2208 tokens at 3e-4.  Last, 2 layers in f32 with the bonus, the decay
   base and ln_x drawn from a seed: the kernel path against the plain path
   on the card (b 2, prompt 256, 8 steps), logits at 3e-4, tokens equal.
8d. Phase 4n, Whisper-small and Qwen2-VL-7B: both attention kernels held
   against their plain versions (bf16, 2e-2) and timed beside SDPA and
   their bound at the shapes the two paths give them at b = 8 -- Whisper's
   encoder (1500 x 1500, non-causal, 12 / 12 x 64), cross-attention
   prefill (128 rows over 1500 keys) and decode (lengths 1500), K / V as
   views of one projection, Qwen2-VL's prefill (256 patches + 128 tokens,
   28 / 4 x 128: G = 7) and decode (the edge lists of phase 5 hold them in
   f32 and bf16 too).  Then, counters zeroed just before and read just
   after each run, Whisper-small at its published config (all 12 + 12
   layers, 1500 stub frames a request) and Qwen2-VL-7B at its published
   width with VLM_SERVE_LAYERS of its 28 layers (256 stub patches a
   request) through serve_llm.run_pipeline with the Qwen path's traffic,
   launch counts exact (Whisper: flash 12 + 2 x 12 a segment, decode 2 x
   12 a step; Qwen2-VL: flash one a layer a segment, decode one a layer a
   step; Bellman the solve's backups), peak memory.  Last, f32 at full
   width, b 2 (Whisper whole, Qwen2-VL at 2 layers): prefill and 8 greedy
   decode steps through the kernels, each position's logits held to a
   one-shot forward at 3e-4, and to the plain path on the card (logits at
   3e-4, greedy tokens equal).
9. Phase 4j, training (examples/train_100m.py --full through the port):
   the attention backward kernel (csrc/flash_attention_bwd.cu) against
   autograd through the plain attention at the path's shape (b 8 x 256,
   8 / 4 heads of 64, causal, f32), at Qwen2.5-32B's 40 / 8 x 128 and
   Zamba2's 32 / 32 x 64 in bf16, and over 120 edge cases in f32 and bf16
   (Sq != Sk, lengths off the tiles, G 1 / 2 / 5 / 7 / 8, D 64 / 128 / 256,
   softcap, causal on and off), at f32 1e-4 and bf16 2e-2 of each gradient's
   largest |entry|; timed beside its plain version's and SDPA's backward
   alone, the first design's times quoted in the log beside them.  Then
   qwen2.5-100m at full width with 2 layers: lm_loss
   gradients through the kernels against the CPU's plain versions (1e-4
   of each tensor's largest |gradient|).  Then the example itself,
   counters zeroed just before and read just after: qwen2.5-100m (12
   layers, d 512, 8 / 4 x 64, SwiGLU 2048, vocab 32768, f32) for 150 of
   the example's 300 steps of 8 x 256 with AdamW at lr 6e-4, data seed 17,
   an async checkpoint every 30 steps (the example's steps / 5); the loss
   must fall; launches exact (flash 2 x 12 a
   step -- the forward and its remat recompute -- and 12 backward calls
   of 3 kernels a step); ms a step, tokens/s, peak memory.  Then the
   resume drill: a fresh Trainer on a copy of the run's checkpoint
   directory without the steps after 120, resumed to 150, losses (rtol
   1e-6) and parameters (atol 1e-6) equal to the uninterrupted run's.
   Last, a profiled train step (busy share, time by kernel group).  TF32
   stays off (asserted).
9b. Phase 4o, training through the masked and cross attention: the
   backward kernel under sliding windows and chunks against its plain
   version over 864 edge cases in f32 and bf16 (window 1 / 16 / 100, chunk
   1 / 16 / 64; (Sq, Sk) (100, 100), (70, 130), (130, 70) -- rows that see
   no key; G 1 / 2 / 5 / 7, D 64 / 128 / 256, softcap and causal on and
   off; f32 1e-4, bf16 2e-2 of each gradient's largest |entry|, a gradient
   the plain version gives as exactly zero at the largest |entry| of the
   three); then timed in bf16 at the training paths' shapes -- Gemma2-9B's
   local layer (1 x 8192, 16 / 8 x 256, window 4096, softcap 50), Llama-4
   Scout's (1 x 9216 across the 8192 chunk edge, 40 / 8 x 128), Whisper's
   encoder (8 x 1500 x 1500, non-causal) and cross-attention (8 x 128 over
   1500 keys, K / V views of one projection), Qwen2-VL (8 x 384, 28 / 4 x
   128, causal) -- beside the plain backward (a kv-head group at a time
   where its scores exceed 4 GB), SDPA's backward (the boolean mask, no
   cap) and the bound of the visible pairs, held at 2e-2 and over 1500
   keys also at 1e-2 in relative L2 norm.  Then lm_loss with remat through
   the kernels on the card against the plain versions on the CPU from the
   same weights (loss rtol 1e-5, every gradient within 1e-4 of its largest
   |entry|), launches exact (the forward twice and the backward once an
   attention call): the six families' reduced configs on 48 tokens (window
   and chunk 32 bite), then at full width Whisper-small whole (b 2 x 64 +
   1500 frames), Qwen2-VL-7B at 2 of 28 layers (b 2 x (256 patches + 64)),
   Gemma2-9B at 2 of 42 (a local and a global layer) and Llama-4 Scout at 1
   of 48 (a chunked MoE layer), b 2 x 64.  Last, Whisper-small whole
   trained on the card for 40 AdamW steps of 8 x 128 tokens with stub
   frames: the loss falls, launches exact, ms a step and tokens/s.
10. Prints each phase's wall time and their summary, a `kernels` JSON line,
   then the one-line verdict.

Any failed check raises, so the exit code is not 0.  Without CUDA it exits
with 2 and prints no result.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: NVIDIA H100 SXM data sheet (dense, no sparsity) -- see PERF.md
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # CUDA cores
F64_FLOPS = 34e12  # CUDA cores
BF16_FLOPS = 989e12  # tensor cores, dense

RHO, W2, B_MAX, S_MAX = 0.7, 1.6, 32, 128
N_EPOCHS = 100_000
BELLMAN_TEST_SHAPES = [(64, 9, 40), (200, 33, 170), (128, 33, 128), (300, 17, 513)]
BATCHED_TEST_SHAPES = [(1, 64, 9, 40), (3, 130, 33, 130), (4, 128, 17, 260)]
PATH_SHAPE = (S_MAX + 1, B_MAX + 1, S_MAX + 1)  # (T, A, K) of the Table-I solve
LARGE_SHAPE = (4097, 33, 4097)  # solve()'s max_s_max = 4096
SWEEP_SPECS = 17  # a 17-point w2 grid: the batched kernel's sweep launch
LLM_SOLVE_SHAPE = (65, 9, 65)  # (T, A, K) of the LLM path's solve (b_max 8, s_max 64)
#: the first design of csrc/bellman.cu on an NVIDIA H100 80GB HBM3 at 700 W,
#: by shape: (ms, the run that timed it; PERF.md section 6).  Quoted on a
#: log line of their own, never in the `kernels` line: not measured here.
PREVIOUS_MS = {
    (129, 33, 129): (0.011422, "chip_smoke.py at commit c670012"),
    (4097, 33, 4097): (0.212861, "chip_smoke.py at commit c670012"),
    (17, 129, 33, 56): (0.008865, "chip_smoke.py at commit bf7b32a, second run"),
    (108, 129, 33, 66): (0.022857, "chip_smoke.py at commit bf7b32a, second run"),
    (17, 129, 33, 129): (0.012543, "chip_smoke.py at commit bf7b32a, second run"),
}
#: edges of the Bellman kernel's design (tests/test_torch_cuda.py's): T off
#: its 5-state lanes and t tiles, A around its 3-action warps, K around its
#: 256-wide chunks and 4097; batched N = 1, 17 and 108
BELLMAN_EDGE_T, BELLMAN_EDGE_A, BELLMAN_EDGE_K = ((1, 63, 65, 129), (1, 9, 33, 64, 65),
                                                  (1, 255, 256, 257, 4097))
BELLMAN_EDGE_BATCHED = [(1, 65, 9, 65), (17, 63, 33, 257), (17, 129, 65, 56),
                        (108, 129, 33, 66), (108, 1, 1, 1), (17, 65, 64, 4097)]
#: an empty kernel, launched with a Bellman launch's grid, block and shared
#: memory: the launch floor of that grid (built beside the kernels)
EMPTY_CU = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int gx, int gy, int gz, int threads, long long smem,
                            void* stream) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  empty_kernel<<<dim3(gx, gy, gz), threads, smem, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""

# --- the sweep path (examples/tradeoff_sweep.py, sweep_scaling's grid, a bank)
FIG5_W2 = [0.0, 0.2, 0.5, 0.8, 1.3, 1.6, 2.2, 3.5, 5.0, 8.0, 15.0, 50.0]
SCALING_W2 = [15.0 * i / 16 for i in range(17)]  # np.linspace(0, 15, 17)
BANK_RHOS = [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9]
REGROW_W2, REGROW_S_MAX = [0.0, 1.6, 8.0], 32
#: a sweep policy may differ from the scalar f64 oracle's only at certified
#: near-ties: at most one state per spec and MAX_TIES over the phase, each
#: of stationary mass <= TIE_MASS.  An H100 80GB HBM3 run showed 2 such
#: states over the 157 specs, of mass 4.2e-18 and 2.7e-17 (PERF.md).
MAX_TIES_PER_SPEC, MAX_TIES, TIE_MASS = 1, 4, 1e-12

# --- the LLM serving path (examples/serve_llm.py on Qwen2.5-32B) ---------
LLM_ARCH = "qwen2.5-32b"
#: the serving path's depth: Qwen2.5-32B at its published width with 8 of
#: its 64 layers (a depth cut that keeps the script inside its time limit on
#: a slow host, with phases 4l and 4o beside it)
LLM_LAYERS = 8
LLM_B_MAX, LLM_PROMPT, LLM_GEN, LLM_REQUESTS, LLM_RHO = 8, 128, 16, 32, 0.6
#: tests/test_kernels.py's attention shapes
FLASH_TEST_SHAPES = [(2, 64, 64, 4, 2, 16, True, None), (1, 33, 70, 4, 4, 8, False, None),
                     (2, 128, 128, 8, 2, 32, True, 50.0), (1, 17, 128, 2, 1, 64, True, None)]
DECODE_TEST_SHAPES = [(2, 300, 8, 2, 16), (3, 128, 4, 4, 32), (1, 77, 8, 1, 64),
                      (4, 64, 16, 4, 8)]
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: bf16 attention over Whisper-small's CROSS_KEYS (1500) keys also meets
#: ||got - want||_2 <= ATTN_REL_BF16 ||want||_2: there a typical |o| is
#: about sqrt(e / 1500) = 0.04, so 2e-2 alone passes a wrong last key tile.
#: Its 36 padding keys scored as 0 move the output by about 36 / (1500
#: e^0.5) = 1.5 % of its norm, its 28 ragged keys dropped by about
#: sqrt(28 / 1500) = 14 %
CROSS_KEYS, ATTN_REL_BF16 = 1500, 1e-2
#: the kernel each wrapper's C entry point launches, by dtype
#: (kernels/csrc/flash_attention.cu, decode_attention.cu)
VARIANTS = {"flash_attention": {"bfloat16": "wgmma bf16", "float32": "cuda-core f32"},
            "decode_attention": {"bfloat16": "split-K cuda-core", "float32": "split-K cuda-core"}}
#: edge cases of the tensor-core flash kernel: lengths off its 64-row tiles,
#: causal rows that see no key (Sq > Sk), several key tiles, softcap, every
#: head size; Whisper's encoder (1500 x 1500 non-causal: 1500 is off the
#: tiles on both axes) and cross-attention prefill (128 rows over 1500
#: keys), Qwen2-VL's prefill at G = 7 (28 / 4 heads of 128)
FLASH_EDGE_SHAPES = [(2, 100, 100, 4, 2, 64, True, None), (1, 70, 130, 8, 2, 128, False, None),
                     (2, 150, 90, 4, 1, 64, True, None), (1, 130, 70, 2, 2, 128, True, None),
                     (2, 80, 80, 4, 2, 128, True, 30.0), (2, 300, 300, 8, 2, 128, True, None),
                     (2, 200, 260, 4, 2, 8, True, 30.0), (2, 1500, 1500, 12, 12, 64, False, None),
                     (2, 128, 1500, 12, 12, 64, False, None),
                     (2, 384, 384, 28, 4, 128, True, None)] + [
    (1, 96, 96, 4, 2, d, True, None) for d in (8, 16, 32, 64, 128, 256)]
#: edge cases of the split-K decode kernel, (B, S, H, KV, D, lengths or a
#: tag): lengths 0, 1, S and inside a split; 4096-deep caches (many splits)
#: at b = 1 and 8; b x KV >= the SM count (one split); G = 16 and 3, D = 8
#: and 256; Whisper's cross-attention decode ("cross": lengths all S = 1500,
#: K / V the halves of one (B, S, 2 KV D) projection, row stride 2 KV D);
#: Qwen2-VL's G = 7
DECODE_EDGE_CASES = [(4, 300, 8, 2, 64, "edges"), (1, 4096, 40, 8, 128, "random"),
                     (8, 4096, 40, 8, 128, "random"), (17, 144, 40, 8, 128, "random"),
                     (2, 200, 16, 1, 32, [200, 37]), (2, 200, 12, 4, 256, [200, 37]),
                     (2, 200, 6, 2, 8, [200, 37]), (2, 1500, 12, 12, 64, "cross"),
                     (2, 400, 28, 4, 128, [400, 129])]
LOGIT_ATOL = 3e-4  # tests/test_models.py's decode-vs-forward bound


def log(*parts):
    print(*parts, flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def bound(bytes_moved, flops, flops_rate):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(torch, fn, reps, side=None):
    """Device time per call: `reps` calls captured in one CUDA graph (on
    the stream `side` when given)."""
    capture = side
    side = side or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=capture):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def call_ms(torch, fn, reps):
    """Time per call of back-to-back calls, host enqueue included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def start_empty_build():
    """nvcc of EMPTY_CU into build/, started now; finish_empty_build waits."""
    from repro_torch.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "launch_floor.cu"
    cu.write_text(EMPTY_CU)
    so = _build.BUILD_DIR / f"launch_floor-{os.getpid()}.so"
    proc = subprocess.Popen([_build._nvcc(), *_build.BASE_FLAGS, "-o", str(so), str(cu)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, so


def finish_empty_build(started):
    import ctypes

    proc, so = started
    out, _ = proc.communicate()
    check(proc.returncode == 0, f"nvcc failed for the launch-floor kernel:\n{out}")
    fn = ctypes.CDLL(str(so)).empty_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.c_void_p]
    return fn


def bellman_geometry(N, T, A, K):
    """(split, grid x, y, z, threads, dynamic shared memory bytes) of the
    Bellman kernel's launch for N specs of (T, A, K) on this card."""
    import ctypes

    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import bellman

    split = bellman._split_plan(N, T, A, K, bellman._sm_count(torch.device("cuda")))
    geo = (ctypes.c_longlong * 5)()
    fn = _build.function("bellman", "bellman_banded_geometry", ctypes.c_int,
                         [ctypes.c_int] * 5 + [ctypes.c_void_p])
    check(fn(N, T, A, K, split, geo) == 0, f"bellman geometry {N, T, A, K}")
    return (split,) + tuple(int(x) for x in geo)


def launch_floor_ms(torch, N, T, A, K, reps):
    """Device time of an empty kernel with the Bellman launch's grid, block
    and shared memory, in the same CUDA-graph harness as the kernel."""
    _, gx, gy, gz, threads, smem = bellman_geometry(N, T, A, K)
    return device_ms(torch, lambda: check(EMPTY_LAUNCH[0](
        gx, gy, gz, threads, smem, torch.cuda.current_stream().cuda_stream) == 0,
        "empty kernel launch"), reps)


EMPTY_LAUNCH = []  # the empty kernel's C entry point, once built


def bellman_inputs(torch, np, rng, T, A, K, n=None):
    lead = () if n is None else (n,)
    h = rng.normal(size=lead + (T + K,)) * 10
    logits = rng.normal(size=lead + (A, K))
    pmfs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    tails = rng.uniform(size=lead + (T, A))
    hso = rng.normal(size=lead) * 3 if n is not None else np.float64(2.5)
    return [torch.as_tensor(x, dtype=torch.float32, device="cuda")
            for x in (h, pmfs, tails, hso)]


def batched_check(torch, np, rng, N, T, A, K):
    """The spec-batched Bellman kernel at (N, T, A, K) against its plain
    version (atol 1e-4, rtol 1e-5) and against N launches of the scalar
    kernel (1e-5, 1e-6); returns the max abs error against the plain one."""
    from repro_torch.kernels import bellman

    args = bellman_inputs(torch, np, rng, T, A, K, n=N)
    got = bellman.bellman_banded_batched(*args)
    want = bellman.bellman_banded_batched_ref(*args)
    torch.cuda.synchronize()
    e = (got - want).abs().max().item()
    check(torch.allclose(got, want, atol=1e-4, rtol=1e-5),
          f"bellman_banded_batched {N, T, A, K} vs plain: {e}")
    for n in range(N):
        one = bellman.bellman_banded(*(x[n] for x in args))
        check(torch.allclose(got[n], one, atol=1e-5, rtol=1e-6),
              f"bellman_banded_batched {N, T, A, K} spec {n} vs scalar")
    log(f"bellman_banded_batched {N}x{T}x{A}x{K}: max_abs_err={e:.3e} "
        "(1e-4/1e-5 vs plain, 1e-5/1e-6 vs scalar launches) ok")
    return e


def batched_row(torch, np, rng, N, T, A, K, reps=100):
    """Times of the spec-batched Bellman kernel at (N, T, A, K): kernel,
    plain version, the torch.bmm library call, and the bound."""
    from repro_torch.kernels import bellman

    h, p, t, hso = bellman_inputs(torch, np, rng, T, A, K, n=N)
    ms = device_ms(torch, lambda: bellman.bellman_banded_batched(h, p, t, hso), reps)
    plain = device_ms(torch, lambda: bellman.bellman_banded_batched_ref(h, p, t, hso), reps)
    lib = device_ms(torch, lambda: torch.bmm(h.unfold(1, K, 1)[:, :T], p.transpose(1, 2)), reps)
    floor = launch_floor_ms(torch, N, T, A, K, reps)
    split, gx, _, gz, threads, smem = bellman_geometry(N, T, A, K)
    b_ms, b_by = bound(4 * N * ((T + K) + A * K + 2 * T * A + 1),
                       N * (2 * T * A * K + 2 * T * A), F32_FLOPS)
    log(f"bellman_banded_batched {N}x{T}x{A}x{K}: kernel_ms={ms:.6f} plain_ms={plain:.6f} "
        f"library_ms={lib:.6f} bound_ms={b_ms:.6f} ({b_by}) launch_floor_ms={floor:.6f}; "
        f"split {split}, {gx * gz} blocks of {threads} threads, {smem} B shared")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                launch_floor_ms=floor, shape=[N, T, A, K], split=split,
                blocks=gx * gz, threads=threads, smem_bytes=smem)


def bellman_row(torch, np, rng, T, A, K, reps):
    """Times of the scalar Bellman kernel at (T, A, K): kernel (device time in
    a CUDA graph), one wrapper call, plain version, the torch.matmul library
    call, the launch floor, and the bound."""
    from repro_torch.kernels import bellman

    h, p, t, hso = bellman_inputs(torch, np, rng, T, A, K)
    ms = device_ms(torch, lambda: bellman.bellman_banded(h, p, t, hso), reps)
    wrapper_ms = call_ms(torch, lambda: bellman.bellman_banded(h, p, t, hso), reps)
    plain = device_ms(torch, lambda: bellman.bellman_banded_ref(h, p, t, hso), reps)
    lib = device_ms(torch, lambda: torch.matmul(h.unfold(0, K, 1)[:T], p.T), reps)
    floor = launch_floor_ms(torch, 1, T, A, K, reps)
    split, gx, _, _, threads, smem = bellman_geometry(1, T, A, K)
    b_ms, b_by = bound(4 * ((T + K) + A * K + 2 * T * A + 1),
                       2 * T * A * K + 2 * T * A, F32_FLOPS)
    log(f"bellman_banded {T}x{A}x{K}: kernel_ms={ms:.6f} call_ms={wrapper_ms:.6f} "
        f"plain_ms={plain:.6f} library_ms={lib:.6f} bound_ms={b_ms:.6f} ({b_by}) "
        f"launch_floor_ms={floor:.6f}; split {split}, {gx} blocks of {threads} "
        f"threads, {smem} B shared")
    return dict(ms=ms, call_ms=wrapper_ms, plain_ms=plain, library_ms=lib,
                bound_ms=b_ms, bound_by=b_by, launch_floor_ms=floor,
                shape=[T, A, K], split=split, blocks=gx, threads=threads,
                smem_bytes=smem)


def bellman_registers():
    """Registers a thread of the Bellman kernel, from its -Xptxas -v log
    (None when the library was built before this process)."""
    import re

    from repro_torch.kernels import _build

    found = re.findall(r"Used (\d+) registers", _build.build_logs.get("bellman", ""))
    return int(found[0]) if found else None


def bellman_edge_phase(torch, np):
    """The Bellman kernel at the edges of its design, against its plain
    version (1e-4 / 1e-5); batched launches also against scalar ones (1e-5 /
    1e-6).  Unaligned h_len and bases, negative hso and zero tails among the
    cases.  Returns the largest error against the plain versions."""
    from repro_torch.kernels import bellman

    def inputs(seed, N, T, A, K, extra, h_off, p_off, neg, zero_tails):
        rng = np.random.default_rng(seed)
        h = rng.normal(size=(N, T + K - 1 + extra)) * 10
        logits = rng.normal(size=(N, A, K))
        pmfs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        tails = np.zeros((N, T, A)) if zero_tails else rng.uniform(size=(N, T, A))
        hso = rng.normal(size=N) * 3 + (-5.0 if neg else 5.0)

        def at(x, off):  # x at a base `off` words past a 16-byte boundary
            buf = torch.zeros(x.size + 4, dtype=torch.float32, device="cuda")
            view = buf[off:off + x.size].view(x.shape)
            view.copy_(torch.as_tensor(x, dtype=torch.float32))
            return view

        return at(h, h_off), at(pmfs, p_off), at(tails, 0), at(hso, 0)

    worst, n = 0.0, 0
    for T in BELLMAN_EDGE_T:
        for A in BELLMAN_EDGE_A:
            for K in BELLMAN_EDGE_K:
                i = T + A + K
                h, p, t, so = (x[0] for x in inputs(i, 1, T, A, K, 1 + i % 3, i % 4,
                                                    (i // 4) % 4, i % 2 == 0, i % 5 == 0))
                got = bellman.bellman_banded(h, p, t, so)
                want = bellman.bellman_banded_ref(h, p, t, so)
                torch.cuda.synchronize()
                e = (got - want).abs().max().item()
                check(torch.allclose(got, want, atol=1e-4, rtol=1e-5),
                      f"bellman_banded edge {T, A, K}: max abs err {e}")
                worst, n = max(worst, e), n + 1
    for N, T, A, K in BELLMAN_EDGE_BATCHED:
        args = inputs(N + T + K, N, T, A, K, 2, 1, 3, True, N == 1)
        got = bellman.bellman_banded_batched(*args)
        want = bellman.bellman_banded_batched_ref(*args)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        check(torch.allclose(got, want, atol=1e-4, rtol=1e-5),
              f"bellman_banded_batched edge {N, T, A, K}: max abs err {e}")
        for i in range(N):
            one = bellman.bellman_banded(*(x[i] for x in args))
            check(torch.allclose(got[i], one, atol=1e-5, rtol=1e-6),
                  f"bellman_banded_batched edge {N, T, A, K} spec {i} vs scalar")
        worst, n = max(worst, e), n + 1
    log(f"bellman edges: {n} cases (T {BELLMAN_EDGE_T} x A {BELLMAN_EDGE_A} x K "
        f"{BELLMAN_EDGE_K}; batched {BELLMAN_EDGE_BATCHED}; unaligned h_len and bases, "
        f"negative hso, zero tails) max_abs_err={worst:.3e} (1e-4/1e-5 vs plain, "
        "1e-5/1e-6 batched vs scalar) ok")
    return worst


def kernel_phase(torch, np):
    from repro_torch.core import GOOGLENET_P4_LATENCY
    from repro_torch.core.policies import q_policy
    from repro_torch.kernels import bellman
    from repro_torch.serving import simulate_compiled

    rng = np.random.default_rng(0)
    rows = {}

    # --- Bellman backup, scalar form -------------------------------------
    err = 0.0
    for T, A, K in BELLMAN_TEST_SHAPES + [PATH_SHAPE, LARGE_SHAPE]:
        args = bellman_inputs(torch, np, rng, T, A, K)
        got = bellman.bellman_banded(*args)
        want = bellman.bellman_banded_ref(*args)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        check(torch.allclose(got, want, atol=1e-4, rtol=1e-5),
              f"bellman_banded {T, A, K}: max abs err {e}")
        err = max(err, e)
        log(f"bellman_banded {T}x{A}x{K}: max_abs_err={e:.3e} (atol 1e-4, rtol 1e-5) ok")
    edge_err = bellman_edge_phase(torch, np)
    err = max(err, edge_err)

    path_row = bellman_row(torch, np, rng, *PATH_SHAPE, reps=200)
    large_row = bellman_row(torch, np, rng, *LARGE_SHAPE, reps=20)
    llm_row = bellman_row(torch, np, rng, *LLM_SOLVE_SHAPE, reps=200)
    rows["bellman_banded"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/bellman.cu",
        replaces="src/repro/kernels/bellman.py:66", max_abs_err=err,
        **path_row, large=large_row, other_shapes=[llm_row],
        registers=bellman_registers(),
    )

    # --- Bellman backup, spec-batched form ---------------------------------
    err_b = max(batched_check(torch, np, rng, *shape) for shape in BATCHED_TEST_SHAPES)
    rows["bellman_banded_batched"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/bellman.cu",
        replaces="src/repro/kernels/bellman.py:131", max_abs_err=max(err_b, edge_err),
        **batched_row(torch, np, rng, SWEEP_SPECS, *PATH_SHAPE),
        registers=bellman_registers(),
    )

    # --- serving event kernel ----------------------------------------------
    means = np.array([0.0] + [float(GOOGLENET_P4_LATENCY(b)) for b in range(1, B_MAX + 1)])
    lam = RHO * B_MAX / float(means[B_MAX])
    # long enough that the 5000-epoch budget, not the trace, ends the run
    trace = np.cumsum(np.random.default_rng(1).exponential(1.0 / lam, 30_000))
    table = q_policy(8, S_MAX, B_MAX)
    small = {}
    for dev in ("cuda", "cpu"):
        small[dev] = simulate_compiled(
            table, trace, means=means, b_max=B_MAX, max_epochs=5000,
            record=True, device=dev,
        )
    c, r = small["cuda"], small["cpu"]
    check(np.array_equal(c.batch_sizes, r.batch_sizes), "serve_scan batch sizes")
    lat_err = float(np.max(np.abs(c.latencies - r.latencies)))
    check(lat_err <= 1e-9, f"serve_scan latencies off by {lat_err}")
    log(f"serve_scan {c.n_epochs} epochs: batches equal, max latency err {lat_err:.3e} "
        "(<= 1e-9) ok")

    rows["serve_scan"] = dict(max_abs_err=lat_err)
    return rows


SCAN_SOURCE = "src/repro_torch/kernels/csrc/serve_scan.cu"
SCAN_REPLACES = ("src/repro/serving/compiled.py:328 (_scan_core{}: a lax.scan, "
                 "not a Pallas kernel)")


def scan_inputs(torch, np, tables, arrivals, draws, means, zeta, *,
                deadlines=None, adaptive=None):
    """The event kernel's CPU tensors for (P, K, L) tables and (S, size)
    padded traces, as serving.compiled builds them (default edges, phase
    0, no deadlines unless given)."""
    from repro_torch.serving.compiled import default_hist_edges

    t = lambda x, dt: torch.as_tensor(np.ascontiguousarray(x), dtype=dt)  # noqa: E731
    args = (t(tables, torch.int64), t(arrivals, torch.float64),
            None if deadlines is None else t(deadlines, torch.float64),
            t(np.zeros(arrivals.shape), torch.int64), t(draws, torch.float64),
            t(means, torch.float64), t(zeta, torch.float64),
            t(default_hist_edges(means), torch.float64))
    ad = None
    if adaptive is not None:
        ad_f, ad_i = adaptive.lowered()
        ad = (t(ad_f, torch.float64), t(ad_i, torch.int64))
    return args, ad


def scan_check(torch, np, name, args, kw, adaptive=None, beliefs=None, reps=3):
    """One instance of the event kernel on the card against its plain
    version on the same inputs: counts, clocks, sums, histograms, surviving
    queues and records equal.  Returns the row's measured numbers."""
    from repro_torch.kernels import serve_scan as ss

    cuda = lambda x: None if x is None else x.cuda()  # noqa: E731
    gargs = [cuda(a) for a in args]
    gad = None if adaptive is None else tuple(cuda(a) for a in adaptive)
    gbel = cuda(beliefs)
    out = ss.serve_scan(*gargs, adaptive=gad, beliefs=gbel, **kw)  # builds and warms
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ss.serve_scan(*gargs, adaptive=gad, beliefs=gbel, **kw)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    t0 = time.perf_counter()
    ref = ss.serve_scan_ref(*args, adaptive=adaptive, beliefs=beliefs, **kw)
    plain = (time.perf_counter() - t0) * 1e3
    got = ss.ScanOut(*(None if x is None else x.cpu() for x in out))
    check(torch.equal(got.agg_i, ref.agg_i), f"{name}: counts differ from the plain version")
    check(torch.equal(got.hist, ref.hist), f"{name}: histograms differ")
    check(torch.allclose(got.agg_f, ref.agg_f, rtol=0, atol=0, equal_nan=True),
          f"{name}: clocks or sums differ from the plain version")
    err = (got.agg_f - ref.agg_f).nan_to_num(0.0).abs().max().item()
    col = {k: i for i, k in enumerate(ss.AGG_I)}
    for lane, row in enumerate(ref.agg_i.tolist()):
        n_srv, n_eps = row[col["n_served"]], row[col["n_epochs"]]
        if ref.queue is not None:
            h, tl = row[col["head"]], row[col["tail"]]
            check(torch.equal(got.queue[lane, h:tl], ref.queue[lane, h:tl]),
                  f"{name}: surviving queue of lane {lane} differs")
        if ref.rec_a is not None:
            check(torch.equal(got.rec_a[lane, :n_eps], ref.rec_a[lane, :n_eps]),
                  f"{name}: decisions of lane {lane} differ")
            check(torch.equal(got.rec_slot[lane, :n_srv], ref.rec_slot[lane, :n_srv]),
                  f"{name}: served slots of lane {lane} differ")
            d = (got.rec_done[lane, :n_srv] - ref.rec_done[lane, :n_srv]).abs()
            err = max(err, d.max().item() if n_srv else 0.0)
            check(err == 0.0, f"{name}: completion times of lane {lane} differ")
    lanes = ref.agg_i.shape[0]
    a = {k: ref.agg_i[:, i].numpy() for k, i in col.items()}
    events = int(a["n_served"].sum() + a["n_epochs"].sum())
    # bytes: each trace's used prefix read once (arrivals, phases, and
    # deadlines where given), its draws, the tables, the outputs written
    tables, arr, dl = args[0], args[1], args[2]
    n_pol = 1 if adaptive is not None else tables.shape[0]
    per_trace = a["n_admitted"].reshape(arr.shape[0], n_pol).max(1) + 1
    bat = a["n_batches"].reshape(arr.shape[0], n_pol).max(1)
    rec = 0 if ref.rec_a is None else int(4 * a["n_epochs"].sum() + 12 * a["n_served"].sum())
    n_bytes = int(8 * per_trace.sum() * (2 + (dl is not None)
                                         + (0 if beliefs is None else beliefs.shape[-1]))
                  + 8 * bat.sum()
                  + 8 * tables.numel() + 8 * 3 * args[5].numel() + 8 * args[7].numel()
                  + lanes * 8 * (len(ss.AGG_I) + len(ss.AGG_F) + ref.hist.shape[1])
                  + (0 if ref.queue is None else int(4 * a["tail"].sum())) + rec)
    # operations: the f64 clock, latency and sums per event, and per taken
    # arrival the EWMA and P scaled distances of the adaptive lane
    flops = 2 * a["n_epochs"].sum() + 4 * a["n_served"].sum()
    if beliefs is not None:  # the blend: K products and sums an epoch
        flops += 2 * tables.shape[1] * a["n_epochs"].sum()
    if adaptive is not None:
        flops += (6 + 5 * tables.shape[0]) * (a["n_admitted"] - a["n_shed"]).sum()
    b_ms, b_by = bound(n_bytes, int(flops), F64_FLOPS)
    log(f"{name} ({lanes} lanes, {events} events): kernel_ms={best:.3f} plain_ms={plain:.3f} "
        f"(Python walk on the host) bound_ms={b_ms:.6f} ({b_by}); counts, sums, "
        f"histograms, queues and records equal to the plain version")
    return dict(route="cuda", source=SCAN_SOURCE, max_abs_err=err, ms=best,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                shape=[lanes, events], epochs=int(a["n_epochs"].sum()),
                admissions=int(a["n_admitted"].sum()))


def serve_scan_row(torch, np, table, energy, row):
    """Time the event kernel and its plain version on the main path's own
    inputs, and hold them against each other there too."""
    from repro_torch.serving import PoissonProcess
    from repro_torch.serving.arrivals import take
    from repro_torch.serving.compiled import pad_arrivals
    from repro_torch.core import GOOGLENET_P4_LATENCY

    means = np.array([0.0] + [float(GOOGLENET_P4_LATENCY(b)) for b in range(1, B_MAX + 1)])
    lam = RHO * B_MAX / float(means[B_MAX])
    # the main path's own inputs: the engine's stream at seed 0 as its final
    # launch sees it (it pre-draws 2 x 100k events and, once all of them are
    # admitted, extends the stream to 4 x 100k and launches again)
    t0 = time.perf_counter()
    ev, _ = take(PoissonProcess(lam), np.random.default_rng(0), n=4 * N_EPOCHS)
    arr, _ = pad_arrivals(np.array([e.time for e in ev]))
    log(f"serve inputs: {len(ev)} Poisson events drawn on the host in "
        f"{time.perf_counter() - t0:.3f} s")
    args, _ = scan_inputs(torch, np, table[None, None], arr[None],
                          np.ones((1, N_EPOCHS)), means, energy)
    kw = dict(t0=0.0, horizon=float("inf"), max_eps=N_EPOCHS, drain=False,
              b_max=B_MAX, record=True)
    got = scan_check(torch, np, "serve_scan", args, kw)
    row.update(got, replaces=SCAN_REPLACES.format(""),
               max_abs_err=max(row["max_abs_err"], got["max_abs_err"]),
               shape=[got["epochs"], got["admissions"]])


def profile_busy(torch, fn):
    """Device time of one call of ``fn`` under torch.profiler: (total ms,
    kernel launches, {kernel name: (ms, calls)}); (None, 0, {}) if the
    profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)

    rows = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    if not rows:
        return None, 0, {}
    return (sum(dev_us(e) for e in rows) / 1e3, sum(e.count for e in rows),
            {e.key: (dev_us(e) / 1e3, e.count) for e in rows})


def profile_solve(torch, spec, rvi_s):
    """Device time of one warm kernel solve, by kernel name (torch.profiler).

    The busy share divides the summed device time by ``rvi_s``, the RVI
    wall time of the same solve measured without the profiler."""
    from repro_torch.core import solve

    out = {}
    total_ms, launches, by_name = profile_busy(
        torch, lambda: out.update(res=solve(spec, backup="pallas", device="cuda")))
    if total_ms is None:
        log("profile solve: the profiler recorded no device time (not measured)")
        return
    backups = out["res"].rvi.iterations + 1
    log(f"profile solve rho={RHO}: {backups} backups, {launches} "
        f"kernel launches, device busy "
        f"{total_ms:.3f} ms = {total_ms / backups:.4f} ms per backup; "
        f"busy share of the unprofiled RVI wall time "
        f"{total_ms / 1e3 / rvi_s:.3f}")
    for key, (ms, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"  {ms:9.3f} ms  {cnt:6d} calls  {key[:90]}")


def table1_spec(rho):
    from repro_torch.core import (GOOGLENET_P4_ENERGY, GOOGLENET_P4_LATENCY,
                                  ServiceModel, SMDPSpec)
    svc = ServiceModel(latency=GOOGLENET_P4_LATENCY, family="det")
    lam = rho * B_MAX / float(svc.mean(B_MAX))
    return SMDPSpec(lam=lam, service=svc, energy=GOOGLENET_P4_ENERGY, b_min=1,
                    b_max=B_MAX, w1=1.0, w2=W2, s_max=S_MAX)


def solve_checked(np, kernels, rho):
    """One kernel solve on the card, held against the banded f64 path on
    the card and the plain path on the CPU."""
    from repro_torch.core import solve

    spec = table1_spec(rho)
    before = kernels.launch_counts()["bellman_banded"]
    t0 = time.perf_counter()
    res = solve(spec, backup="pallas", device="cuda")
    wall = time.perf_counter() - t0
    launched = kernels.launch_counts()["bellman_banded"] - before
    check(res.spec.s_max == S_MAX, f"s_max grew to {res.spec.s_max}")
    check(launched == res.rvi.iterations + 1,
          f"{launched} kernel launches for {res.rvi.iterations} + 1 backups")
    banded = solve(spec, device="cuda")
    cpu = solve(spec, backup="pallas", device="cpu")
    check(np.array_equal(res.policy, banded.policy), f"rho={rho}: kernel vs banded f64 policy")
    check(np.array_equal(res.policy, cpu.policy), f"rho={rho}: card vs CPU plain policy")
    ev = res.eval
    log(f"solve rho={rho} w2={W2}: s_max={res.spec.s_max} iterations={res.rvi.iterations} "
        f"g={res.rvi.g:.6f} W={ev.w_bar:.4f} ms P={ev.p_bar:.4f} W wall_s={wall:.3f} "
        f"rvi_s={res.rvi.wall_time_s:.3f} "
        f"per_backup_ms={1e3 * res.rvi.wall_time_s / (res.rvi.iterations + 1):.4f} "
        f"(banded f64 on the card: {banded.rvi.iterations} iterations; "
        f"kernel launches={launched}); policy == banded == CPU plain")
    return res, wall


def tie_gaps(torch, np, o, policy):
    """States where ``policy`` differs from the oracle solve ``o``'s, and the
    Q-gap of the two actions there under the oracle's own h."""
    from repro_torch.core import rvi

    d = np.flatnonzero(policy != o.policy)
    if not d.size:
        return d, np.zeros(0)
    mdp = o.mdp
    pm, tl, sc = rvi.make_banded_inputs(mdp, device=torch.device("cuda"))
    q = rvi.banded_backup(torch.as_tensor(mdp.c_tilde, device="cuda"), pm, tl, sc,
                          o.spec.s_max, torch.as_tensor(o.rvi.h, device="cuda"))
    q = q.cpu().numpy()
    return d, q[d, policy[d]] - q[d, o.policy[d]]


#: the scalar f64 solve() of each spec on the card, by (repr, s_max): filled
#: by the sweep phase, reused by phase 4k (six of Fig. 4's specs are specs
#: of the sweep phase's bank)
ORACLES = {}


def hold_to_oracle(torch, np, what, sp, r, oracles, ties):
    """A sweep's result ``r`` for the input spec ``sp`` against the scalar
    f64 solve() of ``sp`` on the card (cached in ``oracles``): s_max equal,
    g / W / P within rtol 1e-9, the policy equal or a near-tie certified by
    the oracle's own residual -- the two actions' Q under its h differ by
    less than its final span, at a state of negligible stationary mass (the
    reference's sweep_bank shows the same ties against its own solve()).
    Appends such states to ``ties``."""
    from repro_torch.core import solve

    key = (repr(sp), sp.s_max)
    if key not in oracles:
        oracles[key] = solve(sp, device="cuda")
    o = oracles[key]
    check(r.spec.s_max == o.spec.s_max,
          f"{what}: s_max {r.spec.s_max} vs oracle {o.spec.s_max}")
    states, gaps = tie_gaps(torch, np, o, r.policy)
    mass = np.asarray(o.eval.mu)[states]
    check(len(states) <= MAX_TIES_PER_SPEC and bool(np.all(gaps <= o.rvi.span))
          and bool(np.all(mass <= TIE_MASS)),
          f"{what}: policy vs oracle at states {states}, Q-gaps {gaps}, "
          f"stationary mass {mass}")
    ties += [(what, int(st), int(r.policy[st]), int(o.policy[st]), float(gp), float(m))
             for st, gp, m in zip(states, gaps, mass)]
    for f in ("g", "w_bar", "p_bar"):
        want = getattr(o.eval, f)
        check(abs(getattr(r.eval, f) - want) <= 1e-9 * abs(want), f"{what}: eval.{f} vs oracle")


# ---------------------------------------------------------------------------
# The sweep path: sweep_solve -> batched RVI on the spec-batched kernel ->
# evaluate_policy_batched -> SMDPSchedulerBank -> compiled serve
# ---------------------------------------------------------------------------


def sweep_phase(torch, np, kernels, rows, main_res, energy):
    """The three sweep grids on the kernel path, counters zeroed just
    before and read just after, held against the scalar f64 oracle and the
    banded sweep on the card; then the bank serves the Table-I point."""
    import contextlib
    import dataclasses
    import io
    from unittest import mock

    from repro_torch.core import rvi, solve
    from repro_torch.core import sweep as sw
    from repro_torch.launch import tradeoff_sweep
    from repro_torch.serving import ServingEngine

    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 is on: the f32 coarse phase's matmuls must run in IEEE f32")

    def grid(rho, w2s):
        return [dataclasses.replace(table1_spec(rho), w2=float(w)) for w in w2s]

    grids = {"fig5 rho=0.7": grid(0.7, FIG5_W2),
             "scaling rho=0.3": grid(0.3, SCALING_W2),
             "scaling rho=0.7": grid(0.7, SCALING_W2),
             # the bank stays at s_max 128: this grid runs the regrow rounds
             "regrow rho=0.9": [dataclasses.replace(sp, s_max=REGROW_S_MAX)
                                for sp in grid(0.9, REGROW_W2)]}
    bank_base = table1_spec(0.7)
    lams = [table1_spec(r).lam for r in BANK_RHOS]
    bank_specs = [dataclasses.replace(bank_base, lam=lam, w2=float(w))
                  for lam in lams for w in FIG5_W2]
    calls, solved = [], []

    def count_rvi(fn):
        def wrapped(batch, *a, **kw):
            before = kernels.launch_counts()["bellman_banded_batched"]
            out = fn(batch, *a, **kw)
            calls.append(dict(
                n=batch.n_specs, T=batch.specs[0].s_max + 1, A=batch.n_actions,
                K=rvi.trimmed_band(batch.pmfs_banded, tol=1e-8),
                launches=kernels.launch_counts()["bellman_banded_batched"] - before,
                iters=int(np.max(out.iterations)), rvi_s=out.wall_time_s,
                accel=kw.get("accel"), backup=kw.get("backup")))
            return out
        return wrapped

    def keep_results(fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            solved.append(out)
            return out
        return wrapped

    def run(backup):
        """Every grid through the user entry points; per grid: results (in
        input order), report, wall, and the batched-RVI calls it made."""
        out = {}
        for name, specs in list(grids.items()) + [("bank", None)]:
            sink, first = [], len(calls)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if specs is None:
                bank = sw.sweep_bank(bank_base, lams, FIG5_W2, backup=backup,
                                     report_sink=sink, device="cuda")
                res = solved[-1]
            else:
                res = sw.sweep_solve(specs, backup=backup, report_sink=sink, device="cuda")
            torch.cuda.synchronize()
            out[name] = dict(res=res, report=sink[0], wall=time.perf_counter() - t0,
                             calls=calls[first:], bank=bank if specs is None else None)
        return out

    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(sw, "relative_value_iteration_batched",
                           count_rvi(sw.relative_value_iteration_batched)), \
            mock.patch.object(sw, "sweep_solve", keep_results(sw.sweep_solve)):
        # warm-up: lazy CUDA library init (cuSOLVER for the MPI polish)
        sw.sweep_solve(grids["fig5 rho=0.7"], backup="pallas", device="cuda")
        calls.clear()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        kern = run("pallas")
        grids_launched = kernels.launch_counts()["bellman_banded_batched"]
        cli, first = io.StringIO(), len(calls)
        with contextlib.redirect_stdout(cli):
            points = tradeoff_sweep.main(["--backup", "pallas", "--device", "cuda"])
        counts = kernels.launch_counts()
        cli_calls = calls[first:]
        phase_s = time.perf_counter() - t0
        n_calls = len(calls)
        banded = run("banded")
    cli_launched = counts["bellman_banded_batched"] - grids_launched
    log(f"sweep path launches: {counts} ({n_calls} batched-RVI calls, "
        f"{phase_s:.3f} s): the grids {grids_launched}, the tradeoff_sweep CLI "
        f"{cli_launched} in {len(cli_calls)} calls; peak memory of the sweep phase "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    check(counts["bellman_banded_batched"] > 0, "the sweep never launched the batched kernel")
    check(cli_calls and all(c["launches"] >= 1 for c in cli_calls),
          f"tradeoff_sweep CLI: batched-RVI calls without a kernel launch: {cli_calls}")
    for name, g in kern.items():
        rep = g["report"]
        check(rep.healthy.all() and not rep.any_fired,
              f"{name}: guard ladder fired {rep.rungs}, quarantined {rep.quarantined}")
        bad = [c for c in g["calls"] if c["launches"] < 1]
        check(not bad, f"{name}: batched-RVI calls without a kernel launch: {bad}")
        launched = sum(c["launches"] for c in g["calls"])
        rvi_s = sum(c["rvi_s"] for c in g["calls"])
        log(f"sweep {name}: {len(g['res'])} specs wall_s={g['wall']:.3f} rvi_s={rvi_s:.3f} "
            f"kernel backups={launched} rvi ms per kernel backup="
            f"{1e3 * rvi_s / launched:.4f}; calls (N, T, K, accel, launches, iterations): "
            + ", ".join(f"({c['n']}, {c['T']}, {c['K']}, {c['accel']}, {c['launches']}, "
                        f"{c['iters']})" for c in g["calls"])
            + "; no rung fired")
    cli_rows = [ln for ln in cli.getvalue().splitlines() if ln.startswith("smdp,")]
    fig5 = kern["fig5 rho=0.7"]["res"]
    check(len(cli_rows) == len(fig5) and all(
        np.array_equal(p.policy, r.policy) and p.w_bar == r.eval.w_bar
        for p, r in zip(points, fig5)), "tradeoff_sweep CLI vs the Fig. 5 sweep")
    log("tradeoff_sweep --backup pallas (Fig. 5 CSV): " + " | ".join(cli_rows))

    # --- every spec against the scalar f64 oracle, and the banded sweep ---
    oracles, ties = ORACLES, []
    t0 = time.perf_counter()
    n_checked = 0
    for name, g in kern.items():
        specs = bank_specs if name == "bank" else grids[name]
        for sp, r, b in zip(specs, g["res"], banded[name]["res"]):
            what = f"{name} rho={sp.rho:.2f} w2={sp.w2}"
            check(np.array_equal(r.policy, b.policy), f"{what}: policy vs banded sweep")
            hold_to_oracle(torch, np, what, sp, r, oracles, ties)
            n_checked += 1
    check(len(ties) <= MAX_TIES, f"{len(ties)} near-tie states against the oracle: {ties}")
    grown = sorted({(round(o.spec.rho, 2), s_max, o.spec.s_max)
                    for (_, s_max), o in oracles.items() if o.spec.s_max != s_max})
    log(f"sweep oracle: {n_checked} specs ({len(oracles)} distinct) against the scalar f64 "
        f"solve() on the card: s_max equal, g / W / P within rtol 1e-9, policies equal to "
        f"the banded sweep's and to the oracle's except {len(ties)} certified near-tie "
        f"state(s) (name, state, sweep action, oracle action, Q-gap, stationary mass): "
        f"{ties}; regrown specs (rho, start s_max, final s_max): {grown}; oracle wall "
        f"{time.perf_counter() - t0:.2f} s")

    # --- the bank serves the Table-I point ----------------------------------
    bank = kern["bank"]["bank"]
    lam7 = table1_spec(RHO).lam
    sch = bank.scheduler(lam=lam7, w2=W2)
    check(np.array_equal(sch.table, main_res.action_table()),
          "bank table at (lambda(0.7), 1.6) vs the main path's policy")
    eng = ServingEngine(sch, lam=lam7, b_max=B_MAX, service=main_res.spec.service,
                        energy_table=energy, seed=0, device="cuda")
    before = kernels.launch_counts()["serve_scan"]
    t0 = time.perf_counter()
    rep = eng.run(N_EPOCHS, backend="compiled")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(kernels.launch_counts()["serve_scan"] > before, "bank serve skipped the event kernel")
    ev = main_res.eval
    check(abs(rep.latencies.mean() - ev.w_bar) < 0.05 * ev.w_bar
          and abs(rep.power - ev.p_bar) < 0.05 * ev.p_bar, "bank serve far from analytic W, P")
    log(f"bank ({len(bank)} tables) -> scheduler(lam={lam7:.6f}, w2={W2}) -> compiled serve "
        f"{N_EPOCHS} epochs: W={rep.latencies.mean():.4f} ms (analytic {ev.w_bar:.4f}) "
        f"P={rep.power:.4f} W (analytic {ev.p_bar:.4f}) wall_s={wall:.3f}")

    # --- busy share of one warm sweep, and the kernel at the path's shapes --
    specs07 = grids["scaling rho=0.7"]

    def sweep07():
        sw.sweep_solve(specs07, backup="pallas", device="cuda")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweep07()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    dev_ms, n_k, by_name = profile_busy(torch, sweep07)
    if dev_ms is None:
        log("profile sweep: the profiler recorded no device time (not measured)")
    else:
        bell = [v for k, v in by_name.items() if "bellman" in k]
        lu = sum(ms for k, (ms, _) in by_name.items()
                 if any(w in k for w in ("getrf", "getf2", "laswp", "trsm", "pivinfo",
                                         "displace_pointers", "getrs")))
        log(f"profile sweep scaling rho=0.7 (17 specs, pallas): unprofiled wall_ms="
            f"{wall_ms:.3f}; device busy {dev_ms:.3f} ms in {n_k} kernels, busy share "
            f"{dev_ms / wall_ms:.4f}; Bellman kernel {sum(v[0] for v in bell):.3f} ms in "
            f"{sum(v[1] for v in bell)} launches; batched LU (MPI polish and exact gain) "
            f"{lu:.3f} ms")
        for key, (ms, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
            log(f"  {ms:9.3f} ms  {cnt:6d} calls  {key[:80]}")
    rng = np.random.default_rng(5)
    path_shapes = sorted({(c["n"], c["T"], c["A"], c["K"])
                          for g in kern.values() for c in g["calls"]} |
                         {(c["n"], c["T"], c["A"], c["K"]) for c in cli_calls})
    err_path = max(batched_check(torch, np, rng, *shape) for shape in path_shapes)
    path = max((c for c in kern["scaling rho=0.7"]["calls"]),
               key=lambda c: (c["n"], c["T"], c["A"], c["K"]))
    biggest = max((c for c in kern["bank"]["calls"]),
                  key=lambda c: (c["n"] * c["T"] * c["K"], c["n"]))
    row = rows["bellman_banded_batched"]
    old = {k: row.pop(k) for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                   "bound_by", "launch_floor_ms", "shape", "split",
                                   "blocks", "threads", "smem_bytes")}
    row.update(batched_row(torch, np, rng, path["n"], path["T"], path["A"], path["K"], 200))
    row["other_shapes"] = [
        batched_row(torch, np, rng, biggest["n"], biggest["T"], biggest["A"], biggest["K"]),
        old]
    row["max_abs_err"] = max(row["max_abs_err"], err_path)
    row["max_abs_err_path_shapes"] = err_path
    row["path_shapes_checked"] = [list(sh) for sh in path_shapes]
    row["launches"] = counts["bellman_banded_batched"]
    row["launches_by_grid"] = {name: sum(c["launches"] for c in g["calls"])
                               for name, g in kern.items()}
    row["launches_by_grid"]["tradeoff_sweep CLI"] = cli_launched
    row["sweep_wall_s"] = {name: round(g["wall"], 6) for name, g in kern.items()}


def poisoned_grid_phase(np, kernels, rows):
    """A small grid with one NaN w2 on backup="pallas": it completes, that
    row quarantined and failed after the reference's rungs, every other row
    healthy and equal in policy to the same grid without it, and the
    spec-batched kernel carried the solves (its launch count rose)."""
    import dataclasses

    from repro_torch.core import sweep as sw

    specs = [dataclasses.replace(table1_spec(RHO), w2=w) for w in (0.0, W2, float("nan"), 8.0)]
    sink = []
    before = kernels.launch_counts()["bellman_banded_batched"]
    t0 = time.perf_counter()
    res = sw.sweep_solve(specs, backup="pallas", report_sink=sink, device="cuda")
    wall = time.perf_counter() - t0
    launched = kernels.launch_counts()["bellman_banded_batched"] - before
    rep = sink[0]
    check(launched > 0, "the poisoned grid never launched the batched kernel")
    check(rep.quarantined == [2] and rep.failed == [2],
          f"poisoned grid: quarantined {rep.quarantined}, failed {rep.failed}")
    check(rep.healthy.tolist() == [True, True, False, True] and np.isnan(res[2].eval.g),
          f"poisoned grid: healthy {rep.healthy.tolist()}")
    clean = sw.sweep_solve(specs[:2] + specs[3:], backup="pallas", device="cuda")
    check(all(np.array_equal(a.policy, b.policy) and a.spec.s_max == b.spec.s_max
              for a, b in zip(res[:2] + res[3:], clean)),
          "poisoned grid: healthy rows vs the grid without the NaN spec")
    log(f"poisoned grid (w2 = 0, {W2}, nan, 8 at rho {RHO}, backup=pallas): completed in "
        f"{wall:.3f} s, {launched} batched kernel launches; rungs {rep.rungs}, quarantined "
        f"{rep.quarantined}, failed {rep.failed}; the other rows equal the grid without it")
    rows["bellman_banded_batched"]["poisoned_grid"] = dict(
        rungs=rep.rungs, quarantined=rep.quarantined, failed=rep.failed, launches=launched)


# ---------------------------------------------------------------------------
# Phase 4k: the paper's own figures and tables (launch/paper_figures.py) at
# the benchmarks' full size, every solve and sweep on the Bellman kernels
# ---------------------------------------------------------------------------

#: the reference's numbers at the benchmarks' full size, unrounded: the JAX
#: package's own library calls on the benchmarks' grids, on a CPU
#: (tools/paper_figures_ref.py; `python -m benchmarks.run --only NAME` prints
#: the same, rounded).  Fig. 10: c_o -> (smallest acceptable s_max, RVI
#: iterations there, evaluated g) and the search's solves that stop at
#: max_iter = 10 000 unconverged (their policies are rejected); Fig. 3:
#: (control-limit, specs, Prop. 4 matches, exponential specs), the specs
#: that regrew past s_max 100 and every spec's threshold q (rho-major over
#: the w2s); App. E: (non-control-limit specs, specs) per case and the
#: (rho, w2) of the specs that break the structure (all at s_max 100) and
#: the specs that regrew;
#: Table III: the four
#: baselines' g on the c_o = 0 chain and their iterations, the accel
#: ladder's iterations.
FIG_REF = dict(
    fig10={10000.0: (92, 1825, 66.13121950662794), 1000.0: (84, 1673, 66.13097234951249),
           100.0: (76, 1531, 66.13079748945181), 10.0: (164, 8303, 66.13072376693728),
           0.0: (196, 8870, 66.13072376693998)},
    fig10_cuts=(0.6091370558375635, 0.9740482521609983),
    fig10_unconverged={10.0: (156,), 0.0: (180, 188)},  # stopped at max_iter, rejected
    fig3=(60, 60, 40, 40),
    fig3_grown={(case, rho, w2): s for case in ("case2_expo", "case3_expo")
                for rho, w2, s in ((0.7, 0.0, 150), (0.7, 0.5, 150), (0.7, 1.0, 150),
                                   (0.7, 100.0, 225), (0.9, 0.0, 507), (0.9, 0.5, 507),
                                   (0.9, 1.0, 507), (0.9, 100.0, 761))},
    fig3_q={"case1_det": (1, 2, 2, 8, 2, 4, 6, 8, 3, 7, 8, 8, 4, 8, 8, 8, 7, 8, 8, 8),
            "case2_expo": (1, 2, 2, 8, 3, 5, 6, 8, 5, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8),
            "case3_expo": (1, 2, 3, 8, 3, 6, 8, 8, 5, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8)},
    appE={"case4_bmin5": (3, 15), "case5_log_energy": (1, 15), "case6_size_dep": (9, 15),
          "case7_general": (3, 15)},
    appE_broken={"case4_bmin5": {(0.1, 0.0), (0.1, 0.5), (0.1, 1.0)},
                 "case5_log_energy": {(0.1, 1.0)},
                 "case6_size_dep": {(r, w) for r in (0.1, 0.3, 0.5) for w in (0.0, 0.5, 1.0)},
                 "case7_general": {(0.1, 0.0), (0.3, 0.0), (0.5, 0.0)}},
    appE_grown={("case7_general", rho, w2): s for rho, s in ((0.7, 150), (0.9, 507))
                for w2 in (0.0, 0.5, 1.0)},
    fig8_power_range={0.3: 41.368950795103316, 0.7: 53.10788094077978},
    fig9_w={0.3: dict(det=4.064510760728661, erlang=4.4220003444521865,
                      expo=4.855422581879129, hyperexpo=5.820393200737132),
            0.7: dict(det=6.0861281964682235, erlang=9.244644036779633,
                      expo=13.168274882315332, hyperexpo=20.53436293792295)},
    table3=dict(rvi_co0=(38.859947548547915, 406), rvi_co100=(38.85994754854793, 408),
                avi_schemeI=(38.859947548547915, 400), api_schemeIV=(38.85994754854792, 720)),
    accel_iters={0.3: dict(none=171, mpi=37, anderson=79),
                 0.7: dict(none=703, mpi=36, anderson=378),
                 0.85: dict(none=1474, mpi=22, anderson=889)},
)
#: the paper's Table II claim (its abstract): c_o ~ 100 against c_o = 0
#: saves 63.5% of the space and 98% of the time
PAPER_CUTS = (0.635, 0.98)


def paper_figures_phase(torch, np, kernels, rows):
    """Phase 4k: every figure of launch/paper_figures.py at its full size with
    backup="pallas" on the card, counters zeroed just before and read just
    after; held against the reference's numbers (FIG_REF)."""
    import collections
    from unittest import mock

    from repro_torch.core import build_smdp, evaluate_policy, rvi, tradeoff
    from repro_torch.core import sweep as sw
    from repro_torch.kernels import bellman
    from repro_torch.launch import paper_figures as pf

    solve_mod = sys.modules["repro_torch.core.solve"]
    card = CARD[0]
    current = [None]  # the figure being run
    scalar, batched, sweeps = [], [], []

    def delta_of(name, fn):
        before = kernels.launch_counts()[name]
        out = fn()
        return out, kernels.launch_counts()[name] - before

    def count_scalar(fn, via):
        def wrapped(mdp, *a, **kw):
            out, n = delta_of("bellman_banded", lambda: fn(mdp, *a, **kw))
            T = mdp.spec.s_max + 1
            scalar.append(dict(fig=current[0], via=via, backup=kw.get("backup", "banded"),
                               shape=(T, mdp.n_actions, T), iterations=out.iterations,
                               converged=out.converged, launches=n))
            return out
        return wrapped

    def count_batched(fn):
        def wrapped(batch, *a, **kw):
            out, n = delta_of("bellman_banded_batched", lambda: fn(batch, *a, **kw))
            batched.append(dict(
                fig=current[0], backup=kw.get("backup", "banded"), accel=kw.get("accel"),
                launches=n, shape=(batch.n_specs, batch.specs[0].s_max + 1,
                                   batch.n_actions,
                                   rvi.trimmed_band(batch.pmfs_banded, tol=1e-8))))
            return out
        return wrapped

    def keep_sweep(fn):
        def wrapped(specs, *a, **kw):
            kw.setdefault("report_sink", [])
            out, n = delta_of("bellman_banded_batched", lambda: fn(specs, *a, **kw))
            sweeps.append(dict(fig=current[0], specs=list(specs), res=out, launches=n,
                               report=kw["report_sink"][0], backup=kw.get("backup")))
            return out
        return wrapped

    patches = [
        mock.patch.object(solve_mod, "relative_value_iteration",
                          count_scalar(solve_mod.relative_value_iteration, "solve")),
        mock.patch.object(rvi, "relative_value_iteration",
                          count_scalar(rvi.relative_value_iteration, "rvi")),
        mock.patch.object(rvi, "relative_value_iteration_batched",
                          count_batched(rvi.relative_value_iteration_batched)),
        mock.patch.object(sw, "relative_value_iteration_batched",
                          count_batched(sw.relative_value_iteration_batched)),
        mock.patch.object(sw, "sweep_solve", keep_sweep(sw.sweep_solve)),
        mock.patch.object(tradeoff, "sweep_solve", keep_sweep(tradeoff.sweep_solve)),
    ]
    out, walls = {}, {}
    for p in patches:
        p.start()
    try:
        kernels.reset_launch_counts()
        t_phase = time.perf_counter()
        for name, fn in pf.FIGURES.items():
            current[0] = name
            t0 = time.perf_counter()
            out[name] = fn(backup="pallas", device="cuda")
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            log(f"paper figure {name} (full size, backup=pallas, {card}): wall "
                f"{walls[name]:.2f} s; " + " | ".join(pf.rows(name, out[name])))
        counts = kernels.launch_counts()
        phase_s = time.perf_counter() - t_phase
    finally:
        for p in patches:
            p.stop()

    # --- launches: one a backup of every kernel solve, one a lockstep step --
    kern = [c for c in scalar if c["backup"] == "pallas"]
    want = sum(c["iterations"] + 1 for c in kern)
    bad = [c for c in kern if c["launches"] != c["iterations"] + 1]
    check(not bad, f"kernel RVI calls whose launches are not their backups + 1: {bad[:5]}")
    check(not any(c["launches"] for c in scalar if c["backup"] != "pallas"),
          "a float64 banded RVI call launched the Bellman kernel")
    # the only float64 scalar solves are Table III's oracles, one a rho
    oracle = [c for c in scalar if c["backup"] != "pallas"]
    check(len(oracle) == len(out["table3_iteration_algos"]["accel"]) and all(
        c["fig"] == "table3_iteration_algos" and c["via"] == "solve" for c in oracle),
          f"scalar RVI calls that did not pass backup='pallas' through: "
          f"{[(c['fig'], c['via'], c['shape']) for c in oracle]}")
    check(counts["bellman_banded"] == want,
          f"bellman_banded launched {counts['bellman_banded']} times for {want} backups "
          f"(+1 a call) of {len(kern)} kernel RVI calls")
    check(sweeps and all(s["launches"] >= 1 and s["backup"] == "pallas" for s in sweeps),
          f"sweeps without a batched kernel launch: "
          f"{[(s['fig'], s['launches']) for s in sweeps if s['launches'] < 1]}")
    ladder = [c for c in batched if c["fig"] == "table3_iteration_algos"
              and c["backup"] == "pallas"]
    check(ladder and all(c["launches"] >= 1 for c in ladder),
          "Table III's accel ladder: a batched call without a kernel launch")
    for s in sweeps:
        rep = s["report"]
        check(rep.healthy.all() and not rep.any_fired and not rep.quarantined,
              f"{s['fig']}: guard ladder fired {rep.rungs}, quarantined {rep.quarantined}")
    by_fig = {name: dict(
        bellman_banded=sum(c["launches"] for c in kern if c["fig"] == name),
        rvi_calls=sum(1 for c in kern if c["fig"] == name),
        bellman_banded_batched=sum(c["launches"] for c in batched if c["fig"] == name),
        sweeps=sum(1 for s in sweeps if s["fig"] == name)) for name in pf.FIGURES}
    for name in ("fig3_policies", "appE_structure_breaks", "fig10_abstract_cost",
                 "table3_iteration_algos"):
        check(by_fig[name]["rvi_calls"] > 0 and by_fig[name]["bellman_banded"] > 0,
              f"{name}: no scalar RVI call on the Bellman kernel ({by_fig[name]})")
    for name in ("fig4_cost", "fig7_ideal_parallel", "fig8_log_energy", "fig9_cov"):
        check(by_fig[name]["sweeps"] > 0 and by_fig[name]["bellman_banded_batched"] > 0,
              f"{name}: no sweep on the spec-batched kernel ({by_fig[name]})")
    check(by_fig["table3_iteration_algos"]["bellman_banded_batched"] > 0,
          "Table III's accel ladder launched no spec-batched kernel")
    log(f"paper figures launches: {counts} ({phase_s:.2f} s of wall on {card}); by figure "
        f"{json.dumps(by_fig)}; {len(kern)} kernel RVI calls, every one launched its "
        f"backups + 1, {len(sweeps)} sweeps each on the batched kernel, no guard rung fired")

    # --- Fig. 10 / Table II ---------------------------------------------------
    f10 = out["fig10_abstract_cost"]
    for c_o, (s_ref, it_ref, g_ref) in FIG_REF["fig10"].items():
        r = f10["c_o"][c_o]
        ref_unconv = FIG_REF["fig10_unconverged"].get(c_o, ())
        unconv = [x for x in r["searched"] if not x["converged"]]
        if any(x["s_max"] not in ref_unconv or x["s_max"] == r["min_smax"] for x in unconv):
            raise AssertionError(
                f"Fig. 10 c_o={c_o:g}: kernel solves stopped unconverged at max_iter where "
                f"the reference converged, which corrupts the search: {unconv} (the "
                f"reference's unconverged s_max: {ref_unconv})")
        check(r["min_smax"] == s_ref,
              f"Fig. 10 c_o={c_o:g}: min s_max {r['min_smax']} on the kernel, {s_ref} in the "
              "reference")
    pins, t0 = {}, time.perf_counter()
    for c_o in FIG_REF["fig10"]:
        s_min = f10["c_o"][c_o]["min_smax"]
        for s in (s_min, s_min - (pf.FIG10_S_GRID[1] - pf.FIG10_S_GRID[0])):
            mdp = build_smdp(pf.paper_spec(rho=0.9, w2=1.0, s_max=s, c_o=c_o))
            res = rvi.relative_value_iteration(mdp, eps=1e-2, max_iter=10_000, device="cuda")
            pins[c_o, s] = (res, evaluate_policy(mdp, res.policy))
        (r0, e0), (r1, e1) = pins[c_o, s_min], pins[c_o, s_min - 8]
        check(e0.delta < pf.FIG10_DELTA and r0.converged,
              f"Fig. 10 c_o={c_o:g}: s_min {s_min} is not acceptable on the f64 banded path "
              f"(delta {e0.delta}, converged {r0.converged})")
        check(not e1.delta < pf.FIG10_DELTA,
              f"Fig. 10 c_o={c_o:g}: s_min - 8 = {s_min - 8} is acceptable on the f64 path")
    pin_s = time.perf_counter() - t0

    def cuts(s0, i0, s1, i1):  # c_o = 0 -> c_o = 100, the benchmark's formulas
        space = 1 - ((s1 + 1) * (pf.BMAX + 1) * 2) / ((s0 + 1) * (pf.BMAX + 1) * 2)
        return space, 1 - (i1 * (pf.BMAX + 1) * s1 ** 2) / (i0 * (pf.BMAX + 1) * s0 ** 2)

    s0, s1 = f10["c_o"][0.0]["min_smax"], f10["c_o"][100.0]["min_smax"]
    kern_cuts = (f10["reduction"]["space_saved"], f10["reduction"]["time_saved"])
    f64_cuts = cuts(s0, pins[0.0, s0][0].iterations, s1, pins[100.0, s1][0].iterations)
    check(all(abs(a - b) <= 1e-12 for a, b in zip(f64_cuts, FIG_REF["fig10_cuts"])),
          f"Table II: the f64 banded cuts {f64_cuts} vs the reference's {FIG_REF['fig10_cuts']}")
    log(f"Fig. 10 / Table II at rho 0.9, w2 1, Delta < 1e-3 (kernel search, then s_min and "
        f"s_min - 8 re-solved on the f64 banded path, {pin_s:.2f} s): " + "; ".join(
            f"c_o {c_o:g}: min s_max {f10['c_o'][c_o]['min_smax']} (reference {s_ref}), "
            f"iterations kernel {f10['c_o'][c_o]['iterations']} / f64 "
            f"{pins[c_o, f10['c_o'][c_o]['min_smax']][0].iterations} / reference {it_ref}, "
            f"g {f10['c_o'][c_o]['g']:.6f} (reference {g_ref:.6f}), f64 delta at s_min "
            f"{pins[c_o, f10['c_o'][c_o]['min_smax']][1].delta:.3e} and at s_min - 8 "
            f"{pins[c_o, f10['c_o'][c_o]['min_smax'] - 8][1].delta:.3e}"
            for c_o, (s_ref, it_ref, g_ref) in FIG_REF["fig10"].items()))
    log(f"Table II cuts, c_o 100 against c_o 0 (s_max {s0} -> {s1}): space / time saved "
        f"from the kernel path's iterations {kern_cuts[0]:.4%} / {kern_cuts[1]:.4%}; from "
        f"the f64 banded path's {f64_cuts[0]:.4%} / {f64_cuts[1]:.4%} (equal to the "
        f"reference's {FIG_REF['fig10_cuts'][0]:.4%} / {FIG_REF['fig10_cuts'][1]:.4%}); the "
        f"paper's {PAPER_CUTS[0]:.1%} / {PAPER_CUTS[1]:.0%}")
    one = pf.paper_spec(rho=0.9, w2=1.0, s_max=s1, c_o=100.0)
    mdp = build_smdp(one)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = rvi.relative_value_iteration(mdp, backup="pallas", device="cuda")
    wall = time.perf_counter() - t0
    busy_ms, n_k, by_name = profile_busy(
        torch, lambda: rvi.relative_value_iteration(mdp, backup="pallas", device="cuda"))
    if busy_ms is None:
        log("profile Fig. 10 solve: the profiler recorded no device time (not measured)")
        fig10_busy = None
    else:
        fig10_busy = busy_ms / 1e3 / wall
        log(f"profile Fig. 10 solve (c_o 100, s_max {s1}, {res.iterations + 1} backups, "
            f"{card}): unprofiled wall {wall:.3f} s = {1e3 * wall / (res.iterations + 1):.4f} "
            f"ms a backup; device busy {busy_ms:.3f} ms in {n_k} kernels, busy share "
            f"{fig10_busy:.4f}")
        for key, (ms, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]:
            log(f"  {ms:9.3f} ms  {cnt:6d} calls  {key[:80]}")

    # --- Fig. 3 and App. E --------------------------------------------------
    f3 = out["fig3_policies"]
    got = (f3["control_limit"], f3["total"], f3["prop4_match"], f3["prop4_applicable"])
    check(got == FIG_REF["fig3"], f"Fig. 3: {got} vs the reference's {FIG_REF['fig3']}")
    grown = {(r["case"], r["rho"], r["w2"]): r["s_max"] for r in f3["specs"]}
    moved = {k: (v, FIG_REF["fig3_grown"].get(k, 100)) for k, v in grown.items()
             if v != FIG_REF["fig3_grown"].get(k, 100)}
    check(not moved, f"Fig. 3: final s_max (kernel, reference) differ: {moved}")
    q_got = {case: tuple(r["q"] for r in f3["specs"] if r["case"] == case)
             for case in FIG_REF["fig3_q"]}
    check(q_got == FIG_REF["fig3_q"],
          f"Fig. 3: thresholds q per spec {q_got} vs the reference's {FIG_REF['fig3_q']}")
    log(f"Fig. 3: {f3['control_limit']}/{f3['total']} control-limit, {f3['prop4_match']}/"
        f"{f3['prop4_applicable']} Q equal to Prop. 4's closed form (the reference's "
        f"{FIG_REF['fig3']}); final s_max and q per (case, rho, w2): " + ", ".join(
            f"{r['case'][:5]} {r['rho']} {r['w2']:g}: {r['s_max']} q={r['q']}"
            for r in f3["specs"])
        + "; every spec's final s_max and q equal to the reference's")
    e = out["appE_structure_breaks"]
    held = []
    for case, want in FIG_REF["appE"].items():
        check((e[case]["non_control_limit"], e[case]["total"]) == want,
              f"App. E {case}: {e[case]['non_control_limit']}/{e[case]['total']} vs "
              f"the reference's {want}")
        broken = {(r["rho"], r["w2"]) for r in e[case]["specs"] if not r["control_limit"]}
        moved = [(r["rho"], r["w2"], r["s_max"]) for r in e[case]["specs"]
                 if r["s_max"] != FIG_REF["appE_grown"].get((case, r["rho"], r["w2"]), 100)]
        check(broken == FIG_REF["appE_broken"][case] and not moved,
              f"App. E {case}: breaking (rho, w2) {sorted(broken)} vs the reference's "
              f"{sorted(FIG_REF['appE_broken'][case])}; final s_max off the reference's: "
              f"{moved}")
        for r in e[case]["specs"]:
            if r["control_limit"]:
                continue
            f64 = rvi.relative_value_iteration(build_smdp(r["spec"]), device="cuda")
            check(np.array_equal(f64.policy, r["policy"]),
                  f"App. E {case} rho={r['rho']} w2={r['w2']}: the kernel's policy vs one f64 "
                  f"banded RVI at s_max {r['s_max']}")
            held.append((case, r["rho"], r["w2"], r["s_max"]))
    log("App. E: non-control-limit " + ", ".join(
        f"{c} {e[c]['non_control_limit']}/{e[c]['total']}" for c in e)
        + f" (equal to the reference's, and so are each case's set of breaking (rho, w2) "
        f"and every spec's final s_max); the kernel's policy equal to one f64 banded RVI "
        f"on the card at the final truncation for every breaking spec (case, rho, w2, "
        f"s_max): {held}")

    # --- Figs. 4, 7, 8, 9: every spec against the scalar f64 solve() ----------
    oracles, ties = ORACLES, []
    n_before = len(oracles)
    t0 = time.perf_counter()
    n_held = 0
    for sweep in sweeps:
        for sp, r in zip(sweep["specs"], sweep["res"]):
            hold_to_oracle(torch, np, f"{sweep['fig']} rho={sp.rho:.2f} w2={sp.w2} "
                           f"{sp.service.family}", sp, r, oracles, ties)
            n_held += 1
    check(len(ties) <= MAX_TIES, f"{len(ties)} near-tie states against the oracle: {ties}")
    f4, f7, f8, f9 = (out[n] for n in ("fig4_cost", "fig7_ideal_parallel",
                                       "fig8_log_energy", "fig9_cov"))
    check(all(r["smdp_always_best"] for r in f4.values()), "Fig. 4: SMDP beaten")
    check(all(r["dominated"] == 0 for r in list(f7.values()) + list(f8.values())),
          "Figs. 7-8: an SMDP point is dominated")
    for rho, want in FIG_REF["fig8_power_range"].items():
        check(abs(f8[rho]["power_range"] - want) <= 1e-6 * want,
              f"Fig. 8 rho={rho}: power range {f8[rho]['power_range']} vs {want}")
    for rho, want in FIG_REF["fig9_w"].items():
        check(f9[rho]["monotone"], f"Fig. 9 rho={rho}: W not monotone in CoV")
        for fam, w in want.items():
            check(abs(f9[rho]["w"][fam] - w) <= 1e-6 * w,
                  f"Fig. 9 rho={rho} {fam}: W {f9[rho]['w'][fam]} vs {w}")
    log(f"Figs. 4, 7, 8, 9: {n_held} sweep specs against the scalar f64 solve() on the card "
        f"({len(oracles) - n_before} solved here, the rest the sweep phase's, "
        f"{time.perf_counter() - t0:.2f} s): s_max equal, g / W / "
        f"P within rtol 1e-9, policies equal except {len(ties)} certified near-tie state(s) "
        f"{ties}; Fig. 4 smdp_always_best at rho {list(f4)}; dominated 0 in Figs. 7-8; Fig. 8 "
        f"power range " + ", ".join(
            f"rho {rho}: {f8[rho]['power_range']:.6f} W (reference {w:.6f})"
            for rho, w in FIG_REF["fig8_power_range"].items())
        + "; Fig. 9 W monotone in CoV, " + "; ".join(
            f"rho {rho}: " + ", ".join(f"{fam} {f9[rho]['w'][fam]:.6f} ({w:.6f})"
                                       for fam, w in want.items())
            for rho, want in FIG_REF["fig9_w"].items())
        + " ms (kernel, reference; rtol 1e-6); regrown s_max "
        + str({rho: f9[rho]["s_max"] for rho in f9}))

    # --- Table III ------------------------------------------------------------
    t3 = out["table3_iteration_algos"]
    for name, r in t3["baselines"].items():
        g_ref = FIG_REF["table3"][name][0]
        check(f"{r['g']:.4f}" == f"{g_ref:.4f}",
              f"Table III {name}: g {r['g']} vs the reference's {g_ref}")
    for rho, modes in t3["accel"].items():
        for mode in pf.ACCEL_MODES:
            check(modes[mode]["policy_match"], f"Table III rho={rho} {mode}: policy vs oracle")
    log("Table III baselines (g on the c_o = 0 chain, iterations; the reference's in "
        "brackets): " + ", ".join(
            f"{n} g={r['g']:.4f} ({FIG_REF['table3'][n][0]:.4f}) iters={r['iterations']} "
            f"({FIG_REF['table3'][n][1]}) wall={r['wall_s']:.2f} s"
            for n, r in t3["baselines"].items())
        + f"; accel ladder ({card}; iterations kernel (reference), g_gap, policy_match): "
        + "; ".join(f"rho {rho} " + ", ".join(
            f"{m} {modes[m]['iterations']} ({FIG_REF['accel_iters'][rho][m]}) "
            f"{modes[m]['g_gap_vs_oracle']:.2e} {modes[m]['policy_match']}"
            for m in pf.ACCEL_MODES) for rho, modes in t3["accel"].items()))

    # --- the Bellman kernels at the phase's shapes ----------------------------
    by_shape = collections.Counter()
    for c in kern:
        by_shape[c["shape"]] += c["launches"]
    a9 = max((sh for sh in by_shape if sh[1] == pf.STRUCTURE_B + 1), key=by_shape.get)
    shapes = [a9, (s0 + 1, pf.BMAX + 1, s0 + 1)]
    rng = np.random.default_rng(11)
    err = 0.0
    for T, A, K in shapes:
        args = bellman_inputs(torch, np, rng, T, A, K)
        got_g = bellman.bellman_banded(*args)
        want_g = bellman.bellman_banded_ref(*args)
        torch.cuda.synchronize()
        e_ = (got_g - want_g).abs().max().item()
        check(torch.allclose(got_g, want_g, atol=1e-4, rtol=1e-5),
              f"bellman_banded {T, A, K}: max abs err {e_}")
        err = max(err, e_)
    shape_rows = [dict(bellman_row(torch, np, rng, *sh, reps=200), launches=by_shape[sh])
                  for sh in shapes]
    b_shapes = sorted({c["shape"] for c in batched if c["backup"] == "pallas"})
    err_b = max(batched_check(torch, np, rng, *sh) for sh in b_shapes)
    rows["bellman_banded"]["paper_figures"] = dict(
        launches=counts["bellman_banded"], rvi_calls=len(kern), max_abs_err=err,
        shapes=shape_rows, launches_by_shape={"x".join(map(str, sh)): n
                                              for sh, n in by_shape.most_common()},
        fig10_busy_share=fig10_busy, wall_s=phase_s)
    rows["bellman_banded_batched"]["paper_figures"] = dict(
        launches=counts["bellman_banded_batched"], sweeps=len(sweeps),
        ladder_calls=len(ladder), max_abs_err=err_b,
        shapes_checked=[list(sh) for sh in b_shapes])
    rows["bellman_banded"]["max_abs_err"] = max(rows["bellman_banded"]["max_abs_err"], err)
    rows["bellman_banded_batched"]["max_abs_err"] = max(
        rows["bellman_banded_batched"]["max_abs_err"], err_b)
    by_fig_s = json.dumps({k: round(v, 3) for k, v in walls.items()})
    log(f"paper figures phase: wall by figure {by_fig_s} s on {card}; bellman_banded at the phase's most-launched A = 9 shape {a9} "
        f"({by_shape[a9]} launches) and at Fig. 10's {shapes[1]} held against its plain "
        f"version (max abs err {err:.3e}); bellman_banded_batched at its {len(b_shapes)} "
        f"shapes (max abs err {err_b:.3e})")


# ---------------------------------------------------------------------------
# Attention kernels
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Single-server serving: overload shedding through the managed-queue lane
# (benchmarks/degraded_frontier.py section 3) and the adaptive bank under
# bursty MMPP (benchmarks/mmpp_bursty.py's compiled sections)
# ---------------------------------------------------------------------------

#: degraded_frontier.py's shedding setup: b_max 16, waiting room 24, rho
#: 1.2, drop price 50, w2 1, 8000 arrivals per trace, 4 seeds (400 + s)
SHED_BMAX, SHED_BUFFER, SHED_RHO, SHED_C_DROP, SHED_N, SHED_SEEDS = 16, 24, 1.2, 50.0, 8000, 4
#: mmpp_bursty.py's "bursty" scenario: rho 0.08 / 0.85, w2 0.5, dwell
#: 4000 / 800, horizon 40 000, 5 grid points (and the mean rate), 6 seeds
BURSTY = dict(r1=0.08, r2=0.85, w2=0.5, dwell1=4000.0, dwell2=800.0)
BURSTY_HORIZON, BURSTY_POINTS, BURSTY_SEEDS = 40_000.0, 5, 6
ADAPTIVE_KW = dict(ewma=0.15, margin=0.2, min_dwell=20.0)
ADAPTIVE_BUFFER = 16  # a waiting room the bursts overflow: refusals stay unobserved


def shedding_phase(torch, np, kernels, rows):
    """The drop-cost-aware finite-buffer policy against the blind one on
    one server, counters zeroed just before and read just after."""
    from repro_torch.core import (GOOGLENET_P4_ENERGY, GOOGLENET_P4_LATENCY,
                                  ServiceModel, SMDPSpec, solve)
    from repro_torch.serving import histogram_quantiles, simulate_compiled, verify_backends
    from repro_torch.serving.arrivals import MMPP2

    bm = SHED_BMAX
    svc = ServiceModel(latency=GOOGLENET_P4_LATENCY, family="det")
    means = np.array([0.0] + [float(svc.mean(b)) for b in range(1, bm + 1)])
    zeta = np.array([0.0] + [float(GOOGLENET_P4_ENERGY(b)) for b in range(1, bm + 1)])

    def spec(rho, **kw):
        return SMDPSpec(lam=rho * bm / float(svc.mean(bm)), service=svc,
                        energy=GOOGLENET_P4_ENERGY, b_min=1, b_max=bm, w1=1.0,
                        w2=1.0, **kw)

    lam = SHED_RHO * bm / float(svc.mean(bm))

    def trace(mode, seed):  # degraded_frontier.py's _trace
        rng = np.random.default_rng(seed)
        if mode == "poisson":
            return np.cumsum(rng.exponential(1.0 / lam, SHED_N))
        m = MMPP2(lam1=0.25 * lam, lam2=1.75 * lam, dwell1=40.0, dwell2=40.0)
        return np.asarray(m.sample_arrivals(SHED_N / m.mean_rate, rng)[0])

    modes = ("mmpp2", "poisson")
    traces = {(mode, s): trace(mode, 400 + s) for mode in modes for s in range(SHED_SEEDS)}
    aware_spec = spec(SHED_RHO, s_max=SHED_BUFFER, buffer=SHED_BUFFER, c_drop=SHED_C_DROP)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    aware = solve(aware_spec, backup="pallas", device="cuda")
    aware_launches = kernels.launch_counts()["bellman_banded"]
    blind = solve(spec(0.7, s_max=128), backup="pallas", device="cuda")
    tabs = {"aware": aware.action_table(), "blind": blind.action_table()}
    verified = []
    for mode in modes:
        for name, tab in tabs.items():
            out = verify_backends(tab, traces[(mode, 0)], service=svc, energy_table=zeta,
                                  b_max=bm, buffer=SHED_BUFFER, slo=2.0,
                                  shed_expired=True, device="cuda")
            rep = out["python"]
            verified.append((mode, name, out["n_decisions"], rep.n_shed, rep.n_expired))
    stats = {}
    for (mode, s), tr in traces.items():
        for name, tab in tabs.items():
            r = simulate_compiled(tab, tr, means=means, zeta=zeta, b_max=bm,
                                  buffer=SHED_BUFFER, device="cuda")
            offered = r.n_admitted  # every door-seen arrival, refusals included
            stats.setdefault((mode, name), []).append(dict(
                goodput=r.n_served / r.t_final, drop_rate=r.n_shed / offered,
                W_mean=r.lat_sum / r.n_served,
                P95=float(histogram_quantiles(r.hist, r.hist_edges, [0.95])[0]),
                power=r.energy / r.t_final))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    log(f"shedding path launches: {counts} (wall {wall:.2f} s)")
    check(aware_launches == aware.rvi.iterations + 1,
          f"finite-buffer solve: {aware_launches} launches for {aware.rvi.iterations} + 1 backups")
    check(counts["bellman_banded"] > aware_launches, "blind solve skipped the Bellman kernel")
    n_runs = len(verified) + len(traces) * len(tabs)
    check(counts.get("serve_scan:qman", 0) == n_runs,
          f"{counts.get('serve_scan:qman', 0)} managed-queue launches for {n_runs} runs")
    for mode, name, n_dec, n_shed, n_exp in verified:
        log(f"verify_backends shedding {mode} {name} (seed 400, buffer {SHED_BUFFER}, slo 2.0, "
            f"shed_expired): python loop == event kernel, {n_dec} batches, n_shed {n_shed}, "
            f"n_expired {n_exp}")
        check(n_shed > 0 and n_exp > 0, f"{mode} {name}: nothing shed, the lane is not shown")
    banded = solve(aware_spec, device="cuda")
    cpu = solve(aware_spec, backup="pallas", device="cpu")
    check(np.array_equal(aware.policy, banded.policy), "finite-buffer solve: kernel vs banded f64")
    check(np.array_equal(aware.policy, cpu.policy), "finite-buffer solve: card vs CPU plain")
    serve_from = {k: int(np.argmax(t > 0)) for k, t in tabs.items()}
    log(f"finite-buffer solve (rho {SHED_RHO}, s_max = buffer = {SHED_BUFFER}, c_drop "
        f"{SHED_C_DROP}): {aware.rvi.iterations} iterations, {aware_launches} kernel launches, "
        f"policy == banded f64 == CPU plain; serve-from aware {serve_from['aware']} "
        f"blind {serve_from['blind']}")
    mean = {}
    for (mode, name), rs in sorted(stats.items()):
        mean[(mode, name)] = {k: float(np.mean([r[k] for r in rs])) for k in rs[0]}
        m = mean[(mode, name)]
        log(f"shedding {mode} {name} ({SHED_SEEDS} seeds x {SHED_N} arrivals, buffer "
            f"{SHED_BUFFER}): goodput={m['goodput']:.6f} /ms drop_rate={m['drop_rate']:.6f} "
            f"W={m['W_mean']:.6f} ms P95={m['P95']:.6f} ms power={m['power']:.6f} W")
    aware_gp, blind_gp = mean[("mmpp2", "aware")]["goodput"], mean[("mmpp2", "blind")]["goodput"]
    check(serve_from["aware"] < serve_from["blind"], f"serve-from {serve_from}")
    check(aware_gp > blind_gp, f"aware goodput {aware_gp} <= blind {blind_gp} on MMPP2")
    log(f"shedding gate: serve-from aware < blind, MMPP2 goodput aware {aware_gp:.6f} > "
        f"blind {blind_gp:.6f} ({100 * (aware_gp / blind_gp - 1):.3f}%)")

    # --- the managed-queue instance at one of these launches' shape ---------
    from repro_torch.serving.compiled import pad_arrivals

    tr = traces[("mmpp2", 0)]
    arr, _ = pad_arrivals(tr)
    args, _ = scan_inputs(torch, np, tabs["aware"][None, None], arr[None], np.ones((1, 1)),
                          means, zeta)
    kw = dict(t0=0.0, horizon=float("inf"), max_eps=2 * len(tr) + 2, drain=True,
              b_max=bm, buffer=SHED_BUFFER)
    rows["serve_scan_qman"] = dict(
        scan_check(torch, np, "serve_scan_qman", args, kw),
        replaces=SCAN_REPLACES.format(", qman=True"),
        launches=counts.get("serve_scan:qman", 0))


def adaptive_phase(torch, np, kernels, rows):
    """The AdaptiveController over a solved lambda bank under bursty MMPP:
    the bank through the spec-batched kernel, the controller inside the
    event kernel, counters zeroed just before and read just after."""
    from repro_torch.configs.googlenet_p4 import B_MAX as BM, energy_table, paper_spec, service
    from repro_torch.core import sweep_bank
    from repro_torch.serving import (AdaptiveController, AdaptiveLane, GreedyScheduler,
                                     ServingEngine, SMDPScheduler, TraceProcess,
                                     as_action_table, pad_arrivals_batch, run_grid,
                                     run_grid_adaptive, verify_backends)
    from repro_torch.serving.arrivals import MMPP2

    svc, en = service(), energy_table()
    w2 = BURSTY["w2"]
    mu_max = BM / float(svc.mean(BM))
    m = MMPP2(lam1=BURSTY["r1"] * mu_max, lam2=BURSTY["r2"] * mu_max,
              dwell1=BURSTY["dwell1"], dwell2=BURSTY["dwell2"])
    lam_grid = sorted({round(float(x), 9) for x in
                       [*np.linspace(m.lam1, m.lam2, BURSTY_POINTS), m.mean_rate]})
    traces_ad = [m.sample_arrivals(BURSTY_HORIZON, np.random.default_rng(300 + s))[0]
                 for s in range(BURSTY_SEEDS)]
    traces_sim = [m.sample_arrivals(BURSTY_HORIZON, np.random.default_rng(100 + s))[0]
                  for s in range(BURSTY_SEEDS)]
    means = np.array([0.0] + [float(svc.mean(b)) for b in range(1, BM + 1)])
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    bank = sweep_bank(paper_spec(rho=0.5, w2=w2), lam_grid, backup="pallas", device="cuda")
    bank_s = time.perf_counter() - t0

    def ctrl():
        return AdaptiveController(bank, w2=w2, **ADAPTIVE_KW)

    v_open = verify_backends(None, traces_ad[0], service=svc, energy_table=en, b_max=BM,
                             scheduler=ctrl, device="cuda")
    v_room = verify_backends(None, traces_ad[0], service=svc, energy_table=en, b_max=BM,
                             scheduler=ctrl, buffer=ADAPTIVE_BUFFER, device="cuda")
    keys, stacked = bank.stacked()
    greedy = as_action_table(GreedyScheduler(1, BM), BM)
    L = max(stacked.shape[1], len(greedy))
    pad = lambda t: np.concatenate([t, np.full(L - len(t), t[-1], dtype=np.int64)])  # noqa: E731
    tables = np.stack([pad(t) for t in stacked] + [pad(greedy)])
    arrs = pad_arrivals_batch(traces_sim)
    kw = dict(means=means, zeta=en, b_max=BM, device="cuda")
    t0 = time.perf_counter()
    g = run_grid(tables, arrs, **kw)
    t_grid = time.perf_counter() - t0
    lane = AdaptiveLane.from_controller(ctrl())
    arrs_ad = pad_arrivals_batch(traces_ad)
    t0 = time.perf_counter()
    ga = run_grid_adaptive(arrs_ad, adaptive=lane, **kw)
    t_grid_ad = time.perf_counter() - t0
    counts = kernels.launch_counts()
    log(f"adaptive path launches: {counts} (bank {len(lam_grid)} lambdas in {bank_s:.2f} s)")
    check(counts["bellman_banded_batched"] > 0, "sweep_bank skipped the spec-batched kernel")
    for inst in ("adaptive", "qman_adaptive", "grid_plain", "grid_adaptive"):
        check(counts.get(f"serve_scan:{inst}", 0) == 1,
              f"serve_scan:{inst} launched {counts.get(f'serve_scan:{inst}', 0)} times, not once")
    check(counts["serve_scan"] == 4, "the adaptive path made other event-kernel launches")
    rep_r = v_room["python"]
    log(f"verify_backends adaptive (seed 300, {len(traces_ad[0])} arrivals, "
        f"{len(lam_grid)}-entry bank): python controller == kernel lane, "
        f"{v_open['n_decisions']} batches; with buffer {ADAPTIVE_BUFFER}: "
        f"{v_room['n_decisions']} batches, n_shed {rep_r.n_shed} (never observed)")
    check(rep_r.n_shed > 0, "the buffer refused nothing: the unobserved refusals are not shown")

    # the Python engines on the same traces (host), held at rtol 1e-9
    t0 = time.perf_counter()
    py_cost = np.empty((len(traces_sim), len(tables)))
    for s, tr in enumerate(traces_sim):
        for p, tab in enumerate(tables):
            rep = ServingEngine(SMDPScheduler.from_table(tab), arrivals=TraceProcess(tr),
                                b_max=BM, service=svc, energy_table=en,
                                device="cpu").run(n_epochs=None)
            py_cost[s, p] = rep.weighted_cost(w2)
    t_py = time.perf_counter() - t0
    c_cost = g["w_mean"] + w2 * g["power"]
    check(np.allclose(c_cost, py_cost, rtol=1e-9, atol=0),
          f"run_grid cost off the Python engines by {np.max(np.abs(c_cost / py_cost - 1))}")
    t0 = time.perf_counter()
    py_ad = np.empty(len(traces_ad))
    py_sw = np.empty(len(traces_ad), dtype=np.int64)
    for s, tr in enumerate(traces_ad):
        c = ctrl()
        rep = ServingEngine(c, arrivals=TraceProcess(tr), b_max=BM, service=svc,
                            energy_table=en, device="cpu").run(n_epochs=None)
        py_ad[s], py_sw[s] = rep.weighted_cost(w2), c.n_switches
    t_py_ad = time.perf_counter() - t0
    ca_cost = ga["w_mean"] + w2 * ga["power"]
    check(np.allclose(ca_cost, py_ad, rtol=1e-9, atol=0),
          f"run_grid_adaptive cost off the Python engines by {np.max(np.abs(ca_cost / py_ad - 1))}")
    check(np.array_equal(ga["ad_n_switches"], py_sw), "run_grid_adaptive switches differ")
    best_fixed = float(np.min(py_cost[:, :-1].mean(0)))
    log(f"run_grid: {len(traces_sim)} seeds x {len(tables)} tables (bank + greedy) in one "
        f"launch, cost == Python engines at rtol 1e-9; events {g['events_total']}, "
        f"events/s compiled {g['events_total'] / t_grid:.0f} (wall {t_grid:.3f} s) python "
        f"{g['events_total'] / t_py:.0f} (wall {t_py:.2f} s)")
    log(f"run_grid_adaptive: {len(traces_ad)} seeds in one launch, cost == Python engines "
        f"at rtol 1e-9, switches {ga['ad_n_switches'].tolist()} equal; events "
        f"{ga['events_total']}, events/s compiled {ga['events_total'] / t_grid_ad:.0f} "
        f"(wall {t_grid_ad:.3f} s) python {ga['events_total'] / t_py_ad:.0f} "
        f"(wall {t_py_ad:.2f} s); mean cost adaptive {py_ad.mean():.6f} vs the best fixed "
        f"table {best_fixed:.6f} (other seeds, as in mmpp_bursty.py)")

    # --- each instance at the shape the path launched it --------------------
    from repro_torch.serving.compiled import pad_arrivals

    tr = traces_ad[0]
    arr, _ = pad_arrivals(tr)
    one = dict(t0=0.0, horizon=float("inf"), max_eps=2 * len(tr) + 2, drain=True, b_max=BM,
               record=True)
    args, ad = scan_inputs(torch, np, lane.tables, arr[None], np.ones((1, 2 * len(tr) + 2)),
                           means, en, adaptive=lane)
    rows["serve_scan_adaptive"] = dict(
        scan_check(torch, np, "serve_scan_adaptive", args, one, adaptive=ad),
        replaces=SCAN_REPLACES.format(", adaptive=True"),
        launches=counts["serve_scan:adaptive"])
    rows["serve_scan_qman_adaptive"] = dict(
        scan_check(torch, np, "serve_scan_qman_adaptive", args,
                   dict(one, buffer=ADAPTIVE_BUFFER), adaptive=ad),
        replaces=SCAN_REPLACES.format(", qman=True, adaptive=True"),
        launches=counts["serve_scan:qman_adaptive"])
    grid = dict(t0=0.0, horizon=float("inf"), drain=True, b_max=BM)
    n_max = int(np.isfinite(arrs).sum(1).max())
    args, _ = scan_inputs(torch, np, tables[:, None], arrs, np.ones((len(arrs), 1)), means, en)
    rows["serve_scan_grid_plain"] = dict(
        scan_check(torch, np, "serve_scan_grid_plain", args, dict(grid, max_eps=2 * n_max + 2)),
        replaces=SCAN_REPLACES.format(" under run_grid's vmap"),
        launches=counts["serve_scan:grid_plain"])
    n_max = int(np.isfinite(arrs_ad).sum(1).max())
    args, ad = scan_inputs(torch, np, lane.tables, arrs_ad, np.ones((len(arrs_ad), 1)), means,
                           en, adaptive=lane)
    rows["serve_scan_grid_adaptive"] = dict(
        scan_check(torch, np, "serve_scan_grid_adaptive", args,
                   dict(grid, max_eps=2 * n_max + 2), adaptive=ad),
        replaces=SCAN_REPLACES.format(", adaptive=True, under run_grid_adaptive's vmap"),
        launches=counts["serve_scan:grid_adaptive"])


# ---------------------------------------------------------------------------
# MMPP-aware serving: the exact phase-modulated solve, the belief kernel and
# the event kernel's belief lanes (examples/serve_mmpp_exact.py,
# examples/serve_belief_compiled.py, mmpp_bursty.py's exact_modulated
# section and roofline_report.py's belief grid)
# ---------------------------------------------------------------------------

#: serve_mmpp_exact.py's point: rho 0.10 / 0.85 of mu_max, dwell 4000 / 800,
#: w2 0.5, s_max 128 growing to at most 384; one 20 000 ms trace (seed 7)
EXACT = dict(r1=0.10, r2=0.85, w2=0.5, dwell1=4000.0, dwell2=800.0)
EXACT_S_CAP, EXACT_HORIZON, EXACT_SEED = 384, 20_000.0, 7
#: mmpp_bursty.py's exact_modulated section: s_cap 384, 5 seeds (500 + s)
GAP_SEEDS = 5
BELIEF_REPLACES = ("src/repro/serving/arrivals.py:431-467 (the lax.scan of "
                   "belief_forward_jax, not a Pallas kernel)")


def _lift(np, tab, s_max):
    """A 1-D table -> a feasible (S,) policy on an s_max chain (eq. 30)."""
    t = np.asarray(tab, dtype=np.int64)
    pol = np.array([t[min(s, len(t) - 1)] for s in range(s_max + 1)], dtype=np.int64)
    return np.append(pol, pol[s_max])


def belief_chain_ms(torch, np, c, b_init, t_init, arrs, steps):
    """The belief fold's chain alone (csrc/chain_floor.cu): `steps` guarded
    folds on one thread a trace, step matrices from a window of the trace's
    first gaps in shared memory, one block a trace."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels import belief_forward as bf

    S, K = arrs.shape[0], c.rates.shape[0]
    n = int(_build.function("chain_floor", "belief_floor_window", ctypes.c_longlong, [])())
    gaps = []
    for tr in arrs:
        x = np.resize(tr[np.isfinite(tr)], n)
        gaps.append(np.maximum(np.diff(np.concatenate([[t_init], x])), 0.0))
    win = bf.step_matrices(torch.as_tensor(np.stack(gaps), device="cuda"), c).contiguous()
    consts = bf.pack_consts(c, b_init, t_init)
    n_steps = torch.full((S,), int(steps), dtype=torch.int64, device="cuda")
    out = torch.empty((S, K), dtype=torch.float64, device="cuda")
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    fn = _build.function("chain_floor", "belief_floor_launch", ctypes.c_int,
                         [vp] * 3 + [ll] * 2 + [vp] * 2)

    def launch():
        check(fn(win.data_ptr(), consts.data_ptr(), n_steps.data_ptr(), S, K, out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream) == 0, "belief chain floor launch")

    ms = event_ms(torch, launch)
    check(bool(torch.isfinite(out).all()), "belief chain floor: non-finite belief")
    return ms


def belief_unsafe_case(torch, np, filt, arrs, n_prefix=2048):
    """The belief kernel where pass B must fold chunks exactly: one call's
    rows against a one-chunk call (C = N, a serial fold) over every slot and
    against the plain fold over the first ``n_prefix`` slots (a call's rows
    over a prefix are the prefix call's), atol 1e-12 with argmax rows equal;
    timed as the path's row is (CUDA events around one call, best of 3)."""
    from repro_torch.kernels import belief_forward as bf

    times = torch.as_tensor(arrs, device="cuda")
    b_init = torch.as_tensor(filt.belief, device="cuda")
    c = filt.consts(torch.device("cuda"))
    S, N = arrs.shape
    *got, unsafe = bf._launch(times, b_init, filt._last, c, bf.CHUNK)
    one = bf._launch(times, b_init, filt._last, c, N)
    err_one = (got[0] - one[0]).abs().max().item()
    check(err_one <= 1e-12 and torch.equal(got[0].argmax(-1), one[0].argmax(-1)),
          f"belief_forward: off its one-chunk call by {err_one}")
    n = min(n_prefix, N)
    want = bf.belief_forward_ref(times[:, :n].contiguous(), b_init, filt._last, c)
    err_pre = (got[0][:, :n] - want[0]).abs().max().item()
    check(err_pre <= 1e-12 and torch.equal(got[0][:, :n].argmax(-1), want[0].argmax(-1)),
          f"belief_forward: off the plain fold by {err_pre} over the first {n} slots")
    ms = event_ms(torch, lambda: bf.belief_forward(times, b_init, filt._last, c))
    return dict(ms=ms, unsafe_chunks=int(unsafe.sum()),
                chunks_with_a_product=S * max(-(-N // bf.CHUNK) - 1, 0),
                max_abs_err_one_chunk=err_one, max_abs_err_prefix=err_pre, prefix=n,
                shape=[S, N, len(filt.rates)])


def belief_row(torch, np, filt, arrs, launches):
    """The belief kernel at the bursty batch's shape against its plain
    version on the card (atol 1e-12, argmax rows equal) and against a
    one-chunk call of itself (C = N: a serial fold); two calls equal bit for
    bit, and a call on a prefix of the slots equal to the full call's rows
    there; timed as its earlier design was (CUDA events around one wrapper
    call, best of 3) and as device time in a CUDA graph, beside the chain
    floors and its earlier time; then timed where pass B folds chunks
    exactly (repeated times, a 3-phase cycle)."""
    from repro_torch.kernels import belief_forward as bf
    from repro_torch.serving import PhaseBeliefFilter

    dev = torch.device("cuda")
    times = torch.as_tensor(arrs, device=dev)
    b_init = torch.as_tensor(filt.belief, device=dev)
    c = filt.consts(dev)
    *got, unsafe = bf._launch(times, b_init, filt._last, c, bf.CHUNK)
    torch.cuda.synchronize()
    unsafe = int(unsafe.sum())
    t0 = time.perf_counter()
    want = bf.belief_forward_ref(times, b_init, filt._last, c)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    err = (got[0] - want[0]).abs().max().item()
    check(err <= 1e-12, f"belief_forward: max abs err {err} above 1e-12")
    check(torch.equal(got[0].argmax(-1), want[0].argmax(-1)), "belief_forward argmax rows differ")
    check((got[1] - want[1]).abs().max().item() <= 1e-12 and torch.equal(got[2], want[2]),
          "belief_forward final state differs")
    again = bf.belief_forward(times, b_init, filt._last, c)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "belief_forward: two calls differ")
    S, N = arrs.shape
    for n in (1, bf.CHUNK - 1, bf.CHUNK + 1, N // 2 + 3):
        pre = bf.belief_forward(times[:, :n].contiguous(), b_init, filt._last, c)
        check(torch.equal(pre[0], got[0][:, :n]), f"belief_forward: prefix {n} differs")
    one = bf._launch(times, b_init, filt._last, c, N)
    err_one = (got[0] - one[0]).abs().max().item()
    check(err_one <= 1e-12 and torch.equal(got[0].argmax(-1), one[0].argmax(-1)),
          f"belief_forward: off its one-chunk call by {err_one}")
    # one wrapper call as the earlier design was timed (its host work, the
    # allocations and the ctypes call, included), and the device time of a
    # call (its three kernels) in a CUDA graph of 20
    best = event_ms(torch, lambda: bf.belief_forward(times, b_init, filt._last, c))
    dev_ms = device_ms(torch, lambda: bf.belief_forward(times, b_init, filt._last, c), 20)
    one_ms = event_ms(torch, lambda: bf._launch(times, b_init, filt._last, c, N))
    K = len(filt.rates)
    n_valid = int(np.isfinite(arrs).sum())
    n_long = int(np.isfinite(arrs).sum(1).max())  # the longest trace: a serial fold's chain
    # the floor: one chunk's fold chain (pass C's lanes each fold a chunk);
    # a serial fold over the longest trace is what the earlier design ran
    floor = belief_chain_ms(torch, np, c, b_init, filt._last, arrs, bf.CHUNK)
    serial = belief_chain_ms(torch, np, c, b_init, filt._last, arrs, n_long)
    # bytes: the times read, the rows and the final state written; operations:
    # per valid slot the step matrix (K exps, 4K^3 + 8K^2 flops) and the fold
    n_bytes = 8 * S * N * (1 + K) + 8 * S * (K + 1) + 8 * (6 * K * K + 5 * K + 1)
    flops = n_valid * (4 * K ** 3 + 8 * K * K + 10 * K)
    b_ms, b_by = bound(n_bytes, flops, F64_FLOPS)
    log(f"belief_forward ({S} traces x {N} slots, {n_valid} arrivals, the longest trace "
        f"{n_long}, K={K}, chunks of {bf.CHUNK}; {CARD[0]}): kernel_ms={best:.6f} (events "
        f"around one call, best of 3, as earlier_ms was taken) device_ms={dev_ms:.6f} (a "
        f"call's kernels in a CUDA graph of 20) plain_ms={plain:.3f} (the plain torch fold "
        f"on the card) bound_ms={b_ms:.6f} ({b_by}) floor_ms={floor:.6f} (the fold chain "
        f"alone over {bf.CHUNK} arrivals, a chunk: kernel {best / floor:.3f}x it) "
        f"serial_fold_ms={serial:.6f} (the fold chain alone over the longest trace, "
        f"{n_long} arrivals: what the earlier design walked) "
        f"earlier_ms={EARLIER_MS['belief_forward']} (quoted, PERF.md; "
        f"{EARLIER_MS['belief_forward'] / best:.1f}x) one-chunk call (C = N) {one_ms:.6f} "
        f"ms; max_abs_err={err:.3e} against the plain fold, {err_one:.3e} against the "
        f"one-chunk call (atol 1e-12), argmax rows equal; {unsafe} chunks folded exactly "
        f"in pass B; deterministic and prefix-stable bit for bit")
    # pass B's exact folds.  A gap of exactly 0 (a repeated time) gives E =
    # I up to rounding: this filter's E(0) has no entry below zero, so its
    # chunks stay safe, but the card tests' two-phase filter (rates 0.26 /
    # 2.79, the same dwells) leaves -4e-21 off the diagonal, and a 3-phase
    # cycle (complex eigenvalues) too.  On times rounded to 1 ms nearly
    # every chunk then holds a repeated time and is folded exactly.
    a3 = 1 / 300
    cycle3 = PhaseBeliefFilter([0.3, 1.1, 2.6], [[-a3, a3, 0.0], [0.0, -a3, a3],
                                                 [a3, 0.0, -a3]])
    mmpp2 = PhaseBeliefFilter([0.26, 2.79], [[-1 / 4000, 1 / 4000], [1 / 800, -1 / 800]])
    rounded = np.round(arrs)
    unsafe_cases = {
        "rounded_to_1ms": belief_unsafe_case(torch, np, filt, rounded),
        "rounded_to_1ms_test_filter": belief_unsafe_case(torch, np, mmpp2, rounded),
        "k3_cycle": belief_unsafe_case(torch, np, cycle3, arrs),
        "k3_cycle_rounded_to_1ms": belief_unsafe_case(torch, np, cycle3, rounded),
    }
    for name, u in unsafe_cases.items():
        log(f"belief_forward where pass B folds exactly, {name} ({u['shape']}; {CARD[0]}): "
            f"kernel_ms={u['ms']:.6f} (events around one call, best of 3; earlier_ms="
            f"{EARLIER_MS['belief_forward']} on the path's traces) with "
            f"{u['unsafe_chunks']} of {u['chunks_with_a_product']} chunks folded exactly; "
            f"max_abs_err {u['max_abs_err_one_chunk']:.3e} against the one-chunk call, "
            f"{u['max_abs_err_prefix']:.3e} against the plain fold over the first "
            f"{u['prefix']} slots (atol 1e-12), argmax rows equal")
    return dict(route="cuda", source="src/repro_torch/kernels/csrc/belief_forward.cu",
                replaces=BELIEF_REPLACES, launches=launches, max_abs_err=err, ms=best,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                device_ms=dev_ms, floor_ms=floor, serial_fold_ms=serial, one_chunk_ms=one_ms,
                max_abs_err_one_chunk=err_one, unsafe_chunks=unsafe, chunk=bf.CHUNK,
                shape=[S, N, K], longest_trace=n_long, unsafe_cases=unsafe_cases)


def mmpp_phase(torch, np, kernels, rows, main_res, energy):
    """Exact MMPP-aware serving on the card, counters zeroed just before and
    read just after: the product-chain solve, the five contenders of one
    trace, the belief kernel over the bursty batch, the belief grid lanes and
    the exact_modulated gaps."""
    from repro_torch.configs.googlenet_p4 import B_MAX as BM, energy_table, paper_spec, service
    from repro_torch.core import (PhaseConfig, build_smdp_modulated, evaluate_policy_modulated,
                                  modulated_spec, solve_modulated, sweep_bank)
    from repro_torch.serving import (AdaptiveController, BeliefPhaseScheduler,
                                     OraclePhaseScheduler, PhaseBeliefFilter, ServingEngine,
                                     SMDPScheduler, TraceProcess, belief_forward,
                                     pad_arrivals_batch, run_grid, solve_phase_policies,
                                     verify_backends)
    from repro_torch.serving.arrivals import MMPP2
    from repro_torch.serving.compiled import pad_arrivals

    svc, en = service(), energy_table()
    mu_max = BM / float(svc.mean(BM))
    means = np.array([0.0] + [float(svc.mean(b)) for b in range(1, BM + 1)])
    kernels.reset_launch_counts()
    t_phase = time.perf_counter()

    # --- 1. the serve_mmpp_exact point: exact solve on the card ------------
    w2 = EXACT["w2"]
    m = MMPP2(lam1=EXACT["r1"] * mu_max, lam2=EXACT["r2"] * mu_max,
              dwell1=EXACT["dwell1"], dwell2=EXACT["dwell2"])
    phases = PhaseConfig.from_mmpp(m)
    spec = modulated_spec(paper_spec(rho=0.5, w2=w2), phases)
    sink = []
    t0 = time.perf_counter()
    exact = solve_modulated(spec, phases, max_s_max=EXACT_S_CAP, device="cuda",
                            report_sink=sink)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    check(not sink[0].any_fired and sink[0].healthy.all(),
          f"modulated solve: guard rungs fired {sink[0].rungs}")
    cpu = solve_modulated(spec, phases, max_s_max=EXACT_S_CAP, device="cpu")
    check(cpu.spec.s_max == exact.spec.s_max, "modulated solve: s_max card vs CPU")
    check(np.array_equal(exact.policy, cpu.policy), "modulated solve: policy card vs CPU")
    for k in ("g", "w_bar", "p_bar"):
        a, b = getattr(exact.eval, k), getattr(cpu.eval, k)
        check(abs(a - b) <= 1e-9 * abs(b), f"modulated solve: {k} {a} vs CPU {b}")
    busy = profile_busy(torch, lambda: solve_modulated(spec, phases, max_s_max=EXACT_S_CAP,
                                                       device="cuda"))
    busy_txt = ("not measured (no device time in the profile)" if busy[0] is None else
                f"{busy[0]:.3f} ms of device time in {busy[1]} kernels, busy share "
                f"{busy[0] / 1e3 / solve_s:.3f} of the unprofiled wall")
    log(f"exact modulated solve (rho {EXACT['r1']}/{EXACT['r2']}, dwell "
        f"{EXACT['dwell1']:.0f}/{EXACT['dwell2']:.0f}, w2 {w2}): s_max={exact.spec.s_max} "
        f"iterations={exact.rvi.iterations} g={exact.eval.g:.9f} W={exact.eval.w_bar:.6f} ms "
        f"P={exact.eval.p_bar:.6f} W wall_s={solve_s:.3f} rvi_s={exact.rvi.wall_time_s:.3f}; "
        f"{busy_txt}; policy == CPU plain path, g / W / P within rtol 1e-9, no rung fired")
    s_max = exact.spec.s_max
    heur = solve_phase_policies(paper_spec(rho=0.5, w2=w2),
                                {z: float(r) for z, r in enumerate(phases.rates)},
                                backup="pallas", device="cuda")
    heur_pol = np.stack([_lift(np, heur[z], s_max) for z in range(phases.n_phases)])
    mb = build_smdp_modulated(exact.spec, phases)
    g_heur = evaluate_policy_modulated(mb, 0, heur_pol).g
    check(g_heur >= exact.eval.g * (1 - 1e-9), f"heuristic g {g_heur} below exact {exact.eval.g}")
    k1 = solve_modulated(main_res.spec, PhaseConfig.poisson(main_res.spec.lam), device="cuda")
    check(np.array_equal(k1.policy[0], main_res.policy) and k1.spec.s_max == main_res.spec.s_max,
          "K = 1 modulated solve differs from the main path's policy")
    log(f"phase heuristic (per-phase Poisson solves on the Bellman kernel) on the exact chain: "
        f"g={g_heur:.9f} >= exact {exact.eval.g:.9f} (exact gains "
        f"{100 * (g_heur - exact.eval.g) / g_heur:.3f}%); K = 1 rail: the Table-I point through "
        f"solve_modulated == the main path's policy (s_max {k1.spec.s_max})")

    # --- 2. one trace served five ways, each certified ---------------------
    trace, switches = m.sample_arrivals(EXACT_HORIZON, np.random.default_rng(EXACT_SEED))
    trace = np.asarray(trace)
    stack = exact.action_table()
    lam_grid = [round(f * phases.mean_rate, 9) for f in (0.6, 0.8, 1.0, 1.2, 1.4)]
    t0 = time.perf_counter()
    mod_bank = sweep_bank(paper_spec(rho=0.5, w2=w2), lam_grid, phases=phases,
                          max_s_max=EXACT_S_CAP, device="cuda")
    bank_s = time.perf_counter() - t0

    def filt():
        return PhaseBeliefFilter(phases.rates, phases.gen)

    contenders = {
        "exact+oracle": lambda: OraclePhaseScheduler(dict(enumerate(stack)), switches),
        "heuristic+oracle": lambda: OraclePhaseScheduler(heur, switches),
        "exact+belief_argmax": lambda: BeliefPhaseScheduler(stack, filt()),
        "exact+belief_mix": lambda: BeliefPhaseScheduler(stack, filt(), mode="mix"),
        "adaptive+filter": lambda: AdaptiveController(mod_bank, w2=w2, phase_filter=filt(),
                                                      **ADAPTIVE_KW),
    }
    for name, mk in contenders.items():
        out = verify_backends(None, trace, service=svc, energy_table=en, b_max=BM,
                              scheduler=mk, device="cuda")
        t0 = time.perf_counter()
        rep = ServingEngine(mk(), arrivals=TraceProcess(trace), b_max=BM, service=svc,
                            energy_table=en, seed=0, device="cuda").run(
                                n_epochs=None, backend="compiled")
        wall = time.perf_counter() - t0
        check(np.array_equal(rep.batch_sizes, out["python"].batch_sizes),
              f"{name}: engine run differs from the Python loop")
        log(f"{name:20s} ({len(trace)} arrivals): python loop == compiled, "
            f"{out['n_decisions']} batches, max latency err {out['max_latency_err']:.3e}; "
            f"cost={rep.weighted_cost(w2):.6f} W={rep.latencies.mean():.6f} ms "
            f"P={rep.power:.6f} W P95={rep.percentile(95):.6f} ms (compiled wall {wall:.3f} s)")
    log(f"modulated bank: {len(lam_grid)} (K, S) stacks by sweep_bank(phases=) in {bank_s:.2f} s")

    # --- 3. the bursty scenario: belief kernel, belief grids, exact gaps ----
    b = BURSTY
    mb_ = MMPP2(lam1=b["r1"] * mu_max, lam2=b["r2"] * mu_max, dwell1=b["dwell1"],
                dwell2=b["dwell2"])
    ph_b = PhaseConfig.from_mmpp(mb_)
    lam_b = sorted({round(float(x), 9) for x in
                    [*np.linspace(mb_.lam1, mb_.lam2, BURSTY_POINTS), mb_.mean_rate]})
    pbank = sweep_bank(paper_spec(rho=0.5, w2=b["w2"]), lam_b, backup="pallas", device="cuda")
    exact_b = solve_modulated(modulated_spec(paper_spec(rho=0.5, w2=b["w2"]), ph_b), ph_b,
                              max_s_max=EXACT_S_CAP, device="cuda")
    sb = exact_b.spec.s_max
    heur_b = np.stack([_lift(np, pbank.tables[pbank.nearest(lam=lam, w2=b["w2"])], sb)
                       for lam in (mb_.lam1, mb_.lam2)])
    single_b = np.tile(_lift(np, pbank.tables[pbank.nearest(lam=mb_.mean_rate, w2=b["w2"])],
                             sb)[None], (2, 1))
    mbb = build_smdp_modulated(exact_b.spec, ph_b)
    g_ex = float(exact_b.eval.g)
    g_he = float(evaluate_policy_modulated(mbb, 0, heur_b).g)
    g_si = float(evaluate_policy_modulated(mbb, 0, single_b).g)
    check(g_ex <= g_he * (1 + 1e-9), "exact_modulated: exact worse than the heuristic on its chain")
    tables3 = np.stack([exact_b.action_table(sb), heur_b[:, : sb + 1], single_b[:, : sb + 1]])
    traces_g, streams = [], []
    for s_ in range(GAP_SEEDS):
        tr, sw = mb_.sample_arrivals(BURSTY_HORIZON, np.random.default_rng(500 + s_))
        st = np.array([t for t, _ in sw])
        sp = np.array([p for _, p in sw], dtype=np.int64)
        traces_g.append(np.asarray(tr))
        streams.append(sp[np.maximum(np.searchsorted(st, tr, side="right") - 1, 0)])
    verify_backends(tables3[0], traces_g[0], service=svc, energy_table=en, b_max=BM,
                    phases=streams[0], device="cuda")
    arrs_g = pad_arrivals_batch(traces_g)
    phs = np.stack([pad_arrivals(t, phases=p_, size=arrs_g.shape[1])[2]
                    for t, p_ in zip(traces_g, streams)])
    gg = run_grid(tables3, arrs_g, phases=phs, means=means, zeta=en, b_max=BM, device="cuda")
    sim = (gg["w_mean"] + b["w2"] * gg["power"]).mean(0)
    log(f"exact_modulated (bursty, s_cap {EXACT_S_CAP}, s_max {sb}, {GAP_SEEDS} seeds): chain "
        f"g exact {g_ex:.6f} heuristic {g_he:.6f} single {g_si:.6f}, gaps heuristic "
        f"{100 * (g_he - g_ex) / g_he:.3f}% single {100 * (g_si - g_ex) / g_si:.3f}%; simulated "
        f"W + w2 P exact {sim[0]:.6f} heuristic {sim[1]:.6f} single {sim[2]:.6f}, gaps "
        f"heuristic {100 * (sim[1] - sim[0]) / sim[1]:.3f}% single "
        f"{100 * (sim[2] - sim[0]) / sim[2]:.3f}% (phase lane verified on seed 500)")

    traces_b = [np.asarray(mb_.sample_arrivals(BURSTY_HORIZON, np.random.default_rng(100 + s_))[0])
                for s_ in range(BURSTY_SEEDS)]
    arrs_b = pad_arrivals_batch(traces_b)
    f_b = PhaseBeliefFilter(ph_b.rates, ph_b.gen)
    t0 = time.perf_counter()
    bel_b = belief_forward(arrs_b, f_b, device="cuda")[0]
    torch.cuda.synchronize()
    bel_s = time.perf_counter() - t0
    stacks_b = tables3[:2]  # exact and heuristic (K, L) stacks
    grid = {}
    for pm in ("belief_argmax", "belief_mix"):
        t0 = time.perf_counter()
        grid[pm] = run_grid(stacks_b, arrs_b, phase_mode=pm, beliefs=bel_b, means=means,
                            zeta=en, b_max=BM, device="cuda")
        grid[pm]["wall"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for pm, g in grid.items():
        mode = "mix" if pm == "belief_mix" else "argmax"
        py = np.empty((len(traces_b), len(stacks_b)))
        for s_, tr in enumerate(traces_b):
            for p_, tab in enumerate(stacks_b):
                rep = ServingEngine(BeliefPhaseScheduler(tab, PhaseBeliefFilter(ph_b.rates, ph_b.gen),
                                                         mode=mode),
                                    arrivals=TraceProcess(tr), b_max=BM, service=svc,
                                    energy_table=en, device="cpu").run(n_epochs=None)
                py[s_, p_] = rep.weighted_cost(b["w2"])
        c_cost = g["w_mean"] + b["w2"] * g["power"]
        check(np.allclose(c_cost, py, rtol=1e-9, atol=0),
              f"run_grid {pm}: off the Python engines by {np.max(np.abs(c_cost / py - 1))}")
        log(f"run_grid {pm}: {len(traces_b)} seeds x {len(stacks_b)} stacks (exact, heuristic) "
            f"in one launch, every lane's W + w2 P == its Python engine at rtol 1e-9; events "
            f"{g['events_total']}, wall {g['wall']:.3f} s; mean cost exact "
            f"{py[:, 0].mean():.6f} heuristic {py[:, 1].mean():.6f}")
    t_py = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_phase
    counts = kernels.launch_counts()
    log(f"mmpp path launches: {counts} (phase wall {wall:.2f} s, of it the Python engines of "
        f"the grids {t_py:.2f} s; belief_forward over the batch {bel_s:.3f} s of wall)")
    for name in ("bellman_banded", "bellman_banded_batched", "belief_forward",
                 "serve_scan:mix", "serve_scan:grid_mix", "serve_scan:plain",
                 "serve_scan:adaptive", "serve_scan:grid_plain"):
        check(counts.get(name, 0) > 0, f"the MMPP path never launched {name}")

    # --- each new kernel (instance) at the shape this path launched it ------
    rows["belief_forward"] = belief_row(torch, np, f_b, arrs_b, counts["belief_forward"])
    from repro_torch.serving.compiled import pad_arrivals as pad

    arr1, _ = pad(trace)
    bel1 = belief_forward(arr1, filt(), device="cuda")[0].cpu()[None]
    n1 = len(trace)
    args, _ = scan_inputs(torch, np, stack[None], arr1[None], np.ones((1, 2 * n1 + 2)),
                          means, en)
    one = dict(t0=0.0, horizon=float("inf"), max_eps=2 * n1 + 2, drain=True, b_max=BM,
               record=True)
    rows["serve_scan_mix"] = dict(
        scan_check(torch, np, "serve_scan_mix", args, one, beliefs=bel1),
        replaces=SCAN_REPLACES.format(", mix=True"), launches=counts["serve_scan:mix"])
    n_max = int(np.isfinite(arrs_b).sum(1).max())
    args, _ = scan_inputs(torch, np, stacks_b, arrs_b, np.ones((len(arrs_b), 1)), means, en)
    rows["serve_scan_grid_mix"] = dict(
        scan_check(torch, np, "serve_scan_grid_mix", args,
                   dict(t0=0.0, horizon=float("inf"), max_eps=2 * n_max + 2, drain=True,
                        b_max=BM), beliefs=bel_b.cpu()),
        replaces=SCAN_REPLACES.format(", mix=True, under run_grid's vmap"),
        launches=counts["serve_scan:grid_mix"])


FLEET_SOURCE = "src/repro_torch/kernels/csrc/fleet_scan.cu"
#: the walking kernels' times before their redesign, by row (ms; PERF.md
#: section 6: chip_smoke.py runs of the first designs on an NVIDIA H100
#: 80GB HBM3 at 700 W).  Quoted on the rows' log lines and on a line of their
#: own, never in the `kernels` line: not measured here.
EARLIER_MS = {"fleet_scan": 15.788, "fleet_scan_grid": 53.927, "fleet_scan_mix": 55.729,
              "sim_scan": 135.708, "belief_forward": 16.258, "mmpp_sample": 4.908}
#: the card's name and power limit (nvidia-smi), set by main: every time
#: the walking kernels' rows print names it
CARD = []
FLEET_REPLACES = ("src/repro/serving/fleet.py:551 (the lax.scan of _fleet_scan_core{}, "
                  "with its per-request reconstruction :558-648; not a Pallas kernel)")
FLEET_M, FLEET_RHO, FLEET_N, FLEET_SEEDS = 4, 0.7, 20_000, 4  # fleet_frontier.py
FLEET_ROUTERS = ("jsq", "batch_aware", "rr", "pow2")
FLEET_STREAM_CHUNK, FLEET_STREAM_CHUNKS = 8192, 16
EXAMPLE_M, EXAMPLE_SEEDS = 8, 3  # examples/serve_fleet.py
DEGRADED_BMAX, DEGRADED_N, DEGRADED_CERT_N, DEGRADED_SEEDS = 16, 8000, 1200, 4
DEGRADED_BUFFER = 24
SEVERITIES = {  # benchmarks/degraded_frontier.py
    "none": None,
    "moderate": dict(mtbf=60.0, mttr=5.0, p_straggle=0.05, straggle_mult=3.0),
    "severe": dict(mtbf=25.0, mttr=8.0, p_straggle=0.15, straggle_mult=4.0),
}


def fleet_inputs(np, tables, traces, rids, *, means, zeta, b_max, faults=None,
                 buffer=None, slo=None, beliefs=None):
    """The fleet kernel's card tensors for (P, M, K, L) table stacks over S
    traces and the router ids, built as serving.fleet builds them for
    simulate_fleet (S = P = R = 1) and run_fleet_grid: padded traces, pow2
    uniforms from seed 0, unit draws, a fresh state; ``beliefs`` (one (n,
    K) posterior a trace) selects the mix rule."""
    from repro_torch.serving import fleet

    P, M, K, L = tables.shape
    rows = []
    for s, tr in enumerate(traces):
        phases = bel = None
        if beliefs is not None:
            phases, bel = fleet._belief_phases("belief_mix", beliefs[s], None, K)
        rows.append(fleet._prep_inputs(
            tables[0], tr, means=means, zeta=zeta, draws=None, b_max=b_max,
            deadlines=None, phases=phases, slo=slo, hist_edges=None, router_u=None,
            router_seed=0, bel=bel))
    arr, dl, ph = (np.stack([r[i] for r in rows]) for i in (1, 2, 3))
    bel = None if beliefs is None else np.stack([r[4] for r in rows])
    _, _, _, _, _, _, means_a, zeta_a, _, edges = rows[0]
    fb, fmult, max_retries = fleet._prep_faults(faults, M)
    max_eps, cap, _ = fleet._budgets(int(np.isfinite(arr).sum(axis=1).max()), M,
                                     int(np.isfinite(fb).sum()))
    busy0, state0 = fleet._fresh_state(M)
    q0 = np.full((M, 1), np.inf)
    return fleet._kernel_args(
        "cuda", tables, np.stack([fleet.threshold_gaps(t) for t in tables]),
        np.asarray(rids), arr, dl, ph, np.random.default_rng(0).random(arr.shape + (2,)),
        np.ones((len(arr), 1)), means_a, zeta_a, edges, fb, fmult, q0, q0, busy0, state0,
        bel, None if bel is None else bel[:, 0], t0=0.0, horizon=np.inf, max_eps=max_eps,
        drain=True, b_max=b_max, buf_cap=fleet._NO_BUFFER if buffer is None else buffer,
        max_retries=max_retries, cap=cap)


def event_ms(torch, fn, reps=3):
    """Best of `reps` single launches, CUDA events around each (warm first)."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def _window(np, x, n):
    """The first n finite entries of x, the run replayed with an offset
    when x has fewer (chain_floor.cu's arrival window)."""
    x = np.asarray(x, dtype=np.float64)
    x = x[np.isfinite(x)]
    out, base = [], 0.0
    span = x[-1] - x[0] + (x[-1] - x[0]) / max(len(x) - 1, 1)
    while sum(len(o) for o in out) < n:
        out.append(x + base)
        base += span
    return np.concatenate(out)[:n]


def fleet_chain_ms(torch, np, call, ref):
    """The fleet walk's chain alone (csrc/chain_floor.cu): each lane walks
    the steps its plain walk took (n_steps_used), M replicas in registers,
    arrival times from a window of its own trace in shared memory, one
    block a lane as the kernel launches them.  Returns (ms, the floor's
    admissions over the lanes)."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels import fleet_scan as fk

    args, _ = call
    tables, rids, arr, means, zeta = args[0], args[2], args[3], args[8], args[9]
    beliefs = args[17] if len(args) > 17 else None
    P, M, K, L = tables.shape
    S, size = arr.shape
    R = len(rids)
    lanes = S * P * R
    win_n = int(_build.function("chain_floor", "chain_floor_window", ctypes.c_longlong, [])())
    host = arr.cpu().numpy()
    win = torch.as_tensor(np.stack([_window(np, host[ln // (P * R)], win_n)
                                    for ln in range(lanes)]), device="cuda")
    bel = None
    if beliefs is not None:
        b = beliefs.cpu().numpy()
        bel = torch.as_tensor(np.stack([np.resize(b[ln // (P * R)], (win_n, K))
                                        for ln in range(lanes)]), device="cuda")
    steps = ref.agg_i[:, fk.AGG_I.index("n_steps_used")].contiguous().cuda()
    out = torch.empty((lanes, 3), dtype=torch.float64, device="cuda")
    tab = tables[0].contiguous()
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    fn = _build.function("chain_floor", "fleet_floor_launch", ctypes.c_int,
                         [vp] * 7 + [ll] * 5 + [ctypes.c_double] * 2 + [ctypes.c_int, vp])

    def launch():
        check(fn(win.data_ptr(), tab.data_ptr(), None if bel is None else bel.data_ptr(),
                 means.data_ptr(), zeta.data_ptr(), steps.data_ptr(), out.data_ptr(), lanes,
                 M, K, L, len(means) - 1, 1.0, 1.0, int(bel is not None),
                 torch.cuda.current_stream().cuda_stream) == 0, "fleet chain floor launch")

    ms = event_ms(torch, launch)
    check(bool(torch.isfinite(out).all()), "fleet chain floor: non-finite clock")
    return ms, int(out[:, 2].sum())


def sim_chain_ms(torch, np, args, kw):
    """The simulator walk's chain alone (csrc/chain_floor.cu): E epochs of
    the policy, the service time, the run of offset sums and the state
    update, gaps from a window of the lane's stream in shared memory.
    Returns (ms, the floor's arrivals consumed)."""
    import ctypes

    from repro_torch.kernels import _build

    pol, means, en, svc, arr = args[0], args[1], args[2], args[5], args[6]
    n = int(_build.function("chain_floor", "chain_floor_window", ctypes.c_longlong, [])())
    gaps = (arr[0, :n] / kw["lam"]).contiguous()
    W = svc.shape[2]
    units = (svc[0, :n, W - 1] if W else torch.ones(n, dtype=torch.float64,
                                                    device="cuda")).contiguous()
    E = svc.shape[1]
    out = torch.empty(4, dtype=torch.float64, device="cuda")
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    fn = _build.function("chain_floor", "sim_floor_launch", ctypes.c_int,
                         [vp, vp, vp, ll, vp, vp, ll, ll, ll, ctypes.c_int, vp, vp])

    def launch():
        check(fn(gaps.data_ptr(), units.data_ptr(), pol.data_ptr(), len(pol), means.data_ptr(),
                 en.data_ptr(), len(means), E, int(kw["k_max"]), int(kw["fam"]),
                 out.data_ptr(), torch.cuda.current_stream().cuda_stream) == 0,
              "sim chain floor launch")

    ms = event_ms(torch, launch)
    check(bool(torch.isfinite(out).all()), "sim chain floor: non-finite output")
    return ms, int(out[3])


#: SASS instructions a kernel instance, from cuobjdump -sass of the built
#: libraries (main fills it for fleet_scan and sim_scan)
SASS = {}


def sass_counts(name):
    """{kernel function: SASS instructions} of csrc/<name>.cu's library."""
    from repro_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    res = subprocess.run([tool, "-sass", str(_build._target(name)[0])],
                         capture_output=True, text=True)
    check(res.returncode == 0, f"cuobjdump -sass failed for {name}: {res.stderr[-500:]}")
    counts, fn = {}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn and line.strip().startswith("/*") and ";" in line:
            counts[fn] += 1
    check(len(counts) > 0, f"cuobjdump found no kernels in {name}")
    return counts


def fleet_row(torch, np, name, call, reps=3):
    """One fleet-kernel launch on the card against its plain version on the
    same inputs: every output equal.  Returns the row's measured numbers."""
    from repro_torch.kernels import fleet_scan as fk

    args, kw = call
    fk.fleet_scan(*args, **kw)  # warm
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fk.fleet_scan(*args, **kw)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    cpu = [None if a is None else a.cpu() for a in args]
    t0 = time.perf_counter()
    ref = fk.fleet_scan_ref(*cpu, **kw)
    plain = (time.perf_counter() - t0) * 1e3
    got = [x.cpu() for x in out[:5]]
    for field, g, r in zip(fk.FleetOut._fields, got, ref[:5]):
        check(torch.equal(g, r), f"{name}: {field} differs from the plain version")
    if ref.rec is not None:
        for field, g, r in zip(fk.FleetRecord._fields, out.rec, ref.rec):
            check(torch.equal(g.cpu(), r), f"{name}: record {field} differs")
    err = max((got[1] - ref.agg_f).abs().max().item(),
              (got[3] - ref.busy).nan_to_num(0.0, 0.0, 0.0).abs().max().item())
    a = {k: ref.agg_i[:, i].numpy() for i, k in enumerate(fk.AGG_I)}
    rep = {k: ref.rep_i[:, i].numpy() for i, k in enumerate(fk.REP_I)}  # (lanes, M)
    tables, rids, arr = args[0], args[2].tolist(), args[3]
    S, size = arr.shape
    P, M, K, L = tables.shape
    R = len(rids)
    lanes = S * P * R
    lane = np.arange(lanes)
    rid = np.array(rids)[lane % R]
    served = rep["n_srv"].sum(1)
    mix = len(args) > 17 and args[17] is not None
    n_draws, nfb, n_mult = args[7].shape[1], args[11].shape[1], args[12].shape[1]

    def once(group, n, x):
        # elements shared by the lanes of a group are read once: count the
        # most any lane of the group reads
        most = np.zeros(n)
        np.maximum.at(most, group, x)
        return most.sum()

    trace, stack = lane // (P * R), (lane // R) % P
    adm, eps = a["n_admitted"], a["n_epochs"]
    # bytes: what each lane reads, from this run's counts -- per admission
    # its arrival (and the one it looks ahead to) and its phase, the pow2
    # uniforms on pow2 lanes only; a served request's deadline; at most one
    # belief row and one table entry (K on the mix lane) a decision; the
    # batch_aware lanes' gaps, M a routed arrival; one draw and one
    # multiplier a batch attempt index of a replica (a broadcast element
    # once); the fault boundaries passed; and every lane's outputs written
    # once (the FIFO scratch is neither input nor output)
    n_bytes = int(
        8 * once(trace, S, np.minimum(adm + 1, size)) + 8 * once(trace, S, adm)
        + 16 * once(trace, S, np.where(rid == 2, adm, 0))
        + 8 * once(trace, S, served)
        + (8 * K * once(trace, S, np.minimum(adm, eps)) if mix else 0)
        + 8 * once(stack, P, np.minimum(eps * (K if mix else 1), M * K * L))
        + 8 * once(stack, P, np.where(rid == 3, np.minimum(M * adm, M * K * L), 0))
        + 8 * once(trace, S, np.minimum(rep["nbat"].max(1), n_draws))
        + 8 * np.minimum(rep["nbat"].max(0), n_mult).sum()
        + 8 * np.minimum(rep["fcur"].max(0) + 1, nfb).sum()
        + lanes * 8 * (len(fk.AGG_I) + len(fk.AGG_F) + (len(fk.REP_I) + 1) * M
                       + ref.hist.shape[1])
        + (0 if ref.rec is None else int(8 * eps.sum() + 17 * adm.sum())))
    # operations (f64): per epoch the service time, its completion and the
    # crash test; per served request its latency, the sum and the SLO test;
    # the blend's K products and sums per epoch on the mix lane
    flops = int(4 * eps.sum() + 3 * served.sum() + (2 * K * eps.sum() if mix else 0))
    b_ms, b_by = bound(n_bytes, flops, F64_FLOPS)
    steps = int(a["n_steps_used"].sum())
    chain, floor_adm = fleet_chain_ms(torch, np, call, ref)
    longest = int(a["n_steps_used"].max())
    log(f"{name} ({lanes} lanes, M={M}, {steps} steps, {int(served.sum())} served): "
        f"kernel_ms={best:.3f} ({1e3 * best / longest:.4f} us a step of the longest lane) "
        f"plain_ms={plain:.3f} (Python walk on the host) bound_ms={b_ms:.6f} ({b_by}) "
        f"chain_ms={chain:.3f} (the walk's chain alone, {longest} steps on the longest "
        f"lane: kernel {best / chain:.2f}x it; the floor admitted {floor_adm}, the path "
        f"{int(adm.sum())}) earlier_ms={EARLIER_MS[name]} (quoted, PERF.md); every "
        f"output equal to the plain version")
    return dict(route="cuda", source=FLEET_SOURCE, max_abs_err=err, ms=best,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                chain_ms=chain, shape=[lanes, M, steps], served=int(served.sum()),
                walk=fk.smem_plan(len(args[10]), M, K, L, size, len(args[8]) - 1, mix).walk,
                sass_instructions=SASS["fleet_scan"])


def _fleet_traces(np, mode, lam, n, seeds, base):
    """fleet_frontier.py's _traces (seeds base + s)."""
    from repro_torch.serving.arrivals import MMPP2, DiurnalProcess

    out = []
    for s in range(seeds):
        rng = np.random.default_rng(base + s)
        if mode == "poisson":
            out.append(np.cumsum(rng.exponential(1.0 / lam, n)))
        elif mode == "mmpp2":
            m = MMPP2(lam1=0.3 * lam, lam2=1.3 * lam, dwell1=60.0, dwell2=30.0)
            out.append(np.asarray(m.sample_arrivals(n / m.mean_rate, rng)[0]))
        else:
            proc = DiurnalProcess(base=lam, amp=0.6 * lam, period=300.0)
            out.append(np.array([proc.next(rng).time for _ in range(n)]))
    return out


def _fleet_summary(np, out, i, hq):
    """Seed-averaged (W, P95, power, mean batch) of router lane i."""
    w = float(np.nanmean(out["w_mean"][:, 0, i]))
    power = float(np.nanmean(out["power"][:, 0, i]))
    mb = float(out["n_served"][:, 0, i].sum() / out["n_batches"][:, 0, i].sum())
    p95 = float(np.mean([hq(out["hist"][s, 0, i], out["hist_edges"], [0.95])[0]
                         for s in range(out["hist"].shape[0])]))
    return w, p95, power, mb


#: belief-mode streams against one-shot: tests/test_torch_faults.py's case
#: (M = 3, jsq, faults, room 24, slo 2.0) on a longer MMPP2 trace
BELIEF_STREAM = dict(n=20_000, chunk=997)


def belief_stream_one_shot(np):
    """A chunked FleetStream in each belief mode against simulate_fleet with
    the beliefs of one belief_forward call, on the card: every aggregate
    equal, energy and lat_sum at rtol 1e-12 (the reference's bar for a
    chunked stream against its one-shot run).  The chunked belief rows
    agree with the one-shot call's only to rounding (the belief kernel's
    time-parallel passes), so this is what shows no decision splits."""
    from repro_torch.core import GOOGLENET_P4_ENERGY, GOOGLENET_P4_LATENCY, ServiceModel
    from repro_torch.core.policies import q_policy
    from repro_torch.serving import FaultModel, FleetStream, PhaseBeliefFilter, simulate_fleet
    from repro_torch.serving.arrivals import MMPP2, belief_forward

    bm = 16
    svc = ServiceModel(latency=GOOGLENET_P4_LATENCY, family="det")
    means = np.array([0.0] + [float(svc.mean(b)) for b in range(1, bm + 1)])
    zeta = np.array([0.0] + [float(GOOGLENET_P4_ENERGY(b)) for b in range(1, bm + 1)])
    lam = 3 * 0.7 * bm / float(svc.mean(bm))
    m = MMPP2(lam1=0.3 * lam, lam2=1.3 * lam, dwell1=60.0, dwell2=30.0)
    tr, _ = m.sample_arrivals(BELIEF_STREAM["n"] / m.mean_rate, np.random.default_rng(0))
    sch = FaultModel(mtbf=40.0, mttr=6.0, p_straggle=0.1, straggle_mult=3.0).materialize(
        3, float(tr[-1]) + 50.0, seed=1)
    lo, hi = q_policy(4, 96, bm), q_policy(10, 96, bm)
    stacks = np.stack([np.stack([lo, hi]), np.stack([hi, lo]), np.stack([lo, lo])])
    kw = dict(router="jsq", means=means, zeta=zeta, b_max=bm, slo=2.0, buffer=24,
              faults=sch, device="cuda")

    def filt():
        return PhaseBeliefFilter(rates=[0.3 * lam, 1.3 * lam],
                                 gen=[[-1 / 60, 1 / 60], [1 / 30, -1 / 30]])

    ch = BELIEF_STREAM["chunk"]
    for mode in ("belief_argmax", "belief_mix"):
        st = FleetStream(stacks, phase_mode=mode, belief_filter=filt(), **kw)
        for lo_ in range(0, len(tr), ch):
            st.push(tr[lo_:lo_ + ch])
        got = st.finish()
        bel, _ = belief_forward(tr, filt(), device="cuda")
        one = simulate_fleet(stacks, tr, phase_mode=mode, beliefs=bel.cpu().numpy(), **kw)
        for f in ("n_served", "n_batches", "n_epochs", "slo_miss", "n_crashes", "n_dropped",
                  "n_shed", "t_final"):
            check(getattr(got, f) == getattr(one, f),
                  f"FleetStream {mode} vs one-shot: {f} {getattr(got, f)} vs {getattr(one, f)}")
        for f in ("hist", "qlen"):
            check(np.array_equal(getattr(got, f), getattr(one, f)),
                  f"FleetStream {mode} vs one-shot: {f} differs")
        e_lat = abs(got.lat_sum - one.lat_sum) / one.lat_sum
        e_en = abs(got.energy - one.energy) / one.energy
        check(e_lat <= 1e-12 and e_en <= 1e-12,
              f"FleetStream {mode} vs one-shot: lat_sum {e_lat}, energy {e_en}")
        log(f"FleetStream {mode} ({len(tr)} MMPP2 arrivals in chunks of {ch}, M=3, jsq, "
            f"faults, room 24) == simulate_fleet with one belief_forward call's beliefs on "
            f"the card, every aggregate (n_epochs {got.n_epochs}, n_crashes {got.n_crashes}, "
            f"n_shed {got.n_shed}; lat_sum rel err {e_lat:.3e}, energy {e_en:.3e})")


def fleet_phase(torch, np, kernels, rows):
    """The routed fleet and degraded mode (fleet_frontier.py, serve_fleet.py,
    degraded_frontier.py), counters zeroed just before and read just after."""
    from repro_torch.core import (GOOGLENET_P4_ENERGY, GOOGLENET_P4_LATENCY,
                                  ServiceModel, SMDPSpec, solve)
    from repro_torch.core.policies import q_policy
    from repro_torch.serving import (FaultModel, FaultSchedule, FleetStream,
                                     PhaseBeliefFilter, belief_forward,
                                     histogram_quantiles, pad_arrivals_batch,
                                     run_fleet_grid, simulate_compiled, simulate_fleet,
                                     verify_faults, verify_fleet)
    from repro_torch.serving import fleet
    from repro_torch.serving.arrivals import MMPP2

    M, bm = FLEET_M, B_MAX

    def spec(rho, latency=GOOGLENET_P4_LATENCY, b_max=bm, **kw):  # common.paper_spec
        svc = ServiceModel(latency=latency, family="det")
        lam = rho * b_max / float(svc.mean(b_max))
        kw = dict(dict(s_max=128, c_o=100.0), **kw)
        return SMDPSpec(lam=lam, service=svc, energy=GOOGLENET_P4_ENERGY, b_min=1,
                        b_max=b_max, w1=1.0, w2=1.0, **kw)

    def zeta_of(b_max):
        return np.array([0.0] + [float(GOOGLENET_P4_ENERGY(b)) for b in range(1, b_max + 1)])

    def means_of(svc, b_max):
        return np.array([0.0] + [float(svc.mean(b)) for b in range(1, b_max + 1)])

    kernels.reset_launch_counts()
    t_phase = time.perf_counter()
    py_wall = 0.0
    # --- benchmarks/fleet_frontier.py: M small replicas vs one fat server ---
    spec_small = spec(FLEET_RHO)
    spec_fat = spec(FLEET_RHO, latency=lambda b: GOOGLENET_P4_LATENCY(b) / M)
    small = solve(spec_small, backup="pallas", device="cuda")
    fat = solve(spec_fat, backup="pallas", device="cuda")
    solve_launches = kernels.launch_counts()["bellman_banded"]
    tab_small, tab_fat = small.policy, fat.policy
    zeta = zeta_of(bm)
    means_small = means_of(spec_small.service, bm)
    means_fat = means_small / M
    lam_agg = M * spec_small.lam
    grids, traces = {}, {}
    for mode in ("poisson", "mmpp2", "diurnal"):
        traces[mode] = _fleet_traces(np, mode, lam_agg, FLEET_N, FLEET_SEEDS, 1000)
        arr = pad_arrivals_batch(traces[mode])
        t0 = time.perf_counter()
        out = run_fleet_grid(tab_small[None], arr, routers=FLEET_ROUTERS, n_replicas=M,
                             means=means_small, zeta=zeta, b_max=bm, device="cuda")
        grid_s = time.perf_counter() - t0
        fat_rows = []
        for tr in traces[mode]:
            r = simulate_compiled(tab_fat, tr, means=means_fat, zeta=zeta, b_max=bm,
                                  device="cuda")
            fat_rows.append((r.lat_sum / r.n_served,
                             histogram_quantiles(r.hist, r.hist_edges, [0.95])[0],
                             r.energy / r.t_final, r.n_served / r.n_batches))
        fw, fp95, fpow, fmb = (float(np.mean(c)) for c in zip(*fat_rows))
        log(f"fleet_frontier {mode} (M={M}, rho {FLEET_RHO}/replica, {FLEET_SEEDS} seeds x "
            f"{FLEET_N} arrivals, one launch, {grid_s:.3f} s): fat server W={fw:.6f} ms "
            f"P95={fp95:.6f} ms power={fpow:.6f} W mean_batch={fmb:.6f}")
        for i, router in enumerate(FLEET_ROUTERS):
            w, p95, power, mb = _fleet_summary(np, out, i, histogram_quantiles)
            log(f"  {router:>11}: W={w:.6f} ms P95={p95:.6f} ms power={power:.6f} W "
                f"mean_batch={mb:.6f} (latency x{w / fw:.4f}, energy x{power / fpow:.4f} "
                f"the fat server's)")
        n_in = np.array([len(t) for t in traces[mode]])
        check(np.all(out["n_served"] == n_in[:, None, None]), f"{mode}: a grid lane left requests")
        grids[mode] = (arr, out)
    # every grid cell equals simulate_fleet of that lane, on the same kernel
    ru = np.random.default_rng(0).random(grids["poisson"][0].shape + (2,))
    n_cells = 0
    for mode, (arr, out) in grids.items():
        for s, tr in enumerate(traces[mode]):
            for i, router in enumerate(FLEET_ROUTERS):
                r = simulate_fleet(np.tile(tab_small[None], (M, 1)), tr, router=router,
                                   means=means_small, zeta=zeta, b_max=bm,
                                   router_u=ru[s][: len(tr)], device="cuda")
                for k in ("t_final", "n_served", "n_batches", "n_epochs", "energy",
                          "lat_sum", "slo_miss"):
                    check(out[k][s, 0, i] == getattr(r, k),
                          f"grid cell {mode}/{s}/{router}: {k} differs from simulate_fleet")
                check(np.array_equal(out["hist"][s, 0, i], r.hist)
                      and np.array_equal(out["n_route"][s, 0, i], r.n_routed),
                      f"grid cell {mode}/{s}/{router}: histogram or routing differs")
                n_cells += 1
    log(f"fleet grid: all {n_cells} cells equal simulate_fleet of their lane "
        "(counts, clocks, sums, histograms, routing)")
    # one seed per scenario x every router through the certifier
    hom = np.tile(tab_small[None], (M, 1))
    for mode in grids:
        for router in FLEET_ROUTERS:
            t0 = time.perf_counter()
            v = verify_fleet(hom, traces[mode][0], router=router,
                             service=spec_small.service, energy_table=zeta, b_max=bm,
                             device="cuda")
            py_wall += time.perf_counter() - t0
            log(f"verify_fleet {mode}/{router} (seed 1000, {FLEET_N} arrivals): "
                f"PythonFleet == fleet kernel, {v['n_decisions']} decisions")
    # MMPP-aware fleet: per-phase tables, the posterior from the belief
    # kernel, the mix rule in the fleet kernel
    tr_m = traces["mmpp2"][0]
    lo = solve(spec(0.3 * FLEET_RHO), backup="pallas", device="cuda").policy
    hi = solve(spec(1.3 * FLEET_RHO), backup="pallas", device="cuda").policy
    L = max(len(lo), len(hi))
    pad = lambda t: np.concatenate([t, np.full(L - len(t), t[-1])])  # noqa: E731
    stacks = np.tile(np.stack([pad(lo), pad(hi)])[None], (M, 1, 1))
    filt = PhaseBeliefFilter(rates=[0.3 * lam_agg, 1.3 * lam_agg],
                             gen=[[-1 / 60.0, 1 / 60.0], [1 / 30.0, -1 / 30.0]])
    bel = belief_forward(tr_m, filt, device="cuda")[0].cpu().numpy()
    mix_res = {}
    for router in ("jsq", "batch_aware"):
        t0 = time.perf_counter()
        v = verify_fleet(stacks, tr_m, router=router, service=spec_small.service,
                         energy_table=zeta, b_max=bm, phase_mode="belief_mix",
                         beliefs=bel, device="cuda")
        py_wall += time.perf_counter() - t0
        mix_res[router] = v["compiled"]
        c = v["compiled"]
        log(f"verify_fleet mmpp2/{router} belief_mix (K=2, per-phase tables at rho "
            f"{0.3 * FLEET_RHO:.2f} / {1.3 * FLEET_RHO:.2f}): PythonFleet == fleet kernel, "
            f"{v['n_decisions']} decisions, W={c.w_mean:.6f} ms "
            f"power={c.energy / c.t_final:.6f} W")
    # FleetStream: >= 10 chunks against the one-shot run
    n_stream = FLEET_STREAM_CHUNK * FLEET_STREAM_CHUNKS
    tr_s = np.cumsum(np.random.default_rng(7).exponential(1.0 / lam_agg, n_stream))
    t0 = time.perf_counter()
    fs = FleetStream(hom, router="jsq", means=means_small, zeta=zeta, b_max=bm,
                     device="cuda")
    for lo_ in range(0, n_stream, FLEET_STREAM_CHUNK):
        fs.push(tr_s[lo_:lo_ + FLEET_STREAM_CHUNK])
    st = fs.finish()
    stream_s = time.perf_counter() - t0
    one = simulate_fleet(hom, tr_s, router="jsq", means=means_small, zeta=zeta, b_max=bm,
                         device="cuda")
    for k in ("n_served", "n_batches", "n_epochs", "n_admitted", "slo_miss", "t_final",
              "terminated", "n_crashes", "n_dropped", "n_shed"):
        check(getattr(st, k) == getattr(one, k), f"FleetStream {k} differs from one-shot")
    for k in ("hist", "qlen", "n_routed", "n_served_m"):
        check(np.array_equal(getattr(st, k), getattr(one, k)),
              f"FleetStream {k} differs from one-shot")
    lat_err = abs(st.lat_sum - one.lat_sum) / one.lat_sum
    e_err = abs(st.energy - one.energy) / one.energy
    check(lat_err <= 1e-12 and e_err <= 1e-12, f"FleetStream sums: {lat_err}, {e_err}")
    rep = fs.report()
    log(f"FleetStream ({FLEET_STREAM_CHUNKS} chunks of {FLEET_STREAM_CHUNK}, M={M}, jsq, "
        f"{stream_s:.3f} s, {n_stream / stream_s:.0f} arrivals/s): == one-shot on every "
        f"aggregate, n_epochs {st.n_epochs}; lat_sum rel err {lat_err:.3e}, energy "
        f"{e_err:.3e}; P95={rep['P95']:.6f} ms")
    # --- examples/serve_fleet.py: M = 8, 3 seeds x 4 routers, one launch ----
    spec8 = SMDPSpec(lam=FLEET_RHO * bm / float(means_small[bm]), service=spec_small.service,
                     energy=GOOGLENET_P4_ENERGY, b_min=1, b_max=bm, w1=1.0, w2=1.0, s_max=128)
    tab8 = solve(spec8, backup="pallas", device="cuda").policy
    lam8 = EXAMPLE_M * spec8.lam
    tr8 = [np.cumsum(np.random.default_rng(s).exponential(1.0 / lam8, FLEET_N))
           for s in range(EXAMPLE_SEEDS)]
    ex_routers = ("rr", "jsq", "pow2", "batch_aware")
    out8 = run_fleet_grid(tab8[None], pad_arrivals_batch(tr8), routers=ex_routers,
                          n_replicas=EXAMPLE_M, means=means_small, zeta=zeta, b_max=bm,
                          device="cuda")
    for i, router in enumerate(ex_routers):
        w, p95, power, mb = _fleet_summary(np, out8, i, histogram_quantiles)
        log(f"serve_fleet M={EXAMPLE_M} {router:>11}: W={w:.6f} ms P95={p95:.6f} ms "
            f"power={power:.6f} W mean_batch={mb:.6f}")
    check(np.all(out8["n_served"] == FLEET_N), "serve_fleet: a lane left requests")

    # --- benchmarks/degraded_frontier.py ---------------------------------
    dsvc = ServiceModel(latency=GOOGLENET_P4_LATENCY, family="det")
    dbm = DEGRADED_BMAX
    dmeans, dzeta = means_of(dsvc, dbm), zeta_of(dbm)
    dtabs = np.stack([q_policy(q, 96, dbm) for q in (4, 6, 8)])

    def dtrace(mode, lam, n, seed):
        rng = np.random.default_rng(seed)
        if mode == "poisson":
            return np.cumsum(rng.exponential(1.0 / lam, n))
        m = MMPP2(lam1=0.25 * lam, lam2=1.75 * lam, dwell1=40.0, dwell2=40.0)
        return np.asarray(m.sample_arrivals(n / m.mean_rate, rng)[0])

    # §1 certification
    lam_c = 3 * 0.7 * dbm / float(dsvc.mean(dbm))
    crashes = 0
    for mode in ("poisson", "mmpp2"):
        tr = dtrace(mode, lam_c, DEGRADED_CERT_N, 0)
        sch = FaultModel(**SEVERITIES["moderate"]).materialize(3, float(tr[-1]) + 50.0, seed=1)
        for router in FLEET_ROUTERS:
            t0 = time.perf_counter()
            v = verify_faults(dtabs, tr, faults=sch, service=dsvc, b_max=dbm, router=router,
                              buffer=DEGRADED_BUFFER, energy_table=dzeta, slo=2.0,
                              device="cuda")
            py_wall += time.perf_counter() - t0
            crashes += v["n_crashes"]
            log(f"verify_faults {mode}/{router} (moderate, buffer {DEGRADED_BUFFER}, slo 2.0, "
                f"{DEGRADED_CERT_N} arrivals): PythonFleet == fleet kernel, "
                f"{v['n_decisions']} decisions, crashes {v['n_crashes']}, dropped "
                f"{v['n_dropped']}, shed {v['n_shed']}")
    rail = verify_faults(dtabs, dtrace("poisson", lam_c, DEGRADED_CERT_N, 2),
                         faults=FaultSchedule.none(3), service=dsvc, b_max=dbm,
                         energy_table=dzeta, device="cuda")
    check(rail["n_crashes"] == 0 and rail["n_shed"] == 0, "the no-fault rail faulted")
    check(crashes > 0, "certification: no batch crashed, the degraded lane is not shown")
    log(f"verify_faults no-fault rail: {rail['n_decisions']} decisions, no crash, no shed")
    # §2 fault matrix: M = 3, severity x router x seeds, one launch per run
    lam_m = 3 * 0.7 * dbm / float(dsvc.mean(dbm))
    matrix = {}
    for sev, model in SEVERITIES.items():
        for router in FLEET_ROUTERS:
            agg = []
            for s in range(DEGRADED_SEEDS):
                tr = dtrace("mmpp2", lam_m, DEGRADED_N, 200 + s)
                sch = (FaultSchedule.none(3) if model is None else
                       FaultModel(**model).materialize(3, float(tr[-1]) + 50.0, seed=300 + s))
                r = simulate_fleet(dtabs, tr, router=router, means=dmeans, zeta=dzeta,
                                   b_max=dbm, slo=2.0, faults=sch, buffer=DEGRADED_BUFFER,
                                   device="cuda")
                offered = r.n_served + r.n_dropped + r.n_shed
                agg.append(dict(
                    goodput=r.n_served / r.t_final,
                    drop_rate=(r.n_dropped + r.n_shed) / offered,
                    W_mean=r.lat_sum / r.n_served,
                    P95=float(histogram_quantiles(r.hist, r.hist_edges, [0.95])[0]),
                    power=r.energy / r.t_final, crashes=r.n_crashes))
            m = {k: float(np.mean([a[k] for a in agg])) for k in agg[0]}
            matrix[(sev, router)] = m
            log(f"fault matrix {sev}/{router} (M=3, {DEGRADED_SEEDS} seeds x {DEGRADED_N} "
                f"MMPP2 arrivals, buffer {DEGRADED_BUFFER}): goodput={m['goodput']:.6f} /ms "
                f"drop_rate={m['drop_rate']:.6f} W={m['W_mean']:.6f} ms P95={m['P95']:.6f} ms "
                f"power={m['power']:.6f} W crashes/seed={m['crashes']:.2f}")
    check(all(matrix[("severe", r)]["crashes"] > 0 for r in FLEET_ROUTERS),
          "fault matrix: the severe regime crashed nothing")
    # §3 aware vs blind through the M = 1 fleet
    aware = solve(SMDPSpec(lam=1.2 * dbm / float(dsvc.mean(dbm)), service=dsvc,
                           energy=GOOGLENET_P4_ENERGY, b_min=1, b_max=dbm, w1=1.0, w2=1.0,
                           s_max=DEGRADED_BUFFER, buffer=DEGRADED_BUFFER, c_drop=50.0),
                  backup="pallas", device="cuda").action_table()
    blind = solve(SMDPSpec(lam=0.7 * dbm / float(dsvc.mean(dbm)), service=dsvc,
                           energy=GOOGLENET_P4_ENERGY, b_min=1, b_max=dbm, w1=1.0, w2=1.0,
                           s_max=128), backup="pallas", device="cuda").action_table()
    lam_o = 1.2 * dbm / float(dsvc.mean(dbm))
    shed = {}
    for mode in ("mmpp2", "poisson"):
        for s in range(DEGRADED_SEEDS):
            tr = dtrace(mode, lam_o, DEGRADED_N, 400 + s)
            for name, tab in (("aware", aware), ("blind", blind)):
                r = simulate_fleet(tab[None], tr, router="jsq", means=dmeans, zeta=dzeta,
                                   b_max=dbm, buffer=DEGRADED_BUFFER, device="cuda")
                shed.setdefault((mode, name), []).append(r.n_served / r.t_final)
    serve_from = {"aware": int(np.argmax(aware > 0)), "blind": int(np.argmax(blind > 0))}
    gp = {k: float(np.mean(v)) for k, v in shed.items()}
    log(f"degraded shedding through the M=1 fleet (rho 1.2, buffer {DEGRADED_BUFFER}): "
        f"serve-from {serve_from}; goodput /ms " + ", ".join(
            f"{m}/{n}={v:.6f}" for (m, n), v in sorted(gp.items())))
    check(serve_from["aware"] < serve_from["blind"], f"serve-from {serve_from}")
    check(gp[("mmpp2", "aware")] > gp[("mmpp2", "blind")],
          f"aware MMPP2 goodput {gp[('mmpp2', 'aware')]} <= blind {gp[('mmpp2', 'blind')]}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_phase
    counts = kernels.launch_counts()
    log(f"fleet phase launches: {counts} (wall {wall:.2f} s)")
    log(f"fleet phase: PythonFleet references (verify_fleet / verify_faults) took "
        f"{py_wall:.2f} s of the wall, the interpreter's time, not the card's")
    check(solve_launches == small.rvi.iterations + fat.rvi.iterations + 2,
          f"frontier solves: {solve_launches} Bellman launches")
    n_grid = 3 + 1  # the frontier's three scenarios, serve_fleet's grid
    check(counts.get("fleet_scan:grid_plain", 0) == n_grid,
          f"{counts.get('fleet_scan:grid_plain', 0)} grid launches, want {n_grid}")
    check(counts.get("fleet_scan:mix", 0) == 2, "the mix lane did not launch twice")
    check(counts.get("fleet_scan:plain", 0) > 0, "no one-lane fleet launch")
    check(counts.get("belief_forward", 0) == 1, "the posterior skipped the belief kernel")
    belief_stream_one_shot(np)  # after the phase's launch counts: it launches many chunks

    # --- the kernel rows: the instances on the inputs of the path ----------
    tr = dtrace("mmpp2", lam_m, DEGRADED_N, 200)
    sch = FaultModel(**SEVERITIES["moderate"]).materialize(3, float(tr[-1]) + 50.0, seed=300)
    one_lane = fleet_inputs(np, fleet._norm_tables(dtabs)[None], [tr], [fleet.router_id("jsq")],
                            means=dmeans, zeta=dzeta, b_max=dbm, slo=2.0, faults=sch,
                            buffer=DEGRADED_BUFFER)
    rows["fleet_scan"] = dict(fleet_row(torch, np, "fleet_scan", one_lane),
                              replaces=FLEET_REPLACES.format(""),
                              launches=counts.get("fleet_scan:plain", 0),
                              case="degraded §2 moderate/jsq seed 200, M=3, faults, buffer 24")
    grid = fleet_inputs(np, np.repeat(tab_small[None, None, None], M, axis=1),
                        grids["poisson"][0], [fleet.router_id(r) for r in FLEET_ROUTERS],
                        means=means_small, zeta=zeta, b_max=bm)
    rows["fleet_scan_grid"] = dict(fleet_row(torch, np, "fleet_scan_grid", grid),
                                   replaces=FLEET_REPLACES.format(", vmapped: _fleet_grid_core"),
                                   launches=counts.get("fleet_scan:grid_plain", 0),
                                   case="fleet_frontier poisson grid, 4 seeds x 4 routers")
    mix = fleet_inputs(np, stacks[None], [tr_m], [fleet.router_id("batch_aware")],
                       means=means_small, zeta=zeta, b_max=bm, beliefs=[bel])
    rows["fleet_scan_mix"] = dict(fleet_row(torch, np, "fleet_scan_mix", mix),
                                  replaces=FLEET_REPLACES.format(", mix=True"),
                                  launches=counts.get("fleet_scan:mix", 0),
                                  case="fleet_frontier mmpp2 seed 1000, batch_aware, K=2")


# --- phase 4h: durable sweeps and streams, the samplers, Fig. 6 ------------
#: resilience_overhead.py's sweep, gated on the median of 10 runs a path (the benchmark
#: takes the best of 3): the card machine's host spreads one sweep's wall by +-15%, so a
#: minimum turns on one lucky run (PERF.md, section 6); the runs alternate plain, saved,
#: saved, plain
RESIL = dict(n_specs=64, rho=0.88, s_max=384, b_max=16, chunk=16, repeat=10)
MAX_SWEEP_OVERHEAD = 0.05  # resilience_overhead.py's gate
STREAM_SAVE = dict(n_arrivals=200_000, chunk=8000, repeat=3)
FIG6_EPOCHS = 150_000  # fig6_percentiles.py
FIG6_PAPER = {  # fig6_percentiles.py:19-23: (P, W, P50, P90, P95)
    "static8": (46.27, 6.85, 6.51, 9.85, 11.34),
    "smdp_w2_1.6": (44.96, 6.90, 6.83, 9.23, 9.96),
    "smdp_w2_2.2": (44.41, 7.81, 7.72, 10.45, 11.24),
}
MMPP_SOURCE = "src/repro_torch/kernels/csrc/mmpp_sample.cu"
MMPP_REPLACES = ("src/repro/serving/arrivals.py:580-599 (the lax.scan of mmpp2_times_jax; "
                 "a scan, not a Pallas kernel)")
SIM_SOURCE = "src/repro_torch/kernels/csrc/sim_scan.cu"
SIM_REPLACES = ("src/repro/core/simulate.py:169-232 (the lax.scan of simulate; "
                "a scan, not a Pallas kernel)")
#: the SIGKILL drill's child: a checkpointed sweep on the card (backup
#: pallas), saves throttled so the parent lands the kill after a commit
CHILD_SWEEP = r"""
import sys, time
sys.path.insert(0, sys.argv[3])
from repro_torch.core import sweep as _sweep_mod
from repro_torch.launch.resume_sweep import build_grid
import numpy as np
ckpt, out = sys.argv[1], sys.argv[2]
_orig = _sweep_mod._SweepCheckpointer.save
def _slow(self, tree):
    _orig(self, tree)
    time.sleep(0.5)
_sweep_mod._SweepCheckpointer.save = _slow
res = _sweep_mod.sweep_solve(build_grid(), checkpoint_dir=ckpt, chunk_size=4,
                             backup="pallas", device="cuda")
np.savez(out, policies=np.stack([r.rvi.policy for r in res]),
         g=np.array([r.rvi.g for r in res]), h=np.stack([r.rvi.h for r in res]))
print("COMPLETED", flush=True)
"""


#: resilience_overhead.py's measurement, run in a fresh process: argv is
#: (src dir, work dir, JSON of RESIL with "stream" and "device"); prints one
#: line "RESIL {json}"
CHILD_RESIL = r"""
import dataclasses, json, os, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from repro_torch.core import (GOOGLENET_P4_ENERGY, GOOGLENET_P4_LATENCY, ServiceModel,
                              SMDPSpec, sweep_solve)
from repro_torch.core.policies import q_policy
from repro_torch.serving import FleetStream

work, p = sys.argv[2], json.loads(sys.argv[3])
dev = p["device"]
sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
bm = p["b_max"]
svc = ServiceModel(latency=GOOGLENET_P4_LATENCY, family="det")
base = SMDPSpec(lam=p["rho"] * bm / float(svc.mean(bm)), service=svc,
                energy=GOOGLENET_P4_ENERGY, b_min=1, b_max=bm, w1=1.0, w2=1.0,
                s_max=p["s_max"], c_o=100.0)
specs = [dataclasses.replace(base, w2=float(w)) for w in np.linspace(0.0, 12.0, p["n_specs"])]
chunk = p["chunk"]


def sweep(ck):
    t0 = time.perf_counter()
    sweep_solve(specs, chunk_size=chunk, device=dev, checkpoint_dir=ck)
    sync()
    return time.perf_counter() - t0


sweep(None)  # warm-up, both paths
sweep(os.path.join(work, "resil_warm"))
plain, saved = [], []
for r in range(p["repeat"]):  # plain, saved, saved, plain, ...: drift falls on both
    first, second = (plain, saved) if r % 2 == 0 else (saved, plain)
    for runs in (first, second):
        ck = os.path.join(work, f"resil_rep{r}") if runs is saved else None  # fresh dirs
        runs.append(sweep(ck))
t_plain, t_ck = float(np.median(plain)), float(np.median(saved))

sbm, st = 16, p["stream"]
means = np.array([0.0] + [float(svc.mean(b)) for b in range(1, sbm + 1)])
lam = 2 * 0.7 * sbm / float(svc.mean(sbm))
n, ch = st["n_arrivals"], st["chunk"]
tr = np.cumsum(np.random.default_rng(0).exponential(1.0 / lam, n))
tabs = np.stack([q_policy(q, 96, sbm) for q in (4, 8)])
kw = dict(router="jsq", means=means, b_max=sbm, slo=3.0, device=dev)


def stream(save_dir):
    t0 = time.perf_counter()
    fs = FleetStream(tabs, **kw)
    for lo in range(0, len(tr), ch):
        fs.push(tr[lo:lo + ch])
        if save_dir is not None:
            fs.save(save_dir)
    fs.finish()
    return time.perf_counter() - t0


stream(None)
s_plain = s_saved = float("inf")
for r in range(st["repeat"]):
    s_plain = min(s_plain, stream(None))
    s_saved = min(s_saved, stream(os.path.join(work, f"stream_save_rep{r}")))
print("RESIL " + json.dumps(dict(
    sweep_plain_s=t_plain, sweep_checkpointed_s=t_ck, overhead=t_ck / t_plain - 1.0,
    best_overhead=min(saved) / min(plain) - 1.0,
    plain_runs=[round(x, 4) for x in plain], checkpointed_runs=[round(x, 4) for x in saved],
    stream_plain_s=s_plain, stream_saved_s=s_saved,
    ms_per_save=(s_saved - s_plain) / -(-n // ch) * 1e3)), flush=True)
"""


def _stream_case(np, mode, n=3000, seed=11):
    """(tables, chunks, kwargs) of tests/test_resilience.py's streams."""
    from repro_torch.core import GOOGLENET_P4_ENERGY, GOOGLENET_P4_LATENCY, ServiceModel
    from repro_torch.core.policies import q_policy
    from repro_torch.serving.arrivals import MMPP2, PhaseBeliefFilter

    bm = 16
    svc = ServiceModel(latency=GOOGLENET_P4_LATENCY, family="det")
    means = np.array([0.0] + [float(svc.mean(b)) for b in range(1, bm + 1)])
    zeta = np.array([0.0] + [float(GOOGLENET_P4_ENERGY(b)) for b in range(1, bm + 1)])
    lam = 2 * 0.7 * bm / float(svc.mean(bm))
    rng = np.random.default_rng(seed)
    kw = dict(means=means, zeta=zeta, b_max=bm, slo=3.0, device="cuda")
    if mode == "poisson":
        tr = np.cumsum(rng.exponential(1.0 / lam, n))
        tabs = np.stack([q_policy(q, 96, bm) for q in (4, 8)])
        return tabs, [dict(times=tr[lo:lo + 400]) for lo in range(0, n, 400)], dict(
            kw, router="pow2")
    stacks = np.stack([np.stack([q_policy(4, 96, bm), q_policy(10, 96, bm)])] * 2)
    m = MMPP2(lam1=0.3 * lam, lam2=1.3 * lam, dwell1=60.0, dwell2=30.0)
    tr, switches = m.sample_arrivals(n / m.mean_rate, rng)
    sw_t = np.array([s[0] for s in switches])
    sw_p = np.array([s[1] for s in switches], dtype=np.int64)
    ph = sw_p[np.searchsorted(sw_t, tr, side="right") - 1]
    kw["router"] = "jsq"
    if mode == "mmpp2":
        return stacks, [dict(times=tr[lo:lo + 400], phases=ph[lo:lo + 400])
                        for lo in range(0, len(tr), 400)], kw
    kw["phase_mode"] = "belief_argmax"
    kw["belief_filter"] = lambda: PhaseBeliefFilter(
        [0.3 * lam, 1.3 * lam], [[-1 / 60.0, 1 / 60.0], [1 / 30.0, -1 / 30.0]])
    return stacks, [dict(times=tr[lo:lo + 400]) for lo in range(0, len(tr), 400)], kw


def durable_streams(np, workdir):
    """FleetStream saved halfway and resumed on the card, per arrival mode:
    every aggregate equal to the uninterrupted stream."""
    from repro_torch.serving import FleetStream

    for mode in ("poisson", "mmpp2", "belief"):
        tabs, chunks, kw = _stream_case(np, mode)

        def fresh():
            k = dict(kw)
            if "belief_filter" in k:
                k["belief_filter"] = k["belief_filter"]()
            return FleetStream(tabs, **k)

        one = fresh()
        for c in chunks:
            one.push(**c)
        one.finish()
        fs = fresh()
        cut = len(chunks) // 2
        for c in chunks[:cut]:
            fs.push(**c)
        d = os.path.join(workdir, f"stream_{mode}")
        fs.save(d)
        back = FleetStream.resume(d, device="cuda")
        for c in chunks[cut:]:
            back.push(**c)
        back.finish()
        a, b = back.result(), one.result()
        for f in ("t_final", "n_served", "n_batches", "n_epochs", "n_admitted", "energy",
                  "lat_sum", "slo_miss", "n_crashes", "n_dropped", "n_shed"):
            check(getattr(a, f) == getattr(b, f), f"FleetStream {mode} resume: {f} differs")
        for f in ("hist", "qlen", "busy", "n_routed", "n_served_m"):
            check(np.array_equal(getattr(a, f), getattr(b, f)),
                  f"FleetStream {mode} resume: {f} differs")
        ra, rb = back.report(), one.report()
        check(all(ra[k] == rb[k] or (np.isnan(ra[k]) and np.isnan(rb[k])) for k in ra),
              f"FleetStream {mode} resume: report differs")
        log(f"FleetStream {mode} saved at chunk {cut}/{len(chunks)}, resumed on the card: "
            f"every aggregate equal to the uninterrupted stream (n_epochs {a.n_epochs}, "
            f"P95 {ra['P95']:.4f})")


def sigkill_drill(np, workdir):
    """A child sweeping on the card is SIGKILLed after its first commit; a
    second child resumes; the result equals an uninterrupted card run."""
    from repro_torch.core import sweep_solve
    from repro_torch.launch.resume_sweep import build_grid

    ck, out = os.path.join(workdir, "kill_ck"), os.path.join(workdir, "kill_out.npz")
    cmd = [sys.executable, "-c", CHILD_SWEEP, ck, out, os.path.join(ROOT, "src")]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        while not (os.path.isdir(ck) and [p for p in os.listdir(ck)
                                          if p.startswith("step_") and not p.endswith(".tmp")]):
            if proc.poll() is not None:
                raise AssertionError("the drill's child exited before its first commit: "
                                     + proc.communicate()[1][-2000:])
            check(time.perf_counter() - t0 < 240, "no commit from the drill's child")
            time.sleep(0.01)
    finally:
        proc.kill()
        proc.wait()
    steps = sorted(p for p in os.listdir(ck) if p.startswith("step_"))
    check(not os.path.exists(out), "the SIGKILL landed after the child finished")
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    check(r.returncode == 0 and "COMPLETED" in r.stdout, f"resumed child failed: {r.stderr[-2000:]}")
    got = np.load(out)
    ref = sweep_solve(build_grid(), checkpoint_dir=os.path.join(workdir, "kill_ref"),
                      chunk_size=4, backup="pallas", device="cuda")
    check(np.array_equal(got["policies"], np.stack([x.rvi.policy for x in ref]))
          and np.array_equal(got["g"], np.array([x.rvi.g for x in ref]))
          and np.array_equal(got["h"], np.stack([x.rvi.h for x in ref])),
          "SIGKILL drill: the resumed sweep differs from the uninterrupted card run")
    log(f"SIGKILL drill: child killed with {len(steps)} committed step(s), resumed in a "
        f"second child, policy / g / h bitwise equal to an uninterrupted card run "
        f"({time.perf_counter() - t0:.2f} s)")


def resilience_overhead(np, workdir):
    """benchmarks/resilience_overhead.py at its full size on the card, in a
    fresh child process as the benchmark is its own: the checkpointed sweep
    within 5% of the same chunking unsaved (the median of 10 alternating
    runs a path, fresh directories); FleetStream.save ms a save."""
    params = dict(RESIL, stream=STREAM_SAVE, device="cuda")
    r = subprocess.run([sys.executable, "-c", CHILD_RESIL, os.path.join(ROOT, "src"), workdir,
                        json.dumps(params)], capture_output=True, text=True, timeout=600)
    out = [ln for ln in r.stdout.splitlines() if ln.startswith("RESIL ")]
    check(r.returncode == 0 and len(out) == 1,
          f"the resilience child failed (rc {r.returncode}): {r.stderr[-3000:]}")
    res = json.loads(out[0][len("RESIL "):])
    t_plain, t_ck, overhead = res["sweep_plain_s"], res["sweep_checkpointed_s"], res["overhead"]
    log(f"resilience_overhead sweep in a fresh process ({RESIL['n_specs']} specs, rho "
        f"{RESIL['rho']}, s_max {RESIL['s_max']}, chunk {RESIL['chunk']}, median of "
        f"{RESIL['repeat']} a path, both paths warmed): plain {t_plain:.4f} s, checkpointed "
        f"{t_ck:.4f} s ({-(-RESIL['n_specs'] // RESIL['chunk'])} saves), overhead "
        f"{overhead:+.2%} (gate {MAX_SWEEP_OVERHEAD:.0%}; best of {RESIL['repeat']}: "
        f"{res['best_overhead']:+.2%}); runs plain {res['plain_runs']}, checkpointed "
        f"{res['checkpointed_runs']}")
    check(overhead <= MAX_SWEEP_OVERHEAD,
          f"checkpointed sweep overhead {overhead:+.2%} exceeds the {MAX_SWEEP_OVERHEAD:.0%} gate")
    n, ch = STREAM_SAVE["n_arrivals"], STREAM_SAVE["chunk"]
    log(f"resilience_overhead stream ({n} arrivals, chunk {ch}, best of "
        f"{STREAM_SAVE['repeat']}): plain {res['stream_plain_s']:.4f} s, save every chunk "
        f"{res['stream_saved_s']:.4f} s ({-(-n // ch)} saves): FleetStream.save "
        f"{res['ms_per_save']:.3f} ms a save")
    return {k: res[k] for k in ("sweep_plain_s", "sweep_checkpointed_s", "overhead",
                                "best_overhead", "stream_plain_s", "stream_saved_s",
                                "ms_per_save")}


def mmpp_row(torch, np, m, n_steps, lanes, launches):
    """The MMPP sampler kernel on the bursty batch's draws, held against its
    plain walk exactly and timed (CUDA events around one launch, best of 3)."""
    from repro_torch.kernels import mmpp_sample as mk

    g = torch.Generator(device="cuda")
    g.manual_seed(17)
    draws = torch.empty((lanes, 1 + 2 * n_steps), dtype=torch.float64,
                        device="cuda").exponential_(generator=g)
    lam, dwell = (m.lam1, m.lam2), (m.dwell1, m.dwell2)
    got = mk.mmpp_sample(draws, lam, dwell)
    torch.cuda.synchronize()
    host = draws.cpu()
    t0 = time.perf_counter()
    want = mk.mmpp_sample_ref(host, lam, dwell)
    plain = (time.perf_counter() - t0) * 1e3
    for a, b, name in zip(got, want, ("times", "emitted", "phases")):
        check(torch.equal(a.cpu(), b), f"mmpp_sample: {name} differ from the plain walk")
    # one wrapper call as the earlier design was timed, and the device time
    # of a call in a CUDA graph of 5
    best = event_ms(torch, lambda: mk.mmpp_sample(draws, lam, dwell))
    dev_ms = device_ms(torch, lambda: mk.mmpp_sample(draws, lam, dwell), 5)
    n_bytes = lanes * (1 + 2 * n_steps) * 8 + lanes * n_steps * (8 + 1 + 4)
    b_ms, b_by = bound(n_bytes, lanes * n_steps * 4, F64_FLOPS)
    floor, switches = mmpp_chain_ms(torch, draws, lam, dwell, n_steps)
    log(f"mmpp_sample ({lanes} lanes x {n_steps} steps, the bursty batch; {CARD[0]}): "
        f"kernel_ms={best:.6f} (events around one call, best of 3, as earlier_ms was "
        f"taken) device_ms={dev_ms:.6f} (a CUDA graph of 5; {1e6 * dev_ms / n_steps:.2f} ns "
        f"a step of a lane: the serial walk) plain_ms={plain:.3f} (the plain walk, torch "
        f"ops on the host) bound_ms={b_ms:.6f} ({b_by}; the serial chain is the real bound) "
        f"floor_ms={floor:.6f} (the walk's chain alone, {n_steps} steps, {switches} "
        f"switches: kernel {best / floor:.2f}x it) earlier_ms={EARLIER_MS['mmpp_sample']} "
        f"(quoted, PERF.md; {EARLIER_MS['mmpp_sample'] / best:.2f}x); equal to the plain "
        f"walk in every output")
    return dict(route="cuda", source=MMPP_SOURCE, replaces=MMPP_REPLACES, launches=launches,
                max_abs_err=0.0, ms=best, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, device_ms=dev_ms, floor_ms=floor, shape=[lanes, n_steps])


def mmpp_chain_ms(torch, draws, lam, dwell, n_steps):
    """The MMPP walk's chain alone (csrc/chain_floor.cu): n_steps steps a
    lane, the staged candidates of the lane's first draws in shared memory,
    one block a lane.  Returns (ms, the floor's switches over the lanes)."""
    import ctypes

    from repro_torch.kernels import _build

    n = int(_build.function("chain_floor", "chain_floor_window", ctypes.c_longlong, [])())
    e_g, e_d = draws[:, 1:1 + 2 * n:2], draws[:, 2:2 + 2 * n:2]
    check(e_g.shape[1] == n, "mmpp chain floor: fewer steps than its window")
    win = torch.stack([e_g / lam[0], e_g / lam[1], e_d * dwell[0], e_d * dwell[1]],
                      -1).contiguous()
    nsw0 = (draws[:, 0] * dwell[0]).contiguous()
    L = draws.shape[0]
    out = torch.empty((L, 3), dtype=torch.float64, device="cuda")
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    fn = _build.function("chain_floor", "mmpp_floor_launch", ctypes.c_int,
                         [vp] * 2 + [ll] * 2 + [vp] * 2)

    def launch():
        check(fn(win.data_ptr(), nsw0.data_ptr(), L, n_steps, out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream) == 0, "mmpp chain floor launch")

    ms = event_ms(torch, launch)
    check(bool(torch.isfinite(out[:, :2]).all()), "mmpp chain floor: non-finite clock")
    return ms, int(out[:, 2].sum())


def sim_row(torch, np, args, kw, launches, name):
    """The simulator kernel on one Fig. 6 run's draws, held against its plain
    walk (host) exactly in every output and timed."""
    from repro_torch.kernels import sim_scan as sk

    got = sk.sim_scan(*args, **kw)
    torch.cuda.synchronize()
    host = [x.cpu() for x in args]
    t0 = time.perf_counter()
    want = sk.sim_scan_ref(*host, **kw)
    plain = (time.perf_counter() - t0) * 1e3
    n = int(want.n_served[0])
    for f in got._fields:
        a, b = getattr(got, f).cpu(), getattr(want, f)
        same = torch.equal(a[:, :n], b[:, :n]) if f == "resp" else torch.equal(a, b)
        check(same, f"sim_scan ({name}): {f} differs from the plain walk")
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        sk.sim_scan(*args, **kw)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    E, W = args[5].shape[1], args[5].shape[2]
    consumed = int(want.consumed[0])
    serves = int((want.acts[0] > 0).sum())
    # bytes: the draws this run reads, the actions and responses written
    n_bytes = 8 * consumed + 8 * W * serves + 4 * E + 8 * n + 8 * (len(args[0]) + 4 * len(args[1]))
    b_ms, b_by = bound(n_bytes, 4 * consumed + 6 * E + n, F64_FLOPS)
    chain, floor_consumed = sim_chain_ms(torch, np, args, kw)
    log(f"sim_scan ({name}, {E} epochs, {n} requests, {consumed} arrival draws): "
        f"kernel_ms={best:.6f} ({1e3 * best / E:.4f} us an epoch: the serial walk) "
        f"plain_ms={plain:.3f} (the plain walk, Python floats on the host) "
        f"bound_ms={b_ms:.6f} ({b_by}) chain_ms={chain:.6f} (the walk's chain alone, "
        f"{E} epochs, {floor_consumed} arrivals: kernel {best / chain:.2f}x it) "
        f"earlier_ms={EARLIER_MS['sim_scan']} (quoted, PERF.md); equal to the plain walk "
        f"in every output")
    return dict(route="cuda", source=SIM_SOURCE, replaces=SIM_REPLACES, launches=launches,
                max_abs_err=0.0, ms=best, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, chain_ms=chain, shape=[E, n], policy=name,
                chain_consumed=floor_consumed,
                sass_instructions=SASS["sim_scan"])


def durable_phase(torch, np, kernels, rows):
    """Phase 4h: durable sweeps and streams, the on-device samplers and the
    independent simulator (Fig. 6 / Table I), counters zeroed just before
    and read just after."""
    from repro_torch.configs.googlenet_p4 import B_MAX as BM, energy_table, paper_spec, service
    from repro_torch.core import build_smdp, evaluate_policy, relative_value_iteration
    from repro_torch.core import static_policy, sweep as sweep_mod, sweep_solve
    from repro_torch.core.simulate import (sim_result, simulate, simulate_events,
                                           simulate_inputs)
    from repro_torch.kernels import bellman as tb
    from repro_torch.kernels import sim_scan as sk
    from repro_torch.launch import resume_sweep
    from repro_torch.serving import (DiurnalProcess, PhaseBeliefFilter, belief_forward,
                                     diurnal_times, mmpp2_times, pad_arrivals,
                                     poisson_times, run_grid, simulate_compiled)
    from repro_torch.serving.arrivals import MMPP2
    from repro_torch.core.policies import q_policy

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="phase4h-", dir=os.path.join(ROOT, "build"))
    t_phase = time.perf_counter()
    kernels.reset_launch_counts()

    # --- durable sweeps: self-preempt, resume, every chunk on the kernel ----
    per_call = []
    orig_rvi = sweep_mod.relative_value_iteration_batched

    def counted(*a, **k):
        before = tb.bellman_banded_batched.launches
        out = orig_rvi(*a, **k)
        per_call.append(tb.bellman_banded_batched.launches - before)
        return out

    sweep_mod.relative_value_iteration_batched = counted
    try:
        t0 = time.perf_counter()
        demo = resume_sweep.self_preempt_demo(4, device="cuda", backup="pallas", workdir=work)
        demo_s = time.perf_counter() - t0
    finally:
        sweep_mod.relative_value_iteration_batched = orig_rvi
    check(demo["same"], "resumed card sweep differs from the uninterrupted one")
    check(demo["stream_same"], "resume_sweep's stream resume differs from one-shot")
    check(demo["committed"] >= 1, "no committed chunk at the preemption")
    n_grid = len(resume_sweep.build_grid())
    check(per_call and min(per_call) > 0,
          f"a chunk skipped the spec-batched kernel: launches per chunk {per_call}")
    log(f"resume_sweep --self-preempt (backup pallas, {n_grid} specs, chunk 4): SIGTERM "
        f"after the first commit, SweepPreempted with {demo['committed']} step(s) on disk, "
        f"resumed: policy / g / h bitwise equal to the uninterrupted checkpointed card run; "
        f"{len(per_call)} chunk solves, spec-batched Bellman launches per chunk "
        f"{min(per_call)}..{max(per_call)}; the stream resume equal ({demo_s:.2f} s)")
    sigkill_drill(np, work)
    cpu_dir = os.path.join(work, "cpu_ck")
    grid = resume_sweep.build_grid(n=4)
    sweep_solve(grid, checkpoint_dir=cpu_dir, chunk_size=2, device="cpu")
    try:
        sweep_solve(grid, checkpoint_dir=cpu_dir, chunk_size=2, device="cuda")
        refused = False
    except ValueError as e:
        refused = "different sweep" in str(e)
    check(refused, "a CPU checkpoint resumed on the card was not refused")
    log("a checkpoint written by a CPU sweep is refused on the card (different sweep: "
        "the device type is fingerprinted)")
    resil = resilience_overhead(np, work)

    # --- durable streams --------------------------------------------------
    durable_streams(np, work)

    # --- the samplers -----------------------------------------------------
    svc, en = service(), energy_table()
    mu_max = BM / float(svc.mean(BM))
    m = MMPP2(lam1=BURSTY["r1"] * mu_max, lam2=BURSTY["r2"] * mu_max,
              dwell1=BURSTY["dwell1"], dwell2=BURSTY["dwell2"])
    n_steps = int(m.mean_rate * BURSTY_HORIZON)
    g = torch.Generator(device="cuda")
    g.manual_seed(300)
    times, mask, phases = mmpp2_times(g, m, n_steps, with_phases=True, lanes=BURSTY_SEEDS,
                                      device="cuda")
    counts = mask.sum(-1).tolist()
    size = max(counts) + 64
    padded = [pad_arrivals(times[s, :counts[s]], phases=phases[s, :counts[s]],
                           size=1 << (size - 1).bit_length()) for s in range(BURSTY_SEEDS)]
    arrs = np.stack([p[0] for p in padded])
    phs = np.stack([p[2] for p in padded])
    means = np.array([0.0] + [float(svc.mean(b)) for b in range(1, BM + 1)])
    stack = np.stack([q_policy(4, 160, BM), q_policy(12, 160, BM)])
    gr = run_grid(stack[None], arrs, phases=phs, means=means, zeta=en, b_max=BM,
                  device="cuda")
    check([int(x) for x in gr["n_served"][:, 0]] == counts,
          f"run_grid(phases=) served {gr['n_served'][:, 0]} of {counts} sampled arrivals")
    filt = PhaseBeliefFilter([m.lam1, m.lam2], [[-1 / m.dwell1, 1 / m.dwell1],
                                                 [1 / m.dwell2, -1 / m.dwell2]])
    brows, (b_f, t_f) = belief_forward(times, filt, device="cuda")
    last = [float(times[s, counts[s] - 1]) for s in range(BURSTY_SEEDS)]
    check(bool(torch.isfinite(brows).all()) and t_f.tolist() == last,
          "belief_forward over the sampled traces")
    rates = [c / t for c, t in zip(counts, last)]
    ph_share = float((phases.float() * mask).sum() / mask.sum())
    log(f"mmpp2_times (bursty, {BURSTY_SEEDS} lanes x {n_steps} steps, one launch): "
        f"{counts} arrivals, rates {[round(r, 5) for r in rates]} (mean rate "
        f"{m.mean_rate:.5f}; ~10 burst cycles a lane, so a lane's rate is not held), "
        f"burst share {ph_share:.4f}; run_grid(phases=) served every lane's arrivals; "
        f"belief_forward rows finite, final times the last arrivals")
    # the reference's own bar (tests/test_compiled.py): sorted, +inf tail,
    # the rate within 10% at 30 000 steps of a fast-switching MMPP2
    mb = MMPP2(lam1=1.0, lam2=5.0, dwell1=50.0, dwell2=50.0)
    tb_, mb_ = mmpp2_times(g, mb, 30_000, device="cuda")
    nb = int(mb_.sum())
    rate_b = nb / float(tb_[nb - 1])
    check(bool(torch.isinf(tb_[nb:]).all()) and bool((tb_[:nb].diff() >= 0).all())
          and abs(rate_b - mb.mean_rate) / mb.mean_rate < 0.10,
          f"mmpp2_times: rate {rate_b} vs {mb.mean_rate}, or not sorted")
    log(f"mmpp2_times (rates 1 / 5, dwell 50 / 50, 30000 steps): {nb} arrivals, rate "
        f"{rate_b:.5f} vs {mb.mean_rate:.5f} (10% bar), sorted with an +inf tail")
    lam = RHO * BM / float(svc.mean(BM))
    tab = q_policy(6, 160, BM)
    pt_ = poisson_times(g, lam, 100_000, device="cuda")
    r_p = simulate_compiled(tab, pt_, means=means, zeta=en, b_max=BM, device="cuda")
    rate_p = 100_000 / float(pt_[-1])
    check(r_p.n_served == 100_000 and abs(rate_p - lam) / lam < 0.05,
          f"poisson_times: served {r_p.n_served}, rate {rate_p} vs {lam}")
    proc = DiurnalProcess(base=lam, amp=0.6 * lam, period=5000.0)
    dt_, dm = diurnal_times(g, proc, 120_000, device="cuda")
    nd = int(dm.sum())
    r_d = simulate_compiled(tab, dt_, means=means, zeta=en, b_max=BM, device="cuda")
    rate_d = nd / float(dt_[nd - 1])
    check(r_d.n_served == nd and abs(rate_d - lam) / lam < 0.10,
          f"diurnal_times: served {r_d.n_served} of {nd}, rate {rate_d} vs {lam}")
    log(f"poisson_times (100000 arrivals, rate {rate_p:.5f} vs {lam:.5f}) and diurnal_times "
        f"({nd} arrivals of 120000 candidates, rate {rate_d:.5f}) served through "
        f"simulate_compiled on the card: every arrival served (W {r_p.lat_sum / r_p.n_served:.4f}"
        f" / {r_d.lat_sum / r_d.n_served:.4f} ms)")

    # --- Fig. 6 / Table I through simulate -------------------------------
    spec = paper_spec(rho=RHO)
    pols = {"static8": static_policy(8, spec.s_max)}
    for w2 in (1.6, 2.2):
        sp = dataclasses.replace(spec, w2=w2)
        pols[f"smdp_w2_{w2}"] = relative_value_iteration(build_smdp(sp), backup="pallas",
                                                         device="cuda").policy
    fig6 = {}
    for name, pol in pols.items():
        ev = evaluate_policy(build_smdp(spec), pol)
        t0 = time.perf_counter()
        sim = simulate(pol[:-1], svc, en, spec.lam, BM, n_epochs=FIG6_EPOCHS, seed=0,
                       device="cuda")
        wall = time.perf_counter() - t0
        p50, p90, p95 = sim.percentile([50, 90, 95])
        got = (sim.p_bar, sim.w_bar, p50, p90, p95)
        max_rel = max(abs(a - b) / b for a, b in zip(got, FIG6_PAPER[name]))
        ev_w = ev.w_bar
        ev_p = ev.p_bar
        log(f"fig6 {name} ({FIG6_EPOCHS} epochs, simulate on the card, {wall:.3f} s): "
            f"P={sim.p_bar:.4f} W={sim.w_bar:.4f} P50={p50:.4f} P90={p90:.4f} P95={p95:.4f} "
            f"(paper {FIG6_PAPER[name]}, max rel err {max_rel:.2%}); analytic W={ev_w:.4f} "
            f"P={ev_p:.4f}; Little l/lam={sim.l_bar / spec.lam:.4f}; clipped "
            f"{sim.n_clipped_arrivals}")
        check(abs(sim.w_bar - ev_w) <= 0.02 * ev_w, f"fig6 {name}: W off the analytic by 2%")
        check(abs(sim.p_bar - ev_p) <= 0.02 * ev_p, f"fig6 {name}: P off the analytic by 2%")
        check(abs(sim.l_bar / spec.lam - sim.w_bar) <= 0.02 * sim.w_bar,
              f"fig6 {name}: Little's law off by 2%")
        fig6[name] = dict(P=sim.p_bar, W=sim.w_bar, P50=p50, P90=p90, P95=p95,
                          max_rel_err_vs_paper=max_rel)
    ev_s = simulate_events(pols["smdp_w2_1.6"], svc, en, spec.lam, BM, n_epochs=FIG6_EPOCHS,
                           seed=0, backend="compiled", device="cuda")
    log(f"simulate_events(backend='compiled') smdp_w2_1.6 ({FIG6_EPOCHS} epochs, the event "
        f"kernel): W={ev_s.w_bar:.4f} P={ev_s.p_bar:.4f} Little l/lam="
        f"{ev_s.l_bar / spec.lam:.4f}")
    counts = kernels.launch_counts()
    log(f"phase 4h launches: {counts} ({time.perf_counter() - t_phase:.2f} s)")
    check(counts["mmpp_sample"] == 2, "mmpp2_times did not launch the MMPP sampler once a call")
    check(counts["sim_scan"] == len(pols), "simulate did not launch the simulator kernel "
          "once a policy")
    check(counts["bellman_banded_batched"] > 0 and counts["bellman_banded"] > 0,
          "phase 4h skipped the Bellman kernels")
    check(counts["serve_scan"] > 0 and counts["fleet_scan"] > 0 and counts["belief_forward"] > 0,
          "phase 4h skipped the event, fleet or belief kernel")
    rows["mmpp_sample"] = mmpp_row(torch, np, m, n_steps, BURSTY_SEEDS, counts["mmpp_sample"])
    args, kw = simulate_inputs(pols["smdp_w2_1.6"][:-1], svc, en, spec.lam, BM,
                               n_epochs=FIG6_EPOCHS, seed=0, device="cuda")
    check(sim_result(sk.sim_scan(*args, **kw)).w_bar == fig6["smdp_w2_1.6"]["W"],
          "simulate_inputs does not reproduce simulate's run")
    rows["sim_scan"] = dict(sim_row(torch, np, args, kw, counts["sim_scan"], "smdp_w2_1.6"),
                            fig6=fig6, resilience=resil)
    shutil.rmtree(work, ignore_errors=True)


def mix_at_main_shape(torch, np, table, energy):
    """The mix instance on the main path's own inputs (10^5 epochs), both
    phase rows the Table-I table, beliefs of a bursty filter over the
    stream: the blend is the table's action, so it must equal the plain
    lane, and its time compares with the plain lane's row."""
    from repro_torch.core import GOOGLENET_P4_LATENCY
    from repro_torch.kernels import serve_scan as ss
    from repro_torch.serving import PhaseBeliefFilter, PoissonProcess, belief_forward
    from repro_torch.serving.arrivals import take
    from repro_torch.serving.compiled import pad_arrivals

    means = np.array([0.0] + [float(GOOGLENET_P4_LATENCY(b)) for b in range(1, B_MAX + 1)])
    lam = RHO * B_MAX / float(means[B_MAX])
    ev, _ = take(PoissonProcess(lam), np.random.default_rng(0), n=4 * N_EPOCHS)
    arr, _ = pad_arrivals(np.array([e.time for e in ev]))
    filt = PhaseBeliefFilter([0.5 * lam, 1.5 * lam], [[-1e-3, 1e-3], [1e-3, -1e-3]])
    bel = belief_forward(arr, filt, device="cuda")[0].cpu()[None]
    stack = np.stack([table, table])
    args, _ = scan_inputs(torch, np, stack[None], arr[None], np.ones((1, N_EPOCHS)), means,
                          energy)
    kw = dict(t0=0.0, horizon=float("inf"), max_eps=N_EPOCHS, drain=False, b_max=B_MAX,
              record=True)
    got = scan_check(torch, np, "serve_scan_mix (main path shape)", args, kw, beliefs=bel)
    plain = ss.serve_scan_ref(*args, **kw)
    mixed = ss.serve_scan_ref(*args, beliefs=bel, **kw)
    check(torch.equal(plain.agg_i, mixed.agg_i) and torch.equal(plain.rec_a, mixed.rec_a),
          "mix over two equal rows differs from the plain lane")
    return got


def _normal(torch, rng, shape, dtype):
    return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                           device="cuda").to(dtype)


def _flash_inputs(torch, rng, B, Sq, Sk, H, KV, D, dtype):
    return (_normal(torch, rng, (B, Sq, H, D), dtype),
            _normal(torch, rng, (B, Sk, KV, D), dtype),
            _normal(torch, rng, (B, Sk, KV, D), dtype))


def _decode_inputs(torch, rng, B, S, H, KV, D, dtype, lengths):
    """q, and K / V as one layer's slices of an (L, B, S, KV, D) cache."""
    q = _normal(torch, rng, (B, H, D), dtype)
    cache = _normal(torch, rng, (2, 2, B, S, KV, D), dtype)
    lens = torch.as_tensor(lengths, dtype=torch.int32, device="cuda")
    return q, cache[0, 1], cache[1, 0], lens


def _fused_kv(torch, gen, B, S, KV, D, dtype):
    """K and V (B, S, KV, D) as the two halves of one (B, S, 2 KV D)
    projection, as Whisper's cross-attention reads them (row stride 2 KV D)."""
    kv = torch.randn((B, S, 2 * KV * D), generator=gen, device="cuda").to(dtype)
    return tuple(x.reshape(B, S, KV, D) for x in torch.chunk(kv, 2, dim=-1))


def _decode_inputs_card(torch, seed, B, S, H, KV, D, dtype, lengths, fused=False):
    """As _decode_inputs, drawn on the card from a seeded generator: the
    edge cases' 4096-deep caches are too large to draw on the host quickly.
    ``fused``: K and V are _fused_kv's views."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, H, D), generator=gen, device="cuda").to(dtype)
    lens = torch.as_tensor(lengths, dtype=torch.int32, device="cuda")
    if fused:
        return (q, *_fused_kv(torch, gen, B, S, KV, D, dtype), lens)
    cache = torch.randn((2, 2, B, S, KV, D), generator=gen, device="cuda").to(dtype)
    return q, cache[0, 1], cache[1, 0], lens


def _path_lengths(B):
    """Decode lengths of the serving path: 129 .. 143 (prompt 128 plus the
    generated tokens), spread over the batch."""
    return [LLM_PROMPT + 1 + (i * (LLM_GEN - 2)) // max(B - 1, 1) for i in range(B)]


def attn_flash_row(torch, rng, B, dtype, H, KV, D, reps=50):
    """Flash kernel, plain version and SDPA timed at the serving path's
    prefill (B x LLM_PROMPT, causal) for heads (H, KV, D)."""
    from repro_torch.kernels import flash_attention as fa

    F = torch.nn.functional
    S = LLM_PROMPT
    q, k, v = _flash_inputs(torch, rng, B, S, S, H, KV, D, dtype)
    ms = device_ms(torch, lambda: fa.flash_attention(q, k, v), reps)
    plain = device_ms(torch, lambda: fa.attention_ref(q, k, v), reps)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = device_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), reps)
    pairs = S * (S + 1) // 2  # causal (q, k) pairs per head
    item = q.element_size()
    b_ms, b_by = bound(item * (2 * B * S * H * D + 2 * B * S * KV * D),
                       4 * B * H * D * pairs,
                       BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
    dt = str(dtype).replace("torch.", "")
    variant = VARIANTS["flash_attention"][dt]
    log(f"flash_attention b={B} {(S, H, KV, D)} {dt} ({variant}): kernel_ms={ms:.6f} "
        f"plain_ms={plain:.6f} library_ms={lib:.6f} (SDPA, enable_gqa) "
        f"bound_ms={b_ms:.6f} ({b_by})")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by, shape=[B, S, S, H, KV, D], dtype=dt, variant=variant)


def attn_decode_row(torch, rng, B, dtype, n_sm, H, KV, D, reps=200):
    """Decode kernel, plain version and SDPA timed at the serving path's
    decode (a (LLM_PROMPT + LLM_GEN)-deep cache, lengths 129 .. 143) for
    heads (H, KV, D)."""
    from repro_torch.kernels import decode_attention as da

    F = torch.nn.functional
    S = LLM_PROMPT + LLM_GEN
    lens = _path_lengths(B)
    q, kc, vc, ln = _decode_inputs(torch, rng, B, S, H, KV, D, dtype, lens)
    ms = device_ms(torch, lambda: da.decode_attention(q, kc, vc, ln), reps)
    plain = device_ms(torch, lambda: da.decode_attention_ref(q, kc, vc, ln), reps)
    mask = (torch.arange(S, device="cuda")[None, :] < ln[:, None])[:, None, None, :]
    qt, kt, vt = q[:, :, None, :], kc.transpose(1, 2), vc.transpose(1, 2)
    lib = device_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), reps)
    keys = int(sum(lens))  # the valid prefixes this run's data needs
    item = q.element_size()
    b_ms, b_by = bound(item * (2 * B * H * D + 2 * keys * KV * D) + 4 * B,
                       4 * H * D * keys,
                       BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
    n_split = da._split_plan(B, S, KV, n_sm)
    dt = str(dtype).replace("torch.", "")
    log(f"decode_attention b={B} S={S} {(H, KV, D)} lengths {lens[0]}..{lens[-1]} {dt} "
        f"({VARIANTS['decode_attention'][dt]}, {n_split} splits): "
        f"kernel_ms={ms:.6f} plain_ms={plain:.6f} library_ms={lib:.6f} "
        f"(SDPA, enable_gqa, boolean mask) bound_ms={b_ms:.6f} ({b_by})")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by, shape=[B, S, H, KV, D], dtype=dt,
                variant=VARIANTS["decode_attention"][dt], n_split=n_split)


def attention_checker(torch, err):
    """held(name, got, want, dt, what, rel=None): got within atol = rtol =
    ATTN_TOL[dt] of want, and in bf16 with ``rel`` given also within ``rel``
    of it in relative L2 norm; err[name][dt] keeps the largest abs error."""
    def held(name, got, want, dt, what, rel=None):
        torch.cuda.synchronize()
        g, w = got.float(), want.float()
        e = (g - w).abs().max().item()
        t = ATTN_TOL[dt]
        check(torch.allclose(g, w, atol=t, rtol=t), f"{name} {what} {dt}: max abs err {e}")
        note = ""
        if rel is not None and dt == "bfloat16":
            r = (torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w)).item()
            check(r <= rel, f"{name} {what} {dt}: relative L2 err {r}")
            note = f", rel_l2_err={r:.3e} (bar {rel})"
        err[name][dt] = max(err[name][dt], e)
        log(f"{name} {what} {dt}: max_abs_err={e:.3e} (atol = rtol = {t}){note} ok")
    return held


def attention_phase(torch, np, rows):
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(3)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    full = dict(H=40, KV=8, D=128)  # Qwen2.5-32B's attention
    err = {n: dict.fromkeys(dts, 0.0) for n in ("flash_attention", "decode_attention")}
    held = attention_checker(torch, err)

    flash_shapes = FLASH_TEST_SHAPES + [(b, LLM_PROMPT, LLM_PROMPT, full["H"], full["KV"],
                                         full["D"], True, None) for b in (1, LLM_B_MAX)]
    for B, Sq, Sk, H, KV, D, causal, cap in flash_shapes:
        for dt, dtype in dts.items():
            q, k, v = _flash_inputs(torch, rng, B, Sq, Sk, H, KV, D, dtype)
            held("flash_attention", fa.flash_attention(q, k, v, causal=causal, softcap=cap),
                 fa.attention_ref(q, k, v, causal=causal, softcap=cap), dt,
                 f"{(B, Sq, Sk, H, KV, D)} causal={causal} softcap={cap}")
    decode_shapes = [(s, None) for s in DECODE_TEST_SHAPES] + [
        ((b, LLM_PROMPT + LLM_GEN, full["H"], full["KV"], full["D"]), _path_lengths(b))
        for b in (1, LLM_B_MAX)]
    for (B, S, H, KV, D), lens in decode_shapes:
        if lens is None:
            lens = rng.integers(1, S + 1, B)
        for dt, dtype in dts.items():
            q, kc, vc, ln = _decode_inputs(torch, rng, B, S, H, KV, D, dtype, lens)
            held("decode_attention", da.decode_attention(q, kc, vc, ln),
                 da.decode_attention_ref(q, kc, vc, ln), dt,
                 f"{(B, S, H, KV, D)} lengths={list(map(int, lens))}")

    # --- times at the serving path's shapes ---------------------------------
    def flash_row(B, dt):
        return attn_flash_row(torch, rng, B, dts[dt], **full)

    def decode_row(B, dt):
        return attn_decode_row(torch, rng, B, dts[dt], n_sm, **full)

    for name, row_fn, source, replaces in (
        ("flash_attention", flash_row, "src/repro_torch/kernels/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:72"),
        ("decode_attention", decode_row, "src/repro_torch/kernels/csrc/decode_attention.cu",
         "src/repro/kernels/decode_attention.py:67"),
    ):
        main = row_fn(LLM_B_MAX, "bfloat16")
        others = [row_fn(1, "bfloat16"), row_fn(LLM_B_MAX, "float32")]
        rows[name] = dict(route="cuda", source=source, replaces=replaces, **main,
                          other_shapes=others)

    # --- edge cases of the two designs (their own draws, after the above) --
    rng = np.random.default_rng(6)
    for B, Sq, Sk, H, KV, D, causal, cap in FLASH_EDGE_SHAPES:
        for dt, dtype in dts.items():
            q, k, v = _flash_inputs(torch, rng, B, Sq, Sk, H, KV, D, dtype)
            held("flash_attention", fa.flash_attention(q, k, v, causal=causal, softcap=cap),
                 fa.attention_ref(q, k, v, causal=causal, softcap=cap), dt,
                 f"edge {(B, Sq, Sk, H, KV, D)} causal={causal} softcap={cap}",
                 rel=ATTN_REL_BF16 if Sk == CROSS_KEYS else None)
    H, KV, D = full["H"], full["KV"], full["D"]
    for dt, dtype in dts.items():  # q / k / v as views of one fused qkv, as layers.py
        qkv = _normal(torch, rng, (LLM_B_MAX, LLM_PROMPT, (H + 2 * KV) * D), dtype)
        q, k, v = (x.reshape(LLM_B_MAX, LLM_PROMPT, -1, D)
                   for x in torch.split(qkv, [H * D, KV * D, KV * D], dim=-1))
        held("flash_attention", fa.flash_attention(q, k, v), fa.attention_ref(q, k, v), dt,
             f"fused qkv views {tuple(q.shape)} seq stride {q.stride(1)}")
    odd = torch.zeros(1 + 16 * 2 * 16, dtype=torch.bfloat16, device="cuda")[1:].view(1, 16, 2, 16)
    ok = torch.zeros((1, 16, 2, 16), dtype=torch.bfloat16, device="cuda")
    one = torch.full((1,), 4, dtype=torch.int32, device="cuda")
    for what, call in (("flash q", lambda: fa.flash_attention(odd, ok, ok)),
                       ("decode k_cache", lambda: da.decode_attention(ok[:, 0], odd, ok, one)),
                       ("decode q", lambda: da.decode_attention(odd[:, 0], ok, ok, one))):
        try:
            call()
        except ValueError as e:
            check("16-byte" in str(e), f"misaligned {what}: {e}")
        else:
            raise AssertionError(f"a misaligned {what} view was not refused")
    log("misaligned bf16 views (2 bytes off): flash q, decode k_cache and q refused ok")
    for i, (B, S, H, KV, D, lens) in enumerate(DECODE_EDGE_CASES):
        n_split = da._split_plan(B, S, KV, n_sm)
        fused = lens == "cross"
        if lens == "random":  # S, then anything from 0 to S
            lens = [S] + list(rng.integers(0, S + 1, B - 1))
        elif lens == "edges":  # 0, 1, S and inside the second split
            lens = [0, 1, S, da.split_bounds(S, n_split)[1][0] + 5]
        elif fused:  # every row of a projection's halves
            lens = [S] * B
        for cap in (None, 30.0) if D == 64 else (None,):
            for dt, dtype in dts.items():
                q, kc, vc, ln = _decode_inputs_card(torch, 100 + i, B, S, H, KV, D, dtype,
                                                    lens, fused)
                held("decode_attention", da.decode_attention(q, kc, vc, ln, softcap=cap),
                     da.decode_attention_ref(q, kc, vc, ln, softcap=cap), dt,
                     f"edge {(B, S, H, KV, D)} splits={n_split} softcap={cap} "
                     f"lengths={list(map(int, lens))[:8]}"
                     + (f" K / V views, row stride {kc.stride(1)}" if fused else ""),
                     rel=ATTN_REL_BF16 if S == CROSS_KEYS else None)
    masked_attention(torch, np, rows, held)
    for name in ("flash_attention", "decode_attention"):
        rows[name].update(max_abs_err=max(err[name].values()),
                          max_abs_err_by_dtype=err[name])


# --- the local layers' masks: sliding window (Gemma2), chunk (Llama-4) ------

#: (what, B, Sq, Sk, H, KV, D, softcap, window, chunk) at the local layers'
#: own shapes: Gemma2-9B's 16 / 8 x 256 and -27B's 32 / 16 x 128 heads at a
#: 6144-token prefill under their 4096 window (softcap 50), Llama-4's 40 / 8
#: x 128 at 9216 tokens under its 8192 chunk, and an append of 512 rows onto
#: a 4096-row cache under the window
MASKED_FLASH = [("gemma2-9b local prefill", 1, 6144, 6144, 16, 8, 256, 50.0, 4096, None),
                ("gemma2-27b local prefill", 1, 6144, 6144, 32, 16, 128, 50.0, 4096, None),
                ("llama4 chunked prefill", 1, 9216, 9216, 40, 8, 128, None, None, 8192),
                ("gemma2-9b append 512 onto 4096", 1, 512, 4608, 16, 8, 256, 50.0, 4096,
                 None)]
#: (what, B, S, H, KV, D, softcap, window, chunk, lengths): decode over
#: caches at lengths below, at and past the window / the chunk boundary,
#: ragged
MASKED_DECODE = [
    ("gemma2-9b local decode", 8, 8192, 16, 8, 256, 50.0, 4096, None,
     [1000, 4095, 4096, 4097, 5000, 6144, 7000, 8192]),
    ("llama4 chunked decode", 8, 9216, 40, 8, 128, None, None, 8192,
     [1000, 8191, 8192, 8193, 8300, 8704, 9000, 9216]),
]
#: edges of the masked tile plan, (B, Sq, Sk, H, KV, D, causal, softcap,
#: window, chunk): windows and chunks below a 64-key block and not
#: multiples of one, spans that start mid-block, chunk boundaries inside a
#: key block, an append, rows that see no key (Sq > Sk), causal off
MASKED_FLASH_EDGES = [(2, 300, 300, 4, 2, 64, True, None, 1, None),
                      (2, 300, 300, 4, 2, 64, True, 30.0, 5, None),
                      (1, 300, 300, 8, 2, 128, True, None, 37, None),
                      (1, 300, 300, 16, 8, 256, True, 50.0, 100, None),
                      (2, 300, 300, 4, 1, 64, True, None, None, 7),
                      (1, 300, 300, 8, 2, 128, True, None, None, 50),
                      (1, 300, 300, 4, 4, 64, True, 50.0, None, 130),
                      (1, 70, 330, 8, 2, 128, True, None, 100, None),
                      (1, 70, 330, 8, 2, 128, True, None, None, 100),
                      (2, 150, 90, 4, 1, 64, True, None, 37, None),
                      (2, 150, 90, 4, 1, 64, True, None, None, 50),
                      (1, 200, 200, 4, 2, 64, False, None, 37, None),
                      (1, 200, 200, 4, 2, 64, False, None, None, 50)]
#: (B, S, H, KV, D, window, chunk, lengths): windows and chunks below a
#: split, lengths 0 and around the edges
MASKED_DECODE_EDGES = [(4, 300, 8, 2, 64, 5, None, [0, 5, 6, 299]),
                       (3, 300, 8, 2, 64, None, 7, [7, 8, 200]),
                       (4, 2048, 16, 8, 256, 1000, None, [999, 1000, 1001, 2048]),
                       (3, 2048, 40, 8, 128, None, 1024, [0, 1024, 1025])]


def _sdpa_note(lib, cap, how="boolean mask"):
    """SDPA computes the same function only without a softcap: with one,
    its time (the mask, no cap) is a yardstick, not the library_ms."""
    if cap is None:
        return lib, f"library_ms={lib:.6f} (SDPA, enable_gqa, {how})"
    return None, (f"library_ms=None (SDPA has no softcap; SDPA with the {how} and "
                  f"no cap: {lib:.6f} ms)")


def masked_flash_row(torch, np, held, what, B, Sq, Sk, H, KV, D, cap, window, chunk, *,
                     causal=True, fused=False, rel=None):
    """Both dtypes held against the plain version (``rel``: held's bf16
    relative bar; ``fused``: K / V are _fused_kv's views); bf16 timed beside
    the plain version, SDPA (with the equivalent boolean mask under a window
    or a chunk) and the bound of the visible pairs."""
    from repro_torch.kernels import flash_attention as fa

    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(Sq + Sk + D)
    mask = dict(causal=causal, softcap=cap, window=window, chunk=chunk)
    for dt, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        q = torch.randn((B, Sq, H, D), generator=gen, device="cuda").to(dtype)
        k, v = (_fused_kv(torch, gen, B, Sk, KV, D, dtype) if fused else
                [torch.randn((B, Sk, KV, D), generator=gen, device="cuda").to(dtype)
                 for _ in range(2)])
        held("flash_attention", fa.flash_attention(q, k, v, **mask),
             fa.attention_ref(q, k, v, **mask), dt,
             f"{what} {(B, Sq, Sk, H, KV, D)} causal={causal} window={window} chunk={chunk} "
             f"softcap={cap}" + (f" K / V views, row stride {k.stride(1)}" if fused else ""),
             rel=rel)
    ms = device_ms(torch, lambda: fa.flash_attention(q, k, v, **mask), 10)
    plain = call_ms(torch, lambda: fa.attention_ref(q, k, v, **mask), 2)
    keep = fa.visible(torch.arange(Sq, device="cuda") + (Sk - Sq),
                      torch.arange(Sk, device="cuda"), causal=causal, window=window, chunk=chunk)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if window is None and chunk is None:
        how, sdpa_mask = ("is_causal" if causal else "no mask"), dict(is_causal=causal)
    else:
        how, sdpa_mask = "boolean mask", dict(attn_mask=keep)
    sdpa = device_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, enable_gqa=True, **sdpa_mask), 3)
    lib, note = _sdpa_note(sdpa, cap, how)
    pairs = int(keep.sum().item())
    del keep, sdpa_mask
    item = q.element_size()
    b_ms, b_by = bound(item * (2 * B * Sq * H * D + 2 * B * Sk * KV * D),
                       4 * B * H * D * pairs, BF16_FLOPS)
    log(f"flash_attention {what} {(B, Sq, Sk, H, KV, D)} causal={causal} window={window} "
        f"chunk={chunk} softcap={cap} bfloat16: kernel_ms={ms:.6f} plain_ms={plain:.6f} "
        f"{note} bound_ms={b_ms:.6f} ({b_by}; {pairs} visible pairs a head)")
    return dict(what=what, ms=ms, plain_ms=plain, library_ms=lib, sdpa_mask_ms=sdpa,
                bound_ms=b_ms, bound_by=b_by, shape=[B, Sq, Sk, H, KV, D], causal=causal,
                window=window, chunk=chunk, softcap=cap, dtype="bfloat16",
                visible_pairs=pairs)


def masked_decode_row(torch, np, held, n_sm, what, B, S, H, KV, D, cap, window, chunk,
                      lengths, *, fused=False, rel=None):
    """As masked_flash_row, for the decode kernel over a cache at ``lengths``."""
    from repro_torch.kernels import decode_attention as da

    F = torch.nn.functional
    mask = dict(softcap=cap, window=window, chunk=chunk)
    for dt, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        q, kc, vc, ln = _decode_inputs_card(torch, S + D, B, S, H, KV, D, dtype, lengths,
                                            fused)
        held("decode_attention", da.decode_attention(q, kc, vc, ln, **mask),
             da.decode_attention_ref(q, kc, vc, ln, **mask), dt,
             f"{what} {(B, S, H, KV, D)} window={window} chunk={chunk} softcap={cap} "
             f"lengths={lengths}"
             + (f" K / V views, row stride {kc.stride(1)}" if fused else ""), rel=rel)
    ms = device_ms(torch, lambda: da.decode_attention(q, kc, vc, ln, **mask), 100)
    plain = call_ms(torch, lambda: da.decode_attention_ref(q, kc, vc, ln, **mask), 3)
    lo, hi, _ = da.key_span(ln, S, window, chunk)
    pos = torch.arange(S, device="cuda")
    keep = ((pos[None, :] >= lo[:, None]) & (pos[None, :] < hi[:, None]))[:, None, None, :]
    qt, kt, vt = q[:, :, None, :], kc.transpose(1, 2), vc.transpose(1, 2)
    sdpa = device_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=keep, enable_gqa=True), 20)
    lib, note = _sdpa_note(sdpa, cap)
    keys = int((hi - lo).sum().item())  # the rows this run's lengths need
    item = q.element_size()
    b_ms, b_by = bound(item * (2 * B * H * D + 2 * keys * KV * D) + 4 * B,
                       4 * H * D * keys, BF16_FLOPS)
    n_split = da._split_plan(B, da.span_cap(S, window, chunk), KV, n_sm)
    log(f"decode_attention {what} b={B} S={S} {(H, KV, D)} window={window} chunk={chunk} "
        f"softcap={cap} bfloat16 ({n_split} splits of the masked span, {keys} keys read of "
        f"{int(ln.sum().item())} cached): kernel_ms={ms:.6f} plain_ms={plain:.6f} {note} "
        f"bound_ms={b_ms:.6f} ({b_by})")
    return dict(what=what, ms=ms, plain_ms=plain, library_ms=lib, sdpa_mask_ms=sdpa,
                bound_ms=b_ms,
                bound_by=b_by, shape=[B, S, H, KV, D], window=window, chunk=chunk,
                softcap=cap, dtype="bfloat16", lengths=lengths, keys_read=keys,
                n_split=n_split)


def masked_attention(torch, np, rows, held):
    """Phase 5's masked part: both kernels against their plain versions at
    the local layers' shapes (2e-5 f32, 2e-2 bf16) and at the edges of the
    tile plan, timed beside their bound and SDPA with the equivalent
    boolean mask (where SDPA can express the call: no softcap)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(27)
    for B, Sq, Sk, H, KV, D, causal, cap, window, chunk in MASKED_FLASH_EDGES:
        mask = dict(causal=causal, softcap=cap, window=window, chunk=chunk)
        for dt, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            q, k, v = _flash_inputs(torch, rng, B, Sq, Sk, H, KV, D, dtype)
            held("flash_attention", fa.flash_attention(q, k, v, **mask),
                 fa.attention_ref(q, k, v, **mask), dt,
                 f"masked edge {(B, Sq, Sk, H, KV, D)} causal={causal} window={window} "
                 f"chunk={chunk} softcap={cap}")
    for B, S, H, KV, D, window, chunk, lengths in MASKED_DECODE_EDGES:
        mask = dict(window=window, chunk=chunk)
        for dt, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            q, kc, vc, ln = _decode_inputs_card(torch, S + H, B, S, H, KV, D, dtype, lengths)
            held("decode_attention", da.decode_attention(q, kc, vc, ln, **mask),
                 da.decode_attention_ref(q, kc, vc, ln, **mask), dt,
                 f"masked edge {(B, S, H, KV, D)} window={window} chunk={chunk} "
                 f"lengths={lengths}")
    rows["flash_attention"]["masked_shapes"] = [
        masked_flash_row(torch, np, held, *case) for case in MASKED_FLASH]
    torch.cuda.empty_cache()
    rows["decode_attention"]["masked_shapes"] = [
        masked_decode_row(torch, np, held, n_sm, *case) for case in MASKED_DECODE]
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Whole-model checks (f32) and the LLM serving path (bf16)
# ---------------------------------------------------------------------------


def _greedy_logits(torch, M, cfg, params, tokens, steps, max_len, **inputs):
    """Prefill logits, then `steps` greedy decode steps; (B, steps+1, V), tokens.
    ``inputs``: the prefill's frames or patches."""
    lg, cache = M.prefill(cfg, params, {"tokens": tokens, **inputs}, max_len, torch.float32)
    out, toks = [lg], []
    for _ in range(steps):
        tok = torch.argmax(lg[:, -1], dim=-1, keepdim=True)
        toks.append(tok)
        lg, cache = M.decode_step(cfg, params, cache, tok)
        out.append(lg)
    return torch.cat(out, 1), toks


def model_checks(torch, np):
    import copy
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.models import model as M

    full = ARCHS[LLM_ARCH]
    rng = np.random.default_rng(4)

    # reduced config: the card (kernels) against the CPU (plain versions)
    cfg = full.reduced()
    cpu = M.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    card = copy.deepcopy(cpu).to("cuda")  # Module.to moves in place
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 32)))
    before = kernels.launch_counts()
    got, _ = _greedy_logits(torch, M, cfg, card, toks.cuda(), 4, 40)
    after = kernels.launch_counts()
    want, _ = _greedy_logits(torch, M, cfg, cpu, toks, 4, 40)
    check(want.device.type == "cpu" and got.device.type == "cuda", "devices of the check")
    e = (got.cpu() - want).abs().max().item()
    check(e <= LOGIT_ATOL, f"reduced model card vs CPU: max abs err {e}")
    check(after["flash_attention"] - before["flash_attention"] == cfg.n_layers
          and after["decode_attention"] - before["decode_attention"] == 4 * cfg.n_layers,
          "reduced model did not run one kernel launch per layer and step")
    log(f"reduced {LLM_ARCH} f32 (d={cfg.d_model}, L={cfg.n_layers}): card (kernels) vs "
        f"CPU (plain): prefill + 4 decode logits max_abs_err={e:.3e} (atol {LOGIT_ATOL}) ok")
    del cpu, card

    # full width, 2 layers: decode path (decode kernel) vs fresh prefill (flash)
    cfg2 = dataclasses.replace(full, n_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = M.init_params(cfg2, gen, torch.float32, "cuda")
    P, steps = 16, 4
    toks = torch.as_tensor(rng.integers(0, cfg2.vocab_size, (2, P)), device="cuda")
    dec, gen_toks = _greedy_logits(torch, M, cfg2, params, toks, steps, P + steps + 1)
    worst = 0.0
    for i in range(steps + 1):
        seq = torch.cat([toks] + gen_toks[:i], dim=1)
        fresh, _ = M.prefill(cfg2, params, {"tokens": seq}, seq.shape[1], torch.float32)
        e = (dec[:, i] - fresh[:, 0]).abs().max().item()
        worst = max(worst, e)
        check(e <= LOGIT_ATOL, f"full-width decode vs prefill at step {i}: {e}")
    torch.cuda.synchronize()
    log(f"{LLM_ARCH} full width (d={cfg2.d_model}, H={cfg2.n_heads}/{cfg2.n_kv_heads}, "
        f"2 layers) f32: decode-path logits vs a fresh prefill of prompt + generated, "
        f"{steps} steps: max_abs_err={worst:.3e} (atol {LOGIT_ATOL}); logit scale "
        f"{dec.abs().max().item():.3f}; ok")
    del params, dec
    torch.cuda.empty_cache()


def _backups_of(solution, device):
    """Bellman backups of the solve that produced ``solution``: one RVI per
    s_max of its growth sequence (64, x1.5, ...), replayed if it grew."""
    import dataclasses
    import math

    from repro_torch.core import build_smdp, relative_value_iteration

    s, total = 64, 0
    while s < solution.spec.s_max:
        spec = dataclasses.replace(solution.spec, s_max=s)
        total += relative_value_iteration(build_smdp(spec), backup="pallas",
                                          device=device).iterations + 1
        s = min(math.ceil(s * 1.5), 4096)
    return total + solution.rvi.iterations + 1


def profile_decode(torch, M, cfg, params, B):
    """Device time of greedy decode steps at batch B, by kernel (torch.profiler),
    against their wall time measured without the profiler."""
    tokens = torch.randint(0, cfg.vocab_size, (B, LLM_PROMPT), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    n = 5

    def prefill():
        return M.prefill(cfg, params, {"tokens": tokens}, LLM_PROMPT + 2 * n + 1,
                         torch.bfloat16)

    def steps(cache, tok):
        for _ in range(n):
            lg, cache = M.decode_step(cfg, params, cache, tok)
            tok = torch.argmax(lg[:, -1], dim=-1, keepdim=True)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, cache = prefill()
    tok = torch.argmax(lg[:, -1], dim=-1, keepdim=True)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    pre_ms, pre_launches, pre_by = profile_busy(torch, prefill)
    if pre_ms is None:
        log("profile prefill: the profiler recorded no device time (not measured)")
    else:
        flash = [v for key, v in pre_by.items() if "flash_fwd" in key]
        flash_ms = sum(ms for ms, _ in flash)
        ssd = [v for key, v in pre_by.items() if "ssd_" in key]  # ssd_cb and the scan
        ssd_ms = sum(ms for ms, _ in ssd)
        log(f"profile prefill b={B} x {LLM_PROMPT} tokens: device busy {pre_ms:.3f} ms in "
            f"{pre_launches} kernels; flash_attention kernel {flash_ms:.3f} ms in "
            f"{sum(c for _, c in flash)} launches (share {flash_ms / pre_ms:.4f}); "
            + (f"ssd_scan kernels {ssd_ms:.3f} ms in {sum(c for _, c in ssd)} launches "
               f"(share {ssd_ms / pre_ms:.4f}); " if cfg.family == "hybrid" else "")
            + f"unprofiled wall_ms={prefill_ms:.3f}")
    t0 = time.perf_counter()
    steps(cache, tok)
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    dev_ms, launches, by_name = profile_busy(torch, lambda: steps(cache, tok))
    if dev_ms is None:
        log("profile decode: the profiler recorded no device time (not measured)")
        return
    total = dev_ms / n
    groups = {"decode_attention kernel": 0.0, "matmul (cuBLAS)": 0.0, "other": 0.0}
    if cfg.family == "hybrid":
        groups = {"ssd_scan kernel": 0.0, **groups}
    for key, (ms, _) in by_name.items():
        low = key.lower()
        if "decode_attn" in low:  # the split and the combine kernel
            g = "decode_attention kernel"
        elif "ssd_" in low:  # the scan (and its first pass, which decode skips)
            g = "ssd_scan kernel"
        elif any(w in low for w in ("nvjet", "gemm", "gemv", "cutlass", "xmma")):
            g = "matmul (cuBLAS)"
        else:
            g = "other"
        groups[g] += ms / n
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"profile decode step b={B}: prefill of {B} x {LLM_PROMPT} tokens "
        f"wall_ms={prefill_ms:.3f}; decode wall_ms={wall_ms:.3f} per step, device busy "
        f"{total:.3f} ms per step (busy share {total / wall_ms:.3f}) in "
        f"{launches / n:.0f} kernels per step; weight-read "
        f"bound {weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms "
        f"({weight_bytes / 2**30:.2f} GiB at 3.35 TB/s); "
        + "; ".join(f"{k} {v:.3f} ms (share {v / total:.4f})" for k, v in groups.items()))
    for key, (ms, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"  {ms / n:9.4f} ms/step {cnt // n:5d} calls/step  {key[:90]}")
    return dict(wall_ms=wall_ms, device_ms=total, kernels=launches / n,
                groups_ms=groups)


def llm_path(torch, np, kernels, rows):
    from repro_torch.configs import ARCHS
    from repro_torch.launch import serve_llm
    from repro_torch.models import model as M

    cfg = dataclasses.replace(ARCHS[LLM_ARCH], n_layers=LLM_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"{LLM_ARCH} (published width, {cfg.n_layers} of its "
        f"{ARCHS[LLM_ARCH].n_layers} layers: d={cfg.d_model} L={cfg.n_layers} "
        f"H={cfg.n_heads}/{cfg.n_kv_heads} hd={cfg.head_dim} ff={cfg.d_ff} "
        f"V={cfg.vocab_size}) bf16 random weights: {n_params / 1e9:.3f} B parameters, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, init {time.perf_counter() - t0:.2f} s")

    lines = []

    def note(msg):
        lines.append(msg)
        log(f"  {msg}")

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = serve_llm.run_pipeline(
        cfg, params, n_requests=LLM_REQUESTS, rho=LLM_RHO, gen_tokens=LLM_GEN,
        prompt_len=LLM_PROMPT, b_max=LLM_B_MAX, cache_dtype=torch.bfloat16, seed=0,
        log=note)
    counts = kernels.launch_counts()
    wall = time.perf_counter() - t0
    log(f"LLM path launches: {counts} ({res.segments} segments, wall {wall:.2f} s)")
    L, seg = cfg.n_layers, res.segments
    check(counts["flash_attention"] == L * seg,
          f"flash_attention launched {counts['flash_attention']} times, not {L} x {seg}")
    check(counts["decode_attention"] == L * (LLM_GEN - 1) * seg,
          f"decode_attention launched {counts['decode_attention']} times, "
          f"not {L} x {LLM_GEN - 1} x {seg}")
    backups = _backups_of(res.solution, "cuda")
    check(counts["bellman_banded"] == backups,
          f"bellman_banded launched {counts['bellman_banded']} times for {backups} backups")
    log("l(b) ms, b = 1..8 (non-decreasing): "
        + " ".join(f"{x:.3f}" for x in res.lat_ms))
    sol = res.solution
    log(f"policy head (s = 0..16): {sol.action_table(16).tolist()} s_max={sol.spec.s_max} "
        f"backups={backups} W_model={sol.eval.w_bar:.3f} ms")
    for name, rep in res.reports.items():
        lat = rep.latencies
        check(rep.n_served == LLM_REQUESTS and np.isfinite(lat).all(), f"{name} served")
        log(f"serve {name}: W={lat.mean() * 1e3:.3f} ms P95={rep.percentile(95) * 1e3:.3f} ms "
            f"mean_batch={rep.mean_batch:.3f} P_proxy={rep.power:.3f} W "
            f"(60 W x service time, not measured) span={rep.span:.3f} s")
    check(all(np.isfinite(res.lat_ms)) and res.lat_ms[0] > 0, "l(b) profile")
    log(f"peak memory (torch.cuda.max_memory_allocated): "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for name in ("flash_attention", "decode_attention"):
        rows[name]["launches"] = counts[name]
    rows["bellman_banded"]["launches_llm_path"] = counts["bellman_banded"]
    profile_decode(torch, M, cfg, params, LLM_B_MAX)
    profile_decode(torch, M, cfg, params, 1)
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 4i: the Mamba2 hybrid (Zamba2-1.2B) on the card
# ---------------------------------------------------------------------------

HYBRID_ARCH = "zamba2-1.2b"
SSD_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
SSD_REPLACES = ("src/repro/models/layers.py:523 (the lax.scan of mamba2_block's chunked "
                "SSD, :496-523; a scan, not a Pallas kernel)")
#: f32: tests/test_models.py's kernel-against-naive bar; bf16 inputs: the
#: attention kernels' (both versions compute in f32 from the same inputs)
SSD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: bf16 inputs, held inside their 2e-2 bar: both versions multiply the same
#: bf16 values in f32, so only the order of sums differs.  A kernel that
#: rounded the decay-weighted att, the state or w x to bf16 would miss it.
SSD_BF16_IN_F32_TOL = 1e-4
#: the kernel's edges: one step (decode), a chunk shorter than 8, exactly one
#: 128-chunk (a prompt), one step past it (a padded second chunk), several
SSD_EDGE_S, SSD_EDGE_CHUNKS, SSD_EDGE_B = (1, 7, 128, 129, 300), (8, 128), (1, 8)
SSD_HEADS = [(64, 64, 64), (8, 16, 16)]  # Zamba2's (H, P, N) and the reduced config's
#: the first design's times at ssd_row's shapes, (S, dtype) -> ms, quoted in
#: the log (not measured in this run): earlier runs of this script on an
#: NVIDIA H100 80GB HBM3 at 700.00 W, as PERF.md records them
SSD_EARLIER_MS = {(128, "bfloat16"): 0.512904, (1, "bfloat16"): 0.014864,
                  (128, "float32"): 0.520782, (1, "float32"): 0.014720}
HYBRID_DEPTH = 7  # six Mamba2 layers, the shared block, one more layer
#: the hybrid's serving depth: Zamba2-1.2B at its published width with 12 of
#: its 38 layers (the shared block twice; a cut for the time limit: 19 until
#: the script took 1122 s with phase 4m on an H100 80GB HBM3)
HYBRID_SERVE_LAYERS = 12


def _ssd_inputs(torch, np, rng, B, S, H, P, N, dtype, zero_state):
    """Inputs in a Mamba2 block's regime (tests/test_torch_cuda.py's): xs, B
    and C views of one fused (B, S, H P + 2 N) tensor, B and C at the
    1/sqrt(N) scale of a normalised dot product, dt log-uniform on Mamba2's
    initialisation range [1e-3, 1e-1], A = -exp(log-uniform on [0, log
    16]).  Unit-scale B / C with dt ~ 0.3 give outputs of ~100 from
    cancelling sums, where even the plain version in f32 misses 2e-5
    against float64."""
    xbc = rng.normal(size=(B, S, H * P + 2 * N))
    xbc[..., H * P:] /= np.sqrt(N)
    xbc = torch.as_tensor(xbc, dtype=torch.float32, device="cuda").to(dtype)
    xs = xbc[..., :H * P].reshape(B, S, H, P)
    Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    f = dict(dtype=torch.float32, device="cuda")
    dt = torch.as_tensor(np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (B, S, H))), **f)
    a = torch.as_tensor(-np.exp(rng.uniform(0.0, np.log(16.0), H)), **f)
    state = None if zero_state else torch.as_tensor(rng.normal(size=(B, H, P, N)), **f)
    return xs, Bm, Cm, dt, dt * a, state


def ssd_work(B, S, H, P, N, L, item):
    """(operations, bytes) the chunked SSD needs on these inputs: per chunk
    of Lc steps, C_i . B_j for the Lc (Lc + 1) / 2 causal pairs once per
    sequence (it has no head index), and per head the decay weights, the
    intra-chunk product, the carried state's term and the state update, a
    multiply-add two operations; bytes: each input read once, y (f32) and
    the state written once."""
    ops = 0
    for c0 in range(0, S, L):
        lc = min(L, S - c0)
        pairs = lc * (lc + 1) // 2
        ops += B * 2 * pairs * N
        ops += B * H * (3 * pairs + 2 * pairs * P + 4 * lc * P * N + 2 * P * N)
    nbytes = (item * (B * S * H * P + 2 * B * S * N)
              + 4 * (2 * B * S * H + 2 * B * H * P * N + B * S * H * P))
    return ops, nbytes


def ssd_row(torch, np, rng, B, S, dtype, reps):
    """The SSD kernel and its plain version timed at Zamba2's heads (CUDA
    graphs of back-to-back calls), beside the bound."""
    from repro_torch.kernels import ssd_scan as sd

    H, P, N = SSD_HEADS[0]
    args = _ssd_inputs(torch, np, rng, B, S, H, P, N, dtype, False)
    ms = device_ms(torch, lambda: sd.ssd_scan(*args, chunk=128), reps)
    plain = device_ms(torch, lambda: sd.ssd_scan_ref(*args, chunk=128), reps)
    ops, nbytes = ssd_work(B, S, H, P, N, sd.chunk_len(S, 128), args[0].element_size())
    b_ms, b_by = bound(nbytes, ops, F32_FLOPS)
    dt = str(dtype).replace("torch.", "")
    earlier = SSD_EARLIER_MS[(S, dt)]
    log(f"ssd_scan b={B} S={S} (H, P, N)={(H, P, N)} {dt}: kernel_ms={ms:.6f} "
        f"plain_ms={plain:.6f} library_ms=null (no PyTorch call computes it) "
        f"bound_ms={b_ms:.6f} ({b_by}; {ops / 1e9:.4f} GFLOP, {nbytes / 1e6:.3f} MB); "
        f"the first design {earlier:.6f} ms (quoted from PERF.md, not measured in this "
        f"run; {earlier / ms:.2f}x)")
    return dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=b_ms, bound_by=b_by,
                shape=[B, S, H, P, N], dtype=dt)


def _ssd_state_rounded(torch, sd, xs, Bm, Cm, dt, dA, state, chunk):
    """The control of the bf16-in-f32 bar: the plain version with the state
    rounded to bf16 wherever it is read or handed on, as a kernel that kept
    the state in bf16 would compute."""
    S = xs.shape[1]
    L = sd.chunk_len(S, chunk)
    ys = []
    for c0 in range(0, S, L):
        c = slice(c0, c0 + L)
        state = None if state is None else state.to(torch.bfloat16).float()
        y, state = sd.ssd_scan_ref(xs[:, c], Bm[:, c], Cm[:, c], dt[:, c], dA[:, c], state,
                                   chunk=L)
        ys.append(y)
    return torch.cat(ys, 1), state.to(torch.bfloat16).float()


def ssd_checks(torch, np, rows):
    """The SSD kernel against ssd_scan_ref at the edges of its design, in
    place, and timed at the serving path's prefill and decode shapes."""
    from repro_torch.kernels import ssd_scan as sd

    rng = np.random.default_rng(21)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    worst, n, tight = dict.fromkeys(dts, 0.0), 0, SSD_BF16_IN_F32_TOL
    for H, P, N in SSD_HEADS:
        for S in SSD_EDGE_S:
            for chunk in SSD_EDGE_CHUNKS:
                for B in SSD_EDGE_B:
                    for zero in (True, False):
                        for dt, dtype in dts.items():
                            args = _ssd_inputs(torch, np, rng, B, S, H, P, N, dtype, zero)
                            y, st = sd.ssd_scan(*args, chunk=chunk)
                            y_ref, st_ref = sd.ssd_scan_ref(*args, chunk=chunk)
                            torch.cuda.synchronize()
                            t = SSD_TOL[dt]
                            e = max((y - y_ref).abs().max().item(),
                                    (st - st_ref).abs().max().item())
                            check(torch.allclose(y, y_ref, atol=t, rtol=t)
                                  and torch.allclose(st, st_ref, atol=t, rtol=t),
                                  f"ssd_scan {(B, S, H, P, N)} chunk={chunk} zero_state="
                                  f"{zero} {dt}: max abs err {e}")
                            check(dt == "float32" or (
                                torch.allclose(y, y_ref, atol=tight, rtol=tight)
                                and torch.allclose(st, st_ref, atol=tight, rtol=tight)),
                                f"ssd_scan {(B, S, H, P, N)} chunk={chunk} zero_state="
                                f"{zero} bf16: max abs err {e}, outside {tight}: an f32 "
                                f"operand was rounded")
                            worst[dt] = max(worst[dt], e)
                            n += 1
    log(f"ssd_scan against ssd_scan_ref on the card: {n} cases (S {SSD_EDGE_S} x chunk "
        f"{SSD_EDGE_CHUNKS} x B {SSD_EDGE_B} x zero / random state x f32 / bf16 at (H, P, "
        f"N) {SSD_HEADS}): max_abs_err f32 {worst['float32']:.3e} (atol = rtol = "
        f"{SSD_TOL['float32']}), bf16 {worst['bfloat16']:.3e} ({SSD_TOL['bfloat16']}, and "
        f"{tight}) ok")
    for S in (1, LLM_PROMPT + 1):  # decode, and a prefill that hands its state on
        args = _ssd_inputs(torch, np, rng, LLM_B_MAX, S, 64, 64, 64, torch.bfloat16, False)
        y_ref, st_ref = sd.ssd_scan_ref(*args, chunk=128)
        y_c, st_c = _ssd_state_rounded(torch, sd, *args, chunk=128)
        e = max((y_c - y_ref).abs().max().item(), (st_c - st_ref).abs().max().item())
        check(not (torch.allclose(y_c, y_ref, atol=tight, rtol=tight)
                   and torch.allclose(st_c, st_ref, atol=tight, rtol=tight)),
              f"the state-in-bf16 control at S={S} passes the {tight} bar ({e}): the bar "
              f"cannot tell a rounded state")
        log(f"ssd_scan's {tight} bar against a control, the plain version with its state "
            f"rounded to bf16 (b={LLM_B_MAX} S={S} bf16): max_abs_err={e:.3e}, outside the "
            f"bar ok")
    xs, Bm, Cm, dt_, dA, st = _ssd_inputs(torch, np, rng, 8, 129, 64, 64, 64,
                                          torch.bfloat16, False)
    y_ref, st_ref = sd.ssd_scan_ref(xs, Bm, Cm, dt_, dA, st, chunk=128)
    y, out = sd.ssd_scan(xs, Bm, Cm, dt_, dA, st, chunk=128, state_out=st)
    torch.cuda.synchronize()
    t = SSD_TOL["bfloat16"]
    check(out.data_ptr() == st.data_ptr() and all(
        torch.allclose(y, y_ref, atol=b, rtol=b) and torch.allclose(out, st_ref, atol=b, rtol=b)
        for b in (t, tight)), "ssd_scan in place")
    log("ssd_scan with state_out = the incoming state (the cache updated in place) ok")
    main = ssd_row(torch, np, rng, LLM_B_MAX, LLM_PROMPT, torch.bfloat16, 50)
    others = [ssd_row(torch, np, rng, LLM_B_MAX, 1, torch.bfloat16, 200),
              ssd_row(torch, np, rng, LLM_B_MAX, LLM_PROMPT, torch.float32, 50),
              ssd_row(torch, np, rng, LLM_B_MAX, 1, torch.float32, 200)]
    rows["ssd_scan"] = dict(route="cuda", source=SSD_SOURCE, replaces=SSD_REPLACES,
                            max_abs_err=max(worst.values()), **main,
                            max_abs_err_by_dtype=worst, other_shapes=others)


def hybrid_attention(torch, np, rows):
    """Flash and decode at Zamba2's shared block (32 / 32 heads of 64, G =
    1) against their plain versions, and timed beside SDPA."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    cfg = ARCHS[HYBRID_ARCH]
    heads = dict(H=cfg.n_heads, KV=cfg.n_kv_heads, D=cfg.head_dim)
    rng = np.random.default_rng(22)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for dt, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        t = ATTN_TOL[dt]
        for B in (1, LLM_B_MAX):
            q, k, v = _flash_inputs(torch, rng, B, LLM_PROMPT, LLM_PROMPT, *heads.values(),
                                    dtype)
            got, want = fa.flash_attention(q, k, v), fa.attention_ref(q, k, v)
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            check(torch.allclose(got.float(), want.float(), atol=t, rtol=t),
                  f"flash_attention {HYBRID_ARCH} heads b={B} {dt}: {e}")
            rows["flash_attention"]["max_abs_err_by_dtype"][dt] = max(
                rows["flash_attention"]["max_abs_err_by_dtype"][dt], e)
            S = LLM_PROMPT + LLM_GEN
            q, kc, vc, ln = _decode_inputs(torch, rng, B, S, *heads.values(), dtype,
                                           _path_lengths(B))
            got, want = da.decode_attention(q, kc, vc, ln), da.decode_attention_ref(q, kc, vc, ln)
            torch.cuda.synchronize()
            e2 = (got.float() - want.float()).abs().max().item()
            check(torch.allclose(got.float(), want.float(), atol=t, rtol=t),
                  f"decode_attention {HYBRID_ARCH} heads b={B} {dt}: {e2}")
            rows["decode_attention"]["max_abs_err_by_dtype"][dt] = max(
                rows["decode_attention"]["max_abs_err_by_dtype"][dt], e2)
            log(f"{HYBRID_ARCH} heads {tuple(heads.values())} b={B} {dt}: flash (prefill "
                f"{LLM_PROMPT}) max_abs_err={e:.3e}, decode (lengths "
                f"{_path_lengths(B)[0]}..{_path_lengths(B)[-1]}) max_abs_err={e2:.3e} "
                f"(atol = rtol = {t}) ok")
    for name, row_fn in (("flash_attention", lambda B, d: attn_flash_row(
            torch, rng, B, d, **heads)), ("decode_attention", lambda B, d: attn_decode_row(
            torch, rng, B, d, n_sm, **heads))):
        new = [row_fn(LLM_B_MAX, torch.bfloat16), row_fn(LLM_B_MAX, torch.float32)]
        rows[name]["other_shapes"] += [dict(r, arch=HYBRID_ARCH) for r in new]
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err_by_dtype"].values())


def hybrid_model_checks(torch, np):
    """The reduced Zamba2 on the card against the CPU (launch counts exact),
    and full width at depth 7: decode path against fresh prefills."""
    import copy
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.models import model as M

    full = ARCHS[HYBRID_ARCH]
    rng = np.random.default_rng(23)
    cfg = full.reduced()
    cpu = M.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    card = copy.deepcopy(cpu).to("cuda")
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 32)))
    kernels.reset_launch_counts()
    got, _ = _greedy_logits(torch, M, cfg, card, toks.cuda(), 4, 40)
    counts = kernels.launch_counts()
    want, _ = _greedy_logits(torch, M, cfg, cpu, toks, 4, 40)
    e = (got.cpu() - want).abs().max().item()
    check(e <= LOGIT_ATOL, f"reduced {HYBRID_ARCH} card vs CPU: max abs err {e}")
    n_occ = M.n_shared_occurrences(cfg)
    check(counts["ssd_scan"] == counts["ssd_scan:scan"] == 5 * cfg.n_layers
          and counts["ssd_scan:cb"] == cfg.n_layers
          and counts["flash_attention"] == n_occ and counts["decode_attention"] == 4 * n_occ,
          f"reduced {HYBRID_ARCH} launches {counts}: not one SSD scan per Mamba2 layer and "
          f"step with a first pass at the prefill, one flash / decode per occurrence of the "
          f"shared block and step")
    log(f"reduced {HYBRID_ARCH} f32 (d={cfg.d_model}, L={cfg.n_layers}, {n_occ} shared-block "
        f"occurrences): card (kernels) vs CPU (plain): prefill + 4 decode logits "
        f"max_abs_err={e:.3e} (atol {LOGIT_ATOL}); launches ssd_scan {counts['ssd_scan']}, "
        f"flash {counts['flash_attention']}, decode {counts['decode_attention']} ok")
    del cpu, card

    cfg7 = dataclasses.replace(full, n_layers=HYBRID_DEPTH)
    params = M.init_params(cfg7, torch.Generator(device="cuda").manual_seed(0),
                           torch.float32, "cuda")
    P, steps = 16, 4
    toks = torch.as_tensor(rng.integers(0, cfg7.vocab_size, (2, P)), device="cuda")
    dec, gen_toks = _greedy_logits(torch, M, cfg7, params, toks, steps, P + steps + 1)
    worst = 0.0
    for i in range(steps + 1):
        seq = torch.cat([toks] + gen_toks[:i], dim=1)
        fresh, _ = M.prefill(cfg7, params, {"tokens": seq}, seq.shape[1], torch.float32)
        e = (dec[:, i] - fresh[:, 0]).abs().max().item()
        worst = max(worst, e)
        check(e <= LOGIT_ATOL, f"{HYBRID_ARCH} depth {HYBRID_DEPTH} decode vs prefill at "
                               f"step {i}: {e}")
    torch.cuda.synchronize()
    log(f"{HYBRID_ARCH} full width (d={cfg7.d_model}, {cfg7.n_ssm_heads} SSM heads of "
        f"{cfg7.ssm_head_dim}, state {cfg7.ssm_state}, attention {cfg7.n_heads}/"
        f"{cfg7.n_kv_heads} x {cfg7.head_dim}), depth {HYBRID_DEPTH} (6 Mamba2 layers, the "
        f"shared block, 1 more) f32: decode-path logits vs a fresh prefill of prompt + "
        f"generated, {steps} steps: max_abs_err={worst:.3e} (atol {LOGIT_ATOL}); logit "
        f"scale {dec.abs().max().item():.3f}; ok")
    del params, dec
    torch.cuda.empty_cache()


def hybrid_path(torch, np, kernels, rows):
    """Zamba2-1.2B at its published width, HYBRID_SERVE_LAYERS of its 38
    layers (bf16), through serve_llm.run_pipeline, launch counts exact."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch import serve_llm
    from repro_torch.models import model as M

    cfg = dataclasses.replace(ARCHS[HYBRID_ARCH], n_layers=HYBRID_SERVE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    n_occ = M.n_shared_occurrences(cfg)
    log(f"{HYBRID_ARCH} (published width, {cfg.n_layers} of its "
        f"{ARCHS[HYBRID_ARCH].n_layers} layers: d={cfg.d_model} L={cfg.n_layers} Mamba2 "
        f"(d_inner {cfg.d_inner_ssm} = {cfg.n_ssm_heads} heads x {cfg.ssm_head_dim}, state "
        f"{cfg.ssm_state}, conv {cfg.ssm_conv}), shared attention + MLP every "
        f"{cfg.shared_attn_every} layers ({n_occ} occurrences, H={cfg.n_heads}/"
        f"{cfg.n_kv_heads} hd={cfg.head_dim}, GELU ff={cfg.d_ff}), V={cfg.vocab_size}, tied) "
        f"bf16 random weights: {n_params / 1e9:.3f} B parameters, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, init "
        f"{time.perf_counter() - t0:.2f} s")

    def note(msg):
        log(f"  {msg}")

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = serve_llm.run_pipeline(
        cfg, params, n_requests=LLM_REQUESTS, rho=LLM_RHO, gen_tokens=LLM_GEN,
        prompt_len=LLM_PROMPT, b_max=LLM_B_MAX, cache_dtype=torch.bfloat16, seed=0,
        log=note)
    counts = kernels.launch_counts()
    wall = time.perf_counter() - t0
    log(f"hybrid path launches: {counts} ({res.segments} segments, wall {wall:.2f} s)")
    seg = res.segments
    want = {"flash_attention": n_occ * seg, "decode_attention": n_occ * (LLM_GEN - 1) * seg,
            "ssd_scan": cfg.n_layers * LLM_GEN * seg,
            "ssd_scan:scan": cfg.n_layers * LLM_GEN * seg,
            "ssd_scan:cb": cfg.n_layers * seg,  # the first pass, at each prefill
            "bellman_banded": _backups_of(res.solution, "cuda")}
    for name, n in want.items():
        check(counts[name] == n, f"{name} launched {counts[name]} times, not {n}")
    log(f"hybrid path launches exact: flash {n_occ} x {seg} segments, decode {n_occ} x "
        f"{LLM_GEN - 1} x {seg}, ssd_scan {cfg.n_layers} x {LLM_GEN} x {seg} (its first "
        f"pass {cfg.n_layers} x {seg}, at the prefills), Bellman "
        f"{want['bellman_banded']} backups")
    log("hybrid l(b) ms, b = 1..8 (non-decreasing): "
        + " ".join(f"{x:.3f}" for x in res.lat_ms))
    sol = res.solution
    log(f"hybrid policy head (s = 0..16): {sol.action_table(16).tolist()} "
        f"s_max={sol.spec.s_max} backups={want['bellman_banded']} "
        f"W_model={sol.eval.w_bar:.3f} ms")
    for name, rep in res.reports.items():
        lat = rep.latencies
        check(rep.n_served == LLM_REQUESTS and np.isfinite(lat).all(), f"hybrid {name} served")
        log(f"hybrid serve {name}: W={lat.mean() * 1e3:.3f} ms "
            f"P95={rep.percentile(95) * 1e3:.3f} ms mean_batch={rep.mean_batch:.3f} "
            f"P_proxy={rep.power:.3f} W (60 W x service time, not measured) "
            f"span={rep.span:.3f} s")
    check(all(np.isfinite(res.lat_ms)) and res.lat_ms[0] > 0, "hybrid l(b) profile")
    log(f"hybrid peak memory (torch.cuda.max_memory_allocated): "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    rows["ssd_scan"]["launches"] = counts["ssd_scan"]
    rows["ssd_scan"]["launches_by_kernel"] = {k: counts[f"ssd_scan:{k}"] for k in ("cb", "scan")}
    for name in ("flash_attention", "decode_attention"):
        rows[name]["launches_hybrid_path"] = counts[name]
    rows["bellman_banded"]["launches_hybrid_path"] = counts["bellman_banded"]
    prof = profile_decode(torch, M, cfg, params, LLM_B_MAX)
    if prof is not None:
        rows["ssd_scan"]["decode_step_share"] = (
            prof["groups_ms"]["ssd_scan kernel"] / prof["device_ms"])
    del params
    torch.cuda.empty_cache()


def hybrid_phase(torch, np, kernels, rows):
    t0 = time.perf_counter()
    ssd_checks(torch, np, rows)
    hybrid_attention(torch, np, rows)
    hybrid_model_checks(torch, np)
    hybrid_path(torch, np, kernels, rows)
    log(f"phase 4i ({HYBRID_ARCH}): {time.perf_counter() - t0:.2f} s")

# ---------------------------------------------------------------------------
# Phase 4l: Gemma2-9B, Llama-4 Scout and Grok-1 (local masks, chunked
# prefill, the MoE FFN)
# ---------------------------------------------------------------------------

GEMMA_ARCH, LLAMA4_ARCH, GROK_ARCH = "gemma2-9b", "llama4-scout-17b-a16e", "grok-1-314b"
#: Gemma2-9B at its published width with 14 of its 42 layers (7 local /
#: global pairs), and Llama-4 Scout with one pattern unit of its 48 layers
#: (3 chunked-local, 1 full): depth cuts for time
GEMMA_SERVE_LAYERS = 14
LLAMA4_LAYERS = 4
#: the long-context checks, f32 at full width (the decode-vs-forward bound
#: is an f32 bound; bf16 rounding alone exceeds it): Gemma2-9B at 8 of its
#: 42 layers (4 local / global pairs), a 6144-token prefill, a 512-token
#: append, 32 decode steps past the window; Llama-4 at LLAMA4_LAYERS, an
#: 8176-token prefill and 32 decode steps across the 8192 chunk boundary,
#: held to a one-shot forward of 9216 tokens, with drop-free experts
#: (capacity factor E / top_k, as the reference's decode-vs-forward test
#: raises it: a one-shot forward groups its tokens otherwise than the steps)
GEMMA_LONG = dict(layers=8, prefill=6144, append=512, steps=32, total=6688)
LLAMA4_LONG = dict(prefill=8176, append=0, steps=32, total=9216)
#: Grok-1 at full width, one layer, f32: the kernel path against the plain
#: path on the card (prefill of 2 x 256, 8 decode steps)
GROK_CHECK = dict(batch=2, prompt=256, steps=8)


class _PlainOps:
    """The attention and WKV6 entry points as layers.py calls them, on the
    kernels' plain versions: the plain path on the card."""

    @staticmethod
    def flash_attention(q, k, v, *, causal=True, softcap=None, window=None, chunk=None,
                        device=None):
        from repro_torch.kernels import flash_attention as fa
        return fa.attention_ref(q, k, v, causal=causal, softcap=softcap, window=window,
                                chunk=chunk)

    @staticmethod
    def decode_attention(q, k_cache, v_cache, lengths, *, softcap=None, window=None,
                         chunk=None, device=None):
        from repro_torch.kernels import decode_attention as da
        return da.decode_attention_ref(q, k_cache, v_cache, lengths, softcap=softcap,
                                       window=window, chunk=chunk)

    @staticmethod
    def wkv6_scan(r, k, v, w, u, state=None, *, state_out=None, device=None):
        from repro_torch.kernels import wkv6_scan as wk
        return wk.wkv6_scan_ref(r, k, v, w, u, state, state_out=state_out)


def _free(torch, what):
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"{what} freed: {torch.cuda.memory_allocated() / 2**30:.3f} GiB still allocated")


def serve_model(torch, np, kernels, arch, cfg, describe, want, prompt_len=LLM_PROMPT):
    """``cfg`` (bf16, random weights) through serve_llm.run_pipeline with the
    Qwen cell's traffic (a prompt of ``prompt_len``), counters zeroed just
    before and read just after;
    ``want(L, segments)`` gives the exact launch counts by wrapper (the
    Bellman backups are added).  Logs l(b), each scheduler's serve and the
    peak memory, frees the model and returns the counts."""
    from repro_torch.launch import serve_llm
    from repro_torch.models import model as M

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"{arch} ({describe}) bf16 random weights: {n_params / 1e9:.3f} B parameters, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, init "
        f"{time.perf_counter() - t0:.2f} s")

    def note(msg):
        log(f"  {msg}")

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = serve_llm.run_pipeline(
        cfg, params, n_requests=LLM_REQUESTS, rho=LLM_RHO, gen_tokens=LLM_GEN,
        prompt_len=prompt_len, b_max=LLM_B_MAX, cache_dtype=torch.bfloat16, seed=0,
        log=note)
    counts = kernels.launch_counts()
    wall = time.perf_counter() - t0
    seg = res.segments
    exact = {**want(cfg.n_layers, seg), "bellman_banded": _backups_of(res.solution, "cuda")}
    for name, n in exact.items():
        check(counts[name] == n, f"{arch}: {name} launched {counts[name]} times, not {n}")
    log(f"{arch} path launches exact ({seg} segments, {cfg.n_layers} layers, wall "
        f"{wall:.2f} s): " + ", ".join(f"{k} {v}" for k, v in exact.items()))
    log(f"{arch} l(b) ms, b = 1..8 (non-decreasing): "
        + " ".join(f"{x:.3f}" for x in res.lat_ms))
    for name, rep in res.reports.items():
        lat = rep.latencies
        check(rep.n_served == LLM_REQUESTS and np.isfinite(lat).all(), f"{arch} {name} served")
        log(f"{arch} serve {name}: W={lat.mean() * 1e3:.3f} ms "
            f"P95={rep.percentile(95) * 1e3:.3f} ms mean_batch={rep.mean_batch:.3f} "
            f"P_proxy={rep.power:.3f} W (60 W x service time, not measured) "
            f"span={rep.span:.3f} s")
    check(all(np.isfinite(res.lat_ms)) and res.lat_ms[0] > 0, f"{arch} l(b) profile")
    log(f"{arch} peak memory (torch.cuda.max_memory_allocated): "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del params
    _free(torch, arch)
    return counts


def local_serve(torch, np, kernels, rows, arch, n_layers):
    """``arch`` at its published width with ``n_layers`` layers through
    serve_model: one flash launch a layer a segment, one decode launch a
    layer a decode step."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import model as M

    cfg = dataclasses.replace(ARCHS[arch], n_layers=n_layers)
    n_local = sum(M._layer_is_local(cfg, i) for i in range(cfg.n_layers))
    counts = serve_model(
        torch, np, kernels, arch, cfg,
        f"published width, {cfg.n_layers} of its {ARCHS[arch].n_layers} layers, "
        f"{n_local} local: d={cfg.d_model} H={cfg.n_heads}/{cfg.n_kv_heads} "
        f"hd={cfg.head_dim} ff={cfg.d_ff} V={cfg.vocab_size} window={cfg.sliding_window} "
        f"chunk={cfg.chunk_size} experts={cfg.n_experts} top_k={cfg.top_k} "
        f"shared={cfg.n_shared_experts}",
        lambda L, seg: {"flash_attention": L * seg,
                        "decode_attention": L * (LLM_GEN - 1) * seg})
    for name in ("flash_attention", "decode_attention"):
        rows[name].setdefault("launches_local_path", {})[arch] = counts[name]
    rows["bellman_banded"].setdefault("launches_local_path", {})[arch] = counts[
        "bellman_banded"]


def long_context_check(torch, arch, layers, prefill, append, steps, total, **replace):
    """f32, full width, b = 1: a prefill, an append (flash over the cache's
    prefix), then greedy decode steps, each position's logits held to a
    one-shot forward over the same tokens at LOGIT_ATOL."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import model as M

    cfg = dataclasses.replace(ARCHS[arch], n_layers=layers, **replace)
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(1),
                           torch.float32, "cuda")
    toks = torch.randint(0, cfg.vocab_size, (1, total), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(2))
    start = prefill + append  # the first decode position
    t0 = time.perf_counter()
    with torch.inference_mode():
        lg, cache = M.prefill(cfg, params, {"tokens": toks[:, :prefill]}, start + steps,
                              torch.float32)
        got = {"prefill": lg[0]}
        if append:
            h, cache = M.forward(cfg, params, toks[:, prefill:start], cache=cache)
            lg = M._unembed(cfg, params, h)
            got["append"] = lg[0]
        seq, dec = [toks[:, :start]], []
        for _ in range(steps):
            tok = torch.argmax(lg[:, -1], dim=-1, keepdim=True)
            seq.append(tok)
            lg, cache = M.decode_step(cfg, params, cache, tok)
            dec.append(lg[0])
        got["decode"] = torch.cat(dec)
        torch.cuda.synchronize()
        path_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        full = torch.cat(seq + [toks[:, start + steps:]], dim=1)
        h, _ = M.forward(cfg, params, full)
        pos = {"prefill": [prefill - 1], "append": list(range(prefill, start)),
               "decode": list(range(start, start + steps))}
        errs = {}
        for part, g in got.items():
            want = M._unembed(cfg, params, h[:, pos[part]])[0]
            errs[part] = (g - want).abs().max().item()
        scale = want.abs().max().item()
        torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    worst = max(errs.values())
    check(worst <= LOGIT_ATOL, f"{arch} long context: decode path vs one-shot {errs}")
    log(f"{arch} long context f32 (full width, {layers} layers, b=1, window="
        f"{cfg.sliding_window} chunk={cfg.chunk_size}"
        + (f", capacity factor {cfg.moe_capacity_factor}" if cfg.n_experts else "")
        + f"): prefill {prefill}" + (f", append {append}" if append else "")
        + f", {steps} decode steps (positions {start}..{start + steps - 1}) against a "
        f"one-shot forward of {full.shape[1]} tokens: max_abs_err "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (atol {LOGIT_ATOL}; logit scale {scale:.3f}); path {path_s:.2f} s, one-shot "
        f"{one_s:.2f} s; peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; ok")
    del params, cache, h
    _free(torch, f"{arch} long-context model")


def grok_check(torch, np, kernels):
    """Grok-1 at full width, one layer, f32: prefill and greedy decode
    through the kernels against the same weights through the plain path on
    the card (top-2 routing at capacity factor 1.25, softcap 30)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    cfg = dataclasses.replace(ARCHS[GROK_ARCH], n_layers=1)
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           torch.float32, "cuda")
    B, P, steps = GROK_CHECK["batch"], GROK_CHECK["prompt"], GROK_CHECK["steps"]
    toks = torch.randint(0, cfg.vocab_size, (B, P), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(3))
    kernels.reset_launch_counts()
    got, got_toks = _greedy_logits(torch, M, cfg, params, toks, steps, P + steps)
    counts = kernels.launch_counts()
    check(counts["flash_attention"] == 1 and counts["decode_attention"] == steps,
          f"grok kernel path launches {counts}")
    kernel_ops = L.ops
    L.ops = _PlainOps
    try:
        want, want_toks = _greedy_logits(torch, M, cfg, params, toks, steps, P + steps)
    finally:
        L.ops = kernel_ops
    check(kernels.launch_counts() == counts, "the plain path launched a kernel")
    e = (got - want).abs().max().item()
    check(e <= LOGIT_ATOL and all(torch.equal(a, b) for a, b in zip(got_toks, want_toks)),
          f"grok kernel path vs plain path: max abs err {e}")
    log(f"{GROK_ARCH} full width (d={cfg.d_model}, H={cfg.n_heads}/{cfg.n_kv_heads}, "
        f"{cfg.n_experts} experts top-{cfg.top_k} ff={cfg.d_ff}, softcap "
        f"{cfg.attn_softcap}, 1 layer) f32, {sum(p.numel() for p in params.parameters()) / 1e9:.3f}"
        f" B parameters: prefill {B} x {P} + {steps} decode steps, kernel path vs plain "
        f"path on the card: max_abs_err={e:.3e} (atol {LOGIT_ATOL}), greedy tokens equal; "
        f"logit scale {got.abs().max().item():.3f}; kernel path launches flash 1, decode "
        f"{steps}; peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; ok")
    del params
    _free(torch, GROK_ARCH)


def local_moe_phase(torch, np, kernels, rows):
    from repro_torch.configs import ARCHS

    t0 = time.perf_counter()
    local_serve(torch, np, kernels, rows, GEMMA_ARCH, GEMMA_SERVE_LAYERS)
    long_context_check(torch, GEMMA_ARCH, **GEMMA_LONG)
    local_serve(torch, np, kernels, rows, LLAMA4_ARCH, LLAMA4_LAYERS)
    scout = ARCHS[LLAMA4_ARCH]
    long_context_check(torch, LLAMA4_ARCH, LLAMA4_LAYERS, **LLAMA4_LONG,
                       moe_capacity_factor=scout.n_experts / scout.top_k)
    grok_check(torch, np, kernels)
    log(f"phase 4l (Gemma2-9B, Llama-4 Scout, Grok-1): {time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------------------
# Phase 4m: RWKV6 (Finch) -- the WKV6 scan kernel and RWKV6-3B served
# ---------------------------------------------------------------------------

RWKV_ARCH = "rwkv6-3b"
WKV_SOURCE = "src/repro_torch/kernels/csrc/wkv6_scan.cu"
WKV_REPLACES = ("src/repro/models/layers.py:599-627 (the lax.scan of rwkv6_time_mix's "
                "step; a scan, not a Pallas kernel)")
#: of the largest |entry| of y and of the final state: both versions compute
#: in f32 from the same rounded inputs, the sums in another order
WKV_TOL = 2e-5
#: the kernel's edges: one step (decode), two, two of its 8-step tiles and
#: one step past them, four (its three-slot ring wrapped) and one past,
#: around 64, a long walk; every head size it is built for, so every
#: column split; one head and 680 (1360 blocks at P = 64: a ragged last
#: wave); then the path's prefill and decode and b = 1 at 2048 steps
#: (WKV_LONG; tools/wkv6_ab.py times it: the plain version's 2048 steps are
#: too slow to capture in a graph here)
WKV_EDGE_S = (1, 2, 16, 17, 32, 33, 63, 64, 65, 1000)
WKV_EDGE_P, WKV_EDGE_BH = (16, 32, 64), ((1, 1), (17, 40))
WKV_LONG = (1, 2048)
#: RWKV6-3B's serving depth: 16 of its 32 layers at its published width (a
#: cut for time: with all 32 the script took 963 s on an H100 80GB HBM3,
#: over the 950 s it aims at)
RWKV_SERVE_LAYERS = 16
#: f32 at full width, b = 1: a prefill, a continuation from the cache and
#: decode steps, held to a one-shot forward of all the tokens
RWKV_LONG = dict(layers=4, prefill=2048, append=128, steps=32, total=2208)
#: the kernel path against the plain path on the card: 2 layers, f32, with
#: the bonus, the decay base and ln_x drawn from a seed
RWKV_CHECK = dict(layers=2, batch=2, prompt=256, steps=8)


def _wkv_inputs(torch, gen, B, S, H, P, dtype, zero_state):
    """r, k, v at 0.5 in ``dtype``; decays exp(-exp(w_log)), w_log uniform on
    [-9, 2] (w from 0.9999 down to 6e-4); a nonzero bonus; the incoming
    state random or None: tests/test_torch_cuda.py's law, drawn on the card
    from ``gen`` (cheaper than numpy on the host for the S = 1000 cases)."""
    f = dict(dtype=torch.float32, device="cuda", generator=gen)
    r, k, v = (torch.randn((B, S, H, P), **f).mul_(0.5).to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(torch.rand((B, S, H, P), **f).mul_(11.0).sub_(9.0)))
    u = torch.randn((H, P), **f).mul_(0.5)
    state = None if zero_state else torch.randn((B, H, P, P), **f).mul_(0.5)
    return r, k, v, w, u, state


def wkv_work(B, S, H, P, item, with_state):
    """(operations, bytes) of the WKV6 scan: 5 flops a state entry a step
    (r^T S into y, w S + k v^T), and 5 a channel for the rank-1 bonus,
    y += v (sum_i r_i u_i k_i); bytes: r, k, v in their dtype, w and y in
    f32, u, the state read (when given) and written once."""
    ops = 5 * B * S * H * P * P + 5 * B * S * H * P
    nbytes = (3 * item * B * S * H * P + 4 * 2 * B * S * H * P + 4 * H * P
              + 4 * B * H * P * P * (2 if with_state else 1))
    return ops, nbytes


def _wkv_err(torch, got, want):
    """max abs error, and its bar: WKV_TOL of the largest |entry|."""
    return (got - want).abs().max().item(), WKV_TOL * want.abs().max().item()


def wkv_row(torch, gen, B, S, dtype, reps):
    """The WKV6 kernel and its plain version timed at RWKV6-3B's heads (CUDA
    graphs of back-to-back calls), beside the bound; the state as the cache
    hands it in."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import wkv6_scan as wk

    H, P = ARCHS[RWKV_ARCH].n_heads, ARCHS[RWKV_ARCH].head_dim
    args = _wkv_inputs(torch, gen, B, S, H, P, dtype, False)
    ms = device_ms(torch, lambda: wk.wkv6_scan(*args), reps)
    plain = device_ms(torch, lambda: wk.wkv6_scan_ref(*args), max(2, reps // S))
    ops, nbytes = wkv_work(B, S, H, P, args[0].element_size(), True)
    b_ms, b_by = bound(nbytes, ops, F32_FLOPS)
    dt = str(dtype).replace("torch.", "")
    log(f"wkv6_scan b={B} S={S} (H, P)={(H, P)} {dt}: kernel_ms={ms:.6f} "
        f"plain_ms={plain:.6f} library_ms=null (no PyTorch call computes it) "
        f"bound_ms={b_ms:.6f} ({b_by}; {ops / 1e9:.4f} GFLOP, {nbytes / 1e6:.3f} MB; "
        f"{ms / b_ms:.2f}x the bound)")
    return dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=b_ms, bound_by=b_by,
                shape=[B, S, H, P], dtype=dt)


def wkv_checks(torch, rows):
    """The WKV6 kernel against wkv6_scan_ref at the edges of its design and
    at the serving path's shapes, in place, then timed at the path's prefill
    and decode."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import wkv6_scan as wk

    gen = torch.Generator(device="cuda").manual_seed(31)
    H, P = ARCHS[RWKV_ARCH].n_heads, ARCHS[RWKV_ARCH].head_dim
    cases = [(B, S, Hc, Pc) for S in WKV_EDGE_S for Pc in WKV_EDGE_P
             for B, Hc in WKV_EDGE_BH]
    cases += [(LLM_B_MAX, LLM_PROMPT, H, P), (LLM_B_MAX, 1, H, P), (*WKV_LONG, H, P)]
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    worst, n = dict.fromkeys(dts, 0.0), 0
    for B, S, Hc, Pc in cases:
        for zero in (True, False):
            for dt, dtype in dts.items():
                args = _wkv_inputs(torch, gen, B, S, Hc, Pc, dtype, zero)
                y, st = wk.wkv6_scan(*args)
                y_ref, st_ref = wk.wkv6_scan_ref(*args)
                torch.cuda.synchronize()
                for what, g, w in (("y", y, y_ref), ("state", st, st_ref)):
                    e, bar = _wkv_err(torch, g, w)
                    check(e <= bar, f"wkv6_scan {(B, S, Hc, Pc)} zero_state={zero} {dt} "
                                    f"{what}: max abs err {e}, bar {bar}")
                    worst[dt] = max(worst[dt], e)
                n += 1
    log(f"wkv6_scan against wkv6_scan_ref on the card: {n} cases (S {WKV_EDGE_S} x P "
        f"{WKV_EDGE_P} x (B, H) {WKV_EDGE_BH}, and the path's 8 x 128 / 8 x 1 and "
        f"{WKV_LONG[0]} x {WKV_LONG[1]} at (H, P) {(H, P)}; zero / random state x f32 / "
        f"bf16): max_abs_err f32 "
        f"{worst['float32']:.3e}, bf16 {worst['bfloat16']:.3e} (each within {WKV_TOL} of "
        f"its output's largest |entry|) ok")
    for S in (1, LLM_PROMPT):
        r, k, v, w, u, st = _wkv_inputs(torch, gen, LLM_B_MAX, S, H, P, torch.bfloat16, False)
        y_ref, st_ref = wk.wkv6_scan_ref(r, k, v, w, u, st)
        y, out = wk.wkv6_scan(r, k, v, w, u, st, state_out=st)
        torch.cuda.synchronize()
        errs = [_wkv_err(torch, y, y_ref), _wkv_err(torch, out, st_ref)]
        check(out.data_ptr() == st.data_ptr() and all(e <= bar for e, bar in errs),
              f"wkv6_scan in place at S={S}: {errs}")
    log("wkv6_scan with state_out = the incoming state (the cache updated in place), "
        "prefill and decode, ok")
    main = wkv_row(torch, gen, LLM_B_MAX, LLM_PROMPT, torch.bfloat16, 50)
    others = [wkv_row(torch, gen, LLM_B_MAX, 1, torch.bfloat16, 200),
              wkv_row(torch, gen, LLM_B_MAX, LLM_PROMPT, torch.float32, 50),
              wkv_row(torch, gen, LLM_B_MAX, 1, torch.float32, 200)]
    rows["wkv6_scan"] = dict(route="cuda", source=WKV_SOURCE, replaces=WKV_REPLACES,
                             max_abs_err=max(worst.values()), **main,
                             max_abs_err_by_dtype=worst, other_shapes=others)


def rwkv_serve(torch, np, kernels, rows):
    """RWKV6-3B at its published width, RWKV_SERVE_LAYERS layers, through
    serve_model: one WKV6 launch a layer a step, no attention."""
    from repro_torch.configs import ARCHS

    full = ARCHS[RWKV_ARCH]
    cfg = dataclasses.replace(full, n_layers=RWKV_SERVE_LAYERS)
    counts = serve_model(
        torch, np, kernels, RWKV_ARCH, cfg,
        f"published width, {cfg.n_layers} of its {full.n_layers} layers: d={cfg.d_model} "
        f"{cfg.n_heads} heads x {cfg.head_dim}, channel mix {cfg.d_ff}, "
        f"V={cfg.vocab_size}, {cfg.norm}, untied",
        lambda L, seg: {"wkv6_scan": L * LLM_GEN * seg, "flash_attention": 0,
                        "decode_attention": 0})
    rows["wkv6_scan"]["launches"] = counts["wkv6_scan"]
    rows["bellman_banded"]["launches_rwkv_path"] = counts["bellman_banded"]


def rwkv_kernel_vs_plain(torch, np, kernels):
    """RWKV6-3B at full width, 2 layers, f32, with u_bonus, w_base and ln_x
    drawn from a numpy seed: prefill and greedy decode through the kernel
    against the same weights through the plain path on the card."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    c = RWKV_CHECK
    cfg = dataclasses.replace(ARCHS[RWKV_ARCH], n_layers=c["layers"])
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           torch.float32, "cuda")
    rng = np.random.default_rng(33)
    with torch.no_grad():
        for p in params.blocks:
            for name, draw in (("u_bonus", lambda s: rng.normal(0.0, 0.5, s)),
                               ("w_base", lambda s: rng.uniform(-9.0, 2.0, s)),
                               ("ln_x", lambda s: rng.normal(0.0, 0.3, s))):
                p[name].copy_(torch.as_tensor(draw(tuple(p[name].shape))))
    B, P, steps = c["batch"], c["prompt"], c["steps"]
    toks = torch.randint(0, cfg.vocab_size, (B, P), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(3))
    kernels.reset_launch_counts()
    got, got_toks = _greedy_logits(torch, M, cfg, params, toks, steps, P + steps)
    counts = kernels.launch_counts()
    check(counts["wkv6_scan"] == cfg.n_layers * (steps + 1),
          f"rwkv kernel path launches {counts}")
    kernel_ops = L.ops
    L.ops = _PlainOps
    try:
        want, want_toks = _greedy_logits(torch, M, cfg, params, toks, steps, P + steps)
    finally:
        L.ops = kernel_ops
    check(kernels.launch_counts() == counts, "the plain path launched a kernel")
    e = (got - want).abs().max().item()
    check(e <= LOGIT_ATOL and all(torch.equal(a, b) for a, b in zip(got_toks, want_toks)),
          f"rwkv kernel path vs plain path: max abs err {e}")
    log(f"{RWKV_ARCH} full width (d={cfg.d_model}, {cfg.n_heads} heads x {cfg.head_dim}, "
        f"{cfg.n_layers} layers) f32, u_bonus / w_base / ln_x drawn from a seed: prefill "
        f"{B} x {P} + {steps} decode steps, kernel path vs plain path on the card: "
        f"max_abs_err={e:.3e} (atol {LOGIT_ATOL}), greedy tokens equal; logit scale "
        f"{got.abs().max().item():.3f}; kernel path launches wkv6_scan "
        f"{counts['wkv6_scan']}; peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; ok")
    del params
    _free(torch, f"{RWKV_ARCH} check model")


def rwkv_phase(torch, np, kernels, rows):
    t0 = time.perf_counter()
    wkv_checks(torch, rows)
    rwkv_serve(torch, np, kernels, rows)
    long_context_check(torch, RWKV_ARCH, **RWKV_LONG)
    rwkv_kernel_vs_plain(torch, np, kernels)
    log(f"phase 4m (RWKV6-3B): {time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------------------
# Phase 4n: Whisper-small (the encoder, cross-attention) and Qwen2-VL-7B
# (M-RoPE, patch inputs) through the hand attention kernels
# ---------------------------------------------------------------------------

ENCDEC_ARCH, VLM_ARCH = "whisper-small", "qwen2-vl-7b"
#: Qwen2-VL-7B's serving depth: 14 of its 28 layers at its published width
#: (a depth cut for the time limit, with phase 4o beside it)
VLM_SERVE_LAYERS = 14
#: the f32 checks at full width, b 2: a prompt of 16 text tokens (after
#: Qwen2-VL's 256 stub patches), 8 greedy decode steps; Whisper whole (12 +
#: 12 layers), Qwen2-VL at 2 of its 28 layers (a depth cut)
ENCDEC_VLM_CHECK = dict(batch=2, prompt=16, steps=8)
VLM_CHECK_LAYERS = 2


def _extra_inputs(torch, cfg, B, dtype, seed):
    """The stub frontends' inputs of a batch, as model.input_shapes names
    them (Whisper's frames, Qwen2-VL's patches): unit normals drawn on the
    card."""
    from repro_torch.models import model as M

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {name: torch.randn((B,) + shape, generator=gen, device="cuda").to(dtype)
            for name, shape in M.input_shapes(cfg).items()}


def encdec_vlm_kernel_rows(torch, np, rows):
    """Both kernels at the shapes the two new paths give them, at b = 8:
    Whisper's encoder (1500 x 1500, non-causal, 12 / 12 x 64), its
    cross-attention prefill (128 rows over 1500 keys) and decode (lengths
    1500), both over K / V views of one projection, and Qwen2-VL's prefill
    (256 patches + 128 tokens, causal, 28 / 4 x 128: G = 7) and decode (a
    400-deep cache at the path's lengths); each in both dtypes against its
    plain version, Whisper's also at ATTN_REL_BF16."""
    from repro_torch.configs import ARCHS

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    w, q = ARCHS[ENCDEC_ARCH], ARCHS[VLM_ARCH]
    T, P = w.encoder_len, q.n_patches + LLM_PROMPT
    wh, qh = (w.n_heads, w.n_kv_heads, w.head_dim), (q.n_heads, q.n_kv_heads, q.head_dim)
    B = LLM_B_MAX
    names = ("flash_attention", "decode_attention")
    err = {n: rows[n]["max_abs_err_by_dtype"] for n in names}
    held = attention_checker(torch, err)
    none = (None, None, None)  # softcap, window, chunk
    flash = [masked_flash_row(torch, np, held, "whisper-small encoder", B, T, T, *wh, *none,
                              causal=False, rel=ATTN_REL_BF16),
             masked_flash_row(torch, np, held, "whisper-small cross prefill", B, LLM_PROMPT, T,
                              *wh, *none, causal=False, fused=True, rel=ATTN_REL_BF16),
             masked_flash_row(torch, np, held, "qwen2-vl-7b prefill", B, P, P, *qh, *none)]
    torch.cuda.empty_cache()
    qlens = [P + 1 + (i * (LLM_GEN - 2)) // (B - 1) for i in range(B)]
    decode = [masked_decode_row(torch, np, held, n_sm, "whisper-small cross decode", B, T,
                                *wh, *none, [T] * B, fused=True, rel=ATTN_REL_BF16),
              masked_decode_row(torch, np, held, n_sm, "qwen2-vl-7b decode", B, P + LLM_GEN,
                                *qh, *none, qlens)]
    rows["flash_attention"]["encdec_vlm_shapes"] = flash
    rows["decode_attention"]["encdec_vlm_shapes"] = decode
    for n in names:
        rows[n]["max_abs_err"] = max(err[n].values())
    torch.cuda.empty_cache()


def encdec_vlm_serve(torch, np, kernels, rows):
    """Whisper-small whole (12 + 12 layers) and Qwen2-VL-7B at its published
    width through serve_model: Whisper's segment launches flash once an
    encoder layer and twice a decoder layer (self, cross) in its prefill and
    decode twice a decoder layer a step; Qwen2-VL's (a prompt of its 256
    patches + LLM_PROMPT tokens) flash once a layer, decode once a layer a
    step."""
    from repro_torch.configs import ARCHS

    w = ARCHS[ENCDEC_ARCH]
    counts = serve_model(
        torch, np, kernels, ENCDEC_ARCH, w,
        f"published config, all {w.n_encoder_layers} + {w.n_layers} layers: d={w.d_model} "
        f"H={w.n_heads}/{w.n_kv_heads} hd={w.head_dim} ff={w.d_ff} ({w.act}) "
        f"V={w.vocab_size}, {w.encoder_len} stub frames, {w.norm}",
        lambda L, seg: {"flash_attention": (w.n_encoder_layers + 2 * L) * seg,
                        "decode_attention": 2 * L * (LLM_GEN - 1) * seg})
    launches = {ENCDEC_ARCH: counts}
    full = ARCHS[VLM_ARCH]
    q = dataclasses.replace(full, n_layers=VLM_SERVE_LAYERS)
    counts = serve_model(
        torch, np, kernels, VLM_ARCH, q,
        f"published width, {q.n_layers} of its {full.n_layers} layers: d={q.d_model} "
        f"H={q.n_heads}/{q.n_kv_heads} hd={q.head_dim} ff={q.d_ff} V={q.vocab_size} "
        f"qkv bias, M-RoPE sections {q.mrope_sections}, prompt {q.n_patches} patches + "
        f"{LLM_PROMPT} tokens",
        lambda L, seg: {"flash_attention": L * seg,
                        "decode_attention": L * (LLM_GEN - 1) * seg},
        prompt_len=q.n_patches + LLM_PROMPT)
    launches[VLM_ARCH] = counts
    for name in ("flash_attention", "decode_attention", "bellman_banded"):
        rows[name]["launches_encdec_vlm_path"] = {a: c[name] for a, c in launches.items()}


def encdec_vlm_check(torch, np, kernels, arch, n_layers):
    """f32 at full width (``n_layers`` decoder layers), b 2: prefill and
    greedy decode through the kernels (launch counts exact), each position's
    logits held to a one-shot forward of the same tokens and frames /
    patches, then the same weights through the plain path on the card
    (logits and greedy tokens)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    c = ENCDEC_VLM_CHECK
    cfg = dataclasses.replace(ARCHS[arch], n_layers=n_layers)
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           torch.float32, "cuda")
    B, steps = c["batch"], c["steps"]
    P = c["prompt"] + cfg.n_patches
    toks = torch.randint(0, cfg.vocab_size, (B, P), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(3))
    extra = _extra_inputs(torch, cfg, B, torch.float32, 4)
    kernels.reset_launch_counts()
    got, got_toks = _greedy_logits(torch, M, cfg, params, toks, steps, P + steps, **extra)
    counts = kernels.launch_counts()
    per_layer = 2 if cfg.family == "encdec" else 1
    want_counts = {"flash_attention": cfg.n_encoder_layers + per_layer * cfg.n_layers,
                   "decode_attention": per_layer * cfg.n_layers * steps}
    check(all(counts[k] == n for k, n in want_counts.items()),
          f"{arch} kernel path launches {counts}, not {want_counts}")
    with torch.inference_mode():
        h, _ = M.forward(cfg, params, torch.cat([toks] + got_toks, dim=1), **extra)
        one = M._unembed(cfg, params, h[:, P - 1:])
    e_one = (got - one).abs().max().item()
    check(e_one <= LOGIT_ATOL, f"{arch} decode path vs one-shot: max abs err {e_one}")
    before = kernels.launch_counts()
    kernel_ops = L.ops
    L.ops = _PlainOps
    try:
        want, want_toks = _greedy_logits(torch, M, cfg, params, toks, steps, P + steps,
                                         **extra)
    finally:
        L.ops = kernel_ops
    check(kernels.launch_counts() == before, "the plain path launched a kernel")
    e = (got - want).abs().max().item()
    check(e <= LOGIT_ATOL and all(torch.equal(a, b) for a, b in zip(got_toks, want_toks)),
          f"{arch} kernel path vs plain path: max abs err {e}")
    depth = (f"{cfg.n_encoder_layers} + " if cfg.n_encoder_layers else "") + str(cfg.n_layers)
    log(f"{arch} f32 full width ({depth} layers, d={cfg.d_model}, H={cfg.n_heads}/"
        f"{cfg.n_kv_heads} x {cfg.head_dim}) b={B}, prompt {P} ({cfg.n_patches} patches) + {steps} decode "
        f"steps: decode path vs one-shot forward max_abs_err={e_one:.3e}, kernel path vs "
        f"plain path on the card max_abs_err={e:.3e} (atol {LOGIT_ATOL}), greedy tokens "
        f"equal; logit scale {got.abs().max().item():.3f}; kernel path launches flash "
        f"{counts['flash_attention']}, decode {counts['decode_attention']}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; ok")
    del params
    _free(torch, f"{arch} check model")


def encdec_vlm_phase(torch, np, kernels, rows):
    from repro_torch.configs import ARCHS

    t0 = time.perf_counter()
    encdec_vlm_kernel_rows(torch, np, rows)
    encdec_vlm_serve(torch, np, kernels, rows)
    encdec_vlm_check(torch, np, kernels, ENCDEC_ARCH, ARCHS[ENCDEC_ARCH].n_layers)
    encdec_vlm_check(torch, np, kernels, VLM_ARCH, VLM_CHECK_LAYERS)
    log(f"phase 4n (Whisper-small, Qwen2-VL-7B): {time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------------------
# Phase 4j: training on the card (examples/train_100m.py --full)
# ---------------------------------------------------------------------------

BWD_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
BWD_REPLACES = ("none: the gradient of the port's flash kernel "
                "(src/repro/kernels/flash_attention.py:72 has no backward; the JAX "
                "package trains through src/repro/models/layers.py:112 under jax.grad)")
#: f32 / bf16 bars of the backward kernel, of each gradient's largest |entry|
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: the training path's attention (qwen2.5-100m, b 8 x 256) and two other
#: models' heads at the same tokens: (B, S, H, KV, D, dtype)
BWD_PATH = (8, 256, 8, 4, 64, "float32")
BWD_OTHER = [(8, 256, 40, 8, 128, "bfloat16"), (8, 256, 32, 32, 64, "bfloat16")]
#: edge cases: (Sq, Sk) with Sq != Sk or lengths off the 64 / 32 tiles, G, D,
#: softcap, causal -- 120 cases, each in f32 and bf16 (G = 7 is Qwen2-VL's,
#: D = 256 Gemma2's)
BWD_EDGE_LENGTHS = [(100, 100), (70, 130)]
BWD_EDGE_G, BWD_EDGE_D, BWD_EDGE_CAP = (1, 2, 5, 7, 8), (64, 128, 256), (None, 30.0)
#: the first design's times at bwd_row's shapes, quoted in the log (not
#: measured in this run): an earlier run of this script on an NVIDIA H100
#: 80GB HBM3 at 700.00 W, as PERF.md records it
BWD_EARLIER_MS = {BWD_PATH: 0.194490, BWD_OTHER[0]: 1.474691, BWD_OTHER[1]: 0.471499}
#: the resume drill resumes the run's own step-TRAIN_RESUME checkpoint (a copy
#: of its directory without the later steps) and trains on to TRAIN_STEPS
#: (150 of the example's 300 steps, a cut for the time limit; a save every
#: 30 steps, the example's steps / 5)
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_RESUME = 150, 30, 120
TRAIN_PARITY = dict(layers=2, batch=2)  # full width, cut depth and batch (CPU side)
TRAIN_PROFILE_STEPS = 3


def grad_ms(torch, forward, inputs, grad_out, reps):
    """Device time of a backward alone: `forward()` runs once, then `reps`
    `autograd.grad(..., retain_graph=True)` calls are captured in one CUDA
    graph.  Autograd runs a backward on its forward's stream, so the
    forward runs on the capture stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.enable_grad():
        out = forward()
    return device_ms(
        torch, lambda: torch.autograd.grad(out, inputs, grad_out, retain_graph=True),
        reps, side)


def _held_to_max(torch, got, want, tol):
    """max |got - want| over max |want|, checked against tol."""
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return err, err <= tol * scale


def bwd_case(torch, np, gen, B, Sq, Sk, H, KV, D, dtype, causal, cap):
    """The backward kernel against its plain version on one input (unit
    normals from the card's generator ``gen``); returns the largest absolute
    error and the largest error relative to each gradient's largest
    |entry|."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb

    q, do = (torch.randn((B, Sq, H, D), generator=gen, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn((B, Sk, KV, D), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    out, lse = fa.flash_attention(q, k, v, causal=causal, softcap=cap, return_lse=True)
    got = fb.flash_attention_bwd(q, k, v, out, lse, do, causal=causal, softcap=cap)
    want = fb.flash_attention_bwd_ref(q, k, v, do, causal=causal, softcap=cap)
    torch.cuda.synchronize()
    dt = str(dtype).replace("torch.", "")
    worst, rel = 0.0, 0.0
    for name, g, w in zip("qkv", got, want):
        err, ok = _held_to_max(torch, g, w, BWD_TOL[dt])
        scale = w.float().abs().max().item()
        check(ok, f"flash_attention_bwd {(B, Sq, Sk, H, KV, D)} {dt} causal={causal} "
                  f"softcap={cap}: d{name} max abs err {err} over max |grad| {scale}")
        worst, rel = max(worst, err), max(rel, err / scale)
    return worst, rel


def bwd_row(torch, np, rng, B, S, H, KV, D, dt, reps=20):
    """The backward kernel timed at (B, S, H, KV, D), causal, beside the
    backward alone of its plain version (autograd through attention_ref)
    and of SDPA (enable_gqa), each on its own saved forward; and the
    forward kernel with lse plus the backward kernel.  All in CUDA graphs."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb

    F = torch.nn.functional
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dt]
    q, k, v = _flash_inputs(torch, rng, B, S, S, H, KV, D, dtype)
    do = _normal(torch, rng, (B, S, H, D), dtype)
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    ms = device_ms(torch, lambda: fb.flash_attention_bwd(q, k, v, out, lse, do), reps)

    def fwd_bwd():
        o, l_ = fa.flash_attention(q, k, v, return_lse=True)
        return fb.flash_attention_bwd(q, k, v, o, l_, do)

    both = device_ms(torch, fwd_bwd, reps)
    qq, kk, vv = (x.detach().requires_grad_(True) for x in (q, k, v))
    plain = grad_ms(torch, lambda: fa.attention_ref(qq, kk, vv), (qq, kk, vv), do, reps)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    lib = grad_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), (qt, kt, vt), do.transpose(1, 2), reps)
    pairs = S * (S + 1) // 2  # causal (q, k) pairs per head
    item = q.element_size()
    # bytes: q, k, v, out, dO and lse read once, dq, dk, dv written once;
    # operations: per pair the recomputed score, dP, dV, dK and dQ (2 D each)
    b_ms, b_by = bound(item * (4 * B * S * H * D + 4 * B * S * KV * D) + 4 * B * H * S,
                       10 * B * H * D * pairs,
                       BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
    earlier = BWD_EARLIER_MS[(B, S, H, KV, D, dt)]
    log(f"flash_attention_bwd b={B} {(S, H, KV, D)} {dt} causal: kernel_ms={ms:.6f} "
        f"bound_ms={b_ms:.6f} ({b_by}, {10 * B * H * D * pairs / 1e9:.3f} GFLOP); "
        f"backward alone: plain_ms={plain:.6f} (autograd through attention_ref), "
        f"library_ms={lib:.6f} (SDPA, enable_gqa); forward + backward kernels "
        f"{both:.6f} ms; the first design {earlier:.6f} ms (quoted from PERF.md, not "
        f"measured in this run; "
        f"{earlier / ms:.2f}x)")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                fwd_bwd_ms=both, shape=[B, S, S, H, KV, D], dtype=dt)


def bwd_kernel_checks(torch, np, rows):
    """The backward kernel against its plain version at the path's shape,
    at the two bf16 shapes and over the edge cases; then timed."""
    rng = np.random.default_rng(22)
    gen = torch.Generator(device="cuda").manual_seed(22)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    err, rel = dict.fromkeys(dts, 0.0), dict.fromkeys(dts, 0.0)
    t0 = time.perf_counter()
    for B, S, H, KV, D, dt in [BWD_PATH] + BWD_OTHER:
        e, r = bwd_case(torch, np, gen, B, S, S, H, KV, D, dts[dt], True, None)
        err[dt], rel[dt] = max(err[dt], e), max(rel[dt], r)
        log(f"flash_attention_bwd {(B, S, S, H, KV, D)} {dt} causal: max_abs_err={e:.3e}, "
            f"over max |grad| {r:.3e} (bar {BWD_TOL[dt]}) ok")
    n = 0
    for Sq, Sk in BWD_EDGE_LENGTHS:
        for G in BWD_EDGE_G:
            for D in BWD_EDGE_D:
                for cap in BWD_EDGE_CAP:
                    for causal in (True, False):
                        for dt, dtype in dts.items():
                            e, r = bwd_case(torch, np, gen, 2, Sq, Sk, 2 * G, 2, D,
                                            dtype, causal, cap)
                            err[dt], rel[dt] = max(err[dt], e), max(rel[dt], r)
                        n += 1
    log(f"flash_attention_bwd edge cases: {n} cases x (f32, bf16) (Sq, Sk) in "
        f"{BWD_EDGE_LENGTHS}, G in {BWD_EDGE_G}, D in {BWD_EDGE_D}, softcap "
        f"{BWD_EDGE_CAP}, causal on / off, all shapes: max_abs_err f32 "
        f"{err['float32']:.3e} bf16 {err['bfloat16']:.3e}; over max |grad| f32 "
        f"{rel['float32']:.3e} bf16 {rel['bfloat16']:.3e} ok "
        f"({time.perf_counter() - t0:.2f} s)")
    check(n >= 120, f"only {n} edge cases")
    main = bwd_row(torch, np, rng, *BWD_PATH)
    others = [bwd_row(torch, np, rng, *shape) for shape in BWD_OTHER]
    rows["flash_attention_bwd"] = dict(
        route="cuda", source=BWD_SOURCE, replaces=BWD_REPLACES, **main,
        max_abs_err=max(err.values()), max_abs_err_by_dtype=err,
        max_rel_err_by_dtype=rel, max_rel_err_is="of each gradient's largest |entry|",
        other_shapes=others)


def train_parity(torch, np):
    """qwen2.5-100m at full width, cut to TRAIN_PARITY's depth and batch:
    lm_loss gradients (remat) through the kernels on the card against the
    same weights through the plain versions on the CPU."""
    import copy

    from repro_torch import kernels
    from repro_torch.launch import train as T
    from repro_torch.models import model as M
    from repro_torch.training.data import DataConfig, batch_at_step

    cfg = dataclasses.replace(T.example_config(True), n_layers=TRAIN_PARITY["layers"])
    cpu = M.init_params(cfg, torch.Generator().manual_seed(5), torch.float32, "cpu")
    card = copy.deepcopy(cpu).to("cuda").trainable()
    cpu.trainable()
    data = DataConfig(cfg.vocab_size, 256, TRAIN_PARITY["batch"], seed=17)
    toks = batch_at_step(data, 0, device="cpu")["tokens"]
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    loss_c = M.lm_loss(cfg, card, {"tokens": toks.cuda()}, remat=True)
    g_card = torch.autograd.grad(loss_c, list(card.parameters()))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    loss_p = M.lm_loss(cfg, cpu, {"tokens": toks}, remat=True)
    g_cpu = torch.autograd.grad(loss_p, list(cpu.parameters()))
    check(counts["flash_attention"] == 2 * cfg.n_layers
          and counts["flash_attention_bwd"] == cfg.n_layers,
          f"parity launches {counts['flash_attention']} / {counts['flash_attention_bwd']}")
    check(abs(loss_c.item() - loss_p.item()) <= 1e-5 * abs(loss_p.item()),
          f"loss card {loss_c.item()} cpu {loss_p.item()}")
    worst = (0.0, "")
    for (name, _), g, w in zip(cpu.named_parameters(), g_card, g_cpu):
        e, ok = _held_to_max(torch, g.cpu(), w, 1e-4)
        rel = e / w.abs().max().item()
        check(ok, f"gradient {name}: card vs CPU max err {e} (rel {rel})")
        worst = max(worst, (rel, name))
    log(f"training parity ({cfg.name} full width, {cfg.n_layers} layers, "
        f"{TRAIN_PARITY['batch']} x 256, f32): loss card {loss_c.item():.7f} cpu "
        f"{loss_p.item():.7f}; every gradient within 1e-4 of its largest |entry| "
        f"(worst {worst[0]:.3e}, {worst[1]}); launches flash {counts['flash_attention']} "
        f"bwd {counts['flash_attention_bwd']} ({time.perf_counter() - t0:.2f} s)")


def train_run(torch, np, kernels, rows, workdir):
    """examples/train_100m.py --full on the card, then the resume drill."""
    from repro_torch.launch import train as T
    from repro_torch.training.data import batch_at_step

    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "TF32 is on: training in f32 must run in IEEE f32")
    lines = []
    note = lines.append

    def trainer(steps, d):
        return T.example_trainer(True, steps=steps, ckpt_every=TRAIN_CKPT_EVERY,
                                 ckpt_dir=os.path.join(workdir, d), log_fn=note,
                                 device="cuda")

    t_a = trainer(TRAIN_STEPS, "a")
    cfg, data = t_a.cfg, t_a.data
    n_params = cfg.n_params()
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    p_a, opt_a, losses_a = t_a.run(seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    L = cfg.n_layers
    check(counts["flash_attention"] == 2 * L * TRAIN_STEPS,
          f"flash_attention launched {counts['flash_attention']} times, not 2 x {L} x "
          f"{TRAIN_STEPS} (forward and its recompute)")
    check(counts["flash_attention_bwd"] == L * TRAIN_STEPS,
          f"flash_attention_bwd called {counts['flash_attention_bwd']} times, not "
          f"{L} x {TRAIN_STEPS}")
    for name in ("dot", "dkdv", "dq"):
        check(counts[f"flash_attention_bwd:{name}"] == L * TRAIN_STEPS,
              f"bwd kernel {name}: {counts[f'flash_attention_bwd:{name}']} launches")
    others = {k: v for k, v in counts.items() if v and not k.startswith("flash_attention")}
    check(not others, f"training launched other kernels: {others}")
    check(all(np.isfinite(losses_a)) and len(losses_a) == TRAIN_STEPS, "losses finite")
    first, last = float(np.mean(losses_a[:10])), float(np.mean(losses_a[-10:]))
    check(last < first, f"loss did not fall: {first} -> {last}")
    tokens = data.global_batch * data.seq_len
    step_ms = 1e3 * float(np.median(t_a.step_times))
    log(f"train {cfg.name} (~{n_params / 1e6:.1f}M params, f32, AdamW lr 6e-4, data "
        f"seed 17): {TRAIN_STEPS} steps of {data.global_batch} x {data.seq_len}, a "
        f"checkpoint every {TRAIN_CKPT_EVERY}: loss {losses_a[0]:.4f} -> {losses_a[-1]:.4f} "
        f"(first 10 mean {first:.4f}, last 10 mean {last:.4f}); wall {wall:.2f} s, "
        f"median step {step_ms:.3f} ms, {tokens * TRAIN_STEPS / wall:.0f} tokens/s over the "
        f"run ({tokens / step_ms * 1e3:.0f} at the median step); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"train launches: flash_attention {counts['flash_attention']} (2 x {L} a step), "
        f"flash_attention_bwd {counts['flash_attention_bwd']} calls ({L} a step) of 3 "
        f"kernels each")
    for msg in lines:
        if msg.startswith("[trainer] step") and int(msg.split()[2]) % 50 == 0:
            log(f"  {msg}")
    del lines[:]

    # --- the resume drill: a fresh Trainer on the run's step-120 checkpoint --
    t0 = time.perf_counter()
    src, dst = os.path.join(workdir, "a"), os.path.join(workdir, "b")
    later = [d for d in os.listdir(src) if d.startswith("step_") and not d.endswith(".tmp")
             and int(d[5:]) > TRAIN_RESUME]
    check(f"step_{TRAIN_RESUME:010d}" in os.listdir(src),
          f"the run kept no step-{TRAIN_RESUME} checkpoint: {sorted(os.listdir(src))}")
    shutil.copytree(src, dst, ignore=lambda _, names: [n for n in names if n in later])
    t_res = trainer(TRAIN_STEPS, "b")
    p_b, opt_b, losses_b = t_res.run(seed=0)
    torch.cuda.synchronize()
    check(len(losses_b) == TRAIN_STEPS - TRAIN_RESUME and int(opt_b["step"]) == TRAIN_STEPS,
          "the resumed run did not start at the checkpoint")
    a, b = np.asarray(losses_a[TRAIN_RESUME:]), np.asarray(losses_b)
    loss_rel = float(np.max(np.abs(a - b) / np.abs(a)))
    check(np.allclose(b, a, rtol=1e-6, atol=0), f"resumed losses differ: {loss_rel}")
    p_err, bitwise = 0.0, True
    for (n, x), y in zip(p_a.named_parameters(), p_b.parameters()):
        p_err = max(p_err, (x - y).abs().max().item())
        bitwise &= bool(torch.equal(x, y))
    check(p_err <= 1e-6, f"resumed parameters differ by {p_err}")
    check(any("resumed from step" in m for m in lines), "the second Trainer did not resume")
    log(f"resume drill: a fresh Trainer on a copy of the run's directory cut back to its "
        f"step-{TRAIN_RESUME} checkpoint, resumed to {TRAIN_STEPS}: losses max rel diff "
        f"{loss_rel:.3e} (bar 1e-6), parameters max abs diff {p_err:.3e} (bar 1e-6), "
        f"bitwise equal {bitwise} "
        f"({time.perf_counter() - t0:.2f} s)")

    # --- where a step's time goes (after the comparisons) --------------------
    batch = batch_at_step(data, 0, device="cuda")
    state = {"p": p_a, "o": opt_a}

    def steps():
        for _ in range(TRAIN_PROFILE_STEPS):
            state["p"], state["o"], m = t_a.step_fn(state["p"], state["o"], batch)
        m["loss"].item()

    steps()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps()
    wall_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_PROFILE_STEPS
    dev_ms, launches, by_name = profile_busy(torch, steps)
    if dev_ms is None:
        log("profile train step: the profiler recorded no device time (not measured)")
        busy = None
    else:
        total = dev_ms / TRAIN_PROFILE_STEPS
        busy = total / wall_ms
        groups = {"flash fwd kernel": 0.0, "flash bwd kernels": 0.0, "matmul (cuBLAS)": 0.0,
                  "other": 0.0}
        for key, (ms, _) in by_name.items():
            low = key.lower()
            if "flash_fwd" in low:
                g = "flash fwd kernel"
            elif "bwd_d" in low:
                g = "flash bwd kernels"
            elif any(w in low for w in ("nvjet", "gemm", "gemv", "cutlass", "xmma", "sm90")):
                g = "matmul (cuBLAS)"
            else:
                g = "other"
            groups[g] += ms / TRAIN_PROFILE_STEPS
        log(f"profile train step (b {data.global_batch} x {data.seq_len}): wall_ms="
            f"{wall_ms:.3f} per step unprofiled, device busy {total:.3f} ms per step "
            f"(busy share {busy:.3f}) in {launches / TRAIN_PROFILE_STEPS:.0f} kernels per "
            f"step; " + "; ".join(f"{k} {v:.3f} ms (share {v / total:.4f})"
                                  for k, v in groups.items()))
        for key, (ms, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
            log(f"  {ms / TRAIN_PROFILE_STEPS:9.4f} ms/step "
                f"{cnt // TRAIN_PROFILE_STEPS:5d} calls/step  {key[:90]}")
    rows["flash_attention_bwd"].update(
        launches=counts["flash_attention_bwd"], launches_per_step=L,
        kernel_launches_per_call=3,
        launches_by_kernel={k: counts[f"flash_attention_bwd:{k}"] for k in ("dot", "dkdv", "dq")})
    rows["flash_attention"]["launches_training_path"] = counts["flash_attention"]
    rows["flash_attention_bwd"]["training"] = dict(
        steps=TRAIN_STEPS, loss_first=losses_a[0], loss_last=losses_a[-1],
        step_ms_median=step_ms, tokens_per_s=tokens * TRAIN_STEPS / wall, busy_share=busy)


def train_phase(torch, np, kernels, rows):
    t0 = time.perf_counter()
    bwd_kernel_checks(torch, np, rows)
    train_parity(torch, np)
    workdir = tempfile.mkdtemp(prefix="train_100m_")
    try:
        train_run(torch, np, kernels, rows, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"phase 4j (training): {time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------------------
# Phase 4o: training through the masked and cross attention (Whisper-small,
# Qwen2-VL-7B, Gemma2, Llama-4 Scout, Grok-1)
# ---------------------------------------------------------------------------

#: the masked backward kernel's edge cases, each in f32 and bf16 at B = 2,
#: KV = 2, H = 2 G: every (window, chunk) below x (Sq, Sk) x G x D x softcap
#: x causal (864 cases); (130, 70) has rows that see no key under causal or
#: a chunk, a window or a chunk of 1 leaves every row one key
BWD_MASKS = [(1, None), (16, None), (100, None), (None, 1), (None, 16), (None, 64)]
BWD_MASKED_LENGTHS = [(100, 100), (70, 130), (130, 70)]
BWD_MASKED_G, BWD_MASKED_D, BWD_MASKED_CAP = (1, 2, 5, 7), (64, 128, 256), (None, 30.0)
#: the training paths' attention, timed in bf16: (what, B, Sq, Sk, H, KV, D,
#: causal, softcap, window, chunk, K / V views of one projection)
BWD_TRAIN_ROWS = [
    ("gemma2-9b local", 1, 8192, 8192, 16, 8, 256, True, 50.0, 4096, None, False),
    ("llama4-scout chunked", 1, 9216, 9216, 40, 8, 128, True, None, None, 8192, False),
    ("whisper-small encoder", 8, 1500, 1500, 12, 12, 64, False, None, None, None, False),
    ("whisper-small cross", 8, 128, 1500, 12, 12, 64, False, None, None, None, True),
    ("qwen2-vl-7b", 8, 384, 384, 28, 4, 128, True, None, None, None, False),
]
#: above this many bytes of f32 scores the plain version runs one kv-head
#: group at a time (its autograd keeps several (B, H, Sq, Sk) tensors)
PLAIN_SCORES_BYTES = 4e9
#: full-width training parity, card against CPU, f32: (arch, layers (None:
#: all), batch, text tokens, the card work its CPU side runs beside (None:
#: none; masked_train_phase)); Qwen2-VL's 256 stub patches come before its
#: text, Whisper's 1500 stub frames go through its encoder.  The reduced
#: configs' parity is tests/test_torch_cuda.py's
FAMILY_PARITY = [("whisper-small", None, 2, 64, "edges"), ("qwen2-vl-7b", 2, 2, 64, "timed"),
                 ("llama4-scout-17b-a16e", 1, 2, 64, "train"), ("gemma2-9b", 2, 2, 64, None)]
#: Whisper-small whole, trained on the card with AdamW: steps of batch x
#: seq tokens, each sequence with 1500 stub frames drawn from the step's seed
WHISPER_TRAIN = dict(steps=40, batch=8, seq=128, lr=6e-4, data_seed=17)


def _attention_calls(cfg):
    """Attention calls of one forward: a layer's self-attention, and for the
    encoder-decoder its encoder layers and each decoder layer's cross."""
    if cfg.family == "encdec":
        return cfg.n_encoder_layers + 2 * cfg.n_layers
    return cfg.n_layers


def bwd_masked_edges(torch):
    """The masked backward kernel against its plain version over the
    BWD_MASK* cases in both dtypes, one host read a case; returns (cases,
    {dtype: [max abs err, max err over its gradient's largest |entry|]}).
    A window or a chunk of 1 leaves every row one key, and softmax over one
    key has no gradient: dq and dk are exactly zero in the plain version and
    rounding noise in the kernel's p (dp - Dv), so a gradient whose largest
    |entry| is 0 is held at the largest |entry| of the three."""
    import itertools

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb

    gen = torch.Generator(device="cuda").manual_seed(31)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    worst = {dt: [0.0, 0.0] for dt in dts}
    t0 = time.perf_counter()
    cases = list(itertools.product(BWD_MASKS, BWD_MASKED_LENGTHS, BWD_MASKED_G, BWD_MASKED_D,
                                   BWD_MASKED_CAP, (True, False)))
    for (window, chunk), (Sq, Sk), G, D, cap, causal in cases:
        mask = dict(causal=causal, softcap=cap, window=window, chunk=chunk)
        for dt, dtype in dts.items():
            q, do = (torch.randn((2, Sq, 2 * G, D), generator=gen, device="cuda").to(dtype)
                     for _ in range(2))
            k, v = (torch.randn((2, Sk, 2, D), generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
            out, lse = fa.flash_attention(q, k, v, return_lse=True, **mask)
            got = fb.flash_attention_bwd(q, k, v, out, lse, do, **mask)
            want = fb.flash_attention_bwd_ref(q, k, v, do, **mask)
            stats = torch.stack([t for g, w in zip(got, want) for t in (
                (g.float() - w.float()).abs().max(), w.float().abs().max())]).tolist()
            top = max(stats[1::2])
            for name, e, s in zip("qkv", stats[0::2], stats[1::2]):
                s = s or top
                check(e <= BWD_TOL[dt] * s,
                      f"flash_attention_bwd masked edge (2, {Sq}, {Sk}, {2 * G}, 2, {D}) {dt} "
                      f"causal={causal} window={window} chunk={chunk} softcap={cap}: d{name} "
                      f"max abs err {e} over {s}")
                worst[dt] = [max(worst[dt][0], e), max(worst[dt][1], e / s)]
    log(f"flash_attention_bwd masked edge cases: {len(cases)} cases x (f32, bf16): (window, "
        f"chunk) in {BWD_MASKS}, (Sq, Sk) in {BWD_MASKED_LENGTHS}, G in {BWD_MASKED_G}, D in "
        f"{BWD_MASKED_D}, softcap {BWD_MASKED_CAP}, causal on / off: max_abs_err f32 "
        f"{worst['float32'][0]:.3e} bf16 {worst['bfloat16'][0]:.3e}; over max |grad| f32 "
        f"{worst['float32'][1]:.3e} bf16 {worst['bfloat16'][1]:.3e} (bars {BWD_TOL}) ok "
        f"({time.perf_counter() - t0:.2f} s)")
    return len(cases), worst


def plain_bwd(torch, q, k, v, do, mask):
    """The plain backward (autograd through attention_ref) on q, k, v,
    one kv-head group at a time when the scores exceed PLAIN_SCORES_BYTES:
    returns ((dq, dk, dv), ms of the backward alone -- CUDA events around
    one autograd.grad a group after a warm-up one, summed)."""
    from repro_torch.kernels import flash_attention as fa

    B, Sq, H = q.shape[:3]
    Sk, KV = k.shape[1], k.shape[2]
    n = KV if 4 * B * H * Sq * Sk > PLAIN_SCORES_BYTES else 1
    G, KG = H // n, KV // n
    parts, ms = [], 0.0
    for i in range(n):
        ins = [x[:, :, j * s:(j + 1) * s].detach().requires_grad_(True)
               for x, j, s in ((q, i, G), (k, i, KG), (v, i, KG))]
        dog = do[:, :, i * G:(i + 1) * G]
        with torch.enable_grad():
            out = fa.attention_ref(*ins, **mask)
            torch.autograd.grad(out, ins, dog, retain_graph=True)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            grads = torch.autograd.grad(out, ins, dog)
            end.record()
        end.synchronize()
        ms += start.elapsed_time(end)
        parts.append(grads)
        del out
    grads = tuple(torch.cat([p[j] for p in parts], dim=2) for j in range(3))
    return grads, ms


def bwd_train_row(torch, what, B, Sq, Sk, H, KV, D, causal, cap, window, chunk, fused):
    """The backward kernel at a training path's shape in bf16: held against
    its plain version (2e-2 of each gradient's largest |entry|; over 1500
    keys also ATTN_REL_BF16 in relative L2 norm), timed in a CUDA graph of
    back-to-back calls beside the plain backward, SDPA's backward alone
    (the boolean mask under a window or a chunk, no cap) and the bound of
    the visible pairs."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb

    t0 = time.perf_counter()
    F = torch.nn.functional
    dtype = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(Sq + Sk + H)
    q, do = (torch.randn((B, Sq, H, D), generator=gen, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (_fused_kv(torch, gen, B, Sk, KV, D, dtype) if fused else
            [torch.randn((B, Sk, KV, D), generator=gen, device="cuda").to(dtype)
             for _ in range(2)])
    mask = dict(causal=causal, softcap=cap, window=window, chunk=chunk)
    shape = (B, Sq, Sk, H, KV, D)
    desc = (f"{what} {shape} causal={causal} window={window} chunk={chunk} softcap={cap}"
            + (f" K / V views, row stride {k.stride(1)}" if fused else ""))
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **mask)
    got = fb.flash_attention_bwd(q, k, v, out, lse, do, **mask)
    want, plain = plain_bwd(torch, q, k, v, do, mask)
    rel_l2 = []
    for name, g, w in zip("qkv", got, want):
        e, ok = _held_to_max(torch, g, w, BWD_TOL["bfloat16"])
        check(ok, f"flash_attention_bwd {desc} bfloat16: d{name} max abs err {e}")
        if Sk == CROSS_KEYS:
            r = (torch.linalg.vector_norm(g.float() - w.float())
                 / torch.linalg.vector_norm(w.float())).item()
            check(r <= ATTN_REL_BF16, f"flash_attention_bwd {desc}: d{name} relative L2 {r}")
            rel_l2.append(r)
    err = max(_held_to_max(torch, g, w, 1.0)[0] for g, w in zip(got, want))
    del got, want
    torch.cuda.empty_cache()
    reps = 3 if Sq * Sk > 10 ** 7 else 20
    ms = device_ms(torch, lambda: fb.flash_attention_bwd(q, k, v, out, lse, do, **mask), reps)
    keep = fa.visible(torch.arange(Sq, device="cuda") + (Sk - Sq),
                      torch.arange(Sk, device="cuda"), causal=causal, window=window, chunk=chunk)
    pairs = int(keep.sum().item())
    if window is None and chunk is None:
        how, sdpa_mask = ("is_causal" if causal else "no mask"), dict(is_causal=causal)
    else:
        how, sdpa_mask = "boolean mask", dict(attn_mask=keep)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    try:
        sdpa = grad_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True, **sdpa_mask), (qt, kt, vt), do.transpose(1, 2),
            min(reps, 5))
    except torch.cuda.OutOfMemoryError:  # a yardstick only: no such call then
        sdpa = None
        torch.cuda.empty_cache()
    lib, note = (None, "library_ms=None (SDPA's backward ran out of memory)") if sdpa is None \
        else _sdpa_note(sdpa, cap, how)
    del keep, sdpa_mask, qt, kt, vt
    torch.cuda.empty_cache()
    # bytes: q, out, dO, dq and k, v, dk, dv once, lse read; operations: the
    # recomputed score, dP, dV, dK and dQ (2 D each) per visible pair a head
    b_ms, b_by = bound(2 * (4 * B * Sq * H * D + 4 * B * Sk * KV * D) + 4 * B * H * Sq,
                       10 * B * H * D * pairs, BF16_FLOPS)
    log(f"flash_attention_bwd {desc} bfloat16: kernel_ms={ms:.6f} plain_ms={plain:.6f} "
        f"(autograd through attention_ref, backward alone"
        f"{', a kv-head group at a time' if 4 * B * H * Sq * Sk > PLAIN_SCORES_BYTES else ''}) "
        f"{note.replace('SDPA', 'SDPA backward')} bound_ms={b_ms:.6f} ({b_by}; {pairs} "
        f"visible pairs a head); max_abs_err={err:.3e}"
        + (f", rel_l2_err dq / dk / dv {', '.join(f'{r:.3e}' for r in rel_l2)} (bar "
           f"{ATTN_REL_BF16})" if rel_l2 else "") + f" ok ({time.perf_counter() - t0:.2f} s)")
    return dict(what=what, ms=ms, plain_ms=plain, library_ms=lib, sdpa_mask_ms=sdpa,
                bound_ms=b_ms, bound_by=b_by, shape=list(shape), causal=causal, window=window,
                chunk=chunk, softcap=cap, dtype="bfloat16", visible_pairs=pairs,
                max_abs_err=err, rel_l2_err=rel_l2 or None)


class Parity:
    """lm_loss with remat and its gradients through the kernels on the card,
    against the same weights through the plain versions on the CPU: the
    card's side runs in ``__init__``, the CPU's in ``cpu_side`` (on a worker
    thread, while the card does other work), ``finish`` compares -- loss at
    rtol 1e-5, every gradient within 1e-4 of its largest |entry| (on the
    card, a CPU gradient copied up at a time) -- and checks the attention
    launches (the forward twice a call, the backward's three kernels once)
    and that nothing else launched.  The CPU runs without remat: a
    recompute there changes no bit of the gradients and costs a quarter
    more work."""

    def __init__(self, torch, kernels, cfg, card, cpu, batch, what):
        from repro_torch.models import model as M

        self.torch, self.cfg, self.cpu, self.what = torch, cfg, cpu, what
        self.batch_cpu = {n: x.cpu() for n, x in batch.items()}
        t0 = time.perf_counter()
        kernels.reset_launch_counts()
        self.loss_c = M.lm_loss(cfg, card, batch, remat=True)
        self.g_card = torch.autograd.grad(self.loss_c, list(card.parameters()))
        torch.cuda.synchronize()
        self.counts = kernels.launch_counts()
        self.card_s = time.perf_counter() - t0

    def cpu_side(self):
        from repro_torch.models import model as M

        t0 = time.perf_counter()
        self.loss_p = M.lm_loss(self.cfg, self.cpu, self.batch_cpu, remat=False)
        self.g_cpu = self.torch.autograd.grad(self.loss_p, list(self.cpu.parameters()))
        self.cpu_s = time.perf_counter() - t0

    def finish(self):
        torch, what = self.torch, self.what
        t0 = time.perf_counter()
        calls = _attention_calls(self.cfg)
        want = {"flash_attention": 2 * calls, "flash_attention_bwd": calls,
                **{f"flash_attention_bwd:{k}": calls for k in ("dot", "dkdv", "dq")}}
        counts = self.counts
        check(all(counts[k] == n for k, n in want.items()),
              f"{what} parity launches {counts}, not {want}")
        others = {k: n for k, n in counts.items() if n and k not in want}
        check(not others, f"{what} training launched other kernels: {others}")
        lc, lp = self.loss_c.item(), self.loss_p.item()
        check(abs(lc - lp) <= 1e-5 * abs(lp), f"{what} loss card {lc} cpu {lp}")
        worst = (0.0, "")
        for (name, _), g, w in zip(self.cpu.named_parameters(), self.g_card, self.g_cpu):
            e, scale = torch.stack(_err_and_scale(torch, g, w.to(g.device))).tolist()
            check(e <= 1e-4 * scale, f"{what} gradient {name}: card vs CPU max err {e} over "
                                     f"{scale}")
            worst = max(worst, (e / scale if scale else 0.0, name))
        log(f"training parity {what}: loss card {lc:.7f} cpu {lp:.7f}; every gradient within "
            f"1e-4 of its largest |entry| (worst {worst[0]:.3e}, {worst[1]}); launches flash "
            f"{counts['flash_attention']} bwd {counts['flash_attention_bwd']} ({calls} "
            f"attention call{'s' * (calls > 1)} a forward); card {self.card_s:.2f} s, CPU "
            f"{self.cpu_s:.2f} s, compared in {time.perf_counter() - t0:.2f} s")
        return {k: counts[k] for k in want}


def _err_and_scale(torch, got, want):
    """(max |got - want|, max |want|) as two tensors on got's device."""
    inf = float("inf")
    return (torch.linalg.vector_norm(got.float() - want.float(), inf),
            torch.linalg.vector_norm(want.float(), inf))


def parity_start(torch, kernels, arch, cfg, B, n_text, seed):
    """Draw cfg's weights on the card (f32), copy them to the CPU, and run the
    card's side of a Parity on B x (n_patches + n_text) tokens (and the
    family's stub frames / patches)."""
    import copy

    from repro_torch.configs import ARCHS
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    card = M.init_params(cfg, gen, torch.float32, "cuda")
    cpu = copy.deepcopy(card).to("cpu").trainable()
    card.trainable()
    S = cfg.n_patches + n_text
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda"),
             **_extra_inputs(torch, cfg, B, torch.float32, seed + 1)}
    n_params = sum(p.numel() for p in card.parameters())
    copy_s = time.perf_counter() - t0
    full = ARCHS[arch]
    what = (f"{cfg.name} ({cfg.n_layers} of {full.n_layers} layers"
            + (f" + {cfg.n_encoder_layers} encoder" if cfg.family == "encdec" else "")
            + f", {n_params / 1e9:.3f} B params, b {B} x {S} tokens"
            + (f" ({cfg.n_patches} patches)" if cfg.n_patches else "")
            + (f" + {cfg.encoder_len} frames" if cfg.family == "encdec" else "")
            + f", window {cfg.sliding_window} chunk {cfg.chunk_size}, f32; init and copy "
              f"{copy_s:.2f} s)")
    return Parity(torch, kernels, cfg, card, cpu, batch, what)


def whisper_train_run(torch, np, kernels):
    """Whisper-small whole trained on the card: make_train_step with AdamW
    and remat, WHISPER_TRAIN's steps of data-pipeline tokens with stub
    frames; the loss must fall (last-10 mean below first-10 mean), the
    launches exact, TF32 off."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import model as M
    from repro_torch.training.data import DataConfig, batch_at_step
    from repro_torch.training.optimizer import AdamWConfig, opt_init
    from repro_torch.training.train_step import make_train_step

    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "TF32 is on: training in f32 must run in IEEE f32")
    w = WHISPER_TRAIN
    cfg = ARCHS["whisper-small"]
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(9), torch.float32,
                           "cuda").trainable()
    opt = AdamWConfig(lr=w["lr"])
    state = opt_init(params, opt)
    step = make_train_step(cfg, opt, remat=True)
    data = DataConfig(cfg.vocab_size, w["seq"], w["batch"], seed=w["data_seed"])
    frames = torch.Generator(device="cuda")
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    t0 = time.perf_counter()
    for i in range(w["steps"]):
        batch = batch_at_step(data, i, device="cuda")
        frames.manual_seed(1000 + i)
        batch["frames"] = torch.randn((w["batch"], cfg.encoder_len, cfg.d_model),
                                      generator=frames, device="cuda")
        t1 = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))  # waits for the step
        times.append(time.perf_counter() - t1)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    calls = _attention_calls(cfg) * w["steps"]
    want = {"flash_attention": 2 * calls, "flash_attention_bwd": calls,
            **{f"flash_attention_bwd:{k}": calls for k in ("dot", "dkdv", "dq")}}
    check(all(counts[k] == n for k, n in want.items()),
          f"whisper training launches {counts}, not {want}")
    others = {k: n for k, n in counts.items() if n and k not in want}
    check(not others, f"whisper training launched other kernels: {others}")
    check(all(np.isfinite(losses)), "whisper training losses finite")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    check(last < first, f"whisper training loss did not fall: {first} -> {last}")
    step_ms = 1e3 * float(np.median(times))
    tokens = w["batch"] * w["seq"]
    log(f"train whisper-small whole ({cfg.n_encoder_layers} + {cfg.n_layers} layers, f32, "
        f"AdamW lr {w['lr']}, remat): "
        f"{w['steps']} steps of {w['batch']} x {w['seq']} tokens + {w['batch']} x "
        f"{cfg.encoder_len} stub frames: loss {losses[0]:.4f} -> {losses[-1]:.4f} (first 10 "
        f"mean {first:.4f}, last 10 mean {last:.4f}); wall {wall:.2f} s, median step "
        f"{step_ms:.3f} ms, {tokens / step_ms * 1e3:.0f} tokens/s and "
        f"{w['batch'] * cfg.encoder_len / step_ms * 1e3:.0f} frames/s at the median step on "
        f"{CARD[0]}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
        f"launches flash {counts['flash_attention']} bwd {counts['flash_attention_bwd']} "
        f"({_attention_calls(cfg)} attention calls a forward)")
    del params, state
    torch.cuda.empty_cache()
    return dict(steps=w["steps"], loss_first=losses[0], loss_last=losses[-1],
                step_ms_median=step_ms, tokens_per_s=tokens / step_ms * 1e3,
                launches={k: counts[k] for k in want})


def masked_train_phase(torch, np, kernels, rows):
    """Phase 4o.  The full-width parity's CPU sides run on a worker thread,
    one at a time, each beside a piece of card work: the edge cases, the
    timed rows, the Whisper training run."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs import ARCHS

    t0 = time.perf_counter()
    out, launches = {}, {}
    card_work = {"edges": lambda: bwd_masked_edges(torch),
                 "timed": lambda: [bwd_train_row(torch, *r) for r in BWD_TRAIN_ROWS],
                 "train": lambda: whisper_train_run(torch, np, kernels)}
    check(sorted(w for *_, w in FAMILY_PARITY if w) == sorted(card_work),
          "each piece of phase 4o's card work runs beside one parity's CPU side")
    with ThreadPoolExecutor(1) as pool:
        for i, (arch, layers, B, n_text, name) in enumerate(FAMILY_PARITY):
            cfg = ARCHS[arch] if layers is None else dataclasses.replace(ARCHS[arch],
                                                                         n_layers=layers)
            par = parity_start(torch, kernels, arch, cfg, B, n_text, 5 + i)
            job = pool.submit(par.cpu_side)
            if name:
                t1 = time.perf_counter()
                out[name] = card_work[name]()
                log(f"phase 4o {name}: {time.perf_counter() - t1:.2f} s (beside the CPU side "
                    f"of {arch}'s parity)")
            job.result()
            launches[arch] = par.finish()
            del par
            torch.cuda.empty_cache()
    (n, worst), timed, run = out["edges"], out["timed"], out["train"]
    row = rows["flash_attention_bwd"]
    row["max_abs_err"] = max([row["max_abs_err"]] + [w[0] for w in worst.values()]
                             + [t["max_abs_err"] for t in timed])
    row.update(masked_shapes=timed, masked_edge_cases=dict(
        cases=n, dtypes=2, max_abs_err={dt: w[0] for dt, w in worst.items()},
        max_rel_err={dt: w[1] for dt, w in worst.items()}),
        launches_training_families=launches, whisper_training=run)
    log(f"phase 4o (training through the masked and cross attention): "
        f"{time.perf_counter() - t0:.2f} s")


PHASE_WALLS = {}


def mark(name, t0):
    """Keep and log the wall time of the phase that started at ``t0``."""
    PHASE_WALLS[name] = time.perf_counter() - t0
    log(f"phase {name}: wall {PHASE_WALLS[name]:.2f} s on {CARD[0]}")


def main():
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch import kernels
    from repro_torch.kernels import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    CARD.append(card)
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mark("0 start-up", t_start)
    t0 = time.perf_counter()
    empty = start_empty_build()
    build_s = _build.build_all()
    EMPTY_LAUNCH.append(finish_empty_build(empty))
    log(f"kernel build: {build_s:.2f} s (and the launch-floor kernel)")
    for name, text in sorted(_build.build_logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    for name in ("fleet_scan", "sim_scan"):
        SASS[name] = sass_counts(name)
        for fn, n in sorted(SASS[name].items()):
            log(f"  {name}: {n} SASS instructions in {fn}")
    mark("1 build", t0)

    t0 = time.perf_counter()
    rows = kernel_phase(torch, np)
    mark("2 kernels", t0)

    # --- the main path, counters zeroed just before and read just after ---
    from repro_torch.core import GOOGLENET_P4_ENERGY
    from repro_torch.serving import ServingEngine, SMDPScheduler

    energy = np.array([0.0] + [float(GOOGLENET_P4_ENERGY(b)) for b in range(1, B_MAX + 1)])
    spec = table1_spec(RHO)
    from repro_torch.core import solve

    t_main = time.perf_counter()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = solve(spec, backup="pallas", device="cuda")
    solve_s = time.perf_counter() - t0
    eng = ServingEngine(SMDPScheduler(res), lam=spec.lam, b_max=B_MAX, service=spec.service,
                        energy_table=energy, seed=0, device="cuda")
    t0 = time.perf_counter()
    rep = eng.run(N_EPOCHS, backend="compiled")
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    log(f"main path launches: {counts}")
    check(counts["bellman_banded"] == res.rvi.iterations + 1,
          "solve did not run one Bellman kernel launch per backup")
    check(counts["serve_scan"] > 0, "serving did not launch the event kernel")
    for name in ("bellman_banded", "serve_scan"):
        rows[name]["launches"] = counts[name]
    rows["bellman_banded_batched"]["launches"] = counts["bellman_banded_batched"]
    log(f"main path solve: s_max={res.spec.s_max} iterations={res.rvi.iterations} "
        f"g={res.rvi.g:.6f} W={res.eval.w_bar:.4f} ms P={res.eval.p_bar:.4f} W "
        f"wall_s={solve_s:.3f} rvi_s={res.rvi.wall_time_s:.3f}")
    p50, p95, p99 = rep.percentile([50, 95, 99])
    m = rep.metrics
    log(f"main path serve ({N_EPOCHS} epochs, {rep.n_served} requests): "
        f"W={rep.latencies.mean():.4f} ms P={rep.power:.4f} W P50={p50:.3f} P95={p95:.3f} "
        f"P99={p99:.3f} (sketch {m['P50']:.3f}/{m['P95']:.3f}/{m['P99']:.3f}) "
        f"mean_batch={rep.mean_batch:.3f} wall_s={serve_s:.3f}")
    check(len(rep.batch_sizes) > 0 and np.isfinite(rep.latencies).all(), "serve output")
    check(abs(rep.latencies.mean() - res.eval.w_bar) < 0.05 * res.eval.w_bar,
          "served mean latency far from the analytic W")
    check(abs(rep.power - res.eval.p_bar) < 0.05 * res.eval.p_bar,
          "served power far from the analytic P")
    serve_scan_row(torch, np, res.action_table(), energy, rows["serve_scan"])
    mark("3 main path", t_main)

    # --- checks beside the main path ---------------------------------------
    t_checks = time.perf_counter()
    warm, _ = solve_checked(np, kernels, RHO)
    profile_solve(torch, spec, warm.rvi.wall_time_s)
    solve_checked(np, kernels, 0.9)
    from repro_torch.serving import verify_backends

    # long enough that the epoch budget, not the trace, ends the run
    trace = np.cumsum(np.random.default_rng(2).exponential(1.0 / spec.lam, 5 * N_EPOCHS))
    t0 = time.perf_counter()
    out = verify_backends(res.action_table(), trace, service=spec.service,
                          energy_table=energy, b_max=B_MAX, n_epochs=N_EPOCHS,
                          device="cuda")
    log(f"verify_backends ({out['n_decisions']} batches, Poisson trace, {N_EPOCHS} epochs): "
        f"python loop == event kernel, max latency err {out['max_latency_err']:.3e} "
        f"wall_s={time.perf_counter() - t0:.2f}")
    mark("4 checks beside the main path", t_checks)

    # --- the sweep path: batched solves on the spec-batched kernel, a bank --
    t0 = time.perf_counter()
    sweep_phase(torch, np, kernels, rows, res, energy)
    mark("4b sweep", t0)
    t0 = time.perf_counter()
    poisoned_grid_phase(np, kernels, rows)
    mark("4c poisoned grid", t0)

    # --- the paper's figures and tables at full size (4k) --------------------
    t0 = time.perf_counter()
    paper_figures_phase(torch, np, kernels, rows)
    mark("4k paper figures", t0)

    # --- single-server serving: overload shedding, the adaptive bank --------
    t0 = time.perf_counter()
    shedding_phase(torch, np, kernels, rows)
    mark("4d shedding", t0)
    t0 = time.perf_counter()
    adaptive_phase(torch, np, kernels, rows)
    mark("4e adaptive", t0)

    # --- MMPP-aware serving: exact solve, belief kernel, belief lanes -------
    t0 = time.perf_counter()
    mmpp_phase(torch, np, kernels, rows, res, energy)
    main_mix = mix_at_main_shape(torch, np, res.action_table(), energy)
    rows["serve_scan_mix"]["main_path_shape"] = dict(
        ms=main_mix["ms"], plain_ms=main_mix["plain_ms"], bound_ms=main_mix["bound_ms"],
        shape=main_mix["shape"], plain_lane_ms=rows["serve_scan"]["ms"])
    mark("4f MMPP-aware serving", t0)

    # --- the routed fleet and degraded mode: the fleet kernel ---------------
    t0 = time.perf_counter()
    fleet_phase(torch, np, kernels, rows)
    mark("4g fleet", t0)

    # --- durable sweeps and streams, the samplers, the simulator (4h) --------
    t0 = time.perf_counter()
    durable_phase(torch, np, kernels, rows)
    mark("4h durability, samplers, simulator", t0)

    # --- the attention kernels, the model checks and the LLM serving path ---
    t0 = time.perf_counter()
    attention_phase(torch, np, rows)
    mark("5 attention", t0)
    t0 = time.perf_counter()
    model_checks(torch, np)
    mark("6 model checks", t0)
    t0 = time.perf_counter()
    llm_path(torch, np, kernels, rows)
    mark("7 LLM serving path", t0)

    # --- the Mamba2 hybrid (Zamba2-1.2B): SSD kernel, attention at D = 64 (4i)
    t0 = time.perf_counter()
    hybrid_phase(torch, np, kernels, rows)
    mark("4i hybrid", t0)

    # --- Gemma2-9B, Llama-4 Scout, Grok-1: local masks, chunked prefill, MoE (4l)
    t0 = time.perf_counter()
    local_moe_phase(torch, np, kernels, rows)
    mark("4l local masks and MoE", t0)

    # --- RWKV6-3B: the WKV6 scan kernel, served, long context (4m) ----------
    t0 = time.perf_counter()
    rwkv_phase(torch, np, kernels, rows)
    mark("4m RWKV6", t0)

    # --- Whisper-small and Qwen2-VL-7B: encoder, cross-attention, M-RoPE (4n)
    t0 = time.perf_counter()
    encdec_vlm_phase(torch, np, kernels, rows)
    mark("4n Whisper and Qwen2-VL", t0)

    # --- training: the backward kernel, qwen2.5-100m --full, the resume (4j)
    t0 = time.perf_counter()
    train_phase(torch, np, kernels, rows)
    mark("4j training", t0)

    # --- training Whisper, Qwen2-VL, Gemma2, Llama-4, Grok-1: the masked and
    # cross attention's backward (4o)
    t0 = time.perf_counter()
    masked_train_phase(torch, np, kernels, rows)
    mark("4o masked and cross training", t0)

    order = ("bellman_banded", "bellman_banded_batched", "serve_scan",
             "serve_scan_qman", "serve_scan_adaptive", "serve_scan_qman_adaptive",
             "serve_scan_grid_plain", "serve_scan_grid_adaptive",
             "serve_scan_mix", "serve_scan_grid_mix", "belief_forward",
             "fleet_scan", "fleet_scan_grid", "fleet_scan_mix",
             "mmpp_sample", "sim_scan", "flash_attention", "decode_attention",
             "ssd_scan", "flash_attention_bwd", "wkv6_scan")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernel_list = []
    for name in order:
        row = dict(rows[name], name=name)
        kernel_list.append({**{k: row[k] for k in keys},
                            **{k: v for k, v in row.items() if k not in keys}})
    log("bellman first design, quoted from PERF.md (not measured in this run): "
        + json.dumps([dict(shape=list(shape), ms=ms, run=run)
                      for shape, (ms, run) in PREVIOUS_MS.items()]))
    log("walking kernels before their redesign, quoted from PERF.md (not measured in this "
        f"run; now_ms and floor_ms measured on {card}): " + json.dumps(dict(
            earlier_ms=EARLIER_MS, now_ms={name: rows[name]["ms"] for name in EARLIER_MS},
            floor_ms={name: rows[name].get("chain_ms", rows[name].get("floor_ms"))
                      for name in EARLIER_MS})))
    walls = json.dumps({k: round(v, 2) for k, v in PHASE_WALLS.items()})
    log(f"phase walls (s, {card}): {walls}; sum {sum(PHASE_WALLS.values()):.2f} of "
        f"{time.perf_counter() - t_start:.2f} s since the script started")
    log(f"card: {card}")
    log(json.dumps({"kernels": kernel_list}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
