#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card, and check it.

    python3 chip_smoke.py        (from the root of the checkout, one card)

1. Prints the card (name, power limit) and builds the CUDA kernels from
   the sources in this checkout (one nvcc per source, all at once).
2. Kernel phase: holds each kernel against its plain PyTorch version on
   the card -- the Bellman backup at the reference test shapes, the
   solver's path shape (129, 33, 129) and (4097, 33, 4097); its batched
   form at the reference batched shapes, also against per-spec scalar
   launches; the serving event kernel on a few thousand epochs -- and
   times each against its bound.
3. Main path, with every launch counter zeroed just before and read just
   after: solve the paper's Table-I point (GoogLeNet on a Tesla P4,
   b_max = 32, rho = 0.7, w2 = 1.6) with the Bellman kernel, then serve
   100 000 decision epochs through the event kernel.
4. Checks: the solve went through one kernel launch per backup; its
   policy equals the float64 banded path on the card and the plain CPU
   path; the same at rho = 0.9; verify_backends (Python event loop vs the
   kernel) at the serving size on a Poisson trace.
5. Prints a `kernels` JSON line, then the one-line verdict.

Any failed check raises, so the exit code is not 0.  Without CUDA it exits
with 2 and prints no result.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: NVIDIA H100 SXM data sheet (dense, no sparsity) -- see PERF.md
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # CUDA cores
F64_FLOPS = 34e12  # CUDA cores

RHO, W2, B_MAX, S_MAX = 0.7, 1.6, 32, 128
N_EPOCHS = 100_000
BELLMAN_TEST_SHAPES = [(64, 9, 40), (200, 33, 170), (128, 33, 128), (300, 17, 513)]
BATCHED_TEST_SHAPES = [(1, 64, 9, 40), (3, 130, 33, 130), (4, 128, 17, 260)]
PATH_SHAPE = (S_MAX + 1, B_MAX + 1, S_MAX + 1)  # (T, A, K) of the Table-I solve
LARGE_SHAPE = (4097, 33, 4097)  # solve()'s max_s_max = 4096
SWEEP_SPECS = 17  # a 17-point w2 grid: the batched kernel's sweep launch


def log(*parts):
    print(*parts, flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def bound(bytes_moved, flops, flops_rate):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(torch, fn, reps):
    """Device time per call: `reps` calls captured in one CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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


def bellman_inputs(torch, np, rng, T, A, K, n=None):
    lead = () if n is None else (n,)
    h = rng.normal(size=lead + (T + K,)) * 10
    logits = rng.normal(size=lead + (A, K))
    pmfs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    tails = rng.uniform(size=lead + (T, A))
    hso = rng.normal(size=lead) * 3 if n is not None else np.float64(2.5)
    return [torch.as_tensor(x, dtype=torch.float32, device="cuda")
            for x in (h, pmfs, tails, hso)]


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

    def bellman_row(T, A, K, reps):
        h, p, t, hso = bellman_inputs(torch, np, rng, T, A, K)
        ms = device_ms(torch, lambda: bellman.bellman_banded(h, p, t, hso), reps)
        wrapper_ms = call_ms(torch, lambda: bellman.bellman_banded(h, p, t, hso), reps)
        plain = device_ms(torch, lambda: bellman.bellman_banded_ref(h, p, t, hso), reps)
        lib = device_ms(torch, lambda: torch.matmul(h.unfold(0, K, 1)[:T], p.T), reps)
        b_ms, b_by = bound(4 * ((T + K) + A * K + 2 * T * A + 1),
                           2 * T * A * K + 2 * T * A, F32_FLOPS)
        log(f"bellman_banded {T}x{A}x{K}: kernel_ms={ms:.6f} call_ms={wrapper_ms:.6f} "
            f"plain_ms={plain:.6f} library_ms={lib:.6f} bound_ms={b_ms:.6f} ({b_by})")
        return dict(ms=ms, call_ms=wrapper_ms, plain_ms=plain, library_ms=lib,
                    bound_ms=b_ms, bound_by=b_by, shape=[T, A, K])

    path_row = bellman_row(*PATH_SHAPE, reps=200)
    large_row = bellman_row(*LARGE_SHAPE, reps=20)
    rows["bellman_banded"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/bellman.cu",
        replaces="src/repro/kernels/bellman.py:66", max_abs_err=err,
        **path_row, large=large_row,
    )

    # --- Bellman backup, spec-batched form ---------------------------------
    err_b = 0.0
    for N, T, A, K in BATCHED_TEST_SHAPES:
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
        err_b = max(err_b, e)
        log(f"bellman_banded_batched {N}x{T}x{A}x{K}: max_abs_err={e:.3e} "
            "(1e-4/1e-5 vs plain, 1e-5/1e-6 vs scalar launches) ok")
    N, (T, A, K) = SWEEP_SPECS, PATH_SHAPE
    h, p, t, hso = bellman_inputs(torch, np, rng, T, A, K, n=N)
    ms = device_ms(torch, lambda: bellman.bellman_banded_batched(h, p, t, hso), 100)
    plain = device_ms(torch, lambda: bellman.bellman_banded_batched_ref(h, p, t, hso), 100)
    lib = device_ms(torch, lambda: torch.bmm(h.unfold(1, K, 1)[:, :T], p.transpose(1, 2)), 100)
    b_ms, b_by = bound(4 * N * ((T + K) + A * K + 2 * T * A + 1),
                       N * (2 * T * A * K + 2 * T * A), F32_FLOPS)
    log(f"bellman_banded_batched {N}x{T}x{A}x{K}: kernel_ms={ms:.6f} plain_ms={plain:.6f} "
        f"library_ms={lib:.6f} bound_ms={b_ms:.6f} ({b_by})")
    rows["bellman_banded_batched"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/bellman.cu",
        replaces="src/repro/kernels/bellman.py:131", max_abs_err=err_b,
        ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
        shape=[N, T, A, K],
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


def serve_scan_row(torch, np, table, row):
    """Time the event kernel and its plain version on the main path's own
    inputs, and hold them against each other there too."""
    from repro_torch.kernels import serve_scan as ss
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
    on = lambda x, dt, d="cuda": torch.as_tensor(x, dtype=dt, device=d)  # noqa: E731
    kw = dict(t0=0.0, horizon=float("inf"), max_eps=N_EPOCHS, drain=False, b_max=B_MAX)

    def scan_args(d):
        return (on(table[None], torch.int64, d), on(arr, torch.float64, d),
                on(np.zeros(len(arr)), torch.int64, d),
                on(np.ones(N_EPOCHS), torch.float64, d), on(means, torch.float64, d))

    gpu_args = scan_args("cuda")
    out = ss.serve_scan(*gpu_args, **kw)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ss.serve_scan(*gpu_args, **kw)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    t0 = time.perf_counter()
    ref = ss.serve_scan_ref(*scan_args("cpu"), **kw)
    plain = (time.perf_counter() - t0) * 1e3
    n_srv, n_adm, n_bat, n_eps, _ = ref.agg.tolist()
    check(out.agg.tolist() == ref.agg.tolist(), "serve_scan aggregates at 100k epochs")
    check(torch.equal(out.rec_a[:n_eps].cpu(), ref.rec_a), "serve_scan decisions at 100k")
    t_err = (out.rec_t[:n_eps].cpu() - ref.rec_t).abs().max().item()
    check(t_err <= 1e-9, f"serve_scan clocks off by {t_err}")
    b_ms, b_by = bound(
        8 * (n_adm + 1) + 8 * n_adm + 8 * n_bat + means.nbytes + table.nbytes
        + 12 * n_eps + 48,
        2 * n_eps, F64_FLOPS,
    )
    log(f"serve_scan {n_eps} epochs / {n_adm} admissions: kernel_ms={best:.3f} "
        f"plain_ms={plain:.3f} (Python loop on the host) bound_ms={b_ms:.6f} ({b_by}); "
        f"decisions equal, max clock err {t_err:.3e}")
    row.update(
        route="cuda", source="src/repro_torch/kernels/csrc/serve_scan.cu",
        replaces="src/repro/serving/compiled.py:328 (_scan_core: a lax.scan, not a Pallas kernel)",
        max_abs_err=max(row["max_abs_err"], t_err), ms=best, plain_ms=plain,
        bound_ms=b_ms, bound_by=b_by, library_ms=None, shape=[n_eps, n_adm],
    )


def profile_solve(torch, spec, rvi_s):
    """Device time of one warm kernel solve, by kernel name (torch.profiler).

    The busy share divides the summed device time by ``rvi_s``, the RVI
    wall time of the same solve measured without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import solve

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        res = solve(spec, backup="pallas", device="cuda")
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)

    # kernel-level rows only: an aten op's device time is its kernels' again
    rows = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    total_us = sum(dev_us(e) for e in rows)
    if not rows:
        log("profile solve: the profiler recorded no device time (not measured)")
        return
    backups = res.rvi.iterations + 1
    log(f"profile solve rho={RHO}: {backups} backups, {sum(e.count for e in rows)} "
        f"kernel launches, device busy "
        f"{total_us / 1e3:.3f} ms = {total_us / 1e3 / backups:.4f} ms per backup; "
        f"busy share of the unprofiled RVI wall time "
        f"{total_us / 1e6 / rvi_s:.3f}")
    for e in sorted(rows, key=dev_us, reverse=True)[:8]:
        log(f"  {dev_us(e) / 1e3:9.3f} ms  {e.count:6d} calls  {e.key[:90]}")


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


def main():
    import torch

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
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_s = _build.build_all()
    log(f"kernel build: {build_s:.2f} s")
    for name, text in sorted(_build.build_logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    rows = kernel_phase(torch, np)

    # --- the main path, counters zeroed just before and read just after ---
    from repro_torch.core import GOOGLENET_P4_ENERGY
    from repro_torch.serving import ServingEngine, SMDPScheduler

    energy = np.array([0.0] + [float(GOOGLENET_P4_ENERGY(b)) for b in range(1, B_MAX + 1)])
    spec = table1_spec(RHO)
    from repro_torch.core import solve

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
    serve_scan_row(torch, np, res.action_table(), rows["serve_scan"])

    # --- checks beside the main path ---------------------------------------
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

    order = ("bellman_banded", "bellman_banded_batched", "serve_scan")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernel_list = []
    for name in order:
        row = dict(rows[name], name=name)
        kernel_list.append({**{k: row[k] for k in keys},
                            **{k: v for k, v in row.items() if k not in keys}})
    log(f"card: {card}")
    log(json.dumps({"kernels": kernel_list}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
