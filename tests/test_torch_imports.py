"""The PyTorch port stands alone and never falls back from CUDA to the CPU.

* importing the port pulls in neither jax nor the reference package;
* no source file of the port imports them;
* every entry point, given device=None, means CUDA and raises without it;
* a tensor that is not on the CPU never reaches a plain version;
* chip_smoke.py refuses to run without CUDA or outside the checkout.
"""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO / "src")] + [p for p in [env.get("PYTHONPATH")] if p]
    )
    return env


def test_import_pulls_in_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "import repro_torch.core, repro_torch.kernels.ops\n"
        "import repro_torch.serving, repro_torch.interop\n"
        "import repro_torch.models, repro_torch.configs\n"
        "import repro_torch.launch.serve_llm, repro_torch.serving.kv_cache\n"
        "import repro_torch.core.sweep, repro_torch.core.tradeoff\n"
        "import repro_torch.launch.tradeoff_sweep, repro_torch.launch.paper_figures\n"
        "import repro_torch.serving.fleet, repro_torch.serving.faults\n"
        "import repro_torch.kernels.fleet_scan\n"
        "import repro_torch.checkpoint, repro_torch.core.simulate\n"
        "import repro_torch.launch.resume_sweep, repro_torch.kernels.sim_scan\n"
        "import repro_torch.kernels.mmpp_sample, repro_torch.kernels.ssd_scan\n"
        "import repro_torch.models.layers, repro_torch.models.model\n"
        "import repro_torch.training, repro_torch.launch.train\n"
        "import repro_torch.kernels.flash_attention_bwd, repro_torch.kernels.wkv6_scan\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], env=_env(), capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|from\s+repro(\.|\s))",
    re.MULTILINE,
)


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py"))
    + ["chip_smoke.py"],
)
def test_source_imports_neither_jax_nor_reference(path):
    text = (REPO / path).read_text()
    assert not _FORBIDDEN.search(text), path


def _entry_points():
    from repro_torch.core import (
        GOOGLENET_P4_ENERGY, GOOGLENET_P4_LATENCY, PhaseConfig, ServiceModel, SMDPSpec,
        build_smdp, build_smdp_batched, build_smdp_modulated, relative_value_iteration,
        relative_value_iteration_batched, relative_value_iteration_modulated, solve,
        solve_modulated, sweep_bank, sweep_solve, sweep_solve_modulated,
    )
    from repro_torch.core.tradeoff import smdp_tradeoff_curve
    from repro_torch.launch import paper_figures, tradeoff_sweep
    from repro_torch.configs import ARCHS
    from repro_torch.interop import params_from_reference
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving import (
        AdaptiveController, PhaseBeliefFilter, ServingEngine, SMDPScheduler,
        SMDPSchedulerBank, belief_forward, run_grid, run_grid_adaptive,
        simulate_compiled,
    )
    from repro_torch.serving import (
        FaultSchedule, FleetStream, run_fleet_grid, simulate_fleet, verify_faults,
        verify_fleet,
    )
    from repro_torch.serving.kv_cache import KVCachePool
    from repro_torch.core.simulate import simulate, simulate_events
    from repro_torch.launch import resume_sweep
    from repro_torch.launch import train as train_cli
    from repro_torch.training import DataConfig, Trainer, batch_at_step
    from repro_torch.serving import (
        MMPP2, DiurnalProcess, diurnal_times, mmpp2_times, poisson_times,
    )

    svc = ServiceModel(latency=GOOGLENET_P4_LATENCY, family="det")
    spec = SMDPSpec(lam=0.5, service=svc, energy=GOOGLENET_P4_ENERGY,
                    b_max=4, s_max=8)
    table = np.array([0, 1, 2, 3, 4])
    bank = SMDPSchedulerBank({(0.5,): table, (1.0,): table}, key_names=("lam",))
    padded = np.concatenate([np.arange(5.0), np.full(4, np.inf)])[None]
    h = np.zeros(9)
    pm = np.full((3, 5), 0.2)
    cfg = ARCHS["qwen2.5-32b"].reduced()
    zamba = ARCHS["zamba2-1.2b"].reduced()
    rwkv = ARCHS["rwkv6-3b"].reduced()
    rkvw = np.zeros((1, 3, 2, 16), np.float32)
    xs = np.zeros((1, 3, 2, 4), np.float32)
    bc = np.zeros((1, 3, 5), np.float32)
    dt = np.zeros((1, 3, 2), np.float32)
    q = np.zeros((1, 4, 4, 16), np.float32)
    kv = np.zeros((1, 4, 2, 16), np.float32)
    return {
        "solve": lambda: solve(spec),
        "relative_value_iteration": lambda: relative_value_iteration(build_smdp(spec)),
        "relative_value_iteration_batched": lambda: relative_value_iteration_batched(
            build_smdp_batched([spec])),
        "sweep_solve": lambda: sweep_solve([spec]),
        "sweep_bank": lambda: sweep_bank(spec, [0.5]),
        "solve_modulated": lambda: solve_modulated(spec, PhaseConfig.poisson(0.5)),
        "sweep_solve_modulated": lambda: sweep_solve_modulated(
            [spec], PhaseConfig.poisson(0.5)),
        "relative_value_iteration_modulated": lambda: relative_value_iteration_modulated(
            build_smdp_modulated(spec, PhaseConfig.poisson(0.5))),
        "belief_forward": lambda: belief_forward(
            np.arange(5.0), PhaseBeliefFilter([0.5, 1.0], [[-1.0, 1.0], [1.0, -1.0]])),
        "smdp_tradeoff_curve": lambda: smdp_tradeoff_curve(spec, [0.0]),
        "tradeoff_sweep.main": lambda: tradeoff_sweep.main(["--w2", "0"]),
        "paper_figures.main": lambda: paper_figures.main(["--only", "fig9_cov", "--smoke"]),
        "fig10_abstract_cost": lambda: paper_figures.fig10_abstract_cost(
            (100.0,), s_grid=(36,)),
        "ServingEngine": lambda: ServingEngine(
            SMDPScheduler.from_table(table), lam=0.5, b_max=4, service=svc),
        "simulate_compiled": lambda: simulate_compiled(
            table, np.arange(5.0), means=np.arange(5.0), b_max=4),
        "simulate_compiled(buffer=)": lambda: simulate_compiled(
            table, np.arange(5.0), means=np.arange(5.0), b_max=4, buffer=2),
        "simulate_compiled(adaptive=)": lambda: simulate_compiled(
            None, np.arange(5.0), means=np.arange(5.0), b_max=4,
            adaptive=AdaptiveController(bank)),
        "run_grid": lambda: run_grid(table[None], padded, means=np.arange(5.0),
                                     b_max=4),
        "simulate_fleet": lambda: simulate_fleet(
            np.stack([table, table]), np.arange(5.0), means=np.arange(5.0), b_max=4),
        "run_fleet_grid": lambda: run_fleet_grid(
            table[None], padded, n_replicas=2, means=np.arange(5.0), b_max=4),
        "verify_fleet": lambda: verify_fleet(
            np.stack([table, table]), np.arange(5.0), service=svc, b_max=4),
        "verify_faults": lambda: verify_faults(
            np.stack([table, table]), np.arange(5.0), faults=FaultSchedule.none(2),
            service=svc, b_max=4),
        "FleetStream": lambda: FleetStream(
            np.stack([table, table]), means=np.arange(5.0), b_max=4),
        "run_grid_adaptive": lambda: run_grid_adaptive(
            padded, adaptive=AdaptiveController(bank), means=np.arange(5.0),
            b_max=4),
        "bellman_backup": lambda: ops.bellman_backup(h, pm, np.zeros((5, 3)), 0.0),
        "bellman_backup_batched": lambda: ops.bellman_backup_batched(
            h[None], pm[None], np.zeros((1, 5, 3)), np.zeros(1)),
        "flash_attention": lambda: ops.flash_attention(q, kv, kv),
        "decode_attention": lambda: ops.decode_attention(q[:, 0], kv, kv, [2]),
        "init_params": lambda: M.init_params(cfg, torch.Generator()),
        "init_cache": lambda: M.init_cache(cfg, 1, 8),
        "init_params(hybrid)": lambda: M.init_params(zamba, torch.Generator()),
        "init_cache(hybrid)": lambda: M.init_cache(zamba, 1, 8),
        "ssd_scan": lambda: ops.ssd_scan(
            xs, bc, bc, dt, dt, None, chunk=2),
        "init_params(rwkv)": lambda: M.init_params(rwkv, torch.Generator()),
        "init_cache(rwkv)": lambda: M.init_cache(rwkv, 1, 8),
        "wkv6_scan": lambda: ops.wkv6_scan(rkvw, rkvw, rkvw, rkvw, rkvw[0, 0]),
        "KVCachePool": lambda: KVCachePool(cfg, 2, 8),
        "poisson_times": lambda: poisson_times(0, 1.0, 4),
        "mmpp2_times": lambda: mmpp2_times(0, MMPP2(1.0, 2.0, 5.0, 5.0), 4),
        "diurnal_times": lambda: diurnal_times(0, DiurnalProcess(1.0, 0.5, 10.0), 4),
        "simulate": lambda: simulate(table, svc, np.zeros(5), 0.5, 4, n_epochs=4),
        "simulate_events(compiled)": lambda: simulate_events(
            table, svc, np.zeros(5), 0.5, 4, n_epochs=4, backend="compiled"),
        "resume_sweep.main": lambda: resume_sweep.main(["--n", "2"]),
        "Trainer": lambda: Trainer(cfg, DataConfig(cfg.vocab_size, 8, 2)),
        "batch_at_step": lambda: batch_at_step(DataConfig(cfg.vocab_size, 8, 2), 0),
        "train.main": lambda: train_cli.main(["--arch", "qwen2.5-32b", "--steps", "1"]),
        "FleetStream.resume": lambda: FleetStream.resume("no-such-checkpoint"),
        "params_from_reference": lambda: params_from_reference(cfg, {}),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_device_none_means_cuda_and_raises_without_it(name):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: device=None runs on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[name]()


def test_explicit_cpu_runs_the_plain_versions():
    from repro_torch.kernels import ops

    got = ops.bellman_backup(np.arange(9.0), np.full((3, 5), 0.2),
                             np.zeros((5, 3)), 1.0, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.float32
    want = np.array([[0.2 * sum(range(t, t + 5))] * 3 for t in range(5)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_non_cpu_tensor_never_reaches_a_plain_version():
    """A tensor that does not lie on the CPU goes to the kernel or raises
    (a meta tensor stands in for one on a card the kernel cannot use)."""
    from repro_torch.kernels import bellman, serve_scan

    f = dict(dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        bellman.bellman_banded(
            torch.empty(9, **f), torch.empty(3, 5, **f),
            torch.empty(5, 3, **f), torch.empty((), **f),
        )
    d = dict(dtype=torch.float64, device="meta")
    i = dict(dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        serve_scan.serve_scan(
            torch.empty(1, 1, 4, **i), torch.empty(1, 8, **d), None,
            torch.empty(1, 8, **i), torch.empty(1, 1, **d),
            torch.empty(5, **d), torch.empty(5, **d), torch.empty(9, **d),
            t0=0.0, horizon=float("inf"), max_eps=4, drain=True, b_max=4,
        )
    assert bellman.bellman_banded.launches == 0
    assert serve_scan.serve_scan.launches == 0
    from repro_torch.kernels import fleet_scan

    fl = (torch.empty(1, 2, 1, 4, **i), torch.empty(1, 2, 1, 4, **i),
          torch.empty(1, **i), torch.empty(1, 8, **d), torch.empty(1, 8, **d),
          torch.empty(1, 8, **i), torch.empty(1, 8, 2, **d), torch.empty(1, 1, **d),
          torch.empty(5, **d), torch.empty(5, **d), torch.empty(9, **d),
          torch.empty(2, 1, **d), torch.empty(2, 1, **d), torch.empty(2, 1, **d),
          torch.empty(2, 1, **d), torch.empty(2, **d), torch.empty(5, 2, **i))
    fkw = dict(t0=0.0, horizon=float("inf"), max_eps=4, step_cap=16, drain=True,
               b_max=4, buf_cap=1 << 30, max_retries=0, rr0=0, ph0=0,
               more_coming=False, t_last=float("inf"))
    with pytest.raises(ValueError, match="unsupported device"):
        fleet_scan.fleet_scan(*fl, **fkw)
    with pytest.raises(ValueError, match="CPU tensors"):
        fleet_scan.fleet_scan_ref(*fl, **fkw)
    assert fleet_scan.fleet_scan.launches == 0
    from repro_torch.kernels import mmpp_sample, sim_scan

    with pytest.raises(ValueError, match="unsupported device"):
        mmpp_sample.mmpp_sample(torch.empty(2, 7, **d), (1.0, 2.0), (3.0, 4.0))
    one = torch.ones(1, **d)
    sim_args = (torch.zeros(3, dtype=torch.int64, device="meta"), torch.empty(5, **d),
                torch.empty(5, **d), one, one, torch.empty(1, 8, 0, **d),
                torch.empty(1, 64, **d))
    sim_kw = dict(fam=0, erlang_k=1, lam=1.0, k_max=4, R=0)
    with pytest.raises(ValueError, match="unsupported device"):
        sim_scan.sim_scan(*sim_args, **sim_kw)
    with pytest.raises(ValueError, match="CPU tensors"):
        sim_scan.sim_scan_ref(*sim_args, **sim_kw)
    assert mmpp_sample.mmpp_sample.launches == 0 and sim_scan.sim_scan.launches == 0
    from repro_torch.kernels import decode_attention, flash_attention

    f32 = dict(dtype=torch.float32, device="meta")
    f = dict(dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention.flash_attention(torch.empty(1, 4, 4, 16, **f),
                                        torch.empty(1, 4, 2, 16, **f),
                                        torch.empty(1, 4, 2, 16, **f))
    with pytest.raises(ValueError, match="CUDA tensors"):
        decode_attention.decode_attention(
            torch.empty(1, 4, 16, **f), torch.empty(1, 4, 2, 16, **f),
            torch.empty(1, 4, 2, 16, **f),
            torch.empty(1, dtype=torch.int32, device="meta"))
    assert flash_attention.flash_attention.launches == 0
    assert decode_attention.decode_attention.launches == 0
    from repro_torch.kernels import ssd_scan

    for dtype in (torch.float32, torch.bfloat16):
        x = dict(dtype=dtype, device="meta")
        with pytest.raises(ValueError, match="CUDA tensors"):
            ssd_scan.ssd_scan(torch.empty(1, 3, 2, 4, **x), torch.empty(1, 3, 5, **x),
                              torch.empty(1, 3, 5, **x), torch.empty(1, 3, 2, **f32),
                              torch.empty(1, 3, 2, **f32), torch.empty(1, 2, 4, 5, **f32))
    assert ssd_scan.ssd_scan.launches == 0
    from repro_torch.kernels import wkv6_scan

    for dtype in (torch.float32, torch.bfloat16):
        x = dict(dtype=dtype, device="meta")
        with pytest.raises(ValueError, match="CUDA tensors"):
            wkv6_scan.wkv6_scan(torch.empty(1, 3, 2, 16, **x), torch.empty(1, 3, 2, 16, **x),
                                torch.empty(1, 3, 2, 16, **x), torch.empty(1, 3, 2, 16, **f32),
                                torch.empty(2, 16, **f32), torch.empty(1, 2, 16, 16, **f32))
    assert wkv6_scan.wkv6_scan.launches == 0


def test_chip_smoke_exits_nonzero_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present")
    out = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
