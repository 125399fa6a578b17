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
        GOOGLENET_P4_ENERGY, GOOGLENET_P4_LATENCY, ServiceModel, SMDPSpec,
        build_smdp, relative_value_iteration, solve,
    )
    from repro_torch.kernels import ops
    from repro_torch.serving import ServingEngine, SMDPScheduler, simulate_compiled

    svc = ServiceModel(latency=GOOGLENET_P4_LATENCY, family="det")
    spec = SMDPSpec(lam=0.5, service=svc, energy=GOOGLENET_P4_ENERGY,
                    b_max=4, s_max=8)
    table = np.array([0, 1, 2, 3, 4])
    h = np.zeros(9)
    pm = np.full((3, 5), 0.2)
    return {
        "solve": lambda: solve(spec),
        "relative_value_iteration": lambda: relative_value_iteration(build_smdp(spec)),
        "ServingEngine": lambda: ServingEngine(
            SMDPScheduler.from_table(table), lam=0.5, b_max=4, service=svc),
        "simulate_compiled": lambda: simulate_compiled(
            table, np.arange(5.0), means=np.arange(5.0), b_max=4),
        "bellman_backup": lambda: ops.bellman_backup(h, pm, np.zeros((5, 3)), 0.0),
        "bellman_backup_batched": lambda: ops.bellman_backup_batched(
            h[None], pm[None], np.zeros((1, 5, 3)), np.zeros(1)),
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
    with pytest.raises(ValueError, match="unsupported device"):
        serve_scan.serve_scan(
            torch.empty(1, 4, dtype=torch.int64, device="meta"),
            torch.empty(8, **d), torch.empty(8, dtype=torch.int64, device="meta"),
            torch.empty(1, **d), torch.empty(5, **d),
            t0=0.0, horizon=float("inf"), max_eps=4, drain=True, b_max=4,
        )
    assert bellman.bellman_banded.launches == 0


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
