"""Port vs reference: durable sweeps and streams (the resilience surface).

Mirrors tests/test_resilience.py's TestSweepCheckpointResume,
TestFleetStreamSaveResume and TestKillAndResume on the port with
device="cpu":

* durable sweeps: a resume is bitwise equal to the uninterrupted
  checkpointed run (sweep_solve and sweep_solve_modulated), the
  fingerprint refuses a foreign checkpoint and one written on another
  device type, a SIGTERM raises SweepPreempted with durable progress;
* FleetStream.save/resume: every aggregate (n_epochs included) equals the
  uninterrupted stream, per arrival mode incl. the belief posterior; a
  stream the reference saves halfway resumes in the port and ends equal
  to the reference's uninterrupted stream (counts, histograms and the P²
  report exact, energy / lat_sum at rtol 1e-12: the two sum in other
  orders);
* kill-and-resume drills: children that import repro_torch only
  (PYTHONPATH=src), SIGKILLed mid-sweep and mid-stream, and SIGTERMed
  mid-sweep, resume to results equal to a never-killed run.
"""
import dataclasses
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.serving import FleetStream as RefFleetStream
from repro.serving.arrivals import PhaseBeliefFilter as RefFilter
from repro_torch.core import (
    GOOGLENET_P4_ENERGY,
    GOOGLENET_P4_LATENCY,
    PhaseConfig,
    ServiceModel,
    SMDPSpec,
    SweepPreempted,
    sweep_solve,
    sweep_solve_modulated,
)
from repro_torch.core import sweep as sweep_mod
from repro_torch.core.policies import q_policy
from repro_torch.serving import FleetStream
from repro_torch.serving.arrivals import MMPP2, PhaseBeliefFilter
from repro_torch.serving.metrics import P2Quantile

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"

SVC = ServiceModel(latency=GOOGLENET_P4_LATENCY, family="det")
BMAX = 16
MEANS = np.array([0.0] + [float(SVC.mean(b)) for b in range(1, BMAX + 1)])
ENERGY = np.array(
    [0.0] + [float(GOOGLENET_P4_ENERGY(b)) for b in range(1, BMAX + 1)]
)
LAM = 0.7 * BMAX / float(SVC.mean(BMAX))


def spec_for(rho=0.3, w2=1.0, s_max=48, b_max=16):
    lam = rho * b_max / float(SVC.mean(b_max))
    return SMDPSpec(
        lam=lam, service=SVC, energy=GOOGLENET_P4_ENERGY,
        b_min=1, b_max=b_max, w1=1.0, w2=w2, s_max=s_max, c_o=100.0,
    )


def _grid(n=6, s_max=48):
    base = spec_for(s_max=s_max)
    return [
        dataclasses.replace(base, w2=float(w))
        for w in np.linspace(0.0, 5.0, n)
    ]


def _assert_results_bitwise(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.spec.s_max == b.spec.s_max
        assert np.array_equal(a.rvi.policy, b.rvi.policy)
        assert a.rvi.g == b.rvi.g
        assert np.array_equal(a.rvi.h, b.rvi.h)
        assert a.eval.g == b.eval.g
        assert np.array_equal(a.eval.w_bar, b.eval.w_bar)
        assert np.array_equal(a.eval.p_bar, b.eval.p_bar)


# ---------------------------------------------------------------------------
# Durable sweeps (in-process crash simulation)
# ---------------------------------------------------------------------------


class TestSweepCheckpointResume:
    SWEEP_KW = dict(delta=None, auto_c_o=False, chunk_size=2, device=CPU)

    def _run(self, d, specs, **over):
        kw = {**self.SWEEP_KW, "checkpoint_dir": str(d), **over}
        return sweep_solve(specs, **kw)

    def test_resume_after_lost_steps_is_bitwise(self, tmp_path):
        specs = _grid(6)
        ref = self._run(tmp_path / "ref", specs, keep_last_k=99)
        crash = tmp_path / "crash"
        self._run(crash, specs, keep_last_k=99)
        steps = sorted(crash.glob("step_*"))
        assert len(steps) == 3  # 6 specs / chunk_size=2
        for p in steps[1:]:
            shutil.rmtree(p)
        resumed = self._run(crash, specs, keep_last_k=99)
        _assert_results_bitwise(resumed, ref)

    def test_completed_checkpoint_short_circuits(self, tmp_path):
        specs = _grid(4)
        first = self._run(tmp_path, specs)
        again = self._run(tmp_path, specs)
        _assert_results_bitwise(again, first)

    def test_foreign_fingerprint_rejected(self, tmp_path):
        specs = _grid(4)
        self._run(tmp_path, specs)
        with pytest.raises(ValueError, match="different sweep"):
            self._run(tmp_path, specs, eps=5e-3)
        with pytest.raises(ValueError, match="different sweep"):
            self._run(tmp_path, _grid(5))

    def test_sigterm_raises_preempted_with_durable_progress(self, tmp_path):
        """The signal is raised from the first chunk's own checkpoint
        commit, so delivery is deterministic (no timer race)."""
        specs = _grid(6)
        ref = self._run(tmp_path / "ref", specs)
        orig = sweep_mod._SweepCheckpointer.save
        fired = []

        def kick(self, tree):
            orig(self, tree)
            if not fired:
                fired.append(True)
                os.kill(os.getpid(), signal.SIGTERM)

        sweep_mod._SweepCheckpointer.save = kick
        try:
            with pytest.raises(SweepPreempted) as ei:
                self._run(tmp_path / "pre", specs)
        finally:
            sweep_mod._SweepCheckpointer.save = orig
        assert ei.value.checkpoint_dir == str(tmp_path / "pre")
        assert ei.value.step == 0
        resumed = self._run(tmp_path / "pre", specs)
        _assert_results_bitwise(resumed, ref)

    def test_regrow_rounds_resume_bitwise(self, tmp_path):
        """With auto_c_o and the truncation rule on (regrow rounds, the
        persisted c_o and both queues), a resume from every committed step
        equals the uninterrupted checkpointed run, and the report holds
        every spec."""
        specs = [dataclasses.replace(spec_for(rho=0.9, s_max=32), w2=w)
                 for w in (0.0, 1.6, 8.0)]
        kw = dict(chunk_size=1, keep_last_k=99, device=CPU)
        ref = sweep_solve(specs, checkpoint_dir=str(tmp_path / "ref"), **kw)
        assert sorted({r.spec.s_max for r in ref}) != [32]  # it regrew
        steps = sorted((tmp_path / "ref").glob("step_*"))
        for cut in (1, len(steps) // 2):
            d = tmp_path / f"cut{cut}"
            shutil.copytree(tmp_path / "ref", d)
            for p in sorted(d.glob("step_*"))[cut:]:
                shutil.rmtree(p)
            sink = []
            got = sweep_solve(specs, checkpoint_dir=str(d), report_sink=sink, **kw)
            _assert_results_bitwise(got, ref)
            assert sink[0].healthy.all() and len(sink[0].healthy) == len(specs)

    def test_modulated_resume_is_bitwise(self, tmp_path):
        lam = spec_for(rho=0.4).lam
        ph = PhaseConfig.mmpp2(0.5 * lam, 1.6 * lam, 60.0, 30.0)
        specs = [dataclasses.replace(spec_for(rho=0.4, s_max=32), lam=ph.mean_rate, w2=w)
                 for w in (0.0, 1.0, 3.0, 6.0)]
        kw = dict(delta=None, auto_c_o=False, chunk_size=1, keep_last_k=99, device=CPU)
        ref = sweep_solve_modulated(specs, ph, checkpoint_dir=str(tmp_path / "ref"), **kw)
        crash = tmp_path / "crash"
        sweep_solve_modulated(specs, ph, checkpoint_dir=str(crash), **kw)
        steps = sorted(crash.glob("step_*"))
        assert len(steps) == 4
        for p in steps[2:]:
            shutil.rmtree(p)
        got = sweep_solve_modulated(specs, ph, checkpoint_dir=str(crash), **kw)
        _assert_results_bitwise(got, ref)
        for a, b in zip(got, ref):
            assert a.rvi.policy.ndim == 2 and a.rvi.policy.shape[0] == 2  # (K, S)
        with pytest.raises(ValueError, match="different sweep"):
            sweep_solve_modulated(specs, PhaseConfig.poisson(ph.mean_rate),
                                  checkpoint_dir=str(crash), **kw)

    def test_checkpoint_from_another_device_type_is_refused(self, tmp_path, monkeypatch):
        """The device type is fingerprinted: the card's f32 Bellman core and
        the CPU's plain version round differently, so a CPU checkpoint
        resumed on CUDA would not be the uninterrupted run.  (Here the
        sweep is told it runs on CUDA; the refusal comes at load, before
        any solve.)"""
        specs = _grid(4)
        self._run(tmp_path, specs)
        monkeypatch.setattr(sweep_mod, "resolve_device", lambda d: torch.device("cuda"))
        with pytest.raises(ValueError, match="different sweep"):
            self._run(tmp_path, specs)


# ---------------------------------------------------------------------------
# FleetStream save/resume (in-process)
# ---------------------------------------------------------------------------


def _stream_inputs(mode, n=3000, seed=11):
    """(tables, chunk list, stream kwargs) per arrival mode."""
    rng = np.random.default_rng(seed)
    lam = 2 * LAM  # M=2 fleets below
    kw = dict(means=MEANS, zeta=ENERGY, b_max=BMAX, slo=3.0)
    if mode == "poisson":
        tr = np.cumsum(rng.exponential(1.0 / lam, n))
        tabs = np.stack([q_policy(q, 96, BMAX) for q in (4, 8)])
        chunks = [
            dict(times=tr[lo:lo + 400]) for lo in range(0, len(tr), 400)
        ]
        kw["router"] = "pow2"  # exercises the router RNG round-trip
        return tabs, chunks, kw
    stacks = np.stack(
        [np.stack([q_policy(4, 96, BMAX), q_policy(10, 96, BMAX)])] * 2
    )  # (M=2, K=2, L)
    m = MMPP2(lam1=0.3 * lam, lam2=1.3 * lam, dwell1=60.0, dwell2=30.0)
    tr, switches = m.sample_arrivals(n / m.mean_rate, rng)
    sw_t = np.array([s[0] for s in switches])
    sw_p = np.array([s[1] for s in switches], dtype=np.int64)
    ph = sw_p[np.searchsorted(sw_t, tr, side="right") - 1]
    kw["router"] = "jsq"
    if mode == "mmpp2":
        chunks = [
            dict(times=tr[lo:lo + 400], phases=ph[lo:lo + 400])
            for lo in range(0, len(tr), 400)
        ]
        return stacks, chunks, kw
    assert mode == "belief"
    kw["phase_mode"] = "belief_argmax"
    kw["belief_filter"] = (
        [0.3 * lam, 1.3 * lam], [[-1 / 60.0, 1 / 60.0], [1 / 30.0, -1 / 30.0]])
    chunks = [dict(times=tr[lo:lo + 400]) for lo in range(0, len(tr), 400)]
    return stacks, chunks, kw


def _fresh_stream(mode, cls=FleetStream, filt=PhaseBeliefFilter, **extra):
    """A new stream of either package (filters are stateful; never share)."""
    tabs, chunks, kw = _stream_inputs(mode)
    if "belief_filter" in kw:
        kw = dict(kw, belief_filter=filt(*kw["belief_filter"]))
    return cls(tabs, **kw, **extra), chunks


def _assert_streams_equal(got, ref, rtol=0.0):
    a, b = got.result(), ref.result()
    for f in (
        "t_final", "n_served", "n_batches", "n_epochs", "n_admitted",
        "slo_miss", "n_crashes", "n_dropped", "n_shed",
    ):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("energy", "lat_sum"):
        np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=rtol, atol=0,
                                   err_msg=f)
    np.testing.assert_array_equal(a.hist, b.hist)
    np.testing.assert_array_equal(a.qlen, b.qlen)
    np.testing.assert_array_equal(a.busy, b.busy)
    np.testing.assert_array_equal(a.n_routed, b.n_routed)
    np.testing.assert_array_equal(a.n_served_m, b.n_served_m)
    ra, rb = got.report(), ref.report()
    assert set(ra) == set(rb)
    for k in ra:
        if k in ("W_mean", "power"):  # derived from the sums above
            np.testing.assert_allclose(ra[k], rb[k], rtol=rtol, atol=0, err_msg=k)
        else:
            assert ra[k] == rb[k] or (np.isnan(ra[k]) and np.isnan(rb[k])), k


class TestFleetStreamSaveResume:
    @pytest.mark.parametrize("mode", ["poisson", "mmpp2", "belief"])
    def test_save_resume_matches_uninterrupted(self, mode, tmp_path):
        ref, chunks = _fresh_stream(mode, device=CPU)
        for c in chunks:
            ref.push(**c)
        ref.finish()

        fs, chunks = _fresh_stream(mode, device=CPU)
        cut = len(chunks) // 2
        for c in chunks[:cut]:
            fs.push(**c)
        fs.save(tmp_path)
        del fs
        back = FleetStream.resume(tmp_path, device=CPU)
        for c in chunks[cut:]:
            back.push(**c)
        back.finish()
        _assert_streams_equal(back, ref)

    def test_repeated_saves_resume_from_latest(self, tmp_path):
        ref, chunks = _fresh_stream("poisson", device=CPU)
        for c in chunks:
            ref.push(**c)
        ref.finish()
        fs, chunks = _fresh_stream("poisson", device=CPU)
        for c in chunks[:3]:  # save after every chunk, like a real run
            fs.push(**c)
            fs.save(tmp_path)
        back = FleetStream.resume(tmp_path, device=CPU)
        for c in chunks[3:]:
            back.push(**c)
        back.finish()
        _assert_streams_equal(back, ref)

    def test_p2_snapshot_restore_is_bitwise(self):
        rng = np.random.default_rng(3)
        xs = rng.exponential(1.0, 400)
        est = P2Quantile(0.95)
        for x in xs[:200]:
            est.update(x)
        twin = P2Quantile(0.5)
        twin.restore(est.snapshot())
        assert twin.q == est.q
        for x in xs[200:]:
            est.update(x)
            twin.update(x)
        assert twin.value == est.value
        assert twin.heights == est.heights
        assert twin.ns == est.ns

    @pytest.mark.parametrize("mode", ["poisson", "mmpp2", "belief"])
    def test_reference_saved_stream_resumes_in_the_port(self, mode, tmp_path):
        """The reference saves halfway, the port resumes and runs the rest:
        the end state equals the reference's uninterrupted stream."""
        ref, chunks = _fresh_stream(mode, RefFleetStream, RefFilter)
        for c in chunks:
            ref.push(**c)
        ref.finish()
        half, _ = _fresh_stream(mode, RefFleetStream, RefFilter)
        cut = len(chunks) // 2
        for c in chunks[:cut]:
            half.push(**c)
        half.save(tmp_path)
        back = FleetStream.resume(tmp_path, device=CPU)
        for c in chunks[cut:]:
            back.push(**c)
        back.finish()
        _assert_streams_equal(back, ref, rtol=1e-12)


# ---------------------------------------------------------------------------
# Kill-and-resume subprocess drills (children import repro_torch only)
# ---------------------------------------------------------------------------

#: child sweep: checkpointed, 6 specs, chunk_size=1, saves throttled so the
#: parent can land a signal mid-run deterministically after the first commit
_CHILD_SWEEP = r"""
import dataclasses, sys, time
import numpy as np
from repro_torch.core import (GOOGLENET_P4_ENERGY, GOOGLENET_P4_LATENCY,
                              ServiceModel, SMDPSpec, SweepPreempted, sweep_solve)
from repro_torch.core import sweep as _sweep_mod

ckpt, out = sys.argv[1], sys.argv[2]
_orig = _sweep_mod._SweepCheckpointer.save
def _slow(self, tree):
    _orig(self, tree)
    time.sleep(0.25)
_sweep_mod._SweepCheckpointer.save = _slow

svc = ServiceModel(latency=GOOGLENET_P4_LATENCY, family="det")
base = SMDPSpec(lam=0.3 * 16 / float(svc.mean(16)), service=svc,
                energy=GOOGLENET_P4_ENERGY, b_min=1, b_max=16,
                w1=1.0, w2=1.0, s_max=48, c_o=100.0)
specs = [dataclasses.replace(base, w2=float(w))
         for w in np.linspace(0.0, 5.0, 6)]
try:
    res = sweep_solve(specs, delta=None, auto_c_o=False,
                      checkpoint_dir=ckpt, chunk_size=1, device="cpu")
except SweepPreempted as e:
    print("PREEMPTED", e.step, flush=True)
    sys.exit(0)
assert not [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "repro."))]
np.savez(out, policies=np.stack([r.rvi.policy for r in res]),
         g=np.array([r.rvi.g for r in res]),
         h=np.stack([r.rvi.h for r in res]))
print("COMPLETED", flush=True)
"""

#: child fleet stream: M=2 jsq fleet, saves after every chunk (throttled);
#: "resume" mode restores and pushes only the chunks past the saved seam
_CHILD_FLEET = r"""
import sys, time
import numpy as np
from repro_torch.core import GOOGLENET_P4_ENERGY, GOOGLENET_P4_LATENCY, ServiceModel
from repro_torch.core.policies import q_policy
from repro_torch.serving import FleetStream

ckpt, out, mode = sys.argv[1], sys.argv[2], sys.argv[3]
svc = ServiceModel(latency=GOOGLENET_P4_LATENCY, family="det")
BMAX = 16
MEANS = np.array([0.0] + [float(svc.mean(b)) for b in range(1, BMAX + 1)])
ZETA = np.array([0.0] + [float(GOOGLENET_P4_ENERGY(b))
                         for b in range(1, BMAX + 1)])
lam = 2 * 0.7 * BMAX / float(svc.mean(BMAX))
tr = np.cumsum(np.random.default_rng(7).exponential(1.0 / lam, 4000))
tabs = np.stack([q_policy(q, 96, BMAX) for q in (4, 8)])
chunks = [tr[lo:lo + 400] for lo in range(0, len(tr), 400)]

if mode == "resume":
    fs = FleetStream.resume(ckpt, device="cpu")
    todo = [c for c in chunks if c[0] > fs._t_hwm]
else:
    fs = FleetStream(tabs, router="jsq", means=MEANS, zeta=ZETA,
                     b_max=BMAX, slo=3.0, device="cpu")
    todo = chunks
for c in todo:
    fs.push(c)
    fs.save(ckpt)
    time.sleep(0.25)
res = fs.finish()
rep = fs.report()
np.savez(out, n_served=res.n_served, n_batches=res.n_batches,
         n_epochs=res.n_epochs, n_admitted=res.n_admitted,
         energy=res.energy, lat_sum=res.lat_sum, slo_miss=res.slo_miss,
         hist=res.hist, t_final=res.t_final, n_routed=res.n_routed,
         n_served_m=res.n_served_m, p50=rep["P50"], p95=rep["P95"])
print("COMPLETED", flush=True)
"""


def _env():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin")}
    for k in ("HOME", "TMPDIR"):
        if k in os.environ:
            env[k] = os.environ[k]
    return env


def _committed_steps(d):
    return sorted(
        p for p in Path(d).glob("step_*") if not p.name.endswith(".tmp")
    )


def _spawn(script, *argv):
    return subprocess.Popen(
        [sys.executable, "-c", script, *map(str, argv)],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
    )


def _wait_first_commit(proc, ckpt, deadline_s=240):
    t1 = time.time() + deadline_s
    while time.time() < t1:
        if _committed_steps(ckpt):
            return
        if proc.poll() is not None:
            out, err = proc.communicate()
            raise AssertionError(
                f"child exited before first checkpoint:\n{out}\n{err}"
            )
        time.sleep(0.01)
    proc.kill()
    raise AssertionError("no checkpoint committed within deadline")


def _rerun(script, *argv):
    r = subprocess.run(
        [sys.executable, "-c", script, *map(str, argv)],
        env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert "COMPLETED" in r.stdout, r.stdout
    return r


def _ref_sweep(tmp_path):
    return sweep_solve(
        _grid(6), delta=None, auto_c_o=False,
        checkpoint_dir=str(tmp_path / "ref"), chunk_size=1, device=CPU,
    )


class TestKillAndResume:
    def test_sigkill_mid_sweep_resumes_bitwise(self, tmp_path):
        ckpt, out = tmp_path / "ck", tmp_path / "out.npz"
        proc = _spawn(_CHILD_SWEEP, ckpt, out)
        _wait_first_commit(proc, ckpt)
        proc.kill()
        proc.wait()
        assert not out.exists()  # the kill landed mid-run
        _rerun(_CHILD_SWEEP, ckpt, out)
        got = np.load(out)
        ref = _ref_sweep(tmp_path)
        np.testing.assert_array_equal(
            got["policies"], np.stack([r.rvi.policy for r in ref])
        )
        np.testing.assert_array_equal(
            got["g"], np.array([r.rvi.g for r in ref])
        )
        np.testing.assert_array_equal(
            got["h"], np.stack([r.rvi.h for r in ref])
        )

    def test_sigterm_mid_sweep_preempts_then_resumes(self, tmp_path):
        ckpt, out = tmp_path / "ck", tmp_path / "out.npz"
        proc = _spawn(_CHILD_SWEEP, ckpt, out)
        _wait_first_commit(proc, ckpt)
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=120)
        assert proc.returncode == 0, stderr
        assert "PREEMPTED" in stdout, stdout + stderr
        assert _committed_steps(ckpt)  # progress survived the signal
        assert not out.exists()
        _rerun(_CHILD_SWEEP, ckpt, out)
        got = np.load(out)
        ref = _ref_sweep(tmp_path)
        np.testing.assert_array_equal(
            got["policies"], np.stack([r.rvi.policy for r in ref])
        )

    def test_sigkill_mid_stream_resumes_exactly(self, tmp_path):
        ckpt, out = tmp_path / "ck", tmp_path / "out.npz"
        proc = _spawn(_CHILD_FLEET, ckpt, out, "run")
        _wait_first_commit(proc, ckpt)
        proc.kill()
        proc.wait()
        assert not out.exists()
        _rerun(_CHILD_FLEET, ckpt, out, "resume")
        got = np.load(out)
        # uninterrupted reference, same construction as the child
        lam = 2 * LAM
        tr = np.cumsum(np.random.default_rng(7).exponential(1.0 / lam, 4000))
        tabs = np.stack([q_policy(q, 96, BMAX) for q in (4, 8)])
        fs = FleetStream(
            tabs, router="jsq", means=MEANS, zeta=ENERGY, b_max=BMAX,
            slo=3.0, device=CPU,
        )
        for lo in range(0, len(tr), 400):
            fs.push(tr[lo:lo + 400])
        res = fs.finish()
        rep = fs.report()
        for f in ("n_served", "n_batches", "n_epochs", "n_admitted",
                  "energy", "lat_sum", "slo_miss", "t_final"):
            assert float(got[f]) == float(getattr(res, f)), f
        np.testing.assert_array_equal(got["hist"], res.hist)
        np.testing.assert_array_equal(got["n_routed"], res.n_routed)
        np.testing.assert_array_equal(got["n_served_m"], res.n_served_m)
        assert float(got["p50"]) == rep["P50"]
        assert float(got["p95"]) == rep["P95"]
