"""Crash-safe sweeps: durable checkpoints, preemption, resume.

The port of examples/resume_sweep.py.  Pass ``checkpoint_dir=`` to
`sweep_solve` and every solved chunk is committed durably (atomic rename
+ per-array CRC through `checkpoint.CheckpointManager`).  A SIGTERM
mid-sweep saves-and-raises `SweepPreempted`; re-running the *identical*
call with the same directory (on the same device type) resumes and
produces results bitwise-identical to a never-interrupted run.  A
checkpoint written by different specs, solver parameters or on another
device type is rejected by fingerprint.  The same discipline covers
serving: `FleetStream.save()` persists the full chunk seam and
`FleetStream.resume()` continues with every aggregate equal to the
uninterrupted stream.

    PYTHONPATH=src python -m repro_torch.launch.resume_sweep --device cpu \\
        --ckpt <dir>
    # kill it (SIGTERM / preemption) while it runs, then re-run the same
    # command: it resumes from the last committed chunk.

    # one-command demo: preempt itself after the first chunk commits,
    # then resume in-process and verify against an uninterrupted run
    PYTHONPATH=src python -m repro_torch.launch.resume_sweep --device cpu \\
        --self-preempt

``--backup pallas`` runs every lockstep backup on the spec-batched CUDA
Bellman kernel (``--device`` defaults to cuda).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..core import (
    GOOGLENET_P4_ENERGY,
    GOOGLENET_P4_LATENCY,
    ServiceModel,
    SMDPSpec,
    SweepPreempted,
    sweep_solve,
)
from ..core.policies import q_policy
from ..serving import FleetStream


def build_grid(n=24, s_max=64, b_max=16):
    svc = ServiceModel(latency=GOOGLENET_P4_LATENCY, family="det")
    lam = 0.5 * b_max / float(svc.mean(b_max))
    base = SMDPSpec(
        lam=lam, service=svc, energy=GOOGLENET_P4_ENERGY,
        b_min=1, b_max=b_max, w1=1.0, w2=1.0, s_max=s_max, c_o=100.0,
    )
    return [
        dataclasses.replace(base, w2=float(w))
        for w in np.linspace(0.0, 12.0, n)
    ]


def run_sweep(ckpt_dir, specs, chunk_size=4, *, device=None, backup="banded"):
    sink = []
    try:
        res = sweep_solve(
            specs, checkpoint_dir=str(ckpt_dir), chunk_size=chunk_size,
            report_sink=sink, backup=backup, device=device,
        )
    except SweepPreempted as e:
        print(f"preempted: {e}")
        print("re-run the same command to resume")
        return None
    rep = sink[0]
    print(
        f"solved {len(res)} specs: {int(rep.healthy.sum())} healthy, "
        f"rungs fired: {sorted(rep.rungs) or 'none'}, "
        f"quarantined: {rep.quarantined or 'none'}"
    )
    return res


def self_preempt_demo(chunk_size=4, *, device=None, backup="banded",
                      workdir=None) -> dict:
    """SIGTERM after the first committed chunk, then resume and verify.

    Returns what it checked: ``same`` (resumed == uninterrupted, bitwise
    in policy, g and h), ``committed`` (steps on disk at the preemption),
    the two result lists, and ``stream_same`` (a FleetStream saved halfway
    and resumed equals the uninterrupted one on every report entry)."""
    specs = build_grid()
    with tempfile.TemporaryDirectory(dir=workdir) as td:
        ck = Path(td) / "ck"

        def killer():
            while not sorted(ck.glob("step_*")):
                time.sleep(0.005)
            os.kill(os.getpid(), signal.SIGTERM)

        threading.Thread(target=killer, daemon=True).start()
        if run_sweep(ck, specs, chunk_size, device=device, backup=backup) is not None:
            raise RuntimeError("expected the sweep to be preempted")
        committed = len(sorted(ck.glob("step_*")))
        print(f"progress on disk: {committed} committed chunk(s)")
        resumed = run_sweep(ck, specs, chunk_size, device=device, backup=backup)
        ref = run_sweep(Path(td) / "ref", specs, chunk_size, device=device,
                        backup=backup)
        same = all(
            np.array_equal(a.rvi.policy, b.rvi.policy) and a.rvi.g == b.rvi.g
            and np.array_equal(a.rvi.h, b.rvi.h)
            for a, b in zip(resumed, ref)
        )
        print(f"resumed == uninterrupted (bitwise): {same}")

        # the serving-side counterpart: a killed stream resumes exactly
        b_max = 16
        svc = ServiceModel(latency=GOOGLENET_P4_LATENCY, family="det")
        means = np.array(
            [0.0] + [float(svc.mean(b)) for b in range(1, b_max + 1)]
        )
        lam = 2 * 0.7 * b_max / float(svc.mean(b_max))
        tr = np.cumsum(np.random.default_rng(0).exponential(1.0 / lam, 4000))
        tabs = np.stack([q_policy(q, 96, b_max) for q in (4, 8)])
        kw = dict(router="jsq", means=means, b_max=b_max, slo=3.0, device=device)
        one = FleetStream(tabs, **kw)
        for lo in range(0, len(tr), 500):
            one.push(tr[lo:lo + 500])
        one.finish()
        fs = FleetStream(tabs, **kw)
        for lo in range(0, 2000, 500):
            fs.push(tr[lo:lo + 500])
        fs.save(Path(td) / "stream")  # ... the process dies here ...
        back = FleetStream.resume(Path(td) / "stream", device=device)
        for lo in range(2000, len(tr), 500):
            back.push(tr[lo:lo + 500])
        back.finish()
        ra, rb = back.report(), one.report()
        stream_same = all(ra[k] == rb[k] or np.isnan(ra[k]) for k in ra)
        print(
            f"stream resume == one-shot: {stream_same} "
            f"(P95 {ra['P95']:.3f}, n_epochs {back.n_epochs})"
        )
    return dict(same=same, committed=committed, resumed=resumed, ref=ref,
                stream_same=stream_same)


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=None, help="checkpoint directory")
    ap.add_argument("--chunk-size", type=int, default=4)
    ap.add_argument("--n", type=int, default=24, help="grid size")
    ap.add_argument("--backup", choices=("banded", "pallas"), default="banded")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the kernels' plain versions)")
    ap.add_argument(
        "--self-preempt", action="store_true",
        help="demo: SIGTERM self after first chunk, resume, verify",
    )
    args = ap.parse_args(argv)
    if args.self_preempt:
        return self_preempt_demo(args.chunk_size, device=args.device,
                                 backup=args.backup)
    ckpt = args.ckpt or os.path.join(tempfile.gettempdir(), "resume_sweep_ck")
    print(f"checkpointing to {ckpt}")
    return run_sweep(ckpt, build_grid(args.n), args.chunk_size,
                     device=args.device, backup=args.backup)


if __name__ == "__main__":
    main()
