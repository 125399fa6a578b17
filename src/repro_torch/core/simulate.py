"""Simulation of the batch-service queue: two paths, one queue semantics.

Simulates the exact SMDP dynamics epoch by epoch (decision epochs =
service completions, or arrivals while idle) under an arbitrary policy
table, and records *per-request* response times, so that latency CDFs /
percentiles (paper Fig. 6, Table I) can be measured -- the analytic
evaluator only gives averages.

Entry points:
  * simulate()        -- the independent cross-check of the serving engine
    for Poisson arrivals: arrivals are drawn *during* service, the request
    FIFO is a ring of BUF times, the queue-length integral is exact (the
    l_bar time-integral reference).  One launch of the simulator kernel
    (kernels/sim_scan.py, the reference's ``lax.scan``) walks it.
  * simulate_events() -- the general path for any arrival process (MMPP,
    traces, ...): a thin wrapper over the port's serving engine, so the
    event-driven queue semantics exists once in the port.
    ``backend="compiled"`` routes it through the event kernel.

Random draws.  ``simulate`` draws standard variates up front from one
``torch.Generator`` on the device (seeded by ``seed``) -- the kernel cannot
replay ``jax.random``, and the kernel and its plain walk must read the
same numbers.  Two streams a run:

  * service: (n_epochs, W) unit draws an epoch (det none, expo one
    exponential, erlang k exponentials, hyperexpo a uniform and an
    exponential, atoms a uniform), read at the epoch's index;
  * arrivals: one flat stream of unit exponentials read through a cursor.
    A wait epoch takes one (its gap); a service of length T takes gaps at
    rate lam summed until they pass T -- the count and the sorted offsets
    of the Poisson arrivals in T at once, in the reference's law (the
    Poisson process restarts at every epoch), with no sort and no Poisson
    inversion -- plus the one that passes T, which is discarded.

Sizing rule for the arrival stream: an epoch takes N + 1 draws with N the
arrivals in its service, so E[N + 1] <= 1 + lam m and E[(N + 1)^2] <= 1 +
3 lam m + lam^2 m2, where m and m2 are the largest mean and second moment
of a service the table can choose.  The stream holds n (1 + lam m) + 8
sqrt(n (1 + 3 lam m + lam^2 m2)) + 64 draws (eight standard deviations
over the mean consumption; never more than the n (k_max + 1) an epoch
can take).  A run that would outrun it raises RuntimeError: nothing
wraps.

With more than ``k_max`` arrivals in one service, k_max are kept and the
run counts one clip (``n_clipped_arrivals``), as the reference counts a
Poisson draw clipped at k_max.  The kept arrivals follow the reference's
law, k_max sorted uniforms over the service: the first k_max offsets are
rescaled by T / tau, tau the offset of the (k_max + 1)-th arrival (given
tau, the first k_max arrival times over tau are sorted uniforms), with no
extra draws.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels import sim_scan as _sim
from .service_models import ServiceModel

BUF_LOG2 = _sim.BUF_LOG2
BUF = _sim.BUF  # circular arrival-time buffer (plenty for stable queues)


@dataclasses.dataclass
class SimResult:
    response_times: np.ndarray  # (n_samples,) per-request response times
    w_bar: float  # mean response time
    p_bar: float  # energy / time
    l_bar: float  # time-average queue length (includes in-service)
    total_time: float
    n_served: int
    n_clipped_arrivals: int  # diagnostics: services with more than k_max arrivals

    def percentile(self, q) -> np.ndarray:
        return np.percentile(self.response_times, q)


def simulate_events(
    policy_table: np.ndarray,
    service: ServiceModel,
    energy_table: np.ndarray,
    arrivals,  # rate / MMPP2 / trace / ArrivalProcess (serving.arrivals)
    b_max: int,
    n_epochs: Optional[int] = 100_000,
    horizon: Optional[float] = None,
    seed: int = 0,
    backend: str = "python",
    *,
    device: DeviceLike = None,
) -> SimResult:
    """General event-driven simulation via the serving engine.

    Same decision-epoch semantics as simulate(), but arrivals come from any
    serving.arrivals.ArrivalProcess instead of being fixed to Poisson, and
    the queue loop is the serving engine's -- not a duplicate.  l_bar is
    exact by Little's law on the served set.  ``backend="compiled"`` runs
    the event kernel instead of the Python loop (identical decisions) on
    ``device`` (CUDA unless ``device="cpu"``).
    """
    from ..serving.arrivals import as_process
    from ..serving.engine import ServingEngine
    from ..serving.scheduler import SMDPScheduler

    eng = ServingEngine(
        SMDPScheduler.from_table(policy_table),
        arrivals=as_process(arrivals),
        b_max=b_max,
        service=service,
        energy_table=energy_table,
        seed=seed,
        device=device,
    )
    rep = eng.run(n_epochs=n_epochs, horizon=horizon, backend=backend)
    lat_sum = float(rep.latencies.sum())
    return SimResult(
        response_times=rep.latencies,
        w_bar=float(rep.latencies.mean()) if rep.n_served else float("nan"),
        p_bar=rep.power,
        l_bar=lat_sum / rep.span if rep.span > 0 else float("nan"),
        total_time=rep.span,
        n_served=rep.n_served,
        n_clipped_arrivals=0,
    )


def service_params(service: ServiceModel, b_max: int):
    """(family code, erlang k, draws an epoch W, means (b_max + 1,), mixture
    cumulative weights, mixture scales) of a service model, as the
    simulator kernel takes them (kernels/sim_scan.py)."""
    means = np.array([0.0] + [float(service.mean(b)) for b in range(1, b_max + 1)])
    fam = service.family
    if fam not in _sim.FAMILIES:
        raise ValueError(fam)
    code = _sim.FAMILIES.index(fam)
    cum, scales = np.ones(1), np.ones(1)
    if fam in ("hyperexpo", "atoms"):
        w = np.asarray(service.hyper_weights if fam == "hyperexpo"
                       else service.atom_weights, dtype=np.float64)
        s = np.asarray(service.hyper_scales if fam == "hyperexpo"
                       else service.atom_scales, dtype=np.float64)
        scales = s / float(np.sum(w * s))
        cum = np.cumsum(w / w.sum())
    k = int(service.erlang_k) if fam == "erlang" else 1
    W = {"det": 0, "expo": 1, "erlang": k, "hyperexpo": 2, "atoms": 1}[fam]
    return code, k, W, means, cum, scales


def arrival_stream_size(n_epochs: int, lam: float, m: float, m2: float,
                        k_max: int) -> int:
    """Draws the arrival stream holds (the module docstring's rule)."""
    mean = n_epochs * (1.0 + lam * m)
    sd = math.sqrt(n_epochs * (1.0 + 3.0 * lam * m + lam * lam * m2))
    return int(min(n_epochs * (k_max + 1), math.ceil(mean + 8.0 * sd + 64)))


def simulate_inputs(
    policy_table: np.ndarray,
    service: ServiceModel,
    energy_table: np.ndarray,
    lam: float,
    b_max: int,
    n_epochs: int = 100_000,
    seed=0,
    k_max: Optional[int] = None,
    *,
    device: DeviceLike = None,
):
    """The simulator kernel's inputs for a run of `simulate`: (args, kw) of
    ``kernels.sim_scan.sim_scan`` -- the table, the service constants and
    the two draw streams, made on ``device`` from ``seed`` (a seed, or a
    ``torch.Generator`` there)."""
    dev = resolve_device(device)
    if k_max is None:
        mean_arr = lam * float(service.mean(b_max))
        k_max = int(max(64, 8 * mean_arr))
    pol = np.asarray(policy_table, dtype=np.int64)
    en = np.asarray(energy_table, dtype=np.float64)
    if pol.ndim != 1 or len(pol) == 0:
        raise ValueError("policy_table must be a non-empty (L,) table")
    if pol.min() < 0 or pol.max() > b_max or len(en) != b_max + 1:
        raise ValueError("actions must lie in 0..b_max and energy_table have b_max + 1 entries")
    fam, k, W, means, cum, scales = service_params(service, b_max)
    served = sorted({int(a) for a in pol if a > 0}) or [1]
    m = max(float(service.mean(a)) for a in served)
    m2 = max(float(service.second_moment(a)) for a in served)
    A = arrival_stream_size(int(n_epochs), float(lam), m, m2, int(k_max))
    if isinstance(seed, torch.Generator):
        if seed.device.type != dev.type:
            raise ValueError(f"generator on {seed.device}, simulating on {dev}")
        g = seed
    else:
        g = torch.Generator(device=dev)
        g.manual_seed(int(seed))
    E = int(n_epochs)
    f64 = dict(dtype=torch.float64, device=dev)
    exp = lambda shape: torch.empty(shape, **f64).exponential_(generator=g)  # noqa: E731
    unif = lambda shape: torch.rand(shape, generator=g, **f64)  # noqa: E731
    if service.family == "hyperexpo":
        svc = torch.stack([unif((1, E)), exp((1, E))], dim=-1)
    elif service.family == "atoms":
        svc = unif((1, E, 1))
    else:
        svc = exp((1, E, W))
    arr = exp((1, A))
    t = lambda x, dt=torch.float64: torch.as_tensor(x, dtype=dt, device=dev)  # noqa: E731
    args = (t(pol, torch.int64), t(means), t(en), t(cum), t(scales), svc, arr)
    kw = dict(fam=fam, erlang_k=k, lam=float(lam), k_max=int(k_max),
              R=E * max(int(pol.max()), 1))
    return args, kw


def sim_result(out, lane: int = 0) -> SimResult:
    """A SimResult from one lane of the simulator kernel's outputs; raises
    if the lane's arrival stream ran out."""
    exhausted = int(out.exhausted[lane])
    if exhausted >= 0:
        raise RuntimeError(
            f"simulate: the arrival stream ran out at epoch {exhausted} (after "
            f"{int(out.consumed[lane])} draws); the sizing rule was outrun"
        )
    n = int(out.n_served[lane])
    samples = out.resp[lane, :n].cpu().numpy()
    total_time = float(out.t[lane])
    return SimResult(
        response_times=samples,
        w_bar=float(samples.mean()) if n else float("nan"),
        p_bar=float(out.energy[lane]) / total_time,
        l_bar=float(out.qint[lane]) / total_time,
        total_time=total_time,
        n_served=n,
        n_clipped_arrivals=int(out.clipped[lane]),
    )


def simulate(
    policy_table: np.ndarray,  # (L,) action per state; s >= L uses last entry
    service: ServiceModel,
    energy_table: np.ndarray,  # (b_max + 1,) zeta(a), zeta(0) = 0
    lam: float,
    b_max: int,
    n_epochs: int = 100_000,
    seed=0,
    k_max: Optional[int] = None,
    *,
    device: DeviceLike = None,
) -> SimResult:
    """Run the queue for n_epochs decision epochs under `policy_table`.

    One launch of the simulator kernel on ``device`` (CUDA unless
    ``device="cpu"``, which runs its plain walk); ``seed`` seeds the
    ``torch.Generator`` the draws come from (or is one, on ``device``).
    """
    args, kw = simulate_inputs(policy_table, service, energy_table, lam, b_max,
                               n_epochs, seed, k_max, device=device)
    return sim_result(_sim.sim_scan(*args, **kw))
