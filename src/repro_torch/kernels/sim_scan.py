"""The independent queue simulator's walk: its wrapper and plain version.

One lane walks E decision epochs of the batch-service queue under a
policy table ``pol`` (P,) from an empty queue at t = 0:

    a = pol[min(s, P - 1)];  a = 0 if a > s
    a == 0:  dt = arr[cur] / lam (cur += 1); one arrival at t + dt joins
             the FIFO; integral += s * dt; t += dt
    a >  0:  T = service(a, svc[epoch]); t' = t + T; the a oldest requests
             leave with responses t' - (arrival time); then arrivals land at
             offsets c_1 = arr[cur] / lam, c_{j+1} = c_j + arr[cur + j] / lam
             while c < T; a (k_max + 1)-th that would land at tau counts
             one clip, ends the run and moves the k_max kept to (c_j /
             tau) * T (the reference's law: given tau, the c_j / tau are
             sorted uniforms); the draw that passes T is consumed and
             discarded; integral += s * T + sum_j (T - c_j); energy +=
             en[a]; t = t'
    s += arrivals - a

``service``: det ``means[a]``; expo ``means[a] * e``; erlang
``(means[a] / k) * (e_1 + ... + e_k)``; hyperexpo ``(means[a] *
scales[c]) * e``; atoms ``means[a] * scales[c]``, where the component c
is the first j with ``u < cum[j]`` (the last if none) for the epoch's
uniform u.  ``svc`` holds each epoch's unit draws, (E, W) per lane: W = 0,
1, k, 2 (u, e) and 1 (u).  The FIFO is a ring of BUF = 2^15 arrival
times, read before the epoch's arrivals are written, as the reference's
carried buffer is; a lane whose arrival stream runs out stops at that
epoch and the wrapper raises.

This is the ``step`` of the reference's ``simulate`` (src/repro/core/
simulate.py:169-232) with its ``jax.random`` draws replaced by shared
streams of standard variates, so the kernel ``csrc/sim_scan.cu`` and this
plain walk read the same numbers and agree in every output.  The kernel
runs a block a lane: one thread walks, a stager warp divides the gaps
and folds the service draws ahead of it, a responder warp writes the
responses; ``smem_bytes`` mirrors the block's shared memory (the policy
table is its only part that grows).  ``check_smem`` refuses a table above
``MAX_SMEM_BYTES``, runs of more than ``MAX_K_MAX`` kept arrivals and
streams of 2^30 draws or epochs.  Draws given as CPU tensors run the plain version; CUDA
tensors launch the kernel or raise.  ``sim_scan.launches`` counts
launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..device import refuse_grad
from . import _build

BUF_LOG2 = 15
BUF = 1 << BUF_LOG2
#: service families, as the kernel's codes
FAMILIES = ("det", "expo", "erlang", "hyperexpo", "atoms")
#: the shared memory a block may use (H100: 227 KB)
MAX_SMEM_BYTES = 227 * 1024
#: the kernel's staging chunks (gaps; epochs' service factors; two buffers
#: each), its arrival buffer and its ring of serve records (csrc/sim_scan.cu)
_GAP_CHUNK, _EP_CHUNK, _RING = 1024, 512, 64
#: a run of kept arrivals lives in the kernel's arrival buffer until the
#: responder has written it to the ring: at most this many a serve
MAX_K_MAX = 4096


def smem_bytes(P: int, n_means: int, C: int) -> int:
    """A block's dynamic shared memory, region by region as the kernel's
    ``layout`` lays it out, each 16-byte aligned: the counters, the gap and
    service-factor windows, the arrival buffer, the record ring, then the
    tables (means, energies, means / k, the mixture's cum and scales, the
    int32 policy)."""
    regions = [8 * 2 * _GAP_CHUNK, 16 * 2 * _EP_CHUNK, 8 * MAX_K_MAX,
               8 * _RING, 8 * _RING, 8 * _RING, 8 * n_means, 8 * n_means, 8 * n_means,
               8 * C, 8 * C, 4 * _RING, 4 * _RING, 4 * _RING, 4 * _RING, 4 * P]
    return 64 + sum((r + 15) // 16 * 16 for r in regions)


def check_smem(P: int, n_means: int, C: int, A: int = 1, E: int = 1,
               k_max: int = 1) -> int:
    """The block's shared memory for a P-state policy; raises above
    ``MAX_SMEM_BYTES`` (the kernel keeps the whole table on chip), for
    streams of 2^30 draws or epochs (the kernel counts them in int32) and
    for runs longer than ``MAX_K_MAX`` (min(k_max, A) kept arrivals)."""
    if max(A, E, P) >= 2 ** 30:
        raise ValueError("the simulator kernel takes fewer than 2^30 arrival draws, "
                         "epochs and policy states")
    if min(k_max, A) > MAX_K_MAX:
        raise ValueError(f"k_max {k_max}: the simulator kernel keeps at most "
                         f"{MAX_K_MAX} arrivals of a run on chip")
    n = smem_bytes(P, n_means, C)
    if n > MAX_SMEM_BYTES:
        raise ValueError(f"a policy of {P} states needs {n} B of shared memory a lane, "
                         f"above {MAX_SMEM_BYTES}")
    return n


class SimOut(NamedTuple):
    """Per-lane outputs.  ``resp`` (L, R) holds each lane's ``n_served``
    responses in service order (the rest is scratch); ``exhausted`` is the
    epoch at which a lane's arrival stream ran out, -1 if it did not."""

    acts: torch.Tensor  # (L, E) int32
    resp: torch.Tensor  # (L, R) f64
    t: torch.Tensor  # (L,) f64
    qint: torch.Tensor  # (L,) f64
    energy: torch.Tensor  # (L,) f64
    n_served: torch.Tensor  # (L,) int64
    clipped: torch.Tensor  # (L,) int64
    consumed: torch.Tensor  # (L,) int64 arrival draws read
    exhausted: torch.Tensor  # (L,) int64


def _check(pol, means, en, cum, scales, svc, arr, fam, erlang_k, R):
    if fam not in range(len(FAMILIES)):
        raise ValueError(f"family code {fam} not in 0..{len(FAMILIES) - 1}")
    dev = arr.device
    for name, x, dt in (("pol", pol, torch.int64), ("means", means, torch.float64),
                        ("en", en, torch.float64), ("cum", cum, torch.float64),
                        ("scales", scales, torch.float64), ("svc", svc, torch.float64),
                        ("arr", arr, torch.float64)):
        if not isinstance(x, torch.Tensor) or x.dtype != dt:
            raise TypeError(f"{name} must be a {dt} tensor")
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, arr on {dev}")
    if pol.dim() != 1 or len(pol) == 0:
        raise ValueError("pol must be a non-empty 1-d table")
    if arr.dim() != 2 or svc.dim() != 3 or svc.shape[0] != arr.shape[0]:
        raise ValueError("arr must be (L, A) and svc (L, E, W) with the same L")
    if len(cum) != len(scales) or len(cum) == 0:
        raise ValueError("cum and scales must be non-empty and aligned")
    W = svc.shape[2]
    want = {0: 0, 1: 1, 2: erlang_k, 3: 2, 4: 1}[fam]
    if W < want:
        raise ValueError(f"{FAMILIES[fam]} service needs {want} draws an epoch, got {W}")
    a_max = int(pol.max())
    if a_max >= len(means) or len(en) != len(means) or int(pol.min()) < 0:
        raise ValueError("pol's actions must index means / en")
    if R < svc.shape[1] * a_max:
        raise ValueError(f"response room {R} < epochs x largest action")


def sim_scan_ref(pol, means, en, cum, scales, svc, arr, *, fam: int, erlang_k: int,
                 lam: float, k_max: int, R: int) -> SimOut:
    """Plain version: the walk in Python floats on the host, a lane at a
    time (every operation one IEEE double rounding, in the kernel's
    order).  Takes CPU tensors only."""
    if arr.device.type != "cpu":
        raise ValueError("the plain walk takes CPU tensors")
    _check(pol, means, en, cum, scales, svc, arr, fam, erlang_k, R)
    L, E = svc.shape[0], svc.shape[1]
    polv, mv, ev = pol.tolist(), means.tolist(), en.tolist()
    cumv, scv = cum.tolist(), scales.tolist()
    P, C, lam = len(polv), len(cumv), float(lam)

    def comp(u):
        j = 0
        while j < C - 1 and not (u < cumv[j]):
            j += 1
        return j

    acts = torch.zeros((L, E), dtype=torch.int32)
    resp = torch.zeros((L, R), dtype=torch.float64)
    fo = torch.zeros((L, 3), dtype=torch.float64)
    io = torch.zeros((L, 4), dtype=torch.int64)
    for ln in range(L):
        sd_all, ar = svc[ln].tolist(), arr[ln].tolist()
        A = len(ar)
        ring = [0.0] * BUF
        av, rv = [0] * E, []
        s = head = tail = cur = clipped = 0
        exhausted = -1
        t = qint = energy = 0.0
        for ep in range(E):
            a = polv[s if s < P - 1 else P - 1]
            if a > s:
                a = 0
            if a == 0:
                if cur >= A:
                    exhausted = ep
                    break
                dt = ar[cur] / lam
                cur += 1
                t_next = t + dt
                ring[tail] = t_next
                tail = (tail + 1) & (BUF - 1)
                qint = qint + float(s) * dt
                s += 1
                t = t_next
                continue
            sd = sd_all[ep]
            m = mv[a]
            if fam == 0:
                T = m
            elif fam == 1:
                T = m * sd[0]
            elif fam == 2:
                gam = sd[0]
                for j in range(1, erlang_k):
                    gam = gam + sd[j]
                T = (m / float(erlang_k)) * gam
            elif fam == 3:
                T = (m * scv[comp(sd[0])]) * sd[1]
            else:
                T = m * scv[comp(sd[0])]
            t_next = t + T
            for j in range(a):
                rv.append(t_next - ring[(head + j) & (BUF - 1)])
            head = (head + a) & (BUF - 1)
            first = cur
            c = contrib = 0.0
            n = 0
            out = False
            while True:
                if cur >= A:
                    out = True
                    break
                c = c + ar[cur] / lam
                cur += 1
                if not (c < T):
                    break
                if n == k_max:  # clipped at tau = c: redo the kept k_max
                    clipped += 1
                    tau, cj, contrib = c, 0.0, 0.0
                    for j in range(n):
                        cj = cj + ar[first + j] / lam
                        off = (cj / tau) * T
                        ring[(tail + j) & (BUF - 1)] = t + off
                        contrib = contrib + (T - off)
                    break
                ring[(tail + n) & (BUF - 1)] = t + c
                contrib = contrib + (T - c)
                n += 1
            if out:
                exhausted = ep
                break
            tail = (tail + n) & (BUF - 1)
            qint = qint + (float(s) * T + contrib)
            energy = energy + ev[a]
            s = s - a + n
            t = t_next
            av[ep] = a
        acts[ln] = torch.tensor(av, dtype=torch.int32)
        resp[ln, :len(rv)] = torch.tensor(rv, dtype=torch.float64)
        fo[ln] = torch.tensor([t, qint, energy], dtype=torch.float64)
        io[ln] = torch.tensor([len(rv), clipped, cur, exhausted])
    return SimOut(acts, resp, fo[:, 0], fo[:, 1], fo[:, 2], io[:, 0], io[:, 1],
                  io[:, 2], io[:, 3])


def sim_scan(pol, means, en, cum, scales, svc, arr, *, fam: int, erlang_k: int,
             lam: float, k_max: int, R: int) -> SimOut:
    """The walk of L lanes: ``pol`` (P,) int64, ``means`` / ``en`` (b_max +
    1,) f64, ``cum`` / ``scales`` (C,) f64 (the mixture's cumulative
    weights and scales), ``svc`` (L, E, W) f64 unit service draws, ``arr``
    (L, A) f64 unit exponentials; ``R`` response slots a lane (at least E
    times the largest action).  Outputs on the draws' device."""
    if arr.device.type == "cpu":
        return sim_scan_ref(pol, means, en, cum, scales, svc, arr, fam=fam,
                            erlang_k=erlang_k, lam=lam, k_max=k_max, R=R)
    if arr.device.type != "cuda":
        raise ValueError(f"unsupported device {arr.device}")
    refuse_grad("sim_scan", means, en, cum, scales, svc, arr)
    _check(pol, means, en, cum, scales, svc, arr, fam, erlang_k, R)
    dev = arr.device
    L, E, W = svc.shape
    smem = check_smem(len(pol), len(means), len(cum), arr.shape[1], E, int(k_max))
    tensors = [x.contiguous() for x in (pol, means, en, cum, scales, svc, arr)]
    pol, means, en, cum, scales, svc, arr = tensors
    ring = torch.zeros((L, BUF), dtype=torch.float64, device=dev)
    acts = torch.zeros((L, E), dtype=torch.int32, device=dev)  # a stopped lane leaves 0s
    resp = torch.empty((L, R), dtype=torch.float64, device=dev)
    fo = torch.empty((L, 3), dtype=torch.float64, device=dev)
    io = torch.empty((L, 4), dtype=torch.int64, device=dev)
    vp, ll, dbl = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double
    built = _build.function("sim_scan", "sim_scan_smem_bytes", ll, [ll, ll, ll])(
        len(pol), len(means), len(cum))
    if built != smem:
        raise RuntimeError(f"sim_scan.cu lays out {built} B of shared memory, "
                           f"the wrapper {smem}")
    fn = _build.function("sim_scan", "sim_scan_launch", ctypes.c_int,
                         [vp, ll, vp, ll, vp, ctypes.c_int, ll, vp, vp, ll, vp, ll, vp,
                          ll, dbl, ll, ll, ll, ll, vp, vp, vp, vp, vp, vp])
    rc = fn(pol.data_ptr(), len(pol), means.data_ptr(), len(means), en.data_ptr(), int(fam),
            int(erlang_k), cum.data_ptr(), scales.data_ptr(), len(cum), svc.data_ptr(),
            W, arr.data_ptr(), arr.shape[1], float(lam), int(k_max), E, L, int(R),
            ring.data_ptr(), acts.data_ptr(), resp.data_ptr(), fo.data_ptr(),
            io.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sim_scan launch failed: CUDA error {rc}")
    sim_scan.launches += 1
    return SimOut(acts, resp, fo[:, 0], fo[:, 1], fo[:, 2], io[:, 0], io[:, 1],
                  io[:, 2], io[:, 3])


sim_scan.launches = 0
