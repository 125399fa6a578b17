"""A/B timing of two checkouts of the port on one CUDA card: the belief
kernel at the bursty batch's shape (chip_smoke.py's phase 4f batch: 6
MMPP2 traces, seeds 100-105, 40 000 ms) on its own traces and where pass B
folds chunks exactly (times rounded to 1 ms through a filter whose E(0)
rounds below zero; a 3-phase cycle), and the MMPP sampler at 6 x 24 655
steps.  Each checkout's ``src/`` runs in a fresh child process, in the
order old, new, new, old, so drift on the card shows.  Times: CUDA events
around one call (best of 3) and device time in a CUDA graph of 5 calls.

    python3 tools/belief_mmpp_ab.py OLD/src NEW/src

Prints one JSON line a child, then the card's name and power limit."""
import json
import subprocess
import sys

CHILD = r'''
import json, sys, time
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from repro_torch.configs.googlenet_p4 import B_MAX as BM, service
from repro_torch.kernels import belief_forward as bf, mmpp_sample as mk
from repro_torch.serving import PhaseBeliefFilter, pad_arrivals_batch
from repro_torch.core import PhaseConfig
from repro_torch.serving.arrivals import MMPP2

def event_ms(fn, reps=3):
    fn(); torch.cuda.synchronize(); best = float("inf")
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True); b = torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record(); b.synchronize(); best = min(best, a.elapsed_time(b))
    return best

def graph_ms(fn, reps):
    side = torch.cuda.Stream(); side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3): fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps): fn()
    g.replay(); torch.cuda.synchronize(); best = float("inf")
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True); b = torch.cuda.Event(enable_timing=True)
        a.record(); g.replay(); b.record(); b.synchronize()
        best = min(best, a.elapsed_time(b) / reps)
    return best

def unsafe_count(times, b_init, t, c):
    """Chunks folded exactly in pass B; None for a kernel without the count."""
    if hasattr(bf, "_launch"):
        return int(bf._launch(times, b_init, t, c, bf.CHUNK)[3].sum())
    try:  # an interim version returned the count through stats=
        st = {}
        bf.belief_forward(times, b_init, t, c, stats=st)
        return int(st["unsafe_chunks"].sum())
    except TypeError:
        return None

svc = service(); mu_max = BM / float(svc.mean(BM))
m = MMPP2(lam1=0.08 * mu_max, lam2=0.85 * mu_max, dwell1=4000.0, dwell2=800.0)
ph = PhaseConfig.from_mmpp(m)
traces = [np.asarray(m.sample_arrivals(40_000.0, np.random.default_rng(100 + s))[0]) for s in range(6)]
arrs = pad_arrivals_batch(traces)
f2 = PhaseBeliefFilter(ph.rates, ph.gen)
a3 = 1 / 300
f3 = PhaseBeliefFilter([0.3, 1.1, 2.6], [[-a3, a3, 0.0], [0.0, -a3, a3], [a3, 0.0, -a3]])
ft = PhaseBeliefFilter([0.26, 2.79], [[-1 / 4000, 1 / 4000], [1 / 800, -1 / 800]])
r = np.round(arrs)
out = {}
for name, filt, x in (("path", f2, arrs), ("rounded_to_1ms", f2, r),
                      ("rounded_to_1ms_test_filter", ft, r), ("k3_cycle", f3, arrs),
                      ("k3_cycle_rounded_to_1ms", f3, r)):
    times = torch.as_tensor(x, device="cuda"); b_init = torch.as_tensor(filt.belief, device="cuda")
    c = filt.consts(torch.device("cuda"))
    fn = lambda: bf.belief_forward(times, b_init, filt._last, c)
    got = fn()
    want = bf.belief_forward_ref(times[:, :2048].contiguous(), b_init, filt._last, c)
    err = (got[0][:, :2048] - want[0]).abs().max().item()
    out[name] = dict(event_ms=event_ms(fn), graph_ms=graph_ms(fn, 5),
                     unsafe=unsafe_count(times, b_init, filt._last, c), err_prefix=err,
                     shape=list(x.shape))
g = torch.Generator(device="cuda"); g.manual_seed(17)
n_steps = 24655
draws = torch.empty((6, 1 + 2 * n_steps), dtype=torch.float64, device="cuda").exponential_(generator=g)
fn = lambda: mk.mmpp_sample(draws, (m.lam1, m.lam2), (m.dwell1, m.dwell2))
out["mmpp_sample"] = dict(event_ms=event_ms(fn), graph_ms=graph_ms(fn, 5))
print("AB " + json.dumps(out))
'''

for tag, src in (("old", sys.argv[1]), ("new", sys.argv[2]), ("new", sys.argv[2]),
                 ("old", sys.argv[1])):
    r = subprocess.run([sys.executable, "-c", CHILD, src], capture_output=True, text=True, timeout=600)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("AB ")]
    if r.returncode or not line:
        print(tag, "FAILED", r.returncode, r.stderr[-4000:])
        continue
    print(tag, line[0][3:], flush=True)
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip())
