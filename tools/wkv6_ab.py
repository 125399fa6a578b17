"""A/B timing of two checkouts of the port's WKV6 scan kernel on one CUDA
card, at RWKV6-3B's heads (40 x 64): the serving path's prefill (b 8 x 128)
and decode step (b 8 x 1), and a long prefill (b 1 x 2048), each in bf16
and f32, the state handed in as the cache hands it.  Each checkout's
``src/`` runs in a fresh child process, in the order old, new, new, old,
so drift on the card shows.  Times: CUDA events around one call (best of
3) and device time in a CUDA graph of back-to-back calls, beside the bound
that chip_smoke.py's wkv_work and bound reckon (imported from it, so the
two cannot drift); each child also holds its kernel to wkv6_scan_ref (max
abs error over the output's largest |entry|) and prints ptxas's lines for
the source.

    python3 tools/wkv6_ab.py OLD/src NEW/src

Prints one JSON line a child, then the card's name and power limit."""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r'''
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, sys.argv[2])
from repro_torch.kernels import _build, wkv6_scan as wk
from chip_smoke import F32_FLOPS, bound, wkv_work
H, P = 40, 64
SHAPES = [(8, 128, "bfloat16", 50), (8, 128, "float32", 50), (8, 1, "bfloat16", 200),
          (8, 1, "float32", 200), (1, 2048, "bfloat16", 10), (1, 2048, "float32", 10)]

def inputs(B, S, dtype):
    gen = torch.Generator(device="cuda").manual_seed(31)
    f = dict(dtype=torch.float32, device="cuda", generator=gen)
    r, k, v = (torch.randn((B, S, H, P), **f).mul_(0.5).to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(torch.rand((B, S, H, P), **f).mul_(11.0).sub_(9.0)))
    u = torch.randn((H, P), **f).mul_(0.5)
    return r, k, v, w, u, torch.randn((B, H, P, P), **f).mul_(0.5)

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

def bound_ms(B, S, item):
    ops, nbytes = wkv_work(B, S, H, P, item, True)
    return bound(nbytes, ops, F32_FLOPS)[0]

out, rows = {}, {}
for B, S, dt, reps in SHAPES:
    args = inputs(B, S, getattr(torch, dt))
    fn = lambda: wk.wkv6_scan(*args)
    y, st = fn()
    y_ref, st_ref = wk.wkv6_scan_ref(*args)
    err = max(((a - b).abs().max() / b.abs().max()).item() for a, b in ((y, y_ref), (st, st_ref)))
    rows[f"{B}x{S} {dt}"] = dict(event_ms=event_ms(fn), graph_ms=graph_ms(fn, reps),
                                 bound_ms=bound_ms(B, S, args[0].element_size()),
                                 rel_err=err)
out["rows"] = rows
out["ptxas"] = [ln.strip() for ln in _build.build_logs.get("wkv6_scan", "").splitlines()
                if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
print("AB " + json.dumps(out))
'''


def run(tag, src):
    r = subprocess.run([sys.executable, "-c", CHILD, src, ROOT], capture_output=True,
                       text=True, timeout=600)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("AB ")]
    if r.returncode or not line:
        print(tag, "FAILED", r.returncode, r.stderr[-4000:], flush=True)
        return False
    print(tag, line[0][3:], flush=True)
    return True


def main(argv):
    if len(argv) != 2:
        print(__doc__)
        return 2
    old, new = argv
    ok = run("old", old) & run("new", new) & run("new", new) & run("old", old)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
