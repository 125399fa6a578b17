"""A/B timing of two checkouts of the port's attention backward kernel on one
CUDA card, causal and unmasked -- what both versions compute -- at the
shapes chip_smoke.py's phase 4j times (BWD_PATH, BWD_OTHER: the training
path's b 8 x 256, 8 / 4 x 64 in f32, Qwen2.5-32B's 40 / 8 x 128 and
Zamba2's 32 / 32 x 64 in bf16), imported from it so the two cannot drift.
Each checkout's ``src/`` runs in a fresh child process, in the order old,
new, new, old, so drift on the card shows.  Times: device time in a CUDA
graph of back-to-back calls (best of 3 replays); each child also holds its
kernel to flash_attention_bwd_ref (max abs error over each gradient's
largest |entry|) and prints ptxas's lines for the source.

    python3 tools/attn_bwd_ab.py OLD/src NEW/src

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
from repro_torch.kernels import _build, flash_attention as fa, flash_attention_bwd as fb
from chip_smoke import BWD_OTHER, BWD_PATH

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

rows = {}
for B, S, H, KV, D, dt in [BWD_PATH] + BWD_OTHER:
    gen = torch.Generator(device="cuda").manual_seed(S + H)
    dtype = getattr(torch, dt)
    q, do = (torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn((B, S, KV, D), generator=gen, device="cuda").to(dtype) for _ in range(2))
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    fn = lambda: fb.flash_attention_bwd(q, k, v, out, lse, do)
    got, want = fn(), fb.flash_attention_bwd_ref(q, k, v, do)
    err = max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
              for a, b in zip(got, want))
    rows[f"{B}x{S} {H}/{KV}x{D} {dt}"] = dict(graph_ms=graph_ms(fn, 20), rel_err=err)
ptxas = [ln.strip() for ln in _build.build_logs.get("flash_attention_bwd", "").splitlines()
         if "registers" in ln or "spill" in ln]
print("AB " + json.dumps(dict(rows=rows, ptxas=ptxas)))
'''


def run(tag, src):
    r = subprocess.run([sys.executable, "-c", CHILD, src, ROOT], capture_output=True,
                       text=True, timeout=900)
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
