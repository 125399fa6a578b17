"""End-to-end LLM serving: a real model behind the SMDP scheduler (the
port of examples/serve_llm.py).

Pipeline:
  1. profile the model: measure wall-clock l(b) for b in 1..b_max on this
     device (one decode segment per service: a prefill of the prompt, then
     gen_tokens - 1 greedy decode steps);
  2. fit the SMDP service model on the measured table and solve it (the
     RVI's Bellman backups on the hand-written kernel, ``backup="pallas"``);
  3. replay one Poisson request stream through the ServingEngine in
     executor (wall-clock) mode, SMDP scheduler vs greedy and static;
  4. report latency percentiles per scheduler.  Energy is a proxy: the
     measured service time x a constant 60 W (nothing here reads a power
     meter).

On the card every prefill goes through the flash-attention kernel and
every decode step through the decode-attention kernel, once per attention
layer (for the Mamba2 hybrid, once per occurrence of its shared block),
each with its layer's sliding window (Gemma2's local layers) or
chunked-local mask (Llama-4's), every step of a hybrid through the SSD
scan kernel once per Mamba2 layer, and every step of an RWKV6 model (it
has no attention) through the WKV6 scan kernel once per layer.  An MoE
layer's experts are batched matmuls (``layers.moe_ffn``).  An
encoder-decoder (Whisper) runs its encoder once a prefill (a flash launch
an encoder layer), and its decoder's cross-attention once a layer a step
(flash in the prefill, decode after); each request carries its stub
frame embeddings, and a VLM's (Qwen2-VL) its stub patch embeddings, which
take the place of the prompt's first ``n_patches`` tokens.

    PYTHONPATH=src python -m repro_torch.launch.serve_llm --device cpu
        [--arch qwen2.5-32b | command-r-plus-104b | gemma2-9b | gemma2-27b
         | llama4-scout-17b-a16e | grok-1-314b | zamba2-1.2b | rwkv6-3b
         | whisper-small | qwen2-vl-7b]
        [--n-requests 120] [--rho 0.6] [--gen-tokens 8]

The CLI runs the arch's ``reduced()`` config in float32, as the example
does; ``run_pipeline`` takes any config the port runs, weights and dtypes.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs import ARCHS
from ..core import ServiceModel, SMDPSpec, TableProfile, solve
from ..core.solve import SolveResult
from ..device import DeviceLike, resolve_device
from ..models import model as M
from ..models.config import ModelConfig
from ..serving import (
    EngineReport,
    GreedyScheduler,
    Request,
    ServingEngine,
    SMDPScheduler,
    StaticScheduler,
)

#: the example's energy proxy: every second of service costs 60 J
POWER_PROXY_W = 60.0


class SegmentExecutor:
    """Runs one decode segment per batch and counts the segments.

    A segment is one prefill of the (b, prompt_len) prompts into a fresh
    cache plus ``gen_tokens - 1`` greedy decode steps, a Python loop.  On
    the card it ends with ``torch.cuda.synchronize()``, so a wall-clock
    timer around it measures the service, not the enqueue.
    """

    def __init__(self, cfg: ModelConfig, params: M.LM, gen_tokens: int,
                 b_max: int, prompt_len: int, cache_dtype: torch.dtype):
        if gen_tokens < 1:
            raise ValueError("gen_tokens must be >= 1")
        self.cfg = cfg
        self.params = params
        self.gen_tokens = gen_tokens
        self.b_max = b_max
        self.prompt_len = prompt_len
        self.cache_dtype = cache_dtype
        self.segments = 0

    def run(self, tokens: torch.Tensor, frames: Optional[torch.Tensor] = None,
            patches: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Greedy tokens (b, gen_tokens) for prompts (b, prompt_len), with an
        encoder-decoder's ``frames`` (b, T, d) or a VLM's ``patches`` (b, n,
        d)."""
        b, s = tokens.shape
        if not 1 <= b <= self.b_max or s != self.prompt_len:
            raise ValueError(f"batch {tuple(tokens.shape)} outside "
                             f"(1..{self.b_max}, {self.prompt_len})")
        cfg, params = self.cfg, self.params
        batch = {"tokens": tokens, "frames": frames, "patches": patches}
        logits, cache = M.prefill(cfg, params, batch,
                                  max_len=self.prompt_len + self.gen_tokens,
                                  cache_dtype=self.cache_dtype)
        tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        out = [tok]
        for _ in range(self.gen_tokens - 1):
            logits, cache = M.decode_step(cfg, params, cache, tok)
            tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
            out.append(tok)
        if tokens.device.type == "cuda":
            torch.cuda.synchronize(tokens.device)
        self.segments += 1
        return torch.cat(out, dim=1)

    def __call__(self, batch: List[Request]) -> None:
        self.run(**stack_payloads([r.payload for r in batch]))


def stack_payloads(payloads: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """One batch from request payloads (``draw_requests``): each input stacked."""
    return {k: torch.stack([p[k] for p in payloads]) for k in payloads[0]}


def draw_requests(cfg: ModelConfig, n: int, prompt_len: int, *, seed: int,
                  device: DeviceLike = None, dtype: torch.dtype = torch.float32
                  ) -> Tuple[List[Dict[str, torch.Tensor]], np.random.Generator]:
    """n request payloads, each a dict of the model's inputs: ``tokens``
    (prompt_len,) from ``np.random.default_rng(seed)``, which comes back to
    draw the arrivals, and the inputs ``M.input_shapes(cfg)`` names (an
    encoder-decoder's frames, a VLM's patches), unit normals in ``dtype``
    from a torch generator of their own seeded with ``seed`` -- so every family's
    prompts and arrivals are the draws they were before frames and patches
    existed."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    payloads = [{"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, prompt_len),
                                           dtype=torch.long, device=dev)}
                for _ in range(n)]
    gen = torch.Generator(device=dev).manual_seed(seed)
    for name, shape in M.input_shapes(cfg).items():
        draws = torch.randn((n,) + shape, generator=gen, device=dev).to(dtype)
        for p, x in zip(payloads, draws):
            p[name] = x
    return payloads, rng


def build_executor(cfg: ModelConfig, params: M.LM, gen_tokens: int,
                   b_max: int, prompt_len: int = 16,
                   cache_dtype: torch.dtype = torch.float32) -> SegmentExecutor:
    return SegmentExecutor(cfg, params, gen_tokens, b_max, prompt_len, cache_dtype)


def profile_latency(executor: SegmentExecutor, prompts: List[Dict[str, torch.Tensor]],
                    b_max: int, log: Callable[[str], None] = print) -> List[float]:
    """l(b) in ms for b = 1..b_max on the first b request payloads: a warm
    call, then a timed call; the table is made non-decreasing
    (np.maximum.accumulate), as the paper's service model assumes."""
    lat_ms = []
    for b in range(1, b_max + 1):
        batch = stack_payloads(prompts[:b])
        executor.run(**batch)  # warm
        t0 = time.perf_counter()
        executor.run(**batch)
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        log(f"l({b})={lat_ms[-1]:.3f}ms")
    return [float(x) for x in np.maximum.accumulate(lat_ms)]


def solve_on_profile(lat_ms: List[float], rho: float, b_max: int, *,
                     device: DeviceLike = None) -> SolveResult:
    """The example's SMDP (w2 = 0.5, s_max = 64) on the measured table,
    solved with the Bellman kernel."""
    svc = ServiceModel(latency=TableProfile(tuple(lat_ms)), family="det")
    energy = TableProfile(tuple(POWER_PROXY_W * l for l in lat_ms))  # mJ per batch
    lam = rho * b_max / lat_ms[-1]  # requests per ms
    spec = SMDPSpec(lam=lam, service=svc, energy=energy, b_min=1, b_max=b_max,
                    w1=1.0, w2=0.5, s_max=64)
    return solve(spec, backup="pallas", device=device)


@dataclasses.dataclass
class PipelineResult:
    lat_ms: List[float]
    solution: SolveResult
    reports: Dict[str, EngineReport]
    segments: int  # decode segments run, profile included


def run_pipeline(cfg: ModelConfig, params: M.LM, *, n_requests: int,
                 rho: float, gen_tokens: int, prompt_len: int, b_max: int,
                 cache_dtype: torch.dtype, seed: int = 0,
                 log: Callable[[str], None] = print) -> PipelineResult:
    """Profile, solve and serve on ``params``' device; see the module doc."""
    dev = params.device
    executor = build_executor(cfg, params, gen_tokens, b_max, prompt_len, cache_dtype)
    prompts, rng = draw_requests(cfg, max(n_requests, b_max), prompt_len, seed=seed,
                                 device=dev, dtype=params.dtype)

    # -- 1. profile l(b) on this device (paper Sec. III: prior profiling) --
    lat_ms = profile_latency(executor, prompts, b_max, log=log)

    # -- 2. solve the SMDP on the measured profile --------------------------
    sol = solve_on_profile(lat_ms, rho, b_max, device=dev)
    lam = sol.spec.lam
    log(f"SMDP policy table: {sol.action_table(16).tolist()} "
        f"(lambda={lam:.6f}/ms, {sol.rvi.iterations + 1} backups)")

    # -- 3. replay the same Poisson arrivals through each scheduler ---------
    arrivals = np.cumsum(rng.exponential(1.0 / lam, n_requests)) / 1e3  # s
    reports = {}
    for sched in [SMDPScheduler(sol), GreedyScheduler(1, b_max),
                  StaticScheduler(min(4, b_max))]:
        reqs = [Request(i, float(arrivals[i]), payload=prompts[i])
                for i in range(n_requests)]
        eng = ServingEngine(sched, lam=lam, b_max=b_max, executor=executor,
                            energy_model=lambda a, svc: POWER_PROXY_W * svc,
                            device=dev)
        rep = eng.run_executor(reqs)
        reports[sched.name] = rep
        log(f"{sched.name:9s}: served={rep.n_served} "
            f"W={rep.latencies.mean() * 1e3:.3f}ms "
            f"P95={rep.percentile(95) * 1e3:.3f}ms mean_batch={rep.mean_batch:.3f} "
            f"P_proxy={rep.power:.3f}W span={rep.span:.3f}s")
    return PipelineResult(lat_ms, sol, reports, executor.segments)


def main(argv: Optional[List[str]] = None) -> PipelineResult:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2.5-32b",
                    choices=sorted(n for n, c in ARCHS.items() if M.supported(c)))
    ap.add_argument("--b-max", type=int, default=8)
    ap.add_argument("--n-requests", type=int, default=120)
    ap.add_argument("--rho", type=float, default=0.6)
    ap.add_argument("--gen-tokens", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = ARCHS[args.arch].reduced()
    print(f"serving reduced {args.arch}: d={cfg.d_model} L={cfg.n_layers} "
          f"V={cfg.vocab_size} float32 on {dev}")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = M.init_params(cfg, gen, torch.float32, dev)
    res = run_pipeline(cfg, params, n_requests=args.n_requests, rho=args.rho,
                       gen_tokens=args.gen_tokens, prompt_len=args.prompt_len,
                       b_max=args.b_max, cache_dtype=torch.float32, seed=args.seed)
    print("(P_proxy is the measured service time x a constant "
          f"{POWER_PROXY_W:.0f} W, not a power measurement)")
    return res


if __name__ == "__main__":
    main()
