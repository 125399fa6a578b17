"""The decoder stacks: init / forward / train loss / prefill / decode
(counterpart of repro.models.model, dense and hybrid families).

The parameters are an ``nn.Module``: ``DenseLM`` (the embedding, the final
norm, the untied output matrix and one ``nn.ParameterDict`` per layer) or
``HybridLM`` (the same top, one ``nn.ParameterDict`` of Mamba2 weights per
layer and one ``shared`` attention + MLP block); layouts in ``layers``.
The reference stacks layers on a leading axis and scans them; here a
Python loop walks the per-layer dicts.

Cache conventions (``init_cache``):

  dense  : {"k": (L, B, S, KV, hd), "v": ..., "length": int}
  hybrid : {"ssm": (L, B, H, P, N) float32, "conv": (L, B, K-1, C),
            "attn": one {"k", "v": (B, S, KV, hd)} per occurrence of the
            shared block, "length": int}

Caches are updated in place (K/V by slice assignment, the SSM state by the
scan writing into its slice, the conv tail by a copy) and ``length`` is a
Python int on the host, so a decode step never waits on the card to read
it.

Training (dense family): the tensors are built frozen; ``params.trainable()``
turns ``requires_grad`` on in place (the same storage).  ``lm_loss`` is the
reference's next-token cross-entropy; with ``remat`` each block runs under
``torch.utils.checkpoint`` (non-reentrant), so its forward -- the flash
kernel included -- runs again in the backward.  On the card the attention
gradient is the hand backward kernel (``kernels.ops.FlashAttentionFn``).
``leaf_map(cfg)`` says which slices of which tensors hold each of the
reference's stacked leaves (a layer's ``wq`` is the first H hd columns of
its ``wqkv``); ``gather_leaf`` / ``scatter_leaf`` read and write a leaf
through it (Adafactor factors and clips those leaves).

The dense and the Mamba2 hybrid families run.  The others (MoE, RWKV,
encoder-decoder, VLM) raise ``NotImplementedError`` at ``init_params`` and
at the forward passes; sliding-window and chunked-local layers raise in
``layers.attention``.  ``lm_loss`` on the hybrid raises: the SSD scan has no
backward kernel yet.  ROADMAP.md queue 1 lists them.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from . import layers as L
from .config import ModelConfig

# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _is_hybrid(cfg: ModelConfig) -> bool:
    return cfg.family == "hybrid"


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a family this port cannot run yet."""
    dense = cfg.family == "dense" and not cfg.mrope_sections
    hybrid = _is_hybrid(cfg) and cfg.shared_attn_every > 0
    if cfg.rwkv or cfg.n_experts or not (dense or hybrid):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet (ROADMAP.md "
            "queue 1, the model stack's remaining item); the port runs dense "
            "decoders and the Mamba2 hybrid"
        )


def _norm_names(cfg: ModelConfig, name: str) -> List[str]:
    return [name] if cfg.norm == "rmsnorm" else [name, name + "_b"]


def block_norms(cfg: ModelConfig) -> List[str]:
    """The norms of one dense layer (each a scale, plus a bias for LayerNorm)."""
    return ["ln1", "ln2"] + (["ln1_post", "ln2_post"] if cfg.post_block_norm else [])


def _norm_shapes(cfg: ModelConfig, norms: List[str]) -> Dict[str, tuple]:
    return {name: (cfg.d_model,) for n in norms for name in _norm_names(cfg, n)}


def attn_mlp_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Shapes of an attention + MLP block's weights in the port's layout."""
    d, H, KV, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                        cfg.d_ff)
    shapes = {"wqkv": (d, (H + 2 * KV) * hd), "wo": (H * hd, d)}
    if cfg.qkv_bias:
        shapes["bqkv"] = ((H + 2 * KV) * hd,)
    if cfg.act in ("swiglu", "geglu"):
        shapes["w13"] = (d, 2 * ff)
    else:
        shapes["w1"] = (d, ff)
    shapes["w2"] = (ff, d)
    return shapes


def block_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Shapes of one dense layer's parameters in the port's layout."""
    return {**attn_mlp_shapes(cfg), **_norm_shapes(cfg, block_norms(cfg))}


def mamba_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Shapes of one Mamba2 layer's parameters (the reference's names)."""
    d, di, N, H, K = (cfg.d_model, cfg.d_inner_ssm, cfg.ssm_state, cfg.n_ssm_heads,
                      cfg.ssm_conv)
    return {"in_proj": (d, 2 * di + 2 * N + H), "out_proj": (di, d),
            "conv_w": (K, di + 2 * N), "dt_bias": (H,), "a_log": (H,), "d_skip": (H,),
            **_norm_shapes(cfg, ["ln1"])}


def shared_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Shapes of the hybrid's shared attention + MLP block."""
    return {**attn_mlp_shapes(cfg), **_norm_shapes(cfg, ["ln_a", "ln_m"])}


def n_shared_occurrences(cfg: ModelConfig) -> int:
    """How often the hybrid's shared block runs in one forward."""
    return cfg.n_layers // cfg.shared_attn_every


def _frozen(x: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(x, requires_grad=False)


def _param_dict(tensors: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: _frozen(v) for k, v in tensors.items()})


class _LM(nn.Module):
    """The top of a decoder: embedding, final norm, untied output matrix."""

    def __init__(self, cfg: ModelConfig, top: Dict[str, torch.Tensor]):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embed = _frozen(top["embed"])
        self.final_norm = _frozen(top["final_norm"])
        self.final_norm_b = _frozen(top["final_norm_b"]) if "final_norm_b" in top else None
        self.out = None if cfg.tie_embeddings else _frozen(top["out"])

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def trainable(self) -> "_LM":
        """Turn ``requires_grad`` on for every tensor, in place."""
        for p in self.parameters():
            p.requires_grad_(True)
        return self

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype


class DenseLM(_LM):
    """Parameters of a dense decoder, on one device, in one dtype."""

    def __init__(self, cfg: ModelConfig, top: Dict[str, torch.Tensor],
                 blocks: List[Dict[str, torch.Tensor]]):
        super().__init__(cfg, top)
        if _is_hybrid(cfg):
            raise ValueError(f"{cfg.name} is a hybrid: use HybridLM")
        self.blocks = nn.ModuleList(_param_dict(b) for b in blocks)


class HybridLM(_LM):
    """Parameters of a Mamba2 hybrid (Zamba2): one Mamba2 dict per layer and
    one shared attention + MLP block with its norms ``ln_a`` / ``ln_m``."""

    def __init__(self, cfg: ModelConfig, top: Dict[str, torch.Tensor],
                 blocks: List[Dict[str, torch.Tensor]], shared: Dict[str, torch.Tensor]):
        super().__init__(cfg, top)
        if not _is_hybrid(cfg):
            raise ValueError(f"{cfg.name} is not a hybrid: use DenseLM")
        self.blocks = nn.ModuleList(_param_dict(b) for b in blocks)
        self.shared = _param_dict(shared)


LM = Union[DenseLM, HybridLM]


# ---------------------------------------------------------------------------
# The reference's leaves in the port's tensors
# ---------------------------------------------------------------------------


class Piece(NamedTuple):
    """One port tensor's share of a reference leaf: columns [lo, hi) of its
    last axis (all of it when lo is None), reshaped to ``shape``."""

    name: str  # as in ``params.named_parameters()``
    lo: Optional[int]
    hi: Optional[int]
    shape: Tuple[int, ...]


class Leaf(NamedTuple):
    """A reference leaf: one piece, or one per layer stacked on a new
    leading axis."""

    pieces: List[Piece]
    stacked: bool


def leaf_map(cfg: ModelConfig) -> Dict[str, Leaf]:
    """The reference ``init_params`` leaves of a dense decoder, by their
    ``/``-joined paths in ``jax.tree.leaves`` order (sorted keys), each
    with the port tensors that hold it."""
    check_supported(cfg)
    if cfg.family == "hybrid":
        raise NotImplementedError(f"{cfg.name}: the leaf map covers the dense family")
    d, H, KV, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                        cfg.d_ff)
    qkv = {"q": (0, H * hd, H), "k": (H * hd, (H + KV) * hd, KV),
           "v": ((H + KV) * hd, (H + 2 * KV) * hd, KV)}
    per_layer: Dict[str, Tuple[str, Optional[int], Optional[int], tuple]] = {}
    for x, (lo, hi, n) in qkv.items():
        per_layer[f"w{x}"] = ("wqkv", lo, hi, (d, n, hd))
        if cfg.qkv_bias:
            per_layer[f"b{x}"] = ("bqkv", lo, hi, (n, hd))
    per_layer["wo"] = ("wo", None, None, (H, hd, d))
    if cfg.act in ("swiglu", "geglu"):
        per_layer["w1"] = ("w13", 0, ff, (d, ff))
        per_layer["w3"] = ("w13", ff, 2 * ff, (d, ff))
    else:
        per_layer["w1"] = ("w1", None, None, (d, ff))
    per_layer["w2"] = ("w2", None, None, (ff, d))
    for n in block_norms(cfg):
        per_layer[f"{n}/s"] = (n, None, None, (d,))
        if cfg.norm != "rmsnorm":
            per_layer[f"{n}/b"] = (n + "_b", None, None, (d,))
    leaves = {"embed": Leaf([Piece("embed", None, None, (cfg.vocab_size, d))], False),
              "final_norm/s": Leaf([Piece("final_norm", None, None, (d,))], False)}
    if cfg.norm != "rmsnorm":
        leaves["final_norm/b"] = Leaf([Piece("final_norm_b", None, None, (d,))], False)
    if not cfg.tie_embeddings:
        leaves["out"] = Leaf([Piece("out", None, None, (d, cfg.vocab_size))], False)
    for path, (name, lo, hi, shape) in per_layer.items():
        leaves[f"blocks/{path}"] = Leaf(
            [Piece(f"blocks.{i}.{name}", lo, hi, shape) for i in range(cfg.n_layers)], True)
    return dict(sorted(leaves.items()))


def _view(t: torch.Tensor, pc: Piece) -> torch.Tensor:
    return t if pc.lo is None else t[..., pc.lo:pc.hi]


def gather_leaf(tensors: Dict[str, torch.Tensor], leaf: Leaf) -> torch.Tensor:
    """The reference leaf (a copy when stacked) from the port's tensors."""
    parts = [_view(tensors[pc.name], pc).reshape(pc.shape) for pc in leaf.pieces]
    return torch.stack(parts) if leaf.stacked else parts[0]


def scatter_leaf(tensors: Dict[str, torch.Tensor], leaf: Leaf, value: torch.Tensor) -> None:
    """Write a reference leaf's ``value`` into the port's tensors, in place."""
    for i, pc in enumerate(leaf.pieces):
        dst = _view(tensors[pc.name], pc)
        src = value[i] if leaf.stacked else value
        dst.copy_(src.reshape(dst.shape))

#: the reference's constant initial values of a Mamba2 layer
_MAMBA_CONST = {"dt_bias": -4.6,  # softplus ~ 0.01
                "a_log": 0.0,  # A = -1
                "d_skip": 0.1}


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device: DeviceLike = None) -> LM:
    """Random weights (std 0.02, zero biases, zero RMSNorm offsets, unit
    LayerNorm scales, the Mamba2 constants dt_bias -4.6, a_log 0, d_skip
    0.1, as the reference) drawn from ``generator`` straight into ``dtype``
    on ``device`` -- no f32 staging copy, so a 32B model in bf16 needs its
    61 GiB and no more.  The generator must live on the device
    (``torch.Generator(device="cuda")`` for the card)."""
    check_supported(cfg)
    dev = resolve_device(device)
    std = 0.02

    def init(name, shape):
        if name in _MAMBA_CONST:
            return torch.full(shape, _MAMBA_CONST[name], dtype=dtype, device=dev)
        if name.startswith("w") or name in ("embed", "out", "in_proj", "out_proj",
                                            "conv_w"):
            return torch.randn(shape, generator=generator, dtype=dtype,
                               device=dev).mul_(std)
        if cfg.norm != "rmsnorm" and name.startswith(("ln", "final_norm")) \
                and not name.endswith("_b"):
            return torch.ones(shape, dtype=dtype, device=dev)  # LayerNorm scale
        return torch.zeros(shape, dtype=dtype, device=dev)  # biases, RMSNorm offsets

    def draw(shapes):
        return {n: init(n, shape) for n, shape in shapes.items()}

    top_shapes = {"embed": (cfg.vocab_size, cfg.d_model),
                  **_norm_shapes(cfg, ["final_norm"])}
    if not cfg.tie_embeddings:
        top_shapes["out"] = (cfg.d_model, cfg.vocab_size)
    top = draw(top_shapes)
    if _is_hybrid(cfg):
        blocks = [draw(mamba_shapes(cfg)) for _ in range(cfg.n_layers)]
        return HybridLM(cfg, top, blocks, draw(shared_shapes(cfg)))
    return DenseLM(cfg, top, [draw(block_shapes(cfg)) for _ in range(cfg.n_layers)])


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _embed(cfg: ModelConfig, params: LM, tokens):
    # F.embedding, not params.embed[tokens]: the same rows, and a backward
    # that sums repeated tokens in one fixed order on the CPU too (indexing's
    # backward accumulates there in a nondeterministic order)
    h = F.embedding(tokens, params.embed)
    if cfg.embed_scale:
        h = (h.float() * math.sqrt(cfg.d_model)).to(h.dtype)
    return h


def _unembed(cfg: ModelConfig, params: LM, h):
    if cfg.tie_embeddings:
        logits = torch.matmul(h, params.embed.t())
    else:
        logits = torch.matmul(h, params.out)
    if cfg.final_softcap:
        logits = (cfg.final_softcap
                  * torch.tanh(logits.float() / cfg.final_softcap)).to(logits.dtype)
    return logits


def _layer_is_local(cfg: ModelConfig, i: int) -> bool:
    if cfg.layer_pattern == "local_global":
        return i % 2 == 0
    if cfg.layer_pattern == "chunked_full":
        return i % 4 != 3
    return False


def _block(cfg: ModelConfig, p, h, is_local: bool, kv_cache=None, rope=None):
    a_in = L.apply_norm(cfg, h, p["ln1"], p.get("ln1_b"))
    a_out, new_cache = L.attention(cfg, p, a_in, layer_is_local=is_local,
                                   kv_cache=kv_cache, rope=rope)
    if cfg.post_block_norm:
        a_out = L.apply_norm(cfg, a_out, p["ln1_post"], p.get("ln1_post_b"))
    h = h + a_out
    m_in = L.apply_norm(cfg, h, p["ln2"], p.get("ln2_b"))
    m_out = L.mlp(cfg, p, m_in)
    if cfg.post_block_norm:
        m_out = L.apply_norm(cfg, m_out, p["ln2_post"], p.get("ln2_post_b"))
    return h + m_out, new_cache


def _remat_block(cfg: ModelConfig, p, h, is_local: bool, rope):
    return _block(cfg, p, h, is_local, rope=rope)[0]


def _rope_and_lengths(cfg: ModelConfig, h, cache: Optional[dict]):
    """One forward's rope tables (positions length .. length + S - 1) and,
    for a one-token decode, the decode kernel's valid prefix per sequence;
    every attention layer of the step shares them."""
    B, S = h.shape[:2]
    length = 0 if cache is None else int(cache["length"])
    rope = None
    if cfg.rope_theta > 0:
        positions = torch.arange(length, length + S, device=h.device)[None, :].expand(B, S)
        rope = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    lengths = None
    if cache is not None and length > 0 and S == 1:
        lengths = torch.full((B,), length + 1, dtype=torch.int32, device=h.device)
    return length, rope, lengths


def forward_lm(cfg: ModelConfig, params: DenseLM, tokens, *,
               cache: Optional[dict] = None, remat: bool = False):
    """Dense decoder stack over tokens (B, S).  Returns (h_final, new_cache);
    a given cache is updated in place and comes back with length + S.
    ``remat`` (cache-free, under grad mode) checkpoints each block, as the
    reference's ``jax.checkpoint`` of its scanned body.  Gradients flow
    when the parameters are ``trainable()``; the serving steps below run
    it under inference mode."""
    check_supported(cfg)
    if _is_hybrid(cfg):
        raise ValueError(f"{cfg.name} is a hybrid: use forward_hybrid")
    S = tokens.shape[1]
    h = _embed(cfg, params, tokens)
    length, rope, lengths = _rope_and_lengths(cfg, h, cache)
    for i, p in enumerate(params.blocks):
        kv = None
        if cache is not None:
            kv = {"k": cache["k"][i], "v": cache["v"][i], "length": length,
                  "lengths": lengths}
        if remat and kv is None and torch.is_grad_enabled():
            h = checkpoint(_remat_block, cfg, p, h, _layer_is_local(cfg, i), rope,
                           use_reentrant=False)
        else:
            h, _ = _block(cfg, p, h, _layer_is_local(cfg, i), kv_cache=kv, rope=rope)
    h = L.apply_norm(cfg, h, params.final_norm, params.final_norm_b)
    new_cache = None
    if cache is not None:
        new_cache = {"k": cache["k"], "v": cache["v"], "length": length + S}
    return h, new_cache


def _shared_block(cfg: ModelConfig, sp, h, kv_cache=None, rope=None):
    """The hybrid's shared attention + MLP block (one set of weights)."""
    a_in = L.apply_norm(cfg, h, sp["ln_a"], sp.get("ln_a_b"))
    y, _ = L.attention(cfg, sp, a_in, kv_cache=kv_cache, rope=rope)
    h = h + y
    m_in = L.apply_norm(cfg, h, sp["ln_m"], sp.get("ln_m_b"))
    return h + L.mlp(cfg, sp, m_in)


@torch.inference_mode()
def forward_hybrid(cfg: ModelConfig, params: HybridLM, tokens, *,
                   cache: Optional[dict] = None):
    """Zamba2: the Mamba2 backbone with the shared block after every
    ``shared_attn_every`` layers (``n_layers // shared_attn_every`` times,
    each occurrence with its own KV cache).  Returns (h_final, new_cache);
    a given cache is updated in place and comes back with length + S."""
    check_supported(cfg)
    if not _is_hybrid(cfg):
        raise ValueError(f"{cfg.name} is not a hybrid: use forward_lm")
    S = tokens.shape[1]
    h = _embed(cfg, params, tokens)
    length, rope, lengths = _rope_and_lengths(cfg, h, cache)
    k_every, n_occ = cfg.shared_attn_every, n_shared_occurrences(cfg)
    if cache is not None and cache["conv"].dtype != h.dtype:
        raise ValueError(f"cache dtype {cache['conv'].dtype} differs from the "
                         f"activations' {h.dtype}")
    for i, p in enumerate(params.blocks):
        a_in = L.apply_norm(cfg, h, p["ln1"], p.get("ln1_b"))
        if cache is None:
            y, _, _ = L.mamba2_block(cfg, p, a_in)
        else:
            ssm = cache["ssm"][i]
            y, _, conv = L.mamba2_block(cfg, p, a_in, ssm_state=ssm,
                                        conv_state=cache["conv"][i], ssm_out=ssm)
            cache["conv"][i].copy_(conv)
        h = h + y
        occ = (i + 1) // k_every - 1
        if (i + 1) % k_every == 0 and occ < n_occ:
            kv = None
            if cache is not None:
                kv = {**cache["attn"][occ], "length": length, "lengths": lengths}
            h = _shared_block(cfg, params.shared, h, kv_cache=kv, rope=rope)
    h = L.apply_norm(cfg, h, params.final_norm, params.final_norm_b)
    new_cache = None
    if cache is not None:
        new_cache = {**cache, "length": length + S}
    return h, new_cache


def forward(cfg: ModelConfig, params: LM, tokens, *, cache: Optional[dict] = None):
    """The family's stack over tokens (B, S): forward_hybrid or forward_lm."""
    if _is_hybrid(cfg):
        return forward_hybrid(cfg, params, tokens, cache=cache)
    return forward_lm(cfg, params, tokens, cache=cache)


# ---------------------------------------------------------------------------
# Training loss and serving steps
# ---------------------------------------------------------------------------


def lm_loss(cfg: ModelConfig, params: LM, batch: Dict, *, remat: bool = True):
    """Next-token cross-entropy (predict t + 1 from t): the mean over
    (B, S - 1) of logsumexp(logits) - logits[gold], in f32, as the
    reference's ``lm_loss``.  (The reference takes the gold logit by a
    one-hot contraction for its sharding; here a gather.)"""
    if _is_hybrid(cfg):
        raise NotImplementedError(
            f"{cfg.name}: training the hybrid needs a backward kernel for the SSD "
            "scan (csrc/ssd_scan.cu), which is not written yet (ROADMAP.md queue 1, "
            "hybrid training)")
    tokens = batch["tokens"]
    h, _ = forward_lm(cfg, params, tokens, remat=remat)
    logits = _unembed(cfg, params, h[:, :-1, :]).float()
    targets = tokens[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    return torch.mean(logz - gold)


@torch.inference_mode()
def prefill(cfg: ModelConfig, params: LM, batch: Dict, max_len: int,
            cache_dtype: torch.dtype = torch.bfloat16):
    """Run the prompt, build a cache of capacity max_len.
    Returns (logits of the last position (B, 1, V), cache)."""
    tokens = batch["tokens"]
    B, _ = tokens.shape
    cache = init_cache(cfg, B, max_len, dtype=cache_dtype, device=tokens.device)
    h, cache = forward(cfg, params, tokens, cache=cache)
    return _unembed(cfg, params, h[:, -1:, :]), cache


@torch.inference_mode()
def decode_step(cfg: ModelConfig, params: LM, cache: dict, tokens):
    """One token per sequence: tokens (B, 1) -> (logits (B, 1, V), cache)."""
    h, cache = forward(cfg, params, tokens, cache=cache)
    return _unembed(cfg, params, h[:, -1:, :]), cache


def cache_shapes(cfg: ModelConfig, B: int, max_len: int,
                 dtype: torch.dtype = torch.bfloat16
                 ) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """Every tensor ``init_cache`` builds, by name: (shape, dtype).  The
    hybrid's SSM state is float32 whatever ``dtype``; its shared block's
    caches are named ``attn.<occurrence>.k`` / ``.v``."""
    check_supported(cfg)
    kv = (max_len, cfg.n_kv_heads, cfg.head_dim)
    if not _is_hybrid(cfg):
        return {"k": ((cfg.n_layers, B) + kv, dtype), "v": ((cfg.n_layers, B) + kv, dtype)}
    H, P, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    shapes = {
        "ssm": ((cfg.n_layers, B, H, P, N), torch.float32),
        "conv": ((cfg.n_layers, B, cfg.ssm_conv - 1, cfg.d_inner_ssm + 2 * N), dtype),
    }
    for occ in range(n_shared_occurrences(cfg)):
        for name in ("k", "v"):
            shapes[f"attn.{occ}.{name}"] = ((B,) + kv, dtype)
    return shapes


@torch.inference_mode()
def init_cache(cfg: ModelConfig, B: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device: DeviceLike = None):
    """A zeroed cache of capacity max_len (conventions in the module doc)."""
    dev = resolve_device(device)
    zeros = {name: torch.zeros(shape, dtype=dt, device=dev)
             for name, (shape, dt) in cache_shapes(cfg, B, max_len, dtype).items()}
    if not _is_hybrid(cfg):
        return {**zeros, "length": 0}
    attn = [{"k": zeros[f"attn.{occ}.k"], "v": zeros[f"attn.{occ}.v"]}
            for occ in range(n_shared_occurrences(cfg))]
    return {"ssm": zeros["ssm"], "conv": zeros["conv"], "attn": attn, "length": 0}
