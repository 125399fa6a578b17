"""The model stacks: init / forward / train loss / prefill / decode
(counterpart of repro.models.model: the dense, MoE, VLM, encoder-decoder,
hybrid and RWKV6 families).

The parameters are an ``nn.Module``: ``DenseLM`` (the embedding, the final
norm, the untied output matrix and one ``nn.ParameterDict`` per layer; an
MoE layer holds its router and stacked experts in place of the MLP),
``HybridLM`` (the same top, one ``nn.ParameterDict`` of Mamba2 weights per
layer and one ``shared`` attention + MLP block) or ``RwkvLM`` (the same
top, one ``nn.ParameterDict`` of time-mix and channel-mix weights per
layer, under the reference's leaf names) or ``EncDecLM`` (Whisper: the
same top, the encoder's ``enc_blocks`` -- dense layers -- with its
``enc_final_norm`` and its positions ``enc_pos`` (encoder_len, d), and
decoder ``blocks`` that add cross-attention weights and ``lnx``); layouts
in ``layers``.  A VLM (Qwen2-VL) is a ``DenseLM``.  The reference stacks
layers on a leading axis and scans them; here a Python loop walks the
per-layer dicts.

Cache conventions (``init_cache``):

  dense, moe, vlm : {"k": (L, B, S, KV, hd), "v": ..., "length": int}
  encdec : the same, + {"enc_out": (B, T, d)} in the activations' dtype,
           set by ``prefill`` (the encoder runs once a prefill; decode
           steps read it)
  hybrid : {"ssm": (L, B, H, P, N) float32, "conv": (L, B, K-1, C),
            "attn": one {"k", "v": (B, S, KV, hd)} per occurrence of the
            shared block, "length": int}
  rwkv : {"wkv": (L, B, H, P, P) float32, "tshift": (L, B, 1, d),
          "cshift": (L, B, 1, d), "length": int}

Caches are updated in place (K/V by slice assignment, the SSM and WKV
states by the scans writing into their slices, the conv tail and the
token shifts by a copy) and ``length`` is a Python int on the host, so a
decode step never waits on the card to read it.

Training (every family but the hybrid and RWKV6): the tensors are built
frozen; ``params.trainable()`` turns ``requires_grad`` on in place (the
same storage).  ``lm_loss`` is the reference's next-token cross-entropy
over the family's forward of the reference's batch (``tokens``, plus
``frames`` for the encoder-decoder and ``patches`` for a VLM); with
``remat`` each block -- an encoder layer, a decoder layer with its
cross-attention -- runs under ``torch.utils.checkpoint`` (non-reentrant),
so its forward, the flash kernel included, runs again in the backward.
On the card the attention gradient is the hand backward kernel
(``kernels.ops.FlashAttentionFn``) under the layer's causal, window or
chunk mask.
``leaf_map(cfg)`` says which slices of which tensors hold each of the
reference's stacked leaves (a layer's ``wq`` is the first H hd columns of
its ``wqkv``); ``gather_leaf`` / ``scatter_leaf`` read and write a leaf
through it (Adafactor factors and clips those leaves).

Every family of the reference runs: dense (Gemma2's local / global
layers included), MoE (Llama-4 Scout's chunked-local layers, Grok-1),
VLM (Qwen2-VL: M-RoPE, its stub patch embeddings in place of the first
``n_patches`` token embeddings of a prefill), encoder-decoder (Whisper:
its stub frame embeddings through the encoder, no decoder position
signal), the Mamba2 hybrid and RWKV6.  ``lm_loss`` raises on the hybrid
and on RWKV6 (the SSD and WKV6 scans have no backward kernel yet);
ROADMAP.md queue 1 lists them.
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


def _is_rwkv(cfg: ModelConfig) -> bool:
    return bool(cfg.rwkv)


def _is_encdec(cfg: ModelConfig) -> bool:
    return cfg.family == "encdec"


def supported(cfg: ModelConfig) -> bool:
    """Whether this port runs the configuration's family."""
    if _is_rwkv(cfg):
        return True
    decoder = cfg.family in ("dense", "moe", "vlm")
    hybrid = _is_hybrid(cfg) and cfg.shared_attn_every > 0
    encdec = _is_encdec(cfg) and cfg.n_encoder_layers > 0
    return decoder or hybrid or encdec


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a family this port cannot run yet."""
    if not supported(cfg):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet (ROADMAP.md "
            "queue 1, the model stack's remaining item); the port runs dense, MoE "
            "and VLM decoders, the encoder-decoder, the Mamba2 hybrid and RWKV6"
        )


def _norm_names(cfg: ModelConfig, name: str) -> List[str]:
    return [name] if cfg.norm == "rmsnorm" else [name, name + "_b"]


def block_norms(cfg: ModelConfig) -> List[str]:
    """The norms of one dense layer (each a scale, plus a bias for LayerNorm)."""
    return ["ln1", "ln2"] + (["ln1_post", "ln2_post"] if cfg.post_block_norm else [])


def _norm_shapes(cfg: ModelConfig, norms: List[str]) -> Dict[str, tuple]:
    return {name: (cfg.d_model,) for n in norms for name in _norm_names(cfg, n)}


def _is_gated(cfg: ModelConfig) -> bool:
    return cfg.act in ("swiglu", "geglu")


def _ffn_shapes(cfg: ModelConfig, prefix: str = "", lead: tuple = ()) -> Dict[str, tuple]:
    """An MLP's weights, [w1 | w3] fused as ``w13`` when gated, each with
    the leading axes ``lead`` (the experts' (E,))."""
    d, ff = cfg.d_model, cfg.d_ff
    if _is_gated(cfg):
        return {prefix + "w13": lead + (d, 2 * ff), prefix + "w2": lead + (ff, d)}
    return {prefix + "w1": lead + (d, ff), prefix + "w2": lead + (ff, d)}


def attn_mlp_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Shapes of an attention + MLP (or MoE) block's weights in the port's
    layout."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {"wqkv": (d, (H + 2 * KV) * hd), "wo": (H * hd, d)}
    if cfg.qkv_bias:
        shapes["bqkv"] = ((H + 2 * KV) * hd,)
    if not cfg.n_experts:
        return {**shapes, **_ffn_shapes(cfg)}
    shapes["router"] = (d, cfg.n_experts)
    shapes.update(_ffn_shapes(cfg, lead=(cfg.n_experts,)))
    if cfg.n_shared_experts:
        shapes.update(_ffn_shapes(cfg, prefix="s"))
    return shapes


def block_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Shapes of one dense layer's parameters in the port's layout (also a
    Whisper encoder layer's)."""
    return {**attn_mlp_shapes(cfg), **_norm_shapes(cfg, block_norms(cfg))}


def encdec_block_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Shapes of one Whisper decoder layer: a dense layer, its cross-attention
    (``x_wq``, ``x_wkv`` = [x_wk | x_wv], ``x_wo``) and the norm ``lnx``."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {**block_shapes(cfg), "x_wq": (d, H * hd), "x_wkv": (d, 2 * KV * hd),
            "x_wo": (H * hd, d), **_norm_shapes(cfg, ["lnx"])}


def mamba_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Shapes of one Mamba2 layer's parameters (the reference's names)."""
    d, di, N, H, K = (cfg.d_model, cfg.d_inner_ssm, cfg.ssm_state, cfg.n_ssm_heads,
                      cfg.ssm_conv)
    return {"in_proj": (d, 2 * di + 2 * N + H), "out_proj": (di, d),
            "conv_w": (K, di + 2 * N), "dt_bias": (H,), "a_log": (H,), "d_skip": (H,),
            **_norm_shapes(cfg, ["ln1"])}


#: the rank of RWKV6's decay LoRA (the reference's ``_rwkv_params``)
RWKV_LORA_RANK = 32


def rwkv_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Shapes of one RWKV6 layer's parameters (the reference's names, the
    head axes of wr / wk / wv / wg / wo / w_lora_b flattened)."""
    d, H, P, ff, R = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, RWKV_LORA_RANK
    shapes = {"wr": (d, H * P), "wk": (d, H * P), "wv": (d, H * P), "wg": (d, H * P),
              "wo": (H * P, d), "w_lora_a": (d, R), "w_lora_b": (R, H * P),
              "w_base": (H, P), "u_bonus": (H, P), "ln_x": (P,), "ck": (d, ff),
              "cv": (ff, d), "cr": (d, d)}
    shapes.update({f"mu_{n}": (d,) for n in ("r", "k", "v", "g", "w", "ck", "cr")})
    return {**shapes, **_norm_shapes(cfg, ["ln1", "ln2"])}


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


def _lm_class(cfg: ModelConfig) -> str:
    if _is_rwkv(cfg):
        return "RwkvLM"
    if _is_hybrid(cfg):
        return "HybridLM"
    return "EncDecLM" if _is_encdec(cfg) else "DenseLM"


class DenseLM(_LM):
    """Parameters of a dense (or MoE, or VLM) decoder, on one device, in one
    dtype."""

    def __init__(self, cfg: ModelConfig, top: Dict[str, torch.Tensor],
                 blocks: List[Dict[str, torch.Tensor]]):
        super().__init__(cfg, top)
        if _lm_class(cfg) != "DenseLM":
            raise ValueError(f"{cfg.name} is a {cfg.family} model: use {_lm_class(cfg)}")
        self.blocks = nn.ModuleList(_param_dict(b) for b in blocks)


class EncDecLM(_LM):
    """Parameters of an encoder-decoder (Whisper): the encoder's dense layers
    ``enc_blocks``, its final norm ``enc_final_norm`` (``enc_final_norm_b``)
    and positions ``enc_pos`` (encoder_len, d); decoder ``blocks``
    (``encdec_block_shapes``)."""

    def __init__(self, cfg: ModelConfig, top: Dict[str, torch.Tensor],
                 enc_blocks: List[Dict[str, torch.Tensor]],
                 blocks: List[Dict[str, torch.Tensor]]):
        super().__init__(cfg, top)
        if not _is_encdec(cfg):
            raise ValueError(f"{cfg.name} is not an encoder-decoder: use {_lm_class(cfg)}")
        self.enc_pos = _frozen(top["enc_pos"])
        self.enc_final_norm = _frozen(top["enc_final_norm"])
        self.enc_final_norm_b = (_frozen(top["enc_final_norm_b"])
                                 if "enc_final_norm_b" in top else None)
        self.enc_blocks = nn.ModuleList(_param_dict(b) for b in enc_blocks)
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


class RwkvLM(_LM):
    """Parameters of an RWKV6 (Finch) model: one dict per layer of its time
    mix, channel mix and the two LayerNorms (``rwkv_shapes``)."""

    def __init__(self, cfg: ModelConfig, top: Dict[str, torch.Tensor],
                 blocks: List[Dict[str, torch.Tensor]]):
        super().__init__(cfg, top)
        if not _is_rwkv(cfg):
            raise ValueError(f"{cfg.name} is not an RWKV model: use DenseLM")
        self.blocks = nn.ModuleList(_param_dict(b) for b in blocks)


LM = Union[DenseLM, HybridLM, RwkvLM, EncDecLM]


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
    """The reference ``init_params`` leaves of a dense, MoE or VLM decoder or
    of the encoder-decoder, by their ``/``-joined paths in ``jax.tree.leaves``
    order (sorted keys), each with the port tensors that hold it."""
    check_supported(cfg)
    if cfg.family not in ("dense", "moe", "vlm", "encdec") or _is_rwkv(cfg):
        raise NotImplementedError(f"{cfg.name}: the leaf map covers the dense, MoE, "
                                  "VLM and encoder-decoder families")
    d, H, KV, hd, ff, E = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                           cfg.d_ff, cfg.n_experts)
    qkv = {"q": (0, H * hd, H), "k": (H * hd, (H + KV) * hd, KV),
           "v": ((H + KV) * hd, (H + 2 * KV) * hd, KV)}
    per_layer: Dict[str, Tuple[str, Optional[int], Optional[int], tuple]] = {}
    for x, (lo, hi, n) in qkv.items():
        per_layer[f"w{x}"] = ("wqkv", lo, hi, (d, n, hd))
        if cfg.qkv_bias:
            per_layer[f"b{x}"] = ("bqkv", lo, hi, (n, hd))
    per_layer["wo"] = ("wo", None, None, (H, hd, d))

    def ffn(prefix, lead):
        if _is_gated(cfg):
            per_layer[prefix + "w1"] = (prefix + "w13", 0, ff, lead + (d, ff))
            per_layer[prefix + "w3"] = (prefix + "w13", ff, 2 * ff, lead + (d, ff))
        else:
            per_layer[prefix + "w1"] = (prefix + "w1", None, None, lead + (d, ff))
        per_layer[prefix + "w2"] = (prefix + "w2", None, None, lead + (ff, d))

    ffn("", (E,) if E else ())
    if E:
        per_layer["router"] = ("router", None, None, (d, E))
        if cfg.n_shared_experts:
            ffn("s", ())
    def norms(table, names):
        for n in names:
            table[f"{n}/s"] = (n, None, None, (d,))
            if cfg.norm != "rmsnorm":
                table[f"{n}/b"] = (n + "_b", None, None, (d,))

    leaves = {"embed": Leaf([Piece("embed", None, None, (cfg.vocab_size, d))], False)}
    if not cfg.tie_embeddings:
        leaves["out"] = Leaf([Piece("out", None, None, (d, cfg.vocab_size))], False)
    top: Dict[str, Tuple[str, Optional[int], Optional[int], tuple]] = {}
    norms(top, ["final_norm"])

    def stack(prefix, table, n_layers):
        for path, (name, lo, hi, shape) in table.items():
            leaves[f"{prefix}/{path}"] = Leaf(
                [Piece(f"{prefix}.{i}.{name}", lo, hi, shape) for i in range(n_layers)], True)

    if _is_encdec(cfg):
        # the encoder's layers are dense layers; a decoder layer adds the
        # cross-attention x_wq / x_wk / x_wv / x_wo (x_wk and x_wv the
        # halves of x_wkv) and the norm lnx
        enc = dict(per_layer)
        norms(enc, ["ln1", "ln2"])
        stack("enc_blocks", enc, cfg.n_encoder_layers)
        norms(top, ["enc_final_norm"])
        leaves["enc_pos"] = Leaf([Piece("enc_pos", None, None, (cfg.encoder_len, d))], False)
        per_layer["x_wq"] = ("x_wq", None, None, (d, H, hd))
        per_layer["x_wk"] = ("x_wkv", 0, KV * hd, (d, KV, hd))
        per_layer["x_wv"] = ("x_wkv", KV * hd, 2 * KV * hd, (d, KV, hd))
        per_layer["x_wo"] = ("x_wo", None, None, (H, hd, d))
        norms(per_layer, ["ln1", "ln2", "lnx"])
    else:
        norms(per_layer, block_norms(cfg))
    for path, (name, lo, hi, shape) in top.items():
        leaves[path] = Leaf([Piece(name, lo, hi, shape)], False)
    stack("blocks", per_layer, cfg.n_layers)
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
#: and of an RWKV6 layer: w_base is no weight matrix and ln_x an RMSNorm
#: offset (the model's LayerNorms are not), whatever their names say
_RWKV_CONST = {"w_base": -0.6, "u_bonus": 0.0, "ln_x": 0.0,
               **{f"mu_{n}": 0.5 for n in ("r", "k", "v", "g", "w", "ck", "cr")}}


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device: DeviceLike = None) -> LM:
    """Random weights (std 0.02, Whisper's ``enc_pos`` too; zero biases,
    zero RMSNorm offsets, unit LayerNorm scales, the Mamba2 constants
    dt_bias -4.6, a_log 0, d_skip 0.1, the RWKV6 ones w_base -0.6, every
    mu_* 0.5, u_bonus 0, ln_x 0, as the reference) drawn from ``generator`` straight into ``dtype``
    on ``device`` -- no f32 staging copy, so a 32B model in bf16 needs its
    61 GiB and no more.  The generator must live on the device
    (``torch.Generator(device="cuda")`` for the card)."""
    check_supported(cfg)
    dev = resolve_device(device)
    std = 0.02

    const = {**_MAMBA_CONST, **(_RWKV_CONST if _is_rwkv(cfg) else {})}

    def init(name, shape):
        if name in const:
            return torch.full(shape, const[name], dtype=dtype, device=dev)
        if name.startswith(("w", "sw", "x_w")) or name in (
                "embed", "out", "router", "in_proj", "out_proj", "conv_w", "ck", "cv",
                "cr", "enc_pos"):
            return torch.randn(shape, generator=generator, dtype=dtype,
                               device=dev).mul_(std)
        if cfg.norm != "rmsnorm" and not name.endswith("_b") and name.startswith(
                ("ln", "final_norm", "enc_final_norm")):
            return torch.ones(shape, dtype=dtype, device=dev)  # LayerNorm scale
        return torch.zeros(shape, dtype=dtype, device=dev)  # biases, RMSNorm offsets

    def draw(shapes):
        return {n: init(n, shape) for n, shape in shapes.items()}

    top_shapes = {"embed": (cfg.vocab_size, cfg.d_model),
                  **_norm_shapes(cfg, ["final_norm"])}
    if not cfg.tie_embeddings:
        top_shapes["out"] = (cfg.d_model, cfg.vocab_size)
    top = draw(top_shapes)
    if _is_rwkv(cfg):
        return RwkvLM(cfg, top, [draw(rwkv_shapes(cfg)) for _ in range(cfg.n_layers)])
    if _is_hybrid(cfg):
        blocks = [draw(mamba_shapes(cfg)) for _ in range(cfg.n_layers)]
        return HybridLM(cfg, top, blocks, draw(shared_shapes(cfg)))
    if _is_encdec(cfg):
        top.update(draw({"enc_pos": (cfg.encoder_len, cfg.d_model),
                         **_norm_shapes(cfg, ["enc_final_norm"])}))
        enc = [draw(block_shapes(cfg)) for _ in range(cfg.n_encoder_layers)]
        return EncDecLM(cfg, top, enc,
                        [draw(encdec_block_shapes(cfg)) for _ in range(cfg.n_layers)])
    return DenseLM(cfg, top, [draw(block_shapes(cfg)) for _ in range(cfg.n_layers)])


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _embed(cfg: ModelConfig, params: LM, tokens, patches=None):
    """Token embeddings (B, S, d); a VLM's stub patch embeddings (B, n, d)
    replace the first n of them (the reference's concatenation)."""
    # F.embedding, not params.embed[tokens]: the same rows, and a backward
    # that sums repeated tokens in one fixed order on the CPU too (indexing's
    # backward accumulates there in a nondeterministic order)
    h = F.embedding(tokens, params.embed)
    if cfg.embed_scale:
        h = (h.float() * math.sqrt(cfg.d_model)).to(h.dtype)
    if cfg.n_patches and patches is not None:
        n = patches.shape[1]
        if tokens.shape[1] < n:
            raise ValueError(f"a prompt of {tokens.shape[1]} tokens cannot hold "
                             f"{n} patches")
        h = torch.cat([patches.to(h.dtype), h[:, n:]], dim=1)
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
    m_out = L.moe_ffn(cfg, p, m_in) if cfg.n_experts else L.mlp(cfg, p, m_in)
    if cfg.post_block_norm:
        m_out = L.apply_norm(cfg, m_out, p["ln2_post"], p.get("ln2_post_b"))
    return h + m_out, new_cache


def _remat_block(cfg: ModelConfig, p, h, is_local: bool, rope):
    return _block(cfg, p, h, is_local, rope=rope)[0]


def _mrope_positions(cfg: ModelConfig, B: int, S: int, offset: int = 0, device=None):
    """Stub M-RoPE positions (3, B, S): every row, patch or text, gets (t, t,
    t) with t = offset .. offset + S - 1, as the reference's."""
    pos = torch.arange(offset, offset + S, device=device)[None, :].expand(B, S)
    return pos.expand(3, B, S)


def _rope_and_lengths(cfg: ModelConfig, h, cache: Optional[dict]):
    """One forward's rotary tables (positions length .. length + S - 1; M-RoPE's
    from ``_mrope_positions``) and, for a one-token decode, the decode
    kernel's valid prefix per sequence; every attention layer of the step
    shares them."""
    B, S = h.shape[:2]
    length = 0 if cache is None else int(cache["length"])
    rope = None
    if cfg.mrope_sections is not None:
        rope = L.rotary_tables(cfg, _mrope_positions(cfg, B, S, length, h.device))
    elif cfg.rope_theta > 0:
        positions = torch.arange(length, length + S, device=h.device)[None, :].expand(B, S)
        rope = L.rotary_tables(cfg, positions)
    lengths = None
    if cache is not None and length > 0 and S == 1:
        lengths = torch.full((B,), length + 1, dtype=torch.int32, device=h.device)
    return length, rope, lengths


def forward_lm(cfg: ModelConfig, params: DenseLM, tokens, *, patches=None,
               cache: Optional[dict] = None, remat: bool = False):
    """Dense decoder stack over tokens (B, S) (a VLM's ``patches`` (B, n, d)
    in place of the first n embeddings).  Returns (h_final, new_cache);
    a given cache is updated in place and comes back with length + S.
    ``remat`` (cache-free, under grad mode) checkpoints each block, as the
    reference's ``jax.checkpoint`` of its scanned body.  Gradients flow
    when the parameters are ``trainable()``; the serving steps below run
    it under inference mode."""
    check_supported(cfg)
    if _lm_class(cfg) != "DenseLM":
        raise ValueError(f"{cfg.name} is a {cfg.family} model: use forward")
    S = tokens.shape[1]
    h = _embed(cfg, params, tokens, patches)
    length, rope, lengths = _rope_and_lengths(cfg, h, cache)
    for i, p in enumerate(params.blocks):
        kv = None
        if cache is not None:
            kv = {"k": cache["k"][i], "v": cache["v"][i], "length": length,
                  "lengths": lengths}
        if kv is None and _checkpointed(remat):
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


@torch.inference_mode()
def forward_rwkv(cfg: ModelConfig, params: RwkvLM, tokens, *,
                 cache: Optional[dict] = None):
    """RWKV6: per layer h + time_mix(ln1(h)), then h + channel_mix(ln2(h)).
    Returns (h_final, new_cache); a given cache is updated in place (the
    WKV6 kernel writes each layer's state into ``cache["wkv"][i]``, the
    token shifts are copied into ``tshift`` / ``cshift``) and comes back
    with length + S."""
    check_supported(cfg)
    if not _is_rwkv(cfg):
        raise ValueError(f"{cfg.name} is not an RWKV model: use forward")
    S = tokens.shape[1]
    h = _embed(cfg, params, tokens)
    if cache is not None and cache["tshift"].dtype != h.dtype:
        raise ValueError(f"cache dtype {cache['tshift'].dtype} differs from the "
                         f"activations' {h.dtype}")
    names = ("wkv", "tshift", "cshift")
    for i, p in enumerate(params.blocks):
        c = (dict.fromkeys(names) if cache is None
             else {n: cache[n][i] for n in names})  # None: zeros, nothing kept
        a_in = L.apply_norm(cfg, h, p["ln1"], p.get("ln1_b"))
        y, _, tsh = L.rwkv6_time_mix(cfg, p, a_in, state=c["wkv"],
                                     shift_state=c["tshift"], state_out=c["wkv"])
        h = h + y
        c_in = L.apply_norm(cfg, h, p["ln2"], p.get("ln2_b"))
        y, csh = L.rwkv6_channel_mix(cfg, p, c_in, shift_state=c["cshift"])
        h = h + y
        if cache is not None:
            c["tshift"].copy_(tsh)
            c["cshift"].copy_(csh)
    h = L.apply_norm(cfg, h, params.final_norm, params.final_norm_b)
    new_cache = None
    if cache is not None:
        new_cache = {**cache, "length": int(cache["length"]) + S}
    return h, new_cache


def _enc_block(cfg: ModelConfig, p, h):
    """One Whisper encoder layer: non-causal self-attention and the MLP."""
    a_in = L.apply_norm(cfg, h, p["ln1"], p.get("ln1_b"))
    y, _ = L.attention(cfg, p, a_in, causal=False)
    h = h + y
    m_in = L.apply_norm(cfg, h, p["ln2"], p.get("ln2_b"))
    return h + L.mlp(cfg, p, m_in)


def _dec_block(cfg: ModelConfig, p, h, enc_out, kv_cache=None, rope=None):
    """One Whisper decoder layer: causal self-attention, cross-attention to
    enc_out, the MLP."""
    a_in = L.apply_norm(cfg, h, p["ln1"], p.get("ln1_b"))
    y, _ = L.attention(cfg, p, a_in, kv_cache=kv_cache, rope=rope)
    h = h + y
    x_in = L.apply_norm(cfg, h, p["lnx"], p.get("lnx_b"))
    h = h + L.cross_attention(cfg, p, x_in, enc_out)
    m_in = L.apply_norm(cfg, h, p["ln2"], p.get("ln2_b"))
    return h + L.mlp(cfg, p, m_in)


def _checkpointed(remat: bool) -> bool:
    return remat and torch.is_grad_enabled()


def forward_encoder(cfg: ModelConfig, params: EncDecLM, frames, *, remat: bool = False):
    """Whisper's encoder over stub frame embeddings (B, T, d), T <=
    encoder_len, taken in the model's dtype: frames + enc_pos[:T], the
    non-causal dense layers, the final norm.  Returns enc_out (B, T, d).
    ``remat`` (under grad mode) checkpoints each layer."""
    if not _is_encdec(cfg):
        raise ValueError(f"{cfg.name} has no encoder")
    T = frames.shape[1]
    if T > cfg.encoder_len:
        raise ValueError(f"{T} frames exceed the encoder's {cfg.encoder_len} positions")
    h = frames.to(params.dtype) + params.enc_pos[:T]
    for p in params.enc_blocks:
        if _checkpointed(remat):
            h = checkpoint(_enc_block, cfg, p, h, use_reentrant=False)
        else:
            h = _enc_block(cfg, p, h)
    return L.apply_norm(cfg, h, params.enc_final_norm, params.enc_final_norm_b)


def forward_encdec(cfg: ModelConfig, params: EncDecLM, tokens, frames=None, *,
                   cache: Optional[dict] = None, remat: bool = False):
    """Whisper's decoder over tokens (B, S): per layer causal self-attention
    (on the KV cache when given), cross-attention to enc_out -- the cache's
    ``enc_out`` when it holds one, else ``forward_encoder(frames)`` -- and
    the MLP.  No decoder position signal (rope_theta 0, as the reference).
    Returns (h_final, new_cache); a given cache is updated in place and
    comes back with length + S and ``enc_out``.  ``remat`` (cache-free,
    under grad mode) checkpoints each encoder and decoder layer, the
    cross-attention inside its decoder layer, as the reference's
    ``jax.checkpoint`` of its scanned bodies."""
    check_supported(cfg)
    if not _is_encdec(cfg):
        raise ValueError(f"{cfg.name} is not an encoder-decoder: use forward")
    S = tokens.shape[1]
    enc_out = None if cache is None else cache.get("enc_out")
    if enc_out is None:
        if frames is None:
            raise ValueError(f"{cfg.name}: the encoder needs frames (B, T, d)")
        enc_out = forward_encoder(cfg, params, frames, remat=remat and cache is None)
    h = _embed(cfg, params, tokens)
    if enc_out.dtype != h.dtype:
        raise ValueError(f"enc_out dtype {enc_out.dtype} differs from the "
                         f"activations' {h.dtype}")
    length, rope, lengths = _rope_and_lengths(cfg, h, cache)
    for i, p in enumerate(params.blocks):
        kv = None
        if cache is not None:
            kv = {"k": cache["k"][i], "v": cache["v"][i], "length": length,
                  "lengths": lengths}
        if kv is None and _checkpointed(remat):
            h = checkpoint(_dec_block, cfg, p, h, enc_out, None, rope, use_reentrant=False)
        else:
            h = _dec_block(cfg, p, h, enc_out, kv_cache=kv, rope=rope)
    h = L.apply_norm(cfg, h, params.final_norm, params.final_norm_b)
    new_cache = None
    if cache is not None:
        new_cache = {**cache, "length": length + S, "enc_out": enc_out}
    return h, new_cache


def forward(cfg: ModelConfig, params: LM, tokens, *, cache: Optional[dict] = None,
            frames=None, patches=None, remat: bool = False):
    """The family's stack over tokens (B, S): forward_rwkv, forward_hybrid,
    forward_encdec (with ``frames``, unless the cache holds enc_out) or
    forward_lm (with a VLM's ``patches``); ``remat`` as forward_lm's (the
    hybrid and RWKV6 run without a graph)."""
    if _is_rwkv(cfg):
        return forward_rwkv(cfg, params, tokens, cache=cache)
    if _is_hybrid(cfg):
        return forward_hybrid(cfg, params, tokens, cache=cache)
    if _is_encdec(cfg):
        return forward_encdec(cfg, params, tokens, frames, cache=cache, remat=remat)
    return forward_lm(cfg, params, tokens, patches=patches, cache=cache, remat=remat)


# ---------------------------------------------------------------------------
# Training loss and serving steps
# ---------------------------------------------------------------------------


def lm_loss(cfg: ModelConfig, params: LM, batch: Dict, *, remat: bool = True):
    """Next-token cross-entropy (predict t + 1 from t): the mean over
    (B, S - 1) of logsumexp(logits) - logits[gold], in f32, as the
    reference's ``lm_loss``, over the family's forward of the reference's
    batch: ``tokens`` (B, S), and ``frames`` (B, T, d) for the
    encoder-decoder, ``patches`` (B, n, d) for a VLM.  (The reference takes
    the gold logit by a one-hot contraction for its sharding; here a
    gather.)"""
    if _is_rwkv(cfg):
        raise NotImplementedError(
            f"{cfg.name}: training RWKV6 needs a backward kernel for the WKV6 scan "
            "(csrc/wkv6_scan.cu), which is not written yet (ROADMAP.md queue 1, "
            "training RWKV6)")
    if _is_hybrid(cfg):
        raise NotImplementedError(
            f"{cfg.name}: training the hybrid needs a backward kernel for the SSD "
            "scan (csrc/ssd_scan.cu), which is not written yet (ROADMAP.md queue 1, "
            "hybrid training)")
    tokens = batch["tokens"]
    h, _ = forward(cfg, params, tokens, frames=batch.get("frames"),
                   patches=batch.get("patches"), remat=remat)
    logits = _unembed(cfg, params, h[:, :-1, :]).float()
    targets = tokens[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    return torch.mean(logz - gold)


def input_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """What a prefill's batch holds beside ``tokens``, by name, with each
    request's shape -- as the reference's serving cells give it: an
    encoder-decoder's ``frames`` (encoder_len, d), a VLM's ``patches``
    (n_patches, d); nothing for the other families."""
    shapes = {}
    if _is_encdec(cfg):
        shapes["frames"] = (cfg.encoder_len, cfg.d_model)
    if cfg.n_patches:
        shapes["patches"] = (cfg.n_patches, cfg.d_model)
    return shapes


@torch.inference_mode()
def prefill(cfg: ModelConfig, params: LM, batch: Dict, max_len: int,
            cache_dtype: torch.dtype = torch.bfloat16):
    """Run the prompt -- the reference's batch: ``tokens`` (B, S), plus
    ``frames`` (B, T, d) for an encoder-decoder and ``patches`` (B, n, d)
    for a VLM -- and build a cache of capacity max_len; an encoder-decoder's
    encoder runs once here and its output stays in the cache as
    ``enc_out``.  Returns (logits of the last position (B, 1, V), cache)."""
    tokens = batch["tokens"]
    B, _ = tokens.shape
    cache = init_cache(cfg, B, max_len, dtype=cache_dtype, device=tokens.device)
    if _is_encdec(cfg):
        if batch.get("frames") is None:
            raise ValueError(f"{cfg.name}: a prefill needs the batch's frames")
        cache["enc_out"] = forward_encoder(cfg, params, batch["frames"])
    h, cache = forward(cfg, params, tokens, cache=cache, patches=batch.get("patches"))
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
    hybrid's SSM state and RWKV6's WKV state are float32 whatever
    ``dtype``; the hybrid's shared block's caches are named
    ``attn.<occurrence>.k`` / ``.v``.  RWKV6's cache does not grow with
    ``max_len``.  An encoder-decoder's ``enc_out`` is not among them: its
    prefill adds it (as the reference's ``init_cache`` leaves it out)."""
    check_supported(cfg)
    if _is_rwkv(cfg):
        Ln, H, P, d = cfg.n_layers, cfg.n_heads, cfg.head_dim, cfg.d_model
        return {"wkv": ((Ln, B, H, P, P), torch.float32),
                "tshift": ((Ln, B, 1, d), dtype), "cshift": ((Ln, B, 1, d), dtype)}
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
    if not _is_hybrid(cfg):  # dense, moe, rwkv
        return {**zeros, "length": 0}
    attn = [{"k": zeros[f"attn.{occ}.k"], "v": zeros[f"attn.{occ}.v"]}
            for occ in range(n_shared_occurrences(cfg))]
    return {"ssm": zeros["ssm"], "conv": zeros["conv"], "attn": attn, "length": 0}
