"""ArchConfig schema + input-shape cells shared by all assigned architectures.

Port of :mod:`repro.configs.base`: the same fields, derived properties and
shape cells; ``param_dtype`` is a torch dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # mixer pattern, cycled over layers: "attn" | "swa" | "rglru" | "rwkv6"
    pattern: tuple = ("attn",)
    window: Optional[int] = None     # SWA window (used by "swa" layers)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    first_dense: int = 0             # leading dense-FFN layers (Moonlight)
    renorm_gates: bool = True
    # GShard capacity factor for full-seq MoE; None = lossless (C = tokens)
    moe_capacity_factor: float | None = 1.25
    # dispatch in chunks of this many tokens (linearizes the T·E·C·d
    # dispatch einsums); None = classic full-T GShard
    moe_dispatch_chunk: int | None = None
    # "int8": absmax-quantized KV cache (int8 payloads, a float32 scale a
    # slot); None = cache in param dtype
    kv_quant: str | None = None
    # positions
    use_rope: bool = True
    rope_theta: float = 10_000.0
    mrope: bool = False
    mrope_sections: tuple = (16, 24, 24)
    pos_embed: str = "rope"          # "rope" | "learned"
    max_position: int = 131_072
    # enc-dec (whisper)
    encoder_layers: int = 0
    cross_attention: bool = False
    encoder_len: int = 1500          # whisper 30 s of frames
    # recurrent widths
    lru_width: int = 0
    rwkv_heads: int = 0
    rwkv_head_dim: int = 64
    # misc
    norm: str = "rmsnorm"
    activation: str = "swiglu"
    tie_embeddings: bool = True
    embed_scale: bool = False        # gemma-style sqrt(d) embedding scale
    dtype: str = "bfloat16"
    subquadratic: bool = False       # can run long_500k

    # ---- derived -----------------------------------------------------------
    def mixer_kind(self, layer: int) -> str:
        return self.pattern[layer % len(self.pattern)]

    def mlp_kind(self, layer: int) -> str:
        if self.n_experts > 0 and layer >= self.first_dense:
            return "moe"
        if self.mixer_kind(layer) == "rwkv6":
            return "channel_mix"
        return "dense"

    @property
    def param_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def n_params(self) -> int:
        """Analytic parameter count (embedding + layers)."""
        d, dff = self.d_model, self.d_ff
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.pos_embed == "learned":
            total += self.max_position * d
        for i in range(self.n_layers):
            kind = self.mixer_kind(i)
            if kind in ("attn", "swa"):
                total += d * self.head_dim * (self.n_heads * 2
                                              + self.n_kv_heads * 2)
                if self.cross_attention:
                    total += d * self.head_dim * (self.n_heads * 2
                                                  + self.n_kv_heads * 2)
            elif kind == "rglru":
                total += 2 * d * self.lru_width + 2 * self.lru_width ** 2 \
                    + self.lru_width * d + 5 * self.lru_width
            elif kind == "rwkv6":
                total += 5 * d * d + d * (32 * 5 + 5) + d * 64 * 2
            mk = self.mlp_kind(i)
            gated = self.activation in ("swiglu", "geglu")
            per_ff = d * dff * (3 if gated else 2)
            if mk == "moe":
                total += self.n_experts * per_ff + d * self.n_experts
                total += self.n_shared_experts * per_ff
            elif mk == "channel_mix":
                total += d * dff * 2 + d * d
            else:
                total += per_ff
            total += 2 * d  # norms
        for _ in range(self.encoder_layers):
            total += d * self.head_dim * (self.n_heads * 2 + self.n_kv_heads * 2)
            total += d * dff * 2 + 2 * d
        return total

    def n_active_params(self) -> int:
        """Per-token active params (MoE: top_k + shared experts only)."""
        if self.n_experts == 0:
            return self.n_params()
        d, dff = self.d_model, self.d_ff
        gated = self.activation in ("swiglu", "geglu")
        per_ff = d * dff * (3 if gated else 2)
        inactive = (self.n_layers - self.first_dense) \
            * (self.n_experts - self.top_k) * per_ff
        return self.n_params() - inactive


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str                        # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def supported_shapes(cfg: ArchConfig) -> list[str]:
    """long_500k only for sub-quadratic archs (DESIGN.md §6)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        out.append("long_500k")
    return out
