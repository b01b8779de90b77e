"""Architecture configuration schema for the 10 assigned architectures
(the port's own copy of ``repro.models.config``: pure dataclasses, field
for field the same, so a test can build both from one name).

One ArchConfig fully describes a model: the decoder/encoder stack shape,
attention flavor (GQA, sliding/global pattern, softcap), FFN flavor
(dense SwiGLU / MoE top-k), and non-transformer blocks (mLSTM/sLSTM,
Mamba-style SSM for the hybrid)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | vlm | audio | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None            # default d_model // n_heads
    moe: Optional[MoEConfig] = None
    # attention details
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None    # window for local layers
    local_global_period: int = 0            # gemma2: alternate local/global
    attn_softcap: Optional[float] = None    # gemma2: 50.0
    final_softcap: Optional[float] = None   # gemma2: 30.0
    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_positions: int = 0                  # encoder memory length (frames)
    # ssm / recurrent
    ssm_state: int = 0                      # mamba state size (hymba)
    slstm_every: int = 0                    # xlstm: 1 sLSTM per this many
    # multimodal stub
    n_img_tokens: int = 0                   # llava: prepended patch embeds
    # numerics
    dtype: str = "bfloat16"
    # misc
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve 500k+ contexts? (SSM state / bounded window
        for all but O(1) layers.)"""
        return self.family in ("ssm", "hybrid")

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks)."""
        d, dh = self.d_model, self.head_dim
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        att = d * self.n_heads * dh * 2 + d * self.n_kv_heads * dh * 2
        if self.family == "ssm":
            # xlstm blocks (Dh-major layout): q,k,v,z projections + down
            blk = 5 * d * d
            return emb + self.n_layers * blk
        if self.moe:
            ffn = self.moe.n_experts * 3 * d * self.d_ff + d * self.moe.n_experts
        else:
            ffn = 3 * d * self.d_ff
        blk = att + ffn
        if self.family == "hybrid":
            blk += d * (2 * self.ssm_state + 2) * self.n_heads  # ssm params
        dec = self.n_layers * blk
        enc = self.n_enc_layers * (att + ffn) if self.enc_dec else 0
        cross = self.n_layers * att if self.enc_dec else 0
        return emb + dec + enc + cross

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if not self.moe:
            return self.n_params()
        d = self.d_model
        full = self.n_params()
        ffn_all = self.n_layers * self.moe.n_experts * 3 * d * self.d_ff
        ffn_act = self.n_layers * self.moe.top_k * 3 * d * self.d_ff
        return full - ffn_all + ffn_act


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeConfig:
    """Look up a registered input-shape bundle by name (KeyError when
    unknown)."""
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
