"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) d_ff=1536
(per expert) vocab=151936, MoE 128 experts top-8 (fine-grained)."""
from ..models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_head=128,
    d_ff=1536, vocab=151936,
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=128, top_k=8),
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=32, vocab=256,
        moe=MoEConfig(n_experts=8, top_k=2),
    )
