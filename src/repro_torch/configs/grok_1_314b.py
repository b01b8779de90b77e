"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2."""
from ..models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=32768, vocab=131072,
    moe=MoEConfig(n_experts=8, top_k=2),
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="grok-1-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=96, vocab=256,
        moe=MoEConfig(n_experts=4, top_k=2),
    )
