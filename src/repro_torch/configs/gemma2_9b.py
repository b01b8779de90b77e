"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000 — local+global alternating attention, logit softcaps
(arXiv:2408.00118)."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, d_head=256,
    d_ff=14336, vocab=256000,
    sliding_window=4096, local_global_period=2,
    attn_softcap=50.0, final_softcap=30.0,
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="gemma2-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=256,
        sliding_window=8, local_global_period=2,
        attn_softcap=50.0, final_softcap=30.0,
    )
