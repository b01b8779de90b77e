"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attention + mamba heads per layer
(arXiv:2411.13676). Sliding-window attention everywhere except 3 global
layers; meta-tokens omitted (DESIGN.md). Runs long_500k."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_head=64,
    d_ff=5504, vocab=32001,
    ssm_state=16, sliding_window=1024,
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="hymba-smoke", family="hybrid",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=256,
        ssm_state=4, sliding_window=8,
    )
