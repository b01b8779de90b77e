"""deepseek-coder-33b [dense]: 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256 — llama-arch (arXiv:2401.14196)."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=19200, vocab=32256,
    rope_theta=100_000.0,
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-coder-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=256,
    )
