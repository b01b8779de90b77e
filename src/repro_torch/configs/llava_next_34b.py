"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling. Backbone only; the vision tower is a stub:
input_specs() supplies precomputed anyres patch embeddings (576 tokens)."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=20480, vocab=64000,
    rope_theta=5_000_000.0,
    n_img_tokens=576,
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="llava-next-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=256, n_img_tokens=8,
    )
