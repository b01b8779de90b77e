"""smollm-135m [dense]: 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152
— llama-arch small. Also the CPU-trainable end-to-end example arch."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, d_head=64,
    d_ff=1536, vocab=49152,
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="smollm-smoke", family="dense",
        n_layers=2, d_model=48, n_heads=3, n_kv_heads=1, d_head=16,
        d_ff=128, vocab=256,
    )
