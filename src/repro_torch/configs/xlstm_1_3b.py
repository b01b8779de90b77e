"""xlstm-1.3b [ssm]: 48L d_model=2048 4H d_ff=0 vocab=50304 — sLSTM +
mLSTM blocks at 7:1 ratio (arXiv:2405.04517). Attention-free: runs the
long_500k shape with O(1) recurrent state."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_head=512,
    d_ff=0, vocab=50304,
    slstm_every=8,          # one sLSTM per 8 blocks (7:1 m:s ratio)
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="xlstm-smoke", family="ssm",
        n_layers=4, d_model=64, n_heads=2, n_kv_heads=2, d_head=32,
        d_ff=0, vocab=256,
        slstm_every=2,
    )
