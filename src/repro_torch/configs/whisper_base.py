"""whisper-base [audio]: 6L d_model=512 8H d_ff=2048 vocab=51865 — enc-dec,
conv frontend STUB: input_specs() provides precomputed frame embeddings
(B, 1500, d_model) in place of the mel conv stem (arXiv:2212.04356)."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, d_head=64,
    d_ff=2048, vocab=51865,
    enc_dec=True, n_enc_layers=6, enc_positions=1500,
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="whisper-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab=256,
        enc_dec=True, n_enc_layers=2, enc_positions=32,
    )
