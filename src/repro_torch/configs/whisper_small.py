"""whisper-small — exact published configuration (see assignment brackets)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=51_865,
    encoder_layers=12, cross_attention=True, encoder_len=1500,
    norm="layernorm", activation="gelu", use_rope=False,
    pos_embed="learned", max_position=32_768, tie_embeddings=True,
)  # [arXiv:2212.04356 — enc-dec; conv frontend stubbed per assignment]
