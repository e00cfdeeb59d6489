"""qwen2-vl-7b — exact published configuration (see assignment brackets)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
    d_ff=18_944, vocab_size=152_064,
    mrope=True, mrope_sections=(16, 24, 24), rope_theta=1e6,
    tie_embeddings=False,
)  # [arXiv:2409.12191]
