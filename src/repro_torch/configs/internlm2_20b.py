"""internlm2-20b — exact published configuration (see assignment brackets)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16_384, vocab_size=92_544,
    rope_theta=1e6, tie_embeddings=False,
)  # [arXiv:2403.17297]
