"""recurrentgemma-2b — exact published configuration (see assignment brackets)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256_000,
    pattern=("rglru", "rglru", "swa"), window=2048, lru_width=2560,
    activation="geglu", embed_scale=True, subquadratic=True,
)  # [arXiv:2402.19427]
