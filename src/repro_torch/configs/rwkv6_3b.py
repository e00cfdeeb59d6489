"""rwkv6-3b — exact published configuration (see assignment brackets)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
    d_ff=8960, vocab_size=65_536,
    pattern=("rwkv6",), rwkv_heads=40, rwkv_head_dim=64,
    use_rope=False, norm="layernorm", tie_embeddings=False,
    subquadratic=True,
)  # [arXiv:2404.05892]
