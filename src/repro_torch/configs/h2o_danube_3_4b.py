"""h2o-danube-3-4b — exact published configuration (see assignment brackets)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, head_dim=120,
    d_ff=10_240, vocab_size=32_000,
    pattern=("swa",), window=4096, rope_theta=500_000.0,
    tie_embeddings=False, subquadratic=True,
)  # [arXiv:2401.16818 — llama+mistral mix, SWA]
