"""mistral-nemo-12b — exact published configuration (see assignment brackets)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14_336, vocab_size=131_072,
    rope_theta=1e6, max_position=131_072, tie_embeddings=False,
)  # [hf:mistralai/Mistral-Nemo-Base-2407 — head_dim pinned to 128]
