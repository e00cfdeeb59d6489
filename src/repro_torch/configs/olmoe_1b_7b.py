"""olmoe-1b-7b — exact published configuration (see assignment brackets)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1024, vocab_size=50_304,
    n_experts=64, top_k=8, tie_embeddings=False,
    # chunked dispatch linearizes the GShard einsums
    moe_dispatch_chunk=2048,
)  # [arXiv:2409.02060]
