"""moonshot-v1-16b-a3b — exact published configuration (see assignment brackets)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=163_840,
    n_experts=64, top_k=6, n_shared_experts=2, first_dense=1,
    tie_embeddings=False,
    # chunked dispatch linearizes the GShard T·E·C·d einsums
    moe_dispatch_chunk=2048,
)  # [hf:moonshotai/Moonlight-16B-A3B]
