"""granite-20b — exact published configuration (see assignment brackets)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
    d_ff=24_576, vocab_size=49_152,
    norm="layernorm", activation="gelu", use_rope=False,
    # real granite-20b-code caps at 8192 learned positions; the table is
    # extended to cover the assigned 32k cells (documented in DESIGN.md)
    pos_embed="learned", max_position=32768, tie_embeddings=True,
)  # [arXiv:2405.04324 — gpt_bigcode arch: MQA, learned pos, gelu]
