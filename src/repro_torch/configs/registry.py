"""Aggregated registry of the 10 assigned architectures + the reduced() smoke
transform.

Port of :mod:`repro.configs.registry`: the same ``ARCHS``, ``reduced()`` and
``get()``. ``input_specs`` waits for the dry-run's port (ROADMAP queue 1,
item 11).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.granite_20b import CONFIG as GRANITE_20B
from repro_torch.configs.h2o_danube_3_4b import CONFIG as H2O_DANUBE3_4B
from repro_torch.configs.internlm2_20b import CONFIG as INTERNLM2_20B
from repro_torch.configs.mistral_nemo_12b import CONFIG as MISTRAL_NEMO_12B
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as MOONSHOT_V1_16B_A3B
from repro_torch.configs.olmoe_1b_7b import CONFIG as OLMOE_1B_7B
from repro_torch.configs.qwen2_vl_7b import CONFIG as QWEN2_VL_7B
from repro_torch.configs.recurrentgemma_2b import CONFIG as RECURRENTGEMMA_2B
from repro_torch.configs.rwkv6_3b import CONFIG as RWKV6_3B
from repro_torch.configs.whisper_small import CONFIG as WHISPER_SMALL

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in (
        RECURRENTGEMMA_2B, QWEN2_VL_7B, RWKV6_3B, MOONSHOT_V1_16B_A3B,
        OLMOE_1B_7B, GRANITE_20B, H2O_DANUBE3_4B, MISTRAL_NEMO_12B,
        INTERNLM2_20B, WHISPER_SMALL,
    )
}


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Same family/topology, tiny dims: one pattern unit (+head/tail edge
    cases preserved), small widths, tiny vocab."""
    unit = len(cfg.pattern)
    n_layers = cfg.first_dense + 2 * unit + (1 if unit > 1 else 0)
    d_model = 64
    n_heads = max(2, min(4, cfg.n_heads))
    head_dim = 16
    n_kv = 1 if cfg.n_kv_heads == 1 else max(1, n_heads // 2)
    return dataclasses.replace(
        cfg,
        n_layers=n_layers, d_model=d_model, n_heads=n_heads,
        n_kv_heads=n_kv, head_dim=head_dim,
        d_ff=128 if cfg.n_experts == 0 else 32,
        vocab_size=512,
        n_experts=min(cfg.n_experts, 8),
        top_k=min(cfg.top_k, 2),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        moe_capacity_factor=None,   # lossless: decode==forward exactly

        window=min(cfg.window, 32) if cfg.window else None,
        lru_width=d_model if cfg.lru_width else 0,
        rwkv_heads=4 if cfg.rwkv_heads else 0,
        rwkv_head_dim=16 if cfg.rwkv_heads else 64,
        mrope_sections=(4, 2, 2) if cfg.mrope else cfg.mrope_sections,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_len=24 if cfg.encoder_layers else 1500,
        max_position=2048,
        dtype="float32",
    )


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
