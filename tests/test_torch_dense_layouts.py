"""The dense decoders' real head layouts at narrow width, shared by
tests/test_torch_dense_heads.py (against the JAX package on the CPU) and
tests/test_torch_gpu.py (on the card against the CPU), and a check of what
they keep. ``narrow`` works on either package's ``ArchConfig``; the module
imports nothing of JAX, so the card's tests can use it where JAX is
absent.

Each config keeps the arch's ``n_heads``, ``n_kv_heads``, ``head_dim``,
norm, activation, positions (granite's learned table of 32768 rows),
tying and RoPE theta, and cuts the depth to 2 layers, the widths to
``d_model`` 256 and ``d_ff`` 512, the vocabulary to 512 and the type to
float32. h2o-danube-3-4b's window is cut to 64, so that a prompt of 100
tokens wraps its ring.
"""
from __future__ import annotations

import dataclasses

DENSE_HEADS = ["granite-20b", "internlm2-20b", "h2o-danube-3-4b"]
NARROW_WINDOW = 64
KEPT = ("n_heads", "n_kv_heads", "head_dim", "norm", "activation",
        "use_rope", "rope_theta", "pos_embed", "max_position",
        "tie_embeddings", "pattern")


def narrow(cfg):
    """``cfg`` with its head layout and cut everywhere else."""
    return dataclasses.replace(
        cfg, n_layers=2, d_model=256, d_ff=512, vocab_size=512,
        dtype="float32",
        window=NARROW_WINDOW if cfg.window else None)


def prompt_len(cfg) -> int:
    """A prompt that wraps an SWA ring (100 > the window), else 40."""
    return 100 if cfg.window else 40


def test_narrow_keeps_the_head_layout():
    from repro_torch.configs import ARCHS
    for arch in DENSE_HEADS:
        full = ARCHS[arch]
        cfg = narrow(full)
        assert all(getattr(cfg, f) == getattr(full, f) for f in KEPT)
        assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size,
                cfg.dtype) == (2, 256, 512, 512, "float32")
        assert cfg.window == (NARROW_WINDOW if full.window else None)
        assert prompt_len(cfg) > (cfg.window or 0)
    assert narrow(ARCHS["granite-20b"]).max_position == 32768
    assert narrow(ARCHS["h2o-danube-3-4b"]).head_dim == 120
