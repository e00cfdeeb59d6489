"""Top-level model: embeddings, decoder stack, LM head.

Port of :mod:`repro.models.model` for the decoders, dense,
mixture-of-experts, hybrid (RG-LRU and local attention,
recurrentgemma-2b) and RWKV6 (rwkv6-3b), as an ``nn.Module`` that holds
its parameters:

  model = Model(cfg).init(seed)            # on the card unless device= given
  logits, aux = model.forward(tokens)
  loss, metrics = model.loss(batch, remat=True)
  logits, cache = model.prefill(tokens, max_len=...)
  cache = model.init_cache(batch, max_len)
  logits, cache = model.decode_step(tokens, cache, pos)

``Model(cfg)`` allocates the parameters uninitialised on the device, in
``cfg.param_dtype`` (an MoE router in float32, as the reference's);
``init`` draws them there from a ``torch.Generator`` one tensor at a time,
so a full-width model never has a float32 or host copy. ``models.params.params_from_jax`` fills one from the reference's
parameters instead.

``forward`` and ``loss`` are differentiable: the AdamW route turns the
parameters' gradients on with ``model.requires_grad_(True)`` (every
parameter is made with ``requires_grad=False``, so serving builds no
graph), and K3's gradient is its backward kernel
(``kernels.flash_attention.ops``). ``prefill`` and ``decode_step`` run
under ``torch.no_grad()``. ``encode`` and ``fill_cross_cache`` wait for
later slices; M-RoPE and encoder-decoder configs raise. The hybrid's
scan (``kernels.rglru_scan``), K3 at head_dim 256 and RWKV6's recurrence
(``kernels.rwkv6_wkv``) have no backward kernel: on the card they raise
where a gradient is asked for.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import draw_, embed_init, make_norm

_WAITS = "is not ported yet (ROADMAP queue 1, item 11: LM substrate)"


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device=None):
        super().__init__()
        if cfg.mrope:
            raise NotImplementedError(f"M-RoPE (qwen2-vl) {_WAITS}")
        if cfg.encoder_layers > 0:
            raise NotImplementedError(f"the encoder-decoder path {_WAITS}")
        self.cfg = cfg
        self.device = resolve_device(device)
        dtype, dev = cfg.param_dtype, self.device
        norm_init, _ = make_norm(cfg.norm)
        self.embed = embed_init(cfg.vocab_size, cfg.d_model, dtype, dev)
        self.decoder = tfm.stack_init(cfg, dtype, dev)
        self.norm_final = norm_init(cfg.d_model, dtype, dev)
        self.unembed = (None if cfg.tie_embeddings else
                        embed_init(cfg.vocab_size, cfg.d_model, dtype, dev))
        self.pos_embed = (embed_init(cfg.max_position, cfg.d_model, dtype, dev)
                          if cfg.pos_embed == "learned" else None)

    # ------------------------------------------------------------------ init
    @torch.no_grad()
    def init(self, seed: int | torch.Generator = 0) -> "Model":
        """Draw every parameter in place with the reference's init rules
        (``models.layers.draw_``), in ``named_parameters`` order, from one
        generator on the model's device. The numbers are torch's, not the
        reference's: ``params_from_jax`` carries the reference's across."""
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
        for name, p in self.named_parameters():
            draw_(name, p, gen, self.cfg.norm)
        return self

    # ------------------------------------------------------------- embedding
    def _embed(self, tokens, add_pos=True):
        cfg = self.cfg
        x = self.embed[tokens]
        if cfg.embed_scale:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()
        if cfg.pos_embed == "learned" and add_pos:
            t = tokens.shape[1]
            x = x + self.pos_embed[:t][None]
        return x

    def _logits(self, x):
        _, norm = make_norm(self.cfg.norm)
        x = norm(self.norm_final, x)
        w = self.embed if self.cfg.tie_embeddings else self.unembed
        return x @ w.T

    def _positions(self, tokens, positions):
        if positions is None and self.cfg.use_rope:
            b, t = tokens.shape[:2]
            positions = torch.arange(t, device=tokens.device)[None].expand(b, t)
        return positions

    # ------------------------------------------------------------- forward
    def forward(self, tokens, *, positions=None, last_only=False,
                remat=False):
        """Full-sequence logits (b, t, V), or (b, 1, V) of the last position
        with ``last_only``. Returns (logits, aux), aux the MoE layers'
        summed load-balancing loss (0 for a dense model), each MoE layer at
        the config's capacity. ``remat`` recomputes each pattern unit of the
        layer groups in the backward pass (``transformer.stack_apply``)."""
        x = self._embed(tokens)
        x, aux = tfm.stack_apply(self.decoder, self.cfg, x,
                                 positions=self._positions(tokens, positions),
                                 causal=True, remat=remat)
        if last_only:
            x = x[:, -1:]
        return self._logits(x), aux

    # ------------------------------------------------------------------ loss
    def loss(self, batch, *, remat=False):
        """Next-token cross-entropy on float32 logits. batch: tokens (b,
        t+1) [+ positions]. Returns (loss, {"ce", "aux"}); an MoE config's
        loss is ``ce + 0.01·aux``."""
        tokens = batch["tokens"]
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        logits, aux = self.forward(inputs, positions=batch.get("positions"),
                                   remat=remat)
        logp = torch.log_softmax(logits.float(), dim=-1)
        del logits
        ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
        ce = -ll.mean()
        loss = ce + 0.01 * aux if self.cfg.n_experts > 0 else ce
        return loss, {"ce": ce, "aux": aux}

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch, max_len, dtype=None):
        return tfm.stack_cache_init(self.cfg, batch, max_len,
                                    dtype or self.cfg.param_dtype,
                                    device=self.device)

    @torch.no_grad()
    def prefill(self, tokens, *, max_len, positions=None):
        """Forward the prompt AND build the decode cache in one pass.

        Returns (logits (b, t, V), cache); decode_step continues from
        pos = t.
        """
        x = self._embed(tokens)
        x, cache = tfm.stack_prefill(
            self.decoder, self.cfg, x,
            positions=self._positions(tokens, positions), max_len=max_len)
        return self._logits(x), cache

    @torch.no_grad()
    def decode_step(self, tokens, cache, pos: int):
        """tokens: (b, 1) -> (logits (b, 1, V), cache). The cache is updated
        in place and returned."""
        x = self._embed(tokens, add_pos=False)
        if self.cfg.pos_embed == "learned":
            x = x + self.pos_embed[int(pos)][None, None]
        x, cache = tfm.stack_decode(self.decoder, self.cfg, x, cache, pos)
        return self._logits(x), cache
