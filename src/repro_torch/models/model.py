"""Top-level model: embeddings, decoder stack, (optional) encoder, LM head.

Port of :mod:`repro.models.model` for the decoders, dense (qwen2-vl-7b's
M-RoPE among them), mixture-of-experts, hybrid (RG-LRU and local
attention, recurrentgemma-2b) and RWKV6 (rwkv6-3b), and for the
encoder-decoder (whisper-small), as an ``nn.Module`` that holds its
parameters:

  model = Model(cfg).init(seed)            # on the card unless device= given
  logits, aux = model.forward(tokens)      # frames=... for an encoder-decoder
  loss, metrics = model.loss(batch, remat=True)
  logits, cache = model.prefill(tokens, max_len=...)
  cache = model.init_cache(batch, max_len)
  logits, cache = model.decode_step(tokens, cache, pos)

An encoder-decoder (``cfg.encoder_layers > 0``) runs its encoder over
(stubbed) frame embeddings ``(b, Te, d)`` — the conv front end is a stub,
as in the reference — and every decoder layer cross-attends the encoder's
output: ``forward(tokens, frames=...)`` and ``loss`` with
``batch["frames"]``. It is served by ``fill_cross_cache`` and then
``decode_step``; ``prefill`` refuses it, as the reference's does.

A vision-language config (``cfg.mrope``, qwen2-vl) takes (b, 3, t)
(temporal, height, width) position ids; without ``positions`` every token
is text, with equal ids (i, i, i). Its vision front end is a stub, as in
the reference: ``forward(..., embeds=)`` and ``loss`` with
``batch["embeds"]`` take precomputed (b, t, d) embeddings in place of the
token embeddings (the caller puts the patch embeddings in the image's
span). ``prefill`` and the prefill serving step take token ids only, as
the reference's do. Decode steps carry equal ids (pos, pos, pos).

``Model(cfg)`` allocates the parameters uninitialised on the device, in
``cfg.param_dtype`` (an MoE router in float32, as the reference's);
``init`` draws them there from a ``torch.Generator`` one tensor at a time,
so a full-width model never has a float32 or host copy. ``models.params.params_from_jax`` fills one from the reference's
parameters instead.

``forward`` and ``loss`` are differentiable: the AdamW route turns the
parameters' gradients on with ``model.requires_grad_(True)`` (every
parameter is made with ``requires_grad=False``, so serving builds no
graph). Each kernel's gradient is a backward kernel: K3's is K3-bwd
(``kernels.flash_attention.ops``, head_dim 256 included), the hybrid's
RG-LRU's is S-bwd (``kernels.rglru_scan``) and RWKV6's recurrence's is
W-bwd (``kernels.rwkv6_wkv``); on CPU tensors their plain versions.
``prefill`` and ``decode_step`` run under ``torch.no_grad()``, and so does
``fill_cross_cache``.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import draw_, embed_init, make_norm


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device=None):
        super().__init__()
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
        if cfg.encoder_layers > 0:
            self.encoder = tfm.stack_init(self._encoder_cfg(), dtype, dev)
            self.enc_norm = norm_init(cfg.d_model, dtype, dev)
            self.enc_pos_embed = embed_init(cfg.encoder_len, cfg.d_model,
                                            dtype, dev)

    def _encoder_cfg(self) -> ArchConfig:
        return dataclasses.replace(
            self.cfg, n_layers=self.cfg.encoder_layers, pattern=("attn",),
            cross_attention=False, n_experts=0, first_dense=0,
            use_rope=False)

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
    def _embed(self, tokens, embeds=None, add_pos=True):
        """The token embeddings, or ``embeds`` (the stubbed front end's, in
        ``param_dtype``) in their place; learned positions are added to
        token embeddings only, as in the reference."""
        cfg = self.cfg
        if embeds is not None:
            x = embeds.to(cfg.param_dtype)
        else:
            x = self.embed[tokens]
        if cfg.embed_scale:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()
        if cfg.pos_embed == "learned" and embeds is None and add_pos:
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
            if self.cfg.mrope:              # text: equal (t, h, w) ids
                positions = positions[:, None].expand(b, 3, t)
        return positions

    # ------------------------------------------------------------- encoder
    def encode(self, frames):
        """Whisper-style encoder over (stubbed) frame embeddings (b, Te, d):
        learned positions, a non-causal stack, the final norm."""
        x = frames.to(self.cfg.param_dtype)
        x = x + self.enc_pos_embed[:x.shape[1]][None]
        x, _ = tfm.stack_apply(self.encoder, self._encoder_cfg(), x,
                               positions=None, causal=False)
        _, norm = make_norm(self.cfg.norm)
        return norm(self.enc_norm, x)

    def _cross_kvs(self, enc_out):
        """Each decoder layer's cross (k, v), in layer order."""
        return [attn_mod.cross_kv(lp["cross"], self.cfg, enc_out)
                for lp in self.decoder]

    # ------------------------------------------------------------- forward
    def forward(self, tokens, *, positions=None, embeds=None, frames=None,
                last_only=False, remat=False):
        """Full-sequence logits (b, t, V), or (b, 1, V) of the last position
        with ``last_only``. Returns (logits, aux), aux the MoE layers'
        summed load-balancing loss (0 for a dense model), each MoE layer at
        the config's capacity. ``remat`` recomputes each pattern unit of the
        layer groups in the backward pass (``transformer.stack_apply``).
        ``embeds`` (b, t, d) replaces the token embeddings (the stubbed
        vision front end). An encoder-decoder needs ``frames``: every
        decoder layer then cross-attends the encoder's output (the
        reference's ``_forward_encdec``)."""
        cross = None
        if self.cfg.encoder_layers > 0:
            if frames is None:
                raise ValueError("enc-dec arch needs frames")
            cross = self._cross_kvs(self.encode(frames))
        x, aux = tfm.stack_apply(self.decoder, self.cfg,
                                 self._embed(tokens, embeds),
                                 positions=self._positions(tokens, positions),
                                 causal=True, cross_kvs=cross, remat=remat)
        if last_only:
            x = x[:, -1:]
        return self._logits(x), aux

    # ------------------------------------------------------------------ loss
    def loss(self, batch, *, remat=False):
        """Next-token cross-entropy on float32 logits. batch: tokens (b,
        t+1) [+ positions, embeds, frames]. Returns (loss, {"ce", "aux"}); an MoE
        config's loss is ``ce + 0.01·aux``."""
        tokens = batch["tokens"]
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        logits, aux = self.forward(inputs, positions=batch.get("positions"),
                                   embeds=batch.get("embeds"),
                                   frames=batch.get("frames"), remat=remat)
        logp = torch.log_softmax(logits.float(), dim=-1)
        del logits
        ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
        ce = -ll.mean()
        loss = ce + 0.01 * aux if self.cfg.n_experts > 0 else ce
        return loss, {"ce": ce, "aux": aux}

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch, max_len, dtype=None):
        """Per-layer decode caches; an encoder-decoder's attention layers
        also hold zeroed ``cross_k``/``cross_v`` of ``encoder_len`` keys
        (``fill_cross_cache`` replaces them)."""
        return tfm.stack_cache_init(self.cfg, batch, max_len,
                                    dtype or self.cfg.param_dtype,
                                    with_cross=self.cfg.encoder_layers > 0,
                                    device=self.device)

    @torch.no_grad()
    def fill_cross_cache(self, cache, frames):
        """Run the encoder once and put each layer's projected cross K/V in
        its cache. Like the reference, this *replaces* ``cross_k`` and
        ``cross_v`` with the (b, hkv, Te, hd) projections of these frames,
        so frames shorter than ``encoder_len`` give shorter cross caches."""
        for lc, (k, v) in zip(cache, self._cross_kvs(self.encode(frames))):
            lc["cross_k"], lc["cross_v"] = k, v
        return cache

    @torch.no_grad()
    def prefill(self, tokens, *, max_len, positions=None):
        """Forward the prompt AND build the decode cache in one pass.

        Returns (logits (b, t, V), cache); decode_step continues from
        pos = t. Not for an encoder-decoder (whisper uses
        ``fill_cross_cache`` and decode, its decoder prompt being the short
        task prefix), as in the reference.
        """
        if self.cfg.encoder_layers > 0:
            raise ValueError("use fill_cross_cache for enc-dec")
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
