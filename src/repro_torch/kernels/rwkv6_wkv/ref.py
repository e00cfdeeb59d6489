"""The plain version of W, RWKV6's WKV recurrence.

``wkv_ref(r, k, v, logw, u)`` steps, for each batch row and head, a float32
(dk x dv) state S over T from zero, with the reference's step: ``kv = k_t
⊗ v_t``, ``y_t = r_t · (S + u ⊙ kv)`` summed over dk, ``S ← exp(logw_t) ⊙
S + kv`` (the decay indexes dk). r, k and v are (b, T, H, hd) in the
model's type, logw (b, T, H, hd) and u (H, hd) float32; it returns y
float32 (b, T, H, hd) and the last state float32 (b, H, hd, hd). The
products k_t ⊗ v_t are taken in one op for each ``CHUNK`` steps ahead of
stepping them (the same numbers), so a step is three launches
(``wkv_step``) and the memory stays bounded in T. The decode step
(``models.rwkv6.rwkv6_decode_step``) runs the same step through
``wkv_decode``, so the two cannot drift.

It stands for the ``jax.lax.scan`` of ``rwkv6_apply`` and
``rwkv6_prefill`` in ``src/repro/models/rwkv6.py`` (their ``step``). A
plain loop of tensor ops over T: the CPU tests use it, and ``chip_smoke.py``
holds W against it on the card; no main path runs it where there is one.
"""
from __future__ import annotations

import torch

CHUNK = 512     # steps whose k ⊗ v is taken in one op


def wkv_step(S, r_t, kv_t, w_t, u):
    """One step from S (b, H, hd, hd) on r_t (b, H, 1, hd), kv_t = k_t ⊗ v_t
    (b, H, hd, hd), the decay w_t = exp(logw_t) (b, H, hd, 1) and u (H, hd,
    1), all float32. Returns (y_t (b, H, 1, hd), the next S)."""
    y = r_t @ torch.addcmul(S, u, kv_t)
    return y, torch.addcmul(kv_t, w_t, S)


def wkv_decode(S, r_t, k_t, v_t, logw_t, u):
    """One step on r_t, k_t, v_t (b, H, hd) of any float type, logw_t
    (b, H, hd) and u (H, hd): (y_t float32 (b, H, hd), the next S)."""
    kv = k_t.float()[..., :, None] * v_t.float()[..., None, :]
    y, S = wkv_step(S, r_t.float()[..., None, :], kv,
                    torch.exp(logw_t.float())[..., None], u.float()[..., None])
    return y[..., 0, :], S


def wkv_ref(r, k, v, logw, u, S0=None):
    """(y float32 (b, T, H, hd), S_T float32 (b, H, hd, hd)), from S0 (zero
    where None)."""
    b, t, h, hd = r.shape
    S = (torch.zeros(b, h, hd, hd, dtype=torch.float32, device=r.device)
         if S0 is None else S0.float())
    rf, wf = r.float()[..., None, :], torch.exp(logw.float())[..., None]
    uf = u.float()[..., None]
    ys = []
    for c in range(0, t, CHUNK):
        kv = (k[:, c:c + CHUNK].float()[..., :, None]
              * v[:, c:c + CHUNK].float()[..., None, :])  # (b,CHUNK,H,hd,hd)
        for r_t, kv_t, w_t in zip(rf[:, c:c + CHUNK].unbind(1), kv.unbind(1),
                                  wf[:, c:c + CHUNK].unbind(1)):
            y, S = wkv_step(S, r_t, kv_t, w_t, uf)
            ys.append(y)
    y = (torch.stack(ys, 1)[..., 0, :] if ys else
         torch.zeros(b, 0, h, hd, dtype=torch.float32, device=r.device))
    return y, S
