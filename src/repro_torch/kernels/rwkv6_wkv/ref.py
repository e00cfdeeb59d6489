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

``wkv_chunked(r, k, v, logw, u, chunk, sub)`` is the same function in the
kernel's chunked arithmetic (``csrc/rwkv6_wkv.cu``), for the CPU tests:
no path calls it.
"""
from __future__ import annotations

import torch

CHUNK = 512     # steps whose k ⊗ v is taken in one op
LOG2E = 1.4426950408889634


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


def wkv_chunked(r, k, v, logw, u, chunk=16, sub=16):
    """(y float32 (b, T, H, hd), S_T float32 (b, H, hd, hd)) from a zero
    state, in chunks of ``chunk`` steps cut into sub-chunks of ``sub``
    (``sub`` divides ``chunk``), as the kernel computes them.

    The logs are taken in base 2 (lg = logw · log2 e) and summed within
    each sub-chunk: ``lb`` before each step, ``lb1`` after it, ``L`` the
    sub-chunk's total, and ``B`` the totals of the chunk's earlier
    sub-chunks. Every factor is a power of 2 of a sum that is <= 0, so
    none overflows, however fast the decay:

    - r̃_τ = r_τ · 2^lb_τ and k̂_σ = k_σ · 2^(L - lb1_σ), relative to the
      start of τ's sub-chunk and to the end of σ's;
    - y_τ ⊇ (r̃_τ · 2^B_I)ᵀ S₀ and S_C = 2^B_C ⊙ S₀ + Σ_σ (k̂_σ ·
      2^(B_C - B_{J+1}))ᵀ v_σ, the chunk's products with the state;
    - the chunk's A[τ, σ] = Σ_i r_τ k_σ 2^(b_τ - b_{σ+1}) over i: between
      sub-chunks I > J the product r̃_I · diag(2^(B_I - B_{J+1})) · k̂_Jᵀ;
      within a sub-chunk the decay as a product of w = 2^lg, as the kernel
      takes it (q = r_τ at σ = τ - 1, then q ← q ⊙ w_σ as σ falls); on the
      diagonal r_τ · (u ⊙ k_τ); y_τ ⊇ Σ_σ A[τ, σ] v_σ.

    The ragged last chunk is padded with r = k = v = 0 and logw = 0, which
    leave y's valid rows and the state as they are. With ``chunk = sub``
    (the kernel's choice, 16) there are no products between sub-chunks.
    """
    if chunk % sub:
        raise ValueError(f"sub ({sub}) must divide chunk ({chunk})")
    b, t, h, hd = r.shape
    dev = r.device
    n = -(-t // chunk) * chunk

    def heads_first(x):     # (b, t, h, hd) -> (b, h, n, hd), zero-padded
        x = x.float().permute(0, 2, 1, 3)
        return torch.nn.functional.pad(x, (0, 0, 0, n - t))

    rf, kf, vf = heads_first(r), heads_first(k), heads_first(v)
    lg = heads_first(logw) * LOG2E
    uf = u.float()[None, :, None, :]                       # (1, h, 1, hd)
    ns = chunk // sub
    S = torch.zeros(b, h, hd, hd, dtype=torch.float32, device=dev)
    ys = []
    for c0 in range(0, n, chunk):
        sl = slice(c0, c0 + chunk)
        # (b, h, ns, sub, hd): sub-chunk J, step within it
        rc, kc, vc, lc = (x[:, :, sl].reshape(b, h, ns, sub, hd)
                          for x in (rf, kf, vf, lg))
        lb1 = lc.cumsum(3)                                  # after each step
        lb = torch.nn.functional.pad(lb1, (0, 0, 1, 0))[:, :, :, :sub]
        L = lb1[:, :, :, -1]                                # (b, h, ns, hd)
        B = torch.nn.functional.pad(L.cumsum(2), (0, 0, 1, 0))  # ns + 1
        rt = rc * torch.exp2(lb)
        kt = kc * torch.exp2(L[:, :, :, None] - lb1)
        # the products with the state
        y = (rt * torch.exp2(B[:, :, :ns, None])).reshape(b, h, chunk,
                                                           hd) @ S
        kc_end = kt * torch.exp2(B[:, :, -1:, None] - B[:, :, 1:, None])
        S = (torch.exp2(B[:, :, -1])[..., None] * S
             + kc_end.reshape(b, h, chunk, hd).transpose(2, 3)
             @ vc.reshape(b, h, chunk, hd))
        # the chunk's A, lower triangle and diagonal
        A = torch.zeros(b, h, chunk, chunk, dtype=torch.float32, device=dev)
        for I in range(ns):
            ri, rs = slice(I * sub, (I + 1) * sub), rc[:, :, I]
            for J in range(I):
                gap = torch.exp2(B[:, :, I] - B[:, :, J + 1])  # (b, h, hd)
                A[:, :, ri, J * sub:(J + 1) * sub] = (
                    rt[:, :, I] * gap[:, :, None]) @ kt[:, :, J].transpose(
                        2, 3)
            w = torch.exp2(lc[:, :, I])                     # (b, h, sub, hd)
            for t0 in range(sub):
                q = rs[:, :, t0]
                for s0 in range(t0 - 1, -1, -1):
                    A[:, :, I * sub + t0, I * sub + s0] = (
                        q * kc[:, :, I, s0]).sum(-1)
                    q = q * w[:, :, s0]
            A[:, :, ri, ri] += torch.diag_embed((rs * uf * kc[:, :, I]).sum(-1))
        y = y + A @ vc.reshape(b, h, chunk, hd)
        ys.append(y)
    y = (torch.cat(ys, 2)[:, :, :t] if ys else
         torch.zeros(b, h, 0, hd, dtype=torch.float32, device=dev))
    return y.permute(0, 2, 1, 3).contiguous(), S
