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

``wkv_bwd_ref(r, k, v, logw, u, dy, dS)`` is its gradient, the plain
version of W-bwd (``csrc/rwkv6_wkv_bwd.cu``): the states recomputed in
float32 (float64 for float64 inputs) from the start, kept at every
``CHUNK``-th step, each chunk's states rebuilt from its checkpoint, and
the reverse step taken over the chunk.

``wkv_bwd_chunked(r, k, v, logw, u, dy, dS, chunk)`` is the same gradient
in the kernel's chunked arithmetic, for the CPU tests: no path calls it.
"""
from __future__ import annotations

import torch

CHUNK = 512     # steps whose k ⊗ v is taken in one op
LOG2E = 1.4426950408889634


def _work(x):
    """x in float32, or as it is where it is float64."""
    return x if x.dtype == torch.float64 else x.float()


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
    where None); float64 inputs stay float64."""
    b, t, h, hd = r.shape
    work = _work(r).dtype
    S = (torch.zeros(b, h, hd, hd, dtype=work, device=r.device)
         if S0 is None else S0.to(work))
    rf, wf = _work(r)[..., None, :], torch.exp(_work(logw))[..., None]
    uf = _work(u)[..., None]
    ys = []
    for c in range(0, t, CHUNK):
        kv = (_work(k[:, c:c + CHUNK])[..., :, None]
              * _work(v[:, c:c + CHUNK])[..., None, :])  # (b,CHUNK,H,hd,hd)
        for r_t, kv_t, w_t in zip(rf[:, c:c + CHUNK].unbind(1), kv.unbind(1),
                                  wf[:, c:c + CHUNK].unbind(1)):
            y, S = wkv_step(S, r_t, kv_t, w_t, uf)
            ys.append(y)
    y = (torch.stack(ys, 1)[..., 0, :] if ys else
         torch.zeros(b, 0, h, hd, dtype=work, device=r.device))
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


def wkv_bwd_ref(r, k, v, logw, u, dy, dS=None):
    """The gradient of ``wkv_ref``'s (y, S_T) from a zero state at (dy,
    dS): (dr, dk, dv) in r's type, dlogw (b, T, H, hd) and du (H, hd) in
    float32 (float64 for float64 inputs); ``dS`` None is zero.

    With S_{t-1} the state before step t and G the gradient of the state
    after it (G = dS after the last step), each step from the last:

    - dr_t = S_{t-1} dy_t + u ⊙ k_t (dy_t · v_t);
    - dk_t = G v_t + r_t ⊙ u (dy_t · v_t);
    - dv_t = Gᵀ k_t + dy_t (r_t · (u ⊙ k_t));
    - dlogw_t = w_t ⊙ rowsum(G ⊙ S_{t-1}), w_t = exp(logw_t);
    - du += r_t ⊙ k_t (dy_t · v_t), summed over T, then the batch;
    - G ← diag(w_t) G + r_tᵀ dy_t.
    """
    b, t, h, hd = r.shape
    work = _work(r).dtype
    rf, kf, vf, lw, uf = (_work(x) for x in (r, k, v, logw, u))
    wf = torch.exp(lw)
    dyf = dy.to(work)
    G = (torch.zeros(b, h, hd, hd, dtype=work, device=r.device)
         if dS is None else dS.to(work).clone())
    starts = list(range(0, t, CHUNK))
    S = torch.zeros(b, h, hd, hd, dtype=work, device=r.device)
    ckpts = []
    for c in starts:
        ckpts.append(S)
        for i in range(c, min(c + CHUNK, t)):
            S = torch.addcmul(kf[:, i, :, :, None] * vf[:, i, :, None, :],
                              wf[:, i, :, :, None], S)
    dr, dk, dv, dlogw = (torch.empty(b, t, h, hd, dtype=work,
                                     device=r.device) for _ in range(4))
    du = torch.zeros(b, h, hd, dtype=work, device=r.device)
    for c, S in zip(reversed(starts), reversed(ckpts)):
        before = []
        for i in range(c, min(c + CHUNK, t)):
            before.append(S)
            S = torch.addcmul(kf[:, i, :, :, None] * vf[:, i, :, None, :],
                              wf[:, i, :, :, None], S)
        for i in range(min(c + CHUNK, t) - 1, c - 1, -1):
            Sp = before[i - c]
            r_t, k_t, v_t, w_t, dy_t = (x[:, i] for x in (rf, kf, vf, wf,
                                                           dyf))
            dyv = (dy_t * v_t).sum(-1, keepdim=True)          # (b, h, 1)
            dr[:, i] = (Sp @ dy_t[..., None])[..., 0] + uf * k_t * dyv
            dk[:, i] = (G @ v_t[..., None])[..., 0] + r_t * uf * dyv
            dv[:, i] = ((G.transpose(-1, -2) @ k_t[..., None])[..., 0]
                        + dy_t * (r_t * uf * k_t).sum(-1, keepdim=True))
            dlogw[:, i] = w_t * (G * Sp).sum(-1)
            du += r_t * k_t * dyv
            G = torch.addcmul(r_t[..., :, None] * dy_t[..., None, :],
                              w_t[..., :, None], G)
    return (dr.to(r.dtype), dk.to(r.dtype), dv.to(r.dtype), dlogw,
            du.sum(0))


def _suffix(x, dim, inclusive):
    """Σ over the indices after (``inclusive``: from) each index of ``dim``,
    summed from the last index back."""
    s = x.flip(dim).cumsum(dim).flip(dim)
    if inclusive:
        return s
    return torch.cat([s.narrow(dim, 1, x.shape[dim] - 1),
                      torch.zeros_like(x.narrow(dim, 0, 1))], dim)


def _prefix(x, dim):
    """Σ over the indices before each index of ``dim``."""
    s = x.cumsum(dim)
    return torch.cat([torch.zeros_like(x.narrow(dim, 0, 1)),
                      s.narrow(dim, 0, x.shape[dim] - 1)], dim)


def wkv_bwd_chunked(r, k, v, logw, u, dy, dS=None, chunk=16):
    """``wkv_bwd_ref``'s gradient in chunks of ``chunk`` steps, as
    ``csrc/rwkv6_wkv_bwd.cu`` computes it: the same outputs and types.

    Over a chunk from S0, with ``wkv_chunked``'s r̃_t = r_t ⊙ P_t, K̂_s =
    k_s ⊙ Q_s and D (P_t = 2^lb_t the decay before step t within the chunk,
    Q_s = 2^(L - lb_{s+1}) the decay after step s, D = 2^L, every log a sum
    of logw · log2 e), W[t, s] = w_{t-1} ⊙ ... ⊙ w_{s+1} (products of w =
    2^(logw · log2 e), 1 at s = t - 1) and the chunk's A (``wkv_chunked``),
    y = r̃ S0 + A V and S_end = D ⊙ S0 + K̂ᵀ V. Given dY and the gradient G
    of S_end (dS after the last chunk), chunks from the last:

    - the products: dr̃ = dY S0ᵀ, dK̂ = V Gᵀ, dV = Aᵀ dY + K̂ G, dA = dY Vᵀ
      and dD = rowsum(G ⊙ S0); then G ← D ⊙ G + r̃ᵀ dY;
    - through the decays, with M[t, s] = dA[t, s] r_t ⊙ k_s ⊙ W[t, s]
      for s < t:
      dr_t = dr̃_t ⊙ P_t + Σ_{s<t} dA[t, s] k_s ⊙ W[t, s] + u ⊙ k_t dA[t, t],
      dk_s = dK̂_s ⊙ Q_s + Σ_{t>s} dA[t, s] r_t ⊙ W[t, s] + u ⊙ r_s dA[s, s],
      du = Σ_t r_t ⊙ k_t dA[t, t] (over T, then the batch),
      dlogw_τ = D ⊙ dD + Σ_{s<τ} K̂_s ⊙ dK̂_s + Σ_{t>τ} (r̃_t ⊙ dr̃_t
      + Σ_{s<t} M[t, s]) - Σ_{s>=τ} Σ_{t>s} M[t, s].

    Every factor is a product of decays of at most 1 and none is inverted,
    so nothing overflows however fast the decay; dlogw's one subtraction
    cancels within a chunk. The states S0 come from a forward sweep (S ←
    D ⊙ S + K̂ᵀ V), kept at every chunk. The ragged last chunk is padded
    with r = k = v = dy = 0 and logw = 0, which change no valid output.
    Float32 (float64 for float64 inputs)."""
    b, t, h, hd = r.shape
    work = _work(r).dtype
    dev = r.device
    n = -(-t // chunk) * chunk
    nc = n // chunk

    def chunks_of(x):       # (b, t, h, hd) -> (b, h, nc, chunk, hd), padded
        x = x.to(work).permute(0, 2, 1, 3)
        x = torch.nn.functional.pad(x, (0, 0, 0, n - t))
        return x.reshape(b, h, nc, chunk, hd)

    rc, kc, vc, dyc = (chunks_of(x) for x in (r, k, v, dy))
    lg = chunks_of(logw) * LOG2E
    uf = _work(u).to(work)[None, :, None, None, :]        # (1, h, 1, 1, hd)
    lb1 = lg.cumsum(3)                                    # after each step
    lb = torch.nn.functional.pad(lb1, (0, 0, 1, 0))[..., :chunk, :]
    L = lb1[..., -1:, :]
    P, Q = torch.exp2(lb), torch.exp2(L - lb1)
    D = torch.exp2(L[..., 0, :])                          # (b, h, nc, hd)
    rt, kt = rc * P, kc * Q
    w = torch.exp2(lg)
    # W[t, s] as the kernel takes it: 1 at s = t - 1, then times w_{s+1}
    # as s falls; zero at s >= t
    W = torch.zeros(b, h, nc, chunk, chunk, hd, dtype=work, device=dev)
    for tt in range(1, chunk):
        q = torch.ones_like(w[..., 0, :])
        for s in range(tt - 1, -1, -1):
            W[..., tt, s, :] = q
            q = q * w[..., s, :]
    rkW = rc[..., :, None, :] * kc[..., None, :, :] * W    # r_t k_s W[t, s]
    eye = torch.eye(chunk, dtype=torch.bool, device=dev)
    diag = (rc * uf * kc).sum(-1)                          # r_t · (u ⊙ k_t)
    A = rkW.sum(-1) + torch.diag_embed(diag)               # (.., t, s)
    dA = dyc @ vc.transpose(-1, -2)
    dAd = dA.diagonal(0, -2, -1)[..., None]                # dA[t, t]
    # the forward sweep: the state each chunk starts from
    S = torch.zeros(b, h, hd, hd, dtype=work, device=dev)
    S0 = []
    for c in range(nc):
        S0.append(S)
        S = (D[:, :, c, :, None] * S
             + kt[:, :, c].transpose(-1, -2) @ vc[:, :, c])
    # the backward sweep: the chain and its products
    G = (torch.zeros(b, h, hd, hd, dtype=work, device=dev) if dS is None
         else dS.to(work).clone())
    drt, dkt, dv, dD = ([None] * nc for _ in range(4))
    for c in range(nc - 1, -1, -1):
        drt[c] = dyc[:, :, c] @ S0[c].transpose(-1, -2)
        dkt[c] = vc[:, :, c] @ G.transpose(-1, -2)
        dv[c] = (A[:, :, c].transpose(-1, -2) @ dyc[:, :, c]
                 + kt[:, :, c] @ G)
        dD[c] = (G * S0[c]).sum(-1)
        G = (D[:, :, c, :, None] * G
             + rt[:, :, c].transpose(-1, -2) @ dyc[:, :, c])
    drt, dkt, dv, dD = (torch.stack(x, 2) for x in (drt, dkt, dv, dD))
    # through the decays
    dAl = dA.masked_fill(eye, 0.0)[..., None]              # s < t only
    dr = (drt * P + (dAl * kc[..., None, :, :] * W).sum(-2)
          + uf * kc * dAd)
    dk = (dkt * Q + (dAl * rc[..., :, None, :] * W).sum(-3)
          + uf * rc * dAd)
    M = dAl * rkW
    dlogw = ((D * dD)[..., None, :] + _prefix(kt * dkt, 3)
             + _suffix(rt * drt + M.sum(-2), 3, False)
             - _suffix(M.sum(-3), 3, True))
    du = (rc * kc * dAd).sum((2, 3)).sum(0)

    def back(x):            # (b, h, nc, chunk, hd) -> (b, t, h, hd)
        return (x.reshape(b, h, n, hd)[:, :, :t].permute(0, 2, 1, 3)
                .contiguous())
    return (back(dr).to(r.dtype), back(dk).to(r.dtype), back(dv).to(r.dtype),
            back(dlogw), du)
