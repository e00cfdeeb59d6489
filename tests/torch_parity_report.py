"""Measure how far the PyTorch port is from the JAX package on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_parity_report.py

Prints, on the inputs of the parity tests (tests/test_torch_*.py), the
largest discrepancies those tests hold to a tolerance: objective terms and
aggregates, one sweep pass of the kernel route's plain version against the
JAX oracle, seeded starts (float32, and float64 with 64-bit seeds under
x64), whole solves of both routes at ``--n-solve`` (default 1e6) for
Griewank and the sphere, the plain attention against the JAX package's
interpreted kernel and plain version, the reduced dense models with the
reference's weights carried across, and their training path (the loss and
its gradients, ABO-ZO's candidate losses, AdamW's update with clipping on
and whole AdamW steps, on tests/test_torch_train.py's inputs), and
RWKV6's pieces, its recurrence's plain version, a layer and the reduced
rwkv6-3b on tests/test_torch_rwkv6.py's inputs, and how far a relative
1e-6 nudge of RWKV6's recurrence moves a 32-layer random-weight model's
logits in each package (``rwkv6_sensitivity``, ~2 min). The
tolerances in the tests and in PERF.md come from these numbers. ``--only
NAME ...`` runs some sections.
"""
from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.core.abo as JA
import repro.objectives as J
import repro_torch.core.abo as TA
import repro_torch.objectives as T
from repro.kernels.coord_sweep.ops import pack_aggs
from repro.kernels.coord_sweep.ref import sweep_pass_ref as j_sweep_ref
from repro_torch.kernels.coord_sweep.ref import sweep_pass_ref
from repro.configs import ARCHS as J_ARCHS, reduced as j_reduced
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.models.model import Model as JModel
from repro_torch.configs import ARCHS as T_ARCHS, reduced as t_reduced
from repro_torch.kernels.flash_attention.ops import flash_attention_plain
from repro_torch.models.params import params_from_jax

SIZES = [100, 4096, 10_000, 3 * 4096 + 5]
SHAPES = [(1, 128, 16), (4, 256, 64), (3, 512, 128), (2, 128, 33)]
CASES = [(0.0, True), (0.5, False), (1.0, False)]


def objectives_report() -> dict:
    out = {}
    for name, oj in J.OBJECTIVES.items():
        ot = T.OBJECTIVES[name]
        term_err, agg_rel = np.zeros(oj.n_aggs), np.zeros(oj.n_aggs)
        for n in SIZES:
            x = np.random.RandomState(1).uniform(oj.lower, oj.upper,
                                                 n).astype(np.float32)
            tj = np.asarray(oj.terms(jnp.arange(n), jnp.asarray(x)), np.float64)
            tt = ot.terms(torch.arange(n), torch.from_numpy(x)).double().numpy()
            term_err = np.maximum(term_err, (np.abs(tt - tj)
                                             / (1 + np.abs(tj))).max(axis=0))
            pad = np.ones(-n % 4096, np.float32)    # see test_torch_objectives
            aj = np.asarray(oj.aggregates(jnp.asarray(np.concatenate([x, pad])),
                                          n), np.float64)
            at = ot.aggregates(torch.from_numpy(x), n).double().numpy()
            agg_rel = np.maximum(agg_rel, np.abs(at - aj) / np.abs(aj))
        out[name] = {"term_err_over_1_plus_abs": term_err.tolist(),
                     "aggregate_rel_err": agg_rel.tolist()}
    return out


def sweep_report() -> dict:
    x_same, agg_err = 1.0, np.zeros(3)
    for n_blocks, block, m in SHAPES:
        for lam, is_first in CASES:
            rng = np.random.RandomState(block + m)
            x2d = rng.uniform(-600, 600, (n_blocks, block)).astype(np.float32)
            n = n_blocks * block - 17
            aggs = np.asarray(pack_aggs(J.GRIEWANK.aggregates(
                jnp.asarray(x2d.reshape(-1)), n, agg_dtype=jnp.float32)))
            kw = dict(m=m, n_valid=n, half_width=37.5, lam=lam,
                      is_first=is_first)
            xj, aj = j_sweep_ref(jnp.asarray(x2d), jnp.asarray(aggs),
                                 lower=-600.0, upper=600.0, **kw)
            xt, at = sweep_pass_ref(torch.from_numpy(x2d.copy()),
                                    torch.from_numpy(aggs.copy()),
                                    lower=-600.0, upper=600.0, **kw)
            x_same = min(x_same, float((xt.numpy() == np.asarray(xj)).mean()))
            err = np.abs(at.numpy()[0, :3].astype(np.float64)
                         - np.asarray(aj)[0, :3])
            agg_err = np.maximum(agg_err,
                                 err / (1 + np.abs(aggs[0, :3].astype(float))))
    return {"x_identical_min": x_same,
            "aggs_err_over_1_plus_abs_in": agg_err.tolist()}


def seeded_report() -> dict:
    mismatches = 0
    for seed in (0, 7, 123456789, 2**31 + 5):
        a = np.asarray(JA.seeded_start(seed, 200_000, jnp.float32, -600.0,
                                       600.0)).view(np.uint32)
        b = TA.seeded_start(seed, 200_000, torch.float32, -600.0, 600.0,
                            device="cpu").numpy().view(np.uint32)
        mismatches += int((a != b).sum())
    mismatches64 = 0
    for seed in (0, 7, 2**40 + 3):
        with jax.enable_x64(True):
            a = np.asarray(JA.seeded_start(seed, 200_000, jnp.float64, -600.0,
                                           600.0)).view(np.uint64)
        b = TA.seeded_start(seed, 200_000, torch.float64, -600.0, 600.0,
                            device="cpu").numpy().view(np.uint64)
        mismatches64 += int((a != b).sum())
    return {"float32_bit_mismatches": mismatches,
            "float64_x64_bit_mismatches": mismatches64}


# (b, hq, hkv, sq, sk, d, window, causal, dtype) of
# tests/test_torch_flash_attention.py
ATTN_CASES = [
    (2, 4, 4, 256, 256, 64, None, True, "float32"),
    (1, 8, 2, 384, 384, 128, None, True, "float32"),
    (2, 4, 1, 256, 256, 64, None, True, "float32"),
    (2, 4, 4, 256, 256, 64, 128, True, "float32"),
    (1, 2, 2, 128, 128, 64, None, False, "float32"),
    (1, 2, 2, 200, 200, 64, 48, True, "float32"),
    (1, 4, 2, 2100, 2100, 32, 300, True, "float32"),
    (1, 2, 2, 128, 128, 64, None, True, "bfloat16"),
    (1, 8, 2, 200, 200, 128, None, True, "bfloat16"),
    (2, 4, 1, 96, 96, 120, None, True, "bfloat16"),
]


def attention_report() -> dict:
    out = {}
    for b, hq, hkv, sq, sk, d, win, causal, dt in ATTN_CASES:
        rng = np.random.RandomState(sq + d)
        arrs = [rng.normal(size=s).astype(np.float32)
                for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]
        got = flash_attention_plain(
            *(torch.from_numpy(a).to(getattr(torch, dt)) for a in arrs),
            causal=causal, window=win).float().numpy()
        errs = {}
        for impl in (("ref", "interpret") if sk <= 2048 else ("ref",)):
            want = j_flash(*(jnp.asarray(a).astype(getattr(jnp, dt))
                             for a in arrs), causal=causal, window=win,
                           impl=impl)
            errs[impl] = float(np.abs(got - np.asarray(
                want.astype(jnp.float32))).max())
        out[f"{(b, hq, hkv, sq, sk, d, win, causal)} {dt}"] = errs
    return out


def models_report() -> dict:
    out = {}
    for arch in ("mistral-nemo-12b", "h2o-danube-3-4b", "granite-20b",
                 "internlm2-20b"):
        jm = JModel(j_reduced(J_ARCHS[arch]))
        params = jm.init(jax.random.PRNGKey(3))
        tm = params_from_jax(t_reduced(T_ARCHS[arch]),
                             jax.tree.map(np.asarray, params), device="cpu")
        swa = tm.cfg.window is not None
        tp, max_len = (50, tm.cfg.window) if swa else (40, 64)
        toks = np.random.RandomState(4).randint(0, 512, (2, tp + 6))
        lj = np.asarray(jm.forward(params, jnp.asarray(toks))[0])
        lt = tm.forward(torch.from_numpy(toks))[0].numpy()
        pj, cj = jm.prefill(params, jnp.asarray(toks[:, :tp]), max_len=max_len)
        pt, ct = tm.prefill(torch.from_numpy(toks[:, :tp]), max_len=max_len)
        dec = 0.0
        for i in range(tp, tp + 6):
            gj, cj = jm.decode_step(params, jnp.asarray(toks[:, i:i + 1]), cj,
                                    jnp.asarray(i))
            gt, ct = tm.decode_step(torch.from_numpy(toks[:, i:i + 1]), ct, i)
            dec = max(dec, float(np.abs(gt.numpy() - np.asarray(gj)).max()))
        out[arch] = {"forward": float(np.abs(lt - lj).max()),
                     "prefill": float(np.abs(pt.numpy()
                                             - np.asarray(pj)).max()),
                     "decode": dec, "max_abs_logit": float(np.abs(lj).max())}
    return out


def rwkv6_report() -> dict:
    """RWKV6's pieces, the WKV recurrence, a layer and the reduced model on
    tests/test_torch_rwkv6.py's inputs: max abs differences beside the
    reference's max abs value."""
    import repro.models.rwkv6 as JR
    import repro.models.transformer as JT
    import repro_torch.models.rwkv6 as TR
    import test_torch_rwkv6 as case
    from repro_torch.kernels.rwkv6_wkv.ref import wkv_ref
    from repro_torch.models import transformer as tfm

    def diff(got, want):
        want = np.asarray(want, dtype=np.float32)
        return [float(np.abs(np.asarray(got, np.float32) - want).max()),
                float(np.abs(want).max())]

    w = case.make_weights()
    cfg, jcfg = case.CFG, case.JCFG
    out = {}
    x, xp = case._pair_x(0, 33)
    out["ddlerp"] = max(diff(g, j) for g, j in zip(
        TR._ddlerp(w["t"], torch.from_numpy(x), torch.from_numpy(xp)),
        JR._ddlerp(w["j"], jnp.asarray(x), jnp.asarray(xp))))
    xw = case._inputs(1, 2, 33, 64)
    out["decay"] = diff(TR._decay(w["t"], torch.from_numpy(xw)),
                        JR._decay(w["j"], jnp.asarray(xw)))
    y = case._inputs(2, 2, 9, 64, scale=3.0) + 1.0
    out["group_norm"] = diff(TR._group_norm(w["t"], torch.from_numpy(y), 4),
                             JR._group_norm(w["j"], jnp.asarray(y), 4))
    for t in case.SEQ_LENS:
        x = case._inputs(3 + t, 2, t, 64)
        xj = jnp.asarray(x)
        xpj = jnp.pad(xj, ((0, 0), (1, 0), (0, 0)))[:, :-1]
        r, k, v, _, logw = JR._project(w["j"], jcfg, xj, xpj)
        seen = []
        gn = JR._group_norm
        JR._group_norm = lambda p, y, n, eps=1e-5: seen.append(y) or gn(
            p, y, n, eps)
        try:
            JR.rwkv6_apply(w["j"], jcfg, xj)
        finally:
            JR._group_norm = gn
        s_want = JR.rwkv6_prefill(w["j"], jcfg, xj)[1]["S"]
        yt, st = wkv_ref(*(torch.from_numpy(np.array(a))
                           for a in (r, k, v, logw)), w["t"]["bonus_u"])
        out[f"wkv_y_T{t}"] = diff(yt.reshape(2, t, 64), seen[0])
        out[f"wkv_S_T{t}"] = diff(st, s_want)
    x = case._inputs(4, 2, 24, 64)
    out["time_mix"] = diff(TR.rwkv6_apply(w["t"], cfg, torch.from_numpy(x)),
                           JR.rwkv6_apply(w["j"], jcfg, jnp.asarray(x)))
    _, st = TR.rwkv6_prefill(w["t"], cfg, torch.from_numpy(x[:, :16]))
    _, sj = JR.rwkv6_prefill(w["j"], jcfg, jnp.asarray(x[:, :16]))
    dt, _ = TR.rwkv6_decode_step(w["t"], cfg, torch.from_numpy(x[:, 16:17]),
                                 st)
    dj, _ = JR.rwkv6_decode_step(w["j"], jcfg, jnp.asarray(x[:, 16:17]), sj)
    out["decode_step"] = diff(dt, dj)
    x, _ = case._pair_x(5, 21)
    out["channel_mix"] = diff(TR.channel_mix_full(w["tc"], torch.from_numpy(x)),
                              JR.channel_mix_full(w["jc"], jnp.asarray(x)))
    jp = JT.layer_init(jax.random.PRNGKey(6), jcfg, 0, jnp.float32)
    tp = tfm.layer_init(cfg, 0, torch.float32, "cpu")
    with torch.no_grad():
        for part, leaves in jp.items():
            for name, a in leaves.items():
                tp[part][name].copy_(torch.from_numpy(np.array(a)))
    x = case._inputs(7, 2, 20, 64)
    out["layer"] = diff(tfm.layer_apply(tp, cfg, "rwkv6", "channel_mix",
                                        torch.from_numpy(x), positions=None)[0],
                        JT.layer_apply(jp, jcfg, "rwkv6", "channel_mix",
                                       jnp.asarray(x), positions=None)[0])
    jm = JModel(jcfg)
    params = jm.init(jax.random.PRNGKey(3))
    tm = params_from_jax(cfg, jax.tree.map(np.asarray, params), device="cpu")
    toks = np.random.RandomState(4).randint(0, 512, (2, 36))
    out["model_forward"] = diff(tm.forward(torch.from_numpy(toks))[0],
                                jm.forward(params, jnp.asarray(toks))[0])
    pt, ct = tm.prefill(torch.from_numpy(toks[:, :30]), max_len=64)
    pj, cj = jm.prefill(params, jnp.asarray(toks[:, :30]), max_len=64)
    out["model_prefill"] = diff(pt, pj)
    out["model_cache_S"] = max(
        diff(lc["rec"]["S"], want["S"])
        for lc, want in zip(ct, case._layer_caches(cj)))
    gt, _ = tm.decode_step(torch.from_numpy(toks[:, 30:31]), ct, 30)
    gj, _ = jm.decode_step(params, jnp.asarray(toks[:, 30:31]), cj,
                           jnp.asarray(30))
    out["model_decode"] = diff(gt, gj)
    return out


def rwkv6_sensitivity_report() -> dict:
    """How far a relative 1e-6 nudge of the recurrence's output, in every
    layer, moves a random-weight RWKV6's logits, in both packages on the
    same weights and the same nudge: rwkv6-3b's pattern cut to d 512
    (8 heads of 64, d_ff 1792), 32 layers, vocab 4096, T 64, in float32 and
    bf16. Max over positions of max |diff| over max |logit|, and the share
    of positions whose argmax agrees."""
    import dataclasses

    import repro.models.rwkv6 as JR
    from repro_torch.models import rwkv6 as TR

    def distance(a, b):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        return [float((np.abs(a - b).max(-1) / np.abs(b).max(-1)).max()),
                float((a.argmax(-1) == b.argmax(-1)).mean())]

    t = 64
    nudge = 1 + 1e-6 * np.random.RandomState(0).normal(
        size=(1, t, 512)).astype(np.float32)
    toks = np.random.RandomState(1).randint(0, 4096, (1, t))
    out = {}
    for dt in ("float32", "bfloat16"):
        shape = dict(d_model=512, n_layers=32, rwkv_heads=8, n_heads=8,
                     n_kv_heads=8, d_ff=1792, vocab_size=4096, dtype=dt)
        jcfg = dataclasses.replace(J_ARCHS["rwkv6-3b"], **shape)
        jm = JModel(jcfg)
        params = jm.init(jax.random.PRNGKey(0))
        tm = params_from_jax(dataclasses.replace(T_ARCHS["rwkv6-3b"],
                                                 **shape),
                             jax.tree.map(np.asarray, params), device="cpu")
        base_j = jm.forward(params, jnp.asarray(toks))[0]
        gn = JR._group_norm
        JR._group_norm = lambda p, y, n, eps=1e-5: gn(
            p, y * jnp.asarray(nudge), n, eps)
        try:
            nudged_j = jm.forward(params, jnp.asarray(toks))[0]
        finally:
            JR._group_norm = gn
        with torch.no_grad():
            base_t = tm.forward(torch.from_numpy(toks))[0].float()
            wkv = TR.rwkv6_wkv
            TR.rwkv6_wkv = lambda *a: (
                wkv(*a)[0] * torch.from_numpy(nudge).view(1, t, 8, 64),
                wkv(*a)[1])
            try:
                nudged_t = tm.forward(torch.from_numpy(toks))[0].float()
            finally:
                TR.rwkv6_wkv = wkv
        out[dt] = {"jax": distance(nudged_j[0], base_j[0]),
                   "port": distance(nudged_t[0].numpy(), base_t[0].numpy()),
                   "port_vs_jax": distance(base_t[0].numpy(), base_j[0])}
    return out


def training_report() -> dict:
    """tests/test_torch_train.py's comparisons, measured: the largest
    discrepancy each holds to a tolerance."""
    import test_torch_train as TT
    out = {"loss": 0.0, "grad_rel": 0.0, "candidate_loss": 0.0}
    for arch in TT.DENSE:
        jm, params, tm = TT._pair(arch)
        toks = TT._batch(tm.cfg)
        (lj, _), gj = jax.value_and_grad(
            lambda p: jm.loss(p, {"tokens": jnp.asarray(toks)}),
            has_aux=True)(params)
        tm.requires_grad_(True)
        lt, _ = tm.loss({"tokens": torch.from_numpy(toks)})
        lt.backward()
        out["loss"] = max(out["loss"], abs(float(lt.detach()) - float(lj)))
        want = TT.named_from_jax(tm.cfg, jax.tree.map(np.asarray, gj))
        for n, p in tm.named_parameters():
            out["grad_rel"] = max(out["grad_rel"], float(
                np.abs(p.grad.numpy() - want[n]).max()
                / np.abs(want[n]).max()))
    for arch in ("mistral-nemo-12b", "granite-20b"):
        jm, params, tm = TT._pair(arch)
        toks = TT._batch(tm.cfg)
        key = jax.random.fold_in(jax.random.PRNGKey(1), 2)
        state = {"step": jnp.asarray(3, jnp.int32),
                 "window": jnp.asarray(0.05, jnp.float32)}
        fs, _ = TT._ref_candidates(jm, params, {"tokens": jnp.asarray(toks)},
                                   key, state, 9)
        names = dict(tm.named_parameters())
        probe = {n: torch.empty_like(p) for n, p in names.items()}
        dk = TT.tabo.fold_in(tuple(int(x) for x in np.asarray(key)), 3)
        with torch.no_grad():
            got = [float(tm.loss({"tokens": torch.from_numpy(toks)})[0])]
            for sc in TT.tabo.base_scales(9):
                TT.tabo.perturb_(probe, names, TT.leaf_map(tm.cfg), dk,
                                 sc * np.float32(0.05))
                with TT.tabo._swapped(names, probe):
                    got.append(float(tm.loss(
                        {"tokens": torch.from_numpy(toks)})[0]))
        out["candidate_loss"] = max(out["candidate_loss"], float(
            np.abs(np.array(got) - np.array(fs)).max()))
    steps = {}
    for arch, remat, mb, n in (("mistral-nemo-12b", False, 1, 3),
                               ("mistral-nemo-12b", True, 1, 3),
                               ("h2o-danube-3-4b", True, 2, 2)):
        runs, err, _ = TT._adamw_runs(arch, remat=remat, microbatches=mb,
                                      steps=n)
        steps[f"{arch} remat={remat} microbatches={mb} steps={n}"] = {
            "param_max": float(err.max()),
            "share_over_1e-6": float((err > 1e-6).mean()),
            "loss": max(abs(a - b) for a, b, _, _ in runs),
            "gnorm_rel": max(abs(c - d) / c for _, _, c, d in runs)}
    out["adamw_steps"] = steps
    return out


def solves_report(n: int) -> dict:
    out = {}
    for name in ("griewank", "sphere"):
        rj = JA.abo_minimize(J.OBJECTIVES[name], n)
        rt = TA.abo_minimize(T.OBJECTIVES[name], n, device="cpu")
        out[name] = {"n": n, "jax_fun": rj.fun, "torch_fun": rt.fun,
                     "x_identical": float((rt.x.numpy()
                                           == np.asarray(rj.x)).mean())}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-solve", type=int, default=10**6)
    ap.add_argument("--only", nargs="*", default=None)
    args = ap.parse_args()
    for key, fn in (("objectives", objectives_report), ("sweep", sweep_report),
                    ("seeded_start", seeded_report),
                    ("solves", lambda: solves_report(args.n_solve)),
                    ("attention", attention_report),
                    ("models", models_report),
                    ("training", training_report),
                    ("rwkv6", rwkv6_report),
                    ("rwkv6_sensitivity", rwkv6_sensitivity_report)):
        if args.only is None or key in args.only:
            print(json.dumps({key: fn()}), flush=True)


if __name__ == "__main__":
    main()
