"""The port's LM training path (repro_torch.data, optim, train.abo_zo,
train.steps, launch.train, models.params' leaf map) against the JAX
package's, on the CPU, on the same numpy inputs. This file holds the data
stream, the leaf map, the key arithmetic and ABO-ZO's perturbation, and
the helpers and tolerances of the three files beside it:
``test_torch_train_abo_zo.py`` (the ABO-ZO step), ``test_torch_train_adamw.py``
(AdamW, the loss and its gradients, whole steps, remat) and
``test_torch_train_launch.py`` (resume and the launcher).

The reduced configs carry the reference's weights across
(``models.params.params_from_jax``) and its AdamW state
(``opt_state_from_jax``). The two mixture-of-experts configs (olmoe,
moonshot) take the dense decoders' cases: their trees mix a float32 router
with experts in the model's dtype, and their loss adds ``0.01·aux``. The
hybrid recurrentgemma-2b's tree, whose stacked groups mix RG-LRU and
attention layers by position in the unit, takes the leaf map and the
perturbation cases. Bit for bit where the arithmetic is integer or
one rounding an operation: the data stream, the key arithmetic, ABO-ZO's
perturbation over a whole tree (stacked groups included), the AdamW update
against the reference's op-by-op (unjitted) update with clipping off, and
the port's own remat and resume. Tolerances elsewhere, pinned from
measurement (CPU, float32, reduced configs; ``python
tests/torch_parity_report.py --only training``):

  * the loss and ABO-ZO's candidate losses, port vs JAX: 2e-5 absolute
    (losses ~6.2; measured <= 1.43e-6 and <= 9.5e-7);
  * gradients, per tensor: 1e-4 of the tensor's max |want| (measured
    <= 2.83e-6);
  * AdamW steps through ``make_train_step`` against the reference's jitted
    step (lr 3e-4, 1-3 steps): at most 1e-3 of the parameters more than
    1e-6 apart (measured <= 5.0e-5), and none more than 2·lr (measured
    1.16e-5): where a gradient element is near 0, m̂/√v̂ is near ±1 and
    its last bits move the update by up to lr. The jitted update also
    contracts some multiply-adds into FMAs;
  * gnorm: 1e-5 relative (measured <= 9.1e-7 over whole steps: the
    summation order differs);
    the AdamW update with clipping on, whose scale carries gnorm's
    difference: elements within 1e-6 absolute.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.data.synthetic import BigramStream as JStream
from repro.data.synthetic import StreamConfig as JStreamConfig
from repro.models.model import Model as JModel
from repro.train import abo_zo as jabo
from repro_torch.data.synthetic import BigramStream, StreamConfig
from repro_torch.kernels.perturb.ops import abo_zo_perturb, signs_plain
from repro_torch.models.params import (leaf_map, named_from_jax,
                                       params_from_jax, reference_leaves)
from repro_torch.train import abo_zo as tabo

CPU = "cpu"
LOSS_TOL = 2e-5
GRAD_TOL = 1e-4
STEP_TOL = 1e-6
STEP_SHARE = 1e-3
DENSE = ["mistral-nemo-12b", "h2o-danube-3-4b", "granite-20b",
         "internlm2-20b"]
MOE = ["olmoe-1b-7b", "moonshot-v1-16b-a3b"]
HYBRID = ["recurrentgemma-2b"]
VLM = ["qwen2-vl-7b"]
RWKV = ["rwkv6-3b"]
AUDIO = ["whisper-small"]
RECURRENT = HYBRID + RWKV


def _cfgs(arch, dtype=None):
    cj, ct = JC.reduced(JC.ARCHS[arch]), TC.reduced(TC.ARCHS[arch])
    if dtype is not None:
        cj = dataclasses.replace(cj, dtype=dtype)
        ct = dataclasses.replace(ct, dtype=dtype)
    return cj, ct


def _pair(arch, dtype=None, seed=3):
    cj, ct = _cfgs(arch, dtype)
    jm = JModel(cj)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = params_from_jax(ct, jax.tree.map(np.asarray, params), device=CPU)
    return jm, params, tm


def _bits(a) -> np.ndarray:
    """An array's bit patterns (bf16 as uint16)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a.view(np.uint32 if a.dtype.itemsize == 4 else np.uint64)


def _tbits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.detach().view(torch.int16).numpy().view(np.uint16)
    return t.detach().numpy().view(np.uint32)


def _batch(cfg, b=2, t=24, seed=5):
    toks = np.random.RandomState(seed).randint(0, cfg.vocab_size, (b, t + 1))
    return toks


def _frames(cfg, b=2, seed=6):
    """An encoder-decoder's stubbed frame embeddings (b, encoder_len, d),
    or None."""
    if not cfg.encoder_layers:
        return None
    return np.random.RandomState(seed).normal(
        size=(b, cfg.encoder_len, cfg.d_model)).astype(np.float32)


def _batches(cfg, toks, frames):
    """The same batch for both packages: (JAX's, the port's)."""
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if frames is not None:
        jb["frames"], tb["frames"] = (jnp.asarray(frames),
                                      torch.from_numpy(frames))
    return jb, tb


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 7])
def test_bigram_stream_bits(seed):
    jc = JStreamConfig(vocab_size=512, seq_len=33, global_batch=4, seed=seed)
    tc = StreamConfig(vocab_size=512, seq_len=33, global_batch=4, seed=seed)
    js, ts = JStream(jc), BigramStream(tc)
    assert np.array_equal(js.next_tokens, ts.next_tokens)
    for cursor in (0, 1, 7, 123, 10**6 + 3):
        want = js.batch(cursor)
        assert np.array_equal(ts.batch(cursor), want)
        got = ts.torch_batch(cursor, CPU)
        assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the leaf map and the reference's key arithmetic
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE + MOE + HYBRID + VLM)
def test_leaf_map_covers_the_reference_tree(arch):
    jm, params, tm = _pair(arch)
    leaves = jax.tree.leaves(params)
    ref = reference_leaves(tm.cfg)
    assert len(ref) == len(leaves)
    names = dict(tm.named_parameters())
    lm = leaf_map(tm.cfg)
    assert set(lm) == set(names)
    for i, (group, leaf) in enumerate(zip(ref, leaves)):
        sizes = [names[n].numel() for n in group]
        assert sum(sizes) == np.asarray(leaf).size
        off = 0
        for n, size in zip(group, sizes):
            assert lm[n] == (i, off)
            off += size
    # named_from_jax is the inverse of the stacking
    named = named_from_jax(tm.cfg, jax.tree.map(np.asarray, params))
    for n, p in names.items():
        assert np.array_equal(named[n], p.detach().numpy())


def test_key_arithmetic_matches_jax():
    for seed in (0, 1, 12345):
        assert tabo.prng_key(seed) == tuple(
            int(x) for x in np.asarray(jax.random.PRNGKey(seed)))
    key = jax.random.PRNGKey(1)
    for step in (0, 1, 17, 2**31 + 5):
        want = np.asarray(jax.random.fold_in(key, step))
        assert tabo.fold_in(tabo.prng_key(1), step) == tuple(int(x) for x in want)
    k = jax.random.fold_in(key, 3)
    splits = np.asarray(jax.random.split(k, 11))
    for i in range(11):
        assert tabo.split_key(tuple(int(x) for x in np.asarray(k)), i) == \
            tuple(int(x) for x in splits[i])
    assert np.array_equal(tabo.base_scales(9), np.asarray(jnp.linspace(-1.0, 1.0, 9)))


@pytest.mark.parametrize("offset", [0, 5, 1000])
def test_rademacher_signs_match_jax(offset):
    key = jax.random.PRNGKey(42)
    # JAX draws the whole leaf; compare the window [offset, offset + 64)
    want = np.asarray(jax.random.rademacher(key, (offset + 64,),
                                            jnp.int8))[offset:]
    got = signs_plain(tuple(int(x) for x in np.asarray(key)), offset, 64, CPU)
    assert np.array_equal(got.numpy(), want.astype(np.float32))


def test_rademacher_signs_high_counter_word():
    """A counter past 2^32 puts its high word into threefry's first input,
    as jax.random's iota_2x32_shape does for a leaf that large: checked
    against jax's threefry on the same (hi, lo) counter words."""
    from jax._src import prng as jprng
    key = (7, 99)
    c = np.arange(2**32 - 4, 2**32 + 4, dtype=np.uint64)
    hi, lo = (c >> 32).astype(np.uint32), (c & 0xFFFFFFFF).astype(np.uint32)
    x0, x1 = jprng.threefry_2x32(jnp.asarray(key, jnp.uint32),
                                 jnp.concatenate([hi, lo]).reshape(2, -1))
    bits = np.asarray(x0) ^ np.asarray(x1)
    want = np.where(bits >> 31, -1.0, 1.0).astype(np.float32)
    got = signs_plain(key, 2**32 - 4, 8, CPU)
    assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# ABO-ZO's perturbation (the step: test_torch_train_abo_zo.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE + MOE + HYBRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_perturb_bits_over_the_tree(arch, dtype):
    jm, params, tm = _pair(arch, dtype)
    key = jax.random.fold_in(jax.random.PRNGKey(1), 5)
    scale = np.float32(0.75) * np.float32(0.0123)
    want = named_from_jax(tm.cfg, jax.tree.map(
        np.asarray, jabo._perturb(params, key, scale)))
    src = dict(tm.named_parameters())
    dst = {n: torch.empty_like(p) for n, p in src.items()}
    tabo.perturb_(dst, src, leaf_map(tm.cfg),
                  tuple(int(x) for x in np.asarray(key)), scale)
    for n in src:
        assert np.array_equal(_tbits(dst[n]), _bits(want[n])), n
    # in place gives the same bits
    tabo.perturb_(src, src, leaf_map(tm.cfg),
                  tuple(int(x) for x in np.asarray(key)), scale)
    for n in src:
        assert np.array_equal(_tbits(src[n]), _bits(want[n])), n


def test_perturb_wrapper_checks():
    src = torch.zeros(4)
    with pytest.raises(ValueError, match="does not match"):
        abo_zo_perturb(torch.zeros(5), src, (0, 1), 0, 0.1)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        abo_zo_perturb(src.double(), src.double(), (0, 1), 0, 0.1)
    with pytest.raises(ValueError, match="uint32"):
        abo_zo_perturb(src, src, (0, 2**32), 0, 0.1)
