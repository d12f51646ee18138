"""The port's sampler (``repro_torch.sample``) against the JAX reference's
``repro.sample``, on the CPU.

* Bitwise: the threefry keys ``token_key(seed, position)``, 64,000 random
  bits and uniforms per key, over seeds {0, 1, 3, 2**31, 2**32 - 1} x
  positions {0, 1, 2, 127, 4095}; ``_mask_top_k``.
* Within tolerance: the Gumbel draws (torch's ``log`` and XLA's differ by
  an ulp), the top-p keep sets (the two ``cumsum`` orders differ by an
  ulp), and ``sample_from_logits`` over a grid of temperature, top-k,
  top-p, seeds and positions, where a token may differ only at a counted
  near tie.
* The reference's sampler invariants (``tests/test_sample.py``) inside
  the port, one parametrised case each.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401  (autouse)
from repro.sample import SamplerRows as JSamplerRows
from repro.sample import kernel as jkernel
from repro.sample import rng as jrng
from repro_torch.sample import (SamplerRows, SamplerSpec, rng,
                                sample_from_logits, sample_token,
                                select_tokens)
from repro_torch.sample import kernel

SEEDS = (0, 1, 3, 2**31, 2**32 - 1)
POSITIONS = (0, 1, 2, 127, 4095)
VOCAB = 64000  # yi-6b's
EPS = float(np.finfo(np.float32).eps)
# Gumbel: -log(-log(u)) on bitwise-equal u; each log may differ from XLA's
# by an ulp, which moves g by about eps * max(1, |g|); measured 1.81
GUMBEL_ULPS = 4
# top-p: the prefix masses of the two cumsum orders differ by up to
# 1.2e-7 (about one ulp of 1.0); a token's keep decision may differ only
# where the mass before it lies that close to p
TOP_P_MASS_TOL = 2 * EPS


def _ref_key(seed, pos) -> np.ndarray:
    key = jrng.token_key(seed, pos)
    if jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
        key = jax.random.key_data(key)
    return np.asarray(key).astype(np.int64)


def _ref_rows(specs, positions) -> JSamplerRows:
    return JSamplerRows.from_specs(specs, positions)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_bits_uniforms_bitwise(seed):
    keys = rng.token_key(torch.tensor(seed), torch.tensor(POSITIONS))
    bits = rng.random_bits(keys, VOCAB).numpy()
    uni = rng.uniform(keys, VOCAB).numpy()
    for i, pos in enumerate(POSITIONS):
        want = _ref_key(seed, pos)
        np.testing.assert_array_equal(keys[i].numpy(), want)
        jkey = jrng.token_key(seed, pos)
        np.testing.assert_array_equal(
            bits[i], np.asarray(jax.random.bits(jkey, (VOCAB,), jnp.uint32)))
        ju = np.asarray(jax.random.uniform(jkey, (VOCAB,), jnp.float32))
        np.testing.assert_array_equal(uni[i].view(np.int32),
                                      ju.view(np.int32))
    assert uni.min() >= 0.0 and uni.max() < 1.0


def test_prng_key_and_fold_in_bitwise():
    """The two pieces of ``token_key`` alone, on 64-bit-wide inputs."""
    for seed in SEEDS:
        want = np.asarray(jax.random.key_data(jax.random.PRNGKey(
            jnp.asarray(seed, jnp.uint32)))).astype(np.int64)
        np.testing.assert_array_equal(rng.PRNGKey(seed).numpy(), want)
    key = rng.PRNGKey(torch.tensor(SEEDS))
    folded = rng.fold_in(key, torch.tensor([5, 0, 2**31 - 1, 77, 4095]))
    for i, (seed, data) in enumerate(zip(SEEDS, (5, 0, 2**31 - 1, 77,
                                                 4095))):
        base = jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32))
        want = jax.random.fold_in(base, data)
        np.testing.assert_array_equal(
            folded[i].numpy(), np.asarray(jax.random.key_data(want)
                                          if jnp.issubdtype(
                                              want.dtype,
                                              jax.dtypes.prng_key)
                                          else want).astype(np.int64))


def test_gumbel_within_ulps():
    seeds = torch.tensor(SEEDS).repeat_interleave(len(POSITIONS))
    positions = torch.tensor(POSITIONS).repeat(len(SEEDS))
    got = rng.gumbel(rng.token_key(seeds, positions), VOCAB).double()
    worst = 0.0
    for i in range(len(seeds)):
        jkey = jrng.token_key(int(seeds[i]), int(positions[i]))
        want = np.asarray(jax.random.gumbel(jkey, (VOCAB,), jnp.float32),
                          np.float64)
        err = (np.abs(got[i].numpy() - want)
               / np.maximum(1.0, np.abs(want)) / EPS)
        worst = max(worst, float(err.max()))
    print(f"gumbel: max err {worst:.3f} eps * max(1, |g|) "
          f"(tolerance {GUMBEL_ULPS})")
    assert worst <= GUMBEL_ULPS


def _scores(n, vocab=VOCAB, seed=0, scale=3.0):
    rng_np = np.random.default_rng(seed)
    return rng_np.normal(size=(n, vocab)).astype(np.float32) * scale


def test_mask_top_k_bitwise():
    scores = _scores(6, vocab=4096)
    scores[1, :40] = scores[1, 100]  # ties at the threshold, all kept
    ks = np.array([0, 1, 50, 4095, 4096, 5000], np.int32)
    got = kernel._mask_top_k(torch.from_numpy(scores), torch.from_numpy(ks))
    want = jax.vmap(jkernel._mask_top_k)(jnp.asarray(scores),
                                         jnp.asarray(ks))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))
    kept = (got.numpy() > kernel.NEG).sum(-1)
    assert kept[0] == kept[4] == kept[5] == 4096 and kept[2] == 50


def _prefix_mass(scores: torch.Tensor) -> torch.Tensor:
    """The port's mass before each token in descending order."""
    m = torch.amax(scores, dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    probs = e / e.sum(-1, keepdim=True)
    order = torch.sort(-scores, dim=-1, stable=True).indices
    sp = probs.gather(-1, order)
    pre = torch.cumsum(sp, -1) - sp
    return torch.zeros_like(pre).scatter(-1, order, pre)


def test_mask_top_p_keep_sets():
    scores = _scores(8, seed=1, scale=2.0)
    ps = np.array([1.0, 0.9, 0.5, 0.1, 0.99, 0.75, 0.3, 0.95], np.float32)
    got = kernel._mask_top_p(torch.from_numpy(scores), torch.from_numpy(ps))
    want = np.asarray(jax.vmap(jkernel._mask_top_p)(jnp.asarray(scores),
                                                    jnp.asarray(ps)))
    keep_got = got.numpy() > kernel.NEG
    keep_want = want > jkernel.NEG
    differ = keep_got != keep_want
    pre = _prefix_mass(torch.from_numpy(scores)).numpy()
    near = np.abs(pre - ps[:, None]) <= TOP_P_MASS_TOL
    print(f"top-p: {int(differ.sum())} keep decisions differ, "
          f"{int(near.sum())} tokens within {TOP_P_MASS_TOL:.3g} of p")
    assert not (differ & ~near).any()
    np.testing.assert_array_equal(np.where(keep_got, got.numpy(), 0),
                                  np.where(keep_got, scores, 0))
    assert keep_got[0].all() and keep_got.sum(-1).min() >= 1


GRID = [dict(temperature=t, top_k=k, top_p=p)
        for t in (0.0, 0.3, 1.0) for k in (0, 1, 50) for p in (1.0, 0.9, 0.5)]


def test_sample_from_logits_grid():
    """Tokens equal the reference's over the grid, for 4 (seed, position)
    pairs per setting, all in one batch; a token may differ only where
    the port's two perturbed scores are within GUMBEL_ULPS or the
    reference's token sits at the top-p boundary. Such near ties are
    counted."""
    pairs = [(0, 0), (1, 1), (3, 127), (2**32 - 1, 4095)]
    specs = [SamplerSpec(seed=s, **setting) for setting in GRID
             for s, _ in pairs]
    positions = [p for _ in GRID for _, p in pairs]
    logits = np.tile(_scores(len(pairs), seed=2, scale=2.5), (len(GRID), 1))
    rows = SamplerRows.from_specs(specs, positions)
    got = sample_from_logits(torch.from_numpy(logits), rows).numpy()
    want = np.asarray(jax.jit(jax.vmap(jkernel.sample_from_logits))(
        jnp.asarray(logits)[:, None, :], _ref_rows(specs, positions)))
    near_ties = 0
    for i in np.flatnonzero(got != want):
        spec = specs[i]
        assert spec.temperature > 0, (spec, i)
        near_ties += 1
        row = SamplerRows.from_specs([spec], [positions[i]])
        scaled = kernel._mask_top_k(
            torch.from_numpy(logits[i:i + 1]) / max(spec.temperature, 1e-6),
            row.top_k)
        z = (kernel._mask_top_p(scaled, row.top_p)
             + rng.gumbel(rng.token_key(row.seed, row.pos), VOCAB))[0]
        z = z.double()
        gap = float(z[got[i]] - z[want[i]])
        tie = gap <= GUMBEL_ULPS * EPS * max(1.0, abs(float(z[got[i]])))
        pre = float(_prefix_mass(scaled)[0, want[i]])
        boundary = abs(pre - spec.top_p) <= TOP_P_MASS_TOL
        assert tie or boundary, (spec, i, gap, pre)
    print(f"sample_from_logits: {len(got)} draws, {near_ties} near ties")
    assert len(got) == len(GRID) * len(pairs) == 108
    # the grid is not vacuous: sampled rows leave the argmax
    assert (got != logits.argmax(-1)).sum() > 10


# -- the reference's invariants (tests/test_sample.py), inside the port --

LOGITS = np.array([2.0, 1.0, 0.5, -1.0, -3.0, 0.0, 0.4, 1.9], np.float32)


def _greedy_first_max():
    ties = np.array([1.0, 3.0, 3.0, 0.0], np.float32)
    assert sample_token(ties, None) == 1
    assert sample_token(ties, SamplerSpec.greedy()) == 1
    assert sample_token(LOGITS, None) == int(np.argmax(LOGITS))


def _temperature_to_zero_is_argmax():
    spec = SamplerSpec(temperature=1e-3, seed=123)
    assert {sample_token(LOGITS, spec, position=p)
            for p in range(64)} == {int(np.argmax(LOGITS))}


def _temperature_spreads_mass():
    spec = SamplerSpec(temperature=2.0, seed=9)
    assert len({sample_token(LOGITS, spec, position=p)
                for p in range(64)}) > 3


def _top_k_restricts_support():
    spec = SamplerSpec(temperature=2.0, top_k=2, seed=1)
    assert {sample_token(LOGITS, spec, position=p)
            for p in range(200)} == {0, 7}
    wide = SamplerSpec(temperature=2.0, top_k=len(LOGITS), seed=1)
    assert {sample_token(LOGITS, wide, position=p)
            for p in range(200)} > {0, 7}


def _top_p_truncates_support():
    probs = np.array([0.5, 0.3, 0.15, 0.05], np.float32)
    logits = np.log(probs)
    for p, want in [(0.45, {0}), (0.75, {0, 1}), (0.9, {0, 1, 2})]:
        spec = SamplerSpec(temperature=1.0, top_p=p, seed=4)
        assert {sample_token(logits, spec, position=i)
                for i in range(400)} == want, p
    full = SamplerSpec(temperature=1.0, top_p=1.0, seed=4)
    assert 3 in {sample_token(logits, full, position=i) for i in range(400)}


def _pure_function_of_seed_and_position():
    k = rng.token_key(5, 17)
    assert torch.equal(k, rng.token_key(5, 17))
    assert not torch.equal(k, rng.token_key(5, 18))
    assert not torch.equal(k, rng.token_key(6, 17))
    spec = SamplerSpec(temperature=1.5, seed=42)
    a = [sample_token(LOGITS, spec, position=p) for p in range(32)]
    assert a == [sample_token(LOGITS, spec, position=p) for p in range(32)]
    assert len(set(a)) > 1


def _batch_equals_single_rows():
    specs = [SamplerSpec(temperature=1.0, seed=11),
             SamplerSpec(temperature=2.0, top_k=3, seed=12), None,
             SamplerSpec(temperature=0.9, top_p=0.8, seed=13)]
    rows = SamplerRows.from_specs(specs, [7] * len(specs))
    stacked = torch.from_numpy(np.stack([LOGITS] * len(specs)))[:, None]
    toks, advanced = select_tokens(stacked, rows)
    assert toks.shape == (4, 1, 1)
    assert toks.reshape(-1).tolist() == [sample_token(LOGITS, s, position=7)
                                         for s in specs]
    assert advanced.pos.tolist() == [8] * 4 and rows.pos.tolist() == [7] * 4


def _other_slots_ignored():
    spec = SamplerSpec(temperature=1.2, seed=77)
    rng_np = np.random.default_rng(0)
    seen = set()
    for _ in range(3):
        others = rng_np.normal(size=(3, len(LOGITS))).astype(np.float32)
        specs = [spec] + [SamplerSpec(temperature=2.0, seed=int(s))
                          for s in rng_np.integers(0, 1000, size=3)]
        rows = SamplerRows.from_specs(specs, [5, 1, 9, 2])
        stacked = torch.from_numpy(np.concatenate([LOGITS[None], others]))
        seen.add(int(sample_from_logits(stacked, rows)[0]))
    assert len(seen) == 1


def _advance_hold_freezes_rows():
    rows = SamplerRows.from_specs([SamplerSpec(temperature=1.0, seed=s)
                                   for s in range(4)], [3, 3, 3, 3])
    held = rows.advance(hold=torch.tensor([True, False, True, False]))
    assert held.pos.tolist() == [3, 4, 3, 4]
    assert rows.advance().pos.tolist() == [4] * 4
    for f in dataclasses.fields(rows):
        if f.name != "pos":
            assert torch.equal(getattr(held, f.name), getattr(rows, f.name))


INVARIANTS = {f.__name__.lstrip("_"): f for f in (
    _greedy_first_max, _temperature_to_zero_is_argmax,
    _temperature_spreads_mass, _top_k_restricts_support,
    _top_p_truncates_support, _pure_function_of_seed_and_position,
    _batch_equals_single_rows, _other_slots_ignored,
    _advance_hold_freezes_rows)}


@pytest.mark.parametrize("name", list(INVARIANTS))
def test_sampler_invariant(name):
    INVARIANTS[name]()


def test_sample_token_matches_reference_small_vocab():
    """The first-token path (one row, host-side in the reference) on the
    invariants' logits: the same tokens as the reference's
    ``sample_token`` for 64 positions of three specs."""
    from repro.sample import SamplerSpec as JSamplerSpec
    from repro.sample import sample_token as jsample_token
    for kw in (dict(temperature=1.0, seed=3), dict(temperature=0.7,
                                                   top_k=3, seed=8),
               dict(temperature=1.3, top_p=0.8, seed=2**32 - 1)):
        got = [sample_token(LOGITS, SamplerSpec(**kw), position=p)
               for p in range(64)]
        want = [jsample_token(LOGITS, JSamplerSpec(**kw), position=p)
                for p in range(64)]
        assert got == want, kw
