"""Stage 1 of the port's DRAM simulator against the reference, exactly: the
sector helpers, LSQ Lookahead and the Sector Predictor. Integers and
integer arrays must be equal, floats equal bit for bit; no tolerance
anywhere. Also the contracts of the reference's ``test_core_sectors.py``
and ``test_core_predictor.py``, held by the port. (Stage 2 is in
``test_torch_sim_dram.py``.)"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _hypothesis_compat import given, settings, st
from _sim_oracle import assert_same

from repro.core import lsq as jlsq
from repro.core import predictor as jpred
from repro.core import sectors as jsectors
from repro_torch.core import lsq, predictor, sectors
from repro_torch.data import traces

MASKS = np.arange(256, dtype=np.uint32)
INF_DIST = 2**30


# --------------------------------------------------------------- sectors
def _pre_pair(mod, xp):
    rows = xp.arange(0, 1 << 18, 37, dtype=np.uint32)
    masks = (rows * 41) % 256
    word = mod.encode_pre(rows, masks)
    return (word, *mod.decode_pre(word))


def _offsets_pair(mod, xp):
    rng = np.random.default_rng(5)
    offs = rng.integers(0, 8, size=(64, 5)).astype(np.int32)
    valid = rng.random((64, 5)) < 0.5
    return [mod.mask_from_offsets(xp.asarray(o), xp.asarray(v))
            for o, v in zip(offs, valid)]


SECTOR_CASES = {
    "popcount8": lambda mod, xp: mod.popcount8(xp.asarray(MASKS)),
    "burst_length": lambda mod, xp: mod.burst_length(xp.asarray(MASKS)),
    "mask_from_offset": lambda mod, xp: mod.mask_from_offset(
        xp.arange(8, dtype=np.int32)),
    "expand_compress": lambda mod, xp: (
        mod.expand_mask(xp.asarray(MASKS)),
        mod.compress_mask(mod.expand_mask(xp.asarray(MASKS)))),
    "pre_encoding": _pre_pair,
    "mask_from_offsets": _offsets_pair,
}


@pytest.mark.parametrize("case", SECTOR_CASES)
def test_sector_helpers_equal_over_all_masks(case):
    """Every helper, over all 256 masks, equals the reference's in value
    and dtype. This holds the reference's exact-popcount and round-trip
    contracts (``test_popcount_exact``, ``test_mask_roundtrip_pre_encoding``,
    ``test_expand_compress_roundtrip``) for the port too, and the port's
    round trips are checked below as well."""
    fn = SECTOR_CASES[case]
    ref = fn(jsectors, jnp)
    got = fn(sectors, np)
    ref = ref if isinstance(ref, (list, tuple)) else (ref,)
    got = got if isinstance(got, (list, tuple)) else (got,)
    for i, (r, g) in enumerate(zip(ref, got, strict=True)):
        assert_same(np.asarray(r), np.asarray(g), f"{case}[{i}]")


def test_sector_constants_equal():
    for name in ("NUM_SECTORS", "WORD_BYTES", "BLOCK_BYTES", "PRE_SPARE_BITS",
                 "FULL_MASK"):
        assert getattr(sectors, name) == getattr(jsectors, name), name


def test_port_roundtrips():
    word = sectors.encode_pre(np.arange(0, 1024, 37, dtype=np.uint32),
                              MASKS[:28] * 9 % 256)
    rows, masks = sectors.decode_pre(word)
    np.testing.assert_array_equal(rows, np.arange(0, 1024, 37))
    np.testing.assert_array_equal(masks, MASKS[:28] * 9 % 256)
    np.testing.assert_array_equal(
        sectors.compress_mask(sectors.expand_mask(MASKS)), MASKS)


@settings(max_examples=50, deadline=None)
@given(st.integers(0, 255), st.integers(0, 255))
def test_popcount_or_subadditive(a, b):
    pa, pb = int(sectors.popcount8(a)), int(sectors.popcount8(b))
    assert max(pa, pb) <= int(sectors.popcount8(a | b)) <= pa + pb


@settings(max_examples=30, deadline=None)
@given(st.lists(st.integers(0, 7), min_size=1, max_size=8))
def test_burst_length_counts_distinct_offsets(offs):
    mask = 0
    for o in offs:
        mask |= 1 << o
    assert int(sectors.burst_length(mask)) == len(set(offs))


# --------------------------------------------------------------- LSQ
BATCH = 32  # hypothesis batches are padded to this, so each reference
#             variant compiles once


@jax.jit
def _ref_la_and_halves(dist, masks, window):
    return jlsq.la_mask(dist, window), jlsq.round_to_halves(masks)


_ref_cluster = jax.jit(jlsq.cluster_requests, static_argnames=("window",
                                                               "chop"))


def _episode_batch(eps):
    eps = (eps * BATCH)[:BATCH]
    used = np.array([e[0] for e in eps], np.uint32)
    m0 = np.array([e[1] for e in eps], np.uint32)
    raw = np.array([e[2] for e in eps], np.int32)
    bits = ((used[:, None] >> np.arange(8)) & 1).astype(bool)
    dist = np.where(bits, raw, INF_DIST).astype(np.int32)
    return used, m0, dist


EPISODE = st.tuples(st.integers(1, 255), st.integers(0, 255),
                    st.lists(st.integers(0, 3000), min_size=8, max_size=8))


@settings(max_examples=25, deadline=None)
@given(st.lists(EPISODE, min_size=1, max_size=BATCH),
       st.sampled_from([0, 16, 128, 2048]), st.booleans())
def test_lsq_equal_on_drawn_episodes(eps, window, chop):
    used, m0, dist = _episode_batch(eps)
    la, halves = _ref_la_and_halves(jnp.asarray(dist), jnp.asarray(m0),
                                    jnp.int32(window))
    assert_same(np.asarray(la), lsq.la_mask(dist, window), "la_mask")
    assert_same(np.asarray(halves), lsq.round_to_halves(m0), "halves")
    ref = _ref_cluster(jnp.asarray(used), jnp.asarray(dist), jnp.asarray(m0),
                       window=window, chop=chop)
    got = lsq.cluster_requests(used, dist, m0, window, chop=chop)
    for name, r, g in zip(("n_extra", "masks", "dists"), ref, got):
        assert_same(np.asarray(r), g, name)
    assert_same(np.asarray(jlsq.extra_words_basic(jnp.asarray(used))),
                lsq.extra_words_basic(used), "extra_words_basic")


def _dist_row(pairs):
    row = np.full(8, INF_DIST, np.int32)
    for off, d in pairs:
        row[off] = d
    return row


def test_cluster_requests_groups_by_window():
    n, masks, _ = lsq.cluster_requests(
        np.uint32(0b00001110), _dist_row([(1, 100), (2, 105), (3, 900)]),
        np.uint32(0b1), 64)
    assert int(n) == 2  # {1,2} cluster + {3}
    assert {int(m) for m in masks if int(m)} == {0b0110, 0b1000}


# --------------------------------------------------------------- predictor
def crafted_trace(used_mask, dists, pcs=None):
    """An EpisodeTrace with explicit word usage/distances (the reference's
    ``test_core_predictor.crafted_trace``)."""
    used = np.asarray(used_mask, np.uint16)
    E = len(used)
    first = np.argmax((used[:, None] >> np.arange(8)) & 1, axis=1).astype(np.int32)
    return traces.EpisodeTrace(
        profile=traces.WORKLOADS["mcf-2006"], n_instructions=E * 100,
        pc=np.asarray(pcs if pcs is not None else np.zeros(E), np.int32),
        first_word=first, used_mask=used,
        dirty_mask=np.zeros(E, np.uint16), dist=np.asarray(dists, np.int32),
        instr_pos=np.arange(1, E + 1, dtype=np.int64) * 100,
        bank=np.zeros(E, np.int32), row=np.arange(E, dtype=np.int32),
        block=np.arange(E, dtype=np.int64), dep=np.zeros(E, bool))


POLICIES = [jpred.BASELINE, jpred.BASIC, jpred.LA16, jpred.LA128,
            jpred.LA2048, jpred.SP512, jpred.LA128_SP512,
            jpred.CHOP_LA128_SP512, jpred.PRA_POLICY]


@pytest.fixture(scope="module")
def stage1_trace():
    """2,000 episodes of a generated trace (96 miss PCs, so SHT indices
    repeat) with dirty words; the port's generator, fed to both stages."""
    return traces.generate_trace(traces.WORKLOADS["gobmk-2006"], 2000, seed=4)


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: p.name)
def test_prediction_equal_for_every_policy(policy, stage1_trace):
    """All nine policies: m0, n_extra, masks, dists, writeback, overfetch and
    fetched words equal the reference's scan over episodes, bit for bit
    (the reference reads only the trace's arrays, so it takes the port's
    trace)."""
    port_policy = getattr(predictor, {
        "LA128-SP512": "LA128_SP512", "chop": "CHOP_LA128_SP512",
        "pra": "PRA_POLICY"}.get(policy.name, policy.name.upper()))
    assert dataclasses.asdict(port_policy) == dataclasses.asdict(policy)
    assert_same(jpred.simulate_prediction(stage1_trace, policy),
                predictor.simulate_prediction(stage1_trace, port_policy))


def test_sht_index_and_table_equal():
    """``sht_index`` wraps in uint32 as the reference's; the vectorized SHT
    equals a table read at ``idx`` before it is written there, on a stream
    with many repeated indices (8 entries, 500 episodes)."""
    rng = np.random.default_rng(11)
    pc = rng.integers(0, 2**31 - 1, 500).astype(np.int32)
    word = rng.integers(0, 8, 500).astype(np.int32)
    for n in (1, 8, 512):
        assert_same(np.asarray(jpred.sht_index(jnp.asarray(pc),
                                               jnp.asarray(word), n)),
                    predictor.sht_index(pc, word, n), f"sht_index {n}")
    idx = predictor.sht_index(pc, word, 8)
    used = rng.integers(1, 256, 500).astype(np.uint32)
    table, want = np.zeros(8, np.uint32), np.zeros(500, np.uint32)
    for i in range(500):
        want[i] = table[idx[i]]
        table[idx[i]] = used[i]
    assert_same(want, predictor.sht_predictions(idx, used))


def test_la_covers_words_within_window():
    """Words within the LSQ window of the initial miss are merged."""
    tr = crafted_trace([0b00000111] * 4,
                       np.stack([_dist_row([(0, 0), (1, 5), (2, 10)])] * 4))
    assert int(predictor.simulate_prediction(tr, predictor.LA16)
               .n_extra.sum()) == 0


def test_la_window_boundary():
    """A word at distance > window causes exactly one sector miss."""
    tr = crafted_trace([0b00000011] * 4,
                       np.stack([_dist_row([(0, 0), (1, 100)])] * 4))
    assert int(predictor.simulate_prediction(tr, predictor.LA16)
               .n_extra.sum()) == 4
    assert int(predictor.simulate_prediction(tr, predictor.LA128)
               .n_extra.sum()) == 0


def test_sp_learns_stable_patterns():
    E = 50
    tr = crafted_trace([0b11000001] * E, np.stack(
        [_dist_row([(0, 0), (6, 5000), (7, 6000)])] * E), pcs=np.zeros(E))
    basic = predictor.simulate_prediction(tr, predictor.BASIC)
    sp = predictor.simulate_prediction(tr, predictor.SP512)
    assert int(basic.n_extra.sum()) == 2 * E
    assert int(sp.n_extra[1:].sum()) == 0  # learned after episode 0


def test_sp_overfetch_on_changed_pattern():
    E = 20
    tr = crafted_trace(
        [0b00000001 if i % 2 else 0b11000001 for i in range(E)],
        np.stack([_dist_row([(0, 0), (6, 5000), (7, 6000)]) if i % 2 == 0
                  else _dist_row([(0, 0)]) for i in range(E)]),
        pcs=np.zeros(E))
    sp = predictor.simulate_prediction(tr, predictor.SP512)
    assert int(sp.overfetch_words.sum()) > 0


def test_fig10_orderings_hold():
    tr = traces.generate_trace(traces.WORKLOADS["omnetpp-2006"], 4000, seed=7)
    res = {p.name: predictor.simulate_prediction(tr, p).n_extra.mean()
           for p in [predictor.BASIC, predictor.LA16, predictor.LA128,
                     predictor.LA128_SP512]}
    assert res["basic"] > res["LA16"] > res["LA128"] > res["LA128-SP512"]
