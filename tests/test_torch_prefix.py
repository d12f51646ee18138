"""The port's cross-request prefix cache against the JAX reference: radix
matching, refcounted leases, LRU eviction of unreferenced entries only,
copy-on-write page accounting, and the cold-vs-warm stream oracle over
the port's ``SectoredKVBackend`` (the oracles of tests/test_prefix.py).

The reference's ``PrefixCache.insert`` walks the tree before it evicts,
so an eviction can prune the node the walk returned and the new entry
lands outside the tree (its ``test_never_evicts_referenced_entries``
fails on such draws). The port makes room first; it must pass the same
property, and equal the reference wherever the reference's tree stays
consistent.

Sessions serve the reduced yi-6b (``_torch_port.small_models``,
parameters bridged bit for bit) on the exact path (``AlwaysDense``):
warm and cold streams must be equal token for token and logprob for
logprob within the port, and equal the reference's tokens, integer
stats and cache stats, with logprobs within ``LOGPROB_TOL``.
"""

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

from _torch_port import small_models
from _torch_port import one_torch_thread  # noqa: F401  (autouse)
from repro import serve as jserve
from repro.runtime import sectored_decode as jsd
from repro.sample import SamplerSpec as JSamplerSpec
from repro.serve.prefix import PrefixCache as JPrefixCache
from repro_torch import serve
from repro_torch.runtime import sectored_decode
from repro_torch.sample import SamplerSpec
from repro_torch.serve import (KVPagePool, PrefixCache, ServeSession,
                               ServingBackend)
from repro_torch.telemetry import MeteredBackend

TOK = st.integers(0, 3)
SEQ_LEN = 48
# raw f32 logprobs of the reduced model, port vs reference (bf16 logits
# 0.0051 apart at most, tests/test_torch_sectored_decode.py)
LOGPROB_TOL = 0.02


# -- radix tree ----------------------------------------------------------------


def _lcp(a, b) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


@settings(max_examples=25, deadline=None)
@given(st.lists(st.lists(TOK, min_size=1, max_size=8), min_size=1,
                max_size=8),
       st.lists(TOK, min_size=1, max_size=8))
def test_match_equals_reference_longest_common_prefix(prompts, probe):
    cache = PrefixCache(capacity_pages=1_000_000, page_size=4)
    for i, p in enumerate(prompts):
        cache.insert(tuple(p), state=("s", i))
    donor, m = cache.match(tuple(probe))
    ref = max(_lcp(probe, p) for p in prompts)
    assert m == (ref if ref >= 1 else 0)
    if m:
        assert donor is not None
        assert _lcp(probe, donor.tokens) >= m


@settings(max_examples=25, deadline=None)
@given(st.lists(st.lists(TOK, min_size=1, max_size=10), min_size=1,
                max_size=6),
       st.lists(TOK, min_size=1, max_size=10))
def test_match_length_monotone_in_query_prefix(prompts, probe):
    cache = PrefixCache(capacity_pages=1_000_000, page_size=4)
    for i, p in enumerate(prompts):
        cache.insert(tuple(p), state=i)
    matches = [cache.match(tuple(probe[:k]))[1]
               for k in range(1, len(probe) + 1)]
    assert matches == sorted(matches)
    assert all(m <= k for k, m in enumerate(matches, start=1))


@settings(max_examples=25, deadline=None)
@given(st.lists(st.tuples(st.lists(TOK, min_size=1, max_size=10),
                          st.booleans()),
                min_size=1, max_size=10))
def test_never_evicts_referenced_entries(entries):
    """Refcount > 0 pins an entry through arbitrary admission pressure:
    every leased prompt stays fully matchable until released (the
    reference's property, which the reference itself fails)."""
    _never_evicts_referenced_entries(entries)


#: the 2-entry sequence that falsified the reference's property: its
#: ``insert`` walks the tree before it evicts, and the eviction prunes the
#: node the walk returned, so ``shed`` raises ``KeyError``
TWO_ENTRY_FAULT = [([0], False), ([0, 0, 0, 0, 0], False)]


def test_never_evicts_referenced_entries_two_entry_example():
    """The property's body on the sequence that breaks the reference: the
    port accepts both inserts, matches all 5 tokens, and sheds to 0 pages."""
    cache = PrefixCache(capacity_pages=2, page_size=4)
    for i, (toks, _) in enumerate(TWO_ENTRY_FAULT):
        assert cache.insert(tuple(toks), state=i)
    donor, m = cache.match((0, 0, 0, 0, 0))
    assert m == 5 and donor.state == 1
    cache.shed(1_000_000)
    assert cache.held_pages == 0
    _never_evicts_referenced_entries(TWO_ENTRY_FAULT)


def _never_evicts_referenced_entries(entries):
    cache = PrefixCache(capacity_pages=2, page_size=4)
    leases = []
    for i, (toks, hold) in enumerate(entries):
        cache.insert(tuple(toks), state=i)
        if hold:
            lease = cache.acquire(tuple(toks))
            if lease is not None:
                leases.append(lease)
    cache.shed(1_000_000)
    for lease in leases:
        assert lease.entry.refcount > 0
        donor, m = cache.match(tuple(lease.entry.tokens))
        assert m == len(lease.entry.tokens)
    for lease in leases:
        cache.release(lease)
    cache.shed(1_000_000)
    assert cache.held_pages == 0


def test_insert_evicting_its_own_path_keeps_the_tree_whole():
    """The case the reference gets wrong: on a 2-page cache, (0,) and
    (1,) fill it, and inserting (0, 0) evicts (0,) — the node the insert
    would hang under. The reference leaves (0, 0) outside the tree and
    its shed raises KeyError; the port finds it and sheds it."""
    ref = JPrefixCache(2, page_size=4)
    port = PrefixCache(2, page_size=4)
    for i, toks in enumerate([(0,), (1,), (0, 0)]):
        assert ref.insert(toks, state=i) and port.insert(toks, state=i)
    assert ref.match((0, 0)) == (None, 0)  # the reference's fault
    with pytest.raises(KeyError):
        ref.shed(1_000_000)
    donor, m = port.match((0, 0))
    assert m == 2 and donor.tokens == (0, 0) and donor.state == 2
    assert port.match((1,))[1] == 1 and len(port) == 2
    assert port.shed(1_000_000) == 2 and port.held_pages == 0
    assert port.stats["evictions"] == 3


def _tree_whole(cache) -> bool:
    """Every entry is reachable (fully matchable) and every leaf below the
    root holds an entry — what pruning keeps true in a sound tree."""
    if any(cache.match(e.tokens)[1] != len(e) for e in cache.entries()):
        return False
    stack = list(cache._root.children.values())
    while stack:
        node = stack.pop()
        if not node.children and node.entry is None:
            return False
        stack.extend(node.children.values())
    return True


@settings(max_examples=25, deadline=None)
@given(st.lists(st.tuples(st.lists(TOK, min_size=1, max_size=10),
                          st.integers(0, 3)),
                min_size=1, max_size=12))
def test_matches_reference_while_its_tree_is_whole(ops):
    """Insert / acquire / release / shed on both caches: every return
    value, match and stat equal, for as long as the reference's own tree
    stays whole; the port's always does."""
    ref, port = JPrefixCache(3, page_size=4), PrefixCache(3, page_size=4)
    held = {"ref": [], "port": []}
    for i, (toks, op) in enumerate(ops):
        toks = tuple(toks)
        assert port.insert(toks, state=i) == ref.insert(toks, state=i)
        assert _tree_whole(port)
        if not _tree_whole(ref):
            return  # the reference's fault: nothing left to compare with
        if op == 1:
            a, b = ref.acquire(toks), port.acquire(toks)
            assert (a is None) == (b is None)
            if a is not None:
                assert (a.matched_tokens, a.shared_tokens) == (
                    b.matched_tokens, b.shared_tokens)
                held["ref"].append(a)
                held["port"].append(b)
        elif op == 2 and held["ref"]:
            ref.release(held["ref"].pop(0))
            port.release(held["port"].pop(0))
        elif op == 3:
            assert port.shed(4) == ref.shed(4)
        assert port.match(toks)[1] == ref.match(toks)[1]
        assert port.stats == ref.stats
        assert sorted(e.tokens for e in port.entries()) == sorted(
            e.tokens for e in ref.entries())


def test_release_is_idempotent_and_cow_counted():
    cache = PrefixCache(capacity_pages=64, page_size=4)
    cache.insert(tuple(range(10)), state="e")
    lease = cache.acquire(tuple(range(10)))
    assert lease.matched_tokens == 10 and lease.shared_tokens == 8
    assert lease.shared_pages == 2 and cache.stats["cow_copies"] == 1
    for _ in range(3):
        cache.release(lease)
    assert lease.entry.refcount == 0 and cache.stats["releases"] == 1
    aligned = cache.acquire(tuple(range(8)))
    assert aligned.matched_tokens == 8 and aligned.shared_tokens == 8
    assert cache.stats["cow_copies"] == 1


def test_lru_evicts_unreferenced_only_and_dedupe_refreshes():
    cache = PrefixCache(capacity_pages=3, page_size=4)
    a, b, c = (1, 1, 1, 1), (2, 2, 2, 2), (3, 3, 3, 3)
    for i, toks in enumerate((a, b, c)):
        cache.insert(toks, state=i)
    assert cache.insert(a, state="dup") is False  # dedupe refreshes a
    pinned = cache.acquire(c)
    cache.insert((4, 4, 4, 4), state=3)  # over capacity: LRU b goes
    assert cache.match(b)[1] == 0
    assert cache.match(a)[1] == 4 and cache.match(c)[1] == 4
    assert cache.stats["evictions"] == 1
    cache.shed(1_000_000)
    assert [e.tokens for e in cache.entries()] == [c]  # pinned survives
    cache.release(pinned)


# -- the backend hooks ---------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    return small_models()


@pytest.fixture(scope="module")
def backend(models):
    _, cfg, _, params = models
    return sectored_decode.make_serving_fns(cfg, params=params,
                                            seq_len=SEQ_LEN, device="cpu")


def test_suffix_prefill_from_a_cut_donor_is_bitwise_cold(models, backend):
    """state_prefix + suffix_prefill == the cold prefill, in logits and
    in every K/V row below the length (rows past it are masked), and the
    donor is left as it was: the seed is a copy."""
    _, cfg, _, _ = models
    rng = np.random.default_rng(3)
    donor_prompt = rng.integers(0, cfg.vocab, 20).astype(np.int32)
    prompt = np.concatenate([donor_prompt[:13],
                             rng.integers(0, cfg.vocab, 6).astype(np.int32)])
    _, donor = backend.prefill_fn(donor_prompt[None])
    before = donor.clone()
    seed = backend.state_prefix(donor, 13)
    warm_logits, warm = backend.suffix_prefill(seed, prompt[None, 13:])
    cold_logits, cold = backend.prefill_fn(prompt[None])
    assert np.array_equal(warm_logits.float().numpy(),
                          cold_logits.float().numpy())
    n = len(prompt)
    assert warm.kv.length.eq(n).all() and warm.position.eq(n).all()
    for a, b in ((warm.kv.k, cold.kv.k), (warm.kv.v, cold.kv.v)):
        assert np.array_equal(a[:, :, :n].float().numpy(),
                              b[:, :, :n].float().numpy())
    for a, b in zip((donor.kv.k, donor.kv.v, donor.kv.length, donor.table),
                    (before.kv.k, before.kv.v, before.kv.length,
                     before.table)):
        assert np.array_equal(a.float().numpy(), b.float().numpy())


def test_unique_fetches_collapse_merged_groups():
    pages = np.asarray([[[0, 1]], [[0, 1]], [[2, 3]]])
    assert sectored_decode.unique_fetches(pages, [0, 1, 2]) == 6
    assert sectored_decode.unique_fetches(pages, [0, 0, 2]) == 4
    assert sectored_decode.unique_fetches(pages, [0, 0, 2]) == \
        jsd.unique_fetches(pages, [0, 0, 2])


# -- the cold-vs-warm oracle ---------------------------------------------------


def _requests(stack, vocab, n=5, shared=12, tail=4, max_new=6):
    """Mixed greedy + sampled requests sharing a prefix (the reference
    test's trace)."""
    spec_cls = JSamplerSpec if stack is jserve else SamplerSpec
    rng = np.random.default_rng(7)
    common = rng.integers(0, vocab, size=shared).astype(np.int32)
    tails = np.random.default_rng(42)
    reqs = []
    for rid in range(n):
        t = tails.integers(0, vocab, size=tail).astype(np.int32)
        spec = (spec_cls(temperature=0.8, seed=100 + rid)
                if rid % 2 else None)
        reqs.append(stack.Request(rid, np.concatenate([common, t]),
                                  max_new_tokens=max_new, sampler=spec))
    return reqs


def _run_streams(stack, backend, vocab, scheduler, cache, pool, **flavor):
    """Staggered arrivals (one submit per step) so later requests can hit
    entries inserted by earlier ones; returns streams + the session."""
    sess = stack.ServeSession(backend, max_batch=3,
                              scheduler=getattr(stack, scheduler)(),
                              policy=stack.AlwaysDense(), prefix_cache=cache,
                              page_pool=pool, **flavor)
    handles = []
    for r in _requests(stack, vocab):
        handles.append(sess.submit(r))
        sess.step()
    sess.run_until_drained()
    return {h.rid: (tuple(h.peek()), tuple(h.logprobs()))
            for h in handles}, sess


def _port_run(backend, models, scheduler, cache_pages=None, pool_pages=None,
              page_size=4, **flavor):
    vocab = models[1].vocab
    cache = (PrefixCache(cache_pages, page_size=page_size)
             if cache_pages else None)
    pool = (KVPagePool(pool_pages, page_size=page_size)
            if pool_pages else None)
    return _run_streams(serve, backend, vocab, scheduler, cache, pool,
                        **flavor)


@pytest.mark.parametrize("flavor", [dict(), dict(vectorized=False),
                                    dict(fuse_wave=False)],
                         ids=["fused", "looped", "prefused"])
@pytest.mark.parametrize("scheduler", ["FifoScheduler", "OverlapScheduler"],
                         ids=["fifo", "overlap"])
def test_warm_streams_and_logprobs_identical_uncontended(
        backend, models, scheduler, flavor):
    """Warm admissions (suffix prefill from a shared entry) emit the cold
    run's tokens AND logprobs bit for bit, greedy and sampled, on every
    wave flavor (and every flavor equals the fused wave)."""
    cold, _ = _port_run(backend, models, scheduler)
    warm, sess = _port_run(backend, models, scheduler, cache_pages=8,
                           page_size=16, **flavor)
    assert warm == cold
    assert sess.prefix_cache.stats["hits"] == 4
    assert sess.prefix_cache.stats["hit_tokens"] > 0


def test_warm_streams_identical_under_fifo_preemption(backend, models):
    cold, csess = _port_run(backend, models, "FifoScheduler", pool_pages=11)
    warm, wsess = _port_run(backend, models, "FifoScheduler", cache_pages=16,
                            pool_pages=11)
    assert warm == cold
    assert csess.stats["preemptions"] > 0 and wsess.stats["preemptions"] > 0


def test_warm_sharing_relieves_overlap_preemption_pressure(backend, models):
    """The cold run preempts; the warm run's shared pages shrink its
    footprint, so it preempts strictly less, with the same streams, which
    are those of an uncontended run."""
    free, _ = _port_run(backend, models, "OverlapScheduler")
    cold, csess = _port_run(backend, models, "OverlapScheduler",
                            pool_pages=10)
    warm, wsess = _port_run(backend, models, "OverlapScheduler",
                            cache_pages=16, pool_pages=10)
    assert warm == cold == free
    assert csess.stats["preemptions"] > 0
    assert wsess.stats["preemptions"] < csess.stats["preemptions"]
    assert wsess.prefix_cache.stats["hits"] > 0


def test_warm_run_meters_fewer_prefill_joules(backend, models):
    cold_metered = MeteredBackend(backend)
    _run_streams(serve, cold_metered, models[1].vocab, "FifoScheduler",
                 None, None)
    cold = cold_metered.meter.report()
    warm_metered = MeteredBackend(backend)
    _run_streams(serve, warm_metered, models[1].vocab, "FifoScheduler",
                 PrefixCache(8, page_size=16), None)
    warm = warm_metered.meter.report()
    assert warm["prefix_hit_tokens"] > 0
    assert warm["prefill_tokens"] == cold["prefill_tokens"]
    assert warm["prefill_j"] < cold["prefill_j"]
    assert warm["energy_j"] < cold["energy_j"]


@pytest.mark.parametrize("case", [
    dict(scheduler="OverlapScheduler", cache_pages=16, pool_pages=10),
    dict(scheduler="FifoScheduler", cache_pages=16, pool_pages=11),
    dict(scheduler="OverlapScheduler", cache_pages=8, page_size=16),
], ids=["overlap_pool_cache", "fifo_pool_cache", "overlap_cache"])
def test_sessions_match_reference(models, backend, case):
    """Overlap + pool + prefix cache, both stacks, metered: tokens equal,
    every session stat, cache stat and the pool peak equal, the meter's
    integer counters equal, logprobs within LOGPROB_TOL."""
    jcfg, cfg, jparams, _ = models
    jbackend = jsd.make_serving_fns(jcfg, params=jparams, seq_len=SEQ_LEN)
    page_size = case.get("page_size", 4)
    results = {}
    for name, stack, be in (("port", serve, MeteredBackend(backend)),
                            ("ref", jserve, _jax_metered(jbackend))):
        cache = stack.PrefixCache(case["cache_pages"], page_size=page_size)
        pool = (stack.KVPagePool(case["pool_pages"], page_size=page_size)
                if case.get("pool_pages") else None)
        streams, sess = _run_streams(stack, be, cfg.vocab, case["scheduler"],
                                     cache, pool)
        report = sess.meter.report()
        results[name] = dict(
            streams=streams, stats=dict(sess.stats),
            cache=dict(cache.stats), peak=pool.peak_pages if pool else None,
            order=list(sess.completion_order),
            meter={k: report[k] for k in ("tokens", "prefill_tokens",
                                          "prefix_hit_tokens", "waves",
                                          "evictions")})
    port, ref = results["port"], results["ref"]
    for key in ("stats", "cache", "peak", "order", "meter"):
        assert port[key] == ref[key], key
    worst = 0.0
    for rid, (toks, lps) in ref["streams"].items():
        ptoks, plps = port["streams"][rid]
        assert ptoks == toks, rid
        worst = max(worst, max(abs(a - b) for a, b in zip(lps, plps)))
    assert worst <= LOGPROB_TOL, worst
    if case.get("pool_pages"):
        assert port["stats"]["preemptions"] > 0


def _jax_metered(jbackend):
    from repro.telemetry import MeteredBackend as JMeteredBackend
    return JMeteredBackend(jbackend)


# -- configuration refusals ----------------------------------------------------


def test_prefix_cache_requires_seeding_hooks_and_matching_pages(backend):
    dense = ServingBackend(lambda t: None, lambda s, t: None, device="cpu")
    with pytest.raises(ValueError, match="state_prefix"):
        ServeSession(dense, max_batch=2, prefix_cache=PrefixCache(8))
    with pytest.raises(ValueError, match="page_size"):
        ServeSession(backend, max_batch=2,
                     prefix_cache=PrefixCache(8, page_size=16),
                     page_pool=KVPagePool(8, page_size=4))
