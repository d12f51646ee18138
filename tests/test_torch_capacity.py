"""The port's serving contracts under load, against the JAX reference:
EOS stop tokens, KV-page pool admission, preemption and resume, and the
overlap scheduler's head-of-line admission (the oracles of
tests/test_serve_capacity.py, on the port).

The toy backend (``_torch_port.sum_backend``) is resume-consistent by
construction: its state carries the running token sum and its prefill
recomputes it, so a re-prefill over ``prompt + generated`` lands where
the uncontended run was and preemption must be invisible in the streams.
The parity cases run the same trace through the reference session over
the same toy backend in JAX and require equal streams, stats and
completion order: the two sessions must schedule alike.
"""

import numpy as np
import pytest

from _torch_port import (expected_sum_stream, jax_sum_backend,
                         sum_backend)
from _torch_port import one_torch_thread  # noqa: F401  (autouse)
from repro import serve as jserve
from repro.sample import SamplerSpec as JSamplerSpec
from repro_torch import serve
from repro_torch.runtime import sectored_decode
from repro_torch.sample import SamplerSpec
from repro_torch.serve import (FifoScheduler, KVPagePool, OverlapScheduler,
                               Request, ServeSession)
from repro_torch.serve.pool import DEFAULT_PAGE_SIZE


def _prompts(n, first=1):
    return [np.asarray([rid + first, 2, 3, 5], np.int32) for rid in range(n)]


# -- EOS / stop-token contract ----------------------------------------------


@pytest.mark.parametrize("flavor", [dict(), dict(fuse_wave=False),
                                    dict(vectorized=False)],
                         ids=["fused", "prefused", "looped"])
def test_stop_token_terminates_early(flavor):
    """The stop token is the last token, the slot is freed, on every wave
    flavor."""
    prompt = np.asarray([1, 2], np.int32)  # stream: 3, 6, 12, 24, ...
    sess = ServeSession(sum_backend(), max_batch=2, **flavor)
    h = sess.submit(Request(0, prompt, max_new_tokens=10,
                            stop_tokens=(12,)))
    sess.run_until_drained()
    assert h.peek() == [3, 6, 12]
    assert h.done and h.stopped
    assert sess.stats["eos_stops"] == 1
    assert sess.active_slots() == []


def test_stop_token_at_prefill_and_shared_wave():
    sess = ServeSession(sum_backend(), max_batch=2)
    h = sess.submit(Request(0, np.asarray([1, 2], np.int32),
                            max_new_tokens=10, stop_tokens=(3,)))
    sess.step()
    assert h.peek() == [3] and h.done and h.stopped
    assert sess.stats["decode_steps"] == 0
    # one slot stops early, the other runs to quota in the same waves
    p0, p1 = np.asarray([1, 2], np.int32), np.asarray([2, 3], np.int32)
    h0 = sess.submit(Request(1, p0, max_new_tokens=8, stop_tokens=(12,)))
    h1 = sess.submit(Request(2, p1, max_new_tokens=8, stop_tokens=(12,)))
    sess.run_until_drained()
    assert h0.peek() == [3, 6, 12] and h0.stopped
    assert h1.peek() == expected_sum_stream(p1, 8, stop=(12,))


# -- KV page pool -------------------------------------------------------------


def test_pool_page_arithmetic_and_default_quantum():
    pool = KVPagePool(4, page_size=8)
    assert pool.pages_for(1) == 1 and pool.pages_for(8) == 1
    assert pool.pages_for(9) == 2 and pool.pages_for(0) == 1
    # the leaf module's default mirrors the sectored runtime's page
    assert DEFAULT_PAGE_SIZE == sectored_decode.PAGE_SIZE == 128
    with pytest.raises(ValueError):
        KVPagePool(0)
    with pytest.raises(ValueError):
        KVPagePool(4, page_size=0)


def test_submit_rejects_request_larger_than_whole_pool():
    sess = ServeSession(sum_backend(), max_batch=2,
                        page_pool=KVPagePool(2, page_size=4))
    with pytest.raises(ValueError, match="could never run to completion"):
        sess.submit(Request(0, np.arange(6, dtype=np.int32),
                            max_new_tokens=4))  # worst case 10 tokens
    sess.submit(Request(1, np.arange(4, dtype=np.int32), max_new_tokens=4))


def test_pool_gates_admission_without_preempting():
    """A pool holding one request at a time serializes admission: the
    queue head waits instead of being refused, and nothing preempts."""
    pool = KVPagePool(2, page_size=4)
    sess = ServeSession(sum_backend(), max_batch=4, page_pool=pool)
    handles = [sess.submit(Request(rid, np.arange(4, dtype=np.int32),
                                   max_new_tokens=4)) for rid in range(3)]
    sess.step()
    assert len(sess.active_slots()) == 1  # capacity, not slots, limits
    sess.run_until_drained()
    assert all(h.done for h in handles)
    assert sess.stats["preemptions"] == 0
    assert sess.completion_order == [0, 1, 2]
    assert pool.peak_pages <= pool.capacity_pages


@pytest.mark.parametrize("flavor", [dict(), dict(fuse_wave=False),
                                    dict(vectorized=False)],
                         ids=["fused", "prefused", "looped"])
@pytest.mark.parametrize("scheduler", [FifoScheduler, OverlapScheduler],
                         ids=["fifo", "overlap"])
def test_growth_preempts_youngest_and_streams_match_uncontended(
        scheduler, flavor):
    """Two requests admit together (2 pages each) and overcommit as they
    grow past the 8 -> 9 token page boundary: the younger is preempted,
    resumes, and every stream equals its uncontended run."""
    sess = ServeSession(sum_backend(), max_batch=4, scheduler=scheduler(),
                        page_pool=KVPagePool(4, page_size=4), **flavor)
    handles = [sess.submit(Request(rid, p, max_new_tokens=8))
               for rid, p in enumerate(_prompts(2))]
    sess.run_until_drained()
    assert sess.stats["preemptions"] > 0
    assert handles[1].preemptions > 0 and handles[0].preemptions == 0
    for h in handles:
        assert h.peek() == expected_sum_stream(h.request.prompt, 8)


@pytest.mark.parametrize("flavor", [dict(), dict(fuse_wave=False),
                                    dict(vectorized=False)],
                         ids=["fused", "prefused", "looped"])
def test_preemption_resumes_sampled_stream_bit_identically(flavor):
    """The resumed request's draws restart at position len(generated),
    so its sampled stream and logprobs equal its uncontended run."""
    spec = SamplerSpec(temperature=0.8, seed=11)

    def run(pool):
        sess = ServeSession(sum_backend(), max_batch=4, page_pool=pool,
                            **flavor)
        handles = [sess.submit(Request(rid, p, max_new_tokens=8,
                                       sampler=spec))
                   for rid, p in enumerate(_prompts(2))]
        sess.run_until_drained()
        return sess, [(h.peek(), h.logprobs()) for h in handles]

    _, free = run(None)
    tight, contended = run(KVPagePool(4, page_size=4))
    assert tight.stats["preemptions"] > 0
    assert contended == free


def test_preempted_requests_requeue_in_submission_order():
    sess = ServeSession(sum_backend(), max_batch=4,
                        page_pool=KVPagePool(5, page_size=4))
    handles = [sess.submit(Request(rid, p, max_new_tokens=8))
               for rid, p in enumerate(_prompts(4))]
    preempted_seen = 0
    for _ in range(200):
        if sess.idle:
            break
        sess.step()
        victims = [h for h in sess.queue if h.preemptions > 0]
        preempted_seen = max(preempted_seen, len(victims))
        idx = [h._submit_index for h in victims]
        assert idx == sorted(idx)
    assert sess.idle and preempted_seen > 0
    for h in handles:
        assert h.peek() == expected_sum_stream(h.request.prompt, 8)


def _head_of_line_requests():
    small = [(rid, np.asarray([rid + 1, 2, 3, 5], np.int32), 8)
             for rid in range(3)]  # quantum-8 signature
    large = [(rid, np.arange(1, 13, dtype=np.int32), 4)
             for rid in range(3, 5)]  # quantum-16 signature
    return small + large


def test_overlap_head_of_line_stress_with_pool_exhaustion():
    """A large-quantum group parks behind the in-flight small-quantum
    wave while the pool preempts the running requests; nothing overtakes,
    victims requeue in order, every stream matches its uncontended run."""
    def run(pool):
        sess = ServeSession(sum_backend(quantum=8), max_batch=3,
                            scheduler=OverlapScheduler(), page_pool=pool)
        handles = [sess.submit(Request(rid, p, max_new_tokens=n))
                   for rid, p, n in _head_of_line_requests()]
        for _ in range(300):
            if sess.idle:
                break
            sess.step()
            idx = [h._submit_index for h in sess.queue if h.preemptions]
            assert idx == sorted(idx)
        assert sess.idle and all(h.done for h in handles)
        return sess, [h.peek() for h in handles]

    _, free = run(None)
    tight, contended = run(KVPagePool(7, page_size=4))
    assert tight.stats["preemptions"] > 0
    assert contended == free


def test_pool_disabled_keeps_legacy_behaviour():
    sess = ServeSession(sum_backend(), max_batch=2)
    handles = [sess.submit(Request(rid, np.arange(4, dtype=np.int32),
                                   max_new_tokens=4)) for rid in range(4)]
    assert sess.pool_admits(handles[0])
    assert sess.pool_admit_count(handles) == 4
    assert sess.preempt_overcommitted() == 0
    sess.run_until_drained()
    assert sess.stats["preemptions"] == 0


# -- parity with the reference session ----------------------------------------


def _trace(stack, backend, *, scheduler, pool_pages, page_size=4,
           max_batch=4, sampled=False, quantum_trace=False, **flavor):
    """One trace through ``stack`` (the reference's or the port's serve
    package): streams, logprob count, stats, completion order, peak
    pages and each handle's preemptions."""
    pool = (stack.KVPagePool(pool_pages, page_size=page_size)
            if pool_pages else None)
    spec_cls = JSamplerSpec if stack is jserve else SamplerSpec
    sched = getattr(stack, scheduler)()
    sess = stack.ServeSession(backend, max_batch=max_batch, scheduler=sched,
                              page_pool=pool, **flavor)
    reqs = (_head_of_line_requests() if quantum_trace
            else [(rid, p, 8) for rid, p in enumerate(_prompts(4))])
    handles = []
    for rid, p, n in reqs:
        spec = (spec_cls(temperature=0.8, seed=30 + rid)
                if sampled and rid % 2 else None)
        stop = (0,) if rid == 0 else ()  # request 0 ends at EOS
        handles.append(sess.submit(stack.Request(rid, p, max_new_tokens=n,
                                                 sampler=spec,
                                                 stop_tokens=stop)))
    sess.run_until_drained()
    return dict(streams=[h.peek() for h in handles],
                n_logprobs=[len(h.logprobs()) for h in handles],
                stats=dict(sess.stats), order=list(sess.completion_order),
                peak=pool.peak_pages if pool is not None else None,
                preemptions=[h.preemptions for h in handles],
                stopped=[h.stopped for h in handles])


@pytest.mark.parametrize("case", [
    dict(scheduler="FifoScheduler", pool_pages=5),
    dict(scheduler="OverlapScheduler", pool_pages=5),
    dict(scheduler="OverlapScheduler", pool_pages=5, sampled=True),
    dict(scheduler="FifoScheduler", pool_pages=5, vectorized=False),
    dict(scheduler="OverlapScheduler", pool_pages=6, fuse_wave=False,
         sampled=True),
    dict(scheduler="OverlapScheduler", pool_pages=7, max_batch=3,
         quantum_trace=True),
    dict(scheduler="OverlapScheduler", pool_pages=None, max_batch=2),
], ids=["fifo_pool", "overlap_pool", "overlap_pool_sampled",
        "fifo_pool_looped", "overlap_pool_prefused_sampled",
        "overlap_head_of_line", "overlap_unbounded"])
def test_scheduling_matches_reference(case):
    """Same trace, same toy backend, both stacks: the streams, every
    session stat (preemptions, overlapped prefills, prefill calls, ...),
    the completion order and the pool's peak are equal."""
    quantum = 8 if case.get("quantum_trace") else None
    port = _trace(serve, sum_backend(quantum=quantum), **case)
    ref = _trace(jserve, jax_sum_backend(quantum=quantum), **case)
    assert port == ref
    assert port["stats"]["completed"] == len(port["streams"])
    if case["pool_pages"]:  # not vacuous: the pool preempted
        assert port["stats"]["preemptions"] > 0
