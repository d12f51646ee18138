"""The serving path's captured-graph form, on the CPU.

A CUDA graph cannot be captured here, so these tests hold what the graph
path rests on, with an eager stand-in where a capture would be:

* the in-place step (``sectored_decode_step_``, the body a graph captures)
  equals the functional step bitwise over steps that cross a page
  boundary, in exact mode and at a narrow budget (dispatch and fused);
* the static-buffer prefill (one state, zeroed before each prompt, the
  step replayed token by token) equals the functional loop bitwise and
  holds against the JAX reference's prefill;
* a session whose wave runs through :class:`CapturedStep` (a stand-in
  graph that replays eagerly) keeps one wave buffer and one set of
  sampler rows for its whole life, gives the reference's greedy streams
  and stats, and is bitwise the eager session; so are a sampled wave
  (greedy and sampled requests sharing it) and the dense path's waves;
* the in-place ``SamplerRows`` operations and the in-place wave equal
  their functional forms;
* replay launch accounting, through a stand-in counter.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import f32, small_models
from _torch_port import one_torch_thread  # noqa: F401  (autouse)
from repro.runtime import sectored_decode as jsd
from repro.serve import AlwaysSectored as JAlwaysSectored
from repro.serve import Request as JRequest
from repro.serve import ServeSession as JServeSession
from repro_torch.launch import serve as launch_serve
from repro_torch.runtime import graphs, sectored_decode
from repro_torch.sample import SamplerRows, SamplerSpec
from repro_torch.serve import (AlwaysDense, AlwaysSectored, Request,
                               ServeSession, fused_select_step,
                               make_fused_wave)

PAGE = sectored_decode.PAGE_SIZE
SEQ_LEN = 384  # 8 padded pages
PROMPT = 125  # the steps below cross the first page boundary
# the tolerances of tests/test_torch_sectored_decode.py (measured there:
# logits 0.0051, table 2.8e-4, K/V 0.031)
LOGIT_TOL = 0.02
TABLE_TOL = 2e-3
KV_TOL = 0.0625
# and of tests/test_torch_serve.py (logprobs measured 0.0035)
LOGPROB_TOL = 0.02


@pytest.fixture(scope="module")
def models():
    return small_models()


@pytest.fixture(scope="module")
def prefilled(models):
    """A batch-2 state after PROMPT exact steps, and the tokens."""
    _, cfg, _, params = models
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab, (2, PROMPT + 8)).astype(np.int32))
    state = sectored_decode.init_state(cfg, 2, SEQ_LEN, device="cpu")
    P = state.table.shape[-1]
    for i in range(PROMPT):
        _, state = sectored_decode.sectored_decode_step(
            params, cfg, state, toks[:, i:i + 1], P)
    return state, toks


def _assert_states_equal(a, b):
    for x, y in zip(graphs.leaves(a), graphs.leaves(b), strict=True):
        assert torch.equal(x, y)


@pytest.mark.parametrize("mode", ["exact", "dispatch", "fused"])
def test_in_place_step_equals_functional(models, prefilled, mode):
    _, cfg, _, params = models
    state, toks = prefilled
    P = state.table.shape[-1]
    k, probe, kernel = ((P, False, "dispatch") if mode == "exact"
                        else (1, True, mode))
    functional, in_place = state.clone(), state.clone()
    for i in range(PROMPT, PROMPT + 6):  # lengths 125 .. 131
        tok = toks[:, i:i + 1]
        lf, functional = sectored_decode.sectored_decode_step(
            params, cfg, functional, tok, k, probe=probe, kernel=kernel)
        li = sectored_decode.sectored_decode_step_(
            params, cfg, in_place, tok, k, probe=probe, kernel=kernel)
        assert torch.equal(lf, li)
        _assert_states_equal(functional, in_place)
    assert int(in_place.kv.length.min()) > PAGE
    assert in_place.position.tolist() == [PROMPT + 6] * 2


def test_functional_step_leaves_the_old_state(models, prefilled):
    """The functional step runs on a fork: the caller's K/V take the new
    row, its length, table and position do not move."""
    _, cfg, _, params = models
    state, toks = prefilled
    old = state.clone()
    _, new = sectored_decode.sectored_decode_step(
        params, cfg, old, toks[:, PROMPT:PROMPT + 1], 1, probe=True)
    assert new.kv.k is old.kv.k and new.kv.v is old.kv.v
    for name in ("table", "position"):
        assert torch.equal(getattr(old, name), getattr(state, name))
    assert torch.equal(old.kv.length, state.kv.length)
    assert torch.equal(new.kv.length, state.kv.length + 1)


class StandInCapture(graphs.CapturedStep):
    """CPU stand-in for the CUDA calls of :class:`graphs.CapturedStep`:
    the warm-up runs the body on the scratch copy; the capture runs it on
    another copy (as a capture runs the Python once and the device never);
    a replay runs the body on the static inputs with the counters left
    alone (a real replay runs no Python) and copies the results into the
    outputs, as a graph's replay rewrites its output memory."""

    def _warm_up(self, scratch):
        self.body(*scratch)

    def _record(self, static):
        out = self.body(*graphs.clone_tree(static))

        class Replay:
            def replay(_):
                with graphs.uncounted(self.counters):
                    graphs.copy_tree_(self.out, self.body(*static))
        return Replay(), out


def _stand_in_graphs(backend, monkeypatch):
    """Turn a CPU backend's graph path on, with the stand-in capture."""
    monkeypatch.setattr(graphs, "CapturedStep", StandInCapture)
    backend.graphs = True
    for step in backend._k_cache.values():
        step.graphs = True


def test_static_prefill_equals_loop_and_reference(models, monkeypatch):
    jcfg, cfg, jparams, params = models
    backend = sectored_decode.make_serving_fns(cfg, params=params,
                                               seq_len=SEQ_LEN, device="cpu")
    _stand_in_graphs(backend, monkeypatch)
    jbackend = jsd.make_serving_fns(jcfg, params=jparams, seq_len=SEQ_LEN)
    rng = np.random.default_rng(5)
    # the second prompt is shorter: rows the first one left in the static
    # state would show if the state were not zeroed
    for n in (140, 60):
        prompt = rng.integers(0, cfg.vocab, (1, n)).astype(np.int32)
        logits, state = backend.prefill_fn(prompt)
        static, _ = backend._prefill_graphs[1]
        assert state.kv.k.data_ptr() != static.kv.k.data_ptr()  # a copy

        want = sectored_decode.init_state(cfg, 1, SEQ_LEN, device="cpu")
        for i in range(n):
            want_logits, want = sectored_decode.sectored_decode_step(
                params, cfg, want, torch.from_numpy(prompt[:, i:i + 1]),
                backend.pages)
        assert torch.equal(logits, want_logits)
        _assert_states_equal(state, want)

        jlogits, jstate = jbackend.prefill_fn(prompt)
        assert np.abs(f32(logits) - f32(jlogits)).max() <= LOGIT_TOL
        np.testing.assert_array_equal(state.kv.length.numpy(),
                                      np.asarray(jstate.kv.length))
        np.testing.assert_allclose(state.table.numpy(),
                                   np.asarray(jstate.table), atol=TABLE_TOL)
        np.testing.assert_allclose(f32(state.kv.k), f32(jstate.kv.k),
                                   atol=KV_TOL)
        np.testing.assert_allclose(f32(state.kv.v), f32(jstate.kv.v),
                                   atol=KV_TOL)
    assert list(backend._prefill_graphs) == [1]  # one graph, every length


def _prompts(vocab):
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, vocab, 260).astype(np.int32)
               for _ in range(3)]
    return prompts[:2] + [prompts[1].copy()] + prompts[2:]  # one merge


def _port_session(cfg, params, monkeypatch=None):
    backend = sectored_decode.make_serving_fns(
        cfg, params=params, seq_len=SEQ_LEN, min_topk=1, kernel="fused",
        device="cpu")
    if monkeypatch is not None:
        _stand_in_graphs(backend, monkeypatch)
    return ServeSession(backend, max_batch=4, policy=AlwaysSectored())


def test_session_on_static_buffers(models, monkeypatch):
    jcfg, cfg, jparams, params = models
    prompts = _prompts(cfg.vocab)

    jbackend = jsd.make_serving_fns(jcfg, params=jparams, seq_len=SEQ_LEN,
                                    min_topk=1, kernel="dispatch")
    jsess = JServeSession(jbackend, max_batch=4, policy=JAlwaysSectored())
    jh = [jsess.submit(JRequest(r, p, max_new_tokens=4))
          for r, p in enumerate(prompts)]
    jstats = jsess.run_until_drained()

    runs = {}
    for name, patch in (("eager", None), ("captured", monkeypatch)):
        sess = _port_session(cfg, params, patch)
        handles = [sess.submit(Request(r, p, max_new_tokens=4))
                   for r, p in enumerate(prompts)]
        buffers = []
        while not sess.idle:
            sess.step()
            if sess.batched is not None:
                buffers.append([t.data_ptr() for t in graphs.leaves(
                    (sess.batched, sess._sampler_rows))])
        runs[name] = (sess, handles)
        assert all(b == buffers[0] for b in buffers)  # never rebound

    sess, handles = runs["captured"]
    eager, eager_handles = runs["eager"]
    waves = list(sess._wave_cache.values())
    assert waves and all(isinstance(w, StandInCapture) for w in waves)
    for key in ("completed", "waves", "sectored_steps", "decode_steps",
                "sectored_waves", "merged_slots", "prefill_calls"):
        assert sess.stats[key] == jstats[key], key
    assert sess.stats["merged_slots"] > 0
    for j, t, e in zip(jh, handles, eager_handles):
        assert t.peek() == j.peek() == e.peek()
        assert t.logprobs() == e.logprobs()
        assert max(abs(a - b) for a, b in zip(t.logprobs(), j.logprobs())) \
            <= LOGPROB_TOL
    _assert_states_equal(sess.batched, eager.batched)
    _assert_states_equal(sess._sampler_rows, eager._sampler_rows)


def _sampled_specs():
    """Requests 0 and 2 sampled, 1 and 3 greedy (``--sample-every 2``)."""
    return [SamplerSpec(temperature=0.8, top_k=50, top_p=0.9, seed=3 + r)
            if r % 2 == 0 else None for r in range(4)]


def _serve_both_ways(make_session, prompts, specs, max_new=4):
    """The same requests served eagerly and through the stand-in graph:
    (eager session, its handles, captured session, its handles); the
    captured session's wave buffer and rows never move."""
    runs = []
    for captured in (False, True):
        sess = make_session(captured)
        handles = [sess.submit(Request(r, p, max_new_tokens=max_new,
                                       sampler=s))
                   for r, (p, s) in enumerate(zip(prompts, specs))]
        buffers = []
        while not sess.idle:
            sess.step()
            buffers.append([t.data_ptr() for t in graphs.leaves(
                (sess.batched, sess._sampler_rows))])
        assert all(b == buffers[0] for b in buffers)  # never rebound
        runs += [sess, handles]
    eager, eager_handles, sess, handles = runs
    assert all(isinstance(w, StandInCapture)
               for w in sess._wave_cache.values())
    for t, e in zip(handles, eager_handles):
        assert t.peek() == e.peek() and t.logprobs() == e.logprobs()
        assert len(t.peek()) == max_new
    _assert_states_equal(sess.batched, eager.batched)
    _assert_states_equal(sess._sampler_rows, eager._sampler_rows)
    return eager, eager_handles, sess, handles


def test_sampled_wave_on_static_buffers(models, monkeypatch):
    """A mixed wave (greedy and sampled requests) of the fused sectored
    backend, replayed through the stand-in graph, is bitwise the eager
    one; its greedy requests keep the greedy-only session's streams."""
    _, cfg, _, params = models
    prompts = [p[:130] for p in _prompts(cfg.vocab)]  # one page crossed
    prompts.append(prompts[0][::-1].copy())

    def make(captured):
        return _port_session(cfg, params, monkeypatch if captured else None)
    _, _, sess, handles = _serve_both_ways(make, prompts, _sampled_specs())
    assert [key[1] for key in sess._wave_cache] == [True]
    greedy = make(False)
    greedy_handles = [greedy.submit(Request(r, p, max_new_tokens=4))
                      for r, p in enumerate(prompts)]
    greedy.run_until_drained()
    assert [key[1] for key in greedy._wave_cache] == [False]
    for r in (1, 3):
        assert handles[r].peek() == greedy_handles[r].peek()
    assert any(handles[r].peek() != greedy_handles[r].peek()
               for r in (0, 2))


def test_dense_session_on_static_buffers(models, monkeypatch):
    """The dense path's greedy and sampled waves, replayed through the
    stand-in graph, are bitwise the eager ones (dense prefill stays
    eager)."""
    _, cfg, _, params = models
    prompts = [p[:40 + 9 * i] for i, p in enumerate(_prompts(cfg.vocab))]
    prompts.append(prompts[0][::-1].copy())

    def make(captured):
        backend = launch_serve.build_backend(cfg, params, device="cpu")
        if captured:
            monkeypatch.setattr(graphs, "CapturedStep", StandInCapture)
            backend.graphs = backend.decode_fn.graphs = True
        return ServeSession(backend, max_batch=4, policy=AlwaysDense())
    for specs in ([None] * 4, _sampled_specs()):
        _, _, sess, _ = _serve_both_ways(make, prompts, specs)
        assert len(sess._wave_cache) == 1
        assert sess.batched.kv.k.shape[2] == 1024


def _rows(n=4, seed=0):
    rows = SamplerRows.init(n, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    rows.pos = torch.randint(0, 50, (n,), generator=gen, dtype=torch.int32)
    rows.stop[:, 0] = torch.randint(0, 16, (n,), generator=gen,
                                    dtype=torch.int32)
    return rows


def test_sampler_rows_in_place_equals_functional():
    rows = _rows()
    for hold in (None, torch.tensor([True, False, True, False])):
        want = rows.advance(hold=hold)
        got = rows.clone()
        assert got.advance_(hold=hold) is got
        _assert_states_equal(got, want)
    _assert_states_equal(rows, _rows())  # the functional forms copy

    new = SamplerRows.from_specs([None, None], [7, 9], [(3,), (1, 2)],
                                 device="cpu")
    want = rows.scatter([3, 1], new)
    got = rows.clone()
    assert got.scatter_([3, 1], new) is got
    _assert_states_equal(got, want)
    assert got.pos.tolist()[1] == 9 and got.stop[3, 0] == 3
    _assert_states_equal(rows, _rows())


def test_in_place_wave_equals_functional():
    """make_fused_wave's in-place wave against fused_select_step, over a
    toy step whose state is a counter; slot 2's input is in its stop set
    and slot 0's is not."""
    @dataclasses.dataclass
    class Toy:
        count: torch.Tensor

        def fork(self):
            return Toy(self.count.clone())

    def step_(state, token):
        state.count.add_(1)
        vocab = torch.arange(16, dtype=torch.float32)
        return torch.cos(vocab[None, :] * (token.float() + state.count))

    fn = graphs.Step(step_, graphs=False)
    rows = _rows()
    token = rows.stop[:, :1].clone()
    token[0] = (token[0] + 1) % 16
    want_tok, want_state, want_rows = fused_select_step(fn)(
        Toy(torch.zeros(4, 1)), token, rows)
    state, got_rows = Toy(torch.zeros(4, 1)), rows.clone()
    got_tok = make_fused_wave(fn)(state, token, got_rows)
    assert torch.equal(got_tok, want_tok)
    assert torch.equal(state.count, want_state.count)
    _assert_states_equal(got_rows, want_rows)
    assert got_tok[2, 0] == token[2, 0] and got_rows.logp[2] == 0
    assert got_rows.pos[2] == rows.pos[2]
    assert got_rows.pos[0] == rows.pos[0] + 1


def test_replay_launch_accounting():
    """A capture records the launches it holds and each replay adds them;
    the warm-up's and the capture's own launches are counted nowhere."""
    counter = {"paged": 0, "other": 0}

    def body(state, token):
        counter["paged"] += 2  # a wrapper counts each launch in Python
        state.add_(token)
        return state * 2

    state = torch.zeros(3)
    step = StandInCapture(body, counters=(counter,))
    counter["other"] = 5
    out = step(state, torch.ones(3))
    assert counter == {"paged": 2, "other": 5}
    assert step.launches == [{"paged": 2, "other": 0}]
    assert step.warmup_launches == [{"paged": 2, "other": 0}]
    assert torch.equal(state, torch.ones(3))  # warm-up and capture: copies
    for n in (2, 3):
        assert step(state, torch.ones(3)) is out
        assert counter["paged"] == 2 * n
    assert torch.equal(out, torch.full((3,), 6.0))

    with pytest.raises(ValueError, match="captured on"):
        step(torch.zeros(3), torch.ones(3))
    with pytest.raises(ValueError, match="shape"):
        step(state, torch.ones(4))
    with pytest.raises(RuntimeError, match="boom"):
        with graphs.uncounted((counter,)):
            counter["paged"] += 1
            raise RuntimeError("boom")
    assert counter["paged"] == 6


def test_copy_tree_skips_shared_buffers():
    a = sectored_decode.SectoredState(
        kv=sectored_decode.attention.KVCache(
            k=torch.zeros(2, 3), v=torch.zeros(2, 3),
            length=torch.zeros(2, dtype=torch.int32)),
        table=torch.zeros(4), position=torch.zeros(1, dtype=torch.int32))
    b = a.fork()
    b.table.fill_(1.0)
    b.kv.length.fill_(3)
    graphs.copy_tree_(a, b)
    assert a.table.tolist() == [1.0] * 4 and a.kv.length.tolist() == [3, 3]
    a.zero_()
    assert all(int(t.count_nonzero()) == 0 for t in graphs.leaves(a))
