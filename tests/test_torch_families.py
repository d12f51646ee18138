"""The attention-free (RWKV6) and hybrid (RG-LRU + local attention)
families of the port against the JAX reference, on reduced configs with
the reference's parameters bridged bit for bit.

* a teacher-forced ``decode_step`` chain: logits within ``LOGIT_TOL``
  each step, greedy tokens equal (or a near tie), recurrent leaves within
  ``REC_TOL`` of their magnitude, local-attention K/V rows within
  ``KV_TOL``, lengths and positions equal;
* the port's ``prefill`` state against the **reference's token-by-token
  chain** over the same prompt. The reference's own ``prefill`` returns
  the recurrent states empty (``test_reference_prefill_forgets_the_prompt``
  pins that fault; the port does not copy it);
* a dense ``ServeSession`` of the port against the reference's chain
  followed by greedy decode, prompt by prompt;
* the hybrid's bounded local cache: a request that would pass it is
  refused at submit.

Tolerances: logits are bf16 of size < 1 (ulp 0.0039), measured 0.0098
(rwkv) and 0.011 (hybrid) after 40 steps. Recurrent leaves carry the
bf16 projections' rounding differences: measured 0.0058 (RWKV ``S``) and
0.0079 (the bf16 token-shift rows) of the leaf's largest magnitude, 0.0054
(RG-LRU); ``REC_TOL`` is 0.02 of it. RG-LRU over a prompt is a loop here
and an associative scan in the reference: the same products in another
order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import f32
from _torch_port import one_torch_thread  # noqa: F401  (autouse)
from repro import configs as jconfigs
from repro.models import griffin as jgriffin
from repro.models import model as jmodel
from repro_torch import bridge, configs
from repro_torch.launch import serve as launch_serve
from repro_torch.models import griffin, model
from repro_torch.runtime.graphs import leaves
from repro_torch.serve import Request

ARCHS = ("rwkv6-1.6b", "recurrentgemma-2b")
LOGIT_TOL = 0.02
REC_TOL = 0.02
KV_TOL = 0.0625
HIDDEN_TOL = 0.0625
CHAIN = 40  # past the reduced hybrid's local window of 32


@pytest.fixture(scope="module", params=ARCHS)
def bridged(request):
    jcfg = jconfigs.get(request.param).reduced()
    cfg = configs.get(request.param).reduced()
    jparams = jmodel.init_params(jcfg, jax.random.key(0))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    step = jax.jit(lambda s, t: jmodel.decode_step(jparams, jcfg, s, t))
    return jcfg, cfg, jparams, params, step


def _ref_chain(jcfg, step, toks):
    """The reference's ``decode_step`` over every token: (logits per
    step, final state)."""
    state = jmodel.init_decode_state(jcfg, toks.shape[0], toks.shape[1])
    logits = []
    for i in range(toks.shape[1]):
        lg, state = step(state, jnp.asarray(toks[:, i:i + 1]))
        logits.append(lg)
    return logits, state


@pytest.fixture(scope="module")
def chains(bridged):
    jcfg, cfg, jparams, params, step = bridged
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (2, CHAIN)).astype(np.int32)
    jlogits, jstate = _ref_chain(jcfg, step, toks)
    state = model.init_decode_state(cfg, 2, CHAIN, device="cpu")
    logits = []
    for i in range(CHAIN):
        lg, state = model.decode_step(params, cfg, state,
                                      torch.from_numpy(toks[:, i:i + 1]))
        logits.append(lg)
    return toks, jlogits, jstate, logits, state


def assert_greedy_agrees(tl, jl):
    """Equal argmax tokens, except where the reference's two logits lie
    within 2 * LOGIT_TOL (a near tie)."""
    t, j = f32(tl), f32(jl)
    got, want = t.argmax(-1), j.argmax(-1)
    for row in np.flatnonzero(got != want):
        gap = j[row, want[row]] - j[row, got[row]]
        assert gap <= 2 * LOGIT_TOL, (row, got[row], want[row], gap)


def assert_states_close(state, jstate):
    """Recurrent leaves within REC_TOL of the reference leaf's largest
    magnitude, K/V rows within KV_TOL, lengths and position equal."""
    jrec = [x for x in jax.tree.leaves(jstate.rec)]
    rec = list(leaves(state.rec))
    assert len(rec) == len(jrec) > 0
    for got, want in zip(rec, jrec):
        assert got.dtype == getattr(torch, str(want.dtype))
        assert tuple(got.shape) == want.shape
        scale = float(np.abs(f32(want)).max())
        np.testing.assert_allclose(f32(got), f32(want),
                                   atol=REC_TOL * max(scale, 1.0))
    caches = state.caches()
    jcaches = [] if jstate.kv is None else [c for c in jstate.kv
                                            if c is not None]
    assert len(caches) == len(jcaches)
    for got, want in zip(caches, jcaches):
        np.testing.assert_array_equal(got.length.numpy(),
                                      np.asarray(want.length))
        np.testing.assert_allclose(f32(got.k), f32(want.k), atol=KV_TOL)
        np.testing.assert_allclose(f32(got.v), f32(want.v), atol=KV_TOL)
    np.testing.assert_array_equal(state.position.numpy(),
                                  np.asarray(jstate.position))


def test_decode_chain_matches_reference(bridged, chains):
    toks, jlogits, jstate, logits, state = chains
    worst = 0.0
    for tl, jl in zip(logits, jlogits):
        assert tl.dtype == torch.bfloat16
        worst = max(worst, float(np.abs(f32(tl) - f32(jl)).max()))
        assert_greedy_agrees(tl, jl)
    assert worst <= LOGIT_TOL, worst
    assert_states_close(state, jstate)


def test_prefill_state_matches_reference_chain(bridged, chains):
    """The port's prefill carries the prompt: its state is the
    reference's token-by-token chain's, and its logits the chain's
    last."""
    jcfg, cfg, jparams, params, step = bridged
    toks, jlogits, jstate, logits, state = chains
    tl, pre = model.prefill(params, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(f32(tl), f32(jlogits[-1]), atol=LOGIT_TOL)
    assert_states_close(pre, jstate)
    # and the port's own chain, leaf for leaf
    for a, b in zip(leaves(pre), leaves(state), strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_reference_prefill_forgets_the_prompt(bridged):
    """Pins a fault of the reference (``src/repro/models/model.py``
    ``prefill`` builds a decode state only for uniform attention stacks):
    for these families it returns the initial state with only the
    position set, so a decode after it ignores the prompt. Written to
    pass on the reference as it is; the port's prefill keeps the states
    (``test_prefill_state_matches_reference_chain``)."""
    jcfg, cfg, jparams, params, step = bridged
    toks = np.arange(12, dtype=np.int32)[None] % cfg.vocab
    _, jstate = jmodel.prefill(jparams, jcfg, jnp.asarray(toks))
    assert all(not np.asarray(x).any() for x in jax.tree.leaves(jstate.rec))
    for cache in (jstate.kv or []):
        if cache is not None:
            assert not np.asarray(cache.length).any()
    np.testing.assert_array_equal(np.asarray(jstate.position), [12])
    _, pre = model.prefill(params, cfg, torch.from_numpy(toks))
    assert all(t.any() for t in leaves(pre.rec))


def test_forward_matches_reference(bridged):
    jcfg, cfg, jparams, params, step = bridged
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 37)).astype(np.int32)
    want = jmodel.forward(jparams, jcfg, jnp.asarray(toks))
    got = model.forward(params, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(f32(got), f32(want), atol=HIDDEN_TOL)


def test_rglru_loop_matches_associative_scan():
    """The prompt recurrence as a loop against the reference's
    associative scan, from a nonzero h0: f32 within a few ulps of the
    state's magnitude (the products in another order)."""
    jcfg = jconfigs.get("recurrentgemma-2b").reduced()
    cfg = configs.get("recurrentgemma-2b").reduced()
    jp = jgriffin.init_rec(jax.random.key(3), jcfg, jnp.bfloat16)
    p = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(4)
    jx = jnp.asarray(rng.normal(size=(2, 33, cfg.d_model)), jnp.bfloat16)
    x = bridge.tensor_from_numpy(np.asarray(jx), device="cpu")
    h0 = rng.normal(size=(2, cfg.d_model)).astype(np.float32)
    jy, jh = jgriffin.rglru(jp, jx, jnp.asarray(h0))
    y, h = griffin.rglru(p, x, torch.from_numpy(h0))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(f32(y), f32(jy), atol=HIDDEN_TOL)
    # one step of the loop is the decode update
    y1, h1 = griffin.rglru_step(p, x[:, :1], torch.from_numpy(h0))
    jy1, jh1 = jgriffin.rglru_step(jp, jx[:, :1], jnp.asarray(h0))
    np.testing.assert_allclose(h1.numpy(), np.asarray(jh1), rtol=1e-4,
                               atol=1e-4)


def _prompts(vocab, lengths=(19, 27, 33)):
    rng = np.random.default_rng(5)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def test_dense_session_matches_reference_chain(bridged):
    """The port's dense session (prefill, then batch-3 waves) against
    the reference's batch-1 chain over each prompt, then greedy steps fed
    their own argmax: equal streams, or a parting at a near tie."""
    jcfg, cfg, jparams, params, step = bridged
    new = 5
    prompts = _prompts(cfg.vocab)
    sess = launch_serve.build_session(cfg, params, policy="dense",
                                      device="cpu")
    handles = [sess.submit(Request(r, p, max_new_tokens=new))
               for r, p in enumerate(prompts)]
    stats = sess.run_until_drained()
    assert stats["completed"] == 3 and stats["sectored_steps"] == 0
    compared = 0
    for h, prompt in zip(handles, prompts):
        logits, state = _ref_chain(jcfg, step, prompt[None])
        lg = logits[-1]
        for tok in h.peek():
            want = int(f32(lg).argmax(-1)[0])
            if tok != want:
                assert f32(lg)[0, want] - f32(lg)[0, tok] <= 2 * LOGIT_TOL
                break
            compared += 1
            lg, state = step(state, jnp.asarray([[tok]], jnp.int32))
    assert compared >= 2 * new, compared


def test_hybrid_refuses_requests_past_its_local_cache():
    cfg = configs.get("recurrentgemma-2b").reduced()
    params = model.init_params(cfg, device="cpu")
    rows = model.local_cache_rows(cfg, 200)
    assert rows == 256  # _pad_seq(32, 256)
    sess = launch_serve.build_session(cfg, params, device="cpu")
    fits = np.zeros(rows - 6, np.int32)
    sess.submit(Request(0, fits, max_new_tokens=6))
    with pytest.raises(ValueError, match="256-token attention cache"):
        sess.submit(Request(1, fits, max_new_tokens=7))
    with pytest.raises(ValueError, match="local attention cache"):
        model.prefill(params, cfg, torch.zeros((1, rows + 1),
                                               dtype=torch.int32))
    # the other families' states grow with the prompt: no such bound
    rwkv = configs.get("rwkv6-1.6b").reduced()
    backend = launch_serve.build_backend(
        rwkv, model.init_params(rwkv, device="cpu"), device="cpu")
    assert backend.token_capacity(200) is None
    assert backend.sectored_fn is None  # no sectored step, as in the reference


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_rows_forks_and_batches(arch):
    cfg = configs.get(arch).reduced()
    params = model.init_params(cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, 9)).astype(np.int32))
    _, state = model.prefill(params, cfg, toks)
    fork = state.fork()
    for a, b in zip(leaves(state.rec), leaves(fork.rec)):
        assert a.data_ptr() != b.data_ptr() and torch.equal(a, b)
    for a, b in zip(state.caches(), fork.caches()):
        assert a.k.data_ptr() == b.k.data_ptr()
        assert a.length.data_ptr() != b.length.data_ptr()
    # a functional step leaves the old state's recurrent leaves as they
    # were (it writes into the fork's copies)
    before = state.clone()
    model.decode_step(params, cfg, state, toks[:, :1])
    for a, b in zip(leaves(before.rec), leaves(state.rec)):
        assert torch.equal(a, b)
    wave = state.zeros_batch(4)
    wave.set_row(3, state.row(1))
    for a, b in zip(leaves(wave.row(3)), leaves(state.row(1)),
                    strict=True):
        assert torch.equal(a, b)
    assert not any(t.any() for t in leaves(wave.row(0)))
    other = model.init_decode_state(
        configs.get(arch).reduced(d_model=64), 1, 9, device="cpu")
    with pytest.raises(ValueError, match="cannot join a wave"):
        wave.set_row(0, other)


def test_bridge_carries_a_hybrids_layer_list():
    jcfg = jconfigs.get("recurrentgemma-2b").reduced()
    cfg = configs.get("recurrentgemma-2b").reduced()
    jparams = jmodel.init_params(jcfg, jax.random.key(0))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    assert isinstance(params["layers"], list)
    assert [("rec" in lp, "attn" in lp) for lp in params["layers"]] == [
        (k == "rec", k == "attn") for k in cfg.layer_kinds]
    for got, want in zip(leaves(params), jax.tree.leaves(jparams),
                         strict=True):
        np.testing.assert_array_equal(
            bridge.tensor_to_numpy_bits(got),
            np.asarray(want).view(np.uint16) if want.dtype == jnp.bfloat16
            else np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_prefill_state_matches_its_chain(arch):
    """With f32 weights and an f32 state, the port's prefill and its own
    token-by-token chain agree to f32 rounding at every layer (within
    1e-5 of each leaf's magnitude; measured <= 1.7e-6 on the CPU): the
    bf16 gap between the two comes from the projections' rounding alone.
    This is the CPU side of ``chip_smoke.py``'s leg D witness."""
    from repro_torch.runtime.graphs import map_tree
    cfg = configs.get(arch).reduced()
    params = map_tree(lambda t: t.float(),
                      model.init_params(cfg, device="cpu"))
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (1, CHAIN)).astype(np.int32))
    logits, state = model.prefill(params, cfg, toks, torch.float32)
    chain = model.init_decode_state(cfg, 1, CHAIN, torch.float32,
                                    device="cpu")
    for i in range(CHAIN):
        last = model.decode_step_(params, cfg, chain, toks[:, i:i + 1])
    got = [*leaves(state.rec),
           *(t for c in state.caches() for t in (c.k, c.v))]
    want = [*leaves(chain.rec),
            *(t for c in chain.caches() for t in (c.k, c.v))]
    assert got and all(t.dtype == torch.float32 for t in got)
    for a, b in zip(got, want, strict=True):
        assert float((a - b).abs().max()) <= 1e-5 * max(
            float(b.abs().max()), 1.0)
    for a, b in zip(state.caches(), chain.caches(), strict=True):
        assert torch.equal(a.length, b.length)
    assert torch.equal(state.position, chain.position)
    assert float((logits - last).abs().max()) <= 1e-4
