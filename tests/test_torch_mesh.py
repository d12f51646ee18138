"""The port's serving mesh on the CPU: its sharding rules against the
reference's, spec for spec; mesh construction; the one-rank mesh (the
oracle's anchor) against the unmeshed port and the reference's ``(1,)``
``MeshBackend`` session; ``MeshBackend`` as a transparent decorator; the
CLI's ``--mesh``; and a checkpoint restored onto two ranks.

The reference's rules return ``NamedSharding``s, which need as many JAX
devices as the mesh has; here its ``NamedSharding`` is replaced, for the
test, by the bare spec, and both packages get a device-free mesh
(``FakeMesh``), so every mesh shape runs on one CPU. The multi-rank
cross-mesh oracle is ``tests/test_torch_mesh_oracle.py``.
"""

import re
import tempfile

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from _hypothesis_compat import given, settings, st
from conftest import spec_entry_axes

import _torch_mesh_ranks as ranks
from _torch_port import one_torch_thread  # noqa: F401  (autouse)
from _torch_port import small_models
from repro import configs as jconfigs
from repro.launch import mesh as jmesh
from repro.models import model as jmodel
from repro.parallel import sharding as jsharding
from repro.runtime import sectored_decode as jsd
from repro.serve import AlwaysSectored as JAlwaysSectored
from repro.serve import FifoScheduler as JFifo
from repro.serve import MeshBackend as JMeshBackend
from repro.serve import OverlapScheduler as JOverlap
from repro.serve import Request as JRequest
from repro.serve import SamplerSpec as JSamplerSpec
from repro.serve import ServeSession as JServeSession
from repro.telemetry import MeteredBackend as JMeteredBackend
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.checkpoint import manager
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model
from repro_torch.parallel import sharding
from repro_torch.runtime import sectored_decode
from repro_torch.runtime.graphs import leaves
from repro_torch.serve import MeshBackend, ServeSession, ServingBackend
from repro_torch.telemetry import MeteredBackend
from repro_torch.telemetry.meters import KVGeometry
from repro_torch.train import step as pstep


class FakeMesh:
    """A mesh as both packages' rules read it: axis names and a shape."""

    def __init__(self, shape, axes=("data", "model")):
        self.axis_names = tuple(axes)
        self.devices = np.zeros(shape)


# the reference's parameter and state rules name 'model' unconditionally,
# so they take ('data', 'model') meshes; the wave rules take ('data',) too
MESHES = [FakeMesh((4, 2)), FakeMesh((2, 2)), FakeMesh((16, 16))]
WAVE_MESHES = MESHES + [FakeMesh((2,), ("data",)), FakeMesh((2, 3)),
                        FakeMesh((1, 2))]


@pytest.fixture
def bare_specs(monkeypatch):
    """The reference's rules return their PartitionSpecs unplaced."""
    for mod in (jsharding, jsd, jstep):
        monkeypatch.setattr(mod, "NamedSharding", lambda mesh, spec: spec)


def norm(spec, ndim: int) -> tuple:
    """A spec of either package as a tuple of ``ndim`` entries, each None
    or a tuple of axis names."""
    entries = list(spec) + [None] * (ndim - len(list(spec)))
    return tuple(spec_entry_axes(e) or None for e in entries[:ndim])


def ref_leaves(tree) -> list:
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def assert_same_specs(jspecs, jshapes, pspecs, pshapes):
    """The two packages' spec trees over leaf-for-leaf equal shapes."""
    jl, js = ref_leaves(jspecs), jax.tree_util.tree_leaves(jshapes)
    pl, ps = list(sharding.spec_leaves(pspecs)), list(leaves(pshapes))
    assert [tuple(x.shape) for x in js] == [tuple(t.shape) for t in ps]
    assert len(jl) == len(pl) == len(js)
    for a, b, x in zip(jl, pl, js):
        assert norm(a, x.ndim) == norm(b, x.ndim), (x.shape, a, b)


# -- the rules, spec for spec ------------------------------------------------


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_param_shardings_match_reference(bare_specs, arch):
    """Every parameter of every arch at its published width, on the
    reference's forced (4, 2) mesh, on (2, 2) and (16, 16), with and
    without fsdp."""
    jcfg = jconfigs.get(arch)
    jshapes = jax.eval_shape(lambda: jmodel.init_params(jcfg,
                                                        jax.random.key(0)))
    pshapes = sharding.abstract(model.init_params, configs.get(arch),
                                device="cpu")
    for mesh in MESHES:
        for fsdp in (False, True):
            assert_same_specs(
                jsharding.param_shardings(mesh, jshapes, fsdp=fsdp),
                jshapes, sharding.param_shardings(mesh, pshapes, fsdp=fsdp),
                pshapes)


@pytest.mark.parametrize("long_context", [False, True])
def test_state_shardings_match_reference(bare_specs, long_context):
    """``sectored_state_shardings`` over the SectoredState of yi-6b and
    ``decode_state_shardings`` over every arch's DecodeState."""
    jcfg, cfg = jconfigs.get("yi-6b"), configs.get("yi-6b")
    for mesh in MESHES:
        jst = jax.eval_shape(lambda: jsd.init_state(jcfg, 4, 2048))
        pst = sharding.abstract(sectored_decode.init_state, cfg, 4, 2048,
                                device="cpu")
        assert_same_specs(
            jsharding.sectored_state_shardings(mesh, jst, long_context),
            jst, sharding.sectored_state_shardings(mesh, pst, long_context),
            pst)
    for arch in configs.ARCHS:
        jcfg, cfg = jconfigs.get(arch), configs.get(arch)
        jst = jax.eval_shape(lambda: jmodel.init_decode_state(jcfg, 4,
                                                              1024))
        pst = sharding.abstract(model.init_decode_state, cfg, 4, 1024,
                                device="cpu")
        for mesh in MESHES:
            assert_same_specs(
                jsharding.decode_state_shardings(mesh, jst, long_context),
                jst, sharding.decode_state_shardings(mesh, pst,
                                                     long_context), pst)


def _ref_to_port(name: str, entries: tuple, port_axis: int) -> tuple:
    """A reference wave-buffer spec (slot axis first, then the row's own
    axes with its batch-1 axis) in the port's layout (the slot axis is
    the row's batch axis)."""
    if port_axis == 0:  # (slots, 1) -> (slots,)
        assert entries[1] is None
        return (entries[0],) + entries[2:]
    # (slots, L, 1, rest...) -> (L, slots, rest...)
    assert entries[2] is None, (name, entries)
    return (entries[1], entries[0]) + entries[3:]


@pytest.mark.parametrize("slots", [8, 5])
def test_wave_shardings_match_reference(bare_specs, slots):
    """The wave buffer's specs leaf for leaf, with a divisible and an
    indivisible slot axis, a page axis 'model' divides and one it does not
    (a model axis of 3: dropped, never re-homed), pages sharded or not;
    and the token batch's."""
    jcfg, cfg, _, _ = small_models()
    row = jax.eval_shape(lambda: jsd.init_state(jcfg, 1, 48))
    stacked = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct((slots,) + x.shape, x.dtype), row)
    state = sharding.abstract(sectored_decode.init_state, cfg, slots, 48,
                              device="cpu")
    names = [n for n, _, _ in sharding.slot_leaves(state)]
    assert names == ["k", "v", "length", "table", "position"]
    for mesh in WAVE_MESHES:
        for shard_pages in (True, False):
            jspecs = ref_leaves(jsharding.wave_state_shardings(
                mesh, stacked, shard_pages=shard_pages))
            pspecs = sharding.wave_state_shardings(
                mesh, state, shard_pages=shard_pages)
            for (name, t, axis), a, b, x in zip(
                    sharding.slot_leaves(state), jspecs, pspecs,
                    jax.tree_util.tree_leaves(stacked)):
                want = _ref_to_port(name, norm(a, x.ndim), axis)
                assert want == norm(b, t.ndim), (mesh.devices.shape, name)
            if mesh.devices.shape == (2, 3) and shard_pages:
                assert "model" not in sharding.spec_axes(pspecs[0])
        for shape in ((slots, 1, 1), None):
            assert (norm(jsharding.wave_token_sharding(mesh, shape), 3)
                    == norm(sharding.wave_token_sharding(mesh, shape), 3))


@settings(max_examples=60, deadline=None)
@given(
    st.lists(st.sampled_from([64, 128, 10, 4, 1, 7, 4096]), min_size=1,
             max_size=4),
    st.lists(st.sampled_from([None, "data", "model", ("data", "model")]),
             min_size=0, max_size=4),
    st.sampled_from([(16, 16), (4, 2), (2, 3)]),
)
def test_fix_spec_and_drop_indivisible_match_reference(shape, axes, mshape):
    """Both repairs give the reference's spec, and every kept axis
    divides its dim (tests/test_sharding.py's property, on the port)."""
    mesh = FakeMesh(mshape)
    sizes = dict(zip(mesh.axis_names, mshape))
    jspec = jax.sharding.PartitionSpec(*axes)
    pspec = sharding.P(*axes)
    n = len(shape)
    fixed = sharding.fix_spec(pspec, tuple(shape), mesh)
    assert norm(fixed, n) == norm(jsharding.fix_spec(jspec, tuple(shape),
                                                     mesh), n)
    dropped, lost = sharding.drop_indivisible(pspec, tuple(shape), mesh)
    jdropped, jlost = jsharding.drop_indivisible(jspec, tuple(shape), mesh)
    assert norm(dropped, n) == norm(jdropped, n) and lost == jlost
    for dim, entry in zip(shape, norm(fixed, n)):
        assert dim % int(np.prod([sizes[a] for a in entry or ()])) == 0


def test_fix_spec_moves_model_to_contraction_dim():
    # GQA: kv heads (4) < TP (16) -> model moves to the 4096 input dim
    fixed = sharding.fix_spec(sharding.P(None, "model", None),
                              (4096, 4, 128), FakeMesh((16, 16)))
    assert tuple(fixed) == ("model", None, None)


def test_step_factories_match_reference(bare_specs):
    """``make_sectored_decode_step``, ``make_decode_step`` and
    ``make_prefill_step`` return the reference's specs (yi-6b at full
    width on the production mesh shape, and long-context)."""
    jcfg, cfg = jconfigs.get("yi-6b"), configs.get("yi-6b")
    mesh = FakeMesh((16, 16))
    for long_context in (False, True):
        jfn, (jp, js, jt), jshape = jsd.make_sectored_decode_step(
            jcfg, mesh, batch=4, seq_len=2048, long_context=long_context)
        fn, (pp, ps, pt), pshape = sectored_decode.make_sectored_decode_step(
            cfg, mesh, batch=4, seq_len=2048, long_context=long_context)
        assert_same_specs(js, jshape, ps, pshape)
        assert norm(jt, 2) == norm(pt, 2)
        jfn, (jp2, js2, jt2), jshape2 = jstep.make_decode_step(
            jcfg, mesh, batch=4, seq_len=2048, long_context=long_context)
        fn2, (pp2, ps2, pt2), pshape2 = pstep.make_decode_step(
            cfg, mesh, batch=4, seq_len=2048, long_context=long_context)
        assert_same_specs(js2, jshape2, ps2, pshape2)
        assert norm(jt2, 2) == norm(pt2, 2)
    jshapes = jax.eval_shape(lambda: jmodel.init_params(jcfg,
                                                        jax.random.key(0)))
    pshapes = sharding.abstract(model.init_params, cfg, device="cpu")
    assert_same_specs(jp, jshapes, pp, pshapes)
    _, (jpp, jtt) = jstep.make_prefill_step(jcfg, mesh)
    _, (ppp, ptt) = pstep.make_prefill_step(cfg, mesh)
    assert_same_specs(jpp, jshapes, ppp, pshapes)
    assert norm(jtt, 2) == norm(ptt, 2)


# -- mesh construction --------------------------------------------------------


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A one-rank gloo process group for the in-process meshes."""
    if dist.is_initialized():
        yield
        return
    store = str(tmp_path_factory.mktemp("store") / "store")
    dist.init_process_group("gloo", store=dist.FileStore(store, 1), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def test_mesh_parse_and_validation(one_rank):
    assert mesh_mod.parse_mesh_shape("4x2") == ((4, 2), ("data", "model"))
    assert mesh_mod.parse_mesh_shape("2") == ((2,), ("data",))
    for bad in ("4x2x1", "abc", "0x2"):
        with pytest.raises(ValueError, match="mesh spec") as got:
            mesh_mod.parse_mesh_shape(bad)
        with pytest.raises(ValueError) as want:
            jmesh.parse_mesh_shape(bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="devices") as got:
        mesh_mod.make_serving_mesh("16", device="cpu")
    msg = str(got.value)
    assert msg.startswith("mesh '16' needs 16 devices, host has 1 (")
    assert "torchrun --nproc-per-node 16" in msg
    # an NCCL mesh never falls back to the gloo group this process holds
    with pytest.raises(RuntimeError):
        mesh_mod.init_process_group("cuda")
    mesh = mesh_mod.make_serving_mesh("1x1", device="cpu")
    assert sharding.mesh_axes(mesh) == {"data": 1, "model": 1}
    assert sharding.mesh_coords(mesh) == {"data": 0, "model": 0}


# -- the (1,) anchor ----------------------------------------------------------


ANCHOR_CASES = {
    "greedy-fifo": dict(scheduler="fifo", n_requests=6),
    "greedy-overlap": dict(scheduler="overlap", n_requests=6),
    "sampled-fifo": dict(scheduler="fifo", n_requests=6, sampled=True),
    "sampled-overlap": dict(scheduler="overlap", n_requests=6,
                            sampled=True),
    # held to the dispatch sessions (the reference's fused oracle); the
    # 140-token prompts span two pages, so the narrow fused step engages
    "fused-fifo": dict(scheduler="fifo", kernel="fused", n_requests=5,
                       max_batch=4, seq_len=384, prompt_len=140),
    "fused-overlap": dict(scheduler="overlap", kernel="fused", n_requests=5,
                          max_batch=4, seq_len=384, prompt_len=140),
}


def _jsampler(rid):
    spec = ranks.sampler_for(rid)
    return None if spec is None else JSamplerSpec(
        temperature=spec.temperature, top_k=spec.top_k, top_p=spec.top_p,
        seed=spec.seed)


def _ref_run(jcfg, jparams, *, scheduler, n_requests, max_batch=8,
             max_new_tokens=5, seed=3, sampled=False, seq_len=48,
             prompt_len=6, **_):
    """The reference's ``(1,)`` MeshBackend session (dispatch attend: its
    oracle holds fused to dispatch)."""
    inner = jsd.make_serving_fns(jcfg, params=jparams, seq_len=seq_len,
                                 kernel="dispatch")
    backend = JMeshBackend(JMeteredBackend(inner),
                           jmesh.make_serving_mesh("1"))
    sched = JOverlap() if scheduler == "overlap" else JFifo()
    sess = JServeSession(backend, max_batch=max_batch, scheduler=sched,
                         policy=JAlwaysSectored())
    rng = np.random.default_rng(seed)
    handles = [sess.submit(JRequest(
        rid, rng.integers(0, jcfg.vocab, size=prompt_len).astype(np.int32),
        max_new_tokens=max_new_tokens,
        sampler=_jsampler(rid) if sampled else None))
        for rid in range(n_requests)]
    sess.run_until_drained()
    return ({h.rid: tuple(h.peek()) for h in handles},
            {h.rid: h.energy_j for h in handles}, sess)


@pytest.fixture(scope="module")
def models():
    return small_models()


# the port's bf16 logits differ from the reference's by up to 0.004 at
# this width (tests/test_torch_serve.py: LOGIT_TOL); a greedy stream may
# part from the reference's only where the port's top-2 margin is inside it
LOGIT_TOL = 0.02


def _near_tie(cfg, params, seq_len, prompt, got, want) -> bool:
    """Where two streams of one request first part, the port's logits of
    that position (an exact prefill over the prompt and the tokens
    before it) have the two tokens as their top 2, within LOGIT_TOL."""
    p = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    backend = sectored_decode.make_serving_fns(cfg, params=params,
                                               seq_len=seq_len, device="cpu")
    ctx = np.concatenate([prompt, np.asarray(got[:p], np.int32)])
    row = backend.prefill_fn(ctx[None])[0][0].float()
    top = torch.topk(row, 2)
    return (set(top.indices.tolist()) == {got[p], want[p]}
            and float(top.values[0] - top.values[1]) < LOGIT_TOL)


@pytest.mark.parametrize("case", list(ANCHOR_CASES))
def test_one_rank_mesh_matches_unmeshed_and_reference(one_rank, models,
                                                      case):
    """The oracle's anchor: a ``(1,)`` mesh and ``1x1``, whose page
    gather runs over a one-rank 'model' group (the fused cases, the
    slowest, take ``1x1`` only), reproduce the unmeshed
    port bitwise in tokens, logprobs, per-request joules and stats, and
    the reference's ``(1,)`` MeshBackend session bitwise in per-request
    joules and in every token stream but one that parts at a near tie of
    the port's logits (the port's logits are not the reference's bits)."""
    jcfg, cfg, jparams, params = models
    kw = ANCHOR_CASES[case]
    plain = dict(kw, kernel="dispatch")
    unmeshed = ranks.run_session(cfg, params, **plain)
    ref_tokens, ref_joules, jsess = _ref_run(jcfg, jparams, **kw)
    assert jsess.meter.mesh_shape == (1,)
    assert unmeshed["joules"] == ref_joules
    parted = [rid for rid in ref_tokens
              if unmeshed["tokens"][rid] != ref_tokens[rid]]
    assert len(parted) <= 1, parted
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, size=kw.get("prompt_len", 6))
               .astype(np.int32) for _ in ref_tokens]
    for rid in parted:
        assert _near_tie(cfg, params, kw.get("seq_len", 48), prompts[rid],
                         unmeshed["tokens"][rid], ref_tokens[rid]), rid
    meshes = (("1", (1,)), ("1x1", (1, 1)))
    for spec, shape in meshes[1:] if "fused" in case else meshes:
        mesh = mesh_mod.make_serving_mesh(spec, device="cpu")
        got = ranks.run_session(cfg, params, mesh=mesh, **kw)
        assert got["done"] and got["mesh_shape"] == shape
        assert got["tokens"] == unmeshed["tokens"]
        assert got["joules"] == unmeshed["joules"] == ref_joules
        assert got["logprobs"] == unmeshed["logprobs"]
        assert got["stats"] == unmeshed["stats"]
        assert got["donor_rank"] == 0 and got["prefills"] > 0
    if kw["scheduler"] == "overlap" and kw["n_requests"] > kw.get(
            "max_batch", 8):
        assert unmeshed["stats"]["overlapped_prefills"] >= 1


def test_mesh_backend_is_transparent_decorator(one_rank, models):
    """Protocol surface passes through in both composition orders; page
    sharding turns on for the gather-based backend only."""
    _, cfg, _, params = models
    inner = sectored_decode.make_serving_fns(cfg, params=params, seq_len=48,
                                             device="cpu")
    mesh = mesh_mod.make_serving_mesh("1", device="cpu")
    meshed = MeshBackend(MeteredBackend(inner), mesh)
    metered = MeteredBackend(MeshBackend(inner, mesh))
    for backend in (meshed, metered):
        assert backend.supports_sectored
        assert backend.k_for(1.0) == inner.k_for(1.0)
        assert backend.decode_fn is inner.decode_fn
        assert backend.sectored_fn_for(None) is inner.sectored_fn
        assert backend.mesh_shape == (1,)
        # the session that drives the waves stamps the meter
        assert ServeSession(backend, max_batch=2).meter.mesh_shape == (1,)
    # ... and clears the stamp when the same meter is reused unmeshed
    assert ServeSession(meshed.inner, max_batch=2).meter.mesh_shape is None
    assert MeshBackend(inner, mesh).shard_pages is True
    assert MeshBackend(MeteredBackend(inner), mesh).shard_pages is True
    dense = ServingBackend(lambda t: None, lambda s, t: None)
    assert MeshBackend(dense, mesh).shard_pages is False
    # MeteredBackend always HAS k_for but answers None over a dense
    # backend: the probe calls it, so a dense attend is never page-sharded
    metered_dense = MeteredBackend(dense, geometry=KVGeometry(
        page_size=4, total_pages=8, page_kv_bytes=512.0, n_layers=2))
    assert MeshBackend(metered_dense, mesh).shard_pages is False
    with pytest.raises(ValueError, match="fuse_wave"):
        ServeSession(meshed, max_batch=2, fuse_wave=False)


def test_build_session_and_cli_mesh(one_rank, models, capsys):
    """``build_session(mesh=)`` takes a spec or a mesh and refuses the
    looped wave; ``--mesh 1x1`` runs the CLI and tags its stats line."""
    _, cfg, _, params = models
    sess = launch_serve.build_session(cfg, params, true_sectored=True,
                                      seq_len=48, mesh="1", device="cpu")
    assert isinstance(sess.backend, MeshBackend) and sess.mesh is not None
    with pytest.raises(ValueError, match="vectorized"):
        launch_serve.build_session(cfg, params, true_sectored=True,
                                   seq_len=48, mesh="1", vectorized=False,
                                   device="cpu")
    argv = ["--arch", "yi-6b", "--reduced", "--requests", "3",
            "--max-new-tokens", "3", "--true-sectored", "--fused-kernel",
            "--policy", "sectored", "--telemetry", "--device", "cpu"]
    plain = launch_serve.main(argv)
    plain_out = capsys.readouterr().out
    meshed = launch_serve.main(argv + ["--mesh", "1x1"])
    out = capsys.readouterr().out
    assert meshed == plain
    assert "mesh=1x1 completed=3" in out
    # the energy table is the unmeshed run's (but for its wall clock)
    def table(text):
        return re.sub(r"wall=[0-9.]+s", "", text.split("-- telemetry")[1])
    assert table(out) == table(plain_out)


# -- restore onto a mesh ------------------------------------------------------


def test_restore_reshards_onto_two_ranks(models):
    """Save on one rank, restore on two: each rank's leaves are its block
    of the stored global arrays, by ``param_shardings`` over a model-split
    and an fsdp data-split mesh; a one-rank mesh in a two-rank group is
    refused."""
    _, cfg, _, params = models
    tree = dict(params=params, step=torch.tensor(5, dtype=torch.int32))
    with tempfile.TemporaryDirectory() as d:
        manager.save(d, 7, tree)
        # without a mesh: the whole tree as written, a scalar kept 0-d
        whole, step = manager.restore(manager.latest(d), tree, device="cpu")
        assert step == 7 and whole["step"].shape == ()
        assert all(torch.equal(a, b) for a, b in zip(leaves(whole),
                                                     leaves(tree)))
        got = ranks.spawn_restore(d, timeout=120)
    for rank, res in enumerate(got):
        assert res["too_small"].startswith("mesh '1' covers 1 of the 2")
        for spec, fsdp in (("1x2", False), ("2x1", True)):
            step, local = res[spec]
            assert step == 7
            shape, axes = mesh_mod.parse_mesh_shape(spec)
            mesh = sharding.MeshShape(shape, axes)
            specs = dict(params=sharding.param_shardings(mesh, params,
                                                         fsdp=fsdp),
                         step=sharding.P())
            coords = dict(zip(axes, np.unravel_index(rank, shape)))
            split = False
            for t, s, mine in zip(leaves(tree),
                                  sharding.spec_leaves(specs), local):
                want = (t[sharding.local_slice(s, tuple(t.shape), mesh,
                                               coords)] if t.ndim else t)
                assert mine.dtype == t.dtype and mine.ndim == t.ndim
                assert torch.equal(mine, want)
                split |= mine.shape != t.shape
            assert split
