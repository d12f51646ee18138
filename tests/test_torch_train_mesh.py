"""The port's training step over a device mesh (``make_train_step(cfg,
mesh, fsdp=)``), multi-rank on gloo, against the unmeshed step and the
JAX reference.

One spawn per world size (2 ranks for (2, 1) and (1, 2), 4 for (2, 2))
runs every case (``tests/_torch_train_ranks.py``) for 2 steps at a tiny
reduced config; this process runs the unmeshed steps and compares:

* one rank (``1``, ``1x1``, fsdp off and on, with and without the int8
  error feedback): the meshed step is bitwise the unmeshed step
  (parameters, optimizer state with ``ef``, loss), in process;
* ``D = 2`` data ranks and one 'model' rank ((2, 1)) are bitwise the
  unmeshed step with ``microbatch = 2`` where the clip factor is 1.0,
  with and without fsdp and compression, for a uniform stack, a hybrid's
  list of layers and a MoE stack;
* a 'model' axis of 2 ranks ((1, 2), (2, 2)) runs the partitioned
  program (``parallel/tensor.py``): its split contractions sum in
  another order than the unsplit products, as the reference's
  partitioned program does, so it is held to the split program's
  contract (:func:`assert_split_contract`): every rank the same bits,
  the same bits from run to run, and within stated tolerances of the
  unmeshed step with ``microbatch = D`` (SPLIT_LOSS_TOL,
  SPLIT_UPDATE_TOL on each parameter's update, SPLIT_MOMENT_TOL);
* with the clip active: bitwise without sharded storage ((2, 1), fsdp
  off); with fsdp the global norm sums the shards in another order, so
  the moments are held within CLIP_MOMENT_TOL of their largest magnitude
  (measured: 0) and the parameters bitwise (measured: every leaf bitwise
  at these sizes; two AdamW steps at lr 1e-3 move a parameter by ~2e-3
  at most, so only bitwise tells a skipped update apart. A norm that
  rounds the other way in its last bit could flip a parameter's
  rounding and fail this: the order-of-sum caveat); with 'model'
  splitting the products, the split program's contract;
* the reference's ``make_train_step(cfg, mesh)`` jitted with its own
  shardings on a one-device (1, 1) mesh with ``microbatch = 2`` against
  the port's (2, 1) step: loss and gradients within REF_TOL (f32 witness
  and bf16), and the spec trees equal the reference's, spec for spec;
* a checkpoint saved at (2, 1) with fsdp is byte-equal to the unmeshed
  (``microbatch = 2``) save (the storage does not change); restored
  unmeshed it continues bitwise, and at (1, 2) (the partitioned
  program) the same bits on both ranks, within the split program's
  tolerances;
* ``loop.rank_rows``: a rank's rows are its rows of the global batch;
* under fsdp with remat each layer is gathered inside its remat region:
  once for the forward and again for the recompute (ZeRO-3).
"""

import dataclasses
import filecmp
import os
import shutil
import tempfile

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_train_ranks as ranks
from _torch_port import f32, to_jax
from _torch_port import one_torch_thread  # noqa: F401  (autouse)
from repro import configs as jconfigs
from repro.launch import mesh as jmesh
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.parallel import sharding as jsharding
from repro.train import step as jstep
from repro_torch import bridge, configs
from repro_torch.checkpoint import manager
from repro_torch.data import pipeline
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import model
from repro_torch.optim import adamw
from repro_torch.parallel import comm, sharding
from repro_torch.runtime.graphs import leaves
from repro_torch.train import loop
from repro_torch.train import step as train_step

SPECS = [spec for world in (2, 4) for spec in ranks.MESHES[world]]
EXACT = [c for c, (_, _, _, clip) in ranks.CASES.items()
         if clip == ranks.NO_CLIP]
CLIPPED = [c for c, (_, _, _, clip) in ranks.CASES.items()
           if clip != ranks.NO_CLIP]
CLIP_MOMENT_TOL = 1e-5
#: 'model' of 2 ranks against the unmeshed step: the losses (measured: at
#: most 3.5e-3, the MoE stack at (1, 2), where a rounding flips an
#: expert's routing; 6.7e-4 elsewhere)
SPLIT_LOSS_TOL = 5e-3
#: ... and each moment leaf's rms gap over its rms (measured: at most
#: 0.12)
SPLIT_MOMENT_TOL = 0.25
#: ... and each parameter leaf's update (final minus start): the rms of
#: its gap to the unmeshed update over the rms of the unmeshed update
#: (measured: at most 0.175, the MoE stack at (1, 2); 0.06–0.13
#: elsewhere). With the AdamW update skipped on the leaves whose spec
#: names 'model' every (1, 2) and (2, 2) case reads 1.00, with its sign
#: flipped 1.98–2.01
SPLIT_UPDATE_TOL = 0.5
#: the training parity tolerances (tests/test_torch_train_grads.py): loss,
#: and the gradient's largest error over its largest magnitude
REF_TOL = {"float32": (2e-6, 2e-6), "bfloat16": (2e-3, 0.05)}


def bits(t: torch.Tensor) -> np.ndarray:
    return bridge.tensor_to_numpy_bits(t.reshape(-1))


def assert_bitwise(a: list, b: list):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(bits(x), bits(y))


def data_size(spec: str) -> int:
    return mesh_mod.parse_mesh_shape(spec)[0][0]


def n_params(case: str) -> int:
    cfg = ranks.tiny_cfg(ranks.CASES[case][0])
    return len(list(leaves(model.init_params(cfg, seed=0, device="cpu"))))


def _rms(t: torch.Tensor) -> float:
    return float(t.pow(2).mean().sqrt())


def assert_split_contract(case: str, losses: list, state: list, got: list,
                          again: list | None = None,
                          start: list | None = None) -> None:
    """The partitioned program's contract for 'model' of two or more
    ranks: ``got`` (every rank's losses and global state) the same bits
    on every rank and as ``again`` (a second run); against the unmeshed
    run's ``losses`` and ``state`` (its leaves: the optimizer's ``ef``
    with compression, ``mu``, ``nu``, ``step``, then the parameters),
    the losses within SPLIT_LOSS_TOL, each parameter's update from
    ``start`` (the parameters both runs began from; seed 0 by default)
    within SPLIT_UPDATE_TOL of the unmeshed update, each moment within
    SPLIT_MOMENT_TOL (rms). The error feedback holds each gradient's
    int8 rounding residual, which a gradient moved by rounding moves by
    up to a quantization level: it is held to the bit contracts only."""
    for r in got[1:] + (again or []):
        assert_bitwise(got[0]["losses"], r["losses"])
        assert_bitwise(got[0]["state"], r["state"])
    mine = got[0]
    gap = max(abs(float(a) - float(b)) for a, b in zip(losses,
                                                        mine["losses"]))
    assert gap <= SPLIT_LOSS_TOL, gap
    n = n_params(case)
    arch, _, compress, _ = ranks.CASES[case]
    first = n if compress else 0
    if start is None:
        start = list(leaves(model.init_params(ranks.tiny_cfg(arch), seed=0,
                                              device="cpu")))
    updates = 0.0
    for p0, a, b in zip(start, state[-n:], mine["state"][-n:], strict=True):
        p0, a, b = p0.double(), a.double(), b.double()
        moved = _rms(a - p0)
        if moved:
            updates = max(updates, _rms(b - a) / moved)
        else:  # the unmeshed update rounds away: so must the split one
            assert bool((b == a).all())
    assert updates <= SPLIT_UPDATE_TOL, updates
    worst = 0.0
    for a, b in zip(state[first:first + 2 * n],
                    mine["state"][first:first + 2 * n]):
        a, b = a.double(), b.double()
        rms = _rms(a) or 1.0
        worst = max(worst, _rms(a - b) / rms)
    assert worst <= SPLIT_MOMENT_TOL, worst
    print(f"{case}: loss gap {gap:.3g}, updates {updates:.3g}, "
          f"moments {worst:.3g}")


def unmeshed(case: str, microbatch: int, steps: int = ranks.STEPS):
    """(losses, final state leaves, first step's unclipped grad norm) of
    the unmeshed step."""
    arch, _, compress, clip = ranks.CASES[case]
    cfg = ranks.tiny_cfg(arch)
    ocfg = ranks.opt_cfg(compress, clip)
    params = model.init_params(cfg, seed=0, device="cpu")
    fn, _, _ = train_step.make_train_step(cfg, opt_cfg=ocfg,
                                          microbatch=microbatch)
    b = ranks.batch(0)
    _, g = train_step.value_and_grad(params, cfg, b["tokens"], b["labels"])
    gnorm = float(adamw.global_norm(g))
    p, o, losses = params, adamw.init_state(params, ocfg), []
    for step in range(steps):
        p, o, m = fn(p, o, ranks.batch(step))
        losses.append(m["loss"])
    return losses, list(leaves(dict(params=p, opt=o))), gnorm


@pytest.fixture(scope="module")
def meshed():
    """(spec, case) -> every rank's result."""
    out = {}
    for world in (2, 4):
        with tempfile.TemporaryDirectory() as d:
            per_rank = ranks.spawn_train(world, d, timeout=300)
            for key in per_rank[0]:
                out[key] = [r[key] for r in per_rank]
            if world == 2:  # keep the (2, 1) run's checkpoints
                keep = tempfile.mkdtemp()
                shutil.copytree(os.path.join(d, "ckpt_a"),
                                os.path.join(keep, "ckpt_a"))
                out["ckpt_a"] = os.path.join(keep, "ckpt_a")
    yield out
    shutil.rmtree(os.path.dirname(out["ckpt_a"]), ignore_errors=True)


# -- one rank, in process ------------------------------------------------------


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


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("spec", ["1", "1x1"])
def test_one_rank_is_bitwise_unmeshed(one_rank, spec, fsdp, compress):
    case = {(False, False): "plain", (True, False): "fsdp",
            (False, True): "compress", (True, True): "fsdp-compress"}[
        (fsdp, compress)]
    losses, state, _ = unmeshed(case, 1)
    mesh = mesh_mod.make_serving_mesh(spec, device="cpu")
    got = ranks.run_case(mesh, case)
    assert_bitwise(losses, got["losses"])
    assert_bitwise(state, got["state"])
    assert got["first"]["calls"] == 0  # a one-rank mesh runs no collective


def test_unmeshed_step_returns_reference_triple():
    """``make_train_step(cfg)`` returns ``(fn, in_specs, out_specs)``
    over a one-device mesh; the step carries no mesh."""
    cfg = ranks.tiny_cfg()
    fn, ins, outs = train_step.make_train_step(cfg)
    assert fn.mesh is None and fn.in_specs is ins
    assert len(ins) == 3 and set(ins[2]) == {"tokens", "labels"}
    assert set(ins[1]) == {"mu", "nu", "step"} and ins[1]["step"] == ()
    assert outs[0] is ins[0] and outs[2] == ()


def test_fsdp_gathers_each_layer_again_for_the_recompute(one_rank,
                                                         monkeypatch):
    """ZeRO-3: with remat every layer leaf is gathered twice a step (the
    forward, then the recompute inside its checkpointed region), the
    leaves outside the layers once; without remat once."""
    cfg = ranks.tiny_cfg()
    params = model.init_params(cfg, seed=0, device="cpu")
    mesh = mesh_mod.make_serving_mesh("1x1", device="cpu")
    calls = []
    real = comm.gather_param
    monkeypatch.setattr(comm, "gather_param",
                        lambda t, *a: calls.append(a[-1]) or real(t, *a))
    n_top = len(train_step.layer_slots(params, cfg.n_layers)[0])
    n_layer = len(list(leaves(params["layers"])))
    for remat, per_layer in ((True, 2), (False, 1)):
        calls.clear()
        ocfg = adamw.AdamWConfig()
        fn, ins, _ = train_step.make_train_step(cfg, mesh, opt_cfg=ocfg,
                                                fsdp=True, remat=remat)
        fn(params, adamw.init_state(params, ocfg), ranks.batch(0))
        whole = [k for k in calls if k[1] is None]
        layered = [k for k in calls if k[1] is not None]
        split = n_top + n_layer - len(set(whole)) - len(
            {k[0] for k in layered})
        assert split == 0
        assert len(layered) == per_layer * cfg.n_layers * (
            n_layer - (len(set(whole)) - n_top))
        assert len(whole) == len(set(whole))


# -- multi-rank ---------------------------------------------------------------


@pytest.mark.parametrize("case", EXACT)
@pytest.mark.parametrize("spec", SPECS)
def test_data_ranks_equal_microbatches(meshed, spec, case):
    """D data ranks == the unmeshed step with microbatch = D, bit for bit,
    on every rank, where 'model' is one rank; where it splits the
    products, the split program's contract against the same step."""
    losses, state, _ = unmeshed(case, data_size(spec))
    if ranks.splits_model(spec):
        assert_split_contract(case, losses, state, meshed[(spec, case)],
                              meshed[(spec, case, "again")])
        return
    for rank, got in enumerate(meshed[(spec, case)]):
        assert_bitwise(losses, got["losses"])
        assert_bitwise(state, got["state"])


@pytest.mark.parametrize("case", CLIPPED)
@pytest.mark.parametrize("spec", SPECS)
def test_clipped_step(meshed, spec, case):
    """The clip is active (norm > grad_clip); bitwise without sharded
    storage; with fsdp the parameters bitwise and the moments within
    tolerance (the measured gap is printed); where 'model' splits the
    products, the split program's contract."""
    losses, state, gnorm = unmeshed(case, data_size(spec))
    assert gnorm > ranks.CASES[case][3]
    if ranks.splits_model(spec):
        assert_split_contract(case, losses, state, meshed[(spec, case)],
                              meshed[(spec, case, "again")])
        return
    sharded = ranks.CASES[case][1]
    for got in meshed[(spec, case)]:
        assert_bitwise(losses, got["losses"])
        if not sharded:
            assert_bitwise(state, got["state"])
            continue
        # leaves: mu (n), nu (n), step, then the parameters (n)
        n = (len(state) - 1) // 3
        assert_bitwise(state[2 * n:], got["state"][2 * n:])
        gap = 0.0
        for i, (a, b) in enumerate(zip(state[:2 * n], got["state"][:2 * n])):
            d = float((a.float() - b.float()).abs().max())
            scale = float(a.float().abs().max()) or 1.0
            assert d <= CLIP_MOMENT_TOL * scale, (i, d)
            gap = max(gap, d / scale)
        print(f"{spec} {case}: largest gap {gap:.3g}")


@pytest.mark.parametrize("spec", SPECS)
def test_blocks_follow_the_specs(meshed, spec):
    """Each rank holds its block of every parameter under the rules
    (fsdp splits rows over 'data', 'model' splits its dims), so the
    storage is really sharded."""
    shape, axes = mesh_mod.parse_mesh_shape(spec)
    mesh = sharding.MeshShape(shape, axes)
    cfg = ranks.tiny_cfg()
    glob = list(leaves(model.init_params(cfg, seed=0, device="cpu")))
    specs = list(sharding.spec_leaves(sharding.param_shardings(
        mesh, model.init_params(cfg, seed=0, device="cpu"), fsdp=True)))
    world = len(meshed[(spec, "fsdp")])
    split = 0
    for rank, got in enumerate(meshed[(spec, "fsdp")]):
        coords = dict(zip(axes, np.unravel_index(rank, shape)))
        for t, s, local in zip(glob, specs, got["local_shapes"]):
            want = t[sharding.local_slice(s, tuple(t.shape), mesh,
                                          coords)].shape
            assert tuple(want) == local
            split += tuple(t.shape) != local
    assert split >= world


def _norm(spec) -> tuple:
    """A spec of either package: each entry None or a tuple of axes."""
    return tuple(None if e is None else (e if isinstance(e, tuple) else (e,))
                 for e in spec)


def test_reference_spec_trees(monkeypatch):
    """``make_train_step``'s in/out specs equal the reference's, spec for
    spec (yi-6b at full width on (16, 16) and a tiny (2, 2); fsdp and
    compression on and off)."""
    monkeypatch.setattr(jstep, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jsharding, "NamedSharding", lambda mesh, spec: spec)

    class FakeMesh:
        def __init__(self, shape):
            self.axis_names = ("data", "model")
            self.devices = np.zeros(shape)
            self.shape = dict(zip(self.axis_names, shape))

    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
    for arch, shape in (("yi-6b", (16, 16)), ("qwen3-moe-235b-a22b", (2, 2))):
        jcfg, cfg = jconfigs.get(arch), configs.get(arch)
        for fsdp in (False, True):
            for compress in (False, True):
                _, jin, jout = jstep.make_train_step(
                    jcfg, FakeMesh(shape), fsdp=fsdp,
                    opt_cfg=jadamw.AdamWConfig(compress_grads=compress))
                _, pin, pout = train_step.make_train_step(
                    cfg, sharding.MeshShape(shape, ("data", "model")),
                    fsdp=fsdp,
                    opt_cfg=adamw.AdamWConfig(compress_grads=compress))
                jl = jax.tree_util.tree_leaves((jin, jout), is_leaf=is_spec)
                pl = list(sharding.spec_leaves((pin, pout)))
                assert len(jl) == len(pl)
                for a, b in zip(jl, pl):
                    assert _norm(a) == _norm(b), (a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_data_ranks_match_reference(meshed, dtype):
    """The port's (2, 1) step against the reference's step at
    microbatch 2 on a one-device (1, 1) mesh, jitted with its own
    shardings: loss and gradients within REF_TOL, the new moments too."""
    loss_tol, grad_tol = REF_TOL[dtype]
    jcfg = jconfigs.get("yi-6b").reduced(**ranks.TINY, dtype=dtype)
    cfg = ranks.tiny_cfg(dtype=dtype)
    params = to_jax(model.init_params(cfg, seed=0, device="cpu"))
    b = {k: np.asarray(v) for k, v in ranks.batch(1).items()}
    mesh = jmesh.make_mesh((1, 1), ("data", "model"))
    ocfg = jadamw.AdamWConfig(lr=1e-3)
    fn, ins, outs = jstep.make_train_step(jcfg, mesh, opt_cfg=ocfg,
                                          microbatch=2)
    _, jo, jm = jax.jit(fn, in_shardings=ins, out_shardings=outs)(
        params, jadamw.init_state(params, ocfg), b)
    vg = jax.jit(jax.value_and_grad(
        lambda p, t, l: jmodel.lm_loss(p, jcfg, t, l)))
    halves = [vg(params, b["tokens"][2 * i:2 * i + 2],
                 b["labels"][2 * i:2 * i + 2]) for i in range(2)]
    jgrads = [(f32(x) + f32(y)) / 2 for x, y in zip(
        jax.tree.leaves(halves[0][1]), jax.tree.leaves(halves[1][1]))]
    gmax = max(np.abs(g).max() for g in jgrads)
    for got in meshed[("2x1", f"ref-{dtype}")]:
        assert abs(float(got["loss"]) - float(jm["loss"])) <= loss_tol
        err = max(np.abs(a - f32(b)).max()
                  for a, b in zip(jgrads, got["grads"]))
        assert err <= grad_tol * gmax, err / gmax
        if dtype == "float32":  # state leaves: mu, nu, step, params
            n = len(got["grads"])
            mom = list(jax.tree.leaves((jo["mu"], jo["nu"])))
            for a, b in zip(mom, got["state"][:2 * n], strict=True):
                a = f32(a)
                assert np.abs(a - f32(b)).max() <= 1e-5 * np.abs(a).max()


def test_checkpoint_from_mesh_and_remesh(meshed, tmp_path):
    """(2, 1) fsdp saves (rank 0) the unmeshed microbatch-2 run's files
    byte for byte; restored unmeshed, the run continues bitwise; restored
    at (1, 2), where the partitioned program runs, it continues with the
    same bits on both ranks, within the split program's tolerances of
    the unmeshed continuation."""
    cfg = ranks.tiny_cfg()
    ocfg = ranks.opt_cfg(False, ranks.NO_CLIP)
    params = model.init_params(cfg, seed=0, device="cpu")
    fn, _, _ = train_step.make_train_step(cfg, opt_cfg=ocfg, microbatch=2)
    run = str(tmp_path / "unmeshed")
    p_a, _, res = loop.run(fn, params, adamw.init_state(params, ocfg),
                         ranks.DATA, loop.LoopConfig(
                             total_steps=ranks.STEPS, checkpoint_every=1,
                             checkpoint_dir=run))
    got = meshed[("2x1", "loop")]
    assert got[0]["losses_a"] == res.losses
    for step in range(1, ranks.STEPS + 1):
        name = f"step_{step:08d}"
        for f in ("shard_0.npz", manager.MANIFEST):
            assert filecmp.cmp(os.path.join(run, name, f),
                               os.path.join(meshed["ckpt_a"], name, f),
                               shallow=False), (name, f)
    start = list(leaves(p_a))
    # restored unmeshed, continued with microbatch 1 (the (1, 2) mesh has
    # one data rank)
    cont = str(tmp_path / "cont")
    shutil.copytree(meshed["ckpt_a"], cont)
    fn1, _, _ = train_step.make_train_step(cfg, opt_cfg=ocfg)
    p, o, res1 = loop.run(fn1, params, adamw.init_state(params, ocfg),
                          ranks.DATA, loop.LoopConfig(
                              total_steps=2 * ranks.STEPS,
                              checkpoint_every=100, checkpoint_dir=cont))
    assert res1.restored_from == ranks.STEPS
    for r in got:
        assert r["restored_from"] == ranks.STEPS
    assert_split_contract(
        "fsdp", res1.losses, list(leaves(dict(params=p, opt=o))),
        [dict(losses=[torch.tensor(x) for x in r["losses_b"]],
              state=r["state"]) for r in got], start=start)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_rank_rows_are_global_rows(n_shards):
    """``loop.rank_rows(batch, shard, n)``, what a meshed loop's rank
    reads, is the shard's rows of the global batch, and the ranks' rows
    together are the global batch; the reference's own shard stream
    (``batch_for(shard=)``) agrees for shard 0 only (its other shards are
    seeded by their index), which is why the loop does not read it."""
    data = pipeline.DataConfig(vocab=1000, seq_len=32, global_batch=8,
                               seed=2)
    for step in (0, 5):
        st = pipeline.PipelineState(step)
        full = pipeline.batch_for(data, st, device="cpu")
        rows = data.global_batch // n_shards
        got = [loop.rank_rows(full, shard, n_shards)
               for shard in range(n_shards)]
        for key in ("tokens", "labels"):
            for shard in range(n_shards):
                assert got[shard][key].shape == (rows, data.seq_len)
            assert torch.equal(torch.cat([g[key] for g in got]), full[key])
        stream = pipeline.batch_for(data, st, 0, n_shards, device="cpu")
        assert torch.equal(stream["tokens"], got[0]["tokens"])
        other = pipeline.batch_for(data, st, 1, n_shards, device="cpu")
        assert not torch.equal(other["tokens"], got[1]["tokens"])
