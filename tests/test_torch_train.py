"""The port's training substrate against the JAX reference: parameter
counts, AdamW, the data pipeline, checkpoints, the train step with
microbatches, the fault-tolerant loop and the train CLI
(``launch/train_100m.py`` runs on the card in ``chip_smoke.py``).

* ``param_count`` / ``active_param_count`` equal the reference's for all
  ten configs.
* ``apply_updates`` equals the reference's (called op by op, as its
  tests call it) bit for bit when the global norm is under
  ``grad_clip`` (the clip scale is then exactly 1.0): bf16 and f32
  parameters, f32 and bf16 moments, with and without the int8
  error-feedback compression, over three chained steps, whole and in
  chunks. With clipping the global norm sums in another order: moments
  within CLIP_MOMENT_TOL of their largest magnitude, parameters within
  one bf16 ulp of the reference (measured: 1.8e-6, and every parameter
  equal). ``compress_roundtrip``, ``_compress_int8`` and the
  error-feedback state are bitwise; ``cosine_schedule`` within one f32
  ulp (measured: equal).
* ``make_train_step(microbatch=2)`` against the reference's step at
  microbatch 2 (f32 witness): loss within 1e-6 and the new moments within
  1e-5 of their largest magnitude, parameters within MB_PARAM_TOL
  (measured 0, 2.3e-6 and 5.4e-6).
* ``batch_for`` gives the reference's tokens and labels bitwise, shards
  included.
* checkpoints cross-read both ways bitwise (a uniform stack and a
  hybrid's list of layers, with the error-feedback state), with the
  reference's manifest; a torn checkpoint is skipped.
* the loop's contracts of the reference's ``tests/test_train.py``, and
  bitwise ones: a restart from the step-3 checkpoint and a run with a
  retried step (raised, non-finite loss, or past its deadline) give the
  uninterrupted run's losses and final state bit for bit.
* the CLI prints the reference's summary line and its loss decreases.
"""

import dataclasses
import json
import os
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import f32, to_jax
from _torch_port import one_torch_thread  # noqa: F401  (autouse)
from repro import configs as jconfigs
from repro.checkpoint import manager as jmanager
from repro.data import pipeline as jpipeline
from repro.launch import mesh as jmesh
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import bridge, configs
from repro_torch.checkpoint import manager
from repro_torch.data import pipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import model
from repro_torch.optim import adamw
from repro_torch.runtime.graphs import leaves, map_tree
from repro_torch.train import loop
from repro_torch.train import step as train_step

#: the reduced yi-6b of the reference's tests/test_train.py
TINY = dict(n_layers=2, d_model=64, d_ff=128, vocab=128, n_heads=2,
            n_kv_heads=1, head_dim=32)
CLIP_MOMENT_TOL = 1e-5
#: the first step moves each parameter by about lr * sign(g); where |g|
#: is near eps the move follows the gradient's rounding (2 % of lr 1e-3)
MB_PARAM_TOL = 2e-5


def bits(x) -> np.ndarray:
    """Raw bits of a torch tensor or JAX array (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        return bridge.tensor_to_numpy_bits(x.reshape(-1))
    a = np.asarray(x).reshape(-1)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def assert_trees_bitwise(ref, port):
    ref_l, port_l = jax.tree.leaves(ref), list(leaves(port))
    assert len(ref_l) == len(port_l)
    for a, b in zip(ref_l, port_l):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(bits(a), bits(b))


def assert_port_trees_bitwise(a, b):
    la, lb = list(leaves(a)), list(leaves(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(bits(x), bits(y))


def _as(tree, dtype):
    return map_tree(lambda t: t.to(dtype) if t.is_floating_point() else t,
                    tree)


@pytest.fixture(scope="module")
def tiny():
    """(jax cfg, port cfg, port params, reference grads of one batch as
    port tensors, the batch)."""
    jcfg = jconfigs.get("yi-6b").reduced(**TINY)
    cfg = configs.get("yi-6b").reduced(**TINY)
    params = model.init_params(cfg, seed=0, device="cpu")
    data = pipeline.DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8)
    batch = pipeline.batch_for(data, pipeline.PipelineState(0),
                               device="cpu")
    jgrads = jax.jit(jax.grad(lambda p: jmodel.lm_loss(
        p, jcfg, np.asarray(batch["tokens"]),
        np.asarray(batch["labels"]))))(to_jax(params))
    grads = bridge.params_from_numpy(jax.tree.map(np.asarray, jgrads),
                                     device="cpu")
    return jcfg, cfg, params, grads, data


# -- configs -------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_param_counts_match_reference(arch):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.reduced().param_count() == jcfg.reduced().param_count()


# -- AdamW -----------------------------------------------------------------------


OPT_CASES = {
    "bf16": ("bfloat16", dict()),
    "bf16_compressed": ("bfloat16", dict(compress_grads=True)),
    "bf16_moments": ("bfloat16", dict(moment_dtype="bfloat16")),
    "f32_compressed": ("float32", dict(compress_grads=True)),
}


@pytest.mark.parametrize("chunk", [None, 1000], ids=["whole", "chunked"])
@pytest.mark.parametrize("case", list(OPT_CASES))
def test_apply_updates_bitwise_unclipped(tiny, monkeypatch, case, chunk):
    if chunk:
        monkeypatch.setattr(adamw, "CHUNK", chunk)
    _, _, params, grads, _ = tiny
    dtype, kw = OPT_CASES[case]
    params, grads = _as(params, getattr(torch, dtype)), _as(
        grads, getattr(torch, dtype))
    ocfg = adamw.AdamWConfig(lr=1e-3, grad_clip=1e6, **kw)
    jocfg = jadamw.AdamWConfig(lr=1e-3, grad_clip=1e6, **kw)
    p, o = params, adamw.init_state(params, ocfg)
    jp, jo, jg = to_jax(params), jadamw.init_state(to_jax(params), jocfg), \
        to_jax(grads)
    for _ in range(3):
        p, o = adamw.apply_updates(p, grads, o, ocfg)
        jp, jo = jadamw.apply_updates(jp, jg, jo, jocfg)
        assert_trees_bitwise(jp, p)
        assert_trees_bitwise(jo, o)
    assert int(o["step"]) == 3
    assert all(int(x.view(torch.int16).abs().sum()) > 0
               for x in leaves(o.get("ef", {})))


@pytest.mark.parametrize("compress", [False, True])
def test_apply_updates_clipped_close(tiny, compress):
    _, _, params, grads, _ = tiny
    ocfg = adamw.AdamWConfig(lr=1e-3, grad_clip=1e-2,
                             compress_grads=compress)
    jocfg = jadamw.AdamWConfig(lr=1e-3, grad_clip=1e-2,
                               compress_grads=compress)
    assert float(adamw.global_norm(list(leaves(grads)))) > 10 * 1e-2
    p, o = adamw.apply_updates(params, grads, adamw.init_state(params, ocfg),
                               ocfg)
    jp, jo = jadamw.apply_updates(to_jax(params), to_jax(grads),
                                  jadamw.init_state(to_jax(params), jocfg),
                                  jocfg)
    for a, b in zip(jax.tree.leaves((jo["mu"], jo["nu"])),
                    list(leaves(o["mu"])) + list(leaves(o["nu"]))):
        a, b = f32(a), f32(b)
        assert np.abs(a - b).max() <= CLIP_MOMENT_TOL * np.abs(a).max()
    for a, b in zip(jax.tree.leaves(jp), leaves(p)):
        a, b = f32(a), f32(b)
        ulp = np.abs(a) * 2.0 ** -7 + 1e-30
        assert (np.abs(a - b) <= ulp).all()
    if compress:
        assert_trees_bitwise(jo["ef"], o["ef"])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_compress_roundtrip_bitwise(dtype):
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(size=(3, 70, 33)).astype(np.float32)
                         * 1e-3).to(getattr(torch, dtype))
    ef = torch.from_numpy(rng.normal(size=(3, 70, 33)).astype(np.float32)
                          * 1e-5).to(torch.bfloat16)
    g_hat, new_ef = adamw.compress_roundtrip(g, ef)
    jg_hat, jnew_ef = jadamw.compress_roundtrip(to_jax(g), to_jax(ef))
    assert g_hat.dtype == g.dtype and new_ef.dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(g_hat), bits(jg_hat))
    np.testing.assert_array_equal(bits(new_ef), bits(jnew_ef))
    q, scale = adamw._compress_int8(g.float())
    jq, jscale = jadamw._compress_int8(to_jax(g.float()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(bits(scale), bits(jscale))
    np.testing.assert_array_equal(
        bits(adamw._decompress_int8(q, scale)),
        bits(jadamw._decompress_int8(jq, jscale)))


def test_cosine_schedule_matches():
    lr, jlr = adamw.cosine_schedule(3e-4, 10, 100), \
        jadamw.cosine_schedule(3e-4, 10, 100)
    for s in [0, 1, 5, 9, 10, 11, 37, 50, 99, 100, 120]:
        a, b = float(lr(s)), float(jlr(s))
        assert abs(a - b) <= np.spacing(np.float32(max(abs(b), 1e-30)))


# -- the step with microbatches ---------------------------------------------------


def test_microbatch_step_matches_reference(tiny):
    _, _, params, _, data = tiny
    jcfg = jconfigs.get("yi-6b").reduced(**TINY, dtype="float32")
    cfg = configs.get("yi-6b").reduced(**TINY, dtype="float32")
    params = _as(params, torch.float32)
    ocfg = adamw.AdamWConfig(lr=1e-3)
    jocfg = jadamw.AdamWConfig(lr=1e-3)
    batch = pipeline.batch_for(data, pipeline.PipelineState(1), device="cpu")
    jfn, _, _ = jstep.make_train_step(jcfg, jmesh.make_mesh(
        (1, 1), ("data", "model")),
                                      opt_cfg=jocfg, microbatch=2)
    jbatch = {k: np.asarray(v) for k, v in batch.items()}
    jp, jo, jm = jax.jit(jfn)(to_jax(params),
                              jadamw.init_state(to_jax(params), jocfg),
                              jbatch)
    step, _, _ = train_step.make_train_step(cfg, opt_cfg=ocfg,
                                            microbatch=2)
    p, o, m = step(params, adamw.init_state(params, ocfg), batch)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-6
    for a, b in zip(jax.tree.leaves((jo["mu"], jo["nu"])),
                    list(leaves(o["mu"])) + list(leaves(o["nu"]))):
        a, b = f32(a), f32(b)
        assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max()
    for a, b in zip(jax.tree.leaves(jp), leaves(p)):
        assert np.abs(f32(a) - f32(b)).max() <= MB_PARAM_TOL


# -- data pipeline ------------------------------------------------------------


@pytest.mark.parametrize("shard,n_shards", [(0, 1), (0, 2), (1, 2)])
def test_batch_for_bitwise(shard, n_shards):
    cfg = pipeline.DataConfig(vocab=1000, seq_len=64, global_batch=8,
                              seed=5)
    jcfg = jpipeline.DataConfig(vocab=1000, seq_len=64, global_batch=8,
                                seed=5)
    for step in (0, 3, 17):
        b = pipeline.batch_for(cfg, pipeline.PipelineState(step), shard,
                               n_shards, device="cpu")
        jb = jpipeline.batch_for(jcfg, jpipeline.PipelineState(step), shard,
                                 n_shards)
        for key in ("tokens", "labels"):
            assert b[key].dtype == torch.int32
            assert b[key].shape == (8 // n_shards, 64)
            np.testing.assert_array_equal(b[key].numpy(),
                                          np.asarray(jb[key]))
    assert pipeline.advance(pipeline.PipelineState(4)).step == 5


def test_entry_points_default_to_the_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = pipeline.DataConfig(vocab=10, seq_len=8, global_batch=2)
    with pytest.raises(RuntimeError, match="is_available"):
        pipeline.batch_for(cfg, pipeline.PipelineState(0))
    with pytest.raises(RuntimeError, match="is_available"):
        launch_train.main(["--arch", "yi-6b", "--reduced", "--steps", "1",
                           "--checkpoint-dir", str(tmp_path)])


# -- checkpoints ----------------------------------------------------------------


def _trained_state(arch, compress):
    """A port state after one AdamW step (non-zero moments and error
    feedback) on the reduced ``arch``."""
    cfg = configs.get(arch).reduced(d_model=64, d_ff=64, vocab=64,
                                    n_heads=2, head_dim=32)
    params = model.init_params(cfg, seed=2, device="cpu")
    ocfg = adamw.AdamWConfig(compress_grads=compress)
    toks = torch.arange(16, dtype=torch.int32).reshape(2, 8) % cfg.vocab
    step, _, _ = train_step.make_train_step(cfg, opt_cfg=ocfg, remat=False)
    p, o, _ = step(params, adamw.init_state(params, ocfg),
                   dict(tokens=toks, labels=toks))
    return dict(params=p, opt=o)


CKPT_CASES = [("yi-6b", True), ("recurrentgemma-2b", False)]


@pytest.mark.parametrize("arch,compress", CKPT_CASES)
def test_reference_checkpoint_restores_in_port(tmp_path, arch, compress):
    state = _trained_state(arch, compress)
    jstate = to_jax(state)
    path = jmanager.save(str(tmp_path), 7, jstate)
    assert manager.latest(str(tmp_path)) == path
    like = map_tree(torch.zeros_like, state)
    restored, step = manager.restore(path, like, device="cpu")
    assert step == 7
    assert_port_trees_bitwise(state, restored)


@pytest.mark.parametrize("arch,compress", CKPT_CASES)
def test_port_checkpoint_restores_in_reference(tmp_path, arch, compress):
    state = _trained_state(arch, compress)
    jstate = to_jax(state)
    path = manager.save(str(tmp_path / "port"), 7, state)
    jpath = jmanager.save(str(tmp_path / "ref"), 7, jstate)
    assert jmanager.latest(str(tmp_path / "port")) == path
    like = jax.tree.map(jnp.zeros_like, jstate)
    restored, step = jmanager.restore(path, like)
    assert step == 7
    assert_trees_bitwise(restored, state)
    with open(os.path.join(path, manager.MANIFEST)) as f, \
            open(os.path.join(jpath, manager.MANIFEST)) as g:
        assert json.load(f) == json.load(g)
    with np.load(os.path.join(path, "shard_0.npz")) as a, \
            np.load(os.path.join(jpath, "shard_0.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


def test_torn_checkpoint_skipped(tiny, tmp_path):
    _, _, params, _, _ = tiny
    state = dict(params=params, opt=adamw.init_state(
        params, adamw.AdamWConfig()))
    ckdir = str(tmp_path / "ck")
    manager.save(ckdir, 5, state)
    manager.save(ckdir, 10, state)
    os.makedirs(os.path.join(ckdir, "step_00000020.tmp0"))
    # tear the newest checkpoint (simulated mid-write node loss)
    os.remove(os.path.join(ckdir, "step_00000010", "manifest.json"))
    assert manager.latest(ckdir).endswith("step_00000005")
    assert jmanager.latest(ckdir).endswith("step_00000005")
    assert manager.latest(str(tmp_path / "none")) is None


# -- the loop -------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_run(tiny):
    """(params, opt, step, data) of the reference test's loop: lr 3e-3,
    no remat (as its jitted step)."""
    _, cfg, params, _, data = tiny
    ocfg = adamw.AdamWConfig(lr=3e-3)
    step, _, _ = train_step.make_train_step(cfg, opt_cfg=ocfg, remat=False)
    return params, adamw.init_state(params, ocfg), step, data


def test_loss_decreases(tiny_run, tmp_path):
    params, opt, step, data = tiny_run
    lc = loop.LoopConfig(total_steps=30, checkpoint_every=50,
                         checkpoint_dir=str(tmp_path / "ck"))
    _, _, res = loop.run(step, params, opt, data, lc)
    assert np.mean(res.losses[-5:]) < np.mean(res.losses[:5]) - 0.1


def test_checkpoint_restart_resumes(tiny_run, tmp_path):
    params, opt, step, data = tiny_run
    ckdir = str(tmp_path / "ck2")
    lc = loop.LoopConfig(total_steps=10, checkpoint_every=5,
                         checkpoint_dir=ckdir)
    loop.run(step, params, opt, data, lc)
    lc2 = loop.LoopConfig(total_steps=20, checkpoint_every=5,
                          checkpoint_dir=ckdir)
    _, _, res2 = loop.run(step, params, opt, data, lc2)
    assert res2.restored_from == 10
    assert res2.final_step == 20
    assert len(res2.losses) == 10


def test_fault_injection_retries(tiny_run, tmp_path):
    params, opt, step, data = tiny_run
    failures = {"n": 0}

    def injector(step_i, attempt):
        if step_i == 3 and attempt == 0:
            failures["n"] += 1
            raise RuntimeError("injected node failure")

    lc = loop.LoopConfig(total_steps=6, checkpoint_every=100,
                         checkpoint_dir=str(tmp_path / "ck3"))
    _, _, res = loop.run(step, params, opt, data, lc,
                         fail_injector=injector)
    assert failures["n"] == 1
    assert res.retries == 1
    assert res.final_step == 6


def test_restart_and_retry_are_bitwise(tiny_run, tmp_path):
    """6 steps with a checkpoint every 3; a fresh loop from the initial
    state after step 6's checkpoint is gone restores at 3 and ends on the
    same bits; a retried step changes no loss."""
    params, opt, step, data = tiny_run
    ckdir = str(tmp_path / "ck")
    lc = loop.LoopConfig(total_steps=6, checkpoint_every=3,
                         checkpoint_dir=ckdir)
    p1, o1, res1 = loop.run(step, params, opt, data, lc)
    assert sorted(os.listdir(ckdir)) == ["step_00000003", "step_00000006"]
    # the restored final checkpoint is the final state
    last, at = manager.restore(manager.latest(ckdir), dict(params=p1, opt=o1),
                               device="cpu")
    assert at == 6
    assert_port_trees_bitwise(last, dict(params=p1, opt=o1))
    os.rename(os.path.join(ckdir, "step_00000006"),
              os.path.join(tmp_path, "final"))
    p2, o2, res2 = loop.run(step, params, opt, data, lc)
    assert res2.restored_from == 3 and res2.losses == res1.losses[3:]
    assert_port_trees_bitwise(dict(params=p1, opt=o1),
                              dict(params=p2, opt=o2))

    def injector(step_i, attempt):
        if step_i == 1 and attempt == 0:
            raise RuntimeError("injected node failure")

    lc3 = dataclasses.replace(lc, checkpoint_dir=str(tmp_path / "ck3"))
    _, _, res3 = loop.run(step, params, opt, data, lc3,
                          fail_injector=injector)
    assert res3.retries == 1 and res3.losses == res1.losses


@pytest.mark.parametrize("fault", ["nan", "deadline"])
def test_bad_step_is_retried_from_the_last_good_state(tiny_run, tmp_path,
                                                      fault):
    params, opt, step, data = tiny_run
    calls = {"n": 0}

    def flaky(p, o, batch):
        calls["n"] += 1
        out = step(p, o, batch)
        if calls["n"] == 2:  # the second step's first attempt
            if fault == "nan":
                return out[0], out[1], dict(loss=torch.tensor(float("nan")))
            time.sleep(0.3)
        return out

    lc = loop.LoopConfig(total_steps=3, checkpoint_every=100,
                         checkpoint_dir=str(tmp_path / "a"),
                         step_deadline_s=0.25)
    pa, oa, ra = loop.run(flaky, params, opt, data, lc)
    lc_clean = dataclasses.replace(lc, checkpoint_dir=str(tmp_path / "b"),
                                   step_deadline_s=120.0)
    pb, ob, rb = loop.run(step, params, opt, data, lc_clean)
    assert ra.retries == 1 and rb.retries == 0
    assert ra.losses == rb.losses
    assert_port_trees_bitwise(dict(params=pa, opt=oa),
                              dict(params=pb, opt=ob))


def test_retries_run_out(tiny_run, tmp_path):
    params, opt, step, data = tiny_run

    def always(step_i, attempt):
        raise RuntimeError("injected node failure")

    lc = loop.LoopConfig(total_steps=2, checkpoint_dir=str(tmp_path / "ck"),
                         max_retries=2)
    with pytest.raises(RuntimeError, match="injected"):
        loop.run(step, params, opt, data, lc, fail_injector=always)


def test_grad_compression_close_to_exact(tiny):
    """int8 error-feedback updates point the way exact updates do (the
    reference's test, on the port)."""
    _, cfg, params, _, data = tiny
    batch = pipeline.batch_for(data, pipeline.PipelineState(0), device="cpu")
    _, grads = train_step.value_and_grad(params, cfg, batch["tokens"],
                                         batch["labels"])
    exact_cfg = adamw.AdamWConfig(lr=1e-3)
    comp_cfg = adamw.AdamWConfig(lr=1e-3, compress_grads=True)
    p_exact, _ = adamw.update_leaves(params, list(grads),
                                     adamw.init_state(params, exact_cfg),
                                     exact_cfg)
    p_comp, st = adamw.update_leaves(params, list(grads),
                                     adamw.init_state(params, comp_cfg),
                                     comp_cfg)
    for a, b, p0 in zip(leaves(p_exact), leaves(p_comp), leaves(params)):
        da = a.float().numpy() - p0.float().numpy()
        db = b.float().numpy() - p0.float().numpy()
        if np.linalg.norm(da) < 1e-9:  # zero-gradient leaf (unused param)
            continue
        denom = np.linalg.norm(da) * np.linalg.norm(db) + 1e-12
        assert float((da * db).sum()) / denom > 0.7
    assert any(float(e.float().abs().sum()) > 0 for e in leaves(st["ef"]))


# -- the CLIs --------------------------------------------------------------------


SUMMARY = re.compile(r"^arch=(\S+) steps=(\d+) loss (\S+) -> (\S+) "
                     r"retries=(\d+) restored_from=(\d+)$", re.M)


def test_train_cli(tmp_path, capsys):
    res = launch_train.main(["--arch", "yi-6b", "--reduced", "--steps", "8",
                             "--seq", "32", "--lr", "3e-3", "--device", "cpu",
                             "--checkpoint-dir", str(tmp_path / "ck")])
    m = SUMMARY.search(capsys.readouterr().out)
    assert m and m.group(1) == "yi-6b-smoke" and m.group(2) == "8"
    assert res.final_step == 8 and res.losses[-1] < res.losses[0]
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000008"]
