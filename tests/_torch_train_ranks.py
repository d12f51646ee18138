"""Ranks of the port's training-mesh oracle (``tests/test_torch_train_mesh.py``).

Each spawned process is one rank of a gloo process group on the CPU and
runs every case of its world size on every mesh shape of that size, as a
``torchrun`` rank would: ``make_train_step(cfg, mesh)`` on its blocks of
the parameters and optimizer state and its rows of each batch. Each rank
writes the global trees it gathers back (and what it saw) to ``outdir``;
the test process compares them with the unmeshed steps, which it runs
itself. This module imports torch and ``repro_torch`` only (the ranks
never import JAX).
"""

from __future__ import annotations

import os
import shutil

import torch

from _torch_mesh_ranks import _finish, _init, _spawn
from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import model
from repro_torch.optim import adamw
from repro_torch.parallel import comm, sharding
from repro_torch.runtime.graphs import leaves
from repro_torch.train import loop
from repro_torch.train import step as train_step

#: the reduced yi-6b of the reference's tests/test_train.py
TINY = dict(n_layers=2, d_model=64, d_ff=128, vocab=128, n_heads=2,
            n_kv_heads=1, head_dim=32)
DATA = pipeline.DataConfig(vocab=128, seq_len=16, global_batch=4)
STEPS = 2
#: a clip the gradients never reach (the clip factor is exactly 1.0)
NO_CLIP = 1e6

#: case -> (arch, fsdp, compress_grads, grad_clip)
CASES = {
    "plain": ("yi-6b", False, False, NO_CLIP),
    "fsdp": ("yi-6b", True, False, NO_CLIP),
    "compress": ("yi-6b", False, True, NO_CLIP),
    "fsdp-compress": ("yi-6b", True, True, NO_CLIP),
    "clip": ("yi-6b", False, False, 1.0),
    "clip-fsdp": ("yi-6b", True, False, 1.0),
    # a hybrid's list of layers and a MoE stack, sharded
    "hybrid-fsdp": ("recurrentgemma-2b", True, False, NO_CLIP),
    "moe-fsdp": ("qwen3-moe-235b-a22b", True, False, NO_CLIP),
}

#: world size -> the mesh specs run on it
MESHES = {2: ("2x1", "1x2"), 4: ("2x2",)}


def tiny_cfg(arch: str = "yi-6b", **kw):
    extra = dict(n_layers=3) if arch == "recurrentgemma-2b" else {}
    return configs.get(arch).reduced(**{**TINY, **extra, **kw})


def opt_cfg(compress: bool, clip: float) -> adamw.AdamWConfig:
    return adamw.AdamWConfig(lr=1e-3, grad_clip=clip, compress_grads=compress)


def batch(step: int, shard: int = 0, n_shards: int = 1, data=DATA) -> dict:
    return loop.rank_rows(pipeline.batch_for(
        data, pipeline.PipelineState(step), device="cpu"), shard, n_shards)


def gather_tree(tree, specs, mesh) -> list:
    """Every leaf of a tree of rank blocks as its global tensor."""
    mc = comm.MeshComm(mesh)
    return [mc.gather(t, s, purpose="checkpoint")
            for t, s in zip(leaves(tree), sharding.spec_leaves(specs))]


def run_case(mesh, case: str) -> dict:
    """STEPS meshed steps of ``case`` from seed-0 parameters: the global
    parameters and optimizer state after them, the losses, and the first
    step's collective bytes and calls."""
    arch, fsdp, compress, clip = CASES[case]
    cfg = tiny_cfg(arch)
    ocfg = opt_cfg(compress, clip)
    params = model.init_params(cfg, seed=0, device="cpu")
    fn, ins, _ = train_step.make_train_step(cfg, mesh, opt_cfg=ocfg,
                                            fsdp=fsdp)
    p = sharding.place(params, ins[0], mesh)
    o = sharding.place(adamw.init_state(params, ocfg), ins[1], mesh)
    shard, n_shards = fn.mesh_comm.data_shard()
    losses, first = [], None
    for step in range(STEPS):
        comm.reset_bytes()
        comm.reset_launches()
        p, o, m = fn(p, o, batch(step, shard, n_shards))
        losses.append(m["loss"])
        if first is None:
            first = dict(bytes=dict(comm.collective_bytes),
                         calls=comm.launches["train"])
    state = gather_tree(dict(params=p, opt=o), dict(params=ins[0],
                                                    opt=ins[1]), mesh)
    return dict(losses=losses, state=state, first=first,
                local_shapes=[tuple(t.shape) for t in leaves(p)])


def ref_grads(mesh, dtype: str) -> dict:
    """The (2, 1) step's loss and gradients (the data ranks' mean) and
    one step's state, for the reference comparison."""
    cfg = tiny_cfg(dtype=dtype)
    ocfg = adamw.AdamWConfig(lr=1e-3)
    params = model.init_params(cfg, seed=0, device="cpu")
    fn, ins, _ = train_step.make_train_step(cfg, mesh, opt_cfg=ocfg)
    specs = list(sharding.spec_leaves(ins[0]))
    shard, n = fn.mesh_comm.data_shard()
    b = batch(1, shard, n)
    with train_step.deterministic():
        _, g = train_step.mesh_value_and_grad(
            params, cfg, b["tokens"], b["labels"], fn.mesh_comm, specs)
    grads = [x / n for x in g]
    p, o, m = fn(params, adamw.init_state(params, ocfg), b)
    return dict(grads=grads, loss=m["loss"],
                state=list(leaves(dict(params=p, opt=o))))


def loop_case(mesh_a, mesh_b, outdir: str) -> dict:
    """``loop.run`` at ``mesh_a`` with fsdp for STEPS steps, a checkpoint
    each step (rank 0 writes them), then a copy of its checkpoints
    continued at ``mesh_b`` to 2 * STEPS: the continued run's global
    state."""
    cfg = tiny_cfg()
    ocfg = opt_cfg(False, NO_CLIP)
    params = model.init_params(cfg, seed=0, device="cpu")
    run_a = os.path.join(outdir, "ckpt_a")
    fn, ins, _ = train_step.make_train_step(cfg, mesh_a, opt_cfg=ocfg,
                                            fsdp=True)
    p = sharding.place(params, ins[0], mesh_a)
    o = sharding.place(adamw.init_state(params, ocfg), ins[1], mesh_a)
    _, _, res_a = loop.run(fn, p, o, DATA, loop.LoopConfig(
        total_steps=STEPS, checkpoint_every=1, checkpoint_dir=run_a))
    run_b = os.path.join(outdir, "ckpt_b")
    if torch.distributed.get_rank() == 0:
        shutil.copytree(run_a, run_b)
    torch.distributed.barrier()
    fn, ins, _ = train_step.make_train_step(cfg, mesh_b, opt_cfg=ocfg)
    p = sharding.place(params, ins[0], mesh_b)
    o = sharding.place(adamw.init_state(params, ocfg), ins[1], mesh_b)
    p, o, res_b = loop.run(fn, p, o, DATA, loop.LoopConfig(
        total_steps=2 * STEPS, checkpoint_every=100,
        checkpoint_dir=run_b))
    state = gather_tree(dict(params=p, opt=o), dict(params=ins[0],
                                                    opt=ins[1]), mesh_b)
    return dict(losses_a=res_a.losses, losses_b=res_b.losses,
                restored_from=res_b.restored_from, state=state,
                ckpt_a=run_a)


def splits_model(spec: str) -> bool:
    """Whether the mesh's 'model' axis has two or more ranks (the
    partitioned program splits the products)."""
    shape, axes = mesh_mod.parse_mesh_shape(spec)
    return dict(zip(axes, shape)).get("model", 1) > 1


def train_main(rank: int, world: int, store: str, outdir: str) -> None:
    """Every case on every mesh of this world size, a second time where
    'model' splits the products (its run-to-run bits), and, on 2 ranks,
    the reference's (2, 1) witnesses and the checkpoint re-mesh."""
    _init(rank, world, store)
    results = {}
    for spec in MESHES[world]:
        mesh = mesh_mod.make_serving_mesh(spec, device="cpu")
        for case in CASES:
            results[(spec, case)] = run_case(mesh, case)
            if splits_model(spec):
                results[(spec, case, "again")] = run_case(mesh, case)
    if world == 2:
        mesh21 = mesh_mod.make_serving_mesh("2x1", device="cpu")
        mesh12 = mesh_mod.make_serving_mesh("1x2", device="cpu")
        for dtype in ("float32", "bfloat16"):
            results[("2x1", f"ref-{dtype}")] = ref_grads(mesh21, dtype)
        results[("2x1", "loop")] = loop_case(mesh21, mesh12, outdir)
    _finish(rank, outdir, results)


def spawn_train(world: int, tmpdir: str, timeout: float = 300.0) -> list:
    return _spawn(train_main, world, tmpdir, timeout=timeout)
