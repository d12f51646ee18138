"""Ranks of the port's cross-mesh oracle (``tests/test_torch_mesh*.py``).

Each spawned process is one rank of a gloo process group on the CPU and
runs every case of its world size on every mesh shape of that size, as a
``torchrun`` rank would: the same ``ServeSession`` on every rank, over a
``MeshBackend``. Each rank writes what its session saw to ``outdir``;
the test process compares it with the unmeshed session, which it runs
itself. This module imports torch and ``repro_torch`` only (the ranks
never import JAX).
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import configs
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import model
from repro_torch.runtime import sectored_decode
from repro_torch.runtime.graphs import leaves
from repro_torch.sample import SamplerSpec
from repro_torch.serve import (AlwaysSectored, FifoScheduler,
                               OverlapScheduler, Request, ServeSession)
from repro_torch.serve.mesh_backend import MeshBackend
from repro_torch.telemetry import MeteredBackend

#: the reduced yi-6b of tests/_torch_port.py (SMALL)
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab=128, head_dim=32)

#: case -> session arguments. ``fused`` cases are held to the unmeshed
#: DISPATCH session (fused == dispatch and mesh invariance in one); their
#: 140-token prompts span two of the cache's pages, so the predictor's
#: narrow step (and the paged kernel's plain version) engages
CASES = {
    "greedy-fifo": dict(scheduler="fifo"),
    "greedy-overlap": dict(scheduler="overlap"),
    "sampled-fifo": dict(scheduler="fifo", n_requests=8, sampled=True),
    "sampled-overlap": dict(scheduler="overlap", n_requests=8,
                            sampled=True),
    "fused-fifo": dict(scheduler="fifo", kernel="fused", n_requests=5,
                       max_batch=4, seq_len=384, prompt_len=140),
    "fused-overlap": dict(scheduler="overlap", kernel="fused", n_requests=5,
                          max_batch=4, seq_len=384, prompt_len=140),
    # a max_batch the 'data' axis does not divide: the slot axis degrades
    # to replicated (the pages stay sharded over 'model')
    "indivisible": dict(scheduler="overlap", n_requests=7, max_batch=5),
}

#: world size -> the mesh specs run on it ((1,) runs in-process)
MESHES = {2: ("2x1", "1x2"), 4: ("2x2",)}


def small_cfg():
    return configs.get("yi-6b").reduced(**SMALL)


def sampler_for(rid: int) -> SamplerSpec | None:
    """Odd rids sample (distinct seeds and specs), even rids stay greedy:
    one fused wave carries both (the reference oracle's assignment)."""
    if rid % 2 == 0:
        return None
    return SamplerSpec(temperature=0.8 + 0.1 * (rid % 3),
                       top_k=0 if rid % 4 == 1 else 16, top_p=0.95,
                       seed=1000 + rid)


def run_session(cfg, params, *, mesh=None, scheduler="fifo", n_requests=12,
                max_batch=8, max_new_tokens=5, seed=3, sampled=False,
                kernel="dispatch", seq_len=48, prompt_len=6,
                metered_outside=False) -> dict:
    """One drained, metered session (over ``MeshBackend`` when ``mesh``
    is given; ``metered_outside`` puts the meter outside it): its
    streams, logprobs, joules, stats and the rank's view of the mesh."""
    inner = sectored_decode.make_serving_fns(cfg, params=params,
                                             seq_len=seq_len, kernel=kernel,
                                             device="cpu")
    prefills = [0]
    prefill = inner.prefill_fn

    def counted(tokens):
        prefills[0] += 1
        return prefill(tokens)
    inner.prefill_fn = counted
    if mesh is None:
        backend = MeteredBackend(inner)
    elif metered_outside:
        backend = MeteredBackend(MeshBackend(inner, mesh))
    else:
        backend = MeshBackend(MeteredBackend(inner), mesh)
    sched = OverlapScheduler() if scheduler == "overlap" else FifoScheduler()
    sess = ServeSession(backend, max_batch=max_batch, scheduler=sched,
                        policy=AlwaysSectored())
    rng = np.random.default_rng(seed)
    handles = [sess.submit(Request(
        rid, rng.integers(0, cfg.vocab, size=prompt_len).astype(np.int32),
        max_new_tokens=max_new_tokens,
        sampler=sampler_for(rid) if sampled else None))
        for rid in range(n_requests)]
    sess.run_until_drained()
    out = dict(
        tokens={h.rid: tuple(h.peek()) for h in handles},
        logprobs={h.rid: tuple(h.logprobs()) for h in handles},
        joules={h.rid: h.energy_j for h in handles},
        done=all(h.done for h in handles), stats=dict(sess.stats),
        mesh_shape=sess.meter.mesh_shape, prefills=prefills[0])
    if mesh is not None:
        wave = sess.batched
        mb = sess.backend if not metered_outside else sess.backend.inner
        out.update(
            coords=dict(mb.coords), donor_rank=mb.donor_rank,
            shard_pages=mb.shard_pages, slots=(wave.slots.start,
                                               wave.slots.stop),
            local_shapes=[tuple(t.shape) for t in leaves(wave.local)])
    return out


def _init(rank: int, world: int, store: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))


def _finish(rank: int, outdir: str, results) -> None:
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


def oracle_main(rank: int, world: int, store: str, outdir: str) -> None:
    """Every case on every mesh of this world size."""
    _init(rank, world, store)
    cfg = small_cfg()
    params = model.init_params(cfg, seed=0, device="cpu")
    results = {}
    for spec in MESHES[world]:
        mesh = mesh_mod.make_serving_mesh(spec, device="cpu")
        for case, kw in CASES.items():
            t0 = time.perf_counter()
            res = run_session(cfg, params, mesh=mesh, **kw)
            res["seconds"] = time.perf_counter() - t0
            results[(spec, case)] = res
        # the decorator in the other order, once per mesh
        results[(spec, "metered-outside")] = run_session(
            cfg, params, mesh=mesh, metered_outside=True,
            **CASES["greedy-overlap"])
    _finish(rank, outdir, results)


def restore_main(rank: int, world: int, store: str, outdir: str,
                 ckpt: str) -> None:
    """A one-rank checkpoint restored onto a model-split mesh and an
    fsdp data-split one: this rank's leaves of each."""
    from repro_torch.checkpoint import manager
    from repro_torch.parallel import sharding
    _init(rank, world, store)
    like = dict(params=model.init_params(small_cfg(), seed=1, device="cpu"),
                step=torch.tensor(0, dtype=torch.int32))
    results = {}
    try:
        mesh_mod.make_serving_mesh("1", device="cpu")
    except ValueError as e:
        results["too_small"] = str(e)
    for spec, fsdp in (("1x2", False), ("2x1", True)):
        mesh = mesh_mod.make_serving_mesh(spec, device="cpu")
        specs = dict(params=sharding.param_shardings(mesh, like["params"],
                                                     fsdp=fsdp),
                     step=sharding.P())
        tree, step = manager.restore(manager.latest(ckpt), like,
                                     device="cpu", mesh=mesh,
                                     shardings=specs)
        results[spec] = (step, list(leaves(tree)))
    _finish(rank, outdir, results)


def _spawn(target, world: int, tmpdir: str, args=(),
           timeout: float = 240.0) -> list:
    """Run ``target(rank, world, store, tmpdir, *args)`` on ``world``
    spawned ranks; each rank's results, in rank order. Ranks still
    running at ``timeout`` are killed and the call raises."""
    store = os.path.join(tmpdir, "store")
    ctx = mp.start_processes(target, args=(world, store, tmpdir, *args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"{world} mesh ranks still running after "
                               f"{timeout} s")
    out = []
    for rank in range(world):
        with open(os.path.join(tmpdir, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def spawn_oracle(world: int, tmpdir: str, timeout: float = 240.0) -> list:
    return _spawn(oracle_main, world, tmpdir, timeout=timeout)


def spawn_restore(ckpt: str, timeout: float = 120.0) -> list:
    with tempfile.TemporaryDirectory() as d:
        return _spawn(restore_main, 2, d, args=(ckpt,), timeout=timeout)
