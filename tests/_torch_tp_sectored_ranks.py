"""Ranks of the sectored decode step's partitioned-program oracle
(``tests/test_torch_tp_sectored.py``).

Each spawned process is one rank of a gloo process group on the CPU. On
the mesh of its world size (``1x2`` on 2 ranks, ``2x2`` on 4) it runs
``make_sectored_decode_step(cfg, mesh)`` for every case and kernel
flavor: three steps with the probe on, from a state made from a numpy
seed (K/V rows, table scores, lengths that span more pages than the
page budget) and placed by the step's own state specs, on tokens from
the same seed. It returns, for each step, the rank's logits, its block
of the table, lengths and position, and every page selection it made;
then one step's counted FLOPs beside :func:`tensor.sectored_step_flops`,
and the collective bytes of a step of the split program and of the
gathered form it replaces (every layer's parameters whole, every kv
head's pages gathered). The test process runs the unmeshed step on the
same inputs itself. This module imports torch, numpy and
``repro_torch`` only.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from _torch_mesh_ranks import _finish, _init, _spawn
from _torch_train_ranks import TINY
from repro_torch import configs
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import model
from repro_torch.parallel import comm, sharding, tensor
from repro_torch.runtime import sector_predictor, sectored_decode as sd
from repro_torch.train import step as train_step

#: world size -> the mesh it runs
MESHES = {2: "1x2", 4: "2x2"}
#: rows, the state's length, steps; the lengths span 6 to 8 of the 8
#: pages, more than the 4 + 1 a step reads
B, SEQ, STEPS = 4, 1000, 3
LENGTHS = (700, 777, 901, 1000)
K_PAGES = sd.topk_for(SEQ)

#: case -> (config overrides, long context, flavors). ``kv-heads``: 4
#: query heads over 2 kv heads, so each rank of 'model' = 2 holds whole
#: kv heads; ``straddle``: the tiny yi-6b's 2 query heads over 1 kv head,
#: whose query heads straddle the two ranks (its page mass is summed over
#: 'model' from each rank's part; the fused flavors refuse it);
#: ``long``: the K/V pages split over every rank, the batch and the
#: table whole (the dry run's long_500k layout)
CASES = {
    "kv-heads": (dict(n_heads=4, n_kv_heads=2), False,
                 ("dispatch", "fused", "fused_q8")),
    "straddle": ({}, False, ("dispatch",)),
    "long": (dict(n_heads=4, n_kv_heads=2), True, ("dispatch",)),
}


def case_cfg(case: str):
    """The case's config: ``TINY`` in f32 (the cache stays bf16), so a
    tolerance speaks of the order of a split sum."""
    return configs.get("yi-6b").reduced(**{**TINY, "dtype": "float32",
                                           **CASES[case][0]})


def initial_state(cfg) -> sd.SectoredState:
    """The global state every run starts from, from a numpy seed: K/V
    rows below each length (bf16), table scores in [0, 1), lengths and
    position at :data:`LENGTHS`."""
    state = sd.init_state(cfg, B, SEQ, device="cpu")
    rng = np.random.default_rng(5)
    for t in (state.kv.k, state.kv.v):
        rows = torch.from_numpy(rng.standard_normal(t.shape, np.float32))
        t.copy_(rows.to(t.dtype))
        for b, n in enumerate(LENGTHS):
            t[:, b, n:] = 0
    state.table.copy_(torch.from_numpy(
        rng.random(state.table.shape, np.float32)))
    state.kv.length.copy_(torch.tensor(LENGTHS, dtype=torch.int32))
    state.position.copy_(torch.tensor(LENGTHS, dtype=torch.int32))
    return state


def tokens(cfg) -> torch.Tensor:
    """(B, STEPS) tokens, one column a step."""
    rng = np.random.default_rng(6)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (B, STEPS)))


@contextlib.contextmanager
def recorded_selections():
    """Every ``predict_topk`` result while the block runs, in call order
    (a step's layers, step after step)."""
    seen = []
    real = sector_predictor.predict_topk

    def record(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append(out.clone())
        return out

    sector_predictor.predict_topk = record
    try:
        yield seen
    finally:
        sector_predictor.predict_topk = real


def unmeshed_run(case: str, kernel: str, probe: bool = True) -> dict:
    """The unsplit step over every row: each step's logits and state
    (table, lengths, position), and the selections."""
    cfg = case_cfg(case)
    params = model.init_params(cfg, seed=0, device="cpu")
    state, tok = initial_state(cfg), tokens(cfg)
    steps = []
    with torch.no_grad(), recorded_selections() as seen:
        for s in range(STEPS):
            logits, state = sd.sectored_decode_step(
                params, cfg, state, tok[:, s:s + 1], K_PAGES, probe=probe,
                kernel=kernel)
            steps.append(_snapshot(logits, state))
    return dict(steps=steps, selections=seen)


def _snapshot(logits, state) -> dict:
    return dict(logits=logits.clone(), table=state.table.clone(),
                length=state.kv.length.clone(),
                position=state.position.clone())


def mesh_run(case: str, kernel: str, mesh, probe: bool = True) -> dict:
    """The partitioned step on this rank (see the module docstring)."""
    cfg = case_cfg(case)
    long_context = CASES[case][1]
    params = model.init_params(cfg, seed=0, device="cpu")
    fn, (pspec, sspec, _), shape = sd.make_sectored_decode_step(
        cfg, mesh, batch=B, seq_len=SEQ, long_context=long_context,
        kernel=kernel, probe=probe)
    mc = comm.MeshComm(mesh)
    blocks = sharding.place(params, pspec, mesh)
    state = sharding.place(initial_state(cfg), sspec, mesh)
    part, parts = (0, 1) if long_context else mc.data_shard()
    rows = slice(part * B // parts, (part + 1) * B // parts)
    tok = tokens(cfg)[rows]
    steps, calls = [], {}
    with torch.no_grad(), recorded_selections() as seen:
        for s in range(STEPS):
            comm.reset_launches()
            comm.reset_bytes()
            logits, state = fn(blocks, state, tok[:, s:s + 1])
            steps.append(_snapshot(logits, state))
            calls = dict(tp=comm.launches["tp"], wave=comm.launches["wave"],
                         bytes=dict(comm.collective_bytes),
                         tp_bytes=dict(comm.tp_bytes))
    tp = train_step.split_context(mesh, cfg, pspec)[0]
    with torch.no_grad(), FlopCounterMode(display=False) as flops:
        fn(blocks, state, tok[:, :1])
    # on the CPU the fused flavors' core is the kernel's plain version,
    # whose products the counter sees
    reads = (K_PAGES + 1) * sd.PAGE_SIZE
    return dict(steps=steps, selections=seen, rows=rows,
                coords=dict(mc.coords), calls=calls,
                flops=flops.get_total_flops(),
                implied=tensor.sectored_step_flops(cfg, tp, tok.shape[0],
                                                   reads),
                gathered=gathered_form_bytes(cfg, mesh, blocks, pspec,
                                             sspec, shape, tok,
                                             long_context) if kernel ==
                "dispatch" else None)


def gathered_form_bytes(cfg, mesh, blocks, pspec, sspec, shape, tok,
                        long_context: bool) -> dict:
    """The collective bytes of one step of the form the split program
    replaces: every layer's parameters gathered whole, the unsplit
    program, and every kv head's selected pages gathered to every rank
    (a page shard without rows)."""
    serving = train_step.serving_params(cfg, mesh, pspec, split=False)
    index, size = sharding.block_index(
        sspec.kv.k, tuple(shape.kv.k.shape), mesh, sharding.mesh_coords(
            mesh), 2)
    group = None if long_context else mesh.get_group("model")
    state = sharding.place(initial_state(cfg), sspec, mesh)
    comm.reset_bytes()
    with torch.no_grad():
        tree, tp = serving(blocks)
        sd.sectored_decode_step_(tree, cfg, state, tok[:, :1], K_PAGES,
                                 probe=True, shard=comm.PageShard(
                                     group, index, size), tp=tp)
    return dict(comm.collective_bytes)


def rank_main(rank: int, world: int, store: str, outdir: str) -> None:
    _init(rank, world, store)
    mesh = mesh_mod.make_serving_mesh(MESHES[world], device="cpu")
    results = {}
    for case, (_, _, flavors) in CASES.items():
        for kernel in flavors:
            results[(case, kernel)] = mesh_run(case, kernel, mesh)
        if case == "kv-heads" and world == 2:
            results["refused"] = _fused_refused(mesh)
    if world == 2:
        for case in ("kv-heads", "straddle"):
            results[("ref", case)] = mesh_run(case, "dispatch", mesh,
                                              probe=False)
    _finish(rank, outdir, results)


def _fused_refused(mesh) -> str:
    """The fused kernel on the straddling case: the error it raises."""
    try:
        mesh_run("straddle", "fused", mesh)
    except ValueError as e:
        return str(e)
    return ""


def spawn_sectored(world: int, tmpdir: str, timeout: float = 300.0) -> list:
    return _spawn(rank_main, world, tmpdir, timeout=timeout)
