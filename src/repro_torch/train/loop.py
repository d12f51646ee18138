"""Fault-tolerant training loop (counterpart of the JAX package's
``train/loop.py``), with the reference's semantics:

* it begins by restoring the latest complete checkpoint of
  ``checkpoint_dir`` (missing and torn checkpoints are skipped);
* a step that raises, gives a non-finite loss or passes its deadline is
  retried from the last good state, up to ``max_retries`` times; with the
  deterministic data of :mod:`repro_torch.data.pipeline` and a
  deterministic step (``repro_torch.train.step``) a retry, and a restart
  from a checkpoint, reproduce the uninterrupted run bit for bit;
* it saves every ``checkpoint_every`` steps and at the end.

The state lives on the device of the first parameter; batches are made
there and checkpoints restored there.

A step made by ``make_train_step(cfg, mesh)`` carries its mesh and
specs, and the loop runs as that rank's program: the state is the rank's
blocks, each step reads the rank's rows of the global batch
(:func:`rank_rows`), a checkpoint is written by rank
0 in the one-host format (``manager.save(mesh=)``) and restored onto the
mesh by each rank taking its blocks (``manager.restore(mesh=)``), so a
run may restart on another mesh.
"""

from __future__ import annotations

import dataclasses
import math
import os
import tempfile
import time
from typing import Callable

from repro_torch.checkpoint import manager
from repro_torch.data import pipeline
from repro_torch.runtime.graphs import leaves


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    step_deadline_s: float = 120.0  # straggler threshold
    max_retries: int = 3


@dataclasses.dataclass
class LoopResult:
    final_step: int
    losses: list
    retries: int
    restored_from: int  # step restored at start (0 = fresh)


def rank_rows(batch: dict, shard: int, n_shards: int) -> dict:
    """Data shard ``shard``'s rows of a global batch (views). A rank of
    a mesh step reads these, not ``pipeline.batch_for(shard=)``: there the
    reference's shard ``k > 0`` is a stream of its own, seeded by ``k``."""
    rows = next(iter(batch.values())).shape[0] // n_shards
    return {k: t[shard * rows:(shard + 1) * rows] for k, t in batch.items()}


def run(train_step: Callable, params, opt_state, data_cfg: pipeline.DataConfig,
        loop_cfg: LoopConfig, *, fail_injector: Callable | None = None
        ) -> tuple:
    """Run the loop; returns (params, opt_state, LoopResult)."""
    dev = next(leaves(params)).device
    state = dict(params=params, opt=opt_state)
    mesh = getattr(train_step, "mesh", None)
    placed, shard, n_shards = {}, 0, 1
    if mesh is not None:
        specs = train_step.in_specs
        placed = dict(mesh=mesh, shardings=dict(params=specs[0],
                                                opt=specs[1]))
        shard, n_shards = train_step.mesh_comm.data_shard()
    start_step = 0
    ckpt = manager.latest(loop_cfg.checkpoint_dir)
    if ckpt is not None:
        state, start_step = manager.restore(ckpt, state, device=dev,
                                            **placed)
    restored_from = start_step

    losses = []
    retries = 0
    step = start_step
    while step < loop_cfg.total_steps:
        batch = rank_rows(pipeline.batch_for(
            data_cfg, pipeline.PipelineState(step), device=dev), shard,
            n_shards)
        attempt = 0
        while True:
            t0 = time.time()
            try:
                if fail_injector is not None:
                    fail_injector(step, attempt)
                new_params, new_opt, metrics = train_step(
                    state["params"], state["opt"], batch)
                loss = float(metrics["loss"])
                if not math.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at {step}")
                if time.time() - t0 > loop_cfg.step_deadline_s:
                    raise TimeoutError(f"straggler step {step}")
                break
            except Exception:
                attempt += 1
                retries += 1
                if attempt > loop_cfg.max_retries:
                    raise
                # retry from the last good state (the same data)
                continue
        state = dict(params=new_params, opt=new_opt)
        del new_params, new_opt
        losses.append(loss)
        step += 1
        if step % loop_cfg.checkpoint_every == 0 or step == loop_cfg.total_steps:
            manager.save(loop_cfg.checkpoint_dir, step, state, **placed)
    return state["params"], state["opt"], LoopResult(
        final_step=step, losses=losses, retries=retries,
        restored_from=restored_from)
