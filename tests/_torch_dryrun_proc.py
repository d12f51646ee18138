"""The dry run's fake-mesh work for ``tests/test_torch_dryrun.py``, in a
process of its own (a default process group is per process, and a test
worker may already hold a gloo group). Run as ``python
tests/_torch_dryrun_proc.py OUT.pkl`` with ``src`` on the path; it
writes what the test checks to ``OUT.pkl``. Imports torch and
``repro_torch`` only."""

from __future__ import annotations

import dataclasses
import pickle
import sys

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.launch import dryrun, mesh as mesh_mod
from repro_torch.models import model
from repro_torch.parallel import comm, sharding
from repro_torch.runtime.graphs import leaves
from repro_torch.train import step as train_step

#: the cut shapes of the 2x2 lowering (kinds as the four SHAPES)
CUT = {"train_4k": (16, 4), "prefill_32k": (32, 4), "decode_32k": (128, 4),
       "long_500k": (256, 1)}
#: one arch per family: dense, MoE, RWKV6, hybrid, audio and vision stubs
FAMILIES = ("yi-6b", "qwen3-moe-235b-a22b", "rwkv6-1.6b",
            "recurrentgemma-2b", "musicgen-large", "qwen2-vl-72b")


def cut(shape: str):
    seq, batch = CUT[shape]
    return dataclasses.replace(configs.SHAPES[shape], seq_len=seq,
                               global_batch=batch)


def lower_families(mesh) -> dict:
    out = {}
    for arch in FAMILIES:
        cfg = configs.get(arch).reduced()
        for shape, variant in dryrun.cells_for(arch):
            cost, rf = dryrun.lower_cell(arch, cut(shape), False, variant,
                                         mesh=mesh, cfg=cfg)
            out[(arch, shape)] = dict(row=dryrun.record(cost, rf, 0.0),
                                      cost=dataclasses.asdict(cost))
    return out


def flops_by_depth(mesh) -> dict:
    """The train cell's counted FLOPs at 2, 4 and 6 layers: 'model' lands
    on the stacked FFN's layer axis where the depth is even (on its rows
    where it is odd), so every layer of these runs the same program."""
    out = {}
    for n in (2, 4, 6):
        cfg = dataclasses.replace(configs.get("yi-6b").reduced(), n_layers=n)
        cost, rf = dryrun.lower_cell("yi-6b", cut("train_4k"), False,
                                     mesh=mesh, cfg=cfg)
        out[n] = dict(flops=cost.flops, model_flops=rf.model_flops)
    return out


def collective_case(mesh, fsdp: bool) -> dict:
    """The train cell's collective bytes and the specs and block shapes
    they should follow."""
    cfg = configs.get("yi-6b").reduced()
    cost = dryrun.trace_cell(cfg, cut("train_4k"), mesh, fsdp=fsdp)
    tp_bytes = dict(comm.tp_bytes)
    fn, ins, _ = train_step.make_train_step(cfg, mesh, fsdp=fsdp)
    params = sharding.abstract(model.init_params, cfg, device="cpu")
    top, per_layer = train_step.layer_slots(params, cfg.n_layers)
    return dict(coll=cost.coll, tp=tp_bytes,
                split=[land.split for land in sharding.landing_leaves(
                    fn.tp.lands)],
                specs=list(sharding.spec_leaves(ins[0])),
                shapes=[tuple(t.shape) for t in leaves(params)],
                itemsize=[t.element_size() for t in leaves(params)],
                top=top, layer=per_layer[0], n_layers=cfg.n_layers)


#: the per-token-loop cells checked against a direct trace: (arch, shape,
#: layers); the length LOOP_LEN is past the three cut lengths
LOOP_CELLS = (("rwkv6-1.6b", "train_4k", 1), ("rwkv6-1.6b", "prefill_32k", 1),
              ("recurrentgemma-2b", "train_4k", 3),
              ("recurrentgemma-2b", "prefill_32k", 3))
LOOP_LEN = 96


def time_loop_cells(mesh) -> dict:
    """Each per-token-loop cell at LOOP_LEN tokens, traced directly (every
    token's ops) and as the dry run takes it (counts from the three cut
    lengths, the peak from the loop stand-ins' trace)."""
    out = {}
    for arch, shape, layers in LOOP_CELLS:
        cfg = dataclasses.replace(configs.get(arch).reduced(),
                                  n_layers=layers)
        sc = dataclasses.replace(configs.SHAPES[shape], seq_len=LOOP_LEN,
                                 global_batch=4)
        assert dryrun.has_time_loop(cfg, sc)
        out[(arch, shape)] = dict(
            direct=dataclasses.asdict(dryrun.trace_cell(cfg, sc, mesh)),
            dryrun=dataclasses.asdict(dryrun.time_loop_cost(cfg, sc, mesh)))
    return out


def real_flops() -> int:
    """FlopCounterMode's count of the real meshed step (mesh ``1``, a
    one-rank gloo group), on the cut train cell's inputs."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.optim import adamw
    cfg = configs.get("yi-6b").reduced()
    seq, batch = CUT["train_4k"]
    mesh = mesh_mod.make_serving_mesh("1", device="cpu")
    ocfg = adamw.AdamWConfig()
    fn, _, _ = train_step.make_train_step(cfg, mesh, opt_cfg=ocfg, fsdp=True)
    params = model.init_params(cfg, seed=0, device="cpu")
    tokens = torch.zeros((batch, seq), dtype=torch.int32)
    with FlopCounterMode(display=False) as flops:
        fn(params, adamw.init_state(params, ocfg),
           dict(tokens=tokens, labels=tokens))
    return flops.get_total_flops()


def main(path: str) -> None:
    torch.set_num_threads(1)
    res = {}
    with mesh_mod.make_dryrun_mesh(spec="1") as mesh:
        cost, _ = dryrun.lower_cell("yi-6b", cut("train_4k"), False,
                                    mesh=mesh, cfg=configs.get(
                                        "yi-6b").reduced(), fsdp=True)
        res["fake_flops_1"] = cost.flops
    with mesh_mod.make_dryrun_mesh(spec="2x2") as mesh:
        res["backend"] = dist.get_backend()
        res["world"] = comm.MeshComm(mesh).world
        res["cells"] = lower_families(mesh)
        res["depth"] = flops_by_depth(mesh)
        res["time_loop"] = time_loop_cells(mesh)
        res["coll"] = {fsdp: collective_case(mesh, fsdp)
                       for fsdp in (False, True)}
        try:  # the real meshes never fall back to the fake group
            mesh_mod.make_serving_mesh("2x2", device="cpu")
        except RuntimeError as e:
            res["real_over_fake"] = str(e)
        try:
            with mesh_mod.make_dryrun_mesh(spec="2x2"):
                pass
        except RuntimeError as e:
            res["fake_over_fake"] = str(e)
    res["torn_down"] = not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with mesh_mod.make_dryrun_mesh():
            pass
    except RuntimeError as e:
        res["fake_over_real"] = str(e)
    res["real_flops_1"] = real_flops()
    dist.destroy_process_group()
    with open(path, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1])
