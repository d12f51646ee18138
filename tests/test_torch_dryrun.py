"""The port's dry-run tooling against the JAX reference's: ``SHAPES`` and
``token_specs``, ``input_specs`` and ``cells_for`` for all ten
architectures, ``model_flops_for`` bit for bit, the ``Roofline``
arithmetic on equal inputs, ``report``'s table and summary byte for
byte, and hillclimb's steps.

The fake-mesh work runs in a process of its own
(``tests/_torch_dryrun_proc.py``: a default process group is per
process): ``lower_cell`` of every cell of a dense, a MoE, an RWKV6, a
hybrid and both frontend-stub archs (reduced, cut shapes) on a 2x2 fake
mesh, with the reference's row keys; the training cell's collective
bytes equal to the sum reckoned from the parameter specs; counted FLOPs
linear in ``n_layers`` and, over the data ranks, no lower than
``model_flops_for``; the fake-tensor FLOPs of a one-rank cell equal to
``FlopCounterMode``'s count of the real step; the per-token-loop cells
(RWKV6, hybrid; train and prefill) at 96 tokens equal to a direct trace,
counts and peak; and the fake group refusing to start over a real one
(and the real meshes refusing it).
The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` when imported,
so it is imported with the environment put back after.
"""

import contextlib
import dataclasses
import io
import json
import math
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import _torch_dryrun_proc as proc
from _torch_port import one_torch_thread  # noqa: F401  (autouse)
from repro import configs as jconfigs
from repro.launch import report as jreport
from repro.launch import roofline as jroofline
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.launch import dryrun, report, roofline

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(configs.ARCHS)
ROW_KEYS = {"arch", "shape", "mesh", "chips", "t_compute", "t_memory",
            "t_collective", "bottleneck", "model_flops", "hlo_flops_total",
            "useful_fraction", "roofline_fraction", "peak_memory_gib", "coll",
            "compile_s", "arg_gib", "temp_gib"}


@pytest.fixture(scope="module")
def jdryrun():
    """The reference's dryrun module, imported with XLA_FLAGS put back."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as mod
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mod


@pytest.fixture(scope="module")
def fake_mesh():
    """What the fake-mesh process measured."""
    out = ROOT / "build" / "test_dryrun.pkl"
    out.parent.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_dryrun_proc.py"),
         str(out)], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


# -- shapes and specs ----------------------------------------------------------


def test_shapes_and_token_specs_match_reference():
    assert list(base.SHAPES) == list(jconfigs.SHAPES)
    for name, sc in jconfigs.SHAPES.items():
        assert dataclasses.asdict(configs.SHAPES[name]) == \
            dataclasses.asdict(sc)
        want = jconfigs.base.token_specs(sc)
        got = base.token_specs(configs.SHAPES[name])
        assert set(want) == set(got)
        for key in want:
            assert tuple(got[key].shape) == want[key].shape
            assert str(got[key].dtype).removeprefix("torch.") == \
                str(want[key].dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_cells_match_reference(jdryrun, arch):
    for name in jconfigs.SHAPES:
        want = jdryrun.input_specs(arch, name)
        got = dryrun.input_specs(arch, name)
        assert set(want) == set(got)
        for key in want:
            assert tuple(got[key].shape) == want[key].shape
            assert str(got[key].dtype).removeprefix("torch.") == \
                str(want[key].dtype)
    assert dryrun.cells_for(arch) == jdryrun.cells_for(arch)
    for name in ("FSDP_ARCHS", "BF16_MOMENT_ARCHS", "ATTENTION_ARCHS"):
        assert getattr(dryrun, name) == getattr(jdryrun, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_bitwise(arch):
    for name in jconfigs.SHAPES:
        want = jroofline.model_flops_for(jconfigs.get(arch),
                                         jconfigs.SHAPES[name])
        got = roofline.model_flops_for(configs.get(arch),
                                       configs.SHAPES[name])
        assert np.float64(got).tobytes() == np.float64(want).tobytes()


def _rooflines(chips=256):
    kw = dict(arch="yi-6b", shape="train_4k", mesh="16x16", chips=chips,
              flops_per_device=3.2e14, bytes_per_device=7.5e12,
              coll_bytes_per_device=4.1e10,
              coll_breakdown={"all-gather": 4.0e10, "all-reduce": 1.0e9},
              peak_memory_bytes=90 * 2**30, model_flops=3.6e16)
    return jroofline.Roofline(**kw), roofline.Roofline(**kw)


def test_roofline_arithmetic(monkeypatch):
    """On the reference's constants the rows are equal; on the port's
    (H100 datasheet) each term is its count over its figure."""
    ref, port = _rooflines()
    monkeypatch.setattr(roofline, "PEAK_FLOPS", jroofline.PEAK_FLOPS)
    monkeypatch.setattr(roofline, "HBM_BW", jroofline.HBM_BW)
    monkeypatch.setattr(roofline, "LINK_BW", jroofline.ICI_BW)
    assert port.row() == ref.row()
    monkeypatch.undo()
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    assert port.t_compute == 3.2e14 / 989e12
    assert port.t_memory == 7.5e12 / 3.35e12
    assert port.t_collective == 4.1e10 / 450e9
    assert port.bottleneck == "memory"
    assert port.roofline_fraction == (3.6e16 / (256 * 989e12)) / \
        port.t_memory


def test_analyze_reads_a_step_cost():
    cost = roofline.StepCost(flops=1e12, bytes_accessed=2e12,
                             peak_bytes=3 * 2**30, arg_bytes=2**30,
                             coll=dict(dict.fromkeys(jroofline._COLLECTIVES,
                                                     0), **{"all-gather": 7}))
    rf = roofline.analyze(cost, arch="a", shape="s", mesh_name="2x2",
                          chips=4, model_flops=5.0)
    assert rf.flops_per_device == 1e12 and rf.peak_memory_bytes == 3 * 2**30
    assert rf.coll_bytes_per_device == 7 and rf.coll_breakdown == cost.coll
    assert set(dryrun.record(cost, rf, 1.25)) == ROW_KEYS


def test_report_byte_for_byte(tmp_path):
    """The same JSONL gives the reference's table and summary."""
    rows = []
    for i, (arch, shape) in enumerate([("yi-6b", "train_4k"),
                                       ("qwen2-72b", "decode_32k"),
                                       ("yi-6b", "long_500k@sectored")]):
        ref, _ = _rooflines(chips=256 * (1 + i % 2))
        rec = ref.row()
        rec.update(arch=arch, shape=shape, compile_s=1.5, arg_gib=0.5,
                   temp_gib=3.25)
        rows.append(rec)
    path = tmp_path / "rows.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    outs = []
    for mod in (jreport, report):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            mod.main([str(path)])
        outs.append((out.getvalue(), err.getvalue()))
    assert outs[0] == outs[1]
    assert outs[1][0].count("\n") == 2 + len(rows)


def test_hillclimb_puts_globals_back(monkeypatch, tmp_path):
    """Every step runs its variants (lower_cell stubbed) and every global
    it changes is put back, also when a variant fails."""
    from repro_torch.launch import hillclimb
    from repro_torch.runtime import sectored_decode
    monkeypatch.chdir(tmp_path)
    seen = []

    def fake_lower(arch, shape, multi_pod, variant="dense", **kw):
        seen.append((arch, shape, variant, configs.ARCHS[arch],
                     sectored_decode.TOPK_FRAC,
                     dryrun.step_mod.make_train_step))
        cost = roofline.StepCost(1.0, 1.0, 1, 1, dict.fromkeys(
            jroofline._COLLECTIVES, 0))
        return cost, roofline.analyze(cost, arch=arch, shape=shape,
                                      mesh_name="16x16", chips=256,
                                      model_flops=1.0)
    monkeypatch.setattr(dryrun, "lower_cell", fake_lower)
    before = (dict(configs.ARCHS), sectored_decode.TOPK_FRAC,
              dryrun.step_mod.make_train_step)
    for step in ("all", "B2", "A2"):
        hillclimb.main([step])
    assert (dict(configs.ARCHS), sectored_decode.TOPK_FRAC,
            dryrun.step_mod.make_train_step) == before
    tags = [json.loads(line)["variant"] for line in
            (tmp_path / "results" / "hillclimb.jsonl").read_text()
            .splitlines()]
    assert tags == ["baseline", "blocked-attn", "baseline", "share-heads",
                    "baseline", "bf16-einsum", "sectored+share",
                    "topk-1/16", "blocked+mb4"]
    blocked = [s for s in seen if s[3].blocked_attention]
    assert len(blocked) == 2 and blocked[-1][5] is not before[2]
    assert [s[4] for s in seen if s[4] != before[1]] == [1 / 16]

    def boom(*args, **kw):
        raise RuntimeError("variant failed")
    monkeypatch.setattr(dryrun, "lower_cell", boom)
    with pytest.raises(RuntimeError):
        hillclimb.main(["A2"])
    assert (dict(configs.ARCHS), dryrun.step_mod.make_train_step) == (
        before[0], before[2])


# -- the fake mesh ---------------------------------------------------------------


@pytest.mark.parametrize("arch", [
    "yi-6b", "qwen3-moe-235b-a22b", "rwkv6-1.6b", "recurrentgemma-2b",
    "musicgen-large", "qwen2-vl-72b"])
def test_lower_cell_on_a_2x2_fake_mesh(fake_mesh, arch):
    """Every cell of the family lowers with the reference's row keys:
    finite terms, FLOPs and bytes counted, the parameters gathered."""
    assert fake_mesh["backend"] == "fake" and fake_mesh["world"] == 4
    for shape, variant in dryrun.cells_for(arch):
        got = fake_mesh["cells"][(arch, shape)]
        row, cost = got["row"], got["cost"]
        assert set(row) == ROW_KEYS
        assert row["mesh"] == "2x2" and row["chips"] == 4
        assert row["shape"] == (shape if variant == "dense"
                                else f"{shape}@{variant}")
        assert cost["flops"] > 0 and cost["bytes_accessed"] > 0
        assert cost["peak_bytes"] >= cost["arg_bytes"] > 0
        assert cost["coll"]["all-gather"] > 0
        for key in ("t_compute", "t_memory", "t_collective"):
            assert math.isfinite(row[key]) and row[key] >= 0
        if shape == "train_4k":
            assert cost["coll"]["all-reduce"] > 0


def _gather_bytes(shape, spec, itemsize, sizes) -> int:
    block = [n // math.prod(sizes[a] for a in _axes(e))
             for n, e in zip(shape, list(spec) + [None] * len(shape))]
    total = 0
    for d, e in enumerate(list(spec) + [None] * (len(shape) - len(spec))):
        for a in reversed(_axes(e)):
            if sizes[a] > 1:
                block[d] *= sizes[a]
                total += math.prod(block) * itemsize
    return total


def _axes(e) -> tuple:
    return () if e is None else (e if isinstance(e, tuple) else (e,))


@pytest.mark.parametrize("fsdp", [False, True])
def test_collective_bytes_reckoned_from_specs(fake_mesh, fsdp):
    """The 2x2 training cell's parameter traffic by kind equals the sum
    over the parameters from their specs: a gather per use (a layer's
    twice with remat, the rest once) over the axes the leaf's compute
    does not split ('model' stays split where the partitioned program
    splits the leaf's products), a reduce-scatter of the block where a
    leaf is split over 'data', else an all-reduce of its 'model' slice,
    and the f32 scalars (the loss, each leaf's sum of squares); the
    partitioned program's own crossings over 'model' (``comm.tp_bytes``)
    come on top, as all-gathers and all-reduces only (this cell's split
    program gathers nothing: its kv heads divide over 'model')."""
    got = fake_mesh["coll"][fsdp]
    sizes = {"data": 2, "model": 2}
    L = got["n_layers"]
    want = dict.fromkeys(jroofline._COLLECTIVES, 0)
    specs, shapes = got["specs"], got["shapes"]
    for j, (spec, shape, e) in enumerate(zip(specs, shapes,
                                             got["itemsize"])):
        whole = j in got["top"] or (j in got["layer"] and spec[0]
                                    is not None)
        if not whole:
            spec, shape, uses, calls = spec[1:], shape[1:], 2 * L, L
        else:
            uses = calls = 1
        model_part = math.prod(sizes["model"] for x in spec
                               if "model" in _axes(x))
        sliced = math.prod(shape) // model_part * e
        gathered, kept = spec, shape
        if got["split"][j]:  # the rank's 'model' block is the operand
            gathered = tuple(None if x == "model" else x for x in spec)
            kept = tuple(n // sizes["model"] if x == "model" else n
                         for n, x in zip(shape, list(spec) + [None] * (
                             len(shape) - len(spec))))
        want["all-gather"] += uses * _gather_bytes(kept, gathered, e, sizes)
        if any("data" in _axes(x) for x in spec):
            want["reduce-scatter"] += calls * sliced // sizes["data"]
        else:
            want["all-reduce"] += calls * sliced
    want["all-reduce"] += 4 + 4 * len(specs)
    tp = got["tp"]
    assert tp["all-reduce"] > 0
    assert all(tp[k] == 0 for k in tp if k != "all-reduce")
    assert {k: v - tp[k] for k, v in got["coll"].items()} == want


def test_counted_flops_linear_in_layers(fake_mesh):
    depth = fake_mesh["depth"]
    a, b, c = sorted(depth)
    assert depth[c]["flops"] - depth[b]["flops"] == \
        depth[b]["flops"] - depth[a]["flops"] > 0
    for n, d in depth.items():  # the rank counts its data share's rows
        # and its 'model' share of the split products
        assert d["flops"] * 4 >= d["model_flops"], n


def test_fake_flops_equal_the_real_step(fake_mesh):
    assert fake_mesh["fake_flops_1"] == fake_mesh["real_flops_1"] > 0


def test_fake_group_stays_in_the_dry_run(fake_mesh):
    """The dry-run mesh refuses to start over a real group or another fake
    one and is torn down by its maker; the real meshes refuse a fake
    group."""
    assert "holds a 'gloo' group" in fake_mesh["fake_over_real"]
    assert "holds a 'fake' group" in fake_mesh["fake_over_fake"]
    assert "'fake'" in fake_mesh["real_over_fake"]
    assert fake_mesh["torn_down"]


def test_time_loop_extrapolation_is_exact_for_counts():
    """A quadratic through three cut lengths recovers a quadratic count
    exactly (rational arithmetic); the peak and the argument bytes are
    not taken through it."""
    f = lambda n: 7 + 3 * n + 5 * n * n  # noqa: E731
    pts = [16, 32, 48]
    costs = [roofline.StepCost(f(n), 2 * f(n), f(n), 1,
                               {"all-gather": f(n)}) for n in pts]
    got = dryrun.extrapolate(costs, pts, 32768)
    assert got == dict(flops=f(32768), bytes_accessed=2 * f(32768),
                       coll={"all-gather": f(32768)})


@pytest.mark.parametrize("arch,shape", [
    (arch, shape) for arch, shape, _ in proc.LOOP_CELLS])
def test_time_loop_cell_equals_a_direct_trace(fake_mesh, arch, shape):
    """A per-token loop's cell at LOOP_LEN tokens, past the three cut
    lengths, on the 2x2 fake mesh: the dry run's FLOPs, bytes and
    collective bytes (the quadratic) and its peak and argument bytes (the
    loop stand-ins' trace) equal a direct trace's, every token's ops
    traced."""
    got = fake_mesh["time_loop"][(arch, shape)]
    assert got["dryrun"] == got["direct"]
    assert got["direct"]["peak_bytes"] > got["direct"]["arg_bytes"] > 0
