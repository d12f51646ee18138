"""The sectored decode step's partitioned program over 'model'
(``runtime.sectored_decode.make_sectored_decode_step`` on a DeviceMesh),
multi-rank on gloo on the CPU, against the unsplit step and the JAX
reference's own partitioned step.

One spawn of 2 ranks (``1x2``) and one of 4 (``2x2``) run every case
(``tests/_torch_tp_sectored_ranks.py``): whole kv heads on a rank, a kv
head whose query heads straddle the ranks, and the long-context layout
(pages over every rank); three steps with the probe on from a state made
from a numpy seed. This process runs the unmeshed step and compares:

* a one-rank mesh (in-process) against the unmeshed step, bitwise, in
  every kernel flavor;
* every rank of a 'model' group holds the same bits of the logits, the
  table, the lengths and the position after each step;
* every page selection equals the unmeshed step's exactly (where one
  parts, the test names the step, layer, row and kv head, and the
  unsplit table's score gap between the two pages);
* the logits within LOGIT_TOL of the unmeshed step's largest magnitude
  and the table within TABLE_TOL (measured: logits at most 4.6e-5 with
  whole kv heads on a rank, 2.7e-4 with a straddled kv head; table at
  most 5.4e-7). The table is not bitwise the unsplit step's: layer 0's
  is, where a rank holds whole kv heads (its attend reads the unsplit
  inputs), but the split ``wo`` sum rounds the hidden state otherwise,
  and the later layers read it; a straddled kv head's mass, the sum
  over 'model' of each rank's part, parts from layer 0's too. No
  selection parted over the 3 steps;
* each rank's counted FLOPs (``FlopCounterMode``) equal
  ``tensor.sectored_step_flops`` exactly;
* the collective bytes of a step against the gathered form's;
* the port's 1x2 step against the reference's
  ``make_sectored_decode_step(cfg, mesh)`` jitted with its shardings on
  a (1, 2) JAX mesh in a process of its own
  (``tests/_torch_tp_sectored_reference.py``): logits and table within
  REF_TOL (measured: 2.8e-5 and 9.5e-7), lengths and position equal;
* the dry run's ``long_500k@sectored`` rank program at a tiny width,
  whose FLOPs equal the count.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_tp_sectored_ranks as ranks
from _torch_port import one_torch_thread  # noqa: F401  (autouse)
from repro_torch import bridge, configs
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import model
from repro_torch.parallel import sharding, tensor
from repro_torch.runtime import sectored_decode as sd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = list(ranks.MESHES.values())
RUNS = [(case, kernel) for case, (_, _, flavors) in ranks.CASES.items()
        for kernel in flavors]
#: the split step's logits against the unsplit step's, over the largest
#: magnitude. The weights are f32 but the cache and the attend's query
#: are bf16, so a split sum's other rounding of the hidden state can flip
#: a bf16 rounding of a K/V row or a query (2**-8 relative)
LOGIT_TOL = 5e-4
#: table entries (EMA masses in [0, 1]) against the unsplit step's
TABLE_TOL = 2e-5
#: against the reference's partitioned step: (logits over the largest
#: magnitude, table entries), the same scales
REF_TOL = (LOGIT_TOL, TABLE_TOL)


def bits(t: torch.Tensor) -> np.ndarray:
    return bridge.tensor_to_numpy_bits(t.reshape(-1))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(bits(a), bits(b)))


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max()) / (float(a.abs().max()) or 1.0)


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The reference's and the dry run's subprocesses, started first so
    that they run beside the spawned ranks: name -> (process, output)."""
    out = tmp_path_factory.mktemp("sub")
    src = os.path.join(ROOT, "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src, os.path.join(ROOT, "tests")]), JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=2")
    procs = dict(
        ref=(subprocess.Popen([sys.executable, os.path.join(
            ROOT, "tests", "_torch_tp_sectored_reference.py"), str(out)],
            env=env), out),
        dryrun=(subprocess.Popen([
            sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
            "yi-6b", "--reduced", "--shape", "long_500k", "--variant",
            "sectored", "--spec", "1x2", "--seq-len", "1000", "--out",
            str(out / "row.jsonl")], env=dict(os.environ, PYTHONPATH=src),
            stdout=subprocess.DEVNULL), out / "row.jsonl"))
    yield procs
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def finished(started, name: str):
    """The output of a started subprocess, once it has exited 0."""
    proc, out = started[name]
    assert proc.wait(timeout=300) == 0, name
    return out


@pytest.fixture(scope="module")
def runs(started):
    """spec -> every rank's results."""
    out = {}
    for world, spec in ranks.MESHES.items():
        with tempfile.TemporaryDirectory() as d:
            out[spec] = ranks.spawn_sectored(world, d)
    return out


@pytest.fixture(scope="module")
def unmeshed():
    """(case, kernel, probe) -> the unsplit step's run."""
    out = {(c, k, True): ranks.unmeshed_run(c, k) for c, k in RUNS}
    for case in ("kv-heads", "straddle"):
        out[(case, "dispatch", False)] = ranks.unmeshed_run(
            case, "dispatch", probe=False)
    return out


def rank_view(step: dict, rows: slice) -> dict:
    """The unmeshed step's state cut to a rank's rows."""
    return dict(logits=step["logits"][rows], table=step["table"][:, rows],
                length=step["length"][:, rows],
                position=step["position"][rows])


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A one-rank gloo process group for the in-process mesh."""
    if dist.is_initialized():
        yield
        return
    store = str(tmp_path_factory.mktemp("store") / "store")
    dist.init_process_group("gloo", store=dist.FileStore(store, 1), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("kernel", ("dispatch", "fused", "fused_q8"))
def test_one_rank_mesh_is_bitwise_unmeshed(one_rank, unmeshed, kernel):
    """On a one-rank ``1x1`` mesh every crossing is the identity and the
    page shard holds every page: logits, table, lengths, position and
    selections bitwise the unmeshed step's, the straddling config too."""
    mesh = mesh_mod.make_serving_mesh("1x1", device="cpu")
    for case in ("kv-heads", "straddle"):
        got = ranks.mesh_run(case, kernel, mesh)
        want = (unmeshed[(case, kernel, True)] if kernel == "dispatch"
                or case == "kv-heads" else ranks.unmeshed_run(case, kernel))
        for a, b in zip(want["steps"], got["steps"], strict=True):
            for key in a:
                assert same_bits(a[key], b[key]), (case, key)
        assert all(torch.equal(a, b) for a, b in zip(
            want["selections"], got["selections"], strict=True))
        assert got["flops"] == got["implied"]


def _groups(per_rank: list) -> list:
    groups = {}
    for r in per_rank:
        key = tuple(v for a, v in sorted(r["coords"].items()) if a != "model")
        groups.setdefault(key, []).append(r)
    return list(groups.values())


@pytest.mark.parametrize("spec", SPECS)
def test_identical_ranks(runs, spec):
    """Every rank of a 'model' group holds the same logits, table,
    lengths and position, bit for bit, after each of 3 steps with the
    probe on."""
    for run in RUNS:
        for group in _groups([r[run] for r in runs[spec]]):
            a = group[0]
            for b in group[1:]:
                for x, y in zip(a["steps"], b["steps"], strict=True):
                    for key in x:
                        assert same_bits(x[key], y[key]), (run, key)


def _parting(want: dict, got: dict, step: int, rows: slice) -> str:
    """Where the selections of a step part: the first layer, row and kv
    head, and the unsplit table's score gap between the pages that
    swap."""
    sels_w, sels_g = want["selections"], got["selections"]
    L = len(sels_w) // ranks.STEPS
    for layer in range(L):
        a = sels_w[step * L + layer][rows]
        b = sels_g[step * L + layer]
        if not torch.equal(a, b):
            i = torch.nonzero(a != b)[0].tolist()
            table = (want["steps"][step - 1]["table"][layer][rows]
                     if step else None)
            pa, pb = int(a[tuple(i)]), int(b[tuple(i)])
            gap = (float(table[i[0], i[1], pa] - table[i[0], i[1], pb])
                   if table is not None else float("nan"))
            return (f"step {step} layer {layer} row {i[0]} head {i[1]}: "
                    f"page {pa} vs {pb}, score gap {gap:.3g}")
    return ""


@pytest.mark.parametrize("spec", SPECS)
def test_selections_equal_unmeshed(runs, unmeshed, spec):
    """Every page selection of every rank, layer and step equals the
    unmeshed step's on the rank's rows."""
    for run in RUNS:
        want = unmeshed[(*run, True)]
        for r in runs[spec]:
            got = r[run]
            assert len(got["selections"]) == len(want["selections"])
            for step in range(ranks.STEPS):
                parted = _parting(want, got, step, got["rows"])
                assert not parted, (run, parted)


@pytest.mark.parametrize("spec", SPECS)
def test_near_unmeshed(runs, unmeshed, spec):
    """Logits within LOGIT_TOL and the table within TABLE_TOL of the
    unmeshed step's, lengths and position equal. Where each rank holds
    whole kv heads, layer 0's table stays bitwise the unsplit one (its
    attend reads the unsplit inputs and sums each kv head's mass on one
    rank); the later layers read a hidden state that the split output
    projection's sum rounds otherwise. Where a kv head's query heads
    straddle ranks, its mass is the sum over 'model' of the ranks' parts
    (another order), and whether layer 0 stays bitwise is printed."""
    for run in RUNS:
        want = unmeshed[(*run, True)]
        worst, table_err, first_bitwise = 0.0, 0.0, True
        for r in runs[spec]:
            got = r[run]
            for w, g in zip(want["steps"], got["steps"], strict=True):
                w = rank_view(w, got["rows"])
                worst = max(worst, rel(w["logits"], g["logits"]))
                assert torch.equal(w["length"], g["length"])
                assert torch.equal(w["position"], g["position"])
                first_bitwise &= same_bits(w["table"][0], g["table"][0])
                table_err = max(table_err, float(
                    (w["table"] - g["table"]).abs().max()))
        print(f"{spec} {run}: logits {worst:.3g}, table {table_err:.3g}, "
              f"layer 0's table bitwise: {first_bitwise}")
        assert worst <= LOGIT_TOL, (run, worst)
        assert table_err <= TABLE_TOL, (run, table_err)
        if run[0] != "straddle":
            assert first_bitwise, run


@pytest.mark.parametrize("spec", SPECS)
def test_counted_flops_equal_the_count(runs, spec):
    """``FlopCounterMode`` of a step equals ``sectored_step_flops``: the
    projections, FFN and logits split as their leaves land, the core over
    the rank's query heads and the selected pages (none for the fused
    flavors, whose core is the kernel); for the kv-heads case by hand."""
    m = int(spec.split("x")[1])
    for run in RUNS:
        for r in runs[spec]:
            assert r[run]["flops"] == r[run]["implied"], run
    cfg = ranks.case_cfg("kv-heads")
    got = runs[spec][0][("kv-heads", "dispatch")]
    b = got["rows"].stop - got["rows"].start
    d, hd, H, Hkv, f = (cfg.d_model, cfg.head_dim_, cfg.n_heads,
                        cfg.n_kv_heads, cfg.d_ff)
    reads = (ranks.K_PAGES + 1) * sd.PAGE_SIZE
    layer = (2 * b * d * H * hd // m + 2 * 2 * b * d * Hkv * hd // m
             + 2 * 2 * b * (H // m) * reads * hd + 2 * b * H * hd * d // m
             + 3 * 2 * b * d * f)
    assert got["flops"] == cfg.n_layers * layer + 2 * b * d * cfg.vocab // m


def test_collective_bytes_split_and_gathered(runs):
    """The collective bytes of a step: the split program moves the
    selected pages of the rank's kv heads (an all-to-all) and its
    crossings over 'model'; the gathered form it replaces moved every kv
    head's pages (an all-gather) and every layer's parameters. Where a
    rank holds whole kv heads the pages move 1 / 'model' of the bytes."""
    cfg = ranks.case_cfg("kv-heads")
    for spec in SPECS:
        m = int(spec.split("x")[1])
        for run in RUNS:
            r = runs[spec][0][run]
            if r["gathered"] is None:
                continue
            split = {k: v for k, v in r["calls"]["bytes"].items() if v}
            gathered = {k: v for k, v in r["gathered"].items() if v}
            print(f"{spec} {run}: split {split}, gathered {gathered}")
            assert r["calls"]["tp"] > 0 and r["calls"]["wave"] > 0
            assert sum(split.values()) < sum(gathered.values()), run
            if run[0] == "kv-heads":
                b = r["rows"].stop - r["rows"].start
                # every kv head's selected pages from each rank, K and V,
                # a layer (bf16)
                pages = (cfg.n_layers * 2 * m * b * cfg.n_kv_heads
                         * (ranks.K_PAGES + 1) * sd.PAGE_SIZE
                         * cfg.head_dim_ * 2)
                assert gathered["all-gather"] > pages
                assert split["all-to-all"] * m == pages


def test_fused_refuses_a_straddled_kv_head(runs):
    """The paged kernel's mass is normalised over the query heads it is
    given, so the fused flavors refuse a rank holding part of a kv head's
    query heads."""
    for r in runs["1x2"]:
        assert "needs whole kv heads" in r["refused"]


@pytest.fixture(scope="module")
def jax_reference(started):
    out = finished(started, "ref")
    ref = {}
    for case in ("kv-heads", "straddle"):
        with np.load(out / f"{case}.npz") as z:
            ref[case] = {k: z[k] for k in z.files}
    return ref


@pytest.mark.parametrize("case", ("kv-heads", "straddle"))
def test_one_by_two_matches_reference(runs, unmeshed, jax_reference, case):
    """The port's 1x2 step (probe off, dispatch: the reference factory's
    step) against the reference's on a (1, 2) JAX mesh: logits and table
    within REF_TOL, lengths and position equal; the unmeshed port step's
    own gap printed beside."""
    want = jax_reference[case]
    logit_tol, table_tol = REF_TOL
    for r in runs["1x2"]:
        got = r[("ref", case)]
        for s, g in enumerate(got["steps"]):
            wl = torch.from_numpy(want[f"logits{s}"])
            err = rel(wl, g["logits"])
            table = float(np.abs(want[f"table{s}"] - g["table"].numpy())
                          .max())
            own = rel(wl, unmeshed[(case, "dispatch", False)]["steps"][s]
                      ["logits"])
            print(f"{case} step {s}: logits {err:.3g} (unmeshed {own:.3g}),"
                  f" table {table:.3g}")
            assert err <= logit_tol and table <= table_tol, (s, err, table)
            assert np.array_equal(want[f"length{s}"], g["length"].numpy())
            assert np.array_equal(want[f"position{s}"],
                                  g["position"].numpy())


def test_dryrun_long_500k_sectored_runs_the_split_program(started):
    """The dry run's long_500k@sectored rank program (the split step on
    pages over every rank, no probe) at a tiny width on a 1x2 fake mesh:
    its FLOPs equal ``sectored_step_flops`` of the rank, which holds the
    whole batch, its core over its query heads and the budget's pages;
    the pages cross ranks in an all-to-all."""
    row = json.loads(finished(started, "dryrun").read_text()
                     .splitlines()[0])
    cfg = configs.get("yi-6b").reduced()
    params = sharding.abstract(model.init_params, cfg, device="cpu")
    mesh = sharding.MeshShape((1, 2), ("data", "model"))
    tp = tensor.TP(None, 2, 0, sharding.landings(
        params, sharding.param_shardings(mesh, params)))
    want = tensor.sectored_step_flops(
        cfg, tp, configs.SHAPES["long_500k"].global_batch,
        sd.topk_for(1000) * sd.PAGE_SIZE)
    assert row["hlo_flops_total"] == want * row["chips"]
    assert row["coll"]["all-to-all"] > 0
