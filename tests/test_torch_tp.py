"""The partitioned layer program over 'model' (``repro_torch.parallel.
tensor``), multi-rank on gloo on the CPU, against the unsplit program
and the JAX reference's own partitioned step.

One spawn of 2 ranks (``1x2``) and one of 4 (``2x2``) run every case
(``tests/_torch_tp_ranks.py``); this process runs the unsplit calls and
compares:

* each landing case (vocab rows, heads, kv heads, a hybrid's ``wk`` on
  ``d`` and on ``hd``, split and whole FFNs, experts, the RG-LRU, RWKV
  with ``wo`` on its layer axis and on its input rows, a decode step)
  against its unsplit call, in f32 so that the tolerance speaks of the
  order of a split sum: the output within LAYER_TOL of its largest
  magnitude (measured: at most 4.0e-7), bitwise where only data crosses
  ranks (EXACT: the embedding, gathered logits, the MoE layer with
  gathered expert outputs, a whole FFN); every gradient, its split
  leaves' blocks put together, within LAYER_TOL (measured: at most
  5.0e-7);
* every rank of a 'model' group holds the same bits of the output, the
  input's gradient, the loss, the final hidden states and every leaf
  whole over 'model' after two steps; two runs give the same bits;
* each rank's counted FLOPs (``FlopCounterMode``) equal the count its
  landings imply (``tensor.step_flops``) exactly; for the tiny yi-6b
  that is heads, ``wo``, the attention core and ``lm_head`` over the
  'model' size, the stacked FFN and ``wk``/``wv`` (on their layer axis)
  whole; at full width, a fake 1x2 / 1x4 step of the dry run agrees;
* ``make_prefill_step`` / ``make_decode_step`` on the mesh against the
  unsplit prefill and decode step (LAYER_TOL), the decode step's state
  placed by its own specs (the K/V sequence split over 'model') and its
  new state compared block by block;
* the port's 1x2 step against the reference's ``make_train_step(cfg,
  mesh)`` jitted with its shardings on a (1, 2) JAX mesh in a process of
  its own (``tests/_torch_tp_reference.py``): loss and gradients within
  REF_TOL (f32 witness and bf16; measured: loss 0 and 2.7e-4, gradients
  3.9e-7 and 6.9e-3 of their largest magnitude), and the clip's global
  norm on the rank's blocks equal to the gathered gradients' norm.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import _torch_tp_ranks as ranks
from _torch_port import one_torch_thread  # noqa: F401  (autouse)
from repro_torch import bridge, configs
from repro_torch.models import model
from repro_torch.optim import adamw
from repro_torch.parallel import sharding, tensor
from repro_torch.runtime.graphs import leaves
from repro_torch.train import step as train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = list(ranks.MESHES.values())
#: outputs only data crosses ranks for: bitwise the unsplit call
EXACT = {"embed", "logits", "logits-tied", "moe", "swiglu-whole"}
#: largest error over the largest magnitude, by the case's dtype
LAYER_TOL = {torch.float32: 2e-6, torch.bfloat16: 1e-2}
#: the training parity tolerances (tests/test_torch_train_mesh.py)
REF_TOL = {"float32": (2e-6, 2e-6), "bfloat16": (2e-3, 0.05)}
#: the split bf16 step's loss against the unsplit step's (measured: at
#: most 3.5e-3, the MoE stack, where a rounding flips an expert)
STEP_LOSS_TOL = 5e-3


def bits(t: torch.Tensor) -> np.ndarray:
    return bridge.tensor_to_numpy_bits(t.reshape(-1))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(bits(a), bits(b)))


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max()) / (float(a.abs().max()) or 1.0)


@pytest.fixture(scope="module")
def runs():
    """spec -> every rank's results."""
    out = {}
    for world, spec in ranks.MESHES.items():
        with tempfile.TemporaryDirectory() as d:
            out[spec] = ranks.spawn_tp(world, d, timeout=400)
    return out


def assembled(per_rank: list, i: int) -> torch.Tensor:
    """Operand ``i``'s gradient put together: its split leaves' blocks
    concatenated in 'model' order, a whole leaf's from rank 0."""
    land = per_rank[0]["lands"][i]
    by_index = {}
    for r in per_rank:
        by_index.setdefault(r["model_index"], r["grads"][i])
    if not land.split:
        return by_index[0]
    return torch.cat([by_index[k] for k in sorted(by_index)], land.dim)


@pytest.mark.parametrize("case", list(ranks.LAYER_CASES))
@pytest.mark.parametrize("spec", SPECS)
def test_layer_case(runs, spec, case):
    per_rank = [r[("layer", case)] for r in runs[spec]]
    ref = ranks.reference_call(case)
    for r in per_rank[1:]:
        assert same_bits(per_rank[0]["out"], r["out"])
        if ref["gx"] is not None:
            assert same_bits(per_rank[0]["gx"], r["gx"])
        for i, land in enumerate(r["lands"]):
            if not land.split and r["grads"][i] is not None:
                assert same_bits(per_rank[0]["grads"][i], r["grads"][i]), i
    got = per_rank[0]
    tol = LAYER_TOL[ref["out"].dtype]
    if case in EXACT:
        assert same_bits(ref["out"], got["out"])
    err = rel(ref["out"], got["out"])
    assert err <= tol, err
    worst = 0.0
    if ref["gx"] is not None:
        worst = rel(ref["gx"], got["gx"])
    for i, g in enumerate(ref["grads"]):
        if g is not None:
            worst = max(worst, rel(g, assembled(per_rank, i)))
    assert worst <= tol, worst
    print(f"{spec} {case}: output {err:.3g}, gradients {worst:.3g}")


def _groups(per_rank: list) -> list:
    """The ranks of each 'model' group (one data coordinate each)."""
    groups = {}
    for r in per_rank:
        key = tuple(v for a, v in sorted(r["coords"].items()) if a != "model")
        groups.setdefault(key, []).append(r)
    return list(groups.values())


@pytest.mark.parametrize("spec", SPECS)
def test_identical_ranks(runs, spec):
    """Every rank of a 'model' group: the same loss, final hidden states
    and blocks of every leaf 'model' leaves replicated (the norms), bit
    for bit, after two steps; the global state the same on every
    rank."""
    for case in ranks.STEP_CASES:
        per_rank = [r[("step", case)][0] for r in runs[spec]]
        for group in _groups(per_rank):
            a = group[0]
            for b in group[1:]:
                assert all(same_bits(x, y) for x, y in zip(
                    a["losses"], b["losses"]))
                assert same_bits(a["hidden"], b["hidden"])
                for i, whole in enumerate(a["replicated"]):
                    if whole:
                        assert same_bits(a["local"][i], b["local"][i]), i
        for b in per_rank[1:]:
            assert all(same_bits(x, y) for x, y in zip(
                per_rank[0]["state"], b["state"]))


def test_two_runs_same_bits(runs):
    for spec in SPECS:
        for case in ranks.STEP_CASES:
            for r in runs[spec]:
                first, again = r[("step", case)]
                assert all(same_bits(x, y) for x, y in zip(
                    first["losses"] + first["state"],
                    again["losses"] + again["state"]))


def test_split_step_near_unmeshed(runs):
    """The split step's losses against the unsplit step's (microbatch =
    the data ranks), the gap printed."""
    for spec in SPECS:
        d = int(spec.split("x")[0])
        for case, (arch, _) in ranks.STEP_CASES.items():
            cfg = ranks.step_cfg(arch)
            ocfg = ranks.opt_cfg(False, 1e6)
            params = model.init_params(cfg, seed=0, device="cpu")
            fn, _, _ = train_step.make_train_step(cfg, opt_cfg=ocfg,
                                                  microbatch=d)
            p, o, want = params, adamw.init_state(params, ocfg), []
            for step in range(2):
                p, o, m = fn(p, o, ranks.batch(step))
                want.append(float(m["loss"]))
            got = [float(x) for x in runs[spec][0][("step", case)][0]
                   ["losses"]]
            gap = max(abs(a - b) for a, b in zip(want, got))
            print(f"{spec} {case}: loss gap {gap:.3g}")
            assert gap <= STEP_LOSS_TOL


@pytest.mark.parametrize("spec", SPECS)
def test_counted_flops_equal_the_landings(runs, spec):
    m = int(spec.split("x")[1])
    for case in ranks.STEP_CASES:
        for r in runs[spec]:
            got = r[("step", case)][0]
            assert got["flops"] == got["implied"], (case, got["flops"],
                                                    got["implied"])
    # the tiny yi-6b by hand: heads, wo, the core and lm_head over m; the
    # stacked FFN and wk/wv ('model' on their layer axis) whole; a layer's
    # products 4 times (forward, recompute, two backward) but the down
    # projection's recompute (nothing saves its output), lm_head 3 times
    cfg = configs.get("yi-6b").reduced(**ranks.TINY)
    got = runs[spec][0][("step", "yi-6b")][0]
    b, s = got["rows"], 16
    t, d, hd, f = b * s, cfg.d_model, cfg.head_dim_, cfg.d_ff
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    layer = (2 * t * d * H * hd // m + 2 * 2 * t * d * Hkv * hd
             + 2 * 2 * b * (H // m) * s * s * hd + 2 * t * H * hd * d // m
             + 3 * 2 * t * d * f)
    want = cfg.n_layers * (4 * layer - 2 * t * f * d) + (
        3 * 2 * t * d * cfg.vocab // m)
    assert got["flops"] == want


def test_prefill_and_decode_steps(runs):
    """``make_prefill_step`` / ``make_decode_step`` on a DeviceMesh run
    the partitioned program on the rank's blocks, for a uniform stack
    (kv heads split), a hybrid and RWKV: the rank's logits (gathered
    whole) and prefill state, then one decode step on that state placed
    by the decode step's own state specs (the K/V sequence split over
    'model'): its logits and every block of its new state, the new K/V
    row written into the rank's block where it falls, within LAYER_TOL
    of the unsplit prefill and decode step on its rows (f32; a state
    leaf within the tolerance of its own dtype)."""
    tol = LAYER_TOL[torch.float32]
    for case, (arch, over) in ranks.SERVE_CASES.items():
        cfg = ranks.case_cfg(arch, over)
        params = model.init_params(cfg, seed=0, device="cpu")
        tokens = ranks.inputs("embed", cfg)["tokens"]
        for spec in SPECS:
            for r in runs[spec]:
                got = r[("serve", case)]
                with torch.no_grad():
                    logits, state = model.prefill(params, cfg,
                                                  tokens[got["rows"]])
                    whole = [t.clone() for t in leaves(state)]
                    step, new = model.decode_step(
                        params, cfg, state, tokens[got["rows"]][:, :1])
                assert rel(logits, got["prefill"]) <= tol, (case, spec)
                assert rel(step, got["decode"]) <= tol, (case, spec)
                # a state leaf by its own dtype (RWKV's token-shift rows
                # are bf16 in an f32 config)
                for want, have in zip(whole, got["state"], strict=True):
                    assert rel(want, have) <= LAYER_TOL.get(
                        want.dtype, tol), (case, spec)
                for want, index, have in zip(leaves(new), got["index"],
                                             got["after"], strict=True):
                    assert rel(want[index], have) <= LAYER_TOL.get(
                        want.dtype, tol), (case, spec)


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    out = {}
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]),
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
        JAX_PLATFORMS="cpu")
    for dtype in REF_TOL:
        path = str(tmp_path_factory.mktemp("ref") / f"{dtype}.npz")
        subprocess.run([sys.executable, os.path.join(
            ROOT, "tests", "_torch_tp_reference.py"), dtype, path], env=env,
            check=True, timeout=300)
        with np.load(path) as z:
            out[dtype] = dict(loss=float(z["loss"]),
                              step_loss=float(z["step_loss"]),
                              grads=[z[f"g{i}"] for i in range(
                                  len(z.files) - 2)])
    return out


@pytest.mark.parametrize("dtype", list(REF_TOL))
def test_one_by_two_matches_reference(runs, jax_reference, dtype):
    loss_tol, grad_tol = REF_TOL[dtype]
    want = jax_reference[dtype]
    gmax = max(np.abs(g).max() for g in want["grads"])
    for r in runs["1x2"]:
        got = r[("ref", dtype)]
        assert abs(float(got["loss"]) - want["loss"]) <= loss_tol
        assert abs(float(got["step_loss"]) - want["step_loss"]) <= loss_tol
        assert len(got["grads"]) == len(want["grads"])
        err = max(np.abs(a - b.float().numpy()).max()
                  for a, b in zip(want["grads"], got["grads"]))
        assert err <= grad_tol * gmax, err / gmax
        # the clip's norm on the rank's blocks counts each distinct block
        # once: the norm of the gathered gradients
        whole = float(adamw.global_norm([x.float() for x in got["grads"]]))
        assert abs(float(got["gnorm"]) - whole) <= 1e-6 * whole
        gap = abs(float(got["loss"]) - want["loss"])
        print(f"{dtype}: loss gap {gap:.3g}, gradients {err / gmax:.3g}")


def _lands(arch, shape, fsdp=False, n_layers=None, **over):
    """The landing tree of ``arch`` (``over``: a reduced config) on a
    ``shape`` mesh, and its config."""
    cfg = configs.get(arch)
    if over:
        cfg = cfg.reduced(**over)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    shapes = sharding.abstract(model.init_params, cfg, device="cpu")
    mesh = sharding.MeshShape(shape, ("data", "model"))
    return sharding.landings(shapes, sharding.param_shardings(
        mesh, shapes, fsdp=fsdp)), cfg


def test_full_width_landings_and_flops(tmp_path):
    """Where 'model' lands at full width (the spec decides): yi-6b's
    wk/wv on kv heads at 1x2 and 1x4 and on the layer axis at 16x16, its
    stacked FFN on the layer axis everywhere; qwen3-moe's wk on hd at
    16x16; RWKV's wo on the layer axis (tiny) and on its input rows at
    16x16; a hybrid's per-layer wk on d, or hd with fsdp. Then one fake
    step of the dry run at full width on 1x2 and 1x4 counts the FLOPs
    the landings imply, exactly."""
    def at(lands, *path):
        for key in path:
            lands = lands[key]
        return (lands.kind, lands.dim)

    for shape in ((1, 2), (1, 4)):
        lands = _lands("yi-6b", shape)[0]
        assert at(lands, "layers", "attn", "wk") == ("output", 1)
        assert at(lands, "layers", "mlp", "w_gate")[0] == "layer"
    lands = _lands("yi-6b", (16, 16))[0]
    assert at(lands, "layers", "attn", "wk")[0] == "layer"
    assert at(lands, "layers", "mlp", "w_down")[0] == "layer"
    lands = _lands("qwen3-moe-235b-a22b", (16, 16), fsdp=True)[0]
    assert at(lands, "layers", "attn", "wk") == ("output", 2)
    assert at(lands, "layers", "moe", "w_gate") == ("output", 0)
    assert at(_lands("rwkv6-1.6b", (1, 2), **ranks.TINY)[0], "layers",
              "tmix", "wo")[0] == "layer"
    assert at(_lands("rwkv6-1.6b", (16, 16))[0], "layers", "tmix",
              "wo") == ("contraction", 0)
    for fsdp, want in ((False, ("contraction", 0)), (True, ("output", 2))):
        lands = _lands("recurrentgemma-2b", (1, 2), fsdp=fsdp,
                       **dict(ranks.TINY, n_layers=3))[0]
        assert at(lands, "layers", 2, "attn", "wk") == want
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    for spec, shape in (("1x2", (1, 2)), ("1x4", (1, 4))):
        out = tmp_path / f"{spec}.jsonl"
        subprocess.run([
            sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
            "yi-6b", "--shape", "train_4k", "--spec", spec, "--n-layers",
            "1", "--seq-len", "32", "--global-batch", "1", "--out",
            str(out)], env=env, check=True, timeout=300,
            capture_output=True)
        row = json.loads(out.read_text().splitlines()[0])
        lands, cfg = _lands("yi-6b", shape, n_layers=1)
        want = tensor.step_flops(cfg, tensor.TP(None, shape[1], 0, lands),
                                 1, 32)
        assert row["hlo_flops_total"] == want * row["chips"], spec
