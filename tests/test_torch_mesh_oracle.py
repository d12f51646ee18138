"""The port's cross-mesh oracle, multi-rank on gloo: token streams,
logprobs and per-request joules are ``==`` across mesh shapes (1,),
(2, 1), (1, 2) and (2, 2) and the unmeshed session, greedy and sampled,
fused against dispatch, under FIFO and overlap.

One spawn per world size (2 ranks for (2, 1) and (1, 2), 4 for (2, 2))
runs every case (``tests/_torch_mesh_ranks.py``), each rank a process as
``torchrun`` would start; this process runs the unmeshed sessions and
compares every rank's streams with them. The (1,) mesh is the in-process
anchor of ``tests/test_torch_mesh.py``. The reference's (4, 2) shape
needs 8 ranks and is left out for time (its rules are compared spec for
spec on (4, 2) in ``test_torch_mesh.py``, and (2, 2) splits both axes).
The wave buffer's per-rank blocks are held to the reference's
``wave_state_shardings`` on the same shapes.
"""

import tempfile

import jax
import numpy as np
import pytest

import _torch_mesh_ranks as ranks
from _torch_port import one_torch_thread  # noqa: F401  (autouse)
from repro import configs as jconfigs
from repro.parallel import sharding as jsharding
from repro.runtime import sectored_decode as jsd
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import model
from repro_torch.parallel import sharding
from repro_torch.runtime import sectored_decode

SPECS = [spec for world in (2, 4) for spec in ranks.MESHES[world]]


@pytest.fixture(scope="module")
def unmeshed():
    """The unmeshed session of every case (fused cases: dispatch)."""
    cfg = ranks.small_cfg()
    params = model.init_params(cfg, seed=0, device="cpu")
    return {case: ranks.run_session(cfg, params,
                                    **dict(kw, kernel="dispatch"))
            for case, kw in ranks.CASES.items()}


@pytest.fixture(scope="module")
def meshed():
    """(spec, case) -> every rank's result."""
    out = {}
    for world in (2, 4):
        with tempfile.TemporaryDirectory() as d:
            per_rank = ranks.spawn_oracle(world, d, timeout=240)
        for key in per_rank[0]:
            out[key] = [r[key] for r in per_rank]
    return out


@pytest.mark.parametrize("case", list(ranks.CASES) + ["metered-outside"])
@pytest.mark.parametrize("spec", SPECS)
def test_streams_and_joules_equal_unmeshed(unmeshed, meshed, spec, case):
    """Every rank's session equals the unmeshed one: tokens, logprobs and
    joules ``==`` (fused on the mesh against unmeshed dispatch), stats
    equal, the mesh stamped on the meter."""
    ref = unmeshed["greedy-overlap" if case == "metered-outside" else case]
    shape, _ = mesh_mod.parse_mesh_shape(spec)
    for rank, got in enumerate(meshed[(spec, case)]):
        assert got["done"], rank
        assert got["tokens"] == ref["tokens"], (rank, "tokens")
        assert got["logprobs"] == ref["logprobs"], (rank, "logprobs")
        assert got["joules"] == ref["joules"], (rank, "joules")
        assert got["stats"] == ref["stats"], rank
        assert got["mesh_shape"] == shape


def test_cases_are_not_vacuous(unmeshed):
    """The overlap cases overlap prefills, the sampled ones sample, and
    the fused ones run narrow steps."""
    for case in ("greedy-overlap", "fused-overlap", "indivisible"):
        assert unmeshed[case]["stats"]["overlapped_prefills"] >= 1, case
    for case in ("sampled-fifo", "greedy-fifo", "fused-fifo"):
        assert unmeshed[case]["stats"]["sectored_steps"] > 0, case
    sampled, greedy = unmeshed["sampled-fifo"], unmeshed["greedy-fifo"]
    assert any(sampled["tokens"][r] != greedy["tokens"][r] for r in (1, 3))


@pytest.mark.parametrize("spec", SPECS)
def test_prefill_runs_on_the_last_rank(meshed, spec):
    """The donor is the mesh's last rank, and only it runs the inner
    prefill."""
    results = meshed[(spec, "greedy-overlap")]
    world = len(results)
    for rank, got in enumerate(results):
        assert got["donor_rank"] == world - 1
        assert (got["prefills"] > 0) == (rank == world - 1), rank


@pytest.mark.parametrize("spec", SPECS)
def test_wave_blocks_match_reference_shardings(meshed, spec):
    """Each rank's block of the wave buffer has the shape the reference's
    ``wave_state_shardings`` gives that rank on the same global shapes:
    the slot axis over 'data', the KV pages over 'model'; an
    indivisible slot axis degrades to replicated (every rank all slots)
    while the pages stay split."""
    shape, axes = mesh_mod.parse_mesh_shape(spec)

    class FakeMesh:
        axis_names = axes
        devices = np.zeros(shape)

    cfg = ranks.small_cfg()
    jcfg = jconfigs.get("yi-6b").reduced(**ranks.SMALL)
    for case in ("greedy-fifo", "indivisible"):
        slots = ranks.CASES[case].get("max_batch", 8)
        state = sharding.abstract(sectored_decode.init_state, cfg, slots, 48,
                                  device="cpu")
        row = jax.eval_shape(lambda: jsd.init_state(jcfg, 1, 48))
        stacked = jax.tree.map(
            lambda x: jax.ShapeDtypeStruct((slots,) + x.shape, x.dtype), row)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jsharding, "NamedSharding", lambda mesh, s: s)
            jspecs = jax.tree_util.tree_leaves(
                jsharding.wave_state_shardings(FakeMesh(), stacked),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        for rank, got in enumerate(meshed[(spec, case)]):
            coords = got["coords"]
            for (name, t, axis), jspec, x, local in zip(
                    sharding.slot_leaves(state), jspecs,
                    jax.tree_util.tree_leaves(stacked),
                    got["local_shapes"]):
                # the reference's block of the stacked leaf, moved into
                # the port's layout (slot axis = the row's batch axis)
                block = [n // _parts(e, shape, axes) for n, e in zip(
                    x.shape, list(jspec) + [None] * x.ndim)]
                if axis == 0:
                    want = (block[0],) + tuple(block[2:])
                else:
                    want = (block[1], block[0]) + tuple(block[3:])
                assert tuple(local) == want, (rank, name, jspec)
            n_data = dict(zip(axes, shape))["data"]
            divisible = slots % n_data == 0
            lo, hi = got["slots"]
            assert (hi - lo) == (slots // n_data if divisible else slots)
            if divisible:
                assert lo == coords["data"] * (slots // n_data)


def _parts(entry, shape, axes) -> int:
    sizes = dict(zip(axes, shape))
    names = () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))
    return int(np.prod([sizes[a] for a in names]))
