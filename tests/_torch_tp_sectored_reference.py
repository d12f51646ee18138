"""The reference's sectored decode step on a (1, 2) JAX mesh, for
``tests/test_torch_tp_sectored.py``.

Run as a script in a process of its own, with
``XLA_FLAGS=--xla_force_host_platform_device_count=2`` in its
environment (JAX fixes its device count when its backend starts):

    python tests/_torch_tp_sectored_reference.py OUTDIR

It jits the reference's ``make_sectored_decode_step(cfg, mesh)`` with
its own parameter, state and token shardings on the (1, 2) mesh (XLA's
SPMD partitioner splits it over 'model') for the ``kv-heads`` and
``straddle`` cases of ``tests/_torch_tp_sectored_ranks.py``: the port's
seed-0 parameters, the case's initial state and tokens, three steps. It
writes each step's logits, table, lengths and position to
``OUTDIR/CASE.npz``.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

import _torch_tp_sectored_ranks as ranks  # noqa: E402
from _torch_port import f32, to_jax  # noqa: E402
from _torch_train_ranks import TINY  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.runtime import sectored_decode as jsd  # noqa: E402
from repro_torch.models import model  # noqa: E402

#: the cases compared with the reference
CASES = ("kv-heads", "straddle")


def main(case: str, out: str) -> None:
    assert jax.device_count() >= 2, jax.devices()
    over = ranks.CASES[case][0]
    jcfg = jconfigs.get("yi-6b").reduced(**{**TINY, "dtype": "float32",
                                            **over})
    cfg = ranks.case_cfg(case)
    params = to_jax(model.init_params(cfg, seed=0, device="cpu"))
    st = ranks.initial_state(cfg)
    state = jsd.SectoredState(
        kv=jattention.KVCache(k=to_jax(st.kv.k), v=to_jax(st.kv.v),
                              length=to_jax(st.kv.length)),
        table=to_jax(st.table), position=to_jax(st.position))
    mesh = jmesh.make_mesh((1, 2), ("data", "model"))
    fn, (pspec, sspec, tspec), _ = jsd.make_sectored_decode_step(
        jcfg, mesh, batch=ranks.B, seq_len=ranks.SEQ)
    step = jax.jit(fn, in_shardings=(pspec, sspec, tspec),
                   out_shardings=(NamedSharding(mesh, P()), sspec))
    params = jax.device_put(params, pspec)
    state = jax.device_put(state, sspec)
    tok = np.asarray(ranks.tokens(cfg)).astype(np.int32)
    saved = {}
    for s in range(ranks.STEPS):
        logits, state = step(params, state, tok[:, s:s + 1])
        saved.update({f"logits{s}": f32(logits), f"table{s}": f32(state.table),
                      f"length{s}": np.asarray(state.kv.length),
                      f"position{s}": np.asarray(state.position)})
    np.savez(out, **saved)


if __name__ == "__main__":
    for name in CASES:
        main(name, os.path.join(sys.argv[1], f"{name}.npz"))
