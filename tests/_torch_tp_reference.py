"""The reference's partitioned training step on a (1, 2) JAX mesh, for
``tests/test_torch_tp.py``.

Run as a script in a process of its own, with
``XLA_FLAGS=--xla_force_host_platform_device_count=2`` in its
environment (JAX fixes its device count when its backend starts, so the
test process, which has started it, cannot; ``tests/conftest.py``):

    python tests/_torch_tp_reference.py DTYPE OUT.npz

It jits the reference's ``lm_loss`` gradient and ``make_train_step(cfg,
mesh)`` with the reference's own parameter and batch shardings on the
(1, 2) mesh (XLA's SPMD partitioner splits the products over 'model')
for the tiny yi-6b of ``tests/_torch_train_ranks.py``, its parameters
the port's seed-0 ones, its batch the pipeline's step-1 batch; it writes
the loss, the gradients (in ``jax.tree.leaves`` order, as f32) and the
step's loss.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

import _torch_train_ranks as ranks  # noqa: E402
from _torch_port import f32, to_jax  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.models import model  # noqa: E402


def main(dtype: str, out: str) -> None:
    assert jax.device_count() >= 2, jax.devices()
    jcfg = jconfigs.get("yi-6b").reduced(**ranks.TINY, dtype=dtype)
    cfg = ranks.tiny_cfg(dtype=dtype)
    params = to_jax(model.init_params(cfg, seed=0, device="cpu"))
    batch = {k: np.asarray(v) for k, v in ranks.batch(1).items()}
    mesh = jmesh.make_mesh((1, 2), ("data", "model"))
    ocfg = jadamw.AdamWConfig(lr=1e-3)
    fn, ins, outs = jstep.make_train_step(jcfg, mesh, opt_cfg=ocfg)
    params = jax.device_put(params, ins[0])
    batch = jax.device_put(batch, ins[2])
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.lm_loss(p, jcfg, b["tokens"], b["labels"])),
        in_shardings=(ins[0], ins[2]),
        out_shardings=(NamedSharding(mesh, P()), ins[0]))
    loss, grads = vg(params, batch)
    opt = jax.device_put(jadamw.init_state(params, ocfg), ins[1])
    _, _, metrics = jax.jit(fn, in_shardings=ins, out_shardings=outs)(
        params, opt, batch)
    leaves = jax.tree.leaves(grads)
    np.savez(out, loss=np.float32(loss), step_loss=np.float32(
        metrics["loss"]), **{f"g{i}": f32(g) for i, g in enumerate(leaves)})


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
