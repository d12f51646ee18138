"""Train a ~100M-parameter yi-family model on the deterministic synthetic
pipeline, with checkpointing and restart safety (the port's counterpart
of the JAX package's ``examples/train_100m.py``, same configuration and
the same check that the loss decreases).

``python -m repro_torch.launch.train_100m [--steps 200] [--device cpu]``
"""

from __future__ import annotations

import argparse
import os
import tempfile
import dataclasses

from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import model
from repro_torch.optim import adamw
from repro_torch.train import loop
from repro_torch.train.step import make_train_step


def main(argv=None) -> loop.LoopResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_100m"))
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    # ~100M params: 8L x 512d + 32k vocab
    cfg = dataclasses.replace(
        configs.get("yi-6b"), name="yi-100m", n_layers=args.layers,
        d_model=args.d_model, n_heads=8, n_kv_heads=4, head_dim=64,
        d_ff=args.d_model * 4, vocab=32768,
    )
    print(f"config: {cfg.name}, {cfg.param_count()/1e6:.0f}M params")
    params = model.init_params(cfg, seed=0, device=dev)
    ocfg = adamw.AdamWConfig(lr=1e-3)
    opt = adamw.init_state(params, ocfg)
    step, _, _ = make_train_step(cfg, opt_cfg=ocfg, remat=False)
    data = pipeline.DataConfig(vocab=cfg.vocab, seq_len=256, global_batch=8)
    lc = loop.LoopConfig(total_steps=args.steps, checkpoint_every=100,
                         checkpoint_dir=args.checkpoint_dir)
    params, opt, res = loop.run(step, params, opt, data, lc)
    first = sum(res.losses[:10]) / max(len(res.losses[:10]), 1)
    last = sum(res.losses[-10:]) / max(len(res.losses[-10:]), 1)
    print(f"steps={res.final_step} loss {first:.3f} -> {last:.3f} "
          f"(restored_from={res.restored_from}, retries={res.retries})")
    if not last < first:
        raise SystemExit("loss should decrease")
    return res


if __name__ == "__main__":
    main()
