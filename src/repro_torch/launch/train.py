"""Training launcher of the port (counterpart of the JAX package's
``launch/train.py``).

``python -m repro_torch.launch.train --arch yi-6b --reduced --steps 20``

Runs the fault-tolerant loop (:mod:`repro_torch.train.loop`) over the
deterministic synthetic pipeline with AdamW, on the GPU unless
``--device cpu`` is given, from random parameters of seed 0, and prints
the reference's summary line. ``--compress-grads`` runs the int8
error-feedback gradient compression.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import model
from repro_torch.optim import adamw
from repro_torch.train import loop
from repro_torch.train.step import make_train_step


def main(argv=None) -> loop.LoopResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config")
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_train"))
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = model.init_params(cfg, seed=0, device=dev)
    ocfg = adamw.AdamWConfig(lr=args.lr, compress_grads=args.compress_grads)
    opt = adamw.init_state(params, ocfg)
    step, _, _ = make_train_step(cfg, opt_cfg=ocfg, remat=False)
    data = pipeline.DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                               global_batch=args.batch)
    lc = loop.LoopConfig(total_steps=args.steps, checkpoint_every=50,
                         checkpoint_dir=args.checkpoint_dir)
    _, _, res = loop.run(step, params, opt, data, lc)
    print(f"arch={cfg.name} steps={res.final_step} "
          f"loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f} "
          f"retries={res.retries} restored_from={res.restored_from}")
    return res


if __name__ == "__main__":
    main()
