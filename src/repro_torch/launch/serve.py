"""Serving launcher of the port (counterpart of the JAX package's
``launch/serve.py``).

``python -m repro_torch.launch.serve --arch yi-6b --reduced --true-sectored
--fused-kernel [--kv-quant]``

* ``--true-sectored`` — slots hold SectoredState: exact mode (every valid
  page) when the policy says dense, predictor top-k when it says
  sectored, with the shared-prefix demand OR-merge before each fetch;
* ``--fused-kernel`` (needs ``--true-sectored``) — narrow sectored steps
  read and attend their pages in the CUDA kernel
  (``csrc/sectored_attention_paged.cu``); ``--kv-quant`` feeds it
  per-sector int8 KV.

Runs on the GPU, where prefill steps and decode waves replay captured
CUDA graphs, unless ``--device cpu`` is given. Parameters are random,
from a seeded generator. The dense DecodeState backend (no
``--true-sectored``), telemetry, sampling, the page pool, the prefix
cache, the flight recorder and the mesh are later slices of the port.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch import configs
from repro_torch.kernels import backend as kbackend
from repro_torch.models import model
from repro_torch.runtime import sectored_decode
from repro_torch.serve import (AlwaysDense, AlwaysSectored, FifoScheduler,
                               HysteresisPolicy, Request, ServeSession)

POLICIES = {"hysteresis": HysteresisPolicy, "dense": AlwaysDense,
            "sectored": AlwaysSectored}


def build_backend(cfg, params, *, sectored=True, true_sectored=False,
                  seq_len=256, kernel="dispatch", device=None, graphs=True):
    """The data path: a SectoredState-backed backend.

    ``kernel`` picks the sectored decode flavor: ``"dispatch"`` (gather +
    attend in torch), ``"fused"`` (the CUDA kernel) or ``"fused_q8"``
    (the kernel over per-sector int8 KV). On the card the steps, waves and
    prefill replay captured CUDA graphs; ``graphs=False`` runs them
    eagerly.
    """
    if true_sectored and (cfg.attn_free or cfg.layer_pattern):
        raise ValueError(
            f"--true-sectored needs uniform attention layers; arch "
            f"{cfg.name!r} is attention-free or hybrid. Drop the flag to "
            f"serve it on the dense path.")
    if kernel != "dispatch" and not true_sectored:
        raise ValueError(
            "--fused-kernel/--kv-quant need --true-sectored (the dense "
            "DecodeState backend has no paged KV for the kernel to steer)")
    if not true_sectored:
        raise NotImplementedError(
            "the dense DecodeState backend (no --true-sectored) needs "
            "model.prefill, a later slice of the port; pass --true-sectored")
    backend = sectored_decode.make_serving_fns(cfg, params=params,
                                               seq_len=seq_len, kernel=kernel,
                                               device=device, graphs=graphs)
    if not sectored:
        backend.sectored_fn = None
    return backend


def build_policy(name):
    """Shipped SectorPolicy lineup (``--policy``)."""
    if name == "adaptive":
        raise NotImplementedError(
            "the adaptive policy reads telemetry, a later slice of the port")
    return POLICIES[name]()


def build_session(cfg, params, *, max_batch=4, sectored=True,
                  scheduler="fifo", vectorized=True, true_sectored=False,
                  seq_len=256, telemetry=False, policy="hysteresis",
                  mesh=None, page_pool=None, prefix_cache=None, obs=None,
                  kernel="dispatch", device=None,
                  graphs=True) -> ServeSession:
    """A ServeSession over the port's backend, on ``device`` (None = GPU).
    On the GPU its waves and prefill replay captured CUDA graphs;
    ``graphs=False`` runs them eagerly."""
    if scheduler != "fifo":
        raise NotImplementedError(
            f"scheduler {scheduler!r}: only fifo is ported yet")
    if telemetry:
        raise NotImplementedError("telemetry is a later slice of the port")
    if mesh is not None:
        raise NotImplementedError("the mesh is a later slice of the port")
    backend = build_backend(cfg, params, sectored=sectored,
                            true_sectored=true_sectored, seq_len=seq_len,
                            kernel=kernel, device=device, graphs=graphs)
    return ServeSession(backend, max_batch=max_batch,
                        scheduler=FifoScheduler(),
                        policy=build_policy(policy), vectorized=vectorized,
                        page_pool=page_pool, prefix_cache=prefix_cache,
                        obs=obs)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--true-sectored", action="store_true",
                    help="serve on SectoredState (exact/top-k paths + "
                         "shared-prefix demand merge)")
    ap.add_argument("--fused-kernel", action="store_true",
                    help="with --true-sectored: read and attend the "
                         "selected pages in the CUDA kernel")
    ap.add_argument("--kv-quant", action="store_true",
                    help="with --fused-kernel: per-sector int8 KV, "
                         "dequantized inside the kernel (tolerance-gated)")
    ap.add_argument("--policy", default="hysteresis",
                    choices=sorted(POLICIES),
                    help="SectorPolicy")
    ap.add_argument("--stop-token", type=int, action="append", default=None,
                    metavar="ID", dest="stop_tokens",
                    help="EOS contract: a request finishes the moment it "
                         "emits this token id (repeatable, up to 8)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.kv_quant and not args.fused_kernel:
        ap.error("--kv-quant needs --fused-kernel (dequant runs inside "
                 "the fused kernel; the dispatch path reads full-width)")
    if args.fused_kernel and not args.true_sectored:
        ap.error("--fused-kernel needs --true-sectored (the dense backend "
                 "has no paged KV for the kernel to steer)")

    device = kbackend.resolve_device(args.device)
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = model.init_params(cfg, seed=0, device=device)
    kernel = ("fused_q8" if args.kv_quant
              else "fused" if args.fused_kernel else "dispatch")
    sess = build_session(cfg, params, max_batch=args.max_batch,
                         true_sectored=args.true_sectored,
                         policy=args.policy, kernel=kernel, device=device)
    rng = np.random.default_rng(0)
    handles = []
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, size=8 + rid % 5).astype(np.int32)
        handles.append(sess.submit(Request(
            rid, prompt, max_new_tokens=args.max_new_tokens,
            stop_tokens=tuple(args.stop_tokens or ()))))
    stats = sess.run_until_drained()
    if not all(h.done for h in handles):
        raise RuntimeError("session drained with unfinished requests")
    print(f"arch={cfg.name} device={device} kernel={kernel} "
          f"completed={stats['completed']} "
          f"decode_steps={stats['decode_steps']} waves={stats['waves']} "
          f"sectored_steps={stats['sectored_steps']} "
          f"merged_slots={stats['merged_slots']} "
          f"eos_stops={stats['eos_stops']} "
          f"kv_bytes_saved_at_32k="
          f"{sectored_decode.bytes_saved_fraction(32768):.2f}")
    return stats


if __name__ == "__main__":
    main()
