"""Serve batched requests through a ``ServeSession`` composed from the
three serving protocols (the port's counterpart of the JAX package's
``examples/serve_sectored.py``, the same config, prompts and checks): a
sectored-state backend (the sector predictor driving KV fetches and the
shared-prefix sector-demand OR-merge), the ``OverlapScheduler`` (prefill
double-buffered against the in-flight decode wave) and the
``HysteresisPolicy`` (the dynamic Sectored-off toggle).

``submit()`` returns a ``StreamHandle``: tokens are read back through
``poll()`` / ``tokens()``. The batch mixes greedy and sampled requests:
a ``SamplerSpec`` rides on the request and the wave samples on the
device with a counter-based RNG keyed on (request seed, position), so
two requests with the same prompt and seed give the same stream however
they were packed into waves.

``python -m repro_torch.launch.serve_sectored [--device cpu]``
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch import configs
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import model
from repro_torch.runtime import sectored_decode
from repro_torch.serve import (HysteresisPolicy, OverlapScheduler, Request,
                               SamplerSpec, ServeSession)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--d-model", type=int, default=128)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get("yi-6b").reduced(n_layers=2, d_model=args.d_model,
                                       n_heads=4, n_kv_heads=2,
                                       d_ff=2 * args.d_model, vocab=512,
                                       head_dim=32)
    params = model.init_params(cfg, seed=0, device=dev)
    backend = sectored_decode.make_serving_fns(cfg, params=params,
                                               seq_len=64, device=dev)
    sess = ServeSession(backend, max_batch=6, scheduler=OverlapScheduler(),
                        policy=HysteresisPolicy(min_occupancy=0.5))

    rng = np.random.default_rng(0)
    shared_prefix = rng.integers(0, cfg.vocab, size=10).astype(np.int32)
    sampled_prompt = rng.integers(0, cfg.vocab, size=10).astype(np.int32)
    creative = SamplerSpec(temperature=0.8, top_p=0.95, seed=7)
    handles = []
    for rid in range(6):
        if rid < 2:  # two greedy requests share a prompt (demands OR-merge)
            prompt, spec = shared_prefix, None
        elif rid < 4:  # two sampled requests share prompt AND seed
            prompt, spec = sampled_prompt, creative
        else:  # same prompt, two different seeds: distinct streams
            prompt = sampled_prompt
            spec = SamplerSpec(temperature=0.8, top_p=0.95, seed=100 + rid)
        handles.append(sess.submit(Request(rid, prompt, max_new_tokens=12,
                                           sampler=spec)))

    # stream request 0 token by token (the iterator drives the session, so
    # the other five decode in the same mixed greedy and sampled waves)
    print("request 0 streaming:", list(handles[0].tokens()))
    stats = sess.run_until_drained()
    print("stats:", stats)
    for h in handles:
        spec = h.request.sampler
        desc = spec.describe() if spec is not None else "greedy"
        print(f"request {h.rid}: done={h.done} sampler={desc:22s} "
              f"tokens={h.peek()}")
    if handles[0].peek() != handles[1].peek():
        raise SystemExit("identical prompts diverged")
    if handles[2].peek() != handles[3].peek():
        raise SystemExit("same prompt + same seed must sample the same "
                         "stream")
    print("seeds 104 vs 105 diverge:", handles[4].peek() != handles[5].peek())
    table = sess.batched.table.float().cpu().numpy()  # (L, slots, Hkv, P)
    print("sector-history table (slot 0, layer 0, head 0):",
          np.round(table[0, 0, 0, :6], 3))
    saved = sectored_decode.bytes_saved_fraction(32768)
    print(f"KV bytes saved at 32k context: {saved:.0%}")
    return dict(stats=stats, tokens=[h.peek() for h in handles],
                done=[h.done for h in handles])


if __name__ == "__main__":
    main()
