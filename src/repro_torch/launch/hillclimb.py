"""§Perf hillclimb (counterpart of the JAX package's
``launch/hillclimb.py``): re-trace the three chosen cells with each
optimization applied and record the roofline terms before and after.

Cells (the reference's picks):
  A. qwen2-72b   x train_4k           — the worst training cell.
  B. chatglm3-6b x long_500k@sectored — the collective-bound cell.
  C. kimi-k2-1t-a32b x decode_32k     — the paper's technique at scale
     (trillion-parameter serving; the sectored KV fetch applies).

Optimizations (config flags, baseline kept):
  blocked    — flash-style blocked attention (models/attention._attend_blocked)
  sectored   — the paper's technique at decode_32k
  sharehead  — per-sequence (head-shared) sector selection
  topk-1/16  — half the selected-sector fraction (B2)
  microbatch — 4 gradient-accumulation microbatches (A2)

Steps: ``A``, ``B``, ``C`` (``all`` runs these three), ``B2`` and ``A2``.
Every global a variant changes (the arch's config, the sectored
fraction, the train-step factory) is put back after it. Rows are
appended to ``results/hillclimb.jsonl``; the times are estimates on H100
datasheet figures (``launch/roofline.py``).

Usage: python -m repro_torch.launch.hillclimb [all|A|B|C|B2|A2]
"""

import dataclasses
import json
import os
import sys

from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.runtime import sectored_decode


def run_variant(arch, shape, variant, cfg_overrides, tag, out_f,
                topk_frac=None):
    cfg0 = configs.ARCHS[arch]
    frac0 = sectored_decode.TOPK_FRAC
    configs.ARCHS[arch] = dataclasses.replace(cfg0, **cfg_overrides)
    if topk_frac is not None:
        sectored_decode.TOPK_FRAC = topk_frac
    try:
        _, rf = dryrun.lower_cell(arch, shape, False, variant)
        rec = rf.row()
        rec["variant"] = tag
        print(f"{arch}/{shape} [{tag}]: t_mem={rf.t_memory:.4f}s "
              f"t_coll={rf.t_collective:.4f}s t_comp={rf.t_compute:.4f}s "
              f"mem={rec['peak_memory_gib']:.1f}GiB "
              f"rooffrac={rf.roofline_fraction:.4f}", flush=True)
        out_f.write(json.dumps(rec) + "\n")
        out_f.flush()
    finally:
        configs.ARCHS[arch] = cfg0
        sectored_decode.TOPK_FRAC = frac0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    os.makedirs("results", exist_ok=True)
    out_f = open("results/hillclimb.jsonl", "a")
    step = argv[0] if argv else "all"

    if step in ("all", "A"):
        run_variant("qwen2-72b", "train_4k", "dense", {}, "baseline", out_f)
        run_variant("qwen2-72b", "train_4k", "dense",
                    dict(blocked_attention=True), "blocked-attn", out_f)
    if step in ("all", "B"):
        run_variant("chatglm3-6b", "long_500k", "sectored", {}, "baseline",
                    out_f)
        run_variant("chatglm3-6b", "long_500k", "sectored",
                    dict(sector_share_heads=True), "share-heads", out_f)
    if step in ("B2",):
        # half the selected-sector fraction (the paper's §8.2 knob): the
        # collective term is the cross-shard fetch of the selected pages
        run_variant("chatglm3-6b", "long_500k", "sectored", {},
                    "topk-1/16", out_f, topk_frac=1 / 16)
    if step in ("A2",):
        # 4 gradient-accumulation microbatches on top of blocked attention
        orig = dryrun.step_mod.make_train_step

        def mb4(cfg, mesh=None, **kw):
            kw["microbatch"] = 4
            return orig(cfg, mesh, **kw)
        dryrun.step_mod.make_train_step = mb4
        try:
            run_variant("qwen2-72b", "train_4k", "dense",
                        dict(blocked_attention=True), "blocked+mb4", out_f)
        finally:
            dryrun.step_mod.make_train_step = orig
    if step in ("all", "C"):
        run_variant("kimi-k2-1t-a32b", "decode_32k", "dense", {}, "baseline",
                    out_f)
        run_variant("kimi-k2-1t-a32b", "decode_32k", "dense", {},
                    "bf16-einsum", out_f)
        run_variant("kimi-k2-1t-a32b", "decode_32k", "sectored",
                    dict(sector_share_heads=True), "sectored+share", out_f)
    out_f.close()


if __name__ == "__main__":
    main()
