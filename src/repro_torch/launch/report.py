"""Render the dry-run JSONL records into the roofline table
(counterpart of the JAX package's ``launch/report.py``; the same table
and summary for the same records).

Usage: python -m repro_torch.launch.report results/dryrun_single.jsonl [...]
"""

from __future__ import annotations

import json
import sys


def load(paths):
    rows = []
    for p in paths:
        with open(p) as f:
            for line in f:
                rows.append(json.loads(line))
    return rows


def fmt_row(r) -> str:
    return ("| {arch} | {shape} | {mesh} | {tc:.4f} | {tm:.4f} | {tl:.4f} "
            "| {bn} | {mf:.2e} | {uf:.2f} | {rf:.3f} | {mem:.1f} |").format(
        arch=r["arch"], shape=r["shape"], mesh=r["mesh"],
        tc=r["t_compute"], tm=r["t_memory"], tl=r["t_collective"],
        bn=r["bottleneck"], mf=r["model_flops"],
        uf=r["useful_fraction"], rf=r["roofline_fraction"],
        mem=r["peak_memory_gib"])


HEADER = ("| arch | shape | mesh | t_compute(s) | t_memory(s) | t_coll(s) "
          "| bottleneck | MODEL_FLOPS | useful_frac | roofline_frac "
          "| mem GiB/dev |\n"
          "|---|---|---|---|---|---|---|---|---|---|---|")


def main(argv=None):
    paths = (argv or sys.argv[1:])
    rows = load(paths)
    rows.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    print(HEADER)
    for r in rows:
        print(fmt_row(r))
    # summary
    by_bn = {}
    for r in rows:
        by_bn.setdefault(r["bottleneck"], 0)
        by_bn[r["bottleneck"]] += 1
    print(f"\ncells: {len(rows)}; bottleneck distribution: {by_bn}",
          file=sys.stderr)


if __name__ == "__main__":
    main()
