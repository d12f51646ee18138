"""Quickstart: the paper's result in three calls (the port's counterpart
of the JAX package's ``examples/quickstart.py``, the same mix, sizes and
table).

1. Simulate a memory-intensive 8-core mix on coarse-grained DDR4.
2. Simulate the same mix on Sectored DRAM (SA + VBL + LA128-SP512).
3. Compare performance / DRAM energy / bytes moved (Fig. 13 in
   miniature), then show the serving side's byte savings.

The simulator is host numpy (``core/``); nothing runs on the card.

``python -m repro_torch.launch.quickstart [--n-instructions 150000]``
"""

from __future__ import annotations

import argparse

from repro_torch.core import simulator as sim
from repro_torch.data import traces
from repro_torch.runtime import sectored_decode


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-instructions", type=int, default=150_000)
    args = ap.parse_args(argv)

    mix = tuple(traces.make_mixes("high", n_mixes=1, cores=8, seed=0)[0])
    print("workload mix:", ", ".join(mix))
    base = sim.run_system(mix, "baseline", n_instructions=args.n_instructions)
    sect = sim.run_system(mix, "sectored", n_instructions=args.n_instructions)

    print(f"\n{'':24s}{'baseline':>12s}{'sectored':>12s}")
    print(f"{'mean IPC':24s}{base.mean_ipc:12.3f}{sect.mean_ipc:12.3f}")
    print(f"{'DRAM energy (uJ)':24s}{base.dram_energy_nj/1e3:12.1f}"
          f"{sect.dram_energy_nj/1e3:12.1f}")
    print(f"{'bytes on channel (MB)':24s}{base.sim.bytes_on_bus/1e6:12.2f}"
          f"{sect.sim.bytes_on_bus/1e6:12.2f}")
    print(f"{'avg read latency (ns)':24s}{base.sim.read_latency_ns:12.1f}"
          f"{sect.sim.read_latency_ns:12.1f}")
    speedup = sect.mean_ipc / base.mean_ipc
    energy = sect.dram_energy_nj / base.dram_energy_nj
    saved = sectored_decode.bytes_saved_fraction(32768)
    print(f"\nspeedup: {speedup:.2f}x   DRAM energy: {energy:.2f}x")
    print(f"serving adaptation: sectored KV decode skips {saved:.0%} of KV "
          f"bytes at 32k context")
    return dict(mix=mix, baseline=base, sectored=sect, speedup=speedup,
                energy=energy, kv_bytes_saved=saved)


if __name__ == "__main__":
    main()
