"""TraceRecorder: ring-buffered per-wave telemetry with windowed aggregates
(counterpart of the JAX package's ``telemetry/recorder.py``).

One record per decode wave (appended by
:class:`~repro_torch.telemetry.meters.WaveMeter`), held in a bounded ring
buffer so long-running sessions meter at O(1) memory. Two consumers:

* **Control** — :class:`~repro_torch.serve.policy.AdaptiveSectorPolicy`
  reads the exponentially-weighted aggregates in :attr:`TraceRecorder.ema`
  (sector coverage, predictor attention-mass capture) to widen or narrow
  the top-k fetch fraction; the EMA is the recorder-side analogue of the predictor's
  own sector-history decay.
* **Reporting** — ``launch/serve.py --telemetry --trace-out`` exports the
  raw window as JSONL for offline analysis.

The ``attn_mass`` field arrives honest from the runtime: narrow sectored
steps widen their fetch by one deterministic probe page per wave
(``runtime.sector_predictor.probe_page_for``), so the sector-history table
keeps fresh scores for the whole valid range and no analytic de-biasing is
needed here. ``attn_mass_raw`` is retained as an alias of the observed
value so downstream JSONL consumers keep their column.
"""

from __future__ import annotations

import collections
import json
import pathlib
from typing import Any, Iterable, Mapping

#: record fields folded into the running EMAs (others are kept raw-only)
EMA_FIELDS = ("sector_coverage", "attn_mass", "attn_mass_raw", "energy_j",
              "k_pages")
DEFAULT_EMA_ALPHA = 0.25


class TraceRecorder:
    """Bounded per-wave trace + online exponentially-weighted aggregates.

    ``append()`` takes one flat mapping per wave. Numeric fields listed in
    :data:`EMA_FIELDS` update ``self.ema[field]`` as
    ``(1 - alpha) * old + alpha * new`` (seeded with the first observation);
    fields absent from a record — e.g. ``attn_mass`` on a dense wave —
    leave their EMA untouched, so a burst of dense waves does not erase the
    sectored-path coverage signal.

    Storage is an explicit ring: a preallocated slab of ``capacity`` slots
    written at ``seq % capacity``. Once wrapped, the oldest surviving
    record lives at the *write* cursor, not at slot 0 — ``window()`` and
    ``to_jsonl()`` rotate so exports always run in arrival (``seq``) order
    regardless of where the cursor sits (tested explicitly in
    tests/test_torch_telemetry.py).
    """

    def __init__(self, capacity: int = 1024,
                 ema_alpha: float = DEFAULT_EMA_ALPHA):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if not 0.0 < ema_alpha <= 1.0:
            raise ValueError(f"ema_alpha must be in (0, 1], got {ema_alpha}")
        self.capacity = capacity
        self.ema_alpha = ema_alpha
        self._buf: list[dict[str, Any] | None] = [None] * capacity
        self._appended = 0
        self.ema: dict[str, float] = {}

    def __len__(self) -> int:
        return min(self._appended, self.capacity)

    @property
    def total_appended(self) -> int:
        """Records ever appended (>= len() once the ring has wrapped)."""
        return self._appended

    def append(self, record: Mapping[str, Any]) -> None:
        rec = dict(record)
        rec.setdefault("seq", self._appended)
        if rec.get("attn_mass") is not None:
            rec.setdefault("attn_mass_raw", float(rec["attn_mass"]))
        self._buf[self._appended % self.capacity] = rec
        self._appended += 1
        for field in EMA_FIELDS:
            value = rec.get(field)
            if value is None:
                continue
            value = float(value)
            prev = self.ema.get(field)
            self.ema[field] = (value if prev is None else
                               (1.0 - self.ema_alpha) * prev
                               + self.ema_alpha * value)

    def _ordered(self) -> list[dict[str, Any]]:
        """Buffered records in arrival order (oldest surviving first)."""
        if self._appended <= self.capacity:
            return [r for r in self._buf[:self._appended] if r is not None]
        cursor = self._appended % self.capacity
        return [r for r in self._buf[cursor:] + self._buf[:cursor]
                if r is not None]

    def window(self, n: int | None = None) -> list[dict[str, Any]]:
        """The last ``n`` records (all buffered records when ``n`` is None),
        in arrival order."""
        records = self._ordered()
        if n is None or n >= len(records):
            return records
        return records[len(records) - n:]

    def mean(self, field: str, n: int | None = None) -> float | None:
        """Window mean of a numeric field (records missing it are skipped)."""
        values = [float(r[field]) for r in self.window(n)
                  if r.get(field) is not None]
        if not values:
            return None
        return sum(values) / len(values)

    def to_jsonl(self, path, extra: Mapping[str, Any] | None = None):
        """Write the buffered window as JSON Lines in arrival order;
        returns the path.

        ``extra`` fields are merged into every line (run metadata such as
        arch / scheduler / policy), keeping each line self-describing for
        downstream concatenation across runs.
        """
        path = pathlib.Path(path)
        base = dict(extra or {})
        with path.open("w") as fh:
            for rec in self._ordered():
                fh.write(json.dumps({**base, **rec}) + "\n")
        return path

    @staticmethod
    def summarize(records: Iterable[Mapping[str, Any]]) -> dict[str, float]:
        """Sums of the additive fields over an iterable of records."""
        totals: dict[str, float] = collections.defaultdict(float)
        for rec in records:
            for key in ("energy_j", "act_j", "rd_j", "wr_j", "tokens",
                        "pages_fetched", "pages_valid", "acts", "wall_s",
                        "dram_ns"):
                value = rec.get(key)
                if value is not None:
                    totals[key] += float(value)
        return dict(totals)
