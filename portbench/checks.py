"""The numbers a run compares and their limits.

A cell's limits are ``limits/<cell>.json``: ``{"limits": {name:
limit}, ...}`` beside the readings each limit was set from. A number is
within its limit where it is at most the limit.
"""

from __future__ import annotations

import json

from portbench.spec import HERE


def limits(cell: str) -> dict:
    with open(HERE / "limits" / f"{cell}.json") as f:
        return json.load(f)["limits"]


def compare(check: dict, lims: dict, prefix: str = "") -> dict:
    """``{prefix + name: {"value": v, "limit": l}}`` for every limited
    number, ``v`` being ``check[prefix + name]``: with ``prefix``
    "control_", the control's reading of that number."""
    return {prefix + name: {"value": float(check[prefix + name]),
                            "limit": float(limit)}
            for name, limit in lims.items()}


def within(compared: dict) -> bool:
    """Every number at most its limit: the run is correct."""
    return all(c["value"] <= c["limit"] for c in compared.values())
