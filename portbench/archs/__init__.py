"""What each architecture means to the benchmark, one module a name:
``archs/<architecture>.py``, looked up by the configuration file's
``architecture``. A module holds the sizes the yardstick and the
reference read (``shapes``), the layout of the parameter tree the
benchmark draws (``layout``), a token's decode FLOPs (``decode_flops``),
the program's configuration (``program_config``; the only part that
imports the program) and the plain reference's ``forward``. A new
architecture adds its module and edits none."""

from __future__ import annotations

import importlib
import re

_NAME = re.compile(r"^[a-z][a-z0-9_]*$")


def get(name: str):
    """The module of architecture ``name``; an unknown one raises."""
    if not _NAME.match(name):
        raise ValueError(f"no architecture {name!r}")
    try:
        return importlib.import_module(f"portbench.archs.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"portbench.archs.{name}":
            raise
        raise ValueError(f"no architecture {name!r}: add "
                         f"portbench/archs/{name}.py") from None
