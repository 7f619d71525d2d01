"""JSON config loader (port of ``vanerf_tpu/config.py``).

The port reads the same ``configs/*.json`` schema; YAML configs are not
supported (the port does not depend on ``yaml``).
"""

from __future__ import annotations

import json
import pathlib


def load_cfg(path: str) -> dict:
    """Load a JSON config (reference ``src/config.py:54-68``)."""
    if not str(path).endswith(".json"):
        raise ValueError(f"the port reads JSON configs only, got {path!r}")
    with open(path, "r") as file:
        return json.load(file)


def default_cfg() -> dict:
    """``configs/vanerf.json`` from the repository root."""
    here = pathlib.Path(__file__).resolve().parent.parent
    return load_cfg(str(here / "configs" / "vanerf.json"))
