"""Model configurations of the port (exact public-literature shapes).

The counterpart of ``repro/configs``: every arch module exports ``CONFIG``
(full size) and ``smoke_config()`` (a reduced config of the same family for
CPU tests). Only the archs whose block kinds the port runs are here; any
other name raises and points at ``ROADMAP.md``.
"""
from __future__ import annotations

import importlib

ARCHS = ["qwen1_5_0_5b"]

_ALIAS = {a.replace("_", "-"): a for a in ARCHS}
_ALIAS["qwen1.5-0.5b"] = "qwen1_5_0_5b"


def _module(name: str):
    arch = _ALIAS.get(name, name)
    if arch not in ARCHS:
        raise ValueError(
            f"arch {name!r} is not ported yet (the port has {sorted(_ALIAS)}); "
            "ROADMAP.md, queue 1 (the LM stack), lists the block kinds still to port")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke_config(name: str):
    return _module(name).smoke_config()
