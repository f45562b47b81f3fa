"""Model configurations of the port (exact public-literature shapes).

The counterpart of ``repro/configs``: every arch module exports ``CONFIG``
(full size) and ``smoke_config()`` (a reduced config of the same family for
CPU tests).
"""
from __future__ import annotations

import importlib

ARCHS = [
    "mamba2_1_3b",
    "granite_moe_1b_a400m",
    "grok_1_314b",
    "phi3_medium_14b",
    "minicpm3_4b",
    "qwen1_5_0_5b",
    "granite_8b",
    "qwen2_vl_7b",
    "seamless_m4t_large_v2",
    "recurrentgemma_2b",
]

_ALIAS = {a.replace("_", "-"): a for a in ARCHS}
# the exact ids of the published models
_ALIAS.update({
    "mamba2-1.3b": "mamba2_1_3b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
})


def _module(name: str):
    arch = _ALIAS.get(name, name)
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {name!r}; the port has {sorted(_ALIAS)}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke_config(name: str):
    return _module(name).smoke_config()
