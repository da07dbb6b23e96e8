"""Configurations of the port (counterpart of `repro.configs`).

get_config(name)   -> the full ModelConfig / StoreConfig
get_reduced(name)  -> the same family at tiny sizes for CPU tests
ARCHS              -> every architecture, in the reference's order
"""
from importlib import import_module

ARCHS = [
    "llava-next-mistral-7b",
    "qwen3-moe-235b-a22b",
    "llama4-scout-17b-a16e",
    "qwen3-1.7b",
    "llama3-405b",
    "minicpm3-4b",
    "qwen1.5-110b",
    "xlstm-1.3b",
    "hymba-1.5b",
    "musicgen-medium",
]
ALL = ARCHS + ["paper-kvstore"]

_MOD = {n: n.replace("-", "_").replace(".", "_") for n in ALL}


def _module(name: str):
    if name not in _MOD:
        raise KeyError(f"unknown architecture {name!r}; known: {ALL}")
    return import_module(f"repro_torch.configs.{_MOD[name]}")


def get_config(name: str):
    return _module(name).CONFIG


def get_reduced(name: str):
    return _module(name).reduced()
