"""The paper's own architecture: the ordered-set service (§VI) — per-chip
store shapes of `repro.configs.paper_kvstore`.

`store_backend` selects the engine through the `repro_torch.store`
registry: "det_skiplist" is the paper's flagship, "hash+skiplist" its §IX
hierarchical proposal, "tiered3[/lru|/size]" the three-deep stack."""
from repro_torch.configs.base import StoreConfig

CONFIG = StoreConfig(
    name="paper-kvstore", family="kvstore",
    store_capacity=65536, store_lanes=4096,
    store_backend="det_skiplist",
)


def reduced():
    return CONFIG.replace(store_capacity=512, store_lanes=32)


def tiered():
    """The §IX hierarchical composition on the same shapes."""
    return CONFIG.replace(store_backend="hash+skiplist")


def tiered3(policy: str = "lru"):
    """The three-deep §IX stack (hash -> skiplist -> spill) with a hot-tier
    eviction policy ("lru" | "size"; "none" = spill-only)."""
    name = "tiered3" if policy == "none" else f"tiered3/{policy}"
    return CONFIG.replace(store_backend=name)


def kernelized(mode: str = "gpu"):
    """The §IX composition with its probes through exec mode `mode`
    ("gpu": the CUDA kernels; "torch": the plain versions); results are
    bit-identical across modes."""
    from repro_torch.exec import MODES
    if mode not in MODES:
        raise ValueError(f"unknown store exec mode {mode!r}; one of {MODES}")
    return CONFIG.replace(store_backend="hash+skiplist", store_exec=mode)
