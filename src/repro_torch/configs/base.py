"""Config schema of the port (counterpart of `repro.configs.base`).

`ModelConfig` carries the fields of the reference's `ModelConfig` that the
ported slices read, under the same names and with the same defaults (the
GQA transformer family the serving engine drives, its MoE variant,
minicpm3's MLA, hymba's hybrid attention + mamba block, xLSTM's
mLSTM / sLSTM blocks, and the frontend stubs: musicgen's codebooks and
llava's prefix embeddings); `StoreConfig` carries the kvstore fields.
`ShapeConfig` and `SHAPES` are the reference's assigned input-shape
cells.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0                # 0 -> d_model // n_heads

    # --- attention ---
    attn_type: str = "gqa"           # gqa | mla
    qk_norm: bool = False            # qwen3
    qkv_bias: bool = False           # qwen1.5
    rope_theta: float = 1e4
    sliding_window: int = 0          # 0 = full attention (hymba: >0)
    global_attn_every: int = 0       # hymba: every k-th layer full attn

    # --- MLA (minicpm3) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ---
    n_experts: int = 0
    n_experts_active: int = 0        # top-k
    d_expert: int = 0                # expert FFN width
    n_shared_experts: int = 0        # llama4 shared expert
    norm_topk_prob: bool = True
    moe_impl: str = "replicated_psum"   # or "routed_a2a" (the paper's routing)
    moe_capacity_factor: float = 2.0    # dispatch-buffer budget

    # --- SSM / xLSTM / hybrid ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    slstm_every: int = 0             # xlstm: every k-th block is sLSTM
    block_pattern: str = "transformer"  # transformer | xlstm | hybrid

    # --- modality frontends (stubs, as the reference's) ---
    n_codebooks: int = 0             # musicgen's EnCodec codebooks
    frontend_tokens: int = 0         # vlm / audio: precomputed prefix rows

    # --- numerics / structure ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    vocab_pad_to: int = 256
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True               # recompute each layer in the backward
    attn_impl: str = "xla"           # xla | xla_flash (the flash kernel)
    attn_block_q: int = 512          # q-chunking of the prefill attention
    scan_chunk: int = 256            # mLSTM / mamba chunk length
    kv_cache_dtype: str = "bfloat16"
    ssm_scan_dtype: str = "float32"  # or "bfloat16" (plain scan only)
    decode_shard: str = "batch"      # or "seq2d": batch replicated, the
                                     # cache's seq dim over (dp..., model);
                                     # read by the dry run's cache specs
    pod_compress: bool = False       # int8 error-feedback gradient exchange
                                     # over the pod axis (optim/compress.py)
    # The reference's `scan_layers` has no counterpart: the port walks its
    # layers in a Python loop (no layer scan), so its dry run counts every
    # layer and its roofline needs no unrolled probes.

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return -(-self.vocab_size // p) * p

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class StoreConfig:
    name: str
    family: str = "kvstore"
    store_capacity: int = 0
    store_lanes: int = 0
    store_backend: str = "det_skiplist"  # any repro_torch.store registry name
    store_exec: str = "gpu"              # store.exec mode: torch | gpu

    def replace(self, **kw) -> "StoreConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# archs allowed to run long_500k (sub-quadratic or recurrent decode
# state); pure full-attention archs skip it
LONG_CONTEXT_OK = {"xlstm-1.3b", "hymba-1.5b"}


def cells_for(arch_name: str) -> list[str]:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if arch_name in LONG_CONTEXT_OK or arch_name == "paper-kvstore":
        out.append("long_500k")
    return out
