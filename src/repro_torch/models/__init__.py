"""Models of the port (counterpart of `repro.models`): the dense GQA
transformer family, its mixture-of-experts variant and hymba's hybrid
attention + mamba block.

common     dtype policy, norms, rotary embeddings, init, causal attention
           ("xla" chunked, "xla_flash" on the flash_attention kernel)
params     `Weights`: parameter groups under the reference's names
mlp        SwiGLU
attention  GQA forward / prefill / decode
ssm        the mamba head (selective_scan kernel)
moe        the MoE FFN: router, the dense dispatch and the two
           expert-parallel dispatches on the paper's routing
blocks     the dense, moe and hymba blocks
model      init_params, forward, prefill, prefill_with_past, decode_step,
           cross_entropy
"""
