"""Models of the port (counterpart of `repro.models`): the dense GQA
transformer family, its mixture-of-experts variant, minicpm3's MLA,
hymba's hybrid attention + mamba block and xLSTM's mLSTM / sLSTM
blocks.

common     dtype policy, norms, rotary embeddings, init, causal attention
           ("xla" chunked, "xla_flash" on the flash_attention kernel)
params     `Weights`: parameter groups under the reference's names
mlp        SwiGLU
attention  GQA and MLA forward / prefill / decode
ssm        the mamba head (selective_scan kernel), the mLSTM and sLSTM
           cells
moe        the MoE FFN: router, the dense dispatch and the two
           expert-parallel dispatches on the paper's routing
blocks     the dense, moe, hymba, mlstm and slstm blocks and their caches
model      init_params, forward, init_caches, prefill, prefill_with_past,
           decode_step, cross_entropy
"""
