"""Models of the port (counterpart of `repro.models`): the dense GQA
transformer family.

common     dtype policy, norms, rotary embeddings, init, causal attention
params     `Weights`: parameter groups under the reference's names
mlp        SwiGLU
attention  GQA forward / prefill / decode
blocks     the dense block
model      init_params, forward, prefill, prefill_with_past, decode_step
"""
