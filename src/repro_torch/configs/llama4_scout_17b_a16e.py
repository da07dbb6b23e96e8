"""llama4-scout-17b-a16e [moe]: 16 experts top-1 + shared expert, early
fusion (multimodal frontend STUB). [hf:meta-llama/Llama-4-Scout-17B-16E;
unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab_size=202048, head_dim=128, rope_theta=5e5,
    n_experts=16, n_experts_active=1, d_expert=8192, n_shared_experts=1,
    norm_topk_prob=False, moe_impl="routed_a2a",
)


def reduced():
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, d_expert=128, n_experts=4,
                          n_experts_active=1, n_shared_experts=1,
                          vocab_size=512, head_dim=16, vocab_pad_to=64,
                          moe_impl="dense")
