"""qwen3-moe-235b-a22b [moe]: 128 experts top-8, GQA kv=4, qk_norm.
[hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_ff=1536,
    vocab_size=151936, head_dim=128, qk_norm=True, rope_theta=1e6,
    n_experts=128, n_experts_active=8, d_expert=1536, norm_topk_prob=True,
    moe_impl="routed_a2a",
)


def reduced():
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=96, d_expert=96, n_experts=8,
                          n_experts_active=2, vocab_size=512, head_dim=16,
                          vocab_pad_to=64, moe_impl="dense")
