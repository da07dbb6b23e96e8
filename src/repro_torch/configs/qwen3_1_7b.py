"""qwen3-1.7b [dense]: qk_norm, GQA with 8 KV heads, tied embeddings.
[hf:Qwen/Qwen3-1.7B config.json: 28 layers, hidden 2048, 16 heads, 8 KV
heads, head_dim 128, intermediate 6144, vocab 151936, rope_theta 1e6]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=6144,
    vocab_size=151936, head_dim=128, qk_norm=True, rope_theta=1e6,
    tie_embeddings=True,
)


def reduced():
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab_size=512, head_dim=16,
                          vocab_pad_to=64)
