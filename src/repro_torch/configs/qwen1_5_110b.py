"""qwen1.5-110b [dense]: QKV bias, GQA with 8 KV heads.
[hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=49152,
    vocab_size=152064, head_dim=128, qkv_bias=True, rope_theta=1e6,
)


def reduced():
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab_size=512, head_dim=16,
                          vocab_pad_to=64)
