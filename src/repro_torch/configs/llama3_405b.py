"""llama3-405b [dense]: GQA with 8 KV heads, a 128k vocabulary.
[arXiv:2407.21783; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, d_ff=53248,
    vocab_size=128256, head_dim=128, rope_theta=5e5,
)


def reduced():
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=256, vocab_size=512, head_dim=16,
                          vocab_pad_to=64)
