"""hymba-1.5b [hybrid]: parallel attention + mamba heads per block, sliding
window except 3 global layers, ssm_state=16. [arXiv:2411.13676; hf:
nvidia/Hymba-1.5B-Base: 32 layers, hidden 1600, 25 heads, 5 KV heads,
head_dim 64, intermediate 5504, vocab 32001, window 2048]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504,
    vocab_size=32001, head_dim=64, block_pattern="hybrid",
    ssm_state=16, ssm_expand=2, ssm_conv=4, sliding_window=2048,
)


def reduced():
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab_size=512, head_dim=16,
                          sliding_window=16, vocab_pad_to=64)
