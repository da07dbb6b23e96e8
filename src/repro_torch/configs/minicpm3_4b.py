"""minicpm3-4b [dense]: MLA, a latent-compressed KV of kv_lora_rank 256
plus a 32-wide rope key shared by the heads, cached per token in place of
K and V. [hf:openbmb/MiniCPM3-4B config.json: 62 layers, hidden 2560, 40
heads, intermediate 6400, q_lora_rank 768, kv_lora_rank 256,
qk_nope_head_dim 64, qk_rope_head_dim 32, v_head_dim 64, vocab 73448]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=6400,
    vocab_size=73448, attn_type="mla",
    q_lora_rank=768, kv_lora_rank=256, qk_nope_dim=64, qk_rope_dim=32,
    v_head_dim=64, rope_theta=1e4,
)


def reduced():
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          d_ff=128, vocab_size=512, q_lora_rank=32,
                          kv_lora_rank=16, qk_nope_dim=8, qk_rope_dim=8,
                          v_head_dim=8, vocab_pad_to=64)
