"""llava-next-mistral-7b [vlm]: the Mistral-7B backbone behind an anyres
image-patch prefix. The frontend is a stub, as the reference's: a batch
carries the patch embeddings precomputed (`prefix_embeds`).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=32000, head_dim=128, rope_theta=1e6,
    frontend_tokens=1152,   # anyres stub: base 576 + one 576 tile
)


def reduced():
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab_size=512, head_dim=16,
                          frontend_tokens=8, vocab_pad_to=64)
