"""musicgen-medium [audio]: a decoder over EnCodec tokens, 4 codebooks
with the delay pattern. The frontend is a stub, as the reference's: token
grids [B, n_codebooks, S] arrive pre-delayed; the codebooks' embeddings
are summed and the head is factored per codebook.
[arXiv:2306.05284; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, d_ff=6144,
    vocab_size=2048, head_dim=64, n_codebooks=4, vocab_pad_to=256,
)


def reduced():
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          d_ff=128, vocab_size=256, head_dim=16,
                          n_codebooks=2, vocab_pad_to=64)
