"""xlstm-1.3b [ssm]: mLSTM and sLSTM blocks at a 7:1 ratio (xLSTM[7:1]),
a period of 8 blocks whose last is the sLSTM. d_ff 0: the mixing blocks
carry their own up and down projections (the sLSTM block's FFN is
max(d_ff, 4 d / 3) wide). [arXiv:2405.04517: 48 blocks, d_model 2048, 4
heads; d_inner = 2 d_model = 4096 with d_inner-square q/k/v maps, which
make 3.707 B parameters, not 1.3 B; vocab 50304]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab_size=50304, block_pattern="xlstm", slstm_every=8,
    ssm_expand=2, ssm_conv=4,
)


def reduced():
    return CONFIG.replace(n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
                          vocab_size=512, vocab_pad_to=64, slstm_every=4)
