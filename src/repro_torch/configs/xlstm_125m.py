"""xlstm-125m [ssm-family] — alternating mLSTM (matrix memory, chunkwise
parallel) and sLSTM (scalar memory, sequential scan) blocks. [arXiv:2405.04517]"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig, register


@register("xlstm-125m")
def xlstm_125m() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m",
        arch_type="ssm",
        num_layers=12,
        d_model=768,
        num_heads=4,
        num_kv_heads=4,
        head_dim=192,
        d_ff=0,                       # xLSTM blocks carry their own up/down proj
        vocab_size=50304,
        act="gelu",
        tie_embeddings=True,
        xlstm=XLSTMConfig(slstm_every=3, chunk_size=64),
        source="arXiv:2405.04517 (xLSTM 125M: 12 blocks, d=768)",
    )
