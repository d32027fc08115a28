"""whisper-base [audio] — encoder-decoder; mel+conv frontend is a STUB per the
assignment carve-out: ``input_specs`` supplies precomputed frame embeddings
(batch, 1500, d_model). [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig, register


@register("whisper-base")
def whisper_base() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        arch_type="audio",
        num_layers=6,                 # decoder layers
        d_model=512,
        num_heads=8,
        num_kv_heads=8,               # whisper is MHA (kv == q heads)
        head_dim=64,
        d_ff=2048,
        vocab_size=51865,
        act="gelu",
        rope_theta=1e4,               # (whisper uses learned pos; we use RoPE-free sinusoid)
        tie_embeddings=True,
        is_encdec=True,
        encoder_layers=6,
        encoder_frames=1500,
        source="arXiv:2212.04356 (whisper-base: 6+6 layers, d=512, 8 heads)",
    )
