"""gemma-7b [dense] — GeGLU, head_dim=256, MHA (16 kv heads = 16 q heads).
[arXiv:2403.08295]"""
from repro_torch.configs.base import ModelConfig, register


@register("gemma-7b")
def gemma_7b() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b",
        arch_type="dense",
        num_layers=28,
        d_model=3072,
        num_heads=16,
        num_kv_heads=16,
        head_dim=256,
        d_ff=24576,
        vocab_size=256000,
        act="gelu",                   # GeGLU
        rope_theta=1e4,
        tie_embeddings=True,
        source="arXiv:2403.08295 (Gemma 7B: 28L d=3072 16H hd=256 ff=24576)",
    )
