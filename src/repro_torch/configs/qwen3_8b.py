"""qwen3-8b [dense] — qk_norm, GQA. [hf:Qwen/Qwen3-8B]"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen3-8b")
def qwen3_8b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b",
        arch_type="dense",
        num_layers=36,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=12288,
        vocab_size=151936,
        qk_norm=True,
        act="silu",
        rope_theta=1e6,
        tie_embeddings=False,
        source="hf:Qwen/Qwen3-8B",
    )
