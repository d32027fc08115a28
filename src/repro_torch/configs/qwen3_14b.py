"""qwen3-14b [dense] — qk_norm, GQA. [hf:Qwen/Qwen3-8B family]"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen3-14b")
def qwen3_14b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b",
        arch_type="dense",
        num_layers=40,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=17408,
        vocab_size=151936,
        qk_norm=True,
        act="silu",
        rope_theta=1e6,
        tie_embeddings=False,
        source="hf:Qwen/Qwen3-8B (family card, 14B row)",
    )
