"""gemma3-12b [dense] — 5 local (sliding-window 1024) : 1 global attention
pattern, 128k context.  For the ``long_500k`` shape the global layers also run
with a bounded window (``long_context_window``).  A copy of the JAX
package's config. [hf:google/gemma-3-1b-pt family card]"""
from repro_torch.configs.base import ModelConfig, register


@register("gemma3-12b")
def gemma3_12b() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b",
        arch_type="dense",
        num_layers=48,
        d_model=3840,
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        d_ff=15360,
        vocab_size=262144,
        qk_norm=True,
        act="gelu",
        rope_theta=1e6,
        tie_embeddings=True,
        sliding_window=1024,
        global_every=6,               # 5 local : 1 global
        long_context_window=32768,    # sub-quadratic variant for long_500k
        source="hf:google/gemma-3-1b-pt (family card, 12B row; 5:1 local:global)",
    )
