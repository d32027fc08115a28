"""Model configs, copied from the JAX package's ``repro/configs/base.py``.

The port keeps its own copy (it imports nothing of ``repro``): every
architecture is a frozen dataclass registered under its ``--arch`` id.
Every architecture of the JAX package is registered (``configs/all.py``
imports them and lists the ``ASSIGNED`` ones), with the paper's
``resnet50`` (``models/resnet.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional

# ---------------------------------------------------------------------------
# sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    shared_expert_ff: int = 0        # llama4: one always-on shared expert
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    load_balance_coef: float = 1e-2
    every: int = 1                   # MoE every N layers (llama4 interleaves: 2)


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block hyper-params."""
    state_dim: int = 64
    num_heads: int = 32
    head_dim: int = 64
    conv_width: int = 4
    chunk_size: int = 256
    expand: int = 2                  # d_inner = expand * d_model


@dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 3             # every 3rd block is sLSTM, rest mLSTM
    chunk_size: int = 64
    conv_width: int = 4


@dataclass(frozen=True)
class ButterflyConfig:
    """The paper's contribution: a trained bottleneck at a layer boundary.

    ``layer`` — the butterfly is placed after this many layers (the boundary
    between the edge stage and the cloud stage).  ``d_r`` — reduced channel
    (d_model) size.  ``wire_bits`` — wire quantization (paper: 8).
    ``rate_weight`` — weight of the entropy-rate term (expected coded
    bits/symbol of the wire codes, ``wire_codec.rate_bits``) in the training
    loss; 0 disables it (the fixed-rate baseline).  BottleNet-style: the
    reduce projection learns low-entropy codes the rANS wire codec can
    actually exploit.
    """
    layer: int
    d_r: int
    wire_bits: int = 8
    rate_weight: float = 0.0


# ---------------------------------------------------------------------------
# main config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                   # dense | moe | vlm | audio | ssm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // num_heads
    qk_norm: bool = False
    act: str = "silu"                # silu -> SwiGLU, gelu -> GeGLU
    rope_theta: float = 1e6
    rms_eps: float = 1e-6
    logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None   # window for local attention layers
    global_every: Optional[int] = None     # gemma3: one global layer per N
    tie_embeddings: bool = True
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    hybrid_attn_every: Optional[int] = None  # zamba2: shared attn every N layers
    # encoder-decoder (whisper)
    is_encdec: bool = False
    encoder_layers: int = 0
    encoder_frames: int = 1500       # stub frontend output length
    # vlm
    num_patches: int = 0             # stub vision frontend output length
    # the paper's technique (None = vanilla model)
    butterfly: Optional[ButterflyConfig] = None
    # long-context: window applied to *all* attention layers for long_500k
    long_context_window: Optional[int] = None
    dtype: str = "bfloat16"
    source: str = ""                 # citation for the config numbers

    # -- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def with_butterfly(self, layer: int, d_r: int, wire_bits: int = 8,
                       rate_weight: float = 0.0) -> "ModelConfig":
        return replace(self, butterfly=ButterflyConfig(
            layer=layer, d_r=d_r, wire_bits=wire_bits,
            rate_weight=rate_weight))

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant of the same family: 2 layers, d_model<=512, <=4 experts."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.num_heads, 4)
        n_kv = min(self.num_kv_heads, max(1, n_heads // 2))
        moe = None
        if self.moe is not None:
            moe = replace(self.moe, num_experts=4, top_k=min(self.moe.top_k, 2),
                          d_ff_expert=min(self.moe.d_ff_expert, 128),
                          shared_expert_ff=min(self.moe.shared_expert_ff, 128),
                          every=1)
        ssm = None
        if self.ssm is not None:
            ssm = replace(self.ssm, num_heads=4, head_dim=32, state_dim=16,
                          chunk_size=32)
        xl = None
        if self.xlstm is not None:
            xl = replace(self.xlstm, slstm_every=2, chunk_size=16)
        num_layers = 2
        butterfly = None
        if self.butterfly is not None:
            butterfly = ButterflyConfig(layer=1, d_r=max(8, d_model // 8),
                                        wire_bits=self.butterfly.wire_bits)
        return replace(
            self,
            name=self.name + "-reduced",
            num_layers=num_layers,
            d_model=d_model,
            num_heads=n_heads,
            num_kv_heads=n_kv,
            head_dim=64 if self.head_dim else None,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else None,
            global_every=2 if self.global_every else None,
            hybrid_attn_every=2 if self.hybrid_attn_every else None,
            moe=moe, ssm=ssm, xlstm=xl,
            encoder_layers=2 if self.is_encdec else 0,
            encoder_frames=16 if self.is_encdec else self.encoder_frames,
            num_patches=8 if self.num_patches else 0,
            long_context_window=min(self.long_context_window, 64) if self.long_context_window else None,
            butterfly=butterfly,
            dtype="float32",
        )


# ---------------------------------------------------------------------------
# input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def _import_archs():
    # the per-arch modules are imported lazily so `register` runs
    import repro_torch.configs.all  # noqa: F401


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        _import_archs()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    _import_archs()
    return sorted(_REGISTRY)


def supports_shape(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """Which (arch x shape) pairs run; mirrors DESIGN.md section 5."""
    if shape.name == "long_500k":
        ok = cfg.arch_type in ("ssm", "hybrid") or cfg.xlstm is not None or \
            cfg.long_context_window is not None
        if not ok:
            return False, "pure full-attention arch: long_500k skipped (DESIGN.md 5)"
    return True, ""
