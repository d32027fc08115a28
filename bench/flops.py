"""Analytic operation and byte counts: the yardstick's own copy.

Forward FLOPs follow the port's ``core/costs.py`` conventions (a
multiply-add is 2 FLOPs) with one change: causal attention is counted
once, over the ``S (S + 1) / 2`` query-key pairs a causal mask keeps.
Kernel bytes count each input read once and each output written once.
"""
from __future__ import annotations


def dense_prefill_flops(cfg: dict, seq: int) -> float:
    """Forward FLOPs of one ``seq``-token prompt through a dense GQA model
    split by the butterfly (``cfg`` is a configuration file's dict): the
    layers' projections, causal attention and SwiGLU MLP, the reduce and
    restore projections, and the LM head at the last position only (the
    cloud half returns the last position's logits)."""
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    H, K = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    ff, L = cfg["intermediate_size"], cfg["num_hidden_layers"]
    d_r = cfg["split"]["d_r"]
    proj = 2 * seq * d * hd * (2 * H + 2 * K)           # q, o and k, v
    attn = 2 * H * hd * seq * (seq + 1)                 # scores + values
    mlp = 2 * seq * d * ff * 3
    wire = 2 * seq * d * d_r * 2                        # reduce + restore
    head = 2 * d * cfg["vocab_size"]
    return float(L * (proj + attn + mlp) + wire + head)


def reduce_quant_cost(rows: int, d: int, d_r: int, act_bytes: int = 2,
                      code_bytes: int = 1) -> tuple:
    """(FLOPs, bytes) of the fused reduce + quantize over ``rows`` rows:
    reads x (rows, d) and w_reduce (d, d_r), writes the codes (rows, d_r)
    and one f32 scale a row."""
    flops = 2 * rows * d * d_r
    nbytes = rows * d * act_bytes + d * d_r * act_bytes \
        + rows * d_r * code_bytes + rows * 4
    return float(flops), float(nbytes)


def dequant_restore_cost(rows: int, d: int, d_r: int, act_bytes: int = 2,
                         code_bytes: int = 1) -> tuple:
    """(FLOPs, bytes) of the fused dequantize + restore over ``rows`` rows:
    reads the codes (rows, d_r), the scales and w_restore (d_r, d), writes
    the restored (rows, d)."""
    flops = 2 * rows * d_r * d
    nbytes = rows * d_r * code_bytes + rows * 4 + d_r * d * act_bytes \
        + rows * d * act_bytes
    return float(flops), float(nbytes)


def widths(cfg: dict) -> tuple:
    """(activation bytes, code bytes) of a configuration: its dtype's width
    and the wire's code width (int8 up to 8 bits, int16 above)."""
    act = 2 if cfg["torch_dtype"] in ("bfloat16", "float16") else 4
    code = 1 if cfg["split"]["wire_bits"] <= 8 else 2
    return act, code


def least_seconds(cost: tuple, peaks: dict) -> float:
    """The least time the card could take for ``cost`` = (FLOPs, bytes):
    the larger of operations over the bf16 rate and bytes over the HBM
    rate."""
    flops, nbytes = cost
    return max(flops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes_per_s"])
