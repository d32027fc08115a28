"""Plain PyTorch reference of Qwen3 split by the butterfly unit, and the
weights both it and the program run on.

Qwen3 (https://huggingface.co/Qwen/Qwen3-8B): token embedding; per layer
an RMSNorm, grouped-query attention (q and k each RMS-normed per head,
rotary embedding over the two halves of a head, causal softmax scaled by
``1/sqrt(head_dim)``, no biases), a residual, an RMSNorm, a SwiGLU MLP
(``(silu(h Wg) * h Wu) Wd``) and a residual; a final RMSNorm and an
untied LM head.  The paper's butterfly unit sits after layer ``split``:
``r = x W_reduce`` (d -> d_r), per-token symmetric int8 quantization
(``scale = max|r| / 127``, codes rounded half to even), dequantization
and ``x = r_hat W_restore`` (d_r -> d).

Everything here runs in float32 with TF32 off, one layer's weights
upcast at a time, and reads only the weights it is handed: it imports
nothing of the program.  Departures from the published model: the RMSNorm
gains are stored as offsets from one (``g = 1 + w``), the layout the
program takes; the butterfly is the paper's addition.

``mm`` replaces every linear layer's product (the attention's own score
and value products stay float32): :func:`fp8_mm` is the control, the
reference in the nearest precision below the configuration's bfloat16.
"""
from __future__ import annotations

import contextlib
import math

import torch


# --------------------------------------------------------------- weights
def make_weights(cfg: dict, seed: int, device):
    """(params, butterfly): random weights drawn from ``seed`` on
    ``device`` in a few large calls, in the configuration's dtype
    (``torch_dtype``) and the tree layout the program's split
    bank takes (``params=``; ``butterfly=`` maps the split to the second).
    Every layer is alike, so the stage is one segment whose leaves are
    stacked over the layers.  Matrices are normal with variance 1/fan_in,
    embedding and head rows with variance 1/hidden_size, RMSNorm gain
    offsets 0.1 times normal."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    dtype = getattr(torch, cfg["torch_dtype"])
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    H, K = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    ff, L, V = cfg["intermediate_size"], cfg["num_hidden_layers"], cfg["vocab_size"]
    d_r = cfg["split"]["d_r"]

    def normal(shape, fan_in):
        t = torch.randn(shape, generator=g, device=device, dtype=dtype)
        return t.mul_(1.0 / math.sqrt(fan_in))

    def gain(shape):
        return torch.randn(shape, generator=g, device=device, dtype=dtype).mul_(0.1)

    layer = {
        "norm1": gain((L, d)),
        "mixer": {"wq": normal((L, d, H * hd), d),
                  "wk": normal((L, d, K * hd), d),
                  "wv": normal((L, d, K * hd), d),
                  "wo": normal((L, H * hd, d), H * hd),
                  "q_norm": gain((L, hd)),
                  "k_norm": gain((L, hd))},
        "norm2": gain((L, d)),
        "ffn": {"w_gate": normal((L, d, ff), d),
                "w_up": normal((L, d, ff), d),
                "w_down": normal((L, ff, d), ff)},
    }
    params = {"embed": normal((V, d), d), "final_norm": gain((d,)),
              "head": normal((V, d), d), "stages": [[[layer]]]}
    butterfly = {"w_reduce": normal((d, d_r), d),
                 "w_restore": normal((d_r, d), d_r)}
    return params, butterfly


# --------------------------------------------------------------- pieces
def f32_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return a @ w


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (its absolute maximum onto e4m3's 448), back in float32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def fp8_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The control's linear product: activations rounded to e4m3 with a
    scale a row, weights with a scale an output column, summed in float32
    (an fp8 GEMM's arithmetic)."""
    return _fp8(a, -1) @ _fp8(w, 0)


def rms_norm(x, w, eps):
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return x * (1.0 + w.float())


def rope(x, theta):
    """x (B, S, heads, hd): rotate the pair (x[i], x[i + hd/2]) of each
    position p by ``p * theta**(-2i/hd)``."""
    S, hd = x.shape[1], x.shape[-1]
    freqs = theta ** (-torch.arange(0, hd, 2, device=x.device,
                                    dtype=torch.float32) / hd)
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] * freqs
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v):
    """Causal grouped-query attention in float32: q (B, S, H, hd), k and v
    (B, S, K, hd) -> (B, S, H * hd)."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    q = q.reshape(B, S, K, H // K, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", q, k) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    probs = scores.masked_fill(~mask, float("-inf")).softmax(-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(B, S, H * hd)


def wire(x, butterfly, mm):
    """The butterfly unit with its int8 wire (``wire_bits`` 8)."""
    r = mm(x, butterfly["w_reduce"].float())
    scale = r.abs().amax(-1, keepdim=True).clamp(min=1e-8) / 127.0
    codes = torch.clamp(torch.round(r / scale), -128, 127)
    return mm(codes * scale, butterfly["w_restore"].float())


@contextlib.contextmanager
def _full_f32():
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


# --------------------------------------------------------------- forward
@torch.no_grad()
def last_logits(params, butterfly, cfg: dict, tokens: torch.Tensor,
                mm=f32_mm) -> torch.Tensor:
    """float32 logits (B, V) at the last position of ``tokens`` (B, S) on
    the weights' device, the butterfly after layer ``cfg["split"]["layer"]``."""
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    H, K = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    eps, theta = cfg["rms_norm_eps"], float(cfg["rope_theta"])
    split = cfg["split"]["layer"]
    lp = params["stages"][0][0][0]
    with _full_f32():
        tokens = tokens.to(params["embed"].device)
        B, S = tokens.shape
        x = params["embed"][tokens].float()
        for i in range(cfg["num_hidden_layers"]):
            if i == split:
                x = wire(x, butterfly, mm)
            at, ffn = lp["mixer"], lp["ffn"]
            h = rms_norm(x, lp["norm1"][i], eps)
            q = mm(h, at["wq"][i].float()).reshape(B, S, H, hd)
            k = mm(h, at["wk"][i].float()).reshape(B, S, K, hd)
            v = mm(h, at["wv"][i].float()).reshape(B, S, K, hd)
            q = rope(rms_norm(q, at["q_norm"][i], eps), theta)
            k = rope(rms_norm(k, at["k_norm"][i], eps), theta)
            x = x + mm(attention(q, k, v), at["wo"][i].float())
            h = rms_norm(x, lp["norm2"][i], eps)
            gate = torch.nn.functional.silu(mm(h, ffn["w_gate"][i].float()))
            x = x + mm(gate * mm(h, ffn["w_up"][i].float()),
                       ffn["w_down"][i].float())
        h = rms_norm(x[:, -1], params["final_norm"], eps)
        return mm(h, params["head"].float().t())
