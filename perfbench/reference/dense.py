"""The plain reference of a dense decoder: every position's logits in float32
(TF32 off), layer by layer, from the weights the benchmark drew.

It computes what the served model is defined to compute: a pre-norm
decoder whose blocks are x + attn(norm1(x)) and then x + mlp(norm2(x)),
with a final norm and an LM head (the embedding's transpose when tied).
Attention is causal with RoPE (rotate-half, f32 angles) on q and k,
1 / sqrt(head_dim) scaling, and grouped heads (query head h reads KV head
h // (H / KH)). The MLP is gelu_tanh(x W_i) W_o, or with ``act`` "silu"
silu(x W_g) * (x W_i) then W_o. LayerNorm has eps 1e-5, RMSNorm 1e-6.

Departures from the published models, as the served configurations
define them: positions by RoPE, where GPT-3 learns absolute position
embeddings, and no biases in the projections or the MLP.

``precision="fp8"`` is the control: every product's operands (the
activations a row at a time, the weights an output column at a time)
rounded to float8 e4m3 under an absmax scale, the rest in float32 as
above. It imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch

E4M3_MAX = 448.0


def _qdq(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 under a scale that maps the absmax along
    ``dim`` to the format's largest value; back in float32."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Linear:
    """x (rows, d_in) @ W (d_in, d_out) in float32, or through fp8."""

    def __init__(self, w: torch.Tensor, precision: str):
        w = w.float()
        self.fp8 = precision == "fp8"
        self.w = _qdq(w, dim=0) if self.fp8 else w

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            x = _qdq(x, dim=-1)
        return x @ self.w


def norm(x: torch.Tensor, scale, bias, kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) \
            * scale.float()
    mean = x.mean(-1, keepdim=True)
    xc = x - mean
    y = xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + 1e-5)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x * x * x)))


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, hd) at positions 0..S-1, rotate-half."""
    S, _, hd = x.shape
    half = hd // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     block: int) -> torch.Tensor:
    """q (S, H, hd), k and v (S, KH, hd) -> (S, H, hd), query blocks of
    ``block`` rows against the keys up to each block's end."""
    S, H, hd = q.shape
    KH = k.shape[1]
    G = H // KH
    out = torch.empty_like(q)
    kt = k.permute(1, 2, 0)                      # (KH, hd, S)
    vt = v.permute(1, 0, 2)                      # (KH, S, hd)
    for a in range(0, S, block):
        b = min(S, a + block)
        qb = q[a:b].reshape(b - a, KH, G, hd).permute(1, 2, 0, 3)
        s = (qb @ kt[:, None, :, :b]) / math.sqrt(hd)   # (KH, G, qb, b)
        qpos = torch.arange(a, b, device=q.device)[:, None]
        kpos = torch.arange(b, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = p @ vt[:, None, :b]                      # (KH, G, qb, hd)
        out[a:b] = o.permute(2, 0, 1, 3).reshape(b - a, H, hd)
    return out


def logits_at(sizes: dict, embed: Dict[str, torch.Tensor],
              final_norm: Dict[str, torch.Tensor],
              layer: Callable[[int], Dict[str, torch.Tensor]],
              seqs: Sequence[torch.Tensor], positions: Sequence[torch.Tensor],
              precision: str = "float32", block: int = 512
              ) -> List[torch.Tensor]:
    """The logits (len(positions[i]), V) float32 of each sequence
    ``seqs[i]`` (int64 token ids on the device) at ``positions[i]``.
    ``layer(l)`` gives layer l's weights {"attn/wq", "attn/wk", "attn/wv",
    "attn/wo", "ffn/wi", "ffn/wo" ("ffn/wg" gated), "norm1/scale", ...}
    in their served shapes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    d, H, KH = sizes["d_model"], sizes["num_heads"], sizes["num_kv_heads"]
    hd, kind = sizes["head_dim"], sizes["norm"]
    theta = float(sizes["rope_theta"])
    tok = embed["tok"]
    xs = [tok[s].float() for s in seqs]
    for li in range(sizes["num_layers"]):
        w = layer(li)
        lin = {n: Linear(w[n].reshape(w[n].shape[0] if n != "attn/wo"
                                      else H * hd, -1), precision)
               for n in ("attn/wq", "attn/wk", "attn/wv", "attn/wo",
                         "ffn/wi", "ffn/wo", "ffn/wg") if n in w}
        for i, x in enumerate(xs):
            S = x.shape[0]
            h = norm(x, w.get("norm1/scale"), w.get("norm1/bias"), kind)
            q = rope(lin["attn/wq"](h).reshape(S, H, hd), theta)
            k = rope(lin["attn/wk"](h).reshape(S, KH, hd), theta)
            v = lin["attn/wv"](h).reshape(S, KH, hd)
            o = causal_attention(q, k, v, block)
            x = x + lin["attn/wo"](o.reshape(S, H * hd))
            h = norm(x, w.get("norm2/scale"), w.get("norm2/bias"), kind)
            if "ffn/wg" in lin:
                m = torch.nn.functional.silu(lin["ffn/wg"](h)) \
                    * lin["ffn/wi"](h)
            else:
                m = gelu_tanh(lin["ffn/wi"](h))
            xs[i] = x + lin["ffn/wo"](m)
            del h, q, k, v, o, m
        del w, lin
    head = Linear(tok.t() if sizes["tie_embeddings"] else embed["lm_head"],
                  precision)
    out = []
    for x, pos in zip(xs, positions):
        h = norm(x[pos], final_norm.get("scale"), final_norm.get("bias"),
                 kind)
        out.append(head(h))
    return out
