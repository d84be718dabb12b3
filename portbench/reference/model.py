"""Plain float32 forward of the benchmark's decoder models.

The reference that the served tokens are judged by: a decoder-only
transformer with RoPE, grouped-query attention, RMSNorm and a SwiGLU FFN or
a top-k mixture of experts, written from the configuration file alone, one
layer at a time over the whole sequence, with no cache, no kernel and no
batching trick.  It imports nothing of the program.  The parameters are the
tensors the benchmark drew from the seed, named as the program's checkpoint
tree names them (``segments/seg0/u0/mixer/wq`` stacked over layers).

The arithmetic is the configuration's as it is run (``departures`` in the
configuration file): RMSNorm ``x * rsqrt(mean(x^2) + eps) * (1 + scale)``,
RoPE over the whole head (rotate-half, theta from the file), the top-k
weights renormalised to sum to 1 when ``norm_topk_prob`` is true.

``quant="fp8"`` is the control: every operand of every product with a weight
matrix (activations and weights, the LM head too) rounded to float8 e4m3
with one scale a tensor, as an fp8 GEMM path would round them, the rest in
float32.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

FP8_MAX = 448.0          # largest finite float8 e4m3fn


def _plain_precision() -> None:
    """Float32 products in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale, back in float32."""
    amax = x.abs().max().clamp_min(1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def _linear(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]):
    w = w.float()
    if quant == "fp8":
        return fp8_round(x) @ fp8_round(w)
    return x @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * (1.0 + scale.float())


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x (L, H, D), positions (L,): rotate-half RoPE over the whole head."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float64) / d))
    ang = positions.float()[:, None] * inv.float().to(x.device)[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(cfg: dict, p: Dict[str, torch.Tensor], x, quant):
    """Causal self-attention of one sequence x (L, d)."""
    L = x.shape[0]
    H, K = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = cfg["head_dim"]
    pos = torch.arange(L, device=x.device)
    q = rope(_linear(x, p["wq"], quant).view(L, H, D), pos, cfg["rope_theta"])
    k = rope(_linear(x, p["wk"], quant).view(L, K, D), pos, cfg["rope_theta"])
    v = _linear(x, p["wv"], quant).view(L, K, D)
    k = k.repeat_interleave(H // K, dim=1)              # head h reads h // G
    v = v.repeat_interleave(H // K, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) * D ** -0.5
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)
    return _linear(o.reshape(L, H * D), p["wo"], quant)


def swiglu(x, wi, wg, wo, quant):
    return _linear(torch.nn.functional.silu(_linear(x, wg, quant))
                   * _linear(x, wi, quant), wo, quant)


def moe(cfg: dict, p: Dict[str, torch.Tensor], x, quant):
    """Dropless top-k mixture of experts over x (L, d)."""
    k = cfg["num_experts_per_tok"]
    probs = torch.softmax(_linear(x, p["router"], quant), dim=-1)
    w, e = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, e = w[:, :k], e[:, :k]
    if cfg.get("norm_topk_prob", False):
        w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    out = torch.zeros_like(x)
    for ex in torch.unique(e).tolist():
        rows, slot = torch.nonzero(e == ex, as_tuple=True)
        y = swiglu(x[rows], p["wi"][ex], p["wg"][ex], p["wo"][ex], quant)
        out.index_add_(0, rows, y * w[rows, slot][:, None])
    return out


def _layer(params: Dict[str, torch.Tensor], prefix: str, i: int):
    n = len(prefix)
    return {k[n:]: v[i] for k, v in params.items() if k.startswith(prefix)}


def forward_logits(cfg: dict, params: Dict[str, torch.Tensor],
                   tokens: torch.Tensor, first: int,
                   quant: Optional[str] = None) -> torch.Tensor:
    """Logits (L - first, V) in float32 at positions first.. of one
    sequence ``tokens`` (L,)."""
    _plain_precision()
    eps = cfg["rms_norm_eps"]
    x = params["embed"][tokens.long()].float()
    base = "segments/seg0/u0/"
    for i in range(cfg["num_hidden_layers"]):
        lp = _layer(params, base, i)
        h = rms_norm(x, lp["norm1/scale"], eps)
        x = x + attention(cfg, {k[6:]: v for k, v in lp.items()
                                if k.startswith("mixer/")}, h, quant)
        h = rms_norm(x, lp["norm2/scale"], eps)
        if "num_experts" in cfg:
            x = x + moe(cfg, {k[4:]: v for k, v in lp.items()
                              if k.startswith("moe/")}, h, quant)
        else:
            x = x + swiglu(h, lp["ffn/wi"], lp["ffn/wg"], lp["ffn/wo"], quant)
    h = rms_norm(x[first:], params["final_norm/scale"], eps)
    head = (params["embed"].t() if cfg["tie_word_embeddings"]
            else params["lm_head"])
    return _linear(h, head, quant)


def served_gaps(cfg: dict, params: Dict[str, torch.Tensor],
                prompts: torch.Tensor, served: torch.Tensor,
                quant: Optional[str] = None) -> torch.Tensor:
    """For prompts (B, T) and greedy tokens served after them (B, N): at each
    served position, how far the float32 reference's logit of the token lies
    below its best, (B, N).  With ``quant`` the token judged at each position
    is the one that reference in that precision puts first instead of the
    served one (the control: it needs no decode of its own)."""
    B, T = prompts.shape
    out = []
    for b in range(B):
        seq = torch.cat([prompts[b], served[b, :-1]]).to(prompts.device)
        ref = forward_logits(cfg, params, seq, T - 1)
        tok = served[b].long().to(ref.device)
        if quant is not None:
            tok = forward_logits(cfg, params, seq, T - 1, quant).argmax(-1)
        best = ref.max(-1).values
        out.append(best - ref.gather(-1, tok[:, None])[:, 0])
        del ref
    return torch.stack(out)
