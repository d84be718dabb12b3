"""Three-term roofline of one step (port of ``repro.launch.roofline``).

    compute    = flops / (chips × PEAK_FLOPS)
    memory     = hbm_bytes / (chips × HBM_BW)
    collective = collective_bytes / (chips × LINK_BW)

with the H100 constants of ``launch/mesh.py``.  The FLOPs and bytes come
from the aten-level accounting of ``launch/graph_analysis.py`` (the
reference parses optimized HLO); the collective bytes from the same
accounting or from the dry run's estimate over the partition specs
(``launch/dryrun.py``).  ``model_flops`` = 6·N·D (6·N_active·D for MoE)
plus the attention term bounds how much of the counted compute is
useful.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS


def collective_bytes(accounting: Dict[str, object]) -> Dict[str, int]:
    """Collective result bytes by kind (``all-reduce``, ``all-gather``,
    ``reduce-scatter``, ``all-to-all``) from an accounting, what
    ``graph_analysis.analyze`` or ``Accountant.result()`` gives."""
    return {k: int(v) for k, v in accounting["coll_bytes"].items()}


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: Dict[str, int]
    model_flops: float
    bytes_per_device: Optional[float] = None

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return sum(self.coll_bytes.values()) / (self.chips * LINK_BW)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_fraction(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline this step achieves, assuming the
        dominant term sets wall-clock: t_model_compute / max(all terms)."""
        t_model = self.model_flops / (self.chips * PEAK_FLOPS)
        t_bound = max(self.t_compute, self.t_memory, self.t_collective)
        return t_model / t_bound if t_bound else 0.0

    def row(self) -> str:
        return (f"| {self.arch} | {self.shape} | {self.mesh} "
                f"| {self.t_compute*1e3:.2f} | {self.t_memory*1e3:.2f} "
                f"| {self.t_collective*1e3:.2f} | {self.dominant} "
                f"| {self.useful_fraction*100:.0f}% "
                f"| {self.roofline_fraction*100:.1f}% |")


def model_flops(cfg, cell) -> float:
    """6·N_active·D (+ attention QKᵀ/PV term) per step, the reference's
    arithmetic in its order.

    train: fwd+bwd (3× fwd); prefill: fwd; decode: one token per sequence.
    The attention term uses the causal-effective context (T/2, or the
    window for local layers).  A prefill counts the LM head on all B·T
    positions, as the reference's formula does, though the port's prefill
    runs it on the last position only, so a prefill's ``useful_fraction``
    can exceed 1."""
    n_active = _active_params(cfg)
    B, T = cell.global_batch, cell.seq_len
    hd = cfg.resolved_head_dim
    attn_fwd = 0.0
    for l in range(cfg.n_layers):
        fl = cfg.pattern_at(l)
        if fl == "g":
            ctx = T / 2
        elif fl == "l":
            ctx = min(cfg.window or T, T)
        else:
            continue
        # QKᵀ + PV: 2 matmuls × 2 flops/MAC over (T × ctx × H × hd)
        attn_fwd += 4.0 * B * T * ctx * cfg.n_heads * hd
    if cfg.enc_dec:
        attn_fwd += 4.0 * B * T * cfg.encoder_len * cfg.n_heads * hd

    if cell.kind == "train":
        return (6.0 * n_active * B * T) + 3.0 * attn_fwd
    if cell.kind == "prefill":
        return (2.0 * n_active * B * T) + attn_fwd
    # decode: one new token attends to the whole context
    dec_attn = 0.0
    for l in range(cfg.n_layers):
        fl = cfg.pattern_at(l)
        if fl == "g":
            dec_attn += 4.0 * B * T * cfg.n_heads * hd
        elif fl == "l":
            dec_attn += 4.0 * B * min(cfg.window or T, T) * cfg.n_heads * hd
    return 2.0 * n_active * B + dec_attn


def _active_params(cfg) -> float:
    """Parameters one token passes through.  The encoder's attention counts
    its four d × (H·hd) projections; the reference's expression there
    (``roofline.py:184-186``) reduces to 4·d·hd and drops the other H - 1
    heads' share."""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    hd = cfg.resolved_head_dim
    total = V * d * (1 if cfg.tie_embeddings else 2)
    for l in range(L):
        fl = cfg.pattern_at(l)
        if fl in ("g", "l"):
            if cfg.mla is not None:
                m = cfg.mla
                qk = m.qk_nope_head_dim + m.qk_rope_head_dim
                total += (d * m.q_lora_rank + m.q_lora_rank * cfg.n_heads * qk
                          + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                          + m.kv_lora_rank * cfg.n_heads *
                          (m.qk_nope_head_dim + m.v_head_dim)
                          + cfg.n_heads * m.v_head_dim * d)
            else:
                total += d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) \
                    + cfg.n_heads * hd * d
        else:
            r = cfg.lru_dim or d
            total += 4 * d * r  # in/gate/out + gates (approx.)
        if cfg.moe_at(l):
            m = cfg.moe
            total += 3 * (m.top_k + m.num_shared) * d * m.d_expert \
                + d * m.num_experts
        elif cfg.d_ff:
            mult = 3 if cfg.ffn in ("swiglu", "geglu") else 2
            total += mult * d * cfg.d_ff
    if cfg.enc_dec:
        total += cfg.n_encoder_layers * (4 * d * hd * cfg.n_heads
                                         + 2 * d * cfg.d_ff)
        total += cfg.n_layers * 2 * d * hd * (cfg.n_heads + cfg.n_kv_heads)
    return float(total)


TABLE_HEADER = (
    "| arch | shape | mesh | t_comp ms | t_mem ms | t_coll ms "
    "| dominant | useful | roofline |\n"
    "|---|---|---|---|---|---|---|---|---|")
