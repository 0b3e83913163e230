"""Analytic MODEL_FLOPS per (arch x shape): the useful matmul work, counted
from the architecture dimensions (fwd 2MNK per matmul; train = 3x fwd; no
remat, no dispatch waste).  The roofline reports traced FLOPs / MODEL_FLOPS
to expose recompute/redundancy.  Counterpart of ``repro.roofline.analytic``:
the same config arithmetic on the port's configs and parameter specs.
"""

from __future__ import annotations

from ..configs.base import ModelConfig, ShapeConfig
from ..models.ssm import mamba2_dims, rwkv6_dims


def _attn_proj_flops_per_tok(cfg: ModelConfig) -> float:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    return 2 * d * (qd + 2 * kvd) + 2 * qd * d


def _mlp_flops_per_tok(cfg: ModelConfig, d_ff=None) -> float:
    ff = cfg.d_ff if d_ff is None else d_ff
    mats = 3 if cfg.act == "swiglu" else 2
    return 2 * cfg.d_model * ff * mats


def _moe_flops_per_tok(cfg: ModelConfig) -> float:
    route = 2 * cfg.d_model * cfg.n_experts
    active = cfg.top_k * _mlp_flops_per_tok(cfg)
    shared = _mlp_flops_per_tok(cfg) if cfg.shared_expert else 0
    return route + active + shared


def _attn_score_flops(cfg: ModelConfig, s: int, causal: bool = True,
                      kv_len=None) -> float:
    """Per-sequence attention einsum flops (qk + av)."""
    kv = s if kv_len is None else kv_len
    if cfg.sliding_window is not None:
        kv = min(kv, cfg.sliding_window)
    pairs = s * kv * (0.5 if (causal and kv_len is None) else 1.0)
    return 2 * 2 * pairs * cfg.q_dim


def _mamba_flops_per_tok(cfg: ModelConfig) -> float:
    dims = mamba2_dims(cfg)
    proj = 2 * cfg.d_model * dims["in_dim"] + 2 * dims["d_inner"] * cfg.d_model
    conv = 2 * 4 * dims["conv_dim"]
    # state recurrence: update + readout ~ 4*h*n*p per token
    ssm = 4 * dims["n_heads"] * dims["d_state"] * dims["p"]
    return proj + conv + ssm


def _rwkv_flops_per_tok(cfg: ModelConfig) -> float:
    d = cfg.d_model
    dims = rwkv6_dims(cfg)
    tm = 5 * 2 * d * d + 2 * d * d            # r,k,v,g,w projections + out
    lora = 2 * d * dims["lora"] * 2
    wkv = 4 * dims["h"] * dims["p"] * dims["p"]
    cm = 2 * d * cfg.d_ff * 2 + 2 * d * d     # channel mix
    return tm + lora + wkv + cm


def _head_flops_per_tok(cfg: ModelConfig) -> float:
    return 2 * cfg.d_model * cfg.padded_vocab


def forward_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """One forward pass over the full batch for this cell's step kind."""
    b, s = shape.global_batch, shape.seq_len
    f = cfg.family
    if shape.kind == "decode":
        toks = b                                   # one new token per seq
        ctx = s
    else:
        toks = b * s
        ctx = s

    if f in ("dense", "moe", "vlm"):
        per_tok = _attn_proj_flops_per_tok(cfg)
        per_tok += _moe_flops_per_tok(cfg) if cfg.n_experts else \
            _mlp_flops_per_tok(cfg)
        total = cfg.n_layers * per_tok * toks
        if shape.kind == "decode":
            kv = ctx if cfg.sliding_window is None else min(
                ctx, cfg.sliding_window)
            total += cfg.n_layers * b * 2 * 2 * kv * cfg.q_dim
        else:
            total += cfg.n_layers * b * _attn_score_flops(cfg, s)
        total += toks * _head_flops_per_tok(cfg) if shape.kind != "decode" \
            else b * _head_flops_per_tok(cfg)
        return total

    if f == "encdec":
        t_enc = max(s // cfg.enc_frames_ratio, 1)
        enc_tok = b * t_enc if shape.kind != "decode" else 0
        enc = cfg.n_enc_layers * (enc_tok * (_attn_proj_flops_per_tok(cfg)
                                             + _mlp_flops_per_tok(cfg))
                                  + (b * _attn_score_flops(cfg, t_enc,
                                                           causal=False)
                                     if enc_tok else 0))
        dec_tok = toks
        dec = cfg.n_layers * dec_tok * (2 * _attn_proj_flops_per_tok(cfg)
                                        + _mlp_flops_per_tok(cfg))
        if shape.kind == "decode":
            dec += cfg.n_layers * b * 2 * 2 * (ctx + t_enc) * cfg.q_dim
        else:
            dec += cfg.n_layers * b * (_attn_score_flops(cfg, s)
                                       + 2 * 2 * s * t_enc * cfg.q_dim)
        head = (toks if shape.kind != "decode" else b) * _head_flops_per_tok(cfg)
        return enc + dec + head

    if f == "ssm":
        total = cfg.n_layers * toks * _rwkv_flops_per_tok(cfg)
        total += (toks if shape.kind != "decode" else b) * \
            _head_flops_per_tok(cfg)
        return total

    if f == "hybrid":
        total = cfg.n_layers * toks * _mamba_flops_per_tok(cfg)
        n_apps = cfg.n_layers // cfg.shared_attn_period
        shared_per_tok = (2 * (2 * cfg.d_model) * cfg.d_model     # down proj
                          + _attn_proj_flops_per_tok(cfg)
                          + _mlp_flops_per_tok(cfg))
        total += n_apps * toks * shared_per_tok
        if shape.kind == "decode":
            total += n_apps * b * 2 * 2 * ctx * cfg.q_dim
        else:
            total += n_apps * b * _attn_score_flops(cfg, s)
        total += (toks if shape.kind != "decode" else b) * \
            _head_flops_per_tok(cfg)
        return total

    raise ValueError(f)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS for the cell's step: train = 3x forward (fwd + 2x bwd),
    prefill/decode = forward only."""
    fwd = forward_flops(cfg, shape)
    return 3 * fwd if shape.is_train else fwd


def active_params(cfg: ModelConfig) -> float:
    """Per-token active parameter count (MoE counts top_k + shared)."""
    from ..models import model_api, param_count
    total = param_count(model_api(cfg, device="cpu").param_specs())
    if not cfg.n_experts:
        return total
    # replace expert banks with the active subset
    ff_mats = 3 if cfg.act == "swiglu" else 2
    expert_params = cfg.n_layers * cfg.n_experts * ff_mats * \
        cfg.d_model * cfg.d_ff
    active_experts = cfg.n_layers * cfg.top_k * ff_mats * \
        cfg.d_model * cfg.d_ff
    return total - expert_params + active_experts


# ---------------------------------------------------------------------------
# Analytic HBM traffic (fused lower bound)
# ---------------------------------------------------------------------------

def hbm_bytes_per_device(cfg: ModelConfig, shape: ShapeConfig,
                         chips: int, tp: int = 16) -> float:
    """Per-device HBM traffic assuming perfect elementwise fusion — the
    irreducible streams: weights touched per pass, layer-boundary activation
    checkpoints, KV/recurrent state, loss logits, optimizer state.

    The traced 'bytes accessed' (``LoweredStep.cost``) counts every op's
    inputs and outputs, unfused, so the roofline reports BOTH that upper
    bound and this fused lower bound; an eager step on the card lies
    between them.
    """
    from ..models import model_api, param_count
    b, s = shape.global_batch, shape.seq_len
    n_params = param_count(model_api(cfg, device="cpu").param_specs())
    params_b = n_params * 2                                      # bf16
    d = cfg.d_model
    kv_bytes_tok = (1 if cfg.kv_cache_dtype == "int8" else 2)

    if shape.kind == "train":
        b_loc = max(b // (chips // tp), 1)
        passes = 3 + (1 if cfg.remat in ("full",) else 0)        # fwd+bwd+remat
        weights = passes * params_b / tp                          # gathered/TP
        layers = cfg.n_layers + cfg.n_enc_layers
        acts = 2 * layers * b_loc * s * d * 2                     # ckpt in+out
        logits = 2 * b_loc * s * cfg.padded_vocab * 4 / tp        # CE chunks
        opt = 2 * n_params * 12 / chips
        return weights + acts + logits + opt
    if shape.kind == "prefill":
        b_loc = max(b // (chips // tp), 1)
        weights = params_b / tp
        layers = cfg.n_layers + cfg.n_enc_layers
        acts = 2 * layers * b_loc * s * d * 2
        cache = cfg.n_layers * b_loc * min(
            s, cfg.sliding_window or s) * cfg.kv_dim * 2 * kv_bytes_tok
        return weights + acts + cache
    # decode: stream resident weights + the KV/state working set
    weights = params_b / tp
    b_loc = max(b // (chips // tp), 1)
    if cfg.family in ("ssm",):
        state = cfg.n_layers * b_loc * cfg.n_heads * cfg.d_head ** 2 * 4 * 2
        return weights + state
    eff = min(s, cfg.sliding_window or s)
    kv = cfg.n_layers * b_loc * eff * cfg.kv_dim * 2 * kv_bytes_tok
    if cfg.family == "hybrid":
        kv = (cfg.n_layers // max(cfg.shared_attn_period, 1)) * b_loc * eff \
            * cfg.kv_dim * 2 * kv_bytes_tok
    return weights + kv
