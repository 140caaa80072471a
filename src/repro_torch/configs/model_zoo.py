"""GEMM-lowered workload zoo derived from the `configs/` architectures
(PyTorch port of `repro.configs.model_zoo`).

The paper's Fig. 7 DSE aggregates over four CNNs (+GPT-2M/ViT in our
extended table).  The repo, however, already carries ten published LLM/SSM/
enc-dec architectures as `ModelConfig`s — this module lowers each of them
to the `LayerShape` rows the analytical energy model consumes, so the
array-size DSE and the hybrid-mapping search can stress far more diverse
dataflows (GQA attention, MoE expert FFNs, MLA low-rank projections, SSD
projections + depthwise convs, shared-block hybrids, enc-dec cross
attention) than the CNN quartet.

Lowering conventions (one token batch of `seq_len`, decode-free prefill):
  * every dense projection is one GEMM row: M = tokens, K = in, N = out;
  * SwiGLU FFNs emit gate+up fused (N = 2*d_ff) plus the down projection;
  * MoE layers emit the router plus `top_k` activated expert FFN pairs —
    the token batch streams through top_k distinct expert weight sets, so
    weight-programming events scale with activated experts, matching the
    "activated parameters" accounting of the MoE papers;
  * Mamba-2 blocks emit the five projections and the width-4 depthwise
    causal conv (a grouped LayerShape); the SSD scan itself is not a GEMM
    the MRR array can hold stationary and stays electronic (ssm.py);
  * the LM head emits even for tied embeddings (the GEMM still executes);
  * embedding *lookups* are not GEMMs and are skipped.

Only `ModelConfig` metadata is touched — no parameters are materialized, so
building the full zoo is instant.
"""

from __future__ import annotations

from repro_torch.core.energy import LayerShape
from repro_torch.models.transformer import ModelConfig

ZOO_SEQ_LEN = 512      # prefill token batch used for zoo GEMM rows


def _gemm(name: str, m: int, k: int, n: int) -> LayerShape:
    return LayerShape(name, m=m, k=k, n=n, kind="gemm")


def _attn_rows(tag: str, cfg: ModelConfig, seq: int,
               kv_seq: int | None = None) -> list[LayerShape]:
    """QKV / output projections of one (self- or cross-) attention block."""
    hd = cfg.head_dim
    q_out = cfg.n_heads * hd
    kv_out = 2 * cfg.n_kv_heads * hd
    rows = [_gemm(f"{tag}_qkv", seq, cfg.d_model, q_out + kv_out)]
    if kv_seq is not None and kv_seq != seq:
        # cross-attention: queries from the decoder, K/V from the encoder
        rows = [_gemm(f"{tag}_q", seq, cfg.d_model, q_out),
                _gemm(f"{tag}_kv", kv_seq, cfg.d_model, kv_out)]
    rows.append(_gemm(f"{tag}_out", seq, q_out, cfg.d_model))
    return rows


def _mla_rows(tag: str, cfg: ModelConfig, seq: int) -> list[LayerShape]:
    mla = cfg.mla
    h = mla.n_heads
    return [
        _gemm(f"{tag}_dq", seq, mla.d_model, mla.q_lora),
        _gemm(f"{tag}_uq", seq, mla.q_lora, h * (mla.qk_nope + mla.qk_rope)),
        _gemm(f"{tag}_dkv", seq, mla.d_model, mla.kv_lora + mla.qk_rope),
        _gemm(f"{tag}_ukv", seq, mla.kv_lora, h * (mla.qk_nope + mla.v_head)),
        _gemm(f"{tag}_out", seq, h * mla.v_head, mla.d_model),
    ]


def _ffn_rows(tag: str, seq: int, d_model: int, d_ff: int) -> list[LayerShape]:
    return [_gemm(f"{tag}_wi", seq, d_model, 2 * d_ff),
            _gemm(f"{tag}_wo", seq, d_ff, d_model)]


def _moe_rows(tag: str, cfg: ModelConfig, seq: int) -> list[LayerShape]:
    moe = cfg.moe
    rows = [_gemm(f"{tag}_router", seq, moe.d_model, moe.n_experts)]
    for e in range(moe.top_k):
        rows += _ffn_rows(f"{tag}_exp{e}", seq, moe.d_model, moe.d_ff)
    if moe.n_shared:
        rows += _ffn_rows(f"{tag}_shared", seq, moe.d_model,
                          moe.n_shared * moe.d_ff)
    return rows


def _ssm_rows(tag: str, cfg: ModelConfig, seq: int) -> list[LayerShape]:
    ssm = cfg.ssm
    d, di = ssm.d_model, ssm.d_inner
    gs = ssm.n_groups * ssm.d_state
    return [
        _gemm(f"{tag}_x", seq, d, di),
        _gemm(f"{tag}_z", seq, d, di),
        _gemm(f"{tag}_bc", seq, d, 2 * gs),
        _gemm(f"{tag}_dt", seq, d, ssm.n_heads),
        # width-4 depthwise causal conv on x: d_inner independent channels
        LayerShape(f"{tag}_conv", m=seq, k=ssm.d_conv * di, n=di,
                   groups=di, kind="dwconv"),
        _gemm(f"{tag}_out", seq, di, d),
    ]


def layers_from_config(cfg: ModelConfig,
                       seq_len: int = ZOO_SEQ_LEN) -> list[LayerShape]:
    """Lower one `ModelConfig` to its GEMM LayerShape table."""
    seq = seq_len
    rows: list[LayerShape] = []

    if cfg.frontend == "vision":       # CLIP-style 16px patch embed stub
        rows.append(_gemm("vision_patch", 576, 3 * 16 * 16, cfg.d_model))
    elif cfg.frontend == "audio":      # fbank frame embed stub
        rows.append(_gemm("audio_frames", seq, 80 * 2, cfg.d_model))

    if cfg.is_encdec:
        # speech-to-text shape: the encoder sees the full frame sequence,
        # the decoder prefills a shorter text target; cross-attention K/V
        # projects from the encoder length, queries from the decoder's.
        dec_seq = max(1, seq // 2)
        for i in range(cfg.n_enc_layers):
            rows += _attn_rows(f"enc{i}_attn", cfg, seq)
            rows += _ffn_rows(f"enc{i}_ffn", seq, cfg.d_model, cfg.d_ff)
        for i in range(cfg.n_layers):
            rows += _attn_rows(f"dec{i}_attn", cfg, dec_seq)
            rows += _attn_rows(f"dec{i}_xattn", cfg, dec_seq, kv_seq=seq)
            rows += _ffn_rows(f"dec{i}_ffn", dec_seq, cfg.d_model, cfg.d_ff)
    elif cfg.family == "ssm":
        for i in range(cfg.n_layers):
            rows += _ssm_rows(f"l{i}", cfg, seq)
    elif cfg.family == "hybrid":
        n_shared = cfg.n_layers // cfg.shared_every if cfg.shared_every else 0
        for i in range(cfg.n_layers):
            rows += _ssm_rows(f"l{i}", cfg, seq)
        for j in range(n_shared):      # shared attn+MLP block applications
            rows += _attn_rows(f"shared{j}_attn", cfg, seq)
            rows += _ffn_rows(f"shared{j}_ffn", seq, cfg.d_model, cfg.d_ff)
    else:                              # dense | moe | mla_moe decoders
        for i in range(cfg.n_layers):
            if cfg.mla is not None:
                rows += _mla_rows(f"l{i}_attn", cfg, seq)
            else:
                rows += _attn_rows(f"l{i}_attn", cfg, seq)
            if cfg.moe is not None and not (i == 0 and cfg.first_dense_ff):
                rows += _moe_rows(f"l{i}_moe", cfg, seq)
            else:
                d_ff = cfg.first_dense_ff if (i == 0 and cfg.first_dense_ff) \
                    else cfg.d_ff
                rows += _ffn_rows(f"l{i}_ffn", seq, cfg.d_model, d_ff)

    head_seq = max(1, seq // 2) if cfg.is_encdec else seq   # decoder tokens
    rows.append(_gemm("lm_head", head_seq, cfg.d_model, cfg.vocab))
    return rows


def zoo_workloads(seq_len: int = ZOO_SEQ_LEN,
                  include_paper: bool = True,
                  archs: list[str] | None = None) -> "list":
    """`dse.Workload` list: the paper table/figure workloads plus every
    architecture in the config registry, GEMM-lowered at `seq_len`."""
    from repro_torch.configs import ARCHS, zoo_config
    from repro_torch.core.dse import Workload

    wls = []
    if include_paper:
        from repro_torch.configs.paper_cnns import WORKLOADS
        wls += [Workload(n, layers) for n, layers in WORKLOADS.items()]
    for name in (archs if archs is not None else ARCHS):
        cfg = zoo_config(name)
        wls.append(Workload(cfg.name, layers_from_config(cfg, seq_len)))
    return wls
