"""Config system: model/parallelism/shape configuration dataclasses.

Every assigned architecture is a ``ModelConfig`` in ``repro_torch/configs/<id>.py``;
``repro_torch.models.registry`` turns a config into a runnable model. Configs are
plain frozen dataclasses — serializable, diffable, and cheap to reduce for
smoke tests (``reduced()``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

SHAPES = {
    # name: (seq_len, global_batch, kind)
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0             # shared (always-on) experts, DeepSeekMoE
    dense_residual: bool = False  # dense FFN in parallel with MoE (Arctic)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str              # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None         # default d_model // n_heads
    qk_norm: bool = False                  # Qwen3-style per-head RMS on q/k
    sliding_window: Optional[int] = None   # SWA window (h2o-danube / Mistral)
    local_window: Optional[int] = None     # hybrid local-attn window (Griffin)
    layer_pattern: Optional[str] = None    # hybrid pattern, e.g. "rra"
    rope_theta: float = 10_000.0
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # encoder-decoder
    encoder_layers: int = 0
    # modality frontends are STUBS: input_specs provides precomputed embeddings
    frontend: Optional[str] = None         # None | "vision" | "audio"
    n_prefix_embeds: int = 0               # patch/frame embeddings per sample
    # training / performance knobs (hillclimbing levers, §Perf)
    remat: str = "full"                    # none | full
    grad_accum: int = 1
    scan_layers: bool = True
    q_chunk: int = 2048                    # attention query-chunk length
    attn_scores_f32: bool = True           # False: bf16 streaming softmax
    attn_batch_shard: bool = False         # policy-C fix: 2D batch-shard attn
    prefill_last_only: bool = False        # unembed only the final position
    seq_shard_resid: bool = False          # residual stream seq-sharded over
                                           # `model` (FSDP-ish: partitioner
                                           # gathers weights, not activations)
    kv_cache_int8: bool = False            # quantized KV cache (decode)
    kv_block_prune: int = 0                # keep top-k key blocks (0 = off)
    kv_block_size: int = 512               # zone-map block granularity
    kv_prune_groups: int = 0               # >0: top-k/groups WITHIN each block
                                           # group (shard-local, no x-dev gather)
    # dtype policy: weights/activations bf16, master+opt f32 (mixed precision)
    param_dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=max(2, min(3, self.n_layers)),
            d_model=128,
            n_heads=4,
            n_kv_heads=max(1, min(2, self.n_kv_heads)),
            d_ff=256,
            vocab_size=512,
            head_dim=32,
            n_prefix_embeds=8 if self.n_prefix_embeds else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            sliding_window=64 if self.sliding_window else None,
            local_window=32 if self.local_window else None,
            remat="none",
            grad_accum=1,
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=8, top_k=min(2, self.moe.top_k),
                d_ff_expert=64, n_shared=min(1, self.moe.n_shared))
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, state_dim=16, head_dim=16, chunk=32)
        if self.layer_pattern is not None:
            kw["n_layers"] = 3  # one full "rra"-style group
        return self.replace(**kw)

    # -- parameter counting (for MODEL_FLOPS = 6*N*D roofline term) --------
    def param_counts(self) -> dict[str, float]:
        """Returns dict with total and active (per-token) parameter counts."""
        d, hd = self.d_model, self.resolved_head_dim
        q = self.n_heads * hd
        kv = self.n_kv_heads * hd
        attn = d * q + 2 * d * kv + q * d
        dense_ffn = 3 * d * self.d_ff  # SwiGLU: gate, up, down
        per_layer_total = per_layer_active = 0.0
        if self.family == "ssm":
            s = self.ssm
            d_in = s.expand * d
            heads = d_in // s.head_dim
            zxbcdt = d * (2 * d_in + 2 * s.n_groups * s.state_dim + heads)
            per_layer_total = per_layer_active = zxbcdt + d_in * d + 2 * heads
        elif self.family == "hybrid":
            # average over the layer pattern
            pat = self.layer_pattern or "r"
            n_rec = pat.count("r") / len(pat)
            n_att = 1.0 - n_rec
            rec = 3 * d * d + 2 * d  # in/gate/out projections + lru params
            per_layer_total = per_layer_active = (
                n_rec * rec + n_att * attn + dense_ffn)
        else:
            per_layer_total = per_layer_active = attn
            if self.moe is not None:
                mo = self.moe
                e_ffn = 3 * d * mo.d_ff_expert
                per_layer_total += mo.n_experts * e_ffn + mo.n_shared * e_ffn + d * mo.n_experts
                per_layer_active += mo.top_k * e_ffn + mo.n_shared * e_ffn + d * mo.n_experts
                if mo.dense_residual:
                    per_layer_total += dense_ffn
                    per_layer_active += dense_ffn
            else:
                per_layer_total += dense_ffn
                per_layer_active += dense_ffn

        n_dec = self.n_layers
        total = n_dec * per_layer_total
        active = n_dec * per_layer_active
        if self.encoder_layers:
            enc = self.encoder_layers * (attn + dense_ffn)
            total += enc
            active += enc
            # decoder cross-attention
            total += n_dec * attn
            active += n_dec * attn
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total += emb
        active += emb
        return {"total": total, "active": active}
