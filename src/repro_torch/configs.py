"""Configurations of the paper's CNN family, the dense and MoE decoder LMs,
xLSTM, the Zamba2 hybrid, the vision decoder (Qwen2-VL) and the
encoder-decoder model (SeamlessM4T), for the PyTorch port.

A copy of what the CNN classification rig and the LM paths read from the
JAX package's ``configs/base.py`` (``SemiSFLConfig``, ``MoEConfig``,
``XLSTMConfig``, ``SSMConfig``, the CNN, dense-LM, MoE, MLA, xLSTM,
hybrid, M-RoPE, frontend and encoder-decoder fields of ``ArchConfig``,
``get_config`` and ``smoke_config``), of ``configs/paper_models.py``,
``configs/qwen3_14b.py``, ``configs/h2o_danube_1_8b.py``,
``configs/stablelm_1_6b.py``, ``configs/qwen2_5_14b.py``,
``configs/xlstm_1_3b.py``, ``configs/zamba2_7b.py``,
``configs/deepseek_v2_236b.py``, ``configs/arctic_480b.py``,
``configs/qwen2_vl_7b.py`` and ``configs/seamless_m4t_medium.py``, and of
the ``train_4k`` input shape.  The port keeps its own copy so that it
imports nothing of the JAX package."""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""

    num_experts: int
    top_k: int
    d_ff_expert: int
    # Dense residual MLP computed in parallel with the routed experts
    # (Snowflake Arctic style).  0 disables it.
    d_ff_dense_residual: int = 0
    # Experts always applied to every token (DeepSeek-V2 "shared experts").
    num_shared_experts: int = 0
    # Which layers are MoE layers: every layer with index >= first_moe_layer
    # and (index - first_moe_layer) % period == 0.
    first_moe_layer: int = 0
    period: int = 1
    # Token-dropping capacity factor of the JAX package's expert-parallel
    # path (not ported: the port runs every assignment)
    capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.001

    def is_moe_layer(self, idx: int) -> bool:
        return (idx >= self.first_moe_layer
                and (idx - self.first_moe_layer) % self.period == 0)


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block-stack configuration (mLSTM + periodic sLSTM)."""

    # one sLSTM block every `slstm_period` blocks (the rest are mLSTM);
    # xLSTM[7:1] from the paper -> period 8.
    slstm_period: int = 8
    mlstm_proj_factor: float = 2.0
    slstm_ff_factor: float = 4.0 / 3.0
    mlstm_head_dim: int = 512  # qk head dim after expansion / num_heads


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2-style selective state space configuration."""

    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4


@dataclass(frozen=True)
class SemiSFLConfig:
    """Paper-technique hyperparameters (Section III-V defaults)."""

    split_layer: int = 0                # 0 -> num_layers // 4 at build time
    proj_dim: int = 128                 # projection-head output dim
    proj_hidden: int = 256              # MLP projection head hidden width
    proj_head: str = "mlp"              # none | linear | mlp  (Table V)
    queue_len: int = 4096               # |Q| two-level memory queue
    temperature: float = 0.1            # kappa in Eq.(3)/(5)
    confidence_threshold: float = 0.95  # tau
    ema_decay: float = 0.99             # gamma
    k_s_init: int = 100                 # initial global updating frequency
    k_u: int = 10                       # cross-entity updating frequency
    alpha: float = 1.5                  # K_s decay factor, Eq.(10)
    beta: float = 8.0                   # K_min = floor(beta * |Dl|/|D| * K_u)
    observation_period: int = 10        # rounds per observation period
    adaptation_window: int = 10         # periods in R_h


@dataclass(frozen=True)
class ArchConfig:
    """The CNN, dense-LM, MoE, MLA, xLSTM, hybrid, M-RoPE, frontend and
    encoder-decoder fields of the JAX package's ``ArchConfig``."""

    name: str
    num_layers: int                     # the decoder's, for enc-dec
    # cnn | dense | moe | ssm | hybrid | vlm | audio
    arch_type: str = "cnn"
    # --- dense decoder LM ----------------------------------------------------
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0                   # 0 -> d_model // num_heads
    attn_bias: bool = False             # qwen2-style QKV bias
    qk_norm: bool = False               # qwen3-style per-head RMSNorm on q,k
    rope_kind: str = "rope"             # rope | mrope | none
    rope_theta: float = 1_000_000.0
    rope_pct: float = 1.0               # partial rotary
    # M-RoPE: the (temporal, height, width) planes' shares of the head_dim
    # // 2 frequency slots
    mrope_sections: Tuple[int, ...] = ()
    sliding_window: int = 0             # 0 -> full attention
    norm: str = "rmsnorm"               # rmsnorm | layernorm
    act: str = "silu"                   # silu | gelu | relu
    mlp_gated: bool = True              # SwiGLU-style gate
    # --- MLA (DeepSeek-V2) ---------------------------------------------------
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # --- block-stack structure -------------------------------------------------
    block_kind: str = "attn"            # attn | mamba2 | xlstm
    # hybrid (zamba2): one weight-shared attention block applied after every
    # `shared_attn_period` mamba blocks.
    shared_attn_period: int = 0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    dtype: str = "bfloat16"
    modality: str = "text"              # text | vision | audio
    # patch embeddings a sample puts ahead of its text (vision)
    frontend_tokens: int = 0
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    # --- CNN family (the paper's own models) ----------------------------------
    cnn_channels: Tuple[int, ...] = ()
    cnn_fc: Tuple[int, ...] = ()
    num_classes: int = 0
    image_size: int = 32
    # dropout on the FC-stack activations (AlexNet/VGG convention); live
    # only in train-mode forwards that are given dropout masks
    cnn_dropout: float = 0.0
    semisfl: SemiSFLConfig = field(default_factory=SemiSFLConfig)

    @property
    def resolved_head_dim(self) -> int:
        if self.use_mla:
            return self.qk_nope_head_dim + self.qk_rope_head_dim
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def split_layer(self) -> int:
        s = self.semisfl.split_layer
        if s <= 0:
            s = max(1, self.num_layers // 4)
        return min(s, self.num_layers - 1)

    def param_count(self) -> int:
        """The JAX package's analytic parameter count (read by the cost
        model), over the fields this copy has.  It is the reference's
        reckoning, over-count on the LMs included, not what the port
        builds."""
        d, ff, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        if self.arch_type == "cnn":
            total, cin, hw = 0, 3, self.image_size
            for cout in self.cnn_channels:
                total += cin * cout * 9 + cout
                cin = cout
                hw //= 2
            feat = cin * hw * hw
            for fc in self.cnn_fc:
                total += feat * fc + fc
                feat = fc
            total += feat * self.num_classes + self.num_classes
            return total

        def attn_params() -> int:
            hd = self.resolved_head_dim
            if self.use_mla:
                q = (d * self.q_lora_rank + self.q_lora_rank * self.num_heads
                     * hd if self.q_lora_rank else d * self.num_heads * hd)
                kv = (d * (self.kv_lora_rank + self.qk_rope_head_dim)
                      + self.kv_lora_rank * self.num_heads
                      * (self.qk_nope_head_dim + self.v_head_dim))
                return q + kv + self.num_heads * self.v_head_dim * d
            return (d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                    + self.num_heads * hd * d)

        def mlp_params(width: int) -> int:
            return d * width * (3 if self.mlp_gated else 2)

        def moe_params() -> int:
            m = self.moe
            return (d * m.num_experts
                    + (m.num_experts + m.num_shared_experts)
                    * mlp_params(m.d_ff_expert)
                    + (mlp_params(m.d_ff_dense_residual)
                       if m.d_ff_dense_residual else 0))

        def ssm_params() -> int:
            s = self.ssm or SSMConfig()
            d_in = s.expand * d
            nh = d_in // s.head_dim
            p = d * (2 * d_in + 2 * s.state_dim * (d_in // s.head_dim) + nh)
            p += s.conv_width * (d_in + 2 * s.state_dim * nh)
            p += d_in * d  # out proj
            return p

        total = V * d * 2
        for i in range(L + self.num_encoder_layers):
            if self.block_kind == "mamba2":
                total += ssm_params()
            elif self.block_kind == "xlstm":
                x = self.xlstm or XLSTMConfig()
                if (i + 1) % x.slstm_period == 0:
                    total += 4 * d * d + int(x.slstm_ff_factor * d) * d * 2
                else:
                    di = int(x.mlstm_proj_factor * d)
                    total += d * di * 2 + 3 * di * di // 4 + di * d
            else:
                total += attn_params()
                if self.moe is not None and self.moe.is_moe_layer(i):
                    total += moe_params()
                else:
                    total += mlp_params(ff)
            total += 2 * d  # norms
        if self.shared_attn_period:
            total += attn_params() + mlp_params(ff) + 2 * d
        if self.is_encoder_decoder:
            total += L * attn_params()  # cross attention
        if self.num_classes:
            total += d * self.num_classes
        return total


def _cnn(name, channels, fc, image_size, split, num_classes=10, dropout=0.0):
    return ArchConfig(
        name=name, num_layers=len(channels), cnn_channels=channels,
        cnn_fc=fc, num_classes=num_classes, image_size=image_size,
        cnn_dropout=dropout,
        semisfl=SemiSFLConfig(split_layer=split, proj_dim=64,
                              proj_hidden=128, queue_len=2048))


_REGISTRY = {c.name: c for c in (
    # (i) customized CNN on SVHN: two convs, FC 512, softmax 10
    _cnn("paper-cnn", channels=(32, 64), fc=(512,), image_size=32, split=2),
    # (ii) AlexNet on CIFAR-10; 0.5 dropout on the FC-4096 stack
    _cnn("paper-alexnet", channels=(64, 192, 384, 256, 256),
         fc=(4096, 4096), image_size=32, split=5, dropout=0.5),
    # (iii) VGG13 on STL-10; 0.5 FC dropout
    _cnn("paper-vgg13",
         channels=(64, 64, 128, 128, 256, 256, 512, 512, 512, 512),
         fc=(4096, 4096), image_size=96, split=10, dropout=0.5),
    # (iv) VGG16 on IMAGE-100; 0.5 FC dropout
    _cnn("paper-vgg16",
         channels=(64, 64, 128, 128, 256, 256, 256, 512, 512, 512,
                   512, 512, 512),
         fc=(4096, 4096), image_size=144, split=13, num_classes=100,
         dropout=0.5),
    # Qwen3-14B: dense GQA decoder with per-head qk RMSNorm
    ArchConfig(name="qwen3-14b", arch_type="dense", num_layers=40,
               d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
               d_ff=17408, vocab_size=151936, qk_norm=True, attn_bias=False,
               rope_theta=1_000_000.0),
    # H2O-Danube-1.8B (arXiv:2401.16818): llama + mistral mix with a 4096
    # sliding window, 32 query heads over 8 KV heads of 80
    ArchConfig(name="h2o-danube-1.8b", arch_type="dense", num_layers=24,
               d_model=2560, num_heads=32, num_kv_heads=8, head_dim=80,
               d_ff=6912, vocab_size=32000, sliding_window=4096,
               rope_theta=10_000.0),
    # StableLM-2-1.6B (hf:stabilityai/stablelm-2-1_6b): MHA, partial rotary,
    # LayerNorm
    ArchConfig(name="stablelm-1.6b", arch_type="dense", num_layers=24,
               d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
               d_ff=5632, vocab_size=100352, rope_theta=10_000.0,
               rope_pct=0.25, norm="layernorm", act="silu", mlp_gated=True),
    # Qwen2.5-14B (hf:Qwen/Qwen2.5-0.5B family card): GQA with QKV bias
    ArchConfig(name="qwen2.5-14b", arch_type="dense", num_layers=48,
               d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
               d_ff=13824, vocab_size=152064, attn_bias=True,
               rope_theta=1_000_000.0, norm="rmsnorm", act="silu",
               mlp_gated=True),
    # xLSTM-1.3B (arXiv:2405.04517): 48 blocks, one sLSTM every 8, the rest
    # mLSTM; d_ff 0, the blocks carry their own up-projections
    ArchConfig(name="xlstm-1.3b", arch_type="ssm", num_layers=48,
               d_model=2048, num_heads=4, num_kv_heads=4, head_dim=512,
               d_ff=0, vocab_size=50304, block_kind="xlstm",
               xlstm=XLSTMConfig(slstm_period=8, mlstm_proj_factor=2.0,
                                 slstm_ff_factor=4.0 / 3.0,
                                 mlstm_head_dim=512),
               rope_kind="none", norm="layernorm", act="gelu"),
    # Zamba2-7B (arXiv:2411.15242): 81 Mamba2 layers, one weight-shared
    # attention + MLP block applied after every 6 of them
    ArchConfig(name="zamba2-7b", arch_type="hybrid", num_layers=81,
               d_model=3584, num_heads=32, num_kv_heads=32, head_dim=112,
               d_ff=14336, vocab_size=32000, block_kind="mamba2",
               shared_attn_period=6,
               ssm=SSMConfig(state_dim=64, head_dim=64, expand=2,
                             conv_width=4),
               rope_theta=10_000.0),
    # DeepSeek-V2 236B (arXiv:2405.04434): MLA (kv_lora 512) + MoE of 160
    # routed experts, top 6, and 2 shared experts; layer 0 keeps the dense
    # MLP
    ArchConfig(name="deepseek-v2-236b", arch_type="moe", num_layers=60,
               d_model=5120, num_heads=128, num_kv_heads=128, d_ff=12288,
               vocab_size=102400, use_mla=True, kv_lora_rank=512,
               q_lora_rank=1536, qk_nope_head_dim=128, qk_rope_head_dim=64,
               v_head_dim=128,
               moe=MoEConfig(num_experts=160, top_k=6, d_ff_expert=1536,
                             num_shared_experts=2, first_moe_layer=1,
                             period=1, capacity_factor=1.25),
               rope_theta=10_000.0),
    # Snowflake Arctic 480B (hf:Snowflake/snowflake-arctic-base): 128
    # experts top 2 with a dense residual MLP in parallel
    ArchConfig(name="arctic-480b", arch_type="moe", num_layers=35,
               d_model=7168, num_heads=56, num_kv_heads=8, head_dim=128,
               d_ff=4864, vocab_size=32000,
               moe=MoEConfig(num_experts=128, top_k=2, d_ff_expert=4864,
                             d_ff_dense_residual=4864, first_moe_layer=0,
                             period=1, capacity_factor=1.25),
               rope_theta=10_000.0),
    # Qwen2-VL-7B (arXiv:2409.12191), the language backbone: M-RoPE over
    # (temporal, height, width) position planes, the vision encoder a stub
    # (patch embeddings given as input, ahead of the text)
    ArchConfig(name="qwen2-vl-7b", arch_type="vlm", num_layers=28,
               d_model=3584, num_heads=28, num_kv_heads=4, head_dim=128,
               d_ff=18944, vocab_size=152064, attn_bias=True,
               rope_kind="mrope", mrope_sections=(16, 24, 24),
               rope_theta=1_000_000.0, modality="vision",
               frontend_tokens=1024),
    # SeamlessM4T-medium (arXiv:2308.11596), the transformer backbone: a
    # non-causal encoder over frame embeddings (the audio frontend a stub)
    # and a causal decoder with cross-attention, 12 layers each
    ArchConfig(name="seamless-m4t-medium", arch_type="audio", num_layers=12,
               num_encoder_layers=12, is_encoder_decoder=True, d_model=1024,
               num_heads=16, num_kv_heads=16, head_dim=64, d_ff=4096,
               vocab_size=256206, norm="layernorm", act="relu",
               mlp_gated=False, rope_theta=10_000.0, modality="audio",
               frontend_tokens=0),
)}


@dataclass(frozen=True)
class InputShape:
    """A step's input shape (the JAX package's ``configs/base.py``)."""

    name: str
    seq_len: int
    global_batch: int


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256),
}


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def smoke_config(name: str) -> ArchConfig:
    """Reduced same-family variant for CPU tests (the JAX package's
    ``smoke_config``: 2 layers, or one mLSTM/sLSTM group of 4 for xLSTM,
    or 4 Mamba2 layers with the shared block every 2 for Zamba2, d_model
    <= 256, vocab <= 512, 4 experts, top-k <= 2, MLA ranks 32/48 and head
    dims 32/16/32, at most 8 patch embeddings, 2 encoder layers, M-RoPE
    sections of (hd / 4, hd / 8, hd / 8))."""
    cfg = get_config(name)
    if cfg.arch_type != "cnn":
        d_model = min(cfg.d_model, 256)
        n_heads = max(2, min(cfg.num_heads, 4))
        n_kv = max(1, min(cfg.num_kv_heads, n_heads))
        if n_heads % n_kv:
            n_kv = 1
        head_dim = max(8, d_model // n_heads)
        kw = dict(
            name=cfg.name + "-smoke",
            num_layers=2,
            d_model=d_model,
            num_heads=n_heads,
            num_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
            vocab_size=min(cfg.vocab_size, 512),
            frontend_tokens=min(cfg.frontend_tokens, 8),
            semisfl=replace(cfg.semisfl, split_layer=1, queue_len=64,
                            proj_dim=16, proj_hidden=32, k_s_init=2, k_u=2),
        )
        if cfg.moe is not None:
            kw["moe"] = replace(
                cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2),
                d_ff_expert=64,
                d_ff_dense_residual=64 if cfg.moe.d_ff_dense_residual else 0,
                num_shared_experts=min(cfg.moe.num_shared_experts, 1))
        if cfg.ssm is not None:
            kw["ssm"] = replace(cfg.ssm, state_dim=16, head_dim=32)
            if cfg.shared_attn_period:
                kw["num_layers"] = 4
                kw["shared_attn_period"] = 2
                kw["semisfl"] = replace(kw["semisfl"], split_layer=2)
        if cfg.xlstm is not None:
            kw["xlstm"] = replace(cfg.xlstm, slstm_period=2,
                                  mlstm_head_dim=64)
            kw["num_layers"] = 4
        if cfg.use_mla:
            kw.update(kv_lora_rank=32, q_lora_rank=48, qk_nope_head_dim=32,
                      qk_rope_head_dim=16, v_head_dim=32)
        if cfg.is_encoder_decoder:
            kw["num_encoder_layers"] = 2
        if cfg.mrope_sections:
            kw["mrope_sections"] = (head_dim // 4, head_dim // 8,
                                    head_dim // 8)
        return replace(cfg, **kw)
    return replace(
        cfg,
        name=cfg.name + "-smoke",
        cnn_channels=cfg.cnn_channels[:2] or (8, 16),
        cnn_fc=(32,),
        image_size=16,
        semisfl=replace(cfg.semisfl, split_layer=1, queue_len=64,
                        proj_dim=16, proj_hidden=32, k_s_init=2, k_u=2),
    )
