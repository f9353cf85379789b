"""Model configuration: the port's own copy of the model half of
``asr_model_tpu/config.py`` (``Dimensions``, the ``ModelConfig`` options
the port reads, the rotary/sinusoid base and the special token ids)."""

from __future__ import annotations

from dataclasses import dataclass

THETA = 30000.0
PAD_ID = 0
BOS_ID = 1
EOS_ID = 2


@dataclass(frozen=True)
class Dimensions:
    """Model hyperparameters; the defaults are the flagship config
    (40k vocab, 128 mels, 512 dims, 4 heads, 4 layers)."""

    tokens: int = 40000
    mels: int = 128
    dims: int = 512
    head: int = 4
    layer: int = 4
    act: str = "gelu"
    n_type: str = "AbbyNormal"


@dataclass(frozen=True)
class ModelConfig:
    """The options of ``asr_model_tpu``'s ModelConfig that the port
    reads; every other option is at its reference default (no chained
    blocks, no MoE, ...) and comes with the slice that implements it."""

    ctx: int = 2048              # decoder context cap (learned positions)
    theta: float = THETA         # sinusoid / rotary base
    # the reference masks only the first self-attention call of a block
    # causally; causal_all masks every decoder self-attention
    causal_all: bool = False
    # streaming-causal decoder: implies causal_all, makes MSheath's
    # pooling a per-position causal running mean with the jump policy
    # read from position 0, and masks the d||e cross causally, so the
    # logits of position t depend on tokens <= t only (and
    # ``greedy_decode_stream`` decodes incrementally)
    streaming: bool = False
    num_types: int = 3           # router / tgate modality count
    msheath_mem: int = 64        # v_gate memory slots
    # whole-call decode kernels, the counterparts of the JAX package's
    # PALLAS_XATTN / PALLAS_MLP / PALLAS_ROUTER switches (all off by
    # default, as there); behind each, the JAX package's gate decides
    # which calls take the kernel
    fused_attention: bool = False    # ops/cuda/xattn.py
    fused_mlp: bool = False          # ops/cuda/mlp.py
    fused_router: bool = False       # ops/cuda/router.py
