"""Configuration: the port's own copy of ``asr_model_tpu/config.py``'s
``Dimensions``, the ``ModelConfig`` options the port reads, the
feature settings (``DataConfig``), the rotary/sinusoid base and the
special token ids, and ``Config.from_json`` for the ``config.json`` the
JAX training loop writes beside its checkpoints."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field

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


@dataclass(frozen=True)
class DataConfig:
    """The feature settings the serving frontend reads.  ``pitch_estimator``
    is the F0 algorithm the model trained on, which the frontend must
    compute too: "dio" (DIO + StoneMask) or "yin".  The reference's other
    data fields come with the data path (ROADMAP Queue 1 item 7)."""

    pitch: bool = True
    waveform: bool = True
    pitch_estimator: str = "dio"


# reference options the port does not implement yet: (section, field,
# the default the port runs, the ROADMAP Queue 1 item that brings it)
UNSUPPORTED = (("model", "chained_blocks", False, 9),
               ("model", "encoder_norm", False, 9),
               ("model", "encoder_transformer", False, 9),
               ("model", "msheath_mini_hc", False, 9),
               ("model", "moe_experts", 0, 9),
               ("data", "pitch_tokens", False, 9))


def _build(cls, raw: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in raw.items() if k in names})


@dataclass(frozen=True)
class Config:
    """The model, its dimensions and the feature settings of a trained
    model (the JAX ``Config``'s ``optim`` and ``run`` sections are for
    training and are not read)."""

    dims: Dimensions = field(default_factory=Dimensions)
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)

    @staticmethod
    def from_json(s: str) -> "Config":
        """Reads the JAX ``Config.to_json()`` layout (``model.dims``
        nested in ``model``).  A reference option the port does not
        implement, set to anything but its default, is a ValueError
        naming the ROADMAP item that brings it."""
        raw = json.loads(s)
        model = dict(raw.get("model", {}))
        data = dict(raw.get("data", {}))
        for section, name, default, item in UNSUPPORTED:
            got = (model if section == "model" else data).get(name, default)
            if got != default:
                raise ValueError(
                    f"{section}.{name}={got!r} is not implemented by the "
                    f"PyTorch port yet (ROADMAP Queue 1 item {item})")
        return Config(dims=_build(Dimensions, model.pop("dims", {})),
                      model=_build(ModelConfig, model),
                      data=_build(DataConfig, data))
