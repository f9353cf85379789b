"""Configuration: the port's own copy of ``asr_model_tpu/config.py``'s
``Dimensions``, the ``ModelConfig`` options the port reads, the
feature settings (``DataConfig``), the optimizer and schedule
(``OptimConfig``) and training-loop settings (``RunConfig``), the
rotary/sinusoid base and the special token ids, and
``Config.from_json`` / ``to_json`` for the ``config.json`` the training
loops (the JAX package's and the port's) write beside their
checkpoints, in the JAX package's layout."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple

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
    reads (every one but the pitch-token embedding, which the port
    refuses: ``UNSUPPORTED``), and the port's fused-kernel switches."""

    ctx: int = 2048              # decoder context cap (learned positions)
    theta: float = THETA         # sinusoid / rotary base
    dropout: float = 0.1         # the audio encoder's, in train mode
    # the reference masks only the first self-attention call of a block
    # causally; causal_all masks every decoder self-attention
    causal_all: bool = False
    # streaming-causal decoder: implies causal_all, makes MSheath's
    # pooling a per-position causal running mean with the jump policy
    # read from position 0, and masks the d||e cross causally, so the
    # logits of position t depend on tokens <= t only (and
    # ``greedy_decode_stream`` decodes incrementally)
    streaming: bool = False
    # the reference feeds x back between blocks only with chained_blocks;
    # without it only the last block reaches the output (and is built)
    chained_blocks: bool = False
    # AudioEncoder options: the n_type norm after the stem and the
    # stack (a LocalNorm on mono stems), and a post-norm transformer
    # encoder layer after the stack
    encoder_norm: bool = False
    encoder_transformer: bool = False
    num_types: int = 3           # router / tgate modality count
    # read and written as the JAX package does, and inert as it is
    # there: its Residual builds MSheath without the r_node ("ranvier")
    # paths, so a checkpoint of such a config has no r_node leaves; the
    # paths themselves are ``MSheath(mini_hc=True)`` (ROADMAP Queue 3)
    msheath_mini_hc: bool = False
    msheath_mem: int = 64        # v_gate memory slots
    pitch_token_bins: int = 256  # quantize_pitch bins
    pitch_token_vocab: int = 1024  # pitch-token embedding rows
    # mixture-of-experts MLP (models/moe.py): 0 is the dense MLP; E > 0
    # routes each block's MLP through E experts of its shape, top_k a
    # token, capacity_factor * T * top_k / E slots an expert and example,
    # the load-balance aux weighted into the training loss
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 1e-2
    # whole-call decode kernels, the counterparts of the JAX package's
    # PALLAS_XATTN / PALLAS_MLP / PALLAS_ROUTER switches (all off by
    # default, as there); behind each, the JAX package's gate decides
    # which calls take the kernel
    fused_attention: bool = False    # ops/cuda/xattn.py
    fused_mlp: bool = False          # ops/cuda/mlp.py
    fused_router: bool = False       # ops/cuda/router.py


@dataclass(frozen=True)
class DataConfig:
    """The feature settings the training features and the serving
    frontend read.  ``pitch_estimator`` is the F0 algorithm the model
    trained on, which the frontend must compute too: "dio" (DIO +
    StoneMask: the native host code for training features, the device
    code when serving), "dio_host" (the native host code everywhere) or
    "yin".  ``harmonics``, ``aperiodics`` and ``phase`` are read and
    written and, as in the JAX package, no path reads them (its CLI and
    the port's featurise with them off, and the collator feeds none of
    them to the model)."""

    spectrogram: bool = True
    pitch: bool = True
    waveform: bool = True
    harmonics: bool = False
    aperiodics: bool = False
    phase: bool = False
    pitch_estimator: str = "dio"
    hop_length: int = 160
    sample_rate: int = 16000
    mels: int = 128


@dataclass(frozen=True)
class OptimConfig:
    """MaxFactor + FAMScheduler2 settings (the reference's main())."""

    lr: float = 2.5e-3
    b_decay: float = -0.8
    eps: Tuple[float, float] = (1e-8, 1e-8)
    d: float = 1.0
    decay: float = 1e-2
    gamma: float = 0.99
    maximize: bool = False
    bias: int = 1
    jump_bias: int = 2           # the 'jump' / 'pnet' group
    min_lr: float = 1e-9
    clip: bool = False
    cap: float = 0.0
    warmup_steps: int = 10
    total_steps: int = 100
    decay_start: Optional[int] = None
    warmup_start: float = 1e-6
    eta_min: float = 1e-6


@dataclass(frozen=True)
class RunConfig:
    """Training-loop settings.  ``mesh_*`` are the ranks' mesh
    (``train/loop.py:run_mesh``; ``microbatches`` the GPipe microbatches
    under ``mesh_pipe``).  ``train_dtype``
    "bfloat16" runs the forward and backward in bf16 over f32 master
    weights and optimizer state; ``prefetch_depth`` collated batches are
    prepared ahead on a worker thread; ``remat`` recomputes the forward
    in the backward (``remat_policy`` "dots" keeps the matrix products
    without a batch dimension, "full" nothing) and checkpoints each
    MSheath slot step."""

    max_steps: int = 100
    batch_size: int = 1
    acc_steps: int = 1
    log_interval: int = 10
    eval_interval: int = 10
    save_interval: int = 0
    warmup_interval: int = 10
    checkpoint_dir: str = "./checkpoints"
    log_dir: str = "./logs"
    generate: bool = False       # free-running vs teacher-forced eval WER
    clip_grad_norm: float = 0.0
    train_dtype: str = "float32"
    max_new_tokens: int = 150
    seed: int = 0
    prefetch_depth: int = 2
    remat: bool = False
    remat_policy: str = "dots"
    mesh_data: int = 1
    mesh_model: int = 1
    mesh_seq: int = 1
    mesh_expert: int = 1
    mesh_pipe: int = 1
    microbatches: int = 1


# the JAX package's pitch-token model does not run: its forward raises
# where the text length differs from the frame count (the encoder
# slots' rotary takes its length from the pitch-token condition)
PITCH_TOKEN_FAULT = ("the JAX package's pitch-token forward raises where "
                     "the text length differs from the frame count "
                     "(Attention rotates the frames' q with the text-length "
                     "pitch-token condition), so there is no reference to "
                     "hold a port to")

# reference options the port does not implement yet: (section, field,
# the default the port runs, the ROADMAP Queue 1 item that brings it,
# why, or None)
UNSUPPORTED = (("data", "pitch_tokens", False, 9, PITCH_TOKEN_FAULT),)


def refusal(what: str, item: int, why) -> str:
    """The message of an option the port refuses."""
    return (f"{what} is not implemented by the PyTorch port yet (ROADMAP "
            f"Queue 1 item {item})" + (f": {why}" if why else ""))


def _build(cls, raw: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in raw.items() if k in names})


@dataclass(frozen=True)
class Config:
    """A model, its dimensions, its feature settings and its training
    settings."""

    dims: Dimensions = field(default_factory=Dimensions)
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    run: RunConfig = field(default_factory=RunConfig)

    def to_json(self) -> str:
        """The JAX ``Config.to_json()`` layout (``dims`` nested in
        ``model``); the JAX package's ``Config.from_json`` reads it (and
        ignores the port-only fields, the fused-kernel switches)."""
        model = dataclasses.asdict(self.model) | {
            "dims": dataclasses.asdict(self.dims)}
        return json.dumps({"model": model,
                           "data": dataclasses.asdict(self.data),
                           "optim": dataclasses.asdict(self.optim),
                           "run": dataclasses.asdict(self.run)}, indent=2)

    @staticmethod
    def from_json(s: str) -> "Config":
        """Reads the JAX ``Config.to_json()`` layout (``model.dims``
        nested in ``model``).  A reference option the port does not
        implement, set to anything but its default, is a ValueError
        naming the ROADMAP item that brings it."""
        raw = json.loads(s)
        sec = {k: dict(raw.get(k, {}))
               for k in ("model", "data", "optim", "run")}
        for section, name, default, item, why in UNSUPPORTED:
            got = sec[section].get(name, default)
            if got != default:
                raise ValueError(refusal(f"{section}.{name}={got!r}", item,
                                         why))
        return Config(dims=_build(Dimensions, sec["model"].pop("dims", {})),
                      model=_build(ModelConfig, sec["model"]),
                      data=_build(DataConfig, sec["data"]),
                      optim=_build(OptimConfig, sec["optim"]),
                      run=_build(RunConfig, sec["run"]))
