"""Hand-written Hopper kernels, one module per TPU kernel they replace
(``asr_model_tpu/ops/pallas/``).  Each module holds the wrapper (which
launches the CUDA kernels on a CUDA tensor and counts each kernel launch
in ``<wrapper>.launches``), the plain PyTorch version of the same
function (taken for CPU tensors; calls counted in ``<plain>.calls``),
and a source note on what the kernel replaces and what bounds it.

Two decode paths use them.  The default one runs ``mel_spectrogram``,
``flash_attention``, ``fused_abby`` and ``fused_sheath_scan``; with the
``ModelConfig`` fields ``fused_attention``, ``fused_mlp`` and
``fused_router`` on, the decode step's whole attention calls, residual
MLPs and routers go to ``fused_attn_cached`` / ``fused_attn_full``,
``fused_mlp_residual`` and ``fused_router_same`` as well.
``fused_abby_tail`` has no caller on either path (as in the JAX
package); it serves direct callers.  The serving frontend's DIO pitch
(``ops/dio.py``) adds ``dio_contour``, the one kernel here with no
Pallas counterpart (the JAX package runs that scan in XLA).  Training
(``TRAIN_PATH``) runs the mel kernel in the data pipeline and flash's
forward under autograd; the other wrappers refuse a call autograd needs
a gradient of (``build.eval_only``).

Past each kernel's shared-memory plan a wrapper takes a route that keeps
its rows, heads or frames in device memory (no configuration of the
repo reaches one); ``<wrapper>.routes`` counts each route's launches
apart (``counts()["<wrapper>/<route>"]``)."""

from asr_model_tpu_torch.ops.cuda import (abby, attention, dio, mel, mlp,
                                          router, sheath, xattn)

WRAPPERS = {
    "mel_spectrogram": (mel.mel_spectrogram, mel.mel_spectrogram_plain),
    "flash_attention": (attention.flash_attention,
                        attention.attention_plain),
    "fused_abby": (abby.fused_abby, abby.abby_plain),
    "fused_sheath_scan": (sheath.fused_sheath_scan, sheath.sheath_scan_plain),
    "fused_attn_cached": (xattn.fused_attn_cached, xattn.attn_cached_plain),
    "fused_attn_full": (xattn.fused_attn_full, xattn.attn_full_plain),
    "fused_mlp_residual": (mlp.fused_mlp_residual, mlp.mlp_residual_plain),
    "fused_router_same": (router.fused_router_same, router.router_same_plain),
    "fused_abby_tail": (abby.fused_abby_tail, abby.abby_tail_plain),
    "dio_contour": (dio.dio_contour, dio.dio_contour_plain),
}

# the wrappers the default decode path launches; the fused path adds
# FUSED_ONLY
DEFAULT_PATH = ("mel_spectrogram", "flash_attention", "fused_abby",
                "fused_sheath_scan")
FUSED_ONLY = ("fused_attn_cached", "fused_attn_full", "fused_mlp_residual",
              "fused_router_same")
# the serving path (``Transcriber`` with DIO pitch) at the default config
SERVE_PATH = DEFAULT_PATH + ("dio_contour",)
# the training path: the data pipeline's mel, one utterance a call, and
# the train step's attention (flash's forward under autograd); every
# other kernel is eval-only and gated off in train mode
TRAIN_PATH = ("mel_spectrogram", "flash_attention")


def reset_counts() -> None:
    for wrapper, plain in WRAPPERS.values():
        wrapper.launches = 0
        plain.calls = 0
        for r in getattr(wrapper, "routes", {}):
            wrapper.routes[r] = 0


def counts() -> dict:
    """Launches and plain calls by wrapper, and by route past the plans
    (``"<wrapper>/<route>"``, launches also counted in the wrapper's)."""
    out = {name: {"launches": w.launches, "plain_calls": p.calls}
           for name, (w, p) in WRAPPERS.items()}
    out.update({f"{name}/{r}": {"launches": n, "plain_calls": 0}
                for name, (w, _) in WRAPPERS.items()
                for r, n in getattr(w, "routes", {}).items()})
    return out
