"""Hand-written Hopper kernels, one module per TPU kernel they replace
(``asr_model_tpu/ops/pallas/``).  Each module holds the wrapper (which
launches the CUDA kernels on a CUDA tensor and counts each kernel
launch in ``<wrapper>.launches``), the plain PyTorch version of the same function
(taken for CPU tensors; calls counted in ``<plain>.calls``), and a
source note on what the kernel replaces and what bounds it."""

from asr_model_tpu_torch.ops.cuda import abby, attention, mel, sheath

WRAPPERS = {
    "mel_spectrogram": (mel.mel_spectrogram, mel.mel_spectrogram_plain),
    "flash_attention": (attention.flash_attention,
                        attention.attention_plain),
    "fused_abby": (abby.fused_abby, abby.abby_plain),
    "fused_sheath_scan": (sheath.fused_sheath_scan, sheath.sheath_scan_plain),
}


def reset_counts() -> None:
    for wrapper, plain in WRAPPERS.values():
        wrapper.launches = 0
        plain.calls = 0


def counts() -> dict:
    return {name: {"launches": w.launches, "plain_calls": p.calls}
            for name, (w, p) in WRAPPERS.items()}
