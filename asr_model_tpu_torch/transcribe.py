"""The serving surface: ``Transcriber``.

The counterpart of ``asr_model_tpu/transcribe.py``::

    t = Transcriber.from_checkpoint(ckpt, tokenizer_path)   # on the card
    text = t(audio)                      # np.ndarray, wav path or dict
    texts = t.transcribe_batch([a, b])   # one frontend, one decode
    text = t.transcribe_long(audio)      # 30 s chunks, prompted decode

The frontend (log-mel, the pitch track, the frame-rate waveform) runs on
the model's device; the pitch track is the one the model trained on
(``DataConfig.pitch_estimator``): "dio" (DIO + StoneMask, ``ops/dio.py``)
or "yin".  ``beam_size > 1`` decodes with ``models/beam.py``; a streaming
model takes ``greedy_decode_stream`` unless it is chained, any other the
buffer decode.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Union

import numpy as np
import torch

from asr_model_tpu_torch.config import Config
from asr_model_tpu_torch.data.audio_io import load_wave
from asr_model_tpu_torch.data.tokenizer import Tokenizer, setup_tokenizer
from asr_model_tpu_torch.models.beam import beam_search
from asr_model_tpu_torch.models.generate import (greedy_decode,
                                                 greedy_decode_stream)
from asr_model_tpu_torch.models.longform import (check_pitch_estimator,
                                                 features, transcribe_long)
from asr_model_tpu_torch.models.model import Model, cast_variables
from asr_model_tpu_torch.utils import resolve_device


class Transcriber:
    def __init__(self, model: Model, tokenizer: Tokenizer,
                 sample_rate: int = 16000, hop: int = 160,
                 use_pitch: bool = True, use_waveform: bool = True,
                 bf16: bool = True, max_new_tokens: int = 150,
                 beam_size: int = 1, length_penalty: float = 1.0,
                 pitch_estimator: str = "dio", device=None):
        """``model`` holds its weights; ``bf16`` casts them (in place).
        The model moves to ``device``: None is the CUDA device (an error
        when there is none), the CPU only when asked for."""
        check_pitch_estimator(pitch_estimator)
        model = model.to(resolve_device(device))
        self.model = cast_variables(model) if bf16 else model
        self.dtype = torch.bfloat16 if bf16 else torch.float32
        self.tokenizer = tokenizer
        self.sample_rate, self.hop = sample_rate, hop
        self.use_pitch, self.use_waveform = use_pitch, use_waveform
        self.max_new_tokens = max_new_tokens
        self.beam_size = int(beam_size)
        self.length_penalty = float(length_penalty)
        self.pitch_estimator = pitch_estimator

    @classmethod
    def from_checkpoint(cls, ckpt_path: str, tokenizer_path: str,
                        cfg: Optional[Config] = None, device=None, **kw):
        """A JAX training checkpoint (``flax.serialization`` msgpack) on
        the card (``device`` None; an error without one) or ``device``.
        ``cfg`` None reads the ``config.json`` the training loop writes
        beside its checkpoints, else the default ``Config()``."""
        from asr_model_tpu_torch.train.checkpoint import restore_model
        if cfg is None:
            cfg_path = os.path.join(os.path.dirname(os.path.abspath(
                ckpt_path)), "config.json")
            if os.path.exists(cfg_path):
                with open(cfg_path) as f:
                    cfg = Config.from_json(f.read())
        cfg = cfg or Config()
        model = Model(cfg.dims, cfg.model, device=device)
        kw.setdefault("device", device)
        kw.setdefault("use_pitch", cfg.data.pitch)
        kw.setdefault("use_waveform", cfg.data.waveform)
        kw.setdefault("pitch_estimator", cfg.data.pitch_estimator)
        # the mono stem must come from the checkpoint when the config says
        # it was trained or the caller asks for pitch or waveform
        restore_model(model, ckpt_path, mono_stem=(
            cfg.data.pitch or cfg.data.waveform or kw["use_pitch"]
            or kw["use_waveform"]))
        return cls(model, setup_tokenizer(tokenizer_path), **kw)

    def features(self, audio: torch.Tensor) -> dict:
        """The model's inputs for audio (B, L) on its device."""
        mel, f0, wave = features(
            audio.to(self.model.device), self.sample_rate, self.hop,
            self.model.dims.mels, self.dtype,
            self.pitch_estimator if self.use_pitch else None)
        return dict(spectrogram=mel, pitch=f0,
                    waveform=wave if self.use_waveform else None)

    def _load(self, audio) -> np.ndarray:
        if isinstance(audio, (str, dict)):
            return load_wave(audio, self.sample_rate)[0]
        return np.asarray(audio, np.float32)

    def _decode(self, feats: dict, max_new_tokens: int):
        cfg = self.model.cfg
        # a chained model has no stream decode (as in the JAX package)
        if cfg.streaming and not cfg.chained_blocks:
            return greedy_decode_stream(self.model, **feats,
                                        max_new_tokens=max_new_tokens)
        return greedy_decode(self.model, **feats,
                             max_new_tokens=max_new_tokens)

    def __call__(self, audio: Union[str, dict, np.ndarray],
                 max_new_tokens: Optional[int] = None,
                 beam_size: Optional[int] = None) -> str:
        """One utterance: greedy, or beam search when ``beam_size`` (here
        or on the constructor) is above 1."""
        wav = torch.from_numpy(self._load(audio))[None]
        feats = self.features(wav)
        mnt = max_new_tokens or self.max_new_tokens
        k = self.beam_size if beam_size is None else int(beam_size)
        if k > 1:
            ids, _ = beam_search(self.model, **feats, beam_size=k,
                                 max_new_tokens=mnt,
                                 length_penalty=self.length_penalty)
        else:
            ids = self._decode(feats, mnt)
        return self.tokenizer.decode(ids[0].tolist())

    def transcribe_batch(self, audios: Sequence[Union[str, dict, np.ndarray]],
                         max_new_tokens: Optional[int] = None) -> list:
        """Several utterances in one batch: zero-padded to the longest,
        one frontend, one decode."""
        wavs = [self._load(a) for a in audios]
        L = max(len(w) for w in wavs)
        stacked = np.stack([np.pad(w, (0, L - len(w))) for w in wavs])
        feats = self.features(torch.from_numpy(stacked))
        ids = self._decode(feats, max_new_tokens or self.max_new_tokens)
        return self.tokenizer.batch_decode(ids.tolist())

    def transcribe_long(self, audio: Union[str, dict, np.ndarray],
                        chunk_sec: float = 30.0, **kw) -> str:
        """Chunked long-form transcription (``models/longform.py``)."""
        _, text = transcribe_long(
            self.model, self._load(audio), tokenizer=self.tokenizer,
            sample_rate=self.sample_rate, chunk_sec=chunk_sec, hop=self.hop,
            use_pitch=self.use_pitch, use_waveform=self.use_waveform,
            pitch_estimator=self.pitch_estimator, **kw)
        return text

    @torch.no_grad()
    def encode_only(self, audio: Union[str, dict, np.ndarray]) -> dict:
        """The AudioEncoder's output of each modality slot a / b / c."""
        feats = self.features(torch.from_numpy(self._load(audio))[None])
        spec = feats["spectrogram"]
        xa = {"a": feats["pitch"] if feats["pitch"] is not None else spec,
              "b": spec,
              "c": feats["waveform"] if feats["waveform"] is not None
              else spec}
        return self.model.encode(xa)
