"""The port's training CLI on audio files, on the CPU, at the golden
reference's dims (256 tokens, 16 mels, 64 dims, 2 heads, 4 layers):
``--metadata M --data-dir D --remat --import-reference X.pt --device
cpu`` over GrammarDataset sentences written as WAV and FLAC files with a
``metadata.csv``, the reference state dict of
``tests/golden/reference_parity.npz`` as the ``.pt``, a tokenizer of 30
ids.  It trains, evaluates through the native WER engine and writes a
``config.json`` that the JAX package's ``Config.from_json`` reads with
``run.remat`` and ``run.remat_policy``; ``Config`` round-trips both
fields with the JAX package's; a run with no data source exits with
the JAX CLI's message."""

import importlib.util
import os
import wave

import numpy as np
import pytest
import torch

from _torch_train_step import letters_tokenizer, one_thread  # noqa: F401

from asr_model_tpu.config import Config as JConfig
from asr_model_tpu.config import RunConfig as JRunConfig

from asr_model_tpu_torch import cli, native
from asr_model_tpu_torch.config import Config, RunConfig
from asr_model_tpu_torch.data.dataset import GrammarDataset

ROOT = os.path.join(os.path.dirname(__file__), "..")
GOLDEN = os.path.join(ROOT, "tests", "golden", "reference_parity.npz")


def _flac_encoder():
    path = os.path.join(ROOT, "tools", "flac_encoder.py")
    spec = importlib.util.spec_from_file_location("flac_encoder", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def files(tmp_path):
    """(metadata.csv, data dir, tokenizer.json, reference .pt)."""
    enc = _flac_encoder()
    g = GrammarDataset([])
    train, evals = GrammarDataset.make_split(4, 1)
    data = tmp_path / "data"
    data.mkdir()
    rows = ["audio,sentence"]
    for i, text in enumerate(train + evals):
        pcm = np.round(g.render(text, seed=i) * 32767).astype(np.int16)
        if i % 2:
            enc.write_flac(str(data / f"u{i}.flac"), pcm, 16000)
            rows.append(f"u{i}.flac,{text}")
        else:
            with wave.open(str(data / f"u{i}.wav"), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes(pcm.astype("<i2").tobytes())
            rows.append(f"u{i}.wav,{text}")
    meta = tmp_path / "metadata.csv"
    meta.write_text("\n".join(rows) + "\n")
    z = np.load(GOLDEN)
    pt = tmp_path / "reference.pt"
    torch.save({k[3:]: torch.tensor(z[k]) for k in z.files
                if k.startswith("sd:")}, str(pt))
    return (str(meta), str(data), letters_tokenizer(tmp_path / "tok.json"),
            str(pt))


def test_cli_trains_on_files_with_remat_and_reference(files, tmp_path,
                                                      monkeypatch):
    meta, data, tok, pt = files
    calls = []
    wer = native.wer_levenshtein
    monkeypatch.setattr(native, "wer_levenshtein",
                        lambda r, h: calls.append(1) or wer(r, h))
    log_dir = tmp_path / "logs"
    out = cli.main(["--metadata", meta, "--data-dir", data, "--remat",
                    "--remat-policy", "full", "--import-reference", pt,
                    "--device", "cpu", "--tokenizer", tok,
                    "--tokens", "256", "--mels", "16", "--dims", "64",
                    "--head", "2", "--layer", "4", "--max-steps", "2",
                    "--batch-size", "4", "--prefetch", "0",
                    "--log-dir", str(log_dir)])
    assert out["step"] == 2 and np.isfinite(out["loss"])
    assert np.isfinite(out["eval_wer"]) and calls
    assert out["model"].processor.token.weight.shape == (256, 64)
    text = (log_dir / "config.json").read_text()
    jcfg, cfg = JConfig.from_json(text), Config.from_json(text)
    assert (jcfg.run.remat, jcfg.run.remat_policy) == (True, "full")
    assert (cfg.run.remat, cfg.run.remat_policy) == (True, "full")
    assert (cfg.dims.dims, cfg.dims.tokens) == (64, 256)


@pytest.mark.parametrize("policy", ["dots", "full"])
def test_remat_fields_round_trip_with_jax(policy):
    ours = Config(run=RunConfig(remat=True, remat_policy=policy))
    j = JConfig.from_json(ours.to_json())
    assert (j.run.remat, j.run.remat_policy) == (True, policy)
    back = Config.from_json(JConfig(run=JRunConfig(
        remat=True, remat_policy=policy)).to_json())
    assert (back.run.remat, back.run.remat_policy) == (True, policy)
    assert Config.from_json(back.to_json()) == back


def test_cli_needs_a_data_source():
    with pytest.raises(SystemExit,
                       match="need --metadata/--data-dir or --synthetic N"):
        cli.main(["--device", "cpu", "--metadata", "m.csv"])
