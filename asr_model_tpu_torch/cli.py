"""Training entry point, the counterpart of ``asr_model_tpu/cli.py``:

    python -m asr_model_tpu_torch.cli --metadata M --data-dir D \\
        --max-steps 100 --batch-size 8 [--remat] [--import-reference X.pt]
    python -m asr_model_tpu_torch.cli --synthetic 16 --max-steps 4 \\
        --batch-size 8 --train-dtype bfloat16
    python -m asr_model_tpu_torch.cli --synthetic 16 --chained-blocks \\
        --moe-experts 8 --moe-top-k 2

tokenizer -> dataset (``PreparedDataset`` over a ``metadata.csv`` of
audio files under ``--data-dir``, or ``--synthetic N`` tones) -> 80/20
split -> Model (with ``--import-reference``, the reference's torch
``state_dict`` loaded into it) -> MaxFactor (two bias groups) +
FAMScheduler2 -> ``train_and_evaluate`` (``--remat``: the backward
recomputes the forward).  ``--chained-blocks`` feeds each block's output
to the next, ``--moe-experts N`` / ``--moe-top-k k`` route every block's
MLP through N experts (the load-balance aux joins the loss).  It runs on
the card unless ``--device cpu`` is given.

``--mesh-data/model/seq/expert/pipe`` and ``--microbatches`` run the
parallel paths (``train/loop.py``), one process a rank, with the JAX
CLI's checks and messages.  With more than one rank the CLI starts its
ranks itself (a ``file://`` store in a temporary directory; one card a
rank over NCCL, or gloo ranks with ``--device cpu``) and returns rank
0's summary; under ``torchrun`` (WORLD_SIZE in the environment) it
joins that group instead.  It never runs fewer ranks than the mesh
holds, nor the CPU where the card is asked for.  ``--pitch-tokens`` is
accepted and refused with its reason (the JAX package's pitch-token
model does not run).
"""

from __future__ import annotations

import argparse
import logging
import math
import os
import pickle
import sys
import tempfile
from datetime import datetime

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")


def default_tokenizer_path() -> str:
    """The port's own tokenizer, ``assets/tokenizer.json``."""
    return os.path.join(ASSETS, "tokenizer.json")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("asr_model_tpu_torch")
    p.add_argument("--metadata", type=str, default=None)
    p.add_argument("--data-dir", type=str, default=None)
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic utterances")
    p.add_argument("--tokenizer", type=str, default=None)
    p.add_argument("--max-steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--lr", type=float, default=2.5e-3)
    p.add_argument("--warmup-steps", type=int, default=10)
    p.add_argument("--eval-interval", type=int, default=10)
    p.add_argument("--save-interval", type=int, default=0)
    p.add_argument("--log-dir", type=str, default=None)
    p.add_argument("--checkpoint-dir", type=str, default=None)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--import-reference", type=str, default=None)
    p.add_argument("--generate", action="store_true",
                   help="free-running greedy eval WER instead of "
                        "teacher-forced")
    p.add_argument("--dims", type=int, default=512)
    p.add_argument("--head", type=int, default=4)
    p.add_argument("--layer", type=int, default=4)
    p.add_argument("--tokens", type=int, default=40000)
    p.add_argument("--mels", type=int, default=128)
    p.add_argument("--act", type=str, default="gelu")
    p.add_argument("--n-type", type=str, default="AbbyNormal")
    p.add_argument("--chained-blocks", action="store_true")
    p.add_argument("--streaming", action="store_true")
    p.add_argument("--causal-all", action="store_true")
    p.add_argument("--moe-experts", type=int, default=0)
    p.add_argument("--moe-top-k", type=int, default=2)
    p.add_argument("--pitch-tokens", action="store_true")
    p.add_argument("--pitch-estimator", type=str, default="dio",
                   choices=["dio", "yin"],
                   help="the pitch features' F0: DIO + StoneMask (native, "
                        "on the host) or YIN (on the device)")
    p.add_argument("--no-pitch", action="store_true")
    p.add_argument("--no-waveform", action="store_true")
    p.add_argument("--pad-multiple", type=int, default=128,
                   help="length-bucket padding (0 = exact padding)")
    for axis in ("data", "model", "seq", "expert", "pipe"):
        p.add_argument(f"--mesh-{axis}", type=int, default=1)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--remat-policy", type=str, default="dots",
                   choices=["dots", "full"])
    p.add_argument("--train-dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--prefetch", type=int, default=2)
    p.add_argument("--device", type=str, default=None,
                   help="the device to train on (default: the card; "
                        "'cpu' runs the plain PyTorch route)")
    return p


MESH = ("data", "model", "seq", "expert", "pipe")


def _refuse(args) -> None:
    """The JAX CLI's options this port does not implement yet."""
    from asr_model_tpu_torch.config import PITCH_TOKEN_FAULT, refusal
    if args.pitch_tokens:
        raise SystemExit(refusal("--pitch-tokens", 9, PITCH_TOKEN_FAULT))
    if not args.synthetic and not (args.metadata and args.data_dir):
        raise SystemExit("need --metadata/--data-dir or --synthetic N")


def _check_mesh(args) -> int:
    """The JAX CLI's mesh checks, with its messages; returns the ranks."""
    n = math.prod(getattr(args, f"mesh_{a}") for a in MESH)
    if n > 1:
        if args.device is None or args.device.startswith("cuda"):
            import torch
            have = torch.cuda.device_count()
            if have < n:
                raise SystemExit(
                    "mesh " + "x".join(str(getattr(args, f"mesh_{a}"))
                                       for a in MESH)
                    + f" needs {n} devices, have {have}")
        if args.batch_size % args.mesh_data != 0:
            raise SystemExit(
                f"--batch-size {args.batch_size} must be a multiple of "
                f"--mesh-data {args.mesh_data}")
    if args.mesh_expert > 1:
        if args.moe_experts <= 0:
            raise SystemExit("--mesh-expert needs --moe-experts > 0")
        if args.moe_experts % args.mesh_expert:
            raise SystemExit(
                f"--moe-experts {args.moe_experts} must be a multiple "
                f"of --mesh-expert {args.mesh_expert}")
    if args.mesh_pipe > 1:
        if not args.chained_blocks:
            raise SystemExit("--mesh-pipe needs --chained-blocks")
        if args.layer % args.mesh_pipe:
            raise SystemExit(
                f"--layer {args.layer} not divisible by --mesh-pipe "
                f"{args.mesh_pipe}")
        if args.batch_size % args.microbatches:
            raise SystemExit(
                f"--batch-size {args.batch_size} must be a multiple of "
                f"--microbatches {args.microbatches}")
    return n


def _rank(rank: int, argv, n: int, store: str, device) -> None:
    """One spawned rank: join the group, run ``main``; rank 0 leaves its
    summary in the store directory."""
    import torch.distributed as dist

    import torch

    from asr_model_tpu_torch.parallel.mesh import initialize_distributed
    if device is not None and device.startswith("cpu"):
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    initialize_distributed(rank=rank, world_size=n, device=device,
                           init_method=f"file://{store}/rendezvous")
    try:
        summary = main(argv)
        if rank == 0:
            summary.pop("model", None)
            with open(os.path.join(store, "summary.pkl"), "wb") as f:
                pickle.dump(summary, f)
    finally:
        dist.destroy_process_group()


def _spawn(argv, n: int, device) -> dict:
    """Start the n ranks of the mesh and wait for them."""
    import torch.multiprocessing as mp
    if device is not None and device.startswith("cpu"):
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    store = tempfile.mkdtemp(prefix="asr_mesh_")
    mp.spawn(_rank, args=(argv, n, store, device), nprocs=n, join=True)
    with open(os.path.join(store, "summary.pkl"), "rb") as f:
        summary = pickle.load(f)
    summary["ranks"] = n
    return summary


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_argparser().parse_args(argv)
    _refuse(args)
    n_ranks = _check_mesh(args)
    import torch.distributed as dist
    if not dist.is_initialized():
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:      # torchrun
            from asr_model_tpu_torch.parallel.mesh import (
                initialize_distributed)
            initialize_distributed(device=args.device)
        elif n_ranks > 1:
            return _spawn(argv, n_ranks, args.device)
    from asr_model_tpu_torch.config import (Config, DataConfig, Dimensions,
                                            ModelConfig, OptimConfig,
                                            RunConfig)
    from asr_model_tpu_torch.data.dataset import (PreparedDataset,
                                                  Repeated,
                                                  SyntheticDataset,
                                                  random_split)
    from asr_model_tpu_torch.data.tokenizer import setup_tokenizer
    from asr_model_tpu_torch.models.model import Model
    from asr_model_tpu_torch.train.loop import train_and_evaluate
    from asr_model_tpu_torch.utils import resolve_device

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    dev = resolve_device(args.device)
    if dist.is_initialized() and args.device is None:
        import torch
        dev = torch.device("cuda", torch.cuda.current_device())
    log_dir = args.log_dir or os.path.join(
        "./logs", datetime.now().strftime("%m-%d_%H_%M_%S"))
    os.makedirs(log_dir, exist_ok=True)
    tokenizer = setup_tokenizer(args.tokenizer
                                or default_tokenizer_path())
    if args.tokens < tokenizer.get_vocab_size():
        raise SystemExit(
            f"--tokens {args.tokens} is smaller than the tokenizer vocab "
            f"({tokenizer.get_vocab_size()}): label ids would index out of "
            "bounds. Use --tokens >= vocab size.")

    data = DataConfig(spectrogram=True, pitch=not args.no_pitch,
                      waveform=not args.no_waveform,
                      pitch_estimator=args.pitch_estimator, mels=args.mels)
    extract_args = {"spectrogram": True, "pitch": data.pitch,
                    "waveform": data.waveform,
                    "pitch_estimator": data.pitch_estimator,
                    "hop_length": data.hop_length,
                    "sample_rate": data.sample_rate, "mels": data.mels}
    dims = Dimensions(tokens=args.tokens, mels=args.mels, dims=args.dims,
                      head=args.head, layer=args.layer, act=args.act,
                      n_type=args.n_type)
    cfg = Config(
        dims=dims,
        model=ModelConfig(streaming=args.streaming,
                          causal_all=args.causal_all,
                          chained_blocks=args.chained_blocks,
                          moe_experts=args.moe_experts,
                          moe_top_k=args.moe_top_k),
        data=data,
        optim=OptimConfig(lr=args.lr, warmup_steps=args.warmup_steps,
                          total_steps=args.max_steps),
        run=RunConfig(max_steps=args.max_steps, batch_size=args.batch_size,
                      eval_interval=args.eval_interval,
                      save_interval=args.save_interval,
                      checkpoint_dir=args.checkpoint_dir or log_dir,
                      log_dir=log_dir, generate=args.generate,
                      train_dtype=args.train_dtype,
                      prefetch_depth=args.prefetch, remat=args.remat,
                      remat_policy=args.remat_policy,
                      mesh_data=args.mesh_data, mesh_model=args.mesh_model,
                      mesh_seq=args.mesh_seq, mesh_expert=args.mesh_expert,
                      mesh_pipe=args.mesh_pipe,
                      microbatches=args.microbatches))

    if args.synthetic:
        dataset = SyntheticDataset(n=args.synthetic, tokenizer=tokenizer,
                                   extract_args=extract_args, device=dev)
    else:
        dataset = PreparedDataset(args.metadata, args.data_dir, tokenizer,
                                  extract_args=extract_args, cache=True,
                                  device=dev)
    train_ds, eval_ds = random_split(dataset, 0.8, seed=cfg.run.seed)
    pad = args.pad_multiple or None
    text_pad = 16 if pad else None
    train_loader = Repeated(train_ds, batch_size=cfg.run.batch_size,
                            pad_to_multiple=pad, text_pad_to_multiple=text_pad)
    eval_loader = Repeated(eval_ds, batch_size=cfg.run.batch_size,
                           pad_to_multiple=pad, text_pad_to_multiple=text_pad)
    model = Model(dims, cfg.model, device=dev, seed=cfg.run.seed)
    if args.import_reference:
        from asr_model_tpu_torch.compat import import_reference_checkpoint
        import_reference_checkpoint(args.import_reference, model)
        print(f"imported reference state_dict {args.import_reference}")
    summary = train_and_evaluate(model, tokenizer, train_loader, eval_loader,
                                 cfg, resume_from=args.resume)
    from asr_model_tpu_torch.parallel.sharding import full_numel
    n_params = full_numel(model)
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(f"Train dataset size: {len(train_ds)}")
        print(f"Test dataset size: {len(eval_ds)}")
        print(f"Trainable parameters: {n_params:,}")
    summary["model"] = model
    return summary


if __name__ == "__main__":
    main()
