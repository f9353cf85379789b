"""Runs the port's multi-rank cases for the CPU tests: ``spawn(module,
cases, world, tmp)`` starts ``world`` gloo ranks once (a ``file://``
store in ``tmp``, the loopback interface, one intra-op thread a rank),
each runs ``module.<case>(rank, **kw)`` for every case in order (every
case a collective over all the ranks), and rank 0's results come back
as {case name: {key: numpy array}}.  The case modules import torch and
the port only, so a rank starts in a few seconds."""

import importlib
import os
import pickle

import numpy as np
import torch


def _rank_main(rank, module, cases, world, tmp):
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    torch.set_num_threads(1)
    from asr_model_tpu_torch.parallel.mesh import initialize_distributed
    initialize_distributed(rank=rank, world_size=world, device="cpu",
                           init_method=f"file://{tmp}/store")
    mod = importlib.import_module(module)
    results = {}
    for name, fn, kw in cases:
        out = getattr(mod, fn)(rank, **kw)
        if rank == 0:
            results[name] = {k: np.asarray(v) for k, v in out.items()}
    torch.distributed.barrier()
    if rank == 0:
        with open(os.path.join(tmp, "results.pkl"), "wb") as f:
            pickle.dump(results, f)
    torch.distributed.destroy_process_group()


def spawn(module: str, cases, world: int, tmp) -> dict:
    """``cases``: [(name, function name, kwargs)]."""
    import torch.multiprocessing as mp
    tmp = str(tmp)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    mp.spawn(_rank_main, args=(module, cases, world, tmp), nprocs=world,
             join=True)
    with open(os.path.join(tmp, "results.pkl"), "rb") as f:
        return pickle.load(f)
