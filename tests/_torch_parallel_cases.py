"""The multi-rank cases of ``tests/test_torch_parallel.py`` (run by
``tests/_torch_dist.py:spawn``; torch and the port only), and the
single-process references they are held to: the port's own train step
and forward on one device, which the train-step tests hold to the JAX
package."""

import numpy as np
import torch

from asr_model_tpu_torch.config import Config, Dimensions, ModelConfig
from asr_model_tpu_torch.models.model import Model
from asr_model_tpu_torch.parallel.mesh import make_mesh
from asr_model_tpu_torch.parallel.sharding import (full_state_dict,
                                                   make_sharded_train_step,
                                                   param_specs, shard_params)
from asr_model_tpu_torch.train.loop import (device_batch, make_optimizer,
                                            make_train_step)

DIMS = dict(tokens=64, mels=8, dims=32, head=2, layer=2)
MOE = dict(chained_blocks=True, moe_experts=4, moe_top_k=2)


def batch(b: int = 8):
    """Seed-0 batch: 16 frames of spectrogram and pitch, 6 text positions,
    two labels of the last row padding."""
    rs = np.random.RandomState(0)
    labels = rs.randint(3, 64, (b, 6))
    labels[-1, -2:] = 0
    return device_batch({
        "spectrogram": rs.randn(b, 8, 16).astype(np.float32),
        "pitch": (rs.rand(b, 1, 16) * 200).astype(np.float32),
        "text_ids": rs.randint(3, 64, (b, 6)), "labels": labels}, "cpu")


def build(moe: bool = False, jumps: bool = False) -> Model:
    """The tiny model from seed 0; ``jumps`` shifts every MSheath
    policy's bias towards skipping one slot, so the step takes jumps."""
    m = Model(Dimensions(**DIMS), ModelConfig(**(MOE if moe else {})),
              device="cpu", seed=0)
    if jumps:
        with torch.no_grad():
            for name, p in m.named_parameters():
                if name.endswith("pnet.fc2.bias"):
                    p.add_(torch.tensor([0.0, 8.0, 0.0]))
    return m


def _result(m, loss, gnorm, jstat, sd=None):
    sd = sd if sd is not None else {k: v.detach().clone()
                                    for k, v in m.state_dict().items()}
    out = {"loss": loss.detach().numpy(), "gnorm": gnorm.detach().numpy(),
           "jstat": jstat.numpy()}
    out.update({f"p/{k}": v.numpy() for k, v in sd.items()})
    return out


def single_step(moe: bool = False, jumps: bool = False):
    """The one-device f32 step from the same weights, batch and seed."""
    m = build(moe, jumps)
    opt, _ = make_optimizer(Config(), m)
    step = make_train_step(m, opt)
    loss, gnorm, jstat = step(batch(), torch.Generator().manual_seed(3))
    return _result(m, loss, gnorm, jstat)


def mesh_step(rank, data=1, model=1, expert=1, moe=False, jumps=False,
              remat=False):
    """The sharded f32 step on a (data, model, 1, expert) mesh (with
    ``remat``: the loss and each MSheath slot step recomputed in the
    backward); the whole parameters after it."""
    m = build(moe, jumps)
    mesh = make_mesh(data=data, model=model, expert=expert)
    shard_params(m, mesh)
    opt, _ = make_optimizer(Config(), m)
    step = make_sharded_train_step(m, opt, mesh, remat=remat)
    loss, gnorm, jstat = step(batch(), torch.Generator().manual_seed(3))
    return _result(m, loss, gnorm, jstat, full_state_dict(m))


def single_forward(moe: bool = True):
    m = build(moe)
    b = batch()
    return {"logits": m(b["text_ids"], spectrogram=b["spectrogram"],
                        pitch=b["pitch"])["logits"].numpy()}


def mesh_forward(rank, model=1, expert=1, moe=True):
    """The eval forward of a sharded model (every rank the whole
    batch)."""
    m = build(moe)
    shard_params(m, make_mesh(model=model, expert=expert))
    b = batch()
    return {"logits": m(b["text_ids"], spectrogram=b["spectrogram"],
                        pitch=b["pitch"])["logits"].numpy()}


def mesh_layout(rank):
    """Rank 0's coordinates and group sizes on a (2, 2) mesh, the
    refusal of a mesh larger than the group, and which parameters a
    4-way model axis shards at 2 heads."""
    mesh = make_mesh(data=2, model=2)
    out = {"coords": np.array([mesh.coords[a] for a in mesh.axis_names]),
           "sizes": np.array([mesh.axis("data").size,
                              mesh.axis("model").size,
                              mesh.axis("data", "model").size,
                              mesh.axis("seq").size])}
    try:
        make_mesh(data=16)
        out["refused"] = np.array(0)
    except ValueError as e:
        out["refused"] = np.array("needs 16 devices, have 4" in str(e))
    specs = param_specs(build(), make_mesh(model=4))
    out["sharded"] = np.array(sorted(specs))
    return out
