"""Decoder: the residual block and the multi-modal ``Processor``, eval.

Residual (per call):
  x, _ = MSheath(ln(x));  x = router(x x (layer-1)) + attn(ln(x), causal)
  cross: x += attn(ln(x), cached K/V)   or, with a source xa:
         xa += sinusoids; xa, _ = MSheath(ln(xa));
         x += attn(ln(x), xa=router(xa x (layer-1)))
  return x + ln(mlp_out(gelu(mlp_in(tgate(ln(x))))))
with one ``ln`` shared by every position.  With ``fused_mlp`` the last
line is one call of ``ops/cuda/mlp.py`` wherever the JAX package's
PALLAS_MLP gate would route it (``Residual._mlp_fused_ok``); the fields
``fused_attention`` and ``fused_router`` go to the block's Attention and
Router.

Processor (chained=False, the reference's configuration): only the last
block reaches the output, so it is the only block built.  Per call:
  a = blk(x, causal);  b/c/d = blk(prev, cross = slot a/b/c);
  e = a + b + c;  g = blk(d, xa = e);  logits from g (decode) or from
  sigmoid(blend) d + (1 - sigmoid(blend)) g (forward), through the final
  norm and the weight-tied token embedding.
The per-slot re-encode blk(xa[k]) and the cross K/V precompute run once
per utterance (``encode_xa``, ``precompute_cross``); every
length-dependent op reads ``text_valid``, so a fixed buffer computes
what the live prefix would.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from asr_model_tpu_torch.config import THETA
from asr_model_tpu_torch.models.attention import Attention
from asr_model_tpu_torch.models.gates import Router, TGate
from asr_model_tpu_torch.models.norms import AbbyNormal
from asr_model_tpu_torch.models.registry import get_activation, get_norm
from asr_model_tpu_torch.models.sheath import MSheath
from asr_model_tpu_torch.models.tlayers import Dense, Embed, param
from asr_model_tpu_torch.ops.audio import sinusoids
from asr_model_tpu_torch.ops.cuda import mlp as M
from asr_model_tpu_torch.ops.cuda.abby import window_size


class Residual(nn.Module):
    def __init__(self, dims: int, head: int, layer: int, act: str,
                 n_type: str, num_types: int = 3, mem: int = 64,
                 theta: float = THETA, fused_attention: bool = False,
                 fused_mlp: bool = False, fused_router: bool = False,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.dims, self.layer, self.theta = dims, layer, theta
        self.act_name, self.fused_mlp = act, fused_mlp
        self.act = get_activation(act)
        self.ln = get_norm(n_type, dims, **kw)
        self.attn = Attention(dims, head, n_type, fused=fused_attention,
                              **kw)
        self.router = Router(dims, num_types, layer - 1, fused=fused_router,
                             **kw)
        self.jump = MSheath(dims, head, layer, mem=mem, **kw)
        self.tgate = TGate(dims, num_types, **kw)
        self.mlp_in = Dense(dims, dims * num_types, **kw)
        self.mlp_out = Dense(dims * num_types, dims, **kw)

    def _pe(self, xa):
        pe = sinusoids(xa.shape[1], xa.shape[-1], self.theta,
                       device=xa.device)
        return xa + pe.to(xa.dtype)

    def mlp(self, x):
        h = self.tgate(self.ln(x))
        return self.ln(self.mlp_out(self.act(self.mlp_in(h))))

    def _mlp_fused_ok(self, x) -> bool:
        """The JAX package's PALLAS_MLP gate (``Residual.
        _mlp_fused_eligible``): AbbyNormal ``ln``, exact-erf GELU,
        lane-aligned width, decode-prefix sizes."""
        return (self.fused_mlp and self.act_name == "gelu"
                and isinstance(self.ln, AbbyNormal)
                and x.dtype in (torch.bfloat16, torch.float32)
                and self.dims % 128 == 0 and x.numel() <= 400_000)

    def mlp_fused_args(self, x2):
        """``fused_mlp_residual``'s arguments for the rows x2 (N, D)."""
        dt, ln, tg = x2.dtype, self.ln, self.tgate
        w = lambda t: t.to(dt)
        gates = [(w(getattr(tg, f"ga{i}").weight),
                  w(getattr(tg, f"ga{i}").bias)) for i in range(tg.num_types)]
        return (x2, (w(ln.router_in.weight), w(ln.router_in.bias),
                     w(ln.router_out.weight), w(ln.router_out.bias)),
                w(tg.cs.weight), w(tg.cs.bias), gates, w(self.mlp_in.weight),
                w(self.mlp_in.bias), w(self.mlp_out.weight),
                w(self.mlp_out.bias), window_size(self.dims), ln.alpha, ln.k,
                ln.beta)

    def _mlp_residual_fused(self, x):
        """x + mlp(x) in one ``fused_mlp_residual`` call."""
        out = M.fused_mlp_residual(*self.mlp_fused_args(
            x.reshape(-1, self.dims).contiguous()))
        return out.reshape(x.shape)

    def precompute_cross(self, xa, xa_valid=None):
        """The per-utterance half of the cross branch: +PE, MSheath,
        router mix and the processed K/V."""
        xa, _ = self.jump(self.ln(self._pe(xa)), valid=xa_valid)
        return self.attn.precompute_kv(self.router(*[xa] * (self.layer - 1)))

    def forward(self, x, xa=None, causal: bool = False, x_valid=None,
                xa_valid=None, cached_kv=None):
        n_router = self.layer - 1
        x, _ = self.jump(self.ln(x), valid=x_valid)
        x = (self.router(*[x] * n_router)
             + self.attn(self.ln(x), causal=causal, kv_valid=x_valid))
        if cached_kv is not None:
            x = x + self.attn(self.ln(x), cached_kv=cached_kv,
                              kv_valid=xa_valid)
        elif xa is not None:
            xa, _ = self.jump(self.ln(self._pe(xa)), valid=xa_valid)
            x = x + self.attn(self.ln(x), xa=self.router(*[xa] * n_router),
                              kv_valid=xa_valid)
        if self._mlp_fused_ok(x):
            return self._mlp_residual_fused(x)
        return x + self.mlp(x)


def encode_xa(blk: Residual, xa: Dict[str, torch.Tensor]):
    """The block's re-encode blk(xa[k]) of each modality slot; identical
    slot tensors encode once.  Each distinct slot is its own call, so
    MSheath's jump-control statistics stay per slot."""
    out, seen = {}, {}
    for k in ("a", "b", "c"):
        t = xa.get(k)
        if t is None:
            continue
        if id(t) not in seen:
            seen[id(t)] = blk(t)
        out[k] = seen[id(t)]
    return out


def run_block(blk: Residual, x, xa_kv: Dict, text_valid=None):
    """One block's a/b/c/d/e/(d, e -> g) flow against precomputed cross
    K/V; only the ``a`` call is causal.  Returns (d, g)."""
    T = x.shape[1]
    a = blk(x, causal=True, x_valid=text_valid)
    b = blk(a, cached_kv=xa_kv["a"], x_valid=text_valid) if "a" in xa_kv \
        else a
    c = blk(b, cached_kv=xa_kv["b"], x_valid=text_valid) if "b" in xa_kv \
        else b
    d = blk(c, cached_kv=xa_kv["c"], x_valid=text_valid) if "c" in xa_kv \
        else c
    e = a + b + c
    f = torch.cat([d, e], dim=1)
    g = blk(f[:, :T], xa=f[:, T:], x_valid=text_valid, xa_valid=text_valid)
    return d, g


class Processor(nn.Module):
    def __init__(self, tokens: int, dims: int, head: int, layer: int,
                 act: str, n_type: str, ctx: int = 2048, num_types: int = 3,
                 mem: int = 64, theta: float = THETA,
                 fused_attention: bool = False, fused_mlp: bool = False,
                 fused_router: bool = False, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln = get_norm(n_type, dims, **kw)
        self.token = Embed(tokens, dims, **kw)
        self.position = param(ctx, dims, **kw)
        self.blend = param((), **kw)
        self.last = f"block{layer - 1}"
        self.add_module(self.last, Residual(
            dims, head, layer, act, n_type, num_types, mem, theta,
            fused_attention=fused_attention, fused_mlp=fused_mlp,
            fused_router=fused_router, **kw))

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.position.fill_(1.0)
            self.blend.fill_(0.5)

    @property
    def block(self) -> Residual:
        return getattr(self, self.last)

    def embed(self, ids):
        return self.token(ids) + self.position[:ids.shape[1]]

    def encode_xa(self, xa):
        return encode_xa(self.block, xa)

    def precompute_cross(self, xa_enc):
        return {k: self.block.precompute_cross(xa_enc[k])
                for k in ("a", "b", "c") if xa_enc.get(k) is not None}

    def logits_head(self, d, g, seq: bool = False,
                    logits_position: Optional[int] = None):
        blend = torch.sigmoid(self.blend)
        out = g if seq else blend * d + (1 - blend) * g
        if logits_position is not None:
            out = out[:, logits_position:logits_position + 1]
        logits = self.ln(out) @ self.token.weight.t()
        return logits.float()

    def forward(self, ids, xa=None, seq: bool = False, text_valid=None,
                logits_position: Optional[int] = None, xa_kv=None):
        """``xa``: the encoded modality slots (re-encoded and cross K/V
        precomputed here), or ``xa_kv`` from ``precompute_cross``."""
        x = self.embed(ids)
        if xa_kv is None:
            xa_kv = self.precompute_cross(self.encode_xa(xa))
        d, g = run_block(self.block, x, xa_kv, text_valid=text_valid)
        return self.logits_head(d, g, seq=seq,
                                logits_position=logits_position)
