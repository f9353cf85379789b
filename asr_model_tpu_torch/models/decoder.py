"""Decoder: the residual block and the multi-modal ``Processor``.

Residual (per call):
  x, _ = MSheath(ln(x));  x = router(x x (layer-1)) + attn(ln(x), causal)
  cross: x += attn(ln(x), cached K/V)   or, with a source xa:
         xa += sinusoids; xa, _ = MSheath(ln(xa));
         x += attn(ln(x), xa=router(xa x (layer-1)))
  return x + ln(mlp_out(act(mlp_in(tgate(ln(x))))))
with one ``ln`` shared by every position; with ``moe_experts`` E > 0 the
mlp_in/mlp_out pair is ``models/moe.py:MoEMLP`` (E experts of its
shape).  The block's MSheath is built without its r_node paths whatever
``ModelConfig.msheath_mini_hc`` says, as the JAX package's is.
``streaming`` takes the x-side MSheath's streaming branch,
``xa_streaming`` the xa side's (a text-derived xa; audio xa stays
global), ``cross_causal`` masks the cross call causally (x and xa
position-aligned).  With ``fused_mlp`` the last
line is one call of ``ops/cuda/mlp.py`` wherever the JAX package's
PALLAS_MLP gate would route it (``Residual._mlp_fused_ok``: never an
MoE block, never an activation but GELU); the fields
``fused_attention`` and ``fused_router`` go to the block's Attention and
Router.

Processor (chained=False, the reference's configuration): only the last
block reaches the output, so it is the only block built; with
``chained`` every block ``block0 .. block{L-1}`` is built and each takes
the previous block's g as its x.  Per block:
  a = blk(x, causal);  b/c/d = blk(prev, cross = slot a/b/c);
  e = a + b + c;  g = blk(d, xa = e);  logits from g (the buffer decode
  of a non-streaming model) or from sigmoid(blend) d + (1 -
  sigmoid(blend)) g (forward, and every decode of a streaming model),
  through the final norm and the weight-tied token embedding.
  ``causal_all`` masks b, c, d and g's self-attention causally too;
  ``streaming`` implies it and makes every text-side path prefix-causal
  (the MSheath streaming branch on x, and on g's xa with a causal
  cross), which lets ``decode_stream_step`` run one position at a time
  against per-site state (``StreamingResidual``).
The per-slot re-encode blk(xa[k]) and the cross K/V precompute run once
per utterance (``encode_xa``, ``precompute_cross``), from the last block
alone as the JAX package's decode computes them: a chained model's
decode runs every block against that one cache, while its forward
re-encodes the audio and computes the cross K/V per block; every
length-dependent op reads ``text_valid``, so a fixed buffer computes
what the live prefix would.  Off the eval route (train mode or a
generator) the flow is the JAX package's training one
(``run_block_xa``): every slot is its own re-encode call, identical
slots included, and each cross call runs its own xa-side MSheath and
K/V (each call its own gumbel draws and jump counter).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from asr_model_tpu_torch.config import THETA
from asr_model_tpu_torch.models import stochastic
from asr_model_tpu_torch.models.attention import Attention
from asr_model_tpu_torch.models.gates import Router, TGate
from asr_model_tpu_torch.models.moe import MoEMLP
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
                 moe_experts: int = 0, moe_top_k: int = 2,
                 moe_capacity_factor: float = 1.25,
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
        self.moe = None
        if moe_experts > 0:
            self.moe = MoEMLP(dims, dims * num_types, moe_experts,
                              top_k=moe_top_k,
                              capacity_factor=moe_capacity_factor, act=act,
                              **kw)
        else:
            self.mlp_in = Dense(dims, dims * num_types, **kw)
            self.mlp_out = Dense(dims * num_types, dims, **kw)

    def _pe(self, xa):
        pe = sinusoids(xa.shape[1], xa.shape[-1], self.theta,
                       device=xa.device)
        return xa + pe.to(xa.dtype)

    def mlp(self, x):
        h = self.tgate(self.ln(x))
        if self.moe is not None:
            return self.ln(self.moe(h))
        return self.ln(self.mlp_out(self.act(self.mlp_in(h))))

    def _mlp_fused_ok(self, x) -> bool:
        """The JAX package's PALLAS_MLP gate (``Residual.
        _mlp_fused_eligible``): a dense MLP (no MoE), AbbyNormal ``ln``,
        exact-erf GELU, lane-aligned width, decode-prefix sizes."""
        return (self.fused_mlp and stochastic.eval_route()
                and self.moe is None and self.mlp_in.tp is None
                and self.act_name == "gelu"
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

    def mlp_residual(self, x):
        """x + mlp(x): one ``fused_mlp_residual`` call where the gate
        admits it."""
        if self._mlp_fused_ok(x):
            return self._mlp_residual_fused(x)
        return x + self.mlp(x)

    def forward(self, x, xa=None, causal: bool = False, x_valid=None,
                xa_valid=None, cached_kv=None, streaming: bool = False,
                cross_causal: bool = False, xa_streaming: bool = False):
        n_router = self.layer - 1
        x, _ = self.jump(self.ln(x), valid=x_valid, streaming=streaming)
        x = (self.router(*[x] * n_router)
             + self.attn(self.ln(x), causal=causal, kv_valid=x_valid))
        if cached_kv is not None:
            x = x + self.attn(self.ln(x), cached_kv=cached_kv,
                              kv_valid=xa_valid)
        elif xa is not None:
            xa, _ = self.jump(self.ln(self._pe(xa)), valid=xa_valid,
                              streaming=xa_streaming)
            x = x + self.attn(self.ln(x), xa=self.router(*[xa] * n_router),
                              causal=cross_causal, kv_valid=xa_valid)
        return self.mlp_residual(x)


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


def run_block(blk: Residual, x, xa_kv: Dict, text_valid=None,
              streaming: bool = False, causal_all: bool = False):
    """One block's a/b/c/d/e/(d, e -> g) flow against precomputed cross
    K/V.  The ``a`` call is causal; with ``ca = causal_all or
    streaming`` so are b, c, d and g's self-attention, and with
    ``streaming`` every MSheath on the text side streams and g's cross
    is causal.  Returns (d, g)."""
    T = x.shape[1]
    st, ca = streaming, causal_all or streaming
    kw = dict(causal=ca, x_valid=text_valid, streaming=st)
    a = blk(x, causal=True, x_valid=text_valid, streaming=st)
    b = blk(a, cached_kv=xa_kv["a"], **kw) if "a" in xa_kv else a
    c = blk(b, cached_kv=xa_kv["b"], **kw) if "b" in xa_kv else b
    d = blk(c, cached_kv=xa_kv["c"], **kw) if "c" in xa_kv else c
    e = a + b + c
    f = torch.cat([d, e], dim=1)
    g = blk(f[:, :T], xa=f[:, T:], xa_valid=text_valid, cross_causal=st,
            xa_streaming=st, **kw)
    return d, g


def run_block_xa(blk: Residual, x, xa_enc: Dict, text_valid=None,
                 streaming: bool = False, causal_all: bool = False):
    """``run_block`` with the cross calls over the re-encoded slots
    ``xa_enc`` (the xa side inside each call), as the JAX package
    trains."""
    T = x.shape[1]
    st, ca = streaming, causal_all or streaming
    kw = dict(causal=ca, x_valid=text_valid, streaming=st)
    a = blk(x, causal=True, x_valid=text_valid, streaming=st)
    b = blk(a, xa=xa_enc["a"], **kw) if "a" in xa_enc else a
    c = blk(b, xa=xa_enc["b"], **kw) if "b" in xa_enc else b
    d = blk(c, xa=xa_enc["c"], **kw) if "c" in xa_enc else c
    e = a + b + c
    f = torch.cat([d, e], dim=1)
    g = blk(f[:, :T], xa=f[:, T:], xa_valid=text_valid, cross_causal=st,
            xa_streaming=st, **kw)
    return d, g


def _update_cache(cache, new, pos: int):
    """Write the (B, H, 1, hd) slice ``new`` at time index ``pos`` of a
    (B, H, Tmax, hd) cache, in place."""
    cache[:, :, pos:pos + 1].copy_(new)


class StreamingResidual:
    """One position of ``Residual`` for the streaming-causal variant,
    against per-call-site state: the MSheath stream state (``jump``)
    and (B, H, Tmax, hd) self K/V caches in the model's dtype, written
    after scale, rotary and head norm (what the buffer call recomputes
    for every prefix position each step); the g site adds the state of
    its growing text-derived cross source (``xa_jump``, ``xa_k``,
    ``xa_v``).  The numerics of a position equal the buffer call's
    newest position."""

    @staticmethod
    def init_state(blk: Residual, batch: int, t_max: int, dtype, device,
                   with_xa: bool = False) -> dict:
        h = blk.attn.head
        shape = (batch, h, t_max, blk.dims // h)
        zeros = lambda: torch.zeros(shape, dtype=dtype, device=device)
        st = {"jump": blk.jump.init_stream_state(batch, device),
              "k": zeros(), "v": zeros()}
        if with_xa:
            st |= {"xa_jump": blk.jump.init_stream_state(batch, device),
                   "xa_k": zeros(), "xa_v": zeros()}
        return st

    @staticmethod
    def step(blk: Residual, x_t, pos: int, st: dict, prefix_valid,
             cached_kv=None, xa_t=None, pe_row=None):
        """x_t (B, 1, D) at position ``pos``; prefix_valid (B, Tmax) the
        positions <= pos.  Updates ``st`` in place; returns y_t."""
        n_router = blk.layer - 1
        at = blk.attn
        x1, _ = blk.jump.stream_step(blk.ln(x_t), st["jump"])
        ax = blk.ln(x1)
        qn = at.q_step(ax, pos, causal=True)
        kn, v = at.kv_step(ax, pos, causal=True)
        _update_cache(st["k"], kn, pos)
        _update_cache(st["v"], v, pos)
        x2 = blk.router(*[x1] * n_router) + at.attend_cached(
            qn, st["k"], st["v"], kv_valid=prefix_valid)
        if cached_kv is not None:
            # the audio source: precomputed K/V, the non-causal ladder
            q2 = at.q_step(blk.ln(x2), pos, causal=False)
            x2 = x2 + at.attend_cached(q2, *cached_kv)
        elif xa_t is not None:
            # the growing text-derived source of the d||e call: causal
            # on both sides
            xa1, _ = blk.jump.stream_step(
                blk.ln(xa_t + pe_row.to(xa_t.dtype)), st["xa_jump"])
            kx, vx = at.kv_step(blk.router(*[xa1] * n_router), pos,
                                causal=True)
            _update_cache(st["xa_k"], kx, pos)
            _update_cache(st["xa_v"], vx, pos)
            q3 = at.q_step(blk.ln(x2), pos, causal=True)
            x2 = x2 + at.attend_cached(q3, st["xa_k"], st["xa_v"],
                                       kv_valid=prefix_valid)
        return blk.mlp_residual(x2)


class Processor(nn.Module):
    def __init__(self, tokens: int, dims: int, head: int, layer: int,
                 act: str, n_type: str, ctx: int = 2048, num_types: int = 3,
                 mem: int = 64, theta: float = THETA,
                 causal_all: bool = False, streaming: bool = False,
                 chained: bool = False, fused_attention: bool = False,
                 fused_mlp: bool = False, fused_router: bool = False,
                 moe_experts: int = 0, moe_top_k: int = 2,
                 moe_capacity_factor: float = 1.25,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.dims, self.theta = dims, theta
        self.causal_all, self.streaming = causal_all, streaming
        self.chained = chained
        self.ln = get_norm(n_type, dims, **kw)
        self.token = Embed(tokens, dims, **kw)
        self.position = param(ctx, dims, **kw)
        self.blend = param((), **kw)
        self.names = [f"block{i}" for i in
                      (range(layer) if chained else [layer - 1])]
        for name in self.names:
            self.add_module(name, Residual(
                dims, head, layer, act, n_type, num_types, mem, theta,
                fused_attention=fused_attention, fused_mlp=fused_mlp,
                fused_router=fused_router, moe_experts=moe_experts,
                moe_top_k=moe_top_k,
                moe_capacity_factor=moe_capacity_factor, **kw))

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.position.fill_(1.0)
            self.blend.fill_(0.5)

    @property
    def block(self) -> Residual:
        """The last block: the one the decode's cross K/V come from."""
        return getattr(self, self.names[-1])

    @property
    def blocks(self) -> list:
        return [getattr(self, n) for n in self.names]

    def embed(self, ids):
        return self.token(ids) + self.position[:ids.shape[1]]

    def encode_xa(self, xa, blk: Optional[Residual] = None):
        return encode_xa(blk or self.block, xa)

    def precompute_cross(self, xa_enc, blk: Optional[Residual] = None):
        blk = blk or self.block
        return {k: blk.precompute_cross(xa_enc[k])
                for k in ("a", "b", "c") if xa_enc.get(k) is not None}

    def logits_head(self, d, g, seq: bool = False,
                    logits_position: Optional[int] = None):
        blend = torch.sigmoid(self.blend)
        out = g if seq else blend * d + (1 - blend) * g
        if logits_position is not None:
            out = out[:, logits_position:logits_position + 1]
        logits = self.token.logits(self.ln(out))
        # f32 logits (from bf16 too); a float64 model keeps float64
        return logits.to(torch.promote_types(logits.dtype, torch.float32))

    def forward(self, ids, xa=None, seq: bool = False, text_valid=None,
                logits_position: Optional[int] = None, xa_kv=None):
        """``xa``: the encoded modality slots (re-encoded and cross K/V
        precomputed here, by each block), or ``xa_kv`` from
        ``precompute_cross`` (the decode's: every block reads it)."""
        x = self.embed(ids)
        d = g = None
        for blk in self.blocks:
            d, g = self.block_forward(blk, x, xa, text_valid, xa_kv)
            x = g
        return self.logits_head(d, g, seq=seq,
                                logits_position=logits_position)

    def block_forward(self, blk: Residual, x, xa=None, text_valid=None,
                      xa_kv=None):
        """One block's (d, g) on x: against ``xa_kv``, else the training
        flow off the eval route, else the block's own re-encode and
        cross K/V of the encoded slots ``xa`` (a pipeline stage runs its
        blocks through this too)."""
        flow = dict(streaming=self.streaming, causal_all=self.causal_all)
        if xa_kv is not None:
            return run_block(blk, x, xa_kv, text_valid=text_valid, **flow)
        if not stochastic.eval_route():
            xa_enc = {k: blk(xa[k]) for k in ("a", "b", "c")
                      if xa.get(k) is not None}
            return run_block_xa(blk, x, xa_enc, text_valid, **flow)
        kv = self.precompute_cross(self.encode_xa(xa, blk), blk)
        return run_block(blk, x, kv, text_valid=text_valid, **flow)

    # ---- the incremental decode of the streaming variant

    def init_stream_state(self, batch: int, t_max: int, dtype) -> dict:
        """The state of ``decode_stream_step``: the five call sites
        a/b/c/d/g of the block, on the model's device.  A chained model
        has none (as in the JAX package: its stream decode is not
        implemented; ``Transcriber`` gives it the buffer decode)."""
        if self.chained:
            raise NotImplementedError(
                "incremental streaming decode supports chained=False")
        S, blk = StreamingResidual, self.block
        dev = self.position.device
        return {k: S.init_state(blk, batch, t_max, dtype, dev)
                for k in ("a", "b", "c", "d")} | {
            "g": S.init_state(blk, batch, t_max, dtype, dev, with_xa=True)}

    def decode_stream_step(self, token_t, pos: int, state: dict,
                           xa_kv: Dict, pe_table):
        """One decode step of the streaming variant: the newest token
        (B,) at position ``pos`` through the a/b/c/d/e/(d||e -> g) flow
        for that position against ``state`` (updated in place; the
        sinusoid table ``pe_table`` (Tmax, D) gives g's cross source its
        positions).  Returns the blended (seq=False) head's logits (B,
        vocab) in f32.  The one host read of a decode: at position 1, the
        MSheath states' position-0 jump actions, which the later steps
        replay."""
        if not self.streaming:
            raise ValueError("decode_stream_step needs a streaming model")
        S, blk = StreamingResidual, self.block
        if pos > 0:     # the position-0 jump actions, one host read
            MSheath.pin_actions([st[k] for st in state.values()
                                 for k in ("jump", "xa_jump") if k in st])
        t_max = state["a"]["k"].shape[2]
        batch = token_t.shape[0]
        prefix_valid = (torch.arange(t_max, device=token_t.device) <= pos)[
            None].expand(batch, t_max).contiguous()
        x = self.token(token_t[:, None]) + self.position[pos:pos + 1]
        a = S.step(blk, x, pos, state["a"], prefix_valid)
        prev, out = a, {}
        for site, slot in (("b", "a"), ("c", "b"), ("d", "c")):
            if slot in xa_kv:
                prev = S.step(blk, prev, pos, state[site], prefix_valid,
                              cached_kv=xa_kv[slot])
            out[site] = prev
        b, c, d = out["b"], out["c"], out["d"]
        g = S.step(blk, d, pos, state["g"], prefix_valid, xa_t=a + b + c,
                   pe_row=pe_table[pos:pos + 1])
        return self.logits_head(d, g, seq=False)[:, 0], state
