"""MSheath: the adaptive-depth layer-slot stack, eval and non-streaming.

The layer-slot recurrence (v_gate, LayerNorm, even-slot adapter, skip
gate, working-memory EMA and the scalar jump policy over ``layer``
slots) is ``ops/cuda/sheath.py``: the kernel sequence on a CUDA tensor,
its plain version on a CPU one.  Around it: the policy ``sampled =
argmax(mean over the batch of MPNet(masked mean of x))`` computed by
the caller as in the reference, and the post-scan gated MLP
``x + sigmoid(x w + b) * mlp2(silu(mlp1(LayerNorm(x))))``.  Jump control
is one scalar per call: a caller that stacks independent inputs must
call once per input to keep their statistics apart.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from asr_model_tpu_torch.models.gates import MPNet
from asr_model_tpu_torch.models.tlayers import Dense, normal_, param, uniform_
from asr_model_tpu_torch.ops.cuda import sheath as K


def masked_mean(x, valid, dim):
    if valid is None:
        return x.mean(dim=dim, keepdim=True)
    m = valid.to(x.dtype)
    while m.dim() < x.dim():
        m = m[..., None]
    s = torch.sum(x * m, dim=dim, keepdim=True)
    return s / torch.clamp(torch.sum(m, dim=dim, keepdim=True), min=1.0)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) * (x - mu)).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


class MSheath(nn.Module):
    def __init__(self, dims: int, head: int, layer: int, mem: int = 64,
                 thresh: float = 0.3, device=None, dtype=None):
        super().__init__()
        d, L, M = dims, layer, mem
        self.dims, self.head, self.layer, self.mem = d, head, L, M
        self.thresh = thresh
        kw = dict(device=device, dtype=dtype)
        n_adapt = (L + 1) // 2
        self.mem_w = param(1, 1, d, **kw)
        self.memgate_w = param(d, 1, **kw)
        self.memgate_b = param(1, **kw)
        self.jump_s = param(3, **kw)
        self.span_scale = param(1, **kw)     # reference parameter, unused
        self.ln_scale = param(L, d, **kw)
        self.ln_bias = param(L, d, **kw)
        self.gate_w = param(L, d, 1, **kw)
        self.gate_b = param(L, 1, **kw)
        self.mkey = param(L, M, d, **kw)
        self.mval = param(L, M, 1, **kw)
        self.vmlp1_w = param(L, d, d // 2, **kw)
        self.vmlp1_b = param(L, d // 2, **kw)
        self.vmlp2_w = param(L, d // 2, 1, **kw)
        self.vmlp2_b = param(L, 1, **kw)
        self.vcat_w = param(L, 2, 1, **kw)
        self.vcat_b = param(L, 1, **kw)
        self.adapt_w = param(n_adapt, d, d, **kw)
        self.adapt_b = param(n_adapt, d, **kw)
        self.pnet = MPNet(d, jump=2, **kw)
        self.mlpgate_w = param(d, 1, **kw)
        self.mlpgate_b = param(1, **kw)
        self.mlp1 = Dense(d, 4 * d, **kw)
        self.mlp2 = Dense(4 * d, d, **kw)
        self.mlp_ln_scale = param(d, **kw)
        self.mlp_ln_bias = param(d, **kw)
        self._scan_cache = (None, None)

    def reset_parameters(self, gen):
        """The reference's init: flax kernels bound by the product of
        every axis but the last, biases by the declared width."""
        d, L = self.dims, self.layer
        with torch.no_grad():
            self.mem_w.zero_()
            uniform_(self.memgate_w, d, gen)
            uniform_(self.memgate_b, d, gen)
            self.jump_s.copy_(torch.tensor([0.1, 0.05, 0.01]))
            self.span_scale.fill_(1.0)
            self.ln_scale.fill_(1.0)
            self.ln_bias.zero_()
            uniform_(self.gate_w, L * d, gen)
            uniform_(self.gate_b, d, gen)
            normal_(self.mkey, gen)
            normal_(self.mval, gen)
            uniform_(self.vmlp1_w, L * d, gen)
            uniform_(self.vmlp1_b, d, gen)
            uniform_(self.vmlp2_w, L * (d // 2), gen)
            uniform_(self.vmlp2_b, d // 2, gen)
            uniform_(self.vcat_w, L * 2, gen)
            uniform_(self.vcat_b, 2, gen)
            uniform_(self.adapt_w, self.adapt_w.shape[0] * d, gen)
            uniform_(self.adapt_b, d, gen)
            uniform_(self.mlpgate_w, d, gen)
            uniform_(self.mlpgate_b, d, gen)
            self.mlp_ln_scale.fill_(1.0)
            self.mlp_ln_bias.zero_()

    def scan_weights(self) -> dict:
        """The per-slot stacks as contiguous f32 (what the scan takes;
        float64 stays float64), cached until a parameter changes."""
        stacks = {
            "ln_scale": self.ln_scale, "ln_bias": self.ln_bias,
            "gate_w": self.gate_w[..., 0], "gate_b": self.gate_b[:, 0],
            "mkey": self.mkey, "mval": self.mval[..., 0],
            "vmlp1_w": self.vmlp1_w, "vmlp1_b": self.vmlp1_b,
            "vmlp2_w": self.vmlp2_w[..., 0], "vmlp2_b": self.vmlp2_b[:, 0],
            "vcat_w": self.vcat_w[..., 0], "vcat_b": self.vcat_b[:, 0],
            "adapt_w": self.adapt_w, "adapt_b": self.adapt_b,
            "memgate_w": self.memgate_w[:, 0], "memgate_b": self.memgate_b,
            "mem0": self.mem_w.reshape(-1), "jump_s": self.jump_s}
        key = tuple((t.data_ptr(), t._version, t.dtype) for t in
                    stacks.values())
        if self._scan_cache[0] != key:
            ct = torch.promote_types(self.mkey.dtype, torch.float32)
            self._scan_cache = (key, {k: v.to(ct).contiguous()
                                      for k, v in stacks.items()})
        return self._scan_cache[1]

    def forward(self, x, valid=None):
        b, ctx, d = x.shape
        pooled = masked_mean(x, valid, dim=1)[:, 0]
        policy_mean = self.pnet(pooled).mean(dim=0)
        sampled = torch.argmax(policy_mean).to(torch.int32)
        w = self.scan_weights()
        xk, actions, jstat = K.fused_sheath_scan(
            x.reshape(b * ctx, d).contiguous(), b,
            None if valid is None else valid.contiguous(), w["mem0"],
            sampled, w["jump_s"], {k: w[k] for k in K.WEIGHT_NAMES},
            self.layer, self.thresh)
        x = xk.reshape(b, ctx, d)
        gate = torch.sigmoid(x @ self.mlpgate_w + self.mlpgate_b)
        h = layer_norm(x, self.mlp_ln_scale, self.mlp_ln_bias)
        x = x + gate * self.mlp2(F.silu(self.mlp1(h)))
        return x, {"jstat": jstat, "actions": actions}
