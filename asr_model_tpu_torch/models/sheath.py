"""MSheath: the adaptive-depth layer-slot stack.

The layer-slot recurrence (v_gate, LayerNorm, even-slot adapter, skip
gate, working-memory EMA and the scalar jump policy over ``layer``
slots) is ``ops/cuda/sheath.py``: the kernel sequence on a CUDA tensor,
its plain version on a CPU one.  Around it: the policy ``sampled =
argmax(mean over the batch of MPNet(masked mean of x))`` computed by
the caller as in the reference, and the post-scan gated MLP
``x + sigmoid(x w + b) * mlp2(silu(mlp1(LayerNorm(x))))``.  Jump control
is one scalar per call: a caller that stacks independent inputs must
call once per input to keep their statistics apart.

``streaming=True`` (the streaming-causal decoder) makes output position
t a function of input positions <= t: the working memory is a
per-position causal running mean (f32 cumulative sums) instead of one
pooled row, and the policy input and the forced-skip potential come
from position 0.  The JAX package never sends this scan to its kernel;
here too it is PyTorch ops on every device (``_stream_scan``), sharing
the per-slot math with the kernel's plain version
(``ops/cuda/sheath.py:slot_rows``), with the slot index and the jump
control on the device (no host read).  ``init_stream_state`` and
``stream_step`` run it one position at a time with running sums: the
incremental decode's form, equal by induction to the buffer form's
newest position.

``mini_hc=True`` adds the r_node ("ranvier") paths to every executed
slot: the adapted rows go through ``rate`` parallel linear paths mixed
by a softmax of a per-slot router, then ReLU, before the gate
(``ranvier``).  The JAX package never sends such a scan to its kernel:
here its eval scan is the keyed scan below with no noise, and the
streaming scans take the paths through ``slot_rows``.

Off the eval route (train mode or a generator, ``stochastic.mode``) the
scan is the JAX package's keyed XLA scan (``_train_scan``) in PyTorch
ops on every device, differentiable: each slot draws its own gumbel
noise for the jump policy (straight-through: the kept or jumped state is
scaled by the policy's forward value 1.0, whose gradient reaches the
policy network), ``ste_threshold``'s identity backward carries v_gate's
mask, the slot index and the jump control stay on the device, and the
jump counter is added to the call's record.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from asr_model_tpu_torch.models import stochastic
from asr_model_tpu_torch.models.gates import MPNet
from asr_model_tpu_torch.models.tlayers import Dense, normal_, param, uniform_
from asr_model_tpu_torch.ops.cuda import sheath as K
from asr_model_tpu_torch.parallel import context as pctx
from asr_model_tpu_torch.utils import l2norm


# the per-slot stacks the keyed scan's step reads (``MSheath._slot``),
# and the r_node paths' with ``mini_hc``
SLOT_PARAMS = ("ln_scale", "ln_bias", "gate_w", "gate_b", "mkey", "mval",
               "vmlp1_w", "vmlp1_b", "vmlp2_w", "vmlp2_b", "vcat_w",
               "vcat_b", "adapt_w", "adapt_b", "memgate_w", "memgate_b",
               "jump_s")
RANVIER_PARAMS = ("par_w", "par_b", "rnet_w", "rnet_b")


def masked_mean(x, valid, dim):
    if valid is None:
        return x.mean(dim=dim, keepdim=True)
    m = valid.to(x.dtype)
    while m.dim() < x.dim():
        m = m[..., None]
    s = torch.sum(x * m, dim=dim, keepdim=True)
    return s / torch.clamp(torch.sum(m, dim=dim, keepdim=True), min=1.0)


def causal_mean(x, valid):
    """Per-position running mean over positions <= t (axis 1), summed in
    f32 and cast back to x's dtype."""
    f32 = x.to(torch.float32)
    if valid is None:
        s = torch.cumsum(f32, dim=1)
        n = torch.arange(1, x.shape[1] + 1, dtype=torch.float32,
                         device=x.device)[None, :, None]
    else:
        m = valid.to(torch.float32)[..., None]
        s = torch.cumsum(f32 * m, dim=1)
        n = torch.clamp(torch.cumsum(m, dim=1), min=1.0)
    return (s / n).to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) * (x - mu)).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


class MSheath(nn.Module):
    def __init__(self, dims: int, head: int, layer: int, mem: int = 64,
                 thresh: float = 0.3, mini_hc: bool = False, rate: int = 2,
                 device=None, dtype=None):
        super().__init__()
        d, L, M = dims, layer, mem
        self.dims, self.head, self.layer, self.mem = d, head, L, M
        self.thresh, self.mini_hc, self.rate = thresh, mini_hc, rate
        self.slot_params = SLOT_PARAMS + (RANVIER_PARAMS if mini_hc else ())
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
        if mini_hc:
            self.par_w = param(L, rate, d, d, **kw)
            self.par_b = param(L, rate, d, **kw)
            self.rnet_w = param(L, d, rate, **kw)
            self.rnet_b = param(L, rate, **kw)
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
            if self.mini_hc:
                uniform_(self.par_w, L * self.rate * d, gen)
                uniform_(self.par_b, d, gen)
                uniform_(self.rnet_w, L * d, gen)
                uniform_(self.rnet_b, d, gen)
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
        if self.mini_hc:
            stacks |= {k: getattr(self, k) for k in RANVIER_PARAMS}
        key = tuple((t.data_ptr(), t._version, t.dtype) for t in
                    stacks.values())
        if self._scan_cache[0] != key:
            ct = torch.promote_types(self.mkey.dtype, torch.float32)
            w = {k: v.to(ct).contiguous() for k, v in stacks.items()}
            # the memory keys normalised once (the streaming scan's)
            w["mkey_n"] = l2norm(w["mkey"])
            self._scan_cache = (key, w)
        return self._scan_cache[1]

    def _stream_scan(self, x, sampled, mean_fn):
        """The layer-slot scan of the streaming variant over x (B, T, D),
        all of it on x's device: ``mean_fn(step, x_new, active)`` gives
        the causal mean (B, T, D) of this scan step; the jump action
        comes from position 0's ion (the forced skip) and ``sampled``.
        Returns (x in f32, actions (L,) int32, jstat (3,) int32)."""
        L = self.layer
        w = self.scan_weights()
        dev = x.device
        x = x.to(w["mkey"].dtype)
        x0 = x
        mem_w = w["mem0"].expand_as(x)
        i = torch.zeros((), dtype=torch.int64, device=dev)
        jstat = torch.zeros(3, dtype=torch.int32, device=dev)
        kinds = torch.arange(3, device=dev)
        actions = []
        for step in range(L):
            active = i < L
            x_new, ion = K.slot_rows(x, w, torch.clamp(i, max=L - 1),
                                     self.thresh)
            mem_w_new = self._mem_ema(w, mem_w, mean_fn(step, x_new, active))
            forced = ion[:, 0].mean() < 0.1
            action = torch.where(i >= L - 1, 0, torch.where(
                forced, 1, sampled.to(torch.int64)))
            jw = w["jump_s"].index_select(
                0, torch.clamp(action - 1, 0, 2).reshape(1))
            x_out = torch.where(action > 0, x_new + (jw * x0 + (1.0 - jw)
                                                     * mem_w_new), x_new)
            i_next = torch.where(action > 0,
                                 torch.clamp(i + action + 1, max=L), i + 1)
            x = torch.where(active, x_out, x)
            mem_w = torch.where(active, mem_w_new, mem_w)
            i = torch.where(active, i_next, i)
            jstat = jstat + (active & (kinds == action)).to(
                torch.int32) * x.shape[0]
            actions.append(action)
        return x, torch.stack(actions).to(torch.int32), jstat

    def _replay_scan(self, x, actions, mean_fn):
        """The same scan with its actions known on the host (``actions``,
        a tuple of L ints): only the executed slots run, each slot's
        weights a view, and the memory EMA only while a later jump reads
        it.  The same values as ``_stream_scan`` with those actions."""
        L = self.layer
        w = self.scan_weights()
        x = x.to(w["mkey"].dtype)
        x0 = x
        mem_w = w["mem0"].expand_as(x)
        i = 0
        for step in range(L):
            if i >= L:
                break
            x_new, _ = K.slot_rows(x, w, i, self.thresh)
            mem = mean_fn(step, x_new, None)
            action = actions[step]
            if any(a > 0 for a in actions[step:]):
                mem_w = self._mem_ema(w, mem_w, mem)
            if action > 0:
                jw = w["jump_s"][min(action - 1, 2)]
                x_new = x_new + (jw * x0 + (1.0 - jw) * mem_w)
                i = min(i + action + 1, L)
            else:
                i += 1
            x = x_new
        return x

    @staticmethod
    def _mem_ema(w, mem_w, mem):
        mem_v = torch.sigmoid(mem @ w["memgate_w"] + w["memgate_b"])[..., None]
        return mem_v * mem_w + (1.0 - mem_v) * mem

    def _mlp_tail(self, x):
        gate = torch.sigmoid(x @ self.mlpgate_w + self.mlpgate_b)
        h = layer_norm(x, self.mlp_ln_scale, self.mlp_ln_bias)
        return x + gate * self.mlp2(F.silu(self.mlp1(h)))

    def _sampled(self, pooled):
        return torch.argmax(self.pnet(pooled).mean(dim=0)).to(torch.int32)

    @staticmethod
    def _v_gate(w, x, i, thresh: float):
        """v_gate of slot ``i`` (a 0-d int64 device tensor) on x (B, T,
        D) with the slot stacks ``w``: the straight-through mask (B, T,
        1)."""
        pick = lambda t: t.index_select(0, i.reshape(1))[0]
        key = torch.softmax(l2norm(x) @ l2norm(pick(w["mkey"])).t()
                            / math.sqrt(x.shape[-1]), dim=-1)
        mem_score = key @ pick(w["mval"])
        h = F.silu(x @ pick(w["vmlp1_w"]) + pick(w["vmlp1_b"]))
        mlp_score = h @ pick(w["vmlp2_w"]) + pick(w["vmlp2_b"])
        x_val = (torch.cat([mem_score, mlp_score], dim=-1)
                 @ pick(w["vcat_w"]) + pick(w["vcat_b"]))
        return stochastic.ste_threshold(x_val, thresh)

    def _slot(self, x, mem_w, i, jstat, orig_x, policy_mean, noise, valid,
              streaming: bool, *stacks):
        """One step of the keyed scan: slot ``i``'s update of the carry
        (x, mem_w, i, jstat) and its action.  Every tensor it reads is an
        argument (``stacks``: the ``SLOT_PARAMS`` as the forward sees
        them, the bf16 casts under the train step's ``functional_call``;
        ``RANVIER_PARAMS`` after them with ``mini_hc``),
        so a checkpoint's recompute, which runs after the forward has
        returned, recomputes the same values."""
        w = dict(zip(self.slot_params, stacks))
        L, b, dev = self.layer, x.shape[0], x.device
        active = i < L
        idx = torch.clamp(i, max=L - 1)
        pick = lambda t, j=idx: t.index_select(0, j.reshape(1))[0]
        ion = self._v_gate(w, x, idx, self.thresh)
        px = layer_norm(x, pick(w["ln_scale"]), pick(w["ln_bias"]))
        a_idx = (idx // 2).reshape(1)
        adapted = (px @ w["adapt_w"].index_select(0, a_idx)[0]
                   + w["adapt_b"].index_select(0, a_idx)[0])
        apx = torch.where(idx % 2 == 0, adapted, px)
        if self.mini_hc:
            apx = K.ranvier(apx, w, idx)
        g_val = torch.sigmoid(px @ pick(w["gate_w"]) + pick(w["gate_b"]))
        x_new = x + g_val * (apx * ion)
        # the forced-skip potential is a mean over the whole batch; under
        # a batch sharded over ranks, of every shard (``batch_pmean``)
        sharded = pctx.batch_axis() is not None
        if streaming:
            mem = causal_mean(x_new, valid)
            potential = (pctx.global_mean(ion[:, 0], (0, 1)) if sharded
                         else ion[:, 0].mean())
        else:
            mem = masked_mean(x_new, valid, dim=1)
            if not sharded:
                potential = (ion.mean() if valid is None else masked_mean(
                    ion, valid, dim=(0, 1, 2))[0, 0, 0])
            elif valid is None:
                potential = pctx.global_mean(ion, (0, 1, 2))
            else:
                potential = pctx.global_masked_mean(ion, valid)
        mem_v = torch.sigmoid(mem @ w["memgate_w"] + w["memgate_b"])
        mem_w_new = mem_v * mem_w + (1 - mem_v) * mem
        last = i >= L - 1
        forced = (potential < 0.1) & ~last
        jump = stochastic.gumbel_softmax(policy_mean, noise, 1.0, True)
        sampled = torch.argmax(jump, dim=-1)
        action = torch.where(last, 0, torch.where(forced, 1, sampled))
        one = torch.ones((), dtype=x.dtype, device=dev)
        jump_g = torch.where(forced | last, one,
                             jump.index_select(0, sampled.reshape(1))[0])
        jump_w = w["jump_s"].index_select(
            0, torch.clamp(action - 1, 0, 2).reshape(1))[0]
        jump_i = jump_w * orig_x + (1 - jump_w) * mem_w_new
        x_out = torch.where(action > 0, x_new + jump_i * jump_g,
                            x_new * jump_g)
        i_next = torch.where(action > 0,
                             torch.clamp(i + action + 1, max=L), i + 1)
        kinds = torch.arange(3, device=dev)
        jstat = jstat + (active & (kinds == action)).to(torch.int32) * b
        x = torch.where(active, x_out, x).to(x.dtype)
        mem_w = torch.where(active, mem_w_new, mem_w).to(mem_w.dtype)
        return x, mem_w, torch.where(active, i_next, i), jstat, action

    def _train_scan(self, x, valid, streaming: bool):
        """The keyed layer-slot scan (``asr_model_tpu/models/sheath.py:
        _xla_scan``): returns (x, actions (L,), jstat (3,) int32).  Each
        slot's gumbel noise is drawn before its step, and under
        ``stochastic.remat`` the step is checkpointed
        (``stochastic.checkpoint``: the backward recomputes it and keeps
        only its inputs), the counterpart of the JAX package's
        ``scan_remat``; both routes draw in the same order."""
        b, dev = x.shape[0], x.device
        pooled = x[:, 0] if streaming else masked_mean(x, valid, dim=1)[:, 0]
        policy = self.pnet(pooled)
        policy_mean = (policy.mean(dim=0) if pctx.batch_axis() is None
                       else pctx.global_mean(policy, (0,)))
        gen = stochastic.generator()
        mem_w = self.mem_w.to(x.dtype).expand(b, x.shape[1] if streaming
                                              else 1, self.dims)
        carry = (x, mem_w, torch.zeros((), dtype=torch.int64, device=dev),
                 torch.zeros(3, dtype=torch.int32, device=dev))
        stacks = tuple(getattr(self, n) for n in self.slot_params)
        actions = []
        for _step in range(self.layer):
            with pctx.whole_draws():     # (3,): one draw for the batch
                noise = (None if gen is None else stochastic.sample_gumbel(
                    policy_mean.shape, gen, policy_mean.dtype))
            args = (*carry, x, policy_mean, noise, valid, streaming, *stacks)
            out = (stochastic.checkpoint(self._slot, *args)
                   if stochastic.remat_active() else self._slot(*args))
            carry, action = out[:4], out[4]
            actions.append(action)
        return carry[0], torch.stack(actions).to(torch.int32), carry[3]

    def forward(self, x, valid=None, streaming: bool = False):
        # the JAX package's kernel gate: eval, not streaming, no mini-HC;
        # a batch sharded over ranks takes the keyed scan, whose batch
        # means sum over the shards
        if (not stochastic.eval_route() or pctx.batch_axis() is not None
                or (self.mini_hc and not streaming)):
            xs, actions, jstat = self._train_scan(x, valid, streaming)
            stochastic.add_jstat(jstat)
            return self._mlp_tail(xs), {"jstat": jstat, "actions": actions}
        if streaming:
            return self._forward_streaming(x, valid)
        b, ctx, d = x.shape
        sampled = self._sampled(masked_mean(x, valid, dim=1)[:, 0])
        w = self.scan_weights()
        xk, actions, jstat = K.fused_sheath_scan(
            x.reshape(b * ctx, d).contiguous(), b,
            None if valid is None else valid.contiguous(), w["mem0"],
            sampled, w["jump_s"], {k: w[k] for k in K.WEIGHT_NAMES},
            self.layer, self.thresh)
        x = self._mlp_tail(xk.reshape(b, ctx, d))
        return x, {"jstat": jstat, "actions": actions}

    def _forward_streaming(self, x, valid):
        if valid is None:
            n = torch.arange(1, x.shape[1] + 1, dtype=torch.float32,
                             device=x.device)[None, :, None]
            m = None
        else:
            m = valid.to(torch.float32)[..., None]
            n = torch.clamp(torch.cumsum(m, dim=1), min=1.0)

        def causal_mean(step, x_new, active):
            f32 = x_new.to(torch.float32)
            s = torch.cumsum(f32 if m is None else f32 * m, dim=1)
            return (s / n).to(x_new.dtype)

        xs, actions, jstat = self._stream_scan(
            x, self._sampled(x[:, 0]), causal_mean)
        x = self._mlp_tail(xs.to(x.dtype))
        return x, {"jstat": jstat, "actions": actions}

    def init_stream_state(self, batch: int, device=None) -> dict:
        """The zero state of ``stream_step``: per scan step the running
        f32 sums (L, B, D) of its x_new, the positions seen (a host int:
        every caller steps once a position), and the jump actions (L,)
        decided at position 0."""
        dev = device if device is not None else self.mkey.device
        return {"sums": torch.zeros(self.layer, batch, self.dims,
                                    dtype=torch.float32, device=dev),
                "count": 0,
                "actions": torch.zeros(self.layer, dtype=torch.int32,
                                       device=dev)}

    @staticmethod
    def pin_actions(states) -> None:
        """Read the position-0 actions of stream states to the host, in
        one read for all of them: the steps after position 0 replay them
        there (``replay``)."""
        states = [st for st in states if "replay" not in st]
        if states:
            got = torch.stack([st["actions"] for st in states]).tolist()
            for st, acts in zip(states, got):
                st["replay"] = tuple(acts)

    def stream_step(self, x_t, state: dict):
        """One position (B, 1, D) of the streaming scan against ``state``
        (updated in place and returned): the causal mean of scan step s
        is its running f32 sum over the positions so far divided by their
        count, as ``forward(streaming=True)`` divides its cumulative
        sums; the jump actions are decided on the device at position 0
        (from its policy and potential), then replayed from the host
        (read once, ``pin_actions``).  Equals ``forward(prefix,
        streaming=True)[0][:, -1:]`` by induction."""
        count = state["count"]
        sums = state["sums"]
        n = torch.full((1, 1), count + 1, dtype=torch.float32,
                       device=sums.device)

        def running_mean(step, x_new, active):
            row = sums[step] + x_new[:, 0].to(torch.float32)
            sums[step] = row if active is None else torch.where(
                active, row, sums[step])
            return (row / n)[:, None].to(x_new.dtype)

        if count == 0:
            xs, state["actions"], _ = self._stream_scan(
                x_t, self._sampled(x_t[:, 0]), running_mean)
        else:
            self.pin_actions([state])
            xs = self._replay_scan(x_t, state["replay"], running_mean)
        state["count"] = count + 1
        return self._mlp_tail(xs.to(x_t.dtype)), state
