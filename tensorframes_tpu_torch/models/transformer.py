"""Decoder-only transformer LM, on one device or on a mesh.

The port's counterpart of ``tensorframes_tpu/models/transformer.py``:
pre-norm blocks with RMSNorm, rotary positions (half-split), multi-head
causal attention and a tanh-GELU FFN (or a Switch top-1 MoE, with
``num_experts > 0``), weights in the JAX package's layouts (``wq``
``[D, H, Dh]``, ``wo`` ``[H, Dh, D]``, ``w1`` ``[D, F]``, ``head``
``[D, V]``; a MoE layer's ``moe.router`` ``[D, E]``, ``moe.w1``
``[E, D, F]``, ``moe.w2`` ``[E, F, D]``). Full-sequence scoring
(:meth:`TransformerLM.apply`, :meth:`TransformerLM.loss`) runs attention
through :func:`~tensorframes_tpu_torch.ops.flash_attention` (the CUDA
kernel on the card); the KV-cache forward of decoding keeps plain softmax
attention, as the JAX package does. The training steps (adam with
optax's defaults) differentiate the same forward: on the card,
attention's gradients come from the backward kernel.

The mesh paths take a :class:`~tensorframes_tpu_torch.parallel.DeviceMesh`
with any of the JAX package's axes: data (token rows), model (Megatron
tensor parallelism: heads, the FFN's hidden dim and the vocab), seq (ring
attention) and expert (the MoE's experts), and a pipe axis for the GPipe
step. The JAX package gets them from GSPMD; the port's single controller
computes each shard's part on that shard's device and sums the partial
outputs of the model shards itself (see ``models/_mesh.py``). Work that a
mesh axis does not split runs once per distinct shard of the axes that
split it, never once per slot.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch._subclasses.fake_tensor import is_fake

from ..device import resolve_device
from ..ops.flash_attention import flash_attention
from ._mesh import Access, Layout, Placement

__all__ = ["TransformerConfig", "TransformerLM", "params_from_jax",
           "pipelined_params_from_jax", "adam_init", "adam_update",
           "as_mesh"]


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 6
    d_ff: int = 2048
    rope_base: float = 10000.0
    dtype: torch.dtype = torch.float32
    # MoE: > 0 replaces every layer's dense FFN with a Switch top-1 MoE of
    # this many experts (expert-parallel over a mesh axis when given)
    num_experts: int = 0
    expert_capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads


def _rope(x: torch.Tensor, positions: torch.Tensor,
          base: float) -> torch.Tensor:
    """Rotary position embedding, half-split. x: [B, S, H, D], positions:
    [S]. Angles in f32; cos and sin cast to ``x.dtype`` before use."""
    half = x.shape[-1] // 2
    freqs = base ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[:, None].to(torch.float32) * freqs  # [S, half]
    cos = torch.cos(angles)[None, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[None, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _rms_norm(x: torch.Tensor, scale: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32, cast back to ``x.dtype``, then times ``scale``."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def _qkv(lp: Mapping[str, torch.Tensor], x: torch.Tensor,
         positions: torch.Tensor, base: float):
    """A block's rotary q and k and its v for ``x`` [B, S, D]."""
    h = _rms_norm(x, lp["ln1"])
    q = torch.einsum("bsd,dhk->bshk", h, lp["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, lp["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, lp["wv"])
    return _rope(q, positions, base), _rope(k, positions, base), v


def _dense_finish(lp: Mapping[str, torch.Tensor], x: torch.Tensor,
                  attn: torch.Tensor) -> torch.Tensor:
    """A dense block after its attention: the out-projection, then the
    FFN, each with its residual."""
    x = x + torch.einsum("bshk,hkd->bsd", attn, lp["wo"])
    h = _rms_norm(x, lp["ln2"])
    return x + _gelu(h @ lp["w1"]) @ lp["w2"]


def as_mesh(mesh):
    """``mesh`` as a :class:`~tensorframes_tpu_torch.parallel.DeviceMesh`:
    ``None`` stays ``None``, a list or tuple of devices becomes a one-axis
    ``data`` mesh, a ``DeviceMesh`` is taken as it is; anything else
    raises ``TypeError``."""
    from ..parallel.mesh import DeviceMesh

    if mesh is None or isinstance(mesh, DeviceMesh):
        return mesh
    if isinstance(mesh, (list, tuple)):
        arr = np.empty(len(mesh), dtype=object)
        arr[:] = [torch.device(d) for d in mesh]
        return DeviceMesh(arr, ("data",))
    raise TypeError(
        f"a mesh must be None, a parallel.DeviceMesh or a list of "
        f"devices, got {type(mesh).__module__}.{type(mesh).__name__}")


# optax.adam's defaults; torch.optim.Adam's update rule
ADAM_B1, ADAM_B2, ADAM_EPS, ADAM_EPS_ROOT = 0.9, 0.999, 1e-8, 0.0


def adam_init(params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Adam's state for ``params``: the step count (an int64 scalar on the
    parameters' device) and zero first and second moments."""
    first = next(iter(params.values()))
    return {"count": torch.zeros((), dtype=torch.int64, device=first.device),
            "mu": {k: torch.zeros_like(p) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p) for k, p in params.items()}}


@torch.no_grad()
def adam_update(params: Dict[str, torch.Tensor], grads: Mapping[str, Any],
                opt: Dict[str, Any], learning_rate: float) -> None:
    """One adam step, as ``optax.adam(learning_rate)`` computes it:
    ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``, bias-corrected
    by ``1 - b^t``, ``p -= lr * mu_hat / (sqrt(nu_hat + eps_root) + eps)``.
    Updates ``params`` and ``opt`` in place (the JAX step donates them)."""
    opt["count"] += 1
    t = int(opt["count"])
    c1, c2 = 1.0 - ADAM_B1 ** t, 1.0 - ADAM_B2 ** t
    for k, p in params.items():
        g = grads[k]
        mu, nu = opt["mu"][k], opt["nu"][k]
        mu.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
        nu.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
        denom = (nu / c2).add_(ADAM_EPS_ROOT).sqrt_().add_(ADAM_EPS)
        p.sub_(learning_rate * (mu / c1) / denom)


def _named_args_fn(kw_fn, names):
    """Build a positional function whose parameter names are ``names`` —
    the engine derives computation inputs from parameter names."""
    args = ", ".join(names)
    kwargs = ", ".join(f"{n!r}: {n}" for n in names)
    ns = {"_kw_fn": kw_fn}
    exec(f"def _f({args}):\n    return _kw_fn(**{{{kwargs}}})\n", ns)
    return ns["_f"]


def _is_abstract(t: torch.Tensor) -> bool:
    """A tensor with no data: meta, or fake during capture's probes."""
    return t.device.type == "meta" or is_fake(t)


def _content_seed(seed: int, toks: torch.Tensor) -> int:
    """Fold a block's token content into ``seed`` (uint32 arithmetic, the
    mix of the JAX package's ``generate_via_frame``): blocks with other
    content draw other streams, byte-identical blocks the same one."""
    t = toks.detach().cpu().numpy().astype(np.uint64).ravel()
    idx = np.arange(t.size, dtype=np.uint64)
    mask = np.uint64(0xFFFFFFFF)
    w = (idx * np.uint64(2654435761) + np.uint64(1)) & mask
    mix = int(np.sum((t & mask) * w & mask, dtype=np.uint64) & mask)
    return (seed * 0x9E3779B97F4A7C15 + mix) % (1 << 63)


class _SwitchFFN(nn.Module):
    """A MoE layer's parameters: ``router`` [D, E] (always f32), ``w1``
    [E, D, F] and ``w2`` [E, F, D] in the model's dtype."""

    def __init__(self, c: TransformerConfig, device, dtype):
        super().__init__()
        D, E, Fd = c.d_model, c.num_experts, c.d_ff
        self.router = nn.Parameter(torch.empty(D, E, device=device,
                                               dtype=torch.float32))
        self.w1 = nn.Parameter(torch.empty(E, D, Fd, device=device,
                                           dtype=dtype))
        self.w2 = nn.Parameter(torch.empty(E, Fd, D, device=device,
                                           dtype=dtype))


class _Block(nn.Module):
    def __init__(self, c: TransformerConfig, device, dtype):
        super().__init__()
        D, H, Dh, Fd = c.d_model, c.n_heads, c.head_dim, c.d_ff
        kw = {"device": device, "dtype": dtype}
        self.capacity_factor = c.expert_capacity_factor
        self.ln1 = nn.Parameter(torch.ones(D, **kw))
        self.wq = nn.Parameter(torch.empty(D, H, Dh, **kw))
        self.wk = nn.Parameter(torch.empty(D, H, Dh, **kw))
        self.wv = nn.Parameter(torch.empty(D, H, Dh, **kw))
        self.wo = nn.Parameter(torch.empty(H, Dh, D, **kw))
        self.ln2 = nn.Parameter(torch.ones(D, **kw))
        if c.num_experts > 0:
            self.moe = _SwitchFFN(c, device, dtype)
        else:
            self.moe = None
            self.w1 = nn.Parameter(torch.empty(D, Fd, **kw))
            self.w2 = nn.Parameter(torch.empty(Fd, D, **kw))

    def _lp(self) -> Dict[str, torch.Tensor]:
        names = ("ln1", "wq", "wk", "wv", "wo", "ln2") + \
            (() if self.moe is not None else ("w1", "w2"))
        return {n: getattr(self, n) for n in names}

    def qkv(self, x: torch.Tensor, positions: torch.Tensor, base: float):
        return _qkv(self._lp(), x, positions, base)

    def finish(self, x: torch.Tensor, attn: torch.Tensor
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``(x, aux)`` after the attention: ``aux`` is the MoE layer's
        load-balance term, ``None`` for a dense layer."""
        if self.moe is None:
            return _dense_finish(self._lp(), x, attn), None
        from ..parallel.moe import switch_ffn

        x = x + torch.einsum("bshk,hkd->bsd", attn, self.wo)
        h = _rms_norm(x, self.ln2)
        B, S, D = h.shape
        y, aux = switch_ffn(h.reshape(B * S, D),
                            {"router": self.moe.router, "w1": self.moe.w1,
                             "w2": self.moe.w2},
                            capacity_factor=self.capacity_factor)
        return x + y.reshape(B, S, D), aux


Cache = Dict[str, List[Dict[str, torch.Tensor]]]

_LAYER_NAMES = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w1", "w2")


class _MeshStep:
    """A mesh train step: ``state, loss = step(state, tokens, targets)``.

    ``state`` is ``{"params": ..., "opt": {"count", "mu", "nu"}}`` with
    every parameter held as its slices and copies (``models/_mesh.py``);
    ``mu`` and ``nu`` follow their parameter. :meth:`gather` returns the
    global state (every tensor whole, on one device; the checkpoint form)
    and :meth:`place` places a global state again."""

    def __init__(self, placement: Placement, loss_fn, learning_rate: float,
                 nest=None, flatten=None):
        self.placement = placement
        self.layout = placement.layout
        self._loss = loss_fn
        self.learning_rate = learning_rate
        self._nest = nest or (lambda d: d)
        self._flatten = flatten or (lambda d: d)

    def _grads(self, pieces, tokens, targets):
        acc = Access(self.placement, pieces=pieces, track=True)
        with torch.enable_grad():
            loss = self._loss(acc, torch.as_tensor(tokens),
                              torch.as_tensor(targets))
            grads = torch.autograd.grad(loss, acc.leaves(),
                                        allow_unused=True)
        return loss.detach(), acc.grads(grads)

    def loss_and_grads(self, state, tokens, targets, device=None):
        """``(loss, grads)`` at ``state``'s parameters, the gradients
        gathered whole (``gather``'s form, on ``device``); the state is not
        changed."""
        loss, g = self._grads(self._flatten(state["params"]), tokens,
                              targets)
        device = device if device is not None else self.layout.device()
        return loss, self._nest(self.placement.gather(g, device))

    def __call__(self, state, tokens, targets):
        pieces = self._flatten(state["params"])
        loss, g = self._grads(pieces, tokens, targets)

        def flat(tree):
            return {f"{n}#{j}": t for n, ts in tree.items()
                    for j, t in enumerate(ts)}

        opt = state["opt"]
        adam_update(flat(pieces), flat(g),
                    {"count": opt["count"],
                     "mu": flat(self._flatten(opt["mu"])),
                     "nu": flat(self._flatten(opt["nu"]))},
                    self.learning_rate)
        return state, loss

    def init(self, params: Mapping[str, torch.Tensor],
             dtypes: Mapping[str, torch.dtype]) -> Dict:
        pieces = self.placement.place(params, dtypes)
        return {"params": self._nest(pieces),
                "opt": {"count": torch.zeros((), dtype=torch.int64,
                                             device=self.layout.device()),
                        "mu": self._nest(self.placement.zeros_like(pieces)),
                        "nu": self._nest(self.placement.zeros_like(pieces))}}

    def gather(self, state, device=None) -> Dict:
        """The global state: ``{"params": {name: tensor}, "opt": {"count",
        "mu", "nu"}}`` on ``device`` (the mesh's first device if
        ``None``)."""
        device = device if device is not None else self.layout.device()
        pl = self.placement

        def whole(tree):
            return self._nest(pl.gather(self._flatten(tree), device))

        opt = state["opt"]
        return {"params": whole(state["params"]),
                "opt": {"count": opt["count"].to(device),
                        "mu": whole(opt["mu"]), "nu": whole(opt["nu"])}}

    def place(self, state) -> Dict:
        """A global state (:meth:`gather`'s form) placed on the mesh."""
        pl = self.placement

        def placed(tree):
            return self._nest(pl.place(self._flatten(tree)))

        opt = state["opt"]
        return {"params": placed(state["params"]),
                "opt": {"count": torch.as_tensor(opt["count"]).to(
                    self.layout.device(), torch.int64),
                        "mu": placed(opt["mu"]), "nu": placed(opt["nu"])}}


class TransformerLM(nn.Module):
    """Causal LM: tokens [B, S] (int) -> logits [B, S, vocab].

    ``device``: where the weights live and the model runs; ``None`` follows
    the package default (``cuda``, raising without a GPU). The weights are
    drawn as the JAX package draws them (normal, scaled by
    ``sqrt(1/fan_in)``; ``embed`` also by ``sqrt(d_model)``; a MoE layer's
    router in f32) from ``generator`` (a CPU ``torch.Generator``; seed 0
    if ``None``), so they do not equal ``jax.random``'s; carry JAX weights
    over with :func:`params_from_jax` and ``load_state_dict``.

    The module's parameters do not require grad: scoring and decoding
    build no graph. Training runs on a state of its own
    (:meth:`make_sharded_train_step`, :meth:`make_pipelined_train_step`).
    """

    def __init__(self, config: TransformerConfig = TransformerConfig(),
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = self.config = config
        device = resolve_device(device)
        kw = {"device": device, "dtype": c.dtype}
        D, V = c.d_model, c.vocab_size
        self.embed = nn.Parameter(torch.empty(V, D, **kw))
        self.layers = nn.ModuleList(_Block(c, device, c.dtype)
                                    for _ in range(c.n_layers))
        self.ln_f = nn.Parameter(torch.ones(D, **kw))
        self.head = nn.Parameter(torch.empty(D, V, **kw))
        self._init_weights(generator)
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        """Where the weights are (and the model runs)."""
        return self.embed.device

    @torch.no_grad()
    def _init_weights(self, generator: Optional[torch.Generator]) -> None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        c = self.config

        def dense(p: torch.Tensor, fan_in: int, extra: float = 1.0):
            w = torch.randn(p.shape, generator=generator) \
                * (math.sqrt(1.0 / fan_in) * extra)
            p.copy_(w)

        for lp in self.layers:
            for name in ("wq", "wk", "wv", "wo"):
                dense(getattr(lp, name), c.d_model)
            if lp.moe is not None:
                dense(lp.moe.router, c.d_model)
                dense(lp.moe.w1, c.d_model)
                dense(lp.moe.w2, c.d_ff)
            else:
                dense(lp.w1, c.d_model)
                dense(lp.w2, c.d_ff)
        dense(self.embed, c.d_model, math.sqrt(c.d_model))
        dense(self.head, c.d_model)

    # -- forward ------------------------------------------------------------
    def apply_with_aux(self, tokens: torch.Tensor, mesh=None,
                       seq_axis: Optional[str] = None,
                       data_axis: Optional[str] = None,
                       model_axis: Optional[str] = None,
                       expert_axis: Optional[str] = None,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Forward pass -> (logits, aux): ``aux`` is the MoE layers'
        load-balance term summed (0 for a dense model). Without a mesh,
        attention is causal flash attention over the whole sequence. With
        ``mesh`` (a ``DeviceMesh``), the module's own weights are placed
        for the call, split as :meth:`param_shardings` says over
        ``model_axis`` and ``expert_axis``, the batch over ``data_axis``
        and the sequence over ``seq_axis`` with ring attention (global
        positions, so rotary phases are right on every shard); logits come
        back whole on the model's device."""
        mesh = as_mesh(mesh)
        tokens = torch.as_tensor(tokens)
        if mesh is not None:
            acc = self._own_access(mesh, data_axis, model_axis, seq_axis,
                                   expert_axis)
            heads, aux = self._mesh_apply(acc, tokens)
            return self._gather_logits(heads, acc.placement.layout), \
                aux.to(self.device)
        tokens = tokens.to(self.device)
        x = self.embed[tokens]  # [B, S, D]
        positions = torch.arange(tokens.shape[1], device=self.device)
        aux_total = torch.zeros((), device=self.device)
        for lp in self.layers:
            q, k, v = lp.qkv(x, positions, self.config.rope_base)
            x, aux = lp.finish(x, flash_attention(q, k, v, causal=True))
            if aux is not None:
                aux_total = aux_total + aux
        x = _rms_norm(x, self.ln_f)
        return x @ self.head, aux_total

    def apply(self, tokens, **kw) -> torch.Tensor:
        """Logits ``[B, S, vocab]`` for ``tokens`` ``[B, S]``. (Given a
        callable instead, this is ``nn.Module.apply``.)"""
        if callable(tokens):
            return super().apply(tokens)
        return self.forward(tokens, **kw)

    def forward(self, tokens, with_aux: bool = False, **kw):
        out = self.apply_with_aux(tokens, **kw)
        return out if with_aux else out[0]

    @staticmethod
    def _xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        ll = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
        return -torch.mean(ll)

    def loss(self, tokens: torch.Tensor, targets: torch.Tensor,
             **apply_kw) -> torch.Tensor:
        """Mean next-token cross-entropy (+ the weighted MoE aux when
        experts are on); ``targets[b, s]`` is the label for position ``s``
        (the caller shifts)."""
        mesh = as_mesh(apply_kw.pop("mesh", None))
        if mesh is not None:
            acc = self._own_access(mesh, **apply_kw)
            return self._mesh_apply(acc, torch.as_tensor(tokens),
                                    torch.as_tensor(targets)).to(self.device)
        logits, aux = self.apply_with_aux(tokens, **apply_kw)
        targets = torch.as_tensor(targets).to(self.device)
        return self._xent(logits, targets) \
            + self.config.aux_loss_weight * aux

    # -- the mesh forward ------------------------------------------------------
    def _own_access(self, mesh, data_axis=None, model_axis=None,
                    seq_axis=None, expert_axis=None) -> Access:
        """The module's own weights, sliced for a forward on ``mesh``."""
        layout = Layout(mesh, d=data_axis, m=model_axis, s=seq_axis,
                        e=expert_axis)
        return Access(Placement(layout, self._param_specs()),
                      params=dict(self.named_parameters()))

    def _param_specs(self) -> Dict[str, Tuple[Tuple[int, str], ...]]:
        """The split of every parameter, by role (``m`` model, ``e``
        expert): the JAX package's ``param_shardings``."""
        specs = {"embed": (), "ln_f": (), "head": ((1, "m"),)}
        for i, lp in enumerate(self.layers):
            pre = f"layers.{i}."
            specs.update({pre + "ln1": (), pre + "ln2": (),
                          pre + "wq": ((1, "m"),), pre + "wk": ((1, "m"),),
                          pre + "wv": ((1, "m"),), pre + "wo": ((0, "m"),)})
            if lp.moe is not None:
                specs.update({pre + "moe.router": (),
                              pre + "moe.w1": ((0, "e"), (2, "m")),
                              pre + "moe.w2": ((0, "e"), (1, "m"))})
            else:
                specs.update({pre + "w1": ((1, "m"),),
                              pre + "w2": ((0, "m"),)})
        return specs

    def param_shardings(self, mesh, model_axis: Optional[str] = "model",
                        expert_axis: Optional[str] = None
                        ) -> Dict[str, Tuple[Optional[str], ...]]:
        """Megatron-style tensor-parallel placement over ``model_axis``;
        expert weights split over ``expert_axis`` when MoE is on. For each
        parameter (by its state-dict name), the mesh axis each of its dims
        is split over, or ``None``: the JAX package's ``PartitionSpec``.
        The mesh paths hold each parameter as those slices."""
        as_mesh(mesh)
        axes = {"m": model_axis, "e": expert_axis}
        shapes = {k: p.dim() for k, p in self.named_parameters()}
        out = {}
        for name, spec in self._param_specs().items():
            dims: List[Optional[str]] = [None] * shapes[name]
            for dim, role in spec:
                dims[dim] = axes[role]
            out[name] = tuple(dims)
        return out

    def _mesh_apply(self, acc: Access, tokens: torch.Tensor,
                    targets: Optional[torch.Tensor] = None):
        """The forward over the mesh of ``acc``'s layout: each token shard
        (data d, seq s) on its device, each model shard's heads, FFN
        columns and vocab columns on its own. Returns ``(head outputs by
        (d, s, m), aux)``, or with ``targets`` the loss: the sum of every
        shard's token losses over B·S, plus the weighted aux."""
        c = self.config
        L = acc.placement.layout
        dp, sp, tp = L.size("d"), L.size("s"), L.size("m")
        B, S = tokens.shape
        for what, size, n in (("batch", B, dp), ("sequence", S, sp),
                              ("heads", c.n_heads, tp),
                              ("vocab", c.vocab_size, tp)):
            if size % n:
                raise ValueError(f"the {what} ({size}) does not split over "
                                 f"{n} shards")
        Bl, Sl = B // dp, S // sp
        xs = {}
        for d in range(dp):
            for s in range(sp):
                tok = tokens[d * Bl:(d + 1) * Bl, s * Sl:(s + 1) * Sl]
                xs[d, s] = acc.get("embed", d=d, s=s)[
                    tok.to(L.device(d=d, s=s))]
        aux = None
        for i in range(c.n_layers):
            xs, a = self._mesh_block(acc, f"layers.{i}.", xs, Sl)
            if a is not None:
                aux = a if aux is None else aux + a
        if aux is None:
            aux = torch.zeros((), device=L.device())
        heads = {}
        for (d, s), x in xs.items():
            h = _rms_norm(x, acc.get("ln_f", d=d, s=s))
            for m in range(tp):
                heads[d, s, m] = h.to(L.device(d=d, s=s, m=m)) \
                    @ acc.get("head", d=d, s=s, m=m)
        if targets is None:
            return heads, aux
        dev0 = L.device()
        total = None
        for d, s in xs:
            tgt = targets[d * Bl:(d + 1) * Bl, s * Sl:(s + 1) * Sl]
            nll = self._shard_nll([heads[d, s, m] for m in range(tp)], tgt,
                                  L.device(d=d, s=s)).to(dev0)
            total = nll if total is None else total + nll
        return total / (B * S) + c.aux_loss_weight * aux

    @staticmethod
    def _shard_nll(parts: List[torch.Tensor], targets: torch.Tensor,
                   device: torch.device) -> torch.Tensor:
        """The summed cross-entropy of one token shard whose logits are
        split over the vocab (``parts[m]``, model shard m's columns): the
        log-softmax's max and sum of exponentials meet across the shards,
        and each target's logit comes from the shard that holds it."""
        lfs = [p.to(torch.float32) for p in parts]
        top = None
        for lf in lfs:
            mx = lf.detach().amax(dim=-1).to(device)
            top = mx if top is None else torch.maximum(top, mx)
        total, picked = None, None
        Vl = lfs[0].shape[-1]
        for m, lf in enumerate(lfs):
            e = torch.exp(lf - top.to(lf.device)[..., None]).sum(dim=-1)
            t = targets.to(lf.device).long() - m * Vl
            inside = (t >= 0) & (t < Vl)
            g = torch.gather(lf, -1, t.clamp(0, Vl - 1)[..., None])[..., 0]
            g = torch.where(inside, g, 0.0).to(device)
            e = e.to(device)
            total = e if total is None else total + e
            picked = g if picked is None else picked + g
        return (top + torch.log(total) - picked).sum()

    def _mesh_block(self, acc: Access, pre: str, xs: Dict, Sl: int):
        """One block over every token shard: ``(xs, aux)``."""
        c = self.config
        L = acc.placement.layout
        tp = L.size("m")
        q, k, v = {}, {}, {}
        for (d, s), x in xs.items():
            h = _rms_norm(x, acc.get(pre + "ln1", d=d, s=s))
            for m in range(tp):
                dev = L.device(d=d, s=s, m=m)
                lp = {n: acc.get(pre + n, d=d, s=s, m=m)
                      for n in ("wq", "wk", "wv")}
                hm = h.to(dev)
                pos = torch.arange(s * Sl, (s + 1) * Sl, device=dev)
                q[d, s, m] = _rope(torch.einsum("bsd,dhk->bshk", hm,
                                                lp["wq"]), pos, c.rope_base)
                k[d, s, m] = _rope(torch.einsum("bsd,dhk->bshk", hm,
                                                lp["wk"]), pos, c.rope_base)
                v[d, s, m] = torch.einsum("bsd,dhk->bshk", hm, lp["wv"])
        attn = self._mesh_attention(q, k, v, L)
        out = {}
        for (d, s), x in xs.items():
            o = None
            for m in range(tp):
                part = torch.einsum("bshk,hkd->bsd", attn[d, s, m],
                                    acc.get(pre + "wo", d=d, s=s, m=m))
                part = part.to(x.device)
                o = part if o is None else o + part
            out[d, s] = x + o
        hs = {ds: _rms_norm(x, acc.get(pre + "ln2", d=ds[0], s=ds[1]))
              for ds, x in out.items()}
        if c.num_experts > 0:
            ys, aux = self._mesh_moe(acc, pre, hs, Sl)
            return {ds: out[ds] + ys[ds] for ds in out}, aux
        for (d, s), h in hs.items():
            y = None
            for m in range(tp):
                w1 = acc.get(pre + "w1", d=d, s=s, m=m)
                w2 = acc.get(pre + "w2", d=d, s=s, m=m)
                part = (_gelu(h.to(w1.device) @ w1) @ w2).to(h.device)
                y = part if y is None else y + part
            out[d, s] = out[d, s] + y
        return out, None

    def _mesh_attention(self, q: Dict, k: Dict, v: Dict, L: Layout) -> Dict:
        """Causal attention of every (d, s, m) part: ring attention over
        the seq shards of each (d, m) when the layout has a seq axis, else
        the flash-attention kernel on each part's heads."""
        if L.axes["s"] is None:
            return {key: flash_attention(q[key], k[key], v[key], causal=True)
                    for key in q}
        from ..parallel.ring import ring_attention_parts

        sp = L.size("s")
        rings = {}
        for d, _, m in q:
            if (d, m) in rings:
                continue
            keys = [(d, s, m) for s in range(sp)]
            rings[d, m] = ([q[x] for x in keys], [k[x] for x in keys],
                           [v[x] for x in keys],
                           [L.device(d=d, s=s, m=m) for s in range(sp)])
        scale = float(1.0 / np.sqrt(self.config.head_dim))
        outs = ring_attention_parts(rings, True, scale, L.axes["s"])
        return {(d, s, m): outs[d, m][s] for d, s, m in q}

    def _mesh_moe(self, acc: Access, pre: str, hs: Dict, Sl: int):
        """The Switch FFN of one layer over every token shard, its experts
        split over the expert axis and their hidden dim over the model
        axis. Routing is global (``parallel/moe.py``): a token's index is
        ``b * S + position``, the JAX package's order."""
        from ..parallel.moe import switch_parts

        c = self.config
        L = acc.placement.layout
        ep, tp = L.size("e"), L.size("m")
        for what, size, n in (("experts", c.num_experts, ep),
                              ("d_ff", c.d_ff, tp)):
            if size % n:
                raise ValueError(f"the {what} ({size}) do not split over "
                                 f"{n} shards")
        S = Sl * L.size("s")
        xs, gidx, routers = [], [], []
        for (d, s), h in hs.items():
            Bl = h.shape[0]
            xs.append(h.reshape(Bl * Sl, c.d_model))
            b = torch.arange(d * Bl, (d + 1) * Bl, device=h.device)
            p = torch.arange(s * Sl, (s + 1) * Sl, device=h.device)
            gidx.append((b[:, None] * S + p[None, :]).reshape(-1))
            routers.append(acc.get(pre + "moe.router", d=d, s=s))
        w1s = [[acc.get(pre + "moe.w1", e=j, m=m) for m in range(tp)]
               for j in range(ep)]
        w2s = [[acc.get(pre + "moe.w2", e=j, m=m) for m in range(tp)]
               for j in range(ep)]
        devs = [[L.device(e=j, m=m) for m in range(tp)] for j in range(ep)]
        outs, aux = switch_parts(xs, gidx, routers, w1s, w2s, devs,
                                 c.expert_capacity_factor)
        return {ds: o.reshape(h.shape) for (ds, h), o in
                zip(hs.items(), outs)}, aux

    def _gather_logits(self, heads: Dict, L: Layout) -> torch.Tensor:
        dp, sp, tp = L.size("d"), L.size("s"), L.size("m")
        return torch.cat([torch.cat([torch.cat(
            [heads[d, s, m].to(self.device) for m in range(tp)], dim=-1)
            for s in range(sp)], dim=1) for d in range(dp)], dim=0)

    # -- training -------------------------------------------------------------
    def loss_and_grads(self, params: Mapping[str, torch.Tensor],
                       tokens: torch.Tensor, targets: torch.Tensor
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``(loss, grads)`` of :meth:`loss` at the state dict ``params``
        (this module's names and layouts), by autograd on one device: on
        the card, attention's gradients come from the backward kernel.
        ``params`` are read, never changed; the module's own weights are
        not used."""
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        with torch.enable_grad():
            logits, aux = torch.func.functional_call(
                self, leaves, (tokens,), {"with_aux": True})
            targets = torch.as_tensor(targets).to(logits.device)
            loss = self._xent(logits, targets) \
                + self.config.aux_loss_weight * aux
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        grads = [torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in zip(leaves, grads)]
        return loss.detach(), dict(zip(leaves, grads))

    def _global_params(self, rng, device) -> Dict[str, torch.Tensor]:
        """The global parameters ``init_state`` starts from: ``rng`` a
        state dict (taken as it is, checked against the model's names) or
        a CPU ``torch.Generator`` (drawn as the constructor draws; seed 0
        if ``None``)."""
        if isinstance(rng, Mapping):
            params = {k: torch.as_tensor(v) for k, v in rng.items()}
            missing = set(self.state_dict()) ^ set(params)
            if missing:
                raise KeyError(f"init_state: parameters do not match "
                               f"the model's: {sorted(missing)}")
            return params
        return {k: p.detach() for k, p in TransformerLM(
            self.config, device=device, generator=rng).state_dict().items()}

    def make_sharded_train_step(self, mesh=None, data_axis: str = "data",
                                model_axis: Optional[str] = "model",
                                seq_axis: Optional[str] = None,
                                expert_axis: Optional[str] = None,
                                learning_rate: float = 1e-3):
        """One training step (adam) -> ``(step, init_state)``:
        ``state = init_state(rng)`` then ``state, loss = step(state,
        tokens, targets)``; ``step`` updates the state it is given in
        place and returns it with the loss (a 0-d tensor) of the
        parameters it was given. ``init_state(rng)`` draws the parameters
        as the constructor does from ``rng``, a CPU ``torch.Generator``
        (seed 0 if ``None``), or takes a state dict
        (``params_from_jax(jax_params)``, say) in the config's dtype.

        ``mesh`` ``None`` (or a mesh of one device): the state is ``{"params":
        <state dict>, "opt": <adam state>}`` on this model's device.

        A ``DeviceMesh`` of more devices: token rows split over
        ``data_axis``, the parameters split as :meth:`param_shardings`
        says over ``model_axis`` (and ``expert_axis`` for the experts), the
        sequence over ``seq_axis`` with ring attention. Each axis acts only
        when the mesh has it. The loss is the global mean over B·S tokens;
        each parameter's gradient is summed over its use sites in shard
        order, then adam updates each held copy once.
        ``step.gather(state)`` gives the global state (for checkpoints and
        comparisons), ``step.place(global_state)`` places one again, and
        ``step.loss_and_grads(state, tokens, targets)`` the loss and the
        gathered gradients without a step.
        """
        mesh = as_mesh(mesh)
        if mesh is not None and mesh.num_devices > 1:
            axes = mesh.axis_names
            layout = Layout(
                mesh, d=data_axis if data_axis in axes else None,
                m=model_axis if model_axis in axes else None,
                s=seq_axis if seq_axis in axes else None,
                e=expert_axis if expert_axis in axes else None)
            step = _MeshStep(Placement(layout, self._param_specs()),
                             lambda acc, tok, tgt: self._mesh_apply(
                                 acc, tok, tgt), learning_rate)
            dtypes = {k: p.dtype for k, p in self.named_parameters()}

            def init_state(rng=None):
                return step.init(self._global_params(rng, "cpu"), dtypes)

            return step, init_state

        device = self.device
        dtypes = {k: p.dtype for k, p in self.named_parameters()}

        def init_state(rng=None):
            params = {k: v.to(device, dtypes[k]).clone() for k, v in
                      self._global_params(rng, device).items()}
            return {"params": params, "opt": adam_init(params)}

        def step(state, tokens, targets):
            tokens = torch.as_tensor(tokens).to(device)
            loss, grads = self.loss_and_grads(state["params"], tokens,
                                              targets)
            adam_update(state["params"], grads, state["opt"], learning_rate)
            return state, loss

        return step, init_state

    # -- pipeline parallelism ---------------------------------------------------
    def stacked_layer_params(self, params: Mapping[str, torch.Tensor]
                             ) -> Dict[str, torch.Tensor]:
        """Stack the per-layer tensors of the state dict ``params`` into
        leading-dim-``L`` tensors by layer name (``"wq"``: ``[L, D, H,
        Dh]``), the layout :func:`~tensorframes_tpu_torch.parallel.
        pipeline.pipeline_apply` wants."""
        names = [n for n in _LAYER_NAMES
                 if f"layers.0.{n}" in params]
        return {n: torch.stack([torch.as_tensor(params[f"layers.{i}.{n}"])
                                for i in range(self.config.n_layers)])
                for n in names}

    def make_pipelined_train_step(self, mesh, pipe_axis: str = "pipe",
                                  data_axis: str = "data",
                                  num_microbatches: Optional[int] = None,
                                  learning_rate: float = 1e-3):
        """Training step with the layer stack run as a GPipe pipeline over
        ``pipe_axis`` (one or more layers per stage; ``n_layers`` must be a
        multiple of the axis size) -> ``(step, init_state)``. Embed, final
        norm and head are replicated and run outside the pipeline, on the
        first stage's device over the whole batch; each microbatch's rows
        are split over ``data_axis`` inside the schedule
        (``parallel/pipeline.py``, bubble ticks skipped).

        The state keeps ``{"outer": {"embed", "ln_f", "head"}, "stages":
        {name: [one [1, per_stage, ...] slice a stage]}}``: stage p's slice
        of the stage-major ``[P, per_stage, ...]`` layer stack lives on
        pipe shard p's device, and adam tracks it there. ``init_state``
        takes a CPU generator, a state dict or a global pipelined dict
        (``{"outer", "stages"}``, :func:`pipelined_params_from_jax`).
        ``step.gather``/``step.place`` convert as for
        :meth:`make_sharded_train_step`; a checkpoint of either layout
        restores only into its own. Dense models only: the MoE aux loss
        cannot cross the pipeline boundary."""
        from ..parallel.pipeline import pipeline_parts

        c = self.config
        if c.num_experts > 0:
            raise ValueError(
                "make_pipelined_train_step supports dense FFN models only: "
                "the MoE load-balance aux loss would be silently dropped "
                "across the pipeline; use make_sharded_train_step with "
                "expert_axis for MoE")
        mesh = as_mesh(mesh)
        pipe_size = mesh.shape[pipe_axis]
        if c.n_layers % pipe_size:
            raise ValueError(
                f"n_layers={c.n_layers} not divisible by pipe={pipe_size}")
        per_stage = c.n_layers // pipe_size
        M = num_microbatches or pipe_size
        layout = Layout(mesh, p=pipe_axis,
                        d=data_axis if data_axis in mesh.axis_names
                        else None)
        nd = layout.size("d")
        outer = ("embed", "ln_f", "head")
        specs = {f"outer.{n}": () for n in outer}
        specs.update({f"stages.{n}": ((0, "p"),) for n in _LAYER_NAMES})
        placement = Placement(layout, specs)
        devices = [[layout.device(p=p, d=d) for d in range(nd)]
                   for p in range(pipe_size)]

        def stage_fn(sp, act):
            positions = torch.arange(act.shape[1], device=act.device)
            x = act
            for i in range(per_stage):
                lp = {n: a[0, i] for n, a in sp.items()}
                q, k, v = _qkv(lp, x, positions, c.rope_base)
                x = _dense_finish(lp, x, flash_attention(q, k, v,
                                                         causal=True))
            return x

        def loss_fn(acc, tokens, targets):
            dev0 = layout.device()
            x = acc.get("outer.embed", p=0)[tokens.to(dev0)]
            stages = [{n: acc.get(f"stages.{n}", p=p) for n in _LAYER_NAMES}
                      for p in range(pipe_size)]
            out = pipeline_parts(stage_fn, stages, x, devices, M)
            h = _rms_norm(out, acc.get("outer.ln_f", p=0))
            logits = h @ acc.get("outer.head", p=0)
            return self._xent(logits, targets.to(dev0))

        def nest(flat):
            return {"outer": {n: flat[f"outer.{n}"] for n in outer},
                    "stages": {n: flat[f"stages.{n}"] for n in _LAYER_NAMES}}

        def flatten(tree):
            return {**{f"outer.{n}": t for n, t in tree["outer"].items()},
                    **{f"stages.{n}": t for n, t in tree["stages"].items()}}

        step = _MeshStep(placement, loss_fn, learning_rate, nest, flatten)

        dtypes = {n: c.dtype for n in specs}

        def init_state(rng=None):
            if isinstance(rng, Mapping) and set(rng) == {"outer", "stages"}:
                return step.init(flatten(rng), dtypes)
            flat = self._global_params(rng, "cpu")
            stacked = {n: a.reshape((pipe_size, per_stage) + a.shape[1:])
                       for n, a in self.stacked_layer_params(flat).items()}
            return step.init(flatten({"outer": {n: flat[n] for n in outer},
                                      "stages": stacked}), dtypes)

        return step, init_state

    # -- autoregressive decoding (KV cache) ---------------------------------
    def init_cache(self, batch: int, max_len: int) -> Cache:
        """KV cache: per layer ``k``/``v`` of ``[B, max_len, H, Dh]``,
        zeros. :meth:`_forward_cached` writes into it in place."""
        c = self.config

        def zeros():
            return torch.zeros((batch, max_len, c.n_heads, c.head_dim),
                               dtype=c.dtype, device=self.device)

        return {"layers": [{"k": zeros(), "v": zeros()}
                           for _ in range(c.n_layers)]}

    def _block_cached(self, lp: _Block, ck: Dict[str, torch.Tensor],
                      x: torch.Tensor, start: int, positions: torch.Tensor,
                      key_positions: torch.Tensor):
        """One block over ``x`` (``[B, S, D]`` at global ``positions``),
        writing its keys and values into the cache at ``start`` (in place)
        and attending over every cached key with ``key_positions <=
        position``: plain softmax attention in f32, masked with -inf.
        Returns ``(x, cache_entry)``."""
        q, k, v = lp.qkv(x, positions, self.config.rope_base)
        S = x.shape[1]
        kc, vc = ck["k"], ck["v"]
        kc[:, start:start + S] = k
        vc[:, start:start + S] = v
        scores = torch.einsum("bqhk,bthk->bhqt", q.to(torch.float32),
                              kc.to(torch.float32))
        scores = scores * (1.0 / np.sqrt(self.config.head_dim))
        mask = key_positions[None, :] <= positions[:, None]  # [S, T]
        scores = torch.where(mask[None, None], scores, -torch.inf)
        p = torch.softmax(scores, dim=-1)
        attn = torch.einsum("bhqt,bthk->bqhk", p, vc.to(torch.float32))
        return lp.finish(x, attn.to(x.dtype))[0], ck

    def _forward_cached(self, cache: Cache, tokens: torch.Tensor, start: int,
                        max_len: int) -> Tuple[torch.Tensor, Cache]:
        """Cached forward over ``tokens`` (``[B, S]``) written at cache
        offset ``start``: prefill (S = prompt) and decode (S = 1). Returns
        ``(logits [B, S, V], cache)``; the cache is updated in place."""
        S = tokens.shape[1]
        x = self.embed[tokens]
        positions = start + torch.arange(S, device=self.device)
        key_positions = torch.arange(max_len, device=self.device)
        for lp, ck in zip(self.layers, cache["layers"]):
            x, _ = self._block_cached(lp, ck, x, start, positions,
                                      key_positions)
        x = _rms_norm(x, self.ln_f)
        return x @ self.head, cache

    @staticmethod
    def _pick(logits: torch.Tensor, temperature: float,
              rng: Optional[torch.Generator]) -> torch.Tensor:
        """Greedy argmax, or a sample of ``softmax(logits / temperature)``
        by the Gumbel-max rule with uniforms drawn from ``rng`` (on the
        generator's device, then moved)."""
        if temperature > 0:
            u = torch.rand(logits.shape, generator=rng, device=rng.device,
                           dtype=torch.float32).to(logits.device)
            u = u.clamp_min(torch.finfo(torch.float32).tiny)
            return torch.argmax(logits / temperature - torch.log(-torch.log(u)),
                                dim=-1)
        return torch.argmax(logits, dim=-1)

    @torch.no_grad()
    def generate(self, prompt: torch.Tensor, max_new_tokens: int,
                 temperature: float = 0.0,
                 rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """Autoregressive decode: ``prompt`` ``[B, S0]`` ->
        ``[B, S0 + max_new_tokens]`` int32, on the model's device.

        One prefill fills the KV cache for the prompt, then each step emits
        the token it carries (the prefill's pick first) and decodes its
        successor; the last step's successor is discarded, as in the JAX
        package's ``lax.scan``, so greedy outputs match it token for token.
        ``temperature=0`` is greedy; otherwise sampling with ``rng``.
        """
        if temperature > 0 and rng is None:
            raise ValueError("temperature > 0 sampling needs rng")
        prompt = torch.as_tensor(prompt)
        B, S0 = prompt.shape
        if _is_abstract(prompt):  # a shape probe: the result's shape only
            return torch.empty((B, S0 + max_new_tokens), dtype=torch.int32,
                               device=prompt.device)
        prompt = prompt.to(self.device, torch.int32)
        T = S0 + max_new_tokens
        cache = self.init_cache(B, T)
        logits, cache = self._forward_cached(cache, prompt, 0, T)
        tok = self._pick(logits[:, -1].to(torch.float32), temperature, rng)
        toks = []
        for pos in range(S0, T):
            toks.append(tok.to(torch.int32))
            lg, cache = self._forward_cached(cache, toks[-1][:, None], pos, T)
            tok = self._pick(lg[:, -1].to(torch.float32), temperature, rng)
        return torch.cat([prompt] + [t[:, None] for t in toks], dim=1)

    def generate_via_frame(self, df, max_new_tokens: int,
                           prompt_col: str = "prompt",
                           temperature: float = 0.0,
                           rng: Optional[torch.Generator] = None,
                           trim: bool = True):
        """Batch decoding through ``map_blocks``: prompts in a frame column
        (``[S0]`` int cells), completions back as an int32 ``completion``
        column (``[S0 + max_new_tokens]``).

        Sampling (``temperature > 0``) seeds each block's stream from
        ``rng``'s initial seed and the block's token content: blocks with
        other content draw other streams, byte-identical blocks reproduce
        the same completion, and re-running the frame gives the same
        result. The bits differ from the JAX package's (another generator).
        Capture infers the output's shape on abstract tensors and runs no
        forward."""
        def fn_impl(**cols):
            toks = cols[prompt_col].to(torch.int32)
            gen = None
            if rng is not None:
                gen = torch.Generator(device=rng.device)
                if not _is_abstract(toks):
                    gen.manual_seed(_content_seed(rng.initial_seed(), toks))
            out = self.generate(toks, max_new_tokens,
                                temperature=temperature, rng=gen)
            return {"completion": out.to(toks.device)}

        return df.map_blocks(_named_args_fn(fn_impl, [prompt_col]),
                             trim=trim)


def _host(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's parameter pytree (``{"embed", "layers": [{ln1, wq,
    wk, wv, wo, ln2, w1, w2 | moe: {router, w1, w2}}], "ln_f", "head"}``,
    numpy or jax arrays) as a state dict for :class:`TransformerLM`
    (``model.load_state_dict``), on the CPU in the arrays' dtypes. Layouts
    are the same; ``embed`` already carries its ``sqrt(d_model)`` factor
    and is taken as it is."""
    state = {"embed": _host(params["embed"]), "ln_f": _host(params["ln_f"]),
             "head": _host(params["head"])}
    for i, lp in enumerate(params["layers"]):
        for name in ("ln1", "wq", "wk", "wv", "wo", "ln2"):
            state[f"layers.{i}.{name}"] = _host(lp[name])
        if "moe" in lp:
            for name in ("router", "w1", "w2"):
                state[f"layers.{i}.moe.{name}"] = _host(lp["moe"][name])
        else:
            for name in ("w1", "w2"):
                state[f"layers.{i}.{name}"] = _host(lp[name])
    return state


def pipelined_params_from_jax(params: Mapping[str, Any]
                              ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX package's pipelined parameters (``state["params"]`` of its
    ``make_pipelined_train_step``: ``{"outer": {embed, ln_f, head},
    "stages": {ln1, wq, ...}}`` with stage-major ``[P, per_stage, ...]``
    leaves) as the port's global pipelined dict, which the port's
    pipelined ``init_state`` places one stage a pipe shard."""
    return {"outer": {n: _host(a) for n, a in params["outer"].items()},
            "stages": {n: _host(a) for n, a in params["stages"].items()}}
