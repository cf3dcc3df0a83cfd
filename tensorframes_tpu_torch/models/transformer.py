"""Decoder-only transformer LM on one device.

The port's counterpart of ``tensorframes_tpu/models/transformer.py``:
pre-norm blocks with RMSNorm, rotary positions (half-split), multi-head
causal attention and a tanh-GELU FFN, weights in the JAX package's layouts
(``wq`` ``[D, H, Dh]``, ``wo`` ``[H, Dh, D]``, ``w1`` ``[D, F]``, ``head``
``[D, V]``). Full-sequence scoring (:meth:`TransformerLM.apply`,
:meth:`TransformerLM.loss`) runs attention through
:func:`~tensorframes_tpu_torch.ops.flash_attention` (the CUDA kernel on the
card); the KV-cache forward of decoding keeps plain softmax attention, as
the JAX package does. The single-device training step
(:meth:`TransformerLM.make_sharded_train_step`, adam with optax's
defaults) differentiates the same forward: on the card, attention's
gradients come from the backward kernel.

Not here yet: mixture-of-experts layers and the mesh paths (ring, tensor,
sequence and pipeline parallelism, and the pipelined train step); ROADMAP
A item 7b and A12.
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

__all__ = ["TransformerConfig", "TransformerLM", "params_from_jax",
           "adam_init", "adam_update", "mesh_size"]


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 6
    d_ff: int = 2048
    rope_base: float = 10000.0
    dtype: torch.dtype = torch.float32
    # MoE: > 0 replaces every layer's dense FFN with a Switch top-1 MoE in
    # the JAX package; not ported yet (ROADMAP A12)
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


def mesh_size(mesh) -> int:
    """The number of devices of ``mesh``: 1 for ``None``, else the length
    of a list or tuple of devices. The port has no mesh type yet: anything
    else raises ``NotImplementedError`` (ROADMAP A item 7b)."""
    if mesh is None:
        return 1
    if isinstance(mesh, (list, tuple)):
        return len(mesh)
    raise NotImplementedError(
        f"a mesh of type {type(mesh).__name__}: the port takes None or a "
        f"list of devices until ROADMAP A item 7b (parallel) defines its mesh")


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


class _Block(nn.Module):
    def __init__(self, c: TransformerConfig, device, dtype):
        super().__init__()
        D, H, Dh, Fd = c.d_model, c.n_heads, c.head_dim, c.d_ff
        kw = {"device": device, "dtype": dtype}
        self.ln1 = nn.Parameter(torch.ones(D, **kw))
        self.wq = nn.Parameter(torch.empty(D, H, Dh, **kw))
        self.wk = nn.Parameter(torch.empty(D, H, Dh, **kw))
        self.wv = nn.Parameter(torch.empty(D, H, Dh, **kw))
        self.wo = nn.Parameter(torch.empty(H, Dh, D, **kw))
        self.ln2 = nn.Parameter(torch.ones(D, **kw))
        self.w1 = nn.Parameter(torch.empty(D, Fd, **kw))
        self.w2 = nn.Parameter(torch.empty(Fd, D, **kw))

    def qkv(self, x: torch.Tensor, positions: torch.Tensor, base: float):
        h = _rms_norm(x, self.ln1)
        q = torch.einsum("bsd,dhk->bshk", h, self.wq)
        k = torch.einsum("bsd,dhk->bshk", h, self.wk)
        v = torch.einsum("bsd,dhk->bshk", h, self.wv)
        return _rope(q, positions, base), _rope(k, positions, base), v

    def finish(self, x: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
        x = x + torch.einsum("bshk,hkd->bsd", attn, self.wo)
        h = _rms_norm(x, self.ln2)
        return x + _gelu(h @ self.w1) @ self.w2


Cache = Dict[str, List[Dict[str, torch.Tensor]]]


class TransformerLM(nn.Module):
    """Causal LM: tokens [B, S] (int) -> logits [B, S, vocab].

    ``device``: where the weights live and the model runs; ``None`` follows
    the package default (``cuda``, raising without a GPU). The weights are
    drawn as the JAX package draws them (normal, scaled by
    ``sqrt(1/fan_in)``; ``embed`` also by ``sqrt(d_model)``) from
    ``generator`` (a CPU ``torch.Generator``; seed 0 if ``None``), so they
    do not equal ``jax.random``'s; carry JAX weights over with
    :func:`params_from_jax` and ``load_state_dict``.

    The module's parameters do not require grad: scoring and decoding
    build no graph. Training runs on a state of its own
    (:meth:`make_sharded_train_step`), through :meth:`loss_and_grads`.
    """

    def __init__(self, config: TransformerConfig = TransformerConfig(),
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = self.config = config
        if c.num_experts > 0:
            raise NotImplementedError(
                "num_experts > 0 (mixture-of-experts FFN) is not ported yet: "
                "ROADMAP A12 (models) with A item 7b (parallel/moe.py)")
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
            for name in ("wq", "wk", "wv", "wo", "w1"):
                dense(getattr(lp, name), c.d_model)
            dense(lp.w2, c.d_ff)
        dense(self.embed, c.d_model, math.sqrt(c.d_model))
        dense(self.head, c.d_model)

    # -- forward ------------------------------------------------------------
    @staticmethod
    def _no_mesh(**axes) -> None:
        given = [k for k, a in axes.items() if a is not None]
        if given:
            raise NotImplementedError(
                f"{', '.join(given)}: the mesh paths (ring attention, tensor, "
                f"sequence and expert parallelism) are not ported yet: "
                f"ROADMAP A item 7b (parallel) and A12 (models)")

    def apply_with_aux(self, tokens: torch.Tensor, mesh=None,
                       seq_axis: Optional[str] = None,
                       data_axis: Optional[str] = None,
                       model_axis: Optional[str] = None,
                       expert_axis: Optional[str] = None,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Forward pass -> (logits, aux). ``aux`` is the MoE load-balance
        term, 0 for this dense model. Attention is causal flash attention
        over the whole sequence."""
        self._no_mesh(mesh=mesh, seq_axis=seq_axis, data_axis=data_axis,
                      model_axis=model_axis, expert_axis=expert_axis)
        tokens = torch.as_tensor(tokens).to(self.device)
        x = self.embed[tokens]  # [B, S, D]
        positions = torch.arange(tokens.shape[1], device=self.device)
        for lp in self.layers:
            q, k, v = lp.qkv(x, positions, self.config.rope_base)
            x = lp.finish(x, flash_attention(q, k, v, causal=True))
        x = _rms_norm(x, self.ln_f)
        return x @ self.head, torch.zeros((), device=self.device)

    def apply(self, tokens, **kw) -> torch.Tensor:
        """Logits ``[B, S, vocab]`` for ``tokens`` ``[B, S]``. (Given a
        callable instead, this is ``nn.Module.apply``.)"""
        if callable(tokens):
            return super().apply(tokens)
        return self.forward(tokens, **kw)

    def forward(self, tokens, **kw) -> torch.Tensor:
        return self.apply_with_aux(tokens, **kw)[0]

    @staticmethod
    def _xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        ll = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
        return -torch.mean(ll)

    def loss(self, tokens: torch.Tensor, targets: torch.Tensor,
             **apply_kw) -> torch.Tensor:
        """Mean next-token cross-entropy; ``targets[b, s]`` is the label for
        position ``s`` (the caller shifts)."""
        logits, aux = self.apply_with_aux(tokens, **apply_kw)
        targets = torch.as_tensor(targets).to(self.device)
        return self._xent(logits, targets) \
            + self.config.aux_loss_weight * aux

    # -- training (single device) ---------------------------------------------
    def loss_and_grads(self, params: Mapping[str, torch.Tensor],
                       tokens: torch.Tensor, targets: torch.Tensor
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``(loss, grads)`` of :meth:`loss` at the state dict ``params``
        (this module's names and layouts), by autograd: on the card,
        attention's gradients come from the backward kernel. ``params``
        are read, never changed; the module's own weights are not used."""
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        with torch.enable_grad():
            logits = torch.func.functional_call(self, leaves, (tokens,))
            targets = torch.as_tensor(targets).to(logits.device)
            loss = self._xent(logits, targets)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    def make_sharded_train_step(self, mesh=None, data_axis: str = "data",
                                model_axis: Optional[str] = None,
                                seq_axis: Optional[str] = None,
                                expert_axis: Optional[str] = None,
                                learning_rate: float = 1e-3):
        """One training step (adam) -> ``(step, init_state)``:
        ``state = init_state(rng)`` then ``state, loss = step(state,
        tokens, targets)``; ``state`` is ``{"params": <state dict>, "opt":
        <adam state>}`` on this model's device.

        Single device only: ``mesh`` is ``None`` or holds one device, and
        ``data_axis`` is then the whole batch. A mesh of more devices, or a
        ``model_axis``, ``seq_axis`` or ``expert_axis`` (tensor, sequence
        and expert parallelism), raises ``NotImplementedError``: ROADMAP
        A item 7b. (The JAX package's ``model_axis="model"`` acts only when its
        mesh has that axis; here the default is ``None``.)

        ``init_state(rng)`` draws the parameters as the constructor does
        from ``rng``, a CPU ``torch.Generator`` (seed 0 if ``None``), or
        takes a state dict (``params_from_jax(jax_params)``, say) and
        copies it to the device in the config's dtype. ``step`` updates
        the state it is given in place and returns it with the loss (a
        0-d tensor) of the parameters it was given.
        """
        self._no_mesh(model_axis=model_axis, seq_axis=seq_axis,
                      expert_axis=expert_axis)
        if mesh_size(mesh) != 1:
            raise NotImplementedError(
                f"a mesh of {mesh_size(mesh)} devices: the data-parallel "
                f"train step over a mesh is not ported yet: ROADMAP A item 7b "
                f"(parallel)")
        device, dtype = self.device, self.config.dtype

        def init_state(rng=None):
            if isinstance(rng, Mapping):
                params = {k: torch.as_tensor(v).to(device, dtype).clone()
                          for k, v in rng.items()}
                missing = set(self.state_dict()) ^ set(params)
                if missing:
                    raise KeyError(f"init_state: parameters do not match "
                                   f"the model's: {sorted(missing)}")
            else:
                params = {k: p.detach() for k, p in TransformerLM(
                    self.config, device=device,
                    generator=rng).state_dict().items()}
            return {"params": params, "opt": adam_init(params)}

        def step(state, tokens, targets):
            tokens = torch.as_tensor(tokens).to(device)
            loss, grads = self.loss_and_grads(state["params"], tokens,
                                              targets)
            adam_update(state["params"], grads, state["opt"], learning_rate)
            return state, loss

        return step, init_state

    def make_pipelined_train_step(self, *args, **kwargs):
        """The GPipe-pipelined train step runs over a ``pipe`` mesh axis:
        not ported yet (ROADMAP A item 7b)."""
        raise NotImplementedError(
            "make_pipelined_train_step: the pipelined train step over a "
            "mesh is not ported yet: ROADMAP A item 7b (parallel)")

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
        return lp.finish(x, attn.to(x.dtype)), ck

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


def params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's parameter pytree (``{"embed", "layers": [{ln1, wq,
    wk, wv, wo, ln2, w1, w2}], "ln_f", "head"}``, numpy or jax arrays) as a
    state dict for :class:`TransformerLM` (``model.load_state_dict``), on
    the CPU in the arrays' dtypes. Layouts are the same; ``embed`` already
    carries its ``sqrt(d_model)`` factor and is taken as it is."""
    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a))

    state = {"embed": t(params["embed"]), "ln_f": t(params["ln_f"]),
             "head": t(params["head"])}
    for i, lp in enumerate(params["layers"]):
        if "moe" in lp:
            raise NotImplementedError(
                "mixture-of-experts layers are not ported yet: ROADMAP A12")
        for name in ("ln1", "wq", "wk", "wv", "wo", "ln2", "w1", "w2"):
            state[f"layers.{i}.{name}"] = t(lp[name])
    return state
