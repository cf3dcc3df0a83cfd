"""ResNet-50 batch inference over an image-tensor column (BASELINE config 4).

The port's counterpart of ``tensorframes_tpu/models/resnet.py``: a frozen
network mapped over blocks of rows with ``map_blocks(trim=True)``, its
weights closed over as constants. The frame column stays NHWC ``[N, H, W,
3]`` as in the JAX package; inside, the network runs on an NCHW view of it
(channels-last in memory, which cuDNN takes as it is), with inference-mode
batch norm folded to a per-channel affine, so each branch is conv ->
affine -> relu. Convolutions and the pooling use the JAX package's
``"SAME"`` padding: ``total // 2`` before and the rest after, which at
stride 2 over an even size is asymmetric (the stem's 7x7 at 224 pads 2
and 3, each 3x3 stride-2 convolution and the 3x3 max pool 0 and 1), so it
is padded explicitly (zeros before a convolution, -inf before the pool).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .transformer import _is_abstract, _named_args_fn

__all__ = ["ResNet50", "params_from_jax"]

# Stage specification for ResNet-50: (blocks, bottleneck width)
_STAGES: Tuple[Tuple[int, int], ...] = ((3, 64), (4, 128), (6, 256), (3, 512))
_EXPANSION = 4


def _same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, stride: int,
              value: float = 0.0) -> torch.Tensor:
    top, bottom = _same_pad(x.shape[2], k, stride)
    left, right = _same_pad(x.shape[3], k, stride)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """``conv_general_dilated(..., padding="SAME")`` on NCHW ``x`` with an
    OIHW ``w``."""
    k = w.shape[-1]
    if stride == 1 and k % 2 == 1:  # symmetric: the convolution pads
        return F.conv2d(x, w, padding=k // 2)
    return F.conv2d(_pad_same(x, k, stride), w, stride=stride)


class _Affine(nn.Module):
    """Inference-mode batch norm, folded to ``y = x * scale + bias``."""

    def __init__(self, c: int, **kw):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c, **kw))
        self.bias = nn.Parameter(torch.zeros(c, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale[:, None, None] + self.bias[:, None, None]


class _Stem(nn.Module):
    def __init__(self, **kw):
        super().__init__()
        self.conv = nn.Parameter(torch.empty(64, 3, 7, 7, **kw))
        self.bn = _Affine(64, **kw)


class _Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, cout: int, proj: bool, **kw):
        super().__init__()
        self.conv1 = nn.Parameter(torch.empty(width, cin, 1, 1, **kw))
        self.bn1 = _Affine(width, **kw)
        self.conv2 = nn.Parameter(torch.empty(width, width, 3, 3, **kw))
        self.bn2 = _Affine(width, **kw)
        self.conv3 = nn.Parameter(torch.empty(cout, width, 1, 1, **kw))
        self.bn3 = _Affine(cout, **kw)
        if proj:
            self.proj = nn.Parameter(torch.empty(cout, cin, 1, 1, **kw))
            self.proj_bn = _Affine(cout, **kw)

    def forward(self, x: torch.Tensor, stride: int) -> torch.Tensor:
        y = F.relu(self.bn1(_conv(x, self.conv1)))
        y = F.relu(self.bn2(_conv(y, self.conv2, stride)))
        y = self.bn3(_conv(y, self.conv3))
        if hasattr(self, "proj"):
            x = self.proj_bn(_conv(x, self.proj, stride))
        return F.relu(x + y)


class _Head(nn.Module):
    def __init__(self, cin: int, num_classes: int, **kw):
        super().__init__()
        self.w = nn.Parameter(torch.empty(cin, num_classes, **kw))
        self.b = nn.Parameter(torch.zeros(num_classes, **kw))


class ResNet50(nn.Module):
    """Frozen ResNet-50 classifier, ``[N, H, W, 3] -> [N, num_classes]``.

    ``device``: where the weights live and the network runs (``None``: the
    package default, ``cuda``). The weights are drawn as the JAX package
    draws them (He-normal convolutions, identity affines, the head normal
    times 0.01) from ``generator`` (a CPU ``torch.Generator``; seed 0 if
    ``None``), so they do not equal ``jax.random``'s; carry JAX weights
    over with :func:`params_from_jax` and ``load_state_dict``. The
    parameters do not require grad."""

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = int(num_classes)
        self.dtype = dtype
        kw = {"device": resolve_device(device), "dtype": dtype}
        self.stem = _Stem(**kw)
        self.stages = nn.ModuleList()
        cin = 64
        for stage_i, (blocks, width) in enumerate(_STAGES):
            stage = nn.ModuleList()
            for block_i in range(blocks):
                stage.append(_Bottleneck(cin, width, width * _EXPANSION,
                                         block_i == 0, **kw))
                cin = width * _EXPANSION
            self.stages.append(stage)
        self.head = _Head(cin, self.num_classes, **kw)
        self.init(generator)
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.head.w.device

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None
             ) -> "ResNet50":
        """Draw fresh weights in place (see the class note); returns the
        model."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("scale", "bias", "b"):
                p.fill_(1.0 if leaf == "scale" else 0.0)
                continue
            w = torch.randn(p.shape, generator=generator, dtype=p.dtype)
            if leaf == "w":
                p.copy_(w * 0.01)
            else:
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                p.copy_(w * math.sqrt(2.0 / fan_in))
        return self

    # -- forward ------------------------------------------------------------
    def stage_fns(self) -> List[Callable[[torch.Tensor], torch.Tensor]]:
        """The forward pass as a chain of per-stage callables ``f(x) -> x``
        whose composition is :meth:`apply`: the stem (NHWC images in), the
        four stages (NCHW activations between them), the head (logits
        out)."""
        def stem(x: torch.Tensor) -> torch.Tensor:
            x = x.to(self.device, self.dtype).permute(0, 3, 1, 2)  # NCHW view
            x = F.relu(self.stem.bn(_conv(x, self.stem.conv, 2)))
            return F.max_pool2d(_pad_same(x, 3, 2, -math.inf), 3, 2)

        def make_stage(stage_i: int):
            def stage(x: torch.Tensor) -> torch.Tensor:
                for block_i, blk in enumerate(self.stages[stage_i]):
                    stride = 2 if (block_i == 0 and stage_i > 0) else 1
                    x = blk(x, stride)
                return x
            return stage

        def head(x: torch.Tensor) -> torch.Tensor:
            return torch.mean(x, dim=(2, 3)) @ self.head.w + self.head.b

        return [stem] + [make_stage(i) for i in range(len(_STAGES))] + [head]

    def apply(self, images, **kw) -> torch.Tensor:
        """images: ``[N, H, W, 3]`` (NHWC) -> logits ``[N, num_classes]``,
        the composition of :meth:`stage_fns`. (Given a callable instead,
        this is ``nn.Module.apply``.)"""
        if callable(images):
            return super().apply(images)
        x = torch.as_tensor(images)
        for f in self.stage_fns():
            x = f(x)
        return x

    def forward(self, images) -> torch.Tensor:
        return self.apply(images)

    # -- DataFrame formulation (the BASELINE workload) ----------------------
    def infer_via_frame(self, df, image_col: str = "image",
                        trim: bool = True):
        """Batch inference through ``map_blocks``: the frozen weights ride
        into the program as constants. Returns a lazy frame with a
        ``logits`` column (``[num_classes]`` cells in the model's dtype).
        Capture infers the output's shape on abstract tensors and runs no
        forward."""
        def fn_impl(**cols):
            x = cols[image_col]
            if _is_abstract(x):
                return {"logits": torch.empty((x.shape[0], self.num_classes),
                                              dtype=self.dtype,
                                              device=x.device)}
            with torch.no_grad():
                return {"logits": self.apply(x).to(x.device)}

        return df.map_blocks(_named_args_fn(fn_impl, [image_col]), trim=trim)


def params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ResNet-50 pytree (``{"stem": {"conv", "bn"},
    "stages": [[block]], "head": {"w", "b"}}``, numpy or jax arrays) as a
    state dict for :class:`ResNet50` (``model.load_state_dict``), on the
    CPU in the arrays' dtypes. Convolutions go from HWIO to OIHW; the
    affines and the head are taken as they are."""
    def t(a) -> torch.Tensor:
        a = np.array(a)
        if a.ndim == 4:  # HWIO -> OIHW
            a = np.ascontiguousarray(a.transpose(3, 2, 0, 1))
        return torch.from_numpy(a)

    state: Dict[str, torch.Tensor] = {}

    def walk(prefix: str, node) -> None:
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(f"{prefix}{k}.", v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}{i}.", v)
        else:
            state[prefix[:-1]] = t(node)

    walk("", params)
    return state
