"""The plain references that decide ``correct``: numpy and plain PyTorch.

Nothing here imports the port or JAX, and nothing takes what the port has
made: the harness hands both sides the same inputs (columns, images,
weights) and the reference works the answers out again.

- :func:`tpch_q1`: TPC-H's Q1 (the pricing summary report, clause
  2.4.1) over the columns of ``LINEITEM`` it reads, in float64 (in float32,
  the precision below the configuration's, for the control), one masked
  sum a group and column on the device the columns are on.
- :func:`resnet50_logits`: ResNet-50 inference over NHWC images in
  float32 with TF32 off (``tf32=True``: the control), from the weights of
  :func:`resnet50_params`, in blocks of images.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# -- TPC-H Q1 ---------------------------------------------------------------

Q1_DATE = 10561  # 1998-12-01 as days since 1970-01-01
# Q1's sums, each of its column (or product) of every kept row
Q1_SUMS = ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge",
           "sum_disc")


def q1_cutoff(delta: int) -> int:
    """``date '1998-12-01' - interval '[DELTA]' day`` in days."""
    return Q1_DATE - int(delta)


@torch.no_grad()
def tpch_q1(cols: Dict[str, torch.Tensor], delta: int,
            dtype: torch.dtype = torch.float64) -> Dict[str, np.ndarray]:
    """Q1 with substitution parameter ``delta``: the rows shipped on or
    before ``1998-12-01 - delta`` days, grouped by ``(l_returnflag,
    l_linestatus)`` in that order. Returns ``l_returnflag``,
    ``l_linestatus``, ``count_order`` and the sums of :data:`Q1_SUMS`, one
    entry a group, on the host; values are read and summed in ``dtype``."""
    keep = cols["l_shipdate"] <= q1_cutoff(delta)
    code = cols["l_returnflag"].long() * 256 + cols["l_linestatus"].long()
    qty = cols["l_quantity"].to(dtype)
    price = cols["l_extendedprice"].to(dtype)
    disc = cols["l_discount"].to(dtype)
    disc_price = price * (1 - disc)
    charge = disc_price * (1 + cols["l_tax"].to(dtype))
    terms = dict(zip(Q1_SUMS, (qty, price, disc_price, charge, disc)))
    groups = torch.unique(code[keep]).tolist()
    out = {"l_returnflag": np.array([g // 256 for g in groups], np.int8),
           "l_linestatus": np.array([g % 256 for g in groups], np.int8),
           "count_order": np.zeros(len(groups), np.int64)}
    out.update({k: np.zeros(len(groups)) for k in Q1_SUMS})
    for j, g in enumerate(groups):
        m = keep & (code == g)
        out["count_order"][j] = int(m.sum())
        for k, v in terms.items():
            out[k][j] = float(torch.where(m, v, 0).sum())
    return out


# -- ResNet-50 ---------------------------------------------------------------

def resnet50_params(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """Every weight of the ResNet-50 of ``cfg``: ``(name, shape, init)``,
    ``init`` one of ``he`` (normal times ``sqrt(2 / fan_in)``), ``head``
    (normal times 0.01), ``scale`` (uniform in [0.5, 1.5)) and ``shift``
    (normal times 0.1): inference batch norm folded to a per-channel
    affine ``x * scale + bias`` whose every channel differs, and the
    classifier's bias. Convolutions are OIHW."""
    out: List[Tuple[str, Tuple[int, ...], str]] = []

    def conv(name, co, ci, k):
        out.append((name, (co, ci, k, k), "he"))

    def affine(name, c):
        out.append((f"{name}.scale", (c,), "scale"))
        out.append((f"{name}.bias", (c,), "shift"))

    stem = cfg["stem_width"]
    conv("stem.conv", stem, cfg["channels"], 7)
    affine("stem.bn", stem)
    cin = stem
    for si, (blocks, width) in enumerate(cfg["stages"]):
        cout = width * cfg["expansion"]
        for bi in range(blocks):
            pre = f"stages.{si}.{bi}"
            conv(f"{pre}.conv1", width, cin, 1)
            affine(f"{pre}.bn1", width)
            conv(f"{pre}.conv2", width, width, 3)
            affine(f"{pre}.bn2", width)
            conv(f"{pre}.conv3", cout, width, 1)
            affine(f"{pre}.bn3", cout)
            if bi == 0:
                conv(f"{pre}.proj", cout, cin, 1)
                affine(f"{pre}.proj_bn", cout)
            cin = cout
    out.append(("head.w", (cin, cfg["num_classes"]), "head"))
    out.append(("head.b", (cfg["num_classes"],), "shift"))
    return out


def _same(size: int, k: int, stride: int) -> Tuple[int, int]:
    """"SAME" padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10-bit mantissa, as the tensor
    cores read their operands (used where the device has no TF32)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _Net:
    def __init__(self, params: Dict[str, torch.Tensor], cfg: dict,
                 emulate_tf32: bool):
        self.p = params
        self.cfg = cfg
        self.round = _tf32 if emulate_tf32 else (lambda t: t)

    def conv(self, x, name, stride=1):
        w = self.p[name]
        k = w.shape[-1]
        top, bottom = _same(x.shape[2], k, stride)
        left, right = _same(x.shape[3], k, stride)
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(self.round(x), self.round(w), stride=stride)

    def affine(self, x, name):
        return (x * self.p[f"{name}.scale"][:, None, None]
                + self.p[f"{name}.bias"][:, None, None])

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2).contiguous()
        x = F.relu(self.affine(self.conv(x, "stem.conv", 2), "stem.bn"))
        top, bottom = _same(x.shape[2], 3, 2)
        left, right = _same(x.shape[3], 3, 2)
        x = F.max_pool2d(F.pad(x, (left, right, top, bottom),
                               value=-math.inf), 3, 2)
        for si, (blocks, _) in enumerate(self.cfg["stages"]):
            for bi in range(blocks):
                pre = f"stages.{si}.{bi}"
                stride = 2 if (bi == 0 and si > 0) else 1
                y = F.relu(self.affine(self.conv(x, f"{pre}.conv1"),
                                       f"{pre}.bn1"))
                y = F.relu(self.affine(self.conv(y, f"{pre}.conv2", stride),
                                       f"{pre}.bn2"))
                y = self.affine(self.conv(y, f"{pre}.conv3"), f"{pre}.bn3")
                if bi == 0:
                    x = self.affine(self.conv(x, f"{pre}.proj", stride),
                                    f"{pre}.proj_bn")
                x = F.relu(x + y)
        pooled = x.mean(dim=(2, 3))
        return (self.round(pooled) @ self.round(self.p["head.w"])
                + self.p["head.b"])


@contextlib.contextmanager
def _tf32_flags(on: bool):
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


@torch.no_grad()
def resnet50_logits(params: Dict[str, torch.Tensor], images: np.ndarray,
                    cfg: dict, device, block: int = 32,
                    tf32: bool = False) -> np.ndarray:
    """Logits ``[N, classes]`` (float32, on the host) of NHWC ``images``,
    ``block`` images at a time on ``device``. ``tf32``: the convolutions
    and the classifier read TF32 operands (the card's TF32 math; on a CPU,
    operands rounded to TF32)."""
    device = torch.device(device)
    net = _Net({k: v.to(device, torch.float32) for k, v in params.items()},
               cfg, emulate_tf32=tf32 and device.type != "cuda")
    out = []
    with _tf32_flags(tf32):
        for i in range(0, len(images), block):
            x = torch.from_numpy(np.ascontiguousarray(images[i:i + block]))
            out.append(net(x.to(device, torch.float32)).cpu().numpy())
    return np.concatenate(out) if out else np.zeros(
        (0, cfg["num_classes"]), np.float32)
