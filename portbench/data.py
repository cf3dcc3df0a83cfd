"""Inputs and weights made from the seed, in bulk on the device.

- :func:`lineitem`: the columns of TPC-H's ``LINEITEM`` that Q1 reads,
  drawn as the specification's ``dbgen`` draws them (clause 4.2.3);
- :func:`image_pool`: standard-normal f32 NHWC images, as ``chip_smoke.py``'s
  ``phase_resnet50_infer`` makes them;
- :func:`resnet50_weights`: the weights of :func:`reference.resnet50_params`.

Everything is drawn with a ``torch.Generator`` on the device in a few
large calls; columns and images are then handed to the host, where the
port's frames read them.
"""

from __future__ import annotations

import datetime
import zlib
from typing import Dict

import numpy as np
import torch

from .reference import resnet50_params


def generator(seed: int, device, purpose: str) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` and ``purpose``."""
    state = np.random.SeedSequence(
        [int(seed) % 2 ** 64, zlib.crc32(purpose.encode())]
    ).generate_state(1, np.uint64)[0]
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(state) % 2 ** 63)
    return g


def days(year: int, month: int, day: int) -> int:
    """A date as days since 1970-01-01 (the columns' ``DATE``)."""
    return (datetime.date(year, month, day) - datetime.date(1970, 1, 1)).days


# TPC-H's dates (clause 4.2.2.12)
START_DATE = days(1992, 1, 1)
CURRENT_DATE = days(1995, 6, 17)
END_DATE = days(1998, 12, 31)


def lineitem(cfg: dict, seed: int, device) -> Dict[str, np.ndarray]:
    """The ``LINEITEM`` columns that Q1 reads, on the host, for
    ``cfg["scale_factor"]``: ``SF * 1,500,000`` orders of 1 to 7 lines
    each, an order date uniform over [STARTDATE, ENDDATE - 151], and per
    line a part uniform over ``SF * 200,000`` (its retail price by the
    specification's formula), a quantity of 1 to 50, a discount of 0.00 to
    0.10 and a tax of 0.00 to 0.08, a ship date 1 to 121 days after the
    order and a receipt date 1 to 30 days after that. ``l_returnflag`` is
    ``R`` or ``A`` at random where the receipt date is on or before
    CURRENTDATE, else ``N``; ``l_linestatus`` is ``O`` where the ship date
    is after CURRENTDATE, else ``F``. Flags are one byte (their ASCII
    code), dates int32 days, decimals float64."""
    g = generator(seed, device, "lineitem")
    sf = float(cfg["scale_factor"])

    def draw(lo, hi, n):  # uniform integers in [lo, hi]
        return torch.randint(int(lo), int(hi) + 1, (n,), generator=g,
                             device=device, dtype=torch.int64)

    orders = int(round(sf * 1_500_000))
    lines = draw(1, 7, orders)
    orderdate = draw(START_DATE, END_DATE - 151, orders)
    orderdate = torch.repeat_interleave(orderdate, lines)
    n = int(orderdate.shape[0])
    part = draw(1, round(sf * 200_000), n)
    retail_cents = 90000 + (part // 10) % 20001 + 100 * (part % 1000)
    quantity = draw(1, 50, n)
    ship = orderdate + draw(1, 121, n)
    receipt = ship + draw(1, 30, n)
    r_or_a = torch.where(draw(0, 1, n) == 1, ord("R"), ord("A"))
    cols = {
        "l_returnflag": torch.where(receipt <= CURRENT_DATE, r_or_a,
                                    ord("N")).to(torch.int8),
        "l_linestatus": torch.where(ship > CURRENT_DATE, ord("O"),
                                    ord("F")).to(torch.int8),
        "l_quantity": quantity.to(torch.float64),
        "l_extendedprice": (quantity * retail_cents).to(torch.float64) / 100,
        "l_discount": draw(0, 10, n).to(torch.float64) / 100,
        "l_tax": draw(0, 8, n).to(torch.float64) / 100,
        "l_shipdate": ship.to(torch.int32),
    }
    return {k: v.cpu().numpy() for k, v in cols.items()}


def image_pool(cfg: dict, seed: int, device, chunk: int = 512
               ) -> np.ndarray:
    """``cfg["pool_images"]`` standard-normal float32 NHWC images, on the
    host (made ``chunk`` at a time on the device)."""
    g = generator(seed, device, "images")
    n = int(cfg["pool_images"])
    shape = (cfg["image_size"], cfg["image_size"], cfg["channels"])
    pool = np.empty((n,) + shape, np.float32)
    for i in range(0, n, chunk):
        m = min(chunk, n - i)
        pool[i:i + m] = torch.randn((m,) + shape, generator=g, device=device,
                                    dtype=torch.float32).cpu().numpy()
    return pool


def resnet50_weights(cfg: dict, seed: int, device
                     ) -> Dict[str, torch.Tensor]:
    """The weights of :func:`reference.resnet50_params`, float32 on
    ``device``: one normal draw for every convolution, classifier and
    bias, one uniform draw for every scale, each cut and scaled per
    leaf."""
    spec = resnet50_params(cfg)
    g = generator(seed, device, "weights")
    size = {n: int(np.prod(s)) for n, s, _ in spec}
    normal = torch.randn(sum(size[n] for n, _, i in spec if i != "scale"),
                         generator=g, device=device, dtype=torch.float32)
    uniform = torch.rand(sum(size[n] for n, _, i in spec if i == "scale"),
                         generator=g, device=device, dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    at = {"normal": 0, "uniform": 0}
    for name, shape, init in spec:
        src = "uniform" if init == "scale" else "normal"
        flat = uniform if src == "uniform" else normal
        w = flat[at[src]:at[src] + size[name]].view(shape)
        at[src] += size[name]
        if init == "scale":
            out[name] = 0.5 + w
        elif init == "shift":
            out[name] = w * 0.1
        elif init == "head":
            out[name] = w * 0.01
        else:
            fan_in = shape[1] * shape[2] * shape[3]
            out[name] = w * np.sqrt(2.0 / fan_in)
    return out
