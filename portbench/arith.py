"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes of the work, computed from shapes.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W): 3.35 TB/s of HBM, 67 TFLOP/s in float32 outside the tensor cores
(what a float32 model runs at with TF32 off), 495 TFLOP/s in TF32 and
989 TFLOP/s in bfloat16 and float16 on the tensor cores.
"""

from __future__ import annotations

from typing import Iterator, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12,
              "float16": 989e12}
ITEM_BYTES = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2,
              "int64": 8, "int32": 4}


def segment_sum_bytes(rows: int, width: int, segments: int,
                      value_bytes: int, id_bytes: int = 4) -> int:
    """B1's least traffic (``chip_smoke.py``'s arithmetic): each row's
    ``width`` values and its segment id read once, each segment's
    ``width`` results written once."""
    return rows * (width * value_bytes + id_bytes) + segments * width * value_bytes


def _out(size: int, stride: int) -> int:
    return -(-size // stride)  # "SAME" padding: ceil(size / stride)


def resnet_convs(cfg: dict) -> Iterator[Tuple[str, int, int, int, int]]:
    """Every convolution of the ResNet-50 of ``cfg`` at its image size:
    ``(name, c_out, c_in, kernel, output pixels)``. The stride of a stage's
    first block sits on its 3x3 convolution and its projection, as in the
    port's model and torchvision's (ResNet v1.5)."""
    size = _out(cfg["image_size"], 2)  # the stem's 7x7 at stride 2
    stem = cfg["stem_width"]
    yield "stem", stem, cfg["channels"], 7, size * size
    size = _out(size, 2)  # the 3x3 max pool at stride 2
    cin = stem
    for si, (blocks, width) in enumerate(cfg["stages"]):
        cout = width * cfg["expansion"]
        for bi in range(blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            out = _out(size, stride)
            pre = f"stages.{si}.{bi}"
            yield f"{pre}.conv1", width, cin, 1, size * size
            yield f"{pre}.conv2", width, width, 3, out * out
            yield f"{pre}.conv3", cout, width, 1, out * out
            if bi == 0:
                yield f"{pre}.proj", cout, cin, 1, out * out
            cin, size = cout, out


def resnet_macs(cfg: dict) -> int:
    """Multiply-adds of one image: every convolution and the classifier."""
    convs = sum(co * ci * k * k * px for _, co, ci, k, px in resnet_convs(cfg))
    last = cfg["stages"][-1][1] * cfg["expansion"]
    return convs + last * cfg["num_classes"]


def resnet_flops(cfg: dict) -> int:
    """Model FLOPs of one image: two per multiply-add."""
    return 2 * resnet_macs(cfg)
