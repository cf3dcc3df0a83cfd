"""The yardstick's arithmetic: ResNet-50's FLOPs from its layer shapes and
B1's bytes."""

import json
from pathlib import Path

import pytest

from portbench import arith

CFG = json.loads((Path(__file__).resolve().parents[1] / "configs"
                  / "resnet50_f32.json").read_text())


def test_resnet50_macs_match_the_published_count():
    # 4.1 G multiply-adds at 224 x 224 (He et al.; torchvision: 4.09 G)
    macs = arith.resnet_macs(CFG)
    assert abs(macs - 4.09e9) / 4.09e9 < 0.01, macs
    assert arith.resnet_flops(CFG) == 2 * macs


def test_resnet50_has_53_convolutions_and_its_widths():
    convs = list(arith.resnet_convs(CFG))
    assert len(convs) == 53  # 1 stem, 16 blocks x 3, 4 projections
    assert convs[0] == ("stem", 64, 3, 7, 112 * 112)
    last = [c for c in convs if c[0] == "stages.3.2.conv3"][0]
    assert last[1:] == (2048, 512, 1, 7 * 7)


@pytest.mark.parametrize("rows,width,segments,item,want", [
    (20_000_000, 1, 131_073, 8, 20_000_000 * 12 + 131_073 * 8),
    (2_500_000, 1, 100_000, 8, 2_500_000 * 12 + 100_000 * 8),
    (250_000, 64, 1_024, 4, 250_000 * (64 * 4 + 4) + 1_024 * 64 * 4),
])
def test_segment_sum_bytes(rows, width, segments, item, want):
    assert arith.segment_sum_bytes(rows, width, segments, item) == want


def test_segment_sum_bound_of_the_kernel_table():
    # chip_smoke.py's bound for 2.5M x 1 f64 into 100,000: 0.00919 ms
    ms = arith.segment_sum_bytes(2_500_000, 1, 100_000, 8) \
        / arith.HBM_BYTES_PER_S * 1e3
    assert abs(ms - 0.00919) < 5e-5
