"""What the benchmark's CPU tests share: the cells at small sizes and the
port's default device set to the CPU.

Run the tests with ``python -m pytest portbench/tests -q`` from the root
of the checkout. Tests marked ``cuda`` need an NVIDIA card and skip
without one (``-m cuda`` selects them on the card).
"""

from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

TPCH_SMALL = {"config": {"scale_factor": 0.004}}
RESNET_SMALL = {"config": {"image_size": 32, "pool_images": 32},
                "workload": {"job": {"blocks": 2, "block_rows": 4},
                             "check": {"sample": 6},
                             "traffic": {"params": {
                                 "offset": {"grid": [0, 24, 4]}}}}}
SMALL = {"tpch_q1": TPCH_SMALL, "resnet50_b256": RESNET_SMALL,
         "resnet50_b32": RESNET_SMALL}
CELLS = sorted(SMALL)


@pytest.fixture
def cpu_port():
    """The port's default device set to the CPU for the test, restored
    after."""
    import tensorframes_tpu_torch as ttf
    from tensorframes_tpu_torch.device import default_device

    was = default_device()
    ttf.set_default_device("cpu")
    yield
    ttf.set_default_device(was)
