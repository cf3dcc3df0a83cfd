"""The port's checkpoint / resume (``utils/checkpoint.py``, ``torch.save``
where the JAX package uses Orbax): mirrors of the two checkpoint cases of
``tests/test_builder_checkpoint.py``, and the same host state saved by
both packages reading back equal, exactly."""

import os

import numpy as np
import pytest
import torch

import tensorframes_tpu_torch as ttf
from tensorframes_tpu.utils import checkpoint as jax_ckpt
from tensorframes_tpu_torch.models import (LogisticRegression,
                                           TransformerConfig, TransformerLM)
from tensorframes_tpu_torch.utils import checkpoint as ckpt


@pytest.fixture(autouse=True)
def on_cpu():
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    yield
    ttf.set_default_device(prev)


def test_checkpoint_roundtrip_host(tmp_path):
    state = {"w": np.arange(6.0).reshape(2, 3), "b": np.float32(1.5)}
    ckpt.save(str(tmp_path / "c1"), state)
    back = ckpt.restore(str(tmp_path / "c1"))
    np.testing.assert_array_equal(back["w"], state["w"])
    assert float(back["b"]) == 1.5
    # numpy leaves come back as numpy, with their dtypes, through
    # torch.load(weights_only=True)
    assert isinstance(back["w"], np.ndarray) and back["w"].dtype == np.float64
    assert back["b"].dtype == np.float32 and back["b"].shape == ()
    # the JAX package saves and restores the same tree to the same values
    jax_ckpt.save(str(tmp_path / "j1"), state)
    jback = jax_ckpt.restore(str(tmp_path / "j1"))
    np.testing.assert_array_equal(back["w"], np.asarray(jback["w"]))
    assert float(back["b"]) == float(jback["b"])


def test_checkpoint_resume_sharded_state(tmp_path):
    """The single-device case: the JAX test's mesh is ``local_mesh()``,
    here the logistic regression's step on one device."""
    model = LogisticRegression(num_features=8)
    step = model.make_sharded_train_step(None)
    params = model.init()
    root = str(tmp_path / "run")
    assert ckpt.latest_step(root) is None
    assert ckpt.restore_step(root) == (None, None)
    ckpt.save_step(root, 3, params)
    ckpt.save_step(root, 7, params)
    assert ckpt.latest_step(root) == 7
    restored, step_n = ckpt.restore_step(root, state_like=params)
    assert step_n == 7
    for k in params:
        assert torch.equal(restored[k], params[k])
    x = torch.ones((4, 8))
    y = torch.ones(4)
    a, la = step(params, x, y)
    b, lb = step(restored, x, y)
    assert torch.equal(la, lb) and all(torch.equal(a[k], b[k]) for k in a)


def test_restore_with_like_takes_each_leafs_dtype_and_layout(tmp_path):
    state = {"params": {"w": torch.arange(4.0, dtype=torch.float64)},
             "opt": {"count": torch.tensor(3), "mu": [torch.ones(2)]},
             "note": "adam", "host": np.arange(3, dtype=np.int32)}
    path = str(tmp_path / "c")
    ckpt.save(path, state)
    like = {"params": {"w": torch.zeros(4, dtype=torch.float32)},
            "opt": {"count": torch.tensor(0), "mu": [torch.zeros(2)]},
            "note": "", "host": np.zeros(3, np.int64)}
    back = ckpt.restore(path, like=like)
    assert back["params"]["w"].dtype == torch.float32
    assert back["params"]["w"].tolist() == [0.0, 1.0, 2.0, 3.0]
    assert int(back["opt"]["count"]) == 3 and back["note"] == "adam"
    assert back["host"].dtype == np.int64 and back["host"].tolist() == [0, 1, 2]
    with pytest.raises(ValueError, match="template"):
        ckpt.restore(path, like={"params": {}, "opt": {}, "note": "",
                                 "host": None})
    with pytest.raises(TypeError, match="cannot store"):
        ckpt.save(str(tmp_path / "bad"), {"x": object()})


def test_save_replaces_whole_and_leaves_no_temporary(tmp_path):
    root = str(tmp_path / "run")
    ckpt.save_step(root, 1, {"a": torch.ones(2)})
    ckpt.save_step(root, 1, {"a": torch.zeros(3)})
    assert sorted(os.listdir(root)) == ["step_00000001"]
    assert os.listdir(os.path.join(root, "step_00000001")) == ["state.pt"]
    assert ckpt.restore_step(root)[0]["a"].tolist() == [0.0, 0.0, 0.0]
    os.makedirs(os.path.join(root, "step_00000009.tmp-123"))
    assert ckpt.latest_step(root) == 1


@pytest.fixture
def deterministic():
    """The embedding's backward (an accumulating ``index_put_``) sums in
    a fixed order only under ``torch.use_deterministic_algorithms``."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def test_train_state_resumes_bit_equal(tmp_path, deterministic):
    """A transformer train state saved after 2 steps and restored into a
    fresh ``init_state()`` takes step 3 exactly as the uninterrupted
    state does."""
    cfg = TransformerConfig(vocab_size=32, d_model=16, n_heads=2,
                            n_layers=1, d_ff=32)
    model = TransformerLM(cfg, device="cpu")
    step, init_state = model.make_sharded_train_step(learning_rate=1e-2)
    tok = torch.from_numpy(np.random.default_rng(0).integers(0, 32, (2, 6)))
    tgt = torch.roll(tok, -1, 1)
    state = init_state()
    for _ in range(2):
        state, _ = step(state, tok, tgt)
    ckpt.save_step(str(tmp_path), 2, state)
    state, loss = step(state, tok, tgt)
    restored, at = ckpt.restore_step(str(tmp_path), init_state())
    assert at == 2 and int(restored["opt"]["count"]) == 2
    restored, again = step(restored, tok, tgt)
    assert torch.equal(loss, again)
    for k, v in state["params"].items():
        assert torch.equal(restored["params"][k], v), k
