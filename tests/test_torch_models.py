"""The port's logistic regression and ResNet-50 on the CPU against the JAX
package's (BASELINE configs 5 and 4).

Mirrors of ``tests/test_models.py``'s ``TestLogReg`` (its first two tests)
and ``TestResNet50`` (all three), with the JAX tests' tolerances, plus
parity with the JAX package on the same weights and inputs:

- the frame gradient of the logistic regression against ``jax.grad`` of
  the JAX package's loss on the same rows (rtol 1e-4, atol 1e-5, the JAX
  test's own bound: the frame sums in f64, ``jax.grad`` in f32);
- ResNet-50's logits at 32 x 32, where the stride-2 ``"SAME"`` padding is
  asymmetric, against the JAX package's with the same weights carried over
  by ``resnet.params_from_jax``: to 1e-5 of the logits' max-abs (f32
  convolutions summed in other orders through 53 layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorframes_tpu_torch as ttf
from tensorframes_tpu.models import (LogisticRegression as JaxLogReg,
                                     ResNet50 as JaxResNet50)
from tensorframes_tpu_torch.models import LogisticRegression, ResNet50
from tensorframes_tpu_torch.models import resnet as port_resnet


@pytest.fixture(autouse=True)
def on_cpu():
    prev = ttf.default_device()
    ttf.set_default_device("cpu")
    yield
    ttf.set_default_device(prev)


def _logreg_frame(rng, n=200, d=4, parts=3):
    w_true = np.array([1.5, -2.0, 0.5, 3.0])
    x = rng.normal(size=(n, d))
    p = 1.0 / (1.0 + np.exp(-(x @ w_true)))
    y = (rng.uniform(size=n) < p).astype(np.float64)
    return ttf.frame({"features": x, "label": y}, num_partitions=parts), x, y


class TestLogReg:
    def test_gradient_via_frame_matches_direct(self, rng):
        df, x, y = _logreg_frame(rng)
        model = LogisticRegression(4)
        params = {k: v.numpy() for k, v in model.init().items()}
        grad, loss = model.gradient_via_frame(params, df)
        jm = JaxLogReg(4)
        jp = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
        xs, ys = jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32)
        direct = jax.grad(jm.loss)(jp, xs, ys)
        for k in ("w", "b"):
            np.testing.assert_allclose(grad[k], np.asarray(direct[k]),
                                       rtol=1e-4, atol=1e-5)
        assert abs(loss - float(jm.loss(jp, xs, ys))) < 1e-4
        # and the port's own autograd of its loss, on the same rows
        port = model.grads(params, torch.from_numpy(x), torch.from_numpy(y))
        for k in ("w", "b"):
            np.testing.assert_allclose(grad[k], port[k].numpy(), rtol=1e-4,
                                       atol=1e-5)

    def test_fit_via_frame_learns(self, rng):
        df, _, _ = _logreg_frame(rng, n=400)
        model = LogisticRegression(4)
        params, losses = model.fit_via_frame(df, steps=15, lr=1.0)
        assert losses[-1] < losses[0] * 0.7
        # learned weights correlate with the generating weights
        w = params["w"]
        assert w[3] > w[0] > 0 > w[1]

    def test_single_device_train_step(self, rng):
        """``TestLogReg::test_sharded_train_step`` on one device."""
        model = LogisticRegression(4)
        step = model.make_sharded_train_step(None, lr=0.5)
        params = model.init()
        x = torch.from_numpy(rng.normal(size=(64, 4))).float()
        w_true = torch.tensor([1.5, -2.0, 0.5, 3.0])
        y = (torch.sigmoid(x @ w_true) > 0.5).float()
        losses = []
        for _ in range(20):
            params, loss = step(params, x, y)
            losses.append(float(loss))
        assert losses[-1] < losses[0] * 0.5


def _jax_resnet(num_classes):
    jm = JaxResNet50(num_classes=num_classes)
    params = jm.init()
    model = ResNet50(num_classes=num_classes, device="cpu")
    model.load_state_dict(port_resnet.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, model


class TestResNet50:
    def test_forward_shape_and_determinism(self):
        model = ResNet50(num_classes=10, device="cpu")
        x = torch.ones((2, 32, 32, 3))
        logits = model.apply(x)
        assert tuple(logits.shape) == (2, 10)
        np.testing.assert_allclose(
            logits.numpy(), model.apply(torch.ones((2, 32, 32, 3))).numpy())
        assert not any(p.requires_grad for p in model.parameters())

    def test_stage_chain_equals_apply(self):
        model = ResNet50(num_classes=7, device="cpu")
        x = torch.linspace(-1, 1, 2 * 32 * 32 * 3).reshape(2, 32, 32, 3)
        full = model.apply(x)
        y = x
        for f in model.stage_fns():
            y = f(y)
        np.testing.assert_allclose(y.numpy(), full.numpy(), rtol=1e-6,
                                   atol=1e-6)

    def test_infer_via_frame(self, rng):
        model = ResNet50(num_classes=5, device="cpu")
        imgs = rng.normal(size=(6, 32, 32, 3)).astype(np.float64)
        df = ttf.frame({"image": imgs}, num_partitions=2)
        rows = model.infer_via_frame(df, trim=True).collect()
        assert len(rows) == 6
        assert np.asarray(rows[0]["logits"]).shape == (5,)
        direct = model.apply(torch.from_numpy(imgs).float()).numpy()
        got = np.stack([np.asarray(r["logits"]) for r in rows])
        np.testing.assert_allclose(got, direct, rtol=2e-4, atol=2e-4)

    def test_logits_match_the_jax_package(self, rng):
        jm, params, model = _jax_resnet(7)
        x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
        want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
        got = model.apply(torch.from_numpy(x)).numpy()
        top = np.abs(want).max()
        assert np.abs(got - want).max() <= 1e-5 * top
        # per stage too: the stem's stride-2 convolution and pool, and the
        # first block of each later stage, pad as XLA's "SAME" does
        jy, ty = jnp.asarray(x), torch.from_numpy(x)
        for jf, tf in zip(jm.stage_fns()[:-1], model.stage_fns()[:-1]):
            jy, ty = jf(params, jy), tf(ty)
            w = np.asarray(jy)
            g = ty.permute(0, 2, 3, 1).numpy()
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()

    def test_same_padding_is_xla_s(self):
        assert port_resnet._same_pad(224, 7, 2) == (2, 3)
        assert port_resnet._same_pad(112, 3, 2) == (0, 1)
        for n in (56, 28, 14):
            assert port_resnet._same_pad(n, 3, 2) == (0, 1)
            assert port_resnet._same_pad(n, 1, 2) == (0, 0)
        assert port_resnet._same_pad(7, 3, 1) == (1, 1)
        assert port_resnet._same_pad(33, 3, 2) == (1, 1)

    def test_params_from_jax_carries_every_weight(self):
        jm, params, model = _jax_resnet(3)
        carried = port_resnet.params_from_jax(
            jax.tree_util.tree_map(np.asarray, params))
        state = model.state_dict()
        assert sorted(carried) == sorted(state)
        assert len(state) == 1 + 2 + sum(
            len(s) * 9 + 3 for s in params["stages"]) + 2
        w = np.asarray(params["stages"][1][0]["conv2"])   # HWIO
        np.testing.assert_array_equal(
            state["stages.1.0.conv2"].numpy(), w.transpose(3, 2, 0, 1))
