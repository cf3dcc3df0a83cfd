"""End-to-end language-model training through the port, the counterpart of
``demos/train_lm.py``:

 - the **frame layer** as the data path: the token corpus is a
   ``TensorFrame`` whose partitions are the batches, and its ``blocks()``
   are the data loader;
 - the **train step**: ``TransformerLM.make_sharded_train_step`` (adam) on
   one device or over a ``data`` x ``model`` mesh (tensor-parallel
   parameters, data-parallel batch); on the card, attention's forward and
   backward are the port's CUDA kernels;
 - **checkpoint / resume**: ``utils.checkpoint.save_step`` /
   ``restore_step``: stop anywhere, resume with every tensor restored to
   its device (a mesh state is saved as its global state and placed on
   the same mesh again), and continue as if never interrupted.

The task is next-token prediction on modular-increment sequences
(``tokens[t+1] = (tokens[t] + step) % vocab`` with a per-sequence step of
1 or 2): a two-layer model drives the loss down an order of magnitude in a
few dozen steps.

Run:  python -m tensorframes_tpu_torch.demos.train_lm   (on the card; call
``tensorframes_tpu_torch.set_default_device("cpu")`` first for the CPU)
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch.models import TransformerConfig, TransformerLM
from tensorframes_tpu_torch.models.transformer import as_mesh
from tensorframes_tpu_torch.utils import checkpoint as ckpt_lib

__all__ = ["corpus_frame", "train", "main"]


def corpus_frame(n_batches: int, batch: int, seq_len: int,
                 vocab: int, seed: int = 0) -> "tft.TensorFrame":
    """The training corpus as a frame: one partition per batch.

    Each row is one training sequence (``seq_len + 1`` tokens: inputs are
    ``[:-1]``, targets ``[1:]``)."""
    rng = np.random.default_rng(seed)
    n = n_batches * batch
    starts = rng.integers(0, vocab, (n, 1))
    steps = rng.integers(1, 3, (n, 1))          # +1 or +2 sequences
    pos = np.arange(seq_len + 1)[None, :]
    toks = (starts + steps * pos) % vocab
    df = tft.analyze(tft.frame({"tokens": toks.astype(np.int64)},
                               num_partitions=n_batches))
    df.cache()
    return df


def _batches(df) -> List[np.ndarray]:
    return [b.dense("tokens").astype(np.int32) for b in df.blocks()]


def _config(vocab: int) -> TransformerConfig:
    return TransformerConfig(vocab_size=vocab, d_model=64, n_heads=8,
                             n_layers=2, d_ff=128)


def train(mesh=None, *, n_steps: int = 40, batch: int = 16,
          seq_len: int = 32, vocab: int = 64,
          checkpoint_root: Optional[str] = None,
          checkpoint_every: int = 0,
          resume: bool = False,
          config: Optional[TransformerConfig] = None,
          learning_rate: float = 3e-3) -> Tuple[Dict, List[float]]:
    """Train on ``mesh`` (``None``: the package's default device; a
    ``parallel.DeviceMesh``, its ``model`` axis used when it has one);
    returns ``(final_state, per-step losses)``; a mesh run's state is its
    global state (``step.gather``).

    With ``checkpoint_root`` + ``checkpoint_every``, saves the train state
    every C steps; with ``resume=True``, restores the latest step first
    and continues from there (cold start when nothing is saved)."""
    model = TransformerLM(config or _config(vocab))
    mesh = as_mesh(mesh)
    data_axis = mesh.data_axis if mesh is not None else "data"
    model_axis = "model" if mesh is not None and \
        "model" in mesh.axis_names else None
    step, init_state = model.make_sharded_train_step(
        mesh, data_axis=data_axis, model_axis=model_axis,
        learning_rate=learning_rate)
    # a mesh state is checkpointed whole and placed again on restore
    whole = getattr(step, "gather", lambda s: s)
    place = getattr(step, "place", lambda s: s)

    state = init_state()
    start = 0
    if resume and checkpoint_root:
        restored, at = ckpt_lib.restore_step(checkpoint_root, whole(state))
        if restored is not None:
            state, start = place(restored), at
    if start >= n_steps:
        return whole(state), []

    df = corpus_frame(n_batches=8, batch=batch, seq_len=seq_len,
                      vocab=vocab)
    data = [torch.from_numpy(t).to(model.device) for t in _batches(df)]

    losses: List[float] = []
    for i in range(start, n_steps):
        toks = data[i % len(data)]
        state, loss = step(state, toks[:, :-1], toks[:, 1:])
        losses.append(float(loss))
        if (checkpoint_root and checkpoint_every
                and (i + 1) % checkpoint_every == 0):
            ckpt_lib.save_step(checkpoint_root, i + 1, whole(state))
    return whole(state), losses


def main(checkpoint_root: Optional[str] = None) -> Dict:
    """Train 30 steps checkpointing every 10, "crash", resume from disk to
    40, then greedily continue a +1 sequence with the trained model.
    Checkpoints go under ``checkpoint_root`` (a new temporary directory if
    ``None``)."""
    root = checkpoint_root or os.path.join(
        tempfile.mkdtemp(prefix="tft_lm_"), "ckpt")

    # phase 1: train 30 steps, checkpointing every 10
    _, losses = train(n_steps=30, checkpoint_root=root, checkpoint_every=10)
    resumed_from = ckpt_lib.latest_step(root)
    # phase 2: "crash" after step 30, resume from disk, finish to 40
    state, more = train(n_steps=40, checkpoint_root=root,
                        checkpoint_every=10, resume=True)

    first, last = losses[0], more[-1]
    print(f"step   1: loss {first:.4f}")
    print(f"step  40: loss {last:.4f}  (resumed from step "
          f"{resumed_from} checkpoint)")
    assert last < first / 3, (first, last)

    # the trained model speaks the language: greedily continue a +1
    # sequence with the KV-cache decode loop
    model = TransformerLM(_config(64))
    model.load_state_dict(state["params"])
    prompt = torch.tensor([[10 + i for i in range(8)]], dtype=torch.int32)
    out = model.generate(prompt, max_new_tokens=8)
    completion = out[0, 8:].cpu().tolist()
    print(f"prompt 10..17 -> continuation {completion}")
    return {"first_loss": first, "final_loss": last,
            "resumed_from": resumed_from, "total_steps": 40,
            "losses": losses + more, "continuation": completion}


if __name__ == "__main__":
    main()
