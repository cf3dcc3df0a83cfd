"""Parameters placed on a mesh, for the models' mesh paths.

The JAX package gets tensor, sequence and expert parallelism from GSPMD:
one global program whose ``NamedSharding`` annotations XLA turns into
per-device slices and collectives. The port's mesh is single-controller
and has no such compiler, so the models compute each shard's part
explicitly, on that shard's device. This module keeps the bookkeeping:

- :class:`Layout` names the roles of the mesh's axes (``d`` data, ``m``
  model, ``s`` seq, ``e`` expert, ``p`` pipe) and finds the device of a
  part split over some of them (the first slot of the others).
- :class:`Placement` holds a parameter that the JAX package splits as its
  slices, one per shard of its split axes, and every slice (and a
  replicated parameter) once per distinct device among the slots that
  share it: 8 logical shards of one card hold one copy.
- :class:`Access` hands a mesh forward the tensor for a use site. When
  gradients are wanted, every use gets a leaf of its own sharing the
  copy's storage, so each use site's gradient comes back apart and
  :meth:`Access.grads` sums them per slice in the order of use (shard
  order) before any copy is updated.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

Spec = Tuple[Tuple[int, str], ...]  # (tensor dim, role) pairs split on

ROLES = ("d", "m", "s", "e", "p")


class Layout:
    """The roles of a mesh's axes: ``axes[role]`` is an axis name or
    ``None`` (the role unused: size 1)."""

    def __init__(self, mesh, **axes: Optional[str]):
        self.mesh = mesh
        self.axes = {r: axes.get(r) for r in ROLES}
        used = [a for a in self.axes.values() if a is not None]
        for a in used:
            if a not in mesh.axis_names:
                raise ValueError(f"Mesh has axes {mesh.axis_names}; no "
                                 f"{a!r} axis")
        if len(set(used)) != len(used):
            raise ValueError(f"mesh axes {used} name one axis twice")

    def size(self, role: str) -> int:
        return self.mesh.axis_size(self.axes[role])

    def _coords(self, roles: Mapping[str, int]) -> Dict[str, int]:
        return {self.axes[r]: i for r, i in roles.items()
                if self.axes[r] is not None}

    def device(self, **roles: int) -> torch.device:
        """The device of the part at ``roles`` (role -> shard index)."""
        return self.mesh.device_at(**self._coords(roles))

    def devices_matching(self, roles: Mapping[str, int]
                         ) -> List[torch.device]:
        """The distinct devices, in slot order, of the slots whose
        coordinates on ``roles`` are the given ones."""
        coords = self._coords(roles)
        pos = {a: self.mesh.axis_names.index(a) for a in coords}
        out: List[torch.device] = []
        for idx in np.ndindex(self.mesh.devices.shape):
            if all(idx[pos[a]] == i for a, i in coords.items()):
                dev = self.mesh.devices[idx]
                if dev not in out:
                    out.append(dev)
        return out


class Placement:
    """Where each slice of each parameter lives: ``entries[name]`` is a
    list of ``(key, device)``, slice-major (``key`` the slice's index on
    each split role) and device-minor."""

    def __init__(self, layout: Layout, specs: Mapping[str, Spec]):
        self.layout = layout
        self.specs = {n: tuple((dim, r) for dim, r in spec
                               if layout.size(r) > 1)
                      for n, spec in specs.items()}
        self.entries: Dict[str, List[Tuple[tuple, torch.device]]] = {}
        self._index: Dict[tuple, int] = {}
        for n, spec in self.specs.items():
            ents = []
            for key in itertools.product(
                    *(range(layout.size(r)) for _, r in spec)):
                roles = {r: k for (_, r), k in zip(spec, key)}
                for dev in layout.devices_matching(roles):
                    self._index[n, key, str(dev)] = len(ents)
                    ents.append((key, dev))
            self.entries[n] = ents

    def key(self, name: str, roles: Mapping[str, int]) -> tuple:
        return tuple(roles.get(r, 0) for _, r in self.specs[name])

    def index(self, name: str, key: tuple, device: torch.device) -> int:
        return self._index[name, key, str(device)]

    def piece(self, name: str, t: torch.Tensor, key: tuple) -> torch.Tensor:
        """The slice ``key`` of the global tensor ``t`` (a view)."""
        for (dim, r), k in zip(self.specs[name], key):
            n = self.layout.size(r)
            if t.shape[dim] % n:
                raise ValueError(
                    f"{name}: dim {dim} of size {t.shape[dim]} does not "
                    f"split over the {n} shards of "
                    f"{self.layout.axes[r]!r}")
            size = t.shape[dim] // n
            t = t.narrow(dim, k * size, size)
        return t

    def place(self, params: Mapping[str, torch.Tensor],
              dtypes: Optional[Mapping[str, torch.dtype]] = None
              ) -> Dict[str, List[torch.Tensor]]:
        """Each global tensor's slices and copies, in fresh memory, in
        ``dtypes[name]`` where given."""
        missing = set(self.specs) ^ set(params)
        if missing:
            raise KeyError(f"parameters do not match the model's: "
                           f"{sorted(missing)}")
        out = {}
        for n, ents in self.entries.items():
            t = torch.as_tensor(params[n])
            dt = (dtypes or {}).get(n, t.dtype)
            out[n] = [torch.empty(self.piece(n, t, key).shape, dtype=dt,
                                  device=dev)
                      .copy_(self.piece(n, t, key)) for key, dev in ents]
        return out

    def gather(self, pieces: Mapping[str, Sequence[torch.Tensor]],
               device) -> Dict[str, torch.Tensor]:
        """The global tensors from their slices (the first copy of
        each), on ``device``."""
        out = {}
        for n, ents in self.entries.items():
            first = {}
            for (key, _), t in zip(ents, pieces[n]):
                first.setdefault(key, t.to(device))
            out[n] = self._assemble(self.specs[n], first, ())
        return out

    def _assemble(self, spec: Spec, first: Dict[tuple, torch.Tensor],
                  prefix: tuple) -> torch.Tensor:
        if len(prefix) == len(spec):
            return first[prefix]
        dim, r = spec[len(prefix)]
        return torch.cat([self._assemble(spec, first, prefix + (k,))
                          for k in range(self.layout.size(r))], dim=dim)

    def zeros_like(self, pieces: Mapping[str, Sequence[torch.Tensor]]
                   ) -> Dict[str, List[torch.Tensor]]:
        return {n: [torch.zeros_like(t) for t in ts]
                for n, ts in pieces.items()}


class Access:
    """The tensors of a mesh forward's use sites.

    ``pieces`` (a placed state's slices, from :class:`Placement`) or
    ``params`` (global tensors, sliced on the fly as views: a forward on
    a module's own weights). With ``track``, every :meth:`get` returns a
    new leaf that requires grad, sharing the copy's storage."""

    def __init__(self, placement: Placement,
                 pieces: Optional[Mapping[str, Sequence[torch.Tensor]]]
                 = None,
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 track: bool = False):
        self.placement = placement
        self.pieces = pieces
        self.params = params
        self.track = track
        self.uses: List[Tuple[str, tuple, torch.Tensor]] = []

    def get(self, name: str, **roles: int) -> torch.Tensor:
        pl = self.placement
        key = pl.key(name, roles)
        dev = pl.layout.device(**roles)
        if self.pieces is None:
            return pl.piece(name, self.params[name], key).to(dev)
        t = self.pieces[name][pl.index(name, key, dev)]
        if not self.track:
            return t
        leaf = t.detach().requires_grad_()
        self.uses.append((name, key, leaf))
        return leaf

    def leaves(self) -> List[torch.Tensor]:
        return [leaf for _, _, leaf in self.uses]

    def grads(self, grads: Sequence[Optional[torch.Tensor]]
              ) -> Dict[str, List[torch.Tensor]]:
        """Each copy's gradient: the sum over its slice's uses, in the
        order of use, on the device of the first use, then copied to each
        copy's device (a replicated parameter is updated once a device,
        however many slots share it)."""
        pl = self.placement
        total: Dict[tuple, torch.Tensor] = {}
        for (name, key, _), g in zip(self.uses, grads):
            if g is None:
                continue
            k = (name, key)
            if k in total:
                total[k] = total[k] + g.to(total[k].device)
            else:
                total[k] = g
        out = {}
        for name, ents in pl.entries.items():
            ts = self.pieces[name]
            out[name] = [total[name, key].to(dev) if (name, key) in total
                         else torch.zeros_like(t)
                         for (key, dev), t in zip(ents, ts)]
        return out
