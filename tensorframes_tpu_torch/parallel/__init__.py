"""Distribution layer: device meshes, sharded frames, mesh collectives.

The port's counterpart of ``tensorframes_tpu/parallel/``, single-controller
within a process as the JAX package is: one process drives every device of a
:class:`DeviceMesh` (an array of ``torch.device`` objects with named
axes and one logical id per slot). Partitions become shards of every
column, one per device of the data axis; a mesh reduce's combine becomes
the combiner's collective over the shards' partials (``collectives.py``).

Ported: the mesh, its collectives, the distributed frame's ops
``distribute``, ``dmap_blocks``, ``dfilter``, ``dsort`` (columnsort, or
the external sort past the device budget), ``dreduce_blocks`` and
``daggregate`` (host and device keys, hot-key salting, sketch combiners,
the high-cardinality shuffle route), the shuffle (``dexchange``,
``shuffle_daggregate``, ``shuffle_enabled``), the elastic mesh
(``elastic.py``: device-loss recovery at every op's dispatch, skew
rebalancing, ``admit_devices``, ``grow_mesh``, ``probe_device``) and the
fused distributed plan (``DistributedFrame.lazy()``, ``plan/dist.py``).
Ring attention and the ring allreduce (``ring.py``), the Switch MoE
(``moe.py``) and the GPipe schedule (``pipeline.py``) are ported too; the
transformer's mesh steps stand on them. So is the multi-process cluster
(``cluster.py``): ``initialize`` joins the processes into one
``torch.distributed`` group (gloo or NCCL, chosen from where the ranks
are), ``cluster_mesh`` builds a mesh over every process's slots and
``distribute_local`` places each process's own rows on its own shards;
every d-op then runs across the processes, each holding its own shards,
with bit-identical results on every process.
"""

from .cluster import cluster_mesh, distribute_local, initialize
from .collectives import COMBINERS
from .distributed import (DistributedFrame, daggregate, dfilter, distribute,
                          dmap_blocks, dreduce_blocks, dsort)
from .elastic import admit_devices, grow_mesh, probe_device
from .exchange import dexchange, shuffle_daggregate, shuffle_enabled
from .mesh import DeviceMesh, local_mesh
from .ring import ring_allreduce, ring_attention

__all__ = [
    "DeviceMesh", "local_mesh",
    "DistributedFrame", "daggregate", "dfilter", "distribute",
    "dmap_blocks", "dreduce_blocks", "dsort",
    "COMBINERS",
    "admit_devices", "grow_mesh", "probe_device",
    "dexchange", "shuffle_daggregate", "shuffle_enabled",
    "ring_attention", "ring_allreduce",
    "cluster_mesh", "distribute_local", "initialize",
]

