"""Distributed domain decomposition over device meshes.

This layer has NO counterpart in the reference -- GT4Py is strictly
single-process (SURVEY.md §2.7; verified: no MPI/NCCL/distributed code in
the reference's src/).  Users like FV3/Pace layer MPI on top externally.
Here, horizontal domain decomposition is first-class:

- ``CartesianMesh``: a 2D ``jax.sharding.Mesh`` ("x" -> I, "y" -> J).
- Global-view path: fields are global jax arrays sharded with
  ``NamedSharding(P("x", "y", None))``; stencils run on the global domain
  under ``jit`` and XLA/GSPMD inserts the halo collectives automatically.
- Explicit path: ``halo_exchange`` swaps halos with ``lax.ppermute``
  inside ``shard_map`` (periodic boundaries), for kernels that manage
  their own halos (Pallas) and for overlap scheduling; XLA hands the
  collectives to NCCL on GPUs.

K (vertical) stays on one device: serial scans need the whole column, and
80-128 levels fit comfortably (SURVEY.md §5 "long-context analog").
"""

from .mesh import CartesianMesh  # noqa: F401
from .halo import (  # noqa: F401
    from_extended,
    halo_comm_bytes,
    halo_exchange,
    overlapped_shard_map_stencil,
    shard_map_stencil,
    to_extended,
)
from .distributed import DistributedField, distribute, gather  # noqa: F401
