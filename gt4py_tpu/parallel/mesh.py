"""Device mesh construction for 2D horizontal domain decomposition."""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np

from gt4py_tpu import config


def _factor2(n: int) -> Tuple[int, int]:
    """Most-square factorization of n (px * py = n, px <= py)."""
    best = (1, n)
    for a in range(1, int(math.isqrt(n)) + 1):
        if n % a == 0:
            best = (a, n // a)
    return best


class CartesianMesh:
    """A 2D mesh of devices mapping ("x", "y") onto the (I, J) axes.

    The cards of one host are joined all to all (NVLink), so the device
    order does not matter for the halo exchange; ``create_device_mesh``
    picks one (a plain reshape where it declines).
    """

    AXES = ("x", "y")

    def __init__(
        self,
        shape: Optional[Tuple[int, int]] = None,
        *,
        devices: Optional[Sequence] = None,
    ):
        config.ensure_jax_config()
        import jax
        from jax.experimental import mesh_utils
        from jax.sharding import Mesh

        if devices is None:
            devices = jax.devices()
        n = len(devices)
        if shape is None:
            shape = _factor2(n)
        px, py = shape
        if px * py != n:
            devices = devices[: px * py]
        try:
            dev_array = mesh_utils.create_device_mesh((px, py), devices=devices)
        except Exception:
            dev_array = np.asarray(devices).reshape(px, py)
        self.mesh = Mesh(dev_array, self.AXES)
        self.shape = (px, py)

    @property
    def px(self) -> int:
        return self.shape[0]

    @property
    def py(self) -> int:
        return self.shape[1]

    @property
    def size(self) -> int:
        return self.px * self.py

    def field_sharding(self, ndim: int = 3):
        """NamedSharding for a (I, J, K, ...) global field."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        spec = P("x", "y", *([None] * max(ndim - 2, 0)))
        return NamedSharding(self.mesh, spec)

    def replicated(self):
        from jax.sharding import NamedSharding, PartitionSpec as P

        return NamedSharding(self.mesh, P())

    def __enter__(self):
        return self.mesh.__enter__()

    def __exit__(self, *args):
        return self.mesh.__exit__(*args)

    @classmethod
    def initialize_multihost(cls, **kwargs) -> "CartesianMesh":
        """Initialize jax.distributed (multi-host) then build the mesh over
        all global devices.  On a single host this is a no-op."""
        import os

        import jax

        try:
            jax.distributed.initialize()
        except Exception:
            # Only a configured multi-process job should fail loudly; a
            # plain single-process run (no coordinator configured) falls
            # back to the local devices.
            if any(
                os.environ.get(v)
                for v in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")
            ):
                raise
        return cls(**kwargs)
