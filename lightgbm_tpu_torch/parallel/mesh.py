"""Re-exports of `mesh/topology.py` under the reference's older path
(`lightgbm_tpu/parallel/mesh.py`)."""
from __future__ import annotations

from ..mesh.topology import (build_mesh, describe, get_mesh,  # noqa: F401
                             get_mesh_2level, init, parse_mesh_shape)

__all__ = ["build_mesh", "describe", "get_mesh", "get_mesh_2level",
           "init", "parse_mesh_shape"]
