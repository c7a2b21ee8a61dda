"""Distributed training over the ranks of a process group (the port's
`lightgbm_tpu/parallel/`; ref: src/network/ and the data, feature and
voting tree learners).  `init` joins the group; `train` with
`tree_learner` set then shards each tree's per-row work over the ranks
(`learner.py`).
"""
from ..mesh.topology import get_mesh, get_mesh_2level, init  # noqa: F401
from .data_parallel import make_sharded_train_step, shard_dataset  # noqa: F401,E501
from .learner import make_distributed_grower, resolve_tree_learner  # noqa: F401,E501
