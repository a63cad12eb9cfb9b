"""Subgraph partitioning and the "XLA" fusion backend (the port of
``mxnet_tpu/subgraph``; ref: src/operator/subgraph/)."""
from .partition import (ChainPattern, ChainSelector, Stage,
                        SubgraphProperty, SubgraphSelector, backend_rules,
                        get_subgraph_property, partition_graph,
                        register_subgraph_property)
from . import xla_fuse  # noqa: F401  the conv rule of the "XLA" fleet
from . import rules  # noqa: F401  FC + INT8 rules; registers "XLA"

__all__ = ["ChainPattern", "ChainSelector", "Stage", "SubgraphProperty",
           "SubgraphSelector", "backend_rules", "get_subgraph_property",
           "partition_graph", "register_subgraph_property"]
