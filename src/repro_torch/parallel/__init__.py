"""Sharding of the port: logical-axis rules and their DTensor placements on
a ``DeviceMesh`` (own copy of ``repro.parallel``)."""
from .sharding import (NamedSharding, axis_rules, batch_pspec,
                       cache_shardings, distribute, logical_rules,
                       mesh_sizes, param_pspec, param_shardings, place,
                       spec_placements)

__all__ = ["NamedSharding", "axis_rules", "batch_pspec", "cache_shardings",
           "distribute", "logical_rules", "mesh_sizes", "param_pspec",
           "param_shardings", "place", "spec_placements"]
