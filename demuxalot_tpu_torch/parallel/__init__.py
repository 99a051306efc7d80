"""Barcode-sharded execution over several devices and processes (``ShardedDemultiplexer``)."""
from .mesh import init_distributed, make_mesh
from .sharded import ColumnDataset, ShardedDemultiplexer

__all__ = [
    "ColumnDataset",
    "ShardedDemultiplexer",
    "init_distributed",
    "make_mesh",
]
