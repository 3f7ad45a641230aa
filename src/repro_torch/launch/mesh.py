"""Production meshes and the card's roofline constants (a port of
``repro.launch.mesh``).

The reference's production meshes are kept as sizes: the dry run
(``launch.dryrun_lib.fake_world``) builds one over a fake process group with
no device, and its roofline terms read the same sizes.  A run on the card
builds its mesh with ``distributed.sharding.make_mesh`` over NCCL.
"""
from __future__ import annotations

from repro_torch.distributed.sharding import mesh_sizes

# NVIDIA H100 SXM5 80GB, 700 W: data-sheet values, not measurements
PEAK_FLOPS_BF16 = 989e12    # dense bf16 FLOP/s per GPU
HBM_BW = 3.35e12            # bytes/s per GPU
NVLINK_BW = 450e9           # bytes/s per direction per GPU, inside one 8-GPU node
NET_BW = 50e9               # bytes/s per GPU across nodes (one 400 Gb/s NIC)
NODE_GPUS = 8

# {axis: size}, major to minor: (16, 16) data x model, or (2, 16, 16)
# pod x data x model
PRODUCTION_MESHES = {"single": {"data": 16, "model": 16},
                     "multi": {"pod": 2, "data": 16, "model": 16}}


def mesh_chips(mesh):
    n = 1
    for v in mesh_sizes(mesh).values():
        n *= v
    return n


def in_one_node(mesh, axis):
    """Whether each group of ``axis`` lies inside one node: its ranks, in
    row-major rank order, span its size times the sizes of the axes after
    it."""
    sizes = list(mesh_sizes(mesh).items())
    span = 1
    for name, n in sizes[[a for a, _ in sizes].index(axis):]:
        span *= n
    return span <= NODE_GPUS
