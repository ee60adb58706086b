"""Parallelism over ``torch.distributed``: one process per device, the
batch split over the ranks of a data axis (parallel/mesh.py) and the conv
activations' y rows over the ranks of a spatial axis
(parallel/spatial.py), everything else replicated."""

from prdisagg_torch.parallel.mesh import make_mesh, make_mesh_2d, replicate

__all__ = ["make_mesh", "make_mesh_2d", "replicate"]
