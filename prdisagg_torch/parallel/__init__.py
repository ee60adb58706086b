"""Data parallelism over ``torch.distributed``: one process per device,
the batch split over ranks, everything else replicated."""

from prdisagg_torch.parallel.mesh import make_mesh, replicate

__all__ = ["make_mesh", "replicate"]
