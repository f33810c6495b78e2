from mpopis_tpu_torch.parallel.collectives import (
    gather_sample_costs,
    global_it_weights,
    global_mean_cov,
    global_top_k,
    global_weighted_mean_cov,
)
from mpopis_tpu_torch.parallel.mesh import SampleMesh, distributed_init, make_sample_mesh

__all__ = [
    "gather_sample_costs",
    "global_it_weights",
    "global_mean_cov",
    "global_top_k",
    "global_weighted_mean_cov",
    "SampleMesh",
    "distributed_init",
    "make_sample_mesh",
]
