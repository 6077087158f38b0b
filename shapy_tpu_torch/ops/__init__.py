from shapy_tpu_torch.ops.tri_tri import (  # noqa: F401
    MeshMeshIntersection,
    mesh_mesh_intersection,
    point_to_barycentric,
)
from shapy_tpu_torch.ops.repulsion import repulsion_loss  # noqa: F401
