"""``repro_torch.launch`` — meshes over ``torch.distributed`` ranks
(``mesh``) and a local launcher for their processes (``ranks``)."""
from repro_torch.launch.mesh import (dp_axes, make_host_mesh,  # noqa: F401
                                     make_production_mesh, mesh_axes)
