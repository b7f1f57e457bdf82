"""``repro_torch.launch`` — meshes over ``torch.distributed`` ranks
(``mesh``), a local launcher for their processes (``ranks``), the
entry points (``serve``, ``train``) and the analysis tools: the op-count
cost model (``hlo_cost``), its roofline (``roofline``), per-source-line
attribution (``attribution``) and the multi-pod dry run over fake ranks
(``dryrun``, ``reanalyze``, ``summarize``)."""
from repro_torch.launch.mesh import (dp_axes, make_host_mesh,  # noqa: F401
                                     make_production_mesh, mesh_axes)
