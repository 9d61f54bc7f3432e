"""Launchers: ``serve``, ``train`` and the dry run (``dryrun``, run as the
program: ``python -m repro_torch.launch.dryrun``; not imported here), with
the cell plan (``cells``) and the meshes (``mesh``)."""
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

__all__ = ["make_host_mesh", "make_production_mesh"]
