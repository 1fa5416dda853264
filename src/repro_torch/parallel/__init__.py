"""What runs across the ranks of a mesh, below the models, the optimizer
and the checkpoints that use it: the mesh (``mesh.py``), specs and a rank's
block of a tensor (``spec.py``), and the collectives over a mesh's named
axes with their autograd versions (``collectives.py``)."""
