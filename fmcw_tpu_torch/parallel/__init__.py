"""The sharded processors: a (dp, sp) mesh on torch.distributed
(``mesh.py``) and the frame and array processors that run on it
(``sharded.py``)."""

from .mesh import LocalMesh, make_mesh
from .sharded import make_sharded_array_processor, make_sharded_processor

__all__ = ["LocalMesh", "make_mesh", "make_sharded_processor",
           "make_sharded_array_processor"]
