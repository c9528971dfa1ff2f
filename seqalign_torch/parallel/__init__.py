"""Many pairs and long pairs over a device mesh: ``BatchAligner``
(``batch.py``), its database search (``search.py``), the mesh
(``mesh.py``) and the sequence-parallel fills (``sequence.py``)."""

from .batch import BatchAligner, sharded_batch_score
from .mesh import DataMesh, make_data_mesh, maybe_initialize_distributed
from .search import Database

__all__ = ["BatchAligner", "Database", "DataMesh", "make_data_mesh",
           "maybe_initialize_distributed", "sharded_batch_score"]
