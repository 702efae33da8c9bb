"""Process groups and collectives of the port (counterparts of
distribuuuu_tpu/parallel/mesh.py's bootstrap and parallel/collectives.py),
the mesh of processes over the ``MESH`` axes (``mesh.py``), tensor
parallelism and the sharded layers' collectives (``tp.py``) and the
partition layer (``partition/``)."""
