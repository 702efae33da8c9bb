"""Process groups and collectives of the port (counterparts of
distribuuuu_tpu/parallel/mesh.py's bootstrap and parallel/collectives.py)."""
