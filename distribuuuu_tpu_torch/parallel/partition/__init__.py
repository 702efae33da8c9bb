"""The partition layer of the port (counterpart of
distribuuuu_tpu/parallel/partition/): the topology registry that validates
a ``MESH`` stanza (``topology.py``) and the per-leaf placement table with
the state-dict shard and gather (``specs.py``)."""
