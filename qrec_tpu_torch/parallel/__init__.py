"""Multi-GPU runs of the port: the process mesh (``mesh.py``) and the
collectives its sharded routes call (``collectives.py``)."""
