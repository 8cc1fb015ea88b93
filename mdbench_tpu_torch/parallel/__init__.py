"""Spatial domain decomposition (the port of ``mdbench_tpu.parallel``):
the exchange layer that replaces the mesh collectives (`exchange.py`),
the helpers the domain engines share (`common.py`), the verlet scheme's
slab engine (`verlet_domain.py`), the cluster scheme's slab engine
(`cluster_domain.py`) and their dry run (`dryrun.py`)."""
