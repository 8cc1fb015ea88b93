"""Spatial domain decomposition (the port of ``mdbench_tpu.parallel``):
the exchange layer that replaces the mesh collectives (`exchange.py`),
the helpers the domain engines share (`common.py`), the verlet scheme's
slab engine (`verlet_domain.py`) and its dry run (`dryrun.py`)."""
