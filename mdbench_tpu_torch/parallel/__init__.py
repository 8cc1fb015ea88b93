"""Spatial domain decomposition (the port of ``mdbench_tpu.parallel``):
the exchange layer that replaces the mesh collectives (`exchange.py`),
the helpers the domain engines share (`common.py`), the verlet scheme's
staged engine (`staged.py`) and its slabs (`verlet_domain.py`), pencils
(`verlet_domain2d.py`) and bricks (`verlet_domain3d.py`), the cluster
scheme's slab engine (`cluster_domain.py`) and their dry run
(`dryrun.py`)."""
