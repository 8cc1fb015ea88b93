"""Atom-file input of the port (``mdbench_tpu_torch.io.readers``)."""
