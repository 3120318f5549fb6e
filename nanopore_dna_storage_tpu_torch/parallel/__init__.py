"""Data-parallel decode over ``torch.distributed``: the sharded decoder with
its on-device CRC/index classification (``mesh.py``), the N-process decode
job from ``.post`` directories to list files (``multihost.py``) and a local
launcher (``launch.py``)."""
