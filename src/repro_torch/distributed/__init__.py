"""Distribution substrate: partition rules, compression, PP, elastic.

Counterpart of ``repro/distributed``.  Single-process, as the port's meshes
are (``launch/mesh.py``): one process lays arrays out over a mesh's devices
and moves work between them.
"""
from repro_torch.distributed import compression, elastic, partition, pipeline  # noqa: F401
