"""Data parallelism and FSDP across processes (`mesh.py`: process groups,
meshes, row windows, collectives; `wrap.py`: the model under DDP or
FSDP2)."""
