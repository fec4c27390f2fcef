"""Data parallelism, FSDP and tensor parallelism across processes
(`mesh.py`: process groups, meshes, row windows, collectives; `wrap.py`:
the model under DDP or FSDP2; `tensor.py`: the score UNet column-parallel
over a tensor group)."""
