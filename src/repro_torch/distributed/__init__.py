"""Fault supervision of training runs (``fault``), the tensor-parallel
serving context (``tp``), sharding rules and explicit placement over a
(data x model) mesh (``sharding``, ``collectives``, ``compression``),
and the mesh serving programs (``mesh_serving``). One process drives
every shard; ``torch.distributed`` process groups are not ported
(ROADMAP.md, queue 1)."""
