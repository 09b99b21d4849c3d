"""Fault supervision of training runs (``fault``), the tensor-parallel
serving context (``tp``), sharding rules and explicit placement over a
(data x model) or (pod x data x model) mesh (``sharding``,
``collectives``, ``compression``), and the mesh serving programs
(``mesh_serving``). The mesh's users: ``mesh_serving.MeshServer``
(every serving family), ``training/sharded.py::ShardedTrainer`` (a model
axis for the lm families; ``launch/train.py --mesh``) and the dry-run (``launch/dryrun.py``, whose counts the collectives report
to, ``launch/exec_cost.py``). One process drives every shard;
``torch.distributed`` process groups are not ported (ROADMAP.md,
queue 1)."""
