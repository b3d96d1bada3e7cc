"""The engines over the kernels: the capacity-escalation ladder (ladder.py),
the pipelined bulk executor and its mesh serving paths (executor.py), the
device rebuilder (rebuild.py) and the bulk verify engine (tpu_engine.py),
with the host modules they read: the stores (persistence.py), the pack
cache (cache.py), snapshot records (snapshot.py), crashpoints,
membership and the visibility query language."""
