"""The engines over the kernels: the capacity-escalation ladder (ladder.py),
the pipelined bulk executor and its mesh serving paths (executor.py), the
device rebuilder (rebuild.py) and the bulk verify engine (tpu_engine.py),
with the host modules they read: the stores (persistence.py), the pack
cache (cache.py), snapshot records (snapshot.py), crashpoints,
membership and the visibility query language. Over them, the host control
plane: the Onebox (onebox.py) and its services, the write-ahead log and
crash recovery (durability.py, walcheck.py, crashsim.py), two regions and
their failover (multicluster.py, failovermanager.py, redirection.py,
domainrepl.py), and the operator surfaces (admin.py, canary.py,
shadower.py, batcher.py)."""
