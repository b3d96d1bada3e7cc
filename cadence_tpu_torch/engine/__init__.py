"""The engines over the kernels: the capacity-escalation ladder (ladder.py),
the pipelined bulk executor (executor.py) and the device rebuilder
(rebuild.py)."""
