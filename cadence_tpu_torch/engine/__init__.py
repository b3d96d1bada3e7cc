"""The engines over the kernels: the capacity-escalation ladder (ladder.py)."""
