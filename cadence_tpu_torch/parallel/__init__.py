"""The device mesh: workflow-axis sharding over a list of devices (mesh.py)."""
