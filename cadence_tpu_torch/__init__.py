"""cadence_tpu_torch: the PyTorch and CUDA port of cadence_tpu.

Bulk workflow-history replay and verify on an NVIDIA H100: histories are
encoded into int64 event lanes, replayed per workflow by a hand-written
CUDA kernel, reduced to the canonical checksum row and hashed to one CRC32
per workflow, with the Python oracle (oracle/) as the parity witness.

Layout (mirrors cadence_tpu):
  device.py which device an entry point runs on, and the toolchain probe
  core/    enums, event model, canonical checksum
  oracle/  single-workflow Python reference replayer
  gen/     golden corpus generators
  ops/     dense state, event encoder, wirec compressed lanes, replay /
           payload / CRC / verify
  csrc/    the CUDA kernels (built at first use by ops/_build.py)
  native/  the C++ wirec encoder (built with g++ at first use) and staging
  parallel/ the device mesh: workflow-axis sharding over a list of devices
  engine/  the escalation ladder, the bulk executor, the device rebuilder,
           the bulk verify engine (tpu_engine.py) and the stores it reads
  utils/   pack-thread knob, metrics registry, profiler, flight recorder
"""

__version__ = "0.1.0"
