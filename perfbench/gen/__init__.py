"""History generators of the benchmark: event lanes made from a seed on
the device, in bulk, one file a workload shape."""
