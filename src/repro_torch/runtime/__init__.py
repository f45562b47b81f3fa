"""The fault-tolerance runtime: failure detection, straggler eviction and
the elastic mesh plan (``fault_tolerance``)."""
