"""The benchmark's harness: traffic, weights, the system under test, the
window, the probes, the trace's reduction, the counts and the check."""
