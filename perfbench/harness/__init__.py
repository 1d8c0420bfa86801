"""The benchmark's harness: cells resolved from ``BENCHMARK.json`` by name,
the timed window, the traced slice and its reduction, the comparison with
the reference, and the result line."""
