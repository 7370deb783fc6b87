"""The benchmark's machinery: finding a cell's files by name, spans and
counters kept by the benchmark, the device trace of a bounded slice of
the window, and the result line."""
