"""One reader per metric, metrics/<name>.py, found by the metric's name in
BENCHMARK.json: read(window) returns the value, or None where the run
holds nothing for it."""
