"""One reader a metric, named as in BENCHMARK.json: ``read(run)`` takes
the run record that ``benchmark/run.py`` builds and returns the value,
or None where the run holds nothing to read."""
