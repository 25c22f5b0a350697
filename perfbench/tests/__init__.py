"""CPU tests of the benchmark harness; ``python -m pytest -q
perfbench/tests`` from the repository's root (the ``cuda``-marked one
runs on the card)."""
