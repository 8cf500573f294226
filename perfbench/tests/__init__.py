"""The benchmark's tests (``python -m pytest perfbench/tests``)."""
