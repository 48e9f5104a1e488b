"""The benchmark's own tests: `python -m pytest rtbench/tests -q` on the
CPU; the card tests (marked `cuda`) run where a CUDA device is."""
