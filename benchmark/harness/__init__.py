"""The benchmark's harness: the cell's inputs, weights, loop, trace
reduction and correctness check (see ``benchmark/run.py``)."""
