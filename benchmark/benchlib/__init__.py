"""The benchmark's own library: finding cells by name, making inputs,
timing, reading traces, counting least work and judging outputs.  It
imports torch and numpy, and of the program only what an entry adapter
(`entries/`) and `run.py` hand it."""
