"""Array operations on the resampling hot path.

`ops.expand.expand_rows` copies particle rows by systematic-resampling
block counts with sorts, rolls and selects instead of an ancestor vector
and a row gather (`inference/smc.py`, `particle_filter.py`, `rbpf.py` and
`parallel/smc.py` call it). Its plain reference is
`core.gather.take_rows(x, inference.smc.systematic_resample(...))`, which
it must equal bit for bit.
"""
