"""The benchmark of `repro_torch`, the PyTorch and CUDA port of CUTIE.

`portbench/run.py` runs one cell of `BENCHMARK.json` once and prints one
JSON line.  Everything that belongs to one configuration, one traffic mix
or one metric sits in a file of its own, found by the name that
`BENCHMARK.json` gives it:

    configs/<config>.json            the sizes as they are run, the limits
    configs/<config>.py              builds the program from the sizes
    configs/<config>.reference.py    the plain reference (torch only)
    traffic/<traffic>.json           the traffic mix's parameters
    loops/<loop>.py                  the client loop a traffic file names
    metrics/<metric>.py              ``read(run) -> float | None``
"""
