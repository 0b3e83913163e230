"""B1 (``systolic_mac``): the yardstick's bound of the traced slice's GEMMs
over their device time, in % (the serve cells)."""

from bench.harness import readers


def read(rec):
    return readers.b1_roofline(rec, "serve")
