"""Roofline of the port's cells: the collectives of a traced step
(``comms``), analytic model FLOPs and HBM bytes (``analytic``), the
unroll-delta estimate (``estimate``), the three-term table on the H100's
constants (``analysis``) and the paper-technique power report
(``power_report``).  Counterpart of ``repro.roofline``."""
