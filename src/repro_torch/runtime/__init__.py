"""Fault tolerance: heartbeats, straggler detection, elastic remapping, and
the flow's voltage-recalibration watchdog.

The port's copy of ``repro.runtime``: numpy and the standard library."""
from .monitor import (CalibrationWatchdog, ElasticPlan, HeartbeatMonitor,
                      HostState, StragglerReport, plan_elastic_remap)
