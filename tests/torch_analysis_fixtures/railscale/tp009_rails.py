"""RP009 fixture: a policy moving one partition's rail directly, skipping
the clamp."""


def nudge(session, partition, volts):
    session.set_partition_voltage(partition, volts)
    return volts
