"""RP007 fixture: a pass-only broad except in the serving path."""


def drain(events):
    try:
        return events.popleft()
    except BaseException:
        pass
