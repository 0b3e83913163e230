"""RP008 fixture: a bare print() in the observability path."""


def report(span):
    print("span closed:", span)
