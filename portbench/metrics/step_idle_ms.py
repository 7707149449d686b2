"""Device idle milliseconds a step in the gaps whose midpoint lies inside
one of the program's ``dibs.step`` spans: the idle the step itself caused,
not the harness's between segments."""
from portbench import spans


def read(trace, cell):
    log = spans.log()
    return None if log is None else spans.idle_ms(trace, log)
