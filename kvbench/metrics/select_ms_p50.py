"""Controller and wire: the median over the cold starts due in the window
of the port's ``select`` span (its ``ServiceContext`` and ``_select_profile``),
in ms: the controller's own time on the way to the first token."""
from kvb.spans import READERS


def read(run):
    return READERS["select_ms_p50"](run)
