"""Profiling and debugging helpers (the port's counterpart of
``ldpcgputegra_tpu/utils/profiling.py`` and ``utils/debug.py``)."""

from .debug import check_dataset, dump_dataset, load_dataset, print_frame
from .profiling import span, spans, trace

__all__ = ["trace", "span", "spans", "check_dataset", "dump_dataset",
           "load_dataset", "print_frame"]
