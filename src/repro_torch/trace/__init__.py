"""Workload traces of the port: the open-loop arrival processes and their
driver (``repro.trace.arrivals``'s counterpart). Recording, lowering and
replay stay with the reference's ``repro.trace`` for now."""
from repro_torch.trace.arrivals import (ArrivalEvent, LengthDistribution,
                                        bursty_arrivals, drive,
                                        lengths_from_file, poisson_arrivals)

__all__ = ["ArrivalEvent", "LengthDistribution", "bursty_arrivals", "drive",
           "lengths_from_file", "poisson_arrivals"]
