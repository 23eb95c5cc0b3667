"""Scheduler subsystem of the port (``repro.sched``'s counterpart)."""
from repro_torch.sched.base import PrefillJob, Scheduler
from repro_torch.sched.packing import (PackedDispatch, PackedPrefillJob,
                                       plan_packed_job)
from repro_torch.sched.policies import (POLICY_NAMES, InterleavedScheduler,
                                        PimAwareScheduler, SerialScheduler,
                                        choose_superstep, make_scheduler)

__all__ = ["PrefillJob", "Scheduler", "PackedDispatch", "PackedPrefillJob",
           "plan_packed_job", "POLICY_NAMES", "InterleavedScheduler",
           "PimAwareScheduler", "SerialScheduler",
           "choose_superstep", "make_scheduler"]
