from .device import require_cuda
from .timers import DeviceTimer, Timer, print_timing_info, profile_trace

__all__ = ["DeviceTimer", "Timer", "print_timing_info", "profile_trace",
           "require_cuda"]
