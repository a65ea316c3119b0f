from .debug import debug_mode, enable_debug
from .timing import steady_state_ms, time_once_ms, warm_e2e_ms

__all__ = ["steady_state_ms", "time_once_ms", "warm_e2e_ms", "debug_mode", "enable_debug"]
