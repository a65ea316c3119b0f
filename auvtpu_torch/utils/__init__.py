from .timing import steady_state_ms, time_once_ms, warm_e2e_ms

__all__ = ["steady_state_ms", "time_once_ms", "warm_e2e_ms"]
