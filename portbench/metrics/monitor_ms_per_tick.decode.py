"""Mean host milliseconds of the health monitor's tick (its layer CRC,
every fourth check its dense-oracle probe, every n_layers ticks its head
check), from the benchmark's span around ``HealthMonitor.on_tick``."""


def read(rec):
    s = rec["spans"].get("monitor_s")
    if not s:
        return None
    return 1e3 * sum(s) / len(s)
