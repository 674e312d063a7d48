"""host.cpu_ms_per_count: the process's CPU time (time.process_time) per
count over the traced run's untraced stretch of counts (rank.HOST_S): the
host's work a count, launches and Python, without the time the host's
cores were taken by other processes.  The host waits for the device's
result by spinning, so on a device-bound route this is close to the
count's wall time."""


def read(tr):
    return tr.host.get("cpu_ms_per_count")
